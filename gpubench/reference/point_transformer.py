"""Point Transformer (Zhao et al. 2021, arXiv:2012.09164) as a function of a
dict of named tensors: a copy of the semantics of
``pointcloudprocessing_tpu_torch/models/point_transformer.py`` with the names
of its ``state_dict``, in the dataflow of the authors' release
(``pointtransformer_seg.py``).

Unit-sphere normalization; stage 1 enters by a dense layer, BatchNorm and
relu on the coordinates; each later stage by a transition down (FPS, the
nearest points of the previous stage, [p_j - p_i ++ x_j] through dense, BN,
relu, the max over the group). Each Point Transformer layer searches its own
neighbours, as the release's ``queryandgroup`` does, gathers keys, values
and relative coordinates, and forms the (b, n, k, C) position encoding,
relation and values: the weights are a softmax over the neighbours of the
weight MLP on k_j - q_i + delta_ij, each of the C/8 weight channels shared
by 8 value channels (``.view(n, k, s, c // s) * w.unsqueeze(2)``). The
decoder enters stage 5 on [x ++ the tiled relu(dense(mean x))] and stage s
<= 4 on relu(BN(dense x_enc)) + the 3-NN interpolation of relu(BN(dense
x_dec)), weighted by inverse Euclidean distance (``pointops.interpolation``).
The heads follow the port's multi-head contract; ``se3`` is the identity.

The self-graphs are the reference's own and exact: squared distances in
float64 (``reference/dgcnn.py::knn``), the k smallest a row, in blocks of
clouds. Where a program's graph is given for a stage, a row whose set
differs takes the program's set when that set is a near-tie of the exact one
(``reference/dgcnn.py::take_ties``). The transitions' searches use the
program's f32 expansion (``reference/pointnet2.py::sq_dists``) on the whole
batch at once.

Departures from the release: coordinates as the only features, the stage-5
clamp of k to the points there, no bias before a BatchNorm, BatchNorm's
epsilon 1e-3, and the heads (``configs/point_transformer_kc46.json``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gpubench.reference import dgcnn
from gpubench.reference.fps import farthest_point_sample
from gpubench.reference.pointnet import batch_norm, block, dropout, normalize_unit_sphere
from gpubench.reference.pointnet2 import gather, sq_dists

#: clouds a block of the float64 (b, n, n) self-distances: 32 clouds of
#: 1,024 points take 256 MiB
CLOUDS = 32


def linear(w: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, w[f"{name}.weight"], w.get(f"{name}.bias"))


def norm_relu(w: dict, name: str, x: torch.Tensor, train: bool) -> torch.Tensor:
    return torch.relu(batch_norm(w, f"{name}.bn", x, train))


def self_graph(p: torch.Tensor, k: int, program: torch.Tensor | None, scale: float,
               ties: dgcnn.Ties) -> torch.Tensor:
    """The k nearest points of each point in its cloud, self included,
    exact in float64 a block of ``CLOUDS`` clouds at a time; rows of the
    program's graph ``program`` taken within tau (``scale``)."""
    parts = []
    for at in range(0, p.shape[0], CLOUDS):
        rows = slice(at, at + CLOUDS)
        own, d = dgcnn.knn(p[rows], k)
        if program is not None:
            own, t = dgcnn.take_ties(p[rows], d, own, program[rows].long(), scale)
            ties.add(t)
        parts.append(own)
    return torch.cat(parts)


def attention(w: dict, name: str, p: torch.Tensor, y: torch.Tensor, idx: torch.Tensor,
              share: int, train: bool) -> torch.Tensor:
    """The release's ``PointTransformerLayer``: p (b, n, 3), y (b, n, C), idx
    (b, n, k) -> (b, n, C)."""
    q = linear(w, f"{name}.q", y)
    keys, values = gather(linear(w, f"{name}.k", y), idx), gather(linear(w, f"{name}.v", y), idx)
    p_r = gather(p, idx) - p[:, :, None, :]
    delta = linear(w, f"{name}.pos2", block(w, f"{name}.pos1", p_r, train))
    r = keys - q[:, :, None, :] + delta
    a = block(w, f"{name}.w1", norm_relu(w, f"{name}.rel", r, train), train)
    a = torch.softmax(linear(w, f"{name}.w2", a), dim=2)  # over the neighbours
    b, n, k, c = values.shape
    x = (values + delta).view(b, n, k, share, c // share) * a.unsqueeze(3)
    return x.sum(dim=2).reshape(b, n, c)


def transformer_block(w, name, p, x, idx, share, train):
    y = block(w, f"{name}.l1", x, train)
    z = norm_relu(w, f"{name}.norm2", attention(w, f"{name}.attn", p, y, idx, share, train),
                  train)
    return torch.relu(block(w, f"{name}.l3", z, train, activation=None) + x)


def transition_down(w, name, p, x, m, group, train):
    new_p = gather(p, farthest_point_sample(p, m)[0])
    idx = torch.topk(-sq_dists(new_p, p), group, dim=-1).indices
    grouped = torch.cat([gather(p, idx) - new_p[:, :, None, :], gather(x, idx)], dim=-1)
    return new_p, block(w, f"{name}.l1", grouped, train).amax(dim=2)


def three_nearest(fine: torch.Tensor, coarse: torch.Tensor):
    """The 3 nearest coarse points of each fine point by three argmin passes
    over the f32 expansion, ties to the lowest index: (indices (b, n, 3),
    Euclidean distances (b, n, 3))."""
    d = sq_dists(fine, coarse)
    idxs, vals = [], []
    for _ in range(3):
        i = d.argmin(dim=-1, keepdim=True)
        vals.append(d.amin(dim=-1))
        idxs.append(i[..., 0])
        d = d.scatter(-1, i, float("inf"))
    return torch.stack(idxs, dim=-1), torch.sqrt(torch.stack(vals, dim=-1))


def interpolate(fine, coarse, feats, eps: float = 1e-8):
    idx, dist = three_nearest(fine, coarse)
    wt = 1.0 / (dist + eps)
    wt = wt / wt.sum(dim=-1, keepdim=True)
    return (gather(feats, idx) * wt[..., None]).sum(dim=2)


def forward(w: dict, points: torch.Tensor, sizes: list, encoder_blocks, share: int, *,
            train: bool = False, dropout_rate: float = 0.5,
            generator: torch.Generator | None = None, program_graphs: list | None = None,
            scale: float = 0.0) -> tuple[dict[str, torch.Tensor], list[dgcnn.Ties]]:
    """points (b, n, 3) -> (the three heads, what each stage's
    ``take_ties`` did over its layers). ``sizes``: (points, k, transition
    group) a stage (``models/point_transformer.py::stage_sizes``);
    ``encoder_blocks``: blocks a stage; ``program_graphs``: the program's
    graph of each stage, (b, n_s, k_s), or None for the reference's own
    alone; ``scale``: tau's constant."""
    ties = [dgcnn.Ties() for _ in sizes]

    def graph(s, p):  # every layer searches anew
        given = None if program_graphs is None else program_graphs[s]
        return self_graph(p, sizes[s][1], given, scale, ties[s])

    pc = normalize_unit_sphere(points)
    p, x = pc, block(w, "stem", pc, train)
    stages = []
    for s, ((n, _, group), blocks) in enumerate(zip(sizes, encoder_blocks)):
        if s > 0:
            p, x = transition_down(w, f"down{s + 1}", p, x, n, group, train)
        for i in range(blocks):
            x = transformer_block(w, f"enc{s + 1}.{i}", p, x, graph(s, p), share, train)
        stages.append((p, x))

    c = block(w, "mlp_cls_1", stages[-1][1].mean(dim=1), train, dense="dense")
    if train:
        c = dropout(c, dropout_rate, generator)
    c = block(w, "mlp_cls_2", c, train, dense="dense")
    if train:
        c = dropout(c, dropout_rate, generator)
    cls = block(w, "mlp_cls_out", c, train, dense="dense", bn=False, activation="softmax")

    last = len(stages)
    p, x = stages[-1]
    g = block(w, f"mlp_seg_up{last}.glob", x.mean(dim=1), train, dense="dense", bn=False)
    d = block(w, f"mlp_seg_up{last}.l1", torch.cat([x, g[:, None, :].expand_as(x)], dim=-1), train)
    d = transformer_block(w, f"mlp_seg_dec{last}", p, d, graph(last - 1, p), share, train)
    for s in range(last - 1, 0, -1):
        coarse = p
        p, x = stages[s - 1]
        d = block(w, f"mlp_seg_up{s}.l1", x, train) + interpolate(p, coarse,
                                                          block(w, f"mlp_seg_up{s}.l2", d, train))
        d = transformer_block(w, f"mlp_seg_dec{s}", p, d, graph(s - 1, p), share, train)
    seg = block(w, "mlp_seg_out", block(w, "mlp_seg_1", d, train), train, bn=False,
                activation="softmax")
    se3 = torch.eye(3, dtype=points.dtype, device=points.device).expand(points.shape[0], 3, 3)
    return {"classification_output": cls, "segmentation_output": seg, "se3": se3}, ties
