"""DGCNN (Wang et al. 2019, arXiv:1801.07829) as a function of a dict of named
tensors: a copy of the semantics of
``pointcloudprocessing_tpu_torch/models/dgcnn.py`` with the names of its
``state_dict``, in the literal dataflow.

Unit-sphere normalization, four EdgeConv layers, each over a kNN graph of
its own input's features (``graph='dynamic'``) or of the normalized points
(``graph='static'``): the (b, n, k, 2c) edge tensor [x_i ++ (x_j - x_i)],
the edge MLP (dense without bias, BatchNorm, relu), the max over the k
neighbours. The four outputs' concatenation (512 channels) is lifted to
1024 by a shared layer and max-pooled; the classification head (512 ->
256 -> softmax) and the segmentation head on [per-point 512 ++ global
1024] (256 -> 256 -> 128 -> softmax) follow PointNet's contract; ``se3``
is the identity.

The graph is the reference's own and exact: squared distances of the
reference's f32 features in float64, the k smallest a row. Where a
program's graph is given (``program_graphs``), a row whose set differs
from the reference's takes the program's set when that set is a near-tie
of the exact one (:func:`take_ties`), so that a tie rounding broke
differently reads as agreement and any other difference parts the heads.

Departures from the published network: the heads of the multi-head
contract, relu throughout, the max pool alone and no input transform
(``configs/dgcnn_kc46.json`` lists them).
"""

from __future__ import annotations

import dataclasses

import torch

from gpubench.reference.pointnet import block, normalize_unit_sphere
from gpubench.reference.pointnet2 import gather

#: one unit of rounding of an f32 value near 1
F32_ULP = 2.0 ** -23
#: clouds a block: the (b, n, n) float64 distances and the (b, n, k, 2c) edges
#: of 32 clouds of 1,024 points take well under a GiB each
CLOUDS = 32


def knn(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """x (b, n, c) f32 -> (the k nearest of each point in its cloud, self
    included, (b, n, k) int64; the squared distances (b, n, n) float64).
    The expansion in float64 is exact to ~2^-52 of ``|x|^2``, far below
    any rounding of f32 features."""
    f = x.double()
    sq = (f * f).sum(dim=-1)
    d = torch.clamp(sq[:, :, None] + sq[:, None, :] - 2.0 * (f @ f.transpose(1, 2)), min=0.0)
    return torch.topk(d, k, dim=-1, largest=False).indices, d


@dataclasses.dataclass
class Ties:
    """What :func:`take_ties` did in one layer: rows whose program set
    differs from the reference's, rows that took the program's set, and
    the excesses over the reference's k-th distance in units of the rounding
    scale (the largest taken, the largest of the rows that differ)."""

    differ: int = 0
    taken: int = 0
    largest_taken: float = 0.0
    largest_differ: float = 0.0

    def add(self, other: "Ties") -> None:
        self.differ += other.differ
        self.taken += other.taken
        self.largest_taken = max(self.largest_taken, other.largest_taken)
        self.largest_differ = max(self.largest_differ, other.largest_differ)


def take_ties(x: torch.Tensor, d: torch.Tensor, own: torch.Tensor, program: torch.Tensor,
              scale: float) -> tuple[torch.Tensor, Ties]:
    """The graph a layer uses: for each row whose program set P_i differs
    from the reference's own R_i, P_i where its k members are distinct and
    every j in P_i has ``d_ij <= t_i + tau_i``, else R_i: a row that repeats
    a neighbour is no near-tie, however close its members lie. t_i is the
    reference's k-th smallest distance; ``tau_i = scale * 2^-23 * (|x_i|^2 + max_j |x_j|^2)`` over j in
    P_i and R_i, the rounding scale of an f32 expansion of the distance.
    x (b, n, c), d (b, n, n) float64, own and program (b, n, k) int64."""
    b, n, k = own.shape
    ordered = program.sort(dim=-1).values
    differ = (own.sort(dim=-1).values != ordered).any(dim=-1)
    distinct = (ordered.diff(dim=-1) != 0).all(dim=-1)
    t = d.gather(-1, own).amax(dim=-1)
    farthest = d.gather(-1, program).amax(dim=-1)
    sq = (x.double() ** 2).sum(dim=-1)
    reach = torch.maximum(sq.gather(1, own.reshape(b, -1)).reshape(b, n, k).amax(dim=-1),
                          sq.gather(1, program.reshape(b, -1)).reshape(b, n, k).amax(dim=-1))
    excess = (farthest - t) / (F32_ULP * (sq + reach))
    take = differ & distinct & (excess <= scale)
    ties = Ties(int(differ.sum()), int(take.sum()),
                float(excess[take].max()) if bool(take.any()) else 0.0,
                float(excess[differ].max()) if bool(differ.any()) else 0.0)
    return torch.where(take[..., None], program, own), ties


def edge_conv(w: dict, name: str, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The literal edge block: x (b, n, c), idx (b, n, k) -> (b, n, w)."""
    nbr = gather(x, idx)
    center = x[:, :, None, :].expand_as(nbr)
    return block(w, f"{name}.l1", torch.cat([center, nbr - center], dim=-1), False).amax(dim=2)


def _forward(w, points, k, layers, graph, program_graphs, scale, ties):
    pc = normalize_unit_sphere(points)
    shared = None
    if graph == "static":
        shared, d = knn(pc, k)
        if program_graphs is not None:
            shared, t = take_ties(pc, d, shared, program_graphs[0], scale)
            ties[0].add(t)
    x, outs = pc, []
    for i in range(layers):
        idx = shared
        if idx is None:
            idx, d = knn(x, k)
            if program_graphs is not None:
                idx, t = take_ties(x, d, idx, program_graphs[i], scale)
                ties[i].add(t)
        x = edge_conv(w, f"ec{i + 1}", x, idx)
        outs.append(x)
    local = torch.cat(outs, dim=-1)
    global_features = block(w, "emb", local, False).amax(dim=1)

    c = block(w, "mlp_cls_1", global_features, False, dense="dense")
    c = block(w, "mlp_cls_2", c, False, dense="dense")
    cls = block(w, "mlp_cls_out", c, False, dense="dense", bn=False, activation="softmax")
    tiled = global_features[:, None, :].expand(-1, local.shape[1], -1)
    s = block(w, "mlp_seg_1", torch.cat([local, tiled], dim=-1), False)
    s = block(w, "mlp_seg_3", block(w, "mlp_seg_2", s, False), False)
    seg = block(w, "mlp_seg_out", s, False, bn=False, activation="softmax")
    se3 = torch.eye(3, dtype=points.dtype, device=points.device).expand(points.shape[0], 3, 3)
    return {"classification_output": cls, "segmentation_output": seg, "se3": se3}


def forward(w: dict, points: torch.Tensor, k: int, layers: int = 4, *,
            graph: str = "dynamic", program_graphs: list | None = None,
            scale: float = 0.0) -> tuple[dict[str, torch.Tensor], list[Ties]]:
    """points (b, n, 3) -> (the three heads of the eval forward, what each
    graph's :func:`take_ties` did). ``program_graphs``: the program's
    graphs, (b, n, k) each, one a layer (one for the static graph), or
    None for the reference's own graphs alone; ``scale``: tau's constant.
    Works in blocks of ``CLOUDS`` clouds, so that the (b, n, n) distances
    and the (b, n, k, 2c) edges fit; BatchNorm on running statistics keeps
    the clouds independent."""
    ties = [Ties() for _ in range(1 if graph == "static" else layers)]
    parts = []
    for at in range(0, points.shape[0], CLOUDS):
        rows = slice(at, at + CLOUDS)
        given = None if program_graphs is None else [g[rows].long() for g in program_graphs]
        parts.append(_forward(w, points[rows], k, layers, graph, given, scale, ties))
    return {h: torch.cat([p[h] for p in parts]) for h in parts[0]}, ties
