"""PointNet++ single-scale grouping (Qi et al. 2017, arXiv:1706.02413) as a
function of a dict of named tensors: a copy of the semantics of
``pointcloudprocessing_tpu_torch/models/pointnet2.py`` with the names of its
``state_dict``.

Two set-abstraction levels (FPS centroids, the k nearest points within the
radius, nearer misses padded by the nearest, a pointwise MLP, max over each
group), a global abstraction to 1024, the classification head and a
feature-propagation decoder (inverse-distance 3-NN interpolation) for the
segmentation head. Squared distances are ``|q|^2 + |p|^2 - 2 q.p`` with the
cross term an f32 product, clamped at 0.

Departures from the published SSG network: kNN grouping within the radius
in place of the ball query's first-k (the program's ``_grouping_knn``), and
the heads of the multi-head contract; ``se3`` is the identity.
"""

from __future__ import annotations

import torch

from gpubench.reference.fps import farthest_point_sample
from gpubench.reference.pointnet import block, dropout, normalize_unit_sphere


def gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (b, n, c), idx (b, ...) -> (b, ..., c)."""
    b, c = x.shape[0], x.shape[-1]
    flat = idx.reshape(b, -1).long()
    return x.gather(1, flat[..., None].expand(-1, -1, c)).reshape(*idx.shape, c)


def sq_dists(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    q2 = (q * q).sum(dim=-1, keepdim=True)
    p2 = (p * p).sum(dim=-1)
    return torch.clamp(q2 + p2[:, None, :] - 2.0 * torch.matmul(q, p.transpose(1, 2)), min=0.0)


def group(xyz, feats, m: int, k: int, radius: float):
    centroids = gather(xyz, farthest_point_sample(xyz, m)[0])
    neg, idx = torch.topk(-sq_dists(centroids, xyz), k, dim=-1)
    r2 = torch.tensor(radius * radius, dtype=xyz.dtype, device=xyz.device)
    idx = torch.where(-neg <= r2, idx, idx[..., :1])
    grouped = gather(xyz, idx) - centroids[:, :, None, :]
    if feats is not None:
        grouped = torch.cat([grouped, gather(feats, idx)], dim=-1)
    return centroids, grouped


def mlp(w, name, x, train, depth=3):
    for i in range(depth):
        x = block(w, f"{name}.l{i + 1}", x, train)
    return x


def interpolate(fine, coarse, feats, eps: float = 1e-8):
    d = sq_dists(fine, coarse)
    idxs, vals = [], []
    for _ in range(3):  # the three nearest, ties to the lowest index
        i = d.argmin(dim=-1, keepdim=True)
        vals.append(d.amin(dim=-1))
        idxs.append(i[..., 0])
        d = d.scatter(-1, i, float("inf"))
    idx, sq = torch.stack(idxs, dim=-1), torch.stack(vals, dim=-1)
    wt = 1.0 / (sq + eps)
    wt = wt / wt.sum(dim=-1, keepdim=True)
    return (gather(feats, idx) * wt[..., None]).sum(dim=2)


def forward(w: dict, points: torch.Tensor, sa1: tuple, sa2: tuple, *,
            train: bool = False, dropout_rate: float = 0.3,
            generator: torch.Generator | None = None) -> dict[str, torch.Tensor]:
    """points (b, n, 3) -> the three heads; sa1, sa2 = (centroids, k, radius)."""
    pc = normalize_unit_sphere(points)
    xyz1, g1 = group(pc, None, *sa1)
    f1 = mlp(w, "sa1", g1, train).amax(dim=2)
    xyz2, g2 = group(xyz1, f1, *sa2)
    f2 = mlp(w, "sa2", g2, train).amax(dim=2)
    global_features = mlp(w, "sa3", torch.cat([xyz2, f2], dim=-1), train).amax(dim=1)

    c = block(w, "mlp_cls_1", global_features, train, dense="dense")
    if train:
        c = dropout(c, dropout_rate, generator)
    c = block(w, "mlp_cls_2", c, train, dense="dense")
    if train:
        c = dropout(c, dropout_rate, generator)
    cls = block(w, "mlp_cls_out", c, train, dense="dense", bn=False, activation="softmax")

    tiled = global_features[:, None, :].expand(-1, f2.shape[1], -1)
    d2 = block(w, "mlp_seg_fp2_l1", torch.cat([f2, tiled], dim=-1), train)
    d2 = block(w, "mlp_seg_fp2_l2", d2, train)
    d1 = torch.cat([f1, interpolate(xyz1, xyz2, d2)], dim=-1)
    d1 = block(w, "mlp_seg_fp1_l2", block(w, "mlp_seg_fp1_l1", d1, train), train)
    d0 = interpolate(pc, xyz1, d1)
    d0 = block(w, "mlp_seg_l2", block(w, "mlp_seg_l1", d0, train), train)
    seg = block(w, "mlp_seg_out", d0, train, bn=False, activation="softmax")
    se3 = torch.eye(3, dtype=points.dtype, device=points.device).expand(points.shape[0], 3, 3)
    return {"classification_output": cls, "segmentation_output": seg, "se3": se3}
