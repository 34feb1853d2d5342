"""PointNet++, single-scale grouping (``pointcloudprocessing_tpu/models/pointnet2.py``).

Two set-abstraction levels (FPS centroids, ball query as radius-masked kNN,
a pointwise MLP, max over each group), a global abstraction to 1024, a
classification head (512 -> dropout -> 256 -> dropout -> softmax) and a
segmentation head through a feature-propagation decoder (inverse-distance
3-NN interpolation back to the input points). The head contract is
PointNet's; ``se3`` is the identity (the family regresses no rotation).

On a CUDA tensor FPS runs the hand-written kernel (``ops/cuda/fps``); the
rest is plain PyTorch. Distances are f32 products with TF32 off, as the JAX
package's ``precision=HIGHEST``, since the radius mask and the kNN sets
flip on a rounding. kNN is the exact ``torch.topk``: the JAX package's
approximate TPU search (its default ``exact_knn=False``) is not ported, and
on the CPU it returns the exact set.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from pointcloudprocessing_tpu_torch.models.layers import (
    ConcatPointwiseBlock,
    DenseBlock,
    PointwiseBlock,
    require_device,
)
from pointcloudprocessing_tpu_torch.models.pointnet import (
    ALL_HEADS,
    NOTHING_FROZEN,
    FreezeFlags,
    dropout,
)
from pointcloudprocessing_tpu_torch.ops.fps import farthest_point_sample_batch
from pointcloudprocessing_tpu_torch.ops.gather import gather_rows
from pointcloudprocessing_tpu_torch.ops.knn import full_f32_matmul
from pointcloudprocessing_tpu_torch.ops.normalize import normalize_unit_sphere


def pointnet2_for_width(num_classes: int, num_parts: int, input_width: int,
                        *, device="cuda", **kwargs) -> "PointNet2":
    """PointNet2 with SA sizes clamped for small clouds, as the JAX package's:
    FPS never over-samples and kNN never asks for more neighbours than
    exist; at >= 1024 points this is the canonical configuration. Builds on
    ``device``, CUDA unless the caller asks for the CPU; without CUDA the
    default raises."""
    m1 = max(min(512, input_width // 2), 4)
    k1 = max(min(32, input_width), 1)
    m2 = max(min(128, m1 // 4), 4)
    k2 = max(min(64, m1), 1)
    return PointNet2(
        num_classes, num_parts,
        sa1=(m1, k1, 0.2, (64, 64, 128)),
        sa2=(m2, k2, 0.4, (128, 128, 256)),
        device=require_device(device), **kwargs,
    )


# copied from pointcloudprocessing_tpu/models/pointnet2.py::layer_trainability_pointnet2
def layer_trainability_pointnet2(freeze: FreezeFlags) -> dict[str, bool]:
    """Per-layer trainability report for the training log (the PointNet2
    analogue of ``layer_trainability``; PointNet2 has no transforms)."""
    report: dict[str, bool] = {"input_normalization": False}
    for name in ("sa1", "sa2", "sa3"):
        report[f"{name}_set_abstraction"] = not freeze.shared_network
    for name in ("mlp_cls_1_512", "mlp_cls_2_256", "mlp_cls_out"):
        report[name] = not freeze.classification_head
    for name in ("seg_fp2", "seg_fp1", "mlp_seg_1_128", "mlp_seg_2_128",
                 "mlp_seg_out"):
        report[name] = not freeze.segmentation_head
    return report


def _sq_dists(queries: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """(b, m, 3), (b, n, 3) -> (b, m, n): ``|q|^2 + |p|^2 - 2 q.p`` clamped
    at 0, the cross term an f32 product with TF32 off."""
    q2 = (queries * queries).sum(dim=-1, keepdim=True)
    p2 = (points * points).sum(dim=-1)
    with full_f32_matmul():
        cross = torch.matmul(queries, points.transpose(1, 2))
    return torch.clamp(q2 + p2[:, None, :] - 2.0 * cross, min=0.0)


def _grouping_knn(queries: torch.Tensor, points: torch.Tensor, k: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """k nearest points of each query: (b, m, 3) over (b, n, 3) -> indices
    (b, m, k) int32 and squared distances (b, m, k), ascending."""
    neg, idx = torch.topk(-_sq_dists(queries, points), k, dim=-1)
    return idx.int(), -neg


def sample_and_group(
    xyz: torch.Tensor,
    feats: Optional[torch.Tensor],
    num_centroids: int,
    k: int,
    radius: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One set-abstraction grouping: FPS centroids + radius-masked kNN.

    xyz (b, n, 3), feats optional (b, n, c). kNN hits beyond ``radius`` are
    replaced by the nearest neighbour (for a centroid drawn from the cloud,
    itself), the classic ball-query padding with fixed shapes. Returns
    (new_xyz (b, m, 3), grouped (b, m, k, 3 + c)): centered neighbour
    coordinates ++ neighbour features.
    """
    centroid_idx = farthest_point_sample_batch(xyz, num_centroids)
    new_xyz = gather_rows(xyz, centroid_idx)
    nbr_idx, sq_d = _grouping_knn(new_xyz, xyz, k)
    # r * r rounded once to f32, as the JAX package's weakly typed product
    r2 = torch.tensor(radius * radius, dtype=sq_d.dtype, device=sq_d.device)
    nbr_idx = torch.where(sq_d <= r2, nbr_idx, nbr_idx[..., :1])
    grouped = gather_rows(xyz, nbr_idx) - new_xyz[:, :, None, :]
    if feats is not None:
        grouped = torch.cat([grouped, gather_rows(feats, nbr_idx)], dim=-1)
    return new_xyz, grouped


def _three_nearest(fine_xyz: torch.Tensor, coarse_xyz: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact 3-NN of each fine point among the coarse ones by three argmin
    passes, each winner then masked to inf: ties go to the lowest index, as
    ``jnp.argmin``'s. Returns indices (b, n, 3) int32 and squared distances
    (b, n, 3)."""
    d = _sq_dists(fine_xyz, coarse_xyz)
    idxs, vals = [], []
    for _ in range(3):
        i = d.argmin(dim=-1, keepdim=True)
        vals.append(d.amin(dim=-1))
        idxs.append(i[..., 0])
        d = d.scatter(-1, i, float("inf"))
    return torch.stack(idxs, dim=-1).int(), torch.stack(vals, dim=-1)


def interpolate_features(fine_xyz: torch.Tensor, coarse_xyz: torch.Tensor,
                         coarse_feats: torch.Tensor, eps: float = 1e-8
                         ) -> torch.Tensor:
    """Inverse-distance 3-NN feature propagation: fine (b, n, 3), coarse
    (b, m, 3) with features (b, m, c) -> (b, n, c)."""
    idx, sq_d = _three_nearest(fine_xyz, coarse_xyz)
    w = 1.0 / (sq_d + eps)
    w = w / w.sum(dim=-1, keepdim=True)
    nbr = gather_rows(coarse_feats, idx)  # (b, n, 3, c)
    return (nbr * w[..., None]).sum(dim=2)


class _GlobalAbstraction(nn.Module):
    """Single-group SA: pointwise MLP (``l1``, ``l2``, ...) over [coords ++
    feats], max over all points."""

    def __init__(self, in_features: int, mlp: tuple[int, ...], *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.depth = len(mlp)
        c = 3 + in_features
        for i, width in enumerate(mlp):
            self.add_module(f"l{i + 1}", PointwiseBlock(
                c, width, generator=generator, device=device))
            c = width

    def mlp(self, x, *, train: bool, frozen: bool):
        for i in range(self.depth):
            x = getattr(self, f"l{i + 1}")(x, train=train, frozen=frozen)
        return x

    def forward(self, xyz, feats, *, train: bool, frozen: bool = False):
        x = torch.cat([xyz.to(feats.dtype), feats], dim=-1)
        return self.mlp(x, train=train, frozen=frozen).amax(dim=1)  # (b, mlp[-1])


class _SetAbstraction(_GlobalAbstraction):
    """FPS + group + the same pointwise MLP + max over each group."""

    def __init__(self, in_features: int, num_centroids: int, k: int,
                 radius: float, mlp: tuple[int, ...], *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__(in_features, mlp, generator=generator, device=device)
        self.num_centroids, self.k, self.radius = num_centroids, k, radius

    def forward(self, xyz, feats, *, train: bool, frozen: bool = False):
        new_xyz, x = sample_and_group(xyz, feats, self.num_centroids, self.k,
                                      self.radius)
        # (b, m, 3), (b, m, mlp[-1])
        return new_xyz, self.mlp(x, train=train, frozen=frozen).amax(dim=2)


class PointNet2(nn.Module):
    """Multi-head PointNet++ (SSG); submodule names are the Flax module names.

    Parameters are drawn on the CPU from ``generator`` (Glorot-uniform
    kernels, zero biases, unit BN scales) and placed on ``device``. Train
    mode normalizes by batch statistics (over every group axis) and updates
    the running ones, and draws the classification head's dropout masks
    from ``forward``'s generator, as :class:`PointNet` does. ``sa1``/``sa2``
    are (centroids, k, radius, mlp widths) on the unit-sphere scale.
    """

    def __init__(self, num_classes: int, num_parts: int,
                 dropout_rate: float = 0.3,
                 sa1: tuple = (512, 32, 0.2, (64, 64, 128)),
                 sa2: tuple = (128, 64, 0.4, (128, 128, 256)),
                 sa3_mlp: tuple[int, ...] = (256, 512, 1024), *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.dropout_rate = dropout_rate
        kw = dict(generator=generator, device=device)
        m1, k1, r1, mlp1 = sa1
        m2, k2, r2, mlp2 = sa2
        self.sa1 = _SetAbstraction(0, m1, k1, r1, tuple(mlp1), **kw)
        self.sa2 = _SetAbstraction(mlp1[-1], m2, k2, r2, tuple(mlp2), **kw)
        self.sa3 = _GlobalAbstraction(mlp2[-1], tuple(sa3_mlp), **kw)
        g = sa3_mlp[-1]
        self.mlp_cls_1 = DenseBlock(g, 512, apply_bn=True, activation="relu", **kw)
        self.mlp_cls_2 = DenseBlock(512, 256, apply_bn=True, activation="relu", **kw)
        self.mlp_cls_out = DenseBlock(256, num_classes, activation="softmax", **kw)
        # feature propagation: [f2 ++ tiled global] at the SA2 centroids, then
        # [f1 ++ interpolated] at the SA1 centroids, then the input points
        self.mlp_seg_fp2_l1 = ConcatPointwiseBlock(mlp2[-1], g, 256, **kw)
        self.mlp_seg_fp2_l2 = PointwiseBlock(256, 256, **kw)
        self.mlp_seg_fp1_l1 = PointwiseBlock(mlp1[-1] + 256, 256, **kw)
        self.mlp_seg_fp1_l2 = PointwiseBlock(256, 128, **kw)
        self.mlp_seg_l1 = PointwiseBlock(128, 128, **kw)
        self.mlp_seg_l2 = PointwiseBlock(128, 128, **kw)
        self.mlp_seg_out = PointwiseBlock(128, num_parts, apply_bn=False,
                                          activation="softmax", **kw)

    def forward(
        self,
        points: torch.Tensor,
        *,
        train: bool = False,
        freeze: FreezeFlags = NOTHING_FROZEN,
        generator: torch.Generator | None = None,
        heads: tuple[str, ...] = ALL_HEADS,
    ) -> dict[str, torch.Tensor]:
        """points: (b, n, 3) -> dict of the requested heads' outputs."""
        pc, _ = normalize_unit_sphere(points)
        shared = dict(train=train, frozen=freeze.shared_network)
        xyz1, f1 = self.sa1(pc, None, **shared)
        xyz2, f2 = self.sa2(xyz1, f1, **shared)
        global_features = self.sa3(xyz2, f2, **shared)  # (b, 1024)

        outputs: dict[str, torch.Tensor] = {}
        if "se3" in heads:
            outputs["se3"] = torch.eye(3, dtype=points.dtype,
                                       device=points.device).expand(
                points.shape[0], 3, 3)
        if "classification_output" in heads:
            cls = dict(train=train, frozen=freeze.classification_head)
            x_cls = self.mlp_cls_1(global_features, **cls)
            if train:
                x_cls = dropout(x_cls, self.dropout_rate, generator)
            x_cls = self.mlp_cls_2(x_cls, **cls)
            if train:
                x_cls = dropout(x_cls, self.dropout_rate, generator)
            outputs["classification_output"] = self.mlp_cls_out(x_cls, **cls)
        if "segmentation_output" in heads:
            seg = dict(train=train, frozen=freeze.segmentation_head)
            d2 = self.mlp_seg_fp2_l1(f2, global_features, **seg)
            d2 = self.mlp_seg_fp2_l2(d2, **seg)
            d1 = torch.cat([f1, interpolate_features(xyz1, xyz2, d2)], dim=-1)
            d1 = self.mlp_seg_fp1_l1(d1, **seg)
            d1 = self.mlp_seg_fp1_l2(d1, **seg)
            d0 = interpolate_features(pc, xyz1, d1)  # (b, n, 128)
            d0 = self.mlp_seg_l1(d0, **seg)
            d0 = self.mlp_seg_l2(d0, **seg)
            outputs["segmentation_output"] = self.mlp_seg_out(d0, **seg)
        return outputs
