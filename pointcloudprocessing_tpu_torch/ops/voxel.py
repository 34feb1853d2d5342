"""Voxel-grid downsampling of padded clouds
(``pointcloudprocessing_tpu/ops/voxel.py``).

Fixed-shape formulation: the output has the input's length plus a validity
mask. Quantize -> Morton voxel key -> stable sort -> segment opens -> dense
ranks -> segment sum (on a CUDA tensor one of the two ``ops/cuda/voxel_reduce``
kernels, by the width n).
The Morton order makes the output spatially local in index order, which the
stride sampler relies on.
"""

from __future__ import annotations

import torch

from pointcloudprocessing_tpu_torch.ops.cuda.voxel_reduce import (
    monotone_segment_sum,
)
from pointcloudprocessing_tpu_torch.ops.morton import morton_keys_3d

_INT32_MAX = torch.iinfo(torch.int32).max
_INT64_MAX = torch.iinfo(torch.int64).max


def voxel_downsample_batch(
    points: torch.Tensor,
    voxel_size: float,
    valid_mask: torch.Tensor | None = None,
    reduction: str = "centroid",
    layout: str = "bnc",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Downsample a batch of padded (b, n, 3) clouds by voxel grid.

    Args:
      points: (b, n, 3) f32.
      voxel_size: edge length of the cubic voxel.
      valid_mask: optional (b, n) bool; invalid rows are ignored.
      reduction: 'centroid' (mean of voxel members) or 'first' (the member
        with the lowest input index).
      layout: 'bnc' returns (b, n, 3); 'bcn' returns contiguous (b, 3, n)
        planes, the layout the FPS kernel reads without a gather.

    Returns:
      (out_points, out_mask (b, n)): out_mask is True for the first k rows,
      k = number of occupied voxels, which hold the voxel representatives in
      Morton order. Invalid tail rows are 0.
    """
    if reduction not in ("centroid", "first"):
        raise ValueError(f"Unknown reduction {reduction!r}")
    if layout not in ("bnc", "bcn"):
        raise ValueError(f"Unknown layout {layout!r}")
    b, n = points.shape[:2]
    device = points.device
    if valid_mask is None:
        valid_mask = torch.ones((b, n), dtype=torch.bool, device=device)

    coords = torch.floor(points / voxel_size).to(torch.int32)
    lowest = torch.where(valid_mask[..., None], coords, _INT32_MAX).amin(
        dim=1, keepdim=True
    )
    rel = coords - lowest
    hi, lo = morton_keys_3d(rel[..., 0], rel[..., 1], rel[..., 2])
    # one int64 key orders as the JAX package's two-key (hi, lo) sort, since
    # lo < 2**30; invalid rows take the largest key, so the stable sort puts
    # the valid rows first, in ascending input order within a voxel
    key = (hi.to(torch.int64) << 30) | lo.to(torch.int64)
    key = torch.where(valid_mask, key, _INT64_MAX)
    order = torch.sort(key, dim=1, stable=True).indices
    sorted_points = points.gather(1, order[..., None].expand(-1, -1, 3))

    iota = torch.arange(n, device=device)
    num_valid = valid_mask.sum(dim=1)
    sorted_valid = iota[None, :] < num_valid[:, None]
    # recomputing the quantization on the sorted rows is exact
    sorted_coords = torch.floor(sorted_points / voxel_size).to(torch.int32)
    differs = (sorted_coords[:, 1:] != sorted_coords[:, :-1]).any(dim=-1)
    first = torch.ones((b, 1), dtype=torch.bool, device=device)
    is_new = torch.cat([first, differs], dim=1) & sorted_valid
    rank = torch.cumsum(is_new, dim=1) - 1  # dense segment id per sorted row
    # invalid rows go to the last bucket, which keeps the rank monotone
    rank = torch.where(sorted_valid, rank, n - 1).to(torch.int32)
    num_voxels = is_new.sum(dim=1)

    weights = (sorted_valid if reduction == "centroid" else is_new).to(
        points.dtype
    )
    out_mask = iota[None, :] < num_voxels[:, None]
    # counts ride as a fourth channel of the same segment sum
    data = torch.cat(
        [sorted_points * weights[..., None], weights[..., None]], dim=-1
    )
    reduced = monotone_segment_sum(data, rank)
    sums, counts = reduced[..., :3], reduced[..., 3]
    if reduction == "centroid":
        out = sums / torch.clamp(counts, min=1.0)[..., None]
    else:
        out = sums  # exactly one weighted row per segment
    out = torch.where(out_mask[..., None], out, 0.0)
    if layout == "bcn":
        out = out.transpose(1, 2).contiguous()
    return out, out_mask


def voxel_downsample(
    points: torch.Tensor,
    voxel_size: float,
    valid_mask: torch.Tensor | None = None,
    reduction: str = "centroid",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-cloud voxel downsample: (n, 3) -> ((n, 3), (n,))."""
    mask = None if valid_mask is None else valid_mask[None]
    out, out_mask = voxel_downsample_batch(
        points[None], voxel_size, mask, reduction
    )
    return out[0], out_mask[0]
