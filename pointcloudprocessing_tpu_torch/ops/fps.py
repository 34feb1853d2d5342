"""Farthest-point sampling and the stride sampler
(``pointcloudprocessing_tpu/ops/fps.py``).

On a CUDA tensor FPS runs the hand-written kernel (``ops/cuda/fps``) and
the stride sampler rides the segment-sum kernels (``ops/cuda/voxel_reduce``);
on a CPU tensor both take the kernels' plain versions. ``method='distmat'``
and ``'stream'`` of :func:`farthest_point_sample_batch` are plain PyTorch on
any device.
"""

from __future__ import annotations

import torch

from pointcloudprocessing_tpu_torch.ops.cuda.fps import (
    fps,
    fps_with_points,
    fps_with_points_reference,
)
from pointcloudprocessing_tpu_torch.ops.cuda.voxel_reduce import (
    monotone_segment_sum,
)

#: largest (b, n, n) f32 distance matrix 'auto' builds on the CPU
_MAX_DISTMAT_BYTES = 2 * 1024**3


def _seed_indices(valid_mask: torch.Tensor, start_index: int) -> torch.Tensor:
    """Per-cloud seed: ``start_index`` if valid, else the first valid point."""
    b = valid_mask.shape[0]
    start = torch.full((b,), start_index, dtype=torch.int32,
                       device=valid_mask.device)
    fallback = valid_mask.to(torch.uint8).argmax(dim=1).to(torch.int32)
    return torch.where(valid_mask[:, start_index], start, fallback)


def _distmat_fps(
    points: torch.Tensor, num_samples: int, valid_mask: torch.Tensor,
    start: torch.Tensor,
) -> torch.Tensor:
    """FPS over a precomputed pairwise squared-distance matrix (b, n, n)."""
    n = points.shape[1]
    sq = (points * points).sum(dim=-1)
    gram = points @ points.transpose(1, 2)
    dist = sq[:, :, None] + sq[:, None, :] - 2.0 * gram
    neg = torch.tensor(float("-inf"), dtype=points.dtype, device=points.device)
    min_dist = torch.full_like(sq, float("inf"))
    cur = start.long()
    picks = [cur]
    for _ in range(1, num_samples):
        row = dist.gather(1, cur[:, None, None].expand(-1, 1, n))[:, 0]
        min_dist = torch.minimum(min_dist, row)
        cur = torch.where(valid_mask, min_dist, neg).argmax(dim=-1)
        picks.append(cur)
    return torch.stack(picks, dim=1).int()


def farthest_point_sample_batch(
    points: torch.Tensor,
    num_samples: int,
    valid_mask: torch.Tensor | None = None,
    start_index: int = 0,
    method: str = "auto",
) -> torch.Tensor:
    """FPS over a batch of padded clouds: (b, n, 3) -> (b, num_samples) int32.

    Args:
      valid_mask: optional (b, n) bool; invalid points are never selected.
      start_index: seed index (the first valid point of a cloud whose seed
        row is invalid).
      method: 'auto' (the kernel on a CUDA tensor; on the CPU 'distmat'
        while b*n*n*4 bytes fit ``_MAX_DISTMAT_BYTES``, else 'stream'),
        'distmat' or 'stream'.

    With fewer valid points than num_samples, picks repeat.
    """
    b, n = points.shape[:2]
    if valid_mask is None:
        valid_mask = torch.ones((b, n), dtype=torch.bool, device=points.device)
    start = _seed_indices(valid_mask, start_index)
    if method == "auto":
        if points.is_cuda:
            return fps(points, num_samples, valid_mask, start)
        method = "distmat" if b * n * n * 4 <= _MAX_DISTMAT_BYTES else "stream"
    if method == "distmat":
        return _distmat_fps(points, num_samples, valid_mask, start)
    if method == "stream":
        return fps_with_points_reference(points, num_samples, valid_mask, start)[0]
    raise ValueError(f"Unknown method {method!r}")


def farthest_point_sample_and_gather(
    points: torch.Tensor,
    num_samples: int,
    valid_mask: torch.Tensor | None = None,
    start_index: int = 0,
    layout: str = "bnc",
) -> tuple[torch.Tensor, torch.Tensor]:
    """FPS returning (indices (b, k) int32, sampled points (b, k, 3) f32).

    ``layout='bcn'`` takes plane-major (b, 3, n) points, as
    ``voxel_downsample_batch(layout='bcn')`` returns them; the sampled
    output stays (b, k, 3) for the model.
    """
    if layout not in ("bnc", "bcn"):
        raise ValueError(f"Unknown layout {layout!r}")
    b = points.shape[0]
    n = points.shape[2] if layout == "bcn" else points.shape[1]
    if valid_mask is None:
        valid_mask = torch.ones((b, n), dtype=torch.bool, device=points.device)
    start = _seed_indices(valid_mask, start_index)
    return fps_with_points(points, num_samples, valid_mask, start, layout=layout)


def stride_sample_and_gather(
    points: torch.Tensor,
    num_samples: int,
    valid_mask: torch.Tensor | None = None,
    layout: str = "bnc",
) -> tuple[torch.Tensor, torch.Tensor]:
    """O(n) stratified sampling along the input order: the serving-path
    alternative to FPS's serial selection loop.

    On the Morton-ordered voxel output, evenly spaced picks along the index
    axis are a stratified spatial sample. Requires the valid rows to be
    packed first (true for voxel output). Valid row j maps to the monotone
    bucket floor(j*k/nv); the first row of each bucket is extracted by the
    segment sum. With fewer than ``num_samples`` valid rows some buckets get
    no row; they repeat the previous pick (forward fill), so no phantom zero
    points appear.

    Returns (indices (b, k) int32, sampled (b, k, 3) f32).
    """
    if layout == "bcn":
        points = points.transpose(1, 2)
    elif layout != "bnc":
        raise ValueError(f"Unknown layout {layout!r}")
    b, n = points.shape[:2]
    k = num_samples
    device = points.device
    if valid_mask is None:
        valid_mask = torch.ones((b, n), dtype=torch.bool, device=device)
    nv = torch.clamp(valid_mask.sum(dim=1), min=1)  # (b,)
    j = torch.arange(n, device=device)
    bucket = torch.clamp((j[None, :] * k) // nv[:, None], max=k - 1)
    bucket = torch.where(valid_mask, bucket, n - 1).to(torch.int32)
    first = torch.ones((b, 1), dtype=torch.bool, device=device)
    is_new = torch.cat([first, bucket[:, 1:] != bucket[:, :-1]], dim=1) & valid_mask
    w = is_new.to(points.dtype)[..., None]
    # channels: xyz, source index, and a filled flag that survives the sum as
    # 1.0 for buckets that received a first row and 0.0 for skipped ones
    data = torch.cat(
        [points * w, j.to(points.dtype)[None, :, None] * w, w], dim=-1
    )
    reduced = monotone_segment_sum(data, bucket)
    picks = reduced[:, :k, :4]
    filled = reduced[:, :k, 4] > 0.5
    # forward fill: each bucket takes the nearest filled bucket at or before
    # it; before the first filled bucket it keeps its own (zero) row
    slot = torch.arange(k, device=device).expand(b, k)
    src = torch.cummax(torch.where(filled, slot, -1), dim=1).values
    src = torch.where(src < 0, slot, src)
    picks = picks.gather(1, src[..., None].expand(-1, -1, 4))
    return picks[..., 3].to(torch.int32), picks[..., :3]
