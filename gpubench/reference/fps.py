"""Farthest-point sampling, a copy of the semantics of
``pointcloudprocessing_tpu_torch/ops/cuda/fps.py::fps_with_points_reference``
and ``ops/fps.py::_seed_indices``: the seed is row 0 if valid, else the first
valid row; each step takes the valid point farthest from every pick so far
(squared distances ``dx*dx + dy*dy + dz*dz`` of direct differences, a
running minimum, NaN first, ties to the lowest index)."""

from __future__ import annotations

import torch


def farthest_point_sample(points: torch.Tensor, k: int,
                          valid: torch.Tensor | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """points (b, n, 3) f32 -> (indices (b, k) int64, sampled (b, k, 3))."""
    b, n, _ = points.shape
    if valid is None:
        valid = torch.ones((b, n), dtype=torch.bool, device=points.device)
    xs, ys, zs = points.unbind(-1)
    first_valid = valid.to(torch.uint8).argmax(dim=1)
    cur = torch.where(valid[:, 0], torch.zeros_like(first_valid), first_valid)
    min_dist = torch.full_like(xs, float("inf"))
    neg = torch.tensor(float("-inf"), dtype=xs.dtype, device=xs.device)
    picks = [cur]
    for _ in range(1, k):
        last = cur[:, None]
        dx = xs - xs.gather(1, last)
        dy = ys - ys.gather(1, last)
        dz = zs - zs.gather(1, last)
        min_dist = torch.minimum(min_dist, dx * dx + dy * dy + dz * dz)
        cur = torch.where(valid, min_dist, neg).argmax(dim=1)
        picks.append(cur)
    idx = torch.stack(picks, dim=1)
    return idx, points.gather(1, idx[..., None].expand(-1, -1, 3))
