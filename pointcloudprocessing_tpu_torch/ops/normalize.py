"""Unit-sphere point-cloud normalization
(``pointcloudprocessing_tpu/ops/normalize.py::normalize_unit_sphere``)."""

from __future__ import annotations

import torch

from pointcloudprocessing_tpu_torch.core.constants import NORMALIZATION_EPSILON


def normalize_unit_sphere(points: torch.Tensor):
    """Center (..., n, 3) clouds on their centroid and scale by the largest
    point distance, floored at 1e-7. Returns (normalized, (centroid
    (..., 1, 3), scale (..., 1, 1)))."""
    centroid = points.mean(dim=-2, keepdim=True)
    centered = points - centroid
    dist = torch.sqrt(torch.square(centered).sum(dim=-1))
    max_dist = dist.amax(dim=-1, keepdim=True)[..., None]
    scale = torch.clamp(max_dist, min=NORMALIZATION_EPSILON)
    return centered / scale, (centroid, scale)
