"""On-device data augmentation (``pointcloudprocessing_tpu/ops/augment.py``)."""

from __future__ import annotations

import torch


def jitter(
    points: torch.Tensor,
    generator: torch.Generator,
    stdev_m: tuple[float, float, float],
) -> torch.Tensor:
    """Add per-axis gaussian jitter, drawn from ``generator``, to point
    clouds of shape (..., n, 3): ``points + noise * stdev``."""
    stdev = torch.tensor(stdev_m, dtype=points.dtype, device=points.device)
    noise = torch.randn(points.shape, generator=generator, dtype=points.dtype,
                        device=points.device)
    return points + noise * stdev
