"""On-device data augmentation (``pointcloudprocessing_tpu/ops/augment.py``):
per-axis jitter and uniform random rotations."""

from __future__ import annotations

import torch

from pointcloudprocessing_tpu_torch.parallel.mesh import draw
from pointcloudprocessing_tpu_torch.utils.device import require_device


def jitter(
    points: torch.Tensor,
    generator: torch.Generator,
    stdev_m: tuple[float, float, float],
) -> torch.Tensor:
    """Add per-axis gaussian jitter, drawn from ``generator``, to point
    clouds of shape (..., n, 3): ``points + noise * stdev``."""
    stdev = torch.tensor(stdev_m, dtype=points.dtype, device=points.device)
    noise = draw(torch.randn, points.shape, generator, dtype=points.dtype,
                 device=points.device)
    return points + noise * stdev


def so3_from_normals(normals: torch.Tensor) -> torch.Tensor:
    """Rotations (..., 3, 3) from standard normals (..., 3, 3) by the
    QR-of-gaussian construction: Q with the sign of R's diagonal folded into
    its columns (Haar-uniform), then column 0 times sign(det Q), so det is
    +1."""
    q, r = torch.linalg.qr(normals)
    d = torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))
    q = q * d[..., None, :]
    sign_det = torch.sign(torch.linalg.det(q))
    return torch.cat([q[..., :, :1] * sign_det[..., None, None], q[..., :, 1:]],
                     dim=-1)


def random_so3_rotation(generator: torch.Generator, batch_shape=(),
                        dtype=torch.float32, device="cuda") -> torch.Tensor:
    """Uniform random rotations (*batch_shape, 3, 3) on ``device`` (CUDA
    unless the caller asks for the CPU), from normals drawn from
    ``generator`` (a generator on that device)."""
    device = require_device(device)
    normals = torch.randn((*batch_shape, 3, 3), generator=generator,
                          dtype=dtype, device=device)
    return so3_from_normals(normals)
