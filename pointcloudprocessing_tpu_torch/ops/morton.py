"""Morton (Z-order) keys for quantized voxel coordinates
(``pointcloudprocessing_tpu/ops/morton.py``).

15 bits per axis interleave into a 45-bit code, split into two int32 keys:
``hi`` holds the top 5 bits of each axis, ``lo`` the bottom 10.
"""

from __future__ import annotations

import torch


def _part1by2(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of int32 ``v`` so bit i lands at bit 3*i."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_keys_3d(
    x: torch.Tensor, y: torch.Tensor, z: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) int32 Morton sort keys for non-negative grid coords < 2**15.

    Sorting by (hi, lo) orders points along the 3-D Z-curve; bit order within
    a level is x, then y, then z, as in the JAX package.
    """
    x = torch.clamp(x, 0, 32767).to(torch.int32)
    y = torch.clamp(y, 0, 32767).to(torch.int32)
    z = torch.clamp(z, 0, 32767).to(torch.int32)
    hi = (
        (_part1by2(x >> 10) << 2)
        | (_part1by2(y >> 10) << 1)
        | _part1by2(z >> 10)
    )
    lo = (_part1by2(x) << 2) | (_part1by2(y) << 1) | _part1by2(z)
    return hi, lo
