"""The least time of kernel 7 (``csrc/gather_maxmin.cu``) from the shapes of
its work alone, beside ``roofline.py``'s bounds: a copy of the inline bound
of ``chip_smoke.py``'s kernel-7 check (``roofline(nbytes(q, idx, *got), 2 *
cb * cn * ck * w)``), restated on shapes."""

from __future__ import annotations

from gpubench.harness.roofline import F32, I32, roofline


def gather_maxmin_bound(b: int, n: int, k: int, w: int) -> tuple[float, str]:
    """Kernel 7 in f32: q (b, n, w) and int32 idx (b, n, k) read once, qmax
    and qmin (b, n, w) written once; a compare a gathered value for the
    max and one for the min, at the f32 rate."""
    bytes_moved = 3 * b * n * w * F32 + b * n * k * I32
    return roofline(bytes_moved, 2 * b * n * k * w)
