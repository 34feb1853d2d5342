"""The H100's peaks and the least time a kernel's work could take, from the
work's shapes alone (never from the program's internals).

Copies of ``chip_smoke.py::roofline``, ``fps_bound``,
``pooled_forward_bound`` and ``pooled_backward_bound``, restated on shapes:
each input byte read once and each output byte written once, and the
operations the function needs. Peaks are NVIDIA's data sheet for the H100
SXM, dense, at its 700 W limit.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
BF16_OPS_PER_S = 989e12
#: the denominator of every ``mfu`` metric: dense TF32 on the tensor cores.
#: The port's f32-accurate products run there in 3xTF32 (kernels 4 and 5),
#: faster than the 67 TFLOP/s of the f32 units could give them.
MFU_PEAK_OPS_PER_S = TF32_OPS_PER_S
F32, I32, BOOL = 4, 4, 1


# copied from chip_smoke.py::roofline
def roofline(bytes_moved: float, operations: float, tf32_operations: float = 0.0,
             bf16_operations: float = 0.0) -> tuple[float, str]:
    """The least time in ms: bytes over 3.35 TB/s or the operations on each
    unit (f32 at 67 TFLOP/s, TF32 at 495, bf16 at 989), whichever is
    longest; and which binds."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = max(operations / F32_OPS_PER_S, tf32_operations / TF32_OPS_PER_S,
                bf16_operations / BF16_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fps_bound(b: int, n: int, k: int, valid: int) -> tuple[float, str]:
    """Kernel 2 (``chip_smoke.py::fps_bound``): f32 points, a bool mask, int32
    seeds in; int32 picks and their f32 points out; k - 1 steps over every
    valid point: 3 sub, 3 mul, 2 add, 1 min. ``valid`` sums the clouds'."""
    bytes_moved = b * n * 3 * F32 + b * n * BOOL + b * I32 + b * k * I32 + b * k * 3 * F32
    return roofline(bytes_moved, (k - 1) * valid * 9)


def pooled_forward_bound(b: int, n: int, c_in: int, c: int) -> tuple[float, str]:
    """Kernel 4 in f32 (``chip_smoke.py::pooled_forward_bound``): x, the
    weight, the affine's two rows in; pooled values and int32 argmax out;
    the GEMM on the tensor cores, three TF32 products a product, then
    affine, relu and max a pre-activation."""
    gemm = 2 * b * n * c_in * c
    bytes_moved = (b * n * c_in + c * c_in + 2 * c + b * c) * F32 + b * c * I32
    return roofline(bytes_moved, 3 * b * n * c, 3 * gemm)


def pooled_backward_bound(b: int, n: int, c_in: int, c: int) -> tuple[float, str]:
    """Kernel 5 in f32 (``chip_smoke.py::pooled_backward_bound``): x, the
    weight, coef, argmax, m (c_in, c_in) and the row in; dx and dk out;
    x @ m in 3xTF32 plus the row, and a coef * w row into dx and an x row
    into dk a (cloud, channel) winner."""
    xm = 2 * b * n * c_in * c_in
    bytes_moved = ((b * n * c_in + c * c_in + b * c + c_in * c_in + c_in
                    + b * n * c_in + c_in * c) * F32 + b * c * I32)
    return roofline(bytes_moved, b * n * c_in + 4 * b * c * c_in, 3 * xm)
