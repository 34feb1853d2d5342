"""Pooled chain (dense -> folded BatchNorm affine -> relu -> max over points):
the hand-written CUDA kernels and their plain versions.

Counterparts of ``pointcloudprocessing_tpu/ops/pallas/pooled_chain.py::
pooled_chain_forward`` and ``::pooled_chain_backward``. On the TPU both are
bf16 matrix-unit kernels, and the forward packs the argmax into the low
mantissa bits of the pooled value; on the H100 both are f32 SIMT GEMM
tilings (``csrc/pooled_chain.cu`` says why and how), and the forward gives
the exact f32 maximum with its first index, so n has no index-field bound.

Weights are in the port's layout: ``weight`` is (c, c_in), the Flax
``kernel`` transposed.

A CUDA tensor always goes to the kernel, and a shape, dtype or layout it
cannot take raises; a CPU tensor goes to the plain version.
"""

from __future__ import annotations

import torch

from pointcloudprocessing_tpu_torch.ops.cuda import build

#: widths the kernels tile: c_in and c multiples of 64, c at most 4096
TILE = 64
MAX_CHANNELS = 4096
_POINT_TILE = 128  # points of one block (kBM in the source)
_WAVES = 4  # forward blocks to aim for, in waves of the card's SMs


def pooled_chain_forward_reference(
    x: torch.Tensor, weight: torch.Tensor, a: torch.Tensor, c_row: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: ``r = relu((x @ weight^T) * a + c_row)`` materialised,
    then its max and first-index argmax over the points. x (b, n, c_in),
    weight (c, c_in), a and c_row (c,) -> (pooled (b, c) f32, argmax (b, c)
    int32)."""
    r = torch.relu(torch.matmul(x, weight.t()) * a + c_row)
    return r.amax(dim=1), r.argmax(dim=1).int()


def pooled_chain_backward_reference(
    x: torch.Tensor,
    weight: torch.Tensor,
    coef: torch.Tensor,
    argmax: torch.Tensor,
    m_small: torch.Tensor,
    const_row: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version, through the winners' dense one-hot ``A = onehot(argmax)
    * coef`` (b, n, c): ``dx = A @ weight + x @ m_small + const_row`` and
    ``dk = x^T A`` summed over the clouds. Returns (dx (b, n, c_in),
    dk (c_in, c) f32)."""
    n = x.shape[1]
    points = torch.arange(n, device=x.device)[None, :, None]
    a_mat = torch.where(points == argmax[:, None, :].long(), coef[:, None, :], 0.0)
    dx = torch.matmul(a_mat, weight) + torch.matmul(x, m_small) + const_row
    dk = torch.einsum("bnd,bnc->dc", x, a_mat)
    return dx, dk


def _check(name: str, t: torch.Tensor, shape: tuple, dtype: torch.dtype,
           device: torch.device) -> None:
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, not {device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _check_widths(x: torch.Tensor, weight: torch.Tensor) -> tuple[int, ...]:
    if x.dim() != 3 or weight.dim() != 2:
        raise ValueError(
            f"x must be (b, n, c_in) and weight (c, c_in), got "
            f"{tuple(x.shape)} and {tuple(weight.shape)}")
    b, n, c_in = x.shape
    c = weight.shape[0]
    if (b < 1 or n < 1 or c_in % TILE or c % TILE or c_in < TILE
            or not TILE <= c <= MAX_CHANNELS):
        raise ValueError(
            f"the pooled-chain kernels take b, n >= 1 and c_in, c multiples "
            f"of {TILE} (c <= {MAX_CHANNELS}); got b={b}, n={n}, "
            f"c_in={c_in}, c={c}")
    _check("x", x, (b, n, c_in), torch.float32, x.device)
    _check("weight", weight, (c, c_in), torch.float32, x.device)
    return b, n, c_in, c


def _splits(b: int, n: int, c: int, device: torch.device) -> int:
    """Runs of points per cloud in the forward, so that the grid fills the
    card: (c / 64) * b blocks per run, at most one run per 128-point tile."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tiles = -(-n // _POINT_TILE)
    per_run = (c // TILE) * b
    return max(1, min(tiles, -(-_WAVES * sms // per_run)))


def pooled_chain_forward(
    x: torch.Tensor, weight: torch.Tensor, a: torch.Tensor, c_row: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """``relu((x @ weight^T) * a + c_row)``, then max and first-index argmax
    over the points, without writing the (b, n, c) activation.

    x (b, n, c_in) f32; weight (c, c_in) f32; a, c_row (c,) f32 (the
    BatchNorm affine folded per channel). Returns (pooled (b, c) f32,
    argmax (b, c) int32). The pooled value is the exact f32 maximum of the
    kernel's own GEMM; a channel that is 0 at every point gives 0, argmax 0.
    """
    if x.device.type == "cpu":
        return pooled_chain_forward_reference(x, weight, a, c_row)
    if x.device.type != "cuda":
        raise ValueError(f"no pooled-chain kernel for device {x.device}")
    b, n, c_in, c = _check_widths(x, weight)
    _check("a", a, (c,), torch.float32, x.device)
    _check("c_row", c_row, (c,), torch.float32, x.device)
    splits = _splits(b, n, c, x.device)
    part_v = torch.empty((b, splits, c), dtype=torch.float32, device=x.device)
    part_i = torch.empty((b, splits, c), dtype=torch.int32, device=x.device)
    pooled = torch.empty((b, c), dtype=torch.float32, device=x.device)
    argmax = torch.empty((b, c), dtype=torch.int32, device=x.device)
    lib = build.load("pooled_chain")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.pcp_pooled_chain_forward(
            x.data_ptr(), weight.data_ptr(), a.data_ptr(), c_row.data_ptr(),
            part_v.data_ptr(), part_i.data_ptr(), pooled.data_ptr(),
            argmax.data_ptr(), b, n, c_in, c, splits, stream,
        )
    build.check(lib, code, "pooled_chain_forward launch")
    pooled_chain_forward.launches += 1
    return pooled, argmax


#: kernel launches in this process (CPU calls and refusals do not count)
pooled_chain_forward.launches = 0


def pooled_chain_backward(
    x: torch.Tensor,
    weight: torch.Tensor,
    coef: torch.Tensor,
    argmax: torch.Tensor,
    m_small: torch.Tensor,
    const_row: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The pooled chain's data backward: ``dx = x @ m_small + const_row``
    plus, for each (cloud, channel), ``coef[b, c] * weight[c, :]`` into row
    ``argmax[b, c]``; and ``dk[d, c] = sum_b coef[b, c] * x[b, argmax[b, c], d]``.

    x (b, n, c_in), weight (c, c_in), coef (b, c) f32, argmax (b, c) int32,
    m_small (c_in, c_in), const_row (c_in,) f32. Returns (dx (b, n, c_in),
    dk (c_in, c)) f32, both deterministic. The kernel checks argmax on the
    device: a value outside [0, n) traps, and the next CUDA call raises (the
    CUDA context is then lost).
    """
    if x.device.type == "cpu":
        return pooled_chain_backward_reference(
            x, weight, coef, argmax, m_small, const_row)
    if x.device.type != "cuda":
        raise ValueError(f"no pooled-chain kernel for device {x.device}")
    b, n, c_in, c = _check_widths(x, weight)
    if -(-n // _POINT_TILE) > 65535:
        raise ValueError(f"n={n} exceeds the backward kernel's grid")
    _check("coef", coef, (b, c), torch.float32, x.device)
    _check("argmax", argmax, (b, c), torch.int32, x.device)
    _check("m_small", m_small, (c_in, c_in), torch.float32, x.device)
    _check("const_row", const_row, (c_in,), torch.float32, x.device)
    dx = torch.empty_like(x)
    dk = torch.empty((c_in, c), dtype=torch.float32, device=x.device)
    lib = build.load("pooled_chain")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.pcp_pooled_chain_backward(
            x.data_ptr(), weight.data_ptr(), coef.data_ptr(), argmax.data_ptr(),
            m_small.data_ptr(), const_row.data_ptr(), dx.data_ptr(),
            dk.data_ptr(), b, n, c_in, c, stream,
        )
    build.check(lib, code, "pooled_chain_backward launch")
    pooled_chain_backward.launches += 1
    return dx, dk


#: kernel launches in this process (CPU calls and refusals do not count)
pooled_chain_backward.launches = 0
