"""Pooled chain (dense -> folded BatchNorm affine -> relu -> max over points):
the hand-written CUDA kernels and their plain versions.

Counterparts of ``pointcloudprocessing_tpu/ops/pallas/pooled_chain.py::
pooled_chain_forward`` and ``::pooled_chain_backward``. On the TPU both are
bf16 matrix-unit kernels, and the forward packs the argmax into the low
mantissa bits of the pooled value; on the H100 both run their GEMM on the
tensor cores (``wgmma``) in 3xTF32, which keeps f32 accuracy
(``csrc/pooled_chain.cu`` says why and how), and the forward gives the
exact f32 maximum with its first index, so n has no index-field bound.

Weights are in the port's layout: ``weight`` is (c, c_in), the Flax
``kernel`` transposed.

A CUDA tensor always goes to the kernel, and a shape, dtype or layout it
cannot take raises; a CPU tensor goes to the plain version.
"""

from __future__ import annotations

import torch

from pointcloudprocessing_tpu_torch.ops.cuda import build

#: widths the kernels take: c_in and c multiples of 64, c at most 4096
TILE = 64
MAX_CHANNELS = 4096
#: a block's tile: 128 points x 128 output columns (kTileP, kTileN)
POINT_TILE = 128
COLUMN_TILE = 128


def launch_grid(b: int, n: int, cols: int, sms: int) -> tuple[int, int]:
    """(runs, tiles_per_run) of either kernel: each cloud's ceil(n / 128)
    point tiles are cut into runs of consecutive tiles, one block per (run,
    128-column tile, cloud), so that the grid holds about one block per SM
    (a block fills an SM: 200 KB of shared memory). With more (cloud,
    column-tile) pairs than SMs each cloud is one run. No run is empty."""
    tiles = -(-n // POINT_TILE)
    pairs = b * -(-cols // COLUMN_TILE)
    runs = max(1, min(tiles, sms // pairs))
    per_run = -(-tiles // runs)
    return -(-tiles // per_run), per_run


def _tf32_rna(v: torch.Tensor) -> torch.Tensor:
    bits = v.view(torch.int32)
    rounded = torch.where(torch.isfinite(v), (bits + 0x1000) & -0x2000, bits)
    nan = torch.full_like(bits, 0x7FFFFFFF)
    return torch.where(torch.isnan(v), nan, rounded).view(torch.float32)


def tf32_split(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernels' 3xTF32 split of the weight operand: ``hi`` is
    ``cvt.rna.tf32.f32(v)`` (round to nearest, ties away from zero, to 10
    mantissa bits; the low 13 bits zero) and ``lo`` the same of ``v - hi``
    in f32, so ``hi + lo`` is ``v`` to ~2^-22 of ``|v|``. A NaN gives NaN;
    an infinity keeps itself as ``hi`` and gives a NaN ``lo``."""
    hi = _tf32_rna(t)
    return hi, _tf32_rna(t - hi)


def _bits_to_f32(bits: torch.Tensor) -> torch.Tensor:
    """int64 holding 32-bit patterns -> float32 of those bits."""
    return torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32).view(
        torch.float32)


def tf32_split_x(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernels' split of an x fragment, which each thread makes in
    registers in four instructions: ``hi`` adds half a tf32 ulp to the bits
    and clears the low 13 (``cvt.rna``'s result for every number and
    infinity), ``lo`` is ``v - hi`` in f32 with its low 13 bits cleared
    (toward zero), so ``hi + lo`` is ``v`` to ~2^-21 of ``|v|``. A NaN gives
    a NaN ``lo`` (``hi`` is then arbitrary), so its products are NaN."""
    bits = t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    hi = _bits_to_f32((bits + 0x1000) & 0xFFFFE000)
    lo_bits = (t - hi).view(torch.int32).to(torch.int64) & 0xFFFFE000
    return hi, _bits_to_f32(lo_bits)


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


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _split_scratch(cols: int, c_in: int, device: torch.device) -> torch.Tensor:
    """Room for the kernels' tf32 hi and lo copies of the weight operand,
    its columns padded to whole 128-column tiles."""
    return torch.empty((2, -(-cols // COLUMN_TILE) * COLUMN_TILE * c_in),
                       dtype=torch.float32, device=device)


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
    runs, per_run = launch_grid(b, n, c, _sms(x.device))
    w_split = _split_scratch(c, c_in, x.device)
    part_v = torch.empty((b, runs, c), dtype=torch.float32, device=x.device)
    part_i = torch.empty((b, runs, c), dtype=torch.int32, device=x.device)
    pooled = torch.empty((b, c), dtype=torch.float32, device=x.device)
    argmax = torch.empty((b, c), dtype=torch.int32, device=x.device)
    lib = build.load("pooled_chain")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.pcp_pooled_chain_forward(
            x.data_ptr(), weight.data_ptr(), w_split.data_ptr(), a.data_ptr(),
            c_row.data_ptr(), part_v.data_ptr(), part_i.data_ptr(),
            pooled.data_ptr(), argmax.data_ptr(), b, n, c_in, c, runs,
            per_run, stream,
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
    dk (c_in, c)) f32, both deterministic; on CUDA dk is the transposed view
    of the (c, c_in) array the kernel writes a row a channel. The kernel checks argmax on the
    device: a value outside [0, n) traps, and the next CUDA call raises (the
    CUDA context is then lost).
    """
    if x.device.type == "cpu":
        return pooled_chain_backward_reference(
            x, weight, coef, argmax, m_small, const_row)
    if x.device.type != "cuda":
        raise ValueError(f"no pooled-chain kernel for device {x.device}")
    b, n, c_in, c = _check_widths(x, weight)
    _check("coef", coef, (b, c), torch.float32, x.device)
    _check("argmax", argmax, (b, c), torch.int32, x.device)
    _check("m_small", m_small, (c_in, c_in), torch.float32, x.device)
    _check("const_row", const_row, (c_in,), torch.float32, x.device)
    runs, per_run = launch_grid(b, n, c_in, _sms(x.device))
    m_split = _split_scratch(c_in, c_in, x.device)
    dx = torch.empty_like(x)
    dk_t = torch.empty((c, c_in), dtype=torch.float32, device=x.device)
    lib = build.load("pooled_chain")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.pcp_pooled_chain_backward(
            x.data_ptr(), weight.data_ptr(), coef.data_ptr(), argmax.data_ptr(),
            m_small.data_ptr(), m_split.data_ptr(), const_row.data_ptr(),
            dx.data_ptr(), dk_t.data_ptr(), b, n, c_in, c, runs, per_run,
            stream,
        )
    build.check(lib, code, "pooled_chain_backward launch")
    pooled_chain_backward.launches += 1
    return dx, dk_t.t()


#: kernel launches in this process (CPU calls and refusals do not count)
pooled_chain_backward.launches = 0
