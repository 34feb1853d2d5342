"""Pooled chain (dense -> folded BatchNorm affine -> relu -> max over points):
the hand-written CUDA kernels and their plain versions.

Counterparts of ``pointcloudprocessing_tpu/ops/pallas/pooled_chain.py::
pooled_chain_forward`` and ``::pooled_chain_backward``. On the TPU both are
bf16 matrix-unit kernels, and the forward packs the argmax into the low
mantissa bits of the pooled value; on the H100 both run their GEMM on the
tensor cores (``wgmma``) in 3xTF32, the forward adding the tensor cores'
partial sums into f32 sums of its own every :data:`PROMOTE_K_STEPS` k-steps
(the tensor cores sum toward zero), which keeps f32 accuracy
(``csrc/pooled_chain.cu`` says why and how), and the forward gives the
exact f32 maximum with its first index, so n has no index-field bound.
Each kernel has a bf16 form too (:func:`kernel_form`), the form in which the
JAX package runs them: x and the weight in bf16, single-pass bf16 products
with f32 sums; the backward rounds m and each winner's coef to bf16 as the
TPU kernel does and writes dx in bf16. At c_in 64 and 128 the bf16 forms
are kernels of their own (:func:`bf16_form` "tma": TMA loads, both wgmma
operands in shared memory, a persistent grid planned by
:func:`tma_forward_plan` and :func:`tma_dx_plan`; the backward adds each
row's winners from the per-point lists :func:`winner_lists` describes);
wider bf16 inputs take the f32 forms' run of tiles on bf16 operands.

Weights are in the port's layout: ``weight`` is (c, c_in), the Flax
``kernel`` transposed.

A CUDA tensor always goes to the kernel, and a shape, dtype or layout it
cannot take raises; a CPU tensor goes to the plain version.
"""

from __future__ import annotations

import torch

from pointcloudprocessing_tpu_torch.ops.cuda import build

#: widths the kernels take (every form): c_in and c multiples of 64, c at
#: most 4096; every width the JAX package's ``supported()`` takes at c <= 4096
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


#: k-steps of 8 input channels whose 3xTF32 products the tensor cores sum
#: before the f32 forward adds them into its own f32 sums (kGroup)
PROMOTE_K_STEPS = 2
#: c_in of the bf16 forms' TMA kernels (w, or m, resident in shared memory
#: beside the x ring); wider bf16 inputs take the run-of-tiles form
TMA_WIDTHS = (64, 128)
#: the TMA forward's tile: 256 points (wgmma's n) x a slice of 256 channels
TMA_FWD_POINTS = 256
TMA_FWD_SLICE = 256
#: the TMA backward's dx tile: 64 points (wgmma's m) x c_in columns
TMA_DX_POINTS = 64


def bf16_form(c_in: int) -> str:
    """The bf16 kernels' form for inputs c_in wide: "tma" (TMA loads, both
    wgmma operands in shared memory, a persistent grid) for c_in 64 or 128,
    "runs" (the f32 form's run-of-tiles loop on bf16 operands) above."""
    return "tma" if c_in in TMA_WIDTHS else "runs"


def tma_forward_plan(b: int, n: int, c: int, sms: int) -> tuple[int, int, int]:
    """(runs, tiles_per_run, grid) of the TMA bf16 forward: each cloud's
    ceil(n / 256) point tiles are cut into runs, and the b * runs *
    ceil(c / 256) units (cloud, run, 256-channel slice) go to a persistent
    grid of at most ``sms`` blocks, block i taking units i, i + grid, ...
    The cut minimises the tiles the busiest block walks (waves of units
    times tiles a run), the fewest runs on a tie; no run is empty."""
    tiles = -(-n // TMA_FWD_POINTS)
    pairs = b * -(-c // TMA_FWD_SLICE)
    best = None
    for r in range(1, min(tiles, 4 * sms) + 1):
        per_run = -(-tiles // r)
        runs = -(-tiles // per_run)
        cost = -(-pairs * runs // sms) * per_run
        if best is None or cost < best[0]:
            best = (cost, runs, per_run)
    _, runs, per_run = best
    return runs, per_run, min(sms, pairs * runs)


def tma_dx_plan(b: int, n: int, sms: int) -> tuple[int, int]:
    """(tiles_per_cloud, grid) of the TMA bf16 backward: the b *
    ceil(n / 64) tiles of 64 points go to a persistent grid of at most
    ``sms`` blocks, block i taking tiles i, i + grid, ... (its two
    warpgroups in turn)."""
    per_cloud = -(-n // TMA_DX_POINTS)
    return per_cloud, min(sms, b * per_cloud)


def winner_lists(argmax: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """What the TMA bf16 backward's first launch lists, as plain tensor code:
    each cloud's channels sorted by their argmax point, in channel order
    within a point (``win_ch`` (b, c) int32), and each point's stretch of
    them, ``win_ch[b, pt_off[b, p]:pt_off[b, p + 1]]`` (``pt_off`` (b, n + 1)
    int32). dx's row p adds exactly those channels' coef * w rows, in that
    order."""
    c = argmax.shape[1]
    key = argmax.long() * c + torch.arange(c, device=argmax.device)
    order = torch.argsort(key, dim=1)
    points = torch.gather(argmax.long(), 1, order)
    bounds = torch.arange(n + 1, device=argmax.device).expand(argmax.shape[0], n + 1)
    pt_off = torch.searchsorted(points, bounds.contiguous())
    return order.int(), pt_off.int()


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


def kernel_form(x_dtype: torch.dtype, weight_dtype: torch.dtype) -> str:
    """The kernels' form for x and weight of these types: "tf32x3" for f32
    (3xTF32 products, f32 accuracy), "bf16" for bf16 (the TPU kernels' own
    precision). Any other pair raises."""
    if x_dtype == weight_dtype == torch.float32:
        return "tf32x3"
    if x_dtype == weight_dtype == torch.bfloat16:
        return "bf16"
    raise TypeError(
        f"the pooled-chain kernels take x and weight both f32 or both bf16, "
        f"got {x_dtype} and {weight_dtype}")


def _bf16_round(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def pooled_chain_forward_reference(
    x: torch.Tensor, weight: torch.Tensor, a: torch.Tensor, c_row: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: ``r = relu((x @ weight^T) * a + c_row)`` materialised
    in f32 (bf16 operands are exact in it), then its max and first-index
    argmax over the points. x (b, n, c_in), weight (c, c_in), both f32 or
    both bf16; a and c_row (c,) f32 -> (pooled (b, c) f32, argmax (b, c)
    int32)."""
    kernel_form(x.dtype, weight.dtype)
    r = torch.relu(torch.matmul(x.float(), weight.float().t()) * a + c_row)
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
    ``dk = x^T A`` summed over the clouds, in f32. In the bf16 form (x and
    weight bf16) coef and m_small are rounded to bf16 first, as the TPU
    kernel rounds them, and dx is rounded to bf16 at the end. Returns (dx
    (b, n, c_in) in x's type, dk (c_in, c) f32)."""
    bf16 = kernel_form(x.dtype, weight.dtype) == "bf16"
    if bf16:
        coef, m_small = _bf16_round(coef), _bf16_round(m_small)
    xf = x.float()
    n = x.shape[1]
    points = torch.arange(n, device=x.device)[None, :, None]
    a_mat = torch.where(points == argmax[:, None, :].long(), coef[:, None, :], 0.0)
    dx = torch.matmul(a_mat, weight.float()) + torch.matmul(xf, m_small) + const_row
    dk = torch.einsum("bnd,bnc->dc", xf, a_mat)
    return dx.to(x.dtype), dk


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
    """(b, n, c_in, c) of the kernels' operands, after checking them."""
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
    kernel_form(x.dtype, weight.dtype)
    _check("x", x, (b, n, c_in), x.dtype, x.device)
    _check("weight", weight, (c, c_in), x.dtype, x.device)
    return b, n, c_in, c


def _split_scratch(cols: int, c_in: int, device: torch.device,
                   bf16: bool) -> torch.Tensor:
    """Room for the kernels' tf32 hi and lo copies of the weight operand
    (bf16: its one bf16 copy), its columns padded to whole 128-column
    tiles."""
    size = -(-cols // COLUMN_TILE) * COLUMN_TILE * c_in
    if bf16:
        return torch.empty(size, dtype=torch.bfloat16, device=device)
    return torch.empty((2, size), dtype=torch.float32, device=device)


_DONE: dict = {}


def _done_counters(device: torch.device, count: int) -> torch.Tensor:
    """Zeroed int32 counters, one a (cloud, 256-channel slice), with which the
    TMA bf16 forward finds the block that finishes a slice's last run; the
    kernel sets each back to 0, so they stay zeroed from call to call. One
    set a device, grown as needed: the calls that share it run one at a
    time, as they do on one stream."""
    held = _DONE.get(device)
    if held is None or held.numel() < count:
        held = torch.zeros(max(count, 1024), dtype=torch.int32, device=device)
        _DONE[device] = held
    return held


def pooled_chain_forward(
    x: torch.Tensor, weight: torch.Tensor, a: torch.Tensor, c_row: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """``relu((x @ weight^T) * a + c_row)``, then max and first-index argmax
    over the points, without writing the (b, n, c) activation.

    x (b, n, c_in) and weight (c, c_in), both f32 or both bf16
    (:func:`kernel_form`); a, c_row (c,) f32 (the BatchNorm affine folded
    per channel). Returns (pooled (b, c) f32, argmax (b, c) int32). The
    pooled value is the exact f32 maximum of the kernel's own GEMM; a
    channel that is 0 at every point gives 0, argmax 0.
    """
    if x.device.type == "cpu":
        return pooled_chain_forward_reference(x, weight, a, c_row)
    if x.device.type != "cuda":
        raise ValueError(f"no pooled-chain kernel for device {x.device}")
    b, n, c_in, c = _check_widths(x, weight)
    _check("a", a, (c,), torch.float32, x.device)
    _check("c_row", c_row, (c,), torch.float32, x.device)
    bf16 = x.dtype == torch.bfloat16
    tma = bf16 and bf16_form(c_in) == "tma"
    if tma:
        runs, per_run, grid = tma_forward_plan(b, n, c, build.sms(x.device))
    else:
        runs, per_run = launch_grid(b, n, c, build.sms(x.device))
    pooled = torch.empty((b, c), dtype=torch.float32, device=x.device)
    argmax = torch.empty((b, c), dtype=torch.int32, device=x.device)
    if tma and runs == 1:  # no run's partial best is kept
        part_v, part_i = pooled, argmax
    else:
        part_v = torch.empty((b, runs, c), dtype=torch.float32, device=x.device)
        part_i = torch.empty((b, runs, c), dtype=torch.int32, device=x.device)
    if tma:
        done = _done_counters(x.device, b * -(-c // TMA_FWD_SLICE))
        build.launch(
            "pcp_pooled_chain_forward_bf16_tma", x.device, x.data_ptr(),
            weight.data_ptr(), a.data_ptr(), c_row.data_ptr(), part_v.data_ptr(),
            part_i.data_ptr(), pooled.data_ptr(), argmax.data_ptr(), done.data_ptr(),
            b, n, c_in, c, runs, per_run, grid,
        )
    else:
        w_split = _split_scratch(c, c_in, x.device, bf16)
        build.launch(
            "pcp_pooled_chain_forward_bf16" if bf16 else "pcp_pooled_chain_forward",
            x.device, x.data_ptr(), weight.data_ptr(), w_split.data_ptr(),
            a.data_ptr(), c_row.data_ptr(), part_v.data_ptr(), part_i.data_ptr(),
            pooled.data_ptr(), argmax.data_ptr(), b, n, c_in, c, runs, per_run,
        )
    build.count("pooled_chain_forward_bf16" if bf16 else "pooled_chain_forward")
    return pooled, argmax


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

    x (b, n, c_in) and weight (c, c_in), both f32 or both bf16; coef (b, c)
    f32, argmax (b, c) int32, m_small (c_in, c_in), const_row (c_in,) f32
    (the bf16 form rounds coef and m_small to bf16). Returns (dx (b, n,
    c_in) in x's type, dk (c_in, c) f32), both deterministic; on CUDA dk is
    the transposed view
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
    bf16 = x.dtype == torch.bfloat16
    dx = torch.empty_like(x)
    dk_t = torch.empty((c, c_in), dtype=torch.float32, device=x.device)
    if bf16 and bf16_form(c_in) == "tma":
        _, grid = tma_dx_plan(b, n, build.sms(x.device))
        m_t = torch.empty((c_in, c_in), dtype=torch.bfloat16, device=x.device)
        win_ch = torch.empty((b, c), dtype=torch.int32, device=x.device)
        win_coef = torch.empty((b, c), dtype=torch.float32, device=x.device)
        pt_off = torch.empty((b, n + 1), dtype=torch.int32, device=x.device)
        build.launch(
            "pcp_pooled_chain_backward_bf16_tma", x.device, x.data_ptr(),
            weight.data_ptr(), coef.data_ptr(), argmax.data_ptr(), m_small.data_ptr(),
            m_t.data_ptr(), win_ch.data_ptr(), win_coef.data_ptr(), pt_off.data_ptr(),
            const_row.data_ptr(), dx.data_ptr(), dk_t.data_ptr(), b, n, c_in, c, grid,
        )
    else:
        runs, per_run = launch_grid(b, n, c_in, build.sms(x.device))
        m_split = _split_scratch(c_in, c_in, x.device, bf16)
        build.launch(
            "pcp_pooled_chain_backward_bf16" if bf16 else "pcp_pooled_chain_backward",
            x.device, x.data_ptr(), weight.data_ptr(), coef.data_ptr(),
            argmax.data_ptr(), m_small.data_ptr(), m_split.data_ptr(),
            const_row.data_ptr(), dx.data_ptr(), dk_t.data_ptr(), b, n, c_in, c,
            runs, per_run,
        )
    build.count("pooled_chain_backward_bf16" if bf16 else "pooled_chain_backward")
    return dx, dk_t.t()
