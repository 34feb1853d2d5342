"""Windowed-kNN moment sums: the hand-written CUDA kernel and its plain version.

Counterpart of ``pointcloudprocessing_tpu/ops/pallas/window_normals.py::
windowed_moment_sums`` with its default search (``_moment_sums_for_block``,
"v1"). The TPU kernel builds a (Q, C) distance tile per query block and
sums the moments on the matrix unit with a bf16 hi/lo split; on the H100 one
thread owns one query and recomputes its distances from the candidates
staged in shared memory on each pass, and sums in plain f32
(``csrc/window_normals.cu`` says why and how). The TPU kernel's per-cloud and
per-block grids are launch-overhead devices of the TPU: the port has one
grid, a block per (cloud, query block).

The coordinates must be finite. A CUDA tensor always goes to the kernel,
and any failure raises; a CPU tensor goes to the plain version.
"""

from __future__ import annotations

import torch

from pointcloudprocessing_tpu_torch.ops.cuda import build
from pointcloudprocessing_tpu_torch.ops.knn import full_f32_matmul

LEVELS = 12  # threshold levels m * 2^s, s in [0, LEVELS)
_HUGE_M = 1e37  # a larger nearest distance would overflow m * 2^11
_HUGE = 3e38  # finite "every valid candidate" threshold
_SQRT_HALF = 0.70710678118654752440  # rounds to f32(2^-0.5)
#: the kernel stages 16 B a candidate in shared memory (224 KB of 227)
MAX_CANDIDATES = 14336


def _planes(centered: torch.Tensor, valid_mask: torch.Tensor, window: int,
            q_block: int, layout: str) -> torch.Tensor:
    """Argument checks of the JAX function (its ``:416-429``); returns the
    (b, 3, n) coordinate planes."""
    if layout == "bcn":
        planes = centered
    elif layout == "bnc":
        planes = centered.transpose(1, 2)
    else:
        raise ValueError(f"Unknown layout {layout!r}")
    if planes.dim() != 3 or planes.shape[1] != 3:
        raise ValueError(
            f"centered must be {'(b, 3, n)' if layout == 'bcn' else '(b, n, 3)'}"
            f", got {tuple(centered.shape)}"
        )
    b, _, n = planes.shape
    if valid_mask.shape != (b, n):
        raise ValueError(
            f"valid_mask {tuple(valid_mask.shape)} does not match {b} clouds of "
            f"{n} points"
        )
    if n % q_block or q_block % 128 or window % 128:
        raise ValueError(
            f"windowed_moment_sums needs n % q_block == 0 and 128-aligned "
            f"q_block/window; got n={n} q_block={q_block} window={window}"
        )
    if q_block + 2 * window > n:
        raise ValueError(
            f"candidate window {q_block + 2 * window} exceeds cloud size {n}; "
            "shrink `window`"
        )
    return planes


def _pow2(s: torch.Tensor) -> torch.Tensor:
    """2^s exactly, as f32, from integer levels s in [0, LEVELS)."""
    return ((s.int() + 127) << 23).view(torch.float32)


def window_selection(
    planes: torch.Tensor, valid_mask: torch.Tensor, k: int, window: int,
    q_block: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX kernel's block body for every query block at once: from
    (b, 3, n) planes, the 0/1 selection (b, blocks, Q, C) of each query's
    candidates and the candidates' shifted features (b, blocks, C, 10),
    ``[1, x, y, z, xx, xy, xz, yy, yz, zz]``. Thresholds are formed as the
    kernel forms them (m times an exact power of two; the half level one
    rounding of m * (2^s * f32(2^-0.5))), so the selection is the kernel's
    bit for bit."""
    b, _, n = planes.shape
    c = q_block + 2 * window
    blocks = n // q_block
    q0 = torch.arange(blocks, device=planes.device) * q_block
    start = torch.clamp(q0 - window, min=0, max=n - c)
    cand = start[:, None] + torch.arange(c, device=planes.device)  # (blocks, C)
    px, py, pz = (planes[:, i][:, cand] for i in range(3))  # (b, blocks, C)
    pv = valid_mask[:, cand]
    qx, qy, qz = (planes[:, i].reshape(b, blocks, q_block) for i in range(3))

    dx = qx[..., :, None] - px[..., None, :]
    dy = qy[..., :, None] - py[..., None, :]
    dz = qz[..., :, None] - pz[..., None, :]
    d = dx * dx + dy * dy + dz * dz  # (b, blocks, Q, C)
    del dx, dy, dz
    inf = torch.tensor(float("inf"), device=d.device)
    dm = torch.where(pv[..., None, :], d, inf)
    del d
    m = torch.where(dm > 0.0, dm, inf).amin(dim=-1, keepdim=True)

    def count(thr):
        return (dm <= thr).sum(dim=-1, keepdim=True)

    cnt_top = count(m * _pow2(torch.full_like(m, LEVELS - 1)))
    fallback = (cnt_top < k) | (m > _HUGE_M)
    lo = torch.zeros_like(m, dtype=torch.int32)
    hi = torch.full_like(m, LEVELS - 1, dtype=torch.int32)
    for _ in range(4):
        mid = (lo + hi) >> 1
        ok = count(m * _pow2(mid)) >= k
        hi = torch.where(ok, mid, hi)
        lo = torch.where(ok, lo, mid + 1)
    thr = torch.where(fallback, torch.full_like(m, _HUGE), m * _pow2(hi))
    thr_lo = m * (_pow2(hi) * _SQRT_HALF)
    thr = torch.where((count(thr_lo) >= k) & ~fallback, thr_lo, thr)
    sel = (dm <= thr).float()  # (b, blocks, Q, C)
    del dm

    # the block shift: the valid candidates' mean (JAX kernel :292-299)
    pvf = pv.float()
    nv = torch.clamp(pvf.sum(dim=-1, keepdim=True), min=1.0)
    ax, ay, az = (p - (p * pvf).sum(dim=-1, keepdim=True) / nv
                  for p in (px, py, pz))
    feats = torch.stack(
        [torch.ones_like(ax), ax, ay, az, ax * ax, ax * ay, ax * az, ay * ay,
         ay * az, az * az], dim=-1)  # (b, blocks, C, 10)
    return sel, feats


def windowed_moment_sums_reference(
    centered: torch.Tensor,
    valid_mask: torch.Tensor,
    k: int,
    window: int = 256,
    q_block: int = 256,
    layout: str = "bnc",
) -> tuple[torch.Tensor, ...]:
    """Plain version, with the arguments and outputs of
    :func:`windowed_moment_sums`: :func:`window_selection`, then the sums
    as one f32 matmul (TF32 off)."""
    planes = _planes(centered, valid_mask, window, q_block, layout).float()
    b, _, n = planes.shape
    sel, feats = window_selection(planes, valid_mask.bool(), k, window, q_block)
    with full_f32_matmul():
        sums = torch.matmul(sel, feats)  # (b, blocks, Q, 10)
    return tuple(sums.reshape(b, n, 10).unbind(-1))


def windowed_moment_sums(
    centered: torch.Tensor,
    valid_mask: torch.Tensor,
    k: int,
    window: int = 256,
    q_block: int = 256,
    layout: str = "bnc",
) -> tuple[torch.Tensor, ...]:
    """Per-point masked neighbourhood moment sums over an index window.

    centered: (b, n, 3) per-cloud-centred f32 coordinates in a spatially
    local order (Morton / voxel-sorted), or plane-major (b, 3, n) with
    ``layout='bcn'``, the kernel's own layout (the 'bnc' form pays a
    transpose copy); valid_mask: (b, n) bool; k: the neighbourhood size the
    threshold search aims at; window: the one-sided candidate half-width W
    (multiple of 128); q_block: queries per block (128 or 256, divides n).

    Returns 10 (b, n) f32 tensors (cnt, sx, sy, sz, sxx, sxy, sxz, syy, syz,
    szz). CONTRACT: the sums are taken in coordinates shifted by a per-block
    constant (the block's valid-candidate mean); form only shift-invariant
    quantities from them, such as the covariance ``sxx/cnt - (sx/cnt)^2``.
    """
    if centered.device.type == "cpu":
        return windowed_moment_sums_reference(
            centered, valid_mask, k, window, q_block, layout)
    if centered.device.type != "cuda":
        raise ValueError(f"no window-moments kernel for device {centered.device}")
    planes = _planes(centered, valid_mask, window, q_block, layout)
    if q_block not in (128, 256):
        raise ValueError(f"the kernel takes q_block 128 or 256, got {q_block}")
    if q_block + 2 * window > MAX_CANDIDATES:
        raise ValueError(
            f"the kernel stages at most {MAX_CANDIDATES} candidates, got "
            f"{q_block + 2 * window}; shrink `window`")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if centered.dtype != torch.float32 or valid_mask.dtype != torch.bool:
        raise TypeError(
            f"need f32 coordinates and a bool valid_mask, got {centered.dtype} "
            f"and {valid_mask.dtype}")
    if valid_mask.device != centered.device:
        raise ValueError("centered and valid_mask must be on one device")
    if layout == "bnc":
        planes = planes.contiguous()
    if not (planes.is_contiguous() and valid_mask.is_contiguous()):
        raise ValueError("centered and valid_mask must be contiguous")
    b, _, n = planes.shape
    if b > 65535:
        raise ValueError(f"the kernel takes at most 65535 clouds, got {b}")
    out = torch.empty((10, b, n), dtype=torch.float32, device=planes.device)
    lib = build.load("window_normals")
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.pcp_window_moments(
            planes.data_ptr(), valid_mask.data_ptr(), out.data_ptr(), b, n, k,
            window, q_block, stream,
        )
    build.check(lib, code, "window moments launch")
    windowed_moment_sums.launches += 1
    return tuple(out.unbind(0))


#: kernel launches in this process (CPU calls and refusals do not count)
windowed_moment_sums.launches = 0
