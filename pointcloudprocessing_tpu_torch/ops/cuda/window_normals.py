"""Windowed-kNN moment sums: the hand-written CUDA kernel and its plain version.

Counterpart of ``pointcloudprocessing_tpu/ops/pallas/window_normals.py::
windowed_moment_sums`` with its default search (``_moment_sums_for_block``,
"v1"). The TPU kernel builds a (Q, C) distance tile per query block, runs a
counting search over it and sums the moments on the matrix unit with a bf16
hi/lo split. On the H100 the search reads two order statistics a query, m
and d_(k) (:func:`window_selection_by_order` is its plain form), so each
distance is computed twice, not eight times; the candidates stream through
shared memory in tiles, so any window runs; the sums are plain f32
(``csrc/window_normals.cu`` says why and how). :func:`kernel_form` picks the
kernel's form from k and the window.

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
#: the kernel's register bounds on k: it keeps a query's k smallest
#: distances in KMAX registers; a larger k takes the counting search
REGISTER_FORMS = (8, 16, 32)
#: the most candidates staged as one shared tile (16 B each, 32 KB); a
#: larger window streams through two tiles of STREAM_TILE
RESIDENT_MAX = 2048
STREAM_TILE = 1024


def kernel_form(k: int, q_block: int, window: int) -> tuple[int, int]:
    """The kernel's form for the k-nearest search over C = q_block + 2 *
    window candidates: (kmax, tile). kmax is the least register bound in
    ``REGISTER_FORMS`` that holds k, or 0 (the counting search, eight passes
    over the candidates) above 32; tile is the candidates a shared tile
    holds: the whole window up to ``RESIDENT_MAX``, else ``STREAM_TILE``,
    double-buffered and streamed by every pass."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    kmax = next((f for f in REGISTER_FORMS if k <= f), 0)
    c = q_block + 2 * window
    return kmax, c if c <= RESIDENT_MAX else STREAM_TILE


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


def _window_distances(planes, valid_mask, window, q_block):
    """Every query block's candidates and distances: dm (b, blocks, Q, C),
    +inf at invalid candidates; the candidates' coordinates and validity
    (b, blocks, C) each."""
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
    return torch.where(pv[..., None, :], d, inf), (px, py, pz, pv)


def _nearest_positive(dm: torch.Tensor) -> torch.Tensor:
    """m: each query's least candidate distance > 0 (+inf if none)."""
    inf = torch.tensor(float("inf"), device=dm.device)
    return torch.where(dm > 0.0, dm, inf).amin(dim=-1, keepdim=True)


def _block_sum(v: torch.Tensor, q_block: int) -> torch.Tensor:
    """Sum over the candidates (last axis) in the kernel's fixed order, as
    q_block threads would: thread i a serial sum of candidates i, i +
    q_block, ...; a shuffle-down tree over each 32 threads; the 32-thread
    totals in order."""
    c = v.shape[-1]
    rows = -(-c // q_block)
    v = torch.nn.functional.pad(v, (0, rows * q_block - c))
    part = v[..., :q_block]
    for r in range(1, rows):
        part = part + v[..., r * q_block:(r + 1) * q_block]
    part = part.reshape(*part.shape[:-1], q_block // 32, 32)
    for off in (16, 8, 4, 2, 1):
        part = part[..., :off] + part[..., off:2 * off]
    total = torch.zeros_like(part[..., 0, 0])
    for w in range(q_block // 32):
        total = total + part[..., w, 0]
    return total[..., None]


def _features(px, py, pz, pv, q_block) -> torch.Tensor:
    """The candidates' shifted features (b, blocks, C, 10), ``[1, x, y, z,
    xx, xy, xz, yy, yz, zz]``, about the block shift: the valid candidates'
    mean (JAX kernel :292-299), summed in the kernel's order."""
    pvf = pv.float()
    nv = torch.clamp(_block_sum(pvf, q_block), min=1.0)
    ax, ay, az = (p - _block_sum(p * pvf, q_block) / nv for p in (px, py, pz))
    return torch.stack(
        [torch.ones_like(ax), ax, ay, az, ax * ax, ax * ay, ax * az, ay * ay,
         ay * az, az * az], dim=-1)


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
    dm, cand = _window_distances(planes, valid_mask, window, q_block)
    m = _nearest_positive(dm)

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
    return sel, _features(*cand, q_block)


def order_threshold(m: torch.Tensor, dk: torch.Tensor | None) -> torch.Tensor:
    """The counting search's threshold from two order statistics of a
    query's candidates: m, the least distance > 0, and d_(k), the k-th
    smallest (None when k exceeds the candidates: no count reaches k). "At
    least k candidates within t" is "d_(k) <= t", so each count's test is
    one compare, against the same float thresholds."""
    if dk is None:
        return torch.full_like(m, _HUGE)
    fallback = ~(dk <= m * _pow2(torch.full_like(m, LEVELS - 1))) | (m > _HUGE_M)
    lo = torch.zeros_like(m, dtype=torch.int32)
    hi = torch.full_like(m, LEVELS - 1, dtype=torch.int32)
    for _ in range(4):
        mid = (lo + hi) >> 1
        ok = dk <= m * _pow2(mid)
        hi = torch.where(ok, mid, hi)
        lo = torch.where(ok, lo, mid + 1)
    thr_lo = m * (_pow2(hi) * _SQRT_HALF)
    thr = torch.where(dk <= thr_lo, thr_lo, m * _pow2(hi))
    return torch.where(fallback, torch.full_like(m, _HUGE), thr)


def window_selection_by_order(
    planes: torch.Tensor, valid_mask: torch.Tensor, k: int, window: int,
    q_block: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`window_selection` as the kernel computes it: m and d_(k) of
    each query's candidates, then :func:`order_threshold`. The same
    selection bit for bit."""
    dm, cand = _window_distances(planes, valid_mask, window, q_block)
    dk = (dm.kthvalue(k, dim=-1, keepdim=True).values
          if k <= dm.shape[-1] else None)
    thr = order_threshold(_nearest_positive(dm), dk)
    sel = (dm <= thr).float()
    del dm
    return sel, _features(*cand, q_block)


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


def launch_plan(
    centered: torch.Tensor,
    valid_mask: torch.Tensor,
    k: int,
    window: int,
    q_block: int,
    layout: str,
) -> tuple[torch.Tensor, int, int]:
    """The kernel's checks on a call's arguments, which touch no data (meta
    tensors will do): the (b, 3, n) planes and :func:`kernel_form`'s (kmax,
    tile). Every input the JAX function takes passes; a wrong dtype, a
    device mismatch or a non-contiguous input raises."""
    planes = _planes(centered, valid_mask, window, q_block, layout)
    kmax, tile = kernel_form(k, q_block, window)
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
    return planes, kmax, tile


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
    (multiple of 128); q_block: queries per block (a multiple of 128 that
    divides n).

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
    planes, kmax, tile = launch_plan(centered, valid_mask, k, window, q_block,
                                     layout)
    b, _, n = planes.shape
    out = torch.empty((10, b, n), dtype=torch.float32, device=planes.device)
    # the packed (x, y, z, w) points, the bounding box of each 16, then each
    # query block's shift
    scratch = torch.empty((b * n + b * n // 8 + b * (n // q_block), 4),
                          dtype=torch.float32, device=planes.device)
    build.launch("pcp_window_moments", planes.device,
                 planes.data_ptr(), valid_mask.data_ptr(), scratch.data_ptr(),
                 out.data_ptr(), b, n, k, window, q_block, kmax, tile)
    build.count("windowed_moment_sums")
    return tuple(out.unbind(0))
