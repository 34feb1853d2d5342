"""The pooled-chain kernels' arithmetic and launch plan, on the CPU.

The kernels (``csrc/pooled_chain.cu``) run only on the card; what they
compute is held here through its parts:

- ``tf32_split`` and ``tf32_split_x``, the kernels' 3xTF32 splits of the
  weight and of x, bit for bit against a rounding computed independently
  (ties, subnormals, infinities, NaN, and values next to a power of two);
- an emulation of the kernels' 3xTF32 product (lo*hi, hi*lo, then hi*hi a
  k-step of 8, one f32 rounding a product) against a float64 product, within
  ``chip_smoke.py``'s GEMM-rounding bar, where 1xTF32 is not;
- an emulation of the forward's max: a thread's rows in increasing order,
  the lanes of a column, the warp rows and the runs, combined as the kernel
  combines them, against ``amax``/``argmax`` on ties and NaN;
- ``launch_grid`` at its edges;
- the plain backward against a non-symmetric m: ``x @ m``, not ``x @ m^T``.
"""

import math

import numpy as np
import pytest
import torch

from pointcloudprocessing_tpu_torch.ops.cuda import pooled_chain as pc


def _rna_expected(v: float) -> float:
    """Round an f32 value to 10 mantissa bits, ties away from zero, in
    float64: the quantum is 2^(e - 11) for |v| = m 2^e (0.5 <= m < 1), and
    2^-136 (13 bits above the f32 subnormal step) below the normals."""
    if math.isnan(v) or math.isinf(v) or v == 0.0:
        return v
    _, e = math.frexp(v)
    q = 2.0 ** max(e - 11, -136)
    r = math.copysign(math.floor(abs(v) / q + 0.5) * q, v)
    return math.copysign(math.inf, v) if abs(r) >= 2.0 ** 128 else r


_F32_MAX = float(np.finfo(np.float32).max)
_CASES = {
    "one": (1.0, 1.0),
    "tie up": (1 + 2**-11, 1 + 2**-10),
    "tie 1.5 ulp": (1 + 3 * 2**-11, 1 + 2**-9),
    "below tie": (1 + 2**-11 - 2**-23, 1.0),
    "negative tie": (-(1 + 2**-11), -(1 + 2**-10)),
    "below two": (2 - 2**-23, 2.0),
    "above two": (2 + 2**-22, 2.0),
    "below a half": (0.5 - 2**-25, 0.5),
    "smallest subnormal": (2**-149, 0.0),
    "subnormal tie": (2**-137, 2**-136),
    "subnormal 1.5 step": (3 * 2**-137, 2**-135),
    "largest subnormal": (2**-126 - 2**-149, 2**-126),
    "max finite": (_F32_MAX, math.inf),
    "-max finite": (-_F32_MAX, -math.inf),
}


@pytest.mark.parametrize("name", list(_CASES))
def test_tf32_split_rounds_like_cvt_rna(name):
    v, want_hi = _CASES[name]
    assert _rna_expected(v) == want_hi
    hi, lo = pc.tf32_split(torch.tensor([v], dtype=torch.float32))
    assert hi.item() == want_hi
    assert hi.view(torch.int32).item() & 0x1FFF == 0
    if math.isfinite(want_hi):
        rest = float(np.float32(v) - np.float32(want_hi))
        assert lo.item() == _rna_expected(rest)
        # below the normals lo keeps 10 bits above the f32 subnormal step too
        assert abs(v - (hi.item() + lo.item())) <= 2.0**-21 * abs(v) + 2.0**-137


@pytest.mark.parametrize("name", list(_CASES))
def test_tf32_split_x_rounds_hi_like_cvt_rna_and_cuts_lo(name):
    v, want_hi = _CASES[name]
    hi, lo = pc.tf32_split_x(torch.tensor([v], dtype=torch.float32))
    assert hi.item() == want_hi
    if math.isfinite(want_hi):
        rest = np.float32(v) - np.float32(want_hi)
        want_lo = np.frombuffer((np.array([rest], np.float32).view(np.uint32)
                                 & np.uint32(0xFFFFE000)).tobytes(), np.float32)[0]
        assert lo.item() == float(want_lo)
        assert abs(v - (hi.item() + lo.item())) <= 2.0**-20 * abs(v) + 2.0**-136


def test_tf32_split_x_keeps_nan_in_lo():
    # 0x7fffffff is the NaN the card's arithmetic makes; its hi wraps to -0
    nans = torch.tensor([0x7FFFFFFF, 0x7FC00000, -1, -0x400000],
                        dtype=torch.int32).view(torch.float32)
    hi, lo = pc.tf32_split_x(nans)
    assert torch.isnan(lo).all()
    assert hi[0].item() == 0.0 and math.copysign(1.0, hi[0].item()) == -1.0
    w_hi, w_lo = pc.tf32_split(torch.tensor([0.5]))
    assert torch.isnan(lo * w_hi).all() and torch.isnan(hi * w_lo + lo * w_hi).all()


def test_tf32_split_specials_and_random_values():
    hi, lo = pc.tf32_split(torch.tensor([math.inf, -math.inf, math.nan, 0.0, -0.0]))
    assert hi[0].item() == math.inf and hi[1].item() == -math.inf
    assert math.isnan(lo[0].item()) and math.isnan(lo[1].item())
    assert math.isnan(hi[2].item()) and math.isnan(lo[2].item())
    assert hi[3].item() == 0.0 and hi[4].view(torch.int32).item() == -(2**31)
    rng = np.random.default_rng(4)
    v = (rng.normal(size=4096) * 2.0 ** rng.uniform(-140, 120, 4096)).astype(np.float32)
    hi, lo = pc.tf32_split(torch.from_numpy(v))
    want_hi = np.array([_rna_expected(float(e)) for e in v])
    np.testing.assert_array_equal(hi.numpy().astype(np.float64), want_hi)
    want_lo = [_rna_expected(float(np.float32(e) - np.float32(h)))
               for e, h in zip(v, hi.numpy())]
    np.testing.assert_array_equal(lo.numpy().astype(np.float64), want_lo)


def _gemm_3xtf32(x: np.ndarray, w: np.ndarray, terms: int = 3) -> np.ndarray:
    """x (p, c_in) @ w (c, c_in)^T in the kernels' order: per k-step of 8,
    the lo*hi, hi*lo and hi*hi products each add their 8 exact terms to the
    f32 accumulator with one rounding (``terms`` 1: hi*hi alone)."""
    xh, xl = (t.numpy().astype(np.float64) for t in pc.tf32_split_x(torch.from_numpy(x)))
    wh, wl = (t.numpy().astype(np.float64) for t in pc.tf32_split(torch.from_numpy(w)))
    acc = np.zeros((x.shape[0], w.shape[0]), np.float32)
    pairs = [(xl, wh), (xh, wl), (xh, wh)][3 - terms:]
    for k in range(0, x.shape[1], 8):
        for xa, wb in pairs:
            part = xa[:, k:k + 8] @ wb[:, k:k + 8].T
            acc = (acc.astype(np.float64) + part).astype(np.float32)
    return acc


def _chain_inputs(kind: str):
    rng = np.random.default_rng({"chain": 1, "wide": 2}[kind])
    c_in, c = 128, 64
    if kind == "chain":
        x = np.maximum(rng.normal(size=(256, c_in)), 0.0)
        w = rng.normal(size=(c, c_in)) * 0.1
    else:  # magnitudes over 2^-20 .. 2^20, both signs
        x = rng.normal(size=(256, c_in)) * 2.0 ** rng.uniform(-20, 20, (256, c_in))
        w = rng.normal(size=(c, c_in)) * 2.0 ** rng.uniform(-20, 20, (c, c_in))
    return x.astype(np.float32), w.astype(np.float32)


@pytest.mark.parametrize("kind", ["chain", "wide"])
def test_3xtf32_product_within_the_gemm_bar(kind):
    """chip_smoke.py holds each pre-activation to c_in ulps of
    sum_k |x_k w_k| (c_in 2^-23 of it): 3xTF32 is far inside it, 1xTF32
    (~2^-11 a product) is not."""
    x, w = _chain_inputs(kind)
    exact = x.astype(np.float64) @ w.astype(np.float64).T
    bar = x.shape[1] * 2.0**-23 * (np.abs(x).astype(np.float64) @ np.abs(w).T)
    err = np.abs(_gemm_3xtf32(x, w) - exact)
    assert (err <= bar).all(), (err / bar).max()
    assert (err <= bar / 8).all(), (err / bar).max()
    err1 = np.abs(_gemm_3xtf32(x, w, terms=1) - exact)
    assert (err1 > bar).any()


# ----------------------------------------------------------- the forward max

_NOT_SET = (-math.inf, 0)


def _better(v, i, bv, bi):
    vn, bn = math.isnan(v), math.isnan(bv)
    if vn or bn:
        return vn and (not bn or i < bi)
    return v > bv or (v == bv and i < bi)


def _beats_earlier(v, bv):
    return not (v <= bv) and bv == bv


def _kernel_max(r: np.ndarray, runs: int, per_run: int):
    """The forward's max over one (cloud, channel) column of affine outputs
    y (n,), before relu, as the kernel combines it: a thread (warp w, lane
    group g) visits rows tile * 128 + 16 w + 8 h + g in (tile, h) order with
    beats_earlier; the 8 lane groups combine by xor shuffles over lane bits
    2-4, then the 8 warps in order with better; the runs in order with
    beats_earlier; then relu: a max <= 0 is 0 at index 0."""
    n = r.shape[0]
    run_best = []
    for run in range(runs):
        p_begin = run * per_run * 128
        p_end = min(n, p_begin + per_run * 128)
        tiles = -(-(p_end - p_begin) // 128)
        warps = []
        for w in range(8):
            lanes = []
            for g in range(8):
                bv, bi = _NOT_SET
                for tile in range(tiles):
                    for h in range(2):
                        p = p_begin + tile * 128 + 16 * w + 8 * h + g
                        if p < p_end and _beats_earlier(r[p], bv):
                            bv, bi = r[p], p
                lanes.append((bv, bi))
            for off in (1, 2, 4):  # lane bits 2, 3, 4 are g's bits 0, 1, 2
                lanes = [lanes[g ^ off] if _better(*lanes[g ^ off], *lanes[g])
                         else lanes[g] for g in range(8)]
            warps.append(lanes[0])
        best = warps[0]
        for other in warps[1:]:
            if _better(*other, *best):
                best = other
        run_best.append(best)
    bv, bi = _NOT_SET
    for v, i in run_best:
        if _beats_earlier(v, bv):
            bv, bi = v, i
    return (0.0, 0) if bv <= 0.0 else (bv, bi)


@pytest.mark.parametrize("n", [1, 100, 300, 1000])
def test_kernel_max_order_gives_the_first_index(n):
    """Ties (a few distinct values repeated), columns at or below 0 (relu's
    zeros) and NaN: the kernel's order of combination, taken over the
    values before relu, gives relu's amax and first argmax, with the first
    NaN winning, for every split into runs."""
    rng = np.random.default_rng(n)
    cols = []
    for kind in range(7):
        pool = rng.normal(size=5).astype(np.float32)
        y = pool[rng.integers(0, 5, n)]
        if kind == 1:
            y[:] = -np.abs(y) - 1.0  # a dead channel
        if kind == 2:
            y[:] = np.minimum(y, 0.0)  # relu 0 everywhere, some exact zeros
        if kind >= 5 and n > 1:
            y[rng.integers(0, n, 2)] = np.nan
        cols.append(y)
    tiles = -(-n // 128)
    for runs in range(1, tiles + 1):
        per_run = -(-tiles // runs)
        runs = -(-tiles // per_run)
        for y in cols:
            v, i = _kernel_max(y, runs, per_run)
            t = torch.relu(torch.from_numpy(y))
            assert i == int(torch.argmax(t))
            assert (math.isnan(v) and math.isnan(t.amax().item())) or v == t.amax().item()


# --------------------------------------------------------------- launch plan

@pytest.mark.parametrize("b, n, cols", [
    (8, 8192, 1024), (32, 1024, 1024), (8, 8192, 128), (1, 5, 1024),
    (1, 1000, 64), (1, 8191, 4096), (4, 100, 64), (2, 1000, 4096),
    (3, 8191, 192), (1, 128, 128), (1, 129, 128), (600, 300, 128)])
@pytest.mark.parametrize("sms", [132, 1])
def test_launch_grid_covers_every_tile_once(b, n, cols, sms):
    runs, per_run = pc.launch_grid(b, n, cols, sms)
    tiles = -(-n // pc.POINT_TILE)
    pairs = b * -(-cols // pc.COLUMN_TILE)
    assert 1 <= runs <= tiles and per_run >= 1
    assert (runs - 1) * per_run < tiles <= runs * per_run  # no run empty
    assert runs * pairs <= max(sms, pairs)  # about one block an SM
    if sms == 1 or pairs >= sms:
        assert runs == 1


def test_launch_grid_at_the_training_shapes():
    assert pc.launch_grid(8, 8192, 1024, 132) == (2, 32)  # case A forward
    assert pc.launch_grid(8, 8192, 128, 132) == (16, 4)  # case A backward
    assert pc.launch_grid(32, 1024, 1024, 132) == (1, 8)  # case B forward
    assert pc.launch_grid(32, 1024, 128, 132) == (4, 2)  # case B backward


def test_plain_backward_multiplies_by_m_not_its_transpose():
    rng = np.random.default_rng(12)
    b, n, c_in, c = 2, 40, 64, 64
    x = torch.from_numpy(rng.normal(size=(b, n, c_in)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(c, c_in)).astype(np.float32))
    m = torch.from_numpy(rng.normal(size=(c_in, c_in)).astype(np.float32))
    assert (m - m.t()).abs().max() > 1.0
    argmax = torch.zeros((b, c), dtype=torch.int32)
    dx, dk = pc.pooled_chain_backward(
        x, w, torch.zeros(b, c), argmax, m, torch.zeros(c_in))
    torch.testing.assert_close(dx, torch.matmul(x, m), rtol=1e-6, atol=1e-5)
    assert (dx - torch.matmul(x, m.t())).abs().max() > 1.0
    assert torch.equal(dk, torch.zeros(c_in, c))
