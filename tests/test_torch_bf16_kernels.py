"""The bf16 forms of the pooled-chain kernels (4, 5) and of the neighbour
max/min kernel (7), through their plain versions on the CPU, against the
JAX package's Pallas kernels in interpret mode (the form the JAX package
runs on its accelerator), and the form rules the wrappers apply.

Tolerances, each with its reason:
- pooled forward: the TPU kernel packs the first-index argmax into the low
  ceil(log2 n) mantissa bits, rounding the pooled value to
  23 - ceil(log2 n) bits (ROADMAP, "differences made on purpose"); the
  port's value is the exact f32 maximum. Values agree to one unit of that
  rounding, and an argmax may differ only where the two winners' float64
  values lie within it (a proven tie).
- pooled backward: the same bf16 products summed in f32 in another order,
  then rounded to bf16: dx within one bf16 ulp (2^-7 relative), dk (f32)
  within f32 rounding of its terms.
- chain gradients: at least as close to the f32 naive chain as the JAX
  package's own bf16 Pallas path is (``tests/test_pooled_chain.py``'s bar).
- gather max/min: exact (a selection), NaN included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudprocessing_tpu.core.constants import KERAS_BN_EPSILON
from pointcloudprocessing_tpu.models import fused_pool as jax_fused_pool
from pointcloudprocessing_tpu.ops.pallas.gather_maxmin import (
    gather_maxmin as jax_gather_maxmin,
)
from pointcloudprocessing_tpu.ops.pallas.pooled_chain import (
    pooled_chain_backward as jax_pooled_backward,
)
from pointcloudprocessing_tpu.ops.pallas.pooled_chain import (
    pooled_chain_forward as jax_pooled_forward,
)
from pointcloudprocessing_tpu_torch.models.fused_pool import dense_bn_relu_max
from pointcloudprocessing_tpu_torch.ops.cuda import gather_maxmin as gm
from pointcloudprocessing_tpu_torch.ops.cuda import pooled_chain as pc

BF16 = torch.bfloat16
CIN, C = 128, 256


def _bf16(a: np.ndarray) -> np.ndarray:
    """numpy f32 values rounded to bf16 (the values both packages see)."""
    return torch.from_numpy(a).to(BF16).float().numpy()


def _chain_case(b, n, seed):
    rng = np.random.default_rng(seed)
    x = _bf16(rng.normal(size=(b, n, CIN)).astype(np.float32))
    kernel = (rng.normal(size=(CIN, C)) * 0.2).astype(np.float32)
    a = rng.uniform(0.5, 1.5, C).astype(np.float32)
    c_row = (rng.normal(size=C) * 0.2).astype(np.float32)
    return x, kernel, a, c_row


@pytest.mark.parametrize("b,n,seed", [(4, 64, 0), (4, 128, 1), (4, 256, 2)])
def test_pooled_forward_bf16_matches_pallas(b, n, seed):
    x, kernel, a, c_row = _chain_case(b, n, seed)
    jp, ja = jax_pooled_forward(jnp.asarray(x, jnp.bfloat16), jnp.asarray(kernel),
                                jnp.asarray(a), jnp.asarray(c_row))
    jp, ja = np.asarray(jp), np.asarray(ja)
    xt = torch.from_numpy(x).to(BF16)
    wt = torch.from_numpy(kernel.T.copy()).to(BF16)
    got, arg = pc.pooled_chain_forward(xt, wt, torch.from_numpy(a),
                                       torch.from_numpy(c_row))
    assert got.dtype == torch.float32 and arg.dtype == torch.int32
    got, arg = got.numpy(), arg.numpy()
    unit = 2.0 ** -(23 - max((n - 1).bit_length(), 1))  # the packed rounding
    np.testing.assert_allclose(got, jp, rtol=unit, atol=0.0)
    # every flip a proven tie: the float64 values of both winners agree to
    # the packed rounding
    r64 = np.maximum(np.einsum("bnd,dc->bnc", x.astype(np.float64),
                               wt.float().numpy().T.astype(np.float64))
                     * a + c_row, 0.0)
    for bi, ci in zip(*np.nonzero(arg != ja)):
        mine, theirs = r64[bi, arg[bi, ci], ci], r64[bi, ja[bi, ci], ci]
        assert abs(mine - theirs) <= unit * max(abs(mine), abs(theirs)), (bi, ci)
    assert (arg != ja).mean() < 0.01


def test_pooled_forward_bf16_exact_ties_take_the_first_index():
    """Clouds of 16 repeated rows: every channel's max is attained 16 times
    at once; the first index wins, as jnp.argmax and the JAX kernel's
    packing give it."""
    x, kernel, a, c_row = _chain_case(2, 64, 3)
    x = np.tile(x[:, :4], (1, 16, 1))
    jp, ja = jax_pooled_forward(jnp.asarray(x, jnp.bfloat16), jnp.asarray(kernel),
                                jnp.asarray(a), jnp.asarray(c_row))
    got, arg = pc.pooled_chain_forward(
        torch.from_numpy(x).to(BF16), torch.from_numpy(kernel.T.copy()).to(BF16),
        torch.from_numpy(a), torch.from_numpy(c_row))
    np.testing.assert_array_equal(arg.numpy(), np.asarray(ja))
    assert arg.max() < 4


@pytest.mark.parametrize("b,n,seed", [(4, 64, 4), (4, 256, 5)])
def test_pooled_backward_bf16_matches_pallas(b, n, seed):
    """dx (bf16) and dk (f32) of a non-symmetric m against the TPU kernel:
    it rounds coef, W and m to bf16, sums in f32, writes dx in bf16."""
    x, kernel, _, _ = _chain_case(b, n, seed)
    rng = np.random.default_rng(seed + 10)
    coef = rng.normal(size=(b, C)).astype(np.float32)
    argmax = rng.integers(0, n, (b, C)).astype(np.int32)
    argmax[:, :8] = 3  # many channels win one point
    m = (rng.normal(size=(CIN, CIN)) * 0.05).astype(np.float32)
    row = (rng.normal(size=CIN) * 0.1).astype(np.float32)
    jdx, jdk = jax_pooled_backward(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(kernel), jnp.asarray(coef),
        jnp.asarray(argmax), jnp.asarray(m), jnp.asarray(row))
    assert jdx.dtype == jnp.bfloat16
    dx, dk = pc.pooled_chain_backward(
        torch.from_numpy(x).to(BF16), torch.from_numpy(kernel.T.copy()).to(BF16),
        torch.from_numpy(coef), torch.from_numpy(argmax), torch.from_numpy(m),
        torch.from_numpy(row))
    assert dx.dtype == BF16 and dk.dtype == torch.float32
    want = np.asarray(jdx.astype(jnp.float32))
    np.testing.assert_allclose(dx.float().numpy(), want,
                               rtol=2.0 ** -7, atol=1e-6)
    assert (dx.float().numpy() == want).mean() > 0.95
    terms = np.abs(x).max() * np.abs(_bf16(coef)).sum(axis=0)  # (C,)
    np.testing.assert_allclose(dk.numpy(), np.asarray(jdk), rtol=0.0,
                               atol=float(terms.max()) * 2.0 ** -22)


def _naive(x, kernel, scale, bias):
    """The f32 chain materialised (``tests/test_pooled_chain.py::naive``)."""
    pre = x @ kernel
    mean = jnp.mean(pre, axis=(0, 1))
    var = jnp.mean(jnp.square(pre), axis=(0, 1)) - jnp.square(mean)
    y = (pre - mean) * jax.lax.rsqrt(var + KERAS_BN_EPSILON) * scale + bias
    return jnp.max(jnp.maximum(y, 0.0), axis=1)


def _fro(g, w):
    g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
    return np.linalg.norm(g - w) / (np.linalg.norm(w) + 1e-6)


@pytest.mark.parametrize("b,n,seed", [(4, 64, 6), (4, 256, 7)])
def test_bf16_chain_gradients_as_close_to_f32_as_jax(b, n, seed, monkeypatch):
    """Batch statistics, 128 -> 256: the port's bf16 chain (Gram-matrix
    statistics, both kernels' bf16 forms) against the JAX package's bf16
    Pallas path, each against the f32 naive chain."""
    rng = np.random.default_rng(seed)
    x = _bf16(rng.normal(size=(b, n, CIN)).astype(np.float32))
    kernel = (rng.normal(size=(CIN, C)) * 0.2).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = (rng.normal(size=C) * 0.2).astype(np.float32)
    cfg = (False, 0.99, KERAS_BN_EPSILON, jnp.bfloat16)
    zeros, ones = jnp.zeros(C), jnp.ones(C)

    def jax_loss(xv, k, s, bb):
        out, _, _ = jax_fused_pool.dense_bn_relu_max(cfg, xv, k, s, bb, zeros, ones)
        return jnp.mean(jnp.square(out))

    monkeypatch.setattr(jax_fused_pool, "_FORCE_PALLAS", True)
    jgrads = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(kernel), jnp.asarray(scale),
        jnp.asarray(bias))
    want = jax.grad(lambda *a: jnp.mean(jnp.square(_naive(*a))), argnums=(0, 1, 2, 3))(
        jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(scale), jnp.asarray(bias))

    xt = torch.from_numpy(x).to(BF16).requires_grad_(True)
    wt = torch.from_numpy(kernel.T.copy()).requires_grad_(True)
    st = torch.from_numpy(scale).requires_grad_(True)
    bt = torch.from_numpy(bias).requires_grad_(True)
    pooled, _, _ = dense_bn_relu_max(xt, wt, st, bt, torch.zeros(C), torch.ones(C),
                                     KERAS_BN_EPSILON, False, BF16)
    assert pooled.dtype == torch.float32
    torch.square(pooled).mean().backward()
    assert xt.grad.dtype == BF16 and jgrads[0].dtype == jnp.bfloat16
    got = (xt.grad.float().numpy(), wt.grad.numpy().T, st.grad.numpy(),
           bt.grad.numpy())
    for name, g, j, w in zip(("dx", "dkernel", "dscale", "dbias"), got, jgrads, want):
        assert _fro(g, w) <= _fro(j, w) + 0.05, (name, _fro(g, w), _fro(j, w))
        assert _fro(g, w) < 0.25, (name, _fro(g, w))


def _gather_case(b, n, w, k, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, n, w)).astype(np.float32)
    q[0, 5, :3] = np.nan
    q[-1, 7, 1] = np.inf
    q[-1, 9, 2] = -np.inf
    idx = rng.integers(0, n, (b, n, k)).astype(np.int32)
    idx[0, :, 0] = 5  # every point sees the NaN row
    return _bf16(q), idx


@pytest.mark.parametrize("b,n,w,k,seed", [
    (2, 128, 40, 20, 0), (2, 256, 64, 7, 1), (2, 128, 8, 1, 2), (1, 128, 96, 20, 3),
])
def test_gather_maxmin_bf16_matches_lane_kernel(b, n, w, k, seed):
    """Bit for bit against the lane kernel in interpret mode (which upcasts
    to f32 and back), NaN and infinities included."""
    q, idx = _gather_case(b, n, w, k, seed)
    want = jax_gather_maxmin(jnp.asarray(q, jnp.bfloat16), jnp.asarray(idx),
                             interpret=True)
    got = gm.gather_maxmin(torch.from_numpy(q).to(BF16), torch.from_numpy(idx))
    for g, wnt in zip(got, want):
        assert g.dtype == BF16 and wnt.dtype == jnp.bfloat16
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(wnt.astype(jnp.float32)))



@pytest.mark.parametrize("b,n,w,k,seed,plan_b", [
    # w 72: the ring form's full 64-channel slice and its 8-channel rest
    (2, 128, 72, 20, 4, 64),
    # k 1 at w 72
    (2, 256, 72, 1, 5, 64),
    # n 1,000: the plan cuts each slab into 7 point ranges, which 1,000 is
    # no multiple of (the JAX function's gather fallback: n % 128 != 0)
    (2, 1000, 64, 20, 6, 2),
    # NaN and infinities at n 1,000 and w 136 (two full slices and a rest)
    (1, 1000, 136, 9, 7, 8),
], ids=["w72", "w72-k1", "n1000-ragged-ranges", "n1000-w136"])
def test_gather_maxmin_bf16_matches_jax_at_ring_edges(b, n, w, k, seed, plan_b):
    """The plain version at shapes whose ring plan has a rest launch, k 1
    or point ranges that do not divide n, bit for bit against the JAX
    function in bf16: its lane kernel in interpret mode where n % 128 == 0,
    else its gather_rows fallback; NaN and infinities included
    (``_gather_case``)."""
    plan = gm.gather_plan(plan_b, n, w, 2)
    assert all(step.form == "ring" for step in plan)
    if w % 64:
        assert len(plan) == 2 and plan[1].c_begin == 64 * (w // 64)
    if n % 128:
        assert any(n % step.parts for step in plan)
    q, idx = _gather_case(b, n, w, k, seed)
    want = jax_gather_maxmin(jnp.asarray(q, jnp.bfloat16), jnp.asarray(idx),
                             interpret=n % 128 == 0, allow_pallas=False)
    got = gm.gather_maxmin(torch.from_numpy(q).to(BF16), torch.from_numpy(idx))
    for g, wnt in zip(got, want):
        assert g.dtype == BF16 and wnt.dtype == jnp.bfloat16
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(wnt.astype(jnp.float32)))
    assert np.isnan(got[0].float().numpy()[0, :, :3]).all()


def test_pooled_kernel_form_rule():
    assert pc.kernel_form(torch.float32, torch.float32) == "tf32x3"
    assert pc.kernel_form(BF16, BF16) == "bf16"
    for pair in ((BF16, torch.float32), (torch.float32, BF16),
                 (torch.float16, torch.float16), (torch.float64, torch.float64)):
        with pytest.raises(TypeError):
            pc.kernel_form(*pair)


def test_pooled_wrappers_refuse_what_no_form_takes():
    """On meta tensors (shape and dtype only): the widths check takes
    either form's pair and refuses a mixed or other pair; the wrappers
    refuse a device that is neither the CPU nor CUDA."""
    meta = dict(device="meta")
    for dt in (torch.float32, BF16):
        x = torch.empty((2, 100, 128), dtype=dt, **meta)
        assert pc._check_widths(x, torch.empty((256, 128), dtype=dt, **meta)) == (
            2, 100, 128, 256)
    with pytest.raises(TypeError):
        pc._check_widths(torch.empty((2, 100, 128), dtype=BF16, **meta),
                         torch.empty((256, 128), **meta))
    with pytest.raises(ValueError):
        pc._check_widths(torch.empty((2, 100, 96), dtype=BF16, **meta),
                         torch.empty((256, 96), dtype=BF16, **meta))
    x = torch.empty((2, 100, 128), dtype=BF16, **meta)
    w = torch.empty((256, 128), dtype=BF16, **meta)
    with pytest.raises(ValueError, match="meta"):
        pc.pooled_chain_forward(x, w, torch.empty(256, **meta),
                                torch.empty(256, **meta))
    with pytest.raises(ValueError, match="meta"):
        pc.pooled_chain_backward(x, w, torch.empty((2, 256), **meta),
                                 torch.empty((2, 256), dtype=torch.int32, **meta),
                                 torch.empty((128, 128), **meta),
                                 torch.empty(128, **meta))
    with pytest.raises(ValueError, match="meta"):
        gm.gather_maxmin(torch.empty((2, 100, 8), dtype=BF16, **meta),
                         torch.empty((2, 100, 4), dtype=torch.int32, **meta))


@pytest.mark.parametrize("s,n_max", [(64, 1816), (32, 3632), (16, 7264), (8, 14528)])
def test_gather_form_bf16_slices_where_each_stops_fitting(s, n_max):
    """A bf16 slice keeps the f32 slice's bytes (twice its channels): n x S
    x 2 bytes within a block's shared memory, the next smaller slice one
    point past it, and past S 8 the L2 form, at the f32 form's n."""
    assert n_max * s * 2 <= gm.SHARED_BYTES < (n_max + 1) * s * 2
    assert gm.gather_form(128, n_max, 256, 2) == ("shared", s)
    assert gm.gather_form(128, n_max + 1, 256, 2) == (
        ("shared", s // 2) if s > 8 else ("l2", 0))
    assert gm.gather_form(128, n_max, 256, 4)[1] == s // 2


def test_gather_form_bf16_blocks_and_itemsize_edges():
    """DGCNN's 64 clouds of 1,024 points: S 64 at w 256 and 128 (256 and
    128 blocks), S 32 at w 64 (128 blocks), S 8 at w 3; only 2- and 4-byte
    elements."""
    assert gm.gather_form(64, 1024, 256, 2) == ("shared", 64)
    assert gm.gather_form(64, 1024, 128, 2) == ("shared", 64)
    assert gm.gather_form(64, 1024, 64, 2) == ("shared", 32)
    assert gm.gather_form(64, 1024, 3, 2) == ("shared", 8)
    assert gm.gather_form(1, 1024, 64, 2) == ("shared", 8)
    assert gm.gather_form(64, 1024, 64) == gm.gather_form(64, 1024, 64, 4)
    for itemsize in (1, 3, 8):
        with pytest.raises(ValueError):
            gm.gather_form(64, 1024, 64, itemsize)
