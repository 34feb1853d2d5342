"""The port's pooled chain against the JAX package on the CPU.

- The kernels' plain versions (``ops/cuda/pooled_chain.py``) against the
  JAX Pallas kernels, run in interpret mode as ``tests/test_pooled_chain.py``
  runs them. The JAX forward packs the argmax into the low mantissa bits,
  so its pooled value carries a rounding of 2^-(23 - ceil(log2 n)) and
  near-tied winners may flip: the forward is held at that scale, with the
  winner-value check. The backward is pure matmul algebra: rtol 1e-5.
- The autograd Functions of ``models/fused_pool.py`` in both BatchNorm modes
  against JAX ``fused_pool.dense_bn_relu_max`` (its jnp path, f32), with the
  tolerances of ``tests/test_fused_pool.py``: forward rtol 2e-5 / atol 2e-6,
  gradients rtol 2e-4 / atol 2e-5.
- Batch-statistics BatchNorm and the pooled block's running-statistics
  update against Flax.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudprocessing_tpu.core.constants import KERAS_BN_EPSILON
from pointcloudprocessing_tpu.models import fused_pool as jax_fused_pool
from pointcloudprocessing_tpu.ops.pallas import pooled_chain as jax_pooled_chain
from pointcloudprocessing_tpu_torch.models.fused_pool import dense_bn_relu_max
from pointcloudprocessing_tpu_torch.ops.cuda import pooled_chain

# n = 128 is one JAX tile per cloud at tb = 4 (tn = 256 does not divide it,
# so tn = 128); two clouds per grid step exercise its batch tiling
B, N, CIN, C = 4, 128, 128, 256


def t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def chain_inputs():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(B, N, CIN)).astype(np.float32)
    kernel = (rng.normal(size=(CIN, C)) * 0.1).astype(np.float32)
    a = rng.uniform(0.5, 1.5, C).astype(np.float32)
    c_row = (rng.normal(size=C) * 0.1).astype(np.float32)
    c_row[:8] = -1e4  # channels that are 0 at every point
    return x, kernel, a, c_row


@pytest.fixture(scope="module")
def jax_forward(chain_inputs):
    x, kernel, a, c_row = chain_inputs
    pooled, argmax = jax_pooled_chain.pooled_chain_forward(
        jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(a), jnp.asarray(c_row))
    return np.asarray(pooled), np.asarray(argmax)


def test_forward_reference_matches_jax_kernel(chain_inputs, jax_forward):
    x, kernel, a, c_row = chain_inputs
    want_pooled, want_arg = jax_forward
    pooled, argmax = pooled_chain.pooled_chain_forward(
        t(x), t(kernel.T.copy()), t(a), t(c_row))
    assert pooled.dtype == torch.float32 and argmax.dtype == torch.int32
    # the JAX kernel rounds pooled to 23 - ceil(log2 N) mantissa bits
    tol = 2.0 ** -(23 - (N - 1).bit_length())
    np.testing.assert_allclose(pooled.numpy(), want_pooled, rtol=2 * tol, atol=1e-6)
    # a differing winner must hold the max within that rounding
    r = np.maximum((x @ kernel) * a + c_row, 0.0)
    got_r = np.take_along_axis(r, argmax.numpy()[:, None, :].astype(np.int64),
                               axis=1)[:, 0, :]
    np.testing.assert_allclose(got_r, want_pooled, rtol=2 * tol, atol=1e-6)
    assert (argmax.numpy() == want_arg).mean() > 0.98
    # dead channels: pooled 0 at argmax 0, in both
    assert (pooled.numpy()[:, :8] == 0).all() and (argmax.numpy()[:, :8] == 0).all()
    assert (want_arg[:, :8] == 0).all()


def test_forward_reference_ties_go_to_the_first_index():
    """Rows repeated within a cloud tie exactly; the first one wins, as
    jnp.argmax decides."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 64, 64)).astype(np.float32)
    x[:, 40] = x[:, 9]
    x[:, 50:] = x[:, 3:17]
    w = rng.normal(size=(128, 64)).astype(np.float32)
    ones, zeros = np.ones(128, np.float32), np.zeros(128, np.float32)
    _, argmax = pooled_chain.pooled_chain_forward(t(x), t(w), t(ones), t(zeros))
    want = np.argmax(np.maximum(x @ w.T, 0.0), axis=1)
    np.testing.assert_array_equal(argmax.numpy(), want)
    assert not np.isin(argmax.numpy(), [40, *range(50, 64)]).any()


def test_forward_reference_propagates_nan():
    """A NaN pre-activation (a NaN point, or a NaN BatchNorm factor when
    var + eps rounds to 0 or below) pools to NaN at its first index, as
    numpy's and jnp's max and argmax give it; the CUDA kernel is held to
    the same on the card."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 64, 64)).astype(np.float32)
    x[1, 37, 5] = np.nan
    x[1, 50, 9] = np.nan
    w = rng.normal(size=(128, 64)).astype(np.float32)
    a, c_row = np.ones(128, np.float32), np.zeros(128, np.float32)
    a[[3, 70]] = np.nan
    pooled, argmax = pooled_chain.pooled_chain_forward(t(x), t(w), t(a), t(c_row))
    r = np.maximum((x @ w.T) * a + c_row, 0.0)  # np.maximum propagates NaN
    np.testing.assert_array_equal(pooled.numpy(), r.max(axis=1))
    np.testing.assert_array_equal(argmax.numpy(), np.argmax(r, axis=1))
    nan_a = np.isnan(a)
    assert np.isnan(pooled.numpy()).sum() == 128 + nan_a.sum()
    assert (argmax.numpy()[1, ~nan_a] == 37).all()
    assert (argmax.numpy()[:, nan_a] == 0).all()


def test_backward_reference_matches_jax_kernel():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(B, N, CIN)).astype(np.float32)
    kernel = (rng.normal(size=(CIN, C)) * 0.2).astype(np.float32)
    coef = rng.normal(size=(B, C)).astype(np.float32)
    argmax = rng.integers(0, N, (B, C)).astype(np.int32)
    argmax[:, ::3] = 17  # many channels win one point
    m_small = (rng.normal(size=(CIN, CIN)) * 0.01).astype(np.float32)
    const_row = (rng.normal(size=CIN) * 0.01).astype(np.float32)
    want_dx, want_dk = jax_pooled_chain.pooled_chain_backward(
        *map(jnp.asarray, (x, kernel, coef, argmax, m_small, const_row)))
    dx, dk = pooled_chain.pooled_chain_backward(
        t(x), t(kernel.T.copy()), t(coef), t(argmax), t(m_small), t(const_row))
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dk.numpy(), np.asarray(want_dk), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize(
    "shape", [(4, 64, 100, 128), (4, 64, 128, 96), (4, 0, 128, 128)],
    ids=["c_in", "c", "empty"])
def test_kernel_width_contract(shape):
    """Widths the kernels do not tile raise before any launch."""
    b, n, c_in, c = shape
    with pytest.raises(ValueError, match="multiples of 64"):
        pooled_chain._check_widths(torch.zeros(b, n, c_in), torch.zeros(c, c_in))


# ------------------------------------------------------------- fused_pool

FB, FN, FCIN, FC = 4, 24, 8, 16  # tests/test_fused_pool.py's shapes


@pytest.fixture(scope="module")
def fused_args():
    rng = np.random.default_rng(42)
    return (
        rng.normal(size=(FB, FN, FCIN)).astype(np.float32),
        (rng.normal(size=(FCIN, FC)) * 0.4).astype(np.float32),
        rng.uniform(0.5, 1.5, FC).astype(np.float32),
        (rng.normal(size=FC) * 0.2).astype(np.float32),
        (rng.normal(size=FC) * 0.1).astype(np.float32),
        rng.uniform(0.5, 2.0, FC).astype(np.float32),
    )


def _jax_fused(args, use_running):
    x, kernel, scale, bias, mean_r, var_r = map(jnp.asarray, args)
    cfg = (use_running, 0.99, KERAS_BN_EPSILON, None)

    def loss(x, kernel, scale, bias):
        out, _, _ = jax_fused_pool.dense_bn_relu_max(
            cfg, x, kernel, scale, bias, mean_r, var_r)
        return jnp.sum(jnp.sin(out) * out)

    outs = jax_fused_pool.dense_bn_relu_max(cfg, x, kernel, scale, bias, mean_r, var_r)
    grads = jax.grad(loss, argnums=(0, 1, 2, 3))(x, kernel, scale, bias)
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


@pytest.mark.parametrize("use_running", [False, True], ids=["batch", "running"])
def test_fused_pool_matches_jax(fused_args, use_running):
    want_outs, want_grads = _jax_fused(fused_args, use_running)
    x, kernel, scale, bias, mean_r, var_r = (torch.from_numpy(a.copy()) for a in fused_args)
    weight = kernel.t().contiguous()
    for p in (x, weight, scale, bias):
        p.requires_grad_(True)
    outs = dense_bn_relu_max(x, weight, scale, bias, mean_r, var_r,
                             KERAS_BN_EPSILON, use_running)
    for name, g, w in zip(("pooled", "mean", "var"), outs, want_outs):
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=2e-5, atol=2e-6,
                                   err_msg=name)
    pooled = outs[0]
    torch.sum(torch.sin(pooled) * pooled).backward()
    got = (x.grad, weight.grad.t(), scale.grad, bias.grad)
    for name, g, w in zip(("dx", "dkernel", "dscale", "dbias"), got, want_grads):
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-4, atol=2e-5, err_msg=name)


def test_batch_norm_batch_statistics_match_flax():
    """Flax's fast variance E[x^2] - E[x]^2 over all axes but the last,
    clamped at 0 (a constant feature rounds below 0 without the clamp),
    the biased variance, and the 0.99 running update."""
    from flax import linen as nn

    from pointcloudprocessing_tpu_torch.models.layers import BatchNorm

    rng = np.random.default_rng(5)
    x = (rng.normal(size=(3, 50, 6)) * 2 + 1).astype(np.float32)
    x[..., 0] = 0.1  # constant feature: variance 0 (or a rounded negative)
    x[..., 1] *= 1e-3
    bn = nn.BatchNorm(use_running_average=False, momentum=0.99,
                      epsilon=KERAS_BN_EPSILON)
    variables = bn.init(jax.random.key(0), jnp.asarray(x))
    params = {"scale": rng.uniform(0.5, 1.5, 6).astype(np.float32),
              "bias": rng.normal(size=6).astype(np.float32)}
    stats = {"mean": rng.normal(size=6).astype(np.float32),
             "var": rng.uniform(0.5, 2, 6).astype(np.float32)}
    want, upd = bn.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                         mutable=["batch_stats"])
    port = BatchNorm(6)
    port.load_state_dict({"weight": t(params["scale"]), "bias": t(params["bias"]),
                          "running_mean": t(stats["mean"]),
                          "running_var": t(stats["var"])})
    got = port(torch.from_numpy(x), use_running=False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(
            getattr(port, ours).numpy(), np.asarray(upd["batch_stats"][theirs]),
            rtol=1e-6, atol=1e-7, err_msg=ours)
    assert torch.isfinite(got).all()


def test_pooled_block_updates_running_statistics_like_flax():
    """PooledPointwiseBlock in train mode: Gram-matrix statistics and the
    0.99 running update, against the JAX block (jnp path); frozen, it keeps
    its statistics."""
    from pointcloudprocessing_tpu.models.layers import PooledPointwiseBlock as JaxBlock
    from pointcloudprocessing_tpu_torch.convert import state_dict_from_flax
    from pointcloudprocessing_tpu_torch.models.layers import PooledPointwiseBlock

    rng = np.random.default_rng(9)
    x = np.abs(rng.normal(size=(3, 40, 16))).astype(np.float32)
    jblock = JaxBlock(32)
    variables = jax.tree_util.tree_map(
        np.asarray, dict(jblock.init(jax.random.key(2), jnp.asarray(x), train=False)))
    variables["batch_stats"]["bn"]["mean"] = rng.normal(size=32).astype(np.float32)
    want, upd = jblock.apply(variables, jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
    block = PooledPointwiseBlock(16, 32)
    block.load_state_dict(state_dict_from_flax(variables))
    got = block(torch.from_numpy(x), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-6)
    for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(
            getattr(block.bn, ours).numpy(),
            np.asarray(upd["batch_stats"]["bn"][theirs]), rtol=1e-5, atol=1e-7,
            err_msg=ours)
    before = {k: v.clone() for k, v in block.state_dict().items()}
    block(torch.from_numpy(x), train=True, frozen=True)
    for k, v in block.state_dict().items():
        assert torch.equal(v, before[k]), k
