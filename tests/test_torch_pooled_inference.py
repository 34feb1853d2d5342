"""The pooled chain's inference route (``models/fused_pool.py``): with
running statistics and no gradient to keep, an f32 chain on a CUDA tensor
takes the forward kernel with the BatchNorm folded into its affine; the CPU,
bf16, a chain that keeps a gradient and batch statistics keep their paths.

On the CPU the route is forced on (``_inference_kernel``) and the kernel
replaced by a recorder around its plain version, against the plain chain
(``_running_forward`` and ``amax``). Tests marked ``card`` hold the kernel
itself against the plain chain on a CUDA device and skip without one; run
them there with ``python -m pytest --noconftest tests/test_torch_pooled_inference.py``
(``--noconftest``: the suite's conftest hides CUDA and imports JAX).
"""

import pytest
import torch

from pointcloudprocessing_tpu_torch.core.constants import KERAS_BN_EPSILON
from pointcloudprocessing_tpu_torch.models import PointNet, fused_pool
from pointcloudprocessing_tpu_torch.models.layers import BatchNorm
from pointcloudprocessing_tpu_torch.ops.cuda import build
from pointcloudprocessing_tpu_torch.ops.cuda.pooled_chain import (
    pooled_chain_forward_reference,
)

C_IN, C = 128, 1024  # PointNet's pooled chains


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def chain_args(b, n, device="cpu", seed=0):
    """x (b, n, C_IN) as a relu output, the weight and a BatchNorm's
    parameters and running statistics away from their initial values."""
    g = torch.Generator().manual_seed(seed)
    args = (torch.relu(torch.randn(b, n, C_IN, generator=g)),
            torch.randn(C, C_IN, generator=g) * 0.1,
            torch.rand(C, generator=g) + 0.5,
            torch.randn(C, generator=g) * 0.5,
            torch.randn(C, generator=g) * 0.5,
            torch.rand(C, generator=g) * 4 + 1)
    return tuple(t.to(device) for t in args)


def plain_chain(x, weight, scale, bias, mean, var):
    r, _ = fused_pool._running_forward(x, weight, scale, bias, mean, var,
                                       KERAS_BN_EPSILON, None)
    return r.amax(dim=1).float()


def max_rel_err(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


def randomize_batch_norms(model, seed=1):
    g = torch.Generator().manual_seed(seed)
    for bn in (m for m in model.modules() if isinstance(m, BatchNorm)):
        c = bn.running_mean.numel()
        with torch.no_grad():
            bn.weight.copy_(torch.rand(c, generator=g) + 0.5)
            bn.bias.copy_(torch.randn(c, generator=g) * 0.2)
            bn.running_mean.copy_(torch.randn(c, generator=g) * 0.3)
            bn.running_var.copy_(torch.rand(c, generator=g) * 1.5 + 0.5)
    return model


@pytest.fixture
def forced_route(monkeypatch):
    """The route forced on and the kernel replaced by a recorder around its
    plain version: yields the recorded calls (x, weight, a, c_row)."""
    calls = []

    def recorder(x, weight, a, c_row):
        calls.append((x, weight, a, c_row))
        return pooled_chain_forward_reference(x, weight, a, c_row)

    monkeypatch.setattr(fused_pool, "_inference_kernel", lambda *_: True)
    monkeypatch.setattr(fused_pool, "pooled_chain_forward", recorder)
    return calls


@pytest.mark.parametrize("device, x_dtype, dtype, takes", [
    ("cuda", torch.float32, None, True),
    ("cuda:1", torch.float32, None, True),
    ("cpu", torch.float32, None, False),
    ("cuda", torch.float32, torch.bfloat16, False),
    ("cuda", torch.bfloat16, None, False),
    ("cuda", torch.float64, None, False),
], ids=["cuda-f32", "cuda1-f32", "cpu", "bf16-compute", "bf16-x", "f64-x"])
def test_inference_kernel_condition(device, x_dtype, dtype, takes):
    assert fused_pool._inference_kernel(torch.device(device), x_dtype, dtype) is takes


@pytest.mark.parametrize("case", ["grad", "batch"])
def test_other_chains_keep_their_path_with_the_route_forced(forced_route, case):
    """With the route forced on, a chain that keeps a gradient and a batch-
    statistics chain compute as before: no inference kernel call, and the
    same outputs as with the route off (the CPU and bf16 are the
    condition's, above)."""
    x, weight, scale, bias, mean, var = chain_args(2, 64)
    use_running = case != "batch"

    def run():
        leaves = [t.clone().requires_grad_(case == "grad")
                  for t in (x, weight, scale, bias)]
        return fused_pool.dense_bn_relu_max(*leaves, mean, var, KERAS_BN_EPSILON,
                                            use_running)

    with torch.no_grad() if case != "grad" else torch.enable_grad():
        got = run()
    # the batch-statistics chain calls the kernel through its own route
    assert len(forced_route) == (1 if case == "batch" else 0)
    if case == "batch":
        assert not torch.equal(got[1], mean) and not torch.equal(got[2], var)
    else:
        assert got[1] is mean and got[2] is var
    forced_route.clear()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fused_pool, "_inference_kernel", lambda *_: False)
        with torch.no_grad() if case != "grad" else torch.enable_grad():
            want = run()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_folded_affine_route_at_pointnet_width(forced_route):
    """The route on PointNet's chain shape (128 -> 1024): one kernel call
    with the folded affine, its pooled values within f32 rounding of the
    plain chain's, in grad mode too when nothing needs a gradient."""
    x, weight, scale, bias, mean, var = chain_args(3, 96)
    with torch.no_grad():
        got, got_mean, got_var = fused_pool.dense_bn_relu_max(
            x, weight, scale, bias, mean, var, KERAS_BN_EPSILON)
    got_grad_mode, _, _ = fused_pool.dense_bn_relu_max(
        x, weight, scale, bias, mean, var, KERAS_BN_EPSILON)
    want = plain_chain(x, weight, scale, bias, mean, var)
    assert len(forced_route) == 2
    cx, cw, a, c_row = forced_route[0]
    assert cx is x and cw is weight
    a_want = scale / torch.sqrt(var + KERAS_BN_EPSILON)
    torch.testing.assert_close(a, a_want, rtol=5e-7, atol=0)
    torch.testing.assert_close(c_row, bias - mean * a_want, rtol=5e-7, atol=5e-7)
    assert a.dtype == c_row.dtype == torch.float32
    assert a.is_contiguous() and c_row.is_contiguous()
    assert got.shape == (3, C) and got.dtype == torch.float32
    assert got_mean is mean and got_var is var
    assert max_rel_err(got, want) < 1e-6
    assert torch.equal(got, got_grad_mode)
    assert ((got == 0) == (want == 0)).all()


def test_folded_affine_route_keeps_nan_and_ties(forced_route):
    """A NaN point pools to NaN in its cloud, a NaN running variance in its
    channel, and repeated rows tie: as ``amax`` gives them."""
    x, weight, scale, bias, mean, var = chain_args(2, 64, seed=3)
    x[0, 17, 5] = float("nan")
    x[1, 40:] = x[1, :24]
    var[[2, 900]] = float("nan")
    with torch.no_grad():
        got, _, _ = fused_pool.dense_bn_relu_max(x, weight, scale, bias, mean, var,
                                                 KERAS_BN_EPSILON)
    want = plain_chain(x, weight, scale, bias, mean, var)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.isnan(got[0]).all() and torch.isnan(got[1, [2, 900]]).all()
    finite = ~torch.isnan(want)
    assert max_rel_err(got[finite], want[finite]) < 1e-6


def test_pointnet_eval_takes_the_route_three_times(forced_route):
    """A PointNet eval forward calls the kernel once a pooled chain (input
    T-Net, feature T-Net, ``mlp_2_3``), each 128 -> 1024 with its block's
    folded affine, and its heads stay within f32 rounding of the plain
    forward's."""
    torch.manual_seed(0)
    model = randomize_batch_norms(
        PointNet(23, 12, generator=torch.Generator().manual_seed(0)).eval())
    points = torch.randn(2, 64, 3)
    with torch.no_grad():
        got = model(points)
    assert len(forced_route) == 3
    blocks = (model.input_transform.conv_layer_3, model.feature_transform.conv_layer_3,
              model.mlp_2_3)
    for (x, weight, a, c_row), block in zip(forced_route, blocks):
        bn = block.bn
        assert x.shape == (2, 64, C_IN) and weight is block.conv.weight
        a_want = bn.weight * torch.rsqrt(bn.running_var + KERAS_BN_EPSILON)
        torch.testing.assert_close(a, a_want, rtol=5e-7, atol=0)
        torch.testing.assert_close(c_row, bn.bias - bn.running_mean * a_want,
                                   rtol=5e-7, atol=5e-7)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fused_pool, "_inference_kernel", lambda *_: False)
        with torch.no_grad():
            want = model(points)
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------- on the card

@pytest.mark.card
def test_card_chain_matches_the_plain_chain_at_serving_shape(card):
    """256 x 1,024 x 128 -> 1,024 on the card: the kernel route's pooled
    values within 1e-6 (relative to the largest) of the plain chain's, one
    f32 launch; NaN points and NaN channels and tied rows as ``amax``."""
    x, weight, scale, bias, mean, var = chain_args(256, 1024, card, seed=5)
    x[3, 100, 7] = float("nan")
    x[9, 512:] = x[9, :512]
    var[[10, 600]] = float("nan")
    launched = build.LAUNCHES["pooled_chain_forward"]
    with torch.no_grad():
        got, _, _ = fused_pool.dense_bn_relu_max(x, weight, scale, bias, mean, var,
                                                 KERAS_BN_EPSILON)
        want = plain_chain(x, weight, scale, bias, mean, var)
    torch.cuda.synchronize()
    assert build.LAUNCHES["pooled_chain_forward"] - launched == 1
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.isnan(got[3]).all() and torch.isnan(got[:, [10, 600]]).all()
    finite = ~torch.isnan(want)
    assert max_rel_err(got[finite], want[finite]) <= 1e-6


@pytest.mark.card
def test_card_pointnet_eval_launches_once_a_chain(card):
    """An f32 PointNet eval forward launches the f32 forward kernel three
    times; a bf16 one launches no f32 form; a frozen chain under a trained
    parameter keeps its winner bookkeeping and launches no forward."""
    points = torch.randn(4, 1024, 3, device=card)

    def launched():
        torch.cuda.synchronize()
        return (build.LAUNCHES["pooled_chain_forward"],
                build.LAUNCHES["pooled_chain_forward_bf16"])

    build.reset()

    model = PointNet(23, 12, generator=torch.Generator().manual_seed(0), device=card)
    with torch.no_grad():
        f32_out = model.eval()(points)
    assert launched() == (3, 0)
    assert all(bool(torch.isfinite(v).all()) for v in f32_out.values())

    build.reset()
    bf16 = PointNet(23, 12, generator=torch.Generator().manual_seed(0), device=card,
                    dtype=torch.bfloat16)
    with torch.no_grad():
        bf16.eval()(points)
    assert launched() == (0, 0)

    build.reset()
    x, weight, scale, bias, mean, var = chain_args(4, 1024, card)
    leaves = [t.requires_grad_() for t in (x, weight, scale, bias)]
    pooled, _, _ = fused_pool.dense_bn_relu_max(*leaves, mean, var, KERAS_BN_EPSILON)
    pooled.sum().backward()
    assert launched() == (0, 0)
    assert build.LAUNCHES["pooled_chain_backward"] == 1
