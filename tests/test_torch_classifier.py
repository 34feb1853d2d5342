"""The legacy classification PointNet and the T-Net regressor against the
JAX package on the CPU, on converted JAX weights.

Weights: the JAX models' init with every BatchNorm statistic, scale and
bias drawn at random and the legacy T-Nets' zero ``w`` replaced by small
random values (so neither T-Net is the identity). Bars: outputs at 1e-4
(the repo's logit-parity bar), in eval mode and in train mode with dropout
0; the orthogonality term at rtol 1e-4; after one train-mode call with a
non-default ``bn_momentum`` every running statistic within 1e-5 + 1e-4 of
its size (the batch variance is ``E[x^2] - E[x]^2`` in f32 on both sides,
reduced in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudprocessing_tpu.models.classifier import (
    PointNetClassifier as JaxClassifier,
    TNetRegressor as JaxRegressor,
)
from pointcloudprocessing_tpu_torch.convert import (
    flax_from_state_dict,
    state_dict_from_flax,
)
from pointcloudprocessing_tpu_torch.models.classifier import (
    PointNetClassifier,
    TNetRegressor,
)

B, N, C = 4, 64, 5
ATOL = 1e-4
SMALL_WIDTHS = (32, 64, 128, 64, 32)


def randomized(variables, seed):
    rng = np.random.default_rng(seed)

    def visit(tree):
        out = {}
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                out[name] = visit(leaf)
                continue
            arr = np.asarray(leaf).copy()
            if name in ("var", "scale"):
                arr = rng.uniform(0.5, 1.5, arr.shape)
            elif name in ("mean", "bias"):
                arr = rng.normal(0.0, 0.1, arr.shape)
            elif name == "w":
                arr = rng.normal(0.0, 0.02, arr.shape)
            out[name] = arr.astype(np.float32)
        return out

    return visit(jax.tree_util.tree_map(np.asarray, {
        "params": variables["params"], "batch_stats": variables["batch_stats"]}))


def clouds(seed=0):
    rng = np.random.default_rng(seed)
    scales = np.array([[3.0, 0.3, 0.3], [2.0, 2.0, 0.2], [1.0, 1.0, 1.0],
                       [0.5, 3.0, 1.5]], np.float32)
    return (rng.normal(size=(B, N, 3)) * scales[:, None, :]).astype(np.float32)


def leaves(tree, prefix=()):
    for name, value in tree.items():
        if isinstance(value, dict):
            yield from leaves(value, prefix + (name,))
        else:
            yield "/".join(prefix + (name,)), np.asarray(value)


MODELS = {
    "classifier": (lambda m: JaxClassifier(num_classes=C, dropout_rate=0.0, bn_momentum=m),
                   lambda m: PointNetClassifier(C, dropout_rate=0.0, bn_momentum=m,
                                                device="cpu")),
    "regressor": (lambda m: JaxRegressor(add_regularization=True, bn_momentum=m),
                  lambda m: TNetRegressor(True, bn_momentum=m, device="cpu")),
    "regressor_small": (
        lambda m: JaxRegressor(bn_momentum=m, tnet_layer_widths=SMALL_WIDTHS),
        lambda m: TNetRegressor(bn_momentum=m, tnet_layer_widths=SMALL_WIDTHS,
                                device="cpu")),
}


def pair(name, momentum=0.99, seed=0):
    jax_fn, torch_fn = MODELS[name]
    jmodel = jax_fn(momentum)
    init = jmodel.init(jax.random.key(seed), jnp.zeros((1, N, 3)), train=False)
    variables = randomized(init, seed)
    model = torch_fn(momentum)
    model.load_state_dict(state_dict_from_flax(variables))
    return jmodel, variables, model


@pytest.mark.parametrize("name", list(MODELS))
def test_converter_round_trip(name):
    """Every legacy leaf maps to a port parameter and back, bit for bit."""
    _, variables, model = pair(name)
    back = flax_from_state_dict(model.state_dict())
    want, got = dict(leaves(variables)), dict(leaves(back))
    assert sorted(want) == sorted(got)
    assert all(np.array_equal(want[k], got[k]) for k in want)


@pytest.mark.parametrize("name", list(MODELS))
def test_eval_forward_matches_jax(name):
    jmodel, variables, model = pair(name)
    x = clouds()
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    got = model.eval()(torch.from_numpy(x), train=False).detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    if name == "classifier":
        np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)  # softmax


@pytest.mark.parametrize("name", ["classifier", "regressor"])
@pytest.mark.parametrize("momentum", [0.99, 0.9])
def test_train_forward_reg_and_running_stats(name, momentum):
    jmodel, variables, model = pair(name, momentum, seed=1)
    x = clouds(1)
    want, updates = jmodel.apply(variables, jnp.asarray(x), train=True,
                                 mutable=["batch_stats", "reg_losses"])
    got, reg = model.train().forward_with_reg(torch.from_numpy(x), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    want_reg = sum(float(np.sum(v)) for _, v in leaves(updates["reg_losses"]))
    assert want_reg > 0
    np.testing.assert_allclose(float(reg), want_reg, rtol=1e-4)
    got_stats = dict(leaves(flax_from_state_dict(model.state_dict())["batch_stats"]))
    want_stats = dict(leaves(updates["batch_stats"]))
    before = dict(leaves(variables["batch_stats"]))
    assert sorted(got_stats) == sorted(want_stats)
    for k, w in want_stats.items():
        np.testing.assert_allclose(got_stats[k], w, rtol=1e-4, atol=1e-5, err_msg=k)
        # the momentum took effect: new = m * old + (1 - m) * batch
        assert not np.allclose(w, before[k])
        if momentum != 0.99:
            moved = np.abs(got_stats[k] - before[k]).max()
            assert moved > 1e-3, k


def test_default_momentum_changes_no_existing_block():
    """``bn_momentum`` left at its default is Keras's 0.99 in every block of
    the current PointNet, whose parity tests stand unchanged."""
    from pointcloudprocessing_tpu_torch.core.constants import KERAS_BN_MOMENTUM
    from pointcloudprocessing_tpu_torch.models.layers import BatchNorm
    from pointcloudprocessing_tpu_torch.models.pointnet import PointNet

    model = PointNet(5, 3)
    momenta = {m.momentum for m in model.modules() if isinstance(m, BatchNorm)}
    assert momenta == {KERAS_BN_MOMENTUM}


def test_constructors_default_to_cuda():
    assert not torch.cuda.is_available()
    for cls in (PointNetClassifier, TNetRegressor):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls()
