"""PyTorch port of the multi-head PointNet against the JAX package.

Both models run on the CPU from the same Flax variables (converted with
``pointcloudprocessing_tpu_torch.convert``) and the same numpy inputs. The
bar is the repo's parity invariant: every head within 1e-4 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudprocessing_tpu.models.pointnet import PointNet as JaxPointNet
from pointcloudprocessing_tpu_torch.convert import state_dict_from_flax
from pointcloudprocessing_tpu_torch.models.pointnet import PointNet

B, N, C, P = 2, 64, 23, 12
ATOL = 1e-4  # the repo's logit-parity bar between implementations


def randomize(variables, seed):
    """Numpy copy of a Flax tree with every BN statistic, scale and bias
    drawn at random, so the BatchNorm and bias paths carry real values."""
    rng = np.random.default_rng(seed)

    def visit(tree, path=()):
        out = {}
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                out[name] = visit(leaf, path + (name,))
                continue
            arr = np.asarray(leaf).copy()
            if name == "var":
                arr = rng.uniform(0.5, 1.5, arr.shape).astype(np.float32)
            elif name == "scale":
                arr = rng.uniform(0.5, 1.5, arr.shape).astype(np.float32)
            elif name in ("mean", "bias"):
                arr = rng.normal(0.0, 0.1, arr.shape).astype(np.float32)
            out[name] = arr
        return out

    return visit(jax.tree_util.tree_map(np.asarray, dict(variables)))


def jax_variables(model, width, seed=0):
    variables = model.init(
        jax.random.key(seed), jnp.zeros((1, width, 3), jnp.float32), train=False
    )
    return randomize(
        {"params": variables["params"], "batch_stats": variables["batch_stats"]},
        seed,
    )


def torch_model(variables, num_classes, num_parts, vanilla):
    model = PointNet(num_classes, num_parts, vanilla=vanilla)
    model.load_state_dict(state_dict_from_flax(variables))
    return model.eval()


@pytest.fixture(scope="module", params=[False, True], ids=["full", "vanilla"])
def pair(request):
    vanilla = request.param
    jmodel = JaxPointNet(num_classes=C, num_parts=P, vanilla=vanilla)
    variables = jax_variables(jmodel, N, seed=3)
    return jmodel, variables, torch_model(variables, C, P, vanilla)


HEAD_SETS = [
    ("classification_output", "segmentation_output", "se3"),
    ("classification_output",),
    ("segmentation_output", "se3"),
]


@pytest.mark.parametrize("heads", HEAD_SETS, ids=["all", "cls", "seg+se3"])
def test_heads_match_jax(pair, heads):
    jmodel, variables, tmodel = pair
    pts = (np.random.default_rng(11).normal(size=(B, N, 3)) * 4).astype(np.float32)
    want = jmodel.apply(variables, jnp.asarray(pts), train=False, heads=heads)
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(pts), heads=heads)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(
            got[key].numpy(), np.asarray(want[key]), rtol=0, atol=ATOL,
            err_msg=key,
        )


@pytest.mark.parametrize("legacy", [False, True], ids=["current", "legacy"])
def test_tnet_matches_jax(legacy):
    """Current T-Net (BN+relu convs, pooled chain) and the legacy one
    (plain convs, explicit max), with a random ``w``."""
    from pointcloudprocessing_tpu.models.tnet import TNet as JaxTNet
    from pointcloudprocessing_tpu_torch.models.tnet import TNet

    opts = dict(conv_apply_bn=False, conv_activation=None, w_init_zeros=True) \
        if legacy else {}
    x = np.random.default_rng(5).normal(size=(B, N, 3)).astype(np.float32)
    jtnet = JaxTNet(k=3, **opts)
    init = jtnet.init(jax.random.key(1), jnp.asarray(x), train=False)
    variables = randomize(dict(init), 2)
    variables["params"]["w"] = (
        np.random.default_rng(4).normal(0, 0.05, variables["params"]["w"].shape)
        .astype(np.float32)
    )
    want = np.asarray(jtnet.apply(variables, jnp.asarray(x), train=False))
    tnet = TNet(3, **opts)
    tnet.load_state_dict(state_dict_from_flax(variables))
    with torch.inference_mode():
        got = tnet(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_training_mode_raises():
    """Train mode with dropout needs an explicit generator for its masks
    and raises without one; with one it runs and updates the running
    statistics, except in a frozen block, which keeps them (Keras
    trainable=False), as in the JAX package."""
    model = PointNet(4, 3, vanilla=True)
    pts = torch.randn((2, 8, 3), generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="Generator"):
        model(pts, train=True)
    before = model.mlp_1_1.bn.running_mean.clone()
    out = model.mlp_1_1(pts, train=True, frozen=True)
    assert out.shape == (2, 8, 64)
    assert torch.equal(model.mlp_1_1.bn.running_mean, before)
    out = model(pts, train=True, generator=torch.Generator().manual_seed(1))
    assert out["classification_output"].shape == (2, 4)
    assert not torch.equal(model.mlp_1_1.bn.running_mean, before)


def test_layer_trainability_matches_jax():
    from pointcloudprocessing_tpu.models import pointnet as jax_pointnet
    from pointcloudprocessing_tpu_torch.models import pointnet as port

    for vanilla in (False, True):
        for flags in ((False,) * 4, (True, False, True, False)):
            want = jax_pointnet.layer_trainability(
                jax_pointnet.FreezeFlags(*flags), vanilla)
            got = port.layer_trainability(port.FreezeFlags(*flags), vanilla)
            assert list(got.items()) == list(want.items())


def test_seeded_init_is_reproducible():
    a = PointNet(C, P, generator=torch.Generator().manual_seed(7))
    b = PointNet(C, P, generator=torch.Generator().manual_seed(7))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
