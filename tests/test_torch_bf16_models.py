"""The port's models in bf16 compute against the JAX package's
``dtype=jnp.bfloat16`` models, on converted weights: PointNet 23/12 (eval
and train), DGCNN and PointNet++ at the JAX tests' TINY widths
(``tests/test_dgcnn.py:22``, ``tests/test_pointnet2.py:26``), both graph
modes and edge forms. In train mode the JAX pooled chains take their Pallas
kernels in interpret mode (``fused_pool._FORCE_PALLAS``), the branch the
port's bf16 chain follows. Also: a bf16 model loads the converter's f32
weights, and the ``entry()`` twin against ``__graft_entry__.entry()``.

Bar: the port's bf16 heads lie within 2x the JAX bf16 model's own distance
from its f32 model (the rounding bf16 itself brings), plus 1e-4, the repo's
f32 parity bar; the heads come out in the dtype JAX returns (f32). And the
port rounds at all: its bf16 heads lie at least a quarter of that distance
from its own f32 model's on the same weights, so a port that computed in
f32 whatever its ``dtype`` would fail.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudprocessing_tpu.models import fused_pool as jax_fused_pool
from pointcloudprocessing_tpu.models import pointnet2 as jax_pn2
from pointcloudprocessing_tpu.models.dgcnn import DGCNN as JaxDGCNN
from pointcloudprocessing_tpu.models.pointnet import PointNet as JaxPointNet
from pointcloudprocessing_tpu_torch.convert import (
    flax_from_state_dict,
    state_dict_from_flax,
)
from pointcloudprocessing_tpu_torch.models.dgcnn import DGCNN
from pointcloudprocessing_tpu_torch.models.pointnet import PointNet
from pointcloudprocessing_tpu_torch.models.pointnet2 import PointNet2
from test_torch_pointnet import jax_variables, randomize

BF16 = torch.bfloat16
FLOOR = 1e-4  # the repo's f32 parity bar
HEADS = ("classification_output", "segmentation_output", "se3")
DGCNN_TINY = dict(k=8, edge_widths=(8, 16), emb_width=32)
PN2_TINY = dict(sa1=(16, 8, 0.5, (8, 16)), sa2=(8, 8, 0.9, (16, 32)),
                sa3_mlp=(32, 64))


def _cloud(b, n, seed):
    return (np.random.default_rng(seed).normal(size=(b, n, 3)) * 4).astype(np.float32)


def _apply(jmodel, variables, pts, train):
    if train:
        fn = jax.jit(lambda v, x: jmodel.apply(v, x, train=True,
                                               mutable=["batch_stats"])[0])
    else:
        fn = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))
    return fn(variables, jnp.asarray(pts))


def _check(jax_f32, jax_bf16, model, model32, variables, pts, train):
    """The port's bf16 heads against both JAX models and against the port's
    f32 twin ``model32``; each model's state is restored afterwards (train
    mode updates the running statistics)."""
    jf = _apply(jax_f32, variables, pts, train)
    jb = _apply(jax_bf16, variables, pts, train)
    outs = []
    for m in (model, model32):
        with torch.no_grad():
            outs.append(m.train(train)(torch.from_numpy(pts), train=train))
        m.load_state_dict(state_dict_from_flax(variables))
    out, out32 = outs
    for head in HEADS:
        got, want, ref = out[head], np.asarray(jb[head]), np.asarray(jf[head])
        assert got.dtype == torch.float32 and want.dtype == np.float32, head
        own = np.abs(want - ref).max()
        dist = np.abs(got.numpy() - want).max()
        assert dist <= 2 * own + FLOOR, (head, dist, own)
        rounded = (got - out32[head]).abs().max().item()
        assert rounded >= 0.25 * own, (head, rounded, own)


@pytest.fixture(scope="module", params=[False, True], ids=["full", "vanilla"])
def pointnet(request):
    vanilla = request.param
    kw = dict(num_classes=23, num_parts=12, vanilla=vanilla, dropout_rate=0.0)
    jf, jb = JaxPointNet(**kw), JaxPointNet(**kw, dtype=jnp.bfloat16)
    variables = jax_variables(jf, 64, seed=3)
    models = [PointNet(23, 12, vanilla=vanilla, dropout_rate=0.0, dtype=dtype)
              for dtype in (BF16, None)]
    for m in models:
        m.load_state_dict(state_dict_from_flax(variables))
    return jf, jb, *models, variables


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_pointnet_bf16_matches_jax(pointnet, train, monkeypatch):
    monkeypatch.setattr(jax_fused_pool, "_FORCE_PALLAS", train)
    _check(*pointnet, _cloud(4, 64, 11), train)


@pytest.fixture(scope="module", params=[
    ("dynamic", "reference"), ("dynamic", "factored"), ("static", "reference"),
    ("static", "factored"),
], ids=lambda p: "-".join(p))
def dgcnn(request):
    graph, impl = request.param
    kw = dict(num_classes=5, num_parts=4, graph=graph, dropout_rate=0.0,
              edge_impl=impl, **DGCNN_TINY)
    jf = JaxDGCNN(exact_knn=True, **kw)
    jb = JaxDGCNN(exact_knn=True, dtype=jnp.bfloat16, **kw)
    init = jf.init(jax.random.key(0), jnp.asarray(_cloud(1, 32, 0)), train=False)
    variables = randomize({"params": init["params"],
                           "batch_stats": init["batch_stats"]}, 0)
    models = [DGCNN(5, 4, graph=graph, dropout_rate=0.0, edge_impl=impl,
                    dtype=dtype, **DGCNN_TINY) for dtype in (BF16, None)]
    for m in models:
        m.load_state_dict(state_dict_from_flax(variables))
    return jf, jb, *models, variables


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_dgcnn_bf16_matches_jax(dgcnn, train):
    _check(*dgcnn, _cloud(2, 64, 1), train)


@pytest.fixture(scope="module")
def pointnet2():
    kw = dict(num_classes=5, num_parts=4, dropout_rate=0.0, **PN2_TINY)
    jf = jax_pn2.PointNet2(exact_knn=True, **kw)
    jb = jax_pn2.PointNet2(exact_knn=True, dtype=jnp.bfloat16, **kw)
    init = jax.jit(lambda r, x: jf.init(r, x, train=False))(
        jax.random.key(0), jnp.asarray(_cloud(1, 64, 0)))
    variables = randomize({"params": init["params"],
                           "batch_stats": init["batch_stats"]}, 0)
    models = [PointNet2(5, 4, dropout_rate=0.0, device="cpu", dtype=dtype,
                        **PN2_TINY) for dtype in (BF16, None)]
    for m in models:
        m.load_state_dict(state_dict_from_flax(variables))
    return jf, jb, *models, variables


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_pointnet2_bf16_matches_jax(pointnet2, train):
    _check(*pointnet2, _cloud(2, 64, 2), train)


def test_bf16_model_loads_the_converted_f32_weights(pointnet):
    """No bf16 tree: parameters and statistics stay f32 in a bf16 model, so
    the converter's f32 state_dict loads as it is and converts back bit for
    bit."""
    _, _, model, _, variables = pointnet
    sd = model.state_dict()
    assert all(t.dtype == torch.float32 for t in sd.values())
    back = flax_from_state_dict({k: v.clone() for k, v in sd.items()})
    for tree in ("params", "batch_stats"):
        want = dict(jax.tree_util.tree_flatten_with_path(variables[tree])[0])
        got = dict(jax.tree_util.tree_flatten_with_path(back[tree])[0])
        assert want.keys() == got.keys()
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])


def test_entry_twin_matches_graft_entry():
    """``graft_entry.entry()`` on the CPU: the 23/12 PointNet on 8 x 1,024
    zeros, heads and shapes as ``__graft_entry__.entry()`` gives them on the
    same (converted) weights, and on a random batch too, at 1e-4 (f32)."""
    import __graft_entry__

    from pointcloudprocessing_tpu_torch import graft_entry

    jfn, (jvars, jpts) = __graft_entry__.entry()
    fn, (state, pts) = graft_entry.entry("cpu")
    assert tuple(pts.shape) == tuple(jpts.shape) == (8, 1024, 3)
    own = fn(state, pts)
    assert {k: tuple(v.shape) for k, v in own.items()} == {
        "classification_output": (8, 23), "segmentation_output": (8, 1024, 12),
        "se3": (8, 3, 3)}
    converted = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, dict(jvars)))
    rand = _cloud(8, 1024, 5)
    for jp, tp in ((jpts, pts), (jnp.asarray(rand), torch.from_numpy(rand))):
        want = jax.jit(jfn)(jvars, jp)
        got = fn(converted, tp)
        for head in HEADS:
            np.testing.assert_allclose(got[head].numpy(), np.asarray(want[head]),
                                       rtol=0.0, atol=1e-4, err_msg=head)
