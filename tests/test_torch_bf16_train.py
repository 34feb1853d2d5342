"""bf16 training in the port against the JAX package: Adam with bf16 moments
(``scale_by_adam_moments``), a bf16 PointNet train step, the factory's dtype
names, and the staged trainer with a config's ``compute_dtype`` and
``optimizer_moment_dtype`` set to bfloat16.

Bars, each with its reason:
- Adam: both keep the math in f32 and round only the stored moments, so
  the moments agree within one bf16 ulp (a rounding tie apart) and the
  updates within ``tests/test_train_steps.py``'s rtol of 0.05.
- the train step: the first loss within 2x the JAX bf16 step's own
  distance from its f32 step, plus 1e-4, and at least a quarter of that
  distance from the port's own f32 step (so a step that stayed in f32
  fails); the loss lowers over 8 steps in both, as
  ``tests/test_train_steps.py::
  test_train_step_with_bf16_moments_decreases_loss`` checks.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pointcloudprocessing_tpu.core.config import LearningConfig
from pointcloudprocessing_tpu.models import factory as jax_factory
from pointcloudprocessing_tpu.models import fused_pool as jax_fused_pool
from pointcloudprocessing_tpu.models.pointnet import FreezeFlags as JaxFreeze
from pointcloudprocessing_tpu.models.pointnet import PointNet as JaxPointNet
from pointcloudprocessing_tpu.train import steps as jax_steps
from pointcloudprocessing_tpu_torch.convert import state_dict_from_flax
from pointcloudprocessing_tpu_torch.models import factory
from pointcloudprocessing_tpu_torch.models.pointnet import FreezeFlags, PointNet
from pointcloudprocessing_tpu_torch.train import callbacks, steps
from pointcloudprocessing_tpu_torch.train.profile import TrainProfile
from test_torch_train_profile import make_config, one_torch_thread  # noqa: F401

BF16 = torch.bfloat16


def _adam_state(jstate) -> optax.ScaleByAdamState:
    found = [s for s in jax.tree_util.tree_leaves(
        jstate, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(found) == 1
    return found[0]


def _unmasked(tree):
    """A nested dict of the moments without optax's MaskedNode placeholders
    (the frozen subtree), as f32 numpy arrays."""
    if isinstance(tree, dict):
        kept = {k: _unmasked(v) for k, v in tree.items()
                if not isinstance(v, optax.MaskedNode)}
        return {k: v for k, v in kept.items() if not isinstance(v, dict) or v}
    return np.asarray(tree.astype(jnp.float32))


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |v| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(v), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


def test_adam_bf16_moments_match_scale_by_adam_moments():
    """Ten steps on the same gradients, one subtree frozen: the stored
    moments are bf16 in both and agree within a bf16 ulp; each step's
    update agrees at rtol 0.05."""
    rng = np.random.default_rng(1)
    params = {
        "mlp_1_1": {"conv": {"kernel": rng.normal(size=(3, 8)).astype(np.float32)}},
        "mlp_seg_1": {"conv": {"kernel": rng.normal(size=(8, 5)).astype(np.float32)},
                      "bn": {"scale": rng.uniform(0.5, 1.5, 5).astype(np.float32)}},
        "mlp_cls_1": {"dense": {"kernel": rng.normal(size=(8, 4)).astype(np.float32)}},
    }
    learning = LearningConfig(rate=1e-2, decay_steps=3, decay_rate=0.5)
    jopt = jax_steps.make_optimizer(learning, params, JaxFreeze(classification_head=True),
                                    moment_dtype=jnp.bfloat16)
    jstate, jparams = jopt.init(params), params
    port = {n: t.clone() for n, t in state_dict_from_flax({"params": params}).items()}
    opt = steps.make_optimizer(learning, port, FreezeFlags(classification_head=True),
                               moment_dtype=BF16)
    state = opt.init(port)
    assert set(state.mu) == {"mlp_1_1.conv.weight", "mlp_seg_1.conv.weight",
                             "mlp_seg_1.bn.weight"}
    for _ in range(10):
        grads = jax.tree_util.tree_map(
            lambda p: (rng.normal(size=p.shape) * 1e-2).astype(np.float32), params)
        updates, jstate = jopt.update(grads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        before = {n: p.clone() for n, p in port.items()}
        for name, g in state_dict_from_flax({"params": grads}).items():
            port[name].grad = g
        opt.update_(port, state)
        jupd = state_dict_from_flax({"params": jax.device_get(updates)})
        for name in state.mu:
            np.testing.assert_allclose((port[name] - before[name]).numpy(),
                                       jupd[name].numpy(), rtol=0.05, atol=1e-9,
                                       err_msg=name)
    adam = _adam_state(jstate)
    for which, mine in (("mu", state.mu), ("nu", state.nu)):
        theirs = state_dict_from_flax({"params": _unmasked(getattr(adam, which))})
        assert theirs.keys() == mine.keys()
        for name, t in mine.items():
            assert t.dtype == BF16, (which, name)
            want = theirs[name].numpy()
            assert np.all(np.abs(t.float().numpy() - want) <= _bf16_ulp(want)), (
                which, name)


@pytest.mark.parametrize("value,want", [
    ("", None), ("float32", None), ("f32", None), ("bfloat16", BF16), ("bf16", BF16),
])
def test_factory_dtype_names_match_jax(value, want):
    cfg = SimpleNamespace(compute_dtype=value, optimizer_moment_dtype=value)
    assert factory.compute_dtype_of(cfg) is want
    assert factory.moment_dtype_of(cfg) is want
    jax_want = None if want is None else jnp.bfloat16
    assert jax_factory._compute_dtype(cfg) == jax_want
    assert jax_factory._moment_dtype(cfg) == jax_want


def test_factory_unknown_dtype_raises_like_jax():
    for key, port_fn, jax_fn in (
            ("compute_dtype", factory.compute_dtype_of, jax_factory._compute_dtype),
            ("optimizer_moment_dtype", factory.moment_dtype_of,
             jax_factory._moment_dtype)):
        cfg = SimpleNamespace(compute_dtype="", optimizer_moment_dtype="")
        setattr(cfg, key, "float16")
        with pytest.raises(ValueError, match=key):
            port_fn(cfg)
        with pytest.raises(ValueError, match=key):
            jax_fn(cfg)


def _step_batch():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 64, 3)).astype(np.float32)
    targets = {
        "classification_output": rng.integers(0, 3, 4).astype(np.int32),
        "segmentation_output": rng.integers(0, 2, (4, 64)).astype(np.int32),
        "se3": np.tile(np.eye(3, dtype=np.float32), (4, 1, 1)),
    }
    return x, targets


def test_bf16_pointnet_train_step_matches_jax(monkeypatch):
    """PointNet 3/2 in bf16 with bf16 moments, b 4 x 64 points, 8 steps:
    the first loss against JAX's bf16 step (its pooled chains on their
    Pallas kernels), and the loss lowers in both."""
    learning, weights = LearningConfig(rate=1e-3), (1.0, 1.0, 0.1)
    x, targets = _step_batch()
    jtargets = jax.tree_util.tree_map(jnp.asarray, targets)
    init = JaxPointNet(num_classes=3, num_parts=2).init(
        jax.random.key(0), jnp.zeros((1, 64, 3)), train=False)
    variables = jax.device_get({"params": init["params"],
                                "batch_stats": init["batch_stats"]})

    def jax_losses(dtype, steps_n):
        # bf16: the pooled chains' Pallas branch, which the port follows;
        # f32: the plain chain, the reference
        monkeypatch.setattr(jax_fused_pool, "_FORCE_PALLAS", dtype is not None)
        model = JaxPointNet(num_classes=3, num_parts=2, dropout_rate=0.0, dtype=dtype)
        state, optimizer = jax_steps.init_train_state(
            model, None, 64, learning, JaxFreeze(),
            init_variables=jax.tree_util.tree_map(jnp.array, variables),
            moment_dtype=dtype)
        step = jax_steps.make_train_step(model, optimizer, weights, JaxFreeze(),
                                         (0.0, 0.0, 0.0))
        out = []
        for i in range(steps_n):
            state, logs = step(state, jnp.asarray(x), jtargets, jax.random.key(i))
            out.append(float(logs["loss"]))
        return out

    jb, jf = jax_losses(jnp.bfloat16, 8), jax_losses(None, 1)
    tt = {k: torch.from_numpy(v) for k, v in targets.items()}

    def port_losses(dtype, steps_n):
        model = PointNet(3, 2, dropout_rate=0.0, dtype=dtype)
        model.load_state_dict(state_dict_from_flax(variables))
        state, optimizer = steps.init_train_state(model, learning, FreezeFlags(),
                                                  moment_dtype=dtype)
        step = steps.make_train_step(model, optimizer, weights, FreezeFlags(),
                                     (0.0, 0.0, 0.0))
        out = []
        for i in range(steps_n):
            state, logs = step(state, torch.from_numpy(x), tt, i)
            out.append(float(logs["loss"]))
        return out, model, state

    losses, model, state = port_losses(BF16, 8)
    own = abs(jb[0] - jf[0])
    assert np.isfinite(losses).all() and np.isfinite(jb).all()
    assert abs(losses[0] - jb[0]) <= 2 * own + 1e-4, (losses[0], jb[0], jf[0])
    pf = port_losses(None, 1)[0][0]
    assert abs(losses[0] - pf) >= 0.25 * own, (losses[0], pf, own)
    assert losses[-1] < losses[0] and jb[-1] < jb[0]
    assert all(t.dtype == BF16 for t in state.opt_state.mu.values())
    assert all(t.dtype == BF16 for t in state.opt_state.nu.values())
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_trainer_trains_a_bf16_curriculum(tmp_path):
    """``TrainProfile(device="cpu")`` over a two-stage curriculum with both
    dtype keys at bfloat16: the model computes in bf16, Adam stores bf16
    moments, the stages chain, and each ``best/model.pt`` holds f32
    parameters that an f32 model (as serving builds) loads."""
    path = make_config(tmp_path, name="bf16", compute_dtype="bfloat16",
                       optimizer_moment_dtype="bf16")
    tp = TrainProfile(path, log_to_file=False, device="cpu")
    built = []
    build = tp._build_state

    def recording(stage):
        out = build(stage)
        built.append(out)
        return out

    tp._build_state = recording
    histories = tp.train()
    assert set(histories) == {"classification_pretrain", "final"}
    for h in histories.values():
        assert len(h["loss"]) == 2 and np.isfinite(h["loss"]).all()
    assert len(built) == 2
    for model, state, _, _ in built:
        assert model.mlp_1_1.conv.dtype == BF16
        assert state.opt_state.mu and all(
            t.dtype == BF16 for t in (*state.opt_state.mu.values(),
                                      *state.opt_state.nu.values()))
    for stage in histories:
        sd = callbacks.load_checkpoint(str(tmp_path / "models" / "bf16" / stage))
        assert all(t.dtype == torch.float32 for t in sd.values())
        f32 = factory.model_from_config(tp.config, device="cpu")
        f32.load_state_dict(sd)
        assert f32.mlp_1_1.conv.dtype is None
