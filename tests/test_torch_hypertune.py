"""The port's hyperparameter grid against the JAX package on the CPU.

- ``HyperTune`` (a copy) on the same histories: table, overview and LaTeX
  equal.
- ``sgd``, ``adagrad`` and ``adam`` against optax's ``sgd``, ``adagrad``
  (its defaults) and ``adam(eps=1e-7)``: three updates of the same
  parameters from the same gradients, within 1e-6, a zero gradient
  included (and Adagrad's "0 where the sum is 0" select, from a zero
  accumulator).
- ``run_grid``: the cell order, labels and history keys of the 3x3 grid.
- One cell of each optimizer against JAX's ``run_grid`` from the same
  weights (JAX's seeded init, converted), dropout 0 on both sides (each
  module's ``PointNet`` patched), b 8, n 32, 1 epoch of 2 steps. Bars as in
  ``test_torch_train_step.py``: losses within 8x JAX's own one-ulp
  sensitivity (the same JAX cell rerun on the train batch moved by one f32
  ulp) + 1e-6 of the loss + 1e-7; accuracies within JAX's own one-ulp
  change or one prediction, whichever is larger: Adam's first updates are
  lr * sign(g), so its cell moves its val loss by 5e-5 under a one-ulp
  input change, and a point whose top two part scores are that close
  flips (one of 256 here).
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pointcloudprocessing_tpu.models.pointnet import PointNet as JaxPointNet
from pointcloudprocessing_tpu.train import hypertune as jax_hypertune
from pointcloudprocessing_tpu_torch.convert import state_dict_from_flax
from pointcloudprocessing_tpu_torch.train import hypertune, steps

SCORE = "val_classification_output_sparse_categorical_accuracy"
HISTORY_KEYS = {"loss", "val_loss", SCORE,
                "val_segmentation_output_sparse_categorical_accuracy",
                "val_root_mean_squared_error"}
B, N, C, P = 8, 32, 3, 2


def histories(seed):
    rng = np.random.default_rng(seed)
    out = {}
    for opt in ("SGD", "Adagrad", "Adam"):
        for lr in hypertune.LEARNING_RATES:
            out[f"{opt} {lr}"] = {SCORE: list(rng.random(4)),
                                  "val_loss": list(rng.random(4) * 3)}
    return out


def test_hypertune_tables_equal_jax():
    got, want = hypertune.HyperTune(SCORE), jax_hypertune.HyperTune(SCORE)
    for i, model in enumerate(("pointnet", "vanilla", "third")):
        h = {"Model": model, **histories(i)}
        got.add_data(h)
        want.add_data(h)
    assert got.get_table() == want.get_table()
    assert got.get_overview() == want.get_overview()
    assert got.to_latex() == want.to_latex()
    assert list(got.get_overview()) == list(histories(0))


def test_optimizer_table_order():
    assert list(hypertune.OPTIMIZERS) == list(jax_hypertune.OPTIMIZERS) == [
        "SGD", "Adagrad", "Adam"]
    assert hypertune.LEARNING_RATES == jax_hypertune.LEARNING_RATES


OPTAX = {
    "sgd": (steps.sgd, optax.sgd),
    "adagrad": (steps.adagrad, optax.adagrad),
    "adam": (steps.adam, lambda lr: optax.adam(lr, eps=1e-7)),
}


@pytest.mark.parametrize("lr", [1e-3, 0.1])
@pytest.mark.parametrize("name", list(OPTAX))
def test_optimizer_matches_optax(name, lr):
    rng = np.random.default_rng(len(name))
    shapes = {"a": (5, 7), "b": (7,), "c": (3, 3), "zero_grad": (4,)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (np.zeros(s, np.float32) if k == "zero_grad"
                  else rng.normal(scale=10.0 ** -i, size=s).astype(np.float32))
              for k, s in shapes.items()} for i in range(3)]
    port_fn, optax_fn = OPTAX[name]
    tparams = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    opt = port_fn(lr)
    state = opt.init(tparams)
    jopt = optax_fn(lr)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jparams)
    for g in grads:
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        opt.update_(tparams, state)
        upd, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate,
                                  jparams)
        jparams = optax.apply_updates(jparams, upd)
        for k in params:
            np.testing.assert_allclose(tparams[k].detach().numpy(),
                                       np.asarray(jparams[k]), rtol=0, atol=1e-6,
                                       err_msg=k)
    assert state.count == 3
    assert np.array_equal(tparams["zero_grad"].detach().numpy(), params["zero_grad"])


def test_adagrad_select_where_the_sum_is_zero():
    """From a zero accumulator a zero gradient leaves the sum 0: optax's
    ``scale_by_rss`` gives 0 there, not g / sqrt(eps)."""

    class ZeroStart(steps.Adagrad):
        initial_slots = (0.0,)

    p = torch.tensor([1.0, 2.0, 3.0], requires_grad=True)
    p.grad = torch.tensor([0.0, 0.5, -2.0])
    opt = ZeroStart(0.1)
    state = opt.init({"p": p})
    opt.update_({"p": p}, state)
    jopt = optax.adagrad(0.1, initial_accumulator_value=0.0)
    jp = jnp.asarray([1.0, 2.0, 3.0])
    upd, _ = jopt.update(jnp.asarray([0.0, 0.5, -2.0]), jopt.init(jp), jp)
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp + upd), atol=1e-6)
    assert float(p[0]) == 1.0


def grid_batches():
    """``tests/test_hypertune.py``'s batches: b 8, n 32, 3 classes, 2 parts."""

    def make(seed):
        gen = np.random.default_rng(seed)
        x = gen.normal(size=(B, N, 3)).astype(np.float32)
        cls = gen.integers(0, C, B).astype(np.int32)
        x[:, :, 0] += cls[:, None] * 3.0
        return x, {"classification_output": cls,
                   "segmentation_output": (x[:, :, 2] > 0).astype(np.int32),
                   "se3": np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))}

    return make(1), make(2)


def test_run_grid_cells_labels_and_keys():
    train, val = grid_batches()
    printed = []
    results = hypertune.run_grid(train, val, C, P, N, epochs=2, steps_per_epoch=1,
                                 print_func=printed.append, device="cpu")
    labels = [f"{o} {lr}" for o in ("SGD", "Adagrad", "Adam")
              for lr in (0.0001, 0.001, 0.01)]
    assert list(results) == labels
    assert printed == [f"HyperTune: training {label}" for label in labels]
    for history in results.values():
        assert set(history) == HISTORY_KEYS
        assert all(len(v) == 2 and all(math.isfinite(x) for x in v)
                   for v in history.values())
    tune = hypertune.HyperTune(SCORE)
    tune.add_data({"Model": "vanilla", **results})
    assert list(tune.get_overview()) == labels
    assert "SGD 0.0001" in tune.to_latex()


def test_run_grid_cells_start_from_the_same_weights(monkeypatch):
    built = []
    real = hypertune.model_from_config

    def recording(*args, **kwargs):
        model = real(*args, **kwargs)
        built.append({k: v.clone() for k, v in model.state_dict().items()})
        return model

    monkeypatch.setattr(hypertune, "model_from_config", recording)
    train, val = grid_batches()
    hypertune.run_grid(train, val, C, P, N, epochs=1, steps_per_epoch=1,
                       learning_rates=(1e-3, 1e-2), print_func=lambda *_: None,
                       device="cpu")
    assert len(built) == 6
    assert all(torch.equal(b[k], built[0][k]) for b in built for k in b)


@pytest.fixture(scope="module")
def jax_cells():
    """JAX's run_grid, dropout 0, one cell per optimizer at lr 1e-3 on the
    batches and on the train batch moved by one ulp; and its init."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_hypertune, "PointNet", functools.partial(JaxPointNet, dropout_rate=0.0))
    train, val = grid_batches()
    moved = (np.nextafter(train[0], np.float32(np.inf)), train[1])
    out = {}
    try:
        for x in ("batch", "moved"):
            out[x] = jax_hypertune.run_grid(
                *[(jnp.asarray(b[0]), {k: jnp.asarray(v) for k, v in b[1].items()})
                  for b in ((train if x == "batch" else moved), val)],
                num_classes=C, num_parts=P, input_width=N, epochs=1,
                steps_per_epoch=2, learning_rates=(1e-3,),
                print_func=lambda *_: None)
    finally:
        mp.undo()
    init = JaxPointNet(num_classes=C, num_parts=P, vanilla=True).init(
        jax.random.key(42), jnp.zeros((1, N, 3), jnp.float32), train=False)
    out["init"] = jax.tree_util.tree_map(
        np.asarray, {"params": init["params"], "batch_stats": init["batch_stats"]})
    return out


def test_one_cell_each_matches_jax(jax_cells, monkeypatch):
    real = hypertune.model_from_config

    def from_jax_init(cfg, **kwargs):
        model = real(cfg, **{**kwargs, "dropout_rate": 0.0})
        model.load_state_dict(state_dict_from_flax(jax_cells["init"]))
        return model

    monkeypatch.setattr(hypertune, "model_from_config", from_jax_init)
    train, val = grid_batches()
    got = hypertune.run_grid(train, val, C, P, N, epochs=1, steps_per_epoch=2,
                             learning_rates=(1e-3,), print_func=lambda *_: None,
                             device="cpu")
    want, moved = jax_cells["batch"], jax_cells["moved"]
    assert list(got) == list(want) == ["SGD 0.001", "Adagrad 0.001", "Adam 0.001"]
    for label in got:
        assert set(got[label]) == set(want[label]) == HISTORY_KEYS
        for key in HISTORY_KEYS:
            g, w, m = got[label][key][0], want[label][key][0], moved[label][key][0]
            sens = abs(m - w)
            if "accuracy" in key:
                total = B if "classification" in key else B * N
                assert abs(g - w) <= max(sens, 1 / total), (label, key, g, w, m)
            else:
                bar = 8 * sens + 1e-6 * abs(w) + 1e-7
                assert abs(g - w) <= bar, (label, key, g, w, bar)
