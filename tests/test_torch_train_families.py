"""Every model family through the port's train and eval steps, against the
JAX package on the CPU.

- Freeze labels: the port's ``freeze_label_tree`` over a model's named
  parameters equals JAX's over its Flax tree, leaf for leaf on converted
  names, for PointNet (full and vanilla), PointNet++ and DGCNN under every
  combination of the four freeze flags (exact).
- One train step and one eval step of DGCNN and of PointNet++ from weights
  that ``convert.py`` carries across, jitter 0 and dropout rate 0, 4 clouds
  of 64 points. The eval step runs on the converted weights (running
  statistics). Bars, as ``tests/test_torch_train_step.py`` states them,
  against JAX's own sensitivity: the same JAX step or gradient on the batch
  moved by one f32 ulp (``np.nextafter``, up and down):
  - losses: |port - jax| <= 8 * JAX's one-ulp change + 1e-6 * |jax| + 1e-7;
    metric counts equal;
  - each gradient leaf: <= 16 * JAX's one-ulp change (max norm) + 1e-5 *
    max |g| (16 as in the PointNet test: BatchNorm's rounding differs in
    ways a one-ulp move of the batch does not probe);
  - new params: within 1e-3 * lr plus one f32 ulp of the parameter (the
    float64 reference rounds the update once) where |g| is over 10x the
    leaf's one-ulp change, within 2 * lr elsewhere (a sign Adam may flip); new running
    statistics within 8 * JAX's one-ulp change + 1e-6 + 1e-5 * |stat|.
  DGCNN is held to JAX's f32 step. PointNet++ is held to JAX's step in
  float64 (``jax.enable_x64``, the same f32 weights and clouds), with the
  sensitivities of JAX's f32 step: JAX's own f32 set-abstraction BatchNorm
  statistics are ~1e-4 from its float64 result at this size
  (``tests/test_torch_pointnet2.py``), 12x its one-ulp change, and the port
  is closer to the float64 result than that.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudprocessing_tpu.core.config import LearningConfig
from pointcloudprocessing_tpu.models import pointnet2 as jax_pn2
from pointcloudprocessing_tpu.models.dgcnn import DGCNN as JaxDGCNN
from pointcloudprocessing_tpu.models.pointnet import FreezeFlags as JaxFreeze
from pointcloudprocessing_tpu.models.pointnet import PointNet as JaxPointNet
from pointcloudprocessing_tpu.train import losses as jax_losses
from pointcloudprocessing_tpu.train import steps as jax_steps
from pointcloudprocessing_tpu_torch.convert import flax_from_state_dict, state_dict_from_flax
from pointcloudprocessing_tpu_torch.models import pointnet2
from pointcloudprocessing_tpu_torch.models.dgcnn import DGCNN
from pointcloudprocessing_tpu_torch.models.pointnet import FreezeFlags, PointNet
from pointcloudprocessing_tpu_torch.train import steps
from test_torch_pointnet import randomize
from test_torch_train_step import leaves

B, N, C, P = 4, 64, 5, 4
LR = 1e-4
LEARNING = LearningConfig(rate=LR, decay_steps=7, decay_rate=0.7)
WEIGHTS = (1.0, 1.0, 0.1)
NO_JITTER = (0.0, 0.0, 0.0)
DGCNN_TINY = dict(k=8, edge_widths=(8, 16), emb_width=32)  # tests/test_dgcnn.py


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers, and torch's
    thread pool, oversubscribed, slows these many small steps by tens of
    times (the results do not depend on it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _models(family):
    """(JAX model, port model on the CPU) of one family at test size."""
    if family == "dgcnn":
        return (JaxDGCNN(num_classes=C, num_parts=P, exact_knn=True, dropout_rate=0.0,
                         **DGCNN_TINY),
                DGCNN(C, P, dropout_rate=0.0, **DGCNN_TINY))
    if family == "pointnet2":
        return (jax_pn2.pointnet2_for_width(C, P, N, exact_knn=True, dropout_rate=0.0),
                pointnet2.pointnet2_for_width(C, P, N, dropout_rate=0.0, device="cpu"))
    vanilla = family == "pointnet_vanilla"
    return (JaxPointNet(num_classes=C, num_parts=P, vanilla=vanilla, dropout_rate=0.0),
            PointNet(C, P, vanilla=vanilla, dropout_rate=0.0))


@pytest.fixture(scope="module", params=["pointnet_full", "pointnet_vanilla",
                                        "pointnet2", "dgcnn"])
def family_pair(request):
    jmodel, model = _models(request.param)
    init = jax.jit(lambda r, x: jmodel.init(r, x, train=False))(
        jax.random.key(0), jnp.zeros((1, N, 3)))
    variables = randomize({"params": init["params"],
                           "batch_stats": init["batch_stats"]}, 3)
    model.load_state_dict(state_dict_from_flax(variables))
    return request.param, variables, model


@pytest.mark.parametrize("flags", list(itertools.product([False, True], repeat=4)),
                         ids=lambda f: "".join("F" if v else "t" for v in f))
def test_freeze_labels_equal_jax(family_pair, flags):
    """flags: (input_transform, shared_network, classification_head,
    segmentation_head) frozen."""
    _, variables, model = family_pair
    jax_labels = jax_steps.freeze_label_tree(variables["params"], JaxFreeze(*flags))
    as_numbers = jax.tree_util.tree_map(
        lambda label, p: np.full(np.shape(p), label == "train", np.float32),
        jax_labels, variables["params"])
    want = {name: ("train" if bool(t.reshape(-1)[0]) else "freeze")
            for name, t in state_dict_from_flax({"params": as_numbers}).items()}
    got = steps.freeze_label_tree(dict(model.named_parameters()), FreezeFlags(*flags))
    assert got == want
    assert len(got) == len(list(leaves(variables["params"])))


def _batch():
    rng = np.random.default_rng(1)
    shapes = np.array([[3.0, 0.2, 0.2], [2.0, 2.0, 0.1], [1.0, 1.0, 1.0],
                       [0.5, 3.0, 1.5]], np.float32)
    x = (rng.normal(size=(B, N, 3)) * shapes[:, None, :]).astype(np.float32)
    targets = {
        "classification_output": rng.integers(0, C, B).astype(np.int32),
        "segmentation_output": rng.integers(0, P, (B, N)).astype(np.int32),
        "se3": np.tile(np.eye(3, dtype=np.float32), (B, 1, 1)),
    }
    return x, targets


def _jax_fns(jmodel):
    """JAX's jitted train step, eval step and gradient of one model, built
    once so that the runs below share their compilations."""
    def grads(variables, x, targets):
        def loss_fn(params):
            out, _ = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                  x, train=True, mutable=["batch_stats"])
            return jax_losses.multi_head_loss(out, targets, WEIGHTS)[0]
        return jax.grad(loss_fn)(variables["params"])

    return {"eval": jax_steps.make_eval_step(jmodel, WEIGHTS, NO_JITTER),
            "grads": jax.jit(grads), "train": {}}


def _jax_run(jmodel, fns, variables, x, targets):
    """JAX's train step (logs, new params and stats), its gradients, and
    its eval step on ``variables``, for clouds ``x`` (float64 under x64)."""
    jt = jax.tree_util.tree_map(jnp.asarray, targets)
    jv = jax.tree_util.tree_map(jnp.asarray, variables)
    state, optimizer = jax_steps.init_train_state(jmodel, None, N, LEARNING, JaxFreeze(),
                                                  init_variables=jv)
    eval_logs = jax.device_get(fns["eval"](state, jnp.asarray(x), jt, jax.random.key(1)))
    grads = jax.device_get(fns["grads"](jv, jnp.asarray(x), jt))
    dtype = np.asarray(x).dtype.name
    if dtype not in fns["train"]:
        fns["train"][dtype] = jax_steps.make_train_step(
            jmodel, optimizer, WEIGHTS, JaxFreeze(), NO_JITTER)
    state, logs = fns["train"][dtype](state, jnp.asarray(x), jt, jax.random.key(0))  # donates
    return jax.device_get({"logs": logs, "eval": eval_logs, "grads": grads,
                           "params": state.params, "stats": state.batch_stats})


@pytest.fixture(scope="module", params=["dgcnn", "pointnet2"])
def step_run(request):
    family = request.param
    jmodel, model = _models(family)
    init = jax.jit(lambda r, x: jmodel.init(r, x, train=False))(
        jax.random.key(0), jnp.zeros((1, N, 3)))
    variables = randomize({"params": init["params"],
                           "batch_stats": init["batch_stats"]}, 3)
    x, targets = _batch()
    fns = _jax_fns(jmodel)
    f32 = {d: _jax_run(jmodel, fns, variables, np.nextafter(x, np.float32(d * np.inf)),
                       targets) for d in (1, -1)}
    if family == "pointnet2":
        with jax.enable_x64(True):
            ref = _jax_run(jmodel, fns, jax.tree_util.tree_map(
                lambda a: np.asarray(a, np.float64), variables), x.astype(np.float64), targets)
        ref = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), ref)
        f32[0] = _jax_run(jmodel, fns, variables, x, targets)
    else:
        ref = f32[0] = _jax_run(jmodel, fns, variables, x, targets)

    model.load_state_dict(state_dict_from_flax(variables))
    tt = {k: torch.from_numpy(v) for k, v in targets.items()}
    state, optimizer = steps.init_train_state(model, LEARNING, FreezeFlags())
    eval_logs = steps.make_eval_step(model, WEIGHTS, NO_JITTER)(state, torch.from_numpy(x), tt, 1)
    state, logs = steps.make_train_step(model, optimizer, WEIGHTS, FreezeFlags(), NO_JITTER)(
        state, torch.from_numpy(x), tt, 0)
    grads = flax_from_state_dict({n: p.grad.clone() for n, p in model.named_parameters()})
    new = flax_from_state_dict({k: v.clone() for k, v in model.state_dict().items()})
    port = {"logs": {k: v.numpy() for k, v in logs.items()},
            "eval": {k: v.numpy() for k, v in eval_logs.items()},
            "grads": grads["params"], "params": new["params"], "stats": new["batch_stats"]}
    return {"ref": ref, "f32": f32, "port": port}


@pytest.mark.parametrize("which", ["logs", "eval"])
def test_losses_and_counts_match_jax(step_run, which):
    got, want = step_run["port"][which], step_run["ref"][which]
    base = step_run["f32"][0][which]
    assert set(got) == set(want)
    for key in ("loss", "classification_output_loss", "segmentation_output_loss",
                "se3_loss", "se3_sq_sum"):
        sens = max(abs(float(step_run["f32"][d][which][key]) - float(base[key]))
                   for d in (1, -1))
        bound = 8 * sens + 1e-6 * abs(float(want[key])) + 1e-7
        assert abs(float(got[key]) - float(want[key])) <= bound, (key, got[key], want[key])
    for key in ("classification_correct", "classification_total",
                "segmentation_correct", "segmentation_total", "se3_count"):
        assert float(got[key]) == float(want[key]), key


def _sensitivity(step_run, tree):
    base = dict(leaves(step_run["f32"][0][tree]))
    moved = [dict(leaves(step_run["f32"][d][tree])) for d in (1, -1)]
    return {k: max(np.abs(m[k] - base[k]).max() for m in moved) for k in base}


def test_grads_match_jax(step_run):
    want = dict(leaves(step_run["ref"]["grads"]))
    got = dict(leaves(step_run["port"]["grads"]))
    sens = _sensitivity(step_run, "grads")
    assert set(got) == set(want)
    for key, g in got.items():
        bound = 16 * sens[key] + 1e-5 * np.abs(want[key]).max()
        err = np.abs(g - want[key]).max()
        assert err <= bound, f"{key}: {err:.3e} > {bound:.3e}"


def test_params_and_stats_match_jax(step_run):
    grads = dict(leaves(step_run["ref"]["grads"]))
    sens = _sensitivity(step_run, "grads")
    got = dict(leaves(step_run["port"]["params"]))
    for key, p in leaves(step_run["ref"]["params"]):
        certain = np.abs(grads[key]) > 10 * sens[key]
        err = np.abs(got[key] - p)
        bound = 1e-3 * LR + np.spacing(np.abs(p))
        assert (err[certain] <= bound[certain]).all(), key
        assert err.max() <= 2 * LR * (1 + 1e-3), key
    stat_sens = _sensitivity(step_run, "stats")
    got_stats = dict(leaves(step_run["port"]["stats"]))
    want_stats = dict(leaves(step_run["ref"]["stats"]))
    assert set(got_stats) == set(want_stats)
    for key, s in want_stats.items():
        bound = 8 * stat_sens[key] + 1e-6 + 1e-5 * np.abs(s)
        assert (np.abs(got_stats[key] - s) <= bound).all(), key


def test_families_add_no_regularizer():
    """PointNet++ and DGCNN have no forward_with_reg; the step adds 0."""
    for family in ("dgcnn", "pointnet2"):
        _, model = _models(family)
        outputs, reg = steps.forward_with_reg(model, torch.zeros(2, N, 3))
        assert reg == 0.0 and set(outputs) == {
            "classification_output", "segmentation_output", "se3"}
