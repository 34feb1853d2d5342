"""The port's training step against the JAX package on the CPU.

Both packages start from the same Flax variables (converted with
``pointcloudprocessing_tpu_torch.convert``), the same numpy batch, jitter
off and dropout 0, and take one step, then four more.

At b = 4 a train step is ill-conditioned: BatchNorm over 4 clouds in the
T-Nets' dense layers amplifies f32 rounding, and Adam's first update is
lr * sign(g) wherever |g| is far above eps. So the tolerances are stated
against the JAX reference's own sensitivity, measured here: the same JAX
step on the batch moved by one f32 ulp (``np.nextafter``; for gradients,
the larger change of a move up and a move down).

- loss, head losses, se3 sum: rtol 1e-4; correct counts: equal;
- each trained gradient leaf: |port - jax| <= 16 * (JAX's one-ulp change of that
  leaf, max norm) + 1e-5 * max |g|. 16, not 8: the port takes a pooled
  chain's batch statistics from the Gram matrix and JAX's f32 path from
  the pre-activation, a rounding difference a one-ulp move of the batch
  does not probe; it shows most in gradients that are small residues of
  cancelling terms (6.3x on ``mlp_2_2/bn/bias`` at this batch); a frozen
  leaf has no gradient in the port (``requires_grad`` is off), where JAX
  computes one and masks its update;
- new params: within 1e-3 * lr wherever |g| is over 10x that leaf's one-ulp
  change (the update's sign is certain there), within 2 * lr elsewhere (a
  sign Adam may flip); new batch statistics: within 8 * JAX's one-ulp
  change of that leaf + 1e-6 + 1e-5 * |stat|;
- 5-step loss history: |port - jax| at step s <= 2 * the largest one-ulp
  divergence of JAX's own history up to s + 1e-4 * |loss|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudprocessing_tpu.core.config import LearningConfig
from pointcloudprocessing_tpu.models.pointnet import FreezeFlags as JaxFreeze
from pointcloudprocessing_tpu.models.pointnet import PointNet as JaxPointNet
from pointcloudprocessing_tpu.train import losses as jax_losses
from pointcloudprocessing_tpu.train import steps as jax_steps
from pointcloudprocessing_tpu_torch.convert import (
    flax_from_state_dict,
    state_dict_from_flax,
)
from pointcloudprocessing_tpu_torch.models.pointnet import FreezeFlags, PointNet
from pointcloudprocessing_tpu_torch.train import losses, steps

B, N, C, P = 4, 64, 5, 3
LR = 1e-4
LEARNING = LearningConfig(rate=LR, decay_steps=7, decay_rate=0.7)
STEPS = 5

CASES = {
    # the full model with both T-Net regularizers, nothing frozen
    "full": dict(vanilla=False, freeze=(False, False, False, False),
                 loss_weights=(1.0, 1.0, 0.1), regularize=True),
    # the users' kc46 `final` stage: vanilla, classification head frozen
    "vanilla_frozen_head": dict(vanilla=True, freeze=(False, False, True, False),
                                loss_weights=(0.0, 1.0, 0.0), regularize=False),
}
# the trunk frozen under a trained input T-Net: the feature T-Net's and the
# trunk's pooled chains run on running statistics and pass the gradient down
# (the running-statistics chain's backward). One step only: over five, JAX's
# own one-ulp histories of this case part by as much as the port does.
FROZEN_TRUNK = dict(vanilla=False, freeze=(False, True, False, False),
                    loss_weights=(1.0, 1.0, 0.1), regularize=True)


def leaves(tree, prefix=()):
    for name, value in tree.items():
        if isinstance(value, dict):
            yield from leaves(value, prefix + (name,))
        else:
            yield "/".join(prefix + (name,)), np.asarray(value)


def batch():
    """Four clouds of distinct shapes (rod, plate, ball, two blobs): the
    batch statistics of the T-Nets' dense layers are then far from 0."""
    rng = np.random.default_rng(1)
    shapes = np.array([[3.0, 0.2, 0.2], [2.0, 2.0, 0.1], [1.0, 1.0, 1.0],
                       [0.5, 3.0, 1.5]], np.float32)
    x = (rng.normal(size=(B, N, 3)) * shapes[:, None, :]).astype(np.float32)
    x[3, : N // 2] += 4.0
    targets = {
        "classification_output": rng.integers(0, C, B).astype(np.int32),
        "segmentation_output": rng.integers(0, P, (B, N)).astype(np.int32),
        "se3": np.tile(np.eye(3, dtype=np.float32), (B, 1, 1)),
    }
    return x, targets


def torch_targets(targets):
    return {k: torch.from_numpy(v) for k, v in targets.items()}


@pytest.fixture(scope="module", params=list(CASES))
def run(request):
    return run_case(CASES[request.param])


def run_case(case, num_steps=STEPS):
    """One case run through both packages: JAX's history on the batch and
    on the batch moved by one ulp, JAX's step-0 gradients on both, and the
    port's steps."""
    reg = case["regularize"]
    jmodel = JaxPointNet(num_classes=C, num_parts=P, vanilla=case["vanilla"],
                         dropout_rate=0.0, regularize_input_transform=reg,
                         regularize_feature_transform=reg)
    init = jmodel.init(jax.random.key(0), jnp.zeros((1, N, 3)), train=False)
    variables = jax.tree_util.tree_map(
        np.asarray, {"params": init["params"], "batch_stats": init["batch_stats"]})
    x, targets = batch()
    x_ulp = np.nextafter(x, np.float32(np.inf))
    jfreeze = JaxFreeze(*case["freeze"])
    jtargets = jax.tree_util.tree_map(jnp.asarray, targets)

    def jax_history(points):
        state, optimizer = jax_steps.init_train_state(
            jmodel, None, N, LEARNING, jfreeze,
            init_variables=jax.tree_util.tree_map(jnp.asarray, variables))
        step = jax_steps.make_train_step(
            jmodel, optimizer, case["loss_weights"], jfreeze, (0.0, 0.0, 0.0))
        history = []
        for _ in range(num_steps):
            state, logs = step(state, jnp.asarray(points), jtargets,
                               jax.random.key(0))
            history.append(jax.device_get(
                (logs, {"params": state.params, "batch_stats": state.batch_stats})))
        return history

    @jax.jit
    def jax_grads(params, points):
        def loss_fn(params):
            out, upd = jmodel.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                points, train=True, freeze=jfreeze,
                mutable=["batch_stats", "reg_losses"])
            reg_sum = sum(jnp.sum(v) for v in
                          jax.tree_util.tree_leaves(upd.get("reg_losses", {})))
            return jax_losses.multi_head_loss(
                out, jtargets, case["loss_weights"], reg_sum)[0]
        return jax.grad(loss_fn)(params)

    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    model = PointNet(C, P, vanilla=case["vanilla"], dropout_rate=0.0,
                     regularize_input_transform=reg,
                     regularize_feature_transform=reg)
    model.load_state_dict(state_dict_from_flax(variables))
    freeze = FreezeFlags(*case["freeze"])
    state, optimizer = steps.init_train_state(model, LEARNING, freeze)
    step = steps.make_train_step(model, optimizer, case["loss_weights"], freeze,
                                 (0.0, 0.0, 0.0))
    history = []
    for i in range(num_steps):
        state, logs = step(state, torch.from_numpy(x), torch_targets(targets), 0)
        # clones: on the CPU a state_dict tensor, and numpy's view of it,
        # share memory with the live parameter the next step updates
        entry = {"logs": {k: v.numpy() for k, v in logs.items()},
                 "variables": flax_from_state_dict(
                     {k: v.clone() for k, v in model.state_dict().items()})}
        if i == 0:
            entry["grads"] = flax_from_state_dict(
                {n: p.grad.clone() for n, p in model.named_parameters()
                 if p.grad is not None})["params"]
        history.append(entry)
    return {
        "case": case,
        "variables": variables,
        "jax": jax_history(x),
        "jax_ulp": jax_history(x_ulp),
        "jax_grads": jax.device_get(jax_grads(params, jnp.asarray(x))),
        "jax_grads_ulp": jax.device_get(jax_grads(params, jnp.asarray(x_ulp))),
        "jax_grads_ulp_down": jax.device_get(jax_grads(
            params, jnp.asarray(np.nextafter(x, np.float32(-np.inf))))),
        "port": history,
        "model": model,
    }


def test_first_step_losses_and_metrics_match_jax(run):
    got = run["port"][0]["logs"]
    want = run["jax"][0][0]
    assert set(got) == set(want)
    for key in ("loss", "classification_output_loss", "segmentation_output_loss",
                "se3_loss", "se3_sq_sum"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=key)
    for key in ("classification_correct", "classification_total",
                "segmentation_correct", "segmentation_total", "se3_count"):
        assert float(got[key]) == float(want[key]), key


def grad_sensitivity(run) -> dict[str, float]:
    """Per leaf, the larger max-norm change of JAX's step-0 gradient when
    the batch moves one ulp up or down."""
    want = dict(leaves(run["jax_grads"]))
    up = dict(leaves(run["jax_grads_ulp"]))
    down = dict(leaves(run["jax_grads_ulp_down"]))
    return {k: max(np.abs(want[k] - up[k]).max(), np.abs(want[k] - down[k]).max())
            for k in want}


def frozen_leaves(run) -> set[str]:
    """The Flax leaf names the case's stage freezes."""
    labels = steps.freeze_label_tree(
        {k.replace("/", "."): None for k, _ in leaves(run["jax_grads"])},
        FreezeFlags(*run["case"]["freeze"]))
    return {k.replace(".", "/") for k, label in labels.items() if label == "freeze"}


def test_first_step_grads_match_jax(run):
    want = dict(leaves(run["jax_grads"]))
    sens = grad_sensitivity(run)
    got = dict(leaves(run["port"][0]["grads"]))
    assert set(got) == set(want) - frozen_leaves(run)
    for key, g in got.items():
        sensitivity = sens[key]
        bound = 16 * sensitivity + 1e-5 * np.abs(want[key]).max()
        err = np.abs(g - want[key]).max()
        assert err <= bound, f"{key}: {err:.3e} > {bound:.3e}"


def test_first_step_params_and_stats_match_jax(run):
    want_grads = dict(leaves(run["jax_grads"]))
    sens = grad_sensitivity(run)
    got = run["port"][0]["variables"]
    want = run["jax"][0][1]
    got_params = dict(leaves(got["params"]))
    assert set(got_params) == set(dict(leaves(want["params"])))
    for key, p in leaves(want["params"]):
        g = want_grads[key]
        certain = np.abs(g) > 10 * sens[key]
        err = np.abs(got_params[key] - p)
        assert err[certain].max(initial=0.0) <= 1e-3 * LR, key
        assert err.max() <= 2 * LR * (1 + 1e-3), key
    got_stats = dict(leaves(got["batch_stats"]))
    want_ulp = dict(leaves(run["jax_ulp"][0][1]["batch_stats"]))
    for key, s in leaves(want["batch_stats"]):
        bound = 8 * np.abs(s - want_ulp[key]).max() + 1e-6 + 1e-5 * np.abs(s)
        assert (np.abs(got_stats[key] - s) <= bound).all(), key


def test_five_step_history_matches_jax(run):
    drift = 0.0
    for s in range(STEPS):
        want = float(run["jax"][s][0]["loss"])
        drift = max(drift, abs(float(run["jax_ulp"][s][0]["loss"]) - want))
        got = float(run["port"][s]["logs"]["loss"])
        assert abs(got - want) <= 2 * drift + 1e-4 * abs(want), (s, got, want, drift)
        assert np.isfinite(got)


def test_frozen_trunk_first_step_matches_jax():
    """The first-step checks above on a stage that freezes the trunk under
    a trained input T-Net."""
    run = run_case(FROZEN_TRUNK, num_steps=1)
    test_first_step_losses_and_metrics_match_jax(run)
    test_first_step_grads_match_jax(run)
    test_first_step_params_and_stats_match_jax(run)
    test_frozen_subtrees_take_no_update(run)


def test_frozen_subtrees_take_no_update(run):
    """Frozen parameters and the frozen blocks' running statistics stay
    bit-identical over the steps; the trained ones move."""
    init = state_dict_from_flax(run["variables"])
    final = run["model"].state_dict()
    freeze = FreezeFlags(*run["case"]["freeze"])
    labels = steps.freeze_label_tree(dict(run["model"].named_parameters()), freeze)
    for name, tensor in final.items():
        # a running statistic follows its BatchNorm's scale
        owner = name if name in labels else name.rsplit(".", 1)[0] + ".weight"
        frozen = labels[owner] == "freeze"
        if frozen:
            assert torch.equal(tensor, init[name]), name
        elif name in labels:
            assert not torch.equal(tensor, init[name]), name


def test_state_converts_back_and_evaluates_in_jax(run):
    """The port's state after 5 steps converts to a Flax tree that the JAX
    package evaluates to the port's outputs (the parity bar, 1e-4)."""
    model = run["model"]
    variables = flax_from_state_dict(model.state_dict())
    jmodel = JaxPointNet(num_classes=C, num_parts=P, vanilla=model.vanilla)
    x, _ = batch()
    want = jmodel.apply(jax.tree_util.tree_map(jnp.asarray, variables),
                        jnp.asarray(x), train=False)
    got = steps.make_predict_fn(model)(torch.from_numpy(x))
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=1e-4, err_msg=key)


# ------------------------------------------------------- port-only behaviour

def _toy_problem(seed=0, b=8, n=32, classes=4):
    """Clouds whose class and parts are recoverable from geometry
    (tests/test_train_steps.py's problem)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n, 3)).astype(np.float32)
    cls = rng.integers(0, classes, b).astype(np.int32)
    x[:, :, 0] += cls[:, None] * 4.0
    targets = {
        "classification_output": torch.from_numpy(cls),
        "segmentation_output": torch.from_numpy((x[:, :, 2] > 0).astype(np.int32)),
        "se3": torch.eye(3).expand(b, 3, 3).contiguous(),
    }
    return torch.from_numpy(x), targets


def test_loss_decreases():
    model = PointNet(4, 3, generator=torch.Generator().manual_seed(0))
    state, optimizer = steps.init_train_state(
        model, LearningConfig(rate=1e-3, decay_steps=1000, decay_rate=0.9))
    step = steps.make_train_step(model, optimizer, (1.0, 1.0, 0.1), FreezeFlags(),
                                 (0.0, 0.0, 0.0))
    x, targets = _toy_problem()
    losses_seen = []
    for _ in range(30):
        state, logs = step(state, x, targets, 42)
        losses_seen.append(float(logs["loss"]))
    assert np.isfinite(losses_seen).all()
    assert losses_seen[-1] < losses_seen[0] * 0.7
    assert state.step == 30 and state.opt_state.count == 30


def test_freeze_mask_keeps_params_fixed():
    """tests/test_train_steps.py's freeze check: only the classification
    head trains; every other parameter and statistic stays bit-identical."""
    model = PointNet(4, 3, generator=torch.Generator().manual_seed(0))
    freeze = FreezeFlags(input_transform=True, shared_network=True,
                         classification_head=False, segmentation_head=True)
    state, optimizer = steps.init_train_state(model, LearningConfig(rate=1e-2), freeze)
    assert all(n.startswith("mlp_cls") for n in state.opt_state.mu)
    step = steps.make_train_step(model, optimizer, (1.0, 0.0, 0.0), freeze,
                                 (0.0, 0.0, 0.0))
    x, targets = _toy_problem()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    for _ in range(3):
        state, _ = step(state, x, targets, 1)
    # frozen parameters take no gradient at all, trained ones do
    for name, p in model.named_parameters():
        trained = name.startswith("mlp_cls")
        assert p.requires_grad == trained and (p.grad is not None) == trained, name
    after = model.state_dict()
    moved = False
    for name, value in after.items():
        if name.startswith("mlp_cls"):
            moved = moved or not torch.equal(value, before[name])
        else:
            assert torch.equal(value, before[name]), name
    assert moved


def test_eval_step_no_mutation():
    model = PointNet(4, 3, regularize_input_transform=True,
                     generator=torch.Generator().manual_seed(0))
    state, _ = steps.init_train_state(model, LearningConfig())
    eval_step = steps.make_eval_step(model, (1.0, 1.0, 0.0), (0.01, 0.0, 0.0))
    x, targets = _toy_problem()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    logs = eval_step(state, x, targets, 0)
    assert np.isfinite(float(logs["loss"]))
    # the regularizer counts in eval too, as Keras adds model.losses
    assert float(logs["loss"]) > float(logs["classification_output_loss"]
                                       + logs["segmentation_output_loss"])
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert state.step == 0


def test_eval_step_matches_jax():
    """Eval logs from converted weights, jitter off, both regularizers on."""
    jmodel = JaxPointNet(num_classes=C, num_parts=P, regularize_input_transform=True,
                         regularize_feature_transform=True)
    init = jmodel.init(jax.random.key(3), jnp.zeros((1, N, 3)), train=False)
    variables = jax.tree_util.tree_map(
        np.asarray, {"params": init["params"], "batch_stats": init["batch_stats"]})
    state, _ = jax_steps.init_train_state(
        jmodel, None, N, LEARNING, init_variables=variables)
    x, targets = batch()
    want = jax_steps.make_eval_step(jmodel, (1.0, 1.0, 0.1), apply_jitter=False)(
        state, jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, targets),
        jax.random.key(0))
    model = PointNet(C, P, regularize_input_transform=True,
                     regularize_feature_transform=True)
    model.load_state_dict(state_dict_from_flax(variables))
    pstate, _ = steps.init_train_state(model, LEARNING)
    got = steps.make_eval_step(model, (1.0, 1.0, 0.1), apply_jitter=False)(
        pstate, torch.from_numpy(x), torch_targets(targets), 0)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5,
                                   atol=1e-6, err_msg=key)


def test_optimizer_matches_optax():
    """The port's Adam, learning-rate decay and freeze mask against the
    JAX package's make_optimizer (optax), over 6 updates: rtol 1e-6."""
    import optax

    rng = np.random.default_rng(0)
    params = {
        "mlp_1_1": {"conv": {"kernel": rng.normal(size=(3, 8)).astype(np.float32)}},
        "mlp_cls_1": {"dense": {"kernel": rng.normal(size=(8, 4)).astype(np.float32)},
                      "bn": {"scale": rng.uniform(0.5, 1.5, 4).astype(np.float32)}},
    }
    learning = LearningConfig(rate=1e-2, decay_steps=3, decay_rate=0.5)
    jfreeze, freeze = JaxFreeze(classification_head=True), FreezeFlags(
        classification_head=True)
    jopt = jax_steps.make_optimizer(learning, params, jfreeze)
    jstate = jopt.init(params)
    jparams = params
    port = {n: a.clone() for n, a in state_dict_from_flax(
        {"params": params}).items()}
    opt = steps.make_optimizer(learning, port, freeze)
    state = opt.init(port)
    assert set(state.mu) == {"mlp_1_1.conv.weight"}
    for _ in range(6):
        grads = jax.tree_util.tree_map(
            lambda p: rng.normal(size=p.shape).astype(np.float32), params)
        updates, jstate = jopt.update(grads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for name, g in state_dict_from_flax({"params": grads}).items():
            port[name].grad = g
        opt.update_(port, state)
        for name, p in state_dict_from_flax(
                {"params": jax.device_get(jparams)}).items():
            np.testing.assert_allclose(port[name].numpy(), p.numpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=name)


def test_learning_rate_matches_optax_schedule():
    import optax

    learning = LearningConfig(rate=1e-4, decay_steps=7000, decay_rate=0.7)
    schedule = optax.exponential_decay(1e-4, 7000, 0.7, staircase=False)
    opt = steps.Optimizer(learning, {})
    for count in (0, 1, 6999, 7000, 12345):
        assert float(opt.learning_rate(count)) == pytest.approx(
            float(schedule(count)), rel=1e-6)
    assert float(opt.learning_rate(0)) == np.float32(1e-4)


def test_step_generators_are_seeded_per_step():
    a = steps.step_generators(7, 3, torch.device("cpu"))
    b = steps.step_generators(7, 3, torch.device("cpu"))
    c = steps.step_generators(7, 4, torch.device("cpu"))
    draw = [torch.rand(4, generator=g) for g in (*a, *b, *c)]
    assert torch.equal(draw[0], draw[2]) and torch.equal(draw[1], draw[3])
    assert not torch.equal(draw[0], draw[1])  # jitter and dropout differ
    assert not torch.equal(draw[0], draw[4])  # and so do steps


# ------------------------------------------------------------------ losses

@pytest.fixture(scope="module")
def loss_inputs():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(6, 5)).astype(np.float32) * 3
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    probs[0] = [1.0, 0.0, 0.0, 0.0, 0.0]  # clipped at 1e-7 and 1 - 1e-7
    probs[1] *= 3.0  # renormalized first
    labels = rng.integers(0, 5, 6).astype(np.int32)
    labels[:3] = [1, -2, 9]  # a clipped probability; out-of-range labels
    return probs, labels


def test_sparse_categorical_crossentropy_matches_jax(loss_inputs):
    probs, labels = loss_inputs
    want = jax_losses.sparse_categorical_crossentropy(
        jnp.asarray(probs), jnp.asarray(labels))
    got = losses.sparse_categorical_crossentropy(
        torch.from_numpy(probs), torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    assert float(got[0]) == pytest.approx(-np.log(np.float32(1e-7)), rel=1e-5)


def test_multi_head_loss_matches_jax():
    rng = np.random.default_rng(6)
    outputs = {
        "classification_output": rng.dirichlet(np.ones(5), 4).astype(np.float32),
        "segmentation_output": rng.dirichlet(np.ones(3), (4, 16)).astype(np.float32),
        "se3": rng.normal(size=(4, 3, 3)).astype(np.float32),
    }
    targets = {
        "classification_output": rng.integers(0, 5, 4).astype(np.int32),
        "segmentation_output": rng.integers(0, 3, (4, 16)).astype(np.int32),
        "se3": rng.normal(size=(4, 3, 3)).astype(np.float32),
    }
    weights = (0.5, 1.0, 0.1)
    want_total, want_heads = jax_losses.multi_head_loss(
        jax.tree_util.tree_map(jnp.asarray, outputs),
        jax.tree_util.tree_map(jnp.asarray, targets), weights, 0.25)
    got_total, got_heads = losses.multi_head_loss(
        torch_targets(outputs), torch_targets(targets), weights, 0.25)
    np.testing.assert_allclose(float(got_total), float(want_total), rtol=1e-6)
    for key in want_heads:
        np.testing.assert_allclose(float(got_heads[key]), float(want_heads[key]),
                                   rtol=1e-6, err_msg=key)
    mse = losses.mean_squared_error(
        torch.from_numpy(outputs["se3"]), torch.from_numpy(targets["se3"]))
    assert mse.shape == (4,)


# ---------------------------------------------------------- augment, dropout

def test_jitter_scales_per_axis_and_is_seeded():
    from pointcloudprocessing_tpu_torch.ops.augment import jitter

    pts = torch.zeros(64, 512, 3)
    out = jitter(pts, torch.Generator().manual_seed(0), (0.1, 0.0, 2.0))
    std = out.reshape(-1, 3).std(dim=0)
    assert abs(float(std[0]) - 0.1) < 0.005 and float(std[1]) == 0.0
    assert abs(float(std[2]) - 2.0) < 0.1
    again = jitter(pts, torch.Generator().manual_seed(0), (0.1, 0.0, 2.0))
    assert torch.equal(out, again)


def test_dropout_keeps_and_scales_like_flax():
    from pointcloudprocessing_tpu_torch.models.pointnet import dropout

    x = torch.ones(256, 512)
    out = dropout(x, 0.3, torch.Generator().manual_seed(1))
    kept = out != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.01
    np.testing.assert_allclose(out[kept].numpy(), 1.0 / 0.7, rtol=1e-6)
    assert dropout(x, 0.0, None) is x
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, 0.3, None)


def test_model_from_config_training_regularizers():
    from pointcloudprocessing_tpu.core.config import parse_config
    from pointcloudprocessing_tpu_torch.models.factory import model_from_config

    config = {
        "info": {"name": "t", "class_labels": {"0": "a", "1": "b"},
                 "part_labels": {"0": "p"}},
        "params": {"input_width": 32, "epochs": 1, "patience": 1, "batch_size": 2,
                   "regularize_input_transform": True,
                   "regularize_feature_transform": True},
    }
    cfg = parse_config(config)
    trained = model_from_config(cfg, training=True, dropout_rate=0.1,
                                device="cpu")
    served = model_from_config(cfg, device="cpu")
    assert trained.input_transform.add_regularization
    assert trained.feature_transform.add_regularization
    assert trained.dropout_rate == 0.1
    assert not served.input_transform.add_regularization
    assert not served.feature_transform.add_regularization
