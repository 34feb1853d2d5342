"""The port's multi-device train and eval steps (the shard_map and global
modes, the eval step over a mesh) on the CPU, against the port's
single-device step and the JAX package's multi-device steps.

A module fixture spawns one 2-rank gloo group (``torch_parallel_worker``)
that runs every scenario once; the JAX side runs on the conftest's
virtual CPU devices (meshes over ``jax.devices()[:2]``). TINY sizes: the
full PointNet (both T-Nets and regularizers, 5 classes, 3 parts), clouds
of 64 points, dropout 0 and jitter 0 in the train steps, the batches of
``tests/test_torch_train_step.py``.

Bars (``torch_parallel_worker.within_step_bars``) are that file's: each
reference's own one-ulp sensitivity (the step on the batch moved one f32
ulp), 8x for the port's single-device step, 16x on gradients for JAX's
(the port's Gram-matrix statistics round differently).
- shard_map mode on identical shards: the port's single step bit for
  bit, on both ranks; within JAX's ``make_shardmap_train_multi_step`` bars;
- shard_map on distinct shards: parameters bit-identical across ranks,
  within JAX's shard_map step's bars (its gradient: the mean of the
  halves');
- global mode on 2 ranks: within the bars of the port's single step on
  the whole batch and of JAX's GSPMD step over 2 devices; ranks identical;
  each rank passing its own rows equals the split batch, bit for bit;
- the eval step over a mesh: the single-device logs (jitter on, the whole
  batch's draw), within 1e-6 relative.

The mesh's own functions, sharded serving and the dry run are in
``tests/test_torch_parallel_serving.py``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_parallel_worker as tpw
from pointcloudprocessing_tpu.core.config import LearningConfig
from pointcloudprocessing_tpu.models.pointnet import FreezeFlags as JaxFreeze
from pointcloudprocessing_tpu.models.pointnet import PointNet as JaxPointNet
from pointcloudprocessing_tpu.train import losses as jax_losses
from pointcloudprocessing_tpu.train import steps as jax_steps
from pointcloudprocessing_tpu_torch.convert import state_dict_from_flax
from pointcloudprocessing_tpu_torch.models.pointnet import FreezeFlags
from pointcloudprocessing_tpu_torch.parallel import mesh as mesh_lib
from pointcloudprocessing_tpu_torch.train import steps
from test_torch_train_step import batch as batch4

B, N, C, PARTS = 4, 64, 5, 3
LR = 1e-4
LEARNING = (LR, 7, 0.7)  # rate, decay_steps, decay_rate
WEIGHTS = (1.0, 1.0, 0.1)
NO_JITTER = (0.0, 0.0, 0.0)
POINTNET = dict(num_classes=C, num_parts=PARTS, dropout_rate=0.0,
                regularize_input_transform=True, regularize_feature_transform=True)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers, and torch's
    thread pool, oversubscribed, slows these small steps by tens of times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def batch8():
    """Eight clouds: ``batch4``'s four, then four of other shapes."""
    x4, t4 = batch4()
    rng = np.random.default_rng(2)
    shapes = np.array([[0.3, 2.5, 0.4], [1.5, 0.2, 1.5], [2.0, 1.0, 0.5],
                       [0.8, 0.8, 2.5]], np.float32)
    x = (rng.normal(size=(B, N, 3)) * shapes[:, None, :]).astype(np.float32)
    t = {"classification_output": rng.integers(0, C, B).astype(np.int32),
         "segmentation_output": rng.integers(0, PARTS, (B, N)).astype(np.int32),
         "se3": np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))}
    return (np.concatenate([x4, x]),
            {k: np.concatenate([t4[k], t[k]]) for k in t4})


def ulps(x):
    """x moved one f32 ulp up and down."""
    return np.nextafter(x, np.float32(np.inf)), np.nextafter(x, np.float32(-np.inf))


def jax_init(jmodel, width=N, seed=0):
    init = jax.jit(lambda r, x: jmodel.init(r, x, train=False))(
        jax.random.key(seed), jnp.zeros((1, width, 3)))
    return jax.tree_util.tree_map(
        np.asarray, {"params": init["params"], "batch_stats": init["batch_stats"]})


def flat(variables) -> dict:
    """A Flax tree as the port's flat (params, stats) numpy dicts."""
    return tpw.split_state({k: v.numpy() for k, v in
                            state_dict_from_flax(variables).items()})


def flat_grads(grads, variables) -> dict:
    params, _ = flat({"params": jax.device_get(grads),
                      "batch_stats": variables["batch_stats"]})
    return params


def reference(logs, params, stats, grads=None) -> dict:
    out = {"logs": {k: np.asarray(v) for k, v in logs.items()}, "params": params,
           "stats": stats}
    if grads is not None:
        out["grads"] = grads
    return out


def rank_result(res: dict) -> dict:
    params, stats = tpw.split_state(res["state"])
    return reference(res["logs"], params, stats, res.get("grads"))


def port_single(family_kwargs, state, x, targets, family="pointnet") -> dict:
    """The port's single-device train step on the whole batch."""
    model = tpw._build(family, family_kwargs)
    model.load_state_dict(state)
    st, optimizer = steps.init_train_state(model, LearningConfig(*LEARNING), FreezeFlags())
    step = steps.make_train_step(model, optimizer, WEIGHTS, FreezeFlags(), NO_JITTER)
    _, logs = step(st, torch.from_numpy(x),
                   {k: torch.from_numpy(v) for k, v in targets.items()}, 0)
    params, stats = tpw.split_state(tpw._numpy(model.state_dict()))
    return reference(tpw._numpy(logs), params, stats,
                     {n: p.grad.clone().numpy() for n, p in model.named_parameters()})


def port_bars(family_kwargs, state, x, targets, family="pointnet"):
    """(reference, its one-ulp step, gradient sensitivity) of the port's
    single-device step."""
    want = port_single(family_kwargs, state, x, targets, family)
    up, down = (port_single(family_kwargs, state, u, targets, family) for u in ulps(x))
    sens = {k: max(np.abs(g - up["grads"][k]).max(), np.abs(g - down["grads"][k]).max())
            for k, g in want["grads"].items()}
    return want, up, sens


def jax_grad_fn(jmodel):
    @jax.jit
    def grads(variables, x, targets):
        def loss_fn(params):
            out, upd = jmodel.apply(
                {"params": params, "batch_stats": variables["batch_stats"]}, x,
                train=True, mutable=["batch_stats", "reg_losses"])
            reg = sum(jnp.sum(v) for v in
                      jax.tree_util.tree_leaves(upd.get("reg_losses", {})))
            return jax_losses.multi_head_loss(out, targets, WEIGHTS, reg)[0]
        return jax.grad(loss_fn)(variables["params"])
    return grads


def jax_state(jmodel, variables):
    state, optimizer = jax_steps.init_train_state(
        jmodel, None, N, LearningConfig(*LEARNING), JaxFreeze(),
        init_variables=jax.tree_util.tree_map(jnp.asarray, variables))
    return state, optimizer


def jax_after(state, logs) -> tuple[dict, dict, dict]:
    logs, params, stats = jax.device_get((logs, state.params, state.batch_stats))
    p, s = flat({"params": params, "batch_stats": stats})
    return {k: np.asarray(v).reshape(-1)[-1] for k, v in logs.items()}, p, s


def jax_shardmap(jmodel, variables, x, targets) -> dict:
    """JAX's shard_map step (K = 1) over 2 CPU devices on the global batch;
    with ``grads``: the mean of the halves' gradients."""
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    state, optimizer = jax_state(jmodel, variables)
    sm = jax_steps.make_shardmap_train_multi_step(
        jmodel, optimizer, WEIGHTS, JaxFreeze(), NO_JITTER, mesh)
    state, logs = sm(state, jnp.asarray(x)[None],
                     {k: jnp.asarray(v)[None] for k, v in targets.items()},
                     jax.random.key(0))
    return jax_after(state, logs)


def jax_gspmd(jmodel, variables, x, targets, devices=2) -> tuple:
    """JAX's train step jitted over a ``data`` mesh of ``devices`` CPU
    devices (GSPMD), the batch sharded on it."""
    mesh = Mesh(np.array(jax.devices()[:devices]), ("data",))
    state, optimizer = jax_state(jmodel, variables)
    state = jax.device_put(state, NamedSharding(mesh, P()))
    step = jax_steps.make_train_step(jmodel, optimizer, WEIGHTS, JaxFreeze(), NO_JITTER)
    data = NamedSharding(mesh, P("data"))
    state, logs = step(state, jax.device_put(jnp.asarray(x), data),
                       {k: jax.device_put(jnp.asarray(v), data)
                        for k, v in targets.items()}, jax.random.key(0))
    return jax_after(state, logs)


def jax_bars(run, grad_fn, variables, x, targets, halves=1):
    """(reference, its one-ulp run, gradients, gradient sensitivity) of a
    JAX step ``run(x)``; the gradient is the mean over ``halves`` equal
    row blocks (shard_map's averaged gradient)."""
    want, up = (reference(*run(v)) for v in (x, ulps(x)[0]))

    def grads(v):
        blocks = [({k: jnp.asarray(np.split(t, halves)[i]) for k, t in targets.items()},
                   jnp.asarray(h)) for i, h in enumerate(np.split(v, halves))]
        parts = [flat_grads(grad_fn(variables, h, th), variables) for th, h in blocks]
        return {k: sum(p[k] for p in parts) / halves for k in parts[0]}

    g, gu, gd = (grads(v) for v in (x, *ulps(x)))
    sens = {k: max(np.abs(g[k] - gu[k]).max(), np.abs(g[k] - gd[k]).max()) for k in g}
    return want, up, g, sens


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jmodel = JaxPointNet(num_classes=C, num_parts=PARTS, dropout_rate=0.0,
                         regularize_input_transform=True,
                         regularize_feature_transform=True)
    variables = jax_init(jmodel)
    state = state_dict_from_flax(variables)
    x4, t4 = batch4()
    x8, t8 = batch8()
    common = dict(family="pointnet", kwargs=POINTNET, state=state, learning=LEARNING,
                  loss_weights=WEIGHTS)
    inputs = {
        "sm_same": dict(common, mode="shard_map", rows="all", x=x4, targets=t4),
        "sm_distinct": dict(common, mode="shard_map", rows="split", x=x8, targets=t8),
        "global": dict(common, mode="global", rows="split", x=x4, targets=t4),
        "global_local": dict(common, mode="global", rows="local", x=x4, targets=t4),
        "eval": dict(common, mode="eval", rows="split", x=x8, targets=t8,
                     jitter=(0.01, 0.02, 0.03), seed=5),
    }
    work = str(tmp_path_factory.mktemp("parallel"))
    torch.save(inputs, os.path.join(work, "inputs.pt"))
    ranks = tpw.spawn(2, work, "steps")
    return {"jmodel": jmodel, "variables": variables, "state": state,
            "x4": (x4, t4), "x8": (x8, t8), "ranks": ranks,
            "grad_fn": jax_grad_fn(jmodel)}


def test_shardmap_identical_shards_equal_the_single_step_bit_for_bit(setup):
    x, t = setup["x4"]
    want = port_single(POINTNET, setup["state"], x, t)
    for res in setup["ranks"]:
        got = res["sm_same"]
        for key, value in want["logs"].items():
            # the losses are averaged over the replicas, the metric sums summed
            scale = 1 if key == "loss" or key.endswith("_loss") else 2
            assert np.array_equal(got["logs"][key], scale * value), key
        for name, value in {**want["params"], **want["stats"]}.items():
            assert np.array_equal(got["state"][name], value), name
        for name, value in want["grads"].items():
            assert np.array_equal(got["grads"][name], value), name


@pytest.mark.parametrize("case", ["sm_same", "sm_distinct", "global"])
def test_parameters_bit_identical_across_ranks(setup, case):
    a, b = (res[case] for res in setup["ranks"])
    assert set(a["state"]) == set(b["state"])
    for name in a["state"]:
        assert np.array_equal(a["state"][name], b["state"][name]), name
    for key in a["logs"]:
        assert np.array_equal(a["logs"][key], b["logs"][key]), key


@pytest.mark.parametrize("case", ["sm_same", "sm_distinct"])
def test_shardmap_within_jax_shardmap_bars(setup, case):
    if case == "sm_same":
        x, t = setup["x4"]
        x, t = np.concatenate([x, x]), {k: np.concatenate([v, v]) for k, v in t.items()}
    else:
        x, t = setup["x8"]
    jmodel, variables = setup["jmodel"], setup["variables"]
    want, up, grads, sens = jax_bars(
        lambda v: jax_shardmap(jmodel, variables, v, t), setup["grad_fn"],
        variables, x, t, halves=2)
    got = rank_result(setup["ranks"][0][case])
    faults = tpw.within_step_bars(got, want, up, grads, sens, LR, grad_factor=16)
    assert not faults, faults


def test_global_two_ranks_within_single_step_bars(setup):
    x, t = setup["x4"]
    want, up, sens = port_bars(POINTNET, setup["state"], x, t)
    got = rank_result(setup["ranks"][0]["global"])
    faults = tpw.within_step_bars(got, want, up, want["grads"], sens, LR)
    assert not faults, faults


def test_global_two_ranks_within_jax_gspmd_bars(setup):
    x, t = setup["x4"]
    jmodel, variables = setup["jmodel"], setup["variables"]
    want, up, grads, sens = jax_bars(
        lambda v: jax_gspmd(jmodel, variables, v, t), setup["grad_fn"],
        variables, x, t)
    got = rank_result(setup["ranks"][0]["global"])
    faults = tpw.within_step_bars(got, want, up, grads, sens, LR, grad_factor=16)
    assert not faults, faults


def test_own_rows_equal_the_split_rows(setup):
    """Each rank passing its own rows (``make_global_batch``) and the batch
    split by ``shard_batch`` give the same global step, bit for bit."""
    for res in setup["ranks"]:
        a, b = res["global_local"], res["global"]
        for key in a["logs"]:
            assert np.array_equal(a["logs"][key], b["logs"][key]), key
        for name in a["state"]:
            assert np.array_equal(a["state"][name], b["state"][name]), name


def test_eval_over_mesh_equals_single_device_eval(setup):
    x, t = setup["x8"]
    model = tpw._build("pointnet", POINTNET)
    model.load_state_dict(setup["state"])
    st, _ = steps.init_train_state(model, LearningConfig(*LEARNING), FreezeFlags())
    want = steps.make_eval_step(model, WEIGHTS, (0.01, 0.02, 0.03))(
        st, torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in t.items()}, 5)
    for res in setup["ranks"]:
        got = res["eval"]["logs"]
        assert set(got) == set(want)
        for key, value in want.items():
            np.testing.assert_allclose(got[key], value.numpy(), rtol=1e-6, err_msg=key)
