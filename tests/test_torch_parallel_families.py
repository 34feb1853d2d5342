"""The global (GSPMD counterpart) train step of DGCNN and PointNet++ on a
2-rank gloo group, against the port's single-device step on the whole
batch and the JAX package's GSPMD step over 2 virtual CPU devices.

TINY sizes as ``tests/test_torch_train_families.py``: DGCNN k 8, edges
(8, 16), embedding 32; PointNet++ for 64 points; 4 clouds of 64 points,
weights converted from randomized Flax variables, dropout 0 and jitter 0.
Bars (``torch_parallel_worker.within_step_bars``): 8x the port's own
one-ulp sensitivity; against JAX, 16x on gradients. DGCNN is held to
JAX's f32 GSPMD step; PointNet++ to JAX's GSPMD step in float64 with the
sensitivities of its f32 step (JAX's own f32 set-abstraction statistics
are ~1e-4 from its float64 result at this size, as that file says).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as tpw
from pointcloudprocessing_tpu_torch.convert import state_dict_from_flax
from test_torch_parallel import (
    LR,
    flat_grads,
    jax_bars,
    jax_grad_fn,
    jax_gspmd,
    port_bars,
    rank_result,
    reference,
)
from test_torch_pointnet import randomize
from test_torch_train_families import DGCNN_TINY, _batch, _models

C, PARTS, N = 5, 4, 64
KWARGS = {
    "dgcnn": dict(num_classes=C, num_parts=PARTS, dropout_rate=0.0, **DGCNN_TINY),
    "pointnet2": dict(num_classes=C, num_parts=PARTS, input_width=N, dropout_rate=0.0),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def family_variables(family):
    jmodel, _ = _models(family)
    init = jax.jit(lambda r, x: jmodel.init(r, x, train=False))(
        jax.random.key(0), jnp.zeros((1, N, 3)))
    return jmodel, randomize({"params": init["params"],
                              "batch_stats": init["batch_stats"]}, 3)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    x, t = _batch()
    inputs = {}
    for family in KWARGS:
        _, variables = family_variables(family)
        inputs[family] = dict(family=family, kwargs=KWARGS[family], mode="global",
                              rows="split", state=state_dict_from_flax(variables),
                              learning=(LR, 7, 0.7), loss_weights=(1.0, 1.0, 0.1),
                              x=x, targets=t)
    work = str(tmp_path_factory.mktemp("families"))
    torch.save(inputs, os.path.join(work, "inputs.pt"))
    return inputs, tpw.spawn(2, work, "steps")


@pytest.mark.parametrize("family", list(KWARGS))
def test_ranks_bit_identical(ranks, family):
    a, b = (res[family] for res in ranks[1])
    for name in a["state"]:
        assert np.array_equal(a["state"][name], b["state"][name]), name


@pytest.mark.parametrize("family", list(KWARGS))
def test_global_within_single_step_bars(ranks, family):
    inputs, results = ranks
    sc = inputs[family]
    want, up, sens = port_bars(sc["kwargs"], sc["state"], sc["x"], sc["targets"], family)
    faults = tpw.within_step_bars(rank_result(results[0][family]), want, up,
                                  want["grads"], sens, LR)
    assert not faults, faults


def jax_f64_bars(jmodel, variables, x, t):
    """(float64 GSPMD step and gradients; the f32 step, its one-ulp run and
    its gradient sensitivity)."""
    grad_fn = jax_grad_fn(jmodel)
    base, up, _, sens = jax_bars(lambda v: jax_gspmd(jmodel, variables, v, t),
                                 grad_fn, variables, x, t)
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        want = reference(*jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32),
            jax_gspmd(jmodel, v64, x.astype(np.float64), t)))
        g64 = grad_fn(v64, jnp.asarray(x, jnp.float64),
                      {k: jnp.asarray(v) for k, v in t.items()})
        grads = {k: np.asarray(g, np.float32)
                 for k, g in flat_grads(g64, variables).items()}
    return want, base, up, grads, sens


@pytest.mark.parametrize("family", list(KWARGS))
def test_global_within_jax_gspmd_bars(ranks, family):
    inputs, results = ranks
    sc = inputs[family]
    jmodel, variables = family_variables(family)
    x, t = sc["x"], sc["targets"]
    if family == "pointnet2":
        want, base, up, grads, sens = jax_f64_bars(jmodel, variables, x, t)
    else:
        want, up, grads, sens = jax_bars(lambda v: jax_gspmd(jmodel, variables, v, t),
                                         jax_grad_fn(jmodel), variables, x, t)
        base = want
    faults = tpw.within_step_bars(rank_result(results[0][family]), want, up, grads,
                                  sens, LR, grad_factor=16, base=base)
    assert not faults, faults
