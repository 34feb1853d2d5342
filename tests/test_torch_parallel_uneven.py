"""The global train step on 3 gloo ranks and a batch of 4 (row shares 1,
1, 2): the uneven split that stands in for the JAX plan's points axis.

For PointNet (the full model, ``tests/test_torch_train_step.py``'s batch),
DGCNN and PointNet++ (``tests/test_torch_train_families.py``'s TINY
models and batch): within the bars of the port's single-device step on
the whole batch (8x its one-ulp sensitivity), and parameters bit-identical
across the ranks. PointNet also within the bars of the JAX package's
step for this plan: with 3 devices and a batch of 4 its
``_parallel_plan`` finds no mesh and runs the single-device step (16x on
gradients). DGCNN's and PointNet++'s single-device steps are held to
JAX's by ``tests/test_torch_train_families.py``.
"""

import os

import numpy as np
import pytest
import torch

import torch_parallel_worker as tpw
from pointcloudprocessing_tpu.models.pointnet import PointNet as JaxPointNet
from pointcloudprocessing_tpu_torch.convert import state_dict_from_flax
from test_torch_parallel import (
    LR,
    POINTNET,
    jax_bars,
    jax_gspmd,
    jax_grad_fn,
    jax_init,
    port_bars,
    rank_result,
)
from test_torch_parallel_families import KWARGS, family_variables
from test_torch_train_families import _batch
from test_torch_train_step import batch as batch4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def pointnet_pair():
    jmodel = JaxPointNet(num_classes=5, num_parts=3, dropout_rate=0.0,
                         regularize_input_transform=True,
                         regularize_feature_transform=True)
    return jmodel, jax_init(jmodel)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    common = dict(mode="global", rows="split", learning=(LR, 7, 0.7),
                  loss_weights=(1.0, 1.0, 0.1))
    x4, t4 = batch4()
    inputs = {"pointnet": dict(common, family="pointnet", kwargs=POINTNET, x=x4,
                               targets=t4,
                               state=state_dict_from_flax(pointnet_pair()[1]))}
    x, t = _batch()
    for family in KWARGS:
        inputs[family] = dict(common, family=family, kwargs=KWARGS[family], x=x,
                              targets=t,
                              state=state_dict_from_flax(family_variables(family)[1]))
    work = str(tmp_path_factory.mktemp("uneven"))
    torch.save(inputs, os.path.join(work, "inputs.pt"))
    return inputs, tpw.spawn(3, work, "steps")


FAMILIES = ["pointnet", "dgcnn", "pointnet2"]


@pytest.mark.parametrize("family", FAMILIES)
def test_rows_one_one_two_and_ranks_bit_identical(ranks, family):
    inputs, results = ranks
    shares = [res[family]["logs"]["classification_total"] for res in results]
    assert all(float(s) == 4.0 for s in shares)  # the logs are global sums
    first = results[0][family]["state"]
    for res in results[1:]:
        for name, value in res[family]["state"].items():
            assert np.array_equal(value, first[name]), name
    assert [res[family]["rows"] for res in results] == [1, 1, 2]


@pytest.mark.parametrize("family", FAMILIES)
def test_uneven_global_within_single_step_bars(ranks, family):
    inputs, results = ranks
    sc = inputs[family]
    want, up, sens = port_bars(sc["kwargs"], sc["state"], sc["x"], sc["targets"], family)
    for res in results:
        faults = tpw.within_step_bars(rank_result(res[family]), want, up,
                                      want["grads"], sens, LR)
        assert not faults, faults


def test_uneven_pointnet_within_jax_plan_bars(ranks):
    """The JAX plan for 3 devices and a batch of 4 takes no mesh: its step
    is the single-device one (a 1-device mesh here)."""
    inputs, results = ranks
    sc = inputs["pointnet"]
    jmodel, variables = pointnet_pair()
    want, up, grads, sens = jax_bars(
        lambda v: jax_gspmd(jmodel, variables, v, sc["targets"], devices=1),
        jax_grad_fn(jmodel), variables, sc["x"], sc["targets"])
    faults = tpw.within_step_bars(rank_result(results[0]["pointnet"]), want, up,
                                  grads, sens, LR, grad_factor=16)
    assert not faults, faults
