"""Flax <-> PyTorch weight conversion of the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pointcloudprocessing_tpu.models.pointnet import PointNet as JaxPointNet
from pointcloudprocessing_tpu_torch.convert import (
    flax_from_state_dict,
    state_dict_from_flax,
)
from pointcloudprocessing_tpu_torch.models.pointnet import PointNet


def _flat(tree, prefix=()):
    for name, value in tree.items():
        if isinstance(value, dict):
            yield from _flat(value, prefix + (name,))
        else:
            yield prefix + (name,), value


@pytest.fixture(scope="module", params=[False, True], ids=["full", "vanilla"])
def variables(request):
    model = JaxPointNet(num_classes=23, num_parts=12, vanilla=request.param)
    init = model.init(jax.random.key(0), jnp.zeros((1, 32, 3)), train=False)
    tree = jax.tree_util.tree_map(
        np.asarray, {"params": init["params"], "batch_stats": init["batch_stats"]}
    )
    return request.param, tree


def test_round_trip_is_bit_identical(variables):
    _, tree = variables
    back = flax_from_state_dict(state_dict_from_flax(tree))
    want = dict(_flat(tree))
    got = dict(_flat(back))
    assert set(got) == set(want)
    for path, arr in want.items():
        assert got[path].dtype == arr.dtype, path
        np.testing.assert_array_equal(got[path], arr, err_msg="/".join(path))


def test_every_leaf_maps_both_ways(variables):
    """The converted state_dict names exactly the port model's tensors, with
    their shapes; every Flax leaf lands in exactly one entry."""
    vanilla, tree = variables
    sd = state_dict_from_flax(tree)
    assert len(sd) == len(list(_flat(tree)))
    want = PointNet(23, 12, vanilla=vanilla).state_dict()
    assert set(sd) == set(want)
    for key, tensor in want.items():
        assert sd[key].shape == tensor.shape, key
        assert sd[key].is_contiguous(), key
    # a Dense kernel (in, out) becomes weight (out, in)
    kernel = tree["params"]["mlp_2_3"]["conv"]["kernel"]
    np.testing.assert_array_equal(sd["mlp_2_3.conv.weight"].numpy(), kernel.T)


def test_unknown_names_are_rejected():
    with pytest.raises(KeyError, match="unmapped"):
        state_dict_from_flax({"params": {"x": {"gamma": np.ones(2)}}})
    import torch

    with pytest.raises(KeyError, match="unmapped"):
        flax_from_state_dict({"x.num_batches_tracked": torch.zeros(())})


def test_pointnet2_tree_round_trips_and_maps_every_leaf():
    """The canonical PointNet++ tree (89 leaves: kernel, bias, scale, mean,
    var) maps onto the port's model with no new rule, every leaf both ways,
    bit for bit."""
    from pointcloudprocessing_tpu.models.pointnet2 import pointnet2_for_width as jax_pn2
    from pointcloudprocessing_tpu_torch.models.pointnet2 import pointnet2_for_width

    init = jax_pn2(23, 12, 1024).init(
        jax.random.key(0), jnp.asarray(
            np.random.default_rng(0).normal(size=(1, 1024, 3)).astype(np.float32)),
        train=False)
    tree = jax.tree_util.tree_map(
        np.asarray, {"params": init["params"], "batch_stats": init["batch_stats"]})
    leaves = dict(_flat(tree))
    assert len(leaves) == 89
    assert sum(a.size for a in leaves.values()) == 2_037_859
    assert {path[-1] for path in leaves} == {"kernel", "bias", "scale", "mean", "var"}
    sd = state_dict_from_flax(tree)
    want = pointnet2_for_width(23, 12, 1024, device="cpu").state_dict()
    assert set(sd) == set(want) and len(sd) == len(leaves)
    for key, tensor in want.items():
        assert sd[key].shape == tensor.shape, key
    back = dict(_flat(flax_from_state_dict(sd)))
    assert set(back) == set(leaves)
    for path, arr in leaves.items():
        assert back[path].dtype == arr.dtype, path
        np.testing.assert_array_equal(back[path], arr, err_msg="/".join(path))
