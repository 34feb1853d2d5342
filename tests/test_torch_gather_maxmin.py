"""The plain version of the port's neighbour max/min kernel against the JAX
package's ``gather_maxmin``: its Pallas lane kernel in interpret mode at the
shapes that kernel takes (n % 128 == 0, w <= 96), and its gather fallback at
the DGCNN widths above that. Max and min create no values, so the bar is
bit-identical; NaN propagates on both sides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudprocessing_tpu.ops.gather import gather_rows as jax_gather_rows
from pointcloudprocessing_tpu.ops.pallas.gather_maxmin import (
    gather_maxmin as jax_gather_maxmin,
)
from pointcloudprocessing_tpu_torch.ops.cuda.gather_maxmin import (
    gather_maxmin,
    gather_maxmin_reference,
)
from pointcloudprocessing_tpu_torch.ops.gather import gather_rows


def _case(b, n, w, k, seed, nan=False):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, n, w)).astype(np.float32)
    idx = rng.integers(0, n, (b, n, k)).astype(np.int32)
    if nan:
        q[0, 5, 1] = np.nan
        idx[0, :4, 0] = 5  # four rows see the NaN neighbour
    return q, idx


@pytest.mark.parametrize("b,n,w,k,nan", [
    (2, 128, 64, 20, False),
    (1, 256, 96, 20, False),
    (2, 128, 3, 8, True),
], ids=["w64", "w96-n256", "w3-nan"])
def test_matches_jax_lane_kernel(b, n, w, k, nan):
    q, idx = _case(b, n, w, k, seed=w, nan=nan)
    want = jax_gather_maxmin(jnp.asarray(q), jnp.asarray(idx), interpret=True)
    got = gather_maxmin(torch.from_numpy(q), torch.from_numpy(idx))
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))
    if nan:
        assert np.isnan(got[0].numpy()[0, :4, 1]).all()
        assert np.isnan(got[1].numpy()[0, :4, 1]).all()


@pytest.mark.parametrize("w", [128, 256])
def test_matches_jax_gather_fallback(w):
    """Above the lane kernel's width the JAX function gathers and reduces:
    the DGCNN layers 3 and 4 shapes, cut to 2 clouds of 256 points."""
    q, idx = _case(2, 256, w, 20, seed=w)
    want = jax_gather_maxmin(jnp.asarray(q), jnp.asarray(idx), allow_pallas=False)
    got = gather_maxmin_reference(torch.from_numpy(q), torch.from_numpy(idx))
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))


def test_gather_rows_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 40, 5)).astype(np.float32)
    idx = rng.integers(0, 40, (2, 7, 3)).astype(np.int32)
    want = np.asarray(jax_gather_rows(jnp.asarray(x), jnp.asarray(idx)))
    got = gather_rows(torch.from_numpy(x), torch.from_numpy(idx)).numpy()
    assert got.shape == (2, 7, 3, 5)
    np.testing.assert_array_equal(got, want)


def test_gather_form_slices_and_blocks():
    """The shared form takes the largest slice that fits and gives about a
    block an SM: at DGCNN's 64 clouds of 1,024 points, S 32 at every edge
    width (128 blocks at w 64) and at w 96; S 4 at w 3; S 8 at 16 clouds
    of w 64."""
    from pointcloudprocessing_tpu_torch.ops.cuda.gather_maxmin import (
        MIN_BLOCKS,
        gather_form,
    )

    assert MIN_BLOCKS == 128
    for w in (64, 128, 256, 96):
        assert gather_form(64, 1024, w) == ("shared", 32)
    assert gather_form(64, 1024, 3) == ("shared", 4)
    assert gather_form(16, 1024, 64) == ("shared", 8)
    # b x ceil(w / S) around the block count: 64 clouds x 2 slices of 32
    # reach it, 63 do not
    assert gather_form(63, 1024, 64) == ("shared", 16)
    # no slice gives enough blocks: the smallest that fits
    assert gather_form(1, 1024, 64) == ("shared", 4)


@pytest.mark.parametrize("s,n_max", [(32, 1816), (16, 3632), (8, 7264),
                                     (4, 14528)])
def test_gather_form_where_each_slice_stops_fitting(s, n_max):
    """n x S x 4 bytes within a block's 232,448: the largest n of each
    slice keeps it, one more point takes the next smaller slice (at w 256
    and 128 clouds, where every slice gives enough blocks), and past S 4
    the L2 form."""
    from pointcloudprocessing_tpu_torch.ops.cuda.gather_maxmin import (
        SHARED_BYTES,
        gather_form,
    )

    assert n_max * s * 4 <= SHARED_BYTES < (n_max + 1) * s * 4
    assert gather_form(128, n_max, 256) == ("shared", s)
    assert gather_form(128, n_max + 1, 256) == (
        ("shared", s // 2) if s > 4 else ("l2", 0))


def test_gather_form_refuses_empty_shapes():
    from pointcloudprocessing_tpu_torch.ops.cuda.gather_maxmin import gather_form

    for shape in ((0, 4, 4), (4, 0, 4), (4, 4, 0)):
        with pytest.raises(ValueError):
            gather_form(*shape)


def test_width_no_multiple_of_the_slice_matches_jax_lane_kernel():
    """w 40 at DGCNN's batch takes slices of 32 (one full, one of 8): the
    plain version against the lane kernel in interpret mode at that w."""
    from pointcloudprocessing_tpu_torch.ops.cuda.gather_maxmin import gather_form

    form, s = gather_form(64, 1024, 40)
    assert form == "shared" and 40 % s
    q, idx = _case(2, 128, 40, 20, seed=40, nan=True)
    want = jax_gather_maxmin(jnp.asarray(q), jnp.asarray(idx), interpret=True)
    got = gather_maxmin(torch.from_numpy(q), torch.from_numpy(idx))
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))


def test_cloud_past_the_shared_memory_matches_jax_gather_fallback():
    """A cloud of 14,529 points fits no slice (the L2 form): the plain
    version against the JAX function's gather fallback, k 1 and k 3."""
    from pointcloudprocessing_tpu_torch.ops.cuda.gather_maxmin import gather_form

    n = 14529
    assert gather_form(1, n, 8) == ("l2", 0)
    for k in (1, 3):
        q, idx = _case(1, n, 8, k, seed=k, nan=True)
        want = jax_gather_maxmin(jnp.asarray(q), jnp.asarray(idx),
                                 allow_pallas=False)
        got = gather_maxmin(torch.from_numpy(q), torch.from_numpy(idx))
        for g, wnt in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))


def test_no_silent_fallback_off_cpu():
    """Only a CPU tensor takes the plain version; any other device goes to
    the kernel or raises (here the meta device, which has no kernel)."""
    q = torch.zeros((1, 8, 4), device="meta")
    idx = torch.zeros((1, 8, 2), dtype=torch.int32, device="meta")
    before = gather_maxmin.launches
    with pytest.raises(ValueError, match="no gather-max/min kernel"):
        gather_maxmin(q, idx)
    assert gather_maxmin.launches == before
