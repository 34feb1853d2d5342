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
