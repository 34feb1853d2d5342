"""Voxel downsampling and Morton keys of the port against the JAX package
(plain segment sum on the CPU; the CUDA kernel is checked on the card by
chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudprocessing_tpu.ops import voxel as jax_voxel
from pointcloudprocessing_tpu_torch.ops import voxel as port_voxel


def _scans(rng, b=3, n=256):
    """Dense enough that many voxels hold several points; cloud 1 has holes,
    cloud 2 only a handful of valid points."""
    pts = rng.uniform(-3, 3, (b, n, 3)).astype(np.float32)
    mask = np.ones((b, n), bool)
    mask[1] = rng.uniform(size=n) > 0.4
    mask[2] = False
    mask[2, rng.choice(n, 7, replace=False)] = True
    return pts, mask


@pytest.mark.parametrize("reduction", ["centroid", "first"])
@pytest.mark.parametrize("layout", ["bnc", "bcn"])
def test_voxel_downsample_matches_jax(rng, reduction, layout):
    pts, mask = _scans(rng)
    want, want_mask = jax_voxel.voxel_downsample_batch(
        jnp.asarray(pts), 0.5, jnp.asarray(mask), reduction=reduction,
        layout=layout,
    )
    got, got_mask = port_voxel.voxel_downsample_batch(
        torch.from_numpy(pts), 0.5, torch.from_numpy(mask),
        reduction=reduction, layout=layout,
    )
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    counts = got_mask.numpy().sum(1)
    assert (counts > 0).all() and (counts <= mask.sum(1)).all()
    assert counts[0] < mask[0].sum()  # voxels did merge points
    # row-for-row agreement, which also pins the Morton order; sums are
    # taken in another order, so centroids agree to f32 rounding
    np.testing.assert_allclose(
        got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6
    )
    if reduction == "first":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_voxel_downsample_unmasked_and_single_cloud(rng):
    pts = rng.uniform(-2, 2, (64, 3)).astype(np.float32)
    want, want_mask = jax_voxel.voxel_downsample(jnp.asarray(pts), 0.5)
    got, got_mask = port_voxel.voxel_downsample(torch.from_numpy(pts), 0.5)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_morton_keys_match_jax(rng):
    from pointcloudprocessing_tpu.ops.morton import morton_keys_3d as jax_keys
    from pointcloudprocessing_tpu_torch.ops.morton import morton_keys_3d

    xyz = rng.integers(-5, 40000, (3, 500)).astype(np.int32)
    want = jax_keys(*(jnp.asarray(a) for a in xyz))
    got = morton_keys_3d(*(torch.from_numpy(a) for a in xyz))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_normalize_matches_jax(rng):
    from pointcloudprocessing_tpu.ops.normalize import normalize_unit_sphere as jn
    from pointcloudprocessing_tpu_torch.ops.normalize import normalize_unit_sphere

    pts = (rng.normal(size=(2, 50, 3)) * 7).astype(np.float32)
    pts[1] = 0.0  # degenerate cloud: the 1e-7 scale floor
    (want, (wc, ws)) = jn(jnp.asarray(pts))
    got, (gc, gs) = normalize_unit_sphere(torch.from_numpy(pts))
    for g, w in ((got, want), (gc, wc), (gs, ws)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
