"""FPS and the stride sampler of the port (plain versions; the CUDA kernel
is checked on the card by chip_smoke.py) against the JAX package.

Points lie on a dyadic grid (multiples of 1/32 in [-16, 16)): every squared
distance is then exact in f32, so ties are real and both sides must break
them to the lowest index. Indices must be identical and coordinates
bit-identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudprocessing_tpu.ops import fps as jax_fps
from pointcloudprocessing_tpu_torch.ops import fps as port_fps
from pointcloudprocessing_tpu_torch.ops.cuda.fps import (
    fps_with_points,
    fps_with_points_reference,
)

B, N = 4, 64


def _grid_points(rng, shape):
    return (rng.integers(-512, 512, shape) / 32).astype(np.float32)


def _masks(rng):
    """Cloud 0 all valid; 1 with holes; 2 fully invalid; 3 with holes and
    an invalid seed row."""
    mask = np.ones((B, N), bool)
    mask[1] = rng.uniform(size=N) > 0.3
    mask[2] = False
    mask[3] = rng.uniform(size=N) > 0.5
    mask[3, 0] = False
    return mask


@pytest.mark.parametrize("layout", ["bnc", "bcn"])
@pytest.mark.parametrize("k", [16, 1])
def test_plain_fps_matches_pallas_kernel(rng, layout, k):
    from pointcloudprocessing_tpu.ops.pallas.fps import fps_pallas_with_points

    pts = _grid_points(rng, (B, N, 3))
    pts[0, 5] = pts[0, 9]  # an exact duplicate: a real tie
    mask = _masks(rng)
    if layout == "bcn":
        pts = np.ascontiguousarray(pts.transpose(0, 2, 1))
    jstart = jax_fps._seed_indices(jnp.asarray(mask), 0)
    want_idx, want_pts = fps_pallas_with_points(
        jnp.asarray(pts), k, jnp.asarray(mask), jstart, layout=layout
    )
    tmask = torch.from_numpy(mask)
    start = port_fps._seed_indices(tmask, 0)
    np.testing.assert_array_equal(start.numpy(), np.asarray(jstart))
    idx, sampled = fps_with_points(
        torch.from_numpy(pts), k, tmask, start, layout=layout
    )
    assert idx.dtype == torch.int32 and sampled.shape == (B, k, 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(sampled.numpy(), np.asarray(want_pts))
    assert (idx.numpy()[2] == 0).all()  # all -inf scores pick index 0


@pytest.mark.parametrize("method", ["auto", "distmat", "stream"])
def test_fps_batch_methods_match_jax(rng, method):
    pts = _grid_points(rng, (B, N, 3))
    mask = _masks(rng)
    want = jax_fps.farthest_point_sample_batch(
        jnp.asarray(pts), 12, jnp.asarray(mask), start_index=3,
        method="distmat" if method == "auto" else method,
    )
    got = port_fps.farthest_point_sample_batch(
        torch.from_numpy(pts), 12, torch.from_numpy(mask), start_index=3,
        method=method,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("layout", ["bnc", "bcn"])
def test_fps_and_gather_matches_jax(rng, layout):
    pts = _grid_points(rng, (B, N, 3))
    mask = _masks(rng)
    if layout == "bcn":
        pts = np.ascontiguousarray(pts.transpose(0, 2, 1))
    want_idx, want_pts = jax_fps.farthest_point_sample_and_gather(
        jnp.asarray(pts), 16, jnp.asarray(mask), layout=layout
    )
    idx, sampled = port_fps.farthest_point_sample_and_gather(
        torch.from_numpy(pts), 16, torch.from_numpy(mask), layout=layout
    )
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(sampled.numpy(), np.asarray(want_pts))


@pytest.mark.parametrize("layout", ["bnc", "bcn"])
def test_stride_sampler_matches_jax(rng, layout):
    """Packed-first masks: nv >= k, nv < k (forward fill) and nv = 0."""
    k = 16
    pts = _grid_points(rng, (B, N, 3))
    nv = [N, 40, 5, 0]
    mask = np.arange(N)[None, :] < np.asarray(nv)[:, None]
    if layout == "bcn":
        pts = np.ascontiguousarray(pts.transpose(0, 2, 1))
    want_idx, want_pts = jax_fps.stride_sample_and_gather(
        jnp.asarray(pts), k, jnp.asarray(mask), layout=layout
    )
    idx, sampled = port_fps.stride_sample_and_gather(
        torch.from_numpy(pts), k, torch.from_numpy(mask), layout=layout
    )
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(sampled.numpy(), np.asarray(want_pts))
    # with 5 valid rows of 16 buckets the skipped buckets repeat picks
    assert set(idx.numpy()[2]) == set(range(5))


def test_reference_coordinates_are_the_picked_rows(rng):
    pts = torch.from_numpy(_grid_points(rng, (B, N, 3)))
    mask = torch.from_numpy(_masks(rng))
    start = port_fps._seed_indices(mask, 0)
    idx, sampled = fps_with_points_reference(pts, 8, mask, start)
    assert torch.equal(sampled, pts.gather(1, idx.long()[..., None].expand(-1, -1, 3)))


def test_no_silent_fallback_off_cpu():
    pts = torch.zeros((1, 8, 3), device="meta")
    mask = torch.ones((1, 8), dtype=torch.bool, device="meta")
    start = torch.zeros((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no FPS kernel"):
        fps_with_points(pts, 4, mask, start)
    assert fps_with_points.launches == 0
