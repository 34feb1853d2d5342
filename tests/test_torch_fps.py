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


#: where a NaN coordinate goes: (cloud, row, coordinate); cloud 1's seed is
#: its first valid row (row None)
NAN_AT = {"valid row": (0, 5, 1), "invalid row": (3, 0, 0), "seed row": (1, None, 2)}


@pytest.mark.parametrize("nan", [None, *NAN_AT])
@pytest.mark.parametrize("layout", ["bnc", "bcn"])
@pytest.mark.parametrize("k", [16, 1])
def test_plain_fps_matches_pallas_kernel(rng, layout, k, nan):
    """Picks and coordinates equal to the JAX Pallas kernel's (interpret
    mode), also with a NaN coordinate: in a valid row it wins the next pick
    and then every distance is NaN, so the first valid row wins each pick
    after it (``jnp.minimum`` and ``jnp.argmax`` propagate NaN); in an
    invalid row it is never picked; in the seed row every distance is NaN
    from the first step."""
    from pointcloudprocessing_tpu.ops.pallas.fps import fps_pallas_with_points

    pts = _grid_points(rng, (B, N, 3))
    pts[0, 5] = pts[0, 9]  # an exact duplicate: a real tie
    mask = _masks(rng)
    seed_1 = int(np.argmax(mask[1]))
    if nan is not None:
        c, row, coord = NAN_AT[nan]
        pts[c, seed_1 if row is None else row, coord] = np.nan
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
    if nan == "valid row":
        assert idx.numpy()[0, :3].tolist() == [0, 5, 0][:k]
        assert (idx.numpy()[0, 2:] == 0).all()
    elif nan == "invalid row":
        assert 0 not in idx.numpy()[3]
    elif nan == "seed row":
        assert (idx.numpy()[1] == seed_1).all()


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


def test_plain_fps_past_the_shared_memory_form_matches_jax_stream(rng):
    """One cloud of 16,385 points, the first n that takes the device-memory
    kernel on the card: the plain version, which the card holds that
    kernel to, against the JAX package's streaming FPS."""
    n, k = 16385, 16
    pts = _grid_points(rng, (1, n, 3))
    mask = rng.uniform(size=(1, n)) > 0.25
    want = jax_fps.farthest_point_sample_batch(
        jnp.asarray(pts), k, jnp.asarray(mask), start_index=0, method="stream")
    tmask = torch.from_numpy(mask)
    idx, sampled = fps_with_points(torch.from_numpy(pts), k, tmask,
                                   port_fps._seed_indices(tmask, 0))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want))
    np.testing.assert_array_equal(sampled.numpy()[0], pts[0, idx.numpy()[0]])


def test_kernel_form_rule():
    """The crossover of the two FPS kernels: planes in shared memory up to
    16,384 points, device memory above; no n >= 1 is refused."""
    from pointcloudprocessing_tpu_torch.ops.cuda.fps import (
        SHARED_MAX_POINTS,
        kernel_form,
    )

    assert SHARED_MAX_POINTS == 16384
    assert [kernel_form(n) for n in (1, 2048, 16384)] == ["shared"] * 3
    assert [kernel_form(n) for n in (16385, 65536, 10**7)] == ["global"] * 3
    with pytest.raises(ValueError, match="at least one point"):
        kernel_form(0)


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
