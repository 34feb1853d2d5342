"""FPS and the stride sampler of the port (plain versions; the CUDA kernel
is checked on the card by chip_smoke.py) against the JAX package, the FPS
kernel's shape rule, and the premise of its exact pruning.

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
from pointcloudprocessing_tpu.ops import voxel as jax_voxel
from pointcloudprocessing_tpu_torch.ops import fps as port_fps
from pointcloudprocessing_tpu_torch.ops.cuda.fps import (
    BLOCK_MAX_POINTS,
    CLUSTER_MAX_POINTS,
    MAX_CLUSTER,
    fps_with_points,
    fps_with_points_reference,
    kernel_form,
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


@pytest.mark.parametrize("n", [16385, BLOCK_MAX_POINTS + 1, CLUSTER_MAX_POINTS + 1])
def test_plain_fps_past_the_shared_memory_form_matches_jax_stream(rng, n):
    """One cloud past a kernel form's reach (the first n of the cluster form,
    and of the device-memory form): the plain version, which the card holds
    those kernels to, against the JAX package's streaming FPS."""
    k = 16
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
    """The FPS kernels' reach: one block up to 8,192 points a cloud, a
    cluster of up to 8 blocks up to 65,536, device memory above; no n >= 1
    is refused."""
    assert (BLOCK_MAX_POINTS, MAX_CLUSTER, CLUSTER_MAX_POINTS) == (8192, 8, 65536)
    assert kernel_form(256, 2048) == ("block", 1)
    with pytest.raises(ValueError, match="at least one point"):
        kernel_form(1, 0)


@pytest.mark.parametrize(
    "b, n, form",
    [
        (256, 1, ("block", 1)),
        (1, BLOCK_MAX_POINTS, ("block", 1)),
        (256, BLOCK_MAX_POINTS, ("block", 1)),
        # a small batch: 8 blocks a cloud, one wave of 132 SMs
        (1, BLOCK_MAX_POINTS + 1, ("cluster", 8)),
        (4, 16384, ("cluster", 8)),
        (16, 16385, ("cluster", 8)),
        # a larger batch: the fewest blocks that hold a cloud
        (17, 16385, ("cluster", 3)),
        (64, 16384, ("cluster", 2)),
        (64, 16385, ("cluster", 3)),
        (64, CLUSTER_MAX_POINTS, ("cluster", 8)),
        (4, CLUSTER_MAX_POINTS, ("cluster", 8)),
        (4, CLUSTER_MAX_POINTS + 1, ("global", 1)),
        (1, 10**7, ("global", 1)),
    ],
)
def test_kernel_form_boundaries(b, n, form):
    """The shape rule at each form's edges, small against large b; every
    cluster holds the cloud (at most 8,192 points a block)."""
    assert kernel_form(b, n) == form
    if form[0] == "cluster":
        assert 2 <= form[1] <= MAX_CLUSTER
        assert -(-n // form[1]) <= BLOCK_MAX_POINTS


def test_reference_coordinates_are_the_picked_rows(rng):
    pts = torch.from_numpy(_grid_points(rng, (B, N, 3)))
    mask = torch.from_numpy(_masks(rng))
    start = port_fps._seed_indices(mask, 0)
    idx, sampled = fps_with_points_reference(pts, 8, mask, start)
    assert torch.equal(sampled, pts.gather(1, idx.long()[..., None].expand(-1, -1, 3)))


def _scans(rng, kind: str, b: int, n: int) -> np.ndarray:
    """Scans as chip_smoke.py draws them: 'uniform' in [-20, 20) (nearly a
    voxel a point at 0.4) or 'dense' (LiDAR-like: range log-uniform in
    [1, 40] m, elevation within 15 degrees of the horizon)."""
    if kind == "dense":
        r = np.exp(rng.uniform(0.0, np.log(40.0), (b, n)))
        az = rng.uniform(-np.pi, np.pi, (b, n))
        el = rng.uniform(-np.pi / 12, np.pi / 12, (b, n))
        return np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                         r * np.sin(el)], axis=-1).astype(np.float32)
    return rng.uniform(-20, 20, (b, n, 3)).astype(np.float32)


@pytest.mark.parametrize("kind", ["uniform", "dense"])
def test_plain_fps_matches_pallas_kernel_on_voxel_output(rng, kind):
    """The path's own input: the JAX package's voxel output (valid rows
    packed first, Morton order) of scans at 0.4, in the bcn layout the
    serving path hands FPS, with a short cloud (fewer valid rows than k):
    picks and coordinates equal to the Pallas kernel's (interpret mode)."""
    from pointcloudprocessing_tpu.ops.pallas.fps import fps_pallas_with_points

    b, n, k = 3, 256, 64
    scans = _scans(rng, kind, b, n)
    # the short cloud: 40 distinct voxels
    scans[2] = (rng.integers(0, 40, n)[:, None] * 2.0 + 0.1).astype(np.float32)
    vox, vmask = jax_voxel.voxel_downsample_batch(jnp.asarray(scans), 0.4, layout="bcn")
    vox, vmask = np.array(vox), np.array(vmask)
    nv = vmask.sum(axis=1)
    assert nv[2] == 40 < k and nv[0] > k
    assert (vmask == (np.arange(n)[None, :] < nv[:, None])).all()  # packed
    jstart = jax_fps._seed_indices(jnp.asarray(vmask), 0)
    want_idx, want_pts = fps_pallas_with_points(
        jnp.asarray(vox), k, jnp.asarray(vmask), jstart, layout="bcn")
    tmask = torch.from_numpy(vmask)
    idx, sampled = fps_with_points(torch.from_numpy(vox), k, tmask,
                                   port_fps._seed_indices(tmask, 0), layout="bcn")
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(sampled.numpy(), np.asarray(want_pts))
    assert (idx.numpy()[2] < 40).all()  # picks repeat, never an invalid row


# The CUDA kernel's pruning test (csrc/fps.cu), in torch f32 on the CPU with
# its operations in the kernel's order: a warp skips its update when the
# bound from its run's bounding box (fminf/fmaxf, so NaN coordinates are
# left out) to the new centre is >= the run's largest running min.

def _box(tile: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi) of (..., m, 3) points over m, NaN left out (fminf/fmaxf)."""
    nan = tile.isnan()
    lo = torch.where(nan, torch.inf, tile).amin(dim=-2)
    hi = torch.where(nan, -torch.inf, tile).amax(dim=-2)
    return lo, hi


def _box_bound(lo: torch.Tensor, hi: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """gap = max.NaN(max.NaN(lo - c, c - hi), 0) an axis; the bound is
    (gx*gx + gy*gy) + gz*gz, each operation rounded."""
    g = torch.maximum(torch.maximum(lo - c, c - hi), torch.zeros((), dtype=c.dtype))
    sq = g * g
    return (sq[..., 0] + sq[..., 1]) + sq[..., 2]


def _sq_dist(p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    d = p - c
    sq = d * d
    return (sq[..., 0] + sq[..., 1]) + sq[..., 2]


def _special_tiles(rng, kinds=("morton", "tiny", "zeros", "huge", "inf", "nan")) -> torch.Tensor:
    """(tiles, 32, 3) f32: Morton-ordered voxel output cut into runs of 32
    rows, and runs of +-0, subnormals, huge coordinates whose squares
    overflow, infinities and a NaN row."""
    vox, vmask = jax_voxel.voxel_downsample_batch(
        jnp.asarray(_scans(rng, "uniform", 2, 512)), 0.4)
    vox, vmask = np.asarray(vox), np.asarray(vmask)
    inf = rng.uniform(-1, 1, (2, 32, 3)).astype(np.float32)
    inf[0, 3, 0], inf[1, 7, 2] = np.inf, -np.inf
    nan = vox[0, :32][None].copy()
    nan[0, 5, 1] = np.nan
    made = {
        "morton": [vox[c, : vmask[c].sum() // 32 * 32].reshape(-1, 32, 3) for c in range(2)],
        "tiny": [np.float32(1e-45) * rng.integers(-8, 9, (4, 32, 3))],
        "zeros": [np.where(rng.uniform(size=(2, 32, 3)) < 0.5, np.float32(0.0),
                           np.float32(-0.0))],
        "huge": [np.float32(3e38) * rng.choice([-1.0, -0.5, 0.5, 1.0], (4, 32, 3))],
        "inf": [inf],
        "nan": [nan],
    }
    return torch.from_numpy(np.concatenate(
        [t for kind in kinds for t in made[kind]]).astype(np.float32))


def test_pruning_bound_is_below_every_rounded_distance(rng):
    """Rounding is monotone, so the box bound is <= the rounded distance of
    every point of the box; where a point's distance is NaN (a NaN
    coordinate, or inf - inf) with the centre on the box's infinite edge,
    the bound is NaN too; a NaN bound never lets a run skip."""
    tiles = _special_tiles(rng)
    pts = tiles.reshape(-1, 3)
    centres = torch.cat([
        pts[torch.from_numpy(rng.integers(0, len(pts), 200))],
        torch.tensor([[0.0, -0.0, 0.0], [1e-45, -1e-45, 0.0], [3e38, -3e38, 1.0],
                      [np.inf, 0.0, 0.0], [-np.inf, 1.0, 2.0], [np.nan, 0.0, 0.0],
                      [20.0, -20.0, 5.0]], dtype=torch.float32),
    ])
    lo, hi = _box(tiles)  # (tiles, 3)
    bound = _box_bound(lo[None], hi[None], centres[:, None])  # (centres, tiles)
    d = _sq_dist(tiles[None], centres[:, None, None])  # (centres, tiles, 32)
    coord_nan = tiles.isnan().any(dim=-1)[None].expand_as(d)
    below = (bound[..., None] <= d) | bound[..., None].isnan()
    assert below[~d.isnan()].all()
    # a NaN distance from non-NaN coordinates comes with a NaN bound
    assert bound[..., None].expand_as(d)[d.isnan() & ~coord_nan].isnan().all()
    assert (bound == 0).any() and (bound > 0).any() and bound.isnan().any()


@pytest.mark.parametrize("kinds", [("morton",), ("tiny", "zeros", "huge", "inf"),
                                   ("morton", "nan")])
def test_pruning_never_changes_a_running_min_or_skips_a_nan_run(rng, kinds):
    """The skip rule in an FPS run over one cloud of such runs: from the
    second step on, a run with bound >= its largest running min keeps every
    running min bit for bit under the update it skips, and a run that holds
    a NaN coordinate is never skipped (its running min is NaN from the first
    step on; once a NaN row is picked every distance is NaN). On the voxel
    output alone runs do skip."""
    tiles = _special_tiles(rng, kinds)
    pts = tiles.reshape(-1, 3)
    lo, hi = _box(tiles)
    has_nan = tiles.isnan().any(dim=-1).any(dim=-1)
    md = torch.full(pts.shape[:1], torch.inf)
    cur, skipped = 0, 0
    for s in range(1, 96):
        c = pts[cur]
        new = torch.minimum(md, _sq_dist(pts, c))  # NaN-propagating, as min.NaN
        if s > 1:
            bits = md.view(len(tiles), 32).view(torch.int32)
            run_max = md.view(len(tiles), 32).amax(dim=1)  # NaN if any is
            skip = _box_bound(lo, hi, c) >= run_max
            assert not (skip & has_nan).any()
            same = new.view(len(tiles), 32).view(torch.int32) == bits
            assert same[skip].all()
            skipped += int(skip.sum())
        md = new
        cur = int(md.argmax())
    assert skipped > 0 or kinds != ("morton",)


@pytest.mark.parametrize("layout", ["bnc", "bcn"])
@pytest.mark.parametrize("chains", [2, 4])
def test_blocked_fps_matches_jax(rng, layout, chains):
    """``chains=``: JAX's stripe reshape, one FPS call over b * chains
    clouds; indices identical and coordinates bit-identical to JAX's
    ``_blocked_fps_and_gather`` (grid points, masks with holes)."""
    pts = _grid_points(rng, (B, N, 3))
    mask = _masks(rng)
    mask[2] = True  # blocked FPS wants valid rows in every stripe
    if layout == "bcn":
        pts = np.ascontiguousarray(pts.transpose(0, 2, 1))
    want_idx, want_pts = jax_fps.farthest_point_sample_and_gather(
        jnp.asarray(pts), 16, jnp.asarray(mask), chains=chains, layout=layout)
    calls = []
    real = port_fps.fps_with_points

    def counting(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    port_fps.fps_with_points = counting
    try:
        idx, sampled = port_fps.farthest_point_sample_and_gather(
            torch.from_numpy(pts), 16, torch.from_numpy(mask), chains=chains,
            layout=layout)
    finally:
        port_fps.fps_with_points = real
    assert calls == [(B * chains, N // chains, 3)]  # one call over b * chains clouds
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(sampled.numpy(), np.asarray(want_pts))
    assert (idx.numpy() % chains == np.arange(16)[None, :] // (16 // chains)).all()


def test_blocked_fps_refuses_chains_that_do_not_divide():
    with pytest.raises(ValueError, match="dividing both"):
        port_fps.farthest_point_sample_and_gather(torch.zeros(1, 10, 3), 4, chains=4)
    with pytest.raises(ValueError, match="dividing both"):
        port_fps.farthest_point_sample_and_gather(torch.zeros(1, 16, 3), 6, chains=4)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("method", ["auto", "distmat", "stream"])
def test_single_cloud_fps_matches_jax(rng, masked, method):
    pts = _grid_points(rng, (N, 3))
    mask = rng.uniform(size=N) > 0.4 if masked else None
    want = jax_fps.farthest_point_sample(
        jnp.asarray(pts), 20, None if mask is None else jnp.asarray(mask),
        start_index=2, method="distmat" if method == "auto" else method)
    got = port_fps.farthest_point_sample(
        torch.from_numpy(pts), 20, None if mask is None else torch.from_numpy(mask),
        start_index=2, method=method)
    assert got.shape == (20,) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("budget_offset,form", [(0, "distmat"), (-1, "stream")])
def test_max_distmat_bytes_rule_at_its_edge(rng, monkeypatch, budget_offset, form):
    """'auto' on the CPU takes the distance matrix while b * n * n * 4 bytes
    fit ``max_distmat_bytes`` and the stream form one byte under it, as the
    JAX package's rule; the default budget stays 2 GiB."""
    pts = torch.from_numpy(_grid_points(rng, (B, N, 3)))
    taken = []
    monkeypatch.setattr(port_fps, "_distmat_fps",
                        lambda *a: taken.append("distmat") or torch.zeros(B, 8, dtype=torch.int32))
    monkeypatch.setattr(port_fps, "fps_with_points_reference",
                        lambda *a: taken.append("stream") or (torch.zeros(B, 8, dtype=torch.int32),) * 2)
    port_fps.farthest_point_sample_batch(
        pts, 8, max_distmat_bytes=B * N * N * 4 + budget_offset)
    assert taken == [form]
    assert port_fps._DEFAULT_DISTMAT_BYTES == jax_fps._DEFAULT_DISTMAT_BYTES == 2 * 1024**3
