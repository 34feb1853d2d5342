"""The any-rank segment sum of the port (plain version; the CUDA kernel is
checked on the card by chip_smoke.py) against the JAX package's dense
Pallas kernel and ``jax.ops.segment_sum``, and the shape rule that sends a
monotone segment sum to it, n by n against the JAX package's own."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudprocessing_tpu_torch.ops.cuda import voxel_reduce

D = 4


def _any_order_case(n: int, seed: int):
    """Ranks in any order over [0, n), data at 30x magnitude (the JAX
    test's scene scale, tests/test_preprocess_ops.py:243-260)."""
    rng = np.random.default_rng(seed)
    data = (rng.normal(size=(3, n, D)) * 30).astype(np.float32)
    rank = rng.integers(0, n, (3, n)).astype(np.int32)
    return data, rank


def _jax_segment_sum(data, rank):
    n = data.shape[1]
    return np.asarray(jax.vmap(
        lambda d, r: jax.ops.segment_sum(d, r, num_segments=n)
    )(jnp.asarray(data), jnp.asarray(rank)))


@pytest.mark.parametrize("n", [64, 200])
def test_matches_jax_dense_kernel(n):
    """Against ``segment_reduce_pallas`` in interpret mode, to its bf16 hi/lo
    contract: 2^-16 of the 30x magnitude per row, over a segment of up to 8
    rows (the JAX test's own bound)."""
    from pointcloudprocessing_tpu.ops.pallas.voxel_reduce import segment_reduce_pallas

    data, rank = _any_order_case(n, n)
    assert max(np.bincount(r).max() for r in rank) <= 8
    want = np.asarray(segment_reduce_pallas(jnp.asarray(data), jnp.asarray(rank)))
    got = voxel_reduce.segment_reduce(torch.from_numpy(data), torch.from_numpy(rank))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=30 * 2.0**-16 * 8)


@pytest.mark.parametrize("n", [64, 200])
def test_matches_jax_segment_sum_bit_for_bit(n):
    """``jax.ops.segment_sum`` on the CPU and the port's plain version both
    add each segment's rows in row order from 0: bit-identical, as the
    CUDA kernel is held to the plain version on the card."""
    data, rank = _any_order_case(n, n + 1)
    want = _jax_segment_sum(data, rank)
    got = voxel_reduce.segment_reduce_reference(torch.from_numpy(data),
                                                torch.from_numpy(rank))
    np.testing.assert_array_equal(got.numpy(), want)
    # and row order is the order: the sums of a segment's rows in order
    b, i = 1, int(np.argmax(np.bincount(rank[1])))
    acc = np.zeros(D, np.float32)
    for row in np.flatnonzero(rank[b] == i):
        acc = acc + data[b, row]
    np.testing.assert_array_equal(got.numpy()[b, i], acc)


@pytest.mark.parametrize("n, form", [(40000, "cluster"), (40961, "global")])
@pytest.mark.parametrize("ranks", ["any order", "one segment"])
def test_plain_segment_sum_past_the_shared_memory_form(ranks, n, form):
    """n 40,000 (the cluster form of the kernel on the card) and 40,961 (the
    global form): the plain version, which the card holds the kernel to bit
    for bit, against ``jax.ops.segment_sum``, bit for bit (both add in row
    order)."""
    assert voxel_reduce.segment_sum_form(4, n)[0] == form
    rng = np.random.default_rng(n)
    data = (rng.normal(size=(2, n, D)) * 30).astype(np.float32)
    if ranks == "any order":
        rank = rng.integers(0, n, (2, n)).astype(np.int32)
    else:
        rank = np.full((2, n), n - 1, np.int32)
    got = voxel_reduce.segment_reduce_reference(torch.from_numpy(data),
                                                torch.from_numpy(rank))
    np.testing.assert_array_equal(got.numpy(), _jax_segment_sum(data, rank))


def test_segment_sum_form_rule():
    """Kernel 3's forms by b and n: one block in shared memory up to 5,120
    rows a cloud; up to 40,960, a cluster of C blocks, C a power of two up
    to 8, the largest of which C blocks hold a cloud (at most 5,120 rows a
    block) and one wave holds b clusters (66, 30 and 15 clusters of 2, 4
    and 8 blocks on the H100), else the smallest that holds a cloud; tiles
    of 2,048 rows (and a device-memory scratch) above, up to 2^30 rows
    (wider than the former limit of 65,535 tiles of 128 rows)."""
    vr = voxel_reduce
    form = vr.segment_sum_form
    assert vr.CLUSTERS_A_WAVE == {2: 66, 4: 30, 8: 15}
    assert [form(b, n) for b in (1, 16, 256) for n in (1, 2000, 5120)] == [
        ("shared", 1)] * 9
    assert [form(b, 5121) for b in (1, 15, 16, 30, 31, 66, 67)] == [
        ("cluster", 8), ("cluster", 8), ("cluster", 4), ("cluster", 4),
        ("cluster", 2), ("cluster", 2), ("cluster", 2)]
    assert [form(256, n) for n in (5121, 10240, 10241, 20480, 20481, 40960)] == [
        ("cluster", 2), ("cluster", 2), ("cluster", 4), ("cluster", 4),
        ("cluster", 8), ("cluster", 8)]
    assert [form(b, 8000) for b in (4, 8, 20, 64, 256)] == [
        ("cluster", 8), ("cluster", 8), ("cluster", 4), ("cluster", 2),
        ("cluster", 2)]
    assert [form(b, 40000) for b in (4, 16)] == [("cluster", 8), ("cluster", 8)]
    assert [form(b, n) for b, n in ((1, 40961), (256, 65537), (4, 2**30))] == [
        ("global", 21), ("global", 33), ("global", 2**19)]
    assert vr.CLUSTER_MAX_ROWS == vr.CLUSTER_BLOCKS * vr.SHARED_MAX_ROWS == 40960
    # no block holds more rows than the shared form
    for b in (1, 4, 8, 20, 64, 66, 67, 256, 4096):
        for n in (1, 31, 2000, 5120, 5121, 8000, 40953, 40960, 40961):
            kind, blocks = form(b, n)
            rows = vr.segment_block_rows(n, (kind, blocks))
            assert 1 <= blocks <= (vr.CLUSTER_BLOCKS if kind != "global" else n)
            assert rows <= vr.SHARED_MAX_ROWS and blocks * rows >= n
            assert (kind == "shared") == (blocks == 1)
    assert vr.MAX_ROWS >= 65535 * 128
    for n in (0, 2**30 + 1):
        with pytest.raises(ValueError, match="rows a cloud"):
            form(1, n)
    with pytest.raises(ValueError, match="at least one cloud"):
        form(0, 200)


@pytest.mark.parametrize("n, ints", [
    (1, 0), (5120, 0), (5121, 0), (40960, 0), (40961, 35 * 40961 + 21),
    (65536, 35 * 65536 + 32), (65537, 35 * 65537 + 33)])
def test_scratch_size_rule(n, ints):
    """The scratch the wrapper allocates a cloud: none in the shared and
    cluster forms; 35 int32 a row and a flag a tile in the global form."""
    assert voxel_reduce.segment_scratch_ints(n) == ints


def _plan_ranks(kind: str, n: int, rng) -> np.ndarray:
    if kind == "random":
        return rng.integers(0, n, n)
    if kind == "sorted":
        return np.sort(rng.integers(0, n, n))
    if kind == "one segment":
        return np.full(n, n - 1)
    if kind == "zero-padded":  # valid rows in voxels, the rest one run
        nv = n * 3 // 5
        rank = np.full(n, n - 1)
        rank[:nv] = np.sort(rng.integers(0, nv, nv))
        return rank
    return np.sort(rng.integers(0, n // 4, n)) * 4  # three quarters empty


@pytest.mark.parametrize("b, n", [(256, 200), (4, 200), (256, 5120),
                                  (64, 5121), (8, 8000), (4, 40961)])
@pytest.mark.parametrize("kind", ["random", "sorted", "one segment",
                                  "zero-padded", "three quarters empty"])
def test_segment_walk_plan_writes_every_row_once(kind, b, n):
    """Kernel 3's plan: every output row is written exactly once, an empty
    one as zeros and a segment by the thread or warp the rule names; a
    thread sums at most SHORT_WALK rows unless its warp's long segments are
    too many to share; a long run of ranks in order goes to a warp of the
    block holding its head."""
    vr = voxel_reduce
    rng = np.random.default_rng(n)
    rank = _plan_ranks(kind, n, rng)
    plan = vr.segment_walk_plan(rank, b)
    assert sorted(w[0] for w in plan) == list(range(n))
    counts = np.bincount(rank, minlength=n)
    form = vr.segment_sum_form(b, n)
    blocks, m = form[1], vr.segment_block_rows(n, form)
    in_order = bool((np.diff(rank) >= 0).all())
    runs = form[0] != "shared" and in_order
    for row, kind_, block, who in plan:
        assert 0 <= block < blocks
        assert (kind_ == "zero") == (counts[row] == 0)
        if kind_ == "warp":
            assert counts[row] > vr.SHORT_WALK and 0 <= who < vr.SEG_THREADS // 32
        elif kind_ == "thread":
            assert 0 <= who < vr.SEG_THREADS
            if runs:
                assert counts[row] <= vr.SHORT_WALK
        if runs and kind_ != "zero":  # the block of the run's head
            assert block == int(np.argmax(rank == row)) // m
        elif not runs:  # the block owning the segment
            assert block == (row // m if form[0] == "cluster" else 0)
    warps = [w for w in plan if w[1] == "warp"]
    if kind in ("one segment", "zero-padded"):
        assert len(warps) == 1 and counts[warps[0][0]] == counts.max()
    if kind == "random":
        assert not warps


def test_empty_segments_nan_and_one_segment():
    """Empty segments are 0; a NaN row makes its own segment NaN and no
    other; all rows in one segment sum in row order."""
    data = np.random.default_rng(2).normal(size=(2, 50, 3)).astype(np.float32)
    rank = np.zeros((2, 50), np.int32)
    rank[1] = np.arange(50)[::-1] // 5 * 5  # every fifth segment, decreasing
    data[1, 7, 2] = np.nan
    got = voxel_reduce.segment_reduce(torch.from_numpy(data),
                                      torch.from_numpy(rank)).numpy()
    np.testing.assert_array_equal(got, _jax_segment_sum(data, rank))
    assert (got[0, 1:] == 0).all()
    nan_rows = np.flatnonzero(np.isnan(got[1]).any(-1))
    assert nan_rows.tolist() == [rank[1, 7]]
    assert np.isnan(got[1, rank[1, 7]]).tolist() == [False, False, True]
    assert (got[1][np.arange(50) % 5 != 0] == 0).all()


def test_route_matches_the_jax_package():
    """``sorted_segment_reduce_pallas`` hands exactly the n that 128 does
    not divide to ``segment_reduce_pallas`` (counted through a monkeypatch
    of the JAX module, in interpret mode); the port's route sends the same
    n to its any-rank kernel, through ``monotone_segment_sum`` itself."""
    from pointcloudprocessing_tpu.ops.pallas import voxel_reduce as jax_vr

    widths = (64, 128, 200, 384, 490, 2000, 2048)
    real = jax_vr.segment_reduce_pallas
    jax_dense, port_dense = [], []

    def counting(data, rank, *args, **kwargs):
        jax_dense.append(data.shape[1])
        return real(data, rank, *args, **kwargs)

    port_real = voxel_reduce.segment_reduce

    def port_any(data, rank):
        port_dense.append(data.shape[1])
        return port_real(data, rank)

    jax_vr.segment_reduce_pallas = counting
    voxel_reduce.segment_reduce = port_any
    try:
        for n in widths:
            rank = np.sort(np.random.default_rng(n).integers(0, n, (1, n)),
                           axis=1).astype(np.int32)
            data = np.ones((1, n, D), np.float32)
            want = np.asarray(jax_vr.sorted_segment_reduce_pallas(
                jnp.asarray(data), jnp.asarray(rank)))
            got = voxel_reduce.monotone_segment_sum(torch.from_numpy(data),
                                                    torch.from_numpy(rank))
            np.testing.assert_array_equal(got.numpy(), want)  # counts: exact
    finally:
        jax_vr.segment_reduce_pallas = real
        voxel_reduce.segment_reduce = port_real
    assert jax_dense == [64, 200, 490, 2000]
    assert port_dense == jax_dense


@pytest.mark.parametrize("n", [490, 2000, 5121, 8000])
@pytest.mark.parametrize("reduction", ["centroid", "first"])
def test_voxel_downsample_at_widths_that_do_not_tile(n, reduction):
    """The voxel downsample at n % 128 != 0 (the JAX package takes
    ``jax.ops.segment_sum`` on the CPU there, ops/voxel.py:167-172): masks
    identical, centroids to f32 rounding, 'first' exact."""
    from pointcloudprocessing_tpu.ops import voxel as jax_voxel
    from pointcloudprocessing_tpu_torch.ops import voxel as port_voxel

    rng = np.random.default_rng(n)
    pts = rng.uniform(-20, 20, (2, n, 3)).astype(np.float32)
    mask = np.ones((2, n), bool)
    mask[1, n // 3:] = False
    want, want_mask = jax_voxel.voxel_downsample_batch(
        jnp.asarray(pts), 4.0, jnp.asarray(mask), reduction=reduction)
    got, got_mask = port_voxel.voxel_downsample_batch(
        torch.from_numpy(pts), 4.0, torch.from_numpy(mask), reduction=reduction)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    assert got_mask.numpy().sum(1)[0] < n  # voxels did merge points
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    if reduction == "first":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [490, 2000, 5121, 8000])
def test_stride_sampler_at_widths_that_do_not_tile(n):
    from pointcloudprocessing_tpu.ops import fps as jax_fps
    from pointcloudprocessing_tpu_torch.ops import fps as port_fps

    rng = np.random.default_rng(n + 7)
    pts = rng.uniform(-20, 20, (2, n, 3)).astype(np.float32)
    mask = np.arange(n)[None, :] < np.array([[n], [n // 4]])
    want_idx, want = jax_fps.stride_sample_and_gather(
        jnp.asarray(pts), 256, jnp.asarray(mask))
    got_idx, got = port_fps.stride_sample_and_gather(
        torch.from_numpy(pts), 256, torch.from_numpy(mask))
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
