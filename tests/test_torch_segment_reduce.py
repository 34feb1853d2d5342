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


@pytest.mark.parametrize("ranks", ["any order", "one segment"])
def test_plain_segment_sum_past_the_shared_memory_form(ranks):
    """n 40,000, the device-memory form of the kernel on the card: the plain
    version, which the card holds the kernel to bit for bit, against
    ``jax.ops.segment_sum``, bit for bit (both add in row order)."""
    n = 40000
    assert voxel_reduce.segment_sum_form(n) == "global"
    rng = np.random.default_rng(40000)
    data = (rng.normal(size=(2, n, D)) * 30).astype(np.float32)
    if ranks == "any order":
        rank = rng.integers(0, n, (2, n)).astype(np.int32)
    else:
        rank = np.full((2, n), n - 1, np.int32)
    got = voxel_reduce.segment_reduce_reference(torch.from_numpy(data),
                                                torch.from_numpy(rank))
    np.testing.assert_array_equal(got.numpy(), _jax_segment_sum(data, rank))


def test_segment_sum_form_rule():
    """The any-rank kernel's working set: shared memory up to 5,120 rows a
    cloud, a device-memory scratch above, up to 2^30 rows (wider than the
    former limit of 65,535 tiles of 128 rows)."""
    assert [voxel_reduce.segment_sum_form(n) for n in (1, 2000, 5120)] == [
        "shared"] * 3
    assert [voxel_reduce.segment_sum_form(n) for n in (5121, 40000, 2**30)] == [
        "global"] * 3
    assert voxel_reduce.MAX_ROWS >= 65535 * 128
    for n in (0, 2**30 + 1):
        with pytest.raises(ValueError, match="rows a cloud"):
            voxel_reduce.segment_sum_form(n)


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


def test_no_silent_fallback_off_cpu():
    """Only a CPU tensor takes the plain version; any other device goes to
    the kernel or raises (here the meta device, which has no kernel)."""
    data = torch.zeros((1, 200, 4), device="meta")
    rank = torch.zeros((1, 200), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no segment-sum kernel"):
        voxel_reduce.segment_reduce(data, rank)
    with pytest.raises(ValueError, match="no segment-sum kernel"):
        voxel_reduce.monotone_segment_sum(data, rank)
    assert voxel_reduce.segment_reduce.launches == 0


@pytest.mark.parametrize("n", [490, 2000])
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


@pytest.mark.parametrize("n", [490, 2000])
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
