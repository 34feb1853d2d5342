"""Segment sum of the port (plain version; the CUDA kernel is checked on the
card by chip_smoke.py) against the JAX package's banded Pallas kernel."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudprocessing_tpu_torch.ops.cuda import voxel_reduce
from pointcloudprocessing_tpu_torch.ops.cuda.voxel_reduce import (
    sorted_segment_reduce,
    sorted_segment_reduce_reference,
)

B, N, D = 2, 512, 4


def _monotone_case(rng):
    """The shapes and rank construction of
    test_preprocess_ops.py::test_sorted_segment_reduce_banded_matches_dense:
    sorted skewed draws, plus one segment spanning half the rows."""
    data = (rng.normal(size=(B, N, D)) * 30).astype(np.float32)
    raw = np.sort(rng.integers(0, N // 3, (B, N)), axis=1)
    raw[1, : N // 2] = 0
    return data, raw.astype(np.int32)


def test_matches_jax_banded_kernel(rng):
    from pointcloudprocessing_tpu.ops.pallas.voxel_reduce import (
        sorted_segment_reduce_pallas,
    )

    data, rank = _monotone_case(rng)
    want = np.asarray(sorted_segment_reduce_pallas(
        jnp.asarray(data), jnp.asarray(rank), k_tile=64, chunk=128
    ))
    got = sorted_segment_reduce(
        torch.from_numpy(data), torch.from_numpy(rank)
    ).numpy()
    # the reference splits f32 data into bf16 hi + lo: ~2^-16 relative per
    # row, summed over the longest segment
    max_segment_len = max(np.bincount(r).max() for r in rank)
    np.testing.assert_allclose(
        got, want, rtol=0, atol=30 * 2.0**-16 * max_segment_len
    )


def test_matches_float64_sum(rng):
    """On data of the 1/32 grid every partial sum is exact in f32, so the
    plain version must equal the fp64 sum to rtol 1e-6; empty segments are
    zero."""
    data, rank = _monotone_case(rng)
    data = (np.round(data * 32) / 32).astype(np.float32)
    want = np.zeros((B, N, D), np.float64)
    for b in range(B):
        np.add.at(want[b], rank[b], data[b].astype(np.float64))
    got = sorted_segment_reduce(
        torch.from_numpy(data), torch.from_numpy(rank)
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got.dtype == np.float32


def test_reference_is_scatter_add():
    data = torch.arange(12, dtype=torch.float32).reshape(1, 3, 4)
    rank = torch.tensor([[0, 0, 2]], dtype=torch.int32)
    out = sorted_segment_reduce_reference(data, rank)
    assert out[0, 0].tolist() == [4.0, 6.0, 8.0, 10.0]
    assert out[0, 1].tolist() == [0.0] * 4
    assert out[0, 2].tolist() == [8.0, 9.0, 10.0, 11.0]


# ------------------------------------------------ kernel 1's ownership plan

def _voxel_like(n, rng):
    """Runs of 1-5 rows, the invalid quarter parked in bucket n - 1."""
    nv = n - n // 4
    rank = np.full(n, n - 1)
    rank[:nv] = np.cumsum(rng.uniform(size=nv) < 0.6) - 1
    rank[0] = 0
    return np.maximum.accumulate(rank)


RANKS = {
    "runs crossing tiles": lambda n, rng: np.minimum(np.arange(n) // 700 * 3, n - 1),
    "one run of n rows": lambda n, rng: np.zeros(n, np.int64),
    "skips many buckets": lambda n, rng: np.minimum(np.arange(n) // 3 * 50 + 17, n - 1),
    "runs at the short limit": lambda n, rng: np.minimum(np.repeat(
        np.arange(n) * 2, np.tile([voxel_reduce.SHORT_RUN,
                                   voxel_reduce.SHORT_RUN + 1], n)[:n])[:n],
        n - 1),
    "voxel-like": _voxel_like,
}


def _kernel_order_sum(data, rank):
    """Kernel 1's sums for one cloud, in its order of adds, following
    sorted_sum_plan: a thread's run 0.0f + its rows in row order; a block's
    run by thread t over rows head + t + j WALK_THREADS in order of j, then
    the warps' xor-shuffle trees and their totals in warp order. Returns the
    output and each row's count of writes."""
    n, d = data.shape
    threads = voxel_reduce.WALK_THREADS
    out = np.full((n, d), np.nan, np.float32)
    writes = np.zeros(n, np.int64)
    for row, kind, _, lo, hi in voxel_reduce.sorted_sum_plan(rank):
        writes[row] += 1
        if kind == "zero":
            out[row] = 0.0
        elif kind == "thread":
            acc = np.zeros(d, np.float32)
            for p in range(lo, hi):
                acc = acc + data[p]
            out[row] = acc
        else:
            acc = np.zeros((threads, d), np.float32)
            for p0 in range(lo, hi, threads):
                t = np.arange(min(threads, hi - p0))
                acc[t] = acc[t] + data[p0 + t]
            warps = acc.reshape(threads // 32, 32, d)
            for off in (16, 8, 4, 2, 1):
                warps = warps + warps[:, np.arange(32) ^ off]
            total = warps[0, 0].copy()
            for w in range(1, threads // 32):
                total = total + warps[w, 0]
            out[row] = total
    return out, writes


@pytest.mark.parametrize("n", [1, 257, 2048])
@pytest.mark.parametrize("kind", sorted(RANKS))
def test_sorted_sum_plan_writes_every_row_once(kind, n):
    """Every output row is written exactly once, zeros included; every run
    has one owner, its head's tile, and the walker its length says."""
    rank = RANKS[kind](n, np.random.default_rng(n))
    assert (np.diff(rank) >= 0).all() and 0 <= rank.min() and rank.max() < n
    plan = voxel_reduce.sorted_sum_plan(rank)
    rows = sorted(row for row, *_ in plan)
    assert rows == list(range(n))
    runs = [(row, kind, tile, lo, hi) for row, kind, tile, lo, hi in plan
            if kind != "zero"]
    assert sorted(r for r, *_ in runs) == sorted(set(rank.tolist()))
    covered = np.zeros(n, np.int64)
    for row, kind, tile, lo, hi in runs:
        covered[lo:hi] += 1
        assert (rank[lo:hi] == row).all()
        assert tile == lo // voxel_reduce.TILE_ROWS
        assert kind == ("thread" if hi - lo <= voxel_reduce.SHORT_RUN else "block")
    assert (covered == 1).all()
    for row, kind, tile, lo, _ in plan:
        if kind == "zero":
            assert row not in set(rank.tolist())
            assert tile == lo // voxel_reduce.TILE_ROWS


def test_sorted_sum_plan_shapes():
    """The edges the kernel's launch mirrors: one tile up to 1,024 rows
    (two clouds of 2,048 rows a wave of 512 blocks at 256 clouds), a run of
    33 rows walked by the block, one of 32 by its thread, a run crossing a
    tile owned by its head's tile only."""
    assert voxel_reduce.TILE_ROWS == 4 * voxel_reduce.WALK_THREADS == 1024
    assert [voxel_reduce.sorted_sum_tiles(n) for n in (1, 1024, 1025, 2048)] == [
        1, 1, 2, 2]
    rank = np.concatenate([np.zeros(32), np.ones(33), np.full(1200, 2),
                           np.full(783, 2047)]).astype(np.int64)
    plan = {row: (kind, tile, lo, hi)
            for row, kind, tile, lo, hi in voxel_reduce.sorted_sum_plan(rank)}
    assert plan[0] == ("thread", 0, 0, 32)
    assert plan[1] == ("block", 0, 32, 65)
    assert plan[2] == ("block", 0, 65, 1265)
    assert plan[2047] == ("block", 1, 1265, 2048)
    assert plan[3] == ("zero", 1, 1265, 1265)


@pytest.mark.parametrize("kind", sorted(RANKS))
def test_kernel_order_matches_plain_version(kind):
    """The kernel's order of adds (emulated from the plan) against the plain
    version: short runs bit for bit, long runs within chip_smoke.py's bar,
    at 2 clouds of 2,048 rows."""
    rng = np.random.default_rng(7)
    n, d = 2048, 5
    data = (rng.normal(size=(2, n, d)) * 30).astype(np.float32)
    for c in range(2):
        rank = RANKS[kind](n, rng)
        want = sorted_segment_reduce_reference(
            torch.from_numpy(data[c][None]),
            torch.from_numpy(rank.astype(np.int32)[None]))[0].numpy()
        got, writes = _kernel_order_sum(data[c], rank)
        assert (writes == 1).all()
        short = np.zeros(n, bool)
        for row, kind_, *_ in voxel_reduce.sorted_sum_plan(rank):
            short[row] = kind_ != "block"
        np.testing.assert_array_equal(got[short], want[short])
        bar = 1e-5 * np.abs(data[c]).max() + 1e-6 * np.abs(want)
        assert (np.abs(got - want) <= bar).all()


@pytest.mark.parametrize("kind", sorted(RANKS))
def test_plain_version_matches_jax_banded_kernel_on_plan_ranks(kind):
    """The plain version against the banded Pallas kernel on the plan's
    ranks, at 512 rows and one row."""
    from pointcloudprocessing_tpu.ops.pallas.voxel_reduce import (
        sorted_segment_reduce_pallas,
    )

    rng = np.random.default_rng(11)
    for n in (512, 1):
        rank = RANKS[kind](n, rng).astype(np.int32)[None]
        data = (rng.normal(size=(1, n, 4)) * 30).astype(np.float32)
        want = np.asarray(sorted_segment_reduce_pallas(
            jnp.asarray(data), jnp.asarray(rank), k_tile=64, chunk=128))
        got = sorted_segment_reduce(torch.from_numpy(data),
                                    torch.from_numpy(rank)).numpy()
        longest = max(np.bincount(r).max() for r in rank)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=30 * 2.0**-16 * longest)
