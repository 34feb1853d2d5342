"""Segment sum of the port (plain version; the CUDA kernel is checked on the
card by chip_smoke.py) against the JAX package's banded Pallas kernel."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


def test_no_silent_fallback_off_cpu():
    """Only a CPU tensor takes the plain version; any other device goes to
    the kernel or raises (here the meta device, which has no kernel)."""
    data = torch.zeros((1, 8, 4), device="meta")
    rank = torch.zeros((1, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no segment-sum kernel"):
        sorted_segment_reduce(data, rank)
    assert sorted_segment_reduce.launches == 0


def test_reference_is_scatter_add():
    data = torch.arange(12, dtype=torch.float32).reshape(1, 3, 4)
    rank = torch.tensor([[0, 0, 2]], dtype=torch.int32)
    out = sorted_segment_reduce_reference(data, rank)
    assert out[0, 0].tolist() == [4.0, 6.0, 8.0, 10.0]
    assert out[0, 1].tolist() == [0.0] * 4
    assert out[0, 2].tolist() == [8.0, 9.0, 10.0, 11.0]
