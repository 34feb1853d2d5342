"""The port's device-side random rotations and fixed-width resampling
against the JAX package on the CPU.

The random streams differ (JAX keys against a ``torch.Generator``), so the
draw and the construction are apart in the port, and the construction is
fed the numbers JAX's keys draw:

- ``so3_from_normals`` on the normals ``random_so3_rotation``'s key draws:
  within 1e-6 + 8 cond(A) 2^-24 of JAX's rotations, matrix by matrix, and
  within 4 cond(A) 2^-24 of the same construction in float64; each a proper
  rotation (det +1, QᵀQ = I). An f32 QR's error grows with the gaussian
  matrix's condition number: on 10,000 draws both XLA's and the port's sit
  within 3.5 cond(A) 2^-24 of float64 and within 4.3 cond(A) 2^-24 of
  each other (1.03e-6 apart on one matrix of condition 35 here), so a flat
  1e-6 would be a bar on the QR's rounding, not on the construction.
- ``resample_indices`` on the uniforms ``adjust_to_input_width`` (and the
  batch form's split keys) draw: identical rows, with ``valid_count`` 0,
  below the width, equal to it and above it, and buffers narrower than the
  width.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudprocessing_tpu_torch.ops import augment, resample

jax_augment = importlib.import_module("pointcloudprocessing_tpu.ops.augment")
jax_resample = importlib.import_module("pointcloudprocessing_tpu.ops.resample")


@pytest.mark.parametrize("batch_shape", [(), (64,), (4, 5)])
def test_so3_construction_matches_jax(batch_shape):
    key = jax.random.key(11)
    normals = np.array(jax.random.normal(key, (*batch_shape, 3, 3), jnp.float32))
    want = np.asarray(jax_augment.random_so3_rotation(key, batch_shape))
    got = augment.so3_from_normals(torch.from_numpy(normals)).numpy()
    exact = augment.so3_from_normals(torch.from_numpy(normals.astype(np.float64))).numpy()
    assert got.shape == want.shape == (*batch_shape, 3, 3) and got.dtype == np.float32
    rounding = np.linalg.cond(normals.astype(np.float64))[..., None, None] * 2.0**-24
    assert (np.abs(got - exact) <= 4 * rounding).all()
    assert (np.abs(got - want) <= 1e-6 + 8 * rounding).all()
    np.testing.assert_allclose(np.linalg.det(got), 1.0, atol=1e-5)
    eye = np.broadcast_to(np.eye(3), got.shape)
    np.testing.assert_allclose(np.swapaxes(got, -1, -2) @ got, eye, atol=1e-5)


def test_random_so3_rotation_from_a_generator():
    g = torch.Generator().manual_seed(3)
    got = augment.random_so3_rotation(g, (4096,), device="cpu")
    again = augment.random_so3_rotation(torch.Generator().manual_seed(3), (4096,),
                                        device="cpu")
    assert got.shape == (4096, 3, 3) and got.dtype == torch.float32
    assert torch.equal(got, again)
    np.testing.assert_allclose(torch.linalg.det(got).numpy(), 1.0, atol=1e-5)
    # Haar-uniform: each entry has mean 0 and variance 1/3 (4-5 sigma bars)
    assert abs(got.mean().item()) < 0.02
    assert abs(got.square().mean().item() - 1 / 3) < 0.02
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        augment.random_so3_rotation(g)


def index_buffers(max_n: int):
    """Rows whose values are their own index, and labels to match."""
    points = np.repeat(np.arange(max_n, dtype=np.float32)[:, None], 3, axis=1)
    points[:, 1] += 0.5
    return points, np.arange(max_n, dtype=np.int32) * 7


@pytest.mark.parametrize("max_n,width,count", [
    (100, 64, 0), (100, 64, 10), (100, 64, 63), (100, 64, 64), (100, 64, 90),
    (40, 64, 40), (40, 64, 17), (64, 64, 64), (1, 8, 1)])
def test_single_resample_matches_jax(max_n, width, count):
    key = jax.random.key(max_n * 1000 + width + count)
    uniforms = np.array(jax.random.uniform(key, (width,)))
    points, labels = index_buffers(max_n)
    want_p, want_l = jax_resample.adjust_to_input_width(
        jnp.asarray(points), jnp.asarray(labels), jnp.int32(count), width, key)
    rows = resample.resample_indices(torch.from_numpy(uniforms),
                                     torch.tensor(count, dtype=torch.int32), max_n)
    assert rows.shape == (width,)
    assert np.array_equal(points[rows.numpy()], np.asarray(want_p))
    assert np.array_equal(labels[rows.numpy()], np.asarray(want_l))
    keep = min(count, width)
    assert np.array_equal(rows.numpy()[:keep], np.arange(keep))
    if 0 < count < width:
        assert rows.numpy()[count:].max() < count


def test_batch_resample_matches_jax():
    b, max_n, width = 6, 50, 64
    counts = np.array([0, 1, 20, 50, 49, 33], np.int32)
    key = jax.random.key(5)
    uniforms = np.array(jax.vmap(lambda k: jax.random.uniform(k, (width,)))(
        jax.random.split(key, b)))
    points, labels = index_buffers(max_n)
    points = np.stack([points + 1000 * i for i in range(b)])
    labels = np.stack([labels + 1000 * i for i in range(b)])
    want_p, want_l = jax_resample.adjust_batch_to_input_width(
        jnp.asarray(points), jnp.asarray(labels), jnp.asarray(counts), width, key)
    rows = resample.resample_indices(torch.from_numpy(uniforms),
                                     torch.from_numpy(counts), max_n).numpy()
    got_p = np.take_along_axis(points, rows[..., None], axis=1)
    assert np.array_equal(got_p, np.asarray(want_p))
    assert np.array_equal(np.take_along_axis(labels, rows, axis=1), np.asarray(want_l))


def test_device_resample_draws_from_its_generator():
    """The port's entry points are the index rule on the generator's
    uniforms, one batched gather for a batch."""
    b, max_n, width = 3, 30, 48
    points, labels = index_buffers(max_n)
    tp = torch.from_numpy(np.stack([points] * b))
    tl = torch.from_numpy(np.stack([labels] * b))
    counts = torch.tensor([5, 30, 12])
    got_p, got_l = resample.adjust_batch_to_input_width(
        tp, tl, counts, width, torch.Generator().manual_seed(9))
    u = torch.rand((b, width), generator=torch.Generator().manual_seed(9))
    rows = resample.resample_indices(u, counts, max_n)
    assert torch.equal(got_p, torch.stack([tp[i, rows[i]] for i in range(b)]))
    assert torch.equal(got_l, torch.stack([tl[i, rows[i]] for i in range(b)]))
    one_p, one_l = resample.adjust_to_input_width(
        tp[0], tl[0], 5, width, torch.Generator().manual_seed(9))
    u = torch.rand((width,), generator=torch.Generator().manual_seed(9))
    rows = resample.resample_indices(u, torch.tensor(5), max_n)
    assert torch.equal(one_p, tp[0, rows]) and torch.equal(one_l, tl[0, rows])
    assert one_p.shape == (width, 3) and int(rows.max()) < 5
