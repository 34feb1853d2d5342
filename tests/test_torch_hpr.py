"""The port's hidden-point removal against the JAX package on the CPU.

- ``hidden_point_removal`` (float64 numpy and Qhull on both sides): the
  same indices on a sphere and on the procedural KC-46-like mesh.
- ``_octahedral_bins``: identical cells on random and axis-aligned
  directions (the fold's edges).
- ``hidden_point_removal_mask``: equal masks on the cases of
  ``tests/test_preprocess_ops.py`` (a sphere, a batch with a valid mask and
  garbage rows, a single cloud, a (3,) camera for a batch), on duplicate
  points (exact depth ties) and on a mesh sample.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudprocessing_tpu.synthesis.procedural import kc46_like_mesh
from pointcloudprocessing_tpu.synthesis.mesh import sample_points_uniformly
from pointcloudprocessing_tpu_torch.ops import hpr

jax_hpr = importlib.import_module("pointcloudprocessing_tpu.ops.hpr")
# jitted, as the JAX package's callers run it (eager, its scan dispatches
# every step on its own)
jax_mask = jax.jit(jax_hpr.hidden_point_removal_mask, static_argnames=("grid", "tol"))


def sphere(n: int, seed: int) -> np.ndarray:
    v = np.random.default_rng(seed).normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def kc46_points(n: int = 4000) -> np.ndarray:
    mesh, _ = kc46_like_mesh()
    return sample_points_uniformly(mesh, n, np.random.default_rng(3))


@pytest.mark.parametrize("case", ["sphere", "kc46"])
def test_hull_indices_identical(case):
    points = sphere(2000, 0) if case == "sphere" else kc46_points()
    for camera in (np.array([10.0, 0.0, 0.0]), np.array([-4.0, 30.0, 6.5])):
        got = hpr.hidden_point_removal(points, camera)
        want = jax_hpr.hidden_point_removal(points, camera)
        assert np.array_equal(got, want) and 0 < len(got) < len(points)
    got = hpr.hidden_point_removal(points, camera, radius=500.0)
    assert np.array_equal(got, jax_hpr.hidden_point_removal(points, camera, radius=500.0))


def test_spherical_flip():
    points = kc46_points(500).astype(np.float32)
    camera = np.array([10.0, -3.0, 2.0], np.float32)
    got = hpr.spherical_flip(torch.from_numpy(points), torch.from_numpy(camera), 300.0)
    want = jax_hpr.spherical_flip(jnp.asarray(points), jnp.asarray(camera), 300.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("grid", [8, 64])
def test_octahedral_bins_identical(grid):
    v = np.random.default_rng(1).normal(size=(4096, 3)).astype(np.float32)
    axes = np.concatenate([np.eye(3), -np.eye(3), [[1, 1, 0], [-1, 0, -1],
                                                   [0, -1, -1], [0, 0, 0]]])
    d = np.concatenate([v / np.linalg.norm(v, axis=1, keepdims=True),
                        axes.astype(np.float32)])
    got = hpr._octahedral_bins(torch.from_numpy(d), grid)
    want = np.asarray(jax_hpr._octahedral_bins(jnp.asarray(d), grid))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert got.min() >= 0 and got.max() < grid * grid


def mask_pair(points, camera, valid=None, **kw):
    got = hpr.hidden_point_removal_mask(
        torch.from_numpy(points), torch.from_numpy(camera),
        None if valid is None else torch.from_numpy(valid), **kw)
    want = np.asarray(jax_mask(
        jnp.asarray(points), jnp.asarray(camera),
        None if valid is None else jnp.asarray(valid), **kw))
    assert got.dtype == torch.bool and got.shape == want.shape
    return got.numpy(), want


def test_mask_sphere():
    """``tests/test_preprocess_ops.py:414``'s sphere seen from +x."""
    pts = sphere(2000, 42)
    got, want = mask_pair(pts, np.array([10.0, 0.0, 0.0], np.float32))
    assert np.array_equal(got, want)
    assert got[pts[:, 0] > 0.3].mean() > 0.9 and got[pts[:, 0] < -0.3].mean() < 0.01


def test_mask_batched_and_valid():
    """``tests/test_preprocess_ops.py:438``: garbage rows at 1e6, masked."""
    v = np.random.default_rng(42).normal(size=(2, 512, 3))
    pts = (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)
    pts[:, 500:] = 1e6
    valid = np.ones((2, 512), bool)
    valid[:, 500:] = False
    cams = np.array([[10.0, 0, 0], [0, 10.0, 0]], np.float32)
    got, want = mask_pair(pts, cams, valid)
    assert np.array_equal(got, want) and not got[:, 500:].any()
    assert got[0][pts[0, :, 0] > 0.3].mean() > 0.9


def test_mask_single_cloud_and_shared_camera():
    pts = sphere(700, 5)
    got, want = mask_pair(pts, np.array([0.0, -8.0, 3.0], np.float32))
    assert got.shape == (700,) and np.array_equal(got, want)
    batch = np.stack([sphere(300, 6), sphere(300, 7) * 2.0])
    got, want = mask_pair(batch, np.array([5.0, 5.0, 0.0], np.float32))
    assert got.shape == (2, 300) and np.array_equal(got, want)


@pytest.mark.parametrize("grid,tol", [(64, 0.05), (16, 0.0), (128, 0.2)])
def test_mask_mesh_and_ties(grid, tol):
    """A mesh sample with every point duplicated (exact depth ties in a bin)
    and a valid mask of random holes."""
    pts = kc46_points(3000).astype(np.float32)
    pts = np.stack([np.concatenate([pts, pts[:500]]), np.concatenate([pts[::-1], pts[:500]])])
    valid = np.random.default_rng(9).random(pts.shape[:2]) > 0.1
    cams = np.array([[30.0, 5.0, 4.0], [-10.0, -20.0, -2.0]], np.float32)
    got, want = mask_pair(pts, cams, valid, grid=grid, tol=tol)
    assert np.array_equal(got, want) and got.any()
