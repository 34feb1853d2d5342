"""PCA normals of the port against the JAX package: kNN, the 3x3
eigen-solve, exact normals, the windowed moment sums (the plain version of
the port's kernel against the Pallas kernel, which runs in interpret mode on
the CPU) and windowed normals.

Inputs come from numpy seeds; every cloud goes through the JAX package's
voxel downsample where the windowed path needs Morton order, and the same
arrays feed both sides.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudprocessing_tpu.ops.pallas.window_normals import (
    windowed_moment_sums as jax_window_sums,
)
from pointcloudprocessing_tpu.ops.voxel import voxel_downsample_batch as jax_voxel
from pointcloudprocessing_tpu_torch.ops import normals
from pointcloudprocessing_tpu_torch.ops.cuda.window_normals import (
    window_selection,
    windowed_moment_sums,
)

# both packages' ``ops`` export functions under these modules' names
knn = importlib.import_module("pointcloudprocessing_tpu_torch.ops.knn")
jknn = importlib.import_module("pointcloudprocessing_tpu.ops.knn")
jnormals = importlib.import_module("pointcloudprocessing_tpu.ops.normals")

# the JAX kernel sums bf16 hi/lo halves of each feature: about 2^-16 of the
# sum of the absolute terms (the port sums in f32, more exactly)
SUM_BAR = 2.0 ** -16


def _angles(a: np.ndarray, b: np.ndarray, signed: bool = False) -> np.ndarray:
    """Angle in degrees between unit vectors, up to sign unless ``signed``;
    from the chord in f64 (arccos of an f32 dot cannot resolve 0.03 deg)."""
    a, b = a.astype(np.float64), b.astype(np.float64)
    chord = np.linalg.norm(a - b, axis=-1)
    if not signed:
        chord = np.minimum(chord, np.linalg.norm(a + b, axis=-1))
    return np.degrees(2 * np.arcsin(np.clip(chord / 2, 0.0, 1.0)))


@pytest.fixture(scope="module")
def surface():
    """The 2x2048 paraboloid of ``test_preprocess_ops.py:364``, offset to
    (50, -30, 5) (f32 cancellation), voxel-downsampled at 0.5 by the JAX
    package (Morton order); with the viewpoint above it."""
    rng = np.random.default_rng(42)
    xy = rng.uniform(-10, 10, (2, 2048, 2)).astype(np.float32)
    z = 0.05 * (xy[..., 0] ** 2 + xy[..., 1] ** 2)
    pts = np.concatenate([xy, z[..., None]], axis=-1).astype(np.float32)
    pts += np.array([50.0, -30.0, 5.0], np.float32)
    vox, mask = jax_voxel(jnp.asarray(pts), 0.5)
    vp = np.array([[50.0, -30.0, 500.0]] * 2, np.float32)
    return np.array(vox), np.array(mask), vp


def _centered_planes(vox: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Per-cloud centred (b, 3, n) planes, as the windowed path centres."""
    planes = np.ascontiguousarray(vox.transpose(0, 2, 1))
    denom = np.maximum(mask.sum(1), 1).astype(np.float32)
    centroid = np.where(mask[:, None, :], planes, 0).sum(2) / denom[:, None]
    return (planes - centroid[:, :, None].astype(np.float32)).astype(np.float32)


def test_knn_matches_jax():
    """Distances within f32 rounding of the expansion and identical index
    sets against ``knn_batch(exact=True)``, with invalid points."""
    rng = np.random.default_rng(0)
    q = (rng.normal(size=(2, 48, 3)) * 5 + 20).astype(np.float32)
    p = (rng.normal(size=(2, 96, 3)) * 5 + 20).astype(np.float32)
    valid = rng.uniform(size=(2, 96)) > 0.2
    want_i, want_d = jknn.knn_batch(jnp.asarray(q), jnp.asarray(p), 8,
                                    jnp.asarray(valid), exact=True)
    got_i, got_d = knn.knn_batch(torch.from_numpy(q), torch.from_numpy(p), 8,
                                 torch.from_numpy(valid))
    # |p|^2 ~ 1e3 here: a few f32 ulps of it
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=0, atol=1e-3)
    assert got_i.dtype == torch.int32
    for g, w in zip(got_i.numpy().reshape(-1, 8), np.asarray(want_i).reshape(-1, 8)):
        assert set(g.tolist()) == set(w.tolist())
    assert valid[np.arange(2)[:, None, None], got_i.numpy()].all()
    pts = torch.from_numpy(p[0])
    np.testing.assert_array_equal(
        knn.group_points(pts, got_i[0]).numpy(),
        np.asarray(jknn.group_points(jnp.asarray(p[0]), jnp.asarray(got_i[0].numpy()))))


def test_smallest_eigenvector_matches_jax():
    """Random symmetric 3x3 matrices with separated eigenvalues, plus the
    isotropic case (+z fallback): the same vector up to sign."""
    rng = np.random.default_rng(1)
    rot, _ = np.linalg.qr(rng.normal(size=(512, 3, 3)))
    lam = np.sort(rng.uniform(0.0, 1.0, (512, 3)), -1) + np.array([0.0, 0.2, 0.4])
    a = np.einsum("bij,bj,bkj->bik", rot, lam, rot).astype(np.float32)
    a[0] = np.eye(3, dtype=np.float32)
    want = np.asarray(jnormals.smallest_eigenvector_sym3x3(jnp.asarray(a)))
    got = normals.smallest_eigenvector_sym3x3(torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    assert np.abs(np.sum(got * want, -1)).min() > 1 - 1e-5
    np.testing.assert_array_equal(got[0], [0.0, 0.0, 1.0])


@pytest.mark.parametrize("oriented", [False, True], ids=["unoriented", "viewpoint"])
def test_exact_normals_match_jax(surface, oriented):
    """``method='exact'`` against the JAX package's exact path (signs too
    with a viewpoint): within 0.01 degrees, from the same threshold-selected
    neighbour sets."""
    vox, mask, vp = surface
    vox, mask = vox[:, :512], mask[:, :512]
    vp_j = jnp.asarray(vp) if oriented else None
    vp_t = torch.from_numpy(vp) if oriented else None
    want = np.asarray(jnormals.estimate_normals_batch(
        jnp.asarray(vox), 16, jnp.asarray(mask), vp_j, method="exact"))
    got = normals.estimate_normals_batch(
        torch.from_numpy(vox), 16, torch.from_numpy(mask), vp_t,
        method="exact").numpy()
    ang = _angles(got, want, signed=oriented)[mask]
    assert ang.max() < 0.01, ang.max()


@pytest.fixture(scope="module")
def surface_sums(surface):
    """The JAX kernel's and the port's plain moment sums on the centred
    surface (n = 2048: q_block 256, window 256, as the normals path picks)."""
    vox, mask, _ = surface
    centered = _centered_planes(vox, mask)
    want = np.stack([np.asarray(s) for s in jax_window_sums(
        jnp.asarray(centered), jnp.asarray(mask), 16, window=256, q_block=256,
        layout="bcn")])
    planes_t, mask_t = torch.from_numpy(centered), torch.from_numpy(mask)
    sel, feats = window_selection(planes_t, mask_t, 16, 256, 256)
    abs_sums = torch.matmul(sel, feats.abs()).reshape(2, -1, 10).permute(2, 0, 1)
    return centered, mask, want, abs_sums.numpy()


@pytest.mark.parametrize("layout", ["bcn", "bnc"])
def test_window_moment_sums_match_jax(surface_sums, layout):
    """Counts identical (the selection of the JAX kernel; an exception
    could only be a distance within a few ulp of the half-level threshold,
    where XLA's exp2 is not correctly rounded, and there is none at these
    inputs), sums within the JAX kernel's bf16 hi/lo error."""
    centered, mask, want, abs_sums = surface_sums
    x = centered if layout == "bcn" else np.ascontiguousarray(centered.transpose(0, 2, 1))
    got = np.stack([s.numpy() for s in windowed_moment_sums(
        torch.from_numpy(x), torch.from_numpy(mask), 16, window=256,
        q_block=256, layout=layout)])
    mismatched = int((got[0] != want[0]).sum())
    assert mismatched == 0, f"{mismatched} counts differ"
    assert (got[0][mask] >= 16).all()
    bar = SUM_BAR * abs_sums + 1e-6
    assert (np.abs(got - want) <= bar).all(), np.max(np.abs(got - want) / bar)


def test_window_normals_match_jax_and_exact(surface):
    """Windowed normals against the JAX window path (within 0.1 degree
    median, signs included) and, for quality, against the exact path: the
    JAX package's bar, median under 1 degree and p95 under 5."""
    vox, mask, vp = surface
    args = dict(k=16, method="window")
    want = np.asarray(jnormals.estimate_normals_batch(
        jnp.asarray(vox), valid_mask=jnp.asarray(mask), viewpoint=jnp.asarray(vp),
        **args))
    got = normals.estimate_normals_batch(
        torch.from_numpy(vox), valid_mask=torch.from_numpy(mask),
        viewpoint=torch.from_numpy(vp), **args).numpy()
    assert np.median(_angles(got, want, signed=True)[mask]) < 0.1
    exact = normals.estimate_normals_batch(
        torch.from_numpy(vox), 16, torch.from_numpy(mask), torch.from_numpy(vp),
        method="exact").numpy()
    ang = _angles(exact, got)[mask]
    assert np.median(ang) < 1.0
    assert np.percentile(ang, 95) < 5.0

    planes = np.ascontiguousarray(vox.transpose(0, 2, 1))
    got_bcn = normals.estimate_normals_batch(
        torch.from_numpy(planes), valid_mask=torch.from_numpy(mask),
        viewpoint=torch.from_numpy(vp), layout="bcn", **args).numpy()
    # the layouts centre with sums in another order: f32 rounding
    np.testing.assert_allclose(got_bcn, got.transpose(0, 2, 1), rtol=0, atol=1e-5)


def test_window_normals_edge_cases():
    """The JAX package's edge cases (``test_preprocess_ops.py:386-409``):
    fewer valid points than k among garbage rows, an n that is no multiple
    of 128, and the single-cloud entry point; each against the JAX window
    path."""
    rng = np.random.default_rng(42)
    pts = np.zeros((1, 256, 3), np.float32)
    pts[0, :5, :2] = rng.uniform(-1, 1, (5, 2))
    pts[0, 5:] = 1e6
    mask = np.zeros((1, 256), bool)
    mask[:, :5] = True
    want = np.asarray(jnormals.estimate_normals_batch(
        jnp.asarray(pts), k=16, valid_mask=jnp.asarray(mask), method="window"))
    got = normals.estimate_normals_batch(
        torch.from_numpy(pts), k=16, valid_mask=torch.from_numpy(mask),
        method="window").numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(np.abs(got[0, :5, 2]), 1.0, atol=1e-3)
    assert _angles(got[0, :5], want[0, :5]).max() < 0.1

    odd = rng.normal(size=(1, 490, 3)).astype(np.float32)
    want = np.asarray(jnormals.estimate_normals_batch(jnp.asarray(odd), k=8,
                                                      method="window"))
    got = normals.estimate_normals_batch(torch.from_numpy(odd), k=8,
                                         method="window").numpy()
    assert got.shape == (1, 490, 3) and np.isfinite(got).all()
    # isotropic gaussian neighbourhoods are ill-conditioned: most normals
    # agree to 0.1 degree, a few near-degenerate ones move further
    assert np.median(_angles(got, want)) < 0.1

    single = normals.estimate_normals(torch.from_numpy(pts[0]), k=4,
                                      method="window")
    assert single.shape == (256, 3)


def test_window_single_valid_point_counts_one():
    """``test_preprocess_ops.py:577``: a query with no valid nonzero-distance
    candidate (m = inf) selects no padding; the whole count plane matches
    the JAX kernel's."""
    rng = np.random.default_rng(42)
    pts = rng.normal(size=(1, 512, 3)).astype(np.float32) * 50
    mask = np.zeros((1, 512), bool)
    mask[0, 0] = True
    want = np.asarray(jax_window_sums(jnp.asarray(pts), jnp.asarray(mask), k=16,
                                      window=128, q_block=128)[0])
    got = windowed_moment_sums(torch.from_numpy(pts), torch.from_numpy(mask),
                               k=16, window=128, q_block=128)[0].numpy()
    assert got[0, 0] == 1.0
    np.testing.assert_array_equal(got, want)


def test_argument_checks():
    pts = torch.zeros(1, 256, 3)
    mask = torch.ones(1, 256, dtype=torch.bool)
    with pytest.raises(ValueError, match="128-aligned"):
        windowed_moment_sums(pts, mask, 8, window=100, q_block=128)
    with pytest.raises(ValueError, match="exceeds cloud size"):
        windowed_moment_sums(pts, mask, 8, window=128, q_block=128)
    with pytest.raises(ValueError, match="layout"):
        windowed_moment_sums(pts, mask, 8, window=0, q_block=128, layout="nbc")
    with pytest.raises(ValueError, match="only supported for method='window'"):
        normals.estimate_normals_batch(pts.transpose(1, 2), layout="bcn")
    with pytest.raises(ValueError, match="Unknown layout"):
        normals.estimate_normals_batch(pts, method="window", layout="nbc")
