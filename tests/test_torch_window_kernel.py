"""The windowed moment-sum kernel's algorithm on the CPU: the threshold from
two order statistics (m and the k-th distance) against the counting search
bit for bit on adversarial clouds, the register insertion that keeps the
k-th distance, the kernel-form rule, the launch checks at shapes the
earlier kernel refused, and the plain version against the JAX Pallas
kernel (interpret mode) at query blocks of 384 and 512.

Inputs come from numpy seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudprocessing_tpu.ops.pallas.window_normals import (
    windowed_moment_sums as jax_window_sums,
)
from pointcloudprocessing_tpu.ops.voxel import voxel_downsample_batch as jax_voxel
from pointcloudprocessing_tpu_torch.ops.cuda.window_normals import (
    REGISTER_FORMS,
    RESIDENT_MAX,
    STREAM_TILE,
    kernel_form,
    launch_plan,
    window_selection,
    window_selection_by_order,
    windowed_moment_sums,
)

# the JAX kernel sums bf16 hi/lo halves of each feature: about 2^-16 of the
# sum of the absolute terms (the port sums in f32, more exactly)
SUM_BAR = 2.0 ** -16
B, N, Q, W = 2, 512, 128, 128  # C = 384 candidates a query block


def _point_at(target: np.float32) -> list:
    """(x, y, 0) whose squared distance from the origin, rounded as the
    kernel rounds it, is exactly ``target``: x^2 just below it, y^2 the
    rest."""
    x = np.float32(np.sqrt(np.float64(target)))
    while np.float32(x * x) >= target:
        x = np.nextafter(x, np.float32(0))
    y = np.float32(np.sqrt(np.float64(target - np.float32(x * x))))
    assert np.float32(np.float32(x * x) + np.float32(y * y)) == target
    return [x, y, 0.0]


def _ladder() -> np.ndarray:
    """Points on which the query at the origin meets exact ties: a point at
    distance 1 (m = 1), points at m * 2^s (s = 1..11) and at the half levels
    f32(2^s * f32(2^-0.5)) (s = 1..11)."""
    pts = [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]]
    half = np.float32(0.70710678118654752440)
    for s in range(1, 12):
        a = np.float32(2.0 ** ((s - 1) // 2))
        pts.append([a, a, 0.0] if s % 2 else [0.0, 0.0, np.float32(2.0 ** (s // 2))])
        pts.append(_point_at(np.float32(np.float32(2.0 ** s) * half)))
    return np.asarray(pts, np.float32)


def _cloud(kind: str, rng) -> tuple[np.ndarray, np.ndarray]:
    """(B, N, 3) points and (B, N) validity for one adversarial kind."""
    pts = rng.normal(size=(B, N, 3)).astype(np.float32)
    mask = rng.uniform(size=(B, N)) > 0.2
    if kind == "duplicates":  # each point four times: many distances are 0
        pts = np.repeat(pts[:, : N // 4], 4, axis=1)
    elif kind == "integer_grid":  # integer squares: ties at m * 2^s
        pts = rng.integers(-3, 4, (B, N, 3)).astype(np.float32)
    elif kind == "half_integer_grid":
        pts = rng.integers(-6, 7, (B, N, 3)).astype(np.float32) * 0.5
    elif kind == "ladder":  # exact ties at m * 2^s and at the half levels
        ladder = _ladder()
        pts = (rng.uniform(1e3, 2e3, (B, N, 3)) * rng.choice([-1, 1], (B, N, 3))
               ).astype(np.float32)
        pts[:, : len(ladder)] = ladder
        pts[1] *= np.float32(2.0 ** -10)  # exact: the ties survive the scale
        mask[:, : len(ladder)] = True
    elif kind == "few_valid":  # fewer valid points than k in every block
        mask[:] = False
        mask[:, :5] = True
    elif kind == "one_valid":
        mask[:] = False
        mask[:, 0] = True
    elif kind == "huge_m":  # m > 1e37; squares overflow to inf
        pts *= np.float32(3e19)
    elif kind == "overflowing_levels":  # m * 2^11 overflows to inf
        pts *= np.float32(3e17)
    elif kind == "subnormal":  # squared distances below 2^-126
        pts *= np.float32(1e-20)
    return pts, mask


KINDS = ("normal", "duplicates", "integer_grid", "half_integer_grid", "ladder",
         "few_valid", "one_valid", "huge_m", "overflowing_levels", "subnormal")


@pytest.mark.parametrize("k", [1, 3, 4, 16, 32, 100, 600])
@pytest.mark.parametrize("kind", KINDS)
def test_order_statistics_select_as_the_counting_search(kind, k):
    """m and d_(k), then one compare a level, select exactly the candidates
    the counting search selects (k 600 exceeds the 384 candidates)."""
    pts, mask = _cloud(kind, np.random.default_rng(KINDS.index(kind)))
    planes = torch.from_numpy(np.ascontiguousarray(pts.transpose(0, 2, 1)))
    valid = torch.from_numpy(mask)
    want, feats = window_selection(planes, valid, k, W, Q)
    got, got_feats = window_selection_by_order(planes, valid, k, W, Q)
    assert torch.equal(got, want), int((got != want).sum())
    assert torch.equal(got_feats, feats)
    if kind == "ladder" and k == 3:
        # the origin query's third distance sits exactly on the half level
        # of s = 1, which admits it: {self, the point at 1, the tie}
        assert got[0, 0, 0].sum() == 3


def _register_kth(values: np.ndarray, k: int, kmax: int) -> np.float32:
    """The kernel's register insertion: KMAX slots sorted ascending, the
    first KMAX - k at -inf; a value enters behind one reject compare against
    the last slot, which ends as the k-th smallest (+inf if fewer)."""
    t = np.array([-np.inf] * (kmax - k) + [np.inf] * k, np.float32)
    for x in values:
        if x < t[-1]:
            for i in range(kmax - 1, 0, -1):
                t[i] = min(t[i], max(t[i - 1], x))
            t[0] = min(t[0], x)
    return t[-1]


@pytest.mark.parametrize("kmax", REGISTER_FORMS)
def test_register_insertion_keeps_the_kth_distance(kmax):
    """Every k up to KMAX, on sequences with repeats, zeros, +inf and fewer
    values than k."""
    rng = np.random.default_rng(kmax)
    seqs = [rng.uniform(0, 10, 200), rng.integers(0, 4, 200), np.zeros(50),
            np.concatenate([np.full(20, np.inf), rng.uniform(0, 1, 30)]),
            rng.uniform(0, 1, 5), np.sort(rng.uniform(0, 1, 100))[::-1]]
    for seq in seqs:
        seq = seq.astype(np.float32)
        for k in range(1, kmax + 1):
            want = np.sort(seq)[k - 1] if k <= len(seq) else np.float32(np.inf)
            assert _register_kth(seq, k, kmax) == want, (k, seq[:8])


def test_kernel_form_rule():
    """The least register bound that holds k, the counting search above 32;
    one tile up to RESIDENT_MAX candidates, streamed tiles above."""
    assert [kernel_form(k, 256, 256)[0] for k in (1, 8, 9, 16, 17, 32, 33, 600)] \
        == [8, 8, 16, 16, 32, 32, 0, 0]
    assert kernel_form(16, 256, 256) == (16, 768)
    assert kernel_form(16, 256, 896) == (16, RESIDENT_MAX)  # C = 2048
    assert kernel_form(16, 384, 896) == (16, STREAM_TILE)  # C = 2176
    assert kernel_form(16, 256, 7168) == (16, STREAM_TILE)
    with pytest.raises(ValueError, match="k must be >= 1"):
        kernel_form(0, 256, 256)


@pytest.mark.parametrize("b, n, q_block, window, k, form", [
    (2, 16384, 256, 7168, 16, (16, STREAM_TILE)),  # C 14,592 > 14,336
    (8, 8192, 512, 256, 16, (16, 1024)),  # q_block 512
    (65536, 384, 128, 128, 16, (16, 384)),  # more than 65,535 clouds
    (8, 8192, 256, 256, 48, (0, 768)),  # k above the register forms
])
def test_launch_plan_takes_what_the_earlier_kernel_refused(b, n, q_block, window, k,
                                                           form):
    """The CUDA call's checks pass every shape the JAX function takes (meta
    tensors: nothing is built or allocated)."""
    planes = torch.empty((b, 3, n), device="meta")
    valid = torch.empty((b, n), dtype=torch.bool, device="meta")
    got, kmax, tile = launch_plan(planes, valid, k, window, q_block, "bcn")
    assert got.shape == (b, 3, n)
    assert (kmax, tile) == form
    with pytest.raises(TypeError, match="f32"):
        launch_plan(planes.half(), valid, k, window, q_block, "bcn")
    with pytest.raises(ValueError, match="contiguous"):
        launch_plan(torch.empty((b, n, 3), device="meta").transpose(1, 2), valid,
                    k, window, q_block, "bcn")


@pytest.fixture(scope="module")
def surface():
    """The 2x2048 offset paraboloid of ``test_torch_normals.py``, voxel
    0.5 by the JAX package (Morton order), centred per cloud as (b, 3, n)
    planes."""
    rng = np.random.default_rng(42)
    xy = rng.uniform(-10, 10, (2, 2048, 2)).astype(np.float32)
    z = 0.05 * (xy[..., 0] ** 2 + xy[..., 1] ** 2)
    pts = np.concatenate([xy, z[..., None]], axis=-1).astype(np.float32)
    pts += np.array([50.0, -30.0, 5.0], np.float32)
    vox, mask = (np.array(a) for a in jax_voxel(jnp.asarray(pts), 0.5))
    planes = np.ascontiguousarray(vox.transpose(0, 2, 1))
    denom = np.maximum(mask.sum(1), 1).astype(np.float32)
    centroid = np.where(mask[:, None, :], planes, 0).sum(2) / denom[:, None]
    return (planes - centroid[:, :, None]).astype(np.float32), mask


@pytest.mark.parametrize("q_block, window, n", [(384, 384, 1536), (512, 256, 2048)])
def test_plain_matches_jax_at_wide_query_blocks(surface, q_block, window, n):
    """Query blocks the earlier kernel refused: counts identical to the JAX
    kernel's, sums within its bf16 hi/lo error."""
    centered, mask = surface
    centered, mask = np.ascontiguousarray(centered[:, :, :n]), mask[:, :n]
    want = np.stack([np.asarray(s) for s in jax_window_sums(
        jnp.asarray(centered), jnp.asarray(mask), 16, window=window,
        q_block=q_block, layout="bcn")])
    planes_t, mask_t = torch.from_numpy(centered), torch.from_numpy(mask)
    got = np.stack([s.numpy() for s in windowed_moment_sums(
        planes_t, mask_t, 16, window=window, q_block=q_block, layout="bcn")])
    sel, feats = window_selection(planes_t, mask_t, 16, window, q_block)
    abs_sums = torch.matmul(sel, feats.abs()).reshape(2, n, 10).permute(2, 0, 1)
    assert int((got[0] != want[0]).sum()) == 0
    assert (got[0][mask] >= 16).all()
    bar = SUM_BAR * abs_sums.numpy() + 1e-6
    assert (np.abs(got - want) <= bar).all(), np.max(np.abs(got - want) / bar)


def _box_bound(q: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """The kernel's pruning bound, f32 in its operation order: the gap to
    the box an axis, max(max(lo - q, q - hi), 0), then (gx*gx + gy*gy) +
    gz*gz."""
    with np.errstate(over="ignore", invalid="ignore"):
        g = np.maximum(np.maximum(lo - q, q - hi), np.float32(0))
        sq = g * g
        return (sq[..., 0] + sq[..., 1]) + sq[..., 2]


def _groups(pts: np.ndarray, mask: np.ndarray, size: int = 16):
    """Each group of `size` rows' box over its valid rows (+inf, -inf when
    none), as the prep kernel forms it."""
    g = pts.reshape(-1, size, 3)
    v = mask.reshape(-1, size, 1)
    lo = np.where(v, g, np.float32(np.inf)).min(axis=1)
    hi = np.where(v, g, np.float32(-np.inf)).max(axis=1)
    return g, v[..., 0], lo, hi


def _rounded_dm(q: np.ndarray, p: np.ndarray, valid: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        d = p - q
        sq = d * d
        dist = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
    return np.where(valid, dist, np.float32(np.inf))


@pytest.mark.parametrize("kind", KINDS)
def test_box_bound_is_below_every_rounded_distance(kind):
    """Rounding is monotone, so the bound from a query to a group's box is
    <= the rounded distance (+inf if invalid) of every point of the group,
    with subnormal, overflowing and +inf squares; an all-invalid group's
    bound is +inf."""
    pts, mask = _cloud(kind, np.random.default_rng(100 + KINDS.index(kind)))
    pts, mask = pts.reshape(-1, 3), mask.reshape(-1)
    g, v, lo, hi = _groups(pts, mask)
    queries = pts[::7]
    lb = _box_bound(queries[:, None], lo[None], hi[None])  # (queries, groups)
    dm = _rounded_dm(queries[:, None, None], g[None], v[None])  # (q, groups, 16)
    assert (lb[..., None] <= dm).all()
    assert np.isinf(lb[:, ~v.any(axis=1)]).all()


def _pruned_walk(q, cand, valid, k, order, groups=16):
    """Pass 1 of the kernel for one warp's queries, groups skipped by the
    kernel's rule (every query's bound >= max(m, its k-th so far)): m and
    the k-th distance of each query."""
    g, v, lo, hi = _groups(cand, valid, groups)
    m = np.full(len(q), np.inf, np.float32)
    top = np.full((len(q), k), np.inf, np.float32)
    skipped = 0
    for gi in order:
        lb = _box_bound(q, lo[gi], hi[gi])
        if (lb >= np.maximum(m, top[:, -1])).all():
            skipped += 1
            continue
        for dm in _rounded_dm(q[:, None], g[gi][None], v[gi][None]).T:
            m = np.where(dm > 0, np.minimum(m, dm), m)
            top = np.sort(np.concatenate([top, dm[:, None]], axis=1), axis=1)[:, :k]
    return m, top[:, -1], skipped


@pytest.mark.parametrize("kind", ["normal", "integer_grid", "ladder", "few_valid",
                                  "huge_m", "subnormal"])
def test_pruned_walk_keeps_m_and_the_kth(kind):
    """A warp's pass 1 with skipped groups, walked from just before its own
    queries around the window, gives the same m and k-th distance as the
    unpruned order statistics. Rows sorted by x (a spatially local order,
    as the kernel's Morton-ordered input is): on the normal cloud some
    groups do skip."""
    pts, mask = _cloud(kind, np.random.default_rng(200 + KINDS.index(kind)))
    order_x = np.argsort(pts[0, :384, 0], kind="stable")
    cand, valid = pts[0, order_x], mask[0, order_x]
    k = 16
    q = cand[64:128]  # one warp's 64 queries: two a lane
    order = [(i + 3) % 24 for i in range(24)]  # from group 3 (query 48) around
    m, kth, skipped = _pruned_walk(q, cand, valid, k, order)
    dm = _rounded_dm(q[:, None], cand[None], valid[None])
    want_m = np.where(dm > 0, dm, np.inf).min(axis=1)
    want_kth = np.sort(dm, axis=1)[:, k - 1]
    np.testing.assert_array_equal(m, want_m)
    np.testing.assert_array_equal(kth, want_kth)
    if kind == "normal":
        assert skipped > 0
