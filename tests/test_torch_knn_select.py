"""DGCNN's kNN graph route and the ``knn_select`` kernel's contract on the
CPU.

The kernel (``csrc/knn_select.cu``) runs only on the card, where
``chip_smoke.py`` phase 8 holds it to its plain version. Here: the route
(every tensor through the wrapper, CUDA to the kernel, the CPU to the plain
version), the kernel's list width by k, ``knn_graph`` on the CPU bit for bit
today's graph, no launch counted on the CPU (``build.LAUNCHES``), a stand-in for
``models.dgcnn.knn_graph`` seeing every graph, the wrapper's refusals, and
an emulation of the kernel's selection (the first 32 candidates sorted,
then 32 at a time against the row's k-th distance, the insert across the
list's registers) against the order by (distance, index)."""

import numpy as np
import pytest
import torch

from pointcloudprocessing_tpu_torch.models import dgcnn
from pointcloudprocessing_tpu_torch.models.dgcnn import DGCNN
from pointcloudprocessing_tpu_torch.ops.cuda import build
from pointcloudprocessing_tpu_torch.ops.cuda import knn_select as ks

EDGES = (1, 20, 32, 33)


def _todays_graph(feats: torch.Tensor, k: int) -> torch.Tensor:
    """``knn_graph`` before the kernel: the f32 expansion, clamp, ``topk``."""
    f = feats.float()
    sq = (f * f).sum(dim=-1)
    cross = torch.matmul(f, f.transpose(1, 2))
    d = torch.clamp(sq[:, :, None] + sq[:, None, :] - 2.0 * cross, min=0.0)
    return torch.topk(-d, k, dim=-1).indices.int()


def _feats(b: int, n: int, c: int, dtype=torch.float32, seed: int = 0) -> torch.Tensor:
    x = np.random.default_rng(seed).normal(size=(b, n, c)).astype(np.float32)
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("k, width", [
    (1, 1), (20, 1), (32, 1), (33, 2), (40, 2), (64, 2), (65, 4), (128, 4), (129, 8),
    (256, 8)])
def test_the_list_width_holds_k(k, width):
    """The kernel's lists take the least of 1, 2, 4 and 8 registers a lane
    whose 32 entries each hold k."""
    assert ks.list_width(k) == width


def test_a_k_past_the_kernels_lists_raises():
    """k past ``MAX_K`` (256) has no list width: a CUDA call raises rather
    than leaving the kernel."""
    assert ks.MAX_K == 256
    with pytest.raises(ValueError, match="k <= 256"):
        ks.list_width(257)


@pytest.mark.parametrize("k", EDGES)
def test_knn_graph_takes_the_wrapper_for_every_k(monkeypatch, k):
    """``knn_graph`` has one route: every tensor, at any k, goes through
    ``knn_select``, whose device alone picks the kernel or the plain
    version; the features reach it f32 and contiguous."""
    seen = []

    def recording(feats, kk):
        seen.append((feats.dtype, feats.is_contiguous(), kk))
        return ks.knn_select(feats, kk)

    monkeypatch.setattr(dgcnn, "knn_select", recording)
    feats = _feats(2, 8, 40, torch.bfloat16).transpose(1, 2)
    got = dgcnn.knn_graph(feats, k)
    assert seen == [(torch.float32, True, k)]
    assert torch.equal(got, _todays_graph(feats, k))


@pytest.mark.parametrize("k", EDGES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_knn_graph_on_the_cpu_is_todays_graph(dtype, k):
    """The plain path keeps today's arithmetic: the same indices, in the
    same order, bit for bit, for f32 and bf16 features (made f32 first)."""
    for c in (3, 64):
        feats = _feats(2, 96, c, dtype, seed=c)
        got = dgcnn.knn_graph(feats, k)
        assert got.dtype == torch.int32 and got.shape == (2, 96, k)
        assert torch.equal(got, _todays_graph(feats, k))
        assert torch.equal(ks.knn_select_reference(feats, k), got)


def test_a_cpu_call_launches_nothing():
    """``build.LAUNCHES["knn_select"]`` counts kernel launches only: CPU
    calls of ``knn_graph`` and of the wrapper leave it where it was."""
    before = build.LAUNCHES["knn_select"]
    feats = _feats(2, 64, 16)
    dgcnn.knn_graph(feats, 20)
    dgcnn.knn_graph(feats, 33)
    dgcnn.knn_graph(feats, 64)
    got = ks.knn_select(feats, 20)
    assert torch.equal(got, _todays_graph(feats, 20))
    assert build.LAUNCHES["knn_select"] == before


@pytest.mark.parametrize("graph, calls", [("dynamic", 4), ("static", 1)])
def test_a_stand_in_for_knn_graph_sees_every_graph(monkeypatch, graph, calls):
    """The benchmark's replay stands in for ``models.dgcnn.knn_graph`` by
    name: it sees 4 graphs a dynamic forward and 1 a static one, each
    built by the real function, and the CPU counts no launch."""
    real, seen = dgcnn.knn_graph, []

    def recording(feats, k):
        idx = real(feats, k)
        seen.append(idx)
        return idx

    monkeypatch.setattr(dgcnn, "knn_graph", recording)
    model = DGCNN(5, 3, k=8, edge_widths=(16, 16, 32, 32), emb_width=64, graph=graph,
                  generator=torch.Generator().manual_seed(3), device="cpu").eval()
    before = dict(build.LAUNCHES)
    with torch.inference_mode():
        model(torch.randn(2, 48, 3))
    assert len(seen) == calls and build.LAUNCHES == before
    assert all(idx.shape == (2, 48, 8) and idx.dtype == torch.int32 for idx in seen)


@pytest.mark.parametrize("feats, k, error", [
    (_feats(2, 64, 8, torch.bfloat16), 20, TypeError),
    (_feats(2, 64, 8, torch.float64), 20, TypeError),
    (_feats(2, 8, 64).transpose(1, 2), 4, ValueError),
    (_feats(2, 64, 8)[:, ::2], 4, ValueError),
    (_feats(1, 64, 8)[0], 4, ValueError),
    (_feats(2, 16, 8), 17, ValueError),
    (_feats(2, 64, 8), 0, ValueError),
    (_feats(2, 64, 0), 4, ValueError),
    (torch.empty((2, 64, 8), device="meta"), 20, ValueError),
], ids=["bf16", "f64", "transposed", "strided", "2-d", "k-past-n", "k-0", "c-0", "meta"])
def test_the_wrapper_refuses_what_it_cannot_read(feats, k, error):
    """A non-f32, non-contiguous or misshapen input, a k outside [1, n]
    and a device with no kernel raise before any launch."""
    before = build.LAUNCHES["knn_select"]
    with pytest.raises(error):
        ks.knn_select(feats, k)
    assert build.LAUNCHES["knn_select"] == before


# ---- the kernel's selection, emulated

TILE, LANES = 128, 32


def _emulated_select(d: np.ndarray, n: int, k: int) -> np.ndarray:
    """``knn_select_kernel``'s selection over one cloud's f32 distances d
    (n, n): candidates come in tiles of 128 columns (past n: +inf), 32 at a
    time, into a row's list of 32 ``list_width(k)`` entries. The first 32
    fill its first 32 entries sorted by (distance, index), the rest +inf; of
    each later 32, those below the list's k-th entry at the part's start
    are inserted in lane order, each entry kept if it is at or below the
    new one, else the new one taken if the entry before it is at or below
    it (or it is the first), else the entry before it."""
    size = LANES * ks.list_width(k)
    out = np.empty((n, k), dtype=np.int64)
    for i in range(n):
        ld = np.full(size, np.inf, dtype=np.float32)
        li = np.zeros(size, dtype=np.int64)
        for part in range(0, -(-n // TILE) * TILE, LANES):
            cols = np.arange(part, part + LANES)
            v = np.where(cols < n, d[i, np.minimum(cols, n - 1)], np.float32(np.inf))
            if part == 0:
                order = np.lexsort((cols, v))
                ld[:LANES], li[:LANES] = v[order], cols[order]
                continue
            for src in np.flatnonzero(v < ld[k - 1]):
                x, j = v[src], cols[src]
                up_d, up_i = np.roll(ld, 1), np.roll(li, 1)
                keep = ld <= x
                here = (np.arange(size) == 0) | (up_d <= x)
                ld, li = (np.where(keep, ld, np.where(here, x, up_d)),
                          np.where(keep, li, np.where(here, j, up_i)))
        out[i] = li[:k]
    return out


def _distances(x: np.ndarray) -> np.ndarray:
    """The expansion in f32, clamped as the kernel clamps it."""
    sq = (x * x).sum(-1)
    d = (sq[:, None] + sq[None, :]) - np.float32(2.0) * (x @ x.T)
    return np.clip(d, 0.0, np.finfo(np.float32).max).astype(np.float32)


@pytest.mark.parametrize("n, c, k, kind", [
    (300, 3, 20, "normal"), (130, 16, 32, "normal"), (129, 8, 1, "normal"),
    (20, 5, 20, "normal"), (256, 3, 20, "grid"), (200, 4, 20, "repeats"),
    (300, 8, 33, "normal"), (260, 3, 40, "grid"), (200, 6, 64, "repeats"),
    (300, 4, 65, "normal"), (280, 3, 256, "normal"),
])
def test_the_kernels_selection_is_the_order_by_distance_then_index(n, c, k, kind):
    """The emulated selection gives each row's k smallest by (distance,
    index), ascending: members distinct, equal distances on the lower
    index (exact ties on an integer grid and on repeated points)."""
    rng = np.random.default_rng(n + c + k)
    if kind == "grid":
        x = rng.integers(0, 4, size=(n, c)).astype(np.float32)
    elif kind == "repeats":
        x = np.repeat(rng.normal(size=(n // 4, c)), 4, axis=0).astype(np.float32)
    else:
        x = rng.normal(size=(n, c)).astype(np.float32)
    d = _distances(x)
    got = _emulated_select(d, n, k)
    want = np.stack([np.lexsort((np.arange(n), d[i]))[:k] for i in range(n)])
    np.testing.assert_array_equal(got, want)
