"""Brute-force k-nearest-neighbour search (``pointcloudprocessing_tpu/ops/knn.py``).

Pairwise squared distances as ``|a|^2 + |b|^2 - 2 a.b^T``, then an exact
``torch.topk``. The cross term is an f32 ``torch.matmul`` with TF32 off
(the JAX package's ``precision=HIGHEST``): the expansion subtracts
``|p|^2``-sized terms to recover neighbour distances that can be four or more
orders smaller, so a reduced-precision product corrupts every neighbourhood
of a cloud far from the origin.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_f32_matmul():
    """TF32 off for CUDA matmuls inside the block (a no-op on the CPU, which
    has no TF32); the previous setting comes back after it."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def pairwise_sq_dists(queries: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """(..., nq, c), (..., np, c) -> (..., nq, np) squared euclidean
    distances, clamped at 0 (negative rounding residue): the expansion
    above, the cross term an f32 product with TF32 off."""
    q2 = torch.square(queries).sum(dim=-1, keepdim=True)
    p2 = torch.square(points).sum(dim=-1)
    with full_f32_matmul():
        cross = torch.matmul(queries, points.transpose(-1, -2))
    d = q2 + p2[..., None, :] - 2.0 * cross
    return torch.clamp(d, min=0.0)


def knn(
    queries: torch.Tensor,
    points: torch.Tensor,
    k: int,
    valid_mask: torch.Tensor | None = None,
    exact: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """k nearest neighbours of each query among points.

    queries (nq, 3), points (np, 3), valid_mask optional (np,) bool (invalid
    points are pushed to +inf). Returns (indices (nq, k) int32, sq_dists
    (nq, k)) sorted ascending. ``exact=False`` is the JAX package's
    ``approx_min_k``, a TPU partial reduction that is not ported: the port
    answers it with the exact ``torch.topk``.
    """
    del exact  # both answer exactly (see above)
    d = pairwise_sq_dists(queries, points)
    if valid_mask is not None:
        d = torch.where(valid_mask[..., None, :], d, float("inf"))
    neg_d, idx = torch.topk(-d, k, dim=-1)
    return idx.int(), -neg_d


def knn_batch(
    queries: torch.Tensor,
    points: torch.Tensor,
    k: int,
    valid_mask: torch.Tensor | None = None,
    exact: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(b, nq, 3), (b, np, 3) -> ((b, nq, k), (b, nq, k))."""
    return knn(queries, points, k, valid_mask, exact)


def group_points(points: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Gather neighbour groups: points (n, c), indices (nq, k) -> (nq, k, c)."""
    return points[indices.long()]
