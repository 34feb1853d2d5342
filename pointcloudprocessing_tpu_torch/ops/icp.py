"""Iterative Closest Point, point to point (``pointcloudprocessing_tpu/ops/icp.py``).

A fixed number of iterations of: move the source by the current (R, t) in
full f32, match each moved point to its nearest target point (the exact
:func:`~pointcloudprocessing_tpu_torch.ops.knn.knn`), and solve Kabsch on
the matches.
"""

from __future__ import annotations

import math

import torch

from pointcloudprocessing_tpu_torch.ops.knn import full_f32_matmul, knn
from pointcloudprocessing_tpu_torch.ops.mat_ops import f32, solve_kabsch


def icp(
    source,
    target,
    iterations: int = 20,
    exact_nn: bool = True,
    device="cuda",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Align ``source`` (n, 3) to ``target`` (m, 3) on ``device`` (CUDA
    unless the caller asks for the CPU).

    Returns (R (3, 3), t (3,), rmse) such that ``source @ R.T + t ~= target``;
    with ``iterations`` 0, (I, 0, inf). ``exact_nn=False`` (the JAX
    package's ``approx_min_k``) is answered exactly. Each iteration builds
    the full (n, m) distance matrix: 1.6 GB in f32 at 20,000 x 20,000.
    """
    del exact_nn  # answered exactly (see above)
    source = f32(source, device)
    target = f32(target, source.device)
    r = torch.eye(3, dtype=source.dtype, device=source.device)
    t = torch.zeros(3, dtype=source.dtype, device=source.device)
    rmse = torch.tensor(math.inf, dtype=source.dtype, device=source.device)
    for _ in range(iterations):
        with full_f32_matmul():
            moved = torch.matmul(source, r.T) + t
        idx, _ = knn(moved, target, 1)
        matched = target[idx[:, 0].long()]
        r, t, rmse = solve_kabsch(matched, source, source.device)
    return r, t, rmse
