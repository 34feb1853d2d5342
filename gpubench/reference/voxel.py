"""Voxel-grid downsampling of (b, n, 3) clouds to voxel centroids in Morton
order, a copy of the semantics of
``pointcloudprocessing_tpu_torch/ops/voxel.py::voxel_downsample_batch``
(reduction 'centroid', every row valid).

Each voxel's rows are found by a stable sort of their Morton keys and summed
one after another in that order, as the program's segment sum sums a short
run, so the centroids can agree bit for bit; the order matters because FPS
downstream flips on the last bit.
"""

from __future__ import annotations

import torch

_INT64_MAX = torch.iinfo(torch.int64).max


def morton_key(rel: torch.Tensor) -> torch.Tensor:
    """(..., 3) non-negative int grid coordinates -> int64 Z-order key of
    their 15 low bits, x above y above z within a level."""
    rel = torch.clamp(rel, 0, 32767).long()
    key = torch.zeros(rel.shape[:-1], dtype=torch.int64, device=rel.device)
    for bit in range(15):
        for axis, shift in ((0, 2), (1, 1), (2, 0)):
            key |= ((rel[..., axis] >> bit) & 1) << (3 * bit + shift)
    return key


def run_sums(data: torch.Tensor, head: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sums of the runs of sorted rows: data (b, n, d), head (b, n) bool (a
    row that starts a run). Returns (sums (b, n, d), runs (b,)): run k's sum
    in row k, its rows added left to right from its first; rows past the
    last run are 0."""
    b, n, d = data.shape
    run_id = torch.cumsum(head.long(), dim=1) - 1                    # (b, n)
    runs = head.sum(dim=1)
    iota = torch.arange(n, device=data.device).expand(b, n)
    # row index of each run's head, in run order (heads sort first)
    heads = torch.sort(torch.where(head, iota, n), dim=1).values     # (b, n)
    start = heads.gather(1, run_id)
    pos = iota - start                                                # position in run
    length = torch.zeros((b, n), dtype=torch.long, device=data.device)
    length.scatter_reduce_(1, run_id, pos + 1, reduce="amax")
    sums = torch.zeros_like(data)
    live = iota < runs[:, None]
    first = torch.clamp(heads, max=n - 1)
    for j in range(int(length.max()) if n else 0):
        rows = torch.clamp(first + j, max=n - 1)
        take = live & (j < length)
        add = data.gather(1, rows[..., None].expand(-1, -1, d))
        sums = torch.where(take[..., None], sums + add, sums)
    return sums, runs


def voxel_downsample(points: torch.Tensor, voxel_size: float
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """points (b, n, 3) f32 -> (voxels (b, n, 3), valid (b, n)): the first
    k rows hold the k occupied voxels' centroids in Morton order of their
    grid cells (relative to the cloud's lowest cell), the rest are 0."""
    b, n, _ = points.shape
    coords = torch.floor(points / voxel_size).to(torch.int32)
    rel = coords - coords.amin(dim=1, keepdim=True)
    order = torch.sort(morton_key(rel), dim=1, stable=True).indices
    rows = points.gather(1, order[..., None].expand(-1, -1, 3))
    cells = torch.floor(rows / voxel_size).to(torch.int32)
    head = torch.ones((b, n), dtype=torch.bool, device=points.device)
    head[:, 1:] = (cells[:, 1:] != cells[:, :-1]).any(dim=-1)
    ones = torch.ones((b, n, 1), dtype=points.dtype, device=points.device)
    sums, runs = run_sums(torch.cat([rows, ones], dim=-1), head)
    valid = torch.arange(n, device=points.device)[None, :] < runs[:, None]
    centroids = sums[..., :3] / torch.clamp(sums[..., 3], min=1.0)[..., None]
    return torch.where(valid[..., None], centroids, 0.0), valid
