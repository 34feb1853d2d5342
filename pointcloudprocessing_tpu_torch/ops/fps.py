"""Farthest-point sampling and the stride sampler
(``pointcloudprocessing_tpu/ops/fps.py``).

On a CUDA tensor FPS runs the hand-written kernel (``ops/cuda/fps``) and
the stride sampler rides the segment-sum kernels (``ops/cuda/voxel_reduce``);
on a CPU tensor both take the kernels' plain versions. ``method='distmat'``
and ``'stream'`` of :func:`farthest_point_sample_batch` are plain PyTorch on
any device.
"""

from __future__ import annotations

import torch

from pointcloudprocessing_tpu_torch.ops.cuda.fps import (
    fps,
    fps_with_points,
    fps_with_points_reference,
)
from pointcloudprocessing_tpu_torch.ops.cuda.voxel_reduce import (
    monotone_segment_sum,
)

#: largest (b, n, n) f32 distance matrix 'auto' builds on the CPU, by default
_DEFAULT_DISTMAT_BYTES = 2 * 1024**3


def _seed_indices(valid_mask: torch.Tensor, start_index: int) -> torch.Tensor:
    """Per-cloud seed: ``start_index`` if valid, else the first valid point."""
    b = valid_mask.shape[0]
    start = torch.full((b,), start_index, dtype=torch.int32,
                       device=valid_mask.device)
    fallback = valid_mask.to(torch.uint8).argmax(dim=1).to(torch.int32)
    return torch.where(valid_mask[:, start_index], start, fallback)


def _distmat_fps(
    points: torch.Tensor, num_samples: int, valid_mask: torch.Tensor,
    start: torch.Tensor,
) -> torch.Tensor:
    """FPS over a precomputed pairwise squared-distance matrix (b, n, n)."""
    n = points.shape[1]
    sq = (points * points).sum(dim=-1)
    gram = points @ points.transpose(1, 2)
    dist = sq[:, :, None] + sq[:, None, :] - 2.0 * gram
    neg = torch.tensor(float("-inf"), dtype=points.dtype, device=points.device)
    min_dist = torch.full_like(sq, float("inf"))
    cur = start.long()
    picks = [cur]
    for _ in range(1, num_samples):
        row = dist.gather(1, cur[:, None, None].expand(-1, 1, n))[:, 0]
        min_dist = torch.minimum(min_dist, row)
        cur = torch.where(valid_mask, min_dist, neg).argmax(dim=-1)
        picks.append(cur)
    return torch.stack(picks, dim=1).int()


def _loop_fps(
    points: torch.Tensor, num_samples: int, valid_mask: torch.Tensor,
    start: torch.Tensor,
) -> torch.Tensor:
    """The kernel's plain version (``fps_with_points_reference``), the same
    arithmetic, as one ``while_loop`` for ``torch.export``: the traced
    program keeps FPS as a loop, as the JAX package's export keeps its
    ``fori_loop``, where the Python loop would unroll num_samples steps into
    the graph. Not for eager use (``while_loop`` then compiles)."""
    from torch._higher_order_ops.while_loop import while_loop

    neg = torch.tensor(float("-inf"), dtype=points.dtype, device=points.device)
    slots = torch.arange(num_samples, device=points.device)
    cur = start.long()

    def more(i, cur, min_dist, picks):
        return i < num_samples

    def step(i, cur, min_dist, picks):
        # the closure holds whole tensors only: while_loop refuses two views
        # of one tensor as inputs
        diff = points - points.gather(1, cur[:, None, None].expand(-1, 1, 3))
        dx, dy, dz = diff.unbind(-1)
        min_dist = torch.minimum(min_dist, dx * dx + dy * dy + dz * dz)
        cur = torch.where(valid_mask, min_dist, neg).argmax(dim=1)
        return i + 1, cur, min_dist, torch.where(slots == i, cur[:, None], picks)

    carry = (torch.ones((), dtype=torch.long, device=points.device), cur,
             torch.full_like(points[..., 0], float("inf")),
             cur[:, None].expand(-1, num_samples).clone())
    return while_loop(more, step, carry)[3].int()


def farthest_point_sample_batch(
    points: torch.Tensor,
    num_samples: int,
    valid_mask: torch.Tensor | None = None,
    start_index: int = 0,
    method: str = "auto",
    max_distmat_bytes: int = _DEFAULT_DISTMAT_BYTES,
) -> torch.Tensor:
    """FPS over a batch of padded clouds: (b, n, 3) -> (b, num_samples) int32.

    Args:
      valid_mask: optional (b, n) bool; invalid points are never selected.
      start_index: seed index (the first valid point of a cloud whose seed
        row is invalid).
      method: 'auto' (the kernel on a CUDA tensor; on the CPU 'distmat'
        while b*n*n*4 bytes fit ``max_distmat_bytes``, else 'stream', and
        under ``torch.export`` the stream form as one loop), 'distmat' or
        'stream'.
      max_distmat_bytes: the CPU 'auto' rule's budget (2 GiB).

    With fewer valid points than num_samples, picks repeat.
    """
    b, n = points.shape[:2]
    if valid_mask is None:
        valid_mask = torch.ones((b, n), dtype=torch.bool, device=points.device)
    start = _seed_indices(valid_mask, start_index)
    if method == "auto":
        if points.is_cuda:
            return fps(points, num_samples, valid_mask, start)
        if torch.compiler.is_exporting():
            # a traced program (export/pt2.py): the byte budget would pin a
            # symbolic batch, and the Python loop would unroll
            return _loop_fps(points, num_samples, valid_mask, start)
        method = ("distmat" if b * n * n * 4 <= max_distmat_bytes
                  else "stream")
    if method == "distmat":
        return _distmat_fps(points, num_samples, valid_mask, start)
    if method == "stream":
        return fps_with_points_reference(points, num_samples, valid_mask, start)[0]
    raise ValueError(f"Unknown method {method!r}")


def farthest_point_sample_and_gather(
    points: torch.Tensor,
    num_samples: int,
    valid_mask: torch.Tensor | None = None,
    start_index: int = 0,
    chains: int = 1,
    layout: str = "bnc",
) -> tuple[torch.Tensor, torch.Tensor]:
    """FPS returning (indices (b, k) int32, sampled points (b, k, 3) f32).

    ``layout='bcn'`` takes plane-major (b, 3, n) points, as
    ``voxel_downsample_batch(layout='bcn')`` returns them; the sampled
    output stays (b, k, 3) for the model.

    ``chains > 1`` runs blocked FPS: each cloud splits into ``chains``
    stride-striped subsets (subset c owns the rows j with j % chains == c),
    sampled independently to ``num_samples / chains`` points each, all of
    them in one FPS call over b * chains clouds (one kernel launch on
    CUDA), which cuts the serial selection loop by ``chains``. On the
    Morton-ordered voxel output each subset is a stratified sample, so the
    union is nearly as well spread as exact FPS. Use it only when every
    cloud has far more valid points than ``num_samples``: a subset with
    no valid point contributes padding rows. Exact FPS is the default.
    """
    if layout not in ("bnc", "bcn"):
        raise ValueError(f"Unknown layout {layout!r}")
    b = points.shape[0]
    n = points.shape[2] if layout == "bcn" else points.shape[1]
    if valid_mask is None:
        valid_mask = torch.ones((b, n), dtype=torch.bool, device=points.device)
    if chains > 1:
        if layout == "bcn":  # the stripes are row-major
            points = points.transpose(1, 2)
        return _blocked_fps_and_gather(points, num_samples, valid_mask, chains)
    start = _seed_indices(valid_mask, start_index)
    return fps_with_points(points, num_samples, valid_mask, start, layout=layout)


# copied from pointcloudprocessing_tpu/ops/fps.py::_blocked_fps_and_gather
def _blocked_fps_and_gather(
    points: torch.Tensor, num_samples: int, valid_mask: torch.Tensor, chains: int
) -> tuple[torch.Tensor, torch.Tensor]:
    b, n = points.shape[:2]
    if n % chains or num_samples % chains:
        raise ValueError(
            f"blocked FPS needs chains ({chains}) dividing both n ({n}) and "
            f"num_samples ({num_samples})"
        )
    m, k = n // chains, num_samples // chains
    # subset c owns original indices j with j % chains == c
    p_r = points.reshape(b, m, chains, 3).movedim(2, 1).reshape(b * chains, m, 3)
    v_r = valid_mask.reshape(b, m, chains).movedim(2, 1).reshape(b * chains, m)
    idx_r, sampled_r = farthest_point_sample_and_gather(p_r, k, v_r)
    chain_of = torch.arange(b * chains, dtype=torch.int32,
                            device=points.device)[:, None] % chains
    idx = (idx_r * chains + chain_of).reshape(b, num_samples)
    sampled = sampled_r.reshape(b, num_samples, 3)
    return idx, sampled


def farthest_point_sample(
    points: torch.Tensor,
    num_samples: int,
    valid_mask: torch.Tensor | None = None,
    start_index: int = 0,
    method: str = "auto",
) -> torch.Tensor:
    """Single-cloud FPS: (n, 3) -> (num_samples,) int32 indices."""
    mask = None if valid_mask is None else valid_mask[None]
    return farthest_point_sample_batch(
        points[None], num_samples, mask, start_index, method
    )[0]


def stride_sample_and_gather(
    points: torch.Tensor,
    num_samples: int,
    valid_mask: torch.Tensor | None = None,
    layout: str = "bnc",
) -> tuple[torch.Tensor, torch.Tensor]:
    """O(n) stratified sampling along the input order: the serving-path
    alternative to FPS's serial selection loop.

    On the Morton-ordered voxel output, evenly spaced picks along the index
    axis are a stratified spatial sample. Requires the valid rows to be
    packed first (true for voxel output). Valid row j maps to the monotone
    bucket floor(j*k/nv); the first row of each bucket is extracted by the
    segment sum. With fewer than ``num_samples`` valid rows some buckets get
    no row; they repeat the previous pick (forward fill), so no phantom zero
    points appear.

    Returns (indices (b, k) int32, sampled (b, k, 3) f32).
    """
    if layout == "bcn":
        points = points.transpose(1, 2)
    elif layout != "bnc":
        raise ValueError(f"Unknown layout {layout!r}")
    b, n = points.shape[:2]
    k = num_samples
    device = points.device
    if valid_mask is None:
        valid_mask = torch.ones((b, n), dtype=torch.bool, device=device)
    nv = torch.clamp(valid_mask.sum(dim=1), min=1)  # (b,)
    j = torch.arange(n, device=device)
    bucket = torch.clamp((j[None, :] * k) // nv[:, None], max=k - 1)
    bucket = torch.where(valid_mask, bucket, n - 1).to(torch.int32)
    first = torch.ones((b, 1), dtype=torch.bool, device=device)
    is_new = torch.cat([first, bucket[:, 1:] != bucket[:, :-1]], dim=1) & valid_mask
    w = is_new.to(points.dtype)[..., None]
    # channels: xyz, source index, and a filled flag that survives the sum as
    # 1.0 for buckets that received a first row and 0.0 for skipped ones
    data = torch.cat(
        [points * w, j.to(points.dtype)[None, :, None] * w, w], dim=-1
    )
    reduced = monotone_segment_sum(data, bucket)
    picks = reduced[:, :k, :4]
    filled = reduced[:, :k, 4] > 0.5
    # forward fill: each bucket takes the nearest filled bucket at or before
    # it; before the first filled bucket it keeps its own (zero) row
    slot = torch.arange(k, device=device).expand(b, k)
    src = torch.cummax(torch.where(filled, slot, -1), dim=1).values
    src = torch.where(src < 0, slot, src)
    picks = picks.gather(1, src[..., None].expand(-1, -1, 4))
    return picks[..., 3].to(torch.int32), picks[..., :3]
