"""Farthest-point sampling: the hand-written CUDA kernel and its plain version.

Counterpart of ``pointcloudprocessing_tpu/ops/pallas/fps.py::
fps_pallas_with_points`` (and its index-only wrapper ``fps_pallas``). On the
TPU the selection loop keeps a block of clouds in VMEM; on the H100 the
bound is the latency of one selection step (``csrc/fps.cu`` says why and
how). Three kernel forms, chosen by :func:`kernel_form`: up to
``BLOCK_MAX_POINTS`` points a cloud one thread block holds the cloud's
valid rows in registers; up to ``CLUSTER_MAX_POINTS`` a thread-block
cluster of up to ``MAX_CLUSTER`` blocks shares it through distributed
shared memory; above
that the coordinates are read from device memory and the min distances
kept in a (b, n) scratch. All give the plain version's picks and
coordinates bit for bit, NaN included (a NaN distance keeps its point's
score NaN, and NaN wins the argmax, as ``jnp.argmax`` has it). Outputs are
(b, K) directly: the JAX kernel's (K, b) layout is a TPU store rule.

A CUDA tensor of any n >= 1 goes to a kernel, and any failure raises; a CPU
tensor goes to the plain version.
"""

from __future__ import annotations

import torch

from pointcloudprocessing_tpu_torch.ops.cuda import build

#: the most points one block holds: 1,024 threads with 8 points each in
#: registers (a thread may have at most 64 registers at 1,024 a block)
BLOCK_MAX_POINTS = 8192
#: the portable cluster size, and the most points a cluster form holds
MAX_CLUSTER = 8
CLUSTER_MAX_POINTS = MAX_CLUSTER * BLOCK_MAX_POINTS
#: the H100 SXM's SMs: clusters of MAX_CLUSTER blocks for up to this many
#: blocks a batch, one wave at a block an SM
_SMS = 132


def kernel_form(b: int, n: int) -> tuple[str, int]:
    """The FPS kernel for b clouds of n points and its blocks a cloud:
    'block' (``pcp_fps``, one block) up to ``BLOCK_MAX_POINTS``; 'cluster'
    (``pcp_fps``, a thread-block cluster) up to ``CLUSTER_MAX_POINTS``;
    else 'global' (``pcp_fps_large``, coordinates in device memory, one
    block). A cluster's barrier costs about the same at any cluster size,
    so a small batch takes ``MAX_CLUSTER`` blocks a cloud (fewer points a
    block, a shorter step); a batch whose clusters of that size would not
    fit the card at once takes the fewest blocks that hold a cloud
    (``PERF.md``)."""
    if n < 1:
        raise ValueError(f"FPS needs at least one point a cloud, got {n}")
    if n <= BLOCK_MAX_POINTS:
        return "block", 1
    if n <= CLUSTER_MAX_POINTS:
        if b * MAX_CLUSTER <= _SMS:
            return "cluster", MAX_CLUSTER
        return "cluster", -(-n // BLOCK_MAX_POINTS)
    return "global", 1


def _planes(points: torch.Tensor, layout: str) -> torch.Tensor:
    """(b, 3, n) f32 coordinate planes from either layout."""
    if layout == "bcn":
        return points.float()
    if layout == "bnc":
        return points.float().transpose(1, 2)
    raise ValueError(f"Unknown layout {layout!r}")


def fps_with_points_reference(
    points: torch.Tensor,
    num_samples: int,
    valid_mask: torch.Tensor,
    start: torch.Tensor,
    layout: str = "bnc",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version, the streaming form of the JAX kernel's semantics:
    running min of direct-difference squared distances (``torch.minimum``,
    which propagates NaN), invalid points score -inf, argmax with NaN first
    and ties to the lowest index. Returns (indices (b, K) int32, sampled
    (b, K, 3) f32)."""
    xs, ys, zs = _planes(points, layout).unbind(1)
    valid = valid_mask.bool()
    cur = start.long()
    min_dist = torch.full_like(xs, float("inf"))
    neg = torch.tensor(float("-inf"), dtype=xs.dtype, device=xs.device)
    picks = [cur]
    for _ in range(1, num_samples):
        last = cur[:, None]
        dx = xs - xs.gather(1, last)
        dy = ys - ys.gather(1, last)
        dz = zs - zs.gather(1, last)
        d = dx * dx + dy * dy + dz * dz
        min_dist = torch.minimum(min_dist, d)
        cur = torch.where(valid, min_dist, neg).argmax(dim=1)
        picks.append(cur)
    idx = torch.stack(picks, dim=1)
    sampled = torch.stack(
        [xs.gather(1, idx), ys.gather(1, idx), zs.gather(1, idx)], dim=-1
    )
    return idx.int(), sampled


def fps_with_points(
    points: torch.Tensor,
    num_samples: int,
    valid_mask: torch.Tensor,
    start: torch.Tensor,
    layout: str = "bnc",
) -> tuple[torch.Tensor, torch.Tensor]:
    """FPS over a batch: points (b, n, 3) (or (b, 3, n) with
    ``layout='bcn'``) f32, valid (b, n) bool, start (b,) int32 seeds ->
    (indices (b, K) int32, sampled (b, K, 3) f32). Seeds come from
    ``ops.fps._seed_indices``; the kernel checks them on the device (no host
    sync): a seed outside [0, n) traps, and the next CUDA call raises (the
    CUDA context is then lost). Any n >= 1: :func:`kernel_form` picks the
    kernel."""
    if points.device.type == "cpu":
        return fps_with_points_reference(
            points, num_samples, valid_mask, start, layout
        )
    if points.device.type != "cuda":
        raise ValueError(f"no FPS kernel for device {points.device}")
    if layout not in ("bnc", "bcn"):
        raise ValueError(f"Unknown layout {layout!r}")
    if points.dim() != 3 or points.shape[1 if layout == "bcn" else 2] != 3:
        raise ValueError(
            f"points must be {'(b, 3, n)' if layout == 'bcn' else '(b, n, 3)'}, "
            f"got {tuple(points.shape)}"
        )
    b = points.shape[0]
    n = points.shape[2] if layout == "bcn" else points.shape[1]
    form, cluster = kernel_form(b, n)
    if num_samples < 1:
        raise ValueError(f"num_samples must be >= 1, got {num_samples}")
    if valid_mask.shape != (b, n) or start.shape != (b,):
        raise ValueError(
            f"valid_mask {tuple(valid_mask.shape)} / start {tuple(start.shape)} "
            f"do not match {b} clouds of {n} points"
        )
    if (
        points.dtype != torch.float32
        or valid_mask.dtype != torch.bool
        or start.dtype != torch.int32
    ):
        raise TypeError(
            "need f32 points, bool valid_mask and int32 start, got "
            f"{points.dtype}, {valid_mask.dtype}, {start.dtype}"
        )
    if valid_mask.device != points.device or start.device != points.device:
        raise ValueError("points, valid_mask and start must be on one device")
    if not (
        points.is_contiguous() and valid_mask.is_contiguous()
        and start.is_contiguous()
    ):
        raise ValueError("points, valid_mask and start must be contiguous")
    idx = torch.empty((b, num_samples), dtype=torch.int32, device=points.device)
    sampled = torch.empty(
        (b, num_samples, 3), dtype=torch.float32, device=points.device
    )
    lib = build.load("fps")
    pointers = (points.data_ptr(), valid_mask.data_ptr(), start.data_ptr(),
                idx.data_ptr(), sampled.data_ptr())
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream().cuda_stream
        if form != "global":
            code = lib.pcp_fps(*pointers, b, n, num_samples,
                               int(layout == "bcn"), cluster, stream)
        else:
            min_dist = torch.empty((b, n), dtype=torch.float32,
                                   device=points.device)
            code = lib.pcp_fps_large(*pointers, min_dist.data_ptr(), b, n,
                                     num_samples, int(layout == "bcn"), stream)
    build.check(lib, code, "fps launch")
    fps_with_points.launches += 1
    return idx, sampled


#: kernel launches in this process (CPU calls and refusals do not count)
fps_with_points.launches = 0


def fps(
    points: torch.Tensor,
    num_samples: int,
    valid_mask: torch.Tensor,
    start: torch.Tensor,
) -> torch.Tensor:
    """Index-only variant of :func:`fps_with_points` (``fps_pallas``)."""
    idx, _ = fps_with_points(points, num_samples, valid_mask, start)
    return idx
