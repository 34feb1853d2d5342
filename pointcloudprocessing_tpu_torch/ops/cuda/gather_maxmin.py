"""Neighbour max and min over gathered rows: the hand-written CUDA kernel and
its plain version.

Counterpart of ``pointcloudprocessing_tpu/ops/pallas/gather_maxmin.py::
gather_maxmin``, which the factored DGCNN edge block calls in inference.
The TPU kernel gathers along 128-lane vregs and wins only up to w = 96; on
the H100 a warp owns a point row and reads its neighbours' rows coalesced,
at any n and any w (``csrc/gather_maxmin.cu`` says why and how). f32 only:
bf16 compute is not ported yet.

A CUDA tensor always goes to the kernel, and any failure raises; a CPU
tensor goes to the plain version.
"""

from __future__ import annotations

import torch

from pointcloudprocessing_tpu_torch.ops.cuda import build
from pointcloudprocessing_tpu_torch.ops.gather import gather_rows


def gather_maxmin_reference(
    q: torch.Tensor, idx: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version, the JAX function's own fallback: gather the (b, n, k,
    w) neighbour rows, then max and min over k (NaN propagates)."""
    g = gather_rows(q, idx)
    return g.amax(dim=2), g.amin(dim=2)


def gather_maxmin(
    q: torch.Tensor, idx: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-point neighbour max and min: q (b, n, w) f32, idx (b, n, k) int32
    in [0, n) -> (qmax, qmin), each (b, n, w), exact. The kernel checks the
    indices on the device (no host sync): one outside [0, n) traps, and the
    next CUDA call raises (the CUDA context is then lost)."""
    if q.device.type == "cpu":
        return gather_maxmin_reference(q, idx)
    if q.device.type != "cuda":
        raise ValueError(f"no gather-max/min kernel for device {q.device}")
    if q.dim() != 3 or idx.dim() != 3 or idx.shape[:2] != q.shape[:2]:
        raise ValueError(
            f"need q (b, n, w) and idx (b, n, k), got {tuple(q.shape)} and "
            f"{tuple(idx.shape)}")
    if idx.shape[2] < 1:
        raise ValueError("idx needs at least one neighbour per point")
    if q.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(
            f"need f32 q and int32 idx, got {q.dtype} and {idx.dtype}")
    if idx.device != q.device:
        raise ValueError("q and idx must be on one device")
    if not (q.is_contiguous() and idx.is_contiguous()):
        raise ValueError("q and idx must be contiguous")
    b, n, w = q.shape
    k = idx.shape[2]
    qmax = torch.empty_like(q)
    qmin = torch.empty_like(q)
    lib = build.load("gather_maxmin")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.pcp_gather_maxmin(
            q.data_ptr(), idx.data_ptr(), qmax.data_ptr(), qmin.data_ptr(),
            b, n, w, k, stream,
        )
    build.check(lib, code, "gather_maxmin launch")
    gather_maxmin.launches += 1
    return qmax, qmin


#: kernel launches in this process (CPU calls and refusals do not count)
gather_maxmin.launches = 0
