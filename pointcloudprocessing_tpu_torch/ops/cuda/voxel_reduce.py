"""Sorted segment sum: the hand-written CUDA kernel and its plain version.

Counterpart of ``pointcloudprocessing_tpu/ops/pallas/voxel_reduce.py::
sorted_segment_reduce_pallas``. The TPU kernel contracts generated one-hot
slabs on the MXU with a bf16 hi/lo split of the data; on the H100 it is a
segmented prefix sum in plain fp32 over the contiguous runs, one block per
cloud, whose time does not depend on the run lengths
(``csrc/voxel_reduce.cu`` says why and how).

A CUDA tensor always goes to the kernel, and any failure raises; a CPU
tensor goes to the plain version.
"""

from __future__ import annotations

import torch

from pointcloudprocessing_tpu_torch.ops.cuda import build


def sorted_segment_reduce_reference(
    data: torch.Tensor, rank: torch.Tensor
) -> torch.Tensor:
    """Plain version: ``out[b, k, :] = sum(data[b, i, :] for rank[b, i] == k)``
    for any rank in [0, n); data (b, n, d) f32, rank (b, n) int -> (b, n, d)."""
    d = data.shape[-1]
    index = rank.long()[..., None].expand(-1, -1, d)
    return torch.zeros_like(data).scatter_add_(1, index, data)


def sorted_segment_reduce(data: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """Segment sum over a MONOTONE rank (non-decreasing along axis 1).

    data: (b, n, d) f32 with d in {4, 5}; rank: (b, n) int32 in [0, n).
    Returns (b, n, d) f32 with zeros for empty segments. The kernel checks
    the rank on the device (no host sync): a rank outside [0, n) or one
    that decreases traps, and the next CUDA call raises, as an index out of
    range does in PyTorch's own kernels (the CUDA context is then lost).
    """
    if data.device.type == "cpu":
        return sorted_segment_reduce_reference(data, rank)
    if data.device.type != "cuda":
        raise ValueError(f"no segment-sum kernel for device {data.device}")
    if data.dim() != 3 or data.shape[-1] not in (4, 5):
        raise ValueError(f"data must be (b, n, 4|5), got {tuple(data.shape)}")
    if rank.shape != data.shape[:2]:
        raise ValueError(
            f"rank {tuple(rank.shape)} does not match data {tuple(data.shape)}"
        )
    if data.dtype != torch.float32 or rank.dtype != torch.int32:
        raise TypeError(
            f"need f32 data and int32 rank, got {data.dtype} and {rank.dtype}"
        )
    if rank.device != data.device:
        raise ValueError("data and rank must be on the same device")
    if not (data.is_contiguous() and rank.is_contiguous()):
        raise ValueError("data and rank must be contiguous")
    b, n, d = data.shape
    out = torch.zeros_like(data)
    lib = build.load("voxel_reduce")
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.pcp_sorted_segment_sum(
            data.data_ptr(), rank.data_ptr(), out.data_ptr(), b, n, d, stream
        )
    build.check(lib, code, "sorted_segment_sum launch")
    sorted_segment_reduce.launches += 1
    return out


#: kernel launches in this process (CPU calls and refusals do not count)
sorted_segment_reduce.launches = 0
