"""Neighbour max and min over gathered rows: the hand-written CUDA kernel and
its plain version.

Counterpart of ``pointcloudprocessing_tpu/ops/pallas/gather_maxmin.py::
gather_maxmin``, which the factored DGCNN edge block calls in inference.
The TPU kernel stages a cloud's q in VMEM and gathers along 128-lane vregs,
winning only up to w = 96; on the H100 a block stages one cloud's slice of
S channels in shared memory and gathers there, at any n and any w
(``csrc/gather_maxmin.cu`` says why and how). :func:`gather_form` picks S,
or the L2 form for clouds too large for any slice. q may be f32 or bf16
(the TPU kernel's two dtypes); a bf16 slice holds twice the channels in the
same bytes.

A CUDA tensor always goes to the kernel, and any failure raises; a CPU
tensor goes to the plain version.
"""

from __future__ import annotations

import math

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


#: dynamic shared memory an H100 block may have, in bytes
SHARED_BYTES = 232_448
#: the shared form's channel slices in f32, largest first (128 to 16 bytes
#: a row; a bf16 slice holds twice the channels)
SLICES = (32, 16, 8, 4)
#: the shared form takes a smaller slice while the larger one gives fewer
#: blocks than this, about one an SM of the H100's 132: at 64 clouds of
#: 1,024 points and w 64, S 32's 128 blocks (one 128 KB block an SM, no
#: bank conflicts) beat S 16's 256; at 16 clouds S 8's 128 beat S 32's 32
MIN_BLOCKS = 128


def gather_form(b: int, n: int, w: int, itemsize: int = 4) -> tuple[str, int]:
    """The kernel's form for b clouds of n points and w channels of
    ``itemsize`` bytes (4: f32, 2: bf16): ('shared', S) stages each cloud's
    channels in slices of S elements in shared memory, the largest S of
    ``SLICES`` (scaled by 4 / itemsize; at most w rounded up to a power of
    two) whose n x S elements fit ``SHARED_BYTES`` and that gives at least
    ``MIN_BLOCKS`` blocks (b x ceil(w / S)); if none gives that many, the
    smallest that fits. ('l2', 0) where no slice fits (n > 14,528 in either
    type): a warp a point row, gathering from device memory through L2."""
    if b < 1 or n < 1 or w < 1:
        raise ValueError(f"gather_form needs b, n, w >= 1, got {b}, {n}, {w}")
    if itemsize not in (2, 4):
        raise ValueError(f"gather_form takes 2- or 4-byte elements, got {itemsize}")
    slices = [s * 4 // itemsize for s in SLICES]
    cap = max(slices[-1], 1 << (w - 1).bit_length())
    fits = [s for s in slices if s <= cap and n * s * itemsize <= SHARED_BYTES]
    if not fits:
        return "l2", 0
    return "shared", next(
        (s for s in fits if b * math.ceil(w / s) >= MIN_BLOCKS), fits[-1])


def gather_maxmin(
    q: torch.Tensor, idx: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-point neighbour max and min: q (b, n, w) f32 or bf16, idx (b, n,
    k) int32 in [0, n) -> (qmax, qmin), each (b, n, w) of q's type, exact.
    The kernel checks the
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
    if q.dtype not in (torch.float32, torch.bfloat16) or idx.dtype != torch.int32:
        raise TypeError(
            f"need f32 or bf16 q and int32 idx, got {q.dtype} and {idx.dtype}")
    if idx.device != q.device:
        raise ValueError("q and idx must be on one device")
    if not (q.is_contiguous() and idx.is_contiguous()):
        raise ValueError("q and idx must be contiguous")
    b, n, w = q.shape
    form = gather_form(b, n, w, q.element_size()) if q.numel() else ("l2", 0)
    out = launch(q, idx, form)
    if q.dtype == torch.bfloat16:
        gather_maxmin.launches_bf16 += 1
    else:
        gather_maxmin.launches += 1
    return out


def launch(q: torch.Tensor, idx: torch.Tensor,
           form: tuple[str, int]) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel in ``form`` (as :func:`gather_form` gives it) on
    checked CUDA tensors; counts nothing. :func:`gather_maxmin` is the
    entry point; tools time other forms through this."""
    b, n, w = q.shape
    k = idx.shape[2]
    qmax = torch.empty_like(q)
    qmin = torch.empty_like(q)
    lib = build.load("gather_maxmin")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        entry = (lib.pcp_gather_maxmin_bf16 if q.dtype == torch.bfloat16
                 else lib.pcp_gather_maxmin)
        code = entry(
            q.data_ptr(), idx.data_ptr(), qmax.data_ptr(), qmin.data_ptr(),
            b, n, w, k, form[1], stream,
        )
    build.check(lib, code, "gather_maxmin launch")
    return qmax, qmin


#: kernel launches in this process, f32 and bf16 forms (CPU calls and
#: refusals do not count)
gather_maxmin.launches = 0
gather_maxmin.launches_bf16 = 0
