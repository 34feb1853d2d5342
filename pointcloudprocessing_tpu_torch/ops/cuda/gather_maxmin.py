"""Neighbour max and min over gathered rows: the hand-written CUDA kernel and
its plain version.

Counterpart of ``pointcloudprocessing_tpu/ops/pallas/gather_maxmin.py::
gather_maxmin``, which the factored DGCNN edge block calls in inference.
The TPU kernel stages a cloud's q in VMEM and gathers along 128-lane vregs,
winning only up to w = 96; on the H100 a block stages one cloud's slice of
channels in shared memory and gathers there, at any n and any w
(``csrc/gather_maxmin.cu`` says why and how). q may be f32 or bf16 (the TPU
kernel's two dtypes). :func:`gather_plan` picks the launches: in bf16 the
ring form (persistent blocks, slices of 128-byte rows copied by TMA while
the previous slice is gathered), in f32 the shared form of
:func:`gather_form`, and the L2 form for clouds too large for any slice.

A CUDA tensor always goes to the kernel, and any failure raises; a CPU
tensor goes to the plain version.
"""

from __future__ import annotations

import functools
import math
from fractions import Fraction
from typing import NamedTuple

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
    """The shared form's slice for b clouds of n points and w channels of
    ``itemsize`` bytes (4: f32, 2: bf16; f32's plan, and bf16's where the
    ring form does not take the shape): ('shared', S) stages each cloud's
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


#: the ring form's row widths in bytes, widest first (64, 32, 16 or 8 bf16
#: channels a slice)
RING_ROW_BYTES = (128, 64, 32, 16)
#: the ring form's threads a block (one block an SM)
RING_THREADS = 1024
#: SMs of the H100 (the wrapper reads the card's own count)
SMS = 132


def ring_box_rows(row_bytes: int) -> int:
    """Rows a TMA box of the ring form copies: 8 KB, at most 256 rows."""
    return min(256, 8192 // row_bytes)


def ring_rows(row_bytes: int) -> int:
    """Rows of ``row_bytes`` bytes a ring block holds: whole boxes in a
    block's shared memory less its two 8-byte mbarriers
    (``csrc/gather_maxmin.cu``'s ``Ring``): 1,792 rows of 128 bytes, 3,584
    of 64, 7,168 of 32, 14,336 of 16."""
    box = ring_box_rows(row_bytes)
    return (SHARED_BYTES - 16) // row_bytes // box * box


def ring_parts(slabs: int, n: int, row_bytes: int, sms: int = SMS) -> int:
    """Point ranges a slab is cut into: the count p that minimises the
    busiest block's share of a slab's gather, ceil(slabs p / sms) / p, the
    fewest on a tie (each range stages the whole slab again, from L2), and
    each range at least one round of the block's warps (128 points at 128
    bytes a row, 1,024 at 16)."""
    most = max(1, n // (RING_THREADS * 16 // row_bytes))
    return min(range(1, most + 1),
               key=lambda p: (Fraction(-(-slabs * p // sms), p), p))


class Launch(NamedTuple):
    """One kernel launch of a plan."""

    form: str  #: "ring", "shared" or "l2"
    slice: int  #: channels a slice (0 in the L2 form)
    c_begin: int  #: the launch's first channel
    slices: int  #: slices a cloud (0 in the L2 form)
    parts: int  #: point ranges a slab (the ring form; else 1)
    blocks: int  #: the grid: persistent blocks in the ring form

    def tiles(self, b: int) -> int:
        """Tiles (cloud, slice, point range) of a ring launch over b clouds."""
        return b * self.slices * self.parts


def _ring_launch(b: int, n: int, row_bytes: int, c_begin: int, slices: int,
                 sms: int) -> Launch:
    parts = ring_parts(b * slices, n, row_bytes, sms)
    return Launch("ring", row_bytes // 2, c_begin, slices, parts,
                  min(b * slices * parts, sms))


@functools.lru_cache(maxsize=None)  # a pure function of its ints, called a launch
def gather_plan(b: int, n: int, w: int, itemsize: int = 4, sms: int = SMS,
                aligned: bool = True) -> tuple[Launch, ...]:
    """The launches for b clouds of n points and w channels of ``itemsize``
    bytes (4: f32, 2: bf16) on a card of ``sms`` SMs.

    bf16 with w a multiple of 8 and 16-byte aligned q (``aligned``) takes
    the ring form where n <= 1,792 (a slab of 128-byte rows fits a block):
    slices of 64 channels over w's full 64s, then one launch over the rest
    in the narrowest rows that hold it (16 to 64 bytes; w < 64 in the
    narrowest that hold w). Past 1,792 points a slab takes narrower rows
    (the widest whose slab fits, at most w rounded up to a power of two);
    the ring form cuts such slabs into point ranges only where there are
    at most half as many as SMs, and otherwise gives way to
    :func:`gather_form`'s shared form (the same rows, a block a slab: as
    fast there, ``tools/gather_bench.py``). Each ring launch cuts a slab
    into :func:`ring_parts` point ranges and runs min(tiles, sms)
    persistent blocks. f32, and every other bf16 case, takes
    :func:`gather_form`'s single launch: ('shared', S) in slices of S, or
    the L2 form."""
    if b < 1 or n < 1 or w < 1:
        raise ValueError(f"gather_plan needs b, n, w >= 1, got {b}, {n}, {w}")
    if itemsize == 2 and w % 8 == 0 and aligned and n <= ring_rows(16):
        widest = next(rb for rb in RING_ROW_BYTES if n <= ring_rows(rb))
        full = w // 64 if widest == 128 else 0
        rest = w - 64 * full
        rb = min(widest, max(16, 1 << (2 * rest - 1).bit_length())) if rest else 0
        slices = math.ceil(rest / (rb // 2)) if rest else 0
        if widest == 128 or b * slices <= sms // 2:
            plan = [_ring_launch(b, n, 128, 0, full, sms)] if full else []
            if rest:
                plan.append(_ring_launch(b, n, rb, 64 * full, slices, sms))
            return tuple(plan)
    form, s = gather_form(b, n, w, itemsize)
    if form == "l2":
        return (Launch("l2", 0, 0, 0, 1, math.ceil(b * n / 8)),)
    slices = math.ceil(w / s)
    return (Launch("shared", s, 0, slices, 1, b * slices),)


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
    plan = (gather_plan(b, n, w, q.element_size(), build.sms(q.device),
                        q.data_ptr() % 16 == 0)
            if q.numel() else (Launch("l2", 0, 0, 0, 1, 0),))
    out = launch(q, idx, plan)
    build.count("gather_maxmin_bf16" if q.dtype == torch.bfloat16 else "gather_maxmin")
    return out


def launch(q: torch.Tensor, idx: torch.Tensor,
           plan: tuple[Launch, ...]) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel as ``plan`` (as :func:`gather_plan` gives it) says,
    on checked CUDA tensors; counts nothing. :func:`gather_maxmin` is the
    entry point; tools time other plans through this."""
    b, n, w = q.shape
    k = idx.shape[2]
    qmax = torch.empty_like(q)
    qmin = torch.empty_like(q)
    bf16 = q.dtype == torch.bfloat16
    ptrs = (q.data_ptr(), idx.data_ptr(), qmax.data_ptr(), qmin.data_ptr())
    for step in plan:
        if step.form == "ring":
            if not bf16:
                raise TypeError("the ring form takes bf16 q only")
            build.launch("pcp_gather_maxmin_bf16_ring", q.device,
                         *ptrs, b, n, w, k, 2 * step.slice, step.c_begin,
                         step.slices, step.parts, step.blocks)
        else:
            build.launch("pcp_gather_maxmin_bf16" if bf16 else "pcp_gather_maxmin",
                         q.device, *ptrs, b, n, w, k, step.slice)
    return qmax, qmin
