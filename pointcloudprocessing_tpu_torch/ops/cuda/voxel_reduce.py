"""Segment sums: the two hand-written CUDA kernels, their plain versions and
the shape rule between them.

Counterparts of ``pointcloudprocessing_tpu/ops/pallas/voxel_reduce.py``:

- :func:`sorted_segment_reduce` (``sorted_segment_reduce_pallas``'s banded
  kernel): a monotone rank. The TPU kernel contracts generated one-hot slabs
  on the MXU with a bf16 hi/lo split of the data; on the H100 a block owns
  a tile of ``TILE_ROWS`` rows and the runs headed in it: a thread sums a
  run of up to ``SHORT_RUN`` rows in row order, the block a longer one,
  and each run's warp writes the empty rows below it as zeros, so the
  output needs no zero fill.
  :func:`sorted_sum_plan` spells out who writes which output row.
- :func:`segment_reduce` (``segment_reduce_pallas``): any rank. A stable
  counting sort per cloud, one block a cloud: per-warp counts of the ranks,
  a scan into segment starts, a stable placement of the row indices, then
  a thread adds each segment's rows in row order, so the sums equal
  PyTorch's CPU ``scatter_add_`` bit for bit. Ranks that never decrease
  (all that the voxel and stride paths give) are already in segment
  order, and the kernel then only finds each run's head.
  :func:`segment_sum_form` says where its working set lives: shared
  memory up to ``SHARED_MAX_ROWS`` rows a cloud, else a device-memory
  scratch.

``csrc/voxel_reduce.cu`` says why and how. :func:`monotone_segment_sum`, what
the voxel downsample and the stride sampler call, picks between the two as
the JAX package does. A CUDA tensor always goes to a kernel, and any
failure raises; a CPU tensor goes to the plain version.
"""

from __future__ import annotations

import torch

from pointcloudprocessing_tpu_torch.ops.cuda import build


def segment_reduce_reference(data: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """Plain version of both kernels: ``out[b, k, :] = sum(data[b, i, :] for
    rank[b, i] == k)`` for any rank in [0, n); data (b, n, d) f32, rank
    (b, n) int -> (b, n, d). One ``scatter_add_``, which on the CPU adds
    each segment's rows in row order."""
    d = data.shape[-1]
    index = rank.long()[..., None].expand(-1, -1, d)
    return torch.zeros_like(data).scatter_add_(1, index, data)


#: kernel 1's plain version: the same function, on a monotone rank
sorted_segment_reduce_reference = segment_reduce_reference


#: kernel 1's plan (``csrc/voxel_reduce.cu`` holds the same constants): a
#: block of WALK_THREADS threads owns TILE_ROWS rows of a cloud; a run of at
#: most SHORT_RUN rows is summed by its head's thread, a longer one by the
#: block, thread t adding rows head + t + j WALK_THREADS in order of j
TILE_ROWS = 1024
WALK_THREADS = 256
SHORT_RUN = 32


def sorted_sum_tiles(n: int) -> int:
    """Kernel 1's blocks a cloud of n rows: one a tile of ``TILE_ROWS``."""
    return -(-n // TILE_ROWS)


def sorted_sum_plan(rank) -> list[tuple[int, str, int, int, int]]:
    """Who writes each output row of one cloud in kernel 1, for a monotone
    rank (n,) in [0, n): ``(row, kind, tile, lo, hi)`` for each write, kind
    'thread' or 'block' for the sum of the run rows [lo, hi) (rank ``row``),
    summed by its head's thread or by the head's tile, or 'zero' for an
    empty row, written by the tile of the run above it (or of row n - 1
    above the last rank; lo = hi = that row): by the head's lane, or its
    warp where the empty range is long. ``tile`` is the owning block's
    tile, ``lo // TILE_ROWS`` for a run."""
    rank = [int(r) for r in rank]
    n = len(rank)
    writes = []
    for i, r in enumerate(rank):
        prev = rank[i - 1] if i else -1
        if prev != r:  # a head
            end = i + 1
            while end < n and rank[end] == r:
                end += 1
            kind = "thread" if end - i <= SHORT_RUN else "block"
            writes.append((r, kind, i // TILE_ROWS, i, end))
            writes += [(k, "zero", i // TILE_ROWS, i, i)
                       for k in range(prev + 1, r)]
    if n:
        writes += [(k, "zero", (n - 1) // TILE_ROWS, n - 1, n - 1)
                   for k in range(rank[-1] + 1, n)]
    return writes


#: the any-rank kernel's shared-memory form takes up to this many rows a
#: cloud (44 B a row of the 227 KB a block may have); above it the kernel
#: works in a device-memory scratch of SCRATCH_INTS int32 a row (a 32-bit
#: count for each of a block's 32 warps, a start, a permutation entry and
#: an earlier-rows count)
SHARED_MAX_ROWS = 5120
SCRATCH_INTS = 35
#: the most rows a cloud either segment-sum kernel takes
MAX_ROWS = 2**30


def segment_sum_form(n: int) -> str:
    """Where the any-rank kernel keeps a cloud of n rows: 'shared' up to
    ``SHARED_MAX_ROWS``, else 'global' (a scratch the wrapper allocates)."""
    if not 1 <= n <= MAX_ROWS:
        raise ValueError(f"the segment-sum kernels take 1..{MAX_ROWS} rows a "
                         f"cloud, got {n}")
    return "shared" if n <= SHARED_MAX_ROWS else "global"


def _check(data: torch.Tensor, rank: torch.Tensor, widths) -> None:
    if data.dim() != 3 or data.shape[-1] not in widths:
        raise ValueError(
            f"data must be (b, n, d) with d in {tuple(widths)}, got "
            f"{tuple(data.shape)}")
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
    if data.shape[1] > MAX_ROWS or data.shape[0] >= 2**31:
        raise ValueError(f"the segment-sum kernels take up to {MAX_ROWS} rows "
                         f"and 2^31 - 1 clouds, got {tuple(data.shape)}")


def _launch(entry: str, data: torch.Tensor, rank: torch.Tensor,
            out: torch.Tensor, *scratch, tiles: int | None = None) -> None:
    """Launch ``entry`` on PyTorch's current stream; ``scratch``: the
    pointers an entry takes between ``out`` and the shapes; ``tiles``: kernel
    1's tiles a cloud, which its entry takes after the shapes."""
    b, n, d = data.shape
    lib = build.load("voxel_reduce")
    grid = () if tiles is None else (tiles,)
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, entry)(
            data.data_ptr(), rank.data_ptr(), out.data_ptr(), *scratch, b, n,
            d, *grid, stream
        )
    build.check(lib, code, f"{entry} launch")


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
    _check(data, rank, (4, 5))
    out = torch.empty_like(data)  # the kernel writes every row
    _launch("pcp_sorted_segment_sum", data, rank, out,
            tiles=sorted_sum_tiles(data.shape[1]))
    sorted_segment_reduce.launches += 1
    return out


#: kernel launches in this process (CPU calls and refusals do not count)
sorted_segment_reduce.launches = 0


def segment_reduce(data: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """Segment sum for ANY rank: ``out[b, k, :]`` is the sum of the rows with
    ``rank[b, i] == k``, added in row order, 0 for an empty segment.

    data: (b, n, d) f32 with 1 <= d <= 8; rank: (b, n) int32 in [0, n), in
    any order; n <= ``MAX_ROWS``. The kernel checks the rank on the device:
    one outside [0, n) traps, and the next CUDA call raises (the CUDA
    context is then lost).
    """
    if data.device.type == "cpu":
        return segment_reduce_reference(data, rank)
    if data.device.type != "cuda":
        raise ValueError(f"no segment-sum kernel for device {data.device}")
    _check(data, rank, range(1, 9))
    out = torch.empty_like(data)  # the kernel writes every row
    b, n, _ = data.shape
    scratch = None
    if n and segment_sum_form(n) == "global":
        scratch = torch.empty((b, SCRATCH_INTS * n), dtype=torch.int32,
                              device=data.device)
    _launch("pcp_segment_sum", data, rank, out,
            None if scratch is None else scratch.data_ptr())
    segment_reduce.launches += 1
    return out


#: kernel launches in this process (CPU calls and refusals do not count)
segment_reduce.launches = 0


def monotone_segment_sum(data: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """The segment sum of the voxel downsample and the stride sampler (rank
    monotone): :func:`segment_reduce` when 128 does not divide n, else
    :func:`sorted_segment_reduce`. Each counts its own launches.

    The rule of ``sorted_segment_reduce_pallas``
    (``pointcloudprocessing_tpu/ops/pallas/voxel_reduce.py:151-159``): its
    banded kernel needs an output tile (a multiple of 8 dividing n) and a
    row chunk (a multiple of 128 dividing n), so every other n goes to the
    dense any-rank kernel. The port's banded kernel takes any n; the rule
    is kept so that both packages run the same kernel at the same shape.
    """
    if data.shape[1] % 128:
        return segment_reduce(data, rank)
    return sorted_segment_reduce(data, rank)
