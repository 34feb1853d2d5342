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
- :func:`segment_reduce` (``segment_reduce_pallas``): any rank. Each
  segment's rows are found in row order (the runs of a rank in order, or a
  stable sort by rank) and added in that order from 0, so the sums equal
  PyTorch's CPU ``scatter_add_`` bit for bit; a segment longer than
  ``SHORT_WALK`` rows is walked by a whole warp, a lane a component.
  :func:`segment_sum_form` picks the form by b and n: one block a cloud in
  shared memory up to ``SHARED_MAX_ROWS``, a thread-block cluster of 2 to
  ``CLUSTER_BLOCKS`` blocks a cloud (as many as one wave holds) up to
  ``CLUSTER_MAX_ROWS``, tiles of ``GLOBAL_TILE_ROWS`` rows and a
  device-memory scratch (:func:`segment_scratch_ints`) above.
  :func:`segment_walk_plan` spells out who writes which output row.

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


#: kernel 3's forms (``csrc/voxel_reduce.cu`` holds the same constants):
#: 'shared' (one block a cloud, 44 B a row of the 227 KB a block may have,
#: up to SHARED_MAX_ROWS rows); 'cluster' up to CLUSTER_MAX_ROWS (a
#: thread-block cluster of 2 to CLUSTER_BLOCKS blocks a cloud, block j
#: holding rows [j m, j m + m), each at most SHARED_MAX_ROWS); 'global'
#: above: tiles of GLOBAL_TILE_ROWS rows, then, for a cloud whose ranks are
#: out of order, one block a cloud over a device-memory scratch of
#: SCRATCH_INTS int32 a row (a 32-bit count for each of a block's 32 warps,
#: a start, a permutation entry and an earlier-rows count) and a flag a tile
SHARED_MAX_ROWS = 5120
CLUSTER_BLOCKS = 8
CLUSTER_MAX_ROWS = CLUSTER_BLOCKS * SHARED_MAX_ROWS
#: the clusters of 2, 4 and 8 blocks (one 1,024-thread block an SM) that
#: the H100 holds at once: cudaOccupancyMaxActiveClusters, printed by
#: tools/segment_bench.py (NVIDIA H100 80GB HBM3)
CLUSTERS_A_WAVE = {2: 66, 4: 30, 8: 15}
GLOBAL_TILE_ROWS = 2048
SCRATCH_INTS = 35
#: the most rows a cloud either segment-sum kernel takes
MAX_ROWS = 2**30
#: kernel 3's threads a block; a segment of at most SHORT_WALK rows is
#: summed by one thread, a longer one by a warp (WARP_SHARE: see
#: segment_walk_plan)
SEG_THREADS = 1024
SHORT_WALK = 32
WARP_SHARE = 4


def segment_sum_form(b: int, n: int) -> tuple[str, int]:
    """Kernel 3's form for b clouds of n rows, and its blocks a cloud:
    'shared' (one block) up to ``SHARED_MAX_ROWS``; 'global' above
    ``CLUSTER_MAX_ROWS`` (a tile of ``GLOBAL_TILE_ROWS`` rows a block, and a
    scratch the wrapper allocates); between, a 'cluster' of C blocks, C a
    power of two up to ``CLUSTER_BLOCKS``: the largest of which C blocks
    hold a cloud (ceil(n / ``SHARED_MAX_ROWS``) or more) and one wave holds
    b clusters (``CLUSTERS_A_WAVE``), else the smallest that holds a
    cloud."""
    if not 1 <= n <= MAX_ROWS:
        raise ValueError(f"the segment-sum kernels take 1..{MAX_ROWS} rows a "
                         f"cloud, got {n}")
    if b < 1:
        raise ValueError(f"kernel 3 takes at least one cloud, got {b}")
    if n <= SHARED_MAX_ROWS:
        return "shared", 1
    if n > CLUSTER_MAX_ROWS:
        return "global", -(-n // GLOBAL_TILE_ROWS)
    need = -(-n // SHARED_MAX_ROWS)
    sizes = [c for c in sorted(CLUSTERS_A_WAVE) if c >= need]
    fits = [c for c in sizes if b <= CLUSTERS_A_WAVE[c]]
    return "cluster", max(fits) if fits else min(sizes)


def segment_block_rows(n: int, form: tuple[str, int]) -> int:
    """The rows each block of ``form`` (:func:`segment_sum_form`) holds."""
    kind, blocks = form
    return GLOBAL_TILE_ROWS if kind == "global" else -(-n // blocks)


def segment_scratch_ints(n: int) -> int:
    """The int32 scratch kernel 3 takes a cloud of n rows: none but in the
    'global' form, where it is SCRATCH_INTS a row and a flag a tile."""
    if n <= CLUSTER_MAX_ROWS:
        return 0
    return SCRATCH_INTS * n + -(-n // GLOBAL_TILE_ROWS)


def _owned_walks(lengths, block: int) -> list[tuple[int, str, int, int]]:
    """Who sums each of a block's segments k (``lengths[k]`` rows, 0 for an
    empty one; output row ``k`` of the block's): thread k % SEG_THREADS in
    round k // SEG_THREADS; a round's segments of more than SHORT_WALK rows
    in one warp are walked by that warp when their rows total at most
    WARP_SHARE times the longest, else each by its thread. Returns ``(k,
    kind, block, who)``, kind 'zero' (an empty segment, by its thread),
    'thread' or 'warp'."""
    writes = []
    for g0 in range(0, len(lengths), 32):  # a warp's 32 segments of a round
        group = range(g0, min(g0 + 32, len(lengths)))
        longs = [lengths[k] for k in group if lengths[k] > SHORT_WALK]
        by_warp = bool(longs) and sum(longs) <= WARP_SHARE * max(longs)
        for k in group:
            thread = k % SEG_THREADS
            if lengths[k] == 0:
                writes.append((k, "zero", block, thread))
            elif by_warp and lengths[k] > SHORT_WALK:
                writes.append((k, "warp", block, thread // 32))
            else:
                writes.append((k, "thread", block, thread))
    return writes


def segment_walk_plan(rank, b: int = 1) -> list[tuple[int, str, int, int]]:
    """Who writes each output row of one cloud of a batch of b in kernel 3:
    ``(row, kind, block, who)`` for each write, kind 'thread' or 'warp'
    (``who`` the thread or warp of ``block`` that sums segment ``row``) or
    'zero' (an empty row, written by thread ``who``, or in the run forms by
    warp ``who``).

    Ranks in order, in the 'cluster' and 'global' forms: kernel 1's
    ownership over the blocks' rows (:func:`segment_block_rows`): a run
    belongs to the block holding its head, summed by the head's thread if it
    has at most SHORT_WALK rows, else by the head's warp; the empty rows
    below a run, and above the last rank, by the warp of its head (of row
    n - 1). Otherwise each block owns segments: all n in the 'shared' form
    and in the 'global' form's any-order pass, ``[j m, j m + m)`` in block
    j of the 'cluster' form (after its stable sort), summed as
    :func:`_owned_walks` says."""
    rank = [int(r) for r in rank]
    n = len(rank)
    form = segment_sum_form(b, n)
    m = segment_block_rows(n, form)
    in_order = all(a <= c for a, c in zip(rank, rank[1:]))
    if form[0] != "shared" and in_order:
        writes = []
        for i, r in enumerate(rank):
            prev = rank[i - 1] if i else -1
            if prev != r:  # a head
                end = i + 1
                while end < n and rank[end] == r:
                    end += 1
                thread = i % m % SEG_THREADS
                kind = "thread" if end - i <= SHORT_WALK else "warp"
                writes.append((r, kind, i // m, thread if kind == "thread"
                               else thread // 32))
                writes += [(k, "zero", i // m, thread // 32)
                           for k in range(prev + 1, r)]
        writes += [(k, "zero", (n - 1) // m, (n - 1) % m % SEG_THREADS // 32)
                   for k in range(rank[-1] + 1, n)]
        return writes
    lengths = [0] * n
    for r in rank:
        lengths[r] += 1
    if form[0] != "cluster":
        return _owned_walks(lengths, 0)
    writes = []
    for j in range(form[1]):
        own = lengths[j * m:(j + 1) * m]
        writes += [(j * m + k, kind, j, who)
                   for k, kind, _, who in _owned_walks(own, j)]
    return writes


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
    b, n, d = data.shape
    build.launch("pcp_sorted_segment_sum", data.device,
                 data.data_ptr(), rank.data_ptr(), out.data_ptr(), b, n, d,
                 sorted_sum_tiles(n))
    build.count("sorted_segment_sum")
    return out


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
    b, n, d = data.shape
    if b == 0 or n == 0:
        return out
    scratch = None
    if segment_scratch_ints(n):
        scratch = torch.empty((b, segment_scratch_ints(n)), dtype=torch.int32,
                              device=data.device)
    build.launch("pcp_segment_sum", data.device, data.data_ptr(),
                 rank.data_ptr(), out.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), b, n, d,
                 segment_sum_form(b, n)[1])
    build.count("segment_reduce")
    return out


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
