// Segment sums for the voxel downsample and the stride sampler: two kernels
// in one library, as the JAX package keeps both in one file.
//
// - sorted_segment_sum_kernel replaces ops/pallas/voxel_reduce.py::
//    sorted_segment_reduce_pallas, the banded one-hot MXU contraction with a
//    bf16 hi/lo split that the JAX package runs on the TPU.
// - segment_sum_kernel and segment_tile_kernel (further down), kernel 3,
//    replace ops/pallas/voxel_reduce.py::segment_reduce_pallas, the dense
//    one-hot contraction for any rank: three forms by n (one block a cloud
//    in shared memory to 5,120 rows, a thread-block cluster of 8 blocks to
//    40,960, tiles of 2,048 rows above), each finding a segment's rows in
//    row order (the runs of ranks in order, or a stable sort) and adding
//    them in that order, long segments by a whole warp.
//
// sorted_segment_sum_kernel: the rank is monotone.
//
//   out[b, k, :] = sum of data[b, i, :] over the rows i with rank[b, i] == k
//
// rank is non-decreasing along i (a cumsum over sort order, or a monotone
// bucket map), so every segment is one contiguous run of rows.  On the H100
// the op is bound by device-memory bytes: each row is read once
// ((d + 1) * 4 bytes with its rank) and each output row written once, a few
// MB per serving batch against 3.35 TB/s.  No matrix unit is needed.  The
// design spends nothing else: the output is not zeroed first (the kernel
// writes every row once), and the work is spread over tiles of rows, not
// clouds.
//
// A block of kThreads threads owns a tile of kTileRows rows of one cloud,
// kRowsAThread a thread: 512 blocks at 256x2048, one wave on 132 SMs at
// four blocks an SM, so no block waits for another's slot.  It stages the
// tile's rows and ranks in shared memory, with the kShortRun rows after the
// tile and the rank before it, in one round trip of coalesced loads (16
// bytes a load where the rows allow).  A row heads a run when it is row 0
// or its rank differs from the row before.  Ownership, which
// ops/cuda/voxel_reduce.py::sorted_sum_plan spells out for the CPU tests:
// - a run belongs to the tile that holds its head, whatever tiles it
//   crosses, and writes output row rank[head];
// - a short run (at most kShortRun rows: one or two on uniform scans) is
//   summed by its head's thread from shared memory, 0.0f + its rows in row
//   order, which is PyTorch's CPU scatter_add_ bit for bit;
// - a long run (an invalid-row bucket, a zero-padded scan's one voxel of n
//   rows, a stride bucket of many rows) is summed by the whole block:
//   thread t adds rows head + t, head + t + kThreads, ..., from shared
//   memory while they are staged and then from device memory, a few rows
//   and their ranks loaded at once, until a row of another rank or the
//   cloud's end is met; then a fixed xor-shuffle tree in each warp and the
//   warps' totals in warp order.  A run that ends within the staged rows
//   costs no device-memory access; past them, 2,048 rows (1,024 at d 5)
//   cost one round trip (rows past the run's end are read and dropped:
//   long runs are few, and the main path's dense scans have none);
// - the empty rows below a run, rank[head - 1] + 1 .. rank[head] - 1 (from
//   0 for row 0), are written as zeros by the run's warp, and the rows above
//   the cloud's last rank by the warp of row n - 1 (a few rows by the lane
//   itself, more as one run of floats, 16 bytes a store).
// So every output row is written exactly once, every order of adds is fixed
// by the shapes (deterministic, no atomics on data), and a long run costs
// its rows / (kThreads * kLongReach) round trips, not its length.
//
// The contract is checked on the device, where it costs no host sync: a
// rank outside [0, n) or a rank below the one before it stops the kernel
// with a trap, so the next CUDA call raises instead of a wrong sum coming
// back.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

// A row of D floats from p into v, and back: 16-byte accesses where the
// row's alignment A (in floats: D for rows packed from a 16-byte aligned
// base, 1 if unknown) allows, else 8-byte or 4-byte ones.
template <int A, int D>
__device__ __forceinline__ void load_row(const float* p, float (&v)[D]) {
  if constexpr (A % 4 == 0) {
#pragma unroll
    for (int c = 0; c < D; c += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + c);
      v[c] = q.x;
      v[c + 1] = q.y;
      v[c + 2] = q.z;
      v[c + 3] = q.w;
    }
  } else if constexpr (A % 2 == 0) {
#pragma unroll
    for (int c = 0; c < D; c += 2) {
      const float2 q = *reinterpret_cast<const float2*>(p + c);
      v[c] = q.x;
      v[c + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int c = 0; c < D; ++c) v[c] = p[c];
  }
}

template <int D>
__device__ __forceinline__ void store_row(float* p, const float (&v)[D]) {
  if constexpr (D % 4 == 0) {
#pragma unroll
    for (int c = 0; c < D; c += 4) {
      *reinterpret_cast<float4*>(p + c) =
          make_float4(v[c], v[c + 1], v[c + 2], v[c + 3]);
    }
  } else if constexpr (D % 2 == 0) {
#pragma unroll
    for (int c = 0; c < D; c += 2) {
      *reinterpret_cast<float2*>(p + c) = make_float2(v[c], v[c + 1]);
    }
  } else {
#pragma unroll
    for (int c = 0; c < D; ++c) p[c] = v[c];
  }
}

// Kernel 1's constants; ops/cuda/voxel_reduce.py holds the same three
// (TILE_ROWS, WALK_THREADS, SHORT_RUN), and the entry point refuses a grid
// that its own tile size does not give.
constexpr int kThreads = 256;     // a block's threads
constexpr int kRowsAThread = 4;
constexpr int kTileRows = kThreads * kRowsAThread;  // rows a block owns
// blocks an SM at 64 registers a thread: 528 on the card, so the 512 of a
// 256x2048 batch all run at once (at 65 registers only 396 would)
constexpr int kTileBlocksAnSm = 4;
constexpr int kShortRun = 32;   // the longest run a single thread sums
constexpr int kSpan = kTileRows + kShortRun;  // rows staged a block
// a long run has more than kShortRun rows, so a tile heads at most
// ceil(kTileRows / (kShortRun + 1)) of them
constexpr int kMaxLong = (kTileRows + kShortRun) / (kShortRun + 1);

// Zeros into floats [p, e) by a warp's lanes: 16 bytes a store between the
// first and last 16-byte boundaries.
__device__ __forceinline__ void zero_floats(float* p, float* e, int lane) {
  float* p4 = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(p) + 15) & ~static_cast<uintptr_t>(15));
  if (p4 > e) p4 = e;
  float* e4 = p4 + ((e - p4) & ~3LL);
  for (float* x = p + lane; x < p4; x += 32) *x = 0.0f;
  for (float* x = p4 + 4 * lane; x < e4; x += 128) {
    *reinterpret_cast<float4*>(x) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  for (float* x = e4 + lane; x < e; x += 32) *x = 0.0f;
}

// Zeros into output rows [lo, hi) of every lane's range: a lane writes up
// to kOwnGap rows itself (the stride sampler leaves one or two between its
// buckets), and the warp takes a longer range together as one run of
// floats.  Called by all 32 lanes.
constexpr int kOwnGap = 8;

template <int D>
__device__ __forceinline__ void zero_rows(float* out, int lo, int hi,
                                          int lane) {
  const float zero[D] = {};
  const bool own = hi - lo <= kOwnGap;
  if (own) {
    for (int k = lo; k < hi; ++k) {
      store_row<D>(out + static_cast<long long>(k) * D, zero);
    }
  }
  unsigned todo = __ballot_sync(0xffffffffu, !own);
  while (todo) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    zero_floats(out + static_cast<long long>(__shfl_sync(0xffffffffu, lo, src)) * D,
                out + static_cast<long long>(__shfl_sync(0xffffffffu, hi, src)) * D,
                lane);
  }
}

// One row of D floats from device memory: 16-byte loads when `vec` (D % 4
// == 0 and a 16-byte aligned base), else 4-byte ones.
template <int D>
__device__ __forceinline__ void load_global_row(const float* p, bool vec,
                                                float (&v)[D]) {
  if constexpr (D % 4 == 0) {
    if (vec) {
      load_row<4, D>(p, v);
      return;
    }
  }
  load_row<1, D>(p, v);
}

template <int D>
__global__ void __launch_bounds__(kThreads, kTileBlocksAnSm)
    sorted_segment_sum_kernel(const float* __restrict__ data,
                              const int* __restrict__ rank,
                              float* __restrict__ out, int n, int tiles) {
  __shared__ __align__(16) float rows_s[kSpan * D];  // rows t0 .. t0+kSpan-1
  __shared__ int rank_s[kSpan + 1];  // [q + 1]: rank of row t0 + q, q >= -1
  __shared__ int long_head[kMaxLong];  // tile rows that head long runs
  __shared__ int long_count;
  __shared__ float part[kThreads / 32][D];  // a block walk's warp totals

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long cloud = blockIdx.x / tiles;
  const int t0 = static_cast<int>(blockIdx.x % tiles) * kTileRows;
  const int* r_in = rank + cloud * n;
  const float* d_in = data + cloud * n * D;
  float* o_out = out + cloud * n * D;
  const bool vec = reinterpret_cast<uintptr_t>(data) % 16 == 0;

  // Stage: ranks of rows t0 - 1 .. t0 + kSpan - 1 (-1 before row 0, n past
  // the last row: no rank equals either) and the rows t0 .. t0 + kSpan - 1
  // that exist, as one flat run of floats.
  if (tid == 0) long_count = 0;
  for (int q = tid; q <= kSpan; q += kThreads) {
    const int row = t0 - 1 + q;
    rank_s[q] = row < 0 ? -1 : (row < n ? r_in[row] : n);
  }
  {
    const int count = (min(n, t0 + kSpan) - t0) * D;
    const float* src = d_in + static_cast<long long>(t0) * D;
    int f0 = 0;
    if (reinterpret_cast<uintptr_t>(src) % 16 == 0) {
      f0 = count & ~3;
      for (int f = 4 * tid; f < f0; f += 4 * kThreads) {
        *reinterpret_cast<float4*>(rows_s + f) =
            *reinterpret_cast<const float4*>(src + f);
      }
    }
    for (int f = f0 + tid; f < count; f += kThreads) rows_s[f] = src[f];
  }
  __syncthreads();

  // Each of the thread's rows: check it, and if it heads a run, sum a short
  // run and write the empty rows below it; a long run's head goes on the
  // block's list.
#pragma unroll
  for (int a = 0; a < kRowsAThread; ++a) {
    const int q = tid + a * kThreads;  // the row in the tile
    const int i = t0 + q;
    int gap_lo = 0, gap_hi = 0;    // empty rows below this row's run
    int tail_lo = 0, tail_hi = 0;  // empty rows above the last rank
    if (i < n) {
      const int r = rank_s[q + 1];
      const int prev = rank_s[q];
      if (r < 0 || r >= n) __trap();  // outside [0, n)
      if (prev > r) __trap();         // not monotone: runs would be split
      if (i == n - 1) {
        tail_lo = r + 1;
        tail_hi = n;
      }
      if (prev != r) {  // a head
        gap_lo = prev + 1;
        gap_hi = r;
        float sum[D];
#pragma unroll
        for (int c = 0; c < D; ++c) sum[c] = 0.0f;
        bool ended = false;
        for (int p = q; p < q + kShortRun; ++p) {
          float v[D];
          load_row<D, D>(rows_s + p * D, v);
#pragma unroll
          for (int c = 0; c < D; ++c) sum[c] += v[c];
          if (rank_s[p + 2] != r) {  // row p + 1 is another run's, or past n
            ended = true;
            break;
          }
        }
        if (ended) {
          store_row<D>(o_out + static_cast<long long>(r) * D, sum);
        } else {
          long_head[atomicAdd(&long_count, 1)] = q;
        }
      }
    }
    zero_rows<D>(o_out, gap_lo, gap_hi, lane);
    zero_rows<D>(o_out, tail_lo, tail_hi, lane);
  }
  __syncthreads();

  // Long runs, one at a time, by the whole block: thread t takes rows
  // head + t + j kThreads, j = 0, 1, ..., from shared memory while staged,
  // then from device memory if the run reaches past the staged rows.
  // Rows a thread loads at once: 8 of 16 bytes, or 4 of 5 floats (8 of 5
  // floats spill out of the 64 registers that keep four blocks an SM).
  constexpr int kLongReach = D % 4 == 0 ? 8 : 4;
  const int longs = long_count;
  for (int l = 0; l < longs; ++l) {
    const int h = long_head[l];
    const int r = rank_s[h + 1];
    const bool beyond = rank_s[kSpan] == r;  // the last staged row is the run's
    float acc[D];
#pragma unroll
    for (int c = 0; c < D; ++c) acc[c] = 0.0f;
    for (long long q0 = h + tid;; q0 += kThreads * kLongReach) {
      int rk[kLongReach];
      float v[kLongReach][D];
#pragma unroll
      for (int j = 0; j < kLongReach; ++j) {  // ranks and rows, all in flight
        const long long q = q0 + j * kThreads;
        if (q < kSpan) {
          rk[j] = rank_s[q + 1];
          if (rk[j] == r) load_row<D, D>(rows_s + q * D, v[j]);
        } else if (beyond && t0 + q < n) {
          rk[j] = r_in[t0 + q];
          load_global_row<D>(d_in + (t0 + q) * D, vec, v[j]);
        } else {
          rk[j] = n;
        }
      }
      bool stop = false;
#pragma unroll
      for (int j = 0; j < kLongReach; ++j) {
        if (rk[j] == r) {
#pragma unroll
          for (int c = 0; c < D; ++c) acc[c] += v[j][c];
        } else {
          stop = true;  // monotone: every later row is past the run too
        }
      }
      if (__syncthreads_or(stop)) break;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int c = 0; c < D; ++c) {
        acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < D; ++c) part[warp][c] = acc[c];
    }
    __syncthreads();
    if (tid == 0) {
      float sum[D];
#pragma unroll
      for (int c = 0; c < D; ++c) sum[c] = part[0][c];
      for (int w = 1; w < kThreads / 32; ++w) {
#pragma unroll
        for (int c = 0; c < D; ++c) sum[c] += part[w][c];
      }
      store_row<D>(o_out + static_cast<long long>(r) * D, sum);
    }
    // thread 0 reads `part` before the next walk's barrier; every warp
    // writes it only after that barrier
  }
}

// segment_sum_kernel and segment_tile_kernel: kernel 3, the segment sum for
// ANY rank in [0, n), in any order.
//
// The TPU kernel builds a (k_tile, n) one-hot slab per output tile and
// contracts it on the MXU: every output tile scans every row.  Here it is
// O(n): find each segment's rows in row order (the runs of a monotone rank,
// or a stable sort by rank), then add them.
//
// Invariant: each segment's sum is 0.0f + its rows in increasing row order,
// one add at a time.  That is PyTorch's CPU scatter_add_ and XLA's CPU
// segment_sum bit for bit.  Nothing is added with atomics or in a tree;
// only integer counts and positions are computed in parallel, and those do
// not depend on the schedule.  So a segment of L rows is a chain of L
// dependent adds a component; the d components are independent.
//
// Who adds (ops/cuda/voxel_reduce.py::segment_walk_plan spells it out):
// - a segment of at most kShortWalk = 32 rows is summed by one thread, a
//   few rows loaded ahead of its adds;
// - a longer one is walked by a whole warp, lane c adding component c
//   (lane_run over contiguous rows, lane_sum through a permutation): every
//   lane's loads run up to 16 rows ahead of its adds, so the walk goes at
//   the speed of the add chain, not of one thread's load queue.  In the
//   walks where a thread owns segments, a warp
//   walks its round's long segments one after another when their rows
//   total at most kWarpShare times the longest, else each thread walks its
//   own (many long segments in one warp would queue behind each other).
// - A run that reaches past the rows a block staged (a zero-padded scan's
//   one voxel, one segment of n rows) is continued from device memory by
//   ring_walk: the warp keeps kRingSlots slots of kSlotRows rows and their
//   ranks in flight with cp.async, and the lanes add each slot in order.
//
// Forms, chosen by b and n (ops/cuda/voxel_reduce.py::segment_sum_form):
// - 'shared', n <= kSharedMaxRows = 5,120: segment_sum_kernel<D, true>,
//   one block of 1,024 threads a cloud, everything in shared memory, 44 B a
//   row (below).
// - 'cluster', n <= kClusterMaxRows = 40,960: segment_tile_kernel<D, true>,
//   a thread-block cluster of C blocks a cloud, C a power of two from 2 to
//   kClusterBlocks = 8: the largest that holds a cloud (ceil(n / 5,120)
//   blocks or more) and of which one wave holds b clusters (the H100 holds
//   66, 30 and 15 clusters of 2, 4 and 8 blocks of one block an SM:
//   pcp_segment_clusters_a_wave), else the smallest that holds a cloud.
//   Block j holds rows [j m, (j + 1) m), m = ceil(n / C).  The blocks check
//   their
//   ranks and vote through distributed shared memory.  Ranks in order: each
//   block sums the runs headed in its rows (tile_runs).  Any order: an LSD
//   radix sort of (rank, row) by 8-bit digits across the cluster (stable:
//   per-warp digit counts, the blocks' digit totals read from each other's
//   shared memory, a stable placement written into the owner block's
//   shared memory), then each block sums its own segments.
// - 'global', larger n: segment_tile_kernel<D, false> on tiles of
//   kGlobalTileRows = 2,048 rows, b x tiles blocks: each tile checks its
//   ranks and, if they are in order, sums the runs headed in it, and writes
//   a flag; then segment_sum_kernel<D, false>, one block a cloud, returns at
//   once for a cloud whose flags are all clear and otherwise recomputes the
//   whole cloud with a counting sort in a device-memory scratch.
// Limits: 1 <= d <= 8, n <= 2^30.
//
// segment_sum_kernel: a stable counting sort per cloud.  Warp w owns the
// contiguous rows [w L, (w + 1) L), L = ceil(n / 32), and walks them 32 at a
// time, so the warps' row ranges are in warp order.
//
//  (0) Ranks.  Each warp reads its ranks; a rank outside [0, n) traps.  If
//      no rank is below the one before it (a block vote), the cloud is
//      already in segment order (the permutation is the identity): each
//      head row (row 0, or a new rank) records where its segment starts
//      and where the one before ends, and (d) walks those runs.
//      Otherwise:
//  (a) Per-warp counts.  A ballot per bit of the rank groups a step's lanes
//      by segment.  The group reads its warp's count of the segment so far
//      (cnt[segment][w]); with the group's lanes below, that is each row's
//      number of earlier rows of its segment in its warp.  The group's
//      lowest lane then stores the new count (only warp w writes column w)
//      and adds the group's size to the segment's total (an int atomic).
//  (b) Starts.  An exclusive block scan of the totals.
//  (c) Stable placement.  Row i of segment k, warp w, goes to
//      perm[start[k] + (k's count in the warps before w) + (its earlier
//      rows of k in warp w)]: where a sequential stable counting sort puts
//      it.  One pass, no rounds.
//  (d) Sum.  Thread t owns segments k = t, t + 1,024, ... (walk_segments).
//      Every output row is written (0 for an empty segment).
// Its memory: in the shared form a byte count for each warp (a warp holds
// at most L <= 160 rows, so a byte holds its count), 32; start,
// permutation and the ranks (then each row's rank << 8 | earlier-row
// count), 4 each: 88 KB at n = 2,000, so two blocks fit an SM and 256
// clouds run in one wave.  The data rows are copied into the counts' space
// with cp.async as the kernel starts (32 B a row >= 4 d B), so the walks
// read shared memory; the counting sort copies them again after (c).  In
// the global form: 32-bit counts, start, permutation and the earlier-row
// counts in a device-memory scratch of kScratchInts ints a row.
//
// The function is bound by device-memory bytes (each row and rank read
// once, each output row written once).  On in-order ranks the kernels add
// a few dependent latencies a block to that (rank loads, the vote, the
// copy, the walks), and a long run its chain of adds.

constexpr int kSegThreads = 1024;
constexpr int kSegWarps = kSegThreads / 32;
constexpr int kSharedMaxRows = 5120;  // 44 B a row: 225,280 B
constexpr int kClusterBlocks = 8;     // the portable cluster size
constexpr int kClusterMaxRows = kClusterBlocks * kSharedMaxRows;
constexpr int kGlobalTileRows = 2048;
constexpr long long kMaxRows = 1LL << 30;
constexpr int kScratchInts = kSegWarps + 3;  // device-memory form: a row
constexpr int kShortWalk = 32;  // the longest segment one thread sums
constexpr int kWarpShare = 4;
constexpr int kSlotRows = 256;  // ring_walk: rows a slot
constexpr int kRingSlots = 4;   // and slots in flight
constexpr unsigned kFull = 0xffffffffu;

// Sum of a segment's per-warp counts over the warps before `warp`: a row
// of counts is 32 bytes (shared form) or 32 ints (device-memory form).
// `warp` is the same across the calling warp, so the loops are too.
__device__ __forceinline__ int warps_before(const unsigned char* row,
                                            int warp) {
  const unsigned* words = reinterpret_cast<const unsigned*>(row);
  const int full = warp >> 2;  // words whose four warps are all earlier
  unsigned sum = 0;
  for (int k = 0; k < full; ++k) sum = __dp4a(words[k], 0x01010101u, sum);
  if (warp & 3) {
    const unsigned part = words[full] & ((1u << (8 * (warp & 3))) - 1u);
    sum = __dp4a(part, 0x01010101u, sum);
  }
  return static_cast<int>(sum);
}

__device__ __forceinline__ int warps_before(const unsigned* row, int warp) {
  unsigned sum = 0;
#pragma unroll 8
  for (int k = 0; k < warp; ++k) sum += row[k];
  return static_cast<int>(sum);
}

// The lanes of the warp whose r equals this lane's, among the lanes with
// r >= 0, for 0 <= r < 2^bits: __match_any_sync from one ballot a bit
// (a ballot is a plain vote; __match_any_sync is several times slower on
// the H100 with every warp slot busy).  `bits` is the same across the warp.
__device__ __forceinline__ unsigned match_lanes(int r, int bits) {
  unsigned peers = __ballot_sync(kFull, r >= 0);
  for (int b = 0; b < bits; ++b) {
    const bool one = (r >> b) & 1;
    const unsigned ones = __ballot_sync(kFull, one);
    peers &= one ? ones : ~ones;
  }
  return peers;
}

// Start copying `count` rows of D floats into shared memory (cp.async: no
// registers, the copy runs behind the next phases); stage_wait() waits for
// this thread's copies, and a barrier after it for everyone's.
template <int D>
__device__ __forceinline__ void stage_rows(float* stage, const float* src,
                                           int count_rows) {
  const int count = count_rows * D;
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(stage));
  if (count % 4 == 0 && reinterpret_cast<size_t>(src) % 16 == 0) {
    for (int q = threadIdx.x; q < count / 4; q += kSegThreads) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                   ::"r"(dst + 16 * q), "l"(src + 4 * q) : "memory");
    }
  } else {
    for (int q = threadIdx.x; q < count; q += kSegThreads) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                   ::"r"(dst + 4 * q), "l"(src + q) : "memory");
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One thread's walk: out = 0.0f + rows[row_of(p)] for p = p0 .. p1 - 1,
// one add at a time, a few rows loaded ahead of the adds.  kAligned: rows
// are 16-byte aligned where D allows (shared memory); out always is.
template <int D, bool kAligned, typename RowOf>
__device__ __forceinline__ void walk(const float* rows, int p0, int p1,
                                     RowOf row_of, float* out) {
  constexpr int kAhead = D <= 2 ? 8 : (D <= 4 ? 4 : 2);
  float sum[D];
#pragma unroll
  for (int c = 0; c < D; ++c) sum[c] = 0.0f;
  int p = p0;
  for (; p + kAhead <= p1; p += kAhead) {
    float v[kAhead][D];
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      const long long row = row_of(p + a);
      load_row<kAligned ? D : 1, D>(rows + row * D, v[a]);
    }
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
#pragma unroll
      for (int c = 0; c < D; ++c) sum[c] += v[a][c];
    }
  }
  for (; p < p1; ++p) {
    float v[D];
    const long long row = row_of(p);
    load_row<kAligned ? D : 1, D>(rows + row * D, v);
#pragma unroll
    for (int c = 0; c < D; ++c) sum[c] += v[c];
  }
  store_row<D>(out, sum);
}

// One lane's share of a warp's walk: sum + rows[row_of(p) * D + c] for
// p = p0 .. p1 - 1, one add at a time in row order, the next kU rows'
// loads in flight while this batch is added (clamped to the last row, so
// every load is in range).
template <int D, int kU, typename RowOf>
__device__ __forceinline__ float lane_sum(const float* rows, int p0, int p1,
                                          RowOf row_of, int c, float sum) {
  if (p0 >= p1) return sum;
  const int last = p1 - 1;
  float v[kU];
#pragma unroll
  for (int a = 0; a < kU; ++a) {
    v[a] = rows[static_cast<long long>(row_of(min(p0 + a, last))) * D + c];
  }
  for (int p = p0; p < p1; p += kU) {
    float w[kU];
#pragma unroll
    for (int a = 0; a < kU; ++a) {
      w[a] = rows[static_cast<long long>(row_of(min(p + kU + a, last))) * D + c];
    }
#pragma unroll
    for (int a = 0; a < kU; ++a) {
      if (p + a < p1) sum += v[a];
    }
#pragma unroll
    for (int a = 0; a < kU; ++a) v[a] = w[a];
  }
  return sum;
}

// The same over contiguous rows: sum + p[i D] for i = 0 .. count - 1 (p:
// component c of the first row), in batches of kU loads, each issued a
// batch ahead of its adds when kAhead (2 kU registers), a ragged end as one
// guarded batch: with 16 loads in flight the dependent adds, not the
// loads' latency, set the pace.
template <int D, int kU, bool kAhead>
__device__ __forceinline__ float lane_run(const float* p, int count,
                                          float sum) {
  int i = 0;
  if constexpr (!kAhead) {
    for (; i + kU <= count; i += kU) {
      float v[kU];
#pragma unroll
      for (int a = 0; a < kU; ++a) v[a] = p[(i + a) * D];
#pragma unroll
      for (int a = 0; a < kU; ++a) sum += v[a];
    }
  } else if (count >= kU) {
    float v[kU];
#pragma unroll
    for (int a = 0; a < kU; ++a) v[a] = p[a * D];
    for (; i + 2 * kU <= count; i += kU) {
      const float* next = p + (i + kU) * D;
      float w[kU];
#pragma unroll
      for (int a = 0; a < kU; ++a) w[a] = next[a * D];
#pragma unroll
      for (int a = 0; a < kU; ++a) sum += v[a];
#pragma unroll
      for (int a = 0; a < kU; ++a) v[a] = w[a];
    }
#pragma unroll
    for (int a = 0; a < kU; ++a) sum += v[a];
    i += kU;
  }
  if (i < count) {
    const float* rest = p + i * D;
    float v[kU];
#pragma unroll
    for (int a = 0; a < kU; ++a) v[a] = i + a < count ? rest[a * D] : 0.0f;
#pragma unroll
    for (int a = 0; a < kU; ++a) {
      if (i + a < count) sum += v[a];
    }
  }
  return sum;
}

// Segments k = 0 .. count - 1 into out + k D: bounds(k) gives the
// positions [s, e) of segment k (s < 0: empty), row_of(p) the row at
// position p; kRun: row_of is the identity, so a warp walk reads
// contiguous rows.  Thread t takes k = t, t + 1,024, ...; in each round a
// warp's segments of more than kShortWalk rows are walked by the whole
// warp, one after another, when their rows total at most kWarpShare times
// the longest, else each by its thread.  Called by the whole block.
template <int D, bool kAligned, bool kRun, typename Bounds, typename RowOf>
__device__ __forceinline__ void walk_segments(const float* rows, int count,
                                              Bounds bounds, RowOf row_of,
                                              float* out, int lane) {
  const int rounds = (count + kSegThreads - 1) / kSegThreads;
  for (int i = 0; i < rounds; ++i) {
    const int k = static_cast<int>(threadIdx.x) + i * kSegThreads;
    int s = -1, e = -1;
    if (k < count) {
      const int2 be = bounds(k);
      s = be.x;
      e = be.y;
    }
    const int len = s >= 0 ? e - s : 0;
    const bool is_long = len > kShortWalk;
    const unsigned longs = __ballot_sync(kFull, is_long);
    bool by_warp = false;
    if (longs) {  // the same across the warp
      const int total = __reduce_add_sync(kFull, is_long ? len : 0);
      const int longest = __reduce_max_sync(kFull, is_long ? len : 0);
      by_warp = total <= kWarpShare * longest;
    }
    if (k < count && !(by_warp && is_long)) {
      walk<D, kAligned>(rows, s, s < 0 ? s : e, row_of,
                        out + static_cast<long long>(k) * D);
    }
    if (by_warp) {
      unsigned todo = longs;
      while (todo) {
        const int src = __ffs(todo) - 1;
        todo &= todo - 1;
        const int ws = __shfl_sync(kFull, s, src);
        const int we = __shfl_sync(kFull, e, src);
        const int wk = __shfl_sync(kFull, k, src);
        if (lane < D) {
          out[static_cast<long long>(wk) * D + lane] =
              kRun ? lane_run<D, 16, false>(rows + static_cast<long long>(ws) * D + lane,
                                            we - ws, 0.0f)
                   : lane_sum<D, 4>(rows, ws, we, row_of, lane, 0.0f);
        }
      }
    }
  }
}

// Continue a warp's walk of a run of rank r at row q through device memory
// (all 32 lanes call it; lane c < D holds component c's sum so far): the
// warp copies slots of kSlotRows rows and their ranks into a ring in shared
// memory with cp.async (coalesced, 4 bytes a copy, so any row alignment),
// kRingSlots slots in flight, and lane c adds each slot's component c in
// row order (lane_run) up to the first row of another rank or row n, which
// ends the walk.  ring: kRingSlots * kSlotRows * (D + 1) words.
template <int D>
__device__ __noinline__ float ring_walk(const float* d_in, const int* r_in, long long q,
                          int r, int n, float sum, float* ring, int lane) {
  constexpr int kSlot = kSlotRows * D;  // floats a slot
  int* ranks = reinterpret_cast<int*>(ring + kRingSlots * kSlot);
  const unsigned rows_at = static_cast<unsigned>(__cvta_generic_to_shared(ring));
  const unsigned ranks_at = static_cast<unsigned>(__cvta_generic_to_shared(ranks));
  auto issue = [&](long long row0, int slot) {
    const int floats = static_cast<int>(
        min(static_cast<long long>(kSlotRows), n - row0) * D);
    const float* src = d_in + row0 * D;
    const unsigned dst = rows_at + 4u * static_cast<unsigned>(slot * kSlot);
    int f0 = 0;
    if (reinterpret_cast<uintptr_t>(src) % 16 == 0) {  // 16 bytes a copy
      f0 = floats & ~3;
      for (int f = 4 * lane; f < f0; f += 128) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                     ::"r"(dst + 4u * f), "l"(src + f) : "memory");
      }
    }
    for (int f = f0 + lane; f < floats; f += 32) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                   ::"r"(dst + 4u * f), "l"(src + f) : "memory");
    }
#pragma unroll
    for (int i = lane; i < kSlotRows; i += 32) {
      if (row0 + i < n) {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                     ::"r"(ranks_at + 4u * (slot * kSlotRows + i)),
                     "l"(r_in + row0 + i) : "memory");
      } else {  // past the cloud: no rank equals -1
        ranks[slot * kSlotRows + i] = -1;
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  for (int s = 0; s < kRingSlots; ++s) issue(q + static_cast<long long>(kSlotRows) * s, s);
  for (int k = 0;; ++k) {
    asm volatile("cp.async.wait_group %0;" ::"n"(kRingSlots - 1) : "memory");
    __syncwarp();
    const int slot = k % kRingSlots;
    int rk[kSlotRows / 32];
#pragma unroll
    for (int g = 0; g < kSlotRows / 32; ++g) rk[g] = ranks[slot * kSlotRows + 32 * g + lane];
    int valid = kSlotRows;
#pragma unroll
    for (int g = kSlotRows / 32 - 1; g >= 0; --g) {  // the first row of another rank
      const unsigned other = __ballot_sync(kFull, rk[g] != r);
      if (other) valid = 32 * g + __ffs(other) - 1;
    }
    if (lane < D) sum = lane_run<D, 16, true>(ring + slot * kSlot + lane, valid, sum);
    if (valid < kSlotRows) break;  // monotone: the run has ended
    __syncwarp();                  // every lane has read the slot
    issue(q + static_cast<long long>(kSlotRows) * (k + kRingSlots), slot);
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncwarp();
  return sum;
}

template <int D, bool kShared>
__global__ void __launch_bounds__(kSegThreads, 2)
    segment_sum_kernel(const float* __restrict__ data,
                       const int* __restrict__ rank, float* __restrict__ out,
                       int* __restrict__ scratch,
                       const int* __restrict__ flags, int n, int tiles) {
  using Count = typename std::conditional<kShared, unsigned char,
                                          unsigned>::type;
  extern __shared__ __align__(16) uint4 seg_smem[];
  __shared__ int warp_total[kSegWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lower_lanes = (1u << lane) - 1u;
  const long long cloud = blockIdx.x;
  const int* r_in = rank + cloud * n;
  const float* d_in = data + cloud * n * D;
  float* o_out = out + cloud * n * D;
  const int per_warp = (n + kSegWarps - 1) / kSegWarps;
  const int row0 = min(n, warp * per_warp);
  const int row_end = min(n, row0 + per_warp);
  const int bits = n > 1 ? 32 - __clz(n - 1) : 0;  // a rank's bits

  if constexpr (!kShared) {
    // segment_tile_kernel ran first: a cloud whose tiles all found their
    // ranks in order is summed already
    int bad = 0;
    for (int t = tid; t < tiles; t += kSegThreads) bad |= flags[cloud * tiles + t];
    if (!__syncthreads_or(bad)) return;
  }

  Count* cnt;  // [n][32] each segment's count in each warp
  int* start;  // [n] each segment's first position in perm
  int* perm;   // [n] row indices in (segment, row) order
  int* info;   // [n] each row's earlier rows of its segment in its warp
               // (shared form: with its rank, rank << 8 | earlier)
  if constexpr (kShared) {
    cnt = reinterpret_cast<Count*>(seg_smem);
    start = reinterpret_cast<int*>(cnt + 32LL * n);
  } else {  // every cloud's counts (16-byte aligned rows), then the rest
    cnt = reinterpret_cast<Count*>(scratch + cloud * 32LL * n);
    start = scratch + 32LL * n * gridDim.x + cloud * 3LL * n;
  }
  perm = start + n;
  info = perm + n;
  // shared form: the rows, in the counts' space (32 B a row >= 4 D B)
  float* stage = reinterpret_cast<float*>(cnt);
  const float* rows = kShared ? stage : d_in;  // where the walks read rows

  // The ranks: a rank outside [0, n) traps.  The shared form keeps them
  // in `info` and starts the rows' copy into shared memory.  carry0: the
  // rank before the warp's first row (-1 before row 0).
  const int carry0 = row0 > 0 && row0 < row_end ? r_in[row0 - 1] : -1;
  if constexpr (kShared) {
    stage_rows<D>(stage, d_in, n);
    constexpr int kSteps = kSharedMaxRows / kSegThreads;  // a warp's rows
    int v[kSteps];
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {  // every rank load in flight at once
      const int i = row0 + 32 * j + lane;
      v[j] = i < row_end ? r_in[i] : 0;
    }
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const int i = row0 + 32 * j + lane;
      if (i < row_end) info[i] = v[j];
    }
    __syncwarp();
  }
  auto rank_at = [&](int i) -> int { return kShared ? info[i] : r_in[i]; };
  for (int k = tid; k < n; k += kSegThreads) start[k] = -1;

  // Ranks that never decrease (all that the voxel and stride paths give)
  // are already in segment order: the permutation is the identity and a
  // segment is one run of rows, from its head to the next head.  Each
  // step of a warp: its 32 rows, the previous one's carried in lane 0.
  auto for_each_row = [&](auto step) {
    int carry = carry0;
    for (int i0 = row0; i0 < row_end; i0 += 32) {  // the same for the warp
      const int i = i0 + lane;
      const int r = i < row_end ? rank_at(i) : -1;
      int prev = __shfl_up_sync(kFull, r, 1);
      if (lane == 0) prev = carry;
      carry = __shfl_sync(kFull, r, 31);
      if (i < row_end) step(i, r, prev);
    }
  };
  bool sorted = true;
  for_each_row([&](int, int r, int prev) {
    if (r < 0 || r >= n) __trap();  // outside [0, n)
    if (prev > r) sorted = false;
  });
  if (!__syncthreads_or(!sorted)) {
    int* end = perm;  // [n] one past each segment's last row
    for_each_row([&](int i, int r, int prev) {
      if (prev != r) {  // a head: row 0 or a new rank
        start[r] = i;
        if (prev >= 0) end[prev] = i;
      }
      if (i == n - 1) end[r] = n;
    });
    if constexpr (kShared) stage_wait();
    __syncthreads();
    walk_segments<D, kShared, true>(
        rows, n, [&](int k) { return make_int2(start[k], end[k]); },
        [](int p) { return p; }, o_out, lane);
    return;
  }

  // Any order: the counting sort.
  if constexpr (kShared) stage_wait();  // before the counts overwrite them
  __syncthreads();
  {
    uint4* z = reinterpret_cast<uint4*>(cnt);
    const long long words = 32LL * n * sizeof(Count) / sizeof(uint4);
    for (long long q = tid; q < words; q += kSegThreads) {
      z[q] = make_uint4(0u, 0u, 0u, 0u);
    }
    for (int k = tid; k < n; k += kSegThreads) start[k] = 0;
  }
  __syncthreads();

  // (a) per-warp counts; each row's earlier rows of its segment in its warp
  for (int i0 = row0; i0 < row_end; i0 += 32) {  // the same for the warp
    const int i = i0 + lane;
    const int r = i < row_end ? rank_at(i) : -1;
    const unsigned peers = match_lanes(r, bits);
    int before = 0;
    Count* c = cnt + 32LL * max(r, 0) + warp;
    if (r >= 0) before = static_cast<int>(*c);
    __syncwarp();
    if (r >= 0 && (peers & lower_lanes) == 0) {
      *c = static_cast<Count>(before + __popc(peers));
      atomicAdd(&start[r], __popc(peers));  // the segment's total
    }
    __syncwarp();
    const int e = before + __popc(peers & lower_lanes);
    if (r >= 0) info[i] = kShared ? r << 8 | e : e;  // r < 2^13, e < 2^8
  }
  __syncthreads();

  // (b) starts: an exclusive scan of the totals, each thread a run of them
  {
    const int per = (n + kSegThreads - 1) / kSegThreads;
    const int lo = min(n, tid * per);
    const int hi = min(n, lo + per);
    int own = 0;
    for (int k = lo; k < hi; ++k) own += start[k];
    int inc = own;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(kFull, inc, off);
      if (lane >= off) inc += o;
    }
    if (lane == 31) warp_total[warp] = inc;
    __syncthreads();
    if (warp == 0) {
      const int w = warp_total[lane];
      int winc = w;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_up_sync(kFull, winc, off);
        if (lane >= off) winc += o;
      }
      warp_total[lane] = winc - w;
    }
    __syncthreads();
    int run = warp_total[warp] + inc - own;
    for (int k = lo; k < hi; ++k) {
      const int t = start[k];
      start[k] = run;
      run += t;
    }
  }
  __syncthreads();

  // (c) stable placement
  for (int i = row0 + lane; i < row_end; i += 32) {
    const int v = info[i];
    if constexpr (kShared) {
      const int r = v >> 8;
      perm[start[r] + warps_before(cnt + 32 * r, warp) + (v & 255)] = i;
    } else {
      const int r = r_in[i];
      perm[start[r] + warps_before(cnt + 32LL * r, warp) + v] = i;
    }
  }
  __syncthreads();

  // (d) sum each segment's rows in row order
  if constexpr (kShared) {  // the rows again, over the counts (from L2)
    stage_rows<D>(stage, d_in, n);
    stage_wait();
    __syncthreads();
  }
  walk_segments<D, kShared, false>(
      rows, n,
      [&](int k) { return make_int2(start[k], k + 1 < n ? start[k + 1] : n); },
      [perm](int p) { return perm[p]; }, o_out, lane);
}

// segment_tile_kernel's shared memory, in 4-byte words: the ranks of rows
// t0 - 1 .. t0 + m + kShortRun, then either the staged rows (m + kShortRun
// of them) and ring_walk's ring (in-order ranks), or the radix sort's
// arrays (cluster form, any order): keys and rows twice (the passes
// alternate), each own segment's start and end, the per-warp digit counts
// (256 x 32 bytes), each row's earlier count (a byte), the block's digit
// totals and the digits' bases.
__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

__host__ __device__ constexpr int tile_rank_words(int m) {
  return round4(m + kShortRun + 2);
}

template <int D>
__host__ __device__ constexpr int tile_rows_words(int m) {
  return round4((m + kShortRun) * D);
}

__host__ __device__ constexpr int tile_sort_words(int m) {
  return 6 * round4(m) + 256 * kSegWarps / 4 + round4(m) / 4 + 2 * 256;
}

template <int D>
__host__ __device__ constexpr int tile_words(int m, bool cluster) {
  const int in_order = tile_rows_words<D>(m) + kRingSlots * kSlotRows * (D + 1);
  const int sort = cluster ? tile_sort_words(m) : 0;
  return tile_rank_words(m) + (in_order > sort ? in_order : sort);
}

// A warp's walk of the run of rank r headed at staged row h (more than
// kShortRun rows): lane c adds component c over the staged rows of the run,
// then, if the run reaches past them, on through device memory
// (ring_walk); lane c writes out[r][c].  Out of line: the per-row loop of
// tile_runs stays small.
template <int D>
__device__ __noinline__ void long_run(const float* rows_s, const int* rank_s,
                                      float* ring, const float* d_in,
                                      const int* r_in, float* o_out, int t0,
                                      int staged, int n, int h, int r,
                                      int lane) {
  int e = staged;  // the run's end among the staged rows
  for (int p0 = h + kShortRun; p0 < staged; p0 += 32) {
    const int p = p0 + lane;
    const unsigned other = __ballot_sync(kFull, p < staged && rank_s[p + 1] != r);
    if (other) {
      e = p0 + __ffs(other) - 1;
      break;
    }
  }
  float sum = 0.0f;
  if (lane < D) sum = lane_run<D, 16, true>(rows_s + h * D + lane, e - h, sum);
  if (e == staged && t0 + staged < n) {
    sum = ring_walk<D>(d_in, r_in, t0 + staged, r, n, sum, ring, lane);
  }
  if (lane < D) o_out[static_cast<long long>(r) * D + lane] = sum;
}

// The runs headed in a block's rows [t0, t0 + rows) of a cloud whose ranks
// are in order (kernel 1's ownership, with every sum in row order): a run
// belongs to the block that holds its head and writes output row
// rank[head]; a run of at most kShortRun rows is summed by its head's
// thread from the staged rows; a longer one by the head's warp (at most one
// a warp a round: heads of long runs are more than 32 rows apart), over the
// staged rows and on through device memory if it reaches past them; the
// empty rows below a run, and above the cloud's last rank, are written as
// zeros by the warp of its head (of row n - 1).
template <int D>
__device__ void tile_runs(const float* rows_s, const int* rank_s, float* ring,
                          const float* d_in, const int* r_in, float* o_out,
                          int t0, int rows, int staged, int n, int lane) {
  const int rounds = (rows + kSegThreads - 1) / kSegThreads;
  for (int i = 0; i < rounds; ++i) {
    const int q = static_cast<int>(threadIdx.x) + i * kSegThreads;
    int gap_lo = 0, gap_hi = 0;    // empty rows below this row's run
    int tail_lo = 0, tail_hi = 0;  // empty rows above the last rank
    bool long_head = false;
    int r = 0;
    if (q < rows) {
      r = rank_s[q + 1];
      const int prev = rank_s[q];
      if (t0 + q == n - 1) {
        tail_lo = r + 1;
        tail_hi = n;
      }
      if (prev != r) {  // a head
        gap_lo = prev + 1;
        gap_hi = r;
        // the run's length, up to kShortRun + 1 (one to three rows on the
        // paths' ranks)
        int len = 1;
#pragma unroll 1
        while (len <= kShortRun && rank_s[q + len + 1] == r) ++len;
        if (len <= kShortRun) {
          float sum[D];
#pragma unroll
          for (int c = 0; c < D; ++c) sum[c] = 0.0f;
#pragma unroll 1
          for (int p = q; p < q + len; ++p) {
            float v[D];
            load_row<D, D>(rows_s + p * D, v);
#pragma unroll
            for (int c = 0; c < D; ++c) sum[c] += v[c];
          }
          store_row<D>(o_out + static_cast<long long>(r) * D, sum);
        } else {
          long_head = true;
        }
      }
    }
    zero_rows<D>(o_out, gap_lo, gap_hi, lane);
    zero_rows<D>(o_out, tail_lo, tail_hi, lane);
    const unsigned longs = __ballot_sync(kFull, long_head);
    if (longs) {
      const int src = __ffs(longs) - 1;
      long_run<D>(rows_s, rank_s, ring, d_in, r_in, o_out, t0, staged, n,
                  __shfl_sync(kFull, q, src), __shfl_sync(kFull, r, src), lane);
    }
  }
}

// The cluster form (kCluster: a cluster of `blocks` blocks a cloud, block j
// holding rows [j m, j m + m)) and the global form's tiles (b x
// `blocks` blocks, tile j of a cloud holding rows [j m, j m + m), writing
// flags[cloud * blocks + j] = 1 when its ranks are out of order).
template <int D, bool kCluster>
__global__ void __launch_bounds__(kSegThreads, 1)
    segment_tile_kernel(const float* __restrict__ data,
                        const int* __restrict__ rank, float* __restrict__ out,
                        int* __restrict__ flags, int n, int m, int blocks) {
  extern __shared__ __align__(16) uint4 tile_smem[];
  __shared__ int votes[kClusterBlocks];  // each block's: ranks out of order
  __shared__ int warp_total[kSegWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long cloud = blockIdx.x / blocks;
  const int j = static_cast<int>(blockIdx.x % blocks);  // the cluster rank
  const int t0 = j * m;
  const int rows = max(0, min(n, t0 + m) - t0);
  const int staged = min(n, t0 + m + kShortRun) - min(n, t0);
  const int* r_in = rank + cloud * n;
  const float* d_in = data + cloud * n * D;
  float* o_out = out + cloud * n * D;

  int* rank_s = reinterpret_cast<int*>(tile_smem);  // [q + 1]: row t0 + q
  float* rows_s = reinterpret_cast<float*>(rank_s + tile_rank_words(m));
  float* ring = rows_s + tile_rows_words<D>(m);

  if constexpr (kCluster) {  // waited for before the first remote access
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  }
  // Stage: the rows (cp.async, behind the checks) and the ranks, -1 before
  // row 0 and n past the last row (no rank equals either), every load in
  // flight at once.
  if (staged > 0) {
    stage_rows<D>(rows_s, d_in + static_cast<long long>(t0) * D, staged);
  }
  {
    constexpr int kLoads =
        (kSharedMaxRows + kShortRun + 2 + kSegThreads - 1) / kSegThreads;
    int v[kLoads];
#pragma unroll
    for (int a = 0; a < kLoads; ++a) {
      const int q = tid + a * kSegThreads;
      const int row = t0 - 1 + q;
      v[a] = q > m + kShortRun + 1 || row < 0 ? -1 : (row < n ? r_in[row] : n);
    }
#pragma unroll
    for (int a = 0; a < kLoads; ++a) {
      const int q = tid + a * kSegThreads;
      if (q <= m + kShortRun + 1) rank_s[q] = v[a];
    }
  }
  __syncthreads();
  int bad = 0;
  for (int q = tid; q < rows; q += kSegThreads) {
    const int r = rank_s[q + 1];
    if (r < 0 || r >= n) __trap();  // outside [0, n)
    bad |= rank_s[q] > r;           // below the row before
  }
  bad = __syncthreads_or(bad);

  if constexpr (!kCluster) {
    if (tid == 0) flags[cloud * blocks + j] = bad;
    if (bad) return;  // segment_sum_kernel recomputes the cloud
  } else {
    cg::cluster_group cluster = cg::this_cluster();
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    if (tid < blocks) *cluster.map_shared_rank(&votes[j], tid) = bad;
    cluster_sync_all();  // every vote is in
    int any = 0;
#pragma unroll
    for (int b = 0; b < kClusterBlocks; ++b) any |= b < blocks ? votes[b] : 0;
    if (any) {
      // Any order: an LSD radix sort of (rank, row) by 8-bit digits over
      // the cluster; block j holds sorted positions [j m, j m + rows).
      const int mr = round4(m);
      int* sort_s = rank_s + tile_rank_words(m);  // keys, keys, rows, rows
      int* seg_start = sort_s + 4 * mr;  // own segments t0 + k
      int* seg_end = sort_s + 5 * mr;
      unsigned char* cnt = reinterpret_cast<unsigned char*>(sort_s + 6 * mr);
      unsigned char* ebuf = cnt + 256 * kSegWarps;
      int* dtot = sort_s + 6 * mr + 256 * kSegWarps / 4 + mr / 4;
      int* base = dtot + 256;
      stage_wait();  // the rows' copy lands before its space is reused
      __syncthreads();
      for (int q = tid; q < rows; q += kSegThreads) {
        sort_s[q] = rank_s[q + 1];
        sort_s[2 * mr + q] = t0 + q;
        seg_start[q] = -1;
      }
      const unsigned lower_lanes = (1u << lane) - 1u;
      const int per_warp = (m + kSegWarps - 1) / kSegWarps;  // <= 160
      const int w0 = min(rows, warp * per_warp);
      const int w1 = min(rows, w0 + per_warp);
      const int passes = (32 - __clz(n - 1) + 7) / 8;
      for (int pass = 0; pass < passes; ++pass) {
        const int* kc = sort_s + (pass & 1) * mr;
        const int* vc = kc + 2 * mr;
        int* kn = sort_s + ((pass & 1) ^ 1) * mr;
        int* vn = kn + 2 * mr;
        const int shift = 8 * pass;
        for (int q = tid; q < 256 * kSegWarps / 16; q += kSegThreads) {
          reinterpret_cast<uint4*>(cnt)[q] = make_uint4(0u, 0u, 0u, 0u);
        }
        __syncthreads();
        // per-warp digit counts; each row's earlier rows of its digit in
        // its warp
        for (int i0 = w0; i0 < w1; i0 += 32) {
          const int i = i0 + lane;
          const int g = i < w1 ? (kc[i] >> shift) & 255 : -1;
          const unsigned peers = match_lanes(g, 8);
          int before = 0;
          unsigned char* c = cnt + 32 * max(g, 0) + warp;
          if (g >= 0) before = *c;
          __syncwarp();
          if (g >= 0 && (peers & lower_lanes) == 0) {
            *c = static_cast<unsigned char>(before + __popc(peers));
          }
          __syncwarp();
          if (g >= 0) {
            ebuf[i] = static_cast<unsigned char>(before + __popc(peers & lower_lanes));
          }
        }
        __syncthreads();
        if (tid < 256) {
          const unsigned* words = reinterpret_cast<const unsigned*>(cnt + 32 * tid);
          unsigned t = 0;
#pragma unroll
          for (int w = 0; w < kSegWarps / 4; ++w) t = __dp4a(words[w], 0x01010101u, t);
          dtot[tid] = static_cast<int>(t);
        }
        cluster_sync_all();  // every block's digit totals are in place
        // base[g]: the positions of smaller digits in the cluster, then
        // digit g's rows in the blocks before this one
        int total = 0, inc = 0;
        if (tid < 256) {
          int t[kClusterBlocks];
#pragma unroll
          for (int b = 0; b < kClusterBlocks; ++b) {
            t[b] = b < blocks ? *cluster.map_shared_rank(&dtot[tid], b) : 0;
          }
          int before = 0;
#pragma unroll
          for (int b = 0; b < kClusterBlocks; ++b) {
            total += t[b];
            if (b < j) before += t[b];
          }
          inc = total;
#pragma unroll
          for (int off = 1; off < 32; off <<= 1) {
            const int o = __shfl_up_sync(kFull, inc, off);
            if (lane >= off) inc += o;
          }
          if (lane == 31) warp_total[warp] = inc;
          inc += before - total;  // exclusive, plus the earlier blocks'
        }
        __syncthreads();
        if (tid < 256) {
          for (int w = 0; w < warp; ++w) inc += warp_total[w];
          base[tid] = inc;
        }
        __syncthreads();
        // stable placement into the owner block of each position
        for (int i = w0 + lane; i < w1; i += 32) {
          const int k = kc[i];
          const int g = (k >> shift) & 255;
          const int dest = base[g] + warps_before(cnt + 32 * g, warp) + ebuf[i];
          const int o = dest / m;
          const int l = dest - o * m;
          *cluster.map_shared_rank(kn + l, o) = k;
          *cluster.map_shared_rank(vn + l, o) = vc[i];
        }
        cluster_sync_all();  // placed; every read of this pass is done
      }
      // Segment bounds: a position heads its segment when its rank differs
      // from the position before; the owner block of each segment gets its
      // start and end.
      const int* kf = sort_s + (passes & 1) * mr;
      const int* vf = kf + 2 * mr;
      for (int q = tid; q < rows; q += kSegThreads) {
        const int p = t0 + q;
        const int k = kf[q];
        int prev = -1;
        if (q > 0) {
          prev = kf[q - 1];
        } else if (j > 0) {
          prev = *cluster.map_shared_rank(const_cast<int*>(kf) + (m - 1), j - 1);
        }
        if (k != prev) {
          *cluster.map_shared_rank(seg_start + k % m, k / m) = p;
          if (prev >= 0) *cluster.map_shared_rank(seg_end + prev % m, prev / m) = p;
        }
        if (p == n - 1) *cluster.map_shared_rank(seg_end + k % m, k / m) = n;
      }
      cluster_sync_all();
      walk_segments<D, false, false>(
          d_in, rows,
          [&](int k) { return make_int2(seg_start[k], seg_end[k]); },
          [&](int p) {
            return *cluster.map_shared_rank(const_cast<int*>(vf) + p % m, p / m);
          },
          o_out + static_cast<long long>(t0) * D, lane);
      cluster_sync_all();  // no peer reads this block's rows any more
      return;
    }
  }
  stage_wait();
  __syncthreads();
  tile_runs<D>(rows_s, rank_s, ring, d_in, r_in, o_out, t0, rows,
               staged, n, lane);
}

template <int D, bool kCluster>
int launch_tiles(const float* data, const int* rank, float* out, int* flags,
                 long long b, int n, int m, int blocks, cudaStream_t s) {
  auto kernel = segment_tile_kernel<D, kCluster>;
  const int smem = 4 * tile_words<D>(m, kCluster);
  // the dynamic shared memory granted so far, a device (set once: a call
  // a launch costs the host more than the kernel takes at small b)
  static int allowed[64];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= 64 || smem > allowed[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < 64) allowed[device] = smem;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(b * blocks));
  config.blockDim = dim3(kSegThreads);
  config.dynamicSmemBytes = smem;
  config.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster ? blocks : 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = kCluster ? 1 : 0;
  err = cudaLaunchKernelEx(&config, kernel, data, rank, out, flags, n, m,
                           blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_segment_sum(const float* data, const int* rank, float* out,
                       int* scratch, long long b, long long n, int blocks,
                       cudaStream_t s) {
  const unsigned clouds = static_cast<unsigned>(b);
  const int rows = static_cast<int>(n);
  if (n > kClusterMaxRows) {  // tiles, then the counting sort where needed
    int* flags = scratch + kScratchInts * n * b;
    const int err = launch_tiles<D, false>(data, rank, out, flags, b, rows,
                                           kGlobalTileRows, blocks, s);
    if (err != 0) return err;
    segment_sum_kernel<D, false><<<clouds, kSegThreads, 0, s>>>(
        data, rank, out, scratch, flags, rows, blocks);
    return static_cast<int>(cudaGetLastError());
  }
  if (blocks > 1) {
    return launch_tiles<D, true>(data, rank, out, nullptr, b, rows,
                                 (rows + blocks - 1) / blocks, blocks, s);
  }
  const int smem = static_cast<int>(n * (32 + 3 * sizeof(int)));
  cudaError_t err = cudaFuncSetAttribute(
      segment_sum_kernel<D, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(segment_sum_kernel<D, true>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  segment_sum_kernel<D, true><<<clouds, kSegThreads, smem, s>>>(
      data, rank, out, nullptr, nullptr, rows, 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// data: (b, n, d) f32, rank: (b, n) int32, out: (b, n, d) f32, 16-byte
// aligned, every row written (no need to initialise it); tiles: the tiles a
// cloud, ceil(n / 1024), as the caller's plan counts them.  Returns a
// cudaError_t code (0 on success).
extern "C" int pcp_sorted_segment_sum(const float* data, const int* rank,
                                      float* out, long long b, long long n,
                                      int d, int tiles, void* stream) {
  if (b == 0 || n == 0) return 0;
  if (b < 0 || n < 0 || n > 0x7fffffffLL ||
      tiles != (n + kTileRows - 1) / kTileRows ||
      b * tiles > 0x7fffffffLL || reinterpret_cast<uintptr_t>(out) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>(b * tiles);
  switch (d) {
    case 4:
      sorted_segment_sum_kernel<4><<<blocks, kThreads, 0, s>>>(
          data, rank, out, static_cast<int>(n), tiles);
      break;
    case 5:
      sorted_segment_sum_kernel<5><<<blocks, kThreads, 0, s>>>(
          data, rank, out, static_cast<int>(n), tiles);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}


// Any-rank segment sum.  data: (b, n, d) f32 with 1 <= d <= 8, rank: (b, n)
// int32 in [0, n), out: (b, n, d) f32, 16-byte aligned, every row written.
// blocks: the blocks a cloud, as ops/cuda/voxel_reduce.py::segment_sum_form
// gives them: 1 (the shared form, n <= 5,120), 2 to 8 holding at most 5,120
// rows each (a cluster), or ceil(n / 2,048) for n > 40,960 (the global
// form's tiles).  scratch: in the global form, (b, 35 n + blocks) int32 of
// device memory (no need to initialise it); else unused.  Takes n <= 2^30.
// Returns a cudaError_t code (0 on success).
extern "C" int pcp_segment_sum(const float* data, const int* rank, float* out,
                               int* scratch, long long b, long long n, int d,
                               int blocks, void* stream) {
  if (b == 0 || n == 0) return 0;
  const bool global = n > kClusterMaxRows;
  const bool form = global ? blocks == (n + kGlobalTileRows - 1) / kGlobalTileRows
                    : blocks == 1 ? n <= kSharedMaxRows
                                  : blocks >= 2 && blocks <= kClusterBlocks &&
                                        (n + blocks - 1) / blocks <= kSharedMaxRows;
  if (b < 0 || n < 0 || b > 0x7fffffffLL || n > kMaxRows || !form ||
      b * blocks > 0x7fffffffLL || reinterpret_cast<uintptr_t>(out) % 16 ||
      (global && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: return launch_segment_sum<1>(data, rank, out, scratch, b, n, blocks, s);
    case 2: return launch_segment_sum<2>(data, rank, out, scratch, b, n, blocks, s);
    case 3: return launch_segment_sum<3>(data, rank, out, scratch, b, n, blocks, s);
    case 4: return launch_segment_sum<4>(data, rank, out, scratch, b, n, blocks, s);
    case 5: return launch_segment_sum<5>(data, rank, out, scratch, b, n, blocks, s);
    case 6: return launch_segment_sum<6>(data, rank, out, scratch, b, n, blocks, s);
    case 7: return launch_segment_sum<7>(data, rank, out, scratch, b, n, blocks, s);
    case 8: return launch_segment_sum<8>(data, rank, out, scratch, b, n, blocks, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The clusters of `blocks` blocks of the cluster form (d 4, the rows of n =
// 5,120 * blocks / 2) that the card holds at once, by
// cudaOccupancyMaxActiveClusters; a negative cudaError_t code on failure.
extern "C" int pcp_segment_clusters_a_wave(int blocks) {
  auto kernel = segment_tile_kernel<4, true>;
  const int m = kSharedMaxRows / 2;
  const int smem = 4 * tile_words<4>(m, true);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(blocks));
  config.blockDim = dim3(kSegThreads);
  config.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
  return err == cudaSuccess ? clusters : -static_cast<int>(err);
}

extern "C" const char* pcp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

