// Segment sums for the voxel downsample and the stride sampler: two kernels
// in one library, as the JAX package keeps both in one file.
//
// - sorted_segment_sum_kernel replaces ops/pallas/voxel_reduce.py::
//    sorted_segment_reduce_pallas, the banded one-hot MXU contraction with a
//    bf16 hi/lo split that the JAX package runs on the TPU.
// - segment_sum_kernel (further down) replaces ops/pallas/voxel_reduce.py::
//    segment_reduce_pallas, the dense one-hot contraction for any rank, with
//    a stable counting sort per cloud.
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

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

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

// segment_sum_kernel: the segment sum for ANY rank in [0, n), in any order.
//
// The TPU kernel builds a (k_tile, n) one-hot slab per output tile and
// contracts it on the MXU: every output tile scans every row.  Here it is a
// stable counting sort per cloud, O(n): one block of kSegThreads = 1,024
// threads a cloud.  Warp w owns the contiguous rows [w L, (w + 1) L),
// L = ceil(n / 32), and walks them 32 at a time, so the warps' row ranges
// are in warp order.
//
// Invariant: each segment's sum is 0.0f + its rows in increasing row order,
// one add at a time.  That is PyTorch's CPU scatter_add_ and XLA's CPU
// segment_sum bit for bit.  Nothing is added with atomics or in a tree;
// only integer counts and positions are computed in parallel, and those do
// not depend on the schedule.
//
//  (0) Ranks.  Each warp reads its ranks; a rank outside [0, n) traps.  If
//      no rank is below the one before it (a block vote), the cloud is
//      already in segment order (the permutation is the identity): each
//      head row (row 0, or a new rank) records where its segment starts
//      and where the one before ends, and (d) walks those runs.  Every
//      rank that the voxel and stride paths give takes this path.
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
//  (d) Sum.  Each thread owns segments k = tid, tid + 1,024, ... and adds
//      their rows in permutation order from 0.0f, a few rows loaded ahead
//      of the adds.  Every output row is written (0 for an empty segment).
//
// The price of the order is a long segment walked by one thread: a
// zero-padded scan is one segment of n rows, n dependent adds
// (chip_smoke.py phase 9 times a 256x2000 batch of zero-padded scans).
//
// Memory forms, chosen by n (ops/cuda/voxel_reduce.py::segment_sum_form):
// - n <= kSharedMaxRows = 5,120: everything in shared memory, 44 B a row:
//   a byte count for each warp (a warp holds at most L <= 160 rows, so a
//   byte holds its count), 32; start, permutation and the ranks (then each
//   row's rank << 8 | earlier-row count), 4 each.  88 KB at n = 2,000, so
//   two blocks fit an SM and 256 clouds run in one wave.  The data rows
//   are copied into the counts' space with cp.async as the kernel starts
//   (32 B a row >= 4 d B), so the walks read shared memory; the counting
//   sort copies them again after (c).
// - larger n: 32-bit counts, start, permutation and the earlier-row counts
//   in a device-memory scratch of kScratchInts ints a row that the caller
//   allocates; ranks and rows are read from device memory.
// Limits: 1 <= d <= 8, n <= 2^30, b < 2^31.
//
// The function is bound by device-memory bytes (each row and rank read
// once, each output row written once).  On in-order ranks this kernel
// adds a few dependent latencies a block to that: the rank loads, the
// vote, the copy and the walks.

constexpr int kSegThreads = 1024;
constexpr int kSegWarps = kSegThreads / 32;
constexpr int kSharedMaxRows = 5120;  // 44 B a row: 225,280 B
constexpr long long kMaxRows = 1LL << 30;
constexpr int kScratchInts = kSegWarps + 3;  // device-memory form: a row

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
  unsigned peers = __ballot_sync(0xffffffffu, r >= 0);
  for (int b = 0; b < bits; ++b) {
    const bool one = (r >> b) & 1;
    const unsigned ones = __ballot_sync(0xffffffffu, one);
    peers &= one ? ones : ~ones;
  }
  return peers;
}

// Start copying a cloud's n rows of D floats into shared memory (cp.async:
// no registers, the copy runs behind the next phases); stage_wait() waits
// for this thread's copies, and a barrier after it for everyone's.
template <int D>
__device__ __forceinline__ void stage_rows(float* stage, const float* src,
                                           int n) {
  const int count = n * D;
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

// out = 0.0f + rows[row_of(p)] for p = p0 .. p1 - 1, one add at a time, a
// few rows loaded ahead of the adds.  kAligned: rows are 16-byte aligned
// where D allows (shared memory); out always is.
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

template <int D, bool kShared>
__global__ void __launch_bounds__(kSegThreads, 2)
    segment_sum_kernel(const float* __restrict__ data,
                       const int* __restrict__ rank, float* __restrict__ out,
                       int* __restrict__ scratch, int n) {
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
      int prev = __shfl_up_sync(0xffffffffu, r, 1);
      if (lane == 0) prev = carry;
      carry = __shfl_sync(0xffffffffu, r, 31);
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
    for (int k = tid; k < n; k += kSegThreads) {
      const int s = start[k];
      walk<D, kShared>(rows, s, s < 0 ? s : end[k], [](int p) { return p; },
                       o_out + static_cast<long long>(k) * D);
    }
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
      const int o = __shfl_up_sync(0xffffffffu, inc, off);
      if (lane >= off) inc += o;
    }
    if (lane == 31) warp_total[warp] = inc;
    __syncthreads();
    if (warp == 0) {
      const int w = warp_total[lane];
      int winc = w;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_up_sync(0xffffffffu, winc, off);
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
  for (int k = tid; k < n; k += kSegThreads) {
    walk<D, kShared>(rows, start[k], k + 1 < n ? start[k + 1] : n,
                     [perm](int p) { return perm[p]; },
                     o_out + static_cast<long long>(k) * D);
  }
}

template <int D>
int launch_segment_sum(const float* data, const int* rank, float* out,
                       int* scratch, long long b, long long n, cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>(b);
  const int rows = static_cast<int>(n);
  if (n > kSharedMaxRows) {
    segment_sum_kernel<D, false><<<blocks, kSegThreads, 0, s>>>(
        data, rank, out, scratch, rows);
    return static_cast<int>(cudaGetLastError());
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
  segment_sum_kernel<D, true><<<blocks, kSegThreads, smem, s>>>(
      data, rank, out, nullptr, rows);
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
// int32 in [0, n), out: (b, n, d) f32, every row written.  scratch: for
// n > 5,120, (b, 35 n) int32 of device memory (no need to initialise it);
// else unused.  Takes n <= 2^30.  Returns a cudaError_t code (0 on
// success).
extern "C" int pcp_segment_sum(const float* data, const int* rank, float* out,
                               int* scratch, long long b, long long n, int d,
                               void* stream) {
  if (b == 0 || n == 0) return 0;
  if (b < 0 || n < 0 || b > 0x7fffffffLL || n > kMaxRows ||
      (n > kSharedMaxRows && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: return launch_segment_sum<1>(data, rank, out, scratch, b, n, s);
    case 2: return launch_segment_sum<2>(data, rank, out, scratch, b, n, s);
    case 3: return launch_segment_sum<3>(data, rank, out, scratch, b, n, s);
    case 4: return launch_segment_sum<4>(data, rank, out, scratch, b, n, s);
    case 5: return launch_segment_sum<5>(data, rank, out, scratch, b, n, s);
    case 6: return launch_segment_sum<6>(data, rank, out, scratch, b, n, s);
    case 7: return launch_segment_sum<7>(data, rank, out, scratch, b, n, s);
    case 8: return launch_segment_sum<8>(data, rank, out, scratch, b, n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* pcp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
