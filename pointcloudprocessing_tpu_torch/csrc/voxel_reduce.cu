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
// ((d + 1) * 4 bytes with its rank) and each segment written once, a few MB
// per serving batch against 3.35 TB/s.  No matrix unit is needed.
//
// The runs are short on uniform scans (one or two rows) but long elsewhere:
// the invalid rows are all parked in bucket n - 1, a zero-padded scan is one
// voxel of n rows, a stride bucket spans up to n / k rows.  A walk of each
// run by one thread is serial in its length (0.3 ms for a 2048-row run on
// the H100, against 0.03 ms for scatter_add_), so the design is a
// segmented scan instead, whose time does not depend on the run lengths:
//
// One block per cloud walks the cloud in tiles of kThreads rows, one row a
// thread.  Each tile does a segmented inclusive prefix sum in fp32 with
// head flags (a row heads a segment when i == 0 or rank[i] != rank[i - 1]):
// a warp-shuffle scan within each warp, then warp 0 scans the warps' totals
// and the running sum carried in from the previous tile.  The last row of
// each segment then holds the segment's sum and writes it.  The order of the
// adds is fixed by the shapes, so the result is deterministic; there are no
// atomics.  Output rows of empty segments keep the zeros the wrapper
// allocated.
//
// The contract is checked on the device, where it costs no host sync: a
// rank outside [0, n) or a rank that decreases stops the kernel with a
// trap, so the next CUDA call raises instead of a wrong sum coming back.

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 1024;

// (head seen, sum) <- earlier (f0, v0) then later (f, v): a later head cuts
// the sum off from everything before it.
template <int D>
__device__ __forceinline__ void combine(int f0, const float (&v0)[D], int& f,
                                        float (&v)[D]) {
  if (!f) {
#pragma unroll
    for (int c = 0; c < D; ++c) v[c] = v0[c] + v[c];
  }
  f |= f0;
}

template <int D>
__device__ __forceinline__ void warp_scan(int lane, int& f, float (&v)[D]) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    float vo[D];
#pragma unroll
    for (int c = 0; c < D; ++c) vo[c] = __shfl_up_sync(0xffffffffu, v[c], off);
    const int fo = __shfl_up_sync(0xffffffffu, f, off);
    if (lane >= off) combine<D>(fo, vo, f, v);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    sorted_segment_sum_kernel(const float* __restrict__ data,
                              const int* __restrict__ rank,
                              float* __restrict__ out, int n) {
  constexpr int kWarps = kThreads / 32;
  __shared__ float warp_v[kWarps][D];  // each warp's total, then its prefix
  __shared__ int warp_f[kWarps];
  __shared__ float carry[D];           // running sum at the previous tile's end

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long base = (long long)blockIdx.x * n;
  const int* r = rank + base;
  if (tid < D) carry[tid] = 0.0f;

  for (int t0 = 0; t0 < n; t0 += kThreads) {
    const int i = t0 + tid;
    const bool live = i < n;
    int seg = -1;
    int f = 1;  // rows past n head empty segments of their own
    float v[D];
#pragma unroll
    for (int c = 0; c < D; ++c) v[c] = 0.0f;
    if (live) {
      seg = r[i];
      if (seg < 0 || seg >= n) __trap();  // outside [0, n)
      if (i > 0) {
        const int prev = r[i - 1];
        if (prev > seg) __trap();  // not monotone: runs would be split
        f = prev != seg;
      }
      const float* row = data + (base + i) * D;
#pragma unroll
      for (int c = 0; c < D; ++c) v[c] = row[c];
    }

    warp_scan<D>(lane, f, v);
    if (lane == 31) {
      warp_f[warp] = f;
#pragma unroll
      for (int c = 0; c < D; ++c) warp_v[warp][c] = v[c];
    }
    __syncthreads();
    if (warp == 0) {
      // inclusive scan of the warps' totals, then shift by one: the prefix
      // entering warp w, with the carry from the previous tile in front
      int wf = lane < kWarps ? warp_f[lane] : 1;
      float wv[D];
#pragma unroll
      for (int c = 0; c < D; ++c) wv[c] = lane < kWarps ? warp_v[lane][c] : 0.0f;
      warp_scan<D>(lane, wf, wv);
      int ef = __shfl_up_sync(0xffffffffu, wf, 1);
      float ev[D];
#pragma unroll
      for (int c = 0; c < D; ++c) ev[c] = __shfl_up_sync(0xffffffffu, wv[c], 1);
      if (lane == 0) {
        ef = 0;
#pragma unroll
        for (int c = 0; c < D; ++c) ev[c] = 0.0f;
      }
      float cv[D];
#pragma unroll
      for (int c = 0; c < D; ++c) cv[c] = carry[c];
      combine<D>(1, cv, ef, ev);
      if (lane < kWarps) {
#pragma unroll
        for (int c = 0; c < D; ++c) warp_v[lane][c] = ev[c];
      }
    }
    __syncthreads();
    float pv[D];
#pragma unroll
    for (int c = 0; c < D; ++c) pv[c] = warp_v[warp][c];
    combine<D>(1, pv, f, v);

    if (live && (i == n - 1 || r[i + 1] != seg)) {  // last row of its run
      float* o = out + (base + seg) * D;
#pragma unroll
      for (int c = 0; c < D; ++c) o[c] = v[c];
    }
    if (tid == kThreads - 1) {
#pragma unroll
      for (int c = 0; c < D; ++c) carry[c] = v[c];
    }
    // The next tile's first barrier orders the carry write before warp 0
    // reads it, and warp 0's rewrite of warp_v after every read above.  A
    // lane 31 rewrites its own warp's entry before that barrier, but only
    // after the full-warp shuffles of its scan, which its warp's reads of
    // the entry above precede.
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

// data: (b, n, d) f32, rank: (b, n) int32, out: (b, n, d) f32 zeroed by the
// caller.  Returns a cudaError_t code (0 on success).
extern "C" int pcp_sorted_segment_sum(const float* data, const int* rank,
                                      float* out, long long b, long long n,
                                      int d, void* stream) {
  if (b == 0 || n == 0) return 0;
  if (b < 0 || n < 0 || n > 0x7fffffffLL || b > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>(b);
  switch (d) {
    case 4:
      sorted_segment_sum_kernel<4><<<blocks, kThreads, 0, s>>>(
          data, rank, out, static_cast<int>(n));
      break;
    case 5:
      sorted_segment_sum_kernel<5><<<blocks, kThreads, 0, s>>>(
          data, rank, out, static_cast<int>(n));
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
