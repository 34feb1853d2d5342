// Segment sums for the voxel downsample and the stride sampler: two kernels
// in one library, as the JAX package keeps both in one file.
//
// - sorted_segment_sum_kernel replaces ops/pallas/voxel_reduce.py::
//    sorted_segment_reduce_pallas, the banded one-hot MXU contraction with a
//    bf16 hi/lo split that the JAX package runs on the TPU.
// - segment_sum_kernel (further down) replaces ops/pallas/voxel_reduce.py::
//    segment_reduce_pallas, the dense one-hot contraction for any rank.
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
// contracts it on the MXU: every output tile scans every row.  Here one
// block owns one (cloud, tile of kTile segments) and one thread one segment
// of the tile.  The block streams the cloud's ranks in chunks of kTile
// rows, one a thread; a ballot and a prefix over the warps compact the rows
// whose rank falls in the tile, in row order, into shared memory with their
// data; then each thread adds the compacted rows of its own segment.  So a
// segment's sum is 0 + its rows in increasing row order, the order of
// PyTorch's CPU scatter_add_, and the result is deterministic and needs no
// atomics.  Each data row is read once in all (by the block of its tile);
// the ranks are re-read once per tile, from L2.  The function is bound by
// device-memory bytes; this kernel's work is the compaction (b * n * n /
// kTile rank reads) and the per-thread scan of its tile's rows (b * n *
// kTile compares), so it lands several times over that bound.
//
// A rank outside [0, n) traps, as in sorted_segment_sum_kernel.  Output
// rows of empty segments are written as 0: the caller need not zero them.

constexpr int kTile = 128;

template <int D>
__global__ void __launch_bounds__(kTile)
    segment_sum_kernel(const float* __restrict__ data,
                       const int* __restrict__ rank,
                       float* __restrict__ out, int n) {
  constexpr int kWarps = kTile / 32;
  __shared__ int tile_seg[kTile];     // compacted rows: tile-local segment
  __shared__ float tile_row[kTile][D];  // and data, in row order
  __shared__ int warp_count[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long base = (long long)blockIdx.x * n;  // this cloud's rows
  const int k0 = blockIdx.y * kTile;                  // this tile's segments
  const int* r = rank + base;
  float acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = 0.0f;

  for (int c0 = 0; c0 < n; c0 += kTile) {
    const int i = c0 + tid;
    int local = -1;
    if (i < n) {
      const int seg = r[i];
      if (seg < 0 || seg >= n) __trap();  // outside [0, n)
      local = seg - k0;
    }
    const bool hit = local >= 0 && local < kTile;
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int pos = __popc(ballot & ((1u << lane) - 1u));
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int cnt = warp_count[w];
      if (w < warp) pos += cnt;
      total += cnt;
    }
    if (hit) {
      tile_seg[pos] = local;
      const float* row = data + (base + i) * D;
#pragma unroll
      for (int c = 0; c < D; ++c) tile_row[pos][c] = row[c];
    }
    __syncthreads();
    for (int j = 0; j < total; ++j) {
      if (tile_seg[j] == tid) {
#pragma unroll
        for (int c = 0; c < D; ++c) acc[c] += tile_row[j][c];
      }
    }
    // No third barrier: every read of warp_count above precedes the second
    // barrier, which precedes the next chunk's writes of it; and every
    // thread ends its scan of the tile rows before it reaches the next
    // chunk's first barrier, which precedes their rewrite.
  }
  const int seg = k0 + tid;
  if (seg < n) {
    float* o = out + (base + seg) * D;
#pragma unroll
    for (int c = 0; c < D; ++c) o[c] = acc[c];
  }
}

template <int D>
int launch_segment_sum(const float* data, const int* rank, float* out,
                       long long b, long long n, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(b),
                  static_cast<unsigned>((n + kTile - 1) / kTile));
  segment_sum_kernel<D><<<grid, kTile, 0, s>>>(data, rank, out,
                                                static_cast<int>(n));
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
// int32 in [0, n), out: (b, n, d) f32, every row written.  Returns a
// cudaError_t code (0 on success).
extern "C" int pcp_segment_sum(const float* data, const int* rank, float* out,
                               long long b, long long n, int d, void* stream) {
  if (b == 0 || n == 0) return 0;
  // grid.x takes the clouds, grid.y (at most 65535) the tiles of a cloud
  if (b < 0 || n < 0 || b > 0x7fffffffLL ||
      (n + kTile - 1) / kTile > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: return launch_segment_sum<1>(data, rank, out, b, n, s);
    case 2: return launch_segment_sum<2>(data, rank, out, b, n, s);
    case 3: return launch_segment_sum<3>(data, rank, out, b, n, s);
    case 4: return launch_segment_sum<4>(data, rank, out, b, n, s);
    case 5: return launch_segment_sum<5>(data, rank, out, b, n, s);
    case 6: return launch_segment_sum<6>(data, rank, out, b, n, s);
    case 7: return launch_segment_sum<7>(data, rank, out, b, n, s);
    case 8: return launch_segment_sum<8>(data, rank, out, b, n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* pcp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
