// Self-kNN of every point of a cloud in its own feature space: DGCNN's graph.
//
//   out[b, i, :] = the k points j of cloud b with the smallest
//                  d_ij = max(|x_i|^2 + |x_j|^2 - 2 x_i.x_j, 0), self included,
//                  ascending by (d_ij, j).
//
// Replaces no TPU kernel: pointcloudprocessing_tpu/models/dgcnn.py::knn_graph
// leaves the (b, n, n) distances and their selection to XLA (an einsum, then
// lax.approx_min_k on the TPU, lax.top_k where exact).  The port's plain
// version (ops/cuda/knn_select.py::knn_select_reference) does the same in
// PyTorch: an f32 product on the CUDA cores, four (b, n, n) elementwise
// passes and torch.topk's radix select, which at DGCNN's serving shape (256
// clouds of 1,024 points, four graphs over 3, 64, 64 and 128 channels) took
// 52 of a batch's 76 device ms on the H100, writing and reading several
// 1 GiB tensors a graph.
//
// What bounds it on the H100: the f32 multiply-adds of the distance
// products, n^2 c a cloud (69.5 G at that shape, four graphs), about 2.1 ms
// on the CUDA cores at 67 TFLOP/s.  The selection is a compare a candidate
// and about k (1 + ln(n / k)) inserts a row; the output is b n k int32 (21
// MB a graph).  No (b, n, n) tensor leaves the SM.  What holds it above that
// bound, read on the card: shared memory's 128 bytes a clock to the
// registers.  The register tile's float4 loads (1.5 bytes an FFMA) and the
// selection's loads and shuffles share it, so the two phases add (9.3 ms for
// the four graphs: 5.6 without the selection); an 8 x 8 register tile
// spilled and ran slower, and two rows' inserts interleaved gained 1.5%.
//
// Design.  A block takes one cloud's tile of kQ = 64 query rows; kP = 128
// candidate points at a time stream past it, each tile's channels in chunks
// of kC = 32 through a double-buffered pair of shared buffers (cp.async, 16
// bytes a copy where c % 4 == 0 and the rows are 16-byte aligned, 4 bytes
// otherwise; rows past n and channels past c land as zeros, which add
// nothing).  While one chunk loads, 256 threads take the previous one into a
// register tile of 4 query rows x 8 candidates each (rows ty + 16 i, columns
// tx + 16 j: a quarter-warp's float4 loads hit 32 distinct banks), by f32
// FFMA, channel after channel, the arithmetic class of the SIMT f32 GEMM it
// replaces.  The squared norms are summed in the same order from the same
// staged values (query rows in the first tile, candidates in every tile),
// so d_ii is exactly 0.  The distance is the plain version's expansion,
// (|q|^2 + |p|^2) - 2 q.p with 2 q.p exact, clamped below at 0 (a NaN reads 0,
// as fmaxf gives it) and above at FLT_MAX, so that every real candidate
// beats the +inf of an empty slot; columns past n read +inf.
//
// The tile's 64 x 128 distances go to shared memory.  Each warp owns 8 query
// rows and keeps each row's running list in registers: a list of 32 W
// entries, W = 1, 2, 4 or 8 (the least with k <= 32 W; the wrapper's
// ``list_width``), entry 32 w + l in lane l's w-th register, ascending, the
// entries past k the next ones.  The first 32 candidates of a row fill the
// first 32 entries by a bitonic sort across the warp (the rest read +inf).
// Then a warp reads a row 32 columns at a time; a ballot against the row's
// k-th distance keeps the few that beat it, which the warp packs in order
// into a shared slot of its own, and inserts one after the other: each entry
// is compared with the new one and with the entry before it (a shuffle up,
// and lane 31 of the register before for lane 0), so the entries past its
// place move up one and the first entry past those at or below it takes it
// (no count of the place, whose population counts and bit scans run at half
// the shuffle's rate: 1.3x faster at W = 1).  Candidates arrive in ascending index and an insert
// goes after the entries equal to it, so equal distances break on the lower
// index and the k members are distinct by construction.  The next tile's
// first chunk loads while the warps select.  At the end lanes 0..k-1 write
// the row's indices, ascending by distance: torch.topk's contract.
//
// Semantics: any n >= k, any c >= 1, 1 <= k <= 256, f32 features (b, n, c)
// contiguous; the wrapper checks all of it.

#include <cfloat>
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kQ = 64;             // query rows a block
constexpr int kP = 128;            // candidate points a tile
constexpr int kC = 32;             // channels a chunk
constexpr int kCS = kC + 4;        // a staged row's stride in floats (144 bytes)
constexpr int kDS = kP + 16;       // the distance tile's row stride in floats
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kQ / kWarps;  // query rows a warp selects for
constexpr int kMaxWidth = 8;  // registers a lane holds of a row's list
constexpr unsigned kFull = 0xffffffffu;

struct Smem {
  float q[2][kQ * kCS];  // query rows' chunk, double-buffered
  float p[2][kP * kCS];  // candidates' chunk, double-buffered
  float d[kQ * kDS];     // the tile's distances
  float sq_q[kQ];
  float sq_p[kP];
  float2 taken[kWarps][32];  // a warp's candidates of a part that beat its k-th
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copy chunk (rows q0.. and p0.., channels c0 .. c0 + 4 groups) of the cloud's
// features f (n x c) into buffer `buf`; rows past n and channels past c as
// zeros.
__device__ __forceinline__ void stage(Smem& sm, int buf, const float* f, int n, int c,
                                      int q0, int p0, int c0, int groups, bool vec) {
  const int tid = threadIdx.x;
  float* qs = sm.q[buf];
  float* ps = sm.p[buf];
  if (vec) {
    for (int e = tid; e < (kQ + kP) * groups; e += kThreads) {
      const int r = e / groups;
      const int g = e - r * groups;
      const bool is_q = r < kQ;
      const int row = is_q ? q0 + r : p0 + (r - kQ);
      float* dst = (is_q ? qs + r * kCS : ps + (r - kQ) * kCS) + 4 * g;
      const int ch = c0 + 4 * g;
      const bool ok = row < n && ch < c;
      const float* src = ok ? f + static_cast<long long>(row) * c + ch : f;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                   ::"r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0) : "memory");
    }
  } else {
    const int width = 4 * groups;
    for (int e = tid; e < (kQ + kP) * width; e += kThreads) {
      const int r = e / width;
      const int ch_in = e - r * width;
      const bool is_q = r < kQ;
      const int row = is_q ? q0 + r : p0 + (r - kQ);
      float* dst = (is_q ? qs + r * kCS : ps + (r - kQ) * kCS) + ch_in;
      const int ch = c0 + ch_in;
      const bool ok = row < n && ch < c;
      const float* src = ok ? f + static_cast<long long>(row) * c + ch : f;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
                   ::"r"(smem_addr(dst)), "l"(src), "r"(ok ? 4 : 0) : "memory");
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Sort (v, j) across the warp's lanes, ascending by v, then j (bitonic).
__device__ __forceinline__ void warp_sort(float& v, int& j, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const float ov = __shfl_xor_sync(kFull, v, stride);
      const int oj = __shfl_xor_sync(kFull, j, stride);
      const bool less = ov < v || (ov == v && oj < j);
      // the lower lane of a pair keeps the smaller in an ascending run
      if (less == (((lane & stride) == 0) == ((lane & size) == 0))) {
        v = ov;
        j = oj;
      }
    }
  }
}

__device__ __forceinline__ float norm_fma(float4 v, float s) {
  s = fmaf(v.x, v.x, s);
  s = fmaf(v.y, v.y, s);
  s = fmaf(v.z, v.z, s);
  return fmaf(v.w, v.w, s);
}

// The list's k-th distance (entry k - 1: register kw of lane kl), to every
// lane.
template <int W>
__device__ __forceinline__ float kth(const float (&ld)[W], int kw, int kl) {
  float v = ld[0];
#pragma unroll
  for (int w = 1; w < W; ++w)
    if (w == kw) v = ld[w];
  return __shfl_sync(kFull, v, kl);
}

// W: registers a lane holds of each row's list (32 W >= k).  Two blocks an
// SM at W = 1; a longer list takes the registers of the second.
template <int W>
__global__ void __launch_bounds__(kThreads, W == 1 ? 2 : 1)
knn_select_kernel(const float* __restrict__ feats, int* __restrict__ out, int n, int c,
                  int k, int qtiles, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const long long cloud = blockIdx.x / qtiles;
  const int q0 = (blockIdx.x - static_cast<int>(cloud) * qtiles) * kQ;
  const float* f = feats + cloud * n * c;

  const int chunks = (c + kC - 1) / kC;
  const int tiles = (n + kP - 1) / kP;
  const int steps = tiles * chunks;
  auto groups_of = [&](int h) { return (min(kC, c - h * kC) + 3) / 4; };

  float acc[4][8];
  float ld[kRows][W];  // lane l, register w: entry 32 w + l of each of the warp's rows
  int li[kRows][W];    // its index
  float thr[kRows];    // the row's k-th distance
  const int kw = (k - 1) >> 5;
  const int kl = (k - 1) & 31;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int w = 0; w < W; ++w) {
      ld[r][w] = INFINITY;
      li[r][w] = 0;
    }
    thr[r] = INFINITY;
  }
  float sq_q = 0.0f;  // thread tid < kQ: query row tid
  float sq_p = 0.0f;  // thread tid < kP: candidate tid of the tile

  stage(sm, 0, f, n, c, q0, 0, 0, groups_of(0), vec);
  for (int s = 0; s < steps; ++s) {
    const int t = s / chunks;
    const int h = s - t * chunks;
    const int buf = s & 1;
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();
    if (s + 1 < steps) {
      const int t1 = (s + 1) / chunks;
      const int h1 = s + 1 - t1 * chunks;
      stage(sm, buf ^ 1, f, n, c, q0, t1 * kP, h1 * kC, groups_of(h1), vec);
    }
    if (h == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
      sq_p = 0.0f;
    }
    const float* qs = sm.q[buf];
    const float* ps = sm.p[buf];
    const int groups = groups_of(h);
    for (int g = 0; g < groups; ++g) {
      float4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * kCS + 4 * g);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 bv = *reinterpret_cast<const float4*>(ps + (tx + 16 * j) * kCS + 4 * g);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float v = fmaf(a[i].x, bv.x, acc[i][j]);
          v = fmaf(a[i].y, bv.y, v);
          v = fmaf(a[i].z, bv.z, v);
          acc[i][j] = fmaf(a[i].w, bv.w, v);
        }
      }
    }
    if (tid < kP) {
      for (int g = 0; g < groups; ++g)
        sq_p = norm_fma(*reinterpret_cast<const float4*>(ps + tid * kCS + 4 * g), sq_p);
    }
    if (t == 0 && tid < kQ) {
      for (int g = 0; g < groups; ++g)
        sq_q = norm_fma(*reinterpret_cast<const float4*>(qs + tid * kCS + 4 * g), sq_q);
    }
    if (h != chunks - 1) continue;

    // ---- the tile's distances, into shared memory
    if (tid < kP) sm.sq_p[tid] = sq_p;
    if (t == 0 && tid < kQ) sm.sq_q[tid] = sq_q;
    __syncthreads();
    const int p0 = t * kP;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
      const float sqi = sm.sq_q[row];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = tx + 16 * j;
        float v = (sqi + sm.sq_p[col]) - 2.0f * acc[i][j];
        v = fminf(fmaxf(v, 0.0f), FLT_MAX);
        sm.d[row * kDS + col] = p0 + col < n ? v : INFINITY;
      }
    }
    __syncthreads();

    // ---- each warp's rows take the tile's candidates that beat their k-th
    float2* taken = sm.taken[warp];
    const unsigned below = (1u << lane) - 1u;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = warp * kRows + r;
      if (q0 + row >= n) continue;
      const float* drow = sm.d + row * kDS;
#pragma unroll
      for (int part = 0; part < kP / 32; ++part) {
        const float v = drow[part * 32 + lane];
        if (t == 0 && part == 0) {
          // the first 32 candidates all enter the empty list: sort them
          float sv = v;
          int sj = lane;
          warp_sort(sv, sj, lane);
          ld[r][0] = sv;
          li[r][0] = sj;
          thr[r] = kth(ld[r], kw, kl);
          continue;
        }
        const bool in = v < thr[r];
        const unsigned m = __ballot_sync(kFull, in);
        if (m == 0) continue;
        if (in) taken[__popc(m & below)] = make_float2(v, __int_as_float(p0 + part * 32 + lane));
        __syncwarp();
        const int count = __popc(m);
        for (int e = 0; e < count; ++e) {
          // entries past the new one's place move up one; the first entry
          // whose predecessor is at or below it takes it.  The last register
          // first, so that lane 31 of the one before is still the old entry.
          const float2 x = taken[e];
#pragma unroll
          for (int w = W - 1; w >= 0; --w) {
            float up_d = __shfl_up_sync(kFull, ld[r][w], 1);
            int up_i = __shfl_up_sync(kFull, li[r][w], 1);
            if (w > 0) {
              const float carry_d = __shfl_sync(kFull, ld[r][w - 1], 31);
              const int carry_i = __shfl_sync(kFull, li[r][w - 1], 31);
              if (lane == 0) {
                up_d = carry_d;
                up_i = carry_i;
              }
            }
            const bool keep = ld[r][w] <= x.x;
            const bool here = (w == 0 && lane == 0) || up_d <= x.x;
            ld[r][w] = keep ? ld[r][w] : (here ? x.x : up_d);
            li[r][w] = keep ? li[r][w] : (here ? __float_as_int(x.y) : up_i);
          }
        }
        __syncwarp();
        thr[r] = kth(ld[r], kw, kl);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + warp * kRows + r;
    if (row >= n) continue;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int e = 32 * w + lane;
      if (e < k) out[(cloud * n + row) * k + e] = li[r][w];
    }
  }
}

template <int W>
int launch(const float* feats, int* out, int blocks, int n, int c, int k, int qtiles,
           bool vec, cudaStream_t stream) {
  const size_t smem = sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(
      knn_select_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  knn_select_kernel<W><<<blocks, kThreads, smem, stream>>>(feats, out, n, c, k, qtiles, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// feats: (b, n, c) f32, contiguous; out: (b, n, k) int32.  1 <= k <= n,
// c >= 1; width: registers a lane holds of a row's list, 1, 2, 4 or 8, with
// k <= 32 width.  Returns a cudaError_t code (0 on success).
extern "C" int pcp_knn_select(const float* feats, int* out, long long b, int n, int c, int k,
                              int width, void* stream) {
  if (b == 0 || n == 0) return 0;
  const long long qtiles = (n + kQ - 1) / kQ;
  const bool width_ok = (width == 1 || width == 2 || width == 4 || width == kMaxWidth) &&
                        k <= 32 * width;
  if (b < 0 || n < 0 || c < 1 || k < 1 || k > n || !width_ok || b * qtiles > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = c % 4 == 0 && reinterpret_cast<uintptr_t>(feats) % 16 == 0;
  const int blocks = static_cast<int>(b * qtiles);
  const int tiles = static_cast<int>(qtiles);
  auto s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 1: return launch<1>(feats, out, blocks, n, c, k, tiles, vec, s);
    case 2: return launch<2>(feats, out, blocks, n, c, k, tiles, vec, s);
    case 4: return launch<4>(feats, out, blocks, n, c, k, tiles, vec, s);
    default: return launch<kMaxWidth>(feats, out, blocks, n, c, k, tiles, vec, s);
  }
}

extern "C" const char* pcp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
