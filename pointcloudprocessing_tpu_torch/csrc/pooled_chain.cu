// Pooled chain: dense -> folded BatchNorm affine -> relu -> max over points,
// forward and backward, for the three (b, n, 1024) chains of the PointNet
// training step (both T-Nets' conv_layer_3 and the trunk's mlp_2_3).
//
// Replaces ops/pallas/pooled_chain.py::pooled_chain_forward (_fwd_kernel)
// and ::pooled_chain_backward (_bwd_kernel), which the JAX package runs on
// the TPU's matrix unit in bf16.
//
// Forward:   pooled[b, c] = max_p relu((x[b, p, :] . w[c, :]) * a[c] + c_row[c])
//            argmax[b, c] = the first p that attains it
// Backward:  dx[b, p, :] = x[b, p, :] @ m + row + sum over the channels c
//                          with argmax[b, c] == p of coef[b, c] * w[c, :]
//            dk[d, c]    = sum over b of coef[b, c] * x[b, argmax[b, c], d]
//
// Both are bound by f32 multiply-adds on this card: the forward is
// 2 * b * n * c_in * c flops (17 GFLOP at 8 x 8192 x 128 -> 1024) against a
// read of x once per channel tile (~4 MB a tile), and the (b, n, c)
// pre-activation is never written to device memory, which is what the plain
// version pays for (a GEMM output and three elementwise passes over it).
// The GEMM is a SIMT shared-memory tiling in plain f32 (no tensor cores, no
// TF32): a block of 256 threads owns 128 points x 64 channels, each thread
// 8 points x 4 channels in registers, with x and w staged through shared
// memory 32 input channels at a time.
//
// The max is exact f32 with the first index of the max, as jnp.argmax and
// torch.argmax give it; the TPU kernel's packing of the index into the low
// mantissa bits, which rounds the pooled value, is not carried over, so n is
// not bounded by an index field either.  Each thread keeps a running
// (value, index) best per channel over its points in increasing order (a
// strict > keeps the first), the block combines its 16 rows of threads with
// "larger value, else smaller index", and a second launch combines the
// blocks that split the points of a cloud in split order.  A channel that is
// 0 at every point gives pooled 0, argmax 0.  NaN propagates as in
// torch.relu / amax / argmax and jnp's: relu keeps a NaN, a NaN beats every
// number, and the first NaN wins, so a NaN pre-activation (a NaN point, or
// a NaN BatchNorm factor from an unclamped variance) pools to NaN instead
// of a finite value.  No atomics: the result is deterministic.
//
// The backward's dense part x @ m + row is the same tiling with m (c_in x
// c_in) for the weight.  The winner term is sparse (one point per cloud and
// channel) and many channels may win one point; each block lists, in
// channel order, the channels whose winner lies in its 128 points, and the
// one thread that holds a (point, column) of dx adds their coef * w rows in
// that order, so dx is deterministic too.  dk is a gather of winner rows
// summed over clouds in fixed order.  An argmax outside [0, n) traps, so the
// next CUDA call raises instead of a wrong gradient coming back.

#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128;  // points of a tile
constexpr int kBN = 64;   // output columns of a tile (channels; dx columns)
constexpr int kBK = 32;   // input channels staged per step
constexpr int kThreads = 256;
constexpr int kTM = 8;    // points per thread: ty * 8 + i
constexpr int kTN = 4;    // columns per thread: tx * 4 + j
constexpr int kRows = kBM / kTM;  // 16 rows of threads (ty)
constexpr int kPad = 4;   // keeps float4 rows aligned
constexpr int kMaxC = 4096;       // channels the backward's winner list holds
static_assert(kRows * (kBN / kTN) == kThreads, "thread tile");

// xs[k][p] = x[p0 + p, k0 + k] of one cloud (transposed), zero past p_end.
__device__ __forceinline__ void load_x(const float* __restrict__ xc, int c_in,
                                       int p0, int p_end, int k0,
                                       float (*xs)[kBM + kPad]) {
#pragma unroll
  for (int r = 0; r < kBM * kBK / 4 / kThreads; ++r) {
    const int f = threadIdx.x + r * kThreads;
    const int p = f / (kBK / 4);
    const int kq = (f % (kBK / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p0 + p < p_end) {
      v = *reinterpret_cast<const float4*>(xc + (long long)(p0 + p) * c_in +
                                           k0 + kq);
    }
    xs[kq + 0][p] = v.x;
    xs[kq + 1][p] = v.y;
    xs[kq + 2][p] = v.z;
    xs[kq + 3][p] = v.w;
  }
}

// acc[i][j] += sum over k of xs[k][ty * 8 + i] * bs[k][tx * 4 + j]
__device__ __forceinline__ void mma_tile(const float (*xs)[kBM + kPad],
                                         const float (*bs)[kBN], int ty,
                                         int tx, float (&acc)[kTM][kTN]) {
#pragma unroll 8
  for (int k = 0; k < kBK; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(&xs[k][ty * kTM]);
    const float4 a1 = *reinterpret_cast<const float4*>(&xs[k][ty * kTM + 4]);
    const float4 bv = *reinterpret_cast<const float4*>(&bs[k][tx * kTN]);
    const float av[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b4[kTN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], b4[j], acc[i][j]);
    }
  }
}

// (v, i) beats (bv, bi): NaN above every number, then the larger value,
// then, on a tie (two NaNs included), the smaller index
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn || bn) return vn && (!bn || i < bi);
  return v > bv || (v == bv && i < bi);
}

// v beats bv, a value met later (a later point or split): ties keep bv.
// !(v <= bv) is v > bv or v NaN; bv == bv keeps a NaN best
__device__ __forceinline__ bool beats_earlier(float v, float bv) {
  return !(v <= bv) && bv == bv;
}

// grid (c / kBN, splits, b): one block per channel tile, run of points, cloud
__global__ void __launch_bounds__(kThreads)
    pooled_forward_kernel(const float* __restrict__ x,
                          const float* __restrict__ w,
                          const float* __restrict__ a,
                          const float* __restrict__ c_row,
                          float* __restrict__ part_v, int* __restrict__ part_i,
                          int n, int c_in, int c, int per_split) {
  __shared__ __align__(16) float xs[kBK][kBM + kPad];
  __shared__ __align__(16) float ws[kBK][kBN];
  __shared__ float red_v[kRows][kBN];
  __shared__ int red_i[kRows][kBN];

  const int ty = threadIdx.x / (kBN / kTN);
  const int tx = threadIdx.x % (kBN / kTN);
  const int ch0 = blockIdx.x * kBN;
  const int split = blockIdx.y;
  const int cloud = blockIdx.z;
  const float* xc = x + (long long)cloud * n * c_in;
  const int p_begin = split * per_split;
  const int p_end = min(n, p_begin + per_split);

  float av[kTN], cv[kTN], best_v[kTN];
  int best_i[kTN];
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    av[j] = a[ch0 + tx * kTN + j];
    cv[j] = c_row[ch0 + tx * kTN + j];
    best_v[j] = -1.0f;  // below every relu output
    best_i[j] = 0;
  }

  for (int p0 = p_begin; p0 < p_end; p0 += kBM) {
    float acc[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;
    }
    for (int k0 = 0; k0 < c_in; k0 += kBK) {
      load_x(xc, c_in, p0, p_end, k0, xs);
#pragma unroll
      for (int r = 0; r < kBN * kBK / 4 / kThreads; ++r) {
        const int f = threadIdx.x + r * kThreads;
        const int ch = f / (kBK / 4);
        const int kq = (f % (kBK / 4)) * 4;
        const float4 v = *reinterpret_cast<const float4*>(
            w + (long long)(ch0 + ch) * c_in + k0 + kq);
        ws[kq + 0][ch] = v.x;
        ws[kq + 1][ch] = v.y;
        ws[kq + 2][ch] = v.z;
        ws[kq + 3][ch] = v.w;
      }
      __syncthreads();
      mma_tile(xs, ws, ty, tx, acc);
      __syncthreads();
    }
    // affine and relu in the plain version's order (no FMA contraction),
    // then the running first-index max over this thread's points, which it
    // visits in increasing order
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int p = p0 + ty * kTM + i;
      if (p < p_end) {
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          const float y = __fadd_rn(__fmul_rn(acc[i][j], av[j]), cv[j]);
          const float r = y <= 0.0f ? 0.0f : y;  // relu that keeps NaN
          if (beats_earlier(r, best_v[j])) {
            best_v[j] = r;
            best_i[j] = p;
          }
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    red_v[ty][tx * kTN + j] = best_v[j];
    red_i[ty][tx * kTN + j] = best_i[j];
  }
  __syncthreads();
  if (threadIdx.x < kBN) {
    const int ch = threadIdx.x;
    float bv = red_v[0][ch];
    int bi = red_i[0][ch];
    for (int t = 1; t < kRows; ++t) {
      if (better(red_v[t][ch], red_i[t][ch], bv, bi)) {
        bv = red_v[t][ch];
        bi = red_i[t][ch];
      }
    }
    const long long o = ((long long)cloud * gridDim.y + split) * c + ch0 + ch;
    part_v[o] = bv;
    part_i[o] = bi;
  }
}

// one thread per (cloud, channel): the splits in order, so a tie keeps the
// lower split's (lower) index; an empty split holds -1 and never wins
__global__ void pooled_combine_kernel(const float* __restrict__ part_v,
                                      const int* __restrict__ part_i,
                                      float* __restrict__ pooled,
                                      int* __restrict__ argmax, int b, int c,
                                      int splits) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)b * c) return;
  const long long cloud = t / c;
  const int ch = t % c;
  float bv = -1.0f;
  int bi = 0;
  for (int s = 0; s < splits; ++s) {
    const long long o = (cloud * splits + s) * c + ch;
    if (beats_earlier(part_v[o], bv)) {
      bv = part_v[o];
      bi = part_i[o];
    }
  }
  pooled[t] = bv;
  argmax[t] = bi;
}

// grid (c_in / kBN, ceil(n / kBM), b): one block per 128 points x 64 columns
// of dx
__global__ void __launch_bounds__(kThreads)
    pooled_backward_dx_kernel(const float* __restrict__ x,
                              const float* __restrict__ w,
                              const float* __restrict__ coef,
                              const int* __restrict__ argmax,
                              const float* __restrict__ m,
                              const float* __restrict__ row,
                              float* __restrict__ dx, int n, int c_in, int c) {
  __shared__ __align__(16) float xs[kBK][kBM + kPad];
  __shared__ __align__(16) float ms[kBK][kBN];
  __shared__ int win[kMaxC];  // (point - p0) << 16 | channel, channel order
  __shared__ int warp_count[kThreads / 32];

  const int ty = threadIdx.x / (kBN / kTN);
  const int tx = threadIdx.x % (kBN / kTN);
  const int j0 = blockIdx.x * kBN;
  const int p0 = blockIdx.y * kBM;
  const int cloud = blockIdx.z;
  const float* xc = x + (long long)cloud * n * c_in;
  const int* am = argmax + (long long)cloud * c;
  const float* cf = coef + (long long)cloud * c;

  // ---- the channels whose winner lies in [p0, p0 + kBM), in channel
  // order: each thread scans a contiguous run of channels, then an
  // exclusive scan of the counts places each run
  const int chunk = (c + kThreads - 1) / kThreads;
  const int cb = threadIdx.x * chunk;
  const int ce = min(c, cb + chunk);
  int count = 0;
  for (int ch = cb; ch < ce; ++ch) {
    const int p = am[ch];
    if (p < 0 || p >= n) __trap();  // argmax outside [0, n)
    count += (p >= p0 && p < p0 + kBM);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = count;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) warp_count[warp] = incl;
  __syncthreads();
  int offset = incl - count;
  int total = 0;
  for (int wi = 0; wi < kThreads / 32; ++wi) {
    if (wi < warp) offset += warp_count[wi];
    total += warp_count[wi];
  }
  for (int ch = cb; ch < ce; ++ch) {
    const int p = am[ch];
    if (p >= p0 && p < p0 + kBM) win[offset++] = ((p - p0) << 16) | ch;
  }

  // ---- dense part: x @ m + row
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;
  }
  for (int k0 = 0; k0 < c_in; k0 += kBK) {
    load_x(xc, c_in, p0, n, k0, xs);
#pragma unroll
    for (int r = 0; r < kBN * kBK / 4 / kThreads; ++r) {
      const int f = threadIdx.x + r * kThreads;
      const int k = f / (kBN / 4);
      const int jq = (f % (kBN / 4)) * 4;
      *reinterpret_cast<float4*>(&ms[k][jq]) = *reinterpret_cast<const float4*>(
          m + (long long)(k0 + k) * c_in + j0 + jq);
    }
    __syncthreads();  // also orders the winner list before its reads below
    mma_tile(xs, ms, ty, tx, acc);
    __syncthreads();
  }
  float rv[kTN];
#pragma unroll
  for (int j = 0; j < kTN; ++j) rv[j] = row[j0 + tx * kTN + j];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] += rv[j];
  }

  // ---- winner term: the thread that holds a point adds its winners' rows,
  // in channel order
  for (int e = 0; e < total; ++e) {
    const int packed = win[e];
    const int lp = packed >> 16;
    if (lp / kTM != ty) continue;
    const int ch = packed & 0xffff;
    const float g = cf[ch];
    const float4 wv = *reinterpret_cast<const float4*>(
        w + (long long)ch * c_in + j0 + tx * kTN);
    const float w4[kTN] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      if (i == lp % kTM) {
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(g, w4[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int p = p0 + ty * kTM + i;
    if (p < n) {
      *reinterpret_cast<float4*>(dx + ((long long)cloud * n + p) * c_in + j0 +
                                 tx * kTN) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
}

// grid (c): one block per channel, threads over the input channels d
__global__ void pooled_backward_dk_kernel(const float* __restrict__ x,
                                          const float* __restrict__ coef,
                                          const int* __restrict__ argmax,
                                          float* __restrict__ dk, int b, int n,
                                          int c_in, int c) {
  const int ch = blockIdx.x;
  for (int d = threadIdx.x; d < c_in; d += blockDim.x) {
    float acc = 0.0f;
    for (int cloud = 0; cloud < b; ++cloud) {
      const long long o = (long long)cloud * c + ch;
      const int p = argmax[o];
      if (p < 0 || p >= n) __trap();  // argmax outside [0, n)
      acc = fmaf(coef[o], x[((long long)cloud * n + p) * c_in + d], acc);
    }
    dk[(long long)d * c + ch] = acc;
  }
}

bool shapes_ok(long long b, long long n, long long c_in, long long c) {
  return b > 0 && n > 0 && b <= 65535 && n <= 0x7fffffffLL / 2 &&
         c_in > 0 && c_in % kBN == 0 && c > 0 && c % kBN == 0 &&
         c <= kMaxC && b * n * c_in < (1LL << 40);
}

}  // namespace

// x (b, n, c_in), w (c, c_in), a and c_row (c,) f32; part_v/part_i
// (b, splits, c) scratch; pooled (b, c) f32, argmax (b, c) int32.  Each
// split holds per_split = ceil(ceil(n / 128) / splits) * 128 points.
// Returns a cudaError_t code (0 on success).
extern "C" int pcp_pooled_chain_forward(const float* x, const float* w,
                                        const float* a, const float* c_row,
                                        float* part_v, int* part_i,
                                        float* pooled, int* argmax, int b,
                                        int n, int c_in, int c, int splits,
                                        void* stream) {
  const int tiles = (n + kBM - 1) / kBM;
  if (!shapes_ok(b, n, c_in, c) || splits < 1 || splits > tiles ||
      splits > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per_split = ((tiles + splits - 1) / splits) * kBM;
  pooled_forward_kernel<<<dim3(c / kBN, splits, b), kThreads, 0, s>>>(
      x, w, a, c_row, part_v, part_i, n, c_in, c, per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long outputs = (long long)b * c;
  pooled_combine_kernel<<<(unsigned)((outputs + 255) / 256), 256, 0, s>>>(
      part_v, part_i, pooled, argmax, b, c, splits);
  return static_cast<int>(cudaGetLastError());
}

// x (b, n, c_in), w (c, c_in), coef (b, c) f32, argmax (b, c) int32,
// m (c_in, c_in), row (c_in,) f32; dx (b, n, c_in), dk (c_in, c) f32.
// Returns a cudaError_t code (0 on success).
extern "C" int pcp_pooled_chain_backward(const float* x, const float* w,
                                         const float* coef, const int* argmax,
                                         const float* m, const float* row,
                                         float* dx, float* dk, int b, int n,
                                         int c_in, int c, void* stream) {
  if (!shapes_ok(b, n, c_in, c) || (n + kBM - 1) / kBM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  pooled_backward_dx_kernel<<<dim3(c_in / kBN, (n + kBM - 1) / kBM, b),
                              kThreads, 0, s>>>(x, w, coef, argmax, m, row,
                                                dx, n, c_in, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pooled_backward_dk_kernel<<<c, 128, 0, s>>>(x, coef, argmax, dk, b, n, c_in,
                                              c);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pcp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
