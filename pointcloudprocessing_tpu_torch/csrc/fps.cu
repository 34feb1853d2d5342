// Farthest-point sampling with the picked coordinates.
//
// Replaces ops/pallas/fps.py::fps_pallas_with_points (its _fps_kernel), the
// VMEM-resident selection loop that the JAX package runs on the TPU.
//
// FPS is a serial loop of K steps per cloud; each step updates a running
// min squared distance over the cloud's n points and picks its argmax.  It
// does ~8 flops per point and step, so on the H100 the bound is neither
// memory nor arithmetic but the latency of one step: the distance pass over
// n points plus one block-wide argmax.  Two forms, one block per cloud in
// both; the caller picks one by n (ops/cuda/fps.py::kernel_form):
//
// - fps_kernel (pcp_fps, n <= kSharedMaxPoints = 16,384): the coordinate
//   planes sit in shared memory (12 B a point: 16,384 points take 192 KB of
//   the 227 KB a block may have) and are read K times from there; device
//   memory is touched once for the input and once for the outputs.  The min
//   distance lives in registers, PPT points per thread, strided so that
//   neighbouring threads read neighbouring words.
// - fps_large_kernel (pcp_fps_large, any n >= 1): the coordinates are read
//   from device memory at every step (coalesced in the plane-major bcn
//   layout) and the running minima live in a (b, n) f32 scratch that the
//   caller allocates; a cloud's working set (16 B a point) then comes from
//   L2.  One SM a cloud; a simple form kept for clouds that do not fit.
//
// Each step ends with a warp-shuffle (value, index) argmax, one shared-
// memory exchange between warps and two barriers.  Invalid points never
// take part: their update is skipped and they score -inf, the JAX kernel's
// where(valid, min_dist, -inf).
//
// Semantics held exactly to the JAX kernel (and to torch.minimum/argmax):
// - the min distance starts at +inf; d = (x-cx)^2 + (y-cy)^2 + (z-cz)^2 by
//   direct differences, rounded in that order (the __f*_rn intrinsics keep
//   nvcc from contracting to FMA, which would round differently from the
//   plain version and flip near-ties);
// - the running min propagates NaN (PTX min.NaN): once a valid point's
//   distance is NaN its score stays NaN (fminf would drop it);
// - the argmax follows jnp.argmax: NaN beats every number, ties (between
//   NaNs or equal numbers) go to the lowest index, and when every score is
//   -inf the pick is index 0.
// A seed outside [0, n) stops the kernel with a trap (checked on the
// device, so no host sync), and the next CUDA call raises.

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kSharedMaxPoints = 16384;
constexpr int kLargeThreads = 1024;

// torch.minimum / jnp.minimum: NaN if either operand is NaN
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// (v, i) beats (bv, bi) under jnp.argmax: NaN first, then larger, then the
// lower index
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  const bool vn = v != v, bn = bv != bv;
  if (vn || bn) return vn && (!bn || i < bi);
  return v > bv || (v == bv && i < bi);
}

// The same within one thread, whose candidates come in increasing index:
// a later one wins only if strictly better.
__device__ __forceinline__ bool later_better(float v, float bv) {
  return v > bv || (v != v && bv == bv);
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// The block's (value, index) argmax of every thread's candidate; every
// thread gets the winning index.  A thread starts from (-inf, its own tid),
// so thread 0 holds index 0 and the winner is a real index in [0, n).  The
// second barrier orders the reads of `picked` and red_* before the next
// call's writes of them.
template <int THREADS>
__device__ __forceinline__ int block_argmax(float bv, int bi) {
  constexpr int kWarps = THREADS / 32;
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int picked;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  warp_argmax(bv, bi);
  if (lane == 0) {
    red_v[warp] = bv;
    red_i[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    bv = lane < kWarps ? red_v[lane] : -CUDART_INF_F;
    bi = lane < kWarps ? red_i[lane] : INT_MAX;
    warp_argmax(bv, bi);
    if (lane == 0) picked = bi;
  }
  __syncthreads();
  return picked;
}

template <int PPT, int THREADS>
__global__ void __launch_bounds__(THREADS)
    fps_kernel(const float* __restrict__ points,
               const unsigned char* __restrict__ valid,
               const int* __restrict__ start, int* __restrict__ out_idx,
               float* __restrict__ out_pts, int n, int k, int bcn) {
  static_assert(PPT <= 32, "one valid bit a point in a 32-bit word");
  extern __shared__ float planes[];
  float* xs = planes;
  float* ys = planes + n;
  float* zs = planes + 2 * n;

  const int tid = threadIdx.x;
  const long long cloud = blockIdx.x;
  const float* p = points + cloud * 3 * n;
  if (bcn) {
    for (int q = tid; q < n; q += THREADS) {
      xs[q] = p[q];
      ys[q] = p[n + q];
      zs[q] = p[2 * n + q];
    }
  } else {
    for (int q = tid; q < n; q += THREADS) {
      xs[q] = p[3 * q];
      ys[q] = p[3 * q + 1];
      zs[q] = p[3 * q + 2];
    }
  }
  const unsigned char* vm = valid + cloud * n;
  float md[PPT];
  unsigned live = 0;  // bit j: point tid + j * THREADS exists and is valid
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int q = tid + j * THREADS;
    md[j] = CUDART_INF_F;
    if (q < n && vm[q]) live |= 1u << j;
  }
  __syncthreads();

  int* oi = out_idx + cloud * k;
  float* op = out_pts + cloud * k * 3;
  int cur = start[cloud];
  if (cur < 0 || cur >= n) __trap();  // a seed outside the cloud: raise
  for (int s = 0;; ++s) {
    const float cx = xs[cur], cy = ys[cur], cz = zs[cur];
    if (tid == 0) {
      oi[s] = cur;
      op[3 * s] = cx;
      op[3 * s + 1] = cy;
      op[3 * s + 2] = cz;
    }
    if (s == k - 1) break;

    float bv = -CUDART_INF_F;
    int bi = tid;
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      if (live >> j & 1u) {
        const int q = tid + j * THREADS;
        const float dx = __fsub_rn(xs[q], cx);
        const float dy = __fsub_rn(ys[q], cy);
        const float dz = __fsub_rn(zs[q], cz);
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                  __fmul_rn(dz, dz));
        const float m = min_nan(md[j], d);
        md[j] = m;
        if (later_better(m, bv)) {
          bv = m;
          bi = q;
        }
      }
    }
    cur = block_argmax<THREADS>(bv, bi);
  }
}

__global__ void __launch_bounds__(kLargeThreads)
    fps_large_kernel(const float* __restrict__ points,
                     const unsigned char* __restrict__ valid,
                     const int* __restrict__ start, int* __restrict__ out_idx,
                     float* __restrict__ out_pts, float* __restrict__ min_dist,
                     int n, int k, int bcn) {
  const int tid = threadIdx.x;
  const long long cloud = blockIdx.x;
  const float* p = points + cloud * 3 * n;
  // point q's coordinate c sits at p[q * step + c * plane]
  const long long step = bcn ? 1 : 3;
  const long long plane = bcn ? n : 1;
  const unsigned char* vm = valid + cloud * n;
  float* md = min_dist + cloud * n;

  int* oi = out_idx + cloud * k;
  float* op = out_pts + cloud * k * 3;
  int cur = start[cloud];
  if (cur < 0 || cur >= n) __trap();  // a seed outside the cloud: raise
  for (int s = 0;; ++s) {
    const float* c = p + cur * step;
    const float cx = c[0], cy = c[plane], cz = c[2 * plane];
    if (tid == 0) {
      oi[s] = cur;
      op[3 * s] = cx;
      op[3 * s + 1] = cy;
      op[3 * s + 2] = cz;
    }
    if (s == k - 1) break;

    float bv = -CUDART_INF_F;
    int bi = tid;
    for (int q = tid; q < n; q += kLargeThreads) {
      // the first step sets an invalid point's entry to -inf, which later
      // steps read as "skip"; a valid point's entry is never -inf
      float m;
      if (s == 0) {
        if (!vm[q]) {
          md[q] = -CUDART_INF_F;
          continue;
        }
        m = CUDART_INF_F;
      } else {
        m = md[q];
        if (m == -CUDART_INF_F) continue;
      }
      const float* r = p + q * step;
      const float dx = __fsub_rn(r[0], cx);
      const float dy = __fsub_rn(r[plane], cy);
      const float dz = __fsub_rn(r[2 * plane], cz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      m = min_nan(m, d);
      md[q] = m;
      if (later_better(m, bv)) {
        bv = m;
        bi = q;
      }
    }
    cur = block_argmax<kLargeThreads>(bv, bi);
  }
}

template <int PPT, int THREADS>
int launch(const float* points, const unsigned char* valid, const int* start,
           int* out_idx, float* out_pts, int b, int n, int k, int bcn,
           cudaStream_t stream) {
  const size_t smem = 3 * sizeof(float) * static_cast<size_t>(n);
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel<PPT, THREADS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fps_kernel<PPT, THREADS><<<b, THREADS, smem, stream>>>(
      points, valid, start, out_idx, out_pts, n, k, bcn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// points: (b, n, 3) or, with bcn != 0, (b, 3, n) f32; valid: (b, n) bytes;
// start: (b,) int32 seeds.  Writes out_idx (b, k) int32 and out_pts
// (b, k, 3) f32.  Takes n <= 16,384.  Returns a cudaError_t code (0 on
// success).
extern "C" int pcp_fps(const float* points, const unsigned char* valid,
                       const int* start, int* out_idx, float* out_pts, int b,
                       int n, int k, int bcn, void* stream) {
  if (b == 0) return 0;
  if (n < 1 || n > kSharedMaxPoints || k < 1 || b < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 256) return launch<1, 256>(points, valid, start, out_idx, out_pts, b, n, k, bcn, s);
  if (n <= 512) return launch<2, 256>(points, valid, start, out_idx, out_pts, b, n, k, bcn, s);
  if (n <= 1024) return launch<4, 256>(points, valid, start, out_idx, out_pts, b, n, k, bcn, s);
  if (n <= 2048) return launch<8, 256>(points, valid, start, out_idx, out_pts, b, n, k, bcn, s);
  if (n <= 4096) return launch<4, 1024>(points, valid, start, out_idx, out_pts, b, n, k, bcn, s);
  if (n <= 8192) return launch<8, 1024>(points, valid, start, out_idx, out_pts, b, n, k, bcn, s);
  return launch<16, 1024>(points, valid, start, out_idx, out_pts, b, n, k, bcn, s);
}

// The same for any n >= 1, with min_dist a (b, n) f32 scratch (no need to
// initialise it).  Returns a cudaError_t code (0 on success).
extern "C" int pcp_fps_large(const float* points, const unsigned char* valid,
                             const int* start, int* out_idx, float* out_pts,
                             float* min_dist, int b, int n, int k, int bcn,
                             void* stream) {
  if (b == 0) return 0;
  if (n < 1 || k < 1 || b < 0) return static_cast<int>(cudaErrorInvalidValue);
  fps_large_kernel<<<b, kLargeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      points, valid, start, out_idx, out_pts, min_dist, n, k, bcn);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pcp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
