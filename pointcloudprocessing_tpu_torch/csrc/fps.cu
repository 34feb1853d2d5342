// Farthest-point sampling with the picked coordinates.
//
// Replaces ops/pallas/fps.py::fps_pallas_with_points (its _fps_kernel), the
// VMEM-resident selection loop that the JAX package runs on the TPU.
//
// FPS is a serial loop of K steps per cloud; each step updates a running
// min squared distance over the cloud's n points and picks its argmax.  It
// does ~8 flops per point and step, so on the H100 the bound is neither
// memory nor arithmetic but the latency of one step: the distance pass over
// n points plus one block-wide argmax.  Design: one block per cloud.  The
// coordinate planes sit in shared memory (12 B a point: 16,384 points take
// 192 KB of the 227 KB a block may have) and are read K times from there;
// device memory is touched once for the input and once for the outputs.
// The min distance lives in registers, PPT points per thread, strided so
// that neighbouring threads read neighbouring words.  Each step ends with a
// warp-shuffle (value, index) argmax, one shared-memory exchange between
// warps and two barriers.  Invalid points start at -inf and stay there,
// which is the JAX kernel's "score -inf" rule without a mask load per step.
//
// Semantics held exactly to the JAX kernel: min distance starts at +inf;
// d = (x-cx)^2 + (y-cy)^2 + (z-cz)^2 by direct differences, rounded in
// that order (the __f*_rn intrinsics keep nvcc from contracting to FMA,
// which would round differently from the plain version and flip near-ties);
// ties go to the lowest index, also when every score is -inf (index 0).
// A seed outside [0, n) stops the kernel with a trap (checked on the
// device, so no host sync), and the next CUDA call raises.

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxPoints = 16384;

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
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

template <int PPT, int THREADS>
__global__ void __launch_bounds__(THREADS)
    fps_kernel(const float* __restrict__ points,
               const unsigned char* __restrict__ valid,
               const int* __restrict__ start, int* __restrict__ out_idx,
               float* __restrict__ out_pts, int n, int k, int bcn) {
  constexpr int kWarps = THREADS / 32;
  extern __shared__ float planes[];
  float* xs = planes;
  float* ys = planes + n;
  float* zs = planes + 2 * n;
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int picked;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
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
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int q = tid + j * THREADS;
    md[j] = (q < n && vm[q]) ? CUDART_INF_F : -CUDART_INF_F;
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
    int bi = INT_MAX;
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int q = tid + j * THREADS;
      if (q < n) {
        const float dx = __fsub_rn(xs[q], cx);
        const float dy = __fsub_rn(ys[q], cy);
        const float dz = __fsub_rn(zs[q], cz);
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                  __fmul_rn(dz, dz));
        const float m = fminf(md[j], d);
        md[j] = m;
        if (better(m, q, bv, bi)) {
          bv = m;
          bi = q;
        }
      }
    }
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
      // thread 0 always holds point 0, so bi is a real index in [0, n)
      if (lane == 0) picked = bi;
    }
    __syncthreads();
    cur = picked;
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
// (b, k, 3) f32.  Returns a cudaError_t code (0 on success).
extern "C" int pcp_fps(const float* points, const unsigned char* valid,
                       const int* start, int* out_idx, float* out_pts, int b,
                       int n, int k, int bcn, void* stream) {
  if (b == 0) return 0;
  if (n < 1 || n > kMaxPoints || k < 1 || b < 0) {
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

extern "C" const char* pcp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
