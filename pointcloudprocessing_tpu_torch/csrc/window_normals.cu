// Windowed-kNN moment sums for PCA normal estimation.
//
// Replaces ops/pallas/window_normals.py::windowed_moment_sums (its default
// block body _moment_sums_for_block, the "v1" search), the Pallas kernel
// that the JAX package runs on the TPU.
//
// The clouds arrive in a spatially local order (the voxel downsample's
// Morton order), so the k nearest neighbours of query i lie almost surely in
// the index window around it.  For a block of Q consecutive queries the
// candidates are the C = Q + 2W points from start = clamp(q0 - W, 0, n - C).
// For each query the kernel
//
//   1. takes m, the least squared distance > 0 to a valid candidate;
//   2. finds the least level s in [0, 12) whose threshold m * 2^s admits at
//      least k candidates: one count at level 11 (if it misses k, or if m >
//      1e37, every valid candidate is selected: the threshold becomes the
//      finite 3e38, so invalid candidates, at +inf, never pass), then four
//      bisection probes over the levels;
//   3. tightens the threshold by half a level, to m * 2^s * 2^-0.5, when that
//      still admits k candidates;
//   4. sums [1, x, y, z, xx, xy, xz, yy, yz, zz] over the selected
//      candidates, in coordinates shifted by the mean of the block's valid
//      candidates (so the first moments are relative to a per-block shift:
//      consumers may form only shift-invariant quantities, the covariance).
//
// What bounds it on the H100: arithmetic.  The function needs each query's
// C squared distances once (8 flops each), then a compare per candidate in
// each of 8 passes (the minimum, the level-11 count, four probes, the
// half-level count, the selection) and an add in each of the 6 counting
// passes, and 19 flops per selected candidate for the sums: about
// 768 x 22 flops a query at Q = W = 256, against 16 bytes of input and 40
// of output.  This kernel recomputes the distance in every pass, 8 x 768 x 9
// flops a query, to keep no (Q, C) tile.  Design: one block per (cloud, query
// block), one thread per query.  The block stages its candidates' three
// coordinate planes and valid flags in shared memory (16 B a candidate,
// 12 KB at Q = W = 256) and every thread recomputes its distances from
// there on each pass: a (Q, C) distance tile would not fit, and the
// passes are cheap.  All threads of a warp read the same candidate at the
// same time, a shared-memory broadcast.
//
// Numerics, held to the plain version (ops/cuda/window_normals.py) bit for
// bit up to the moment sums: distances are (dx*dx + dy*dy) + dz*dz of direct
// differences, rounded in that order (the __f*_rn intrinsics keep nvcc from
// contracting to FMA); level thresholds are m times an exact power of two
// built from its exponent bits; the half level is m * (2^s * f32(2^-0.5)),
// one rounding.  The JAX package writes the half level m * exp2(s - 0.5),
// and XLA's exp2 is not correctly rounded everywhere (on the CPU it is 3 ulp
// off for s >= 7), so a distance within a few ulp of that threshold can be
// counted on one side by the JAX package and on the other here.  The sums
// are plain f32, each query's in candidate order (deterministic); the JAX
// kernel's bf16 hi/lo matrix-unit split is a TPU device and is not ported,
// so these sums are the more exact.  The block shift is a fixed-order
// reduction, so the whole output is deterministic.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kLevels = 12;
constexpr float kHugeM = 1e37f;  // a larger m would overflow m * 2^11
constexpr float kHuge = 3e38f;   // finite "every valid candidate" threshold
constexpr float kSqrtHalf = 0.70710678118654752440f;
constexpr int kMaxCandidates = 14336;  // 16 B each: 224 KB of shared memory

// 2^s exactly, for s in [0, 12)
__device__ __forceinline__ float pow2i(int s) {
  return __int_as_float((s + 127) << 23);
}

__device__ __forceinline__ float sqdist(float qx, float qy, float qz, float px,
                                        float py, float pz) {
  const float dx = __fsub_rn(qx, px);
  const float dy = __fsub_rn(qy, py);
  const float dz = __fsub_rn(qz, pz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// candidates of the block whose distance (+inf when invalid) is <= thr
__device__ __forceinline__ int count_within(const float* cx, const float* cy,
                                            const float* cz, const float* cv,
                                            int c, float qx, float qy, float qz,
                                            float thr) {
  int cnt = 0;
#pragma unroll 4
  for (int j = 0; j < c; ++j) {
    const float d = sqdist(qx, qy, qz, cx[j], cy[j], cz[j]);
    const float dm = cv[j] != 0.0f ? d : CUDART_INF_F;
    cnt += dm <= thr;
  }
  return cnt;
}

// Fixed-order sum over the block: a strided serial sum per thread, a warp
// shuffle tree, then the warps' totals in order.  Every thread gets it.
template <int Q>
__device__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float total = 0.0f;
#pragma unroll
  for (int i = 0; i < Q / 32; ++i) total += scratch[i];
  __syncthreads();  // scratch is reused by the next call
  return total;
}

template <int Q>
__global__ void __launch_bounds__(Q)
    window_moments_kernel(const float* __restrict__ planes,
                          const unsigned char* __restrict__ valid,
                          float* __restrict__ out, int b, int n, int window,
                          int k) {
  extern __shared__ float cand[];
  __shared__ float scratch[Q / 32];
  const int c = Q + 2 * window;
  float* cx = cand;
  float* cy = cx + c;
  float* cz = cy + c;
  float* cv = cz + c;

  const int tid = threadIdx.x;
  const long long cloud = blockIdx.y;
  const int q0 = blockIdx.x * Q;
  const int start = min(max(q0 - window, 0), n - c);
  const float* px = planes + cloud * 3 * n + start;
  const float* py = px + n;
  const float* pz = py + n;
  const unsigned char* pv = valid + cloud * n + start;
  float sx = 0.0f, sy = 0.0f, sz = 0.0f, sn = 0.0f;
  for (int j = tid; j < c; j += Q) {
    const float x = px[j], y = py[j], z = pz[j];
    const float v = pv[j] ? 1.0f : 0.0f;
    cx[j] = x;
    cy[j] = y;
    cz[j] = z;
    cv[j] = v;
    sx += x * v;
    sy += y * v;
    sz += z * v;
    sn += v;
  }
  // the block shift: the valid candidates' mean (:292-296 of the JAX kernel)
  const float nv = fmaxf(block_sum<Q>(sn, scratch), 1.0f);
  const float shx = block_sum<Q>(sx, scratch) / nv;
  const float shy = block_sum<Q>(sy, scratch) / nv;
  const float shz = block_sum<Q>(sz, scratch) / nv;  // its barriers order the staging

  const int ql = q0 + tid - start;  // the query's place among the candidates
  const float qx = cx[ql], qy = cy[ql], qz = cz[ql];

  float m = CUDART_INF_F;  // nearest non-self (d > 0) valid candidate
#pragma unroll 4
  for (int j = 0; j < c; ++j) {
    const float d = sqdist(qx, qy, qz, cx[j], cy[j], cz[j]);
    const float dm = cv[j] != 0.0f ? d : CUDART_INF_F;
    if (dm > 0.0f) m = fminf(m, dm);
  }
  const int cnt_top =
      count_within(cx, cy, cz, cv, c, qx, qy, qz, __fmul_rn(m, pow2i(kLevels - 1)));
  const bool fallback = cnt_top < k || m > kHugeM;
  int lo = 0, hi = kLevels - 1;
  for (int probe = 0; probe < 4; ++probe) {
    const int mid = (lo + hi) >> 1;
    const int cnt =
        count_within(cx, cy, cz, cv, c, qx, qy, qz, __fmul_rn(m, pow2i(mid)));
    if (cnt >= k) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  // every query makes all 8 passes, as the JAX kernel does: the work does
  // not depend on the data
  const float thr_lo = __fmul_rn(m, __fmul_rn(pow2i(hi), kSqrtHalf));
  const int cnt_lo = count_within(cx, cy, cz, cv, c, qx, qy, qz, thr_lo);
  float thr = fallback ? kHuge : __fmul_rn(m, pow2i(hi));
  if (cnt_lo >= k && !fallback) thr = thr_lo;

  float s[10];
#pragma unroll
  for (int f = 0; f < 10; ++f) s[f] = 0.0f;
  for (int j = 0; j < c; ++j) {
    const float d = sqdist(qx, qy, qz, cx[j], cy[j], cz[j]);
    const float dm = cv[j] != 0.0f ? d : CUDART_INF_F;
    if (dm <= thr) {
      const float ax = __fsub_rn(cx[j], shx);
      const float ay = __fsub_rn(cy[j], shy);
      const float az = __fsub_rn(cz[j], shz);
      s[0] = __fadd_rn(s[0], 1.0f);
      s[1] = __fadd_rn(s[1], ax);
      s[2] = __fadd_rn(s[2], ay);
      s[3] = __fadd_rn(s[3], az);
      s[4] = __fadd_rn(s[4], __fmul_rn(ax, ax));
      s[5] = __fadd_rn(s[5], __fmul_rn(ax, ay));
      s[6] = __fadd_rn(s[6], __fmul_rn(ax, az));
      s[7] = __fadd_rn(s[7], __fmul_rn(ay, ay));
      s[8] = __fadd_rn(s[8], __fmul_rn(ay, az));
      s[9] = __fadd_rn(s[9], __fmul_rn(az, az));
    }
  }
  const long long plane = static_cast<long long>(b) * n;
  float* o = out + cloud * n + q0 + tid;
#pragma unroll
  for (int f = 0; f < 10; ++f) o[f * plane] = s[f];
}

template <int Q>
int launch(const float* planes, const unsigned char* valid, float* out, int b,
           int n, int window, int k, cudaStream_t stream) {
  const int c = Q + 2 * window;
  const size_t smem = 4 * sizeof(float) * static_cast<size_t>(c);
  cudaError_t err = cudaFuncSetAttribute(
      window_moments_kernel<Q>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n / Q, b);
  window_moments_kernel<Q><<<grid, Q, smem, stream>>>(planes, valid, out, b, n,
                                                      window, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// planes: (b, 3, n) f32 per-cloud-centred coordinates; valid: (b, n) bytes.
// Writes out (10, b, n) f32: cnt, sx, sy, sz, sxx, sxy, sxz, syy, syz, szz.
// q_block is 128 or 256 and divides n; C = q_block + 2 * window <= n.
// Returns a cudaError_t code (0 on success).
extern "C" int pcp_window_moments(const float* planes, const unsigned char* valid,
                                  float* out, int b, int n, int k, int window,
                                  int q_block, void* stream) {
  if (b == 0) return 0;
  const int c = q_block + 2 * window;
  if (b < 0 || b > 65535 || n < 1 || k < 1 || window < 0 || c > n ||
      c > kMaxCandidates || (q_block != 128 && q_block != 256) ||
      n % q_block != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_block == 256) return launch<256>(planes, valid, out, b, n, window, k, s);
  return launch<128>(planes, valid, out, b, n, window, k, s);
}

extern "C" const char* pcp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
