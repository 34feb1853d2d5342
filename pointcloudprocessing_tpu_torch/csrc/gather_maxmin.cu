// Per-point neighbour max and min over gathered feature rows.
//
// Replaces ops/pallas/gather_maxmin.py::gather_maxmin (its _lane_kernel),
// the VMEM lane-gather kernel that the JAX package runs on the TPU for the
// factored DGCNN edge block:
//
//   qmax[b, i, c] = max_j q[b, idx[b, i, j], c],  qmin the same with min.
//
// What bounds it on the H100: device-memory bytes.  The function reads idx
// once (b n k x 4 B), q once (b n w x 4 B) and writes two (b, n, w)
// outputs; at b = 64, n = 1024, k = 20, w = 256 that is 5.2 + 67 + 134 MB,
// about 62 us at 3.35 TB/s.  It does no arithmetic to speak of.  Design:
// one warp per point row.  Lane j reads the row's j-th index once, and the
// warp takes the indices in order by shuffle; for each neighbour the lanes
// read that neighbour's row in 32-channel strides, so every gathered row is
// read coalesced, and keep a running max and min in registers, four
// channels a lane a pass.  The k gathered rows of a point are its
// neighbours' rows of the same cloud, a cloud's q is 1 MB at n = 1024 and
// w = 256, and the warps of a block run neighbouring rows: the re-reads
// are served from the 50 MB L2 cache, and device memory sees q about once.
// The TPU kernel's width limit (w <= 96) and its f32 upcast are facts of
// TPU lane shuffles: this kernel takes any n and any w, in f32.
//
// Semantics: exact (max and min create no value).  NaN propagates as in
// torch.amax/amin and jnp.max/min: a NaN neighbour value makes the result
// NaN.  The unordered compares `!(v <= best) && best == best` take a NaN v
// and keep a NaN best without an isnan call.  The running value starts at
// the first neighbour's value, so the result is always one of the gathered
// values.  An index outside [0, n) stops the kernel with a trap (checked on
// the device, no host sync), and the next CUDA call raises.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kPerLane = 4;  // channels a lane holds in one pass

__global__ void __launch_bounds__(kWarps * 32)
    gather_maxmin_kernel(const float* __restrict__ q,
                         const int* __restrict__ idx, float* __restrict__ qmax,
                         float* __restrict__ qmin, long long rows, int n, int w,
                         int k) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const long long cloud = row / n;
  const float* qc = q + cloud * n * w;
  const int* ir = idx + row * k;
  float* omax = qmax + row * w;
  float* omin = qmin + row * w;

  for (int c0 = 0; c0 < w; c0 += 32 * kPerLane) {
    float mx[kPerLane] = {}, mn[kPerLane] = {};  // set by the first neighbour
    for (int j0 = 0; j0 < k; j0 += 32) {
      int mine = 0;
      if (j0 + lane < k) {
        mine = ir[j0 + lane];
        if (mine < 0 || mine >= n) __trap();  // a neighbour outside the cloud
      }
      const int cnt = min(32, k - j0);
      for (int jj = 0; jj < cnt; ++jj) {
        const int src = __shfl_sync(0xffffffffu, mine, jj);
        const float* r = qc + static_cast<long long>(src) * w;
        const bool first = j0 + jj == 0;
#pragma unroll
        for (int v = 0; v < kPerLane; ++v) {
          const int c = c0 + v * 32 + lane;
          if (c < w) {
            const float x = r[c];
            mx[v] = (first || (!(x <= mx[v]) && mx[v] == mx[v])) ? x : mx[v];
            mn[v] = (first || (!(x >= mn[v]) && mn[v] == mn[v])) ? x : mn[v];
          }
        }
      }
    }
#pragma unroll
    for (int v = 0; v < kPerLane; ++v) {
      const int c = c0 + v * 32 + lane;
      if (c < w) {
        omax[c] = mx[v];
        omin[c] = mn[v];
      }
    }
  }
}

}  // namespace

// q: (b, n, w) f32; idx: (b, n, k) int32 in [0, n).  Writes qmax and qmin,
// each (b, n, w) f32.  Returns a cudaError_t code (0 on success).
extern "C" int pcp_gather_maxmin(const float* q, const int* idx, float* qmax,
                                 float* qmin, long long b, int n, int w, int k,
                                 void* stream) {
  if (b == 0 || n == 0 || w == 0) return 0;
  if (b < 0 || n < 0 || w < 0 || k < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long rows = b * n;
  const long long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gather_maxmin_kernel<<<static_cast<unsigned>(blocks), kWarps * 32, 0, s>>>(
      q, idx, qmax, qmin, rows, n, w, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pcp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
