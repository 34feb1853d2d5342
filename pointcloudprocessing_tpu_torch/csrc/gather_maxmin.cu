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
// about 62 us at 3.35 TB/s.  It does no arithmetic to speak of.  But the
// gather reads every q row k times: 1.34 GB at that shape, which from the L2
// cache alone (a warp a point row, PR 3's form) took 0.27-0.29 ms.
//
// The TPU kernel stages a cloud's q in VMEM and gathers on-chip.  Here the
// shared form does the same in shared memory, a channel slice at a time:
// a block takes one (cloud, slice of S channels), copies q[b, :, c0:c0+S]
// into shared memory once (cp.async, 16 bytes a copy where w allows; n S 4
// bytes, 128 KB at n 1,024 and S 32), then walks the cloud's points.  A
// point belongs to S / 4 lanes, each of which holds 4 channels, so a warp
// serves 32 / (S / 4) points at a time.  Eight neighbours a step: every
// lane of a point loads the same indices (16-byte loads where k is a
// multiple of 4; one at a time, the indices cost the L1/shared data path
// two thirds of what the rows do), then reads the rows' 4 channels as
// float4 values from shared memory, with no branch between the loads, so
// they are in flight together; a running max and min stay in registers,
// and the outputs go out as float4 stores.  The next round's index row is
// prefetched into L1 (a round's first index load otherwise waits on L2).
// Device memory sees q once, the outputs once and idx once a slice (from
// L2 after the first).
//
// Bank conflicts: a float4 load is served a quarter-warp (8 lanes) at a
// time.  At S 32 those 8 lanes read one 128-byte row, all 32 banks once:
// no conflict, whatever rows the neighbours are.  At S 16 a quarter-warp
// reads two random 64-byte rows, which share banks half the time (1.5
// wavefronts a load on average), and less at S 8 and 4.
//
// Forms, chosen by ops/cuda/gather_maxmin.py::gather_form(b, n, w): the
// largest S in {32, 16, 8, 4} (at most w rounded up to a power of two)
// whose slice fits a block's 227 KB and that gives about a block an SM;
// where even S 4 does not fit (n > 14,528), the L2 form: one warp a point
// row, each neighbour's row read from device memory in 32-channel strides,
// the re-reads served from the 50 MB L2.  Any n, any w and any k >= 1, in
// f32 (the TPU kernel's w <= 96 and f32 upcast are facts of its lane
// shuffles).
//
// What holds it above the bound (measured on the H100): b n k w = 335M
// values at that shape, each taken into a max and a min; a NaN-propagating
// compare-and-select costs four instructions (0.30 ms at S 32), PTX
// max.NaN / min.NaN one each.  At S 32 a block holds 128 KB, so an SM runs
// one block of 32 warps: its copy does not overlap its gather, and the
// gather waits on latency (512 threads a block ran 1.3x slower).
//
// Semantics: exact (max and min create no value).  NaN propagates as in
// torch.amax/amin and jnp.max/min: a NaN neighbour value makes the result
// NaN (PTX max.NaN / min.NaN).  The running max starts at -inf (the min at
// +inf), which any gathered value replaces or equals, so every result that
// is not NaN is one of the gathered values.  An index outside
// [0, n) stops the kernel with a trap (checked on the device, no host
// sync), and the next CUDA call raises.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;  // warps a block (L2 form)
constexpr int kPerLane = 4;  // channels a lane holds in one pass (L2 form)
constexpr int kSharedBytes = 232448;  // dynamic shared memory a block may have
constexpr int kSmBytes = 233472;      // shared memory of an SM

// One instruction each, NaN-propagating (the canonical NaN if either is).
__device__ __forceinline__ float take_max(float x, float best) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(x), "f"(best));
  return r;
}

__device__ __forceinline__ float take_min(float x, float best) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(x), "f"(best));
  return r;
}

// The shared form.  kVec: w % 4 == 0 and q, qmax, qmin 16-byte aligned.
template <int S, bool kVec>
__global__ void __launch_bounds__(1024)
    gather_maxmin_shared_kernel(const float* __restrict__ q,
                                const int* __restrict__ idx,
                                float* __restrict__ qmax,
                                float* __restrict__ qmin, int n, int w, int k,
                                int slices) {
  constexpr int kLanes = S / 4;         // lanes a point
  constexpr int kPoints = 32 / kLanes;  // points a warp at once
  extern __shared__ __align__(16) float slab[];  // n rows of S floats

  const long long cloud = blockIdx.x / slices;
  const int c0 = static_cast<int>(blockIdx.x % slices) * S;
  const int width = min(S, w - c0);  // this slice's channels
  const float* qc = q + cloud * n * w + c0;

  // Stage the slice: row r's channels at slab[r S ..].
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(slab));
  if constexpr (kVec) {
    const int chunks = width / 4;
    for (int e = threadIdx.x; e < n * chunks; e += blockDim.x) {
      const int r = e / chunks;
      const int c = 4 * (e - r * chunks);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                   ::"r"(dst + 4 * (r * S + c)),
                   "l"(qc + static_cast<long long>(r) * w + c) : "memory");
    }
  } else {
    for (int e = threadIdx.x; e < n * width; e += blockDim.x) {
      const int r = e / width;
      const int c = e - r * width;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                   ::"r"(dst + 4 * (r * S + c)),
                   "l"(qc + static_cast<long long>(r) * w + c) : "memory");
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int group = lane / kLanes;  // the warp's point
  const int sub = lane % kLanes;    // channels 4 sub .. 4 sub + 3
  const int warps = blockDim.x >> 5;
  const int* ic = idx + cloud * n * k;
  const float* col = slab + 4 * sub;  // this lane's channels of row 0
  const long long out0 = cloud * n * w + c0 + 4 * sub;
  const unsigned rows = static_cast<unsigned>(n);
  const bool vec_idx = k % 4 == 0 && reinterpret_cast<uintptr_t>(idx) % 16 == 0;

  for (int p0 = (threadIdx.x >> 5) * kPoints; p0 < n; p0 += warps * kPoints) {
    const int p = p0 + group;  // the same p0 across the warp
    const bool live = p < n;
    // a lane past the cloud's end repeats row n - 1's reads, and stores nothing
    const int* ir = ic + static_cast<long long>(min(p, n - 1)) * k;
    // the next round's index row into L1 now, so its loads do not wait on L2
    if (sub == 0 && p + warps * kPoints < n) {
      const int* next = ir + static_cast<long long>(warps * kPoints) * k;
      asm volatile("prefetch.global.L1 [%0];" ::"l"(next));
      asm volatile("prefetch.global.L1 [%0];" ::"l"(next + k - 1));
    }
    float mx[4], mn[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      mx[e] = -__int_as_float(0x7f800000);
      mn[e] = __int_as_float(0x7f800000);
    }
    auto take = [&](const float4& x) {
      mx[0] = take_max(x.x, mx[0]);
      mx[1] = take_max(x.y, mx[1]);
      mx[2] = take_max(x.z, mx[2]);
      mx[3] = take_max(x.w, mx[3]);
      mn[0] = take_min(x.x, mn[0]);
      mn[1] = take_min(x.y, mn[1]);
      mn[2] = take_min(x.z, mn[2]);
      mn[3] = take_min(x.w, mn[3]);
    };
    auto row = [&](int src) {
      return *reinterpret_cast<const float4*>(col + src * S);
    };
    // Eight (then four) neighbours a step, with no branch between their
    // loads: the indices (16-byte loads where k and idx allow, else one at a
    // time; the same address across the point's lanes), one check, the
    // rows, then the compares.
    auto bad = [&](const int4& s) {
      return (static_cast<unsigned>(s.x) >= rows) | (static_cast<unsigned>(s.y) >= rows) |
             (static_cast<unsigned>(s.z) >= rows) | (static_cast<unsigned>(s.w) >= rows);
    };
    auto step = [&](int s0, int s1, int s2, int s3) {
      if (bad(make_int4(s0, s1, s2, s3))) __trap();  // outside the cloud
      const float4 x0 = row(s0), x1 = row(s1), x2 = row(s2), x3 = row(s3);
      take(x0);
      take(x1);
      take(x2);
      take(x3);
    };
    int j = 0;
    if (vec_idx) {
      for (; j + 8 <= k; j += 8) {
        const int4 s = *reinterpret_cast<const int4*>(ir + j);
        const int4 t = *reinterpret_cast<const int4*>(ir + j + 4);
        if (bad(s) | bad(t)) __trap();  // a neighbour outside the cloud
        const float4 x0 = row(s.x), x1 = row(s.y), x2 = row(s.z), x3 = row(s.w);
        const float4 x4 = row(t.x), x5 = row(t.y), x6 = row(t.z), x7 = row(t.w);
        take(x0);
        take(x1);
        take(x2);
        take(x3);
        take(x4);
        take(x5);
        take(x6);
        take(x7);
      }
      for (; j + 4 <= k; j += 4) {
        const int4 s = *reinterpret_cast<const int4*>(ir + j);
        step(s.x, s.y, s.z, s.w);
      }
    } else {
      for (; j + 4 <= k; j += 4) step(ir[j], ir[j + 1], ir[j + 2], ir[j + 3]);
    }
    for (; j < k; ++j) {
      const int s0 = ir[j];
      if (static_cast<unsigned>(s0) >= rows) __trap();
      take(row(s0));
    }
    if (live && 4 * sub < width) {
      const long long o = out0 + static_cast<long long>(p) * w;
      if constexpr (kVec) {
        *reinterpret_cast<float4*>(qmax + o) =
            make_float4(mx[0], mx[1], mx[2], mx[3]);
        *reinterpret_cast<float4*>(qmin + o) =
            make_float4(mn[0], mn[1], mn[2], mn[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (4 * sub + e < width) {
            qmax[o + e] = mx[e];
            qmin[o + e] = mn[e];
          }
        }
      }
    }
  }
}

template <int S, bool kVec>
int launch_slice(const float* q, const int* idx, float* qmax, float* qmin,
                 long long b, int n, int w, int k, cudaStream_t s) {
  const int slices = (w + S - 1) / S;
  const long long blocks = b * slices;
  const int smem = n * S * static_cast<int>(sizeof(float));
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // the blocks an SM holds by shared memory, and threads to fill it: 1,024
  // for one block, else at most 2,048 an SM with registers to spare
  const int resident = kSmBytes / (smem + 1024);
  const int threads = resident <= 1 ? 1024 : (resident == 2 ? 512 : 256);
  auto kernel = gather_maxmin_shared_kernel<S, kVec>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), threads, smem, s>>>(
      q, idx, qmax, qmin, n, w, k, slices);
  return static_cast<int>(cudaGetLastError());
}

template <int S>
int launch_shared(const float* q, const int* idx, float* qmax, float* qmin,
                  long long b, int n, int w, int k, cudaStream_t s) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(qmax) |
                         reinterpret_cast<uintptr_t>(qmin);
  const bool vec = w % 4 == 0 && ptrs % 16 == 0;
  return vec ? launch_slice<S, true>(q, idx, qmax, qmin, b, n, w, k, s)
             : launch_slice<S, false>(q, idx, qmax, qmin, b, n, w, k, s);
}

// The L2 form: one warp a point row, reading each neighbour's row from
// device memory in 32-channel strides, kPerLane channels a lane a pass.
__global__ void __launch_bounds__(kWarps * 32)
    gather_maxmin_l2_kernel(const float* __restrict__ q,
                            const int* __restrict__ idx,
                            float* __restrict__ qmax, float* __restrict__ qmin,
                            long long rows, int n, int w, int k) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const long long cloud = row / n;
  const float* qc = q + cloud * n * w;
  const int* ir = idx + row * k;
  float* omax = qmax + row * w;
  float* omin = qmin + row * w;

  for (int c0 = 0; c0 < w; c0 += 32 * kPerLane) {
    float mx[kPerLane], mn[kPerLane];
#pragma unroll
    for (int v = 0; v < kPerLane; ++v) {
      mx[v] = -__int_as_float(0x7f800000);
      mn[v] = __int_as_float(0x7f800000);
    }
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
#pragma unroll
        for (int v = 0; v < kPerLane; ++v) {
          const int c = c0 + v * 32 + lane;
          if (c < w) {
            const float x = r[c];
            mx[v] = take_max(x, mx[v]);
            mn[v] = take_min(x, mn[v]);
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
// each (b, n, w) f32.  slice: the shared form's S (32, 16, 8 or 4, with n S
// floats within a block's shared memory), or 0 for the L2 form, as
// gather_form chose.  Returns a cudaError_t code (0 on success).
extern "C" int pcp_gather_maxmin(const float* q, const int* idx, float* qmax,
                                 float* qmin, long long b, int n, int w, int k,
                                 int slice, void* stream) {
  if (b == 0 || n == 0 || w == 0) return 0;
  if (b < 0 || n < 0 || w < 0 || k < 1 ||
      static_cast<long long>(n) * slice * 4 > kSharedBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (slice) {
    case 32: return launch_shared<32>(q, idx, qmax, qmin, b, n, w, k, s);
    case 16: return launch_shared<16>(q, idx, qmax, qmin, b, n, w, k, s);
    case 8: return launch_shared<8>(q, idx, qmax, qmin, b, n, w, k, s);
    case 4: return launch_shared<4>(q, idx, qmax, qmin, b, n, w, k, s);
    case 0: break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long rows = b * n;
  const long long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  gather_maxmin_l2_kernel<<<static_cast<unsigned>(blocks), kWarps * 32, 0, s>>>(
      q, idx, qmax, qmin, rows, n, w, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pcp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
