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
//
// The bf16 form (q, qmax and qmin bf16, the TPU kernel's other dtype; the
// one DGCNN runs under compute_dtype bf16) is the ring form below wherever
// TMA can copy q (w a multiple of 8, 16-byte aligned pointers) and a slab
// fits a block; each 32-bit word takes a pair of channels into
// max.NaN.bf16x2 / min.NaN.bf16x2.  Exact in bf16 too; the TPU kernel
// upcasts to f32 and back, which gives the same values.  Bound at 64 x 1024,
// k 20: 5.2 MB of idx, then q and two outputs of 8.4 / 16.8 / 33.6 MB at w
// 64 / 128 / 256: 9.1 / 16.6 / 31.6 us at 3.35 TB/s (and about 2.85 TB/s is
// what a plain fill reaches on the card).
//
// What bounds the bf16 form, read on the card (tools/gather_variants.py,
// 64 x 1024 x 128): the SM's shared-memory/L1 pipeline and the output
// stores.  Each (point, neighbour) reads one 128-byte row from shared
// memory, a wavefront, and a share of a 16-byte index load through L1: the
// gather of a slab takes about 1.7 SM cycles a (point, neighbour), 1.1
// with the outputs not stored, 1.3 with no index loaded.  The max and min
// cost nothing measurable (an xor and an add in their place read the
// same), nor does the trap check.  Streaming stores (st.global.cs) beat
// plain ones by a fifth.  The copy of a slab is device-memory bound, and
// every block starts with one (5 us at w 128, 8 at w 256), which nothing
// can hide.
//
// The parent kernel (the shared form above on 2-byte elements) lost time
// where this design does not: at w 64 it took 64-byte slices (S 32: 128
// blocks, 256 threads an SM, a quarter-warp reading two random rows, 1.5
// wavefronts a load), and at w 128 and 256 no block's copy overlapped any
// gather (256 blocks of 128 KB at w 256: two waves).
//
// The ring form (gather_maxmin_ring_kernel):
// - 128-byte rows: a slice of 64 channels, eight lanes a point, so a
//   quarter-warp reads one whole row, whatever the neighbours are: no bank
//   conflicts.  The rest of w past its last full 64 channels takes a
//   second launch in the narrowest rows that hold it (16 to 64 bytes), as
//   does w < 64; clouds past 1,792 points (the rows a block holds at 128
//   bytes) take narrower rows, and the shared form where their slabs fill
//   the card anyway (the same rows and gather, as fast there).
// - A persistent grid of one 1,024-thread block an SM; block i takes tiles
//   i, i + grid, ...; a tile is (cloud, slice, range of points).
//   gather_plan cuts each slab into point ranges so that the busiest block
//   holds the least of a slab's gather (at 64 x 1024 x 64: two ranges, 128
//   tiles, where there are 64 slabs for 132 SMs); a second range re-reads
//   the slab from L2.  Tiles that run at once are neighbours in (cloud,
//   slice) order, so a cloud's output rows fill while they sit in L2: a
//   block taking a contiguous share of the tiles left 16-byte rows' half
//   sectors to device memory, 1.8x slower at 8 x 8192 x 256.
// - The copy overlaps the gather by TMA: a slab arrives as 8 KB boxes
//   (cp.async.bulk.tensor, rows past n and channels past w as zeros) that
//   complete on an mbarrier, two arrivals a phase (its early and its late
//   part).  Slab j of a block lies at ring row 0 when j is even and at
//   rows - npad when j is odd, so two neighbours share the middle `ov`
//   boxes when 2 npad > rows: slab j + 1's other boxes are issued once slab
//   j has landed and load during its gather; the shared ones are issued
//   once slab j's gathers are over (256 of 1,024 rows at n 1,024, 3 us at
//   w 256).  A block of one tile holds its slab alone, leaving the rest of
//   the SM's 256 KB to L1 (the index rows).
// - Sixteen neighbours a step: their indices (16-byte loads), one trap
//   check (3-input unsigned max), sixteen row loads in flight, then the
//   compares (2-5% faster than eight a step).
//
// Variants dropped after the card read them slower (tools/gather_bench.py):
// a cluster of up to 8 blocks holding 1,024 rows of a cloud each and
// reading the others' rows through distributed shared memory (at 8 x 8192,
// 0.0776 / 0.1361 / 0.2307 ms at w 64 / 128 / 256 against 0.0390 for the
// ring form in 16-byte rows and 0.0887 / 0.1686 for the shared form);
// outputs staged in shared memory and stored by TMA, a warp's four points
// a box (0.0150 / 0.0318 / 0.0584 at 64 x 1024 w 64 / 128 / 256, against
// 0.0133 / 0.0258 / 0.0510); L2-only stores (st.global.cg); more point
// ranges a slab (each stages the slab again).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

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

// A 32-bit word of a row: one f32 channel, or two bf16 channels.
template <typename T>
struct Word;
template <>
struct Word<float> {
  static constexpr uint32_t kLow = 0xff800000u;   // -inf
  static constexpr uint32_t kHigh = 0x7f800000u;  // +inf
  __device__ static uint32_t max(uint32_t x, uint32_t best) {
    return __float_as_uint(take_max(__uint_as_float(x), __uint_as_float(best)));
  }
  __device__ static uint32_t min(uint32_t x, uint32_t best) {
    return __float_as_uint(take_min(__uint_as_float(x), __uint_as_float(best)));
  }
};
template <>
struct Word<__nv_bfloat16> {
  static constexpr uint32_t kLow = 0xff80ff80u;
  static constexpr uint32_t kHigh = 0x7f807f80u;
  __device__ static uint32_t max(uint32_t x, uint32_t best) {
    uint32_t r;
    asm("max.NaN.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(best));
    return r;
  }
  __device__ static uint32_t min(uint32_t x, uint32_t best) {
    uint32_t r;
    asm("min.NaN.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(best));
    return r;
  }
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);  // exact: v is one of the row's values
}

// One point's running max and min over its k neighbours' rows, a lane's 16
// bytes (four 32-bit words) of each, the row of neighbour s at col + s RB:
// kWide (16 or 8) neighbours a step where k and idx allow, then 8, 4 and
// one at a time, with no branch between a step's loads: the indices
// (16-byte loads where vec_idx, the same address across the point's
// lanes), one check, the rows, then the compares.  An index outside
// [0, rows) traps.
template <typename T, int RB, int kWide>
__device__ __forceinline__ void neighbour_maxmin(const unsigned char* col, const int* ir,
                                                 int k, unsigned rows, bool vec_idx,
                                                 uint32_t (&mx)[4], uint32_t (&mn)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    mx[e] = Word<T>::kLow;
    mn[e] = Word<T>::kHigh;
  }
  auto take = [&](const uint4& x) {
    mx[0] = Word<T>::max(x.x, mx[0]);
    mx[1] = Word<T>::max(x.y, mx[1]);
    mx[2] = Word<T>::max(x.z, mx[2]);
    mx[3] = Word<T>::max(x.w, mx[3]);
    mn[0] = Word<T>::min(x.x, mn[0]);
    mn[1] = Word<T>::min(x.y, mn[1]);
    mn[2] = Word<T>::min(x.z, mn[2]);
    mn[3] = Word<T>::min(x.w, mn[3]);
  };
  auto row = [&](int src) {
    return *reinterpret_cast<const uint4*>(col + static_cast<unsigned>(src) * RB);
  };
  auto bad = [&](const int4& v) {  // any index outside [0, rows)
    return __vimax3_u32(__vimax3_u32(static_cast<unsigned>(v.x), static_cast<unsigned>(v.y),
                                     static_cast<unsigned>(v.z)),
                        static_cast<unsigned>(v.w), 0u) >= rows;
  };
  int j = 0;
  if (vec_idx) {
    if constexpr (kWide >= 16) {
      for (; j + 16 <= k; j += 16) {
        const int4 a = *reinterpret_cast<const int4*>(ir + j);
        const int4 c = *reinterpret_cast<const int4*>(ir + j + 4);
        const int4 d = *reinterpret_cast<const int4*>(ir + j + 8);
        const int4 e = *reinterpret_cast<const int4*>(ir + j + 12);
        if (bad(a) | bad(c) | bad(d) | bad(e)) __trap();  // outside the cloud
        const uint4 x0 = row(a.x), x1 = row(a.y), x2 = row(a.z), x3 = row(a.w);
        const uint4 x4 = row(c.x), x5 = row(c.y), x6 = row(c.z), x7 = row(c.w);
        const uint4 y0 = row(d.x), y1 = row(d.y), y2 = row(d.z), y3 = row(d.w);
        const uint4 y4 = row(e.x), y5 = row(e.y), y6 = row(e.z), y7 = row(e.w);
        take(x0);
        take(x1);
        take(x2);
        take(x3);
        take(x4);
        take(x5);
        take(x6);
        take(x7);
        take(y0);
        take(y1);
        take(y2);
        take(y3);
        take(y4);
        take(y5);
        take(y6);
        take(y7);
      }
    }
    for (; j + 8 <= k; j += 8) {
      const int4 a = *reinterpret_cast<const int4*>(ir + j);
      const int4 c = *reinterpret_cast<const int4*>(ir + j + 4);
      if (bad(a) | bad(c)) __trap();  // a neighbour outside the cloud
      const uint4 x0 = row(a.x), x1 = row(a.y), x2 = row(a.z), x3 = row(a.w);
      const uint4 x4 = row(c.x), x5 = row(c.y), x6 = row(c.z), x7 = row(c.w);
      take(x0);
      take(x1);
      take(x2);
      take(x3);
      take(x4);
      take(x5);
      take(x6);
      take(x7);
    }
  }
  for (; j + 4 <= k; j += 4) {
    const int4 a = vec_idx ? *reinterpret_cast<const int4*>(ir + j)
                           : make_int4(ir[j], ir[j + 1], ir[j + 2], ir[j + 3]);
    if (bad(a)) __trap();
    const uint4 x0 = row(a.x), x1 = row(a.y), x2 = row(a.z), x3 = row(a.w);
    take(x0);
    take(x1);
    take(x2);
    take(x3);
  }
  for (; j < k; ++j) {
    const int s0 = ir[j];
    if (static_cast<unsigned>(s0) >= rows) __trap();
    take(row(s0));
  }
}

// The shared form, S channels a slice.  kVec: w a multiple of a lane's
// channels and q, qmax, qmin 16-byte aligned.
template <typename T, int S, bool kVec>
__global__ void __launch_bounds__(1024)
    gather_maxmin_shared_kernel(const T* __restrict__ q,
                                const int* __restrict__ idx,
                                T* __restrict__ qmax,
                                T* __restrict__ qmin, int n, int w, int k,
                                int slices) {
  constexpr int kV = 16 / sizeof(T);    // channels a lane (16 bytes)
  constexpr int kLanes = S / kV;        // lanes a point
  constexpr int kPoints = 32 / kLanes;  // points a warp at once
  extern __shared__ __align__(16) unsigned char slab_bytes[];  // n rows of S
  T* slab = reinterpret_cast<T*>(slab_bytes);

  const long long cloud = blockIdx.x / slices;
  const int c0 = static_cast<int>(blockIdx.x % slices) * S;
  const int width = min(S, w - c0);  // this slice's channels
  const T* qc = q + cloud * n * w + c0;

  // Stage the slice: row r's channels at slab[r S ..].
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(slab));
  if constexpr (kVec) {
    const int chunks = width / kV;
    for (int e = threadIdx.x; e < n * chunks; e += blockDim.x) {
      const int r = e / chunks;
      const int c = kV * (e - r * chunks);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                   ::"r"(dst + static_cast<unsigned>(sizeof(T)) * (r * S + c)),
                   "l"(qc + static_cast<long long>(r) * w + c) : "memory");
    }
  } else if constexpr (sizeof(T) == 4) {
    for (int e = threadIdx.x; e < n * width; e += blockDim.x) {
      const int r = e / width;
      const int c = e - r * width;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                   ::"r"(dst + 4 * (r * S + c)),
                   "l"(qc + static_cast<long long>(r) * w + c) : "memory");
    }
  } else {  // 2-byte elements: below cp.async's smallest copy
    for (int e = threadIdx.x; e < n * width; e += blockDim.x) {
      const int r = e / width;
      const int c = e - r * width;
      slab[r * S + c] = qc[static_cast<long long>(r) * w + c];
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int group = lane / kLanes;  // the warp's point
  const int sub = lane % kLanes;    // channels kV sub .. kV sub + kV - 1
  const int warps = blockDim.x >> 5;
  const int* ic = idx + cloud * n * k;
  // this lane's channels of row 0
  const unsigned char* col = slab_bytes + 16 * sub;
  const long long out0 = cloud * n * w + c0 + kV * sub;
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
    uint32_t mx[4], mn[4];
    neighbour_maxmin<T, static_cast<int>(S * sizeof(T)), 8>(col, ir, k, rows, vec_idx, mx,
                                                           mn);
    if (live && kV * sub < width) {
      const long long o = out0 + static_cast<long long>(p) * w;
      if constexpr (kVec) {
        *reinterpret_cast<uint4*>(qmax + o) = make_uint4(mx[0], mx[1], mx[2], mx[3]);
        *reinterpret_cast<uint4*>(qmin + o) = make_uint4(mn[0], mn[1], mn[2], mn[3]);
      } else {
        const T* hi = reinterpret_cast<const T*>(mx);
        const T* lo = reinterpret_cast<const T*>(mn);
#pragma unroll
        for (int e = 0; e < kV; ++e) {
          if (kV * sub + e < width) {
            qmax[o + e] = hi[e];
            qmin[o + e] = lo[e];
          }
        }
      }
    }
  }
}

template <typename T, int S, bool kVec>
int launch_slice(const T* q, const int* idx, T* qmax, T* qmin,
                 long long b, int n, int w, int k, cudaStream_t s) {
  const int slices = (w + S - 1) / S;
  const long long blocks = b * slices;
  const int smem = n * S * static_cast<int>(sizeof(T));
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // the blocks an SM holds by shared memory, and threads to fill it: 1,024
  // for one block, else at most 2,048 an SM with registers to spare
  const int resident = kSmBytes / (smem + 1024);
  const int threads = resident <= 1 ? 1024 : (resident == 2 ? 512 : 256);
  auto kernel = gather_maxmin_shared_kernel<T, S, kVec>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), threads, smem, s>>>(
      q, idx, qmax, qmin, n, w, k, slices);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int S>
int launch_shared(const T* q, const int* idx, T* qmax, T* qmin,
                  long long b, int n, int w, int k, cudaStream_t s) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(qmax) |
                         reinterpret_cast<uintptr_t>(qmin);
  const bool vec = w % (16 / sizeof(T)) == 0 && ptrs % 16 == 0;
  return vec ? launch_slice<T, S, true>(q, idx, qmax, qmin, b, n, w, k, s)
             : launch_slice<T, S, false>(q, idx, qmax, qmin, b, n, w, k, s);
}

// The L2 form: one warp a point row, reading each neighbour's row from
// device memory in 32-channel strides, kPerLane channels a lane a pass
// (in f32, which holds a bf16 value exactly).
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    gather_maxmin_l2_kernel(const T* __restrict__ q,
                            const int* __restrict__ idx,
                            T* __restrict__ qmax, T* __restrict__ qmin,
                            long long rows, int n, int w, int k) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const long long cloud = row / n;
  const T* qc = q + cloud * n * w;
  const int* ir = idx + row * k;
  T* omax = qmax + row * w;
  T* omin = qmin + row * w;

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
        const T* r = qc + static_cast<long long>(src) * w;
#pragma unroll
        for (int v = 0; v < kPerLane; ++v) {
          const int c = c0 + v * 32 + lane;
          if (c < w) {
            const float x = to_f32(r[c]);
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
        from_f32(mx[v], omax + c);
        from_f32(mn[v], omin + c);
      }
    }
  }
}

// q: (b, n, w); idx: (b, n, k) int32 in [0, n).  Writes qmax and qmin,
// each (b, n, w) of q's type.  slice: the shared form's S (in channels,
// with n S elements within a block's shared memory), or 0 for the L2
// form, as gather_form chose.  Returns a cudaError_t code (0 on success).
template <typename T>
int gather(const T* q, const int* idx, T* qmax, T* qmin, long long b, int n,
           int w, int k, int slice, void* stream) {
  constexpr int kE = sizeof(T);
  if (b == 0 || n == 0 || w == 0) return 0;
  if (b < 0 || n < 0 || w < 0 || k < 1 ||
      static_cast<long long>(n) * slice * kE > kSharedBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (slice * kE) {  // a slice's bytes a row
    case 128: return launch_shared<T, 128 / kE>(q, idx, qmax, qmin, b, n, w, k, s);
    case 64: return launch_shared<T, 64 / kE>(q, idx, qmax, qmin, b, n, w, k, s);
    case 32: return launch_shared<T, 32 / kE>(q, idx, qmax, qmin, b, n, w, k, s);
    case 16: return launch_shared<T, 16 / kE>(q, idx, qmax, qmin, b, n, w, k, s);
    case 0: break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long rows = b * n;
  const long long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  gather_maxmin_l2_kernel<T><<<static_cast<unsigned>(blocks), kWarps * 32, 0, s>>>(
      q, idx, qmax, qmin, rows, n, w, k);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The ring form (bf16), as the header says: a persistent block an SM walks
// its tiles, each a (cloud, slice of RB / 2 channels, range of points); the
// slice's rows (its slab, RB bytes a row) arrive by TMA boxes of kBoxRows
// rows that complete on an mbarrier, the next slab's first rows during the
// current slab's gather.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait for the phase of parity `parity`; a copy that has not landed after
// 4 s traps rather than hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint64_t start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) start = global_ns();
    else if (global_ns() - start > 4000000000ull) __trap();
  }
}

constexpr int kRingThreads = 1024;
constexpr int kRingBarBytes = 16;  // two mbarriers after the rows

// A slab's rows in boxes of 8 KB (at most 256 rows, TMA's largest box), and
// the rows a block's shared memory holds, a whole number of boxes: 1,792
// rows of 128 bytes, 3,584 of 64, 7,168 of 32, 14,336 of 16.
template <int RB>
struct Ring {
  static constexpr int kBoxRows = 8192 / RB < 256 ? 8192 / RB : 256;
  static constexpr int kRows = (kSharedBytes - kRingBarBytes) / RB / kBoxRows * kBoxRows;
  static constexpr int kBytes = kRows * RB + kRingBarBytes;
};

// The ring holds `held` rows: Ring<RB>::kRows, or one slab's npad where
// each block has one tile.  The slab of a block's j-th tile lies at ring
// row 0 when j is even and at held - npad when j is odd, so two neighbours
// share the middle `ov` boxes when 2 npad > held: a slab's boxes outside
// them load while the previous slab is gathered (early), the shared ones
// after its last gather (late).  Each mbarrier takes two arrivals a phase,
// one with each part's bytes.
template <int RB>
__global__ void __launch_bounds__(kRingThreads, 1)
    gather_maxmin_ring_kernel(const __grid_constant__ CUtensorMap qmap,
                              const int* __restrict__ idx,
                              __nv_bfloat16* __restrict__ qmax,
                              __nv_bfloat16* __restrict__ qmin, int n, int w,
                              int k, int c_begin, int slices, int parts,
                              long long tiles, int held) {
  using T = __nv_bfloat16;
  constexpr int kLanes = RB / 16;       // lanes a point, 8 channels each
  constexpr int kPoints = 32 / kLanes;  // points a warp at once
  constexpr int kC = Ring<RB>::kBoxRows;
  extern __shared__ __align__(128) unsigned char ring[];
  const uint32_t full = smem_addr(ring + held * RB);  // two mbarriers

  const int nb = (n + kC - 1) / kC;  // boxes a slab
  const int npad = nb * kC;
  const int ov = max(0, 2 * npad - held) / kC;
  const long long stride = gridDim.x;  // block i takes tiles i, i + grid, ...

  // boxes [i0, i1) of the slab of tile t, the block's j-th, with one arrival
  auto issue = [&](long long t, int j, int i0, int i1) {
    const long long slab = t / parts;
    const uint32_t bar = full + 8u * (j & 1);
    const int base = (j & 1) ? held - npad : 0;
    const int cloud = static_cast<int>(slab / slices);
    const int c0 = c_begin + static_cast<int>(slab % slices) * (RB / 2);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"((i1 - i0) * kC * RB)
                 : "memory");
    for (int i = i0; i < i1; ++i) {
      asm volatile(
          "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(ring + (base + i * kC) * RB)),
          "l"(reinterpret_cast<uint64_t>(&qmap)), "r"(c0), "r"(i * kC), "r"(cloud),
          "r"(bar)
          : "memory");
    }
  };
  // the early part of the block's j-th slab (j >= 1), and then its late part
  auto early = [&](long long t, int j) {
    if (j & 1) issue(t, j, ov, nb);
    else issue(t, j, 0, nb - ov);
  };
  auto late = [&](long long t, int j) {
    if (j & 1) issue(t, j, 0, ov);
    else issue(t, j, nb - ov, nb);
  };

  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 2;\n" ::"r"(full) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 2;\n" ::"r"(full + 8) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    issue(blockIdx.x, 0, 0, nb);
    issue(blockIdx.x, 0, 0, 0);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int group = lane / kLanes;  // the warp's point
  const int sub = lane % kLanes;    // channels 8 sub .. 8 sub + 7 of the slice
  const int warps = blockDim.x >> 5;
  const unsigned rows = static_cast<unsigned>(n);
  const bool vec_idx = k % 4 == 0 && reinterpret_cast<uintptr_t>(idx) % 16 == 0;

  int j = 0;
  for (long long t = blockIdx.x; t < tiles; t += stride, ++j) {
    // the previous tile's gathers are over (synced below): its rows that
    // this tile's late part overwrites are free
    if (j > 0 && threadIdx.x == 0) {
      // order the gathers' reads of the ring before the copies' writes
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      late(t, j);
    }
    mbar_wait(full + 8u * (j & 1), (j >> 1) & 1);
    // the next tile's early part once this one has landed, so the two do
    // not share device memory's rate while the block waits
    if (threadIdx.x == 0 && t + stride < tiles) early(t + stride, j + 1);
    const long long slab = t / parts;
    const long long cloud = slab / slices;
    const int c0 = c_begin + static_cast<int>(slab % slices) * (RB / 2);
    const int part = static_cast<int>(t - slab * parts);
    const int p_lo = static_cast<int>(static_cast<long long>(part) * n / parts);
    const int p_hi = static_cast<int>(static_cast<long long>(part + 1) * n / parts);
    const unsigned char* col = ring + ((j & 1) ? held - npad : 0) * RB + 16 * sub;
    const int* ic = idx + cloud * n * k;
    const long long out0 = cloud * n * w + c0 + 8 * sub;
    const bool store = c0 + 8 * sub < w;

    for (int p0 = p_lo + (threadIdx.x >> 5) * kPoints; p0 < p_hi; p0 += warps * kPoints) {
      const int p = p0 + group;  // the same p0 across the warp
      const bool live = p < p_hi;
      // a lane past the range repeats row p_hi - 1's reads, and stores nothing
      const int* ir = ic + static_cast<long long>(min(p, p_hi - 1)) * k;
      if (sub == 0 && p + warps * kPoints < p_hi) {
        const int* next = ir + static_cast<long long>(warps * kPoints) * k;
        asm volatile("prefetch.global.L1 [%0];" ::"l"(next));
        asm volatile("prefetch.global.L1 [%0];" ::"l"(next + k - 1));
      }
      uint32_t mx[4], mn[4];
      neighbour_maxmin<T, RB, 16>(col, ir, k, rows, vec_idx, mx, mn);
      if (live && store) {
        const long long o = out0 + static_cast<long long>(p) * w;
        uint4* hi = reinterpret_cast<uint4*>(qmax + o);
        uint4* lo = reinterpret_cast<uint4*>(qmin + o);
        if constexpr (RB >= 32) {
          // streaming stores of whole 32-byte sectors: a fifth faster at w
          // 128 than plain ones
          __stcs(hi, make_uint4(mx[0], mx[1], mx[2], mx[3]));
          __stcs(lo, make_uint4(mn[0], mn[1], mn[2], mn[3]));
        } else {  // half sectors: kept in L2 until the next slice fills them
          *hi = make_uint4(mx[0], mx[1], mx[2], mx[3]);
          *lo = make_uint4(mn[0], mn[1], mn[2], mn[3]);
        }
      }
    }
    if (t + stride < tiles) __syncthreads();  // the ring's rows are refilled
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's tensor-map encoder, looked up once (the library is not linked)
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// q (b, n, w) bf16 as boxes of RB / 2 channels x kBoxRows points of one
// cloud, unswizzled; columns past w and rows past n arrive as zeros
template <int RB>
bool q_map(CUtensorMap* map, const __nv_bfloat16* q, long long b, int n, int w) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t gdim[3] = {static_cast<cuuint64_t>(w), static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t gstride[2] = {static_cast<cuuint64_t>(w) * 2,
                                 static_cast<cuuint64_t>(n) * w * 2};
  const cuuint32_t box[3] = {RB / 2, Ring<RB>::kBoxRows, 1}, estride[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<__nv_bfloat16*>(q), gdim,
            gstride, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int RB>
int launch_ring(const __nv_bfloat16* q, const int* idx, __nv_bfloat16* qmax,
                __nv_bfloat16* qmin, long long b, int n, int w, int k, int c_begin,
                int slices, int parts, int grid, cudaStream_t s) {
  const long long tiles = b * slices * parts;
  if (n > Ring<RB>::kRows || parts > n || grid > tiles ||
      c_begin + (slices - 1) * (RB / 2) >= w) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap map;
  if (!q_map<RB>(&map, q, b, n, w)) return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      gather_maxmin_ring_kernel<RB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Ring<RB>::kBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // a block of one tile holds its slab alone, leaving the rest to L1
  const int kC = Ring<RB>::kBoxRows;
  const int rows = tiles <= grid ? (n + kC - 1) / kC * kC : Ring<RB>::kRows;
  gather_maxmin_ring_kernel<RB><<<grid, kRingThreads, rows * RB + kRingBarBytes, s>>>(
      map, idx, qmax, qmin, n, w, k, c_begin, slices, parts, tiles, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, qmax, qmin f32; slice 32, 16, 8, 4 or 0.
extern "C" int pcp_gather_maxmin(const float* q, const int* idx, float* qmax,
                                 float* qmin, long long b, int n, int w, int k,
                                 int slice, void* stream) {
  return gather(q, idx, qmax, qmin, b, n, w, k, slice, stream);
}

// q, qmax, qmin bf16; slice 64, 32, 16, 8 or 0.
extern "C" int pcp_gather_maxmin_bf16(const __nv_bfloat16* q, const int* idx,
                                      __nv_bfloat16* qmax, __nv_bfloat16* qmin,
                                      long long b, int n, int w, int k,
                                      int slice, void* stream) {
  return gather(q, idx, qmax, qmin, b, n, w, k, slice, stream);
}

// The ring form: q, qmax, qmin bf16, w a multiple of 8 and each pointer
// 16-byte aligned; slices of row_bytes / 2 channels (128, 64, 32 or 16
// bytes a row) from channel c_begin, each cloud's slab cut into `parts`
// point ranges, on `grid` persistent blocks, as gather_plan chose.
extern "C" int pcp_gather_maxmin_bf16_ring(const __nv_bfloat16* q, const int* idx,
                                           __nv_bfloat16* qmax, __nv_bfloat16* qmin,
                                           long long b, int n, int w, int k, int row_bytes,
                                           int c_begin, int slices, int parts, int grid,
                                           void* stream) {
  if (b == 0 || n == 0 || w == 0) return 0;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(qmax) |
                         reinterpret_cast<uintptr_t>(qmin);
  if (b < 0 || n < 0 || k < 1 || w % 8 != 0 || ptrs % 16 != 0 || c_begin < 0 ||
      c_begin % 8 != 0 || slices < 1 || parts < 1 || grid < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (row_bytes) {
    case 128: return launch_ring<128>(q, idx, qmax, qmin, b, n, w, k, c_begin, slices, parts, grid, s);
    case 64: return launch_ring<64>(q, idx, qmax, qmin, b, n, w, k, c_begin, slices, parts, grid, s);
    case 32: return launch_ring<32>(q, idx, qmax, qmin, b, n, w, k, c_begin, slices, parts, grid, s);
    case 16: return launch_ring<16>(q, idx, qmax, qmin, b, n, w, k, c_begin, slices, parts, grid, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* pcp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
