// Farthest-point sampling with the picked coordinates.
//
// Replaces ops/pallas/fps.py::fps_pallas_with_points (its _fps_kernel), the
// VMEM-resident selection loop that the JAX package runs on the TPU.
//
// FPS is a serial loop of K steps per cloud; each step updates a running
// min squared distance over the cloud's n points and picks its argmax.  It
// does ~9 operations per point and step, so on the H100 the bound is
// neither memory nor arithmetic but the instruction latency of one step: the
// distance pass over the cloud plus one argmax across the cloud.  Three
// forms; the caller picks one from (b, n) (ops/cuda/fps.py::kernel_form):
//
// - fps_kernel<.., false> (pcp_fps, cluster 1, n <= kBlockMaxSlots = 8,192):
//   one block a cloud.
// - fps_kernel<.., true> (pcp_fps, cluster C in 2..8, n <= C * 8,192): a
//   thread-block cluster a cloud, each block holding a slice of it; the
//   blocks exchange their best candidate through distributed shared memory.
// - fps_large_kernel (pcp_fps_large, any n >= 1): the coordinates are read
//   from device memory at every step and the running minima live in a
//   (b, n) f32 scratch that the caller allocates; one SM a cloud, a simple
//   form for clouds above the cluster form's reach.
//
// fps_kernel's design, from a split of the earlier one-block kernel on the
// card (PERF.md): its distance pass was ~61% of a step, its warp-shuffle
// argmax ~18%.
// - The valid rows are compacted in row order into slots once, at load, so
//   the pass has no per-point validity test; a block's unused slots copy the
//   last valid row, which ties it at every step and loses the tie.  Slot
//   order is row order, so "lowest slot" is "lowest row".
// - Each thread keeps its PPT points' coordinates and running minima in
//   registers; a warp owns a contiguous run of 32 * PPT slots.
// - Scores are compared as their bit patterns: a running min is +0 or more
//   (a sum of squares) or the canonical NaN 0x7FFFFFFF that PTX min.NaN
//   returns, so unsigned order of the bits is "NaN first, then larger".  A
//   thread's PPT candidates reduce in a tree (ties to the lower slot), a
//   warp's in two redux.sync (max key, then min slot among the lanes that
//   hold it).
// - One barrier a step: the warps' partials are double-buffered by the
//   step's parity, and every warp reduces them all itself.  A cluster adds
//   one cluster barrier: warp 0 of each block writes the block's best
//   (key, slot, row, coordinates) into every peer's shared memory.
// - Exact pruning (FlashFPS): a warp skips its pass when the lower bound of
//   the distance from its run's bounding box to the new centre is >= the
//   run's largest running min.  The bound is computed with the same rounded
//   operations, and rounding is monotone, so it is <= every point's
//   rounded distance: the skipped update would have changed nothing.  The
//   first step never tests, so a NaN coordinate has made its run's largest
//   running min NaN before any test, and a NaN never passes the test.  On
//   the Morton-ordered voxel output a run is a compact tile.  On a cloud in
//   random order every run spans the cloud and the test costs ~7% a step;
//   making the test depend on a flag set at run time cost more than that
//   on the voxel output (PERF.md), so every warp tests.
//
// Semantics held exactly to the JAX kernel (and to torch.minimum/argmax):
// - the min distance starts at +inf; d = (x-cx)^2 + (y-cy)^2 + (z-cz)^2 by
//   direct differences, rounded in that order (the __f*_rn intrinsics keep
//   nvcc from contracting to FMA, which would round differently from the
//   plain version and flip near-ties);
// - the running min propagates NaN (PTX min.NaN): once a valid point's
//   distance is NaN its score stays NaN (fminf would drop it);
// - invalid points never take part (the JAX kernel's where(valid, min_dist,
//   -inf)), and the argmax follows jnp.argmax: NaN beats every number, ties
//   go to the lowest index, and when every score is -inf the pick is 0.
// A seed outside [0, n) stops the kernel with a trap (checked on the
// device, so no host sync), and the next CUDA call raises.

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBlockMaxSlots = 8192;  // 1024 threads x 8 points
constexpr int kMaxCluster = 8;        // the portable cluster size
constexpr int kLargeThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNoSlot = 0xffffffffu;  // loses every tie

// torch.minimum / jnp.minimum: NaN if either operand is NaN
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float sq_dist(float x, float y, float z, float cx,
                                         float cy, float cz) {
  const float dx = __fsub_rn(x, cx);
  const float dy = __fsub_rn(y, cy);
  const float dz = __fsub_rn(z, cz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// The gap between [lo, hi] and c along one axis, 0 inside (NaN stays NaN)
__device__ __forceinline__ float gap(float lo, float hi, float c) {
  return max_nan(max_nan(__fsub_rn(lo, c), __fsub_rn(c, hi)), 0.0f);
}

__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A block's best candidate, as written into its cluster peers
struct Record {
  unsigned key, slot;
  int row;
  float x, y, z;
};

template <int THREADS, int PPT, bool CLUSTER>
__global__ void __launch_bounds__(THREADS)
    fps_kernel(const float* __restrict__ points,
               const unsigned char* __restrict__ valid,
               const int* __restrict__ start, int* __restrict__ out_idx,
               float* __restrict__ out_pts, int n, int k, int bcn) {
  constexpr int kWarps = THREADS / 32;
  constexpr int kSlots = THREADS * PPT;  // a block's slots
  extern __shared__ float staged[];      // xs, ys, zs, rows of the slots
  float* xs = staged;
  float* ys = xs + kSlots;
  float* zs = ys + kSlots;
  int* rows = reinterpret_cast<int*>(zs + kSlots);
  __shared__ uint2 part[2][kWarps];  // (key, slot) a warp, by step parity
  __shared__ int counts[2][kWarps];
  __shared__ Record rec[2][kMaxCluster];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int rank = 0, csize = 1;
  if constexpr (CLUSTER) {
    rank = static_cast<int>(cg::this_cluster().block_rank());
    csize = static_cast<int>(cg::this_cluster().num_blocks());
  }
  const long long cloud = blockIdx.x / csize;
  const float* p = points + cloud * 3 * n;
  // row q's coordinate c sits at p[q * step + c * plane]
  const long long step = bcn ? 1 : 3;
  const long long plane = bcn ? n : 1;
  const unsigned char* vm = valid + cloud * n;
  const int first_slot = rank * kSlots;  // this block's first slot

  // Compaction: valid row q takes slot "valid rows before q"; this block
  // stages the rows of its slots.
  int nv = 0;
  for (int r0 = 0, round = 0; r0 < n; r0 += THREADS, ++round) {
    const int q = r0 + tid;
    const bool v = q < n && vm[q];
    const unsigned ballot = __ballot_sync(kFull, v);
    if (lane == 0) counts[round & 1][warp] = __popc(ballot);
    __syncthreads();
    int c = lane < kWarps ? counts[round & 1][lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kFull, c, o);
      if (lane >= o) c += t;
    }
    const int before = warp == 0 ? 0 : __shfl_sync(kFull, c, warp - 1);
    const int slot = nv + before + __popc(ballot & ((1u << lane) - 1u));
    if (v && slot >= first_slot && slot < first_slot + kSlots) {
      const int l = slot - first_slot;
      const float* r = p + q * step;
      xs[l] = r[0];
      ys[l] = r[plane];
      zs[l] = r[2 * plane];
      rows[l] = q;
    }
    nv += __shfl_sync(kFull, c, 31);
  }
  if constexpr (CLUSTER) {
    cluster_sync_all();  // staged, and every peer's shared memory is live
  } else {
    __syncthreads();
  }

  int* oi = out_idx + cloud * k;
  float* op = out_pts + cloud * k * 3;
  const bool writer = rank == 0 && tid == 0;
  const int seed = start[cloud];
  if (seed < 0 || seed >= n) __trap();  // a seed outside the cloud: raise
  float cx = p[seed * step], cy = p[seed * step + plane],
        cz = p[seed * step + 2 * plane];
  if (writer) {
    oi[0] = seed;
    op[0] = cx;
    op[1] = cy;
    op[2] = cz;
  }
  if (nv == 0) {  // every score is -inf at every step: every later pick is 0
    if (rank == 0) {
      for (int s = 1 + tid; s < k; s += THREADS) {
        oi[s] = 0;
        op[3 * s] = p[0];
        op[3 * s + 1] = p[plane];
        op[3 * s + 2] = p[2 * plane];
      }
    }
    return;  // uniform across the cluster, before any remote access
  }

  // This thread's points: slot warp * 32 * PPT + j * 32 + lane of the block.
  // Slots past the last valid row copy it (only the block that holds it
  // has such slots in a warp that is not idle).
  const int warp_first = first_slot + warp * 32 * PPT;
  const bool idle = warp_first >= nv;  // no valid row in the warp's run
  const int last = max(nv - 1 - first_slot, 0);
  float px[PPT], py[PPT], pz[PPT], md[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int l = warp * 32 * PPT + j * 32 + lane;
    const int src = first_slot + l < nv ? l : last;
    px[j] = xs[src];
    py[j] = ys[src];
    pz[j] = zs[src];
    md[j] = CUDART_INF_F;
  }
  // the warp's bounding box (fminf/fmaxf skip NaN, see the note above)
  float lox = px[0], hix = px[0], loy = py[0], hiy = py[0], loz = pz[0],
        hiz = pz[0];
#pragma unroll
  for (int j = 1; j < PPT; ++j) {
    lox = fminf(lox, px[j]);
    hix = fmaxf(hix, px[j]);
    loy = fminf(loy, py[j]);
    hiy = fmaxf(hiy, py[j]);
    loz = fminf(loz, pz[j]);
    hiz = fmaxf(hiz, pz[j]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lox = fminf(lox, __shfl_xor_sync(kFull, lox, o));
    hix = fmaxf(hix, __shfl_xor_sync(kFull, hix, o));
    loy = fminf(loy, __shfl_xor_sync(kFull, loy, o));
    hiy = fmaxf(hiy, __shfl_xor_sync(kFull, hiy, o));
    loz = fminf(loz, __shfl_xor_sync(kFull, loz, o));
    hiz = fmaxf(hiz, __shfl_xor_sync(kFull, hiz, o));
  }

  unsigned wkey = 0u, wslot = kNoSlot;  // the warp's best: none if idle
  for (int s = 1; s < k; ++s) {
    if (!idle) {
      bool update = true;
      if (s > 1) {
        const float gx = gap(lox, hix, cx), gy = gap(loy, hiy, cy),
                    gz = gap(loz, hiz, cz);
        const float bound = __fadd_rn(
            __fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)), __fmul_rn(gz, gz));
        update = !(bound >= __uint_as_float(wkey));
      }
      if (update) {
        unsigned key[PPT];
        int at[PPT];
#pragma unroll
        for (int j = 0; j < PPT; ++j) {
          md[j] = min_nan(md[j], sq_dist(px[j], py[j], pz[j], cx, cy, cz));
          key[j] = __float_as_uint(md[j]);
          at[j] = j;
        }
#pragma unroll
        for (int w = 1; w < PPT; w <<= 1) {
#pragma unroll
          for (int j = 0; j + w < PPT; j += 2 * w) {
            if (key[j + w] > key[j]) {
              key[j] = key[j + w];
              at[j] = at[j + w];
            }
          }
        }
        const unsigned slot = warp_first + at[0] * 32 + lane;
        wkey = __reduce_max_sync(kFull, key[0]);
        wslot = __reduce_min_sync(kFull, key[0] == wkey ? slot : kNoSlot);
      }
    }
    if (lane == 0) part[s & 1][warp] = make_uint2(wkey, wslot);
    __syncthreads();
    const uint2 w = lane < kWarps ? part[s & 1][lane] : make_uint2(0u, kNoSlot);
    const unsigned bkey = __reduce_max_sync(kFull, w.x);
    const unsigned bslot = __reduce_min_sync(kFull, w.x == bkey ? w.y : kNoSlot);
    if constexpr (!CLUSTER) {
      cx = xs[bslot];
      cy = ys[bslot];
      cz = zs[bslot];
      if (writer) {
        oi[s] = rows[bslot];
        op[3 * s] = cx;
        op[3 * s + 1] = cy;
        op[3 * s + 2] = cz;
      }
    } else {
      if (warp == 0) {
        Record mine{bkey, bslot, 0, 0.0f, 0.0f, 0.0f};
        if (bslot != kNoSlot) {
          const int l = static_cast<int>(bslot) - first_slot;
          mine.row = rows[l];
          mine.x = xs[l];
          mine.y = ys[l];
          mine.z = zs[l];
        }
        if (lane < csize) {
          *cg::this_cluster().map_shared_rank(&rec[s & 1][rank], lane) = mine;
        }
      }
      cluster_sync_all();
      Record r{0u, kNoSlot, 0, 0.0f, 0.0f, 0.0f};
      if (lane < csize) r = rec[s & 1][lane];
      const unsigned ckey = __reduce_max_sync(kFull, r.key);
      const unsigned cslot =
          __reduce_min_sync(kFull, r.key == ckey ? r.slot : kNoSlot);
      const int from = __ffs(__ballot_sync(kFull, r.slot == cslot)) - 1;
      cx = __shfl_sync(kFull, r.x, from);
      cy = __shfl_sync(kFull, r.y, from);
      cz = __shfl_sync(kFull, r.z, from);
      const int row = __shfl_sync(kFull, r.row, from);
      if (writer) {
        oi[s] = row;
        op[3 * s] = cx;
        op[3 * s + 1] = cy;
        op[3 * s + 2] = cz;
      }
    }
  }
}

// The device-memory form's block argmax: (v, i) beats
// (bv, bi) under jnp.argmax: NaN first, then larger, then the lower index
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
    const float ov = __shfl_down_sync(kFull, v, off);
    const int oi = __shfl_down_sync(kFull, i, off);
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
__device__ __forceinline__ int block_argmax(float bv, int bi) {
  constexpr int kWarps = kLargeThreads / 32;
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
      m = min_nan(m, sq_dist(r[0], r[plane], r[2 * plane], cx, cy, cz));
      md[q] = m;
      if (later_better(m, bv)) {
        bv = m;
        bi = q;
      }
    }
    cur = block_argmax(bv, bi);
  }
}

template <int THREADS, int PPT, bool CLUSTER>
int launch(const float* points, const unsigned char* valid, const int* start,
           int* out_idx, float* out_pts, int b, int n, int k, int bcn,
           int cluster, cudaStream_t stream) {
  auto kernel = fps_kernel<THREADS, PPT, CLUSTER>;
  const size_t smem = 4 * sizeof(float) * THREADS * PPT;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (!CLUSTER) {
    fps_kernel<THREADS, PPT, false><<<b, THREADS, smem, stream>>>(
        points, valid, start, out_idx, out_pts, n, k, bcn);
    return static_cast<int>(cudaGetLastError());
  } else {
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(static_cast<unsigned>(b) * cluster);
    config.blockDim = dim3(THREADS);
    config.dynamicSmemBytes = smem;
    config.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.attrs = attr;
    config.numAttrs = 1;
    err = cudaLaunchKernelEx(&config, kernel, points, valid, start, out_idx,
                             out_pts, n, k, bcn);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
}

// The smallest block that holds `slots` points, 8 a thread from 256 up
template <bool CLUSTER>
int dispatch(int slots, const float* points, const unsigned char* valid,
             const int* start, int* out_idx, float* out_pts, int b, int n,
             int k, int bcn, int cluster, cudaStream_t s) {
  if (slots <= 256)
    return launch<256, 1, CLUSTER>(points, valid, start, out_idx, out_pts, b, n, k, bcn, cluster, s);
  if (slots <= 512)
    return launch<256, 2, CLUSTER>(points, valid, start, out_idx, out_pts, b, n, k, bcn, cluster, s);
  if (slots <= 1024)
    return launch<256, 4, CLUSTER>(points, valid, start, out_idx, out_pts, b, n, k, bcn, cluster, s);
  if (slots <= 2048)
    return launch<256, 8, CLUSTER>(points, valid, start, out_idx, out_pts, b, n, k, bcn, cluster, s);
  if (slots <= 4096)
    return launch<512, 8, CLUSTER>(points, valid, start, out_idx, out_pts, b, n, k, bcn, cluster, s);
  return launch<1024, 8, CLUSTER>(points, valid, start, out_idx, out_pts, b, n, k, bcn, cluster, s);
}

}  // namespace

// points: (b, n, 3) or, with bcn != 0, (b, 3, n) f32; valid: (b, n) bytes;
// start: (b,) int32 seeds.  Writes out_idx (b, k) int32 and out_pts
// (b, k, 3) f32.  cluster: the blocks a cloud (1 to 8); takes n <= cluster
// * 8,192.  Returns a cudaError_t code (0 on success).
extern "C" int pcp_fps(const float* points, const unsigned char* valid,
                       const int* start, int* out_idx, float* out_pts, int b,
                       int n, int k, int bcn, int cluster, void* stream) {
  if (b == 0) return 0;
  if (n < 1 || k < 1 || b < 0 || cluster < 1 || cluster > kMaxCluster ||
      n > cluster * kBlockMaxSlots) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int slots = (n + cluster - 1) / cluster;
  if (cluster == 1) {
    return dispatch<false>(slots, points, valid, start, out_idx, out_pts, b, n, k, bcn, 1, s);
  }
  return dispatch<true>(slots, points, valid, start, out_idx, out_pts, b, n, k, bcn, cluster, s);
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
