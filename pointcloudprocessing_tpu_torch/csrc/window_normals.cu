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
// For each query the function
//
//   1. takes m, the least squared distance > 0 to a valid candidate;
//   2. finds the least level s in [0, 12) whose threshold m * 2^s admits at
//      least k candidates: a count at level 11 (if it misses k, or if m >
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
// The reformulation.  Every count of the search is compared only with k,
// and for any threshold t, "at least k candidates have dm <= t" holds if and
// only if d_(k) <= t, where d_(k) is the k-th smallest dm of the block's
// candidates (repeats count, invalid candidates are +inf): the k smallest
// are all <= d_(k).  So the search needs two order statistics a query, m
// and d_(k), and its six counts become six compares of d_(k) against the
// same float thresholds; the selection is the counting search's bit for bit.
// The passes over the candidates fall from eight (the minimum, six counts,
// the selection) to two: pass 1 folds each distance into m and into the k
// smallest distances, kept sorted in registers behind one reject compare
// (a template bound KMAX of 8, 16 or 32 slots; slots beyond k hold -inf, so
// slot KMAX-1 is the k-th); pass 2 selects and sums.  For k above 32 the
// counting search runs as before, over the same streamed tiles
// (window_moments_kernel<0>, eight passes).
//
// What bounds it on the H100: operations.  The function needs each query's
// C distances once (8 flops), a compare for m, one for d_(k) and one for
// the selection (about 11 a candidate), and 19 flops per selected candidate
// for the sums, against 16 bytes of input and 40 of output a query.  This
// kernel computes a distance at most twice, in the two passes, and skips
// what it can prove useless.
//
// Design.  A prep kernel, one block per query block, packs each point as a
// float4 (x, y, z, w), w = +0 for a valid point and +inf for an invalid one,
// so dm = d + w exactly with no select; records the bounding box of each
// group of 16 points' valid points; and forms the block shift with a
// fixed-order reduction.  The main kernel runs one block of 128 threads per
// 128 queries of a query block (any Q that 128 divides), a query a thread;
// every lane of a warp reads the same candidate, a 16-byte shared
// broadcast.  (Two queries a thread, one load feeding two distances, ran
// slower: half the warps, and each warp's insertions and sums triggered by
// twice the lanes.)  The candidates and their boxes reach shared memory
// as tiles by 1-D bulk copies (TMA) that complete on an mbarrier: the whole
// window as one tile when it holds at most 2048 candidates (32 KB), else
// double-buffered tiles that every pass streams, the next tile's copies in
// flight while the block works on this one, so C is limited only by n.
// Pass 1 starts just before the warp's own queries and wraps around (the
// k-th falls fast).  The walks go a group of 16 at a time, and a warp skips
// a group when none of its queries could use it: the distance from a query
// to the group's box, rounded in the distance's own operation order, is at
// most every rounded distance to a point in it (rounding is monotone), so
// a group whose bound is not below a query's max(m, current k-th) changes
// neither, and one whose bound exceeds the threshold holds no selected
// candidate.  Pass 2 walks in candidate order.  An insertion or a selected
// candidate's sums run for the whole warp when any lane needs them
// (tools/window_events.py counts ~46 insertions and ~20 selections a query
// at the config-2 and config-5 shapes, ~135-140 and ~125 for its warp of
// 32), so a warp's lanes are
// neighbours in the Morton order, whose events fall close together.
// Clouds and query blocks share one grid dimension, so any number of
// clouds launches.
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
// so these sums are the more exact.  The block shift is summed in one fixed
// order, as if by Q threads (strided serial sums, a warp shuffle tree, the
// warps' totals in order), so the whole output is deterministic.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kLevels = 12;
constexpr float kHugeM = 1e37f;  // a larger m would overflow m * 2^11
constexpr float kHuge = 3e38f;   // finite "every valid candidate" threshold
constexpr float kSqrtHalf = 0.70710678118654752440f;
constexpr int kThreads = 128;  // threads, and queries, a main block
constexpr int kPrepThreads = 128;
constexpr int kMaxTile = 2048;  // candidates a shared tile holds (32 KB)
constexpr int kGroup = 16;      // candidates a bounding box covers

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// The block's walks over its candidates: tiles copied into shared memory by
// thread 0 with 1-D bulk copies that complete on one mbarrier per buffer,
// each tile with the bounding boxes of its groups.  One tile holds the
// whole window when it fits (one copy, read by every walk); else two
// buffers alternate, and each visit starts the next visit's copy.  Every
// walk but the last starts at the tile holding the block's own queries and
// wraps; the last walks in candidate order.
struct Tiles {
  float4* buf;    // nbuf tiles of span candidates
  float4* boxes;  // then nbuf tiles of span / kGroup boxes (lo, hi)
  uint32_t bar;   // shared address of two consecutive mbarriers
  const float4* src;
  const float4* src_boxes;
  int c, span, ntiles, first, walks, loads, visit;

  __device__ Tiles(float4* buf_, unsigned long long* bars, const float4* src_,
                   const float4* src_boxes_, int c_, int tile, int own,
                   int walks_)
      : buf(buf_), bar(smem_addr(bars)), src(src_), src_boxes(src_boxes_),
        c(c_), span(min(tile, c_)), walks(walks_), visit(0) {
    ntiles = (c + span - 1) / span;
    boxes = buf + (ntiles == 1 ? 1 : 2) * span;
    first = own / span;
    loads = ntiles == 1 ? 1 : walks * ntiles;
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
                   : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar + 8)
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0) issue(0);
  }

  __device__ int tile_of(int v) const {
    if (ntiles == 1) return 0;
    const int walk = v / ntiles, i = v % ntiles;
    return walk < walks - 1 ? (first + i) % ntiles : i;
  }

  __device__ static void copy(uint32_t dst, const void* src, uint32_t bytes,
                              uint32_t b) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(dst),
        "l"(src), "r"(bytes), "r"(b)
        : "memory");
  }

  __device__ void issue(int v) const {
    const int s0 = tile_of(v) * span;
    const uint32_t len = static_cast<uint32_t>(min(span, c - s0));
    const uint32_t b = bar + 8u * (v & 1);
    // the buffer's last readers passed a barrier; order their reads before
    // the copy's writes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
                 "r"(len * 16u + len / kGroup * 32u)
                 : "memory");
    copy(smem_addr(buf + (v & 1) * span), src + s0, len * 16u, b);
    copy(smem_addr(boxes + (v & 1) * (span / kGroup) * 2),
         src_boxes + s0 / kGroup * 2, len / kGroup * 32u, b);
  }

  // The tile of this visit, once it has landed: its first candidate s0, its
  // length, and its boxes.
  __device__ const float4* begin(int& s0, int& len, const float4*& bx) const {
    const int v = loads == 1 ? 0 : visit;
    if (threadIdx.x == 0 && v + 1 < loads) issue(v + 1);
    mbar_wait(bar + 8u * (v & 1), (v >> 1) & 1);
    s0 = tile_of(visit) * span;
    len = min(span, c - s0);
    bx = boxes + (v & 1) * (span / kGroup) * 2;
    return buf + (v & 1) * span;
  }

  __device__ void end() {
    if (loads > 1) __syncthreads();  // the buffer is refilled next visit
    ++visit;
  }
};

// One walk over every candidate, tile by tile, a group of kGroup at a time:
// keep(lo, hi), warp-uniform, says whether any of the warp's queries could
// use a candidate in the group's box; if so, f(candidate, j) on each
// candidate j of the group, four loads issued ahead of their uses.  From
// `own` around (rotated walks) or in candidate order.  Tiles and `own` are
// multiples of kGroup candidates.
template <class K, class F>
__device__ __forceinline__ void walk(Tiles& tiles, int own, bool in_order,
                                     K& keep, F& f) {
  for (int i = 0; i < tiles.ntiles; ++i) {
    int s0, len;
    const float4* bx;
    const float4* t = tiles.begin(s0, len, bx);
    const int rot = !in_order && own >= s0 && own < s0 + len ? own - s0 : 0;
    for (int u = 0; u < len; u += kGroup) {
      const int g = u + rot < len ? u + rot : u + rot - len;
      if (!keep(bx[g / kGroup * 2], bx[g / kGroup * 2 + 1])) continue;
#pragma unroll
      for (int j = g; j < g + kGroup; j += 4) {
        const float4 a = t[j], b = t[j + 1], c = t[j + 2], d = t[j + 3];
        f(a, j);
        f(b, j + 1);
        f(c, j + 2);
        f(d, j + 3);
      }
    }
    tiles.end();
  }
}

// The least distance, rounded as sqdist rounds it, from (qx, qy, qz) to a
// point of the box [lo, hi]: rounding is monotone, so each rounded
// difference to a point of the box is at least as large in magnitude as
// the one to the box's face, and so on through the squares and sums.  An
// empty box (lo +inf, hi -inf) gives +inf.
__device__ __forceinline__ float box_bound(float qx, float qy, float qz,
                                           float4 lo, float4 hi) {
  const float gx = fmaxf(fmaxf(__fsub_rn(lo.x, qx), __fsub_rn(qx, hi.x)), 0.0f);
  const float gy = fmaxf(fmaxf(__fsub_rn(lo.y, qy), __fsub_rn(qy, hi.y)), 0.0f);
  const float gz = fmaxf(fmaxf(__fsub_rn(lo.z, qz), __fsub_rn(qz, hi.z)), 0.0f);
  return __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)),
                   __fmul_rn(gz, gz));
}

// x into the KMAX smallest values seen, kept sorted ascending
template <int KMAX>
__device__ __forceinline__ void insert(float (&t)[KMAX], float x) {
#pragma unroll
  for (int i = KMAX - 1; i > 0; --i) t[i] = fminf(t[i], fmaxf(t[i - 1], x));
  t[0] = fminf(t[0], x);
}

// Packs the query block's own points as (x, y, z, w), and the bounding box
// of each group of kGroup of them (valid points only; +inf, -inf if none);
// and forms the block shift, the mean of its C candidates' valid points, in
// one fixed order: as Q threads would, each a strided serial sum, a shuffle
// tree a warp of 32, then the warps' totals in order.
__global__ void __launch_bounds__(kPrepThreads)
    window_moments_prep_kernel(const float* __restrict__ planes,
                               const unsigned char* __restrict__ valid,
                               float4* __restrict__ packed,
                               float4* __restrict__ boxes,
                               float4* __restrict__ shifts, int n, int q_block,
                               int window) {
  __shared__ float part[4][kPrepThreads / 32];
  const int tid = threadIdx.x;
  const int blocks = n / q_block;
  const long long cloud = blockIdx.x / blocks;
  const int q0 = static_cast<int>(blockIdx.x % blocks) * q_block;
  const float* px = planes + cloud * 3 * n;
  const float* py = px + n;
  const float* pz = py + n;
  const unsigned char* pv = valid + cloud * n;
  for (int j = q0 + tid; j < q0 + q_block; j += kPrepThreads) {
    packed[cloud * n + j] =
        make_float4(px[j], py[j], pz[j], pv[j] ? 0.0f : CUDART_INF_F);
  }
  for (int g = q0 + tid * kGroup; g < q0 + q_block; g += kPrepThreads * kGroup) {
    float4 lo = make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F, 0.0f);
    float4 hi = make_float4(-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F, 0.0f);
    for (int j = g; j < g + kGroup; ++j) {
      if (!pv[j]) continue;
      lo.x = fminf(lo.x, px[j]);
      lo.y = fminf(lo.y, py[j]);
      lo.z = fminf(lo.z, pz[j]);
      hi.x = fmaxf(hi.x, px[j]);
      hi.y = fmaxf(hi.y, py[j]);
      hi.z = fmaxf(hi.z, pz[j]);
    }
    boxes[(cloud * n + g) / kGroup * 2] = lo;
    boxes[(cloud * n + g) / kGroup * 2 + 1] = hi;
  }

  const int c = q_block + 2 * window;
  const int start = min(max(q0 - window, 0), n - c);
  float total[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // thread 0's: x, y, z, count
  for (int base = 0; base < q_block; base += kPrepThreads) {
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int j = base + tid; j < c; j += q_block) {
      const float v = pv[start + j] ? 1.0f : 0.0f;
      s[0] += px[start + j] * v;
      s[1] += py[start + j] * v;
      s[2] += pz[start + j] * v;
      s[3] += v;
    }
#pragma unroll
    for (int f = 0; f < 4; ++f) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s[f] += __shfl_down_sync(0xffffffffu, s[f], off);
      if ((tid & 31) == 0) part[f][tid >> 5] = s[f];
    }
    __syncthreads();
    if (tid == 0) {
#pragma unroll
      for (int f = 0; f < 4; ++f)
        for (int w = 0; w < kPrepThreads / 32; ++w) total[f] += part[f][w];
    }
    __syncthreads();
  }
  if (tid == 0) {
    const float nv = fmaxf(total[3], 1.0f);
    shifts[blockIdx.x] =
        make_float4(total[0] / nv, total[1] / nv, total[2] / nv, 0.0f);
  }
}

template <int KMAX>  // 0: the counting search (k > 32)
__global__ void __launch_bounds__(kThreads)
    window_moments_kernel(const float4* __restrict__ packed,
                          const float4* __restrict__ boxes,
                          const float4* __restrict__ shifts,
                          float* __restrict__ out, int b, int n, int q_block,
                          int window, int k, int tile) {
  extern __shared__ float4 buf[];
  __shared__ __align__(8) unsigned long long bars[2];
  const int tid = threadIdx.x;
  const int chunks = n / kThreads;
  const long long cloud = blockIdx.x / chunks;
  const int cq0 = static_cast<int>(blockIdx.x % chunks) * kThreads;
  const int q0 = cq0 / q_block * q_block;
  const int c = q_block + 2 * window;
  const int start = min(max(q0 - window, 0), n - c);
  const int own = cq0 - start;  // the block's first query among the candidates
  const float4* pts = packed + cloud * n;
  Tiles tiles(buf, bars, pts + start, boxes + (cloud * n + start) / kGroup * 2,
              c, tile, own, KMAX ? 2 : 8);
  // a warp's walks start just before its 32 queries
  const int from = max(own + (tid & ~31) - kGroup, 0);

  const float4 q = pts[cq0 + tid];
  auto dist = [&](const float4 cv) {
    return __fadd_rn(sqdist(q.x, q.y, q.z, cv.x, cv.y, cv.z), cv.w);
  };
  // A group is skipped when no query of the warp can use it: every
  // candidate in it is at least the box bound away.
  auto bound = [&](const float4 lo, const float4 hi) {
    return box_bound(q.x, q.y, q.z, lo, hi);
  };
  // m: the nearest non-self (d > 0) valid candidate, +inf if none; kept as
  // its bits - 1, which order positive floats with +0 last
  uint32_t mb = __float_as_uint(CUDART_INF_F) - 1u;
  float m;

  // ---- the threshold of each query
  float thr;
  if constexpr (KMAX > 0) {
    float top[KMAX];  // the k smallest dm; slots below KMAX - k hold -inf
#pragma unroll
    for (int i = 0; i < KMAX; ++i) top[i] = i < KMAX - k ? -CUDART_INF_F : CUDART_INF_F;
    // a group matters while it can hold a distance below m or the k-th
    auto keep = [&](const float4 lo, const float4 hi) {
      const float below = fmaxf(__uint_as_float(mb + 1u), top[KMAX - 1]);
      return __any_sync(0xffffffffu, bound(lo, hi) < below);
    };
    auto scan = [&](const float4 cv, int) {
      const float dm = dist(cv);
      mb = min(mb, __float_as_uint(dm) - 1u);
      // a no-op for a lane whose dm is not below its k-th
      if (__any_sync(0xffffffffu, dm < top[KMAX - 1])) insert<KMAX>(top, dm);
    };
    walk(tiles, from, false, keep, scan);
    m = __uint_as_float(mb + 1u);
    // "at least k within t" is "d_(k) <= t": the counting search's probes
    const float dk = top[KMAX - 1];
    const bool fallback =
        !(dk <= __fmul_rn(m, pow2i(kLevels - 1))) || m > kHugeM;
    int lo = 0, hi = kLevels - 1;
#pragma unroll
    for (int probe = 0; probe < 4; ++probe) {
      const int mid = (lo + hi) >> 1;
      if (dk <= __fmul_rn(m, pow2i(mid))) {
        hi = mid;
      } else {
        lo = mid + 1;
      }
    }
    const float thr_lo = __fmul_rn(m, __fmul_rn(pow2i(hi), kSqrtHalf));
    thr = fallback ? kHuge : dk <= thr_lo ? thr_lo : __fmul_rn(m, pow2i(hi));
  } else {
    auto keep_m = [&](const float4 lo, const float4 hi) {
      return __any_sync(0xffffffffu, bound(lo, hi) < __uint_as_float(mb + 1u));
    };
    auto scan = [&](const float4 cv, int) {
      mb = min(mb, __float_as_uint(dist(cv)) - 1u);
    };
    walk(tiles, from, false, keep_m, scan);
    m = __uint_as_float(mb + 1u);
    int cnt;
    auto keep_thr = [&](const float4 lo, const float4 hi) {
      return __any_sync(0xffffffffu, bound(lo, hi) <= thr);
    };
    auto count = [&](const float4 cv, int) { cnt += dist(cv) <= thr; };
    auto count_within = [&](float t) {
      thr = t;
      cnt = 0;
      walk(tiles, from, false, keep_thr, count);
      return cnt >= k;
    };
    const bool fallback =
        !count_within(__fmul_rn(m, pow2i(kLevels - 1))) || m > kHugeM;
    int lo = 0, hi = kLevels - 1;
    for (int probe = 0; probe < 4; ++probe) {
      const int mid = (lo + hi) >> 1;
      if (count_within(__fmul_rn(m, pow2i(mid)))) {
        hi = mid;
      } else {
        lo = mid + 1;
      }
    }
    const float thr_lo = __fmul_rn(m, __fmul_rn(pow2i(hi), kSqrtHalf));
    const bool tighter = count_within(thr_lo);
    thr = fallback ? kHuge : tighter ? thr_lo : __fmul_rn(m, pow2i(hi));
  }

  // ---- selection and sums, in candidate order
  const float4 sh = shifts[cloud * (n / q_block) + q0 / q_block];
  float s[10];
#pragma unroll
  for (int f = 0; f < 10; ++f) s[f] = 0.0f;
  auto keep_sel = [&](const float4 lo, const float4 hi) {
    return __any_sync(0xffffffffu, bound(lo, hi) <= thr);
  };
  auto sum = [&](const float4 cv, int) {
    if (dist(cv) <= thr) {
      const float ax = __fsub_rn(cv.x, sh.x);
      const float ay = __fsub_rn(cv.y, sh.y);
      const float az = __fsub_rn(cv.z, sh.z);
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
  };
  walk(tiles, from, true, keep_sel, sum);

  const long long plane = static_cast<long long>(b) * n;
  float* o = out + cloud * n + cq0 + tid;
#pragma unroll
  for (int f = 0; f < 10; ++f) o[f * plane] = s[f];
}

template <int KMAX>
int launch(const float4* packed, const float4* boxes, const float4* shifts,
           float* out, int b, int n, int q_block, int window, int k, int tile,
           int blocks, cudaStream_t stream) {
  const int c = q_block + 2 * window;
  const int span = min(tile, c);
  const size_t smem =
      (span >= c ? 1 : 2) * (span + span / kGroup * 2) * sizeof(float4);
  cudaError_t err = cudaFuncSetAttribute(
      window_moments_kernel<KMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  window_moments_kernel<KMAX><<<blocks, kThreads, smem, stream>>>(
      packed, boxes, shifts, out, b, n, q_block, window, k, tile);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// planes: (b, 3, n) f32 per-cloud-centred coordinates; valid: (b, n) bytes;
// scratch: 16-byte aligned, 16 * (b * n + b * n / 8 + b * n / q_block)
// bytes (the packed points, their groups' boxes, the block shifts).  Writes
// out (10, b, n) f32: cnt, sx, sy, sz, sxx, sxy, sxz, syy, syz, szz.
// q_block is a multiple of 128 that divides n; C = q_block + 2 * window <=
// n.  kmax is the register bound of the k smallest distances (8, 16 or 32,
// >= k) or 0 for the counting search; tile is the candidates a shared tile
// holds (a multiple of 128, at most 2048; the window is one tile when tile
// >= C).  Returns a cudaError_t code (0 on success).
extern "C" int pcp_window_moments(const float* planes, const unsigned char* valid,
                                  void* scratch, float* out, int b, int n, int k,
                                  int window, int q_block, int kmax, int tile,
                                  void* stream) {
  if (b == 0) return 0;
  const long long c = static_cast<long long>(q_block) + 2LL * window;
  const long long blocks = static_cast<long long>(b) * (n / kThreads);
  if (b < 0 || n < 1 || k < 1 || window < 0 || q_block < kThreads ||
      q_block % kThreads != 0 || n % q_block != 0 || c > n || tile < 128 ||
      tile % 128 != 0 || tile > kMaxTile ||
      (kmax != 0 && kmax != 8 && kmax != 16 && kmax != 32) ||
      (kmax != 0 && k > kmax) || blocks > INT_MAX ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long points = static_cast<long long>(b) * n;
  float4* packed = static_cast<float4*>(scratch);
  float4* boxes = packed + points;
  float4* shifts = boxes + points / kGroup * 2;
  window_moments_prep_kernel<<<static_cast<int>(blocks / (q_block / kThreads)),
                               kPrepThreads, 0, s>>>(
      planes, valid, packed, boxes, shifts, n, q_block, window);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nb = static_cast<int>(blocks);
  switch (kmax) {
    case 8:
      return launch<8>(packed, boxes, shifts, out, b, n, q_block, window, k, tile, nb, s);
    case 16:
      return launch<16>(packed, boxes, shifts, out, b, n, q_block, window, k, tile, nb, s);
    case 32:
      return launch<32>(packed, boxes, shifts, out, b, n, q_block, window, k, tile, nb, s);
    default:
      return launch<0>(packed, boxes, shifts, out, b, n, q_block, window, k, tile, nb, s);
  }
}

extern "C" const char* pcp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
