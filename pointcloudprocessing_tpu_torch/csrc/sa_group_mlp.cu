// One set-abstraction level of PointNet++ in inference: the grouping's
// gather, three pointwise layers with their BatchNorm folded in, and the max
// over each group, in one launch.
//
//   x[b, g, j, :] = [xyz[b, p] - centers[b, g]  ++  feats[b, p, :]],  p = idx[b, g, j]
//   h1 = relu(a1 * (x  . w1) + c1),  h2 = relu(a2 * (h1 . w2) + c2)
//   out[b, g, :] = max over j of relu(a3 * (h2 . w3) + c3)
//   a = scale * rsqrt(running_var + eps),  c = bias - running_mean * a
//
// Replaces no TPU kernel: pointcloudprocessing_tpu/models/pointnet2.py leaves
// the grouped MLP to XLA.  The port's plain path (models/pointnet2.py's
// _SetAbstraction on the CPU, in bf16 or in training) writes the grouped
// (b, m, k, c) input and each layer's activation to device memory and runs
// BatchNorm and relu as separate passes over them: at the serving shape (256
// clouds of 1,024 points; SA1 512 groups of 32 rows through 3-64-64-128,
// SA2 128 groups of 64 rows through 131-128-128-256) that is about 69 GB of
// traffic a batch and ~43 of its ~65 device ms on the H100.
//
// What bounds it on the H100: operations.  The two levels hold 383 GFLOP a
// batch; in 3xTF32 (three tensor-core products a multiply-add) at the
// card's dense 495 TFLOP/s that is 2.3 ms.  The bytes that have to move are
// small: the gathered rows come from a 67 MB feature tensor (L2 and device
// memory), the weights (50 KB and 264 KB) stay in L2, the outputs are 67 and
// 33 MB.  No grouped activation leaves the SM.
//
// Arithmetic.  The products are f32-accurate 3xTF32 on warpgroup MMA
// (wgmma m64nNk8, A from registers, B from shared memory): each f32
// operand v is split into hi = tf32(v) and lo = tf32(v - hi) (the weights
// round lo to nearest, the activations cut it toward zero), and each k-step
// adds lo*hi, then hi*lo, then hi*hi.  The tensor cores add their products
// toward zero, so, as the pooled-chain kernel does since it measured 5.8x
// an f32 GEMM's error without it, the products of a group of 16 input
// channels are summed on the tensor cores from zero and each group is added
// into f32 sums rounded to nearest.  The three coordinate channels (SA1's
// whole first layer, SA2's first three) run in f32 FFMA; centering is the
// plain path's single f32 subtraction.  relu keeps a NaN and the group max
// lets a NaN win, as torch.relu and amax do.
//
// Design.  A persistent block an SM walks tiles of (cloud, floor(kRows / k)
// groups, at most kMaxGroups): at kRows = 128 four groups of 32 rows in SA1,
// two of 64 in SA2.  Two activation regions of kRows rows alternate roles:
// the tile's gathered features land in one, layer 1 writes the other, layer
// 2 writes the first again, layer 3 reads it; so while layer 3 runs, the
// next tile's rows are gathered by cp.async into the free region (a lane a
// row's neighbour index, the rows as 16-byte copies, 4-byte ones for the
// coordinates).  The weights go in 64-column x 32-channel stages, a period
// of the same steps every tile (each layer's 64-column slices, each slice's
// 32-channel chunks).  A first launch, sa_group_mlp_split_kernel (a block
// a stage), splits the period's stages into hi and lo, laid out as wgmma's
// K-major core matrices, into a scratch in device memory (the weights are
// 50 KB and 264 KB, the scratch twice that, in L2); the main kernel runs
// after it in stream order, so its reads are ordered after those writes.
// There one thread brings
// each step's stage into a ring of kStages slots by a bulk copy, which
// completes on the slot's mbarrier.  The bulk copy is the async proxy that
// wgmma reads through, so no stage is split or fenced in the loop: splitting
// a stage a step in shared memory, with its proxy fence (a CTA memory
// barrier), cost 1.6 ms of the two levels' 9.8 (NVIDIA H100 80GB HBM3).  Each
// warpgroup owns 64 rows x 64 columns of a slice (at kRows = 64, all 64 rows
// x 32 columns).  Layers 1 and 2 end in an epilogue that applies the folded
// affine and relu and writes the next layer's operand into shared memory;
// layer 3's epilogue reduces its slice over the rows of each group in
// registers, so only (b, m, c_out) is written.  Where k is a multiple of 16
// a warp's 16 rows are of one group: a butterfly over them, then a thread a
// (group, column) takes the max over the group's warps; otherwise a
// segmented shuffle over each 8-row half, whose parts combine by
// shared-memory integer max on the non-negative values (a NaN as the
// largest key).  The affine is folded in the block's prologue.  Rows past
// the tile's groups are zeros and never reach the max.  A neighbour index
// outside [0, n) traps.
//
// What holds it above its bound, read on the card (clock64 stamps a phase,
// NVIDIA H100 80GB HBM3 at 700 W): the products run near the
// tensor cores' rate (issue and wait ~0.9 k clocks a step at SA2's widths
// against 0.77 k at peak), but 8 warps an SM (its shared memory holds one
// block) leave the rest of a step exposed: the A fragments' loads and
// splits, the promotions, the epilogues (layer 3's ~2.5-3 k clocks each)
// and the tile's start, ~1.3 k clocks a step.  Neither the next step's A
// fragments loaded under the products nor warpgroups that walk their own
// rows apart, so that one's epilogue runs beside the other's products,
// measured faster (8.36 and 8.01 ms for both levels against 8.00).
//
// kRows = 128 needs 2 x 128 x (max(f, c1, c2) + 4) floats of activations;
// wider levels (up to 256 channels) take kRows = 64.  The wrapper,
// ops/cuda/sa_group_mlp.py, picks the form and refuses other widths.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlice = 64;                // output columns a pass
constexpr int kChunk = 32;                // input channels a weight stage
constexpr int kStages = 4;                // the ring's weight stages
constexpr int kStageW = 2 * kSlice * kChunk;  // floats of a stage: its hi, then its lo
constexpr int kMaxGroups = 16;
constexpr int kMaxWidth = 256;
constexpr int kMaxK = 64;
constexpr int kAffine = 3 * kMaxWidth;
constexpr int kSmemLimit = 232448;

struct Level {
  const float* xyz;      // (b, n, 3)
  const float* feats;    // (b, n, f), or null at f 0
  const float* centers;  // (b, m, 3)
  const int* idx;        // (b, m, k)
  const float* w[3];     // (c1, 3 + f), (c2, c1), (c3, c2)
  const float* scale[3];
  const float* bias[3];
  const float* mean[3];
  const float* var[3];
  float* out;            // (b, m, c3)
  float* split;          // the period's stages, split (the split kernel writes them)
  float eps;
  int n, m, k, f;
  int c[3];
  int groups;            // groups a tile
  int tiles_per_cloud;
  int tiles;
  int stride;            // floats of an activation row
};

__host__ __device__ inline int act_stride(int f, int c1, int c2) {
  const int w = f > c1 ? f : c1;
  return (w > c2 ? w : c2) + 4;
}

__host__ __device__ inline long long smem_floats(int rows, int stride) {
  return 2LL * rows * stride + kStages * kStageW + 2 * rows * 4 + 2 * kMaxGroups * 4 +
         kMaxWidth * 4 + 2 * kAffine + kMaxGroups * kSlice + 2 * kStages;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo to ~2^-22 of |v|, both tf32 (the weights' split)
__device__ __forceinline__ uint2 split(float v) {
  const uint32_t hi = to_tf32(v);
  return make_uint2(hi, to_tf32(__fsub_rn(v, __uint_as_float(hi))));
}

// the activations' split in four integer and float instructions: hi is
// cvt.rna's, lo is v - hi cut to tf32 toward zero (v = hi + lo to ~2^-21 of
// |v|); a NaN gives a NaN lo, so its products are NaN
__device__ __forceinline__ void split_x(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(v, __uint_as_float(hi))) & 0xffffe000u;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// wait for the phase of parity `parity` to complete
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// a bulk copy (the async proxy) of `bytes` from device memory, completing
// on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// shared-memory matrix descriptor of a no-swizzle K-major wgmma B operand:
// core matrices of 8 columns x 4 k, 128 contiguous bytes; the next 8
// columns 128 bytes on (the stride offset), the next 4 k kSlice * 16 bytes
// on (the leading offset)
__device__ __forceinline__ uint64_t b_desc(unsigned addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((kSlice * 16) >> 4) << 16) |
         (static_cast<uint64_t>(128 >> 4) << 32);
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// ties reads and writes of the accumulators to this point (after a wait):
// the compiler does not move them across it
template <int N>
__device__ __forceinline__ void keep_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x n of the warpgroup) += a (64 x 8, registers) * b (8 x n, shared
// memory, K-major), tf32 in, f32 accumulators; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[16], const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// relu that keeps a NaN (and -0), as torch.relu
__device__ __forceinline__ float relu(float y) { return y < 0.f ? 0.f : y; }

__device__ __forceinline__ float affine(float a, float v, float c) {
  return __fadd_rn(__fmul_rn(a, v), c);
}

// the larger, a NaN on either side winning
__device__ __forceinline__ float max_nan(float v, float o) {
  return (o > v || o != o) ? o : v;
}

// an order-preserving key of a relu output (+0 and up, -0, or NaN): a NaN
// is the largest, -0 sorts below +0, which the slots start at
__device__ __forceinline__ int max_key(float v) {
  return v != v ? 0x7fffffff : __float_as_int(v);
}

// a step of the period: layer, 64-column slice, 32-channel chunk
struct Cursor {
  int layer, s, q;
};

// a tile: its cloud, first group, groups and rows in use
struct Tile {
  int cloud, m0, gv, valid;
};

// the stages of a tile's period of steps (f 0 skips layer 1's feature
// channels)
__host__ __device__ inline int period_steps(int f, int c1, int c2, int c3) {
  return (c1 / kSlice) * (f / kChunk) + (c2 / kSlice) * (c1 / kChunk) +
         (c3 / kSlice) * (c2 / kChunk);
}

// a block a stage: the period's stage blockIdx.x split into hi and lo in
// the scratch, laid out as the stage in shared memory takes it: wgmma's
// K-major core matrices, element (column n, channel k) of a 64 x 32 stage
// at (k / 4, n, k % 4)
__global__ void __launch_bounds__(kThreads) sa_group_mlp_split_kernel(const Level L) {
  const int chunks[3] = {L.f / kChunk, L.c[0] / kChunk, L.c[1] / kChunk};
  int st = static_cast<int>(blockIdx.x), layer = L.f ? 0 : 1;
  while (st >= (L.c[layer] / kSlice) * chunks[layer]) {
    st -= (L.c[layer] / kSlice) * chunks[layer];
    ++layer;
  }
  const int s = st / chunks[layer], q = st % chunks[layer];
  const int width = layer == 0 ? 3 + L.f : L.c[layer - 1];
  const float* w = L.w[layer] + static_cast<size_t>(s) * kSlice * width +
                   (layer == 0 ? 3 : 0) + q * kChunk;
  float* dst = L.split + static_cast<size_t>(blockIdx.x) * kStageW;
#pragma unroll
  for (int h = 0; h < kSlice * kChunk / kThreads; ++h) {
    const int e = threadIdx.x + h * kThreads;
    const int n = (e >> 2) % kSlice, k = (e / (4 * kSlice)) * 4 + (e & 3);
    const uint2 pair = split(w[static_cast<size_t>(n) * width + k]);
    dst[e] = __uint_as_float(pair.x);
    dst[e + kSlice * kChunk] = __uint_as_float(pair.y);
  }
}

template <int kRows>
__global__ void __launch_bounds__(kThreads, 1) sa_group_mlp_kernel(const Level L) {
  constexpr int kRowWarps = kRows / 16;
  constexpr int kNT = kRows / 16;       // 8-column tiles a warpgroup's slice share holds
  constexpr int kWarpRows = kRows / 8;  // rows a warp gathers
  constexpr int kAcc = kNT * 4;         // a thread's accumulators
  static_assert(kRowWarps * (kSlice / (kNT * 8)) == kThreads / 32, "warp layout");

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int S = L.stride;
  float* const act0 = smem;
  float* const act1 = smem + kRows * S;
  float* const stages = smem + 2 * kRows * S;        // [kStages][hi, lo][k / 4][kSlice][4]
  float* const pts = stages + kStages * kStageW;     // [2][kRows][4]
  float* const ctr = pts + 2 * kRows * 4;            // [2][kMaxGroups][4]
  float* const w1c = ctr + 2 * kMaxGroups * 4;       // [kMaxWidth][4]
  float* const aff_a = w1c + kMaxWidth * 4;          // [3][kMaxWidth]
  float* const aff_c = aff_a + kAffine;
  int* const slots = reinterpret_cast<int*>(aff_c + kAffine);  // [kMaxGroups][kSlice]
  uint64_t* const full = reinterpret_cast<uint64_t*>(slots + kMaxGroups * kSlice);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = (warp % kRowWarps) * 16 + g;  // a thread's rows: row0, row0 + 8
  const int ncol0 = (warp / kRowWarps) * kNT * 8;
  const int F = L.f, C1 = L.c[0], C2 = L.c[1], C3 = L.c[2], K = L.k;
  const int in1 = 3 + F;

  // the period of steps a tile: each layer's slices, each slice's chunks
  const int nq0 = F / kChunk, nq1 = C1 / kChunk, nq2 = C2 / kChunk;
  const int ns0 = C1 / kSlice, ns1 = C2 / kSlice, ns2 = C3 / kSlice;
  const int first_layer = F ? 0 : 1;
  const int n12 = (F ? ns0 * nq0 : 0) + ns1 * nq1;  // steps before layer 3
  const int period = n12 + ns2 * nq2;
  const int my_tiles = (L.tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int total = my_tiles * period;
  auto chunks = [&](int layer) { return layer == 0 ? nq0 : layer == 1 ? nq1 : nq2; };
  auto slices = [&](int layer) { return layer == 0 ? ns0 : layer == 1 ? ns1 : ns2; };
  auto advance = [&](Cursor& c) {
    if (++c.q == chunks(c.layer)) {
      c.q = 0;
      if (++c.s == slices(c.layer)) {
        c.s = 0;
        c.layer = c.layer == 2 ? first_layer : c.layer + 1;
      }
    }
  };

  // prologue: the folded affine, layer 1's coordinate weights, empty slots
  // and the stages' barriers
  for (int l = 0; l < 3; ++l) {
    for (int c = tid; c < L.c[l]; c += kThreads) {
      const float a = __fmul_rn(L.scale[l][c], rsqrtf(__fadd_rn(L.var[l][c], L.eps)));
      aff_a[l * kMaxWidth + c] = a;
      aff_c[l * kMaxWidth + c] = __fsub_rn(L.bias[l][c], __fmul_rn(L.mean[l][c], a));
    }
  }
  for (int e = tid; e < C1 * 3; e += kThreads) {
    w1c[(e / 3) * 4 + e % 3] = L.w[0][(e / 3) * in1 + e % 3];
  }
  for (int e = tid; e < kMaxGroups * kSlice; e += kThreads) slots[e] = 0;
  if (tid < kStages) mbar_init(full + tid, 1);
  // the barriers' initialization, seen by the bulk copies (the async proxy)
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  // one bulk copy a step brings its stage (hi and lo, kStageW floats) into
  // the ring slot of the step kStages before, whose products are done
  auto fetch = [&](int step) {
    uint64_t* bar = full + (step & (kStages - 1));
    mbar_expect(bar, kStageW * 4);
    bulk_copy(stages + (step & (kStages - 1)) * kStageW,
              L.split + static_cast<size_t>(step % period) * kStageW, kStageW * 4, bar);
  };

  auto tile_info = [&](int local) {
    const int u = static_cast<int>(blockIdx.x) + local * gridDim.x;
    Tile tile;
    tile.cloud = u / L.tiles_per_cloud;
    tile.m0 = (u - tile.cloud * L.tiles_per_cloud) * L.groups;
    tile.gv = min(L.groups, L.m - tile.m0);
    tile.valid = tile.gv * K;
    return tile;
  };

  // the neighbour index of the row this lane copies (lane < kWarpRows)
  auto load_index = [&](const Tile& tile) {
    const int r = warp * kWarpRows + lane;
    const bool mine = lane < kWarpRows && r < tile.valid;
    const int p = mine ? __ldg(L.idx + (static_cast<size_t>(tile.cloud) * L.m + tile.m0) * K + r)
                       : 0;
    if (mine && static_cast<unsigned>(p) >= static_cast<unsigned>(L.n)) __trap();
    return p;
  };

  auto issue_gather = [&](const Tile& tile, int my_p, int buf) {
    float* x = buf ? act1 : act0;
    float* p = pts + buf * kRows * 4;
    for (int rr = 0; rr < kWarpRows; ++rr) {
      const int r = warp * kWarpRows + rr;
      const int src_p = __shfl_sync(0xffffffffu, my_p, rr);
      const bool ok = r < tile.valid;
      const size_t row = static_cast<size_t>(tile.cloud) * L.n + src_p;
      if (lane < 3) cp_async4(p + r * 4 + lane, L.xyz + row * 3 + lane, ok);
      for (int c = lane * 4; c < F; c += 128) cp_async16(x + r * S + c, L.feats + row * F + c, ok);
    }
    float* cn = ctr + buf * kMaxGroups * 4;
    if (tid < kMaxGroups * 3) {
      const int gg = tid / 3, comp = tid % 3;
      const bool ok = gg < tile.gv;
      cp_async4(cn + gg * 4 + comp,
                L.centers + (static_cast<size_t>(tile.cloud) * L.m + tile.m0 + (ok ? gg : 0)) * 3 +
                    comp,
                ok);
    }
    cp_async_commit();
  };

  float acc[kAcc], part[2][kAcc];  // the f32 sums; each promotion group's products
#pragma unroll
  for (int e = 0; e < kAcc; ++e) acc[e] = part[0][e] = part[1][e] = 0.f;

  Cursor cur{first_layer, 0, 0};
  Tile tile = tile_info(0), next = tile;
  if (total > 0) issue_gather(tile, load_index(tile), 0);
  if (tid == 0) {
    for (int st = 0; st < kStages - 1 && st < total; ++st) fetch(st);
  }

  // the next tile's rows are copied during layer 3's second step (its
  // indices loaded a step before), into layer 1's output region, free since
  // layer 2's last step; its first step waits for them
  const int gather_step = n12 + 1;
  const unsigned stage_addr = static_cast<unsigned>(__cvta_generic_to_shared(stages)) +
                              ncol0 * 16;  // this warpgroup's columns
  int grp[2] = {0, 0}, len[2] = {0, 0};  // a thread's rows' groups and runs
  bool head[2] = {false, false};
  // groups of a multiple of 16 rows hold a warp's 16 rows whole: its max
  // over them is a butterfly over the rows (the fast form of layer 3's max)
  const bool whole_warps = K % 16 == 0;
  const float inv_k = 1.f / K;  // r / k for r < 128, k <= 64, exact
  auto div_k = [&](int r) { return __float2int_rz((r + 0.5f) * inv_k); };
  int j = 0, buf = 0, lt = 0, next_p = 0;
  for (int i = 0; i < total; ++i) {
    // at the barrier every warpgroup's products of step i - 1 are done, so
    // its ring slot takes step i + kStages - 1; at a tile's first step its
    // gathered rows have landed
    if (j == 0) cp_async_wait<0>();
    __syncthreads();
    if (tid == 0 && i + kStages - 1 < total) fetch(i + kStages - 1);

    float* x = buf ? act1 : act0;  // gathered features, then layer 2's output
    float* y = buf ? act0 : act1;  // layer 1's output
    float* p = pts + buf * kRows * 4;
    if (j == 0) {
      // the tile's coordinates centered in place (rows past its groups stay
      // zeros), and each thread's rows' groups for layer 3's max
      const float* cn = ctr + buf * kMaxGroups * 4;
      for (int e = tid; e < kRows * 3; e += kThreads) {
        const int r = e / 3, d = e % 3;
        if (r < tile.valid) p[r * 4 + d] = __fsub_rn(p[r * 4 + d], cn[div_k(r) * 4 + d]);
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = row0 + 8 * hr;
        grp[hr] = r < tile.valid ? div_k(r) : -1;
        len[hr] = grp[hr] < 0 ? -1 : min(7 - g, (grp[hr] + 1) * K - 1 - r);
        head[hr] = grp[hr] >= 0 && (g == 0 || div_k(r - 1) != grp[hr]);
      }
      if (F == 0) {  // layer 1 on the coordinates alone, in FFMA
        __syncthreads();
        for (int c = tid % kSlice; c < C1; c += kSlice) {
          const float w0 = w1c[c * 4], w1 = w1c[c * 4 + 1], w2 = w1c[c * 4 + 2];
          const float a = aff_a[c], b = aff_c[c];
#pragma unroll 8
          for (int r = tid / kSlice; r < kRows; r += kThreads / kSlice) {
            const float4 pr = *reinterpret_cast<const float4*>(p + r * 4);
            const float v = fmaf(pr.z, w2, fmaf(pr.y, w1, __fmul_rn(pr.x, w0)));
            y[r * S + c] = relu(affine(a, v, b));
          }
        }
        __syncthreads();
      }
    }
    if (j == gather_step - 1 && lt + 1 < my_tiles) {
      next = tile_info(lt + 1);
      next_p = load_index(next);
    }

    // the step's products on the tensor cores, in two promotion groups of
    // two k-steps, each k-step lo*hi, hi*lo, hi*hi
    {
      const float* ar0 = (cur.layer == 1 ? y : x) + cur.q * kChunk + row0 * S;
      const float* ar1 = ar0 + 8 * S;
      uint32_t ahi[kChunk / 8][4], alo[kChunk / 8][4];  // the A fragments, split
#pragma unroll
      for (int kk = 0; kk < kChunk / 8; ++kk) {
        const int k0 = kk * 8 + t;
        split_x(ar0[k0], ahi[kk][0], alo[kk][0]);
        split_x(ar1[k0], ahi[kk][1], alo[kk][1]);
        split_x(ar0[k0 + 4], ahi[kk][2], alo[kk][2]);
        split_x(ar1[k0 + 4], ahi[kk][3], alo[kk][3]);
      }
      const unsigned hi = stage_addr + (i & (kStages - 1)) * kStageW * 4;
      const unsigned lo = hi + kSlice * kChunk * 4;
      mbar_wait(full + (i & (kStages - 1)), (i / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kChunk / 8; ++kk) {
        const unsigned off = kk * 2 * kSlice * 16;  // two k / 4 blocks a k-step
        float(&d)[kAcc] = part[kk / 2];
        wgmma_tf32(d, alo[kk], b_desc(hi + off), kk % 2);
        wgmma_tf32(d, ahi[kk], b_desc(lo + off), 1);
        wgmma_tf32(d, ahi[kk], b_desc(hi + off), 1);
        if (kk % 2) wgmma_commit();
      }
    }
    if (j == gather_step && lt + 1 < my_tiles) issue_gather(next, next_p, buf ^ 1);

    // each group's products added into the f32 sums, rounded to nearest
    wgmma_wait<1>();
    keep_acc(part[0]);
#pragma unroll
    for (int e = 0; e < kAcc; ++e) acc[e] = __fadd_rn(acc[e], part[0][e]);
    wgmma_wait<0>();
    keep_acc(part[1]);
#pragma unroll
    for (int e = 0; e < kAcc; ++e) acc[e] = __fadd_rn(acc[e], part[1][e]);

    if (cur.q == chunks(cur.layer) - 1) {  // the slice's epilogue
      const int layer = cur.layer, s = cur.s;
      const float* la = aff_a + layer * kMaxWidth + s * kSlice + ncol0;
      const float* lc = aff_c + layer * kMaxWidth + s * kSlice + ncol0;
      if (layer < 2) {
        float xs[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
        if (layer == 0) {  // the coordinate channels, in FFMA
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const float4 pr = *reinterpret_cast<const float4*>(p + (row0 + 8 * hr) * 4);
            xs[hr][0] = pr.x, xs[hr][1] = pr.y, xs[hr][2] = pr.z;
          }
        }
        float* dst = (layer == 0 ? y : x) + s * kSlice + ncol0;
#pragma unroll
        for (int jn = 0; jn < kNT; ++jn) {
          const int c = jn * 8 + 2 * t;
          const float2 a = *reinterpret_cast<const float2*>(la + c);
          const float2 b = *reinterpret_cast<const float2*>(lc + c);
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            float v0 = acc[jn * 4 + 2 * hr], v1 = acc[jn * 4 + 2 * hr + 1];
            if (layer == 0) {
              const float4 w0 = *reinterpret_cast<const float4*>(w1c + (s * kSlice + ncol0 + c) * 4);
              const float4 w1 = *reinterpret_cast<const float4*>(w1c + (s * kSlice + ncol0 + c + 1) * 4);
              v0 = __fadd_rn(v0, fmaf(xs[hr][2], w0.z, fmaf(xs[hr][1], w0.y, __fmul_rn(xs[hr][0], w0.x))));
              v1 = __fadd_rn(v1, fmaf(xs[hr][2], w1.z, fmaf(xs[hr][1], w1.y, __fmul_rn(xs[hr][0], w1.x))));
            }
            *reinterpret_cast<float2*>(dst + (row0 + 8 * hr) * S + c) =
                make_float2(relu(affine(a.x, v0, b.x)), relu(affine(a.y, v1, b.y)));
          }
        }
      } else if (whole_warps) {
        // the max over the warp's 16 rows, all of one group (or none): the
        // thread's two rows, then a butterfly over the 8 row pairs; lanes
        // 0-3 store the warp's columns, and after the barrier a thread a
        // (group, column) takes the max over the group's k / 16 warps
        float* pm = reinterpret_cast<float*>(slots);  // [row warp][kSlice]
#pragma unroll
        for (int jn = 0; jn < kNT; ++jn) {
          const int c = jn * 8 + 2 * t;
          const float2 a = *reinterpret_cast<const float2*>(la + c);
          const float2 b = *reinterpret_cast<const float2*>(lc + c);
          float v[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float lo = relu(affine(h ? a.y : a.x, acc[jn * 4 + h], h ? b.y : b.x));
            const float hi = relu(affine(h ? a.y : a.x, acc[jn * 4 + 2 + h], h ? b.y : b.x));
            v[h] = max_nan(lo, hi);
          }
#pragma unroll
          for (int d = 4; d < 32; d *= 2) {
#pragma unroll
            for (int h = 0; h < 2; ++h) v[h] = max_nan(v[h], __shfl_xor_sync(0xffffffffu, v[h], d));
          }
          if (g == 0) {
            *reinterpret_cast<float2*>(pm + (warp % kRowWarps) * kSlice + ncol0 + c) =
                make_float2(v[0], v[1]);
          }
        }
        __syncthreads();
        const int warps_a_group = K / 16;
        float* out = L.out + (static_cast<size_t>(tile.cloud) * L.m + tile.m0) * C3 + s * kSlice;
        for (int e = tid; e < tile.gv * kSlice; e += kThreads) {
          const int gg = e / kSlice, c = e % kSlice;
          const float* from = pm + gg * warps_a_group * kSlice + c;
          float v = from[0];
          for (int w = 1; w < warps_a_group; ++w) v = max_nan(v, from[w * kSlice]);
          out[static_cast<size_t>(gg) * C3 + c] = v;
        }
      } else {
        // the max over each group's rows: a segmented shuffle over the
        // warp's 8-row halves, then the heads' integer max in the slots
#pragma unroll
        for (int jn = 0; jn < kNT; ++jn) {
          const int c = jn * 8 + 2 * t;
          const float2 a = *reinterpret_cast<const float2*>(la + c);
          const float2 b = *reinterpret_cast<const float2*>(lc + c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hr = e >> 1;
            float v = relu(affine(e & 1 ? a.y : a.x, acc[jn * 4 + e], e & 1 ? b.y : b.x));
#pragma unroll
            for (int d = 1; d < 8; d *= 2) {
              const float o = __shfl_down_sync(0xffffffffu, v, 4 * d);
              if (d <= len[hr]) v = max_nan(v, o);
            }
            if (head[hr]) atomicMax(slots + grp[hr] * kSlice + ncol0 + c + (e & 1), max_key(v));
          }
        }
        __syncthreads();
        float* out = L.out + (static_cast<size_t>(tile.cloud) * L.m + tile.m0) * C3 + s * kSlice;
        for (int e = tid; e < tile.gv * kSlice; e += kThreads) {
          out[static_cast<size_t>(e / kSlice) * C3 + e % kSlice] = __int_as_float(slots[e]);
          slots[e] = 0;
        }
      }
#pragma unroll
      for (int e = 0; e < kAcc; ++e) acc[e] = 0.f;
    }

    advance(cur);
    if (++j == period) {
      j = 0;
      ++lt;
      buf ^= 1;
      tile = next;
    }
  }
  cp_async_wait<0>();
}

template <int kRows>
int launch(const Level& level, int sms, cudaStream_t stream) {
  const long long bytes = smem_floats(kRows, level.stride) * 4;
  if (bytes > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(sa_group_mlp_kernel<kRows>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  sa_group_mlp_split_kernel<<<period_steps(level.f, level.c[0], level.c[1], level.c[2]),
                              kThreads, 0, stream>>>(level);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = level.tiles < sms ? level.tiles : sms;
  sa_group_mlp_kernel<kRows><<<grid, kThreads, bytes, stream>>>(level);
  return static_cast<int>(cudaGetLastError());
}

bool width_ok(int c) { return c >= kSlice && c <= kMaxWidth && c % kSlice == 0; }

}  // namespace

// xyz (b, n, 3), feats (b, n, f) or null at f 0, centers (b, m, 3), idx (b,
// m, k) int32 in [0, n), layer l's weight (c_l, c_{l-1}) with c_0 = 3 + f,
// its BatchNorm's scale, bias, running mean and variance (c_l); out (b, m,
// c3); split: a scratch of (f c1 + c1 c2 + c2 c3) / 2048 stages of kStageW
// floats, 16-byte aligned; all f32 but idx, contiguous.  f 0 or a multiple
// of 64 up to 256; c1, c2, c3 multiples of 64 up to 256; 1 <= k <= 64; rows
// 128 or 64 (the rows a tile; its shared memory must fit); sms: the grid's
// most blocks.
// Returns a cudaError_t code (0 on success).
extern "C" int pcp_sa_group_mlp(const float* xyz, const float* feats, const float* centers,
                                const int* idx, const float* w1, const float* w2,
                                const float* w3, const float* s1, const float* s2,
                                const float* s3, const float* b1, const float* b2,
                                const float* b3, const float* mu1, const float* mu2,
                                const float* mu3, const float* v1, const float* v2,
                                const float* v3, float* out, float* split, int b, int n, int m,
                                int k, int f, int c1, int c2, int c3, int rows, int sms,
                                float eps, void* stream) {
  if (b == 0 || m == 0) return 0;
  const bool f_ok = f == 0 ? feats == nullptr : (width_ok(f) && feats != nullptr);
  if (b < 0 || n < 1 || m < 0 || k < 1 || k > kMaxK || !f_ok || !width_ok(c1) ||
      !width_ok(c2) || !width_ok(c3) || (rows != 128 && rows != 64) || sms < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Level level;
  level.xyz = xyz;
  level.feats = feats;
  level.centers = centers;
  level.idx = idx;
  level.w[0] = w1, level.w[1] = w2, level.w[2] = w3;
  level.scale[0] = s1, level.scale[1] = s2, level.scale[2] = s3;
  level.bias[0] = b1, level.bias[1] = b2, level.bias[2] = b3;
  level.mean[0] = mu1, level.mean[1] = mu2, level.mean[2] = mu3;
  level.var[0] = v1, level.var[1] = v2, level.var[2] = v3;
  level.out = out;
  level.split = split;
  level.eps = eps;
  level.n = n, level.m = m, level.k = k, level.f = f;
  level.c[0] = c1, level.c[1] = c2, level.c[2] = c3;
  level.groups = rows / k < kMaxGroups ? rows / k : kMaxGroups;
  level.tiles_per_cloud = (m + level.groups - 1) / level.groups;
  const long long tiles = static_cast<long long>(b) * level.tiles_per_cloud;
  if (tiles > (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);
  level.tiles = static_cast<int>(tiles);
  level.stride = act_stride(f, c1, c2);
  auto s = static_cast<cudaStream_t>(stream);
  return rows == 128 ? launch<128>(level, sms, s) : launch<64>(level, sms, s);
}

extern "C" const char* pcp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
