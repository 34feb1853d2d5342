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
// Both GEMMs run on the tensor cores in 3xTF32, which keeps f32 accuracy:
// each f32 operand v is split into hi = tf32(v) and lo = tf32(v - hi)
// (cvt.rna: round to nearest, ties away from zero, 10 mantissa bits; x's lo
// is cut toward zero instead), and each k-step adds lo*hi, then hi*lo, then
// hi*hi into f32 accumulators.  A tf32 product is exact in f32; the dropped
// lo*lo term and the rounding of lo are ~2^-21 of |x_k w_k| at most, far
// inside the GEMM-rounding bar the callers hold the kernels to (c_in ulps
// of sum |x_k w_k|).  The forward is 2 * b * n * c_in * c products (17
// GFLOP at 8 x 8192 x 128 -> 1024, three tensor-core products each), bound
// by tensor-core operations; the
// (b, n, c) pre-activation never reaches device memory, which is what the
// plain version pays for.  The backward's dense part x @ m is an eighth of
// that work and is bound by the bytes of x and dx.
//
// One main loop serves both, on Hopper's warpgroup MMA (wgmma m64n128k8,
// A from registers, B from shared memory): a block of two warpgroups owns a
// tile of 128 points x 128 output columns (64 points each) and walks a run
// of a cloud's point tiles.  The weight (w, or m for the backward) is split
// once a call into hi and lo arrays laid out as wgmma's no-swizzle K-major
// core matrices, 32 input channels a chunk; a block keeps its column tile's
// chunks resident in shared memory (c_in <= 128; wider ones stream through
// the same slots).  x streams through a 4-stage cp.async ring, and each
// thread splits its own x fragment in registers, so every x value is split
// once a block.  Each k-step is a commit group, so products stay in flight
// across stages; in the forward each warp copies the rows it reads, the
// warpgroups need no block barrier, and one's epilogue runs beside the
// other's products.  An infinite input has no 3xTF32 split (inf - inf is
// NaN), so it gives NaN.
//
// The max is exact f32 with the first index of the max, as jnp.argmax and
// torch.argmax give it; the TPU kernel's packing of the index into the low
// mantissa bits is not carried over, so n is not bounded by an index field.
// relu is monotone, so the kernels take the max of the affine output y and
// apply relu once at the end: a max above 0 is relu's max at the same first
// index, and a max <= 0 means relu is 0 at every point, so pooled 0 at
// argmax 0.  A thread holds rows g and g + 8 of its warp's 16 points of a tile (g =
// lane / 4) and visits them, tile after tile, in increasing order, so its
// running (value, index) best keeps the first of equal values with a strict
// >.  Where rows of different lanes, warps or runs meet, the full rule
// combines them: NaN first, then the larger value, then the smaller index
// (xor shuffles over lane bits 2-4, then the 8 warps through shared
// memory, then a second launch over the runs in run order).  A channel that
// is 0 at every point gives pooled 0, argmax 0.  NaN propagates as in
// torch.relu / amax / argmax: relu keeps a NaN, and the first NaN wins.  No
// atomics: the result is deterministic.
//
// The backward's winner term is sparse (one point per cloud and channel)
// and many channels may win one point; at each tile the block lists, in
// channel order, the channels whose winner lies in its 128 points, and the
// thread that holds a (point, column) of dx adds their coef * w rows in that
// order, so dx is deterministic too; the rows of a tile's first 16 winners
// are staged in shared memory while the tile's products run.  dk is a
// gather of winner rows summed over clouds in fixed order, written
// transposed (a row a channel), in the same launch that splits m.  An
// argmax outside [0, n) traps, so the next CUDA call raises instead of a
// wrong gradient coming back.
//
// The bf16 forms compute what the TPU kernels compute in bf16, the form in
// which the JAX package runs them: x and w (and, in the backward, m and
// each winner's coef) are bf16, each product is exact and the sums are
// f32, with one wgmma m64n128k16.f32.bf16.bf16 a k-step in place of three
// tf32 products.  The main loop is the same template: a bf16 stage holds
// 64 input channels, the same 128 bytes a row as f32's 32, so the x ring,
// the fragment addresses (a 32-bit word holds a tf32 value or a bf16 pair,
// and wgmma's register layout puts k pair 2t, 2t + 1 where tf32 has k t)
// and the weight chunks' core-matrix layout ([k / 8][column][k % 8], 128
// bytes a core matrix) keep their byte geometry.  The weight (or m,
// rounded to bf16 to nearest even) is relaid once a call, with no split.
// The forward's output is the f32 maximum with its first index, as in f32
// (the TPU kernel's packed argmax rounds the pooled value to 23 -
// ceil(log2 n) bits; this one does not).  The backward writes dx in bf16,
// rounded once from its f32 sum, and dk in f32.  The forward is bound by
// its 17 GFLOP at 989 TFLOP/s of dense bf16 (0.017 ms at 8 x 8192 x 128 ->
// 1024), the backward by the bytes of x and dx (33.6 MB, 0.010 ms).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kTileP = 128;    // points of a tile
constexpr int kTileN = 128;    // output columns of a tile (channels; dx columns)
constexpr int kChunk = 32;     // input channels a pipeline stage holds (f32)
constexpr int kStages = 4;
constexpr int kThreads = 256;  // two warpgroups of 64 points each
constexpr int kAcc = kTileN / 2;        // accumulators a thread: m64n128 f32
constexpr int kStrideK = kChunk + 4;    // x rows of a stage: bank 4g + t
constexpr int kStageX = kTileP * kStrideK;  // floats of an x stage
constexpr int kStageB = kTileN * kChunk;    // floats of a hi (or lo) chunk
constexpr int kSmemBytes = kStages * (kStageX + 2 * kStageB) * 4;  // 204,800
// a weight chunk in shared memory: [k / 4][column][k % 4], so a core matrix
// (8 columns x 4 k) is 128 contiguous bytes; the next 8 columns are 128 B
// on (the stride offset), the next 4 k 2,048 B (the leading offset)
constexpr int kCoreK = kTileN * 16;
constexpr int kMaxC = 4096;  // channels the backward's winner list holds
constexpr int kBatch = 16;   // winner rows the backward stages at a time
static_assert((kStages * kStageX * 4) % 128 == 0, "weight slots' alignment");

template <bool kBf16>
using Elem = typename std::conditional<kBf16, __nv_bfloat16, float>::type;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// the stage of this iteration has landed; with weights, they are visible
// to wgmma (the async proxy) once the block has passed the barrier after
__device__ __forceinline__ void cp_async_wait_stage(bool weights) {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
  if (weights) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo to ~2^-22 of |v|, both tf32 (the weights' split)
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(__fsub_rn(v, __uint_as_float(hi)));
}

// the split of an x fragment, in four integer and float instructions: hi
// is cvt.rna's for every number and infinity (the carry of the half-ulp
// add may reach the exponent), lo is v - hi cut to tf32 toward zero, so v
// = hi + lo to ~2^-21 of |v|.  A NaN gives an arbitrary hi and a NaN lo,
// so its products are NaN all the same.
__device__ __forceinline__ void split_x(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(v, __uint_as_float(hi))) & 0xffffe000u;
}

// shared-memory matrix descriptor of a no-swizzle K-major wgmma operand
__device__ __forceinline__ uint64_t weight_desc(unsigned addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(kCoreK >> 4) << 16) |
         (static_cast<uint64_t>(128 >> 4) << 32);
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// ties reads and writes of the accumulators to this point (after a wait):
// the compiler does not move them across it
__device__ __forceinline__ void keep(float (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128 of the warpgroup) += a (64 x 8, registers) * b (8 x 128,
// shared memory, K-major), tf32 in, f32 accumulators; scale_d 0 overwrites
__device__ __forceinline__ void wgmma_tf32(float (&d)[kAcc], const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// the same with a (64 x 16, registers: bf16 pairs) and b (16 x 128) in bf16
__device__ __forceinline__ void wgmma_bf16(float (&d)[kAcc], const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// the weight operand (n_cols x k, element (j, k) at src[j * stride_n + k *
// stride_k]) split into hi and lo, each laid out as consecutive column
// tiles of 128 x k in chunks of 32 k as a stage holds them; zero past n_cols
__device__ __forceinline__ void split_operand(const float* __restrict__ src,
                                              long long stride_n,
                                              long long stride_k, int n_cols,
                                              int k, float* __restrict__ hi,
                                              float* __restrict__ lo,
                                              int blocks) {
  const long long total = (long long)((n_cols + kTileN - 1) / kTileN) * kTileN * k;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)blocks * blockDim.x) {
    const long long q = i / 4;  // (column tile, k / 4, column in the tile)
    const int jj = q % kTileN;
    const long long r = q / kTileN;
    const int kk = (r % (k / 4)) * 4 + i % 4;
    const int j = (r / (k / 4)) * kTileN + jj;
    const float v = j < n_cols ? src[j * stride_n + kk * stride_k] : 0.0f;
    uint32_t h, l;
    split(v, h, l);
    hi[i] = __uint_as_float(h);
    lo[i] = __uint_as_float(l);
  }
}

__global__ void pooled_forward_split_kernel(const float* __restrict__ w,
                                            int c, int c_in,
                                            float* __restrict__ hi,
                                            float* __restrict__ lo) {
  split_operand(w, c_in, 1, c, c_in, hi, lo, gridDim.x);
}

__device__ __forceinline__ __nv_bfloat16 to_bf16(float v) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ __nv_bfloat16 to_bf16(__nv_bfloat16 v) { return v; }
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// the bf16 forms' weight operand, laid out as split_operand lays out hi,
// with 8 k a core-matrix row in place of 4; an f32 source rounds to bf16
template <typename Src>
__device__ __forceinline__ void relayout_bf16(const Src* __restrict__ src,
                                              long long stride_n,
                                              long long stride_k, int n_cols,
                                              int k, __nv_bfloat16* __restrict__ out,
                                              int blocks) {
  const long long total = (long long)((n_cols + kTileN - 1) / kTileN) * kTileN * k;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)blocks * blockDim.x) {
    const long long q = i / 8;  // (column tile, k / 8, column in the tile)
    const int jj = q % kTileN;
    const long long r = q / kTileN;
    const int kk = (r % (k / 8)) * 8 + i % 8;
    const int j = (r / (k / 8)) * kTileN + jj;
    out[i] = j < n_cols ? to_bf16(src[j * stride_n + kk * stride_k])
                        : __float2bfloat16_rn(0.0f);
  }
}

__global__ void pooled_forward_relayout_kernel(const __nv_bfloat16* __restrict__ w,
                                               int c, int c_in,
                                               __nv_bfloat16* __restrict__ out) {
  relayout_bf16(w, c_in, 1, c, c_in, out, gridDim.x);
}

// The walk of a block over its run of point tiles: the flattened (tile,
// k-chunk) sequence streams through a ring of x stages, and epilogue(tile,
// d) runs after each tile's last chunk (uniformly in the block; it may sync
// only with kBlockSync).  Each warp copies and reads its own 16 rows of x,
// so without kBlockSync the two warpgroups drift apart once the resident
// weights are in, and one's epilogue runs beside the other's products.
// w_hi / w_lo point at the block's column tile of the split weight (kBf16:
// w_hi at its bf16 relayout, w_lo unused).  Its chunks stay resident in the
// block's 4 weight slots when they fit (c_in <= 128 in f32, 256 in bf16),
// and otherwise stream through them beside x.
template <bool kBf16, bool kBlockSync, typename Epilogue>
__device__ __forceinline__ void run_tiles(const Elem<kBf16>* __restrict__ xc,
                                          const float* __restrict__ w_hi,
                                          const float* __restrict__ w_lo,
                                          int c_in, int p_begin, int p_end,
                                          float* smem, Epilogue epilogue) {
  constexpr int kK = kBf16 ? 2 * kChunk : kChunk;  // 128 bytes of an x row
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int chunks = c_in / kK;
  const int tiles = (p_end - p_begin + kTileP - 1) / kTileP;
  const int total = tiles * chunks;
  const bool resident = chunks <= kStages;
  float* slots = smem + kStages * kStageX;  // weight chunks, hi then lo

  auto fetch = [&](int it) {
    if (it < total) {
      float* xs = smem + (it % kStages) * kStageX;
      const int p0 = p_begin + (it / chunks) * kTileP;
      const int k0 = (it % chunks) * kK;
      // without kBlockSync each warp copies the 16 rows it reads, so x
      // needs no block barrier; with it the block's threads copy the rows
      // in order (measured faster for the backward).  A row of a stage is
      // 8 copies of 16 bytes.
#pragma unroll
      for (int i = 0; i < 16 * 8 / 32; ++i) {
        const int f = kBlockSync ? threadIdx.x + i * kThreads : lane + i * 32;
        const int r = (kBlockSync ? 0 : 16 * warp) + f / 8;
        const int q = f % 8;
        const bool ok = p0 + r < p_end;
        cp_async16(xs + r * kStrideK + 4 * q,
                   xc + (ok ? (long long)(p0 + r) * c_in + k0 + q * (kK / 8) : 0), ok);
      }
      if (!resident || it < chunks) {  // resident: slot it holds chunk it
        float* bs = slots + (it % kStages) * 2 * kStageB;
        const long long b0 = (long long)(it % chunks) * kStageB;
#pragma unroll
        for (int i = 0; i < kStageB / 4 / kThreads; ++i) {
          const int f = (threadIdx.x + i * kThreads) * 4;
          cp_async16(bs + f, w_hi + b0 + f, true);
          if (!kBf16) cp_async16(bs + kStageB + f, w_lo + b0 + f, true);
        }
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) fetch(s);

  // this thread's x rows: 16 * warp + g (+ 8) of the tile
  const int row = 16 * warp + g;
  float d[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) d[i] = 0.0f;
  for (int it = 0; it < total; ++it) {
    const bool weights = !resident || it < chunks;
    cp_async_wait_stage(weights);
    // stage it landed, and (streaming) every wgmma on the slot refilled
    // below is done; past the resident weights' copies a warp need wait
    // only for its own rows (kBlockSync keeps the block in step: measured
    // faster for the backward, whose epilogue syncs the block anyway)
    if (kBlockSync || weights) {
      __syncthreads();
    } else {
      __syncwarp();
    }
    fetch(it + kStages - 1);
    const float* xs = smem + (it % kStages) * kStageX;
    const float* bs = slots + (resident ? it % chunks : it % kStages) * 2 * kStageB;
    const unsigned b_hi = static_cast<unsigned>(__cvta_generic_to_shared(bs));
    const unsigned b_lo = b_hi + kStageB * 4;
    const bool first = it % chunks == 0;
    const bool last = it % chunks == chunks - 1;
    // one commit group a k-step (8 k in f32, 16 in bf16: 32 bytes of a row
    // either way); a k-step's fragment registers are rewritten only once
    // its group of the chunk before is done, so up to three k-steps of
    // products stay in flight across chunks
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* p = xs + row * kStrideK + kk * 8 + t;
      const float v[4] = {p[0], p[8 * kStrideK], p[4], p[8 * kStrideK + 4]};
      const unsigned step = kk * 2 * kCoreK;
      wgmma_wait<3>();
      if constexpr (kBf16) {  // the words are the bf16 pairs wgmma takes
        const uint32_t a[4] = {__float_as_uint(v[0]), __float_as_uint(v[1]),
                               __float_as_uint(v[2]), __float_as_uint(v[3])};
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        wgmma_bf16(d, a, weight_desc(b_hi + step), !(first && kk == 0));
      } else {
        uint32_t ah[4], al[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split_x(v[i], ah[i], al[i]);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        wgmma_tf32(d, al, weight_desc(b_hi + step), !(first && kk == 0));
        wgmma_tf32(d, ah, weight_desc(b_lo + step), 1);
        wgmma_tf32(d, ah, weight_desc(b_hi + step), 1);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    }
    if (last || !resident) wgmma_wait<0>();
    if (last) {
      keep(d);
      epilogue(it / chunks, d);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// (v, i) beats (bv, bi): NaN above every number, then the larger value,
// then, on a tie (two NaNs included), the smaller index
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn || bn) return vn && (!bn || i < bi);
  return v > bv || (v == bv && i < bi);
}

// v beats bv, a value met later (a later point or run): ties keep bv.
// !(v <= bv) is v > bv or v NaN; bv == bv keeps a NaN best
__device__ __forceinline__ bool beats_earlier(float v, float bv) {
  return !(v <= bv) && bv == bv;
}

// grid (ceil(c / 128), runs, b): one block per channel tile, run of point
// tiles, cloud; writes the run's (value, index) best per channel.  The
// accumulator d[4j + 2h + e] is row 16 * warp + 8h + g, column 8j + 2t + e.
// w_split: the split weight (f32: hi, then lo) or its bf16 relayout.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 1)
    pooled_forward_kernel(const Elem<kBf16>* __restrict__ x,
                          const float* __restrict__ w_split,
                          const float* __restrict__ a,
                          const float* __restrict__ c_row,
                          float* __restrict__ part_v, int* __restrict__ part_i,
                          int n, int c_in, int c, int tiles_per_run) {
  extern __shared__ __align__(128) float smem[];
  __shared__ float red_v[kThreads / 32][kTileN];
  __shared__ int red_i[kThreads / 32][kTileN];
  __shared__ float a_s[kTileN], c_s[kTileN];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ch0 = blockIdx.x * kTileN;
  const int run = blockIdx.y;
  const int cloud = blockIdx.z;
  const int p_begin = run * tiles_per_run * kTileP;
  const int p_end = min(n, p_begin + tiles_per_run * kTileP);
  if (threadIdx.x < kTileN) {  // read after the walk's first barrier
    const int ch = ch0 + threadIdx.x;
    a_s[threadIdx.x] = ch < c ? a[ch] : 0.0f;
    c_s[threadIdx.x] = ch < c ? c_row[ch] : 0.0f;
  }

  // this thread's 32 columns 8j + 2t + e, at 2j + e
  float best_v[kAcc / 2];
  int best_i[kAcc / 2];
#pragma unroll
  for (int j = 0; j < kAcc / 2; ++j) {
    best_v[j] = -INFINITY;
    best_i[j] = 0;
  }

  // words of a column tile of the operand, and of the whole hi array
  constexpr int kWords = sizeof(Elem<kBf16>) / 2;  // 2 x words an element
  const long long split_size =
      (long long)((c + kTileN - 1) / kTileN) * kTileN * c_in * kWords / 2;
  const float* w_hi = w_split + (long long)blockIdx.x * kTileN * c_in * kWords / 2;
  run_tiles<kBf16, false>(x + (long long)cloud * n * c_in, w_hi, w_hi + split_size, c_in,
            p_begin, p_end, smem, [&](int tile, float (&d)[kAcc]) {
    // the affine in the plain version's order (no FMA contraction), then
    // the running max over this thread's two rows in increasing order
    const int p = p_begin + tile * kTileP + 16 * warp + g;
    const bool row_ok[2] = {p < p_end, p + 8 < p_end};
#pragma unroll
    for (int j = 0; j < kTileN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t + e;
        const float av = a_s[col], cv = c_s[col];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float y = __fadd_rn(__fmul_rn(d[4 * j + 2 * h + e], av), cv);
          if (row_ok[h] && beats_earlier(y, best_v[2 * j + e])) {
            best_v[2 * j + e] = y;
            best_i[2 * j + e] = p + 8 * h;
          }
        }
      }
    }
  });

  // the 8 lanes of a column (lane bits 2-4), then the 8 warps
#pragma unroll
  for (int j = 0; j < kAcc / 2; ++j) {
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best_v[j], off);
      const int oi = __shfl_xor_sync(0xffffffffu, best_i[j], off);
      if (better(ov, oi, best_v[j], best_i[j])) {
        best_v[j] = ov;
        best_i[j] = oi;
      }
    }
    if (g == 0) {
      const int col = 8 * (j / 2) + 2 * t + j % 2;
      red_v[warp][col] = best_v[j];
      red_i[warp][col] = best_i[j];
    }
  }
  __syncthreads();
  if (threadIdx.x < kTileN && ch0 + (int)threadIdx.x < c) {
    const int col = threadIdx.x;
    float bv = red_v[0][col];
    int bi = red_i[0][col];
    for (int wi = 1; wi < kThreads / 32; ++wi) {
      if (better(red_v[wi][col], red_i[wi][col], bv, bi)) {
        bv = red_v[wi][col];
        bi = red_i[wi][col];
      }
    }
    const long long o = ((long long)cloud * gridDim.y + run) * c + ch0 + col;
    part_v[o] = bv;
    part_i[o] = bi;
  }
}

// one thread per (cloud, channel): the runs in order, so a tie keeps the
// lower run's (lower) index; then relu: a max <= 0 is pooled 0 at argmax 0
__global__ void pooled_combine_kernel(const float* __restrict__ part_v,
                                      const int* __restrict__ part_i,
                                      float* __restrict__ pooled,
                                      int* __restrict__ argmax, int b, int c,
                                      int runs) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)b * c) return;
  const long long cloud = t / c;
  const int ch = t % c;
  float bv = -INFINITY;
  int bi = 0;
  for (int s = 0; s < runs; ++s) {
    const long long o = (cloud * runs + s) * c + ch;
    if (beats_earlier(part_v[o], bv)) {
      bv = part_v[o];
      bi = part_i[o];
    }
  }
  if (bv <= 0.0f) {  // not NaN
    bv = 0.0f;
    bi = 0;
  }
  pooled[t] = bv;
  argmax[t] = bi;
}

// a coefficient as the bf16 forms take it: rounded to bf16
__device__ __forceinline__ float coef_of(float v, bool bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// two neighbouring elements of a staged w row, as f32
__device__ __forceinline__ float2 pair_of(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair_of(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// dx's two neighbouring columns, in its type (bf16: rounded to nearest even)
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// grid (ceil(c_in / 128), runs, b): one block per 128 columns of dx, run of
// point tiles, cloud.  m_split: m split (f32: hi, then lo) or its bf16
// relayout.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 1)
    pooled_backward_dx_kernel(const Elem<kBf16>* __restrict__ x,
                              const Elem<kBf16>* __restrict__ w,
                              const float* __restrict__ coef,
                              const int* __restrict__ argmax,
                              const float* __restrict__ m_split,
                              const float* __restrict__ row,
                              Elem<kBf16>* __restrict__ dx, int n, int c_in, int c,
                              int tiles_per_run) {
  extern __shared__ __align__(128) float smem[];
  __shared__ int win[kMaxC];  // (point - p0) << 16 | channel, channel order
  __shared__ int warp_count[kThreads / 32];
  // their w columns
  __shared__ __align__(16) unsigned char win_bytes[kBatch * kTileN * sizeof(Elem<kBf16>)];
  auto win_w = reinterpret_cast<Elem<kBf16>(*)[kTileN]>(win_bytes);
  __shared__ float win_coef[kBatch];
  __shared__ __align__(8) float row_s[kTileN];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int j0 = blockIdx.x * kTileN;
  const int run = blockIdx.y;
  const int cloud = blockIdx.z;
  const int p_begin = run * tiles_per_run * kTileP;
  const int p_end = min(n, p_begin + tiles_per_run * kTileP);
  const int* am = argmax + (long long)cloud * c;
  const float* cf = coef + (long long)cloud * c;

  // this thread's contiguous run of channels and their winners, read once
  // (L1 holds little beside 229 KB of shared memory, and dx's stores would
  // evict them), checked once: an argmax outside [0, n) traps
  const int span = (c + kThreads - 1) / kThreads;
  const int cb = threadIdx.x * span;
  int my_p[kMaxC / kThreads];
#pragma unroll
  for (int i = 0; i < kMaxC / kThreads; ++i) {
    my_p[i] = -1;
    if (i < span && cb + i < c) {
      my_p[i] = am[cb + i];
      if (my_p[i] < 0 || my_p[i] >= n) __trap();
    }
  }
  if (threadIdx.x < kTileN) {
    const int col = j0 + threadIdx.x;
    row_s[threadIdx.x] = col < c_in ? row[col] : 0.0f;
  }
  // the channels whose winner lies in [p0, p0 + 128), in channel order, into
  // win; returns their count.  Each thread counts its run of channels, then
  // an exclusive scan of the counts places each run.
  auto list_winners = [&](int p0) {
    int count = 0;
#pragma unroll
    for (int i = 0; i < kMaxC / kThreads; ++i) {
      count += (my_p[i] >= p0 && my_p[i] < p0 + kTileP);
    }
    int incl = count;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += o;
    }
    __syncthreads();  // the last readers of win and warp_count are done
    if (lane == 31) warp_count[warp] = incl;
    __syncthreads();
    int offset = incl - count;
    int total = 0;
    for (int wi = 0; wi < kThreads / 32; ++wi) {
      if (wi < warp) offset += warp_count[wi];
      total += warp_count[wi];
    }
#pragma unroll
    for (int i = 0; i < kMaxC / kThreads; ++i) {
      if (my_p[i] >= p0 && my_p[i] < p0 + kTileP) {
        win[offset++] = ((my_p[i] - p0) << 16) | (cb + i);
      }
    }
    __syncthreads();
    return total;
  };
  // cp.async the w columns and coefficients of winners e0 .. e0 + rows, a
  // row in 16-byte copies of kPer elements
  constexpr int kPer = 16 / sizeof(Elem<kBf16>);
  constexpr int kPieces = kTileN / kPer;  // copies a row
  auto stage_rows = [&](int e0, int rows) {
#pragma unroll
    for (int i = 0; i < kBatch * kPieces / kThreads; ++i) {
      const int f = threadIdx.x + i * kThreads;
      const int e = f / kPieces;
      const int col = (f % kPieces) * kPer;
      if (e < rows) {
        const int ch = win[e0 + e] & 0xffff;
        const bool ok = j0 + col < c_in;
        cp_async16(&win_w[e][col], w + (ok ? (long long)ch * c_in + j0 + col : 0), ok);
      }
    }
    if ((int)threadIdx.x < rows) {
      const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(&win_coef[threadIdx.x]));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                   "l"(cf + (win[e0 + threadIdx.x] & 0xffff))
                   : "memory");
    }
  };
  // the staged rows' terms, by the four threads that hold each row's point
  auto add_rows = [&](float (&d)[kAcc], int e0, int rows) {
    for (int e = 0; e < rows; ++e) {
      const int lp = win[e0 + e] >> 16;  // row 16 * warp + 8h + g of the tile
      if (lp / 16 != warp || lp % 8 != g) continue;
      const float s = coef_of(win_coef[e], kBf16);
      const bool upper = lp % 16 >= 8;
#pragma unroll
      for (int j = 0; j < kTileN / 8; ++j) {
        const float2 wv = pair_of(&win_w[e][8 * j + 2 * t]);
        if (upper) {
          d[4 * j + 2] = fmaf(s, wv.x, d[4 * j + 2]);
          d[4 * j + 3] = fmaf(s, wv.y, d[4 * j + 3]);
        } else {
          d[4 * j] = fmaf(s, wv.x, d[4 * j]);
          d[4 * j + 1] = fmaf(s, wv.y, d[4 * j + 1]);
        }
      }
    }
  };

  // a tile's winners are listed, and their first 16 rows staged, before
  // its first stage's copies are committed (the first tile's here, a later
  // one's at the end of the tile before), so the rows join that group
  int winners = list_winners(p_begin);
  stage_rows(0, min(kBatch, winners));
  const int tiles = (p_end - p_begin + kTileP - 1) / kTileP;
  constexpr int kWords = sizeof(Elem<kBf16>) / 2;  // 2 x words an element
  const long long split_size =
      (long long)((c_in + kTileN - 1) / kTileN) * kTileN * c_in * kWords / 2;
  const float* m_hi = m_split + (long long)blockIdx.x * kTileN * c_in * kWords / 2;
  run_tiles<kBf16, true>(x + (long long)cloud * n * c_in, m_hi, m_hi + split_size, c_in,
            p_begin, p_end, smem, [&](int tile, float (&d)[kAcc]) {
    const int p0 = p_begin + tile * kTileP;
    // the staged rows' copies joined the tile's first stage group, which
    // the last stage's wait and block barrier covered (with 4 stages a
    // tile; with fewer, wait for all here)
    if (c_in / kChunk < kStages) {
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
    }
    // ---- x @ m + row, then the winners' rows in channel order
#pragma unroll
    for (int j = 0; j < kTileN / 8; ++j) {
      const float2 rv = *reinterpret_cast<const float2*>(&row_s[8 * j + 2 * t]);
      d[4 * j] += rv.x;
      d[4 * j + 1] += rv.y;
      d[4 * j + 2] += rv.x;
      d[4 * j + 3] += rv.y;
    }
    add_rows(d, 0, min(kBatch, winners));
    // more than 16 winners: the rest 16 at a time, each a round trip
    for (int e0 = kBatch; e0 < winners; e0 += kBatch) {
      const int rows = min(kBatch, winners - e0);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kBatch * kPieces / kThreads; ++i) {
        const int f = threadIdx.x + i * kThreads;
        const int e = f / kPieces;
        const int col = (f % kPieces) * kPer;
        if (e < rows) {
          const int ch = win[e0 + e] & 0xffff;
          *reinterpret_cast<uint4*>(&win_w[e][col]) = j0 + col < c_in
              ? *reinterpret_cast<const uint4*>(w + (long long)ch * c_in + j0 + col)
              : make_uint4(0u, 0u, 0u, 0u);
        }
      }
      if ((int)threadIdx.x < rows) win_coef[threadIdx.x] = cf[win[e0 + threadIdx.x] & 0xffff];
      __syncthreads();
      add_rows(d, e0, rows);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + 16 * warp + 8 * h + g;
      if (p < p_end) {
#pragma unroll
        for (int j = 0; j < kTileN / 8; ++j) {
          const int col = j0 + 8 * j + 2 * t;
          if (col < c_in) {
            store_pair(dx + ((long long)cloud * n + p) * c_in + col,
                       d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
          }
        }
      }
    }
    if (tile + 1 < tiles) {
      winners = list_winners(p0 + kTileP);
      stage_rows(0, min(kBatch, winners));
    }
  });
}

// The backward's first launch: blocks [0, split_blocks) split m into hi
// and lo for the dx kernel, and block split_blocks + ch gathers channel
// ch's row of dk^T (threads over the input channels d) from the winners;
// the winners and coefficients of 128 clouds at a time come through
// shared memory in one round trip, so a thread's x loads do not wait on
// each other, and the clouds are summed in order.  kBf16: m is rounded to
// bf16 and relaid at m_hi (m_lo unused), and each coef rounds to bf16.
template <bool kBf16>
__global__ void pooled_backward_prep_kernel(const float* __restrict__ m,
                                            float* __restrict__ m_hi,
                                            float* __restrict__ m_lo,
                                            int split_blocks,
                                            const Elem<kBf16>* __restrict__ x,
                                            const float* __restrict__ coef,
                                            const int* __restrict__ argmax,
                                            float* __restrict__ dk_t, int b,
                                            int n, int c_in, int c) {
  if ((int)blockIdx.x < split_blocks) {  // column j of m is k-major
    if constexpr (kBf16) {
      relayout_bf16(m, 1, c_in, c_in, c_in, reinterpret_cast<__nv_bfloat16*>(m_hi),
                    split_blocks);
    } else {
      split_operand(m, 1, c_in, c_in, c_in, m_hi, m_lo, split_blocks);
    }
    return;
  }
  __shared__ int ps[128];
  __shared__ float cs[128];
  const int ch = blockIdx.x - split_blocks;
  for (int d0 = 0; d0 < c_in; d0 += blockDim.x) {
    const int d = d0 + threadIdx.x;
    float acc = 0.0f;
    for (int b0 = 0; b0 < b; b0 += 128) {
      __syncthreads();  // the last round's reads are done
      if (threadIdx.x < 128 && b0 + (int)threadIdx.x < b) {
        const long long o = (long long)(b0 + threadIdx.x) * c + ch;
        const int p = argmax[o];
        if (p < 0 || p >= n) __trap();  // argmax outside [0, n)
        ps[threadIdx.x] = p;
        cs[threadIdx.x] = coef_of(coef[o], kBf16);
      }
      __syncthreads();
      if (d < c_in) {
        const int clouds = min(128, b - b0);
#pragma unroll 8
        for (int i = 0; i < clouds; ++i) {
          acc = fmaf(cs[i], to_f32(x[((long long)(b0 + i) * n + ps[i]) * c_in + d]), acc);
        }
      }
    }
    if (d < c_in) dk_t[(long long)ch * c_in + d] = acc;
  }
}

bool shapes_ok(long long b, long long n, long long c_in, long long c) {
  return b > 0 && n > 0 && b <= 65535 && n <= 0x7fffffffLL / 2 &&
         c_in > 0 && c_in % 64 == 0 && c > 0 && c % 64 == 0 &&
         c <= kMaxC && b * n * c_in < (1LL << 40);
}

// runs of tiles_per_run point tiles cover the cloud's tiles, none empty
bool runs_ok(int n, int runs, int tiles_per_run) {
  const long long tiles = (n + kTileP - 1) / kTileP;
  return runs >= 1 && runs <= 65535 && tiles_per_run >= 1 &&
         (long long)(runs - 1) * tiles_per_run < tiles &&
         (long long)runs * tiles_per_run >= tiles;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSmemBytes);
}

// blocks of 256 threads for a split of total elements
int split_blocks(long long total) {
  return static_cast<int>(std::min<long long>((total + 255) / 256, 4096));
}

// the forward's launches: the weight's split (or bf16 relayout), the main
// kernel, the combine over runs
template <bool kBf16>
int forward(const Elem<kBf16>* x, const Elem<kBf16>* w, float* w_split,
            const float* a, const float* c_row, float* part_v, int* part_i,
            float* pooled, int* argmax, int b, int n, int c_in, int c, int runs,
            int tiles_per_run, void* stream) {
  if (!shapes_ok(b, n, c_in, c) || !runs_ok(n, runs, tiles_per_run)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static const cudaError_t attr = allow_smem(pooled_forward_kernel<kBf16>);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long split_size = (long long)((c + kTileN - 1) / kTileN) * kTileN * c_in;
  if constexpr (kBf16) {
    pooled_forward_relayout_kernel<<<split_blocks(split_size), 256, 0, s>>>(
        w, c, c_in, reinterpret_cast<__nv_bfloat16*>(w_split));
  } else {
    pooled_forward_split_kernel<<<split_blocks(split_size), 256, 0, s>>>(
        w, c, c_in, w_split, w_split + split_size);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pooled_forward_kernel<kBf16><<<dim3((c + kTileN - 1) / kTileN, runs, b), kThreads,
                                 kSmemBytes, s>>>(x, w_split, a, c_row, part_v,
                                                  part_i, n, c_in, c, tiles_per_run);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long outputs = (long long)b * c;
  pooled_combine_kernel<<<(unsigned)((outputs + 255) / 256), 256, 0, s>>>(
      part_v, part_i, pooled, argmax, b, c, runs);
  return static_cast<int>(cudaGetLastError());
}

// the backward's launches: m's split (or bf16 relayout) beside dk, then dx
template <bool kBf16>
int backward(const Elem<kBf16>* x, const Elem<kBf16>* w, const float* coef,
             const int* argmax, const float* m, float* m_split, const float* row,
             Elem<kBf16>* dx, float* dk_t, int b, int n, int c_in, int c, int runs,
             int tiles_per_run, void* stream) {
  if (!shapes_ok(b, n, c_in, c) || !runs_ok(n, runs, tiles_per_run)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static const cudaError_t attr = allow_smem(pooled_backward_dx_kernel<kBf16>);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long split_size =
      (long long)((c_in + kTileN - 1) / kTileN) * kTileN * c_in;
  const int blocks = split_blocks(split_size) * 2;  // of 128 threads
  pooled_backward_prep_kernel<kBf16><<<blocks + c, 128, 0, s>>>(
      m, m_split, m_split + split_size, blocks, x, coef, argmax, dk_t, b, n,
      c_in, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pooled_backward_dx_kernel<kBf16><<<dim3((c_in + kTileN - 1) / kTileN, runs, b),
                                     kThreads, kSmemBytes, s>>>(
      x, w, coef, argmax, m_split, row, dx, n, c_in, c, tiles_per_run);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (b, n, c_in), w (c, c_in), a and c_row (c,) f32; w_split (2,
// ceil(c / 128) * 128 * c_in) f32 scratch; part_v/part_i (b, runs, c)
// scratch; pooled (b, c) f32, argmax (b, c) int32.  Run r holds the point
// tiles [r * tiles_per_run, (r + 1) * tiles_per_run) of 128 points.
// Returns a cudaError_t code (0 on success).
extern "C" int pcp_pooled_chain_forward(const float* x, const float* w,
                                        float* w_split, const float* a,
                                        const float* c_row, float* part_v,
                                        int* part_i, float* pooled,
                                        int* argmax, int b, int n, int c_in,
                                        int c, int runs, int tiles_per_run,
                                        void* stream) {
  return forward<false>(x, w, w_split, a, c_row, part_v, part_i, pooled, argmax,
                        b, n, c_in, c, runs, tiles_per_run, stream);
}

// The bf16 form: x (b, n, c_in) and w (c, c_in) bf16; w_split scratch of
// ceil(c / 128) * 128 * c_in bf16 (16-byte aligned); the rest as above.
extern "C" int pcp_pooled_chain_forward_bf16(const __nv_bfloat16* x,
                                             const __nv_bfloat16* w,
                                             float* w_split, const float* a,
                                             const float* c_row, float* part_v,
                                             int* part_i, float* pooled,
                                             int* argmax, int b, int n,
                                             int c_in, int c, int runs,
                                             int tiles_per_run, void* stream) {
  return forward<true>(x, w, w_split, a, c_row, part_v, part_i, pooled, argmax,
                       b, n, c_in, c, runs, tiles_per_run, stream);
}

// x (b, n, c_in), w (c, c_in), coef (b, c) f32, argmax (b, c) int32,
// m (c_in, c_in), row (c_in,) f32; m_split (2, ceil(c_in / 128) * 128 *
// c_in) f32 scratch; dx (b, n, c_in), dk_t (c, c_in) f32 (dk transposed).
// Runs as in the forward.  Returns a cudaError_t code (0 on success).
extern "C" int pcp_pooled_chain_backward(const float* x, const float* w,
                                         const float* coef, const int* argmax,
                                         const float* m, float* m_split,
                                         const float* row, float* dx,
                                         float* dk_t, int b, int n, int c_in,
                                         int c, int runs, int tiles_per_run,
                                         void* stream) {
  return backward<false>(x, w, coef, argmax, m, m_split, row, dx, dk_t, b, n,
                         c_in, c, runs, tiles_per_run, stream);
}

// The bf16 form: x (b, n, c_in), w (c, c_in) and dx bf16; m f32, rounded to
// bf16 into m_split (ceil(c_in / 128) * 128 * c_in bf16); coef f32, each
// rounded to bf16 where it multiplies; dk_t f32.
extern "C" int pcp_pooled_chain_backward_bf16(const __nv_bfloat16* x,
                                              const __nv_bfloat16* w,
                                              const float* coef,
                                              const int* argmax, const float* m,
                                              float* m_split, const float* row,
                                              __nv_bfloat16* dx, float* dk_t,
                                              int b, int n, int c_in, int c,
                                              int runs, int tiles_per_run,
                                              void* stream) {
  return backward<true>(x, w, coef, argmax, m, m_split, row, dx, dk_t, b, n,
                        c_in, c, runs, tiles_per_run, stream);
}

extern "C" const char* pcp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
