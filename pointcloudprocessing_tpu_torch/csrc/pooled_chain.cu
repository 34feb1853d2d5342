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
// The f32 forms run both GEMMs on the tensor cores in 3xTF32: each f32
// operand v is split into hi = tf32(v) and lo = tf32(v - hi) (cvt.rna:
// round to nearest, ties away from zero, 10 mantissa bits; x's lo is cut
// toward zero instead), and each k-step adds lo*hi, then hi*lo, then hi*hi.
// A tf32 product is exact in f32, and the split's errors (the dropped lo*lo
// term, x's lo cut toward zero) are ~2^-21 of |x_k w_k|: measured on the
// card, rounding x's lo to nearest or adding lo*lo leaves the forward's
// error where it was.  What costs accuracy is the tensor cores' own f32
// sums, which add each product toward zero: left there for the 48 additions
// of a 128-channel dot product, the forward's pooled values erred 5.8-5.9x
// (RMS) an f32 GEMM's against float64.  So the forward keeps those sums to
// a group of kGroup = 2 k-steps (16 channels; the group's first product has
// scale_d 0) and adds each group into its own f32 sums, rounded to nearest,
// which brings it to 0.91-0.97x (RMS) of an f32 GEMM, the largest error to
// 0.39-0.92x.  The backward's x @ m, at an f32 GEMM's error already (its
// sums carry the winners' terms and row), keeps its tensor-core sums.  The
// forward is 2 * b * n * c_in * c products (17 GFLOP at 8 x 8192 x 128 ->
// 1024, three tensor-core products each), bound by tensor-core operations;
// the (b, n, c) pre-activation never reaches device memory, which is what
// the plain version pays for.  The backward's dense part x @ m is an eighth
// of that work and is bound by the bytes of x and dx.
//
// One main loop (run_tiles) serves both f32 kernels, on warpgroup MMA
// (wgmma m64n128k8, A from registers, B from shared memory): a block of two
// warpgroups owns a tile of 128 points x 128 output columns (64 points
// each) and walks a run
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
// each winner's coef) are bf16, each product is exact and the sums are f32.
// The forward's output is the f32 maximum with its first index, as in f32
// (the TPU kernel's packed argmax rounds the pooled value to 23 -
// ceil(log2 n) bits; this one does not).  The backward writes dx in bf16,
// rounded once from its f32 sum, and dk in f32.  The forward is bound by
// its 17 GFLOP at 989 TFLOP/s of dense bf16 (0.017 ms at 8 x 8192 x 128 ->
// 1024), the backward by the bytes of x and dx (33.6 MB, 0.010 ms).
//
// At c_in 64 and 128 (the chains' width) each bf16 form is a kernel of its
// own, built for Hopper (below, "The bf16 forms (c_in 64 or 128)"): TMA
// loads through mbarrier rings issued by a producer warp, wgmma with both
// operands in 128-byte-swizzled shared memory, a persistent grid.  The
// forward turns the product round (channels are wgmma's m, points its n),
// so a thread's running max over points lives in registers; its slice of
// 256 channels of w stays resident, so x comes from L2 four times at c =
// 1024; two consumer warpgroups take the tensor cores in turn, one's
// epilogue (the affine, the max, the first index) under the other's
// products.  The backward's first launch sorts each cloud's winners by
// point (channel order within a point) into per-point lists, and dx's
// epilogue adds, for each row, only that row's winners, from w rows staged
// while the row's products run; dx goes back through shared memory by TMA
// stores.  Wider c_in keeps the f32 forms' run of tiles on bf16 operands:
// one wgmma m64n128k16.f32.bf16.bf16 a k-step in place of three tf32
// products, a bf16 stage holding 64 input channels, the same 128 bytes a
// row as f32's 32, with the weight (or m, rounded to bf16) relaid once a
// call.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
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
constexpr int kGroup = 2;    // k-steps whose products the tensor cores sum
                             // before the forward promotes them (16 channels)
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
template <int N>
__device__ __forceinline__ void keep_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
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

// d (64 x 256) += a (64 x 16) * b (16 x 256), both bf16 in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[128], uint64_t a, uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 128) += a (64 x 16) * b (16 x 128), both bf16 in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 64) += a (64 x 16) * b (16 x 64), both bf16 in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
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
template <bool kBf16, bool kBlockSync, bool kPromote, typename Epilogue>
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
  // d: the f32 sums; q (kPromote): a group's partial sums on the tensor
  // cores, added into d with ordinary f32 adds after each kGroup k-steps
  float d[kAcc], q[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) d[i] = q[i] = 0.0f;
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
      } else if constexpr (kPromote) {
        uint32_t ah[4], al[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split_x(v[i], ah[i], al[i]);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        wgmma_tf32(q, al, weight_desc(b_hi + step), kk % kGroup != 0);
        wgmma_tf32(q, ah, weight_desc(b_lo + step), 1);
        wgmma_tf32(q, ah, weight_desc(b_hi + step), 1);
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
      if (!kBf16 && kPromote && kk % kGroup == kGroup - 1) {
        // the group's products are done: promote them into d (round to
        // nearest); the next group starts its partial sums at 0
        wgmma_wait<0>();
        keep_acc(q);
#pragma unroll
        for (int i = 0; i < kAcc; ++i) d[i] = __fadd_rn(d[i], q[i]);
      }
    }
    if (last || !resident) wgmma_wait<0>();
    if (last) {
      keep_acc(d);
      epilogue(it / chunks, d);
      if (!kBf16 && kPromote) {
#pragma unroll
        for (int i = 0; i < kAcc; ++i) d[i] = 0.0f;
      }
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
  run_tiles<kBf16, false, true>(x + (long long)cloud * n * c_in, w_hi, w_hi + split_size, c_in,
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
  run_tiles<kBf16, true, false>(x + (long long)cloud * n * c_in, m_hi, m_hi + split_size, c_in,
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

// dk's row ch (dk transposed), by a block: threads over the input channels
// d; the winners and coefficients of 128 clouds at a time come through
// shared memory in one round trip, so a thread's x loads do not wait on
// each other, and the clouds are summed in order.  kBf16: each coef rounds
// to bf16.  An argmax outside [0, n) traps.
template <bool kBf16>
__device__ __forceinline__ void gather_dk(int ch, const Elem<kBf16>* __restrict__ x,
                                          const float* __restrict__ coef,
                                          const int* __restrict__ argmax,
                                          float* __restrict__ dk_t, int b, int n,
                                          int c_in, int c) {
  __shared__ int ps[128];
  __shared__ float cs[128];
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

// The backward's first launch: blocks [0, split_blocks) split m into hi
// and lo for the dx kernel, and block split_blocks + ch gathers dk's row ch.
// kBf16: m is rounded to bf16 and relaid at m_hi (m_lo unused).
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
  gather_dk<kBf16>(blockIdx.x - split_blocks, x, coef, argmax, dk_t, b, n, c_in, c);
}

// ---------------------------------------------------------------------------
// The bf16 forms (c_in 64 or 128): TMA, mbarriers and wgmma with both
// operands in shared memory.  A block is consumer warpgroups (warps 0 on)
// and a producer after them (the forward's, a warpgroup that gives its
// registers to the consumers by setmaxnreg; dx's, a warp); the producer's
// lane 0 issues every TMA load, the consumers issue products and run the
// epilogue.

constexpr int kFwdThreads = 384;   // two consumer warpgroups, a producer one
constexpr int kBox = 64;           // bf16 a 128-byte swizzled row of a box
constexpr int kBoxRowBytes = 128;
constexpr int kFwdPoints = 256;    // points of a forward tile (wgmma n)
constexpr int kFwdSlice = 256;     // channels of a forward slice: 4 x m64
constexpr int kDxPoints = 64;      // points of a dx tile (wgmma m)
constexpr int kDxConsumers = 2;    // dx's consumer warpgroups, a tile each at a time
constexpr int kDxThreads = 128 * kDxConsumers + 32;  // and a producer warp
constexpr int kDxStages = 5;       // x tiles in flight a block (16 KB each at c_in 128)
constexpr int kWinBatch = 64;      // winner rows a dx warpgroup stages at a time

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// wait for the phase of parity `parity` to complete (a fresh barrier's
// phase of parity 1 counts as complete)
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

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0,
                                            int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0,
                                            int c1, int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src,
                                             int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// named barriers 1-4 (0 is __syncthreads) over `count` threads
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// descriptor of a K-major bf16 operand laid out by TMA's 128-byte swizzle:
// rows of 128 bytes (64 k), 8-row atoms 1,024 bytes apart; a k-step of 16
// moves the start 32 bytes within the row
__device__ __forceinline__ uint64_t sw128_desc(unsigned addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// the larger of a and b, NaN if either is NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;\n" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// relu of a max and its index: a max <= 0 is 0 at index 0 (NaN is kept)
__device__ __forceinline__ void relu_out(float v, int i, float* pooled, int* argmax) {
  if (v <= 0.0f) {
    v = 0.0f;
    i = 0;
  }
  *pooled = v;
  *argmax = i;
}

// The bf16 forward for c_in = 64 KB (KB 1 or 2), persistent: block i takes
// the units i, i + grid, ... of (cloud, run of 256-point tiles, slice of
// 256 channels), the slice fastest, so the blocks that read one stretch of
// x run together and x comes from device memory about once and from L2 once
// a slice.  The product is turned round: channels are wgmma's m, points its
// n (m64n256k16), so a thread holds 2 channels x 64 points of a tile and
// keeps its running max in 8 registers.  The slice's w (256 x c_in, 64 KB at
// c_in 128) is resident, loaded by TMA once a unit; x tiles stream through
// a ring of 4 / KB stages.  Warpgroup g owns the slice's channels [128 g,
// 128 g + 128) as two m64 blocks; the warpgroups take the tensor cores in
// turn (0, 1, 0, 1, ... by named barriers 1 and 2), so one's epilogue runs
// under the other's products.  With one run a unit writes pooled and argmax
// (after relu); with several, each run's (value, index) best goes to
// part_v / part_i, and the block that finishes a (cloud, slice)'s last run
// (a counter in `done`, which it sets back to 0) combines them in run order.
template <int KB>
__global__ void __launch_bounds__(kFwdThreads, 1)
    pooled_forward_tma_kernel(const __grid_constant__ CUtensorMap x_map,
                              const __grid_constant__ CUtensorMap w_map,
                              const float* __restrict__ a,
                              const float* __restrict__ c_row,
                              float* __restrict__ part_v, int* __restrict__ part_i,
                              float* __restrict__ pooled, int* __restrict__ argmax,
                              int* __restrict__ done, int n, int c, int runs,
                              int tiles_per_run, int units) {
  constexpr int kStages = 4 / KB;
  constexpr int kWBox = kFwdSlice * kBoxRowBytes;    // 32 KB: 256 rows x 64 k
  constexpr int kXBox = kFwdPoints * kBoxRowBytes;
  constexpr int kXBytes = KB * kXBox;                // an x tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* w_s = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* x_s = w_s + KB * kWBox;
  uint64_t* w_full = reinterpret_cast<uint64_t*>(x_s + kStages * kXBytes);
  uint64_t* w_empty = w_full + 1;
  uint64_t* x_full = w_full + 2;
  uint64_t* x_empty = x_full + kStages;
  __shared__ int last_run;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slices = (c + kFwdSlice - 1) / kFwdSlice;
  if (threadIdx.x == 0) {
    mbar_init(w_full, 1);
    mbar_init(w_empty, 8);  // lane 0 of each consumer warp
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&x_full[s], 1);
      mbar_init(&x_empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {  // the producer warpgroup: lane 0 of warp 8 issues the loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 8 && lane == 0) {
      int xi = 0, wi = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x, ++wi) {
        const int slice = u % slices, run = (u / slices) % runs;
        const int cloud = u / (slices * runs);
        const int p_begin = run * tiles_per_run * kFwdPoints;
        const int p_end = min(n, p_begin + tiles_per_run * kFwdPoints);
        mbar_wait(w_empty, (wi & 1) ^ 1);  // the last unit's products are done
        mbar_expect(w_full, KB * kWBox);
        for (int kb = 0; kb < KB; ++kb) {
          tma_load_2d(w_s + kb * kWBox, &w_map, kb * kBox, slice * kFwdSlice, w_full);
        }
        for (int p0 = p_begin; p0 < p_end; p0 += kFwdPoints, ++xi) {
          const int s = xi % kStages;
          mbar_wait(&x_empty[s], ((xi / kStages) & 1) ^ 1);
          mbar_expect(&x_full[s], kXBytes);
          for (int kb = 0; kb < KB; ++kb) {
            tma_load_3d(x_s + s * kXBytes + kb * kXBox, &x_map, kb * kBox, p0, cloud,
                        &x_full[s]);
          }
        }
      }
    }
    return;
  }

  // the consumers take the registers the producer gives up
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = warp >> 2, wq = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  float acc[kFwdPoints / 2];
#pragma unroll
  for (int i = 0; i < kFwdPoints / 2; ++i) acc[i] = 0.0f;
  bool waited = wg == 1;  // warpgroup 0 takes the first turn without waiting
  int xi = 0, wi = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++wi) {
    const int slice = u % slices, run = (u / slices) % runs;
    const int cloud = u / (slices * runs);
    const int p_begin = run * tiles_per_run * kFwdPoints;
    const int p_end = min(n, p_begin + tiles_per_run * kFwdPoints);
    // this thread's channels: row 16 wq + 8 h + g of block k of its warpgroup
    float av[2][2], cv[2][2], bv[2][2];
    int bi[2][2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ch = slice * kFwdSlice + (2 * wg + k) * 64 + 16 * wq + 8 * h + g;
        av[k][h] = ch < c ? a[ch] : 0.0f;
        cv[k][h] = ch < c ? c_row[ch] : 0.0f;
        bv[k][h] = -INFINITY;
        bi[k][h] = 0;
      }
    }
    mbar_wait(w_full, wi & 1);
    for (int p0 = p_begin; p0 < p_end; p0 += kFwdPoints, ++xi) {
      const int s = xi % kStages;
      mbar_wait(&x_full[s], (xi / kStages) & 1);
      const bool full = p0 + kFwdPoints <= p_end;
      const unsigned xa = smem_addr(x_s + s * kXBytes);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (waited) bar_sync(wg == 0 ? 1 : 2, 256);  // this warpgroup's turn
        waited = true;
        const unsigned wa = smem_addr(w_s) + (2 * wg + k) * 64 * kBoxRowBytes;
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kb = 0; kb < KB; ++kb) {
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            wgmma_ss(acc, sw128_desc(wa + kb * kWBox + ks * 32),
                     sw128_desc(xa + kb * kXBox + ks * 32), kb + ks > 0);
          }
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        wgmma_wait<0>();
        keep_acc(acc);
        // the other's turn once these products are done, so the tensor cores
        // run the warpgroups' products one after the other and each
        // epilogue runs beside the other's products
        bar_arrive(wg == 0 ? 2 : 1, 256);
        if (k == 1 && lane == 0) {
          mbar_arrive(&x_empty[s]);
          if (p0 + kFwdPoints >= p_end) mbar_arrive(w_empty);
        }
        // acc[4j + 2h + e]: channel row 8h + g of the warp, point 8j + 2t + e
        // of the tile.  The affine in the plain version's order (no FMA
        // contraction), in place; a point past the run's end (zero-filled)
        // gives -inf, which no valid point of the tile, all before it, loses
        // to on the first-index rule
#pragma unroll
        for (int i = 0; i < kFwdPoints / 2; ++i) {
          const int h = (i >> 1) & 1;
          acc[i] = __fadd_rn(__fmul_rn(acc[i], av[k][h]), cv[k][h]);
        }
        if (!full) {
#pragma unroll
          for (int i = 0; i < kFwdPoints / 2; ++i) {
            if (p0 + 8 * (i >> 2) + 2 * t + (i & 1) >= p_end) acc[i] = -INFINITY;
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // the row's max (NaN first) in eight independent chains, then the
          // first of its points that attains it, by a pass in reverse order
          float part[8];
#pragma unroll
          for (int q = 0; q < 8; ++q) part[q] = acc[4 * (q >> 1) + 2 * h + (q & 1)];
#pragma unroll
          for (int q = 8; q < kFwdPoints / 4; ++q) {
            part[q % 8] = max_nan(part[q % 8], acc[4 * (q >> 1) + 2 * h + (q & 1)]);
          }
#pragma unroll
          for (int q = 1; q < 8; ++q) part[0] = max_nan(part[0], part[q]);
          const float m = part[0];
          // the first of the row's 64 points (q = 2j + e) at m, in eight
          // independent chains of eight (each scanned in reverse), then the
          // smallest of theirs
          int found[8];
#pragma unroll
          for (int c8 = 0; c8 < 8; ++c8) found[c8] = kFwdPoints / 4;
          if (m == m) {
#pragma unroll
            for (int c8 = 0; c8 < 8; ++c8) {
#pragma unroll
              for (int q = 8 * c8 + 7; q >= 8 * c8; --q) {
                if (acc[4 * (q >> 1) + 2 * h + (q & 1)] == m) found[c8] = q;
              }
            }
          } else {  // the first NaN
#pragma unroll
            for (int c8 = 0; c8 < 8; ++c8) {
#pragma unroll
              for (int q = 8 * c8 + 7; q >= 8 * c8; --q) {
                const float y = acc[4 * (q >> 1) + 2 * h + (q & 1)];
                if (y != y) found[c8] = q;
              }
            }
          }
#pragma unroll
          for (int c8 = 1; c8 < 8; ++c8) found[0] = min(found[0], found[c8]);
          const int first = 8 * (found[0] >> 1) + (found[0] & 1);  // 8j + e
          if (beats_earlier(m, bv[k][h])) {  // an earlier tile keeps a tie
            bv[k][h] = m;
            bi[k][h] = p0 + 2 * t + first;
          }
        }
      }
    }
    // the 4 lanes of a channel row (lane bits 0-1), then the unit's result
#pragma unroll
    for (int k = 0; k < 2; ++k) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, bv[k][h], off);
          const int oi = __shfl_xor_sync(0xffffffffu, bi[k][h], off);
          if (better(ov, oi, bv[k][h], bi[k][h])) {
            bv[k][h] = ov;
            bi[k][h] = oi;
          }
        }
        const int ch = slice * kFwdSlice + (2 * wg + k) * 64 + 16 * wq + 8 * h + g;
        if (t == 0 && ch < c) {
          if (runs == 1) {
            relu_out(bv[k][h], bi[k][h], pooled + (long long)cloud * c + ch,
                     argmax + (long long)cloud * c + ch);
          } else {
            const long long o = ((long long)cloud * runs + run) * c + ch;
            part_v[o] = bv[k][h];
            part_i[o] = bi[k][h];
          }
        }
      }
    }
    if (runs > 1) {
      // the last of the (cloud, slice)'s runs to finish combines them, in
      // run order (a tie keeps the lower run's lower index), so the result
      // does not depend on which block that is
      __threadfence();
      bar_sync(3, 256);
      if (threadIdx.x == 0) {
        last_run = atomicAdd(&done[cloud * slices + slice], 1) == runs - 1;
      }
      bar_sync(3, 256);
      if (last_run) {
        __threadfence();
        const int ch = slice * kFwdSlice + threadIdx.x;
        if (ch < c) {
          float best = -INFINITY;
          int at = 0;
          for (int r = 0; r < runs; ++r) {
            const long long o = ((long long)cloud * runs + r) * c + ch;
            const float v = __ldcg(part_v + o);
            if (beats_earlier(v, best)) {
              best = v;
              at = __ldcg(part_i + o);
            }
          }
          relu_out(best, at, pooled + (long long)cloud * c + ch,
                   argmax + (long long)cloud * c + ch);
        }
        if (threadIdx.x == 0) done[cloud * slices + slice] = 0;  // for the next call
      }
    }
  }
  if (wg == 0) bar_sync(1, 256);  // warpgroup 1's last turn hand-back
}

// The bf16 backward's first launch (c_in 64 or 128), blocks of 1,024
// threads.  The first b * ceil(n / kCsrPoints) blocks list the clouds'
// winners, a block a cloud's kCsrPoints points: win_ch holds each cloud's
// channels in point order and, within a point, channel order (a counting
// sort), with win_coef their bf16-rounded coef, and pt_off[p] .. pt_off[p +
// 1] is point p's stretch of them.  The next m_blocks write m^T in bf16 (m_t[j][k] = m[k][j], the
// K-major operand of dx's products), and the rest gather dk's rows: a
// channel's clouds are cut into dk_parts(b) stretches, one a warp (lane l
// holding channels 4l .. 4l + 3 of a row), each summed in cloud order, then
// the stretches in order, so dk is deterministic.  An argmax outside [0, n)
// traps.
constexpr int kPrepThreads = 1024;
constexpr int kCsrPoints = 1024;  // points a block of the lists takes

// exclusive prefix sum of v over the block's 1,024 threads, in thread order
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane], wi = w;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, wi, off);
      if (lane >= off) wi += o;
    }
    warp_sums[lane] = wi - w;
  }
  __syncthreads();
  const int out = warp_sums[warp] + incl - v;
  __syncthreads();  // warp_sums is free again
  return out;
}

// in-place exclusive prefix sum of a[0 .. count), by the block's 32 warps:
// warp w takes the w-th stretch of the array, its lanes on neighbouring
// entries (no bank conflicts), then the stretches' totals are scanned
__device__ __forceinline__ void block_scan_array(int* a, int count, int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int stretch = (count + 31) / 32;
  const int begin = warp * stretch, end = min(count, begin + stretch);
  int total = 0;
  for (int k = begin; k < end; k += 32) {
    const int v = k + lane < end ? a[k + lane] : 0;
    int incl = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += o;
    }
    if (k + lane < end) a[k + lane] = total + incl - v;
    total += __shfl_sync(0xffffffffu, incl, 31);
  }
  const int offset = block_exclusive_scan(lane == 0 ? total : 0, warp_sums);
  const int warp_offset = __shfl_sync(0xffffffffu, offset, 0);
  for (int k = begin + lane; k < end; k += 32) a[k] += warp_offset;
  __syncthreads();
}

// the stretches (warps) each channel's clouds are cut into for dk: a power
// of two up to 32, about one for every 16 clouds
__host__ __device__ __forceinline__ int dk_parts(int b) {
  int parts = 1;
  while (parts < 32 && parts * 16 < b) parts <<= 1;
  return parts;
}

__global__ void __launch_bounds__(kPrepThreads, 1)
    pooled_backward_prep_tma_kernel(
        const float* __restrict__ m, __nv_bfloat16* __restrict__ m_t, int m_blocks,
        const __nv_bfloat16* __restrict__ x, const float* __restrict__ coef,
        const int* __restrict__ argmax, float* __restrict__ dk_t,
        int* __restrict__ win_ch, float* __restrict__ win_coef, int* __restrict__ pt_off,
        int b, int n, int c_in, int c) {
  // the lists' counters and slots; dk's partial sums
  __shared__ int work[2 * kCsrPoints + kMaxC];
  __shared__ int warp_sums[33];
  const int block = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int csr_blocks = b * ((n + kCsrPoints - 1) / kCsrPoints);
  if (block >= csr_blocks + m_blocks) {  // dk's rows
    const int parts = dk_parts(b);
    const int ch = (block - csr_blocks - m_blocks) * (32 / parts) + warp / parts;
    const int part = warp % parts;
    const int per = (b + parts - 1) / parts;
    const int cl_begin = min(b, part * per), cl_end = min(b, cl_begin + per);
    const bool on = 4 * lane < c_in;
    constexpr int kRows = 16;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (ch < c) {
      // the stretch's clouds in order, 32 at a time: their winners first,
      // one a lane, then 16 x rows at a time
      for (int cl0 = cl_begin; cl0 < cl_end; cl0 += 32) {
        const int clouds = min(32, cl_end - cl0);
        const long long o = (long long)(cl0 + lane) * c + ch;
        int p_mine = 0;
        float cf_mine = 0.0f;
        if (lane < clouds) {
          p_mine = argmax[o];
          if (p_mine < 0 || p_mine >= n) __trap();  // argmax outside [0, n)
          cf_mine = coef_of(coef[o], true);
        }
        for (int u0 = 0; u0 < clouds; u0 += kRows) {
          uint2 xr[kRows];
#pragma unroll
          for (int u = 0; u < kRows; ++u) {
            const int p = __shfl_sync(0xffffffffu, p_mine, (u0 + u) & 31);
            xr[u] = make_uint2(0u, 0u);
            if (on && u0 + u < clouds) {
              xr[u] = *reinterpret_cast<const uint2*>(
                  x + ((long long)(cl0 + u0 + u) * n + p) * c_in + 4 * lane);
            }
          }
#pragma unroll
          for (int u = 0; u < kRows; ++u) {
            const float cf = __shfl_sync(0xffffffffu, cf_mine, (u0 + u) & 31);
            if (u0 + u < clouds) {
              const float2 lo =
                  __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr[u].x));
              const float2 hi =
                  __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr[u].y));
              acc[0] = fmaf(cf, lo.x, acc[0]);
              acc[1] = fmaf(cf, lo.y, acc[1]);
              acc[2] = fmaf(cf, hi.x, acc[2]);
              acc[3] = fmaf(cf, hi.y, acc[3]);
            }
          }
        }
      }
    }
    float* partial = reinterpret_cast<float*>(work);  // [warp][128]
#pragma unroll
    for (int q = 0; q < 4; ++q) partial[warp * 128 + 4 * lane + q] = acc[q];
    __syncthreads();
    if (part == 0 && ch < c && on) {
      float total[4] = {acc[0], acc[1], acc[2], acc[3]};
      for (int pi = 1; pi < parts; ++pi) {
#pragma unroll
        for (int q = 0; q < 4; ++q) total[q] += partial[(warp + pi) * 128 + 4 * lane + q];
      }
      *reinterpret_cast<float4*>(dk_t + (long long)ch * c_in + 4 * lane) =
          make_float4(total[0], total[1], total[2], total[3]);
    }
    return;
  }
  if (block >= csr_blocks) {  // m^T in bf16
    for (int i = (block - csr_blocks) * kPrepThreads + tid; i < c_in * c_in;
         i += m_blocks * kPrepThreads) {
      const int j = i / c_in, k = i % c_in;
      m_t[i] = __float2bfloat16_rn(m[(long long)k * c_in + j]);
    }
    return;
  }
  // block (cloud, chunk) lists the cloud's winners on the chunk's kCsrPoints
  // points [p0, p1): a pass over the cloud's argmax counts the channels
  // below p0 and each point's channels (shared-memory counters), a scan
  // gives the points' offsets, and each channel takes a slot in its point's
  // stretch (a counter again, so in no set order); then each channel's
  // final place is its stretch's start plus the number of the stretch's
  // channels below it, so a point's channels are in channel order
  const int chunks = (n + kCsrPoints - 1) / kCsrPoints;
  const int cloud = block / chunks;
  const int p0 = (block % chunks) * kCsrPoints, p1 = min(n, p0 + kCsrPoints);
  const int points = p1 - p0;
  int* count = work;                  // [point]: winners, then (scanned) offsets
  int* cursor = count + kCsrPoints;   // [point]: slots taken
  int* slot_ch = cursor + kCsrPoints;  // [slot]: the chunk's channels
  const int* am = argmax + (long long)cloud * c;
  for (int q = tid; q < points; q += kPrepThreads) count[q] = cursor[q] = 0;
  __syncthreads();
  int below = 0;  // this thread's channels below p0
  for (int j = tid; j < c; j += kPrepThreads) {
    const int p = am[j];
    if (p < 0 || p >= n) __trap();  // argmax outside [0, n)
    if (p < p0) {
      ++below;
    } else if (p < p1) {
      atomicAdd(&count[p - p0], 1);
    }
  }
  const int below_before = block_exclusive_scan(below, warp_sums);
  if (tid == kPrepThreads - 1) warp_sums[32] = below_before + below;
  __syncthreads();
  const int base = warp_sums[32];  // the cloud's channels below p0
  block_scan_array(count, points, warp_sums);
  int* off = pt_off + (long long)cloud * (n + 1);
  for (int j = tid; j < c; j += kPrepThreads) {
    const int p = am[j];
    if (p >= p0 && p < p1) slot_ch[count[p - p0] + atomicAdd(&cursor[p - p0], 1)] = j;
  }
  __syncthreads();
  const int total = points > 0 ? count[points - 1] + cursor[points - 1] : 0;
  for (int q = tid; q < points; q += kPrepThreads) off[p0 + q] = base + count[q];
  if (p1 == n && tid == 0) off[n] = c;
  for (int slot = tid; slot < total; slot += kPrepThreads) {
    const int j = slot_ch[slot];
    const int q = am[j] - p0;
    int rank = 0;
    for (int o = count[q]; o < count[q] + cursor[q]; ++o) rank += slot_ch[o] < j;
    const long long at = (long long)cloud * c + base + count[q] + rank;
    win_ch[at] = j;
    win_coef[at] = coef_of(coef[(long long)cloud * c + j], true);
  }
}

// The bf16 backward's dx for c_in = 64 KB (KB 1 or 2), persistent: block i
// takes the 64-point tiles i, i + grid, ... of all clouds, its
// kDxConsumers warpgroups in turn (warpgroup g the block's tiles g, g + 2,
// ...), so two tiles' latencies overlap; a producer warp's lane 0 issues
// the loads.  m^T (c_in x c_in
// bf16, 32 KB at c_in 128) is resident; x tiles stream by TMA through a
// ring of kDxStages (80 KB in flight at c_in 128, for x's bytes at the
// device's rate).  dx = x @ m (m64 x c_in x 16 products, both operands in
// shared memory) + row, then each row's own winners' coef * w rows, in
// channel order, from the prep's lists: the tile's winners are one stretch
// of them, whose w rows the warpgroup copies into shared memory (64 at a
// time) while its products run.  dx is rounded to bf16 and written back
// through shared memory (128-byte swizzled, two buffers a warpgroup, so a
// tile's store drains while the next is built) by TMA stores, which clip
// the rows past n.
template <int KB>
__global__ void __launch_bounds__(kDxThreads, 1)
    pooled_backward_dx_tma_kernel(const __grid_constant__ CUtensorMap x_map,
                                  const __grid_constant__ CUtensorMap m_map,
                                  const __grid_constant__ CUtensorMap dx_map,
                                  const __nv_bfloat16* __restrict__ w,
                                  const int* __restrict__ win_ch,
                                  const float* __restrict__ win_coef,
                                  const int* __restrict__ pt_off,
                                  const float* __restrict__ row, int n, int c,
                                  int tiles_per_cloud, int tiles) {
  constexpr int kCols = KB * kBox;                 // c_in: wgmma's n
  constexpr int kXBox = kDxPoints * kBoxRowBytes;  // 8 KB: 64 rows x 64 k
  constexpr int kXBytes = KB * kXBox;
  constexpr int kMBox = kCols * kBoxRowBytes;
  constexpr int kPieces = kCols / 8;               // 16-byte pieces of a w row
  extern __shared__ uint8_t smem_raw[];
  uint8_t* m_s = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* x_s = m_s + KB * kMBox;
  uint8_t* out_s = x_s + kDxStages * kXBytes;  // [warpgroup][buffer] tiles
  // [warpgroup][winner][column] w rows, each padded by 16 bytes (so the
  // rows 8 lanes read at once fall in different banks), then
  // [warpgroup][winner] coef
  constexpr int kRow = kCols + 8;
  __nv_bfloat16* win_w =
      reinterpret_cast<__nv_bfloat16*>(out_s + 2 * kDxConsumers * kXBytes);
  float* win_c = reinterpret_cast<float*>(win_w + kDxConsumers * kWinBatch * kRow);
  float* row_s = win_c + kDxConsumers * kWinBatch;  // row, the same for every tile
  uint64_t* m_full = reinterpret_cast<uint64_t*>(row_s + kCols);
  uint64_t* x_full = m_full + 1;
  uint64_t* x_empty = x_full + kDxStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    mbar_init(m_full, 1);
    for (int s = 0; s < kDxStages; ++s) {
      mbar_init(&x_full[s], 1);
      mbar_init(&x_empty[s], 4);  // lane 0 of each warp of the consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * kDxConsumers) {  // the producer warp
    if (lane == 0) {
      mbar_expect(m_full, KB * kMBox);
      for (int kb = 0; kb < KB; ++kb) tma_load_2d(m_s + kb * kMBox, &m_map, kb * kBox, 0, m_full);
      for (int k = 0, tile = blockIdx.x; tile < tiles; ++k, tile += gridDim.x) {
        const int s = k % kDxStages;
        mbar_wait(&x_empty[s], ((k / kDxStages) & 1) ^ 1);
        mbar_expect(&x_full[s], kXBytes);
        for (int kb = 0; kb < KB; ++kb) {
          tma_load_3d(x_s + s * kXBytes + kb * kXBox, &x_map, kb * kBox,
                      (tile % tiles_per_cloud) * kDxPoints, tile / tiles_per_cloud, &x_full[s]);
        }
      }
    }
    return;
  }

  const int wg = warp >> 2, wq = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int ti = threadIdx.x & 127;
  __nv_bfloat16* my_w = win_w + wg * kWinBatch * kRow;
  float* my_c = win_c + wg * kWinBatch;
  if (threadIdx.x < kCols) row_s[threadIdx.x] = row[threadIdx.x];
  bar_sync(7, 128 * kDxConsumers);
  float acc[kCols / 2];
#pragma unroll
  for (int i = 0; i < kCols / 2; ++i) acc[i] = 0.0f;
  // the channels and coef of winners b0 .. b0 + rows of a cloud's list
  // (rows <= 64) that this thread copies: its pieces f = ti + 128 m are
  // piece f % kPieces of winner f / kPieces
  constexpr int kPer = kWinBatch * kPieces / 128;
  struct Batch {
    int ch[kPer];
    float cf;
  };
  auto fetch = [&](const int* chs, const float* cfs, int b0, int rows, Batch& bt) {
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int e = (ti + 128 * m) / kPieces;
      bt.ch[m] = e < rows ? chs[b0 + e] : 0;
    }
    bt.cf = ti < rows ? cfs[b0 + ti] : 0.0f;
  };
  // copy their w rows into shared memory
  auto stage = [&](const Batch& bt, int rows) {
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int f = ti + 128 * m, e = f / kPieces, q = f % kPieces;
      if (e < rows) {
        cp_async16(my_w + e * kRow + q * 8, w + (long long)bt.ch[m] * kCols + q * 8, true);
      }
    }
    if (ti < rows) my_c[ti] = bt.cf;
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  // a tile's stretch of winners and this thread's rows' own, read a tile
  // ahead: [0] the tile's first and last, [1 + h] row h's
  auto stretch = [&](int tile, int (&e)[3][2]) {
    e[0][0] = e[0][1] = e[1][0] = e[1][1] = e[2][0] = e[2][1] = 0;
    if (tile >= tiles) return;
    const int p0 = (tile % tiles_per_cloud) * kDxPoints;
    const int* off = pt_off + (long long)(tile / tiles_per_cloud) * (n + 1);
    e[0][0] = off[p0];
    e[0][1] = off[min(p0 + kDxPoints, n)];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + 16 * wq + 8 * h + g;
      if (p < n) {
        e[1 + h][0] = off[p];
        e[1 + h][1] = off[p + 1];
      }
    }
  };
  int next[3][2];
  Batch first;  // the next tile's first winners, read a tile ahead
  {
    const int tile = blockIdx.x + wg * gridDim.x;
    stretch(tile, next);
    if (tile < tiles) {
      const long long cl = tile / tiles_per_cloud;
      fetch(win_ch + cl * c, win_coef + cl * c, next[0][0],
            min(kWinBatch, next[0][1] - next[0][0]), first);
    }
  }
  mbar_wait(m_full, 0);
  int buf = 0;
  for (int k = wg, tile = blockIdx.x + wg * gridDim.x; tile < tiles;
       k += kDxConsumers, tile += kDxConsumers * gridDim.x) {
    const int cloud = tile / tiles_per_cloud;
    const int p0 = (tile % tiles_per_cloud) * kDxPoints;
    const int* chs = win_ch + (long long)cloud * c;
    const float* cfs = win_coef + (long long)cloud * c;
    const int e_begin = next[0][0], e_end = next[0][1];
    const int lo[2] = {next[1][0], next[2][0]}, hi[2] = {next[1][1], next[2][1]};
    const Batch now = first;
    stretch(tile + kDxConsumers * gridDim.x, next);
    const int s = k % kDxStages;
    mbar_wait(&x_full[s], (k / kDxStages) & 1);
    const unsigned xa = smem_addr(x_s + s * kXBytes), ma = smem_addr(m_s);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kb = 0; kb < KB; ++kb) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        wgmma_ss(acc, sw128_desc(xa + kb * kXBox + ks * 32),
                 sw128_desc(ma + kb * kMBox + ks * 32), kb + ks > 0);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // the first winners' rows come in while the products run (the last
    // tile's readers of the staging are past its barriers)
    stage(now, min(kWinBatch, e_end - e_begin));
    if (tile + kDxConsumers * gridDim.x < tiles) {
      const long long cl = (tile + kDxConsumers * gridDim.x) / tiles_per_cloud;
      fetch(win_ch + cl * c, win_coef + cl * c, next[0][0],
            min(kWinBatch, next[0][1] - next[0][0]), first);
    }
    wgmma_wait<0>();
    keep_acc(acc);
    if (lane == 0) mbar_arrive(&x_empty[s]);

    // acc[4j + 2h + e]: point 16 wq + 8h + g of the tile, column 8j + 2t + e
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) {
      const float2 rv = *reinterpret_cast<const float2*>(&row_s[8 * j + 2 * t]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        acc[4 * j + 2 * h] += rv.x;
        acc[4 * j + 2 * h + 1] += rv.y;
      }
    }
    for (int b0 = e_begin; b0 < e_end; b0 += kWinBatch) {
      const int rows = min(kWinBatch, e_end - b0);
      if (b0 != e_begin) {
        Batch more;
        fetch(chs, cfs, b0, rows, more);
        bar_sync(3 + wg, 128);  // the last batch's readers are done
        stage(more, rows);
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      bar_sync(3 + wg, 128);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e1 = min(hi[h], b0 + rows);
        for (int e = max(lo[h], b0); e < e1; ++e) {
          const float sc = my_c[e - b0];
          const __nv_bfloat16* wr = my_w + (e - b0) * kRow;
#pragma unroll
          for (int j = 0; j < kCols / 8; ++j) {
            const float2 wv = pair_of(wr + 8 * j + 2 * t);
            acc[4 * j + 2 * h] = fmaf(sc, wv.x, acc[4 * j + 2 * h]);
            acc[4 * j + 2 * h + 1] = fmaf(sc, wv.y, acc[4 * j + 2 * h + 1]);
          }
        }
      }
    }

    // stage the tile in bf16: row r at r * 128 bytes of its 64-column box,
    // 16-byte chunk q at q ^ (r % 8) (TMA's 128-byte swizzle)
    uint8_t* out = out_s + (2 * wg + buf) * kXBytes;
    if (ti == 0) {  // the store that last read this buffer is done reading
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
    }
    bar_sync(3 + wg, 128);  // and this tile's winner rows are read
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * wq + 8 * h + g;
        *reinterpret_cast<__nv_bfloat162*>(out + (j / 8) * kXBox + r * kBoxRowBytes +
                                           (((j % 8) ^ g) << 4) + 4 * t) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar_sync(3 + wg, 128);
    if (ti == 0) {
      for (int kb = 0; kb < KB; ++kb) {
        tma_store_3d(&dx_map, out + kb * kXBox, kb * kBox, p0, cloud);
      }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
    buf ^= 1;
  }
  if (ti == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

bool shapes_ok(long long b, long long n, long long c_in, long long c) {
  return b > 0 && n > 0 && b <= 65535 && n <= 0x7fffffffLL / 2 &&
         c_in > 0 && c_in % 64 == 0 && c > 0 && c % 64 == 0 &&
         c <= kMaxC && b * n * c_in < (1LL << 40);
}

// runs of tiles_per_run point tiles (of `tile` points) cover the cloud's
// tiles, none empty
bool runs_ok(int n, int runs, int tiles_per_run, int tile = kTileP) {
  const long long tiles = (n + tile - 1) / tile;
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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// the driver's tensor-map encoder, looked up once (no link against libcuda)
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// a TMA map of a bf16 tensor, 128-byte swizzled boxes: dims and box
// innermost first, strides in elements of dims 1 .. rank - 1
bool bf16_map(CUtensorMap* map, const void* base, int rank, const long long* dims,
              const long long* strides, const int* box) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  cuuint64_t gdim[3], gstride[2];
  cuuint32_t bdim[3], estride[3] = {1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    gdim[i] = static_cast<cuuint64_t>(dims[i]);
    bdim[i] = static_cast<cuuint32_t>(box[i]);
  }
  for (int i = 0; i + 1 < rank; ++i) gstride[i] = static_cast<cuuint64_t>(strides[i]) * 2;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), gdim,
            gstride, bdim, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// x (b, n, c_in) in boxes of 64 channels x `points` points of one cloud
bool x_map(CUtensorMap* map, const __nv_bfloat16* x, int b, int n, int c_in, int points) {
  const long long dims[3] = {c_in, n, b}, strides[2] = {c_in, (long long)n * c_in};
  const int box[3] = {kBox, points, 1};
  return bf16_map(map, x, 3, dims, strides, box);
}

// a (rows, c_in) row-major matrix in boxes of 64 channels x `rows_box` rows
bool rows_map(CUtensorMap* map, const __nv_bfloat16* p, int rows, int c_in, int rows_box) {
  const long long dims[2] = {c_in, rows}, strides[1] = {c_in};
  const int box[2] = {kBox, rows_box};
  return bf16_map(map, p, 2, dims, strides, box);
}

template <int KB>
int fwd_smem() {  // alignment slack, w slice, x ring, barriers
  return 1024 + KB * kFwdSlice * kBoxRowBytes + (4 / KB) * KB * kFwdPoints * kBoxRowBytes +
         8 * (2 + 2 * (4 / KB));
}

template <int KB>
int dx_smem() {  // alignment slack, m^T, x ring, dx staging, winners, row, barriers
  return 1024 + KB * KB * kBox * kBoxRowBytes +
         (kDxStages + 2 * kDxConsumers) * KB * kDxPoints * kBoxRowBytes +
         kDxConsumers * kWinBatch * ((KB * kBox + 8) * 2 + 4) + KB * kBox * 4 +
         8 * (1 + 2 * kDxStages);
}

template <int KB>
int forward_tma(const __nv_bfloat16* x, const __nv_bfloat16* w, const float* a,
                const float* c_row, float* part_v, int* part_i, float* pooled, int* argmax,
                int* done, int b, int n, int c, int runs, int tiles_per_run, int grid,
                cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      pooled_forward_tma_kernel<KB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      fwd_smem<KB>());
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap xm, wm;
  if (!x_map(&xm, x, b, n, KB * kBox, kFwdPoints) ||
      !rows_map(&wm, w, c, KB * kBox, kFwdSlice)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int units = b * runs * ((c + kFwdSlice - 1) / kFwdSlice);
  pooled_forward_tma_kernel<KB><<<grid, kFwdThreads, fwd_smem<KB>(), s>>>(
      xm, wm, a, c_row, part_v, part_i, pooled, argmax, done, n, c, runs, tiles_per_run,
      units);
  return static_cast<int>(cudaGetLastError());
}

template <int KB>
int backward_tma(const __nv_bfloat16* x, const __nv_bfloat16* w, const float* coef,
                 const int* argmax, const float* m, __nv_bfloat16* m_t, int* win_ch,
                 float* win_coef, int* pt_off, const float* row, __nv_bfloat16* dx,
                 float* dk_t, int b, int n, int c, int grid, cudaStream_t s) {
  constexpr int kCIn = KB * kBox;
  static const cudaError_t attr = cudaFuncSetAttribute(
      pooled_backward_dx_tma_kernel<KB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dx_smem<KB>());
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap xm, mm, dm;
  if (!x_map(&xm, x, b, n, kCIn, kDxPoints) || !rows_map(&mm, m_t, kCIn, kCIn, kCIn) ||
      !x_map(&dm, dx, b, n, kCIn, kDxPoints)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int m_blocks = (kCIn * kCIn + kPrepThreads - 1) / kPrepThreads;
  const int per_block = 32 / dk_parts(b);  // channels a dk block
  const int dk_blocks = (c + per_block - 1) / per_block;
  const int csr_blocks = b * ((n + kCsrPoints - 1) / kCsrPoints);
  pooled_backward_prep_tma_kernel<<<csr_blocks + m_blocks + dk_blocks, kPrepThreads, 0, s>>>(
      m, m_t, m_blocks, x, coef, argmax, dk_t, win_ch, win_coef, pt_off, b, n, kCIn, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_per_cloud = (n + kDxPoints - 1) / kDxPoints;
  pooled_backward_dx_tma_kernel<KB><<<grid, kDxThreads, dx_smem<KB>(), s>>>(
      xm, mm, dm, w, win_ch, win_coef, pt_off, row, n, c, tiles_per_cloud,
      b * tiles_per_cloud);
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

// The bf16 forms for c_in 64 or 128 (TMA): x (b, n, c_in) and w (c, c_in)
// bf16; a and c_row (c,) f32; part_v/part_i (b, runs, c) scratch (unused
// with one run); pooled (b, c) f32, argmax (b, c) int32; done (b *
// ceil(c / 256)) int32 counters, zero on entry and left zero (calls that
// share them run one at a time, as on one stream).  Run r holds the
// 256-point tiles [r * tiles_per_run, (r + 1) * tiles_per_run); grid blocks
// (at most b * runs * ceil(c / 256)) walk the units.
extern "C" int pcp_pooled_chain_forward_bf16_tma(const __nv_bfloat16* x,
                                                 const __nv_bfloat16* w,
                                                 const float* a, const float* c_row,
                                                 float* part_v, int* part_i,
                                                 float* pooled, int* argmax, int* done,
                                                 int b, int n, int c_in, int c, int runs,
                                                 int tiles_per_run, int grid,
                                                 void* stream) {
  const long long units = (long long)b * runs * ((c + kFwdSlice - 1) / kFwdSlice);
  if (!shapes_ok(b, n, c_in, c) || (c_in != 64 && c_in != 128) ||
      !runs_ok(n, runs, tiles_per_run, kFwdPoints) || grid < 1 || grid > units) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return c_in == 64 ? forward_tma<1>(x, w, a, c_row, part_v, part_i, pooled, argmax, done,
                                     b, n, c, runs, tiles_per_run, grid, s)
                    : forward_tma<2>(x, w, a, c_row, part_v, part_i, pooled, argmax, done,
                                     b, n, c, runs, tiles_per_run, grid, s);
}

// x (b, n, c_in), w (c, c_in) and dx bf16 (c_in 64 or 128); coef (b, c) f32,
// argmax (b, c) int32, m (c_in, c_in), row (c_in,) f32; scratch m_t (c_in,
// c_in) bf16, win_ch (b, c) int32, win_coef (b, c) f32, pt_off (b, n + 1)
// int32; dk_t (c, c_in) f32.  grid blocks (at most b * ceil(n / 64)) walk the
// 64-point tiles.
extern "C" int pcp_pooled_chain_backward_bf16_tma(
    const __nv_bfloat16* x, const __nv_bfloat16* w, const float* coef, const int* argmax,
    const float* m, __nv_bfloat16* m_t, int* win_ch, float* win_coef, int* pt_off,
    const float* row, __nv_bfloat16* dx, float* dk_t, int b, int n, int c_in, int c,
    int grid, void* stream) {
  const long long tiles = (long long)b * ((n + kDxPoints - 1) / kDxPoints);
  if (!shapes_ok(b, n, c_in, c) || (c_in != 64 && c_in != 128) || grid < 1 ||
      grid > tiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return c_in == 64 ? backward_tma<1>(x, w, coef, argmax, m, m_t, win_ch, win_coef, pt_off,
                                      row, dx, dk_t, b, n, c, grid, s)
                    : backward_tma<2>(x, w, coef, argmax, m, m_t, win_ch, win_coef, pt_off,
                                      row, dx, dk_t, b, n, c, grid, s);
}

extern "C" const char* pcp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
