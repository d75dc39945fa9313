// Fused outer-product-mean, for Hopper (sm_90a).
//
// Replaces the TPU kernel `fused_opm_pallas`
// (src/repro/kernels/triangle.py, body `_opm_kernel`):
//   o[i,j]  = sum_s a[s,i,:] (x) b[s,j,:]                 (C x C), fp32
//   norm    = sum_s mask_a[s,i] * mask_b[s,j]              fp32
//   ov      = vec(o) * (1 / (norm + 1e-3)), cast to dt
//   out     = ov @ w + bias                                fp32, one cast
// a and b arrive masked. The (B, I, J, C, C) outer-product tensor never
// reaches device memory: a tile's ov lives in shared memory only.
//
// Bound on the H100, FULL widths (C = 32, C^2 = 1024, D = 128, S = 128,
// bf16): 2 I J S C^2 + 2 I J C^2 D operations, 34.4 GFLOP at r = 256 and
// 77 GFLOP at r = 384, take 0.035 ms and 0.078 ms at 989 TFLOP/s, while the
// bytes (a, b and the masks read once, out written once, w) take under
// 0.01 ms. So tensor-core operations bound it, and the design puts both
// products on wgmma, Hopper's warpgroup tensor-core instruction, and keeps
// the tensor cores fed from a ring of shared-memory stages that TMA fills.
//
// Design (bf16):
//  * one persistent block an SM walks the 8 x 8-pixel tiles (b, i0, j0),
//    j fastest; 384 threads: two consumer warpgroups and one producer warp;
//  * a tile is NSUB sub-tiles of 128 / C rows i (two of 4 at C = 32, one
//    of 8 at C = 16). A sub-tile's outer product is one GEMM over s with
//    M = (i, c1) = 128, split 64 / 64 over the consumer warpgroups, and
//    N = (j, c2) = 8 C; both operands are read by wgmma in a's and b's own
//    memory layout ([s][(i, c)], "MN-major"), 128-byte swizzled by TMA;
//  * the producer warp keeps a ring of NSLOT stages full: per stage 32
//    rows of s of a and b (TMA, zero fill past S, I and J) and the masks of
//    the sub-tile's pixels (4-byte cp.async by its 32 lanes, which the
//    stage's barrier also waits for); then, per tile, the C^2 / 64 chunks of w,
//    64 rows of (c1, c2) each, in an order staggered by the tile's j index
//    so that the SMs do not all ask for the same chunk at once. The stagger
//    sets the order in which the projection sums its chunks, so it depends
//    on j alone: a pixel's output is then the same bits whichever block
//    takes its tile and whatever I is, and a shard of rows i (Dynamic Axial
//    Parallelism hands each rank one) gives the whole call's rows exactly. A stage is released by
//    the 8 consumer warps once the wgmma that read it completed, one group
//    kept in flight. The producer's warpgroup hands registers to the
//    consumers (setmaxnreg), whose 128-float accumulators then do not spill;
//  * the consumers sum each pixel's norm from the staged masks beside the
//    products, take one fp32 reciprocal per pixel, scale the fragments by
//    it, cast them to bf16 and write them with stmatrix into ov: 64 pixels
//    x C^2, in blocks of 64 (c1, c2) columns that hold 8 c1 x 8 c2 each, so
//    that one 8 x 8 fragment is one 128-byte row of a block, swizzled as
//    wgmma reads a K-major operand (conflict-free stores);
//  * the projection ov (64 x C^2) @ w (C^2 x D) runs on wgmma over the w
//    chunks (w read in its own layout, row blocks gathered by a 4-d TMA box
//    in ov's column order), each consumer warpgroup owning D / 2 outputs
//    (at D = 32 the first owns all); bias and the one cast are applied to
//    the fragments, which are stored straight to `out`.
// While the consumers project and store, the producer is already loading
// the next tile's first stages. The 128 KB ov buffer (C = 32) leaves room
// for three 26 KB stages. On the card the kernel is held back by the bytes
// each SM takes in, not by its tensor work: every tile stages 192 KB of a
// and b and all 256 KB of w (see PERF.md). A pixel with norm = 0 (padding, or an all-masked
// MSA column) has o = 0, so its output is the bias, as in the plain
// version. The fp32 instantiation is a plain FMA loop with the plain
// version's arithmetic (no TF32, a true divide), for the fp32 checks; it
// is not the timed path. The kernels launch on the caller's stream,
// allocate nothing and do not synchronise.
#include <cuda.h>               // CUtensorMap and its enums; the encoder is reached
#include <cuda_runtime.h>       // through cudaGetDriverEntryPoint, so no -lcuda
#include <cuda_bf16.h>
#include <stdint.h>
#include <mutex>

namespace {

using bf16 = __nv_bfloat16;
constexpr float kNormEps = 1e-3f;   // AlphaFold's outer-product-mean epsilon

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// Hopper building blocks: mbarrier, TMA, wgmma, stmatrix
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A 4-byte asynchronous copy (zero fill where !ok), and an arrival on `bar`
// once this thread's earlier such copies have landed.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// A wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (in 16-byte units), swizzle mode (1 = 128 B, 2 = 64 B).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(swizzle) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pins accumulator registers around the asynchronous products, so that the
// compiler neither moves them nor reads them before wgmma_wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2,
                                            uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The consumer warpgroups' own barrier (id 1; __syncthreads is id 0).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// wgmma.mma_async m64nNk16, fp32 += bf16 x bf16, A and B from shared memory
// through descriptors; TA / TB = 1: the operand is MN-major (transposed).

// D (64 x 256, fp32, 128 registers a thread) += A * B, both from shared memory.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// D (64 x 128, fp32, 64 registers a thread) += A * B, both from shared memory.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// D (64 x 64, fp32, 32 registers a thread) += A * B, both from shared memory.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// D (64 x 32, fp32, 16 registers a thread) += A * B, both from shared memory.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}


// ---------------------------------------------------------------------------
// bf16: wgmma
// ---------------------------------------------------------------------------

constexpr int kTI = 8, kTJ = 8, kP = kTI * kTJ;   // a tile: 8 x 8 pixels
constexpr int kST = 32;                           // s rows a stage
constexpr int kConsumers = 256;                   // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;        // and the producer's warpgroup
constexpr int kRowB = 128;                        // bytes of a swizzled row (64 bf16)
constexpr int kBlockB = 64 * kRowB;               // a 64-row block of ov or w

template <int C, int D>
struct OpmGeo {
  static_assert((C == 16 || C == 32) && (D == 32 || D == 128), "widths");
  static constexpr int TIS = 128 / C;           // i of a sub-tile (M = 128)
  static constexpr int NSUB = kTI / TIS;        // sub-tiles a tile
  static constexpr int NPS = TIS * kTJ;         // pixels a sub-tile
  static constexpr int NOP = kTJ * C;           // N of the outer product
  static constexpr int NBOX = NOP / 64;         // b boxes a stage
  static constexpr int G8 = C / 8;              // channel groups of 8
  static constexpr int NKB = G8 * G8;           // ov blocks = w chunks
  static constexpr int PWG = D == 128 ? 2 : 1;  // projecting warpgroups
  static constexpr int PN = D / PWG;            // their N
  static constexpr int WBOX = D == 128 ? 64 : 32;   // d a w box (128 / 64 B rows)
  static constexpr int WROWB = WBOX * 2;
  static constexpr int NWB = D / WBOX;
  static constexpr int AB_BYTES = 2 * kST * kRowB + NBOX * kST * kRowB;
  static constexpr int MASKS = kST * (TIS + kTJ);   // floats a stage
  static constexpr int W_BYTES = NWB * 64 * WROWB;
  static_assert(W_BYTES <= AB_BYTES, "a w chunk must not cover the staged masks");
  static constexpr int SLOT = (AB_BYTES + MASKS * 4 + 1023) / 1024 * 1024;
  static constexpr int NSLOT = C == 32 ? 3 : 4;
  static constexpr int OV_BYTES = NKB * kBlockB;
  static constexpr int SMEM = 1024 + OV_BYTES + NSLOT * SLOT + (kP + D) * 4 + 2 * NSLOT * 8;
  static constexpr int MPL = MASKS / 32;        // mask floats a producer lane copies
  static_assert(MASKS % 32 == 0 && SMEM <= 232448, "shared memory");
};

template <int C, int D>
__global__ void __launch_bounds__(kThreads, 1)
outer_product_mean_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                                const __grid_constant__ CUtensorMap map_b,
                                const __grid_constant__ CUtensorMap map_w,
                                const float* __restrict__ mask_a,
                                const float* __restrict__ mask_b,
                                const float* __restrict__ bias, bf16* __restrict__ out, int nb,
                                int ns, int ni, int nj) {
  using G = OpmGeo<C, D>;
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte alignment, which the 128-byte swizzle's 8-row pattern needs.
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t ov = smem_addr(smem);
  const uint32_t ring = ov + G::OV_BYTES;
  unsigned char* ring_p = smem + G::OV_BYTES;
  float* inv_s = reinterpret_cast<float*>(ring_p + G::NSLOT * G::SLOT);   // [kP]
  float* bias_s = inv_s + kP;                                            // [D]
  const uint32_t full = smem_addr(bias_s + D);                           // [NSLOT] mbarriers
  const uint32_t empty = full + 8 * G::NSLOT;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int k = 0; k < G::NSLOT; ++k) {
      mbar_init(full + 8 * k, 33);    // the producer lanes' 32 arrivals + expect_tx
      mbar_init(empty + 8 * k, 8);    // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int ntj = (nj + kTJ - 1) / kTJ, nti = (ni + kTI - 1) / kTI;
  const int ntiles = nb * nti * ntj;
  const int nst = (ns + kST - 1) / kST;

  if (warp >= 8) {
    // ------------------------------------------------------------- producer
    // Its warpgroup gives registers to the consumers' accumulators.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    if (warp != 8) return;
    uint32_t n = 0;   // ring position
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int tj = tile % ntj, rest = tile / ntj, ti = rest % nti, b = rest / nti;
      const int i0 = ti * kTI, j0 = tj * kTJ;
      for (int sub = 0; sub < G::NSUB; ++sub) {
        const int is0 = i0 + sub * G::TIS;
        for (int st = 0; st < nst; ++st, ++n) {
          const int s0 = st * kST;
          const uint32_t slot = n % G::NSLOT;
          mbar_wait(empty + 8 * slot, ((n / G::NSLOT) & 1) ^ 1);
          const uint32_t dst = ring + slot * G::SLOT, bar = full + 8 * slot;
          if (lane == 0) {
            mbar_arrive_expect_tx(bar, G::AB_BYTES);
            tma_load_3d(dst, &map_a, bar, is0 * C, s0, b);
            tma_load_3d(dst + kST * kRowB, &map_a, bar, is0 * C + 64, s0, b);
#pragma unroll
            for (int k = 0; k < G::NBOX; ++k)
              tma_load_3d(dst + (2 + k) * kST * kRowB, &map_b, bar, j0 * C + 64 * k, s0, b);
          }
          // The masks of the stage's pixels, copied by the 32 lanes; the
          // barrier counts each lane's arrival once its copies landed.
          const uint32_t ms = dst + G::AB_BYTES;
#pragma unroll
          for (int k = 0; k < G::MPL; ++k) {
            const int e = lane + 32 * k;
            if (e < kST * G::TIS) {
              const int s = s0 + e / G::TIS, i = is0 + e % G::TIS;
              const bool ok = s < ns && i < ni;
              cp_async4(ms + 4 * e, ok ? mask_a + ((long long)b * ns + s) * ni + i : mask_a, ok);
            } else {
              const int e2 = e - kST * G::TIS, s = s0 + e2 / kTJ, j = j0 + e2 % kTJ;
              const bool ok = s < ns && j < nj;
              cp_async4(ms + 4 * e, ok ? mask_b + ((long long)b * ns + s) * nj + j : mask_b, ok);
            }
          }
          cp_async_arrive(bar);
        }
      }
      for (int k = 0; k < G::NKB; ++k, ++n) {
        const int kb = (k + tj) % G::NKB;   // staggered over the j tiles
        const uint32_t slot = n % G::NSLOT;
        mbar_wait(empty + 8 * slot, ((n / G::NSLOT) & 1) ^ 1);
        const uint32_t dst = ring + slot * G::SLOT, bar = full + 8 * slot;
        if (lane == 0) {
          mbar_arrive_expect_tx(bar, G::W_BYTES);
          // Rows (c1, c2) = (8 (kb / G8) + 0..7, 8 (kb % G8) + 0..7) of w,
          // c1 outer: the order of ov's block kb.
#pragma unroll
          for (int q = 0; q < G::NWB; ++q)
            tma_load_4d(dst + q * 64 * G::WROWB, &map_w, bar, q * G::WBOX, 0, kb % G::G8,
                        (kb / G::G8) * 8);
        }
        mbar_arrive(bar);
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
  const int wg = warp >> 2, wq = warp & 3, g8 = lane >> 2, tq = lane & 3;
  // The outer product: this thread's rows m = 64 wg + 16 wq + g8 (+ 8) are
  // (i, c1) with i = il_sub and c1 = 8 (c1g0 + h) + g8.
  const int il_sub = (64 * wg + 16 * wq) / C;
  const int c1g0 = ((16 * wq) % C) / 8;
  // The norm: pixel np of the sub-tile, summed over s = nu, nu + U, ...
  constexpr int U = kConsumers / G::NPS;
  const int np = tid / U, nu = tid % U, nil = np / kTJ, njl = np % kTJ;
  const bool proj = wg < G::PWG;
  for (int d = tid; d < D; d += kConsumers) bias_s[d] = bias[d];
  consumer_sync();

  uint32_t n = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int tj = tile % ntj, rest = tile / ntj, ti = rest % nti, b = rest / nti;
    const int i0 = ti * kTI, j0 = tj * kTJ;

#pragma unroll 1
    for (int sub = 0; sub < G::NSUB; ++sub) {
      float acc[G::NOP / 2];
      float nrm = 0.f;
      if (nst == 0) {
#pragma unroll
        for (int k = 0; k < G::NOP / 2; ++k) acc[k] = 0.f;
      }
      int prev = -1;
#pragma unroll 1
      for (int st = 0; st < nst; ++st, ++n) {
        const uint32_t slot = n % G::NSLOT;
        mbar_wait(full + 8 * slot, (n / G::NSLOT) & 1);
        const uint32_t base = ring + slot * G::SLOT;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < kST / 16; ++k) {
          // a: its 64-column box of this warpgroup; b: NBOX boxes of 64
          // columns, 32 rows of 128 B each. 16 rows of s a step.
          const uint64_t da = smem_desc(base + wg * kST * kRowB + k * 16 * kRowB,
                                        kST * kRowB, 8 * kRowB, 1);
          const uint64_t db = smem_desc(base + 2 * kST * kRowB + k * 16 * kRowB,
                                        kST * kRowB, 8 * kRowB, 1);
          if constexpr (C == 32) wgmma_m64n256k16<1, 1>(acc, da, db, st > 0 || k > 0);
          else wgmma_m64n128k16<1, 1>(acc, da, db, st > 0 || k > 0);
        }
        wgmma_commit();
        fence_regs(acc);
        const float* ms = reinterpret_cast<const float*>(ring_p + slot * G::SLOT + G::AB_BYTES);
#pragma unroll
        for (int s = nu; s < kST; s += U) nrm += ms[s * G::TIS + nil] * ms[kST * G::TIS + s * kTJ + njl];
        wgmma_wait<1>();
        fence_regs(acc);
        __syncwarp();
        if (prev >= 0 && lane == 0) mbar_arrive(empty + 8 * prev);
        prev = slot;
      }
      wgmma_wait<0>();
      fence_regs(acc);
      __syncwarp();
      if (prev >= 0 && lane == 0) mbar_arrive(empty + 8 * prev);

      // One reciprocal per pixel.
#pragma unroll
      for (int off = 1; off < U; off <<= 1) nrm += __shfl_xor_sync(0xffffffffu, nrm, off);
      if (nu == 0) inv_s[sub * G::NPS + np] = 1.f / (nrm + kNormEps);
      consumer_sync();

      // Scale, cast and store the fragments into ov. Matrix (nt, h) of this
      // thread: rows c1 = 8 (c1g0 + h) + 0..7, columns c2 = 8 (nt % G8) +
      // 0..7 of pixel (ilt, nt / G8): row g8 of a 128-byte row of block
      // kb = c1g * G8 + c2g, at chunk g8 ^ (pixel % 8).
      const int ilt = sub * G::TIS + il_sub;
      float iv[kTJ];
#pragma unroll
      for (int jl = 0; jl < kTJ; ++jl) iv[jl] = inv_s[ilt * kTJ + jl];
      const int mrow = lane & 7, msel = lane >> 3;
#pragma unroll
      for (int q4 = 0; q4 < G::NOP / 16; ++q4) {
        uint32_t r[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int mi = 4 * q4 + e, nt = mi >> 1, h = mi & 1;
          const float v = iv[nt / G::G8];
          r[e] = pack_bf16(acc[4 * nt + 2 * h] * v, acc[4 * nt + 2 * h + 1] * v);
        }
        const int mi = 4 * q4 + msel, nt = mi >> 1, h = mi & 1;
        const int jl = nt / G::G8, kb = (c1g0 + h) * G::G8 + nt % G::G8;
        const int p = ilt * kTJ + jl;
        stmatrix_x4(ov + kb * kBlockB + p * kRowB + ((mrow ^ jl) << 4), r[0], r[1], r[2], r[3]);
      }
    }
    // ov is complete and visible to the tensor cores' (async) reads.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    consumer_sync();

    // ------------------------------------------------- ov @ w, chunk by chunk
    float acc2[G::PN / 2];
    int prev = -1;
#pragma unroll 1
    for (int k = 0; k < G::NKB; ++k, ++n) {
      const int kb = (k + tj) % G::NKB;
      const uint32_t slot = n % G::NSLOT;
      mbar_wait(full + 8 * slot, (n / G::NSLOT) & 1);
      if (proj) {
        const uint32_t wbase = ring + slot * G::SLOT + wg * 64 * G::WROWB;
        fence_regs(acc2);
        wgmma_fence();
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          // ov block kb: K-major, 64 pixel rows of 128 B, 16 columns a step;
          // w: MN-major, 16 rows (c1, c2) a step.
          const uint64_t da = smem_desc(ov + kb * kBlockB + q * 32, 16, 8 * kRowB, 1);
          const uint64_t db = smem_desc(wbase + q * 16 * G::WROWB, 64 * G::WROWB,
                                        8 * G::WROWB, D == 128 ? 1 : 2);
          if constexpr (D == 128) wgmma_m64n64k16<0, 1>(acc2, da, db, k > 0 || q > 0);
          else wgmma_m64n32k16<0, 1>(acc2, da, db, k > 0 || q > 0);
        }
        wgmma_commit();
        fence_regs(acc2);
        wgmma_wait<1>();
        fence_regs(acc2);
      }
      __syncwarp();
      if (prev >= 0 && lane == 0) mbar_arrive(empty + 8 * prev);
      prev = slot;
    }
    wgmma_wait<0>();
    fence_regs(acc2);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * prev);

    if (proj) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = 16 * wq + g8 + 8 * h;   // pixel (p / 8, p % 8) of the tile
        const int i = i0 + p / kTJ, j = j0 + p % kTJ;
        if (i >= ni || j >= nj) continue;
        const int d0 = wg * G::PN + 2 * tq;
        bf16* o = out + (((long long)b * ni + i) * nj + j) * D + d0;
#pragma unroll
        for (int nt = 0; nt < G::PN / 8; ++nt) {
          const float2 bv = *reinterpret_cast<const float2*>(bias_s + d0 + 8 * nt);
          *reinterpret_cast<uint32_t*>(o + 8 * nt) =
              pack_bf16(acc2[4 * nt + 2 * h] + bv.x, acc2[4 * nt + 2 * h + 1] + bv.y);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: plain FMA loop (checks only)
// ---------------------------------------------------------------------------

constexpr int kFT = 4;              // 4 x 4 pixels per block
constexpr int kFS = 16;             // s rows per step
constexpr int kFThreads = 256;

template <int C>
constexpr int fma_smem_bytes() {
  return (2 * kFS * kFT * C + 2 * kFS * kFT + kFT * kFT * C * C + kFT * kFT) * 4;
}

template <int C, int D>
__global__ void __launch_bounds__(kFThreads)
outer_product_mean_fma_kernel(const float* __restrict__ a, const float* __restrict__ b,
                              const float* __restrict__ mask_a,
                              const float* __restrict__ mask_b, const float* __restrict__ w,
                              const float* __restrict__ bias, float* __restrict__ out, int ns,
                              int ni, int nj) {
  constexpr int P = kFT * kFT, Q = C * C, NQ = Q / kFThreads;
  constexpr int PPG = P * D / kFThreads;   // pixels per thread in the projection
  static_assert(Q % kFThreads == 0 && kFThreads % D == 0, "shape");
  extern __shared__ __align__(16) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);   // [kFS][kFT][C]
  float* Bs = As + kFS * kFT * C;
  float* Ma = Bs + kFS * kFT * C;               // [kFS][kFT]
  float* Mb = Ma + kFS * kFT;
  float* Ov = Mb + kFS * kFT;                   // [P][Q]
  float* Nrm = Ov + P * Q;
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * kFT, i0 = blockIdx.y * kFT;
  const long long bb = blockIdx.z;

  float acc[NQ][P];
#pragma unroll
  for (int n = 0; n < NQ; ++n)
#pragma unroll
    for (int p = 0; p < P; ++p) acc[n][p] = 0.f;
  float nrm = 0.f;

  for (int s0 = 0; s0 < ns; s0 += kFS) {
    for (int idx = tid; idx < kFS * kFT * C; idx += kFThreads) {
      const int cc = idx % C, rest = idx / C, r = rest % kFT, s = s0 + rest / kFT;
      As[idx] = (s < ns && i0 + r < ni) ? a[((bb * ns + s) * ni + i0 + r) * C + cc] : 0.f;
      Bs[idx] = (s < ns && j0 + r < nj) ? b[((bb * ns + s) * nj + j0 + r) * C + cc] : 0.f;
    }
    if (tid < kFS * kFT) {
      const int r = tid % kFT, s = s0 + tid / kFT;
      Ma[tid] = (s < ns && i0 + r < ni) ? mask_a[(bb * ns + s) * ni + i0 + r] : 0.f;
      Mb[tid] = (s < ns && j0 + r < nj) ? mask_b[(bb * ns + s) * nj + j0 + r] : 0.f;
    }
    __syncthreads();
    for (int s = 0; s < kFS; ++s) {
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        const int q = tid + kFThreads * n, c1 = q / C, c2 = q % C;
        float bv[kFT];
#pragma unroll
        for (int j = 0; j < kFT; ++j) bv[j] = Bs[(s * kFT + j) * C + c2];
#pragma unroll
        for (int i = 0; i < kFT; ++i) {
          const float av = As[(s * kFT + i) * C + c1];
#pragma unroll
          for (int j = 0; j < kFT; ++j) acc[n][i * kFT + j] = fmaf(av, bv[j], acc[n][i * kFT + j]);
        }
      }
    }
    if (tid < P)
      for (int s = 0; s < kFS; ++s) nrm += Ma[s * kFT + tid / kFT] * Mb[s * kFT + tid % kFT];
    __syncthreads();
  }
  if (tid < P) Nrm[tid] = nrm;
  __syncthreads();
#pragma unroll
  for (int n = 0; n < NQ; ++n)
#pragma unroll
    for (int p = 0; p < P; ++p) Ov[p * Q + tid + kFThreads * n] = acc[n][p] / (Nrm[p] + kNormEps);
  __syncthreads();

  const int d = tid % D, pg = tid / D;
  float z[PPG];
#pragma unroll
  for (int u = 0; u < PPG; ++u) z[u] = 0.f;
  for (int q = 0; q < Q; ++q) {
    const float wv = w[(long long)q * D + d];
#pragma unroll
    for (int u = 0; u < PPG; ++u) z[u] = fmaf(Ov[(pg * PPG + u) * Q + q], wv, z[u]);
  }
#pragma unroll
  for (int u = 0; u < PPG; ++u) {
    const int p = pg * PPG + u, i = i0 + p / kFT, j = j0 + p % kFT;
    if (i < ni && j < nj) out[((bb * ni + i) * nj + j) * D + d] = z[u] + bias[d];
  }
}

// ---------------------------------------------------------------------------
// Host: tensor maps and launches
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, found through the runtime once.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  static std::once_flag once;
  std::call_once(once, [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#endif
      fn = reinterpret_cast<EncodeTiled>(p);
  });
  return fn;
}

// A bf16 tiled tensor map, cached by everything that defines it: encoding
// is host work, and the main path hands the same weights (and, through the
// caching allocator, often the same activation addresses) call after call.
struct MapKey {
  const void* ptr;
  int rank, swizzle;
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4];
  bool operator==(const MapKey& o) const {
    if (ptr != o.ptr || rank != o.rank || swizzle != o.swizzle) return false;
    for (int k = 0; k < rank; ++k)
      if (dims[k] != o.dims[k] || box[k] != o.box[k] || (k + 1 < rank && strides[k] != o.strides[k]))
        return false;
    return true;
  }
};

constexpr int kMapCache = 32;
std::mutex map_mutex;
MapKey map_keys[kMapCache];
CUtensorMap map_vals[kMapCache];
int map_used = 0, map_next = 0;

bool tensor_map(CUtensorMap* out, const MapKey& key) {
  std::lock_guard<std::mutex> lock(map_mutex);
  for (int k = 0; k < map_used; ++k)
    if (map_keys[k] == key) {
      *out = map_vals[k];
      return true;
    }
  EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUresult r = enc(out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, key.rank, const_cast<void*>(key.ptr),
                         key.dims, key.strides, key.box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         static_cast<CUtensorMapSwizzle>(key.swizzle),
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return false;
  const int slot = map_used < kMapCache ? map_used++ : (map_next++ % kMapCache);
  map_keys[slot] = key;
  map_vals[slot] = *out;
  return true;
}

// A (rows, S, B) view of a (B, S, rows / C, C) tensor: 64-column boxes of
// kST rows of s, 128-byte swizzled.
bool rows_map(CUtensorMap* m, const void* p, int nb, int ns, long long cols) {
  MapKey k{};
  k.ptr = p;
  k.rank = 3;
  k.swizzle = CU_TENSOR_MAP_SWIZZLE_128B;
  k.dims[0] = cols;
  k.dims[1] = ns > 0 ? ns : 1;
  k.dims[2] = nb;
  k.strides[0] = cols * 2;
  k.strides[1] = cols * 2 * k.dims[1];
  k.box[0] = 64;
  k.box[1] = kST;
  k.box[2] = 1;
  return tensor_map(m, k);
}

template <int C, int D>
int launch_wgmma(cudaStream_t st, const void* a, const void* b, const void* ma, const void* mb,
                 const void* w, const void* bias, void* out, int nb, int ns, int ni, int nj) {
  using G = OpmGeo<C, D>;
  CUtensorMap map_a, map_b, map_w;
  MapKey kw{};
  // w (C^2, D) as (d, c2 % 8, c2 / 8, c1): a box is 8 c1 x 8 c2 rows.
  kw.ptr = w;
  kw.rank = 4;
  kw.swizzle = D == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  kw.dims[0] = D;
  kw.dims[1] = 8;
  kw.dims[2] = C / 8;
  kw.dims[3] = C;
  kw.strides[0] = D * 2;
  kw.strides[1] = 8 * D * 2;
  kw.strides[2] = C * D * 2;
  kw.box[0] = G::WBOX;
  kw.box[1] = 8;
  kw.box[2] = 1;
  kw.box[3] = 8;
  if (!rows_map(&map_a, a, nb, ns, (long long)ni * C) ||
      !rows_map(&map_b, b, nb, ns, (long long)nj * C) || !tensor_map(&map_w, kw))
    return (int)cudaErrorInvalidValue;

  static int sms[64] = {0};
  static bool attr[64] = {false};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!attr[dev]) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(outer_product_mean_wgmma_kernel<C, D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (err != cudaSuccess) return (int)err;
    attr[dev] = true;
  }
  const long long tiles =
      (long long)nb * ((ni + kTI - 1) / kTI) * ((nj + kTJ - 1) / kTJ);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int grid = (int)(tiles < sms[dev] ? tiles : sms[dev]);
  outer_product_mean_wgmma_kernel<C, D><<<grid, kThreads, G::SMEM, st>>>(
      map_a, map_b, map_w, static_cast<const float*>(ma), static_cast<const float*>(mb),
      static_cast<const float*>(bias), static_cast<bf16*>(out), nb, ns, ni, nj);
  return (int)cudaGetLastError();
}

template <int C, int D>
int launch_fma(cudaStream_t st, const void* a, const void* b, const void* ma, const void* mb,
               const void* w, const void* bias, void* out, int nb, int ns, int ni, int nj) {
  const int smem = fma_smem_bytes<C>();
  cudaError_t err = cudaFuncSetAttribute(outer_product_mean_fma_kernel<C, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nj + kFT - 1) / kFT, (ni + kFT - 1) / kFT, nb);
  outer_product_mean_fma_kernel<C, D><<<grid, kFThreads, smem, st>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<const float*>(ma),
      static_cast<const float*>(mb), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(out), ns, ni, nj);
  return (int)cudaGetLastError();
}

}  // namespace

// a: (B, S, I, C), b: (B, S, J, C), masked, contiguous. mask_a: (B, S, I),
// mask_b: (B, S, J) fp32 contiguous. w: (C*C, D) contiguous in a's dtype;
// bias: (D,) fp32. out: (B, I, J, D) contiguous in a's dtype. dtype: 0 =
// float32, 1 = bfloat16 (a, b, w 16-byte aligned). C in {16, 32}, D in
// {32, 128}. Returns the cudaError_t of the launch (cudaErrorInvalidValue
// where a tensor map cannot be encoded).
extern "C" int outer_product_mean_fwd(const void* a, const void* b, const void* mask_a,
                                      const void* mask_b, const void* w, const void* bias,
                                      void* out, int nb, int ns, int ni, int nj, int c, int d,
                                      int dtype, void* stream) {
  if (nb <= 0 || ni <= 0 || nj <= 0) return 0;
  if (ns < 0 || (dtype != 0 && dtype != 1) ||
      (dtype == 0 && (nb > 65535 || (ni + kFT - 1) / kFT > 65535)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define OPM_CASE(CC, DD)                                                                   \
  if (c == CC && d == DD)                                                                  \
    return dtype == 1                                                                      \
               ? launch_wgmma<CC, DD>(st, a, b, mask_a, mask_b, w, bias, out, nb, ns, ni, nj) \
               : launch_fma<CC, DD>(st, a, b, mask_a, mask_b, w, bias, out, nb, ns, ni, nj);
  OPM_CASE(16, 32)    // MINI
  OPM_CASE(16, 128)
  OPM_CASE(32, 32)
  OPM_CASE(32, 128)   // FULL
#undef OPM_CASE
  return (int)cudaErrorInvalidValue;
}
