// Flash-attention forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py, body `_flash_kernel`):
// out = softmax(scale * q k^T + bias + mask) v with an online softmax over KV
// tiles, returning out and the fp32 log-sum-exp. The (N, H, Sq, Skv) scores
// tensor never reaches device memory.
//
// Bound on the H100, bf16, at the Evoformer's shapes (S = 128..384, D = 32):
// one MSA-row call at r = 256 (N = 128, H = 8) does 8.6 GFLOP (0.009 ms at
// 989 TFLOP/s), 67 M exponentials (~0.018 ms at 16 a clock per SM) and
// moves 67 MB (0.020 ms at 3.35 TB/s). So bytes and exponentials bound it
// about equally, once the products run on tensor cores; what matters is the
// tensor cores themselves, copies that overlap the products, and reading the
// bias (shared by rep = N / B consecutive groups) once per block rather than
// once per group.
//
// Design of the bf16 kernel (flash_fwd_mma_kernel):
//  * one block of 4 warps per (64 query rows, head, G consecutive groups n of
//    one bias batch); each warp owns 16 rows;
//  * S = Q K^T and O += P V run on mma.sync m16n8k16 (bf16 in, fp32
//    accumulate). mma.sync rather than wgmma: at D = 32 each 64-key tile is
//    only 16 + 16 products per warp, and the kernel is bound by bytes and
//    exponentials, not by the rate of the products. Q's A fragments
//    are loaded from device memory once per group, one group ahead, and
//    stay in registers;
//    K's B fragments come from shared memory by ldmatrix, V's by
//    ldmatrix.trans;
//  * the online softmax works on the accumulator fragments: a row lives in
//    the 4 lanes of a quad, so its max takes two shuffles, and its sum is
//    kept per lane until the end. p = 2^((s - m) log2 e) by ex2.approx: the
//    difference is taken before the scaling by log2 e, so a row masked with
//    -1e9 (s = m exactly) gets p = 1 on every key, as in the reference;
//  * P is rounded to bf16 unnormalised (the reference's rounding point) and
//    used straight from registers as the A operand of P V: the m16n8 fp32
//    accumulator layout of two key tiles is the m16n8k16 A layout. The
//    scores never reach shared or device memory;
//  * K and V tiles of 64 keys, and the tile's key mask, are double-buffered
//    in shared memory by cp.async (16-byte copies; zero fill past Skv), so
//    the next tile's copy overlaps this tile's products; one barrier a tile;
//  * the block stages its (64 rows x Skv) bias slice once (cp.async, or
//    element loads when a row is not a multiple of 16 bytes) in dynamic
//    shared memory and runs its G groups over it: the bias's L2 traffic
//    falls by G. Up to 384 padded keys; the wrapper chooses G;
//  * kept from the first version: q/k/v read in the JAX layout (N, S, H, D)
//    through their N and S strides; -1e30 for keys past Skv; the sum
//    x * scale + bias + mask in fp32 in that order; out and lse written once.
// Above 384 padded keys (flash_fwd_mma_kernel_streamed, the r = 2048 sites)
// the slice is too wide to stage whole, and the block streams it instead:
//  * each KV tile's (64 rows x 64 keys) bias tile travels through the same
//    cp.async double buffer as the tile's K, V and key mask (16-byte copies,
//    zero fill past Sq and Skv; element loads where a row is not a multiple
//    of 16 bytes), in rows padded by 16 bytes so that a quad's 8 rows hit
//    distinct banks. No bias load from device memory sits in the score loop;
//  * the block holds G = 2 groups of one bias batch side by side, 4 warps
//    each, which read each staged bias tile at the same KV step: the bias's
//    L2 traffic halves. One stage holds G K, V and mask tiles and one bias
//    tile (30 KB at G 2, D 32), 60 KB double-buffered; at most 128 registers
//    a thread, so two such blocks (16 warps) fit an SM;
//  * bound at r = 2048 (N 2048, S 2048, H 4, D 32): 3.4e10 exponentials,
//    about 9.3 ms at 16 a clock per SM, against 4.45 ms of products and
//    about 69 GB of K and V re-read from L2 by the 64-row query blocks; but
//    a warp issues about 700 instructions per 64-key tile (its SASS), so the
//    issue rate alone bounds it near 26 ms, and the copies' addresses are
//    worked out once per block, not per tile;
//  * its tile (warp_tile) repeats the staged kernel's arithmetic, with the
//    roundings nvcc chose there pinned by intrinsics (s * scale + bias a
//    product and a sum on a tile's first 8 keys and one fma on the rest; l
//    rescaled and added to in one fma), so both kernels give the same bits.
// Rows past Sq load zeros and are not written. The wrapper guarantees that
// q, k, v and their N and S strides allow 16-byte copies (the launcher
// checks it too).
//
// The fp32 kernel (flash_fwd_fp32_kernel) stays scalar: on tensor cores fp32
// would run as TF32 and lose the 1e-4 tolerance. It serves the fp32 parity
// runs only: one thread per query row, K/V tiles of 32 keys staged as fp32.
// Both launch on the caller's stream, allocate nothing and do not
// synchronise.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// fp32: scalar FMA kernel
// ---------------------------------------------------------------------------

constexpr int kBQ = 128;  // query rows per block = threads per block
constexpr int kBK = 32;   // keys per staged KV tile

template <int D>
__global__ void __launch_bounds__(kBQ)
flash_fwd_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ bias,
                      const float* __restrict__ mask, float* __restrict__ out,
                      float* __restrict__ lse, long long q_sn, long long q_ss, long long k_sn,
                      long long k_ss, long long v_sn, long long v_ss, int sq, int skv, int nh,
                      int rep, float scale) {
  __shared__ __align__(16) float ks[kBK][D];
  __shared__ __align__(16) float vs[kBK][D];
  __shared__ float bs[kBQ][kBK + 1];  // +1: rows land in distinct banks
  __shared__ float ms[kBK];

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const long long n = blockIdx.z;
  const int row = q0 + tid;
  const bool active = row < sq;
  const bool has_bias = bias != nullptr;
  const bool has_mask = mask != nullptr;
  const float* bias_nh = has_bias ? bias + ((n / rep) * nh + h) * (long long)sq * skv : nullptr;

  float qr[D];
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = active ? q[n * q_sn + row * q_ss + (long long)h * D + d] : 0.f;
    acc[d] = 0.f;
  }
  float m = kNegInf;
  float l = 0.f;

  for (int j0 = 0; j0 < skv; j0 += kBK) {
    __syncthreads();  // the previous tile is no longer read
    for (int idx = tid; idx < kBK * D; idx += kBQ) {
      const int j = idx / D, d = idx % D;
      const int kv = j0 + j;
      const bool ok = kv < skv;
      ks[j][d] = ok ? k[n * k_sn + kv * k_ss + (long long)h * D + d] : 0.f;
      vs[j][d] = ok ? v[n * v_sn + kv * v_ss + (long long)h * D + d] : 0.f;
    }
    if (has_bias) {
      for (int idx = tid; idx < kBQ * kBK; idx += kBQ) {
        const int r = idx / kBK, c = idx % kBK;
        const int qrow = q0 + r, kv = j0 + c;
        bs[r][c] = (qrow < sq && kv < skv) ? bias_nh[(long long)qrow * skv + kv] : 0.f;
      }
    }
    if (has_mask && tid < kBK) {
      const int kv = j0 + tid;
      ms[tid] = kv < skv ? mask[n * skv + kv] : 0.f;
    }
    __syncthreads();
    if (!active) continue;

    float s[kBK];
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(&ks[j][d]);
        dot = fmaf(qr[d], kk.x, dot);
        dot = fmaf(qr[d + 1], kk.y, dot);
        dot = fmaf(qr[d + 2], kk.z, dot);
        dot = fmaf(qr[d + 3], kk.w, dot);
      }
      float sj = dot * scale;
      if (has_bias) sj += bs[tid][j];
      if (has_mask) sj += ms[j];
      if (j0 + j >= skv) sj = kNegInf;
      s[j] = sj;
      tile_max = fmaxf(tile_max, sj);
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float p = expf(s[j] - m_new);
      l += p;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(&vs[j][d]);
        acc[d] = fmaf(p, vv.x, acc[d]);
        acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
        acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
        acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
      }
    }
    m = m_new;
  }

  if (active) {
    const float lc = fmaxf(l, 1e-30f);
    const float inv = 1.f / lc;
    float* orow = out + ((n * sq + row) * nh + h) * (long long)D;
#pragma unroll
    for (int d = 0; d < D; ++d) orow[d] = acc[d] * inv;
    lse[(n * nh + h) * sq + row] = m + logf(lc);
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kRows = 64;         // query rows per block (per group when streamed), 16 a warp
constexpr int kKeys = 64;         // keys per staged KV tile
constexpr int kThreads = 128;
constexpr int kMaxStaged = 384;   // widest bias slice (padded keys) a block stages
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct FwdTile {
  static constexpr int kRow = D + 8;            // bf16 per staged K/V row; the 16 extra
                                                // bytes put ldmatrix's 8 rows in distinct banks
  static constexpr int kElems = kKeys * kRow;   // bf16 per staged K or V tile
  static constexpr int kFixedBytes = 4 * kElems * 2 + 2 * kKeys * 4;  // K, V x 2; mask x 2
};

// d += a (16x16, row-major) * b (16x8, col-major); bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// 16-byte / 4-byte asynchronous copies; ok = false writes zeros instead.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The m16n8k16 A fragments of 16 rows of a (rows, D) bf16 matrix with the
// given row stride, straight from device memory: this lane's rows r0 and
// r0 + 8, columns 2t, 2t + 1 (+ 8) of each 16-wide k chunk. Rows at or past
// `rows` are zero.
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[D / 16][4], const bf16* base,
                                             long long row_stride, int r0, int rows, int t) {
  const bool ok0 = r0 < rows, ok1 = r0 + 8 < rows;
  const bf16* p0 = base + (ok0 ? (long long)r0 * row_stride : 0) + 2 * t;
  const bf16* p1 = base + (ok1 ? (long long)(r0 + 8) * row_stride : 0) + 2 * t;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    a[kc][0] = ok0 ? __ldg(reinterpret_cast<const unsigned int*>(p0 + 16 * kc)) : 0u;
    a[kc][1] = ok1 ? __ldg(reinterpret_cast<const unsigned int*>(p1 + 16 * kc)) : 0u;
    a[kc][2] = ok0 ? __ldg(reinterpret_cast<const unsigned int*>(p0 + 16 * kc + 8)) : 0u;
    a[kc][3] = ok1 ? __ldg(reinterpret_cast<const unsigned int*>(p1 + 16 * kc + 8)) : 0u;
  }
}

// One warp's 16 rows against one staged 64-key tile of the streamed kernel:
// S = Q K^T, then x = s * scale + bias + mask in fp32, in that order (keys
// past Skv -1e30), the online softmax update of (m, l, o), and O += P V.
// kt, vt: the tile's K and V; mt: its key mask or NULL; b0, b1: this lane's
// two rows of the staged bias tile.
template <int D>
__device__ __forceinline__ void warp_tile(const uint32_t (&qa)[D / 16][4], const bf16* kt,
                                          const bf16* vt, const float* mt, const bf16* b0,
                                          const bf16* b1, int j0, int skv, float scale,
                                          float (&o)[D / 8][4], float (&m)[2], float (&l)[2],
                                          int lane) {
  using T = FwdTile<D>;
  const int t = lane & 3;
  // S = Q K^T: this warp's 16 rows against the tile's 64 keys, as 8 n-tiles.
  float s[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int jp = 0; jp < 4; ++jp) {
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t b[4];
      ldmatrix_x4(b, kt + (16 * jp + (lane & 7) + ((lane >> 4) << 3)) * T::kRow + 16 * kc +
                         (((lane >> 3) & 1) << 3));
      mma_bf16(s[2 * jp], qa[kc], b[0], b[1]);
      mma_bf16(s[2 * jp + 1], qa[kc], b[2], b[3]);
    }
  }

  // x = s * scale + bias + mask in fp32, in that order; keys past Skv -1e30.
  // s * scale + bias is rounded as nvcc compiles the staged kernel's sum:
  // the tile's first 8 keys as a product, then a sum; the rest as one fma.
  // So the two kernels give the same bits.
  const bool ragged = j0 + kKeys > skv;
  float mx0 = m[0], mx1 = m[1];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * t;  // this lane's first column in the tile
    const float2 x0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b0 + c));
    const float2 x1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b1 + c));
    const float xb[4] = {x0.x, x0.y, x1.x, x1.y};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[j][e] = j == 0 ? __fadd_rn(__fmul_rn(s[j][e], scale), xb[e])
                       : __fmaf_rn(s[j][e], scale, xb[e]);
    if (mt != nullptr) {
      const float2 mm = *reinterpret_cast<const float2*>(mt + c);
      s[j][0] += mm.x;
      s[j][1] += mm.y;
      s[j][2] += mm.x;
      s[j][3] += mm.y;
    }
    if (ragged) {
      if (j0 + c >= skv) s[j][0] = s[j][2] = kNegInf;
      if (j0 + c + 1 >= skv) s[j][1] = s[j][3] = kNegInf;
    }
    mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
    mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
  }

  // Online softmax on the fragments: a row's 64 values lie in one quad.
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);
  const float a0 = exp2_approx((m[0] - mx0) * kLog2e);
  const float a1 = exp2_approx((m[1] - mx1) * kLog2e);
  m[0] = mx0;
  m[1] = mx1;
#pragma unroll
  for (int d = 0; d < D / 8; ++d) {
    o[d][0] *= a0;
    o[d][1] *= a0;
    o[d][2] *= a1;
    o[d][3] *= a1;
  }
  // P, unnormalised and rounded to bf16, as the A fragments of 4 key chunks:
  // n-tiles 2kk and 2kk + 1 of S are chunk kk's (a0, a1) and (a2, a3). The
  // sum l is rescaled and takes the first chunk's p in one fma, as in the
  // staged kernel's compiled code.
  uint32_t pa[4][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float p0 = exp2_approx((s[j][0] - mx0) * kLog2e);
    const float p1 = exp2_approx((s[j][1] - mx0) * kLog2e);
    const float p2 = exp2_approx((s[j][2] - mx1) * kLog2e);
    const float p3 = exp2_approx((s[j][3] - mx1) * kLog2e);
    l[0] = j == 0 ? __fmaf_rn(l[0], a0, p0 + p1) : __fadd_rn(l[0], p0 + p1);
    l[1] = j == 0 ? __fmaf_rn(l[1], a1, p2 + p3) : __fadd_rn(l[1], p2 + p3);
    pa[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
    pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
  }

  // O += P V: V's B fragments by ldmatrix.trans, two d n-tiles at a time.
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, vt + (16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3)) * T::kRow +
                               16 * dp + ((lane >> 4) << 3));
      mma_bf16(o[2 * dp], pa[kk], b[0], b[1]);
      mma_bf16(o[2 * dp + 1], pa[kk], b[2], b[3]);
    }
  }
}

// A group's out and lse for this lane's rows row0 and row0 + 8 (those past
// Sq are not written), after its last tile.
template <int D>
__device__ __forceinline__ void write_rows(const float (&o)[D / 8][4], const float (&m)[2],
                                           const float (&l)[2], bf16* __restrict__ out,
                                           float* __restrict__ lse, long long n, int row0,
                                           int sq, int nh, int h, int t) {
  const int row1 = row0 + 8;
  const float l0 = fmaxf(quad_sum(l[0]), 1e-30f);
  const float l1 = fmaxf(quad_sum(l[1]), 1e-30f);
  const float i0 = 1.f / l0, i1 = 1.f / l1;
  if (row0 < sq) {
    bf16* orow = out + ((n * sq + row0) * nh + h) * (long long)D + 2 * t;
#pragma unroll
    for (int d = 0; d < D / 8; ++d)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * d) =
          __floats2bfloat162_rn(o[d][0] * i0, o[d][1] * i0);
    if (t == 0) lse[(n * nh + h) * sq + row0] = m[0] + logf(l0);
  }
  if (row1 < sq) {
    bf16* orow = out + ((n * sq + row1) * nh + h) * (long long)D + 2 * t;
#pragma unroll
    for (int d = 0; d < D / 8; ++d)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * d) =
          __floats2bfloat162_rn(o[d][2] * i1, o[d][3] * i1);
    if (t == 0) lse[(n * nh + h) * sq + row1] = m[1] + logf(l1);
  }
}

// A bias slice of at most kMaxStaged padded keys, or none.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ bias,
                     const float* __restrict__ mask, bf16* __restrict__ out,
                     float* __restrict__ lse, long long q_sn, long long q_ss, long long k_sn,
                     long long k_ss, long long v_sn, long long v_ss, int sq, int skv, int nh,
                     int rep, int groups, int bias_vec, float scale) {
  using T = FwdTile<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);                  // [2][kKeys][kRow]
  bf16* vs = ks + 2 * T::kElems;                             // [2][kKeys][kRow]
  float* ms = reinterpret_cast<float*>(vs + 2 * T::kElems);  // [2][kKeys]
  bf16* bs = reinterpret_cast<bf16*>(ms + 2 * kKeys);        // [kRows][bstride]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kRows, h = blockIdx.y;
  const long long n0 = (long long)blockIdx.z * groups;
  const int ntiles = (skv + kKeys - 1) / kKeys;
  const int skv_pad = ntiles * kKeys;
  const int bstride = skv_pad + 8;  // 16 extra bytes: a quad's 8 rows hit distinct banks
  const bool has_bias = bias != nullptr, has_mask = mask != nullptr;
  const bf16* bias_h = has_bias ? bias + ((n0 / rep) * nh + h) * (long long)sq * skv : nullptr;
  const int wr = warp * 16 + g;  // this lane's first row in the block; the second is wr + 8
  const int row0 = q0 + wr, row1 = row0 + 8;

  // Copy K, V and the mask of iteration `it` (group it / ntiles, tile
  // it % ntiles) into stage it % 2.
  auto load_tile = [&](int it) {
    const int gi = it / ntiles;
    const int j0 = (it - gi * ntiles) * kKeys;
    const long long n = n0 + gi;
    const int st = it & 1;
    constexpr int kChunks = D / 8;  // 16-byte chunks per row
    bf16* kd = ks + st * T::kElems;
    bf16* vd = vs + st * T::kElems;
    for (int c = tid; c < kKeys * kChunks; c += kThreads) {
      const int r = c / kChunks, cc = (c % kChunks) * 8;
      const int key = j0 + r;
      const bool ok = key < skv;
      const long long kr = ok ? key : 0;
      cp_async16(kd + r * T::kRow + cc, k + n * k_sn + kr * k_ss + (long long)h * D + cc, ok);
      cp_async16(vd + r * T::kRow + cc, v + n * v_sn + kr * v_ss + (long long)h * D + cc, ok);
    }
    if (has_mask && tid < kKeys) {
      const int key = j0 + tid;
      const bool ok = key < skv;
      cp_async4(ms + st * kKeys + tid, mask + n * skv + (ok ? key : 0), ok);
    }
  };

  // The bias slice, once for all G groups: zero past Sq and Skv.
  if (has_bias) {
    if (bias_vec) {
      const int cpr = skv_pad / 8;
      for (int c = tid; c < kRows * cpr; c += kThreads) {
        const int r = c / cpr, col = (c - r * cpr) * 8;
        const bool ok = q0 + r < sq && col < skv;  // skv % 8 == 0: a chunk is all in or out
        cp_async16(bs + r * bstride + col, bias_h + (ok ? (long long)(q0 + r) * skv + col : 0),
                   ok);
      }
    } else {
      for (int e = tid; e < kRows * skv_pad; e += kThreads) {
        const int r = e / skv_pad, col = e - r * skv_pad;
        bs[r * bstride + col] = (q0 + r < sq && col < skv)
                                    ? bias_h[(long long)(q0 + r) * skv + col]
                                    : __float2bfloat16(0.f);
      }
    }
  }
  load_tile(0);
  cp_async_commit();

  // A group's Q fragments are loaded one group ahead, so that their latency
  // hides behind the previous group's tiles.
  uint32_t qa[D / 16][4], nqa[D / 16][4];
  float o[D / 8][4];
  float m[2], l[2];
  const int total = groups * ntiles;
  load_a_frags<D>(nqa, q + n0 * q_sn + (long long)h * D, q_ss, row0, sq, t);
  for (int it = 0; it < total; ++it) {
    const int gi = it / ntiles;
    const int tile = it - gi * ntiles;
    const int j0 = tile * kKeys;
    const long long n = n0 + gi;
    const int st = it & 1;
    cp_async_wait<0>();  // this iteration's tile (and the bias slice) has landed,
    __syncthreads();     // and every warp is done with the previous one,
    if (it + 1 < total) load_tile(it + 1);  // whose stage the next copy refills
    cp_async_commit();

    if (tile == 0) {
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc)
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[kc][e] = nqa[kc][e];
      if (gi + 1 < groups)
        load_a_frags<D>(nqa, q + (n + 1) * q_sn + (long long)h * D, q_ss, row0, sq, t);
#pragma unroll
      for (int d = 0; d < D / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
      m[0] = m[1] = kNegInf;
      l[0] = l[1] = 0.f;
    }

    // S = Q K^T: this warp's 16 rows against the tile's 64 keys, as 8 n-tiles.
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    const bf16* kt = ks + st * T::kElems;
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        uint32_t b[4];
        ldmatrix_x4(b, kt + (16 * jp + (lane & 7) + ((lane >> 4) << 3)) * T::kRow + 16 * kc +
                           (((lane >> 3) & 1) << 3));
        mma_bf16(s[2 * jp], qa[kc], b[0], b[1]);
        mma_bf16(s[2 * jp + 1], qa[kc], b[2], b[3]);
      }
    }

    // x = s * scale + bias + mask in fp32, in that order; keys past Skv -1e30.
    const float* mt = ms + st * kKeys;
    const bool ragged = j0 + kKeys > skv;
    float mx0 = m[0], mx1 = m[1];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * t;  // this lane's first column in the tile
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= scale;
      if (has_bias) {
        const float2 b0 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(bs + wr * bstride + j0 + c));
        const float2 b1 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(bs + (wr + 8) * bstride + j0 + c));
        s[j][0] += b0.x;
        s[j][1] += b0.y;
        s[j][2] += b1.x;
        s[j][3] += b1.y;
      }
      if (has_mask) {
        const float2 mm = *reinterpret_cast<const float2*>(mt + c);
        s[j][0] += mm.x;
        s[j][1] += mm.y;
        s[j][2] += mm.x;
        s[j][3] += mm.y;
      }
      if (ragged) {
        if (j0 + c >= skv) s[j][0] = s[j][2] = kNegInf;
        if (j0 + c + 1 >= skv) s[j][1] = s[j][3] = kNegInf;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }

    // Online softmax on the fragments: a row's 64 values lie in one quad.
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float a0 = exp2_approx((m[0] - mx0) * kLog2e);
    const float a1 = exp2_approx((m[1] - mx1) * kLog2e);
    m[0] = mx0;
    m[1] = mx1;
    l[0] *= a0;
    l[1] *= a1;
#pragma unroll
    for (int d = 0; d < D / 8; ++d) {
      o[d][0] *= a0;
      o[d][1] *= a0;
      o[d][2] *= a1;
      o[d][3] *= a1;
    }
    // P, unnormalised and rounded to bf16, as the A fragments of 4 key chunks:
    // n-tiles 2kk and 2kk + 1 of S are chunk kk's (a0, a1) and (a2, a3).
    uint32_t pa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = exp2_approx((s[j][0] - mx0) * kLog2e);
      const float p1 = exp2_approx((s[j][1] - mx0) * kLog2e);
      const float p2 = exp2_approx((s[j][2] - mx1) * kLog2e);
      const float p3 = exp2_approx((s[j][3] - mx1) * kLog2e);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pa[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }

    // O += P V: V's B fragments by ldmatrix.trans, two d n-tiles at a time.
    const bf16* vt = vs + st * T::kElems;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vt + (16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3)) * T::kRow +
                                 16 * dp + ((lane >> 4) << 3));
        mma_bf16(o[2 * dp], pa[kk], b[0], b[1]);
        mma_bf16(o[2 * dp + 1], pa[kk], b[2], b[3]);
      }
    }

    if (tile == ntiles - 1) {  // the group's last tile: write out and lse once
      const float l0 = fmaxf(quad_sum(l[0]), 1e-30f);
      const float l1 = fmaxf(quad_sum(l[1]), 1e-30f);
      const float i0 = 1.f / l0, i1 = 1.f / l1;
      if (row0 < sq) {
        bf16* orow = out + ((n * sq + row0) * nh + h) * (long long)D + 2 * t;
#pragma unroll
        for (int d = 0; d < D / 8; ++d)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * d) =
              __floats2bfloat162_rn(o[d][0] * i0, o[d][1] * i0);
        if (t == 0) lse[(n * nh + h) * sq + row0] = m[0] + logf(l0);
      }
      if (row1 < sq) {
        bf16* orow = out + ((n * sq + row1) * nh + h) * (long long)D + 2 * t;
#pragma unroll
        for (int d = 0; d < D / 8; ++d)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * d) =
              __floats2bfloat162_rn(o[d][2] * i1, o[d][3] * i1);
        if (t == 0) lse[(n * nh + h) * sq + row1] = m[1] + logf(l1);
      }
    }
  }
}

// The streamed kernel's block: G groups of kRows query rows side by side, 4
// warps each. Its shared memory: two stages, each G K and V tiles, one
// (kRows x kKeys) bias tile and G key masks. At most 128 registers a thread,
// so that 16 warps fit an SM (above that, at G 2, one block does).
template <int D, int G>
struct StreamTile {
  static constexpr int kThreads = 128 * G;       // 4 warps of 16 rows a group
  static constexpr int kMinBlocks = 4 / G;       // blocks an SM: 16 warps
  static constexpr int kBRow = kKeys + 8;        // bf16 per staged bias row: +16 bytes, a
                                                 // quad's 8 rows hit distinct banks
  static constexpr int kKV = G * FwdTile<D>::kElems;  // bf16 of a stage's K (or V) tiles
  static constexpr int kStageBytes = 2 * kKV * 2 + kRows * kBRow * 2 + G * kKeys * 4;
  static constexpr int kBytes = 2 * kStageBytes;
};

// A bias slice wider than kMaxStaged padded keys: streamed a tile at a time,
// shared by G groups side by side.
template <int D, int G>
__global__ void __launch_bounds__(StreamTile<D, G>::kThreads, StreamTile<D, G>::kMinBlocks)
flash_fwd_mma_kernel_streamed(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const bf16* __restrict__ bias,
                              const float* __restrict__ mask, bf16* __restrict__ out,
                              float* __restrict__ lse, long long q_sn, long long q_ss,
                              long long k_sn, long long k_ss, long long v_sn, long long v_ss,
                              int sq, int skv, int nh, int rep, int bias_vec, float scale) {
  using T = FwdTile<D>;
  using S = StreamTile<D, G>;
  extern __shared__ __align__(16) unsigned char smem[];
  // Stage st: K [G][kKeys][kRow], V [G][kKeys][kRow], bias [kRows][kBRow],
  // mask [G][kKeys].
  auto stage_k = [&](int st) { return reinterpret_cast<bf16*>(smem + st * S::kStageBytes); };
  auto stage_b = [&](int st) { return stage_k(st) + 2 * S::kKV; };
  auto stage_m = [&](int st) { return reinterpret_cast<float*>(stage_b(st) + kRows * S::kBRow); };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int gi = warp >> 2;            // this warp's group in the block
  const int wr = (warp & 3) * 16 + g;  // this lane's first row in the block; the second is wr + 8
  const int q0 = blockIdx.x * kRows, h = blockIdx.y;
  const long long n0 = (long long)blockIdx.z * G, n = n0 + gi;
  const int row0 = q0 + wr;
  const int ntiles = (skv + kKeys - 1) / kKeys;
  const bool has_mask = mask != nullptr;
  const bf16* bias_h = bias + ((n0 / rep) * nh + h) * (long long)sq * skv;

  // A thread's copies are the same at every tile but for the tile's first
  // key, so their addresses are worked out once: a tile then costs a thread
  // a few instructions per 16-byte copy, not a loop of index arithmetic.
  constexpr int kChunks = D / 8;                                 // 16-byte chunks a K/V row
  constexpr int kKVCopies = G * kKeys * kChunks / S::kThreads;   // a thread's K (and V) chunks
  constexpr int kBCopies = kRows * (kKeys / 8) / S::kThreads;    // a thread's bias chunks
  static_assert(kKVCopies * S::kThreads == G * kKeys * kChunks, "K/V chunks split evenly");
  static_assert(kBCopies * S::kThreads == kRows * (kKeys / 8), "bias chunks split evenly");
  const bf16* ksrc[kKVCopies];
  const bf16* vsrc[kKVCopies];
  int kvdst[kKVCopies], kvkey[kKVCopies];
#pragma unroll
  for (int i = 0; i < kKVCopies; ++i) {
    const int r = (tid + i * S::kThreads) / kChunks;  // group * kKeys + key
    const int cc = (tid % kChunks) * 8, gg = r / kKeys;
    kvkey[i] = r - gg * kKeys;
    kvdst[i] = r * T::kRow + cc;
    ksrc[i] = k + (n0 + gg) * k_sn + kvkey[i] * k_ss + (long long)h * D + cc;
    vsrc[i] = v + (n0 + gg) * v_sn + kvkey[i] * v_ss + (long long)h * D + cc;
  }
  const bf16* bsrc[kBCopies];
  int bdst[kBCopies], bcol[kBCopies];
#pragma unroll
  for (int i = 0; i < kBCopies; ++i) {
    const int r = (tid + i * S::kThreads) / (kKeys / 8);
    bcol[i] = (tid % (kKeys / 8)) * 8;
    bdst[i] = r * S::kBRow + bcol[i];
    // A row past Sq is filled with zeros: its column limit is 0.
    bsrc[i] = bias_h + (q0 + r < sq ? (long long)(q0 + r) * skv + bcol[i] : 0);
    if (q0 + r >= sq) bcol[i] = skv;
  }
  const int mkey = tid % kKeys;  // threads under G * kKeys copy the masks
  const float* msrc = has_mask ? mask + (n0 + tid / kKeys) * skv + mkey : nullptr;

  // Copy tile `tile`'s K, V and mask of each group, and its bias tile, into
  // stage tile % 2: zero past Sq and Skv.
  auto load_tile = [&](int tile) {
    const int j0 = tile * kKeys, st = tile & 1;
    const long long kstep = (long long)j0 * k_ss, vstep = (long long)j0 * v_ss;
    bf16* kd = stage_k(st);
    bf16* vd = kd + S::kKV;
#pragma unroll
    for (int i = 0; i < kKVCopies; ++i) {
      const bool ok = j0 + kvkey[i] < skv;
      cp_async16(kd + kvdst[i], ok ? ksrc[i] + kstep : ksrc[i], ok);
      cp_async16(vd + kvdst[i], ok ? vsrc[i] + vstep : vsrc[i], ok);
    }
    bf16* bd = stage_b(st);
    if (bias_vec) {
#pragma unroll
      for (int i = 0; i < kBCopies; ++i) {
        const bool ok = j0 + bcol[i] < skv;  // skv % 8 == 0: a chunk is all in or out
        cp_async16(bd + bdst[i], ok ? bsrc[i] + j0 : bsrc[i], ok);
      }
    } else {
      for (int e = tid; e < kRows * kKeys; e += S::kThreads) {
        const int r = e / kKeys, col = e % kKeys;
        bd[r * S::kBRow + col] = (q0 + r < sq && j0 + col < skv)
                                     ? bias_h[(long long)(q0 + r) * skv + j0 + col]
                                     : __float2bfloat16(0.f);
      }
    }
    if (has_mask && tid < G * kKeys) {
      const bool ok = j0 + mkey < skv;
      cp_async4(stage_m(st) + tid, ok ? msrc + j0 : msrc, ok);
    }
  };

  load_tile(0);
  cp_async_commit();
  uint32_t qa[D / 16][4];
  load_a_frags<D>(qa, q + n * q_sn + (long long)h * D, q_ss, row0, sq, t);
  float o[D / 8][4];
#pragma unroll
  for (int d = 0; d < D / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  for (int tile = 0; tile < ntiles; ++tile) {
    const int st = tile & 1;
    cp_async_wait<0>();  // this tile has landed,
    __syncthreads();     // and every warp is done with the previous one,
    if (tile + 1 < ntiles) load_tile(tile + 1);  // whose stage the next copy refills
    cp_async_commit();
    const bf16* b0 = stage_b(st) + wr * S::kBRow;
    warp_tile<D>(qa, stage_k(st) + gi * T::kElems, stage_k(st) + S::kKV + gi * T::kElems,
                 has_mask ? stage_m(st) + gi * kKeys : nullptr, b0, b0 + 8 * S::kBRow,
                 tile * kKeys, skv, scale, o, m, l, lane);
  }
  write_rows<D>(o, m, l, out, lse, n, row0, sq, nh, h, t);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <int D>
int launch_fp32(const void* q, const void* k, const void* v, const void* bias, const void* mask,
                void* out, void* lse, long long q_sn, long long q_ss, long long k_sn,
                long long k_ss, long long v_sn, long long v_ss, int n, int sq, int skv, int nh,
                int rep, float scale, cudaStream_t st) {
  const dim3 grid((sq + kBQ - 1) / kBQ, nh, n);
  flash_fwd_fp32_kernel<D><<<grid, kBQ, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(bias), static_cast<const float*>(mask),
      static_cast<float*>(out), static_cast<float*>(lse), q_sn, q_ss, k_sn, k_ss, v_sn, v_ss,
      sq, skv, nh, rep, scale);
  return (int)cudaGetLastError();
}

template <int D, int G>
int launch_streamed(const void* q, const void* k, const void* v, const void* bias,
                    const void* mask, void* out, void* lse, long long q_sn, long long q_ss,
                    long long k_sn, long long k_ss, long long v_sn, long long v_ss, int n, int sq,
                    int skv, int nh, int rep, float scale, cudaStream_t st) {
  using S = StreamTile<D, G>;
  static_assert(S::kBytes <= 227 * 1024, "a block's shared memory is at most 227 KB");
  if (S::kBytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(flash_fwd_mma_kernel_streamed<D, G>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 S::kBytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int bias_vec = skv % 8 == 0 && aligned16(bias);
  const dim3 grid((sq + kRows - 1) / kRows, nh, n / G);
  flash_fwd_mma_kernel_streamed<D, G><<<grid, S::kThreads, S::kBytes, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(bias), static_cast<const float*>(mask), static_cast<bf16*>(out),
      static_cast<float*>(lse), q_sn, q_ss, k_sn, k_ss, v_sn, v_ss, sq, skv, nh, rep, bias_vec,
      scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const void* bias, const void* mask,
                void* out, void* lse, long long q_sn, long long q_ss, long long k_sn,
                long long k_ss, long long v_sn, long long v_ss, int n, int sq, int skv, int nh,
                int rep, int groups, float scale, cudaStream_t st) {
  const int skv_pad = (skv + kKeys - 1) / kKeys * kKeys;
  const bool staged = bias != nullptr && skv_pad <= kMaxStaged;
  const bool streamed = bias != nullptr && !staged;
  if (groups < 1 || n % groups != 0 || rep % groups != 0 || (!staged && !streamed && groups != 1))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) ||
      (q_sn | q_ss | k_sn | k_ss | v_sn | v_ss) % 8 != 0)
    return (int)cudaErrorMisalignedAddress;
  if (streamed) {
#define STREAMED_CASE(GG)                                                                     \
  case GG:                                                                                    \
    return launch_streamed<D, GG>(q, k, v, bias, mask, out, lse, q_sn, q_ss, k_sn, k_ss, v_sn, \
                                  v_ss, n, sq, skv, nh, rep, scale, st);
    switch (groups) {
      STREAMED_CASE(1)
      STREAMED_CASE(2)
      default:
        return (int)cudaErrorInvalidValue;
    }
#undef STREAMED_CASE
  }
  const int bias_vec = staged && skv % 8 == 0 && aligned16(bias);
  const size_t bytes =
      FwdTile<D>::kFixedBytes + (staged ? (size_t)kRows * (skv_pad + 8) * sizeof(bf16) : 0);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((sq + kRows - 1) / kRows, nh, n / groups);
  flash_fwd_mma_kernel<D><<<grid, kThreads, bytes, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(bias), static_cast<const float*>(mask), static_cast<bf16*>(out),
      static_cast<float*>(lse), q_sn, q_ss, k_sn, k_ss, v_sn, v_ss, sq, skv, nh, rep, groups,
      bias_vec, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: (N, S, H, D) with unit D stride and H stride D; the N and S strides
// are given in elements. bias: (N/rep, H, Sq, Skv) contiguous, or NULL. mask:
// (N, Skv) fp32 contiguous, or NULL. out: (N, Sq, H, D) contiguous; lse:
// (N, H, Sq) fp32. dtype: 0 = float32, 1 = bfloat16 (q, k, v, bias, out).
// groups (bf16 only): consecutive groups n per block, dividing rep and N:
// with a bias slice up to 384 padded keys any such G (run one after
// another over the staged slice), with a wider one 1 or 2 (run side by side
// over each streamed bias tile), without a bias 1; in bf16, q, k, v
// and their N and S strides must allow 16-byte copies.
// Returns the cudaError_t of the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* bias, const void* mask, void* out, void* lse,
                                   long long q_sn, long long q_ss, long long k_sn,
                                   long long k_ss, long long v_sn, long long v_ss, int n,
                                   int sq, int skv, int nh, int d, int rep, int groups,
                                   float scale, int dtype, void* stream) {
  if (n <= 0 || sq <= 0) return 0;
  if (skv <= 0 || nh > 65535 || n > 65535 || rep <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_CASE(DD)                                                                         \
  case DD:                                                                                     \
    return dtype == 0 ? launch_fp32<DD>(q, k, v, bias, mask, out, lse, q_sn, q_ss, k_sn, k_ss, \
                                        v_sn, v_ss, n, sq, skv, nh, rep, scale, st)            \
                      : launch_bf16<DD>(q, k, v, bias, mask, out, lse, q_sn, q_ss, k_sn, k_ss, \
                                        v_sn, v_ss, n, sq, skv, nh, rep, groups, scale, st);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  switch (d) {
    FLASH_CASE(16)  // MINI
    FLASH_CASE(32)  // FULL
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FLASH_CASE
}
