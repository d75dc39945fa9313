// Fused triangular multiplicative update, for Hopper (sm_90a).
//
// Replaces the TPU kernel `fused_triangle_pallas`
// (src/repro/kernels/triangle.py, body `_tri_kernel`):
//   a   = (a_lin * sigmoid(ga)).to(dt) * mask
//   o   = sum_k a[i,k,:] * b[j,k,:]                       fp32, per channel
//   y   = LN_C(o) * gamma + beta, cast to dt               fp32 two-pass stats
//   out = sigmoid(g_lin + g_bias) * (y @ w_out + b_out)    fp32, one cast
// plus the LN mean and inv (rsqrt(var + eps)) of every pixel in fp32, which
// the recompute backward reads. The (B, I, J, C) fp32 product never reaches
// device memory: it lives in registers, then in shared memory for the
// epilogue.
//
// Bound on the H100, FULL widths (C = D = 128, bf16, I = J = K = r): the
// function reads a_lin, ga, b (3 r^2 C bf16), g_lin (r^2 D bf16) and the
// fp32 mask, and writes out (r^2 D bf16), mean and inv (fp32): about 85 MB
// at r = 256, 0.025 ms at 3.35 TB/s, and 190 MB, 0.057 ms, at r = 384. Its
// 2 r^3 C + 2 r^2 C D operations (6.4 GFLOP at r = 256) take 0.0065 ms at
// 989 TFLOP/s. So bytes bound it, and the design keeps every intermediate
// on chip; what it pays instead is re-reading the a and b rows once per
// output tile (from L2) and gating a again for every j tile.
//
// Design (bf16):
//  * one block of 16 warps per 16 x 16 output pixels; a loop inside the
//    block over k in steps of 16 takes the place of the TPU grid's
//    sequential k axis;
//  * each step stages the gated, masked a tile and the b tile in shared
//    memory transposed to [channel][row][k], so that for every channel the
//    tile is a 16 x 16 row-major matrix: the per-channel product
//    o_c = A_c B_c^T is then mma.sync m16n8k16 (bf16 in, fp32 accumulate),
//    two of them per channel per step; each warp owns C/16 channels and
//    keeps their 16 x 16 fp32 sums in registers;
//  * staging is bound by the instructions it runs, not by loads: each thread takes
//    4 consecutive k of 8 channels, gates them in fp32 with the fast
//    exponent and reciprocal (the result is rounded to bf16 anyway), and
//    writes each channel's 4 k as one 8-byte store; the padding of the
//    staged tiles makes those stores conflict-free;
//  * epilogue: the sums go to shared memory as [pixel][C] fp32; one warp
//    per pixel row takes two-pass LN statistics over C with shuffles and
//    writes y in bf16 over its own row; then y (256 x C) @ w_out (C x D)
//    runs on mma.sync again with w_out staged transposed, and the bias,
//    the output gate and the one cast are applied to the fragments before
//    they are stored.
// The fp32 instantiation is a plain FMA loop with the same arithmetic (no
// TF32), for the fp32 checks; it is not the timed path.
// Ragged I, J and K are masked: rows past I or J and columns past K stage
// zeros, and pixels past I or J are not written. A pixel whose a row is all
// masked gets LN of a zero vector, (0 - 0) * rsqrt(eps), as the plain
// version does. The kernel launches on the caller's stream, allocates
// nothing and does not synchronise.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float bf2f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float sigmoid_exact(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a (16x16, row-major) * b (16x8, col-major); bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kT = 16;              // output tile: kT x kT pixels; k step kT
constexpr int kRS = kT + 4;         // row stride of a staged channel tile (bf16)
constexpr int kCS = kT * kRS + 4;   // channel stride (bf16), 4 mod 8: see the staging
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

template <int C, int D>
struct TriSmem {
  static constexpr int kStage = 2 * C * kCS * 2;        // As + Bs
  static constexpr int kAccStride = C + 4;              // floats per pixel row
  static constexpr int kAcc = kT * kT * kAccStride * 4;
  static constexpr int kWStride = C + 8;                // bf16 per row of w_out^T
  static constexpr int kW = D * kWStride * 2;
  static constexpr int kBytes = kStage > kAcc + kW ? kStage : kAcc + kW;
};

template <int C, int D>
__global__ void __launch_bounds__(kThreads, 1)
triangle_mult_mma_kernel(const bf16* __restrict__ a_lin, const bf16* __restrict__ ga,
                         const float* __restrict__ mask, const bf16* __restrict__ b,
                         const float* __restrict__ gamma, const float* __restrict__ beta,
                         const float* __restrict__ w_out, const float* __restrict__ b_out,
                         const bf16* __restrict__ g_lin, const float* __restrict__ g_bias,
                         bf16* __restrict__ out, float* __restrict__ mean_out,
                         float* __restrict__ inv_out, long long a_sb, long long a_si,
                         long long a_sk, long long g_sb, long long g_si, long long g_sk,
                         long long m_sb, long long m_si, long long m_sk, int ni, int nj,
                         int nk, float eps) {
  static_assert(C % 32 == 0 && C / kWarps >= 1, "C must be a multiple of 32");
  static_assert(D % 8 == 0, "D must be a multiple of 8");
  using S = TriSmem<C, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + C * kCS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int j0 = blockIdx.x * kT, i0 = blockIdx.y * kT;
  const long long bb = blockIdx.z;

  constexpr int CPW = C / kWarps;     // channels per warp
  // Staging work: a task is 4 consecutive k of 16 channels of all kT rows;
  // lane l takes row l / 2 and the 8 channels 8 * (2 * task_c + l % 2).
  constexpr int KQ = kT / 4, TASKS = KQ * C / 16;
  const int r = lane >> 1;
  float acc[CPW][2][4];
#pragma unroll
  for (int cc = 0; cc < CPW; ++cc)
#pragma unroll
    for (int jt = 0; jt < 2; ++jt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[cc][jt][e] = 0.f;

  for (int k0 = 0; k0 < nk; k0 += kT) {
    // Each thread loads 4 k of its 8 channels (16 bytes each; lane pairs
    // read 32 contiguous bytes) and writes every channel's 4 k as one 8-byte
    // store: with a row stride of 10 words and a channel stride of 4 mod 8
    // elements, the 16 stores of a half-warp fill 32 distinct banks.
    for (int item = warp; item < 2 * TASKS; item += kWarps) {
      const bool is_a = item < TASKS;
      const int task = is_a ? item : item - TASKS;
      const int kq = task % KQ, cv = (task / KQ) * 2 + (lane & 1);
      const int kb = k0 + kq * 4;
      const int ch = cv * 8;
      if (is_a) {
        const int ig = i0 + r;
        uint4 av[4], gv[4];
        float m[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool ok = ig < ni && kb + q < nk;
          const long long kg = kb + q;
          av[q] = ok ? *reinterpret_cast<const uint4*>(a_lin + bb * a_sb + ig * a_si + kg * a_sk + ch)
                     : make_uint4(0u, 0u, 0u, 0u);
          gv[q] = ok ? *reinterpret_cast<const uint4*>(ga + bb * g_sb + ig * g_si + kg * g_sk + ch)
                     : make_uint4(0u, 0u, 0u, 0u);
          m[q] = ok ? mask[bb * m_sb + ig * m_si + kg * m_sk] : 0.f;
        }
        // (a_lin * sigmoid(ga)) rounded to bf16, then times the mask in
        // bf16: the plain version's two rounding points.
        const __nv_bfloat162 m01 = __floats2bfloat162_rn(m[0], m[1]);
        const __nv_bfloat162 m23 = __floats2bfloat162_rn(m[2], m[3]);
        bf16 y[4][8];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&av[q]);
          const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv[q]);
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const float2 af = __bfloat1622float2(a2[p]);
            const float2 gf = __bfloat1622float2(g2[p]);
            y[q][2 * p] = __float2bfloat16(af.x * __fdividef(1.f, 1.f + __expf(-gf.x)));
            y[q][2 * p + 1] = __float2bfloat16(af.y * __fdividef(1.f, 1.f + __expf(-gf.y)));
          }
        }
        bf16* dst = As + ch * kCS + r * kRS + kq * 4;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const __nv_bfloat162 lo = __hmul2(__halves2bfloat162(y[0][e], y[1][e]), m01);
          const __nv_bfloat162 hi = __hmul2(__halves2bfloat162(y[2][e], y[3][e]), m23);
          *reinterpret_cast<uint2*>(dst + e * kCS) =
              make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                         *reinterpret_cast<const uint32_t*>(&hi));
        }
      } else {
        const int jg = j0 + r;
        uint4 bv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          bv[q] = (jg < nj && kb + q < nk)
                      ? *reinterpret_cast<const uint4*>(b + ((bb * nj + jg) * nk + kb + q) * C + ch)
                      : make_uint4(0u, 0u, 0u, 0u);
        const uint32_t* w0 = reinterpret_cast<const uint32_t*>(&bv[0]);
        const uint32_t* w1 = reinterpret_cast<const uint32_t*>(&bv[1]);
        const uint32_t* w2 = reinterpret_cast<const uint32_t*>(&bv[2]);
        const uint32_t* w3 = reinterpret_cast<const uint32_t*>(&bv[3]);
        bf16* dst = Bs + ch * kCS + r * kRS + kq * 4;
#pragma unroll
        for (int p = 0; p < 4; ++p) {   // word p holds channels 2p (low) and 2p + 1
          *reinterpret_cast<uint2*>(dst + 2 * p * kCS) =
              make_uint2(__byte_perm(w0[p], w1[p], 0x5410), __byte_perm(w2[p], w3[p], 0x5410));
          *reinterpret_cast<uint2*>(dst + (2 * p + 1) * kCS) =
              make_uint2(__byte_perm(w0[p], w1[p], 0x7632), __byte_perm(w2[p], w3[p], 0x7632));
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int cc = 0; cc < CPW; ++cc) {
      const int c = warp * CPW + cc;
      const bf16* Ac = As + c * kCS;
      const bf16* Bc = Bs + c * kCS;
      uint32_t a[4];
      a[0] = ld32(Ac + g * kRS + 2 * t);
      a[1] = ld32(Ac + (g + 8) * kRS + 2 * t);
      a[2] = ld32(Ac + g * kRS + 2 * t + 8);
      a[3] = ld32(Ac + (g + 8) * kRS + 2 * t + 8);
#pragma unroll
      for (int jt = 0; jt < 2; ++jt) {
        const bf16* Bj = Bc + (jt * 8 + g) * kRS + 2 * t;
        mma_bf16(acc[cc][jt], a, ld32(Bj), ld32(Bj + 8));
      }
    }
    __syncthreads();
  }

  // Epilogue. The sums go to shared memory as [pixel p = i * kT + j][C].
  float* accs = reinterpret_cast<float*>(smem);
  constexpr int AS = S::kAccStride;
#pragma unroll
  for (int cc = 0; cc < CPW; ++cc) {
    const int c = warp * CPW + cc;
#pragma unroll
    for (int jt = 0; jt < 2; ++jt) {
      const int p = g * kT + jt * 8 + 2 * t;
      accs[p * AS + c] = acc[cc][jt][0];
      accs[(p + 1) * AS + c] = acc[cc][jt][1];
      accs[(p + 8 * kT) * AS + c] = acc[cc][jt][2];
      accs[(p + 8 * kT + 1) * AS + c] = acc[cc][jt][3];
    }
  }
  // w_out (C, D) fp32 -> bf16, transposed to [D][C] so its fragments load as rows.
  bf16* Ws = reinterpret_cast<bf16*>(smem + S::kAcc);
  constexpr int WS = S::kWStride;
  for (int idx = tid; idx < C * D; idx += kThreads) {
    const int k = idx / D, n = idx % D;
    Ws[n * WS + k] = __float2bfloat16(w_out[idx]);
  }
  __syncthreads();

  // LayerNorm: one warp per pixel, two-pass fp32 statistics; y in bf16
  // overwrites the start of the pixel's own row.
  constexpr int PPW = kT * kT / kWarps;
  for (int q = 0; q < PPW; ++q) {
    const int p = warp * PPW + q;
    float* row = accs + p * AS;
    float v[C / 32];
    float s = 0.f;
#pragma unroll
    for (int u = 0; u < C / 32; ++u) {
      v[u] = row[lane + 32 * u];
      s += v[u];
    }
    const float mean = warp_sum(s) / C;
    float ss = 0.f;
#pragma unroll
    for (int u = 0; u < C / 32; ++u) {
      const float dv = v[u] - mean;
      ss += dv * dv;
    }
    const float inv = rsqrtf(warp_sum(ss) / C + eps);
    __syncwarp();
    bf16* y = reinterpret_cast<bf16*>(row);
#pragma unroll
    for (int u = 0; u < C / 32; ++u) {
      const int c = lane + 32 * u;
      y[c] = __float2bfloat16((v[u] - mean) * inv * gamma[c] + beta[c]);
    }
    const int ig = i0 + p / kT, jg = j0 + p % kT;
    if (lane == 0 && ig < ni && jg < nj) {
      const long long o = (bb * ni + ig) * nj + jg;
      mean_out[o] = mean;
      inv_out[o] = inv;
    }
  }
  __syncthreads();

  // y (kT*kT x C) @ w_out (C x D): warp w owns pixel rows 16w..16w+15 (one i).
  constexpr int NT8 = D / 8;
  constexpr int YS = 2 * AS;          // bf16 stride of a y row
  const bf16* Y = reinterpret_cast<const bf16*>(accs);
  const int m0 = warp * 16;
  float z[NT8][4];
#pragma unroll
  for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) z[nt][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < C; ks += 16) {
    uint32_t a[4];
    a[0] = ld32(Y + (m0 + g) * YS + ks + 2 * t);
    a[1] = ld32(Y + (m0 + g + 8) * YS + ks + 2 * t);
    a[2] = ld32(Y + (m0 + g) * YS + ks + 2 * t + 8);
    a[3] = ld32(Y + (m0 + g + 8) * YS + ks + 2 * t + 8);
#pragma unroll
    for (int nt = 0; nt < NT8; ++nt) {
      const bf16* Wn = Ws + (nt * 8 + g) * WS + ks + 2 * t;
      mma_bf16(z[nt], a, ld32(Wn), ld32(Wn + 8));
    }
  }
  const int ig = i0 + warp;
  if (ig >= ni) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int jg = j0 + g + 8 * h;
    if (jg >= nj) continue;
    const long long base = ((bb * ni + ig) * nj + jg) * D;
#pragma unroll
    for (int nt = 0; nt < NT8; ++nt) {
      const int d = nt * 8 + 2 * t;
      const __nv_bfloat162 gl = *reinterpret_cast<const __nv_bfloat162*>(g_lin + base + d);
      const float z0 = z[nt][2 * h] + b_out[d];
      const float z1 = z[nt][2 * h + 1] + b_out[d + 1];
      const float s0 = sigmoid_exact(__low2float(gl) + g_bias[d]);
      const float s1 = sigmoid_exact(__high2float(gl) + g_bias[d + 1]);
      *reinterpret_cast<__nv_bfloat162*>(out + base + d) = __floats2bfloat162_rn(s0 * z0, s1 * z1);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: plain FMA loop (checks only)
// ---------------------------------------------------------------------------

constexpr int kFT = 8;              // 8 x 8 pixels per block, k step 8
constexpr int kFThreads = 256;

template <int C>
constexpr int fma_smem_bytes() { return 2 * kFT * kFT * C * 4; }

template <int C, int D>
__global__ void __launch_bounds__(kFThreads)
triangle_mult_fma_kernel(const float* __restrict__ a_lin, const float* __restrict__ ga,
                         const float* __restrict__ mask, const float* __restrict__ b,
                         const float* __restrict__ gamma, const float* __restrict__ beta,
                         const float* __restrict__ w_out, const float* __restrict__ b_out,
                         const float* __restrict__ g_lin, const float* __restrict__ g_bias,
                         float* __restrict__ out, float* __restrict__ mean_out,
                         float* __restrict__ inv_out, long long a_sb, long long a_si,
                         long long a_sk, long long g_sb, long long g_si, long long g_sk,
                         long long m_sb, long long m_si, long long m_sk, int ni, int nj,
                         int nk, float eps) {
  static_assert(kFThreads % C == 0 && C % 32 == 0, "C must divide the block");
  extern __shared__ __align__(16) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);   // [k][i][C]
  float* Bs = As + kFT * kFT * C;               // [k][j][C]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int j0 = blockIdx.x * kFT, i0 = blockIdx.y * kFT;
  const long long bb = blockIdx.z;
  constexpr int G = kFThreads / C;   // thread groups over the i rows
  constexpr int RPG = kFT / G;       // i rows per group
  const int c = tid % C, grp = tid / C;

  float acc[RPG][kFT];
#pragma unroll
  for (int r = 0; r < RPG; ++r)
#pragma unroll
    for (int j = 0; j < kFT; ++j) acc[r][j] = 0.f;

  for (int k0 = 0; k0 < nk; k0 += kFT) {
    for (int idx = tid; idx < kFT * kFT * C; idx += kFThreads) {
      const int cc = idx % C, rest = idx / C, r = rest % kFT, k = rest / kFT;
      const int kg = k0 + k, ig = i0 + r, jg = j0 + r;
      float x = 0.f, y = 0.f;
      if (ig < ni && kg < nk) {
        const float a = a_lin[bb * a_sb + ig * a_si + kg * a_sk + cc];
        const float gt = ga[bb * g_sb + ig * g_si + kg * g_sk + cc];
        x = a * sigmoid_exact(gt) * mask[bb * m_sb + ig * m_si + kg * m_sk];
      }
      if (jg < nj && kg < nk) y = b[((bb * nj + jg) * nk + kg) * C + cc];
      As[idx] = x;
      Bs[idx] = y;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFT; ++k) {
      float bv[kFT];
#pragma unroll
      for (int j = 0; j < kFT; ++j) bv[j] = Bs[(k * kFT + j) * C + c];
#pragma unroll
      for (int r = 0; r < RPG; ++r) {
        const float av = As[(k * kFT + grp * RPG + r) * C + c];
#pragma unroll
        for (int j = 0; j < kFT; ++j) acc[r][j] = fmaf(av, bv[j], acc[r][j]);
      }
    }
    __syncthreads();
  }

  float* accs = reinterpret_cast<float*>(smem);   // [pixel][C + 1]
  constexpr int AS = C + 1;
#pragma unroll
  for (int r = 0; r < RPG; ++r)
#pragma unroll
    for (int j = 0; j < kFT; ++j) accs[((grp * RPG + r) * kFT + j) * AS + c] = acc[r][j];
  __syncthreads();

  constexpr int PPW = kFT * kFT / (kFThreads / 32);
  for (int q = 0; q < PPW; ++q) {
    const int p = warp * PPW + q;
    float* row = accs + p * AS;
    float v[C / 32];
    float s = 0.f;
#pragma unroll
    for (int u = 0; u < C / 32; ++u) {
      v[u] = row[lane + 32 * u];
      s += v[u];
    }
    const float mean = warp_sum(s) / C;
    float ss = 0.f;
#pragma unroll
    for (int u = 0; u < C / 32; ++u) {
      const float dv = v[u] - mean;
      ss += dv * dv;
    }
    const float inv = rsqrtf(warp_sum(ss) / C + eps);
#pragma unroll
    for (int u = 0; u < C / 32; ++u) {
      const int cc = lane + 32 * u;
      row[cc] = (v[u] - mean) * inv * gamma[cc] + beta[cc];
    }
    const int ig = i0 + p / kFT, jg = j0 + p % kFT;
    if (lane == 0 && ig < ni && jg < nj) {
      const long long o = (bb * ni + ig) * nj + jg;
      mean_out[o] = mean;
      inv_out[o] = inv;
    }
  }
  __syncthreads();

  for (int idx = tid; idx < kFT * kFT * D; idx += kFThreads) {
    const int p = idx / D, d = idx % D;
    const int ig = i0 + p / kFT, jg = j0 + p % kFT;
    if (ig >= ni || jg >= nj) continue;
    const float* y = accs + p * AS;
    float z = 0.f;
#pragma unroll 8
    for (int cc = 0; cc < C; ++cc) z = fmaf(y[cc], w_out[cc * D + d], z);
    z += b_out[d];
    const long long o = ((bb * ni + ig) * nj + jg) * D + d;
    out[o] = sigmoid_exact(g_lin[o] + g_bias[d]) * z;
  }
}

// ---------------------------------------------------------------------------

struct Args {
  const void *a_lin, *ga, *mask, *b, *gamma, *beta, *w_out, *b_out, *g_lin, *g_bias;
  void *out, *mean, *inv;
  long long a_sb, a_si, a_sk, g_sb, g_si, g_sk, m_sb, m_si, m_sk;
  int nb, ni, nj, nk;
  float eps;
};

template <typename T, typename Kern>
int launch(Kern kern, const Args& x, dim3 grid, int threads, int smem, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, threads, smem, st>>>(
      static_cast<const T*>(x.a_lin), static_cast<const T*>(x.ga),
      static_cast<const float*>(x.mask), static_cast<const T*>(x.b),
      static_cast<const float*>(x.gamma), static_cast<const float*>(x.beta),
      static_cast<const float*>(x.w_out), static_cast<const float*>(x.b_out),
      static_cast<const T*>(x.g_lin), static_cast<const float*>(x.g_bias),
      static_cast<T*>(x.out), static_cast<float*>(x.mean), static_cast<float*>(x.inv), x.a_sb,
      x.a_si, x.a_sk, x.g_sb, x.g_si, x.g_sk, x.m_sb, x.m_si, x.m_sk, x.ni, x.nj, x.nk, x.eps);
  return (int)cudaGetLastError();
}

template <int C, int D>
int dispatch(const Args& x, int dtype, cudaStream_t st) {
  if (dtype == 1) {
    const dim3 grid((x.nj + kT - 1) / kT, (x.ni + kT - 1) / kT, x.nb);
    return launch<bf16>(triangle_mult_mma_kernel<C, D>, x, grid, kThreads, TriSmem<C, D>::kBytes,
                        st);
  }
  const dim3 grid((x.nj + kFT - 1) / kFT, (x.ni + kFT - 1) / kFT, x.nb);
  return launch<float>(triangle_mult_fma_kernel<C, D>, x, grid, kFThreads, fma_smem_bytes<C>(),
                       st);
}

}  // namespace

// a_lin, ga: (B, I, K, C) with unit channel stride and the given B, I, K
// strides (elements, multiples of 8; 16-byte aligned base). mask: (B, I, K)
// fp32 with the given strides. b: (B, J, K, C) contiguous. gamma, beta: (C,)
// fp32; w_out: (C, D) fp32 contiguous; b_out, g_bias: (D,) fp32. g_lin, out:
// (B, I, J, D) contiguous; mean, inv: (B, I, J) fp32 contiguous. dtype: 0 =
// float32, 1 = bfloat16 (a_lin, ga, b, g_lin, out). C, D in {32, 128}.
// Returns the cudaError_t of the launch.
extern "C" int triangle_mult_fwd(const void* a_lin, const void* ga, const void* mask,
                                 const void* b, const void* gamma, const void* beta,
                                 const void* w_out, const void* b_out, const void* g_lin,
                                 const void* g_bias, void* out, void* mean, void* inv,
                                 long long a_sb, long long a_si, long long a_sk, long long g_sb,
                                 long long g_si, long long g_sk, long long m_sb, long long m_si,
                                 long long m_sk, int nb, int ni, int nj, int nk, int c, int d,
                                 float eps, int dtype, void* stream) {
  if (nb <= 0 || ni <= 0 || nj <= 0) return 0;
  if (nk < 0 || nb > 65535 || (ni + kFT - 1) / kFT > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Args x{a_lin, ga,   mask, b,    gamma, beta, w_out, b_out, g_lin, g_bias, out, mean, inv,
               a_sb,  a_si, a_sk, g_sb, g_si,  g_sk, m_sb,  m_si,  m_sk,  nb,     ni,  nj,   nk,
               eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c == 32 && d == 32) return dispatch<32, 32>(x, dtype, st);     // MINI
  if (c == 32 && d == 128) return dispatch<32, 128>(x, dtype, st);
  if (c == 128 && d == 32) return dispatch<128, 32>(x, dtype, st);
  if (c == 128 && d == 128) return dispatch<128, 128>(x, dtype, st);  // FULL
  return (int)cudaErrorInvalidValue;
}
