// Fused outer-product-mean, for Hopper (sm_90a).
//
// Replaces the TPU kernel `fused_opm_pallas`
// (src/repro/kernels/triangle.py, body `_opm_kernel`):
//   o[i,j]  = sum_s a[s,i,:] (x) b[s,j,:]                 (C x C), fp32
//   norm    = sum_s mask_a[s,i] * mask_b[s,j]              fp32
//   ov      = (vec(o) / (norm + 1e-3)), cast to dt
//   out     = ov @ w + bias                                fp32, one cast
// a and b arrive masked. The (B, I, J, C, C) outer-product tensor never
// reaches device memory: each block keeps its tile in registers, then in
// shared memory.
//
// Bound on the H100, FULL widths (C = 32, C^2 = 1024, D = 128, S = 128,
// bf16): 2 I J S C^2 + 2 I J C^2 D operations, 34.4 GFLOP at r = 256 and
// 77 GFLOP at r = 384, take 0.035 ms and 0.078 ms at 989 TFLOP/s, while the
// bytes (a, b and the masks read once, out written once, w) take under
// 0.01 ms. So tensor-core operations bound it. The design runs both
// products on mma.sync (bf16 in, fp32 accumulate) from shared memory that
// cp.async fills with no register round trip; the remaining distance to
// the bound is mma.sync against wgmma and w (256 KB in bf16) streamed again
// by every block.
//
// Design (bf16):
//  * one block of 16 warps per TI x TJ output pixels with TI * C = 256 and
//    TJ * C = 128 (8 x 4 pixels at C = 32): the tile's outer product is one
//    256 x 128 fp32 GEMM over s, a[s, (i, c1)]^T b[s, (j, c2)], 64 x 32 per
//    warp in registers;
//  * a loop inside the block over s in steps of 32, double-buffered with
//    cp.async (zero fill past S, I and J), takes the place of the TPU grid's
//    sequential s axis; a and b keep their memory layout in shared memory
//    ([s][(i, c)], rows padded by 16 bytes against bank conflicts) and
//    ldmatrix.trans turns them into mma fragments; the masks of the step are
//    copied beside them and one thread per pixel sums the norm;
//  * epilogue: each fragment is divided by its pixel's norm + 1e-3 in fp32,
//    cast to bf16 and stored as ov[pixel][c1 * C + c2] in shared memory;
//    then ov (pixels x C^2) @ w (C^2 x D) runs on mma.sync with w streamed
//    through shared memory in double-buffered chunks of 64 rows (it does
//    not fit whole), and the bias and the one cast are applied to the
//    fragments before they are stored.
// The fp32 instantiation is a plain FMA loop with the same arithmetic (no
// TF32), for the fp32 checks; it is not the timed path. A pixel with
// norm = 0 (padding, or an all-masked MSA column) has o = 0, so its output
// is the bias, as in the plain version. The kernel launches on the
// caller's stream, allocates nothing and does not synchronise.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr float kNormEps = 1e-3f;   // AlphaFold's outer-product-mean epsilon

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

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
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
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kM = 256;             // rows (i, c1) of a block's outer product
constexpr int kN = 128;             // columns (j, c2)
constexpr int kST = 32;             // s rows per pipeline step
constexpr int kKC = 64;             // rows of w per streamed chunk
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kAStride = kM + 8;    // bf16 per staged a row
constexpr int kBStride = kN + 8;

template <int C, int D>
struct OpmCfg {
  static constexpr int TI = kM / C, TJ = kN / C, P = TI * TJ, Q = C * C;
  static constexpr int OVS = Q + 8;                 // bf16 per ov row
  static constexpr int WS = D + 8;                  // bf16 per staged w row
  static constexpr int kA = kST * kAStride;         // bf16 per a buffer
  static constexpr int kB = kST * kBStride;
  static constexpr int kStage = 2 * (kA + kB) * 2 + 2 * kST * (TI + TJ) * 4;
  static constexpr int kW = 2 * kKC * WS * 2;
  static constexpr int kUnion = kStage > kW ? kStage : kW;
  static constexpr int kOv = P * OVS * 2;
  static constexpr int kBytes = kUnion + kOv + P * 4;
};

template <int C, int D>
__global__ void __launch_bounds__(kThreads, 1)
outer_product_mean_mma_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                              const float* __restrict__ mask_a,
                              const float* __restrict__ mask_b, const bf16* __restrict__ w,
                              const float* __restrict__ bias, bf16* __restrict__ out, int ns,
                              int ni, int nj) {
  using K = OpmCfg<C, D>;
  constexpr int TI = K::TI, TJ = K::TJ, P = K::P, Q = K::Q;
  static_assert(P % 16 == 0 && P <= kThreads && D % 8 == 0 && Q % kKC == 0, "tile shape");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);         // [2][kST][kAStride]
  bf16* Bs = As + 2 * K::kA;                        // [2][kST][kBStride]
  float* Ma = reinterpret_cast<float*>(Bs + 2 * K::kB);   // [2][kST][TI]
  float* Mb = Ma + 2 * kST * TI;                    // [2][kST][TJ]
  bf16* Ws = reinterpret_cast<bf16*>(smem);         // [2][kKC][WS], after the s loop
  bf16* Ov = reinterpret_cast<bf16*>(smem + K::kUnion);   // [P][OVS]
  float* Nrm = reinterpret_cast<float*>(smem + K::kUnion + K::kOv);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int j0 = blockIdx.x * TJ, i0 = blockIdx.y * TI;
  const long long bb = blockIdx.z;
  const int wm = warp >> 2, wn = warp & 3;          // 4 x 4 warps of 64 x 32

  auto load_stage = [&](int st, int buf) {
    const int s0 = st * kST;
    bf16* Ab = As + buf * K::kA;
    bf16* Bb = Bs + buf * K::kB;
    for (int v = tid; v < kST * (kM / 8); v += kThreads) {
      const int row = v / (kM / 8), ch = v % (kM / 8);
      const int s = s0 + row, i = i0 + ch * 8 / C;
      const bool ok = s < ns && i < ni;
      cp_async16(Ab + row * kAStride + ch * 8,
                 ok ? a + ((bb * ns + s) * ni + i0) * C + ch * 8 : a, ok);
    }
    for (int v = tid; v < kST * (kN / 8); v += kThreads) {
      const int row = v / (kN / 8), ch = v % (kN / 8);
      const int s = s0 + row, j = j0 + ch * 8 / C;
      const bool ok = s < ns && j < nj;
      cp_async16(Bb + row * kBStride + ch * 8,
                 ok ? b + ((bb * ns + s) * nj + j0) * C + ch * 8 : b, ok);
    }
    for (int v = tid; v < kST * (TI + TJ); v += kThreads) {
      if (v < kST * TI) {
        const int row = v / TI, ii = v % TI, s = s0 + row, i = i0 + ii;
        const bool ok = s < ns && i < ni;
        cp_async4(Ma + buf * kST * TI + v, ok ? mask_a + (bb * ns + s) * ni + i : mask_a, ok);
      } else {
        const int u = v - kST * TI, row = u / TJ, jj = u % TJ, s = s0 + row, j = j0 + jj;
        const bool ok = s < ns && j < nj;
        cp_async4(Mb + buf * kST * TJ + u, ok ? mask_b + (bb * ns + s) * nj + j : mask_b, ok);
      }
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  float nrm = 0.f;

  const int nst = (ns + kST - 1) / kST;
  if (nst > 0) load_stage(0, 0);
  cp_async_commit();
  for (int st = 0; st < nst; ++st) {
    if (st + 1 < nst) {
      load_stage(st + 1, (st + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int buf = st & 1;
    const bf16* Ab = As + buf * K::kA;
    const bf16* Bb = Bs + buf * K::kB;
    if (tid < P) {
      const float* ma = Ma + buf * kST * TI + tid / TJ;
      const float* mb = Mb + buf * kST * TJ + tid % TJ;
#pragma unroll 8
      for (int s = 0; s < kST; ++s) nrm += ma[s * TI] * mb[s * TJ];
    }
#pragma unroll
    for (int ks = 0; ks < kST; ks += 16) {
      // A fragments: the stored [s][m] tile read transposed (rows m, cols s).
      uint32_t af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int row = ks + (lane & 7) + ((lane >> 4) << 3);
        const int col = wm * 64 + mt * 16 + (((lane >> 3) & 1) << 3);
        ldmatrix_x4_trans(af[mt], Ab + row * kAStride + col);
      }
      // B fragments: [s][n] read transposed gives the col-major k x n operand.
      uint32_t bfr[4][2];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int row = ks + (lane & 7) + (((lane >> 3) & 1) << 3);
        const int col = wn * 32 + np * 16 + ((lane >> 4) << 3);
        uint32_t r[4];
        ldmatrix_x4_trans(r, Bb + row * kBStride + col);
        bfr[2 * np][0] = r[0];
        bfr[2 * np][1] = r[1];
        bfr[2 * np + 1][0] = r[2];
        bfr[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], af[mt], bfr[nt][0], bfr[nt][1]);
    }
    __syncthreads();
  }

  // Stream w from here on; its first chunk loads while ov is written.
  auto load_w = [&](int kc, int buf) {
    bf16* Wb = Ws + buf * kKC * K::WS;
    for (int v = tid; v < kKC * (D / 8); v += kThreads) {
      const int row = v / (D / 8), ch = v % (D / 8);
      cp_async16(Wb + row * K::WS + ch * 8, w + (long long)(kc * kKC + row) * D + ch * 8, true);
    }
  };
  load_w(0, 0);
  cp_async_commit();

  if (tid < P) Nrm[tid] = nrm;
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = wm * 64 + mt * 16 + g + 8 * h;
        const int n = wn * 32 + nt * 8 + 2 * t;
        const int p = (m / C) * TJ + n / C;
        const float den = Nrm[p] + kNormEps;
        *reinterpret_cast<__nv_bfloat162*>(Ov + p * K::OVS + (m % C) * C + n % C) =
            __floats2bfloat162_rn(acc[mt][nt][2 * h] / den, acc[mt][nt][2 * h + 1] / den);
      }
    }
  }

  // ov (P x Q) @ w (Q x D): TILES m16n8 tiles, TPW consecutive ones per warp.
  constexpr int NT8 = D / 8, TILES = (P / 16) * NT8;
  constexpr int TPW = (TILES + kWarps - 1) / kWarps;
  float z[TPW][4];
#pragma unroll
  for (int u = 0; u < TPW; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) z[u][e] = 0.f;
  constexpr int NCH = Q / kKC;
  for (int kc = 0; kc < NCH; ++kc) {
    if (kc + 1 < NCH) {
      load_w(kc + 1, (kc + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Wb = Ws + (kc & 1) * kKC * K::WS;
#pragma unroll
    for (int ks = 0; ks < kKC; ks += 16) {
#pragma unroll
      for (int u = 0; u < TPW; ++u) {
        const int idx = warp * TPW + u;
        if (idx >= TILES) break;
        const int mt = idx / NT8, nt = idx % NT8;
        uint32_t af[4];
        ldmatrix_x4(af, Ov + (mt * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) * K::OVS +
                            kc * kKC + ks + ((lane >> 4) << 3));
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1,
                          Wb + (ks + (lane & 7) + (((lane >> 3) & 1) << 3)) * K::WS + nt * 8);
        mma_bf16(z[u], af, b0, b1);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int u = 0; u < TPW; ++u) {
    const int idx = warp * TPW + u;
    if (idx >= TILES) break;
    const int mt = idx / NT8, nt = idx % NT8;
    const int d = nt * 8 + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = mt * 16 + g + 8 * h;
      const int i = i0 + p / TJ, j = j0 + p % TJ;
      if (i >= ni || j >= nj) continue;
      *reinterpret_cast<__nv_bfloat162*>(out + ((bb * ni + i) * nj + j) * D + d) =
          __floats2bfloat162_rn(z[u][2 * h] + bias[d], z[u][2 * h + 1] + bias[d + 1]);
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

template <typename T, typename Kern>
int launch(Kern kern, dim3 grid, int threads, int smem, cudaStream_t st, const void* a,
           const void* b, const void* ma, const void* mb, const void* w, const void* bias,
           void* out, int ns, int ni, int nj) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, threads, smem, st>>>(static_cast<const T*>(a), static_cast<const T*>(b),
                                    static_cast<const float*>(ma), static_cast<const float*>(mb),
                                    static_cast<const T*>(w), static_cast<const float*>(bias),
                                    static_cast<T*>(out), ns, ni, nj);
  return (int)cudaGetLastError();
}

template <int C, int D>
int dispatch(int dtype, cudaStream_t st, const void* a, const void* b, const void* ma,
             const void* mb, const void* w, const void* bias, void* out, int nb, int ns, int ni,
             int nj) {
  if (dtype == 1) {
    using K = OpmCfg<C, D>;
    const dim3 grid((nj + K::TJ - 1) / K::TJ, (ni + K::TI - 1) / K::TI, nb);
    return launch<bf16>(outer_product_mean_mma_kernel<C, D>, grid, kThreads, K::kBytes, st, a, b,
                        ma, mb, w, bias, out, ns, ni, nj);
  }
  const dim3 grid((nj + kFT - 1) / kFT, (ni + kFT - 1) / kFT, nb);
  return launch<float>(outer_product_mean_fma_kernel<C, D>, grid, kFThreads, fma_smem_bytes<C>(),
                       st, a, b, ma, mb, w, bias, out, ns, ni, nj);
}

}  // namespace

// a: (B, S, I, C), b: (B, S, J, C), masked, contiguous. mask_a: (B, S, I),
// mask_b: (B, S, J) fp32 contiguous. w: (C*C, D) contiguous in a's dtype;
// bias: (D,) fp32. out: (B, I, J, D) contiguous in a's dtype. dtype: 0 =
// float32, 1 = bfloat16. C in {16, 32}, D in {32, 128}. Returns the
// cudaError_t of the launch.
extern "C" int outer_product_mean_fwd(const void* a, const void* b, const void* mask_a,
                                      const void* mask_b, const void* w, const void* bias,
                                      void* out, int nb, int ns, int ni, int nj, int c, int d,
                                      int dtype, void* stream) {
  if (nb <= 0 || ni <= 0 || nj <= 0) return 0;
  if (ns < 0 || nb > 65535 || (ni + kFT - 1) / kFT > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define OPM_CASE(CC, DD)                                                                  \
  if (c == CC && d == DD)                                                                 \
    return dispatch<CC, DD>(dtype, st, a, b, mask_a, mask_b, w, bias, out, nb, ns, ni, nj);
  OPM_CASE(16, 32)    // MINI
  OPM_CASE(16, 128)
  OPM_CASE(32, 32)
  OPM_CASE(32, 128)   // FULL
#undef OPM_CASE
  return (int)cudaErrorInvalidValue;
}
