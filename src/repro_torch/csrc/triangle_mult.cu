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
// 2 r^3 C + 2 r^2 C D operations (4.3 GFLOP at r = 256) take 0.0045 ms at
// 989 TFLOP/s. What bounds this design is neither: it is the L2 cache,
// from which every block re-reads the a rows of its i tile and the b rows
// of its j tile, (r / 16)^2 blocks x 32 rows x r x C x 2 bytes = 0.54 GB at
// r = 256 and 1.8 GB at r = 384. The register file caps the output tile of
// one block at 16 x 16 pixels x C channels (its fp32 sums are 128 KB at
// C = 128, half of an SM's registers), and that caps the reuse. On an H100
// 80GB HBM3 at 700 W the main loop reads those fragments at about 10 TB/s;
// the pre-pass is bound by device memory, and the epilogue (LN, the
// projection, the gate: about 13 us a block) by its own work, which one
// block an SM cannot hide behind another block's loads.
//
// Design (bf16), three stages on the caller's stream:
//  1. pre-pass (`triangle_prepass_kernel`): reads a_lin, ga and the mask
//     through their strides once, gates a with the plain version's two
//     rounding points ((a_lin * sigmoid(ga)) rounded to bf16, then times the
//     mask in bf16; the sigmoid with the fast exponent and reciprocal, as
//     its product is rounded to bf16 at once), and writes it, and a copy of
//     b, into a workspace in the
//     order of mma.sync's fragments: for batch b, channel c, 16-row tile t
//     and 16-k tile u, 32 lanes x 16 bytes, lane (r % 8) * 4 + (k % 8) / 2
//     holding rows r, r + 8 and k pairs k, k + 8 of that tile (what ldmatrix
//     x4 would load from a row-major 16 x 16 tile). It also writes w_out^T
//     in bf16. This is O(r^2 C) work, done once, where the earlier kernel
//     gated a again for every j tile (r / 16 times);
//  2. main loop (`triangle_mult_mma_kernel`, one block of 16 warps per
//     16 x 16 output pixels): warp w owns channels C/16 * w .. C/16 * (w+1)
//     and nothing in the loop is shared between warps, so there is no
//     shared memory and no barrier in it. Each (k tile, channel) unit is one
//     16-byte load of the a fragment and one of the b fragment per lane,
//     straight from the workspace (L2) into registers, and two
//     mma.sync.m16n8k16 (bf16 in, fp32 accumulate); the loads run three
//     units ahead of the products in a ring of four register slots, so
//     about 32 KB per SM are in flight to cover L2's latency. Offsets are
//     32-bit. The fp32 sums stay in registers;
//  3. epilogue (same kernel): the sums go to shared memory as [pixel][C]
//     fp32 (16-byte stores); one warp per pixel, four pixels a pass, takes
//     two-pass LN statistics over C with shuffles and writes y in bf16 over
//     its own row; then y (256 x C) @ w_out (C x D) runs on mma.sync with
//     w_out^T staged from the workspace; the bias, the output gate and the
//     one cast are applied to the fragments in a per-warp tile of shared
//     memory, so that g_lin is read and out written as 16-byte vectors.
// Workspace: one bf16 buffer the wrapper allocates with torch.empty,
// B C (ceil(I/16) + ceil(J/16)) ceil(K/16) 256 + C D elements (the gated a
// and the copy of b, zero-padded to whole tiles, and w_out^T): about twice
// a_lin's size, 34 MB at r = 256. `triangle_workspace` in
// kernels/triangle.py gives the same layout.
// The fp32 instantiation is a plain FMA loop with the same arithmetic (no
// TF32), for the fp32 checks; it gates in its own loop and uses no
// workspace; it is not the timed path.
// Ragged I, J and K: the pre-pass writes zeros for rows past I or J and k
// past K, and pixels past I or J are not written. A pixel whose a row is
// all masked gets LN of a zero vector, (0 - 0) * rsqrt(eps), as the plain
// version does. The kernels allocate nothing and do not synchronise.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float sigmoid_exact(float x) { return 1.f / (1.f + expf(-x)); }
// With the fast exponent and reciprocal: for values rounded to bf16 next.
__device__ __forceinline__ float sigmoid_fast(float x) {
  return __fdividef(1.f, 1.f + __expf(-x));
}

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
// bf16 stage 1: the pre-pass into the fragment-ordered workspace
// ---------------------------------------------------------------------------

constexpr int kT = 16;              // output tile kT x kT pixels; k tile kT
constexpr int kFragVecs = 32;       // 16-byte vectors of one 16 x 16 tile
constexpr int kPThreads = 256;
constexpr int kPC = 32;             // channels of one pre-pass block
constexpr int kPRS = 24;            // bf16 per staged row: 16 k + 8 padding
constexpr int kPCS = kT * kPRS + 4; // bf16 per staged channel (194 words)

// Block (x = k tile, y = row tile, z = (batch, channel chunk, a or b)):
// phase 1 reads the 16 x 16 (row, k) positions x kPC channels of its tile,
// 16-byte vectors along C (two lanes on one position read 32 contiguous
// bytes), gates them (a only) and stores them to shared memory as
// [channel][row][k]: the even lanes' 2-byte stores of one channel fill 8
// consecutive words and the odd lanes', 8 channels on, lie 16 banks away
// (194 * 8 = 16 mod 32). Phase 2 composes each (channel, lane) 16-byte
// fragment from four 32-bit words (the row stride of 12 words spreads a
// warp's 32 reads over 32 banks) and writes them, a warp's 512 bytes of one
// channel contiguous. Blocks (0, 0, z) also convert slice z of w_out to
// bf16 w_out^T.
__global__ void __launch_bounds__(kPThreads)
triangle_prepass_kernel(const bf16* __restrict__ a_lin, const bf16* __restrict__ ga,
                        const float* __restrict__ mask, const bf16* __restrict__ b,
                        const float* __restrict__ w_out, uint4* __restrict__ ws_a,
                        uint4* __restrict__ ws_b, bf16* __restrict__ ws_w, long long a_sb,
                        long long a_si, long long a_sk, long long g_sb, long long g_si,
                        long long g_sk, long long m_sb, long long m_si, long long m_sk, int c,
                        int d, int ni, int nj, int nk, int ti_n, int tj_n, int tk_n) {
  __shared__ __align__(16) bf16 S[kPC * kPCS];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tk = blockIdx.x, tr = blockIdx.y;
  const int is_b = blockIdx.z & 1, rest = blockIdx.z >> 1;
  const int chunks = c / kPC, cchunk = rest % chunks, bb = rest / chunks;

  if (blockIdx.x == 0 && blockIdx.y == 0) {
    const int total = c * d, per = (total + gridDim.z - 1) / gridDim.z;
    const int end = min(total, (int)(blockIdx.z + 1) * per);
    for (int idx = blockIdx.z * per + tid; idx < end; idx += kPThreads) {
      const int n = idx / c, k = idx % c;     // ws_w is [D][C]
      ws_w[idx] = __float2bfloat16(w_out[k * d + n]);
    }
  }
  const int tr_n = is_b ? tj_n : ti_n, nrows = is_b ? nj : ni;
  if (tk >= tk_n || tr >= tr_n) return;

#pragma unroll
  for (int it = 0; it < kT * kT * (kPC / 8) / kPThreads; ++it) {
    const int wi = it * (kPThreads / 32) + warp;    // 32 warp items: row x vector pair
    const int row = wi >> 1, kk = lane >> 1;
    const int v = (wi & 1) * 2 + (lane & 1);
    const int ch = cchunk * kPC + v * 8;
    const int rg = tr * kT + row, kg = tk * kT + kk;
    uint4 y = make_uint4(0u, 0u, 0u, 0u);
    if (rg < nrows && kg < nk) {
      if (is_b) {
        y = __ldg(reinterpret_cast<const uint4*>(
            b + (((long long)bb * nj + rg) * nk + kg) * c + ch));
      } else {
        const uint4 av = __ldg(reinterpret_cast<const uint4*>(
            a_lin + bb * a_sb + rg * a_si + kg * a_sk + ch));
        const uint4 gv = __ldg(reinterpret_cast<const uint4*>(
            ga + bb * g_sb + rg * g_si + kg * g_sk + ch));
        const bf16 m = __float2bfloat16(mask[bb * m_sb + rg * m_si + kg * m_sk]);
        const __nv_bfloat162 m2 = __halves2bfloat162(m, m);
        const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&av);
        const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
        __nv_bfloat162* y2 = reinterpret_cast<__nv_bfloat162*>(&y);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          // (a_lin * sigmoid(ga)) rounded to bf16, then times the mask in
          // bf16: the plain version's two rounding points.
          const float2 af = __bfloat1622float2(a2[p]);
          const float2 gf = __bfloat1622float2(g2[p]);
          y2[p] = __hmul2(__floats2bfloat162_rn(af.x * sigmoid_fast(gf.x),
                                                af.y * sigmoid_fast(gf.y)),
                          m2);
        }
      }
    }
    const bf16* ye = reinterpret_cast<const bf16*>(&y);
    bf16* dst = S + (v * 8) * kPCS + row * kPRS + kk;
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[e * kPCS] = ye[e];
  }
  __syncthreads();

  const uint32_t* Sw = reinterpret_cast<const uint32_t*>(S);
  uint4* ws = is_b ? ws_b : ws_a;
#pragma unroll
  for (int it = 0; it < kPC * kFragVecs / kPThreads; ++it) {
    const int q = it * kPThreads + tid;
    const int l = q & 31, cl = q >> 5;
    const uint32_t* src = Sw + cl * (kPCS / 2) + (l >> 2) * (kPRS / 2) + (l & 3);
    // Register r of the fragment: rows + 8 * (r & 1), k pairs + 8 * (r >> 1).
    const uint4 f = make_uint4(src[0], src[8 * (kPRS / 2)], src[4], src[8 * (kPRS / 2) + 4]);
    const unsigned o = (((unsigned)(bb * c + cchunk * kPC + cl) * tr_n + tr) * tk_n + tk) *
                           kFragVecs + l;
    ws[o] = f;
  }
}

// ---------------------------------------------------------------------------
// bf16 stages 2 and 3: main loop on mma.sync, then the epilogue
// ---------------------------------------------------------------------------

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

template <int C, int D>
struct TriSmem {
  // [b_out, g_bias (fp32) | sums, then y, [pixel][C] | w_out^T [D][C] bf16];
  // after the products the gate tile [pixel][D] bf16 lies over the last two.
  static constexpr int kBias = 2 * D * 4;
  static constexpr int kAccStride = C + 4;              // floats per pixel row
  static constexpr int kAcc = kT * kT * kAccStride * 4;
  static constexpr int kWStride = C + 8;                // bf16 per row of w_out^T
  static constexpr int kW = D * kWStride * 2;
  static constexpr int kGateStride = D + 8;             // bf16 per pixel of the gate tile
  static constexpr int kGate = kT * kT * kGateStride * 2;
  static constexpr int kBytes = kBias + (kAcc + kW > kGate ? kAcc + kW : kGate);
};

template <int C, int D>
__global__ void __launch_bounds__(kThreads, 1)
triangle_mult_mma_kernel(const uint4* __restrict__ wa, const uint4* __restrict__ wb,
                         const bf16* __restrict__ wt, const float* __restrict__ gamma,
                         const float* __restrict__ beta, const float* __restrict__ b_out,
                         const bf16* __restrict__ g_lin, const float* __restrict__ g_bias,
                         bf16* __restrict__ out, float* __restrict__ mean_out,
                         float* __restrict__ inv_out, int ni, int nj, int ti_n, int tj_n,
                         int tk_n, float eps) {
  static_assert(C % 32 == 0 && C / kWarps >= 1, "C must be a multiple of 32");
  static_assert(D % 8 == 0, "D must be a multiple of 8");
  using S = TriSmem<C, D>;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tj = blockIdx.x, ti = blockIdx.y, bb = blockIdx.z;
  const int j0 = tj * kT, i0 = ti * kT;

  constexpr int CPW = C / kWarps;            // channels per warp
  constexpr int PF = CPW < 4 ? CPW : 4;      // register slots of the load ring
  static_assert(CPW % PF == 0, "the ring's slots must repeat every k tile");
  // Channel strides of the two fragment arrays, in 16-byte vectors.
  const unsigned sa = (unsigned)ti_n * tk_n * kFragVecs;
  const unsigned sb = (unsigned)tj_n * tk_n * kFragVecs;
  const uint4* pa = wa + ((unsigned)(bb * C + warp * CPW) * ti_n + ti) * tk_n * kFragVecs + lane;
  const uint4* pb = wb + ((unsigned)(bb * C + warp * CPW) * tj_n + tj) * tk_n * kFragVecs + lane;

  float acc[CPW][2][4];
#pragma unroll
  for (int cc = 0; cc < CPW; ++cc)
#pragma unroll
    for (int jt = 0; jt < 2; ++jt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[cc][jt][e] = 0.f;

  // Unit (k, cc) lives in slot cc % PF; the loads of unit (k, cc) + PF - 1
  // are issued before the products of unit (k, cc).
  uint4 ra[PF], rb[PF];
  if (tk_n > 0) {
#pragma unroll
    for (int u = 0; u < PF - 1; ++u) {
      ra[u] = __ldg(pa + u * sa);
      rb[u] = __ldg(pb + u * sb);
    }
  }
  for (int k = 0; k < tk_n; ++k) {
#pragma unroll
    for (int cc = 0; cc < CPW; ++cc) {
      const int nu = cc + PF - 1;
      const int kn = k + nu / CPW, cn = nu % CPW;
      if (kn < tk_n) {
        ra[nu % PF] = __ldg(pa + cn * sa + (unsigned)kn * kFragVecs);
        rb[nu % PF] = __ldg(pb + cn * sb + (unsigned)kn * kFragVecs);
      }
      const uint4 va = ra[cc % PF], vb = rb[cc % PF];
      const uint32_t a[4] = {va.x, va.y, va.z, va.w};
      mma_bf16(acc[cc][0], a, vb.x, vb.z);    // j 0..7:  b rows j, k pairs k and k + 8
      mma_bf16(acc[cc][1], a, vb.y, vb.w);    // j 8..15
    }
  }

  // Epilogue. The sums go to shared memory as [pixel p = i * kT + j][C]: a
  // lane holds the warp's CPW consecutive channels of each of its 8
  // pixels and stores them as 16-byte vectors (a quarter-warp's eight
  // vectors meet at most two to a bank group).
  float* bo_s = reinterpret_cast<float*>(smem);
  float* gb_s = bo_s + D;
  float* accs = reinterpret_cast<float*>(smem + S::kBias);
  constexpr int AS = S::kAccStride;
#pragma unroll
  for (int jt = 0; jt < 2; ++jt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = (g + 8 * (e >> 1)) * kT + jt * 8 + 2 * t + (e & 1);
      float* dst = accs + p * AS + warp * CPW;
      if constexpr (CPW % 4 == 0) {
#pragma unroll
        for (int c4 = 0; c4 < CPW; c4 += 4)
          *reinterpret_cast<float4*>(dst + c4) =
              make_float4(acc[c4][jt][e], acc[c4 + 1][jt][e], acc[c4 + 2][jt][e],
                          acc[c4 + 3][jt][e]);
      } else {
#pragma unroll
        for (int cc = 0; cc < CPW; ++cc) dst[cc] = acc[cc][jt][e];
      }
    }
  // w_out^T (D, C) bf16 from the workspace, 16-byte rows into padded rows;
  // b_out and g_bias in front of the sums.
  bf16* Ws = reinterpret_cast<bf16*>(smem + S::kBias + S::kAcc);
  constexpr int WS = S::kWStride;
  for (int idx = tid; idx < D * C / 8; idx += kThreads) {
    const int n = idx / (C / 8), k8 = idx % (C / 8);
    *reinterpret_cast<uint4*>(Ws + n * WS + k8 * 8) =
        __ldg(reinterpret_cast<const uint4*>(wt) + idx);
  }
  for (int idx = tid; idx < D; idx += kThreads) {
    bo_s[idx] = b_out[idx];
    gb_s[idx] = g_bias[idx];
  }
  __syncthreads();

  // LayerNorm: one warp per pixel, four pixels at a time (their shuffle
  // chains interleave), two-pass fp32 statistics; y in bf16 overwrites the
  // start of the pixel's own row.
  constexpr int PPW = kT * kT / kWarps;
  constexpr int NU = C / 32;
  constexpr int LP = 4;                      // pixels a pass
  static_assert(PPW % LP == 0, "a warp's pixels come in passes of LP");
  float gam[NU], bet[NU];
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    gam[u] = gamma[lane + 32 * u];
    bet[u] = beta[lane + 32 * u];
  }
  for (int q = 0; q < PPW; q += LP) {
    float v[LP][NU], mean[LP], inv[LP];
#pragma unroll
    for (int h = 0; h < LP; ++h) {
      const float* row = accs + (warp * PPW + q + h) * AS;
      float s = 0.f;
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        v[h][u] = row[lane + 32 * u];
        s += v[h][u];
      }
      mean[h] = s;
    }
#pragma unroll
    for (int h = 0; h < LP; ++h) mean[h] = warp_sum(mean[h]) / C;
#pragma unroll
    for (int h = 0; h < LP; ++h) {
      float ss = 0.f;
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        const float dv = v[h][u] - mean[h];
        ss += dv * dv;
      }
      inv[h] = ss;
    }
#pragma unroll
    for (int h = 0; h < LP; ++h) inv[h] = rsqrtf(warp_sum(inv[h]) / C + eps);
    __syncwarp();
#pragma unroll
    for (int h = 0; h < LP; ++h) {
      const int p = warp * PPW + q + h;
      bf16* y = reinterpret_cast<bf16*>(accs + p * AS);
#pragma unroll
      for (int u = 0; u < NU; ++u)
        y[lane + 32 * u] = __float2bfloat16((v[h][u] - mean[h]) * inv[h] * gam[u] + bet[u]);
      const int ig = i0 + p / kT, jg = j0 + p % kT;
      if (lane == 0 && ig < ni && jg < nj) {
        const unsigned o = ((unsigned)bb * ni + ig) * nj + jg;
        mean_out[o] = mean[h];
        inv_out[o] = inv[h];
      }
    }
  }
  __syncthreads();

  // y (kT*kT x C) @ w_out (C x D): warp w owns pixel rows 16w..16w+15 (one
  // i).
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
  __syncthreads();                    // y and w_out^T are dead from here

  // The output gate and the store, through a per-warp tile in shared
  // memory, so that g_lin is read and out written as 16-byte vectors, a
  // warp's 16 pixels (one i, 16 consecutive j) being one contiguous run:
  // the logits come in, each lane gates its fragments in place, the tile
  // goes out. The tile's 16-byte row padding spreads a quad's 4-byte
  // accesses of 8 pixels over 32 banks.
  const int ig = i0 + warp;
  if (ig >= ni) return;
  constexpr int GS = S::kGateStride;
  constexpr int VPP = D / 8;          // 16-byte vectors a pixel
  constexpr int VPL = kT * VPP / 32;  // of them a lane
  bf16* G = reinterpret_cast<bf16*>(smem + S::kBias) + m0 * GS;
  const unsigned row0 = ((unsigned)bb * ni + ig) * nj + j0;   // pixel (ig, j0)
  const int nj_tile = min(kT, nj - j0);
  uint4 gv[VPL];
#pragma unroll
  for (int u = 0; u < VPL; ++u) {
    const int idx = u * 32 + lane, pj = idx / VPP, v = idx % VPP;
    if (pj < nj_tile)
      gv[u] = __ldg(reinterpret_cast<const uint4*>(g_lin + (row0 + pj) * D) + v);
  }
#pragma unroll
  for (int u = 0; u < VPL; ++u) {
    const int idx = u * 32 + lane, pj = idx / VPP, v = idx % VPP;
    if (pj < nj_tile) *reinterpret_cast<uint4*>(G + pj * GS + v * 8) = gv[u];
  }
  __syncwarp();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    __nv_bfloat162* gp = reinterpret_cast<__nv_bfloat162*>(G + (g + 8 * h) * GS + 2 * t);
#pragma unroll
    for (int nt = 0; nt < NT8; ++nt) {
      const int d = nt * 8 + 2 * t;
      const __nv_bfloat162 gl = gp[nt * 4];
      const float z0 = z[nt][2 * h] + bo_s[d];
      const float z1 = z[nt][2 * h + 1] + bo_s[d + 1];
      const float s0 = sigmoid_fast(__low2float(gl) + gb_s[d]);
      const float s1 = sigmoid_fast(__high2float(gl) + gb_s[d + 1]);
      gp[nt * 4] = __floats2bfloat162_rn(s0 * z0, s1 * z1);
    }
  }
  __syncwarp();
#pragma unroll
  for (int u = 0; u < VPL; ++u) {
    const int idx = u * 32 + lane, pj = idx / VPP, v = idx % VPP;
    if (pj < nj_tile)
      reinterpret_cast<uint4*>(out + (row0 + pj) * D)[v] =
          *reinterpret_cast<const uint4*>(G + pj * GS + v * 8);
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

template <int C, int D>
int launch_fp32_cd(const Args& x, cudaStream_t st) {
  auto kern = triangle_mult_fma_kernel<C, D>;
  const int smem = fma_smem_bytes<C>();
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((x.nj + kFT - 1) / kFT, (x.ni + kFT - 1) / kFT, x.nb);
  kern<<<grid, kFThreads, smem, st>>>(
      static_cast<const float*>(x.a_lin), static_cast<const float*>(x.ga),
      static_cast<const float*>(x.mask), static_cast<const float*>(x.b),
      static_cast<const float*>(x.gamma), static_cast<const float*>(x.beta),
      static_cast<const float*>(x.w_out), static_cast<const float*>(x.b_out),
      static_cast<const float*>(x.g_lin), static_cast<const float*>(x.g_bias),
      static_cast<float*>(x.out), static_cast<float*>(x.mean), static_cast<float*>(x.inv),
      x.a_sb, x.a_si, x.a_sk, x.g_sb, x.g_si, x.g_sk, x.m_sb, x.m_si, x.m_sk, x.ni, x.nj, x.nk,
      x.eps);
  return (int)cudaGetLastError();
}

// The workspace's layout in bf16 elements (triangle_workspace in
// kernels/triangle.py is the same function): the gated a's fragments, then
// b's, then w_out^T.
struct Layout {
  long long ti_n, tj_n, tk_n, a_elems, b_elems, numel;
};

Layout layout(long long nb, long long ni, long long nj, long long nk, long long c,
              long long d) {
  Layout l;
  l.ti_n = (ni + kT - 1) / kT;
  l.tj_n = (nj + kT - 1) / kT;
  l.tk_n = (nk + kT - 1) / kT;
  l.a_elems = nb * c * l.ti_n * l.tk_n * kT * kT;
  l.b_elems = nb * c * l.tj_n * l.tk_n * kT * kT;
  l.numel = l.a_elems + l.b_elems + c * d;
  return l;
}

template <int C, int D>
int launch_bf16(const Args& x, bf16* ws, long long ws_numel, cudaStream_t st) {
  const Layout l = layout(x.nb, x.ni, x.nj, x.nk, C, D);
  // 32-bit offsets: the workspace in 16-byte vectors, the outputs in
  // elements.
  if (ws == nullptr || ws_numel < l.numel || l.numel / 8 > 0xffffffffLL ||
      (long long)x.nb * x.ni * x.nj * D > 0xffffffffLL)
    return (int)cudaErrorInvalidValue;
  uint4* wa = reinterpret_cast<uint4*>(ws);
  uint4* wb = reinterpret_cast<uint4*>(ws + l.a_elems);
  bf16* wt = ws + l.a_elems + l.b_elems;

  const long long tr_max = l.ti_n > l.tj_n ? l.ti_n : l.tj_n;
  if (tr_max > 65535) return (int)cudaErrorInvalidValue;
  const dim3 pgrid((unsigned)(l.tk_n > 0 ? l.tk_n : 1), (unsigned)tr_max,
                   (unsigned)(x.nb * (C / kPC) * 2));
  triangle_prepass_kernel<<<pgrid, kPThreads, 0, st>>>(
      static_cast<const bf16*>(x.a_lin), static_cast<const bf16*>(x.ga),
      static_cast<const float*>(x.mask), static_cast<const bf16*>(x.b),
      static_cast<const float*>(x.w_out), wa, wb, wt, x.a_sb, x.a_si, x.a_sk, x.g_sb, x.g_si,
      x.g_sk, x.m_sb, x.m_si, x.m_sk, C, D, x.ni, x.nj, x.nk, (int)l.ti_n, (int)l.tj_n,
      (int)l.tk_n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  auto kern = triangle_mult_mma_kernel<C, D>;
  const int smem = TriSmem<C, D>::kBytes;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)l.tj_n, (unsigned)l.ti_n, x.nb);
  kern<<<grid, kThreads, smem, st>>>(
      wa, wb, wt, static_cast<const float*>(x.gamma), static_cast<const float*>(x.beta),
      static_cast<const float*>(x.b_out), static_cast<const bf16*>(x.g_lin),
      static_cast<const float*>(x.g_bias), static_cast<bf16*>(x.out),
      static_cast<float*>(x.mean), static_cast<float*>(x.inv), x.ni, x.nj, (int)l.ti_n,
      (int)l.tj_n, (int)l.tk_n, x.eps);
  return (int)cudaGetLastError();
}

template <int C, int D>
int dispatch(const Args& x, int dtype, void* ws, long long ws_numel, cudaStream_t st) {
  if (dtype == 1) return launch_bf16<C, D>(x, static_cast<bf16*>(ws), ws_numel, st);
  return launch_fp32_cd<C, D>(x, st);
}

}  // namespace

// a_lin, ga: (B, I, K, C) with unit channel stride and the given B, I, K
// strides (elements, multiples of 8; 16-byte aligned base). mask: (B, I, K)
// fp32 with the given strides. b: (B, J, K, C) contiguous. gamma, beta: (C,)
// fp32; w_out: (C, D) fp32 contiguous; b_out, g_bias: (D,) fp32. g_lin, out:
// (B, I, J, D) contiguous; mean, inv: (B, I, J) fp32 contiguous. dtype: 0 =
// float32, 1 = bfloat16 (a_lin, ga, b, g_lin, out). C, D in {32, 128}.
// ws: bf16 workspace of ws_numel elements, 16-byte aligned, at least the
// layout above (bf16 only; NULL and 0 for fp32). Launches the pre-pass and
// the main kernel (bf16) or the FMA kernel (fp32); returns the first
// cudaError_t.
extern "C" int triangle_mult_fwd(const void* a_lin, const void* ga, const void* mask,
                                 const void* b, const void* gamma, const void* beta,
                                 const void* w_out, const void* b_out, const void* g_lin,
                                 const void* g_bias, void* out, void* mean, void* inv, void* ws,
                                 long long ws_numel, long long a_sb, long long a_si,
                                 long long a_sk, long long g_sb, long long g_si, long long g_sk,
                                 long long m_sb, long long m_si, long long m_sk, int nb, int ni,
                                 int nj, int nk, int c, int d, float eps, int dtype,
                                 void* stream) {
  if (nb <= 0 || ni <= 0 || nj <= 0) return 0;
  if (nk < 0 || nb > 65535 || (ni + kFT - 1) / kFT > 65535 || (dtype != 0 && dtype != 1) ||
      (dtype == 1 && (long long)nb * (c / kPC) * 2 > 65535))
    return (int)cudaErrorInvalidValue;
  const Args x{a_lin, ga,   mask, b,    gamma, beta, w_out, b_out, g_lin, g_bias, out, mean, inv,
               a_sb,  a_si, a_sk, g_sb, g_si,  g_sk, m_sb,  m_si,  m_sk,  nb,     ni,  nj,   nk,
               eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c == 32 && d == 32) return dispatch<32, 32>(x, dtype, ws, ws_numel, st);     // MINI
  if (c == 32 && d == 128) return dispatch<32, 128>(x, dtype, ws, ws_numel, st);
  if (c == 128 && d == 32) return dispatch<128, 32>(x, dtype, ws, ws_numel, st);
  if (c == 128 && d == 128) return dispatch<128, 128>(x, dtype, ws, ws_numel, st);  // FULL
  return (int)cudaErrorInvalidValue;
}
