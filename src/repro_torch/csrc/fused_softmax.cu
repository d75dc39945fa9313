// Fused scale + bias + mask + softmax over the last axis, for Hopper (sm_90a).
//
// Replaces the TPU kernel `fused_softmax_pallas` (src/repro/kernels/
// fused_softmax.py, body `_softmax_kernel`): y = softmax(scale*x + bias + mask)
// over C for x (N, H, R, C), with bias (B, H, R, C) shared by the N/B
// consecutive rows n of x (bias row n / rep), or none, and an additive fp32
// mask (N, C) broadcast over H and R, or none. The logits are summed in fp32
// in the reference's order and roundings (x*scale, then + bias, then + mask,
// no fused multiply-add), the row max is subtracted before the exponential,
// and a non-finite max (a row that is all -inf) is taken as 0, as the
// reference's guard does; such a row then sums to 0 and comes out
// 0 * (1/0) = NaN, as the reference's 0/0. The output is in x's dtype.
//
// Bound on the H100: memory. Each element of x and of the output crosses
// device memory once, the bias (0.5-1.2 MB at the main path's shapes, held
// in L2) once per call and the mask once per run of rows, with ~12
// instructions an element, far below the ~295 operations a byte that would
// make the card compute-bound. So the bound is those bytes over 3.35 TB/s.
// The TPU kernel's ROW_TILE = 8 and its 128-lane padding of C are TPU
// layout rules and do not carry over.
//
// Design, C <= 1024 (every main-path call), the rows kernel:
//  * a row is split over `lpr` lanes (a power of two up to 32) as the
//    wrapper's `softmax_partition` says: 16-byte vectors (8 bf16, 4 fp32)
//    where C is whole vectors and the pointers are aligned, lane l of a row
//    holding its vectors l, l + lpr, ... (NVL of them), so a lane group's
//    loads are contiguous: 32 lanes a row at C = 256, 16 lanes (two rows a
//    warp) at C = 128, 16 lanes of three vectors at C = 384; vectors past C
//    (a C such as 200) are predicated. Otherwise one element at a time;
//  * a warp takes a run of `steps * 2 * (32 / lpr)` consecutive rows, each
//    lane group two rows at a time (both rows' x and bias loads issued
//    before either is reduced; `softmax_steps` makes runs as long as the
//    call still fills two waves: 16 rows a warp at C = 256). The rows
//    (n, h, r) of a run share mask row n (H*R consecutive rows do): a lane
//    loads its part of that row once, as float4s, into registers, and
//    again only where its row crosses into the next n. n and the bias row
//    are kept incrementally: one 64-bit division a lane at the start of its
//    run, and one only where a row crosses an n. They and the offsets are
//    32-bit where the tensor has fewer than 2**30 elements (every main-path
//    call), 64-bit otherwise: 48 registers in place of 64 at C = 256 (the
//    build's ptxas report), so 5 blocks an SM in place of 4, which was
//    faster on the card at C = 128 and 256. Four rows at a time, and
//    launch bounds that force 5 to 8 blocks an SM (spilling), were each
//    slower there;
//  * per element: a packed bf16 -> fp32 conversion, the three fp32 roundings
//    of the logit, the max, 2^((l - m) log2 e) by ex2.approx.ftz (l - m
//    rounded first, so a row masked by -1e9 comes out uniform as in the
//    reference), the sum; then one IEEE reciprocal of the sum a row, a
//    multiply an element and a packed cast. Against the plain version's
//    exp and division: ex2.approx's 2 ulp and the rounding of (l - m) log2 e
//    (|l - m| 2^-24 relative), a few 1e-7 at the values above 1e-9, and one
//    rounding of the product;
//  * the max and the sum are reduced over the lane group with xor shuffles;
//    every lane of a warp runs the same steps, so the shuffles see the whole
//    warp; rows past the end are computed on zeros and not stored.
// 1024 < C <= 16384: one 512-thread block per row, up to 32 values a
// thread in registers (thread t holds elements i*512 + t), the max and the
// sum reduced across warps through shared memory, with the same arithmetic.
// Nothing is re-read from device memory: each row is loaded once. The
// kernels launch on the caller's stream, allocate nothing and do not
// synchronise.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 2;   // rows a lane group holds at once
constexpr int kMaxSteps = 64;
constexpr int kRowBlock = 512;
constexpr int kMaxWarpC = 1024;
constexpr int kMaxC = 16384;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// e^(l - m), l - m rounded first (see the note above).
__device__ __forceinline__ float exp_shifted(float l, float m) {
  return exp2_approx(__fmul_rn(__fsub_rn(l, m), kLog2e));
}

// The logit in the reference's order: x*scale, + bias, + mask, each rounded.
__device__ __forceinline__ float logit(float x, float scale, float b, float mk) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, scale), b), mk);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// VEC consecutive elements as loaded and stored: a 16-byte vector (8 bf16,
// 4 fp32), or one element (VEC = 1).
template <typename T, int VEC> struct Vec;

template <> struct Vec<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw zero() { return make_uint4(0u, 0u, 0u, 0u); }
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&f)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&f)[8]) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};

template <> struct Vec<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&f)[4]) {
    f[0] = r.x; f[1] = r.y; f[2] = r.z; f[3] = r.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&f)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <typename T> struct Vec<T, 1> {
  using Raw = T;
  static __device__ __forceinline__ Raw zero() { return from_f<T>(0.f); }
  static __device__ __forceinline__ Raw load(const T* p) { return *p; }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&f)[1]) { f[0] = to_f(r); }
  static __device__ __forceinline__ void store(T* p, const float (&f)[1]) { *p = from_f<T>(f[0]); }
};

// VEC mask entries from p (16-byte aligned where VEC > 1).
template <int VEC>
__device__ __forceinline__ void load_mask(const float* __restrict__ p, float (&m)[VEC]) {
  if constexpr (VEC == 1) {
    m[0] = __ldg(p);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p + i));
      m[i] = t.x; m[i + 1] = t.y; m[i + 2] = t.z; m[i + 3] = t.w;
    }
  }
}

// Max and sum over an aligned group of `lpr` lanes (every lane of the warp
// takes part).
__device__ __forceinline__ float group_max(float v, int lpr) {
  for (int off = lpr >> 1; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float group_sum(float v, int lpr) {
  for (int off = lpr >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The rows kernel (see the note above). Warp w of the grid takes rows
// [w * warp_rows, (w + 1) * warp_rows), warp_rows = steps * kRows * groups;
// lane group `grp` of it the rows w * warp_rows + t * groups + grp, t = 0, 1,
// ..., kRows at a time; lane `sub` of the group its vectors sub + k * lpr,
// k < NVL, of the row's nv = c / VEC. I: the offsets' type, int where the
// tensor has fewer than 2**30 elements (every main-path call).
template <typename T, int VEC, int NVL, typename I>
__global__ void __launch_bounds__(kThreads)
softmax_rows_kernel(const T* __restrict__ x, const T* __restrict__ bias,
                    const float* __restrict__ mask, T* __restrict__ out, I rows,
                    I hr, int rep, int c, float scale, int lpr_log2, int steps) {
  using V = Vec<T, VEC>;
  const int lpr = 1 << lpr_log2;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (lpr - 1);
  const int groups = 32 >> lpr_log2;
  const int nv = c / VEC;
  const I warp_rows = (I)steps * kRows * groups;
  const I w0 = ((I)blockIdx.x * kWarps + (threadIdx.x >> 5)) * warp_rows;
  if (w0 >= rows) return;  // the whole warp

  // The lane group's next row, its n, its place in n's H*R rows and its
  // bias batch.
  I row = w0 + (lane >> lpr_log2);
  I n = row / hr;
  I in = row - n * hr;
  I nb = n / rep;
  I mask_n = -1;  // the mask row held in mk
  float mk[NVL][VEC];
#pragma unroll
  for (int k = 0; k < NVL; ++k)
#pragma unroll
    for (int i = 0; i < VEC; ++i) mk[k][i] = 0.f;

  for (int s = 0; s < steps; ++s) {
    if (w0 + (I)s * kRows * groups >= rows) break;  // the whole warp
    typename V::Raw xr[kRows][NVL], br[kRows][NVL];
    I rrow[kRows], rn[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      rrow[q] = row;
      rn[q] = n;
      const bool ok = row < rows;
      const T* xp = x + row * c;
      const T* bp = bias + (nb * hr + in) * c;
#pragma unroll
      for (int k = 0; k < NVL; ++k) {
        const int vi = sub + k * lpr;
        const bool ld = ok && vi < nv;
        xr[q][k] = ld ? V::load(xp + vi * VEC) : V::zero();
        br[q][k] = (ld && bias != nullptr) ? V::load(bp + vi * VEC) : V::zero();
      }
      row += groups;
      in += groups;
      if (in >= hr) {
        n += in / hr;
        in %= hr;
        nb = n / rep;
      }
    }
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const bool ok = rrow[q] < rows;
      if (mask != nullptr && ok && rn[q] != mask_n) {
        mask_n = rn[q];
        const float* mp = mask + mask_n * c;
#pragma unroll
        for (int k = 0; k < NVL; ++k) {
          const int vi = sub + k * lpr;
          if (vi < nv) load_mask<VEC>(mp + vi * VEC, mk[k]);
        }
      }
      float v[NVL][VEC];
      float m = -INFINITY;
#pragma unroll
      for (int k = 0; k < NVL; ++k) {
        float xf[VEC], bf[VEC];
        V::unpack(xr[q][k], xf);
        V::unpack(br[q][k], bf);
        const bool valid = sub + k * lpr < nv;
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          // Without a bias or a mask the term is +0.f, which leaves the
          // logit's bits as they are (-0.f + 0.f aside, which exp maps to 1
          // either way).
          const float l = logit(xf[i], scale, bf[i], mask != nullptr ? mk[k][i] : 0.f);
          v[k][i] = valid ? l : -INFINITY;
          m = fmaxf(m, v[k][i]);
        }
      }
      m = group_max(m, lpr);
      if (!isfinite(m)) m = 0.f;
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < NVL; ++k)
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          v[k][i] = exp_shifted(v[k][i], m);
          sum += v[k][i];
        }
      const float inv = __frcp_rn(group_sum(sum, lpr));
      if (!ok) continue;
      T* op = out + rrow[q] * c;
#pragma unroll
      for (int k = 0; k < NVL; ++k) {
        const int vi = sub + k * lpr;
        if (vi >= nv) continue;
#pragma unroll
        for (int i = 0; i < VEC; ++i) v[k][i] *= inv;
        V::store(op + vi * VEC, v[k]);
      }
    }
  }
}

// One 512-thread block per row; ITEMS values a thread.
template <typename T, int ITEMS>
__global__ void __launch_bounds__(kRowBlock)
softmax_block_kernel(const T* __restrict__ x, const T* __restrict__ bias,
                     const float* __restrict__ mask, T* __restrict__ out, long long hr,
                     int rep, int c, float scale) {
  __shared__ float red[kRowBlock / 32];
  __shared__ float bcast;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row = blockIdx.x;
  const long long n = row / hr;
  const long long px = row * c;
  const long long pb = ((n / rep) * hr + (row - n * hr)) * c;
  const long long pm = n * c;

  float v[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int idx = i * kRowBlock + tid;
    if (idx < c) {
      v[i] = logit(to_f(x[px + idx]), scale, bias != nullptr ? to_f(bias[pb + idx]) : 0.f,
                   mask != nullptr ? mask[pm + idx] : 0.f);
    } else {
      v[i] = -INFINITY;
    }
  }

  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) m = fmaxf(m, v[i]);
  m = group_max(m, 32);
  if (lane == 0) red[warp] = m;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kRowBlock / 32 ? red[lane] : -INFINITY;
    t = group_max(t, 32);
    if (lane == 0) bcast = isfinite(t) ? t : 0.f;
  }
  __syncthreads();
  m = bcast;

  float s = 0.f;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    v[i] = exp_shifted(v[i], m);
    s += v[i];
  }
  s = group_sum(s, 32);
  __syncthreads();  // every thread has read bcast before it is rewritten
  if (lane == 0) red[warp] = s;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kRowBlock / 32 ? red[lane] : 0.f;
    t = group_sum(t, 32);
    if (lane == 0) bcast = __frcp_rn(t);
  }
  __syncthreads();
  const float inv = bcast;

#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int idx = i * kRowBlock + tid;
    if (idx < c) out[px + idx] = from_f<T>(v[i] * inv);
  }
}

template <typename T, int VEC, int NVL>
void launch_rows(const T* x, const T* bias, const float* mask, T* out, long long rows,
                 long long hr, int rep, int c, float scale, int lpr_log2, int steps,
                 unsigned blocks, cudaStream_t st) {
  // int offsets where even a row past the end (rows + 8 runs, each at most
  // 4096 rows of at most 1024 elements) stays below 2**31.
  if (rows * c < (1LL << 30))
    softmax_rows_kernel<T, VEC, NVL, int><<<blocks, kThreads, 0, st>>>(
        x, bias, mask, out, (int)rows, (int)hr, rep, c, scale, lpr_log2, steps);
  else
    softmax_rows_kernel<T, VEC, NVL, long long><<<blocks, kThreads, 0, st>>>(
        x, bias, mask, out, rows, hr, rep, c, scale, lpr_log2, steps);
}

// The launch geometry the wrapper computes once per (shapes, layouts,
// dtype) and hands over by address (`softmax_geometry`).
struct Geom {
  long long rows, hr, rep, c;  // rows = N*H*R, hr = H*R, rep = N/B (1 without a bias)
  long long dtype;             // 0 = float32, 1 = bfloat16
  long long lpr_log2, nvl;     // lanes a row (log2), vectors a lane; nvl = 0: block per row
  long long vec;               // elements a vector: 16 / sizeof(dtype), or 1
  long long steps;             // times a lane group takes kRows rows
};

template <typename T>
int launch(const void* xv, const void* biasv, const float* mask, void* outv, const Geom& g,
           float scale, cudaStream_t st) {
  const T* x = static_cast<const T*>(xv);
  const T* bias = static_cast<const T*>(biasv);
  T* out = static_cast<T*>(outv);
  const int c = (int)g.c, rep = (int)g.rep;
  constexpr int kVec = 16 / sizeof(T);
  if (g.nvl == 0) {
    if (c <= kMaxWarpC || g.rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const int items = (c + kRowBlock - 1) / kRowBlock;
    const dim3 grid((unsigned)g.rows), block(kRowBlock);
    if (items <= 4) {
      softmax_block_kernel<T, 4><<<grid, block, 0, st>>>(x, bias, mask, out, g.hr, rep, c, scale);
    } else if (items <= 8) {
      softmax_block_kernel<T, 8><<<grid, block, 0, st>>>(x, bias, mask, out, g.hr, rep, c, scale);
    } else if (items <= 16) {
      softmax_block_kernel<T, 16><<<grid, block, 0, st>>>(x, bias, mask, out, g.hr, rep, c,
                                                          scale);
    } else {
      softmax_block_kernel<T, 32><<<grid, block, 0, st>>>(x, bias, mask, out, g.hr, rep, c,
                                                          scale);
    }
    return (int)cudaGetLastError();
  }
  if (c > kMaxWarpC || g.lpr_log2 < 0 || g.lpr_log2 > 5 || g.steps < 1 ||
      g.steps > kMaxSteps || (g.vec != 1 && g.vec != kVec) || c % g.vec != 0 || g.nvl * (g.vec << g.lpr_log2) < c)
    return (int)cudaErrorInvalidValue;
  const int lpr_log2 = (int)g.lpr_log2, steps = (int)g.steps;
  const long long warp_rows = g.steps * kRows * (32 >> lpr_log2);
  const long long warps = (g.rows + warp_rows - 1) / warp_rows;
  const long long blocks = (warps + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const unsigned b = (unsigned)blocks;
#define SM_ROWS(V, NV)                                                                       \
  case NV:                                                                                   \
    launch_rows<T, V, NV>(x, bias, mask, out, g.rows, g.hr, rep, c, scale, lpr_log2, steps, \
                          b, st);                                                            \
    break;
  if (g.vec == kVec) {
    switch (g.nvl) {
      SM_ROWS(kVec, 1) SM_ROWS(kVec, 2) SM_ROWS(kVec, 3) SM_ROWS(kVec, 4)
      SM_ROWS(kVec, 5) SM_ROWS(kVec, 6) SM_ROWS(kVec, 7) SM_ROWS(kVec, 8)
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    switch (g.nvl) {
      SM_ROWS(1, 1) SM_ROWS(1, 2) SM_ROWS(1, 4) SM_ROWS(1, 8) SM_ROWS(1, 16) SM_ROWS(1, 32)
      default: return (int)cudaErrorInvalidValue;
    }
  }
#undef SM_ROWS
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: (N, H, R, C) contiguous; bias: (B, H, R, C) contiguous in x's
// dtype, or null; mask: (N, C) contiguous fp32, or null. geom: the Geom
// above, as 9 long longs (the wrapper's partition: the rows kernel with
// vec = 16 / sizeof(dtype) only where it divides C and every pointer is
// 16-byte aligned, nvl * vec * 2**lpr_log2 >= C; nvl = 0, the block kernel,
// for 1024 < C <= 16384). Returns the cudaError_t of the launch.
extern "C" int fused_softmax_fwd(const void* x, const void* bias, const void* mask, void* out,
                                 const long long* geom, float scale, void* stream) {
  const Geom& g = *reinterpret_cast<const Geom*>(geom);
  if (g.rows <= 0) return 0;
  if (g.c <= 0 || g.c > kMaxC || g.hr <= 0 || g.rep <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  if (g.dtype == 0) return launch<float>(x, bias, m, out, g, scale, st);
  if (g.dtype == 1) return launch<__nv_bfloat16>(x, bias, m, out, g, scale, st);
  return (int)cudaErrorInvalidValue;
}
