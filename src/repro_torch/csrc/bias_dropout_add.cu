// Bias + dropout + residual add, for Hopper (sm_90a).
//
// Replaces the TPU kernel `bias_dropout_add_pallas`
// (src/repro/kernels/fused_elementwise.py, body `_bias_dropout_add_kernel`):
//   out = residual + keep * (x + b) / (1 - rate)
// summed in fp32 and cast once to the residual's dtype: the Evoformer's
// residual adds that apply row or column dropout in training.
//
// Bound on the H100: memory. x and the residual are read once and the output
// written once, with a few operations per element: at FULL width (a
// (1, 128, 256, 256) MSA or (1, 256, 256, 128) pair update in bf16) about
// 50 MB, so about 0.015 ms at 3.35 TB/s. On an H100 80GB HBM3 at 700 W,
// with its inputs cold in device memory, this kernel moves them at about
// 2.4 TB/s.
//
// Design:
//  * the mask is the reduced Bernoulli draw (0/1, fp32 or uint8) at its own
//    shape, with the shared axis of size 1; the kernel reads it through
//    broadcast strides (stride 0 along the shared axis), so no full-size mask
//    is written or read, where the reference streams a broadcast fp32 mask as
//    large as x. The reduced mask (at most a few hundred KB) stays in L1/L2;
//  * the grid is rows x channel vectors: blockIdx.z and blockIdx.y are the
//    row's i0 and i1, blockIdx.x with threadIdx.y its i2, so a row's mask
//    offset i0*ks0 + i1*ks1 + i2*ks2 is formed once per thread from the grid,
//    with no division anywhere; threadIdx.x walks the row's 8-channel
//    vectors, one a thread at the main path's widths (C = 256: 32 threads
//    a row, 4 rows a block of 128), so each thread has a 16-byte load of x
//    and one of the residual in flight (bf16; twice that in fp32) and the
//    grid has one thread per vector; the loads are issued as raw vectors
//    before any element is converted, and the bias is a template argument,
//    so the main path's instantiation has no bias code. On the card, two or
//    four vectors a thread (fewer, longer-lived threads), 256- or 512-thread
//    blocks and a runtime bias test were each slower;
//  * where the mask's channel stride is 1 and its rows are aligned, a
//    vector's 8 mask entries are one 32-byte (fp32) or 8-byte (uint8) load;
//    otherwise (a mask shared along the channels, or a full-size mask read
//    through other strides) they are read one by one;
//  * offsets are 32-bit where the tensor and the mask span fit in int32, as
//    they do at every main-path shape; the launcher takes a 64-bit
//    instantiation otherwise;
//  * no bias (the Evoformer passes none) and no mask are both allowed;
//  * the division by (1 - rate) is the reference's: y * keep / (1 - rate) in
//    fp32, not a multiplication by a reciprocal. The arithmetic per element
//    is the earlier version's, in the same order, so the result is
//    bit-identical to it and to the plain version's fp32 expression before
//    its one rounding.
// The kernel launches on the caller's stream, allocates nothing and does not
// synchronise.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;
constexpr int kThreads = 128;

// 8 consecutive elements as loaded: one 16-byte vector of bf16, two of
// fp32; converted to fp32 one element at a time where they are used.
template <typename T> struct Vec8;

template <> struct Vec8<float> {
  struct Raw { float4 a, b; };
  static __device__ __forceinline__ Raw load(const float* p) {
    return {__ldg(reinterpret_cast<const float4*>(p)),
            __ldg(reinterpret_cast<const float4*>(p + 4))};
  }
  static __device__ __forceinline__ float get(const Raw& r, int i) {
    const float4& h = i < 4 ? r.a : r.b;
    const int j = i & 3;
    return j == 0 ? h.x : j == 1 ? h.y : j == 2 ? h.z : h.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&o)[kVec]) {
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(o[4], o[5], o[6], o[7]);
  }
};

template <> struct Vec8<__nv_bfloat16> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ float get(const Raw& r, int i) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
    return (i & 1) ? __high2float(h[i >> 1]) : __low2float(h[i >> 1]);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&o)[kVec]) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < kVec / 2; ++i) h[i] = __floats2bfloat162_rn(o[2 * i], o[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};

// A vector's 8 mask entries: one aligned load where the channel stride is 1
// (kVecKeep), else one load each.
template <bool kVecKeep, typename I>
__device__ __forceinline__ void load_keep8(const float* p, I ksc, float (&k)[kVec]) {
  if (kVecKeep) {
    const Vec8<float>::Raw r = Vec8<float>::load(p);
#pragma unroll
    for (int i = 0; i < kVec; ++i) k[i] = Vec8<float>::get(r, i);
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i) k[i] = p[(I)i * ksc];
  }
}
template <bool kVecKeep, typename I>
__device__ __forceinline__ void load_keep8(const uint8_t* p, I ksc, float (&k)[kVec]) {
  if (kVecKeep) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    const uint8_t* b = reinterpret_cast<const uint8_t*>(&u);
#pragma unroll
    for (int i = 0; i < kVec; ++i) k[i] = (float)b[i];
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i) k[i] = (float)p[(I)i * ksc];
  }
}

// x, residual, out: contiguous (d0, d1, d2, c), c = 8 * nvr. keep: NULL or
// read at i0 * ks0 + i1 * ks1 + i2 * ks2 + ch * ksc (broadcast strides);
// kVecKeep: ksc == 1 and every row's first entry aligned for one load;
// kBias: b is not NULL. Block (bx, by): bx threads along a row's vectors,
// one vector each (the loop covers rows of more than bx vectors), by rows;
// grid (ceil(d2 / by), d1, d0).
template <typename T, typename K, typename I, bool kVecKeep, bool kBias>
__global__ void __launch_bounds__(kThreads)
bias_dropout_add_kernel(const T* __restrict__ x, const float* __restrict__ b,
                        const T* __restrict__ res, const K* __restrict__ keep,
                        T* __restrict__ out, int nvr, int d1, int d2, I ks0, I ks1, I ks2,
                        I ksc, float keep_den) {
  const int i2 = blockIdx.x * blockDim.y + threadIdx.y;
  if (i2 >= d2) return;
  const I row = ((I)blockIdx.z * d1 + (I)blockIdx.y) * d2 + i2;
  const I base = row * nvr * kVec;
  const I kbase = (I)blockIdx.z * ks0 + (I)blockIdx.y * ks1 + (I)i2 * ks2;
  for (int v = threadIdx.x; v < nvr; v += blockDim.x) {
    const int ch = v * kVec;
    const typename Vec8<T>::Raw xr = Vec8<T>::load(x + base + ch);
    const typename Vec8<T>::Raw rr = Vec8<T>::load(res + base + ch);
    float k[kVec];
    if (keep != nullptr) load_keep8<kVecKeep, I>(keep + kbase + (I)ch * ksc, ksc, k);
    float o[kVec];
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      float y = Vec8<T>::get(xr, u);
      if (kBias) y += __ldg(b + ch + u);
      if (keep != nullptr) y = y * k[u] / keep_den;
      o[u] = Vec8<T>::get(rr, u) + y;
    }
    Vec8<T>::store(out + base + ch, o);
  }
}

// The launch geometry the wrapper computes once per (shape, mask layout,
// dtypes) and hands over by address.
struct Geom {
  long long d0, d1, d2, c;          // x viewed as (d0, d1, d2, c)
  long long ks0, ks1, ks2, ksc;     // the mask's broadcast strides (elements)
  long long dtype, keep_dtype;      // 0 = float32, 1 = bfloat16; 0 = float32, 1 = uint8
};

template <typename T, typename K, typename I, bool kVecKeep, bool kBias>
int launch(const void* x, const void* b, const void* res, const void* keep, void* out,
           const Geom& g, float keep_den, cudaStream_t st) {
  const int nvr = (int)(g.c / kVec);
  // One vector a thread: bx the least power of two with bx >= nvr, at most
  // 32.
  int bx = 1;
  while (bx < 32 && bx < nvr) bx *= 2;
  const int by = kThreads / bx;
  const dim3 grid((unsigned)((g.d2 + by - 1) / by), (unsigned)g.d1, (unsigned)g.d0);
  bias_dropout_add_kernel<T, K, I, kVecKeep, kBias><<<grid, dim3(bx, by), 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(b), static_cast<const T*>(res),
      static_cast<const K*>(keep), static_cast<T*>(out), nvr, (int)g.d1, (int)g.d2,
      (I)g.ks0, (I)g.ks1, (I)g.ks2, (I)g.ksc, keep_den);
  return (int)cudaGetLastError();
}

template <typename T, typename K, typename I>
int launch_vec(const void* x, const void* b, const void* res, const void* keep, void* out,
               const Geom& g, float keep_den, cudaStream_t st) {
  // One aligned load per vector needs ksc == 1, row offsets that are
  // multiples of 8 entries and an aligned start (32 bytes of fp32 are read
  // as two 16-byte loads, 8 bytes of uint8 as one).
  const uintptr_t align = sizeof(K) == 4 ? 16 : 8;
  const bool vec = keep != nullptr && g.ksc == 1 && g.ks0 % kVec == 0 &&
                   g.ks1 % kVec == 0 && g.ks2 % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(keep) % align == 0;
  if (b != nullptr)
    return vec ? launch<T, K, I, true, true>(x, b, res, keep, out, g, keep_den, st)
               : launch<T, K, I, false, true>(x, b, res, keep, out, g, keep_den, st);
  return vec ? launch<T, K, I, true, false>(x, b, res, keep, out, g, keep_den, st)
             : launch<T, K, I, false, false>(x, b, res, keep, out, g, keep_den, st);
}

template <typename T, typename I>
int launch_keep(const void* x, const void* b, const void* res, const void* keep, void* out,
                const Geom& g, float keep_den, cudaStream_t st) {
  if (g.keep_dtype == 0) return launch_vec<T, float, I>(x, b, res, keep, out, g, keep_den, st);
  if (g.keep_dtype == 1) return launch_vec<T, uint8_t, I>(x, b, res, keep, out, g, keep_den, st);
  return (int)cudaErrorInvalidValue;
}

template <typename I>
int launch_dtype(const void* x, const void* b, const void* res, const void* keep, void* out,
                 const Geom& g, float keep_den, cudaStream_t st) {
  if (g.dtype == 0) return launch_keep<float, I>(x, b, res, keep, out, g, keep_den, st);
  if (g.dtype == 1)
    return launch_keep<__nv_bfloat16, I>(x, b, res, keep, out, g, keep_den, st);
  return (int)cudaErrorInvalidValue;
}

long long abs_ll(long long v) { return v < 0 ? -v : v; }

}  // namespace

// x, residual, out: contiguous (d0, d1, d2, c) with c % 8 == 0, d0 and d1 at
// most 65535 (grid extents) and 16-byte aligned starts. b: (c,) fp32, or
// NULL. keep: a 0/1 mask read at element offset i0 * ks0 + i1 * ks1 +
// i2 * ks2 + ch * ksc, or NULL (no dropout). geom: the Geom above, as 10
// long longs. keep_den = 1 - rate. Returns the cudaError_t of the launch.
extern "C" int bias_dropout_add_fwd(const void* x, const void* b, const void* res,
                                    const void* keep, void* out, const long long* geom,
                                    float keep_den, void* stream) {
  const Geom& g = *reinterpret_cast<const Geom*>(geom);
  if (g.c <= 0 || g.c % kVec != 0 || g.d0 < 0 || g.d1 < 0 || g.d2 < 0 || g.d0 > 65535 ||
      g.d1 > 65535 || g.d2 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const long long n = g.d0 * g.d1 * g.d2 * g.c;
  if (n == 0) return 0;
  // The largest offset either index type must hold: the tensor's and the
  // mask's (a bound on the mask's: every stride times its extent).
  const long long kspan = abs_ll(g.ks0) * g.d0 + abs_ll(g.ks1) * g.d1 + abs_ll(g.ks2) * g.d2 +
                          abs_ll(g.ksc) * g.c;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0x7fffffffLL && kspan <= 0x7fffffffLL)
    return launch_dtype<int>(x, b, res, keep, out, g, keep_den, st);
  return launch_dtype<long long>(x, b, res, keep, out, g, keep_den, st);
}
