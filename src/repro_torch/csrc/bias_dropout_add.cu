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
// 50 MB, so about 0.015 ms at 3.35 TB/s.
//
// Design:
//  * the mask is the reduced Bernoulli draw (0/1, fp32 or uint8) at its own
//    shape, with the shared axis of size 1; the kernel reads it through
//    broadcast strides (stride 0 along the shared axis), so no full-size mask
//    is written or read, where the reference streams a broadcast fp32 mask as
//    large as x. The reduced mask (at most a few hundred KB) stays in L1/L2;
//  * one thread handles 8 consecutive channels of one row: 16-byte loads of
//    x and the residual in bf16 (two in fp32) and one 16-byte store, so a
//    warp's accesses are contiguous; the row's (i0, i1, i2) index, which
//    locates its mask entries, is decoded once per 8 elements;
//  * no bias (the Evoformer passes none) and no mask are both allowed;
//  * the division by (1 - rate) is the reference's: y * keep / (1 - rate) in
//    fp32, not a multiplication by a reciprocal.
// The grid is sized to a few waves of the 132 SMs and a grid-stride loop
// covers the rest. The kernel launches on the caller's stream, allocates
// nothing and does not synchronise.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(uint8_t x) { return (float)x; }

template <typename T> struct Vec8;

template <> struct Vec8<float> {
  static __device__ __forceinline__ void load(const float* p, float (&o)[kVec]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&o)[kVec]) {
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(o[4], o[5], o[6], o[7]);
  }
};

template <> struct Vec8<__nv_bfloat16> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&o)[kVec]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < kVec / 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&o)[kVec]) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < kVec / 2; ++i) h[i] = __floats2bfloat162_rn(o[2 * i], o[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};

// x, residual, out: contiguous, viewed as (d0, d1, d2, c). keep: NULL or read
// at i0 * ks0 + i1 * ks1 + i2 * ks2 + ch * ksc (broadcast strides).
template <typename T, typename K>
__global__ void bias_dropout_add_kernel(const T* __restrict__ x, const float* __restrict__ b,
                                        const T* __restrict__ res, const K* __restrict__ keep,
                                        T* __restrict__ out, long long n_vec, int c, int d1,
                                        int d2, long long ks0, long long ks1, long long ks2,
                                        long long ksc, float keep_den) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n_vec;
       i += stride) {
    const long long e = i * kVec;
    const long long row = e / c;
    const int ch = (int)(e - row * c);
    float xv[kVec], rv[kVec], ov[kVec];
    Vec8<T>::load(x + e, xv);
    Vec8<T>::load(res + e, rv);
    long long koff = 0;
    if (keep != nullptr) {
      const int i2 = (int)(row % d2);
      const long long t = row / d2;
      const int i1 = (int)(t % d1);
      const long long i0 = t / d1;
      koff = i0 * ks0 + i1 * ks1 + i2 * ks2 + ch * ksc;
    }
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      float y = xv[u];
      if (b != nullptr) y += b[ch + u];
      if (keep != nullptr) y = y * to_f(keep[koff + u * ksc]) / keep_den;
      ov[u] = rv[u] + y;
    }
    Vec8<T>::store(out + e, ov);
  }
}

template <typename T, typename K>
int launch(const void* x, const void* b, const void* res, const void* keep, void* out,
           long long n_vec, int c, int d1, int d2, long long ks0, long long ks1, long long ks2,
           long long ksc, float keep_den, cudaStream_t st) {
  constexpr int kThreads = 256;
  long long blocks = (n_vec + kThreads - 1) / kThreads;
  const long long max_blocks = 132LL * 16;  // a few waves; the loop covers the rest
  if (blocks > max_blocks) blocks = max_blocks;
  bias_dropout_add_kernel<T, K><<<(unsigned)blocks, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(b), static_cast<const T*>(res),
      static_cast<const K*>(keep), static_cast<T*>(out), n_vec, c, d1, d2, ks0, ks1, ks2, ksc,
      keep_den);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_keep(int keep_dtype, const void* x, const void* b, const void* res,
                const void* keep, void* out, long long n_vec, int c, int d1, int d2,
                long long ks0, long long ks1, long long ks2, long long ksc, float keep_den,
                cudaStream_t st) {
  if (keep_dtype == 0)
    return launch<T, float>(x, b, res, keep, out, n_vec, c, d1, d2, ks0, ks1, ks2, ksc,
                            keep_den, st);
  if (keep_dtype == 1)
    return launch<T, uint8_t>(x, b, res, keep, out, n_vec, c, d1, d2, ks0, ks1, ks2, ksc,
                              keep_den, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x, residual, out: contiguous (d0, d1, d2, c) with c % 8 == 0 and 16-byte
// aligned starts. b: (c,) fp32, or NULL. keep: a 0/1 mask read at element
// offset i0 * ks0 + i1 * ks1 + i2 * ks2 + ch * ksc, or NULL (no dropout).
// keep_den = 1 - rate. dtype: 0 = float32, 1 = bfloat16 (x, residual, out);
// keep_dtype: 0 = float32, 1 = uint8. Returns the cudaError_t of the launch.
extern "C" int bias_dropout_add_fwd(const void* x, const void* b, const void* res,
                                    const void* keep, void* out, long long d0, int d1, int d2,
                                    int c, long long ks0, long long ks1, long long ks2,
                                    long long ksc, float keep_den, int dtype, int keep_dtype,
                                    void* stream) {
  if (c <= 0 || c % kVec != 0 || d1 <= 0 || d2 <= 0 || d0 < 0) return (int)cudaErrorInvalidValue;
  const long long n_vec = d0 * d1 * d2 * (c / kVec);
  if (n_vec == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_keep<float>(keep_dtype, x, b, res, keep, out, n_vec, c, d1, d2, ks0, ks1,
                              ks2, ksc, keep_den, st);
  if (dtype == 1)
    return launch_keep<__nv_bfloat16>(keep_dtype, x, b, res, keep, out, n_vec, c, d1, d2, ks0,
                                      ks1, ks2, ksc, keep_den, st);
  return (int)cudaErrorInvalidValue;
}
