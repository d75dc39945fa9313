// LayerNorm forward over the last axis, for Hopper (sm_90a).
//
// Replaces the TPU kernel `layer_norm_pallas` (src/repro/kernels/layer_norm.py,
// body `_layer_norm_kernel`): LayerNorm over C of a contiguous tensor with
// fp32 statistics, the affine gamma/beta, and the output in the input dtype.
//
// Bound on the H100: memory. Each element is read once and written once, with
// a few operations per element, far below the ~295 operations a byte that
// would make the card compute-bound. So the bound is (bytes in + bytes out)
// over 3.35 TB/s.
//
// Two variants behind one launch, chosen by C (the wrapper's
// `ln_partition`):
//  * the vector kernel, for rows of 16-byte vectors (C % 8 == 0 in bf16,
//    C % 4 == 0 in fp32) that fit the register envelope: a row is split over
//    `lpr` lanes (a power of two up to 32; 32 / lpr rows a warp), each lane
//    holding NVL <= 8 of its vectors, lane l the vectors l, l + lpr, ... so
//    that a warp's loads are contiguous. The row is read once, as 16-byte
//    vectors, into registers; the two-pass statistics (mean, then the mean
//    of squared deviations, as the plain version computes them) come from
//    those registers through shuffles; the output is written as 16-byte
//    vectors. gamma and beta are loaded once per thread as vectors, and each
//    thread has two rows in flight;
//  * the loop kernel, for any other C (not a multiple of the vector, wider
//    than the envelope, or a misaligned view): one warp per row walking it
//    with a stride of 32 elements, three reads of the row (the second and
//    third hit L1), gamma and beta per element.
// Neither allocates or synchronises; both launch on the caller's stream.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = 32 * kWarpsPerBlock;
constexpr int kRowsInFlight = 2;   // rows a thread of the vector kernel holds at once

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum over the `lpr` lanes of a row group (aligned groups of lpr lanes).
__device__ __forceinline__ float group_sum(float v, int lpr) {
  for (int off = lpr >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// 16 bytes <-> VEC values of T, as fp32.
template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
  __device__ __forceinline__ static void unpack(const uint4& u, float (&f)[N]) {
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int k = 0; k < N; ++k) f[k] = to_f(e[k]);
  }
  __device__ __forceinline__ static uint4 pack(const float (&f)[N]) {
    uint4 u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int k = 0; k < N; ++k) e[k] = from_f<T>(f[k]);
    return u;
  }
};

template <typename T, int NVL>
__global__ void __launch_bounds__(kThreads)
layer_norm_vec_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                      const float* __restrict__ beta, T* __restrict__ out, long long rows,
                      int c, int lpr_log2, float eps) {
  constexpr int V = Vec<T>::N;
  const int lpr = 1 << lpr_log2;
  const int sub = threadIdx.x & (lpr - 1);         // lane within its row group
  const int grp = threadIdx.x >> lpr_log2;         // row group within the block
  const int groups = kThreads >> lpr_log2;

  // gamma and beta of this lane's vectors, once.
  float g[NVL][V], bt[NVL][V];
#pragma unroll
  for (int k = 0; k < NVL; ++k) {
    const int e0 = (sub + k * lpr) * V;
#pragma unroll
    for (int q = 0; q < V; q += 4) {
      const float4 gv = __ldg(reinterpret_cast<const float4*>(gamma + e0 + q));
      const float4 bv = __ldg(reinterpret_cast<const float4*>(beta + e0 + q));
      g[k][q] = gv.x; g[k][q + 1] = gv.y; g[k][q + 2] = gv.z; g[k][q + 3] = gv.w;
      bt[k][q] = bv.x; bt[k][q + 1] = bv.y; bt[k][q + 2] = bv.z; bt[k][q + 3] = bv.w;
    }
  }

  // The block's rows: kRowsInFlight sets of `groups` consecutive rows.
  const long long row0 = (long long)blockIdx.x * groups * kRowsInFlight + grp;
  uint4 raw[kRowsInFlight][NVL];
#pragma unroll
  for (int r = 0; r < kRowsInFlight; ++r) {
    const long long row = row0 + (long long)r * groups;
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * c);
#pragma unroll
    for (int k = 0; k < NVL; ++k)
      raw[r][k] = row < rows ? xr[sub + k * lpr] : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int r = 0; r < kRowsInFlight; ++r) {
    // Every lane of the warp takes part in the shuffles; a row past the end
    // is computed on zeros and not stored.
    const long long row = row0 + (long long)r * groups;
    float v[NVL][V];
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < NVL; ++k) {
      Vec<T>::unpack(raw[r][k], v[k]);
#pragma unroll
      for (int q = 0; q < V; ++q) s += v[k][q];
    }
    const float mean = group_sum(s, lpr) / (float)c;
    float s2 = 0.f;
#pragma unroll
    for (int k = 0; k < NVL; ++k)
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const float d = v[k][q] - mean;
        s2 += d * d;
      }
    const float inv = rsqrtf(group_sum(s2, lpr) / (float)c + eps);
    if (row >= rows) continue;
    uint4* orow = reinterpret_cast<uint4*>(out + row * c);
#pragma unroll
    for (int k = 0; k < NVL; ++k) {
      float y[V];
#pragma unroll
      for (int q = 0; q < V; ++q) y[q] = (v[k][q] - mean) * inv * g[k][q] + bt[k][q];
      orow[sub + k * lpr] = Vec<T>::pack(y);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
layer_norm_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ beta, T* __restrict__ out, long long rows, int c,
                  float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * c;
  T* orow = out + row * c;

  float s = 0.f;
  for (int i = lane; i < c; i += 32) s += to_f(xr[i]);
  const float mean = warp_sum(s) / (float)c;

  float s2 = 0.f;
  for (int i = lane; i < c; i += 32) {
    const float d = to_f(xr[i]) - mean;
    s2 += d * d;
  }
  const float inv = rsqrtf(warp_sum(s2) / (float)c + eps);

  for (int i = lane; i < c; i += 32) {
    const float y = (to_f(xr[i]) - mean) * inv;
    orow[i] = from_f<T>(y * gamma[i] + beta[i]);
  }
}

template <typename T>
int launch(const void* x, const void* gamma, const void* beta, void* out, long long rows, int c,
           float eps, int lpr_log2, int nvl, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  const float* gp = static_cast<const float*>(gamma);
  const float* bp = static_cast<const float*>(beta);
  T* op = static_cast<T*>(out);
  if (nvl == 0) {
    const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    layer_norm_kernel<T><<<(unsigned)blocks, kThreads, 0, st>>>(xp, gp, bp, op, rows, c, eps);
    return (int)cudaGetLastError();
  }
  if (lpr_log2 < 0 || lpr_log2 > 5 || nvl < 0 || nvl > 8 ||
      (long long)nvl * (Vec<T>::N << lpr_log2) != c)
    return (int)cudaErrorInvalidValue;
  const long long per_block = (long long)(kThreads >> lpr_log2) * kRowsInFlight;
  const long long blocks = (rows + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
#define LN_VEC(NV)                                                                       \
  case NV:                                                                               \
    layer_norm_vec_kernel<T, NV><<<(unsigned)blocks, kThreads, 0, st>>>(xp, gp, bp, op, rows, \
                                                                        c, lpr_log2, eps); \
    break;
  switch (nvl) {
    LN_VEC(1) LN_VEC(2) LN_VEC(3) LN_VEC(4) LN_VEC(5) LN_VEC(6) LN_VEC(7) LN_VEC(8)
  }
#undef LN_VEC
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. nvl = 0: the loop kernel; otherwise the
// vector kernel with `nvl` 16-byte vectors a lane over 2**lpr_log2 lanes a
// row (nvl * 2**lpr_log2 * (16 / sizeof(dtype)) == C; x, gamma, beta and out
// 16-byte aligned). Returns the cudaError_t of the launch.
extern "C" int layer_norm_fwd(const void* x, const void* gamma, const void* beta, void* out,
                              long long rows, int c, float eps, int lpr_log2, int nvl, int dtype,
                              void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, gamma, beta, out, rows, c, eps, lpr_log2, nvl, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, gamma, beta, out, rows, c, eps, lpr_log2, nvl, st);
  return (int)cudaErrorInvalidValue;
}
