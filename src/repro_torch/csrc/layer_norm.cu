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
// Design: one warp per row; the leading dims are folded into rows because the
// tensor is contiguous. A block holds 8 warps (8 rows). Statistics are
// two-pass, as the plain version computes them: the warp sums the row for the
// mean, then sums the squared deviations for the variance (no cancellation of
// a one-pass sum/sumsq). Each lane walks the row with a stride of 32 elements
// so a warp's loads are contiguous; the second and third reads of a row hit
// L1, so device memory sees each byte once. Shuffles reduce across the warp;
// nothing goes through shared memory.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kWarpsPerBlock = 8;

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

template <typename T>
__global__ void layer_norm_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                                  const float* __restrict__ beta, T* __restrict__ out,
                                  long long rows, int c, float eps) {
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int layer_norm_fwd(const void* x, const void* gamma, const void* beta, void* out,
                              long long rows, int c, float eps, int dtype, void* stream) {
  if (rows <= 0) return 0;
  const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks), block(32 * kWarpsPerBlock);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    layer_norm_kernel<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<float*>(out), rows, c, eps);
  } else if (dtype == 1) {
    layer_norm_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<__nv_bfloat16*>(out), rows, c, eps);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
