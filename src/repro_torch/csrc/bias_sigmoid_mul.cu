// Gating: out = sigmoid(g + bg) * v, for Hopper (sm_90a).
//
// Replaces the TPU kernel `bias_sigmoid_mul_pallas`
// (src/repro/kernels/fused_elementwise.py): the Evoformer's attention and
// triangle output gates, computed in fp32 with the output in v's dtype.
//
// Bound on the H100: memory. Two tensors in, one out, a handful of operations
// per element; the bound is those bytes over 3.35 TB/s.
//
// Design: a grid-stride elementwise pass over the flat, contiguous tensors;
// the bias of C channels is indexed by i % C (kept incrementally) and
// stays in L1. Neighbouring
// threads touch neighbouring elements, so every load and store is coalesced.
// The grid is sized to a few waves of the 132 SMs and the loop covers the rest.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void bias_sigmoid_mul_kernel(const T* __restrict__ g, const float* __restrict__ bg,
                                        const T* __restrict__ v, T* __restrict__ out,
                                        long long n, int c) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // The channel is tracked incrementally: one 64-bit modulo per thread, not
  // one per element.
  int col = (int)(i % c);
  const int step = (int)(stride % c);
  for (; i < n; i += stride) {
    const float z = to_f(g[i]) + bg[col];
    const float s = 1.f / (1.f + expf(-z));
    out[i] = from_f<T>(s * to_f(v[i]));
    col += step;
    if (col >= c) col -= c;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int bias_sigmoid_mul_fwd(const void* g, const void* bg, const void* v, void* out,
                                    long long n, int c, int dtype, void* stream) {
  if (n <= 0) return 0;
  constexpr int kThreads = 256;
  long long blocks = (n + kThreads - 1) / kThreads;
  const long long max_blocks = 132LL * 16;  // a few waves; the loop covers the rest
  if (blocks > max_blocks) blocks = max_blocks;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    bias_sigmoid_mul_kernel<float><<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const float*>(g), static_cast<const float*>(bg),
        static_cast<const float*>(v), static_cast<float*>(out), n, c);
  } else if (dtype == 1) {
    bias_sigmoid_mul_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(g), static_cast<const float*>(bg),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), n, c);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
