// Gating: out = sigmoid(g + bg) * v, for Hopper (sm_90a).
//
// Replaces the TPU kernel `bias_sigmoid_mul_pallas`
// (src/repro/kernels/fused_elementwise.py): the Evoformer's attention and
// triangle output gates, computed in fp32 with the output in v's dtype.
//
// Bound on the H100: memory. Two tensors in, one out, a handful of operations
// per element; the bound is those bytes over 3.35 TB/s (at the MSA-row gate,
// (1, 128, 256, 256) in bf16, 50 MB: 0.015 ms).
//
// Design (K3's shape, csrc/bias_dropout_add.cu):
//  * the grid is rows x channel vectors: a row of C channels is split over
//    `lanes` threads (a power of two up to 32: 32 at C = 256, 16 at C = 128
//    in bf16), blockIdx.x and the thread's row group give the row, so a
//    vector's channel is its position in the row, with no division or
//    modulo anywhere; each thread loads one 16-byte vector of g and one of v
//    (8 bf16, 4 fp32), two where a row has more vectors than lanes, issued
//    before any element is converted, and the bias beside them as float4s
//    from L1. The grid has one thread per vector at the main path's widths;
//  * the scalar variant (VEC = 1), in the same launch: one element a thread
//    for a C that is not whole vectors (C % 8 != 0 in bf16) or a view whose
//    pointers are not 16-byte aligned; the wrapper chooses (`gate_partition`);
//  * fp32 arithmetic. bf16 tensors (the main path) take the fast sigmoid
//    s = rcp(1 + 2^(-z log2 e)), ex2.approx.ftz (at most 2 ulp, plus the
//    rounding of -z log2 e: a relative error of |z| 2^-24 in the
//    exponential) and rcp.approx.ftz (1 ulp) in place of an IEEE expf and a
//    division; 2^x overflows to +inf for z < -88, where rcp gives 0, as the
//    sigmoid underflows there. That is a few 1e-7 of the sigmoid, far below
//    the output's bf16 rounding. fp32 tensors take the plain version's own
//    expression, 1 / (1 + expf(-z)): chip_smoke.py holds every fp32
//    gradient of the model against the CPU's, and the clamped FAPE loss
//    amplifies one ulp of the gate there (the fast sigmoid in fp32 moved
//    structure.bb_update.w's gradient by 3.5e-3 of its largest entry, over
//    the check's 1e-3; the plain expression keeps it at 1.8e-4, on an H100
//    80GB HBM3 at 700 W). The product s * v and the cast are the plain
//    version's;
//  * offsets are 32-bit where the tensor has fewer than 2**30 elements, as at
//    every main-path shape; a 64-bit instantiation otherwise.
// The kernel launches on the caller's stream, allocates nothing and does not
// synchronise.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float sigmoid_fast(float z) {
  float e, s;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(z * -1.4426950408889634f));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(s) : "f"(1.f + e));
  return s;
}

// bf16 (the main path) takes the fast sigmoid; fp32 the plain version's
// own expression (see the note above).
template <typename T>
__device__ __forceinline__ float sigmoid(float z) {
  if constexpr (sizeof(T) == 2) return sigmoid_fast(z);
  else return 1.f / (1.f + expf(-z));
}

// VEC consecutive elements as loaded and stored: a 16-byte vector (8 bf16,
// 4 fp32), or one element (VEC = 1).
template <typename T, int VEC> struct Vec;

template <> struct Vec<__nv_bfloat16, 8> {
  using Raw = uint4;
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
  static __device__ __forceinline__ Raw load(const T* p) { return *p; }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&f)[1]) {
    if constexpr (sizeof(T) == 4) f[0] = r; else f[0] = __bfloat162float(r);
  }
  static __device__ __forceinline__ void store(T* p, const float (&f)[1]) {
    if constexpr (sizeof(T) == 4) *p = f[0]; else *p = __float2bfloat16(f[0]);
  }
};

// The bias of VEC channels from `ch` (a multiple of 4 where VEC > 1).
template <int VEC>
__device__ __forceinline__ void load_bias(const float* __restrict__ bg, int ch, float (&b)[VEC]) {
  if constexpr (VEC == 1) {
    b[0] = __ldg(bg + ch);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(bg + ch + i));
      b[i] = t.x; b[i + 1] = t.y; b[i + 2] = t.z; b[i + 3] = t.w;
    }
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void gate(const typename Vec<T, VEC>::Raw& gr,
                                     const typename Vec<T, VEC>::Raw& vr,
                                     const float* __restrict__ bg, int ch, T* o) {
  float gf[VEC], vf[VEC], b[VEC], y[VEC];
  load_bias<VEC>(bg, ch, b);
  Vec<T, VEC>::unpack(gr, gf);
  Vec<T, VEC>::unpack(vr, vf);
#pragma unroll
  for (int i = 0; i < VEC; ++i) y[i] = sigmoid<T>(gf[i] + b[i]) * vf[i];
  Vec<T, VEC>::store(o, y);
}

// g, v, out: contiguous (rows, c); VEC divides c and, where VEC > 1, every
// pointer is 16-byte aligned. A row's nv = c / VEC vectors are split over
// 2**lanes_log2 threads: thread `sub` takes vectors sub, sub + lanes, ...,
// two at a time. Block: kThreads >> lanes_log2 rows.
template <typename T, int VEC, typename I>
__global__ void __launch_bounds__(kThreads)
bias_sigmoid_mul_kernel(const T* __restrict__ g, const float* __restrict__ bg,
                        const T* __restrict__ v, T* __restrict__ out, I rows, int c,
                        int lanes_log2) {
  using V = Vec<T, VEC>;
  const int lanes = 1 << lanes_log2;
  const int sub = threadIdx.x & (lanes - 1);
  const I row = (I)blockIdx.x * (kThreads >> lanes_log2) + (threadIdx.x >> lanes_log2);
  if (row >= rows) return;
  const I base = row * c;
  const int nv = c / VEC;
  for (int k = sub; k < nv; k += 2 * lanes) {
    const int ch0 = k * VEC, ch1 = (k + lanes) * VEC;
    const bool two = k + lanes < nv;
    const typename V::Raw g0 = V::load(g + base + ch0), v0 = V::load(v + base + ch0);
    typename V::Raw g1 = g0, v1 = v0;
    if (two) {
      g1 = V::load(g + base + ch1);
      v1 = V::load(v + base + ch1);
    }
    gate<T, VEC>(g0, v0, bg, ch0, out + base + ch0);
    if (two) gate<T, VEC>(g1, v1, bg, ch1, out + base + ch1);
  }
}

template <typename T, int VEC, typename I>
int launch(const void* g, const void* bg, const void* v, void* out, long long rows, int c,
           int lanes_log2, cudaStream_t st) {
  const long long per_block = kThreads >> lanes_log2;
  const long long blocks = (rows + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  bias_sigmoid_mul_kernel<T, VEC, I><<<(unsigned)blocks, kThreads, 0, st>>>(
      static_cast<const T*>(g), static_cast<const float*>(bg), static_cast<const T*>(v),
      static_cast<T*>(out), (I)rows, c, lanes_log2);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch_index(const void* g, const void* bg, const void* v, void* out, long long rows, int c,
                 int lanes_log2, cudaStream_t st) {
  // int offsets where even the last block's rows past the end stay below
  // 2**31.
  if (rows * c < (1LL << 30))
    return launch<T, VEC, int>(g, bg, v, out, rows, c, lanes_log2, st);
  return launch<T, VEC, long long>(g, bg, v, out, rows, c, lanes_log2, st);
}

}  // namespace

// g, v, out: contiguous (rows, c) in one dtype (0 = float32, 1 = bfloat16);
// bg: (c,) fp32. vec: 1, or 16 / sizeof(dtype) where that divides c and g,
// v, out and bg are 16-byte aligned; 2**lanes_log2 (at most 32) threads a
// row. Returns the cudaError_t of the launch.
extern "C" int bias_sigmoid_mul_fwd(const void* g, const void* bg, const void* v, void* out,
                                    long long rows, int c, int vec, int lanes_log2, int dtype,
                                    void* stream) {
  if (rows <= 0) return 0;
  if (c <= 0 || lanes_log2 < 0 || lanes_log2 > 5) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4 && c % 4 == 0)
    return launch_index<float, 4>(g, bg, v, out, rows, c, lanes_log2, st);
  if (dtype == 0 && vec == 1)
    return launch_index<float, 1>(g, bg, v, out, rows, c, lanes_log2, st);
  if (dtype == 1 && vec == 8 && c % 8 == 0)
    return launch_index<__nv_bfloat16, 8>(g, bg, v, out, rows, c, lanes_log2, st);
  if (dtype == 1 && vec == 1)
    return launch_index<__nv_bfloat16, 1>(g, bg, v, out, rows, c, lanes_log2, st);
  return (int)cudaErrorInvalidValue;
}
