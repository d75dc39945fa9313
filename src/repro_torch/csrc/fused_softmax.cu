// Fused scale + bias + mask + softmax over the last axis, for Hopper (sm_90a).
//
// Replaces the TPU kernel `fused_softmax_pallas` (src/repro/kernels/
// fused_softmax.py, body `_softmax_kernel`): y = softmax(scale*x + bias + mask)
// over C for x (N, H, R, C), with bias (B, H, R, C) shared by the N/B
// consecutive rows n of x (bias row n / rep), or none, and an additive fp32
// mask (N, C) broadcast over H and R, or none. The logits are summed in fp32
// in the reference's order (x*scale, then + bias, then + mask), the row max
// is subtracted before exp, and a non-finite max (a row that is all -inf)
// is taken as 0, as the reference's guard does; such a row then sums to 0
// and comes out 0/0 = NaN, as in the reference. The output is in x's dtype.
//
// Bound on the H100: memory. Each element of x and of the output crosses
// device memory once, the bias once per call and the mask once per row
// group, with a few operations per element, far below the ~295 operations a
// byte that would make the card compute-bound. So the bound is those bytes
// over 3.35 TB/s. The TPU kernel's ROW_TILE = 8 and its 128-lane padding of
// C are TPU layout rules and do not carry over.
//
// Design (the paper's own GPU design, §IV.A.2):
// - C <= 1024: one warp per row, the row in registers (up to 32 values a
//   lane), 16-byte loads and stores where C and the pointers allow, the max
//   and the sum reduced with __shfl_xor_sync. Lane l holds the elements
//   (chunk*32 + l)*VEC .. +VEC-1, so a warp's loads are contiguous; a ragged
//   C is handled by predication (lanes past C hold -inf and add 0).
// - 1024 < C <= 16384: one 512-thread block per row, up to 32 values a
//   thread in registers (thread t holds elements i*512 + t), the max and the
//   sum reduced across warps through shared memory.
// Nothing is re-read from device memory: each row is loaded once.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kRowBlock = 512;
constexpr int kMaxWarpC = 1024;
constexpr int kMaxC = 16384;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Row pointers of one softmax row: x, bias (or null), mask (or null).
struct RowPtrs {
  long long x, bias, mask;
};

__device__ __forceinline__ RowPtrs row_offsets(long long row, long long hr, int rep, int c) {
  const long long n = row / hr;
  const long long in_group = row - n * hr;
  RowPtrs p;
  p.x = row * c;
  p.bias = ((n / rep) * hr + in_group) * c;
  p.mask = n * c;
  return p;
}

// One warp per row; E values a lane, loaded VEC at a time.
template <typename T, int VEC, int E>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
softmax_warp_kernel(const T* __restrict__ x, const T* __restrict__ bias,
                    const float* __restrict__ mask, T* __restrict__ out, long long rows,
                    long long hr, int rep, int c, float scale) {
  constexpr int kChunks = E / VEC;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const RowPtrs p = row_offsets(row, hr, rep, c);

  float v[E];
#pragma unroll
  for (int ch = 0; ch < kChunks; ++ch) {
    const int base = (ch * 32 + lane) * VEC;
    if (base < c) {  // VEC divides C, so the whole vector lies in the row
      const Vec<T, VEC> xv = *reinterpret_cast<const Vec<T, VEC>*>(x + p.x + base);
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[ch * VEC + i] = to_f(xv.v[i]) * scale;
      if (bias != nullptr) {
        const Vec<T, VEC> bv = *reinterpret_cast<const Vec<T, VEC>*>(bias + p.bias + base);
#pragma unroll
        for (int i = 0; i < VEC; ++i) v[ch * VEC + i] += to_f(bv.v[i]);
      }
      if (mask != nullptr) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) v[ch * VEC + i] += mask[p.mask + base + i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[ch * VEC + i] = -INFINITY;
    }
  }

  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < E; ++i) m = fmaxf(m, v[i]);
  m = warp_max(m);
  if (!isfinite(m)) m = 0.f;
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < E; ++i) {
    v[i] = expf(v[i] - m);
    s += v[i];
  }
  s = warp_sum(s);

#pragma unroll
  for (int ch = 0; ch < kChunks; ++ch) {
    const int base = (ch * 32 + lane) * VEC;
    if (base < c) {
      Vec<T, VEC> ov;
#pragma unroll
      for (int i = 0; i < VEC; ++i) ov.v[i] = from_f<T>(v[ch * VEC + i] / s);
      *reinterpret_cast<Vec<T, VEC>*>(out + p.x + base) = ov;
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
  const RowPtrs p = row_offsets(row, hr, rep, c);

  float v[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int idx = i * kRowBlock + tid;
    if (idx < c) {
      float a = to_f(x[p.x + idx]) * scale;
      if (bias != nullptr) a += to_f(bias[p.bias + idx]);
      if (mask != nullptr) a += mask[p.mask + idx];
      v[i] = a;
    } else {
      v[i] = -INFINITY;
    }
  }

  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) m = fmaxf(m, v[i]);
  m = warp_max(m);
  if (lane == 0) red[warp] = m;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kRowBlock / 32 ? red[lane] : -INFINITY;
    t = warp_max(t);
    if (lane == 0) bcast = isfinite(t) ? t : 0.f;
  }
  __syncthreads();
  m = bcast;

  float s = 0.f;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    v[i] = expf(v[i] - m);
    s += v[i];
  }
  s = warp_sum(s);
  __syncthreads();  // every thread has read bcast before it is rewritten
  if (lane == 0) red[warp] = s;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kRowBlock / 32 ? red[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) bcast = t;
  }
  __syncthreads();
  s = bcast;

#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int idx = i * kRowBlock + tid;
    if (idx < c) out[p.x + idx] = from_f<T>(v[i] / s);
  }
}

template <typename T, int VEC, int E>
void launch_warp(const void* x, const void* bias, const float* mask, void* out,
                 long long rows, long long hr, int rep, int c, float scale,
                 cudaStream_t st) {
  const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  softmax_warp_kernel<T, VEC, E><<<(unsigned)blocks, 32 * kWarpsPerBlock, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(bias), mask, static_cast<T*>(out),
      rows, hr, rep, c, scale);
}

// VEC: the widest of 16 bytes, 8, 4, 2, 1 elements that divides C and fits
// in E (only when every pointer is 16-byte aligned); E: values a lane.
template <typename T, int E>
void dispatch_vec(int vec, const void* x, const void* bias, const float* mask, void* out,
                  long long rows, long long hr, int rep, int c, float scale,
                  cudaStream_t st) {
  constexpr int kMaxVec = 16 / sizeof(T);
  if (vec >= 8 && kMaxVec >= 8 && E >= 8) {
    launch_warp<T, (kMaxVec >= 8 ? 8 : 1), (E >= 8 ? E : 8)>(x, bias, mask, out, rows, hr,
                                                             rep, c, scale, st);
  } else if (vec >= 4 && E >= 4) {
    launch_warp<T, 4, (E >= 4 ? E : 4)>(x, bias, mask, out, rows, hr, rep, c, scale, st);
  } else if (vec >= 2 && E >= 2) {
    launch_warp<T, 2, (E >= 2 ? E : 2)>(x, bias, mask, out, rows, hr, rep, c, scale, st);
  } else {
    launch_warp<T, 1, E>(x, bias, mask, out, rows, hr, rep, c, scale, st);
  }
}

template <typename T>
int launch(const void* x, const void* bias, const float* mask, void* out, long long rows,
           long long hr, int rep, int c, float scale, int aligned, cudaStream_t st) {
  if (c <= kMaxWarpC) {
    if ((rows + kWarpsPerBlock - 1) / kWarpsPerBlock > 0x7fffffffLL) {
      return (int)cudaErrorInvalidConfiguration;
    }
    int vec = 1;
    if (aligned) {
      for (int cand = 16 / (int)sizeof(T); cand > 1; cand >>= 1) {
        if (c % cand == 0) { vec = cand; break; }
      }
    }
    const int per_lane = (c + 31) / 32;
    if (per_lane <= 1) {
      dispatch_vec<T, 1>(vec, x, bias, mask, out, rows, hr, rep, c, scale, st);
    } else if (per_lane <= 2) {
      dispatch_vec<T, 2>(vec, x, bias, mask, out, rows, hr, rep, c, scale, st);
    } else if (per_lane <= 4) {
      dispatch_vec<T, 4>(vec, x, bias, mask, out, rows, hr, rep, c, scale, st);
    } else if (per_lane <= 8) {
      dispatch_vec<T, 8>(vec, x, bias, mask, out, rows, hr, rep, c, scale, st);
    } else if (per_lane <= 16) {
      dispatch_vec<T, 16>(vec, x, bias, mask, out, rows, hr, rep, c, scale, st);
    } else {
      dispatch_vec<T, 32>(vec, x, bias, mask, out, rows, hr, rep, c, scale, st);
    }
    return (int)cudaGetLastError();
  }
  if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const int items = (c + kRowBlock - 1) / kRowBlock;
  const dim3 grid((unsigned)rows), block(kRowBlock);
  const T* xp = static_cast<const T*>(x);
  const T* bp = static_cast<const T*>(bias);
  T* op = static_cast<T*>(out);
  if (items <= 4) {
    softmax_block_kernel<T, 4><<<grid, block, 0, st>>>(xp, bp, mask, op, hr, rep, c, scale);
  } else if (items <= 8) {
    softmax_block_kernel<T, 8><<<grid, block, 0, st>>>(xp, bp, mask, op, hr, rep, c, scale);
  } else if (items <= 16) {
    softmax_block_kernel<T, 16><<<grid, block, 0, st>>>(xp, bp, mask, op, hr, rep, c, scale);
  } else {
    softmax_block_kernel<T, 32><<<grid, block, 0, st>>>(xp, bp, mask, op, hr, rep, c, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: (N, H, R, C) contiguous; bias: (B, H, R, C) contiguous in x's
// dtype, or null; mask: (N, C) contiguous fp32, or null. rows = N*H*R,
// hr = H*R, rep = N/B (1 without a bias). aligned: every pointer is 16-byte
// aligned. dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the
// launch.
extern "C" int fused_softmax_fwd(const void* x, const void* bias, const void* mask, void* out,
                                 long long rows, long long hr, int rep, int c, float scale,
                                 int dtype, int aligned, void* stream) {
  if (rows <= 0) return 0;
  if (c <= 0 || c > kMaxC || hr <= 0 || rep <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  if (dtype == 0) return launch<float>(x, bias, m, out, rows, hr, rep, c, scale, aligned, st);
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x, bias, m, out, rows, hr, rep, c, scale, aligned, st);
  }
  return (int)cudaErrorInvalidValue;
}
