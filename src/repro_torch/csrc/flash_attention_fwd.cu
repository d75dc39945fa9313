// Flash-attention forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py, body `_flash_kernel`):
// out = softmax(scale * q k^T + bias + mask) v with an online softmax over KV
// tiles, returning out and the fp32 log-sum-exp. The (N, H, Sq, Skv) scores
// tensor never reaches device memory.
//
// Bound on the H100: at the Evoformer's shapes (S = 128..384, D = 32) the
// work is about S * D * 4 operations for each of the N*H*S query rows against
// 2*D*S bytes of K/V shared by a whole q tile, so with tensor cores the
// kernel would be memory-bound; done with scalar fp32 FMAs, as here, it is
// bound by the FMA issue rate and shared-memory reads. That is the simple,
// right first version; tensor cores (mma.sync / wgmma) are later work.
//
// Design, not a copy of the TPU's grid:
//  * one block per (q tile of 128 rows, head, group n); one thread per query
//    row, which keeps its q row and fp32 accumulator in registers;
//  * a loop inside the block over KV tiles of 32 keys: K, V, the bias tile and
//    the mask tile are staged in shared memory as fp32, then each thread
//    scores its row against the tile, updates its running max and sum, and
//    accumulates p * V; out and lse are written once at the end;
//  * q/k/v are read in the JAX layout (N, S, H, D) through their N and S
//    strides, so the QKV projection's column slices are read in place: no
//    transpose to (N, H, S, D) and no padding of D to 128 lanes;
//  * the bias (B, H, Sq, Skv) is shared by rep = N/B consecutive groups; the
//    mask (N, Skv) is additive and finite;
//  * columns past Skv in the ragged last tile score -1e30: they never win the
//    max and add exp(-huge) = 0 to the sum;
//  * a row whose keys are all masked by -1e9 computes what the plain version
//    computes: in fp32 s - 1e9 rounds to -1e9, so its weights are uniform;
//  * in bf16, p is rounded to bf16 before the PV product (the reference's
//    rounding point) and the product accumulates in fp32.
// The kernel launches on the caller's stream, allocates nothing and does not
// synchronise.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kBQ = 128;  // query rows per block = threads per block
constexpr int kBK = 32;   // keys per staged KV tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// Round p to the value dtype, as the plain version does before its PV product.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

template <typename T, int D>
__global__ void __launch_bounds__(kBQ)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ bias, const float* __restrict__ mask,
                 T* __restrict__ out, float* __restrict__ lse,
                 long long q_sn, long long q_ss, long long k_sn, long long k_ss,
                 long long v_sn, long long v_ss, int sq, int skv, int nh, int rep,
                 float scale) {
  __shared__ __align__(16) float ks[kBK][D];
  __shared__ __align__(16) float vs[kBK][D];
  __shared__ float bs[kBQ][kBK + 1];  // +1: rows land in distinct banks
  __shared__ float ms[kBK];

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const long long n = blockIdx.z;
  const int row = q0 + tid;
  const bool active = row < sq;
  const bool has_bias = bias != nullptr;
  const bool has_mask = mask != nullptr;
  const T* bias_nh = has_bias ? bias + ((n / rep) * nh + h) * (long long)sq * skv : nullptr;

  float qr[D];
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = active ? to_f(q[n * q_sn + row * q_ss + (long long)h * D + d]) : 0.f;
    acc[d] = 0.f;
  }
  float m = kNegInf;
  float l = 0.f;

  for (int j0 = 0; j0 < skv; j0 += kBK) {
    __syncthreads();  // the previous tile is no longer read
    for (int idx = tid; idx < kBK * D; idx += kBQ) {
      const int j = idx / D, d = idx % D;
      const int kv = j0 + j;
      const bool ok = kv < skv;
      ks[j][d] = ok ? to_f(k[n * k_sn + kv * k_ss + (long long)h * D + d]) : 0.f;
      vs[j][d] = ok ? to_f(v[n * v_sn + kv * v_ss + (long long)h * D + d]) : 0.f;
    }
    if (has_bias) {
      for (int idx = tid; idx < kBQ * kBK; idx += kBQ) {
        const int r = idx / kBK, c = idx % kBK;
        const int qrow = q0 + r, kv = j0 + c;
        bs[r][c] = (qrow < sq && kv < skv) ? to_f(bias_nh[(long long)qrow * skv + kv]) : 0.f;
      }
    }
    if (has_mask && tid < kBK) {
      const int kv = j0 + tid;
      ms[tid] = kv < skv ? mask[n * skv + kv] : 0.f;
    }
    __syncthreads();
    if (!active) continue;

    float s[kBK];
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(&ks[j][d]);
        dot = fmaf(qr[d], kk.x, dot);
        dot = fmaf(qr[d + 1], kk.y, dot);
        dot = fmaf(qr[d + 2], kk.z, dot);
        dot = fmaf(qr[d + 3], kk.w, dot);
      }
      float sj = dot * scale;
      if (has_bias) sj += bs[tid][j];
      if (has_mask) sj += ms[j];
      if (j0 + j >= skv) sj = kNegInf;
      s[j] = sj;
      tile_max = fmaxf(tile_max, sj);
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float p = expf(s[j] - m_new);
      l += p;
      const float pr = round_to<T>(p);
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(&vs[j][d]);
        acc[d] = fmaf(pr, vv.x, acc[d]);
        acc[d + 1] = fmaf(pr, vv.y, acc[d + 1]);
        acc[d + 2] = fmaf(pr, vv.z, acc[d + 2]);
        acc[d + 3] = fmaf(pr, vv.w, acc[d + 3]);
      }
    }
    m = m_new;
  }

  if (active) {
    const float lc = fmaxf(l, 1e-30f);
    const float inv = 1.f / lc;
    T* orow = out + ((n * sq + row) * nh + h) * (long long)D;
#pragma unroll
    for (int d = 0; d < D; ++d) orow[d] = from_f<T>(acc[d] * inv);
    lse[(n * nh + h) * sq + row] = m + logf(lc);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* bias, const void* mask,
           void* out, void* lse, long long q_sn, long long q_ss, long long k_sn,
           long long k_ss, long long v_sn, long long v_ss, int n, int sq, int skv, int nh,
           int d, int rep, float scale, cudaStream_t st) {
  const dim3 grid((sq + kBQ - 1) / kBQ, nh, n);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* bp = static_cast<const T*>(bias);
  const float* mp = static_cast<const float*>(mask);
  T* op = static_cast<T*>(out);
  float* lp = static_cast<float*>(lse);
#define FLASH_CASE(DD)                                                                  \
  case DD:                                                                              \
    flash_fwd_kernel<T, DD><<<grid, kBQ, 0, st>>>(qp, kp, vp, bp, mp, op, lp, q_sn, q_ss, \
                                                  k_sn, k_ss, v_sn, v_ss, sq, skv, nh, rep, \
                                                  scale);                                \
    break;
  switch (d) {
    FLASH_CASE(16)  // MINI
    FLASH_CASE(32)  // FULL
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FLASH_CASE
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: (N, S, H, D) with unit D stride and H stride D; the N and S strides
// are given in elements. bias: (N/rep, H, Sq, Skv) contiguous, or NULL. mask:
// (N, Skv) fp32 contiguous, or NULL. out: (N, Sq, H, D) contiguous; lse:
// (N, H, Sq) fp32. dtype: 0 = float32, 1 = bfloat16 (q, k, v, bias, out).
// Returns the cudaError_t of the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* bias, const void* mask, void* out, void* lse,
                                   long long q_sn, long long q_ss, long long k_sn,
                                   long long k_ss, long long v_sn, long long v_ss, int n,
                                   int sq, int skv, int nh, int d, int rep, float scale,
                                   int dtype, void* stream) {
  if (n <= 0 || sq <= 0) return 0;
  if (skv <= 0 || nh > 65535 || n > 65535 || rep <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, bias, mask, out, lse, q_sn, q_ss, k_sn, k_ss, v_sn, v_ss, n,
                         sq, skv, nh, d, rep, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, bias, mask, out, lse, q_sn, q_ss, k_sn, k_ss, v_sn,
                                 v_ss, n, sq, skv, nh, d, rep, scale, st);
  return (int)cudaErrorInvalidValue;
}
