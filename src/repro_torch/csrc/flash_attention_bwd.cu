// Flash-attention backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_attention_bwd_pallas`
// (src/repro/kernels/flash_attention.py, bodies `_bwd_dq_kernel`,
// `_bwd_dkv_kernel` and `_bwd_dbias_kernel`): the gradients of
// out = softmax(scale * q k^T + bias + mask) v from the saved (q, k, v, out,
// lse) and the cotangent do, without the (N, H, Sq, Skv) scores or probs in
// device memory. Every sweep rebuilds the same tile in fp32:
//   s = scale * q.k + bias + mask,  p = exp(s - lse),  dp = do.v,
//   ds = p * (dp - delta),  delta = rowsum(do * out),
// and accumulates
//   dq = scale * ds k,  dk = scale * ds^T q,  dv = p^T do,
//   dbias[b] = sum over the rep = N/B groups n that share bias b of ds,
//   dmask[n, j] = sum over heads and query rows of ds.
//
// Bound on the H100: at the Evoformer's shapes (S = 128..384, D = 32) the
// three sweeps do about nine S*S*D products per (n, h), a few hundred
// operations for each byte of q/k/v/do read, so on tensor cores the kernel
// would be bound by its bytes; done with scalar fp32 FMAs, as here, it is
// bound by the FMA issue rate. That is the simple, right first version, as
// the forward (flash_attention_fwd.cu) is; mma.sync / wgmma tiles are later
// work.
//
// Design, not a copy of the TPU's grid (which runs in order on one core and
// carries its accumulators in VMEM from one grid step to the next):
//  * delta pre-pass: one thread per (n, q row, head) sums do * out in fp32;
//  * dq sweep: one block per (q tile of 128 rows, head, n), one thread per
//    query row holding its q, do and fp32 dq in registers; a loop inside the
//    block over KV tiles of 32 keys staged in shared memory as fp32 (K, V,
//    the bias tile, the mask). When rep == 1 each ds tile is the bias
//    gradient itself and is written here (the reference fuses it the same way);
//  * dk/dv sweep: one block per (KV tile of 128 keys, head, n), one thread
//    per key holding its k, v and fp32 dk, dv in registers; a loop over q
//    tiles of 32 rows staged in shared memory (q, do, lse, delta, the bias
//    tile). The column sums of ds go to a per-head scratch when the mask's
//    gradient is asked for, and a last small pass sums them over heads;
//  * dbias sweep (rep > 1): one block per (32 x 32 tile of (q, kv), head,
//    bias batch b), 4 warps; lane = query row, warp = 8 key columns, so the
//    K/V rows a warp reads are broadcasts. The block loops over the rep
//    groups in order, and each thread sums its 8 entries of ds in registers:
//    a fixed reduction order, no atomics, deterministic;
//  * q/k/v/do/out are read in the JAX layout (N, S, H, D) through their N and
//    S strides, so the QKV projection's column slices are read in place;
//  * query rows past Sq and key columns past Skv in the ragged last tiles are
//    skipped: they contribute nothing;
//  * a row whose keys are all masked by -1e9 computes what the plain version
//    computes: in fp32 every s and lse round to -1e9, so p = exp(0) for every
//    key, exactly as in the reference's backward;
//  * outputs: dq, dk, dv in q's dtype; dbias in q's dtype (the bias's); dmask
//    in fp32. Every sum is fp32.
// The kernel launches on the caller's stream, allocates nothing (the wrapper
// passes the delta and per-head dmask scratch) and does not synchronise.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kBQ = 128;   // dq sweep: query rows per block = threads
constexpr int kBK = 32;    // dq sweep: keys per staged tile
constexpr int kBKV = 128;  // dk/dv sweep: keys per block = threads
constexpr int kTQ = 32;    // dk/dv sweep: query rows per staged tile
constexpr int kDB = 32;    // dbias sweep: a kDB x kDB tile of (q, kv)
constexpr int kDBCols = 8; // dbias sweep: key columns per thread
constexpr int kDBThreads = kDB * kDB / kDBCols;  // 128: lane = row, warp = 8 columns

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Element strides of the N and S axes of q, k, v, out and do (each has a
// dense (H, D) block).
struct Strides {
  long long q_n, q_s, k_n, k_s, v_n, v_s, o_n, o_s, g_n, g_s;
};

// delta[n, h, i] = sum_d do[n, i, h, d] * out[n, i, h, d], in fp32.
template <typename T, int D>
__global__ void delta_kernel(const T* __restrict__ dout, const T* __restrict__ out,
                             float* __restrict__ delta, Strides st, long long rows, int sq,
                             int nh) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows) return;
  const int h = (int)(idx % nh);
  const long long t = idx / nh;
  const int i = (int)(t % sq);
  const long long n = t / sq;
  const T* g = dout + n * st.g_n + i * st.g_s + (long long)h * D;
  const T* o = out + n * st.o_n + i * st.o_s + (long long)h * D;
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) acc = fmaf(to_f(g[d]), to_f(o[d]), acc);
  delta[(n * nh + h) * sq + i] = acc;
}

template <typename T, int D>
__global__ void __launch_bounds__(kBQ)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, const T* __restrict__ bias,
          const float* __restrict__ mask, T* __restrict__ dq, T* __restrict__ dbias_fused,
          Strides st, int sq, int skv, int nh, int rep, float scale) {
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
  T* db_row = (dbias_fused != nullptr && active)
                  ? dbias_fused + ((n * nh + h) * (long long)sq + row) * skv
                  : nullptr;

  float qr[D], gr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = active ? to_f(q[n * st.q_n + row * st.q_s + (long long)h * D + d]) : 0.f;
    gr[d] = active ? to_f(dout[n * st.g_n + row * st.g_s + (long long)h * D + d]) : 0.f;
    acc[d] = 0.f;
  }
  const long long stat = (n * nh + h) * sq + row;
  const float lse_r = active ? lse[stat] : 0.f;
  const float delta_r = active ? delta[stat] : 0.f;

  for (int j0 = 0; j0 < skv; j0 += kBK) {
    __syncthreads();  // the previous tile is no longer read
    for (int idx = tid; idx < kBK * D; idx += kBQ) {
      const int j = idx / D, d = idx % D;
      const int kv = j0 + j;
      const bool ok = kv < skv;
      ks[j][d] = ok ? to_f(k[n * st.k_n + kv * st.k_s + (long long)h * D + d]) : 0.f;
      vs[j][d] = ok ? to_f(v[n * st.v_n + kv * st.v_s + (long long)h * D + d]) : 0.f;
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

    const int jn = min(kBK, skv - j0);  // keys past Skv contribute nothing
#pragma unroll 2
    for (int j = 0; j < jn; ++j) {
      float dot = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(&ks[j][d]);
        const float4 vv = *reinterpret_cast<const float4*>(&vs[j][d]);
        dot = fmaf(qr[d], kk.x, dot);
        dot = fmaf(qr[d + 1], kk.y, dot);
        dot = fmaf(qr[d + 2], kk.z, dot);
        dot = fmaf(qr[d + 3], kk.w, dot);
        dp = fmaf(gr[d], vv.x, dp);
        dp = fmaf(gr[d + 1], vv.y, dp);
        dp = fmaf(gr[d + 2], vv.z, dp);
        dp = fmaf(gr[d + 3], vv.w, dp);
      }
      float s = dot * scale;
      if (has_bias) s += bs[tid][j];
      if (has_mask) s += ms[j];
      const float p = expf(s - lse_r);
      const float ds = p * (dp - delta_r);
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(&ks[j][d]);
        acc[d] = fmaf(ds, kk.x, acc[d]);
        acc[d + 1] = fmaf(ds, kk.y, acc[d + 1]);
        acc[d + 2] = fmaf(ds, kk.z, acc[d + 2]);
        acc[d + 3] = fmaf(ds, kk.w, acc[d + 3]);
      }
      if (db_row != nullptr) db_row[j0 + j] = from_f<T>(ds);
    }
  }

  if (active) {
    T* drow = dq + ((n * sq + row) * nh + h) * (long long)D;
#pragma unroll
    for (int d = 0; d < D; ++d) drow[d] = from_f<T>(acc[d] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kBKV)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ delta, const T* __restrict__ bias,
           const float* __restrict__ mask, T* __restrict__ dk, T* __restrict__ dv,
           float* __restrict__ dmask_h, Strides st, int sq, int skv, int nh, int rep,
           float scale) {
  __shared__ __align__(16) float qs[kTQ][D];
  __shared__ __align__(16) float gs[kTQ][D];
  __shared__ float ls[kTQ];
  __shared__ float dls[kTQ];
  __shared__ float bs[kTQ][kBKV];  // row i, this thread's column: conflict-free

  const int tid = threadIdx.x;
  const int kv0 = blockIdx.x * kBKV;
  const int h = blockIdx.y;
  const long long n = blockIdx.z;
  const int col = kv0 + tid;
  const bool active = col < skv;
  const bool has_bias = bias != nullptr;
  const bool has_mask = mask != nullptr;
  const T* bias_nh = has_bias ? bias + ((n / rep) * nh + h) * (long long)sq * skv : nullptr;

  float kr[D], vr[D], dkr[D], dvr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    kr[d] = active ? to_f(k[n * st.k_n + col * st.k_s + (long long)h * D + d]) : 0.f;
    vr[d] = active ? to_f(v[n * st.v_n + col * st.v_s + (long long)h * D + d]) : 0.f;
    dkr[d] = 0.f;
    dvr[d] = 0.f;
  }
  const float mask_c = (has_mask && active) ? mask[n * skv + col] : 0.f;
  float dm = 0.f;
  const long long stat0 = (n * nh + h) * (long long)sq;

  for (int i0 = 0; i0 < sq; i0 += kTQ) {
    __syncthreads();
    for (int idx = tid; idx < kTQ * D; idx += kBKV) {
      const int i = idx / D, d = idx % D;
      const int qrow = i0 + i;
      const bool ok = qrow < sq;
      qs[i][d] = ok ? to_f(q[n * st.q_n + qrow * st.q_s + (long long)h * D + d]) : 0.f;
      gs[i][d] = ok ? to_f(dout[n * st.g_n + qrow * st.g_s + (long long)h * D + d]) : 0.f;
    }
    if (tid < kTQ) {
      const int qrow = i0 + tid;
      const bool ok = qrow < sq;
      ls[tid] = ok ? lse[stat0 + qrow] : 0.f;
      dls[tid] = ok ? delta[stat0 + qrow] : 0.f;
    }
    if (has_bias) {
#pragma unroll 4
      for (int i = 0; i < kTQ; ++i) {
        const int qrow = i0 + i;
        bs[i][tid] = (qrow < sq && active) ? to_f(bias_nh[(long long)qrow * skv + col]) : 0.f;
      }
    }
    __syncthreads();
    if (!active) continue;

    const int in = min(kTQ, sq - i0);  // rows past Sq contribute nothing
#pragma unroll 2
    for (int i = 0; i < in; ++i) {
      float dot = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 qq = *reinterpret_cast<const float4*>(&qs[i][d]);
        const float4 gg = *reinterpret_cast<const float4*>(&gs[i][d]);
        dot = fmaf(qq.x, kr[d], dot);
        dot = fmaf(qq.y, kr[d + 1], dot);
        dot = fmaf(qq.z, kr[d + 2], dot);
        dot = fmaf(qq.w, kr[d + 3], dot);
        dp = fmaf(gg.x, vr[d], dp);
        dp = fmaf(gg.y, vr[d + 1], dp);
        dp = fmaf(gg.z, vr[d + 2], dp);
        dp = fmaf(gg.w, vr[d + 3], dp);
      }
      float s = dot * scale;
      if (has_bias) s += bs[i][tid];
      if (has_mask) s += mask_c;
      const float p = expf(s - ls[i]);
      const float ds = p * (dp - dls[i]);
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 qq = *reinterpret_cast<const float4*>(&qs[i][d]);
        const float4 gg = *reinterpret_cast<const float4*>(&gs[i][d]);
        dvr[d] = fmaf(p, gg.x, dvr[d]);
        dvr[d + 1] = fmaf(p, gg.y, dvr[d + 1]);
        dvr[d + 2] = fmaf(p, gg.z, dvr[d + 2]);
        dvr[d + 3] = fmaf(p, gg.w, dvr[d + 3]);
        dkr[d] = fmaf(ds, qq.x, dkr[d]);
        dkr[d + 1] = fmaf(ds, qq.y, dkr[d + 1]);
        dkr[d + 2] = fmaf(ds, qq.z, dkr[d + 2]);
        dkr[d + 3] = fmaf(ds, qq.w, dkr[d + 3]);
      }
      dm += ds;
    }
  }

  if (active) {
    const long long o = ((n * skv + col) * nh + h) * (long long)D;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      dk[o + d] = from_f<T>(dkr[d] * scale);
      dv[o + d] = from_f<T>(dvr[d]);
    }
    if (dmask_h != nullptr) dmask_h[(n * nh + h) * skv + col] = dm;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kDBThreads)
dbias_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const T* __restrict__ dout, const float* __restrict__ lse,
             const float* __restrict__ delta, const T* __restrict__ bias,
             const float* __restrict__ mask, T* __restrict__ dbias, Strides st, int sq,
             int skv, int nh, int rep, int n_kv_tiles, float scale) {
  __shared__ float qs[kDB][D + 1];  // +1: a warp reads 32 rows at one d
  __shared__ float gs[kDB][D + 1];
  __shared__ __align__(16) float ks[kDB][D];  // a warp reads one row: broadcast
  __shared__ __align__(16) float vs[kDB][D];
  __shared__ float ls[kDB];
  __shared__ float dls[kDB];
  __shared__ float ms[kDB];

  const int tid = threadIdx.x;
  const int lane = tid & 31;          // query row in the tile
  const int c0 = (tid >> 5) * kDBCols;  // first of this warp's key columns
  const int q0 = (blockIdx.x / n_kv_tiles) * kDB;
  const int kv0 = (blockIdx.x % n_kv_tiles) * kDB;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int row = q0 + lane;
  const bool active = row < sq;
  const bool has_mask = mask != nullptr;
  const long long bias_off = ((b * nh + h) * (long long)sq + row) * skv;

  float br[kDBCols], acc[kDBCols];
#pragma unroll
  for (int c = 0; c < kDBCols; ++c) {
    const int col = kv0 + c0 + c;
    br[c] = (active && col < skv) ? to_f(bias[bias_off + col]) : 0.f;
    acc[c] = 0.f;
  }

  for (int r = 0; r < rep; ++r) {
    const long long n = b * rep + r;
    __syncthreads();
    for (int idx = tid; idx < kDB * D; idx += kDBThreads) {
      const int i = idx / D, d = idx % D;
      const int qrow = q0 + i, kvr = kv0 + i;
      const bool qok = qrow < sq, kok = kvr < skv;
      qs[i][d] = qok ? to_f(q[n * st.q_n + qrow * st.q_s + (long long)h * D + d]) : 0.f;
      gs[i][d] = qok ? to_f(dout[n * st.g_n + qrow * st.g_s + (long long)h * D + d]) : 0.f;
      ks[i][d] = kok ? to_f(k[n * st.k_n + kvr * st.k_s + (long long)h * D + d]) : 0.f;
      vs[i][d] = kok ? to_f(v[n * st.v_n + kvr * st.v_s + (long long)h * D + d]) : 0.f;
    }
    if (tid < kDB) {
      const int qrow = q0 + tid, kvr = kv0 + tid;
      const long long stat = (n * nh + h) * sq + qrow;
      ls[tid] = qrow < sq ? lse[stat] : 0.f;
      dls[tid] = qrow < sq ? delta[stat] : 0.f;
      ms[tid] = (has_mask && kvr < skv) ? mask[n * skv + kvr] : 0.f;
    }
    __syncthreads();
    if (!active) continue;

    float dot[kDBCols], dp[kDBCols];
#pragma unroll
    for (int c = 0; c < kDBCols; ++c) {
      dot[c] = 0.f;
      dp[c] = 0.f;
    }
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      const float q_0 = qs[lane][d], q_1 = qs[lane][d + 1];
      const float q_2 = qs[lane][d + 2], q_3 = qs[lane][d + 3];
      const float g_0 = gs[lane][d], g_1 = gs[lane][d + 1];
      const float g_2 = gs[lane][d + 2], g_3 = gs[lane][d + 3];
#pragma unroll
      for (int c = 0; c < kDBCols; ++c) {
        const float4 kk = *reinterpret_cast<const float4*>(&ks[c0 + c][d]);
        const float4 vv = *reinterpret_cast<const float4*>(&vs[c0 + c][d]);
        dot[c] = fmaf(q_0, kk.x, dot[c]);
        dot[c] = fmaf(q_1, kk.y, dot[c]);
        dot[c] = fmaf(q_2, kk.z, dot[c]);
        dot[c] = fmaf(q_3, kk.w, dot[c]);
        dp[c] = fmaf(g_0, vv.x, dp[c]);
        dp[c] = fmaf(g_1, vv.y, dp[c]);
        dp[c] = fmaf(g_2, vv.z, dp[c]);
        dp[c] = fmaf(g_3, vv.w, dp[c]);
      }
    }
    const float lse_r = ls[lane], delta_r = dls[lane];
#pragma unroll
    for (int c = 0; c < kDBCols; ++c) {
      float s = dot[c] * scale + br[c];
      if (has_mask) s += ms[c0 + c];
      const float p = expf(s - lse_r);
      acc[c] += p * (dp[c] - delta_r);
    }
  }

  if (active) {
#pragma unroll
    for (int c = 0; c < kDBCols; ++c) {
      const int col = kv0 + c0 + c;
      if (col < skv) dbias[bias_off + col] = from_f<T>(acc[c]);
    }
  }
}

// dmask[n, j] = sum_h dmask_h[n, h, j], in a fixed order.
__global__ void dmask_reduce_kernel(const float* __restrict__ dmask_h, float* __restrict__ dmask,
                                    long long cols, int nh, int skv) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= cols) return;
  const long long n = idx / skv;
  const int j = (int)(idx % skv);
  float acc = 0.f;
  for (int h = 0; h < nh; ++h) acc += dmask_h[(n * nh + h) * skv + j];
  dmask[idx] = acc;
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           const void* lse, const void* bias, const void* mask, void* dq, void* dk, void* dv,
           void* dbias, void* dmask, void* delta, void* dmask_h, Strides st, int n, int sq,
           int skv, int nh, int rep, float scale, cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* op = static_cast<const T*>(out);
  const T* gp = static_cast<const T*>(dout);
  const T* bp = static_cast<const T*>(bias);
  const float* lp = static_cast<const float*>(lse);
  const float* mp = static_cast<const float*>(mask);
  float* dl = static_cast<float*>(delta);
  float* dmh = static_cast<float*>(dmask_h);
  int err;

  const long long rows = (long long)n * sq * nh;
  delta_kernel<T, D><<<(unsigned)((rows + 255) / 256), 256, 0, stream>>>(gp, op, dl, st, rows,
                                                                         sq, nh);
  if ((err = (int)cudaGetLastError()) != 0) return err;

  // When each group has its own bias (rep == 1), the dq sweep's ds tiles are
  // the bias gradient.
  T* fused = (bias != nullptr && rep == 1) ? static_cast<T*>(dbias) : nullptr;
  dq_kernel<T, D><<<dim3((sq + kBQ - 1) / kBQ, nh, n), kBQ, 0, stream>>>(
      qp, kp, vp, gp, lp, dl, bp, mp, static_cast<T*>(dq), fused, st, sq, skv, nh, rep, scale);
  if ((err = (int)cudaGetLastError()) != 0) return err;

  dkv_kernel<T, D><<<dim3((skv + kBKV - 1) / kBKV, nh, n), kBKV, 0, stream>>>(
      qp, kp, vp, gp, lp, dl, bp, mp, static_cast<T*>(dk), static_cast<T*>(dv),
      dmask != nullptr ? dmh : nullptr, st, sq, skv, nh, rep, scale);
  if ((err = (int)cudaGetLastError()) != 0) return err;

  if (bias != nullptr && rep > 1) {
    const int nqt = (sq + kDB - 1) / kDB, nkt = (skv + kDB - 1) / kDB;
    dbias_kernel<T, D><<<dim3(nqt * nkt, nh, n / rep), kDBThreads, 0, stream>>>(
        qp, kp, vp, gp, lp, dl, bp, mp, static_cast<T*>(dbias), st, sq, skv, nh, rep, nkt,
        scale);
    if ((err = (int)cudaGetLastError()) != 0) return err;
  }
  if (dmask != nullptr) {
    const long long cols = (long long)n * skv;
    dmask_reduce_kernel<<<(unsigned)((cols + 255) / 256), 256, 0, stream>>>(
        dmh, static_cast<float*>(dmask), cols, nh, skv);
    if ((err = (int)cudaGetLastError()) != 0) return err;
  }
  return 0;
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v, const void* out,
             const void* dout, const void* lse, const void* bias, const void* mask, void* dq,
             void* dk, void* dv, void* dbias, void* dmask, void* delta, void* dmask_h,
             Strides st, int n, int sq, int skv, int nh, int rep, float scale,
             cudaStream_t stream) {
  switch (d) {
    case 16:  // MINI
      return launch<T, 16>(q, k, v, out, dout, lse, bias, mask, dq, dk, dv, dbias, dmask,
                           delta, dmask_h, st, n, sq, skv, nh, rep, scale, stream);
    case 32:  // FULL
      return launch<T, 32>(q, k, v, out, dout, lse, bias, mask, dq, dk, dv, dbias, dmask,
                           delta, dmask_h, st, n, sq, skv, nh, rep, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (N, Sq, H, D); k, v: (N, Skv, H, D); out, dout: (N, Sq, H, D); each with
// unit D stride and H stride D, the N and S strides given in elements. lse:
// (N, H, Sq) fp32 contiguous. bias: (N/rep, H, Sq, Skv) contiguous, or NULL;
// mask: (N, Skv) fp32 contiguous, or NULL. Outputs, contiguous: dq (N, Sq, H,
// D), dk, dv (N, Skv, H, D); dbias (N/rep, H, Sq, Skv) when bias is given;
// dmask (N, Skv) fp32, or NULL when its gradient is not wanted. Scratch:
// delta (N, H, Sq) fp32; dmask_h (N, H, Skv) fp32 when dmask is given.
// dtype: 0 = float32, 1 = bfloat16 (q, k, v, out, dout, bias, dq, dk, dv,
// dbias). Returns the first failing launch's cudaError_t, else 0.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* out, const void* dout, const void* lse,
                                   const void* bias, const void* mask, void* dq, void* dk,
                                   void* dv, void* dbias, void* dmask, void* delta,
                                   void* dmask_h, long long q_sn, long long q_ss,
                                   long long k_sn, long long k_ss, long long v_sn,
                                   long long v_ss, long long o_sn, long long o_ss,
                                   long long g_sn, long long g_ss, int n, int sq, int skv,
                                   int nh, int d, int rep, float scale, int dtype,
                                   void* stream) {
  if (n <= 0 || sq <= 0 || skv <= 0 || nh <= 0 || nh > 65535 || n > 65535 || rep <= 0 ||
      n % rep != 0)
    return (int)cudaErrorInvalidValue;
  if ((bias != nullptr) != (dbias != nullptr)) return (int)cudaErrorInvalidValue;
  if (dmask != nullptr && (mask == nullptr || dmask_h == nullptr))
    return (int)cudaErrorInvalidValue;
  const Strides st{q_sn, q_ss, k_sn, k_ss, v_sn, v_ss, o_sn, o_ss, g_sn, g_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(d, q, k, v, out, dout, lse, bias, mask, dq, dk, dv, dbias, dmask,
                           delta, dmask_h, st, n, sq, skv, nh, rep, scale, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(d, q, k, v, out, dout, lse, bias, mask, dq, dk, dv, dbias,
                                   dmask, delta, dmask_h, st, n, sq, skv, nh, rep, scale, s);
  return (int)cudaErrorInvalidValue;
}
