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
// Bound on the H100, bf16, at the Evoformer's shapes (S = 128..384, D = 32):
// the gradient needs five S x S x D products per (n, h) (s, dp, dv, dq, dk),
// 21 GFLOP for an MSA-row call at r = 256 (0.022 ms at 989 TFLOP/s), and
// moves about 135 MB (0.041 ms at 3.35 TB/s): bytes bound it once the
// products run on tensor cores, with the exponentials (67 M per recompute)
// close behind.
//
// Design of the bf16 path: two tensor-core sweeps and three small passes.
//  * delta pre-pass: one thread per (n, q row, head) sums do * out in fp32
//    from 16-byte loads;
//  * dq sweep (flash_bwd_dq_mma_kernel): a block per (64 query rows, head,
//    G consecutive groups n of one bias batch) loops over KV tiles of 64
//    keys (K, V and the key mask double-buffered in shared memory by
//    cp.async) and on mma.sync m16n8k16 recomputes S = Q K^T and dP = dO V^T,
//    forms P and dS = P (dP - delta) on the fragments, and accumulates dQ +=
//    dS K (K's fragments by ldmatrix.trans), written once times the scale.
//    The block stages its (64 x Skv) bias slice once for its G groups. The
//    bias gradient is taken here: with rep = 1 each dS tile is dbias and is
//    written as it is (the reference fuses it the same way); with rep > 1 dS
//    is summed over the block's G groups in an fp32 (64 x Skv) slab in
//    shared memory, and the slab is written once as the chunk's partial.
//    This is the variant with the slab in the dq sweep, chosen because that
//    sweep already stages the (64 x Skv) bias slice in the slab's own
//    layout, and it does three products against the dk/dv sweep's four.
//    Slab and bias take 99 KB at r = 256 and 147 KB at r = 384, so one
//    block fits an SM; it has 16 warps so that the SM still has warps to
//    switch between: warp w owns rows 16 (w % 4) and keys 16 (w / 4) of each
//    tile, keeps its rows' q and do A fragments, lse and delta in
//    registers, and the 4 warps of a row slice sum their dQ partials in a
//    fixed order at the end of each group;
//  * dk/dv sweep (flash_bwd_dkv_mma_kernel): a block per (64 keys, head, G
//    groups); each warp keeps 16 keys' K and V A fragments and their key
//    mask in registers, loops over the group's query tiles (q, do, lse and
//    delta double-buffered by cp.async), recomputes S^T = K Q^T and dP^T =
//    V dO^T, and accumulates dV += P^T dO and dK += dS^T Q (ldmatrix.trans
//    of the staged q and do). The block stages its (Sq x 64) bias slice
//    once. The mask's gradient: each lane sums its dS over query rows, a
//    quad sums its lanes, into a per-head scratch;
//  * dbias reduce (rep > 1): the rep / G partials of a bias batch summed in
//    a fixed order, cast to the bias's dtype; this replaces the third
//    recompute sweep of the first version;
//  * dmask reduce: the per-head sums summed over heads in a fixed order.
// P and dS are rounded to bf16 as the A operands of their products (the
// sums stay fp32); dbias and dmask sum dS in fp32. No floating-point atomics
// anywhere: two runs give the same bits. The products run on mma.sync
// rather than wgmma because at D = 32 the kernel is bound by bytes and
// exponentials, not by the rate of the products. Query rows past Sq
// and keys past Skv in the ragged last tiles load zeros and contribute
// nothing. The bias slices are staged up to 384 rows or keys (padded to
// 64); beyond that the bias is read per element and G is 1. The wrapper
// chooses G, allocates the partials and guarantees that q, k, v, out, do
// and their N and S strides allow 16-byte copies (the launcher checks it
// too).
//
// A row whose keys are all masked by -1e9 computes what the plain version
// computes: in fp32 every s and lse round to -1e9, so p = exp(0) for every
// key, exactly as in the reference's backward (R4).
//
// The fp32 path keeps the first version's three scalar sweeps (dq_kernel,
// dkv_kernel, dbias_kernel): on tensor cores fp32 would run as TF32 and lose
// the 1e-4 tolerance; it serves the fp32 parity runs only. One thread per
// query row (dq) or key (dk/dv) holds its vectors in fp32 registers against
// K/V or q/do tiles of 32 staged in shared memory; the dbias sweep keeps a
// 32 x 32 tile in registers and loops over the rep groups in order.
// Outputs: dq, dk, dv in q's dtype; dbias in the bias's; dmask in fp32. The
// kernels launch on the caller's stream, allocate nothing (the wrapper
// passes the delta, partial and per-head dmask scratch) and do not
// synchronise.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 128;   // fp32 dq sweep: query rows per block = threads
constexpr int kBK = 32;    // fp32 dq sweep: keys per staged tile
constexpr int kBKV = 128;  // fp32 dk/dv sweep: keys per block = threads
constexpr int kTQ = 32;    // fp32 dk/dv sweep: query rows per staged tile
constexpr int kDB = 32;    // fp32 dbias sweep: a kDB x kDB tile of (q, kv)
constexpr int kDBCols = 8; // fp32 dbias sweep: key columns per thread
constexpr int kDBThreads = kDB * kDB / kDBCols;  // 128: lane = row, warp = 8 columns

// The scalar sweeps below are instantiated for float only (the fp32 path).
__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

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


// The same in bf16, with 16-byte loads (do and out allow them: the wrapper
// copies a view that does not).
template <int D>
__global__ void delta_bf16_kernel(const __nv_bfloat16* __restrict__ dout,
                                  const __nv_bfloat16* __restrict__ out,
                                  float* __restrict__ delta, Strides st, long long rows,
                                  int sq, int nh) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows) return;
  const int h = (int)(idx % nh);
  const long long t = idx / nh;
  const int i = (int)(t % sq);
  const long long n = t / sq;
  const uint4* g = reinterpret_cast<const uint4*>(dout + n * st.g_n + i * st.g_s + (long long)h * D);
  const uint4* o = reinterpret_cast<const uint4*>(out + n * st.o_n + i * st.o_s + (long long)h * D);
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    const uint4 gv = __ldg(g + c), ov = __ldg(o + c);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const float2 gf = __bfloat1622float2(g2[p]), of = __bfloat1622float2(o2[p]);
      acc = fmaf(gf.x, of.x, acc);
      acc = fmaf(gf.y, of.y, acc);
    }
  }
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

// ---------------------------------------------------------------------------
// bf16: tensor cores, two sweeps
// ---------------------------------------------------------------------------

constexpr int kRows = 64;         // query rows (dq sweep) or keys (dk/dv sweep) per block
constexpr int kTile = 64;         // keys (dq sweep) or query rows (dk/dv sweep) per staged tile
constexpr int kThreads = 128;     // 4 warps of 16 rows or keys
constexpr int kMaxStaged = 384;   // widest bias slice (padded to kTile) a block stages
constexpr int kBT = kRows + 8;    // bf16 per staged bias row of the dk/dv sweep
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -1e30f;
constexpr float kNoRow = 1e30f;   // lse of a query row past Sq: its p is 0

template <int D>
struct BwdTile {
  static constexpr int kRow = D + 8;           // bf16 per staged row; the 16 extra bytes
                                               // put ldmatrix's 8 rows in distinct banks
  static constexpr int kElems = kTile * kRow;  // bf16 per staged tile
  // Two tiles (K, V or q, do), double-buffered, then four fp32 vectors of
  // kTile (the mask x 2, or lse and delta x 2).
  static constexpr int kFixedBytes = 4 * kElems * 2 + 4 * kTile * 4;
};

// d += a (16x16, row-major) * b (16x8, col-major); bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// 16-byte / 4-byte asynchronous copies; ok = false writes zeros instead.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// The m16n8k16 A fragments of 16 rows of a (rows, D) bf16 matrix with the
// given row stride, straight from device memory: this lane's rows r0 and
// r0 + 8, columns 2t, 2t + 1 (+ 8) of each 16-wide k chunk. Rows at or past
// `rows` are zero.
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[D / 16][4], const bf16* base,
                                             long long row_stride, int r0, int rows, int t) {
  const bool ok0 = r0 < rows, ok1 = r0 + 8 < rows;
  const bf16* p0 = base + (ok0 ? (long long)r0 * row_stride : 0) + 2 * t;
  const bf16* p1 = base + (ok1 ? (long long)(r0 + 8) * row_stride : 0) + 2 * t;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    a[kc][0] = ok0 ? __ldg(reinterpret_cast<const unsigned int*>(p0 + 16 * kc)) : 0u;
    a[kc][1] = ok1 ? __ldg(reinterpret_cast<const unsigned int*>(p1 + 16 * kc)) : 0u;
    a[kc][2] = ok0 ? __ldg(reinterpret_cast<const unsigned int*>(p0 + 16 * kc + 8)) : 0u;
    a[kc][3] = ok1 ? __ldg(reinterpret_cast<const unsigned int*>(p1 + 16 * kc + 8)) : 0u;
  }
}

// acc = A B^T: A is 16 rows x D (fragments a), B the NT * 8 rows x D of a
// staged tile that start at `tile`, read by ldmatrix; acc holds NT n-tiles
// of 8 tile rows.
template <int D, int NT>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const uint32_t (&a)[D / 16][4],
                                        const bf16* tile, int lane) {
  constexpr int kRow = BwdTile<D>::kRow;
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int jp = 0; jp < NT / 2; ++jp) {
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t b[4];
      ldmatrix_x4(b, tile + (16 * jp + (lane & 7) + ((lane >> 4) << 3)) * kRow + 16 * kc +
                         (((lane >> 3) & 1) << 3));
      mma_bf16(acc[2 * jp], a[kc], b[0], b[1]);
      mma_bf16(acc[2 * jp + 1], a[kc], b[2], b[3]);
    }
  }
}

// acc += A B: A is 16 rows x KC * 16 (the fragments of KC chunks of 16
// columns, built from an accumulator), B the KC * 16 rows x D of a staged
// tile that start at `tile`, read by ldmatrix.trans; acc holds D / 8
// n-tiles.
template <int D, int KC>
__device__ __forceinline__ void mma_ab(float (&acc)[D / 8][4], const uint32_t (&a)[KC][4],
                                       const bf16* tile, int lane) {
  constexpr int kRow = BwdTile<D>::kRow;
#pragma unroll
  for (int kk = 0; kk < KC; ++kk) {
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, tile + (16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3)) * kRow +
                               16 * dp + ((lane >> 4) << 3));
      mma_bf16(acc[2 * dp], a[kk], b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], a[kk], b[2], b[3]);
    }
  }
}

// 16-byte copies of the tile rows [r0, r0 + kTile) of a (rows, D) matrix in
// the (N, S, H, D) layout into a staged tile; rows past `rows` are zero.
template <int D, int NTHREADS>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* base, long long row_stride,
                                          int r0, int rows, int tid) {
  constexpr int kChunks = D / 8;
  for (int c = tid; c < kTile * kChunks; c += NTHREADS) {
    const int r = c / kChunks, cc = (c % kChunks) * 8;
    const bool ok = r0 + r < rows;
    cp_async16(dst + r * BwdTile<D>::kRow + cc,
               base + (ok ? (long long)(r0 + r) * row_stride : 0) + cc, ok);
  }
}

// The bias as one lane reads it: two bf16 at (row, col) and (row, col + 1)
// of a staged slice, or from device memory (0 past Sq or Skv) where the
// slice is too wide to stage.
__device__ __forceinline__ float2 bias_pair(const bf16* b, int row, int col, int sq, int skv) {
  float2 r = make_float2(0.f, 0.f);
  if (row < sq) {
    const bf16* p = b + (long long)row * skv + col;
    if (col < skv) r.x = __bfloat162float(p[0]);
    if (col + 1 < skv) r.y = __bfloat162float(p[1]);
  }
  return r;
}

// Store two bf16 at p[0], p[1] (p[1] only while col + 1 < skv): one 4-byte
// store where the pair is aligned.
__device__ __forceinline__ void store_pair(bf16* p, float x, float y, int col, int skv) {
  if (col + 1 < skv && (reinterpret_cast<uintptr_t>(p) & 3u) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
  } else {
    if (col < skv) p[0] = __float2bfloat16(x);
    if (col + 1 < skv) p[1] = __float2bfloat16(y);
  }
}

// Stage a block's bias slice, rows [r0, r0 + rows_pad) and columns [c0, c0 +
// cols_pad) of the (sq, skv) matrix at bias_h, into dst with row stride
// `stride`; zero past Sq and Skv. vec: 16-byte copies (skv % 8 == 0 and an
// aligned bias); otherwise element loads.
template <int NTHREADS>
__device__ __forceinline__ void stage_bias(bf16* dst, int stride, const bf16* bias_h, int r0,
                                           int rows_pad, int c0, int cols_pad, int sq, int skv,
                                           bool vec, int tid) {
  if (vec) {
    const int cpr = cols_pad / 8;
    for (int c = tid; c < rows_pad * cpr; c += NTHREADS) {
      const int r = c / cpr, col = (c - r * cpr) * 8;
      const bool ok = r0 + r < sq && c0 + col < skv;
      cp_async16(dst + r * stride + col,
                 bias_h + (ok ? (long long)(r0 + r) * skv + c0 + col : 0), ok);
    }
  } else {
    for (int e = tid; e < rows_pad * cols_pad; e += NTHREADS) {
      const int r = e / cols_pad, col = e - r * cols_pad;
      dst[r * stride + col] = (r0 + r < sq && c0 + col < skv)
                                  ? bias_h[(long long)(r0 + r) * skv + c0 + col]
                                  : __float2bfloat16(0.f);
    }
  }
}

// The dq sweep. Where it keeps the fp32 slab (rep > 1), slab and bias leave
// room for one block an SM, so the block has KS = 4 times the warps: warp w
// takes rows 16 (w % 4) .. + 16 and keys (w / 4) * 64 / KS .. + 64 / KS of
// every tile, and a row's dQ is the sum of KS warps' partials, taken at the
// end of each group in a fixed order through shared memory. Elsewhere KS =
// 1: 4 warps of 16 rows x 64 keys, three blocks an SM. Either way K, V and
// the mask run through kDqStages stages of cp.async with one barrier a tile,
// so that up to three tiles are in flight behind the one in use.
constexpr int kDqStages = 4;

template <int D, int KS>
struct DqSmem {
  static constexpr int kAcc = D / 2;  // fp32 dQ accumulators of a lane
  static constexpr int kStageBytes = 2 * BwdTile<D>::kElems * 2 + kTile * 4;  // K, V, mask
  static constexpr int kPartBytes = (KS - 1) * kAcc * kThreads * 4;
  static constexpr int kFixedBytes = kDqStages * kStageBytes + kPartBytes;
};

template <int D, int KS>
__global__ void __launch_bounds__(kThreads * KS, KS == 1 ? 3 : 1)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const bf16* __restrict__ bias, const float* __restrict__ mask,
                        bf16* __restrict__ dq, bf16* __restrict__ dbias,
                        float* __restrict__ dbias_part, Strides st, int sq, int skv, int nh,
                        int rep, int groups, int bias_vec, float scale) {
  using T = BwdTile<D>;
  using Q = DqSmem<D, KS>;
  constexpr int kN = kThreads * KS;  // threads
  constexpr int kKeys = kTile / KS;  // keys of a tile per warp
  constexpr int NT = kKeys / 8;      // n-tiles of S and dP per warp
  constexpr int KC = kKeys / 16;     // k chunks of dQ += dS K per warp
  extern __shared__ __align__(16) unsigned char smem[];
  // Stage i: K, V [kTile][kRow] bf16, then the mask [kTile] fp32.
  auto k_of = [&](int i) { return reinterpret_cast<bf16*>(smem + i * Q::kStageBytes); };
  auto v_of = [&](int i) { return k_of(i) + T::kElems; };
  auto m_of = [&](int i) { return reinterpret_cast<float*>(k_of(i) + 2 * T::kElems); };
  float* part = reinterpret_cast<float*>(smem + kDqStages * Q::kStageBytes);  // [KS-1][kAcc][kThreads]
  bf16* bs = reinterpret_cast<bf16*>(smem + Q::kFixedBytes);                 // [kRows][bstride]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rw = warp & 3;   // this warp's 16 rows: 16 rw ...
  const int kq = warp >> 2;  // this warp's keys of a tile: kKeys kq ...
  const int q0 = blockIdx.x * kRows, h = blockIdx.y;
  const long long chunk = blockIdx.z, n0 = chunk * groups;
  const int ntiles = (skv + kTile - 1) / kTile;
  const int skv_pad = ntiles * kTile;
  const int bstride = skv_pad + 8;  // 16 extra bytes: a quad's 8 rows hit distinct banks
  const bool has_bias = bias != nullptr, has_mask = mask != nullptr;
  const bool staged = has_bias && skv_pad <= kMaxStaged;
  // rep > 1: dS summed over the G groups in an fp32 slab beside the bias.
  const bool slab_mode = staged && dbias_part != nullptr;
  float* slab = reinterpret_cast<float*>(bs + kRows * bstride);  // [kRows][bstride]
  const bf16* bias_h = has_bias ? bias + ((n0 / rep) * nh + h) * (long long)sq * skv : nullptr;
  const int wr = rw * 16 + g;  // this lane's first row in the block; the second is wr + 8
  const int row0 = q0 + wr, row1 = row0 + 8;
  const int total = groups * ntiles;

  auto load_tile = [&](int it) {
    const int gi = it / ntiles;
    const int j0 = (it - gi * ntiles) * kTile;
    const long long n = n0 + gi;
    const int sg = it % kDqStages;
    copy_rows<D, kN>(k_of(sg), k + n * st.k_n + (long long)h * D, st.k_s, j0, skv, tid);
    copy_rows<D, kN>(v_of(sg), v + n * st.v_n + (long long)h * D, st.v_s, j0, skv, tid);
    if (has_mask && tid < kTile) {
      const int key = j0 + tid;
      const bool ok = key < skv;
      cp_async4(m_of(sg) + tid, mask + n * skv + (ok ? key : 0), ok);
    }
  };

  if (staged)
    stage_bias<kN>(bs, bstride, bias_h, q0, kRows, 0, skv_pad, sq, skv, bias_vec, tid);
  if (slab_mode)
    for (int e = tid; e < kRows * bstride; e += kN) slab[e] = 0.f;
  for (int i = 0; i < kDqStages - 1; ++i) {  // the first tiles, and the bias with the first
    if (i < total) load_tile(i);
    cp_async_commit();
  }

  uint32_t qa[D / 16][4], ga[D / 16][4];
  float dqa[D / 8][4];
  float lse0 = 0.f, lse1 = 0.f, dl0 = 0.f, dl1 = 0.f;
  for (int it = 0; it < total; ++it) {
    const int gi = it / ntiles;
    const int tile = it - gi * ntiles;
    const int j0 = tile * kTile;
    const long long n = n0 + gi;
    const int sg = it % kDqStages;
    cp_async_wait<kDqStages - 2>();  // this iteration's tile has landed
    __syncthreads();                 // and every warp is done with the previous one,
    if (it + kDqStages - 1 < total) load_tile(it + kDqStages - 1);  // whose stage this refills
    cp_async_commit();

    if (tile == 0) {
      load_a_frags<D>(qa, q + n * st.q_n + (long long)h * D, st.q_s, row0, sq, t);
      load_a_frags<D>(ga, dout + n * st.g_n + (long long)h * D, st.g_s, row0, sq, t);
      const long long sb = (n * nh + h) * (long long)sq;
      lse0 = row0 < sq ? lse[sb + row0] : kNoRow;
      lse1 = row1 < sq ? lse[sb + row1] : kNoRow;
      dl0 = row0 < sq ? delta[sb + row0] : 0.f;
      dl1 = row1 < sq ? delta[sb + row1] : 0.f;
#pragma unroll
      for (int d = 0; d < D / 8; ++d) dqa[d][0] = dqa[d][1] = dqa[d][2] = dqa[d][3] = 0.f;
    }

    // This warp's keys of the tile.
    const bf16* kt = k_of(sg) + kq * kKeys * T::kRow;
    const bf16* vt = v_of(sg) + kq * kKeys * T::kRow;
    float s[NT][4], dp[NT][4];
    mma_abt<D, NT>(s, qa, kt, lane);   // S = Q K^T
    mma_abt<D, NT>(dp, ga, vt, lane);  // dP = dO V^T

    const float* mt = m_of(sg);
    const bool ragged = j0 + kTile > skv;
    uint32_t da[KC][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = kq * kKeys + 8 * j + 2 * t;  // this lane's first column in the tile
      const int col = j0 + c;
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = s[j][e] * scale;
      if (has_bias) {
        float2 b0, b1;
        if (staged) {
          b0 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(bs + wr * bstride + col));
          b1 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(bs + (wr + 8) * bstride + col));
        } else {
          b0 = bias_pair(bias_h, row0, col, sq, skv);
          b1 = bias_pair(bias_h, row1, col, sq, skv);
        }
        x[0] += b0.x;
        x[1] += b0.y;
        x[2] += b1.x;
        x[3] += b1.y;
      }
      if (has_mask) {
        const float2 mm = *reinterpret_cast<const float2*>(mt + c);
        x[0] += mm.x;
        x[1] += mm.y;
        x[2] += mm.x;
        x[3] += mm.y;
      }
      if (ragged) {
        if (col >= skv) x[0] = x[2] = kNegInf;
        if (col + 1 >= skv) x[1] = x[3] = kNegInf;
      }
      const float ds0 = exp2_approx((x[0] - lse0) * kLog2e) * (dp[j][0] - dl0);
      const float ds1 = exp2_approx((x[1] - lse0) * kLog2e) * (dp[j][1] - dl0);
      const float ds2 = exp2_approx((x[2] - lse1) * kLog2e) * (dp[j][2] - dl1);
      const float ds3 = exp2_approx((x[3] - lse1) * kLog2e) * (dp[j][3] - dl1);
      da[j >> 1][(j & 1) * 2] = pack_bf16(ds0, ds1);
      da[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds2, ds3);
      if (has_bias) {
        if (dbias != nullptr) {  // rep == 1: this dS tile is the bias gradient
          const long long base = (n * nh + h) * (long long)sq;
          if (row0 < sq) store_pair(dbias + (base + row0) * skv + col, ds0, ds1, col, skv);
          if (row1 < sq) store_pair(dbias + (base + row1) * skv + col, ds2, ds3, col, skv);
        } else if (slab_mode) {
          float2* s0 = reinterpret_cast<float2*>(slab + wr * bstride + col);
          float2* s1 = reinterpret_cast<float2*>(slab + (wr + 8) * bstride + col);
          float2 a0 = *s0, a1 = *s1;
          a0.x += ds0;
          a0.y += ds1;
          a1.x += ds2;
          a1.y += ds3;
          *s0 = a0;
          *s1 = a1;
        } else {  // G = 1, slice too wide to stage: dS is the group's partial
          float* base = dbias_part + (chunk * nh + h) * (long long)sq * skv;
          if (row0 < sq && col < skv) base[(long long)row0 * skv + col] = ds0;
          if (row0 < sq && col + 1 < skv) base[(long long)row0 * skv + col + 1] = ds1;
          if (row1 < sq && col < skv) base[(long long)row1 * skv + col] = ds2;
          if (row1 < sq && col + 1 < skv) base[(long long)row1 * skv + col + 1] = ds3;
        }
      }
    }
    mma_ab<D, KC>(dqa, da, kt, lane);  // dQ += dS K over this warp's keys

    if (tile == ntiles - 1) {
      // The group's dQ: with KS > 1 the warps of key slices 1.. leave their
      // partials in shared memory, and slice 0 adds them in order.
      const int slot = rw * 32 + lane;
      if (KS > 1) {
        if (kq > 0) {
#pragma unroll
          for (int d = 0; d < D / 8; ++d)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              part[((kq - 1) * Q::kAcc + 4 * d + e) * kThreads + slot] = dqa[d][e];
        }
        __syncthreads();
        if (kq == 0) {
#pragma unroll
          for (int p = 0; p < KS - 1; ++p)
#pragma unroll
            for (int d = 0; d < D / 8; ++d)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                dqa[d][e] += part[(p * Q::kAcc + 4 * d + e) * kThreads + slot];
        }
      }
      if (kq == 0 && row0 < sq) {
        bf16* p0 = dq + ((n * sq + row0) * nh + h) * (long long)D + 2 * t;
#pragma unroll
        for (int d = 0; d < D / 8; ++d)
          *reinterpret_cast<__nv_bfloat162*>(p0 + 8 * d) =
              __floats2bfloat162_rn(dqa[d][0] * scale, dqa[d][1] * scale);
      }
      if (kq == 0 && row1 < sq) {
        bf16* p1 = dq + ((n * sq + row1) * nh + h) * (long long)D + 2 * t;
#pragma unroll
        for (int d = 0; d < D / 8; ++d)
          *reinterpret_cast<__nv_bfloat162*>(p1 + 8 * d) =
              __floats2bfloat162_rn(dqa[d][2] * scale, dqa[d][3] * scale);
      }
    }
  }

  if (slab_mode) {  // the chunk's partial, once
    __syncthreads();
    float* out = dbias_part + (chunk * nh + h) * (long long)sq * skv;
    for (int e = tid; e < kRows * skv; e += kN) {
      const int r = e / skv, c = e - r * skv;
      if (q0 + r < sq) out[(long long)(q0 + r) * skv + c] = slab[r * bstride + c];
    }
  }
}

template <int D, int KS>
int launch_dq(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, const float* lse,
              const float* delta, const bf16* bias, const float* mask, bf16* dq, bf16* dbias,
              float* dbias_part, Strides st, int n, int sq, int skv, int nh, int rep,
              int groups, int bias_vec, float scale, cudaStream_t stream) {
  const int skv_pad = (skv + kTile - 1) / kTile * kTile;
  const bool staged = bias != nullptr && skv_pad <= kMaxStaged;
  const size_t bytes = DqSmem<D, KS>::kFixedBytes +
                       (staged ? (size_t)kRows * (skv_pad + 8) * sizeof(bf16) : 0) +
                       (staged && dbias_part != nullptr
                            ? (size_t)kRows * (skv_pad + 8) * sizeof(float)
                            : 0);
  int err;
  if (bytes > 48 * 1024 &&
      (err = (int)cudaFuncSetAttribute(flash_bwd_dq_mma_kernel<D, KS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bytes)) != 0)
    return err;
  flash_bwd_dq_mma_kernel<D, KS>
      <<<dim3((sq + kRows - 1) / kRows, nh, n / groups), kThreads * KS, bytes, stream>>>(
          q, k, v, dout, lse, delta, bias, mask, dq, dbias, dbias_part, st, sq, skv, nh, rep,
          groups, bias_vec, scale);
  return (int)cudaGetLastError();
}

template <int D>
__global__ void __launch_bounds__(kThreads, 3)
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const bf16* __restrict__ bias, const float* __restrict__ mask,
                         bf16* __restrict__ dk, bf16* __restrict__ dv,
                         float* __restrict__ dmask_h, Strides st, int sq, int skv, int nh,
                         int rep, int groups, int bias_vec, float scale) {
  using T = BwdTile<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);                  // [2][kTile][kRow]
  bf16* gs = qs + 2 * T::kElems;                             // [2][kTile][kRow]: do
  float* ls = reinterpret_cast<float*>(gs + 2 * T::kElems);  // [2][kTile]: lse
  float* dls = ls + 2 * kTile;                               // [2][kTile]: delta
  bf16* bs = reinterpret_cast<bf16*>(smem + T::kFixedBytes);  // [sq_pad][kBT]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kv0 = blockIdx.x * kRows, h = blockIdx.y;
  const long long n0 = (long long)blockIdx.z * groups;
  const int ntiles = (sq + kTile - 1) / kTile;
  const int sq_pad = ntiles * kTile;
  const bool has_bias = bias != nullptr, has_mask = mask != nullptr;
  const bool staged = has_bias && sq_pad <= kMaxStaged;
  const bf16* bias_h = has_bias ? bias + ((n0 / rep) * nh + h) * (long long)sq * skv : nullptr;
  const int wk = warp * 16 + g;  // this lane's first key in the block; the second is wk + 8
  const int key0 = kv0 + wk, key1 = key0 + 8;
  const bool kok0 = key0 < skv, kok1 = key1 < skv;

  auto load_tile = [&](int it) {
    const int gi = it / ntiles;
    const int i0 = (it - gi * ntiles) * kTile;
    const long long n = n0 + gi;
    const int sg = it & 1;
    copy_rows<D, kThreads>(qs + sg * T::kElems, q + n * st.q_n + (long long)h * D, st.q_s, i0,
                           sq, tid);
    copy_rows<D, kThreads>(gs + sg * T::kElems, dout + n * st.g_n + (long long)h * D, st.g_s,
                           i0, sq, tid);
    const int r = tid & (kTile - 1);
    const bool ok = i0 + r < sq;
    const long long sb = (n * nh + h) * (long long)sq + (ok ? i0 + r : 0);
    if (tid < kTile)
      cp_async4(ls + sg * kTile + r, lse + sb, ok);
    else
      cp_async4(dls + sg * kTile + r, delta + sb, ok);
  };

  if (staged)
    stage_bias<kThreads>(bs, kBT, bias_h, 0, sq_pad, kv0, kRows, sq, skv, bias_vec, tid);
  load_tile(0);
  cp_async_commit();

  uint32_t ka[D / 16][4], va[D / 16][4];
  float dka[D / 8][4], dva[D / 8][4];
  float mk0 = 0.f, mk1 = 0.f, dm0 = 0.f, dm1 = 0.f;
  const int total = groups * ntiles;
  for (int it = 0; it < total; ++it) {
    const int gi = it / ntiles;
    const int tile = it - gi * ntiles;
    const int i0 = tile * kTile;
    const long long n = n0 + gi;
    const int sg = it & 1;
    cp_async_wait<0>();  // this iteration's tiles (and the bias slice) have landed,
    __syncthreads();     // and every warp is done with the previous ones,
    if (it + 1 < total) load_tile(it + 1);  // whose stage the next copy refills
    cp_async_commit();

    if (tile == 0) {
      load_a_frags<D>(ka, k + n * st.k_n + (long long)h * D, st.k_s, key0, skv, t);
      load_a_frags<D>(va, v + n * st.v_n + (long long)h * D, st.v_s, key0, skv, t);
      mk0 = (has_mask && kok0) ? mask[n * skv + key0] : 0.f;
      mk1 = (has_mask && kok1) ? mask[n * skv + key1] : 0.f;
      dm0 = dm1 = 0.f;
#pragma unroll
      for (int d = 0; d < D / 8; ++d) {
        dka[d][0] = dka[d][1] = dka[d][2] = dka[d][3] = 0.f;
        dva[d][0] = dva[d][1] = dva[d][2] = dva[d][3] = 0.f;
      }
    }

    const bf16* qt = qs + sg * T::kElems;
    const bf16* gt = gs + sg * T::kElems;
    float s[8][4], dp[8][4];
    mma_abt<D, 8>(s, ka, qt, lane);   // S^T = K Q^T: rows are keys, columns query rows
    mma_abt<D, 8>(dp, va, gt, lane);  // dP^T = V dO^T

    const float* lt = ls + sg * kTile;
    const float* dt = dls + sg * kTile;
    const bool ragged = i0 + kTile > sq;
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * t;  // this lane's first query row in the tile
      const int qi = i0 + c;
      const float2 lq = *reinterpret_cast<const float2*>(lt + c);
      const float2 dq2 = *reinterpret_cast<const float2*>(dt + c);
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = s[j][e] * scale;
      if (has_bias) {
        if (staged) {
          x[0] += __bfloat162float(bs[qi * kBT + wk]);
          x[1] += __bfloat162float(bs[(qi + 1) * kBT + wk]);
          x[2] += __bfloat162float(bs[qi * kBT + wk + 8]);
          x[3] += __bfloat162float(bs[(qi + 1) * kBT + wk + 8]);
        } else {
          const bool r0 = qi < sq, r1 = qi + 1 < sq;
          x[0] += (r0 && kok0) ? __bfloat162float(bias_h[(long long)qi * skv + key0]) : 0.f;
          x[1] += (r1 && kok0) ? __bfloat162float(bias_h[(long long)(qi + 1) * skv + key0]) : 0.f;
          x[2] += (r0 && kok1) ? __bfloat162float(bias_h[(long long)qi * skv + key1]) : 0.f;
          x[3] += (r1 && kok1) ? __bfloat162float(bias_h[(long long)(qi + 1) * skv + key1]) : 0.f;
        }
      }
      x[0] += mk0;
      x[1] += mk0;
      x[2] += mk1;
      x[3] += mk1;
      float p0 = exp2_approx((x[0] - lq.x) * kLog2e);
      float p1 = exp2_approx((x[1] - lq.y) * kLog2e);
      float p2 = exp2_approx((x[2] - lq.x) * kLog2e);
      float p3 = exp2_approx((x[3] - lq.y) * kLog2e);
      if (ragged) {  // query rows past Sq
        if (qi >= sq) p0 = p2 = 0.f;
        if (qi + 1 >= sq) p1 = p3 = 0.f;
      }
      if (!kok0) p0 = p1 = 0.f;
      if (!kok1) p2 = p3 = 0.f;
      const float ds0 = p0 * (dp[j][0] - dq2.x);
      const float ds1 = p1 * (dp[j][1] - dq2.y);
      const float ds2 = p2 * (dp[j][2] - dq2.x);
      const float ds3 = p3 * (dp[j][3] - dq2.y);
      dm0 += ds0 + ds1;
      dm1 += ds2 + ds3;
      pa[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
      da[j >> 1][(j & 1) * 2] = pack_bf16(ds0, ds1);
      da[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds2, ds3);
    }
    mma_ab<D, 4>(dva, pa, gt, lane);  // dV += P^T dO
    mma_ab<D, 4>(dka, da, qt, lane);  // dK += dS^T Q

    if (tile == ntiles - 1) {  // the group's last tile: write dk, dv and dmask once
      dm0 = quad_sum(dm0);
      dm1 = quad_sum(dm1);
      if (dmask_h != nullptr && t == 0) {
        const long long mb = (n * nh + h) * (long long)skv;
        if (kok0) dmask_h[mb + key0] = dm0;
        if (kok1) dmask_h[mb + key1] = dm1;
      }
      if (kok0) {
        const long long o = ((n * skv + key0) * nh + h) * (long long)D + 2 * t;
#pragma unroll
        for (int d = 0; d < D / 8; ++d) {
          *reinterpret_cast<__nv_bfloat162*>(dk + o + 8 * d) =
              __floats2bfloat162_rn(dka[d][0] * scale, dka[d][1] * scale);
          *reinterpret_cast<__nv_bfloat162*>(dv + o + 8 * d) =
              __floats2bfloat162_rn(dva[d][0], dva[d][1]);
        }
      }
      if (kok1) {
        const long long o = ((n * skv + key1) * nh + h) * (long long)D + 2 * t;
#pragma unroll
        for (int d = 0; d < D / 8; ++d) {
          *reinterpret_cast<__nv_bfloat162*>(dk + o + 8 * d) =
              __floats2bfloat162_rn(dka[d][2] * scale, dka[d][3] * scale);
          *reinterpret_cast<__nv_bfloat162*>(dv + o + 8 * d) =
              __floats2bfloat162_rn(dva[d][2], dva[d][3]);
        }
      }
    }
  }
}

// dbias[b] = sum over its `parts` partials, in order, cast to bf16.
__global__ void dbias_reduce_kernel(const float* __restrict__ part, bf16* __restrict__ dbias,
                                    long long per_batch, int parts, long long total) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long b = idx / per_batch;
  const float* p = part + b * parts * per_batch + (idx - b * per_batch);
  float acc = 0.f;
  for (int i = 0; i < parts; ++i) acc += p[i * per_batch];
  dbias[idx] = __float2bfloat16(acc);
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const void* out, const void* dout,
                const void* lse, const void* bias, const void* mask, void* dq, void* dk,
                void* dv, void* dbias, void* dbias_part, void* dmask, void* delta,
                void* dmask_h, Strides st, int n, int sq, int skv, int nh, int rep, int groups,
                float scale, cudaStream_t stream) {
  using T = BwdTile<D>;
  const int sq_pad = (sq + kTile - 1) / kTile * kTile;
  const int skv_pad = (skv + kTile - 1) / kTile * kTile;
  const bool has_bias = bias != nullptr;
  const bool partial = has_bias && rep > 1;
  const bool staged_q = has_bias && skv_pad <= kMaxStaged;  // the dq sweep's (64 x Skv) slice
  const bool staged_k = has_bias && sq_pad <= kMaxStaged;   // the dk/dv sweep's (Sq x 64) slice
  if (groups < 1 || n % groups != 0 || rep % groups != 0 ||
      (groups > 1 && !(staged_q && staged_k)) || (partial && dbias_part == nullptr))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout) || !aligned16(out) ||
      (st.q_n | st.q_s | st.k_n | st.k_s | st.v_n | st.v_s | st.g_n | st.g_s | st.o_n |
       st.o_s) % 8 != 0)
    return (int)cudaErrorMisalignedAddress;
  const int bias_vec = has_bias && skv % 8 == 0 && aligned16(bias);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* gp = static_cast<const bf16*>(dout);
  const bf16* bp = static_cast<const bf16*>(bias);
  const float* lp = static_cast<const float*>(lse);
  const float* mp = static_cast<const float*>(mask);
  float* dl = static_cast<float*>(delta);
  float* dmh = static_cast<float*>(dmask_h);
  int err;

  const long long rows = (long long)n * sq * nh;
  delta_bf16_kernel<D><<<(unsigned)((rows + 255) / 256), 256, 0, stream>>>(
      gp, static_cast<const bf16*>(out), dl, st, rows, sq, nh);
  if ((err = (int)cudaGetLastError()) != 0) return err;

  // The slab of rep > 1 takes the 16-warp layout; otherwise 4 warps.
  float* part = partial ? static_cast<float*>(dbias_part) : nullptr;
  bf16* db_direct = has_bias && rep == 1 ? static_cast<bf16*>(dbias) : nullptr;
  err = (partial && staged_q)
            ? launch_dq<D, 4>(qp, kp, vp, gp, lp, dl, bp, mp, static_cast<bf16*>(dq), db_direct,
                              part, st, n, sq, skv, nh, rep, groups, bias_vec, scale, stream)
            : launch_dq<D, 1>(qp, kp, vp, gp, lp, dl, bp, mp, static_cast<bf16*>(dq), db_direct,
                              part, st, n, sq, skv, nh, rep, groups, bias_vec, scale, stream);
  if (err != 0) return err;

  const size_t bytes_k = T::kFixedBytes + (staged_k ? (size_t)sq_pad * kBT * sizeof(bf16) : 0);
  if (bytes_k > 48 * 1024 &&
      (err = (int)cudaFuncSetAttribute(flash_bwd_dkv_mma_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bytes_k)) != 0)
    return err;
  flash_bwd_dkv_mma_kernel<D><<<dim3(skv_pad / kRows, nh, n / groups), kThreads, bytes_k, stream>>>(
      qp, kp, vp, gp, lp, dl, bp, mp, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      dmask != nullptr ? dmh : nullptr, st, sq, skv, nh, rep, groups, bias_vec, scale);
  if ((err = (int)cudaGetLastError()) != 0) return err;

  if (partial) {
    const long long per_batch = (long long)nh * sq * skv;
    const long long total = (long long)(n / rep) * per_batch;
    dbias_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
        static_cast<const float*>(dbias_part), static_cast<bf16*>(dbias), per_batch,
        rep / groups, total);
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

template <int D>
int launch_fp32(const void* q, const void* k, const void* v, const void* out, const void* dout,
                const void* lse, const void* bias, const void* mask, void* dq, void* dk,
                void* dv, void* dbias, void* dmask, void* delta, void* dmask_h, Strides st,
                int n, int sq, int skv, int nh, int rep, float scale, cudaStream_t stream) {
  using T = float;
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

}  // namespace

// q: (N, Sq, H, D); k, v: (N, Skv, H, D); out, dout: (N, Sq, H, D); each with
// unit D stride and H stride D, the N and S strides given in elements. lse:
// (N, H, Sq) fp32 contiguous. bias: (N/rep, H, Sq, Skv) contiguous, or NULL;
// mask: (N, Skv) fp32 contiguous, or NULL. Outputs, contiguous: dq (N, Sq, H,
// D), dk, dv (N, Skv, H, D); dbias (N/rep, H, Sq, Skv) when bias is given;
// dmask (N, Skv) fp32, or NULL when its gradient is not wanted. Scratch:
// delta (N, H, Sq) fp32; dmask_h (N, H, Skv) fp32 when dmask is given;
// dbias_part (N/groups, H, Sq, Skv) fp32 in bf16 when bias is given and
// rep > 1 (else NULL). groups (bf16 only): consecutive groups n per block,
// dividing rep and N, 1 where a bias slice is not staged (Sq or Skv padded
// to 64 above 384); in bf16, q, k, v, out, dout and their N and S strides must
// allow 16-byte copies. dtype: 0 = float32, 1 = bfloat16 (q, k, v, out,
// dout, bias, dq, dk, dv, dbias). Returns the first failing launch's
// cudaError_t, else 0.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* out, const void* dout, const void* lse,
                                   const void* bias, const void* mask, void* dq, void* dk,
                                   void* dv, void* dbias, void* dbias_part, void* dmask,
                                   void* delta, void* dmask_h, long long q_sn, long long q_ss,
                                   long long k_sn, long long k_ss, long long v_sn,
                                   long long v_ss, long long o_sn, long long o_ss,
                                   long long g_sn, long long g_ss, int n, int sq, int skv,
                                   int nh, int d, int rep, int groups, float scale, int dtype,
                                   void* stream) {
  if (n <= 0 || sq <= 0 || skv <= 0 || nh <= 0 || nh > 65535 || n > 65535 || rep <= 0 ||
      n % rep != 0)
    return (int)cudaErrorInvalidValue;
  if ((bias != nullptr) != (dbias != nullptr)) return (int)cudaErrorInvalidValue;
  if (dmask != nullptr && (mask == nullptr || dmask_h == nullptr))
    return (int)cudaErrorInvalidValue;
  const Strides st{q_sn, q_ss, k_sn, k_ss, v_sn, v_ss, o_sn, o_ss, g_sn, g_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_BWD_CASE(DD)                                                                    \
  case DD:                                                                                    \
    return dtype == 0                                                                         \
               ? launch_fp32<DD>(q, k, v, out, dout, lse, bias, mask, dq, dk, dv, dbias,      \
                                 dmask, delta, dmask_h, st, n, sq, skv, nh, rep, scale, s)    \
               : launch_bf16<DD>(q, k, v, out, dout, lse, bias, mask, dq, dk, dv, dbias,      \
                                 dbias_part, dmask, delta, dmask_h, st, n, sq, skv, nh, rep,  \
                                 groups, scale, s);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  switch (d) {
    FLASH_BWD_CASE(16)  // MINI
    FLASH_BWD_CASE(32)  // FULL
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FLASH_BWD_CASE
}
