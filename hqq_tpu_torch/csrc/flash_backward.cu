// SPDX-License-Identifier: Apache-2.0
// The fp32 route of the flash-attention backward (dK/dV and dQ) at head
// size 256, on the CUDA cores. The launch plan (`flash_backward_launch_plan`)
// routes head sizes above 128 here by shape, before any launch: the tensor-
// core kernels of flash_backward_fp32_sm90.cu keep 64 rows of an operand
// pair in two TF32 parts in shared memory, 256 KB at head size 256. bf16 and
// fp16 take flash_backward_sm90.cu; the fp32 forward is flash_fp32_sm90.cu's.
//
// For out = softmax(scale * q k^T [causal]) v over whole sequences, with
// the forward's log-sum-exp lse [B, nh, T] (natural log, fp32) and
// D = rowsum(dO * O) [B, nh, T] (fp32, computed by the wrapper as
// `hqq_tpu`'s library computes it outside its kernels):
//   P  = exp(scale * q k^T - lse)         (0 above the diagonal and past T)
//   dV = P^T dO          dP = dO V^T       dS = P * (dP - D)
//   dQ = scale * dS K    dK = scale * dS^T Q
// with every value in fp32. k and v hold n_kv heads, each shared by
// nh / n_kv query heads (GQA): dK and dV sum over the group.
//
// Replaces: the backward kernels of the library flash attention that
//   `hqq_tpu.ops.attention.prefill_attention` calls on every training step
//   (jax/experimental/pallas/ops/tpu/flash_attention.py
//   `_flash_attention_bwd_dkv`, and `_flash_attention_bwd_dq`), under its
//   custom VJP, for fp32 inputs at head size 256.
// Bound on H100: operations. The backward does about 2.5 times the causal
//   forward's work, 5 * 2 * T^2 * hd per head halved for causality, at the
//   fp32 rate of the CUDA cores, which these kernels use.
// Design: simple and right first. Every product runs on the CUDA cores in
//   fp32, from tiles staged in shared memory as fp32 (rows of hd + 1 words,
//   so that a column read by 16 threads hits 16 banks); 256 threads, each
//   owning a 2 x 2 block of a 32 x 32 tile at rows ty + 16i and columns
//   tx + 16j.
//   * dK/dV: one block per (batch, kv head, key tile). It keeps its K and V
//     tiles in shared memory and walks, for every query head of its group,
//     the query tiles at or below the diagonal; for each it recomputes S
//     and dP, forms P and dS in shared memory, and adds P^T dO and dS^T Q to
//     dV and dK in registers. It writes dK and dV once: no atomics, so
//     repeated runs are bit-equal.
//   * dQ: one block per (batch, head, query tile), longest first. It keeps
//     Q, dO, lse and D and walks the key tiles at or left of the diagonal,
//     recomputing S, dP and dS and adding dS K to dQ in registers.
//   Both recompute P = exp2(S * scale * log2 e - lse * log2 e), the
//   convention of the forward kernels (log2 units, scale applied to S),
//   with the causal mask on the diagonal tile and zeros for keys and
//   queries past T, so a row past T is never NaN.
#include <math.h>

#include "hqq_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

// query and key rows of a tile for a padded head size
template <int HDP>
struct Tile {
  static constexpr int kRows = 32;
  static constexpr int kLd = HDP + 1;  // row length in shared memory (floats)
};

// Shared memory (floats) of each kernel; ops/attention.py
// `flash_backward_launch_plan` computes the same sizes.
__host__ __device__ inline int dkv_smem_floats(int hdp, int rows) {
  return 4 * rows * (hdp + 1) + 2 * rows * (rows + 1) + 2 * rows;
}
__host__ __device__ inline int dq_smem_floats(int hdp, int rows) {
  return 4 * rows * (hdp + 1) + rows * (rows + 1) + 2 * rows;
}

// rows [row0, row0 + ROWS) of a [T, hd] matrix into dst [ROWS][HDP + 1] as
// fp32, zeros past T and past hd
template <int ROWS, int HDP, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src, int row0, int t,
                                          int hd) {
  for (int i = threadIdx.x; i < ROWS * HDP; i += kThreads) {
    const int r = i / HDP, d = i % HDP;
    dst[r * (HDP + 1) + d] =
        row0 + r < t && d < hd ? src[static_cast<size_t>(row0 + r) * hd + d] : 0.f;
  }
}

// lse (in log2 units) and D of rows [row0, row0 + ROWS) of one head
template <int ROWS>
__device__ __forceinline__ void load_stats(float* lse_s, float* d_s, const float* __restrict__ lse,
                                           const float* __restrict__ dd, int row0, int t) {
  for (int i = threadIdx.x; i < ROWS; i += kThreads) {
    const bool ok = row0 + i < t;
    lse_s[i] = ok ? lse[row0 + i] * kLog2e : 0.f;
    d_s[i] = ok ? dd[row0 + i] : 0.f;
  }
}

// P and dS of a (query tile, key tile) pair into shared memory ([BM][BM + 1]
// each; ps may be null): S = Q K^T and dP = dO V^T from the staged tiles,
// then P = exp2(S * scale_log2 - lse), 0 where masked, dS = P (dP - D).
template <int HDP>
__device__ __forceinline__ void probs_and_ds(const float* qs, const float* dos, const float* ks,
                                             const float* vs, const float* lse_s,
                                             const float* d_s, float* ps, float* dss, int m0,
                                             int n0, int t, int causal, float scale_log2) {
  constexpr int BM = Tile<HDP>::kRows, R = BM / 16, LD = Tile<HDP>::kLd;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float s[R][R], dp[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) s[i][j] = 0.f, dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HDP; ++d) {
    float qv[R], ov[R], kv[R], vv[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      qv[i] = qs[(ty + 16 * i) * LD + d], ov[i] = dos[(ty + 16 * i) * LD + d];
      kv[i] = ks[(tx + 16 * i) * LD + d], vv[i] = vs[(tx + 16 * i) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int m = ty + 16 * i, n = tx + 16 * j;
      const int row = m0 + m, col = n0 + n;
      const bool ok = row < t && col < t && !(causal && col > row);
      const float p = ok ? exp2f(s[i][j] * scale_log2 - lse_s[m]) : 0.f;
      if (ps != nullptr) ps[m * (BM + 1) + n] = p;
      dss[m * (BM + 1) + n] = p * (dp[i][j] - d_s[m]);
    }
}

template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ dd,
                         T* __restrict__ dk, T* __restrict__ dv, int b_kv, int nh, int n_kv,
                         int t, int hd, float scale, int causal) {
  constexpr int BM = Tile<HDP>::kRows, R = BM / 16, C = HDP / 16, LD = Tile<HDP>::kLd;
  extern __shared__ float sm[];
  float* ks = sm;
  float* vs = ks + BM * LD;
  float* qs = vs + BM * LD;
  float* dos = qs + BM * LD;
  float* ps = dos + BM * LD;
  float* dss = ps + BM * (BM + 1);
  float* lse_s = dss + BM * (BM + 1);
  float* d_s = lse_s + BM;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  const int kt = blockIdx.x / b_kv;  // key tile 0 first: under causality it walks the most
  const int bkv = blockIdx.x % b_kv;  // b * n_kv + kv head
  const int b = bkv / n_kv, rep = nh / n_kv;
  const int n0 = kt * BM;
  const size_t kv_off = static_cast<size_t>(bkv) * t * hd;
  load_rows<BM, HDP>(ks, k + kv_off, n0, t, hd);
  load_rows<BM, HDP>(vs, v + kv_off, n0, t, hd);

  float dka[R][C], dva[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) dka[i][j] = 0.f, dva[i][j] = 0.f;
  const float scale_log2 = scale * kLog2e;
  const int q_tiles = (t + BM - 1) / BM;
  for (int r = 0; r < rep; ++r) {
    const int head = b * nh + bkv % n_kv * rep + r;
    const size_t q_off = static_cast<size_t>(head) * t * hd;
    for (int qt = causal ? kt : 0; qt < q_tiles; ++qt) {
      const int m0 = qt * BM;
      __syncthreads();  // the previous tile's reads are done
      load_rows<BM, HDP>(qs, q + q_off, m0, t, hd);
      load_rows<BM, HDP>(dos, dout + q_off, m0, t, hd);
      load_stats<BM>(lse_s, d_s, lse + static_cast<size_t>(head) * t,
                     dd + static_cast<size_t>(head) * t, m0, t);
      __syncthreads();
      probs_and_ds<HDP>(qs, dos, ks, vs, lse_s, d_s, ps, dss, m0, n0, t, causal, scale_log2);
      __syncthreads();
      // dV[n] += sum_m P[m][n] dO[m];  dK[n] += sum_m dS[m][n] Q[m]
#pragma unroll 2
      for (int m = 0; m < BM; ++m) {
        float pv[R], sv[R];
#pragma unroll
        for (int i = 0; i < R; ++i)
          pv[i] = ps[m * (BM + 1) + ty + 16 * i], sv[i] = dss[m * (BM + 1) + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < C; ++j) {
          const float o = dos[m * LD + tx + 16 * j], qq = qs[m * LD + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < R; ++i) {
            dva[i][j] = fmaf(pv[i], o, dva[i][j]);
            dka[i][j] = fmaf(sv[i], qq, dka[i][j]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int n = n0 + ty + 16 * i;
    if (n >= t) continue;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) {
        dk[kv_off + static_cast<size_t>(n) * hd + d] = dka[i][j] * scale;
        dv[kv_off + static_cast<size_t>(n) * hd + d] = dva[i][j];
      }
    }
  }
}

template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        const T* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ dd, T* __restrict__ dq, int bh, int nh,
                        int n_kv, int t, int hd, float scale, int causal) {
  constexpr int BM = Tile<HDP>::kRows, R = BM / 16, C = HDP / 16, LD = Tile<HDP>::kLd;
  extern __shared__ float sm[];
  float* qs = sm;
  float* dos = qs + BM * LD;
  float* ks = dos + BM * LD;
  float* vs = ks + BM * LD;
  float* dss = vs + BM * LD;
  float* lse_s = dss + BM * (BM + 1);
  float* d_s = lse_s + BM;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  const int q_tiles = (t + BM - 1) / BM;
  const int qt = q_tiles - 1 - static_cast<int>(blockIdx.x) / bh;  // the longest first
  const int head = blockIdx.x % bh;                                  // b * nh + h
  const int kv_head = head / nh * n_kv + head % nh / (nh / n_kv);
  const int m0 = qt * BM;
  const size_t q_off = static_cast<size_t>(head) * t * hd;
  const size_t kv_off = static_cast<size_t>(kv_head) * t * hd;
  load_rows<BM, HDP>(qs, q + q_off, m0, t, hd);
  load_rows<BM, HDP>(dos, dout + q_off, m0, t, hd);
  load_stats<BM>(lse_s, d_s, lse + static_cast<size_t>(head) * t,
                 dd + static_cast<size_t>(head) * t, m0, t);

  float dqa[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) dqa[i][j] = 0.f;
  const float scale_log2 = scale * kLog2e;
  const int n_tiles = causal ? qt + 1 : q_tiles;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int n0 = kt * BM;
    __syncthreads();  // the previous tile's reads are done
    load_rows<BM, HDP>(ks, k + kv_off, n0, t, hd);
    load_rows<BM, HDP>(vs, v + kv_off, n0, t, hd);
    __syncthreads();
    probs_and_ds<HDP>(qs, dos, ks, vs, lse_s, d_s, nullptr, dss, m0, n0, t, causal, scale_log2);
    __syncthreads();
    // dQ[m] += sum_n dS[m][n] K[n]
#pragma unroll 2
    for (int n = 0; n < BM; ++n) {
      float sv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) sv[i] = dss[(ty + 16 * i) * (BM + 1) + n];
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const float kk = ks[n * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < R; ++i) dqa[i][j] = fmaf(sv[i], kk, dqa[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= t) continue;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) dq[q_off + static_cast<size_t>(m) * hd + d] = dqa[i][j] * scale;
    }
  }
}

template <typename K>
int set_smem(K kernel, int smem) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

bool valid(int b, int nh, int n_kv, int t, int hd, int head_pad) {
  return b >= 1 && nh >= 1 && n_kv >= 1 && nh % n_kv == 0 && t >= 1 && hd >= 16 && hd % 16 == 0 &&
         hd <= head_pad && head_pad == 256;
}

template <typename T, int HDP>
int backward(const void* q, const void* k, const void* v, const void* dout, const float* lse,
             const float* dd, void* dq, void* dk, void* dv, int b, int nh, int n_kv, int t,
             int hd, float scale, int causal, int smem_dkv, int smem_dq, cudaStream_t s) {
  constexpr int BM = Tile<HDP>::kRows;
  if (smem_dkv < 4 * dkv_smem_floats(HDP, BM) || smem_dq < 4 * dq_smem_floats(HDP, BM))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (t + BM - 1) / BM;
  if (dk != nullptr) {
    auto kernel = flash_bwd_dkv_kernel<T, HDP>;
    int e = set_smem(kernel, smem_dkv);
    if (e != 0) return e;
    kernel<<<b * n_kv * tiles, kThreads, smem_dkv, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), lse, dd, static_cast<T*>(dk), static_cast<T*>(dv), b * n_kv,
        nh, n_kv, t, hd, scale, causal);
    e = static_cast<int>(cudaGetLastError());
    if (e != 0) return e;
  }
  if (dq != nullptr) {
    auto kernel = flash_bwd_dq_kernel<T, HDP>;
    int e = set_smem(kernel, smem_dq);
    if (e != 0) return e;
    kernel<<<b * nh * tiles, kThreads, smem_dq, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), lse, dd, static_cast<T*>(dq), b * nh, nh, n_kv, t, hd, scale,
        causal);
    return static_cast<int>(cudaGetLastError());
  }
  return 0;
}

template <typename T>
int backward_head(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                  const float* dd, void* dq, void* dk, void* dv, int b, int nh, int n_kv, int t,
                  int hd, float scale, int causal, int head_pad, int smem_dkv, int smem_dq,
                  cudaStream_t s) {
#define HQQ_FLASH_BWD(HDP)                                                                      \
  if (head_pad == HDP)                                                                          \
  return backward<T, HDP>(q, k, v, dout, lse, dd, dq, dk, dv, b, nh, n_kv, t, hd, scale, causal, \
                          smem_dkv, smem_dq, s)
  HQQ_FLASH_BWD(256);
#undef HQQ_FLASH_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, dout, dq [B, nh, T, hd] and k, v, dk, dv [B, n_kv, T, hd] fp32
// (dtype HQQ_F32), contiguous; lse and dd fp32 [B, nh, T]; head_pad 256.
// Either kernel runs alone where the other's outputs are null (dq, or dk and
// dv). The shared-memory sizes come from the launch plan
// (`flash_backward_launch_plan`).
HQQ_EXPORT int hqq_flash_backward(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* dd, void* dq, void* dk, void* dv,
                                  int b, int nh, int n_kv, int t, int hd, float scale, int causal,
                                  int dtype, int head_pad, int smem_dkv, int smem_dq,
                                  void* stream) {
  if (!valid(b, nh, n_kv, t, hd, head_pad) || (dk == nullptr) != (dv == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto l = static_cast<const float*>(lse);
  const auto d = static_cast<const float*>(dd);
#define HQQ_FLASH_BWD_TYPE(T)                                                                  \
  return backward_head<T>(q, k, v, dout, l, d, dq, dk, dv, b, nh, n_kv, t, hd, scale, causal, \
                          head_pad, smem_dkv, smem_dq, s)
  if (dtype == HQQ_F32) HQQ_FLASH_BWD_TYPE(float);
#undef HQQ_FLASH_BWD_TYPE
  return static_cast<int>(cudaErrorInvalidValue);
}

HQQ_EXPORT const char* hqq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
