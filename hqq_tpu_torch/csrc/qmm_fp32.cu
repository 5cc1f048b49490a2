// SPDX-License-Identifier: Apache-2.0
// qmm_fp32: the fp32 route of the dequant-matmul kernels. For fp32
// activations, y[M, N] = x @ W^T (+ (x @ A) @ B) with every value in fp32:
// W[n, k] = code * scale - zs dequantized in fp32 (an fp32 multiply, then an
// fp32 subtract, as the plain version does), products and sums in fp32 on
// the CUDA cores, y in fp32. One templated kernel serves both kernel layouts
// and the LoRA term:
//   axis=1 (quant_matmul, quant_matmul_lora): codes [N, K*cb/8] in the word
//     layout of hqq_common.cuh, scale and zs [N, C] (`hqq_ax1_meta_cols`);
//   axis=0 (quant_matmul_ax0): codes [N, K_pad*cb/8], scale and zs
//     [N/g, K_pad], row n reading row n % (N/g);
// with scale and zs in fp32 or bf16 (widened to fp32 as they are read, the
// axis=1 4-bit container's zs given its 8*scale back: `hqq_ax1_zs_offset`).
//
// Replaces, for fp32 activations: hqq_tpu/ops/fused_matmul.py `_qmm_kernel`,
//   `_qmm_ax0_kernel`, `_qmm_ax0_cm_kernel` and `_qmm_lora_kernel`, which
//   take x in any type and multiply in it (`hqq_tpu`'s own training recipe
//   computes in fp32). The tensor-core kernels of quant_matmul*.cu take bf16
//   and fp16 only; rounding x to them would not be an fp32 result.
// Bound on H100: operations, 2*M*N*K at the fp32 rate of the CUDA cores
//   (67 TFLOP/s): M=512, K=N=4096 is 17.2 GFLOP, 0.26 ms.
// Design: a block computes a 64 x 64 tile of y (64 tokens, 64 weight rows)
//   with 256 threads, each 4 x 4 outputs (rows ty + 16i, columns tx + 16j,
//   so that a warp's loads from shared memory are broadcasts or 16
//   consecutive words). K is walked in steps of 32: the block stages x's
//   [64 x 32] slice and dequantizes W's [64 x 32] slice into shared memory,
//   both transposed so that the inner loop reads a row of each. With an
//   adapter, the walk also stages A's [32 x 16] slice and each thread sums
//   p = x @ A for one token and four ranks; after the walk, p goes to shared
//   memory and each thread adds sum_j p[m, j] * B[j, n] to its outputs. A
//   rank above 16 walks K again for each further chunk of 16, for p alone.
//   Simple and right first: the tensor-core route for fp32 (3xTF32 wgmma)
//   is later work.
#include "hqq_common.cuh"

namespace {

constexpr int kTM = 64;       // tokens of a block
constexpr int kTN = 64;       // weight rows (output features) of a block
constexpr int kTK = 32;       // K of a step
constexpr int kRC = 16;       // ranks of a chunk of the LoRA term
constexpr int kThreads = 256;

// a quantized weight in either kernel layout
struct Weight {
  const uint32_t* wq;  // [N, row_words] 32-bit words of codes
  const void* scale;
  const void* zs;
  int n, k;        // logical out and in features
  int row_words;   // words of a code row
  int meta_cols;   // row length of scale and zs
  int g, cb, axis;
  int pblocks;     // axis=0: N/g
  float zadd;      // axis=1: the multiple of scale the stored zs lacks
};

// W[n, k] in fp32, as `dequant_plain` computes it
template <typename Meta>
__device__ __forceinline__ float weight_at(const Weight& w, int n, int k) {
  const int per_word = 32 / w.cb;  // code k = per_word * word + 4f + b at bit 8b + cb*f
  const uint32_t word = __ldg(w.wq + static_cast<size_t>(n) * w.row_words + k / per_word);
  const int kk = k % per_word;
  const uint32_t code = (word >> (8 * (kk % 4) + w.cb * (kk / 4))) & ((1u << w.cb) - 1u);
  const size_t mi = w.axis == 1 ? static_cast<size_t>(n) * w.meta_cols + k / w.g
                                : static_cast<size_t>(n % w.pblocks) * w.meta_cols + k;
  const float s = meta_f32(static_cast<const Meta*>(w.scale)[mi]);
  return hqq_dq(code, s, meta_f32(static_cast<const Meta*>(w.zs)[mi]) + w.zadd * s);
}

template <typename Meta, bool kLora>
__global__ void __launch_bounds__(kThreads)
    qmm_fp32_kernel(const float* __restrict__ x, const Weight w, const float* __restrict__ a,
                    const float* __restrict__ lb, int rank, float* __restrict__ out, int m) {
  __shared__ float xs[kTK][kTM + 1];  // x's slice, transposed: [k][token]
  __shared__ float ws[kTK][kTN + 1];  // W's slice, transposed: [k][weight row]
  __shared__ float as[kTK][kRC];      // A's slice of the rank chunk
  __shared__ float ps[kTM][kRC + 1];  // p = x @ A of the chunk
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kTM, n0 = blockIdx.x * kTN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int chunks = kLora ? (rank + kRC - 1) / kRC : 1;
  for (int c = 0; c < chunks; ++c) {
    float pacc[4] = {0.f, 0.f, 0.f, 0.f};  // token tid / 4, ranks 4 * (tid % 4) + 0..3
    for (int k0 = 0; k0 < w.k; k0 += kTK) {
      for (int i = tid; i < kTM * kTK; i += kThreads) {
        const int r = i / kTK, kk = i % kTK;
        xs[kk][r] = m0 + r < m && k0 + kk < w.k ? x[static_cast<size_t>(m0 + r) * w.k + k0 + kk]
                                                : 0.f;
      }
      if (c == 0) {
        for (int i = tid; i < kTN * kTK; i += kThreads) {
          const int r = i / kTK, kk = i % kTK;
          ws[kk][r] = n0 + r < w.n && k0 + kk < w.k ? weight_at<Meta>(w, n0 + r, k0 + kk) : 0.f;
        }
      }
      if constexpr (kLora) {
        for (int i = tid; i < kTK * kRC; i += kThreads) {
          const int kk = i / kRC, j = c * kRC + i % kRC;
          as[kk][i % kRC] = k0 + kk < w.k && j < rank
                                ? a[static_cast<size_t>(k0 + kk) * rank + j] : 0.f;
        }
      }
      __syncthreads();
      if (c == 0) {
#pragma unroll 8
        for (int kk = 0; kk < kTK; ++kk) {
          float xv[4], wv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) xv[i] = xs[kk][ty + 16 * i], wv[i] = ws[kk][tx + 16 * i];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
        }
      }
      if constexpr (kLora) {
#pragma unroll 8
        for (int kk = 0; kk < kTK; ++kk) {
          const float xv = xs[kk][tid / 4];
#pragma unroll
          for (int j = 0; j < 4; ++j) pacc[j] = fmaf(xv, as[kk][4 * (tid % 4) + j], pacc[j]);
        }
      }
      __syncthreads();
    }
    if constexpr (kLora) {
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[tid / 4][4 * (tid % 4) + j] = pacc[j];
      __syncthreads();
      const int rc = min(kRC, rank - c * kRC);
      for (int j = 0; j < rc; ++j) {
        float b[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int col = n0 + tx + 16 * jj;
          b[jj] = col < w.n ? __ldg(lb + static_cast<size_t>(c * kRC + j) * w.n + col) : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) acc[i][jj] = fmaf(ps[ty + 16 * i][j], b[jj], acc[i][jj]);
      }
      __syncthreads();  // the next chunk rewrites ps
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < w.n) out[static_cast<size_t>(row) * w.n + col] = acc[i][j];
    }
  }
}

template <typename Meta>
int launch(const float* x, const Weight& w, const float* a, const float* lb, int rank,
           float* out, int m, cudaStream_t s) {
  const dim3 grid((w.n + kTN - 1) / kTN, (m + kTM - 1) / kTM);
  if (rank > 0)
    qmm_fp32_kernel<Meta, true><<<grid, kThreads, 0, s>>>(x, w, a, lb, rank, out, m);
  else
    qmm_fp32_kernel<Meta, false><<<grid, kThreads, 0, s>>>(x, w, a, lb, rank, out, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x fp32 [m, k] and out fp32 [m, n], contiguous; axis 1: wq [n, k*cb/8],
// scale and zs [n, hqq_ax1_meta_cols(k/g)]; axis 0: wq [n, k_pad*cb/8],
// scale and zs [n/g, k_pad]; meta_dtype HQQ_F32 or HQQ_BF16. rank 0: no
// adapter; else a fp32 [k, rank] and lb fp32 [rank, n].
HQQ_EXPORT int hqq_qmm_fp32(const void* x, const void* wq, const void* scale, const void* zs,
                            const void* a, const void* lb, void* out, int m, int n, int k,
                            int k_pad, int group_size, int cb, int axis, int meta_dtype, int rank,
                            void* stream) {
  if (m < 1 || n < 1 || k < 1 || group_size < 1 || (cb != 1 && cb != 2 && cb != 4 && cb != 8) ||
      (axis != 0 && axis != 1) || rank < 0 || (rank > 0 && (a == nullptr || lb == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Weight w;
  w.wq = static_cast<const uint32_t*>(wq);
  w.scale = scale, w.zs = zs;
  w.n = n, w.k = k, w.g = group_size, w.cb = cb, w.axis = axis;
  const int kw = axis == 1 ? k : k_pad;
  w.row_words = kw / (32 / cb);
  w.meta_cols = axis == 1 ? hqq_ax1_meta_cols(k / group_size, meta_dtype) : k_pad;
  w.pblocks = axis == 0 ? n / group_size : 0;
  w.zadd = axis == 1 ? hqq_ax1_zs_offset(cb, meta_dtype) : 0.f;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto xf = static_cast<const float*>(x);
  const auto af = static_cast<const float*>(a);
  const auto bf = static_cast<const float*>(lb);
  if (meta_dtype == HQQ_F32) return launch<float>(xf, w, af, bf, rank, static_cast<float*>(out), m, s);
  if (meta_dtype == HQQ_BF16)
    return launch<__nv_bfloat16>(xf, w, af, bf, rank, static_cast<float*>(out), m, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

HQQ_EXPORT const char* hqq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
