// SPDX-License-Identifier: Apache-2.0
// quant_matmul_ax0: y[M, N] = x[M, K] @ W^T for a weight quantized in groups
// along axis 0: W[n, k] = code[n, k] * scale[n % P, k] - zs[n % P, k], with
// P = N/g. The g rows {b, b + P, b + 2P, ...} share the scale and zs of
// column k. W is dequantized in fp32 and rounded to x's type (bf16 or
// fp16), multiplied on the tensor cores with an fp32 accumulator; y in x's
// type, in logical column order. Any M.
//
// Kernel layout (`to_kernel_layout_ax0`): wq uint8 [N, K_pad*cb/8], the codes
// of logical row n contiguous along K in the word layout of hqq_common.cuh
// (K padded with zero codes to K_pad, a multiple of 32); scale and zs
// [P, K_pad] in fp32 or bf16 (zero past K), widened to fp32 for the
// arithmetic. x has row length kx <= K_pad, a multiple of 8.
//
// Replaces: hqq_tpu/ops/fused_matmul.py `_qmm_ax0_kernel` (launched by
//   `_qmm_ax0_call`) and `_qmm_ax0_cm_kernel` (`_qmm_ax0_cm_call`), both
//   behind `_quant_matmul_pallas_ax0`. The TPU needs the second, chunk-major
//   kernel for groups under 8 packed rows; one kernel serves every g here,
//   and nothing of the TPU's row permutation at pack time is kept.
// Bound on H100: bytes at decode (the codes plus 2*P*K scale and zs values;
//   at 2-bit g16 with fp32 meta the meta is twice the codes), operations at
//   prefill (2*M*N*K at the bf16 rate). Scale and zs change with every k, so
//   nothing factors out of an int8 dot: bf16/fp16 operands at every M.
// Design: the 64x64 tile of qmm_tile.cuh over PERMUTED rows p = b*g + a
//   (logical row n = a*P + b): a tile's 64 rows are whole groups (or a part
//   of one), so the tile reads 64/g rows of scale and zs instead of 64. Each
//   thread dequantizes one 32-bit word of codes with that word's 32/cb
//   scales and zs. The store maps p back to n. At M <= 64 there are only
//   N/64 tiles, so K is split over gridDim.z: each split writes an fp32
//   partial and a second kernel sums the partials in a fixed order.
#include "qmm_tile.cuh"

namespace {

using namespace qmm;

// ws[nr][kk] = W[row(p0 + nr), k0 + kk], dequantized; pblocks = n / g
template <typename T, typename Meta>
__device__ __forceinline__ void dequant_slab_ax0(T* ws, const uint32_t* __restrict__ wq,
                                                 const Meta* __restrict__ scale,
                                                 const Meta* __restrict__ zs, int p0, int k0,
                                                 int n, int k_pad, int g, int pblocks,
                                                 const WordLayout& l) {
  for (int idx = threadIdx.x; idx < kBN * l.slab_words; idx += kThreads) {
    const int nr = idx / l.slab_words;
    const int wj = idx % l.slab_words;
    const int p = p0 + nr;
    const int kk = k0 + wj * l.codes_per_word;
    T* dst = ws + nr * kLd + wj * l.codes_per_word;
    if (p < n && kk < k_pad) {
      const int row = (p % g) * pblocks + p / g;
      const uint32_t word =
          __ldg(wq + static_cast<size_t>(row) * l.row_words + kk / l.codes_per_word);
      const size_t mi = static_cast<size_t>(p / g) * k_pad + kk;
      for (int f = 0; f < l.fields; ++f) {
        const uint32_t q = (word >> (l.cb * f)) & l.mask;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int e = 4 * f + b;
          dst[e] = to_t<T>(hqq_dq((q >> (8 * b)) & 0xffu, meta_f32(scale, mi + e),
                                  meta_f32(zs, mi + e)));
        }
      }
    } else {
      for (int e = 0; e < l.codes_per_word; ++e) dst[e] = to_t<T>(0.f);
    }
  }
}

// part: null, or fp32 [gridDim.z, M, N] partial sums (K split over blockIdx.z)
template <typename T, typename Meta>
__global__ void __launch_bounds__(kThreads)
    qmm_ax0_kernel(const T* __restrict__ x, const uint32_t* __restrict__ wq,
                   const Meta* __restrict__ scale, const Meta* __restrict__ zs, int out_dtype,
                   void* __restrict__ out, float* __restrict__ part, int m, int n, int kx,
                   int k_pad, int g, int cb, int slabs_per_split) {
  __shared__ Smem smem;
  T* xs = reinterpret_cast<T*>(smem.slabs.x);
  T* ws = reinterpret_cast<T*>(smem.slabs.w);

  const int m0 = blockIdx.y * kBM;
  const int p0 = blockIdx.x * kBN;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 32;
  const int k_begin = blockIdx.z * slabs_per_split * kBK;
  const int k_end = min(k_pad, k_begin + slabs_per_split * kBK);

  const WordLayout layout = word_layout(k_pad, cb);
  const int pblocks = n / g;

  Acc acc[2][2];
  zero_acc(acc);
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    load_x_slab(xs, x, m0, k0, m, kx);
    dequant_slab_ax0(ws, wq, scale, zs, p0, k0, n, k_pad, g, pblocks, layout);
    __syncthreads();
    mma_slab(acc, xs, ws, wm, wn);
    __syncthreads();
  }

  stage_acc(smem.c, acc, wm, wn);
  __syncthreads();
  for (int idx = threadIdx.x; idx < kBM * kBN; idx += kThreads) {
    const int r = idx / kBN;
    const int p = p0 + idx % kBN;
    if (m0 + r < m && p < n) {
      const int col = (p % g) * pblocks + p / g;
      const float v = smem.c[r * kLdc + idx % kBN];
      if (part != nullptr) {
        part[(static_cast<size_t>(blockIdx.z) * m + m0 + r) * n + col] = v;
      } else {
        hqq_store(out, static_cast<size_t>(m0 + r) * n + col, v, out_dtype);
      }
    }
  }
}

__global__ void sum_splits_kernel(const float* __restrict__ part, void* __restrict__ out,
                                  size_t count, int splits, int out_dtype) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < count;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < splits; ++s) v += part[static_cast<size_t>(s) * count + i];
    hqq_store(out, i, v, out_dtype);
  }
}

template <typename T, typename Meta>
int launch(const void* x, const void* wq, const void* scale, const void* zs, void* out,
           void* part, int m, int n, int kx, int k_pad, int g, int cb, int dtype, int splits,
           cudaStream_t s) {
  const int slabs = (k_pad + kBK - 1) / kBK;
  const int slabs_per_split = (slabs + splits - 1) / splits;
  dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM, splits);
  float* partial = splits > 1 ? static_cast<float*>(part) : nullptr;
  qmm_ax0_kernel<T, Meta><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const uint32_t*>(wq), static_cast<const Meta*>(scale),
      static_cast<const Meta*>(zs), dtype, out, partial, m, n, kx, k_pad, g, cb, slabs_per_split);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const size_t count = static_cast<size_t>(m) * n;
  const int blocks = static_cast<int>((count + 255) / 256 < 1024 ? (count + 255) / 256 : 1024);
  sum_splits_kernel<<<blocks, 256, 0, s>>>(partial, out, count, splits, dtype);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: HQQ_BF16 or HQQ_F16, the type of x and of y; meta_dtype: HQQ_F32 or
// HQQ_BF16, the type of scale and zs. splits >= 1 blocks share K; with
// splits > 1, part is fp32 scratch of splits*m*n elements.
HQQ_EXPORT int hqq_quant_matmul_ax0(const void* x, const void* wq, const void* scale,
                                    const void* zs, void* out, void* part, int m, int n, int kx,
                                    int k_pad, int group_size, int cb, int dtype, int meta_dtype,
                                    int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (splits < 1 || (splits > 1 && part == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
#define HQQ_AX0_LAUNCH(T, Meta) \
  return launch<T, Meta>(x, wq, scale, zs, out, part, m, n, kx, k_pad, group_size, cb, dtype, splits, s)
  if (dtype == HQQ_BF16 && meta_dtype == HQQ_F32) HQQ_AX0_LAUNCH(__nv_bfloat16, float);
  if (dtype == HQQ_BF16 && meta_dtype == HQQ_BF16) HQQ_AX0_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  if (dtype == HQQ_F16 && meta_dtype == HQQ_F32) HQQ_AX0_LAUNCH(__half, float);
  if (dtype == HQQ_F16 && meta_dtype == HQQ_BF16) HQQ_AX0_LAUNCH(__half, __nv_bfloat16);
#undef HQQ_AX0_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

HQQ_EXPORT const char* hqq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
