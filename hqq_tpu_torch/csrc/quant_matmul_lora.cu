// SPDX-License-Identifier: Apache-2.0
// quant_matmul_lora: y[M, N] = x @ W^T + (x @ A) @ B in one kernel, with
// W[n, k] = code * scale - zs in the axis=1 kernel layout of hqq_common.cuh
// (scale and zs in fp32 or bf16),
// A [K, r] rounded to x's type (bf16 or fp16) and B [r, N] in fp32 (the
// adapter's scaling folded into B). W is dequantized in fp32 and rounded to
// x's type; both products run on the tensor cores with fp32 accumulators.
// The rank-r partial p = x @ A stays in fp32 and B is applied in fp32 after
// the walk over K; y in x's type, rounded once. Any M, any r >= 1.
//
// Replaces: hqq_tpu/ops/fused_matmul.py `_qmm_lora_kernel` (launched by
//   `_qmm_lora_call`, entry `quant_matmul_pallas_lora`): HQQ+ serving under
//   the `pallas` backend, and the M > 32 (prefill) and 8-bit routes of
//   `quant_matmul_pallas_a8_lora`.
// Bound on H100: operations at prefill, as quant_matmul: 2*M*N*K for the
//   base plus 2*M*K*r + 2*M*r*N for the adapter (0.4% more at r = 8,
//   K = N = 4096). A and B add 2*r*K + 4*r*N bytes.
// Design: the Hopper mainloop of qmm_sm90.cuh with its axis=1 layout, as
//   quant_matmul, and the adapter riding the same pipeline, in chunks of RP
//   ranks (16 for r <= 16, else 64). The wrapper hands A over as A^T
//   [passes*RP, K] in x's type, K-major, the rank padded with zeros (built
//   once per adapter and kept beside it). Each slot of the ring also brings
//   A^T's [RP x 64] slab by TMA in x's swizzle, and a consumer multiplies 64
//   token rows of x's slab, already in shared memory, by it: wgmma
//   m64nRPk16 with x as the A side,
//   RP/2 more fp32 accumulators a thread (the token tile is capped at 128,
//   so no consumer holds more than 64 + 32). After the walk over K, p goes
//   to shared memory and each consumer adds sum_j p[m, j] * B[j, n] in fp32
//   to its accumulators before the one rounding to y's type. A rank above
//   RP walks K again for each further chunk, loading x and A^T alone. Where
//   K is split over blocks (M <= 32), each split applies B to its own fp32
//   partial of p: (x @ A) @ B is linear in x's K slices.
#include "qmm_sm90.cuh"

// dtype: HQQ_BF16 or HQQ_F16, the type of x, of at and of y; meta_dtype:
// HQQ_F32 or HQQ_BF16, the type of scale and zs; at: A^T
// [passes * rank_tile, k], zero past the rank; lb: B fp32 [r, N]. The
// launch fields come from `qmm_launch_plan(..., rank=r)`.
HQQ_EXPORT int hqq_quant_matmul_lora(const void* x, const void* wq, const void* scale,
                                     const void* zs, const void* at, const void* lb, void* out,
                                     void* part, int m, int n, int k, int r, int group_size,
                                     int cb, int dtype, int meta_dtype, int token_tile,
                                     int rank_tile, int passes, int stages, int splits,
                                     int slabs_per_split, int smem, void* stream) {
  sm90::Params p{};
  sm90::WeightMaps w{};
  const int e = meta_dtype == HQQ_F32
                    ? sm90::ax1_params<float>(p, w, wq, scale, zs, n, k, group_size, cb)
                : meta_dtype == HQQ_BF16
                    ? sm90::ax1_params<__nv_bfloat16>(p, w, wq, scale, zs, n, k, group_size, cb)
                    : 1;
  if (r < 1 || k % 8 != 0 || e != 0) return static_cast<int>(cudaErrorInvalidValue);
  p.out = out;
  p.part = splits > 1 ? static_cast<float*>(part) : nullptr;
  p.m = m;
  p.slabs_per_split = slabs_per_split;
  p.stages = stages;
  p.out_dtype = dtype;
  p.lb = static_cast<const float*>(lb);
  p.rank = r, p.passes = passes;
  // A^T as boxes of [rank_tile x 64] in the 128-byte swizzle (x's slab's)
  const long dims[2] = {k, 1L * passes * rank_tile}, strides[1] = {2L * k};
  const int box[2] = {sm90::kBK, rank_tile};
  if (sm90::encode_map(&w.lora_a,
                       dtype == HQQ_BF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                         : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
                       2, at, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HQQ_LORA_LAUNCH(T, Meta, RP) \
  sm90::launch<T, sm90::Ax1Layout<Meta>, RP>(x, k, p, w, token_tile, splits, smem, s)
#define HQQ_LORA_RANKS(T, Meta)                                     \
  if (dtype == hqq_dtype_code<T>() && meta_dtype == hqq_dtype_code<Meta>()) { \
    if (rank_tile == 16) return HQQ_LORA_LAUNCH(T, Meta, 16);       \
    if (rank_tile == 64) return HQQ_LORA_LAUNCH(T, Meta, 64);       \
  }
  HQQ_LORA_RANKS(__nv_bfloat16, float)
  HQQ_LORA_RANKS(__nv_bfloat16, __nv_bfloat16)
  HQQ_LORA_RANKS(__half, float)
  HQQ_LORA_RANKS(__half, __nv_bfloat16)
#undef HQQ_LORA_RANKS
#undef HQQ_LORA_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

HQQ_EXPORT const char* hqq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
