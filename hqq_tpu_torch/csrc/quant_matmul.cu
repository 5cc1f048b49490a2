// SPDX-License-Identifier: Apache-2.0
// quant_matmul: y[M, N] = x[M, K] @ W^T with W[n, k] = code * scale - zs,
// dequantized in fp32 and rounded to x's type (bf16 or fp16), multiplied on
// the tensor cores with an fp32 accumulator; y in x's type. Any M.
//
// Replaces: hqq_tpu/ops/fused_matmul.py `_qmm_kernel` (launched by
//   `_qmm_call`, entry `quant_matmul_pallas`): the `pallas` backend, the
//   M > 32 (prefill) route of `quant_matmul_pallas_a8`, and 8-bit weights.
// Bound on H100: operations at prefill. M=512, K=N=4096 is 17.2 GFLOP,
//   17.4 us at 989 TFLOP/s bf16, against 11 MB of bytes (3.3 us). At small
//   M the weight bytes bound it instead (M=4, K=N=4096: 10.5 MB, 3.1 us).
// Design: the Hopper mainloop of qmm_sm90.cuh (TMA for x, cp.async for the
//   codes and meta, an mbarrier ring, wgmma on the dequantized slab with
//   the tokens as wgmma's N, dequantization of one slab overlapping the
//   products of the previous one) over its axis=1 layout (`Ax1Layout<Meta>`,
//   shared with quant_matmul_lora.cu; scale and zs in fp32 or bf16): a slab row holds 64/g groups (or a
//   part of one), one scale and zs per 8-code chunk. At decode sizes K is
//   split over gridDim.z (the launch plan of ops/fused_matmul.py).
#include "qmm_sm90.cuh"

// dtype: HQQ_BF16 or HQQ_F16, the type of x and of y; meta_dtype: HQQ_F32
// or HQQ_BF16, the type of scale and zs. token_tile, stages, splits,
// slabs_per_split and smem come from the launch plan (`qmm_launch_plan`);
// with splits > 1, part is fp32 scratch of splits*m*n.
HQQ_EXPORT int hqq_quant_matmul(const void* x, const void* wq, const void* scale, const void* zs,
                                void* out, void* part, int m, int n, int k, int group_size, int cb,
                                int dtype, int meta_dtype, int token_tile, int stages, int splits,
                                int slabs_per_split, int smem, void* stream) {
  sm90::Params p{};
  sm90::WeightMaps w{};
  const int e = meta_dtype == HQQ_F32
                    ? sm90::ax1_params<float>(p, w, wq, scale, zs, n, k, group_size, cb)
                : meta_dtype == HQQ_BF16
                    ? sm90::ax1_params<__nv_bfloat16>(p, w, wq, scale, zs, n, k, group_size, cb)
                    : 1;
  if (e != 0) return static_cast<int>(cudaErrorInvalidValue);
  p.out = out;
  p.part = splits > 1 ? static_cast<float*>(part) : nullptr;
  p.m = m;
  p.slabs_per_split = slabs_per_split;
  p.stages = stages;
  p.out_dtype = dtype;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HQQ_QMM_LAUNCH(T, Meta) \
  return sm90::launch<T, sm90::Ax1Layout<Meta>>(x, k, p, w, token_tile, splits, smem, s)
  if (dtype == HQQ_BF16 && meta_dtype == HQQ_F32) HQQ_QMM_LAUNCH(__nv_bfloat16, float);
  if (dtype == HQQ_BF16 && meta_dtype == HQQ_BF16) HQQ_QMM_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  if (dtype == HQQ_F16 && meta_dtype == HQQ_F32) HQQ_QMM_LAUNCH(__half, float);
  if (dtype == HQQ_F16 && meta_dtype == HQQ_BF16) HQQ_QMM_LAUNCH(__half, __nv_bfloat16);
#undef HQQ_QMM_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

HQQ_EXPORT const char* hqq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
