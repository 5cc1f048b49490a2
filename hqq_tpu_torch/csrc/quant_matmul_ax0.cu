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
// Design: the Hopper mainloop of qmm_sm90.cuh over its axis=0 layout
//   (`Ax0Layout<Meta>`, shared with qmm_fp32.cu): a tile's 128 rows are 8
//   consecutive b by 16 consecutive a of n = a*P + b (16 b by 8 a at g = 8),
//   for every g, so a slab reads 8 rows of scale and zs (4 KB with fp32
//   meta), the codes come by one TMA box of the [g, P, row] view of wq, and
//   a warpgroup's 64 rows are 8 runs of 8 consecutive columns of y. Each
//   consumer thread dequantizes 8 codes of 4 rows that share one b, reading
//   their 8 scales and 8 zs from shared memory once; the epilogue stores
//   each run of 8 columns of a token as one 16-byte store (32 bytes for the
//   fp32 partials) where P % 8 == 0. A tile of 128/g whole groups (rows
//   p = b*g + a) would put a warpgroup's 64 columns P apart at g >= 64:
//   every bf16 of y its own 32-byte sector, and each thread would read its
//   16 meta values four times. At decode sizes K is split over
//   gridDim.z (the launch plan of ops/fused_matmul.py): each split writes
//   an fp32 partial, and `qmm_sum_splits` adds them in order.
#include "qmm_sm90.cuh"

namespace {

template <typename T, typename Meta>
int launch(const void* x, const void* wq, const void* scale, const void* zs, void* out,
           void* part, int m, int n, int kx, int k_pad, int g, int cb, int dtype,
           int token_tile, int stages, int splits, int slabs_per_split, int smem,
           cudaStream_t s) {
  sm90::Params p{};
  sm90::WeightMaps w{};
  if (sm90::ax0_params<Meta>(p, w, wq, scale, zs, n, k_pad, g, cb) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  p.out = out;
  p.part = splits > 1 ? static_cast<float*>(part) : nullptr;
  p.m = m;
  p.slabs_per_split = slabs_per_split;
  p.stages = stages;
  p.out_dtype = dtype;
  return sm90::launch<T, sm90::Ax0Layout<Meta>>(x, kx, p, w, token_tile, splits, smem, s);
}

}  // namespace

// dtype: HQQ_BF16 or HQQ_F16, the type of x and of y; meta_dtype: HQQ_F32 or
// HQQ_BF16, the type of scale and zs. token_tile, stages, splits,
// slabs_per_split and smem come from the launch plan (`qmm_launch_plan`);
// with splits > 1, part is fp32 scratch of splits*m*n elements.
HQQ_EXPORT int hqq_quant_matmul_ax0(const void* x, const void* wq, const void* scale,
                                    const void* zs, void* out, void* part, int m, int n, int kx,
                                    int k_pad, int group_size, int cb, int dtype, int meta_dtype,
                                    int token_tile, int stages, int splits, int slabs_per_split,
                                    int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HQQ_AX0_LAUNCH(T, Meta)                                                                \
  return launch<T, Meta>(x, wq, scale, zs, out, part, m, n, kx, k_pad, group_size, cb, dtype, \
                         token_tile, stages, splits, slabs_per_split, smem, s)
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
