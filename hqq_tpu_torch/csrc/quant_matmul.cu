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
//   M the weight bytes bound it instead.
// Design: the 64x64 tile of qmm_tile.cuh: per K slab of 64 the block loads
//   x's slab, dequantizes the weight's slab into shared memory and runs wmma
//   products with fp32 accumulators; a bounds-checked store at the end.
#include "qmm_tile.cuh"

namespace {

using namespace qmm;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    qmm_kernel(const T* __restrict__ x, const uint32_t* __restrict__ wq,
               const float* __restrict__ scale, const float* __restrict__ zs, int out_dtype,
               void* __restrict__ out, int m, int n, int k, int group_size, int cb) {
  __shared__ Smem smem;
  T* xs = reinterpret_cast<T*>(smem.slabs.x);
  T* ws = reinterpret_cast<T*>(smem.slabs.w);

  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32;  // warp's rows within the tile
  const int wn = (warp & 1) * 32;   // warp's columns within the tile

  const WordLayout layout = word_layout(k, cb);
  const int groups = k / group_size;

  Acc acc[2][2];
  zero_acc(acc);
  for (int k0 = 0; k0 < k; k0 += kBK) {
    load_x_slab(xs, x, m0, k0, m, k);
    dequant_slab(ws, wq, scale, zs, n0, k0, n, k, group_size, groups, layout);
    __syncthreads();
    mma_slab(acc, xs, ws, wm, wn);
    __syncthreads();
  }

  stage_acc(smem.c, acc, wm, wn);
  __syncthreads();
  for (int idx = threadIdx.x; idx < kBM * kBN; idx += kThreads) {
    const int r = idx / kBN;
    const int c = idx % kBN;
    if (m0 + r < m && n0 + c < n) {
      hqq_store(out, static_cast<size_t>(m0 + r) * n + n0 + c, smem.c[r * kLdc + c], out_dtype);
    }
  }
}

}  // namespace

// dtype: HQQ_BF16 or HQQ_F16, the type of x and of y
HQQ_EXPORT int hqq_quant_matmul(const void* x, const void* wq, const void* scale, const void* zs,
                                void* out, int m, int n, int k, int group_size, int cb, int dtype,
                                void* stream) {
  dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == HQQ_BF16) {
    qmm_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const uint32_t*>(wq),
        static_cast<const float*>(scale), static_cast<const float*>(zs), dtype, out, m, n, k,
        group_size, cb);
  } else if (dtype == HQQ_F16) {
    qmm_kernel<__half><<<grid, kThreads, 0, s>>>(
        static_cast<const __half*>(x), static_cast<const uint32_t*>(wq),
        static_cast<const float*>(scale), static_cast<const float*>(zs), dtype, out, m, n, k,
        group_size, cb);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

HQQ_EXPORT const char* hqq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
