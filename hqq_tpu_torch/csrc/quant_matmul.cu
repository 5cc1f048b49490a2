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
// Design: a 64x64 output tile per block of 4 warps, K in slabs of 64. For
//   each slab the block copies x's 64x64 slab into shared memory in 16-byte
//   loads, dequantizes the weight's 64x64 slab from its packed words straight
//   into shared memory (the dequantized weight never reaches device memory),
//   and each warp runs a 2x2 grid of 16x16x16 wmma products on its 32x32
//   quarter. The accumulators go through shared memory to a bounds-checked
//   store. No cp.async pipeline, TMA or wgmma yet: that is the work of
//   making it fast.
#include <mma.h>

#include "hqq_common.cuh"

namespace {

using namespace nvcuda;

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 64;
constexpr int kLd = kBK + 8;   // padded row of a bf16/fp16 slab (16-byte multiple)
constexpr int kLdc = kBN + 4;  // padded row of the fp32 output tile
constexpr int kThreads = 128;

template <typename T>
__device__ __forceinline__ T to_t(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 to_t<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half to_t<__half>(float v) {
  return __float2half_rn(v);
}

struct SlabBuffers {
  alignas(32) unsigned char x[kBM * kLd * 2];
  alignas(32) unsigned char w[kBN * kLd * 2];
};
union alignas(32) Smem {
  SlabBuffers slabs;
  float c[kBM * kLdc];
};

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

  const int codes_per_word = 32 / cb;
  const int fields = 8 / cb;
  const uint32_t mask = ((1u << cb) - 1u) * 0x01010101u;
  const int row_words = k / codes_per_word;
  const int groups = k / group_size;
  const int slab_words = kBK / codes_per_word;  // weight words per slab row

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < k; k0 += kBK) {
    // x slab: 64 rows x 8 chunks of 8 elements (16 bytes); K % 8 == 0
    for (int idx = threadIdx.x; idx < kBM * (kBK / 8); idx += kThreads) {
      const int r = idx / (kBK / 8);
      const int c8 = (idx % (kBK / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < m && k0 + c8 < k) {
        v = *reinterpret_cast<const uint4*>(x + static_cast<size_t>(m0 + r) * k + k0 + c8);
      }
      *reinterpret_cast<uint4*>(xs + r * kLd + c8) = v;
    }
    // weight slab, dequantized: ws[nr][kk] = W[n0 + nr, k0 + kk]
    for (int idx = threadIdx.x; idx < kBN * slab_words; idx += kThreads) {
      const int nr = idx / slab_words;
      const int wj = idx % slab_words;
      const int col = n0 + nr;
      const int kk = k0 + wj * codes_per_word;
      T* dst = ws + nr * kLd + wj * codes_per_word;
      if (col < n && kk < k) {
        const uint32_t word = __ldg(wq + static_cast<size_t>(col) * row_words + kk / codes_per_word);
        const size_t gi = static_cast<size_t>(col) * groups + kk / group_size;
        const float s = scale[gi];
        const float z = zs[gi];
        for (int f = 0; f < fields; ++f) {
          const uint32_t q = (word >> (cb * f)) & mask;
#pragma unroll
          for (int b = 0; b < 4; ++b) dst[4 * f + b] = to_t<T>(hqq_dq((q >> (8 * b)) & 0xffu, s, z));
        }
      } else {
        for (int e = 0; e < codes_per_word; ++e) dst[e] = to_t<T>(0.f);
      }
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], xs + (wm + 16 * i) * kLd + kk, kLd);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], ws + (wn + 16 * j) * kLd + kk, kLd);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(smem.c + (wm + 16 * i) * kLdc + wn + 16 * j, acc[i][j], kLdc,
                              wmma::mem_row_major);
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
