// SPDX-License-Identifier: Apache-2.0
// dequant: W[n, k] = code * scale - zs, from the kernel layout of
// hqq_common.cuh (scale and zs fp32 or bf16, widened to fp32) to a dense
// [N, K] matrix in fp32, bf16 or fp16. A second
// entry does the same for the axis=0 layout of quant_matmul_ax0.cu, where
// row n reads scale and zs [P, K_pad] (fp32 or bf16) at (n % P, k).
//
// Replaces: hqq_tpu/ops/fused_matmul.py `_dq_kernel` (launched by `_dq_call`,
//   entry `dequant_pallas`), which writes W^T [K, N] tile by tile, and its
//   use on the permuted axis=0 layout by `_dequant_pallas_ax0`.
// Bound on H100: bytes. It reads K*N*cb/8 bytes of codes and 8*N*K/g bytes of
//   scale and zs, and writes N*K*sizeof(out); at 4096x11008 to bf16 that is
//   28.2 MB in and 90 MB out, 35 us at 3.35 TB/s. It does one multiply and
//   one subtract per element, far below the compute rate.
// Design: one thread per 32-bit word of codes. A word never straddles a
//   group, so a thread loads one scale and one zs and writes the word's
//   32/cb outputs as contiguous elements; neighbouring threads read
//   neighbouring words and write neighbouring runs, so both streams are
//   coalesced. A grid-stride loop covers any size.
#include "hqq_common.cuh"

template <typename Meta>
__global__ void hqq_dequant_kernel(const uint32_t* __restrict__ wq,
                                   const Meta* __restrict__ scale,
                                   const Meta* __restrict__ zs, void* __restrict__ out,
                                   int n, int k, int group_size, int cb, int out_dtype,
                                   int meta_cols, float zadd) {
  const int codes_per_word = 32 / cb;
  const int fields = 8 / cb;
  const uint32_t mask = ((1u << cb) - 1u) * 0x01010101u;
  const int row_words = k / codes_per_word;
  const size_t total = static_cast<size_t>(n) * row_words;
  for (size_t idx = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; idx < total;
       idx += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int row = static_cast<int>(idx / row_words);
    const int w = static_cast<int>(idx % row_words);
    const int k0 = w * codes_per_word;
    const size_t g = static_cast<size_t>(row) * meta_cols + k0 / group_size;
    const float s = meta_f32(scale[g]);
    const float z = meta_f32(zs[g]) + zadd * s;
    const uint32_t word = wq[idx];
    const size_t base = static_cast<size_t>(row) * k + k0;
    for (int f = 0; f < fields; ++f) {
      const uint32_t q = (word >> (cb * f)) & mask;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        hqq_store(out, base + 4 * f + b, hqq_dq((q >> (8 * b)) & 0xffu, s, z), out_dtype);
      }
    }
  }
}

// axis=0 layout: a code has its own scale and zs, so the unit is four codes
// (one byte lane of a field), not a word: thread idx takes quad idx of the
// K_pad-long rows, reads its four scale and four zs values in one load each
// and writes its four outputs in one store, and neighbouring threads read
// and write neighbouring runs. The threads of a word load the same word.
// Codes past K are padding and are not written; a quad that K cuts, or rows
// that K % 4 != 0 leaves unaligned, go element by element.
template <typename Meta>
__global__ void hqq_dequant_ax0_kernel(const uint32_t* __restrict__ wq,
                                       const Meta* __restrict__ scale,
                                       const Meta* __restrict__ zs, void* __restrict__ out, int n,
                                       int k, int k_pad, int group_size, int cb, int out_dtype) {
  const int fields = 8 / cb;
  const uint32_t mask = ((1u << cb) - 1u) * 0x01010101u;
  const int row_quads = k_pad / 4;
  const int pblocks = n / group_size;
  const bool aligned = k % 4 == 0;
  const size_t total = static_cast<size_t>(n) * row_quads;
  for (size_t idx = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; idx < total;
       idx += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int row = static_cast<int>(idx / row_quads);
    const int quad = static_cast<int>(idx % row_quads);
    const int k0 = quad * 4;
    if (k0 >= k) continue;
    const uint32_t word = wq[idx / fields];  // row_quads = fields * words per row
    const uint32_t q = (word >> (cb * (quad % fields))) & mask;
    const size_t mi = static_cast<size_t>(row % pblocks) * k_pad + k0;
    const size_t base = static_cast<size_t>(row) * k + k0;
    float s[4], z[4], v[4];
    meta4_f32(scale, mi, s);
    meta4_f32(zs, mi, z);
#pragma unroll
    for (int b = 0; b < 4; ++b) v[b] = hqq_dq((q >> (8 * b)) & 0xffu, s[b], z[b]);
    if (aligned && k0 + 4 <= k) {
      hqq_store4(out, base, v, out_dtype);
    } else {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (k0 + b < k) hqq_store(out, base + b, v[b], out_dtype);
      }
    }
  }
}

static int grid_for(size_t total, int threads) {
  const size_t want = (total + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 132 * 64 ? want : 132 * 64);
  return blocks > 0 ? blocks : 1;
}

// meta_dtype: HQQ_F32 or HQQ_BF16, the type of scale and zs [N/g, K_pad];
// scale, zs and out 16-byte aligned
HQQ_EXPORT int hqq_dequant_ax0(const void* wq, const void* scale, const void* zs, void* out,
                               int n, int k, int k_pad, int group_size, int cb, int out_dtype,
                               int meta_dtype, void* stream) {
  const size_t total = static_cast<size_t>(n) * (k_pad / 4);
  const int threads = 256;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (meta_dtype == HQQ_F32) {
    hqq_dequant_ax0_kernel<float><<<grid_for(total, threads), threads, 0, s>>>(
        static_cast<const uint32_t*>(wq), static_cast<const float*>(scale),
        static_cast<const float*>(zs), out, n, k, k_pad, group_size, cb, out_dtype);
  } else if (meta_dtype == HQQ_BF16) {
    hqq_dequant_ax0_kernel<__nv_bfloat16><<<grid_for(total, threads), threads, 0, s>>>(
        static_cast<const uint32_t*>(wq), static_cast<const __nv_bfloat16*>(scale),
        static_cast<const __nv_bfloat16*>(zs), out, n, k, k_pad, group_size, cb, out_dtype);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// meta_dtype: HQQ_F32 or HQQ_BF16, the type of scale and zs [N, C]
// (`hqq_ax1_meta_cols`)
HQQ_EXPORT int hqq_dequant(const void* wq, const void* scale, const void* zs, void* out, int n,
                           int k, int group_size, int cb, int out_dtype, int meta_dtype,
                           void* stream) {
  const size_t total = static_cast<size_t>(n) * (k / (32 / cb));
  const int threads = 256;
  const int cols = hqq_ax1_meta_cols(k / group_size, meta_dtype);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (meta_dtype == HQQ_F32) {
    hqq_dequant_kernel<float><<<grid_for(total, threads), threads, 0, s>>>(
        static_cast<const uint32_t*>(wq), static_cast<const float*>(scale),
        static_cast<const float*>(zs), out, n, k, group_size, cb, out_dtype, cols, 0.f);
  } else if (meta_dtype == HQQ_BF16) {
    hqq_dequant_kernel<__nv_bfloat16><<<grid_for(total, threads), threads, 0, s>>>(
        static_cast<const uint32_t*>(wq), static_cast<const __nv_bfloat16*>(scale),
        static_cast<const __nv_bfloat16*>(zs), out, n, k, group_size, cb, out_dtype, cols,
        hqq_ax1_zs_offset(cb, HQQ_BF16));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

HQQ_EXPORT const char* hqq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
