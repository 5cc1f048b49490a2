// SPDX-License-Identifier: Apache-2.0
// dequant: W[n, k] = code * scale - zs, from the kernel layout of
// hqq_common.cuh to a dense [N, K] matrix in fp32, bf16 or fp16.
//
// Replaces: hqq_tpu/ops/fused_matmul.py `_dq_kernel` (launched by `_dq_call`,
//   entry `dequant_pallas`), which writes W^T [K, N] tile by tile.
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

__global__ void hqq_dequant_kernel(const uint32_t* __restrict__ wq,
                                   const float* __restrict__ scale,
                                   const float* __restrict__ zs, void* __restrict__ out,
                                   int n, int k, int group_size, int cb, int out_dtype) {
  const int codes_per_word = 32 / cb;
  const int fields = 8 / cb;
  const uint32_t mask = ((1u << cb) - 1u) * 0x01010101u;
  const int row_words = k / codes_per_word;
  const int groups = k / group_size;
  const size_t total = static_cast<size_t>(n) * row_words;
  for (size_t idx = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; idx < total;
       idx += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int row = static_cast<int>(idx / row_words);
    const int w = static_cast<int>(idx % row_words);
    const int k0 = w * codes_per_word;
    const size_t g = static_cast<size_t>(row) * groups + k0 / group_size;
    const float s = scale[g];
    const float z = zs[g];
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

HQQ_EXPORT int hqq_dequant(const void* wq, const void* scale, const void* zs, void* out, int n,
                           int k, int group_size, int cb, int out_dtype, void* stream) {
  const size_t total = static_cast<size_t>(n) * (k / (32 / cb));
  const int threads = 256;
  const size_t want = (total + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 132 * 64 ? want : 132 * 64);
  hqq_dequant_kernel<<<blocks > 0 ? blocks : 1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(wq), static_cast<const float*>(scale),
      static_cast<const float*>(zs), out, n, k, group_size, cb, out_dtype);
  return static_cast<int>(cudaGetLastError());
}

HQQ_EXPORT const char* hqq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
