// SPDX-License-Identifier: Apache-2.0
// Shared pieces of the Hopper kernels of hqq_tpu_torch.
//
// Kernel layout of a quantized weight W [N, K] (built by
// `hqq_tpu_torch.ops.fused_matmul.to_kernel_layout`):
//   wq    uint8 [N, K*cb/8], codes of row n contiguous along K, read as
//         little-endian 32-bit words. Word w of a row holds the C = 32/cb
//         codes k = w*C + 4*f + b (f = 0..8/cb-1 the field, b = 0..3 the
//         byte): code k sits at bits [8*b + cb*f, 8*b + cb*f + cb).
//         So (word >> (cb*f)) & (mask * 0x01010101) yields the four codes
//         4f..4f+3 as four bytes in k order, ready for __dp4a against four
//         int8 activations, and a word never straddles a group (the layout
//         requires g % C == 0).
//   scale fp32 [N, K/g], zs fp32 [N, K/g] with zs = zero*scale, so that
//         W[n, k] = code * scale - zs.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Output/operand type codes shared with the Python wrappers.
enum HqqDtype { HQQ_F32 = 0, HQQ_BF16 = 1, HQQ_F16 = 2 };

// Dequantize one code exactly as the plain torch version does: an fp32
// multiply, then an fp32 subtract (no fused multiply-add).
__device__ __forceinline__ float hqq_dq(uint32_t code, float s, float z) {
  return __fsub_rn(__fmul_rn(static_cast<float>(code), s), z);
}

__device__ __forceinline__ void hqq_store(void* out, size_t i, float v, int dtype) {
  if (dtype == HQQ_BF16) {
    reinterpret_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
  } else if (dtype == HQQ_F16) {
    reinterpret_cast<__half*>(out)[i] = __float2half_rn(v);
  } else {
    reinterpret_cast<float*>(out)[i] = v;
  }
}

#define HQQ_EXPORT extern "C" __attribute__((visibility("default")))
