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
//         int8 activations. K is whole words; g is a multiple of 8, so a
//         field never straddles a group (nor do the 8 codes of two
//         neighbouring fields 2j, 2j+1), but a word may: at 2-bit g8 and
//         1-bit g16 it spans 2 groups, at 1-bit g8 4, and each field takes
//         its own group's scale and zs.
//   scale [N, C], zs [N, C] with zs = zero*scale, so that
//         W[n, k] = code * scale - zs (the first K/g columns hold the
//         groups). fp32 with C = K/g, or bf16 with C = K/g padded to a
//         multiple of 8 (rows of whole 16 bytes, for TMA; `hqq_ax1_meta_cols`).
//         bf16 in the 4-bit container stores zs - 8*scale = (zero - 8)*scale
//         instead, as `hqq_tpu`'s 4-bit layout does: zero*scale is some 8
//         steps large and its bf16 rounding would cost a tenth of a step. The
//         kernels widen bf16 to fp32 as they read it and add 8*scale back
//         there (`hqq_ax1_zs_offset`), so they compute from fp32 values.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Output/operand type codes shared with the Python wrappers.
enum HqqDtype { HQQ_F32 = 0, HQQ_BF16 = 1, HQQ_F16 = 2 };

// the code of a C++ type
template <typename T>
__host__ __device__ constexpr int hqq_dtype_code();
template <>
__host__ __device__ constexpr int hqq_dtype_code<float>() { return HQQ_F32; }
template <>
__host__ __device__ constexpr int hqq_dtype_code<__nv_bfloat16>() { return HQQ_BF16; }
template <>
__host__ __device__ constexpr int hqq_dtype_code<__half>() { return HQQ_F16; }

// The columns C of an axis=1 layout's scale and zs for K/g groups
// (`to_kernel_layout` pads bf16 rows the same way).
__host__ __device__ inline int hqq_ax1_meta_cols(int groups, int meta_dtype) {
  return meta_dtype == HQQ_BF16 ? (groups + 7) / 8 * 8 : groups;
}

// The multiple of scale that an axis=1 layout's stored zs lacks: 8 for bf16
// meta in the 4-bit container, else 0.
__host__ __device__ inline float hqq_ax1_zs_offset(int cb, int meta_dtype) {
  return meta_dtype == HQQ_BF16 && cb == 4 ? 8.f : 0.f;
}

// a scale or zs widened to fp32 (bf16 by its bits: exact)
__device__ __forceinline__ float meta_f32(float v) { return v; }
__device__ __forceinline__ float meta_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Dequantize one code exactly as the plain torch version does: an fp32
// multiply, then an fp32 subtract (no fused multiply-add).
__device__ __forceinline__ float hqq_dq(uint32_t code, float s, float z) {
  return __fsub_rn(__fmul_rn(static_cast<float>(code), s), z);
}

// Four scales or zs of the axis=0 layout (fp32 or bf16) from index i (a
// multiple of 4, the base 16-byte aligned) in one load; bf16 widens to fp32
// by its bits.
__device__ __forceinline__ void meta4_f32(const float* p, size_t i, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p + i);
  v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
}
__device__ __forceinline__ void meta4_f32(const __nv_bfloat16* p, size_t i, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p + i);
  v[0] = __uint_as_float(t.x << 16), v[1] = __uint_as_float(t.x & 0xffff0000u);
  v[2] = __uint_as_float(t.y << 16), v[3] = __uint_as_float(t.y & 0xffff0000u);
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

// Four outputs from index i (a multiple of 4, the base 16-byte aligned) in
// one store, each rounded as hqq_store rounds it.
__device__ __forceinline__ void hqq_store4(void* out, size_t i, const float (&v)[4], int dtype) {
  if (dtype == HQQ_BF16) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(reinterpret_cast<__nv_bfloat16*>(out) + i) = make_uint2(
        *reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
  } else if (dtype == HQQ_F16) {
    const __half2 lo = __floats2half2_rn(v[0], v[1]);
    const __half2 hi = __floats2half2_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(reinterpret_cast<__half*>(out) + i) = make_uint2(
        *reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
  } else {
    *reinterpret_cast<float4*>(reinterpret_cast<float*>(out) + i) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

#define HQQ_EXPORT extern "C" __attribute__((visibility("default")))
