// SPDX-License-Identifier: Apache-2.0
// The 64x64 output tile of quant_matmul_lora.cu, its only user (and
// flash_prefill.cu borrows its to_t): quant_matmul and quant_matmul_ax0
// moved to the Hopper mainloop of qmm_sm90.cuh, and quant_matmul_lora moves
// there next.
//
// A block of 4 warps owns a 64x64 tile of y = x @ W^T and walks K in slabs
// of 64. For each slab it copies x's 64x64 slab into shared memory in
// 16-byte loads, a kernel-specific routine dequantizes the weight's 64x64
// slab from its packed words straight into shared memory (the dequantized
// weight never reaches device memory), and each warp runs a 2x2 grid of
// 16x16x16 wmma products on its 32x32 quarter, fp32 accumulators. The
// accumulators go through shared memory to the kernel's own bounds-checked
// store. No cp.async pipeline, TMA or wgmma: slab loads, dequantization and
// products run one after the other.
#pragma once

#include <mma.h>

#include "hqq_common.cuh"

namespace qmm {

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
// the slabs while K is walked, then the fp32 output tile
union alignas(32) Smem {
  SlabBuffers slabs;
  float c[kBM * kLdc];
};

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ void zero_acc(Acc (&acc)[2][2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
}

// x slab: 64 rows x 8 chunks of 8 elements (16 bytes); needs K % 8 == 0.
// Rows past m and chunks past k are zero.
template <typename T>
__device__ __forceinline__ void load_x_slab(T* xs, const T* __restrict__ x, int m0, int k0,
                                            int m, int k) {
  for (int idx = threadIdx.x; idx < kBM * (kBK / 8); idx += kThreads) {
    const int r = idx / (kBK / 8);
    const int c8 = (idx % (kBK / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + r < m && k0 + c8 < k) {
      v = *reinterpret_cast<const uint4*>(x + static_cast<size_t>(m0 + r) * k + k0 + c8);
    }
    *reinterpret_cast<uint4*>(xs + r * kLd + c8) = v;
  }
}

// What a thread needs of the word layout (hqq_common.cuh) to walk a packed
// row: computed once per launch, outside the K loop (the divisions are by
// run-time values).
struct WordLayout {
  int cb;
  int codes_per_word;
  int fields;
  uint32_t mask;
  int row_words;   // 32-bit words per packed row
  int slab_words;  // of them per 64-wide K slab
};

__device__ __forceinline__ WordLayout word_layout(int k, int cb) {
  WordLayout l;
  l.cb = cb;
  l.codes_per_word = 32 / cb;
  l.fields = 8 / cb;
  l.mask = ((1u << cb) - 1u) * 0x01010101u;
  l.row_words = k / l.codes_per_word;
  l.slab_words = kBK / l.codes_per_word;
  return l;
}

// Weight slab of the axis=1 kernel layout (hqq_common.cuh), dequantized:
// ws[nr][kk] = W[n0 + nr, k0 + kk]; one scale and zs per 32-bit word.
// groups = k / group_size.
template <typename T>
__device__ __forceinline__ void dequant_slab(T* ws, const uint32_t* __restrict__ wq,
                                             const float* __restrict__ scale,
                                             const float* __restrict__ zs, int n0, int k0, int n,
                                             int k, int group_size, int groups,
                                             const WordLayout& l) {
  for (int idx = threadIdx.x; idx < kBN * l.slab_words; idx += kThreads) {
    const int nr = idx / l.slab_words;
    const int wj = idx % l.slab_words;
    const int col = n0 + nr;
    const int kk = k0 + wj * l.codes_per_word;
    T* dst = ws + nr * kLd + wj * l.codes_per_word;
    if (col < n && kk < k) {
      const uint32_t word =
          __ldg(wq + static_cast<size_t>(col) * l.row_words + kk / l.codes_per_word);
      const size_t gi = static_cast<size_t>(col) * groups + kk / group_size;
      const float s = scale[gi];
      const float z = zs[gi];
      for (int f = 0; f < l.fields; ++f) {
        const uint32_t q = (word >> (l.cb * f)) & l.mask;
#pragma unroll
        for (int b = 0; b < 4; ++b) dst[4 * f + b] = to_t<T>(hqq_dq((q >> (8 * b)) & 0xffu, s, z));
      }
    } else {
      for (int e = 0; e < l.codes_per_word; ++e) dst[e] = to_t<T>(0.f);
    }
  }
}

// acc += xs[64 x 64] @ ws[64 x 64]^T on the calling warp's 32x32 quarter
// (rows wm.., columns wn..).
template <typename T>
__device__ __forceinline__ void mma_slab(Acc (&acc)[2][2], const T* xs, const T* ws, int wm,
                                         int wn) {
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
}

// The warp's accumulators into the fp32 tile c[64][kLdc]; the slabs must be
// done with (c overlays them).
__device__ __forceinline__ void stage_acc(float* c, const Acc (&acc)[2][2], int wm, int wn) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(c + (wm + 16 * i) * kLdc + wn + 16 * j, acc[i][j], kLdc,
                              wmma::mem_row_major);
}

}  // namespace qmm
