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
//   products of the previous one). This file keeps the axis=1 layout: a
//   slab row holds 64/g groups (or a part of one), one scale and zs per
//   8-code chunk. At decode sizes K is split over gridDim.z (the launch
//   plan of ops/fused_matmul.py).
#include "qmm_sm90.cuh"

namespace {

using sm90::Params;

// kernel layout of hqq_common.cuh: wq [N, K*cb/8], scale and zs fp32 [N, K/g]
struct Ax1Layout {
  static constexpr bool kContiguous = true;

  // smem row of tile row pr's codes
  static __device__ __forceinline__ int code_row(const Params&, int pr) { return pr; }

  // TMA coordinates of a slab: codes {byte, row, 0}, scale and zs {group, row}
  static __device__ __forceinline__ void code_coords(const Params& p, int p0, int k0, int (&c)[3]) {
    c[0] = k0 / 8 * p.cb, c[1] = p0, c[2] = 0;
  }
  static __device__ __forceinline__ void meta_coords(const Params& p, int p0, int k0, int (&c)[2]) {
    c[0] = meta_base(p, k0), c[1] = p0;
  }

  static __device__ __forceinline__ int group_of(const Params& p, int k) {
    return p.group_log2 >= 0 ? k >> p.group_log2 : k / p.group_size;
  }
  // the first group a slot holds: the slab's own where a slab can touch
  // groups from any start, else aligned to the slot (16-byte TMA and
  // cp.async addresses)
  static __device__ __forceinline__ int meta_base(const Params& p, int k0) {
    const int g0 = group_of(p, k0);
    return p.meta_shift ? g0 : g0 & ~(p.slab_groups - 1);
  }

  // what the TMA does not load, by cp.async (zero-filled past the tensor)
  static __device__ __forceinline__ void load_slab(const Params& p, int p0, int k0,
                                                   uint32_t codes, uint32_t meta, int tid) {
    if (!p.codes_tma) {
      const int slab_bytes = 8 * p.cb;
      const int per_row = slab_bytes / p.code_vec;
      const int c0 = k0 / 8 * p.cb;  // the slab's byte offset within a row
      for (int idx = tid; idx < sm90::kBN * per_row; idx += 128) {
        const int r = idx / per_row, off = c0 + (idx % per_row) * p.code_vec;
        const bool ok = p0 + r < p.n && off < p.row_bytes;
        const uint8_t* src = ok ? p.wq + static_cast<size_t>(p0 + r) * p.row_bytes + off : p.wq;
        sm90::cp_async(codes + r * slab_bytes + (idx % per_row) * p.code_vec, src, p.code_vec,
                       ok);
      }
    }
    if (!p.meta_tma) {
      const int groups = p.slab_groups;
      const int g0 = meta_base(p, k0);
      const int per_row = groups * 4 / p.meta_vec;
      for (int idx = tid; idx < 2 * sm90::kBN * per_row; idx += 128) {
        const int a = idx / (sm90::kBN * per_row);  // 0: scale, 1: zs
        const int rem = idx % (sm90::kBN * per_row);
        const int r = rem / per_row, off = g0 * 4 + (rem % per_row) * p.meta_vec;
        const uint8_t* base = static_cast<const uint8_t*>(a == 0 ? p.scale : p.zs);
        const bool ok = p0 + r < p.n && off < p.meta_cols * 4;
        const uint8_t* src =
            ok ? base + static_cast<size_t>(p0 + r) * p.meta_cols * 4 + off : base;
        sm90::cp_async(meta + (a * sm90::kBN + r) * groups * 4 + (rem % per_row) * p.meta_vec,
                       src, p.meta_vec, ok);
      }
    }
  }

  // float index of tile row pr's scales in a slot, and of chunk q's group
  // (codes 8q..8q+7 lie in one group) among the slot's groups
  static __device__ __forceinline__ int meta_offset(const Params& p, int, int pr, int) {
    return pr * p.slab_groups;
  }
  static __device__ __forceinline__ int meta_add(const Params& p, int k0, int q) {
    return group_of(p, k0 + 8 * q) - meta_base(p, k0);
  }
  static __device__ __forceinline__ int zs_offset(const Params& p) {
    return sm90::kBN * p.slab_groups;
  }
  static __device__ __forceinline__ void meta8(const uint8_t* meta, int off, int zs_off,
                                               float (&s)[8], float (&z)[8]) {
    const float* m = reinterpret_cast<const float*>(meta);
    const float sv = m[off], zv = m[zs_off + off];
#pragma unroll
    for (int e = 0; e < 8; ++e) s[e] = sv, z[e] = zv;
  }

  static __device__ __forceinline__ int column(const Params&, int pr) { return pr; }
};

}  // namespace

// dtype: HQQ_BF16 or HQQ_F16, the type of x and of y. token_tile, stages,
// splits, slabs_per_split and smem come from the launch plan
// (`qmm_launch_plan`); with splits > 1, part is fp32 scratch of splits*m*n.
HQQ_EXPORT int hqq_quant_matmul(const void* x, const void* wq, const void* scale, const void* zs,
                                void* out, void* part, int m, int n, int k, int group_size, int cb,
                                int dtype, int token_tile, int stages, int splits,
                                int slabs_per_split, int smem, void* stream) {
  const int g = group_size;
  Params p{};
  p.wq = static_cast<const uint8_t*>(wq);
  p.scale = scale, p.zs = zs, p.out = out;
  p.part = splits > 1 ? static_cast<float*>(part) : nullptr;
  p.m = m, p.n = n;
  p.row_bytes = k / 8 * cb;
  p.meta_cols = k / g;
  p.group_size = g, p.cb = cb, p.pblocks = 0;
  // groups under a slab row: 64/g, one, or for a g that neither divides nor
  // is divided by 64 as many as a slab can touch; a slot holds at least 4
  // (a TMA box row of 16 bytes)
  const bool tiles = sm90::kBK % g == 0 || g % sm90::kBK == 0;
  p.meta_shift = !tiles;
  p.group_log2 = (g & (g - 1)) == 0 ? __builtin_ctz(static_cast<unsigned>(g)) : -1;
  const int groups = g % sm90::kBK == 0 ? 1 : tiles ? sm90::kBK / g : (sm90::kBK - 1) / g + 2;
  p.slab_groups = groups > 4 ? groups : 4;
  p.code_vec = sm90::copy_vec(wq, p.row_bytes, 8 * cb);
  p.meta_vec = tiles ? sm90::copy_vec(scale, 4L * p.meta_cols, 4L * p.slab_groups) : 4;
  if (sm90::copy_vec(zs, 4L * p.meta_cols, 4L * p.slab_groups) < p.meta_vec) p.meta_vec = 4;
  p.meta_rows = 0;
  p.slabs = (k + sm90::kBK - 1) / sm90::kBK;
  p.slabs_per_split = slabs_per_split;
  p.stages = stages;
  p.code_stage = sm90::kBN * 8 * cb;
  p.meta_stage = 2 * sm90::kBN * p.slab_groups * 4;
  p.out_dtype = dtype;
  // TMA where its rules hold (16-byte rows and strides), else cp.async
  sm90::WeightMaps w;
  p.codes_tma = cb >= 2 && p.code_vec == 16;
  if (p.codes_tma) {
    const long dims[3] = {p.row_bytes, n, 1}, strides[2] = {p.row_bytes, 1L * p.row_bytes * n};
    const int box[3] = {8 * cb, sm90::kBN, 1};
    if (sm90::encode_map(&w.codes, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, wq, dims, strides, box,
                         CU_TENSOR_MAP_SWIZZLE_NONE) != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  p.meta_tma = tiles && p.meta_vec == 16;
  if (p.meta_tma) {
    const long dims[2] = {p.meta_cols, n}, strides[1] = {4L * p.meta_cols};
    const int box[2] = {p.slab_groups, sm90::kBN};
    if (sm90::encode_map(&w.scale, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, scale, dims, strides, box,
                         CU_TENSOR_MAP_SWIZZLE_NONE) != 0 ||
        sm90::encode_map(&w.zs, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, zs, dims, strides, box,
                         CU_TENSOR_MAP_SWIZZLE_NONE) != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == HQQ_BF16)
    return sm90::launch<__nv_bfloat16, Ax1Layout>(x, k, p, w, token_tile, splits, smem, s);
  if (dtype == HQQ_F16)
    return sm90::launch<__half, Ax1Layout>(x, k, p, w, token_tile, splits, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

HQQ_EXPORT const char* hqq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
