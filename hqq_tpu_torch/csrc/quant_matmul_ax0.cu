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
// Design: the Hopper mainloop of qmm_sm90.cuh over PERMUTED rows p = b*g + a
//   (logical row n = a*P + b): a tile's 128 rows are whole groups (or a
//   part of one), so a slab reads 128/g rows of scale and zs, which ride
//   the pipeline into shared memory with the codes (cp.async; the producer
//   gathers the g runs of 128/g code rows, each copy computing its own
//   source row). Each thread dequantizes 8 codes with their 8 scales and zs
//   from shared memory. The store maps p back to n. At decode sizes K is
//   split over gridDim.z (the launch plan of ops/fused_matmul.py): each
//   split writes an fp32 partial, and `qmm_sum_splits` adds them in order.
#include "qmm_sm90.cuh"

namespace {

using sm90::Params;

__device__ __forceinline__ void meta8_f32(const float* m, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(m);
  const float4 b = *reinterpret_cast<const float4*>(m + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void meta8_f32(const __nv_bfloat16* m, float (&v)[8]) {
  const uint4 t = *reinterpret_cast<const uint4*>(m);
  const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// kernel layout of the file header: wq [N, K_pad*cb/8] in logical row
// order, scale and zs [P, K_pad] of type Meta
template <typename Meta>
struct Ax0Layout {
  static constexpr bool kContiguous = false;

  // smem row of tile row pr's codes: the TMA box lands them as [a][b], the
  // cp.async fallback in tile order
  static __device__ __forceinline__ int code_row(const Params& p, int pr) {
    const int g = p.group_size;
    return p.codes_tma ? (pr % g) * max(1, sm90::kBN / g) + pr / g : pr;
  }

  // TMA coordinates of a slab: codes {byte, b, a} of the [g, P, row] view,
  // scale and zs {column, b}
  static __device__ __forceinline__ void code_coords(const Params& p, int p0, int k0, int (&c)[3]) {
    c[0] = k0 / 8 * p.cb, c[1] = p0 / p.group_size, c[2] = p0 % p.group_size;
  }
  static __device__ __forceinline__ void meta_coords(const Params& p, int p0, int k0, int (&c)[2]) {
    c[0] = k0, c[1] = p0 / p.group_size;
  }

  // what the TMA does not load, by cp.async (zero-filled past the tensor)
  static __device__ __forceinline__ void load_slab(const Params& p, int p0, int k0,
                                                   uint32_t codes, uint32_t meta, int tid) {
    const int g = p.group_size;
    if (!p.codes_tma) {
      const int slab_bytes = 8 * p.cb;
      const int per_row = slab_bytes / p.code_vec;
      const int c0 = k0 / 8 * p.cb;
      for (int idx = tid; idx < sm90::kBN * per_row; idx += 128) {
        const int r = idx / per_row, off = c0 + (idx % per_row) * p.code_vec;
        const int pr = p0 + r;
        const bool ok = pr < p.n && off < p.row_bytes;
        const size_t row = static_cast<size_t>(pr % g) * p.pblocks + pr / g;
        const uint8_t* src = ok ? p.wq + row * p.row_bytes + off : p.wq;
        sm90::cp_async(codes + r * slab_bytes + (idx % per_row) * p.code_vec, src, p.code_vec,
                       ok);
      }
    }
    if (p.meta_tma) return;
    constexpr int kRowBytes = sm90::kBK * static_cast<int>(sizeof(Meta));
    const int per_meta = kRowBytes / p.meta_vec;
    const int b0 = p0 / g;
    const int total = 2 * p.meta_rows * per_meta;
    for (int idx = tid; idx < total; idx += 128) {
      const int a = idx / (p.meta_rows * per_meta);  // 0: scale, 1: zs
      const int rem = idx % (p.meta_rows * per_meta);
      const int i = rem / per_meta, off = k0 * static_cast<int>(sizeof(Meta)) +
                                           (rem % per_meta) * p.meta_vec;
      const uint8_t* base = static_cast<const uint8_t*>(a == 0 ? p.scale : p.zs);
      const bool ok = b0 + i < p.pblocks && off < p.meta_cols * static_cast<int>(sizeof(Meta));
      const uint8_t* src =
          ok ? base + static_cast<size_t>(b0 + i) * p.meta_cols * sizeof(Meta) + off : base;
      sm90::cp_async(meta + (a * p.meta_rows + i) * kRowBytes + (rem % per_meta) * p.meta_vec,
                     src, p.meta_vec, ok);
    }
  }

  // element index of tile row pr's scales for chunk q (columns 8q..8q+7)
  static __device__ __forceinline__ int meta_offset(const Params& p, int p0, int pr, int q) {
    return ((p0 + pr) / p.group_size - p0 / p.group_size) * sm90::kBK + 8 * q;
  }
  static __device__ __forceinline__ int zs_offset(const Params& p) {
    return p.meta_rows * sm90::kBK;
  }
  static __device__ __forceinline__ int meta_add(const Params&, int, int) { return 0; }
  static __device__ __forceinline__ float zs_add(const Params&) { return 0.f; }  // zs as stored
  static __device__ __forceinline__ void meta8(const uint8_t* meta, int off, int zs_off, float,
                                               float (&s)[8], float (&z)[8]) {
    const Meta* m = reinterpret_cast<const Meta*>(meta);
    meta8_f32(m + off, s);
    meta8_f32(m + zs_off + off, z);
  }

  // the logical column of permuted row pr
  static __device__ __forceinline__ int column(const Params& p, int pr) {
    return (pr % p.group_size) * p.pblocks + pr / p.group_size;
  }
};

template <typename T, typename Meta>
int launch(const void* x, const void* wq, const void* scale, const void* zs, void* out,
           void* part, int m, int n, int kx, int k_pad, int g, int cb, int dtype,
           int token_tile, int stages, int splits, int slabs_per_split, int smem,
           cudaStream_t s) {
  constexpr long kMeta = sizeof(Meta);
  Params p{};
  p.wq = static_cast<const uint8_t*>(wq);
  p.scale = scale, p.zs = zs, p.out = out;
  p.part = splits > 1 ? static_cast<float*>(part) : nullptr;
  p.m = m, p.n = n;
  p.row_bytes = k_pad / 8 * cb;
  p.meta_cols = k_pad;
  p.group_size = g, p.cb = cb, p.pblocks = n / g;
  p.code_vec = sm90::copy_vec(wq, p.row_bytes, 8 * cb);
  p.meta_vec = sm90::copy_vec(scale, kMeta * k_pad, kMeta * sm90::kBK);
  if (sm90::copy_vec(zs, kMeta * k_pad, kMeta * sm90::kBK) < p.meta_vec) p.meta_vec = 4;
  // rows of scale and zs under a tile of 128 permuted rows
  const bool whole = sm90::kBN % g == 0 || g % sm90::kBN == 0;  // a tile is whole groups, or in one
  p.meta_rows = sm90::kBN % g == 0 ? sm90::kBN / g : whole ? 1 : (sm90::kBN - 1) / g + 2;
  p.slabs = (k_pad + sm90::kBK - 1) / sm90::kBK;
  p.slabs_per_split = slabs_per_split;
  p.stages = stages;
  p.code_stage = sm90::kBN * 8 * cb;
  p.meta_stage = 2 * p.meta_rows * sm90::kBK * static_cast<int>(kMeta);
  p.out_dtype = dtype;
  // TMA where its rules hold (16-byte rows and strides, a tile of whole
  // groups or inside one), else cp.async. Codes: the [g, P, row] view of
  // wq, so one box gathers the tile's g runs of 128/g rows.
  sm90::WeightMaps w;
  p.codes_tma = whole && cb >= 2 && p.code_vec == 16;
  if (p.codes_tma) {
    const long dims[3] = {p.row_bytes, p.pblocks, g};
    const long strides[2] = {p.row_bytes, 1L * p.row_bytes * p.pblocks};
    const int box[3] = {8 * cb, max(1, sm90::kBN / g), min(g, sm90::kBN)};
    if (sm90::encode_map(&w.codes, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, wq, dims, strides, box,
                         CU_TENSOR_MAP_SWIZZLE_NONE) != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  p.meta_tma = whole && p.meta_vec == 16;
  if (p.meta_tma) {
    const CUtensorMapDataType type =
        kMeta == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    const long dims[2] = {k_pad, p.pblocks}, strides[1] = {kMeta * k_pad};
    const int box[2] = {sm90::kBK, p.meta_rows};
    if (sm90::encode_map(&w.scale, type, 2, scale, dims, strides, box,
                         CU_TENSOR_MAP_SWIZZLE_NONE) != 0 ||
        sm90::encode_map(&w.zs, type, 2, zs, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE) != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return sm90::launch<T, Ax0Layout<Meta>>(x, kx, p, w, token_tile, splits, smem, s);
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
