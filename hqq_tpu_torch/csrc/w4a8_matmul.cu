// SPDX-License-Identifier: Apache-2.0
// w4a8_matmul: y[m, n] = sx[m] * sum_g( s[n,g] * dot_g(x8[m], c[n]) - xsum[m,g] * zs[n,g] )
// for M <= 32 rows of int8 activations x8 (x ~ x8 * sx, per row) against a
// 1/2/4/8-bit weight in the kernel layout of hqq_common.cuh. dot_g is the
// exact int32 dot of group g; the epilogue is fp32; y is written in fp32,
// bf16 or fp16. A second entry, w4a8_lora_matmul, adds a LoRA epilogue in
// fp32: y[m, n] += sum_j xa[m, j] * B[j, n], with xa = x @ A [M, r] computed
// by the caller from the unquantized activations and B [r, N] fp32 (the
// adapter's scaling folded in). Scale and zs are fp32 or bf16; bf16 is
// widened to fp32 as it is loaded, and the 4-bit container's zs gets its
// 8*scale back there (`hqq_ax1_zs_offset`): a flag, not a template
// argument, so the instantiations do not double.
//
// Replaces: hqq_tpu/ops/fused_matmul.py `_qmm_a8_decode_kernel` (launched by
//   `_qmm_a8_decode_call`) and `_qmm_a8_kernel` (launched by `_qmm_a8_call`),
//   both behind `quant_matmul_pallas_a8` for M <= 32. The TPU needs two
//   kernels (class-replicated deep dots when K % 8g == 0, batched per-group
//   dots otherwise); one kernel serves every K % g == 0 here. With the
//   epilogue: `_qmm_a8_lora_decode_kernel` (launched by
//   `_qmm_a8_lora_decode_call`, entry `quant_matmul_pallas_a8_lora`).
// Bound on H100: bytes. At decode the weight is read once: K*N*cb/8 bytes of
//   codes plus 8*N*K/g of fp32 scale and zs (4096x4096, 4-bit, g64: 10.5 MB,
//   3.1 us at 3.35 TB/s). The int8 work, 2*M*N*K operations, stays far below
//   the int8 rate for M <= 32.
// Design: one warp per NCOL output columns and MT activation rows (gridDim.y
//   splits M into chunks of MT). Each lane owns whole groups: in a K-tile of
//   32 groups, lane l takes group l, so the warp reads 32 consecutive groups
//   of a row, contiguous and coalesced, in 16-byte loads where the group's
//   byte count allows. The block stages the tile's activations of its MT
//   rows in shared memory, one padded row of words per group, so that the 32
//   lanes' reads fall in 32 different banks. Unpacking is a shift and a mask
//   per 4 codes, and __dp4a multiplies them with 4 activations into the
//   group's int32 sum. Each lane folds its group's partial into fp32
//   accumulators through scale and zs; a warp shuffle sums the lanes at the
//   end. Every weight byte is read from memory once per M chunk (once in
//   all for M <= 8). The LoRA term rides the same reduction: lane l sums the
//   ranks j = l, l + 32, ... of its warp's outputs, a second shuffle adds
//   the lanes, and the term joins after the multiply by sx (r*(M + N) more
//   fp32 values to read, 0.7% of a 4096x4096 4-bit g64 weight at r = 8).
#include "hqq_common.cuh"

namespace {

constexpr int kWarps = 8;     // warps per block
constexpr int kNcol = 2;      // output columns per warp
constexpr int kTileGroups = 32;  // groups per K-tile, one per lane

// LoRA epilogue operands: xa fp32 [M, r], b fp32 [r, N]; r = 0 for none
struct Lora {
  const float* xa;
  const float* b;
  int r;
};

// scale or zs i, fp32 or bf16 (widened by its bits)
__device__ __forceinline__ float load_meta(const void* p, size_t i, int bf16) {
  return bf16 ? meta_f32(static_cast<const __nv_bfloat16*>(p)[i]) : static_cast<const float*>(p)[i];
}

// VW: weight words per load, 4 (one 16-byte load) or 1
template <int CB, int MT, int VW>
__global__ void __launch_bounds__(kWarps * 32)
    w4a8_kernel(const int8_t* __restrict__ x8, const float* __restrict__ sx,
                const uint32_t* __restrict__ wq, const void* __restrict__ scale,
                const void* __restrict__ zs, Lora lora, void* __restrict__ out, int m, int n,
                int k, int group_size, int out_dtype, int meta_bf16, int meta_cols) {
  constexpr int kFields = 8 / CB;           // 4-code fields per weight word
  constexpr int kCodesPerWord = 32 / CB;
  constexpr uint32_t kMask = ((1u << CB) - 1u) * 0x01010101u;
  extern __shared__ int xs_smem[];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int groups = k / group_size;
  const int words_per_group = group_size / kCodesPerWord;  // weight words
  const int xw_per_group = group_size / 4;                 // activation words
  const int xw_stride = xw_per_group + 1;                  // +1: bank spread
  const int row_words = k / kCodesPerWord;
  const int m0 = blockIdx.y * MT;
  const int col0 = (blockIdx.x * kWarps + warp) * kNcol;
  const int* x32 = reinterpret_cast<const int*>(x8);

  float acc[MT][kNcol];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int c = 0; c < kNcol; ++c) acc[i][c] = 0.f;

  for (int g0 = 0; g0 < groups; g0 += kTileGroups) {
    __syncthreads();  // the previous tile has been consumed
    const int tile_words = MT * kTileGroups * xw_per_group;
    for (int idx = threadIdx.x; idx < tile_words; idx += blockDim.x) {
      const int row = idx / (kTileGroups * xw_per_group);
      const int rem = idx - row * (kTileGroups * xw_per_group);
      const int gl = rem / xw_per_group;
      const int wj = rem - gl * xw_per_group;
      const int grp = g0 + gl;
      int v = 0;
      if (m0 + row < m && grp < groups) {
        v = x32[(static_cast<size_t>(m0 + row) * k + static_cast<size_t>(grp) * group_size) / 4 + wj];
      }
      xs_smem[(row * kTileGroups + gl) * xw_stride + wj] = v;
    }
    __syncthreads();

    const int grp = g0 + lane;
    if (grp < groups) {
      int idot[MT][kNcol];
      int xsum[MT];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        xsum[i] = 0;
#pragma unroll
        for (int c = 0; c < kNcol; ++c) idot[i][c] = 0;
      }
      const int* xrow = xs_smem + lane * xw_stride;
      for (int w0 = 0; w0 < words_per_group; w0 += VW) {
        uint32_t wv[kNcol][VW];
#pragma unroll
        for (int c = 0; c < kNcol; ++c) {
          const int col = col0 + c;
          const size_t off = static_cast<size_t>(col) * row_words +
                             static_cast<size_t>(grp) * words_per_group + w0;
          if constexpr (VW == 4) {
            uint4 v = make_uint4(0u, 0u, 0u, 0u);
            if (col < n) v = __ldg(reinterpret_cast<const uint4*>(wq + off));
            wv[c][0] = v.x;
            wv[c][1] = v.y;
            wv[c][2] = v.z;
            wv[c][3] = v.w;
          } else {
            wv[c][0] = col < n ? __ldg(wq + off) : 0u;
          }
        }
#pragma unroll
        for (int v = 0; v < VW; ++v) {
#pragma unroll
          for (int f = 0; f < kFields; ++f) {
            const int xoff = (w0 + v) * kFields + f;
#pragma unroll
            for (int i = 0; i < MT; ++i) {
              const int xw = xrow[i * kTileGroups * xw_stride + xoff];
              xsum[i] = __dp4a(xw, 0x01010101, xsum[i]);
#pragma unroll
              for (int c = 0; c < kNcol; ++c) {
                const int q = static_cast<int>((wv[c][v] >> (CB * f)) & kMask);
                idot[i][c] = __dp4a(q, xw, idot[i][c]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int c = 0; c < kNcol; ++c) {
        const int col = col0 + c;
        if (col < n) {
          const size_t gi = static_cast<size_t>(col) * meta_cols + grp;
          const float s = load_meta(scale, gi, meta_bf16);
          const float z = load_meta(zs, gi, meta_bf16) + (meta_bf16 && CB == 4 ? 8.f * s : 0.f);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            acc[i][c] += s * static_cast<float>(idot[i][c]) - static_cast<float>(xsum[i]) * z;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int c = 0; c < kNcol; ++c) {
      float v = acc[i][c];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      const int row = m0 + i;
      const int col = col0 + c;
      float l = 0.f;
      if (lora.r > 0) {  // uniform over the warp, as are row and col
        if (row < m && col < n) {
          for (int j = lane; j < lora.r; j += 32) {
            l = fmaf(lora.xa[static_cast<size_t>(row) * lora.r + j],
                     lora.b[static_cast<size_t>(j) * n + col], l);
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
      }
      if (lane == 0 && row < m && col < n) {
        hqq_store(out, static_cast<size_t>(row) * n + col, v * sx[row] + l, out_dtype);
      }
    }
  }
}

template <int CB, int MT, int VW>
int launch(const void* x8, const void* sx, const void* wq, const void* scale, const void* zs,
           Lora lora, void* out, int m, int n, int k, int group_size, int out_dtype,
           int meta_dtype, cudaStream_t stream) {
  auto kernel = w4a8_kernel<CB, MT, VW>;
  const int smem = MT * kTileGroups * (group_size / 4 + 1) * 4;
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int cols_per_block = kWarps * kNcol;
  dim3 grid((n + cols_per_block - 1) / cols_per_block, (m + MT - 1) / MT);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const int8_t*>(x8), static_cast<const float*>(sx),
      static_cast<const uint32_t*>(wq), scale, zs, lora, out, m, n, k, group_size, out_dtype,
      meta_dtype == HQQ_BF16, hqq_ax1_meta_cols(k / group_size, meta_dtype));
  return static_cast<int>(cudaGetLastError());
}

template <int CB, int MT>
int dispatch_vw(const void* x8, const void* sx, const void* wq, const void* scale,
                const void* zs, Lora lora, void* out, int m, int n, int k, int group_size,
                int out_dtype, int meta_dtype, cudaStream_t stream) {
  // 16-byte loads need a group of a multiple of 4 words (it keeps every
  // row and every group 16-byte aligned)
  if ((group_size / (32 / CB)) % 4 == 0)
    return launch<CB, MT, 4>(x8, sx, wq, scale, zs, lora, out, m, n, k, group_size, out_dtype,
                             meta_dtype, stream);
  return launch<CB, MT, 1>(x8, sx, wq, scale, zs, lora, out, m, n, k, group_size, out_dtype,
                           meta_dtype, stream);
}

template <int CB>
int dispatch_mt(const void* x8, const void* sx, const void* wq, const void* scale,
                const void* zs, Lora lora, void* out, int m, int n, int k, int group_size,
                int out_dtype, int meta_dtype, cudaStream_t stream) {
#define HQQ_W4A8_MT(MT)                                                                     \
  return dispatch_vw<CB, MT>(x8, sx, wq, scale, zs, lora, out, m, n, k, group_size, out_dtype, \
                             meta_dtype, stream)
  if (m <= 1) HQQ_W4A8_MT(1);
  if (m <= 2) HQQ_W4A8_MT(2);
  if (m <= 4) HQQ_W4A8_MT(4);
  HQQ_W4A8_MT(8);
#undef HQQ_W4A8_MT
}

int dispatch_cb(const void* x8, const void* sx, const void* wq, const void* scale, const void* zs,
                Lora lora, void* out, int m, int n, int k, int group_size, int cb, int out_dtype,
                int meta_dtype, cudaStream_t s) {
  if (meta_dtype != HQQ_F32 && meta_dtype != HQQ_BF16) return static_cast<int>(cudaErrorInvalidValue);
#define HQQ_W4A8_CB(CB) \
  return dispatch_mt<CB>(x8, sx, wq, scale, zs, lora, out, m, n, k, group_size, out_dtype, meta_dtype, s)
  switch (cb) {
    case 1: HQQ_W4A8_CB(1);
    case 2: HQQ_W4A8_CB(2);
    case 4: HQQ_W4A8_CB(4);
    case 8: HQQ_W4A8_CB(8);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef HQQ_W4A8_CB
}

}  // namespace

// meta_dtype: HQQ_F32 or HQQ_BF16, the type of scale and zs [N, C]
// (`hqq_ax1_meta_cols`)
HQQ_EXPORT int hqq_w4a8_matmul(const void* x8, const void* sx, const void* wq, const void* scale,
                               const void* zs, void* out, int m, int n, int k, int group_size,
                               int cb, int out_dtype, int meta_dtype, void* stream) {
  return dispatch_cb(x8, sx, wq, scale, zs, Lora{nullptr, nullptr, 0}, out, m, n, k, group_size,
                     cb, out_dtype, meta_dtype, static_cast<cudaStream_t>(stream));
}

// xa fp32 [M, r] and lb fp32 [r, N], r >= 1: the LoRA epilogue
HQQ_EXPORT int hqq_w4a8_lora_matmul(const void* x8, const void* sx, const void* wq,
                                    const void* scale, const void* zs, const void* xa,
                                    const void* lb, void* out, int m, int n, int k, int r,
                                    int group_size, int cb, int out_dtype, int meta_dtype,
                                    void* stream) {
  if (r < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Lora lora{static_cast<const float*>(xa), static_cast<const float*>(lb), r};
  return dispatch_cb(x8, sx, wq, scale, zs, lora, out, m, n, k, group_size, cb, out_dtype,
                     meta_dtype, static_cast<cudaStream_t>(stream));
}

HQQ_EXPORT const char* hqq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
