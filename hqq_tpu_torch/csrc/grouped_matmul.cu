// SPDX-License-Identifier: Apache-2.0
// grouped_matmul: the experts of a Mixture-of-Experts layer, y[e] = x[e] . W_e^T,
// with every W_e read in its packed 4-bit form and never written out dense.
//
//   hqq_grouped_matmul  x [E, C, K] bf16, W_e [N, K] a canonical 4bit_u8 QTensor of
//                       axis=1 stacked on a leading E (codes [E, N*K/(2g), g], scale
//                       and zero [E, N*K/g, 1] in fp32 or bf16) -> y [E, C, N] bf16
//
// Replaces no Pallas kernel: hqq_tpu/nn/moe.py:110 `GroupedQuantLinear.__call__`
//   leaves the experts to XLA, a vmapped `dequantize` (hqq_tpu/core/quantize.py:381)
//   of all E experts to the activation type and one einsum with fp32 accumulation.
//   Done literally on this card (dequantize the stack, then torch.bmm) every decode
//   step would write and read every expert in bf16: at Mixtral-8x7B 90 GB a step
//   against 28.2 GB of codes and meta.
// Arithmetic: the function of hqq_tpu's: W_e[n, k] = (c - zero) * scale in the meta
//   type T (each an fp32 operation rounded to T, no fused multiply-add), rounded to
//   bf16; products of bf16 values summed in fp32 (the tensor cores' accumulator);
//   y rounded to bf16. Only the order of the sums differs from the plain twin's.
// Bound on H100: bytes. The codes and meta of all E experts are read once, x and y
//   are small: at 8 x [14336, 4096] 4-bit g64 fp32 meta 293.6 MB, 88 us at 3.35 TB/s.
// Design (simple first; wgmma, TMA and skipping empty experts are later work):
//   * Packing. 4bit_u8 packs the group-space rows as W[:s] << 4 | W[s:], s = N*K/(2g),
//     so the K bytes from n*K on hold output row n in their high nibbles and row
//     n + N/2 in their low nibbles, k in order: a row pair is one contiguous run.
//   * Tensor cores. mma.sync m16n8k16 bf16 -> fp32 with the weight rows as the MMA's
//     M side (rows 0-7 of a tile the pairs' upper rows, 8-15 their lower rows, so one
//     code byte feeds a lane's two A rows) and the tokens as its N side (a tile of 8
//     tokens; C <= 32 is 1-4 tiles). The k order inside a 64-wide step is the MMA's
//     own: the lane of threadID_in_group t reads the 16 code bytes 16t..16t+15 of
//     its pair in one 16-byte load and gives byte 4w+j of them to k-step w as
//     logical k 2t+j (j < 2) or 2t+6+j (j >= 2); its B fragment takes x at the same
//     k, so the sum runs over the same products.
//   * A block is 8 warps over 128 row pairs of one expert (grid: pair tiles x E),
//     each warp 16 pairs (two M tiles) reusing its x fragments for both. x[e] goes
//     through shared memory in chunks of 512 k for all C rows (rows padded by 16
//     bytes: the fragment loads hit no bank twice); a K of 14336 at C = 32 would
//     not fit whole. Each lane loads the code bytes of two 64-wide steps of both
//     tiles before it computes, and the scale and zero of its 16 codes' group
//     (g % 16 == 0: 16 codes are one group).
//   * K % 64 == 0, any N/2 (ragged pair tiles masked), E up to 65535.
#include "hqq_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kTiles = 2;                        // M tiles of 8 pairs a warp
constexpr int kPairsPerBlock = kWarps * kTiles * 8;
constexpr int kChunk = 512;                      // k of x a shared-memory chunk holds
constexpr int kRow = kChunk + 8;                 // bf16 a staged row (16 bytes of padding)
constexpr int kUnroll = 2;                       // 64-wide k steps loaded ahead

// a value rounded to T, as an fp32 operation whose result PyTorch stores in T
template <typename T>
__device__ __forceinline__ float round_as(float x) { return x; }
template <>
__device__ __forceinline__ float round_as<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// (c - z) * s in T, then rounded to bf16: the dequantized weight
template <typename T>
__device__ __forceinline__ float dq(uint32_t c, float s, float z) {
  return round_as<T>(__fmul_rn(round_as<T>(__fsub_rn(static_cast<float>(c), z)), s));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the A fragment of one k-step from a code word (bytes j = 0..3 at logical k
// 2t + (j < 2 ? j : j + 6)): a0/a2 the upper rows' nibbles, a1/a3 the lower rows'
template <typename T>
__device__ __forceinline__ void a_fragment(uint32_t w, float su, float zu, float sl, float zl,
                                           uint32_t (&a)[4]) {
  float u[4], l[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    u[j] = dq<T>((w >> (8 * j + 4)) & 0xfu, su, zu);
    l[j] = dq<T>((w >> (8 * j)) & 0xfu, sl, zl);
  }
  a[0] = pack_bf16(u[0], u[1]);
  a[1] = pack_bf16(l[0], l[1]);
  a[2] = pack_bf16(u[2], u[3]);
  a[3] = pack_bf16(l[2], l[3]);
}

// D += A . B, m16n8k16, bf16 x bf16 -> fp32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T>
__device__ __forceinline__ float meta(const T* p, size_t i) {
  return meta_f32(p[i]);
}

// TT token tiles of 8 (C <= 8 * TT); T the meta type
template <typename T, int TT>
__global__ void __launch_bounds__(kWarps * 32)
    grouped_matmul_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ wq,
                          const T* __restrict__ scale, const T* __restrict__ zero,
                          __nv_bfloat16* __restrict__ y, int c_rows, int k, int n,
                          int group_size) {
  __shared__ __align__(16) __nv_bfloat16 xs[TT * 8][kRow];
  const int e = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int pairs = n / 2;
  const int groups = k / group_size;  // of a row
  const __nv_bfloat16* xe = x + static_cast<size_t>(e) * c_rows * k;
  const uint8_t* we = wq + static_cast<size_t>(e) * pairs * k;
  const T* se = scale + static_cast<size_t>(e) * n * groups;
  const T* ze = zero + static_cast<size_t>(e) * n * groups;

  int pair[kTiles];
  bool live[kTiles];
#pragma unroll
  for (int r = 0; r < kTiles; ++r) {
    pair[r] = blockIdx.x * kPairsPerBlock + (warp * kTiles + r) * 8 + g;
    live[r] = pair[r] < pairs;
  }
  float acc[kTiles][TT][4];
#pragma unroll
  for (int r = 0; r < kTiles; ++r)
#pragma unroll
    for (int j = 0; j < TT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[r][j][i] = 0.f;

  for (int kc = 0; kc < k; kc += kChunk) {
    const int kn = min(kChunk, k - kc);
    __syncthreads();  // the previous chunk's fragments are read
    const int vecs = kn / 8;  // 16-byte vectors of a row
    for (int v = threadIdx.x; v < TT * 8 * vecs; v += kWarps * 32) {
      const int row = v / vecs, col = (v - row * vecs) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (row < c_rows)
        val = __ldg(reinterpret_cast<const uint4*>(xe + static_cast<size_t>(row) * k + kc + col));
      *reinterpret_cast<uint4*>(&xs[row][col]) = val;
    }
    __syncthreads();

    for (int kb = 0; kb < kn; kb += 64 * kUnroll) {
      uint4 codes[kUnroll][kTiles];
      float su[kUnroll][kTiles], zu[kUnroll][kTiles], sl[kUnroll][kTiles], zl[kUnroll][kTiles];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k0 = kc + kb + 64 * u + 16 * t;  // this lane's 16 codes
        const bool in_k = kb + 64 * u < kn;
        const int grp = k0 / group_size;
#pragma unroll
        for (int r = 0; r < kTiles; ++r) {
          codes[u][r] = make_uint4(0, 0, 0, 0);
          su[u][r] = zu[u][r] = sl[u][r] = zl[u][r] = 0.f;
          if (live[r] && in_k) {
            codes[u][r] = __ldg(reinterpret_cast<const uint4*>(
                we + static_cast<size_t>(pair[r]) * k + k0));
            const size_t mu = static_cast<size_t>(pair[r]) * groups + grp;
            const size_t ml = static_cast<size_t>(pair[r] + pairs) * groups + grp;
            su[u][r] = meta(se, mu), zu[u][r] = meta(ze, mu);
            sl[u][r] = meta(se, ml), zl[u][r] = meta(ze, ml);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (kb + 64 * u >= kn) break;
        // x at the same k as the codes, for every token tile: b0/b1 of step w
        // are words 2w and 2w + 1
        uint32_t b[TT][8];
#pragma unroll
        for (int j = 0; j < TT; ++j) {
          const uint4* p = reinterpret_cast<const uint4*>(&xs[j * 8 + g][kb + 64 * u + 16 * t]);
          const uint4 lo = p[0], hi = p[1];
          b[j][0] = lo.x, b[j][1] = lo.y, b[j][2] = lo.z, b[j][3] = lo.w;
          b[j][4] = hi.x, b[j][5] = hi.y, b[j][6] = hi.z, b[j][7] = hi.w;
        }
#pragma unroll
        for (int r = 0; r < kTiles; ++r) {
          const uint32_t words[4] = {codes[u][r].x, codes[u][r].y, codes[u][r].z,
                                     codes[u][r].w};
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            uint32_t a[4];
            a_fragment<T>(words[w], su[u][r], zu[u][r], sl[u][r], zl[u][r], a);
#pragma unroll
            for (int j = 0; j < TT; ++j) mma_bf16(acc[r][j], a, b[j][2 * w], b[j][2 * w + 1]);
          }
        }
      }
    }
  }

  // D: c0/c1 the upper row (pair) at tokens 2t, 2t + 1; c2/c3 the lower row
  __nv_bfloat16* ye = y + static_cast<size_t>(e) * c_rows * n;
#pragma unroll
  for (int r = 0; r < kTiles; ++r) {
    if (!live[r]) continue;
#pragma unroll
    for (int j = 0; j < TT; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int tok = j * 8 + 2 * t + (i & 1);
        const int row = pair[r] + (i >= 2 ? pairs : 0);
        if (tok < c_rows) ye[static_cast<size_t>(tok) * n + row] = __float2bfloat16_rn(acc[r][j][i]);
      }
    }
  }
}

template <typename T, int TT>
int launch(const void* x, const void* wq, const void* scale, const void* zero, void* y,
           int experts, int c_rows, int k, int n, int group_size, cudaStream_t s) {
  const dim3 grid((n / 2 + kPairsPerBlock - 1) / kPairsPerBlock, experts);
  grouped_matmul_kernel<T, TT><<<grid, kWarps * 32, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(wq),
      static_cast<const T*>(scale), static_cast<const T*>(zero),
      static_cast<__nv_bfloat16*>(y), c_rows, k, n, group_size);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_tiles(const void* x, const void* wq, const void* scale, const void* zero, void* y,
                 int experts, int c_rows, int k, int n, int group_size, int token_tiles,
                 cudaStream_t s) {
  switch (token_tiles) {
    case 1:
      return launch<T, 1>(x, wq, scale, zero, y, experts, c_rows, k, n, group_size, s);
    case 2:
      return launch<T, 2>(x, wq, scale, zero, y, experts, c_rows, k, n, group_size, s);
    case 4:
      return launch<T, 4>(x, wq, scale, zero, y, experts, c_rows, k, n, group_size, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x, wq, scale, zero and y as above, contiguous, 16-byte aligned; c_rows <= 8 *
// token_tiles (1, 2 or 4); k % 64 == 0, group_size % 16 == 0, k % group_size == 0,
// n even; meta_dtype HQQ_F32 or HQQ_BF16; all from `grouped_matmul_plan`
HQQ_EXPORT int hqq_grouped_matmul(const void* x, const void* wq, const void* scale,
                                  const void* zero, void* y, int experts, int c_rows, int k,
                                  int n, int group_size, int meta_dtype, int token_tiles,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (experts < 1 || experts > 65535 || c_rows < 1 || c_rows > 8 * token_tiles || k % 64 ||
      group_size % 16 || k % group_size || n % 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (meta_dtype == HQQ_F32)
    return launch_tiles<float>(x, wq, scale, zero, y, experts, c_rows, k, n, group_size,
                               token_tiles, s);
  if (meta_dtype == HQQ_BF16)
    return launch_tiles<__nv_bfloat16>(x, wq, scale, zero, y, experts, c_rows, k, n,
                                       group_size, token_tiles, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

HQQ_EXPORT const char* hqq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
