// SPDX-License-Identifier: Apache-2.0
// dequant: a dense W from packed codes, in three layouts.
//
//   hqq_dequant            W[n, k] = code * scale - zs from the axis=1 kernel layout of
//                          hqq_common.cuh (scale and zs fp32 or bf16, widened to fp32)
//   hqq_dequant_ax0        the same from the axis=0 layout of quant_matmul_ax0.cu, where
//                          row n reads scale and zs [P, K_pad] at (n % P, k)
//   hqq_dequant_canonical  W = ((c - zero) * scale).reshape(shape) from a canonical
//                          QTensor (core/bitpack.py): the group-space matrix [R, C] packed
//                          along axis 0, chunk f of the rows in bitfield f, most
//                          significant first (uint8 containers, or int32 for 3-bit);
//                          or, with packing=None, the codes unpacked in fp32, bf16 or
//                          fp16 (exact integers), one to an element; a stack of E
//                          such QTensors (the experts of nn/moe.py's
//                          GroupedQuantLinear) in one launch, E the grid's y
//
// Replaces: hqq_tpu/ops/fused_matmul.py `_dq_kernel` (launched by `_dq_call`,
//   entry `dequant_pallas`), which writes W^T [K, N] tile by tile, and its use on
//   the permuted axis=0 layout by `_dequant_pallas_ax0`. The canonical entry
//   computes what hqq_tpu/core/quantize.py `dequantize` leaves to XLA's fusion:
//   the weight of the canonical QuantLinear, in its forward and again in its
//   backward (nn/linear.py `_DequantMatmul`).
// Bound on H100: bytes. The codes and the meta are read once and W is written
//   once: at 4096 x 11008, 4-bit g64 to bf16, 28.2 MB in and 90 MB out, 35 us
//   at 3.35 TB/s. One multiply and one subtract per element.
// Design: W is most of the bytes, so the stores set the pace. A lane owns
//   vectors of 16 output bytes (8 bf16/fp16 or 4 fp32 values; one value
//   where the launch plan narrows them) and the 32 lanes of a warp own 32
//   neighbouring vectors, so that each store instruction of a warp writes
//   512 contiguous bytes. A lane loads the code bytes of its vector itself
//   (the word that holds them, or the vector's packed elements, in one
//   load) and takes 4 vectors a pass with all their loads issued before the
//   first store: 16-128 bytes of codes in flight a lane. The output type,
//   the container and the vector width are template arguments, so codes and
//   words index registers at compile time; the grid strides over the
//   vectors, and the one division a vector needs (its group, row or pack
//   block) is a multiply-high by constants the launch plan computes
//   (`FastDiv`). The axis=0 entry gives a thread one vector of columns of a
//   residue class b = n % P of rows: it reads that vector's scale and zs
//   once, keeps them in registers, and walks the rows n = a*P + b of its
//   slice of a with up to 16 rows' loads in flight. The canonical entry
//   reads a vector's packed elements once and writes one vector for each
//   bitfield of them, each into a run of the output of its own (field f of
//   packed element e is output element e + f * stride); unpacked codes are
//   one field, read by their value.
// Arithmetic: the kernel layouts compute as `hqq_dq` does (an fp32 multiply,
//   then an fp32 subtract); the canonical entry as the plain PyTorch twin
//   does, in the meta type T: t = round_T(c - z), w = round_T(t * s), each an
//   fp32 operation rounded to T (PyTorch's opmath), then w rounded to the
//   output type. No fused multiply-add anywhere, so every entry is bit-equal
//   to its twin.
#include <type_traits>

#include "hqq_common.cuh"

__device__ __forceinline__ float meta_f32(__half v) { return __half2float(v); }

namespace {

constexpr int kItems = 4;  // vectors a lane takes per pass

// x / d for 0 <= x < 2^31: the multiply-high of Granlund and Montgomery, with
// mul and shift from the launch plan (`_fastdiv` in ops/fused_matmul.py);
// mul = 0 stands for d = 1
struct FastDiv {
  uint32_t mul, shift;
};

__device__ __forceinline__ uint32_t fdiv(uint32_t x, FastDiv f) {
  return f.mul ? __umulhi(x, f.mul) >> f.shift : x;
}

// a value rounded to T, as an fp32 operation whose result PyTorch stores in T
template <typename T>
__device__ __forceinline__ float round_as(float x) { return x; }
template <>
__device__ __forceinline__ float round_as<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
template <>
__device__ __forceinline__ float round_as<__half>(float x) {
  return __half2float(__float2half_rn(x));
}

// NB bytes from p (aligned to NB, or to 16 above it) into 32-bit words, byte i
// in byte i % 4 of word i / 4
template <int NB>
__device__ __forceinline__ void load_run(const void* p, uint32_t* w) {
  if constexpr (NB >= 16) {
#pragma unroll
    for (int i = 0; i < NB / 16; ++i) {
      const uint4 t = __ldg(reinterpret_cast<const uint4*>(p) + i);
      w[4 * i] = t.x, w[4 * i + 1] = t.y, w[4 * i + 2] = t.z, w[4 * i + 3] = t.w;
    }
  } else if constexpr (NB == 8) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = t.x, w[1] = t.y;
  } else if constexpr (NB == 4) {
    w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else if constexpr (NB == 2) {
    w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  } else {
    static_assert(NB == 1, "a run is 1, 2, 4, 8 or a multiple of 16 bytes");
    w[0] = __ldg(reinterpret_cast<const unsigned char*>(p));
  }
}

// N values of type T (fp32, bf16 or fp16) from p, widened to fp32 (exact)
template <typename T, int N>
__device__ __forceinline__ void load_meta(const T* p, float* v) {
  constexpr int NB = N * static_cast<int>(sizeof(T));
  uint32_t w[(NB + 3) / 4];
  load_run<NB>(p, w);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (sizeof(T) == 4) {
      v[i] = __uint_as_float(w[i]);
    } else {
      const uint32_t h = (w[i / 2] >> (16 * (i % 2))) & 0xffffu;
      if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        v[i] = __uint_as_float(h << 16);
      } else {
        v[i] = __half2float(__ushort_as_half(static_cast<unsigned short>(h)));
      }
    }
  }
}

template <typename Out>
__device__ __forceinline__ uint32_t pack2(float a, float b);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float a, float b) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&t);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float a, float b) {
  const __half2 t = __floats2half2_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&t);
}

// N outputs from v, each rounded to Out, in one store at p (aligned to the
// N * sizeof(Out) bytes it writes)
template <typename Out, int N>
__device__ __forceinline__ void store_run(Out* p, const float* v) {
  constexpr int NB = N * static_cast<int>(sizeof(Out));
  if constexpr (sizeof(Out) == 2 && N == 1) {
    if constexpr (std::is_same<Out, __nv_bfloat16>::value) {
      *p = __float2bfloat16_rn(v[0]);
    } else {
      *p = __float2half_rn(v[0]);
    }
  } else {
    uint32_t w[NB / 4];
#pragma unroll
    for (int i = 0; i < NB / 4; ++i) {
      if constexpr (sizeof(Out) == 4) {
        w[i] = __float_as_uint(v[i]);
      } else {
        w[i] = pack2<Out>(v[2 * i], v[2 * i + 1]);
      }
    }
    if constexpr (NB == 16) {
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    } else if constexpr (NB == 8) {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else {
      static_assert(NB == 4, "a store is 2, 4, 8 or 16 bytes");
      *reinterpret_cast<uint32_t*>(p) = w[0];
    }
  }
}

// The word layout's code c (0 <= c < 32/CB) of word w: bits 8*b + CB*f, with
// c = 4f + b.
template <int CB>
__device__ __forceinline__ uint32_t word_code(uint32_t w, int c) {
  return (w >> (CB * (c / 4) + 8 * (c % 4))) & ((1u << CB) - 1u);
}

// ---- axis=1 kernel layout ---------------------------------------------------
// Vector v holds the VC codes e = v*VC .. v*VC + VC - 1 of W [N, K] read
// row-major, which is the words' own order (code e is in word e / C), so
// its outputs are W's elements e, and its group is e / g of the groups read
// row-major: scale[e / g], or with bf16 meta, whose rows are padded by `pad`
// columns, scale[e/g + (e/g / (K/g)) * pad].
template <typename Meta, typename Out, int CB>
__global__ void __launch_bounds__(256)
    hqq_dequant_kernel(const uint32_t* __restrict__ wq, const Meta* __restrict__ scale,
                       const Meta* __restrict__ zs, Out* __restrict__ out, uint32_t vectors,
                       FastDiv per_group, FastDiv per_row_groups, uint32_t pad, float zadd) {
  constexpr int VC = 16 / sizeof(Out);
  constexpr int C = 32 / CB;
  constexpr int VW = VC > C ? VC / C : 1;  // words of a vector
  const uint32_t lane = threadIdx.x & 31;
  const uint32_t warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const uint32_t warps = (gridDim.x * blockDim.x) >> 5;
  for (uint32_t base = warp * 32 * kItems; base < vectors; base += warps * 32 * kItems) {
    uint32_t w[kItems][VW];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const uint32_t v = base + j * 32 + lane;
      if (v < vectors) load_run<VW * 4>(wq + v * VC / C, w[j]);
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const uint32_t v = base + j * 32 + lane;
      if (v >= vectors) break;
      const uint32_t e = v * VC;
      const int kbase = VW == 1 ? static_cast<int>(e % C) : 0;
      const uint32_t grp = fdiv(e, per_group);
      const uint32_t mi = pad ? grp + fdiv(grp, per_row_groups) * pad : grp;
      const float s = meta_f32(scale[mi]);
      const float zm = meta_f32(zs[mi]);
      const float z = zadd != 0.f ? __fadd_rn(zm, __fmul_rn(zadd, s)) : zm;
      float o[VC];
#pragma unroll
      for (int i = 0; i < VC; ++i) {
        const int c = kbase + i;  // one word (VW = 1): no runtime index
        o[i] = hqq_dq(word_code<CB>(w[j][VW == 1 ? 0 : c / C], c % C), s, z);
      }
      store_run<Out, VC>(out + e, o);
    }
  }
}

// ---- axis=0 kernel layout ---------------------------------------------------
// Block (x, b, z): the threads own vectors of VC columns k0 = VC * (x *
// blockDim.x + t) of the rows n = a*P + b, a in slice z of [0, g), all of
// which read row b of scale and zs: loaded once, widened to fp32, kept in
// registers. Columns past K are padding and are not written; a vector that K
// cuts, or rows that K leaves unaligned to 16 bytes, store element by element.
template <typename Meta, typename Out, int CB>
__global__ void __launch_bounds__(128)
    hqq_dequant_ax0_kernel(const uint32_t* __restrict__ wq, const Meta* __restrict__ scale,
                           const Meta* __restrict__ zs, Out* __restrict__ out, int n, int k,
                           int k_pad, int pblocks, int rows_per_block, int aligned) {
  constexpr int VC = 16 / sizeof(Out);
  constexpr int C = 32 / CB;
  constexpr int IW = VC > C ? VC / C : 1;  // words of a vector
  constexpr int UNROLL = 16;                 // rows whose loads go out together
  const int k0 = (blockIdx.x * blockDim.x + threadIdx.x) * VC;
  if (k0 >= k) return;
  const int b = blockIdx.y;
  const int a0 = blockIdx.z * rows_per_block;
  const int a1 = min(n / pblocks, a0 + rows_per_block);
  float s[VC], z[VC];
  load_meta<Meta, VC>(scale + static_cast<size_t>(b) * k_pad + k0, s);
  load_meta<Meta, VC>(zs + static_cast<size_t>(b) * k_pad + k0, z);
  const int row_words = k_pad / C;
  const int kbase = IW == 1 ? k0 % C : 0;
  const bool whole = aligned && k0 + VC <= k;
  for (int a = a0; a < a1; a += UNROLL) {
    uint32_t w[UNROLL][IW];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (a + u < a1) {
        const size_t row = static_cast<size_t>(a + u) * pblocks + b;
        load_run<IW * 4>(wq + row * row_words + k0 / C, w[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (a + u >= a1) break;
      const size_t row = static_cast<size_t>(a + u) * pblocks + b;
      float v[VC];
#pragma unroll
      for (int i = 0; i < VC; ++i) {
        const int c = kbase + i;  // one word (IW = 1): no runtime index
        v[i] = hqq_dq(word_code<CB>(w[u][IW == 1 ? 0 : c / C], c % C), s[i], z[i]);
      }
      Out* dst = out + row * k + k0;
      if (whole) {
        store_run<Out, VC>(dst, v);
      } else {
#pragma unroll
        for (int i = 0; i < VC; ++i) {
          if (k0 + i < k) store_run<Out, 1>(dst + i, v + i);
        }
      }
    }
  }
}

// ---- canonical QTensor ------------------------------------------------------
// Packed element e of pack block bb (e in [bb * PB, (bb + 1) * PB)) holds, in
// field f, the code of output element o = e + bb * block_skip + f * stride:
// packed row i of a block stores group-space rows f * SB + i of it (SB packed
// rows, RB = SB * r rows a block, PB = SB * C, block_skip = (RB - SB) * C,
// stride = SB * C). Outputs at or past `valid` = R * C are the zero rows that
// pad 3-bit to whole words: never written. Meta per row (axis=1: scale [R, 1]),
// per column (axis=0: [1, C]) or one scalar. A container of fp32, bf16 or fp16
// (packing=None) holds one code an element, as its value: one field, e = o.
struct CanonGeom {
  uint32_t positions;     // vectors of VC packed elements
  uint32_t valid;         // R * C
  uint32_t stride;        // SB * C
  uint32_t block_skip;    // (RB - SB) * C
  FastDiv per_block;      // PB
  FastDiv per_row;        // C
  uint32_t cols;          // C
  int fields, bits;       // r, and the bits of a field
  int meta_mode;          // 0 scalar, 1 per row, 2 per column
  // a stack of experts (blockIdx.y): the elements of codes, of scale (and of
  // zero) and of W between one expert and the next; 0 for a single QTensor
  uint32_t wq_stride, meta_stride, out_stride;
};

// containers that hold codes as values, not bitfields
template <typename Word>
constexpr bool kValueCodes = !std::is_integral<Word>::value;

// element t of the bytes in w (Word-sized), as the low bits of a word
template <typename Word>
__device__ __forceinline__ uint32_t element(const uint32_t* w, int t) {
  if constexpr (sizeof(Word) == 4) {
    return w[t];
  } else if constexpr (sizeof(Word) == 2) {
    return (w[t / 2] >> (16 * (t % 2))) & 0xffffu;
  } else {
    return (w[t / 4] >> (8 * (t % 4))) & 0xffu;
  }
}

// the code in element x: its field at shift, or its value (exact in fp32)
template <typename Word>
__device__ __forceinline__ float code_of(uint32_t x, int shift, uint32_t mask) {
  if constexpr (std::is_same<Word, float>::value) {
    return __uint_as_float(x);
  } else if constexpr (std::is_same<Word, __nv_bfloat16>::value) {
    return __uint_as_float(x << 16);
  } else if constexpr (std::is_same<Word, __half>::value) {
    return __half2float(__ushort_as_half(static_cast<unsigned short>(x)));
  } else {
    return static_cast<float>((x >> shift) & mask);
  }
}

template <typename Word, typename T, typename Out, int VC>
__global__ void __launch_bounds__(256)
    hqq_dequant_canonical_kernel(const Word* __restrict__ wq, const T* __restrict__ scale,
                                 const T* __restrict__ zero, Out* __restrict__ out,
                                 CanonGeom geo) {
  constexpr int IB = VC * static_cast<int>(sizeof(Word));  // packed bytes of a vector
  wq += static_cast<size_t>(blockIdx.y) * geo.wq_stride;
  scale += static_cast<size_t>(blockIdx.y) * geo.meta_stride;
  zero += static_cast<size_t>(blockIdx.y) * geo.meta_stride;
  out += static_cast<size_t>(blockIdx.y) * geo.out_stride;
  const uint32_t mask = (1u << geo.bits) - 1u;
  const int fields = kValueCodes<Word> ? 1 : geo.fields;
  const uint32_t lane = threadIdx.x & 31;
  const uint32_t warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const uint32_t warps = (gridDim.x * blockDim.x) >> 5;  // of one expert
  float s1 = 0.f, z1 = 0.f;
  if (geo.meta_mode == 0) s1 = meta_f32(scale[0]), z1 = meta_f32(zero[0]);
  for (uint32_t base = warp * 32 * kItems; base < geo.positions;
       base += warps * 32 * kItems) {
    uint32_t w[kItems][(IB + 3) / 4];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const uint32_t p = base + j * 32 + lane;
      if (p < geo.positions) load_run<IB>(wq + static_cast<size_t>(p) * VC, w[j]);
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const uint32_t p = base + j * 32 + lane;
      if (p >= geo.positions) break;
      const uint32_t e = p * VC;
      const uint32_t o0 = e + fdiv(e, geo.per_block) * geo.block_skip;
      uint32_t x[VC];  // the vector's packed elements
#pragma unroll
      for (int i = 0; i < VC; ++i) x[i] = element<Word>(w[j], i);
      // meta per column: the same columns in every field (stride % C == 0)
      float s[VC], z[VC];
      if (geo.meta_mode == 0) {
#pragma unroll
        for (int i = 0; i < VC; ++i) s[i] = s1, z[i] = z1;
      } else if (geo.meta_mode == 2) {
        const uint32_t col = o0 - fdiv(o0, geo.per_row) * geo.cols;
        load_meta<T, VC>(scale + col, s);
        load_meta<T, VC>(zero + col, z);
      }
      for (int f = 0; f < fields; ++f) {
        const uint32_t o = o0 + f * geo.stride;
        if (o >= geo.valid) break;  // the rows that pad 3-bit: later fields too
        if (geo.meta_mode == 1) {  // meta per row: a row of its own in each field
          const uint32_t row = fdiv(o, geo.per_row);
          const float sr = meta_f32(scale[row]), zr = meta_f32(zero[row]);
#pragma unroll
          for (int i = 0; i < VC; ++i) s[i] = sr, z[i] = zr;
        }
        const int shift = geo.bits * (fields - 1 - f);
        float v[VC];
#pragma unroll
        for (int i = 0; i < VC; ++i) {
          const float c = code_of<Word>(x[i], shift, mask);
          v[i] = round_as<T>(__fmul_rn(round_as<T>(__fsub_rn(c, z[i])), s[i]));
        }
        store_run<Out, VC>(out + o, v);
      }
    }
  }
}

// ---- host entries -----------------------------------------------------------

template <typename Meta, typename Out>
int launch_ax1(const void* wq, const void* scale, const void* zs, void* out, uint32_t vectors,
               FastDiv per_group, FastDiv per_row_groups, uint32_t pad, int cb, float zadd,
               int grid, cudaStream_t s) {
  const auto* q = static_cast<const uint32_t*>(wq);
  const auto* sc = static_cast<const Meta*>(scale);
  const auto* z = static_cast<const Meta*>(zs);
  auto* o = static_cast<Out*>(out);
  switch (cb) {
    case 8:
      hqq_dequant_kernel<Meta, Out, 8><<<grid, 256, 0, s>>>(q, sc, z, o, vectors, per_group,
                                                             per_row_groups, pad, zadd);
      break;
    case 4:
      hqq_dequant_kernel<Meta, Out, 4><<<grid, 256, 0, s>>>(q, sc, z, o, vectors, per_group,
                                                             per_row_groups, pad, zadd);
      break;
    case 2:
      hqq_dequant_kernel<Meta, Out, 2><<<grid, 256, 0, s>>>(q, sc, z, o, vectors, per_group,
                                                             per_row_groups, pad, zadd);
      break;
    case 1:
      hqq_dequant_kernel<Meta, Out, 1><<<grid, 256, 0, s>>>(q, sc, z, o, vectors, per_group,
                                                             per_row_groups, pad, zadd);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename Meta, typename Out>
int launch_ax0(const void* wq, const void* scale, const void* zs, void* out, int n, int k,
               int k_pad, int pblocks, int cb, int rows_per_block, int aligned, dim3 grid,
               cudaStream_t s) {
  const auto* q = static_cast<const uint32_t*>(wq);
  const auto* sc = static_cast<const Meta*>(scale);
  const auto* z = static_cast<const Meta*>(zs);
  auto* o = static_cast<Out*>(out);
  switch (cb) {
    case 8:
      hqq_dequant_ax0_kernel<Meta, Out, 8><<<grid, 128, 0, s>>>(q, sc, z, o, n, k, k_pad, pblocks,
                                                                 rows_per_block, aligned);
      break;
    case 4:
      hqq_dequant_ax0_kernel<Meta, Out, 4><<<grid, 128, 0, s>>>(q, sc, z, o, n, k, k_pad, pblocks,
                                                                 rows_per_block, aligned);
      break;
    case 2:
      hqq_dequant_ax0_kernel<Meta, Out, 2><<<grid, 128, 0, s>>>(q, sc, z, o, n, k, k_pad, pblocks,
                                                                 rows_per_block, aligned);
      break;
    case 1:
      hqq_dequant_ax0_kernel<Meta, Out, 1><<<grid, 128, 0, s>>>(q, sc, z, o, n, k, k_pad, pblocks,
                                                                 rows_per_block, aligned);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename Word, typename T, typename Out>
int launch_canonical(const void* wq, const void* scale, const void* zero, void* out,
                     const CanonGeom& geo, int vec, dim3 grid, cudaStream_t s) {
  const auto* q = static_cast<const Word*>(wq);
  const auto* sc = static_cast<const T*>(scale);
  const auto* z = static_cast<const T*>(zero);
  auto* o = static_cast<Out*>(out);
  constexpr int VC = 16 / sizeof(Out);
  if (vec == VC) {
    hqq_dequant_canonical_kernel<Word, T, Out, VC><<<grid, 256, 0, s>>>(q, sc, z, o, geo);
  } else if (vec == 1) {
    hqq_dequant_canonical_kernel<Word, T, Out, 1><<<grid, 256, 0, s>>>(q, sc, z, o, geo);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename Word, typename T>
int canonical_out(const void* wq, const void* scale, const void* zero, void* out,
                  const CanonGeom& geo, int vec, int out_dtype, dim3 grid, cudaStream_t s) {
  switch (out_dtype) {
    case HQQ_F32:
      return launch_canonical<Word, T, float>(wq, scale, zero, out, geo, vec, grid, s);
    case HQQ_BF16:
      return launch_canonical<Word, T, __nv_bfloat16>(wq, scale, zero, out, geo, vec, grid, s);
    case HQQ_F16:
      return launch_canonical<Word, T, __half>(wq, scale, zero, out, geo, vec, grid, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename Word>
int canonical_meta(const void* wq, const void* scale, const void* zero, void* out,
                   const CanonGeom& geo, int vec, int meta_dtype, int out_dtype, dim3 grid,
                   cudaStream_t s) {
  switch (meta_dtype) {
    case HQQ_F32:
      return canonical_out<Word, float>(wq, scale, zero, out, geo, vec, out_dtype, grid, s);
    case HQQ_BF16:
      return canonical_out<Word, __nv_bfloat16>(wq, scale, zero, out, geo, vec, out_dtype, grid,
                                                s);
    case HQQ_F16:
      return canonical_out<Word, __half>(wq, scale, zero, out, geo, vec, out_dtype, grid, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// meta_dtype: HQQ_F32 or HQQ_BF16, the type of scale and zs [N, C]
// (`hqq_ax1_meta_cols`); vectors = N*K / VC < 2^28; (g_mul, g_shift) divide by
// g, (r_mul, r_shift) by K/g; pad = C - K/g; all from `dequant_launch_plan`
HQQ_EXPORT int hqq_dequant(const void* wq, const void* scale, const void* zs, void* out,
                           unsigned vectors, unsigned g_mul, unsigned g_shift, unsigned r_mul,
                           unsigned r_shift, unsigned pad, int cb, int out_dtype, int meta_dtype,
                           int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const FastDiv pg{g_mul, g_shift}, pr{r_mul, r_shift};
  const float zadd = hqq_ax1_zs_offset(cb, meta_dtype);
#define HQQ_AX1(META)                                                                         \
  switch (out_dtype) {                                                                        \
    case HQQ_F32:                                                                             \
      return launch_ax1<META, float>(wq, scale, zs, out, vectors, pg, pr, pad, cb, zadd, grid, \
                                     s);                                                      \
    case HQQ_BF16:                                                                            \
      return launch_ax1<META, __nv_bfloat16>(wq, scale, zs, out, vectors, pg, pr, pad, cb,     \
                                             zadd, grid, s);                                  \
    case HQQ_F16:                                                                             \
      return launch_ax1<META, __half>(wq, scale, zs, out, vectors, pg, pr, pad, cb, zadd,      \
                                      grid, s);                                               \
    default:                                                                                  \
      return static_cast<int>(cudaErrorInvalidValue);                                         \
  }
  if (meta_dtype == HQQ_F32) {
    HQQ_AX1(float)
  } else if (meta_dtype == HQQ_BF16) {
    HQQ_AX1(__nv_bfloat16)
  }
#undef HQQ_AX1
  return static_cast<int>(cudaErrorInvalidValue);
}

// meta_dtype: HQQ_F32 or HQQ_BF16, the type of scale and zs [N/g, K_pad];
// scale, zs and out 16-byte aligned; grid and rows_per_block from
// `dequant_launch_plan`
HQQ_EXPORT int hqq_dequant_ax0(const void* wq, const void* scale, const void* zs, void* out,
                               int n, int k, int k_pad, int group_size, int cb, int out_dtype,
                               int meta_dtype, int grid_x, int grid_z, int rows_per_block,
                               int aligned, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int pblocks = n / group_size;
  const dim3 grid(grid_x, pblocks, grid_z);
#define HQQ_AX0(META)                                                                          \
  switch (out_dtype) {                                                                         \
    case HQQ_F32:                                                                              \
      return launch_ax0<META, float>(wq, scale, zs, out, n, k, k_pad, pblocks, cb,              \
                                     rows_per_block, aligned, grid, s);                        \
    case HQQ_BF16:                                                                             \
      return launch_ax0<META, __nv_bfloat16>(wq, scale, zs, out, n, k, k_pad, pblocks, cb,      \
                                             rows_per_block, aligned, grid, s);                \
    case HQQ_F16:                                                                              \
      return launch_ax0<META, __half>(wq, scale, zs, out, n, k, k_pad, pblocks, cb,             \
                                      rows_per_block, aligned, grid, s);                       \
    default:                                                                                   \
      return static_cast<int>(cudaErrorInvalidValue);                                          \
  }
  if (meta_dtype == HQQ_F32) {
    HQQ_AX0(float)
  } else if (meta_dtype == HQQ_BF16) {
    HQQ_AX0(__nv_bfloat16)
  }
#undef HQQ_AX0
  return static_cast<int>(cudaErrorInvalidValue);
}

// container: 1 (uint8 bitfields), 4 (3bit_32's int32 bitfields), or for
// packing=None the codes' own type, -1 - HQQ_F32, -1 - HQQ_BF16 or -1 - HQQ_F16;
// meta_dtype: the type T of scale and zero (HQQ_F32, HQQ_BF16 or HQQ_F16);
// vec: 16 / sizeof(out), or 1; the geometry from `dequant_canonical_plan`; a
// stack of `experts` QTensors one launch (grid: grid x experts), each expert's
// codes, meta and W `wq_stride`, `meta_stride` and `out_stride` elements after
// the one before
HQQ_EXPORT int hqq_dequant_canonical(const void* wq, const void* scale, const void* zero,
                                     void* out, unsigned positions, unsigned valid,
                                     unsigned stride, unsigned block_skip, unsigned block_mul,
                                     unsigned block_shift, unsigned cols, unsigned col_mul,
                                     unsigned col_shift, unsigned experts, unsigned wq_stride,
                                     unsigned meta_stride, unsigned out_stride, int fields,
                                     int bits, int meta_mode, int container, int vec,
                                     int meta_dtype, int out_dtype, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (experts < 1 || experts > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const CanonGeom geo{positions, valid, stride, block_skip, FastDiv{block_mul, block_shift},
                      FastDiv{col_mul, col_shift}, cols, fields, bits, meta_mode,
                      wq_stride, meta_stride, out_stride};
  const dim3 blocks(grid, experts);
#define HQQ_CANON(WORD) \
  return canonical_meta<WORD>(wq, scale, zero, out, geo, vec, meta_dtype, out_dtype, blocks, s)
  switch (container) {
    case 1:
      HQQ_CANON(uint8_t);
    case 4:
      HQQ_CANON(uint32_t);
    case -1 - HQQ_F32:
      HQQ_CANON(float);
    case -1 - HQQ_BF16:
      HQQ_CANON(__nv_bfloat16);
    case -1 - HQQ_F16:
      HQQ_CANON(__half);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef HQQ_CANON
}

HQQ_EXPORT const char* hqq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
