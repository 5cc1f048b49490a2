// SPDX-License-Identifier: Apache-2.0
// qmm_fp32: the fp32 route of the dequant-matmul kernels. For fp32
// activations, y[M, N] = x @ W^T (+ (x @ A) @ B) to fp32 accuracy:
// W[n, k] = code * scale - zs dequantized in fp32 (an fp32 multiply, then an
// fp32 subtract, as the plain version does), the product from three TF32
// tensor-core products, the LoRA term in fp32 on the CUDA cores, y in fp32.
// One templated kernel serves both kernel layouts and the LoRA term:
//   axis=1 (quant_matmul, quant_matmul_lora): codes [N, K*cb/8] in the word
//     layout of hqq_common.cuh, scale and zs [N, C] (`hqq_ax1_meta_cols`);
//   axis=0 (quant_matmul_ax0): codes [N, K_pad*cb/8], scale and zs
//     [N/g, K_pad], row n reading row n % (N/g);
// with scale and zs in fp32 or bf16 (widened to fp32 as they are read, the
// axis=1 4-bit container's zs given its 8*scale back: `hqq_ax1_zs_offset`).
//
// Replaces, for fp32 activations: hqq_tpu/ops/fused_matmul.py `_qmm_kernel`,
//   `_qmm_ax0_kernel`, `_qmm_ax0_cm_kernel` and `_qmm_lora_kernel`, which
//   take x in any type and multiply in it (`hqq_tpu`'s own training recipe
//   computes in fp32). The bf16/fp16 kernels of quant_matmul*.cu round x to
//   their type, which is no fp32 result.
// Bound on H100: operations. An fp32-accurate product from TF32 needs three
//   TF32 products, 3 * 2*M*N*K at 495 TFLOP/s: 0.104 ms at M=512,
//   K=N=4096 (against 0.256 ms for one fp32 product at the CUDA cores'
//   67 TFLOP/s).
// Design (3xTF32 on the Hopper mainloop of qmm_sm90.cuh, in slabs of 32
//   fp32, one 128-byte swizzle row): a producer warpgroup fills a ring of
//   `stages` slots by TMA with x's [BM x 32] fp32 slab, the slab's codes and
//   its scale and zs (cp.async where TMA's 16-byte rules fail), through the
//   layouts' hooks (`Ax1Layout<Meta, 32>`, `Ax0Layout<Meta, 32>`). Two
//   consumer warpgroups of 64 weight rows each take a slot, split x's slab
//   in place into big = tf32_rna(x) and small = tf32_rna(x - big) (each
//   consumer half the tokens, then a barrier of both), dequantize their
//   64 x 32 slab of W exactly as the plain version does and write
//   W_big and W_small, both rounded by `cvt.rna` (the tensor core is never
//   left to read the low bits of a raw fp32), as two 128-byte-swizzled
//   K-major tiles, and issue three chains of wgmma m64nBMk8 tf32,
//   part = W_big x_small + W_small x_big + W_big x_big (the small products
//   first) into zeroed accumulators, while they dequantize the next slab;
//   then acc += part in fp32 on the CUDA cores. Only small x small (about
//   2^-22 of a product) is dropped. The tensor core's fp32 accumulator
//   loses low bits as its sum grows: one chain over all of K (1536 wgmma
//   at K = 4096) read 3.6e-5 of max|y| against the fp32 twin, over the bar
//   of 1e-5; folded slab by slab it reads 1.3e-6 to 1.7e-6 (H100 80GB
//   HBM3, 700 W). y is stored from the accumulators (runs of 8
//   columns per 4 tokens a warp store); at decode sizes K is split over
//   gridDim.z into fp32 partials that `qmm_sum_splits` adds in order.
//   LoRA (axis=1): after the base's walk over K, one more walk per chunk of
//   8 ranks brings x's slab and A's [32 x 8] fp32 slab by TMA; each consumer
//   sums p = x @ A in fp32 for its half of the tokens into shared memory,
//   and at the chunk's end each thread adds sum_j p[m, j] * B[j, n] to its
//   fp32 sums. p computed inside the base's walk (from the raw slab, before
//   the split) cost the 128-token tile its registers: ptxas serialized the
//   wgmma of the LoRA instantiations (C7515) or spilled 32-96 bytes, for
//   0.37-0.39 ms at M=512, K=N=4096, r=8; the walks apart take 0.385 ms
//   with neither (H100 80GB HBM3, 700 W).
#include "qmm_sm90.cuh"

namespace {

using sm90::kBN;
using sm90::Params;
using sm90::WeightMaps;

constexpr int kKS = 32;                // K of a slab: one 128-byte swizzle row of fp32
constexpr int kRP = 8;                 // ranks of a chunk of the LoRA term
constexpr int kWTile = 64 * kKS * 4;   // a consumer's 64 x 32 fp32 tile (W_big or W_small)

// Shared-memory carve-up; ops/fused_matmul.py `qmm_fp32_smem_bytes`
// computes the same sizes.
struct Fp32Smem {
  int x, xs, a, lora, pbuf, codes, meta, bars, total;
};

__host__ __device__ inline Fp32Smem fp32_smem(int bm, int stages, int code_stage,
                                              int meta_stage, bool lora) {
  Fp32Smem s;
  s.x = 0;                                 // x's slab (TMA; then x_big in place), swizzled
  s.xs = stages * bm * 128;                // x_small of the slab, in the same swizzle
  s.a = s.xs + stages * bm * 128;          // per consumer two of (W_big, W_small)
  s.lora = s.a + 2 * 2 * 2 * kWTile;       // A's [32 x kRP] fp32 slab of each slot
  s.pbuf = s.lora + (lora ? stages * kKS * kRP * 4 : 0);  // p = x @ A, fp32 [bm][kRP]
  s.codes = s.pbuf + (lora ? bm * kRP * 4 : 0);
  s.meta = s.codes + stages * code_stage;
  s.bars = s.meta + stages * meta_stage;
  s.total = s.bars + 16 * stages + 1024;   // + slack to align the base to 1024
  return s;
}

// x's slab, rows [wg*BM/2, (wg+1)*BM/2), in place into its TF32 big part,
// its small part into xs (16-byte chunks: the swizzle does not matter)
template <int BM>
__device__ __forceinline__ void split_x(uint8_t* x, uint8_t* xs, int wg, int ct) {
  constexpr int kChunks = BM / 2 * 8;
  for (int c = ct; c < kChunks; c += 128) {
    const int off = (wg * kChunks + c) * 16;
    const float4 v = *reinterpret_cast<const float4*>(x + off);
    const float4 b = make_float4(sm90::tf32_rna(v.x), sm90::tf32_rna(v.y), sm90::tf32_rna(v.z),
                                 sm90::tf32_rna(v.w));
    *reinterpret_cast<float4*>(x + off) = b;
    *reinterpret_cast<float4*>(xs + off) = make_float4(
        sm90::tf32_rna(__fsub_rn(v.x, b.x)), sm90::tf32_rna(__fsub_rn(v.y, b.y)),
        sm90::tf32_rna(__fsub_rn(v.z, b.z)), sm90::tf32_rna(__fsub_rn(v.w, b.w)));
  }
}

// A consumer's 64 x 32 slab of W, dequantized as the plain version does and
// split into its TF32 big and small parts, written to the tiles wb and ws:
// each thread 8 codes (chunk q = ct % 4) of the rows ct/4 and ct/4 + 32
template <typename Layout, bool kBytes>
__device__ __forceinline__ void dequant_split(uint8_t* wb, uint8_t* ws, const uint8_t* codes,
                                              const uint8_t* meta, const int (&code_off)[2],
                                              const int (&meta_off)[2], int madd, int zs_off,
                                              float zadd, const sm90::ChunkCodes& cc, int ct) {
  const int q = ct % 4;
  float sc[8], z[8];
  if constexpr (Layout::kRowsShareMeta) Layout::meta8(meta, meta_off[0] + madd, zs_off, zadd, sc, z);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    uint32_t lo, hi;
    sm90::read_codes<kBytes>(codes + code_off[i], cc, lo, hi);
    if constexpr (!Layout::kRowsShareMeta)
      Layout::meta8(meta, meta_off[i] + madd, zs_off, zadd, sc, z);
    float b[8], s[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float v = __fsub_rn(__fmul_rn(sm90::code_f32(e < 4 ? lo : hi, e & 3), sc[e]), z[e]);
      b[e] = sm90::tf32_rna(v);
      s[e] = sm90::tf32_rna(__fsub_rn(v, b[e]));
    }
    const int r = ct / 4 + 32 * i;
    *reinterpret_cast<float4*>(wb + sm90::sw128(r, 2 * q)) = make_float4(b[0], b[1], b[2], b[3]);
    *reinterpret_cast<float4*>(wb + sm90::sw128(r, 2 * q + 1)) = make_float4(b[4], b[5], b[6], b[7]);
    *reinterpret_cast<float4*>(ws + sm90::sw128(r, 2 * q)) = make_float4(s[0], s[1], s[2], s[3]);
    *reinterpret_cast<float4*>(ws + sm90::sw128(r, 2 * q + 1)) = make_float4(s[4], s[5], s[6], s[7]);
  }
}

// The ranks of p = x @ A a consumer thread sums for one of its tokens
template <int BM>
struct LoraShare {
  static constexpr int kPJ = BM / 32 > 0 ? BM / 32 : 1;  // ranks a thread
  static constexpr int kPerToken = kRP / kPJ;             // threads a token
};

// The thread's kPJ ranks of p for its token (where it has one: consumer
// wg's half of the tokens), over the raw slab x and slot s of A's [32 x kRP]
// slabs, added to its own entries of p in shared memory (from zero where
// `first`): p holds no registers across the walk.
template <int BM>
__device__ __forceinline__ void lora_partial(float* pb, const uint8_t* x, const uint8_t* a_slots,
                                             int s, int wg, int ct, bool first) {
  constexpr int kPJ = LoraShare<BM>::kPJ, kPerToken = LoraShare<BM>::kPerToken;
  static_assert(kPJ == 1 || kPJ == 2 || kPJ == 4, "a thread's ranks: one vector load a row");
  if (ct / kPerToken >= BM / 2) return;
  const int m = wg * (BM / 2) + ct / kPerToken, j0 = ct % kPerToken * kPJ;
  float* dst = pb + m * kRP + j0;
  float pacc[kPJ];
#pragma unroll
  for (int j = 0; j < kPJ; ++j) pacc[j] = first ? 0.f : dst[j];
  const float* a = reinterpret_cast<const float*>(a_slots + s * kKS * kRP * 4);
#pragma unroll
  for (int c = 0; c < kKS / 4; ++c) {
    const float4 v = *reinterpret_cast<const float4*>(x + sm90::sw128(m, c));
    const float xv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* row = a + (4 * c + e) * kRP + j0;  // 4 * kPJ-byte aligned
      float av[kPJ];
      if constexpr (kPJ == 4) {
        const float4 t = *reinterpret_cast<const float4*>(row);
        av[0] = t.x, av[1] = t.y, av[2] = t.z, av[3] = t.w;
      } else if constexpr (kPJ == 2) {
        const float2 t = *reinterpret_cast<const float2*>(row);
        av[0] = t.x, av[1] = t.y;
      } else {
        av[0] = row[0];
      }
#pragma unroll
      for (int j = 0; j < kPJ; ++j) pacc[j] = fmaf(xv[e], av[j], pacc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kPJ; ++j) dst[j] = pacc[j];
}

// The LoRA term of one chunk of kRP ranks from r0, added to the consumer's
// fp32 sums once p of every token is in shared memory: each thread adds
// sum_j p[m, j] * B[r0 + j, n] to its outputs (the two weight rows n of the
// accumulator layout). Both consumers call it.
template <int BM, typename Layout>
__device__ __forceinline__ void lora_add(float (&acc)[BM / 2], const float* pb, const Params& p,
                                         int p0, int wg, int r0) {
  sm90::named_sync<256>(3);  // p of every token
  const int ct = threadIdx.x % 128, warp = ct / 32, lane = ct % 32;
  float bv[2][kRP];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int col = Layout::column(p, p0, wg * 64 + warp * 16 + lane / 4 + 8 * h);
#pragma unroll
    for (int j = 0; j < kRP; ++j)
      bv[h][j] = col >= 0 && r0 + j < p.rank
                     ? __ldg(p.lb + static_cast<size_t>(r0 + j) * p.n + col)
                     : 0.f;
  }
#pragma unroll
  for (int j = 0; j < BM / 8; ++j)
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const float* pm = pb + (8 * j + 2 * (lane % 4) + (h & 1)) * kRP;
      float t = 0.f;
#pragma unroll
      for (int jj = 0; jj < kRP; ++jj) t = fmaf(pm[jj], bv[h >> 1][jj], t);
      acc[4 * j + h] += t;
    }
  sm90::named_sync<256>(3);  // p read by all before the next chunk rewrites it
}

template <int BM, typename Layout, bool kLora>
__global__ void __launch_bounds__(sm90::kThreads, 1)
    qmm_fp32_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap cmap,
                    const __grid_constant__ CUtensorMap smap,
                    const __grid_constant__ CUtensorMap zmap,
                    const __grid_constant__ CUtensorMap amap, const Params p) {
  using namespace sm90;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~static_cast<uintptr_t>(1023));
  const Fp32Smem L = fp32_smem(BM, p.stages, p.code_stage, p.meta_stage, kLora);
  const uint32_t full0 = smem_u32(smem + L.bars);
  const uint32_t empty0 = full0 + 8 * p.stages;

  const int p0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * BM;
  const int kb = blockIdx.z * p.slabs_per_split;
  const int nslab = min(p.slabs, kb + p.slabs_per_split) - kb;
  // the first nslab slabs carry the base, each further nslab one chunk of p
  const int iters = (kLora ? 1 + p.passes : 1) * nslab;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full0 + 8 * s, 128 + 1);  // the producers' cp.async + the TMA's expect_tx
      mbar_init(empty0 + 8 * s, 2);       // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    const int tid = threadIdx.x;
    for (int it = 0; it < iters; ++it) {
      const int s = it % p.stages;
      const bool base = !kLora || it < nslab;
      mbar_wait(empty0 + 8 * s, ((it / p.stages) & 1) ^ 1);
      const int k0 = (kb + it % nslab) * kKS;
      const uint32_t full = full0 + 8 * s;
      const uint32_t codes = smem_u32(smem + L.codes + s * p.code_stage);
      const uint32_t meta = smem_u32(smem + L.meta + s * p.meta_stage);
      if (tid == 0) {
        mbar_expect_tx(full, base ? p.tx_bytes : BM * 128 + kKS * kRP * 4);  // else x and A
        tma_load_2d(smem_u32(smem + L.x + s * BM * 128), &xmap, full, k0, m0);
        if (!base)
          tma_load_2d(smem_u32(smem + L.lora + s * kKS * kRP * 4), &amap, full,
                      (it / nslab - 1) * kRP, k0);
        if (base && p.codes_tma) {
          int c[3];
          Layout::code_coords(p, p0, k0, c);
          tma_load_3d(codes, &cmap, full, c[0], c[1], c[2]);
        }
        if (base && p.meta_tma) {
          int c[2];
          Layout::meta_coords(p, p0, k0, c);
          tma_load_2d(meta, &smap, full, c[0], c[1]);
          tma_load_2d(meta + p.meta_stage / 2, &zmap, full, c[0], c[1]);
        }
      }
      if (base && (!p.codes_tma || !p.meta_tma)) Layout::load_slab(p, p0, k0, codes, meta, tid);
      cp_async_arrive(full);
    }
  } else {
    // ---- consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
    const int wg = threadIdx.x / 128 - 1;
    const int ct = threadIdx.x % 128;
    const int q = ct % 4;  // the thread's 8 codes of each row it dequantizes
    const ChunkCodes cc = chunk_codes(q, p.cb);
    int code_off[2], meta_off[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int pr = wg * 64 + ct / 4 + 32 * i;  // tile row
      code_off[i] = Layout::code_row(p, pr) * (kKS / 8) * p.cb;
      meta_off[i] = Layout::meta_offset(p, p0, pr, q);
    }
    const int zs_off = Layout::zs_offset(p);
    const float zadd = Layout::zs_add(p);
    uint8_t* a_tiles = smem + L.a + wg * 4 * kWTile;  // [buffer][big, small]

    // acc: the sum over the slabs done, in fp32 on the CUDA cores; part: one
    // slab's three product chains, in the tensor core's accumulator
    float acc[BM / 2], part[BM / 2];
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f, part[i] = 0.f;
    float* pb = reinterpret_cast<float*>(smem + L.pbuf);  // LoRA: p [BM][kRP]

    // the walk over K with the base
    for (int it = 0; it < nslab; ++it) {
      const int s = it % p.stages;
      mbar_wait(full0 + 8 * s, (it / p.stages) & 1);
      uint8_t* xb = smem + L.x + s * BM * 128;
      uint8_t* xsm = smem + L.xs + s * BM * 128;
      split_x<BM>(xb, xsm, wg, ct);
      const uint8_t* codes = smem + L.codes + s * p.code_stage;
      const uint8_t* meta = smem + L.meta + s * p.meta_stage;
      const int madd = Layout::meta_add(p, (kb + it) * kKS, q);
      uint8_t* wb = a_tiles + (it & 1) * 2 * kWTile;
      if (p.cb == 8)
        dequant_split<Layout, true>(wb, wb + kWTile, codes, meta, code_off, meta_off, madd, zs_off,
                                    zadd, cc, ct);
      else
        dequant_split<Layout, false>(wb, wb + kWTile, codes, meta, code_off, meta_off, madd,
                                     zs_off, zadd, cc, ct);
      fence_proxy_async();
      if (it > 0) {  // the previous slab's products, folded into acc; its slot is free
        wgmma_wait<0>();
        fence_acc(part);
#pragma unroll
        for (int i = 0; i < BM / 2; ++i) acc[i] += part[i];
        if (ct == 0) mbar_arrive(empty0 + 8 * ((it - 1) % p.stages));
      }
      named_sync<256>(3);  // both halves of x split, this consumer's tiles written

      const uint64_t dxb = sw128_desc(smem_u32(xb)), dxs = sw128_desc(smem_u32(xsm));
      const uint64_t dwb = sw128_desc(smem_u32(wb)), dws = sw128_desc(smem_u32(wb + kWTile));
#pragma unroll
      for (int i = 0; i < BM / 2; ++i) part[i] = 0.f;
      fence_acc(part);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kKS / 8; ++ks) wgmma<float, BM>(part, dwb + 2 * ks, dxs + 2 * ks);
#pragma unroll
      for (int ks = 0; ks < kKS / 8; ++ks) wgmma<float, BM>(part, dws + 2 * ks, dxb + 2 * ks);
#pragma unroll
      for (int ks = 0; ks < kKS / 8; ++ks) wgmma<float, BM>(part, dwb + 2 * ks, dxb + 2 * ks);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_acc(part);
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) acc[i] += part[i];
    if constexpr (kLora) {
      if (ct == 0) mbar_arrive(empty0 + 8 * ((nslab - 1) % p.stages));
      // then for each chunk of kRP ranks a walk over K for p alone
      for (int it = nslab; it < iters; ++it) {
        const int s = it % p.stages;
        mbar_wait(full0 + 8 * s, (it / p.stages) & 1);
        lora_partial<BM>(pb, smem + L.x + s * BM * 128, smem + L.lora, s, wg, ct,
                         it % nslab == 0);
        named_sync(1 + wg);  // the slot is read before it is released
        if (ct == 0) mbar_arrive(empty0 + 8 * s);
        if (it % nslab == nslab - 1)
          lora_add<BM, Layout>(acc, pb, p, p0, wg, (it / nslab - 1) * kRP);
      }
    }
    // ---- epilogue: from the accumulators, row n = warp*16 + lane/4 (+8) of
    // the warpgroup's 64, token 8j + 2*(lane%4) (+1): a warp store is 4
    // tokens by 8 consecutive rows, 8 consecutive columns of y where the
    // layout keeps them in runs
    const int warp = ct / 32, lane = ct % 32;
    int col[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) col[h] = Layout::column(p, p0, wg * 64 + warp * 16 + lane / 4 + 8 * h);
    float* out = p.part != nullptr ? p.part + static_cast<size_t>(blockIdx.z) * p.m * p.n
                                   : static_cast<float*>(p.out);
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int m = m0 + 8 * j + 2 * (lane % 4) + (h & 1);
        if (m < p.m && col[h >> 1] >= 0) out[static_cast<size_t>(m) * p.n + col[h >> 1]] = acc[4 * j + h];
      }
  }
}

template <int BM, typename Layout, bool kLora>
int launch_tile(const void* x, int kx, Params p, const WeightMaps& w, int splits, int smem,
                cudaStream_t s) {
  CUtensorMap map;  // x fp32 [m, kx] as boxes of [BM x 32] in the 128-byte swizzle
  const long dims[2] = {kx, p.m}, strides[1] = {4L * kx};
  const int box[2] = {kKS, BM};
  int e = sm90::encode_map(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, x, dims, strides, box,
                           CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != 0) return e;
  p.tx_bytes = BM * 128 + (p.codes_tma ? p.code_stage : 0) +
               (p.meta_tma ? p.meta_stage : 0);
  if (smem < fp32_smem(BM, p.stages, p.code_stage, p.meta_stage, kLora).total)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = qmm_fp32_kernel<BM, Layout, kLora>;
  e = static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (e != 0) return e;
  dim3 grid(p.tiles, (p.m + BM - 1) / BM, splits);
  kernel<<<grid, sm90::kThreads, smem, s>>>(map, w.codes, w.scale, w.zs, w.lora_a, p);
  e = static_cast<int>(cudaGetLastError());
  if (e != 0 || splits == 1) return e;
  const size_t count = static_cast<size_t>(p.m) * p.n;
  const int blocks = static_cast<int>((count + 255) / 256 < 1024 ? (count + 255) / 256 : 1024);
  sm90::qmm_sum_splits<<<blocks, 256, 0, s>>>(p.part, p.out, count, splits, HQQ_F32);
  return static_cast<int>(cudaGetLastError());
}

template <typename Layout, bool kLora>
int launch(const void* x, int kx, const Params& p, const WeightMaps& w, int bm, int splits,
           int smem, cudaStream_t s) {
  if (splits < 1 || (splits > 1 && p.part == nullptr) || p.stages < 2 || p.code_vec == 0 ||
      p.meta_vec == 0 || kx % 4 != 0 || (splits - 1) * p.slabs_per_split >= p.slabs ||
      splits * p.slabs_per_split < p.slabs ||
      (kLora && (p.lb == nullptr || p.rank < 1 || p.passes * kRP < p.rank)))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (bm) {
    case 8: return launch_tile<8, Layout, kLora>(x, kx, p, w, splits, smem, s);
    case 32: return launch_tile<32, Layout, kLora>(x, kx, p, w, splits, smem, s);
    case 64: return launch_tile<64, Layout, kLora>(x, kx, p, w, splits, smem, s);
    case 128: return launch_tile<128, Layout, kLora>(x, kx, p, w, splits, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename Meta>
int launch_meta(const void* x, const void* wq, const void* scale, const void* zs, const void* a,
                const void* lb, void* out, void* part, int m, int n, int kx, int k_pad, int g,
                int cb, int axis, int rank, int passes, int token_tile, int stages, int splits,
                int slabs_per_split, int smem, cudaStream_t s) {
  Params p{};
  WeightMaps w{};
  const int e = axis == 1 ? sm90::ax1_params<Meta, kKS>(p, w, wq, scale, zs, n, kx, g, cb)
                          : sm90::ax0_params<Meta, kKS>(p, w, wq, scale, zs, n, k_pad, g, cb);
  if (e != 0) return static_cast<int>(cudaErrorInvalidValue);
  p.out = out;
  p.part = splits > 1 ? static_cast<float*>(part) : nullptr;
  p.m = m;
  p.slabs_per_split = slabs_per_split;
  p.stages = stages;
  p.out_dtype = HQQ_F32;
  if (axis == 0) return launch<sm90::Ax0Layout<Meta, kKS>, false>(x, kx, p, w, token_tile, splits,
                                                                   smem, s);
  if (rank == 0) return launch<sm90::Ax1Layout<Meta, kKS>, false>(x, kx, p, w, token_tile, splits,
                                                                  smem, s);
  p.lb = static_cast<const float*>(lb);
  p.rank = rank, p.passes = passes;
  // A fp32 [k, passes*kRP], zero past the rank, as boxes of [32 x kRP]
  const long dims[2] = {1L * passes * kRP, kx}, strides[1] = {4L * passes * kRP};
  const int box[2] = {kRP, kKS};
  if (sm90::encode_map(&w.lora_a, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, a, dims, strides, box,
                       CU_TENSOR_MAP_SWIZZLE_NONE) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<sm90::Ax1Layout<Meta, kKS>, true>(x, kx, p, w, token_tile, splits, smem, s);
}

}  // namespace

// x fp32 [m, kx] (kx = K for axis 1; K <= kx <= k_pad, a multiple of 4, for
// axis 0) and out fp32 [m, n], contiguous and 16-byte aligned; axis 1: wq
// [n, k*cb/8], scale and zs [n, hqq_ax1_meta_cols(k/g)]; axis 0: wq
// [n, k_pad*cb/8], scale and zs [n/g, k_pad]; meta_dtype HQQ_F32 or
// HQQ_BF16. rank 0: no adapter; else (axis 1) a fp32 [k, passes*8], zero
// past the rank, and lb fp32 [rank, n]. token_tile, stages, splits,
// slabs_per_split and smem come from the launch plan
// (`qmm_fp32_launch_plan`); with splits > 1, part is fp32 scratch of
// splits*m*n elements.
HQQ_EXPORT int hqq_qmm_fp32(const void* x, const void* wq, const void* scale, const void* zs,
                            const void* a, const void* lb, void* out, void* part, int m, int n,
                            int kx, int k_pad, int group_size, int cb, int axis, int meta_dtype,
                            int rank, int passes, int token_tile, int stages, int splits,
                            int slabs_per_split, int smem, void* stream) {
  if (m < 1 || n < 1 || kx < 1 || (cb != 1 && cb != 2 && cb != 4 && cb != 8) ||
      (axis != 0 && axis != 1) || rank < 0 || (rank > 0 && (axis != 1 || a == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
#define HQQ_FP32_LAUNCH(Meta)                                                                    \
  return launch_meta<Meta>(x, wq, scale, zs, a, lb, out, part, m, n, kx, k_pad, group_size, cb, \
                           axis, rank, passes, token_tile, stages, splits, slabs_per_split,      \
                           smem, s)
  if (meta_dtype == HQQ_F32) HQQ_FP32_LAUNCH(float);
  if (meta_dtype == HQQ_BF16) HQQ_FP32_LAUNCH(__nv_bfloat16);
#undef HQQ_FP32_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

HQQ_EXPORT const char* hqq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
