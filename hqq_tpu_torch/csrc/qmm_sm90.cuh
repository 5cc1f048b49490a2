// SPDX-License-Identifier: Apache-2.0
// The Hopper mainloop of the fused dequant-matmul kernels (quant_matmul.cu,
// quant_matmul_ax0.cu, quant_matmul_lora.cu): TMA, wgmma and an mbarrier
// pipeline, in the PTX of sm90_ptx.cuh.
//
// The operands are swapped: wgmma's 64-row A side takes dequantized weight
// rows (output features), its N side takes a tile of BM tokens, so a block
// computes D = W_tile . x_tile^T, the transposed 128 x BM tile of y, with
// both operands K-major in shared memory. BM is 8 at decode and up to 256
// at prefill (8, 32, 64, 128, 256), so a few tokens waste no tensor-core
// rows.
//
// A block is three warpgroups: a producer and two consumers of 64 weight
// rows each. K is walked in slabs of 64 through a ring of `stages` slots,
// each with a full and an empty mbarrier:
//   producer   waits for the slot to be empty and loads x's [BM x 64]
//              slab by one TMA (128-byte swizzle; rows past M and columns
//              past K arrive as zeros), the slab's packed codes by a second
//              and its scale and zs by two more, all counted on the slot's
//              full barrier by bytes. Where a weight breaks TMA's 16-byte
//              rules (1-bit codes, odd strides, odd groups) its 128
//              threads copy that part by cp.async instead (zero-filled
//              past the tensor), each arriving on the barrier when its
//              copies land. TMA first: per-row cp.async of 4 to 16 bytes
//              for everything took 0.108 ms against TMA's 0.055 at M=512,
//              K=N=4096 (H100 80GB HBM3, 700 W);
//   consumers  wait for the slot to be full, dequantize their 64 x 64
//              weight slab from shared memory into one of two A tiles (in
//              the swizzle the descriptor declares), fence the generic
//              proxy against the async one, issue four m64nBMk16 wgmma on
//              it and x's slab, and wait for the previous slab's wgmma
//              only, so the dequantization of slab s overlaps the products
//              of slab s-1; then they release that slab's slot.
// The epilogue transposes the fp32 accumulators through shared memory and
// stores y in 16-byte rows (or an fp32 partial when K is split over
// gridDim.z; `qmm_sum_splits` adds the partials in a fixed order).
//
// The LoRA kernel (RP > 0) rides the same ring: a slot also holds A^T's
// [RP x 64] slab (x's type, by TMA, in x's swizzle), a consumer multiplies
// 64 token rows of x's slab by it into p = x @ A (wgmma with x as the
// 64-row side), and after each walk over K (one per chunk of RP ranks; only
// the first dequantizes) p @ B is added to the fp32 accumulators
// (`lora_term`).
//
// A layout (`Ax1Layout<Meta>` and `Ax0Layout<Meta>` below, which qmm_fp32.cu
// takes too, with slabs of 32) supplies how a slab's codes and meta are
// loaded, where a row's scale and zs sit, and which column of y a weight row
// is. The dequantized operand is
// bit-identical to the plain version's (an fp32 multiply, then an fp32
// subtract, rounded to x's type), so only the order of the fp32 sums
// differs.
#pragma once

#include "sm90_ptx.cuh"

namespace sm90 {

constexpr int kBN = 128;       // weight rows of a block (two consumer warpgroups)
constexpr int kBK = 64;        // K of a slab: one 128-byte swizzle row of bf16
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kATile = 64 * kBK * 2;  // one consumer's dequantized 64 x 64 slab

// What the host computes once per launch and the kernel reads.
struct Params {
  const uint8_t* wq;
  const void* scale;
  const void* zs;
  void* out;
  float* part;      // fp32 [splits, M, N] when K is split, else null
  int m, n;         // tokens, weight rows (output features)
  int tiles;        // blocks along the weight rows (gridDim.x)
  int b_tiles;      // axis=0: tiles along b (the rows of scale and zs)
  int row_bytes;    // bytes of one packed code row
  int meta_cols;    // axis=1: groups per row (K/g); axis=0: K_pad
  int group_size, cb, pblocks;
  int code_vec, meta_vec;  // cp.async sizes (4, 8 or 16 bytes)
  int meta_rows;           // axis=0: rows of scale and zs a tile reads (its b rows)
  int slab_groups;         // axis=1: groups of a slab row a slot holds (at least 4)
  int meta_shift;          // axis=1: g neither divides nor is divided by 64
  int group_log2;          // log2(g) where g is a power of two, else -1
  int codes_tma, meta_tma; // 1: the slab's codes / scale and zs come by TMA
  int tx_bytes;            // bytes the TMA loads of a slot deliver
  int slabs, slabs_per_split, stages;
  int code_stage, meta_stage;  // bytes of a slot's codes and meta
  int out_dtype;
  // LoRA (a kernel with RP > 0): B fp32 [rank, N]; the rank is walked in
  // `passes` chunks of RP, each a walk over K (the first with the base)
  const float* lb;
  int rank, passes;
};

// Shared-memory carve-up; ops/fused_matmul.py `qmm_launch_plan` computes the
// same sizes.
struct SmemLayout {
  int x, scratch, per_wg, lora, pbuf, codes, meta, bars, total;
};

// rp: the LoRA kernel's rank chunk (0 without an adapter)
__host__ __device__ inline SmemLayout smem_layout(int bm, int stages, int code_stage,
                                                  int meta_stage, int rp = 0) {
  SmemLayout s;
  s.x = 0;
  s.scratch = stages * bm * 128;
  // two A tiles, or the epilogue's [BM x 64] staging of y in x's type (an
  // fp32 partial, or the LoRA term's, needs BM <= 64 or 64 tokens at a time)
  s.per_wg = 2 * kATile > bm * 128 ? 2 * kATile : bm * 128;
  s.lora = s.scratch + 2 * s.per_wg;     // slots of A^T's [rp x 64] slab, swizzled
  s.pbuf = s.lora + stages * rp * 128;   // p = x @ A of the tile, fp32 [bm][rp]
  s.codes = s.pbuf + bm * rp * 4;
  s.meta = s.codes + stages * code_stage;
  s.bars = s.meta + stages * meta_stage;
  s.total = s.bars + 16 * stages + 1024;  // + slack to align the base to 1024
  return s;
}

// -------------------------------------------------------------- dequant --

// byte e of w as an exact float: 2^23 + code, less 2^23
__device__ __forceinline__ float code_f32(uint32_t w, int e) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540u | e)) - 8388608.f;
}

// Eight codes k = 8q..8q+7 of a packed row (word layout of hqq_common.cuh)
// as two words of four byte-wide codes each.
struct ChunkCodes {
  int offset;  // byte offset of the chunk's word(s) within a slab row
  int shift;
  uint32_t mask;
  int cb;
};

__device__ __forceinline__ ChunkCodes chunk_codes(int q, int cb) {
  ChunkCodes c;
  if (cb == 8) {
    c.offset = 8 * q, c.shift = 0;
  } else {
    const int per_word = 4 / cb;  // chunks of 8 codes in a 32-bit word
    c.offset = 4 * (q / per_word);
    c.shift = cb * 2 * (q % per_word);
  }
  c.mask = ((1u << cb) - 1u) * 0x01010101u;
  c.cb = cb;
  return c;
}

template <bool kBytes>  // 8-bit codes: one byte each, no shift or mask
__device__ __forceinline__ void read_codes(const uint8_t* row, const ChunkCodes& c, uint32_t& lo,
                                           uint32_t& hi) {
  if (kBytes) {
    const uint2 w = *reinterpret_cast<const uint2*>(row + c.offset);
    lo = w.x, hi = w.y;
  } else {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(row + c.offset) >> c.shift;
    lo = w & c.mask, hi = (w >> c.cb) & c.mask;
  }
}

// A consumer's 64 x 64 weight slab, dequantized from the slot into its A
// tile a (each thread 8 codes of 4 rows; where the layout says the four
// rows share their scale and zs, as axis=0's do, they are read once).
// kBytes is a template argument so that the hot loop carries no branch on
// the container.
template <typename T, typename Layout, bool kBytes>
__device__ __forceinline__ void dequant_tile(uint8_t* a, const uint8_t* codes, const uint8_t* meta,
                                             const int (&code_off)[4], const int (&meta_off)[4],
                                             int madd, int zs_off, float zadd, const ChunkCodes& cc,
                                             int ct) {
  const int q = ct % 8;
  float sc[8], z[8];
  if constexpr (Layout::kRowsShareMeta) Layout::meta8(meta, meta_off[0] + madd, zs_off, zadd, sc, z);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t lo, hi;
    read_codes<kBytes>(codes + code_off[i], cc, lo, hi);
    if constexpr (!Layout::kRowsShareMeta)
      Layout::meta8(meta, meta_off[i] + madd, zs_off, zadd, sc, z);
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = __fsub_rn(__fmul_rn(code_f32(e < 4 ? lo : hi, e & 3), sc[e]), z[e]);
    const int r = i * 16 + ct / 8;
    *reinterpret_cast<uint4*>(a + sw128(r, q)) =
        make_uint4(pack2<T>(v[0], v[1]), pack2<T>(v[2], v[3]), pack2<T>(v[4], v[5]),
                   pack2<T>(v[6], v[7]));
  }
}

// The LoRA term of one rank chunk, added to the accumulators (after the
// chunk's walk over K, no wgmma in flight): p = x @ A of the tile goes to
// shared memory; then, 64 tokens at a time, the consumer's fp32
// accumulators go to its A tiles (free until the next slab), each thread
// adds sum_j p[m, j] * B[r0 + j, n] in fp32 to the outputs of one column n
// there, 8 ranks at a time, and the accumulators are read back. Loops over
// shared memory, not over register arrays, so the term holds no registers
// beyond the accumulators.
template <int BM, int RP>
__device__ __forceinline__ void lora_term(float (&acc)[BM / 2], const float (&pacc)[RP / 2],
                                          float* pb, float* st, bool lora_rows, int tok0,
                                          const Params& p, int col0, int r0, bool again) {
  constexpr int kRows = BM > 64 ? 64 : BM;  // tokens staged at a time: 16 KB of fp32
  const int ct = threadIdx.x % 128, warp = ct / 32, lane = ct % 32;
  const int wg_bar = threadIdx.x / 128;  // this consumer's barrier, 1 + wg
  if (lora_rows) {
#pragma unroll
    for (int j = 0; j < RP / 8; ++j)
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int tok = tok0 + warp * 16 + lane / 4 + 8 * (h >> 1);
        if (tok < BM) pb[tok * RP + 8 * j + 2 * (lane % 4) + (h & 1)] = pacc[4 * j + h];
      }
  }
  named_sync<256>(3);  // both consumers: p complete
  const int n = ct % 64, col = col0 + n;
  const int rc = min(RP, p.rank - r0);
#pragma unroll
  for (int t0 = 0; t0 < BM; t0 += kRows) {
#pragma unroll
    for (int j = t0 / 8; j < (t0 + kRows) / 8; ++j)  // st [kRows tokens][64 weight rows]
#pragma unroll
      for (int h = 0; h < 4; ++h)
        st[(8 * j - t0 + 2 * (lane % 4) + (h & 1)) * 64 + warp * 16 + lane / 4 + 8 * (h >> 1)] =
            acc[4 * j + h];
    named_sync(wg_bar);
    for (int j0 = 0; j0 < rc; j0 += 8) {
      float b[8];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        b[jj] = j0 + jj < rc && col < p.n
                    ? __ldg(p.lb + static_cast<size_t>(r0 + j0 + jj) * p.n + col)
                    : 0.f;
      for (int m = ct / 64; m < kRows; m += 2) {
        const float* pm = pb + (t0 + m) * RP + j0;
        float t = 0.f;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) t = fmaf(pm[jj], b[jj], t);
        st[m * 64 + n] += t;
      }
    }
    named_sync(wg_bar);
#pragma unroll
    for (int j = t0 / 8; j < (t0 + kRows) / 8; ++j)
#pragma unroll
      for (int h = 0; h < 4; ++h)
        acc[4 * j + h] =
            st[(8 * j - t0 + 2 * (lane % 4) + (h & 1)) * 64 + warp * 16 + lane / 4 + 8 * (h >> 1)];
    // every warp has read st back before the next tokens, or the epilogue
    // (which stages y in the same bytes), rewrite it
    named_sync(wg_bar);
  }
  if (again) named_sync<256>(3);  // the next chunk rewrites pb
}

// RP: 0, or the rank chunk of the LoRA kernel (16 or 64): a pass over K
// also brings A^T's [RP x 64] slab into the slot, and a consumer multiplies
// 64 of the tile's token rows by it into RP/2 more accumulators a thread
// (wgmma m64nRPk16 with x's slab as the A side). Both consumers take 64
// rows at BM = 128; at BM <= 64 the first takes them all. There the A side's
// rows past BM read past the slot (the next slots, which TMA may be
// filling, or the first A tiles, which may be being dequantized): a row of the product depends only on its
// own row of A, and the rows past BM are never stored, so what they read
// does not matter.
template <typename T, int BM, typename Layout, int RP = 0>
__global__ void __launch_bounds__(kThreads, 1)
    qmm_sm90_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap cmap,
                    const __grid_constant__ CUtensorMap smap,
                    const __grid_constant__ CUtensorMap zmap,
                    const __grid_constant__ CUtensorMap amap, const Params p) {
  static_assert(RP == 0 || (BM <= 128 && RP % 16 == 0), "LoRA tiles: BM <= 128, RP of 16s");
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~static_cast<uintptr_t>(1023));
  const SmemLayout L = smem_layout(BM, p.stages, p.code_stage, p.meta_stage, RP);
  const uint32_t full0 = smem_u32(smem + L.bars);
  const uint32_t empty0 = full0 + 8 * p.stages;

  const int p0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * BM;
  const int kb = blockIdx.z * p.slabs_per_split;
  const int nslab = min(p.slabs, kb + p.slabs_per_split) - kb;
  const int iters = (RP > 0 ? p.passes : 1) * nslab;  // the first nslab carry the base

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
      const bool base = RP == 0 || it < nslab;  // the base's slabs
      mbar_wait(empty0 + 8 * s, ((it / p.stages) & 1) ^ 1);
      const int k0 = (kb + (RP > 0 ? it % nslab : it)) * kBK;
      const uint32_t full = full0 + 8 * s;
      const uint32_t codes = smem_u32(smem + L.codes + s * p.code_stage);
      const uint32_t meta = smem_u32(smem + L.meta + s * p.meta_stage);
      if (tid == 0) {
        mbar_expect_tx(full, base ? p.tx_bytes : (BM + RP) * 128);  // else x and A^T alone
        tma_load_2d(smem_u32(smem + L.x + s * BM * 128), &xmap, full, k0, m0);
        if constexpr (RP > 0)
          tma_load_2d(smem_u32(smem + L.lora + s * RP * 128), &amap, full, k0, it / nslab * RP);
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
    const int q = ct % 8;  // the thread's 16-byte chunk of each row it dequantizes
    const ChunkCodes cc = chunk_codes(q, p.cb);
    int code_off[4], meta_off[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int pr = wg * 64 + i * 16 + ct / 8;  // tile row
      code_off[i] = Layout::code_row(p, pr) * 8 * p.cb;
      meta_off[i] = Layout::meta_offset(p, p0, pr, q);
    }
    const int zs_off = Layout::zs_offset(p);
    const float zadd = Layout::zs_add(p);
    uint8_t* a_tiles = smem + L.scratch + wg * L.per_wg;

    float acc[BM / 2];
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;
    float pacc[RP > 0 ? RP / 2 : 1];
    const bool lora_rows = RP > 0 && (BM == 128 || wg == 0);
    const int tok0 = BM == 128 ? wg * 64 : 0;

    for (int it = 0; it < iters; ++it) {
      const int s = it % p.stages;
      const bool base = RP == 0 || it < nslab;  // the base's slabs
      if constexpr (RP > 0) {
        if (it % nslab == 0) {
#pragma unroll
          for (int i = 0; i < RP / 2; ++i) pacc[i] = 0.f;
        }
      }
      mbar_wait(full0 + 8 * s, (it / p.stages) & 1);
      const uint8_t* xs = smem + L.x + s * BM * 128;
      uint8_t* a = a_tiles + (it & 1) * kATile;
      if (base) {
        const uint8_t* codes = smem + L.codes + s * p.code_stage;
        const uint8_t* meta = smem + L.meta + s * p.meta_stage;
        const int madd = Layout::meta_add(p, (kb + it) * kBK, q);
        if (p.cb == 8)
          dequant_tile<T, Layout, true>(a, codes, meta, code_off, meta_off, madd, zs_off, zadd, cc,
                                        ct);
        else
          dequant_tile<T, Layout, false>(a, codes, meta, code_off, meta_off, madd, zs_off, zadd, cc,
                                         ct);
        fence_proxy_async();
        named_sync(1 + wg);
      }

      const uint64_t db = sw128_desc(smem_u32(xs));
      fence_acc(acc);
      if constexpr (RP > 0) fence_acc(pacc);
      wgmma_fence();
      if (base) {
        const uint64_t da = sw128_desc(smem_u32(a));
#pragma unroll
        for (int ks = 0; ks < kBK / 16; ++ks) wgmma<T, BM>(acc, da + 2 * ks, db + 2 * ks);
      }
      if constexpr (RP > 0) {
        if (lora_rows) {
          const uint64_t dx = sw128_desc(smem_u32(xs + tok0 * 128));
          const uint64_t dl = sw128_desc(smem_u32(smem + L.lora + s * RP * 128));
#pragma unroll
          for (int ks = 0; ks < kBK / 16; ++ks) wgmma<T, RP>(pacc, dx + 2 * ks, dl + 2 * ks);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_acc(acc);
      if constexpr (RP > 0) fence_acc(pacc);
      if (it > 0 && ct == 0) mbar_arrive(empty0 + 8 * ((it - 1) % p.stages));
      if constexpr (RP > 0) {
        if (it % nslab == nslab - 1) {  // the chunk's walk over K is done
          wgmma_wait<0>();
          fence_acc(acc);
          fence_acc(pacc);
          lora_term<BM, RP>(acc, pacc, reinterpret_cast<float*>(smem + L.pbuf),
                            reinterpret_cast<float*>(a_tiles), lora_rows, tok0, p, p0 + wg * 64,
                            it / nslab * RP, it + 1 < iters);
        }
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    // ---- epilogue: the accumulators, transposed, through this warpgroup's
    // A tiles (all its wgmma are done), then out in 16-byte rows
    const int warp = ct / 32, lane = ct % 32;
    const int pw = p0 + wg * 64;  // the warpgroup's first weight row
    if (p.part != nullptr) {
      float* st = reinterpret_cast<float*>(a_tiles);  // [BM][64], 16-byte chunks swizzled
#pragma unroll
      for (int j = 0; j < BM / 8; ++j)
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int n = warp * 16 + lane / 4 + 8 * (h >> 1);
          const int m = 8 * j + 2 * (lane % 4) + (h & 1);
          st[m * 64 + (((n >> 2) ^ (m & 7)) << 2) + (n & 3)] = acc[4 * j + h];
        }
      named_sync(1 + wg);
      float* part = p.part + static_cast<size_t>(blockIdx.z) * p.m * p.n;
      if constexpr (Layout::kContiguous) {
        for (int idx = ct; idx < BM * 16; idx += 128) {
          const int m = idx / 16, c = idx % 16;
          if (m0 + m >= p.m) continue;
          const float4 v = *reinterpret_cast<const float4*>(st + m * 64 + ((c ^ (m & 7)) << 2));
          const float e4[4] = {v.x, v.y, v.z, v.w};
          float* row = part + static_cast<size_t>(m0 + m) * p.n;
          const int pr = pw + 4 * c;
          if (pr + 4 <= p.n && p.n % 4 == 0) {
            *reinterpret_cast<float4*>(row + pr) = v;
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (pr + e < p.n) row[pr + e] = e4[e];
          }
        }
      } else {  // runs of 8 rows: 8 columns of y in one 32-byte store where they are
        for (int idx = ct; idx < BM * 8; idx += 128) {
          const int m = idx / 8, c = idx % 8;
          if (m0 + m >= p.m) continue;
          const float4 v0 = *reinterpret_cast<const float4*>(st + m * 64 + (((2 * c) ^ (m & 7)) << 2));
          const float4 v1 =
              *reinterpret_cast<const float4*>(st + m * 64 + (((2 * c + 1) ^ (m & 7)) << 2));
          float* row = part + static_cast<size_t>(m0 + m) * p.n;
          const int r = wg * 64 + 8 * c;
          const int col = Layout::run_column(p, p0, r);
          if (col >= 0) {
            *reinterpret_cast<float4*>(row + col) = v0;
            *reinterpret_cast<float4*>(row + col + 4) = v1;
          } else {
            const float e8[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const int ce = Layout::column(p, p0, r + e);
              if (ce >= 0) row[ce] = e8[e];
            }
          }
        }
      }
    } else {
      T* st = reinterpret_cast<T*>(a_tiles);  // [BM][64], 16-byte chunks swizzled
#pragma unroll
      for (int j = 0; j < BM / 8; ++j)
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int n = warp * 16 + lane / 4 + 8 * (h >> 1);
          const int m = 8 * j + 2 * (lane % 4) + (h & 1);
          st[m * 64 + (((n >> 3) ^ (m & 7)) << 3) + (n & 7)] = to_type<T>(acc[4 * j + h]);
        }
      named_sync(1 + wg);
      T* out = static_cast<T*>(p.out);
      for (int idx = ct; idx < BM * 8; idx += 128) {
        const int m = idx / 8, c = idx % 8;
        if (m0 + m >= p.m) continue;
        const uint4 v = *reinterpret_cast<const uint4*>(st + m * 64 + ((c ^ (m & 7)) << 3));
        T* row = out + static_cast<size_t>(m0 + m) * p.n;
        const T* e8 = reinterpret_cast<const T*>(&v);
        if constexpr (Layout::kContiguous) {
          const int pr = pw + 8 * c;
          if (pr + 8 <= p.n && p.n % 8 == 0) {
            *reinterpret_cast<uint4*>(row + pr) = v;
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e)
              if (pr + e < p.n) row[pr + e] = e8[e];
          }
        } else {  // 8 rows, 8 columns of y: one 16-byte store where they are a run
          const int r = wg * 64 + 8 * c;
          const int col = Layout::run_column(p, p0, r);
          if (col >= 0) {
            *reinterpret_cast<uint4*>(row + col) = v;
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const int ce = Layout::column(p, p0, r + e);
              if (ce >= 0) row[ce] = e8[e];
            }
          }
        }
      }
    }
  }
}

// out[i] = sum over s of part[s][i], in order of s
__global__ void qmm_sum_splits(const float* __restrict__ part, void* __restrict__ out,
                               size_t count, int splits, int out_dtype) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < count;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < splits; ++s) v += part[static_cast<size_t>(s) * count + i];
    hqq_store(out, i, v, out_dtype);
  }
}

// ------------------------------------------------------------------ host --

// the largest of 16, 8, 4 bytes that divides every address a copy reads
inline int copy_vec(const void* base, long row_bytes, long slab_bytes) {
  const uintptr_t b = reinterpret_cast<uintptr_t>(base);
  for (int v = 16; v >= 4; v /= 2)
    if (b % v == 0 && row_bytes % v == 0 && slab_bytes % v == 0) return v;
  return 0;
}

// x [m, kx] (bf16 or fp16, rows of 16-byte multiples) as boxes of [bm x 64]
// in the 128-byte swizzle
inline int encode_x_map(CUtensorMap* map, const void* x, int m, int kx, int bm, int dtype) {
  const long dims[2] = {kx, m}, strides[1] = {2L * kx};
  const int box[2] = {kBK, bm};
  return encode_map(map,
                    dtype == HQQ_BF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                      : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
                    2, x, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// the layout's maps of codes, scale and zs (unused where p says cp.async),
// and of the LoRA kernel's A^T
struct WeightMaps {
  CUtensorMap codes, scale, zs, lora_a;
};

template <typename T, int BM, typename Layout, int RP>
int launch_tile(const void* x, int kx, Params p, const WeightMaps& w, int splits, int smem,
                cudaStream_t s) {
  CUtensorMap map;
  int e = encode_x_map(&map, x, p.m, kx, BM, p.out_dtype);
  p.tx_bytes =
      (BM + RP) * 128 + (p.codes_tma ? p.code_stage : 0) + (p.meta_tma ? p.meta_stage : 0);
  if (e != 0) return e;
  if (smem < smem_layout(BM, p.stages, p.code_stage, p.meta_stage, RP).total)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = qmm_sm90_kernel<T, BM, Layout, RP>;
  e = static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (e != 0) return e;
  dim3 grid(p.tiles, (p.m + BM - 1) / BM, splits);
  kernel<<<grid, kThreads, smem, s>>>(map, w.codes, w.scale, w.zs, w.lora_a, p);
  e = static_cast<int>(cudaGetLastError());
  if (e != 0 || splits == 1) return e;
  const size_t count = static_cast<size_t>(p.m) * p.n;
  const int blocks = static_cast<int>((count + 255) / 256 < 1024 ? (count + 255) / 256 : 1024);
  qmm_sum_splits<<<blocks, 256, 0, s>>>(p.part, p.out, count, splits, p.out_dtype);
  return static_cast<int>(cudaGetLastError());
}

// the kernel for token tile `bm` (8, 32, 64, 128 or 256; the LoRA kernel,
// RP > 0, up to 128)
template <typename T, typename Layout, int RP = 0>
int launch(const void* x, int kx, const Params& p, const WeightMaps& w, int bm, int splits,
           int smem, cudaStream_t s) {
  if (splits < 1 || (splits > 1 && (p.part == nullptr || bm > 64)) || p.stages < 2 ||
      p.code_vec == 0 || p.meta_vec == 0 || kx % 8 != 0 ||
      (splits - 1) * p.slabs_per_split >= p.slabs || splits * p.slabs_per_split < p.slabs ||
      (RP > 0 && (p.lb == nullptr || p.rank < 1 || p.passes * RP < p.rank)))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (bm) {
    case 8: return launch_tile<T, 8, Layout, RP>(x, kx, p, w, splits, smem, s);
    case 32: return launch_tile<T, 32, Layout, RP>(x, kx, p, w, splits, smem, s);
    case 64: return launch_tile<T, 64, Layout, RP>(x, kx, p, w, splits, smem, s);
    case 128: return launch_tile<T, 128, Layout, RP>(x, kx, p, w, splits, smem, s);
    case 256:
      if constexpr (RP == 0) return launch_tile<T, 256, Layout, RP>(x, kx, p, w, splits, smem, s);
      return static_cast<int>(cudaErrorInvalidValue);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ------------------------------------------------------- axis=1 layout --

// kernel layout of hqq_common.cuh: wq [N, K*cb/8], scale and zs [N, C] in
// Meta (fp32, or bf16 widened to fp32 as a consumer reads it); slabs of KS
// columns (64 here, 32 for qmm_fp32.cu)
template <typename Meta, int KS = kBK>
struct Ax1Layout {
  static constexpr bool kContiguous = true;
  static constexpr bool kRowsShareMeta = false;
  static constexpr int kMeta = sizeof(Meta);
  // the first group of a cp.async'd slot is aligned to 4 bytes
  static constexpr int kAlign = 4 / kMeta;

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
  // the first group a slot holds: the slab's own (down to 4 bytes) where a
  // slab can touch groups from any start, else aligned to the slot (16-byte
  // TMA and cp.async addresses)
  static __device__ __forceinline__ int meta_base(const Params& p, int k0) {
    const int g0 = group_of(p, k0);
    return p.meta_shift ? g0 & ~(kAlign - 1) : g0 & ~(p.slab_groups - 1);
  }

  // what the TMA does not load, by cp.async (zero-filled past the tensor)
  static __device__ __forceinline__ void load_slab(const Params& p, int p0, int k0,
                                                   uint32_t codes, uint32_t meta, int tid) {
    if (!p.codes_tma) {
      const int slab_bytes = KS / 8 * p.cb;
      const int per_row = slab_bytes / p.code_vec;
      const int c0 = k0 / 8 * p.cb;  // the slab's byte offset within a row
      for (int idx = tid; idx < kBN * per_row; idx += 128) {
        const int r = idx / per_row, off = c0 + (idx % per_row) * p.code_vec;
        const bool ok = p0 + r < p.n && off < p.row_bytes;
        const uint8_t* src = ok ? p.wq + static_cast<size_t>(p0 + r) * p.row_bytes + off : p.wq;
        cp_async(codes + r * slab_bytes + (idx % per_row) * p.code_vec, src, p.code_vec,
                       ok);
      }
    }
    if (!p.meta_tma) {
      const int groups = p.slab_groups;
      const int g0 = meta_base(p, k0);
      const int per_row = groups * kMeta / p.meta_vec;
      for (int idx = tid; idx < 2 * kBN * per_row; idx += 128) {
        const int a = idx / (kBN * per_row);  // 0: scale, 1: zs
        const int rem = idx % (kBN * per_row);
        const int r = rem / per_row, off = g0 * kMeta + (rem % per_row) * p.meta_vec;
        const uint8_t* base = static_cast<const uint8_t*>(a == 0 ? p.scale : p.zs);
        const bool ok = p0 + r < p.n && off < p.meta_cols * kMeta;
        const uint8_t* src =
            ok ? base + static_cast<size_t>(p0 + r) * p.meta_cols * kMeta + off : base;
        cp_async(meta + (a * kBN + r) * groups * kMeta + (rem % per_row) * p.meta_vec,
                       src, p.meta_vec, ok);
      }
    }
  }

  // index of tile row pr's scales in a slot (in Meta), and of chunk q's
  // group (codes 8q..8q+7 lie in one group) among the slot's groups
  static __device__ __forceinline__ int meta_offset(const Params& p, int, int pr, int) {
    return pr * p.slab_groups;
  }
  static __device__ __forceinline__ int meta_add(const Params& p, int k0, int q) {
    return group_of(p, k0 + 8 * q) - meta_base(p, k0);
  }
  static __device__ __forceinline__ int zs_offset(const Params& p) {
    return kBN * p.slab_groups;
  }
  // the multiple of scale the stored zs lacks (`hqq_ax1_zs_offset`)
  static __device__ __forceinline__ float zs_add(const Params& p) {
    return hqq_ax1_zs_offset(p.cb, hqq_dtype_code<Meta>());
  }
  static __device__ __forceinline__ void meta8(const uint8_t* meta, int off, int zs_off,
                                               float zadd, float (&s)[8], float (&z)[8]) {
    const Meta* m = reinterpret_cast<const Meta*>(meta);
    const float sv = meta_f32(m[off]), zv = meta_f32(m[zs_off + off]) + zadd * sv;
#pragma unroll
    for (int e = 0; e < 8; ++e) s[e] = sv, z[e] = zv;
  }

  // the column of y of tile row r, or -1 past N
  static __device__ __forceinline__ int column(const Params& p, int p0, int r) {
    return p0 + r < p.n ? p0 + r : -1;
  }
};


// Params and weight maps of an axis=1 weight of n rows and k columns, its
// scale and zs in Meta, in slabs of KS columns, but for the launch plan's
// fields and the outputs
template <typename Meta, int KS = kBK>
inline int ax1_params(Params& p, WeightMaps& w, const void* wq, const void* scale, const void* zs,
                      int n, int k, int group_size, int cb) {
  constexpr int kMeta = sizeof(Meta);
  const int g = group_size;
  p.wq = static_cast<const uint8_t*>(wq);
  p.scale = scale, p.zs = zs;
  p.n = n;
  p.tiles = (n + kBN - 1) / kBN;
  p.row_bytes = k / 8 * cb;
  p.meta_cols = hqq_ax1_meta_cols(k / g, kMeta == 4 ? HQQ_F32 : HQQ_BF16);
  p.group_size = g, p.cb = cb, p.pblocks = 0;
  // groups under a slab row: KS/g, one, or for a g that neither divides nor
  // is divided by KS as many as a slab can touch (and one more for bf16,
  // whose first group is aligned down to 4 bytes); a slot holds at least a
  // TMA box row of 16 bytes
  const bool tiles = KS % g == 0 || g % KS == 0;
  p.meta_shift = !tiles;
  p.group_log2 = (g & (g - 1)) == 0 ? __builtin_ctz(static_cast<unsigned>(g)) : -1;
  const int groups =
      g % KS == 0 ? 1 : tiles ? KS / g : (KS - 1) / g + 2 + Ax1Layout<Meta, KS>::kAlign - 1;
  p.slab_groups = groups > 16 / kMeta ? groups : 16 / kMeta;
  p.code_vec = copy_vec(wq, p.row_bytes, KS / 8 * cb);
  p.meta_vec = tiles ? copy_vec(scale, 1L * kMeta * p.meta_cols, 1L * kMeta * p.slab_groups) : 4;
  if (copy_vec(zs, 1L * kMeta * p.meta_cols, 1L * kMeta * p.slab_groups) < p.meta_vec)
    p.meta_vec = 4;
  p.meta_rows = 0;
  p.slabs = (k + KS - 1) / KS;
  p.code_stage = kBN * KS / 8 * cb;
  p.meta_stage = 2 * kBN * p.slab_groups * kMeta;
  // TMA where its rules hold (16-byte rows and strides), else cp.async
  p.codes_tma = cb >= 2 && p.code_vec == 16;
  if (p.codes_tma) {
    const long dims[3] = {p.row_bytes, n, 1}, strides[2] = {p.row_bytes, 1L * p.row_bytes * n};
    const int box[3] = {KS / 8 * cb, kBN, 1};
    if (encode_map(&w.codes, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, wq, dims, strides, box,
                   CU_TENSOR_MAP_SWIZZLE_NONE) != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  p.meta_tma = tiles && p.meta_vec == 16;
  if (p.meta_tma) {
    const auto type = kMeta == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    const long dims[2] = {p.meta_cols, n}, strides[1] = {1L * kMeta * p.meta_cols};
    const int box[2] = {p.slab_groups, kBN};
    if (encode_map(&w.scale, type, 2, scale, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE) != 0 ||
        encode_map(&w.zs, type, 2, zs, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE) != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}


// ------------------------------------------------------- axis=0 layout --

// measurement switches of the axis=0 layout's two designs (chip_smoke.py's
// --time variants build with them at 0): runs of 8 columns stored at once,
// and one read of scale and zs for the rows a thread dequantizes
#ifndef HQQ_AX0_RUN_STORES
#define HQQ_AX0_RUN_STORES 1
#endif
#ifndef HQQ_AX0_SHARED_META
#define HQQ_AX0_SHARED_META 1
#endif

// eight scales or zs from shared memory, widened to fp32 (bf16 by its bits)
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

// Kernel layout of quant_matmul_ax0.cu: wq [N, K_pad*cb/8] in logical row
// order, scale and zs [P, K_pad] of type Meta (P = N/g); weight row
// n = a*P + b (a < g, b < P) reads row b of them. Slabs of KS columns.
//
// A tile's 128 rows are BB consecutive b by 128/BB consecutive a (BB = 8,
// or 16 at g = 8, `ax0_params`), tile row r = a_l*BB + b_l: a warpgroup's
// 64 rows are 8 whole runs of 8 consecutive b, i.e. of 8 consecutive columns
// of y, and the 4 rows a consumer thread dequantizes (r, r+16, r+32, r+48)
// share their b, so one read of 8 scales and 8 zs serves them all. The codes
// come by one TMA box {slab bytes, BB b, 128/BB a} of the [g, P, row] view
// of wq, which lands in tile-row order, scale and zs by a box {KS, BB}.
template <typename Meta, int KS = kBK>
struct Ax0Layout {
  static constexpr bool kContiguous = false;
  static constexpr bool kRowsShareMeta = HQQ_AX0_SHARED_META;

  // the tile's first b and first a (blockIdx.x = its b tile + b_tiles * its a tile)
  static __device__ __forceinline__ int b_first(const Params& p, int p0) {
    return p0 / kBN % p.b_tiles * p.meta_rows;
  }
  static __device__ __forceinline__ int a_first(const Params& p, int p0) {
    return p0 / kBN / p.b_tiles * (kBN / p.meta_rows);
  }

  static __device__ __forceinline__ int code_row(const Params&, int pr) { return pr; }

  // TMA coordinates of a slab: codes {byte, b, a} of the [g, P, row] view,
  // scale and zs {column, b}
  static __device__ __forceinline__ void code_coords(const Params& p, int p0, int k0, int (&c)[3]) {
    c[0] = k0 / 8 * p.cb, c[1] = b_first(p, p0), c[2] = a_first(p, p0);
  }
  static __device__ __forceinline__ void meta_coords(const Params& p, int p0, int k0, int (&c)[2]) {
    c[0] = k0, c[1] = b_first(p, p0);
  }

  // what the TMA does not load, by cp.async (zero-filled past the tensor)
  static __device__ __forceinline__ void load_slab(const Params& p, int p0, int k0,
                                                   uint32_t codes, uint32_t meta, int tid) {
    const int bb = p.meta_rows, b0 = b_first(p, p0), a0 = a_first(p, p0);
    if (!p.codes_tma) {
      const int slab_bytes = KS / 8 * p.cb;
      const int per_row = slab_bytes / p.code_vec;
      const int c0 = k0 / 8 * p.cb;
      for (int idx = tid; idx < kBN * per_row; idx += 128) {
        const int r = idx / per_row, off = c0 + (idx % per_row) * p.code_vec;
        const int a = a0 + r / bb, b = b0 + r % bb;
        const bool ok = a < p.group_size && b < p.pblocks && off < p.row_bytes;
        const size_t row = static_cast<size_t>(a) * p.pblocks + b;
        const uint8_t* src = ok ? p.wq + row * p.row_bytes + off : p.wq;
        cp_async(codes + r * slab_bytes + (idx % per_row) * p.code_vec, src, p.code_vec, ok);
      }
    }
    if (p.meta_tma) return;
    constexpr int kRowBytes = KS * static_cast<int>(sizeof(Meta));
    const int per_meta = kRowBytes / p.meta_vec;
    const int total = 2 * bb * per_meta;
    for (int idx = tid; idx < total; idx += 128) {
      const int h = idx / (bb * per_meta);  // 0: scale, 1: zs
      const int rem = idx % (bb * per_meta);
      const int i = rem / per_meta, off = k0 * static_cast<int>(sizeof(Meta)) +
                                           (rem % per_meta) * p.meta_vec;
      const uint8_t* base = static_cast<const uint8_t*>(h == 0 ? p.scale : p.zs);
      const bool ok = b0 + i < p.pblocks && off < p.meta_cols * static_cast<int>(sizeof(Meta));
      const uint8_t* src =
          ok ? base + static_cast<size_t>(b0 + i) * p.meta_cols * sizeof(Meta) + off : base;
      cp_async(meta + (h * bb + i) * kRowBytes + (rem % per_meta) * p.meta_vec, src, p.meta_vec,
               ok);
    }
  }

  // element index of tile row pr's scales for chunk q (columns 8q..8q+7)
  static __device__ __forceinline__ int meta_offset(const Params& p, int, int pr, int q) {
    return pr % p.meta_rows * KS + 8 * q;
  }
  static __device__ __forceinline__ int zs_offset(const Params& p) { return p.meta_rows * KS; }
  static __device__ __forceinline__ int meta_add(const Params&, int, int) { return 0; }
  static __device__ __forceinline__ float zs_add(const Params&) { return 0.f; }  // zs as stored
  static __device__ __forceinline__ void meta8(const uint8_t* meta, int off, int zs_off, float,
                                               float (&s)[8], float (&z)[8]) {
    const Meta* m = reinterpret_cast<const Meta*>(meta);
    meta8_f32(m + off, s);
    meta8_f32(m + zs_off + off, z);
  }

  // the column of y of tile row r, or -1 where its a or b lies past the weight
  static __device__ __forceinline__ int column(const Params& p, int p0, int r) {
    const int a = a_first(p, p0) + r / p.meta_rows, b = b_first(p, p0) + r % p.meta_rows;
    return a < p.group_size && b < p.pblocks ? a * p.pblocks + b : -1;
  }
  // the first column of the 8 rows r..r+7 (r % 8 == 0) where they are 8
  // consecutive columns, the first a multiple of 8 (P % 8 == 0), else -1
  static __device__ __forceinline__ int run_column(const Params& p, int p0, int r) {
    return HQQ_AX0_RUN_STORES && p.pblocks % 8 == 0 ? column(p, p0, r) : -1;
  }
};

// Params and weight maps of an axis=0 weight of n rows, groups of g, K
// padded to k_pad, scale and zs in Meta, slabs of KS columns, but for the
// launch plan's fields and the outputs (ops/fused_matmul.py mirrors the
// tile count, `ax0_tile_rows`, and the slot's bytes)
template <typename Meta, int KS = kBK>
inline int ax0_params(Params& p, WeightMaps& w, const void* wq, const void* scale, const void* zs,
                      int n, int k_pad, int g, int cb) {
  constexpr int kMeta = sizeof(Meta);
  if (g < 8 || g % 8 != 0 || n % g != 0) return static_cast<int>(cudaErrorInvalidValue);
  p.wq = static_cast<const uint8_t*>(wq);
  p.scale = scale, p.zs = zs;
  p.n = n;
  p.row_bytes = k_pad / 8 * cb;
  p.meta_cols = k_pad;
  p.group_size = g, p.cb = cb, p.pblocks = n / g;
  const int bb = g < 16 ? 16 : 8;  // b rows of a tile; 128/bb a rows
  p.meta_rows = bb;
  p.b_tiles = (p.pblocks + bb - 1) / bb;
  p.tiles = p.b_tiles * ((g + kBN / bb - 1) / (kBN / bb));
  p.code_vec = copy_vec(wq, p.row_bytes, KS / 8 * cb);
  p.meta_vec = copy_vec(scale, 1L * kMeta * k_pad, kMeta * KS);
  if (copy_vec(zs, 1L * kMeta * k_pad, kMeta * KS) < p.meta_vec) p.meta_vec = 4;
  p.slabs = (k_pad + KS - 1) / KS;
  p.code_stage = kBN * KS / 8 * cb;
  p.meta_stage = 2 * bb * KS * kMeta;
  // TMA where its 16-byte rules hold, else cp.async. Codes: the [g, P, row]
  // view of wq, one box of BB runs of 128/BB rows
  p.codes_tma = cb >= 2 && p.code_vec == 16;
  if (p.codes_tma) {
    const long dims[3] = {p.row_bytes, p.pblocks, g};
    const long strides[2] = {p.row_bytes, 1L * p.row_bytes * p.pblocks};
    const int box[3] = {KS / 8 * cb, bb, kBN / bb};
    if (encode_map(&w.codes, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, wq, dims, strides, box,
                   CU_TENSOR_MAP_SWIZZLE_NONE) != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  p.meta_tma = p.meta_vec == 16;
  if (p.meta_tma) {
    const auto type = kMeta == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    const long dims[2] = {k_pad, p.pblocks}, strides[1] = {1L * kMeta * k_pad};
    const int box[2] = {KS, bb};
    if (encode_map(&w.scale, type, 2, scale, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE) != 0 ||
        encode_map(&w.zs, type, 2, zs, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE) != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace sm90
