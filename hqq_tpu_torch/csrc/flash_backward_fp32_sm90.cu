// SPDX-License-Identifier: Apache-2.0
// The fp32 route of the flash-attention backward on the tensor cores: the
// dK/dV and dQ kernels, every product to fp32 accuracy from three TF32
// products, at every head size the forward takes (16-256). bf16 and fp16
// take flash_backward_sm90.cu.
//
// For out = softmax(scale * q k^T [causal]) v over whole sequences, with
// the forward's log-sum-exp lse [B, nh, T] (natural log, fp32) and
// D = rowsum(dO * O) [B, nh, T] (fp32, computed by the wrapper as the
// library computes it outside its kernels):
//   P  = exp(scale * q k^T - lse)           (0 above the diagonal and past T)
//   dP = dO V^T        dS = scale * P * (dP - D)
//   dV = P^T dO        dK = dS^T Q          dQ = dS K
// every value in fp32. k and v hold n_kv heads, each shared by nh / n_kv
// query heads (GQA): dK and dV sum over the group.
//
// Replaces, for fp32 inputs: the library flash attention's
//   `_flash_attention_bwd_dkv` and `_flash_attention_bwd_dq`
//   (jax/experimental/pallas/ops/tpu/flash_attention.py), which
//   `hqq_tpu.ops.attention.prefill_attention` reaches on every training
//   step under its custom VJP, and which multiply in the inputs' type.
// Bound on H100: operations. An fp32-accurate product from TF32 takes three
//   TF32 products; dK/dV does four products (S, dP, dV, dK) and dQ three
//   (S, dP, dQ) of 2 * T * T * hd per head, halved under causality: at
//   (1, 32/32, 1024, 128) 0.104 and 0.078 ms at 495 TFLOP/s, against 0.256
//   and 0.192 ms for one fp32 product at the CUDA cores' 67 TFLOP/s.
// Design (3xTF32 on wgmma, the pattern of flash_fp32_sm90.cu; one kernel
// template for both):
//   * a block owns 64 resident rows, an A operand pair of one (batch,
//     head): K and V (dK/dV: 64 keys of one query head's kv head) or Q and
//     dO (dQ: 64 query rows), over W head columns: the whole padded head
//     at head_pad 64 and 128; at 256 a cluster of two blocks shares the 64
//     rows, block r of the pair holding columns 128 r .. 128 r + 127 (see
//     below). One thread of a producer warpgroup issues every TMA load: the
//     A pair once, then the B pair in tiles of BS rows (16 at W = 128, 32
//     at 64): Q and dO (dK/dV, with the rows' lse and D by a 1-D TMA) or K
//     and V (dQ), through a ring of 2-4 slots. Tiles come in panels of 32
//     head columns (one 128-byte row of fp32) in the 128-byte swizzle; TMA
//     fills rows past T and columns past the head size with zeros;
//   * every operand is split into TF32 parts, big = rna(v) and small =
//     rna(v - big) (`cvt.rna`): the A pair once, in place, by the consumer
//     warpgroup, the small parts beside it; each streamed tile by the
//     producer warpgroup's 128 threads in two passes, so that the split runs
//     under the consumer's products: (1) in place in its slot, the small
//     parts into a work buffer, once the consumer's S/dP products of the
//     tile before have read theirs; (2) the transposed big and small parts
//     of the operands contracted over the streamed rows (Q and dO for dK/dV,
//     K for dQ), once its second products of the tile before are done. TF32
//     wgmma takes no transpose, so these are written K-major along the
//     streamed rows, W rows of BS values in panels of 8 (32 bytes, the
//     32-byte swizzle). Four mbarriers hand the work buffers back and forth
//     (the split done, the products done), one phase per tile;
//   * X1 = A1 B1^T and X2 = A2 B2^T (S^T and dP^T with the keys as rows for
//     dK/dV, S and dP for dQ): three wgmma chains m64nBSk8 each, a_big b_small
//     + a_small b_big + a_big b_big, both operands K-major in shared memory,
//     into zeroed registers (small x small, ~2^-22 of a product, dropped);
//   * P and dS in fp32 on the accumulator layout, each split into TF32
//     parts that stay in the registers as the A operand of the second
//     products: dV += P^T dO and dK += dS^T Q (dK/dV), dQ += dS K (dQ), each
//     in three chains of wgmma m64nWk8 with B the transposed parts. An
//     accumulator's 8 columns hold streamed rows 2c and 2c + 1 where TF32's
//     A fragment wants columns c and c + 4, so the transposed parts store
//     each 8 streamed rows in the order 0 2 4 6 1 3 5 7;
//   * dK, dV and dQ accumulate in the tensor core's fp32 over the whole
//     walk, with no fold on the CUDA cores (the bar of 1e-4 of max|grad|
//     holds at T = 4096: PERF.md), and leave registers once;
//   * under causality a dK/dV block walks the query tiles at or below its
//     keys, a dQ block the key tiles up to its diagonal, and only tiles that
//     cross it (or T) are masked; blocks take their tile from the plan's
//     table, which starts with the longest walks;
//   * GQA: a dK/dV block owns one (batch, query head, key tile) and writes
//     fp32 dK and dV of its query head; with nh > n_kv the wrapper sums them
//     over the group. No atomics: repeated runs are bit-equal.
// Shared memory bounds the tiles: the A pair in two parts takes 64 * W * 16
// bytes (128 KB at W = 128), so a block has one consumer and the SM one
// block, the streamed tiles are narrow and the work buffers single.
//
// Head size 256: the A pair of 64 rows in two parts would take 256 KB, more
// than a block's 227. wgmma's M is 64, so the rows cannot shrink; the head
// columns can. A cluster of two blocks owns the 64 rows, each block the
// hd-128 geometry over its 128 columns (its streamed tiles carry only
// those). The second products are per column: each block accumulates dK,
// dV or dQ of its own columns, as at 128. The first products contract over
// the head, so each block's X1 and X2 are partials over its half: every
// consumer thread stores its 2 x BS / 2 partials (4 KB a block at BS = 16)
// into the other block's shared memory (`st.shared::cluster`) and arrives
// on that block's mbarrier with release at cluster scope; it waits on its
// own (acquire), then both blocks add lo + hi (rank 0's partial first), so
// both hold the same P and dS bits. Two slots alternate by tile: a thread
// writes tile it + 2's partials only after the other block's arrivals of
// tile it + 1, which each of its threads makes after reading tile it's.
// Nothing else crosses the cluster; no atomics, so runs stay bit-equal.
// The alternatives were worse: the raw fp32 pair (128 KB) split into TF32
// parts in registers per k8 panel costs the consumer a split per product
// and wgmma's A from registers for the first products, where both operands
// now sit in shared memory; streaming the pair from L2 in column panels
// reads it again for every tile.
#include <math.h>

#include "sm90_ptx.cuh"

namespace {

using namespace sm90;

constexpr int kThreads = 256;  // producer warpgroup + one consumer warpgroup
constexpr int kRows = 64;      // resident rows of a block
constexpr float kLog2e = 1.4426950408889634f;
// a slot's lse or D: one 1-D TMA box of at most 32 rows, 128-byte aligned
constexpr int kStatBytes = 128;

// per padded head size: the blocks of a cluster (2 at 256, the head split),
// the head columns of a block, the streamed rows of a step
__host__ __device__ constexpr int cluster_of(int hdp) { return hdp == 256 ? 2 : 1; }
__host__ __device__ constexpr int block_cols(int hdp) { return hdp / cluster_of(hdp); }
__host__ __device__ constexpr int stream_tile(int hdp) { return block_cols(hdp) == 64 ? 32 : 16; }

// Shared-memory carve-up; ops/attention.py `flash_bwd_fp32_smem` computes
// the same sizes. From 0: the A pair's big parts (A1, A2), their small
// parts, the streamed pair's small parts, the transposed big and small
// parts (B1^T, and B2^T for dK/dV), the ring of raw streamed pairs, per
// slot the tile's lse and D (dK/dV), in a cluster the two slots of the
// other block's partials of X1 and X2, the barriers (the A pair's, one per
// slot, four hand-overs, in a cluster one per partials slot).
struct BwdFp32Smem {
  int as, bs, bt, ring, stage, stats, xr, bars, total;
};

__host__ __device__ inline BwdFp32Smem bwd_fp32_smem(bool dkv, int hdp, int stages) {
  BwdFp32Smem s;
  const int w = block_cols(hdp), bs = stream_tile(hdp);
  const int a = kRows * w * 4, b = bs * w * 4;
  const bool cl = cluster_of(hdp) > 1;
  s.as = 2 * a;
  s.bs = 4 * a;
  s.bt = s.bs + 2 * b;
  s.ring = s.bt + (dkv ? 4 : 2) * b;
  s.stage = 2 * b;
  s.stats = s.ring + stages * s.stage;
  s.xr = s.stats + (dkv ? stages * 2 * kStatBytes : 0);
  s.bars = s.xr + (cl ? 2 * 128 * bs * 4 : 0);
  s.total = s.bars + 8 * (5 + stages + (cl ? 2 : 0)) + 1024;  // + slack to align the base
  return s;
}

__device__ __forceinline__ float4 split4(float4& v) {
  const float4 b = make_float4(tf32_rna(v.x), tf32_rna(v.y), tf32_rna(v.z), tf32_rna(v.w));
  const float4 s = make_float4(tf32_rna(__fsub_rn(v.x, b.x)), tf32_rna(__fsub_rn(v.y, b.y)),
                               tf32_rna(__fsub_rn(v.z, b.z)), tf32_rna(__fsub_rn(v.w, b.w)));
  v = b;
  return s;
}

// `bytes` of fp32 at `big` split in place into the TF32 big part, the small
// part to the same offsets of `small` (16-byte chunks: the swizzle does not
// matter)
__device__ __forceinline__ void split_in_place(uint8_t* big, uint8_t* small, int bytes, int ct) {
  for (int c = ct * 16; c < bytes; c += 128 * 16) {
    float4 v = *reinterpret_cast<const float4*>(big + c);
    const float4 s = split4(v);
    *reinterpret_cast<float4*>(big + c) = v;
    *reinterpret_cast<float4*>(small + c) = s;
  }
}

// Pass 1 of a streamed tile's split, by the producer warpgroup's thread pt:
// its items of the tile (BS rows of W columns in TMA panels of 32 columns,
// the 128-byte swizzle), column n and rows 8g..8g+7 each, split in place into
// the big part, the small part to the same offsets of `small`; both kept in
// big[] and sm[] for pass 2
template <int W, int BS>
__device__ __forceinline__ void split_rows(uint8_t* raw, uint8_t* small, int pt,
                                           float (&big)[W * BS / 1024][8],
                                           float (&sm)[W * BS / 1024][8]) {
#pragma unroll
  for (int u = 0; u < W * BS / 1024; ++u) {
    const int item = pt + 128 * u, n = item % W, g = item / W;
    const int panel = n / 32 * BS * 128, chunk = n % 32 / 4, word = n % 4 * 4;
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = *reinterpret_cast<const float*>(raw + panel + sw128(8 * g + i, chunk) + word);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int off = panel + sw128(8 * g + i, chunk) + word;
      big[u][i] = tf32_rna(v[i]);
      sm[u][i] = tf32_rna(__fsub_rn(v[i], big[u][i]));
      *reinterpret_cast<float*>(raw + off) = big[u][i];
      *reinterpret_cast<float*>(small + off) = sm[u][i];
    }
  }
}

// Pass 2: the same items' parts transposed to `tb` and `ts`: row n of the
// transpose holds column n's BS values K-major, in panels of 8 rows (W
// rows of 32 bytes each, the 32-byte swizzle), each 8 in the order
// 0 2 4 6 1 3 5 7
template <int W, int BS>
__device__ __forceinline__ void write_transposed(uint8_t* tb, uint8_t* ts, int pt,
                                                 const float (&big)[W * BS / 1024][8],
                                                 const float (&sm)[W * BS / 1024][8]) {
#pragma unroll
  for (int u = 0; u < W * BS / 1024; ++u) {
    const int item = pt + 128 * u, n = item % W, g = item / W;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int off = g * W * 32 + n * 32 + ((h ^ ((n >> 2) & 1)) << 4);
      *reinterpret_cast<float4*>(tb + off) =
          make_float4(big[u][h], big[u][h + 2], big[u][h + 4], big[u][h + 6]);
      *reinterpret_cast<float4*>(ts + off) =
          make_float4(sm[u][h], sm[u][h + 2], sm[u][h + 4], sm[u][h + 6]);
    }
  }
}

// D[64 x N] += A . B^T over the head in three TF32 chains (a_big b_small,
// a_small b_big, a_big b_big): A's rows at `ab`/`as` in panels `a_panel`
// bytes apart, B's at `bb`/`bs` in panels `b_panel` apart, K-major, the
// 128-byte swizzle
template <int N, int W>
__device__ __forceinline__ void three_over_head(float (&d)[N / 2], uint32_t ab, uint32_t as,
                                                int a_panel, uint32_t bb, uint32_t bs,
                                                int b_panel) {
#pragma unroll
  for (int chain = 0; chain < 3; ++chain) {
    const uint64_t da = sw128_desc(chain == 1 ? as : ab);
    const uint64_t db = sw128_desc(chain == 0 ? bs : bb);
#pragma unroll
    for (int kk = 0; kk < W / 8; ++kk) {
      const int pn = kk / 4, step = 2 * (kk % 4);
      wgmma<float, N>(d, da + (pn * a_panel >> 4) + step, db + (pn * b_panel >> 4) + step);
    }
  }
}

// D[64 x W] += F . T over the streamed rows in three TF32 chains (f_big
// t_small, f_small t_big, f_big t_big): F from registers (one fragment per
// k8 step), T the transposed parts at `tb`/`ts`, panel j of k8 step j
template <int W, int BS>
__device__ __forceinline__ void three_over_stream(float (&d)[W / 2],
                                                  const uint32_t (&fb)[BS / 8][4],
                                                  const uint32_t (&fs)[BS / 8][4], uint32_t tb,
                                                  uint32_t ts) {
#pragma unroll
  for (int j = 0; j < BS / 8; ++j) wgmma_rs<float, W>(d, fb[j], sw32_desc(ts + j * W * 32));
#pragma unroll
  for (int j = 0; j < BS / 8; ++j) wgmma_rs<float, W>(d, fs[j], sw32_desc(tb + j * W * 32));
#pragma unroll
  for (int j = 0; j < BS / 8; ++j) wgmma_rs<float, W>(d, fb[j], sw32_desc(tb + j * W * 32));
}

// a cluster's two partials of one value, rank 0's first: the same bits in
// both blocks
__device__ __forceinline__ float lo_plus_hi(float mine, float theirs, int rank) {
  return rank == 0 ? __fadd_rn(mine, theirs) : __fadd_rn(theirs, mine);
}

// v into the TF32 parts of an A fragment slot
__device__ __forceinline__ void split_frag(float v, uint32_t& big, uint32_t& small) {
  const float b = tf32_rna(v);
  big = __float_as_uint(b);
  small = __float_as_uint(tf32_rna(__fsub_rn(v, b)));
}

#ifndef HQQ_BWD_FP32_VARIANT
// 0: the kernel; for `chip_smoke.py --time` only, builds whose results are
// wrong: 1 without the partials' swap in a cluster (each block's P and dS
// from its own half), 2 without the second products (dV, dK, dQ)
#define HQQ_BWD_FP32_VARIANT 0
#endif

// DKV: the dK/dV kernel (A = K, V; B = Q, dO; out1 = dK, out2 = dV), else
// the dQ kernel (A = Q, dO; B = K, V; out1 = dQ). HDP: the padded head
// size; at 256 the grid's blocks pair into clusters, block r of a pair on
// head columns 128 r .. 128 r + 127.
template <bool DKV, int HDP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_fp32_kernel(const __grid_constant__ CUtensorMap a1map,
                          const __grid_constant__ CUtensorMap a2map,
                          const __grid_constant__ CUtensorMap b1map,
                          const __grid_constant__ CUtensorMap b2map,
                          const __grid_constant__ CUtensorMap lmap,
                          const __grid_constant__ CUtensorMap dmap, const float* __restrict__ lse,
                          const float* __restrict__ dd, float* __restrict__ out1,
                          float* __restrict__ out2, const int* __restrict__ order, int bh, int nh,
                          int rep, int t, int tp, int hd, float scale, int causal, int stages) {
  constexpr int kCluster = cluster_of(HDP);
  constexpr int W = block_cols(HDP);
  constexpr int BS = stream_tile(HDP);
  constexpr int kPanels = W / 32;
  constexpr int kA = kRows * W * 4, kB = BS * W * 4;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~static_cast<uintptr_t>(1023));
  const BwdFp32Smem L = bwd_fp32_smem(DKV, HDP, stages);
  // the A pair's TMA; per ring slot the streamed pair's TMA; the producer
  // warpgroup's two passes of the split (128 arrivals each); the consumer's
  // S/dP products and its second products of a tile done (one arrival); in
  // a cluster, per partials slot the other block's 128 arrivals
  const uint32_t a_full = smem_u32(smem + L.bars);
  const uint32_t full0 = a_full + 8;
  const uint32_t rows_ready = full0 + 8 * stages, t_ready = rows_ready + 8;
  const uint32_t x_done = t_ready + 8, wide_done = x_done + 8;
  const uint32_t xr_full0 = wide_done + 8;

  // the plan's resident tile of every (batch, query head) in turn; in a
  // cluster both blocks on the same one, each on its columns
  const int blk = static_cast<int>(blockIdx.x) / kCluster;
  const int rank = kCluster > 1 ? cluster_rank() : 0;
  const int col0 = rank * W;
  const int r0 = __ldg(order + blk / bh) * kRows;
  const int head = blk % bh;  // b * nh + h
  const int kv_head = head / nh * (nh / rep) + head % nh / rep;
  const int all = (t + BS - 1) / BS;
  // dK/dV: earlier queries see none of the keys; dQ: later keys none of the rows
  const int s_first = DKV && causal ? r0 / BS : 0;
  const int s_end = !DKV && causal ? min(all, (min(t, r0 + kRows) + BS - 1) / BS) : all;
  const int n_s = s_end - s_first;

  if (threadIdx.x == 0) {
    mbar_init(a_full, 1);
    for (int s = 0; s < stages; ++s) mbar_init(full0 + 8 * s, 1);  // the TMA's expect_tx
    mbar_init(rows_ready, 128);
    mbar_init(t_ready, 128);
    mbar_init(x_done, 1);
    mbar_init(wide_done, 1);
    if constexpr (kCluster > 1) {
      mbar_init(xr_full0, 128);
      mbar_init(xr_full0 + 8, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // in a cluster the other block's barriers must be live before any
  // arrival on them
  if constexpr (kCluster > 1) {
    cluster_sync();
  } else {
    __syncthreads();
  }

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: thread 0 issues every TMA load; all 128
    // split each streamed tile, in two passes: the row parts once the
    // consumer's S/dP products of the tile before have read theirs, the
    // transposed parts once its second products have (two warpgroups of
    // 128 threads hold up to 255 registers each: no setmaxnreg)
    const int pt = threadIdx.x;
    const int b_head = DKV ? head : kv_head;
    // streamed tile `it` into its slot
    auto load = [&](int it) {
      const int s = it % stages, c0 = (s_first + it) * BS;
      const uint32_t full = full0 + 8 * s;
      const uint32_t b1 = smem_u32(smem + L.ring + s * L.stage), b2 = b1 + kB;
      mbar_expect_tx(full, 2 * kB + (DKV ? 2 * BS * 4 : 0));
#pragma unroll
      for (int pn = 0; pn < kPanels; ++pn) {
        tma_load_3d(b1 + pn * BS * 128, &b1map, full, col0 + 32 * pn, c0, b_head);
        tma_load_3d(b2 + pn * BS * 128, &b2map, full, col0 + 32 * pn, c0, b_head);
      }
      if constexpr (DKV) {
        const uint32_t st = smem_u32(smem + L.stats + s * 2 * kStatBytes);
        tma_load_1d(st, &lmap, full, head * tp + c0);
        tma_load_1d(st + kStatBytes, &dmap, full, head * tp + c0);
      }
    };
    if (pt == 0) {
      const int a_head = DKV ? kv_head : head;
      mbar_expect_tx(a_full, 2 * kA);
#pragma unroll
      for (int pn = 0; pn < kPanels; ++pn) {
        tma_load_3d(smem_u32(smem + pn * kRows * 128), &a1map, a_full, col0 + 32 * pn, r0,
                    a_head);
        tma_load_3d(smem_u32(smem + kA + pn * kRows * 128), &a2map, a_full, col0 + 32 * pn, r0,
                    a_head);
      }
      for (int it = 0; it < min(stages, n_s); ++it) load(it);
    }
    constexpr int kItems = W * BS / 1024;
    float big1[kItems][8], sm1[kItems][8], big2[kItems][8], sm2[kItems][8];
    for (int it = 0; it < n_s; ++it) {
      const int s = it % stages;
      uint8_t* b1 = smem + L.ring + s * L.stage;
      uint8_t* b2 = b1 + kB;
      mbar_wait(full0 + 8 * s, (it / stages) & 1);
      if (it > 0) mbar_wait(x_done, (it - 1) & 1);
      split_rows<W, BS>(b1, smem + L.bs, pt, big1, sm1);
      if constexpr (DKV) {
        split_rows<W, BS>(b2, smem + L.bs + kB, pt, big2, sm2);
      } else {
        split_in_place(b2, smem + L.bs + kB, kB, pt);
      }
      fence_proxy_async();
      mbar_arrive(rows_ready);
      if (it > 0) {
        mbar_wait(wide_done, (it - 1) & 1);
        // tile it - 1's slot is free: its successor in the ring comes in
        if (pt == 0 && it - 1 + stages < n_s) load(it - 1 + stages);
      }
      write_transposed<W, BS>(smem + L.bt, smem + L.bt + kB, pt, big1, sm1);
      if constexpr (DKV) write_transposed<W, BS>(smem + L.bt + 2 * kB, smem + L.bt + 3 * kB, pt,
                                                 big2, sm2);
      fence_proxy_async();
      mbar_arrive(t_ready);
    }
  } else {
    // ---- the consumer warpgroup
    const int ct = threadIdx.x - 128, warp = ct / 32, lane = ct % 32;
    const int row_a = r0 + warp * 16 + lane / 4;  // this thread's rows: row_a and row_a + 8
    const int col_t = 2 * (lane % 4);             // and its columns 8j + col_t, + 1
    const float scale_log2 = scale * kLog2e;
    // dQ: the rows' lse (log2 units) and D; rows past T take 0 (their dS is
    // 0: dO's rows there are zeros)
    float lse2[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
    if constexpr (!DKV) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row_a + 8 * i;
        if (row < t) {
          lse2[i] = __ldg(lse + static_cast<size_t>(head) * t + row) * kLog2e;
          dl[i] = __ldg(dd + static_cast<size_t>(head) * t + row);
        }
      }
    }

    mbar_wait(a_full, 0);
    split_in_place(smem, smem + L.as, 2 * kA, ct);
    fence_proxy_async();
    named_sync<128>(1);
    float acc1[W / 2], acc2[DKV ? W / 2 : 1];
#pragma unroll
    for (int i = 0; i < W / 2; ++i) acc1[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (DKV ? W / 2 : 1); ++i) acc2[i] = 0.f;
    const uint32_t a1b = smem_u32(smem), a2b = a1b + kA;
    const uint32_t a1s = smem_u32(smem + L.as), a2s = a1s + kA;
    const uint32_t b1s = smem_u32(smem + L.bs), b2s = b1s + kB;
    const uint32_t t1b = smem_u32(smem + L.bt), t1s = t1b + kB;  // B1^T big, small
    const uint32_t t2b = t1s + kB, t2s = t2b + kB;               // B2^T (dK/dV)

    for (int it = 0; it < n_s; ++it) {
      const int s = it % stages;
      const int c0 = (s_first + it) * BS;
      const uint32_t b1 = smem_u32(smem + L.ring + s * L.stage), b2 = b1 + kB;
      mbar_wait(rows_ready, it & 1);

      // X1 = A1 B1^T and X2 = A2 B2^T, into zeroed registers
      float x1[BS / 2], x2[BS / 2];
#pragma unroll
      for (int i = 0; i < BS / 2; ++i) x1[i] = 0.f, x2[i] = 0.f;
      fence_acc(x1);
      fence_acc(x2);
      wgmma_fence();
      three_over_head<BS, W>(x1, a1b, a1s, kRows * 128, b1, b1s, BS * 128);
      three_over_head<BS, W>(x2, a2b, a2s, kRows * 128, b2, b2s, BS * 128);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(x1);
      fence_acc(x2);
      if (ct == 0) mbar_arrive(x_done);  // every warp issued the products: the parts are read

      if constexpr (kCluster > 1 && HQQ_BWD_FP32_VARIANT != 1) {
        // this block's partials over its half of the head into the other
        // block's slot it % 2 (4 values of X1 or X2 at (c * 128 + ct) * 16
        // bytes for chunk c), then the other block's from ours: X = lo + hi,
        // rank 0's partial first, in both blocks
        const int slot = it & 1;
        const uint32_t mine = smem_u32(smem + L.xr + slot * 128 * BS * 4) + ct * 16;
        const uint32_t theirs = map_to_rank(mine, rank ^ 1);
#pragma unroll
        for (int c = 0; c < BS / 8; ++c) {
          st_cluster(theirs + c * 128 * 16,
                     make_float4(x1[4 * c], x1[4 * c + 1], x1[4 * c + 2], x1[4 * c + 3]));
          st_cluster(theirs + (BS / 8 + c) * 128 * 16,
                     make_float4(x2[4 * c], x2[4 * c + 1], x2[4 * c + 2], x2[4 * c + 3]));
        }
        mbar_arrive_cluster(map_to_rank(xr_full0 + 8 * slot, rank ^ 1));
        mbar_wait_cluster(xr_full0 + 8 * slot, (it >> 1) & 1);
        const uint8_t* got = smem + L.xr + slot * 128 * BS * 4 + ct * 16;
#pragma unroll
        for (int c = 0; c < BS / 8; ++c) {
          const float4 o1 = *reinterpret_cast<const float4*>(got + c * 128 * 16);
          const float4 o2 = *reinterpret_cast<const float4*>(got + (BS / 8 + c) * 128 * 16);
          const float v1[4] = {o1.x, o1.y, o1.z, o1.w}, v2[4] = {o2.x, o2.y, o2.z, o2.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            x1[4 * c + i] = lo_plus_hi(x1[4 * c + i], v1[i], rank);
            x2[4 * c + i] = lo_plus_hi(x2[4 * c + i], v2[i], rank);
          }
        }
      }

      // P and dS (h >> 1 picks the row, h & 1 the column), split into the
      // A fragments of the second products: "columns" c (streamed row 2c)
      // and c + 4 (2c + 1)
      const bool mask = DKV ? c0 + BS > t || r0 + kRows > t || (causal && r0 + kRows - 1 > c0)
                            : c0 + BS > t || (causal && c0 + BS - 1 > r0);
      // dK/dV: the tile's lse and D, as TMA wrote them (landed before the
      // split handed the tile over; the wait makes them visible here)
      if constexpr (DKV) mbar_wait(full0 + 8 * s, (it / stages) & 1);
      const float* stats = reinterpret_cast<const float*>(smem + L.stats + s * 2 * kStatBytes);
      uint32_t pb[BS / 8][4], ps[BS / 8][4], db[BS / 8][4], ds_[BS / 8][4];
#pragma unroll
      for (int j = 0; j < BS / 8; ++j) {
        const int sc = 8 * j + col_t;  // this thread's first streamed column
        float2 l2 = make_float2(0.f, 0.f), d2 = l2;
        if constexpr (DKV) {
          l2 = *reinterpret_cast<const float2*>(stats + sc);
          d2 = *reinterpret_cast<const float2*>(stats + kStatBytes / 4 + sc);
        }
        float p[4], ds[4];
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const float l = DKV ? (h & 1 ? l2.y : l2.x) * kLog2e : lse2[h >> 1];
          const float d = DKV ? (h & 1 ? d2.y : d2.x) : dl[h >> 1];
          float pv = exp2f(x1[4 * j + h] * scale_log2 - l);
          if (mask) {
            const int row = row_a + 8 * (h >> 1), col = c0 + sc + (h & 1);
            const int key = DKV ? row : col, q = DKV ? col : row;
            if (q >= t || key >= t || (causal && key > q)) pv = 0.f;
          }
          p[h] = pv;
          ds[h] = pv * (x2[4 * j + h] - d) * scale;
        }
        const int frag[4] = {0, 2, 1, 3};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          split_frag(ds[frag[i]], db[j][i], ds_[j][i]);
          if constexpr (DKV) split_frag(p[frag[i]], pb[j][i], ps[j][i]);
        }
      }

      // dK += dS^T Q and dV += P^T dO, or dQ += dS K
      mbar_wait(t_ready, it & 1);
      fence_acc(acc1);
      if constexpr (DKV) fence_acc(acc2);
      wgmma_fence();
      if constexpr (HQQ_BWD_FP32_VARIANT != 2) {
        three_over_stream<W, BS>(acc1, db, ds_, t1b, t1s);
        if constexpr (DKV) three_over_stream<W, BS>(acc2, pb, ps, t2b, t2s);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc1);
      if constexpr (DKV) fence_acc(acc2);
      // every warp issued the products after its reads of the slot's lse
      // and D: the transposed parts and the slot are free
      if (ct == 0) mbar_arrive(wide_done);
    }


    // out [B, nh, T, hd] fp32 at this block's query head: rows below T,
    // this block's columns below hd
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row_a + 8 * i;
      if (row >= t) continue;
      const size_t at = (static_cast<size_t>(head) * t + row) * hd;
#pragma unroll
      for (int j = 0; j < W / 8; ++j) {
        const int col = col0 + 8 * j + col_t;
        if (col >= hd) continue;
        *reinterpret_cast<float2*>(out1 + at + col) =
            make_float2(acc1[4 * j + 2 * i], acc1[4 * j + 2 * i + 1]);
        if constexpr (DKV)
          *reinterpret_cast<float2*>(out2 + at + col) =
              make_float2(acc2[4 * j + 2 * i], acc2[4 * j + 2 * i + 1]);
      }
    }
  }
  // no block of a cluster leaves while the other may still reach its
  // shared memory
  if constexpr (kCluster > 1) cluster_sync();
}

// q, k, v or dO fp32 [heads, T, hd] as boxes of [rows x 32 head columns] in
// the 128-byte swizzle (zeros past T and past hd)
int encode_rows(CUtensorMap* map, const void* base, int heads, int t, int hd, int rows) {
  const long dims[3] = {hd, t, heads}, strides[2] = {4L * hd, 4L * hd * t};
  const int box[3] = {32, rows, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, base, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}

// lse or D, fp32 [B * nh, Tp], as one run read in boxes of `box` rows (zeros
// past its end)
int encode_stats(CUtensorMap* map, const void* base, long n, int box) {
  const long dims[1] = {n};
  const int boxes[1] = {box};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, base, dims, nullptr, boxes,
                    CU_TENSOR_MAP_SWIZZLE_NONE);
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *dd;
  int b, nh, n_kv, t, hd;
  float scale;
  int causal, head_pad, tile, stages, smem, blocks;
  cudaStream_t stream;
};

template <bool DKV, int HDP>
int launch(const Args& a, void* out1, void* out2, const int* order) {
  constexpr int BS = stream_tile(HDP);
  if (a.tile != BS || a.stages < 2 || a.smem < bwd_fp32_smem(DKV, HDP, a.stages).total)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tp = DKV ? (a.t + 3) / 4 * 4 : a.t;  // the rows of a head in lse and dd
  // A: K, V over the kv heads (dK/dV) or Q, dO over the query heads (dQ); B the other pair
  const void* a1 = DKV ? a.k : a.q;
  const void* a2 = DKV ? a.v : a.dout;
  const void* b1 = DKV ? a.q : a.k;
  const void* b2 = DKV ? a.dout : a.v;
  const int a_heads = a.b * (DKV ? a.n_kv : a.nh), b_heads = a.b * (DKV ? a.nh : a.n_kv);
  CUtensorMap a1m, a2m, b1m, b2m, lm, dm;
  if (encode_rows(&a1m, a1, a_heads, a.t, a.hd, kRows) != 0 ||
      encode_rows(&a2m, a2, a_heads, a.t, a.hd, kRows) != 0 ||
      encode_rows(&b1m, b1, b_heads, a.t, a.hd, BS) != 0 ||
      encode_rows(&b2m, b2, b_heads, a.t, a.hd, BS) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (DKV) {
    const long n = static_cast<long>(a.b) * a.nh * tp;
    if (encode_stats(&lm, a.lse, n, BS) != 0 || encode_stats(&dm, a.dd, n, BS) != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  } else {
    lm = a1m;  // unused
    dm = a1m;
  }
  auto kernel = flash_bwd_fp32_kernel<DKV, HDP>;
  int e = static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem));
  if (e != 0) return e;
  // a block per resident tile, or a cluster of blocks (the head split)
  constexpr int kCluster = cluster_of(HDP);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(a.blocks * kCluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(a.smem);
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kCluster > 1 ? 1 : 0;
  e = static_cast<int>(cudaLaunchKernelEx(
      &cfg, kernel, a1m, a2m, b1m, b2m, lm, dm, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.dd), static_cast<float*>(out1), static_cast<float*>(out2),
      order, a.b * a.nh, a.nh, a.nh / a.n_kv, a.t, tp, a.hd, a.scale, a.causal, a.stages));
  if (e != 0) return e;
  return static_cast<int>(cudaGetLastError());
}

template <bool DKV>
int dispatch(const Args& a, void* out1, void* out2, const int* order) {
  if (a.b < 1 || a.nh < 1 || a.n_kv < 1 || a.nh % a.n_kv || a.t < 1 || a.hd < 16 ||
      a.hd % 16 || a.hd > a.head_pad || order == nullptr || out1 == nullptr ||
      (DKV && out2 == nullptr) ||
      static_cast<long>(a.blocks) != static_cast<long>(a.b) * a.nh * ((a.t + kRows - 1) / kRows))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.head_pad == 64) return launch<DKV, 64>(a, out1, out2, order);
  if (a.head_pad == 128) return launch<DKV, 128>(a, out1, out2, order);
  if (a.head_pad == 256) return launch<DKV, 256>(a, out1, out2, order);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

#define HQQ_BWD_FP32_SHAPE                                                                   \
  int b, int nh, int n_kv, int t, int hd, float scale, int causal, int head_pad, int tile, \
      int stages, int smem, int blocks, void* stream

// The dK/dV kernel. q, dout [B, nh, T, hd] and k, v [B, n_kv, T, hd], all
// fp32, contiguous and 16-byte aligned; lse and dd fp32 [B, nh, tp], each
// row's log-sum-exp and D, tp = T rounded up to a multiple of 4 (16-byte
// aligned boxes; any values past T); head_dim a multiple of 16, at most
// head_pad (64, 128 or 256). dk and dv fp32 [B, nh, T, hd]: with nh == n_kv the
// gradients of k and v, with nh > n_kv one per query head, for the wrapper
// to sum over each group. kv_order (int32 on the device, one key tile of 64
// per group of B * nh blocks), head_pad, tile (the query rows of a step),
// stages, smem and blocks (resident tiles: at head_pad 256 each a cluster
// of two) come from the launch plan (`flash_backward_launch_plan`).
HQQ_EXPORT int hqq_flash_bwd_fp32_dkv(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* dd, void* dk,
                                      void* dv, const int* kv_order, HQQ_BWD_FP32_SHAPE) {
  const Args a{q,      k,        v,    dout,   lse,  dd,     b,
               nh,     n_kv,     t,    hd,     scale, causal, head_pad,
               tile,   stages,   smem, blocks, static_cast<cudaStream_t>(stream)};
  return dispatch<true>(a, dk, dv, kv_order);
}

// The dQ kernel: q, k, v, dout as above, lse and dd fp32 [B, nh, T], dq fp32
// [B, nh, T, hd]. q_order (one query tile of 64 rows per group of B * nh
// blocks), head_pad, tile (the keys of a step), stages, smem and blocks from
// the launch plan.
HQQ_EXPORT int hqq_flash_bwd_fp32_dq(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* dd, void* dq,
                                     const int* q_order, HQQ_BWD_FP32_SHAPE) {
  const Args a{q,      k,        v,    dout,   lse,  dd,     b,
               nh,     n_kv,     t,    hd,     scale, causal, head_pad,
               tile,   stages,   smem, blocks, static_cast<cudaStream_t>(stream)};
  return dispatch<false>(a, dq, nullptr, q_order);
}

HQQ_EXPORT const char* hqq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
