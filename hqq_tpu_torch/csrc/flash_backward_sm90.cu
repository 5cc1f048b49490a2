// SPDX-License-Identifier: Apache-2.0
// The backward of flash attention on the tensor cores: the dK/dV and dQ
// kernels for bf16 and fp16 (fp32 takes the 3xTF32 kernels of
// flash_backward_fp32_sm90.cu).
//
// For out = softmax(scale * q k^T [causal]) v over whole sequences, with
// the forward's log-sum-exp lse [B, nh, T] (natural log, fp32) and
// D = rowsum(dO * O) [B, nh, T] (fp32, computed by the wrapper as the
// library computes it outside its kernels):
//   P  = exp(scale * q k^T - lse)           (0 above the diagonal and past T)
//   dP = dO V^T        dS = scale * P * (dP - D)
//   dV = P' ^T dO      dK = dS'^T Q         dQ = dS' K
// where P' and dS' are P and dS rounded to the inputs' type, as the
// library's backward kernels round them before these products
// (flash_attention.py `p.T.astype(do.dtype)`, `ds.T.astype(do.dtype)`,
// `ds.astype(k.dtype)`); every product sums in fp32 and each output is
// rounded once. k and v hold n_kv heads, each shared by nh / n_kv query
// heads (GQA): dK and dV sum over the group.
//
// Replaces: the library flash attention's `_flash_attention_bwd_dkv` and
//   `_flash_attention_bwd_dq` (jax/experimental/pallas/ops/tpu/
//   flash_attention.py), which `hqq_tpu.ops.attention.prefill_attention`
//   reaches on every training step under its custom VJP.
// Bound on H100: operations. dK/dV does four products (S, dP, dV, dK) and
//   dQ three (S, dP, dQ), each 2 * T * T * hd per head, halved under
//   causality: at (1, 32/32, 1024, 128) 17.2 and 12.9 GFLOP, 0.017 and
//   0.013 ms at the bf16 tensor-core rate, against 8 MB read and written.
// Design (wgmma, TMA and an mbarrier ring in the PTX of sm90_ptx.cuh, on
// the pattern of flash_prefill.cu: a producer warp and two consumer
// warpgroups of 64 rows each; tiles by TMA in the 128-byte swizzle, in
// panels of 64 head columns, zeros past T and past the head size):
//   * dK/dV: a block owns 128 keys of one (batch, query head). K's and V's
//     tiles are loaded once; the producer streams tiles of 64 query rows
//     (Q, dO, and their rows' lse and D by a 1-D TMA, with each head's
//     rows a multiple of 4 apart so that every box starts 16-byte aligned:
//     the wrapper pads them where T is not) through a ring of 2-4 slots.
//     Per tile, each consumer forms S^T = K Q^T and dP^T = V dO^T
//     (wgmma m64n64k16, keys as rows, queries as N, both operands K-major),
//     P^T and dS^T from each column's lse and D in registers, rounds them
//     into A fragments, and adds P'^T dO and dS'^T Q to dV and dK with the
//     register-sourced wgmma m64nHDk16, dO and Q read MN-major from the
//     same shared tiles (the transpose bit, as the forward reads V). dK and
//     dV leave registers once. Under causality a block walks only the query
//     tiles at or below its keys, a warpgroup skips a tile that lies wholly
//     above its keys, and only tiles that cross the diagonal (or T) are
//     masked; blocks take their key tile from the plan's table, which starts
//     with the tiles that walk the most query tiles.
//     At head size 256 the accumulators of 64 keys' dK and dV would take
//     256 registers a thread: a block owns 64 keys, and both consumers form
//     the same S^T and dP^T and each keeps dK and dV of 128 head columns.
//   * GQA: the grid is split over the query heads of a group, so that a
//     block owns one (batch, query head, key tile); with nh > n_kv each
//     block writes its dK and dV in fp32 to [B, nh, T, hd] and the wrapper
//     sums them over the group and rounds once. No atomics: repeated runs
//     are bit-equal.
//   * dQ: a block owns 128 query rows of one (batch, head); Q, dO and the
//     rows' lse and D are loaded once, K's and V's tiles of 64 keys (32 at
//     head size 256, for the ring's shared memory) come through the ring.
//     Per tile: S = Q K^T and dP = dO V^T (wgmma, K-major), P and dS in
//     registers (a row's values lie in one quad), dQ += dS' K by the
//     register-sourced wgmma with K read MN-major. Causal blocks walk the key
//     tiles up to their diagonal, longest first, and mask only the tiles
//     that cross it.
// The consumers issue their products one after another (S and dP, then
// the elementwise step, then the two register-sourced products):
// overlapping one tile's elementwise step with the next tile's products is
// the next step.
#include <math.h>

#include "sm90_ptx.cuh"

namespace {

using namespace sm90;

constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kBQ = 64;        // query rows of a dK/dV step
constexpr int kBM = 128;       // query rows of a dQ block
constexpr float kLog2e = 1.4426950408889634f;

// keys of a dK/dV block: 64 per consumer, or 64 shared by both at 256
__host__ __device__ constexpr int dkv_keys(int hdp) { return hdp == 256 ? 64 : 128; }
// keys of a dQ step
__host__ __device__ constexpr int dq_key_tile(int hdp) { return hdp == 256 ? 32 : 64; }

// Shared-memory carve-ups; ops/attention.py `flash_bwd_dkv_smem` and
// `flash_bwd_dq_smem` compute the same totals.
struct BwdSmem {
  int stage0, stage, stats, bars, total;
};

// K's tile, V's; per slot Q's and dO's tiles; per slot lse[64] and D[64]
__host__ __device__ inline BwdSmem dkv_smem(int hdp, int stages) {
  BwdSmem s;
  s.stage0 = 2 * dkv_keys(hdp) * hdp * 2;
  s.stage = 2 * kBQ * hdp * 2;
  s.stats = s.stage0 + stages * s.stage;
  s.bars = s.stats + stages * 2 * kBQ * 4;
  s.total = s.bars + 8 * (1 + 2 * stages) + 1024;  // + slack to align the base to 1024
  return s;
}

// Q's tile, dO's; per slot K's and V's tiles
__host__ __device__ inline BwdSmem dq_smem(int hdp, int stages) {
  BwdSmem s;
  s.stage0 = 2 * kBM * hdp * 2;
  s.stage = 2 * dq_key_tile(hdp) * hdp * 2;
  s.stats = s.stage0 + stages * s.stage;
  s.bars = s.stats;
  s.total = s.bars + 8 * (1 + 2 * stages) + 1024;
  return s;
}

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                    ~static_cast<uintptr_t>(1023));
}

__device__ __forceinline__ void init_ring(uint32_t once, uint32_t full0, uint32_t empty0,
                                          int stages) {
  if (threadIdx.x == 0) {
    mbar_init(once, 1);
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);   // the TMA's expect_tx
      mbar_init(empty0 + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// A[64 x 16k] . B[N x 16k]^T over the head size: A's rows start at `a` in
// panels `a_panel` bytes apart, B's at `b` in panels `b_panel` bytes apart
template <typename T, int N, int HDP>
__device__ __forceinline__ void product_over_head(float (&d)[N / 2], uint64_t a, int a_panel,
                                                  uint64_t b, int b_panel) {
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    const int pn = kk / 4, step = 2 * (kk % 4);
    wgmma<T, N>(d, a + (pn * a_panel >> 4) + step, b + (pn * b_panel >> 4) + step);
  }
}

template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const __grid_constant__ CUtensorMap omap,
                       const __grid_constant__ CUtensorMap lmap,
                       const __grid_constant__ CUtensorMap dmap, T* __restrict__ dk,
                       T* __restrict__ dv, float* __restrict__ dk_part,
                       float* __restrict__ dv_part, const int* __restrict__ kv_order, int bh,
                       int nh, int rep, int t, int tp, int hd, float scale, int causal,
                       int stages) {
  constexpr int kKeys = dkv_keys(HDP);
  constexpr bool kSplitCols = HDP == 256;
  constexpr int NC = kSplitCols ? HDP / 2 : HDP;  // head columns of a consumer's dK and dV
  constexpr int kPanels = HDP / 64;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const BwdSmem L = dkv_smem(HDP, stages);
  const uint32_t kv_full = smem_u32(smem + L.bars);
  const uint32_t full0 = kv_full + 8;
  const uint32_t empty0 = full0 + 8 * stages;

  // the plan's key tile of every (batch, query head) in turn
  const int kt = __ldg(kv_order + blockIdx.x / bh);
  const int head = static_cast<int>(blockIdx.x) % bh;  // b * nh + h
  const int kv_head = head / nh * (nh / rep) + head % nh / rep;
  const int n0 = kt * kKeys;
  const int q_first = causal ? n0 / kBQ : 0;  // earlier queries see none of the keys
  const int n_q = (t + kBQ - 1) / kBQ - q_first;
  init_ring(kv_full, full0, empty0, stages);

  if (threadIdx.x < 128) {
    // ---- producer: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      const uint32_t ks = smem_u32(smem), vs = ks + kKeys * HDP * 2;
      mbar_expect_tx(kv_full, 2 * kKeys * HDP * 2);
#pragma unroll
      for (int pn = 0; pn < kPanels; ++pn) {
        tma_load_3d(ks + pn * kKeys * 128, &kmap, kv_full, 64 * pn, n0, kv_head);
        tma_load_3d(vs + pn * kKeys * 128, &vmap, kv_full, 64 * pn, n0, kv_head);
      }
      for (int it = 0; it < n_q; ++it) {
        const int s = it % stages;
        const int m0 = (q_first + it) * kBQ;
        mbar_wait(empty0 + 8 * s, ((it / stages) & 1) ^ 1);
        const uint32_t full = full0 + 8 * s;
        const uint32_t qs = smem_u32(smem + L.stage0 + s * L.stage);
        const uint32_t os = qs + kBQ * HDP * 2;
        const uint32_t st = smem_u32(smem + L.stats + s * 2 * kBQ * 4);
        mbar_expect_tx(full, 2 * kBQ * HDP * 2 + 2 * kBQ * 4);
#pragma unroll
        for (int pn = 0; pn < kPanels; ++pn) {
          tma_load_3d(qs + pn * kBQ * 128, &qmap, full, 64 * pn, m0, head);
          tma_load_3d(os + pn * kBQ * 128, &omap, full, 64 * pn, m0, head);
        }
        tma_load_1d(st, &lmap, full, head * tp + m0);
        tma_load_1d(st + kBQ * 4, &dmap, full, head * tp + m0);
      }
    }
  } else {
    // ---- consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = threadIdx.x / 128 - 1;
    const int ct = threadIdx.x % 128, warp = ct / 32, lane = ct % 32;
    const int key0 = n0 + (kSplitCols ? 0 : 64 * wg);  // the warpgroup's first key
    const int col0 = kSplitCols ? NC * wg : 0;          // and first column of its dK, dV
    const int key_a = key0 + warp * 16 + lane / 4;     // this thread's keys: key_a, key_a + 8
    const int col_t = 2 * (lane % 4);  // its columns 8j + col_t, + 1 (queries of S^T, or head)
    const float scale_log2 = scale * kLog2e;

    float dka[NC / 2], dva[NC / 2];
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) dka[i] = 0.f, dva[i] = 0.f;
    const uint64_t kd = sw128_desc(smem_u32(smem + (key0 - n0) * 128));
    const uint64_t vd = sw128_desc(smem_u32(smem + kKeys * HDP * 2 + (key0 - n0) * 128));
    mbar_wait(kv_full, 0);
    for (int it = 0; it < n_q; ++it) {
      const int s = it % stages;
      const int m0 = (q_first + it) * kBQ;
      mbar_wait(full0 + 8 * s, (it / stages) & 1);
      if (!causal || m0 + kBQ - 1 >= key0) {  // else every query comes before the keys
        const uint32_t qs = smem_u32(smem + L.stage0 + s * L.stage);
        const uint32_t os = qs + kBQ * HDP * 2;
        const float* stats = reinterpret_cast<const float*>(smem + L.stats + s * 2 * kBQ * 4);

        // S^T = K Q^T and dP^T = V dO^T, in registers
        float st[32], dpt[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) st[i] = 0.f, dpt[i] = 0.f;
        fence_acc(st);
        fence_acc(dpt);
        wgmma_fence();
        product_over_head<T, 64, HDP>(st, kd, kKeys * 128, sw128_desc(qs), kBQ * 128);
        product_over_head<T, 64, HDP>(dpt, vd, kKeys * 128, sw128_desc(os), kBQ * 128);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(st);
        fence_acc(dpt);

        // P^T and dS^T from each query column's lse and D, rounded into the
        // A fragments of the next products (h & 1 picks the column, h >> 1
        // the key row)
        const bool mask = m0 + kBQ > t || key0 + 64 > t || (causal && key0 + 63 > m0);
        uint32_t pa[4][4], da[4][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int qc = 8 * j + col_t;
          const float2 l2 = *reinterpret_cast<const float2*>(stats + qc);
          const float2 d2 = *reinterpret_cast<const float2*>(stats + kBQ + qc);
          float p[4], ds[4];
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const float lse = (h & 1 ? l2.y : l2.x) * kLog2e, d = h & 1 ? d2.y : d2.x;
            float pv = exp2f(st[4 * j + h] * scale_log2 - lse);
            if (mask) {
              const int q = m0 + qc + (h & 1), key = key_a + 8 * (h >> 1);
              if (q >= t || key >= t || (causal && key > q)) pv = 0.f;
            }
            p[h] = pv;
            ds[h] = pv * (dpt[4 * j + h] - d) * scale;
          }
          pa[j / 2][2 * (j & 1)] = pack2<T>(p[0], p[1]);
          pa[j / 2][2 * (j & 1) + 1] = pack2<T>(p[2], p[3]);
          da[j / 2][2 * (j & 1)] = pack2<T>(ds[0], ds[1]);
          da[j / 2][2 * (j & 1) + 1] = pack2<T>(ds[2], ds[3]);
        }

        // dV += P'^T dO and dK += dS'^T Q: queries are K of the products,
        // dO's and Q's head columns N, read MN-major (64-column panels one
        // LBO apart)
        const uint32_t cols = col0 / 64 * kBQ * 128;
        fence_acc(dva);
        fence_acc(dka);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBQ / 16; ++kk)
          wgmma_rs<T, NC>(dva, pa[kk], sw128_mn_desc(os + cols + kk * 16 * 128, kBQ * 128));
#pragma unroll
        for (int kk = 0; kk < kBQ / 16; ++kk)
          wgmma_rs<T, NC>(dka, da[kk], sw128_mn_desc(qs + cols + kk * 16 * 128, kBQ * 128));
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(dva);
        fence_acc(dka);
      }
      if (ct == 0) mbar_arrive(empty0 + 8 * s);
    }

    // dK and dV once: keys below T, columns below hd; in the inputs' type,
    // or in fp32 per query head where the wrapper sums a GQA group
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = key_a + 8 * i;
      if (key >= t) continue;
#pragma unroll
      for (int j = 0; j < NC / 8; ++j) {
        const int col = col0 + 8 * j + col_t;
        if (col >= hd) continue;
        const float k0 = dka[4 * j + 2 * i], k1 = dka[4 * j + 2 * i + 1];
        const float v0 = dva[4 * j + 2 * i], v1 = dva[4 * j + 2 * i + 1];
        if (dk_part != nullptr) {
          const size_t at = (static_cast<size_t>(head) * t + key) * hd + col;
          *reinterpret_cast<float2*>(dk_part + at) = make_float2(k0, k1);
          *reinterpret_cast<float2*>(dv_part + at) = make_float2(v0, v1);
        } else {
          const size_t at = (static_cast<size_t>(kv_head) * t + key) * hd + col;
          *reinterpret_cast<uint32_t*>(dk + at) = pack2<T>(k0, k1);
          *reinterpret_cast<uint32_t*>(dv + at) = pack2<T>(v0, v1);
        }
      }
    }
  }
}

template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap omap, const float* __restrict__ lse,
                      const float* __restrict__ dd, T* __restrict__ dq,
                      const int* __restrict__ q_order, int bh, int nh, int rep, int t, int hd,
                      float scale, int causal, int stages) {
  constexpr int BN = dq_key_tile(HDP);
  constexpr int kPanels = HDP / 64;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const BwdSmem L = dq_smem(HDP, stages);
  const uint32_t q_full = smem_u32(smem + L.bars);
  const uint32_t full0 = q_full + 8;
  const uint32_t empty0 = full0 + 8 * stages;

  // the plan's query tile of every (batch, head) in turn
  const int qt = __ldg(q_order + blockIdx.x / bh);
  const int head = static_cast<int>(blockIdx.x) % bh;  // b * nh + h
  const int kv_head = head / nh * (nh / rep) + head % nh / rep;
  const int m0 = qt * kBM;
  const int all_tiles = (t + BN - 1) / BN;
  const int n_tiles = causal ? min(all_tiles, (min(t, m0 + kBM) + BN - 1) / BN) : all_tiles;
  init_ring(q_full, full0, empty0, stages);

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      const uint32_t qs = smem_u32(smem), os = qs + kBM * HDP * 2;
      mbar_expect_tx(q_full, 2 * kBM * HDP * 2);
#pragma unroll
      for (int pn = 0; pn < kPanels; ++pn) {
        tma_load_3d(qs + pn * kBM * 128, &qmap, q_full, 64 * pn, m0, head);
        tma_load_3d(os + pn * kBM * 128, &omap, q_full, 64 * pn, m0, head);
      }
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int s = kt % stages;
        mbar_wait(empty0 + 8 * s, ((kt / stages) & 1) ^ 1);
        const uint32_t full = full0 + 8 * s;
        const uint32_t ks = smem_u32(smem + L.stage0 + s * L.stage);
        const uint32_t vs = ks + BN * HDP * 2;
        mbar_expect_tx(full, 2 * BN * HDP * 2);
#pragma unroll
        for (int pn = 0; pn < kPanels; ++pn) {
          tma_load_3d(ks + pn * BN * 128, &kmap, full, 64 * pn, kt * BN, kv_head);
          tma_load_3d(vs + pn * BN * 128, &vmap, full, 64 * pn, kt * BN, kv_head);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = threadIdx.x / 128 - 1;
    const int ct = threadIdx.x % 128, warp = ct / 32, lane = ct % 32;
    const int row0 = m0 + wg * 64;                  // the warpgroup's first row
    const int row_a = row0 + warp * 16 + lane / 4;  // this thread's rows: row_a and row_a + 8
    const int col_t = 2 * (lane % 4);               // and its columns 8j + col_t, + 1
    const float scale_log2 = scale * kLog2e;
    // the rows' lse (log2 units) and D; rows past T take 0 (their dS is 0:
    // dO's rows there are zeros)
    float lse2[2], dl[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row_a + 8 * i;
      const bool ok = row < t;
      lse2[i] = ok ? __ldg(lse + static_cast<size_t>(head) * t + row) * kLog2e : 0.f;
      dl[i] = ok ? __ldg(dd + static_cast<size_t>(head) * t + row) : 0.f;
    }

    float acc[HDP / 2];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.f;
    const uint64_t qd = sw128_desc(smem_u32(smem + wg * 64 * 128));
    const uint64_t od = sw128_desc(smem_u32(smem + kBM * HDP * 2 + wg * 64 * 128));
    mbar_wait(q_full, 0);
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int s = kt % stages;
      const int n0 = kt * BN;
      mbar_wait(full0 + 8 * s, (kt / stages) & 1);
      if (!causal || n0 <= row0 + 63) {  // else every key lies above the rows
        const uint32_t ks = smem_u32(smem + L.stage0 + s * L.stage);
        const uint32_t vs = ks + BN * HDP * 2;

        // S = Q K^T and dP = dO V^T, in registers
        float sc[BN / 2], dp[BN / 2];
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f, dp[i] = 0.f;
        fence_acc(sc);
        fence_acc(dp);
        wgmma_fence();
        product_over_head<T, BN, HDP>(sc, qd, kBM * 128, sw128_desc(ks), BN * 128);
        product_over_head<T, BN, HDP>(dp, od, kBM * 128, sw128_desc(vs), BN * 128);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(sc);
        fence_acc(dp);

        // dS from each row's lse and D (h >> 1 picks the row), rounded into
        // the A fragments of dQ += dS' K
        const bool mask = n0 + BN > t || (causal && n0 + BN - 1 > row0);
        uint32_t da[BN / 16][4];
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          float ds[4];
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            float p = exp2f(sc[4 * j + h] * scale_log2 - lse2[h >> 1]);
            if (mask) {
              const int col = n0 + 8 * j + col_t + (h & 1);
              if (col >= t || (causal && col > row_a + 8 * (h >> 1))) p = 0.f;
            }
            ds[h] = p * (dp[4 * j + h] - dl[h >> 1]) * scale;
          }
          da[j / 2][2 * (j & 1)] = pack2<T>(ds[0], ds[1]);
          da[j / 2][2 * (j & 1) + 1] = pack2<T>(ds[2], ds[3]);
        }

        // dQ += dS' K: keys are K's rows (K of the product), its head columns N
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          wgmma_rs<T, HDP>(acc, da[kk], sw128_mn_desc(ks + kk * 16 * 128, BN * 128));
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(acc);
      }
      if (ct == 0) mbar_arrive(empty0 + 8 * s);
    }

    T* base = dq + static_cast<size_t>(head) * t * hd;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row_a + 8 * i;
      if (row >= t) continue;
      T* dst = base + static_cast<size_t>(row) * hd;
#pragma unroll
      for (int j = 0; j < HDP / 8; ++j) {
        const int col = 8 * j + col_t;
        if (col < hd)
          *reinterpret_cast<uint32_t*>(dst + col) =
              pack2<T>(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
      }
    }
  }
}

// q, k, v or dO [heads, T, hd] as boxes of [rows x 64 head columns] in the
// 128-byte swizzle (zeros past T and past hd)
int encode_rows(CUtensorMap* map, const void* base, int heads, int t, int hd, int rows,
                int dtype) {
  const long dims[3] = {hd, t, heads}, strides[2] = {2L * hd, 2L * hd * t};
  const int box[3] = {64, rows, 1};
  return encode_map(map,
                    dtype == HQQ_BF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                      : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
                    3, base, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// lse or D, fp32 [B * nh, Tp], as one run read in boxes of 64 rows (zeros
// past its end)
int encode_stats(CUtensorMap* map, const void* base, long n) {
  const long dims[1] = {n};
  const int box[1] = {kBQ};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, base, dims, nullptr, box,
                    CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <typename K>
int set_smem(K kernel, int smem) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *dd;
  int b, nh, n_kv, t, tp, hd;  // tp: the rows of a head in lse and dd
  float scale;
  int causal, dtype, stages, smem, blocks;
  cudaStream_t stream;
};

template <typename T, int HDP>
int launch_dkv(const Args& a, void* dk, void* dv, float* dk_part, float* dv_part,
               const int* kv_order) {
  constexpr int kKeys = dkv_keys(HDP);
  if (a.stages < 2 || a.smem < dkv_smem(HDP, a.stages).total ||
      static_cast<long>(a.blocks) != static_cast<long>(a.b) * a.nh * ((a.t + kKeys - 1) / kKeys))
    return static_cast<int>(cudaErrorInvalidValue);
  const long n = static_cast<long>(a.b) * a.nh * a.tp;
  CUtensorMap qm, km, vm, om, lm, dm;
  if (encode_rows(&qm, a.q, a.b * a.nh, a.t, a.hd, kBQ, a.dtype) != 0 ||
      encode_rows(&km, a.k, a.b * a.n_kv, a.t, a.hd, kKeys, a.dtype) != 0 ||
      encode_rows(&vm, a.v, a.b * a.n_kv, a.t, a.hd, kKeys, a.dtype) != 0 ||
      encode_rows(&om, a.dout, a.b * a.nh, a.t, a.hd, kBQ, a.dtype) != 0 ||
      encode_stats(&lm, a.lse, n) != 0 || encode_stats(&dm, a.dd, n) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_bwd_dkv_kernel<T, HDP>;
  int e = set_smem(kernel, a.smem);
  if (e != 0) return e;
  kernel<<<a.blocks, kThreads, a.smem, a.stream>>>(
      qm, km, vm, om, lm, dm, static_cast<T*>(dk), static_cast<T*>(dv), dk_part, dv_part,
      kv_order, a.b * a.nh, a.nh, a.nh / a.n_kv, a.t, a.tp, a.hd, a.scale, a.causal, a.stages);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HDP>
int launch_dq(const Args& a, void* dq, const int* q_order) {
  if (a.stages < 2 || a.smem < dq_smem(HDP, a.stages).total ||
      static_cast<long>(a.blocks) != static_cast<long>(a.b) * a.nh * ((a.t + kBM - 1) / kBM))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int BN = dq_key_tile(HDP);
  CUtensorMap qm, km, vm, om;
  if (encode_rows(&qm, a.q, a.b * a.nh, a.t, a.hd, kBM, a.dtype) != 0 ||
      encode_rows(&km, a.k, a.b * a.n_kv, a.t, a.hd, BN, a.dtype) != 0 ||
      encode_rows(&vm, a.v, a.b * a.n_kv, a.t, a.hd, BN, a.dtype) != 0 ||
      encode_rows(&om, a.dout, a.b * a.nh, a.t, a.hd, kBM, a.dtype) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_bwd_dq_kernel<T, HDP>;
  int e = set_smem(kernel, a.smem);
  if (e != 0) return e;
  kernel<<<a.blocks, kThreads, a.smem, a.stream>>>(
      qm, km, vm, om, static_cast<const float*>(a.lse), static_cast<const float*>(a.dd),
      static_cast<T*>(dq), q_order, a.b * a.nh, a.nh, a.nh / a.n_kv, a.t, a.hd, a.scale,
      a.causal, a.stages);
  return static_cast<int>(cudaGetLastError());
}

bool valid(const Args& a, int head_pad) {
  return a.b >= 1 && a.nh >= 1 && a.n_kv >= 1 && a.nh % a.n_kv == 0 && a.t >= 1 && a.hd >= 16 &&
         a.hd % 16 == 0 && a.hd <= head_pad && (a.dtype == HQQ_BF16 || a.dtype == HQQ_F16);
}

}  // namespace

#define HQQ_BWD_SHAPE                                                                        \
  int b, int nh, int n_kv, int t, int hd, float scale, int causal, int dtype, int head_pad

// The dK/dV kernel. q, dout [B, nh, T, hd] and k, v [B, n_kv, T, hd], all
// bf16 (dtype 1) or fp16 (dtype 2), contiguous and 16-byte aligned; lse and
// dd fp32 [B, nh, tp], each row's log-sum-exp and D, tp = T rounded up to a
// multiple of 4 (16-byte aligned, any values past T); head_dim a multiple
// of 16, at most 256. With nh == n_kv it writes dk and dv [B, n_kv, T, hd] in
// the inputs' type (dk_part and dv_part null); with nh > n_kv it writes
// dk_part and dv_part fp32 [B, nh, T, hd], one per query head (dk and dv
// null).
// kv_order (int32 on the device, one key tile per group of B * nh blocks),
// head_pad, stages, smem and blocks come from the launch plan
// (`flash_backward_launch_plan`).
HQQ_EXPORT int hqq_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* dd, void* dk, void* dv,
                                 void* dk_part, void* dv_part, const int* kv_order,
                                 HQQ_BWD_SHAPE, int stages, int smem, int blocks, void* stream) {
  const Args a{q, k, v, dout, lse, dd, b, nh, n_kv, t, (t + 3) / 4 * 4, hd, scale, causal, dtype,
               stages, smem, blocks, static_cast<cudaStream_t>(stream)};
  const bool split = nh > n_kv;
  if (!valid(a, head_pad) || kv_order == nullptr ||
      (split ? dk_part == nullptr || dv_part == nullptr : dk == nullptr || dv == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  float* kp = split ? static_cast<float*>(dk_part) : nullptr;
  float* vp = split ? static_cast<float*>(dv_part) : nullptr;
#define HQQ_DKV(T, HDP) \
  if (head_pad == HDP) return launch_dkv<T, HDP>(a, dk, dv, kp, vp, kv_order)
  if (dtype == HQQ_BF16) {
    HQQ_DKV(__nv_bfloat16, 64);
    HQQ_DKV(__nv_bfloat16, 128);
    HQQ_DKV(__nv_bfloat16, 256);
  } else {
    HQQ_DKV(__half, 64);
    HQQ_DKV(__half, 128);
    HQQ_DKV(__half, 256);
  }
#undef HQQ_DKV
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dQ kernel: q, k, v, dout as above, lse and dd fp32 [B, nh, T], dq
// [B, nh, T, hd] in the inputs' type.
// q_order (int32 on the device, one query tile of 128 rows per group of
// B * nh blocks), head_pad, stages, smem and blocks from the launch plan.
HQQ_EXPORT int hqq_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* dd, void* dq, const int* q_order,
                                HQQ_BWD_SHAPE, int stages, int smem, int blocks, void* stream) {
  const Args a{q,    k,      v,     dout,   lse,  dd,    b,    nh,     n_kv,  t, t, hd,
               scale, causal, dtype, stages, smem, blocks, static_cast<cudaStream_t>(stream)};
  if (!valid(a, head_pad) || q_order == nullptr || dq == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
#define HQQ_DQ(T, HDP) \
  if (head_pad == HDP) return launch_dq<T, HDP>(a, dq, q_order)
  if (dtype == HQQ_BF16) {
    HQQ_DQ(__nv_bfloat16, 64);
    HQQ_DQ(__nv_bfloat16, 128);
    HQQ_DQ(__nv_bfloat16, 256);
  } else {
    HQQ_DQ(__half, 64);
    HQQ_DQ(__half, 128);
    HQQ_DQ(__half, 256);
  }
#undef HQQ_DQ
  return static_cast<int>(cudaErrorInvalidValue);
}

HQQ_EXPORT const char* hqq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
