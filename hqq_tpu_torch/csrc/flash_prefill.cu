// SPDX-License-Identifier: Apache-2.0
// Flash attention over whole sequences (perplexity evaluation, training
// forward): causal or full self-attention with an online softmax, so that the
// [T, T] scores never reach device memory.
//
// Replaces the TPU flash-attention kernel that
// `hqq_tpu.ops.attention.prefill_attention` hands long causal sequences to.
// It computes what `_naive` computes under the causal mask:
//   out[b, h, i] = softmax_j(scale * q[b, h, i] . k[b, h / rep, j]) @ v,
//   j <= i (causal) or every j < T,
// with fp32 scores, fp32 softmax statistics and an fp32 output sum, the
// probabilities rounded to q's type before the product with V and the
// division by the fp32 sum, and the output rounded once to q's type. bf16
// and fp16 (fp32 takes the 3xTF32 kernel of flash_fp32_sm90.cu). Where a
// gradient is wanted it also writes each row's log-sum-exp,
// lse = ln sum_j exp(scale * q . k_j) in fp32 [B, nh, T], for the backward
// kernels: a runtime option (a null pointer skips it), one store per row
// from the consumer's registers after the last tile, so evaluation pays a
// branch and no bytes.
//
// Bound by operations on this card (4 * T * T * head_dim per head, halved
// under causality, against 2 * T * head_dim values read and written).
// Design (wgmma, TMA and an mbarrier ring, in the PTX of sm90_ptx.cuh):
//   * a block owns 128 query rows of one (batch, head): a producer warp and
//     two consumer warpgroups of 64 rows each. The producer loads Q's tile
//     once and K's and V's tiles of BN keys (128, or 64 at head size 256)
//     through a ring of 2-4 slots, all by TMA in the 128-byte swizzle, in
//     panels of 64 head columns; TMA zero-fills rows past T and columns
//     past the head size, so head sizes pad to 64, 128 or 256 and the
//     padded columns add zeros;
//   * S = Q K^T is wgmma m64nBNk16 with both operands K-major in shared
//     memory; S stays in registers, and each row's max and sum come from
//     the accumulator layout (a row's values lie in four lanes of a quad)
//     by two shuffles;
//   * P, rounded to q's type, never leaves the registers: an accumulator's
//     16 columns are the A fragment of the next wgmma, so O += P V is the
//     register-sourced wgmma m64nHDk16 with V read MN-major from shared
//     memory (the transpose bit of 16-bit wgmma, V's 64-column panels one
//     LBO apart);
//   * O is an fp32 accumulator in registers, rescaled there when a row's
//     max moves, divided by the fp32 sum and rounded once at the end; only
//     rows below T and columns below the head size are stored;
//   * causal blocks walk the key tiles up to their diagonal, mask only the
//     tiles that cross it (and the ragged last one), and skip the products
//     of a tile that lies wholly above a consumer's rows; a block takes its
//     query tile from the launch plan's table (`flash_launch_plan`), which
//     starts with the tiles that walk the most key tiles, so a causal grid
//     ends on short blocks;
//   * GQA is an index (kv head = h / rep), K and V arrive unrepeated.
// The consumers issue their products one after another (S, softmax, PV):
// overlapping one tile's softmax with the next tile's S is the next step.
#include <math.h>

#include "sm90_ptx.cuh"

namespace {

using namespace sm90;

constexpr int kBM = 128;       // query rows of a block
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups

// Shared-memory carve-up; ops/attention.py `flash_launch_plan` computes the
// same sizes.
struct FlashSmem {
  int q, kv, stage, bars, total;
};

__host__ __device__ inline FlashSmem flash_smem(int hdp, int bn, int stages) {
  FlashSmem s;
  s.q = 0;
  s.kv = kBM * hdp * 2;
  s.stage = 2 * bn * hdp * 2;  // K's tile, then V's
  s.bars = s.kv + stages * s.stage;
  s.total = s.bars + 8 * (1 + 2 * stages) + 1024;  // + slack to align the base to 1024
  return s;
}

template <typename T, int HDP, int BN>
__global__ void __launch_bounds__(kThreads, 1)
    flash_prefill_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap, T* __restrict__ out,
                         float* __restrict__ lse, const int* __restrict__ q_order, int bh, int nh,
                         int rep, int t, int hd, float scale_log2, int causal, int stages) {
  constexpr int kPanels = HDP / 64;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~static_cast<uintptr_t>(1023));
  const FlashSmem L = flash_smem(HDP, BN, stages);
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

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);   // the TMA's expect_tx
      mbar_init(empty0 + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, kBM * HDP * 2);
#pragma unroll
      for (int pn = 0; pn < kPanels; ++pn)
        tma_load_3d(smem_u32(smem + L.q + pn * kBM * 128), &qmap, q_full, 64 * pn, m0, head);
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int s = kt % stages;
        mbar_wait(empty0 + 8 * s, ((kt / stages) & 1) ^ 1);
        const uint32_t full = full0 + 8 * s;
        const uint32_t ks = smem_u32(smem + L.kv + s * L.stage);
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
    // ---- consumer warpgroups: 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = threadIdx.x / 128 - 1;
    const int ct = threadIdx.x % 128, warp = ct / 32, lane = ct % 32;
    const int row0 = m0 + wg * 64;                     // the warpgroup's first row
    const int row_a = row0 + warp * 16 + lane / 4;     // this thread's rows: row_a and row_a + 8
    const int col_t = 2 * (lane % 4);                  // and its columns 8j + col_t, + 1

    float o[HDP / 2];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) o[i] = 0.f;
    float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};

    const uint64_t dq = sw128_desc(smem_u32(smem + L.q + wg * 64 * 128));
    mbar_wait(q_full, 0);
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int s = kt % stages;
      const int n0 = kt * BN;
      mbar_wait(full0 + 8 * s, (kt / stages) & 1);
      if (!causal || n0 <= row0 + 63) {  // else every key lies above the rows
        const uint32_t ks = smem_u32(smem + L.kv + s * L.stage);
        const uint32_t vs = ks + BN * HDP * 2;

        // S = Q K^T, in registers
        float sc[BN / 2];
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
        const uint64_t dk = sw128_desc(ks);
        fence_acc(sc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HDP / 16; ++kk) {
          const int pn = kk / 4, step = 2 * (kk % 4);
          wgmma<T, BN>(sc, dq + (pn * kBM * 128 >> 4) + step, dk + (pn * BN * 128 >> 4) + step);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(sc);

        // online softmax on the thread's two rows (h >> 1 picks the row)
        const bool mask = n0 + BN > t || (causal && n0 + BN - 1 > row0);
        float tile_mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            float v = sc[4 * j + h] * scale_log2;
            if (mask) {
              const int col = n0 + 8 * j + col_t + (h & 1);
              if (col >= t || (causal && col > row_a + 8 * (h >> 1))) v = -INFINITY;
            }
            sc[4 * j + h] = v;
            tile_mx[h >> 1] = fmaxf(tile_mx[h >> 1], v);
          }
        float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          tile_mx[i] = fmaxf(tile_mx[i], __shfl_xor_sync(0xffffffffu, tile_mx[i], 1));
          tile_mx[i] = fmaxf(tile_mx[i], __shfl_xor_sync(0xffffffffu, tile_mx[i], 2));
          const float mn = fmaxf(mx[i], tile_mx[i]);  // finite: key 0 is in every row's first tile
          corr[i] = exp2f(mx[i] - mn);
          mx[i] = mn;
        }
        uint32_t pa[BN / 16][4];  // P in q's type: the A fragments of O += P V
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const float p0 = exp2f(sc[4 * j] - mx[0]), p1 = exp2f(sc[4 * j + 1] - mx[0]);
          const float p2 = exp2f(sc[4 * j + 2] - mx[1]), p3 = exp2f(sc[4 * j + 3] - mx[1]);
          psum[0] += p0 + p1;
          psum[1] += p2 + p3;
          pa[j / 2][2 * (j & 1)] = pack2<T>(p0, p1);
          pa[j / 2][2 * (j & 1) + 1] = pack2<T>(p2, p3);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 1);
          psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 2);
          sum[i] = sum[i] * corr[i] + psum[i];
        }
#pragma unroll
        for (int j = 0; j < HDP / 8; ++j)
#pragma unroll
          for (int h = 0; h < 4; ++h) o[4 * j + h] *= corr[h >> 1];

        // O += P V: keys are V's rows (K of the product), its head columns N
        fence_acc(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          wgmma_rs<T, HDP>(o, pa[kk], sw128_mn_desc(vs + kk * 16 * 128, BN * 128));
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(o);
      }
      if (ct == 0) mbar_arrive(empty0 + 8 * s);
    }

    // out = O / sum, rounded once; rows below T, columns below hd. A row's
    // max and sum sit in the four lanes of its quad: the first stores its
    // log-sum-exp, (max + log2 sum) * ln 2 (the max is in log2 units)
    const float inv[2] = {1.f / sum[0], 1.f / sum[1]};
    if (lse != nullptr && lane % 4 == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (row_a + 8 * i < t)
          lse[static_cast<size_t>(head) * t + row_a + 8 * i] =
              (mx[i] + log2f(sum[i])) * 0.6931471805599453f;
    }
    T* base = out + static_cast<size_t>(head) * t * hd;
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
              pack2<T>(o[4 * j + 2 * i] * inv[i], o[4 * j + 2 * i + 1] * inv[i]);
      }
    }
  }
}

// q, k or v [heads, T, hd] as boxes of [rows x 64 head columns] in the
// 128-byte swizzle (zeros past T and past hd)
int encode_qkv(CUtensorMap* map, const void* base, int heads, int t, int hd, int rows,
               int dtype) {
  const long dims[3] = {hd, t, heads}, strides[2] = {2L * hd, 2L * hd * t};
  const int box[3] = {64, rows, 1};
  return encode_map(map,
                    dtype == HQQ_BF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                      : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
                    3, base, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <typename T, int HDP, int BN>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, const int* q_order,
           int b, int nh, int n_kv, int t, int hd, float scale, int causal, int dtype, int stages,
           int smem, int blocks, cudaStream_t stream) {
  if (stages < 2 || smem < flash_smem(HDP, BN, stages).total)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qm, km, vm;
  if (encode_qkv(&qm, q, b * nh, t, hd, kBM, dtype) != 0 ||
      encode_qkv(&km, k, b * n_kv, t, hd, BN, dtype) != 0 ||
      encode_qkv(&vm, v, b * n_kv, t, hd, BN, dtype) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_prefill_kernel<T, HDP, BN>;
  int e = static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (e != 0) return e;
  kernel<<<blocks, kThreads, smem, stream>>>(qm, km, vm, static_cast<T*>(out), lse, q_order, b * nh,
                                             nh, nh / n_kv, t, hd, scale * 1.4426950408889634f,
                                             causal, stages);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_head(const void* q, const void* k, const void* v, void* out, float* lse,
                const int* q_order, int b, int nh, int n_kv, int t, int hd, float scale,
                int causal, int dtype, int head_pad, int key_tile, int stages, int smem,
                int blocks, cudaStream_t st) {
#define HQQ_FLASH_LAUNCH(HDP, BN)                                                             \
  if (head_pad == HDP && key_tile == BN)                                                     \
  return launch<T, HDP, BN>(q, k, v, out, lse, q_order, b, nh, n_kv, t, hd, scale, causal,   \
                            dtype, stages, smem, blocks, st)
  HQQ_FLASH_LAUNCH(64, 128);
  HQQ_FLASH_LAUNCH(128, 128);
  HQQ_FLASH_LAUNCH(256, 64);
#undef HQQ_FLASH_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q and out [B, nh, T, hd], k and v [B, n_kv, T, hd], all bf16 (dtype 1) or
// fp16 (dtype 2), contiguous and 16-byte aligned; head_dim a multiple of 16,
// at most 256; nh a multiple of n_kv. lse: fp32 [B, nh, T], or null for
// none. q_order (int32 on the device, one query tile per group of B * nh
// blocks), head_pad, key_tile, stages, smem and blocks come from the launch
// plan (`flash_launch_plan`).
HQQ_EXPORT int hqq_flash_prefill(const void* q, const void* k, const void* v, void* out,
                                 void* lse, const int* q_order, int b, int nh, int n_kv, int t,
                                 int hd, float scale, int causal, int dtype, int head_pad,
                                 int key_tile, int stages, int smem, int blocks, void* stream) {
  if (b < 1 || nh < 1 || n_kv < 1 || nh % n_kv || t < 1 || hd < 16 || hd % 16 ||
      hd > head_pad || q_order == nullptr ||
      static_cast<long>(blocks) != static_cast<long>(b) * nh * ((t + kBM - 1) / kBM)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == HQQ_BF16)
    return launch_head<__nv_bfloat16>(q, k, v, out, static_cast<float*>(lse), q_order, b, nh,
                                      n_kv, t, hd, scale, causal, dtype, head_pad, key_tile,
                                      stages, smem, blocks, st);
  if (dtype == HQQ_F16)
    return launch_head<__half>(q, k, v, out, static_cast<float*>(lse), q_order, b, nh, n_kv, t,
                               hd, scale, causal, dtype, head_pad, key_tile, stages, smem,
                               blocks, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

HQQ_EXPORT const char* hqq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
