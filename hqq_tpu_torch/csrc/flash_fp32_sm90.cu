// SPDX-License-Identifier: Apache-2.0
// The fp32 forward of flash attention over whole sequences, on the tensor
// cores: out = softmax(scale * q k^T [causal]) v to fp32 accuracy, and each
// row's log-sum-exp lse = ln sum_j exp(scale * q . k_j) (natural log, fp32
// [B, nh, T]) where a gradient is wanted; the fp32 backward kernels of
// flash_backward_fp32_sm90.cu read it.
//
// Replaces, for fp32 inputs: the library flash-attention kernel that
// `hqq_tpu.ops.attention.prefill_attention` calls (`hqq_tpu/ops/attention.py`
// :66), which takes any input type and multiplies in it. The bf16/fp16
// kernel of flash_prefill.cu rounds the inputs to its type, which is no
// fp32 result.
// Bound on H100: operations. An fp32-accurate product from TF32 takes three
//   TF32 products: 3 * 4 * T^2 * hd per head, halved under causality, at
//   495 TFLOP/s: 0.052 ms at (1, 32/32, 1024, 128) against 0.128 ms for one
//   fp32 product at the CUDA cores' 67 TFLOP/s.
// Design (3xTF32 on wgmma, the pattern of flash_prefill.cu and qmm_fp32.cu):
//   * a block owns 64 query rows of one (batch, head): a producer warpgroup
//     whose one thread loads Q's tile once and K's and V's tiles of BN keys
//     (64, 32 or 8 at head sizes 64, 128, 256) through a ring of 2-4 slots
//     by TMA, in panels of 32 head columns (one 128-byte row of fp32): Q and
//     K in the 128-byte swizzle, V plain; TMA fills rows past T and columns
//     past the head size with zeros;
//   * one consumer warpgroup (two at head size 256, each owning 128 of the
//     output columns, both forming the whole S) splits every operand into
//     TF32 parts, big = rna(v) and small = rna(v - big) (`cvt.rna`): Q once,
//     in place, its small part beside it; each K tile in place in its slot,
//     the small part into one buffer; each V tile into V^T big and small,
//     written K-major along the keys, because TF32 wgmma takes no transpose;
//   * S = Q_big K_small + Q_small K_big + Q_big K_big: three wgmma chains
//     m64nBNk8 tf32 with both operands K-major in shared memory, into
//     zeroed registers (only small x small, ~2^-22 of a product, dropped);
//   * the online softmax in fp32 on the accumulator layout (a row's values
//     lie in the four lanes of a quad); P split the same way stays in the
//     registers as the A operand of O_tile = P_big V_small + P_small V_big +
//     P_big V_big (wgmma m64nOCk8 tf32, A from registers). An accumulator's
//     8 columns hold keys 2c and 2c + 1 where TF32's A fragment wants columns
//     c and c + 4, so V^T stores each 8 keys in the order 0 2 4 6 1 3 5 7
//     and the fragment is the accumulator's registers in another order;
//   * each tile's O_tile comes into zeroed registers and is added to the
//     fp32 output sums on the CUDA cores (O = O * corr + O_tile), as
//     qmm_fp32.cu folds each slab: the tensor core's own accumulation over
//     many products loses low bits (qmm_fp32: 3.6e-5 of max|y| at K = 4096);
//   * causal blocks walk the key tiles up to their diagonal and mask only
//     the tiles that cross it (and the ragged last one); the launch plan's
//     table of query tiles (`flash_fp32_launch_plan`) starts with the tiles
//     that walk the most key tiles. GQA is an index (kv head = h / rep).
// Shared memory bounds the tiles: Q in two parts takes 64 * hd * 8 bytes
// (64 KB at 128), so a block has one consumer and the SM one block.
#include <math.h>

#include "sm90_ptx.cuh"

namespace {

using namespace sm90;

constexpr int kBM = 64;  // query rows of a block

// Shared-memory carve-up; ops/attention.py `flash_fp32_smem_bytes` computes
// the same sizes.
struct Fp32FlashSmem {
  int qs, ks, vt, vts, ring, stage, bars, total;
};

__host__ __device__ inline Fp32FlashSmem fp32_flash_smem(int hdp, int bn, int stages) {
  Fp32FlashSmem s;
  const int tile = bn * hdp * 4;  // a K or V tile, and V^T
  s.qs = kBM * hdp * 4;           // Q (big after the split) from 0
  s.ks = 2 * s.qs;
  s.vt = s.ks + tile;
  s.vts = s.vt + tile;
  s.ring = s.vts + tile;
  s.stage = 2 * tile;  // K's tile, then V's
  s.bars = s.ring + stages * s.stage;
  s.total = s.bars + 8 * (1 + 2 * stages) + 1024;  // + slack to align the base to 1024
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
// part to the same offsets of `small`; thread `tid` of `n` (16-byte chunks:
// the swizzle does not matter)
__device__ __forceinline__ void split_in_place(uint8_t* big, uint8_t* small, int bytes, int tid,
                                               int n) {
  for (int c = tid * 16; c < bytes; c += n * 16) {
    float4 v = *reinterpret_cast<const float4*>(big + c);
    const float4 s = split4(v);
    *reinterpret_cast<float4*>(big + c) = v;
    *reinterpret_cast<float4*>(small + c) = s;
  }
}

// The byte offset of the 16-byte chunk h (keys 8g + {0,2,4,6} for h = 0,
// 8g + {1,3,5,7} for h = 1) of row n of V^T: rows of BN keys, K-major, in
// the 128-byte swizzle (BN >= 32, panels of 32 keys, each HDP rows of 128
// bytes) or the 32-byte swizzle (BN = 8)
template <int HDP, int BN>
__device__ __forceinline__ int vt_offset(int n, int g, int h) {
  if constexpr (BN >= 32) {
    return g / 4 * HDP * 128 + sw128(n, 2 * (g % 4) + h);
  } else {
    return n * 32 + ((h ^ ((n >> 2) & 1)) << 4);
  }
}

// Consumer `wg`'s columns of V's tile (plain rows of 128 bytes in panels of
// 32 columns) as V^T big and small, each 8 keys in the order 0 2 4 6 1 3 5 7
template <int HDP, int BN, int OC>
__device__ __forceinline__ void transpose_v(const uint8_t* v, uint8_t* vt, uint8_t* vts, int wg,
                                            int ct) {
  for (int item = ct; item < OC * (BN / 8); item += 128) {
    const int n = wg * OC + item % OC, g = item / OC;
    const float* src = reinterpret_cast<const float*>(v + n / 32 * BN * 128) + n % 32;
    float x[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = src[(8 * g + i) * 32];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float4 b = make_float4(x[h], x[h + 2], x[h + 4], x[h + 6]);
      const float4 s = split4(b);
      const int off = vt_offset<HDP, BN>(n, g, h);
      *reinterpret_cast<float4*>(vt + off) = b;
      *reinterpret_cast<float4*>(vts + off) = s;
    }
  }
}

// the descriptor of k8 step j of consumer wg's V^T rows
template <int HDP, int BN, int OC>
__device__ __forceinline__ uint64_t vt_desc(uint32_t vt, int wg, int j) {
  if constexpr (BN >= 32) {
    return sw128_desc(vt + j / 4 * HDP * 128 + wg * OC * 128) + 2 * (j % 4);
  } else {
    return sw32_desc(vt + wg * OC * 32);
  }
}

template <int HDP, int BN, int NC>
__global__ void __launch_bounds__(128 * (1 + NC), 1)
    flash_fp32_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap, float* __restrict__ out,
                      float* __restrict__ lse, const int* __restrict__ q_order, int bh, int nh,
                      int rep, int t, int hd, float scale_log2, int causal, int stages) {
  constexpr int kPanels = HDP / 32;
  constexpr int OC = HDP / NC;  // output columns of a consumer
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~static_cast<uintptr_t>(1023));
  const Fp32FlashSmem L = fp32_flash_smem(HDP, BN, stages);
  const uint32_t q_full = smem_u32(smem + L.bars);
  const uint32_t full0 = q_full + 8;
  const uint32_t empty0 = full0 + 8 * stages;

  const int qt = __ldg(q_order + blockIdx.x / bh);
  const int head = static_cast<int>(blockIdx.x) % bh;  // b * nh + h
  const int kv_head = head / nh * (nh / rep) + head % nh / rep;
  const int m0 = qt * kBM;
  const int all_tiles = (t + BN - 1) / BN;
  const int n_tiles = causal ? min(all_tiles, (min(t, m0 + kBM) + BN - 1) / BN) : all_tiles;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);    // the TMA's expect_tx
      mbar_init(empty0 + 8 * s, NC);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, kBM * HDP * 4);
#pragma unroll
      for (int pn = 0; pn < kPanels; ++pn)
        tma_load_3d(smem_u32(smem + pn * kBM * 128), &qmap, q_full, 32 * pn, m0, head);
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int s = kt % stages;
        mbar_wait(empty0 + 8 * s, ((kt / stages) & 1) ^ 1);
        const uint32_t full = full0 + 8 * s;
        const uint32_t ks = smem_u32(smem + L.ring + s * L.stage);
        const uint32_t vs = ks + BN * HDP * 4;
        mbar_expect_tx(full, 2 * BN * HDP * 4);
#pragma unroll
        for (int pn = 0; pn < kPanels; ++pn) {
          tma_load_3d(ks + pn * BN * 128, &kmap, full, 32 * pn, kt * BN, kv_head);
          tma_load_3d(vs + pn * BN * 128, &vmap, full, 32 * pn, kt * BN, kv_head);
        }
      }
    }
  } else {
    // ---- consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = threadIdx.x / 128 - 1;
    const int ct = threadIdx.x % 128, warp = ct / 32, lane = ct % 32;
    const int tid = threadIdx.x - 128;                 // of the NC * 128 consumer threads
    const int row_a = m0 + warp * 16 + lane / 4;       // this thread's rows: row_a and row_a + 8
    const int col_t = 2 * (lane % 4);                  // and its columns 8j + col_t, + 1

    mbar_wait(q_full, 0);
    split_in_place(smem, smem + L.qs, kBM * HDP * 4, tid, NC * 128);
    fence_proxy_async();
    named_sync<NC * 128>(1);
    const uint64_t dqb = sw128_desc(smem_u32(smem));
    const uint64_t dqs = sw128_desc(smem_u32(smem + L.qs));
    const uint64_t dks = sw128_desc(smem_u32(smem + L.ks));
    const uint32_t vt = smem_u32(smem + L.vt), vts = smem_u32(smem + L.vts);

    float o[OC / 2];
#pragma unroll
    for (int i = 0; i < OC / 2; ++i) o[i] = 0.f;
    float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};

    for (int kt = 0; kt < n_tiles; ++kt) {
      const int s = kt % stages;
      const int n0 = kt * BN;
      uint8_t* kraw = smem + L.ring + s * L.stage;
      mbar_wait(full0 + 8 * s, (kt / stages) & 1);
      if constexpr (NC > 1) named_sync<NC * 128>(2);  // the other's S read K_small
      split_in_place(kraw, smem + L.ks, BN * HDP * 4, tid, NC * 128);
      transpose_v<HDP, BN, OC>(kraw + BN * HDP * 4, smem + L.vt, smem + L.vts, wg, ct);
      fence_proxy_async();
      named_sync<NC * 128>(1);

      // S = Q_big K_small + Q_small K_big + Q_big K_big, into zeroed registers
      float sc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
      const uint64_t dkb = sw128_desc(smem_u32(kraw));
      fence_acc(sc);
      wgmma_fence();
#pragma unroll
      for (int chain = 0; chain < 3; ++chain) {
        const uint64_t da = chain == 1 ? dqs : dqb;
        const uint64_t db = chain == 0 ? dks : dkb;
#pragma unroll
        for (int kk = 0; kk < HDP / 8; ++kk) {
          const int pn = kk / 4, step = 2 * (kk % 4);
          wgmma<float, BN>(sc, da + (pn * kBM * 128 >> 4) + step, db + (pn * BN * 128 >> 4) + step);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sc);
      if (ct == 0) mbar_arrive(empty0 + 8 * s);  // K's and V's raw tiles are read

      // online softmax on the thread's two rows (h >> 1 picks the row)
      const bool mask = n0 + BN > t || (causal && n0 + BN - 1 > m0);
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
      // P in fp32, split; the A fragment of k8 step j: rows r, r + 8 at
      // "columns" c (key 2c) and c + 4 (key 2c + 1)
      uint32_t pb[BN / 8][4], ps[BN / 8][4];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        float p[4];
#pragma unroll
        for (int h = 0; h < 4; ++h) p[h] = exp2f(sc[4 * j + h] - mx[h >> 1]);
        psum[0] += p[0] + p[1];
        psum[1] += p[2] + p[3];
        const int order[4] = {0, 2, 1, 3};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float b = tf32_rna(p[order[i]]);
          pb[j][i] = __float_as_uint(b);
          ps[j][i] = __float_as_uint(tf32_rna(__fsub_rn(p[order[i]], b)));
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 1);
        psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 2);
        sum[i] = sum[i] * corr[i] + psum[i];
      }

      // O_tile = P_big V_small + P_small V_big + P_big V_big, then folded
      float op[OC / 2];
#pragma unroll
      for (int i = 0; i < OC / 2; ++i) op[i] = 0.f;
      fence_acc(op);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) wgmma_rs<float, OC>(op, pb[j], vt_desc<HDP, BN, OC>(vts, wg, j));
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) wgmma_rs<float, OC>(op, ps[j], vt_desc<HDP, BN, OC>(vt, wg, j));
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) wgmma_rs<float, OC>(op, pb[j], vt_desc<HDP, BN, OC>(vt, wg, j));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(op);
#pragma unroll
      for (int j = 0; j < OC / 8; ++j)
#pragma unroll
        for (int h = 0; h < 4; ++h) o[4 * j + h] = fmaf(o[4 * j + h], corr[h >> 1], op[4 * j + h]);
    }

    // out = O / sum; rows below T, columns below hd; the first lane of a
    // row's quad stores its log-sum-exp, (max + log2 sum) * ln 2
    const float inv[2] = {1.f / sum[0], 1.f / sum[1]};
    if (lse != nullptr && wg == 0 && lane % 4 == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (row_a + 8 * i < t)
          lse[static_cast<size_t>(head) * t + row_a + 8 * i] =
              (mx[i] + log2f(sum[i])) * 0.6931471805599453f;
    }
    float* base = out + static_cast<size_t>(head) * t * hd;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row_a + 8 * i;
      if (row >= t) continue;
      float* dst = base + static_cast<size_t>(row) * hd;
#pragma unroll
      for (int j = 0; j < OC / 8; ++j) {
        const int col = wg * OC + 8 * j + col_t;
        if (col < hd)
          *reinterpret_cast<float2*>(dst + col) =
              make_float2(o[4 * j + 2 * i] * inv[i], o[4 * j + 2 * i + 1] * inv[i]);
      }
    }
  }
}

// q, k or v fp32 [heads, T, hd] as boxes of [rows x 32 head columns] (zeros
// past T and past hd), in the 128-byte swizzle or plain
int encode_fp32(CUtensorMap* map, const void* base, int heads, int t, int hd, int rows,
                CUtensorMapSwizzle swizzle) {
  const long dims[3] = {hd, t, heads}, strides[2] = {4L * hd, 4L * hd * t};
  const int box[3] = {32, rows, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, base, dims, strides, box, swizzle);
}

template <int HDP, int BN, int NC>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, const int* q_order,
           int b, int nh, int n_kv, int t, int hd, float scale, int causal, int stages, int smem,
           int blocks, cudaStream_t stream) {
  if (stages < 2 || smem < fp32_flash_smem(HDP, BN, stages).total)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qm, km, vm;
  if (encode_fp32(&qm, q, b * nh, t, hd, kBM, CU_TENSOR_MAP_SWIZZLE_128B) != 0 ||
      encode_fp32(&km, k, b * n_kv, t, hd, BN, CU_TENSOR_MAP_SWIZZLE_128B) != 0 ||
      encode_fp32(&vm, v, b * n_kv, t, hd, BN, CU_TENSOR_MAP_SWIZZLE_NONE) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_fp32_kernel<HDP, BN, NC>;
  int e = static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (e != 0) return e;
  kernel<<<blocks, 128 * (1 + NC), smem, stream>>>(qm, km, vm, static_cast<float*>(out), lse,
                                                   q_order, b * nh, nh, nh / n_kv, t, hd,
                                                   scale * 1.4426950408889634f, causal, stages);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q and out [B, nh, T, hd], k and v [B, n_kv, T, hd], all fp32, contiguous
// and 16-byte aligned; head_dim a multiple of 16, at most 256; nh a multiple
// of n_kv. lse: fp32 [B, nh, T], or null for none. q_order (int32 on the
// device, one query tile per group of B * nh blocks), head_pad, key_tile,
// consumers, stages, smem and blocks come from the launch plan
// (`flash_fp32_launch_plan`).
HQQ_EXPORT int hqq_flash_fp32(const void* q, const void* k, const void* v, void* out, void* lse,
                              const int* q_order, int b, int nh, int n_kv, int t, int hd,
                              float scale, int causal, int head_pad, int key_tile, int consumers,
                              int stages, int smem, int blocks, void* stream) {
  if (b < 1 || nh < 1 || n_kv < 1 || nh % n_kv || t < 1 || hd < 16 || hd % 16 ||
      hd > head_pad || q_order == nullptr ||
      static_cast<long>(blocks) != static_cast<long>(b) * nh * ((t + kBM - 1) / kBM)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<float*>(lse);
#define HQQ_FLASH_FP32(HDP, BN, NC)                                                          \
  if (head_pad == HDP && key_tile == BN && consumers == NC)                                 \
  return launch<HDP, BN, NC>(q, k, v, out, l, q_order, b, nh, n_kv, t, hd, scale, causal,   \
                             stages, smem, blocks, st)
  HQQ_FLASH_FP32(64, 64, 1);
  HQQ_FLASH_FP32(128, 32, 1);
  HQQ_FLASH_FP32(256, 8, 2);
#undef HQQ_FLASH_FP32
  return static_cast<int>(cudaErrorInvalidValue);
}

HQQ_EXPORT const char* hqq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
