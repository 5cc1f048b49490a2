// SPDX-License-Identifier: Apache-2.0
// Paged decode attention: one query row per (slot, query head) against the
// slot's keys and values, which lie in fixed-size pages of a shared pool and
// are found through a block table.
//
// Replaces the TPU paged-attention kernel that `hqq_tpu.ops.paged.paged_attn`
// hands plain-causal decode to. It computes what `paged_attention_ref`
// computes for window = softcap = sinks = None:
//   out[b, h] = softmax_s(q[b, h] . K[h / rep, tab[b, s / pg], s % pg]) @ V,
//   s < lengths[b],
// with fp32 scores, an fp32 softmax and an fp32 output sum, rounded once to
// q's type. q arrives pre-scaled. Pages are bf16, fp16 or fp32 (q of the same
// type), or int8 with one fp32 scale per row (q fp32): then a row's score is
// multiplied by k_scale / 127 and its probability by v_scale / 127 in the
// kernel, and no dequantized page is ever written.
//
// Bound by bytes on this card: every attended K and V row is read once and
// used for 2 * head_dim multiply-adds per query head. What limits a sweep
// over pages is the bytes in flight: at 3.35 TB/s and ~1 us of latency an SM
// needs some 25-30 KB on its way. So pages travel whole:
//   * a block owns one (slot, kv head, split) and serves `qh` query heads of
//     that kv head (the launch plan's `heads_per_block`, a divisor of
//     rep = nh / n_kv; rep / qh groups of blocks), so a page is fetched once
//     for all of them;
//   * a producer warp walks the block table and moves `pps` pages at a time
//     (a stage of at least 16 rows) into a ring of `stages` mbarrier-guarded
//     slots: one bulk copy (cp.async.bulk, no tensor map) per K page, per V
//     page and, for int8, per run of the page's K and V scales, which the
//     pool holds contiguously; where a page or a scale run breaks the bulk
//     copy's 16-byte rule (`paged_launch_plan`: pg * hd * size or pg * 4 not
//     a multiple of 16) the warp's 32 lanes copy it by 4-byte cp.async. The
//     lanes hold the split's block-table entries 32 at a time, so no copy
//     waits on a load of its page number;
//   * `warps` consumer warps (8, fewer only where a slot each would keep
//     two blocks off an SM) take the stages, slot s always to warp
//     s % warps; the ring holds a slot per warp (two where that is under
//     32 KB). A warp reads a row in 16-byte vectors from shared memory
//     (`lanes` lanes a row, 32 / lanes rows at a time, two rows per lane
//     per step), forms each query head's
//     score with a shuffle reduction over the row's lanes, and keeps an
//     online softmax per head: running max (warp-uniform), running sum and
//     output sums per lane, rescaled only when the max moves. The scales
//     arrive with their page, so no global load waits inside the key loop;
//   * rows at or past lengths[b] (a whole page holds them) are selected out
//     before the max and before P.V: their score is -inf, their weight 0,
//     and they are never loaded (a lane past the end reads the stage's last
//     valid row again), so NaN there changes nothing. No block-table entry
//     at or past ceil(lengths[b] / pg) is read;
//   * the warps' softmaxes merge through shared memory (the ring, free once
//     every stage is consumed); where (slot, kv head) pairs cannot fill the
//     card the plan splits each slot's stages over `splits` blocks, which
//     write (max, sum, unnormalised output) in fp32 for a second small
//     kernel to merge.
// A slot of length 0 gets zeros.
#include <math.h>

#include "sm90_ptx.cuh"

// 1 builds the variant that reads each row's scales from device memory
// inside the key loop (through the block table), as the parent design did;
// for measuring what scales that arrive with their page buy
#ifndef HQQ_PAGED_GLOBAL_SCALES
#define HQQ_PAGED_GLOBAL_SCALES 0
#endif


namespace {

using namespace sm90;

constexpr int kMaxWarps = 8;                    // consumer warps of a block, at most
constexpr int kThreads = 32 * (1 + kMaxWarps);  // a producer warp, then the consumers
constexpr int kMaxHd = 256;

// Page and q types of the C entry.
enum PagedDtype { PAGED_F32 = 0, PAGED_BF16 = 1, PAGED_F16 = 2, PAGED_INT8 = 3 };

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

// Shared-memory carve-up; ops/paged.py `paged_smem_bytes` computes the same
// sizes. A stage: K's pages, V's pages, then (int8) K's and V's scale runs.
struct PagedSmem {
  int v, ks, vs, stage, merge, bars, total;
};

__host__ __device__ inline PagedSmem paged_smem(int row_bytes, int pg, int pps, int stages,
                                                int quant, int qh, int hd, int warps) {
  PagedSmem s;
  const int run = align16(pps * pg * row_bytes);
  const int scales = quant ? align16(pps * pg * 4) : 0;
  s.v = run;
  s.ks = 2 * run;
  s.vs = 2 * run + scales;
  s.stage = 2 * run + 2 * scales;
  s.merge = warps * qh * (hd + 2) * 4;  // each warp's max, sum and output per head
  const int ring = stages * s.stage;
  s.bars = align16(ring > s.merge ? ring : s.merge);
  s.total = s.bars + 16 * stages;
  return s;
}

// the elements of one 16-byte vector of a page row
template <typename KV>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int E = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int E = 8;
};
template <>
struct Vec<__half> {
  static constexpr int E = 8;
};
template <>
struct Vec<int8_t> {
  static constexpr int E = 16;
};

// one 32-bit word of a row, widened to fp32 (E / 4 values)
__device__ __forceinline__ void widen(uint32_t w, float* x, float) { x[0] = __uint_as_float(w); }
__device__ __forceinline__ void widen(uint32_t w, float* x, __nv_bfloat16) {
  x[0] = __uint_as_float(w << 16), x[1] = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ void widen(uint32_t w, float* x, __half) {
  const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w));
  x[0] = f.x, x[1] = f.y;
}
__device__ __forceinline__ void widen(uint32_t w, float* x, int8_t) {
  // byte b + 128 under the exponent of 2^23: 2^23 + 128 + b exactly, full-rate
  // instructions where a conversion runs at a quarter of the rate
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    x[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + i)) - 8388736.f;
}

// the 16-byte vector at byte `off` of a row in shared memory: one 16-byte
// read where rows are 16-byte aligned (`vec16`), else four 4-byte reads, the
// words past the row's end zero (they would be the next row's)
template <typename KV>
__device__ __forceinline__ void load_vec(const uint8_t* row, int off, int row_bytes, bool vec16,
                                         float (&x)[Vec<KV>::E]) {
  uint32_t w[4];
  if (vec16) {
    const uint4 t = *reinterpret_cast<const uint4*>(row + off);
    w[0] = t.x, w[1] = t.y, w[2] = t.z, w[3] = t.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = off + 4 * i < row_bytes ? *reinterpret_cast<const uint32_t*>(row + off + 4 * i) : 0u;
  }
  constexpr int kPer = Vec<KV>::E / 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) widen(w[i], x + kPer * i, KV());
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

__device__ __forceinline__ void store1(float* out, size_t i, float v) { out[i] = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* out, size_t i, float v) {
  out[i] = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store1(__half* out, size_t i, float v) {
  out[i] = __float2half_rn(v);
}

struct PagedArgs {
  const void* q;
  const uint8_t* kp;
  const uint8_t* vp;
  const float* ks;
  const float* vs;
  const int* lengths;
  const int* tab;
  void* out;
  float* part;
  int nh, rep, hd, num_pages, pg, mp, splits;
  int row_bytes, pps, stages, warps, lanes_log2, bulk, vec16;
};

// barrier `id` over `n` threads (the consumer warps)
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// KV: the pages' type; Q: q's and the output's type; QH: query heads of a
// block; NCH: vectors of a row a lane takes (2 only for fp32 rows of more
// than 32 vectors).
template <typename KV, typename Q, int QH, int NCH>
__global__ void __launch_bounds__(kThreads, QH == 1 ? 2 : 1)
    paged_attention_kernel(const PagedArgs a) {
  constexpr int E = Vec<KV>::E;
  constexpr bool kQuant = sizeof(KV) == 1;
  constexpr bool kStageScales = kQuant && !HQQ_PAGED_GLOBAL_SCALES;
  extern __shared__ __align__(16) uint8_t smem[];
  const PagedSmem L = paged_smem(a.row_bytes, a.pg, a.pps, a.stages, kQuant, QH, a.hd, a.warps);
  const uint32_t full0 = smem_u32(smem + L.bars);
  const uint32_t empty0 = full0 + 8 * a.stages;

  const int groups = a.rep / QH;
  const int kvh = blockIdx.x / groups;
  const int h0 = kvh * a.rep + blockIdx.x % groups * QH;  // the block's first query head
  const int b = blockIdx.y, z = blockIdx.z;
  const int len = min(max(__ldg(a.lengths + b), 0), a.mp * a.pg);
  const int n_pages = (len + a.pg - 1) / a.pg;
  const int all_stages = (n_pages + a.pps - 1) / a.pps;
  const int per_split = (all_stages + a.splits - 1) / a.splits;
  const int st0 = z * per_split;
  const int n_st = max(0, min(all_stages, st0 + per_split) - st0);
  const int stage_rows = a.pps * a.pg;
  const int page_bytes = a.pg * a.row_bytes;

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full0 + 8 * s, a.bulk ? 1 : 32);  // the expect_tx, or the lanes' cp.async
      mbar_init(empty0 + 8 * s, 1);               // the consuming warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 0) {
    // ---- producer: the block table's pages of this split, stage by stage
    // the warp's lanes hold 32 block-table entries at a time, one each, so
    // no copy waits on a load of its page number
    const int* mytab = a.tab + static_cast<size_t>(b) * a.mp;
    const size_t head_page0 = static_cast<size_t>(kvh) * a.num_pages;
    const int p_end = min(n_pages, (st0 + n_st) * a.pps);
    int held = -32, entry = 0;  // entries [held, held + 32)
    for (int i = 0; i < n_st; ++i) {
      const int slot = i % a.stages;
      const int p0 = (st0 + i) * a.pps;
      const int np = min(a.pps, n_pages - p0);
      mbar_wait(empty0 + 8 * slot, ((i / a.stages) & 1) ^ 1);
      const uint32_t full = full0 + 8 * slot;
      const uint32_t st = smem_u32(smem + slot * L.stage);
      if (a.bulk && lane == 0)
        mbar_expect_tx(full, np * (2 * page_bytes + (kStageScales ? 8 * a.pg : 0)));
      for (int j = 0; j < np; ++j) {
        if (p0 + j >= held + 32) {
          held = p0 + j;
          entry = held + lane < p_end ? __ldg(mytab + held + lane) : 0;
        }
        const size_t page = head_page0 + __shfl_sync(0xffffffffu, entry, p0 + j - held);
        if (a.bulk) {
          if (lane == 0) {
            bulk_load(st + j * page_bytes, a.kp + page * page_bytes, page_bytes, full);
            bulk_load(st + L.v + j * page_bytes, a.vp + page * page_bytes, page_bytes, full);
            if (kStageScales) {
              bulk_load(st + L.ks + j * a.pg * 4, a.ks + page * a.pg, a.pg * 4, full);
              bulk_load(st + L.vs + j * a.pg * 4, a.vs + page * a.pg, a.pg * 4, full);
            }
          }
        } else {
          for (int w = 4 * lane; w < page_bytes; w += 128) {
            cp_async(st + j * page_bytes + w, a.kp + page * page_bytes + w, 4, true);
            cp_async(st + L.v + j * page_bytes + w, a.vp + page * page_bytes + w, 4, true);
          }
          if (kStageScales) {
            for (int r = lane; r < a.pg; r += 32) {
              cp_async(st + L.ks + (j * a.pg + r) * 4, a.ks + page * a.pg + r, 4, true);
              cp_async(st + L.vs + (j * a.pg + r) * 4, a.vs + page * a.pg + r, 4, true);
            }
          }
        }
      }
      if (!a.bulk) cp_async_arrive(full);
    }
    return;
  }

  // ---- consumer warps: stage i to warp (i % stages) % warps
  const int cw = warp - 1;
  const int lanes = 1 << a.lanes_log2;      // lanes of a row
  const int rp = 32 >> a.lanes_log2;        // rows a step reads, per row of lanes
  const int grp = lane >> a.lanes_log2;     // the lane's row within those
  const int sl = lane & (lanes - 1);        // its 16-byte vector(s) of the row
  const int nv = (a.row_bytes + 15) / 16;   // vectors of a row

  // q of the block's heads, the lane's columns, in fp32 (0 past hd)
  float qf[QH][NCH][E];
#pragma unroll
  for (int h = 0; h < QH; ++h)
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int col = (sl + c * lanes) * E + e;
        qf[h][c][e] =
            col < a.hd
                ? to_f32(static_cast<const Q*>(a.q)[(static_cast<size_t>(b) * a.nh + h0 + h) * a.hd +
                                                    col])
                : 0.f;
      }
  float m[QH], l[QH], acc[QH][NCH][E];
#pragma unroll
  for (int h = 0; h < QH; ++h) {
    m[h] = -INFINITY, l[h] = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[h][c][e] = 0.f;
  }

  for (int i = 0; i < n_st; ++i) {
    const int slot = i % a.stages;
    // a slot always goes to one warp, which so waits on its phases in order
    // (a wait two phases ahead would pass at once)
    if (slot % a.warps != cw) continue;
    mbar_wait(full0 + 8 * slot, (i / a.stages) & 1);
    const uint8_t* kst = smem + slot * L.stage;
    const uint8_t* vst = kst + L.v;
    const float* kss = reinterpret_cast<const float*>(kst + L.ks);
    const float* vss = reinterpret_cast<const float*>(kst + L.vs);
    const int rows = min(len - (st0 + i) * stage_rows, stage_rows);  // >= 1
    // the variant's scale of row r of the stage, through the block table
    auto scale_at = [&](const float* pool, int r) {
      const size_t page = static_cast<size_t>(kvh) * a.num_pages +
                          __ldg(a.tab + static_cast<size_t>(b) * a.mp + (st0 + i) * a.pps + r / a.pg);
      return __ldg(pool + page * a.pg + r % a.pg);
    };
    for (int r0 = 0; r0 < rows; r0 += 2 * rp) {
      int row[2];
      bool ok[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = r0 + u * rp + grp;
        ok[u] = r < rows;
        row[u] = ok[u] ? r : rows - 1;  // past the end: a valid row, selected out below
      }
      float s[2][QH];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int h = 0; h < QH; ++h) s[u][h] = 0.f;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const int v = sl + c * lanes;
        if (v < nv) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            float kf[E];
            load_vec<KV>(kst + row[u] * a.row_bytes, 16 * v, a.row_bytes, a.vec16, kf);
#pragma unroll
            for (int h = 0; h < QH; ++h)
#pragma unroll
              for (int e = 0; e < E; ++e) s[u][h] = fmaf(qf[h][c][e], kf[e], s[u][h]);
          }
        }
      }
      // each row's score on all of its lanes, -inf for rows past the end
      float mx[QH];
#pragma unroll
      for (int h = 0; h < QH; ++h) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            if (o < lanes) s[u][h] += __shfl_xor_sync(0xffffffffu, s[u][h], o);
          if (kQuant)
            s[u][h] *= (kStageScales ? kss[row[u]] : scale_at(a.ks, row[u])) / 127.0f;
          s[u][h] = ok[u] ? s[u][h] : -INFINITY;
        }
        mx[h] = fmaxf(s[0][h], s[1][h]);
        for (int o = lanes; o < 32; o <<= 1)
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], o));
      }
      float pv[2][QH];
#pragma unroll
      for (int h = 0; h < QH; ++h) {
        if (mx[h] > m[h]) {  // warp-uniform; row r0 is valid, so the first step moves it
          const float corr = expf(m[h] - mx[h]);
          m[h] = mx[h];
          l[h] *= corr;
#pragma unroll
          for (int c = 0; c < NCH; ++c)
#pragma unroll
            for (int e = 0; e < E; ++e) acc[h][c][e] *= corr;
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float p = ok[u] ? expf(s[u][h] - m[h]) : 0.f;
          l[h] += p;
          pv[u][h] =
              kQuant ? p * ((kStageScales ? vss[row[u]] : scale_at(a.vs, row[u])) / 127.0f) : p;
        }
      }
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const int v = sl + c * lanes;
        if (v < nv) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            if (!ok[u]) continue;
            float vf[E];
            load_vec<KV>(vst + row[u] * a.row_bytes, 16 * v, a.row_bytes, a.vec16, vf);
#pragma unroll
            for (int h = 0; h < QH; ++h)
#pragma unroll
              for (int e = 0; e < E; ++e) acc[h][c][e] = fmaf(pv[u][h], vf[e], acc[h][c][e]);
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * slot);
  }

  // a warp's sums over its rows of lanes: each lane then holds the warp's
  // sum and output sums of its columns
#pragma unroll
  for (int h = 0; h < QH; ++h)
    for (int o = lanes; o < 32; o <<= 1) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], o);
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[h][c][e] += __shfl_xor_sync(0xffffffffu, acc[h][c][e], o);
    }

  // merge the warps' softmaxes in shared memory (the ring is consumed)
  bar_sync(1, 32 * a.warps);
  float* mrg = reinterpret_cast<float*>(smem);  // [warp][head][max, sum, hd outputs]
#pragma unroll
  for (int h = 0; h < QH; ++h) {
    float* dst = mrg + (cw * QH + h) * (a.hd + 2);
    if (lane == 0) dst[0] = m[h], dst[1] = l[h];
    if (grp == 0) {
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int col = (sl + c * lanes) * E + e;
          if (col < a.hd) dst[2 + col] = acc[h][c][e];
        }
    }
  }
  bar_sync(1, 32 * a.warps);
  const int ct = threadIdx.x - 32;
  for (int i = ct; i < QH * a.hd; i += 32 * a.warps) {
    const int h = i / a.hd, d = i % a.hd;
    float big = -INFINITY;
    for (int w = 0; w < a.warps; ++w) big = fmaxf(big, mrg[(w * QH + h) * (a.hd + 2)]);
    float lsum = 0.f, o = 0.f;
    if (big > -INFINITY) {
      for (int w = 0; w < a.warps; ++w) {
        const float* src = mrg + (w * QH + h) * (a.hd + 2);
        const float e = expf(src[0] - big);
        lsum += src[1] * e;
        o += src[2 + d] * e;
      }
    }
    const size_t head = static_cast<size_t>(b) * a.nh + h0 + h;
    if (a.splits == 1) {
      store1(static_cast<Q*>(a.out), head * a.hd + d, lsum > 0.f ? o / lsum : 0.f);
    } else {
      float* dst = a.part + (head * a.splits + z) * (a.hd + 2);
      dst[2 + d] = o;
      if (d == 0) dst[0] = big, dst[1] = lsum;
    }
  }
}

// Merge the splits of one (slot, query head): part [B, nh, splits, 2 + hd]
// holds each split's running max, sum and unnormalised output.
template <typename Q>
__global__ void __launch_bounds__(128)
    paged_attention_merge_kernel(const float* __restrict__ part, Q* __restrict__ out, int nh,
                                 int hd, int splits) {
  const size_t head = static_cast<size_t>(blockIdx.y) * nh + blockIdx.x;
  const float* src = part + head * splits * (hd + 2);
  float big = -INFINITY;
  for (int z = 0; z < splits; ++z) big = fmaxf(big, src[z * (hd + 2)]);
  for (int d = threadIdx.x; d < hd; d += 128) {
    float lsum = 0.f, o = 0.f;
    if (big > -INFINITY) {
      for (int z = 0; z < splits; ++z) {
        const float* pz = src + z * (hd + 2);
        const float e = expf(pz[0] - big);
        lsum += pz[1] * e;
        o += pz[2 + d] * e;
      }
    }
    store1(out, head * hd + d, lsum > 0.f ? o / lsum : 0.f);
  }
}

template <typename KV, typename Q, int QH, int NCH>
cudaError_t launch(const PagedArgs& a, int b, int n_kv, int smem, cudaStream_t stream) {
  auto kernel = paged_attention_kernel<KV, Q, QH, NCH>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(n_kv * (a.rep / QH), b, a.splits), 32 * (1 + a.warps), smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  paged_attention_merge_kernel<Q><<<dim3(a.nh, b), 128, 0, stream>>>(a.part, static_cast<Q*>(a.out),
                                                                      a.nh, a.hd, a.splits);
  return cudaGetLastError();
}

template <typename KV, typename Q, int NCH>
cudaError_t launch_heads(const PagedArgs& a, int qh, int b, int n_kv, int smem,
                         cudaStream_t stream) {
  if (qh == 1) return launch<KV, Q, 1, NCH>(a, b, n_kv, smem, stream);
  if (qh == 2) return launch<KV, Q, 2, NCH>(a, b, n_kv, smem, stream);
  // int8 rows hold 16 columns a lane: four heads' q and sums would spill
  if constexpr (sizeof(KV) > 1) {
    if (qh == 4) return launch<KV, Q, 4, NCH>(a, b, n_kv, smem, stream);
  }
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// q [B, nh, hd], k_pages and v_pages [n_kv, num_pages, pg, hd], k_scales and
// v_scales fp32 [n_kv, num_pages, pg] (int8 pages only, else null), lengths
// int32 [B], tab int32 [B, mp], out [B, nh, hd] in q's type, part fp32
// [B, nh, splits, 2 + hd] (splits > 1 only, else null). head_dim a multiple
// of 4, at most 256. The launch plan (`paged_launch_plan`) gives splits and
// the rest: bulk (1: pages by bulk copy, every pool 16-byte aligned),
// vec16 (rows of whole 16-byte vectors), lanes_log2 (log2 of the lanes of a
// row), pages_per_stage, stages, warps (consumer warps, 1 to 8),
// heads_per_block (1, 2 or, but for int8 pages, 4, dividing nh / n_kv) and
// smem (bytes of dynamic shared memory).
HQQ_EXPORT int hqq_paged_attention(const void* q, const void* kp, const void* vp,
                                   const void* ks, const void* vs, const void* lengths,
                                   const void* tab, void* out, void* part, int b, int nh, int n_kv,
                                   int hd, int num_pages, int pg, int mp, int splits, int dtype,
                                   int bulk, int vec16, int lanes_log2, int pages_per_stage,
                                   int stages, int warps, int heads_per_block, int smem,
                                   void* stream) {
  const int esize = dtype == PAGED_F32 ? 4 : dtype == PAGED_INT8 ? 1 : 2;
  const int row_bytes = hd * esize;
  const int rep = n_kv > 0 ? nh / n_kv : 0;
  const int nv = (row_bytes + 15) / 16;
  const int nch = (nv + 31) / 32;
  if (b < 1 || nh < 1 || n_kv < 1 || nh % n_kv || hd < 4 || hd % 4 || hd > kMaxHd || pg < 1 ||
      mp < 1 || splits < 1 || (splits > 1 && part == nullptr) ||
      ((dtype == PAGED_INT8) != (ks != nullptr)) || ((ks == nullptr) != (vs == nullptr)) ||
      pages_per_stage < 1 || stages < 1 || warps < 1 || warps > kMaxWarps ||
      heads_per_block < 1 || rep % heads_per_block ||
      lanes_log2 < 0 || lanes_log2 > 5 || (nch == 1 && (1 << lanes_log2) < nv) ||
      (nch > 1 && lanes_log2 != 5) || nch > 2 || (nch == 2 && dtype != PAGED_F32) ||
      (vec16 && row_bytes % 16) ||
      (bulk && (pg * row_bytes % 16 || (ks != nullptr && pg % 4) || !aligned16(kp) ||
                !aligned16(vp) || (ks != nullptr && (!aligned16(ks) || !aligned16(vs))))) ||
      smem < paged_smem(row_bytes, pg, pages_per_stage, stages, dtype == PAGED_INT8,
                        heads_per_block, hd, warps).total) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PagedArgs a;
  a.q = q;
  a.kp = static_cast<const uint8_t*>(kp);
  a.vp = static_cast<const uint8_t*>(vp);
  a.ks = static_cast<const float*>(ks);
  a.vs = static_cast<const float*>(vs);
  a.lengths = static_cast<const int*>(lengths);
  a.tab = static_cast<const int*>(tab);
  a.out = out;
  a.part = static_cast<float*>(part);
  a.nh = nh, a.rep = rep, a.hd = hd, a.num_pages = num_pages, a.pg = pg, a.mp = mp;
  a.splits = splits, a.row_bytes = row_bytes, a.pps = pages_per_stage, a.stages = stages;
  a.warps = warps;
  a.lanes_log2 = lanes_log2, a.bulk = bulk, a.vec16 = vec16;
  const auto st = static_cast<cudaStream_t>(stream);
  const int qh = heads_per_block;
  cudaError_t err;
  switch (dtype) {
    case PAGED_F32:
      err = nch == 2 ? launch_heads<float, float, 2>(a, qh, b, n_kv, smem, st)
                     : launch_heads<float, float, 1>(a, qh, b, n_kv, smem, st);
      break;
    case PAGED_BF16:
      err = launch_heads<__nv_bfloat16, __nv_bfloat16, 1>(a, qh, b, n_kv, smem, st);
      break;
    case PAGED_F16:
      err = launch_heads<__half, __half, 1>(a, qh, b, n_kv, smem, st);
      break;
    case PAGED_INT8:
      err = launch_heads<int8_t, float, 1>(a, qh, b, n_kv, smem, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

HQQ_EXPORT const char* hqq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
