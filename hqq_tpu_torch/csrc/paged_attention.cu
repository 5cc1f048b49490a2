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
// used for 2 * head_dim multiply-adds, far below the ratio at which
// arithmetic would limit. So the design is a sweep on the CUDA cores:
//   * a block of 4 warps owns one (slot, query head, split); a warp takes 4
//     keys at a time, its lanes 4 elements of a row each (a row of 128 bf16
//     values is one coalesced 256-byte read), eight row reads in flight;
//   * an online softmax per warp (running max, running sum, running output
//     in registers), merged across the warps through shared memory;
//   * long sequences are split over `splits` blocks, each taking an equal
//     share of the slot's own length; a split writes (max, sum, unnormalised
//     output) in fp32 and a second small kernel merges them. That keeps all
//     SMs busy at 8 slots x 32 heads;
//   * GQA is an index (kv head = h / rep): the rep blocks that share a kv
//     head read the same rows, which the L2 cache serves.
// No key at or beyond lengths[b] and no block-table entry at or beyond
// ceil(lengths[b] / pg) is read. A slot of length 0 gets zeros.
#include <math.h>

#include "hqq_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kGroup = 4;      // keys a warp takes per iteration
constexpr int kMaxHd = 256;    // two chunks of 32 lanes x 4 elements

// Page and q types of the C entry.
enum PagedDtype { PAGED_F32 = 0, PAGED_BF16 = 1, PAGED_F16 = 2, PAGED_INT8 = 3 };

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = __uint_as_float(t.x << 16), v[1] = __uint_as_float(t.x & 0xffff0000u);
  v[2] = __uint_as_float(t.y << 16), v[3] = __uint_as_float(t.y & 0xffff0000u);
}
__device__ __forceinline__ void load4(const __half* p, float (&v)[4]) {
  const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&t.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&t.y));
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}
__device__ __forceinline__ void load4(const int8_t* p, float (&v)[4]) {
  const int t = __ldg(reinterpret_cast<const int*>(p));
  v[0] = static_cast<float>((t << 24) >> 24), v[1] = static_cast<float>((t << 16) >> 24);
  v[2] = static_cast<float>((t << 8) >> 24), v[3] = static_cast<float>(t >> 24);
}

__device__ __forceinline__ void store1(float* out, size_t i, float v) { out[i] = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* out, size_t i, float v) {
  out[i] = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store1(__half* out, size_t i, float v) {
  out[i] = __float2half_rn(v);
}

// KV: the pages' type; Q: q's and the output's type; NCH: chunks of 128
// elements in a head (1 for head_dim <= 128, 2 up to 256).
template <typename KV, typename Q, int NCH>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const Q* __restrict__ q, const KV* __restrict__ kp,
                       const KV* __restrict__ vp, const float* __restrict__ ks,
                       const float* __restrict__ vs, const int* __restrict__ lengths,
                       const int* __restrict__ tab, Q* __restrict__ out,
                       float* __restrict__ part, int nh, int rep, int hd, int num_pages, int pg,
                       int mp, int splits) {
  const int h = blockIdx.x, b = blockIdx.y, z = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int len = min(max(lengths[b], 0), mp * pg);
  // this split's share of the slot's keys, a whole number of warp rounds
  int chunk = (len + splits - 1) / splits;
  chunk = (chunk + kWarps * kGroup - 1) / (kWarps * kGroup) * (kWarps * kGroup);
  const int s0 = z * chunk;
  const int s1 = min(len, s0 + chunk);
  const int* __restrict__ mytab = tab + static_cast<size_t>(b) * mp;
  const size_t head_row0 = static_cast<size_t>(h / rep) * num_pages;

  float qf[NCH][4], acc[NCH][4];
  bool act[NCH];
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int d = c * 128 + lane * 4;
    act[c] = d < hd;
#pragma unroll
    for (int i = 0; i < 4; ++i) qf[c][i] = 0.f, acc[c][i] = 0.f;
    if (act[c]) load4(q + (static_cast<size_t>(b) * nh + h) * hd + d, qf[c]);
  }
  float m = -INFINITY, l = 0.f;

  for (int s = s0 + warp * kGroup; s < s1; s += kWarps * kGroup) {
    size_t row[kGroup];
    float sc[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int sj = (s + j < s1) ? s + j : s;  // past the end: key s again, weight 0
      const int pi = sj / pg;
      row[j] = (head_row0 + mytab[pi]) * pg + (sj - pi * pg);
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        if (act[c]) {
          float kf[4];
          load4(kp + row[j] * hd + c * 128 + lane * 4, kf);
#pragma unroll
          for (int i = 0; i < 4; ++i) dot = fmaf(qf[c][i], kf[i], dot);
        }
      }
      sc[j] = dot;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int j = 0; j < kGroup; ++j) sc[j] += __shfl_xor_sync(0xffffffffu, sc[j], o);
    }
    float mn = m;
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (ks != nullptr) sc[j] *= ks[row[j]] / 127.0f;
      if (s + j >= s1) sc[j] = -INFINITY;
      mn = fmaxf(mn, sc[j]);
    }
    // key s is within the share, so mn is finite
    const float corr = expf(m - mn);
    float p[kGroup];
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      p[j] = expf(sc[j] - mn);
      psum += p[j];
      if (vs != nullptr) p[j] *= vs[row[j]] / 127.0f;
    }
    l = l * corr + psum;
    m = mn;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[c][i] *= corr;
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        if (act[c]) {
          float vf[4];
          load4(vp + row[j] * hd + c * 128 + lane * 4, vf);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[c][i] = fmaf(p[j], vf[i], acc[c][i]);
        }
      }
    }
  }

  // merge the warps' partial softmaxes
  __shared__ float sm_m[kWarps], sm_l[kWarps];
  __shared__ float sm_acc[kWarps][kMaxHd];
  if (lane == 0) sm_m[warp] = m, sm_l[warp] = l;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    if (act[c]) {
#pragma unroll
      for (int i = 0; i < 4; ++i) sm_acc[warp][c * 128 + lane * 4 + i] = acc[c][i];
    }
  }
  __syncthreads();
  float big = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) big = fmaxf(big, sm_m[w]);
  const size_t head = static_cast<size_t>(b) * nh + h;
  for (int d = threadIdx.x; d < hd; d += kThreads) {
    float lsum = 0.f, o = 0.f;
    if (big > -INFINITY) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float e = expf(sm_m[w] - big);
        lsum += sm_l[w] * e;
        o += sm_acc[w][d] * e;
      }
    }
    if (splits == 1) {
      store1(out, head * hd + d, lsum > 0.f ? o / lsum : 0.f);
    } else {
      float* dst = part + (head * splits + z) * (hd + 2);
      dst[2 + d] = o;
      if (d == 0) dst[0] = big, dst[1] = lsum;
    }
  }
}

// Merge the splits of one (slot, query head): part [B, nh, splits, 2 + hd]
// holds each split's running max, sum and unnormalised output.
template <typename Q>
__global__ void __launch_bounds__(kThreads)
paged_attention_merge_kernel(const float* __restrict__ part, Q* __restrict__ out, int nh, int hd,
                             int splits) {
  const size_t head = static_cast<size_t>(blockIdx.y) * nh + blockIdx.x;
  const float* src = part + head * splits * (hd + 2);
  float big = -INFINITY;
  for (int z = 0; z < splits; ++z) big = fmaxf(big, src[z * (hd + 2)]);
  for (int d = threadIdx.x; d < hd; d += kThreads) {
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

template <typename KV, typename Q>
cudaError_t launch(const void* q, const void* kp, const void* vp, const float* ks,
                   const float* vs, const int* lengths, const int* tab, void* out, float* part,
                   int b, int nh, int n_kv, int hd, int num_pages, int pg, int mp, int splits,
                   cudaStream_t stream) {
  const dim3 grid(nh, b, splits);
  const int rep = nh / n_kv;
  if (hd <= 128) {
    paged_attention_kernel<KV, Q, 1><<<grid, kThreads, 0, stream>>>(
        static_cast<const Q*>(q), static_cast<const KV*>(kp), static_cast<const KV*>(vp), ks, vs,
        lengths, tab, static_cast<Q*>(out), part, nh, rep, hd, num_pages, pg, mp, splits);
  } else {
    paged_attention_kernel<KV, Q, 2><<<grid, kThreads, 0, stream>>>(
        static_cast<const Q*>(q), static_cast<const KV*>(kp), static_cast<const KV*>(vp), ks, vs,
        lengths, tab, static_cast<Q*>(out), part, nh, rep, hd, num_pages, pg, mp, splits);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  paged_attention_merge_kernel<Q><<<dim3(nh, b), kThreads, 0, stream>>>(
      part, static_cast<Q*>(out), nh, hd, splits);
  return cudaGetLastError();
}

}  // namespace

// q [B, nh, hd], k_pages and v_pages [n_kv, num_pages, pg, hd], k_scales and
// v_scales fp32 [n_kv, num_pages, pg] (int8 pages only, else null), lengths
// int32 [B], tab int32 [B, mp], out [B, nh, hd] in q's type, part fp32
// [B, nh, splits, 2 + hd] (splits > 1 only, else null). head_dim a multiple
// of 4, at most 256.
HQQ_EXPORT int hqq_paged_attention(const void* q, const void* kp, const void* vp,
                                   const void* ks, const void* vs, const void* lengths,
                                   const void* tab, void* out, void* part, int b, int nh, int n_kv,
                                   int hd, int num_pages, int pg, int mp, int splits, int dtype,
                                   void* stream) {
  if (b < 1 || nh < 1 || n_kv < 1 || nh % n_kv || hd < 4 || hd % 4 || hd > kMaxHd || pg < 1 ||
      mp < 1 || splits < 1 || (splits > 1 && part == nullptr) ||
      ((dtype == PAGED_INT8) != (ks != nullptr)) || ((ks == nullptr) != (vs == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* fks = static_cast<const float*>(ks);
  const auto* fvs = static_cast<const float*>(vs);
  const auto* il = static_cast<const int*>(lengths);
  const auto* it = static_cast<const int*>(tab);
  auto* fp = static_cast<float*>(part);
  cudaError_t err;
  switch (dtype) {
    case PAGED_F32:
      err = launch<float, float>(q, kp, vp, fks, fvs, il, it, out, fp, b, nh, n_kv, hd, num_pages,
                                 pg, mp, splits, st);
      break;
    case PAGED_BF16:
      err = launch<__nv_bfloat16, __nv_bfloat16>(q, kp, vp, fks, fvs, il, it, out, fp, b, nh, n_kv,
                                                 hd, num_pages, pg, mp, splits, st);
      break;
    case PAGED_F16:
      err = launch<__half, __half>(q, kp, vp, fks, fvs, il, it, out, fp, b, nh, n_kv, hd,
                                   num_pages, pg, mp, splits, st);
      break;
    case PAGED_INT8:
      err = launch<int8_t, float>(q, kp, vp, fks, fvs, il, it, out, fp, b, nh, n_kv, hd, num_pages,
                                  pg, mp, splits, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

HQQ_EXPORT const char* hqq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
