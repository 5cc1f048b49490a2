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
// with fp32 scores, fp32 softmax statistics and an fp32 output sum, rounded
// once to q's type at the end. bf16 and fp16, products on the tensor cores.
//
// Bound by operations on this card (4 * T * T * head_dim per head, halved
// under causality, against 2 * T * head_dim values read). The design is the
// plain one that is right first:
//   * a block of 4 warps owns a tile of 64 query rows of one (batch, head)
//     and walks the key tiles of 64 rows up to its diagonal; each warp owns
//     16 of the rows, so no softmax statistic crosses a warp;
//   * per key tile: K and V tiles go to shared memory in 16-byte loads, each
//     warp forms S = Q K^T in four 16x16 wmma accumulators and stores them to
//     its strip of shared memory, two lanes a row scale, mask and exponentiate
//     them (running max and sum in registers) and write P in q's type;
//   * a wmma accumulator's layout is opaque, so the running output lives in
//     shared memory as an fp32 tile whose rows can be addressed: a row is
//     rescaled there when its maximum moves, then the tile is loaded as
//     accumulators, P V is added and it is stored back;
//   * the kernel masks a ragged last tile itself (rows and keys at or beyond T
//     are zero and get no weight), so T need not be a multiple of the tile;
//   * GQA is an index (kv head = h / rep), K and V arrive unrepeated.
// No cp.async pipeline, TMA or wgmma yet, and the trips of S, P and O through
// shared memory cost most of the time: that is the work of making it fast.
#include <math.h>

#include "qmm_tile.cuh"

namespace {

using namespace nvcuda;

constexpr int kBM = 64;             // query rows per block
constexpr int kBN = 64;             // keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kLdS = kBN + 4;       // padded row of the fp32 score strip
constexpr int kLdP = kBN + 8;       // padded row of the probability strip

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// 64 rows x hd of src (rows from r0; rows at or beyond t are zero) into dst
// with row stride ld.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src, int r0, int t, int hd,
                                          int ld) {
  const int chunks = hd / 8;
  for (int idx = threadIdx.x; idx < 64 * chunks; idx += kThreads) {
    const int r = idx / chunks;
    const int c8 = (idx - r * chunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < t) {
      val = __ldg(reinterpret_cast<const uint4*>(src + static_cast<size_t>(r0 + r) * hd + c8));
    }
    *reinterpret_cast<uint4*>(dst + r * ld + c8) = val;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ out, int nh, int rep, int t, int hd, float scale,
                     int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = hd + 8;   // row of a q, k or v tile
  const int ldo = hd + 4;  // row of the fp32 output tile
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + kBM * ld;
  T* vs = ks + kBN * ld;
  float* os = reinterpret_cast<float*>(vs + kBN * ld);
  float* ss = os + kBM * ldo;
  T* ps = reinterpret_cast<T*>(ss + kBM * kLdS);

  // the last query tiles walk the most key tiles: start them first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = qt * kBM;
  const size_t q_off = (static_cast<size_t>(b) * nh + h) * t * hd;
  const size_t kv_off = (static_cast<size_t>(b) * (nh / rep) + h / rep) * t * hd;
  const T* kg = k + kv_off;
  const T* vg = v + kv_off;

  load_tile(qs, q + q_off, m0, t, hd, ld);
  for (int i = threadIdx.x; i < kBM * ldo; i += kThreads) os[i] = 0.f;

  const T* qw = qs + warp * 16 * ld;
  float* sw = ss + warp * 16 * kLdS;
  T* pw = ps + warp * 16 * kLdP;
  float* ow = os + warp * 16 * ldo;
  const int r = lane >> 1, half = lane & 1;  // two lanes a row, 32 keys each
  const int row = m0 + warp * 16 + r;
  float m = -INFINITY, l = 0.f;

  const int all_tiles = (t + kBN - 1) / kBN;
  const int n_tiles = causal ? min(all_tiles, qt + 1) : all_tiles;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int n0 = kt * kBN;
    __syncthreads();  // the tiles of the last round are done with
    load_tile(ks, kg, n0, t, hd, ld);
    load_tile(vs, vg, n0, t, hd, ld);
    __syncthreads();

    // S = Q K^T on the warp's 16 rows
    Acc sacc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(sacc[j], 0.f);
    for (int kk = 0; kk < hd; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
      wmma::load_matrix_sync(a, qw + kk, ld);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> kb;
        wmma::load_matrix_sync(kb, ks + (16 * j) * ld + kk, ld);
        wmma::mma_sync(sacc[j], a, kb, sacc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(sw + 16 * j, sacc[j], kLdS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax on the lane's half row. Key 0 is visible to every row,
    // so from the first tile on the running max is finite.
    float* srow = sw + r * kLdS + half * 32;
    T* prow = pw + r * kLdP + half * 32;
    float mx = -INFINITY;
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const int col = n0 + half * 32 + c;
      float s = srow[c] * scale;
      if (col >= t || (causal && col > row)) s = -INFINITY;
      srow[c] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float mn = fmaxf(m, mx);
    const float corr = expf(m - mn);
    float psum = 0.f;
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const float p = expf(srow[c] - mn);
      psum += p;
      prow[c] = qmm::to_t<T>(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * corr + psum;
    m = mn;
    float* orow = ow + r * ldo;
    for (int c = half; c < hd; c += 2) orow[c] *= corr;
    __syncwarp();

    // O += P V
    wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> pa[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wmma::load_matrix_sync(pa[kk], pw + 16 * kk, kLdP);
    for (int j = 0; j < hd / 16; ++j) {
      Acc o;
      wmma::load_matrix_sync(o, ow + 16 * j, ldo, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> vb;
        wmma::load_matrix_sync(vb, vs + (16 * kk) * ld + 16 * j, ld);
        wmma::mma_sync(o, pa[kk], vb, o);
      }
      wmma::store_matrix_sync(ow + 16 * j, o, ldo, wmma::mem_row_major);
    }
    __syncwarp();
  }

  if (row < t) {
    const float inv = 1.f / l;
    const float* orow = ow + r * ldo;
    T* dst = out + q_off + static_cast<size_t>(row) * hd;
    for (int c8 = half; c8 < hd / 8; c8 += 2) {
      alignas(16) T tmp[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) tmp[i] = qmm::to_t<T>(orow[c8 * 8 + i] * inv);
      *reinterpret_cast<uint4*>(dst + c8 * 8) = *reinterpret_cast<const uint4*>(tmp);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int b, int nh, int n_kv,
                   int t, int hd, float scale, int causal, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kBM + 2 * kBN) * (hd + 8) * sizeof(T) +
                      static_cast<size_t>(kBM) * (hd + 4) * sizeof(float) +
                      static_cast<size_t>(kBM) * kLdS * sizeof(float) +
                      static_cast<size_t>(kBM) * kLdP * sizeof(T);
  auto kernel = flash_prefill_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((t + kBM - 1) / kBM, nh, b);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<T*>(out), nh,
                                           nh / n_kv, t, hd, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q and out [B, nh, T, hd], k and v [B, n_kv, T, hd], all bf16 (dtype 1) or
// fp16 (dtype 2), contiguous and 16-byte aligned; head_dim a multiple of 16,
// at most 256; nh a multiple of n_kv.
HQQ_EXPORT int hqq_flash_prefill(const void* q, const void* k, const void* v, void* out, int b,
                                 int nh, int n_kv, int t, int hd, float scale, int causal,
                                 int dtype, void* stream) {
  if (b < 1 || b > 65535 || nh < 1 || nh > 65535 || n_kv < 1 || nh % n_kv || t < 1 || hd < 16 ||
      hd % 16 || hd > 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == HQQ_BF16) {
    err = launch<__nv_bfloat16>(q, k, v, out, b, nh, n_kv, t, hd, scale, causal, st);
  } else if (dtype == HQQ_F16) {
    err = launch<__half>(q, k, v, out, b, nh, n_kv, t, hd, scale, causal, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

HQQ_EXPORT const char* hqq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
