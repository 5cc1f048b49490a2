// SPDX-License-Identifier: Apache-2.0
// quant_matmul_lora: y[M, N] = x @ W^T + (x @ A) @ B in one kernel, with
// W[n, k] = code * scale - zs in the axis=1 kernel layout of hqq_common.cuh,
// A [K, r] and B [r, N] in fp32 (the adapter's scaling folded into B). W is
// dequantized in fp32 and rounded to x's type (bf16 or fp16), A is rounded
// to x's type too; both products run on the tensor cores with fp32
// accumulators. The rank-r partial p = x @ A stays in fp32 and B is applied
// in fp32 in the epilogue; y in x's type. Any M, any r >= 1.
//
// Replaces: hqq_tpu/ops/fused_matmul.py `_qmm_lora_kernel` (launched by
//   `_qmm_lora_call`, entry `quant_matmul_pallas_lora`): HQQ+ serving under
//   the `pallas` backend, and the M > 32 (prefill) and 8-bit routes of
//   `quant_matmul_pallas_a8_lora`.
// Bound on H100: operations at prefill, as quant_matmul: 2*M*N*K for the
//   base plus 2*M*K*r + 2*M*r*N for the adapter (0.4% more at r = 8,
//   K = N = 4096). A and B add 4*r*(K + N) bytes.
// Design: the 64x64 tile of qmm_tile.cuh, and beside it the tile's rank-r
//   partial: per K slab the block also stages A's slab [64, r_pad] in shared
//   memory (r padded with zeros to a multiple of 16), and warp w multiplies
//   x's rows 16w..16w+15 of the slab with it into r_pad/16 more accumulators.
//   Up to rank 64 the adapter costs no second pass over x. Every block along N
//   repeats its row block's partial (r_pad/64 of the base's products). At
//   the end p goes to shared memory, each output's term sum_j p[j] * B[j, n]
//   is summed in fp32 into the output tile's shared memory, and the warps
//   add it to their accumulators before the one rounding to y's type. A
//   rank above 64 goes in chunks of 64: each further chunk walks K again for
//   its partial alone (x is read once more, W is not) and adds its term to
//   the same accumulators, so no rank costs registers beyond a chunk's.
#include "qmm_tile.cuh"

namespace {

using namespace qmm;

// acc += the calling warp's 32x32 quarter of the fp32 tile c[64][kLdc]
__device__ __forceinline__ void add_tile(Acc (&acc)[2][2], const float* c, int wm, int wn) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      Acc t;
      wmma::load_matrix_sync(t, c + (wm + 16 * i) * kLdc + wn + 16 * j, kLdc,
                             wmma::mem_row_major);
#pragma unroll
      for (int e = 0; e < t.num_elements; ++e) acc[i][j].x[e] += t.x[e];
    }
}

// RF: 16-wide fragments of one rank chunk, kRp = 16 * RF columns of A
template <typename T, int RF>
__global__ void __launch_bounds__(kThreads)
    qmm_lora_kernel(const T* __restrict__ x, const uint32_t* __restrict__ wq,
                    const float* __restrict__ scale, const float* __restrict__ zs,
                    const float* __restrict__ la, const float* __restrict__ lb, int r,
                    int out_dtype, void* __restrict__ out, int m, int n, int k, int group_size,
                    int cb) {
  constexpr int kRp = 16 * RF;
  constexpr int kLda = kRp + 8;  // padded row of A's slab
  constexpr int kLdp = kRp + 4;  // padded row of the fp32 partial
  __shared__ Smem smem;
  __shared__ alignas(32) unsigned char a_raw[kBK * kLda * 2];
  __shared__ alignas(32) float ps[kBM * kLdp];
  T* xs = reinterpret_cast<T*>(smem.slabs.x);
  T* ws = reinterpret_cast<T*>(smem.slabs.w);
  T* a_s = reinterpret_cast<T*>(a_raw);

  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 32;

  const WordLayout layout = word_layout(k, cb);
  const int groups = k / group_size;

  Acc acc[2][2];
  zero_acc(acc);

  // One walk over K per chunk of kRp ranks; the first also does the base.
  for (int r0 = 0; r0 < r; r0 += kRp) {
    const bool with_base = r0 == 0;
    Acc pacc[RF];
#pragma unroll
    for (int f = 0; f < RF; ++f) wmma::fill_fragment(pacc[f], 0.f);

    for (int k0 = 0; k0 < k; k0 += kBK) {
      load_x_slab(xs, x, m0, k0, m, k);
      if (with_base) dequant_slab(ws, wq, scale, zs, n0, k0, n, k, group_size, groups, layout);
      // A's slab, rounded to x's type: a_s[kk][j] = A[k0 + kk, r0 + j]
      for (int idx = threadIdx.x; idx < kBK * kRp; idx += kThreads) {
        const int kk = idx / kRp;
        const int j = idx % kRp;
        float v = 0.f;
        if (k0 + kk < k && r0 + j < r) v = la[static_cast<size_t>(k0 + kk) * r + r0 + j];
        a_s[kk * kLda + j] = to_t<T>(v);
      }
      __syncthreads();
      if (with_base) mma_slab(acc, xs, ws, wm, wn);
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> xa;
        wmma::load_matrix_sync(xa, xs + (16 * warp) * kLd + kk, kLd);
#pragma unroll
        for (int f = 0; f < RF; ++f) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> af;
          wmma::load_matrix_sync(af, a_s + kk * kLda + 16 * f, kLda);
          wmma::mma_sync(pacc[f], xa, af, pacc[f]);
        }
      }
      __syncthreads();
    }

    // The chunk's term p @ B in fp32, ranks in order: p goes to shared
    // memory, the term to the tile that overlays the slabs (done with until
    // the next chunk), and from there into the accumulators.
#pragma unroll
    for (int f = 0; f < RF; ++f)
      wmma::store_matrix_sync(ps + (16 * warp) * kLdp + 16 * f, pacc[f], kLdp,
                              wmma::mem_row_major);
    __syncthreads();
    const int rc = min(kRp, r - r0);
    for (int idx = threadIdx.x; idx < kBM * kBN; idx += kThreads) {
      const int row = idx / kBN;
      const int c = idx % kBN;
      float term = 0.f;
      if (n0 + c < n) {
        for (int j = 0; j < rc; ++j) {
          term = fmaf(ps[row * kLdp + j], lb[static_cast<size_t>(r0 + j) * n + n0 + c], term);
        }
      }
      smem.c[row * kLdc + c] = term;
    }
    __syncthreads();
    add_tile(acc, smem.c, wm, wn);
    __syncthreads();
  }

  stage_acc(smem.c, acc, wm, wn);
  __syncthreads();
  for (int idx = threadIdx.x; idx < kBM * kBN; idx += kThreads) {
    const int row = idx / kBN;
    const int c = idx % kBN;
    if (m0 + row < m && n0 + c < n) {
      hqq_store(out, static_cast<size_t>(m0 + row) * n + n0 + c, smem.c[row * kLdc + c],
                out_dtype);
    }
  }
}

template <typename T>
int launch(const void* x, const void* wq, const void* scale, const void* zs, const void* la,
           const void* lb, int r, void* out, int m, int n, int k, int group_size, int cb,
           int dtype, cudaStream_t s) {
  dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
#define HQQ_LORA_LAUNCH(RF)                                                                   \
  qmm_lora_kernel<T, RF><<<grid, kThreads, 0, s>>>(                                           \
      static_cast<const T*>(x), static_cast<const uint32_t*>(wq),                             \
      static_cast<const float*>(scale), static_cast<const float*>(zs),                        \
      static_cast<const float*>(la), static_cast<const float*>(lb), r, dtype, out, m, n, k,   \
      group_size, cb)
  if (r <= 16) {
    HQQ_LORA_LAUNCH(1);
  } else if (r <= 32) {
    HQQ_LORA_LAUNCH(2);
  } else {  // above 64 in chunks of 64 ranks
    HQQ_LORA_LAUNCH(4);
  }
#undef HQQ_LORA_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: HQQ_BF16 or HQQ_F16, the type of x and of y; la [K, r] and
// lb [r, N] are fp32, r >= 1
HQQ_EXPORT int hqq_quant_matmul_lora(const void* x, const void* wq, const void* scale,
                                     const void* zs, const void* la, const void* lb, void* out,
                                     int m, int n, int k, int r, int group_size, int cb,
                                     int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (r < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == HQQ_BF16) {
    return launch<__nv_bfloat16>(x, wq, scale, zs, la, lb, r, out, m, n, k, group_size, cb, dtype,
                                 s);
  }
  if (dtype == HQQ_F16) {
    return launch<__half>(x, wq, scale, zs, la, lb, r, out, m, n, k, group_size, cb, dtype, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

HQQ_EXPORT const char* hqq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
