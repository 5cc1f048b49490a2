// SPDX-License-Identifier: Apache-2.0
// RMSNorm of rows of width d: y = (x * rsqrt(mean(x^2) + eps)) * (w + offset),
// every step in fp32, y rounded to x's type (bf16, fp16 or fp32).
//
// Replaces no Pallas kernel: `hqq_tpu/models/llama.py:268` `rms_norm` (and
// `_gemma_norm` of `hqq_tpu/models/gemma.py:68`, offset 1) is left to XLA's
// fusion there. It is a kernel here because a row's result must not depend
// on the rows beside it: PyTorch's reduction sums a row in an order that
// depends on how many rows one call reduces, and a speculative verify
// window's rows then part from one-token decode steps in their last bits.
//
// The order of the sum depends on d (and the element size) alone, by the
// launch plan `hqq_tpu_torch.ops.norm.norm_launch_plan`: a row belongs to
// `threads` = 2^threads_log2 threads (one warp for short rows, several rows
// a block then); thread t sums, in one fp32 accumulator, the squares of the
// vectors v = t, t + threads, ... of `vec` elements each, element by element;
// then the threads' sums combine by halving (p[i] += p[i + s] for s =
// threads/2 .. 1), in shared memory down to 32 and by warp shuffles below.
// No row is split over blocks. Every product and sum is __fmul_rn /
// __fadd_rn, so nvcc contracts nothing into an FMA, and 1/sqrt is
// __fsqrt_rn then __fdiv_rn: each step is one correctly rounded IEEE
// operation, which the plain twin (`rms_norm_plain`) repeats in PyTorch to
// the bit.
//
// Bound by bytes: each x read twice (the second pass mostly from L1/L2),
// each y written once; a block's sums cost nothing beside the loads.
#include "hqq_common.cuh"

namespace {

constexpr int kMaxBlock = 1024;
constexpr int kMaxRowsPerBlock = 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

__device__ __forceinline__ void from_f32(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* p) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void from_f32(float v, __half* p) { *p = __float2half_rn(v); }

// V elements of type T from p into fp32: one 16-byte load where V * sizeof(T)
// is 16 (the plan then guarantees 16-byte rows), else element by element.
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&f)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) f[j] = to_f32(e[j]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) f[j] = to_f32(p[j]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&f)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) from_f32(f[j], e + j);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) from_f32(f[j], p + j);
  }
}

// One row per 2^threads_log2 threads, blockDim.x / 2^threads_log2 rows a
// block.
template <typename T, typename W, int V>
__global__ void __launch_bounds__(kMaxBlock) rms_norm_kernel(const T* __restrict__ x,
                                                             const W* __restrict__ w,
                                                             T* __restrict__ out, long rows,
                                                             int d, int threads_log2, float eps,
                                                             float offset) {
  __shared__ float red[kMaxBlock];
  __shared__ float rinv_row[kMaxRowsPerBlock];
  const int threads = 1 << threads_log2;
  const int sub = threadIdx.x >> threads_log2;
  const int t = threadIdx.x & (threads - 1);
  const long row = static_cast<long>(blockIdx.x) * (blockDim.x >> threads_log2) + sub;
  const bool live = row < rows;
  const int nvec = d / V;
  const T* xr = x + (live ? row : 0) * static_cast<long>(d);

  float acc = 0.f;
  if (live) {
    for (int v = t; v < nvec; v += threads) {
      float f[V];
      load_vec<T, V>(xr + static_cast<long>(v) * V, f);
#pragma unroll
      for (int j = 0; j < V; ++j) acc = __fadd_rn(acc, __fmul_rn(f[j], f[j]));
    }
  }
  // halving tree: levels of 32 and more in shared memory, then the warp
  float* r = red + sub * threads;
  if (threads > 32) {
    r[t] = acc;
    __syncthreads();
    for (int s = threads >> 1; s >= 32; s >>= 1) {
      if (t < s) r[t] = __fadd_rn(r[t], r[t + s]);
      __syncthreads();
    }
    acc = r[t & 31];
  }
  if (t < 32) {
#pragma unroll
    for (int s = 16; s >= 1; s >>= 1) acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, s));
  }
  if (t == 0) {
    const float ms = __fdiv_rn(acc, static_cast<float>(d));
    rinv_row[sub] = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(ms, eps)));
  }
  __syncthreads();
  if (!live) return;
  const float rinv = rinv_row[sub];
  T* yr = out + row * static_cast<long>(d);
  for (int v = t; v < nvec; v += threads) {
    float f[V], g[V];
    load_vec<T, V>(xr + static_cast<long>(v) * V, f);
#pragma unroll
    for (int j = 0; j < V; ++j) g[j] = to_f32(w[v * V + j]);
#pragma unroll
    for (int j = 0; j < V; ++j) f[j] = __fmul_rn(__fmul_rn(f[j], rinv), __fadd_rn(g[j], offset));
    store_vec<T, V>(yr + static_cast<long>(v) * V, f);
  }
}

template <typename T, typename W>
int launch(const void* x, const void* w, void* out, long rows, int d, float eps, float offset,
           int vec, int threads_log2, int rows_per_block, cudaStream_t s) {
  const int block = rows_per_block << threads_log2;
  if (block > kMaxBlock || rows_per_block > kMaxRowsPerBlock || (threads_log2 < 5) ||
      d % vec) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long grid = (rows + rows_per_block - 1) / rows_per_block;
  if (grid > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
  const T* xp = static_cast<const T*>(x);
  const W* wp = static_cast<const W*>(w);
  T* op = static_cast<T*>(out);
  constexpr int V16 = 16 / sizeof(T);
  if (vec == V16) {
    rms_norm_kernel<T, W, V16><<<static_cast<unsigned>(grid), block, 0, s>>>(
        xp, wp, op, rows, d, threads_log2, eps, offset);
  } else if (vec == 1) {
    rms_norm_kernel<T, W, 1><<<static_cast<unsigned>(grid), block, 0, s>>>(
        xp, wp, op, rows, d, threads_log2, eps, offset);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_w(const void* x, const void* w, void* out, long rows, int d, float eps, float offset,
             int w_dtype, int vec, int threads_log2, int rows_per_block, cudaStream_t s) {
  switch (w_dtype) {
    case HQQ_F32:
      return launch<T, float>(x, w, out, rows, d, eps, offset, vec, threads_log2, rows_per_block,
                              s);
    case HQQ_BF16:
      return launch<T, __nv_bfloat16>(x, w, out, rows, d, eps, offset, vec, threads_log2,
                                      rows_per_block, s);
    case HQQ_F16:
      return launch<T, __half>(x, w, out, rows, d, eps, offset, vec, threads_log2,
                               rows_per_block, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x, out [rows, d] contiguous, of x_dtype; w [d] of w_dtype. The plan's vec,
// threads_log2 and rows_per_block (`norm_launch_plan`).
HQQ_EXPORT int hqq_rms_norm(const void* x, const void* w, void* out, int rows, int d, float eps,
                            float offset, int x_dtype, int w_dtype, int vec, int threads_log2,
                            int rows_per_block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case HQQ_F32:
      return launch_w<float>(x, w, out, rows, d, eps, offset, w_dtype, vec, threads_log2,
                             rows_per_block, s);
    case HQQ_BF16:
      return launch_w<__nv_bfloat16>(x, w, out, rows, d, eps, offset, w_dtype, vec,
                                     threads_log2, rows_per_block, s);
    case HQQ_F16:
      return launch_w<__half>(x, w, out, rows, d, eps, offset, w_dtype, vec, threads_log2,
                              rows_per_block, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

HQQ_EXPORT const char* hqq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
