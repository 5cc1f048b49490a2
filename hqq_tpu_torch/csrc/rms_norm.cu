// SPDX-License-Identifier: Apache-2.0
// The two norms of the model families, over rows of width d, every step in
// fp32 and y rounded to x's type (bf16, fp16 or fp32):
//   RMSNorm    y = (x * rsqrt(mean(x^2) + eps)) * (w + offset)
//   LayerNorm  y = ((x - mu) * rsqrt(var + eps)) * w [+ b], mu = mean(x),
//              var = mean((x - mu)^2): the two-pass form
//
// Replace no Pallas kernel: `hqq_tpu/models/llama.py:268` `rms_norm` (and
// `_gemma_norm` of `hqq_tpu/models/gemma.py:68`, offset 1) and the three
// LayerNorms (`hqq_tpu/models/vit.py:131` `_layer_norm`, `phi.py:153`
// `layer_norm`, `cohere.py:75` `cohere_norm`, weight only) are left to XLA's
// fusion there. They are kernels here because a row's result must not depend
// on the rows beside it: PyTorch's reduction sums a row in an order that
// depends on how many rows one call reduces, and a speculative verify
// window's rows then part from one-token decode steps in their last bits.
//
// The order of every sum depends on d (and the element size) alone, by the
// launch plan `hqq_tpu_torch.ops.norm.norm_launch_plan`: a row belongs to
// `threads` = 2^threads_log2 threads (one warp for short rows, several rows
// a block then); thread t sums, in one fp32 accumulator, the values of the
// vectors v = t, t + threads, ... of `vec` elements each, element by element;
// then the threads' sums combine by halving (p[i] += p[i + s] for s =
// threads/2 .. 1), in shared memory down to 32 and by warp shuffles below.
// No row is split over blocks. LayerNorm sums twice in that order: x, then
// (x - mu)^2 with mu = sum / d. Every product, sum and difference is
// __fmul_rn / __fadd_rn / __fsub_rn, so nvcc contracts nothing into an FMA,
// and 1/sqrt is __fsqrt_rn then __fdiv_rn: each step is one correctly
// rounded IEEE operation, which the plain twins (`rms_norm_plain`,
// `layer_norm_plain`) repeat in PyTorch to the bit.
//
// Bound by bytes: each x read twice (three times for LayerNorm; the later
// passes mostly from L1/L2), each y written once; a block's sums cost
// nothing beside the loads.
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

// The halving tree over a row's `threads` partial sums (r: the row's slice
// of shared memory): levels of 32 and more in shared memory, then the warp.
// Every thread of the block calls it (it synchronises the block); the sum is
// thread 0's of the row.
__device__ __forceinline__ float tree_sum(float acc, float* r, int t, int threads) {
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
  return acc;
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
  acc = tree_sum(acc, red + sub * threads, t, threads);
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

// The grid of a launch plan (`norm_launch_plan`), or -1 where the kernels
// do not take the plan.
long plan_grid(long rows, int d, int vec, int threads_log2, int rows_per_block) {
  const int block = rows_per_block << threads_log2;
  if (block > kMaxBlock || rows_per_block > kMaxRowsPerBlock || threads_log2 < 5 || d % vec) {
    return -1;
  }
  const long grid = (rows + rows_per_block - 1) / rows_per_block;
  return grid > 0x7fffffffL ? -1 : grid;
}

template <typename T, typename W>
int launch(const void* x, const void* w, void* out, long rows, int d, float eps, float offset,
           int vec, int threads_log2, int rows_per_block, cudaStream_t s) {
  const int block = rows_per_block << threads_log2;
  const long grid = plan_grid(rows, d, vec, threads_log2, rows_per_block);
  if (grid < 0) return static_cast<int>(cudaErrorInvalidValue);
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

// LayerNorm: one row per 2^threads_log2 threads, as rms_norm_kernel. Row r
// reads weight row r % w_rows of w (and b, when given): [w_rows, d], the
// per-head weights of a norm over [.., H, d] with w_rows = H, else one row.
template <typename T, typename W, int V>
__global__ void __launch_bounds__(kMaxBlock) layer_norm_kernel(const T* __restrict__ x,
                                                               const W* __restrict__ w,
                                                               const W* __restrict__ b,
                                                               T* __restrict__ out, long rows,
                                                               int d, int w_rows,
                                                               int threads_log2, float eps) {
  __shared__ float red[kMaxBlock];
  __shared__ float mu_row[kMaxRowsPerBlock];
  __shared__ float rinv_row[kMaxRowsPerBlock];
  const int threads = 1 << threads_log2;
  const int sub = threadIdx.x >> threads_log2;
  const int t = threadIdx.x & (threads - 1);
  const long row = static_cast<long>(blockIdx.x) * (blockDim.x >> threads_log2) + sub;
  const bool live = row < rows;
  const int nvec = d / V;
  const T* xr = x + (live ? row : 0) * static_cast<long>(d);
  float* r = red + sub * threads;

  // first pass: the sum of x, then mu = sum / d
  float acc = 0.f;
  if (live) {
    for (int v = t; v < nvec; v += threads) {
      float f[V];
      load_vec<T, V>(xr + static_cast<long>(v) * V, f);
#pragma unroll
      for (int j = 0; j < V; ++j) acc = __fadd_rn(acc, f[j]);
    }
  }
  acc = tree_sum(acc, r, t, threads);
  if (t == 0) mu_row[sub] = __fdiv_rn(acc, static_cast<float>(d));
  __syncthreads();
  const float mu = mu_row[sub];

  // second pass: the sum of (x - mu)^2, then 1 / sqrt(var + eps)
  acc = 0.f;
  if (live) {
    for (int v = t; v < nvec; v += threads) {
      float f[V];
      load_vec<T, V>(xr + static_cast<long>(v) * V, f);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float c = __fsub_rn(f[j], mu);
        acc = __fadd_rn(acc, __fmul_rn(c, c));
      }
    }
  }
  acc = tree_sum(acc, r, t, threads);
  if (t == 0) {
    const float var = __fdiv_rn(acc, static_cast<float>(d));
    rinv_row[sub] = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
  }
  __syncthreads();
  if (!live) return;
  const float rinv = rinv_row[sub];
  const long wo = (row % w_rows) * static_cast<long>(d);
  const W* wr = w + wo;
  const W* br = b == nullptr ? nullptr : b + wo;
  T* yr = out + row * static_cast<long>(d);
  for (int v = t; v < nvec; v += threads) {
    float f[V];
    load_vec<T, V>(xr + static_cast<long>(v) * V, f);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      f[j] = __fmul_rn(__fmul_rn(__fsub_rn(f[j], mu), rinv), to_f32(wr[v * V + j]));
    }
    if (br != nullptr) {
#pragma unroll
      for (int j = 0; j < V; ++j) f[j] = __fadd_rn(f[j], to_f32(br[v * V + j]));
    }
    store_vec<T, V>(yr + static_cast<long>(v) * V, f);
  }
}

template <typename T, typename W>
int launch_ln(const void* x, const void* w, const void* b, void* out, long rows, int d,
              int w_rows, float eps, int vec, int threads_log2, int rows_per_block,
              cudaStream_t s) {
  const int block = rows_per_block << threads_log2;
  const long grid = plan_grid(rows, d, vec, threads_log2, rows_per_block);
  if (grid < 0 || w_rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const T* xp = static_cast<const T*>(x);
  const W* wp = static_cast<const W*>(w);
  const W* bp = static_cast<const W*>(b);
  T* op = static_cast<T*>(out);
  constexpr int V16 = 16 / sizeof(T);
  if (vec == V16) {
    layer_norm_kernel<T, W, V16><<<static_cast<unsigned>(grid), block, 0, s>>>(
        xp, wp, bp, op, rows, d, w_rows, threads_log2, eps);
  } else if (vec == 1) {
    layer_norm_kernel<T, W, 1><<<static_cast<unsigned>(grid), block, 0, s>>>(
        xp, wp, bp, op, rows, d, w_rows, threads_log2, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_ln_w(const void* x, const void* w, const void* b, void* out, long rows, int d,
                int w_rows, float eps, int w_dtype, int vec, int threads_log2,
                int rows_per_block, cudaStream_t s) {
  switch (w_dtype) {
    case HQQ_F32:
      return launch_ln<T, float>(x, w, b, out, rows, d, w_rows, eps, vec, threads_log2,
                                 rows_per_block, s);
    case HQQ_BF16:
      return launch_ln<T, __nv_bfloat16>(x, w, b, out, rows, d, w_rows, eps, vec,
                                         threads_log2, rows_per_block, s);
    case HQQ_F16:
      return launch_ln<T, __half>(x, w, b, out, rows, d, w_rows, eps, vec, threads_log2,
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

// x, out [rows, d] contiguous, of x_dtype; w and b [w_rows, d] of w_dtype (b
// may be null: no bias). The plan's vec, threads_log2 and rows_per_block
// (`norm_launch_plan`).
HQQ_EXPORT int hqq_layer_norm(const void* x, const void* w, const void* b, void* out, int rows,
                              int d, int w_rows, float eps, int x_dtype, int w_dtype, int vec,
                              int threads_log2, int rows_per_block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case HQQ_F32:
      return launch_ln_w<float>(x, w, b, out, rows, d, w_rows, eps, w_dtype, vec, threads_log2,
                                rows_per_block, s);
    case HQQ_BF16:
      return launch_ln_w<__nv_bfloat16>(x, w, b, out, rows, d, w_rows, eps, w_dtype, vec,
                                        threads_log2, rows_per_block, s);
    case HQQ_F16:
      return launch_ln_w<__half>(x, w, b, out, rows, d, w_rows, eps, w_dtype, vec,
                                 threads_log2, rows_per_block, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

HQQ_EXPORT const char* hqq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
