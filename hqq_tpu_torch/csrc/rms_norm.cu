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
// launch plan `hqq_tpu_torch.ops.norm.norm_launch_plan` (LayerNorm's with
// `layer=True`): a row belongs to `threads` = 2^threads_log2 threads (one
// warp for short rows, several rows a block then); thread t sums, in one
// fp32 accumulator, the values of the vectors v = t, t + threads, ... of
// `vec` elements each, element by element; then the threads' sums combine
// by halving (p[i] += p[i + s] for s = threads/2 .. 1). No row is split
// over blocks. LayerNorm sums twice in that order: x, then (x - mu)^2 with
// mu = sum / d. Every product, sum and difference is __fmul_rn / __fadd_rn
// / __fsub_rn, so nvcc contracts nothing into an FMA, and 1/sqrt is
// __fsqrt_rn then __fdiv_rn: each step is one correctly rounded IEEE
// operation, which the plain twins (`rms_norm_plain`, `layer_norm_plain`)
// repeat in PyTorch to the bit.
//
// Bound by bytes: each x read once and each y written once at best; a
// block's sums cost nothing beside the loads. RMSNorm reads x twice (the
// second pass mostly from L1/L2) and halves in shared memory down to 32
// threads, a barrier a level. LayerNorm (redesigned: it lost to
// F.layer_norm at the vision towers' widths) reads each row once, in
// 16-byte vectors, into registers (at most 40 values a thread, so its plan
// gives a row the fewest threads that hold it: one warp up to 1280 bf16 or
// fp32 values, 128 threads at Falcon-7B's 4544), takes both sums and y
// from there, loads w and b in 16-byte vectors where aligned, and halves
// across a row's warps with one exchange through shared memory a sum, the
// rest by warp shuffles.
#include "hqq_common.cuh"

namespace {

constexpr int kMaxBlock = 1024;
constexpr int kMaxRowsPerBlock = 32;
// LayerNorm: the values of x a thread holds in registers and the most
// threads of a block (ops/norm.py `_LN_REG_FLOATS`, `_LN_MAX_ROW_THREADS`)
constexpr int kLnRegFloats = 40;
constexpr int kLnMaxBlock = 512;

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

// V elements of weight type W at p into fp32: 16-byte loads where `wide`
// (V * sizeof(W) a multiple of 16 and p 16-byte aligned), else one by one.
template <typename W, int V>
__device__ __forceinline__ void load_w(const W* p, bool wide, float (&f)[V]) {
  if constexpr (V * sizeof(W) % 16 == 0) {
    if (wide) {
#pragma unroll
      for (int c = 0; c < V * static_cast<int>(sizeof(W)) / 16; ++c) {
        const uint4 raw = *reinterpret_cast<const uint4*>(p + c * 16 / sizeof(W));
        const W* e = reinterpret_cast<const W*>(&raw);
#pragma unroll
        for (int j = 0; j < 16 / static_cast<int>(sizeof(W)); ++j)
          f[c * 16 / sizeof(W) + j] = to_f32(e[j]);
      }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) f[j] = to_f32(p[j]);
}

// The halving tree of `tree_sum` over a row's `threads` partial sums, with
// one exchange through shared memory (r: the row's `threads` floats) where
// the row spans warps: levels s >= 32 pair thread i with i + s, the same
// lane of another warp, so lane l first halves the warps' values of lane l
// in registers; then the warp's levels by xor shuffles, which leave the
// same bits in every lane. Every thread of the block calls it (it
// synchronises the block where threads > 32); every thread of the row gets
// the sum.
__device__ __forceinline__ float row_sum(float acc, float* r, int t, int threads) {
  if (threads > 32) {
    constexpr int kWarps = kLnMaxBlock / 32;
    const int warps = threads >> 5, lane = t & 31;
    r[t] = acc;
    __syncthreads();
    float q[kWarps];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) q[w] = w < warps ? r[w * 32 + lane] : 0.f;
#pragma unroll
    for (int s = kWarps / 2; s >= 1; s >>= 1) {
      if (s < warps) {
#pragma unroll
        for (int w = 0; w < s; ++w) q[w] = __fadd_rn(q[w], q[w + s]);
      }
    }
    acc = q[0];
  }
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, s));
  return acc;
}

// LayerNorm: one row per 2^threads_log2 threads, blockDim.x /
// 2^threads_log2 rows a block, each thread's vectors t, t + threads, ... (at
// most S of them) read once into registers: the sum of x, mu, the sum of
// (x - mu)^2 and y all from there. Row r reads weight row r % w_rows of w
// (and b, when given): [w_rows, d], the per-head weights of a norm over
// [.., H, d] with w_rows = H, else one row.
template <typename T, typename W, int V, int S>
__global__ void __launch_bounds__(kLnMaxBlock) layer_norm_kernel(const T* __restrict__ x,
                                                               const W* __restrict__ w,
                                                               const W* __restrict__ b,
                                                               T* __restrict__ out, long rows,
                                                               int d, int w_rows,
                                                               int threads_log2, float eps) {
  __shared__ float red[2][kLnMaxBlock];
  const int threads = 1 << threads_log2;
  const int sub = threadIdx.x >> threads_log2;
  const int t = threadIdx.x & (threads - 1);
  const long row = static_cast<long>(blockIdx.x) * (blockDim.x >> threads_log2) + sub;
  const bool live = row < rows;
  const int nvec = d / V;
  const T* xr = x + (live ? row : 0) * static_cast<long>(d);

  // the row's values, every load issued before the first sum
  float f[S][V];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int v = t + k * threads;
    if (live && v < nvec) {
      load_vec<T, V>(xr + static_cast<long>(v) * V, f[k]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) f[k][j] = 0.f;
    }
  }

  // the sum of x, then mu = sum / d
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    if (t + k * threads < nvec) {
#pragma unroll
      for (int j = 0; j < V; ++j) acc = __fadd_rn(acc, f[k][j]);
    }
  }
  const float mu =
      __fdiv_rn(row_sum(acc, red[0] + sub * threads, t, threads), static_cast<float>(d));

  // the sum of (x - mu)^2, then 1 / sqrt(var + eps)
  acc = 0.f;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    if (t + k * threads < nvec) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        f[k][j] = __fsub_rn(f[k][j], mu);
        acc = __fadd_rn(acc, __fmul_rn(f[k][j], f[k][j]));
      }
    }
  }
  const float var =
      __fdiv_rn(row_sum(acc, red[1] + sub * threads, t, threads), static_cast<float>(d));
  const float rinv = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
  if (!live) return;

  const long wo = (row % w_rows) * static_cast<long>(d);
  const W* wr = w + wo;
  const W* br = b == nullptr ? nullptr : b + wo;
  const bool wide = ((reinterpret_cast<uintptr_t>(wr) |
                      (br == nullptr ? 0 : reinterpret_cast<uintptr_t>(br))) & 15) == 0;
  T* yr = out + row * static_cast<long>(d);
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int v = t + k * threads;
    if (v >= nvec) continue;
    float g[V];
    load_w<W, V>(wr + v * V, wide, g);
#pragma unroll
    for (int j = 0; j < V; ++j) f[k][j] = __fmul_rn(__fmul_rn(f[k][j], rinv), g[j]);
    if (br != nullptr) {
      load_w<W, V>(br + v * V, wide, g);
#pragma unroll
      for (int j = 0; j < V; ++j) f[k][j] = __fadd_rn(f[k][j], g[j]);
    }
    store_vec<T, V>(yr + static_cast<long>(v) * V, f[k]);
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
  // a thread's vectors must fit its registers
  if ((vec != V16 && vec != 1) || block > kLnMaxBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((d / vec + (1 << threads_log2) - 1) >> threads_log2 > kLnRegFloats / vec)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec == V16) {
    layer_norm_kernel<T, W, V16, kLnRegFloats / V16>
        <<<static_cast<unsigned>(grid), block, 0, s>>>(xp, wp, bp, op, rows, d, w_rows,
                                                       threads_log2, eps);
  } else {
    layer_norm_kernel<T, W, 1, kLnRegFloats><<<static_cast<unsigned>(grid), block, 0, s>>>(
        xp, wp, bp, op, rows, d, w_rows, threads_log2, eps);
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
