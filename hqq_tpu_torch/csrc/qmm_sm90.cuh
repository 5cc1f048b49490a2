// SPDX-License-Identifier: Apache-2.0
// The Hopper mainloop of the fused dequant-matmul kernels (quant_matmul.cu,
// quant_matmul_ax0.cu): TMA, wgmma and an mbarrier pipeline, in raw PTX.
//
// The operands are swapped: wgmma's 64-row A side takes dequantized weight
// rows (output features), its N side takes a tile of BM tokens, so a block
// computes D = W_tile . x_tile^T, the transposed 128 x BM tile of y, with
// both operands K-major in shared memory. BM is 8 at decode and up to 256
// at prefill (8, 32, 64, 128, 256), so a few tokens waste no tensor-core
// rows.
//
// A block is three warpgroups: a producer and two consumers of 64 weight
// rows each. K is walked in slabs of 64 through a ring of `stages` slots,
// each with a full and an empty mbarrier:
//   producer   waits for the slot to be empty and loads x's [BM x 64]
//              slab by one TMA (128-byte swizzle; rows past M and columns
//              past K arrive as zeros), the slab's packed codes by a second
//              and its scale and zs by two more, all counted on the slot's
//              full barrier by bytes. Where a weight breaks TMA's 16-byte
//              rules (1-bit codes, odd strides, odd groups) its 128
//              threads copy that part by cp.async instead (zero-filled
//              past the tensor), each arriving on the barrier when its
//              copies land. TMA first: per-row cp.async of 4 to 16 bytes
//              for everything took 0.108 ms against TMA's 0.055 at M=512,
//              K=N=4096 (H100 80GB HBM3, 700 W);
//   consumers  wait for the slot to be full, dequantize their 64 x 64
//              weight slab from shared memory into one of two A tiles (in
//              the swizzle the descriptor declares), fence the generic
//              proxy against the async one, issue four m64nBMk16 wgmma on
//              it and x's slab, and wait for the previous slab's wgmma
//              only, so the dequantization of slab s overlaps the products
//              of slab s-1; then they release that slab's slot.
// The epilogue transposes the fp32 accumulators through shared memory and
// stores y in 16-byte rows (or an fp32 partial when K is split over
// gridDim.z; `qmm_sum_splits` adds the partials in a fixed order).
//
// A layout (the .cu file's own) supplies how a slab's codes and meta are
// loaded, where a row's scale and zs sit, and which column of y a weight
// row is. The dequantized operand is bit-identical to the plain version's
// (an fp32 multiply, then an fp32 subtract, rounded to x's type), so only
// the order of the fp32 sums differs.
#pragma once

#include <cuda.h>

#include "hqq_common.cuh"

namespace sm90 {

constexpr int kBN = 128;       // weight rows of a block (two consumer warpgroups)
constexpr int kBK = 64;        // K of a slab: one 128-byte swizzle row of bf16
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kATile = 64 * kBK * 2;  // one consumer's dequantized 64 x 64 slab

// What the host computes once per launch and the kernel reads.
struct Params {
  const uint8_t* wq;
  const void* scale;
  const void* zs;
  void* out;
  float* part;      // fp32 [splits, M, N] when K is split, else null
  int m, n;         // tokens, weight rows (output features)
  int row_bytes;    // bytes of one packed code row
  int meta_cols;    // axis=1: groups per row (K/g); axis=0: K_pad
  int group_size, cb, pblocks;
  int code_vec, meta_vec;  // cp.async sizes (4, 8 or 16 bytes)
  int meta_rows;           // axis=0: rows of scale and zs a tile reads
  int slab_groups;         // axis=1: groups of a slab row a slot holds (at least 4)
  int meta_shift;          // axis=1: g neither divides nor is divided by 64
  int group_log2;          // log2(g) where g is a power of two, else -1
  int codes_tma, meta_tma; // 1: the slab's codes / scale and zs come by TMA
  int tx_bytes;            // bytes the TMA loads of a slot deliver
  int slabs, slabs_per_split, stages;
  int code_stage, meta_stage;  // bytes of a slot's codes and meta
  int out_dtype;
};

// Shared-memory carve-up; ops/fused_matmul.py `qmm_launch_plan` computes the
// same sizes.
struct SmemLayout {
  int x, scratch, per_wg, codes, meta, bars, total;
};

__host__ __device__ inline SmemLayout smem_layout(int bm, int stages, int code_stage,
                                                  int meta_stage) {
  SmemLayout s;
  s.x = 0;
  s.scratch = stages * bm * 128;
  // two A tiles, or the epilogue's [BM x 64] staging of y in x's type (an
  // fp32 partial needs BM <= 64)
  s.per_wg = 2 * kATile > bm * 128 ? 2 * kATile : bm * 128;
  s.codes = s.scratch + 2 * s.per_wg;
  s.meta = s.codes + stages * code_stage;
  s.bars = s.meta + stages * meta_stage;
  s.total = s.bars + 16 * stages + 1024;  // + slack to align the base to 1024
  return s;
}

// ---------------------------------------------------------------- PTX ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// cp.async of `vec` bytes, zero-filled when !valid (src is then not read)
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, int vec, bool valid) {
  const int n = valid ? vec : 0;
  if (vec == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n)
                 : "memory");
  } else if (vec == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(n)
                 : "memory");
  }
}

// the barrier counts one arrival once every earlier cp.async of the thread landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulators while a wgmma owns them
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// K-major operand in the 128-byte swizzle: rows of 128 bytes, 8-row groups
// 1024 bytes apart (SBO), the tile 1024-byte aligned; +2 per k16 step.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// the 16-byte chunk q of row r of a 128-byte-swizzled tile
__device__ __forceinline__ int sw128(int r, int q) { return r * 128 + ((q ^ (r & 7)) << 4); }

// D[64 x N] += A[64 x 16] . B[N x 16]^T, both from shared memory, K-major
template <typename T, int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma<__nv_bfloat16, 8>(float (&d)[4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<__half, 8>(float (&d)[4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.f16.f16 "
      "{%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<__nv_bfloat16, 32>(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<__half, 32>(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<__nv_bfloat16, 64>(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<__half, 64>(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<__nv_bfloat16, 128>(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<__half, 128>(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<__nv_bfloat16, 256>(float (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<__half, 256>(float (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

// -------------------------------------------------------------- dequant --

template <typename T>
__device__ __forceinline__ T to_type(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 to_type<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half to_type<__half>(float v) {
  return __float2half_rn(v);
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(float a, float b);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float a, float b) {
  const __half2 v = __floats2half2_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// byte e of w as an exact float: 2^23 + code, less 2^23
__device__ __forceinline__ float code_f32(uint32_t w, int e) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540u | e)) - 8388608.f;
}

// Eight codes k = 8q..8q+7 of a packed row (word layout of hqq_common.cuh)
// as two words of four byte-wide codes each.
struct ChunkCodes {
  int offset;  // byte offset of the chunk's word(s) within a slab row
  int shift;
  uint32_t mask;
};

__device__ __forceinline__ ChunkCodes chunk_codes(int q, int cb) {
  ChunkCodes c;
  if (cb == 8) {
    c.offset = 8 * q, c.shift = 0;
  } else {
    const int per_word = 4 / cb;  // chunks of 8 codes in a 32-bit word
    c.offset = 4 * (q / per_word);
    c.shift = cb * 2 * (q % per_word);
  }
  c.mask = ((1u << cb) - 1u) * 0x01010101u;
  return c;
}

__device__ __forceinline__ void read_codes(const uint8_t* row, const ChunkCodes& c, int cb,
                                           uint32_t& lo, uint32_t& hi) {
  if (cb == 8) {
    const uint2 w = *reinterpret_cast<const uint2*>(row + c.offset);
    lo = w.x, hi = w.y;
  } else {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(row + c.offset) >> c.shift;
    lo = w & c.mask, hi = (w >> cb) & c.mask;
  }
}

// ---------------------------------------------------------------- kernel --

template <typename T, int BM, typename Layout>
__global__ void __launch_bounds__(kThreads, 1)
    qmm_sm90_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap cmap,
                    const __grid_constant__ CUtensorMap smap,
                    const __grid_constant__ CUtensorMap zmap, const Params p) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~static_cast<uintptr_t>(1023));
  const SmemLayout L = smem_layout(BM, p.stages, p.code_stage, p.meta_stage);
  const uint32_t full0 = smem_u32(smem + L.bars);
  const uint32_t empty0 = full0 + 8 * p.stages;

  const int p0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * BM;
  const int kb = blockIdx.z * p.slabs_per_split;
  const int nslab = min(p.slabs, kb + p.slabs_per_split) - kb;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full0 + 8 * s, 128 + 1);  // the producers' cp.async + the TMA's expect_tx
      mbar_init(empty0 + 8 * s, 2);       // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    const int tid = threadIdx.x;
    for (int it = 0; it < nslab; ++it) {
      const int s = it % p.stages;
      mbar_wait(empty0 + 8 * s, ((it / p.stages) & 1) ^ 1);
      const int k0 = (kb + it) * kBK;
      const uint32_t full = full0 + 8 * s;
      const uint32_t codes = smem_u32(smem + L.codes + s * p.code_stage);
      const uint32_t meta = smem_u32(smem + L.meta + s * p.meta_stage);
      if (tid == 0) {
        mbar_expect_tx(full, p.tx_bytes);
        tma_load_2d(smem_u32(smem + L.x + s * BM * 128), &xmap, full, k0, m0);
        if (p.codes_tma) {
          int c[3];
          Layout::code_coords(p, p0, k0, c);
          tma_load_3d(codes, &cmap, full, c[0], c[1], c[2]);
        }
        if (p.meta_tma) {
          int c[2];
          Layout::meta_coords(p, p0, k0, c);
          tma_load_2d(meta, &smap, full, c[0], c[1]);
          tma_load_2d(meta + p.meta_stage / 2, &zmap, full, c[0], c[1]);
        }
      }
      if (!p.codes_tma || !p.meta_tma) Layout::load_slab(p, p0, k0, codes, meta, tid);
      cp_async_arrive(full);
    }
  } else {
    // ---- consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
    const int wg = threadIdx.x / 128 - 1;
    const int ct = threadIdx.x % 128;
    const int q = ct % 8;  // the thread's 16-byte chunk of each row it dequantizes
    const ChunkCodes cc = chunk_codes(q, p.cb);
    int code_off[4], meta_off[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int pr = wg * 64 + i * 16 + ct / 8;  // tile row
      code_off[i] = Layout::code_row(p, pr) * 8 * p.cb;
      meta_off[i] = Layout::meta_offset(p, p0, pr, q);
    }
    const int zs_off = Layout::zs_offset(p);
    uint8_t* a_tiles = smem + L.scratch + wg * L.per_wg;

    float acc[BM / 2];
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;

    for (int it = 0; it < nslab; ++it) {
      const int s = it % p.stages;
      mbar_wait(full0 + 8 * s, (it / p.stages) & 1);
      const uint8_t* codes = smem + L.codes + s * p.code_stage;
      const uint8_t* meta = smem + L.meta + s * p.meta_stage;
      uint8_t* a = a_tiles + (it & 1) * kATile;
      const int k0 = (kb + it) * kBK;
      const int madd = Layout::meta_add(p, k0, q);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t lo, hi;
        read_codes(codes + code_off[i], cc, p.cb, lo, hi);
        float sc[8], z[8];
        Layout::meta8(meta, meta_off[i] + madd, zs_off, sc, z);
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = __fsub_rn(__fmul_rn(code_f32(e < 4 ? lo : hi, e & 3), sc[e]), z[e]);
        const int r = i * 16 + ct / 8;
        *reinterpret_cast<uint4*>(a + sw128(r, q)) =
            make_uint4(pack2<T>(v[0], v[1]), pack2<T>(v[2], v[3]), pack2<T>(v[4], v[5]),
                       pack2<T>(v[6], v[7]));
      }
      fence_proxy_async();
      named_sync(1 + wg);

      const uint64_t da = sw128_desc(smem_u32(a));
      const uint64_t db = sw128_desc(smem_u32(smem + L.x + s * BM * 128));
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks) wgmma<T, BM>(acc, da + 2 * ks, db + 2 * ks);
      wgmma_commit();
      wgmma_wait<1>();
      fence_acc(acc);
      if (it > 0 && ct == 0) mbar_arrive(empty0 + 8 * ((it - 1) % p.stages));
    }
    wgmma_wait<0>();
    fence_acc(acc);

    // ---- epilogue: the accumulators, transposed, through this warpgroup's
    // A tiles (all its wgmma are done), then out in 16-byte rows
    const int warp = ct / 32, lane = ct % 32;
    const int pw = p0 + wg * 64;  // the warpgroup's first weight row
    if (p.part != nullptr) {
      float* st = reinterpret_cast<float*>(a_tiles);  // [BM][64], 16-byte chunks swizzled
#pragma unroll
      for (int j = 0; j < BM / 8; ++j)
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int n = warp * 16 + lane / 4 + 8 * (h >> 1);
          const int m = 8 * j + 2 * (lane % 4) + (h & 1);
          st[m * 64 + (((n >> 2) ^ (m & 7)) << 2) + (n & 3)] = acc[4 * j + h];
        }
      named_sync(1 + wg);
      float* part = p.part + static_cast<size_t>(blockIdx.z) * p.m * p.n;
      for (int idx = ct; idx < BM * 16; idx += 128) {
        const int m = idx / 16, c = idx % 16;
        if (m0 + m >= p.m) continue;
        const float4 v = *reinterpret_cast<const float4*>(st + m * 64 + ((c ^ (m & 7)) << 2));
        const float e4[4] = {v.x, v.y, v.z, v.w};
        float* row = part + static_cast<size_t>(m0 + m) * p.n;
        const int pr = pw + 4 * c;
        if (Layout::kContiguous && pr + 4 <= p.n && p.n % 4 == 0) {
          *reinterpret_cast<float4*>(row + pr) = v;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (pr + e < p.n) row[Layout::column(p, pr + e)] = e4[e];
        }
      }
    } else {
      T* st = reinterpret_cast<T*>(a_tiles);  // [BM][64], 16-byte chunks swizzled
#pragma unroll
      for (int j = 0; j < BM / 8; ++j)
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int n = warp * 16 + lane / 4 + 8 * (h >> 1);
          const int m = 8 * j + 2 * (lane % 4) + (h & 1);
          st[m * 64 + (((n >> 3) ^ (m & 7)) << 3) + (n & 7)] = to_type<T>(acc[4 * j + h]);
        }
      named_sync(1 + wg);
      T* out = static_cast<T*>(p.out);
      for (int idx = ct; idx < BM * 8; idx += 128) {
        const int m = idx / 8, c = idx % 8;
        if (m0 + m >= p.m) continue;
        const uint4 v = *reinterpret_cast<const uint4*>(st + m * 64 + ((c ^ (m & 7)) << 3));
        T* row = out + static_cast<size_t>(m0 + m) * p.n;
        const int pr = pw + 8 * c;
        if (Layout::kContiguous && pr + 8 <= p.n && p.n % 8 == 0) {
          *reinterpret_cast<uint4*>(row + pr) = v;
        } else {
          const T* e8 = reinterpret_cast<const T*>(&v);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (pr + e < p.n) row[Layout::column(p, pr + e)] = e8[e];
        }
      }
    }
  }
}

// out[i] = sum over s of part[s][i], in order of s
__global__ void qmm_sum_splits(const float* __restrict__ part, void* __restrict__ out,
                               size_t count, int splits, int out_dtype) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < count;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < splits; ++s) v += part[static_cast<size_t>(s) * count + i];
    hqq_store(out, i, v, out_dtype);
  }
}

// ------------------------------------------------------------------ host --

// the largest of 16, 8, 4 bytes that divides every address a copy reads
inline int copy_vec(const void* base, long row_bytes, long slab_bytes) {
  const uintptr_t b = reinterpret_cast<uintptr_t>(base);
  for (int v = 16; v >= 4; v /= 2)
    if (b % v == 0 && row_bytes % v == 0 && slab_bytes % v == 0) return v;
  return 0;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A tensor map of `rank` <= 3 dimensions (innermost first; strides in bytes
// of dimensions 1..rank-1), boxes of `box`, zeros outside the tensor.
inline int encode_map(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* base,
                      const long* dims, const long* strides, const int* box,
                      CUtensorMapSwizzle swizzle) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                            &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess || fn == nullptr)
      return static_cast<int>(cudaErrorNotSupported);
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  cuuint64_t d[3], st[2];
  cuuint32_t b[3], elem[3] = {1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    d[i] = static_cast<cuuint64_t>(dims[i]);
    b[i] = static_cast<cuuint32_t>(box[i]);
    if (i > 0) st[i - 1] = static_cast<cuuint64_t>(strides[i - 1]);
  }
  const CUresult r = encode(map, type, rank, const_cast<void*>(base), d, st, b, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// x [m, kx] (bf16 or fp16, rows of 16-byte multiples) as boxes of [bm x 64]
// in the 128-byte swizzle
inline int encode_x_map(CUtensorMap* map, const void* x, int m, int kx, int bm, int dtype) {
  const long dims[2] = {kx, m}, strides[1] = {2L * kx};
  const int box[2] = {kBK, bm};
  return encode_map(map,
                    dtype == HQQ_BF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                      : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
                    2, x, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// the layout's maps of codes, scale and zs (unused where p says cp.async)
struct WeightMaps {
  CUtensorMap codes, scale, zs;
};

template <typename T, int BM, typename Layout>
int launch_tile(const void* x, int kx, Params p, const WeightMaps& w, int splits, int smem,
                cudaStream_t s) {
  CUtensorMap map;
  int e = encode_x_map(&map, x, p.m, kx, BM, p.out_dtype);
  p.tx_bytes = BM * 128 + (p.codes_tma ? p.code_stage : 0) + (p.meta_tma ? p.meta_stage : 0);
  if (e != 0) return e;
  if (smem < smem_layout(BM, p.stages, p.code_stage, p.meta_stage).total)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = qmm_sm90_kernel<T, BM, Layout>;
  e = static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (e != 0) return e;
  dim3 grid((p.n + kBN - 1) / kBN, (p.m + BM - 1) / BM, splits);
  kernel<<<grid, kThreads, smem, s>>>(map, w.codes, w.scale, w.zs, p);
  e = static_cast<int>(cudaGetLastError());
  if (e != 0 || splits == 1) return e;
  const size_t count = static_cast<size_t>(p.m) * p.n;
  const int blocks = static_cast<int>((count + 255) / 256 < 1024 ? (count + 255) / 256 : 1024);
  qmm_sum_splits<<<blocks, 256, 0, s>>>(p.part, p.out, count, splits, p.out_dtype);
  return static_cast<int>(cudaGetLastError());
}

// the kernel for token tile `bm` (8, 32, 64, 128 or 256)
template <typename T, typename Layout>
int launch(const void* x, int kx, const Params& p, const WeightMaps& w, int bm, int splits,
           int smem, cudaStream_t s) {
  if (splits < 1 || (splits > 1 && (p.part == nullptr || bm > 64)) || p.stages < 2 ||
      p.code_vec == 0 || p.meta_vec == 0 || kx % 8 != 0 ||
      (splits - 1) * p.slabs_per_split >= p.slabs || splits * p.slabs_per_split < p.slabs)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (bm) {
    case 8: return launch_tile<T, 8, Layout>(x, kx, p, w, splits, smem, s);
    case 32: return launch_tile<T, 32, Layout>(x, kx, p, w, splits, smem, s);
    case 64: return launch_tile<T, 64, Layout>(x, kx, p, w, splits, smem, s);
    case 128: return launch_tile<T, 128, Layout>(x, kx, p, w, splits, smem, s);
    case 256: return launch_tile<T, 256, Layout>(x, kx, p, w, splits, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace sm90
