// SPDX-License-Identifier: Apache-2.0
// w4a8_matmul: y[m, n] = sx[m] * sum_g( s[n,g] * dot_g(x8[m], c[n]) - xsum[m,g] * zs[n,g] )
// for M <= 32 rows of int8 activations x8 (x ~ x8 * sx, per row) against a
// 1/2/4/8-bit weight in the kernel layout of hqq_common.cuh. dot_g is the
// exact int32 dot of group g; the epilogue is fp32; y is written in fp32,
// bf16 or fp16. A second entry, w4a8_lora_matmul, adds a LoRA epilogue in
// fp32: y[m, n] += sum_j xa[m, j] * B[j, n], with xa = x @ A [M, r] computed
// by the caller from the unquantized activations and B [r, N] fp32 (the
// adapter's scaling folded in). Scale and zs are fp32 or bf16; bf16 is
// widened to fp32 as it is read, and the 4-bit container's zs gets its
// 8*scale back there (`hqq_ax1_zs_offset`): a flag, not a template argument.
//
// Replaces: hqq_tpu/ops/fused_matmul.py `_qmm_a8_decode_kernel` (launched by
//   `_qmm_a8_decode_call`) and `_qmm_a8_kernel` (launched by `_qmm_a8_call`),
//   both behind `quant_matmul_pallas_a8` for M <= 32. The TPU needs two
//   kernels (class-replicated deep dots when K % 8g == 0, batched per-group
//   dots otherwise); here the route follows the group: the tensor-core
//   kernel where a group is whole k32 steps, the small-group kernel below
//   otherwise. With the epilogue: `_qmm_a8_lora_decode_kernel` (launched by
//   `_qmm_a8_lora_decode_call`, entry `quant_matmul_pallas_a8_lora`).
// Bound on H100: bytes. At decode the weight is read once: K*N*cb/8 bytes of
//   codes plus 8*N*K/g of fp32 scale and zs (4096x4096, 4-bit, g64: 10.5 MB,
//   3.1 us at 3.35 TB/s). The int8 work, 2*M*N*K operations, is at most 2.9
//   GOP at M = 32 (32 x 4096 x 11008), ~3 us at half the int8 rate.
//
// Design (the tensor-core route, `w4a8_mma_kernel`, g % 32 == 0): the int8
// tensor cores with the operands swapped, a TMA ring fed by a producer
// warp, and K split over the consumer warps of a block.
//   * mma.sync m16n8k32 s8: the weight rows (output columns) are the MMA's
//     M side, the tokens its N side (one n8 tile per 8 tokens, NT <= 4), the
//     unpacked codes the A operand in registers, x8 the B operand. Codes are
//     0..63 at most, so s8 takes them as they are.
//   * The k order of an MMA (the fragment order, held by
//     tests/test_torch_w4a8_plan.py). In a k32 step the thread of
//     threadID_in_group t takes the codes 8t .. 8t+7 of the step, which one
//     kernel-layout word holds as two 4-code fields (two words for 8-bit):
//     word c*CB + t*CB/4 of the stage's row, fields f = 2t % (8/CB) and f+1.
//     (w >> CB*f) & mask is A register a0 (row g) or a1 (row g+8), which the
//     MMA reads as its k = 4t .. 4t+3; field f+1 is a2/a3, its k = 16+4t ..
//     16+4t+3. So B must hold x8 at k = 8t .. 8t+3 in b0 and 8t+4 .. 8t+7 in
//     b1: the 8 bytes at 8t of the step, one 8-byte read. The group dot does
//     not depend on the order of k within it, and a step never straddles a
//     group (g % 32 == 0 on this route). No shuffle, no pass of the codes
//     through shared memory beyond the TMA's landing.
//   * xsum[m, g] comes from the same B fragments: one more MMA per step with
//     an A of ones gives it in the accumulator's own layout (every row
//     equal), once per (token, step) and warp, never per column.
//   * Exact int32 dots folded into fp32, every 1, 2 or 4 steps of a group
//     (`consume_stage`): acc += s * dot - xsum * z.
//   * A block owns 32, 64 or 128 weight rows (the plan's column tile) and
//     all of K; no grid dimension over M, so every weight byte is read once
//     for every M <= 32. It first loads its scale and zs for the whole of K
//     (TMA boxes whose rows are an odd number of 16 bytes, so the 8 rows a
//     warp reads fall in 8 bank groups; where fp32 meta rows break the
//     16-byte rule, 4-byte cp.async by every thread). Then a producer warp
//     keeps `stages` stages in flight in an mbarrier ring, each the block's
//     rows x 1024/CB codes (one 128-byte row each, in the 128-byte TMA
//     swizzle, so the 8 rows a load instruction reads fall in 8 bank
//     groups) and the stage's x8 in 128-byte swizzled boxes.
//   * Eight consumer warps: rows/16 row groups by 8/(rows/16) k-slices.
//     Stage i goes to slice i % slices (the ring's slots are a multiple of
//     the slices, so a slot always goes to the same warps); at the end the
//     slices' fp32 partials meet in shared memory and are summed in slice
//     order: no atomics, no scratch in device memory, no second launch,
//     repeated runs bit-equal. The multiply by sx, the LoRA term and the
//     store follow.
//   * The launch plan is `w4a8_launch_plan` in ops/fused_matmul.py: route,
//     token tile, column tile, ring stages, meta box and shared memory
//     (`tc_smem` below computes the same; the entry refuses a plan whose
//     bytes differ).
// The small-group route (`w4a8_group_mma_kernel`): the same rows 2, 3 and 8
//   where a group is not whole k32 steps (g = 8, 16, 24, ...: HQQ+'s 2-bit
//   and 1.58-bit g8, 1-bit g8 and g16, whose groups are shorter than a
//   32-bit word) or where a block's scale and zs for all of K leave no room
//   for a ring (1-bit g32 at K = 11008 and 32 tokens).
// Bound on H100: bytes, and meta's most of them. At 2-bit g8 with fp32
//   scale and zs a weight row of K = 4096 is 1 KB of codes and 4 KB of meta
//   (80%): (4, 4096, 11008) reads 56.4 MB, 16.8 us at 3.35 TB/s. The fold
//   acc += s * dot - xsum * z is 3 fp32 instructions a (row, token, group):
//   at 32 tokens 0.54 G of them, ~18 us of the CUDA cores, past the bytes.
// Design: the tensor-core route's ring, streaming each stage's meta with its
//   codes, and per-group int8 MMAs.
//   * A block owns 64 or 32 weight rows and all of K; no grid dimension over
//     M, so every weight byte is read once for every M <= 32. A TMA warp
//     keeps the ring in flight: a stage is the rows' 128 code bytes, x8's
//     boxes, and the scale and zs of the groups those codes belong to
//     (boxes of 128 bytes a row from the stage's first group, rounded down
//     to 16 bytes; 4 KB a row at K = 4096 never fits a block for all of K).
//     All in the 128-byte swizzle: the 8 rows a warp reads fall in 8 bank
//     groups.
//   * Per-group dots on the int8 tensor cores, mma.sync m16n8k32 in the
//     fragment order of `unpack_a`: thread t holds the codes 8t .. 8t+7 of a
//     step, which lie in one group (g % 8 == 0), so zeroing the other
//     groups' chunks isolates a group's exact dot. An n8 tile is 4 tokens by
//     two halves: column half h of B holds its tokens' x8 only in the chunks
//     of the pieces h*P/2 .. of the step, so 2 MMAs a tile give a step's 4
//     groups at g8 (1 at g16, g24, ...), and M <= 4 fills the tile. Masking
//     A instead (4 MMAs of 8 tokens a step at g8) folded padding tokens at
//     M = 4: 35.5 against 33.8 us at (4, 4096, 11008), 2-bit g8, blocks of
//     32 rows and 4 k-slices alike (`chip_smoke.py --time`, one H100 at
//     700 W); there the MMAs cost 1.5 us of 40 (variant no-mma) and the
//     fold 14 (no-fold). m16n8k16 a group pair would still mix two groups
//     in one MMA, so it too needs a mask, at half the k a MMA.
//   * xsum[token, piece] once a stage for the block, by an xsum warp (dp4a
//     on the stage's x8), shared by every column.
//   * The fold acc += s * dot - xsum * z at once after each MMA, s and z
//     widened from the stage's boxes (bf16 by its bits, the 4-bit
//     container's zs offset added back), each half of a tile in its own
//     accumulators, summed at the end.
//   * Two k-slices (4 where there is a block an SM at most); their partials
//     summed in slice order: no atomics, repeated runs bit-equal. The column
//     tile, the slices and the fold order come from N, K, cb, g and the meta
//     type alone, so a row's sums are bit-equal at every M.
// Code or meta rows off the 16-byte rule of a TMA map (1-bit rows at K =
//   4544, 1- and 2-bit rows at K = 96, fp32 meta rows of K/g % 4 != 0
//   columns) go by the plan to `w4a8_dp4a_kernel` on the CUDA cores: one
//   warp per 2 columns and 8 activation rows, each lane a whole group at a
//   time of a K-tile of at least 32 groups and 1024 codes, its fields read
//   from the words they sit in, __dp4a on the unpacked codes, a warp
//   shuffle at the end.
#include <string.h>

#include "sm90_ptx.cuh"

namespace {

using namespace sm90;

// LoRA epilogue operands: xa fp32 [M, r], b fp32 [r, N]; r = 0 for none
struct Lora {
  const float* xa;
  const float* b;
  int r;
};

// scale or zs i, fp32 or bf16 (widened by its bits)
__device__ __forceinline__ float load_meta(const void* p, size_t i, int bf16) {
  return bf16 ? meta_f32(static_cast<const __nv_bfloat16*>(p)[i]) : static_cast<const float*>(p)[i];
}

// the LoRA term of output (row, col): sum_j xa[row, j] * b[j, col] in fp32
__device__ __forceinline__ float lora_term(const Lora& l, int row, int col, int n) {
  float v = 0.f;
  for (int j = 0; j < l.r; ++j)
    v = fmaf(l.xa[static_cast<size_t>(row) * l.r + j], l.b[static_cast<size_t>(j) * n + col], v);
  return v;
}

// ------------------------------------------------- tensor-core route --

constexpr int kConsumers = 8;                    // consumer warps
constexpr int kThreads = 32 * (kConsumers + 1);  // then the producer warp
constexpr int kMagic = 0x4B400000;               // 1.5 * 2^23 as fp32 bits
constexpr float kMagicF = 12582912.f;

__host__ __device__ inline int align_up(int x, int a) { return (x + a - 1) / a * a; }

// Shared-memory carve-up of a block of `rows` weight rows; ops/fused_matmul.py
// `w4a8_smem_bytes` computes the same. First the block's scale and zs for
// the whole of K, loaded once: each [boxes][rows][bc] (bc columns a TMA box,
// bc * size an odd multiple of 16 bytes, so that the 8 rows a warp reads lie
// in 8 different bank groups). Then the ring: a stage is the codes [rows x
// 128 bytes] and x8 in kc/128 boxes of [8*nt tokens x 128 bytes], padded to
// 1024 bytes. After the last stage the ring holds the fp32 partials
// [8 / (rows / 16) k-slices][8*nt][rows + 4]. Then the barriers.
struct TcSmem {
  int zs, ring, x8, stage, bars, total;
};

__host__ __device__ inline TcSmem tc_smem(int kc, int nt, int bc, int boxes, int msize,
                                          int stages, int rows) {
  TcSmem s;
  const int meta = boxes * rows * bc * msize;
  s.zs = meta;
  s.ring = align_up(2 * meta, 1024);
  s.x8 = rows * 128;
  s.stage = align_up(s.x8 + kc / 128 * 128 * 8 * nt, 1024);
  const int ring = stages * s.stage;
  const int part = kConsumers / (rows / 16) * 8 * nt * (rows + 4) * 4;
  s.bars = s.ring + (ring > part ? ring : part);
  s.total = 1024 + s.bars + 16 * stages + 8;  // 1024: to align the base
  return s;
}

struct TcArgs {
  const void* scale;  // for the cp.async of meta rows off the 16-byte rule
  const void* zs;
  const float* sx;
  Lora lora;
  void* out;
  int m, n, k, g, out_dtype, meta_bf16, meta_cols;
  int stages_total, rows, stages, bc, boxes, meta_tma;
};

// D += A . B, m16n8k32, s8 x s8 -> s32
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// the exact fp32 value of an accumulator that started at kMagic
__device__ __forceinline__ float magic_f32(int d) { return __int_as_float(d) - kMagicF; }

// the A fragment of k32 step c of the stage for rows r and r + 8 (r & 7 ==
// gid) in the 128-byte swizzle: a0, a1 the codes 8t .. 8t+3 of row r and
// r + 8, a2, a3 the codes 8t+4 .. 8t+7 (t: threadID_in_group)
template <int CB>
__device__ __forceinline__ void unpack_a(const uint8_t* codes, int r, int c, int t,
                                         uint32_t (&a)[4]) {
  constexpr uint32_t kMask = ((1u << CB) - 1u) * 0x01010101u;
  const int byte = 4 * (c * CB + t * CB / 4);
  const int off = (((byte >> 4) ^ (r & 7)) << 4) + (byte & 15);
  if constexpr (CB == 8) {  // two words: codes 8t .. 8t+3 and 8t+4 .. 8t+7
    const uint2 lo = *reinterpret_cast<const uint2*>(codes + r * 128 + off);
    const uint2 hi = *reinterpret_cast<const uint2*>(codes + (r + 8) * 128 + off);
    a[0] = lo.x, a[1] = hi.x, a[2] = lo.y, a[3] = hi.y;
  } else {
    const int f = (2 * t) % (8 / CB);
    const uint32_t w0 = *reinterpret_cast<const uint32_t*>(codes + r * 128 + off);
    const uint32_t w1 = *reinterpret_cast<const uint32_t*>(codes + (r + 8) * 128 + off);
    a[0] = (w0 >> (CB * f)) & kMask;
    a[1] = (w1 >> (CB * f)) & kMask;
    a[2] = (w0 >> (CB * f + CB)) & kMask;
    a[3] = (w1 >> (CB * f + CB)) & kMask;
  }
}

// One stage of a consumer warp: rows r0 and r0 + 8 of the block, every
// token. F k32 steps chain their MMAs into one exact int32 dot (F divides
// the steps of a group, so they lie in one group), which is then folded with
// the scale and zs of that group: acc += s * dot - xsum * z. Each chain
// starts from 0x4B400000 (1.5 * 2^23 as fp32 bits): a dot of |d| <= 4 * 32 *
// 63 * 128 < 2^22 leaves the fp32 value 12582912 + d, which one subtract
// converts exactly. No chain waits on another. Steps past K
// read the TMA's zero fill (codes, x8 and meta), and fold 0. Meta reads are
// of the block's [boxes][rows][bc] scale and zs: mi the element of row r0's
// group, mc its column in the box.
template <int CB, int NT, int F>
__device__ __forceinline__ void consume_stage(const uint8_t* st, const uint8_t* meta,
                                              const TcSmem& L, const TcArgs& a, int r0, int gid,
                                              int tig, int cig, int mi, int mc, int cpg, float zoff,
                                              float (&acc)[NT][4]) {
  constexpr int kSteps = 32 / CB;
  // chains unrolled: all of a stage's, at most 4 (the 16 and 32 steps of the
  // 2- and 1-bit containers spilled at 32 tokens, fully unrolled)
  constexpr int kUnroll = kSteps / F < 4 ? kSteps / F : 4;
  const uint32_t ones[4] = {0x01010101u, 0x01010101u, 0x01010101u, 0x01010101u};
#pragma unroll kUnroll
  for (int c0 = 0; c0 < kSteps; c0 += F) {
    int d[NT][4], dx[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[j][e] = dx[j][e] = kMagic;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const int c = c0 + f;
      // B: x8 of token 8j + gid, the 8 bytes at 32c + 8t of the stage
      const int xb = 32 * c + 8 * tig;
      uint32_t af[4];
      unpack_a<CB>(st, r0, c, tig, af);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int tok = 8 * j + gid;
        const uint2 v = *reinterpret_cast<const uint2*>(
            st + L.x8 + (xb >> 7) * 1024 * NT + tok * 128 + ((((xb & 127) >> 4) ^ (tok & 7)) << 4) +
            (xb & 15));
        const uint32_t b[2] = {v.x, v.y};
        mma_s8(d[j], af, b);
        mma_s8(dx[j], ones, b);
      }
    }
    // the group's scale and zs: element mi (row r0) and mi + 8 bc (row r0 + 8)
    const int i1 = mi + 8 * a.bc;
    const float s0 = load_meta(meta, mi, a.meta_bf16), s1 = load_meta(meta, i1, a.meta_bf16);
    const float z0 = fmaf(zoff, s0, load_meta(meta + L.zs, mi, a.meta_bf16));
    const float z1 = fmaf(zoff, s1, load_meta(meta + L.zs, i1, a.meta_bf16));
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float x0 = magic_f32(dx[j][0]), x1 = magic_f32(dx[j][1]);
      acc[j][0] = fmaf(-x0, z0, fmaf(s0, magic_f32(d[j][0]), acc[j][0]));
      acc[j][1] = fmaf(-x1, z0, fmaf(s0, magic_f32(d[j][1]), acc[j][1]));
      acc[j][2] = fmaf(-x0, z1, fmaf(s1, magic_f32(d[j][2]), acc[j][2]));
      acc[j][3] = fmaf(-x1, z1, fmaf(s1, magic_f32(d[j][3]), acc[j][3]));
    }
    cig += F;  // the next chain starts a group? then the next column, or the next box
    const bool next = cig == cpg;
    cig = next ? 0 : cig;
    mc += next;
    mi += next;
    const bool wrap = mc == a.bc;
    mc = wrap ? 0 : mc;
    mi += wrap ? (a.rows - 1) * a.bc : 0;
  }
}

// CB: container bits; NT: n8 tiles of tokens (8 * NT >= M)
template <int CB, int NT>
__global__ void __launch_bounds__(kThreads, 1)
    w4a8_mma_kernel(const __grid_constant__ CUtensorMap cmap, const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap smap, const __grid_constant__ CUtensorMap zmap,
                    const TcArgs a) {
  constexpr int kKc = 1024 / CB;  // codes of a stage: a 128-byte row
  constexpr int kBoxes = kKc / 128;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const int msize = a.meta_bf16 ? 2 : 4;
  const int groups = a.rows / 16;          // row groups: the consumers of a stage
  const int slices = kConsumers / groups;  // k-slices: stage i to slice i % slices
  const TcSmem L = tc_smem(kKc, NT, a.bc, a.boxes, msize, a.stages, a.rows);
  const uint32_t full0 = base + L.bars;
  const uint32_t empty0 = full0 + 8 * a.stages;
  const uint32_t meta_bar = empty0 + 8 * a.stages;
  const int n0 = blockIdx.x * a.rows;
  const int n_st = a.stages_total;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    prefetch_map(&cmap);
    prefetch_map(&xmap);
    if (a.meta_tma) prefetch_map(&smap), prefetch_map(&zmap);
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full0 + 8 * s, 1);  // the expect_tx
      mbar_init(empty0 + 8 * s, groups);
    }
    mbar_init(meta_bar, 1);  // the expect_tx of the meta's TMA
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int gid = lane >> 2, tig = lane & 3;
  const int r0 = 16 * (warp % groups) + gid;  // the consumer's rows r0 and r0 + 8 of the block
  const int slice = warp / groups;
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  // ---- the block's scale and zs, and the ring's first stages: by TMA from
  // the producer's lane 0; where meta rows break the 16-byte rule, by 4-byte
  // cp.async from every thread of the block (zeros outside), which waits
  // for its copies before the block's barrier
  const int box_bytes = a.rows * a.bc * msize;
  const int tx = a.rows * 128 + kBoxes * 128 * 8 * NT;
  const int first = n_st < a.stages ? n_st : a.stages;  // slots free from the start
  auto load_stage = [&](int i) {
    const int k0 = i * kKc;
    const uint32_t st = base + L.ring + (i % a.stages) * L.stage;
    const uint32_t full = full0 + 8 * (i % a.stages);
    mbar_expect_tx(full, tx);
    tma_load_2d(st, &cmap, full, k0 / 8 * CB, n0);
#pragma unroll
    for (int b = 0; b < kBoxes; ++b)
      tma_load_2d(st + L.x8 + b * 1024 * NT, &xmap, full, k0 + 128 * b, 0);
  };
  if (warp == kConsumers && lane == 0) {
    if (a.meta_tma) {
      mbar_expect_tx(meta_bar, 2 * a.boxes * box_bytes);
      for (int b = 0; b < a.boxes; ++b) {
        tma_load_2d(base + b * box_bytes, &smap, meta_bar, b * a.bc, n0);
        tma_load_2d(base + L.zs + b * box_bytes, &zmap, meta_bar, b * a.bc, n0);
      }
    }
    for (int i = 0; i < first; ++i) load_stage(i);
  }
  if (!a.meta_tma) {
    const int words = a.bc * msize / 4;  // of a box row
    const size_t row_bytes = static_cast<size_t>(a.meta_cols) * msize;
    for (int e = threadIdx.x; e < a.boxes * a.rows * words; e += kThreads) {
      const int br = e / words, w = e - br * words;  // box row br = b * rows + r
      const int b = br / a.rows, r = br - b * a.rows;
      const int col = b * a.bc * msize + 4 * w;  // byte of the row
      const bool ok = n0 + r < a.n && col < a.meta_cols * msize;
      const size_t src = ok ? (n0 + r) * row_bytes + col : 0;
      cp_async(base + 4 * e, static_cast<const uint8_t*>(a.scale) + src, 4, ok);
      cp_async(base + L.zs + 4 * e, static_cast<const uint8_t*>(a.zs) + src, 4, ok);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  }

  if (warp == kConsumers) {
    // ---- producer: stage i into slot i % stages as slots free up (the
    // ring's first went out above)
    for (int i = first; i < n_st; ++i) {
      mbar_wait(empty0 + 8 * (i % a.stages), ((i / a.stages) & 1) ^ 1);
      if (lane == 0) load_stage(i);
    }
  } else {
    // ---- consumers: warp w takes rows 16 (w % groups) .. + 16 of the
    // stages i with i % slices == w / groups (the ring's slots are a
    // multiple of slices, so a slot always goes to the same warps, which so
    // wait on its phases in order), every token, folding every F steps: 4,
    // 2 or 1, the most that divides a group's steps
    const float zoff = a.meta_bf16 && CB == 4 ? 8.f : 0.f;
    const int cpg = a.g / 32;  // k32 steps of a group
    const int fold = cpg % 4 == 0 ? 4 : cpg % 2 == 0 ? 2 : 1;
    if (a.meta_tma) mbar_wait(meta_bar, 0);
    for (int i = slice; i < n_st; i += slices) {
      const int slot = i % a.stages;
      const int k0 = i * kKc;
      const int gk = k0 / a.g;               // the stage's first group
      const int cig = (k0 - gk * a.g) / 32;  // the first step's place in it
      const int mb = gk / a.bc, mc = gk - mb * a.bc;
      const int mi = (mb * a.rows + r0) * a.bc + mc;
      mbar_wait(full0 + 8 * slot, (i / a.stages) & 1);
      const uint8_t* st = smem + L.ring + slot * L.stage;
      switch (fold) {
        case 4: consume_stage<CB, NT, 4>(st, smem, L, a, r0, gid, tig, cig, mi, mc, cpg, zoff, acc); break;
        case 2: consume_stage<CB, NT, 2>(st, smem, L, a, r0, gid, tig, cig, mi, mc, cpg, zoff, acc); break;
        default: consume_stage<CB, NT, 1>(st, smem, L, a, r0, gid, tig, cig, mi, mc, cpg, zoff, acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * slot);
    }
  }

  // ---- the partials of the k-slices: every stage is consumed, so the ring is free
  __syncwarp();
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem + L.ring);  // [slices][8 * NT tokens][rows + 4]
  const int pitch = a.rows + 4;
  if (warp < kConsumers) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        part[(slice * 8 * NT + 8 * j + 2 * tig + (e & 1)) * pitch + r0 + 8 * (e >> 1)] = acc[j][e];
  }
  __syncthreads();
  // the slices summed in order, times sx, plus the LoRA term, stored
  for (int e = threadIdx.x; e < a.m * a.rows; e += kThreads) {
    const int tok = e / a.rows, r = e - tok * a.rows;
    const int col = n0 + r;
    if (col >= a.n) continue;
    float v = part[tok * pitch + r];
    for (int q = 1; q < slices; ++q) v += part[(q * 8 * NT + tok) * pitch + r];
    const float l = a.lora.r > 0 ? lora_term(a.lora, tok, col, a.n) : 0.f;
    hqq_store(a.out, static_cast<size_t>(tok) * a.n + col, v * a.sx[tok] + l, a.out_dtype);
  }
}

template <int CB, int NT>
int launch_tc(const void* x8, const void* wq, const TcArgs& a, int smem, cudaStream_t stream) {
  auto kernel = w4a8_mma_kernel<CB, NT>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap cmap, xmap, smap, zmap;
  memset(&smap, 0, sizeof(smap));
  memset(&zmap, 0, sizeof(zmap));
  const long row_bytes = static_cast<long>(a.k) / 8 * CB;
  {
    const long dims[2] = {row_bytes, a.n}, strides[1] = {row_bytes};
    const int box[2] = {128, a.rows};
    if (encode_map(&cmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, wq, dims, strides, box,
                   CU_TENSOR_MAP_SWIZZLE_128B) != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  {
    const long dims[2] = {a.k, a.m}, strides[1] = {a.k};
    const int box[2] = {128, 8 * NT};
    if (encode_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, x8, dims, strides, box,
                   CU_TENSOR_MAP_SWIZZLE_128B) != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.meta_tma) {
    const auto type = a.meta_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    const long dims[2] = {a.meta_cols, a.n};
    const long strides[1] = {static_cast<long>(a.meta_cols) * (a.meta_bf16 ? 2 : 4)};
    const int box[2] = {a.bc, a.rows};
    if (encode_map(&smap, type, 2, a.scale, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE) != 0 ||
        encode_map(&zmap, type, 2, a.zs, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE) != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  kernel<<<(a.n + a.rows - 1) / a.rows, kThreads, smem, stream>>>(cmap, xmap, smap, zmap, a);
  return static_cast<int>(cudaGetLastError());
}

template <int CB>
int dispatch_nt(const void* x8, const void* wq, const TcArgs& a, int token_tile, int smem,
                cudaStream_t s) {
  switch (token_tile) {
    case 8: return launch_tc<CB, 1>(x8, wq, a, smem, s);
    case 16: return launch_tc<CB, 2>(x8, wq, a, smem, s);
    case 32: return launch_tc<CB, 4>(x8, wq, a, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ------------------------------------------------- the small-group route --

// HQQ_W4A8_GROUP_VARIANT builds the route without one part of its work, for
// what each costs (wrong results; `chip_smoke.py --time`): 1 the fp32 fold
// (the dots are xor-ed into the accumulators), 2 the MMAs (A xor B in their
// place), 3 scale and zs (neither loaded nor read: 1 and 0.5), 4 every
// consumer's work (the ring's loads alone)
#ifndef HQQ_W4A8_GROUP_VARIANT
#define HQQ_W4A8_GROUP_VARIANT 0
#endif

// Shared-memory carve-up of the small-group route (ops/fused_matmul.py
// `w4a8_group_smem` computes the same). A ring slot is one stage: the codes
// [rows x 128 B]; x8 in kc/128 boxes of [tile tokens x 128 B], each box
// 1024-aligned; scale and zs, each `mboxes` boxes of [rows x 128 B] (32 fp32
// or 64 bf16 columns a box, from the stage's first group rounded down to 16
// bytes); all in the 128-byte TMA swizzle, so the 8 rows a warp reads fall
// in 8 bank groups; then xsum [tile tokens][pitch] fp32, the stage's steps x
// pieces and 16 bytes of padding a token (bank groups again); padded to 1024
// bytes. After the last stage the ring holds the fp32 partials [slices]
// [tile][rows + 4]. Then three barriers a slot: full (the TMA), xsum ready,
// empty.
struct GmSmem {
  int x8, xbox, scale, zs, xs, pitch, stage, bars, total;
};

__host__ __device__ inline GmSmem gm_smem(int kc, int tile, int rows, int mboxes, int pieces,
                                          int slices, int stages) {
  GmSmem s;
  s.x8 = rows * 128;
  s.xbox = 128 * (tile > 8 ? tile : 8);
  s.scale = s.x8 + kc / 128 * s.xbox;
  s.zs = s.scale + mboxes * rows * 128;
  s.xs = s.zs + mboxes * rows * 128;
  s.pitch = kc / 32 * pieces + 4;
  s.stage = align_up(s.xs + tile * s.pitch * 4, 1024);
  const int ring = stages * s.stage;
  const int part = slices * tile * (rows + 4) * 4;
  s.bars = ring > part ? ring : part;
  s.total = 1024 + s.bars + 24 * stages;
  return s;
}

// the groups ("pieces") a k32 step can touch: 4 at g = 8, 2 for other g
// under 32 or off its multiples (a step straddles at most one boundary), 1
// where g % 32 == 0
__host__ __device__ inline int gm_pieces(int g) { return g == 8 ? 4 : g % 32 ? 2 : 1; }

// meta boxes a stage reads, 128 bytes of columns a box: the groups it
// touches (kc/g where g divides kc, else at most (kc - 1)/g + 2), from its
// first group's column rounded down to 16 bytes (a TMA box starts there),
// so up to 16/msize - 1 columns more where a stage's groups are not whole
// 16 bytes
__host__ __device__ inline int gm_meta_boxes(int kc, int g, int msize) {
  const int unit = 16 / msize;
  int cols = kc % g == 0 ? kc / g : (kc - 1) / g + 2;
  if (kc % (g * unit) != 0) cols += unit - 1;
  return (cols * msize + 127) / 128;
}

struct GmArgs {
  const float* sx;
  Lora lora;
  void* out;
  int m, n, k, g, out_dtype, meta_bf16;
  int stages_total, rows, slices, stages, mboxes;
};

// D = A . B + C with every C element `c`, m16n8k32, s8 x s8 -> s32
__device__ __forceinline__ void mma_s8_c(int (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2],
                                         int c) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%10, %10, %10, %10};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "r"(c));
}

// element `col` of row r in [boxes][rows x 128 B], swizzled
__device__ __forceinline__ float gm_meta(const uint8_t* p, int col, int r, int rows, int bf16) {
  const int byte = col << (bf16 ? 1 : 2);
  const int in = byte & 127;
  const uint8_t* q = p + ((byte >> 7) * rows + r) * 128 + (((in >> 4) ^ (r & 7)) << 4) + (in & 15);
  return bf16 ? __uint_as_float(static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(q)) << 16)
              : *reinterpret_cast<const float*>(q);
}

// the byte of columns 4c + 2h, 4c + 2h + 1 (g = 8: groups 2h, 2h + 1 of
// step c) in row 0 of a box group, for rows whose swizzle is sw (r0 and r0
// + 8 share it)
__device__ __forceinline__ int gm_pair_byte(int c, int h, int sw, int rows, int bf16) {
  return bf16 ? (c >> 4) * rows * 128 + ((((c & 15) >> 1) ^ sw) << 4) + (c & 1) * 8 + 4 * h
              : (c >> 3) * rows * 128 + (((c & 7) ^ sw) << 4) + 8 * h;
}

__device__ __forceinline__ void gm_pair(const uint8_t* q, int bf16, float (&v)[2]) {
  if (bf16) {
    const uint32_t t = *reinterpret_cast<const uint32_t*>(q);
    v[0] = __uint_as_float(t << 16), v[1] = __uint_as_float(t & 0xffff0000u);
  } else {
    const float2 t = *reinterpret_cast<const float2*>(q);
    v[0] = t.x, v[1] = t.y;
  }
}

// One stage of a consumer warp: rows r0 and r0 + 8 of the block, every
// token. In a k32 step thread tig holds the codes 8 tig .. 8 tig + 7 (one
// chunk: `unpack_a`), which lie in one group (g % 8 == 0). An n8 tile is 4
// tokens by two halves: B column n holds token n % 4 for the pieces of half
// n / 4 (pieces h*PH .. h*PH + PH - 1, PH = P/2; half 0 alone at P = 1), and
// each of the PH MMAs of a tile gives piece h*PH + pi to column half h by
// zeroing, in B, the chunks of every other piece: the accumulator holds that
// group's exact dot, from kMagic. The fold acc += s * dot - xsum * z follows
// at once, pieces in order, steps in order, each half in its own
// accumulators (thread tig holds half tig / 2, tokens 2 (tig % 2) and + 1),
// with s and z from the stage's boxes and xsum from the xsum warp's table.
// Steps past K are not walked; a step's chunks past K read the TMA's zero
// fill (codes, x8, meta).
template <int CB, int T4, int P>
__device__ __forceinline__ void consume_group_stage(const uint8_t* st, const GmSmem& L,
                                                    const GmArgs& a, int k0, int steps, int r0,
                                                    int gid, int tig, float zoff,
                                                    float (&acc)[T4][4]) {
  constexpr int PH = P > 1 ? P / 2 : 1;  // pieces a half
  if (HQQ_W4A8_GROUP_VARIANT == 4) return;
  const int r1 = r0 + 8;
  const int hd = tig >> 1;               // the accumulators' half
  const int hb = gid >> 2, tb = gid & 3;  // the B column's half and token
  const uint8_t* sm = st + L.scale;
  const uint8_t* zm = st + L.zs;
  const uint8_t* sm0 = sm + r0 * 128;  // row r0 of the first box
  const uint8_t* zm0 = zm + r0 * 128;
  const float* xs = reinterpret_cast<const float*>(st + L.xs);
  const int gk0 = k0 / a.g;
  int off = k0 - gk0 * a.g;  // where the step starts in its group (P < 4)
  // the step's first group, counted from the boxes' first column: the
  // stage's first group rounded down to 16 bytes (0 at g = 8)
  int col = gk0 % (a.meta_bf16 ? 8 : 4);
  // steps unrolled: 2 at one 4-token tile, else none (34.0 against 36.5 us
  // at (8, 4096, 12288), level at 4 tokens; 4 spilled)
  constexpr int kUnroll = T4 > 1 ? 1 : 2;
#pragma unroll kUnroll
  for (int c = 0; c < steps; ++c) {
    uint32_t af[4];
    unpack_a<CB>(st, r0, c, tig, af);
    // the piece of thread tig's chunk; the scale and zs of the accumulators'
    // pieces hd*PH + pi for rows r0, r1
    int mine = 0;
    float s0[PH], s1[PH], z0[PH], z1[PH];
    if constexpr (P == 4) mine = tig;
    if constexpr (P == 2) mine = off + 8 * tig >= a.g;
#if HQQ_W4A8_GROUP_VARIANT == 3
#pragma unroll
    for (int pi = 0; pi < PH; ++pi) s0[pi] = s1[pi] = 1.f, z0[pi] = z1[pi] = 0.5f;
#else
    if constexpr (P == 4) {  // rows r0 and r1 = r0 + 8: 1024 bytes apart, one swizzle
      const int b = gm_pair_byte(c, hd, r0 & 7, a.rows, a.meta_bf16);
      gm_pair(sm0 + b, a.meta_bf16, s0);
      gm_pair(sm0 + 1024 + b, a.meta_bf16, s1);
      gm_pair(zm0 + b, a.meta_bf16, z0);
      gm_pair(zm0 + 1024 + b, a.meta_bf16, z1);
    } else {
      // P = 2: half 1's group, or the first where no chunk reaches it (any
      // finite meta: its dot and xsum are 0); P = 1: the step's group
      const int cm = P == 2 && hd && off + 24 >= a.g ? col + 1 : col;
      s0[0] = gm_meta(sm, cm, r0, a.rows, a.meta_bf16);
      s1[0] = gm_meta(sm, cm, r1, a.rows, a.meta_bf16);
      z0[0] = gm_meta(zm, cm, r0, a.rows, a.meta_bf16);
      z1[0] = gm_meta(zm, cm, r1, a.rows, a.meta_bf16);
    }
#endif
    if (zoff != 0.f) {
#pragma unroll
      for (int pi = 0; pi < PH; ++pi)
        z0[pi] = fmaf(zoff, s0[pi], z0[pi]), z1[pi] = fmaf(zoff, s1[pi], z1[pi]);
    }
    const int xb = 32 * c + 8 * tig;
#pragma unroll
    for (int j = 0; j < T4; ++j) {
      const int tok = 4 * j + tb;
      const uint2 v = *reinterpret_cast<const uint2*>(
          st + L.x8 + (xb >> 7) * L.xbox + tok * 128 + ((((xb & 127) >> 4) ^ (tok & 7)) << 4) +
          (xb & 15));
      // xsum of the accumulators' tokens 4j + 2 (tig % 2) and + 1, pieces hd*PH + pi
      float x0[PH], x1[PH];
      const float* xr = xs + (4 * j + 2 * (tig & 1)) * L.pitch;
      if constexpr (P == 4) {
        const float2 u = *reinterpret_cast<const float2*>(xr + 4 * c + 2 * hd);
        const float2 w = *reinterpret_cast<const float2*>(xr + L.pitch + 4 * c + 2 * hd);
        x0[0] = u.x, x0[1] = u.y, x1[0] = w.x, x1[1] = w.y;
      } else if constexpr (P == 2) {
        x0[0] = xr[2 * c + hd], x1[0] = xr[L.pitch + 2 * c + hd];
      } else {  // half 1 holds no piece
        x0[0] = hd ? 0.f : xr[c], x1[0] = hd ? 0.f : xr[L.pitch + c];
      }
#pragma unroll
      for (int pi = 0; pi < PH; ++pi) {
        const bool keep = P == 1 ? hb == 0 : mine == hb * PH + pi;
        const uint32_t bm[2] = {keep ? v.x : 0u, keep ? v.y : 0u};
        int d[4];
#if HQQ_W4A8_GROUP_VARIANT == 2
#pragma unroll
        for (int e = 0; e < 4; ++e) d[e] = kMagic + static_cast<int>((af[e] ^ bm[e & 1]) & 0xffu);
#else
        mma_s8_c(d, af, bm, kMagic);
#endif
#if HQQ_W4A8_GROUP_VARIANT == 1
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = __int_as_float(__float_as_int(acc[j][e]) ^ d[e]);
#else
        acc[j][0] = fmaf(-x0[pi], z0[pi], fmaf(s0[pi], magic_f32(d[0]), acc[j][0]));
        acc[j][1] = fmaf(-x1[pi], z0[pi], fmaf(s0[pi], magic_f32(d[1]), acc[j][1]));
        acc[j][2] = fmaf(-x0[pi], z1[pi], fmaf(s1[pi], magic_f32(d[2]), acc[j][2]));
        acc[j][3] = fmaf(-x1[pi], z1[pi], fmaf(s1[pi], magic_f32(d[3]), acc[j][3]));
#endif
      }
    }
    if constexpr (P < 4) {  // the next step's place in its group
      off += 32;
      while (off >= a.g) off -= a.g, ++col;
    }
  }
}

// The xsum warp's table for one stage: xsum[tok][c * P + p] of the stage's
// x8 (tokens < m), each 8-code chunk summed by two dp4a and added to its
// piece's sum: exact integers, stored as fp32.
template <int P>
__device__ __forceinline__ void stage_xsum(uint8_t* st, const GmSmem& L, const GmArgs& a, int k0,
                                           int steps, int lane) {
  float* xs = reinterpret_cast<float*>(st + L.xs);
  for (int e = lane; e < a.m * steps; e += 32) {
    const int tok = e / steps, c = e - tok * steps;
    const uint8_t* row = st + L.x8 + (c >> 2) * L.xbox + tok * 128;
    const int ch = (c & 3) * 2;  // the step's first 16-byte chunk of the row
    const uint4 lo = *reinterpret_cast<const uint4*>(row + ((ch ^ (tok & 7)) << 4));
    const uint4 hi = *reinterpret_cast<const uint4*>(row + (((ch + 1) ^ (tok & 7)) << 4));
    constexpr int kOnes = 0x01010101;
    const int q[4] = {__dp4a(static_cast<int>(lo.y), kOnes, __dp4a(static_cast<int>(lo.x), kOnes, 0)),
                      __dp4a(static_cast<int>(lo.w), kOnes, __dp4a(static_cast<int>(lo.z), kOnes, 0)),
                      __dp4a(static_cast<int>(hi.y), kOnes, __dp4a(static_cast<int>(hi.x), kOnes, 0)),
                      __dp4a(static_cast<int>(hi.w), kOnes, __dp4a(static_cast<int>(hi.z), kOnes, 0))};
    float* dst = xs + tok * L.pitch + c * P;
    if constexpr (P == 4) {
      *reinterpret_cast<float4*>(dst) = make_float4(q[0], q[1], q[2], q[3]);
    } else if constexpr (P == 2) {
      const int off = (k0 + 32 * c) % a.g;
      int v0 = 0, v1 = 0;  // the chunks in the step's first group, and in the next
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const bool next = off + 8 * t >= a.g;
        v0 += next ? 0 : q[t];
        v1 += next ? q[t] : 0;
      }
      *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
    } else {
      dst[0] = static_cast<float>(q[0] + q[1] + q[2] + q[3]);
    }
  }
}

// CB: container bits; T4: tiles of 4 tokens (4 * T4 >= M); P: pieces a step
template <int CB, int T4, int P>
__global__ void __launch_bounds__(kThreads + 32, 1)
    w4a8_group_mma_kernel(const __grid_constant__ CUtensorMap cmap,
                          const __grid_constant__ CUtensorMap xmap,
                          const __grid_constant__ CUtensorMap smap,
                          const __grid_constant__ CUtensorMap zmap, const GmArgs a) {
  constexpr int kKc = 1024 / CB;  // codes of a stage: a 128-byte row
  constexpr int kBoxes = kKc / 128;
  constexpr int kTile = 4 * T4;   // tokens
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const int groups = a.rows / 16;            // row groups of a slice
  const int consumers = groups * a.slices;   // then the TMA warp, then the xsum warp
  const GmSmem L = gm_smem(kKc, kTile, a.rows, a.mboxes, P, a.slices, a.stages);
  const uint32_t full0 = base + L.bars;
  const uint32_t ready0 = full0 + 8 * a.stages;
  const uint32_t empty0 = ready0 + 8 * a.stages;
  const int n0 = blockIdx.x * a.rows;
  const int n_st = a.stages_total;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cpb = a.meta_bf16 ? 64 : 32;  // meta columns a box
  auto steps_of = [&](int k0) { return (min(kKc, a.k - k0) + 31) / 32; };

  if (threadIdx.x == 0) {
    prefetch_map(&cmap);
    prefetch_map(&xmap);
    if (HQQ_W4A8_GROUP_VARIANT != 3) prefetch_map(&smap), prefetch_map(&zmap);
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full0 + 8 * s, 1);        // the expect_tx
      mbar_init(ready0 + 8 * s, 32);      // every lane of the xsum warp
      mbar_init(empty0 + 8 * s, groups);  // the consumers of the stage's slice
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == consumers) {
    // ---- the TMA warp: stage i into slot i % stages as slots free up
    const int meta_tx = HQQ_W4A8_GROUP_VARIANT == 3 ? 0 : 2 * a.mboxes * a.rows * 128;
    const int tx = a.rows * 128 + kBoxes * 128 * kTile + meta_tx;
    for (int i = 0; i < n_st; ++i) {
      if (i >= a.stages) mbar_wait(empty0 + 8 * (i % a.stages), ((i / a.stages) & 1) ^ 1);
      if (lane == 0) {
        const int k0 = i * kKc;
        const uint32_t st = base + (i % a.stages) * L.stage;
        const uint32_t full = full0 + 8 * (i % a.stages);
        mbar_expect_tx(full, tx);
        tma_load_2d(st, &cmap, full, k0 / 8 * CB, n0);
#pragma unroll
        for (int b = 0; b < kBoxes; ++b)
          tma_load_2d(st + L.x8 + b * L.xbox, &xmap, full, k0 + 128 * b, 0);
        if (HQQ_W4A8_GROUP_VARIANT != 3) {
          const int gk0 = k0 / a.g / (cpb / 8) * (cpb / 8);  // a box starts on 16 bytes
          for (int b = 0; b < a.mboxes; ++b) {
            tma_load_2d(st + L.scale + b * a.rows * 128, &smap, full, gk0 + b * cpb, n0);
            tma_load_2d(st + L.zs + b * a.rows * 128, &zmap, full, gk0 + b * cpb, n0);
          }
        }
      }
    }
  } else if (warp == consumers + 1) {
    // ---- the xsum warp: each stage's table once it lands, for every column
    for (int i = 0; i < n_st; ++i) {
      const int slot = i % a.stages;
      mbar_wait(full0 + 8 * slot, (i / a.stages) & 1);
      stage_xsum<P>(smem + slot * L.stage, L, a, i * kKc, steps_of(i * kKc), lane);
      __syncwarp();
      mbar_arrive(ready0 + 8 * slot);
    }
  }

  // ---- consumers: warp w takes rows 16 (w % groups) .. + 16 of the stages
  // i with i % slices == w / groups (the ring's slots are a multiple of the
  // slices, so a slot always goes to the same warps)
  const int gid = lane >> 2, tig = lane & 3;
  const int r0 = 16 * (warp % groups) + gid;
  const int slice = warp / groups;
  float acc[T4][4];
#pragma unroll
  for (int j = 0; j < T4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  if (warp < consumers) {
    const float zoff = a.meta_bf16 && CB == 4 ? 8.f : 0.f;
    for (int i = slice; i < n_st; i += a.slices) {
      const int slot = i % a.stages;
      mbar_wait(full0 + 8 * slot, (i / a.stages) & 1);
      mbar_wait(ready0 + 8 * slot, (i / a.stages) & 1);
      consume_group_stage<CB, T4, P>(smem + slot * L.stage, L, a, i * kKc, steps_of(i * kKc), r0,
                                     gid, tig, zoff, acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * slot);
    }
    // the halves of each (row, token): half 0 plus half 1 (one sum, the
    // same bits in either thread)
#pragma unroll
    for (int j = 0; j < T4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += __shfl_xor_sync(0xffffffffu, acc[j][e], 2);
  }

  // ---- the slices' partials: every stage is consumed, so the ring is free
  __syncwarp();
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem);  // [slices][tile tokens][rows + 4]
  const int pitch = a.rows + 4;
  if (warp < consumers && tig < 2) {
#pragma unroll
    for (int j = 0; j < T4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        part[(slice * kTile + 4 * j + 2 * tig + (e & 1)) * pitch + r0 + 8 * (e >> 1)] = acc[j][e];
  }
  __syncthreads();
  // the slices summed in order, times sx, plus the LoRA term, stored
  for (int e = threadIdx.x; e < a.m * a.rows; e += blockDim.x) {
    const int tok = e / a.rows, r = e - tok * a.rows;
    const int col = n0 + r;
    if (col >= a.n) continue;
    float v = part[tok * pitch + r];
    for (int q = 1; q < a.slices; ++q) v += part[(q * kTile + tok) * pitch + r];
    const float l = a.lora.r > 0 ? lora_term(a.lora, tok, col, a.n) : 0.f;
    hqq_store(a.out, static_cast<size_t>(tok) * a.n + col, fmaf(v, a.sx[tok], l), a.out_dtype);
  }
}

template <int CB, int T4, int P>
int launch_group(const void* x8, const void* wq, const void* scale, const void* zs,
                 const GmArgs& a, int smem, cudaStream_t stream) {
  auto kernel = w4a8_group_mma_kernel<CB, T4, P>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap cmap, xmap, smap, zmap;
  const long row_bytes = static_cast<long>(a.k) / 8 * CB;
  {
    const long dims[2] = {row_bytes, a.n}, strides[1] = {row_bytes};
    const int box[2] = {128, a.rows};
    if (encode_map(&cmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, wq, dims, strides, box,
                   CU_TENSOR_MAP_SWIZZLE_128B) != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  {
    const long dims[2] = {a.k, a.m}, strides[1] = {a.k};
    const int box[2] = {128, 4 * T4};
    if (encode_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, x8, dims, strides, box,
                   CU_TENSOR_MAP_SWIZZLE_128B) != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  {
    const auto type = a.meta_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    const int cols = hqq_ax1_meta_cols(a.k / a.g, a.meta_bf16 ? HQQ_BF16 : HQQ_F32);
    const long dims[2] = {cols, a.n};
    const long strides[1] = {static_cast<long>(cols) * (a.meta_bf16 ? 2 : 4)};
    const int box[2] = {a.meta_bf16 ? 64 : 32, a.rows};
    if (encode_map(&smap, type, 2, scale, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B) != 0 ||
        encode_map(&zmap, type, 2, zs, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B) != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = 32 * (a.rows / 16 * a.slices + 2);
  kernel<<<(a.n + a.rows - 1) / a.rows, threads, smem, stream>>>(cmap, xmap, smap, zmap, a);
  return static_cast<int>(cudaGetLastError());
}

template <int CB, int T4>
int group_pieces(const void* x8, const void* wq, const void* scale, const void* zs,
                 const GmArgs& a, int smem, cudaStream_t s) {
  switch (gm_pieces(a.g)) {
    case 4: return launch_group<CB, T4, 4>(x8, wq, scale, zs, a, smem, s);
    case 2: return launch_group<CB, T4, 2>(x8, wq, scale, zs, a, smem, s);
    default: return launch_group<CB, T4, 1>(x8, wq, scale, zs, a, smem, s);
  }
}

template <int CB>
int group_tokens(const void* x8, const void* wq, const void* scale, const void* zs,
                 const GmArgs& a, int token_tile, int smem, cudaStream_t s) {
  switch (token_tile) {
    case 4: return group_pieces<CB, 1>(x8, wq, scale, zs, a, smem, s);
    case 8: return group_pieces<CB, 2>(x8, wq, scale, zs, a, smem, s);
    case 16: return group_pieces<CB, 4>(x8, wq, scale, zs, a, smem, s);
    case 32: return group_pieces<CB, 8>(x8, wq, scale, zs, a, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ------------------------------ the CUDA-core route (rows off the 16-byte rule) --

constexpr int kDpWarps = 8;  // warps per block
constexpr int kDpNcol = 2;   // output columns per warp
constexpr int kDpRows = 8;   // activation rows per block (gridDim.y over M)

// Groups of a K-tile: one a lane, or for groups under 32 codes 32 * (32/g),
// so that a tile holds at least 1024 codes (ops/fused_matmul.py
// `w4a8_dp4a_smem`). Lane l takes the tile's groups l, l + 32, ...: over
// the whole of K still every group of its residue mod 32, in order.
__host__ __device__ inline int dp4a_tile_groups(int g) { return 32 * (g < 32 ? 32 / g : 1); }
// x8's kDpRows rows of a tile, each group's g/4 words and one of padding
// (`w4a8_dp4a_smem`)
__host__ __device__ inline int dp4a_smem(int g) {
  return kDpRows * dp4a_tile_groups(g) * (g / 4 + 1) * 4;
}

// A lane owns a group at a time: its g/4 fields of 4 codes, each in one word
// (4 | g). Where a group is shorter than a word (2-bit g8, 1-bit g8 and g16)
// the lanes of neighbouring groups read the same word, each its own fields;
// so a run of 32/(cb*g) lanes owns whole words. Field q of group grp is
// field f = (k % C) / 4 of word k / C, k = grp*g + 4q, and takes the scale
// and zs of grp. The group's dots and xsum are exact int32 sums; they fold
// into fp32 in group order, then the warp's butterfly: repeated runs are
// bit-equal.
template <int CB>
__global__ void __launch_bounds__(kDpWarps * 32)
    w4a8_dp4a_kernel(const int8_t* __restrict__ x8, const float* __restrict__ sx,
                     const uint32_t* __restrict__ wq, const void* __restrict__ scale,
                     const void* __restrict__ zs, Lora lora, void* __restrict__ out, int m, int n,
                     int k, int group_size, int out_dtype, int meta_bf16, int meta_cols) {
  constexpr int kCodesPerWord = 32 / CB;
  constexpr uint32_t kMask = ((1u << CB) - 1u) * 0x01010101u;
  extern __shared__ int xs_smem[];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int groups = k / group_size;
  const int tile_groups = dp4a_tile_groups(group_size);
  const int xw_per_group = group_size / 4;  // x8 words of a group = its fields
  const int xw_stride = xw_per_group + 1;   // +1: bank spread
  const int row_words = k / kCodesPerWord;
  const int m0 = blockIdx.y * kDpRows;
  const int col0 = (blockIdx.x * kDpWarps + warp) * kDpNcol;
  const int* x32 = reinterpret_cast<const int*>(x8);
  const float zoff = meta_bf16 && CB == 4 ? 8.f : 0.f;

  float acc[kDpRows][kDpNcol];
#pragma unroll
  for (int i = 0; i < kDpRows; ++i)
#pragma unroll
    for (int c = 0; c < kDpNcol; ++c) acc[i][c] = 0.f;

  for (int g0 = 0; g0 < groups; g0 += tile_groups) {
    __syncthreads();  // the previous tile has been consumed
    const int tile_words = kDpRows * tile_groups * xw_per_group;
    for (int idx = threadIdx.x; idx < tile_words; idx += blockDim.x) {
      const int row = idx / (tile_groups * xw_per_group);
      const int rem = idx - row * (tile_groups * xw_per_group);
      const int gl = rem / xw_per_group;
      const int wj = rem - gl * xw_per_group;
      const int grp = g0 + gl;
      int v = 0;
      if (m0 + row < m && grp < groups)
        v = x32[(static_cast<size_t>(m0 + row) * k + static_cast<size_t>(grp) * group_size) / 4 + wj];
      xs_smem[(row * tile_groups + gl) * xw_stride + wj] = v;
    }
    __syncthreads();

    for (int gl = lane; gl < tile_groups; gl += 32) {
      const int grp = g0 + gl;
      if (grp >= groups) break;
      int idot[kDpRows][kDpNcol];
      int xsum[kDpRows];
#pragma unroll
      for (int i = 0; i < kDpRows; ++i) {
        xsum[i] = 0;
#pragma unroll
        for (int c = 0; c < kDpNcol; ++c) idot[i][c] = 0;
      }
      const int* xrow = xs_smem + gl * xw_stride;
      uint32_t wv[kDpNcol];
      for (int q = 0; q < xw_per_group; ++q) {
        const int kq = grp * group_size + 4 * q;  // the field's first code
        const int f = (kq % kCodesPerWord) / 4;
        if (q == 0 || f == 0) {  // the group's first word, or the next one
#pragma unroll
          for (int c = 0; c < kDpNcol; ++c) {
            const int col = col0 + c;
            wv[c] = col < n ? __ldg(wq + static_cast<size_t>(col) * row_words + kq / kCodesPerWord)
                            : 0u;
          }
        }
#pragma unroll
        for (int i = 0; i < kDpRows; ++i) {
          const int xw = xrow[i * tile_groups * xw_stride + q];
          xsum[i] = __dp4a(xw, 0x01010101, xsum[i]);
#pragma unroll
          for (int c = 0; c < kDpNcol; ++c)
            idot[i][c] = __dp4a(static_cast<int>((wv[c] >> (CB * f)) & kMask), xw, idot[i][c]);
        }
      }
#pragma unroll
      for (int c = 0; c < kDpNcol; ++c) {
        const int col = col0 + c;
        if (col < n) {
          const size_t gi = static_cast<size_t>(col) * meta_cols + grp;
          const float s = load_meta(scale, gi, meta_bf16);
          const float z = fmaf(zoff, s, load_meta(zs, gi, meta_bf16));
#pragma unroll
          for (int i = 0; i < kDpRows; ++i)
            acc[i][c] = fmaf(-static_cast<float>(xsum[i]), z,
                             fmaf(s, static_cast<float>(idot[i][c]), acc[i][c]));
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kDpRows; ++i) {
#pragma unroll
    for (int c = 0; c < kDpNcol; ++c) {
      float v = acc[i][c];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      const int row = m0 + i;
      const int col = col0 + c;
      if (lane == 0 && row < m && col < n) {
        const float l = lora.r > 0 ? lora_term(lora, row, col, n) : 0.f;
        hqq_store(out, static_cast<size_t>(row) * n + col, v * sx[row] + l, out_dtype);
      }
    }
  }
}

template <int CB>
int launch_dp4a(const void* x8, const void* sx, const void* wq, const void* scale, const void* zs,
                Lora lora, void* out, int m, int n, int k, int g, int out_dtype, int meta_dtype,
                cudaStream_t stream) {
  auto kernel = w4a8_dp4a_kernel<CB>;
  const int smem = dp4a_smem(g);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int cols = kDpWarps * kDpNcol;
  dim3 grid((n + cols - 1) / cols, (m + kDpRows - 1) / kDpRows);
  kernel<<<grid, kDpWarps * 32, smem, stream>>>(
      static_cast<const int8_t*>(x8), static_cast<const float*>(sx),
      static_cast<const uint32_t*>(wq), scale, zs, lora, out, m, n, k, g, out_dtype,
      meta_dtype == HQQ_BF16, hqq_ax1_meta_cols(k / g, meta_dtype));
  return static_cast<int>(cudaGetLastError());
}

// route: 0 the tensor cores (g % 32 == 0), 2 the small-group route, 1 the
// CUDA cores (rows off the 16-byte rule): the plan's choice by shape;
// token_tile, rows (weight rows of a block), slices (k-slices), stages, bc
// (columns of a meta box; the tensor cores only) and smem: the plan's (smem
// checked against the formula of the route)
int dispatch(const void* x8, const void* sx, const void* wq, const void* scale, const void* zs,
             Lora lora, void* out, int m, int n, int k, int g, int cb, int out_dtype,
             int meta_dtype, int route, int token_tile, int rows, int slices, int stages, int bc,
             int smem, cudaStream_t s) {
  if (meta_dtype != HQQ_F32 && meta_dtype != HQQ_BF16) return static_cast<int>(cudaErrorInvalidValue);
  if (m < 1 || m > 32 || g < 4 || g % 4 != 0 || k % g != 0 || k % (32 / cb) != 0)
    return static_cast<int>(cudaErrorInvalidValue);  // fields of 4 codes, rows of whole words
  if (cb != 1 && cb != 2 && cb != 4 && cb != 8) return static_cast<int>(cudaErrorInvalidValue);
  if (route == 1) {
    if (smem != dp4a_smem(g)) return static_cast<int>(cudaErrorInvalidValue);
#define HQQ_W4A8_DP(CB) \
  return launch_dp4a<CB>(x8, sx, wq, scale, zs, lora, out, m, n, k, g, out_dtype, meta_dtype, s)
    switch (cb) {
      case 1: HQQ_W4A8_DP(1);
      case 2: HQQ_W4A8_DP(2);
      case 4: HQQ_W4A8_DP(4);
      default: HQQ_W4A8_DP(8);
    }
#undef HQQ_W4A8_DP
  }
  const int msize = meta_dtype == HQQ_BF16 ? 2 : 4;
  const int meta_cols = hqq_ax1_meta_cols(k / g, meta_dtype);
  const int kc = 1024 / cb;
  const int total = (k + kc - 1) / kc;
  if (reinterpret_cast<uintptr_t>(x8) % 16 || reinterpret_cast<uintptr_t>(wq) % 16 || k % 16 ||
      (static_cast<long>(k) * cb / 8) % 16 != 0 || token_tile < m || stages < slices ||
      (rows != 16 && rows != 32 && rows != 64 && rows != 128) || slices < 1 ||
      stages % slices != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == 2) {
    // TMA for codes, x8, scale and zs: meta rows and bases on the 16-byte rule
    const int mboxes = gm_meta_boxes(kc, g, msize);
    if (g % 8 != 0 || (static_cast<long>(meta_cols) * msize) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(scale) % 16 || reinterpret_cast<uintptr_t>(zs) % 16 ||
        rows == 128 || (slices != 2 && slices != 4) || rows / 16 * slices > kConsumers ||
        smem != gm_smem(kc, token_tile, rows, mboxes, gm_pieces(g), slices, stages).total)
      return static_cast<int>(cudaErrorInvalidValue);
    GmArgs a;
    a.sx = static_cast<const float*>(sx);
    a.lora = lora;
    a.out = out;
    a.m = m, a.n = n, a.k = k, a.g = g, a.out_dtype = out_dtype;
    a.meta_bf16 = meta_dtype == HQQ_BF16;
    a.stages_total = total;
    a.rows = rows, a.slices = slices, a.stages = stages, a.mboxes = mboxes;
    switch (cb) {
      case 1: return group_tokens<1>(x8, wq, scale, zs, a, token_tile, smem, s);
      case 2: return group_tokens<2>(x8, wq, scale, zs, a, token_tile, smem, s);
      case 4: return group_tokens<4>(x8, wq, scale, zs, a, token_tile, smem, s);
      default: return group_tokens<8>(x8, wq, scale, zs, a, token_tile, smem, s);
    }
  }
  // the meta boxes cover every group a step reads, those past K included
  const int boxes = bc < 1 ? 0 : ((total * kc + g - 1) / g + bc - 1) / bc;
  if (route != 0 || g % 32 != 0 || rows < 32 || slices != kConsumers / (rows / 16) || bc < 1 ||
      bc > 256 ||
      (bc * msize / 16) % 2 != 1 || bc * msize % 16 != 0 ||
      smem != tc_smem(kc, token_tile / 8, bc, boxes, msize, stages, rows).total)
    return static_cast<int>(cudaErrorInvalidValue);
  TcArgs a;
  a.scale = scale, a.zs = zs;
  a.sx = static_cast<const float*>(sx);
  a.lora = lora;
  a.out = out;
  a.m = m, a.n = n, a.k = k, a.g = g, a.out_dtype = out_dtype;
  a.meta_bf16 = meta_dtype == HQQ_BF16;
  a.meta_cols = meta_cols;
  a.stages_total = total;
  a.rows = rows, a.stages = stages, a.bc = bc, a.boxes = boxes;
  // TMA for scale and zs where rows and base meet the 16-byte rule
  a.meta_tma = (static_cast<long>(a.meta_cols) * msize) % 16 == 0 &&
               reinterpret_cast<uintptr_t>(scale) % 16 == 0 && reinterpret_cast<uintptr_t>(zs) % 16 == 0;
  switch (cb) {
    case 1: return dispatch_nt<1>(x8, wq, a, token_tile, smem, s);
    case 2: return dispatch_nt<2>(x8, wq, a, token_tile, smem, s);
    case 4: return dispatch_nt<4>(x8, wq, a, token_tile, smem, s);
    default: return dispatch_nt<8>(x8, wq, a, token_tile, smem, s);
  }
}

}  // namespace

// meta_dtype: HQQ_F32 or HQQ_BF16, the type of scale and zs [N, C]
// (`hqq_ax1_meta_cols`); route .. smem: `w4a8_launch_plan`'s
HQQ_EXPORT int hqq_w4a8_matmul(const void* x8, const void* sx, const void* wq, const void* scale,
                               const void* zs, void* out, int m, int n, int k, int group_size,
                               int cb, int out_dtype, int meta_dtype, int route, int token_tile,
                               int rows, int slices, int stages, int bc, int smem, void* stream) {
  return dispatch(x8, sx, wq, scale, zs, Lora{nullptr, nullptr, 0}, out, m, n, k, group_size, cb,
                  out_dtype, meta_dtype, route, token_tile, rows, slices, stages, bc, smem,
                  static_cast<cudaStream_t>(stream));
}

// xa fp32 [M, r] and lb fp32 [r, N], r >= 1: the LoRA epilogue
HQQ_EXPORT int hqq_w4a8_lora_matmul(const void* x8, const void* sx, const void* wq,
                                    const void* scale, const void* zs, const void* xa,
                                    const void* lb, void* out, int m, int n, int k, int r,
                                    int group_size, int cb, int out_dtype, int meta_dtype,
                                    int route, int token_tile, int rows, int slices,
                                    int stages, int bc, int smem, void* stream) {
  if (r < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Lora lora{static_cast<const float*>(xa), static_cast<const float*>(lb), r};
  return dispatch(x8, sx, wq, scale, zs, lora, out, m, n, k, group_size, cb, out_dtype, meta_dtype,
                  route, token_tile, rows, slices, stages, bc, smem,
                  static_cast<cudaStream_t>(stream));
}

HQQ_EXPORT const char* hqq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
