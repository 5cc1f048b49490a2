# SPDX-License-Identifier: Apache-2.0
"""Fused dequant-matmul kernels for Hopper: their host side.

Mirrors `hqq_tpu.ops.fused_matmul`: the kernel layouts (`KernelQTensor` for
axis=1 weights, `KernelQTensor0` for axis=0), the per-row int8 activation
quantization, and the entry points `quant_matmul_pallas`,
`quant_matmul_pallas_a8`, `quant_matmul_pallas_lora`,
`quant_matmul_pallas_a8_lora` and `dequant_pallas`, whose names and routing
are kept so that a reader finds each counterpart.

The kernel layouts are this card's own (see ``csrc/hqq_common.cuh``): the
codes of W [N, K] stay contiguous along K, 32/cb codes to a 32-bit word.
Axis=1: scale and zs = zero*scale are [N, K/g] in fp32, or in bf16 with the
columns padded to a multiple of 8 (rows of whole 16 bytes, for TMA). Axis=0: the rows stay
in logical order, K is padded to a multiple of 32, and scale and zs are
[N/g, K_pad] in fp32 or bf16; row n reads row n % (N/g) of them. None of
the TPU layouts' padding, row permutation or nibble orders carry over.

Nine kernels, each behind a wrapper with a plain PyTorch twin and a launch
count (``<wrapper>.launches``):

    w4a8_matmul       -> csrc/w4a8_matmul.cu        (M <= 32, int8 activations)
    w4a8_lora_matmul  -> csrc/w4a8_matmul.cu        (the same, + LoRA epilogue)
    quant_matmul      -> csrc/quant_matmul.cu       (any M, bf16/fp16 operands)
    quant_matmul_lora -> csrc/quant_matmul_lora.cu  (the same, + x@A and B inside)
    quant_matmul_ax0  -> csrc/quant_matmul_ax0.cu   (axis=0 weights, any M)
    dequant           -> csrc/dequant.cu            (both layouts)
    dequant_canonical -> csrc/dequant.cu            (a canonical QTensor: the
                                                     canonical QuantLinear's W)
    qmm_fp32          -> csrc/qmm_fp32.cu           (fp32 x: the three matmuls'
                                                     fp32 route, 3xTF32)
    grouped_matmul    -> csrc/grouped_matmul.cu     (a stack of experts'
                                                     4-bit W, x [E, C <= 32, K])

A wrapper runs the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises; nothing falls back.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from ..core.bitpack import FIELD_BITS, PACKING_CONTAINER, VALS_PER_WORD
from ..core.bitpack import unpack as _bitpack_unpack
from ..core.quantize import QTensor, dequantize_plain, resolve_meta, unpack_codes
from . import _build

__all__ = [
    "KernelQTensor",
    "KernelQTensor0",
    "supports_kernel_layout",
    "supports_kernel_layout_ax0",
    "to_kernel_layout",
    "to_kernel_layout_ax0",
    "quantize_activations_int8",
    "quant_matmul_pallas",
    "quant_matmul_pallas_a8",
    "quant_matmul_pallas_lora",
    "quant_matmul_pallas_a8_lora",
    "dequant_pallas",
    "w4a8_matmul",
    "w4a8_lora_matmul",
    "quant_matmul",
    "quant_matmul_lora",
    "quant_matmul_ax0",
    "dequant",
    "w4a8_matmul_plain",
    "w4a8_lora_matmul_plain",
    "quant_matmul_plain",
    "quant_matmul_lora_plain",
    "quant_matmul_ax0_plain",
    "dequant_plain",
    "dequant_canonical",
    "stacked_experts",
    "expert_qtensor",
    "dequant_stacked_plain",
    "grouped_matmul",
    "grouped_matmul_plain",
    "GroupedPlan",
    "grouped_matmul_plan",
    "DequantPlan",
    "dequant_launch_plan",
    "CanonicalPlan",
    "dequant_canonical_plan",
    "qmm_fp32",
    "reset_launch_counts",
    "QmmPlan",
    "qmm_launch_plan",
    "qmm_fp32_launch_plan",
    "W4a8Plan",
    "w4a8_launch_plan",
    "w4a8_smem_bytes",
    "w4a8_dp4a_smem",
    "w4a8_group_smem",
    "ax0_tile_rows",
    "lora_a_kernel_layout",
    "lora_rank_tile",
    "ax1_meta_cols",
]

# nbits (canonical) -> container bits of the kernel layout: 3-bit rides the
# 4-bit container, 1.58-bit the 2-bit one, 6/5-bit the 8-bit one
_KERNEL_CONTAINER_BITS = {8: 8, 6: 8, 5: 8, 4: 4, 3: 4, 2: 2, 1.58: 2, 1: 1}

# largest M that `quant_matmul_pallas_a8` sends to the int8 kernel
A8_MAX_M = 32

# the geometry of the Hopper mainloop (csrc/qmm_sm90.cuh) and of the card
QMM_ROWS = 128  # weight rows of a block
QMM_SLAB = 64  # K of a slab
QMM_TOKEN_TILES = (8, 32, 64, 128, 256)
QMM_MAX_STAGES = 8
# the LoRA kernel: rank chunks (A^T's rows a pass holds) and its largest
# token tile (two consumers of 64 token rows each multiply x by A^T)
QMM_RANK_TILES = (16, 64)
QMM_LORA_MAX_TILE = 128
H100_SMS = 132
H100_SMEM_PER_BLOCK = 232448
# the most tokens for which K is split: the w4a8 backend's decode sizes,
# which reach quant_matmul only from the pallas backend and 8-bit weights
QMM_SPLIT_MAX_M = A8_MAX_M
# the fp32 route (csrc/qmm_fp32.cu): slabs of 32 fp32 (one 128-byte swizzle
# row), token tiles up to 128, the LoRA term in chunks of 8 ranks
QMM_FP32_SLAB = 32
QMM_FP32_TOKEN_TILES = (8, 32, 64, 128)
QMM_FP32_RANK_TILE = 8
# the w4a8 kernel (csrc/w4a8_matmul.cu): eight consumer warps, stages of one
# 128-byte code row each (1024/cb codes), token tiles of 8, 16 or 32, rings
# of at most 8 slots; an SM's shared memory
W4A8_CONSUMERS = 8
W4A8_TOKEN_TILES = (8, 16, 32)
W4A8_MAX_STAGES = 8
H100_SMEM_PER_SM = 233472
# the dequant kernels (csrc/dequant.cu): vectors of 16 output bytes, 4 a lane
# per pass, blocks of 256 threads striding over them (at most 8 an SM, one
# wave); the axis=0 entry's blocks of 128 threads, sliced along the rows of a
# residue class until there are 16 an SM
DEQUANT_THREADS = 256
DEQUANT_ITEMS = 4
DEQUANT_MAX_BLOCKS = 8 * H100_SMS
DEQUANT_AX0_THREADS = 128
DEQUANT_AX0_MIN_BLOCKS = 16 * H100_SMS

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# launches of the w4a8 wrappers (both, with and without the LoRA epilogue) by
# the kernel their plan's route launches: `w4a8_mma_kernel`, the small-group
# `w4a8_group_mma_kernel`, `w4a8_dp4a_kernel`
W4A8_ROUTE_LAUNCHES = {"tensor_cores": 0, "group_mma": 0, "cuda_cores": 0}


@dataclasses.dataclass
class KernelQTensor:
    """Inference-prepared quantized weight in the kernel layout.

      wq:    uint8 [N, K*cb/8]  codes of W [N, K], 32/cb to a 32-bit word
                                (K whole words; a word may span 2 or 4
                                groups, a 4-code field never does)
      scale: [N, C]             dequant scale (multiplicative) of group
                                k // g in column k // g: fp32 with C = K/g,
                                or bf16 with C = K/g padded to a multiple
                                of 8 (`ax1_meta_cols`); the kernels widen
                                bf16 to fp32 for the arithmetic
      zs:    [N, C]             zero * scale (W = c*scale - zs), as scale;
                                bf16 in the 4-bit container stores
                                (zero - 8) * scale (`_ax1_zs_offset`)
    """

    wq: torch.Tensor
    scale: torch.Tensor
    zs: torch.Tensor
    nbits: float = 4
    container_bits: int = 4
    group_size: int = 64
    shape: tuple = ()  # (K, N)
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def k(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def r(self) -> int:
        return 8 // self.container_bits


def supports_kernel_layout(qt: QTensor) -> bool:
    """Whether ``qt`` converts to the kernel layout: `hqq_tpu`'s rule, axis=1
    groups of a multiple of 8 codes that divide K. A group may be shorter
    than a 32-bit word (2-bit g8, 1-bit g8 and g16): each 4-code field of a
    word lies in one group (4 | g) and the kernels read its group's scale
    and zs per field. `to_kernel_layout` refuses a K that is not whole
    words (a departure from `hqq_tpu`, which pads K)."""
    if qt.axis != 1 or not qt.channel_wise or qt.group_size is None:
        return False
    g = qt.group_size
    k = qt.shape[1]
    r = 8 // _KERNEL_CONTAINER_BITS[qt.nbits]
    return k % g == 0 and g % r == 0 and g % 8 == 0


def _pack_words(codes: torch.Tensor, cb: int) -> torch.Tensor:
    """Codes [N, K] -> uint8 [N, K*cb/8] in the word layout of
    ``csrc/hqq_common.cuh``: code k = 4r*w + 4f + b at bit 8b + cb*f of
    word w (r = 8/cb)."""
    n, k = codes.shape
    r = 8 // cb
    c = codes.to(torch.int32).reshape(n, k // (4 * r), r, 4)
    shifts = (torch.arange(r, device=codes.device, dtype=torch.int32) * cb).view(1, 1, r, 1)
    return (c << shifts).sum(dim=2).to(torch.uint8).reshape(n, k * cb // 8)


def _unpack_words(wq: torch.Tensor, cb: int) -> torch.Tensor:
    """Inverse of `_pack_words`: uint8 [N, K*cb/8] -> int32 codes [N, K]."""
    n, nbytes = wq.shape
    r = 8 // cb
    b = wq.to(torch.int32).reshape(n, nbytes // 4, 1, 4)
    shifts = (torch.arange(r, device=wq.device, dtype=torch.int32) * cb).view(1, 1, r, 1)
    return ((b >> shifts) & ((1 << cb) - 1)).reshape(n, nbytes * r)


def ax1_meta_cols(groups: int, meta_dtype: torch.dtype) -> int:
    """Columns of an axis=1 layout's scale and zs for ``groups`` = K/g
    groups: K/g in fp32, padded to a multiple of 8 in bf16
    (`hqq_ax1_meta_cols` of csrc/hqq_common.cuh)."""
    return -(-groups // 8) * 8 if meta_dtype == torch.bfloat16 else groups


def to_kernel_layout(qt: QTensor, meta_dtype=torch.float32) -> KernelQTensor:
    """Convert a canonical axis=1 `QTensor` to the kernel layout, on its
    device (a one-time repack at `prepare_for_inference`). ``meta_dtype``
    (fp32 or bf16) is the storage type of scale and zs, as in `hqq_tpu`:
    zs = zero * scale is formed in fp32 and both are then rounded to it."""
    if not supports_kernel_layout(qt):
        raise ValueError(
            "kernel layout needs axis=1 groups of a multiple of 8 dividing K; "
            f"got axis={qt.axis}, group_size={qt.group_size}, nbits={qt.nbits}, "
            f"shape={qt.shape}"
        )
    cb = _KERNEL_CONTAINER_BITS[qt.nbits]
    if qt.shape[1] % (32 // cb):
        raise ValueError(
            f"kernel layout of {qt.nbits}-bit g{qt.group_size} axis=1 needs K in whole "
            f"32-bit words of {32 // cb} codes; got K={qt.shape[1]} (shape {qt.shape})"
        )
    if meta_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"meta_dtype must be float32 or bfloat16, not {meta_dtype}")
    qt = resolve_meta(qt)
    n_out, k = qt.shape
    g = qt.group_size
    codes = unpack_codes(qt, torch.int32).reshape(n_out, k)
    scale = qt.scale.reshape(n_out, k // g).to(torch.float32)
    zero = qt.zero.reshape(n_out, k // g).to(torch.float32)
    pad = ax1_meta_cols(k // g, meta_dtype) - k // g
    zs = (zero - _ax1_zs_offset(cb, meta_dtype)) * scale
    return KernelQTensor(
        wq=_pack_words(codes, cb),
        scale=F.pad(scale, (0, pad)).to(meta_dtype).contiguous(),
        zs=F.pad(zs, (0, pad)).to(meta_dtype).contiguous(),
        nbits=qt.nbits,
        container_bits=cb,
        group_size=g,
        shape=(k, n_out),
        compute_dtype=qt.compute_dtype,
    )


def _ax1_zs_offset(cb: int, meta_dtype: torch.dtype) -> float:
    """The multiple of scale that an axis=1 layout's stored zs lacks: 8 for
    bf16 meta in the 4-bit container, which stores (zero - 8) * scale as
    `hqq_tpu`'s 4-bit layout does (zero * scale is some 8 steps large, and
    its bf16 rounding would cost a tenth of a step), else 0
    (`hqq_ax1_zs_offset` of csrc/hqq_common.cuh)."""
    return 8.0 if meta_dtype == torch.bfloat16 and cb == 4 else 0.0


def _ax1_meta(kqt: KernelQTensor) -> tuple[torch.Tensor, torch.Tensor]:
    """scale and zs of an axis=1 layout as the kernels read them: fp32
    [N, K/g], the padding cut, the 4-bit bf16 zs given its 8 * scale back."""
    groups = kqt.k // kqt.group_size
    scale = kqt.scale[:, :groups].to(torch.float32)
    zs = kqt.zs[:, :groups].to(torch.float32)
    offset = _ax1_zs_offset(kqt.container_bits, kqt.scale.dtype)
    return scale, (zs + offset * scale if offset else zs)


@dataclasses.dataclass
class KernelQTensor0:
    """Inference-prepared axis=0 quantized weight in the kernel layout. The
    g rows {b, b + P, b + 2P, ...} (P = N/g) form the group of column k, as
    `W.reshape(g, -1)` groups them; rows stay in logical order.

      wq:    uint8 [N, K_pad*cb/8]  codes of W [N, K], 32/cb to a 32-bit
                                    word, K padded with zero codes to a
                                    multiple of 32
      scale: [N/g, K_pad]           dequant scale of (row n % P, column k),
                                    fp32 or bf16, zero past K
      zs:    [N/g, K_pad]           zero * scale (W = c*scale - zs)
    """

    wq: torch.Tensor
    scale: torch.Tensor
    zs: torch.Tensor
    nbits: float = 4
    container_bits: int = 4
    group_size: int = 64
    shape: tuple = ()  # (N, K) logical
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def k(self) -> int:  # in_features
        return self.shape[1]

    @property
    def n(self) -> int:  # out_features
        return self.shape[0]

    @property
    def r(self) -> int:
        return 8 // self.container_bits

    @property
    def k_pad(self) -> int:
        return self.scale.shape[1]


def supports_kernel_layout_ax0(qt: QTensor) -> bool:
    """Whether an axis=0 ``qt`` converts to the kernel layout: groups of a
    multiple of 8 rows that divide N (`hqq_tpu`'s rule; the word layout
    along K asks for nothing more, K is padded)."""
    if qt.axis != 0 or not qt.channel_wise or qt.group_size is None:
        return False
    g = qt.group_size
    r = 8 // _KERNEL_CONTAINER_BITS[qt.nbits]
    return qt.shape[0] % g == 0 and g % r == 0 and g % 8 == 0


def to_kernel_layout_ax0(qt: QTensor, meta_dtype=torch.float32) -> KernelQTensor0:
    """Convert a canonical axis=0 `QTensor` to the kernel layout, on its
    device. ``meta_dtype`` (fp32 or bf16) is the storage type of scale and
    zs; the kernels widen them to fp32 for the arithmetic. The serving
    backends pick it per config (`backends.pallas_backend._ax0_meta_dtype`);
    the default here is exact."""
    if not supports_kernel_layout_ax0(qt):
        raise ValueError(
            "axis=0 kernel layout needs groups of a multiple of 8 rows dividing "
            f"out_features; got axis={qt.axis}, group_size={qt.group_size}, shape={qt.shape}"
        )
    if meta_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"meta_dtype must be float32 or bfloat16, not {meta_dtype}")
    qt = resolve_meta(qt)
    n_out, k = qt.shape
    g = qt.group_size
    cb = _KERNEL_CONTAINER_BITS[qt.nbits]
    p_blocks = n_out // g
    # group space is [g, P*K] with codes[a, b*K + k] = W_q[a*P + b, k]: read
    # row-major it is W_q [N, K] itself
    codes = unpack_codes(qt, torch.int32).reshape(n_out, k)
    scale = qt.scale.reshape(p_blocks, k).to(torch.float32)
    zero = qt.zero.reshape(p_blocks, k).to(torch.float32)
    pad = -k % 32
    if pad:
        codes, scale, zero = (F.pad(t, (0, pad)) for t in (codes, scale, zero))
    return KernelQTensor0(
        wq=_pack_words(codes, cb),
        scale=scale.to(meta_dtype).contiguous(),
        zs=(zero * scale).to(meta_dtype).contiguous(),
        nbits=qt.nbits,
        container_bits=cb,
        group_size=g,
        shape=(n_out, k),
        compute_dtype=qt.compute_dtype,
    )


# ---------------------------------------------------------------------------
# Kernel wrappers and their plain versions
# ---------------------------------------------------------------------------


def _on_cpu(t: torch.Tensor) -> bool:
    """True for a CPU tensor (plain version), False for a CUDA one (kernel)."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise RuntimeError(f"no kernel for tensors on {t.device}")
    return False


def _check_kqt(kqt: KernelQTensor, device: torch.device) -> None:
    k, n = kqt.shape
    g = kqt.group_size
    if kqt.wq.dtype != torch.uint8 or tuple(kqt.wq.shape) != (n, k * kqt.container_bits // 8):
        raise ValueError(f"wq must be uint8 [{n}, {k * kqt.container_bits // 8}]")
    for name in ("scale", "zs"):
        t = getattr(kqt, name)
        if t.dtype != kqt.scale.dtype or t.dtype not in (torch.float32, torch.bfloat16) \
                or tuple(t.shape) != (n, ax1_meta_cols(k // g, t.dtype)):
            raise ValueError(f"{name} must be fp32 [{n}, {k // g}] or bf16 "
                             f"[{n}, {ax1_meta_cols(k // g, torch.bfloat16)}]")
    for t in (kqt.wq, kqt.scale, kqt.zs):
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"kernel operands must be contiguous on {device}")


def _check_kqt0(kqt: KernelQTensor0, device: torch.device) -> None:
    n, k = kqt.shape
    k_pad = kqt.k_pad
    if k_pad % 32 or k_pad < k:
        raise ValueError(f"scale must be padded along K to a multiple of 32 >= {k}")
    if kqt.wq.dtype != torch.uint8 or tuple(kqt.wq.shape) != (n, k_pad * kqt.container_bits // 8):
        raise ValueError(f"wq must be uint8 [{n}, {k_pad * kqt.container_bits // 8}]")
    for name in ("scale", "zs"):
        t = getattr(kqt, name)
        if t.dtype != kqt.scale.dtype or t.dtype not in (torch.float32, torch.bfloat16) \
                or tuple(t.shape) != (n // kqt.group_size, k_pad):
            raise ValueError(f"{name} must be fp32 or bf16 [{n // kqt.group_size}, {k_pad}]")
    for t in (kqt.wq, kqt.scale, kqt.zs):
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"kernel operands must be contiguous on {device}")


def _ptr(t: torch.Tensor, align: int = 16) -> int:
    p = t.data_ptr()
    if p % align:
        raise ValueError(f"kernel operand not {align}-byte aligned")
    return p


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


@dataclasses.dataclass(frozen=True)
class QmmPlan:
    """How `quant_matmul`, `quant_matmul_ax0` and `quant_matmul_lora`
    launch: a block per (128 weight rows, ``token_tile`` tokens, K split),
    ``stages`` slots in the pipeline, ``smem`` bytes of dynamic shared
    memory; the LoRA kernel walks K ``passes`` times, ``rank_tile`` ranks
    at a time (0 without an adapter)."""

    token_tile: int
    stages: int
    splits: int
    slabs_per_split: int
    grid: tuple  # (weight-row tiles, token tiles, splits)
    smem: int
    rank_tile: int = 0
    passes: int = 1


def ax0_tile_rows(group_size: int) -> tuple[int, int]:
    """(b rows, a rows) of a 128-row axis=0 tile (`ax0_params` of
    csrc/qmm_sm90.cuh): 8 consecutive b by 16 consecutive a of the weight
    rows n = a*P + b, 16 b by 8 a at g = 8; tile row r = a_l * b_rows + b_l."""
    b_rows = 16 if group_size < 16 else 8
    return b_rows, QMM_ROWS // b_rows


def _row_tiles(n: int, group_size: int, axis: int) -> int:
    """Blocks along the weight rows: 128 rows each (axis=0: b tiles times a
    tiles, the last of each possibly part empty)."""
    if axis == 1:
        return -(-n // QMM_ROWS)
    b_rows, a_rows = ax0_tile_rows(group_size)
    return -(-(n // group_size) // b_rows) * -(-group_size // a_rows)


def _slab_meta_bytes(group_size: int, axis: int, meta_size: int, slab: int = QMM_SLAB) -> int:
    """Bytes of scale and zs that one slot of the pipeline holds, for slabs
    of ``slab`` columns (64; 32 on the fp32 route)."""
    g = group_size
    if axis == 1:  # 128 rows of the groups under a slab (at least 16 bytes)
        tiles = slab % g == 0 or g % slab == 0
        # where a slab can start mid-group, bf16's first group is aligned
        # down to 4 bytes: one group more
        groups = (1 if g % slab == 0 else slab // g if tiles
                  else (slab - 1) // g + 2 + 4 // meta_size - 1)
        return 2 * QMM_ROWS * max(16 // meta_size, groups) * meta_size
    # axis=0: the slab's columns of the tile's b rows of [P, K_pad]
    return 2 * ax0_tile_rows(g)[0] * slab * meta_size


def qmm_smem_bytes(token_tile: int, stages: int, code_stage: int, meta_stage: int,
                   rank_tile: int = 0) -> int:
    """Dynamic shared memory of one block (`smem_layout` of qmm_sm90.cuh):
    the x slots, each consumer's two A tiles (or its epilogue staging), the
    LoRA kernel's A^T slots and its fp32 partial p, the code and meta slots,
    the barriers, and 1024 bytes to align the base."""
    per_wg = max(2 * 64 * QMM_SLAB * 2, token_tile * 128)
    return (stages * token_tile * 128 + 2 * per_wg + stages * rank_tile * 128
            + token_tile * rank_tile * 4 + stages * (code_stage + meta_stage) + 16 * stages + 1024)


def _ring(smem_of, what: str) -> int:
    """The slots of a pipeline ring: as many as one block's shared memory
    holds, at most ``QMM_MAX_STAGES``; ``smem_of(stages)`` is the block's
    bytes. Raises where two do not fit."""
    fixed = smem_of(0)
    stages = min(QMM_MAX_STAGES, (H100_SMEM_PER_BLOCK - fixed) // (smem_of(1) - fixed))
    if stages < 2:
        raise ValueError(f"no two pipeline stages fit for {what}")
    return stages


def _k_splits(m: int, blocks: int, slabs: int) -> tuple[int, int]:
    """(splits, slabs per split) of K over gridDim.z for ``blocks`` blocks
    of ``slabs`` slabs each: up to ``QMM_SPLIT_MAX_M`` tokens, where the
    card has fewer blocks than SMs, the split with the fewest waves of
    blocks times slabs per block (plus two for a block's fill and epilogue),
    the fewer splits on a tie; above it, none."""
    if m > QMM_SPLIT_MAX_M or blocks >= H100_SMS:
        return 1, slabs
    options = []
    for s in range(1, slabs + 1):
        sps = -(-slabs // s)
        eff = -(-slabs // sps)  # no empty split
        options.append((-(-blocks * eff // H100_SMS) * (sps + 2), eff, sps))
    _, splits, per_split = min(options)
    return splits, per_split


@functools.lru_cache(maxsize=4096)
def qmm_launch_plan(m: int, n: int, k: int, cb: int, group_size: int, axis: int = 1,
                    meta_size: int = 4, rank: int = 0) -> QmmPlan:
    """The launch of the Hopper dequant-matmul for x [m, k] and a weight of
    n rows (k = K_pad for axis=0; meta_size = 4 or 2 bytes of its scale),
    with a LoRA adapter of ``rank`` ranks or none.

    Token tile: the least of 8, 32, 64 that holds m tokens; above 64, 128 or
    256, whichever takes fewer waves of blocks times the tile (a block's
    time grows with its tile), the larger one on a tie. Up to
    ``QMM_SPLIT_MAX_M`` tokens the card has only n/128 blocks to run, so K
    is split over gridDim.z: the split with the fewest waves of blocks
    times slabs per block (plus two for a block's fill and epilogue), the
    fewer splits on a tie. One wave of 128 blocks beats two of 256 there
    (H100 80GB HBM3, 700 W: 0.0184 against 0.0208 ms at M=4, K=N=4096).
    Above it K is never split, so that a row of y does not depend on how
    many rows go with it (chunked prefill gives the logits of a whole one).
    Stages: as many slots as shared memory holds, at most 8. With an
    adapter: the rank in chunks of 16 (r <= 16) or 64, one walk over K per
    chunk, and token tiles up to 128 (a consumer then holds 64 base and at
    most 32 adapter accumulators). Cached: every decode step asks again for
    the same shapes."""
    slabs = -(-k // QMM_SLAB)
    row_tiles = _row_tiles(n, group_size, axis)
    rank_tile = lora_rank_tile(rank) if rank else 0
    if m <= 64:
        tile = next(t for t in QMM_TOKEN_TILES if t >= m)
    elif rank:
        tile = QMM_LORA_MAX_TILE
    else:
        tile = min((128, 256),
                   key=lambda t: (-(-row_tiles * -(-m // t) // H100_SMS) * t, -t))
    splits, per_split = _k_splits(m, row_tiles * -(-m // tile), slabs)
    code_stage = QMM_ROWS * 8 * cb
    meta_stage = _slab_meta_bytes(group_size, axis, meta_size)
    stages = _ring(lambda s: qmm_smem_bytes(tile, s, code_stage, meta_stage, rank_tile),
                   f"tile {tile}, cb {cb}, g {group_size}")
    return QmmPlan(token_tile=tile, stages=stages, splits=splits, slabs_per_split=per_split,
                   grid=(row_tiles, -(-m // tile), splits),
                   smem=qmm_smem_bytes(tile, stages, code_stage, meta_stage, rank_tile),
                   rank_tile=rank_tile, passes=-(-rank // rank_tile) if rank else 1)


def qmm_fp32_smem_bytes(token_tile: int, stages: int, code_stage: int, meta_stage: int,
                        lora: bool = False) -> int:
    """Dynamic shared memory of one block of the fp32 route (`fp32_smem`
    of csrc/qmm_fp32.cu): per slot x's slab (split in place into its TF32
    big part) and its small part, each consumer's two pairs of 64 x 32 fp32
    tiles (W_big, W_small), with an adapter A's [32 x 8] slab per slot and
    p [token_tile x 8], the code and meta slots, the barriers, and 1024
    bytes to align the base."""
    lora_bytes = stages * QMM_FP32_SLAB * QMM_FP32_RANK_TILE * 4 \
        + token_tile * QMM_FP32_RANK_TILE * 4 if lora else 0
    return (2 * stages * token_tile * 128 + 2 * 2 * 2 * 64 * QMM_FP32_SLAB * 4 + lora_bytes
            + stages * (code_stage + meta_stage) + 16 * stages + 1024)


@functools.lru_cache(maxsize=4096)
def qmm_fp32_launch_plan(m: int, n: int, k: int, cb: int, group_size: int, axis: int = 1,
                         meta_size: int = 4, rank: int = 0) -> QmmPlan:
    """The launch of the fp32 route (csrc/qmm_fp32.cu) for x [m, k] and a
    weight of n rows (k = K_pad for axis=0; meta_size = 4 or 2 bytes of its
    scale), with a LoRA adapter of ``rank`` ranks (axis=1) or none.

    Slabs of 32 columns. Token tile: the least of 8, 32, 64, 128 that holds
    m tokens, else 128 (a 256-token tile would leave two slots of its ring
    in shared memory). K is split as `qmm_launch_plan` splits it: only up to
    ``QMM_SPLIT_MAX_M`` tokens, so that a row of y does not depend on how
    many rows go with it above that. Stages: as many slots as shared memory
    holds, at most 8. With an adapter, one more walk over K per 8 ranks
    after the base's (``passes`` of them)."""
    slabs = -(-k // QMM_FP32_SLAB)
    row_tiles = _row_tiles(n, group_size, axis)
    tile = next((t for t in QMM_FP32_TOKEN_TILES if t >= m), QMM_FP32_TOKEN_TILES[-1])
    splits, per_split = _k_splits(m, row_tiles * -(-m // tile), slabs)
    code_stage = QMM_ROWS * QMM_FP32_SLAB // 8 * cb
    meta_stage = _slab_meta_bytes(group_size, axis, meta_size, QMM_FP32_SLAB)
    lora = rank > 0
    stages = _ring(lambda s: qmm_fp32_smem_bytes(tile, s, code_stage, meta_stage, lora),
                   f"the fp32 route's tile {tile}, cb {cb}, g {group_size}")
    return QmmPlan(token_tile=tile, stages=stages, splits=splits, slabs_per_split=per_split,
                   grid=(row_tiles, -(-m // tile), splits),
                   smem=qmm_fp32_smem_bytes(tile, stages, code_stage, meta_stage, lora),
                   rank_tile=QMM_FP32_RANK_TILE if lora else 0,
                   passes=-(-rank // QMM_FP32_RANK_TILE) if lora else 1)


@dataclasses.dataclass(frozen=True)
class W4a8Plan:
    """How `w4a8_matmul` and `w4a8_lora_matmul` launch.

    ``route`` "tensor_cores" (g % 32 == 0): a block per ``col_tile`` weight
    rows (grid (column tiles,)), which first loads its scale and zs for the
    whole of K (``meta_boxes`` TMA boxes of ``meta_cols`` columns each), then
    walks all ``stages_total`` stages of ``stage_codes`` codes through a ring
    of ``stages`` slots; its eight consumer warps are col_tile/16 row groups
    by ``k_slices`` slices, stage i going to slice i % k_slices; ``smem``
    bytes. "group_mma" (the small-group route: groups that are not whole
    k32 steps, or meta too large for a block): the same grid, ring and
    slices, each stage carrying its own scale and zs (``meta_boxes`` boxes
    of ``meta_cols`` columns a stage) and each step's groups kept apart by
    their own MMAs; col_tile and k_slices depend on N, K, cb, g and the
    meta type alone, so a row's sums take one order at every M. "cuda_cores":
    the CUDA-core kernel for code or meta rows off the 16-byte rule of a
    TMA map, blocks of 16 columns by 8 rows of x8 (grid (column tiles, row
    tiles)); the stage fields are 0. ``meta_tma``: scale and zs by TMA
    (rows of whole 16 bytes; else 4-byte cp.async by every thread of the
    block). ``why`` says why the route was taken, or why the grid leaves
    SMs idle."""

    route: str
    token_tile: int
    col_tile: int
    stage_codes: int
    stages_total: int
    k_slices: int
    stages: int
    meta_cols: int
    meta_boxes: int
    smem: int
    grid: tuple
    meta_tma: bool = False
    why: str = ""

    @property
    def route_code(self) -> int:
        return {"tensor_cores": 0, "cuda_cores": 1, "group_mma": 2}[self.route]


def _w4a8_meta_box(groups: int, meta_size: int) -> tuple[int, int]:
    """(columns of a meta TMA box, boxes) that hold ``groups`` groups: the
    least width whose bytes are an odd multiple of 16 (the 8 rows a warp
    reads then fall in 8 different bank groups) and at most 256 columns,
    as many boxes as that takes."""
    unit = 16 // meta_size
    if groups <= 256 - unit:
        bc = -(-groups // unit) * unit
        bc += unit * (1 - bc // unit % 2)
    else:
        bc = 256 - unit if (256 - unit) // unit % 2 else 256 - 2 * unit
    return bc, -(-groups // bc)


def w4a8_smem_bytes(stage_codes: int, token_tile: int, meta_box: int, meta_boxes: int,
                    meta_size: int, stages: int, rows: int) -> int:
    """Dynamic shared memory of one block of the w4a8 kernel (`tc_smem` of
    csrc/w4a8_matmul.cu): the block's scale and zs [meta_boxes][rows]
    [meta_box] each; the ring of ``stages`` slots, each the codes [rows x
    128 bytes] and x8 in boxes of [token_tile x 128 bytes], padded to 1024
    bytes, which after the last stage holds the fp32 partials of the
    k-slices [slices x token_tile x (rows + 4)]; the barriers; 1024 bytes to
    align the base."""
    meta = -(-2 * meta_boxes * rows * meta_box * meta_size // 1024) * 1024
    stage = -(-(rows * 128 + stage_codes // 128 * 128 * token_tile) // 1024) * 1024
    part = W4A8_CONSUMERS // (rows // 16) * token_tile * (rows + 4) * 4
    return 1024 + meta + max(stages * stage, part) + 16 * stages + 8


def w4a8_dp4a_smem(group_size: int) -> int:
    """Shared memory of a block of the CUDA-core route (`dp4a_smem` of
    csrc/w4a8_matmul.cu): x8's 8 rows of a K-tile, each group's g/4 words
    and one of padding (bank spread). A tile is 32 groups, one a lane, or
    for groups under 32 codes 32 * (32 // g), so that it holds at least 1024
    codes; lane l takes its groups l, l + 32, ... (2-bit g8: 128 groups,
    each pair of lanes one word)."""
    tile_groups = 32 * max(1, 32 // group_size)
    return 8 * tile_groups * (group_size // 4 + 1) * 4


def w4a8_group_pieces(group_size: int) -> int:
    """The MMAs of a k32 step on the small-group route (`gm_pieces`): the
    groups a step can touch, 4 at g = 8, 2 for other g off the multiples of
    32 (a step straddles at most one boundary), 1 where g % 32 == 0."""
    return 4 if group_size == 8 else 2 if group_size % 32 else 1


def w4a8_group_meta_boxes(stage_codes: int, group_size: int, meta_size: int) -> int:
    """Meta boxes of 128 bytes a row that hold the groups one stage touches
    (`gm_meta_boxes`): stage_codes/g where g divides a stage, else at most
    (stage_codes - 1)/g + 2, counted from the first group's column rounded
    down to 16 bytes (where a TMA box may start): 16/meta_size - 1 more
    where a stage's groups are not whole 16 bytes."""
    g = group_size
    unit = 16 // meta_size
    cols = stage_codes // g if stage_codes % g == 0 else (stage_codes - 1) // g + 2
    if stage_codes % (g * unit):
        cols += unit - 1
    return -(-cols * meta_size // 128)


def w4a8_group_smem(stage_codes: int, token_tile: int, rows: int, meta_boxes: int, pieces: int,
                    slices: int, stages: int) -> int:
    """Dynamic shared memory of one block of the small-group route (`gm_smem`
    of csrc/w4a8_matmul.cu): a ring slot holds the codes [rows x 128 bytes],
    x8 in boxes of [token_tile x 128 bytes] (1024 bytes at least), scale and
    zs ``meta_boxes`` boxes of [rows x 128 bytes] each, and the xsum table
    [token_tile][steps x pieces + 4] fp32, padded to 1024 bytes; after the
    last stage the ring holds the fp32 partials [slices x token_tile x (rows
    + 4)]; three barriers a slot; 1024 bytes to align the base."""
    stage = (rows * 128 + stage_codes // 128 * 128 * max(token_tile, 8)
             + 2 * meta_boxes * rows * 128 + token_tile * (stage_codes // 32 * pieces + 4) * 4)
    stage = -(-stage // 1024) * 1024
    part = slices * token_tile * (rows + 4) * 4
    return 1024 + max(stages * stage, part) + 24 * stages


# the small-group route: tiles of 4 tokens (an n8 MMA tile holds 4 tokens by
# two halves of a step's groups); (column tile, k-slices) a block
W4A8_GROUP_TOKEN_TILES = (4, 8, 16, 32)
W4A8_GROUP_TILES = ((64, 2), (32, 2), (32, 4))


def _w4a8_group_plan(m: int, n: int, k: int, cb: int, g: int, meta_size: int,
                     why: str) -> W4a8Plan:
    """The small-group route's launch (`w4a8_launch_plan`)."""
    tile = next(t for t in W4A8_GROUP_TOKEN_TILES if t >= m)
    kc = 1024 // cb
    total = -(-k // kc)
    pieces = w4a8_group_pieces(g)
    boxes = w4a8_group_meta_boxes(kc, g, meta_size)

    def smem(rows, slices, stages, token_tile=tile):
        return w4a8_group_smem(kc, token_tile, rows, boxes, pieces, slices, stages)

    # column tile and k-slices from N, K, cb, g and the meta type alone: a
    # ring of the 32-token tile must fit, whatever M is. Rows: the fewest an
    # SM must take (its blocks, rounded up, times their rows), then the
    # larger tile. Slices: 4 (eight consumer warps) where the blocks leave an
    # SM one at most, else 2, so that more blocks share an SM (chip_smoke.py
    # `--time ... tile-R-S,ring-S` readings)
    fits = [o for o in W4A8_GROUP_TILES if smem(*o, o[1], token_tile=32) <= H100_SMEM_PER_BLOCK]
    if not fits:
        raise ValueError(f"no ring of the small-group w4a8 kernel fits for cb {cb}, g {g}")
    def blocks_of(r):
        return -(-n // r)

    rows = min((o[0] for o in fits), key=lambda r: (-(-blocks_of(r) // H100_SMS) * r, -r))
    few = blocks_of(rows) <= H100_SMS
    rows, slices = next((o for o in fits if o[0] == rows and (o[1] == 4) == few),
                        next(o for o in fits if o[0] == rows))
    blocks = blocks_of(rows)
    resident = min(4, max(1, -(-blocks // H100_SMS)))  # blocks an SM holds at once
    budget = H100_SMEM_PER_SM // resident - 1024
    stages = min(W4A8_MAX_STAGES, -(-total // slices) * slices)
    while stages > slices and smem(rows, slices, stages) > budget:
        stages -= slices
    if blocks < H100_SMS:
        why += f"; {blocks} blocks of {rows} rows: N = {n} has no more"
    return W4a8Plan(route="group_mma", token_tile=tile, col_tile=rows, stage_codes=kc,
                    stages_total=total, k_slices=slices, stages=stages,
                    meta_cols=128 // meta_size, meta_boxes=boxes,
                    smem=smem(rows, slices, stages), grid=(blocks,), meta_tma=True, why=why)


@functools.lru_cache(maxsize=4096)
def w4a8_launch_plan(m: int, n: int, k: int, cb: int, group_size: int,
                     meta_dtype: torch.dtype = torch.float32) -> W4a8Plan:
    """The launch of the w4a8 kernel for x8 [m, k] (m <= 32) and a weight of
    n rows in ``cb``-bit containers with groups of ``group_size``.

    Route, by shape, before any launch: the tensor cores where a group is
    whole k32 steps (g % 32 == 0), the code rows meet a TMA map's 16-byte
    rule (k * cb / 8 % 16 == 0) and a block's scale and zs for the whole of
    K fit its shared memory beside the shortest ring; else the small-group
    route (g = 8, 16, 24, ..., groups shorter than a word among them (2-bit
    g8, 1-bit g8 and g16), and meta too large for a block, such as 1-bit
    g32 at K = 11008 and 32 tokens), where code and meta rows meet the
    16-byte rule; else the CUDA cores (1-bit rows at K = 4544, 1- and 2-bit
    rows at K = 96, fp32 meta rows of K/g % 4 != 0 columns).

    Tensor cores: token tile 8, 16 or 32, the least that holds m; stages of
    1024/cb codes (one 128-byte code row). Blocks of 64 weight rows, or 32
    where that leaves fewer blocks than SMs; at the 32-token tile 128, 64
    or 32, the most that keeps 0.6 blocks per SM (x8 is read from L2 once
    per block, at 32 tokens and 32 rows twice the codes' bytes). The ring: the deepest multiple of the
    k-slices up to 8 that fits the shared memory of the blocks an SM holds
    at once. The small-group route: token tiles of 4, 8, 16 or 32, the
    same stages and ring rule; blocks of 64 or 32 rows, whichever leaves an
    SM the fewest rows, with 4 k-slices where there is a block an SM at
    most and 2 otherwise, of those whose ring fits at the 32-token tile."""
    g = group_size
    meta_size = 2 if meta_dtype == torch.bfloat16 else 4

    def small(why):
        return W4a8Plan(route="cuda_cores", token_tile=8, col_tile=16, stage_codes=0,
                        stages_total=0, k_slices=0, stages=0, meta_cols=0, meta_boxes=0,
                        smem=w4a8_dp4a_smem(g), grid=(-(-n // 16), -(-m // 8)), why=why)

    if k * cb // 8 % 16:
        return small(f"code rows of {k * cb // 8} bytes break the 16-byte rule of a TMA map")
    meta_row = ax1_meta_cols(k // g, meta_dtype) * meta_size
    if g % 32:
        if meta_row % 16:
            return small(f"meta rows of {meta_row} bytes break the 16-byte rule of a TMA map")
        return _w4a8_group_plan(m, n, k, cb, g, meta_size, f"g = {g} is not a multiple of 32 codes")
    tile = next(t for t in W4A8_TOKEN_TILES if t >= m)
    kc = 1024 // cb
    total = -(-k // kc)
    bc, boxes = _w4a8_meta_box(-(-total * kc // g), meta_size)

    def smem(rows, stages):
        return w4a8_smem_bytes(kc, tile, bc, boxes, meta_size, stages, rows)

    least = H100_SMS if tile <= 16 else 0.6 * H100_SMS
    options = (64, 32) if tile <= 16 else (128, 64, 32)
    fits = [r for r in options if smem(r, W4A8_CONSUMERS // (r // 16)) <= H100_SMEM_PER_BLOCK]
    if not fits:
        why = f"a block's scale and zs ({boxes} x {bc} columns) leave no room for a ring"
        if meta_row % 16:
            return small(why + f", and meta rows of {meta_row} bytes break the 16-byte rule")
        return _w4a8_group_plan(m, n, k, cb, g, meta_size, why)
    rows = next((r for r in fits if -(-n // r) >= least), fits[-1])
    slices = W4A8_CONSUMERS // (rows // 16)
    blocks = -(-n // rows)
    resident = min(4, max(1, -(-blocks // H100_SMS)))  # blocks an SM holds at once
    budget = H100_SMEM_PER_SM // resident - 1024
    stages = min(W4A8_MAX_STAGES, -(-total // slices) * slices)
    while stages > slices and smem(rows, stages) > budget:
        stages -= slices
    if smem(rows, stages) > H100_SMEM_PER_BLOCK:
        raise ValueError(f"no ring of the w4a8 kernel fits for cb {cb}, g {g}, {rows} rows")
    why = "" if blocks >= H100_SMS else (
        f"{blocks} blocks of {rows} rows: N = {n} has no more at token tile {tile}")
    return W4a8Plan(route="tensor_cores", token_tile=tile, col_tile=rows, stage_codes=kc,
                    stages_total=total, k_slices=slices, stages=stages, meta_cols=bc,
                    meta_boxes=boxes, smem=smem(rows, stages), grid=(blocks,),
                    meta_tma=meta_row % 16 == 0, why=why)


def _fastdiv(d: int) -> tuple[int, int]:
    """(mul, shift) with x // d == (x * mul >> 32) >> shift for every 0 <= x
    < 2^31: the multiply-high division of Granlund and Montgomery that the
    dequant kernels take (`FastDiv` of csrc/dequant.cu); d = 1 gives mul 0,
    which they read as x itself."""
    if d < 1 or d >= 2**31:
        raise ValueError(f"no fast division by {d}")
    if d == 1:
        return 0, 0
    p = 31 + (d - 1).bit_length()  # 31 + ceil(log2 d)
    return -(-(1 << p) // d), p - 32


def _grid_stride_blocks(vectors: int) -> int:
    """Blocks of the dequant kernels' grid-stride loop over ``vectors``
    vectors: a warp takes 32 * DEQUANT_ITEMS a pass; at most one wave."""
    warps = -(-vectors // (32 * DEQUANT_ITEMS))
    return max(1, min(DEQUANT_MAX_BLOCKS, -(-warps // (DEQUANT_THREADS // 32))))


@dataclasses.dataclass(frozen=True)
class DequantPlan:
    """How `dequant` launches on a kernel layout (csrc/dequant.cu).

    Axis=1 (`hqq_dequant`): ``vectors`` vectors of ``vec`` codes (16 output
    bytes) in W's row-major order, lanes of a warp on neighbouring vectors,
    ``items`` a lane per pass, ``grid`` blocks of ``threads`` striding over
    them; vector v's group is v*vec // g (``per_group``), its meta column
    that plus ``pad`` for each row before it (``per_row_groups`` divides by
    K/g). Axis=0 (`hqq_dequant_ax0`): a thread per vector of ``vec`` columns
    and residue class b = n % P of rows, ``grid`` = (column blocks, P,
    slices), each slice ``rows_per_block`` rows of the class; ``aligned``:
    W's rows start on 16 bytes, so whole vectors store at once."""

    axis: int
    vec: int
    threads: int
    grid: tuple
    items: int = DEQUANT_ITEMS
    vectors: int = 0
    per_group: tuple = (0, 0)
    per_row_groups: tuple = (0, 0)
    pad: int = 0
    rows_per_block: int = 0
    aligned: bool = True


@functools.lru_cache(maxsize=None)
def dequant_launch_plan(n: int, k: int, cb: int, group_size: int, out_dtype: torch.dtype,
                        meta_dtype: torch.dtype = torch.float32, axis: int = 1,
                        k_pad: Optional[int] = None) -> DequantPlan:
    """The launch of the dequant kernel for W [n, k] from a kernel layout of
    ``cb``-bit containers and groups of ``group_size`` (axis=0: scale and zs
    [n / g, k_pad]), written in ``out_dtype``."""
    if out_dtype not in _DTYPE_CODE:
        raise ValueError(f"dequant kernel writes fp32, bf16 or fp16, not {out_dtype}")
    if n * k >= 2**31:
        raise ValueError(f"W [{n}, {k}] has 2^31 elements or more")
    g = group_size
    vec = 16 // out_dtype.itemsize
    if axis == 0:
        p_blocks = n // g
        if p_blocks > 65535:
            raise ValueError(f"{p_blocks} residue classes of rows exceed a grid's 65535")
        gx = -(-k // (vec * DEQUANT_AX0_THREADS))
        slices = max(1, min(g, -(-DEQUANT_AX0_MIN_BLOCKS // (gx * p_blocks))))
        rows = -(-g // slices)
        return DequantPlan(axis=0, vec=vec, threads=DEQUANT_AX0_THREADS,
                           grid=(gx, p_blocks, -(-g // rows)), items=1, rows_per_block=rows,
                           aligned=k * out_dtype.itemsize % 16 == 0)
    vectors = n * k // vec  # K is a multiple of 8 (g % 8 == 0)
    groups = k // g
    return DequantPlan(axis=1, vec=vec, threads=DEQUANT_THREADS,
                       grid=(_grid_stride_blocks(vectors),), vectors=vectors,
                       per_group=_fastdiv(g), per_row_groups=_fastdiv(groups),
                       pad=ax1_meta_cols(groups, meta_dtype) - groups)


def dequant_plain(kqt: "KernelQTensor | KernelQTensor0", dtype=torch.float32) -> torch.Tensor:
    """Plain version of the dequant kernel: W [N, K] = c*scale - zs in fp32,
    then cast to ``dtype``. Axis=0: row n takes row n % (N/g) of scale and
    zs (widened to fp32), and the K padding is cut."""
    c = _unpack_words(kqt.wq, kqt.container_bits).to(torch.float32)
    g = kqt.group_size
    if isinstance(kqt, KernelQTensor0):
        n, k = kqt.shape
        w = c * kqt.scale.to(torch.float32).repeat(g, 1) - kqt.zs.to(torch.float32).repeat(g, 1)
        return w[:, :k].to(dtype)
    k, n = kqt.shape
    scale, zs = _ax1_meta(kqt)
    w = c.view(n, k // g, g) * scale[:, :, None] - zs[:, :, None]
    return w.reshape(n, k).to(dtype)


def dequant(kqt: "KernelQTensor | KernelQTensor0", dtype=torch.float32) -> torch.Tensor:
    """W [N, K] in ``dtype`` (fp32, bf16 or fp16) from either kernel layout."""
    if _on_cpu(kqt.wq):
        return dequant_plain(kqt, dtype)
    dev = kqt.wq.device
    ax0 = isinstance(kqt, KernelQTensor0)
    if ax0:
        _check_kqt0(kqt, dev)
    else:
        _check_kqt(kqt, dev)
    plan = dequant_launch_plan(kqt.n, kqt.k, kqt.container_bits, kqt.group_size, dtype,
                               kqt.scale.dtype, axis=0 if ax0 else 1,
                               k_pad=kqt.k_pad if ax0 else None)
    out = torch.empty((kqt.n, kqt.k), dtype=dtype, device=dev)
    name = "dequant_ax0" if ax0 else "dequant"
    with torch.cuda.device(dev):
        lib = _build.library(name)
        if ax0:
            code = lib.hqq_dequant_ax0(
                _ptr(kqt.wq), _ptr(kqt.scale), _ptr(kqt.zs), _ptr(out), kqt.n, kqt.k,
                kqt.k_pad, kqt.group_size, kqt.container_bits, _DTYPE_CODE[dtype],
                _DTYPE_CODE[kqt.scale.dtype], plan.grid[0], plan.grid[2], plan.rows_per_block,
                int(plan.aligned), _stream(dev),
            )
        else:
            code = lib.hqq_dequant(
                _ptr(kqt.wq), _ptr(kqt.scale, 4), _ptr(kqt.zs, 4), _ptr(out), plan.vectors,
                *plan.per_group, *plan.per_row_groups, plan.pad, kqt.container_bits,
                _DTYPE_CODE[dtype], _DTYPE_CODE[kqt.scale.dtype], plan.grid[0], _stream(dev),
            )
    _build.check(name, code)
    dequant.launches += 1
    return out


@dataclasses.dataclass(frozen=True)
class CanonicalPlan:
    """How `dequant_canonical` computes W from a canonical `QTensor`.

    csrc/dequant.cu `hqq_dequant_canonical`. The packed matrix [Rp, C]
    (``container``: 1-byte or 4-byte words of ``fields`` bitfields of
    ``bits`` bits, most significant first; or, with packing=None, -1 minus
    the dtype code of the unpacked codes' fp32, bf16 or fp16, one code an
    element, ``fields`` 1) is read as ``positions`` vectors
    of ``vec`` elements, one ``load_bytes`` load each, lanes of a warp on
    neighbouring vectors, ``items`` a lane per pass, ``grid`` blocks of
    ``threads`` striding over them. Packed element e of pack block e //
    (SB*C) (``per_block``) holds in field f the output element e + block *
    ``block_skip`` + f * ``stride``; those at or past ``valid`` = R*C are
    3-bit padding and are not written. Each field of a vector is one store of
    ``vec`` outputs. Meta: ``meta_mode`` 0 one scalar, 1 per row (the
    output's row by ``per_row`` = C), 2 per column, in ``meta_dtype`` T =
    the promotion of scale's and zero's types, the type the plain twin
    computes in."""

    container: int = 0
    fields: int = 0
    bits: int = 0
    vec: int = 0
    load_bytes: int = 0
    positions: int = 0
    valid: int = 0
    stride: int = 0
    block_skip: int = 0
    per_block: tuple = (0, 0)
    cols: int = 0
    per_row: tuple = (0, 0)
    meta_mode: int = 0
    meta_dtype: torch.dtype = torch.float32
    threads: int = DEQUANT_THREADS
    items: int = DEQUANT_ITEMS
    grid: tuple = (0,)


def dequant_canonical_plan(qt: QTensor, dtype: torch.dtype) -> CanonicalPlan:
    """The launch of the dequant kernel's canonical entry for ``qt`` (scale
    and zero plain tensors: `resolve_meta`), written in ``dtype``. Covers
    every packing of `BIT_TO_PACKING` (8, 6 and 5 bits in 8bit_u8, 1.58 in
    2bit_u8, 3-bit in the int32 container), any group size, both axes,
    per-tensor meta and ``pack_blocks``, and ``packing=None`` (codes
    unpacked in fp32, bf16 or fp16). The output vector is 16 bytes where C,
    the length of a group-space row, is a multiple of it, else one element.
    Plans are kept by what they depend on (a training step asks for the
    same few hundred times)."""
    return _canonical_plan(
        qt.packing, tuple(qt.shape), qt.group_size, qt.axis, qt.channel_wise, qt.pack_blocks,
        tuple(qt.wq.shape), qt.wq.dtype, tuple(qt.scale.shape), qt.scale.dtype,
        tuple(qt.zero.shape), qt.zero.dtype, dtype)


@functools.lru_cache(maxsize=None)
def _canonical_plan(packing, shape, group_size, axis, channel_wise, pack_blocks, wq_shape,
                    wq_dtype, scale_shape, scale_dtype, zero_shape, zero_dtype,
                    dtype) -> CanonicalPlan:
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"dequant kernel writes fp32, bf16 or fp16, not {dtype}")
    meta = torch.promote_types(scale_dtype, zero_dtype)
    if meta not in _DTYPE_CODE:
        raise ValueError(f"scale and zero in {scale_dtype} and {zero_dtype}: the kernel "
                         f"computes in fp32, bf16 or fp16")
    total = 1
    for d in shape:
        total *= d
    # the rows of the group-space matrix, before 3-bit padding
    if group_size is None or not channel_wise:
        rows = shape[0]
    elif axis == 0:
        rows = group_size
    else:
        rows = total // group_size
    cols = total // rows
    if packing is None:  # the codes unpacked, one an element: one field
        if wq_dtype not in _DTYPE_CODE:
            raise ValueError(f"unpacked codes in {wq_dtype}: the kernel reads fp32, bf16 "
                             f"or fp16")
        r, bits, blocks, container = 1, 0, 1, -1 - _DTYPE_CODE[wq_dtype]
    else:
        if wq_dtype != PACKING_CONTAINER[packing]:
            raise ValueError(f"{packing} codes are {PACKING_CONTAINER[packing]}, not "
                             f"{wq_dtype}")
        r, bits, blocks = VALS_PER_WORD[packing], FIELD_BITS[packing], pack_blocks
        container = 4 if packing == "3bit_32" else 1
    packed_rows = -(-rows // r)
    if wq_shape != (packed_rows, cols):
        raise ValueError(f"wq {wq_shape} is not [{packed_rows}, {cols}] of {packing} for "
                         f"{rows} group-space rows")
    if packed_rows % blocks:
        raise ValueError(f"{packed_rows} packed rows do not split into {blocks} blocks")
    sb = packed_rows // blocks  # packed rows of a block
    if blocks > 1 and rows != packed_rows * r:
        raise ValueError(f"{blocks} pack blocks of {rows} rows: a block is not whole words")
    if packed_rows * cols >= 2**31 or total >= 2**31:
        raise ValueError(f"{packing} codes of {total} values: 2^31 or more")
    if zero_shape != scale_shape:
        raise ValueError(f"scale {scale_shape} and zero {zero_shape} differ in shape")
    if all(d == 1 for d in scale_shape):
        mode = 0
    elif scale_shape == (rows, 1):
        mode = 1
    elif scale_shape == (1, cols):
        mode = 2
    else:
        raise ValueError(f"meta {scale_shape} is none of scalar, [{rows}, 1] and [1, {cols}]")
    vec = 16 // dtype.itemsize
    vec = vec if cols % vec == 0 else 1
    positions = packed_rows * cols // vec
    return CanonicalPlan(
        container=container, fields=r, bits=bits, vec=vec,
        load_bytes=vec * wq_dtype.itemsize, positions=positions, valid=rows * cols,
        stride=sb * cols, block_skip=(r - 1) * sb * cols, per_block=_fastdiv(sb * cols),
        cols=cols, per_row=_fastdiv(cols), meta_mode=mode, meta_dtype=meta,
        grid=(_grid_stride_blocks(positions),))


def stacked_experts(qt: QTensor) -> int:
    """The experts of a stacked `QTensor` (``wq``, ``scale`` and ``zero``
    with a leading E, ``shape`` one expert's: `nn.moe.GroupedQuantLinear`'s
    stack), 0 for a single one (``wq`` in group space, 2-D)."""
    return qt.wq.shape[0] if qt.wq.dim() == 3 else 0


def expert_qtensor(qt: QTensor, e: int) -> QTensor:
    """Expert ``e`` of a stacked `QTensor`, a single one (views)."""
    return dataclasses.replace(qt, wq=qt.wq[e], scale=qt.scale[e], zero=qt.zero[e])


def dequant_stacked_plain(qt: QTensor, dtype=None) -> torch.Tensor:
    """Plain PyTorch dequantization of a stack of experts, [E, *qt.shape]:
    `core.quantize.dequantize_plain`'s operations on all experts at once
    (the codes unpacked expert by expert as pack blocks), so each expert's W
    is bit-equal to `dequantize_plain` of it alone; 3-bit and unpacked codes
    expert by expert."""
    experts = stacked_experts(qt)
    dtype = dtype if dtype is not None else qt.compute_dtype
    if qt.packing in (None, "3bit_32") or qt.pack_blocks != 1:
        return torch.stack([dequantize_plain(expert_qtensor(qt, e), dtype)
                            for e in range(experts)])
    codes = _bitpack_unpack(qt.wq.reshape(-1, *qt.wq.shape[2:]), qt.packing, qt.scale.dtype,
                            blocks=experts).reshape(experts, -1, *qt.wq.shape[2:])
    return ((codes - qt.zero) * qt.scale).reshape(experts, *qt.shape).to(dtype)


def dequant_canonical(qt: QTensor, dtype=None) -> torch.Tensor:
    """W = ((c - zero) * scale).reshape(qt.shape) in ``dtype`` (default the
    compute type) from a canonical `QTensor`: the kernel's canonical entry
    for codes on a CUDA device (`dequant_canonical_plan`), the plain twin
    `core.quantize.dequantize_plain` for codes on the CPU. Meta-quantized
    scale and zero are dequantized first, in fp32, by the same route.
    `core.quantize.dequantize` calls it.

    A stacked `QTensor` (`stacked_experts`) gives [E, *qt.shape]: one
    launch for all E experts (E the grid's second dimension), each expert's
    W bit-equal to a call on it alone; on the CPU the twin of each."""
    experts = stacked_experts(qt)
    if experts == 0:
        qt = resolve_meta(qt)
    elif qt.is_meta_quantized:
        raise ValueError("a stack of experts holds plain scale and zero tensors")
    dtype = dtype if dtype is not None else qt.compute_dtype
    if _on_cpu(qt.wq):
        return dequant_stacked_plain(qt, dtype) if experts else dequantize_plain(qt, dtype)
    plan = dequant_canonical_plan(expert_qtensor(qt, 0) if experts else qt, dtype)
    dev = qt.wq.device
    scale, zero = (t.to(plan.meta_dtype).contiguous() for t in (qt.scale, qt.zero))
    for t in (qt.wq, scale, zero):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"codes, scale and zero must be contiguous on {dev}")
    meta_align = plan.vec * scale.element_size() if plan.meta_mode == 2 else 1
    n_out = 1
    for d in qt.shape:
        n_out *= d
    strides = (qt.wq[0].numel(), scale[0].numel(), n_out) if experts else (0, 0, 0)
    out = torch.empty(((experts,) if experts else ()) + tuple(qt.shape), dtype=dtype, device=dev)
    grid = plan.grid[0] if not experts else max(
        1, -(-_grid_stride_blocks(plan.positions * experts) // experts))
    with torch.cuda.device(dev):
        code = _build.library("dequant_canonical").hqq_dequant_canonical(
            _ptr(qt.wq, min(16, plan.load_bytes)), _ptr(scale, min(16, meta_align)),
            _ptr(zero, min(16, meta_align)), _ptr(out), plan.positions, plan.valid, plan.stride,
            plan.block_skip, *plan.per_block, plan.cols, *plan.per_row, max(experts, 1),
            *strides, plan.fields, plan.bits, plan.meta_mode, plan.container, plan.vec,
            _DTYPE_CODE[plan.meta_dtype], _DTYPE_CODE[dtype], grid, _stream(dev),
        )
    _build.check("dequant_canonical", code)
    dequant_canonical.launches += 1
    return out


# the most rows (C) an expert's slots hold for the grouped expert kernel
# (csrc/grouped_matmul.cu, which sets its own block geometry); past it the
# stack is dequantized once and multiplied by torch.bmm
GROUPED_MAX_C = 32


@dataclasses.dataclass(frozen=True)
class GroupedPlan:
    """How `grouped_matmul` computes x [E, C, K] . W_e^T: ``route``
    "kernel" (csrc/grouped_matmul.cu, ``token_tiles`` tiles of 8 tokens)
    or "bmm" (the stack dequantized in one
    launch of `dequant_canonical`, then `torch.bmm`), with the reason."""

    route: str
    token_tiles: int = 0
    why: str = ""


@functools.lru_cache(maxsize=None)
def grouped_matmul_plan(experts: int, c: int, k: int, n: int, x_dtype: torch.dtype,
                        packing: Optional[str], axis: int, group_size: Optional[int],
                        meta_dtype: torch.dtype, channel_wise: bool = True,
                        pack_blocks: int = 1) -> GroupedPlan:
    """The route of x [experts, c, k] through a stack of [n, k] weights, by
    shape and config alone, before any launch: the kernel for 4bit_u8 axis=1
    codes with fp32 or bf16 scale and zero, bf16 x, k % 64 == 0, groups of a
    multiple of 16 that divide k, n even and 1 <= c <= 32 (every decode
    step, small prefills); the dequantized stack and `torch.bmm` otherwise
    (larger c: a compute-bound product; 2-bit, 3-bit, 8-bit, axis=0, ...)."""
    def bmm(why):
        return GroupedPlan(route="bmm", why=why)

    if packing != "4bit_u8" or axis != 1 or not channel_wise or pack_blocks != 1:
        return bmm(f"{packing} axis={axis}: the kernel reads 4bit_u8 axis=1 codes")
    if x_dtype != torch.bfloat16:
        return bmm(f"x in {x_dtype}: the kernel multiplies bf16")
    if meta_dtype not in (torch.float32, torch.bfloat16):
        return bmm(f"scale and zero in {meta_dtype}")
    if group_size is None or group_size % 16 or k % group_size or k % 64 or n % 2:
        return bmm(f"k={k}, n={n}, g={group_size}: the kernel needs k % 64 == 0, g % 16 == 0 "
                   f"dividing k, n even")
    if not 1 <= c <= GROUPED_MAX_C:
        return bmm(f"{c} rows an expert: past {GROUPED_MAX_C} the product is compute-bound")
    if not 1 <= experts <= 65535:
        return bmm(f"{experts} experts exceed a grid's 65535")
    tiles = next(t for t in (1, 2, 4) if c <= 8 * t)
    return GroupedPlan(route="kernel", token_tiles=tiles,
                       why=f"{c} rows an expert, {tiles} token tile(s)")


def grouped_plan_for(x: torch.Tensor, qt: QTensor) -> GroupedPlan:
    """`grouped_matmul_plan` for x [E, C, K] and a stacked `QTensor`
    (scale and zero of two types: no kernel)."""
    meta = qt.scale.dtype if qt.scale.dtype == qt.zero.dtype else None
    return grouped_matmul_plan(x.shape[0], x.shape[1], qt.shape[1], qt.shape[0], x.dtype,
                               qt.packing, qt.axis, qt.group_size, meta, qt.channel_wise,
                               qt.pack_blocks)


def grouped_matmul_plain(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """Plain version of the grouped kernel: every expert's W dequantized to
    x's type (`dequantize_plain`), the products summed in fp32, the result
    rounded to x's type: [E, C, N]."""
    w = dequant_stacked_plain(qt, x.dtype)
    return torch.bmm(x.float(), w.float().transpose(1, 2)).to(x.dtype)


def grouped_matmul(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """y[e] = x[e] . W_e^T for x [E, C, K] and a stacked 4bit_u8 `QTensor`
    (`stacked_experts`) whose plan takes the kernel (`grouped_matmul_plan`):
    its plain twin for tensors on the CPU; on the card the kernel, or a
    ValueError for what its plan sends elsewhere."""
    if _on_cpu(x):
        return grouped_matmul_plain(x, qt)
    plan = grouped_plan_for(x, qt)
    if plan.route != "kernel":
        raise ValueError(f"grouped_matmul: {plan.why}")
    dev = x.device
    experts, c, k = x.shape
    n = qt.shape[0]
    g = qt.group_size
    if stacked_experts(qt) != experts or qt.shape[1] != k:
        raise ValueError(f"x {tuple(x.shape)} against {stacked_experts(qt)} experts of "
                         f"{tuple(qt.shape)}")
    if qt.wq.dtype != torch.uint8 or tuple(qt.wq.shape) != (experts, n * k // (2 * g), g) \
            or tuple(qt.scale.shape) != (experts, n * k // g, 1) or qt.zero.shape != qt.scale.shape:
        raise ValueError(f"codes must be uint8 [{experts}, {n * k // (2 * g)}, {g}] and scale and "
                         f"zero [{experts}, {n * k // g}, 1]")
    x = x.contiguous()
    for t in (qt.wq, qt.scale, qt.zero):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"codes, scale and zero must be contiguous on {dev}")
    y = torch.empty((experts, c, n), dtype=x.dtype, device=dev)
    with torch.cuda.device(dev):
        code = _build.library("grouped_matmul").hqq_grouped_matmul(
            _ptr(x), _ptr(qt.wq), _ptr(qt.scale, 4 if qt.scale.dtype == torch.float32 else 2),
            _ptr(qt.zero, 4 if qt.zero.dtype == torch.float32 else 2), _ptr(y, 2), experts, c, k,
            n, qt.group_size, _DTYPE_CODE[qt.scale.dtype], plan.token_tiles, _stream(dev),
        )
    _build.check("grouped_matmul", code)
    grouped_matmul.launches += 1
    return y


def _check_lora(kqt, a: torch.Tensor, b: torch.Tensor, dev) -> int:
    """The rank of an adapter A [K, r], B [r, N] for ``kqt``, checked."""
    r = a.shape[-1]
    if tuple(a.shape) != (kqt.k, r) or tuple(b.shape) != (r, kqt.n):
        raise ValueError(f"LoRA needs A [{kqt.k}, r] and B [r, {kqt.n}], got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    if r < 1:
        raise ValueError("the LoRA kernels need a rank of at least 1")
    if a.device != dev or b.device != dev:
        raise ValueError(f"LoRA operands must be on {dev}")
    return r


def qmm_fp32(x2: torch.Tensor, kqt: "KernelQTensor | KernelQTensor0",
             a: Optional[torch.Tensor] = None, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The fp32 route of `quant_matmul`, `quant_matmul_ax0` and
    `quant_matmul_lora` (csrc/qmm_fp32.cu): x2 fp32 [M, K] @ W^T (+ (x2 @
    a) @ b) -> fp32 [M, N] to fp32 accuracy: W dequantized in fp32, the
    product from three TF32 tensor-core products of the operands' big and
    small parts, the adapter's term in fp32. Its plain versions are those
    of the three wrappers."""
    if _on_cpu(x2):
        if isinstance(kqt, KernelQTensor0):
            return quant_matmul_ax0_plain(x2, kqt)
        return quant_matmul_plain(x2, kqt) if a is None else quant_matmul_lora_plain(x2, kqt, a, b)
    dev = x2.device
    ax0 = isinstance(kqt, KernelQTensor0)
    if ax0:
        _check_kqt0(kqt, dev)
    else:
        _check_kqt(kqt, dev)
    if x2.dtype != torch.float32 or x2.ndim != 2 or x2.shape[1] != kqt.k:
        raise ValueError(f"qmm_fp32 takes fp32 x [M, {kqt.k}], got {x2.dtype} {tuple(x2.shape)}")
    pad = -kqt.k % 4 if ax0 else 0  # x's rows in whole 16-byte chunks (axis=1: K % 8 == 0)
    x2 = F.pad(x2, (0, pad)) if pad else x2.contiguous()
    if x2.data_ptr() % 16:
        x2 = x2.clone()
    m, kx = x2.shape
    r = 0
    if a is not None:
        if ax0:
            raise ValueError("the LoRA term is served over an axis=1 weight only")
        r = _check_lora(kqt, a, b, dev)
        b = b.to(torch.float32).contiguous()
    k_pad = kqt.k_pad if ax0 else kqt.k
    plan = qmm_fp32_launch_plan(m, kqt.n, k_pad, kqt.container_bits, kqt.group_size,
                                axis=0 if ax0 else 1, meta_size=kqt.scale.element_size(), rank=r)
    if r:  # A [K, passes * 8] in fp32, zero past the rank
        a_pad = torch.zeros((kqt.k, plan.passes * plan.rank_tile), dtype=torch.float32,
                            device=dev)
        a_pad[:, :r].copy_(a.detach())
    out = torch.empty((m, kqt.n), dtype=torch.float32, device=dev)
    part = _split_scratch(plan, m, kqt.n, dev)
    lib = _build.library("qmm_fp32")
    with torch.cuda.device(dev):
        code = lib.hqq_qmm_fp32(
            _ptr(x2), _ptr(kqt.wq, 4), _ptr(kqt.scale, 2), _ptr(kqt.zs, 2),
            _ptr(a_pad) if r else None, _ptr(b, 4) if r else None, _ptr(out, 4),
            None if part is None else _ptr(part, 4), m, kqt.n, kx, k_pad, kqt.group_size,
            kqt.container_bits, 0 if ax0 else 1, _DTYPE_CODE[kqt.scale.dtype], r, plan.passes,
            plan.token_tile, plan.stages, plan.splits, plan.slabs_per_split, plan.smem,
            _stream(dev),
        )
    _build.check("qmm_fp32", code)
    qmm_fp32.launches += 1
    return out


def quant_matmul_plain(x2: torch.Tensor, kqt: KernelQTensor) -> torch.Tensor:
    """Plain version of the quant_matmul kernel: x2 [M, K] @ W^T with W
    dequantized in fp32 and rounded to x2's dtype, summed in fp32."""
    w = dequant_plain(kqt, x2.dtype)
    return (x2.to(torch.float32) @ w.to(torch.float32).t()).to(x2.dtype)


def _kernel_activations(x2: torch.Tensor, k: int) -> torch.Tensor:
    """x2 [M, K] as the tile kernels take it: bf16 or fp16, contiguous and
    16-byte aligned."""
    if x2.dtype not in (torch.bfloat16, torch.float16):
        raise ValueError(f"the kernel takes bf16 or fp16 activations, not {x2.dtype}")
    if x2.ndim != 2 or x2.shape[1] != k:
        raise ValueError(f"x has shape {tuple(x2.shape)}, weight has K={k}")
    x2 = x2.contiguous()
    return x2.clone() if x2.data_ptr() % 16 else x2


def _split_scratch(plan: QmmPlan, m: int, n: int, dev) -> "torch.Tensor | None":
    """fp32 partials [splits, m, n] of a K split over blocks, or None."""
    if plan.splits == 1:
        return None
    return torch.empty((plan.splits, m, n), dtype=torch.float32, device=dev)


def quant_matmul(x2: torch.Tensor, kqt: KernelQTensor) -> torch.Tensor:
    """x2 [M, K] @ W^T -> [M, N] in x2's dtype: bf16 or fp16 on the card's
    tensor cores, fp32 through `qmm_fp32`."""
    if _on_cpu(x2):
        return quant_matmul_plain(x2, kqt)
    if x2.dtype == torch.float32:
        return qmm_fp32(x2, kqt)
    dev = x2.device
    _check_kqt(kqt, dev)
    x2 = _kernel_activations(x2, kqt.k)
    m, k = x2.shape
    n = kqt.n
    out = torch.empty((m, n), dtype=x2.dtype, device=dev)
    plan = qmm_launch_plan(m, n, k, kqt.container_bits, kqt.group_size,
                           meta_size=kqt.scale.element_size())
    part = _split_scratch(plan, m, n, dev)
    lib = _build.library("quant_matmul")
    with torch.cuda.device(dev):
        code = lib.hqq_quant_matmul(
            _ptr(x2), _ptr(kqt.wq, 4), _ptr(kqt.scale, 4), _ptr(kqt.zs, 4), _ptr(out, 2),
            None if part is None else _ptr(part, 4), m, n, k, kqt.group_size,
            kqt.container_bits, _DTYPE_CODE[x2.dtype], _DTYPE_CODE[kqt.scale.dtype],
            plan.token_tile, plan.stages, plan.splits, plan.slabs_per_split, plan.smem,
            _stream(dev),
        )
    _build.check("quant_matmul", code)
    quant_matmul.launches += 1
    return out


def quant_matmul_lora_plain(
    x2: torch.Tensor, kqt: KernelQTensor, a: torch.Tensor, b: torch.Tensor,
) -> torch.Tensor:
    """Plain version of the quant_matmul_lora kernel: x2 @ W^T + (x2 @ A) @ B
    with W and A rounded to x2's dtype, both products summed in fp32, B
    applied to the fp32 partial in fp32, one rounding to x2's dtype."""
    xf = x2.to(torch.float32)
    base = xf @ dequant_plain(kqt, x2.dtype).to(torch.float32).t()
    part = xf @ a.to(x2.dtype).to(torch.float32)
    return (base + part @ b.to(torch.float32)).to(x2.dtype)


def lora_rank_tile(rank: int) -> int:
    """The ranks of one chunk of the LoRA kernel for an adapter of ``rank``
    ranks: 16 up to 16, else 64."""
    return QMM_RANK_TILES[0] if rank <= QMM_RANK_TILES[0] else QMM_RANK_TILES[1]


def lora_a_kernel_layout(a: torch.Tensor, dtype: torch.dtype, rank_tile: int) -> torch.Tensor:
    """A [K, r] as the LoRA kernel reads it: A^T [passes * rank_tile, K] in
    ``dtype`` (x's type: the kernel rounds A to it, as `hqq_tpu` does),
    K-major, the rank padded with zero rows to whole chunks."""
    k, r = a.shape
    out = torch.empty((-(-r // rank_tile) * rank_tile, k), dtype=dtype, device=a.device)
    out[r:].zero_()
    out[:r].copy_(a.detach().t())  # one kernel: transpose and cast
    return out


def quant_matmul_lora(
    x2: torch.Tensor, kqt: KernelQTensor, a: torch.Tensor, b: torch.Tensor,
) -> torch.Tensor:
    """x2 [M, K] @ W^T + (x2 @ A) @ B -> [M, N] in x2's dtype, with A [K, r]
    and B [r, N] (scaling folded in), any rank r >= 1, all in one kernel
    (fp32 x through `qmm_fp32`). The kernel reads A as A^T, which is built
    from ``a`` at each call (`lora_a_kernel_layout`), so what is served is
    always the ``a`` given."""
    if _on_cpu(x2):
        return quant_matmul_lora_plain(x2, kqt, a, b)
    if x2.dtype == torch.float32:
        return qmm_fp32(x2, kqt, a, b)
    dev = x2.device
    _check_kqt(kqt, dev)
    x2 = _kernel_activations(x2, kqt.k)
    r = _check_lora(kqt, a, b, dev)
    m, k = x2.shape
    n = kqt.n
    plan = qmm_launch_plan(m, n, k, kqt.container_bits, kqt.group_size,
                           meta_size=kqt.scale.element_size(), rank=r)
    a_t = lora_a_kernel_layout(a, x2.dtype, plan.rank_tile)
    b = b.to(torch.float32).contiguous()
    out = torch.empty((m, n), dtype=x2.dtype, device=dev)
    part = _split_scratch(plan, m, n, dev)
    lib = _build.library("quant_matmul_lora")
    with torch.cuda.device(dev):
        code = lib.hqq_quant_matmul_lora(
            _ptr(x2), _ptr(kqt.wq, 4), _ptr(kqt.scale, 4), _ptr(kqt.zs, 4), _ptr(a_t), _ptr(b, 4),
            _ptr(out, 2), None if part is None else _ptr(part, 4), m, n, k, r, kqt.group_size,
            kqt.container_bits, _DTYPE_CODE[x2.dtype], _DTYPE_CODE[kqt.scale.dtype],
            plan.token_tile, plan.rank_tile,
            plan.passes, plan.stages, plan.splits, plan.slabs_per_split, plan.smem, _stream(dev),
        )
    _build.check("quant_matmul_lora", code)
    quant_matmul_lora.launches += 1
    return out


def quant_matmul_ax0_plain(x2: torch.Tensor, kqt: KernelQTensor0) -> torch.Tensor:
    """Plain version of the quant_matmul_ax0 kernel: x2 [M, K] @ W^T with W
    dequantized in fp32 and rounded to x2's dtype, summed in fp32."""
    w = dequant_plain(kqt, x2.dtype)
    return (x2.to(torch.float32) @ w.to(torch.float32).t()).to(x2.dtype)


def quant_matmul_ax0(x2: torch.Tensor, kqt: KernelQTensor0) -> torch.Tensor:
    """x2 [M, K] @ W^T -> [M, N] in x2's dtype for an axis=0 weight, columns
    in logical order (fp32 through `qmm_fp32`)."""
    if _on_cpu(x2):
        return quant_matmul_ax0_plain(x2, kqt)
    if x2.dtype == torch.float32:
        return qmm_fp32(x2, kqt)
    dev = x2.device
    _check_kqt0(kqt, dev)
    pad = -kqt.k % 8  # the kernel reads rows of whole 16-byte chunks
    if pad and x2.shape[-1] == kqt.k:
        x2 = F.pad(x2, (0, pad))
    x2 = _kernel_activations(x2, kqt.k + pad)
    m, kx = x2.shape
    n = kqt.n
    out = torch.empty((m, n), dtype=x2.dtype, device=dev)
    plan = qmm_launch_plan(m, n, kqt.k_pad, kqt.container_bits, kqt.group_size, axis=0,
                           meta_size=kqt.scale.element_size())
    part = _split_scratch(plan, m, n, dev)
    lib = _build.library("quant_matmul_ax0")
    with torch.cuda.device(dev):
        code = lib.hqq_quant_matmul_ax0(
            _ptr(x2), _ptr(kqt.wq, 4), _ptr(kqt.scale, 2), _ptr(kqt.zs, 2), _ptr(out, 2),
            None if part is None else _ptr(part, 4), m, n, kx, kqt.k_pad, kqt.group_size,
            kqt.container_bits, _DTYPE_CODE[x2.dtype], _DTYPE_CODE[kqt.scale.dtype],
            plan.token_tile, plan.stages, plan.splits, plan.slabs_per_split, plan.smem,
            _stream(dev),
        )
    _build.check("quant_matmul_ax0", code)
    quant_matmul_ax0.launches += 1
    return out


def w4a8_matmul_plain(
    x8: torch.Tensor, sx: torch.Tensor, kqt: KernelQTensor, out_dtype=torch.float32
) -> torch.Tensor:
    """Plain version of the w4a8 kernel:
    y = sx * sum_g(s_g * dot_g(x8, c) - xsum_g * zs_g), with every group
    dot exact (integers below 2^24 are exact in fp32)."""
    k, n = kqt.shape
    g = kqt.group_size
    m = x8.shape[0]
    c = _unpack_words(kqt.wq, kqt.container_bits).to(torch.float32).view(n, k // g, g)
    xg = x8.to(torch.float32).view(m, k // g, g)
    dots = torch.einsum("mgk,ngk->mng", xg, c)
    xsum = xg.sum(dim=-1)  # [M, K/g]
    scale, zs = _ax1_meta(kqt)
    out = (dots * scale[None] - xsum[:, None, :] * zs[None]).sum(dim=-1)
    return (out * sx).to(out_dtype)


def _w4a8_operands(x8, sx, kqt, out_dtype):
    """(x8, sx) as the w4a8 kernel takes them, checked against ``kqt``."""
    dev = x8.device
    _check_kqt(kqt, dev)
    m, k = x8.shape
    if x8.dtype != torch.int8 or k != kqt.k or not 1 <= m <= A8_MAX_M:
        raise ValueError(f"w4a8 kernel takes int8 [M<= {A8_MAX_M}, {kqt.k}], got {x8.dtype} {tuple(x8.shape)}")
    if kqt.nbits == 8:
        raise ValueError("8-bit codes do not fit int8 operands")
    if out_dtype not in _DTYPE_CODE:
        raise ValueError(f"w4a8 kernel writes fp32, bf16 or fp16, not {out_dtype}")
    x8 = x8.contiguous()
    if x8.data_ptr() % 16:  # the base of a TMA map
        x8 = x8.clone()
    sx = sx.to(torch.float32).contiguous()
    if sx.numel() != m or sx.device != dev:
        raise ValueError("sx must hold one fp32 scale per row, on the device of x8")
    plan = w4a8_launch_plan(m, kqt.n, k, kqt.container_bits, kqt.group_size, kqt.scale.dtype)
    return x8, sx, plan


def _w4a8_meta_ptrs(kqt: KernelQTensor, plan: W4a8Plan) -> tuple:
    """scale and zs as the C entries take them: 16-byte aligned bases (TMA)
    on the small-group route."""
    align = 16 if plan.route == "group_mma" else 4
    return _ptr(kqt.scale, align), _ptr(kqt.zs, align)


def _w4a8_plan_args(plan: W4a8Plan) -> tuple:
    """The plan's fields as the C entries take them, after the meta type."""
    return (plan.route_code, plan.token_tile, plan.col_tile, plan.k_slices, plan.stages,
            plan.meta_cols, plan.smem)


def w4a8_matmul(
    x8: torch.Tensor, sx: torch.Tensor, kqt: KernelQTensor, out_dtype=torch.float32
) -> torch.Tensor:
    """int8 activations x8 [M, K] (M <= 32) with row scales sx [M, 1]
    against a 1/2/4-bit (or 5/6-bit in the 8-bit container) weight ->
    [M, N] in ``out_dtype``."""
    if _on_cpu(x8):
        return w4a8_matmul_plain(x8, sx, kqt, out_dtype)
    dev = x8.device
    x8, sx, plan = _w4a8_operands(x8, sx, kqt, out_dtype)
    m, k = x8.shape
    out = torch.empty((m, kqt.n), dtype=out_dtype, device=dev)
    lib = _build.library("w4a8_matmul")
    with torch.cuda.device(dev):
        code = lib.hqq_w4a8_matmul(
            _ptr(x8, 4), _ptr(sx, 4), _ptr(kqt.wq, 16), *_w4a8_meta_ptrs(kqt, plan),
            _ptr(out, 2), m, kqt.n, k, kqt.group_size, kqt.container_bits,
            _DTYPE_CODE[out_dtype], _DTYPE_CODE[kqt.scale.dtype], *_w4a8_plan_args(plan),
            _stream(dev),
        )
    _build.check("w4a8_matmul", code)
    w4a8_matmul.launches += 1
    W4A8_ROUTE_LAUNCHES[plan.route] += 1
    return out


def w4a8_lora_matmul_plain(
    x8: torch.Tensor, sx: torch.Tensor, kqt: KernelQTensor, xa: torch.Tensor, b: torch.Tensor,
    out_dtype=torch.float32,
) -> torch.Tensor:
    """Plain version of the w4a8_lora kernel: the w4a8 base in fp32 plus
    xa @ B in fp32, one rounding to ``out_dtype``."""
    base = w4a8_matmul_plain(x8, sx, kqt, torch.float32)
    return (base + xa.to(torch.float32) @ b.to(torch.float32)).to(out_dtype)


def w4a8_lora_matmul(
    x8: torch.Tensor, sx: torch.Tensor, kqt: KernelQTensor, xa: torch.Tensor, b: torch.Tensor,
    out_dtype=torch.float32,
) -> torch.Tensor:
    """`w4a8_matmul` plus the LoRA epilogue xa [M, r] @ B [r, N] in fp32,
    where xa = x @ A was computed from the unquantized activations."""
    if _on_cpu(x8):
        return w4a8_lora_matmul_plain(x8, sx, kqt, xa, b, out_dtype)
    dev = x8.device
    x8, sx, plan = _w4a8_operands(x8, sx, kqt, out_dtype)
    m, k = x8.shape
    r = b.shape[0]
    if r < 1 or tuple(xa.shape) != (m, r) or tuple(b.shape) != (r, kqt.n):
        raise ValueError(f"LoRA epilogue needs xa [{m}, r] and B [r, {kqt.n}], got "
                         f"{tuple(xa.shape)}, {tuple(b.shape)}")
    if xa.device != dev or b.device != dev:
        raise ValueError(f"LoRA operands must be on {dev}")
    xa = xa.to(torch.float32).contiguous()
    b = b.to(torch.float32).contiguous()
    out = torch.empty((m, kqt.n), dtype=out_dtype, device=dev)
    lib = _build.library("w4a8_lora_matmul")
    with torch.cuda.device(dev):
        code = lib.hqq_w4a8_lora_matmul(
            _ptr(x8, 4), _ptr(sx, 4), _ptr(kqt.wq, 16), *_w4a8_meta_ptrs(kqt, plan),
            _ptr(xa, 4), _ptr(b, 4), _ptr(out, 2), m, kqt.n, k, r, kqt.group_size,
            kqt.container_bits, _DTYPE_CODE[out_dtype], _DTYPE_CODE[kqt.scale.dtype],
            *_w4a8_plan_args(plan), _stream(dev),
        )
    _build.check("w4a8_lora_matmul", code)
    w4a8_lora_matmul.launches += 1
    W4A8_ROUTE_LAUNCHES[plan.route] += 1
    return out


_WRAPPERS = (dequant, dequant_canonical, quant_matmul, quant_matmul_lora, quant_matmul_ax0,
             w4a8_matmul, w4a8_lora_matmul, qmm_fp32, grouped_matmul)


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0, and the w4a8 routes'."""
    for w in _WRAPPERS:
        w.launches = 0
    for route in W4A8_ROUTE_LAUNCHES:
        W4A8_ROUTE_LAUNCHES[route] = 0


reset_launch_counts()


# ---------------------------------------------------------------------------
# Entry points (the names of `hqq_tpu.ops.fused_matmul`)
# ---------------------------------------------------------------------------


def quantize_activations_int8(x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 activation quantization: x ~ x8 * sx, with
    sx = max(amax/127, 1e-8) and x8 = round(x/sx) (half to even) in fp32."""
    xf = x2.to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    sx = torch.clamp_min(amax / 127.0, 1e-8)
    x8 = torch.round(xf / sx).to(torch.int8)
    return x8, sx


def quant_matmul_pallas(x: torch.Tensor, kqt: "KernelQTensor | KernelQTensor0") -> torch.Tensor:
    """``x @ W_dq^T`` for a kernel-layout weight of either axis: x [..., K]
    -> [..., N] in x's dtype, fp32 accumulation (the `quant_matmul` or the
    `quant_matmul_ax0` kernel)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, kqt.k)
    out = quant_matmul_ax0(x2, kqt) if isinstance(kqt, KernelQTensor0) else quant_matmul(x2, kqt)
    return out.reshape(*lead, kqt.n)


def quant_matmul_pallas_a8(x: torch.Tensor, kqt: "KernelQTensor | KernelQTensor0") -> torch.Tensor:
    """``x @ W_dq^T`` with int8 activations at decode sizes.

    The routing of `hqq_tpu`'s `quant_matmul_pallas_a8`: axis=0 weights
    (their scales change along K within a row, so nothing factors out of an
    int8 dot), 8-bit weights and M > 32 rows (M = the product of the leading
    dims, so a prefill of B*t_pad > 32) take the bf16-operand kernels with
    full-precision activations; M <= 32 quantizes the activations per row
    to int8 and takes the `w4a8_matmul` kernel. The weight side is exact;
    the output is in x's dtype."""
    if isinstance(kqt, KernelQTensor0) or kqt.nbits == 8:
        return quant_matmul_pallas(x, kqt)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, kqt.k)
    if x2.shape[0] > A8_MAX_M:
        return quant_matmul_pallas(x, kqt)
    x8, sx = quantize_activations_int8(x2)
    out = w4a8_matmul(x8, sx, kqt, x.dtype)
    return out.reshape(*lead, kqt.n)


def quant_matmul_pallas_lora(
    x: torch.Tensor, kqt: KernelQTensor, a: torch.Tensor, b: torch.Tensor,
) -> torch.Tensor:
    """``x @ W_dq^T + (x @ a) @ b`` in one kernel (`quant_matmul_lora`).
    a: [K, r], b: [r, N] with the adapter's scaling folded in; any r >= 1."""
    lead = x.shape[:-1]
    out = quant_matmul_lora(x.reshape(-1, kqt.k), kqt, a, b)
    return out.reshape(*lead, kqt.n)


def quant_matmul_pallas_a8_lora(
    x: torch.Tensor, kqt: KernelQTensor, a: torch.Tensor, b: torch.Tensor,
) -> torch.Tensor:
    """``x @ W_dq^T + (x @ a) @ b`` with the base on the int8 decode kernel
    and the adapter in its epilogue (`w4a8_lora_matmul`).

    The routing of `hqq_tpu`'s `quant_matmul_pallas_a8_lora`: M > 32 and
    8-bit weights take `quant_matmul_pallas_lora`. Its third route, K not a
    multiple of 8 groups, does not exist here: the w4a8 kernel serves every
    K % g == 0. The rank-r partial xa = x @ a is a plain matmul on the
    unquantized activations, outside the kernel as in `hqq_tpu`, so the
    adapter never sees the int8 rounding; the kernel adds xa @ b in fp32
    after the multiply by the activation scale (`hqq_tpu` divides xa by that
    scale first and multiplies the sum: equal to fp32 rounding)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, kqt.k)
    if x2.shape[0] > A8_MAX_M or kqt.nbits == 8:
        return quant_matmul_pallas_lora(x, kqt, a, b)
    x8, sx = quantize_activations_int8(x2)
    xa = x2.to(torch.float32) @ a.to(torch.float32)
    out = w4a8_lora_matmul(x8, sx, kqt, xa, b, x.dtype)
    return out.reshape(*lead, kqt.n)


def dequant_pallas(kqt: "KernelQTensor | KernelQTensor0", dtype=torch.float32) -> torch.Tensor:
    """W^T [K, N] in ``dtype`` (the `dequant` kernel writes W [N, K] in
    logical row order; this returns its transposed view, the reference's
    orientation)."""
    return dequant(kqt, dtype).t()
