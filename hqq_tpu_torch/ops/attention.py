# SPDX-License-Identifier: Apache-2.0
"""Attention over whole sequences: flash attention for perplexity
evaluation and the training forward.

Mirrors `hqq_tpu.ops.attention`. The naive path writes [B, H, T, S] scores to
device memory, which is fine for decode (T = 1) and quadratic in T for whole
sequences. `prefill_attention` hands long self-attention without an explicit
mask to the `flash_attention` kernel (``csrc/flash_prefill.cu``: wgmma and
TMA, online softmax, scores, probabilities and output in registers; its launch
plan is `flash_launch_plan`); short sequences and explicit masks (a sliding
window) take the naive path, as in `hqq_tpu`.

Under autograd, `flash_attention` is a `torch.autograd.Function`: the forward
also writes each row's log-sum-exp, and the backward is two kernels, the
counterparts of the library's dK/dV and dQ kernels:
`flash_attention_backward_dkv` and `flash_attention_backward_dq` (bf16 and
fp16: ``csrc/flash_backward_sm90.cu``, wgmma and TMA), and for fp32 inputs
`flash_attention_backward_dkv_fp32` and `flash_attention_backward_dq_fp32`
(``csrc/flash_backward_fp32_sm90.cu``: 3xTF32 on wgmma; at head size 256
the head split over a cluster of two blocks), launch plan
`flash_backward_launch_plan`, plain twin `flash_attention_backward_plain`.
For fp32 inputs the forward is `flash_attention_fp32`
(``csrc/flash_fp32_sm90.cu``: 3xTF32 on wgmma, each operand split into
TF32 big and small parts, each tile's products folded into fp32 sums;
launch plan `flash_fp32_launch_plan`).

Every kernel wrapper has a plain PyTorch twin and a launch count
(``<wrapper>.launches``). It runs the plain version only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from . import _build
from .fused_matmul import _DTYPE_CODE, H100_SMEM_PER_BLOCK, _on_cpu, _ptr, _stream

__all__ = ["prefill_attention", "flash_attention", "flash_attention_plain", "FLASH_MIN_SEQ",
           "FlashPlan", "flash_launch_plan", "flash_attention_fp32", "FlashFp32Plan",
           "flash_fp32_launch_plan", "flash_fp32_smem_bytes", "flash_attention_backward",
           "flash_attention_backward_dkv", "flash_attention_backward_dq",
           "flash_attention_backward_dkv_fp32", "flash_attention_backward_dq_fp32",
           "flash_attention_backward_plain", "FlashBackwardPlan", "flash_backward_launch_plan",
           "flash_bwd_fp32_smem"]

# below this sequence length the naive path runs (`hqq_tpu`'s threshold)
FLASH_MIN_SEQ = 256
_MAX_HEAD_DIM = 256
# the geometry of csrc/flash_prefill.cu: query rows of a block, the padded
# head sizes it is built for, and the most slots of its K/V ring
FLASH_QUERY_TILE = 128
FLASH_HEAD_PADS = (64, 128, 256)
FLASH_MAX_STAGES = 4


@dataclasses.dataclass(frozen=True)
class FlashPlan:
    """How `flash_attention` launches: ``blocks`` blocks of 128 query rows,
    block i on query tile ``q_order[i // (batch * heads)]`` of (batch, head)
    ``i % (batch * heads)`` (the kernel reads the table); the head size
    padded to ``head_pad``, keys in tiles of ``key_tile`` through ``stages``
    slots, ``smem`` bytes of dynamic shared memory."""

    head_pad: int
    key_tile: int
    stages: int
    smem: int
    q_order: tuple
    blocks: int


def flash_smem_bytes(head_pad: int, key_tile: int, stages: int) -> int:
    """Dynamic shared memory of one block (`flash_smem` of flash_prefill.cu):
    Q's tile, ``stages`` slots of K's and V's tiles, the barriers, and 1024
    bytes to align the base."""
    return (FLASH_QUERY_TILE * head_pad * 2 + stages * 2 * key_tile * head_pad * 2
            + 8 * (1 + 2 * stages) + 1024)


@functools.lru_cache(maxsize=1024)
def flash_launch_plan(batch: int, heads: int, t: int, head_dim: int) -> FlashPlan:
    """The launch of the flash kernel for [batch, heads, t, head_dim]. The
    head size pads to 64, 128 or 256 (TMA fills the padding with zeros);
    keys come in tiles of 128, or of 64 at 256, where a consumer's output
    accumulators already take 128 registers; as many ring slots as shared
    memory holds, at most 4. The query tiles go last first: under causality
    the last walks the most key tiles, so a causal grid ends on short
    blocks."""
    if not 16 <= head_dim <= _MAX_HEAD_DIM or head_dim % 16:
        raise ValueError(f"the kernel takes head sizes of 16s up to {_MAX_HEAD_DIM}, "
                         f"not {head_dim}")
    head_pad = next(p for p in FLASH_HEAD_PADS if p >= head_dim)
    key_tile = 64 if head_pad == 256 else 128
    fixed = flash_smem_bytes(head_pad, key_tile, 0)
    per_stage = flash_smem_bytes(head_pad, key_tile, 1) - fixed
    stages = min(FLASH_MAX_STAGES, (H100_SMEM_PER_BLOCK - fixed) // per_stage)
    q_tiles = -(-t // FLASH_QUERY_TILE)
    return FlashPlan(head_pad=head_pad, key_tile=key_tile, stages=stages,
                     smem=flash_smem_bytes(head_pad, key_tile, stages),
                     q_order=tuple(range(q_tiles - 1, -1, -1)), blocks=batch * heads * q_tiles)


# the geometry of csrc/flash_fp32_sm90.cu: query rows of a block, and per
# padded head size the key tile and the consumer warpgroups (two at 256,
# each owning 128 output columns); the most slots of its K/V ring
FLASH_FP32_QUERY_TILE = 64
FLASH_FP32_KEY_TILE = {64: 64, 128: 32, 256: 8}
FLASH_FP32_CONSUMERS = {64: 1, 128: 1, 256: 2}
FLASH_FP32_MAX_STAGES = 4


@dataclasses.dataclass(frozen=True)
class FlashFp32Plan:
    """How `flash_attention_fp32` launches: ``blocks`` blocks of 64 query
    rows, block i on query tile ``q_order[i // (batch * heads)]`` of (batch,
    head) ``i % (batch * heads)``; the head size padded to ``head_pad``,
    keys in tiles of ``key_tile`` through ``stages`` slots, ``consumers``
    warpgroups, ``smem`` bytes of dynamic shared memory."""

    head_pad: int
    key_tile: int
    consumers: int
    stages: int
    smem: int
    q_order: tuple
    blocks: int


def flash_fp32_smem_bytes(head_pad: int, key_tile: int, stages: int) -> int:
    """Dynamic shared memory of one block (`fp32_flash_smem` of
    flash_fp32_sm90.cu): Q's tile in its TF32 big and small parts, K's small
    part, V^T's big and small parts, ``stages`` slots of K's and V's raw
    tiles, the barriers, and 1024 bytes to align the base."""
    tile = key_tile * head_pad * 4
    return (2 * FLASH_FP32_QUERY_TILE * head_pad * 4 + 3 * tile + stages * 2 * tile
            + 8 * (1 + 2 * stages) + 1024)


@functools.lru_cache(maxsize=1024)
def flash_fp32_launch_plan(batch: int, heads: int, t: int, head_dim: int) -> FlashFp32Plan:
    """The launch of the fp32 flash kernel for [batch, heads, t, head_dim].
    The head size pads to 64, 128 or 256 (TMA fills the padding with zeros).
    Q's two TF32 parts take 64 * head_pad * 8 bytes, so the key tile shrinks
    as the head grows (64, 32, 8 keys) to leave a ring of at least two slots
    of K's and V's fp32 tiles; at 256 two consumers share the output
    columns, 128 each, so that a thread's output sums and a tile's products
    stay at 64 registers each. The query tiles go last first, as in
    `flash_launch_plan`."""
    if not 16 <= head_dim <= _MAX_HEAD_DIM or head_dim % 16:
        raise ValueError(f"the kernel takes head sizes of 16s up to {_MAX_HEAD_DIM}, "
                         f"not {head_dim}")
    head_pad = next(p for p in FLASH_HEAD_PADS if p >= head_dim)
    key_tile = FLASH_FP32_KEY_TILE[head_pad]
    stages = max(n for n in range(1, FLASH_FP32_MAX_STAGES + 1)
                 if flash_fp32_smem_bytes(head_pad, key_tile, n) <= H100_SMEM_PER_BLOCK)
    q_tiles = -(-t // FLASH_FP32_QUERY_TILE)
    return FlashFp32Plan(head_pad=head_pad, key_tile=key_tile,
                         consumers=FLASH_FP32_CONSUMERS[head_pad], stages=stages,
                         smem=flash_fp32_smem_bytes(head_pad, key_tile, stages),
                         q_order=tuple(range(q_tiles - 1, -1, -1)),
                         blocks=batch * heads * q_tiles)


@functools.lru_cache(maxsize=64)
def _q_order_on(q_order: tuple, device: torch.device) -> torch.Tensor:
    """A plan's tile table (query tiles, or the backward's key tiles) as the
    kernel reads it, int32 on the card, copied there once per table."""
    return torch.tensor(q_order, dtype=torch.int32, device=device)


def _naive(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: Optional[torch.Tensor],
           scale: float) -> torch.Tensor:
    """Scores summed and kept in fp32, fp32 softmax, probabilities rounded
    to q's type before the second product."""
    scores = torch.einsum("bhtd,bhsd->bhts", q.to(torch.float32), k.to(torch.float32)) * scale
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhts,bhsd->bhtd", probs, v)


def _causal_mask(t: int, s: int, device) -> torch.Tensor:
    visible = torch.ones((t, s), dtype=torch.bool, device=device).tril()
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(visible, zero, torch.finfo(torch.float32).min)[None, None]


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                          sm_scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of the flash_attention kernel: `_naive` under the causal
    mask (or none). k and v may hold fewer heads than q (GQA): each is shared
    by nh / n_kv query heads."""
    hd = q.shape[3]
    sm_scale = hd**-0.5 if sm_scale is None else sm_scale
    rep = q.shape[1] // k.shape[1]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    mask = _causal_mask(q.shape[2], k.shape[2], q.device) if causal else None
    return _naive(q, k, v, mask, sm_scale)


def _check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dtypes) -> None:
    b, nh, t, hd = q.shape
    n_kv = k.shape[1]
    if q.dtype not in dtypes:
        raise ValueError(f"the kernel takes {dtypes}, not {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype or k.shape != v.shape \
            or tuple(k.shape) != (b, n_kv, t, hd):
        raise ValueError(f"k and v must be [B, n_kv, {t}, {hd}] of q's type; got "
                         f"{tuple(k.shape)} {k.dtype}, {tuple(v.shape)} {v.dtype}")
    if nh % n_kv or hd % 16 or hd > _MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes nh a multiple of n_kv and head_dim a multiple of 16 "
                         f"up to {_MAX_HEAD_DIM}; got nh={nh}, n_kv={n_kv}, head_dim={hd}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"kernel operands must be on {q.device}")


def _flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                   sm_scale: Optional[float], with_lse: bool):
    """(out, lse or None) on the card: bf16/fp16 through the wgmma kernel
    (`flash_attention.launches`), fp32 through `flash_attention_fp32`."""
    if q.dtype == torch.float32:
        return flash_attention_fp32(q, k, v, causal, sm_scale, with_lse)
    dev = q.device
    b, nh, t, hd = q.shape
    n_kv = k.shape[1]
    _check_qkv(q, k, v, (torch.bfloat16, torch.float16))
    sm_scale = hd**-0.5 if sm_scale is None else sm_scale
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((b, nh, t), dtype=torch.float32, device=dev) if with_lse else None
    plan = flash_launch_plan(b, nh, t, hd)
    lib = _build.library("flash_attention")
    with torch.cuda.device(dev):
        code = lib.hqq_flash_prefill(_ptr(q), _ptr(k), _ptr(v), _ptr(out),
                                     None if lse is None else _ptr(lse, 4),
                                     _ptr(_q_order_on(plan.q_order, dev), 4), b, nh, n_kv, t, hd,
                                     float(sm_scale), int(bool(causal)), _DTYPE_CODE[q.dtype],
                                     plan.head_pad, plan.key_tile, plan.stages, plan.smem,
                                     plan.blocks, _stream(dev))
    _build.check("flash_attention", code)
    flash_attention.launches += 1
    return out, lse


def flash_attention_fp32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                         sm_scale: Optional[float] = None, with_lse: bool = False):
    """The fp32 route of `flash_attention` (csrc/flash_fp32_sm90.cu: every
    product from three TF32 tensor-core products, softmax and sums in fp32):
    (out, lse or None) for fp32 q, k, v. Its plain versions are
    `flash_attention_plain` and `_plain_lse`."""
    if _on_cpu(q):
        out = flash_attention_plain(q, k, v, causal, sm_scale)
        return out, (_plain_lse(q, k, causal, sm_scale) if with_lse else None)
    dev = q.device
    b, nh, t, hd = q.shape
    _check_qkv(q, k, v, (torch.float32,))
    sm_scale = hd**-0.5 if sm_scale is None else sm_scale
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((b, nh, t), dtype=torch.float32, device=dev) if with_lse else None
    plan = flash_fp32_launch_plan(b, nh, t, hd)
    lib = _build.library("flash_attention_fp32")
    with torch.cuda.device(dev):
        code = lib.hqq_flash_fp32(_ptr(q), _ptr(k), _ptr(v), _ptr(out),
                                  None if lse is None else _ptr(lse, 4),
                                  _ptr(_q_order_on(plan.q_order, dev), 4), b, nh, k.shape[1], t,
                                  hd, float(sm_scale), int(bool(causal)), plan.head_pad,
                                  plan.key_tile, plan.consumers, plan.stages, plan.smem,
                                  plan.blocks, _stream(dev))
    _build.check("flash_attention_fp32", code)
    flash_attention_fp32.launches += 1
    return out, lse


flash_attention_fp32.launches = 0


def _plain_lse(q: torch.Tensor, k: torch.Tensor, causal: bool,
               sm_scale: Optional[float]) -> torch.Tensor:
    """Each row's log-sum-exp of scale * q . k (causal or not), fp32
    [B, nh, T]: what the forward kernels write for the backward."""
    sm_scale = q.shape[3]**-0.5 if sm_scale is None else sm_scale
    rep = q.shape[1] // k.shape[1]
    kf = k.to(torch.float32).repeat_interleave(rep, dim=1) if rep > 1 else k.to(torch.float32)
    scores = torch.einsum("bhtd,bhsd->bhts", q.to(torch.float32), kf) * sm_scale
    if causal:
        scores = scores + _causal_mask(q.shape[2], k.shape[2], q.device)
    return torch.logsumexp(scores, dim=-1)


class _FlashAttention(torch.autograd.Function):
    """`flash_attention` under autograd: the forward keeps q, k, v, out and
    each row's log-sum-exp; the backward is `flash_attention_backward` (the
    dK/dV and dQ kernels on the card, their plain twin on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        if _on_cpu(q):
            out = flash_attention_plain(q, k, v, causal, sm_scale)
            lse = _plain_lse(q, k, causal, sm_scale)
        else:
            out, lse = _flash_forward(q, k, v, causal, sm_scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse, do, ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Self-attention over whole sequences: q [B, nh, T, hd], k and v
    [B, n_kv, T, hd] with nh a multiple of n_kv -> [B, nh, T, hd] in q's type
    (bf16 and fp16 on the tensor cores, fp32 through `flash_attention_fp32`;
    head_dim a multiple of 16 up to 256; any T). Where autograd wants a
    gradient of q, k or v it runs as `_FlashAttention`, which also keeps
    each row's log-sum-exp for the backward kernels."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, sm_scale)
    if _on_cpu(q):
        return flash_attention_plain(q, k, v, causal, sm_scale)
    return _flash_forward(q, k, v, causal, sm_scale, with_lse=False)[0]


flash_attention.launches = 0


# ---------------------------------------------------------------------------
# The backward (csrc/flash_backward_sm90.cu; fp32: csrc/flash_backward_fp32_sm90.cu)
# ---------------------------------------------------------------------------

# the geometry of csrc/flash_backward_sm90.cu: query rows of a dK/dV step and
# of a dQ block, and the most slots of either ring
FLASH_BWD_QUERY_TILE = 64
FLASH_BWD_DQ_ROWS = 128
FLASH_BWD_MAX_STAGES = 4
# the geometry of csrc/flash_backward_fp32_sm90.cu: the resident rows of a
# block (keys of dK/dV, query rows of dQ) and, per padded head size, the
# streamed rows of a step (queries of dK/dV, keys of dQ) and the blocks of a
# cluster, which split the head's columns between them (head_pad 256: two
# blocks of 128 columns each)
FLASH_BWD_FP32_ROWS = 64
FLASH_BWD_FP32_TILE = {64: 32, 128: 16, 256: 16}
FLASH_BWD_FP32_CLUSTER = {64: 1, 128: 1, 256: 2}


@dataclasses.dataclass(frozen=True)
class FlashBackwardPlan:
    """How the backward kernels launch.

    bf16 and fp16 (the wgmma kernels): the head size padded to
    ``head_pad``. dK/dV: ``dkv_blocks`` blocks of ``dkv_keys`` keys, one per
    (batch, query head, key tile), block i on key tile
    ``kv_order[i // (batch * heads)]``; query tiles of 64 rows through
    ``dkv_stages`` slots, ``dkv_smem`` bytes of shared memory; at head size
    256 both consumers share the block's 64 keys, 128 head columns each.
    ``gqa_split``: heads > kv_heads, so each block writes fp32
    partials of its query head, summed over the group by the wrapper. dQ:
    ``dq_blocks`` blocks of 128 query rows, block i on query tile
    ``q_order[i // (batch * heads)]``; key tiles of ``dq_key_tile`` rows
    through ``dq_stages`` slots, ``dq_smem`` bytes.

    fp32 (the 3xTF32 kernels of flash_backward_fp32_sm90.cu): ``fp32_route``
    "wgmma" (head_pad 64 and 128, a block per resident tile) or
    "wgmma_cluster" (head_pad 256: a cluster of ``fp32_cluster`` = 2 blocks
    per resident tile, 128 head columns each). A block owns ``fp32_rows``
    resident rows and walks tiles of ``fp32_tile`` streamed rows through
    ``fp32_dkv_stages`` or ``fp32_dq_stages`` ring slots, with
    ``fp32_dkv_smem`` or ``fp32_dq_smem`` bytes of shared memory. dK/dV:
    ``fp32_dkv_blocks`` resident tiles (blocks, or clusters), tile i on key
    tile ``fp32_kv_order[i // g]`` of (batch, query head) i % g, g = batch *
    heads, fp32 partials summed by the wrapper where ``gqa_split``. dQ:
    ``fp32_dq_blocks`` resident tiles, tile i on query tile
    ``fp32_q_order[i // g]``."""

    head_pad: int
    dkv_keys: int
    gqa_split: bool
    dkv_stages: int
    dkv_smem: int
    dkv_blocks: int
    kv_order: tuple
    dq_key_tile: int
    dq_stages: int
    dq_smem: int
    dq_blocks: int
    q_order: tuple
    fp32_route: str
    fp32_cluster: int
    fp32_rows: int
    fp32_tile: int
    fp32_dkv_stages: int
    fp32_dq_stages: int
    fp32_dkv_smem: int
    fp32_dq_smem: int
    fp32_dkv_blocks: int
    fp32_dq_blocks: int
    fp32_kv_order: tuple
    fp32_q_order: tuple


def flash_bwd_dkv_smem(head_pad: int, keys: int, stages: int) -> int:
    """Dynamic shared memory of a dK/dV block (`dkv_smem` of
    flash_backward_sm90.cu): K's and V's tiles of ``keys`` rows, per slot
    Q's and dO's tiles and 64 rows' lse and D in fp32, the barriers, 1024
    bytes to align the base."""
    return (2 * keys * head_pad * 2 + stages * (2 * FLASH_BWD_QUERY_TILE * head_pad * 2
                                                + 2 * FLASH_BWD_QUERY_TILE * 4)
            + 8 * (1 + 2 * stages) + 1024)


def flash_bwd_dq_smem(head_pad: int, key_tile: int, stages: int) -> int:
    """Dynamic shared memory of a dQ block (`dq_smem` of
    flash_backward_sm90.cu): Q's and dO's tiles of 128 rows, per slot K's and
    V's tiles of ``key_tile`` rows, the barriers, 1024 bytes to align the
    base."""
    return (2 * FLASH_BWD_DQ_ROWS * head_pad * 2 + stages * 2 * key_tile * head_pad * 2
            + 8 * (1 + 2 * stages) + 1024)


def flash_bwd_fp32_smem(head_pad: int, stages: int, dkv: bool) -> int:
    """Dynamic shared memory of a block of flash_backward_fp32_sm90.cu
    (`bwd_fp32_smem`), over its head_pad / cluster columns: the resident
    pair (K and V, or Q and dO) of 64 rows in its TF32 big and small parts,
    the streamed pair's small parts, the transposed big and small parts of
    the streamed operands contracted over the streamed rows (Q and dO for
    dK/dV, K for dQ), ``stages`` slots of the streamed pair's raw tiles
    (and, for dK/dV, their rows' lse and D, 128 bytes each: a TMA box lands
    128-byte aligned), in a cluster two slots of the other block's partials
    of S and dP (a float per streamed row of each, per consumer thread),
    the barriers (one per slot, five more, in a cluster one per partials
    slot), and 1024 bytes to align the base."""
    tile, cluster = FLASH_BWD_FP32_TILE[head_pad], FLASH_BWD_FP32_CLUSTER[head_pad]
    cols = head_pad // cluster
    a, b = FLASH_BWD_FP32_ROWS * cols * 4, tile * cols * 4
    stats = stages * 2 * 128 if dkv else 0
    partials = 2 * 128 * tile * 4 if cluster > 1 else 0
    return (4 * a + (2 + (4 if dkv else 2)) * b + stages * 2 * b + stats + partials
            + 8 * (5 + stages + (2 if cluster > 1 else 0)) + 1024)


def _stages(smem_of) -> int:
    """As many ring slots as a block's shared memory holds, at most
    FLASH_BWD_MAX_STAGES."""
    return max(n for n in range(1, FLASH_BWD_MAX_STAGES + 1) if smem_of(n) <= H100_SMEM_PER_BLOCK)


@functools.lru_cache(maxsize=1024)
def flash_backward_launch_plan(batch: int, heads: int, kv_heads: int, t: int,
                               head_dim: int) -> FlashBackwardPlan:
    """The launch of the backward kernels for q
    [batch, heads, t, head_dim] and k, v [batch, kv_heads, t, head_dim]. The
    head size pads to 64, 128 or 256 as in the forward.

    bf16/fp16: a dK/dV block owns 128 keys, 64 per consumer, whose dK and dV
    accumulators take 2 x head_pad / 2 registers a thread; at 256 that would
    be 256, so there a block owns 64 keys and each consumer 128 of the head
    columns. A dQ block owns 128 query rows; keys come in tiles of 64, or of
    32 at 256, where Q's and dO's tiles already take 128 KB. Causal work
    falls with the key tile (dK/dV) and grows with the query tile (dQ): the
    tables start with the longest walks, so a causal grid ends on short
    blocks.

    fp32: the 3xTF32 kernels. A block keeps 64 resident rows of an operand
    pair in two TF32 parts (128 KB at 128), so the streamed tiles are
    narrow: 16 rows at 128, 32 at 64, the ring as deep as the rest of the
    block's shared memory allows. At head_pad 256 that pair alone would
    take 256 KB, so a cluster of two blocks shares each resident tile, one
    block on each half of the head's columns (the hd-128 geometry and 16
    streamed rows each, plus 16 KB for the other block's partials of S and
    dP). The tables start with the longest causal walks, as above."""
    if not 16 <= head_dim <= _MAX_HEAD_DIM or head_dim % 16:
        raise ValueError(f"the kernel takes head sizes of 16s up to {_MAX_HEAD_DIM}, "
                         f"not {head_dim}")
    if heads % kv_heads:
        raise ValueError(f"heads {heads} must be a multiple of kv heads {kv_heads}")
    head_pad = next(p for p in FLASH_HEAD_PADS if p >= head_dim)
    dkv_keys, dq_key_tile = (64, 32) if head_pad == 256 else (128, 64)
    key_tiles = -(-t // dkv_keys)
    q_tiles = -(-t // FLASH_BWD_DQ_ROWS)
    dkv_stages = _stages(lambda n: flash_bwd_dkv_smem(head_pad, dkv_keys, n))
    dq_stages = _stages(lambda n: flash_bwd_dq_smem(head_pad, dq_key_tile, n))
    cluster = FLASH_BWD_FP32_CLUSTER[head_pad]
    fp32_dkv_stages = _stages(lambda n: flash_bwd_fp32_smem(head_pad, n, True))
    fp32_dq_stages = _stages(lambda n: flash_bwd_fp32_smem(head_pad, n, False))
    fp32_tiles = -(-t // FLASH_BWD_FP32_ROWS)
    return FlashBackwardPlan(
        head_pad=head_pad, dkv_keys=dkv_keys, gqa_split=heads > kv_heads, dkv_stages=dkv_stages,
        dkv_smem=flash_bwd_dkv_smem(head_pad, dkv_keys, dkv_stages),
        dkv_blocks=batch * heads * key_tiles, kv_order=tuple(range(key_tiles)),
        dq_key_tile=dq_key_tile, dq_stages=dq_stages,
        dq_smem=flash_bwd_dq_smem(head_pad, dq_key_tile, dq_stages),
        dq_blocks=batch * heads * q_tiles, q_order=tuple(range(q_tiles - 1, -1, -1)),
        fp32_route="wgmma" if cluster == 1 else "wgmma_cluster", fp32_cluster=cluster,
        fp32_rows=FLASH_BWD_FP32_ROWS, fp32_tile=FLASH_BWD_FP32_TILE[head_pad],
        fp32_dkv_stages=fp32_dkv_stages, fp32_dq_stages=fp32_dq_stages,
        fp32_dkv_smem=flash_bwd_fp32_smem(head_pad, fp32_dkv_stages, True),
        fp32_dq_smem=flash_bwd_fp32_smem(head_pad, fp32_dq_stages, False),
        fp32_dkv_blocks=batch * heads * fp32_tiles, fp32_dq_blocks=batch * heads * fp32_tiles,
        fp32_kv_order=tuple(range(fp32_tiles)),
        fp32_q_order=tuple(range(fp32_tiles - 1, -1, -1)))


def flash_attention_backward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                                   causal: bool = True, sm_scale: Optional[float] = None):
    """Plain version of the backward kernels, the same arithmetic from the
    same saved statistics: P = exp(scale * q k^T - lse) (0 above the
    diagonal), D = rowsum(dO * O), dV = P'^T dO, dS = scale * P (dO V^T - D),
    dQ = dS' K, dK = dS'^T Q, dK and dV summed over each kv head's query
    heads. P' and dS' are P and dS rounded to the inputs' type, where the
    library's backward kernels round them (a no-op for fp32); every other
    value, product and sum is fp32, and each output is rounded once to the
    inputs' type. Returns (dq, dk, dv)."""
    hd = q.shape[3]
    sm_scale = hd**-0.5 if sm_scale is None else sm_scale
    n_kv = k.shape[1]
    rep = q.shape[1] // n_kv
    f32 = torch.float32
    qf, of, dof = q.to(f32), o.to(f32), do.to(f32)
    kf, vf = k.to(f32), v.to(f32)
    if rep > 1:
        kf, vf = kf.repeat_interleave(rep, dim=1), vf.repeat_interleave(rep, dim=1)
    s = torch.einsum("bhtd,bhsd->bhts", qf, kf) * sm_scale
    p = torch.exp(s - lse.to(f32)[..., None])
    if causal:
        t = q.shape[2]
        p = p * torch.ones((t, k.shape[2]), dtype=torch.bool, device=q.device).tril()
    dv = torch.einsum("bhts,bhtd->bhsd", p.to(q.dtype).to(f32), dof)
    dp = torch.einsum("bhtd,bhsd->bhts", dof, vf)
    delta = (dof * of).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta) * sm_scale).to(q.dtype).to(f32)
    dq = torch.einsum("bhts,bhsd->bhtd", ds, kf)
    dk = torch.einsum("bhts,bhtd->bhsd", ds, qf)
    if rep > 1:
        b, _, t2, _ = dk.shape
        dk = dk.reshape(b, n_kv, rep, t2, hd).sum(dim=2)
        dv = dv.reshape(b, n_kv, rep, t2, hd).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _backward_operands(q, k, v, o, lse, do, sm_scale) -> tuple:
    """The backward kernels' operands, checked and made once for both:
    contiguous q, k, v, dO, fp32 lse, D = rowsum(dO * O) in fp32
    [B, nh, T] (plain torch, as the library computes it outside its
    kernels), and the scale."""
    _check_qkv(q, k, v, tuple(_DTYPE_CODE))
    b, nh, t, hd = q.shape
    if tuple(o.shape) != tuple(q.shape) or tuple(do.shape) != tuple(q.shape) \
            or do.dtype != q.dtype or tuple(lse.shape) != (b, nh, t):
        raise ValueError(f"o and dO must be q's shape and dO q's type, lse [{b}, {nh}, {t}]")
    delta = (do.to(torch.float32) * o.to(torch.float32)).sum(dim=-1)
    sm_scale = hd**-0.5 if sm_scale is None else sm_scale
    return (q.contiguous(), k.contiguous(), v.contiguous(), do.contiguous(),
            lse.to(torch.float32).contiguous(), delta, sm_scale)


def _launch_dkv_fp32(ops: tuple, causal: bool) -> tuple:
    """(dk, dv) of fp32 operands from one launch of the plan's fp32 dK/dV
    kernel; with GQA, the kernel's partials of each query head summed over
    the group (plain torch)."""
    q, k, v, do, lse, delta, sm_scale = ops
    dev = q.device
    b, nh, t, hd = q.shape
    n_kv = k.shape[1]
    plan = flash_backward_launch_plan(b, nh, n_kv, t, hd)
    shape = (b, nh, t, hd) if plan.gqa_split else tuple(k.shape)
    dk, dv = (torch.empty(shape, dtype=torch.float32, device=dev) for _ in range(2))
    if t % 4:  # the kernel reads each head's lse and D in 16-byte-aligned boxes
        lse, delta = (torch.nn.functional.pad(x, (0, -t % 4)) for x in (lse, delta))
    lib = _build.library("flash_attention_backward_dkv_fp32")
    with torch.cuda.device(dev):
        code = lib.hqq_flash_bwd_fp32_dkv(
            _ptr(q, 16), _ptr(k, 16), _ptr(v, 16), _ptr(do, 16), _ptr(lse, 16),
            _ptr(delta, 16), _ptr(dk, 8), _ptr(dv, 8),
            _ptr(_q_order_on(plan.fp32_kv_order, dev), 4), b, nh, n_kv, t, hd, float(sm_scale),
            int(bool(causal)), plan.head_pad, plan.fp32_tile, plan.fp32_dkv_stages,
            plan.fp32_dkv_smem, plan.fp32_dkv_blocks, _stream(dev))
    _build.check("flash_attention_backward_dkv_fp32", code)
    flash_attention_backward_dkv_fp32.launches += 1
    if plan.gqa_split:
        rep = nh // n_kv
        dk = dk.view(b, n_kv, rep, t, hd).sum(dim=2)
        dv = dv.view(b, n_kv, rep, t, hd).sum(dim=2)
    return dk, dv


def _launch_dq_fp32(ops: tuple, causal: bool) -> torch.Tensor:
    """dq of fp32 operands from one launch of the plan's fp32 dQ kernel."""
    q, k, v, do, lse, delta, sm_scale = ops
    dev = q.device
    b, nh, t, hd = q.shape
    plan = flash_backward_launch_plan(b, nh, k.shape[1], t, hd)
    dq = torch.empty_like(q)
    lib = _build.library("flash_attention_backward_dq_fp32")
    with torch.cuda.device(dev):
        code = lib.hqq_flash_bwd_fp32_dq(
            _ptr(q, 16), _ptr(k, 16), _ptr(v, 16), _ptr(do, 16), _ptr(lse, 4), _ptr(delta, 4),
            _ptr(dq, 8), _ptr(_q_order_on(plan.fp32_q_order, dev), 4), b, nh, k.shape[1], t, hd,
            float(sm_scale), int(bool(causal)), plan.head_pad, plan.fp32_tile,
            plan.fp32_dq_stages, plan.fp32_dq_smem, plan.fp32_dq_blocks, _stream(dev))
    _build.check("flash_attention_backward_dq_fp32", code)
    flash_attention_backward_dq_fp32.launches += 1
    return dq


def _launch_dkv(ops: tuple, causal: bool) -> tuple:
    """(dk, dv) from one launch of the dK/dV kernel of the operands' type;
    with GQA, the kernel's fp32 partials of each query head summed over the
    group (plain torch) and rounded once."""
    q, k, v, do, lse, delta, sm_scale = ops
    if q.dtype == torch.float32:
        return _launch_dkv_fp32(ops, causal)
    dev = q.device
    b, nh, t, hd = q.shape
    n_kv = k.shape[1]
    plan = flash_backward_launch_plan(b, nh, n_kv, t, hd)
    if plan.gqa_split:
        dk = dv = None
        dk_part, dv_part = (torch.empty((b, nh, t, hd), dtype=torch.float32, device=dev)
                            for _ in range(2))
    else:
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        dk_part = dv_part = None
    if t % 4:  # the kernel reads each head's lse and D in 16-byte-aligned boxes
        lse, delta = (torch.nn.functional.pad(x, (0, -t % 4)) for x in (lse, delta))
    lib = _build.library("flash_attention_backward_dkv")
    with torch.cuda.device(dev):
        code = lib.hqq_flash_bwd_dkv(
            _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta),
            None if dk is None else _ptr(dk, 4), None if dv is None else _ptr(dv, 4),
            None if dk_part is None else _ptr(dk_part, 8),
            None if dv_part is None else _ptr(dv_part, 8),
            _ptr(_q_order_on(plan.kv_order, dev), 4), b, nh, n_kv, t, hd, float(sm_scale),
            int(bool(causal)), _DTYPE_CODE[q.dtype], plan.head_pad, plan.dkv_stages,
            plan.dkv_smem, plan.dkv_blocks, _stream(dev))
    _build.check("flash_attention_backward_dkv", code)
    flash_attention_backward_dkv.launches += 1
    if plan.gqa_split:
        rep = nh // n_kv
        dk = dk_part.view(b, n_kv, rep, t, hd).sum(dim=2).to(q.dtype)
        dv = dv_part.view(b, n_kv, rep, t, hd).sum(dim=2).to(q.dtype)
    return dk, dv


def _launch_dq(ops: tuple, causal: bool) -> torch.Tensor:
    """dq from one launch of the dQ kernel of the operands' type."""
    q, k, v, do, lse, delta, sm_scale = ops
    if q.dtype == torch.float32:
        return _launch_dq_fp32(ops, causal)
    dq = torch.empty_like(q)
    dev = q.device
    b, nh, t, hd = q.shape
    plan = flash_backward_launch_plan(b, nh, k.shape[1], t, hd)
    lib = _build.library("flash_attention_backward_dq")
    with torch.cuda.device(dev):
        code = lib.hqq_flash_bwd_dq(
            _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta), _ptr(dq, 4),
            _ptr(_q_order_on(plan.q_order, dev), 4), b, nh, k.shape[1], t, hd,
            float(sm_scale), int(bool(causal)), _DTYPE_CODE[q.dtype], plan.head_pad,
            plan.dq_stages, plan.dq_smem, plan.dq_blocks, _stream(dev))
    _build.check("flash_attention_backward_dq", code)
    flash_attention_backward_dq.launches += 1
    return dq


def flash_attention_backward_dkv(q, k, v, o, lse, do, causal: bool = True,
                                 sm_scale: Optional[float] = None):
    """(dk, dv) from the dK/dV kernel: one block per (batch, query head,
    key tile), the query tiles at or below the diagonal walked inside it
    (fp32 inputs: `flash_attention_backward_dkv_fp32`)."""
    if _on_cpu(q):
        return flash_attention_backward_plain(q, k, v, o, lse, do, causal, sm_scale)[1:]
    return _launch_dkv(_backward_operands(q, k, v, o, lse, do, sm_scale), causal)


def flash_attention_backward_dq(q, k, v, o, lse, do, causal: bool = True,
                                sm_scale: Optional[float] = None):
    """dq from the dQ kernel: one block per (batch, head, query tile), the
    key tiles at or left of the diagonal walked inside it (fp32 inputs:
    `flash_attention_backward_dq_fp32`)."""
    if _on_cpu(q):
        return flash_attention_backward_plain(q, k, v, o, lse, do, causal, sm_scale)[0]
    return _launch_dq(_backward_operands(q, k, v, o, lse, do, sm_scale), causal)


def flash_attention_backward_dkv_fp32(q, k, v, o, lse, do, causal: bool = True,
                                      sm_scale: Optional[float] = None):
    """(dk, dv) of fp32 inputs from the fp32 dK/dV kernel
    (csrc/flash_backward_fp32_sm90.cu: every product from three TF32
    tensor-core products; at head_pad 256 a cluster of two blocks a tile,
    by the launch plan). Its plain version is
    `flash_attention_backward_plain`."""
    if _on_cpu(q):
        return flash_attention_backward_plain(q, k, v, o, lse, do, causal, sm_scale)[1:]
    _check_qkv(q, k, v, (torch.float32,))
    return _launch_dkv_fp32(_backward_operands(q, k, v, o, lse, do, sm_scale), causal)


def flash_attention_backward_dq_fp32(q, k, v, o, lse, do, causal: bool = True,
                                     sm_scale: Optional[float] = None):
    """dq of fp32 inputs from the fp32 dQ kernel (as
    `flash_attention_backward_dkv_fp32`)."""
    if _on_cpu(q):
        return flash_attention_backward_plain(q, k, v, o, lse, do, causal, sm_scale)[0]
    _check_qkv(q, k, v, (torch.float32,))
    return _launch_dq_fp32(_backward_operands(q, k, v, o, lse, do, sm_scale), causal)


flash_attention_backward_dkv.launches = 0
flash_attention_backward_dq.launches = 0
flash_attention_backward_dkv_fp32.launches = 0
flash_attention_backward_dq_fp32.launches = 0


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor, causal: bool = True,
                             sm_scale: Optional[float] = None):
    """(dq, dk, dv) of `flash_attention` from its saved q, k, v, out and
    log-sum-exp and the output's gradient dO, in the inputs' types (bf16,
    fp16 or fp32): on the card, the dK/dV and the dQ kernel over operands
    made once (D is a [B, nh, T] reduction; fp32 inputs take the fp32
    kernels); on the CPU, `flash_attention_backward_plain`."""
    if _on_cpu(q):
        return flash_attention_backward_plain(q, k, v, o, lse, do, causal, sm_scale)
    ops = _backward_operands(q, k, v, o, lse, do, sm_scale)
    dk, dv = _launch_dkv(ops, causal)
    return _launch_dq(ops, causal), dk, dv


def prefill_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Self-attention over full sequences [B, H, T, hd] -> [B, H, T, hd].

    Without an explicit mask, for T >= FLASH_MIN_SEQ and a head size the
    kernel has, this is the `flash_attention` kernel (on the CPU, its plain
    version); the kernel applies causality and masks a ragged last tile
    itself, so T need not be a multiple of anything. Any explicit ``mask``
    and any shorter sequence take the naive path. k and v may hold fewer
    heads than q: both paths share each among nh / n_kv query heads."""
    t = q.shape[2]
    hd = q.shape[3]
    scale = scale if scale is not None else hd**-0.5
    kernel_head = hd % 16 == 0 and hd <= _MAX_HEAD_DIM
    if mask is None and t >= FLASH_MIN_SEQ and t == k.shape[2] and kernel_head:
        return flash_attention(q, k, v, causal, scale)
    rep = q.shape[1] // k.shape[1]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    if mask is None and causal:
        mask = _causal_mask(t, k.shape[2], q.device)
    return _naive(q, k, v, mask, scale)
