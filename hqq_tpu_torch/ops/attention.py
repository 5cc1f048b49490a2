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

The kernel's wrapper has a plain PyTorch twin and a launch count
(``flash_attention.launches``). It runs the plain version only for tensors on
the CPU; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from . import _build
from .fused_matmul import _DTYPE_CODE, H100_SMEM_PER_BLOCK, _on_cpu, _ptr, _stream

__all__ = ["prefill_attention", "flash_attention", "flash_attention_plain", "FLASH_MIN_SEQ",
           "FlashPlan", "flash_launch_plan"]

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


@functools.lru_cache(maxsize=64)
def _q_order_on(q_order: tuple, device: torch.device) -> torch.Tensor:
    """A plan's query-tile table as the kernel reads it, int32 on the card,
    copied there once per table."""
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Self-attention over whole sequences: q [B, nh, T, hd], k and v
    [B, n_kv, T, hd] with nh a multiple of n_kv -> [B, nh, T, hd] in q's type
    (bf16 or fp16 on the card; head_dim a multiple of 16 up to 256; any T).
    Forward only: the backward kernel belongs to the training path, so a
    tensor that requires a gradient is refused."""
    if _on_cpu(q):
        return flash_attention_plain(q, k, v, causal, sm_scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError("flash_attention has no backward kernel yet: call it under "
                                  "torch.no_grad()")
    dev = q.device
    b, nh, t, hd = q.shape
    n_kv = k.shape[1]
    if q.dtype not in (torch.bfloat16, torch.float16):
        raise ValueError(f"the kernel takes bf16 or fp16, not {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype or k.shape != v.shape \
            or tuple(k.shape) != (b, n_kv, t, hd):
        raise ValueError(f"k and v must be [B, n_kv, {t}, {hd}] of q's type; got "
                         f"{tuple(k.shape)} {k.dtype}, {tuple(v.shape)} {v.dtype}")
    if nh % n_kv or hd % 16 or hd > _MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes nh a multiple of n_kv and head_dim a multiple of 16 "
                         f"up to {_MAX_HEAD_DIM}; got nh={nh}, n_kv={n_kv}, head_dim={hd}")
    if k.device != dev or v.device != dev:
        raise ValueError(f"kernel operands must be on {dev}")
    sm_scale = hd**-0.5 if sm_scale is None else sm_scale
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    plan = flash_launch_plan(b, nh, t, hd)
    lib = _build.library("flash_attention")
    with torch.cuda.device(dev):
        code = lib.hqq_flash_prefill(_ptr(q), _ptr(k), _ptr(v), _ptr(out),
                                     _ptr(_q_order_on(plan.q_order, dev), 4), b, nh, n_kv, t, hd,
                                     float(sm_scale), int(bool(causal)), _DTYPE_CODE[q.dtype],
                                     plan.head_pad, plan.key_tile, plan.stages, plan.smem,
                                     plan.blocks, _stream(dev))
    _build.check("flash_attention", code)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


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
