# SPDX-License-Identifier: Apache-2.0
"""Paged KV-cache primitives: pooled pages, per-token writes, paged attention.

Mirrors `hqq_tpu.ops.paged`. Pages live in one stacked pool
``[L, H, num_pages, page_size, hd]`` that is updated in place (one
`index_put_` per pool per token); with ``quantize_kv`` the pages are int8 with
one fp32 absmax scale per row ``[L, H, P, pg, 1]``. Model forwards take a
`PagedKVCache` wherever they take a dense `KVCache`.

Decode attention over a plain-causal layer is the `paged_attention` kernel
(``csrc/paged_attention.cu``) behind a wrapper with a plain PyTorch twin and a
launch count (``paged_attention.launches``). The wrapper runs the plain
version only for tensors on the CPU; for CUDA tensors it launches the kernel
or raises. Layers with a sliding window, logit softcapping or attention sinks
take `paged_attention_ref`, the gather-based version, as in `hqq_tpu`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import _build
from .fused_matmul import _on_cpu, _ptr, _stream

__all__ = [
    "PagedKVCache",
    "init_paged_cache",
    "quant_rows",
    "write_token_to_pages",
    "paged_attention_ref",
    "paged_attention",
    "paged_attention_plain",
    "paged_attn",
]

# fewer (slot, head) pairs than this: `paged_attention` splits each slot's
# keys over more blocks (four per SM of an H100)
_MIN_BLOCKS = 528
# a split takes at least this many keys of the block table's capacity
_MIN_SPLIT_KEYS = 128
_MAX_HEAD_DIM = 256

_PAGE_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2, torch.int8: 3}


@dataclasses.dataclass
class PagedKVCache:
    """Pooled KV pages: k/v [L, n_kv_heads, num_pages, page_size, head_dim].

    With int8 pages, k_scales/v_scales hold the per-row absmax scales
    [L, H, P, pg, 1] in fp32. The pools are updated in place."""

    k: torch.Tensor
    v: torch.Tensor
    k_scales: Optional[torch.Tensor] = None
    v_scales: Optional[torch.Tensor] = None
    page_size: int = 16

    @property
    def num_pages(self) -> int:
        return self.k.shape[2]

    @property
    def quantized(self) -> bool:
        return self.k_scales is not None


def init_paged_cache(cfg, num_pages: int, page_size: int = 16, dtype=torch.bfloat16,
                     quantize_kv: bool = False, device="cuda") -> PagedKVCache:
    shape = (cfg.num_hidden_layers, cfg.num_key_value_heads, num_pages, page_size, cfg.head_dim_)
    if quantize_kv:
        sshape = shape[:-1] + (1,)
        return PagedKVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scales=torch.ones(sshape, dtype=torch.float32, device=device),
            v_scales=torch.ones(sshape, dtype=torch.float32, device=device),
            page_size=page_size,
        )
    return PagedKVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                        v=torch.zeros(shape, dtype=dtype, device=device), page_size=page_size)


def quant_rows(x: torch.Tensor):
    """Per-row int8 quantization (absmax over the last dim), rounding half
    to even. Returns (int8 codes, fp32 scales [..., 1])."""
    xf = x.to(torch.float32)
    scales = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8)
    w = torch.round(xf / scales * 127.0).to(torch.int8)
    return w, scales


def write_token_to_pages(cache: PagedKVCache, layer_idx: int, kb: torch.Tensor, vb: torch.Tensor,
                         page_of: torch.Tensor, offset: torch.Tensor) -> PagedKVCache:
    """Write one new K/V row per slot into its page, in place: kb/vb
    [B, H, hd], page_of/offset [B]. One `index_put_` per pool: the layer's
    pool [H, P, pg, hd] indexed by (all heads, page_of[b], offset[b]) takes
    the value [H, B, hd]. Rows that name the same (page, offset) may land in
    any order: only dead slots do, on scratch page 0."""
    heads = torch.arange(cache.k.shape[1], device=cache.k.device)[:, None]
    idx = (heads, page_of.long()[None, :], offset.long()[None, :])

    def put(pool, rows):
        pool[layer_idx].index_put_(idx, rows.transpose(0, 1).to(pool.dtype))

    if cache.quantized:
        kq, ks = quant_rows(kb)
        vq, vs = quant_rows(vb)
        put(cache.k, kq)
        put(cache.v, vq)
        put(cache.k_scales, ks)
        put(cache.v_scales, vs)
    else:
        put(cache.k, kb)
        put(cache.v, vb)
    return cache


def paged_attention_ref(
    q: torch.Tensor,  # [B, nh, hd] (pre-scaled)
    k_pages: torch.Tensor,  # [H, P, pg, hd]
    v_pages: torch.Tensor,
    lengths: torch.Tensor,  # [B] int
    page_indices: torch.Tensor,  # [B, MP] int
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    sinks: Optional[torch.Tensor] = None,  # [nh] attention sinks
) -> torch.Tensor:
    """Gather-based paged attention: the plain version of the kernel, and
    the route of layers with a window, a softcap or sinks. Scores and softmax
    in fp32; the probabilities are rounded to q's type before the second
    product."""
    b, nh, hd = q.shape
    h = k_pages.shape[0]
    mp, pg = page_indices.shape[1], k_pages.shape[2]
    s_max = mp * pg

    tab = page_indices.long()
    k_seq = k_pages[:, tab].permute(1, 0, 2, 3, 4).reshape(b, h, s_max, hd)
    v_seq = v_pages[:, tab].permute(1, 0, 2, 3, 4).reshape(b, h, s_max, hd)
    rep = nh // h
    if rep > 1:
        k_seq = k_seq.repeat_interleave(rep, dim=1)
        v_seq = v_seq.repeat_interleave(rep, dim=1)

    scores = torch.einsum("bhd,bhsd->bhs", q.to(torch.float32), k_seq.to(torch.float32))
    if softcap is not None:
        scores = torch.tanh(scores / softcap) * softcap
    neg = torch.finfo(torch.float32).min
    key_pos = torch.arange(s_max, device=q.device)[None, :]
    lens = lengths[:, None]
    valid = key_pos < lens  # [B, S]
    if window is not None:
        # the query sits at lengths - 1 (the row just written)
        valid = valid & (key_pos > (lens - 1 - window))
    scores = torch.where(valid[:, None, :], scores, neg)
    if sinks is not None:
        # a per-head sink logit joins the softmax; its mass is dropped
        sk = sinks.reshape(1, -1, 1).to(torch.float32)
        m = torch.maximum(scores.amax(dim=-1, keepdim=True), sk)
        num = torch.exp(scores - m)
        den = num.sum(dim=-1, keepdim=True) + torch.exp(sk - m)
        probs = (num / den).to(q.dtype)
    else:
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
    dt = torch.promote_types(probs.dtype, v_seq.dtype)
    return torch.einsum("bhs,bhsd->bhd", probs.to(dt), v_seq.to(dt))


def _dequant_pages(pages: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    return pages.to(torch.float32) * (scales / 127.0)


def paged_attention_plain(q, k_pages, v_pages, lengths, page_indices, k_scales=None,
                          v_scales=None) -> torch.Tensor:
    """Plain version of the paged_attention kernel: `paged_attention_ref` on
    the pages as they are, or on int8 pages dequantized in fp32 (rows times
    scale / 127) with q in fp32."""
    if k_scales is not None:
        k_pages = _dequant_pages(k_pages, k_scales)
        v_pages = _dequant_pages(v_pages, v_scales)
        q = q.to(torch.float32)
    return paged_attention_ref(q, k_pages, v_pages, lengths, page_indices)


def paged_attention(q, k_pages, v_pages, lengths, page_indices, k_scales=None,
                    v_scales=None) -> torch.Tensor:
    """Plain-causal decode attention over paged K/V: q [B, nh, hd]
    (pre-scaled), pages [H, P, pg, hd], lengths [B], page_indices [B, MP]
    -> [B, nh, hd] in q's type. Float pages (bf16, fp16, fp32) take q of
    their own type; int8 pages take their scales [H, P, pg, 1] and q in fp32.
    A slot of length 0 gets zeros (the plain version averages V over the
    masked keys there; no caller passes it)."""
    if _on_cpu(q):
        return paged_attention_plain(q, k_pages, v_pages, lengths, page_indices, k_scales,
                                     v_scales)
    dev = q.device
    b, nh, hd = q.shape
    h, num_pages, pg, _ = k_pages.shape
    mp = page_indices.shape[1]
    quantized = k_scales is not None
    if k_pages.dtype not in _PAGE_DTYPE_CODE or (k_pages.dtype == torch.int8) != quantized:
        raise ValueError(f"pages must be bf16, fp16 or fp32, or int8 with scales; got "
                         f"{k_pages.dtype}, scales {'given' if quantized else 'missing'}")
    want_q = torch.float32 if quantized else k_pages.dtype
    if q.dtype != want_q:
        raise ValueError(f"{k_pages.dtype} pages take q in {want_q}, not {q.dtype}")
    if v_pages.shape != k_pages.shape or v_pages.dtype != k_pages.dtype or k_pages.shape[3] != hd:
        raise ValueError(f"k/v pages must both be [H, P, pg, {hd}] of one type")
    if nh % h or hd % 4 or hd > _MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes nh a multiple of H and head_dim a multiple of 4 up "
                         f"to {_MAX_HEAD_DIM}; got nh={nh}, H={h}, head_dim={hd}")
    if tuple(lengths.shape) != (b,) or page_indices.shape[0] != b:
        raise ValueError("lengths must be [B] and page_indices [B, MP]")
    if quantized and (v_scales is None or k_scales.numel() != h * num_pages * pg
                      or v_scales.numel() != h * num_pages * pg
                      or k_scales.dtype != torch.float32 or v_scales.dtype != torch.float32):
        raise ValueError(f"int8 pages need fp32 k/v scales [{h}, {num_pages}, {pg}, 1]")
    q = q.contiguous()
    pools = [k_pages, v_pages] + ([k_scales, v_scales] if quantized else [])
    for t in pools:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"kernel operands must be contiguous on {dev}")
    lengths = lengths.to(device=dev, dtype=torch.int32).contiguous()
    page_indices = page_indices.to(device=dev, dtype=torch.int32).contiguous()

    # few (slot, head) pairs: split each slot's keys over blocks; a split
    # writes an fp32 partial that the library's second kernel merges
    splits = max(1, min(_MIN_BLOCKS // (b * nh), mp * pg // _MIN_SPLIT_KEYS))
    part = (torch.empty((b, nh, splits, hd + 2), dtype=torch.float32, device=dev)
            if splits > 1 else None)
    out = torch.empty_like(q)
    lib = _build.library("paged_attention")
    with torch.cuda.device(dev):
        code = lib.hqq_paged_attention(
            _ptr(q), _ptr(k_pages), _ptr(v_pages),
            _ptr(k_scales, 4) if quantized else None, _ptr(v_scales, 4) if quantized else None,
            _ptr(lengths, 4), _ptr(page_indices, 4), _ptr(out), None if part is None else
            _ptr(part, 4), b, nh, h, hd, num_pages, pg, mp, splits,
            _PAGE_DTYPE_CODE[k_pages.dtype], _stream(dev),
        )
    _build.check("paged_attention", code)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0


def paged_attn(
    q: torch.Tensor,
    cache: PagedKVCache,
    layer_idx: int,
    lengths: torch.Tensor,
    page_indices: torch.Tensor,
    pages_per_block: int = 4,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    sinks: Optional[torch.Tensor] = None,
    seq_axis: Optional[str] = None,
) -> torch.Tensor:
    """Dispatch as `hqq_tpu.ops.paged.paged_attn`: the `paged_attention`
    kernel for a plain-causal layer (any head size the kernel takes;
    ``pages_per_block`` belonged to the TPU kernel and is ignored), the
    gather-based `paged_attention_ref` for window, softcap and sink layers.
    With int8 pages q goes in fp32. ``seq_axis`` (a page pool sharded over
    devices) is not ported yet."""
    if seq_axis is not None:
        raise NotImplementedError("sequence-parallel paged attention is not ported yet")
    k_pages, v_pages = cache.k[layer_idx], cache.v[layer_idx]
    ks = None if cache.k_scales is None else cache.k_scales[layer_idx]
    vs = None if cache.v_scales is None else cache.v_scales[layer_idx]
    if window is None and softcap is None and sinks is None:
        if ks is not None:
            q = q.to(torch.float32)
        return paged_attention(q, k_pages, v_pages, lengths, page_indices, ks, vs)
    if ks is not None:
        k_pages = _dequant_pages(k_pages, ks)
        v_pages = _dequant_pages(v_pages, vs)
        q = q.to(torch.float32)
    return paged_attention_ref(q, k_pages, v_pages, lengths, page_indices, window=window,
                               softcap=softcap, sinks=sinks)
