# SPDX-License-Identifier: Apache-2.0
"""Paged KV-cache primitives: pooled pages, per-token writes, paged attention.

Mirrors `hqq_tpu.ops.paged`. Pages live in one stacked pool
``[L, H, num_pages, page_size, hd]`` that is updated in place (one
`index_put_` per pool per token); with ``quantize_kv`` the pages are int8 with
one fp32 absmax scale per row ``[L, H, P, pg, 1]``. Model forwards take a
`PagedKVCache` wherever they take a dense `KVCache`.

Decode attention over a plain-causal layer is the `paged_attention` kernel
(``csrc/paged_attention.cu``: one block per slot, kv head and split, whole
pages by bulk copy into an mbarrier ring; its launch plan is
`paged_launch_plan`) behind a wrapper with a plain PyTorch twin and a launch
count (``paged_attention.launches``). The wrapper runs the plain version only
for tensors on the CPU; for CUDA tensors it launches the kernel or raises.
Layers with a sliding window, logit softcapping or attention sinks take
`paged_attention_ref`, the gather-based version, as in `hqq_tpu`.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from . import _build
from .fused_matmul import H100_SMEM_PER_BLOCK, _on_cpu, _ptr, _stream

__all__ = [
    "PagedKVCache",
    "init_paged_cache",
    "quant_rows",
    "write_token_to_pages",
    "paged_attention_ref",
    "paged_attention",
    "paged_attention_plain",
    "paged_attn",
    "PagedPlan",
    "paged_launch_plan",
    "paged_smem_bytes",
]

# an H100's SMs, each with 228 KB of shared memory (1 KB of it reserved per
# block), and the consumer warps an SM should hold: fewer (slot, kv head)
# blocks than fill them and `paged_attention` splits each slot's pages over
# more blocks
_SMS, _SM_SMEM, _SM_WARPS = 132, 233472, 16
# a split takes at least this many keys of the block table's capacity
_MIN_SPLIT_KEYS = 128
_MAX_HEAD_DIM = 256

_PAGE_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2, torch.int8: 3}
_PAGE_BYTES = {torch.float32: 4, torch.bfloat16: 2, torch.float16: 2, torch.int8: 1}
# the geometry of csrc/paged_attention.cu: rows a stage holds at least, and
# the ring's bytes a block aims to keep in flight; shared memory that lets
# two blocks share an SM
PAGED_STAGE_ROWS = 16
PAGED_RING_BYTES = 32768
_TWO_BLOCKS_SMEM = 113 * 1024


def _align16(x: int) -> int:
    return (x + 15) // 16 * 16


def _paged_stage_bytes(row_bytes: int, page_size: int, pages_per_stage: int,
                       quantized: bool) -> int:
    run = _align16(pages_per_stage * page_size * row_bytes)
    return 2 * run + (2 * _align16(pages_per_stage * page_size * 4) if quantized else 0)


def paged_smem_bytes(row_bytes: int, page_size: int, pages_per_stage: int, stages: int,
                     quantized: bool, heads_per_block: int, head_dim: int, warps: int) -> int:
    """Dynamic shared memory of one block (`paged_smem` of
    paged_attention.cu): ``stages`` slots of K's and V's pages (and, for
    int8, their scale runs), each part rounded up to 16 bytes; the warps'
    merge area, which reuses the ring; an mbarrier pair per slot."""
    stage = _paged_stage_bytes(row_bytes, page_size, pages_per_stage, quantized)
    merge = warps * heads_per_block * (head_dim + 2) * 4
    return _align16(max(stages * stage, merge)) + 16 * stages


@dataclasses.dataclass(frozen=True)
class PagedPlan:
    """How `paged_attention` launches: blocks of ``warps`` consumer warps
    and a producer warp, one per (slot, kv head, group of
    ``heads_per_block`` query heads, split of ``splits``). ``bulk``: pages
    (and int8 scale runs) by bulk copy, else by 4-byte cp.async; ``vec16``:
    rows of whole 16-byte vectors (else the consumers read four words and
    zero those past the row); a row takes ``2**lanes_log2`` lanes (each two
    vectors where a row has more than 32, fp32 only); a stage holds
    ``pages_per_stage`` pages, the ring ``stages`` slots (slot s to warp
    s % warps), ``smem`` bytes."""

    bulk: bool
    vec16: bool
    lanes_log2: int
    heads_per_block: int
    pages_per_stage: int
    stages: int
    warps: int
    splits: int
    smem: int


@functools.lru_cache(maxsize=1024)
def paged_launch_plan(batch: int, heads: int, kv_heads: int, head_dim: int, page_size: int,
                      max_pages: int, page_dtype: torch.dtype) -> PagedPlan:
    """The launch of the paged kernel for q [batch, heads, head_dim] over
    pages [kv_heads, P, page_size, head_dim] of ``page_dtype`` and a block
    table [batch, max_pages], decided by these shapes alone.

    A block serves the most of 4, 2 or 1 query heads (2 or 1 for int8)
    that divides heads / kv_heads, so each page is read once for all of them
    (twice at int8 with four or more heads a kv head). A stage holds whole
    pages, at least 16 rows. Bulk copies need 16-byte sizes and addresses: a
    page of page_size * head_dim elements, and for int8 a run of page_size
    fp32 scales; other pages go by cp.async. A block has 8 consumer warps,
    or fewer where a ring slot each would keep two blocks off an SM; each
    warp owns one slot, or two where one each holds less than
    PAGED_RING_BYTES (on the card eight warps with a slot each beat four
    with two). Where the blocks would not fill
    the card (16 consumer warps an SM, as many blocks as its shared memory
    holds), each slot's stages are split over more blocks, each split taking
    at least 128 keys of the table's capacity; a split costs a second kernel
    that merges the splits' fp32 partials."""
    if page_dtype not in _PAGE_BYTES:
        raise ValueError(f"pages must be fp32, bf16, fp16 or int8, not {page_dtype}")
    if heads % kv_heads:
        raise ValueError(f"heads {heads} must be a multiple of kv heads {kv_heads}")
    if head_dim % 4 or not 4 <= head_dim <= _MAX_HEAD_DIM or page_size < 1 or max_pages < 1:
        raise ValueError(f"the kernel takes head sizes of 4s up to {_MAX_HEAD_DIM}; got "
                         f"head_dim={head_dim}, page_size={page_size}, max_pages={max_pages}")
    quantized = page_dtype == torch.int8
    row_bytes = head_dim * _PAGE_BYTES[page_dtype]
    vectors = -(-row_bytes // 16)
    lanes_log2 = min(5, (vectors - 1).bit_length())
    bulk = page_size * row_bytes % 16 == 0 and (not quantized or page_size % 4 == 0)
    rep = heads // kv_heads
    # int8 rows give a lane 16 columns: four heads' q and sums would spill
    qh = next(d for d in ((2, 1) if quantized else (4, 2, 1)) if rep % d == 0)
    pps = max(1, PAGED_STAGE_ROWS // page_size)
    stage = _paged_stage_bytes(row_bytes, page_size, pps, quantized)

    def smem(stages, warps):
        return paged_smem_bytes(row_bytes, page_size, pps, stages, quantized, qh, head_dim,
                                warps)

    warps = next((w for w in (8, 4, 2) if smem(w, w) <= _TWO_BLOCKS_SMEM), 1)
    stages = warps * (2 if warps * stage < PAGED_RING_BYTES else 1)
    if smem(stages, warps) > _TWO_BLOCKS_SMEM:
        stages = warps
    while stages > 1 and smem(stages, warps) > H100_SMEM_PER_BLOCK:
        stages -= 1
    if smem(stages, warps) > H100_SMEM_PER_BLOCK:
        raise ValueError(f"a page of {page_size} x {head_dim} {page_dtype} does not fit a block")
    pairs = batch * kv_heads * (rep // qh)
    per_sm = max(1, min(_SM_WARPS // warps, _SM_SMEM // (smem(stages, warps) + 1024)))
    min_stages = -(-_MIN_SPLIT_KEYS // (pps * page_size))
    splits = max(1, min(_SMS * per_sm // pairs, -(-max_pages // pps) // min_stages))
    return PagedPlan(bulk=bulk, vec16=row_bytes % 16 == 0, lanes_log2=lanes_log2,
                     heads_per_block=qh, pages_per_stage=pps, stages=stages, warps=warps,
                     splits=splits, smem=smem(stages, warps))


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

    plan = paged_launch_plan(b, nh, h, hd, pg, mp, k_pages.dtype)
    # few (slot, kv head) blocks: each slot's pages split over more blocks;
    # a split writes an fp32 partial that the library's second kernel merges
    part = (torch.empty((b, nh, plan.splits, hd + 2), dtype=torch.float32, device=dev)
            if plan.splits > 1 else None)
    out = torch.empty_like(q)
    pool_align = 16 if plan.bulk else 4  # a bulk copy's addresses are 16-byte aligned
    lib = _build.library("paged_attention")
    with torch.cuda.device(dev):
        code = lib.hqq_paged_attention(
            _ptr(q, 4), _ptr(k_pages, pool_align), _ptr(v_pages, pool_align),
            _ptr(k_scales, pool_align) if quantized else None,
            _ptr(v_scales, pool_align) if quantized else None,
            _ptr(lengths, 4), _ptr(page_indices, 4), _ptr(out, 4), None if part is None else
            _ptr(part, 4), b, nh, h, hd, num_pages, pg, mp, plan.splits,
            _PAGE_DTYPE_CODE[k_pages.dtype], int(plan.bulk), int(plan.vec16), plan.lanes_log2,
            plan.pages_per_stage, plan.stages, plan.warps, plan.heads_per_block, plan.smem,
            _stream(dev),
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
