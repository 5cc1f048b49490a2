# SPDX-License-Identifier: Apache-2.0
"""Continuous batching over a paged KV pool: block-table KV cache and the
paged-attention kernel.

Mirrors `hqq_tpu.serving.paged`. KV memory is handed out in fixed-size pages
from one shared pool, each request with its own block table:

* the pages live in one stacked pool ``[L, H, num_pages, page_size, hd]``
  that every write updates in place;
* decode attention is the `paged_attention` kernel (`ops.paged`), one launch
  per layer and step for all slots;
* prefill runs the dense forward into a batch-1 mini cache, which is then
  copied into the request's pages;
* the page allocator on the host is a free list; a request is admitted when
  its worst-case page budget is free (no preemption);
* optional: int8 pages, a prefix cache over content-hashed prompt pages
  (reference counts, LRU eviction), chunked prefill, a horizon of several
  decode steps with no read-back between them;
* multi-LoRA, as the dense engine (`serving.batching`): every prefill,
  chunk and decode step runs under `adapter_context`, the prefix cache's
  keys start from the adapter id;
* ``inputs_embeds`` requests (vision-language serving): the prefill runs
  over the prompt's embeddings, cast to the pool's float type. They
  bypass the prefix cache, whose page keys hash token ids (the same
  placeholders would alias different images), and chunked prefill; a
  token request and an embeds request share a step.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..models import llama
from ..nn.multilora import adapter_context
from ..ops.paged import PagedKVCache, init_paged_cache, paged_attention_ref, quant_rows
from ..utils.profiling import log_event
from .batching import (Request, _checked_adapter, _checked_embeds, _checked_request,
                       _default_embeds_forward, _effective_sampling, _embeds_rows,
                       _refuse_embeds_without_forward, refuse_own_cache)
from .generate import next_power_of_2, sample_token, sample_token_batch

__all__ = ["PagedKVCache", "PagedBatchingEngine", "paged_attention_ref", "init_paged_cache",
           "paged_decode_step", "splice_prefill_into_pages"]


def paged_decode_step(params: dict, cfg, tokens: torch.Tensor, cache: PagedKVCache,
                      lengths: torch.Tensor, page_indices: torch.Tensor,
                      pages_per_block: int = 4, forward_fn=None):
    """One decode step for all slots over the paged pool: tokens [B],
    lengths [B] (the position of each new token), page_indices [B, MP].
    Goes through the family forward's paged branch (`llama.forward` by
    default; ``forward_fn`` for another family). ``pages_per_block`` belonged
    to the TPU kernel and is ignored. Returns (logits [B, V], cache)."""
    fwd = forward_fn or (
        lambda p, toks, c, lens, ptab: llama.forward(p, cfg, toks, c, lens, page_indices=ptab)
    )
    logits, cache = fwd(params, tokens[:, None], cache, lengths, page_indices)
    return logits[:, -1], cache


def splice_prefill_into_pages(cache: PagedKVCache, mini: llama.KVCache, pages: List[int],
                              t_real: int, start_tok: int = 0) -> PagedKVCache:
    """Copy a dense prefill mini cache [L, 1, H, T_pad, hd] into ``pages``
    of the pool, in place: one indexed write per pool for all the pages.

    ``start_tok`` (a page multiple) skips the leading tokens: with the
    prefix cache the leading pages already lie in the pool."""
    pg = cache.page_size
    if start_tok % pg:
        raise ValueError("start_tok must be a multiple of the page size")
    n = -(-(t_real - start_tok) // pg)
    if n <= 0:
        return cache
    idx = torch.as_tensor(pages[:n], dtype=torch.long, device=cache.k.device)

    def rows(dense):  # [L, 1, H, T, hd] -> [L, H, n, pg, hd]
        chunk = dense[:, 0, :, start_tok:start_tok + n * pg]
        return chunk.reshape(chunk.shape[0], chunk.shape[1], n, pg, chunk.shape[-1])

    if cache.quantized:
        kq, ks = quant_rows(rows(mini.k))
        vq, vs = quant_rows(rows(mini.v))
        cache.k[:, :, idx] = kq
        cache.v[:, :, idx] = vq
        cache.k_scales[:, :, idx] = ks
        cache.v_scales[:, :, idx] = vs
    else:
        cache.k[:, :, idx] = rows(mini.k).to(cache.k.dtype)
        cache.v[:, :, idx] = rows(mini.v).to(cache.v.dtype)
    return cache


class PagedBatchingEngine:
    """Continuous batching over a paged KV pool: add_request / step / run."""

    def __init__(
        self,
        params: Any,
        cfg: Any,
        batch_slots: int = 8,
        num_pages: int = 512,
        page_size: int = 16,
        max_pages_per_seq: int = 64,  # a multiple of 4, as in `hqq_tpu`
        eos_token_id: Optional[int] = None,
        do_sample: bool = False,
        top_k: int = 20,
        top_p: float = 1.0,
        temperature: float = 0.6,
        cache_dtype=torch.bfloat16,
        quantize_kv: bool = False,
        seed: int = 0,
        horizon: int = 1,
        forward_fn=None,
        embeds_forward_fn=None,
        enable_prefix_cache: bool = False,
        prefill_chunk: "int | None" = None,
        device="cuda",
    ):
        """forward_fn: where another family's forward goes in. Signature:
        (params, tokens [B, T], cache, start_pos, page_indices) -> (logits,
        cache); called with a dense mini cache (page_indices=None) for
        prefill and with the `PagedKVCache` for decode. Defaults to the
        Llama-family forward.

        enable_prefix_cache: full prompt pages are content-hashed; a new
        request whose prompt shares a page-aligned prefix with a cached one
        reuses those pages and prefills only its suffix. Cached pages are
        reference-counted and LRU-evicted when the free list runs dry.

        prefill_chunk: long prompts prefill in chunks of this many tokens,
        one chunk per `step()`, between the decode steps of the live slots.

        horizon: that many decode steps per `step()` with no read-back
        between them; the same tokens as single steps.

        embeds_forward_fn: (params, embeds [1, T, D], mini cache,
        start_pos) -> (logits, cache), the prefill of an ``inputs_embeds``
        request; defaults to the Llama forward over the embeddings, and
        with a custom ``forward_fn`` must be given for such requests.

        A family with a dense cache of its own (DeepSeek-V3) is refused
        (`refuse_own_cache`)."""
        refuse_own_cache("PagedBatchingEngine", cfg)
        self.params = params
        self.cfg = cfg
        self.device = torch.device(device)
        self._fwd = forward_fn or (
            lambda p, toks, cache, pos, ptab=None: llama.forward(
                p, cfg, toks, cache, pos, page_indices=ptab)
        )
        self._efwd = _default_embeds_forward(cfg, forward_fn, embeds_forward_fn)
        self.s = batch_slots
        self.pg = page_size
        if max_pages_per_seq % 4:
            raise ValueError("max_pages_per_seq must be a multiple of 4")
        self.mp = max_pages_per_seq
        self.eos = eos_token_id
        self.do_sample = do_sample
        self.top_k = top_k
        self.top_p = top_p
        self.temperature = temperature

        self.cache = init_paged_cache(cfg, num_pages, page_size, cache_dtype,
                                      quantize_kv=quantize_kv, device=self.device)
        self._mini_dtype = cache_dtype  # the prefill mini cache stays float
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

        # page 0 is a scratch page: dead slots' block tables point at it, so
        # their (ignored) decode writes never touch a live request's pages
        self.free_pages = deque(range(1, num_pages))
        self.slot_pages: List[List[int]] = [[] for _ in range(batch_slots)]
        # block table; unallocated entries point at page 0 (never read: the
        # kernel stops at each slot's length)
        self._page_tab = np.zeros((batch_slots, max_pages_per_seq), np.int32)

        self.queue: deque[Request] = deque()
        self.active: Dict[int, Request] = {}
        self.finished: Dict[int, Request] = {}
        self._uid = 0
        self._tokens = np.zeros((batch_slots,), np.int32)
        self._pos = np.zeros((batch_slots,), np.int32)
        self._live = np.zeros((batch_slots,), bool)
        self._adapter = np.zeros((batch_slots,), np.int64)  # each slot's adapter id
        # per-slot sampling parameters [4, S]: do_sample/top_k/temperature/top_p
        self._samp = np.zeros((4, batch_slots), np.float32)
        self._samp[0] = 1.0 if do_sample else 0.0
        self._samp[1] = top_k
        self._samp[2] = temperature
        self._samp[3] = top_p

        # prefix cache: chain digest -> page id, in LRU order
        self._prefix_cache: "OrderedDict[bytes, int] | None" = (
            OrderedDict() if enable_prefix_cache else None
        )
        self._page_ref: Dict[int, int] = {}  # cached page -> active users
        self._page_key: Dict[int, bytes] = {}
        self._slot_cached: List[List[int]] = [[] for _ in range(batch_slots)]
        self.prefix_cache_hits = 0  # pages reused

        self.prefill_chunk = prefill_chunk
        # slots in the middle of a chunked prefill (occupied, not live)
        self._prefilling: Dict[int, dict] = {}

        self.horizon = max(1, int(horizon))

    def close(self):
        """Drop the page pool and the parameters. Idempotent."""
        self.__dict__.pop("_fwd", None)
        self.__dict__.pop("_efwd", None)
        self.cache = None
        self.params = None

    # -- device steps ----------------------------------------------------------
    def _prefill(self, tokens: np.ndarray, mini: llama.KVCache, start_pos: int,
                 adapter_id: int = 0):
        toks = torch.from_numpy(tokens.astype(np.int64)).to(self.device)
        with adapter_context(torch.tensor([adapter_id], device=self.device)):
            return self._fwd(self.params, toks, mini, int(start_pos))

    def _load_prefix(self, mini: llama.KVCache, pages: List[int]) -> llama.KVCache:
        """Gather cached prefix pages into rows [0, n*pg) of the dense mini
        cache, in place (int8 pools are dequantized on the way)."""
        cache = self.cache
        idx = torch.as_tensor(pages, dtype=torch.long, device=self.device)
        k = cache.k[:, :, idx]  # [L, H, n, pg, hd]
        v = cache.v[:, :, idx]
        if cache.quantized:
            k = k.to(torch.float32) * (cache.k_scales[:, :, idx] / 127.0)
            v = v.to(torch.float32) * (cache.v_scales[:, :, idx] / 127.0)
        n_rows = len(pages) * cache.page_size
        lyr, heads, hd = k.shape[0], k.shape[1], k.shape[-1]
        mini.k[:, 0, :, :n_rows] = k.reshape(lyr, heads, n_rows, hd).to(mini.k.dtype)
        mini.v[:, 0, :, :n_rows] = v.reshape(lyr, heads, n_rows, hd).to(mini.v.dtype)
        return mini

    def _decode(self, steps: int) -> np.ndarray:
        """``steps`` paged decode steps for all slots, the tokens read back
        once at the end: [steps, S]."""
        dev = self.device
        tok = torch.from_numpy(self._tokens.astype(np.int64)).to(dev)
        lengths = torch.from_numpy(self._pos.astype(np.int64)).to(dev)
        page_tab = torch.from_numpy(self._page_tab).to(dev)
        samp = torch.from_numpy(self._samp).to(dev)
        out = []
        with adapter_context(torch.from_numpy(self._adapter).to(dev)):
            for _ in range(steps):
                logits, self.cache = self._fwd(self.params, tok[:, None], self.cache, lengths,
                                               page_tab)
                tok = sample_token_batch(logits[:, -1], self._gen, samp[0] > 0.5,
                                         samp[1].to(torch.int64), samp[2], samp[3])
                lengths = lengths + 1
                out.append(tok)
        return torch.stack(out).cpu().numpy()

    # -- scheduling on the host --------------------------------------------------
    def add_request(self, prompt_ids, max_new_tokens: int = 128,
                    inputs_embeds=None, adapter_id: int = 0,
                    do_sample: Optional[bool] = None,
                    top_k: Optional[int] = None,
                    top_p: Optional[float] = None,
                    temperature: Optional[float] = None,
                    stop_token_ids: Optional[List[int]] = None) -> int:
        """Queue a request; returns its uid. do_sample / top_k / top_p /
        temperature / stop_token_ids are per-request (None = the engine's
        defaults). ``adapter_id`` picks the multi-LoRA adapter (0: none);
        prefix-cache pages are shared only within one adapter, whose LoRA
        changes their K/V. ``inputs_embeds`` [len(prompt), D]: the prompt's
        embeddings (image rows spliced over the placeholders), prefilled
        unchunked and outside the prefix cache. Ids outside the vocabulary,
        an adapter id outside the tree's stacks, embeddings of another shape
        and embeddings on an engine with no embeds forward raise a
        ValueError here, before any step."""
        sampled = self.do_sample if do_sample is None else bool(do_sample)
        prompt = _checked_request(prompt_ids, top_k if sampled else None, self.cfg.vocab_size)
        adapter_id = _checked_adapter(adapter_id, self.params)
        embeds = _checked_embeds(inputs_embeds, len(prompt), self.cfg.hidden_size)
        if embeds is not None:
            _refuse_embeds_without_forward(self._efwd)
        t_pad = next_power_of_2(max(len(prompt), 2))
        need = -(-(len(prompt) + max_new_tokens) // self.pg)
        if need > self.mp or -(-t_pad // self.pg) > self.mp:
            raise ValueError(
                f"request needs {need} pages (> max_pages_per_seq={self.mp}); "
                f"raise max_pages_per_seq or shorten prompt/max_new_tokens"
            )
        self._uid += 1
        self.queue.append(
            Request(uid=self._uid, prompt=prompt, max_new_tokens=max_new_tokens,
                    adapter_id=adapter_id, do_sample=do_sample, top_k=top_k, top_p=top_p,
                    temperature=temperature,
                    stop_token_ids=list(stop_token_ids) if stop_token_ids else None,
                    embeds=embeds)
        )
        return self._uid

    def _pages_needed(self, req: Request) -> int:
        return min(-(-(len(req.prompt) + req.max_new_tokens) // self.pg), self.mp)

    # -- prefix cache ------------------------------------------------------------
    def _prefix_keys(self, prompt: np.ndarray, adapter_id: int = 0) -> list:
        """Chain digests of the prompt's cacheable full pages. The page that
        holds the last prompt token is never cached: decode writes into it
        when the prompt is not page-aligned, and when it is, the last token
        must still run to give logits. The chain starts from the adapter id,
        as in `hqq_tpu`."""
        t, pg = len(prompt), self.pg
        full = t // pg
        if full * pg == t:
            full -= 1
        keys, h = [], b"adapter:%d" % adapter_id
        for j in range(max(full, 0)):
            h = hashlib.sha1(h + prompt[j * pg: (j + 1) * pg].tobytes()).digest()
            keys.append(h)
        return keys

    def _evictable(self) -> int:
        if self._prefix_cache is None:
            return 0
        return sum(1 for p in self._prefix_cache.values() if self._page_ref.get(p, 0) == 0)

    def _free_capacity(self) -> int:
        return len(self.free_pages) + self._evictable()

    def _evict_for(self, need: int) -> None:
        """LRU-evict unreferenced cached pages until ``need`` pages are free."""
        if self._prefix_cache is None:
            return
        for key in list(self._prefix_cache):
            if len(self.free_pages) >= need:
                break
            page = self._prefix_cache[key]
            if self._page_ref.get(page, 0) == 0:
                del self._prefix_cache[key]
                self._page_ref.pop(page, None)
                self._page_key.pop(page, None)
                self.free_pages.append(page)

    def _admit(self, slot: int, req: Request) -> None:
        need = self._pages_needed(req)
        t = len(req.prompt)
        ds, tk, tmp, tp = _effective_sampling(
            req, self.do_sample, self.top_k, self.temperature, self.top_p)
        self._samp[:, slot] = (1.0 if ds else 0.0, tk, tmp, tp)
        self._adapter[slot] = req.adapter_id

        # the longest cached page-aligned prefix (leading hits only). An
        # embeds request never takes part: the keys hash token ids, and the
        # same placeholders would alias requests with different images
        shared: List[int] = []
        keys: list = []
        if self._prefix_cache is not None and req.embeds is None:
            keys = self._prefix_keys(req.prompt, req.adapter_id)
            for key in keys:
                page = self._prefix_cache.get(key)
                if page is None:
                    break
                shared.append(page)
                self._prefix_cache.move_to_end(key)  # LRU touch
        n_shared = len(shared)
        self.prefix_cache_hits += n_shared

        self._evict_for(need - n_shared)
        pages_new = [self.free_pages.popleft() for _ in range(need - n_shared)]
        pages = shared + pages_new
        for p in shared:
            self._page_ref[p] = self._page_ref.get(p, 0) + 1
        self.slot_pages[slot] = pages
        self._slot_cached[slot] = list(shared)
        # filler entries point at the scratch page 0
        self._page_tab[slot, :] = 0
        self._page_tab[slot, : len(pages)] = pages

        s0 = n_shared * self.pg  # the first token that must really run
        t_suf = t - s0
        t_pad_total = next_power_of_2(max(t_suf, 2))
        # the prefill must fit the allocated pages: pad to a page multiple
        t_cache = s0 + -(-t_pad_total // self.pg) * self.pg
        mini = llama.init_cache(self.cfg, 1, t_cache, self._mini_dtype, self.device)
        if n_shared:
            mini = self._load_prefix(mini, shared)

        if self.prefill_chunk is not None and t_suf > self.prefill_chunk and req.embeds is None:
            # chunked prefill: one chunk per step(), between decode steps.
            # The block table stays on the scratch page until the slot goes
            # live, so other slots' dead writes cannot touch these pages.
            self._prefilling[slot] = dict(
                req=req, mini=mini, t=t, s0=s0, done=s0,
                pages=pages, pages_new=pages_new, keys=keys, n_shared=n_shared,
            )
            self._page_tab[slot, :] = 0
            self._advance_prefill(slot)  # the first chunk now
            return

        if req.embeds is not None:  # s0 = 0: no prefix was shared
            emb = _embeds_rows(req.embeds, t_pad_total, self._mini_dtype, self.device)
            with adapter_context(torch.tensor([req.adapter_id], device=self.device)):
                logits, mini = self._efwd(self.params, emb, mini, 0)
        else:
            suffix = np.zeros((1, t_pad_total), np.int32)
            suffix[0, :t_suf] = req.prompt[s0:]
            logits, mini = self._prefill(suffix, mini, s0, req.adapter_id)
        self._finish_prefill(slot, req, mini, logits, t_suf - 1, t, s0,
                             pages, pages_new, keys, n_shared)

    def _finish_prefill(self, slot, req, mini, logits, first_idx, t, s0,
                        pages, pages_new, keys, n_shared):
        """Copy the finished prefill into pages, register the prompt's
        cacheable pages, sample the first token, set the slot live."""
        self.cache = splice_prefill_into_pages(self.cache, mini, pages_new, t, start_tok=s0)
        # register this prompt's own full pages for reuse, only now that
        # their KV lies in the pool
        if self._prefix_cache is not None:
            for j in range(n_shared, len(keys)):
                key, page = keys[j], pages[j]
                if key not in self._prefix_cache:
                    self._prefix_cache[key] = page
                    self._page_key[page] = key
                    self._page_ref[page] = self._page_ref.get(page, 0) + 1
                    self._slot_cached[slot].append(page)

        self._page_tab[slot, :] = 0
        self._page_tab[slot, : len(pages)] = pages

        ds, tk, tmp, tp = _effective_sampling(
            req, self.do_sample, self.top_k, self.temperature, self.top_p)
        first = int(sample_token(logits[:, first_idx], self._gen, ds, tk, tmp, tp)[0])
        log_event("request_admitted", uid=req.uid, slot=slot, prompt_len=t,
                  pages=len(pages), prefix_pages_reused=n_shared)
        req.slot = slot
        req.output = [first]
        self.active[slot] = req
        self._tokens[slot] = first
        self._pos[slot] = t
        self._live[slot] = True
        self._maybe_finish(slot)

    def _advance_prefill(self, slot: int) -> None:
        """Run one prefill chunk of a pending slot; set it live when done."""
        st = self._prefilling[slot]
        req, t = st["req"], st["t"]
        start = st["done"]
        n = min(self.prefill_chunk, t - start)
        t_pad = next_power_of_2(max(n, 2))
        buf = np.zeros((1, t_pad), np.int32)
        buf[0, :n] = req.prompt[start: start + n]
        logits, st["mini"] = self._prefill(buf, st["mini"], start, req.adapter_id)
        st["done"] = start + n
        if st["done"] >= t:
            del self._prefilling[slot]
            self._finish_prefill(
                slot, req, st["mini"], logits, n - 1, t, st["s0"],
                st["pages"], st["pages_new"], st["keys"], st["n_shared"],
            )

    def _release(self, slot: int) -> None:
        cached = set(self._slot_cached[slot])
        for p in self.slot_pages[slot]:
            if p in cached:
                # stays in the pool as a reusable prefix; evicted only when
                # the free list runs dry and nobody references it
                self._page_ref[p] = max(self._page_ref.get(p, 1) - 1, 0)
            else:
                self.free_pages.append(p)
        self.slot_pages[slot] = []
        self._slot_cached[slot] = []
        self._page_tab[slot, :] = 0
        self._pos[slot] = 0
        self._tokens[slot] = 0

    def _maybe_finish(self, slot: int) -> None:
        req = self.active.get(slot)
        if req is None:
            return
        last = req.output[-1] if req.output else None
        out_of_pages = int(self._pos[slot]) + 1 >= len(self.slot_pages[slot]) * self.pg
        if (
            (self.eos is not None and last == self.eos)
            or (req.stop_token_ids and last in req.stop_token_ids)
            or len(req.output) >= req.max_new_tokens
            or out_of_pages
        ):
            log_event("request_finished", uid=req.uid, slot=slot, n_tokens=len(req.output))
            req.done = True
            self.finished[req.uid] = req
            del self.active[slot]
            self._live[slot] = False
            self._release(slot)

    def cancel(self, uid: int) -> bool:
        """Cancel a queued or running request; a running one gives its
        pages back at once. Returns True if it was found."""
        for i, req in enumerate(self.queue):
            if req.uid == uid:
                del self.queue[i]
                req.done = True
                self.finished[uid] = req
                return True
        for slot, req in list(self.active.items()):
            if req.uid == uid:
                req.done = True
                self.finished[uid] = req
                del self.active[slot]
                self._live[slot] = False
                self._release(slot)
                return True
        for slot, st in list(self._prefilling.items()):
            if st["req"].uid == uid:
                st["req"].done = True
                self.finished[uid] = st["req"]
                del self._prefilling[slot]
                self._release(slot)
                return True
        return False

    def _schedule(self) -> None:
        """Fill free slots from the queue. Admission looks past requests
        that do not fit the free pages (no head-of-line blocking): a small
        request behind a large one goes first; among requests that fit, the
        order is first in, first out."""
        for slot in range(self.s):
            if self._live[slot] or slot in self._prefilling or not self.queue:
                continue
            free = self._free_capacity()
            pick = None
            for idx, req in enumerate(self.queue):
                if self._pages_needed(req) <= free:
                    pick = idx
                    break
            if pick is None:
                return  # nothing fits until pages come back
            req = self.queue[pick]
            del self.queue[pick]
            self._admit(slot, req)

    @torch.inference_mode()
    def step(self) -> int:
        self._schedule()
        for slot in list(self._prefilling):
            self._advance_prefill(slot)
        if not self.active:
            return len(self._prefilling)

        # the full horizon only if every live slot has page room for it
        h = self.horizon
        if h > 1:
            room = min(len(self.slot_pages[s]) * self.pg - int(self._pos[s])
                       for s in self.active)
            if room < h + 1:
                h = 1
        toks = self._decode(h)

        for slot in list(self.active):
            for j in range(toks.shape[0]):
                req = self.active.get(slot)
                if req is None:
                    break
                req.output.append(int(toks[j, slot]))
                self._tokens[slot] = int(toks[j, slot])
                self._pos[slot] += 1
                self._maybe_finish(slot)
        return len(self.active) + len(self._prefilling)

    def run(self) -> Dict[int, List[int]]:
        while self.queue or self.active or self._prefilling:
            self.step()
        return {uid: r.output for uid, r in self.finished.items()}
