# SPDX-License-Identifier: Apache-2.0
"""Speculative decoding: a cheap draft proposes, the target verifies, and
the output is the target's own.

Mirrors `hqq_tpu.serving.speculative`. A draft model (the same network
quantized harder, its first layers, or a smaller family member with the
same vocabulary) proposes k tokens one after the other; the target scores
the whole window in one forward, accepts a prefix and supplies the next
token. Greedy decoding accepts the longest prefix that matches the
target's argmax, so the ids are the target's plain greedy ids; sampling
is Leviathan et al.'s rejection scheme (`_spec_accept`), whose output is
distributed as sampling from the target alone.

The caches are position-masked: rows past a slot's position are never
attended and are overwritten as it advances, so a rejected window needs no
rollback. A window that runs past the end of a dense cache drops its last
rows, as `hqq_tpu`'s scatter does (`models.llama._update_stacked_cache`).

* `SpeculativeGenerator`: one prompt over dense caches. A round (the draft
  ingests the current token, proposes k more, the target verifies the
  k + 1 rows, the accept count is resolved on the device) is captured on
  the card in one `torch.cuda.CUDAGraph` per cache length and replayed;
  it advances the token and the position on the device, and the host reads
  one [k + 2] vector a round. "partial" (and the CPU) run the same round
  eagerly.
* `SpeculativeBatchingEngine` and `SpeculativePagedEngine`: greedy
  continuous batching over `ContinuousBatchingEngine` and
  `PagedBatchingEngine` (the same API: add_request / step / run / cancel);
  each step drafts k - 1 tokens a slot and verifies the k-wide window of
  every slot in one target forward (per-slot positions; over the pages the
  paged-attention kernel once per window row). Their steps are eager.

Random draws are uniforms from a seeded `torch.Generator`, drawn before
the loop into a static buffer that the round reads, as `Generator` draws
its Gumbel noise; a categorical draw is the inverse CDF at one uniform.
JAX's keys cannot be reproduced, so sampled ids differ from `hqq_tpu`'s;
their distribution is the same.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..models import llama
from .batching import ContinuousBatchingEngine, refuse_own_cache
from .generate import _GraphCache, _to_numpy, capture_graph, next_power_of_2
from .paged import PagedBatchingEngine

__all__ = [
    "SpeculativeGenerator",
    "SpeculativeBatchingEngine",
    "SpeculativePagedEngine",
]


def _categorical(probs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """One draw from each row of ``probs`` [..., V] (not necessarily
    normalized) at the uniforms ``u`` [...]: the first index whose
    cumulative sum exceeds u times the row's sum. A token of probability 0
    is never drawn."""
    cdf = probs.cumsum(-1)
    val = (u * cdf[..., -1])[..., None]
    return torch.searchsorted(cdf, val, right=True)[..., 0].clamp_max(probs.shape[-1] - 1)


def _leading(flags: torch.Tensor) -> torch.Tensor:
    """How many leading entries of the last axis of ``flags`` are true
    (the index of the first false one), with no host read."""
    return flags.long().cumprod(-1).sum(-1)


def _spec_accept(target_logits: torch.Tensor, draft_logits: torch.Tensor,
                 proposals: torch.Tensor, draws: torch.Tensor, temperature: float):
    """Rejection sampling (Leviathan et al.) on the device: returns
    (n_accepted, next_token), the output distributed as sampling from the
    target alone.

    target_logits [..., k+1, V] (positions pos..pos+k), draft_logits
    [..., k, V], proposals [..., k] (drawn from the draft's softmax),
    draws [..., 2k+1] uniforms in [0, 1): k acceptance tests, k residual
    draws and the bonus draw. Proposal i is accepted while u_i <
    p_target(d_i) / p_draft(d_i); the first rejected one is replaced by a
    draw from max(p_target - p_draft, 0), and when all k are accepted the
    next token is a draw from the target at the window's last row."""
    k = proposals.shape[-1]
    pt = torch.softmax(target_logits.to(torch.float32) / temperature, dim=-1)
    pd = torch.softmax(draft_logits.to(torch.float32) / temperature, dim=-1)
    idx = proposals[..., None].long()
    ratio = pt[..., :k, :].gather(-1, idx)[..., 0] / pd.gather(-1, idx)[..., 0].clamp_min(1e-20)
    n_acc = _leading(draws[..., :k] < ratio)
    resid = (pt[..., :k, :] - pd).clamp_min(0.0)
    resid = resid / resid.sum(-1, keepdim=True).clamp_min(1e-20)
    rejected = _categorical(resid, draws[..., k:2 * k])  # [..., k]
    bonus = _categorical(pt[..., k, :], draws[..., 2 * k])  # [...]
    nxt = torch.cat([rejected, bonus[..., None]], dim=-1).gather(-1, n_acc[..., None])[..., 0]
    return n_acc, nxt


def _greedy_accept(target_logits: torch.Tensor, proposals: torch.Tensor):
    """(n_accepted, next_token) of greedy verification: the longest prefix
    of ``proposals`` [k] equal to the target's argmax, then the target's
    own choice after it."""
    greedy = torch.argmax(target_logits, dim=-1)  # [k+1]
    n_acc = _leading(proposals == greedy[:-1])
    return n_acc, greedy.gather(0, n_acc[None])[0]


class _SpecState:
    """The static buffers of one cache length: both caches, the current
    token [1] and its position (0-d), the round counter (the draws' row),
    the packed result [k + 2] (the merged tokens, then the accept count),
    the draws [cache_len, 3k + 1] of a sampling generator, and the graph
    where one is captured."""

    def __init__(self, cfg, dcfg, cache_len: int, k: int, cache_dtype, device, sampling: bool):
        self.tcache = llama.init_cache(cfg, 1, cache_len, cache_dtype, device)
        self.dcache = llama.init_cache(dcfg, 1, cache_len, cache_dtype, device)
        self.tok = torch.zeros((1,), dtype=torch.long, device=device)
        self.pos = torch.zeros((), dtype=torch.long, device=device)
        self.counter = torch.zeros((), dtype=torch.long, device=device)
        self.packed = torch.zeros((k + 2,), dtype=torch.long, device=device)
        # per round: k draft draws, then the 2k + 1 of `_spec_accept`
        self.draws = (torch.zeros((cache_len, 3 * k + 1), dtype=torch.float32, device=device)
                      if sampling else None)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.capture: dict = {}


class SpeculativeGenerator:
    """Speculative decoding of one prompt over two parameter trees with one
    vocabulary. ``forward_fn(params, cfg, tokens, cache, start_pos)``
    defaults to the Llama forward and serves both models (``draft_cfg``:
    the draft's config, by default ``cfg``); ``start_pos`` may be a 0-d
    device tensor. ``compile_mode``: "full" replays each round as a CUDA
    graph on the card, "partial" runs it eagerly (as on the CPU)."""

    def __init__(
        self,
        target_params: Any,
        draft_params: Any,
        cfg: Any,
        k: int = 4,
        draft_cfg: Optional[Any] = None,
        forward_fn: Optional[Callable] = None,
        cache_dtype=torch.bfloat16,
        do_sample: bool = False,
        temperature: float = 1.0,
        eos_token_id: Optional[int] = None,
        seed: int = 0,
        compile_mode: str = "full",
        device="cuda",
    ):
        if compile_mode not in ("full", "partial"):
            raise ValueError(f"compile_mode must be 'full' or 'partial', not {compile_mode!r}")
        if int(k) < 1:
            raise ValueError(f"k must be at least 1, not {k}")
        refuse_own_cache("SpeculativeGenerator", cfg, draft_cfg or cfg)
        self.pt = target_params
        self.pd = draft_params
        self.cfg = cfg
        self.dcfg = draft_cfg or cfg
        self.k = int(k)
        self.cache_dtype = cache_dtype
        self.do_sample = do_sample
        self.temperature = float(temperature)
        self.eos = eos_token_id
        self.compile_mode = compile_mode
        self.device = torch.device(device)
        self._fwd = forward_fn or llama.forward
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._graphs = _GraphCache()  # {cache_len: _SpecState}
        # of the last generate: rounds run and proposals accepted (of k each)
        self.rounds = 0
        self.accepted = 0

    def captures(self) -> dict:
        """{cache_len: {"seconds": s, "launches": {wrapper: n}}} of each kept
        round graph: the kernel launches recorded into one round."""
        return self._graphs.captures()

    def release_graphs(self) -> None:
        self._graphs.clear()

    def _new_state(self, cache_len: int) -> _SpecState:
        return _SpecState(self.cfg, self.dcfg, cache_len, self.k, self.cache_dtype, self.device,
                          self.do_sample)

    def _graphed(self, max_new_tokens: int) -> bool:
        """Whether this call replays a round graph: "full" on the card, with
        a round to replay."""
        return self.compile_mode == "full" and self.device.type == "cuda" and max_new_tokens > 1

    def _graph_state(self, cache_len: int) -> _SpecState:
        """The kept buffers of ``cache_len`` with their graph, captured on
        first use and dropped when either tree changes
        (`generate._GraphCache.state`)."""
        return self._graphs.state(cache_len, [self.pt, self.pd],
                                  lambda: self._new_state(cache_len), self._capture)

    def _capture(self, st: _SpecState) -> None:
        st.graph, st.capture = capture_graph(self.device, lambda: self._round(st))

    def _pick(self, logits: torch.Tensor, u: Optional[torch.Tensor]) -> torch.Tensor:
        """The next token of ``logits`` [V]: argmax, or a draw from the
        softmax at temperature at the uniform ``u``."""
        if not self.do_sample:
            return torch.argmax(logits, dim=-1)
        return _categorical(torch.softmax(logits.to(torch.float32) / self.temperature, -1), u)

    def _round(self, st: _SpecState) -> None:
        """One round on ``st``'s buffers, in place and with no host read:
        the draft ingests ``tok`` at ``pos`` and proposes k tokens (each
        fed back), the target verifies [tok] + proposals at ``pos``, then
        ``packed`` gets the proposals with the target's token at the accept
        count, and the count; ``tok`` becomes that token, ``pos`` advances
        by the count + 1, the counter by one."""
        k = self.k
        row = None if st.draws is None else st.draws.index_select(0, st.counter.view(1))[0]
        dl, _ = self._fwd(self.pd, self.dcfg, st.tok.view(1, 1), st.dcache, st.pos)
        prev, dpos = dl[0, -1], st.pos + 1
        props, dlogits = [], []
        for i in range(k):
            prop = self._pick(prev, None if row is None else row[i])
            props.append(prop)
            dlogits.append(prev)
            dl, _ = self._fwd(self.pd, self.dcfg, prop.view(1, 1), st.dcache, dpos)
            prev, dpos = dl[0, -1], dpos + 1
        props = torch.stack(props)  # [k]
        window = torch.cat([st.tok, props])[None]  # [1, k+1]
        tl, _ = self._fwd(self.pt, self.cfg, window, st.tcache, st.pos)
        if self.do_sample:
            n_acc, nxt = _spec_accept(tl[0], torch.stack(dlogits), props, row[k:],
                                      self.temperature)
        else:
            n_acc, nxt = _greedy_accept(tl[0], props)
        merged = torch.cat([props, props.new_zeros(1)])
        merged.scatter_(0, n_acc.view(1), nxt.view(1))
        st.packed.copy_(torch.cat([merged, n_acc.view(1)]))
        st.tok.copy_(nxt.view(1))
        st.pos.add_(n_acc + 1)
        st.counter.add_(1)

    @torch.inference_mode()
    def generate(self, input_ids, max_new_tokens: int = 128) -> np.ndarray:
        """The generated ids [1, <= max_new_tokens] (prompt not included);
        greedy: the target's own greedy ids. With ``eos_token_id`` the ids
        end at its first EOS."""
        ids = np.asarray(input_ids).reshape(1, -1)
        t0 = ids.shape[1]
        k, dev = self.k, self.device
        cache_len = next_power_of_2(t0 + max_new_tokens + k + 2)
        graphed = self._graphed(max_new_tokens)
        st = self._graph_state(cache_len) if graphed else self._new_state(cache_len)
        for cache in (st.tcache, st.dcache):
            cache.k.zero_()
            cache.v.zero_()
        t_pad = next_power_of_2(max(t0, 2))
        prompt = np.zeros((1, t_pad), np.int64)
        prompt[0, :t0] = ids[0]
        prompt = torch.from_numpy(prompt).to(dev)
        tl, _ = self._fwd(self.pt, self.cfg, prompt, st.tcache, 0)
        self._fwd(self.pd, self.dcfg, prompt, st.dcache, 0)
        u = None
        if st.draws is not None:
            st.draws.copy_(torch.rand(st.draws.shape, generator=self._gen, device=dev))
            u = torch.rand((), generator=self._gen, device=dev)
        first = self._pick(tl[0, t0 - 1], u)
        st.tok.copy_(first.view(1))
        st.pos.fill_(t0)
        st.counter.zero_()
        out = [int(first)]
        self.rounds = self.accepted = 0
        while len(out) < max_new_tokens:
            if graphed:
                st.graph.replay()
            else:
                self._round(st)
            res = _to_numpy(st.packed)  # the round's one read
            self.rounds += 1
            self.accepted += int(res[k + 1])
            new = res[: int(res[k + 1]) + 1].tolist()
            out.extend(new)
            if self.eos is not None and self.eos in new:
                out = out[: len(out) - len(new) + new.index(self.eos) + 1]
                break
        return np.asarray(out[:max_new_tokens], np.int32)[None]


def _draft_window(draft_fwd, draft_params, tokens: torch.Tensor, dcache, pos: torch.Tensor,
                  n: int):
    """``n`` greedy draft steps for every slot from ``tokens`` [B] at
    per-slot positions ``pos`` [B], each fed back: the drafts [B, n]."""
    drafts, tok, p = [], tokens, pos
    for _ in range(n):
        dl, dcache = draft_fwd(draft_params, tok[:, None], dcache, p)
        tok = torch.argmax(dl[:, -1], dim=-1)
        drafts.append(tok)
        p = p + 1
    return torch.stack(drafts, dim=1)


def _commit_greedy(tlogits: torch.Tensor, drafts: torch.Tensor):
    """(committed [B, k], n_commit [B]) of a verified window: each slot's
    longest prefix of ``drafts`` [B, k-1] equal to the target's argmax of
    ``tlogits`` [B, k, V], then the target's own token."""
    preds = torch.argmax(tlogits, dim=-1)  # [B, k]
    n_acc = _leading(preds[:, :-1] == drafts)  # [B]
    km1 = drafts.shape[1]
    idx = torch.arange(km1, device=drafts.device)[None, :]
    committed = torch.cat([torch.where(idx < n_acc[:, None], drafts, 0),
                           drafts.new_zeros((drafts.shape[0], 1))], dim=1)
    committed.scatter_(1, n_acc[:, None], preds.gather(1, n_acc[:, None]))
    return committed, n_acc + 1


class _SpeculativeEngine:
    """What the two speculative engines share: the inner engine's API
    passed through, the draft's dense cache [L, S, n_kv, rows, hd] with
    each new request's context prefilled into its slot, and the commit of
    a verified step."""

    def _init_draft(self, eng, draft_params, cfg, draft_cfg, k_draft: int, rows: int,
                    cache_dtype, draft_forward_fn):
        if int(k_draft) < 2:
            raise ValueError(f"k_draft must be at least 2, not {k_draft}")
        self._eng = eng
        self.dcfg = draft_cfg or cfg
        self.draft_params = draft_params
        self._dfwd = draft_forward_fn or (
            lambda p, toks, cache, pos: llama.forward(p, self.dcfg, toks, cache, pos))
        self.dcache = llama.init_cache(self.dcfg, eng.s, rows, cache_dtype, eng.device)
        self.k = int(k_draft)
        self._drafted: List[Optional[int]] = [None] * eng.s  # uid whose context each slot holds

    def close(self):
        """Drop the draft's cache and parameters, then the inner engine's.
        Idempotent."""
        self.__dict__.pop("_dfwd", None)
        self.dcache = None
        self.draft_params = None
        self._eng.close()

    # passthroughs --------------------------------------------------------------
    def add_request(self, prompt_ids, max_new_tokens: int = 128) -> int:
        return self._eng.add_request(prompt_ids, max_new_tokens)

    def cancel(self, uid: int) -> bool:
        return self._eng.cancel(uid)

    @property
    def finished(self):
        return self._eng.finished

    # ---------------------------------------------------------------------------
    def _prefill_drafts(self) -> None:
        """Prefill each newly admitted request's context (its prompt and the
        tokens it has emitted but the last) into its slot of the draft
        cache; the target's prefill ran in the inner engine's admission."""
        eng = self._eng
        for slot, req in eng.active.items():
            if self._drafted[slot] == req.uid:
                continue
            ctx = np.concatenate([req.prompt, np.asarray(req.output[:-1], np.int64)])
            t_pad = next_power_of_2(max(len(ctx), 2))  # fits: add_request checked it
            buf = np.zeros((1, t_pad), np.int64)
            buf[0, :len(ctx)] = ctx
            mini = llama.init_cache(self.dcfg, 1, t_pad, self.dcache.k.dtype, eng.device)
            _, mini = self._dfwd(self.draft_params, torch.from_numpy(buf).to(eng.device), mini, 0)
            self.dcache.k[:, slot, :, :t_pad] = mini.k[:, 0]
            self.dcache.v[:, slot, :, :t_pad] = mini.v[:, 0]
            self._drafted[slot] = req.uid

    def _verify(self, target_fwd) -> tuple:
        """One speculative step of every slot: k - 1 greedy drafts from each
        slot's token, the target's forward ``target_fwd(window [B, k], pos
        [B])`` over the window, the commit. Returns (committed [B, k],
        n_commit [B]) on the host."""
        eng = self._eng
        dev = eng.device
        tokens = torch.from_numpy(eng._tokens.astype(np.int64)).to(dev)
        pos = torch.from_numpy(eng._pos.astype(np.int64)).to(dev)
        drafts = _draft_window(self._dfwd, self.draft_params, tokens, self.dcache, pos,
                               self.k - 1)
        tlogits = target_fwd(torch.cat([tokens[:, None], drafts], dim=1), pos)
        committed, n_commit = _commit_greedy(tlogits, drafts)
        return committed.cpu().numpy(), n_commit.cpu().numpy()

    def _commit(self, committed: np.ndarray, n_commit: np.ndarray, room) -> None:
        """Append each live slot's committed tokens, at most ``room(slot)``
        of them, finishing requests as the inner engine does."""
        eng = self._eng
        for slot in list(eng.active):
            n = min(int(n_commit[slot]), room(slot))
            for j in range(n):
                req = eng.active.get(slot)
                if req is None:
                    break
                tok = int(committed[slot, j])
                req.output.append(tok)
                eng._tokens[slot] = tok
                eng._pos[slot] += 1
                eng._maybe_finish(slot)


class SpeculativeBatchingEngine(_SpeculativeEngine):
    """Continuous batching with batched speculative decoding, greedy and
    token for token the target's: the API of `ContinuousBatchingEngine`
    (add_request / step / run / cancel). Each step drafts ``k_draft - 1``
    tokens a slot with the draft, verifies the ``k_draft``-wide window of
    every slot in one target forward at per-slot positions, and commits
    1..k_draft tokens a slot."""

    def __init__(
        self,
        params: Any,
        draft_params: Any,
        cfg: Any,
        draft_cfg: Optional[Any] = None,
        k_draft: int = 4,
        batch_slots: int = 8,
        max_len: int = 1024,
        eos_token_id: Optional[int] = None,
        cache_dtype=torch.bfloat16,
        forward_fn: Optional[Callable] = None,
        draft_forward_fn: Optional[Callable] = None,
        device="cuda",
    ):
        refuse_own_cache("SpeculativeBatchingEngine", cfg, draft_cfg or cfg)
        eng = ContinuousBatchingEngine(
            params, cfg, batch_slots=batch_slots, max_len=max_len, eos_token_id=eos_token_id,
            do_sample=False, cache_dtype=cache_dtype, forward_fn=forward_fn, device=device)
        self._init_draft(eng, draft_params, cfg, draft_cfg, k_draft, max_len, cache_dtype,
                         draft_forward_fn)

    @torch.inference_mode()
    def step(self) -> int:
        eng = self._eng
        eng._schedule()
        if not eng.active:
            return 0
        self._prefill_drafts()

        def target(window, pos):
            logits, eng.cache = eng._fwd(eng.params, window, eng.cache, pos)
            return logits

        committed, n_commit = self._verify(target)
        # never past the cache's last row (the window's rows past it were dropped)
        self._commit(committed, n_commit, lambda slot: eng.max_len - 1 - int(eng._pos[slot]))
        return len(eng.active)

    def run(self) -> Dict[int, List[int]]:
        while self._eng.queue or self._eng.active:
            self.step()
        return {uid: r.output for uid, r in self._eng.finished.items()}


class SpeculativePagedEngine(_SpeculativeEngine):
    """Paged continuous batching with batched speculative decoding, greedy
    and token for token the target's: the API of `PagedBatchingEngine`.
    Each step drafts ``k_draft - 1`` tokens a slot (a dense draft cache of
    ``max_pages_per_seq * page_size`` rows a slot), then the target
    verifies the ``k_draft``-wide window in one paged forward: all k rows
    are written into the slot's pages first, then row j attends the keys
    below pos + j + 1 (`models.llama._attention_paged`, one paged-attention
    launch a row and layer).

    Rollback-free on both sides: rejected rows lie past the committed
    position and the next window overwrites them; the block table is fixed
    at admission, and its entries past a slot's pages point at the scratch
    page 0. A step in which some live slot has no room for k + 1 rows is
    one plain paged step instead. It leaves the draft cache without the
    row of that step's token: that lowers acceptance, never correctness,
    because verification is exact."""

    def __init__(
        self,
        params: Any,
        draft_params: Any,
        cfg: Any,
        draft_cfg: Optional[Any] = None,
        k_draft: int = 4,
        batch_slots: int = 8,
        num_pages: int = 512,
        page_size: int = 16,
        max_pages_per_seq: int = 64,
        eos_token_id: Optional[int] = None,
        cache_dtype=torch.bfloat16,
        forward_fn: Optional[Callable] = None,
        draft_forward_fn: Optional[Callable] = None,
        device="cuda",
        **paged_kwargs,
    ):
        refuse_own_cache("SpeculativePagedEngine", cfg, draft_cfg or cfg)
        eng = PagedBatchingEngine(
            params, cfg, batch_slots=batch_slots, num_pages=num_pages, page_size=page_size,
            max_pages_per_seq=max_pages_per_seq, eos_token_id=eos_token_id, do_sample=False,
            cache_dtype=cache_dtype, forward_fn=forward_fn, device=device, **paged_kwargs)
        self._init_draft(eng, draft_params, cfg, draft_cfg, k_draft,
                         max_pages_per_seq * page_size, cache_dtype, draft_forward_fn)
        self.fallback_steps = 0  # plain paged steps taken for want of room

    @torch.inference_mode()
    def step(self) -> int:
        eng = self._eng
        eng._schedule()
        for slot in list(eng._prefilling):
            eng._advance_prefill(slot)
        if not eng.active:
            return len(eng._prefilling)
        self._prefill_drafts()

        def room(slot):  # rows left in the slot's pages
            return len(eng.slot_pages[slot]) * eng.pg - int(eng._pos[slot])

        if min(room(s) for s in eng.active) < self.k + 1:
            self.fallback_steps += 1
            return PagedBatchingEngine.step(eng)
        page_tab = torch.from_numpy(eng._page_tab).to(eng.device)

        def target(window, pos):
            logits, eng.cache = eng._fwd(eng.params, window, eng.cache, pos, page_tab)
            return logits

        committed, n_commit = self._verify(target)
        self._commit(committed, n_commit, lambda slot: room(slot) - 1)
        return len(eng.active) + len(eng._prefilling)

    def run(self) -> Dict[int, List[int]]:
        eng = self._eng
        while eng.queue or eng.active or eng._prefilling:
            self.step()
        return {uid: r.output for uid, r in eng.finished.items()}
