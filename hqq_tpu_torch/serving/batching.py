# SPDX-License-Identifier: Apache-2.0
"""Continuous batching over a dense KV cache, and what the serving engines
share: a request and its sampling parameters.

Mirrors `hqq_tpu.serving.batching`. `ContinuousBatchingEngine` owns the
whole serving loop:

* a fixed pool of ``batch_slots`` decode slots over one dense cache
  [L, S, n_kv, max_len, hd] (`models.llama.KVCache`), every slot at its own
  position (a [B] ``start_pos``), so requests join and leave the batch
  without touching the others;
* a prefill runs the request alone in a float mini cache of its bucketed
  length (the next power of two), whose rows are then copied into the
  slot's rows, quantized there where the cache is int8 (``quantize_kv``);
* finished slots (EOS, a stop token, max_new_tokens, the end of the cache)
  retire on the host between steps and free slots refill from the queue;
* ``horizon`` decode steps run with no read-back between them, the tokens
  read once at the end (as `serving.paged.PagedBatchingEngine._decode`).

Every decode step runs all ``batch_slots`` rows, live or not, so a
request's tokens do not depend on its neighbours: the kernels see the same
shapes every step, the activations are quantized per token and attention
is per slot.

Multi-LoRA (`nn.multilora`): each request names an ``adapter_id`` of the
tree's `MultiLoRALinear` stacks; its prefill runs under
``adapter_context([adapter_id])`` and every decode step under the slots'
ids, so one batch serves several adapters. An id outside the stacks is
refused with a ValueError at `add_request`.

Vision-language requests: ``inputs_embeds`` [len(prompt), D] (the image
rows already spliced over the placeholders, `engine.vl`) stand in for the
prompt's token embedding at prefill, cast to the cache's type; decode goes
on over the sampled ids. With ``mrope_offsets`` (Qwen2-VL,
`models.qwen2_vl.serving_forward_fns`) an embeds request carries its
prompt's M-RoPE ``position_ids`` [3, T] and a ``pos_offset``: each slot's
decode rotates at its cache length plus that offset, held in a device
buffer written at admission, so a step reads nothing back from the host; a
text-only slot beside it has offset 0, ordinary RoPE.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..models import llama
from ..nn.multilora import adapter_context, adapter_count
from ..utils.profiling import log_event
from .generate import next_power_of_2, sample_token, sample_token_batch

__all__ = ["Request", "ContinuousBatchingEngine", "check_family", "family_name",
           "refuse_own_cache"]


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # [T] int32
    max_new_tokens: int
    output: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    done: bool = False
    adapter_id: int = 0  # multi-LoRA: which adapter serves this request
    # per-request sampling parameters (None = the engine's default)
    do_sample: Optional[bool] = None
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    temperature: Optional[float] = None
    # stop token ids beyond the engine's eos (checked on the host)
    stop_token_ids: Optional[List[int]] = None
    # multimodal: the prompt's embeddings [T, D] (image rows spliced over the
    # placeholders); the prefill runs on these in place of the token ids
    embeds: Optional[torch.Tensor] = None
    # M-RoPE (Qwen2-VL): the prefill's position ids [3, T] and the decode
    # offset (largest position + 1 - prompt length; 0 is ordinary RoPE)
    position_ids: Optional[np.ndarray] = None
    pos_offset: int = 0


def _effective_sampling(req: Request, do_sample, top_k, temperature, top_p):
    """The request's parameters with the engine's defaults filled in."""
    return (
        do_sample if req.do_sample is None else bool(req.do_sample),
        top_k if req.top_k is None else int(req.top_k),
        temperature if req.temperature is None else float(req.temperature),
        top_p if req.top_p is None else float(req.top_p),
    )


def _checked_embeds(inputs_embeds, n_tokens: int, hidden: int) -> Optional[torch.Tensor]:
    """A request's prompt embeddings as a tensor [n_tokens, hidden] (numpy
    or torch, any float type, any device), after a ValueError for another
    shape; None stays None."""
    if inputs_embeds is None:
        return None
    emb = (inputs_embeds if isinstance(inputs_embeds, torch.Tensor)
           else torch.tensor(np.asarray(inputs_embeds)))
    if emb.ndim != 2 or tuple(emb.shape) != (n_tokens, hidden) or not emb.is_floating_point():
        raise ValueError(f"inputs_embeds must be floats [len(prompt)={n_tokens}, {hidden}], "
                         f"got {emb.dtype} {tuple(emb.shape)}")
    return emb


def _embeds_rows(emb: torch.Tensor, t_pad: int, dtype, device) -> torch.Tensor:
    """[1, t_pad, D] in ``dtype`` on ``device``: the request's rows, then
    zeros (the padded rows' outputs are never read)."""
    out = torch.zeros((1, t_pad, emb.shape[1]), dtype=dtype, device=device)
    out[0, :emb.shape[0]] = emb.to(device=device, dtype=dtype)
    return out


def _checked_mrope(mrope: bool, embeds, position_ids, pos_offset: int,
                   n_tokens: int) -> Optional[np.ndarray]:
    """The M-RoPE position ids as int64 [3, n_tokens] (or None), after a
    ValueError for M-RoPE arguments on an engine without ``mrope_offsets``,
    position ids without embeddings or of another shape, and an embeds
    request without position ids on an M-RoPE engine (its prefill needs
    them)."""
    if (position_ids is not None or pos_offset) and not mrope:
        raise ValueError("position_ids and pos_offset (M-RoPE) need an engine built with "
                         "mrope_offsets=True")
    if position_ids is None:
        if mrope and embeds is not None:
            raise ValueError("inputs_embeds on an mrope_offsets engine needs position_ids "
                             "[3, T] (the prompt's M-RoPE ids)")
        return None
    if embeds is None:
        raise ValueError("position_ids need inputs_embeds (a text prompt's M-RoPE ids are its "
                         "positions)")
    pid = np.asarray(position_ids, np.int64)
    if pid.size != 3 * n_tokens:
        raise ValueError(f"position_ids must be [3, {n_tokens}], got {pid.shape}")
    return pid.reshape(3, n_tokens)


def _checked_adapter(adapter_id, params) -> int:
    """The adapter id as an int, after a ValueError for an id outside the
    tree's adapter stacks (`nn.multilora.adapter_count`; a tree without
    stacks serves adapter 0 only): `hqq_tpu`'s gather fills such a row
    with NaN, torch's would be a device-side assert on the card."""
    n = adapter_count(params)
    if not 0 <= int(adapter_id) < n:
        raise ValueError(f"adapter_id {adapter_id} outside the tree's adapters [0, {n})")
    return int(adapter_id)


def family_name(cfg) -> str:
    """The model family of a config, by the module that defines its class
    (``falcon`` for `models.falcon.FalconConfig`)."""
    return type(cfg).__module__.rsplit(".", 1)[-1]


def check_family(cfg, max_len: int, quantize_kv: bool) -> None:
    """A ValueError, before any step, for what the family's forward cannot
    serve: int8 KV pools where its attention reads float pools only (the
    config's ``reads_int8_kv``), and a cache longer than its learned
    positions (``max_cache_len``, GPT-2)."""
    if quantize_kv and not getattr(cfg, "reads_int8_kv", True):
        raise ValueError(f"quantize_kv: the {family_name(cfg)} family's forward reads the "
                         f"dense cache's float pools only; int8 KV is not served for it")
    limit = getattr(cfg, "max_cache_len", None)
    if limit is not None and max_len > limit:
        raise ValueError(f"max_len {max_len} exceeds the {family_name(cfg)} family's {limit} "
                         f"learned positions")


def refuse_own_cache(who: str, *cfgs) -> None:
    """A ValueError, before anything is built, where a config's family
    keeps a dense cache of its own (`models.llama.cache_for`: DeepSeek-V3's
    MLA cache, whose K and V rows differ in width): ``who`` (the paged
    engine, the speculative paths) holds Llama's K/V layout only. Such a
    family is served by `ContinuousBatchingEngine` and `Generator`."""
    for cfg in cfgs:
        if llama.cache_for(cfg) is not llama.init_cache:
            raise ValueError(f"{who}: the {family_name(cfg)} family keeps a dense cache of its "
                             f"own, which {who} does not hold; serve it with the dense engine "
                             f"(ContinuousBatchingEngine) or Generator")


def _default_embeds_forward(cfg, forward_fn, embeds_forward_fn):
    """The forward an engine runs an ``inputs_embeds`` prefill through:
    ``embeds_forward_fn`` where given; the Llama forward over
    ``inputs_embeds`` where the engine runs the Llama forward too; None
    where a custom ``forward_fn`` came without one (another family's
    forward: the Llama default would run the wrong model), which
    `add_request` refuses."""
    if embeds_forward_fn is not None:
        return embeds_forward_fn
    if forward_fn is not None:
        return None
    return lambda p, e, cache, pos: llama.forward(p, cfg, None, cache, pos, inputs_embeds=e)


def _refuse_embeds_without_forward(efwd) -> None:
    if efwd is None:
        raise ValueError("inputs_embeds request on an engine with a custom forward_fn: pass "
                         "embeds_forward_fn too (the default Llama inputs_embeds forward does "
                         "not apply)")


def _checked_request(prompt_ids, top_k, vocab_size: int) -> np.ndarray:
    """The prompt as int32 ids, after a ValueError for what would fail
    inside a later step: an id outside [0, vocab_size) indexes past the
    embedding table (a device-side assert on the card, which ends the
    process's CUDA context; `hqq_tpu`'s gather clamps it instead), and a
    sampled request's top_k outside [1, vocab_size] is refused by
    `torch.topk` (``top_k`` None: not checked)."""
    prompt = np.asarray(prompt_ids).reshape(-1)
    if prompt.size:
        if prompt.dtype.kind not in "iu":
            raise ValueError(f"prompt ids must be integers, got {prompt.dtype}")
        if prompt.min() < 0 or prompt.max() >= vocab_size:
            raise ValueError(f"prompt ids must lie in [0, {vocab_size}), got "
                             f"{int(prompt.min())}..{int(prompt.max())}")
    if top_k is not None and not 1 <= int(top_k) <= vocab_size:
        raise ValueError(f"top_k must lie in [1, {vocab_size}], got {top_k}")
    return prompt.astype(np.int32)


class ContinuousBatchingEngine:
    """Continuous batching over a dense KV cache: add_request / step / run
    / cancel / close."""

    def __init__(
        self,
        params: Any,
        cfg: Any,
        batch_slots: int = 8,
        max_len: int = 1024,
        eos_token_id: Optional[int] = None,
        do_sample: bool = False,
        top_k: int = 20,
        top_p: float = 1.0,
        temperature: float = 0.6,
        cache_dtype=torch.bfloat16,
        forward_fn=None,
        embeds_forward_fn=None,
        seed: int = 0,
        horizon: int = 1,
        quantize_kv: bool = False,
        mrope_offsets: bool = False,
        device="cuda",
    ):
        """forward_fn: another family's forward, (params, tokens [B, T],
        cache, start_pos) -> (logits, cache), called with the mini cache
        and an int for a prefill and with the engine's cache and a [B]
        tensor of positions for decode; defaults to the Llama forward.

        horizon: that many decode steps per `step()` with no read-back
        between them; the same tokens as single steps.

        quantize_kv: int8 pools with per-row scales (`llama.init_cache`; the
        cache is the family's, `llama.cache_for`);
        refused with a ValueError for a family whose forward reads float
        pools only, as is a ``max_len`` past GPT-2's learned positions
        (`check_family`).

        embeds_forward_fn: (params, embeds [1, T, D], mini cache, 0) ->
        (logits, cache), the prefill of an ``inputs_embeds`` request;
        defaults to the Llama forward over the embeddings, and with a
        custom ``forward_fn`` must be given for such requests.

        mrope_offsets (Qwen2-VL, `models.qwen2_vl.serving_forward_fns`):
        ``forward_fn`` takes a fifth argument at decode, the slots' M-RoPE
        offsets [S] on the device, and ``embeds_forward_fn`` a fifth at
        prefill, the request's position ids [3, 1, T_pad]."""
        check_family(cfg, max_len, quantize_kv)
        self.params = params
        self.cfg = cfg
        self.device = torch.device(device)
        self.s = batch_slots
        self.max_len = max_len
        self.eos = eos_token_id
        self.do_sample = do_sample
        self.top_k = top_k
        self.top_p = top_p
        self.temperature = temperature
        self._fwd = forward_fn or (
            lambda p, toks, cache, pos: llama.forward(p, cfg, toks, cache, pos))
        self._efwd = _default_embeds_forward(cfg, forward_fn, embeds_forward_fn)
        self.quantize_kv = bool(quantize_kv)
        self._cache_dtype = cache_dtype  # the prefill mini cache stays float
        self._init_cache = llama.cache_for(cfg)  # the family's own (DeepSeek-V3: MLA)
        self.cache = self._init_cache(cfg, batch_slots, max_len, cache_dtype, self.device,
                                      quantize_kv=self.quantize_kv)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

        # per-slot sampling parameters [4, S]: do_sample/top_k/temperature/top_p
        self._samp = np.zeros((4, batch_slots), np.float32)
        self._samp[0] = 1.0 if do_sample else 0.0
        self._samp[1] = top_k
        self._samp[2] = temperature
        self._samp[3] = top_p
        self.queue: deque[Request] = deque()
        self.active: Dict[int, Request] = {}  # slot -> request
        self.finished: Dict[int, Request] = {}
        self._uid = 0
        self._tokens = np.zeros((batch_slots,), np.int64)  # each slot's next input
        self._pos = np.zeros((batch_slots,), np.int64)  # each slot's write position
        self._live = np.zeros((batch_slots,), bool)
        self._adapter = np.zeros((batch_slots,), np.int64)  # each slot's adapter id
        self.horizon = max(1, int(horizon))
        # M-RoPE: each slot's decode offset, written at its admission
        self._mrope = bool(mrope_offsets)
        self._pos_off = torch.zeros((batch_slots,), dtype=torch.int64, device=self.device)

    def close(self):
        """Drop the cache and the parameters. Idempotent."""
        self.__dict__.pop("_fwd", None)
        self.__dict__.pop("_efwd", None)
        self.cache = None
        self.params = None

    # -- device steps ----------------------------------------------------------
    def _decode(self, steps: int) -> np.ndarray:
        """``steps`` decode steps for all slots, the tokens read back once
        at the end: [steps, S]. Within the horizon every slot advances one
        position a step; the horizon's cap keeps the live slots inside the
        cache, and a dead slot's rows past its end are dropped
        (`models.llama._update_stacked_cache`), as in `hqq_tpu`."""
        dev = self.device
        tok = torch.from_numpy(self._tokens).to(dev)
        pos = torch.from_numpy(self._pos).to(dev)
        samp = torch.from_numpy(self._samp).to(dev)
        out = []
        with adapter_context(torch.from_numpy(self._adapter).to(dev)):
            for _ in range(steps):
                offs = (self._pos_off,) if self._mrope else ()
                logits, self.cache = self._fwd(self.params, tok[:, None], self.cache, pos, *offs)
                tok = sample_token_batch(logits[:, -1], self._gen, samp[0] > 0.5,
                                         samp[1].to(torch.int64), samp[2], samp[3])
                pos = pos + 1
                out.append(tok)
        return torch.stack(out).cpu().numpy()

    def _splice(self, slot: int, mini: llama.KVCache) -> None:
        """Copy the prefill's rows [0, T_pad) into the slot, in place; the
        slot's later rows keep what they held, masked until overwritten."""
        rows = mini.k.shape[3]
        cache = self.cache
        if cache.quantized:
            from ..ops.paged import quant_rows

            for pool, scales, dense in ((cache.k, cache.k_scales, mini.k),
                                        (cache.v, cache.v_scales, mini.v)):
                q, sc = quant_rows(dense[:, 0])
                pool[:, slot, :, :rows] = q
                scales[:, slot, :, :rows] = sc
        else:
            cache.k[:, slot, :, :rows] = mini.k[:, 0].to(cache.k.dtype)
            cache.v[:, slot, :, :rows] = mini.v[:, 0].to(cache.v.dtype)

    # -- scheduling on the host --------------------------------------------------
    def add_request(self, prompt_ids, max_new_tokens: int = 128, adapter_id: int = 0,
                    inputs_embeds=None, position_ids=None, pos_offset: int = 0,
                    do_sample: Optional[bool] = None, top_k: Optional[int] = None,
                    top_p: Optional[float] = None, temperature: Optional[float] = None,
                    stop_token_ids: Optional[List[int]] = None) -> int:
        """Queue a request; returns its uid. do_sample / top_k / top_p /
        temperature / stop_token_ids are per request (None = the engine's
        defaults); a stop token is kept in the output, as EOS is.
        ``adapter_id`` picks the multi-LoRA adapter (0: none).

        ``inputs_embeds`` [len(prompt), D]: the prompt's embeddings (image
        rows spliced over the placeholders), which the prefill runs on in
        place of the ids. With ``mrope_offsets``: ``position_ids`` [3, T],
        the prompt's M-RoPE ids (required with ``inputs_embeds``), and
        ``pos_offset``, the decode's offset (largest position + 1 -
        len(prompt)).

        Ids outside the vocabulary, an adapter id outside the tree's stacks,
        embeddings or position ids of another shape, M-RoPE arguments on an
        engine without ``mrope_offsets`` and embeddings on an engine with
        no embeds forward raise a ValueError here, before any step."""
        sampled = self.do_sample if do_sample is None else bool(do_sample)
        prompt = _checked_request(prompt_ids, top_k if sampled else None, self.cfg.vocab_size)
        adapter_id = _checked_adapter(adapter_id, self.params)
        embeds = _checked_embeds(inputs_embeds, len(prompt), self.cfg.hidden_size)
        position_ids = _checked_mrope(self._mrope, embeds, position_ids, pos_offset, len(prompt))
        if embeds is not None:
            _refuse_embeds_without_forward(self._efwd)
        t_pad = next_power_of_2(max(len(prompt), 2))
        if t_pad + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({len(prompt)} tokens, padded {t_pad}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_len={self.max_len}")
        self._uid += 1
        self.queue.append(
            Request(uid=self._uid, prompt=prompt, max_new_tokens=max_new_tokens,
                    adapter_id=adapter_id, do_sample=do_sample, top_k=top_k, top_p=top_p,
                    temperature=temperature,
                    stop_token_ids=list(stop_token_ids) if stop_token_ids else None,
                    embeds=embeds, position_ids=position_ids, pos_offset=int(pos_offset)))
        return self._uid

    def _admit(self, slot: int, req: Request) -> None:
        """Prefill ``req`` alone into a mini cache of its bucket, copy it
        into ``slot``, sample its first token."""
        t = len(req.prompt)
        t_pad = next_power_of_2(max(t, 2))
        prompt = np.zeros((1, t_pad), np.int64)
        prompt[0, :t] = req.prompt
        ds, tk, tmp, tp = _effective_sampling(
            req, self.do_sample, self.top_k, self.temperature, self.top_p)
        self._samp[:, slot] = (1.0 if ds else 0.0, tk, tmp, tp)
        self._adapter[slot] = req.adapter_id
        mini = self._init_cache(self.cfg, 1, t_pad, self._cache_dtype, self.device)
        if self._mrope:
            self._pos_off[slot] = req.pos_offset
        with adapter_context(torch.tensor([req.adapter_id], device=self.device)):
            if req.embeds is None:
                logits, mini = self._fwd(self.params, torch.from_numpy(prompt).to(self.device),
                                         mini, 0)
            else:
                emb = _embeds_rows(req.embeds, t_pad, self._cache_dtype, self.device)
                if req.position_ids is None:
                    logits, mini = self._efwd(self.params, emb, mini, 0)
                else:
                    # the padded rows take positions past the prompt's (their
                    # cache rows are masked; their rotation is never read)
                    pid = np.empty((3, 1, t_pad), np.int64)
                    pid[:, 0, :t] = req.position_ids
                    pid[:, 0, t:] = req.position_ids.max() + 1
                    logits, mini = self._efwd(self.params, emb, mini, 0,
                                              torch.from_numpy(pid).to(self.device))
        self._splice(slot, mini)
        first = int(sample_token(logits[:, t - 1], self._gen, ds, tk, tmp, tp)[0])
        log_event("request_admitted", uid=req.uid, slot=slot, prompt_len=t)
        req.slot = slot
        req.output = [first]
        self.active[slot] = req
        self._tokens[slot] = first
        self._pos[slot] = t
        self._live[slot] = True
        self._maybe_finish(slot)

    def _maybe_finish(self, slot: int) -> None:
        req = self.active.get(slot)
        if req is None:
            return
        last = req.output[-1] if req.output else None
        if (
            (self.eos is not None and last == self.eos)
            or (req.stop_token_ids and last in req.stop_token_ids)
            or len(req.output) >= req.max_new_tokens
            or int(self._pos[slot]) >= self.max_len - 1
        ):
            log_event("request_finished", uid=req.uid, slot=slot, n_tokens=len(req.output))
            req.done = True
            self.finished[req.uid] = req
            del self.active[slot]
            self._live[slot] = False

    def cancel(self, uid: int) -> bool:
        """Cancel a queued or running request; a running one finishes at
        once with the tokens it has (its slot refills on the next step).
        Returns True if it was found."""
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
                return True
        return False

    def _schedule(self) -> None:
        for slot in range(self.s):
            if not self._live[slot] and self.queue:
                self._admit(slot, self.queue.popleft())

    @torch.inference_mode()
    def step(self) -> int:
        """Admit queued requests, run one decode horizon. Returns the
        number of active requests."""
        self._schedule()
        if not self.active:
            return 0
        # the horizon capped so that no live slot runs past the cache
        h = self.horizon
        if h > 1:
            max_pos = max(int(self._pos[s]) for s in self.active)
            h = max(1, min(h, self.max_len - 1 - max_pos))
        toks = self._decode(h)
        for slot in list(self.active):
            for j in range(toks.shape[0]):
                req = self.active.get(slot)
                if req is None:
                    break  # finished within the horizon: the rest is dropped
                req.output.append(int(toks[j, slot]))
                self._tokens[slot] = int(toks[j, slot])
                self._pos[slot] += 1
                self._maybe_finish(slot)
        return len(self.active)

    def run(self) -> Dict[int, List[int]]:
        """Drain the queue; returns {uid: generated token ids}."""
        while self.queue or self.active:
            self.step()
        return {uid: r.output for uid, r in self.finished.items()}
