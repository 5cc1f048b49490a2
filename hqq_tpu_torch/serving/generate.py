# SPDX-License-Identifier: Apache-2.0
"""Generation: prefill, then a token-by-token decode loop.

Mirrors `hqq_tpu.serving.generate`. The cache is sized to the next power of
two above prompt + new tokens, the prompt is right-padded to a power-of-two
bucket, and the first token comes from ``logits[:, t-1]``. Padded prompt
slots are written to the cache, but each is overwritten by a real token
before any query can attend to it. The decode loop is a Python loop of
one-token forwards (`hqq_tpu` runs it as one jitted scan; its counterpart
here, a CUDA graph, is later work).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from ..models import llama

__all__ = ["Generator", "sample_token", "sample_token_batch", "next_power_of_2", "MAX_TOP_K"]


def next_power_of_2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def sample_token(
    logits: torch.Tensor,
    generator: Optional[torch.Generator],
    do_sample: bool,
    top_k: int,
    temperature: float,
    top_p: float = 1.0,
    gumbel: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Greedy, or top-k (with optional top-p) sampling by the Gumbel trick.

    ``gumbel`` is optional noise of shape [..., top_k]; without it the noise
    is drawn from ``generator``."""
    if not do_sample:
        return torch.argmax(logits, dim=-1)
    logits = logits / max(temperature, 1e-5)
    vals, idxs = torch.topk(logits, top_k, dim=-1)
    if top_p < 1.0:
        # nucleus filter within the top-k candidates (sorted descending):
        # keep tokens whose CDF before them is below top_p; the first stays
        probs = torch.softmax(vals, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < top_p
        vals = torch.where(keep, vals, torch.finfo(vals.dtype).min)
    if gumbel is None:
        gumbel = _gumbel(vals.shape, generator, vals.device, vals.dtype)
    choice = torch.argmax(vals + gumbel.to(vals.dtype), dim=-1)
    return torch.gather(idxs, -1, choice[..., None])[..., 0]


# width of the per-row sampler's top-k: requested values are clamped to it
MAX_TOP_K = 64


def _gumbel(shape, generator, device, dtype) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device, dtype=dtype)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(dtype).tiny)))


def sample_token_batch(
    logits: torch.Tensor,
    generator: Optional[torch.Generator],
    do_sample: torch.Tensor,
    top_k: torch.Tensor,
    temperature: torch.Tensor,
    top_p: torch.Tensor,
    gumbel: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sampling with per-row parameters: every slot of a continuous batch
    carries its own request's.

    logits [S, V]; do_sample bool [S]; top_k int [S] (clamped to MAX_TOP_K);
    temperature and top_p float [S]. Greedy rows (do_sample False) are the
    argmax whatever the other parameters. ``gumbel`` is optional noise of
    shape [S, min(MAX_TOP_K, V)]; without it the noise is drawn from
    ``generator``."""
    greedy = torch.argmax(logits, dim=-1)
    lt = logits.to(torch.float32) / temperature.to(torch.float32).clamp_min(1e-5)[:, None]
    k_eff = min(MAX_TOP_K, logits.shape[-1])
    vals, idxs = torch.topk(lt, k_eff, dim=-1)  # sorted descending
    pos = torch.arange(k_eff, device=logits.device)[None, :]
    neg = torch.finfo(vals.dtype).min
    vals = torch.where(pos < top_k.clamp(1, k_eff)[:, None], vals, neg)
    # nucleus filter within the top-k candidates (the first always stays;
    # rows cut by top_k have probability ~0 and stay cut)
    probs = torch.softmax(vals, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_p[:, None]
    vals = torch.where(keep, vals, neg)
    if gumbel is None:
        gumbel = _gumbel(vals.shape, generator, vals.device, vals.dtype)
    choice = torch.argmax(vals + gumbel.to(vals.dtype), dim=-1)
    sampled = torch.gather(idxs, -1, choice[:, None])[:, 0]
    return torch.where(do_sample, sampled, greedy)


class Generator:
    """Prefill plus decode over the dense cache.

    forward_fn(params, tokens, cache, start_pos) -> (logits, cache) defaults
    to the Llama forward; any model with that signature works.
    """

    def __init__(
        self,
        params: Any,
        cfg: Any,
        max_new_tokens: int = 256,
        cache_len: Optional[int] = None,
        do_sample: bool = False,
        top_k: int = 20,
        temperature: float = 0.6,
        top_p: float = 1.0,
        eos_token_id: Optional[int] = None,
        forward_fn: Optional[Callable] = None,
        cache_dtype=torch.bfloat16,
        device="cuda",
    ):
        self.params = params
        self.cfg = cfg
        self.max_new_tokens = max_new_tokens
        self.cache_len = cache_len
        self.do_sample = do_sample
        self.top_k = top_k
        self.temperature = temperature
        self.top_p = top_p
        self.eos_token_id = eos_token_id
        self.cache_dtype = cache_dtype
        self.device = torch.device(device)
        self._forward = forward_fn or (
            lambda p, toks, cache, pos: llama.forward(p, cfg, toks, cache, pos)
        )

    def _sample(self, logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        return sample_token(logits, generator, self.do_sample, self.top_k, self.temperature,
                            self.top_p)

    @torch.inference_mode()
    def generate(self, input_ids, max_new_tokens: Optional[int] = None,
                 seed: int = 0) -> np.ndarray:
        """input_ids: [B, T] token ids (list, numpy or tensor). Returns the
        generated ids [B, <= max_new_tokens] (prompt not included) as a
        numpy array."""
        input_ids = np.asarray(input_ids)
        if input_ids.ndim == 1:
            input_ids = input_ids[None]
        b, t = input_ids.shape
        steps = max_new_tokens or self.max_new_tokens
        dev = self.device

        cache_len = self.cache_len or next_power_of_2(t + steps + 1)
        cache = llama.init_cache(self.cfg, b, cache_len, self.cache_dtype, dev)

        t_pad = next_power_of_2(max(t, 2))
        prompt = np.zeros((b, t_pad), np.int64)
        prompt[:, :t] = input_ids
        logits, cache = self._forward(self.params, torch.from_numpy(prompt).to(dev), cache, 0)
        gen = torch.Generator(device=dev).manual_seed(seed)
        tok = self._sample(logits[:, t - 1], gen)

        eos = self.eos_token_id
        done = torch.zeros((b,), dtype=torch.bool, device=dev)
        outs = [tok]
        for i in range(steps - 1):
            logits, cache = self._forward(self.params, tok[:, None], cache, t + i)
            nxt = self._sample(logits[:, -1], gen)
            if eos is not None:
                # once a decode step has emitted EOS its row keeps emitting it
                nxt = torch.where(done, torch.full_like(nxt, eos), nxt)
                done = done | (nxt == eos)
            tok = nxt
            outs.append(tok)
        out = torch.stack(outs, dim=1).cpu().numpy()

        if eos is not None and b == 1:
            idx = np.where(out[0] == eos)[0]
            return out[:, : idx[0] + 1] if len(idx) else out
        return out
