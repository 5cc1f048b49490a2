# SPDX-License-Identifier: Apache-2.0
"""IBM Granite family: Llama-shaped with the muP-style scalars.

Mirrors `hqq_tpu.models.granite` (HF `GraniteForCausalLM`): the embeddings
times ``embedding_multiplier``, each block's attention and MLP outputs
times ``residual_multiplier``, the scores times ``attention_multiplier``
in place of 1/sqrt(hd), the logits divided by ``logits_scaling``. The
block is `llama`'s; the multipliers are applied in the activations' type,
as `hqq_tpu` applies them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import llama
from .llama import KVCache, _scaled, init_cache, init_params, rms_norm  # noqa: F401

__all__ = ["GraniteConfig", "forward", "init_params", "init_cache", "KVCache"]


@dataclasses.dataclass(frozen=True)
class GraniteConfig(llama.LlamaConfig):
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    attention_multiplier: float = 1.0
    logits_scaling: float = 1.0

    @classmethod
    def from_hf(cls, hf: dict) -> "GraniteConfig":
        base = llama.LlamaConfig.from_hf(hf)
        return cls(**dataclasses.asdict(base),
                   embedding_multiplier=hf.get("embedding_multiplier", 1.0),
                   residual_multiplier=hf.get("residual_multiplier", 1.0),
                   attention_multiplier=hf.get("attention_multiplier", 1.0),
                   logits_scaling=hf.get("logits_scaling", 1.0))

    @classmethod
    def tiny(cls, vocab_size: int = 256) -> "GraniteConfig":
        return cls(vocab_size=vocab_size, hidden_size=256, intermediate_size=512,
                   num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                   max_position_embeddings=512, embedding_multiplier=12.0,
                   residual_multiplier=0.22, attention_multiplier=0.015625, logits_scaling=8.0)


def _forward_paged(params: dict, cfg: GraniteConfig, tokens: torch.Tensor, cache,
                   lengths: torch.Tensor, page_indices: torch.Tensor):
    """One paged step (see `llama._forward_paged`): the attention multiplier
    is the query scale, so the plain-causal layers reach the paged-attention
    kernel; no window, as in `hqq_tpu`."""
    toks = tokens if tokens.ndim == 2 else tokens[:, None]
    x = _scaled(params["embed_tokens"][toks], cfg.embedding_multiplier)
    lengths, page_indices = lengths.to(x.device), page_indices.to(x.device)
    _, cos, sin, _ = llama.positions_and_masks(cfg, toks.shape[1], lengths, None, x.device)
    for i, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["input_layernorm"], cfg.rms_norm_eps)
        attn = llama._attention_paged(layer["self_attn"], cfg, h, cache, i, lengths, page_indices,
                                      cos, sin, q_scale=cfg.attention_multiplier)
        x = x + _scaled(attn, cfg.residual_multiplier)
        h = rms_norm(x, layer["post_attention_layernorm"], cfg.rms_norm_eps)
        x = x + _scaled(llama._mlp(layer["mlp"], h), cfg.residual_multiplier)
    return llama._logits(params, cfg, x) / cfg.logits_scaling, cache


def forward(params: dict, cfg: GraniteConfig, tokens: torch.Tensor, cache=None, start_pos=0,
            page_indices: Optional[torch.Tensor] = None):
    """`llama.forward`'s contract with Granite's scalars: a dense `KVCache`
    (float or int8 pools), a `PagedKVCache` with ``page_indices``, or
    ``cache=None`` (the naive attention over the sequence, as in
    `hqq_tpu`)."""
    from ..ops.paged import PagedKVCache

    if isinstance(cache, PagedKVCache):
        if page_indices is None:
            raise ValueError("a PagedKVCache needs page_indices")
        return _forward_paged(params, cfg, tokens, cache,
                              torch.as_tensor(start_pos, device=cache.k.device), page_indices)
    x = _scaled(params["embed_tokens"][tokens], cfg.embedding_multiplier)
    _, cos, sin, mask = llama.positions_and_masks(
        cfg, tokens.shape[1], start_pos, None if cache is None else cache.max_len, x.device)
    for i, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["input_layernorm"], cfg.rms_norm_eps)
        attn = llama._attention(layer["self_attn"], cfg, h, cache, i, start_pos, mask, cos, sin,
                                scale=cfg.attention_multiplier)
        x = x + _scaled(attn, cfg.residual_multiplier)
        h = rms_norm(x, layer["post_attention_layernorm"], cfg.rms_norm_eps)
        x = x + _scaled(llama._mlp(layer["mlp"], h), cfg.residual_multiplier)
    return llama._logits(params, cfg, x) / cfg.logits_scaling, cache
