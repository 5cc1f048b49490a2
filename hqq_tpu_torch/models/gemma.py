# SPDX-License-Identifier: Apache-2.0
"""Gemma family: a Llama-shaped decoder with Gemma's deltas.

Mirrors `hqq_tpu.models.gemma` (HF `GemmaForCausalLM`): embeddings scaled
by sqrt(hidden) in their own type, RMSNorm weighted by ``(1 + w)`` (the
norm kernel with offset 1), a GeGLU MLP (GELU, tanh form), embeddings tied
to the head. Attention and the caches are `llama`'s. There is no paged
branch, as in `hqq_tpu`: the server serves Gemma on the dense engine.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from ..ops.norm import apply_rms_norm
from . import llama
from .llama import KVCache, _scaled, init_cache  # noqa: F401

__all__ = ["GemmaConfig", "init_params", "forward", "init_cache", "KVCache"]


@dataclasses.dataclass(frozen=True)
class GemmaConfig(llama.LlamaConfig):
    """Gemma-2B-like defaults; `from_hf` reads real configs."""

    vocab_size: int = 256000
    hidden_size: int = 2048
    intermediate_size: int = 16384
    num_hidden_layers: int = 18
    num_attention_heads: int = 8
    num_key_value_heads: int = 1
    head_dim: Optional[int] = 256
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = True

    @classmethod
    def tiny(cls, vocab_size: int = 256) -> "GemmaConfig":
        return cls(vocab_size=vocab_size, hidden_size=256, intermediate_size=512,
                   num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                   head_dim=64, max_position_embeddings=512)


def init_params(cfg: GemmaConfig, generator: Optional[torch.Generator] = None,
                dtype=torch.bfloat16, device="cuda") -> dict:
    """`llama.init_params` without ``lm_head``: the head is always tied."""
    params = llama.init_params(cfg, generator, dtype, device)
    params.pop("lm_head", None)
    return params


def _gemma_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm weighted by (1 + w), fp32 inside (HF `GemmaRMSNorm`)."""
    return apply_rms_norm(x, w, eps, 1.0)


def _gemma_mlp(layer: dict, x: torch.Tensor) -> torch.Tensor:
    if "gate_up_proj" in layer:  # fused by `fuse_for_decode`
        gate, up = layer["gate_up_proj"](x).chunk(2, dim=-1)
    else:
        gate, up = layer["gate_proj"](x), layer["up_proj"](x)
    return layer["down_proj"](F.gelu(gate, approximate="tanh") * up)


def _embed(params: dict, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """The token embeddings times sqrt(hidden), in the embeddings' type."""
    return _scaled(params["embed_tokens"][tokens], cfg.hidden_size**0.5)


def _tied_logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32) @ params["embed_tokens"].to(torch.float32).t()


def forward(params: dict, cfg: GemmaConfig, tokens: torch.Tensor, cache=None, start_pos=0):
    """`llama.forward`'s contract over a dense `KVCache` or ``cache=None``,
    with Gemma's norm, activation and embedding scale."""
    x = _embed(params, cfg, tokens)
    _, cos, sin, mask = llama.positions_and_masks(
        cfg, tokens.shape[1], start_pos, None if cache is None else cache.max_len, x.device)
    for i, layer in enumerate(params["layers"]):
        h = _gemma_norm(x, layer["input_layernorm"], cfg.rms_norm_eps)
        if cache is None:
            x = x + llama._attention_nocache(layer["self_attn"], cfg, h, mask, cos, sin)
        else:
            x = x + llama._attention(layer["self_attn"], cfg, h, cache, i, start_pos, mask, cos,
                                     sin)
        h = _gemma_norm(x, layer["post_attention_layernorm"], cfg.rms_norm_eps)
        x = x + _gemma_mlp(layer["mlp"], h)
    x = _gemma_norm(x, params["norm"], cfg.rms_norm_eps)
    return _tied_logits(params, x), cache
