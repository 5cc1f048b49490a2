# SPDX-License-Identifier: Apache-2.0
"""Phi-3 decoder: Llama-shaped with natively fused projections.

Mirrors `hqq_tpu.models.phi3`. HF `Phi3ForCausalLM` stores
``self_attn.qkv_proj`` and ``mlp.gate_up_proj`` as single linears, the keys
`llama.forward` already reads (`fuse_for_decode` makes the same ones for
the other families), so the forward is `llama.forward` and the loader maps
the weights as they are. Each fused projection quantizes, and prepares to
``w4a8``, as one layer of its full width.

LongRoPE (``rope_scaling``) is not implemented: `Phi3Config.from_hf`
refuses it, as `hqq_tpu` does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

from ..nn.linear import Linear
from . import llama
from .llama import KVCache, forward, init_cache  # noqa: F401  (the forward is llama's)

__all__ = ["Phi3Config", "init_params", "forward", "init_cache", "params_from_hf_state_dict"]


@dataclasses.dataclass(frozen=True)
class Phi3Config(llama.LlamaConfig):
    @classmethod
    def from_hf(cls, hf: dict) -> "Phi3Config":
        if hf.get("rope_scaling") not in (None, {}):
            raise ValueError("Phi-3 LongRoPE (rope_scaling) is not implemented; use the "
                             "base-context checkpoints or strip the scaling for short contexts")
        return cls(**dataclasses.asdict(llama.LlamaConfig.from_hf(hf)))

    @classmethod
    def tiny(cls, vocab_size: int = 256) -> "Phi3Config":
        return cls(vocab_size=vocab_size, hidden_size=128, intermediate_size=256,
                   num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                   max_position_embeddings=256)


def init_params(cfg: Phi3Config, generator: Optional[torch.Generator] = None,
                dtype=torch.bfloat16, device="cuda") -> dict:
    """Random tree with the native fused projections (`llama.init_params`'
    draws, N(0, 1/in_features), seed 0 on ``device`` when no
    ``generator``)."""
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    d, f = cfg.hidden_size, cfg.intermediate_size
    nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_

    def randn(*shape):
        return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)

    def lin(out_f, in_f):
        return Linear((randn(out_f, in_f) / math.sqrt(in_f)).to(dtype))

    def ones():
        return torch.ones((d,), dtype=dtype, device=device)

    layers = [{
        "self_attn": {"qkv_proj": lin((nh + 2 * nkv) * hd, d), "o_proj": lin(d, nh * hd)},
        "mlp": {"gate_up_proj": lin(2 * f, d), "down_proj": lin(d, f)},
        "input_layernorm": ones(),
        "post_attention_layernorm": ones(),
    } for _ in range(cfg.num_hidden_layers)]
    params = {"embed_tokens": (randn(cfg.vocab_size, d) * 0.02).to(dtype), "layers": layers,
              "norm": ones()}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = lin(cfg.vocab_size, d)
    return params


def params_from_hf_state_dict(state: Dict[str, torch.Tensor], cfg: Phi3Config,
                              dtype=torch.bfloat16) -> dict:
    """An HF `Phi3ForCausalLM` state dict (fused qkv/gate_up) as the tree."""

    def arr(name):
        return state[name].to(dtype)

    def lin(prefix):
        bias = prefix + ".bias"
        return Linear(arr(prefix + ".weight"), arr(bias) if bias in state else None)

    layers = []
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}"
        layers.append({
            "self_attn": {"qkv_proj": lin(f"{p}.self_attn.qkv_proj"),
                          "o_proj": lin(f"{p}.self_attn.o_proj")},
            "mlp": {"gate_up_proj": lin(f"{p}.mlp.gate_up_proj"),
                    "down_proj": lin(f"{p}.mlp.down_proj")},
            "input_layernorm": arr(f"{p}.input_layernorm.weight"),
            "post_attention_layernorm": arr(f"{p}.post_attention_layernorm.weight"),
        })
    params = {"embed_tokens": arr("model.embed_tokens.weight"), "layers": layers,
              "norm": arr("model.norm.weight")}
    if "lm_head.weight" in state:
        params["lm_head"] = lin("lm_head")
    return params
