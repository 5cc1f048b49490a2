# SPDX-License-Identifier: Apache-2.0
"""StarCoder2 family: the llama walk with biased LayerNorms, biased
linears, a plain ``c_fc``/``c_proj`` tanh-GELU MLP, GQA and an optional
sliding window.

Mirrors `hqq_tpu.models.starcoder2` (HF ``Starcoder2ForCausalLM``).
Attention is `llama._attention` over the dense cache (its float pools or
its int8 ones, with their scales: ``quantize_kv`` serves this family) and
`llama._attention_nocache` without one, so ``cache=None`` reaches the flash
kernel where there is no window. q, k and v fuse into ``qkv_proj``
(`fuse_for_decode`), which `llama._qkv_rope` reads. Every LayerNorm is one
launch of the fixed-order kernel. As in `hqq_tpu`, `init_params` and the
loader default to fp32. There is no paged branch: the server serves the
family on the dense engine.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..nn.linear import Linear
from . import llama
from .llama import KVCache, init_cache  # noqa: F401
from .llama import layer_norm as ln

__all__ = ["Starcoder2Config", "forward", "init_cache", "init_params",
           "params_from_hf_state_dict"]


@dataclasses.dataclass(frozen=True)
class Starcoder2Config(llama.LlamaConfig):
    vocab_size: int = 49152
    hidden_size: int = 3072
    intermediate_size: int = 12288
    num_hidden_layers: int = 30
    num_attention_heads: int = 24
    num_key_value_heads: int = 2
    rope_theta: float = 100000.0
    sliding_window: Optional[int] = 4096
    norm_epsilon: float = 1e-5
    tie_word_embeddings: bool = True

    @classmethod
    def from_hf(cls, hf: dict) -> "Starcoder2Config":
        return cls(
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"],
            num_hidden_layers=hf["num_hidden_layers"],
            num_attention_heads=hf["num_attention_heads"],
            num_key_value_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
            max_position_embeddings=hf.get("max_position_embeddings", 4096),
            rope_theta=hf.get("rope_theta", 100000.0),
            sliding_window=hf.get("sliding_window"),
            norm_epsilon=hf.get("norm_epsilon", 1e-5),
            tie_word_embeddings=hf.get("tie_word_embeddings", True),
        )

    @classmethod
    def starcoder2_7b(cls) -> "Starcoder2Config":
        """bigcode/starcoder2-7b's published config: hidden 4608, ffn 18432,
        32 layers, 36/4 heads, vocab 49152, window 4096, rope theta 1e6,
        16384 positions."""
        return cls(hidden_size=4608, intermediate_size=18432, num_hidden_layers=32,
                   num_attention_heads=36, num_key_value_heads=4, rope_theta=1000000.0,
                   max_position_embeddings=16384, sliding_window=4096)

    @classmethod
    def tiny(cls, vocab_size: int = 256) -> "Starcoder2Config":
        return cls(vocab_size=vocab_size, hidden_size=256, intermediate_size=512,
                   num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                   max_position_embeddings=512, sliding_window=None)


def forward(params: dict, cfg: Starcoder2Config, tokens: torch.Tensor, cache=None, start_pos=0):
    """`llama.forward`'s contract over a dense `KVCache` (float or int8
    pools) or ``cache=None``: (logits [B, T, V] fp32, cache)."""
    x = params["embed_tokens"][tokens]
    _, cos, sin, mask = llama.positions_and_masks(
        cfg, tokens.shape[1], start_pos, None if cache is None else cache.max_len, x.device)
    eps = cfg.norm_epsilon
    for i, layer in enumerate(params["layers"]):
        h = ln(x, layer["input_layernorm"], eps)
        if cache is None:
            x = x + llama._attention_nocache(layer["self_attn"], cfg, h, mask, cos, sin)
        else:
            x = x + llama._attention(layer["self_attn"], cfg, h, cache, i, start_pos, mask, cos,
                                     sin)
        h = ln(x, layer["post_attention_layernorm"], eps)
        mlp = layer["mlp"]
        x = x + mlp["c_proj"](F.gelu(mlp["c_fc"](h), approximate="tanh"))
    x = ln(x, params["norm"], eps)
    if cfg.tie_word_embeddings or "lm_head" not in params:
        return x.to(torch.float32) @ params["embed_tokens"].to(torch.float32).t(), cache
    return params["lm_head"](x).to(torch.float32), cache


def init_params(cfg: Starcoder2Config, generator: Optional[torch.Generator] = None,
                dtype=torch.float32, device="cuda") -> dict:
    """Random tree in `hqq_tpu`'s layout: linears N(0, 1/in_features) with
    zero biases, drawn in fp32 from ``generator`` (seed 0 on ``device``
    when None); LayerNorms weight one and bias zero."""
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    d, f = cfg.hidden_size, cfg.intermediate_size
    nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_

    def randn(*shape):
        return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)

    def lin(o, i):
        return Linear((randn(o, i) / math.sqrt(i)).to(dtype),
                      torch.zeros((o,), dtype=dtype, device=device))

    def norm():
        return {"weight": torch.ones((d,), dtype=dtype, device=device),
                "bias": torch.zeros((d,), dtype=dtype, device=device)}

    layers = [{"self_attn": {"q_proj": lin(nh * hd, d), "k_proj": lin(nkv * hd, d),
                             "v_proj": lin(nkv * hd, d), "o_proj": lin(d, nh * hd)},
               "mlp": {"c_fc": lin(f, d), "c_proj": lin(d, f)},
               "input_layernorm": norm(), "post_attention_layernorm": norm()}
              for _ in range(cfg.num_hidden_layers)]
    return {"embed_tokens": (randn(cfg.vocab_size, d) * 0.02).to(dtype), "layers": layers,
            "norm": norm()}


def params_from_hf_state_dict(state: Dict[str, torch.Tensor], cfg: Starcoder2Config,
                              dtype=torch.float32) -> dict:
    """An HF `Starcoder2ForCausalLM` state dict as the tree."""

    def arr(name):
        return state[name].to(dtype)

    def lin(prefix):
        bias = prefix + ".bias"
        return Linear(arr(prefix + ".weight"), arr(bias) if bias in state else None)

    def norm(prefix):
        return {"weight": arr(prefix + ".weight"), "bias": arr(prefix + ".bias")}

    layers = []
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}"
        layers.append({
            "self_attn": {n: lin(f"{p}.self_attn.{n}")
                          for n in ("q_proj", "k_proj", "v_proj", "o_proj")},
            "mlp": {"c_fc": lin(f"{p}.mlp.c_fc"), "c_proj": lin(f"{p}.mlp.c_proj")},
            "input_layernorm": norm(f"{p}.input_layernorm"),
            "post_attention_layernorm": norm(f"{p}.post_attention_layernorm"),
        })
    params = {"embed_tokens": arr("model.embed_tokens.weight"), "layers": layers,
              "norm": norm("model.norm")}
    if "lm_head.weight" in state and not cfg.tie_word_embeddings:
        params["lm_head"] = lin("lm_head")
    return params
