# SPDX-License-Identifier: Apache-2.0
"""Phi family (phi-1, phi-1.5, phi-2): parallel attention and MLP from one
LayerNorm, partial rotary embeddings, biased layers.

Mirrors `hqq_tpu.models.phi` (HF ``PhiForCausalLM``): per block
``x = x + attn(LN(x)) + mlp(LN(x))``, the same normed input feeding both
branches; RoPE over the first ``rotary_dim = partial_rotary_factor *
head_dim`` dims of q and k only (Phi-2: 32 of 80); attention scores in
fp32; an untied ``lm_head`` with a bias.

`utils.patching.fuse_for_decode` joins q, k and v into ``qkv_proj``, and
the attention here reads it where present (`hqq_tpu`'s Phi forward reads
``q_proj`` and fails on a fused layer instead).

Every LayerNorm is one launch of the fixed-order kernel. Attention is
plain torch over the dense cache's float pools; int8 pools are not read
(``reads_int8_kv``) and there is no paged branch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import ClassVar, Dict, Optional

import torch
import torch.nn.functional as F

from ..nn.linear import Linear
from . import llama
from .llama import KVCache, init_cache, refuse_int8_pools  # noqa: F401
from .llama import layer_norm as ln

__all__ = ["PhiConfig", "forward", "init_cache", "init_params", "params_from_hf_state_dict"]


@dataclasses.dataclass(frozen=True)
class PhiConfig:
    vocab_size: int = 51200
    hidden_size: int = 2048
    intermediate_size: int = 8192
    num_hidden_layers: int = 24
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 2048
    layer_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    partial_rotary_factor: float = 0.5
    tie_word_embeddings: bool = False
    # read by the shared helpers
    rms_norm_eps: float = 1e-5
    sliding_window: Optional[int] = None

    # the forward reads the dense cache's float pools only
    reads_int8_kv: ClassVar[bool] = False

    @property
    def head_dim_(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def rotary_dim(self) -> int:
        return int(self.partial_rotary_factor * self.head_dim_)

    @classmethod
    def from_hf(cls, hf: dict) -> "PhiConfig":
        return cls(
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"],
            num_hidden_layers=hf["num_hidden_layers"],
            num_attention_heads=hf["num_attention_heads"],
            num_key_value_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
            max_position_embeddings=hf.get("max_position_embeddings", 2048),
            layer_norm_eps=hf.get("layer_norm_eps", 1e-5),
            rope_theta=hf.get("rope_theta", 10000.0),
            partial_rotary_factor=hf.get("partial_rotary_factor", 0.5),
            tie_word_embeddings=hf.get("tie_word_embeddings", False),
        )

    @classmethod
    def phi2(cls) -> "PhiConfig":
        """microsoft/phi-2's published config: hidden 2560, ffn 10240, 32
        layers, 32 heads of 80, partial rotary 0.4, vocab 51200."""
        return cls(hidden_size=2560, intermediate_size=10240, num_hidden_layers=32,
                   partial_rotary_factor=0.4)

    @classmethod
    def tiny(cls, vocab_size: int = 256) -> "PhiConfig":
        return cls(vocab_size=vocab_size, hidden_size=256, intermediate_size=512,
                   num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
                   max_position_embeddings=512)


def _partial_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                  rotary_dim: int) -> torch.Tensor:
    """RoPE over the first ``rotary_dim`` dims of x [B, H, T, hd]; the rest
    passes through."""
    return torch.cat([llama._apply_rope(x[..., :rotary_dim], cos, sin), x[..., rotary_dim:]],
                     dim=-1)


def _attention(layer: dict, cfg: PhiConfig, x: torch.Tensor, cache, layer_idx: int,
               start_pos, mask: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    b, t, _ = x.shape
    nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_
    if "qkv_proj" in layer:  # fused by `fuse_for_decode`: one wide matmul
        q, k, v = torch.split(layer["qkv_proj"](x), [nh * hd, nkv * hd, nkv * hd], dim=-1)
    else:
        q, k, v = layer["q_proj"](x), layer["k_proj"](x), layer["v_proj"](x)
    q = q.reshape(b, t, nh, hd).transpose(1, 2)
    k = k.reshape(b, t, nkv, hd).transpose(1, 2)
    v = v.reshape(b, t, nkv, hd).transpose(1, 2)
    q, k = _partial_rope(q, cos, sin, cfg.rotary_dim), _partial_rope(k, cos, sin, cfg.rotary_dim)
    return layer["dense"](llama.float_attention(q, k, v, cache, layer_idx, start_pos, mask))


def forward(params: dict, cfg: PhiConfig, tokens: torch.Tensor, cache=None, start_pos=0):
    """`llama.forward`'s contract over a dense `KVCache` (float pools) or
    ``cache=None``: (logits [B, T, V] fp32, cache)."""
    refuse_int8_pools(cache, "phi")
    t = tokens.shape[1]
    x = params["embed_tokens"][tokens]
    _, pos_bt, mask = llama.causal_mask(t, start_pos, None if cache is None else cache.max_len,
                                        cfg.sliding_window, x.device)
    rd = cfg.rotary_dim
    cos, sin = llama._rope_cos_sin(pos_bt.reshape(-1), rd, cfg.rope_theta)
    cos = cos.reshape(*pos_bt.shape, rd)[:, None]
    sin = sin.reshape(*pos_bt.shape, rd)[:, None]

    for i, layer in enumerate(params["layers"]):
        h = ln(x, layer["input_layernorm"], cfg.layer_norm_eps)
        mlp = layer["mlp"]
        x = (x + _attention(layer["self_attn"], cfg, h, cache, i, start_pos, mask, cos, sin)
             + mlp["fc2"](F.gelu(mlp["fc1"](h), approximate="tanh")))

    x = ln(x, params["final_layernorm"], cfg.layer_norm_eps)
    return params["lm_head"](x).to(torch.float32), cache


def init_params(cfg: PhiConfig, generator: Optional[torch.Generator] = None,
                dtype=torch.bfloat16, device="cuda") -> dict:
    """Random tree in `hqq_tpu`'s layout: linears N(0, 1/in_features) with
    zero biases (the head too), drawn in fp32 from ``generator`` (seed 0 on
    ``device`` when None); LayerNorms weight one and bias zero."""
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
                             "v_proj": lin(nkv * hd, d), "dense": lin(d, nh * hd)},
               "mlp": {"fc1": lin(f, d), "fc2": lin(d, f)},
               "input_layernorm": norm()}
              for _ in range(cfg.num_hidden_layers)]
    embed = (randn(cfg.vocab_size, d) * 0.02).to(dtype)
    return {"embed_tokens": embed, "layers": layers, "final_layernorm": norm(),
            "lm_head": lin(cfg.vocab_size, d)}


def params_from_hf_state_dict(state: Dict[str, torch.Tensor], cfg: PhiConfig,
                              dtype=torch.bfloat16) -> dict:
    """An HF `PhiForCausalLM` state dict as the tree."""

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
                          for n in ("q_proj", "k_proj", "v_proj", "dense")},
            "mlp": {"fc1": lin(f"{p}.mlp.fc1"), "fc2": lin(f"{p}.mlp.fc2")},
            "input_layernorm": norm(f"{p}.input_layernorm"),
        })
    return {"embed_tokens": arr("model.embed_tokens.weight"), "layers": layers,
            "final_layernorm": norm("model.final_layernorm"), "lm_head": lin("lm_head")}
