# SPDX-License-Identifier: Apache-2.0
"""OLMo-2 family: a "norm-after" decoder.

Mirrors `hqq_tpu.models.olmo2` (HF `Olmo2ForCausalLM`): no input norms;
each sublayer reads x as it is and its output is normed before the
residual add; q and k are normed over the flat projection (``q_norm_flat``
over nh * hd, ``k_norm_flat`` over n_kv * hd) before the heads are split
and rotated, which `llama._qkv_rope` does where a layer holds those norms.
So q, k and v must stay three layers: `utils.patching.fuse_for_decode`
leaves an OLMo-2 layer as it is. There is no paged branch, as in
`hqq_tpu`: the server serves OLMo-2 on the dense engine.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ..nn.linear import Linear
from . import llama
from .llama import KVCache, init_cache, rms_norm  # noqa: F401

__all__ = ["Olmo2Config", "init_params", "forward", "init_cache", "params_from_hf_state_dict"]


@dataclasses.dataclass(frozen=True)
class Olmo2Config(llama.LlamaConfig):
    vocab_size: int = 100352
    rms_norm_eps: float = 1e-6
    rope_theta: float = 500000.0

    @classmethod
    def olmo2_7b(cls) -> "Olmo2Config":
        """allenai/OLMo-2-1124-7B's published config."""
        return cls(vocab_size=100352, hidden_size=4096, intermediate_size=11008,
                   num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=32,
                   max_position_embeddings=4096, rms_norm_eps=1e-6, rope_theta=500000.0)

    @classmethod
    def tiny(cls, vocab_size: int = 256) -> "Olmo2Config":
        return cls(vocab_size=vocab_size, hidden_size=256, intermediate_size=512,
                   num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                   max_position_embeddings=512)


def init_params(cfg: Olmo2Config, generator: Optional[torch.Generator] = None,
                dtype=torch.bfloat16, device="cuda") -> dict:
    """`llama.init_params` plus the flat q/k norms and the post-MLP norm
    (the tree of `hqq_tpu`'s init, whose ``input_layernorm`` the forward
    does not read)."""
    params = llama.init_params(cfg, generator, dtype, device)
    nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_
    for layer in params["layers"]:
        layer["self_attn"]["q_norm_flat"] = torch.ones((nh * hd,), dtype=dtype, device=device)
        layer["self_attn"]["k_norm_flat"] = torch.ones((nkv * hd,), dtype=dtype, device=device)
        layer["post_feedforward_layernorm"] = torch.ones((cfg.hidden_size,), dtype=dtype,
                                                         device=device)
    return params


def forward(params: dict, cfg: Olmo2Config, tokens: torch.Tensor, cache=None, start_pos=0):
    """`llama.forward`'s contract over a dense `KVCache` or ``cache=None``
    (the naive attention over the sequence, as in `hqq_tpu`)."""
    x = params["embed_tokens"][tokens]
    _, cos, sin, mask = llama.positions_and_masks(
        cfg, tokens.shape[1], start_pos, None if cache is None else cache.max_len, x.device)
    for i, layer in enumerate(params["layers"]):
        attn = llama._attention(layer["self_attn"], cfg, x, cache, i, start_pos, mask, cos, sin)
        x = x + rms_norm(attn, layer["post_attention_layernorm"], cfg.rms_norm_eps)
        x = x + rms_norm(llama._mlp(layer["mlp"], x), layer["post_feedforward_layernorm"],
                         cfg.rms_norm_eps)
    x = rms_norm(x, params["norm"], cfg.rms_norm_eps)
    if "lm_head" in params:
        return params["lm_head"](x).to(torch.float32), cache
    return x.to(torch.float32) @ params["embed_tokens"].to(torch.float32).t(), cache


def params_from_hf_state_dict(state: Dict[str, torch.Tensor], cfg: Olmo2Config,
                              dtype=torch.bfloat16) -> dict:
    """An HF `Olmo2ForCausalLM` state dict as the tree."""

    def arr(name):
        return state[name].to(dtype)

    def lin(prefix):
        bias = prefix + ".bias"
        return Linear(arr(prefix + ".weight"), arr(bias) if bias in state else None)

    layers = []
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}"
        sa = {n: lin(f"{p}.self_attn.{n}") for n in ("q_proj", "k_proj", "v_proj", "o_proj")}
        sa["q_norm_flat"] = arr(f"{p}.self_attn.q_norm.weight")
        sa["k_norm_flat"] = arr(f"{p}.self_attn.k_norm.weight")
        layers.append({
            "self_attn": sa,
            "mlp": {n: lin(f"{p}.mlp.{n}") for n in ("gate_proj", "up_proj", "down_proj")},
            "post_attention_layernorm": arr(f"{p}.post_attention_layernorm.weight"),
            "post_feedforward_layernorm": arr(f"{p}.post_feedforward_layernorm.weight"),
        })
    return {"embed_tokens": arr("model.embed_tokens.weight"), "layers": layers,
            "norm": arr("model.norm.weight"), "lm_head": lin("lm_head")}
