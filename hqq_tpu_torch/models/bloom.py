# SPDX-License-Identifier: Apache-2.0
"""BLOOM family (bloom-560m to 176B, bloomz).

Mirrors `hqq_tpu.models.bloom` (HF ``modeling_bloom.py``). Beside the
llama walk:

* ALiBi alone, no rotary and no learned positions: ``slope * j`` added to
  the scores, unscaled (`falcon.alibi_bias` without a head size);
* a LayerNorm right after the token embedding
  (``word_embeddings_layernorm``);
* the fused ``query_key_value`` interleaved per head, [nh, 3, hd];
* sequential pre-LN blocks with the tanh-GELU MLP, and
  ``apply_residual_connection_post_layernorm``: the residual branch starts
  from the norm's output instead of x;
* the head tied to ``word_embeddings``.

Every LayerNorm is one launch of the fixed-order kernel. Attention is
plain torch over the dense cache's float pools, as `hqq_tpu` writes it;
int8 pools are not read (``reads_int8_kv``) and there is no paged branch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import ClassVar, Dict, Optional

import torch
import torch.nn.functional as F

from ..nn.linear import Linear
from . import llama
from .falcon import alibi_bias
from .llama import KVCache, init_cache, refuse_int8_pools  # noqa: F401
from .llama import layer_norm as ln

__all__ = ["BloomConfig", "forward", "init_cache", "init_params", "params_from_hf_state_dict"]


@dataclasses.dataclass(frozen=True)
class BloomConfig:
    vocab_size: int = 250880
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    layer_norm_epsilon: float = 1e-5
    apply_residual_connection_post_layernorm: bool = False
    tie_word_embeddings: bool = True
    # read by the shared helpers
    sliding_window: Optional[int] = None
    rope_theta: float = 10000.0
    max_position_embeddings: int = 2048

    # the forward reads the dense cache's float pools only
    reads_int8_kv: ClassVar[bool] = False

    @property
    def head_dim_(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_key_value_heads(self) -> int:
        return self.num_attention_heads

    @classmethod
    def from_hf(cls, hf: dict) -> "BloomConfig":
        return cls(
            vocab_size=hf["vocab_size"],
            hidden_size=hf.get("hidden_size", hf.get("n_embed", 1024)),
            num_hidden_layers=hf.get("num_hidden_layers", hf.get("n_layer", 24)),
            num_attention_heads=hf.get("num_attention_heads", hf.get("n_head", 16)),
            layer_norm_epsilon=hf.get("layer_norm_epsilon", 1e-5),
            apply_residual_connection_post_layernorm=hf.get(
                "apply_residual_connection_post_layernorm", False),
            tie_word_embeddings=hf.get("tie_word_embeddings", True),
        )

    @classmethod
    def tiny(cls, vocab_size: int = 256, **kw) -> "BloomConfig":
        return cls(vocab_size=vocab_size, hidden_size=64, num_hidden_layers=2,
                   num_attention_heads=4, **kw)


def forward(params: dict, cfg: BloomConfig, tokens: torch.Tensor, cache=None, start_pos=0):
    """`llama.forward`'s contract over a dense `KVCache` (float pools) or
    ``cache=None``: (logits [B, T, V] fp32, cache)."""
    refuse_int8_pools(cache, "bloom")
    b, t = tokens.shape
    nh, hd = cfg.num_attention_heads, cfg.head_dim_
    eps = cfg.layer_norm_epsilon
    x = params["word_embeddings"][tokens]
    s_len = t if cache is None else cache.max_len
    _, _, mask = llama.causal_mask(t, start_pos, None if cache is None else s_len, None,
                                   x.device)
    mask = mask + alibi_bias(nh, s_len, x.device)
    x = ln(x, params["word_embeddings_layernorm"], eps)
    post = cfg.apply_residual_connection_post_layernorm

    for i, layer in enumerate(params["layers"]):
        h = ln(x, layer["input_layernorm"], eps)
        qkv = layer["self_attn"]["query_key_value"](h).reshape(b, t, nh, 3, hd)
        q, k, v = (qkv[..., j, :].transpose(1, 2) for j in range(3))
        x = (h if post else x) + layer["self_attn"]["dense"](
            llama.float_attention(q, k, v, cache, i, start_pos, mask))
        h = ln(x, layer["post_attention_layernorm"], eps)
        mlp = layer["mlp"]
        x = (h if post else x) + mlp["dense_4h_to_h"](
            F.gelu(mlp["dense_h_to_4h"](h), approximate="tanh"))

    x = ln(x, params["ln_f"], eps)
    return x.to(torch.float32) @ params["word_embeddings"].to(torch.float32).t(), cache


def init_params(cfg: BloomConfig, generator: Optional[torch.Generator] = None,
                dtype=torch.bfloat16, device="cuda") -> dict:
    """Random tree in `hqq_tpu`'s layout: linears N(0, 1/in_features) with
    zero biases, drawn in fp32 from ``generator`` (seed 0 on ``device``
    when None); LayerNorms weight one and bias zero."""
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    d = cfg.hidden_size

    def randn(*shape):
        return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)

    def lin(o, i):
        return Linear((randn(o, i) / math.sqrt(i)).to(dtype),
                      torch.zeros((o,), dtype=dtype, device=device))

    def norm():
        return {"weight": torch.ones((d,), dtype=dtype, device=device),
                "bias": torch.zeros((d,), dtype=dtype, device=device)}

    layers = [{"input_layernorm": norm(),
               "self_attn": {"query_key_value": lin(3 * d, d), "dense": lin(d, d)},
               "post_attention_layernorm": norm(),
               "mlp": {"dense_h_to_4h": lin(4 * d, d), "dense_4h_to_h": lin(d, 4 * d)}}
              for _ in range(cfg.num_hidden_layers)]
    return {"word_embeddings": (randn(cfg.vocab_size, d) * 0.02).to(dtype),
            "word_embeddings_layernorm": norm(), "layers": layers, "ln_f": norm()}


def params_from_hf_state_dict(state: Dict[str, torch.Tensor], cfg: BloomConfig,
                              dtype=torch.bfloat16) -> dict:
    """An HF `BloomForCausalLM` state dict as the tree."""

    def arr(name):
        return state[name].to(dtype)

    def lin(prefix):
        return Linear(arr(prefix + ".weight"), arr(prefix + ".bias"))

    def norm(prefix):
        return {"weight": arr(prefix + ".weight"), "bias": arr(prefix + ".bias")}

    layers = []
    for i in range(cfg.num_hidden_layers):
        p = f"transformer.h.{i}"
        layers.append({
            "input_layernorm": norm(f"{p}.input_layernorm"),
            "self_attn": {"query_key_value": lin(f"{p}.self_attention.query_key_value"),
                          "dense": lin(f"{p}.self_attention.dense")},
            "post_attention_layernorm": norm(f"{p}.post_attention_layernorm"),
            "mlp": {"dense_h_to_4h": lin(f"{p}.mlp.dense_h_to_4h"),
                    "dense_4h_to_h": lin(f"{p}.mlp.dense_4h_to_h")},
        })
    return {"word_embeddings": arr("transformer.word_embeddings.weight"),
            "word_embeddings_layernorm": norm("transformer.word_embeddings_layernorm"),
            "layers": layers, "ln_f": norm("transformer.ln_f")}
