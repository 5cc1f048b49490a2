# SPDX-License-Identifier: Apache-2.0
"""Falcon family: 7B (multi-query), 40B/180B (new decoder architecture)
and RW (ALiBi).

Mirrors `hqq_tpu.models.falcon` (HF ``modeling_falcon.py``). Three block
variants:

* ``new_decoder_architecture``: the fused ``query_key_value`` in grouped
  layout, n_kv groups of (nh / n_kv queries, one key, one value), two
  parallel LayerNorms (``ln_attn``, ``ln_mlp``) and ``x + attn + mlp``;
* ``multi_query`` (7B): q is [nh heads | 1 key | 1 value], one
  ``input_layernorm`` whose output feeds attention and the MLP alike;
* sequential blocks (RW): input and post-attention LayerNorms, usually
  with ``alibi``: per-head linear biases on the key positions in place of
  rotary embeddings. Like `hqq_tpu` (and HF's eager path) the bias is
  applied twice, ``2 * slope * j / sqrt(hd)``, with the slopes rounded
  through bf16.

Every LayerNorm is one launch of the fixed-order kernel (`ops.norm`). The
MLP is dense_h_to_4h, the tanh GELU (`jax.nn.gelu`'s default, which
`hqq_tpu` calls; HF's Falcon uses the erf form), dense_4h_to_h. The
embedding is the head unless ``tie_word_embeddings`` is off.

Attention is plain torch over the dense cache's float pools
(`llama.float_attention`); this forward does not read int8 pools
(``reads_int8_kv``), and there is no paged branch: the server serves the
family on the dense engine.
"""

from __future__ import annotations

import dataclasses
import math
from typing import ClassVar, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..nn.linear import Linear
from . import llama
from .llama import KVCache, init_cache, refuse_int8_pools  # noqa: F401
from .llama import layer_norm as ln

__all__ = ["FalconConfig", "alibi_slopes", "alibi_bias", "forward", "init_cache", "init_params",
           "params_from_hf_state_dict"]


@dataclasses.dataclass(frozen=True)
class FalconConfig:
    vocab_size: int = 65024
    hidden_size: int = 4544
    num_hidden_layers: int = 32
    num_attention_heads: int = 71
    num_kv_heads: Optional[int] = None
    new_decoder_architecture: bool = False
    multi_query: bool = True
    parallel_attn: bool = True
    num_ln_in_parallel_attn: Optional[int] = None
    bias: bool = False
    alibi: bool = False
    rope_theta: float = 10000.0
    layer_norm_epsilon: float = 1e-5
    max_position_embeddings: int = 2048
    tie_word_embeddings: bool = True
    # read by the shared helpers
    sliding_window: Optional[int] = None
    rope_scaling: Optional[tuple] = None

    # the forward reads the dense cache's float pools only
    reads_int8_kv: ClassVar[bool] = False

    @property
    def head_dim_(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def n_kv_(self) -> int:
        """The kv heads: the groups of the new architecture, 1 for
        multi-query, nh otherwise."""
        if self.new_decoder_architecture:
            return self.num_kv_heads or self.num_attention_heads
        return 1 if self.multi_query else self.num_attention_heads

    @property
    def num_key_value_heads(self) -> int:
        return self.n_kv_

    @property
    def two_ln(self) -> bool:
        n = self.num_ln_in_parallel_attn
        if n is None and self.new_decoder_architecture:
            n = 2
        return n == 2

    @classmethod
    def from_hf(cls, hf: dict) -> "FalconConfig":
        return cls(
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            num_hidden_layers=hf["num_hidden_layers"],
            num_attention_heads=hf["num_attention_heads"],
            num_kv_heads=hf.get("num_kv_heads"),
            new_decoder_architecture=hf.get("new_decoder_architecture", False),
            multi_query=hf.get("multi_query", True),
            parallel_attn=hf.get("parallel_attn", True),
            num_ln_in_parallel_attn=hf.get("num_ln_in_parallel_attn"),
            bias=hf.get("bias", False),
            alibi=hf.get("alibi", False),
            rope_theta=hf.get("rope_theta", 10000.0),
            layer_norm_epsilon=hf.get("layer_norm_epsilon", 1e-5),
            max_position_embeddings=hf.get("max_position_embeddings", 2048),
            tie_word_embeddings=hf.get("tie_word_embeddings", True),
        )

    @classmethod
    def falcon_7b(cls) -> "FalconConfig":
        """tiiuae/falcon-7b's published config: hidden 4544, 32 layers, 71
        heads of 64, multi-query, parallel attention with one norm, no
        bias, no ALiBi, vocab 65024, tied head."""
        return cls()

    @classmethod
    def tiny(cls, vocab_size: int = 256, **kw) -> "FalconConfig":
        return cls(vocab_size=vocab_size, hidden_size=64, num_hidden_layers=2,
                   num_attention_heads=4, max_position_embeddings=128, **kw)


def alibi_slopes(n_heads: int) -> torch.Tensor:
    """ALiBi's per-head slopes (HF ``build_alibi_tensor``): powers of
    2^(-8/n) for the closest power of two n, the odd powers of the next
    one's base beyond it; fp32 [n_heads] on the CPU."""
    closest = 2 ** math.floor(math.log2(n_heads))
    base = 2.0 ** (-(2.0 ** -(math.log2(closest) - 3)))
    slopes = [base ** p for p in range(1, closest + 1)]
    if closest != n_heads:
        extra_base = 2.0 ** (-(2.0 ** -(math.log2(2 * closest) - 3)))
        slopes += [extra_base ** p for p in range(1, 2 * (n_heads - closest) + 1, 2)]
    return torch.tensor(slopes, dtype=torch.float32)


def alibi_bias(n_heads: int, s_len: int, device, head_dim: Optional[int] = None) -> torch.Tensor:
    """The additive ALiBi bias [1, nh, 1, S] over key positions j < S:
    Bloom's ``slope * j``; with ``head_dim`` Falcon's ``2 * slope * j /
    sqrt(head_dim)`` with the slopes rounded through bf16 first (HF's
    eager path applies the bias in the mask and again in the scores)."""
    slopes = alibi_slopes(n_heads)
    keys = torch.arange(s_len, device=device, dtype=torch.float32)
    if head_dim is None:
        return (slopes.to(device)[:, None, None] * keys[None, None, :])[None]
    slopes = slopes.to(torch.bfloat16).to(torch.float32).to(device)
    return (2.0 * slopes[:, None, None] * keys[None, None, :] / math.sqrt(head_dim))[None]


def _split_heads(cfg: FalconConfig, qkv: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The fused projection [B, T, ...] as q [B, nh, T, hd] and k, v
    [B, n_kv, T, hd] in each of the three layouts."""
    b, t, _ = qkv.shape
    nh, hd = cfg.num_attention_heads, cfg.head_dim_
    if cfg.new_decoder_architecture:
        nkv = cfg.n_kv_
        g = nh // nkv
        x = qkv.reshape(b, t, nkv, g + 2, hd)
        q = x[:, :, :, :g].reshape(b, t, nh, hd)
        k, v = x[:, :, :, g], x[:, :, :, g + 1]
    elif cfg.multi_query:
        x = qkv.reshape(b, t, nh + 2, hd)
        q, k, v = x[:, :, :nh], x[:, :, nh:nh + 1], x[:, :, nh + 1:]
    else:
        x = qkv.reshape(b, t, nh, 3, hd)
        q, k, v = x[..., 0, :], x[..., 1, :], x[..., 2, :]
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def forward(params: dict, cfg: FalconConfig, tokens: torch.Tensor, cache=None, start_pos=0):
    """`llama.forward`'s contract over a dense `KVCache` (float pools) or
    ``cache=None``: (logits [B, T, V] fp32, cache)."""
    refuse_int8_pools(cache, "falcon")
    t = tokens.shape[1]
    nh, hd = cfg.num_attention_heads, cfg.head_dim_
    eps = cfg.layer_norm_epsilon
    x = params["word_embeddings"][tokens]
    device = x.device
    s_len = t if cache is None else cache.max_len
    if cfg.alibi:
        _, _, mask = llama.causal_mask(t, start_pos, None if cache is None else s_len, None,
                                       device)
        mask = mask + alibi_bias(nh, s_len, device, hd)
        cos = sin = None
    else:
        _, cos, sin, mask = llama.positions_and_masks(
            cfg, t, start_pos, None if cache is None else s_len, device)

    for i, layer in enumerate(params["layers"]):
        if cfg.parallel_attn and cfg.two_ln:
            attn_in = ln(x, layer["ln_attn"], eps)
            mlp_in = ln(x, layer["ln_mlp"], eps)
        else:
            attn_in = mlp_in = ln(x, layer["input_layernorm"], eps)
        q, k, v = _split_heads(cfg, layer["self_attn"]["query_key_value"](attn_in))
        if not cfg.alibi:
            q, k = llama._apply_rope(q, cos, sin), llama._apply_rope(k, cos, sin)
        attn_out = layer["self_attn"]["dense"](
            llama.float_attention(q, k, v, cache, i, start_pos, mask))
        mlp = layer["mlp"]
        if cfg.parallel_attn:
            x = x + attn_out + mlp["dense_4h_to_h"](
                F.gelu(mlp["dense_h_to_4h"](mlp_in), approximate="tanh"))
        else:
            x = x + attn_out
            h = ln(x, layer["post_attention_layernorm"], eps)
            x = x + mlp["dense_4h_to_h"](F.gelu(mlp["dense_h_to_4h"](h), approximate="tanh"))

    x = ln(x, params["ln_f"], eps)
    if cfg.tie_word_embeddings or "lm_head" not in params:
        return x.to(torch.float32) @ params["word_embeddings"].to(torch.float32).t(), cache
    return params["lm_head"](x).to(torch.float32), cache


def _qkv_width(cfg: FalconConfig) -> int:
    nh, hd = cfg.num_attention_heads, cfg.head_dim_
    if cfg.new_decoder_architecture:
        return (2 * cfg.n_kv_ + nh) * hd
    return (nh + 2) * hd if cfg.multi_query else 3 * cfg.hidden_size


def init_params(cfg: FalconConfig, generator: Optional[torch.Generator] = None,
                dtype=torch.bfloat16, device="cuda") -> dict:
    """Random tree in `hqq_tpu`'s layout: linears N(0, 1/in_features)
    drawn in fp32 from ``generator`` (seed 0 on ``device`` when None),
    biases zero where ``bias``, LayerNorms weight one and bias zero."""
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    d = cfg.hidden_size

    def randn(*shape):
        return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)

    def lin(o, i):
        bias = torch.zeros((o,), dtype=dtype, device=device) if cfg.bias else None
        return Linear((randn(o, i) / math.sqrt(i)).to(dtype), bias)

    def norm():
        return {"weight": torch.ones((d,), dtype=dtype, device=device),
                "bias": torch.zeros((d,), dtype=dtype, device=device)}

    layers = []
    for _ in range(cfg.num_hidden_layers):
        layer = {"self_attn": {"query_key_value": lin(_qkv_width(cfg), d), "dense": lin(d, d)},
                 "mlp": {"dense_h_to_4h": lin(4 * d, d), "dense_4h_to_h": lin(d, 4 * d)}}
        if cfg.parallel_attn and cfg.two_ln:
            layer["ln_attn"], layer["ln_mlp"] = norm(), norm()
        else:
            layer["input_layernorm"] = norm()
            if not cfg.parallel_attn:
                layer["post_attention_layernorm"] = norm()
        layers.append(layer)
    return {"word_embeddings": (randn(cfg.vocab_size, d) * 0.02).to(dtype), "layers": layers,
            "ln_f": norm()}


def params_from_hf_state_dict(state: Dict[str, torch.Tensor], cfg: FalconConfig,
                              dtype=torch.bfloat16) -> dict:
    """An HF `FalconForCausalLM` state dict as the tree."""

    def arr(name):
        return state[name].to(dtype)

    def lin(prefix):
        bias = prefix + ".bias"
        return Linear(arr(prefix + ".weight"), arr(bias) if bias in state else None)

    def norm(prefix):
        return {"weight": arr(prefix + ".weight"), "bias": arr(prefix + ".bias")}

    layers = []
    for i in range(cfg.num_hidden_layers):
        p = f"transformer.h.{i}"
        layer = {
            "self_attn": {"query_key_value": lin(f"{p}.self_attention.query_key_value"),
                          "dense": lin(f"{p}.self_attention.dense")},
            "mlp": {"dense_h_to_4h": lin(f"{p}.mlp.dense_h_to_4h"),
                    "dense_4h_to_h": lin(f"{p}.mlp.dense_4h_to_h")},
        }
        if f"{p}.ln_attn.weight" in state:
            layer["ln_attn"], layer["ln_mlp"] = norm(f"{p}.ln_attn"), norm(f"{p}.ln_mlp")
        else:
            layer["input_layernorm"] = norm(f"{p}.input_layernorm")
            if f"{p}.post_attention_layernorm.weight" in state:
                layer["post_attention_layernorm"] = norm(f"{p}.post_attention_layernorm")
        layers.append(layer)
    params = {"word_embeddings": arr("transformer.word_embeddings.weight"), "layers": layers,
              "ln_f": norm("transformer.ln_f")}
    if not cfg.tie_word_embeddings and "lm_head.weight" in state:
        params["lm_head"] = lin("lm_head")
    return params
