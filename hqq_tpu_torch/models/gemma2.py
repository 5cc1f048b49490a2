# SPDX-License-Identifier: Apache-2.0
"""Gemma-2 family: Gemma's deltas plus logit softcaps, a query scale of
query_pre_attn_scalar^-0.5, norms before and after both sublayers, and
layers that alternate between a sliding window and full attention.

Mirrors `hqq_tpu.models.gemma2` (HF `Gemma2ForCausalLM`):

    x = x + post_attn_norm(attn(input_norm(x)))
    x = x + post_ffn_norm(mlp(pre_ffn_norm(x)))
    scores = cap * tanh(scores / cap);  logits = cap_f * tanh(logits / cap_f)

Every norm is the norm kernel with offset 1. The paged step is shared with
Gemma-3; with a softcap every Gemma-2 layer takes the gather route of
`ops.paged.paged_attn`, as in `hqq_tpu`, so the paged-attention kernel
does not run for Gemma-2.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ..nn.linear import Linear
from . import llama
from .gemma import GemmaConfig, _embed, _gemma_mlp, _gemma_norm, _tied_logits
from .llama import KVCache, init_cache  # noqa: F401

__all__ = ["Gemma2Config", "init_params", "forward", "init_cache", "params_from_hf_state_dict"]


@dataclasses.dataclass(frozen=True)
class Gemma2Config(GemmaConfig):
    attn_logit_softcapping: Optional[float] = 50.0
    final_logit_softcapping: Optional[float] = 30.0
    query_pre_attn_scalar: float = 256.0
    sliding_window: Optional[int] = 4096

    def layer_is_sliding(self, i: int) -> bool:
        return i % 2 == 0  # HF: even layers sliding, odd layers full attention

    @classmethod
    def from_hf(cls, hf: dict) -> "Gemma2Config":
        base = GemmaConfig.from_hf(hf)
        return cls(**dataclasses.asdict(base),
                   attn_logit_softcapping=hf.get("attn_logit_softcapping", 50.0),
                   final_logit_softcapping=hf.get("final_logit_softcapping", 30.0),
                   query_pre_attn_scalar=hf.get("query_pre_attn_scalar", 256.0))

    @classmethod
    def gemma2_9b(cls) -> "Gemma2Config":
        """google/gemma-2-9b's published config."""
        return cls(vocab_size=256000, hidden_size=3584, intermediate_size=14336,
                   num_hidden_layers=42, num_attention_heads=16, num_key_value_heads=8,
                   head_dim=256, max_position_embeddings=8192, rms_norm_eps=1e-6,
                   rope_theta=10000.0, sliding_window=4096, query_pre_attn_scalar=256.0,
                   attn_logit_softcapping=50.0, final_logit_softcapping=30.0)

    @classmethod
    def tiny(cls, vocab_size: int = 256) -> "Gemma2Config":
        return cls(vocab_size=vocab_size, hidden_size=256, intermediate_size=512,
                   num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                   head_dim=64, max_position_embeddings=512, query_pre_attn_scalar=64.0,
                   sliding_window=16)


def init_params(cfg: Gemma2Config, generator: Optional[torch.Generator] = None,
                dtype=torch.bfloat16, device="cuda") -> dict:
    """`llama.init_params` without ``lm_head``, with the four norms of a
    block and the final one at zero: (1 + w) is then the identity."""
    params = llama.init_params(cfg, generator, dtype, device)
    params.pop("lm_head", None)
    d = cfg.hidden_size

    def zeros():
        return torch.zeros((d,), dtype=dtype, device=device)

    for layer in params["layers"]:
        for name in ("input_layernorm", "post_attention_layernorm", "pre_feedforward_layernorm",
                     "post_feedforward_layernorm"):
            layer[name] = zeros()
    params["norm"] = zeros()
    return params


def _softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    return x if cap is None else torch.tanh(x / cap) * cap


def _block(layer: dict, cfg, x: torch.Tensor, attn) -> torch.Tensor:
    """One block around ``attn(h)``: the sandwich norms and the GeGLU MLP."""
    h = _gemma_norm(x, layer["input_layernorm"], cfg.rms_norm_eps)
    x = x + _gemma_norm(attn(h), layer["post_attention_layernorm"], cfg.rms_norm_eps)
    h = _gemma_norm(x, layer["pre_feedforward_layernorm"], cfg.rms_norm_eps)
    h = _gemma_mlp(layer["mlp"], h)
    return x + _gemma_norm(h, layer["post_feedforward_layernorm"], cfg.rms_norm_eps)


def _forward_paged(params: dict, cfg, tokens: torch.Tensor, cache, lengths: torch.Tensor,
                   page_indices: torch.Tensor):
    """One paged step for Gemma-2 and Gemma-3: the sandwich norms, the
    embedding scale, sliding and full layers, Gemma-3's two RoPE tables
    (its local base frequency on sliding layers) and per-head q/k norms,
    the softcaps where the config has them. A layer with a window or a
    softcap takes the gather route; Gemma-3's full layers the kernel."""
    toks = tokens if tokens.ndim == 2 else tokens[:, None]
    t = toks.shape[1]
    x = _embed(params, cfg, toks)
    lengths, page_indices = lengths.to(x.device), page_indices.to(x.device)
    cfg_full = dataclasses.replace(cfg, sliding_window=None)
    _, cos_g, sin_g, _ = llama.positions_and_masks(cfg_full, t, lengths, None, x.device)
    local_theta = getattr(cfg, "rope_local_base_freq", None)
    if local_theta is not None:
        cfg_local = dataclasses.replace(cfg, rope_theta=local_theta)
        _, cos_l, sin_l, _ = llama.positions_and_masks(cfg_local, t, lengths, None, x.device)
    else:
        cos_l, sin_l = cos_g, sin_g
    q_scale = cfg.query_pre_attn_scalar**-0.5

    for i, layer in enumerate(params["layers"]):
        sliding = cfg.layer_is_sliding(i)
        window = cfg.sliding_window if sliding else None
        cos, sin = (cos_l, sin_l) if sliding else (cos_g, sin_g)

        def attn(h, i=i, layer=layer, window=window, cos=cos, sin=sin):
            return llama._attention_paged(layer["self_attn"], cfg, h, cache, i, lengths,
                                          page_indices, cos, sin, window=window, q_scale=q_scale,
                                          softcap=cfg.attn_logit_softcapping, norm_offset=1.0)

        x = _block(layer, cfg, x, attn)
    x = _gemma_norm(x, params["norm"], cfg.rms_norm_eps)
    return _softcap(_tied_logits(params, x), getattr(cfg, "final_logit_softcapping", None)), cache


def forward(params: dict, cfg: Gemma2Config, tokens: torch.Tensor, cache=None, start_pos=0,
            page_indices: Optional[torch.Tensor] = None):
    """`llama.forward`'s contract: a dense `KVCache`, a `PagedKVCache` with
    ``page_indices``, or ``cache=None`` (the naive attention over the
    sequence with each layer's mask, as in `hqq_tpu`)."""
    from ..ops.paged import PagedKVCache

    if isinstance(cache, PagedKVCache):
        if page_indices is None:
            raise ValueError("a PagedKVCache needs page_indices")
        return _forward_paged(params, cfg, tokens, cache,
                              torch.as_tensor(start_pos, device=cache.k.device), page_indices)
    t = tokens.shape[1]
    x = _embed(params, cfg, tokens)
    cache_len = None if cache is None else cache.max_len
    cfg_full = dataclasses.replace(cfg, sliding_window=None)
    _, cos, sin, mask_full = llama.positions_and_masks(cfg_full, t, start_pos, cache_len, x.device)
    _, _, _, mask_sliding = llama.positions_and_masks(cfg, t, start_pos, cache_len, x.device)
    scale = cfg.query_pre_attn_scalar**-0.5
    for i, layer in enumerate(params["layers"]):
        mask = mask_sliding if cfg.layer_is_sliding(i) else mask_full

        def attn(h, i=i, layer=layer, mask=mask):
            return llama._attention(layer["self_attn"], cfg, h, cache, i, start_pos, mask, cos,
                                    sin, scale=scale, softcap=cfg.attn_logit_softcapping)

        x = _block(layer, cfg, x, attn)
    x = _gemma_norm(x, params["norm"], cfg.rms_norm_eps)
    return _softcap(_tied_logits(params, x), cfg.final_logit_softcapping), cache


def params_from_hf_state_dict(state: Dict[str, torch.Tensor], cfg: Gemma2Config,
                              dtype=torch.bfloat16) -> dict:
    """An HF `Gemma2ForCausalLM` state dict (4 norms a block, tied head) as
    the tree."""

    def arr(name):
        return state[name].to(dtype)

    def lin(prefix):
        bias = prefix + ".bias"
        return Linear(arr(prefix + ".weight"), arr(bias) if bias in state else None)

    layers = []
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}"
        layer = {
            "self_attn": {n: lin(f"{p}.self_attn.{n}") for n in ("q_proj", "k_proj", "v_proj",
                                                                   "o_proj")},
            "mlp": {n: lin(f"{p}.mlp.{n}") for n in ("gate_proj", "up_proj", "down_proj")},
        }
        for n in ("input_layernorm", "post_attention_layernorm", "pre_feedforward_layernorm",
                  "post_feedforward_layernorm"):
            layer[n] = arr(f"{p}.{n}.weight")
        layers.append(layer)
    return {"embed_tokens": arr("model.embed_tokens.weight"), "layers": layers,
            "norm": arr("model.norm.weight")}
