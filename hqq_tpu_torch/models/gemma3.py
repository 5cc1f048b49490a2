# SPDX-License-Identifier: Apache-2.0
"""Gemma-3 (text) family: Gemma-2's block with per-head q/k norms in place
of the attention softcap, two RoPE base frequencies (a local one on
sliding layers, the global theta on full ones) and ``layer_types`` from
the config (else 5 sliding layers to 1 full).

Mirrors `hqq_tpu.models.gemma3` (HF `Gemma3ForCausalLM`). The paged step
is Gemma-2's: sliding layers take the gather route (their window), full
layers have no window and no softcap and reach the paged-attention kernel,
at head size 256 on the published configs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from . import llama
from .gemma import _embed, _gemma_norm, _tied_logits
from .gemma2 import Gemma2Config, _block, _forward_paged
from .gemma2 import init_params as _gemma2_init
from .gemma2 import params_from_hf_state_dict as _gemma2_load
from .llama import KVCache, init_cache  # noqa: F401

__all__ = ["Gemma3Config", "init_params", "forward", "init_cache", "params_from_hf_state_dict"]


@dataclasses.dataclass(frozen=True)
class Gemma3Config(Gemma2Config):
    attn_logit_softcapping: Optional[float] = None
    final_logit_softcapping: Optional[float] = None
    rope_local_base_freq: float = 10000.0
    rope_theta: float = 1000000.0
    layer_types: Optional[tuple] = None  # from the HF config; else the 5:1 pattern

    def __post_init__(self):
        super().__post_init__()
        # a JSON sidecar gives lists back; the config stays hashable
        if isinstance(self.layer_types, list):
            object.__setattr__(self, "layer_types", tuple(self.layer_types))

    def layer_is_sliding(self, i: int) -> bool:
        if self.layer_types is not None:
            return self.layer_types[i] == "sliding_attention"
        return (i + 1) % 6 != 0

    @classmethod
    def from_hf(cls, hf: dict) -> "Gemma3Config":
        lt = hf.get("layer_types")
        return cls(
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"],
            num_hidden_layers=hf["num_hidden_layers"],
            num_attention_heads=hf["num_attention_heads"],
            num_key_value_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
            head_dim=hf.get("head_dim", 256),
            max_position_embeddings=hf.get("max_position_embeddings", 32768),
            rms_norm_eps=hf.get("rms_norm_eps", 1e-6),
            rope_theta=hf.get("rope_theta", 1_000_000.0),
            rope_local_base_freq=hf.get("rope_local_base_freq", 10_000.0),
            sliding_window=hf.get("sliding_window", 4096),
            query_pre_attn_scalar=hf.get("query_pre_attn_scalar", 256.0),
            attn_logit_softcapping=hf.get("attn_logit_softcapping"),
            final_logit_softcapping=hf.get("final_logit_softcapping"),
            layer_types=tuple(lt) if lt else None,
            tie_word_embeddings=True,
        )

    @classmethod
    def gemma3_12b(cls) -> "Gemma3Config":
        """google/gemma-3-12b's text model, as its published config gives it."""
        return cls(vocab_size=262208, hidden_size=3840, intermediate_size=15360,
                   num_hidden_layers=48, num_attention_heads=16, num_key_value_heads=8,
                   head_dim=256, max_position_embeddings=131072, rms_norm_eps=1e-6,
                   rope_theta=1_000_000.0, rope_local_base_freq=10_000.0, sliding_window=1024,
                   query_pre_attn_scalar=256.0)

    @classmethod
    def tiny(cls, vocab_size: int = 256) -> "Gemma3Config":
        return cls(vocab_size=vocab_size, hidden_size=256, intermediate_size=512,
                   num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                   head_dim=64, max_position_embeddings=512, query_pre_attn_scalar=64.0,
                   sliding_window=16, layer_types=("sliding_attention", "full_attention"))


def init_params(cfg: Gemma3Config, generator: Optional[torch.Generator] = None,
                dtype=torch.bfloat16, device="cuda") -> dict:
    """Gemma-2's tree plus per-head ``q_norm``/``k_norm`` at zero."""
    params = _gemma2_init(cfg, generator, dtype, device)
    hd = cfg.head_dim_
    for layer in params["layers"]:
        layer["self_attn"]["q_norm"] = torch.zeros((hd,), dtype=dtype, device=device)
        layer["self_attn"]["k_norm"] = torch.zeros((hd,), dtype=dtype, device=device)
    return params


def forward(params: dict, cfg: Gemma3Config, tokens: torch.Tensor, cache=None, start_pos=0,
            page_indices: Optional[torch.Tensor] = None):
    """`llama.forward`'s contract: a dense `KVCache`, a `PagedKVCache` with
    ``page_indices`` (Gemma-2's paged step), or ``cache=None``. The dense
    and cache-free attention is not capped, as in `hqq_tpu`."""
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
    _, cos_g, sin_g, mask_full = llama.positions_and_masks(cfg_full, t, start_pos, cache_len,
                                                           x.device)
    cfg_local = dataclasses.replace(cfg, rope_theta=cfg.rope_local_base_freq)
    _, cos_l, sin_l, mask_sliding = llama.positions_and_masks(cfg_local, t, start_pos, cache_len,
                                                              x.device)
    scale = cfg.query_pre_attn_scalar**-0.5
    for i, layer in enumerate(params["layers"]):
        sliding = cfg.layer_is_sliding(i)
        mask = mask_sliding if sliding else mask_full
        cos, sin = (cos_l, sin_l) if sliding else (cos_g, sin_g)

        def attn(h, i=i, layer=layer, mask=mask, cos=cos, sin=sin):
            return llama._attention(layer["self_attn"], cfg, h, cache, i, start_pos, mask, cos,
                                    sin, scale=scale, norm_offset=1.0)

        x = _block(layer, cfg, x, attn)
    x = _gemma_norm(x, params["norm"], cfg.rms_norm_eps)
    return _tied_logits(params, x), cache


def params_from_hf_state_dict(state: Dict[str, torch.Tensor], cfg: Gemma3Config,
                              dtype=torch.bfloat16) -> dict:
    """Gemma-2's mapping plus each layer's ``q_norm``/``k_norm``."""
    params = _gemma2_load(state, cfg, dtype)
    for i, layer in enumerate(params["layers"]):
        p = f"model.layers.{i}.self_attn"
        layer["self_attn"]["q_norm"] = state[f"{p}.q_norm.weight"].to(dtype)
        layer["self_attn"]["k_norm"] = state[f"{p}.k_norm.weight"].to(dtype)
    return params
