# SPDX-License-Identifier: Apache-2.0
"""Mixtral (sparse MoE): Llama attention with a top-k routed MoE block in
place of the MLP.

Mirrors `hqq_tpu.models.mixtral` (HF `MixtralForCausalLM`): the router
``block_sparse_moe.gate`` stays in full precision while the experts
quantize (`quantize_mixtral`); the experts ``w1`` (gate), ``w3`` (up) and
``w2`` (down) are stacked `GroupedLinear`s or `GroupedQuantLinear`s with
GShard capacity routing (`nn.moe`): one batched product per stack, at
decode the grouped kernel. ``capacity_factor`` at E / top_k (4.0 for
Mixtral's 8 experts and top-2) drops no assignment; at the default 2.0 a
token may lose an expert to its neighbours in the batch, as in `hqq_tpu`.

`forward` has the dense-cache, ``cache=None`` and paged branches of
`llama.forward`; the paged step is llama's walk with the MoE block as its
MLP. Expert parallelism (``ep_axis``, `parallel/`) is not ported: a config
that sets it raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

from ..nn.linear import Linear
from ..nn.moe import GroupedLinear, quantize_experts, refuse_expert_parallel, swiglu_moe
from . import llama
from .llama import KVCache, init_cache, rms_norm  # noqa: F401

__all__ = ["MixtralConfig", "init_params", "forward", "init_cache", "quantize_mixtral",
           "params_from_hf_state_dict"]


@dataclasses.dataclass(frozen=True)
class MixtralConfig(llama.LlamaConfig):
    num_local_experts: int = 8
    num_experts_per_tok: int = 2
    capacity_factor: float = 2.0  # >= E/top_k drops nothing
    ep_axis: Optional[str] = None  # expert parallelism: not ported, must stay None

    def __post_init__(self):
        super().__post_init__()
        refuse_expert_parallel(self)

    @classmethod
    def from_hf(cls, hf: dict) -> "MixtralConfig":
        base = llama.LlamaConfig.from_hf(hf)
        return cls(**dataclasses.asdict(base),
                   num_local_experts=hf.get("num_local_experts", 8),
                   num_experts_per_tok=hf.get("num_experts_per_tok", 2))

    @classmethod
    def mixtral_8x7b(cls) -> "MixtralConfig":
        """mistralai/Mixtral-8x7B-v0.1 as published (from memory: no copy of
        its config.json is in this repo)."""
        return cls(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
                   num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
                   max_position_embeddings=32768, rms_norm_eps=1e-5, rope_theta=1e6,
                   num_local_experts=8, num_experts_per_tok=2)

    @classmethod
    def tiny(cls, vocab_size: int = 256) -> "MixtralConfig":
        return cls(vocab_size=vocab_size, hidden_size=128, intermediate_size=256,
                   num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                   max_position_embeddings=256, num_local_experts=4, num_experts_per_tok=2)


def init_params(cfg: MixtralConfig, generator: Optional[torch.Generator] = None,
                dtype=torch.bfloat16, device="cuda") -> dict:
    """`llama.init_params`'s attention, norms and embeddings, each layer's
    MLP replaced by the router and the stacked experts (weights N(0, 1/in),
    drawn in fp32 from ``generator``, seed 0 on ``device`` when None)."""
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    params = llama.init_params(dataclasses.replace(cfg, intermediate_size=8), generator, dtype,
                               device)
    d, f, e = cfg.hidden_size, cfg.intermediate_size, cfg.num_local_experts

    def randn(*shape, fan_in):
        w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (w / math.sqrt(fan_in)).to(dtype)

    for layer in params["layers"]:
        layer.pop("mlp")
        layer["block_sparse_moe"] = {
            "gate": Linear(randn(e, d, fan_in=d)),
            # HF Mixtral naming: w1 = gate, w3 = up ([f, d]), w2 = down ([d, f])
            "experts": {"w1": GroupedLinear(randn(e, f, d, fan_in=d)),
                        "w2": GroupedLinear(randn(e, d, f, fan_in=f)),
                        "w3": GroupedLinear(randn(e, f, d, fan_in=d))},
        }
    return params


def _moe_block(block: dict, cfg: MixtralConfig, x: torch.Tensor) -> torch.Tensor:
    """x [B, T, D] -> [B, T, D] through the top-k routed experts."""
    return swiglu_moe(block, ("w1", "w3", "w2"), x, cfg.num_experts_per_tok, cfg.capacity_factor)


def forward(params: dict, cfg: MixtralConfig, tokens: torch.Tensor, cache=None, start_pos=0,
            page_indices: Optional[torch.Tensor] = None):
    """`llama.forward`'s contract (a dense `KVCache`, a `PagedKVCache` with
    ``page_indices``, or ``cache=None``) with the MoE block as the MLP."""
    from ..ops.paged import PagedKVCache

    if isinstance(cache, PagedKVCache):
        if page_indices is None:
            raise ValueError("a PagedKVCache needs page_indices")
        return llama._forward_paged(
            params, cfg, tokens, cache, torch.as_tensor(start_pos, device=cache.k.device),
            page_indices, mlp_fn=lambda layer, h: _moe_block(layer["block_sparse_moe"], cfg, h))
    t = tokens.shape[1]
    x = params["embed_tokens"][tokens]
    _, cos, sin, mask = llama.positions_and_masks(
        cfg, t, start_pos, None if cache is None else cache.max_len, x.device)
    for i, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["input_layernorm"], cfg.rms_norm_eps)
        if cache is None:
            x = x + llama._attention_nocache(layer["self_attn"], cfg, h, mask, cos, sin)
        else:
            x = x + llama._attention(layer["self_attn"], cfg, h, cache, i, start_pos, mask, cos,
                                     sin)
        h = rms_norm(x, layer["post_attention_layernorm"], cfg.rms_norm_eps)
        x = x + _moe_block(layer["block_sparse_moe"], cfg, h)
    return llama._logits(params, cfg, x), cache


def quantize_mixtral(params: dict, attn_config: Optional[dict] = None,
                     expert_config: Optional[dict] = None, compute_dtype=torch.bfloat16) -> dict:
    """Quantize the attention (`quantize_model`) and the stacked experts, in
    place; the router gate and lm_head stay in full precision, as in
    `hqq_tpu`. Default configs 4-bit g64 for both."""
    from ..core.quantize import BaseQuantizeConfig
    from .base import quantize_model

    attn_config = attn_config or BaseQuantizeConfig(nbits=4, group_size=64)
    expert_config = expert_config or BaseQuantizeConfig(nbits=4, group_size=64)
    quantize_model(params, attn_config, compute_dtype, ignore=("lm_head", "block_sparse_moe.gate"))
    for layer in params["layers"]:
        quantize_experts(layer["block_sparse_moe"]["experts"], ("w1", "w2", "w3"), expert_config,
                         compute_dtype)
    return params


def params_from_hf_state_dict(state: Dict[str, torch.Tensor], cfg: MixtralConfig,
                              dtype=torch.bfloat16) -> dict:
    """An HF Mixtral state dict as the tree: each layer's experts
    ``block_sparse_moe.experts.{e}.w{1,2,3}`` stacked along E."""

    def arr(name):
        return state[name].to(dtype)

    def lin(prefix):
        bias = prefix + ".bias"
        return Linear(arr(prefix + ".weight"), arr(bias) if bias in state else None)

    layers = []
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}"
        experts = {w: GroupedLinear(torch.stack([
            arr(f"{p}.block_sparse_moe.experts.{e}.{w}.weight")
            for e in range(cfg.num_local_experts)])) for w in ("w1", "w2", "w3")}
        layers.append({
            "self_attn": {f"{n}_proj": lin(f"{p}.self_attn.{n}_proj") for n in "qkvo"},
            "block_sparse_moe": {"gate": lin(f"{p}.block_sparse_moe.gate"), "experts": experts},
            "input_layernorm": arr(f"{p}.input_layernorm.weight"),
            "post_attention_layernorm": arr(f"{p}.post_attention_layernorm.weight"),
        })
    params = {"embed_tokens": arr("model.embed_tokens.weight"), "layers": layers,
              "norm": arr("model.norm.weight")}
    if "lm_head.weight" in state:
        params["lm_head"] = lin("lm_head")
    return params
