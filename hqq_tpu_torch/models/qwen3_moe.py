# SPDX-License-Identifier: Apache-2.0
"""Qwen3-MoE: Qwen3's attention (per-head q/k RMSNorm) with a top-k routed
MoE block as the MLP.

Mirrors `hqq_tpu.models.qwen3_moe` (HF `Qwen3MoeForCausalLM`): the router
``mlp.gate`` stays in full precision, the experts
``mlp.experts.{gate,up,down}_proj`` are stacked (`nn.moe`) with
``moe_intermediate_size`` hidden width, and the layers of
``mlp_only_layers`` keep a dense Llama MLP. The routing weights are the
renormalized top-k (HF ``norm_topk_prob=True``). Expert parallelism
(``ep_axis``) is not ported: a config that sets it raises.
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

__all__ = ["Qwen3MoeConfig", "init_params", "forward", "init_cache", "quantize_qwen3_moe",
           "params_from_hf_state_dict"]

_EXPERTS = ("gate_proj", "up_proj", "down_proj")


@dataclasses.dataclass(frozen=True)
class Qwen3MoeConfig(llama.LlamaConfig):
    num_experts: int = 8
    num_experts_per_tok: int = 2
    moe_intermediate_size: int = 256
    mlp_only_layers: tuple = ()
    capacity_factor: float = 2.0
    ep_axis: Optional[str] = None  # expert parallelism: not ported, must stay None

    def __post_init__(self):
        super().__post_init__()
        if isinstance(self.mlp_only_layers, list):
            object.__setattr__(self, "mlp_only_layers", tuple(self.mlp_only_layers))
        refuse_expert_parallel(self)

    @classmethod
    def from_hf(cls, hf: dict) -> "Qwen3MoeConfig":
        base = llama.LlamaConfig.from_hf(hf)
        return cls(**dataclasses.asdict(base), num_experts=hf.get("num_experts", 8),
                   num_experts_per_tok=hf.get("num_experts_per_tok", 2),
                   moe_intermediate_size=hf.get("moe_intermediate_size", 256),
                   mlp_only_layers=tuple(hf.get("mlp_only_layers", ()) or ()))

    @classmethod
    def qwen3_30b_a3b(cls) -> "Qwen3MoeConfig":
        """Qwen/Qwen3-30B-A3B as published (from memory: no copy of its
        config.json is in this repo)."""
        return cls(vocab_size=151936, hidden_size=2048, intermediate_size=6144,
                   num_hidden_layers=48, num_attention_heads=32, num_key_value_heads=4,
                   head_dim=128, max_position_embeddings=40960, rms_norm_eps=1e-6,
                   rope_theta=1e6, num_experts=128, num_experts_per_tok=8,
                   moe_intermediate_size=768)

    @classmethod
    def tiny(cls, vocab_size: int = 256) -> "Qwen3MoeConfig":
        return cls(vocab_size=vocab_size, hidden_size=128, intermediate_size=256,
                   num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                   head_dim=32, max_position_embeddings=256, num_experts=4,
                   num_experts_per_tok=2, moe_intermediate_size=64)


def init_params(cfg: Qwen3MoeConfig, generator: Optional[torch.Generator] = None,
                dtype=torch.bfloat16, device="cuda") -> dict:
    """`llama.init_params` with Qwen3's q/k norms (ones) and, but in
    ``mlp_only_layers`` (a dense MLP of ``intermediate_size``), the router
    and stacked experts in place of the MLP."""
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    params = llama.init_params(dataclasses.replace(cfg, intermediate_size=8), generator, dtype,
                               device)
    d, f, e, hd = cfg.hidden_size, cfg.moe_intermediate_size, cfg.num_experts, cfg.head_dim_
    fd = cfg.intermediate_size

    def randn(*shape, fan_in):
        w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (w / math.sqrt(fan_in)).to(dtype)

    for i, layer in enumerate(params["layers"]):
        layer["self_attn"]["q_norm"] = torch.ones((hd,), dtype=dtype, device=device)
        layer["self_attn"]["k_norm"] = torch.ones((hd,), dtype=dtype, device=device)
        if i in cfg.mlp_only_layers:
            layer["mlp"] = {"gate_proj": Linear(randn(fd, d, fan_in=d)),
                            "up_proj": Linear(randn(fd, d, fan_in=d)),
                            "down_proj": Linear(randn(d, fd, fan_in=fd))}
            continue
        layer["mlp"] = {"gate": Linear(randn(e, d, fan_in=d)), "experts": {
            "gate_proj": GroupedLinear(randn(e, f, d, fan_in=d)),
            "up_proj": GroupedLinear(randn(e, f, d, fan_in=d)),
            "down_proj": GroupedLinear(randn(e, d, f, fan_in=f))}}
    return params


def _mlp(layer: dict, cfg: Qwen3MoeConfig, h: torch.Tensor) -> torch.Tensor:
    """The layer's MoE block, or its dense MLP (``mlp_only_layers``)."""
    if "experts" in layer["mlp"]:
        return swiglu_moe(layer["mlp"], _EXPERTS, h, cfg.num_experts_per_tok,
                          cfg.capacity_factor)
    return llama._mlp(layer["mlp"], h)


def forward(params: dict, cfg: Qwen3MoeConfig, tokens: torch.Tensor, cache=None, start_pos=0,
            page_indices: Optional[torch.Tensor] = None):
    """`llama.forward`'s contract with the MoE block as the MLP."""
    from ..ops.paged import PagedKVCache

    if isinstance(cache, PagedKVCache):
        if page_indices is None:
            raise ValueError("a PagedKVCache needs page_indices")
        return llama._forward_paged(
            params, cfg, tokens, cache, torch.as_tensor(start_pos, device=cache.k.device),
            page_indices, mlp_fn=lambda layer, h: _mlp(layer, cfg, h))
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
        x = x + _mlp(layer, cfg, h)
    return llama._logits(params, cfg, x), cache


def quantize_qwen3_moe(params: dict, attn_config: Optional[dict] = None,
                       expert_config: Optional[dict] = None,
                       compute_dtype=torch.bfloat16) -> dict:
    """Quantize the attention and the stacked experts in place; the router
    stays in full precision. As in `hqq_tpu`, the ignore pattern "mlp.gate"
    also leaves the dense layers' ``mlp.gate_proj`` unquantized."""
    from ..core.quantize import BaseQuantizeConfig
    from .base import quantize_model

    attn_config = attn_config or BaseQuantizeConfig(nbits=4, group_size=64)
    expert_config = expert_config or BaseQuantizeConfig(nbits=4, group_size=64)
    quantize_model(params, attn_config, compute_dtype, ignore=("lm_head", "mlp.gate"))
    for layer in params["layers"]:
        if "experts" in layer["mlp"]:
            quantize_experts(layer["mlp"]["experts"], _EXPERTS, expert_config, compute_dtype)
    return params


def params_from_hf_state_dict(state: Dict[str, torch.Tensor], cfg: Qwen3MoeConfig,
                              dtype=torch.bfloat16) -> dict:
    """An HF `Qwen3MoeForCausalLM` state dict as the tree (experts stacked
    along E; a layer without ``mlp.gate`` keeps its dense MLP)."""

    def arr(name):
        return state[name].to(dtype)

    def lin(prefix):
        bias = prefix + ".bias"
        return Linear(arr(prefix + ".weight"), arr(bias) if bias in state else None)

    layers = []
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}"
        sa = {f"{n}_proj": lin(f"{p}.self_attn.{n}_proj") for n in "qkvo"}
        sa["q_norm"] = arr(f"{p}.self_attn.q_norm.weight")
        sa["k_norm"] = arr(f"{p}.self_attn.k_norm.weight")
        if f"{p}.mlp.gate.weight" in state:
            mlp = {"gate": lin(f"{p}.mlp.gate"), "experts": {w: GroupedLinear(torch.stack([
                arr(f"{p}.mlp.experts.{e}.{w}.weight") for e in range(cfg.num_experts)]))
                for w in _EXPERTS}}
        else:  # a dense layer (mlp_only_layers)
            mlp = {n: lin(f"{p}.mlp.{n}") for n in _EXPERTS}
        layers.append({"self_attn": sa, "mlp": mlp,
                       "input_layernorm": arr(f"{p}.input_layernorm.weight"),
                       "post_attention_layernorm": arr(f"{p}.post_attention_layernorm.weight")})
    params = {"embed_tokens": arr("model.embed_tokens.weight"), "layers": layers,
              "norm": arr("model.norm.weight")}
    if "lm_head.weight" in state:
        params["lm_head"] = lin("lm_head")
    return params
