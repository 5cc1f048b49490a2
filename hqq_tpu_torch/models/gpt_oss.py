# SPDX-License-Identifier: Apache-2.0
"""gpt-oss (openai/gpt-oss-20b and -120b): attention sinks, alternating
sliding and full layers, YaRN rope, biased attention projections and a
clamped-SwiGLU MoE with expert biases.

Mirrors `hqq_tpu.models.gpt_oss` (HF `GptOssForCausalLM`):

  * a learned sink logit per head joins each softmax and its share of the
    mass is dropped (`_sink_softmax`);
  * ``layer_types`` alternate sliding_attention (``sliding_window``) and
    full_attention (even layers sliding where it is not given);
  * the experts' ``gate_up_proj`` [E, 2F, D] holds gate and up INTERLEAVED
    (columns 0::2 gate, 1::2 up), with fp32 biases; the activation is
    (up + 1) * gate * sigmoid(alpha * gate) with gate clamped above at
    ``swiglu_limit`` and up clamped on both sides; the router biases its
    logits, and the renormalized top-k of the softmax equals gpt-oss's
    softmax over the top-k logits.

The dense cache is read through float pools only (``reads_int8_kv``); the
paged step sends every layer to the gather route of `ops.paged.paged_attn`
with its sinks, as `hqq_tpu` does (the paged kernel takes no sinks).
Expert parallelism (``ep_axis``) is not ported: a config that sets it raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import ClassVar, Dict, Optional

import torch

from ..nn.linear import Linear
from ..nn.moe import (GroupedLinear, combine_experts, quantize_experts, refuse_expert_parallel,
                      route_tokens)
from . import llama
from .llama import KVCache, init_cache, rms_norm  # noqa: F401

__all__ = ["GptOssConfig", "init_params", "forward", "init_cache", "quantize_gpt_oss",
           "params_from_hf_state_dict"]


@dataclasses.dataclass(frozen=True)
class GptOssConfig(llama.LlamaConfig):
    num_local_experts: int = 4
    num_experts_per_tok: int = 2
    layer_types: Optional[tuple] = None  # None: even layers sliding
    swiglu_alpha: float = 1.702
    swiglu_limit: float = 7.0
    capacity_factor: float = 2.0
    ep_axis: Optional[str] = None  # expert parallelism: not ported, must stay None
    reads_int8_kv: ClassVar[bool] = False

    def __post_init__(self):
        super().__post_init__()
        if isinstance(self.layer_types, list):
            object.__setattr__(self, "layer_types", tuple(self.layer_types))
        refuse_expert_parallel(self)

    def layer_is_sliding(self, i: int) -> bool:
        if self.layer_types is not None:
            return self.layer_types[i] == "sliding_attention"
        return i % 2 == 0

    @classmethod
    def from_hf(cls, hf: dict) -> "GptOssConfig":
        base = llama.LlamaConfig.from_hf(hf)
        base = dataclasses.replace(base, attention_bias=hf.get("attention_bias", True))
        return cls(**dataclasses.asdict(base),
                   num_local_experts=hf.get("num_local_experts", 4),
                   num_experts_per_tok=hf.get("num_experts_per_tok", 2),
                   layer_types=tuple(hf.get("layer_types") or ()) or None,
                   swiglu_limit=hf.get("swiglu_limit", 7.0))

    @classmethod
    def gpt_oss_20b(cls, num_hidden_layers: int = 24) -> "GptOssConfig":
        """openai/gpt-oss-20b as published (from memory: no copy of its
        config.json is in this repo), alternating sliding and full layers."""
        return cls(vocab_size=201088, hidden_size=2880, intermediate_size=2880,
                   num_hidden_layers=num_hidden_layers, num_attention_heads=64,
                   num_key_value_heads=8, head_dim=64, max_position_embeddings=131072,
                   rms_norm_eps=1e-5, rope_theta=150000.0, sliding_window=128,
                   attention_bias=True, num_local_experts=32, num_experts_per_tok=4,
                   layer_types=tuple("sliding_attention" if i % 2 == 0 else "full_attention"
                                     for i in range(num_hidden_layers)),
                   rope_scaling={"rope_type": "yarn", "factor": 32.0, "beta_fast": 32.0,
                                 "beta_slow": 1.0, "truncate": False,
                                 "original_max_position_embeddings": 4096})

    @classmethod
    def tiny(cls, vocab_size: int = 256) -> "GptOssConfig":
        return cls(vocab_size=vocab_size, hidden_size=128, intermediate_size=64,
                   num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                   head_dim=32, max_position_embeddings=256, sliding_window=16,
                   num_local_experts=4, num_experts_per_tok=2,
                   layer_types=("sliding_attention", "full_attention"), attention_bias=True)


def init_params(cfg: GptOssConfig, generator: Optional[torch.Generator] = None,
                dtype=torch.bfloat16, device="cuda") -> dict:
    """Random parameters in `hqq_tpu`'s layout (weights N(0, 1/in) drawn in
    fp32 from ``generator``, seed 0 on ``device`` when None; biases and
    sinks 0, norms 1, the embedding N(0, 0.02^2))."""
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    d, f, e = cfg.hidden_size, cfg.intermediate_size, cfg.num_local_experts
    nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_

    def randn(*shape, fan_in):
        w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (w / math.sqrt(fan_in)).to(dtype)

    def lin(out_f, in_f, bias=True):
        b = torch.zeros((out_f,), dtype=dtype, device=device) if bias else None
        return Linear(randn(out_f, in_f, fan_in=in_f), b)

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    layers = []
    for _ in range(cfg.num_hidden_layers):
        layers.append({
            "self_attn": {"q_proj": lin(nh * hd, d), "k_proj": lin(nkv * hd, d),
                          "v_proj": lin(nkv * hd, d), "o_proj": lin(d, nh * hd),
                          "sinks": zeros(nh)},
            "mlp": {"router": lin(e, d),
                    "experts": {"gate_up_proj": GroupedLinear(randn(e, 2 * f, d, fan_in=d)),
                                "down_proj": GroupedLinear(randn(e, d, f, fan_in=f))},
                    "gate_up_bias": zeros(e, 2 * f, dt=torch.float32),
                    "down_bias": zeros(e, d, dt=torch.float32)},
            "input_layernorm": torch.ones((d,), dtype=dtype, device=device),
            "post_attention_layernorm": torch.ones((d,), dtype=dtype, device=device),
        })
    embed = (torch.randn((cfg.vocab_size, d), generator=generator, device=device,
                         dtype=torch.float32) * 0.02).to(dtype)
    params = {"embed_tokens": embed, "layers": layers,
              "norm": torch.ones((d,), dtype=dtype, device=device)}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = lin(cfg.vocab_size, d, bias=False)
    return params


def _sink_softmax(scores: torch.Tensor, sinks: torch.Tensor) -> torch.Tensor:
    """softmax over [scores, the head's sink logit], the sink column dropped.
    scores [B, nh, T, S] (mask added), sinks [nh]."""
    sink = sinks.reshape(1, -1, 1, 1).to(torch.float32)
    m = torch.maximum(scores.amax(dim=-1, keepdim=True), sink)
    num = torch.exp(scores - m)
    return num / (num.sum(dim=-1, keepdim=True) + torch.exp(sink - m))


def _attention(layer: dict, cfg: GptOssConfig, x: torch.Tensor, cache, layer_idx: int,
               start_pos, mask: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Attention with sinks over the dense cache's float pools (written in
    place first), or with ``cache=None`` over the sequence's own keys: the
    scores in fp32, the probabilities rounded to q's type before the
    product, as `hqq_tpu`'s."""
    b, t, _ = x.shape
    nh, hd = cfg.num_attention_heads, cfg.head_dim_
    q, k, v = llama._qkv_rope(layer, cfg, x, cos, sin)
    if cache is None:
        keys, vals = k, v
    else:
        llama.refuse_int8_pools(cache, "gpt_oss")
        llama._update_stacked_cache(cache.k, cache.v, layer_idx, k, v, start_pos)
        keys, vals = cache.k[layer_idx], cache.v[layer_idx]
    rep = nh // keys.shape[1]
    if rep > 1:
        keys, vals = llama._repeat_heads(keys, rep), llama._repeat_heads(vals, rep)
    scores = llama._scores(q, keys, hd, None, None)
    probs = _sink_softmax(scores + mask, layer["sinks"]).to(q.dtype)
    out = (probs @ vals).transpose(1, 2).reshape(b, t, nh * hd)
    return layer["o_proj"](out)


def _moe_block(block: dict, cfg: GptOssConfig, x: torch.Tensor) -> torch.Tensor:
    """The clamped-SwiGLU MoE with interleaved gate/up and expert biases."""
    b, t, d = x.shape
    xf = x.reshape(b * t, d)
    combine, expert_in = route_tokens(block["router"], xf, cfg.num_experts_per_tok,
                                      cfg.capacity_factor)
    gu = block["experts"]["gate_up_proj"](expert_in).to(torch.float32)
    gu = gu + block["gate_up_bias"][:, None, :]
    gate, up = gu[..., 0::2], gu[..., 1::2]  # interleaved columns
    limit = cfg.swiglu_limit
    gate = gate.clamp(max=limit)
    up = up.clamp(min=-limit, max=limit)
    glu = gate * torch.sigmoid(gate * cfg.swiglu_alpha)
    h = ((up + 1.0) * glu).to(xf.dtype)
    out_e = block["experts"]["down_proj"](h).to(torch.float32) + block["down_bias"][:, None, :]
    return combine_experts(combine, out_e, cfg.num_experts_per_tok).reshape(b, t, d).to(x.dtype)


def _forward_paged(params: dict, cfg: GptOssConfig, tokens: torch.Tensor, cache,
                   lengths: torch.Tensor, page_indices: torch.Tensor):
    """One paged step: every layer through the gather route with its sinks,
    the sliding layers with their window."""
    toks = tokens if tokens.ndim == 2 else tokens[:, None]
    x = params["embed_tokens"][toks]
    lengths, page_indices = lengths.to(x.device), page_indices.to(x.device)
    _, cos, sin, _ = llama.positions_and_masks(cfg, toks.shape[1], lengths, None, x.device)
    for i, layer in enumerate(params["layers"]):
        sa = layer["self_attn"]
        window = cfg.sliding_window if cfg.layer_is_sliding(i) else None
        h = rms_norm(x, layer["input_layernorm"], cfg.rms_norm_eps)
        x = x + llama._attention_paged(sa, cfg, h, cache, i, lengths, page_indices, cos, sin,
                                       window=window, sinks=sa["sinks"])
        h = rms_norm(x, layer["post_attention_layernorm"], cfg.rms_norm_eps)
        x = x + _moe_block(layer["mlp"], cfg, h)
    return llama._logits(params, cfg, x), cache


def forward(params: dict, cfg: GptOssConfig, tokens: torch.Tensor, cache=None, start_pos=0,
            page_indices: Optional[torch.Tensor] = None):
    """`llama.forward`'s contract: a dense `KVCache` (float pools), a
    `PagedKVCache` with ``page_indices``, or ``cache=None``; each layer's
    mask is its own (sliding or full)."""
    from ..ops.paged import PagedKVCache

    if isinstance(cache, PagedKVCache):
        if page_indices is None:
            raise ValueError("a PagedKVCache needs page_indices")
        return _forward_paged(params, cfg, tokens, cache,
                              torch.as_tensor(start_pos, device=cache.k.device), page_indices)
    t = tokens.shape[1]
    x = params["embed_tokens"][tokens]
    cache_len = None if cache is None else cache.max_len
    cfg_full = dataclasses.replace(cfg, sliding_window=None)
    _, cos, sin, mask_full = llama.positions_and_masks(cfg_full, t, start_pos, cache_len, x.device)
    _, _, _, mask_sliding = llama.positions_and_masks(cfg, t, start_pos, cache_len, x.device)
    for i, layer in enumerate(params["layers"]):
        mask = mask_sliding if cfg.layer_is_sliding(i) else mask_full
        h = rms_norm(x, layer["input_layernorm"], cfg.rms_norm_eps)
        x = x + _attention(layer["self_attn"], cfg, h, cache, i, start_pos, mask, cos, sin)
        h = rms_norm(x, layer["post_attention_layernorm"], cfg.rms_norm_eps)
        x = x + _moe_block(layer["mlp"], cfg, h)
    return llama._logits(params, cfg, x), cache


def quantize_gpt_oss(params: dict, attn_config: Optional[dict] = None,
                     expert_config: Optional[dict] = None, compute_dtype=torch.bfloat16) -> dict:
    """Quantize the attention and the stacked experts in place; the router,
    the sinks, the expert biases and lm_head stay in full precision."""
    from ..core.quantize import BaseQuantizeConfig
    from .base import quantize_model

    attn_config = attn_config or BaseQuantizeConfig(nbits=4, group_size=64)
    expert_config = expert_config or BaseQuantizeConfig(nbits=4, group_size=64)
    quantize_model(params, attn_config, compute_dtype, ignore=("lm_head", "mlp.router"))
    for layer in params["layers"]:
        quantize_experts(layer["mlp"]["experts"], ("gate_up_proj", "down_proj"), expert_config,
                         compute_dtype)
    return params


def params_from_hf_state_dict(state: Dict[str, torch.Tensor], cfg: GptOssConfig,
                              dtype=torch.bfloat16) -> dict:
    """An HF `GptOssForCausalLM` state dict as the tree: the experts, stored
    input-major ([E, D, 2F] and [E, F, D]), turned to [E, out, in]; the
    interleaved gate/up kept; the expert biases in fp32."""

    def arr(name, dt=dtype):
        return state[name].to(dt)

    def lin(prefix):
        bias = prefix + ".bias"
        return Linear(arr(prefix + ".weight"), arr(bias) if bias in state else None)

    layers = []
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}"
        sa = {f"{n}_proj": lin(f"{p}.self_attn.{n}_proj") for n in "qkvo"}
        sa["sinks"] = arr(f"{p}.self_attn.sinks")
        mlp = {
            "router": Linear(arr(f"{p}.mlp.router.weight"), arr(f"{p}.mlp.router.bias")),
            "experts": {
                "gate_up_proj": GroupedLinear(
                    arr(f"{p}.mlp.experts.gate_up_proj").transpose(1, 2).contiguous()),
                "down_proj": GroupedLinear(
                    arr(f"{p}.mlp.experts.down_proj").transpose(1, 2).contiguous()),
            },
            "gate_up_bias": arr(f"{p}.mlp.experts.gate_up_proj_bias", torch.float32),
            "down_bias": arr(f"{p}.mlp.experts.down_proj_bias", torch.float32),
        }
        layers.append({"self_attn": sa, "mlp": mlp,
                       "input_layernorm": arr(f"{p}.input_layernorm.weight"),
                       "post_attention_layernorm": arr(f"{p}.post_attention_layernorm.weight")})
    params = {"embed_tokens": arr("model.embed_tokens.weight"), "layers": layers,
              "norm": arr("model.norm.weight")}
    if "lm_head.weight" in state:
        params["lm_head"] = lin("lm_head")
    return params
