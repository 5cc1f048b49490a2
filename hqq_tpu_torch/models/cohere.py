# SPDX-License-Identifier: Apache-2.0
"""Cohere (Command-R) decoder: parallel residual from one norm,
interleaved RoPE, scaled logits.

Mirrors `hqq_tpu.models.cohere` (HF ``CohereForCausalLM``). Beside the
llama walk:

* one norm a block, whose output feeds attention and the MLP:
  ``x = x + attn(ln(x)) + mlp(ln(x))``;
* the norm is a LayerNorm with a weight and no bias (``CohereLayerNorm``),
  also applied per head to q and k before the heads move when
  ``use_qk_norm`` (weights [H, hd]): each one launch of the fixed-order
  LayerNorm kernel, the per-head weights read by row;
* interleaved RoPE: the pairs (x_2i, x_2i+1) rotate together;
* the head tied to the embedding, the logits scaled by ``logit_scale``.

A layer fused by `utils.patching.fuse_for_decode` (``qkv_proj``,
``gate_up_proj``) is read as it is. Attention is plain torch over the
dense cache's float pools, as `hqq_tpu` writes it; int8 pools are not
read (``reads_int8_kv``) and there is no paged branch.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Dict, Optional

import torch

from ..nn.linear import Linear
from ..ops.norm import apply_layer_norm
from . import llama
from .llama import KVCache, init_cache, refuse_int8_pools  # noqa: F401

__all__ = ["CohereConfig", "forward", "init_cache", "init_params", "params_from_hf_state_dict"]


@dataclasses.dataclass(frozen=True)
class CohereConfig(llama.LlamaConfig):
    logit_scale: float = 0.0625
    use_qk_norm: bool = False
    layer_norm_eps: float = 1e-5

    # the forward reads the dense cache's float pools only
    reads_int8_kv: ClassVar[bool] = False

    @classmethod
    def from_hf(cls, hf: dict) -> "CohereConfig":
        base = dataclasses.replace(llama.LlamaConfig.from_hf(hf),
                                   rms_norm_eps=hf.get("layer_norm_eps", 1e-5),
                                   tie_word_embeddings=hf.get("tie_word_embeddings", True))
        return cls(**dataclasses.asdict(base), logit_scale=hf.get("logit_scale", 0.0625),
                   use_qk_norm=hf.get("use_qk_norm", False),
                   layer_norm_eps=hf.get("layer_norm_eps", 1e-5))

    @classmethod
    def command_r_plus(cls) -> "CohereConfig":
        """CohereForAI/c4ai-command-r-plus's published config: hidden 12288,
        ffn 33792, 64 layers, 96/8 heads of 128, vocab 256000, use_qk_norm,
        logit_scale 0.8333, rope theta 75e6."""
        return cls(vocab_size=256000, hidden_size=12288, intermediate_size=33792,
                   num_hidden_layers=64, num_attention_heads=96, num_key_value_heads=8,
                   max_position_embeddings=8192, rope_theta=75000000.0,
                   tie_word_embeddings=True, logit_scale=0.8333333333333334, use_qk_norm=True)

    @classmethod
    def tiny(cls, vocab_size: int = 256) -> "CohereConfig":
        return cls(vocab_size=vocab_size, hidden_size=128, intermediate_size=256,
                   num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                   max_position_embeddings=256, tie_word_embeddings=True, use_qk_norm=True)


def _norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """CohereLayerNorm: mean-centred, weight only (`ops.norm.layer_norm`)."""
    return apply_layer_norm(x, w, None, eps)


def _rope_interleaved(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables [T, hd] with each frequency repeated for its pair."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                             device=positions.device) / head_dim))
    emb = (positions.to(torch.float32)[:, None] * inv_freq[None, :]).repeat_interleave(2, dim=-1)
    return emb.cos(), emb.sin()


def _apply_rope_interleaved(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x [B, H, T, hd] rotated with Cohere's ``rotate_half``, which pairs
    the even and odd dims."""
    rot = torch.stack([-x[..., 1::2], x[..., 0::2]], dim=-1).reshape(x.shape)
    return (x.to(torch.float32) * cos + rot.to(torch.float32) * sin).to(x.dtype)


def _attention(layer: dict, cfg: CohereConfig, x: torch.Tensor, cache, layer_idx: int,
               start_pos, mask: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    b, t, _ = x.shape
    nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_
    if "qkv_proj" in layer:  # fused by `fuse_for_decode`: one wide matmul
        q, k, v = torch.split(layer["qkv_proj"](x), [nh * hd, nkv * hd, nkv * hd], dim=-1)
    else:
        q, k, v = layer["q_proj"](x), layer["k_proj"](x), layer["v_proj"](x)
    q, k, v = q.reshape(b, t, nh, hd), k.reshape(b, t, nkv, hd), v.reshape(b, t, nkv, hd)
    if cfg.use_qk_norm and "q_norm" in layer:  # per head, [H, hd] weights
        q = _norm(q, layer["q_norm"], cfg.layer_norm_eps)
        k = _norm(k, layer["k_norm"], cfg.layer_norm_eps)
    q = _apply_rope_interleaved(q.transpose(1, 2), cos, sin)
    k = _apply_rope_interleaved(k.transpose(1, 2), cos, sin)
    return layer["o_proj"](llama.float_attention(q, k, v.transpose(1, 2), cache, layer_idx,
                                                 start_pos, mask))


def forward(params: dict, cfg: CohereConfig, tokens: torch.Tensor, cache=None, start_pos=0):
    """`llama.forward`'s contract over a dense `KVCache` (float pools) or
    ``cache=None``: (logits [B, T, V] fp32, cache)."""
    refuse_int8_pools(cache, "cohere")
    t = tokens.shape[1]
    x = params["embed_tokens"][tokens]
    _, pos_bt, mask = llama.causal_mask(t, start_pos, None if cache is None else cache.max_len,
                                        cfg.sliding_window, x.device)
    hd = cfg.head_dim_
    cos, sin = _rope_interleaved(pos_bt.reshape(-1), hd, cfg.rope_theta)
    cos = cos.reshape(*pos_bt.shape, hd)[:, None]
    sin = sin.reshape(*pos_bt.shape, hd)[:, None]

    for i, layer in enumerate(params["layers"]):
        h = _norm(x, layer["input_layernorm"], cfg.layer_norm_eps)
        x = (x + _attention(layer["self_attn"], cfg, h, cache, i, start_pos, mask, cos, sin)
             + llama._mlp(layer["mlp"], h))

    x = _norm(x, params["norm"], cfg.layer_norm_eps)
    logits = x.to(torch.float32) @ params["embed_tokens"].to(torch.float32).t()
    return logits * llama._scalar_in(cfg.logit_scale, torch.float32), cache


def init_params(cfg: CohereConfig, generator: Optional[torch.Generator] = None,
                dtype=torch.bfloat16, device="cuda") -> dict:
    """`llama.init_params` without the head and the post-attention norm,
    plus the per-head q/k norm weights (ones) where ``use_qk_norm``."""
    params = llama.init_params(cfg, generator, dtype, device)
    params.pop("lm_head", None)
    nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_
    for layer in params["layers"]:
        layer.pop("post_attention_layernorm", None)
        if cfg.use_qk_norm:
            layer["self_attn"]["q_norm"] = torch.ones((nh, hd), dtype=dtype, device=device)
            layer["self_attn"]["k_norm"] = torch.ones((nkv, hd), dtype=dtype, device=device)
    return params


def params_from_hf_state_dict(state: Dict[str, torch.Tensor], cfg: CohereConfig,
                              dtype=torch.bfloat16) -> dict:
    """An HF `CohereForCausalLM` state dict as the tree."""

    def arr(name):
        return state[name].to(dtype)

    def lin(prefix):
        bias = prefix + ".bias"
        return Linear(arr(prefix + ".weight"), arr(bias) if bias in state else None)

    layers = []
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}"
        sa = {f"{n}_proj": lin(f"{p}.self_attn.{n}_proj") for n in "qkvo"}
        if cfg.use_qk_norm:
            sa["q_norm"] = arr(f"{p}.self_attn.q_norm.weight")
            sa["k_norm"] = arr(f"{p}.self_attn.k_norm.weight")
        layers.append({
            "self_attn": sa,
            "mlp": {f"{n}_proj": lin(f"{p}.mlp.{n}_proj") for n in ("gate", "up", "down")},
            "input_layernorm": arr(f"{p}.input_layernorm.weight"),
        })
    return {"embed_tokens": arr("model.embed_tokens.weight"), "layers": layers,
            "norm": arr("model.norm.weight")}
