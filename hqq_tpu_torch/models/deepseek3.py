# SPDX-License-Identifier: Apache-2.0
"""DeepSeek-V3: Multi-head Latent Attention (MLA) and a fine-grained MoE
with shared experts and group-limited sigmoid routing.

Mirrors `hqq_tpu.models.deepseek3` (HF `DeepseekV3ForCausalLM`):

* MLA: the query from ``q_proj``, or low-rank (``q_a_proj``, RMSNorm,
  ``q_b_proj``); K and V decompressed from a ``kv_lora_rank`` latent
  (``kv_a_proj_with_mqa``, RMSNorm of the latent, ``kv_b_proj``). RoPE
  turns only the ``qk_rope_head_dim`` part, and the rope part of K is one
  head shared by every head; with ``rope_interleave`` the rope dims are
  de-interleaved first. Scores scale by qk_head_dim**-0.5, times
  DeepSeek-YaRN's mscale² (``attn_scale_``). K rows are nope + rope wide
  and V rows ``v_head_dim`` wide, so the family keeps its own dense cache
  (`init_cache`), which the dense engine and `Generator` build through
  `llama.cache_for`. There is no paged branch, as in `hqq_tpu`.
* MoE (layers from ``first_k_dense_replace`` on): the router in fp32
  (sigmoid of the logits plus a correction bias; the top-2 sum of each
  group, the ``topk_group`` best groups, the top-k experts in them), the
  weights the chosen experts' sigmoid scores, normalized, times
  ``routed_scaling_factor``; always-on shared experts. Every routed expert
  runs on every token (`hqq_tpu`'s dense compute, which drops nothing):
  the stacks (`nn.moe.GroupedQuantLinear`) take x broadcast to [E, T, D],
  so at decode the grouped kernel runs at T rows an expert, then each
  token sums its own top-k rows in its router's k order.

The dense layers' MLP reads ``gate_up_proj`` where `fuse_for_decode` made
one: `hqq_tpu`'s forward raises there (KeyError 'gate_proj'), so
`hqq_tpu.serve` cannot serve this family with its defaults. The forward
reads float pools only (``reads_int8_kv``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, ClassVar, Dict, Optional

import torch
import torch.nn.functional as F

from ..nn.linear import Linear
from ..nn.moe import GroupedLinear, stable_topk, weighted_rows_sum
from . import llama
from .llama import KVCache, refuse_int8_pools, rms_norm

__all__ = ["DeepseekV3Config", "init_params", "init_layer", "forward", "init_cache",
           "params_from_hf_state_dict"]


@dataclass(frozen=True)
class DeepseekV3Config:
    vocab_size: int = 129280
    hidden_size: int = 7168
    intermediate_size: int = 18432
    moe_intermediate_size: int = 2048
    num_hidden_layers: int = 61
    num_attention_heads: int = 128
    n_routed_experts: int = 256
    n_shared_experts: int = 1
    num_experts_per_tok: int = 8
    n_group: int = 8
    topk_group: int = 4
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 2.5
    first_k_dense_replace: int = 3
    q_lora_rank: Optional[int] = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    # RoPE scaling as llama's canonical tuple; DeepSeek-YaRN's
    # mscale_all_dim also scales the softmax (`attn_scale_`)
    rope_scaling: Optional[tuple] = None
    # checkpoints store the rope dims interleaved (even/odd pairs)
    rope_interleave: bool = True
    max_position_embeddings: int = 4096
    tie_word_embeddings: bool = False
    # read by the shared helpers
    sliding_window: Optional[int] = None

    # the forward reads the dense cache's float pools only
    reads_int8_kv: ClassVar[bool] = False

    def __post_init__(self):
        if isinstance(self.rope_scaling, dict):
            object.__setattr__(self, "rope_scaling", tuple(sorted(self.rope_scaling.items())))
        elif isinstance(self.rope_scaling, list):
            object.__setattr__(self, "rope_scaling", tuple((k, v) for k, v in self.rope_scaling))

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def attn_scale_(self) -> float:
        """qk_head_dim**-0.5, times mscale² where rope_scaling sets
        ``mscale_all_dim`` (mscale = 0.1 * mscale_all_dim * ln(factor) + 1)."""
        base = self.qk_head_dim**-0.5
        if self.rope_scaling is None:
            return base
        rs = dict(self.rope_scaling)
        mscale_all = rs.get("mscale_all_dim") or 0
        if mscale_all:
            factor = float(rs.get("factor", 1.0))
            m = 1.0 if factor <= 1 else 0.1 * mscale_all * math.log(factor) + 1.0
            base = base * m * m
        return base

    @property
    def head_dim_(self) -> int:
        """The rotary tables' width (`llama.positions_and_masks`): the rope dims."""
        return self.qk_rope_head_dim

    @classmethod
    def from_hf(cls, hf: dict) -> "DeepseekV3Config":
        return cls(
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"],
            moe_intermediate_size=hf.get("moe_intermediate_size", 2048),
            num_hidden_layers=hf["num_hidden_layers"],
            num_attention_heads=hf["num_attention_heads"],
            n_routed_experts=hf.get("n_routed_experts", 256),
            n_shared_experts=hf.get("n_shared_experts", 1),
            num_experts_per_tok=hf.get("num_experts_per_tok", 8),
            n_group=hf.get("n_group", 8),
            topk_group=hf.get("topk_group", 4),
            norm_topk_prob=hf.get("norm_topk_prob", True),
            routed_scaling_factor=hf.get("routed_scaling_factor", 2.5),
            first_k_dense_replace=hf.get("first_k_dense_replace", 3),
            q_lora_rank=hf.get("q_lora_rank"),
            kv_lora_rank=hf.get("kv_lora_rank", 512),
            qk_nope_head_dim=hf.get("qk_nope_head_dim", 128),
            qk_rope_head_dim=hf.get("qk_rope_head_dim", 64),
            v_head_dim=hf.get("v_head_dim", 128),
            rms_norm_eps=hf.get("rms_norm_eps", 1e-6),
            rope_theta=hf.get("rope_theta", 10000.0),
            rope_scaling=llama.LlamaConfig._canon_rope_scaling(hf.get("rope_scaling")),
            rope_interleave=hf.get("rope_interleave", True),
            max_position_embeddings=hf.get("max_position_embeddings", 4096),
        )

    @classmethod
    def tiny(cls, vocab_size: int = 256) -> "DeepseekV3Config":
        return cls(vocab_size=vocab_size, hidden_size=128, intermediate_size=256,
                   moe_intermediate_size=64, num_hidden_layers=3, num_attention_heads=4,
                   n_routed_experts=8, n_shared_experts=1, num_experts_per_tok=2, n_group=4,
                   topk_group=2, first_k_dense_replace=1, q_lora_rank=64, kv_lora_rank=32,
                   qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
                   max_position_embeddings=128)


def init_layer(cfg: DeepseekV3Config, layer_idx: int, generator: torch.Generator,
               dtype=torch.bfloat16, device="cuda",
               experts: Optional[Callable[[int, int], object]] = None) -> dict:
    """One decoder layer in HF naming, weights N(0, 1/in) drawn in fp32 from
    ``generator`` and cast to ``dtype`` (the router N(0, 0.02^2) in fp32,
    its correction bias 0, norm weights 1): a dense MLP below
    ``first_k_dense_replace``, the MoE block from there. ``experts(out,
    in)`` builds each routed stack (w1, w2, w3 in that order); by default a
    dense `GroupedLinear` drawn from ``generator``."""
    d, nh = cfg.hidden_size, cfg.num_attention_heads

    def randn(*shape):
        return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)

    def lin(o, i):
        return Linear((randn(o, i) / math.sqrt(i)).to(dtype))

    def ones(n):
        return torch.ones((n,), dtype=dtype, device=device)

    def dense_mlp(f):
        return {"gate_proj": lin(f, d), "up_proj": lin(f, d), "down_proj": lin(d, f)}

    sa = {
        "kv_a_proj_with_mqa": lin(cfg.kv_lora_rank + cfg.qk_rope_head_dim, d),
        "kv_a_layernorm": ones(cfg.kv_lora_rank),
        "kv_b_proj": lin(nh * (cfg.qk_nope_head_dim + cfg.v_head_dim), cfg.kv_lora_rank),
        "o_proj": lin(d, nh * cfg.v_head_dim),
    }
    if cfg.q_lora_rank is None:
        sa["q_proj"] = lin(nh * cfg.qk_head_dim, d)
    else:
        sa["q_a_proj"] = lin(cfg.q_lora_rank, d)
        sa["q_a_layernorm"] = ones(cfg.q_lora_rank)
        sa["q_b_proj"] = lin(nh * cfg.qk_head_dim, cfg.q_lora_rank)
    if layer_idx < cfg.first_k_dense_replace:
        mlp = dense_mlp(cfg.intermediate_size)
    else:
        e, f = cfg.n_routed_experts, cfg.moe_intermediate_size
        if experts is None:
            def experts(o, i):
                return GroupedLinear((randn(e, o, i) / math.sqrt(i)).to(dtype))
        mlp = {
            "gate_weight": randn(e, d) * 0.02,
            "e_score_correction_bias": torch.zeros((e,), dtype=torch.float32, device=device),
            "experts": {"w1": experts(f, d), "w2": experts(d, f), "w3": experts(f, d)},
            "shared_experts": dense_mlp(f * cfg.n_shared_experts),
        }
    return {"self_attn": sa, "mlp": mlp, "input_layernorm": ones(d),
            "post_attention_layernorm": ones(d)}


def init_params(cfg: DeepseekV3Config, generator: Optional[torch.Generator] = None,
                dtype=torch.bfloat16, device="cuda") -> dict:
    """Random parameter tree in HF naming (`init_layer` for every layer; the
    embedding N(0, 0.02^2)); seed 0 on ``device`` when ``generator`` is
    None."""
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    d = cfg.hidden_size
    layers = [init_layer(cfg, i, generator, dtype, device) for i in range(cfg.num_hidden_layers)]
    embed = torch.randn((cfg.vocab_size, d), generator=generator, device=device,
                        dtype=torch.float32) * 0.02
    head = torch.randn((cfg.vocab_size, d), generator=generator, device=device,
                       dtype=torch.float32) / math.sqrt(d)
    return {"embed_tokens": embed.to(dtype), "layers": layers,
            "norm": torch.ones((d,), dtype=dtype, device=device), "lm_head": Linear(head.to(dtype))}


def init_cache(cfg: DeepseekV3Config, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cuda", quantize_kv: bool = False) -> KVCache:
    """The MLA cache: K [L, B, H, S, nope + rope], V [L, B, H, S, v], zeroed.
    int8 pools are refused (``reads_int8_kv``)."""
    if quantize_kv:
        raise ValueError("deepseek3: this family's attention reads the dense cache's float "
                         "pools only; int8 KV pools (quantize_kv) are not served for it")
    base = (cfg.num_hidden_layers, batch, cfg.num_attention_heads, max_len)
    return KVCache(k=torch.zeros(base + (cfg.qk_head_dim,), dtype=dtype, device=device),
                   v=torch.zeros(base + (cfg.v_head_dim,), dtype=dtype, device=device))


def _deinterleave(x: torch.Tensor) -> torch.Tensor:
    """(even dims | odd dims): the rotate-half rotation then pairs the
    stored dims (2i, 2i + 1); q and K permute alike, so scores are as HF's."""
    return torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1)


def _mla_attention(layer: dict, cfg: DeepseekV3Config, x: torch.Tensor, cache,
                   layer_idx: int, start_pos, mask: torch.Tensor, cos: torch.Tensor,
                   sin: torch.Tensor) -> torch.Tensor:
    """MLA over x [B, T, D]: the new K/V rows written into the dense cache
    in place (``cache=None``: the sequence's own keys), then
    `llama.float_attention` at ``attn_scale_``."""
    b, t, _ = x.shape
    nh = cfg.num_attention_heads
    nd, rd, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    if "q_proj" in layer:
        q = layer["q_proj"](x)
    else:
        q = layer["q_b_proj"](rms_norm(layer["q_a_proj"](x), layer["q_a_layernorm"],
                                       cfg.rms_norm_eps))
    q = q.reshape(b, t, nh, nd + rd).transpose(1, 2)
    q_pass, q_rot = q[..., :nd], q[..., nd:]

    ckv = layer["kv_a_proj_with_mqa"](x)  # [B, T, kv_lora + rope]
    # the latent is a strided slice of the row: the norm's wrapper copies it
    latent = rms_norm(ckv[..., :cfg.kv_lora_rank], layer["kv_a_layernorm"], cfg.rms_norm_eps)
    kv = layer["kv_b_proj"](latent).reshape(b, t, nh, nd + vd).transpose(1, 2)
    k_pass, v = kv[..., :nd], kv[..., nd:]
    k_rot = ckv[..., cfg.kv_lora_rank:].reshape(b, 1, t, rd)
    if cfg.rope_interleave:
        q_rot, k_rot = _deinterleave(q_rot), _deinterleave(k_rot)
    q_rot = llama._apply_rope(q_rot, cos, sin)
    k_rot = llama._apply_rope(k_rot, cos, sin).expand(b, nh, t, rd)
    q = torch.cat([q_pass, q_rot], dim=-1)
    k = torch.cat([k_pass, k_rot], dim=-1)
    out = llama.float_attention(q, k, v, cache, layer_idx, start_pos, mask,
                                scale=cfg.attn_scale_)
    return layer["o_proj"](out)


def _router(mlp: dict, cfg: DeepseekV3Config, x2: torch.Tensor):
    """Group-limited sigmoid routing in fp32 for tokens x2 [T, D]: returns
    (experts [T, K], weights [T, K]). Experts outside the chosen groups
    score 0.0 (not -inf), as in `hqq_tpu` and HF; every top-k takes equal
    values lower index first (`nn.moe.stable_topk`)."""
    logits = x2.to(torch.float32) @ mlp["gate_weight"].to(torch.float32).t()
    scores = torch.sigmoid(logits)  # [T, E]
    choice = scores + mlp["e_score_correction_bias"].to(torch.float32)[None, :]
    ng = cfg.n_group
    per_group = cfg.n_routed_experts // ng
    group_scores = stable_topk(choice.reshape(-1, ng, per_group), 2)[0].sum(-1)  # [T, G]
    gidx = stable_topk(group_scores, cfg.topk_group)[1]
    gmask = torch.zeros_like(group_scores).scatter_(1, gidx, 1.0)
    smask = gmask.repeat_interleave(per_group, dim=-1)  # [T, E]
    masked = torch.where(smask > 0, choice, 0.0)
    idx = stable_topk(masked, cfg.num_experts_per_tok)[1]
    w = torch.gather(scores, 1, idx)
    if cfg.norm_topk_prob:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return idx, w * cfg.routed_scaling_factor


def _moe_block(mlp: dict, cfg: DeepseekV3Config, x: torch.Tensor) -> torch.Tensor:
    """Dense compute, as `hqq_tpu`: every routed expert on every token
    (x broadcast to [E, T, D], made contiguous once for the two stacks
    that read it), each token's top-k rows summed in fp32 with its
    weights, then the shared experts added."""
    b, t, d = x.shape
    x2 = x.reshape(b * t, d)
    idx, w = _router(mlp, cfg, x2)
    e, n = cfg.n_routed_experts, b * t
    xin = x2.expand(e, n, d).contiguous()
    ex = mlp["experts"]
    eout = ex["w2"](F.silu(ex["w1"](xin)) * ex["w3"](xin))  # [E, T, D]
    rows = idx * n + torch.arange(n, device=x.device)[:, None]  # expert e, token i: row e*n+i
    routed = weighted_rows_sum(eout.reshape(e * n, d), rows, w)
    return (routed.to(x.dtype) + llama._mlp(mlp["shared_experts"], x2)).reshape(b, t, d)


def forward(params: dict, cfg: DeepseekV3Config, tokens: torch.Tensor, cache=None,
            start_pos=0, kv_valid: Optional[torch.Tensor] = None):
    """Run the model over ``tokens`` [B, T] from ``start_pos`` (an int, a
    0-d tensor or a [B] tensor of per-slot offsets) over the family's
    dense cache, updated in place, or with ``cache=None`` over the
    sequence alone; ``kv_valid`` [B, S_max] masks cache slots. Returns
    (logits [B, T, V] fp32, cache)."""
    refuse_int8_pools(cache, "deepseek3")
    x = params["embed_tokens"][tokens]
    _, cos, sin, mask = llama.positions_and_masks(
        cfg, tokens.shape[1], start_pos, None if cache is None else cache.max_len, x.device,
        kv_valid)
    for i, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["input_layernorm"], cfg.rms_norm_eps)
        x = x + _mla_attention(layer["self_attn"], cfg, h, cache, i, start_pos, mask, cos, sin)
        h = rms_norm(x, layer["post_attention_layernorm"], cfg.rms_norm_eps)
        mlp = layer["mlp"]
        x = x + (_moe_block(mlp, cfg, h) if "experts" in mlp else llama._mlp(mlp, h))
    return llama._logits(params, cfg, x), cache


def params_from_hf_state_dict(state: Dict[str, torch.Tensor], cfg: DeepseekV3Config,
                              dtype=torch.bfloat16) -> dict:
    """An HF `DeepseekV3ForCausalLM` state dict as the tree: each MoE
    layer's routed experts ``mlp.experts.{e}.{gate,up,down}_proj`` stacked
    along E into w1, w3 and w2 (`GroupedLinear` [E, out, in]), the router
    ``mlp.gate`` (weight and correction bias) in fp32."""

    def arr(name, dt=dtype):
        return state[name].to(dt)

    def lin(prefix):
        bias = prefix + ".bias"
        return Linear(arr(prefix + ".weight"), arr(bias) if bias in state else None)

    def dense_mlp(p):
        return {n: lin(f"{p}.{n}") for n in ("gate_proj", "up_proj", "down_proj")}

    layers = []
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}"
        sa = {n: lin(f"{p}.self_attn.{n}") for n in ("kv_a_proj_with_mqa", "kv_b_proj", "o_proj")}
        sa["kv_a_layernorm"] = arr(f"{p}.self_attn.kv_a_layernorm.weight")
        if f"{p}.self_attn.q_proj.weight" in state:
            sa["q_proj"] = lin(f"{p}.self_attn.q_proj")
        else:
            sa["q_a_proj"] = lin(f"{p}.self_attn.q_a_proj")
            sa["q_a_layernorm"] = arr(f"{p}.self_attn.q_a_layernorm.weight")
            sa["q_b_proj"] = lin(f"{p}.self_attn.q_b_proj")
        if i < cfg.first_k_dense_replace:
            mlp = dense_mlp(f"{p}.mlp")
        else:
            def stack(proj):
                return GroupedLinear(torch.stack([
                    arr(f"{p}.mlp.experts.{e}.{proj}.weight")
                    for e in range(cfg.n_routed_experts)]))

            mlp = {
                "gate_weight": arr(f"{p}.mlp.gate.weight", torch.float32),
                "e_score_correction_bias": arr(f"{p}.mlp.gate.e_score_correction_bias",
                                               torch.float32),
                "experts": {"w1": stack("gate_proj"), "w2": stack("down_proj"),
                            "w3": stack("up_proj")},
                "shared_experts": dense_mlp(f"{p}.mlp.shared_experts"),
            }
        layers.append({
            "self_attn": sa,
            "mlp": mlp,
            "input_layernorm": arr(f"{p}.input_layernorm.weight"),
            "post_attention_layernorm": arr(f"{p}.post_attention_layernorm.weight"),
        })
    return {"embed_tokens": arr("model.embed_tokens.weight"), "layers": layers,
            "norm": arr("model.norm.weight"), "lm_head": lin("lm_head")}
