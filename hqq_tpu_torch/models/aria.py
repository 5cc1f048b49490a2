# SPDX-License-Identifier: Apache-2.0
"""Aria: an Idefics3 (SigLIP) vision tower, a cross-attention projector and
a grouped-expert MoE language model with shared experts.

Mirrors `hqq_tpu.models.aria` (HF ``AriaForConditionalGeneration``):

* the tower: patches flattened in (c, ph, pw) order (the stride-p
  convolution as a matmul), learned position embeddings at Idefics3's
  bucketed position ids (`_position_ids`), pre-LN encoder layers with a
  tanh-GELU MLP; ``vision_feature_layer`` -1 runs every layer and no
  post-layernorm is applied;
* the projector: the first ``query_num`` learned queries (by the image's
  patch count, ``patch_to_query``) cross-attend to the patch features
  through q/k/v pre-projections over LayerNormed inputs, then an
  ``nn.MultiheadAttention`` with its own joint in-projection and
  out-projection, a linear, then LayerNorm, ``linear_in``, the tanh GELU
  and ``linear_out`` with no residual. The projector's norms use eps 1e-5,
  not the tower's;
* the text MoE: the router's softmax over all experts in fp32, the top-k
  renormalized (`nn.moe.route_tokens`), the stacked experts' ``fc1`` [E,
  2f, d] split into the projection (first half) and the gate (second),
  ``fc2(silu(projection) * gate)``, combined by each token's own slots
  (`nn.moe.combine_experts`), plus the always-on shared experts (a Llama
  MLP at width f * ``moe_num_shared_experts``).

Attention is `models.llama`'s: the dense cache (an int, 0-d or [B]
``start_pos``; ``kv_valid``; ``inputs_embeds``) and ``cache=None``.
Every norm is one launch of the fixed-order norm kernels (`ops.norm`); the
tower's and the projector's unquantized products are `F.linear` and
plain torch attention (fp32 scores), as `hqq_tpu` computes them outside
any Pallas kernel. Expert parallelism (``ep_axis``, `parallel/`) is not
ported: a config that sets it raises.

Parameters are ``{"text", "vision", "projector"}``;
`params_from_hf_state_dict` returns the text tree and ``{"vision",
"projector"}`` apart (the vision-language engine's two trees, `engine.vl`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..nn.linear import Linear
from ..nn.moe import (GroupedLinear, combine_experts, quantize_experts, refuse_expert_parallel,
                      route_tokens)
from . import llama
from .llama import layer_norm, rms_norm
from .llava import _VISION_ACTS, _patchify, _vision_attention, splice_rows

__all__ = ["AriaTextConfig", "IdeficsVisionConfig", "AriaConfig", "init_layer", "init_params",
           "vision_forward", "embed_multimodal", "forward", "init_cache", "quantize_aria",
           "params_from_hf_state_dict"]

# the projector's LayerNorms are plain nn.LayerNorm (eps 1e-5), not the tower's
PROJECTOR_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class AriaTextConfig(llama.LlamaConfig):
    moe_num_experts: int = 8
    moe_topk: int = 2
    moe_num_shared_experts: int = 2
    capacity_factor: float = 2.0  # >= E/top_k drops nothing
    ep_axis: Optional[str] = None  # expert parallelism: not ported, must stay None

    def __post_init__(self):
        super().__post_init__()
        refuse_expert_parallel(self)

    @classmethod
    def from_hf(cls, hf: dict) -> "AriaTextConfig":
        base = llama.LlamaConfig.from_hf(hf)
        return cls(**dataclasses.asdict(base),
                   moe_num_experts=hf.get("moe_num_experts", 8),
                   moe_topk=hf.get("moe_topk", 2),
                   moe_num_shared_experts=hf.get("moe_num_shared_experts", 2))


@dataclasses.dataclass(frozen=True)
class IdeficsVisionConfig:
    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    image_size: int = 980
    patch_size: int = 14
    num_channels: int = 3
    layer_norm_eps: float = 1e-6
    hidden_act: str = "gelu_pytorch_tanh"

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim_(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def from_hf(cls, hf: dict) -> "IdeficsVisionConfig":
        return cls(
            hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"],
            num_hidden_layers=hf["num_hidden_layers"],
            num_attention_heads=hf["num_attention_heads"],
            image_size=hf["image_size"],
            patch_size=hf["patch_size"],
            num_channels=hf.get("num_channels", 3),
            layer_norm_eps=hf.get("layer_norm_eps", 1e-6),
            hidden_act=hf.get("hidden_act", "gelu_pytorch_tanh"),
        )


def _query_pairs(p2q) -> tuple:
    """``patch_to_query`` as sorted (patches, queries) int pairs, from a
    dict or from pairs (a checkpoint's JSON gives lists)."""
    items = p2q.items() if isinstance(p2q, dict) else p2q
    return tuple(sorted((int(k), int(v)) for k, v in items))


@dataclasses.dataclass(frozen=True)
class AriaConfig:
    text: AriaTextConfig = dataclasses.field(default_factory=AriaTextConfig)
    vision: IdeficsVisionConfig = dataclasses.field(default_factory=IdeficsVisionConfig)
    image_token_index: int = 9
    vision_feature_layer: int = -1
    # (patch count, query count) pairs: HF's projector_patch_to_query_dict
    patch_to_query: tuple = ((1225, 128), (4900, 256))

    def __post_init__(self):
        object.__setattr__(self, "patch_to_query", _query_pairs(self.patch_to_query))

    @property
    def max_query_num(self) -> int:
        return max(v for _, v in self.patch_to_query)

    @property
    def tower_layers(self) -> int:
        """The encoder layers the tower runs: up to ``vision_feature_layer``
        of the [embeddings, layer 1, ...] list (-1: all of them)."""
        fl = self.vision_feature_layer
        return self.vision.num_hidden_layers + 1 + fl if fl < 0 else fl

    @classmethod
    def from_hf(cls, hf: dict) -> "AriaConfig":
        return cls(
            text=AriaTextConfig.from_hf(hf["text_config"]),
            vision=IdeficsVisionConfig.from_hf(hf["vision_config"]),
            image_token_index=hf.get("image_token_index", 9),
            vision_feature_layer=hf.get("vision_feature_layer", -1),
            patch_to_query=_query_pairs(hf.get("projector_patch_to_query_dict",
                                               {1225: 128, 4900: 256})),
        )

    @classmethod
    def tiny(cls, vocab_size: int = 256) -> "AriaConfig":
        return cls(
            text=AriaTextConfig(
                vocab_size=vocab_size, hidden_size=64, intermediate_size=48,
                num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                max_position_embeddings=128, moe_num_experts=4, moe_topk=2,
                moe_num_shared_experts=2),
            vision=IdeficsVisionConfig(
                hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                num_attention_heads=4, image_size=16, patch_size=4),
            image_token_index=254,
            patch_to_query=((16, 4),),
        )


# --------------------------------------------------------------------------
# The tower and the projector
# --------------------------------------------------------------------------


def _position_ids(side: int, n_h: int, n_w: int) -> np.ndarray:
    """Idefics3's fractional-coordinate bucketing, on the host in numpy as
    `hqq_tpu` computes it: each axis's fractions i / n, nudged by (1 - 1e-6)
    just below their bucket's boundary, bucketed with ``side="right"``. Not
    the identity even at the native resolution: side 4 gives per-axis ids
    [0, 0, 1, 2], rows that HF's reference duplicates too. Returns the
    flattened ids [n_h * n_w] (int64)."""
    boundaries = np.arange(1 / side, 1.0, 1 / side)

    def bucket(n):
        frac = np.arange(n) / n * (1 - 1e-6)
        return np.searchsorted(boundaries, frac, side="right")

    bh, bw = bucket(n_h), bucket(n_w)
    return (bh[:, None] * side + bw[None, :]).reshape(-1)


def _tower_forward(params: dict, cfg: AriaConfig, pixels: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] pixels -> the hidden states of layer
    ``vision_feature_layer`` [B, N, H] (no post-layernorm)."""
    vc = cfg.vision
    vp = params["vision"]
    pos_emb = vp["position_embeddings"]
    patches = _patchify(pixels.to(torch.float32), vc.patch_size).to(pos_emb.dtype)
    x = vp["patch_proj"](patches)
    side = vc.image_size // vc.patch_size
    pos = _position_ids(side, pixels.shape[2] // vc.patch_size, pixels.shape[3] // vc.patch_size)
    x = x + pos_emb[torch.from_numpy(pos).to(pos_emb.device)]

    act = _VISION_ACTS[vc.hidden_act]
    for layer in vp["layers"][:cfg.tower_layers]:
        h = layer_norm(x, layer["layer_norm1"], vc.layer_norm_eps)
        x = x + _vision_attention(layer, vc, h)
        h = layer_norm(x, layer["layer_norm2"], vc.layer_norm_eps)
        x = x + layer["fc2"](act(layer["fc1"](h)))
    return x


def _mha(proj: dict, cfg: AriaConfig, q: torch.Tensor, k: torch.Tensor,
         v: torch.Tensor) -> torch.Tensor:
    """``nn.MultiheadAttention`` (batch first) over the already projected
    q, k, v: the joint ``in_proj`` [3d, d] split in thirds [q; k; v] with
    its bias, the tower's heads, scores in fp32 divided by sqrt(hd), the
    probabilities in q's type times v, then ``out_proj``."""
    b, tq, d = q.shape
    nh = cfg.vision.num_attention_heads
    hd = d // nh
    w, bias = proj["in_proj"].weight, proj["in_proj"].bias

    def heads(x, i):
        y = x @ w[i * d:(i + 1) * d].to(x.dtype).t() + bias[i * d:(i + 1) * d].to(x.dtype)
        return y.reshape(b, -1, nh, hd).transpose(1, 2)

    qh, kh, vh = heads(q, 0), heads(k, 1), heads(v, 2)
    scores = (qh.to(torch.float32) @ kh.to(torch.float32).transpose(-1, -2)) / math.sqrt(hd)
    probs = torch.softmax(scores, dim=-1).to(qh.dtype)
    out = (probs @ vh).transpose(1, 2).reshape(b, tq, d)
    return proj["out_proj"](out)


def vision_forward(params: dict, cfg: AriaConfig, pixels: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] pixels -> the projected image rows [B, query_num, text
    hidden] (HF's ``get_image_features`` and ``AriaProjector``). ``params``
    holds "vision" and "projector". An image whose patch count is not in
    ``patch_to_query`` is a ValueError."""
    feats = _tower_forward(params, cfg, pixels)  # [B, N, H]
    n_patches = feats.shape[1]
    queries_of = dict(cfg.patch_to_query)
    if n_patches not in queries_of:
        raise ValueError(f"an image of {n_patches} patches: the projector knows "
                         f"{sorted(queries_of)} (patch_to_query)")
    query_num = queries_of[n_patches]

    proj = params["projector"]
    ca = proj["cross_attn"]
    b = feats.shape[0]
    query = proj["query"]
    queries = query[:query_num].expand(b, query_num, query.shape[-1])
    q = ca["q_proj"](layer_norm(queries, ca["layer_norm"], PROJECTOR_EPS))
    kv = layer_norm(feats, ca["layer_norm_kv"], PROJECTOR_EPS)
    attn = ca["linear"](_mha(ca, cfg, q, ca["k_proj"](kv), ca["v_proj"](kv)))
    h = layer_norm(attn, proj["layer_norm"], PROJECTOR_EPS)
    return proj["linear_out"](F.gelu(proj["linear_in"](h), approximate="tanh"))


# --------------------------------------------------------------------------
# The text MoE decoder
# --------------------------------------------------------------------------


def _moe_block(mlp: dict, cfg: AriaTextConfig, x: torch.Tensor) -> torch.Tensor:
    """x [B, T, D] -> [B, T, D]: the routed experts (``fc1``'s output split
    into the projection, then the gate; silu(projection) * gate through
    ``fc2``), combined over each token's own top-k slots in fp32, plus the
    shared experts."""
    b, t, d = x.shape
    xf = x.reshape(b * t, d)
    combine, expert_in = route_tokens(mlp["router"], xf, cfg.moe_topk, cfg.capacity_factor)
    ex = mlp["experts"]
    proj_h, gate = ex["fc1"](expert_in).chunk(2, dim=-1)  # [E, C, f] each
    expert_out = ex["fc2"](F.silu(proj_h) * gate)
    routed = combine_experts(combine, expert_out, cfg.moe_topk).reshape(b, t, d).to(x.dtype)
    return routed + llama._mlp(mlp["shared_experts"], x)


def _text_of(params, cfg):
    """(the text tree, the text config) of the whole tree or the text tree
    alone, and of an `AriaConfig` or an `AriaTextConfig`."""
    text = params["text"] if isinstance(params, dict) and "text" in params else params
    return text, cfg.text if isinstance(cfg, AriaConfig) else cfg


def forward(params, cfg, tokens: Optional[torch.Tensor], cache=None, start_pos=0,
            kv_valid: Optional[torch.Tensor] = None,
            inputs_embeds: Optional[torch.Tensor] = None):
    """Run the text model over ``tokens`` [B, T] (or ``inputs_embeds``
    [B, T, D]) from ``start_pos``: Llama attention over the dense cache,
    updated in place (``start_pos`` an int, a 0-d or a [B] tensor;
    ``kv_valid`` [B, S_max] masks cache slots), or with ``cache=None`` over
    the sequence alone, and the MoE block as the MLP. ``params`` is the
    whole tree or the text tree, ``cfg`` an `AriaConfig` or an
    `AriaTextConfig`. Returns (logits [B, T, V] fp32, cache)."""
    text, tcfg = _text_of(params, cfg)
    x = inputs_embeds if inputs_embeds is not None else text["embed_tokens"][tokens]
    _, cos, sin, mask = llama.positions_and_masks(
        tcfg, x.shape[1], start_pos, None if cache is None else cache.max_len, x.device,
        kv_valid)
    for i, layer in enumerate(text["layers"]):
        h = rms_norm(x, layer["input_layernorm"], tcfg.rms_norm_eps)
        if cache is None:
            x = x + llama._attention_nocache(layer["self_attn"], tcfg, h, mask, cos, sin)
        else:
            x = x + llama._attention(layer["self_attn"], tcfg, h, cache, i, start_pos, mask,
                                     cos, sin)
        h = rms_norm(x, layer["post_attention_layernorm"], tcfg.rms_norm_eps)
        x = x + _moe_block(layer["mlp"], tcfg, h)
    return llama._logits(text, tcfg, x), cache


def embed_multimodal(params: dict, cfg: AriaConfig, tokens: torch.Tensor,
                     image_embeds: torch.Tensor) -> torch.Tensor:
    """The token embedding of ``tokens`` [B, T] with the image rows
    ``image_embeds`` [n, D] over the ``image_token_index`` placeholders,
    after a host check of the placeholder count (`llava.splice_rows`)."""
    text, _ = _text_of(params, cfg)
    emb = text["embed_tokens"][tokens.to(text["embed_tokens"].device)]
    return splice_rows(emb, tokens, cfg.image_token_index, image_embeds)


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, device="cuda",
               quantize_kv: bool = False):
    """Llama's dense cache for the text model (``cfg`` an `AriaConfig` or an
    `AriaTextConfig`)."""
    tcfg = cfg.text if isinstance(cfg, AriaConfig) else cfg
    return llama.init_cache(tcfg, batch, max_len, dtype, device, quantize_kv)


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------


def _drawers(generator: torch.Generator, dtype, device):
    """(randn, lin, ln): fp32 normals from ``generator``; a `Linear` N(0,
    1/in) with a zero bias or none; a LayerNorm leaf of ones and zeros."""
    def randn(*shape):
        return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)

    def lin(o, i, bias=True):
        return Linear((randn(o, i) / math.sqrt(i)).to(dtype),
                      torch.zeros((o,), dtype=dtype, device=device) if bias else None)

    def ln(n):
        return {"weight": torch.ones((n,), dtype=dtype, device=device),
                "bias": torch.zeros((n,), dtype=dtype, device=device)}

    return randn, lin, ln


def init_layer(cfg: AriaTextConfig, generator: torch.Generator, dtype=torch.bfloat16,
               device="cuda") -> dict:
    """One text decoder layer in `hqq_tpu`'s layout: the attention, the
    router and the expert stacks ``fc1`` [E, 2f, d] and ``fc2`` [E, d, f]
    N(0, 1/in) drawn in fp32 from ``generator`` and cast to ``dtype``, the
    shared experts at width f * ``moe_num_shared_experts``, norm weights
    one."""
    randn, lin, _ = _drawers(generator, dtype, device)
    d, f, e = cfg.hidden_size, cfg.intermediate_size, cfg.moe_num_experts
    nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_
    sf = f * cfg.moe_num_shared_experts

    def grouped(o, i):
        return GroupedLinear((randn(e, o, i) / math.sqrt(i)).to(dtype))

    return {
        "self_attn": {"q_proj": lin(nh * hd, d, False), "k_proj": lin(nkv * hd, d, False),
                      "v_proj": lin(nkv * hd, d, False), "o_proj": lin(d, nh * hd, False)},
        "mlp": {
            "router": lin(e, d, False),
            "experts": {"fc1": grouped(2 * f, d), "fc2": grouped(d, f)},
            "shared_experts": {"gate_proj": lin(sf, d, False), "up_proj": lin(sf, d, False),
                               "down_proj": lin(d, sf, False)},
        },
        "input_layernorm": torch.ones((d,), dtype=dtype, device=device),
        "post_attention_layernorm": torch.ones((d,), dtype=dtype, device=device),
    }


def init_params(cfg: AriaConfig, generator: Optional[torch.Generator] = None,
                dtype=torch.float32, device="cuda") -> dict:
    """A random tree in `hqq_tpu`'s layout, drawn in fp32 from ``generator``
    (seed 0 on ``device`` when None) and cast to ``dtype``: the tower and
    the projector (linears N(0, 1/in) with zero biases, LayerNorms one and
    zero, the position embeddings and the queries N(0, 0.02^2)), then the
    text model (`init_layer` for each layer, the embedding N(0, 0.02^2),
    an untied lm_head)."""
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    randn, lin, ln = _drawers(generator, dtype, device)
    tc, vc = cfg.text, cfg.vision
    d, vd, vf = tc.hidden_size, vc.hidden_size, vc.intermediate_size
    vision = {
        "patch_proj": lin(vd, vc.num_channels * vc.patch_size ** 2),
        "position_embeddings": (randn(vc.num_patches, vd) * 0.02).to(dtype),
        "layers": [{"q_proj": lin(vd, vd), "k_proj": lin(vd, vd), "v_proj": lin(vd, vd),
                    "out_proj": lin(vd, vd), "fc1": lin(vf, vd), "fc2": lin(vd, vf),
                    "layer_norm1": ln(vd), "layer_norm2": ln(vd)}
                   for _ in range(vc.num_hidden_layers)],
    }
    projector = {
        "query": (randn(cfg.max_query_num, vd) * 0.02).to(dtype),
        "cross_attn": {"q_proj": lin(vd, vd, False), "k_proj": lin(vd, vd, False),
                       "v_proj": lin(vd, vd, False), "in_proj": lin(3 * vd, vd),
                       "out_proj": lin(vd, vd), "linear": lin(vd, vd),
                       "layer_norm": ln(vd), "layer_norm_kv": ln(vd)},
        "layer_norm": ln(vd),
        "linear_in": lin(d, vd, False),
        "linear_out": lin(d, d, False),
    }
    text = {
        "embed_tokens": (randn(tc.vocab_size, d) * 0.02).to(dtype),
        "layers": [init_layer(tc, generator, dtype, device) for _ in range(tc.num_hidden_layers)],
        "norm": torch.ones((d,), dtype=dtype, device=device),
        "lm_head": lin(tc.vocab_size, d, False),
    }
    return {"text": text, "vision": vision, "projector": projector}


def quantize_aria(params: dict, attn_config: Optional[dict] = None,
                  expert_config: Optional[dict] = None, compute_dtype=torch.bfloat16) -> dict:
    """Quantize the text model's attention and shared experts
    (`quantize_model`) and its expert stacks (`quantize_grouped`), in
    place; the router, lm_head, the tower and the projector stay in full
    precision, as in `hqq_tpu`. Default configs 4-bit g64 for both. Returns
    ``{"text", "vision", "projector"}``."""
    from ..core.quantize import BaseQuantizeConfig
    from .base import quantize_model

    attn_config = attn_config or BaseQuantizeConfig(nbits=4, group_size=64)
    expert_config = expert_config or BaseQuantizeConfig(nbits=4, group_size=64)
    text = quantize_model(params["text"], attn_config, compute_dtype,
                          ignore=("lm_head", "mlp.router"))
    for layer in text["layers"]:
        quantize_experts(layer["mlp"]["experts"], ("fc1", "fc2"), expert_config, compute_dtype)
    return {"text": text, "vision": params["vision"], "projector": params["projector"]}


def params_from_hf_state_dict(state: Dict[str, torch.Tensor], cfg: AriaConfig,
                              dtype=torch.float32):
    """(text tree, {"vision", "projector"}) of an HF
    ``AriaForConditionalGeneration`` state dict (name -> tensor): the
    ``model.language_model.*``, ``model.vision_tower.*`` and
    ``model.multi_modal_projector.*`` names; the experts' ``fc1``/``fc2``
    [E, in, out] transposed to [E, out, in]; the patch convolution's weight
    flattened over (c, ph, pw)."""

    def arr(name):
        return state[name].to(dtype)

    def lin(prefix):
        b = prefix + ".bias"
        return Linear(arr(prefix + ".weight"), arr(b) if b in state else None)

    def ln(prefix):
        return {"weight": arr(prefix + ".weight"), "bias": arr(prefix + ".bias")}

    def stack(name):
        return GroupedLinear(arr(name).transpose(1, 2).contiguous())

    layers = []
    for i in range(cfg.text.num_hidden_layers):
        p = f"model.language_model.layers.{i}"
        layers.append({
            "self_attn": {f"{t}_proj": lin(f"{p}.self_attn.{t}_proj") for t in "qkvo"},
            "mlp": {
                "router": lin(f"{p}.mlp.router"),
                "experts": {"fc1": stack(f"{p}.mlp.experts.fc1.weight"),
                            "fc2": stack(f"{p}.mlp.experts.fc2.weight")},
                "shared_experts": {f"{t}_proj": lin(f"{p}.mlp.shared_experts.{t}_proj")
                                   for t in ("gate", "up", "down")},
            },
            "input_layernorm": arr(f"{p}.input_layernorm.weight"),
            "post_attention_layernorm": arr(f"{p}.post_attention_layernorm.weight"),
        })
    text = {"embed_tokens": arr("model.language_model.embed_tokens.weight"), "layers": layers,
            "norm": arr("model.language_model.norm.weight")}
    if "lm_head.weight" in state:
        text["lm_head"] = lin("lm_head")

    vt = "model.vision_tower"
    conv_w = arr(f"{vt}.embeddings.patch_embedding.weight")
    vision = {
        "patch_proj": Linear(conv_w.reshape(conv_w.shape[0], -1),
                             arr(f"{vt}.embeddings.patch_embedding.bias")),
        "position_embeddings": arr(f"{vt}.embeddings.position_embedding.weight"),
        "layers": [{
            "q_proj": lin(f"{p}.self_attn.q_proj"), "k_proj": lin(f"{p}.self_attn.k_proj"),
            "v_proj": lin(f"{p}.self_attn.v_proj"), "out_proj": lin(f"{p}.self_attn.out_proj"),
            "fc1": lin(f"{p}.mlp.fc1"), "fc2": lin(f"{p}.mlp.fc2"),
            "layer_norm1": ln(f"{p}.layer_norm1"), "layer_norm2": ln(f"{p}.layer_norm2"),
        } for p in (f"{vt}.encoder.layers.{i}" for i in range(cfg.vision.num_hidden_layers))],
    }

    mp = "model.multi_modal_projector"
    projector = {
        "query": arr(f"{mp}.query"),
        "cross_attn": {
            "q_proj": lin(f"{mp}.cross_attn.q_proj"),
            "k_proj": lin(f"{mp}.cross_attn.k_proj"),
            "v_proj": lin(f"{mp}.cross_attn.v_proj"),
            "in_proj": Linear(arr(f"{mp}.cross_attn.multihead_attn.in_proj_weight"),
                              arr(f"{mp}.cross_attn.multihead_attn.in_proj_bias")),
            "out_proj": lin(f"{mp}.cross_attn.multihead_attn.out_proj"),
            "linear": lin(f"{mp}.cross_attn.linear"),
            "layer_norm": ln(f"{mp}.cross_attn.layer_norm"),
            "layer_norm_kv": ln(f"{mp}.cross_attn.layer_norm_kv"),
        },
        "layer_norm": ln(f"{mp}.layer_norm"),
        "linear_in": lin(f"{mp}.feed_forward.linear_in"),
        "linear_out": lin(f"{mp}.feed_forward.linear_out"),
    }
    return text, {"vision": vision, "projector": projector}
