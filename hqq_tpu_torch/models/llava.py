# SPDX-License-Identifier: Apache-2.0
"""LLaVA: a CLIP vision tower, a two-layer projector and a Llama language
model.

Mirrors `hqq_tpu.models.llava` (HF ``LlavaForConditionalGeneration``):

* the CLIP tower is pre-LN: patches flattened in (c, ph, pw) order (the
  stride-p convolution as a matmul), a class embedding in front, learned
  position embeddings, ``pre_layernorm``, then encoder layers of
  attention and an MLP (quick-GELU by default). It stops at
  ``vision_feature_layer`` (-2: 23 of 24 layers run, no post-layernorm)
  and drops the CLS row under the "default" strategy;
* the projector is ``linear_1``, the erf GELU, ``linear_2``;
* `embed_multimodal` writes the image rows over the
  ``image_token_index`` placeholders of the token embedding, after a
  check on the host that there are as many placeholders as image rows;
* the text forward is `models.llama.forward` with ordinary sequential
  positions (LLaVA-1.5, unlike Qwen2-VL's M-RoPE).

Every LayerNorm is one launch of the fixed-order kernel (`ops.norm`). The
tower's attention is non-causal plain torch (the scores and softmax in
fp32, the probabilities rounded to q's type before the product with v),
as `hqq_tpu` computes it outside any Pallas kernel.

Parameters are ``{"text", "vision", "projector"}``; `params_from_hf_state_dict`
returns the text tree and ``{"vision", "projector"}`` apart (the
vision-language engine's two trees, `engine.vl`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..nn.linear import Linear
from . import llama
from .llama import layer_norm

__all__ = ["ClipVisionConfig", "LlavaConfig", "VISION_FP_TAGS", "quick_gelu", "init_params",
           "vision_forward", "splice_rows", "embed_multimodal", "forward", "init_cache",
           "params_from_hf_state_dict"]

# vision linears that stay in full precision under quantize_model: the
# patch projection and the projector (small and quality-critical, as
# lm_head)
VISION_FP_TAGS = ("patch_proj", "linear_1", "linear_2")


@dataclasses.dataclass(frozen=True)
class ClipVisionConfig:
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    image_size: int = 336
    patch_size: int = 14
    num_channels: int = 3
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim_(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def from_hf(cls, hf: dict) -> "ClipVisionConfig":
        return cls(
            hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"],
            num_hidden_layers=hf["num_hidden_layers"],
            num_attention_heads=hf["num_attention_heads"],
            image_size=hf.get("image_size", 336),
            patch_size=hf.get("patch_size", 14),
            num_channels=hf.get("num_channels", 3),
            layer_norm_eps=hf.get("layer_norm_eps", 1e-5),
            hidden_act=hf.get("hidden_act", "quick_gelu"),
        )


@dataclasses.dataclass(frozen=True)
class LlavaConfig:
    text: llama.LlamaConfig = dataclasses.field(default_factory=llama.LlamaConfig)
    vision: ClipVisionConfig = dataclasses.field(default_factory=ClipVisionConfig)
    image_token_index: int = 32000
    vision_feature_layer: int = -2
    vision_feature_select_strategy: str = "default"

    @classmethod
    def from_hf(cls, hf: dict) -> "LlavaConfig":
        return cls(
            text=llama.LlamaConfig.from_hf(hf["text_config"]),
            vision=ClipVisionConfig.from_hf(hf["vision_config"]),
            image_token_index=hf.get("image_token_index", 32000),
            vision_feature_layer=hf.get("vision_feature_layer", -2),
            vision_feature_select_strategy=hf.get("vision_feature_select_strategy", "default"),
        )

    @classmethod
    def tiny(cls, vocab_size: int = 256) -> "LlavaConfig":
        return cls(
            text=llama.LlamaConfig(
                vocab_size=vocab_size, hidden_size=64, intermediate_size=48,
                num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                max_position_embeddings=256),
            vision=ClipVisionConfig(
                hidden_size=32, intermediate_size=64, num_hidden_layers=3,
                num_attention_heads=4, image_size=16, patch_size=4),
            image_token_index=vocab_size - 2,
        )

    @property
    def tower_layers(self) -> int:
        """The encoder layers `vision_forward` runs: up to
        ``vision_feature_layer`` of the [embeddings, layer 1, ...] list."""
        fl = self.vision_feature_layer
        return self.vision.num_hidden_layers + 1 + fl if fl < 0 else fl


# --------------------------------------------------------------------------
# CLIP vision tower
# --------------------------------------------------------------------------


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


_VISION_ACTS = {
    "quick_gelu": quick_gelu,
    "gelu": lambda x: F.gelu(x),
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_pytorch_tanh": lambda x: F.gelu(x, approximate="tanh"),
}


def _patchify(pixels: torch.Tensor, p: int) -> torch.Tensor:
    """[B, C, H, W] -> [B, N, C*p*p] in (c, ph, pw) flatten order (the HF
    convolution as a matmul)."""
    b, c, h, w = pixels.shape
    x = pixels.reshape(b, c, h // p, p, w // p, p).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, (h // p) * (w // p), c * p * p)


def _vision_attention(layer: dict, cfg: ClipVisionConfig, x: torch.Tensor) -> torch.Tensor:
    """Non-causal attention over the image's rows: the scores in fp32,
    divided by sqrt(hd), softmax, the probabilities in q's type times v."""
    b, t, d = x.shape
    nh, hd = cfg.num_attention_heads, cfg.head_dim_

    def heads(lin):
        return layer[lin](x).reshape(b, t, nh, hd).transpose(1, 2)

    q, k, v = heads("q_proj"), heads("k_proj"), heads("v_proj")
    scores = (q.to(torch.float32) @ k.to(torch.float32).transpose(-1, -2)) / math.sqrt(hd)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = probs @ v
    return layer["out_proj"](out.transpose(1, 2).reshape(b, t, d))


def vision_forward(params: dict, cfg: LlavaConfig, pixels: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] pixels -> projected image rows [B, N (N - 1 without
    CLS), text hidden], as HF's ``get_image_features``. ``params`` holds
    "vision" and "projector"."""
    vc = cfg.vision
    vp = params["vision"]
    b = pixels.shape[0]
    cls_emb = vp["class_embedding"]
    patches = _patchify(pixels.to(torch.float32), vc.patch_size).to(cls_emb.dtype)
    x = vp["patch_proj"](patches)
    cls = cls_emb.expand(b, 1, vc.hidden_size)
    x = torch.cat([cls, x], dim=1) + vp["position_embeddings"]
    x = layer_norm(x, vp["pre_layernorm"], vc.layer_norm_eps)

    act = _VISION_ACTS[vc.hidden_act]
    for layer in vp["layers"][:cfg.tower_layers]:
        h = layer_norm(x, layer["layer_norm1"], vc.layer_norm_eps)
        x = x + _vision_attention(layer, vc, h)
        h = layer_norm(x, layer["layer_norm2"], vc.layer_norm_eps)
        x = x + layer["fc2"](act(layer["fc1"](h)))

    if cfg.vision_feature_select_strategy == "default":
        x = x[:, 1:]  # drop CLS
    proj = params["projector"]
    return proj["linear_2"](F.gelu(proj["linear_1"](x)))


# --------------------------------------------------------------------------
# The splice and the text forward
# --------------------------------------------------------------------------


def splice_rows(embeds: torch.Tensor, tokens: torch.Tensor, placeholder: int,
                image_embeds: torch.Tensor) -> torch.Tensor:
    """``embeds`` [B, T, D] with row j of ``image_embeds`` [n, D] written
    over the j-th ``placeholder`` token of ``tokens`` [B, T] (HF's
    masked_scatter). The placeholders are counted on the host first: a
    count other than n is a ValueError (HF raises "Image features and image
    tokens do not match" there)."""
    b, t, d = embeds.shape
    is_img = (tokens == placeholder).reshape(-1)
    n_ph = int(is_img.sum())
    if n_ph != image_embeds.shape[0]:
        raise ValueError(f"the prompt has {n_ph} image placeholders but the image gives "
                         f"{image_embeds.shape[0]} rows")
    flat = embeds.reshape(b * t, d).clone()
    flat[is_img.nonzero()[:, 0]] = image_embeds.to(flat.dtype)
    return flat.reshape(b, t, d)


def embed_multimodal(params: dict, cfg: LlavaConfig, tokens: torch.Tensor,
                     image_embeds: torch.Tensor) -> torch.Tensor:
    """The token embedding of ``tokens`` [B, T] with the image rows
    ``image_embeds`` [n, D] (flattened over the images) over the
    ``image_token_index`` placeholders (`splice_rows`)."""
    text = params["text"]
    emb = text["embed_tokens"][tokens.to(text["embed_tokens"].device)]
    return splice_rows(emb, tokens, cfg.image_token_index, image_embeds)


def forward(params, cfg: LlavaConfig, tokens, cache=None, start_pos=0, **kw):
    """The text forward, plain Llama with sequential positions. ``params``
    is the whole tree or the text tree alone."""
    text = params["text"] if isinstance(params, dict) and "text" in params else params
    return llama.forward(text, cfg.text, tokens, cache, start_pos, **kw)


def init_cache(cfg: LlavaConfig, batch: int, max_len: int, dtype=torch.bfloat16, device="cuda",
               quantize_kv: bool = False):
    return llama.init_cache(cfg.text, batch, max_len, dtype, device, quantize_kv)


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------


def init_params(cfg: LlavaConfig, generator: Optional[torch.Generator] = None,
                dtype=torch.float32, device="cuda") -> dict:
    """A random tree in `hqq_tpu`'s layout: linears N(0, 1/in_features)
    with zero biases, LayerNorms weight one and bias zero, the class,
    position and patch embeddings N(0, 0.02^2); drawn in fp32 from
    ``generator`` (seed 0 on ``device`` when None), cast to ``dtype``. The
    text tree is `llama.init_params`'s, drawn last."""
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    vc = cfg.vision
    d, f, td = vc.hidden_size, vc.intermediate_size, cfg.text.hidden_size

    def randn(*shape):
        return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)

    def lin(o, i):
        return Linear((randn(o, i) / math.sqrt(i)).to(dtype),
                      torch.zeros((o,), dtype=dtype, device=device))

    def ln(n):
        return {"weight": torch.ones((n,), dtype=dtype, device=device),
                "bias": torch.zeros((n,), dtype=dtype, device=device)}

    layers = [{"layer_norm1": ln(d), "q_proj": lin(d, d), "k_proj": lin(d, d),
               "v_proj": lin(d, d), "out_proj": lin(d, d), "layer_norm2": ln(d),
               "fc1": lin(f, d), "fc2": lin(d, f)}
              for _ in range(vc.num_hidden_layers)]
    vision = {
        "class_embedding": (randn(1, 1, d) * 0.02).to(dtype),
        "position_embeddings": (randn(1, vc.num_patches + 1, d) * 0.02).to(dtype),
        "patch_proj": Linear((randn(d, vc.num_channels * vc.patch_size ** 2) * 0.02).to(dtype)),
        "pre_layernorm": ln(d),
        "layers": layers,
    }
    return {"vision": vision, "projector": {"linear_1": lin(td, d), "linear_2": lin(td, td)},
            "text": llama.init_params(cfg.text, generator, dtype, device)}


def params_from_hf_state_dict(state: dict, cfg: LlavaConfig,
                              dtype=torch.float32) -> Tuple[dict, dict]:
    """(text tree, {"vision", "projector"}) of an HF
    ``LlavaForConditionalGeneration`` state dict (name -> tensor); the
    layout of transformers >= 4.52 (``model.vision_tower``,
    ``model.language_model``, a top-level ``lm_head``) is renamed to the
    classic one first."""
    from .hf import params_from_hf_state_dict as llama_loader

    if any(k.startswith("model.vision_tower") for k in state):
        new = {}
        for k, v in state.items():
            if k.startswith("model.language_model."):
                new["language_model.model." + k[len("model.language_model."):]] = v
            elif k.startswith("model."):
                new[k[len("model."):]] = v
            else:
                new[k] = v
        if "lm_head.weight" in new:
            new["language_model.lm_head.weight"] = new.pop("lm_head.weight")
        state = new

    def arr(name):
        return state[name].to(dtype)

    def lin(name):
        b = f"{name}.bias"
        return Linear(arr(f"{name}.weight"), arr(b) if b in state else None)

    def ln(name):
        return {"weight": arr(f"{name}.weight"), "bias": arr(f"{name}.bias")}

    vt = "vision_tower.vision_model"
    layers = []
    for i in range(cfg.vision.num_hidden_layers):
        p = f"{vt}.encoder.layers.{i}"
        layers.append({
            "layer_norm1": ln(f"{p}.layer_norm1"),
            "q_proj": lin(f"{p}.self_attn.q_proj"),
            "k_proj": lin(f"{p}.self_attn.k_proj"),
            "v_proj": lin(f"{p}.self_attn.v_proj"),
            "out_proj": lin(f"{p}.self_attn.out_proj"),
            "layer_norm2": ln(f"{p}.layer_norm2"),
            "fc1": lin(f"{p}.mlp.fc1"),
            "fc2": lin(f"{p}.mlp.fc2"),
        })
    conv_w = arr(f"{vt}.embeddings.patch_embedding.weight")
    d = conv_w.shape[0]
    vision = {
        "class_embedding": arr(f"{vt}.embeddings.class_embedding").reshape(1, 1, d),
        "position_embeddings": arr(f"{vt}.embeddings.position_embedding.weight")[None],
        "patch_proj": Linear(conv_w.reshape(d, -1)),
        "pre_layernorm": ln(f"{vt}.pre_layrnorm"),  # HF's historical spelling
        "layers": layers,
    }
    projector = {"linear_1": lin("multi_modal_projector.linear_1"),
                 "linear_2": lin("multi_modal_projector.linear_2")}
    lm_state = {k[len("language_model."):]: v for k, v in state.items()
                if k.startswith("language_model.")}
    text = llama_loader(lm_state, cfg.text, dtype)
    return text, {"vision": vision, "projector": projector}
