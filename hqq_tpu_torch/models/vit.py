# SPDX-License-Identifier: Apache-2.0
"""Vision Transformer (HF ``ViTForImageClassification``): the vision model
family.

Mirrors `hqq_tpu.models.vit`, pre-LN:

    patches = unfold(pixels, p)                 # [B, N, C*p*p], (c, ph, pw)
    x = concat(cls, patches @ W_patch) + pos
    per layer: x += attn(LN1(x)); x += mlp(LN2(x))    # the erf GELU
    logits = classifier(pool(LN(x)))            # pool "cls" or "mean"

Its linear leaves quantize through the same `quantize_model` tree walker as
the language models; the patch projection and the classifier stay in full
precision (`engine.vision`). Every LayerNorm is one launch of the
fixed-order norm kernel (`ops.norm`, eps 1e-12 by default); attention is
plain torch, non-causal, the scores and softmax in fp32, the probabilities
rounded to q's type before the product with v, as `hqq_tpu` computes it
outside any Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..nn.linear import Linear
from .llama import layer_norm
from .llava import _patchify

__all__ = ["ViTConfig", "LINEAR_TAGS", "init_params", "forward", "params_from_hf_state_dict"]

# the quantizable linear tags (the patch projection and the classifier stay
# in full precision, as lm_head and the embeddings of the language models)
LINEAR_TAGS = (
    "attention.query",
    "attention.key",
    "attention.value",
    "attention.dense",
    "mlp.fc1",
    "mlp.fc2",
)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_channels: int = 3
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    layer_norm_eps: float = 1e-12
    num_labels: int = 1000

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim_(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def from_hf(cls, hf: dict) -> "ViTConfig":
        return cls(
            image_size=hf.get("image_size", 224),
            patch_size=hf.get("patch_size", 16),
            num_channels=hf.get("num_channels", 3),
            hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"],
            num_hidden_layers=hf["num_hidden_layers"],
            num_attention_heads=hf["num_attention_heads"],
            layer_norm_eps=hf.get("layer_norm_eps", 1e-12),
            num_labels=len(hf.get("id2label", {})) or 1000,
        )

    @classmethod
    def tiny(cls) -> "ViTConfig":
        return cls(image_size=32, patch_size=8, hidden_size=64, intermediate_size=128,
                   num_hidden_layers=2, num_attention_heads=4, num_labels=10)


def init_params(cfg: ViTConfig, generator: Optional[torch.Generator] = None,
                dtype=torch.float32, device="cuda") -> dict:
    """A random tree in `hqq_tpu`'s layout: linears N(0, 1/in) with zero
    biases, LayerNorms weight one and bias zero, the position embeddings
    N(0, 0.02^2), a zero CLS token; drawn in fp32 from ``generator`` (seed 0
    on ``device`` when None), cast to ``dtype``."""
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    d, f = cfg.hidden_size, cfg.intermediate_size

    def randn(*shape):
        return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)

    def lin(o, i):
        return Linear((randn(o, i) / math.sqrt(i)).to(dtype),
                      torch.zeros((o,), dtype=dtype, device=device))

    def ln(n):
        return {"weight": torch.ones((n,), dtype=dtype, device=device),
                "bias": torch.zeros((n,), dtype=dtype, device=device)}

    layers = [{"layernorm_before": ln(d),
               "attention": {"query": lin(d, d), "key": lin(d, d), "value": lin(d, d),
                             "dense": lin(d, d)},
               "layernorm_after": ln(d),
               "mlp": {"fc1": lin(f, d), "fc2": lin(d, f)}}
              for _ in range(cfg.num_hidden_layers)]
    return {
        "cls_token": torch.zeros((1, 1, d), dtype=dtype, device=device),
        "position_embeddings": (randn(1, cfg.num_patches + 1, d) * 0.02).to(dtype),
        "patch_proj": lin(d, cfg.num_channels * cfg.patch_size ** 2),
        "layers": layers,
        "layernorm": ln(d),
        "classifier": lin(cfg.num_labels, d),
    }


def _attention(layer: dict, cfg: ViTConfig, x: torch.Tensor) -> torch.Tensor:
    """Non-causal attention over the image's rows: the scores in fp32,
    divided by sqrt(hd), softmax, the probabilities in q's type times v,
    then ``dense``."""
    b, t, d = x.shape
    nh, hd = cfg.num_attention_heads, cfg.head_dim_

    def heads(name):
        return layer[name](x).reshape(b, t, nh, hd).transpose(1, 2)

    q, k, v = heads("query"), heads("key"), heads("value")
    scores = (q.to(torch.float32) @ k.to(torch.float32).transpose(-1, -2)) / math.sqrt(hd)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return layer["dense"]((probs @ v).transpose(1, 2).reshape(b, t, d))


def forward(params: dict, cfg: ViTConfig, pixels: torch.Tensor,
            pool: str = "cls") -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, C, H, W] pixels -> (logits [B, num_labels], hidden [B, N + 1,
    D]): the final LayerNorm's rows, pooled by the CLS row ("cls") or the
    mean over the rows (any other ``pool``, as in `hqq_tpu`), through the
    classifier; where the tree has no classifier the pooled rows stand for
    the logits."""
    b = pixels.shape[0]
    cls_token = params["cls_token"]
    patches = _patchify(pixels.to(torch.float32), cfg.patch_size).to(cls_token.dtype)
    x = params["patch_proj"](patches)
    x = torch.cat([cls_token.expand(b, 1, cfg.hidden_size), x], dim=1) + params[
        "position_embeddings"]

    eps = cfg.layer_norm_eps
    for layer in params["layers"]:
        h = layer_norm(x, layer["layernorm_before"], eps)
        x = x + _attention(layer["attention"], cfg, h)
        h = layer_norm(x, layer["layernorm_after"], eps)
        x = x + layer["mlp"]["fc2"](F.gelu(layer["mlp"]["fc1"](h)))

    x = layer_norm(x, params["layernorm"], eps)
    pooled = x[:, 0] if pool == "cls" else x.mean(dim=1)
    head = params.get("classifier")
    return (pooled if head is None else head(pooled)), x


def params_from_hf_state_dict(state: Dict[str, torch.Tensor], cfg: ViTConfig,
                              dtype=torch.float32) -> dict:
    """The tree of an HF ``ViTForImageClassification`` (or ``ViTModel``)
    state dict, its names with or without the ``vit.`` prefix; the patch
    convolution's weight flattened over (c, ph, pw); ``classifier`` None
    where the state has no head."""

    def arr(name):
        return state[name].to(dtype)

    def lin(prefix):
        b = f"{prefix}.bias"
        return Linear(arr(f"{prefix}.weight"), arr(b) if b in state else None)

    def ln(prefix):
        return {"weight": arr(f"{prefix}.weight"), "bias": arr(f"{prefix}.bias")}

    pre = "vit." if any(k.startswith("vit.") for k in state) else ""
    layers = []
    for i in range(cfg.num_hidden_layers):
        p = f"{pre}encoder.layer.{i}"
        layers.append({
            "layernorm_before": ln(f"{p}.layernorm_before"),
            "attention": {"query": lin(f"{p}.attention.attention.query"),
                          "key": lin(f"{p}.attention.attention.key"),
                          "value": lin(f"{p}.attention.attention.value"),
                          "dense": lin(f"{p}.attention.output.dense")},
            "layernorm_after": ln(f"{p}.layernorm_after"),
            "mlp": {"fc1": lin(f"{p}.intermediate.dense"), "fc2": lin(f"{p}.output.dense")},
        })
    conv_w = arr(f"{pre}embeddings.patch_embeddings.projection.weight")
    return {
        "cls_token": arr(f"{pre}embeddings.cls_token"),
        "position_embeddings": arr(f"{pre}embeddings.position_embeddings"),
        "patch_proj": Linear(conv_w.reshape(conv_w.shape[0], -1),
                             arr(f"{pre}embeddings.patch_embeddings.projection.bias")),
        "layers": layers,
        "layernorm": ln(f"{pre}layernorm"),
        "classifier": lin("classifier") if "classifier.weight" in state else None,
    }
