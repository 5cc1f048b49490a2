# SPDX-License-Identifier: Apache-2.0
"""Vision models: quantize, save and load ViT-class models, and run them.

Mirrors `hqq_tpu.engine.vision` (HQQ's ``HQQtimm`` role) over the ViT of
`models.vit`. Checkpoints are `hqq_tpu`'s format, the config under
``hf_config``, so either package loads the other's. `quantize_model` keeps
the patch projection and the classifier in full precision (as lm_head in
the language models); after `prepare_for_inference("pallas")` the linears
run the bf16-operand kernel for bf16 activations and its fp32 route
(`qmm_fp32`) for fp32 ones, fp32 being the default compute type of
`AutoHQQVisionModel.from_pretrained`, as in `hqq_tpu`.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional

import torch

from ..core.quantize import BaseQuantizeConfig
from ..models import base as model_base
from ..models import hf as hf_loader
from ..models import vit as vit_mod

__all__ = ["HQQVisionModel", "AutoHQQVisionModel", "HQQtimm"]

_VISION_REGISTRY = {
    "vit": {
        "config": vit_mod.ViTConfig.from_hf,
        "config_cls": vit_mod.ViTConfig,
        "forward": vit_mod.forward,
        "loader": vit_mod.params_from_hf_state_dict,
    },
}


def _arch(model_type: str) -> dict:
    arch = _VISION_REGISTRY.get(model_type)
    if arch is None:
        raise ValueError(f"vision architecture {model_type!r} not supported; available: "
                         f"{list(_VISION_REGISTRY)}")
    return arch


@dataclasses.dataclass
class HQQVisionModel:
    params: Any
    cfg: Any
    model_type: str = "vit"
    quantized: bool = False

    def quantize_model(self, quant_config: Optional[dict] = None,
                       compute_dtype=None) -> "HQQVisionModel":
        """Quantize every linear but the patch projection and the
        classifier, in place."""
        if self.quantized:
            raise RuntimeError("model is already quantized")
        self.params = model_base.quantize_model(self.params, quant_config or BaseQuantizeConfig(),
                                                compute_dtype,
                                                ignore=("patch_proj", "classifier", "lm_head"))
        self.quantized = True
        return self

    def prepare_for_inference(self, backend: str = "pallas") -> "HQQVisionModel":
        from ..utils.patching import prepare_for_inference

        self.params = prepare_for_inference(self.params, backend)
        return self

    def save_quantized(self, save_dir: str) -> None:
        """Write the tree and ``{"model_type", "hf_config"}`` (before
        `prepare_for_inference`: kernel layouts are not saved)."""
        if not self.quantized:
            raise RuntimeError("quantize_model() first")
        model_base.save_quantized(self.params, save_dir, config={
            "model_type": self.model_type, "hf_config": dataclasses.asdict(self.cfg)})

    def forward(self, pixels: torch.Tensor, pool: str = "cls"):
        """(logits, hidden) of pixels [B, C, H, W] (`models.vit.forward`)."""
        return _arch(self.model_type)["forward"](self.params, self.cfg, pixels, pool)

    __call__ = forward


class AutoHQQVisionModel:
    """`from_pretrained` (a local HF directory) and `from_quantized` (a
    checkpoint of either package) for vision models."""

    @classmethod
    def from_pretrained(cls, model_dir: str, compute_dtype=torch.float32,
                        device="cuda") -> HQQVisionModel:
        with open(os.path.join(model_dir, "config.json")) as f:
            hf_cfg = json.load(f)
        model_type = hf_cfg.get("model_type", "vit")
        arch = _arch(model_type)
        cfg = arch["config"](hf_cfg)
        state = hf_loader.read_hf_state(model_dir, compute_dtype, device)
        return HQQVisionModel(params=arch["loader"](state, cfg, compute_dtype), cfg=cfg,
                              model_type=model_type)

    @classmethod
    def from_quantized(cls, save_dir: str, device="cuda") -> HQQVisionModel:
        params, config = model_base.from_quantized(save_dir, device=device)
        model_type = config.get("model_type", "vit")
        cfg = _arch(model_type)["config_cls"](**config.get("hf_config", {}))
        return HQQVisionModel(params=params, cfg=cfg, model_type=model_type, quantized=True)


# the reference HQQ's class name
HQQtimm = AutoHQQVisionModel
