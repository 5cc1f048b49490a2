# SPDX-License-Identifier: Apache-2.0
"""User-facing model: quantize, prepare and generate.

Mirrors `hqq_tpu.engine.hf` (`register_arch` and `HQQModel`). The registry
maps an HF ``model_type`` to its config builder and forward function; this
slice registers llama. Loading HF checkpoints and saving or loading
quantized models come with the serialization slice.

    model = HQQModel(init_params(LlamaConfig.llama2_7b()), LlamaConfig.llama2_7b())
    model.quantize_model(BaseQuantizeConfig(nbits=4, group_size=64))
    model.prepare_for_inference(backend="w4a8")
    ids = model.generate(prompt_ids, max_new_tokens=128)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from ..core.quantize import BaseQuantizeConfig
from ..models import base as model_base
from ..models import llama
from ..serving.generate import Generator

__all__ = ["HQQModel", "register_arch"]

# model_type -> {"config": from_hf builder, "forward": forward fn}
_HQQ_REGISTRY: Dict[str, dict] = {
    "llama": {"config": llama.LlamaConfig.from_hf, "forward": llama.forward},
}


def register_arch(model_type: str, config, forward) -> None:
    """Add an architecture to the registry."""
    _HQQ_REGISTRY[model_type] = {"config": config, "forward": forward}


@dataclasses.dataclass
class HQQModel:
    """A parameter tree with its config. Generation runs on the device of
    the parameters."""

    params: Any
    cfg: Any
    model_type: str = "llama"
    quantized: bool = False

    @property
    def _arch(self) -> dict:
        return _HQQ_REGISTRY[self.model_type]

    @property
    def device(self):
        return self.params["embed_tokens"].device

    def quantize_model(self, quant_config: Optional[dict] = None,
                       compute_dtype=None) -> "HQQModel":
        """Quantize every linear but lm_head, layer by layer, in place."""
        if self.quantized:
            raise RuntimeError("model is already quantized")
        self.params = model_base.quantize_model(
            self.params, quant_config or BaseQuantizeConfig(), compute_dtype
        )
        self.quantized = True
        return self

    def prepare_for_inference(self, backend: str = "pallas") -> "HQQModel":
        """Swap to a fused backend ("w4a8" is the decode path)."""
        from ..utils.patching import prepare_for_inference

        self.params = prepare_for_inference(self.params, backend)
        return self

    def forward(self, tokens, cache=None, start_pos=0):
        return self._arch["forward"](self.params, self.cfg, tokens, cache, start_pos)

    def generate(self, input_ids, max_new_tokens: int = 128, **kw):
        kw.setdefault("device", self.device)
        seed = kw.pop("seed", 0)
        gen = Generator(
            self.params,
            self.cfg,
            forward_fn=lambda p, t, c, s: self._arch["forward"](p, self.cfg, t, c, s),
            **kw,
        )
        return gen.generate(input_ids, max_new_tokens=max_new_tokens, seed=seed)
