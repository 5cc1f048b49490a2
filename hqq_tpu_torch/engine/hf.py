# SPDX-License-Identifier: Apache-2.0
"""User-facing model: load, quantize, save, prepare and generate.

Mirrors `hqq_tpu.engine.hf` (`register_arch`, `HQQModel`,
`HQQModelForCausalLM`, `AutoHQQHFModel`). The registry maps an HF
``model_type`` to its config constructor, forward function and HF state-dict
loader; llama, Qwen2/Qwen3 on the llama walk, the RMSNorm families
(mistral, granite, gemma, gemma2, gemma3_text, phi3, olmo2), the
LayerNorm families (starcoder2, phi, cohere, gpt2, bloom, falcon) and the
MoE families (mixtral, qwen3_moe, gpt_oss, deepseek_v3) are registered.
`quantize_model` quantizes every `Linear` but lm_head, as `hqq_tpu`'s does:
on an MoE tree that is the attention and the routers (DeepSeek-V3's router
is an fp32 array, which stays so), the expert stacks stay dense; the
families' own `quantize_mixtral`, `quantize_qwen3_moe` and
`quantize_gpt_oss` quantize the experts and keep the router, and
DeepSeek-V3's experts quantize with `nn.moe.quantize_experts`, as in
`hqq_tpu`, which has no quantizer of its own for it. The README's
quick start runs as it does in `hqq_tpu`:

    model = HQQModelForCausalLM.from_pretrained(local_dir)      # bf16, on cuda
    model.quantize_model(BaseQuantizeConfig(nbits=4, group_size=64))
    model.save_quantized(out_dir)
    model = HQQModelForCausalLM.from_quantized(out_dir)
    model.prepare_for_inference(backend="w4a8")
    ids = model.generate(prompt_ids, max_new_tokens=128)

Checkpoints are `hqq_tpu`'s format (`models.serialize`): the sidecar's
``config_class`` names `hqq_tpu`'s config class, as `hqq_tpu` writes it, and
loading builds the config from this package's registry entry for the
model type, never by importing the class the file names.

`HQQModel` keeps one `Generator` per set of generate arguments, so that
its decode graphs (`serving.generate`, ``compile_mode="full"``) are
captured once and replayed by later calls. Each call hands the generator
the current ``params``, and the generator captures anew when the tree it
reads has changed (an adapter added, merged or loaded, ``params`` set
anew); `quantize_model`, `prepare_for_inference` and `release_graphs`
drop the kept generators with their graphs and buffers.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

import torch

from ..core.quantize import BaseQuantizeConfig
from ..models import base as model_base
from ..models import hf as hf_loader
from ..models import llama
from ..serving.generate import Generator

__all__ = ["HQQModel", "HQQModelForCausalLM", "AutoHQQHFModel", "register_arch"]


def _llama_entry() -> dict:
    return {"config_cls": llama.LlamaConfig, "forward": llama.forward,
            "loader": hf_loader.params_from_hf_state_dict}


# model_type -> {"config_cls": config dataclass, "forward": forward fn,
# "loader": HF state dict -> parameter tree}; Qwen2 (attention biases)
# and Qwen3 (per-head q/k norms) are Llama-shaped, as in hqq_tpu
_HQQ_REGISTRY: Dict[str, dict] = {t: _llama_entry() for t in ("llama", "qwen2", "qwen3")}


def _register_rmsnorm_families() -> None:
    """The RMSNorm families on the llama walk, with the loaders `hqq_tpu`
    names: the Llama loader for Mistral, Granite and Gemma, their own for
    Gemma-2, Gemma-3, Phi-3 and OLMo-2."""
    from ..models import gemma, gemma2, gemma3, granite, mistral, olmo2, phi3

    llama_loader = hf_loader.params_from_hf_state_dict
    for model_type, module, config_cls, loader in (
        ("mistral", mistral, mistral.MistralConfig, llama_loader),
        ("granite", granite, granite.GraniteConfig, llama_loader),
        ("gemma", gemma, gemma.GemmaConfig, llama_loader),
        ("gemma2", gemma2, gemma2.Gemma2Config, gemma2.params_from_hf_state_dict),
        ("gemma3_text", gemma3, gemma3.Gemma3Config, gemma3.params_from_hf_state_dict),
        ("phi3", phi3, phi3.Phi3Config, phi3.params_from_hf_state_dict),
        ("olmo2", olmo2, olmo2.Olmo2Config, olmo2.params_from_hf_state_dict),
    ):
        _HQQ_REGISTRY[model_type] = {"config_cls": config_cls, "forward": module.forward,
                                     "loader": loader}


_register_rmsnorm_families()


def _register_layernorm_families() -> None:
    """The LayerNorm families, each with its own loader, as `hqq_tpu`
    registers them: StarCoder2, Phi (Phi-2), Cohere, GPT-2, BLOOM and
    Falcon."""
    from ..models import bloom, cohere, falcon, gpt2, phi, starcoder2

    for model_type, module, config_cls in (
        ("starcoder2", starcoder2, starcoder2.Starcoder2Config),
        ("phi", phi, phi.PhiConfig),
        ("cohere", cohere, cohere.CohereConfig),
        ("gpt2", gpt2, gpt2.GPT2Config),
        ("bloom", bloom, bloom.BloomConfig),
        ("falcon", falcon, falcon.FalconConfig),
    ):
        _HQQ_REGISTRY[model_type] = {"config_cls": config_cls, "forward": module.forward,
                                     "loader": module.params_from_hf_state_dict}


_register_layernorm_families()


def _register_moe_families() -> None:
    """The MoE families, each with its own loader, as `hqq_tpu` registers
    them: Mixtral, Qwen3-MoE, gpt-oss and DeepSeek-V3."""
    from ..models import deepseek3, gpt_oss, mixtral, qwen3_moe

    for model_type, module, config_cls in (
        ("mixtral", mixtral, mixtral.MixtralConfig),
        ("qwen3_moe", qwen3_moe, qwen3_moe.Qwen3MoeConfig),
        ("gpt_oss", gpt_oss, gpt_oss.GptOssConfig),
        ("deepseek_v3", deepseek3, deepseek3.DeepseekV3Config),
    ):
        _HQQ_REGISTRY[model_type] = {"config_cls": config_cls, "forward": module.forward,
                                     "loader": module.params_from_hf_state_dict}


_register_moe_families()


def register_arch(model_type: str, config_cls, forward, loader) -> None:
    """Add an architecture to the registry. ``config_cls`` is the config
    dataclass: ``config_cls.from_hf(hf_config_dict)`` builds it from an HF
    ``config.json``, and ``config_cls(**fields)`` from a checkpoint's
    sidecar."""
    _HQQ_REGISTRY[model_type] = {"config_cls": config_cls, "forward": forward, "loader": loader}


def _lookup_arch(model_type: str) -> dict:
    if model_type not in _HQQ_REGISTRY:
        raise ValueError(f"architecture {model_type!r} not supported; available: "
                         f"{list(_HQQ_REGISTRY)}")
    return _HQQ_REGISTRY[model_type]


def _config_class_name(cfg) -> str:
    """The config's class as `hqq_tpu` names it in the sidecar: this
    package's modules mirror `hqq_tpu`'s, so ``hqq_tpu_torch.models.llama``
    is written ``hqq_tpu.models.llama``."""
    cls = type(cfg)
    module = cls.__module__
    if module.startswith("hqq_tpu_torch."):
        module = "hqq_tpu." + module.removeprefix("hqq_tpu_torch.")
    return f"{module}.{cls.__qualname__}"


@dataclasses.dataclass
class HQQModel:
    """A parameter tree with its config. Generation runs on the device of
    the parameters."""

    params: Any
    cfg: Any
    model_type: str = "llama"
    quantized: bool = False
    _generators: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                          compare=False)

    @property
    def _arch(self) -> dict:
        return _lookup_arch(self.model_type)

    @property
    def device(self):
        """The device of the token embedding (``embed_tokens``; Falcon's and
        BLOOM's ``word_embeddings``, GPT-2's ``wte``)."""
        for name in ("embed_tokens", "word_embeddings", "wte"):
            if name in self.params:
                return self.params[name].device
        raise KeyError("the parameter tree holds no token embedding")

    def quantize_model(self, quant_config: Optional[dict] = None,
                       compute_dtype=None) -> "HQQModel":
        """Quantize every linear but lm_head, layer by layer, in place."""
        if self.quantized:
            raise RuntimeError("model is already quantized")
        self.release_graphs()
        self.params = model_base.quantize_model(
            self.params, quant_config or BaseQuantizeConfig(), compute_dtype
        )
        self.quantized = True
        return self

    def prepare_for_inference(self, backend: str = "pallas") -> "HQQModel":
        """Swap to a fused backend ("w4a8" is the decode path)."""
        from ..utils.patching import prepare_for_inference

        self.release_graphs()
        self.params = prepare_for_inference(self.params, backend)
        return self

    def save_quantized(self, save_dir: str) -> None:
        """Write the quantized model to ``save_dir`` (before
        `prepare_for_inference`: kernel layouts are not saved)."""
        if not self.quantized:
            raise RuntimeError("quantize_model() first")
        model_base.save_quantized(self.params, save_dir, config={
            "model_type": self.model_type,
            "hf_config": dataclasses.asdict(self.cfg),
            "config_class": _config_class_name(self.cfg),
        })

    def forward(self, tokens, cache=None, start_pos=0):
        return self._arch["forward"](self.params, self.cfg, tokens, cache, start_pos)

    def release_graphs(self) -> None:
        """Drop the kept generators with their decode graphs and buffers."""
        self._generators.clear()

    def generator(self, **kw) -> Generator:
        """The kept `Generator` for these arguments (``device`` defaults to
        the parameters'), made on first use, reading the current
        ``params``."""
        kw.setdefault("device", self.device)
        key = tuple(sorted(kw.items()))
        if key not in self._generators:
            forward = self._arch["forward"]
            self._generators[key] = Generator(
                self.params, self.cfg,
                forward_fn=lambda p, t, c, s: forward(p, self.cfg, t, c, s), **kw)
        gen = self._generators[key]
        gen.params = self.params
        return gen

    def generate(self, input_ids, max_new_tokens: int = 128, seed: int = 0, on_token=None,
                 **kw):
        """Generate with the kept `Generator` of ``kw`` (see `Generator`)."""
        return self.generator(**kw).generate(input_ids, max_new_tokens=max_new_tokens,
                                             seed=seed, on_token=on_token)


class HQQModelForCausalLM:
    """Class-method facade with the reference engine's API."""

    @classmethod
    def from_pretrained(cls, model_dir: str, compute_dtype=torch.bfloat16,
                        device="cuda") -> HQQModel:
        """A local HF directory as an unquantized `HQQModel` on ``device``."""
        with open(os.path.join(model_dir, "config.json")) as f:
            hf_cfg = json.load(f)
        model_type = hf_cfg.get("model_type", "llama")
        arch = _lookup_arch(model_type)
        cfg = arch["config_cls"].from_hf(hf_cfg)
        params = arch["loader"](hf_loader.read_hf_state(model_dir, compute_dtype, device), cfg,
                                compute_dtype)
        return HQQModel(params=params, cfg=cfg, model_type=model_type)

    @classmethod
    def from_quantized(cls, save_dir: str, device="cuda") -> HQQModel:
        """A checkpoint of `save_quantized` (this package's or `hqq_tpu`'s)
        as a quantized `HQQModel` on ``device``."""
        params, config = model_base.from_quantized(save_dir, device=device)
        model_type = config.get("model_type", "llama")
        arch = _lookup_arch(model_type)
        cfg = arch["config_cls"](**config.get("hf_config", {}))
        return HQQModel(params=params, cfg=cfg, model_type=model_type, quantized=True)

    @staticmethod
    def quantize_model_(model: HQQModel, quant_config=None, compute_dtype=None) -> HQQModel:
        return model.quantize_model(quant_config, compute_dtype)

    @staticmethod
    def save_quantized_(model: HQQModel, save_dir: str) -> None:
        model.save_quantized(save_dir)


AutoHQQHFModel = HQQModelForCausalLM
