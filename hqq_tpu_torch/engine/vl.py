# SPDX-License-Identifier: Apache-2.0
"""Vision-language models: quantize, save, load, encode images and
generate, for LLaVA, Qwen2-VL and Aria.

Mirrors `hqq_tpu.engine.vl`. A model is two parameter trees, ``{"text",
"vision"}`` (LLaVA's and Aria's vision trees are ``{"vision",
"projector"}``), with the same save and load contract as the text engine
(`engine.hf`): checkpoints are `hqq_tpu`'s format, the config under
``vl_config``, so either package loads the other's. The whole pipeline
runs on this package's parts: the vision tower, the projector or patch
merger, the image rows spliced over the placeholders, a prefill over the
embeddings (M-RoPE positions for Qwen2-VL, sequential ones for LLaVA and
Aria), then decode a token at a time.

`quantize_model` quantizes both towers and keeps the patch embedding and
the projector or merger in full precision (`_VISION_FP`); Aria's goes
through `models.aria.quantize_aria`: the attention, the shared experts and
the expert stacks, while the router, lm_head, the whole tower and the
projector stay in full precision. `prepare_for_inference` puts the vision
tree on "pallas" when the text tree goes to "w4a8" or "int8": the tower
runs once a request at prefill width, the bf16-operand kernel's work.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional

import numpy as np
import torch

from ..core.quantize import BaseQuantizeConfig
from ..models import base as model_base
from ..models import hf as hf_loader
from ..models import aria, llama, llava, qwen2_vl

__all__ = ["HQQVLModel", "AutoHQQVLModel"]

_VL_REGISTRY = {"qwen2_vl": qwen2_vl, "llava": llava, "aria": aria}

# vision-tree leaves that stay in full precision under quantize_model (Aria's
# whole tower and projector do: `aria.quantize_aria` leaves them alone)
_VISION_FP = {
    "qwen2_vl": ("patch_embed", "merger_fc1", "merger_fc2"),
    "llava": llava.VISION_FP_TAGS,
}

_CONFIGS = {"qwen2_vl": qwen2_vl.Qwen2VLConfig, "llava": llava.LlavaConfig,
            "aria": aria.AriaConfig}


def _refuse_unknown(model_type: str) -> None:
    if model_type not in _VL_REGISTRY:
        raise ValueError(f"VL architecture {model_type!r} not supported; available: "
                         f"{list(_VL_REGISTRY)}")


def _cfg_from_dict(d: dict, model_type: str):
    """The config a checkpoint's ``vl_config`` describes (JSON turns the
    tuples into lists; `llama.LlamaConfig` takes rope_scaling as a list,
    `aria.AriaConfig` patch_to_query as lists of pairs)."""
    _refuse_unknown(model_type)
    rest = {k: v for k, v in d.items() if k not in ("text", "vision")}
    if model_type == "aria":
        return aria.AriaConfig(text=aria.AriaTextConfig(**d["text"]),
                               vision=aria.IdeficsVisionConfig(**d["vision"]), **rest)
    text = llama.LlamaConfig(**d["text"])
    if model_type == "llava":
        return llava.LlavaConfig(text=text, vision=llava.ClipVisionConfig(**d["vision"]), **rest)
    if "mrope_section" in rest:
        rest["mrope_section"] = tuple(rest["mrope_section"])
    return qwen2_vl.Qwen2VLConfig(text=text, vision=qwen2_vl.VisionConfig(**d["vision"]), **rest)


def _tree_device(tree) -> torch.device:
    return tree["embed_tokens"].device


@dataclasses.dataclass
class HQQVLModel:
    """``params = {"text", "vision"}``; for LLaVA and Aria the vision tree
    is ``{"vision", "projector"}``."""

    params: Any
    cfg: Any
    model_type: str = "qwen2_vl"
    quantized: bool = False

    def __post_init__(self):
        _refuse_unknown(self.model_type)

    @property
    def device(self) -> torch.device:
        return _tree_device(self.params["text"])

    # -- quantization --------------------------------------------------------
    def quantize_model(self, quant_config: Optional[dict] = None,
                       vision_config: Optional[dict] = None,
                       compute_dtype=None) -> "HQQVLModel":
        """Quantize both towers, in place: ``quant_config`` the text model,
        ``vision_config`` (the same when None) the vision blocks; the patch
        embedding and the projector or merger stay in full precision. Aria:
        `aria.quantize_aria` with ``quant_config`` for the attention, the
        shared experts and the expert stacks; its tower and projector stay
        in full precision."""
        if self.quantized:
            raise RuntimeError("model is already quantized")
        qc = quant_config or BaseQuantizeConfig()
        if self.model_type == "aria":
            full = aria.quantize_aria({"text": self.params["text"], **self.params["vision"]},
                                      attn_config=qc, expert_config=qc,
                                      compute_dtype=compute_dtype or torch.bfloat16)
            self.params = {"text": full["text"],
                           "vision": {"vision": full["vision"], "projector": full["projector"]}}
            self.quantized = True
            return self
        self.params = {
            "text": model_base.quantize_model(self.params["text"], qc, compute_dtype),
            "vision": model_base.quantize_model(self.params["vision"], vision_config or qc,
                                                compute_dtype,
                                                ignore=_VISION_FP[self.model_type]),
        }
        self.quantized = True
        return self

    def prepare_for_inference(self, backend: str = "pallas") -> "HQQVLModel":
        """The text tree on ``backend``; the vision tree on "pallas" where
        the text goes to "w4a8" or "int8" (the tower's rows are a prefill,
        never a decode), else on ``backend`` too."""
        from ..utils.patching import prepare_for_inference

        self.params = {
            "text": prepare_for_inference(self.params["text"], backend),
            "vision": prepare_for_inference(
                self.params["vision"], "pallas" if backend in ("w4a8", "int8") else backend),
        }
        return self

    # -- persistence ---------------------------------------------------------
    def save_quantized(self, save_dir: str) -> None:
        """Write both trees and ``{"model_type", "vl_config"}`` (before
        `prepare_for_inference`: kernel layouts are not saved)."""
        if not self.quantized:
            raise RuntimeError("quantize_model() first")
        model_base.save_quantized(self.params, save_dir, config={
            "model_type": self.model_type, "vl_config": dataclasses.asdict(self.cfg)})

    # -- inference -----------------------------------------------------------
    def encode_images(self, pixel_values: torch.Tensor, grid_thw=None) -> torch.Tensor:
        """The image rows [n, text hidden]: LLaVA and Aria take pixels [B, C,
        H, W], Qwen2-VL patch rows [sum of t*h*w, patch_dim] and
        ``grid_thw``."""
        if self.model_type in ("llava", "aria"):
            out = _VL_REGISTRY[self.model_type].vision_forward(self.params["vision"], self.cfg,
                                                               pixel_values)
            return out.reshape(-1, self.cfg.text.hidden_size)
        return qwen2_vl.vision_forward(self.params["vision"], self.cfg.vision, pixel_values,
                                       grid_thw)

    def embed(self, input_ids, pixel_values, grid_thw=None):
        """(inputs_embeds [1, T, D], M-RoPE position ids [3, 1, T] or None)
        of one prompt with its images: the tower, then the splice."""
        toks = torch.as_tensor(np.asarray(input_ids, np.int64).reshape(1, -1),
                               device=self.device)
        img = self.encode_images(pixel_values, grid_thw)
        if self.model_type in ("llava", "aria"):
            mod = _VL_REGISTRY[self.model_type]
            return mod.embed_multimodal(self.params, self.cfg, toks, img), None
        emb = qwen2_vl.embed_multimodal(self.params["text"], self.cfg, toks, img)
        pos = qwen2_vl.get_mrope_positions(self.cfg, toks[0].cpu().numpy(), grid_thw)
        return emb, pos

    def _forward(self, *args, **kw):
        if self.model_type == "llava":
            return llama.forward(self.params["text"], self.cfg.text, *args, **kw)
        if self.model_type == "aria":
            return aria.forward(self.params["text"], self.cfg, *args, **kw)
        return qwen2_vl.forward(self.params["text"], self.cfg, *args, **kw)

    @torch.inference_mode()
    def generate(self, input_ids, pixel_values=None, grid_thw=None, max_new_tokens: int = 32,
                 do_sample: bool = False, temperature: float = 1.0, seed: int = 0,
                 eos_token_id: Optional[int] = None, max_len: Optional[int] = None) -> list:
        """Image-conditioned generation of one sequence: the tower, the
        splice, a prefill over the embeddings (M-RoPE positions for
        Qwen2-VL, sequential for LLaVA and Aria), then one decode step a
        token. Text only when ``pixel_values`` is None. Greedy, or sampling
        from the softmax of logits / temperature with a generator seeded by
        ``seed``."""
        cfg = self.cfg
        dev = self.device
        toks = np.asarray(input_ids, np.int64).reshape(1, -1)
        t0 = toks.shape[1]
        text = self.params["text"]
        n = max_len or 1 << int(np.ceil(np.log2(t0 + max_new_tokens + 1)))
        cache = llama.init_cache(cfg.text, 1, n, text["norm"].dtype, dev)
        ids = torch.from_numpy(toks).to(dev)
        mp = t0
        if pixel_values is not None:
            emb, pos = self.embed(toks, pixel_values, grid_thw)
            if pos is None:
                logits, cache = self._forward(None, cache, 0, inputs_embeds=emb)
            else:
                logits, cache = self._forward(None, cache, 0,
                                              position_ids=torch.from_numpy(pos).to(dev),
                                              inputs_embeds=emb)
                mp = int(pos.max()) + 1
        else:
            logits, cache = self._forward(ids, cache, 0)
        gen = torch.Generator(device=dev).manual_seed(seed)

        def pick(lg):
            if do_sample:
                probs = torch.softmax(lg.to(torch.float32) / temperature, dim=-1)
                return int(torch.multinomial(probs, 1, generator=gen))
            return int(torch.argmax(lg))

        out = [pick(logits[0, -1])]
        p = t0
        for _ in range(max_new_tokens - 1):
            if eos_token_id is not None and out[-1] == eos_token_id:
                break
            tok = torch.tensor([[out[-1]]], device=dev)
            if self.model_type != "qwen2_vl":
                logits, cache = self._forward(tok, cache, p)
            else:
                pid = torch.full((3, 1, 1), mp, device=dev)
                logits, cache = self._forward(tok, cache, p, position_ids=pid)
            out.append(pick(logits[0, -1]))
            p += 1
            mp += 1
        return out


class AutoHQQVLModel:
    """`from_pretrained` (a local HF directory) and `from_quantized` (a
    checkpoint of either package) for VL models."""

    @classmethod
    def from_pretrained(cls, model_dir: str, compute_dtype=torch.bfloat16,
                        device="cuda") -> HQQVLModel:
        with open(os.path.join(model_dir, "config.json")) as f:
            hf_cfg = json.load(f)
        model_type = hf_cfg.get("model_type", "qwen2_vl")
        _refuse_unknown(model_type)
        mod = _VL_REGISTRY[model_type]
        cfg = _CONFIGS[model_type].from_hf(hf_cfg)
        state = hf_loader.read_hf_state(model_dir, compute_dtype, device)
        text, vision = mod.params_from_hf_state_dict(state, cfg, compute_dtype)
        return HQQVLModel(params={"text": text, "vision": vision}, cfg=cfg,
                          model_type=model_type)

    @classmethod
    def from_quantized(cls, save_dir: str, device="cuda") -> HQQVLModel:
        params, config = model_base.from_quantized(save_dir, device=device)
        model_type = config.get("model_type", "qwen2_vl")
        return HQQVLModel(params=params, cfg=_cfg_from_dict(config["vl_config"], model_type),
                          model_type=model_type, quantized=True)
