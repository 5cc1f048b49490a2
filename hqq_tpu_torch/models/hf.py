# SPDX-License-Identifier: Apache-2.0
"""Hugging Face checkpoints of the Llama family, read into a parameter tree.

Mirrors `hqq_tpu.models.hf`. A local directory laid out as HF saves a
Llama/Mistral/Qwen model (``config.json``, ``*.safetensors`` and, when
sharded, ``model.safetensors.index.json``) is read shard by shard with this
package's own safetensors reader; neither ``transformers`` nor
``safetensors`` is needed. Each tensor goes to ``device`` as it is read.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch

from ..nn.linear import Linear
from ._safetensors import load_file
from .llama import LlamaConfig

__all__ = ["load_hf_llama", "params_from_hf_state_dict", "read_hf_config", "read_hf_state"]


def read_hf_config(model_dir: str) -> LlamaConfig:
    with open(os.path.join(model_dir, "config.json")) as f:
        return LlamaConfig.from_hf(json.load(f))


def _iter_hf_shards(model_dir: str, device="cpu"):
    """Each safetensors file of ``model_dir`` as {name: tensor on device},
    one file at a time: those the index names, else every one there."""
    index_path = os.path.join(model_dir, "model.safetensors.index.json")
    if os.path.exists(index_path):
        with open(index_path) as f:
            files = sorted(set(json.load(f)["weight_map"].values()))
    else:
        files = sorted(f for f in os.listdir(model_dir) if f.endswith(".safetensors"))
    for fname in files:
        yield load_file(os.path.join(model_dir, fname), device)


def params_from_hf_state_dict(state: Dict[str, torch.Tensor], cfg: LlamaConfig,
                              dtype=torch.bfloat16) -> dict:
    """A flat HF Llama state dict (name -> tensor) as the parameter tree of
    `models.llama.forward`, every tensor in ``dtype`` on its own device.
    Qwen3's per-head ``q_norm``/``k_norm`` come along when present; biases
    wherever the checkpoint has them."""

    def arr(name):
        return state[name].to(dtype)

    def lin(prefix):
        bias = prefix + ".bias"
        return Linear(arr(prefix + ".weight"), arr(bias) if bias in state else None)

    layers = []
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}"
        sa = {name: lin(f"{p}.self_attn.{name}") for name in ("q_proj", "k_proj", "v_proj",
                                                               "o_proj")}
        if f"{p}.self_attn.q_norm.weight" in state:
            sa["q_norm"] = arr(f"{p}.self_attn.q_norm.weight")
            sa["k_norm"] = arr(f"{p}.self_attn.k_norm.weight")
        layers.append({
            "self_attn": sa,
            "mlp": {name: lin(f"{p}.mlp.{name}") for name in ("gate_proj", "up_proj",
                                                               "down_proj")},
            "input_layernorm": arr(f"{p}.input_layernorm.weight"),
            "post_attention_layernorm": arr(f"{p}.post_attention_layernorm.weight"),
        })
    params = {"embed_tokens": arr("model.embed_tokens.weight"), "layers": layers,
              "norm": arr("model.norm.weight")}
    if not cfg.tie_word_embeddings and "lm_head.weight" in state:
        params["lm_head"] = lin("lm_head")
    return params


def load_hf_llama(model_dir: str, dtype=torch.bfloat16, config: Optional[LlamaConfig] = None,
                  device="cuda") -> tuple[Any, LlamaConfig]:
    """(params, config) of a local HF Llama/Mistral directory, on ``device``.
    Shards are read one at a time; each floating tensor is cast to
    ``dtype`` as its shard arrives."""
    cfg = config or read_hf_config(model_dir)
    return params_from_hf_state_dict(read_hf_state(model_dir, dtype, device), cfg, dtype), cfg


def read_hf_state(model_dir: str, dtype, device) -> Dict[str, torch.Tensor]:
    """Every tensor of the directory's shards on ``device``, floating ones
    already in ``dtype`` (so no shard's own type is held beside it)."""
    state: Dict[str, torch.Tensor] = {}
    for shard in _iter_hf_shards(model_dir, device):
        for name, t in shard.items():
            state[name] = t.to(dtype) if t.is_floating_point() else t
    return state
