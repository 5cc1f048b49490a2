# SPDX-License-Identifier: Apache-2.0
"""HQQ+: low-rank adapters on quantized linears, the serving side.

Mirrors `hqq_tpu.core.peft` as far as serving needs it: `lora_config`,
`LoRALinear` (out = base(x) + (x @ A) @ B * alpha/r [+ bias], A
kaiming-uniform, B zeros) and, of `PeftUtils`, `add_lora`,
`cast_lora_weights`, `save_lora_weights` and `load_lora_weights`. Layers
are `nn.Module`s and the tree walkers replace them in place, as
`models.base` does.

Not ported yet (they come with the training slice): dropout, the gradient,
`merge_and_quantize`/`merge_lora`, `FakeQuantLoRALinear`,
`GroupedProjLinear`, `TrainableParams` and `load_hf_adapter`. Until then the
adapter weights are frozen parameters.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch
from torch import nn

from ..nn.linear import _as_param

__all__ = ["LoRALinear", "PeftUtils", "lora_config"]


def lora_config(
    r: int = 8,
    lora_alpha: int = 8,
    dropout: float = 0.0,
    train_dtype=torch.float32,
    train_bias: bool = False,
) -> dict:
    """A per-tag adapter config, as `hqq_tpu.core.peft.lora_config`."""
    return dict(r=r, lora_alpha=lora_alpha, dropout=dropout, train_dtype=train_dtype,
                train_bias=train_bias)


class LoRALinear(nn.Module):
    """LoRA wrapper over any linear-like layer.

    out = base(x) + (x @ A) @ B * (alpha / r) [+ bias]
    A: [in, r] kaiming-uniform, B: [r, out] zeros, so a fresh wrap is a
    no-op. A and B keep ``train_dtype`` (fp32 by default) whatever the
    base's compute dtype."""

    def __init__(self, base: nn.Module, lora_a: torch.Tensor, lora_b: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, scaling: float = 1.0,
                 dropout: float = 0.0):
        super().__init__()
        self.base = base
        self.lora_a = _as_param(lora_a)
        self.lora_b = _as_param(lora_b)
        self.bias = _as_param(bias)
        self.scaling = float(scaling)
        self.dropout = float(dropout)  # kept for training; the forward is deterministic

    @property
    def in_features(self) -> int:
        return self.base.in_features

    @property
    def out_features(self) -> int:
        return self.base.out_features

    @classmethod
    def wrap(
        cls,
        base: nn.Module,
        r: int = 8,
        lora_alpha: int = 8,
        dropout: float = 0.0,
        train_dtype=torch.float32,
        train_bias: bool = False,
        generator: Optional[torch.Generator] = None,
        device=None,
    ) -> "LoRALinear":
        """Wrap ``base``; A is drawn from ``generator`` (seed 0 on the
        layer's device when None). ``device`` defaults to that of the
        base's first tensor."""
        if device is None:
            device = _device_of(base)
        device = torch.device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        in_f, out_f = base.in_features, base.out_features
        bound = math.sqrt(6.0 / in_f)  # kaiming-uniform over fan_in
        u = torch.rand((in_f, r), generator=generator, device=device, dtype=torch.float32)
        lora_a = ((2.0 * u - 1.0) * bound).to(train_dtype)
        lora_b = torch.zeros((r, out_f), dtype=train_dtype, device=device)
        bias = torch.zeros((out_f,), dtype=train_dtype, device=device) if train_bias else None
        return cls(base, lora_a, lora_b, bias, scaling=float(lora_alpha) / float(r),
                   dropout=dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.base(x)
        delta = (x.to(self.lora_a.dtype) @ self.lora_a) @ self.lora_b * self.scaling
        out = out + delta.to(out.dtype)
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        return out

    def merged_weight(self, dtype=torch.float32) -> torch.Tensor:
        """W + (A @ B)^T, [out, in]. As in `hqq_tpu`, the scaling is not
        applied here."""
        if hasattr(self.base, "dequantize"):
            w = self.base.dequantize(dtype)
        else:
            w = self.base.weight.to(dtype)
        return w + (self.lora_a @ self.lora_b).t().to(dtype)


def _device_of(module: nn.Module) -> torch.device:
    for t in module.parameters():
        return t.device
    for holder in (getattr(module, "qweight", None), getattr(module, "kqt", None)):
        if holder is not None:
            return holder.wq.device
    raise ValueError(f"cannot tell the device of {type(module).__name__}")


def _map_lora(tree: Any, fn, path: str = "") -> None:
    """Call fn(path, layer) on every `LoRALinear` of a tree of dicts and
    lists, depth first."""
    from ..models.base import _children

    if isinstance(tree, (dict, list)):
        for key, sub in _children(tree, path):
            _map_lora(tree[key], fn, sub)
    elif isinstance(tree, LoRALinear):
        fn(path, tree)


class PeftUtils:
    """Model-level adapter management; every method works in place and
    returns ``params``."""

    @staticmethod
    def add_lora(params: Any, lora_params: dict, generator: Optional[torch.Generator] = None,
                 ignore=("lm_head",)) -> Any:
        """Wrap every linear leaf in a LoRA adapter.

        lora_params: one `lora_config(...)` dict, or {linear_tag: cfg} with
        None (or a missing tag) meaning skip. The A matrices are drawn one
        after the other from ``generator`` (see `LoRALinear.wrap`)."""
        from ..models.base import name_to_linear_tag, patch_linears

        uniform = "r" in lora_params
        gen = [generator]

        def wrap(path, layer):
            if any(ig in path for ig in ignore):
                return layer
            cfg = lora_params if uniform else lora_params.get(name_to_linear_tag(path))
            if cfg is None:
                return layer
            if gen[0] is None:  # one seeded stream, shared by the layers
                gen[0] = torch.Generator(device=_device_of(layer)).manual_seed(0)
            return LoRALinear.wrap(layer, generator=gen[0], **cfg)

        return patch_linears(params, wrap)

    @staticmethod
    def cast_lora_weights(params: Any, dtype) -> Any:
        def cast(_, layer):
            layer.lora_a.data = layer.lora_a.data.to(dtype)
            layer.lora_b.data = layer.lora_b.data.to(dtype)
            if layer.bias is not None:
                layer.bias.data = layer.bias.data.to(dtype)

        _map_lora(params, cast)
        return params

    @staticmethod
    def save_lora_weights(params: Any, path: str) -> None:
        """Save only the adapter weights, keyed by module path, as
        safetensors: the file `hqq_tpu`'s `save_lora_weights` writes."""
        from safetensors.torch import save_file

        flat = {}

        def collect(p, layer):
            flat[f"{p}.lora_a"] = layer.lora_a.detach().cpu().contiguous()
            flat[f"{p}.lora_b"] = layer.lora_b.detach().cpu().contiguous()
            if layer.bias is not None:
                flat[f"{p}.lora_bias"] = layer.bias.detach().cpu().contiguous()

        _map_lora(params, collect)
        save_file(flat, path)

    @staticmethod
    def load_lora_weights(params: Any, path: str) -> Any:
        from safetensors.torch import load_file

        flat = load_file(path)

        def load(p, layer):
            dev = layer.lora_a.device
            layer.lora_a = _as_param(flat[f"{p}.lora_a"].to(dev))
            layer.lora_b = _as_param(flat[f"{p}.lora_b"].to(dev))
            if f"{p}.lora_bias" in flat:
                layer.bias = _as_param(flat[f"{p}.lora_bias"].to(dev))

        _map_lora(params, load)
        return params
