# SPDX-License-Identifier: Apache-2.0
"""HQQ+: low-rank adapters on quantized linears, for serving and training.

Mirrors `hqq_tpu.core.peft`: `lora_config`, `LoRALinear` (out = base(x) +
(dropout(x) @ A) @ B * alpha/r [+ bias], A kaiming-uniform, B zeros;
`merge_and_quantize`), `TrainableParams` (the adapters as the trainable
leaves of a parameter tree) and, of `PeftUtils`, `add_lora`, `merge_lora`,
`cast_lora_weights`, `save_lora_weights` and `load_lora_weights`. Layers
are `nn.Module`s and the tree walkers replace them in place, as
`models.base` does. Adapter weights are parameters with ``requires_grad``
off until `TrainableParams.values` turns it on.

Not ported yet: `FakeQuantLoRALinear`, `GroupedProjLinear` and
`load_hf_adapter`.
"""

from __future__ import annotations

import math
from typing import Any, Callable, List, Optional

import torch
from torch import nn

from ..nn.linear import Linear, QuantLinear, _as_param
from .quantize import QTensor

__all__ = ["LoRALinear", "PeftUtils", "TrainableParams", "lora_config"]


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
        self.dropout = float(dropout)

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

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                deterministic: bool = True) -> torch.Tensor:
        """base(x) plus the adapter's term. With ``dropout`` > 0, not
        ``deterministic`` and a ``generator``, the adapter sees x with each
        value kept with probability 1 - dropout (the mask drawn from the
        generator) and scaled by 1 / (1 - dropout), as in `hqq_tpu`."""
        out = self.base(x)
        h = x.to(self.lora_a.dtype)
        if self.dropout > 0.0 and not deterministic and generator is not None:
            keep = torch.rand(h.shape, generator=generator, device=h.device) < 1.0 - self.dropout
            h = torch.where(keep, h / (1.0 - self.dropout), 0.0)
        delta = (h @ self.lora_a) @ self.lora_b * self.scaling
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

    @torch.no_grad()
    def merge_and_quantize(self, quant_config: Optional[dict] = None) -> QuantLinear:
        """The adapter merged into the dequantized base (`merged_weight`)
        and quantized again: with the base's own settings (4-bit rounds its
        zero) when ``quant_config`` is None and the base is a `QuantLinear`,
        else with ``quant_config``. The biases add up."""
        w = self.merged_weight(torch.float32)
        bias = getattr(self.base, "bias", None)
        if self.bias is not None:
            bias = self.bias if bias is None else bias + self.bias
        bias = None if bias is None else bias.detach()
        if quant_config is None and isinstance(self.base, QuantLinear):
            qt = self.base.qweight
            return QuantLinear.quantize(w, bias, nbits=qt.nbits, group_size=qt.group_size,
                                        axis=qt.axis, round_zero=(qt.nbits == 4),
                                        compute_dtype=qt.compute_dtype)
        return QuantLinear.quantize(w, bias, quant_config=quant_config)


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


def _leaves(tree: Any, path: str = ""):
    """(dotted path, tensor) for every array leaf of a parameter tree, in the
    order and under the names of `hqq_tpu`'s pytree flattening: dict keys
    sorted, lists in order, a layer's fields in declaration order (a
    LoRALinear's base, lora_a, lora_b, bias; a QuantLinear's qweight and
    bias; a QTensor's wq, scale and zero), None skipped."""
    def sub(key):
        return f"{path}.{key}" if path else str(key)

    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], sub(key))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, sub(i))
    elif isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, LoRALinear):
        yield from _leaves(tree.base, sub("base"))
        for name in ("lora_a", "lora_b", "bias"):
            yield from _leaves(getattr(tree, name), sub(name))
    elif isinstance(tree, QuantLinear):
        yield from _leaves(tree.qweight, sub("qweight"))
        yield from _leaves(tree.bias, sub("bias"))
    elif isinstance(tree, QTensor):
        for name in ("wq", "scale", "zero"):
            yield from _leaves(getattr(tree, name), sub(name))
    elif isinstance(tree, Linear):
        for name in ("weight", "bias"):
            yield from _leaves(getattr(tree, name), sub(name))
    elif isinstance(tree, nn.Module):
        for name, t in tree.named_parameters():
            yield sub(name), t


def _default_trainable(path: str) -> bool:
    return path.endswith((".lora_a", ".lora_b")) or (".lora" in path and path.endswith(".bias"))


class TrainableParams:
    """The trainable leaves of a parameter tree, by dotted path (`hqq_tpu`'s
    `TrainableParams` in torch idiom). The default predicate takes the LoRA
    A and B (and LoRA bias) leaves; everything else is the frozen quantized
    backbone. Paths and their order are those of `hqq_tpu`."""

    def __init__(self, params: Any, predicate: Optional[Callable[[str], bool]] = None):
        pred = predicate or _default_trainable
        self._params = params
        leaves = list(_leaves(params))
        self._paths = [p for p, _ in leaves]
        self._all = [t for _, t in leaves]
        self._idx = [i for i, p in enumerate(self._paths) if pred(p)]
        if not self._idx:
            raise ValueError("no trainable leaves matched the predicate")

    @property
    def paths(self) -> List[str]:
        return [self._paths[i] for i in self._idx]

    def extract(self, params: Any) -> List[torch.Tensor]:
        """The leaves of ``params`` (a tree of the same structure) at the
        trainable paths."""
        leaves = [t for _, t in _leaves(params)]
        return [leaves[i] for i in self._idx]

    def values(self) -> List[torch.Tensor]:
        """The trainable parameters, for an optimizer: ``requires_grad`` is
        set on them and cleared on every other parameter of the tree."""
        train = [self._all[i] for i in self._idx]
        keep = {id(t) for t in train}
        for t in self._all:
            if t.is_leaf and (t.is_floating_point() or t.is_complex()):
                t.requires_grad_(id(t) in keep)
        return train

    @torch.no_grad()
    def inject(self, trainable: List[torch.Tensor], params: Optional[Any] = None) -> Any:
        """Copy ``trainable`` (one tensor per path, in order) into the
        trainable leaves of ``params`` (default: the tree this was built
        from), in place, so that an optimizer over `values` keeps its
        parameters; returns the tree."""
        leaves = self._all if params is None else [t for _, t in _leaves(params)]
        if len(trainable) != len(self._idx):
            raise ValueError(f"{len(trainable)} values for {len(self._idx)} trainable leaves")
        for i, v in zip(self._idx, trainable):
            leaves[i].copy_(torch.as_tensor(v).to(device=leaves[i].device,
                                                  dtype=leaves[i].dtype))
        return self._params if params is None else params


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
    def merge_lora(params: Any, quant_config: Optional[dict] = None) -> Any:
        """Replace every `LoRALinear` by its `merge_and_quantize`, in place."""
        from ..models.base import _children

        def visit(tree, path=""):
            for key, sub in _children(tree, path):
                node = tree[key]
                if isinstance(node, (dict, list)):
                    visit(node, sub)
                elif isinstance(node, LoRALinear):
                    tree[key] = node.merge_and_quantize(quant_config)

        if isinstance(params, LoRALinear):
            return params.merge_and_quantize(quant_config)
        visit(params)
        return params

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
        safetensors (the package's own writer): the file `hqq_tpu`'s
        `save_lora_weights` writes."""
        from ..models._safetensors import save_file

        flat = {}

        def collect(p, layer):
            flat[f"{p}.lora_a"] = layer.lora_a
            flat[f"{p}.lora_b"] = layer.lora_b
            if layer.bias is not None:
                flat[f"{p}.lora_bias"] = layer.bias

        _map_lora(params, collect)
        save_file(flat, path)

    @staticmethod
    def load_lora_weights(params: Any, path: str) -> Any:
        from ..models._safetensors import load_file

        flat = load_file(path)

        def load(p, layer):
            dev = layer.lora_a.device
            layer.lora_a = _as_param(flat[f"{p}.lora_a"].to(dev))
            layer.lora_b = _as_param(flat[f"{p}.lora_b"].to(dev))
            if f"{p}.lora_bias" in flat:
                layer.bias = _as_param(flat[f"{p}.lora_bias"].to(dev))

        _map_lora(params, load)
        return params
