# SPDX-License-Identifier: Apache-2.0
"""Model-level quantization over a parameter tree.

Mirrors `hqq_tpu.models.base`. A model's parameters are nested dicts and
lists whose leaves are tensors and linear layers (`Linear`, `QuantLinear`
and the kernel backends' modules). Every `Linear` whose linear tag (its path
with ``model``/``layers`` and layer indices stripped) matches the quant
config becomes a `QuantLinear`; per-tag configs with None mean "skip".

Unlike `hqq_tpu`, which builds a new tree, `patch_linears` and so
`quantize_model` replace the leaves in place: each dense weight is dropped
as soon as its layer is quantized, so a model's peak memory stays near its
dense size instead of dense plus quantized.

Only `Linear` leaves are quantized, as in `hqq_tpu`: on an MoE tree that is
the attention and the routers; the expert stacks (`nn.moe.GroupedLinear`)
are no linear leaves and stay as they are. The MoE families quantize their
experts with their own `quantize_mixtral`, `quantize_qwen3_moe` and
`quantize_gpt_oss`, which keep the router in full precision.

`save_quantized` and `from_quantized` write and read checkpoints in
`hqq_tpu`'s format (`models.serialize`).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Union

from ..core.quantize import BaseQuantizeConfig
from ..nn.linear import Linear, QuantLinear
from .serialize import load_checkpoint, save_checkpoint

__all__ = [
    "IGNORE_LINEAR",
    "name_to_linear_tag",
    "iter_linears",
    "patch_linears",
    "get_linear_tags",
    "quantize_model",
    "save_quantized",
    "from_quantized",
]

# Linears never quantized by default
IGNORE_LINEAR = ("lm_head",)


def name_to_linear_tag(path: str) -> str:
    """'layers.11.self_attn.q_proj' -> 'self_attn.q_proj'."""
    parts = [p for p in path.split(".") if p not in ("model", "layers") and not p.isdigit()]
    return ".".join(parts)


def _is_linear(node: Any) -> bool:
    # the kernel backends' modules also carry in/out features; only the two
    # canonical layer types are patched, as in `hqq_tpu`
    return isinstance(node, (Linear, QuantLinear))


def _children(tree: Any, path: str):
    """(key, child path) for each child of a dict or list."""
    keys = list(tree) if isinstance(tree, dict) else range(len(tree))
    for key in keys:
        yield key, f"{path}.{key}" if path else str(key)


def iter_linears(params: Any, path: str = ""):
    """Yield (path, layer) for every Linear/QuantLinear leaf, depth first."""
    if isinstance(params, (dict, list)):
        for key, sub in _children(params, path):
            yield from iter_linears(params[key], sub)
    elif _is_linear(params):
        yield path, params


def get_linear_tags(params: Any, ignore=IGNORE_LINEAR) -> list[str]:
    """Unique linear tags in traversal order."""
    tags: list[str] = []
    for path, _ in iter_linears(params):
        tag = name_to_linear_tag(path)
        if tag in tags or any(ig in path for ig in ignore):
            continue
        tags.append(tag)
    return tags


def patch_linears(params: Any, fn: Callable[[str, Any], Any], path: str = "") -> Any:
    """Replace every linear leaf with fn(path, leaf), in place; returns
    ``params`` (or fn's result when ``params`` is itself a leaf)."""
    if isinstance(params, (dict, list)):
        for key, sub in _children(params, path):
            params[key] = patch_linears(params[key], fn, sub)
        return params
    return fn(path, params) if _is_linear(params) else params


def quantize_model(
    params: Any,
    quant_config: Union[dict, None] = None,
    compute_dtype=None,
    ignore=IGNORE_LINEAR,
) -> Any:
    """Quantize every (non-ignored) Linear leaf of a parameter tree, in
    place, layer by layer.

    quant_config: a `BaseQuantizeConfig(...)` dict applied to every tag, or
    a {linear_tag: config-or-None} dict (None skips that tag).
    """
    if quant_config is None:
        quant_config = BaseQuantizeConfig()
    if "weight_quant_params" in quant_config:
        patch_params: Dict[str, Optional[dict]] = {
            t: quant_config for t in get_linear_tags(params, ignore)
        }
    else:
        patch_params = dict(quant_config)

    def quantize_leaf(path: str, layer):
        if any(ig in path for ig in ignore) or not isinstance(layer, Linear):
            return layer
        cfg = patch_params.get(name_to_linear_tag(path))
        if cfg is None:
            return layer
        return QuantLinear.quantize(
            layer.weight.data, None if layer.bias is None else layer.bias.data,
            quant_config=cfg, compute_dtype=compute_dtype,
        )

    return patch_linears(params, quantize_leaf)


def save_quantized(params: Any, save_dir: str, config: Optional[dict] = None) -> None:
    """Write ``params`` and ``config`` to ``save_dir`` (`save_checkpoint`)."""
    save_checkpoint(save_dir, params, config=config)


def from_quantized(save_dir: str, device="cuda"):
    """(params, config dict) of a checkpoint, tensors on ``device``."""
    return load_checkpoint(save_dir, device=device)
