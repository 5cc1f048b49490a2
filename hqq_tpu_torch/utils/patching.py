# SPDX-License-Identifier: Apache-2.0
"""Inference preparation: swap quantized layers for fused backends.

Mirrors `hqq_tpu.utils.patching.prepare_for_inference`, with the backend
names of `hqq_tpu`:

    "xla"    keep `QuantLinear` (dequantize, on the card by the dequant
             kernel's canonical entry, then matmul)
    "pallas" `PallasQuantLinear` (the fused dequant-matmul kernel)
    "w4a8"   `A8QuantLinear` (int8 activations at M <= 32, the fused
             kernel above)

Layers of either quantization axis convert under "pallas" and "w4a8"
(axis=0 takes the bf16-operand axis=0 kernel under both). A `LoRALinear`
over an axis=1 base becomes one fused module under "pallas"
(`PallasLoRAQuantLinear`) and "w4a8" (`A8LoRAQuantLinear`); otherwise its
base converts in place.

``backend`` may also be a {linear_tag: backend} dict; missing tags keep
"xla". Layers convert in place in the tree (see `models.base`).
"""

from __future__ import annotations

from typing import Any

from ..backends.pallas_backend import (
    PallasQuantLinear,
    _patch_w4a8_any_axis,
    patch_lora_to_pallas,
    patch_lora_to_w4a8,
    patch_quantlinear_to_pallas,
)
from ..core.peft import LoRALinear
from ..nn.linear import QuantLinear

__all__ = ["BACKENDS", "prepare_for_inference"]

BACKENDS = ("xla", "pallas", "w4a8")


def prepare_for_inference(params: Any, backend="pallas", verbose: bool = False,
                          meta_dtype=None) -> Any:
    """Swap the quantized layers of ``params`` to ``backend``, in place;
    returns ``params``.

    ``meta_dtype`` overrides the storage type of the axis=0 kernel layout's
    scale and zs. None takes the per-config policy
    (`backends.pallas_backend._ax0_meta_dtype`: bf16 for 2-bit g16 and 1-bit
    g16/g32, fp32 otherwise); pass ``torch.float32`` for the numbers of the
    "xla" path. The axis=1 layout is fp32 only."""
    from ..models.base import _children, name_to_linear_tag

    per_tag = isinstance(backend, dict)
    for b in backend.values() if per_tag else (backend,):
        if b not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}: {b!r}")
    stats = {"converted": 0, "kept": 0}

    def one(node: QuantLinear, b: str):
        out = node
        if b == "pallas":
            out = patch_quantlinear_to_pallas(node, meta_dtype)
        elif b == "w4a8":
            out = _patch_w4a8_any_axis(node, meta_dtype)
        stats["converted" if out is not node else "kept"] += 1
        return out

    def convert(node: Any, path: str) -> Any:
        if isinstance(node, (dict, list)):
            for key, sub in _children(node, path):
                node[key] = convert(node[key], sub)
            return node
        if isinstance(node, LoRALinear):
            b = backend.get(name_to_linear_tag(path)) if per_tag else backend
            if b in ("pallas", "w4a8"):
                fused = (patch_lora_to_pallas if b == "pallas" else patch_lora_to_w4a8)(node)
                if fused is not node:
                    stats["converted"] += 1
                    return fused
            node.base = convert(node.base, path)
            return node
        if isinstance(node, QuantLinear):
            b = backend.get(name_to_linear_tag(path), "xla") if per_tag else backend
            return one(node, b)
        if isinstance(node, PallasQuantLinear) and backend == "xla":
            raise ValueError("cannot convert PallasQuantLinear back to xla backend")
        return node

    out = convert(params, "")
    if verbose:
        print(f"prepare_for_inference[{backend}]: {stats}")
    return out
