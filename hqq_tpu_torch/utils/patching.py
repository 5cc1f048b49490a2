# SPDX-License-Identifier: Apache-2.0
"""Inference preparation: swap quantized layers for fused backends.

Mirrors `hqq_tpu.utils.patching.prepare_for_inference`, with the backend
names of `hqq_tpu`:

    "xla"    keep `QuantLinear` (dequantize with plain torch, then matmul)
    "pallas" `PallasQuantLinear` (the fused dequant-matmul kernel)
    "w4a8"   `A8QuantLinear` (int8 activations at M <= 32, the fused
             kernel above)

``backend`` may also be a {linear_tag: backend} dict; missing tags keep
"xla". Layers convert in place in the tree (see `models.base`).
"""

from __future__ import annotations

from typing import Any

from ..backends.pallas_backend import (
    PallasQuantLinear,
    patch_quantlinear_to_pallas,
    patch_quantlinear_to_w4a8,
)
from ..nn.linear import QuantLinear

__all__ = ["BACKENDS", "prepare_for_inference"]

BACKENDS = ("xla", "pallas", "w4a8")


def prepare_for_inference(params: Any, backend="pallas") -> Any:
    """Swap the quantized layers of ``params`` to ``backend``, in place;
    returns ``params``."""
    from ..models.base import _children, name_to_linear_tag

    per_tag = isinstance(backend, dict)
    for b in backend.values() if per_tag else (backend,):
        if b not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}: {b!r}")

    def one(node: QuantLinear, b: str):
        if b == "pallas":
            return patch_quantlinear_to_pallas(node)
        if b == "w4a8":
            return patch_quantlinear_to_w4a8(node)
        return node

    def convert(node: Any, path: str) -> Any:
        if isinstance(node, (dict, list)):
            for key, sub in _children(node, path):
                node[key] = convert(node[key], sub)
            return node
        if isinstance(node, QuantLinear):
            b = backend.get(name_to_linear_tag(path), "xla") if per_tag else backend
            return one(node, b)
        if isinstance(node, PallasQuantLinear) and backend == "xla":
            raise ValueError("cannot convert PallasQuantLinear back to xla backend")
        return node

    return convert(params, "")
