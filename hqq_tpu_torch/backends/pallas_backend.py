# SPDX-License-Identifier: Apache-2.0
"""Fused-kernel inference backends.

Mirrors `hqq_tpu.backends.pallas_backend`: converts a quantized `QuantLinear`
into a module whose forward is one fused kernel, through a one-time repack
into the kernel layout (`ops.fused_matmul.to_kernel_layout`). The names
``pallas`` and ``w4a8`` are kept from `hqq_tpu`; here they run the CUDA
kernels of ``csrc/``. Conversion is driven by
`hqq_tpu_torch.utils.patching.prepare_for_inference`.

Only axis=1 layers convert. An axis=0 layer stays a `QuantLinear` on the
``"xla"`` path until the axis=0 kernel is ported.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.linear import QuantLinear, _as_param
from ..ops.fused_matmul import (
    KernelQTensor,
    dequant_pallas,
    quant_matmul_pallas,
    quant_matmul_pallas_a8,
    supports_kernel_layout,
    to_kernel_layout,
)

__all__ = [
    "PallasQuantLinear",
    "A8QuantLinear",
    "patch_quantlinear_to_pallas",
    "patch_quantlinear_to_w4a8",
]


class _KernelLinear(nn.Module):
    """A kernel-layout weight plus an optional bias."""

    def __init__(self, kqt: KernelQTensor, bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.kqt = kqt
        self.bias = _as_param(bias)

    @property
    def in_features(self) -> int:
        return self.kqt.k

    @property
    def out_features(self) -> int:
        return self.kqt.n

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.kqt.compute_dtype

    def dequantize(self, dtype=None) -> torch.Tensor:
        """W [out, in] in ``dtype`` (default: the compute dtype), written by
        the dequant kernel."""
        w_t = dequant_pallas(self.kqt, dtype if dtype is not None else self.compute_dtype)
        return w_t.t()


class PallasQuantLinear(_KernelLinear):
    """Inference-only quantized linear running the fused dequant-matmul
    kernel (bf16 operands on the card)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = quant_matmul_pallas(x.to(self.compute_dtype), self.kqt)
        if self.bias is not None:
            out = out + self.bias
        return out


class A8QuantLinear(_KernelLinear):
    """W4A8 serving layer: 4-bit codes in device memory, int8 activations at
    M <= 32, the fused bf16-operand kernel above (`quant_matmul_pallas_a8`).
    The weight side is exact; activations are quantized per row."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = quant_matmul_pallas_a8(x.to(self.compute_dtype), self.kqt)
        if self.bias is not None:
            out = out + self.bias
        return out


def patch_quantlinear_to_pallas(layer: QuantLinear) -> "PallasQuantLinear | QuantLinear":
    """Convert a `QuantLinear` to the fused backend; returns the layer
    unchanged when its config does not fit the kernel layout."""
    if supports_kernel_layout(layer.qweight):
        return PallasQuantLinear(to_kernel_layout(layer.qweight), layer.bias)
    return layer


def patch_quantlinear_to_w4a8(layer: QuantLinear) -> "A8QuantLinear | QuantLinear":
    """Convert a `QuantLinear` to the W4A8 backend; returns the layer
    unchanged when its config does not fit the kernel layout."""
    if supports_kernel_layout(layer.qweight):
        return A8QuantLinear(to_kernel_layout(layer.qweight), layer.bias)
    return layer

