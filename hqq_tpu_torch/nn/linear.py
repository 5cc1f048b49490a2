# SPDX-License-Identifier: Apache-2.0
"""Linear layers (PyTorch `nn.Module`s).

Mirrors `hqq_tpu.nn.linear`: `Linear` is the dense layer, `QuantLinear`
holds a `QTensor` and runs the ``"xla"`` path, named after `hqq_tpu`'s
backend: dequantize, then a matmul in the compute dtype with an fp32
accumulator, through `dequant_matmul`, whose backward dequantizes again
instead of keeping the weight (`hqq_tpu`'s custom VJP). On a CUDA device
each dequantization is one launch of the dequant kernel's canonical entry
(csrc/dequant.cu, `ops.fused_matmul.dequant_canonical`), written straight
in the compute type; on the CPU its plain twin. Weights are
``[out_features, in_features]`` as in torch.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.quantize import QTensor, dequantize, quantize

__all__ = ["Linear", "QuantLinear", "dequant_matmul", "concat_biases"]


def _as_param(t: Optional[torch.Tensor]) -> Optional[nn.Parameter]:
    return None if t is None else nn.Parameter(t, requires_grad=False)


def concat_biases(layers) -> Optional[torch.Tensor]:
    """The biases of ``layers`` side by side, zeros (in the first bias's
    type) for a layer without one; None where no layer has one. For layers
    joined along their outputs (`utils.patching.fuse_for_decode`)."""
    first = next((layer.bias for layer in layers if layer.bias is not None), None)
    if first is None:
        return None
    return torch.cat([layer.bias.data if layer.bias is not None
                      else first.new_zeros(layer.out_features) for layer in layers])


class Linear(nn.Module):
    """Dense linear layer, the unquantized peer of `QuantLinear`."""

    def __init__(self, weight: torch.Tensor, bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.weight = _as_param(weight)
        self.bias = _as_param(bias)

    @property
    def in_features(self) -> int:
        return self.weight.shape[1]

    @property
    def out_features(self) -> int:
        return self.weight.shape[0]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.linear(x, self.weight.to(x.dtype))
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        return out


class _DequantMatmul(torch.autograd.Function):
    """x @ W_dq^T with `hqq_tpu`'s memory-efficient backward: the forward
    keeps the `QTensor` (the packed codes and meta the layer holds anyway)
    and nothing of x or of the dequantized weight; the backward dequantizes
    again and returns dx = g @ W_dq in the compute type. Each dequantization
    is one call of `dequantize` (on the card, one kernel launch). The codes,
    scale and zero get no gradient."""

    @staticmethod
    def forward(ctx, x, qt):
        ctx.qt = qt
        return F.linear(x, dequantize(qt, qt.compute_dtype))

    @staticmethod
    def backward(ctx, g):
        qt = ctx.qt
        w = dequantize(qt, qt.compute_dtype)  # again, not stored
        return g.to(qt.compute_dtype) @ w, None


def dequant_matmul(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """``x @ W_dq^T`` in the compute type of ``qt`` (x is cast to it), with
    a backward that recomputes W_dq rather than storing it: mirrors
    `hqq_tpu.nn.linear.dequant_matmul`."""
    return _DequantMatmul.apply(x.to(qt.compute_dtype), qt)


class QuantLinear(nn.Module):
    """Quantized linear layer on the ``"xla"`` path. Construct it with
    `QuantLinear.quantize`."""

    def __init__(self, qweight: QTensor, bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.qweight = qweight
        self.bias = _as_param(bias)

    @classmethod
    def quantize(
        cls,
        weight: torch.Tensor,
        bias: Optional[torch.Tensor] = None,
        quant_config: Optional[dict] = None,
        compute_dtype=None,
        **quant_kwargs,
    ) -> "QuantLinear":
        """Quantize a dense [out_features, in_features] weight.

        `quant_config` is a `BaseQuantizeConfig(...)` dict; extra kwargs
        override single weight_quant_params, and an explicit `compute_dtype`
        overrides the config's. group_size=None means a whole row (axis=1)
        or column (axis=0)."""
        params: dict = {}
        if quant_config is not None:
            params.update(quant_config["weight_quant_params"])
            if quant_config.get("scale_quant_params") is not None:
                params["scale_quant_params"] = quant_config["scale_quant_params"]
            if quant_config.get("zero_quant_params") is not None:
                params["zero_quant_params"] = quant_config["zero_quant_params"]
        params.update(quant_kwargs)
        if compute_dtype is not None:
            params["compute_dtype"] = compute_dtype
        params.setdefault("compute_dtype", torch.bfloat16)
        if params.get("group_size", 64) is None:
            params["group_size"] = (
                weight.shape[1] if params.get("axis", 1) == 1 else weight.shape[0]
            )
        qt = quantize(weight, **params)
        if bias is not None:
            bias = bias.to(qt.compute_dtype)
        return cls(qt, bias)

    @property
    def in_features(self) -> int:
        return self.qweight.shape[1]

    @property
    def out_features(self) -> int:
        return self.qweight.shape[0]

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.qweight.compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = dequant_matmul(x, self.qweight)
        if self.bias is not None:
            out = out + self.bias
        return out

    def dequantize(self, dtype=None) -> torch.Tensor:
        return dequantize(self.qweight, dtype=dtype)
