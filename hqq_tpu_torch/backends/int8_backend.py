# SPDX-License-Identifier: Apache-2.0
"""Dynamic A8W8 int8 backend: an int8 x int8 -> int32 matmul.

Mirrors `hqq_tpu.backends.int8_backend`. The weight is converted once, at
`prepare_for_inference(backend="int8")`: the HQQ-dequantized weight is
quantized again symmetrically per output row,

    w8 [out, in] int8, sw = max(absmax_row / 127, 1e-8) (fp32),

and each forward quantizes the activations per token,

    x8 = round(x / sx), sx = max(absmax_row(x) / 127, 1e-8)
    y  = (x8 @ w8^T) * sx * sw        # int32 accumulation

rounding half to even in both packages, so the int32 products are the
same bits. `hqq_tpu` takes an XLA int8 dot here, no Pallas kernel; on the
card this is `torch._int_mm` (cuBLASLt), a library product, and the
activation quantization and the rescale are plain torch. The int8 weight
holds twice the bytes of the 4-bit codes of the ``w4a8`` backend.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.quantize import dequantize
from ..nn.linear import QuantLinear, _as_param
from ..ops.fused_matmul import quantize_activations_int8

__all__ = ["Int8QuantLinear", "patch_quantlinear_to_int8", "dynamic_int8_matmul", "pad_for_mxu",
           "int8_matmul", "int8_matmul_plain"]

# `torch._int_mm` on CUDA takes more than 16 rows, and K and N multiples of 8
_INT_MM_MIN_ROWS = 17
_INT_MM_MULTIPLE = 8


def _quantize_int8_rows(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization with one fp32 scale per row."""
    sw = (w.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-8)
    w8 = torch.round(w / sw).to(torch.int8)
    return w8, sw.to(torch.float32)


def int8_matmul_plain(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """x8 [M, K] @ w8 [N, K]^T -> int32 [M, N], exact: the products and
    their sums (below 2^31 for K < 2^17) are integers that fp64 holds."""
    return (x8.to(torch.float64) @ w8.to(torch.float64).t()).to(torch.int32)


def int8_matmul(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """x8 [M, K] @ w8 [N, K]^T with int32 accumulation. On the CPU the
    plain version; on the card `torch._int_mm`, with the rows padded to
    its minimum (zero rows, sliced off) and K and N required to be
    multiples of 8 (`pad_for_mxu(layer, 8)` pads a layer that is not)."""
    if x8.device.type == "cpu":
        return int8_matmul_plain(x8, w8)
    m, k = x8.shape
    n = w8.shape[0]
    if k % _INT_MM_MULTIPLE or n % _INT_MM_MULTIPLE:
        raise ValueError(f"torch._int_mm takes K and N multiples of {_INT_MM_MULTIPLE}, got "
                         f"K={k}, N={n}: pad the layer with pad_for_mxu(layer, "
                         f"{_INT_MM_MULTIPLE})")
    rows = max(m, _INT_MM_MIN_ROWS)
    if rows != m:
        x8 = F.pad(x8, (0, 0, 0, rows - m))
    return torch._int_mm(x8.contiguous(), w8.t())[:m]


def dynamic_int8_matmul(x: torch.Tensor, w8: torch.Tensor, sw: torch.Tensor) -> torch.Tensor:
    """``x @ W^T`` for an int8 row-scaled W: the activations quantized per
    token (`quantize_activations_int8`), the int32 product, the fp32
    rescale (acc * sx * sw, in `hqq_tpu`'s order). Returns x's dtype."""
    lead = x.shape[:-1]
    x8, sx = quantize_activations_int8(x.reshape(-1, x.shape[-1]))
    acc = int8_matmul(x8, w8)
    out = acc.to(torch.float32) * sx * sw.reshape(1, -1)
    return out.reshape(*lead, w8.shape[0]).to(x.dtype)


class Int8QuantLinear(nn.Module):
    """Inference linear with a static int8 weight (one scale per output
    row) and int8 activations quantized per token at each call.

    ``w8`` may be padded (`pad_for_mxu`): the logical sizes are then
    ``logical_out``/``logical_in``, the activations are padded with zeros
    and the output sliced, which changes no product."""

    def __init__(self, w8: torch.Tensor, sw: torch.Tensor, bias: Optional[torch.Tensor] = None,
                 compute_dtype=torch.bfloat16, logical_out: Optional[int] = None,
                 logical_in: Optional[int] = None):
        super().__init__()
        self.w8 = _as_param(w8)
        self.sw = _as_param(sw)
        self.bias = _as_param(bias)
        self.compute_dtype = compute_dtype
        self.logical_out = logical_out
        self.logical_in = logical_in

    @property
    def in_features(self) -> int:
        return self.logical_in or self.w8.shape[1]

    @property
    def out_features(self) -> int:
        return self.logical_out or self.w8.shape[0]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k_pad = self.w8.shape[1]
        if x.shape[-1] != k_pad:
            x = F.pad(x, (0, k_pad - x.shape[-1]))
        out = dynamic_int8_matmul(x.to(self.compute_dtype), self.w8, self.sw)
        if self.w8.shape[0] != self.out_features:
            out = out[..., : self.out_features]
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        return out

    def dequantize(self, dtype=None) -> torch.Tensor:
        """W [out, in] (the logical part) in ``dtype``, default the compute
        dtype."""
        w = (self.w8.to(torch.float32) * self.sw).to(dtype or self.compute_dtype)
        return w[: self.out_features, : self.in_features]


def pad_for_mxu(layer: Int8QuantLinear, multiple: int = 512) -> Int8QuantLinear:
    """Pad both weight dims up to ``multiple`` (the name is `hqq_tpu`'s,
    whose 512 is a TPU tiling rule). Zero rows and columns are exact:
    padded K meets zero activations, padded N is sliced off. Returns the
    layer itself when nothing needs padding."""
    out_f, in_f = layer.w8.shape
    op = -(-out_f // multiple) * multiple
    ip = -(-in_f // multiple) * multiple
    if (op, ip) == (out_f, in_f):
        return layer
    w8 = F.pad(layer.w8.data, (0, ip - in_f, 0, op - out_f))
    sw = F.pad(layer.sw.data, (0, 0, 0, op - out_f), value=1.0)
    return Int8QuantLinear(w8, sw, None if layer.bias is None else layer.bias.data,
                           layer.compute_dtype, layer.logical_out or out_f,
                           layer.logical_in or in_f)


def patch_quantlinear_to_int8(layer: QuantLinear) -> Int8QuantLinear:
    """A `QuantLinear` (any nbits and axis) as an `Int8QuantLinear`: its
    HQQ-dequantized weight, in fp32, quantized again to int8 per row, once.
    A layer whose sizes are not multiples of 8 is padded to them
    (`pad_for_mxu`), which `torch._int_mm` needs on the card."""
    w8, sw = _quantize_int8_rows(dequantize(layer.qweight, torch.float32))
    out = Int8QuantLinear(w8, sw, None if layer.bias is None else layer.bias.data,
                          layer.qweight.compute_dtype)
    return pad_for_mxu(out, _INT_MM_MULTIPLE)
