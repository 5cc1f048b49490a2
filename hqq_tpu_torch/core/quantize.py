# SPDX-License-Identifier: Apache-2.0
"""Core HQQ quantizer (PyTorch).

Mirrors `hqq_tpu.core.quantize`. A quantized weight is a `QTensor`, a
dataclass of tensors holding bit-packed integer codes plus per-group scale
and zero-point; `quantize` and `dequantize` are plain functions on tensors
and run on the device of their input.

Math (affine, asymmetric, per group):

    W grouped along axis: [-1, g] (axis=1) or [g, -1] (axis=0)
    s_inv = (2^n - 1) / (max - min)       # guarded and clamped
    zero  = -min * s_inv                   # rounded when round_zero (4-bit)
    W_q   = round(W * s_inv + zero).clip(0, 2^n - 1)   # HQQ-optimised
    stored scale = 1 / s_inv               # dequant is a multiply
    dequant: (W_q - zero) * scale, reshaped to the original shape
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Union

import torch

from . import bitpack
from .optimize import optimize_weights_proximal

__all__ = [
    "QTensor",
    "quantize",
    "dequantize",
    "dequantize_plain",
    "unpack_codes",
    "resolve_meta",
    "BaseQuantizeConfig",
    "SUPPORTED_BITS",
    "BIT_TO_PACKING",
]

SUPPORTED_BITS = (8, 6, 5, 4, 3, 2, 1.58, 1)

# Widths without a container of their own ride the next one up
# (6/5 -> 8-bit, 1.58 -> 2-bit).
BIT_TO_PACKING = {
    8: "8bit_u8",
    6: "8bit_u8",
    5: "8bit_u8",
    4: "4bit_u8",
    3: "3bit_32",
    2: "2bit_u8",
    1.58: "2bit_u8",
    1: "1bit_u8",
}


def _canon_bits(nbits) -> float:
    """Normalise an nbits value (int or float) to its canonical key."""
    for b in SUPPORTED_BITS:
        if float(nbits) == float(b):
            return b
    raise ValueError(f"nbits={nbits} not supported; choose from {SUPPORTED_BITS}")


@dataclasses.dataclass
class QTensor:
    """Bit-packed quantized tensor.

    Tensors live in group space: ``wq`` is the packed code matrix of the
    grouped weight ([num_groups, g] for axis=1, [g, num_groups] for axis=0),
    and ``scale``/``zero`` broadcast against the unpacked grouped matrix.
    ``scale`` and ``zero`` may themselves be `QTensor`s (meta-quantization).
    """

    wq: torch.Tensor
    scale: Union[torch.Tensor, "QTensor"]
    zero: Union[torch.Tensor, "QTensor"]
    nbits: float = 4
    group_size: Optional[int] = 64
    axis: int = 1
    shape: tuple = ()
    packing: Optional[str] = "4bit_u8"
    compute_dtype: torch.dtype = torch.bfloat16
    channel_wise: bool = True
    # >1: wq packed block-locally (`bitpack.pack(blocks=...)`)
    pack_blocks: int = 1

    @property
    def is_meta_quantized(self) -> bool:
        """True when scale and/or zero are themselves quantized."""
        return isinstance(self.scale, QTensor) or isinstance(self.zero, QTensor)

    def dequantize(self, dtype=None) -> torch.Tensor:
        return dequantize(self, dtype=dtype)


def _grouped_view(w: torch.Tensor, group_size: Optional[int], channel_wise: bool, axis: int):
    """Reshape to group space."""
    if group_size is not None and channel_wise:
        return w.reshape(-1, group_size) if axis == 1 else w.reshape(group_size, -1)
    return w


def _quantize_impl(
    w: torch.Tensor,
    *,
    nbits: float,
    channel_wise: bool,
    group_size: Optional[int],
    optimize: bool,
    round_zero: bool,
    axis: int,
    bitpack_weights: bool,
    meta_dtype,
    opt_params: dict,
):
    """Grouping, min/max, scale/zero init, proximal solve and bit-packing."""
    w_f = _grouped_view(w.to(torch.float32), group_size, channel_wise, axis)

    max_v = float(round(2**nbits - 1))
    min_v = 0.0

    if not channel_wise:
        _min = w_f.min().reshape(1, 1)
        _max = w_f.max().reshape(1, 1)
        optimize = False
    else:
        _min = w_f.amin(dim=axis, keepdim=True)
        _max = w_f.amax(dim=axis, keepdim=True)

    denom = _max - _min
    # a true division, as hqq_tpu's: a Python float over a tensor is the
    # tensor's reciprocal times the float in torch, a rounding more
    scale = torch.full_like(denom, max_v) / denom
    scale = torch.where(denom.abs() <= 1e-4, torch.ones_like(scale), scale)
    scale = scale.clamp(max=2e4)  # half-precision safety
    zero = -_min * scale

    if round_zero:
        zero = torch.round(zero)

    if optimize:
        w_q, scale, zero = optimize_weights_proximal(
            w_f, scale, zero, (min_v, max_v), axis=axis, opt_params=opt_params
        )
    else:
        w_q = torch.round(w_f * scale + zero).clamp(min_v, max_v)

    # Store the inverse so that dequantization is a multiply.
    scale = (1.0 / scale).to(meta_dtype)
    zero = zero.to(meta_dtype)

    if bitpack_weights:
        wq = bitpack.pack(w_q.to(torch.int32), BIT_TO_PACKING[nbits])
    else:
        wq = w_q
    return wq, scale, zero


def quantize(
    w: torch.Tensor,
    nbits: float = 4,
    channel_wise: bool = True,
    group_size: Optional[int] = 64,
    optimize: bool = True,
    round_zero: bool = False,
    axis: int = 1,
    bitpack_weights: bool = True,
    compute_dtype=torch.bfloat16,
    meta_dtype=torch.float32,
    opt_params: Optional[dict] = None,
    scale_quant_params: Optional[dict] = None,
    zero_quant_params: Optional[dict] = None,
) -> QTensor:
    """Quantize a 2-D weight matrix to an HQQ `QTensor` on ``w``'s device,
    with the scale guard (denominator <= 1e-4 -> scale 1.0) and the 2e4
    clamp. ``meta_dtype`` is the storage type of scale and zero."""
    nbits = _canon_bits(nbits)
    if axis not in (0, 1):
        raise ValueError("axis must be 0 or 1")
    if group_size is not None and w.numel() % group_size != 0:
        raise ValueError(
            f"tensor size {tuple(w.shape)} not divisible by group_size={group_size}"
        )

    shape = tuple(w.shape)
    p = dict(dict(lp_norm=0.7, beta=1e1, kappa=1.01, iters=20), **(opt_params or {}))

    wq, scale, zero = _quantize_impl(
        w,
        nbits=nbits,
        channel_wise=channel_wise,
        group_size=group_size,
        optimize=optimize,
        round_zero=round_zero,
        axis=axis,
        bitpack_weights=bitpack_weights,
        meta_dtype=meta_dtype,
        opt_params=p,
    )

    packing: Optional[str] = BIT_TO_PACKING[nbits]
    if not bitpack_weights:
        wq = wq.to(compute_dtype)
        packing = None

    if zero_quant_params is not None:
        zero = _quantize_meta(zero, zero_quant_params)
    if scale_quant_params is not None:
        scale = _quantize_meta(scale, scale_quant_params)

    return QTensor(
        wq=wq,
        scale=scale,
        zero=zero,
        nbits=nbits,
        group_size=group_size,
        axis=axis,
        shape=shape,
        packing=packing,
        compute_dtype=compute_dtype,
        channel_wise=channel_wise,
    )


def _quantize_meta(arr: torch.Tensor, params: dict) -> QTensor:
    """Quantize a scale or zero tensor itself (meta-quantization). Defaults:
    8-bit, no solver, axis=0."""
    p = dict(
        nbits=8,
        channel_wise=True,
        group_size=128,
        optimize=False,
        round_zero=False,
        axis=0,
    )
    p.update(params or {})
    if p["group_size"] is not None and arr.numel() % p["group_size"] != 0:
        # small or odd-shaped meta tensors are quantized tensor-wise
        p["channel_wise"] = False
        p["group_size"] = None
    return quantize(
        arr,
        nbits=p["nbits"],
        channel_wise=p["channel_wise"],
        group_size=p["group_size"],
        optimize=bool(p["optimize"]),
        round_zero=bool(p["round_zero"]),
        axis=p["axis"],
        compute_dtype=torch.float32,
        meta_dtype=torch.float32,
    )


def resolve_meta(qt: QTensor) -> QTensor:
    """An equivalent QTensor whose scale and zero are plain tensors."""
    if not qt.is_meta_quantized:
        return qt
    scale, zero = qt.scale, qt.zero
    if isinstance(scale, QTensor):
        scale = dequantize(scale, torch.float32)
    if isinstance(zero, QTensor):
        zero = dequantize(zero, torch.float32)
    return dataclasses.replace(qt, scale=scale, zero=zero)


def _logical_rows(qt: QTensor) -> int:
    """Row count of the unpacked group-space matrix (before 3-bit padding)."""
    if qt.group_size is None or not qt.channel_wise:
        return qt.shape[0]
    if qt.axis == 0:
        return qt.group_size
    n = 1
    for s in qt.shape:
        n *= s
    return n // qt.group_size


def unpack_codes(qt: QTensor, dtype=torch.float32) -> torch.Tensor:
    """Unpack `wq` to integer codes in group space (padding removed)."""
    if qt.packing is None:
        return qt.wq.to(dtype)
    w_r = bitpack.unpack(qt.wq, qt.packing, dtype, blocks=qt.pack_blocks)
    rows = _logical_rows(qt)
    if w_r.shape[0] != rows:  # 3-bit zero padding
        w_r = w_r[:rows]
    return w_r


def dequantize(qt: QTensor, dtype=None) -> torch.Tensor:
    """(W_q - zero) * scale, reshaped to the original weight shape, in
    ``dtype`` (default the compute type); meta-quantized scale/zero are
    dequantized on the fly. Codes on a CUDA device go through the dequant
    kernel (`ops.fused_matmul.dequant_canonical`, bit-equal to the plain
    twin), codes on the CPU through `dequantize_plain`."""
    from ..ops.fused_matmul import dequant_canonical  # the ops import this module

    return dequant_canonical(qt, dtype)


def dequantize_plain(qt: QTensor, dtype=None) -> torch.Tensor:
    """Plain PyTorch `dequantize`: the codes widened to scale's type, then
    (W_q - zero) * scale, each operation rounded to the meta type."""
    qt = resolve_meta(qt)
    out_dtype = dtype if dtype is not None else qt.compute_dtype
    w_r = unpack_codes(qt, qt.scale.dtype)
    w_r = (w_r - qt.zero) * qt.scale
    return w_r.reshape(qt.shape).to(out_dtype)


def BaseQuantizeConfig(
    nbits: float = 4,
    group_size: Optional[int] = 64,
    quant_zero: bool = False,
    quant_scale: bool = False,
    offload_meta: bool = False,
    view_as_float: bool = False,
    axis: int = 1,
    round_zero: Optional[bool] = None,
    optimize: bool = True,
    compute_dtype=torch.bfloat16,
) -> dict:
    """Build a quant config dict. `quant_zero`/`quant_scale` quantize the
    zero/scale tensors themselves to 8 bits; `offload_meta` and
    `view_as_float` are accepted and ignored, as in `hqq_tpu`."""
    nbits = _canon_bits(nbits)
    if group_size is not None and group_size % 8 != 0:
        raise ValueError("group_size must be a multiple of 8 (or None)")
    if quant_zero or quant_scale:
        warnings.warn(
            "quant_zero/quant_scale (meta-quantization) are deprecated in "
            "reference HQQ; supported here for parity.",
            DeprecationWarning,
            stacklevel=2,
        )
    if offload_meta:
        warnings.warn("offload_meta has no effect; ignored.", stacklevel=2)

    weight_quant_params = {
        "nbits": nbits,
        "channel_wise": True,
        "group_size": group_size,
        "optimize": optimize,
        "round_zero": (nbits == 4) if round_zero is None else round_zero,
        "axis": axis,
        "compute_dtype": compute_dtype,
    }
    scale_quant_params = (
        {"nbits": 8, "channel_wise": True, "group_size": 128, "optimize": False}
        if quant_scale
        else None
    )
    zero_quant_params = (
        {"nbits": 8, "channel_wise": False, "group_size": None, "optimize": False}
        if quant_zero
        else None
    )
    return {
        "weight_quant_params": weight_quant_params,
        "scale_quant_params": scale_quant_params,
        "zero_quant_params": zero_quant_params,
        "offload_meta": False,
    }
