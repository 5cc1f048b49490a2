# SPDX-License-Identifier: Apache-2.0
"""Fused-kernel inference backends.

Mirrors `hqq_tpu.backends.pallas_backend`: converts a quantized `QuantLinear`
into a module whose forward is one fused kernel, through a one-time repack
into the kernel layout (`ops.fused_matmul.to_kernel_layout`). The names
``pallas`` and ``w4a8`` are kept from `hqq_tpu`; here they run the CUDA
kernels of ``csrc/``. Conversion is driven by
`hqq_tpu_torch.utils.patching.prepare_for_inference`.

Axis=1 layers convert to `KernelQTensor`, axis=0 layers to `KernelQTensor0`
(under ``w4a8`` too, where they take the bf16-operand axis=0 kernel), and a
`LoRALinear` over an axis=1 base converts to a module whose one kernel holds
the adapter as well. `concat_a8_linears` joins axis=1 `A8QuantLinear`s
along their output rows (`utils.patching.fuse_for_decode`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ..nn.linear import QuantLinear, _as_param, concat_biases
from ..ops.fused_matmul import (
    _KERNEL_CONTAINER_BITS,
    KernelQTensor,
    KernelQTensor0,
    dequant_pallas,
    quant_matmul_pallas,
    quant_matmul_pallas_a8,
    quant_matmul_pallas_a8_lora,
    quant_matmul_pallas_lora,
    supports_kernel_layout,
    supports_kernel_layout_ax0,
    to_kernel_layout,
    to_kernel_layout_ax0,
)

__all__ = [
    "PallasQuantLinear",
    "A8QuantLinear",
    "PallasLoRAQuantLinear",
    "A8LoRAQuantLinear",
    "patch_quantlinear_to_pallas",
    "patch_quantlinear_to_w4a8",
    "patch_lora_to_pallas",
    "patch_lora_to_w4a8",
    "concat_a8_linears",
]


class _KernelLinear(nn.Module):
    """A kernel-layout weight plus an optional bias."""

    def __init__(self, kqt: "KernelQTensor | KernelQTensor0",
                 bias: Optional[torch.Tensor] = None):
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


def _ax0_meta_dtype(qt, meta_dtype=None):
    """Storage type of scale and zs for an axis=0 kernel layout. None takes
    `hqq_tpu`'s policy, kept so that both packages serve the same numbers:
    bf16 for the configs with fewer than 8 packed rows per group (2-bit g16,
    1-bit g16 and g32), where scale and zs outweigh the codes, fp32
    otherwise. bf16 rounds each weight by about 5e-3 of its size."""
    if meta_dtype is not None:
        return meta_dtype
    r = 8 // _KERNEL_CONTAINER_BITS[qt.nbits]
    return torch.bfloat16 if (r > 1 and qt.group_size // r < 8) else torch.float32


def _to_any_layout(qt, meta_dtype=None):
    """The kernel layout of ``qt`` for its axis, or None if it has none.
    Axis=1 stores scale and zs in ``meta_dtype`` (fp32 when None, as in
    `hqq_tpu`), axis=0 by `_ax0_meta_dtype`."""
    if supports_kernel_layout(qt):
        return to_kernel_layout(qt, meta_dtype or torch.float32)
    if supports_kernel_layout_ax0(qt):
        return to_kernel_layout_ax0(qt, _ax0_meta_dtype(qt, meta_dtype))
    return None


def patch_quantlinear_to_pallas(layer: QuantLinear,
                                meta_dtype=None) -> "PallasQuantLinear | QuantLinear":
    """Convert a `QuantLinear` of either axis to the fused backend; returns
    the layer unchanged when its config fits no kernel layout."""
    kqt = _to_any_layout(layer.qweight, meta_dtype)
    return layer if kqt is None else PallasQuantLinear(kqt, layer.bias)


def patch_quantlinear_to_w4a8(layer: QuantLinear,
                              meta_dtype=None) -> "A8QuantLinear | QuantLinear":
    """Convert an axis=1 `QuantLinear` to the W4A8 backend; returns the
    layer unchanged when its config does not fit the kernel layout."""
    if not supports_kernel_layout(layer.qweight):
        return layer
    return A8QuantLinear(_to_any_layout(layer.qweight, meta_dtype), layer.bias)


def _patch_w4a8_any_axis(layer: QuantLinear, meta_dtype=None) -> "A8QuantLinear | QuantLinear":
    """w4a8 conversion for both axes: axis=1 gets the int8 kernel; axis=0
    gets the bf16-operand axis=0 kernel, to which `quant_matmul_pallas_a8`
    sends a `KernelQTensor0`."""
    kqt = _to_any_layout(layer.qweight, meta_dtype)
    return layer if kqt is None else A8QuantLinear(kqt, layer.bias)


def concat_a8_linears(layers) -> "A8QuantLinear | None":
    """One `A8QuantLinear` computing the outputs of ``layers`` side by side
    (q, k and v; gate and up), or None where they do not join.

    The axis=1 layout holds W row-major by output (wq [N, K*cb/8], scale
    and zs [N, C]), so the layers join along dim 0; `hqq_tpu`'s layout is
    [K, N] and joins its axis 1. They must share K, the group, the
    container, the code width and the type and columns of scale and zs
    (bf16 pads C to a multiple of 8, the same for a shared K). Axis=0
    layouts do not join: their scale and zs rows repeat every N/g rows.
    The fused N is not padded (`hqq_tpu` pads it to 512 lanes, a TPU tiling
    rule): the launch plans take any N. A missing bias among biased layers
    is zeros."""
    kqts = [layer.kqt for layer in layers]
    k0 = kqts[0]
    if not all(isinstance(layer, A8QuantLinear) and isinstance(kq, KernelQTensor)
               and kq.k == k0.k and kq.group_size == k0.group_size
               and kq.container_bits == k0.container_bits and kq.nbits == k0.nbits
               and kq.compute_dtype == k0.compute_dtype and kq.scale.dtype == k0.scale.dtype
               and kq.scale.shape[1] == k0.scale.shape[1] and kq.wq.shape[1] == k0.wq.shape[1]
               for layer, kq in zip(layers, kqts)):
        return None
    fused = dataclasses.replace(
        k0, wq=torch.cat([kq.wq for kq in kqts]), scale=torch.cat([kq.scale for kq in kqts]),
        zs=torch.cat([kq.zs for kq in kqts]), shape=(k0.k, sum(kq.n for kq in kqts)))
    return A8QuantLinear(fused, concat_biases(layers))


class _KernelLoRALinear(nn.Module):
    """A kernel-layout weight, LoRA factors a [K, r] and b [r, N] (the
    adapter's scaling folded into b, both fp32) and an optional bias.

    ``a`` is the one copy of A the layer keeps: the LoRA kernel's A^T
    (`lora_a_kernel_layout` in x's type) is made from it by
    `quant_matmul_lora` at each launch, two small copies of r * K values,
    and the int8 decode route reads ``a`` itself. So an adapter loaded into
    ``a`` (by `load_state_dict`, ``a.data.copy_``, an optimizer) is served
    at every M alike."""

    def __init__(self, kqt: KernelQTensor, a: torch.Tensor, b: torch.Tensor,
                 bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.kqt = kqt
        self.a = _as_param(a)
        self.b = _as_param(b)
        self.bias = _as_param(bias)

    @property
    def in_features(self) -> int:
        return self.kqt.k

    @property
    def out_features(self) -> int:
        return self.kqt.n

    def _add_bias(self, out: torch.Tensor) -> torch.Tensor:
        return out if self.bias is None else out + self.bias.to(out.dtype)


class PallasLoRAQuantLinear(_KernelLoRALinear):
    """HQQ+ serving layer: the dequant-matmul and the adapter in one kernel
    (`quant_matmul_pallas_lora`)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._add_bias(quant_matmul_pallas_lora(x, self.kqt, self.a, self.b))


class A8LoRAQuantLinear(_KernelLoRALinear):
    """HQQ+ on the w4a8 path: the int8 decode kernel with the adapter in its
    epilogue (`quant_matmul_pallas_a8_lora`); the adapter sees the
    activations at full precision."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._add_bias(
            quant_matmul_pallas_a8_lora(x, self.kqt, self.a, self.b))


def _patch_lora(lora, cls):
    base = lora.base
    if not (isinstance(base, QuantLinear) and supports_kernel_layout(base.qweight)):
        return lora
    bias = base.bias
    if lora.bias is not None:
        bias = lora.bias if bias is None else bias + lora.bias
    fp32 = torch.float32
    return cls(to_kernel_layout(base.qweight), lora.lora_a.data.to(fp32),
               lora.lora_b.data.to(fp32) * lora.scaling, None if bias is None else bias.data)


def patch_lora_to_pallas(lora) -> "PallasLoRAQuantLinear | nn.Module":
    """`LoRALinear` over an axis=1 `QuantLinear` -> one fused module (the
    biases merged, the scaling folded into b); returns the input unchanged
    when the base does not fit the kernel layout (the base then converts on
    its own)."""
    return _patch_lora(lora, PallasLoRAQuantLinear)


def patch_lora_to_w4a8(lora) -> "A8LoRAQuantLinear | nn.Module":
    """As `patch_lora_to_pallas`, for the w4a8 path."""
    return _patch_lora(lora, A8LoRAQuantLinear)
