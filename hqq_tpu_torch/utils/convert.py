# SPDX-License-Identifier: Apache-2.0
"""Carry `hqq_tpu` parameters into this package.

`params_from_numpy` takes a parameter tree of `hqq_tpu` whose arrays have
been turned into numpy arrays (``jax.tree_util.tree_map(np.asarray, tree)``)
and returns the same tree in this package's types on ``device``. It reads
fields by attribute name only (``weight``, ``bias``, ``qweight``, a
QTensor's ``wq``/``scale``/``zero``/``nbits``/..., a LoRALinear's
``base``/``lora_a``/``lora_b``/``scaling``, a MultiLoRALinear's
``base``/``a_stack``/``b_stack``/``scaling``, an Int8QuantLinear's
``w8``/``sw``/``compute_dtype``/``logical_out``/``logical_in``, and the MoE
stacks, known by ``n_experts``: a GroupedLinear's ``weight``/``bias``, a
GroupedQuantLinear's ``wq``/``scale``/``zero`` and static fields), so it
imports nothing of `hqq_tpu`. A QTensor alone converts too. `paged_cache_from_numpy` carries a paged KV
cache across the same way (its pools and scales as numpy arrays).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..backends.int8_backend import Int8QuantLinear
from ..core.peft import LoRALinear
from ..core.quantize import QTensor
from ..nn.linear import Linear, QuantLinear
from ..nn.moe import GroupedLinear, GroupedQuantLinear
from ..nn.multilora import MultiLoRALinear
from ..ops.paged import PagedKVCache

__all__ = ["params_from_numpy", "paged_cache_from_numpy", "tensor_from_numpy", "torch_dtype"]


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy/JAX dtype or scalar type (by name)."""
    return getattr(torch, np.dtype(dtype).name)


def tensor_from_numpy(arr, device="cuda") -> torch.Tensor:
    """A numpy array (bfloat16 included) as a tensor on ``device``."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True, order="C")).to(device)


def _qtensor(qt: Any, device) -> QTensor:
    def meta(a):
        return _qtensor(a, device) if hasattr(a, "wq") else tensor_from_numpy(a, device)

    return QTensor(
        wq=tensor_from_numpy(qt.wq, device),
        scale=meta(qt.scale),
        zero=meta(qt.zero),
        nbits=qt.nbits,
        group_size=qt.group_size,
        axis=qt.axis,
        shape=tuple(qt.shape),
        packing=qt.packing,
        compute_dtype=torch_dtype(qt.compute_dtype),
        channel_wise=qt.channel_wise,
        pack_blocks=getattr(qt, "pack_blocks", 1),
    )


def params_from_numpy(tree: Any, device="cuda") -> Any:
    """Convert an `hqq_tpu` tree (numpy leaves) to this package's types:
    dicts and lists stay, arrays become tensors, ``Linear``,
    ``QuantLinear``, ``LoRALinear`` and ``MultiLoRALinear`` become their
    `nn.Module` counterparts (an ``Int8QuantLinear``, a ``GroupedLinear`` and
    a ``GroupedQuantLinear`` too), and a ``QTensor`` becomes
    this package's `QTensor`."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    if tree is None:
        return None
    if hasattr(tree, "a_stack"):
        return MultiLoRALinear(params_from_numpy(tree.base, device),
                               tensor_from_numpy(tree.a_stack, device),
                               tensor_from_numpy(tree.b_stack, device), tree.scaling)
    if hasattr(tree, "lora_a"):
        bias = None if tree.bias is None else tensor_from_numpy(tree.bias, device)
        return LoRALinear(params_from_numpy(tree.base, device),
                          tensor_from_numpy(tree.lora_a, device),
                          tensor_from_numpy(tree.lora_b, device), bias, tree.scaling,
                          getattr(tree, "dropout", 0.0))
    if hasattr(tree, "w8"):
        bias = None if tree.bias is None else tensor_from_numpy(tree.bias, device)
        return Int8QuantLinear(tensor_from_numpy(tree.w8, device), tensor_from_numpy(tree.sw, device),
                               bias, torch_dtype(tree.compute_dtype), tree.logical_out,
                               tree.logical_in)
    if hasattr(tree, "n_experts"):  # the MoE stacks, before the QTensor and Linear checks
        if hasattr(tree, "wq"):
            return GroupedQuantLinear(
                tensor_from_numpy(tree.wq, device), tensor_from_numpy(tree.scale, device),
                tensor_from_numpy(tree.zero, device), nbits=tree.nbits,
                group_size=tree.group_size, axis=tree.axis, shape=tuple(tree.shape),
                packing=tree.packing, compute_dtype=torch_dtype(tree.compute_dtype))
        bias = None if tree.bias is None else tensor_from_numpy(tree.bias, device)
        return GroupedLinear(tensor_from_numpy(tree.weight, device), bias)
    if hasattr(tree, "qweight"):
        bias = None if tree.bias is None else tensor_from_numpy(tree.bias, device)
        return QuantLinear(_qtensor(tree.qweight, device), bias)
    if hasattr(tree, "wq") and hasattr(tree, "packing"):
        return _qtensor(tree, device)
    if hasattr(tree, "weight"):
        bias = None if tree.bias is None else tensor_from_numpy(tree.bias, device)
        return Linear(tensor_from_numpy(tree.weight, device), bias)
    return tensor_from_numpy(tree, device)


def paged_cache_from_numpy(cache: Any, device="cuda") -> PagedKVCache:
    """An `hqq_tpu` ``PagedKVCache`` (numpy leaves) as this package's, on
    ``device``: the pools, the int8 pools' scales if any, the page size."""
    def opt(a):
        return None if a is None else tensor_from_numpy(a, device)

    return PagedKVCache(k=tensor_from_numpy(cache.k, device), v=tensor_from_numpy(cache.v, device),
                        k_scales=opt(cache.k_scales), v_scales=opt(cache.v_scales),
                        page_size=int(cache.page_size))
