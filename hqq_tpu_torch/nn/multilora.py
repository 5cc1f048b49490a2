# SPDX-License-Identifier: Apache-2.0
"""Multi-LoRA serving: many adapters stacked over one quantized base, each
row of a batch served by its own adapter in one forward.

Mirrors `hqq_tpu.nn.multilora`. `MultiLoRALinear` holds ``a_stack
[n_adapters, in, r]`` and ``b_stack [n_adapters, r, out]``; the adapter of
each batch row comes from `adapter_context`, a binding around the forward,
so model code that calls a layer as ``layer(x)`` picks it up unchanged.
Adapter 0 is by convention the empty one (B = 0).

The base keeps its kernel (w4a8 on the decode path); the per-row term is a
gather of each row's A and B and two batched products (`torch.bmm`), the
library product where `hqq_tpu` has `jnp.einsum`, outside any kernel.

An id outside the stack is refused by the engines (`adapter_count`) before
any step: `hqq_tpu`'s `jnp.take` fills such a row with NaN, and torch's
gather would be a device-side assert on the card.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, List, Optional

import torch
from torch import nn

from .linear import _as_param

__all__ = ["MultiLoRALinear", "adapter_context", "current_adapter_ids", "stack_adapters",
           "adapter_count"]

# The per-row adapter ids ([B] int64) bound around a forward, innermost
# last, one stack a thread: a server's loop thread binds its batch's ids
# while other threads run forwards of their own on the same tree.
_BOUND = threading.local()


def _stack() -> List[torch.Tensor]:
    stack = getattr(_BOUND, "ids", None)
    if stack is None:
        stack = _BOUND.ids = []
    return stack


@contextlib.contextmanager
def adapter_context(ids):
    """Bind per-batch-row adapter ids for every `MultiLoRALinear` reached
    by the enclosed call on this thread. ``ids`` [B]: a tensor (on the layers' device for
    a forward on the card: no copy then) or anything `torch.as_tensor`
    takes."""
    stack = _stack()
    stack.append(torch.as_tensor(ids, dtype=torch.long))
    try:
        yield
    finally:
        stack.pop()


def current_adapter_ids() -> Optional[torch.Tensor]:
    """The ids bound innermost on this thread, or None."""
    stack = _stack()
    return stack[-1] if stack else None


class MultiLoRALinear(nn.Module):
    """A base layer (`QuantLinear`, `A8QuantLinear`, `Int8QuantLinear`,
    `Linear`, ...) plus a bank of LoRA adapters selected per row:

        out[b] = base(x[b]) + (x[b] @ A[ids[b]]) @ B[ids[b]] * scaling

    With no `adapter_context` bound it is the bare base."""

    def __init__(self, base: nn.Module, a_stack: torch.Tensor, b_stack: torch.Tensor,
                 scaling: float = 1.0):
        super().__init__()
        self.base = base
        self.a_stack = _as_param(a_stack)
        self.b_stack = _as_param(b_stack)
        self.scaling = float(scaling)

    @property
    def in_features(self) -> int:
        return self.base.in_features

    @property
    def out_features(self) -> int:
        return self.base.out_features

    @property
    def n_adapters(self) -> int:
        return self.a_stack.shape[0]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.base(x)
        ids = current_adapter_ids()
        if ids is None:
            return out
        ids = ids.to(self.a_stack.device)
        a = self.a_stack.index_select(0, ids)  # [B, in, r]
        b = self.b_stack.index_select(0, ids)  # [B, r, out]
        xf = x.to(self.a_stack.dtype)
        if x.ndim == 2:
            delta = torch.bmm(torch.bmm(xf[:, None], a), b)[:, 0]
        else:
            delta = torch.bmm(torch.bmm(xf, a), b)
        return out + (delta * self.scaling).to(out.dtype)

    def dequantize(self, dtype=None):
        if hasattr(self.base, "dequantize"):
            return self.base.dequantize(dtype)
        return self.base.weight


def _walk(tree: Any, path: str, fn) -> Any:
    """A new tree of dicts and lists, fn(path, node) at every other node."""
    if isinstance(tree, dict):
        return {k: _walk(v, f"{path}.{k}" if path else str(k), fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_walk(v, f"{path}.{i}" if path else str(i), fn) for i, v in enumerate(tree)]
    return fn(path, tree)


def stack_adapters(params_list: List[Any], base_params: Any, scaling: float = 1.0) -> Any:
    """A multi-adapter tree from N trees whose linear leaves are `LoRALinear`
    over the same base: adapter i of each stack is ``params_list[i]``'s at
    that path. The result is a new tree of dicts and lists over the leaves
    of ``base_params``, which stays as it is; a leaf that is not wrapped in
    every adapter tree is taken unchanged.

    ``base_params`` may be prepared (`prepare_for_inference` having swapped
    its leaves for `A8QuantLinear` and the like): the stack wraps whatever
    leaf sits at each adapter's path, so multi-LoRA serving keeps the fast
    decode kernels."""
    from ..core.peft import LoRALinear

    adapter_maps = []
    for tree in params_list:
        found = {}

        def visit(path, node, _found=found):
            if isinstance(node, LoRALinear):
                _found[path] = node
            return node

        _walk(tree, "", visit)
        adapter_maps.append(found)

    def convert(path, layer):
        wraps = [m.get(path) for m in adapter_maps]
        if not all(isinstance(w, LoRALinear) for w in wraps):
            return layer
        with torch.no_grad():
            a_stack = torch.stack([w.lora_a.data for w in wraps])
            b_stack = torch.stack([w.lora_b.data * w.scaling / scaling for w in wraps])
        return MultiLoRALinear(layer, a_stack, b_stack, scaling=scaling)

    return _walk(base_params, "", convert)


def adapter_count(params: Any) -> int:
    """How many adapters a request of ``params`` may name: the smallest
    stack of its `MultiLoRALinear` layers, 1 (adapter 0, the bare base)
    where it has none."""
    counts = []

    def visit(_, node):
        if isinstance(node, MultiLoRALinear):
            counts.append(node.n_adapters)
        return node

    _walk(params, "", visit)
    return min(counts, default=1)
