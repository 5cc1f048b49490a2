# SPDX-License-Identifier: Apache-2.0
"""Inference preparation: swap quantized layers for fused backends.

Mirrors `hqq_tpu.utils.patching.prepare_for_inference`, with the backend
names of `hqq_tpu`:

    "xla"    keep `QuantLinear` (dequantize, on the card by the dequant
             kernel's canonical entry, then matmul)
    "pallas" `PallasQuantLinear` (the fused dequant-matmul kernel)
    "w4a8"   `A8QuantLinear` (int8 activations at M <= 32, the fused
             kernel above)
    "int8"   `Int8QuantLinear` (the weight quantized again to int8 per
             row, once; int8 activations per token; `torch._int_mm`)

Layers of either quantization axis convert under "pallas" and "w4a8"
(axis=0 takes the bf16-operand axis=0 kernel under both). A `LoRALinear`
over an axis=1 base becomes one fused module under "pallas"
(`PallasLoRAQuantLinear`) and "w4a8" (`A8LoRAQuantLinear`); otherwise its
base converts in place.

``backend`` may also be a {linear_tag: backend} dict; missing tags keep
"xla". Layers convert in place in the tree (see `models.base`). The MoE
expert stacks (`nn.moe.GroupedQuantLinear`) keep their canonical form under
every backend, as in `hqq_tpu`: their product is the grouped kernel's.

`fuse_for_decode` then joins each layer's q, k and v into one
``qkv_proj`` and gate and up into one ``gate_up_proj`` (`A8QuantLinear`,
`Int8QuantLinear` and `Linear`), so a decode step makes 4 matmul launches
a layer instead of 7. An OLMo-2 layer (``q_norm_flat``) stays as it is,
as in `hqq_tpu`: its q and k are normed over their own projections. The
other families read ``qkv_proj`` where it is: Phi-2 too, whose
`hqq_tpu` forward fails on a fused layer (`models.phi`). The layers the
LayerNorm families name otherwise (Falcon's and BLOOM's
``query_key_value``, GPT-2's ``c_attn``, the plain MLPs) stay as they are,
as do an MoE block's router and expert stacks (a Qwen3-MoE dense layer's
MLP joins). DeepSeek-V3's MLA projections have no q/k/v to join; its dense
layers' gate/up join (its forward reads ``gate_up_proj``, where `hqq_tpu`'s
raises), and the shared experts nested in its MoE blocks stay apart, as in
`hqq_tpu`.

Three helpers of `hqq_tpu.utils.patching` ride along: `auto_mix_plan` (a
per-tag backend plan under a memory budget), `lowrank_approx` (truncated
SVD factors) and `merge_zeros_into_lora` (a per-channel zero point as a
rank-1 term).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..backends.int8_backend import Int8QuantLinear, pad_for_mxu, patch_quantlinear_to_int8
from ..backends.pallas_backend import (
    A8QuantLinear,
    PallasQuantLinear,
    _patch_w4a8_any_axis,
    concat_a8_linears,
    patch_lora_to_pallas,
    patch_lora_to_w4a8,
    patch_quantlinear_to_pallas,
)
from ..core.peft import LoRALinear
from ..nn.linear import Linear, QuantLinear, concat_biases

__all__ = ["BACKENDS", "prepare_for_inference", "fuse_for_decode", "auto_mix_plan",
           "lowrank_approx", "merge_zeros_into_lora"]

BACKENDS = ("xla", "pallas", "w4a8", "int8")


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
        elif b == "int8":
            out = patch_quantlinear_to_int8(node)
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


def _concat_linears(layers):
    """The layers joined along their outputs, or None where the group mixes
    kinds or holds one that does not join (axis=0 kernel layouts, the LoRA
    kernel modules, `PallasQuantLinear`, `QuantLinear`, a padded
    `Int8QuantLinear`), as in `hqq_tpu`."""
    if all(isinstance(layer, A8QuantLinear) for layer in layers):
        return concat_a8_linears(layers)
    if all(isinstance(layer, Int8QuantLinear) for layer in layers):
        if any(layer.w8.shape != (layer.out_features, layer.in_features) for layer in layers):
            return None
        return Int8QuantLinear(
            torch.cat([layer.w8.data for layer in layers]),
            torch.cat([layer.sw.data for layer in layers]), concat_biases(layers),
            layers[0].compute_dtype)
    if all(type(layer) is Linear for layer in layers):
        return Linear(torch.cat([layer.weight.data for layer in layers]), concat_biases(layers))
    return None


def fuse_for_decode(params, pad_to: int = 8):
    """Join each layer's q/k/v into ``qkv_proj`` and gate/up into
    ``gate_up_proj`` (`_concat_linears`; groups that do not join stay as
    they are); then pad every `Int8QuantLinear` to multiples of ``pad_to``
    (0: none). Run after `prepare_for_inference`. Returns a new tree over
    the same leaves and the fused layers.

    ``pad_to``: `hqq_tpu` pads int8 weights to 512, a TPU tiling rule; the
    H100 has no such rule, and `torch._int_mm` needs multiples of 8, which
    Llama's widths (4096, 11008, 12288, 22016) already are: the default
    adds no byte at those widths. 512 gives `hqq_tpu`'s shapes; the
    outputs are the same either way (zero rows and columns). Only a value
    other than 8 changes a tree that `prepare_for_inference` built:
    `patch_quantlinear_to_int8` already pads to 8, and `_concat_linears`
    joins only unpadded layers, so every fused width is a multiple of 8
    too. The fused w4a8 width is not padded (see `concat_a8_linears`)."""

    def fuse_layer(layer: dict) -> dict:
        out = dict(layer)
        sa = layer.get("self_attn")
        if isinstance(sa, dict) and "q_norm_flat" in sa:
            return out  # OLMo-2 norms q and k over their own projections: the layer stays
        if isinstance(sa, dict) and all(k in sa for k in ("q_proj", "k_proj", "v_proj")):
            fused = _concat_linears([sa["q_proj"], sa["k_proj"], sa["v_proj"]])
            if fused is not None:
                sa = {k: v for k, v in sa.items() if k not in ("q_proj", "k_proj", "v_proj")}
                sa["qkv_proj"] = fused
            out["self_attn"] = sa
        mlp = layer.get("mlp")
        if isinstance(mlp, dict) and all(k in mlp for k in ("gate_proj", "up_proj")):
            fused = _concat_linears([mlp["gate_proj"], mlp["up_proj"]])
            if fused is not None:
                mlp = {k: v for k, v in mlp.items() if k not in ("gate_proj", "up_proj")}
                mlp["gate_up_proj"] = fused
            out["mlp"] = mlp
        return out

    out = dict(params)
    if "layers" in out:
        out["layers"] = [fuse_layer(layer) for layer in out["layers"]]

    def pad(node):
        if isinstance(node, dict):
            return {k: pad(v) for k, v in node.items()}
        if isinstance(node, list):
            return [pad(v) for v in node]
        return pad_for_mxu(node, pad_to) if isinstance(node, Int8QuantLinear) else node

    return pad(out) if pad_to else out


def auto_mix_plan(params: Any, hbm_budget_bytes: Optional[int] = None,
                  reserve_bytes: int = 0) -> Dict[str, str]:
    """A per-tag backend plan for `prepare_for_inference`, as `hqq_tpu`
    builds it: every tag of a quantized leaf on "int8" (about 1 byte a
    weight, the faster prefill), then the tags with the most weights moved
    to "w4a8" (counted as K*N/2 bytes of codes and 8 bytes of fp32 scale
    and zs a group) until the weights fit ``hbm_budget_bytes`` less
    ``reserve_bytes`` (the KV pool, activations). No budget: all "int8"."""
    from ..models.base import iter_linears, name_to_linear_tag

    sizes: Dict[str, tuple] = {}  # tag -> (int8 bytes, w4a8 bytes)
    for path, node in iter_linears(params):
        if not isinstance(node, QuantLinear):
            continue
        tag = name_to_linear_tag(path)
        n, k = node.qweight.shape
        g = node.qweight.group_size or 64
        p_int8, p_w4a8 = sizes.get(tag, (0, 0))
        sizes[tag] = (p_int8 + n * k, p_w4a8 + n * k // 2 + (n * k // max(g, 1)) * 8)
    plan = {tag: "int8" for tag in sizes}
    if hbm_budget_bytes is None:
        return plan

    def footprint():
        return sum(sizes[t][0] if plan[t] == "int8" else sizes[t][1] for t in sizes)

    budget = hbm_budget_bytes - reserve_bytes
    for tag in sorted(sizes, key=lambda t: sizes[t][0], reverse=True):
        if footprint() <= budget:
            break
        plan[tag] = "w4a8"
    return plan


def lowrank_approx(w: torch.Tensor, max_rank: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The best rank-r factors of a 2-D W [out, in] by truncated SVD, in
    fp32: (A [in, r], B [r, out]) with W^T ~= A @ B, r = min(max_rank,
    min(out, in)). A singular vector's sign is the solver's own, so the
    factors match `hqq_tpu`'s up to a sign per rank; A @ B does not depend
    on it."""
    u, s, vt = torch.linalg.svd(w.detach().to(torch.float32).t(), full_matrices=False)
    r = min(int(max_rank), s.shape[0])
    return u[:, :r] * s[:r][None, :], vt[:r, :]


def merge_zeros_into_lora(layer: QuantLinear, rank_pad: int = 1
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The zero point of a per-channel (group_size = in_features) axis=1
    layer as a rank-1 term: W_dq = c*scale - zero*scale, so x @ W_dq^T =
    x @ (c*scale)^T + (x @ a) @ b with a = ones [in, 1] and b = -(zero *
    scale) [1, out], both fp32. Returns (a, b). Other layouts raise a
    ValueError (`hqq_tpu` asserts). ``rank_pad`` is `hqq_tpu`'s argument,
    unused there and here."""
    from ..core.quantize import resolve_meta

    qt = layer.qweight
    if qt.axis != 1 or qt.group_size != qt.shape[1]:
        raise ValueError("zero-folding requires per-channel (group_size == in_features) "
                         f"axis=1; got axis={qt.axis}, group_size={qt.group_size}, "
                         f"shape={qt.shape}")
    qt = resolve_meta(qt)
    zs = (qt.zero * qt.scale).reshape(qt.shape[0])
    a = torch.ones((qt.shape[1], 1), dtype=torch.float32, device=zs.device)
    return a, -zs[None, :].to(torch.float32)
