# SPDX-License-Identifier: Apache-2.0
"""Checkpoints: parameter trees <-> sharded safetensors plus a JSON sidecar.

Mirrors `hqq_tpu.models.serialize` and writes its format, ``hqq_tpu.v1``,
letter for letter: the tree's structure and static metadata (quant
configs, dtype names such as ``"bfloat16"``, shapes) go into
``hqq_config.json``; the tensors go into ``model-XXXXX-of-YYYYY.safetensors``
files under dotted-path keys (a QTensor's ``W_q``/``scale``/``zero``, a
meta-quantized scale or zero as a ``scale_q``/``zero_q`` subtree), split
greedily at ``max_shard_bytes`` in the tree's order. A checkpoint written by
either package loads in the other.

Nodes: dicts, lists, None, tensors, `Linear`, `QuantLinear`, `QTensor`
(meta-quantized too), `LoRALinear`, the MoE stacks and the int8 backend's
`Int8QuantLinear` (``w8``, ``sw``, its bias and its logical sizes, as
`hqq_tpu` names them; trees fused by `fuse_for_decode` hold no other kind).
The MoE experts' stacks: `GroupedLinear` (its
``weight`` [E, out, in] and ``bias`` children) and `GroupedQuantLinear`
(``W_q``, ``scale`` and ``zero`` with a leading E, and the per-expert
nbits, group size, axis, shape, packing and compute dtype), as `hqq_tpu`
writes them. Kernel-layout modules (the backends'
`PallasQuantLinear`, `A8QuantLinear` and their LoRA peers) and `hqq_tpu`'s
kernel-layout nodes are refused with a `TypeError` both ways: the two
packages' kernel layouts differ, so a checkpoint is saved before
`prepare_for_inference` and prepared again after loading. Unknown node
types raise.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..backends.int8_backend import Int8QuantLinear
from ..core.peft import LoRALinear
from ..core.quantize import QTensor
from ..nn.linear import Linear, QuantLinear
from ..nn.moe import GroupedLinear, GroupedQuantLinear
from ._safetensors import SafeTensorsFile, save_file

__all__ = ["FORMAT", "tree_to_state", "state_to_tree", "save_checkpoint", "load_checkpoint"]

FORMAT = "hqq_tpu.v1"

# kernel-layout node types, of this package and of hqq_tpu
_KERNEL_NODES = ("PallasQuantLinear", "A8QuantLinear", "PallasLoRAQuantLinear",
                 "A8LoRAQuantLinear", "KernelQTensor", "KernelQTensor0")


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).removeprefix("torch.")


def _dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt


def _nbits(nbits):
    """nbits as the sidecar holds it: an int, or a float for 1.58 bits."""
    return int(nbits) if float(nbits).is_integer() else float(nbits)


def _kernel_node_error(kind: str, path: str) -> TypeError:
    return TypeError(f"{kind} at {path!r} is a kernel layout, which checkpoints do not hold: "
                     f"save before prepare_for_inference, and prepare again after loading")


def tree_to_state(tree: Any, prefix: str = "") -> Tuple[Dict[str, torch.Tensor], Any]:
    """Flatten a parameter tree into (tensors by dotted path, JSON-able
    structure). Unknown leaf types and kernel layouts raise `TypeError`."""
    flat: Dict[str, torch.Tensor] = {}

    def sub(path, key):
        return f"{path}.{key}" if path else str(key)

    def rec(node, path):
        if node is None:
            return {"type": "none"}
        if isinstance(node, dict):
            return {"type": "dict",
                    "children": {k: rec(v, sub(path, k)) for k, v in node.items()}}
        if isinstance(node, (list, tuple)):
            return {"type": "list",
                    "children": [rec(v, sub(path, i)) for i, v in enumerate(node)]}
        if type(node).__name__ in _KERNEL_NODES:
            raise _kernel_node_error(type(node).__name__, path)
        if isinstance(node, QuantLinear):
            return {"type": "QuantLinear",
                    "children": {"qweight": rec(node.qweight, f"{path}.qweight"),
                                 "bias": rec(node.bias, f"{path}.bias")}}
        if isinstance(node, Int8QuantLinear):
            flat[f"{path}.w8"] = node.w8.detach()
            flat[f"{path}.sw"] = node.sw.detach()
            return {"type": "Int8QuantLinear",
                    "meta": {"compute_dtype": _dtype_name(node.compute_dtype),
                             "logical_out": node.logical_out,
                             "logical_in": node.logical_in},
                    "children": {"bias": rec(node.bias, f"{path}.bias")}}
        if isinstance(node, LoRALinear):
            return {"type": "LoRALinear",
                    "meta": {"scaling": node.scaling, "dropout": node.dropout},
                    "children": {"base": rec(node.base, f"{path}.base"),
                                 "lora_a": rec(node.lora_a, f"{path}.lora_a"),
                                 "lora_b": rec(node.lora_b, f"{path}.lora_b"),
                                 "bias": rec(node.bias, f"{path}.bias")}}
        if isinstance(node, (Linear, GroupedLinear)):
            return {"type": type(node).__name__,
                    "children": {"weight": rec(node.weight, f"{path}.weight"),
                                 "bias": rec(node.bias, f"{path}.bias")}}
        if isinstance(node, GroupedQuantLinear):
            flat[f"{path}.W_q"] = node.wq
            flat[f"{path}.scale"] = node.scale
            flat[f"{path}.zero"] = node.zero
            return {"type": "GroupedQuantLinear",
                    "meta": {"nbits": _nbits(node.nbits),
                             "group_size": node.group_size,
                             "axis": node.axis,
                             "shape": [int(s) for s in node.shape],
                             "packing": node.packing,
                             "compute_dtype": _dtype_name(node.compute_dtype)}}
        if isinstance(node, QTensor):
            # W_q, scale and zero as the reference HQQ's state_dict names
            # them; a meta-quantized scale or zero recurses
            flat[f"{path}.W_q"] = node.wq
            children = {}
            if isinstance(node.scale, QTensor):
                children["scale_q"] = rec(node.scale, f"{path}.scale_q")
            else:
                flat[f"{path}.scale"] = node.scale
            if isinstance(node.zero, QTensor):
                children["zero_q"] = rec(node.zero, f"{path}.zero_q")
            else:
                flat[f"{path}.zero"] = node.zero
            return {"type": "QTensor",
                    "children": children,
                    "meta": {"nbits": _nbits(node.nbits),
                             "group_size": node.group_size,
                             "axis": node.axis,
                             "shape": [int(s) for s in node.shape],
                             "packing": node.packing,
                             "compute_dtype": _dtype_name(node.compute_dtype),
                             "channel_wise": node.channel_wise,
                             "pack_blocks": node.pack_blocks}}
        if isinstance(node, torch.Tensor):
            flat[path] = node.detach()
            return {"type": "array", "dtype": _dtype_name(node.dtype)}
        raise TypeError(f"Unsupported leaf at {path!r}: {type(node)}")

    structure = rec(tree, prefix)
    return flat, structure


def state_to_tree(structure: Any, get: Callable[[str], torch.Tensor], prefix: str = "") -> Any:
    """Rebuild a parameter tree from a structure and a getter of tensors by
    dotted path. Kernel-layout and unknown node types raise `TypeError`."""

    def sub(path, key):
        return f"{path}.{key}" if path else str(key)

    def rec(node, path):
        t = node["type"]
        ch = node.get("children") or {}
        if t == "none":
            return None
        if t == "dict":
            return {k: rec(v, sub(path, k)) for k, v in ch.items()}
        if t == "list":
            return [rec(v, sub(path, i)) for i, v in enumerate(ch)]
        if t in _KERNEL_NODES:
            raise _kernel_node_error(t, path)
        if t == "QuantLinear":
            return QuantLinear(rec(ch["qweight"], f"{path}.qweight"), rec(ch["bias"], f"{path}.bias"))
        if t == "Int8QuantLinear":
            m = node.get("meta") or {}
            w8, sw = get(f"{path}.w8"), get(f"{path}.sw")
            if (w8.dtype != torch.int8 or w8.ndim != 2 or tuple(sw.shape) != (w8.shape[0], 1)
                    or "compute_dtype" not in m or "bias" not in ch):
                raise TypeError(f"Int8QuantLinear at {path!r} needs an int8 w8 [N, K], an sw "
                                f"[N, 1], a bias child and its compute_dtype; got w8 "
                                f"{w8.dtype} {tuple(w8.shape)}, sw {tuple(sw.shape)}")
            return Int8QuantLinear(w8, sw, rec(ch["bias"], f"{path}.bias"),
                                   _dtype(m["compute_dtype"]), m.get("logical_out"),
                                   m.get("logical_in"))
        if t == "LoRALinear":
            return LoRALinear(rec(ch["base"], f"{path}.base"), rec(ch["lora_a"], f"{path}.lora_a"),
                              rec(ch["lora_b"], f"{path}.lora_b"), rec(ch["bias"], f"{path}.bias"),
                              scaling=node["meta"]["scaling"], dropout=node["meta"]["dropout"])
        if t == "Linear":
            return Linear(rec(ch["weight"], f"{path}.weight"), rec(ch["bias"], f"{path}.bias"))
        if t == "GroupedLinear":
            if "weight" not in ch or "bias" not in ch:
                raise TypeError(f"GroupedLinear at {path!r} needs weight and bias children")
            weight = rec(ch["weight"], f"{path}.weight")
            if not isinstance(weight, torch.Tensor) or weight.ndim != 3:
                raise TypeError(f"GroupedLinear at {path!r} needs a weight [E, out, in]")
            return GroupedLinear(weight, rec(ch["bias"], f"{path}.bias"))
        if t == "GroupedQuantLinear":
            m = node.get("meta") or {}
            missing = {"nbits", "group_size", "axis", "shape", "packing",
                       "compute_dtype"} - set(m)
            wq, scale, zero = (get(f"{path}.{n}") for n in ("W_q", "scale", "zero"))
            if missing or wq.ndim != 3 or scale.ndim != 3 or zero.shape != scale.shape \
                    or scale.shape[0] != wq.shape[0]:
                raise TypeError(f"GroupedQuantLinear at {path!r} needs W_q, scale and zero "
                                f"with a leading E and its meta; missing {sorted(missing)}, "
                                f"got W_q {tuple(wq.shape)}, scale {tuple(scale.shape)}")
            return GroupedQuantLinear(wq, scale, zero, nbits=_nbits(m["nbits"]),
                                      group_size=m["group_size"], axis=m["axis"],
                                      shape=tuple(m["shape"]), packing=m["packing"],
                                      compute_dtype=_dtype(m["compute_dtype"]))
        if t == "QTensor":
            m = node["meta"]
            scale = rec(ch["scale_q"], f"{path}.scale_q") if "scale_q" in ch else get(f"{path}.scale")
            zero = rec(ch["zero_q"], f"{path}.zero_q") if "zero_q" in ch else get(f"{path}.zero")
            return QTensor(wq=get(f"{path}.W_q"), scale=scale, zero=zero, nbits=_nbits(m["nbits"]),
                           group_size=m["group_size"], axis=m["axis"], shape=tuple(m["shape"]),
                           packing=m["packing"], compute_dtype=_dtype(m["compute_dtype"]),
                           channel_wise=m.get("channel_wise", True),
                           pack_blocks=m.get("pack_blocks", 1))
        if t == "array":
            return get(path)
        raise TypeError(f"Unknown node type {t!r} at {path!r}")

    return rec(structure, prefix)


def save_checkpoint(save_dir: str, params: Any, config: Optional[dict] = None,
                    max_shard_bytes: int = 4 * 1024**3) -> None:
    """Write ``params`` as sharded safetensors plus the ``hqq_config.json``
    sidecar (format, structure, ``config``, weight map). Tensors are copied
    to the host one at a time as their shard is written."""
    flat, structure = tree_to_state(params)
    os.makedirs(save_dir, exist_ok=True)

    shards: list = [{}]
    size = 0
    for k, v in flat.items():
        nbytes = v.numel() * v.element_size()
        if size + nbytes > max_shard_bytes and shards[-1]:
            shards.append({})
            size = 0
        shards[-1][k] = v
        size += nbytes

    weight_map = {}
    for i, shard in enumerate(shards):
        fname = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        save_file(shard, os.path.join(save_dir, fname))
        weight_map.update(dict.fromkeys(shard, fname))

    with open(os.path.join(save_dir, "hqq_config.json"), "w") as f:
        json.dump({"format": FORMAT, "structure": structure, "config": config or {},
                   "weight_map": weight_map}, f, indent=1)


def load_checkpoint(save_dir: str, device="cuda") -> Tuple[Any, dict]:
    """(params, config) of a checkpoint written by `save_checkpoint` or by
    `hqq_tpu`'s; each tensor is moved to ``device`` as it is read."""
    with open(os.path.join(save_dir, "hqq_config.json")) as f:
        index = json.load(f)
    if index.get("format", FORMAT) != FORMAT:
        raise ValueError(f"{save_dir}: format {index['format']!r}, expected {FORMAT!r}")
    files = {fname: SafeTensorsFile(os.path.join(save_dir, fname))
             for fname in sorted(set(index["weight_map"].values()))}
    try:
        params = state_to_tree(index["structure"],
                               lambda path: files[index["weight_map"][path]].get(path, device))
    finally:
        for f in files.values():
            f.close()
    return params, index.get("config", {})
