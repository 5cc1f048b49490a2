# SPDX-License-Identifier: Apache-2.0
"""The safetensors file format, read and written with torch alone.

A file is 8 bytes of little-endian header length, a JSON header mapping
each tensor's name to ``{"dtype", "shape", "data_offsets"}`` (plus an
optional ``"__metadata__"`` of strings), padded with spaces to a multiple
of 8 bytes, then the tensors' raw C-order bytes, back to back with no gap.
Files written here load with the ``safetensors`` package and the reverse;
the package itself is not needed.

Reading maps the file (`mmap`) and wraps each tensor's bytes with
`torch.frombuffer`; `SafeTensorsFile.get` copies one tensor at a time to
its device, so a load never holds a second host copy of a checkpoint.
"""

from __future__ import annotations

import json
import math
import mmap
import os
import struct
from typing import Dict

import torch

__all__ = ["DTYPES", "save_file", "load_file", "SafeTensorsFile"]

# the format's dtype codes
DTYPES = {
    "BF16": torch.bfloat16,
    "F16": torch.float16,
    "F32": torch.float32,
    "F64": torch.float64,
    "U8": torch.uint8,
    "I8": torch.int8,
    "I16": torch.int16,
    "I32": torch.int32,
    "U32": torch.uint32,
    "I64": torch.int64,
    "BOOL": torch.bool,
}
_CODES = {dt: code for code, dt in DTYPES.items()}


def save_file(tensors: Dict[str, torch.Tensor], path: str) -> None:
    """Write ``tensors`` (any device, any strides) to ``path``. Tensors go
    in order of element size, largest first, then by name, as the
    ``safetensors`` package orders them, so that each starts aligned to its
    element size."""
    order = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header: dict = {}
    offset = 0
    for name in order:
        t = tensors[name]
        if t.dtype not in _CODES:
            raise TypeError(f"{name!r}: dtype {t.dtype} has no safetensors code")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _CODES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for name in order:
            t = tensors[name].detach()
            if t.numel():
                f.write(t.to("cpu").contiguous().reshape(-1).view(torch.uint8).numpy())


class SafeTensorsFile:
    """One safetensors file, mapped: ``keys()``, ``metadata``, and
    ``get(name, device)``. Use it as a context manager, or call `close`."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
            self._base = 8 + n
            self.metadata = header.pop("__metadata__", None) or {}
            data_bytes = os.fstat(f.fileno()).st_size - self._base
            for name, e in header.items():
                begin, end = e["data_offsets"]
                if e["dtype"] not in DTYPES:
                    raise ValueError(f"{path}: {name!r} has unknown dtype {e['dtype']!r}")
                if end - begin != math.prod(e["shape"]) * DTYPES[e["dtype"]].itemsize or \
                        not 0 <= begin <= end <= data_bytes:
                    raise ValueError(f"{path}: {name!r} has offsets {e['data_offsets']} that "
                                     f"do not fit its shape {e['shape']} or the file")
            self._entries = header
            # a private, copy-on-write map: writable, as torch.frombuffer
            # wants, and never written back
            self._map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)

    def keys(self):
        return list(self._entries)

    def get(self, name: str, device="cpu") -> torch.Tensor:
        """Tensor ``name`` on ``device``, in memory of its own (not the map)."""
        e = self._entries[name]
        dtype, shape = DTYPES[e["dtype"]], tuple(e["shape"])
        begin, end = e["data_offsets"]
        if end == begin:
            return torch.empty(shape, dtype=dtype, device=device)
        raw = torch.frombuffer(self._map, dtype=torch.uint8, count=end - begin,
                               offset=self._base + begin)
        if (self._base + begin) % dtype.itemsize:
            raw = raw.clone()  # an aligned copy: the view below must start aligned
        t = raw.view(dtype).reshape(shape)
        return t.to(device, copy=True)

    def close(self) -> None:
        self._map.close()

    def __enter__(self) -> "SafeTensorsFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def load_file(path: str, device="cpu") -> Dict[str, torch.Tensor]:
    """Every tensor of ``path``, each moved to ``device`` as it is read."""
    with SafeTensorsFile(path) as f:
        return {name: f.get(name, device) for name in f.keys()}
