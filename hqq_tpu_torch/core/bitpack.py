# SPDX-License-Identifier: Apache-2.0
"""Bit-packing for quantized weights (PyTorch).

Mirrors `hqq_tpu.core.bitpack`: integer codes of a 2-D group-space matrix
are packed along axis 0 into uint8 / int32 containers. The matrix is split
into ``r`` equal row-chunks (r = values per container word) and chunk ``k``
occupies bitfield ``k``, most-significant first. The bytes are identical to
`hqq_tpu`'s, so a checkpoint's packed codes mean the same in both packages:

    4bit_u8: 2 vals/byte,   p = W[:s]<<4 | W[s:]
    2bit_u8: 4 vals/byte,   bitfields 6,4,2,0
    1bit_u8: 8 vals/byte,   bitfields 7..0
    3bit_32: 10 vals/int32, rows zero-padded to a multiple of 10, bitfields 27..0
    8bit_u8: identity cast
"""

from __future__ import annotations

import torch

__all__ = [
    "pack",
    "unpack",
    "packed_rows",
    "unpacked_rows",
    "PACKING_CONTAINER",
    "VALS_PER_WORD",
    "FIELD_BITS",
]

# packing name -> container dtype
PACKING_CONTAINER = {
    "8bit_u8": torch.uint8,
    "4bit_u8": torch.uint8,
    "3bit_32": torch.int32,
    "2bit_u8": torch.uint8,
    "1bit_u8": torch.uint8,
}

# packing name -> number of values per container word
VALS_PER_WORD = {
    "8bit_u8": 1,
    "4bit_u8": 2,
    "3bit_32": 10,
    "2bit_u8": 4,
    "1bit_u8": 8,
}

# packing name -> bits per bitfield
FIELD_BITS = {
    "8bit_u8": 8,
    "4bit_u8": 4,
    "3bit_32": 3,
    "2bit_u8": 2,
    "1bit_u8": 1,
}


def packed_rows(n_rows: int, packing: str) -> int:
    """Number of container rows used to store ``n_rows`` unpacked rows."""
    r = VALS_PER_WORD[packing]
    return -(-n_rows // r)


def unpacked_rows(n_packed_rows: int, packing: str) -> int:
    """Number of rows produced by ``unpack`` (includes 3-bit padding)."""
    return n_packed_rows * VALS_PER_WORD[packing]


def _pack_blocks(w: torch.Tensor, packing: str) -> torch.Tensor:
    """Pack axis 1 of ``w`` [blocks, rows, ...]: chunk k -> bitfield k."""
    r = VALS_PER_WORD[packing]
    bits = FIELD_BITS[packing]
    step = w.shape[1] // r
    w = w.to(PACKING_CONTAINER[packing])
    out = w[:, :step] << (bits * (r - 1))
    for k in range(1, r):
        out = out | (w[:, k * step : (k + 1) * step] << (bits * (r - 1 - k)))
    return out


def _unpack_blocks(p: torch.Tensor, packing: str, dtype) -> torch.Tensor:
    """Inverse of `_pack_blocks` on ``p`` [blocks, packed_rows, ...]."""
    r = VALS_PER_WORD[packing]
    bits = FIELD_BITS[packing]
    mask = (1 << bits) - 1
    # mask after every shift: the int32 container's shifts are arithmetic
    chunks = [(p >> (bits * (r - 1 - k))) & mask for k in range(r)]
    return torch.cat(chunks, dim=1).to(dtype)


def pack(w_q: torch.Tensor, packing: str, blocks: int = 1) -> torch.Tensor:
    """Pack integer codes (2-D, values in [0, 2^nbits)) along axis 0.

    blocks > 1 packs each of ``blocks`` contiguous row-blocks on its own, so
    that a dim-0 slice at a block boundary is a packed matrix by itself.
    blocks=1 is the reference-compatible layout; its row count is padded
    with zeros up to a multiple of r (only 3-bit needs it)."""
    if packing == "8bit_u8":
        return w_q.to(torch.uint8)
    r = VALS_PER_WORD[packing]
    n, cols = w_q.shape[0], tuple(w_q.shape[1:])
    if blocks == 1:
        pad = (-n) % r
        if pad:
            w_q = torch.cat([w_q, w_q.new_zeros((pad,) + cols)], dim=0)
        return _pack_blocks(w_q[None], packing)[0]
    if n % (blocks * r) != 0:
        raise ValueError(f"{n} rows do not split into {blocks} blocks of r={r}")
    out = _pack_blocks(w_q.reshape(blocks, n // blocks, *cols), packing)
    return out.reshape(n // r, *cols)


def unpack(p: torch.Tensor, packing: str, dtype=torch.uint8, blocks: int = 1) -> torch.Tensor:
    """Unpack along axis 0 into ``dtype``. 3-bit output keeps its zero
    padding rows; callers cut it to the logical row count (see
    `hqq_tpu_torch.core.quantize.unpack_codes`)."""
    if packing == "8bit_u8":
        return p.to(dtype)
    n_p, cols = p.shape[0], tuple(p.shape[1:])
    if n_p % blocks != 0:
        raise ValueError(f"{n_p} packed rows do not split into {blocks} blocks")
    out = _unpack_blocks(p.reshape(blocks, n_p // blocks, *cols), packing, dtype)
    return out.reshape(n_p * VALS_PER_WORD[packing], *cols)
