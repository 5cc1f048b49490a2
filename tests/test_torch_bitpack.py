# SPDX-License-Identifier: Apache-2.0
"""hqq_tpu_torch.core.bitpack against hqq_tpu.core.bitpack: the packed
bytes are identical for every container, with blocks = 1 and > 1, and
unpacking gives back the codes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hqq_tpu.core import bitpack as jbp
from hqq_tpu_torch.core import bitpack as tbp

_BITS = {"8bit_u8": 8, "4bit_u8": 4, "3bit_32": 3, "2bit_u8": 2, "1bit_u8": 1}


# block-local packing (blocks > 1) needs rows divisible by blocks * r and
# has no 3-bit form
_CASES = [
    (packing, rows, blocks)
    for packing in _BITS
    for rows in (80, 64)
    for blocks in (1, 2, 4)
    if blocks == 1
    or (packing != "3bit_32" and rows % (blocks * tbp.VALS_PER_WORD[packing]) == 0)
]


@pytest.mark.parametrize("packing,rows,blocks", _CASES)
def test_pack_bytes_equal(packing, rows, blocks):
    rng = np.random.default_rng(rows + blocks)
    codes = rng.integers(0, 2 ** _BITS[packing], size=(rows, 24)).astype(np.int32)

    ref = np.asarray(jbp.pack(jnp.asarray(codes), packing, blocks=blocks))
    got = tbp.pack(torch.from_numpy(codes), packing, blocks=blocks).numpy()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)

    back = tbp.unpack(torch.from_numpy(got), packing, torch.int32, blocks=blocks).numpy()
    ref_back = np.asarray(jbp.unpack(jnp.asarray(ref), packing, jnp.int32, blocks=blocks))
    np.testing.assert_array_equal(back, ref_back)
    np.testing.assert_array_equal(back[:rows], codes)
    assert tbp.packed_rows(rows, packing) == jbp.packed_rows(rows, packing)
