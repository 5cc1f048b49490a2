# SPDX-License-Identifier: Apache-2.0
"""The w4a8 small-group route's arithmetic, on the CPU.

`w4a8_group_mma_kernel` (`csrc/w4a8_matmul.cu`) takes rows 2/3 and 8 where
a group is not whole k32 steps (HQQ+'s 2-bit and 1.58-bit g8, 1-bit g8 and
g16, 4-bit g16 and g24) or where a block's meta for all of K does not fit.
It cannot run here, so `tests/test_torch_w4a8_plan.py`'s numpy emulation
walks the packed words as the card does (per k32 step, one MMA per group
of the step with the other groups' threads masked, xsum per token and
group, the fold piece by piece, the k-slices summed in order, times sx,
plus the LoRA term), and is held to `hqq_tpu`'s `quant_matmul_pallas_a8`
and `quant_matmul_pallas_a8_lora` (Pallas in interpret mode) and to the
port's plain twins.

Bars (of max|y|): 1e-5 in fp32 (exact group dots, fp32 folds in another
order), 2^-7 for a bf16 output (one rounding more). Control: one thread's
mask moved to the next group must miss the fp32 bar. Row 0 of the emulated
y is bit-equal at M = 1, 4, 8 and 32: the plan's column tile and K split do
not depend on M.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_w4a8_plan as wp
from hqq_tpu.ops import fused_matmul as jf
from hqq_tpu_torch.ops import fused_matmul as tf


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch ops on one thread: the suite's workers share the cores, and
    torch's intra-op threads would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (m, n, k, g, nbits, bf16 meta, rank): the four sub-word configs, 4-bit g16
# and g24, M 1-32, ragged N, a last stage cut by K, both meta types, with and
# without an adapter
_CASES = [
    (1, 96, 512, 8, 2, False, 0),
    (4, 136, 512, 8, 2, True, 8),      # ragged N
    (8, 96, 1024, 8, 1.58, False, 8),
    (32, 96, 512, 8, 1.58, True, 0),
    (4, 96, 1024, 8, 1, False, 0),     # a word spans 4 groups
    (32, 72, 512, 8, 1, True, 8),
    (1, 96, 512, 16, 1, True, 0),
    (8, 200, 1024, 16, 1, False, 8),
    (4, 96, 512, 16, 4, False, 0),
    (32, 96, 512, 16, 4, True, 8),     # bf16 4-bit: the zs offset
    (1, 96, 768, 24, 4, False, 8),     # steps that straddle two groups
    (8, 64, 960, 24, 4, True, 0),      # the last stage cut by K
    (32, 96, 960, 24, 4, False, 0),
]


def _route(m, kt):
    return tf.w4a8_launch_plan(m, kt.n, kt.k, kt.container_bits, kt.group_size,
                               kt.scale.dtype)


def _reference(x, kj, a, b, k, g):
    """hqq_tpu's int8 route: the LoRA entry where it takes the shape, else
    its int8 base plus the adapter in float64."""
    if a is not None and k % (8 * g) == 0:
        return np.asarray(jf.quant_matmul_pallas_a8_lora(jnp.asarray(x), kj, jnp.asarray(a),
                                                         jnp.asarray(b)))
    base = np.asarray(jf.quant_matmul_pallas_a8(jnp.asarray(x), kj))
    return base if a is None else base + (x.astype(np.float64) @ a) @ b


@pytest.mark.parametrize("m,n,k,g,nbits,bf16,rank", _CASES)
def test_group_route_matches_hqq_tpu_and_plain(m, n, k, g, nbits, bf16, rank):
    kj, kt, x, a, b = wp._case(m, n, k, g, nbits, bf16, rank)
    assert _route(m, kt).route == "group_mma"
    x8t, sxt = tf.quantize_activations_int8(torch.from_numpy(x))
    x8, sx = x8t.numpy(), sxt.numpy()
    xa = x @ a if rank else None
    got = wp.emulate(x8, sx, kt, xa, b).numpy()
    if rank:
        plain = tf.w4a8_lora_matmul_plain(x8t, sxt, kt, torch.from_numpy(xa), torch.from_numpy(b))
    else:
        plain = tf.w4a8_matmul_plain(x8t, sxt, kt)
    ref = _reference(x, kj, a, b, k, g)
    assert got.shape == ref.shape == (m, n)
    assert wp._rel(got, ref) < 1e-5
    assert wp._rel(got, plain.numpy()) < 1e-5
    got16 = wp.emulate(x8, sx, kt, xa, b, torch.bfloat16).float().numpy()
    assert wp._rel(got16, plain.numpy()) < 2.0**-7


@pytest.mark.parametrize("m,n,k,g,nbits,bf16,rank", [c for c in _CASES if c[6] == 0])
def test_moved_mask_misses(m, n, k, g, nbits, bf16, rank):
    """The control: thread 0's 8 codes masked into the next group's MMA,
    so they meet that group's scale, must miss the fp32 bar."""
    _, kt, x, _, _ = wp._case(m, n, k, g, nbits, bf16, 0)
    x8t, sxt = tf.quantize_activations_int8(torch.from_numpy(x))
    bad = wp.emulate(x8t.numpy(), sxt.numpy(), kt, moved=True).numpy()
    assert wp._rel(bad, tf.w4a8_matmul_plain(x8t, sxt, kt).numpy()) > 1e-3


@pytest.mark.parametrize("n,k,g,nbits,bf16", [
    (96, 512, 8, 2, False), (72, 1024, 8, 1, True), (96, 512, 16, 1, False),
    (96, 960, 24, 4, True),
])
def test_row0_bit_equal_across_m(n, k, g, nbits, bf16):
    """Row 0 of y from the same row of x at M = 1, 4, 8 and 32: the plans'
    column tile, K split and fold order are M's alike, and x8 scales per
    row, so the emulated rows are bit-equal."""
    kj, kt, x, _, _ = wp._case(32, n, k, g, nbits, bf16, 0)
    rows = []
    for m in (1, 4, 8, 32):
        x8, sx = tf.quantize_activations_int8(torch.from_numpy(x[:m]))
        assert _route(m, kt).route == "group_mma"
        rows.append(wp.emulate(x8.numpy(), sx.numpy(), kt)[0])
    assert all(torch.equal(r, rows[0]) for r in rows[1:])
    plans = {(p.col_tile, p.k_slices, p.stage_codes) for p in (_route(m, kt) for m in (1, 4, 8, 32))}
    assert len(plans) == 1


def test_meta_too_large_for_a_block():
    """1-bit g32 at K = 11008: the tensor-core route's scale and zs for all
    of K leave no ring, so the small-group route takes it, its meta streamed
    a stage at a time (one piece a step)."""
    m, n, k, g = 32, 64, 11008, 32
    kj, kt, x, _, _ = wp._case(m, n, k, g, 1, False, 0)
    plan = _route(m, kt)
    assert plan.route == "group_mma" and "no room for a ring" in plan.why
    x8t, sxt = tf.quantize_activations_int8(torch.from_numpy(x))
    got = wp.emulate(x8t.numpy(), sxt.numpy(), kt).numpy()
    assert wp._rel(got, tf.w4a8_matmul_plain(x8t, sxt, kt).numpy()) < 1e-5
    assert wp._rel(got, np.asarray(jf.quant_matmul_pallas_a8(jnp.asarray(x), kj))) < 1e-5
