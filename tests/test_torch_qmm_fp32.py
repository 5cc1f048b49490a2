# SPDX-License-Identifier: Apache-2.0
"""The fp32 route of the dequant-matmuls (csrc/qmm_fp32.cu) as far as the
CPU can hold it.

The kernel forms an fp32-accurate product from three TF32 tensor-core
products: each operand v (x's slab and the dequantized W) is split into
big = rna(v) and small = rna(v - big), where rna is `cvt.rna.tf32.f32`
(the 13 low mantissa bits rounded to nearest, ties away from zero), and
y = W_big x_small + W_small x_big + W_big x_big, each TF32 product exact and
summed in fp32; only small x small (about 2^-22 of a product) is dropped.
Here that arithmetic is emulated in numpy on the bits (the products in
float64, where they are exact) at small sizes, and held:

  * against the port's fp32 plain twins (`quant_matmul_plain`,
    `quant_matmul_ax0_plain`, `quant_matmul_lora_plain`, the LoRA term in
    fp32 as the kernel adds it) and against hqq_tpu's interpret-mode
    kernels on fp32 x, at the fp32 bar of chip_smoke.py and the card tests
    (1e-5 of max|y|);
  * the control, one TF32 product (rna(W) rna(x): what `torch.matmul` gives
    with TF32 allowed), must miss that bar, so the bar sees the split.

And `qmm_fp32_launch_plan`: every M bucket, both layouts, both meta types
and LoRA ranks fit the block's shared memory with a ring of at least two
slots, the grid covers every output once, and K is split only at M <= 32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hqq_tpu.core.quantize import quantize as j_quantize
from hqq_tpu.ops import fused_matmul as jf
from hqq_tpu_torch.ops import fused_matmul as tf
from hqq_tpu_torch.utils.convert import params_from_numpy

TOL_FP32 = 1e-5  # of max|y|: chip_smoke.py TOL_QMM_FP32


def tf32_rna(v: np.ndarray) -> np.ndarray:
    """fp32 -> TF32 as `cvt.rna.tf32.f32` does it, on the bits: add half of
    the 13 dropped bits to the magnitude, then clear them."""
    u = np.ascontiguousarray(v, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    v = v.astype(np.float32)
    big = tf32_rna(v)
    return big, tf32_rna(v - big)  # v - big is exact in fp32


def _dot(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b.T of TF32 values: each product exact, as the tensor core's."""
    return a.astype(np.float64) @ b.astype(np.float64).T


def three_tf32(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    """x [M, K] @ w [N, K]^T as the kernel forms it (small products first)."""
    xb, xs = _split(x)
    wb, ws = _split(w)
    return (_dot(xs, wb) + _dot(xb, ws) + _dot(xb, wb)).astype(np.float32)


def one_tf32(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    """The control: one TF32 product."""
    return _dot(tf32_rna(x), tf32_rna(w)).astype(np.float32)


def test_tf32_rna_bits():
    rng = np.random.default_rng(0)
    v = (rng.standard_normal(4096) * np.exp2(rng.integers(-20, 20, 4096))).astype(np.float32)
    r = tf32_rna(v)
    assert not (r.view(np.uint32) & np.uint32(0x1FFF)).any()
    # to nearest: within half a TF32 step (2^-11 of the value, relative)
    assert np.all(np.abs(r.astype(np.float64) - v) <= np.abs(v) * 2.0**-11)
    # ties go away from zero, both signs
    tie = np.array([1 + 2.0**-11, -(1 + 2.0**-11), 1 + 3 * 2.0**-11], dtype=np.float32)
    np.testing.assert_array_equal(tf32_rna(tie), np.float32([1 + 2.0**-10, -(1 + 2.0**-10),
                                                              1 + 2 * 2.0**-10]))
    # big + small keeps 22 bits of the value: what the dropped small*small costs
    big, small = _split(v)
    assert np.all(np.abs((big.astype(np.float64) + small) - v) <= np.abs(v) * 2.0**-21)


# (layout, nbits, g, meta): both kernel layouts, both meta types
_LAYOUTS = [("ax1", 4, 64, torch.float32), ("ax1", 4, 64, torch.bfloat16),
            ("ax1", 3, 32, torch.float32), ("ax0", 3, 64, torch.float32),
            ("ax0", 2, 16, torch.bfloat16)]


def _weight(layout, nbits, g, meta, n, k, seed):
    from hqq_tpu_torch.core.quantize import quantize

    w = torch.from_numpy((np.random.default_rng(seed).standard_normal((n, k)) / np.sqrt(k))
                         .astype(np.float32))
    if layout == "ax0":
        return tf.to_kernel_layout_ax0(quantize(w, nbits=nbits, group_size=g, axis=0), meta)
    return tf.to_kernel_layout(quantize(w, nbits=nbits, group_size=g, axis=1,
                                        round_zero=(nbits == 4)), meta)


# (layout, nbits, g, meta, rank): the LoRA term rides axis=1 weights only
_CASES = [c + (0,) for c in _LAYOUTS] + [c + (8,) for c in _LAYOUTS if c[0] == "ax1"]


@pytest.mark.parametrize("m,k,n", [(33, 512, 256), (7, 1024, 128)])
@pytest.mark.parametrize("layout,nbits,g,meta,rank", _CASES)
def test_three_tf32_meets_the_fp32_bar(layout, nbits, g, meta, rank, m, k, n):
    kqt = _weight(layout, nbits, g, meta, n, k, seed=m + k + n + nbits)
    rng = np.random.default_rng(rank + m)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = tf.dequant_plain(kqt, torch.float32).numpy()  # the kernel's fp32 W, bit for bit
    xt = torch.from_numpy(x)
    if rank:
        a = (rng.standard_normal((k, rank)) / np.sqrt(k)).astype(np.float32)
        b = (rng.standard_normal((rank, n)) * 0.05).astype(np.float32)
        ref = tf.quant_matmul_lora_plain(xt, kqt, torch.from_numpy(a), torch.from_numpy(b))
        term = (x @ a) @ b  # fp32, as the kernel adds it
    else:
        plain = tf.quant_matmul_ax0_plain if layout == "ax0" else tf.quant_matmul_plain
        ref = plain(xt, kqt)
        term = 0.0
    ref = ref.numpy()
    scale = np.abs(ref).max()
    got = three_tf32(x, w) + term
    control = one_tf32(x, w) + term
    assert np.abs(got - ref).max() <= TOL_FP32 * scale
    assert np.abs(control - ref).max() > TOL_FP32 * scale


@pytest.mark.parametrize("axis,nbits,g", [(1, 4, 64), (1, 2, 16), (0, 3, 64), (0, 3, 128)])
def test_three_tf32_against_hqq_tpu(axis, nbits, g):
    """The emulated kernel against hqq_tpu's Pallas kernel in interpret mode
    on fp32 x, at the fp32 bar; one TF32 product misses it."""
    n, k, m = 256, 512, 40
    rng = np.random.default_rng(axis * 100 + g)
    w = (rng.standard_normal((n, k)) / np.sqrt(k)).astype(np.float32)
    qj = j_quantize(jnp.asarray(w), nbits=nbits, group_size=g, axis=axis,
                    round_zero=(nbits == 4), compute_dtype=jnp.float32)
    qt = params_from_numpy(jax.tree_util.tree_map(np.asarray, qj), "cpu")
    if axis == 1:
        kj, kt = jf.to_kernel_layout(qj, pad_k_groups=8), tf.to_kernel_layout(qt)
    else:
        kj, kt = jf.to_kernel_layout_ax0(qj), tf.to_kernel_layout_ax0(qt)
    x = rng.standard_normal((m, k)).astype(np.float32)
    yj = np.asarray(jf.quant_matmul_pallas(jnp.asarray(x), kj))
    wd = tf.dequant_plain(kt, torch.float32).numpy()
    scale = np.abs(yj).max()
    assert np.abs(three_tf32(x, wd) - yj).max() <= TOL_FP32 * scale
    assert np.abs(one_tf32(x, wd) - yj).max() > TOL_FP32 * scale


_M = [1, 4, 8, 31, 32, 33, 64, 65, 128, 257, 512, 1023]
# (cb, g) of both layouts, as test_torch_qmm_sm90: every container, groups of
# 8 to 128, and groups that neither divide nor are multiples of the slab
_GEOMETRY = {1: [(8, 8), (4, 64), (4, 24), (4, 96), (2, 16), (2, 128), (1, 32)],
             0: [(8, 8), (4, 64), (4, 72), (2, 16), (2, 128), (1, 32)]}
_SHAPES = [(4096, 4096), (11008, 4096), (4096, 11008), (200, 96 * 4), (320, 1152)]


@pytest.mark.parametrize("axis", [1, 0])
@pytest.mark.parametrize("m", _M)
def test_fp32_launch_plan(m, axis):
    for cb, g in _GEOMETRY[axis]:
        for n, k in _SHAPES:
            if n % g or (axis == 1 and k % g):
                continue
            for meta_size in (4, 2):
                for rank in ((0, 1, 8, 65) if axis == 1 else (0,)):
                    plan = tf.qmm_fp32_launch_plan(m, n, k, cb, g, axis=axis,
                                                   meta_size=meta_size, rank=rank)
                    rows, tokens, splits = plan.grid
                    slabs = -(-k // tf.QMM_FP32_SLAB)
                    assert rows == tf._row_tiles(n, g, axis)
                    assert plan.token_tile in tf.QMM_FP32_TOKEN_TILES
                    assert (tokens - 1) * plan.token_tile < m <= tokens * plan.token_tile
                    assert splits == plan.splits >= 1
                    assert (splits - 1) * plan.slabs_per_split < slabs \
                        <= splits * plan.slabs_per_split
                    if m > tf.QMM_SPLIT_MAX_M:
                        assert splits == 1
                    # a ring of two slots at least, inside one block's shared memory
                    assert 2 <= plan.stages <= tf.QMM_MAX_STAGES
                    assert plan.smem <= tf.H100_SMEM_PER_BLOCK
                    code_stage = tf.QMM_ROWS * tf.QMM_FP32_SLAB // 8 * cb
                    meta_stage = tf._slab_meta_bytes(g, axis, meta_size, tf.QMM_FP32_SLAB)
                    assert plan.smem == tf.qmm_fp32_smem_bytes(plan.token_tile, plan.stages,
                                                               code_stage, meta_stage, rank > 0)
                    # every rank in one chunk of 8 of one pass
                    if rank:
                        assert plan.rank_tile == tf.QMM_FP32_RANK_TILE
                        assert (plan.passes - 1) * plan.rank_tile < rank \
                            <= plan.passes * plan.rank_tile


def test_fp32_launch_plan_main_shapes():
    """The shapes of chip_smoke.py's fp32 rows: one wave of 128 blocks."""
    for args in ((512, 4096, 4096, 4, 64), (512, 11008, 4096, 2, 16, 0, 2)):
        plan = tf.qmm_fp32_launch_plan(*args)
        assert (plan.token_tile, plan.splits) == (128, 1) and plan.stages >= 3
        assert plan.grid[0] * plan.grid[1] <= 4 * 86
    plan = tf.qmm_fp32_launch_plan(512, 4096, 4096, 4, 64, rank=8)
    assert (plan.token_tile, plan.passes, plan.grid) == (128, 1, (32, 4, 1))
