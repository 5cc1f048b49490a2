# SPDX-License-Identifier: Apache-2.0
"""The fp32 route of flash attention (csrc/flash_fp32_sm90.cu) as far as the
CPU can hold it.

The kernel forms every product to fp32 accuracy from three TF32 tensor-core
products: each operand v is split into big = rna(v) and small =
rna(v - big), rna being `cvt.rna.tf32.f32`, and a @ b = a_big b_small +
a_small b_big + a_big b_big, each TF32 product exact and summed in fp32
(only small x small, about 2^-22 of a product, dropped). It walks 64 query
rows at a time over key tiles of the launch plan's size: S = Q K^T of a tile
in three products, the online softmax in fp32 (exp2 of scores in log2
units), P split the same way, the tile's P V in three products into zeroed
sums, folded into the output as O = O * corr + O_tile. Here that arithmetic
is emulated in numpy on the bits (the products in float64, where they are
exact) at small sizes, causal and not, and held:

  * against `hqq_tpu.ops.attention.prefill_attention` in fp32 on the CPU and
    the port's `flash_attention_plain`, at the fp32 bar of chip_smoke.py and
    the card tests (1e-4 of max|out|);
  * the control, one TF32 product for each of S and P V (what the plain
    version gives with TF32 allowed), must miss that bar.

And `flash_fp32_launch_plan`: the shared memory fits a block of an H100
with a ring of at least two slots, every (batch, head, query tile) is
covered once, longest causal walks first, for head sizes 64, 128, 256 and
GQA.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hqq_tpu.ops.attention import prefill_attention as j_prefill
from hqq_tpu_torch.ops import attention as at
from hqq_tpu_torch.ops.fused_matmul import H100_SMEM_PER_BLOCK

TOL_FP32 = 1e-4  # of max|out|: chip_smoke.py TOL_FLASH_FP32


def tf32_rna(v: np.ndarray) -> np.ndarray:
    """fp32 -> TF32 as `cvt.rna.tf32.f32` does it, on the bits."""
    u = np.ascontiguousarray(v, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _dot(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b.T of TF32 values: each product exact, as the tensor core's."""
    return a.astype(np.float64) @ b.astype(np.float64).T


def three_tf32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a [M, K] @ b [N, K]^T as the kernel forms it (small products first)."""
    ab = tf32_rna(a)
    asm = tf32_rna(a - ab)  # a - ab is exact in fp32
    bb = tf32_rna(b)
    bs = tf32_rna(b - bb)
    return (_dot(ab, bs) + _dot(asm, bb) + _dot(ab, bb)).astype(np.float32)


def one_tf32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The control: one TF32 product."""
    return _dot(tf32_rna(a), tf32_rna(b)).astype(np.float32)


def kernel_attention(q, k, v, causal: bool, key_tile: int, product=three_tf32) -> np.ndarray:
    """One head [T, hd] as the kernel walks it: blocks of 64 query rows, key
    tiles of ``key_tile`` up to the diagonal, S and each tile's P V by
    ``product``, every other value fp32."""
    t, hd = q.shape
    scale_log2 = np.float32(hd**-0.5 * 1.4426950408889634)
    out = np.zeros_like(q)
    for m0 in range(0, t, at.FLASH_FP32_QUERY_TILE):
        rows = np.arange(m0, min(t, m0 + at.FLASH_FP32_QUERY_TILE))
        o = np.zeros((len(rows), hd), np.float32)
        mx = np.full(len(rows), -np.inf, np.float32)
        total = np.zeros(len(rows), np.float32)
        n_tiles = -(-(min(t, rows[-1] + 1) if causal else t) // key_tile)
        for kt in range(n_tiles):
            cols = np.arange(kt * key_tile, min(t, (kt + 1) * key_tile))
            s = product(q[rows], k[cols]) * scale_log2
            if causal:
                s = np.where(cols[None, :] > rows[:, None], -np.inf, s).astype(np.float32)
            mn = np.maximum(mx, s.max(axis=1))
            corr = np.exp2(mx - mn).astype(np.float32)
            mx = mn
            p = np.exp2(s - mn[:, None]).astype(np.float32)
            total = total * corr + p.sum(axis=1, dtype=np.float32)
            o = o * corr[:, None] + product(p, np.ascontiguousarray(v[cols].T))
        out[rows] = o / total[:, None]
    return out


def _inputs(t: int, hd: int, heads: int = 2, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, heads, t, hd)).astype(np.float32) for _ in range(3)]


def _rel(got: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(got.astype(np.float64) - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t,hd", [(64, 64), (200, 64), (64, 128), (200, 128)])
def test_three_tf32_attention_meets_the_bar(t, hd, causal):
    q, k, v = _inputs(t, hd, seed=t + hd)
    ref = np.asarray(j_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    plain = at.flash_attention_plain(*(torch.from_numpy(x) for x in (q, k, v)), causal).numpy()
    key_tile = at.flash_fp32_launch_plan(1, 2, t, hd).key_tile
    got = np.stack([kernel_attention(q[0, h], k[0, h], v[0, h], causal, key_tile)
                    for h in range(2)])[None]
    assert np.isfinite(got).all()
    assert _rel(got, ref) <= TOL_FP32
    assert _rel(got, plain) <= TOL_FP32
    control = np.stack([kernel_attention(q[0, h], k[0, h], v[0, h], causal, key_tile, one_tf32)
                        for h in range(2)])[None]
    assert _rel(control, ref) > TOL_FP32


def test_split_is_exact_to_two_tf32_steps():
    """big + small holds v to about 2^-22 of it: the split loses what the
    bar cannot see, one TF32 part alone (2^-11) does not."""
    rng = np.random.default_rng(1)
    v = (rng.standard_normal(4096) * np.exp2(rng.integers(-10, 10, 4096))).astype(np.float32)
    big = tf32_rna(v)
    small = tf32_rna(v - big)
    assert not ((big.view(np.uint32) | small.view(np.uint32)) & np.uint32(0x1FFF)).any()
    err = np.abs(big.astype(np.float64) + small - v)
    assert np.all(err <= np.abs(v) * 2.0**-21)
    assert np.abs(big.astype(np.float64) - v).max() > 2.0**-14 * np.abs(v).max()


@pytest.mark.parametrize("hd", [64, 128, 256, 80, 16])
@pytest.mark.parametrize("heads,t", [(8, 512), (32, 1024), (4, 1)])
def test_fp32_plan_fits(hd, heads, t):
    """The head pads to 64, 128 or 256; the key tile and consumers follow
    it; the ring holds as many slots as fit, at least 2, at most 4; the
    shared memory is the source's formula and fits a block."""
    plan = at.flash_fp32_launch_plan(2, heads, t, hd)
    assert plan.head_pad == min(p for p in at.FLASH_HEAD_PADS if p >= hd)
    assert plan.key_tile == at.FLASH_FP32_KEY_TILE[plan.head_pad]
    assert plan.consumers == (2 if plan.head_pad == 256 else 1)
    assert 2 <= plan.stages <= at.FLASH_FP32_MAX_STAGES
    assert plan.smem == at.flash_fp32_smem_bytes(plan.head_pad, plan.key_tile, plan.stages)
    assert plan.smem <= H100_SMEM_PER_BLOCK
    assert plan.stages == at.FLASH_FP32_MAX_STAGES or at.flash_fp32_smem_bytes(
        plan.head_pad, plan.key_tile, plan.stages + 1) > H100_SMEM_PER_BLOCK
    # the accumulator of a consumer's share of the output columns and of a
    # tile's scores fit the wgmma shapes the source instantiates
    assert plan.head_pad // plan.consumers in (64, 128) and plan.key_tile % 8 == 0


@pytest.mark.parametrize("b,nh,n_kv,t", [(1, 32, 32, 1024), (1, 8, 8, 512), (2, 8, 2, 300),
                                         (3, 4, 1, 65), (1, 2, 2, 1)])
def test_fp32_plan_covers_every_tile_once(b, nh, n_kv, t):
    """Block i runs query tile q_order[i // (b * nh)] of (batch, head)
    i % (b * nh) (GQA only changes which kv head a head reads): every
    (batch, head, query tile of 64 rows) once; the causal walks never grow
    along the table, the kernel's launch order."""
    plan = at.flash_fp32_launch_plan(b, nh, t, 128)
    q_tiles = len(plan.q_order)
    assert (q_tiles - 1) * at.FLASH_FP32_QUERY_TILE < t <= q_tiles * at.FLASH_FP32_QUERY_TILE
    assert plan.blocks == b * nh * q_tiles
    blocks = [(plan.q_order[i // (b * nh)], i % (b * nh)) for i in range(plan.blocks)]
    assert sorted(blocks) == sorted((q, h) for q in range(q_tiles) for h in range(b * nh))
    walks = [-(-min(t, (q + 1) * at.FLASH_FP32_QUERY_TILE) // plan.key_tile)
             for q in plan.q_order]
    assert walks == sorted(walks, reverse=True)
    assert {h // nh * n_kv + h % nh // (nh // n_kv) for h in range(b * nh)} == set(range(b * n_kv))


def test_fp32_plan_refuses_other_heads():
    for hd in (8, 24, 272):
        with pytest.raises(ValueError):
            at.flash_fp32_launch_plan(1, 1, 256, hd)
