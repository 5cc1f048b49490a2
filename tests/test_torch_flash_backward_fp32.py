# SPDX-License-Identifier: Apache-2.0
"""The fp32 route of the flash-attention backward
(csrc/flash_backward_fp32_sm90.cu) as far as the CPU can hold it.

The two kernels form every product to fp32 accuracy from three TF32
tensor-core products: each operand v is split into big = rna(v) and small =
rna(v - big), rna being `cvt.rna.tf32.f32`, and a @ b = a_big b_small +
a_small b_big + a_big b_big, each TF32 product exact and summed in fp32. A
block keeps 64 resident rows (keys for dK/dV, query rows for dQ) and walks
tiles of the launch plan's streamed rows (query tiles at or below its keys,
or key tiles up to its diagonal): S and dP of the tile in three products
each, P = exp2(S * scale * log2 e - lse * log2 e) and dS = scale * P (dP - D)
in fp32, then dV += P^T dO and dK += dS^T Q (or dQ += dS K) in three
products, summed over the whole walk in fp32 with no fold. Here that
arithmetic is emulated in numpy on the bits (the products in float64, where
they are exact) at small sizes, causal and not, MHA and GQA (per query head,
summed over the group, as the wrapper sums the kernel's partials), and held:

  * against `jax.vjp` of `hqq_tpu.ops.attention.prefill_attention` in fp32
    on the CPU and against the port's `flash_attention_backward_plain`, at
    the fp32 bar of chip_smoke.py (1e-4 of max|grad|);
  * the control, one TF32 product for each product (what the plain backward
    gives with TF32 allowed), must miss that bar.

At head_pad 256 a cluster of two blocks shares each resident tile, a block
on each half of the head's columns: S and dP are each block's partial over
its 128 columns (three TF32 products), swapped between the two and added
lo + hi in fp32, and that order is emulated too, held to the same two
references at head sizes 256 and 160 (the second half mostly the zero
columns TMA reads), with the control that drops one half.

Then the register fragments: P and dS leave the accumulator of S^T (or S)
as the A operand of the second products, so the transposed operands store
each 8 streamed rows as 0 2 4 6 1 3 5 7; the map is checked lane by lane.
And `flash_backward_launch_plan`'s fp32 fields: shared memory fits a block
of an H100 and is the source's formula, head size 256 takes the cluster of
two by shape, every (batch, head, tile) is covered once, and the longest
causal walks come first.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hqq_tpu.ops.attention import prefill_attention as j_prefill
from hqq_tpu_torch.ops import attention as at
from hqq_tpu_torch.ops.fused_matmul import H100_SMEM_PER_BLOCK

TOL_FP32 = 1e-4  # of max|grad|: chip_smoke.py TOL_BWD[torch.float32]
LOG2E = 1.4426950408889634


def tf32_rna(v: np.ndarray) -> np.ndarray:
    """fp32 -> TF32 as `cvt.rna.tf32.f32` does it, on the bits."""
    u = np.ascontiguousarray(v, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _dot(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b.T of TF32 values: each product exact, as the tensor core's."""
    return a.astype(np.float64) @ b.astype(np.float64).T


def three_tf32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a [M, K] @ b [N, K]^T as the kernels form it."""
    ab = tf32_rna(a)
    asm = tf32_rna(a - ab)  # a - ab is exact in fp32
    bb = tf32_rna(b)
    bs = tf32_rna(b - bb)
    return (_dot(ab, bs) + _dot(asm, bb) + _dot(ab, bb)).astype(np.float32)


def one_tf32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The control: one TF32 product."""
    return _dot(tf32_rna(a), tf32_rna(b)).astype(np.float32)


def _probs(x1, x2, lse2, d, keys, queries, t, causal, scale, key_rows: bool):
    """P and dS of a tile from X1 (S^T with ``key_rows``, else S) and X2,
    as the kernels form them: 0 past T and above the diagonal."""
    lse2, d = (lse2[None, :], d[None, :]) if key_rows else (lse2[:, None], d[:, None])
    p = np.exp2(x1 * np.float32(scale * LOG2E) - lse2).astype(np.float32)
    kk, qq = (keys[:, None], queries[None, :]) if key_rows else (keys[None, :], queries[:, None])
    p = np.where((kk >= t) | (qq >= t) | (causal & (kk > qq)), np.float32(0), p)
    return p, (p * (x2 - d) * np.float32(scale)).astype(np.float32)


def split_head(a: np.ndarray, b: np.ndarray, product=three_tf32, halves=(0, 1)) -> np.ndarray:
    """a [M, hd] @ b [N, hd]^T over the head as a cluster of two blocks forms
    it at head_pad 256: each block's three TF32 products over its 128
    columns (past hd, the zeros TMA reads), then lo + hi in fp32. The
    control keeps only the ``halves`` given."""
    parts = [product(a[:, 128 * h:128 * h + 128], b[:, 128 * h:128 * h + 128]) for h in halves]
    return parts[0] if len(parts) == 1 else (parts[0] + parts[1]).astype(np.float32)


def kernel_head(q, k, v, do, lse, d, causal: bool, tile: int, product=three_tf32, first=None):
    """One query head [T, hd] and its kv head as the two kernels walk them:
    (dq, and dk and dv of this query head). Rows past T are the zeros TMA
    reads there. ``first`` forms S and dP (S^T and dP^T), by default as
    ``product``."""
    first = first or product
    t, hd = q.shape
    rows = at.FLASH_BWD_FP32_ROWS
    scale = hd**-0.5
    lse2 = (lse * np.float32(LOG2E)).astype(np.float32)
    pad = -(-t // rows) * rows + tile
    q, k, v, do = (np.pad(x, ((0, pad - t), (0, 0))) for x in (q, k, v, do))
    lse2, d = (np.pad(x, (0, pad - t)) for x in (lse2, d))
    dq, dk, dv = (np.zeros((t, hd), np.float32) for _ in range(3))
    for r0 in range(0, t, rows):  # dK/dV: 64 keys, the query tiles from the diagonal
        keys = np.arange(r0, r0 + rows)
        acc_k, acc_v = (np.zeros((rows, hd), np.float32) for _ in range(2))
        for c0 in range(r0 // tile * tile if causal else 0, t, tile):
            qs = np.arange(c0, c0 + tile)
            p, ds = _probs(first(k[keys], q[qs]), first(v[keys], do[qs]), lse2[qs], d[qs],
                           keys, qs, t, causal, scale, key_rows=True)
            acc_v = acc_v + product(p, do[qs].T)
            acc_k = acc_k + product(ds, q[qs].T)
        dk[r0:r0 + rows], dv[r0:r0 + rows] = acc_k[:t - r0], acc_v[:t - r0]
    for r0 in range(0, t, rows):  # dQ: 64 query rows, the key tiles up to the diagonal
        qs = np.arange(r0, r0 + rows)
        acc = np.zeros((rows, hd), np.float32)
        for c0 in range(0, min(t, r0 + rows) if causal else t, tile):
            keys = np.arange(c0, c0 + tile)
            _, ds = _probs(first(q[qs], k[keys]), first(do[qs], v[keys]), lse2[qs], d[qs],
                           keys, qs, t, causal, scale, key_rows=False)
            acc = acc + product(ds, k[keys].T)
        dq[r0:r0 + rows] = acc[:t - r0]
    return dq, dk, dv


def kernel_backward(q, k, v, do, o, lse, causal: bool, product=three_tf32, first=None):
    """(dq, dk, dv) [B, heads, T, hd] as the kernels and the wrapper give
    them: D = rowsum(dO * O) in fp32, each query head's dK and dV summed
    over its group."""
    b, nh, t, hd = q.shape
    rep = nh // k.shape[1]
    tile = at.flash_backward_launch_plan(b, nh, k.shape[1], t, hd).fp32_tile
    d = (torch.from_numpy(do) * torch.from_numpy(o)).sum(dim=-1).numpy()
    dq = np.zeros_like(q)
    dk_part, dv_part = np.zeros_like(q), np.zeros_like(q)
    for bi in range(b):
        for h in range(nh):
            dq[bi, h], dk_part[bi, h], dv_part[bi, h] = kernel_head(
                q[bi, h], k[bi, h // rep], v[bi, h // rep], do[bi, h], lse[bi, h], d[bi, h],
                causal, tile, product, first)
    group = (b, k.shape[1], rep, t, hd)
    return dq, dk_part.reshape(group).sum(axis=2), dv_part.reshape(group).sum(axis=2)


def _inputs(b, nh, n_kv, t, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, nh, t, hd)).astype(np.float32)
    k = rng.standard_normal((b, n_kv, t, hd)).astype(np.float32)
    v = rng.standard_normal((b, n_kv, t, hd)).astype(np.float32)
    do = rng.standard_normal((b, nh, t, hd)).astype(np.float32)
    return q, k, v, do


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _references(q, k, v, do, causal):
    """(o, lse, the plain backward, jax.vjp of hqq_tpu's prefill_attention)
    of fp32 numpy inputs, K and V repeated over each kv head's group for
    hqq_tpu."""
    nh, n_kv = q.shape[1], k.shape[1]
    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, do))
    o = at.flash_attention_plain(qt, kt, vt, causal)
    lse = at._plain_lse(qt, kt, causal, None)
    plain = [x.numpy() for x in at.flash_attention_backward_plain(qt, kt, vt, o, lse, dot, causal)]

    def fwd(q, k, v):
        rep = nh // n_kv
        return j_prefill(q, jnp.repeat(k, rep, axis=1), jnp.repeat(v, rep, axis=1), causal=causal)

    _, vjp = jax.vjp(fwd, *(jnp.asarray(x) for x in (q, k, v)))
    return o.numpy(), lse.numpy(), plain, [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,nh,n_kv,t,hd", [(1, 2, 2, 200, 128), (1, 4, 2, 130, 64),
                                            (1, 2, 1, 77, 128), (1, 2, 2, 64, 64)])
def test_three_tf32_backward_meets_the_bar(causal, b, nh, n_kv, t, hd):
    q, k, v, do = _inputs(b, nh, n_kv, t, hd, seed=t + hd)
    o, lse, plain, ref = _references(q, k, v, do, causal)
    got = kernel_backward(q, k, v, do, o, lse, causal)
    for g, r, p in zip(got, ref, plain):
        assert np.isfinite(g).all()
        assert _rel(g, r) <= TOL_FP32
        assert _rel(g, p) <= TOL_FP32
    control = kernel_backward(q, k, v, do, o, lse, causal, one_tf32)
    assert max(_rel(c, r) for c, r in zip(control, ref)) > TOL_FP32


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,nh,n_kv,t,hd", [(1, 2, 2, 80, 256), (1, 4, 2, 70, 160)])
def test_split_head_backward_meets_the_bar(causal, b, nh, n_kv, t, hd):
    """Head size 256 on a cluster of two: S and dP from the two blocks'
    partials over 128 columns each, added lo + hi, meet the fp32 bar against
    jax.vjp of hqq_tpu's prefill_attention and the plain backward; with one
    half dropped (either) they miss it."""
    plan = at.flash_backward_launch_plan(b, nh, n_kv, t, hd)
    assert (plan.head_pad, plan.fp32_route, plan.fp32_cluster) == (256, "wgmma_cluster", 2)
    q, k, v, do = _inputs(b, nh, n_kv, t, hd, seed=t + hd)
    o, lse, plain, ref = _references(q, k, v, do, causal)
    got = kernel_backward(q, k, v, do, o, lse, causal, first=split_head)
    for g, r, p in zip(got, ref, plain):
        assert np.isfinite(g).all()
        assert _rel(g, r) <= TOL_FP32
        assert _rel(g, p) <= TOL_FP32
    for half in (0, 1):
        control = kernel_backward(q, k, v, do, o, lse, causal,
                                  first=lambda a, b_, h=half: split_head(a, b_, halves=(h,)))
        assert max(_rel(c, r) for c, r in zip(control, ref)) > TOL_FP32


# the wgmma fragment maps of a warpgroup (warp w, lane l): an fp32
# accumulator's register 4j + h holds row 16w + l/4 + 8(h >> 1), column
# 8j + 2(l % 4) + (h & 1); a TF32 A fragment's register i of k8 step j holds
# row 16w + l/4 + 8(i & 1), k index l % 4 + 4(i >> 1)
_FRAG = (0, 2, 1, 3)  # the kernel's fragment register i <- accumulator register 4j + _FRAG[i]
_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)  # k index m of a transposed panel holds streamed row 8j + _ORDER[m]


@pytest.mark.parametrize("tile", [16, 32])
def test_fragment_order_matches_the_transposed_rows(tile):
    """Every P or dS value the kernel moves from the accumulator into an A
    fragment meets, in the product, the transposed operand's column of the
    same streamed row; the 0 2 4 6 1 3 5 7 order with another fragment map,
    or the plain order with this one, does not."""
    def pairs(frag, order):
        for w in range(4):
            for lane in range(32):
                for j in range(tile // 8):
                    for i in range(4):
                        h = frag[i]
                        acc = (16 * w + lane // 4 + 8 * (h >> 1), 8 * j + 2 * (lane % 4) + (h & 1))
                        a_row = 16 * w + lane // 4 + 8 * (i & 1)
                        yield acc, (a_row, 8 * j + order[lane % 4 + 4 * (i >> 1)])

    assert all(a == b for a, b in pairs(_FRAG, _ORDER))
    assert not all(a == b for a, b in pairs(_FRAG, tuple(range(8))))
    assert not all(a == b for a, b in pairs((0, 1, 2, 3), _ORDER))


@pytest.mark.parametrize("hdp", [64, 128])
def test_transposed_panel_is_a_permutation(hdp):
    """The two 16-byte chunks a thread writes for column n of k8 step j
    (streamed rows 8j + {0,2,4,6} and 8j + {1,3,5,7}, at
    n * 32 + ((h ^ ((n >> 2) & 1)) << 4) of the panel: the 32-byte swizzle)
    cover each chunk of the panel once, and the panels of a tile sit
    hdp * 32 bytes apart."""
    offs = sorted(n * 32 + ((h ^ ((n >> 2) & 1)) << 4) for n in range(hdp) for h in range(2))
    assert offs == list(range(0, hdp * 32, 16))


def test_split_holds_two_tf32_steps():
    """big + small holds v to about 2^-22 of it: the split loses what the
    bar cannot see; one TF32 part alone (2^-11) does not."""
    rng = np.random.default_rng(1)
    v = (rng.standard_normal(4096) * np.exp2(rng.integers(-10, 10, 4096))).astype(np.float32)
    big = tf32_rna(v)
    small = tf32_rna(v - big)
    assert not ((big.view(np.uint32) | small.view(np.uint32)) & np.uint32(0x1FFF)).any()
    assert np.all(np.abs(big.astype(np.float64) + small - v) <= np.abs(v) * 2.0**-21)
    assert np.abs(big.astype(np.float64) - v).max() > 2.0**-14 * np.abs(v).max()


def _fp32_smem(head_pad: int, stages: int, dkv: bool) -> int:
    """`bwd_fp32_smem` of the source, written out over a block's columns
    (the head, or half of it at 256): the resident pair of 64 rows in two
    parts, the streamed pair's small parts, 4 (dK/dV) or 2 (dQ) transposed
    parts, per slot the raw pair (and 128 bytes each of lse and D for
    dK/dV), at 256 two slots of the other block's partials (128 threads x
    16 streamed rows of S and dP) and their two barriers, a barrier per
    slot and five more, 1024 bytes of alignment."""
    cols = min(head_pad, 128)
    tile = {64: 32, 128: 16}[cols]
    a, b = 64 * cols * 4, tile * cols * 4
    cluster = 8 * 2 + 2 * 128 * tile * 4 if head_pad == 256 else 0
    return (4 * a + (6 if dkv else 4) * b + stages * (2 * b + (256 if dkv else 0))
            + 8 * (5 + stages) + cluster + 1024)


@pytest.mark.parametrize("hd", list(range(16, 257, 16)))
@pytest.mark.parametrize("heads,kv_heads,t", [(8, 2, 301), (4, 4, 1023)])
def test_fp32_plan_fits(hd, heads, kv_heads, t):
    """Every head size takes the 3xTF32 kernels: streamed tiles of 32 rows
    at head_pad 64, 16 at 128 and at 256, where a cluster of two blocks
    splits the head's columns, 128 each; each ring as deep as the block's
    shared memory allows, 2 to 4 slots, the source's formula."""
    plan = at.flash_backward_launch_plan(2, heads, kv_heads, t, hd)
    hp = plan.head_pad
    assert (plan.fp32_route, plan.fp32_cluster, plan.fp32_rows, plan.fp32_tile) == {
        64: ("wgmma", 1, 64, 32), 128: ("wgmma", 1, 64, 16),
        256: ("wgmma_cluster", 2, 64, 16)}[hp]
    for stages, smem, dkv in ((plan.fp32_dkv_stages, plan.fp32_dkv_smem, True),
                              (plan.fp32_dq_stages, plan.fp32_dq_smem, False)):
        assert smem == _fp32_smem(hp, stages, dkv) == at.flash_bwd_fp32_smem(hp, stages, dkv)
        assert 2 <= stages <= at.FLASH_BWD_MAX_STAGES and smem <= H100_SMEM_PER_BLOCK
        assert stages == at.FLASH_BWD_MAX_STAGES or \
            _fp32_smem(hp, stages + 1, dkv) > H100_SMEM_PER_BLOCK
    assert plan.gqa_split == (heads > kv_heads)


@pytest.mark.parametrize("b,nh,n_kv,t,hd", [(1, 32, 32, 1024, 128), (1, 32, 8, 1023, 128),
                                            (2, 8, 2, 301, 64), (3, 2, 2, 1, 16),
                                            (1, 4, 1, 129, 256), (1, 8, 8, 4097, 128)])
def test_fp32_plan_covers_every_tile_once(b, nh, n_kv, t, hd):
    """dK/dV resident tile i (a block, or at head size 256 a cluster of
    two) runs key tile fp32_kv_order[i // g] of query head i % g (g = b *
    nh), dQ tile i query tile fp32_q_order[i // g]: every (head, tile of
    fp32_rows rows) once."""
    plan = at.flash_backward_launch_plan(b, nh, n_kv, t, hd)
    rows = plan.fp32_rows
    for order, blocks, g in ((plan.fp32_kv_order, plan.fp32_dkv_blocks, b * nh),
                             (plan.fp32_q_order, plan.fp32_dq_blocks, b * nh)):
        tiles = len(order)
        assert (tiles - 1) * rows < t <= tiles * rows and blocks == g * tiles
        got = sorted((order[i // g], i % g) for i in range(blocks))
        assert got == sorted((x, h) for x in range(tiles) for h in range(g))


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("t", [1023, 4096, 301])
def test_fp32_plan_longest_walks_first(t, hd):
    """Under causality a dK/dV block walks the streamed query tiles at or
    below its 64 keys, a dQ block the key tiles up to its diagonal: along
    each table, the kernels' launch order, that count never grows."""
    plan = at.flash_backward_launch_plan(1, 8, 2, t, hd)
    rows, tile = plan.fp32_rows, plan.fp32_tile
    streamed = -(-t // tile)
    dkv = [streamed - kt * rows // tile for kt in plan.fp32_kv_order]
    dq = [-(-min(t, (qt + 1) * rows) // tile) for qt in plan.fp32_q_order]
    for walks in (dkv, dq):
        assert walks == sorted(walks, reverse=True) and walks[0] == streamed


def test_fp32_wrappers_on_cpu_are_the_plain_twin():
    """On CPU tensors the fp32 wrappers return the plain backward and count
    no launch."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(1, 4, 2, 70, 64, seed=5))
    o = at.flash_attention_plain(q, k, v, True)
    lse = at._plain_lse(q, k, True, None)
    counts = (at.flash_attention_backward_dkv_fp32.launches,
              at.flash_attention_backward_dq_fp32.launches)
    ref = at.flash_attention_backward_plain(q, k, v, o, lse, do, True)
    dk, dv = at.flash_attention_backward_dkv_fp32(q, k, v, o, lse, do, True)
    dq = at.flash_attention_backward_dq_fp32(q, k, v, o, lse, do, True)
    assert all(torch.equal(a, r) for a, r in zip((dq, dk, dv), ref))
    assert (at.flash_attention_backward_dkv_fp32.launches,
            at.flash_attention_backward_dq_fp32.launches) == counts
