# SPDX-License-Identifier: Apache-2.0
"""The backward of the port's flash attention against hqq_tpu's and the
library's references, on the CPU.

`flash_attention_backward_plain` is the plain twin of the dK/dV and dQ
kernels (csrc/flash_backward_sm90.cu for bf16 and fp16,
csrc/flash_backward_fp32_sm90.cu for fp32), which the card tests hold to
it. Here it is held, in fp32 (where its roundings of P and dS to the inputs'
type are no-ops), to:
  * `jax.vjp` of `hqq_tpu.ops.attention.prefill_attention` (its naive path on
    the CPU) with K and V repeated over each kv head's query heads, as
    `hqq_tpu`'s model does; the port shares them by index;
  * the library's own `mha_reference_bwd`, the VJP that its flash kernel's
    tests use, fed the library forward's saved statistics (its lse =
    m + log l).
GQA, ragged T, head sizes 64 and 128, causal and not. Bars: rel err < 1e-5
of max|grad| (the same fp32 products, summed in another order). Then the
autograd Function of `flash_attention`, `prefill_attention`'s routing under
autograd, the backward launch plan, and a check that the wrappers count no
launch on the CPU. In bf16 it is held to the library's own backward kernels
in test_torch_flash_backward_lib.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu import flash_attention as lib

from hqq_tpu.ops.attention import prefill_attention as j_prefill
from hqq_tpu_torch.ops import attention as at
from hqq_tpu_torch.ops.fused_matmul import H100_SMEM_PER_BLOCK

_CASES = [(1, 4, 2, 300, 64), (2, 2, 2, 257, 128), (1, 4, 1, 129, 64), (1, 2, 2, 256, 128)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch ops on one thread: the suite's workers share the cores, and
    torch's intra-op threads would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(b, nh, n_kv, t, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, nh, t, hd)).astype(np.float32)
    k = rng.standard_normal((b, n_kv, t, hd)).astype(np.float32)
    v = rng.standard_normal((b, n_kv, t, hd)).astype(np.float32)
    do = rng.standard_normal((b, nh, t, hd)).astype(np.float32)
    return q, k, v, do


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _port(q, k, v, do, causal, lse=None, o=None):
    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, do))
    if o is None:
        o = at.flash_attention_plain(qt, kt, vt, causal)
    if lse is None:
        lse = at._plain_lse(qt, kt, causal, None)
    return [x.numpy() for x in at.flash_attention_backward_plain(
        qt, kt, vt, torch.as_tensor(np.array(o)), torch.as_tensor(np.array(lse)), dot, causal)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,nh,n_kv,t,hd", _CASES)
def test_backward_plain_matches_prefill_attention_vjp(causal, b, nh, n_kv, t, hd):
    q, k, v, do = _inputs(b, nh, n_kv, t, hd, seed=t + hd + nh)
    rep = nh // n_kv

    def fwd(q, k, v):
        k, v = jnp.repeat(k, rep, axis=1), jnp.repeat(v, rep, axis=1)
        return j_prefill(q, k, v, causal=causal)

    _, vjp = jax.vjp(fwd, *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))
    got = _port(q, k, v, do, causal)
    for g, w in zip(got, want):
        assert g.shape == w.shape and _rel(g, w) < 1e-5


@pytest.mark.parametrize("b,nh,n_kv,t,hd", _CASES)
def test_backward_plain_matches_library_reference(b, nh, n_kv, t, hd):
    """mha_reference_bwd takes the scale folded into q (it refuses any other
    sm_scale): its dQ is then the gradient of the scaled q, scale times less
    than ours; its dK and dV are ours. lse = m + log l of its forward."""
    q, k, v, do = _inputs(b, nh, n_kv, t, hd, seed=7 * t + hd)
    rep, scale = nh // n_kv, hd**-0.5
    qs = jnp.asarray(q * scale)
    kr, vr = (jnp.repeat(jnp.asarray(x), rep, axis=1) for x in (k, v))
    o, l, m = lib.mha_reference_no_custom_vjp(qs, kr, vr, causal=True, save_residuals=True)
    dq, dk, dv, _ = lib.mha_reference_bwd(qs, kr, vr, None, None, o, l, m, jnp.asarray(do),
                                          causal=True)
    dk = np.asarray(dk).reshape(b, n_kv, rep, t, hd).sum(axis=2)
    dv = np.asarray(dv).reshape(b, n_kv, rep, t, hd).sum(axis=2)
    lse = np.asarray(m) + np.log(np.asarray(l))
    got = _port(q, k, v, do, True, lse=lse, o=np.asarray(o))
    for g, w in zip(got, (np.asarray(dq) * scale, dk, dv)):
        assert _rel(g, w) < 1e-5


def test_backward_controls_miss_the_bar():
    """The chip's controls, on the CPU: the D term dropped, and the causal
    mask shifted by one, each miss the bar by far."""
    q, k, v, do = _inputs(1, 4, 2, 300, 64, seed=3)
    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, do))
    o = at.flash_attention_plain(qt, kt, vt, True)
    lse = at._plain_lse(qt, kt, True, None)
    ref = at.flash_attention_backward_plain(qt, kt, vt, o, lse, dot, True)
    no_d = at.flash_attention_backward_plain(qt, kt, vt, torch.zeros_like(o), lse, dot, True)
    shifted = at.flash_attention_backward_plain(qt, kt, vt, o, lse, dot, False)
    for bad in (no_d, shifted):
        assert max(_rel(b.numpy(), r.numpy()) for b, r in zip(bad, ref)) > 1e-2


@pytest.mark.parametrize("t,flash", [(255, False), (256, True), (300, True)])
def test_prefill_attention_gradients(t, flash):
    """Under autograd, prefill_attention takes the flash Function from T =
    256 on (its backward is the plain twin on the CPU) and the naive path
    below; both give hqq_tpu's gradients."""
    q, k, v, do = _inputs(1, 4, 2, t, 64, seed=t)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = at.prefill_attention(qt, kt, vt, causal=True)
    assert (out.grad_fn.__class__.__name__ == "_FlashAttentionBackward") == flash
    got = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(do))

    def fwd(q, k, v):
        return j_prefill(q, jnp.repeat(k, 2, axis=1), jnp.repeat(v, 2, axis=1), causal=True)

    out_j, vjp = jax.vjp(fwd, *(jnp.asarray(x) for x in (q, k, v)))
    assert _rel(out.detach().numpy(), out_j) < 1e-5
    for g, w in zip(got, vjp(jnp.asarray(do))):
        assert _rel(g.numpy(), w) < 1e-5


def test_flash_function_counts_no_launch_on_cpu():
    q, k, v, do = _inputs(1, 2, 2, 256, 64, seed=1)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    wrappers = (at.flash_attention, at.flash_attention_fp32, at.flash_attention_backward_dkv,
                at.flash_attention_backward_dq, at.flash_attention_backward_dkv_fp32,
                at.flash_attention_backward_dq_fp32)
    counts = [w.launches for w in wrappers]
    at.flash_attention(qt, kt, vt).backward(torch.from_numpy(do))
    assert all(g is not None for g in (qt.grad, kt.grad, vt.grad))
    assert [w.launches for w in wrappers] == counts


@pytest.mark.parametrize("hd", list(range(16, 257, 16)))
def test_backward_plan_fits(hd):
    """Every head size pads to 64, 128 or 256. The wgmma kernels: dK/dV
    blocks of 128 keys (64 at 256, where the consumers split the head
    columns), dQ key tiles of 64 (32 at 256); each ring as deep as a block's
    shared memory allows, at most 4 slots and at least 2, its size the
    source's formula. The fp32 route: the 3xTF32 kernels (64 resident rows,
    streamed tiles of 32 rows at head_pad 64 and 16 at 128, rings of 2-4
    slots; at 256 a cluster of two blocks a resident tile, 128 head columns
    and 16 streamed rows each). Everything fits a block of the card."""
    plan = at.flash_backward_launch_plan(2, 8, 2, 300, hd)
    hp = plan.head_pad
    assert hp == next(p for p in (64, 128, 256) if p >= hd)
    assert (plan.dkv_keys, plan.dq_key_tile) == ((64, 32) if hp == 256 else (128, 64))
    assert plan.dkv_smem == 2 * plan.dkv_keys * hp * 2 + plan.dkv_stages * (
        2 * 64 * hp * 2 + 2 * 64 * 4) + 8 * (1 + 2 * plan.dkv_stages) + 1024
    assert plan.dq_smem == 2 * 128 * hp * 2 + plan.dq_stages * 2 * plan.dq_key_tile * hp * 2 \
        + 8 * (1 + 2 * plan.dq_stages) + 1024
    for stages, rows, smem_of in ((plan.dkv_stages, plan.dkv_keys, at.flash_bwd_dkv_smem),
                                  (plan.dq_stages, plan.dq_key_tile, at.flash_bwd_dq_smem)):
        assert 2 <= stages <= at.FLASH_BWD_MAX_STAGES
        assert smem_of(hp, rows, stages) <= H100_SMEM_PER_BLOCK
        assert stages == at.FLASH_BWD_MAX_STAGES or \
            smem_of(hp, rows, stages + 1) > H100_SMEM_PER_BLOCK
    assert plan.fp32_route == ("wgmma_cluster" if hp == 256 else "wgmma")
    assert (plan.fp32_cluster, plan.fp32_rows, plan.fp32_tile) == \
        {64: (1, 64, 32), 128: (1, 64, 16), 256: (2, 64, 16)}[hp]
    for stages, smem, dkv in ((plan.fp32_dkv_stages, plan.fp32_dkv_smem, True),
                              (plan.fp32_dq_stages, plan.fp32_dq_smem, False)):
        assert 2 <= stages <= at.FLASH_BWD_MAX_STAGES
        assert smem == at.flash_bwd_fp32_smem(hp, stages, dkv)
    assert max(plan.fp32_dkv_smem, plan.fp32_dq_smem) <= H100_SMEM_PER_BLOCK
    # a resident tile (a block, or a cluster at 256) per (batch, query head, tile)
    tiles = -(-300 // plan.fp32_rows)
    assert (plan.fp32_dkv_blocks, plan.fp32_dq_blocks) == (2 * 8 * tiles, 2 * 8 * tiles)


@pytest.mark.parametrize("kv_heads,t,split,blocks_dkv,blocks_dq", [
    (32, 1024, False, 256, 256), (8, 1023, True, 256, 256)])
def test_backward_plan_of_the_7b_path(kv_heads, t, split, blocks_dkv, blocks_dq):
    """Path I's shape (32 heads, head size 128, T = 1024) and its GQA
    variant: 8 key tiles of 128 and 8 query tiles of 128 per head; with 8 kv
    heads the dK/dV grid is split over the 32 query heads, 4x the 64 blocks
    of the kv heads."""
    plan = at.flash_backward_launch_plan(1, 32, kv_heads, t, 128)
    assert (plan.head_pad, plan.dkv_keys, plan.gqa_split) == (128, 128, split)
    assert (plan.dkv_blocks, plan.dq_blocks) == (blocks_dkv, blocks_dq)
    assert (plan.dkv_stages, plan.dq_stages) == (4, 4)
    # fp32: 64 resident rows and 16 streamed rows a step, 16 tiles per head
    assert (plan.fp32_route, plan.fp32_rows, plan.fp32_tile) == ("wgmma", 64, 16)
    assert (plan.fp32_dkv_blocks, plan.fp32_dq_blocks) == (512, 512)
    assert (plan.fp32_dkv_stages, plan.fp32_dq_stages) == (3, 4)


@pytest.mark.parametrize("b,nh,n_kv,t,hd", [(1, 32, 32, 1024, 128), (2, 8, 2, 300, 64),
                                            (1, 4, 1, 129, 256), (3, 2, 2, 1, 16),
                                            (1, 8, 8, 4097, 128)])
def test_backward_plan_covers_every_tile_once(b, nh, n_kv, t, hd):
    """The kernels run block i on tile order[i // (b * nh)] of (batch,
    query head) i % (b * nh): with the plan's block counts, every key tile
    (dK/dV) and every query tile of 128 rows (dQ) of every query head
    once."""
    plan = at.flash_backward_launch_plan(b, nh, n_kv, t, hd)
    for order, rows, blocks in ((plan.kv_order, plan.dkv_keys, plan.dkv_blocks),
                                (plan.q_order, at.FLASH_BWD_DQ_ROWS, plan.dq_blocks)):
        tiles = len(order)
        assert (tiles - 1) * rows < t <= tiles * rows
        assert sorted(order) == list(range(tiles)) and blocks == b * nh * tiles
        got = sorted((order[i // (b * nh)], i % (b * nh)) for i in range(blocks))
        assert got == sorted((x, h) for x in range(tiles) for h in range(b * nh))


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("t", [1023, 4096, 300])
def test_backward_plan_longest_walks_first(t, hd):
    """Under causality a dK/dV block walks the query tiles of 64 rows at or
    below its keys, a dQ block the key tiles up to its diagonal: along each
    table, the kernels' launch order, that count never grows."""
    plan = at.flash_backward_launch_plan(1, 8, 8, t, hd)
    q64 = -(-t // at.FLASH_BWD_QUERY_TILE)
    dkv = [q64 - kt * plan.dkv_keys // at.FLASH_BWD_QUERY_TILE for kt in plan.kv_order]
    dq = [-(-min(t, (qt + 1) * at.FLASH_BWD_DQ_ROWS) // plan.dq_key_tile) for qt in plan.q_order]
    for walks, longest in ((dkv, q64), (dq, -(-t // plan.dq_key_tile))):
        assert walks == sorted(walks, reverse=True) and walks[0] == longest


@pytest.mark.parametrize("heads,kv_heads,hd", [(8, 2, 8), (8, 2, 40), (8, 2, 272), (8, 3, 64)])
def test_backward_plan_refuses(heads, kv_heads, hd):
    with pytest.raises(ValueError):
        at.flash_backward_launch_plan(1, heads, kv_heads, 256, hd)
