# SPDX-License-Identifier: Apache-2.0
"""The MoE layers of hqq_tpu_torch (`nn/moe.py`) and the grouped expert
kernel's host side against hqq_tpu, on the CPU.

* `moe_dispatch`: dispatch equal and combine within 1e-6 of hqq_tpu's on
  random router probabilities, on a case that drops assignments at
  capacity, and on forced ties (`jax.lax.top_k` takes the lower expert
  first; a stable descending sort gives the same order, `torch.topk`
  promises none).
* `quantize_grouped` against hqq_tpu's at the reference bars (codes match >
  0.999, scale rtol 1e-5, zero rtol 1e-4).
* `GroupedQuantLinear.dequantize` and its forward on hqq_tpu's quantized
  stack (carried by `params_from_numpy`): W bit-equal, y within 1e-6 of max|y|
  in fp32; the stacked `dequant_canonical` bit-equal to E single calls.
* `grouped_matmul_plain` (the kernel's twin) within 2^-7 of max|y| of
  hqq_tpu's `GroupedQuantLinear.__call__` in bf16, and within 1e-6 of the
  fp32 dequantized stack's product.
* `grouped_matmul_plan`: the kernel at C = 1 and 32, the dequantized stack
  and `torch.bmm` at C = 33, for 2-bit g16 and every other case the kernel
  does not take.
* On the card (``-m cuda``; skips here): the kernel against its twin.

JAX is imported inside the tests, so that the `cuda` case runs where it is
not installed (`python3 -m pytest --noconftest -m cuda tests/test_torch_moe.py`).
"""

import dataclasses

import numpy as np
import pytest
import torch

from hqq_tpu_torch.nn import moe as tmoe
from hqq_tpu_torch.ops import fused_matmul as fm

TOL_BF16 = 2.0**-7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch ops on one thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _probs(t, e, seed):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((t, e)).astype(np.float32) * 2
    p = np.exp(logits - logits.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


def _ties(t, e, seed):
    """Rows with equal probabilities at the top, in the middle and everywhere
    (bf16 router logits make such rows), in float32."""
    rng = np.random.default_rng(seed)
    p = rng.integers(1, 4, (t, e)).astype(np.float32)  # values 1..3: many ties
    p[0] = 1.0  # all equal
    p[1, :] = 1.0
    p[1, e - 1] = p[1, 0] = 2.0  # the top two tied at both ends
    return p / p.sum(-1, keepdims=True)


# (name, probs, top_k, capacity)
DISPATCH_CASES = {
    "random": (lambda: _probs(16, 8, 0), 2, 8),
    "random_top4": (lambda: _probs(24, 8, 1), 4, 12),
    "random_tight": (lambda: _probs(32, 4, 2), 2, 5),  # drops some
    "capacity_drop": (lambda: np.asarray([[1.0, 0.0], [1.0, 0.0], [1.0, 0.0]], np.float32), 1, 2),
    "ties": (lambda: _ties(12, 6, 3), 2, 4),
    "ties_top3": (lambda: _ties(10, 8, 4), 3, 4),
}


@pytest.mark.parametrize("case", DISPATCH_CASES)
def test_moe_dispatch_matches_hqq_tpu(case):
    import jax.numpy as jnp

    from hqq_tpu.nn.moe import moe_dispatch as j_dispatch

    make, k, cap = DISPATCH_CASES[case]
    p = make()
    dj, cj = (np.asarray(a) for a in j_dispatch(jnp.asarray(p), k, cap))
    dt, ct = tmoe.moe_dispatch(torch.from_numpy(p), k, cap)
    assert dt.dtype == torch.bool and ct.dtype == torch.float32
    np.testing.assert_array_equal(dt.numpy(), dj)
    np.testing.assert_allclose(ct.numpy(), cj, rtol=0, atol=1e-6)
    if case == "capacity_drop":
        assert int(dt.sum()) == 2  # the third token past capacity 2 is dropped


def test_ties_take_the_lower_expert_first():
    """Equal probabilities: the lower expert wins, whatever torch.topk does."""
    p = torch.full((3, 8), 1.0 / 8)
    d, c = tmoe.moe_dispatch(p, 2, 3)
    assert d[:, :2].any(-1).all() and not d[:, 2:].any()  # [T, E, C]: experts 0 and 1
    np.testing.assert_allclose(c.sum((1, 2)).numpy(), 1.0, rtol=0, atol=1e-7)


@pytest.mark.parametrize("tokens,k,e,cf", [(8, 2, 8, 2.0), (1, 2, 8, 2.0), (8, 2, 8, 4.0),
                                           (8, 8, 128, 2.0), (3, 4, 32, 2.0), (5, 2, 4, 1.3)])
def test_capacity_matches_hqq_tpu(tokens, k, e, cf):
    want = max(int(-(-(tokens * k / e * cf) // 1)), 1)  # hqq_tpu's expression
    assert tmoe.moe_capacity(tokens, k, e, cf) == want
    if (tokens, k, e, cf) == (8, 8, 128, 2.0):
        assert want == 1  # Qwen3-MoE at 8 slots: one slot an expert


def _stack(e=3, n=64, k=128, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((e, n, k)) / 8).astype(np.float32)


@pytest.mark.parametrize("nbits,g", [(4, 64), (4, 32), (2, 16), (3, 64)])
def test_quantize_grouped_matches_hqq_tpu(nbits, g):
    import jax.numpy as jnp

    from hqq_tpu.core.quantize import QTensor as JQT
    from hqq_tpu.core.quantize import unpack_codes as j_unpack
    from hqq_tpu.nn.moe import quantize_grouped as j_qg

    from hqq_tpu_torch.core.quantize import unpack_codes as t_unpack

    w = _stack(seed=nbits + g)
    qj = j_qg(jnp.asarray(w), nbits=nbits, group_size=g, compute_dtype=jnp.float32)
    qt = tmoe.quantize_grouped(torch.from_numpy(w), nbits=nbits, group_size=g,
                               compute_dtype=torch.float32)
    assert (qt.nbits, qt.group_size, qt.axis, qt.shape, qt.packing) == (
        qj.nbits, qj.group_size, qj.axis, tuple(qj.shape), qj.packing)
    assert tuple(qt.wq.shape) == qj.wq.shape and qt.n_experts == 3
    for e in range(3):
        cj = np.asarray(j_unpack(JQT(wq=qj.wq[e], scale=qj.scale[e], zero=qj.zero[e],
                                     nbits=qj.nbits, group_size=g, axis=1, shape=qj.shape,
                                     packing=qj.packing), jnp.int32))
        ct = t_unpack(fm.expert_qtensor(qt.qtensor(), e), torch.int32).numpy()
        assert np.mean(ct == cj) > 0.999
    np.testing.assert_allclose(qt.scale.numpy(), np.asarray(qj.scale), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(qt.zero.numpy(), np.asarray(qj.zero), rtol=1e-4, atol=5e-4)


@pytest.fixture(scope="module")
def jax_stacks():
    """hqq_tpu's quantized stacks (fp32 and bf16 compute, 4-bit g64 and
    2-bit g16), their dequantized weights and their outputs on fixed x."""
    import jax
    import jax.numpy as jnp

    from hqq_tpu.nn.moe import quantize_grouped as j_qg

    out = {}
    rng = np.random.default_rng(7)
    for name, nbits, g, dt in (("4bit_fp32", 4, 64, jnp.float32),
                               ("4bit_bf16", 4, 64, jnp.bfloat16),
                               ("2bit_fp32", 2, 16, jnp.float32)):
        w = _stack(e=4, n=96, k=192, seed=nbits)
        qj = j_qg(jnp.asarray(w), nbits=nbits, group_size=g, compute_dtype=dt)
        x = rng.standard_normal((4, 5, 192)).astype(np.float32)
        xj = jnp.asarray(x, dt)
        out[name] = dict(np_q=jax.tree_util.tree_map(np.asarray, qj), x=x,
                         w=np.asarray(qj.dequantize(jnp.float32)),
                         y=np.asarray(qj(xj).astype(jnp.float32)),
                         y_bf16=np.asarray(qj(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32)))
    return out


def _port_stack(np_q):
    from hqq_tpu_torch.utils import params_from_numpy

    return params_from_numpy(np_q, "cpu")


@pytest.mark.parametrize("name", ["4bit_fp32", "4bit_bf16", "2bit_fp32"])
def test_grouped_quant_linear_matches_hqq_tpu(jax_stacks, name):
    r = jax_stacks[name]
    gq = _port_stack(r["np_q"])
    assert isinstance(gq, tmoe.GroupedQuantLinear) and gq.n_experts == 4
    np.testing.assert_array_equal(gq.dequantize(torch.float32).numpy(), r["w"])
    x = torch.from_numpy(r["x"]).to(gq.compute_dtype)
    y = gq(x).float().numpy()
    bar = 1e-6 if gq.compute_dtype == torch.float32 else TOL_BF16
    assert np.abs(y - r["y"]).max() <= bar * np.abs(r["y"]).max()


@pytest.mark.parametrize("name", ["4bit_fp32", "2bit_fp32"])
def test_stacked_dequant_equals_single_calls(jax_stacks, name):
    gq = _port_stack(jax_stacks[name]["np_q"])
    qt = gq.qtensor()
    assert fm.stacked_experts(qt) == 4
    for dt in (torch.float32, torch.bfloat16):
        w = fm.dequant_canonical(qt, dt)
        assert w.shape == (4, 96, 192) and w.dtype == dt
        for e in range(4):
            assert torch.equal(w[e], fm.dequant_canonical(fm.expert_qtensor(qt, e), dt))


def test_grouped_twin_against_hqq_tpu_in_bf16(jax_stacks):
    """The kernel's twin on bf16 x against hqq_tpu's layer in bf16, and
    against the fp32 product of the dequantized stack."""
    r = jax_stacks["4bit_fp32"]
    gq = _port_stack(r["np_q"])
    qt = gq.qtensor()
    xb = torch.from_numpy(r["x"]).to(torch.bfloat16)
    y = fm.grouped_matmul_plain(xb, qt).float().numpy()
    yj = r["y_bf16"]
    assert np.abs(y - yj).max() <= TOL_BF16 * np.abs(yj).max()
    # the fp32 product of the bf16 W and x: y differs by its rounding to bf16
    w = fm.dequant_canonical(qt, torch.bfloat16).float()
    want = torch.bmm(xb.float(), w.transpose(1, 2)).numpy()
    assert np.abs(y - want).max() <= 2.0**-8 * np.abs(want).max()
    # fp32 x: the twin is the fp32 product itself
    xf = torch.from_numpy(r["x"])
    yf = fm.grouped_matmul_plain(xf, qt)
    wf = fm.dequant_canonical(qt, torch.float32)
    assert (yf - torch.bmm(xf, wf.transpose(1, 2))).abs().max() <= 1e-6 * yf.abs().max()
    # on the CPU the wrapper is its twin
    assert torch.equal(fm.grouped_matmul(xb, qt), fm.grouped_matmul_plain(xb, qt))


def _plan(c, k=4096, n=14336, x=torch.bfloat16, packing="4bit_u8", axis=1, g=64,
          meta=torch.float32, experts=8):
    return fm.grouped_matmul_plan(experts, c, k, n, x, packing, axis, g, meta)


@pytest.mark.parametrize("c,route,tiles", [(1, "kernel", 1), (4, "kernel", 1), (8, "kernel", 1),
                                           (9, "kernel", 2), (16, "kernel", 2),
                                           (17, "kernel", 4), (32, "kernel", 4),
                                           (33, "bmm", 0), (512, "bmm", 0)])
def test_grouped_plan_by_rows(c, route, tiles):
    p = _plan(c)
    assert (p.route, p.token_tiles) == (route, tiles)


@pytest.mark.parametrize("kw", [dict(packing="2bit_u8", g=16), dict(packing="3bit_32"),
                                dict(packing="8bit_u8"), dict(axis=0), dict(x=torch.float32),
                                dict(x=torch.float16), dict(meta=torch.float16),
                                dict(k=4064, g=32), dict(g=8), dict(n=14335),
                                dict(packing=None), dict(experts=70000)])
def test_grouped_plan_sends_the_rest_to_bmm(kw):
    assert _plan(4, **kw).route == "bmm"


@pytest.mark.parametrize("e,n,k", [(8, 14336, 4096), (8, 4096, 14336), (128, 768, 2048),
                                   (128, 2048, 768), (32, 5760, 2880), (32, 2880, 2880)])
def test_grouped_plan_takes_the_published_shapes(e, n, k):
    for c in (1, 2, 4, 32):
        p = _plan(c, k=k, n=n, experts=e)
        assert p.route == "kernel" and p.token_tiles == (1 if c <= 8 else 4)


def test_combine_reads_a_tokens_own_slots_only():
    """A token's combined output is bit-equal wherever its two slots lie
    and whatever its neighbours hold, and is its weights times its slots'
    outputs summed largest weight first (`hqq_tpu`'s einsum within fp32
    rounding)."""
    rng = np.random.default_rng(3)
    e, c, d = 8, 8, 64
    mine = torch.from_numpy(rng.standard_normal((2, d)).astype(np.float32))
    w = (0.6180339, 0.3819661)
    want = w[0] * mine[0] + w[1] * mine[1]
    for c1 in range(c):
        for c2 in range(c):
            comb = torch.zeros(4, e, c)
            comb[1, 2, c1], comb[1, 6, c2] = w
            for t in (0, 2, 3):  # neighbours in the other slots of the same experts
                comb[t, 2, (c1 + t + 1) % c], comb[t, 6, (c2 + t + 1) % c] = 0.5, 0.5
            out = torch.from_numpy(rng.standard_normal((e, c, d)).astype(np.float32))
            out[2, c1], out[6, c2] = mine[0], mine[1]
            got = tmoe.combine_experts(comb, out, 2)
            assert torch.equal(got[1], want)
            torch.testing.assert_close(got, torch.einsum("tec,ecd->td", comb, out), rtol=1e-6,
                                       atol=1e-6)


def test_moe_layer_routes_by_plan():
    """GroupedQuantLinear takes the kernel's wrapper where the plan does,
    the dequantized stack elsewhere; on the CPU both are the twins."""
    w = torch.from_numpy(_stack(e=2, n=64, k=128))
    gq = tmoe.quantize_grouped(w, nbits=4, group_size=64, compute_dtype=torch.bfloat16)
    x = torch.randn(2, 3, 128, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    before = fm.grouped_matmul.launches
    y = gq(x)  # the CPU twin: no launch counted
    assert fm.grouped_matmul.launches == before
    assert torch.equal(y, fm.grouped_matmul_plain(x, gq.qtensor()))
    x40 = torch.randn(2, 40, 128, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    w_dq = gq.dequantize(torch.bfloat16)
    assert torch.equal(gq(x40), torch.bmm(x40, w_dq.transpose(1, 2)))


def test_grouped_linear_matches_hqq_tpu():
    import jax.numpy as jnp

    from hqq_tpu.nn.moe import GroupedLinear as JGL

    rng = np.random.default_rng(3)
    w, b = _stack(e=3, n=32, k=48), rng.standard_normal((3, 32)).astype(np.float32)
    x = rng.standard_normal((3, 4, 48)).astype(np.float32)
    yj = np.asarray(JGL(weight=jnp.asarray(w), bias=jnp.asarray(b))(jnp.asarray(x)))
    y = tmoe.GroupedLinear(torch.from_numpy(w), torch.from_numpy(b))(torch.from_numpy(x))
    assert np.abs(y.numpy() - yj).max() <= 1e-6 * np.abs(yj).max()


@pytest.mark.cuda
def test_grouped_kernel_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for meta in (torch.float32, torch.bfloat16):
        for e, n, k, c in ((4, 64, 128, 3), (4, 130, 192, 9), (2, 256, 64, 17), (8, 512, 1024, 32),
                           (32, 384, 2880, 2)):
            w = torch.randn((e, n, k), generator=gen, device="cuda") / 8
            gq = tmoe.quantize_grouped(w, nbits=4, group_size=64 if k % 64 == 0 else 32)
            qt = dataclasses.replace(gq.qtensor(), scale=gq.scale.to(meta), zero=gq.zero.to(meta))
            x = torch.randn((e, c, k), generator=gen, device="cuda").to(torch.bfloat16)
            before = fm.grouped_matmul.launches
            y = fm.grouped_matmul(x, qt)
            assert fm.grouped_matmul.launches == before + 1
            ref = fm.grouped_matmul_plain(x, qt)
            assert (y.float() - ref.float()).abs().max() <= TOL_BF16 * ref.float().abs().max()
            assert torch.equal(y, fm.grouped_matmul(x, qt))
            w_st = fm.dequant_canonical(qt, torch.bfloat16)
            for i in range(e):
                assert torch.equal(w_st[i], fm.dequant_canonical(fm.expert_qtensor(qt, i),
                                                                 torch.bfloat16))
