# SPDX-License-Identifier: Apache-2.0
"""HQQ+'s sub-word groups against hqq_tpu: 2-bit and 1.58-bit g8, 1-bit g8
and g16, axis=1.

In the kernel layout (`csrc/hqq_common.cuh`) a 32-bit word holds 32/cb
codes, so at these configs one word spans 2 or 4 groups: every 4-code field
lies in one group (4 | g), and each field takes its own group's scale and
zs. `hqq_tpu` fuses these layers under "pallas" and "w4a8"; so does the
port (before, its layout rule turned them away and they ran as canonical
`QuantLinear`s: under "w4a8" another function than `hqq_tpu`'s, whose int8
activations they lacked).

On the CPU the port's wrappers run their plain twins and `hqq_tpu` its
Pallas kernels in interpret mode. Bars (of max|y|):
  * the int8 route (M <= 32): 2e-5 against `hqq_tpu` and against
    x8*sx @ W_dq^T in float64 (the bar of `tests/test_w4a8.py`);
  * fp32 x on the bf16-operand route (M > 32, "pallas"): 1e-5, as
    `tests/test_torch_fused_matmul.py` holds it;
  * bf16 x: 2^-7 (a bf16 rounding of the output);
  * dequant_pallas: exact against the stored values in float64; against
    `hqq_tpu` two fp32 ulps of max|W| (fp32 meta), 2^-7 (bf16 meta, which
    `hqq_tpu` dequantizes in bf16 arithmetic);
  * greedy ids of a tiny Llama: equal.
Controls: each field given the scale and zs of its neighbour group in the
same word must miss the 2e-5 bar.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hqq_tpu.core.quantize import dequantize as j_dequantize
from hqq_tpu.core.quantize import quantize as j_quantize
from hqq_tpu.nn.linear import QuantLinear as JQuantLinear
from hqq_tpu.ops import fused_matmul as jf
from hqq_tpu.utils.patching import prepare_for_inference as j_prepare
from hqq_tpu_torch.ops import fused_matmul as tf
from hqq_tpu_torch.utils.convert import params_from_numpy
from hqq_tpu_torch.utils.patching import prepare_for_inference as t_prepare

# (nbits, g): HQQ+'s low-bit settings, each a group shorter than a word
CONFIGS = [(2, 8), (1.58, 8), (1, 8), (1, 16)]
_IDS = [f"{nbits}bit-g{g}" for nbits, g in CONFIGS]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch ops on one thread: the suite's workers share the cores, and
    torch's intra-op threads would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _layers(nbits, g, n_out=128, k=256, seed=0):
    """The same canonical axis=1 layer on both sides (fp32 compute), and the
    float64 W it dequantizes to."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n_out, k)) / np.sqrt(k)).astype(np.float32)
    qj = j_quantize(jnp.asarray(w), nbits=nbits, group_size=g, axis=1,
                    compute_dtype=jnp.float32)
    lj = JQuantLinear(qweight=qj)
    lt = params_from_numpy(_numpy(lj), "cpu")
    w_dq = np.asarray(j_dequantize(qj, jnp.float32)).astype(np.float64)
    return lj, lt, w_dq


def _x(m, k, seed):
    return np.random.default_rng(seed + 7).standard_normal((m, k)).astype(np.float32)


# -- the fault: these layers were kept canonical --------------------------------


@pytest.mark.parametrize("backend", ["w4a8", "pallas"])
@pytest.mark.parametrize("nbits,g", CONFIGS, ids=_IDS)
def test_subword_layer_converts_and_matches_hqq_tpu(nbits, g, backend):
    """Each config converts to `hqq_tpu`'s module class under both backends
    and gives its numbers: under "w4a8" the int8 route at M = 1, 4, 32 within
    2e-5 of max|y| of `hqq_tpu`'s `A8QuantLinear`, the bf16-operand route at
    M = 40 and "pallas" at every M within 1e-5."""
    lj, lt, w_dq = _layers(nbits, g, seed=int(nbits * 10) + g)
    mj = j_prepare({"q_proj": lj}, backend)["q_proj"]
    mt = t_prepare({"q_proj": lt}, backend)["q_proj"]
    assert type(mt).__name__ == type(mj).__name__ != "QuantLinear"
    for m in (1, 4, 32, 40):
        x = _x(m, 256, m)
        yj = np.asarray(mj(jnp.asarray(x))).astype(np.float64)
        yt = mt(torch.from_numpy(x)).numpy().astype(np.float64)
        scale = np.abs(yj).max()
        int8_route = backend == "w4a8" and m <= tf.A8_MAX_M
        assert np.abs(yt - yj).max() / scale < (2e-5 if int8_route else 1e-5), m
        if int8_route:  # and the function hqq_tpu computes: int8 activations
            x8, sx = tf.quantize_activations_int8(torch.from_numpy(x))
            want = (x8.numpy().astype(np.float64) * sx.numpy()) @ w_dq.T
        else:
            want = x.astype(np.float64) @ w_dq.T
        assert np.abs(yt - want).max() / np.abs(want).max() < (2e-5 if int8_route else 1e-5)


def _llama_tree(nbits, g, lora: bool):
    """A tiny Llama quantized at (nbits, g) axis=1 by hqq_tpu, with rank-8
    adapters (B from numpy, non-zero) when ``lora``."""
    from hqq_tpu.core import peft as jp
    from hqq_tpu.models import llama as jl
    from hqq_tpu.models import quantize_model as j_quantize_model
    from hqq_tpu.core.quantize import BaseQuantizeConfig as JConfig

    cfg = jl.LlamaConfig.tiny()
    params = jl.init_params(cfg, jax.random.PRNGKey(2), dtype=jnp.float32)
    q = j_quantize_model(params, JConfig(nbits=nbits, group_size=g), compute_dtype=jnp.float32)
    if not lora:
        return cfg, q
    lj = jp.PeftUtils.add_lora(q, jp.lora_config(r=8, lora_alpha=16), jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)

    def fill(tree):
        if isinstance(tree, dict):
            return {k: fill(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [fill(v) for v in tree]
        if isinstance(tree, jp.LoRALinear):
            b = (rng.standard_normal(tree.lora_b.shape) * 0.05).astype(np.float32)
            return tree.replace(lora_b=jnp.asarray(b))
        return tree

    return cfg, fill(lj)


@pytest.mark.parametrize("lora", [False, True], ids=["base", "lora"])
@pytest.mark.parametrize("backend", ["w4a8", "pallas"])
@pytest.mark.parametrize("nbits,g", CONFIGS, ids=_IDS)
def test_prepare_converts_the_same_leaves(nbits, g, backend, lora, capsys):
    """`prepare_for_inference` converts as many leaves and keeps as many as
    `hqq_tpu`'s on a tiny tree, each to the same class."""
    _, tree = _llama_tree(nbits, g, lora)
    j_prepare(tree, backend, verbose=True)
    said_j = capsys.readouterr().out.strip().splitlines()[-1]
    out = t_prepare(params_from_numpy(_numpy(tree), "cpu"), backend, verbose=True)
    said_t = capsys.readouterr().out.strip().splitlines()[-1]
    assert said_t == said_j and "'kept': 0" in said_t, (said_t, said_j)
    name = ("A8" if backend == "w4a8" else "Pallas") + ("LoRA" if lora else "") + "QuantLinear"
    assert type(out["layers"][0]["mlp"]["down_proj"]).__name__ == name


def test_k_not_whole_words_is_refused():
    """K = 40 at 1-bit g8 is 5 groups but no whole 32-bit word: `hqq_tpu`
    pads K and fuses it; the port's layout refuses it with a ValueError
    naming the config, so `prepare_for_inference` raises rather than keep
    the layer canonical (ROADMAP §3, a departure)."""
    lj, lt, _ = _layers(1, 8, n_out=16, k=40)
    assert jf.supports_kernel_layout(lj.qweight) and tf.supports_kernel_layout(lt.qweight)
    with pytest.raises(ValueError, match="1-bit g8 axis=1 needs K in whole 32-bit words"):
        tf.to_kernel_layout(lt.qweight)
    for backend in ("pallas", "w4a8"):
        with pytest.raises(ValueError, match="whole 32-bit words"):
            t_prepare({"q_proj": lt}, backend)


# -- each route against hqq_tpu, fp32 and bf16 meta ------------------------------


def _carry(nbits, g, meta, n_out=128, k=256, seed=0):
    """One canonical weight, both packages' kernel layouts with ``meta``
    ("fp32" or "bf16") scale and zs, and the float64 W of the port's."""
    rng = np.random.default_rng(seed + int(nbits * 100) + g)
    w = (rng.standard_normal((n_out, k)) / np.sqrt(k)).astype(np.float32)
    qj = j_quantize(jnp.asarray(w), nbits=nbits, group_size=g, axis=1, compute_dtype=jnp.float32)
    kj = jf.to_kernel_layout(qj, meta_dtype=jnp.bfloat16 if meta == "bf16" else jnp.float32)
    kt = tf.to_kernel_layout(params_from_numpy(_numpy(qj), "cpu"),
                             torch.bfloat16 if meta == "bf16" else torch.float32)
    w64 = tf.dequant_plain(kt, torch.float64).numpy()
    return kj, kt, w64


def _rel(y, ref) -> float:
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    return np.abs(y - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("meta", ["fp32", "bf16"])
@pytest.mark.parametrize("nbits,g", CONFIGS, ids=_IDS)
def test_layout_and_dequant_pallas(nbits, g, meta):
    """The port stores the scale and zs `hqq_tpu` stores (bf16: bit for bit;
    fp32: the same scale, zs to fp32 rounding of zero*scale), its words
    unpack to `hqq_tpu`'s codes, and `dequant_pallas` gives W^T."""
    kj, kt, w64 = _carry(nbits, g, meta)
    groups = 256 // g
    assert kt.container_bits == tf._KERNEL_CONTAINER_BITS[nbits] and kt.group_size == g
    codes_j = np.asarray(jf.unpack_codes_host(kj))[:256, :128].T
    assert np.array_equal(tf._unpack_words(kt.wq, kt.container_bits).numpy(), codes_j)
    for name in ("scale", "zs"):
        want = np.asarray(getattr(kj, name).astype(jnp.float32))[:groups, :128].T
        got = getattr(kt, name)[:, :groups].float().numpy()
        if meta == "bf16" or name == "scale":
            assert np.array_equal(got, want), name
        else:
            np.testing.assert_allclose(got, want, rtol=2 * np.finfo(np.float32).eps, atol=0)
    dj = np.asarray(jf.dequant_pallas(kj, jnp.float32).astype(jnp.float32))[:256, :128]
    dt = tf.dequant_pallas(kt).numpy()
    assert dt.shape == (256, 128)
    np.testing.assert_array_equal(dt, w64.T.astype(np.float32))
    if meta == "fp32":
        ulp = np.finfo(np.float32).eps * np.abs(dj).max()
        np.testing.assert_allclose(dt, dj, rtol=0, atol=2 * ulp)
    else:  # hqq_tpu computes c*s - zs in bf16 there and writes bf16
        assert _rel(dt, dj) < 2.0**-7


@pytest.mark.parametrize("x_dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("meta", ["fp32", "bf16"])
@pytest.mark.parametrize("nbits,g", CONFIGS, ids=_IDS)
def test_quant_matmul_pallas(nbits, g, meta, x_dtype):
    """Row 1's entry: fp32 x within 1e-5 of max|y| of the float64 product
    with the stored values, and of `hqq_tpu` where both keep fp32 meta
    (bf16 meta: `hqq_tpu` dequantizes in bf16 arithmetic, 2^-7); bf16 x
    within 2^-7 (an output rounding)."""
    kj, kt, w64 = _carry(nbits, g, meta, seed=1)
    x = _x(40, 256, 3)
    if x_dtype == "bf16":
        xt = torch.from_numpy(x).to(torch.bfloat16)
        xj = jnp.asarray(x).astype(jnp.bfloat16)
        x64 = xt.double().numpy()
    else:
        xt, xj, x64 = torch.from_numpy(x), jnp.asarray(x), x.astype(np.float64)
    yt = tf.quant_matmul_pallas(xt, kt)
    yj = np.asarray(jf.quant_matmul_pallas(xj, kj).astype(jnp.float32))
    assert yt.dtype == xt.dtype and tuple(yt.shape) == (40, 128)
    yt = yt.float().numpy()
    fp32 = x_dtype == "fp32"
    assert _rel(yt, yj) < (1e-5 if fp32 and meta == "fp32" else 2.0**-7)
    want = x64 @ (w64 if fp32 else torch.from_numpy(w64).to(torch.bfloat16).double().numpy()).T
    assert _rel(yt, want) < (1e-5 if fp32 else 2.0**-7)


@pytest.mark.parametrize("meta", ["fp32", "bf16"])
@pytest.mark.parametrize("nbits,g", CONFIGS, ids=_IDS)
def test_quant_matmul_pallas_a8(nbits, g, meta):
    """Rows 2/3 at M = 1, 4, 8, 32 (int8 activations: 2e-5 of max|y| against
    `hqq_tpu` and against x8*sx @ W^T) and row 1 at M = 40 (fp32 x: 1e-5 of
    the float64 product; against `hqq_tpu` 1e-5, 2^-7 on bf16 meta)."""
    kj, kt, w64 = _carry(nbits, g, meta, seed=2)
    for m in (1, 4, 8, 32, 40):
        x = _x(m, 256, m)
        yj = np.asarray(jf.quant_matmul_pallas_a8(jnp.asarray(x), kj))
        yt = tf.quant_matmul_pallas_a8(torch.from_numpy(x), kt).numpy()
        if m <= tf.A8_MAX_M:
            x8, sx = tf.quantize_activations_int8(torch.from_numpy(x))
            want = (x8.numpy().astype(np.float64) * sx.numpy()) @ w64.T
            assert _rel(yt, yj) < 2e-5 and _rel(yt, want) < 2e-5, m
        else:
            assert _rel(yt, x.astype(np.float64) @ w64.T) < 1e-5
            assert _rel(yt, yj) < (1e-5 if meta == "fp32" else 2.0**-7)


@pytest.mark.parametrize("entry", ["pallas_lora", "a8_lora"])
@pytest.mark.parametrize("meta", ["fp32", "bf16"])
@pytest.mark.parametrize("nbits,g", CONFIGS, ids=_IDS)
def test_lora_entries(nbits, g, meta, entry):
    """Rows 7 and 8: x @ W^T + (x @ A) @ B at M = 3 (the a8 entry's int8
    route, row 8) and M = 40 (row 7), rank 8, within 2e-5 of max|y| of
    `hqq_tpu` (2^-7 where `hqq_tpu` dequantizes bf16 meta in bf16 on row
    7) and of the float64 function."""
    kj, kt, w64 = _carry(nbits, g, meta, seed=3)
    rng = np.random.default_rng(5)
    a = (rng.standard_normal((256, 8)) / 16).astype(np.float32)
    b = (rng.standard_normal((8, 128)) * 0.05).astype(np.float32)
    fj = jf.quant_matmul_pallas_lora if entry == "pallas_lora" else jf.quant_matmul_pallas_a8_lora
    ft = tf.quant_matmul_pallas_lora if entry == "pallas_lora" else tf.quant_matmul_pallas_a8_lora
    for m in (3, 40):
        x = _x(m, 256, 10 + m)
        yj = np.asarray(fj(jnp.asarray(x), kj, jnp.asarray(a), jnp.asarray(b)))
        yt = ft(torch.from_numpy(x), kt, torch.from_numpy(a), torch.from_numpy(b)).numpy()
        xq = x.astype(np.float64)
        int8_route = entry == "a8_lora" and m <= tf.A8_MAX_M
        if int8_route:  # the base sees int8 activations, the adapter the exact ones
            x8, sx = tf.quantize_activations_int8(torch.from_numpy(x))
            xq = x8.numpy().astype(np.float64) * sx.numpy()
        want = xq @ w64.T + (x.astype(np.float64) @ a) @ b
        assert _rel(yt, want) < 2e-5, m
        assert _rel(yt, yj) < (2e-5 if int8_route or meta == "fp32" else 2.0**-7), m


# -- the CUDA-core kernel's walk over the words, emulated -------------------------


def _emulate_dp4a(x8, sx, kqt, neighbour=False):
    """`w4a8_dp4a_kernel` on the packed words, in numpy: for each group its
    g/4 fields, field f = (k % C) / 4 of word k / C (k = grp*g + 4q), four
    byte codes by shift and mask, exact int dots and xsum; lane grp % 32
    folds s*dot - xsum*z in group order (fp32 fma), the butterfly, times sx.
    ``neighbour``: each field takes the meta of the other group of its pair
    in the word (grp ^ 1): the fault such a layout invites."""
    m, k = x8.shape
    n, g, cb = kqt.n, kqt.group_size, kqt.container_bits
    per_word = 32 // cb
    words = kqt.wq.numpy().view(np.uint32).reshape(n, -1).astype(np.int64)
    s = kqt.scale.float().numpy()
    z = kqt.zs.float().numpy()
    mask = ((1 << cb) - 1) * 0x01010101
    xi = x8.astype(np.int64)
    lanes = np.zeros((32, n, m), np.float32)
    f64 = np.float64

    def fma(a, b, c):
        return (np.asarray(a, f64) * np.asarray(b, f64) + np.asarray(c, f64)).astype(np.float32)

    for grp in range(k // g):
        idot = np.zeros((n, m), np.int64)
        xsum = np.zeros(m, np.int64)
        for q in range(g // 4):
            kq = grp * g + 4 * q
            f = (kq % per_word) // 4
            field = (words[:, kq // per_word] >> (cb * f)) & mask
            c4 = (field[:, None] >> (8 * np.arange(4))) & 0xFF  # [n, 4] codes kq..kq+3
            idot += c4 @ xi[:, kq:kq + 4].T
            xsum += xi[:, kq:kq + 4].sum(axis=1)
        mi = grp ^ 1 if neighbour else grp
        lane = grp % 32
        a_ = fma(s[:, mi][:, None], idot.astype(np.float32), lanes[lane])
        lanes[lane] = fma(-xsum.astype(np.float32)[None, :], z[:, mi][:, None], a_)
    for off in (16, 8, 4, 2, 1):
        lanes = (lanes + lanes[np.arange(32) ^ off]).astype(np.float32)
    return fma(lanes[0].T, sx.reshape(-1, 1), 0.0)


@pytest.mark.parametrize("nbits,g", CONFIGS, ids=_IDS)
def test_dp4a_walk_matches_plain_and_hqq_tpu(nbits, g):
    """Code rows off the 16-byte rule of a TMA map (K = 480: 120 or 60
    bytes) keep these groups on the CUDA cores, whose walk over the words
    (emulated) is within 1e-5 of max|y| of the plain twin and of `hqq_tpu`'s
    int8 route; a field reading its neighbour group's meta in the same word
    misses the bar. (At K = 512 the plan takes the small-group route,
    `tests/test_torch_w4a8_groups.py`.)"""
    kj, kt, _ = _carry(nbits, g, "fp32", n_out=96, k=480, seed=4)
    for m in (1, 8, 32):
        plan = tf.w4a8_launch_plan(m, kt.n, kt.k, kt.container_bits, g)
        assert plan.route == "cuda_cores" and plan.smem == tf.w4a8_dp4a_smem(g)
        assert tf.w4a8_launch_plan(m, kt.n, 512, kt.container_bits, g).route == "group_mma"
        x = _x(m, 480, 20 + m)
        x8, sx = tf.quantize_activations_int8(torch.from_numpy(x))
        got = _emulate_dp4a(x8.numpy(), sx.numpy(), kt)
        plain = tf.w4a8_matmul_plain(x8, sx, kt).numpy()
        assert _rel(got, plain) < 1e-5
        assert _rel(got, np.asarray(jf.quant_matmul_pallas_a8(jnp.asarray(x), kj))) < 1e-5
        assert _rel(_emulate_dp4a(x8.numpy(), sx.numpy(), kt, neighbour=True), plain) > 2e-5


# -- a tiny Llama at 2-bit g8 through Generator and the paged engine -----------------


_PROMPTS = [[1, 7, 3, 9, 11], [4, 5, 6, 200, 17]]
_ENGINE_KW = dict(batch_slots=2, num_pages=24, page_size=8, max_pages_per_seq=4)


def _engine_ids(engine_cls, params, cfg, **kw):
    eng = engine_cls(params, cfg, **_ENGINE_KW, **kw)
    uids = [eng.add_request(np.asarray(p, np.int32), max_new_tokens=6) for p in _PROMPTS]
    out = eng.run()
    eng.close()
    return [list(out[u]) for u in uids]


@pytest.fixture(scope="module")
def llama_2bit_g8():
    """hqq_tpu's greedy ids from the tiny Llama at 2-bit g8 on "w4a8", with
    and without rank-8 adapters: its generate and its paged engine, run
    once; and the port's trees from the same weights."""
    from hqq_tpu.engine.hf import HQQModel as JModel
    from hqq_tpu.serving.paged import PagedBatchingEngine as JEngine

    runs = {}
    for lora in (False, True):
        cfg, tree = _llama_tree(2, 8, lora)
        jtree = j_prepare(tree, "w4a8")
        jm = JModel(params=jtree, cfg=cfg, quantized=True)
        gen = np.asarray(jm.generate(_PROMPTS, max_new_tokens=8, cache_dtype=jnp.float32))
        eng = _engine_ids(JEngine, jtree, cfg, cache_dtype=jnp.float32)
        runs[lora] = (gen, eng, lambda tree=tree: params_from_numpy(_numpy(tree), "cpu"))
    return runs


@pytest.mark.parametrize("lora", [False, True], ids=["base", "lora"])
def test_tiny_llama_2bit_g8_greedy_ids(llama_2bit_g8, lora):
    """Greedy ids through `Generator` (`HQQModel.generate`) and the paged
    engine on "w4a8" equal `hqq_tpu`'s, every linear on the int8 route at
    decode (`A8QuantLinear`, `A8LoRAQuantLinear` with an adapter)."""
    from hqq_tpu_torch.engine.hf import HQQModel as TModel
    from hqq_tpu_torch.models import llama as tl
    from hqq_tpu_torch.serving.paged import PagedBatchingEngine as TEngine

    gen_j, eng_j, fresh = llama_2bit_g8[lora]
    cfg = tl.LlamaConfig.tiny()
    tm = TModel(params=fresh(), cfg=cfg, quantized=True).prepare_for_inference("w4a8")
    name = "A8LoRAQuantLinear" if lora else "A8QuantLinear"
    assert type(tm.params["layers"][1]["self_attn"]["o_proj"]).__name__ == name
    got = tm.generate(_PROMPTS, max_new_tokens=8, cache_dtype=torch.float32)
    np.testing.assert_array_equal(got, gen_j)
    tree = t_prepare(fresh(), "w4a8")
    assert _engine_ids(TEngine, tree, cfg, cache_dtype=torch.float32, device="cpu") == eng_j


# -- the helpers of hqq_tpu.utils.patching that ride along ---------------------------


def test_auto_mix_plan_matches():
    """The per-tag plan equals `hqq_tpu`'s with no budget, under budgets that
    demote none, some and all tags, and with a reserve."""
    from hqq_tpu.utils.patching import auto_mix_plan as j_plan
    from hqq_tpu_torch.utils.patching import auto_mix_plan as t_plan

    _, tree = _llama_tree(4, 64, False)
    ttree = params_from_numpy(_numpy(tree), "cpu")
    full = sum(t.qweight.shape[0] * t.qweight.shape[1] for t in _quant_leaves(ttree))
    assert t_plan(ttree) == j_plan(tree)
    assert set(t_plan(ttree).values()) == {"int8"}
    for budget, reserve in ((10 * full, 0), (full * 3 // 4, 0), (full // 2, 0), (1, 0),
                            (full, full // 4)):
        assert t_plan(ttree, budget, reserve) == j_plan(tree, budget, reserve), (budget, reserve)
    assert set(t_plan(ttree, 1).values()) == {"w4a8"}
    assert set(t_plan(ttree, full * 3 // 4).values()) == {"int8", "w4a8"}


def _quant_leaves(tree):
    from hqq_tpu_torch.models.base import iter_linears
    from hqq_tpu_torch.nn.linear import QuantLinear

    return [node for _, node in iter_linears(tree) if isinstance(node, QuantLinear)]


@pytest.mark.parametrize("shape,rank", [((48, 32), 4), ((32, 48), 8), ((24, 16), 40)])
def test_lowrank_approx_matches(shape, rank):
    """The factors equal `hqq_tpu`'s up to a sign per rank (the solvers'
    own), A @ B to fp32 rounding, and the rank is cut at min(out, in)."""
    from hqq_tpu.utils.patching import lowrank_approx as j_lowrank
    from hqq_tpu_torch.utils.patching import lowrank_approx as t_lowrank

    w = np.random.default_rng(rank).standard_normal(shape).astype(np.float32)
    aj, bj = (np.asarray(t) for t in j_lowrank(jnp.asarray(w), rank))
    at, bt = t_lowrank(torch.from_numpy(w), rank)
    r = min(rank, *shape)
    assert tuple(at.shape) == aj.shape == (shape[1], r) and tuple(bt.shape) == bj.shape == (r, shape[0])
    sign = np.sign((at.numpy() * aj).sum(axis=0))
    np.testing.assert_allclose(at.numpy() * sign, aj, rtol=0, atol=1e-4 * np.abs(aj).max())
    np.testing.assert_allclose(bt.numpy() * sign[:, None], bj, rtol=0, atol=1e-4)
    prod = aj.astype(np.float64) @ bj
    np.testing.assert_allclose((at @ bt).numpy(), prod, rtol=0, atol=1e-5 * np.abs(prod).max())
    if r == min(shape):  # full rank: W^T itself
        np.testing.assert_allclose((at @ bt).numpy(), w.T, rtol=0, atol=1e-4 * np.abs(w).max())


def test_merge_zeros_into_lora_matches():
    """A per-channel layer's zero point as the rank-1 term a = ones, b =
    -zero*scale: equal to `hqq_tpu`'s; a grouped layer is refused."""
    from hqq_tpu.utils.patching import merge_zeros_into_lora as j_merge
    from hqq_tpu_torch.utils.patching import merge_zeros_into_lora as t_merge

    lj, lt, w_dq = _layers(4, 256, n_out=64, k=256)
    aj, bj = (np.asarray(t) for t in j_merge(lj))
    at, bt = t_merge(lt)
    np.testing.assert_array_equal(at.numpy(), aj)
    np.testing.assert_array_equal(bt.numpy(), bj)
    assert at.dtype == bt.dtype == torch.float32
    # the symmetric part plus the term gives the layer's W back
    qt = lt.qweight
    codes = tf.unpack_codes(qt, torch.float32).reshape(qt.shape)
    sym = (codes * qt.scale.reshape(-1, 1)).double().numpy()
    np.testing.assert_allclose(sym + (at @ bt).double().numpy().T, w_dq, rtol=0,
                               atol=1e-6 * np.abs(w_dq).max())
    _, grouped, _ = _layers(4, 64, n_out=64, k=256)
    with pytest.raises(ValueError, match="per-channel"):
        t_merge(grouped)
