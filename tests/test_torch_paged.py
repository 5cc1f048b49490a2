# SPDX-License-Identifier: Apache-2.0
"""hqq_tpu_torch's paged KV cache and paged serving engine against hqq_tpu's.

The same numpy-seeded inputs go through both packages on the CPU, where
hqq_tpu takes its gather-based `paged_attention_ref` and the port's kernel
wrapper its plain version. Tolerances: the page writes and `quant_rows` are
exact (the same fp32 operations in the same order); attention outputs 2e-4
(the bar of hqq_tpu's own paged tests: fp32 sums in another order);
`_forward_paged` logits 1e-5 of max|logits| in fp32; the engine's greedy
tokens are equal, case by case, on `LlamaConfig.tiny` 4-bit g32 in fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hqq_tpu.core.quantize import BaseQuantizeConfig as JConfig
from hqq_tpu.models import llama as jl
from hqq_tpu.models import quantize_model as j_quantize_model
from hqq_tpu.ops import paged as jp
from hqq_tpu.serving import generate as jg
from hqq_tpu.serving.paged import PagedBatchingEngine as JEngine
from hqq_tpu_torch.models import llama as tl
from hqq_tpu_torch.ops import paged as tp
from hqq_tpu_torch.serving import generate as tg
from hqq_tpu_torch.serving.paged import PagedBatchingEngine as TEngine
from hqq_tpu_torch.utils import paged_cache_from_numpy, params_from_numpy

_NP = {"float32": np.float32, "bfloat16": jnp.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch ops on one thread: the suite's workers share the cores, and
    torch's intra-op threads would oversubscribe them (an engine case of
    this module took 30-90 s beside five busy workers, 4 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a, copy=True))
    return t if dtype is None else t.to(dtype)


def _np(t):
    return t.to(torch.float32).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def test_quant_rows_matches():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    # ties of the rounding (x / scale * 127 = n + 0.5) and an all-zero row
    x[0, 0] = np.array([127.0] + [i + 0.5 for i in range(15)], np.float32)
    x[0, 1] = 0.0
    qj, sj = jp.quant_rows(jnp.asarray(x))
    qt, st = tp.quant_rows(_t(x))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32 and st.shape == (3, 5, 1)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def _pool_pair(cfg, num_pages, pg, dtype, quantize_kv, seed=0):
    """The same randomly filled paged cache in both packages."""
    jc = jp.init_paged_cache(cfg, num_pages, pg, _NP.get(dtype, jnp.float32),
                             quantize_kv=quantize_kv)
    rng = np.random.default_rng(seed)
    if quantize_kv:
        fill = dict(k=rng.integers(-127, 128, jc.k.shape).astype(np.int8),
                    v=rng.integers(-127, 128, jc.v.shape).astype(np.int8),
                    k_scales=rng.uniform(0.5, 2.0, jc.k_scales.shape).astype(np.float32),
                    v_scales=rng.uniform(0.5, 2.0, jc.v_scales.shape).astype(np.float32))
    else:
        fill = dict(k=rng.standard_normal(jc.k.shape).astype(np.float32),
                    v=rng.standard_normal(jc.v.shape).astype(np.float32))
    jc = jc.replace(**{n: jnp.asarray(a, getattr(jc, n).dtype) for n, a in fill.items()})
    tc = paged_cache_from_numpy(jax.tree_util.tree_map(np.asarray, jc), "cpu")
    return jc, tc


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_write_token_to_pages_matches(kind):
    cfg = jl.LlamaConfig.tiny()
    jc, tc = _pool_pair(cfg, 6, 4, kind, kind == "int8")
    assert tc.page_size == 4 and tc.num_pages == 6 and tc.quantized == (kind == "int8")
    assert tc.k.dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16,
                          "int8": torch.int8}[kind]
    rng = np.random.default_rng(1)
    b, h, hd = 4, cfg.num_key_value_heads, cfg.head_dim_
    kb = rng.standard_normal((b, h, hd)).astype(np.float32)
    vb = rng.standard_normal((b, h, hd)).astype(np.float32)
    # two dead slots on the same row of scratch page 0
    page_of = np.array([3, 0, 5, 0], np.int32)
    offset = np.array([1, 0, 3, 0], np.int32)
    jout = jp.write_token_to_pages(jc, 1, jnp.asarray(kb), jnp.asarray(vb),
                                   jnp.asarray(page_of), jnp.asarray(offset))
    k_before = tc.k.clone()
    tout = tp.write_token_to_pages(tc, 1, _t(kb), _t(vb), _t(page_of), _t(offset))
    assert tout.k.data_ptr() == tc.k.data_ptr()  # in place
    assert not torch.equal(tc.k, k_before)
    names = ("k", "v") + (("k_scales", "v_scales") if kind == "int8" else ())
    for name in names:
        got = _np(getattr(tout, name))
        ref = np.asarray(getattr(jout, name).astype(jnp.float32)
                         if kind == "bfloat16" else getattr(jout, name))
        # the duplicates on page 0 may land in either order: compare the rest
        np.testing.assert_array_equal(got[:, :, 1:], ref[:, :, 1:])
        row = got[1, :, 0, 0]
        live = {"k": kb, "v": vb}.get(name)
        if live is not None and kind == "float32":
            assert any(np.array_equal(row, live[s]) for s in (1, 3))


@pytest.mark.parametrize("window,softcap,sinks", [
    (None, None, False), (5, None, False), (None, 30.0, False), (None, None, True),
    (7, 20.0, True),
])
@pytest.mark.parametrize("nh,h", [(4, 4), (4, 2), (6, 1)])
def test_paged_attention_ref_matches(nh, h, window, softcap, sinks):
    rng = np.random.default_rng(nh * 10 + h)
    b, hd, pg, mp, num_pages = 3, 32, 4, 6, 20
    q = rng.standard_normal((b, nh, hd)).astype(np.float32) * hd**-0.5
    k = rng.standard_normal((h, num_pages, pg, hd)).astype(np.float32)
    v = rng.standard_normal((h, num_pages, pg, hd)).astype(np.float32)
    lengths = np.array([1, 9, 24], np.int32)
    tab = rng.permutation(np.arange(1, num_pages))[: b * mp].reshape(b, mp).astype(np.int32)
    sk = rng.standard_normal(nh).astype(np.float32) if sinks else None
    ref = jp.paged_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(lengths), jnp.asarray(tab), window=window,
                                 softcap=softcap, sinks=None if sk is None else jnp.asarray(sk))
    got = tp.paged_attention_ref(_t(q), _t(k), _t(v), _t(lengths), _t(tab), window=window,
                                 softcap=softcap, sinks=None if sk is None else _t(sk))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4, rtol=0)
    if window is None and softcap is None and not sinks:
        # the kernel's wrapper takes its plain version on the CPU
        launches = tp.paged_attention.launches
        plain = tp.paged_attention(_t(q), _t(k), _t(v), _t(lengths), _t(tab))
        assert tp.paged_attention.launches == launches
        np.testing.assert_allclose(plain.numpy(), np.asarray(ref), atol=2e-4, rtol=0)


@pytest.mark.parametrize("window", [None, 6])
def test_paged_attn_int8_pages_matches(window):
    cfg = jl.LlamaConfig.tiny()
    jc, tc = _pool_pair(cfg, 12, 4, "int8", True, seed=3)
    rng = np.random.default_rng(4)
    nh, hd = cfg.num_attention_heads, cfg.head_dim_
    q = rng.standard_normal((2, nh, hd)).astype(np.float32) * 0.01
    lengths = np.array([7, 16], np.int32)
    tab = rng.permutation(np.arange(1, 12))[:8].reshape(2, 4).astype(np.int32)
    ref = jp.paged_attn(jnp.asarray(q), jc, 1, jnp.asarray(lengths), jnp.asarray(tab),
                        window=window)
    got = tp.paged_attn(_t(q), tc, 1, _t(lengths), _t(tab), window=window)
    assert got.dtype == torch.float32
    scale = np.abs(np.asarray(ref)).max()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4 * scale, rtol=0)
    with pytest.raises(NotImplementedError):
        tp.paged_attn(_t(q), tc, 1, _t(lengths), _t(tab), seq_axis="sp")


def test_sample_token_batch_matches():
    rng = np.random.default_rng(5)
    s, vocab = 6, 100
    logits = rng.standard_normal((s, vocab)).astype(np.float32) * 3
    do_sample = np.array([False, True, True, True, False, True])
    top_k = np.array([20, 1, 5, 200, 3, 40], np.int32)
    temperature = np.array([0.6, 1.0, 0.7, 1.5, 0.0, 0.9], np.float32)
    top_p = np.array([1.0, 1.0, 0.8, 0.95, 0.5, 0.3], np.float32)
    # greedy rows are the argmax whatever the noise
    greedy = tg.sample_token_batch(_t(logits), None, torch.zeros(s, dtype=torch.bool),
                                   _t(top_k), _t(temperature), _t(top_p))
    np.testing.assert_array_equal(greedy.numpy(), logits.argmax(-1))
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        ref = jg.sample_token_batch(jnp.asarray(logits), key, jnp.asarray(do_sample),
                                    jnp.asarray(top_k), jnp.asarray(temperature),
                                    jnp.asarray(top_p))
        noise = np.asarray(jax.random.gumbel(key, (s, min(jg.MAX_TOP_K, vocab)), jnp.float32))
        got = tg.sample_token_batch(_t(logits), None, _t(do_sample), _t(top_k), _t(temperature),
                                    _t(top_p), gumbel=_t(noise))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # without noise given, it is drawn from the generator: reproducible
    draws = [tg.sample_token_batch(_t(logits), torch.Generator().manual_seed(7), _t(do_sample),
                                   _t(top_k), _t(temperature), _t(top_p)) for _ in range(2)]
    assert torch.equal(draws[0], draws[1])
    assert tg.MAX_TOP_K == jg.MAX_TOP_K


# ---------------------------------------------------------------------------
# the model's paged branch and the engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def quantized():
    cfg = jl.LlamaConfig.tiny()
    params = jl.init_params(cfg, jax.random.PRNGKey(2), dtype=jnp.float32)
    qparams = j_quantize_model(params, JConfig(nbits=4, group_size=32),
                               compute_dtype=jnp.float32)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, qparams), "cpu")
    return cfg, qparams, tl.LlamaConfig.tiny(), tparams


@pytest.mark.parametrize("kind,t", [("float32", 1), ("float32", 3), ("int8", 1)])
def test_forward_paged_logits_match(quantized, kind, t):
    """One paged step (T = 1) and a verify window (T = 3) over pools with
    history, per-slot offsets and a dead slot: logits and pools."""
    jcfg, jparams, tcfg, tparams = quantized
    jc, tc = _pool_pair(jcfg, 16, 4, kind, kind == "int8", seed=6)
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, jcfg.vocab_size, (3, t)).astype(np.int32)
    lengths = np.array([5, 0, 17], np.int32)  # slot 1 is dead: scratch page 0
    tab = np.zeros((3, 6), np.int32)
    tab[0, :3] = [3, 9, 4]
    tab[2, :6] = [7, 1, 12, 15, 2, 8]
    jl_logits, jc2 = jl.forward(jparams, jcfg, jnp.asarray(tokens), jc, jnp.asarray(lengths),
                                page_indices=jnp.asarray(tab))
    with torch.no_grad():
        tl_logits, tc2 = tl.forward(tparams, tcfg, _t(tokens).long(), tc, _t(lengths),
                                    page_indices=_t(tab))
    assert tc2 is tc and tl_logits.dtype == torch.float32
    ref = np.asarray(jl_logits)
    live = [0, 2]
    tol = (1e-5 if kind == "float32" else 1e-4) * np.abs(ref).max()
    np.testing.assert_allclose(tl_logits.numpy()[live], ref[live], atol=tol, rtol=0)
    # the new rows landed where hqq_tpu put them (page 0 takes the dead slot's)
    if kind == "float32":
        np.testing.assert_allclose(tc.k.numpy()[:, :, 1:], np.asarray(jc2.k)[:, :, 1:],
                                   atol=1e-5, rtol=0)
    else:
        diff = np.abs(tc.k.numpy()[:, :, 1:].astype(np.int32)
                      - np.asarray(jc2.k)[:, :, 1:].astype(np.int32))
        assert diff.max() <= 1  # a rounding at a tie of x / scale * 127
    with pytest.raises(ValueError):
        tl.forward(tparams, tcfg, _t(tokens).long(), tc, _t(lengths))  # no page table
    with pytest.raises(NotImplementedError):
        tl.forward(tparams, tcfg, _t(tokens).long(), tc, _t(lengths), page_indices=_t(tab),
                   seq_axis="sp")


def _prompts(seed, lengths, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).astype(np.int32) for n in lengths]


_ENGINE_KW = dict(batch_slots=2, num_pages=40, page_size=8, max_pages_per_seq=8)
# (engine arguments, prompt lengths, shared prefix length)
_ENGINE_CASES = {
    "plain": (dict(), [5, 12, 20, 33, 9], 0),
    "horizon4": (dict(horizon=4), [5, 12, 20, 33, 9], 0),
    "quantize_kv": (dict(quantize_kv=True), [5, 12, 20, 33, 9], 0),
    "prefix_cache": (dict(enable_prefix_cache=True), [30, 27, 41, 19], 18),
    "prefill_chunk": (dict(prefill_chunk=8), [5, 30, 20, 41, 9], 0),
}


def _run_case(engine_cls, params, cfg, name, **extra):
    kw, lengths, shared = _ENGINE_CASES[name]
    prompts = _prompts(11, lengths)
    if shared:
        head = _prompts(12, [shared])[0]
        prompts = [np.concatenate([head, p[shared:]]) if len(p) > shared else p for p in prompts]
    eng = engine_cls(params, cfg, **_ENGINE_KW, **kw, **extra)
    uids = [eng.add_request(p, max_new_tokens=6 + i) for i, p in enumerate(prompts)]
    out = eng.run()
    stats = dict(hits=eng.prefix_cache_hits, free=len(eng.free_pages),
                 cached=0 if eng._prefix_cache is None else len(eng._prefix_cache))
    eng.close()
    return [out[u] for u in uids], stats


@pytest.fixture(scope="module")
def engine_ref(quantized):
    """hqq_tpu's engine, run once per case of the module."""
    jcfg, jparams, _, _ = quantized
    done = {}

    def run(name):
        if name not in done:
            done[name] = _run_case(JEngine, jparams, jcfg, name, cache_dtype=jnp.float32)
        return done[name]

    return run


@pytest.mark.parametrize("name", list(_ENGINE_CASES))
def test_engine_greedy_tokens_equal(quantized, engine_ref, name):
    _, _, tcfg, tparams = quantized
    ref, ref_stats = engine_ref(name)
    got, stats = _run_case(TEngine, tparams, tcfg, name, cache_dtype=torch.float32, device="cpu")
    assert [len(o) for o in got] == [6 + i for i in range(len(got))]
    assert got == ref
    assert stats == ref_stats
    if name == "prefix_cache":
        assert stats["hits"] > 0 and stats["cached"] > 0
    if name == "horizon4":
        # h steps with no read-back between them: the tokens of h single steps
        assert got == engine_ref("plain")[0]


def test_engine_stop_tokens_and_sampling_params(quantized, engine_ref):
    """EOS and per-request stop tokens end a request where hqq_tpu ends it;
    a per-request top_k = 1 is greedy whatever the engine samples."""
    jcfg, jparams, tcfg, tparams = quantized
    plain, _ = engine_ref("plain")
    eos, stop = plain[1][2], plain[2][3]
    prompts = _prompts(11, _ENGINE_CASES["plain"][1])[:3]

    def run(engine_cls, params, cfg, **kw):
        eng = engine_cls(params, cfg, **_ENGINE_KW, eos_token_id=int(eos), do_sample=True, **kw)
        uids = [eng.add_request(p, max_new_tokens=8, top_k=1,
                                stop_token_ids=[int(stop)] if i == 2 else None)
                for i, p in enumerate(prompts)]
        out = eng.run()
        eng.close()
        return [out[u] for u in uids]

    ref = run(JEngine, jparams, jcfg, cache_dtype=jnp.float32)
    got = run(TEngine, tparams, tcfg, cache_dtype=torch.float32, device="cpu")
    assert got == ref
    assert got[1][-1] == eos and len(got[1]) <= 3
    assert got[2][-1] in (eos, stop) and len(got[2]) <= 4


def test_engine_cancel_matches(quantized):
    """Cancel a running and a queued request mid-run: the same outputs, the
    same pages given back."""
    jcfg, jparams, tcfg, tparams = quantized
    prompts = _prompts(13, [9, 14, 22, 6])

    def run(engine_cls, params, cfg, **kw):
        eng = engine_cls(params, cfg, **_ENGINE_KW, **kw)
        uids = [eng.add_request(p, max_new_tokens=10) for p in prompts]
        eng.step()
        eng.step()
        free_before = len(eng.free_pages)
        found = [eng.cancel(uids[0]), eng.cancel(uids[3]), eng.cancel(999)]
        free_after = len(eng.free_pages)
        out = eng.run()
        free_end = len(eng.free_pages)
        eng.close()
        return [out[u] for u in uids], found, free_after - free_before, free_end

    ref = run(JEngine, jparams, jcfg, cache_dtype=jnp.float32)
    got = run(TEngine, tparams, tcfg, cache_dtype=torch.float32, device="cpu")
    assert got == ref
    outs, found, given_back, free_end = got
    assert found == [True, True, False] and given_back > 0
    assert len(outs[0]) == 3 and outs[3] == [] and len(outs[1]) == len(outs[2]) == 10
    assert free_end == _ENGINE_KW["num_pages"] - 1  # all but the scratch page


def test_engine_refuses_what_is_not_ported(quantized):
    _, _, tcfg, tparams = quantized
    eng = TEngine(tparams, tcfg, **_ENGINE_KW, cache_dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="inputs_embeds"):  # [len(prompt), D] or refused
        eng.add_request([1, 2, 3], inputs_embeds=np.zeros((3, tcfg.hidden_size + 1), np.float32))
    with pytest.raises(ValueError, match="adapter_id"):  # no multi-LoRA stack: adapter 0 only
        eng.add_request([1, 2, 3], adapter_id=1)
    with pytest.raises(ValueError, match="pages"):
        eng.add_request(list(range(1, 60)), max_new_tokens=32)  # hqq_tpu's page budget rule
    with pytest.raises(ValueError):
        TEngine(tparams, tcfg, max_pages_per_seq=6, device="cpu")
    eng.close()
    eng.close()  # idempotent
    assert eng.cache is None and eng.params is None
