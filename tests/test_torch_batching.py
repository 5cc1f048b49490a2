# SPDX-License-Identifier: Apache-2.0
"""hqq_tpu_torch's dense continuous-batching engine and the dense cache's
per-slot positions and int8 pools against hqq_tpu's.

LlamaConfig.tiny() in fp32, hqq_tpu's random weights carried across with
params_from_numpy, unquantized: the engine's logic is under test, and the
quantized layers' numbers have their own tests (a CPU test of quantized
layers here would spend its time dequantizing, many times over when the
suite's workers share the cores). The engines'
greedy tokens are equal, case by case (plain, a horizon of 4, int8 pools,
EOS and stop tokens, cancel, a request that ends on the cache's last row
while another decodes on in a horizon). One forward at per-slot offsets:
logits 1e-5 of max|logit| over float pools, 1e-4 over int8 pools (a K/V
row near a rounding tie may land one code apart), the rows written where
hqq_tpu writes them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hqq_tpu.models import llama as jl
from hqq_tpu.serving.batching import ContinuousBatchingEngine as JEngine
from hqq_tpu_torch.models import llama as tl
from hqq_tpu_torch.serving.batching import ContinuousBatchingEngine as TEngine
from hqq_tpu_torch.utils import params_from_numpy

_KW = dict(batch_slots=2, max_len=64)
# (engine arguments, prompt lengths): one prefill bucket (16), so that
# hqq_tpu's engine compiles one prefill
_LENGTHS = [9, 12, 16, 11]
_CASES = {
    "plain": (dict(), _LENGTHS),
    "horizon4": (dict(horizon=4), _LENGTHS),
    "quantize_kv": (dict(quantize_kv=True, horizon=4), _LENGTHS),
}


@pytest.fixture(scope="module")
def model():
    cfg = jl.LlamaConfig.tiny()
    params = jl.init_params(cfg, jax.random.PRNGKey(2), dtype=jnp.float32)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    return cfg, params, tl.LlamaConfig.tiny(), tparams


def _prompts(seed, lengths, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).astype(np.int32) for n in lengths]


def _engine(which, model, **kw):
    jcfg, jparams, tcfg, tparams = model
    if which == "jax":
        return JEngine(jparams, jcfg, cache_dtype=jnp.float32, **kw)
    return TEngine(tparams, tcfg, cache_dtype=torch.float32, device="cpu", **kw)


def _run(which, model, prompts, new, engine_kw, requests=None):
    eng = _engine(which, model, **engine_kw)
    uids = [eng.add_request(p, max_new_tokens=new[i], **(requests or [{}] * len(prompts))[i])
            for i, p in enumerate(prompts)]
    out = eng.run()
    eng.close()
    return [out[u] for u in uids]


@pytest.fixture(scope="module")
def engine_ref(model):
    """hqq_tpu's engine, run once per case of the module."""
    done = {}

    def run(name):
        if name not in done:
            kw, lengths = _CASES[name]
            done[name] = _run("jax", model, _prompts(11, lengths),
                              [6 + i for i in range(len(lengths))], dict(_KW, **kw))
        return done[name]

    return run


@pytest.mark.parametrize("name", list(_CASES))
def test_engine_greedy_tokens_equal(model, engine_ref, name):
    kw, lengths = _CASES[name]
    got = _run("torch", model, _prompts(11, lengths), [6 + i for i in range(len(lengths))],
               dict(_KW, **kw))
    assert [len(o) for o in got] == [6 + i for i in range(len(got))]
    # a horizon reads nothing back between its steps: the tokens of single
    # steps, which are hqq_tpu's (its horizon gives them too)
    assert got == engine_ref("plain" if name == "horizon4" else name)


def test_stop_tokens_and_sampling_params(model, engine_ref):
    """EOS and per-request stop tokens end a request where hqq_tpu ends it;
    a per-request top_k = 1 is greedy whatever the engine samples."""
    plain = engine_ref("plain")
    eos, stop = plain[1][2], plain[2][3]
    prompts = _prompts(11, _LENGTHS)[:3]
    kw = dict(_KW, eos_token_id=int(eos), do_sample=True)
    requests = [dict(top_k=1, stop_token_ids=[int(stop)] if i == 2 else None) for i in range(3)]
    ref = _run("jax", model, prompts, [8] * 3, kw, requests)
    got = _run("torch", model, prompts, [8] * 3, kw, requests)
    assert got == ref
    assert got[1][-1] == eos and len(got[1]) <= 3
    assert got[2][-1] in (eos, stop) and len(got[2]) <= 4


def test_cancel_matches(model):
    """Cancel a running and a queued request mid-run: the same outputs."""
    prompts = _prompts(13, [9, 14, 16, 10])

    def run(which):
        eng = _engine(which, model, **_KW)
        uids = [eng.add_request(p, max_new_tokens=10) for p in prompts]
        eng.step()
        eng.step()
        found = (eng.cancel(uids[0]), eng.cancel(uids[3]), eng.cancel(uids[0]), eng.cancel(99))
        out = eng.run()
        eng.close()
        return found, [out[u] for u in uids]

    (found, got), (_, ref) = run("torch"), run("jax")
    assert found == (True, True, False, False)
    assert got == ref
    assert len(got[0]) == 3 and got[3] == [] and len(got[1]) == 10


def test_request_ending_on_the_last_row(model):
    """A request ends at max_len - 1 while another decodes on in a horizon
    of 4: the dead slot's position stops at the last row (hqq_tpu drops
    its writes past the cache; torch's indexed write would raise), and the
    live slot's tokens are hqq_tpu's."""
    prompts = _prompts(17, [16, 3])
    kw = dict(batch_slots=2, max_len=32, horizon=4)
    ref = _run("jax", model, prompts, [16, 28], kw)
    eng = _engine("torch", model, **kw)
    uids = [eng.add_request(p, max_new_tokens=n) for p, n in zip(prompts, [16, 28])]
    while 0 in eng._live.nonzero()[0] or not eng.active:
        eng.step()  # until slot 0's request has ended
    assert eng._pos[0] == kw["max_len"] - 1 and eng.active
    out = eng.run()
    eng.close()
    assert [out[u] for u in uids] == ref
    assert [len(o) for o in ref] == [16, 28]


@pytest.mark.parametrize("int8", [False, True])
def test_per_slot_start_pos_forward_matches(model, int8):
    """Two decode tokens at per-slot offsets [B] over a cache with history:
    hqq_tpu's scatter and the port's indexed write, the int8 pools'
    scale-after-dot too."""
    jcfg, jparams, tcfg, tparams = model
    rng = np.random.default_rng(4)
    b, s = 3, 24
    jc = jl.init_cache(jcfg, b, s, jnp.float32, quantize_kv=int8)
    shape = jc.k.shape
    if int8:
        fill = dict(k=rng.integers(-127, 128, shape).astype(np.int8),
                    v=rng.integers(-127, 128, shape).astype(np.int8),
                    k_scales=rng.uniform(0.5, 2.0, jc.k_scales.shape).astype(np.float32),
                    v_scales=rng.uniform(0.5, 2.0, jc.v_scales.shape).astype(np.float32))
    else:
        fill = dict(k=rng.standard_normal(shape).astype(np.float32),
                    v=rng.standard_normal(shape).astype(np.float32))
    jc = jl.KVCache(**{n: jnp.asarray(a) for n, a in fill.items()})
    tc = tl.KVCache(**{n: torch.from_numpy(a.copy()) for n, a in fill.items()})
    assert tc.quantized == int8
    tokens = rng.integers(0, jcfg.vocab_size, (b, 2)).astype(np.int32)
    start = np.array([5, 0, 17], np.int32)
    jlog, jc2 = jax.jit(jl.forward, static_argnums=(1,))(jparams, jcfg, jnp.asarray(tokens), jc,
                                                         jnp.asarray(start))
    with torch.no_grad():
        tlog, tc2 = tl.forward(tparams, tcfg, torch.from_numpy(tokens).long(), tc,
                               torch.from_numpy(start).long())
    assert tc2 is tc
    ref = np.asarray(jlog)
    np.testing.assert_allclose(tlog.numpy(), ref, atol=(1e-4 if int8 else 1e-5)
                               * np.abs(ref).max(), rtol=0)
    for name in fill:
        got, want = getattr(tc, name).numpy(), np.asarray(getattr(jc2, name))
        if name in ("k", "v") and int8:
            assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
        else:
            np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)
    # the rows written: each slot's two, at its own offset
    changed = (tc.k.numpy() != fill["k"]).any(axis=(0, 2, 4))  # [B, S]
    assert [list(np.nonzero(r)[0]) for r in changed] == [[5, 6], [0, 1], [17, 18]]


def test_engine_refuses_what_is_not_ported(model):
    """What the engine cannot serve is refused at add_request, before any
    step: embeddings of the wrong shape, M-RoPE arguments on an engine
    without ``mrope_offsets``, and so on. (Embeds requests and M-RoPE
    engines themselves are served: tests/test_torch_vl_serving.py.)"""
    eng = _engine("torch", model, **_KW)
    with pytest.raises(ValueError, match="inputs_embeds"):
        eng.add_request([1, 2, 3], inputs_embeds=np.zeros((2, 256), np.float32))
    with pytest.raises(ValueError, match="adapter_id"):  # no multi-LoRA stack: adapter 0 only
        eng.add_request([1, 2, 3], adapter_id=1)
    with pytest.raises(ValueError, match="M-RoPE"):
        eng.add_request([1, 2, 3], pos_offset=2)
    with pytest.raises(ValueError, match="max_len"):
        eng.add_request(list(range(1, 40)), max_new_tokens=8)  # t_pad 64 + 8 > 64
    mrope = _engine("torch", model, mrope_offsets=True, **_KW)
    with pytest.raises(ValueError, match="position_ids"):
        mrope.add_request([1, 2, 3], inputs_embeds=np.zeros((3, 256), np.float32))
    custom = _engine("torch", model, forward_fn=lambda p, t, c, s: None, **_KW)
    with pytest.raises(ValueError, match="embeds_forward_fn"):
        custom.add_request([1, 2, 3], inputs_embeds=np.zeros((3, 256), np.float32))
    assert not mrope.queue and not custom.queue
    # what would fail inside a step is refused before it: ids outside the
    # vocabulary, a sampled request's top_k outside [1, vocab]
    for bad in ([1, 256], [-1, 2], [1.0, 2.0]):
        with pytest.raises(ValueError, match="prompt ids"):
            eng.add_request(bad)
    with pytest.raises(ValueError, match="top_k"):
        eng.add_request([1, 2], do_sample=True, top_k=0)
    assert not eng.queue
    eng.add_request([1, 2], max_new_tokens=4, top_k=0)  # greedy: top_k is not read
    eng.close()
    eng.close()  # idempotent
    assert eng.cache is None and eng.params is None
