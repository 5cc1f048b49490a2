# SPDX-License-Identifier: Apache-2.0
"""hqq_tpu_torch's speculative decoding against hqq_tpu's, on the CPU.

LlamaConfig.tiny(vocab_size=128) in fp32, hqq_tpu's random weights (the
embedding scaled by 100, so that greedy decoding does not settle on one
token) carried across with params_from_numpy; quantized trees are
hqq_tpu's, so the port's quantizer does not run here. The recipes are
hqq_tpu's tests/test_speculative.py: a 4-bit g32 target with a 2-bit
draft for the generator, the fp32 model with a 3-bit draft for the
engines, 8 new tokens.

* `SpeculativeGenerator`: greedy ids equal to hqq_tpu's and to the port's
  `Generator`, with the target as a perfect draft and the 2-bit tree as a
  weak one, k = 2 and 4, and with EOS; a sampled run gives ids in the
  vocabulary.
* The engines: ids equal to hqq_tpu's speculative engines and to the
  port's plain engines, near page exhaustion too (the plain-step fallback
  runs); a dense slot whose verify window crosses the end of the cache
  (a torch indexed write raised there before the rows past the end were
  dropped); a paged window past a slot's last page writes scratch page 0.
* `_spec_accept` on fixed draws against a numpy restatement of hqq_tpu's
  scan (hqq_tpu/serving/speculative.py:39-74), and its distribution: over
  20,000 trials at V = 8 and k = 3 the first emitted token's frequencies
  lie within 5 standard errors of the target's softmax at every token
  (a false alarm about once in 10^5 runs; the inputs are seeded, so a run
  is the same every time), where accepting every proposal misses.
"""

import dataclasses

import numpy as np
import pytest
import torch

from hqq_tpu_torch.models import llama as tl
from hqq_tpu_torch.serving.batching import ContinuousBatchingEngine
from hqq_tpu_torch.serving.generate import Generator
from hqq_tpu_torch.serving.paged import PagedBatchingEngine
from hqq_tpu_torch.serving.speculative import (
    SpeculativeBatchingEngine,
    SpeculativeGenerator,
    SpeculativePagedEngine,
    _spec_accept,
)
from hqq_tpu_torch.utils import params_from_numpy

_PROMPT = [3, 17, 92, 41, 5]
_PROMPTS = [[3, 17, 29, 5], [11, 2], [7, 23, 23, 41, 9]]  # the engines' recipe
_NEW = 8
_PAGED = dict(batch_slots=2, num_pages=32, page_size=4, max_pages_per_seq=8)
_EXHAUST = dict(batch_slots=1, num_pages=16, page_size=4, max_pages_per_seq=4)
_EXHAUST_PROMPT = [5, 9, 3, 7, 2]  # 5 + 7 new = 12 rows, the last of its 3 pages


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch ops on one thread: the suite's workers share the cores, and
    torch's intra-op threads would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    """The trees in both packages and hqq_tpu's runs of the recipes."""
    import jax
    import jax.numpy as jnp

    from hqq_tpu.core.quantize import BaseQuantizeConfig
    from hqq_tpu.models import llama as jl
    from hqq_tpu.models import quantize_model
    from hqq_tpu.serving import speculative as js

    cfg = jl.LlamaConfig.tiny(vocab_size=128)
    params = jl.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    params = dict(params, embed_tokens=params["embed_tokens"] * 100.0)

    def quant(nbits):
        return quantize_model(params, BaseQuantizeConfig(nbits=nbits, group_size=32),
                              compute_dtype=jnp.float32)

    jtrees = {"fp32": params, "q4": quant(4), "q3": quant(3), "q2": quant(2)}
    gen = np.asarray(js.SpeculativeGenerator(jtrees["q4"], jtrees["q2"], cfg, k=2,
                                             cache_dtype=jnp.float32)
                     .generate(np.asarray(_PROMPT, np.int32), max_new_tokens=_NEW))
    dense = js.SpeculativeBatchingEngine(params, jtrees["q3"], cfg, k_draft=4, batch_slots=2,
                                         max_len=64, cache_dtype=jnp.float32)
    uids = [dense.add_request(p, max_new_tokens=_NEW) for p in _PROMPTS]
    dense_out = dense.run()
    paged = js.SpeculativePagedEngine(params, jtrees["q3"], cfg, k_draft=4,
                                      cache_dtype=jnp.float32, **_PAGED)
    pids = [paged.add_request(p, max_new_tokens=_NEW) for p in _PROMPTS]
    paged_out = paged.run()
    exhaust = js.SpeculativePagedEngine(params, params, cfg, k_draft=4, cache_dtype=jnp.float32,
                                        **_EXHAUST)
    eid = exhaust.add_request(_EXHAUST_PROMPT, max_new_tokens=7)
    trees = {name: params_from_numpy(jax.tree_util.tree_map(np.asarray, t), "cpu")
             for name, t in jtrees.items()}
    return dict(cfg=tl.LlamaConfig.tiny(vocab_size=128), trees=trees, generator=gen,
                dense=[dense_out[u] for u in uids], paged=[paged_out[u] for u in pids],
                exhaust=exhaust.run()[eid])


def _plain_generate(ref, eos=None):
    gen = Generator(ref["trees"]["q4"], ref["cfg"], cache_dtype=torch.float32,
                    compile_mode="partial", eos_token_id=eos, device="cpu")
    return gen.generate([_PROMPT], max_new_tokens=_NEW)


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("draft", ["q4", "q2"])  # the target itself, a 2-bit draft
def test_generator_greedy_ids(ref, draft, k):
    spec = SpeculativeGenerator(ref["trees"]["q4"], ref["trees"][draft], ref["cfg"], k=k,
                                cache_dtype=torch.float32, device="cpu")
    out = spec.generate(_PROMPT, max_new_tokens=_NEW)
    assert out.shape == (1, _NEW)
    np.testing.assert_array_equal(out, ref["generator"])
    np.testing.assert_array_equal(out, _plain_generate(ref))
    assert len(set(out[0].tolist())) > 2  # ids that a wrong accept would change


def test_generator_eos(ref):
    ids = ref["generator"][0].tolist()
    # an EOS first emitted mid-stream (neither package checks the prefill's token)
    first = next(j for j in range(3, _NEW) if ids[j] not in ids[:j])
    eos = ids[first]
    spec = SpeculativeGenerator(ref["trees"]["q4"], ref["trees"]["q4"], ref["cfg"], k=4,
                                eos_token_id=eos, cache_dtype=torch.float32, device="cpu")
    out = spec.generate(_PROMPT, max_new_tokens=_NEW)
    np.testing.assert_array_equal(out, ref["generator"][:, :first + 1])
    np.testing.assert_array_equal(out, _plain_generate(ref, eos))


def test_generator_sampling_runs(ref):
    kw = dict(k=3, cache_dtype=torch.float32, do_sample=True, temperature=0.8, device="cpu")
    trees = (ref["trees"]["q4"], ref["trees"]["q2"], ref["cfg"])
    outs = [SpeculativeGenerator(*trees, seed=seed, **kw).generate(_PROMPT, max_new_tokens=_NEW)
            for seed in (3, 3, 4)]
    assert outs[0].shape == (1, _NEW)
    assert (outs[0] >= 0).all() and (outs[0] < ref["cfg"].vocab_size).all()
    np.testing.assert_array_equal(outs[0], outs[1])  # one seed, one draw
    assert not np.array_equal(outs[0], outs[2])


def _run(engine, prompts, new):
    uids = [engine.add_request(p, max_new_tokens=new) for p in prompts]
    out = engine.run()
    return [out[u] for u in uids]


def test_dense_engine_ids(ref):
    kw = dict(batch_slots=2, max_len=64, cache_dtype=torch.float32, device="cpu")
    trees, cfg = ref["trees"], ref["cfg"]
    got = _run(SpeculativeBatchingEngine(trees["fp32"], trees["q3"], cfg, k_draft=4, **kw),
               _PROMPTS, _NEW)
    assert got == ref["dense"]
    assert got == _run(ContinuousBatchingEngine(trees["fp32"], cfg, **kw), _PROMPTS, _NEW)


def test_paged_engine_ids(ref):
    kw = dict(cache_dtype=torch.float32, device="cpu", **_PAGED)
    trees, cfg = ref["trees"], ref["cfg"]
    got = _run(SpeculativePagedEngine(trees["fp32"], trees["q3"], cfg, k_draft=4, **kw),
               _PROMPTS, _NEW)
    assert got == ref["paged"]
    assert got == _run(PagedBatchingEngine(trees["fp32"], cfg, **kw), _PROMPTS, _NEW)


def test_paged_engine_near_page_exhaustion(ref):
    kw = dict(cache_dtype=torch.float32, device="cpu", **_EXHAUST)
    trees, cfg = ref["trees"], ref["cfg"]
    eng = SpeculativePagedEngine(trees["fp32"], trees["fp32"], cfg, k_draft=4, **kw)
    got = _run(eng, [_EXHAUST_PROMPT], 7)[0]
    assert eng.fallback_steps > 0  # the window did not fit the last page
    assert got == ref["exhaust"]
    assert got == _run(PagedBatchingEngine(trees["fp32"], cfg, **kw), [_EXHAUST_PROMPT], 7)[0]


def test_dense_window_across_the_cache_end(ref):
    """Prompts of 8 and 5 tokens, 8 and 4 new, max_len 16, a 2-bit draft:
    windows of k = 4 rows that start at positions 13-15 write past row 15,
    the first slot's once it has ended there too, while the second runs."""
    kw = dict(batch_slots=2, max_len=16, cache_dtype=torch.float32, device="cpu")
    trees, cfg = ref["trees"], ref["cfg"]
    prompts = [list(range(1, 9)), list(range(20, 25))]
    eng = SpeculativeBatchingEngine(trees["fp32"], trees["q2"], cfg, k_draft=4, **kw)
    inner, last_rows = eng._eng._fwd, []

    def fwd(params, toks, cache, pos):
        if isinstance(pos, torch.Tensor):  # a verify window, not a prefill
            last_rows.append(int(pos.max()) + toks.shape[1] - 1)
        return inner(params, toks, cache, pos)

    eng._eng._fwd = fwd
    uids = [eng.add_request(p, max_new_tokens=n) for p, n in zip(prompts, (8, 4))]
    out = eng.run()
    got = [out[u] for u in uids]
    assert max(last_rows) > 15  # a verify window ran past the cache
    plain = ContinuousBatchingEngine(trees["fp32"], cfg, **kw)
    uids = [plain.add_request(p, max_new_tokens=n) for p, n in zip(prompts, (8, 4))]
    out = plain.run()
    assert got == [out[u] for u in uids]
    assert [len(o) for o in got] == [8, 4]


def test_per_slot_write_drops_rows_past_the_end():
    """The dense per-slot write keeps what fits and drops the rest, as
    hqq_tpu's scatter: slot 0 writes rows 6-7 of its window of 4 from row 6
    of 8, slot 1 from row 9 writes nothing, slot 2 all 4 from row 1."""
    torch.manual_seed(0)
    k_all, v_all = torch.randn(2, 2, 3, 2, 8, 4).unbind(0)  # [L, B, n_kv, S, hd]
    k_new, v_new = torch.randn(2, 3, 2, 4, 4).unbind(0)  # [B, n_kv, t, hd]
    want_k, want_v = k_all.clone(), v_all.clone()
    for b, start in enumerate([6, 9, 1]):
        for j in range(4):
            if start + j < 8:
                want_k[1, b, :, start + j] = k_new[b, :, j]
                want_v[1, b, :, start + j] = v_new[b, :, j]
    tl._update_stacked_cache(k_all, v_all, 1, k_new, v_new, torch.tensor([6, 9, 1]))
    assert torch.equal(k_all, want_k) and torch.equal(v_all, want_v)


def test_paged_window_past_the_last_page_writes_scratch_page(ref):
    """A window of 4 rows from position 6 of a slot with 2 pages of 4: rows
    6-7 land in its second page, rows 8-9 in page 0 (the block table's
    filler), no other page changes."""
    from hqq_tpu_torch.ops.paged import init_paged_cache

    cfg, params = ref["cfg"], ref["trees"]["fp32"]
    cache = init_paged_cache(cfg, 8, 4, torch.float32, device="cpu")
    cache.k.normal_(generator=torch.Generator().manual_seed(1))
    before = cache.k.clone()
    tab = torch.tensor([[3, 5, 0, 0], [1, 2, 0, 0]])
    toks = torch.tensor([[4, 8, 15, 16], [23, 42, 7, 9]])
    with torch.inference_mode():
        tl.forward(params, cfg, toks, cache, torch.tensor([6, 0]), page_indices=tab)
    changed = (cache.k != before).any(dim=-1).any(dim=1).any(dim=0)  # [pages, rows]
    assert changed[5, 2:].all() and not changed[5, :2].any()  # slot 0: rows 6-7
    assert changed[0, :2].all() and not changed[0, 2:].any()  # rows 8-9: scratch
    assert changed[1].all() and not changed[2].any()  # slot 1: rows 0-3
    assert not changed[[3, 4, 6, 7]].any()


def _np_categorical(p, u):
    cdf = np.cumsum(p)
    return min(int(np.searchsorted(cdf, u * cdf[-1], side="right")), len(p) - 1)


def _np_accept(tl_, dl_, props, draws, temperature):
    """hqq_tpu's `_spec_accept` scan in numpy, its categorical draws taken
    by the inverse CDF at the given uniforms."""
    def softmax(x):
        e = np.exp(x / temperature - (x / temperature).max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)

    k = len(props)
    pt, pd = softmax(tl_), softmax(dl_)
    done, n_acc, nxt = False, 0, 0
    for i in range(k):
        d = props[i]
        accept = (not done) and draws[i] < pt[i, d] / max(pd[i, d], 1e-20)
        resid = np.maximum(pt[i] - pd[i], 0.0)
        resid = resid / max(resid.sum(), 1e-20)
        rej = _np_categorical(resid, draws[k + i])
        if not done and not accept:
            nxt = rej
        n_acc += int(accept)
        done = done or not accept
    return n_acc, nxt if done else _np_categorical(pt[k], draws[2 * k])


@pytest.mark.parametrize("k", [1, 3, 4])
def test_spec_accept_matches_the_scan(k):
    rng = np.random.default_rng(k)
    vocab, seen = 16, set()
    for case in range(64):
        tl_ = (rng.standard_normal((k + 1, vocab)) * 2).astype(np.float32)
        dl_ = tl_[:k] + (rng.standard_normal((k, vocab)) * (case % 4) * 0.5).astype(np.float32)
        props = rng.integers(0, vocab, k)
        draws = rng.random(2 * k + 1).astype(np.float32)
        want = _np_accept(tl_.astype(np.float64), dl_.astype(np.float64), props, draws, 0.8)
        n_acc, nxt = _spec_accept(torch.from_numpy(tl_), torch.from_numpy(dl_),
                                  torch.from_numpy(props), torch.from_numpy(draws), 0.8)
        assert (int(n_acc), int(nxt)) == want, case
        seen.add(want[0])
    assert seen == set(range(k + 1))  # every accept count came up


def test_spec_accept_distribution():
    vocab, k, n = 8, 3, 20000
    g = torch.Generator().manual_seed(0)
    tlog = torch.randn(k + 1, vocab, generator=g) * 1.5
    dlog = torch.randn(k, vocab, generator=g) * 1.5
    pt = torch.softmax(tlog, -1).double()
    props = torch.multinomial(torch.softmax(dlog, -1), n, replacement=True, generator=g).T
    draws = torch.rand(n, 2 * k + 1, generator=g)
    n_acc, nxt = _spec_accept(tlog.expand(n, -1, -1), dlog.expand(n, -1, -1), props, draws, 1.0)
    first = torch.where(n_acc >= 1, props[:, 0], nxt)
    stderr = (pt[0] * (1 - pt[0]) / n).sqrt()

    def worst_z(tokens):
        freq = torch.bincount(tokens, minlength=vocab).double() / n
        return ((freq - pt[0]).abs() / stderr).max().item()

    assert worst_z(first) < 5.0
    assert worst_z(props[:, 0]) > 5.0  # the control: every proposal accepted
    assert 0 < (n_acc == 0).sum() < n  # both branches taken


def test_layer_skip_draft(ref):
    """A draft of the target's first layer, its own config: ids still equal
    to the plain decode's."""
    trees, cfg = ref["trees"], ref["cfg"]
    target = trees["q4"]
    draft = dict(target, layers=target["layers"][:1])
    spec = SpeculativeGenerator(target, draft, cfg, k=4,
                                draft_cfg=dataclasses.replace(cfg, num_hidden_layers=1),
                                cache_dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(spec.generate(_PROMPT, max_new_tokens=_NEW),
                                  _plain_generate(ref))


def test_kept_round_graphs_follow_the_trees(ref, monkeypatch):
    """With the capture a stub whose replay is the eager round: a graph per
    cache length is captured once and replayed, and a change to either
    tree drops the kept graphs, so the next call captures anew."""
    import types

    from hqq_tpu_torch.serving import speculative

    captured = []

    def capture(device, step):
        captured.append(step)
        return types.SimpleNamespace(replay=step), {"seconds": 0.0, "launches": {}}

    monkeypatch.setattr(speculative, "capture_graph", capture)
    monkeypatch.setattr(SpeculativeGenerator, "_graphed", lambda self, new: new > 1)
    trees, cfg = ref["trees"], ref["cfg"]
    spec = SpeculativeGenerator(trees["q4"], trees["q2"], cfg, k=2, cache_dtype=torch.float32,
                                device="cpu")
    for _ in range(2):
        np.testing.assert_array_equal(spec.generate(_PROMPT, max_new_tokens=_NEW),
                                      ref["generator"])
    assert list(spec.captures()) == [32] and len(captured) == 1
    spec.generate(_PROMPT, max_new_tokens=40)  # cache length 32 -> 64: a second graph
    assert list(spec.captures()) == [32, 64] and len(captured) == 2
    spec.pd = trees["q4"]  # another draft: every kept graph goes
    np.testing.assert_array_equal(spec.generate(_PROMPT, max_new_tokens=_NEW), ref["generator"])
    assert list(spec.captures()) == [32] and len(captured) == 3
    spec.release_graphs()
    assert spec.captures() == {}


def test_arguments_checked(ref):
    trees, cfg = ref["trees"], ref["cfg"]
    with pytest.raises(ValueError, match="compile_mode"):
        SpeculativeGenerator(trees["fp32"], trees["fp32"], cfg, compile_mode="scan",
                             device="cpu")
    with pytest.raises(ValueError, match="k_draft"):
        SpeculativeBatchingEngine(trees["fp32"], trees["fp32"], cfg, k_draft=1, batch_slots=1,
                                  max_len=16, device="cpu")


# ---------------------------------------------------------------------------
# On the card (marked ``cuda``; they skip where torch sees no CUDA device;
# JAX is imported only inside the CPU fixture, so on the GPU:
# ``python -m pytest --noconftest -m cuda tests/test_torch_speculative.py``)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_tree():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from hqq_tpu_torch import BaseQuantizeConfig
    from hqq_tpu_torch.models.base import quantize_model
    from hqq_tpu_torch.utils.patching import prepare_for_inference

    cfg = tl.LlamaConfig.tiny(vocab_size=128)
    params = tl.init_params(cfg, torch.Generator("cuda").manual_seed(0), torch.bfloat16, "cuda")
    params["embed_tokens"] = params["embed_tokens"] * 100.0
    quantize_model(params, BaseQuantizeConfig(nbits=4, group_size=64))
    return prepare_for_inference(params, "w4a8"), cfg


@pytest.mark.cuda
@pytest.mark.parametrize("do_sample", [False, True])
def test_round_graph_equals_eager_rounds(cuda_tree, do_sample):
    from hqq_tpu_torch import ops

    params, cfg = cuda_tree
    draft = dict(params, layers=params["layers"][:1])
    kw = dict(k=4, draft_cfg=dataclasses.replace(cfg, num_hidden_layers=1), do_sample=do_sample,
              seed=2)
    full = SpeculativeGenerator(params, draft, cfg, **kw)
    ids = full.generate(_PROMPT, max_new_tokens=24)
    again = full.generate(_PROMPT, max_new_tokens=24)  # a replay of the kept graph
    partial = SpeculativeGenerator(params, draft, cfg, compile_mode="partial", **kw)
    eager = partial.generate(_PROMPT, max_new_tokens=24)
    np.testing.assert_array_equal(ids, eager)
    if not do_sample:  # greedy: the same ids at every call
        np.testing.assert_array_equal(again, eager)
    (cache_len, cap), = full.captures().items()
    st = partial._new_state(cache_len)
    ops.reset_launch_counts()
    with torch.inference_mode():
        partial._round(st)
    eager_launches = {w.__name__: w.launches for w in ops.kernel_wrappers() if w.launches}
    # 5 draft steps of 7 linears (M = 1) and the target's window (M = 5)
    assert cap["launches"] == eager_launches == {"w4a8_matmul": 5 * 7 + 2 * 7}


@pytest.mark.cuda
def test_engines_on_the_card_equal_plain_engines(cuda_tree):
    params, cfg = cuda_tree
    draft = dict(params, layers=params["layers"][:1])
    dcfg = dataclasses.replace(cfg, num_hidden_layers=1)
    paged = dict(batch_slots=2, num_pages=32, page_size=4, max_pages_per_seq=8)
    got = _run(SpeculativePagedEngine(params, draft, cfg, draft_cfg=dcfg, **paged), _PROMPTS, _NEW)
    assert got == _run(PagedBatchingEngine(params, cfg, **paged), _PROMPTS, _NEW)
    dense = dict(batch_slots=2, max_len=16)
    prompts = [list(range(1, 9)), list(range(20, 25))]
    got = _run(SpeculativeBatchingEngine(params, draft, cfg, draft_cfg=dcfg, **dense), prompts, 8)
    assert got == _run(ContinuousBatchingEngine(params, cfg, **dense), prompts, 8)
