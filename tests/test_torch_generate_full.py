# SPDX-License-Identifier: Apache-2.0
"""Generator's whole-loop decode (compile_mode="full") and on_token
streaming, against hqq_tpu on the CPU, and as a replayed CUDA graph on the
card.

CPU: a 0-d tensor ``start_pos`` gives the logits of an int one bit for bit
(dense cache, bf16 and fp32, a sliding window too); "full" gives hqq_tpu's
"full" greedy ids (4-bit g64, fp32 compute and cache, weights carried
across), for batch 2 and for batch 1 with EOS; on_token fires with
hqq_tpu's sequence; sampled ids are equal in "full" and "partial" for one
seed. The keeping of graphs runs here too, with the capture replaced by a
stub that replays the eager step: kept buffers are reused, bounded and
dropped, only graphed calls keep any, and a change to the parameter tree
makes the next call capture anew.

Card (marked ``cuda``; they skip where torch sees no CUDA device, and this
module imports JAX only inside the CPU tests' fixture, so on the GPU:
``python -m pytest --noconftest -m cuda tests/test_torch_generate_full.py``):
the graph's ids and K/V cache equal the eager loop's, greedy and sampled;
the launches recorded into the graph equal "partial"'s per decode step; a
step that reads a tensor on the host makes the capture raise; after an
adapter is added or merged the ids equal a fresh model's.
"""

import dataclasses
import types
from unittest import mock

import numpy as np
import pytest
import torch

from hqq_tpu_torch import BaseQuantizeConfig, ops
from hqq_tpu_torch.core.peft import LoRALinear, PeftUtils, lora_config
from hqq_tpu_torch.engine.hf import HQQModel as TModel
from hqq_tpu_torch.models import llama as tl
from hqq_tpu_torch.serving.generate import Generator

_PROMPTS = {
    "b2": [[1, 7, 3, 9, 11], [4, 5, 6, 200, 17]],
    "b1": [[12, 99, 5, 31, 250, 4, 8]],
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch ops on one thread: the suite's workers share the cores, and
    torch's intra-op threads would oversubscribe them (a case of this
    module took minutes beside five busy workers, seconds alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("window", [None, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tensor_start_pos_is_bit_equal(dtype, window):
    cfg = dataclasses.replace(tl.LlamaConfig.tiny(), sliding_window=window)
    params = tl.init_params(cfg, torch.Generator().manual_seed(2), dtype, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 12), generator=torch.Generator().manual_seed(3))
    caches = [tl.init_cache(cfg, 2, 16, dtype, "cpu") for _ in range(2)]
    with torch.inference_mode():
        outs = []
        for cache, pos in zip(caches, (int, lambda p: torch.tensor(p))):
            logits, _ = tl.forward(params, cfg, toks[:, :8], cache, pos(0))
            steps = [logits]
            for i in range(8, 12):
                logits, _ = tl.forward(params, cfg, toks[:, i:i + 1], cache, pos(i))
                steps.append(logits)
            outs.append(steps)
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert torch.equal(caches[0].k, caches[1].k) and torch.equal(caches[0].v, caches[1].v)


@pytest.fixture(scope="module")
def both():
    """(hqq_tpu's model, the port's model on the CPU): the tiny Llama,
    4-bit g64 with fp32 compute, the same weights in both."""
    import jax
    import jax.numpy as jnp

    from hqq_tpu.core.quantize import BaseQuantizeConfig as JConfig
    from hqq_tpu.engine.hf import HQQModel as JModel
    from hqq_tpu.models import llama as jl
    from hqq_tpu.models import quantize_model as j_quantize_model
    from hqq_tpu_torch.utils import params_from_numpy

    cfg = jl.LlamaConfig.tiny()
    params = jl.init_params(cfg, jax.random.PRNGKey(1), dtype=jnp.float32)
    qparams = j_quantize_model(params, JConfig(nbits=4, group_size=64), compute_dtype=jnp.float32)
    jm = JModel(params=qparams, cfg=cfg, quantized=True).prepare_for_inference("w4a8")
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, qparams), "cpu")
    tm = TModel(params=tp, cfg=tl.LlamaConfig.tiny(), quantized=True).prepare_for_inference("w4a8")
    return jm, tm, jnp.float32


@pytest.mark.parametrize("prompt,eos", [("b2", False), ("b1", True)])
def test_full_matches_hqq_tpu_full(both, prompt, eos):
    jm, tm, jf32 = both
    kw = {}
    if eos:
        plain = jm.generate(_PROMPTS[prompt], max_new_tokens=10, cache_dtype=jf32)
        kw["eos_token_id"] = int(np.asarray(plain)[0, 4])
    ref = np.asarray(jm.generate(_PROMPTS[prompt], max_new_tokens=10, cache_dtype=jf32,
                                 compile_mode="full", **kw))
    got = tm.generate(_PROMPTS[prompt], max_new_tokens=10, cache_dtype=torch.float32,
                      compile_mode="full", **kw)
    assert got.shape == ref.shape and got.shape[0] == len(_PROMPTS[prompt])
    assert got.shape[1] == 10 or (eos and got.shape[1] <= 5)
    np.testing.assert_array_equal(got, ref)
    partial = tm.generate(_PROMPTS[prompt], max_new_tokens=10, cache_dtype=torch.float32,
                          compile_mode="partial", **kw)
    np.testing.assert_array_equal(partial, got)


def test_on_token_matches_hqq_tpu(both):
    jm, tm, jf32 = both
    ref_calls, got_calls = [], []
    from hqq_tpu.serving.generate import Generator as JGenerator

    # hqq_tpu's HQQModel.generate does not pass on_token on: its Generator does
    ref = np.asarray(JGenerator(jm.params, jm.cfg, cache_dtype=jf32).generate(
        _PROMPTS["b2"], max_new_tokens=7, on_token=ref_calls.append))
    got = tm.generate(_PROMPTS["b2"], max_new_tokens=7, cache_dtype=torch.float32,
                      on_token=got_calls.append)
    assert len(got_calls) == len(ref_calls) == 7
    for a, b in zip(got_calls, ref_calls):
        assert isinstance(a, np.ndarray) and a.shape == (2,)
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(np.stack(got_calls, axis=1), got)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("top_p", [1.0, 0.9])
def test_sampled_full_equals_partial(both, top_p):
    _, tm, _ = both
    kw = dict(max_new_tokens=9, do_sample=True, top_k=20, top_p=top_p, temperature=1.0,
              cache_dtype=torch.float32)
    full = tm.generate(_PROMPTS["b2"], seed=4, compile_mode="full", **kw)
    partial = tm.generate(_PROMPTS["b2"], seed=4, compile_mode="partial", **kw)
    streamed = tm.generate(_PROMPTS["b2"], seed=4, on_token=lambda ids: None, **kw)
    other = tm.generate(_PROMPTS["b2"], seed=5, compile_mode="full", **kw)
    np.testing.assert_array_equal(full, partial)
    np.testing.assert_array_equal(full, streamed)
    assert not np.array_equal(full, other)


@pytest.fixture
def cpu_graphs(monkeypatch):
    """Generators that keep graphs on the CPU: the device condition lifted
    and the capture a stub whose replay is the eager step. Returns the
    states captured, in order."""
    captured = []

    def capture(gen, st):
        captured.append(st)
        st.capture = {"seconds": 0.0, "launches": {}}
        st.graph = types.SimpleNamespace(replay=lambda: gen._decode_step(st))

    monkeypatch.setattr(Generator, "_capture", capture)
    monkeypatch.setattr(Generator, "_graphed", lambda gen, steps, on_token: (
        gen.compile_mode == "full" and on_token is None and steps > 1))
    return captured


def test_kept_buffers_are_reused_and_dropped(both, cpu_graphs):
    _, tm, _ = both
    model = TModel(params=tm.params, cfg=tm.cfg, quantized=True)
    kw = dict(cache_dtype=torch.float32)
    a = model.generate(_PROMPTS["b2"], max_new_tokens=6, **kw)
    gen = model.generator(**kw)
    assert list(gen.captures()) == [(2, 16)] and len(cpu_graphs) == 1
    cache_ptr = gen._graphs[(2, 16)].cache.k.data_ptr()
    b = model.generate(_PROMPTS["b2"], max_new_tokens=4, **kw)  # same cache_len: a replay
    assert model.generator(**kw) is gen and list(gen.captures()) == [(2, 16)]
    assert len(cpu_graphs) == 1 and gen._graphs[(2, 16)].cache.k.data_ptr() == cache_ptr
    np.testing.assert_array_equal(a[:, :4], b)
    model.generate(_PROMPTS["b2"], max_new_tokens=12, **kw)  # cache_len 32: a second graph
    assert list(gen.captures()) == [(2, 16), (2, 32)] and len(model._generators) == 1
    # "partial", streaming and one-token calls allocate per call and keep nothing
    model.generate(_PROMPTS["b2"], max_new_tokens=6, compile_mode="partial", **kw)
    model.generate(_PROMPTS["b2"], max_new_tokens=6, on_token=lambda ids: None, **kw)
    model.generate(_PROMPTS["b2"], max_new_tokens=1, **kw)
    assert model.generator(compile_mode="partial", **kw).captures() == {}
    assert list(gen.captures()) == [(2, 16), (2, 32)] and len(cpu_graphs) == 2
    model.prepare_for_inference("w4a8")
    assert model._generators == {}
    model.generate(_PROMPTS["b2"], max_new_tokens=2, **kw)
    assert model.generator(**kw) is not gen
    model.release_graphs()
    assert model._generators == {}


def test_kept_graphs_are_bounded(both, cpu_graphs, monkeypatch):
    _, tm, _ = both
    monkeypatch.setattr(Generator, "max_graphs", 2)
    gen = Generator(tm.params, tm.cfg, cache_dtype=torch.float32, device="cpu")
    for new in (6, 12, 6, 28):  # cache_len 16, 32, 16 (a replay), 64
        gen.generate(_PROMPTS["b2"], max_new_tokens=new)
    assert list(gen.captures()) == [(2, 16), (2, 64)]  # (2, 32) was the least recently used
    assert [st.out.shape[1] for st in cpu_graphs] == [16, 32, 64]
    gen.release_graphs()
    assert gen.captures() == {}


def _random_lora_b(params, seed: int) -> None:
    """Nonzero adapters (add_lora starts B at zero, which changes nothing)."""
    g = torch.Generator().manual_seed(seed)
    for layer in params["layers"]:
        for group in ("self_attn", "mlp"):
            for m in layer[group].values():
                if isinstance(m, LoRALinear):
                    m.lora_b.data = 0.05 * torch.randn(m.lora_b.shape, generator=g).to(m.lora_b)


def _adapter_changes(model, check) -> None:
    """Add nonzero adapters to ``model`` in place, then merge them, then
    set ``params`` anew (the layers reversed), calling ``check()`` after
    each."""
    PeftUtils.add_lora(model.params, lora_config(r=4, lora_alpha=8))
    _random_lora_b(model.params, 5)
    check()
    PeftUtils.merge_lora(model.params)
    check()
    model.params = dict(model.params, layers=model.params["layers"][::-1])
    check()


def test_parameter_changes_make_the_graph_recapture(cpu_graphs):
    cfg = tl.LlamaConfig.tiny()
    model = TModel(tl.init_params(cfg, torch.Generator().manual_seed(6), torch.float32, "cpu"),
                   cfg)
    model.quantize_model(BaseQuantizeConfig(nbits=4, group_size=64), torch.float32)
    kw = dict(max_new_tokens=6, cache_dtype=torch.float32)

    def check():
        fresh = TModel(params=model.params, cfg=cfg, quantized=True)
        want = fresh.generate(_PROMPTS["b2"], compile_mode="partial", **kw)
        np.testing.assert_array_equal(model.generate(_PROMPTS["b2"], **kw), want)
        np.testing.assert_array_equal(model.generate(_PROMPTS["b2"], **kw), want)

    check()
    assert len(cpu_graphs) == 1
    first = model.generate(_PROMPTS["b2"], **kw)
    _adapter_changes(model, check)
    assert len(cpu_graphs) == 4  # one capture per tree, none for the repeated calls
    assert not np.array_equal(model.generate(_PROMPTS["b2"], **kw), first)


def test_quantize_model_drops_kept_generators():
    cfg = tl.LlamaConfig.tiny()
    model = TModel(tl.init_params(cfg, None, torch.float32, "cpu"), cfg)
    model.generate(_PROMPTS["b1"], max_new_tokens=2, cache_dtype=torch.float32)
    assert len(model._generators) == 1
    model.quantize_model(BaseQuantizeConfig(nbits=4, group_size=64))
    assert model._generators == {}


def test_compile_mode_checked():
    cfg = tl.LlamaConfig.tiny()
    with pytest.raises(ValueError, match="compile_mode"):
        Generator({}, cfg, compile_mode="scan", device="cpu")


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = tl.LlamaConfig.tiny()
    model = TModel(tl.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                                  torch.bfloat16, "cuda"), cfg)
    model.quantize_model(BaseQuantizeConfig(nbits=4, group_size=64))
    return model.prepare_for_inference("w4a8")


@pytest.mark.cuda
@pytest.mark.parametrize("do_sample", [False, True])
def test_graph_ids_equal_eager_ids(cuda_model, do_sample):
    kw = dict(max_new_tokens=12, do_sample=do_sample, top_k=20, top_p=0.9, seed=3)
    full = cuda_model.generate(_PROMPTS["b2"], **kw)
    again = cuda_model.generate(_PROMPTS["b2"], **kw)  # a replay of the kept graph
    made = []
    new_state = Generator._new_state

    def recorded(gen, *a):
        made.append(new_state(gen, *a))
        return made[-1]

    with mock.patch.object(Generator, "_new_state", recorded):
        partial = cuda_model.generate(_PROMPTS["b2"], compile_mode="partial", **kw)
    gen = cuda_model.generator(do_sample=do_sample, top_k=20, top_p=0.9)
    assert list(gen.captures()) == [(2, 32)] and len(made) == 1
    np.testing.assert_array_equal(full, partial)
    np.testing.assert_array_equal(again, partial)
    # every layer's K/V of every step, as the replays and the eager loop left them
    assert torch.equal(gen._graphs[(2, 32)].cache.k, made[0].cache.k)
    assert torch.equal(gen._graphs[(2, 32)].cache.v, made[0].cache.v)


@pytest.mark.cuda
def test_capture_launches_equal_a_partial_step(cuda_model):
    ops.reset_launch_counts()
    cuda_model.generate(_PROMPTS["b2"], max_new_tokens=1, compile_mode="partial")
    prefill = {w.__name__: w.launches for w in ops.kernel_wrappers()}
    ops.reset_launch_counts()
    cuda_model.generate(_PROMPTS["b2"], max_new_tokens=3, compile_mode="partial")
    per_step = {w.__name__: (w.launches - prefill[w.__name__]) / 2 for w in ops.kernel_wrappers()}
    per_step = {k: v for k, v in per_step.items() if v}
    cuda_model.generate(_PROMPTS["b2"], max_new_tokens=3)
    (capture,) = cuda_model.generator().captures().values()
    assert per_step == {"w4a8_matmul": 14}
    assert capture["launches"] == per_step


@pytest.mark.cuda
def test_host_read_in_the_step_makes_capture_raise(cuda_model):
    def reads_host(params, toks, cache, pos):
        int(pos)  # a host read: legal eagerly, illegal under capture
        return tl.forward(params, cuda_model.cfg, toks, cache, pos)

    gen = Generator(cuda_model.params, cuda_model.cfg, forward_fn=reads_host)
    eager = Generator(cuda_model.params, cuda_model.cfg, forward_fn=reads_host,
                      compile_mode="partial").generate(_PROMPTS["b2"], max_new_tokens=4)
    assert eager.shape == (2, 4)
    with pytest.raises(RuntimeError):
        gen.generate(_PROMPTS["b2"], max_new_tokens=4)


@pytest.mark.cuda
def test_graph_follows_parameter_changes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = tl.LlamaConfig.tiny()
    model = TModel(tl.init_params(cfg, torch.Generator("cuda").manual_seed(6), torch.bfloat16,
                                  "cuda"), cfg)
    model.quantize_model(BaseQuantizeConfig(nbits=4, group_size=64))
    kw = dict(max_new_tokens=6)

    def check():
        fresh = TModel(params=model.params, cfg=cfg, quantized=True)
        want = fresh.generate(_PROMPTS["b2"], compile_mode="partial", **kw)
        np.testing.assert_array_equal(model.generate(_PROMPTS["b2"], **kw), want)
        np.testing.assert_array_equal(model.generate(_PROMPTS["b2"], **kw), want)  # a replay

    check()
    _adapter_changes(model, check)
    assert len(model.generator().captures()) == 1
