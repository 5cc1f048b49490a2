# SPDX-License-Identifier: Apache-2.0
"""hqq_tpu_torch's multi-LoRA serving against hqq_tpu's, on the CPU.

The recipe of hqq_tpu's tests/test_multilora.py: LlamaConfig.tiny
(vocab_size=128) quantized by hqq_tpu to 4-bit g32 with fp32 compute,
adapters of rank 4 on every linear but lm_head (adapter 0 as `add_lora`
leaves it, B = 0; adapters 1 and 2 with B random, std 0.03 and 0.08),
stacked by `stack_adapters`; every tree carried across with
params_from_numpy.

* `MultiLoRALinear` and `stack_adapters`: the logits of a batch whose rows
  name different adapters against hqq_tpu's under `adapter_context`, and
  against each row through its own adapter's `LoRALinear` tree, at 2e-4
  (hqq_tpu's bar); a tree stacked by hqq_tpu and carried across gives the
  same; with no context bound, the bare base; over a base prepared for
  "w4a8" a row's logits do not depend on its neighbours' adapters.
* Both engines: each request's ids equal those of a single-adapter engine
  on its adapter's tree and of hqq_tpu's `ContinuousBatchingEngine` on the
  stacked tree; the paged prefix cache shares pages within an adapter
  only; an adapter id outside the stack is refused with a ValueError
  before any step (hqq_tpu's gather fills such a row with NaN), and
  answered 400 by the server, which serves the others.
"""

import http.client
import json

import numpy as np
import pytest
import torch

from hqq_tpu_torch.core.peft import LoRALinear as TLoRALinear
from hqq_tpu_torch.core.peft import PeftUtils as TPeft
from hqq_tpu_torch.core.peft import lora_config as t_lora_config
from hqq_tpu_torch.models import llama as tl
from hqq_tpu_torch.nn.multilora import (
    MultiLoRALinear,
    adapter_context,
    adapter_count,
    current_adapter_ids,
    stack_adapters,
)
from hqq_tpu_torch.serving.batching import ContinuousBatchingEngine
from hqq_tpu_torch.serving.paged import PagedBatchingEngine
from hqq_tpu_torch.serving.server import InferenceServer
from hqq_tpu_torch.utils import params_from_numpy
from hqq_tpu_torch.utils.patching import prepare_for_inference

_B_STD = (0.0, 0.03, 0.08)  # adapter i's B (0: the empty adapter)
_TOKENS = [[3, 17, 29, 5, 11, 60], [9, 8, 7, 6, 5, 4], [100, 2, 71, 8, 33, 1]]
_PROMPTS = [[3, 17, 29, 5, 11, 60, 2], [9, 8, 7, 6, 5], [100, 2, 71, 8, 33, 1], [4, 4, 50]]
_ADAPTERS = [1, 2, 0, 1]  # of each prompt
_NEW = 8
_DENSE = dict(batch_slots=2, max_len=64)
_PAGED = dict(batch_slots=2, num_pages=40, page_size=4, max_pages_per_seq=8)


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
    """hqq_tpu's base, adapter trees and stacked tree (numpy leaves), its
    logits of the mixed batch and its dense engine's ids of the prompts."""
    import dataclasses as dc

    import jax
    import jax.numpy as jnp

    from hqq_tpu.core.peft import LoRALinear, PeftUtils, lora_config
    from hqq_tpu.core.quantize import BaseQuantizeConfig
    from hqq_tpu.models import LlamaConfig, forward, init_params, quantize_model
    from hqq_tpu.nn.multilora import adapter_context as j_adapter_context
    from hqq_tpu.nn.multilora import stack_adapters as j_stack_adapters
    from hqq_tpu.serving.batching import ContinuousBatchingEngine as JEngine

    cfg = LlamaConfig.tiny(vocab_size=128)
    base = quantize_model(init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32),
                          BaseQuantizeConfig(nbits=4, group_size=32), compute_dtype=jnp.float32)
    rng = np.random.default_rng(0)

    def bump(tree, std):
        def rec(node):
            if isinstance(node, dict):
                return {k: rec(v) for k, v in node.items()}
            if isinstance(node, list):
                return [rec(v) for v in node]
            if isinstance(node, LoRALinear):
                b = jnp.asarray(rng.standard_normal(node.lora_b.shape) * std, node.lora_b.dtype)
                return dc.replace(node, lora_b=b)
            return node

        return rec(tree) if std else tree

    loras = [bump(PeftUtils.add_lora(base, lora_config(r=4)), std) for std in _B_STD]
    multi = j_stack_adapters(loras, base)
    ids = jnp.asarray([1, 2, 0], jnp.int32)
    with j_adapter_context(ids):
        logits = forward(multi, cfg, jnp.asarray(_TOKENS, jnp.int32))[0]
    eng = JEngine(multi, cfg, cache_dtype=jnp.float32, **_DENSE)
    uids = [eng.add_request(p, max_new_tokens=_NEW, adapter_id=a)
            for p, a in zip(_PROMPTS, _ADAPTERS)]
    out = eng.run()
    numpy = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(base=numpy(base), loras=[numpy(t) for t in loras], multi=numpy(multi),
                logits=np.asarray(logits), ids=[out[u] for u in uids])


def _cfg():
    return tl.LlamaConfig.tiny(vocab_size=128)


def _port(ref):
    """(base, adapter trees, stacked tree) in the port: the adapter trees
    carried across, the stack made by the port's `stack_adapters` over a
    base of its own."""
    base = params_from_numpy(ref["base"], "cpu")
    loras = [params_from_numpy(t, "cpu") for t in ref["loras"]]
    return base, loras, stack_adapters(loras, base)


def _forward(tree, tokens, ids=None):
    toks = torch.as_tensor(tokens)
    with torch.inference_mode():
        if ids is None:
            return tl.forward(tree, _cfg(), toks)[0]
        with adapter_context(torch.as_tensor(ids)):
            return tl.forward(tree, _cfg(), toks)[0]


def _close(got, want, bar=2e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=bar, atol=bar)


def test_mixed_batch_logits(ref):
    base, loras, multi = _port(ref)
    assert isinstance(multi["layers"][0]["self_attn"]["q_proj"], MultiLoRALinear)
    assert not isinstance(multi["lm_head"], MultiLoRALinear)
    assert adapter_count(multi) == 3 and adapter_count(base) == 1
    got = _forward(multi, _TOKENS, [1, 2, 0])
    _close(got, ref["logits"])
    for row, adapter in enumerate([1, 2, 0]):  # each row through its own adapter alone
        _close(got[row], _forward(loras[adapter], _TOKENS[row:row + 1])[0])
    assert (got[0] - _forward(loras[2], _TOKENS[:1])[0]).abs().max() > 1e-3  # adapters differ
    # no context bound: the bare base
    _close(_forward(multi, _TOKENS), _forward(base, _TOKENS), 1e-6)


def test_tree_stacked_by_hqq_tpu(ref):
    multi = params_from_numpy(ref["multi"], "cpu")
    layer = multi["layers"][1]["mlp"]["down_proj"]
    assert isinstance(layer, MultiLoRALinear) and layer.a_stack.shape == (3, 512, 4)
    _close(_forward(multi, _TOKENS, [1, 2, 0]), ref["logits"])


def test_rows_do_not_depend_on_neighbours_over_w4a8(ref):
    base, loras, _ = _port(ref)
    multi = stack_adapters(loras, prepare_for_inference(base, "w4a8"))
    assert type(multi["layers"][0]["mlp"]["up_proj"].base).__name__ == "A8QuantLinear"
    mixed = _forward(multi, _TOKENS, [1, 2, 0])
    for row, adapter in enumerate([1, 2, 0]):
        alone = _forward(multi, _TOKENS[row:row + 1], [adapter])[0]
        _close(mixed[row], alone, 1e-5)
    # the control: every row on adapter 0 misses rows 0 and 1
    zero = _forward(multi, _TOKENS, [0, 0, 0])
    assert all((zero[r] - mixed[r]).abs().max() > 1e-3 for r in (0, 1))


def _run(engine, prompts, adapters, new=_NEW):
    uids = [engine.add_request(p, max_new_tokens=new, adapter_id=a)
            for p, a in zip(prompts, adapters)]
    out = engine.run()
    return [out[u] for u in uids]


def _singles(cls, kw, loras, prompts, adapters):
    """Each request alone through an engine on its adapter's own tree."""
    return [_run(cls(loras[a], _cfg(), cache_dtype=torch.float32, device="cpu", **kw), [p], [0])[0]
            for p, a in zip(prompts, adapters)]


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_engine_ids(ref, kind):
    cls, kw = ((ContinuousBatchingEngine, _DENSE) if kind == "dense"
               else (PagedBatchingEngine, _PAGED))
    _, loras, multi = _port(ref)
    got = _run(cls(multi, _cfg(), cache_dtype=torch.float32, device="cpu", **kw), _PROMPTS,
               _ADAPTERS)
    assert got == ref["ids"]
    assert got == _singles(cls, kw, loras, _PROMPTS, _ADAPTERS)
    assert len({tuple(o) for o in got[:3]}) == 3


def test_prefix_cache_keeps_adapters_apart(ref):
    _, loras, multi = _port(ref)
    prompt = list(range(1, 14))  # three full pages of 4 cacheable
    eng = PagedBatchingEngine(multi, _cfg(), cache_dtype=torch.float32, device="cpu",
                              enable_prefix_cache=True, **_PAGED)
    got, hits = [], []
    for adapter in (1, 2, 1):
        got.append(_run(eng, [prompt], [adapter])[0])
        hits.append(eng.prefix_cache_hits)
    assert hits == [0, 0, 3]  # reused only under the same adapter
    assert got[0] == got[2] != got[1]
    assert got[:2] == _singles(PagedBatchingEngine, _PAGED, loras, [prompt] * 2, [1, 2])


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_adapter_outside_the_stack_refused(ref, kind):
    cls, kw = ((ContinuousBatchingEngine, _DENSE) if kind == "dense"
               else (PagedBatchingEngine, _PAGED))
    base, _, multi = _port(ref)
    eng = cls(multi, _cfg(), cache_dtype=torch.float32, device="cpu", **kw)
    for bad in (3, -1):
        with pytest.raises(ValueError, match="adapter_id"):
            eng.add_request([1, 2, 3], adapter_id=bad)
    assert not eng.queue
    with pytest.raises(ValueError, match="adapter_id"):  # a tree with no stack: adapter 0 only
        cls(base, _cfg(), cache_dtype=torch.float32, device="cpu", **kw).add_request(
            [1, 2, 3], adapter_id=1)


def _post(port, obj):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/generate", json.dumps(obj), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read())


def test_server_serves_adapters(ref):
    _, _, multi = _port(ref)
    srv = InferenceServer(PagedBatchingEngine(multi, _cfg(), cache_dtype=torch.float32,
                                              device="cpu", **_PAGED), port=0).start()
    try:
        for prompt, adapter, want in zip(_PROMPTS[:2], _ADAPTERS, ref["ids"]):
            status, out = _post(srv.port, {"prompt_ids": prompt, "max_new_tokens": _NEW,
                                           "adapter_id": adapter})
            assert status == 200 and out["tokens"] == want
        status, out = _post(srv.port, {"prompt_ids": [1, 2], "adapter_id": 3})
        assert status == 400 and "adapter_id" in out["error"]
        status, _ = _post(srv.port, {"prompt_ids": _PROMPTS[0], "max_new_tokens": 2})
        assert status == 200  # still serving
    finally:
        srv.stop()


def test_lora_layer_of_the_stack(ref):
    """The stack's scaling folds each adapter's own into B, as hqq_tpu's."""
    _, loras, multi = _port(ref)
    layer = multi["layers"][0]["self_attn"]["o_proj"]
    own = loras[2]["layers"][0]["self_attn"]["o_proj"]
    assert isinstance(own, TLoRALinear) and own.scaling != 1.0 and layer.scaling == 1.0
    torch.testing.assert_close(layer.b_stack[2], own.lora_b * own.scaling)
    # the port's own adapters, made by add_lora in place on a tree of its own
    grown = TPeft.add_lora(params_from_numpy(ref["base"], "cpu"), t_lora_config(r=2))
    stacked = stack_adapters([grown, grown], params_from_numpy(ref["base"], "cpu"))
    assert adapter_count(stacked) == 2
    assert stacked["layers"][1]["mlp"]["gate_proj"].a_stack.shape == (2, 256, 2)


def test_adapter_ids_are_bound_per_thread():
    """Ids bound on one thread (a server's loop) reach no forward on
    another, and the stack unwinds to nothing."""
    import threading

    seen, bound, release = {}, threading.Event(), threading.Event()

    def loop():
        with adapter_context([1, 2]):
            seen["loop"] = current_adapter_ids().tolist()
            bound.set()
            release.wait(10)

    t = threading.Thread(target=loop)
    t.start()
    assert bound.wait(10)
    seen["other"] = current_adapter_ids()
    with adapter_context([0]):
        seen["other nested"] = current_adapter_ids().tolist()
    release.set()
    t.join(10)
    assert seen == {"loop": [1, 2], "other": None, "other nested": [0]}
    assert current_adapter_ids() is None


# ---------------------------------------------------------------------------
# On the card (marked ``cuda``; skips where torch sees no CUDA device; JAX is
# imported only inside the CPU fixture, so on the GPU:
# ``python -m pytest --noconftest -m cuda tests/test_torch_multilora.py``)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_engine_rows_on_the_card_do_not_depend_on_neighbours():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from hqq_tpu_torch import BaseQuantizeConfig
    from hqq_tpu_torch.models.base import quantize_model

    cfg = _cfg()
    params = tl.init_params(cfg, torch.Generator("cuda").manual_seed(0), torch.bfloat16, "cuda")
    quantize_model(params, BaseQuantizeConfig(nbits=4, group_size=64))
    base = prepare_for_inference(params, "w4a8")
    loras = []
    for seed in (1, 2, 3):
        tree = {k: v for k, v in base.items()}
        tree["layers"] = [{g: dict(b) if isinstance(b, dict) else b for g, b in layer.items()}
                          for layer in base["layers"]]
        gen = torch.Generator("cuda").manual_seed(seed)
        for layer in tree["layers"]:
            for group in ("self_attn", "mlp"):
                for name, mod in layer[group].items():
                    wrapped = TLoRALinear.wrap(mod, r=4, generator=gen, device="cuda")
                    wrapped.lora_b.data = 0.05 * torch.randn(wrapped.lora_b.shape, generator=gen,
                                                             device="cuda")
                    layer[group][name] = wrapped
        loras.append(tree)
    multi = stack_adapters(loras, base)
    kw = dict(cache_dtype=torch.bfloat16, device="cuda", **_PAGED)
    mixed = _run(PagedBatchingEngine(multi, cfg, **kw), _PROMPTS, [0, 1, 2, 1])
    for a in (0, 1, 2):
        others = [(a + 1) % 3 if b != a else a for b in (0, 1, 2, 1)]
        again = _run(PagedBatchingEngine(multi, cfg, **kw), _PROMPTS, others)
        assert all(m == g for m, g, b in zip(mixed, again, (0, 1, 2, 1)) if b == a)
    assert len({tuple(o) for o in mixed[:3]}) == 3
