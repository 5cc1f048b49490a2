# SPDX-License-Identifier: Apache-2.0
"""Paged serving of the RMSNorm families in hqq_tpu_torch, on the CPU.

Mirrors hqq_tpu's tests/test_paged_families.py with the port's engines and
hqq_tpu's random fp32 weights (carried across by `params_from_numpy`):

* `PagedBatchingEngine` through each family's paged branch (Mistral's
  window, Granite's multipliers, Gemma-2's softcaps and alternating
  windows, Gemma-3's two RoPE tables and per-head Gemma norms, Phi-3's
  fused projections) gives the greedy ids of a dense-cache greedy loop over
  the same forward, and the ids of hqq_tpu's paged engine;
* int8 pages through Gemma-2's gather route: the first token agrees with
  the dense loop's, as in hqq_tpu (int8 K/V is lossy);
* `SpeculativePagedEngine` with the target as its draft gives the plain
  paged engine's ids (the verify windows of every paged branch);
* the dense `ContinuousBatchingEngine` serves Gemma and OLMo-2 (no paged
  branch) with the dense loop's ids;
* `serve.build_engine` picks the paged engine where the family forward
  takes ``page_indices`` and the dense one otherwise;
* `SpeculativeBatchingEngine` and `Generator` ("full", eager on the CPU)
  through the family forwards give the dense loop's ids.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from hqq_tpu_torch.models import llama as tl
from hqq_tpu_torch.serving.batching import ContinuousBatchingEngine
from hqq_tpu_torch.serving.paged import PagedBatchingEngine
from hqq_tpu_torch.serving.speculative import SpeculativePagedEngine
from hqq_tpu_torch.utils import params_from_numpy

_CONFIG = {"mistral": "MistralConfig", "granite": "GraniteConfig", "gemma": "GemmaConfig",
           "gemma2": "Gemma2Config", "gemma3": "Gemma3Config", "phi3": "Phi3Config",
           "olmo2": "Olmo2Config"}
PAGED = ["mistral", "granite", "gemma2", "gemma3", "phi3"]
_POOL = dict(batch_slots=2, num_pages=32, page_size=4, max_pages_per_seq=8)
_PROMPT, _NEW = [3, 17, 29, 5, 11], 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch ops on one thread: the suite's workers share the cores, and
    torch's intra-op threads would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fams():
    """Per family: the port's config, tree and forward, and hqq_tpu's paged
    engine's greedy ids (families with a paged branch)."""
    import jax
    import jax.numpy as jnp

    from hqq_tpu.serving.paged import PagedBatchingEngine as JaxPaged

    out = {}
    for i, family in enumerate(_CONFIG):
        jm = importlib.import_module(f"hqq_tpu.models.{family}")
        tm = importlib.import_module(f"hqq_tpu_torch.models.{family}")
        jcfg = getattr(jm, _CONFIG[family]).tiny()
        params = jm.init_params(jcfg, jax.random.PRNGKey(i + 1), dtype=jnp.float32)
        tcfg = getattr(tm, _CONFIG[family])(**dataclasses.asdict(jcfg))
        tree = params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
        entry = dict(cfg=tcfg, tree=tree, fwd=tm.forward)
        if family in PAGED:
            eng = JaxPaged(params, jcfg, cache_dtype=jnp.float32, **_POOL,
                           forward_fn=lambda p, toks, c, pos, ptab=None, jm=jm, jcfg=jcfg:
                           jm.forward(p, jcfg, toks, c, pos, page_indices=ptab))
            uid = eng.add_request(_PROMPT, max_new_tokens=_NEW)
            entry["jax_paged"] = eng.run()[uid]
        out[family] = entry
    return out


def _copy_tree(tree):
    """A copy of a tree's containers and tensors (quantize_model works in place)."""
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy_tree(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    return type(tree)(tree.weight.clone(), None if tree.bias is None else tree.bias.clone())


def _dense_greedy(f, prompt, n_new):
    cache = tl.init_cache(f["cfg"], 1, 64, torch.float32, "cpu")
    logits, _ = f["fwd"](f["tree"], f["cfg"], torch.tensor([prompt]), cache, 0)
    out = [int(logits[0, -1].argmax())]
    for pos in range(len(prompt), len(prompt) + n_new - 1):
        logits, _ = f["fwd"](f["tree"], f["cfg"], torch.tensor([[out[-1]]]), cache, pos)
        out.append(int(logits[0, -1].argmax()))
    return out


def _paged_fn(f):
    return lambda p, toks, cache, pos, ptab=None: f["fwd"](p, f["cfg"], toks, cache, pos,
                                                         page_indices=ptab)


def _paged_run(f, **kw):
    eng = PagedBatchingEngine(f["tree"], f["cfg"], cache_dtype=torch.float32, device="cpu",
                              forward_fn=_paged_fn(f), **(_POOL | kw))
    uid = eng.add_request(_PROMPT, max_new_tokens=_NEW)
    return eng.run()[uid]


@pytest.mark.parametrize("family", PAGED)
def test_paged_engine_matches_dense(fams, family):
    f = fams[family]
    got = _paged_run(f)
    assert got == _dense_greedy(f, _PROMPT, _NEW)
    assert got == f["jax_paged"]


def test_int8_pages_gemma2(fams):
    f = fams["gemma2"]
    got = _paged_run(f, quantize_kv=True)
    assert len(got) == _NEW and got[0] == _dense_greedy(f, _PROMPT, _NEW)[0]


@pytest.mark.parametrize("family", PAGED)
def test_paged_speculative_matches_paged(fams, family):
    f = fams[family]
    eng = SpeculativePagedEngine(
        f["tree"], f["tree"], f["cfg"], k_draft=3, cache_dtype=torch.float32, device="cpu",
        forward_fn=_paged_fn(f),
        draft_forward_fn=lambda p, toks, cache, pos: f["fwd"](p, f["cfg"], toks, cache, pos),
        **_POOL)
    uid = eng.add_request(_PROMPT, max_new_tokens=_NEW)
    assert eng.run()[uid] == _paged_run(f)


@pytest.mark.parametrize("family", ["gemma", "olmo2"])
def test_dense_engine_serves_families_without_paged_branch(fams, family):
    f = fams[family]
    eng = ContinuousBatchingEngine(
        f["tree"], f["cfg"], batch_slots=2, max_len=64, cache_dtype=torch.float32, device="cpu",
        forward_fn=lambda p, toks, cache, pos: f["fwd"](p, f["cfg"], toks, cache, pos))
    uid = eng.add_request(_PROMPT, max_new_tokens=_NEW)
    assert eng.run()[uid] == _dense_greedy(f, _PROMPT, _NEW)


@pytest.mark.parametrize("family,engine", [("gemma2", PagedBatchingEngine),
                                           ("gemma3", PagedBatchingEngine),
                                           ("gemma", ContinuousBatchingEngine),
                                           ("olmo2", ContinuousBatchingEngine)])
def test_serve_picks_the_engine(fams, family, engine, monkeypatch):
    from hqq_tpu_torch import serve
    from hqq_tpu_torch.core.quantize import BaseQuantizeConfig
    from hqq_tpu_torch.models.base import quantize_model

    # quantized with fp32 compute: the server's cache takes that type
    f = dict(fams[family])
    f["tree"] = quantize_model(_copy_tree(f["tree"]),
                               BaseQuantizeConfig(nbits=4, group_size=32), torch.float32)
    monkeypatch.setattr(serve, "_load", lambda args: (f["tree"], f["cfg"], f["fwd"]))
    args = serve.make_parser().parse_args(
        ["--model", "unused", "--device", "cpu", "--backend", "xla", "--slots", "2",
         "--num-pages", "32", "--page-size", "4", "--max-pages-per-seq", "8", "--max-len", "64"])
    eng = serve.build_engine(args)
    assert type(eng) is engine
    uid = eng.add_request(_PROMPT, max_new_tokens=3)
    assert eng.run()[uid] == _dense_greedy(f, _PROMPT, 3)


@pytest.mark.parametrize("family", ["gemma", "olmo2", "gemma2"])
def test_dense_speculative_matches_dense(fams, family):
    from hqq_tpu_torch.serving.speculative import SpeculativeBatchingEngine

    f = fams[family]
    fwd = lambda p, toks, cache, pos: f["fwd"](p, f["cfg"], toks, cache, pos)  # noqa: E731
    eng = SpeculativeBatchingEngine(f["tree"], f["tree"], f["cfg"], k_draft=3, batch_slots=2,
                                    max_len=64, cache_dtype=torch.float32, forward_fn=fwd,
                                    draft_forward_fn=fwd, device="cpu")
    uid = eng.add_request(_PROMPT, max_new_tokens=_NEW)
    assert eng.run()[uid] == _dense_greedy(f, _PROMPT, _NEW)


@pytest.mark.parametrize("family", ["gemma2", "olmo2"])
def test_generator_full_matches_dense(fams, family):
    from hqq_tpu_torch.engine.hf import HQQModel

    f = fams[family]
    model = HQQModel(f["tree"], f["cfg"], family)  # the family's registry entry
    ids = model.generate(np.asarray([_PROMPT]), max_new_tokens=_NEW, cache_dtype=torch.float32,
                         device="cpu")
    assert ids[0].tolist() == _dense_greedy(f, _PROMPT, _NEW)
