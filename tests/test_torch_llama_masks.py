# SPDX-License-Identifier: Apache-2.0
"""`models.llama.forward`'s ``kv_valid`` and ``inputs_embeds`` against
hqq_tpu, on the CPU.

A tiny Llama (hqq_tpu's random fp32 weights, carried across by
`params_from_numpy`), torch on one thread, hqq_tpu's forward jitted once
in a module fixture:

* a left-padded batch over the dense cache, ``kv_valid`` leaving the pad
  slots out: the prefill and three decode steps within 1e-5 of max|logits|
  of hqq_tpu's (fp32; sums in another order), and a control, the same
  steps without ``kv_valid``, past that bar;
* ``inputs_embeds`` in place of the tokens (``tokens=None``): bit-equal to
  the token path, within 1e-5 of hqq_tpu's with the same embeddings, over
  the dense cache and cache-free.
"""

import numpy as np
import pytest
import torch

from hqq_tpu_torch.models import llama as tl
from hqq_tpu_torch.utils import params_from_numpy

_BAR = 1e-5
_PAD = 3  # slot 0's prompt is 3 tokens shorter, padded on the left


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    """The configs, the port's tree, the tokens and the embeddings, and
    hqq_tpu's logits: the left-padded run with kv_valid (a prefill of 8,
    3 steps) and the inputs_embeds runs (dense cache, cache-free)."""
    import jax
    import jax.numpy as jnp

    from hqq_tpu.models import llama as jl

    fwd = jax.jit(jl.forward, static_argnums=(1,))
    jcfg = jl.LlamaConfig.tiny()
    params = jl.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    rng = np.random.default_rng(0)
    toks = rng.integers(1, jcfg.vocab_size, (2, 11)).astype(np.int32)
    toks[0, :_PAD] = 0
    valid = np.ones((2, 16), bool)
    valid[0, :_PAD] = False
    cache = jl.init_cache(jcfg, 2, 16, jnp.float32)
    logits, cache = fwd(params, jcfg, jnp.asarray(toks[:, :8]), cache, 0, jnp.asarray(valid))
    padded = [np.asarray(logits)]
    for i in range(8, 11):
        logits, cache = fwd(params, jcfg, jnp.asarray(toks[:, i:i + 1]), cache, i,
                            jnp.asarray(valid))
        padded.append(np.asarray(logits))
    embeds = np.asarray(params["embed_tokens"])[toks[:, :8]]
    embed_cached = np.asarray(fwd(params, jcfg, None, jl.init_cache(jcfg, 2, 16, jnp.float32), 0,
                                  None, jnp.asarray(embeds))[0])
    embed_nocache = np.asarray(fwd(params, jcfg, None, None, 0, None, jnp.asarray(embeds))[0])
    np_tree = jax.tree_util.tree_map(np.asarray, params)
    return dict(tcfg=tl.LlamaConfig(**{k: getattr(jcfg, k) for k in jcfg.__dataclass_fields__}),
                tree=params_from_numpy(np_tree, "cpu"), toks=torch.from_numpy(toks).long(),
                valid=torch.from_numpy(valid), padded=padded, embeds=torch.from_numpy(embeds),
                embed_cached=embed_cached, embed_nocache=embed_nocache)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _padded_run(r, kv_valid):
    cache = tl.init_cache(r["tcfg"], 2, 16, torch.float32, "cpu")
    toks = r["toks"]
    out = [tl.forward(r["tree"], r["tcfg"], toks[:, :8], cache, 0, kv_valid=kv_valid)[0]]
    out += [tl.forward(r["tree"], r["tcfg"], toks[:, i:i + 1], cache, i, kv_valid=kv_valid)[0]
            for i in range(8, 11)]
    return out


def test_kv_valid_left_padded_batch(ref):
    for got, want in zip(_padded_run(ref, ref["valid"]), ref["padded"]):
        assert _rel(got.numpy(), want) <= _BAR
    # control: the pad slots attended; slot 0's logits move past the bar
    control = _padded_run(ref, None)
    assert _rel(control[-1][0].numpy(), ref["padded"][-1][0]) > _BAR


@pytest.mark.parametrize("cached", [True, False])
def test_inputs_embeds(ref, cached):
    r = ref
    cfg, tree = r["tcfg"], r["tree"]

    def run(**kw):
        cache = tl.init_cache(cfg, 2, 16, torch.float32, "cpu") if cached else None
        return tl.forward(tree, cfg, cache=cache, start_pos=0, **kw)[0]

    got = run(tokens=None, inputs_embeds=r["embeds"])
    assert torch.equal(got, run(tokens=r["toks"][:, :8]))
    assert _rel(got.numpy(), r["embed_cached" if cached else "embed_nocache"]) <= _BAR
