# SPDX-License-Identifier: Apache-2.0
"""hqq_tpu_torch's whole-sequence attention, cache-free forward and
perplexity harness against hqq_tpu's.

The same numpy-seeded inputs go through both packages on the CPU, in fp32,
where hqq_tpu's `prefill_attention` takes its naive path and the port's
`flash_attention` wrapper its plain version. Tolerances: attention 1e-5 of
max|out| (fp32 sums in another order); logits 1e-5 of max|logits| against
hqq_tpu and against the port's own dense-cache forward; log-likelihood and
perplexity rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hqq_tpu.core.quantize import BaseQuantizeConfig as JConfig
from hqq_tpu.models import llama as jl
from hqq_tpu.models import quantize_model as j_quantize_model
from hqq_tpu.ops import attention as ja
from hqq_tpu.utils import eval as je
from hqq_tpu_torch.models import llama as tl
from hqq_tpu_torch.ops import attention as ta
from hqq_tpu_torch.utils import eval as te
from hqq_tpu_torch.utils import params_from_numpy


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, ref, tol=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, atol=tol * np.abs(ref).max(), rtol=0)


def _qkv(b, h, t, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, t, hd)).astype(np.float32) for _ in range(3)]


# T = 300 takes the port's kernel route (its plain version here), T = 40 the
# naive path; hqq_tpu is on its naive path on the CPU either way
@pytest.mark.parametrize("t", [40, 300])
@pytest.mark.parametrize("mode", ["causal", "full", "masked", "scaled"])
def test_prefill_attention_matches(t, mode):
    q, k, v = _qkv(2, 3, t, 32, seed=t)
    kw = {}
    if mode == "full":
        kw["causal"] = False
    elif mode == "scaled":
        kw["scale"] = 0.07
    j_kw, t_kw = dict(kw), dict(kw)
    if mode == "masked":  # a sliding window of 9, as an explicit mask
        pos = np.arange(t)
        visible = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < 9)
        mask = np.where(visible, 0.0, np.finfo(np.float32).min).astype(np.float32)[None, None]
        j_kw["mask"], t_kw["mask"] = jnp.asarray(mask), _t(mask)
    ref = ja.prefill_attention(*(jnp.asarray(a) for a in (q, k, v)), **j_kw)
    launches = ta.flash_attention.launches
    got = ta.prefill_attention(_t(q), _t(k), _t(v), **t_kw)
    assert ta.flash_attention.launches == launches  # the plain version on the CPU
    _close(got, ref)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_shares_kv_heads(causal):
    """Unrepeated K/V heads (GQA) give what repeated ones give."""
    q, _, _ = _qkv(1, 6, 70, 16, seed=1)
    _, k, v = _qkv(1, 2, 70, 16, seed=2)
    got = ta.flash_attention(_t(q), _t(k), _t(v), causal, 0.2)
    rep = ta.flash_attention(_t(q), _t(k).repeat_interleave(3, 1), _t(v).repeat_interleave(3, 1),
                             causal, 0.2)
    ref = ja.prefill_attention(jnp.asarray(q), jnp.repeat(jnp.asarray(k), 3, 1),
                               jnp.repeat(jnp.asarray(v), 3, 1), causal=causal, scale=0.2)
    assert torch.equal(got, rep)
    _close(got, ref)
    assert ta.FLASH_MIN_SEQ == ja.FLASH_MIN_SEQ


@pytest.fixture(scope="module")
def models():
    jcfg = jl.LlamaConfig.tiny()
    params = jl.init_params(jcfg, jax.random.PRNGKey(3), dtype=jnp.float32)
    qparams = j_quantize_model(params, JConfig(nbits=4, group_size=32),
                               compute_dtype=jnp.float32)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, qparams), "cpu")
    return jcfg, qparams, tl.LlamaConfig.tiny(), tparams


@pytest.mark.parametrize("t,window", [(24, None), (300, None), (40, 8)])
def test_forward_nocache_logits_match(models, t, window):
    """cache=None against hqq_tpu's, and against the port's own dense-cache
    forward of the same tokens (T = 300 goes through `flash_attention`'s
    plain version, the window through the explicit mask)."""
    import dataclasses

    jcfg, jparams, tcfg, tparams = models
    if window is not None:
        jcfg = dataclasses.replace(jcfg, sliding_window=window)
        tcfg = dataclasses.replace(tcfg, sliding_window=window)
    tokens = np.random.default_rng(t).integers(0, jcfg.vocab_size, (2, t))
    ref, none = jl.forward(jparams, jcfg, jnp.asarray(tokens, jnp.int32))
    assert none is None
    with torch.no_grad():
        got, cache = tl.forward(tparams, tcfg, _t(tokens))
        dense, _ = tl.forward(tparams, tcfg, _t(tokens),
                              tl.init_cache(tcfg, 2, t + 8, torch.float32, "cpu"), 0)
    assert cache is None and got.dtype == torch.float32 and got.shape == (2, t, jcfg.vocab_size)
    _close(got, ref)
    _close(got, dense.numpy())


def test_loglikelihood_matches(models):
    jcfg, jparams, tcfg, tparams = models
    tokens = np.random.default_rng(5).integers(0, jcfg.vocab_size, (1, 50))
    ref = float(je.loglikelihood(jparams, jcfg, jnp.asarray(tokens, jnp.int32)))
    got = te.loglikelihood(tparams, tcfg, tokens, device="cpu")
    assert got.dtype == torch.float32 and not got.requires_grad
    np.testing.assert_allclose(float(got), ref, rtol=1e-4)


@pytest.mark.parametrize("n,max_length,stride", [
    (150, 64, 32),    # overlapping windows and a short last one
    (100, 64, 64),    # no overlap
    (40, 64, 32),     # one window shorter than max_length
    (700, 300, 200),  # windows of T = 299: `flash_attention`'s plain version
])
def test_perplexity_matches(models, n, max_length, stride):
    jcfg, jparams, tcfg, tparams = models
    ids = np.random.default_rng(n).integers(0, jcfg.vocab_size, n)
    ref = je.perplexity(jparams, jcfg, ids, max_length=max_length, stride=stride)
    got = te.perplexity(tparams, tcfg, ids, max_length=max_length, stride=stride, device="cpu")
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    assert np.isfinite(got) and got > 1.0


def test_perplexity_takes_a_forward_fn(models):
    """`forward_fn` replaces the model's forward, as in hqq_tpu."""
    _, _, tcfg, tparams = models
    ids = np.random.default_rng(9).integers(0, tcfg.vocab_size, 90)
    calls = []

    def fwd(params, cfg, tokens):
        calls.append(tuple(tokens.shape))
        return tl.forward(params, cfg, tokens)

    got = te.perplexity(tparams, tcfg, ids, max_length=32, stride=32, forward_fn=fwd,
                        device="cpu")
    assert calls == [(1, 31)] * 3
    np.testing.assert_allclose(
        got, te.perplexity(tparams, tcfg, ids, max_length=32, stride=32, device="cpu"), rtol=1e-6)
