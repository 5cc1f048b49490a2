# SPDX-License-Identifier: Apache-2.0
"""hqq_tpu_torch.models.llama.forward against hqq_tpu.models.llama.forward:
LlamaConfig.tiny() in fp32, 4-bit g64 weights quantized by hqq_tpu and
carried across with params_from_numpy, a prefill of 8 tokens then 3 decode
steps over the dense cache, under each backend.

Tolerance: 1e-5 of max|logit| for every backend, fp32 sums in another
order (the readings are 3e-7 to 1.1e-6). Under "w4a8" all of these rows
(M = 16, then 2) quantize activations to int8. Weights from PRNGKey(11):
on these inputs no activation of the 56 int8 quantizations lies within 21
fp32 ulps of a rounding tie, so both sides round every one the same way.
One flipped rounding (PRNGKey(1) has one) moves the logits by about 7e-3
of max|logit|; skipping the int8 step (w4a8 against xla) by 2.5e-2 to
4.4e-2 over PRNGKeys 1-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hqq_tpu.core.quantize import BaseQuantizeConfig as JConfig
from hqq_tpu.models import llama as jl
from hqq_tpu.models import quantize_model as j_quantize_model
from hqq_tpu.utils.patching import prepare_for_inference as j_prepare
from hqq_tpu_torch.models import llama as tl
from hqq_tpu_torch.utils import params_from_numpy
from hqq_tpu_torch.utils.patching import prepare_for_inference as t_prepare

_TOL = 1e-5
# one compile for the prefill and one for the decode steps (start_pos traced)
_j_forward = jax.jit(jl.forward, static_argnums=(1,))


@pytest.fixture(scope="module")
def quantized():
    cfg = jl.LlamaConfig.tiny()
    params = jl.init_params(cfg, jax.random.PRNGKey(11), dtype=jnp.float32)
    return cfg, j_quantize_model(params, JConfig(nbits=4, group_size=64),
                                 compute_dtype=jnp.float32)


def test_config_matches_jax():
    for name in ("tiny", "llama2_7b", "llama2_13b", "llama2_70b", "llama3_8b"):
        jc, tc = getattr(jl.LlamaConfig, name)(), getattr(tl.LlamaConfig, name)()
        assert jc.__dict__ == tc.__dict__
    hf = {"vocab_size": 128, "hidden_size": 64, "intermediate_size": 128,
          "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
          "rope_scaling": {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                           "high_freq_factor": 4.0, "original_max_position_embeddings": 64}}
    assert jl.LlamaConfig.from_hf(hf).__dict__ == tl.LlamaConfig.from_hf(hf).__dict__


@pytest.mark.parametrize("scaling", [
    None,
    {"rope_type": "linear", "factor": 2.0},
    {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
     "original_max_position_embeddings": 64},
    {"rope_type": "yarn", "factor": 4.0, "original_max_position_embeddings": 64},
])
def test_rope_and_mask_match_jax(scaling):
    jc = jl.LlamaConfig(hidden_size=128, num_attention_heads=2, rope_scaling=scaling)
    tc = tl.LlamaConfig(hidden_size=128, num_attention_heads=2, rope_scaling=scaling)
    _, jcos, jsin, jmask = jl.positions_and_masks(jc, 5, 7, 16)
    _, tcos, tsin, tmask = tl.positions_and_masks(tc, 5, 7, 16, device="cpu")
    np.testing.assert_allclose(tcos.numpy(), np.asarray(jcos), rtol=0, atol=2e-6)
    np.testing.assert_allclose(tsin.numpy(), np.asarray(jsin), rtol=0, atol=2e-6)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))


def test_cache_update_is_in_place():
    cfg = tl.LlamaConfig.tiny()
    cache = tl.init_cache(cfg, 2, 16, torch.float32, "cpu")
    k_ptr = cache.k.data_ptr()
    k = torch.randn(2, cfg.num_key_value_heads, 3, cfg.head_dim_)
    tl._update_stacked_cache(cache.k, cache.v, 1, k, -k, 5)
    assert cache.k.data_ptr() == k_ptr
    torch.testing.assert_close(cache.k[1, :, :, 5:8], k)
    torch.testing.assert_close(cache.v[1, :, :, 5:8], -k)
    assert cache.k[0].abs().sum() == 0 and cache.k[1, :, :, :5].abs().sum() == 0


@pytest.mark.parametrize("backend", ["xla", "pallas", "w4a8"])
def test_forward_matches_jax(quantized, backend):
    cfg, qparams = quantized
    tcfg = tl.LlamaConfig.tiny()
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(2, 8))

    jp = j_prepare(qparams, backend)
    cache = jl.init_cache(cfg, 2, 16, jnp.float32)
    logits, cache = _j_forward(jp, cfg, jnp.asarray(toks), cache, jnp.int32(0))
    ref = [np.asarray(logits)]
    steps = [np.asarray(logits[:, -1]).argmax(-1)]
    for s in range(3):
        logits, cache = _j_forward(jp, cfg, jnp.asarray(steps[-1][:, None]), cache,
                                   jnp.int32(8 + s))
        ref.append(np.asarray(logits))
        steps.append(np.asarray(logits[:, -1]).argmax(-1))

    tp = t_prepare(params_from_numpy(jax.tree_util.tree_map(np.asarray, qparams), "cpu"), backend)
    tcache = tl.init_cache(tcfg, 2, 16, torch.float32, "cpu")
    got = []
    with torch.inference_mode():
        tlog, tcache = tl.forward(tp, tcfg, torch.from_numpy(toks), tcache, 0)
        got.append(tlog.numpy())
        for s in range(3):  # the same decode tokens on both sides
            tok = torch.from_numpy(steps[s][:, None])
            tlog, tcache = tl.forward(tp, tcfg, tok, tcache, 8 + s)
            got.append(tlog.numpy())

    for r, g in zip(ref, got):
        assert g.shape == r.shape and np.isfinite(g).all()
        assert np.abs(g - r).max() / np.abs(r).max() < _TOL
