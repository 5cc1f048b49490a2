# SPDX-License-Identifier: Apache-2.0
"""hqq_tpu_torch generation against hqq_tpu: greedy tokens of
HQQModel.generate are equal on the tiny model (4-bit g64, fp32 compute and
cache, the same weights carried across), for batch 2 and for batch 1 with a
prompt long enough that the prefill has M > 32 rows; EOS handling matches;
and sample_token picks the same token as hqq_tpu's when fed the Gumbel noise
that jax.random.gumbel draws for the same key and shape."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hqq_tpu.core.quantize import BaseQuantizeConfig as JConfig
from hqq_tpu.engine.hf import HQQModel as JModel
from hqq_tpu.models import llama as jl
from hqq_tpu.models import quantize_model as j_quantize_model
from hqq_tpu.serving import generate as jg
from hqq_tpu_torch.engine.hf import HQQModel as TModel
from hqq_tpu_torch.models import llama as tl
from hqq_tpu_torch.serving import generate as tg
from hqq_tpu_torch.utils import params_from_numpy


@pytest.fixture(scope="module")
def quantized():
    cfg = jl.LlamaConfig.tiny()
    params = jl.init_params(cfg, jax.random.PRNGKey(1), dtype=jnp.float32)
    return cfg, j_quantize_model(params, JConfig(nbits=4, group_size=64),
                                 compute_dtype=jnp.float32)


_PROMPTS = {
    "b2": [[1, 7, 3, 9, 11], [4, 5, 6, 200, 17]],
    # t = 40 -> t_pad = 64 rows: the prefill takes the M > 32 route
    "b1_long": [list(np.random.default_rng(3).integers(0, 256, size=40))],
}


@pytest.fixture(scope="module")
def generate_both(quantized):
    """(hqq_tpu's tokens, the port's tokens) for a backend and a prompt of
    _PROMPTS, each generated once per module."""
    cfg, qparams = quantized
    done = {}

    def run(backend, prompt, new, **kw):
        key = (backend, prompt, new, tuple(sorted(kw.items())))
        if key not in done:
            jm = JModel(params=qparams, cfg=cfg, quantized=True).prepare_for_inference(backend)
            ref = jm.generate(_PROMPTS[prompt], max_new_tokens=new, cache_dtype=jnp.float32, **kw)
            tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, qparams), "cpu")
            tm = TModel(params=tp, cfg=tl.LlamaConfig.tiny(),
                        quantized=True).prepare_for_inference(backend)
            got = tm.generate(_PROMPTS[prompt], max_new_tokens=new, cache_dtype=torch.float32,
                              **kw)
            done[key] = np.asarray(ref), np.asarray(got)
        return done[key]

    return run


@pytest.mark.parametrize("prompt", list(_PROMPTS))
@pytest.mark.parametrize("backend", ["xla", "w4a8"])
def test_greedy_tokens_equal(generate_both, backend, prompt):
    ref, got = generate_both(backend, prompt, 8)
    assert got.shape == ref.shape == (len(_PROMPTS[prompt]), 8)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("prompt", list(_PROMPTS))
def test_eos_handling_matches(generate_both, prompt):
    """Rows are forced to EOS after it; a batch of one is trimmed."""
    ref, _ = generate_both("xla", prompt, 8)
    eos = int(ref[0, 3])
    ref, got = generate_both("xla", prompt, 8, eos_token_id=eos)
    np.testing.assert_array_equal(got, ref)


def test_next_power_of_2():
    for n in (1, 2, 3, 9, 64, 100, 129):
        assert tg.next_power_of_2(n) == jg.next_power_of_2(n)


@pytest.mark.parametrize("top_k,temperature,top_p", [(5, 1.0, 1.0), (20, 0.6, 0.9),
                                                     (20, 1.3, 0.5)])
def test_sample_token_matches_jax_with_its_noise(top_k, temperature, top_p):
    logits = np.random.default_rng(top_k).standard_normal((6, 256)).astype(np.float32) * 3
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        ref = np.asarray(jg.sample_token(jnp.asarray(logits), key, True, top_k, temperature,
                                         top_p))
        noise = np.asarray(jax.random.gumbel(key, (6, top_k), jnp.float32))
        got = tg.sample_token(torch.from_numpy(logits), None, True, top_k, temperature, top_p,
                              gumbel=torch.from_numpy(noise.copy()))
        np.testing.assert_array_equal(got.numpy(), ref)
    greedy = tg.sample_token(torch.from_numpy(logits), None, False, top_k, temperature)
    np.testing.assert_array_equal(greedy.numpy(), logits.argmax(-1))


def test_sampled_generate_is_seeded(quantized):
    cfg, qparams = quantized
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, qparams), "cpu")
    tm = TModel(params=tp, cfg=tl.LlamaConfig.tiny(), quantized=True).prepare_for_inference("w4a8")
    kw = dict(max_new_tokens=6, do_sample=True, top_k=20, top_p=0.9, cache_dtype=torch.float32)
    a = tm.generate([[1, 2, 3]], seed=5, **kw)
    b = tm.generate([[1, 2, 3]], seed=5, **kw)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (1, 6) and a.min() >= 0 and a.max() < cfg.vocab_size
