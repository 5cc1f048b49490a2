# SPDX-License-Identifier: Apache-2.0
"""hqq_tpu_torch's Hugging Face loading against hqq_tpu's, and the README
quick start in both packages. Tiny HF directories are built here with the
installed transformers (`save_pretrained`, one file and sharded), nothing
downloaded. The port's `from_pretrained` gives hqq_tpu's tensors bit for
bit at fp32 and its logits within 1e-5 (and those of transformers' own
model within 1e-4); from_pretrained -> quantize_model -> save_quantized ->
from_quantized -> prepare_for_inference("w4a8") -> generate gives hqq_tpu's
greedy ids."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hqq_tpu.core.quantize import BaseQuantizeConfig as JConfig
from hqq_tpu.engine.hf import HQQModelForCausalLM as JForCausalLM
from hqq_tpu.models import serialize as js
from hqq_tpu_torch import BaseQuantizeConfig
from hqq_tpu_torch.engine.hf import AutoHQQHFModel, HQQModelForCausalLM
from hqq_tpu_torch.models import hf as thf
from hqq_tpu_torch.models import serialize as ts

transformers = pytest.importorskip("transformers")

_SIZES = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256)
_TOKENS = [[3, 17, 29, 5, 81, 200, 7, 1], [9, 2, 44, 61, 8, 130, 250, 12]]


def _hf_dir(root, family: str, sharded: bool) -> str:
    """A tiny HF checkpoint of ``family`` (fp32 weights from seed 0)."""
    path = os.path.join(root, f"{family}-{'sharded' if sharded else 'single'}")
    torch.manual_seed(0)
    if family == "llama":
        cfg = transformers.LlamaConfig(**_SIZES)
        model = transformers.LlamaForCausalLM(cfg)
    else:  # Qwen3: per-head q/k norms, head_dim given
        cfg = transformers.Qwen3Config(**_SIZES, head_dim=16)
        model = transformers.Qwen3ForCausalLM(cfg)
    with torch.no_grad():  # norms away from 1, so that a missing one shows
        for name, p in model.named_parameters():
            if "norm" in name:
                p.add_(torch.rand_like(p) * 0.5)
    model.save_pretrained(path, max_shard_size="60KB" if sharded else "1GB")
    return path


@pytest.fixture(scope="module")
def hf_root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("hf"))


@pytest.mark.parametrize("family,sharded", [("llama", False), ("llama", True),
                                            ("qwen3", True)])
def test_from_pretrained_matches_hqq_tpu(hf_root, family, sharded):
    path = _hf_dir(hf_root, family, sharded)
    assert os.path.exists(os.path.join(path, "model.safetensors.index.json")) == sharded
    ref = JForCausalLM.from_pretrained(path, compute_dtype=jnp.float32)
    got = HQQModelForCausalLM.from_pretrained(path, compute_dtype=torch.float32, device="cpu")
    assert got.model_type == ref.model_type == family
    jflat, jstruct = js.tree_to_state(jax.tree_util.tree_map(lambda x: x, ref.params))
    tflat, tstruct = ts.tree_to_state(got.params)
    assert json.loads(json.dumps(tstruct)) == json.loads(json.dumps(jstruct))
    assert sorted(jflat) == sorted(tflat)
    for k in jflat:
        assert np.array_equal(np.asarray(jflat[k]), tflat[k].numpy()), k
    if family == "qwen3":
        assert "q_norm" in got.params["layers"][0]["self_attn"]

    toks = np.asarray(_TOKENS)
    ref_logits, _ = ref.forward(jnp.asarray(toks))
    got_logits, _ = got.forward(torch.from_numpy(toks))
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(ref_logits), rtol=0, atol=1e-5)
    hf_model = transformers.AutoModelForCausalLM.from_pretrained(path, dtype=torch.float32)
    with torch.no_grad():
        hf_logits = hf_model(torch.from_numpy(toks)).logits
    np.testing.assert_allclose(got_logits.numpy(), hf_logits.numpy(), rtol=0, atol=1e-4)


def test_load_hf_llama_and_shards(hf_root):
    """`load_hf_llama` (bf16 by default) and `_iter_hf_shards` with and
    without the index."""
    single = _hf_dir(hf_root, "llama", False)
    sharded = _hf_dir(hf_root, "llama", True)
    names = [sorted(s) for s in thf._iter_hf_shards(sharded)]
    assert len(names) > 1 and len({n for s in names for n in s}) == sum(map(len, names))
    (one,) = [dict(s) for s in thf._iter_hf_shards(single)]
    merged = {k: v for s in thf._iter_hf_shards(sharded) for k, v in s.items()}
    assert sorted(one) == sorted(merged)
    for k in one:
        assert torch.equal(one[k], merged[k]), k
    params, cfg = thf.load_hf_llama(sharded, device="cpu")
    assert cfg == thf.read_hf_config(single)
    assert params["embed_tokens"].dtype == torch.bfloat16
    assert torch.equal(params["embed_tokens"], one["model.embed_tokens.weight"].bfloat16())


def test_quick_start_matches_hqq_tpu(hf_root, tmp_path):
    """The README workflow in both packages, each quantizing on its own:
    the same greedy ids."""
    path = _hf_dir(hf_root, "llama", True)
    prompts = [[1, 7, 3, 9, 11], [4, 5, 6, 200, 17]]

    ref = JForCausalLM.from_pretrained(path, compute_dtype=jnp.float32)
    ref.quantize_model(JConfig(nbits=4, group_size=64), compute_dtype=jnp.float32)
    ref.save_quantized(str(tmp_path / "ref"))
    ref = JForCausalLM.from_quantized(str(tmp_path / "ref")).prepare_for_inference("w4a8")
    ref_ids = np.asarray(ref.generate(prompts, max_new_tokens=8, cache_dtype=jnp.float32))

    model = AutoHQQHFModel.from_pretrained(path, compute_dtype=torch.float32, device="cpu")
    HQQModelForCausalLM.quantize_model_(model, BaseQuantizeConfig(nbits=4, group_size=64),
                                        compute_dtype=torch.float32)
    HQQModelForCausalLM.save_quantized_(model, str(tmp_path / "port"))
    model = HQQModelForCausalLM.from_quantized(str(tmp_path / "port"), device="cpu")
    model.prepare_for_inference("w4a8")
    ids = model.generate(prompts, max_new_tokens=8, cache_dtype=torch.float32)
    assert ids.shape == (2, 8)
    np.testing.assert_array_equal(ids, ref_ids)


def test_save_needs_a_quantized_model(hf_root, tmp_path):
    model = HQQModelForCausalLM.from_pretrained(_hf_dir(hf_root, "llama", False),
                                                device="cpu")
    with pytest.raises(RuntimeError, match="quantize_model"):
        model.save_quantized(str(tmp_path))
    model.quantize_model(BaseQuantizeConfig(nbits=4, group_size=64))
    model.prepare_for_inference("w4a8")
    with pytest.raises(TypeError, match="prepare_for_inference"):
        model.save_quantized(str(tmp_path))


def test_unknown_architecture_refused(tmp_path):
    with open(tmp_path / "config.json", "w") as f:
        json.dump({"model_type": "not_a_model", **_SIZES}, f)
    with pytest.raises(ValueError, match="not supported"):
        HQQModelForCausalLM.from_pretrained(str(tmp_path), device="cpu")
