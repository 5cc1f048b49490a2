# SPDX-License-Identifier: Apache-2.0
"""The RMSNorm families on the llama walk against hqq_tpu, on the CPU.

Mistral, Granite, Gemma, Gemma-2, Gemma-3, Phi-3 and OLMo-2, each on its
`tiny()` config with hqq_tpu's random fp32 weights carried across by
`params_from_numpy` (the embedding scaled by 100, so that greedy ids vary
where the head is not tied to it).
hqq_tpu runs once per family in a module fixture.

* Logits of 24 tokens against hqq_tpu's forward, dense, within 1e-5 of
  max|logits| (fp32; sums in another order, the norm's fixed order against
  XLA's); the cache-free path too.
* Cached decode (a 20-token prefill, then 4 one-token steps over the dense
  cache) against the full forward, within 1e-5.
* Greedy ids after quantization: the tree quantized by hqq_tpu (4-bit g32,
  fp32 compute) through `HQQModel.generate` equal to hqq_tpu's greedy loop
  over its forward; the port's own `quantize_model` on the family tree
  within 1e-2 of those logits (a code may differ in a rare rounding: the
  quantizers agree on > 0.999 of codes).
* The HF loader: a tiny HF directory written by the port's safetensors
  writer, read by `HQQModelForCausalLM.from_pretrained` (every family's
  ``model_type``), logits equal to hqq_tpu's on the same weights.
* Checkpoints: hqq_tpu's `save_quantized` read by the port's
  `from_quantized` and the port's read by hqq_tpu's, every tensor
  bit-equal and the config of the family's class (Gemma-3's
  ``layer_types`` a tuple again).
* Every one of the 16 model types served resolves to the port's modules.
* `fuse_for_decode` leaves an OLMo-2 layer unfused (its q and k are normed
  over their own projections): logits after equal logits before. Phi-3's
  native fused projections prepare to w4a8 at their own widths.
"""

import dataclasses
import importlib
import json
import os

import numpy as np
import pytest
import torch

from hqq_tpu_torch.core.quantize import BaseQuantizeConfig
from hqq_tpu_torch.engine.hf import HQQModel, HQQModelForCausalLM
from hqq_tpu_torch.models import llama as tl
from hqq_tpu_torch.models._safetensors import save_file
from hqq_tpu_torch.models.serialize import tree_to_state
from hqq_tpu_torch.utils import params_from_numpy

FAMILIES = ["mistral", "granite", "gemma", "gemma2", "gemma3", "phi3", "olmo2"]
_CONFIG = {"mistral": "MistralConfig", "granite": "GraniteConfig", "gemma": "GemmaConfig",
           "gemma2": "Gemma2Config", "gemma3": "Gemma3Config", "phi3": "Phi3Config",
           "olmo2": "Olmo2Config"}
_MODEL_TYPE = {f: f for f in FAMILIES} | {"gemma3": "gemma3_text"}
_T, _PREFILL, _NEW = 24, 20, 6
_PROMPT = [3, 17, 92, 41, 5, 77]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch ops on one thread: the suite's workers share the cores, and
    torch's intra-op threads would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _modules(family):
    return (importlib.import_module(f"hqq_tpu.models.{family}"),
            importlib.import_module(f"hqq_tpu_torch.models.{family}"))


def _jax_greedy(fwd, params, cfg, prompt, n_new):
    import jax.numpy as jnp

    from hqq_tpu.models import llama as jl

    cache = jl.init_cache(cfg, 1, 64, jnp.float32)
    logits, cache = fwd(params, cfg, jnp.asarray([prompt], jnp.int32), cache, 0)
    out = [int(jnp.argmax(logits[0, -1]))]
    for pos in range(len(prompt), len(prompt) + n_new - 1):
        logits, cache = fwd(params, cfg, jnp.asarray([[out[-1]]], jnp.int32), cache, pos)
        out.append(int(jnp.argmax(logits[0, -1])))
    return out


@pytest.fixture(scope="module")
def ref():
    """Per family: both configs, the fp32 and hqq_tpu-quantized trees (numpy
    and the port's), hqq_tpu's logits (dense and cache-free) and greedy ids
    of the quantized tree."""
    import jax
    import jax.numpy as jnp

    from hqq_tpu.core.quantize import BaseQuantizeConfig
    from hqq_tpu.models import quantize_model

    toks = np.random.default_rng(0).integers(0, 256, (2, _T)).astype(np.int32)
    out = {}
    for i, family in enumerate(FAMILIES):
        jm, tm = _modules(family)
        jcfg = getattr(jm, _CONFIG[family]).tiny()
        tcfg = getattr(tm, _CONFIG[family])(**dataclasses.asdict(jcfg))
        params = jm.init_params(jcfg, jax.random.PRNGKey(i), dtype=jnp.float32)
        params = dict(params, embed_tokens=params["embed_tokens"] * 100.0)
        jq = quantize_model(params, BaseQuantizeConfig(nbits=4, group_size=32),
                            compute_dtype=jnp.float32)
        from hqq_tpu.models import llama as jl

        jcache = jl.init_cache(jcfg, 2, 32, jnp.float32)
        np_tree = jax.tree_util.tree_map(np.asarray, params)
        np_q = jax.tree_util.tree_map(np.asarray, jq)
        out[family] = dict(
            jcfg=jcfg, tcfg=tcfg, jq=jq, np_tree=np_tree, np_q=np_q,
            tree=params_from_numpy(np_tree, "cpu"), qtree=params_from_numpy(np_q, "cpu"),
            logits=np.asarray(jm.forward(params, jcfg, jnp.asarray(toks), jcache, 0)[0]),
            nocache=np.asarray(jm.forward(params, jcfg, jnp.asarray(toks))[0]),
            qlogits=np.asarray(jm.forward(jq, jcfg, jnp.asarray([_PROMPT], jnp.int32))[0]),
            greedy=_jax_greedy(jm.forward, jq, jcfg, _PROMPT, _NEW))
    return dict(toks=toks, families=out)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("family", FAMILIES)
def test_logits_against_hqq_tpu(ref, family):
    r, (_, tm) = ref["families"][family], _modules(family)
    toks = torch.from_numpy(ref["toks"]).long()
    cache = tl.init_cache(r["tcfg"], 2, 32, torch.float32, "cpu")
    logits, _ = tm.forward(r["tree"], r["tcfg"], toks, cache, 0)
    assert _rel(logits.numpy(), r["logits"]) <= 1e-5
    nocache, _ = tm.forward(r["tree"], r["tcfg"], toks)
    assert _rel(nocache.numpy(), r["nocache"]) <= 1e-5


@pytest.mark.parametrize("family", FAMILIES)
def test_cached_decode_equals_forward(ref, family):
    r, (_, tm) = ref["families"][family], _modules(family)
    toks = torch.from_numpy(ref["toks"]).long()
    full, _ = tm.forward(r["tree"], r["tcfg"], toks)
    cache = tl.init_cache(r["tcfg"], 2, 32, torch.float32, "cpu")
    got = [tm.forward(r["tree"], r["tcfg"], toks[:, :_PREFILL], cache, 0)[0]]
    got += [tm.forward(r["tree"], r["tcfg"], toks[:, i:i + 1], cache, i)[0]
            for i in range(_PREFILL, _T)]
    assert _rel(torch.cat(got, dim=1).numpy(), full.numpy()) <= 1e-5


@pytest.mark.parametrize("family", FAMILIES)
def test_greedy_after_quantize(ref, family):
    r = ref["families"][family]
    model = HQQModel(r["qtree"], r["tcfg"], _MODEL_TYPE[family], quantized=True)
    ids = model.generate(np.asarray([_PROMPT]), max_new_tokens=_NEW, compile_mode="partial",
                         cache_dtype=torch.float32, device="cpu")
    assert ids[0].tolist() == r["greedy"]
    if not r["tcfg"].tie_word_embeddings:  # a tied head keeps echoing the large embedding
        assert len(set(r["greedy"])) > 1

    own = HQQModel(params_from_numpy(r["np_tree"], "cpu"), r["tcfg"], _MODEL_TYPE[family])
    own.quantize_model(BaseQuantizeConfig(nbits=4, group_size=32), compute_dtype=torch.float32)
    logits, _ = own.forward(torch.tensor([_PROMPT]))
    assert _rel(logits.numpy(), r["qlogits"]) <= 1e-2


def _hf_state(tree, family) -> dict:
    """The tree under HF's names (OLMo-2's flat q/k norms as q_norm/k_norm)."""
    state = {"model.embed_tokens.weight": tree["embed_tokens"], "model.norm.weight": tree["norm"]}
    if "lm_head" in tree:
        state["lm_head.weight"] = tree["lm_head"].weight
    for i, layer in enumerate(tree["layers"]):
        for key, node in layer.items():
            items = node.items() if isinstance(node, dict) else [(None, node)]
            for sub, leaf in items:
                name = f"model.layers.{i}.{key}" + (f".{sub}" if sub else "")
                name = name.replace("q_norm_flat", "q_norm").replace("k_norm_flat", "k_norm")
                if hasattr(leaf, "weight"):
                    state[name + ".weight"] = leaf.weight
                    if leaf.bias is not None:
                        state[name + ".bias"] = leaf.bias
                else:
                    state[name + ".weight"] = leaf
    return {k: v.detach().contiguous() for k, v in state.items()}


def _hf_config(cfg, family) -> dict:
    out = {k: v for k, v in dataclasses.asdict(cfg).items() if v is not None}
    out["model_type"] = _MODEL_TYPE[family]
    if out.get("rope_scaling") is None:
        out.pop("rope_scaling", None)
    if "layer_types" in out:
        out["layer_types"] = list(out["layer_types"])
    return out


@pytest.mark.parametrize("family", FAMILIES)
def test_hf_loader(ref, family, tmp_path):
    r = ref["families"][family]
    save_file(_hf_state(r["tree"], family), str(tmp_path / "model.safetensors"))
    with open(tmp_path / "config.json", "w") as f:
        json.dump(_hf_config(r["tcfg"], family), f)
    model = HQQModelForCausalLM.from_pretrained(str(tmp_path), compute_dtype=torch.float32,
                                                device="cpu")
    assert type(model.cfg) is type(r["tcfg"]) and model.cfg == r["tcfg"]
    cache = tl.init_cache(model.cfg, 2, 32, torch.float32, "cpu")
    logits, _ = model.forward(torch.from_numpy(ref["toks"]).long(), cache, 0)
    assert _rel(logits.numpy(), r["logits"]) <= 1e-5


def _leaves(tree):
    return tree_to_state(tree)[0]


@pytest.mark.parametrize("family", FAMILIES)
def test_checkpoints_both_ways(ref, family, tmp_path):
    import jax

    from hqq_tpu.engine import hf as jhf

    r = ref["families"][family]
    jhf.HQQModel(r["jq"], r["jcfg"], _MODEL_TYPE[family], quantized=True).save_quantized(
        str(tmp_path / "jax"))
    mine = HQQModelForCausalLM.from_quantized(str(tmp_path / "jax"), device="cpu")
    assert type(mine.cfg) is type(r["tcfg"]) and mine.cfg == r["tcfg"]
    want = _leaves(r["qtree"])
    got = _leaves(mine.params)
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)

    mine.save_quantized(str(tmp_path / "port"))
    back = jhf.HQQModelForCausalLM.from_quantized(str(tmp_path / "port"))
    assert back.cfg == r["jcfg"]
    jw = jax.tree_util.tree_leaves(r["jq"])
    jb = jax.tree_util.tree_leaves(back.params)
    assert len(jw) == len(jb)
    assert all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(jw, jb))


def test_gemma3_layer_types_round_trip(tmp_path):
    from hqq_tpu_torch.models.gemma3 import Gemma3Config

    cfg = Gemma3Config.tiny()
    back = Gemma3Config(**json.loads(json.dumps(dataclasses.asdict(cfg))))
    assert back == cfg and isinstance(back.layer_types, tuple) and hash(back) == hash(cfg)
    assert [back.layer_is_sliding(i) for i in range(2)] == [True, False]
    assert [Gemma3Config(num_hidden_layers=12).layer_is_sliding(i) for i in range(12)] == (
        [True] * 5 + [False] + [True] * 5 + [False])


def test_fuse_for_decode_leaves_olmo2_unfused(ref):
    from hqq_tpu_torch.utils.patching import fuse_for_decode

    r = ref["families"]["olmo2"]
    toks = torch.from_numpy(ref["toks"]).long()
    before, _ = _modules("olmo2")[1].forward(r["tree"], r["tcfg"], toks)
    fused = fuse_for_decode(r["tree"])
    assert all("q_proj" in layer["self_attn"] and "qkv_proj" not in layer["self_attn"]
               for layer in fused["layers"])
    after, _ = _modules("olmo2")[1].forward(fused, r["tcfg"], toks)
    assert torch.equal(after, before)
    # the families without flat norms do fuse
    g = fuse_for_decode(ref["families"]["gemma2"]["tree"])
    assert all("qkv_proj" in layer["self_attn"] for layer in g["layers"])


def test_phi3_fused_layers_prepare_to_w4a8(ref):
    from hqq_tpu_torch.backends.pallas_backend import A8QuantLinear
    from hqq_tpu_torch.utils.patching import prepare_for_inference

    r = ref["families"]["phi3"]
    tree = params_from_numpy(r["np_q"], "cpu")
    cfg = r["tcfg"]
    prepared = prepare_for_inference(tree, "w4a8")
    layer = prepared["layers"][0]
    qkv, gate_up = layer["self_attn"]["qkv_proj"], layer["mlp"]["gate_up_proj"]
    nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_
    assert isinstance(qkv, A8QuantLinear) and isinstance(gate_up, A8QuantLinear)
    assert qkv.out_features == (nh + 2 * nkv) * hd
    assert gate_up.out_features == 2 * cfg.intermediate_size
    toks = torch.tensor([_PROMPT])
    want, _ = _modules("phi3")[1].forward(r["qtree"], cfg, toks)
    got, _ = _modules("phi3")[1].forward(prepared, cfg, toks)
    assert _rel(got.numpy(), want.numpy()) <= 2e-2


def test_every_model_type_resolves_to_the_port():
    """The 20 model types served: llama, Qwen2/3, the seven RMSNorm
    families, the six LayerNorm families and the four MoE families
    (DeepSeek-V3 as ``deepseek_v3``, its HF model type), each to a config
    class, forward and loader of hqq_tpu_torch; a type outside the registry
    is refused."""
    from hqq_tpu_torch.engine.hf import _HQQ_REGISTRY, _lookup_arch

    types = ["llama", "qwen2", "qwen3", *_MODEL_TYPE.values(), "starcoder2", "phi", "cohere",
             "gpt2", "bloom", "falcon", "mixtral", "qwen3_moe", "gpt_oss", "deepseek_v3"]
    assert len(set(types)) == 20 and set(types) <= set(_HQQ_REGISTRY)
    for model_type in types:
        arch = _lookup_arch(model_type)
        for part in ("config_cls", "forward", "loader"):
            assert arch[part].__module__.startswith("hqq_tpu_torch."), (model_type, part)
    with pytest.raises(ValueError, match="deepseek3"):
        _lookup_arch("deepseek3")


def test_phi3_refuses_longrope():
    from hqq_tpu_torch.models.phi3 import Phi3Config

    hf = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=1,
              num_attention_heads=4, rope_scaling={"type": "longrope", "short_factor": [1.0]})
    with pytest.raises(ValueError, match="LongRoPE"):
        Phi3Config.from_hf(hf)


def test_no_port_module_sums_in_fp64():
    root = os.path.join(os.path.dirname(__file__), "..", "hqq_tpu_torch", "models")
    for name in os.listdir(root):
        if name.endswith(".py") and name != "_safetensors.py":
            with open(os.path.join(root, name)) as f:
                assert "float64" not in f.read(), name
