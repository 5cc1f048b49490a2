# SPDX-License-Identifier: Apache-2.0
"""The LayerNorm families against hqq_tpu, on the CPU.

StarCoder2, Phi (Phi-2), Cohere, GPT-2, BLOOM and Falcon on their `tiny()`
configs, with three more block variants: Falcon-RW (ALiBi, sequential
blocks, biases), Falcon's new decoder architecture (grouped q/k/v, two
norms) and BLOOM with ``apply_residual_connection_post_layernorm``.
hqq_tpu's random fp32 weights, every bias and norm weight drawn anew (init
leaves them 0 and 1, which would hide a bias or a weight dropped), are
carried across by `params_from_numpy`. hqq_tpu runs once per case in a
module fixture.

* Logits of 24 tokens against hqq_tpu's forward over the dense cache,
  within 1e-5 of max|logits| (fp32; the LayerNorm kernel's fixed order
  against XLA's sums), and cache-free too.
* Cached decode (a 20-token prefill, then 4 one-token steps) against the
  full forward, within 1e-5.
* Greedy ids after quantization: hqq_tpu's quantized tree (4-bit g32,
  fp32 compute) through `HQQModel.generate` equal to hqq_tpu's greedy loop;
  the port's own `quantize_model` within 1e-2 of those logits.
* ALiBi at per-slot positions (BLOOM, Falcon-RW): a decode step whose two
  slots sit at other positions (a [B] ``start_pos``), against hqq_tpu's.
* The HF loader: a tiny HF directory under each family's HF names (GPT-2's
  Conv1D weights stored [in, out], BLOOM's and Falcon's fused
  ``query_key_value`` as they are) read by `from_pretrained`, logits
  against hqq_tpu's on the same weights.
* Checkpoints both ways, every tensor bit-equal.
* The two faults of hqq_tpu kept out of the port: Phi-2 after
  `fuse_for_decode` (hqq_tpu's forward raises KeyError 'q_proj'; the
  port's reads ``qkv_proj``, logits bit-equal to the unfused tree's under
  w4a8), and int8 KV pools handed to a family whose attention reads float
  pools only (hqq_tpu writes bf16 K/V into them and drops the scales; the
  port's engine and server refuse with a ValueError naming the family,
  and StarCoder2, on llama's attention, reads them).
* GPT-2's learned positions bound the cache: a longer one is refused.
"""

import dataclasses
import importlib
import json

import numpy as np
import pytest
import torch

from hqq_tpu_torch.core.quantize import BaseQuantizeConfig
from hqq_tpu_torch.engine.hf import HQQModel, HQQModelForCausalLM
from hqq_tpu_torch.models import llama as tl
from hqq_tpu_torch.models._safetensors import save_file
from hqq_tpu_torch.models.serialize import tree_to_state
from hqq_tpu_torch.utils import params_from_numpy

# case -> (module, config class, tiny() overrides, model_type)
CASES = {
    "starcoder2": ("starcoder2", "Starcoder2Config", {}, "starcoder2"),
    "phi": ("phi", "PhiConfig", {}, "phi"),
    "cohere": ("cohere", "CohereConfig", {}, "cohere"),
    "gpt2": ("gpt2", "GPT2Config", {}, "gpt2"),
    "bloom": ("bloom", "BloomConfig", {}, "bloom"),
    "falcon": ("falcon", "FalconConfig", {}, "falcon"),
    "falcon_rw": ("falcon", "FalconConfig",
                  dict(alibi=True, multi_query=False, parallel_attn=False, bias=True), "falcon"),
    "falcon_new": ("falcon", "FalconConfig", dict(new_decoder_architecture=True, num_kv_heads=2),
                   "falcon"),
    "bloom_post": ("bloom", "BloomConfig", dict(apply_residual_connection_post_layernorm=True),
                   "bloom"),
}
ALIBI = ["bloom", "falcon_rw"]
FLOAT_POOLS_ONLY = ["phi", "cohere", "gpt2", "bloom", "falcon"]
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


def _modules(case):
    mod = CASES[case][0]
    return (importlib.import_module(f"hqq_tpu.models.{mod}"),
            importlib.import_module(f"hqq_tpu_torch.models.{mod}"))


def _perturbed(tree, seed: int):
    """Every bias N(0, 0.1^2) and every norm weight 1 + N(0, 0.1^2), numpy
    draws into hqq_tpu's tree."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = np.shape(leaf)
        if name.endswith("bias"):
            return jnp.asarray(rng.standard_normal(shape).astype(np.float32) * 0.1)
        if ("norm" in name or "['ln" in name) and not name.endswith(".weight"):
            return jnp.asarray((1 + rng.standard_normal(shape) * 0.1).astype(np.float32))
        return leaf

    return jax.tree_util.tree_map_with_path(draw, tree)


def _jax_greedy(jm, params, cfg, prompt, n_new):
    import jax.numpy as jnp

    cache = jm.init_cache(cfg, 1, 64, jnp.float32)
    logits, cache = jm.forward(params, cfg, jnp.asarray([prompt], jnp.int32), cache, 0)
    out = [int(jnp.argmax(logits[0, -1]))]
    for pos in range(len(prompt), len(prompt) + n_new - 1):
        logits, cache = jm.forward(params, cfg, jnp.asarray([[out[-1]]], jnp.int32), cache, pos)
        out.append(int(jnp.argmax(logits[0, -1])))
    return out


def _jax_slots(jm, params, cfg, toks):
    """A 16-token prefill of both slots, then one step with slot 0 at
    position 16 and slot 1 back at 12."""
    import jax.numpy as jnp

    cache = jm.init_cache(cfg, 2, 32, jnp.float32)
    _, cache = jm.forward(params, cfg, jnp.asarray(toks[:, :16]), cache, 0)
    pos = jnp.asarray([16, 12], jnp.int32)
    return np.asarray(jm.forward(params, cfg, jnp.asarray(toks[:, 16:17]), cache, pos)[0])


@pytest.fixture(scope="module")
def ref():
    """Per case: both configs, the fp32 and hqq_tpu-quantized trees (numpy
    and the port's), hqq_tpu's logits (dense, cache-free, per-slot) and
    greedy ids of the quantized tree."""
    import jax
    import jax.numpy as jnp

    from hqq_tpu.core.quantize import BaseQuantizeConfig as JConfig
    from hqq_tpu.models import quantize_model

    toks = np.random.default_rng(0).integers(0, 256, (2, _T)).astype(np.int32)
    out = {}
    for i, case in enumerate(CASES):
        jm, tm = _modules(case)
        _, cls, kw, _ = CASES[case]
        jcfg = getattr(jm, cls).tiny(**kw)
        tcfg = getattr(tm, cls)(**dataclasses.asdict(jcfg))
        params = _perturbed(jm.init_params(jcfg, jax.random.PRNGKey(i), dtype=jnp.float32), i)
        jq = quantize_model(params, JConfig(nbits=4, group_size=32), compute_dtype=jnp.float32)
        np_tree = jax.tree_util.tree_map(np.asarray, params)
        np_q = jax.tree_util.tree_map(np.asarray, jq)
        jcache = jm.init_cache(jcfg, 2, 32, jnp.float32)
        out[case] = dict(
            jcfg=jcfg, tcfg=tcfg, jq=jq, np_tree=np_tree, np_q=np_q,
            tree=params_from_numpy(np_tree, "cpu"), qtree=params_from_numpy(np_q, "cpu"),
            logits=np.asarray(jm.forward(params, jcfg, jnp.asarray(toks), jcache, 0)[0]),
            nocache=np.asarray(jm.forward(params, jcfg, jnp.asarray(toks))[0]),
            qlogits=np.asarray(jm.forward(jq, jcfg, jnp.asarray([_PROMPT], jnp.int32))[0]),
            greedy=_jax_greedy(jm, jq, jcfg, _PROMPT, _NEW),
            slots=_jax_slots(jm, params, jcfg, toks) if case in ALIBI else None)
    return dict(toks=toks, cases=out)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _cache(cfg, b=2, n=32, quantize_kv=False):
    return tl.init_cache(cfg, b, n, torch.float32, "cpu", quantize_kv=quantize_kv)


@pytest.mark.parametrize("case", CASES)
def test_logits_against_hqq_tpu(ref, case):
    r, tm = ref["cases"][case], _modules(case)[1]
    toks = torch.from_numpy(ref["toks"]).long()
    logits, _ = tm.forward(r["tree"], r["tcfg"], toks, _cache(r["tcfg"]), 0)
    assert _rel(logits.numpy(), r["logits"]) <= 1e-5
    nocache, _ = tm.forward(r["tree"], r["tcfg"], toks)
    assert _rel(nocache.numpy(), r["nocache"]) <= 1e-5


@pytest.mark.parametrize("case", CASES)
def test_cached_decode_equals_forward(ref, case):
    r, tm = ref["cases"][case], _modules(case)[1]
    toks = torch.from_numpy(ref["toks"]).long()
    full, _ = tm.forward(r["tree"], r["tcfg"], toks)
    cache = _cache(r["tcfg"])
    got = [tm.forward(r["tree"], r["tcfg"], toks[:, :_PREFILL], cache, 0)[0]]
    got += [tm.forward(r["tree"], r["tcfg"], toks[:, i:i + 1], cache, i)[0]
            for i in range(_PREFILL, _T)]
    assert _rel(torch.cat(got, dim=1).numpy(), full.numpy()) <= 1e-5


@pytest.mark.parametrize("case", CASES)
def test_greedy_after_quantize(ref, case):
    r = ref["cases"][case]
    model_type = CASES[case][3]
    model = HQQModel(r["qtree"], r["tcfg"], model_type, quantized=True)
    ids = model.generate(np.asarray([_PROMPT]), max_new_tokens=_NEW, compile_mode="partial",
                         cache_dtype=torch.float32, device="cpu")
    assert ids[0].tolist() == r["greedy"]

    own = HQQModel(params_from_numpy(r["np_tree"], "cpu"), r["tcfg"], model_type)
    own.quantize_model(BaseQuantizeConfig(nbits=4, group_size=32), compute_dtype=torch.float32)
    logits, _ = own.forward(torch.tensor([_PROMPT]))
    assert _rel(logits.numpy(), r["qlogits"]) <= 1e-2


@pytest.mark.parametrize("case", ALIBI)
def test_alibi_at_per_slot_positions(ref, case):
    r, tm = ref["cases"][case], _modules(case)[1]
    toks = torch.from_numpy(ref["toks"]).long()
    cache = _cache(r["tcfg"])
    tm.forward(r["tree"], r["tcfg"], toks[:, :16], cache, 0)
    got, _ = tm.forward(r["tree"], r["tcfg"], toks[:, 16:17], cache, torch.tensor([16, 12]))
    assert _rel(got.numpy(), r["slots"]) <= 1e-5


# the HF names: the tree's path prefix and renames, per module
_HF = {
    "starcoder2": ("model.", {}),
    "phi": ("model.", {}),
    "cohere": ("model.", {}),
    "gpt2": ("transformer.", {"layers": "h"}),
    "bloom": ("transformer.", {"layers": "h", "self_attn": "self_attention"}),
    "falcon": ("transformer.", {"layers": "h", "self_attn": "self_attention"}),
}


def _hf_state(tree, module: str) -> dict:
    """The tree under HF's names: linears and LayerNorms as .weight/.bias,
    bare arrays (embeddings, Cohere's norms) as .weight; GPT-2's Conv1D
    weights transposed to HF's [in, out]."""
    prefix, renames = _HF[module]
    state = {}

    def walk(node, path):
        if isinstance(node, dict):
            if set(node) <= {"weight", "bias"} and "weight" in node:
                state.update({f"{path}.{k}": v for k, v in node.items()})
                return
            for k, v in node.items():
                walk(v, f"{path}.{renames.get(k, k)}" if path else renames.get(k, k))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{path}.{i}")
        elif hasattr(node, "weight"):
            w = node.weight.data
            state[path + ".weight"] = w.t() if module == "gpt2" else w
            if node.bias is not None:
                state[path + ".bias"] = node.bias.data
        else:
            state[path + ".weight"] = node

    walk(tree, "")
    out = {}
    for k, v in state.items():
        out[k if k.startswith("lm_head") else prefix + k] = v.detach().contiguous()
    return out


def _hf_config(cfg, model_type: str) -> dict:
    out = {k: v for k, v in dataclasses.asdict(cfg).items() if v is not None}
    out["model_type"] = model_type
    if model_type == "gpt2":  # HF's own names
        out.update(n_embd=out.pop("hidden_size"), n_layer=out.pop("num_hidden_layers"),
                   n_head=out.pop("num_attention_heads"),
                   n_positions=out.pop("max_position_embeddings"))
    return out


@pytest.mark.parametrize("case", CASES)
def test_hf_loader(ref, case, tmp_path):
    r = ref["cases"][case]
    module, model_type = CASES[case][0], CASES[case][3]
    save_file(_hf_state(r["tree"], module), str(tmp_path / "model.safetensors"))
    with open(tmp_path / "config.json", "w") as f:
        json.dump(_hf_config(r["tcfg"], model_type), f)
    model = HQQModelForCausalLM.from_pretrained(str(tmp_path), compute_dtype=torch.float32,
                                                device="cpu")
    assert type(model.cfg) is type(r["tcfg"]) and model.cfg == r["tcfg"]
    logits, _ = model.forward(torch.from_numpy(ref["toks"]).long(), _cache(model.cfg), 0)
    assert _rel(logits.numpy(), r["logits"]) <= 1e-5


def _leaves(tree):
    return tree_to_state(tree)[0]


@pytest.mark.parametrize("case", CASES)
def test_checkpoints_both_ways(ref, case, tmp_path):
    import jax

    from hqq_tpu.engine import hf as jhf

    r = ref["cases"][case]
    model_type = CASES[case][3]
    jhf.HQQModel(r["jq"], r["jcfg"], model_type, quantized=True).save_quantized(
        str(tmp_path / "jax"))
    mine = HQQModelForCausalLM.from_quantized(str(tmp_path / "jax"), device="cpu")
    assert type(mine.cfg) is type(r["tcfg"]) and mine.cfg == r["tcfg"]
    want, got = _leaves(r["qtree"]), _leaves(mine.params)
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)

    mine.save_quantized(str(tmp_path / "port"))
    back = jhf.HQQModelForCausalLM.from_quantized(str(tmp_path / "port"))
    assert back.cfg == r["jcfg"]
    jw, jb = jax.tree_util.tree_leaves(r["jq"]), jax.tree_util.tree_leaves(back.params)
    assert len(jw) == len(jb)
    assert all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(jw, jb))


def test_phi2_fuses_for_decode(ref):
    """hqq_tpu: `fuse_for_decode` joins Phi-2's q/k/v and its forward then
    raises KeyError 'q_proj'. The port's reads ``qkv_proj``: logits under
    w4a8 bit-equal to the unfused tree's (the int8 route's group dots are
    exact)."""
    from hqq_tpu_torch.backends.pallas_backend import A8QuantLinear
    from hqq_tpu_torch.utils.patching import fuse_for_decode, prepare_for_inference

    r, tm = ref["cases"]["phi"], _modules("phi")[1]
    tree = prepare_for_inference(params_from_numpy(r["np_q"], "cpu"), "w4a8")
    fused = fuse_for_decode(tree)
    assert all(set(layer["self_attn"]) == {"qkv_proj", "dense"}
               and isinstance(layer["self_attn"]["qkv_proj"], A8QuantLinear)
               for layer in fused["layers"])
    toks = torch.tensor([_PROMPT])
    want, _ = tm.forward(tree, r["tcfg"], toks)
    got, _ = tm.forward(fused, r["tcfg"], toks)
    assert torch.equal(got, want)


def _write_checkpoint(r, model_type: str, path) -> str:
    HQQModel(params_from_numpy(r["np_q"], "cpu"), r["tcfg"], model_type,
             quantized=True).save_quantized(str(path))
    return str(path)


def test_phi2_serves_with_the_defaults(ref, tmp_path):
    """`serve.main` with its defaults (paged engine asked, w4a8, fused) on a
    Phi-2 checkpoint: the dense engine over the fused tree, and a request
    answered with the ids of the unfused tree's greedy decode."""
    from hqq_tpu_torch.serve import main

    r = ref["cases"]["phi"]
    ckpt = _write_checkpoint(r, "phi", tmp_path / "phi")
    srv = main(["--model", ckpt, "--device", "cpu", "--port", "0", "--max-len", "64",
                "--slots", "2"], serve=False)
    eng = srv.engine
    assert type(eng).__name__ == "ContinuousBatchingEngine"
    assert "qkv_proj" in eng.params["layers"][0]["self_attn"]
    eng.add_request(np.asarray(_PROMPT), max_new_tokens=_NEW)
    got = eng.run()
    eng.close()
    model = HQQModelForCausalLM.from_quantized(ckpt, device="cpu")
    model.prepare_for_inference("w4a8")
    want = model.generate(np.asarray([_PROMPT]), max_new_tokens=_NEW, compile_mode="partial",
                          cache_dtype=torch.float32, device="cpu")
    assert list(got.values())[0] == want[0].tolist()


@pytest.mark.parametrize("case", FLOAT_POOLS_ONLY)
def test_int8_kv_refused(ref, case, tmp_path):
    """int8 pools reach no forward that reads float pools only: the dense
    engine, the server (before loading) and the forward itself refuse them
    with a ValueError that names the family."""
    from hqq_tpu_torch.serve import main
    from hqq_tpu_torch.serving.batching import ContinuousBatchingEngine

    r, tm = ref["cases"][case], _modules(case)[1]
    family = CASES[case][0]
    with pytest.raises(ValueError, match=family):
        ContinuousBatchingEngine(r["tree"], r["tcfg"], batch_slots=2, max_len=32,
                                 quantize_kv=True, device="cpu",
                                 forward_fn=lambda p, t, c, s: tm.forward(p, r["tcfg"], t, c, s))
    ckpt = _write_checkpoint(r, CASES[case][3], tmp_path / case)
    with pytest.raises(ValueError, match=family):
        main(["--model", ckpt, "--device", "cpu", "--port", "0", "--int8-kv"], serve=False)
    with pytest.raises(ValueError, match=family):
        tm.forward(r["tree"], r["tcfg"], torch.tensor([_PROMPT]),
                   _cache(r["tcfg"], 1, 32, quantize_kv=True), 0)


def test_starcoder2_reads_int8_pools(ref):
    """StarCoder2 runs llama's attention, which reads int8 pools with their
    scales: the dense engine serves it, and the logits of decode steps over
    int8 pools stay near those over fp32 pools (per-row absmax int8 K/V)."""
    from hqq_tpu_torch.serving.batching import ContinuousBatchingEngine

    r, tm = ref["cases"]["starcoder2"], _modules("starcoder2")[1]
    toks = torch.from_numpy(ref["toks"]).long()
    outs = {}
    for q in (False, True):
        cache = _cache(r["tcfg"], quantize_kv=q)
        tm.forward(r["tree"], r["tcfg"], toks[:, :_PREFILL], cache, 0)
        outs[q] = torch.cat([tm.forward(r["tree"], r["tcfg"], toks[:, i:i + 1], cache,
                                        torch.tensor([i, i]))[0] for i in range(_PREFILL, _T)], 1)
    err = _rel(outs[True].numpy(), outs[False].numpy())
    assert 0 < err <= 2e-2
    eng = ContinuousBatchingEngine(r["tree"], r["tcfg"], batch_slots=2, max_len=32,
                                   quantize_kv=True, cache_dtype=torch.float32, device="cpu",
                                   forward_fn=lambda p, t, c, s: tm.forward(p, r["tcfg"], t, c, s))
    eng.add_request(np.asarray(_PROMPT), max_new_tokens=4)
    assert len(list(eng.run().values())[0]) == 4
    eng.close()


def test_gpt2_positions_bound_the_cache(ref):
    """GPT-2's learned positions: a cache or a sequence past
    max_position_embeddings is refused, never gathered past ``wpe``."""
    from hqq_tpu_torch.models import gpt2
    from hqq_tpu_torch.serving.batching import ContinuousBatchingEngine

    r = ref["cases"]["gpt2"]
    n = r["tcfg"].max_position_embeddings
    with pytest.raises(ValueError, match="gpt2"):
        ContinuousBatchingEngine(r["tree"], r["tcfg"], batch_slots=1, max_len=n + 1,
                                 device="cpu")
    with pytest.raises(ValueError, match="learned positions"):
        gpt2.forward(r["tree"], r["tcfg"], torch.zeros((1, 1), dtype=torch.long),
                     _cache(r["tcfg"], 1, n + 8), 0)
    with pytest.raises(ValueError, match="learned positions"):
        gpt2.forward(r["tree"], r["tcfg"], torch.zeros((1, 4), dtype=torch.long), None, n - 2)
