# SPDX-License-Identifier: Apache-2.0
"""DeepSeek-V3 (MLA, group-limited sigmoid routing, dense-compute MoE with
shared experts) against hqq_tpu, on the CPU.

Three configs on `tiny()`: the low-rank query with interleaved rope dims,
``q_proj`` with the dims in order, and DeepSeek-YaRN (``mscale_all_dim``:
the softmax scaled by mscale²). hqq_tpu's random fp32 weights, every norm
weight and correction bias drawn anew from a numpy seed, carried across by
`params_from_numpy`; hqq_tpu runs once per case in a module fixture and
torch on one thread.

* fp32 logits over the family's dense cache and cache-free, decode at int
  offsets, and decode at per-slot [B] offsets over a left-padded batch
  with ``kv_valid``: within 1e-5 of max|logits| of hqq_tpu's (the port
  reads 1.4e-6-2.1e-6 here; sums in another order).
* `_router`: the experts equal to hqq_tpu's and the weights within 1e-6,
  on scores built to tie and on a correction bias that makes every score
  negative (the masked experts' 0.0 then wins, lower index first).
* A 4-bit g32 w4a8 model: greedy ids of `Generator` and of the dense
  engine equal to a greedy loop of hqq_tpu's forward over
  `deepseek3.init_cache`; `fuse_for_decode` joins only the dense layers'
  gate/up, and the fused tree's logits are bit-equal; `serve.main` with its
  defaults serves it (dense engine, fused) with those ids.
* Refusals: int8 KV pools, the paged engine and the speculative paths, each
  a ValueError that names the family. The two reference faults recorded:
  hqq_tpu cannot generate with this family, and its fused tree raises.
* Checkpoints both ways (every tensor bit-equal; the port's logits equal
  after its load), the HF loader against hqq_tpu's on a tiny
  `transformers.DeepseekV3ForCausalLM`, `quantize_model` keeping the router
  in fp32, and the w4a8 plan on the tensor cores at the MLA's shapes.
"""

import dataclasses

import numpy as np
import pytest
import torch

from hqq_tpu_torch.engine.hf import HQQModel, HQQModelForCausalLM
from hqq_tpu_torch.models import deepseek3 as td
from hqq_tpu_torch.models.serialize import tree_to_state
from hqq_tpu_torch.utils import params_from_numpy

YARN = (("beta_fast", 32), ("beta_slow", 1), ("factor", 4.0), ("mscale", 1.0),
        ("mscale_all_dim", 1.0), ("original_max_position_embeddings", 32),
        ("rope_type", "yarn"))
CASES = {"q_lora": {}, "q_proj": dict(q_lora_rank=None, rope_interleave=False),
         "yarn": dict(rope_scaling=YARN)}
_T, _PREFILL = 24, 20
_PROMPTS = [[3, 17, 92, 41, 5, 77], [9, 8, 7, 200, 31, 64]]
_NEW = 6
_BAR = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch ops on one thread: the suite's workers share the cores, and
    torch's intra-op threads would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturbed(tree, seed: int):
    """Norm weights 1 + N(0, 0.1^2) and correction biases N(0, 0.5^2):
    numpy draws into hqq_tpu's tree (init leaves them 1 and 0)."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = np.shape(leaf)
        if "correction_bias" in name:
            return jnp.asarray(rng.standard_normal(shape).astype(np.float32) * 0.5)
        if "norm" in name:
            return jnp.asarray((1 + rng.standard_normal(shape) * 0.1).astype(np.float32))
        return leaf

    return jax.tree_util.tree_map_with_path(draw, tree)


def _jax_quantized(jd, params):
    """hqq_tpu's 4-bit g32 tree (fp32 compute): every Linear but lm_head by
    `quantize_model`, each routed stack by `quantize_grouped`."""
    import jax.numpy as jnp

    from hqq_tpu.core.quantize import BaseQuantizeConfig
    from hqq_tpu.models.base import quantize_model
    from hqq_tpu.nn.moe import quantize_grouped

    q = quantize_model(params, BaseQuantizeConfig(nbits=4, group_size=32),
                       compute_dtype=jnp.float32)
    for layer in q["layers"]:
        if "experts" in layer["mlp"]:
            ex = layer["mlp"]["experts"]
            for name in ("w1", "w2", "w3"):
                ex[name] = quantize_grouped(ex[name].weight, nbits=4, group_size=32,
                                            compute_dtype=jnp.float32)
    return q


def _jax_greedy(jd, fwd, params, cfg, prompt, n_new):
    """A greedy loop of hqq_tpu's forward (``fwd``, jitted) over
    `deepseek3.init_cache`."""
    import jax.numpy as jnp

    cache = jd.init_cache(cfg, 1, 64, jnp.float32)
    logits, cache = fwd(params, cfg, jnp.asarray([prompt], jnp.int32), cache, 0)
    out = [int(np.argmax(np.asarray(logits[0, -1])))]
    for pos in range(len(prompt), len(prompt) + n_new - 1):
        logits, cache = fwd(params, cfg, jnp.asarray([[out[-1]]], jnp.int32), cache, pos)
        out.append(int(np.argmax(np.asarray(logits[0, -1]))))
    return out


@pytest.fixture(scope="module")
def ref():
    """Per case: both configs, hqq_tpu's fp32 tree (numpy and the port's)
    and its logits; for "q_lora" also its decode at per-slot offsets, its
    4-bit tree (numpy) and the w4a8 tree's greedy ids. hqq_tpu's forward
    and preparation run jitted (eager, each op's first call compiles)."""
    import jax
    import jax.numpy as jnp

    from hqq_tpu.models import deepseek3 as jd
    from hqq_tpu.utils.patching import prepare_for_inference as j_prepare

    fwd = jax.jit(jd.forward, static_argnums=(1,))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 256, (2, _T)).astype(np.int32)
    out = {}
    for i, (case, kw) in enumerate(CASES.items()):
        jcfg = dataclasses.replace(jd.DeepseekV3Config.tiny(), **kw)
        params = _perturbed(jd.init_params(jcfg, jax.random.PRNGKey(i)), i)
        np_tree = jax.tree_util.tree_map(np.asarray, params)
        dense = np.asarray(fwd(params, jcfg, jnp.asarray(toks), jd.init_cache(jcfg, 2, 32), 0)[0])
        nocache = np.asarray(fwd(params, jcfg, jnp.asarray(toks))[0])
        out[case] = dict(jcfg=jcfg, tcfg=td.DeepseekV3Config(**dataclasses.asdict(jcfg)),
                         params=params, np_tree=np_tree, tree=params_from_numpy(np_tree, "cpu"),
                         dense=dense, nocache=nocache)
    r = out["q_lora"]
    jcfg, params = r["jcfg"], r["params"]
    # a left-padded batch: slot 0's first 3 slots hold padding, kv_valid
    # leaves them out; the decode steps at per-slot offsets (slot 1
    # rewrites its rows 10-11)
    valid = np.ones((2, 32), bool)
    valid[0, :3] = False
    starts = [np.array([12 + i, 10 + i], np.int32) for i in range(3)]
    cache = jd.init_cache(jcfg, 2, 32)
    logits, cache = fwd(params, jcfg, jnp.asarray(toks[:, :12]), cache, 0, jnp.asarray(valid))
    padded = [np.asarray(logits)]
    for i, s in enumerate(starts):
        logits, cache = fwd(params, jcfg, jnp.asarray(toks[:, 12 + i:13 + i]), cache,
                            jnp.asarray(s), jnp.asarray(valid))
        padded.append(np.asarray(logits))
    r.update(padded=padded, valid=valid, starts=starts)
    jq = _jax_quantized(jd, params)
    r["jq"] = jq
    r["np_q"] = jax.tree_util.tree_map(np.asarray, jq)
    r["ja8"] = jax.jit(lambda tree: j_prepare(tree, "w4a8"))(jq)
    r["greedy"] = [_jax_greedy(jd, fwd, r["ja8"], jcfg, p, _NEW) for p in _PROMPTS]
    return dict(toks=toks, cases=out, fwd=fwd)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _cache(cfg, b=2, n=32):
    return td.init_cache(cfg, b, n, torch.float32, "cpu")


@pytest.mark.parametrize("case", CASES)
def test_logits_against_hqq_tpu(ref, case):
    r = ref["cases"][case]
    toks = torch.from_numpy(ref["toks"]).long()
    logits, _ = td.forward(r["tree"], r["tcfg"], toks, _cache(r["tcfg"]), 0)
    assert _rel(logits.numpy(), r["dense"]) <= _BAR
    nocache, _ = td.forward(r["tree"], r["tcfg"], toks)
    assert _rel(nocache.numpy(), r["nocache"]) <= _BAR


def test_decode_at_int_offsets(ref):
    """A prefill and decode steps at int offsets over the MLA cache, against
    hqq_tpu's cache-free forward over the same tokens (no assignment is
    dropped: a token's logits are the same either way)."""
    r = ref["cases"]["q_lora"]
    toks = torch.from_numpy(ref["toks"]).long()
    cache = _cache(r["tcfg"])
    got = [td.forward(r["tree"], r["tcfg"], toks[:, :_PREFILL], cache, 0)[0]]
    got += [td.forward(r["tree"], r["tcfg"], toks[:, i:i + 1], cache, i)[0]
            for i in range(_PREFILL, _T)]
    assert _rel(torch.cat(got, dim=1).numpy(), r["nocache"]) <= _BAR


def test_per_slot_offsets_with_kv_valid(ref):
    r = ref["cases"]["q_lora"]
    toks = torch.from_numpy(ref["toks"]).long()
    valid = torch.from_numpy(r["valid"])
    cache = _cache(r["tcfg"])
    got = [td.forward(r["tree"], r["tcfg"], toks[:, :12], cache, 0, kv_valid=valid)[0]]
    for i, s in enumerate(r["starts"]):
        got.append(td.forward(r["tree"], r["tcfg"], toks[:, 12 + i:13 + i], cache,
                              torch.from_numpy(s).long(), kv_valid=valid)[0])
    for g, w in zip(got, r["padded"]):
        assert _rel(g.numpy(), w) <= _BAR


def _router_inputs(kind: str, cfg, seed: int):
    """(gate_weight [E, D], bias [E], x [T, D]) in fp32. "ties": the
    router's rows two distinct vectors, so scores and group sums tie
    exactly; "negative_bias": a correction bias under -1, so every
    unmasked choice is below the masked experts' 0.0."""
    rng = np.random.default_rng(seed)
    e, d = cfg.n_routed_experts, cfg.hidden_size
    gate = rng.standard_normal((e, d)).astype(np.float32) * 0.02
    bias = np.zeros((e,), np.float32)
    if kind == "ties":
        gate = np.stack([gate[i % 2] for i in range(e)])
    else:
        bias = (-1.5 - rng.random(e)).astype(np.float32)
    return gate, bias, rng.standard_normal((16, d)).astype(np.float32)


@pytest.mark.parametrize("kind,groups", [("ties", None), ("negative_bias", None),
                                         ("negative_bias", (1, 1, 6))])
def test_router_against_hqq_tpu(kind, groups):
    import jax.numpy as jnp

    from hqq_tpu.models import deepseek3 as jd

    jcfg = jd.DeepseekV3Config.tiny()
    if groups:  # Moonlight's one group, top-6
        jcfg = dataclasses.replace(jcfg, n_group=groups[0], topk_group=groups[1],
                                   num_experts_per_tok=groups[2])
    tcfg = td.DeepseekV3Config(**dataclasses.asdict(jcfg))
    gate, bias, x = _router_inputs(kind, jcfg, 3)
    jidx, jw = jd._router({"gate_weight": jnp.asarray(gate),
                           "e_score_correction_bias": jnp.asarray(bias)}, jcfg, jnp.asarray(x))
    idx, w = td._router({"gate_weight": torch.from_numpy(gate),
                         "e_score_correction_bias": torch.from_numpy(bias)}, tcfg,
                        torch.from_numpy(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert np.abs(w.numpy() - np.asarray(jw)).max() <= 1e-6


def _w4a8_tree(r):
    from hqq_tpu_torch.utils.patching import prepare_for_inference

    return prepare_for_inference(params_from_numpy(r["np_q"], "cpu"), "w4a8")


def _fwd(cfg):
    return lambda p, toks, c, pos: td.forward(p, cfg, toks, c, pos)


@pytest.mark.parametrize("route", ["generator", "dense_engine"])
def test_w4a8_greedy_ids(ref, route):
    from hqq_tpu_torch.serving.batching import ContinuousBatchingEngine

    r = ref["cases"]["q_lora"]
    tree = _w4a8_tree(r)
    if route == "generator":
        model = HQQModel(tree, r["tcfg"], "deepseek_v3", quantized=True)
        got = [model.generate(np.asarray([p]), max_new_tokens=_NEW, cache_dtype=torch.float32,
                              device="cpu")[0].tolist() for p in _PROMPTS]
    else:
        eng = ContinuousBatchingEngine(tree, r["tcfg"], batch_slots=2, max_len=64,
                                       cache_dtype=torch.float32, device="cpu",
                                       forward_fn=_fwd(r["tcfg"]))
        uids = [eng.add_request(np.asarray(p), max_new_tokens=_NEW) for p in _PROMPTS]
        res = eng.run()
        eng.close()
        got = [list(map(int, res[u])) for u in uids]
    assert got == r["greedy"]


def test_fuse_for_decode(ref):
    """The dense layer's gate/up join into ``gate_up_proj``, the MoE
    layers' shared experts and the MLA projections stay as they are, and
    the fused tree's w4a8 logits equal the unfused tree's bit for bit
    (hqq_tpu's forward raises on the fused tree: `test_reference_faults`)."""
    from hqq_tpu_torch.backends.pallas_backend import A8QuantLinear
    from hqq_tpu_torch.utils.patching import fuse_for_decode

    r = ref["cases"]["q_lora"]
    tree = _w4a8_tree(r)
    fused = fuse_for_decode(tree)
    dense, moe = fused["layers"][0], fused["layers"][1]
    assert set(dense["mlp"]) == {"gate_up_proj", "down_proj"}
    assert isinstance(dense["mlp"]["gate_up_proj"], A8QuantLinear)
    assert set(moe["mlp"]["shared_experts"]) == {"gate_proj", "up_proj", "down_proj"}
    assert set(moe["self_attn"]) == set(tree["layers"][1]["self_attn"])
    toks = torch.tensor([_PROMPTS[0]])
    want, _ = td.forward(tree, r["tcfg"], toks)
    got, _ = td.forward(fused, r["tcfg"], toks)
    assert torch.equal(got, want)


@pytest.fixture(scope="module")
def checkpoint(ref, tmp_path_factory):
    """hqq_tpu's quantized tiny DeepSeek-V3 (fp32 compute) as its checkpoint."""
    from hqq_tpu.engine import hf as jhf

    r = ref["cases"]["q_lora"]
    path = str(tmp_path_factory.mktemp("deepseek3") / "jax")
    jhf.HQQModel(r["jq"], r["jcfg"], "deepseek_v3", quantized=True).save_quantized(path)
    return path


def test_serves_with_the_defaults(ref, checkpoint):
    """`serve.main` with its defaults (the paged engine asked, w4a8, fused):
    the dense engine over the fused tree answers with hqq_tpu's greedy ids
    of the unfused w4a8 tree."""
    from hqq_tpu_torch.serve import main

    srv = main(["--model", checkpoint, "--device", "cpu", "--port", "0", "--max-len", "64",
                "--slots", "2"], serve=False)
    eng = srv.engine
    assert type(eng).__name__ == "ContinuousBatchingEngine"
    assert "gate_up_proj" in eng.params["layers"][0]["mlp"]
    uids = [eng.add_request(np.asarray(p), max_new_tokens=_NEW) for p in _PROMPTS]
    res = eng.run()
    eng.close()
    assert [list(map(int, res[u])) for u in uids] == ref["cases"]["q_lora"]["greedy"]


@pytest.mark.parametrize("who", ["int8_kv_engine", "int8_kv_server", "paged", "speculative",
                                 "speculative_dense", "speculative_paged"])
def test_refused(ref, checkpoint, who):
    """What the family's dense MLA cache rules out, refused before any step
    with a ValueError that names the family."""
    from hqq_tpu_torch.serve import main
    from hqq_tpu_torch.serving.batching import ContinuousBatchingEngine
    from hqq_tpu_torch.serving.paged import PagedBatchingEngine
    from hqq_tpu_torch.serving.speculative import (SpeculativeBatchingEngine,
                                                   SpeculativeGenerator, SpeculativePagedEngine)

    r = ref["cases"]["q_lora"]
    tree, cfg = r["tree"], r["tcfg"]
    cpu = dict(device="cpu")
    build = {
        "int8_kv_engine": lambda: ContinuousBatchingEngine(
            tree, cfg, batch_slots=2, max_len=32, quantize_kv=True, forward_fn=_fwd(cfg), **cpu),
        "int8_kv_server": lambda: main(["--model", checkpoint, "--port", "0", "--int8-kv"]
                                       + ["--device", "cpu"], serve=False),
        "paged": lambda: PagedBatchingEngine(tree, cfg, batch_slots=2, num_pages=16,
                                             page_size=4, max_pages_per_seq=8, **cpu),
        "speculative": lambda: SpeculativeGenerator(tree, tree, cfg, compile_mode="partial",
                                                    **cpu),
        "speculative_dense": lambda: SpeculativeBatchingEngine(tree, tree, cfg, batch_slots=2,
                                                               max_len=32, **cpu),
        "speculative_paged": lambda: SpeculativePagedEngine(tree, tree, cfg, batch_slots=2,
                                                            num_pages=16, page_size=4,
                                                            max_pages_per_seq=8, **cpu),
    }[who]
    with pytest.raises(ValueError, match="deepseek"):
        build()


@pytest.mark.parametrize("fault", ["generate", "fused_forward"])
def test_reference_faults(ref, fault):
    """The two faults of hqq_tpu that the port keeps out (`ROADMAP.md` §3):
    its generator builds Llama's cache for this family (AttributeError
    'num_key_value_heads'), and its forward reads ``gate_proj`` of a tree
    `fuse_for_decode` joined (KeyError). The port's paths over the same
    trees are held above (`test_w4a8_greedy_ids`, `test_fuse_for_decode`)."""
    import jax.numpy as jnp

    from hqq_tpu.engine.hf import HQQModel as JModel
    from hqq_tpu.utils.patching import fuse_for_decode

    r = ref["cases"]["q_lora"]
    if fault == "generate":
        with pytest.raises(AttributeError, match="num_key_value_heads"):
            JModel(r["jq"], r["jcfg"], "deepseek_v3", quantized=True).generate(
                np.asarray([_PROMPTS[0]]), max_new_tokens=2)
    else:
        fused = fuse_for_decode(r["ja8"])
        with pytest.raises(KeyError, match="gate_proj"):
            ref["fwd"](fused, r["jcfg"], jnp.asarray([_PROMPTS[0]], jnp.int32))


def _leaves(tree):
    return tree_to_state(tree)[0]


def test_checkpoints_both_ways(ref, checkpoint, tmp_path):
    import jax

    from hqq_tpu.engine import hf as jhf

    from hqq_tpu_torch.nn.moe import GroupedQuantLinear

    r = ref["cases"]["q_lora"]
    mine = HQQModelForCausalLM.from_quantized(checkpoint, device="cpu")
    assert type(mine.cfg) is td.DeepseekV3Config and mine.cfg == r["tcfg"]
    want, got = _leaves(params_from_numpy(r["np_q"], "cpu")), _leaves(mine.params)
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
    mlp = mine.params["layers"][1]["mlp"]
    assert isinstance(mlp["experts"]["w2"], GroupedQuantLinear)
    assert mlp["gate_weight"].dtype == torch.float32
    toks = torch.tensor([_PROMPTS[0]])
    assert torch.equal(td.forward(mine.params, mine.cfg, toks)[0],
                       td.forward(params_from_numpy(r["np_q"], "cpu"), r["tcfg"], toks)[0])

    mine.save_quantized(str(tmp_path / "port"))
    back = jhf.HQQModelForCausalLM.from_quantized(str(tmp_path / "port"))
    assert back.cfg == r["jcfg"]
    jw, jb = jax.tree_util.tree_leaves(r["jq"]), jax.tree_util.tree_leaves(back.params)
    assert len(jw) == len(jb)
    assert all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(jw, jb))


def test_yarn_config_through_a_checkpoint(ref, tmp_path):
    """The sidecar's rope_scaling comes back as the canonical tuple."""
    r = ref["cases"]["yarn"]
    HQQModel(r["tree"], r["tcfg"], "deepseek_v3", quantized=True).save_quantized(str(tmp_path))
    back = HQQModelForCausalLM.from_quantized(str(tmp_path), device="cpu")
    assert back.cfg == r["tcfg"] and back.cfg.rope_scaling == YARN
    assert back.cfg.attn_scale_ == r["jcfg"].attn_scale_


def test_quantize_model_keeps_the_router(ref):
    """`HQQModel.quantize_model`, in both packages: every Linear but lm_head
    (the MLA projections, the dense and shared MLPs), the router's fp32
    arrays and the routed stacks as they were."""
    import jax.numpy as jnp

    from hqq_tpu.core.quantize import BaseQuantizeConfig as JConfig
    from hqq_tpu.engine.hf import HQQModel as JModel

    from hqq_tpu_torch.core.quantize import BaseQuantizeConfig

    r = ref["cases"]["q_proj"]
    jmodel = JModel(r["np_tree"], r["jcfg"], "deepseek_v3")
    jmodel.quantize_model(JConfig(nbits=4, group_size=32), compute_dtype=jnp.float32)
    mine = HQQModel(params_from_numpy(r["np_tree"], "cpu"), r["tcfg"], "deepseek_v3")
    mine.quantize_model(BaseQuantizeConfig(nbits=4, group_size=32), compute_dtype=torch.float32)

    def kinds(tree, path=""):
        if isinstance(tree, dict):
            return {k2: v2 for k, v in tree.items() for k2, v2 in kinds(v, f"{path}.{k}").items()}
        if isinstance(tree, (list, tuple)):
            return {k2: v2 for i, v in enumerate(tree) for k2, v2 in kinds(v, f"{path}.{i}").items()}
        name = type(tree).__name__
        return {path: "array" if name in ("ndarray", "Tensor", "ArrayImpl") else name}

    got = kinds(mine.params)
    assert got == kinds(jmodel.params)
    assert got[".layers.1.self_attn.q_proj"] == "QuantLinear"
    assert got[".layers.1.mlp.experts.w1"] == "GroupedLinear"
    assert mine.params["layers"][1]["mlp"]["gate_weight"].dtype == torch.float32


def test_hf_loader_against_hqq_tpu():
    """`params_from_hf_state_dict` on a tiny `DeepseekV3ForCausalLM` (bias
    drawn), every tensor equal to hqq_tpu's loader's."""
    import jax

    transformers = pytest.importorskip("transformers")
    from hqq_tpu.models import deepseek3 as jd

    hf_cfg = transformers.DeepseekV3Config(
        vocab_size=64, hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4, n_routed_experts=4,
        n_shared_experts=1, num_experts_per_tok=2, n_group=2, topk_group=1, q_lora_rank=24,
        kv_lora_rank=16, qk_rope_head_dim=8, qk_nope_head_dim=16, v_head_dim=16,
        first_k_dense_replace=1, max_position_embeddings=64)
    torch.manual_seed(0)
    model = transformers.DeepseekV3ForCausalLM(hf_cfg).float()
    with torch.no_grad():
        model.model.layers[1].mlp.gate.e_score_correction_bias.uniform_(-0.05, 0.05)
    state = dict(model.state_dict())
    jcfg = jd.DeepseekV3Config.from_hf(hf_cfg.to_dict())
    tcfg = td.DeepseekV3Config.from_hf(hf_cfg.to_dict())
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    want = _leaves(params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jd.params_from_hf_state_dict(state, jcfg)), "cpu"))
    got = _leaves(td.params_from_hf_state_dict(state, tcfg, torch.float32))
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("m", [4, 8, 32])
def test_w4a8_plan_takes_the_mla_shapes(m):
    """kv_b_proj's K = 512, kv_a_proj_with_mqa's N = 576 and DeepSeek-V3's
    o_proj K = 16384 (and its q_b_proj, kv_b_proj widths) go to the tensor
    cores at 4-bit g64."""
    from hqq_tpu_torch.ops.fused_matmul import w4a8_launch_plan

    for k, n in ((512, 4096), (512, 32768), (2048, 576), (7168, 576), (16384, 7168),
                 (1536, 24576)):
        assert w4a8_launch_plan(m, n, k, 4, 64).route == "tensor_cores", (m, k, n)
