# SPDX-License-Identifier: Apache-2.0
"""The MoE families (Mixtral, Qwen3-MoE, gpt-oss) against hqq_tpu, on the CPU.

Each on its `tiny()` config, Qwen3-MoE also with a dense layer
(``mlp_only_layers``), hqq_tpu's random fp32 weights with every bias, norm
weight and attention sink drawn anew (init leaves them 0 and 1), carried
across by `params_from_numpy`. hqq_tpu runs once per case in a module
fixture.

* Logits of 24 tokens over the dense cache and cache-free, and of a paged
  step (T = 1) and a verify window (T = 3) over a filled pool with a dead
  slot, within 1e-5 of max|logits| of hqq_tpu's (fp32), with the dispatch
  of every MoE layer equal to hqq_tpu's.
* Cached decode equals the full forward (no assignment is dropped there).
* The families' quantizers (`quantize_mixtral`, ...) against hqq_tpu's:
  the same node types at every path, the router in full precision, codes
  and meta at the reference bars (codes and zeros matching in > 0.999 of
  places: over thousands of groups the solver meets a tie now and then); `quantize_model` on an MoE tree
  quantizes the routers and leaves the experts dense, as hqq_tpu's does.
* The HF loaders on a tiny HF directory under each family's names (gpt-oss's
  experts input-major), every tensor bit-equal to the tree's.
* Checkpoints both ways, every tensor bit-equal.
* Greedy ids of the port's paged and dense engines equal to hqq_tpu's
  engines' on hqq_tpu's quantized tree; `Generator` ("full", eager here)
  equal to the dense loop.
* `prepare_for_inference` and `fuse_for_decode` leave the expert stacks as
  they are; the fused tree's logits under w4a8 bit-equal to the unfused.
* `serve.main` on a tiny Mixtral checkpoint written by hqq_tpu, paged and
  dense, against `hqq_tpu.serve.main` on it.
* A config with ``ep_axis`` (expert parallelism, not ported) raises.
"""

import dataclasses
import importlib
import json

import numpy as np
import pytest
import torch

from hqq_tpu_torch.engine.hf import HQQModel, HQQModelForCausalLM
from hqq_tpu_torch.models import llama as tl
from hqq_tpu_torch.models._safetensors import save_file
from hqq_tpu_torch.models.serialize import tree_to_state
from hqq_tpu_torch.nn.moe import GroupedLinear, GroupedQuantLinear
from hqq_tpu_torch.utils import paged_cache_from_numpy, params_from_numpy

# case -> (module, config class, tiny() overrides, model_type, quantizer)
CASES = {
    "mixtral": ("mixtral", "MixtralConfig", {}, "mixtral", "quantize_mixtral"),
    "qwen3_moe": ("qwen3_moe", "Qwen3MoeConfig", {}, "qwen3_moe", "quantize_qwen3_moe"),
    "qwen3_moe_dense": ("qwen3_moe", "Qwen3MoeConfig", dict(mlp_only_layers=(1,)), "qwen3_moe",
                        "quantize_qwen3_moe"),
    "gpt_oss": ("gpt_oss", "GptOssConfig", {}, "gpt_oss", "quantize_gpt_oss"),
}
_T, _PREFILL = 24, 20
_PROMPTS = [[3, 17, 92, 41, 5, 77], [9, 8, 7, 200, 31]]
_NEW = 6
_POOL = dict(batch_slots=2, num_pages=32, page_size=4, max_pages_per_seq=8)


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


def _tiny(jm, tm, case):
    _, cls, kw, _, _ = CASES[case]
    jcfg = dataclasses.replace(getattr(jm, cls).tiny(), **kw)
    return jcfg, getattr(tm, cls)(**dataclasses.asdict(jcfg))


def _perturbed(tree, seed: int):
    """Every bias N(0, 0.1^2), every norm weight 1 + N(0, 0.1^2) and every
    sink N(0, 1): numpy draws into hqq_tpu's tree."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape, dt = np.shape(leaf), np.asarray(leaf).dtype
        if name.endswith("bias") or name.endswith("bias']"):
            return jnp.asarray(rng.standard_normal(shape).astype(np.float32) * 0.1, dt)
        if "sinks" in name:
            return jnp.asarray(rng.standard_normal(shape).astype(np.float32), dt)
        if "norm" in name:
            return jnp.asarray((1 + rng.standard_normal(shape) * 0.1).astype(np.float32), dt)
        return leaf

    return jax.tree_util.tree_map_with_path(draw, tree)


def _record_dispatch(monkeypatch_target, module, log: list):
    """Wrap ``module.moe_dispatch`` so each call's dispatch lands in ``log``."""
    inner = module.moe_dispatch

    def rec(*a, **k):
        d, c = inner(*a, **k)
        log.append(np.asarray(d))
        return d, c

    monkeypatch_target(module, "moe_dispatch", rec)


class _Patch:
    """A monkeypatch for fixtures of module scope."""

    def __init__(self):
        self.undo = []

    def __call__(self, obj, name, value):
        self.undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def restore(self):
        for obj, name, value in reversed(self.undo):
            setattr(obj, name, value)
        self.undo.clear()


def _paged_inputs(jcfg, seed):
    """A filled fp32 pool (hqq_tpu's, and the port's copy), tokens for a
    step of T = 1 and a window of T = 3, lengths with a dead slot, a page
    table."""
    import jax
    import jax.numpy as jnp

    from hqq_tpu.ops import paged as jp

    jc = jp.init_paged_cache(jcfg, 16, 4, jnp.float32)
    rng = np.random.default_rng(seed)
    jc = jc.replace(k=jnp.asarray(rng.standard_normal(jc.k.shape).astype(np.float32)),
                    v=jnp.asarray(rng.standard_normal(jc.v.shape).astype(np.float32)))
    tab = np.zeros((3, 6), np.int32)
    tab[0, :3] = [3, 9, 4]
    tab[2, :6] = [7, 1, 12, 15, 2, 8]
    return dict(jc=jc, np_cache=jax.tree_util.tree_map(np.asarray, jc),
                lengths=np.array([5, 0, 17], np.int32), tab=tab,
                toks={t: rng.integers(0, 256, (3, t)).astype(np.int32) for t in (1, 3)})


def _jax_engines(jm, jq, jcfg):
    """hqq_tpu's paged and dense engines' greedy ids for _PROMPTS."""
    import jax.numpy as jnp

    from hqq_tpu.serving.batching import ContinuousBatchingEngine as JDense
    from hqq_tpu.serving.paged import PagedBatchingEngine as JPaged

    out = {}
    paged = JPaged(jq, jcfg, cache_dtype=jnp.float32, **_POOL,
                   forward_fn=lambda p, toks, c, pos, ptab=None:
                   jm.forward(p, jcfg, toks, c, pos, page_indices=ptab))
    dense = JDense(jq, jcfg, batch_slots=2, max_len=64, cache_dtype=jnp.float32,
                   forward_fn=lambda p, toks, c, pos: jm.forward(p, jcfg, toks, c, pos))
    for name, eng in (("paged", paged), ("dense", dense)):
        uids = [eng.add_request(np.asarray(p), max_new_tokens=_NEW) for p in _PROMPTS]
        res = eng.run()
        out[name] = [list(map(int, res[u])) for u in uids]
    return out


@pytest.fixture(scope="module")
def ref():
    """Per case: both configs, hqq_tpu's fp32 and quantized trees (numpy
    and the port's), hqq_tpu's logits (dense, cache-free, paged) with the
    dispatch of every MoE call, and its engines' greedy ids."""
    import jax
    import jax.numpy as jnp

    from hqq_tpu.core.quantize import BaseQuantizeConfig as JConfig

    toks = np.random.default_rng(0).integers(0, 256, (2, _T)).astype(np.int32)
    patch = _Patch()
    out = {}
    try:
        for i, case in enumerate(CASES):
            jm, tm = _modules(case)
            jcfg, tcfg = _tiny(jm, tm, case)
            params = _perturbed(jm.init_params(jcfg, jax.random.PRNGKey(i), dtype=jnp.float32),
                                i)
            q = JConfig(nbits=4, group_size=32)
            jq = getattr(jm, CASES[case][4])(params, q, q, compute_dtype=jnp.float32)
            np_tree = jax.tree_util.tree_map(np.asarray, params)
            np_q = jax.tree_util.tree_map(np.asarray, jq)
            logs = {}
            for name in ("dense", "nocache", "paged1", "paged3"):
                logs[name] = []
            _record_dispatch(patch, jm, logs["dense"])
            jcache = jm.init_cache(jcfg, 2, 32, jnp.float32)
            dense = np.asarray(jm.forward(params, jcfg, jnp.asarray(toks), jcache, 0)[0])
            patch.restore()
            _record_dispatch(patch, jm, logs["nocache"])
            nocache = np.asarray(jm.forward(params, jcfg, jnp.asarray(toks))[0])
            patch.restore()
            pin = _paged_inputs(jcfg, i + 10)
            paged = {}
            for t in (1, 3):
                _record_dispatch(patch, jm, logs[f"paged{t}"])
                paged[t] = np.asarray(jm.forward(
                    params, jcfg, jnp.asarray(pin["toks"][t]), pin["jc"],
                    jnp.asarray(pin["lengths"]), page_indices=jnp.asarray(pin["tab"]))[0])
                patch.restore()
            out[case] = dict(jcfg=jcfg, tcfg=tcfg, jq=jq, np_tree=np_tree, np_q=np_q,
                             tree=params_from_numpy(np_tree, "cpu"),
                             qtree=params_from_numpy(np_q, "cpu"), dense=dense,
                             nocache=nocache, paged=paged, pin=pin, dispatch=logs,
                             engines=_jax_engines(jm, jq, jcfg))
    finally:
        patch.restore()
    return dict(toks=toks, cases=out)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _cache(cfg, b=2, n=32):
    return tl.init_cache(cfg, b, n, torch.float32, "cpu")


def _port_dispatch(monkeypatch) -> list:
    """Record each dispatch the port's routing (`nn.moe.route_tokens`) makes."""
    from hqq_tpu_torch.nn import moe as tmoe

    log = []
    inner = tmoe.moe_dispatch

    def rec(*a, **k):
        d, c = inner(*a, **k)
        log.append(d.numpy())
        return d, c

    monkeypatch.setattr(tmoe, "moe_dispatch", rec)
    return log


def _same_dispatch(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", CASES)
def test_logits_against_hqq_tpu(ref, case, monkeypatch):
    r, tm = ref["cases"][case], _modules(case)[1]
    toks = torch.from_numpy(ref["toks"]).long()
    log = _port_dispatch(monkeypatch)
    logits, _ = tm.forward(r["tree"], r["tcfg"], toks, _cache(r["tcfg"]), 0)
    assert _rel(logits.numpy(), r["dense"]) <= 1e-5
    _same_dispatch(log, r["dispatch"]["dense"])
    log.clear()
    nocache, _ = tm.forward(r["tree"], r["tcfg"], toks)
    assert _rel(nocache.numpy(), r["nocache"]) <= 1e-5
    _same_dispatch(log, r["dispatch"]["nocache"])


@pytest.mark.parametrize("t", [1, 3])
@pytest.mark.parametrize("case", CASES)
def test_paged_logits_against_hqq_tpu(ref, case, t, monkeypatch):
    r, tm = ref["cases"][case], _modules(case)[1]
    pin = r["pin"]
    cache = paged_cache_from_numpy(pin["np_cache"], "cpu")
    log = _port_dispatch(monkeypatch)
    logits, out = tm.forward(r["tree"], r["tcfg"], torch.from_numpy(pin["toks"][t]).long(), cache,
                             torch.from_numpy(pin["lengths"]),
                             page_indices=torch.from_numpy(pin["tab"]))
    assert out is cache
    live = [0, 2]  # slot 1 is dead (scratch page 0)
    assert _rel(logits.numpy()[live], r["paged"][t][live]) <= 1e-5
    _same_dispatch(log, r["dispatch"][f"paged{t}"])


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


def _kinds(tree, path=""):
    """{path: node type name} of every non-container node."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_kinds(v, f"{path}.{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_kinds(v, f"{path}.{i}"))
        return out
    name = type(tree).__name__
    return {path: "array" if name in ("ndarray", "Tensor", "Parameter") else name}


@pytest.mark.parametrize("case", CASES)
def test_quantizer_against_hqq_tpu(ref, case):
    from hqq_tpu_torch.core.quantize import BaseQuantizeConfig
    from hqq_tpu_torch.core.quantize import unpack_codes

    r, tm = ref["cases"][case], _modules(case)[1]
    q = BaseQuantizeConfig(nbits=4, group_size=32)
    mine = getattr(tm, CASES[case][4])(params_from_numpy(r["np_tree"], "cpu"), q, q,
                                       compute_dtype=torch.float32)
    assert _kinds(mine) == _kinds(r["np_q"])
    router = "block_sparse_moe" if case == "mixtral" else "mlp"
    gate = mine["layers"][0][router]["router" if case == "gpt_oss" else "gate"]
    assert type(gate).__name__ == "Linear"
    want = tree_to_state(r["qtree"])[0]
    got = tree_to_state(mine)[0]
    assert got.keys() == want.keys()
    for k in want:
        if k.endswith(".W_q") and "experts" in k:  # a stack: its codes by expert
            gq_path = k[:-4]
            g, w = _at(mine, gq_path), _at(r["qtree"], gq_path)
            from hqq_tpu_torch.ops.fused_matmul import expert_qtensor
            for e in range(g.n_experts):
                cg = unpack_codes(expert_qtensor(g.qtensor(), e), torch.int32)
                cw = unpack_codes(expert_qtensor(w.qtensor(), e), torch.int32)
                assert (cg == cw).float().mean() > 0.999
        elif k.endswith(".W_q"):
            assert (got[k] == want[k]).float().mean() > 0.99
        elif k.endswith(".scale"):
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-5, atol=1e-6)
        elif k.endswith(".zero"):  # a solver tie may move a group's zero: as the codes, > 0.999
            close = np.isclose(got[k].numpy(), want[k].numpy(), rtol=1e-4, atol=5e-4)
            assert close.mean() > 0.999, (k, close.mean())
        else:
            assert torch.equal(got[k], want[k]), k


def _at(tree, path):
    for p in path.split("."):
        tree = tree[int(p)] if isinstance(tree, list) else tree[p]
    return tree


def test_quantize_model_quantizes_routers_not_experts(ref):
    """`HQQModel.quantize_model` on an MoE tree, in both packages: every
    Linear but lm_head, which on Mixtral is the attention and the router
    gate; the experts stay dense `GroupedLinear`s."""
    import jax.numpy as jnp

    from hqq_tpu.core.quantize import BaseQuantizeConfig as JConfig
    from hqq_tpu.engine.hf import HQQModel as JModel

    from hqq_tpu_torch.core.quantize import BaseQuantizeConfig

    r = ref["cases"]["mixtral"]
    jmodel = JModel(r["np_tree"], r["jcfg"], "mixtral")
    jmodel.quantize_model(JConfig(nbits=4, group_size=32), compute_dtype=jnp.float32)
    mine = HQQModel(params_from_numpy(r["np_tree"], "cpu"), r["tcfg"], "mixtral")
    mine.quantize_model(BaseQuantizeConfig(nbits=4, group_size=32), compute_dtype=torch.float32)
    kinds = _kinds(mine.params)
    assert kinds == _kinds(jmodel.params)
    assert kinds[".layers.0.block_sparse_moe.gate"] == "QuantLinear"
    assert kinds[".layers.0.block_sparse_moe.experts.w1"] == "GroupedLinear"


# HF names: how each family's tree maps onto an HF state dict
def _hf_state(tree, case) -> dict:
    state = {"model.embed_tokens.weight": tree["embed_tokens"],
             "model.norm.weight": tree["norm"], "lm_head.weight": tree["lm_head"].weight.data}
    for i, layer in enumerate(tree["layers"]):
        p = f"model.layers.{i}"
        for n, v in layer.items():
            if n.endswith("layernorm"):
                state[f"{p}.{n}.weight"] = v
        for n, v in layer["self_attn"].items():
            if n == "sinks":
                state[f"{p}.self_attn.sinks"] = v
            elif n in ("q_norm", "k_norm"):
                state[f"{p}.self_attn.{n}.weight"] = v
            else:
                state[f"{p}.self_attn.{n}.weight"] = v.weight.data
                if v.bias is not None:
                    state[f"{p}.self_attn.{n}.bias"] = v.bias.data
        block = layer["block_sparse_moe"] if case == "mixtral" else layer["mlp"]
        pre = f"{p}.block_sparse_moe" if case == "mixtral" else f"{p}.mlp"
        if case == "gpt_oss":
            state[f"{pre}.router.weight"] = block["router"].weight.data
            state[f"{pre}.router.bias"] = block["router"].bias.data
            for n in ("gate_up_proj", "down_proj"):  # HF stores them input-major
                state[f"{pre}.experts.{n}"] = block["experts"][n].weight.data.transpose(1, 2)
            state[f"{pre}.experts.gate_up_proj_bias"] = block["gate_up_bias"]
            state[f"{pre}.experts.down_proj_bias"] = block["down_bias"]
        elif "experts" in block:
            state[f"{pre}.gate.weight"] = block["gate"].weight.data
            for n, stack in block["experts"].items():
                for e in range(stack.n_experts):
                    state[f"{pre}.experts.{e}.{n}.weight"] = stack.weight.data[e]
        else:
            for n, v in block.items():
                state[f"{pre}.{n}.weight"] = v.weight.data
    return {k: v.detach().contiguous() for k, v in state.items()}


@pytest.mark.parametrize("case", CASES)
def test_hf_loader(ref, case, tmp_path):
    r = ref["cases"][case]
    save_file(_hf_state(r["tree"], case), str(tmp_path / "model.safetensors"))
    hf = {k: v for k, v in dataclasses.asdict(r["tcfg"]).items() if v is not None}
    hf["model_type"] = CASES[case][3]
    with open(tmp_path / "config.json", "w") as f:
        json.dump(hf, f)
    model = HQQModelForCausalLM.from_pretrained(str(tmp_path), compute_dtype=torch.float32,
                                                device="cpu")
    assert type(model.cfg) is type(r["tcfg"]) and model.cfg == r["tcfg"]
    want, got = tree_to_state(r["tree"])[0], tree_to_state(model.params)[0]
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)


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
    assert isinstance(_at(mine.params, "layers.0." + (
        "block_sparse_moe.experts.w1" if case == "mixtral" else
        "mlp.experts.down_proj")), GroupedQuantLinear)

    mine.save_quantized(str(tmp_path / "port"))
    again = HQQModelForCausalLM.from_quantized(str(tmp_path / "port"), device="cpu")
    assert all(torch.equal(a, _leaves(again.params)[k]) for k, a in got.items())
    back = jhf.HQQModelForCausalLM.from_quantized(str(tmp_path / "port"))
    assert back.cfg == r["jcfg"]
    jw, jb = jax.tree_util.tree_leaves(r["jq"]), jax.tree_util.tree_leaves(back.params)
    assert len(jw) == len(jb)
    assert all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(jw, jb))


def test_dense_grouped_linear_checkpoint(ref, tmp_path):
    """An unquantized MoE tree (`GroupedLinear` stacks) both ways."""
    from hqq_tpu.models.serialize import load_checkpoint as j_load
    from hqq_tpu.models.serialize import save_checkpoint as j_save

    from hqq_tpu_torch.models.serialize import load_checkpoint, save_checkpoint

    r = ref["cases"]["gpt_oss"]
    save_checkpoint(str(tmp_path / "port"), r["tree"])
    jtree, _ = j_load(str(tmp_path / "port"))
    assert type(jtree["layers"][0]["mlp"]["experts"]["down_proj"]).__name__ == "GroupedLinear"
    j_save(str(tmp_path / "jax"), jtree)
    back, _ = load_checkpoint(str(tmp_path / "jax"), device="cpu")
    assert isinstance(back["layers"][0]["mlp"]["experts"]["gate_up_proj"], GroupedLinear)
    want, got = _leaves(r["tree"]), _leaves(back)
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)


def _fwd(case, cfg, paged):
    tm = _modules(case)[1]
    if paged:
        return lambda p, toks, c, pos, ptab=None: tm.forward(p, cfg, toks, c, pos,
                                                             page_indices=ptab)
    return lambda p, toks, c, pos: tm.forward(p, cfg, toks, c, pos)


@pytest.mark.parametrize("engine", ["paged", "dense"])
@pytest.mark.parametrize("case", CASES)
def test_engines_match_hqq_tpu(ref, case, engine):
    from hqq_tpu_torch.serving.batching import ContinuousBatchingEngine
    from hqq_tpu_torch.serving.paged import PagedBatchingEngine

    r = ref["cases"][case]
    if engine == "paged":
        eng = PagedBatchingEngine(r["qtree"], r["tcfg"], cache_dtype=torch.float32, device="cpu",
                                  forward_fn=_fwd(case, r["tcfg"], True), **_POOL)
    else:
        eng = ContinuousBatchingEngine(r["qtree"], r["tcfg"], batch_slots=2, max_len=64,
                                       cache_dtype=torch.float32, device="cpu",
                                       forward_fn=_fwd(case, r["tcfg"], False))
    uids = [eng.add_request(np.asarray(p), max_new_tokens=_NEW) for p in _PROMPTS]
    res = eng.run()
    eng.close()
    assert [list(res[u]) for u in uids] == r["engines"][engine]


def _dense_greedy(case, tree, cfg, prompt, n_new):
    tm = _modules(case)[1]
    cache = tl.init_cache(cfg, 1, 64, torch.float32, "cpu")
    logits, _ = tm.forward(tree, cfg, torch.tensor([prompt]), cache, 0)
    out = [int(logits[0, -1].argmax())]
    for pos in range(len(prompt), len(prompt) + n_new - 1):
        logits, _ = tm.forward(tree, cfg, torch.tensor([[out[-1]]]), cache, pos)
        out.append(int(logits[0, -1].argmax()))
    return out


@pytest.mark.parametrize("case", ["mixtral", "gpt_oss"])
def test_generator_full_matches_dense(ref, case):
    r = ref["cases"][case]
    model = HQQModel(r["qtree"], r["tcfg"], CASES[case][3], quantized=True)
    ids = model.generate(np.asarray([_PROMPTS[0]]), max_new_tokens=_NEW,
                         cache_dtype=torch.float32, device="cpu")
    assert ids[0].tolist() == _dense_greedy(case, r["qtree"], r["tcfg"], _PROMPTS[0], _NEW)


@pytest.mark.parametrize("case", CASES)
def test_prepare_and_fuse_leave_the_experts(ref, case):
    """w4a8 and `fuse_for_decode` change the attention (q/k/v joined) and a
    dense layer's MLP, never the expert stacks or the router; the fused
    tree's logits equal the unfused tree's bit for bit."""
    from hqq_tpu_torch.backends.pallas_backend import A8QuantLinear
    from hqq_tpu_torch.utils.patching import fuse_for_decode, prepare_for_inference

    r, tm = ref["cases"][case], _modules(case)[1]
    tree = prepare_for_inference(params_from_numpy(r["np_q"], "cpu"), "w4a8")
    fused = fuse_for_decode(tree)
    for layer, flayer in zip(tree["layers"], fused["layers"]):
        assert isinstance(flayer["self_attn"]["qkv_proj"], A8QuantLinear)
        block = "block_sparse_moe" if case == "mixtral" else "mlp"
        if "experts" in layer[block]:
            for n, v in layer[block]["experts"].items():
                assert isinstance(v, GroupedQuantLinear) and flayer[block]["experts"][n] is v
    toks = torch.tensor([_PROMPTS[0]])
    want, _ = tm.forward(tree, r["tcfg"], toks)
    got, _ = tm.forward(fused, r["tcfg"], toks)
    assert torch.equal(got, want)


@pytest.fixture(scope="module")
def mixtral_checkpoint(ref, tmp_path_factory):
    """hqq_tpu's quantized tiny Mixtral (fp32 compute) as its checkpoint."""
    from hqq_tpu.engine import hf as jhf

    r = ref["cases"]["mixtral"]
    path = str(tmp_path_factory.mktemp("moe_serve") / "mixtral")
    jhf.HQQModel(r["jq"], r["jcfg"], "mixtral", quantized=True).save_quantized(path)
    return path


@pytest.mark.parametrize("engine", ["paged", "dense"])
def test_serve_main_mixtral(mixtral_checkpoint, engine):
    """`serve.main` with its defaults but the engine (w4a8, fused) on a
    tiny Mixtral checkpoint written by hqq_tpu: ids equal to
    `hqq_tpu.serve.main`'s on the same checkpoint."""
    from hqq_tpu.serve import main as j_main

    from hqq_tpu_torch.serve import main as t_main

    argv = ["--model", mixtral_checkpoint, "--port", "0", "--slots", "2", "--num-pages", "32",
            "--page-size", "4", "--max-pages-per-seq", "8", "--max-len", "64",
            "--engine", engine]
    got = _engine_ids(t_main(argv + ["--device", "cpu"], serve=False).engine)
    want = _engine_ids(j_main(argv, serve=False).engine)
    assert got == want and all(len(ids) == _NEW for ids in got)


def _engine_ids(eng):
    uids = [eng.add_request(np.asarray(p), max_new_tokens=_NEW) for p in _PROMPTS]
    res = eng.run()
    return [list(map(int, res[u])) for u in uids]


@pytest.mark.parametrize("case", ["mixtral", "qwen3_moe", "gpt_oss"])
def test_expert_parallel_refused(case):
    tm = _modules(case)[1]
    with pytest.raises(NotImplementedError, match="parallel"):
        getattr(tm, CASES[case][1])(ep_axis="ep")


def test_gpt_oss_refuses_int8_pools(ref):
    """gpt-oss's dense attention reads float pools only: int8 pools are
    refused with a ValueError that names the family, by the forward and by
    the dense engine."""
    from hqq_tpu_torch.serving.batching import ContinuousBatchingEngine

    r, tm = ref["cases"]["gpt_oss"], _modules("gpt_oss")[1]
    cache = tl.init_cache(r["tcfg"], 1, 8, device="cpu", quantize_kv=True)
    with pytest.raises(ValueError, match="gpt_oss"):
        tm.forward(r["tree"], r["tcfg"], torch.tensor([[1, 2]]), cache, 0)
    with pytest.raises(ValueError, match="gpt_oss"):
        ContinuousBatchingEngine(r["tree"], r["tcfg"], batch_slots=2, max_len=32,
                                 quantize_kv=True, device="cpu",
                                 forward_fn=_fwd("gpt_oss", r["tcfg"], False))


@pytest.mark.parametrize("engine", ["paged", "dense"])
def test_gpt_oss_int8_kv_refused_by_the_server(ref, tmp_path, engine):
    """`--int8-kv` for gpt-oss is refused on either engine with a
    ValueError that names the family, before any weight is read: the
    checkpoint directory holds its config only."""
    import json

    from hqq_tpu_torch.serve import main

    ckpt = tmp_path / "gpt_oss"
    ckpt.mkdir()
    (ckpt / "hqq_config.json").write_text(json.dumps({"config": {"model_type": "gpt_oss"}}))
    argv = ["--model", str(ckpt), "--device", "cpu", "--port", "0", "--engine", engine,
            "--int8-kv"]
    with pytest.raises(ValueError, match="gpt_oss"):
        main(argv, serve=False)


@pytest.mark.parametrize("case", ["gpt_oss", "mixtral"])
def test_paged_speculative_matches_paged(case):
    """The MoE speculative path (`hqq_tpu`'s tests/test_gpt_oss.py:101):
    `SpeculativePagedEngine` with the target as its draft gives the plain
    paged engine's ids and `hqq_tpu`'s speculative engine's, through the
    width-k verify window (sinks, windows and the MoE block at T = 4)."""
    import jax
    import jax.numpy as jnp

    from hqq_tpu.serving.speculative import SpeculativePagedEngine as JSpec

    from hqq_tpu_torch.serving.paged import PagedBatchingEngine
    from hqq_tpu_torch.serving.speculative import SpeculativePagedEngine

    jm, tm = _modules(case)
    jcfg, tcfg = _tiny(jm, tm, case)
    params = jm.init_params(jcfg, jax.random.PRNGKey(7), dtype=jnp.float32)
    if case == "gpt_oss":
        for layer in params["layers"]:
            layer["self_attn"]["sinks"] = jnp.asarray([0.4, -0.2, 0.9, 0.1], jnp.float32)
    tree = params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    prompt, kw = [3, 17, 29, 5], dict(batch_slots=1, num_pages=32, page_size=4,
                                      max_pages_per_seq=8)
    fwd = _fwd(case, tcfg, True)
    plain = PagedBatchingEngine(tree, tcfg, cache_dtype=torch.float32, device="cpu",
                                forward_fn=fwd, **kw)
    u = plain.add_request(prompt, max_new_tokens=6)
    want = plain.run()[u]
    spec = SpeculativePagedEngine(tree, tree, tcfg, k_draft=3, cache_dtype=torch.float32,
                                  device="cpu", forward_fn=fwd,
                                  draft_forward_fn=_fwd(case, tcfg, False), **kw)
    v = spec.add_request(prompt, max_new_tokens=6)
    got = spec.run()[v]
    jspec = JSpec(params, params, jcfg, k_draft=3, cache_dtype=jnp.float32, **kw,
                  forward_fn=lambda p, t, c, s, ptab=None: jm.forward(p, jcfg, t, c, s,
                                                                      page_indices=ptab),
                  draft_forward_fn=lambda p, t, c, s: jm.forward(p, jcfg, t, c, s))
    w = jspec.add_request(prompt, max_new_tokens=6)
    assert got == want == list(map(int, jspec.run()[w]))
