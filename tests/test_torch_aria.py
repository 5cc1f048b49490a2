# SPDX-License-Identifier: Apache-2.0
"""hqq_tpu_torch's Aria (`models.aria`, `engine.vl`) against hqq_tpu's, on
the CPU.

hqq_tpu's tiny config with two ``patch_to_query`` entries (16 patches -> 4
queries, 4 -> 2), its random fp32 weights with every bias and norm weight
drawn anew (init leaves them 0 and 1), carried across with
params_from_numpy; hqq_tpu's runs happen once, jitted, in a module fixture.
Bars: 1e-5 of max|y| in fp32.

* `_position_ids` bit-equal (side 4, whose buckets repeat rows, and 70);
* the tower, the projector over both entries, and `encode_images`; an
  image of a patch count the config does not know is a ValueError;
* `_moe_block` at the default capacity factor, at one that drops
  assignments, and at E / top_k, with every dispatch equal to hqq_tpu's;
* the text logits with and without a cache (prefill and a decode step),
  and the multimodal logits over the spliced image rows;
* greedy ids through `HQQVLModel.generate` (4-bit g64) equal to
  hqq_tpu's, with and without an image;
* the dense engine with `aria.forward` as its forward hooks: ids equal to
  hqq_tpu's engine with the same hooks;
* `quantize_model`'s leaves as hqq_tpu's (the router, lm_head, the tower
  and the projector in full precision); checkpoints both ways, every leaf
  bit-equal (hqq_tpu's `AutoHQQVLModel.from_quantized` cannot build an
  Aria config, from either package's checkpoint: its checkpoint reader is
  held to the port's instead); `from_pretrained` of an HF-named directory
  written here;
* `serve.main` on an Aria directory exits with hqq_tpu's SystemExit text
  for VL types (`hqq_tpu.serve` itself does not detect Aria as one).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hqq_tpu.core.quantize import BaseQuantizeConfig as JConfig
from hqq_tpu.engine.vl import AutoHQQVLModel as JAuto
from hqq_tpu.engine.vl import HQQVLModel as JVL
from hqq_tpu.models import aria as jaria
from hqq_tpu.nn import moe as jmoe
from hqq_tpu.serving.batching import ContinuousBatchingEngine as JEngine
from hqq_tpu_torch.core.quantize import BaseQuantizeConfig as TConfig
from hqq_tpu_torch.engine import vl as tvl
from hqq_tpu_torch.engine.vl import AutoHQQVLModel as TAuto
from hqq_tpu_torch.engine.vl import HQQVLModel as TVL
from hqq_tpu_torch.models import aria as taria
from hqq_tpu_torch.models._safetensors import save_file
from hqq_tpu_torch.models.serialize import tree_to_state
from hqq_tpu_torch.nn import moe as tmoe
from hqq_tpu_torch.serving.batching import ContinuousBatchingEngine as TEngine
from hqq_tpu_torch.utils import params_from_numpy

_TOL = 1e-5
_NEW = 8
_IMAGE_PROMPT = [5] + [254] * 4 + [7, 3, 9]
_TEXT_PROMPT = [5, 6, 7, 8, 9, 10, 11, 12]  # the image prompt's length: one compile
_ENGINE_TEXT = [[11, 12, 13, 14], [200, 31, 7]]  # one prefill bucket (4)
# the MoE block's cases: (experts, capacity factor); 8 experts top-2 gives
# E / top_k = 4.0, 0.5 drops assignments for sure
_MOE_CASES = {"default": (8, 2.0), "drops": (8, 0.5), "E/top_k": (8, 4.0)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch ops on one thread: the suite's workers share the cores, and
    torch's intra-op threads would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg():
    return dataclasses.replace(jaria.AriaConfig.tiny(), patch_to_query=((4, 2), (16, 4)))


def _tcfg(jcfg):
    return tvl._cfg_from_dict(json.loads(json.dumps(dataclasses.asdict(jcfg))), "aria")


def _to_torch(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), "cpu")


def _perturbed(tree, seed: int):
    """Every bias N(0, 0.1^2) and every norm weight 1 + N(0, 0.1^2): numpy
    draws into hqq_tpu's tree."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape, dt = np.shape(leaf), np.asarray(leaf).dtype
        if name.endswith("bias") or name.endswith("bias']"):
            return jnp.asarray(rng.standard_normal(shape).astype(np.float32) * 0.1, dt)
        if "norm" in name:
            return jnp.asarray((1 + rng.standard_normal(shape) * 0.1).astype(np.float32), dt)
        return leaf

    return jax.tree_util.tree_map_with_path(draw, tree)


def _pixels(n, side, seed):
    return np.random.default_rng(seed).standard_normal((n, 3, side, side)).astype(np.float32)


def _split(full):
    return {"text": full["text"], "vision": {"vision": full["vision"],
                                             "projector": full["projector"]}}


def _embeds_fns(module, tcfg):
    """The dense engine's forward hooks for Aria, as a user of the Python
    API builds them from ``module.forward``."""
    def fwd(p, toks, cache, pos):
        return module.forward(p, tcfg, toks, cache, pos)

    def efwd(p, emb, cache, pos):
        return module.forward(p, tcfg, None, cache, pos, inputs_embeds=emb)

    return fwd, efwd


def _run_engine(engine_cls, params, tcfg, module, embeds, **kw):
    """Greedy ids of the image request (its spliced rows as inputs_embeds)
    and two text requests through a 2-slot dense engine."""
    fwd, efwd = _embeds_fns(module, tcfg)
    eng = engine_cls(params, tcfg, batch_slots=2, max_len=64, forward_fn=fwd,
                     embeds_forward_fn=efwd, **kw)
    uids = [eng.add_request(np.asarray(_IMAGE_PROMPT), max_new_tokens=_NEW,
                            inputs_embeds=embeds)]
    uids += [eng.add_request(np.asarray(p), max_new_tokens=_NEW) for p in _ENGINE_TEXT]
    out = eng.run()
    eng.close()
    return [list(map(int, out[u])) for u in uids]


@pytest.fixture(scope="module")
def ref():
    """hqq_tpu's trees (fp32 and 4-bit g64) and its runs."""
    cfg = _jcfg()
    init = jax.jit(jaria.init_params, static_argnums=(0, 2))
    full = _perturbed(init(cfg, jax.random.PRNGKey(3), jnp.float32), 3)
    big, small = _pixels(2, 16, 0), _pixels(1, 8, 1)
    toks = np.random.default_rng(2).integers(0, 250, (2, 12)).astype(np.int32)
    vis = {"vision": full["vision"], "projector": full["projector"]}

    fwd = jax.jit(jaria.forward, static_argnums=1)
    tower = jax.jit(jaria._tower_forward, static_argnums=1)
    vision = jax.jit(jaria.vision_forward, static_argnums=1)
    cache = jaria.init_cache(cfg, 2, 16, jnp.float32)
    nocache, _ = fwd(full, cfg, jnp.asarray(toks))
    prefill, cache = fwd(full, cfg, jnp.asarray(toks), cache, 0)
    step, _ = fwd(full, cfg, jnp.asarray(toks[:, :1]), cache, 12)
    img = vision(vis, cfg, jnp.asarray(big[:1])).reshape(-1, cfg.text.hidden_size)
    mm_emb = jaria.embed_multimodal(full, cfg, jnp.asarray([_IMAGE_PROMPT]), img)
    mm, _ = fwd(full, cfg, None, jaria.init_cache(cfg, 1, 16, jnp.float32), 0,
                inputs_embeds=mm_emb)

    moe = {}
    x = np.random.default_rng(4).standard_normal((2, 16, cfg.text.hidden_size)).astype(
        np.float32)

    def moe_ref(mlp, mcfg, x):
        """The block's output and its dispatch (the router's softmax, then
        moe_dispatch at the block's capacity)."""
        xf = x.reshape(-1, x.shape[-1])
        probs = jax.nn.softmax(mlp["router"](xf).astype(jnp.float32), axis=-1)
        t, e, k = xf.shape[0], mcfg.moe_num_experts, mcfg.moe_topk
        capacity = max(int(-(-(t * k / e * mcfg.capacity_factor) // 1)), 1)
        return jaria._moe_block(mlp, mcfg, x), jmoe.moe_dispatch(probs, k, capacity)[0]

    moe_jit = jax.jit(moe_ref, static_argnums=1)
    for name, (e, cf) in _MOE_CASES.items():
        mcfg = dataclasses.replace(cfg.text, moe_num_experts=e, capacity_factor=cf)
        mlp = _perturbed(init(dataclasses.replace(cfg, text=mcfg), jax.random.PRNGKey(7),
                              jnp.float32)["text"]["layers"][0]["mlp"], 7)
        y, dispatch = moe_jit(mlp, mcfg, jnp.asarray(x))
        moe[name] = dict(cfg=mcfg, mlp=mlp, y=np.asarray(y), dispatch=np.asarray(dispatch))

    jm = JVL(params=_split(full), cfg=cfg, model_type="aria").quantize_model(
        JConfig(nbits=4, group_size=64), compute_dtype=jnp.float32)
    q_img = jm.encode_images(jnp.asarray(big[:1]))
    q_emb = jaria.embed_multimodal(jm.params, cfg, jnp.asarray([_IMAGE_PROMPT]), q_img)
    return dict(
        cfg=cfg, full=full, big=big, small=small, toks=toks, moe=moe, x=x, jm=jm,
        tower=np.asarray(tower(vis, cfg, jnp.asarray(big))),
        vision_big=np.asarray(vision(vis, cfg, jnp.asarray(big))),
        vision_small=np.asarray(vision(vis, cfg, jnp.asarray(small))),
        nocache=np.asarray(nocache), prefill=np.asarray(prefill), step=np.asarray(step),
        mm=np.asarray(mm), mm_emb=np.asarray(mm_emb),
        image_ids=jm.generate(_IMAGE_PROMPT, pixel_values=jnp.asarray(big[:1]),
                              max_new_tokens=_NEW),
        text_ids=jm.generate(_TEXT_PROMPT, max_new_tokens=_NEW),
        engine_ids=_run_engine(JEngine, jm.params["text"], cfg.text, jaria,
                               np.asarray(q_emb[0]), cache_dtype=jnp.float32),
        q_emb=np.asarray(q_emb),
    )


def _close(got, want, tol=_TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("side,n", [(4, 4), (4, 2), (70, 70), (70, 35)])
def test_position_ids_bit_equal(side, n):
    got, want = taria._position_ids(side, n, n), jaria._position_ids(side, n, n)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    if (side, n) == (4, 4):  # not the identity: rows repeat
        assert got.reshape(4, 4)[0].tolist() == [0, 0, 1, 2]


def test_tower(ref):
    tcfg = _tcfg(ref["cfg"])
    vis = _to_torch({"vision": ref["full"]["vision"], "projector": ref["full"]["projector"]})
    _close(taria._tower_forward(vis, tcfg, torch.from_numpy(ref["big"])), ref["tower"])


@pytest.mark.parametrize("which", ["big", "small"])
def test_projector_both_entries(ref, which):
    """Both patch_to_query entries: 16 patches -> 4 queries, 4 -> 2."""
    tcfg = _tcfg(ref["cfg"])
    vis = _to_torch({"vision": ref["full"]["vision"], "projector": ref["full"]["projector"]})
    got = taria.vision_forward(vis, tcfg, torch.from_numpy(ref[which]))
    assert got.shape[1] == {"big": 4, "small": 2}[which]
    _close(got, ref[f"vision_{which}"])


def test_encode_images_and_unknown_patch_count(ref):
    tcfg = _tcfg(ref["cfg"])
    tm = TVL(params=_to_torch(_split(ref["full"])), cfg=tcfg, model_type="aria")
    rows = tm.encode_images(torch.from_numpy(ref["big"]))
    assert rows.shape == (8, tcfg.text.hidden_size)
    _close(rows, ref["vision_big"].reshape(8, -1))
    with pytest.raises(ValueError, match=r"9 patches.*\[4, 16\]"):
        tm.encode_images(torch.from_numpy(_pixels(1, 12, 5)))


@pytest.mark.parametrize("case", list(_MOE_CASES))
def test_moe_block(ref, case, monkeypatch):
    r = ref["moe"][case]
    tcfg = taria.AriaTextConfig(**dataclasses.asdict(r["cfg"]))
    disp = []
    inner = tmoe.moe_dispatch

    def rec(*a, **k):
        d, c = inner(*a, **k)
        disp.append(d.numpy())
        return d, c

    monkeypatch.setattr(tmoe, "moe_dispatch", rec)
    y = taria._moe_block(_to_torch(r["mlp"]), tcfg, torch.from_numpy(ref["x"]))
    assert np.array_equal(disp[0], r["dispatch"])
    kept, asked = int(disp[0].sum()), ref["x"].shape[0] * ref["x"].shape[1] * tcfg.moe_topk
    assert (kept < asked) == (case == "drops")
    _close(y, r["y"])


def test_text_logits(ref):
    tcfg = _tcfg(ref["cfg"])
    tree = _to_torch(ref["full"])
    toks = torch.from_numpy(ref["toks"]).long()
    _close(taria.forward(tree, tcfg, toks)[0], ref["nocache"])
    cache = taria.init_cache(tcfg, 2, 16, torch.float32, "cpu")
    logits, cache = taria.forward(tree, tcfg, toks, cache, 0)
    _close(logits, ref["prefill"])
    _close(taria.forward(tree, tcfg, toks[:, :1], cache, 12)[0], ref["step"])


def test_multimodal_logits(ref):
    tcfg = _tcfg(ref["cfg"])
    tree = _to_torch(ref["full"])
    img = taria.vision_forward(tree, tcfg, torch.from_numpy(ref["big"][:1]))[0]
    emb = taria.embed_multimodal(tree, tcfg, torch.tensor([_IMAGE_PROMPT]), img)
    _close(emb, ref["mm_emb"])
    with pytest.raises(ValueError, match="placeholders"):
        taria.embed_multimodal(tree, tcfg, torch.tensor([_IMAGE_PROMPT]), img[:-1])
    logits, _ = taria.forward(tree, tcfg, None, taria.init_cache(tcfg, 1, 16, torch.float32,
                                                                 "cpu"), 0, inputs_embeds=emb)
    _close(logits, ref["mm"])


@pytest.mark.parametrize("image", [True, False], ids=["image", "text"])
def test_generate_matches_hqq_tpu(ref, image):
    tm = TVL(params=_to_torch(ref["jm"].params), cfg=_tcfg(ref["cfg"]), model_type="aria",
             quantized=True)
    if not image:
        assert tm.generate(_TEXT_PROMPT, max_new_tokens=_NEW) == ref["text_ids"]
        return
    got = tm.generate(_IMAGE_PROMPT, pixel_values=torch.from_numpy(ref["big"][:1]),
                      max_new_tokens=_NEW)
    assert got == ref["image_ids"] and got != ref["text_ids"]


def test_dense_engine_with_aria_hooks(ref):
    """The port's dense engine with `aria.forward` as forward_fn and
    embeds_forward_fn gives hqq_tpu's engine's ids with the same hooks: an
    image request beside two text requests, 2 slots (one refills)."""
    tcfg = _tcfg(ref["cfg"])
    got = _run_engine(TEngine, _to_torch(ref["jm"].params["text"]), tcfg.text, taria,
                      torch.from_numpy(ref["q_emb"][0]), cache_dtype=torch.float32,
                      device="cpu")
    assert got == ref["engine_ids"]
    assert got[0][:_NEW] == ref["image_ids"]


def _structure_types(tree):
    _, structure = tree_to_state(tree)
    out = {}

    def walk(node, path):
        out[path] = node["type"]
        ch = node.get("children") or {}
        for k, v in (ch.items() if isinstance(ch, dict) else enumerate(ch)):
            walk(v, f"{path}.{k}")

    walk(structure, "")
    return out


def test_quantize_model_leaves(ref):
    """quantize_model goes through quantize_aria: the same node types as
    hqq_tpu's at every path (the router, lm_head, the tower and the
    projector in full precision, the stacks grouped and quantized)."""
    tm = TVL(params=_to_torch(_split(ref["full"])), cfg=_tcfg(ref["cfg"]), model_type="aria")
    tm.quantize_model(TConfig(nbits=4, group_size=64), compute_dtype=torch.float32)
    types = _structure_types(tm.params)
    assert types == _structure_types(_to_torch(ref["jm"].params))
    layer = ".text.layers.0.mlp"
    assert types[f"{layer}.router"] == "Linear" and types[".text.lm_head"] == "Linear"
    assert types[f"{layer}.experts.fc1"] == "GroupedQuantLinear"
    assert types[f"{layer}.shared_experts.down_proj"] == "QuantLinear"
    assert {v for k, v in types.items() if k.startswith(".vision.")} == {"dict", "list",
                                                                          "Linear", "array",
                                                                          "none"}
    with pytest.raises(RuntimeError, match="already"):
        tm.quantize_model()


def test_checkpoint_across_packages(ref, tmp_path):
    jm = ref["jm"]
    jm.save_quantized(str(tmp_path / "jax"))
    tm = TAuto.from_quantized(str(tmp_path / "jax"), device="cpu")
    assert tm.model_type == "aria" and tm.quantized
    assert dataclasses.asdict(tm.cfg) == dataclasses.asdict(ref["cfg"])
    want, _ = tree_to_state(_to_torch(jm.params))
    got, _ = tree_to_state(tm.params)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    # the port's checkpoint read back by hqq_tpu's checkpoint reader. Its
    # AutoHQQVLModel.from_quantized cannot build an Aria config (it makes a
    # LlamaConfig of the text config, MoE fields included, before it looks
    # at the model type), not even from its own checkpoint: a reference
    # fault the port's `_cfg_from_dict` does not share
    from hqq_tpu.models.base import from_quantized as j_from_quantized

    tm.save_quantized(str(tmp_path / "torch"))
    params, config = j_from_quantized(str(tmp_path / "torch"))
    assert config["model_type"] == "aria"
    assert config["vl_config"] == json.loads(json.dumps(dataclasses.asdict(ref["cfg"])))
    flat_back, _ = tree_to_state(_to_torch(params))
    assert set(flat_back) == set(want)
    for k in want:
        assert torch.equal(flat_back[k], want[k]), k
    for path in ("jax", "torch"):
        with pytest.raises(TypeError, match="moe_num_experts"):
            JAuto.from_quantized(str(tmp_path / path))


def _hf_state(full) -> dict:
    """hqq_tpu's fp tree under HF AriaForConditionalGeneration's names (the
    experts [E, in, out], the patch projection as a convolution)."""
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    state = {}

    def lin(name, layer):
        state[f"{name}.weight"] = t(layer.weight)
        if layer.bias is not None:
            state[f"{name}.bias"] = t(layer.bias)

    def ln(name, p):
        state[f"{name}.weight"], state[f"{name}.bias"] = t(p["weight"]), t(p["bias"])

    text, vision, proj = full["text"], full["vision"], full["projector"]
    lm = "model.language_model"
    state[f"{lm}.embed_tokens.weight"] = t(text["embed_tokens"])
    state[f"{lm}.norm.weight"] = t(text["norm"])
    lin("lm_head", text["lm_head"])
    for i, layer in enumerate(text["layers"]):
        p = f"{lm}.layers.{i}"
        for n in "qkvo":
            lin(f"{p}.self_attn.{n}_proj", layer["self_attn"][f"{n}_proj"])
        mlp = layer["mlp"]
        lin(f"{p}.mlp.router", mlp["router"])
        for n in ("fc1", "fc2"):
            state[f"{p}.mlp.experts.{n}.weight"] = t(np.swapaxes(
                np.asarray(mlp["experts"][n].weight), 1, 2))
        for n in ("gate", "up", "down"):
            lin(f"{p}.mlp.shared_experts.{n}_proj", mlp["shared_experts"][f"{n}_proj"])
        state[f"{p}.input_layernorm.weight"] = t(layer["input_layernorm"])
        state[f"{p}.post_attention_layernorm.weight"] = t(layer["post_attention_layernorm"])
    vt = "model.vision_tower"
    w = np.asarray(vision["patch_proj"].weight)
    state[f"{vt}.embeddings.patch_embedding.weight"] = t(w.reshape(w.shape[0], 3, 4, 4))
    state[f"{vt}.embeddings.patch_embedding.bias"] = t(vision["patch_proj"].bias)
    state[f"{vt}.embeddings.position_embedding.weight"] = t(vision["position_embeddings"])
    for i, layer in enumerate(vision["layers"]):
        p = f"{vt}.encoder.layers.{i}"
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            lin(f"{p}.self_attn.{n}", layer[n])
        lin(f"{p}.mlp.fc1", layer["fc1"])
        lin(f"{p}.mlp.fc2", layer["fc2"])
        ln(f"{p}.layer_norm1", layer["layer_norm1"])
        ln(f"{p}.layer_norm2", layer["layer_norm2"])
    mp, ca = "model.multi_modal_projector", proj["cross_attn"]
    state[f"{mp}.query"] = t(proj["query"])
    for n in ("q_proj", "k_proj", "v_proj", "linear"):
        lin(f"{mp}.cross_attn.{n}", ca[n])
    state[f"{mp}.cross_attn.multihead_attn.in_proj_weight"] = t(ca["in_proj"].weight)
    state[f"{mp}.cross_attn.multihead_attn.in_proj_bias"] = t(ca["in_proj"].bias)
    lin(f"{mp}.cross_attn.multihead_attn.out_proj", ca["out_proj"])
    ln(f"{mp}.cross_attn.layer_norm", ca["layer_norm"])
    ln(f"{mp}.cross_attn.layer_norm_kv", ca["layer_norm_kv"])
    ln(f"{mp}.layer_norm", proj["layer_norm"])
    lin(f"{mp}.feed_forward.linear_in", proj["linear_in"])
    lin(f"{mp}.feed_forward.linear_out", proj["linear_out"])
    return state


def _hf_config(cfg) -> dict:
    text = {k: v for k, v in dataclasses.asdict(cfg.text).items()
            if k not in ("capacity_factor", "ep_axis", "rope_scaling")}
    return {"model_type": "aria", "text_config": text,
            "vision_config": dataclasses.asdict(cfg.vision),
            "image_token_index": cfg.image_token_index,
            "projector_patch_to_query_dict": {str(k): v for k, v in cfg.patch_to_query}}


def test_from_pretrained(ref, tmp_path):
    """An HF-named directory written here: both packages read it into the
    tree it was written from, every tensor bit-equal, and equal configs."""
    save_file(_hf_state(ref["full"]), str(tmp_path / "model.safetensors"))
    (tmp_path / "config.json").write_text(json.dumps(_hf_config(ref["cfg"])))
    tm = TAuto.from_pretrained(str(tmp_path), compute_dtype=torch.float32, device="cpu")
    jm = JAuto.from_pretrained(str(tmp_path), compute_dtype=jnp.float32)
    assert tm.model_type == "aria" and not tm.quantized
    assert dataclasses.asdict(tm.cfg) == dataclasses.asdict(jm.cfg)
    assert tm.cfg.patch_to_query == ref["cfg"].patch_to_query
    want, _ = tree_to_state(_to_torch(_split(ref["full"])))
    for got in (tree_to_state(tm.params)[0], tree_to_state(_to_torch(jm.params))[0]):
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k


def test_serve_exits_with_hqq_tpus_message(tmp_path):
    """The port's serve.main refuses an Aria directory with the SystemExit
    hqq_tpu.serve gives a VL type it serves through the Python API, word for
    word; hqq_tpu.serve itself does not detect Aria (`_detect_vl` knows
    llava and qwen2_vl) and fails later, at the architecture lookup."""
    from hqq_tpu.serve import main as j_main
    from hqq_tpu_torch.serve import main as t_main

    for name in ("aria", "qwen2_vl"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "config.json").write_text(json.dumps({"model_type": name}))
    with pytest.raises(SystemExit) as want:
        j_main(["--model", str(tmp_path / "qwen2_vl")], serve=False)
    with pytest.raises(SystemExit) as got:
        t_main(["--model", str(tmp_path / "aria"), "--device", "cpu"], serve=False)
    assert str(got.value) == str(want.value).replace("'qwen2_vl'", "'aria'")
    with pytest.raises(AssertionError, match="'aria' not supported"):
        j_main(["--model", str(tmp_path / "aria")], serve=False)


def test_ep_axis_refused():
    with pytest.raises(NotImplementedError, match="expert parallelism"):
        taria.AriaTextConfig(ep_axis="ep")

