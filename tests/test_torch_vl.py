# SPDX-License-Identifier: Apache-2.0
"""hqq_tpu_torch's vision-language models against hqq_tpu's: LLaVA
(`models.llava`), Qwen2-VL (`models.qwen2_vl`) and `engine.vl`.

hqq_tpu's tiny configs in fp32, its random weights carried across with
params_from_numpy; hqq_tpu's runs happen once, in module fixtures.

* the vision embeddings (the CLIP tower and projector of LLaVA over two
  images; the Qwen2-VL tower and merger over two images of different
  grids, whose block-diagonal mask keeps them apart) within 1e-5 of
  max|y|;
* `get_mrope_positions` and the M-RoPE angles bit-equal; `_mrope_cos_sin`
  within one ulp (torch's CPU cos and XLA's differ in the last bit of ~5%
  of the angles: the table's inputs are bit-equal);
* `HQQVLModel.generate`'s greedy ids equal to hqq_tpu's for both
  families, with and without an image, on trees hqq_tpu's
  `quantize_model` quantized (8-bit g16, both towers);
* `quantize_model` quantizes the leaves hqq_tpu's does (the patch
  embedding and the projector or merger stay in full precision), and
  `prepare_for_inference("w4a8")` puts the tower on the bf16-operand
  kernel's layout;
* a VL checkpoint crosses both packages both ways with every leaf
  bit-equal and the config equal; an unknown type is refused;
* the HF loaders against hqq_tpu's on a tiny `transformers` model's state
  dict, and a wrong placeholder count refused.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hqq_tpu.core.quantize import BaseQuantizeConfig as JConfig
from hqq_tpu.engine.vl import AutoHQQVLModel as JAuto
from hqq_tpu.engine.vl import HQQVLModel as JVL
from hqq_tpu.models import llava as jllava
from hqq_tpu.models import qwen2_vl as jqwen
from hqq_tpu_torch.core.quantize import BaseQuantizeConfig as TConfig
from hqq_tpu_torch.engine.vl import AutoHQQVLModel as TAuto
from hqq_tpu_torch.engine.vl import HQQVLModel as TVL
from hqq_tpu_torch.models import llava as tllava
from hqq_tpu_torch.models import qwen2_vl as tqwen
from hqq_tpu_torch.models.serialize import tree_to_state
from hqq_tpu_torch.utils import params_from_numpy

_TOL = 1e-5
_QWEN_GRIDS = ((1, 4, 4), (1, 4, 8))  # two images: 16 + 32 patches, 4 + 8 merged rows


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch ops on one thread: the suite's workers share the cores, and
    torch's intra-op threads would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_torch(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), "cpu")


def _llava_pixels(cfg, n, seed):
    vc = cfg.vision
    return np.random.default_rng(seed).standard_normal(
        (n, vc.num_channels, vc.image_size, vc.image_size)).astype(np.float32)


def _qwen_patches(cfg, grids, seed):
    n = sum(t * h * w for t, h, w in grids)
    return np.random.default_rng(seed).standard_normal((n, cfg.vision.patch_dim)).astype(
        np.float32)


def _llava_prompt(cfg, extra):
    return [5] + [cfg.image_token_index] * cfg.vision.num_patches + list(extra)


def _qwen_prompt(cfg, grids):
    toks = [5, 9]
    for t, h, w in grids:
        toks += [cfg.vision_start_token_id] + [cfg.image_token_id] * (t * h * w // 4) + [7]
    return toks


@pytest.fixture(scope="module")
def llava():
    """hqq_tpu's tiny LLaVA: the fp tree, the 8-bit g16 model, and its runs."""
    cfg = jllava.LlavaConfig.tiny()
    p = jllava.init_params(cfg, jax.random.PRNGKey(3), dtype=jnp.float32)
    fp = {"text": p["text"], "vision": {"vision": p["vision"], "projector": p["projector"]}}
    m = JVL(params=fp, cfg=cfg, model_type="llava").quantize_model(
        JConfig(nbits=8, group_size=16), compute_dtype=jnp.float32)
    px = _llava_pixels(cfg, 2, 0)
    toks = _llava_prompt(cfg, [7, 3])
    ref = dict(
        embeds=np.asarray(jllava.vision_forward(fp["vision"], cfg, jnp.asarray(px))),
        image_ids=m.generate(toks, pixel_values=jnp.asarray(px[:1]), max_new_tokens=8),
        text_ids=m.generate([5, 6, 7, 8], max_new_tokens=8),
    )
    return cfg, fp, m, px, toks, ref


@pytest.fixture(scope="module")
def qwen():
    """hqq_tpu's tiny Qwen2-VL: the fp tree, the 8-bit g16 model, and its runs."""
    cfg = jqwen.Qwen2VLConfig.tiny()
    fp = jqwen.init_params(cfg, jax.random.PRNGKey(1), dtype=jnp.float32)
    m = JVL(params=fp, cfg=cfg, model_type="qwen2_vl").quantize_model(
        JConfig(nbits=8, group_size=16), compute_dtype=jnp.float32)
    patches = _qwen_patches(cfg, _QWEN_GRIDS, 0)
    toks = _qwen_prompt(cfg, _QWEN_GRIDS)
    pos = jqwen.get_mrope_positions(cfg, np.asarray(toks), _QWEN_GRIDS)
    cos, sin = jqwen._mrope_cos_sin(cfg, jnp.asarray(pos))
    ref = dict(
        embeds=np.asarray(jqwen.vision_forward(fp["vision"], cfg.vision, jnp.asarray(patches),
                                               _QWEN_GRIDS)),
        pos=pos, cos=np.asarray(cos), sin=np.asarray(sin),
        image_ids=m.generate(toks, pixel_values=jnp.asarray(patches), grid_thw=_QWEN_GRIDS,
                             max_new_tokens=8),
        text_ids=m.generate([5, 6, 7, 8], max_new_tokens=8),
    )
    return cfg, fp, m, patches, toks, ref


def _close(got, want, tol=_TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, atol=tol * np.abs(want).max(), rtol=0)


def test_llava_vision_embeddings(llava):
    cfg, fp, _, px, _, ref = llava
    got = tllava.vision_forward(_to_torch(fp["vision"]), tllava.LlavaConfig.tiny(),
                                torch.from_numpy(px))
    assert got.shape == (2, cfg.vision.num_patches, cfg.text.hidden_size)  # CLS dropped
    _close(got, ref["embeds"])


def test_qwen2_vl_vision_embeddings(qwen):
    cfg, fp, _, patches, _, ref = qwen
    got = tqwen.vision_forward(_to_torch(fp["vision"]), tqwen.Qwen2VLConfig.tiny().vision,
                               torch.from_numpy(patches), _QWEN_GRIDS)
    assert got.shape == (12, cfg.vision.hidden_size)
    _close(got, ref["embeds"])
    # the mask keeps the images apart: the first image alone gives its rows
    alone = tqwen.vision_forward(_to_torch(fp["vision"]), tqwen.Qwen2VLConfig.tiny().vision,
                                 torch.from_numpy(patches[:16]), _QWEN_GRIDS[:1])
    _close(alone, ref["embeds"][:4])


def test_mrope_positions_and_tables(qwen):
    cfg, _, _, _, toks, ref = qwen
    tcfg = tqwen.Qwen2VLConfig.tiny()
    pos = tqwen.get_mrope_positions(tcfg, np.asarray(toks), _QWEN_GRIDS)
    assert pos.dtype == ref["pos"].dtype and np.array_equal(pos, ref["pos"])
    assert int(pos.max()) + 1 < len(toks)  # an image advances the streams by max(t, h, w)
    cos, sin = tqwen._mrope_cos_sin(tcfg, torch.from_numpy(pos))
    assert cos.shape == ref["cos"].shape == (1, 1, len(toks), tcfg.text.head_dim_)
    ulp = 2.0 ** -23
    for got, want in ((cos, ref["cos"]), (sin, ref["sin"])):
        np.testing.assert_allclose(got.numpy(), want, atol=ulp, rtol=0)
    # the angles the tables take are bit-equal: only the cos/sin routines differ
    hd = tcfg.text.head_dim_
    inv_t = 1.0 / (tcfg.text.rope_theta ** (torch.arange(0, hd, 2, dtype=torch.float32) / hd))
    inv_j = 1.0 / (cfg.text.rope_theta ** (jnp.arange(0, hd, 2, dtype=jnp.float32) / hd))
    ang_t = torch.from_numpy(pos)[..., None].to(torch.float32) * inv_t
    ang_j = jnp.asarray(pos)[..., None].astype(jnp.float32) * inv_j
    assert np.array_equal(ang_t.numpy(), np.asarray(ang_j))


@pytest.mark.parametrize("family", ["llava", "qwen2_vl"])
@pytest.mark.parametrize("image", [True, False], ids=["image", "text"])
def test_generate_matches_hqq_tpu(request, family, image):
    """Greedy ids of the quantized model through `HQQVLModel.generate`
    equal hqq_tpu's, token for token."""
    name = "llava" if family == "llava" else "qwen"
    cfg, _, jm, pixels, toks, ref = request.getfixturevalue(name)
    tcfg = (tllava.LlavaConfig if family == "llava" else tqwen.Qwen2VLConfig).tiny()
    tm = TVL(params=_to_torch(jm.params), cfg=tcfg, model_type=family, quantized=True)
    if not image:
        assert tm.generate([5, 6, 7, 8], max_new_tokens=8) == ref["text_ids"]
        return
    px = torch.from_numpy(pixels[:1] if family == "llava" else pixels)
    grid = _QWEN_GRIDS if family == "qwen2_vl" else None
    got = tm.generate(toks, pixel_values=px, grid_thw=grid, max_new_tokens=8)
    assert got == ref["image_ids"] and got != ref["text_ids"]


def _structure_types(tree):
    """{path: node type} of a tree's serialized structure."""
    _, structure = tree_to_state(tree)
    out = {}

    def walk(node, path):
        out[path] = node["type"]
        ch = node.get("children") or {}
        for k, v in (ch.items() if isinstance(ch, dict) else enumerate(ch)):
            walk(v, f"{path}.{k}")

    walk(structure, "")
    return out


@pytest.mark.parametrize("family", ["llava", "qwen2_vl"])
def test_quantize_and_prepare_leaves(request, family):
    """The port's quantize_model quantizes the leaves hqq_tpu's does, the
    patch embedding and the projector or merger kept in full precision;
    prepare_for_inference("w4a8") puts the text on w4a8 and the tower on
    the bf16-operand kernel's layout."""
    from hqq_tpu_torch.backends.pallas_backend import A8QuantLinear, PallasQuantLinear

    cfg, fp, jm, *_ = request.getfixturevalue("llava" if family == "llava" else "qwen")
    tcfg = (tllava.LlavaConfig if family == "llava" else tqwen.Qwen2VLConfig).tiny()
    tm = TVL(params=_to_torch(fp), cfg=tcfg, model_type=family)
    tm.quantize_model(TConfig(nbits=4, group_size=16), compute_dtype=torch.float32)
    assert _structure_types(tm.params) == _structure_types(_to_torch(jm.params))
    fp_tags = ("patch_proj", "linear_1", "linear_2", "patch_embed", "merger_fc1", "merger_fc2")
    types = _structure_types(tm.params)
    assert {types[p] for p in types if p.rsplit(".", 1)[-1] in fp_tags} == {"Linear"}
    with pytest.raises(RuntimeError, match="already"):
        tm.quantize_model()
    tm.prepare_for_inference("w4a8")
    text, vision = tm.params["text"], tm.params["vision"]
    assert isinstance(text["layers"][0]["self_attn"]["q_proj"], A8QuantLinear)
    block = vision["vision"]["layers"][0] if family == "llava" else vision["blocks"][0]
    lin = block["q_proj"] if family == "llava" else block["attn_qkv"]
    assert type(lin) is PallasQuantLinear


@pytest.mark.parametrize("family", ["llava", "qwen2_vl"])
def test_checkpoint_across_packages(request, tmp_path, family):
    """hqq_tpu's save_quantized -> the port's from_quantized and the
    reverse: every leaf bit-equal, the configs equal."""
    cfg, _, jm, *_ = request.getfixturevalue("llava" if family == "llava" else "qwen")
    jm.save_quantized(str(tmp_path / "jax"))
    tm = TAuto.from_quantized(str(tmp_path / "jax"), device="cpu")
    assert tm.model_type == family and tm.quantized
    assert dataclasses.asdict(tm.cfg) == dataclasses.asdict(cfg)
    want, _ = tree_to_state(_to_torch(jm.params))
    got, _ = tree_to_state(tm.params)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    tm.save_quantized(str(tmp_path / "torch"))
    back = JAuto.from_quantized(str(tmp_path / "torch"))
    assert back.model_type == family and back.cfg == cfg
    flat_back, _ = tree_to_state(_to_torch(back.params))
    for k in want:
        assert torch.equal(flat_back[k], want[k]), k


def test_aria_and_unknown_types_refused():
    """Aria is ported (tests/test_torch_aria.py) and no longer refused; a
    type neither package knows is."""
    from hqq_tpu_torch.models import aria as taria

    assert TVL(params={}, cfg=taria.AriaConfig.tiny(), model_type="aria").model_type == "aria"
    with pytest.raises(ValueError, match="not supported"):
        TVL(params={}, cfg=tllava.LlavaConfig.tiny(), model_type="idefics")


def test_splice_checks_the_placeholder_count(llava):
    cfg, fp, _, px, toks, _ = llava
    tcfg = tllava.LlavaConfig.tiny()
    tree = _to_torch(fp)
    img = tllava.vision_forward(tree["vision"], tcfg, torch.from_numpy(px[:1]))[0]
    ids = torch.tensor([toks])
    emb = tllava.embed_multimodal(tree, tcfg, ids, img)
    want = np.asarray(jllava.embed_multimodal(
        {"text": fp["text"]}, cfg, jnp.asarray([toks]), jnp.asarray(img.numpy())))
    assert np.array_equal(emb.numpy(), want)
    with pytest.raises(ValueError, match="placeholders"):  # 16 placeholders, 15 rows
        tllava.embed_multimodal(tree, tcfg, ids, img[:-1])
    with pytest.raises(ValueError, match="placeholders"):
        tqwen.embed_multimodal(tree["text"], tqwen.Qwen2VLConfig.tiny(), ids, img[:-1])


def _hf_llava():
    transformers = pytest.importorskip("transformers")
    vision = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=3,
                  num_attention_heads=4, image_size=16, patch_size=4, projection_dim=32,
                  vocab_size=10)
    text = dict(vocab_size=256, hidden_size=64, intermediate_size=48, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256,
                rope_theta=10000.0, tie_word_embeddings=False)
    hf_cfg = transformers.LlavaConfig(vision_config=vision, text_config=text,
                                      image_token_index=254, vision_feature_layer=-2,
                                      vision_feature_select_strategy="default")
    torch.manual_seed(0)
    model = transformers.LlavaForConditionalGeneration(hf_cfg).eval().float()
    return hf_cfg.to_dict(), dict(model.state_dict())


def _hf_qwen2_vl():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.Qwen2VLConfig(
        vision_config=dict(depth=2, embed_dim=64, hidden_size=64, num_heads=4, patch_size=4,
                           mlp_ratio=2, in_channels=3, temporal_patch_size=2,
                           spatial_merge_size=2),
        text_config=dict(vocab_size=256, hidden_size=64, intermediate_size=96,
                         num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                         rope_scaling={"type": "mrope", "mrope_section": [4, 2, 2]}),
        vocab_size=256, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2,
        rope_scaling={"type": "mrope", "mrope_section": [4, 2, 2]},
        image_token_id=254, video_token_id=253, vision_start_token_id=252)
    torch.manual_seed(0)
    model = transformers.Qwen2VLForConditionalGeneration(hf_cfg).eval().float()
    return hf_cfg.to_dict(), dict(model.state_dict())


@pytest.mark.parametrize("family", ["llava", "qwen2_vl"])
def test_hf_state_dict_loaders(family):
    """Both packages' loaders read one HF state dict into equal trees."""
    hf, state = _hf_llava() if family == "llava" else _hf_qwen2_vl()
    jmod, tmod = (jllava, tllava) if family == "llava" else (jqwen, tqwen)
    jcfg = (jllava.LlavaConfig if family == "llava" else jqwen.Qwen2VLConfig).from_hf(hf)
    tcfg = (tllava.LlavaConfig if family == "llava" else tqwen.Qwen2VLConfig).from_hf(hf)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jtext, jvision = jmod.params_from_hf_state_dict(state, jcfg, jnp.float32)
    ttext, tvision = tmod.params_from_hf_state_dict(state, tcfg, torch.float32)
    for got, want in ((ttext, jtext), (tvision, jvision)):
        g, _ = tree_to_state(got)
        w, _ = tree_to_state(_to_torch(want))
        assert set(g) == set(w)
        for k in w:
            assert torch.equal(g[k], w[k]), k
