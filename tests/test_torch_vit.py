# SPDX-License-Identifier: Apache-2.0
"""hqq_tpu_torch's ViT (`models.vit`) and vision engine (`engine.vision`)
against hqq_tpu's, on the CPU.

hqq_tpu's tiny ViT (2 layers at 64, patches of 8 over 32 x 32 images, 10
labels), its random fp32 weights with every bias and LayerNorm weight drawn
anew, carried across with params_from_numpy; hqq_tpu's runs happen once,
jitted where they can be, in a module fixture. Bars: 1e-5 of max|y| in
fp32; in bf16 compute 2^-6 of max|y|, two bf16 ulps of the largest logit
(the logits come out in bf16, and the two packages round the bf16
products and sums in another order).

* logits and hidden states with the "cls" and "mean" pools;
* `HQQVisionModel` quantized at 4-bit g64 in fp32 and in bf16: its
  forward as hqq_tpu's, unprepared and under the "pallas" and "w4a8"
  backends; the leaves it quantizes as hqq_tpu's (the patch projection and
  the classifier stay in full precision), codes and meta at the
  reference's bars (the bf16 case holds initial zeros of exactly 7.5,
  which the port's scale once missed by a rounding);
* checkpoints both ways, every leaf bit-equal, the configs equal;
* `from_pretrained` of HF-named directories written here, with the
  ``vit.`` prefix and a classifier and without both.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hqq_tpu.core.quantize import BaseQuantizeConfig as JConfig
from hqq_tpu.engine.vision import AutoHQQVisionModel as JAuto
from hqq_tpu.engine.vision import HQQVisionModel as JVision
from hqq_tpu.models import vit as jvit
from hqq_tpu_torch.core.quantize import BaseQuantizeConfig as TConfig
from hqq_tpu_torch.engine.vision import AutoHQQVisionModel as TAuto
from hqq_tpu_torch.engine.vision import HQQtimm
from hqq_tpu_torch.engine.vision import HQQVisionModel as TVision
from hqq_tpu_torch.models import vit as tvit
from hqq_tpu_torch.models._safetensors import save_file
from hqq_tpu_torch.models.serialize import tree_to_state
from hqq_tpu_torch.utils import params_from_numpy

_TOL = {"fp32": 1e-5, "bf16": 2.0**-6}
_DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
_BACKENDS = ("xla", "pallas", "w4a8")


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


def _tcfg(jcfg):
    return tvit.ViTConfig(**dataclasses.asdict(jcfg))


def _perturbed(tree, seed: int):
    """Every bias N(0, 0.1^2) and every LayerNorm weight 1 + N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape, dt = np.shape(leaf), np.asarray(leaf).dtype
        if name.endswith("bias") or name.endswith("bias']"):
            return jnp.asarray(rng.standard_normal(shape).astype(np.float32) * 0.1, dt)
        if "layernorm" in name:
            return jnp.asarray((1 + rng.standard_normal(shape) * 0.1).astype(np.float32), dt)
        return leaf

    return jax.tree_util.tree_map_with_path(draw, tree)


@pytest.fixture(scope="module")
def ref():
    """hqq_tpu's trees and runs: the fp32 model's logits and hidden states
    under both pools; per compute type the quantized model and its logits
    on each backend."""
    cfg = jvit.ViTConfig.tiny()
    fp = _perturbed(jax.jit(jvit.init_params, static_argnums=(0, 2))(
        cfg, jax.random.PRNGKey(1), jnp.float32), 1)
    px = np.random.default_rng(0).standard_normal((3, 3, 32, 32)).astype(np.float32)
    fwd = jax.jit(jvit.forward, static_argnums=(1, 3))
    out = dict(cfg=cfg, fp=fp, px=px, pools={}, quant={})
    for pool in ("cls", "mean"):
        logits, hidden = fwd(fp, cfg, jnp.asarray(px), pool)
        out["pools"][pool] = (np.asarray(logits), np.asarray(hidden))
    for name, (jdt, _) in _DTYPES.items():
        tree = jax.tree_util.tree_map(lambda a: a.astype(jdt), fp)
        jm = JVision(params=tree, cfg=cfg).quantize_model(JConfig(nbits=4, group_size=64),
                                                          compute_dtype=jdt)
        logits = {}
        for backend in _BACKENDS:
            m = JVision(params=jm.params, cfg=cfg, quantized=True)
            if backend != "xla":
                m.prepare_for_inference(backend)
            logits[backend] = np.asarray(m(jnp.asarray(px, jdt))[0].astype(jnp.float32))
        out["quant"][name] = (jm, logits)
    return out


def _close(got, want, tol=_TOL["fp32"]):
    got = got.detach().to(torch.float32).numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("pool", ["cls", "mean"])
def test_logits_and_hidden(ref, pool):
    logits, hidden = tvit.forward(_to_torch(ref["fp"]), _tcfg(ref["cfg"]),
                                  torch.from_numpy(ref["px"]), pool)
    want_logits, want_hidden = ref["pools"][pool]
    assert hidden.shape == (3, 17, 64) and logits.shape == (3, 10)
    _close(hidden, want_hidden)
    _close(logits, want_logits)


def test_without_classifier_the_pooled_rows_come_back(ref):
    tree = _to_torch(ref["fp"])
    tree["classifier"] = None
    pooled, hidden = tvit.forward(tree, _tcfg(ref["cfg"]), torch.from_numpy(ref["px"]), "mean")
    assert torch.equal(pooled, hidden.mean(dim=1))


@pytest.mark.parametrize("backend", _BACKENDS)
@pytest.mark.parametrize("dtype", list(_DTYPES))
def test_quantized_engine_matches_hqq_tpu(ref, dtype, backend):
    """hqq_tpu's quantized tree through the port's HQQVisionModel, on each
    backend, in fp32 and bf16 compute."""
    jm, logits = ref["quant"][dtype]
    tm = TVision(params=_to_torch(jm.params), cfg=_tcfg(ref["cfg"]), quantized=True)
    if backend != "xla":
        tm.prepare_for_inference(backend)
    px = torch.from_numpy(ref["px"]).to(_DTYPES[dtype][1])
    got, hidden = tm(px)
    assert got.dtype == hidden.dtype == _DTYPES[dtype][1]
    _close(got, logits[backend], _TOL[dtype])


@pytest.mark.parametrize("dtype", list(_DTYPES))
def test_quantize_model_leaves(ref, dtype):
    """The port's quantize_model quantizes what hqq_tpu's does: every
    encoder linear, the same tree and types; the patch projection and the
    classifier stay Linear; codes and meta at the reference bars. The bf16
    weights hold groups whose min is -max, whose initial zero is 7.5 when
    the scale 15 / (max - min) is divided out exactly (as hqq_tpu does)."""
    jm, _ = ref["quant"][dtype]
    jdt, tdt = _DTYPES[dtype]
    tree = _to_torch(jax.tree_util.tree_map(lambda a: a.astype(jdt), ref["fp"]))
    tm = TVision(params=tree, cfg=_tcfg(ref["cfg"])).quantize_model(
        TConfig(nbits=4, group_size=64), compute_dtype=tdt)
    got, got_s = tree_to_state(tm.params)
    want, want_s = tree_to_state(_to_torch(jm.params))
    assert got_s == want_s
    assert type(tm.params["patch_proj"]).__name__ == "Linear"
    assert type(tm.params["classifier"]).__name__ == "Linear"
    assert type(tm.params["layers"][0]["mlp"]["fc1"]).__name__ == "QuantLinear"
    for k in want:
        if k.endswith("W_q"):  # the solver meets a tie now and then: codes match in > 0.999
            assert (got[k] == want[k]).float().mean() > 0.999, k
        elif k.endswith("zero"):
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-4, atol=5e-4,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(got[k].float().numpy(), want[k].float().numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    with pytest.raises(RuntimeError, match="already"):
        tm.quantize_model()


def test_checkpoint_across_packages(ref, tmp_path):
    jm, _ = ref["quant"]["fp32"]
    jm.save_quantized(str(tmp_path / "jax"))
    tm = TAuto.from_quantized(str(tmp_path / "jax"), device="cpu")
    assert tm.model_type == "vit" and tm.quantized
    assert dataclasses.asdict(tm.cfg) == dataclasses.asdict(ref["cfg"])
    want, _ = tree_to_state(_to_torch(jm.params))
    got, _ = tree_to_state(tm.params)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    tm.save_quantized(str(tmp_path / "torch"))
    back = JAuto.from_quantized(str(tmp_path / "torch"))
    assert back.model_type == "vit" and back.cfg == ref["cfg"]
    flat_back, _ = tree_to_state(_to_torch(back.params))
    for k in want:
        assert torch.equal(flat_back[k], want[k]), k
    with pytest.raises(RuntimeError, match="quantize_model"):
        TVision(params={}, cfg=tm.cfg).save_quantized(str(tmp_path / "none"))


def _hf_dir(path, fp, cfg, prefixed: bool) -> dict:
    """An HF ViT directory (``vit.`` names and a classifier, or ViTModel's
    bare names and none) of hqq_tpu's fp tree."""
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    pre = "vit." if prefixed else ""
    state = {}

    def lin(name, layer):
        state[f"{name}.weight"], state[f"{name}.bias"] = t(layer.weight), t(layer.bias)

    def ln(name, p):
        state[f"{name}.weight"], state[f"{name}.bias"] = t(p["weight"]), t(p["bias"])

    for i, layer in enumerate(fp["layers"]):
        p = f"{pre}encoder.layer.{i}"
        ln(f"{p}.layernorm_before", layer["layernorm_before"])
        ln(f"{p}.layernorm_after", layer["layernorm_after"])
        for n in ("query", "key", "value"):
            lin(f"{p}.attention.attention.{n}", layer["attention"][n])
        lin(f"{p}.attention.output.dense", layer["attention"]["dense"])
        lin(f"{p}.intermediate.dense", layer["mlp"]["fc1"])
        lin(f"{p}.output.dense", layer["mlp"]["fc2"])
    w = np.asarray(fp["patch_proj"].weight)
    state[f"{pre}embeddings.patch_embeddings.projection.weight"] = t(
        w.reshape(w.shape[0], cfg.num_channels, cfg.patch_size, cfg.patch_size))
    state[f"{pre}embeddings.patch_embeddings.projection.bias"] = t(fp["patch_proj"].bias)
    state[f"{pre}embeddings.cls_token"] = t(fp["cls_token"])
    state[f"{pre}embeddings.position_embeddings"] = t(fp["position_embeddings"])
    ln(f"{pre}layernorm", fp["layernorm"])
    hf = {k: v for k, v in dataclasses.asdict(cfg).items() if k != "num_labels"}
    hf["model_type"] = "vit"
    if prefixed:
        lin("classifier", fp["classifier"])
        hf["id2label"] = {str(i): f"label{i}" for i in range(cfg.num_labels)}
    path.mkdir()
    save_file(state, str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps(hf))
    return state


@pytest.mark.parametrize("prefixed", [True, False], ids=["vit.", "bare"])
def test_from_pretrained(ref, tmp_path, prefixed):
    _hf_dir(tmp_path / "hf", ref["fp"], ref["cfg"], prefixed)
    tm = HQQtimm.from_pretrained(str(tmp_path / "hf"), device="cpu")
    jm = JAuto.from_pretrained(str(tmp_path / "hf"))
    assert tm.cfg == _tcfg(jm.cfg) and not tm.quantized
    want = dict(ref["fp"])
    if not prefixed:
        want["classifier"] = None
    w, w_s = tree_to_state(_to_torch(want))
    for tree in (tm.params, _to_torch(jm.params)):
        g, g_s = tree_to_state(tree)
        assert g_s == w_s
        for k in w:
            assert g[k].dtype == torch.float32 and torch.equal(g[k], w[k]), k
    logits, _ = tm(torch.from_numpy(ref["px"]))
    if prefixed:
        _close(logits, ref["pools"]["cls"][0])
    else:
        _close(logits, ref["pools"]["cls"][1][:, 0])


def test_unknown_type_refused(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps({"model_type": "swin"}))
    with pytest.raises(ValueError, match="not supported"):
        TAuto.from_pretrained(str(tmp_path), device="cpu")
