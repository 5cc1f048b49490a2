# SPDX-License-Identifier: Apache-2.0
"""hqq_tpu_torch's axis=0 serving path against hqq_tpu's.

One set of numpy inputs goes through both packages: the JAX side runs its
axis=0 Pallas kernels in interpret mode, the port runs its plain versions
(the tensors lie on the CPU). Weights cross with params_from_numpy. Bars:
  * quant_matmul_pallas and quant_matmul_pallas_a8 on a KernelQTensor0 with
    fp32 scale and zs: rel err < 2e-5 of max|y| against hqq_tpu and against
    x @ dequantize(qt).T in float64 (the bar of test_ax0_kernel.py: the same
    fp32 arithmetic, summed in another order);
  * the default policy stores scale and zs in the same dtype as hqq_tpu does
    (bf16 for 2-bit g16 and 1-bit g16/g32). With bf16 scale and zs hqq_tpu's
    kernel does c*scale - zs in bf16, while the port widens both to fp32 and
    rounds the weight once, to the activations' type: each weight may differ
    by a bf16 rounding (2^-9 of its size), which over a sum of K terms stays
    under 1e-3 of max|y|, the bar held here. (XLA's CPU backend keeps that
    bf16 arithmetic in fp32, so the readings here are near 1e-7.) Against the
    xla path the rounding of scale and zs shows: rel err < 2e-2, hqq_tpu's
    own bar, and > 2e-5;
  * dequant_pallas on a KernelQTensor0: atol 2e-6 against hqq_tpu with fp32
    scale and zs. With bf16 ones hqq_tpu's kernel writes bf16, so the port's
    bf16 output is held to it within two bf16 steps at max|W| (2^-6 of it);
  * prepare_for_inference on an axis=0 tree: the same module class per leaf
    as hqq_tpu's, by name, and the same meta dtype;
  * the slice as a whole on LlamaConfig.tiny() in fp32 (attention 3-bit g64,
    MLP 2-bit g16, both axis=0): greedy tokens equal under "pallas" and
    "w4a8", prefill logits within 1e-4 of max|logit|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hqq_tpu.backends import pallas_backend as jb
from hqq_tpu.core.quantize import BaseQuantizeConfig as JConfig
from hqq_tpu.core.quantize import dequantize as j_dequantize
from hqq_tpu.core.quantize import quantize as j_quantize
from hqq_tpu.engine.hf import HQQModel as JModel
from hqq_tpu.models import llama as jl
from hqq_tpu.models import quantize_model as j_quantize_model
from hqq_tpu.nn.linear import QuantLinear as JQuantLinear
from hqq_tpu.ops import fused_matmul as jf
from hqq_tpu.utils.patching import prepare_for_inference as j_prepare
from hqq_tpu_torch.backends import pallas_backend as tb
from hqq_tpu_torch.engine.hf import HQQModel as TModel
from hqq_tpu_torch.models import llama as tl
from hqq_tpu_torch.ops import fused_matmul as tf
from hqq_tpu_torch.utils import params_from_numpy
from hqq_tpu_torch.utils.patching import prepare_for_inference as t_prepare


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _dtype_name(dtype) -> str:
    """'bfloat16' for torch.bfloat16 and for jnp.bfloat16 alike."""
    return str(np.dtype(dtype) if not isinstance(dtype, torch.dtype) else dtype).split(".")[-1]


def _quantized(n_out, k, g, nbits, seed=0):
    rng = np.random.default_rng(seed + n_out + k + g)
    w = (rng.standard_normal((n_out, k)) / np.sqrt(k)).astype(np.float32)
    qj = j_quantize(jnp.asarray(w), nbits=nbits, group_size=g, axis=0,
                    round_zero=(nbits == 4), compute_dtype=jnp.float32)
    return qj, params_from_numpy(_numpy(qj), "cpu"), rng


# (nbits, g, N, K): group-major (4- and 3-bit g64) and chunk-major (2-bit g16,
# 1-bit g32) configs of hqq_tpu; N = 320 and 160 are no multiples of 8*g, and
# K = 200 pads along K in both packages
_CONFIGS = [(4, 64, 320, 512), (3, 64, 320, 512), (2, 16, 320, 512), (1, 32, 160, 512),
            (2, 16, 192, 200)]


@pytest.mark.parametrize("entry", ["quant_matmul_pallas", "quant_matmul_pallas_a8"])
@pytest.mark.parametrize("m", [1, 40])
@pytest.mark.parametrize("nbits,g,n_out,k", _CONFIGS)
def test_ax0_matmul_fp32_meta(entry, m, nbits, g, n_out, k):
    qj, qt, rng = _quantized(n_out, k, g, nbits)
    assert tf.supports_kernel_layout_ax0(qt) and jf.supports_kernel_layout_ax0(qj)
    kj = jf.to_kernel_layout_ax0(qj)
    kt = tf.to_kernel_layout_ax0(qt)
    assert kt.scale.dtype == torch.float32 and (kt.n, kt.k) == (n_out, k)
    x = rng.standard_normal((m, k)).astype(np.float32)
    yj = np.asarray(getattr(jf, entry)(jnp.asarray(x), kj))
    yt = getattr(tf, entry)(torch.from_numpy(x), kt).numpy()
    expected = x.astype(np.float64) @ np.asarray(j_dequantize(qj, jnp.float32)).astype(np.float64).T
    scale = np.abs(expected).max()
    assert yt.shape == yj.shape == (m, n_out)
    assert np.abs(yt - yj).max() / scale < 2e-5
    assert np.abs(yt - expected).max() / scale < 2e-5


# (nbits, g, N, K) of path F's attention config at groups of 64 and 128 with
# fp32 meta: N/g a multiple of 8 (the kernel's tiles store runs of 8
# columns) and not (256/128 = 2 b rows)
_WIDE_GROUPS = [(3, 64, 512, 256), (3, 128, 1024, 256), (3, 128, 256, 512)]


@pytest.mark.parametrize("m", [1, 40, 130])
@pytest.mark.parametrize("nbits,g,n_out,k", _WIDE_GROUPS)
def test_ax0_matmul_fp32_meta_wide_groups(m, nbits, g, n_out, k):
    """quant_matmul_pallas at 3-bit g64 and g128 with fp32 scale and zs
    against hqq_tpu's group-major kernel in interpret mode, at the bar of
    test_ax0_matmul_fp32_meta (2e-5 of max|y|), for M below, inside and
    across the 128-token tile."""
    qj, qt, rng = _quantized(n_out, k, g, nbits, seed=7)
    kj = jf.to_kernel_layout_ax0(qj, meta_dtype=jnp.float32)
    kt = tf.to_kernel_layout_ax0(qt, torch.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    yj = np.asarray(jf.quant_matmul_pallas(jnp.asarray(x), kj))
    yt = tf.quant_matmul_pallas(torch.from_numpy(x), kt).numpy()
    assert yt.shape == yj.shape == (m, n_out)
    assert np.abs(yt - yj).max() / np.abs(yj).max() < 2e-5


@pytest.mark.parametrize("m", [1, 40])
@pytest.mark.parametrize("nbits,g,n_out,k", _CONFIGS)
def test_ax0_matmul_default_meta_policy(m, nbits, g, n_out, k):
    qj, qt, rng = _quantized(n_out, k, g, nbits, seed=1)
    want = jb._ax0_meta_dtype(qj)
    got = tb._ax0_meta_dtype(qt)
    assert _dtype_name(want) == _dtype_name(got)
    assert (got == torch.bfloat16) == ((nbits, g) in ((2, 16), (1, 32)))
    kj = jf.to_kernel_layout_ax0(qj, meta_dtype=want)
    kt = tf.to_kernel_layout_ax0(qt, got)
    assert kt.scale.dtype == kt.zs.dtype == got
    x = rng.standard_normal((m, k)).astype(np.float32)
    yj = np.asarray(jf.quant_matmul_pallas(jnp.asarray(x), kj))
    yt = tf.quant_matmul_pallas(torch.from_numpy(x), kt).numpy()
    xla = x.astype(np.float64) @ np.asarray(j_dequantize(qj, jnp.float32)).astype(np.float64).T
    scale = np.abs(xla).max()
    assert np.abs(yt - yj).max() / scale < (1e-3 if got == torch.bfloat16 else 2e-5)
    assert np.abs(yt - xla).max() / scale < 2e-2
    if got == torch.bfloat16:  # the rounding of scale and zs is really there
        assert np.abs(yt - xla).max() / scale > 2e-5


@pytest.mark.parametrize("meta", ["float32", "bfloat16"])
@pytest.mark.parametrize("nbits,g,n_out,k", _CONFIGS)
def test_ax0_dequant_pallas(meta, nbits, g, n_out, k):
    qj, qt, _ = _quantized(n_out, k, g, nbits, seed=2)
    kj = jf.to_kernel_layout_ax0(qj, meta_dtype=getattr(jnp, meta))
    kt = tf.to_kernel_layout_ax0(qt, getattr(torch, meta))
    wj = np.asarray(jf.dequant_pallas(kj, interpret=True), np.float32)  # [K, N]
    wt = tf.dequant_pallas(kt, getattr(torch, meta)).to(torch.float32).numpy()
    assert wt.shape == wj.shape == (k, n_out)
    atol = 2e-6 if meta == "float32" else 2.0**-6 * np.abs(wj).max()
    np.testing.assert_allclose(wt, wj, rtol=0, atol=atol)
    if meta == "float32":
        np.testing.assert_allclose(wt.T, np.asarray(j_dequantize(qj, jnp.float32)), rtol=0,
                                   atol=2e-6)


def test_ax0_layout_limits_match():
    """The configs that keep the xla path are hqq_tpu's: a group that does
    not divide N, or is no multiple of 8 rows."""
    for n_out, k, g, nbits in ((40, 64, 256, 4), (64, 64, 4, 4), (256, 128, 64, 8),
                               (256, 128, 8, 1), (256, 100, 16, 2)):
        w = np.random.default_rng(0).standard_normal((n_out, k)).astype(np.float32)
        qj = j_quantize(jnp.asarray(w), nbits=nbits, group_size=g, axis=0,
                        compute_dtype=jnp.float32)
        qt = params_from_numpy(_numpy(qj), "cpu")
        assert tf.supports_kernel_layout_ax0(qt) == jf.supports_kernel_layout_ax0(qj)
        assert not tf.supports_kernel_layout(qt)
    with pytest.raises(ValueError):
        tf.to_kernel_layout_ax0(qt, torch.float16)
    tf.reset_launch_counts()
    kt = tf.to_kernel_layout_ax0(qt)
    tf.quant_matmul_pallas_a8(torch.zeros(2, 100), kt)
    tf.dequant_pallas(kt)
    assert tf.quant_matmul_ax0.launches == 0 and tf.dequant.launches == 0  # CPU: plain versions


# -- the modules ------------------------------------------------------------


@pytest.mark.parametrize("backend", ["pallas", "w4a8"])
@pytest.mark.parametrize("nbits,g", [(2, 16), (3, 64)])
def test_ax0_prepare_for_inference_layer(backend, nbits, g):
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((320, 512)) / 20).astype(np.float32)
    bias = rng.standard_normal(320).astype(np.float32)
    lj = JQuantLinear.quantize(jnp.asarray(w), jnp.asarray(bias),
                               quant_config=JConfig(nbits=nbits, group_size=g, axis=0,
                                                    compute_dtype=jnp.float32))
    x = rng.standard_normal((2, 3, 512)).astype(np.float32)
    ref = np.asarray(lj(jnp.asarray(x)))
    for meta in (None, "float32"):
        fj = j_prepare({"up_proj": lj}, backend,
                       meta_dtype=meta and getattr(jnp, meta))["up_proj"]
        ft = t_prepare({"up_proj": params_from_numpy(_numpy(lj), "cpu")}, backend,
                       meta_dtype=meta and getattr(torch, meta))["up_proj"]
        assert type(ft).__name__ == type(fj).__name__ != "QuantLinear"
        assert type(ft.kqt).__name__ == type(fj.kqt).__name__ == "KernelQTensor0"
        assert _dtype_name(ft.kqt.scale.dtype) == _dtype_name(fj.kqt.scale.dtype)
        assert (ft.in_features, ft.out_features) == (512, 320)
        yj = np.asarray(fj(jnp.asarray(x)))
        yt = ft(torch.from_numpy(x)).numpy()
        scale = np.abs(ref).max()
        bf16 = ft.kqt.scale.dtype == torch.bfloat16
        assert bf16 == (meta is None and g == 16)
        assert np.abs(yt - yj).max() / scale < (1e-3 if bf16 else 2e-5)
        assert np.abs(yt - ref).max() / scale < (2e-2 if bf16 else 2e-5)
        wj = np.asarray(fj.dequantize(jnp.float32))
        np.testing.assert_allclose(ft.dequantize(torch.float32).numpy(), wj, rtol=0,
                                   atol=2.0**-6 * np.abs(wj).max() if bf16 else 2e-6)


# -- the model --------------------------------------------------------------


@pytest.fixture(scope="module")
def ax0_models():
    """(cfg, hqq_tpu's tree, a function giving a fresh copy in the port): the
    tiny model with attention 3-bit g64 and MLP 2-bit g16, both axis=0."""
    cfg = jl.LlamaConfig.tiny()
    params = jl.init_params(cfg, jax.random.PRNGKey(5), dtype=jnp.float32)
    attn = JConfig(nbits=3, group_size=64, axis=0)
    mlp = JConfig(nbits=2, group_size=16, axis=0)
    per_tag = {f"self_attn.{t}_proj": attn for t in "qkvo"}
    per_tag.update({f"mlp.{t}_proj": mlp for t in ("gate", "up", "down")})
    qj = j_quantize_model(params, per_tag, compute_dtype=jnp.float32)
    return cfg, qj, lambda: params_from_numpy(_numpy(qj), "cpu")


def _leaf_classes(tree, path=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _leaf_classes(sub, f"{path}.{key}").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _leaf_classes(sub, f"{path}.{i}").items()}
    name = type(tree).__name__
    kqt = getattr(tree, "kqt", None)
    if kqt is not None:
        name += f"({type(kqt).__name__}:{_dtype_name(kqt.scale.dtype)})"
    return {path: name}


@pytest.mark.parametrize("backend", ["xla", "pallas", "w4a8",
                                     {"self_attn.q_proj": "w4a8", "mlp.up_proj": "pallas"}])
def test_ax0_prepare_for_inference_classes_match(ax0_models, backend):
    _, qj, fresh = ax0_models
    classes_j = _leaf_classes(j_prepare(qj, backend))
    classes_t = _leaf_classes(t_prepare(fresh(), backend))
    skip = ("ArrayImpl", "Tensor")  # arrays are jax Arrays on one side, Tensors on the other
    assert {k: v for k, v in classes_t.items() if v not in skip} == \
        {k: v for k, v in classes_j.items() if v not in skip}
    if backend in ("pallas", "w4a8"):
        got = set(classes_t.values()) - set(skip)
        cls = "PallasQuantLinear" if backend == "pallas" else "A8QuantLinear"
        assert got == {f"{cls}(KernelQTensor0:float32)", f"{cls}(KernelQTensor0:bfloat16)",
                       "Linear"}


@pytest.mark.parametrize("backend", ["xla", "pallas", "w4a8"])
def test_ax0_model_greedy_tokens_equal(ax0_models, backend):
    cfg, qj, fresh = ax0_models
    prompts = [[1, 7, 3, 9, 11], [4, 5, 6, 200, 17]]
    jm = JModel(params=qj, cfg=cfg, quantized=True).prepare_for_inference(backend)
    ref = np.asarray(jm.generate(prompts, max_new_tokens=8, cache_dtype=jnp.float32))
    tm = TModel(params=fresh(), cfg=tl.LlamaConfig.tiny(),
                quantized=True).prepare_for_inference(backend)
    got = tm.generate(prompts, max_new_tokens=8, cache_dtype=torch.float32)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("backend", ["pallas", "w4a8"])
@pytest.mark.parametrize("t", [5, 40])  # M = 5 rows, and M = 40 > 32
def test_ax0_model_prefill_logits(ax0_models, backend, t):
    cfg, qj, fresh = ax0_models
    toks = np.random.default_rng(t).integers(0, cfg.vocab_size, size=(1, t))
    ref, _ = jl.forward(j_prepare(qj, backend), cfg, jnp.asarray(toks),
                        jl.init_cache(cfg, 1, 64, jnp.float32), 0)
    ref = np.asarray(ref)
    tcfg = tl.LlamaConfig.tiny()
    got, _ = tl.forward(t_prepare(fresh(), backend), tcfg, torch.from_numpy(toks),
                        tl.init_cache(tcfg, 1, 64, torch.float32, "cpu"), 0)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max())
