# SPDX-License-Identifier: Apache-2.0
"""hqq_tpu_torch's HQQ+ serving path against hqq_tpu's.

One set of numpy inputs goes through both packages: the JAX side runs its
Pallas LoRA kernels in interpret mode, the port runs its plain versions (the
tensors lie on the CPU). Weights cross with params_from_numpy. Bars:
  * quant_matmul_pallas_lora and quant_matmul_pallas_a8_lora in fp32: rel
    err < 2e-5 of max|y| against hqq_tpu and against the formula in float64
    (the bar of test_a8_lora.py): the group dots are exact, fp32 sums run in
    another order;
  * prepare_for_inference on a LoRA tree: the same module class per leaf as
    hqq_tpu's, by name;
  * the slice as a whole on LlamaConfig.tiny() in fp32: greedy tokens equal
    under "pallas" and "w4a8" (both packages round the same int8 activations
    in fp32), prefill logits within 1e-4 of max|logit| under "pallas";
  * a file of adapter weights written by one package loads in the other.

Every K here is a multiple of 8 groups. Otherwise hqq_tpu's
quant_matmul_pallas_a8_lora leaves the int8 path (its kernel needs K % 8g ==
0) and the two packages would round different activations; the port's kernel
serves every K % g == 0. So the tiny model (hidden 256) is quantized at g32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hqq_tpu.core import peft as jp
from hqq_tpu.core.quantize import BaseQuantizeConfig as JConfig
from hqq_tpu.core.quantize import dequantize as j_dequantize
from hqq_tpu.core.quantize import quantize as j_quantize
from hqq_tpu.engine.hf import HQQModel as JModel
from hqq_tpu.models import llama as jl
from hqq_tpu.models import quantize_model as j_quantize_model
from hqq_tpu.nn.linear import QuantLinear as JQuantLinear
from hqq_tpu.ops import fused_matmul as jf
from hqq_tpu.utils.patching import prepare_for_inference as j_prepare
from hqq_tpu_torch.core import peft as tp
from hqq_tpu_torch.engine.hf import HQQModel as TModel
from hqq_tpu_torch.models import llama as tl
from hqq_tpu_torch.ops import fused_matmul as tf
from hqq_tpu_torch.utils import params_from_numpy
from hqq_tpu_torch.utils.patching import prepare_for_inference as t_prepare


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _carry(m, n_out, k, g, nbits, r):
    rng = np.random.default_rng(m * 1000 + k + nbits * 10 + r)
    w = (rng.standard_normal((n_out, k)) / np.sqrt(k)).astype(np.float32)
    qj = j_quantize(jnp.asarray(w), nbits=nbits, group_size=g, axis=1,
                    round_zero=(nbits == 4), compute_dtype=jnp.float32)
    kj = jf.to_kernel_layout(qj)
    kt = tf.to_kernel_layout(params_from_numpy(_numpy(qj), "cpu"))
    x = rng.standard_normal((m, k)).astype(np.float32)
    a = (rng.standard_normal((k, r)) / np.sqrt(k)).astype(np.float32)
    b = (rng.standard_normal((r, n_out)) * 0.05).astype(np.float32)
    w_dq = np.asarray(j_dequantize(qj, jnp.float32)).astype(np.float64)
    return kj, kt, x, a, b, w_dq


_CASES = [(m, nbits, r) for m in (1, 3, 8, 40) for nbits, r in ((4, 8), (2, 4), (1, 8))]


@pytest.mark.parametrize("m,nbits,r", _CASES)
def test_quant_matmul_pallas_lora(m, nbits, r):
    kj, kt, x, a, b, w_dq = _carry(m, 256, 512, 64, nbits, r)
    yj = np.asarray(jf.quant_matmul_pallas_lora(jnp.asarray(x), kj, jnp.asarray(a),
                                                jnp.asarray(b)))
    yt = tf.quant_matmul_pallas_lora(torch.from_numpy(x), kt, torch.from_numpy(a),
                                     torch.from_numpy(b)).numpy()
    expected = x.astype(np.float64) @ w_dq.T + (x.astype(np.float64) @ a) @ b
    scale = np.abs(expected).max()
    assert yt.shape == yj.shape == (m, 256)
    assert np.abs(yt - yj).max() / scale < 2e-5
    assert np.abs(yt - expected).max() / scale < 2e-5


@pytest.mark.parametrize("m,nbits,r", _CASES)
def test_quant_matmul_pallas_a8_lora(m, nbits, r):
    kj, kt, x, a, b, w_dq = _carry(m, 256, 512, 64, nbits, r)
    yj = np.asarray(jf.quant_matmul_pallas_a8_lora(jnp.asarray(x), kj, jnp.asarray(a),
                                                   jnp.asarray(b)))
    yt = tf.quant_matmul_pallas_a8_lora(torch.from_numpy(x), kt, torch.from_numpy(a),
                                        torch.from_numpy(b)).numpy()
    xq = x.astype(np.float64)
    if m <= 32:  # the base sees int8 activations, the adapter the exact ones
        x8, sx = tf.quantize_activations_int8(torch.from_numpy(x))
        xq = x8.numpy().astype(np.float64) * sx.numpy()
    expected = xq @ w_dq.T + (x.astype(np.float64) @ a) @ b
    scale = np.abs(expected).max()
    assert np.abs(yt - yj).max() / scale < 2e-5
    assert np.abs(yt - expected).max() / scale < 2e-5


def test_a8_lora_routes_8bit_and_keeps_leading_dims():
    """8-bit weights take the bf16-operand LoRA kernel at every M, as in
    hqq_tpu; leading dims are kept."""
    kj, kt, x, a, b, w_dq = _carry(4, 128, 256, 32, 8, 4)
    yj = np.asarray(jf.quant_matmul_pallas_a8_lora(jnp.asarray(x), kj, jnp.asarray(a),
                                                   jnp.asarray(b)))
    yt = tf.quant_matmul_pallas_a8_lora(torch.from_numpy(x).reshape(2, 2, 256), kt,
                                        torch.from_numpy(a), torch.from_numpy(b))
    assert tuple(yt.shape) == (2, 2, 128)
    np.testing.assert_allclose(yt.reshape(4, 128).numpy(), yj, rtol=0,
                               atol=2e-5 * np.abs(yj).max())


def test_lora_wrappers_count_nothing_on_cpu():
    _, kt, x, a, b, _ = _carry(2, 128, 256, 64, 4, 4)
    tf.reset_launch_counts()
    args = (kt, torch.from_numpy(a), torch.from_numpy(b))
    tf.quant_matmul_pallas_a8_lora(torch.from_numpy(x), *args)
    tf.quant_matmul_pallas_lora(torch.from_numpy(x), *args)
    assert tf.w4a8_lora_matmul.launches == 0 and tf.quant_matmul_lora.launches == 0


# -- the modules ------------------------------------------------------------


def _j_lora_layer(rng, n_out=128, k=512, r=4, bias=True, train_bias=True):
    w = (rng.standard_normal((n_out, k)) / np.sqrt(k)).astype(np.float32)
    base = JQuantLinear.quantize(
        jnp.asarray(w), jnp.asarray(rng.standard_normal(n_out).astype(np.float32)) if bias else None,
        quant_config=JConfig(nbits=4, group_size=64, compute_dtype=jnp.float32))
    lora = jp.LoRALinear.wrap(base, r=r, lora_alpha=2 * r, train_bias=train_bias)
    lora = lora.replace(lora_b=jnp.asarray((rng.standard_normal((r, n_out)) * 0.05)
                                           .astype(np.float32)))
    if train_bias:
        lora = lora.replace(bias=jnp.asarray(rng.standard_normal(n_out).astype(np.float32)))
    return lora


@pytest.mark.parametrize("bias,train_bias", [(True, True), (False, True), (True, False),
                                             (False, False)])
def test_lora_linear_and_fused_modules(bias, train_bias):
    """LoRALinear's forward, and the fused modules with the biases merged and
    the scaling folded into b, all against hqq_tpu's."""
    rng = np.random.default_rng(5)
    lj = _j_lora_layer(rng, bias=bias, train_bias=train_bias)
    lt = params_from_numpy(_numpy(lj), "cpu")
    assert isinstance(lt, tp.LoRALinear) and lt.scaling == lj.scaling == 2.0
    x = rng.standard_normal((3, 5, 512)).astype(np.float32)
    ref = np.asarray(lj(jnp.asarray(x)))
    scale = np.abs(ref).max()
    np.testing.assert_allclose(lt(torch.from_numpy(x)).numpy(), ref, rtol=0, atol=2e-5 * scale)
    np.testing.assert_allclose(lt.merged_weight().numpy(), np.asarray(lj.merged_weight()),
                               rtol=0, atol=1e-6)
    for backend in ("pallas", "w4a8"):
        fj = j_prepare({"q_proj": lj}, backend)["q_proj"]
        ft = t_prepare({"q_proj": params_from_numpy(_numpy(lj), "cpu")}, backend)["q_proj"]
        assert type(ft).__name__ == type(fj).__name__
        assert (ft.bias is None) == (fj.bias is None)
        yj = np.asarray(fj(jnp.asarray(x)))
        np.testing.assert_allclose(ft(torch.from_numpy(x)).numpy(), yj, rtol=0,
                                   atol=2e-5 * np.abs(yj).max())


def test_lora_wrap_starts_as_a_no_op_and_is_seeded():
    lin = params_from_numpy(_numpy(_j_lora_layer(np.random.default_rng(1))), "cpu").base
    a = tp.LoRALinear.wrap(lin, r=4, lora_alpha=8, generator=torch.Generator().manual_seed(3))
    b = tp.LoRALinear.wrap(lin, r=4, lora_alpha=8, generator=torch.Generator().manual_seed(3))
    x = torch.randn(2, 512, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(a(x), lin(x))
    torch.testing.assert_close(a.lora_a, b.lora_a)
    assert tuple(a.lora_a.shape) == (512, 4) and a.scaling == 2.0
    assert a.lora_a.abs().max() <= (6.0 / 512) ** 0.5 and not a.lora_b.any()


@pytest.mark.parametrize("r", [65, 128])
def test_rank_above_one_kernel_chunk_fuses(r):
    """Ranks above 64 (the kernel's chunk) fuse as any other: the same module
    class as hqq_tpu gives and its fused output, at decode and prefill M."""
    lj = _j_lora_layer(np.random.default_rng(7), r=r)
    x = np.random.default_rng(8).standard_normal((40, 512)).astype(np.float32)
    for backend in ("pallas", "w4a8"):
        fj = j_prepare({"q_proj": lj}, backend)["q_proj"]
        ft = t_prepare({"q_proj": params_from_numpy(_numpy(lj), "cpu")}, backend)["q_proj"]
        assert type(ft).__name__ == type(fj).__name__ != "LoRALinear"
        assert tuple(ft.a.shape) == (512, r)
        for m in (3, 40):
            yj = np.asarray(fj(jnp.asarray(x[:m])))
            np.testing.assert_allclose(ft(torch.from_numpy(x[:m])).numpy(), yj, rtol=0,
                                       atol=2e-5 * np.abs(yj).max())


# -- the model --------------------------------------------------------------


@pytest.fixture(scope="module")
def lora_models():
    """(cfg, hqq_tpu's tree, a function giving a fresh copy in the port): the
    tiny model, 4-bit g32, adapters of rank 8 on every linear but lm_head
    with B from numpy, q_proj with a trained bias."""
    cfg = jl.LlamaConfig.tiny()
    params = jl.init_params(cfg, jax.random.PRNGKey(2), dtype=jnp.float32)
    q = j_quantize_model(params, JConfig(nbits=4, group_size=32), compute_dtype=jnp.float32)
    lj = jp.PeftUtils.add_lora(q, jp.lora_config(r=8, lora_alpha=16), jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)

    def fill(tree, path=""):
        if isinstance(tree, dict):
            return {k: fill(v, f"{path}.{k}") for k, v in tree.items()}
        if isinstance(tree, list):
            return [fill(v, f"{path}.{i}") for i, v in enumerate(tree)]
        if isinstance(tree, jp.LoRALinear):
            b = (rng.standard_normal(tree.lora_b.shape) * 0.05).astype(np.float32)
            bias = None
            if path.endswith("q_proj"):
                bias = jnp.asarray(rng.standard_normal(b.shape[1]).astype(np.float32) * 0.1)
            return tree.replace(lora_b=jnp.asarray(b), bias=bias)
        return tree

    lj = fill(lj)
    return cfg, lj, lambda: params_from_numpy(_numpy(lj), "cpu")


def _leaf_classes(tree, path=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _leaf_classes(sub, f"{path}.{key}").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _leaf_classes(sub, f"{path}.{i}").items()}
    inner = getattr(tree, "base", None)
    name = type(tree).__name__ + (f"({type(inner).__name__})" if inner is not None else "")
    return {path: name}


@pytest.mark.parametrize("backend", ["xla", "pallas", "w4a8",
                                     {"self_attn.q_proj": "w4a8", "mlp.up_proj": "pallas"}])
def test_prepare_for_inference_classes_match(lora_models, backend):
    _, lj, fresh = lora_models
    classes_j = _leaf_classes(j_prepare(lj, backend))
    classes_t = _leaf_classes(t_prepare(fresh(), backend))
    # arrays are jax Arrays on one side and Tensors on the other
    skip = ("ArrayImpl", "Tensor")
    assert {k: v for k, v in classes_t.items() if v not in skip} == \
        {k: v for k, v in classes_j.items() if v not in skip}
    assert "LoRALinear(QuantLinear)" in classes_t.values() or backend in ("pallas", "w4a8")


@pytest.mark.parametrize("backend", ["xla", "pallas", "w4a8"])
def test_lora_model_greedy_tokens_equal(lora_models, backend):
    cfg, lj, fresh = lora_models
    prompts = [[1, 7, 3, 9, 11], [4, 5, 6, 200, 17]]
    jm = JModel(params=lj, cfg=cfg, quantized=True).prepare_for_inference(backend)
    ref = np.asarray(jm.generate(prompts, max_new_tokens=8, cache_dtype=jnp.float32))
    tm = TModel(params=fresh(), cfg=tl.LlamaConfig.tiny(),
                quantized=True).prepare_for_inference(backend)
    got = tm.generate(prompts, max_new_tokens=8, cache_dtype=torch.float32)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("t", [5, 40])  # M = 5 rows, and M = 40 > 32
def test_lora_model_prefill_logits(lora_models, t):
    cfg, lj, fresh = lora_models
    toks = np.random.default_rng(t).integers(0, cfg.vocab_size, size=(1, t))
    ref, _ = jl.forward(j_prepare(lj, "pallas"), cfg, jnp.asarray(toks),
                        jl.init_cache(cfg, 1, 64, jnp.float32), 0)
    ref = np.asarray(ref)
    tcfg = tl.LlamaConfig.tiny()
    got, _ = tl.forward(t_prepare(fresh(), "pallas"), tcfg, torch.from_numpy(toks),
                        tl.init_cache(tcfg, 1, 64, torch.float32, "cpu"), 0)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def test_add_lora_structure_and_cast():
    cfg = tl.LlamaConfig.tiny()
    params = tl.init_params(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    tp.PeftUtils.add_lora(params, {"self_attn.q_proj": tp.lora_config(r=4, lora_alpha=8),
                                   "mlp.up_proj": tp.lora_config(r=2), "mlp.down_proj": None},
                          torch.Generator().manual_seed(1))
    layer = params["layers"][1]
    assert isinstance(layer["self_attn"]["q_proj"], tp.LoRALinear)
    assert layer["mlp"]["up_proj"].lora_a.shape[1] == 2
    assert not isinstance(layer["mlp"]["down_proj"], tp.LoRALinear)
    assert not isinstance(params["lm_head"], tp.LoRALinear)
    # the layers draw from one stream: no two A matrices are equal
    a0 = params["layers"][0]["self_attn"]["q_proj"].lora_a
    assert not torch.equal(a0, layer["self_attn"]["q_proj"].lora_a)
    tp.PeftUtils.cast_lora_weights(params, torch.bfloat16)
    assert a0.dtype == torch.bfloat16 and layer["mlp"]["up_proj"].lora_b.dtype == torch.bfloat16


@pytest.mark.parametrize("writer", ["hqq_tpu", "hqq_tpu_torch"])
def test_lora_weights_file_crosses_packages(lora_models, tmp_path, writer):
    _, lj, fresh = lora_models
    path = str(tmp_path / "adapters.safetensors")
    def zeroed_j(tree):
        if isinstance(tree, dict):
            return {k: zeroed_j(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [zeroed_j(v) for v in tree]
        if isinstance(tree, jp.LoRALinear):
            return tree.replace(lora_a=tree.lora_a * 0, lora_b=tree.lora_b * 0)
        return tree

    want = _numpy(lj)["layers"][1]["self_attn"]["q_proj"]
    if writer == "hqq_tpu":
        jp.PeftUtils.save_lora_weights(lj, path)
        target = fresh()
        tp._map_lora(target, lambda _, l: (l.lora_a.data.zero_(), l.lora_b.data.zero_()))
        got = tp.PeftUtils.load_lora_weights(target, path)["layers"][1]["self_attn"]["q_proj"]
        got = (got.lora_a.numpy(), got.lora_b.numpy(), got.bias.numpy())
    else:
        tp.PeftUtils.save_lora_weights(fresh(), path)
        got = jp.PeftUtils.load_lora_weights(zeroed_j(lj), path)["layers"][1]["self_attn"]["q_proj"]
        got = (np.asarray(got.lora_a), np.asarray(got.lora_b), np.asarray(got.bias))
    for g, w in zip(got, (want.lora_a, want.lora_b, want.bias)):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("layer", ["PallasLoRAQuantLinear", "A8LoRAQuantLinear"])
def test_lora_layer_serves_a_changed_adapter(layer):
    """One copy of A: the layer holds no tensor besides a and b, and after
    load_state_dict, or an in-place update through a.data, the outputs at
    M = 4 (the int8 route of the w4a8 layer) and M = 64 (the LoRA kernel)
    both follow the new A."""
    from hqq_tpu_torch.backends import pallas_backend as pb

    _, kt, _, a, b, _ = _carry(4, 256, 512, 64, 4, 8)
    a, b = torch.from_numpy(a), torch.from_numpy(b)
    a2 = torch.from_numpy(np.random.default_rng(9).standard_normal(tuple(a.shape))
                          .astype(np.float32) / 20)
    cls = getattr(pb, layer)
    mod, fresh, again = cls(kt, a.clone(), b), cls(kt, a2.clone(), b), cls(kt, a.clone(), b)
    rng = np.random.default_rng(1)
    xs = [torch.from_numpy(rng.standard_normal((m, 512)).astype(np.float32)) for m in (4, 64)]
    assert list(mod.named_buffers()) == [] and set(mod.state_dict()) == {"a", "b"}
    mod.load_state_dict(fresh.state_dict())
    for x in xs:
        assert torch.equal(mod(x), fresh(x))
    mod.a.data.copy_(a)
    for x in xs:
        assert torch.equal(mod(x), again(x)) and not torch.equal(mod(x), fresh(x))
