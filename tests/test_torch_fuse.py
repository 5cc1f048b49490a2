# SPDX-License-Identifier: Apache-2.0
"""fuse_for_decode and the int8 backend of hqq_tpu_torch against hqq_tpu's.

LlamaConfig.tiny() in fp32, 4-bit g64 weights quantized by hqq_tpu and
carried across with params_from_numpy. Each package prepares its tree for
a backend and fuses it (hqq_tpu pads the fused w4a8 N and the int8 weights
to 512, the port pads nothing at these widths; the outputs are the same).

Tolerances: logits 1e-5 of max|logit| and greedy ids equal over a prefill
of 8 tokens and 3 decode steps (fp32 sums in another order, the bar of
tests/test_torch_llama.py; weights from PRNGKey(11), whose activations lie
far from int8 rounding ties in both packages); the int32 products of the
int8 backend equal bit for bit (both round half to even, the accumulation
is exact), and its outputs 1e-6 of max|y| (one fp32 rescale); the fused
w4a8 layer against the unfused layers side by side: bit-equal on the int8
route (exact group dots) and 1e-6 of max|y| on the bf16-operand route (an
fp32 matmul over another N).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hqq_tpu.backends import int8_backend as ji
from hqq_tpu.core.quantize import BaseQuantizeConfig as JConfig
from hqq_tpu.core.peft import PeftUtils as JPeft
from hqq_tpu.core.peft import lora_config as j_lora_config
from hqq_tpu.models import llama as jl
from hqq_tpu.models import quantize_model as j_quantize_model
from hqq_tpu.models.serialize import load_checkpoint as j_load
from hqq_tpu.models.serialize import save_checkpoint as j_save
from hqq_tpu.utils.patching import fuse_for_decode as j_fuse
from hqq_tpu.utils.patching import prepare_for_inference as j_prepare
from hqq_tpu_torch.backends import int8_backend as ti
from hqq_tpu_torch.backends.pallas_backend import A8LoRAQuantLinear, A8QuantLinear
from hqq_tpu_torch.models import llama as tl
from hqq_tpu_torch.models.serialize import load_checkpoint as t_load
from hqq_tpu_torch.models.serialize import save_checkpoint as t_save
from hqq_tpu_torch.nn.linear import Linear
from hqq_tpu_torch.ops import fused_matmul as fm
from hqq_tpu_torch.utils import params_from_numpy
from hqq_tpu_torch.utils.patching import fuse_for_decode as t_fuse
from hqq_tpu_torch.utils.patching import prepare_for_inference as t_prepare

_TOL = 1e-5
_j_forward = jax.jit(jl.forward, static_argnums=(1,))


@pytest.fixture(scope="module")
def quantized():
    cfg = jl.LlamaConfig.tiny()
    params = jl.init_params(cfg, jax.random.PRNGKey(11), dtype=jnp.float32)
    return cfg, params, j_quantize_model(params, JConfig(nbits=4, group_size=64),
                                         compute_dtype=jnp.float32)


def _to_torch(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), "cpu")


def _greedy(forward, tokens, steps: int = 3):
    """(logits of the prefill and of each decode step, greedy ids)."""
    logits, cache = forward(tokens, None, 0)
    out, ids = [logits], []
    for i in range(steps):
        nxt = np.asarray(logits)[:, -1].argmax(-1)[:, None].astype(np.int32)
        ids.append(nxt[:, 0])
        logits, cache = forward(nxt, cache, tokens.shape[1] + i)
        out.append(logits)
    return [np.asarray(o) for o in out], np.stack(ids, 1)


def _run_both(jtree, ttree, cfg):
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)

    def jfwd(toks, cache, pos):
        cache = jl.init_cache(cfg, 2, 16, jnp.float32) if cache is None else cache
        return _j_forward(jtree, cfg, jnp.asarray(toks), cache, jnp.int32(pos))

    def tfwd(toks, cache, pos):
        cache = tl.init_cache(tl.LlamaConfig.tiny(), 2, 16, torch.float32, "cpu") \
            if cache is None else cache
        with torch.no_grad():
            return tl.forward(ttree, tl.LlamaConfig.tiny(), torch.from_numpy(toks).long(),
                              cache, pos)

    return _greedy(jfwd, tokens), _greedy(tfwd, tokens)


@pytest.mark.parametrize("backend", ["w4a8", "int8", "plain"])
def test_fused_logits_match_jax(quantized, backend):
    cfg, params, qparams = quantized
    jtree = params if backend == "plain" else j_prepare(qparams, backend)
    jfused = j_fuse(jtree, pad_to=512)
    tfused = t_fuse(t_prepare(_to_torch(qparams), backend) if backend != "plain"
                    else _to_torch(params))
    kind = {"w4a8": A8QuantLinear, "int8": ti.Int8QuantLinear, "plain": Linear}[backend]
    for tree in (jfused, tfused):
        sa, mlp = tree["layers"][0]["self_attn"], tree["layers"][0]["mlp"]
        assert set(sa) == {"qkv_proj", "o_proj"} and set(mlp) == {"gate_up_proj", "down_proj"}
    assert isinstance(tfused["layers"][1]["self_attn"]["qkv_proj"], kind)
    (jl_out, jids), (tl_out, tids) = _run_both(jfused, tfused, cfg)
    for got, ref in zip(tl_out, jl_out):
        np.testing.assert_allclose(got, ref, atol=_TOL * np.abs(ref).max(), rtol=0)
    np.testing.assert_array_equal(tids, jids)
    # and the port's fused tree against its unfused one (the same layers)
    unfused_tree = (t_prepare(_to_torch(qparams), backend) if backend != "plain"
                    else _to_torch(params))
    (_, _), (unfused, uids) = _run_both(jfused, unfused_tree, cfg)
    np.testing.assert_array_equal(uids, tids)
    for got, ref in zip(tl_out, unfused):
        np.testing.assert_allclose(got, ref, atol=_TOL * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("m", [4, 40])
def test_a8_concat_against_unfused(quantized, m):
    """The fused w4a8 layer gives the unfused layers' outputs side by side:
    at M = 4 through the int8 route, at M = 40 through the bf16-operand
    kernel's (here its plain twin's)."""
    _, _, qparams = quantized
    tree = t_prepare(_to_torch(qparams), "w4a8")
    for names, key in ((("q_proj", "k_proj", "v_proj"), "self_attn"),
                       (("gate_proj", "up_proj"), "mlp")):
        parts = [tree["layers"][0][key][n] for n in names]
        fused = t_fuse(tree)["layers"][0][key]["qkv_proj" if key == "self_attn"
                                               else "gate_up_proj"]
        assert fused.kqt.n == sum(p.out_features for p in parts)
        assert fused.kqt.wq.shape[0] == fused.kqt.n  # joined along N: the rows
        x = torch.from_numpy(np.random.default_rng(m).standard_normal(
            (m, parts[0].in_features)).astype(np.float32))
        with torch.no_grad():
            got, want = fused(x), torch.cat([p(x) for p in parts], dim=-1)
        if m <= fm.A8_MAX_M:
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, atol=1e-6 * want.abs().max().item(), rtol=0)


def test_unfusable_layers_stay_as_in_jax(quantized):
    """Axis=0 kernel layouts, the LoRA kernel modules and groups of mixed
    kinds stay unfused in both packages."""
    cfg, params, qparams = quantized
    ax0 = j_quantize_model(params, JConfig(nbits=4, group_size=64, axis=0),
                           compute_dtype=jnp.float32)
    lora = JPeft.add_lora(qparams, j_lora_config(r=4, lora_alpha=8), key=jax.random.PRNGKey(1))
    for jtree in (ax0, lora):
        t = t_fuse(t_prepare(_to_torch(jtree), "w4a8"))
        j = j_fuse(j_prepare(jtree, "w4a8"), pad_to=512)
        for tree in (t, j):
            assert set(tree["layers"][0]["self_attn"]) == {"q_proj", "k_proj", "v_proj",
                                                          "o_proj"}
            assert "gate_up_proj" not in tree["layers"][0]["mlp"]
    assert isinstance(t["layers"][0]["self_attn"]["q_proj"], A8LoRAQuantLinear)
    # a group of mixed kinds: one q projection left dense
    mixed = t_prepare(_to_torch(qparams), "int8")
    mixed["layers"][0]["self_attn"]["q_proj"] = _to_torch(params)["layers"][0]["self_attn"][
        "q_proj"]
    fused = t_fuse(mixed)
    assert "q_proj" in fused["layers"][0]["self_attn"]
    assert "qkv_proj" in fused["layers"][1]["self_attn"]


def test_dynamic_int8_matmul_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 5, 96)).astype(np.float32)
    x[0, 0, :4] = [127.0, 0.5, 1.5, -2.5]  # ties of x / sx at sx = 1
    w = rng.standard_normal((40, 96)).astype(np.float32)
    jw8, jsw = ji._quantize_int8_rows(jnp.asarray(w))
    tw8, tsw = ti._quantize_int8_rows(torch.from_numpy(w))
    np.testing.assert_array_equal(tw8.numpy(), np.asarray(jw8))
    np.testing.assert_array_equal(tsw.numpy(), np.asarray(jsw))
    # the int32 products, bit for bit
    x8, sx = fm.quantize_activations_int8(torch.from_numpy(x.reshape(-1, 96)))
    jacc = jax.lax.dot_general(jnp.asarray(x8.numpy()), jw8, (((1,), (1,)), ((), ())),
                               preferred_element_type=jnp.int32)
    acc = ti.int8_matmul(x8, tw8)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    ref = np.asarray(ji.dynamic_int8_matmul(jnp.asarray(x), jw8, jsw))
    got = ti.dynamic_int8_matmul(torch.from_numpy(x), tw8, tsw).numpy()
    assert got.shape == (3, 5, 40)
    np.testing.assert_allclose(got, ref, atol=1e-6 * np.abs(ref).max(), rtol=0)


def test_int8_quant_linear_matches_jax(quantized):
    """`patch_quantlinear_to_int8` of the same layer: the same w8 and sw;
    the forward (with a bias, and padded by `pad_for_mxu`) as hqq_tpu's."""
    _, _, qparams = quantized
    jlayer = qparams["layers"][0]["mlp"]["down_proj"]
    tlayer = _to_torch(qparams)["layers"][0]["mlp"]["down_proj"]
    ji8, ti8 = ji.patch_quantlinear_to_int8(jlayer), ti.patch_quantlinear_to_int8(tlayer)
    np.testing.assert_array_equal(ti8.w8.numpy(), np.asarray(ji8.w8))
    np.testing.assert_array_equal(ti8.sw.numpy(), np.asarray(ji8.sw))
    bias = np.random.default_rng(6).standard_normal(ti8.out_features).astype(np.float32)
    ji8 = ji8.replace(bias=jnp.asarray(bias))
    ti8.bias = torch.nn.Parameter(torch.from_numpy(bias), requires_grad=False)
    jpad, tpad = ji.pad_for_mxu(ji8, 384), ti.pad_for_mxu(ti8, 384)
    assert tuple(tpad.w8.shape) == jpad.w8.shape == (384, 768)
    assert (tpad.in_features, tpad.out_features) == (512, 256)
    x = np.random.default_rng(7).standard_normal((2, 3, 512)).astype(np.float32)
    for jmod, tmod in ((ji8, ti8), (jpad, tpad)):
        ref = np.asarray(jmod(jnp.asarray(x)))
        with torch.no_grad():
            got = tmod(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-6 * np.abs(ref).max(), rtol=0)
    np.testing.assert_array_equal(tpad.dequantize(torch.float32).numpy(),
                                  np.asarray(jpad.dequantize(jnp.float32)))


def test_fused_int8_checkpoint_crosses(quantized, tmp_path):
    """A fused int8 tree saved by each package loads in the other and gives
    its logits; the port's is bit-equal after the round trip."""
    cfg, _, qparams = quantized
    jfused = j_fuse(j_prepare(qparams, "int8"), pad_to=512)
    tfused = t_fuse(t_prepare(_to_torch(qparams), "int8"))
    j_save(str(tmp_path / "j"), jfused)
    t_save(str(tmp_path / "t"), tfused)
    from_j, _ = t_load(str(tmp_path / "j"), "cpu")
    from_t, _ = j_load(str(tmp_path / "t"))
    back, _ = t_load(str(tmp_path / "t"), "cpu")
    layer = from_j["layers"][0]["mlp"]["gate_up_proj"]
    assert isinstance(layer, ti.Int8QuantLinear) and layer.w8.shape[0] % 512 == 0
    assert layer.out_features == 2 * cfg.intermediate_size
    assert torch.equal(back["layers"][1]["self_attn"]["qkv_proj"].w8,
                       tfused["layers"][1]["self_attn"]["qkv_proj"].w8)
    (jref, _), (tref, _) = _run_both(jfused, tfused, cfg)
    (jgot, _), (tgot, _) = _run_both(from_t, from_j, cfg)
    for got, ref in zip(tgot + jgot, jref + tref):
        np.testing.assert_allclose(got, ref, atol=_TOL * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("n", [12288, 22016])
def test_launch_plans_take_the_fused_widths(n):
    """The fused widths of Llama-2-7B (q/k/v 3 x 4096, gate/up 2 x 11008)
    get a plan as they are, unpadded: the int8 kernel at decode M, the
    bf16-operand kernel at the prefill buckets; every weight row is in a
    block."""
    for m in (1, 4, 8, 16, 32):
        for meta in (torch.float32, torch.bfloat16):
            plan = fm.w4a8_launch_plan(m, n, 4096, 4, 64, meta)
            assert plan.route == "tensor_cores" and plan.grid[0] * plan.col_tile == n
    for m in (64, 128, 256, 512, 1024):
        plan = fm.qmm_launch_plan(m, n, 4096, 4, 64)
        assert plan.grid[0] * fm.QMM_ROWS >= n and plan.grid[1] * plan.token_tile >= m
        assert plan.splits == 1  # no K split above 32 tokens: chunked prefills stay bit-equal


@pytest.mark.parametrize("backend", ["int8", "plain"])
def test_fused_biases_join_with_zeros(quantized, backend):
    """Biases on some of the joined layers (Qwen2's q/k/v have them): the
    fused layer gives the unfused outputs side by side, a missing bias
    counting as zeros."""
    _, params, qparams = quantized
    tree = (t_prepare(_to_torch(qparams), "int8") if backend == "int8" else _to_torch(params))
    sa = tree["layers"][0]["self_attn"]
    rng = np.random.default_rng(8)
    for name in ("q_proj", "v_proj"):
        sa[name].bias = torch.nn.Parameter(torch.from_numpy(
            rng.standard_normal(sa[name].out_features).astype(np.float32)), requires_grad=False)
    parts = [sa[n] for n in ("q_proj", "k_proj", "v_proj")]
    fused = t_fuse(tree)["layers"][0]["self_attn"]["qkv_proj"]
    x = torch.from_numpy(rng.standard_normal((3, parts[0].in_features)).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(fused(x), torch.cat([p(x) for p in parts], dim=-1),
                                   atol=1e-6, rtol=1e-6)
    assert fused.bias.shape == (fused.out_features,) and not fused.bias[256:320].any()
