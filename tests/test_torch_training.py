# SPDX-License-Identifier: Apache-2.0
"""hqq_tpu_torch's HQQ+ training path against hqq_tpu's, on the CPU.

The recipe of `hqq_tpu` (examples/hqq_plus.py): quantize a Llama model,
wrap every linear but lm_head with LoRA, collect the adapters with
`TrainableParams`, train them with `make_lora_train_step`, merge them back.
A JAX tree is built once, its adapters' B perturbed (so that the gradient
of A is not zero), and carried across with `params_from_numpy`; both
packages then run on the same numbers. LlamaConfig.tiny() (head size 64,
GQA 4/2), fp32 compute, T = 256 after the shift, so the port's attention
takes the flash Function (its backward is the kernels' plain twin here) and
`hqq_tpu`'s its naive path. Bars:
  * the loss: rel diff < 1e-5; every LoRA gradient: rel err < 1e-4 of its
    max|grad| (fp32 sums in another order through two layers and a
    backward);
  * three Adam steps against optax.adam: every train value within 1% of
    the most that three steps of lr = 1e-3 can move it (3e-5). Adam divides
    each gradient by its own running size, so where a gradient is near 0 the
    fp32 noise of the two packages moves its update by a part of lr;
  * merge_lora: the requantized codes equal hqq_tpu's for > 0.999 of them
    (the bar of the quantize tests);
  * the dequant_matmul Function: dx rel err < 1e-6, and no [out, in] float
    tensor among what autograd saves.
"""


import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hqq_tpu.core import peft as jp
from hqq_tpu.core.quantize import BaseQuantizeConfig as JConfig
from hqq_tpu.core.quantize import quantize as j_quantize
from hqq_tpu.core.quantize import unpack_codes as j_unpack_codes
from hqq_tpu.models import llama as jl
from hqq_tpu.models import quantize_model as j_quantize_model
from hqq_tpu.nn import linear as jlin
from hqq_tpu.utils import training as jt
from hqq_tpu_torch.core import peft as tp
from hqq_tpu_torch.core.quantize import unpack_codes as t_unpack_codes
from hqq_tpu_torch.models import llama as tl
from hqq_tpu_torch.nn import linear as tlin
from hqq_tpu_torch.utils import params_from_numpy
from hqq_tpu_torch.utils import training as tt

T = 257  # tokens per row: T = 256 after the shift


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch ops on one thread: the suite's workers share the cores, and
    torch's intra-op threads would oversubscribe them (a case of this
    module took minutes beside five busy workers, seconds alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    """(JAX cfg, JAX tree, port cfg, batch): 4-bit g64 fp32, LoRA r=8
    alpha=16 on every linear but lm_head, B from a seed."""
    cfg = jl.LlamaConfig.tiny()
    params = jl.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    qparams = j_quantize_model(params, JConfig(nbits=4, group_size=64), compute_dtype=jnp.float32)
    lparams = jp.PeftUtils.add_lora(qparams, jp.lora_config(r=8, lora_alpha=16))
    trainable = jp.TrainableParams(lparams)
    rng = np.random.default_rng(0)
    vals = [v if p.endswith("lora_a") else jnp.asarray(rng.standard_normal(v.shape) * 0.02,
                                                       jnp.float32)
            for p, v in zip(trainable.paths, trainable.values())]
    lparams = trainable.inject(vals, lparams)
    batch = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, T)).astype(np.int32)
    return cfg, lparams, tl.LlamaConfig.tiny(), batch


def _port_tree(lparams):
    return params_from_numpy(_numpy(lparams), "cpu")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def test_trainable_paths_equal(models):
    """The default predicate's paths, their order, and every leaf's path
    (a predicate that takes all) are hqq_tpu's."""
    _, lparams, _, _ = models
    params = _port_tree(lparams)
    assert tp.TrainableParams(params).paths == jp.TrainableParams(lparams).paths
    everything = (lambda p: True)
    assert tp.TrainableParams(params, everything).paths == \
        jp.TrainableParams(lparams, everything).paths
    only_a = (lambda p: p.endswith("lora_a"))
    assert tp.TrainableParams(params, only_a).paths == jp.TrainableParams(lparams, only_a).paths
    assert len(tp.TrainableParams(params).paths) == 2 * 7 * 2


def test_values_set_requires_grad_on_adapters_only(models):
    _, lparams, _, _ = models
    params = _port_tree(lparams)
    trainable = tp.TrainableParams(params)
    vals = trainable.values()
    assert all(v.requires_grad for v in vals)
    frozen = [t for p, t in tp._leaves(params) if p not in set(trainable.paths)]
    assert frozen and not any(t.requires_grad for t in frozen)
    assert all(a is b for a, b in zip(trainable.extract(params), vals))


def test_loss_and_lora_gradients_match(models):
    cfg, lparams, tcfg, batch = models
    jtrain = jp.TrainableParams(lparams)
    loss_j, grads_j = jax.value_and_grad(
        lambda vals: jt.causal_lm_loss(jtrain.inject(vals, lparams), cfg, jnp.asarray(batch))
    )(jtrain.values())
    params = _port_tree(lparams)
    trainable = tp.TrainableParams(params)
    vals = trainable.values()
    loss_t = tt.causal_lm_loss(params, tcfg, torch.from_numpy(batch))
    loss_t.backward()
    assert abs(loss_t.item() - float(loss_j)) / abs(float(loss_j)) < 1e-5
    for path, v, g in zip(trainable.paths, vals, grads_j):
        assert v.grad is not None and np.abs(np.asarray(g)).max() > 0, path
        assert _rel(v.grad.numpy(), g) < 1e-4, path


def test_loss_mask_matches(models):
    cfg, lparams, tcfg, batch = models
    mask = np.ones_like(batch)
    mask[:, :100] = 0
    want = float(jt.causal_lm_loss(lparams, cfg, jnp.asarray(batch), jnp.asarray(mask)))
    with torch.no_grad():
        got = tt.causal_lm_loss(_port_tree(lparams), tcfg, torch.from_numpy(batch),
                                torch.from_numpy(mask)).item()
    assert abs(got - want) / abs(want) < 1e-5


def test_three_adam_steps_match_optax(models):
    cfg, lparams, tcfg, batch = models
    jtrain = jp.TrainableParams(lparams)
    vals_j = jtrain.values()
    opt = optax.adam(1e-3)
    state = opt.init(vals_j)
    step_j = jt.make_lora_train_step(cfg, jtrain, opt)
    params = _port_tree(lparams)
    trainable = tp.TrainableParams(params)
    step_t = tt.make_lora_train_step(tcfg, trainable, torch.optim.Adam(trainable.values(), lr=1e-3))
    for _ in range(3):
        vals_j, state, loss_j = step_j(vals_j, state, lparams, jnp.asarray(batch))
        loss_t = step_t(params, torch.from_numpy(batch))
        assert abs(loss_t.item() - float(loss_j)) / abs(float(loss_j)) < 1e-5
    moved = 0.0
    for path, v, w, v0 in zip(trainable.paths, trainable.values(), vals_j, jtrain.values()):
        assert np.abs(v.detach().numpy() - np.asarray(w)).max() < 0.01 * 3 * 1e-3, path
        moved = max(moved, float(np.abs(np.asarray(w) - np.asarray(v0)).max()))
    assert moved > 2e-3  # the steps did move the adapters


def test_loss_falls_over_ten_steps():
    """tests/test_peft.py's recipe (2-bit g32 base, r = 4, alpha 8, Adam
    5e-3) on the port, at T = 256 so that attention is the flash Function."""
    cfg = tl.LlamaConfig.tiny()
    params = tl.init_params(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    from hqq_tpu_torch.core.quantize import BaseQuantizeConfig
    from hqq_tpu_torch.models.base import quantize_model

    quantize_model(params, BaseQuantizeConfig(nbits=2, group_size=32), compute_dtype=torch.float32)
    tp.PeftUtils.add_lora(params, tp.lora_config(r=4, lora_alpha=8))
    trainable = tp.TrainableParams(params)
    step = tt.make_lora_train_step(cfg, trainable, torch.optim.Adam(trainable.values(), lr=5e-3))
    batch = torch.randint(0, cfg.vocab_size, (2, T), generator=torch.Generator().manual_seed(0))
    losses = [step(params, batch).item() for _ in range(10)]
    assert losses[-1] < losses[0], losses
    b = trainable.values()[1]
    assert trainable.paths[1].endswith("lora_b") and b.detach().abs().max() > 0


def test_loss_takes_a_family_forward():
    """causal_lm_loss with ``forward=gemma.forward`` (a Gemma tree at head
    size 256, T = 256: the flash Function) is the mean next-token NLL of
    `hqq_tpu`'s Gemma logits on the same weights; llama's forward on that
    tree is not."""
    from hqq_tpu.models import gemma as jg
    from hqq_tpu_torch.models import gemma as tg

    jcfg = jg.GemmaConfig.tiny()
    jcfg = type(jcfg)(**{**jcfg.__dict__, "head_dim": 256})
    jparams = jg.init_params(jcfg, jax.random.PRNGKey(3), dtype=jnp.float32)
    batch = np.random.default_rng(4).integers(0, jcfg.vocab_size, (1, T + 1)).astype(np.int32)
    logits, _ = jg.forward(jparams, jcfg, jnp.asarray(batch[:, :-1]))
    logp = jax.nn.log_softmax(np.asarray(logits, np.float64), axis=-1)
    want = -float(np.take_along_axis(np.asarray(logp), batch[:, 1:, None], -1).mean())
    tcfg = tg.GemmaConfig(**jcfg.__dict__)
    params = params_from_numpy(_numpy(jparams), "cpu")
    with torch.no_grad():
        got = tt.causal_lm_loss(params, tcfg, torch.from_numpy(batch), forward=tg.forward).item()
        params["lm_head"] = params["embed_tokens"]  # llama's walk needs a head
        other = tt.causal_lm_loss(params, tcfg, torch.from_numpy(batch)).item()
    assert abs(got - want) / abs(want) < 1e-5
    assert abs(other - want) / abs(want) > 1e-3


def test_remat_gives_the_same_gradients(models):
    _, lparams, tcfg, batch = models
    grads = []
    for remat in (False, True):
        params = _port_tree(lparams)
        trainable = tp.TrainableParams(params)
        step = tt.make_lora_train_step(tcfg, trainable,
                                       torch.optim.SGD(trainable.values(), lr=0.0), remat=remat)
        step(params, torch.from_numpy(batch))
        grads.append([v.grad.clone() for v in trainable.values()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0)


def test_inject_writes_values_in_place(models):
    _, lparams, _, _ = models
    params = _port_tree(lparams)
    trainable = tp.TrainableParams(params)
    vals = trainable.values()
    new = [torch.full_like(v, 0.5) for v in vals]
    assert trainable.inject(new) is params
    assert all(torch.equal(v, n) for v, n in zip(trainable.values(), new))
    other = _port_tree(lparams)
    trainable.inject(new, other)
    assert all(torch.equal(v, n) for v, n in zip(trainable.extract(other), new))


def test_merge_lora_codes_match(models):
    _, lparams, _, _ = models
    merged_j = jp.PeftUtils.merge_lora(lparams)
    merged_t = tp.PeftUtils.merge_lora(_port_tree(lparams))
    for name in ("q_proj", "v_proj"):
        lj = merged_j["layers"][1]["self_attn"][name]
        lt = merged_t["layers"][1]["self_attn"][name]
        assert isinstance(lt, tlin.QuantLinear)
        cj = np.asarray(j_unpack_codes(lj.qweight))
        ct = t_unpack_codes(lt.qweight).numpy()
        assert (cj == ct).mean() > 0.999, name
        wj = np.asarray(lj.dequantize(jnp.float32))
        assert _rel(lt.dequantize(torch.float32).numpy(), wj) < 1e-2
    assert not any(isinstance(x, tp.LoRALinear) for x in
                   (merged_t["layers"][0]["mlp"]["up_proj"], merged_t["lm_head"]))


def test_merge_and_quantize_with_a_config(models):
    """With a quant config the merged weight is quantized by it; the biases
    add up."""
    from hqq_tpu_torch.core.quantize import BaseQuantizeConfig

    _, lparams, _, _ = models
    layer = _port_tree(lparams)["layers"][0]["mlp"]["down_proj"]
    layer.bias = tlin._as_param(torch.ones(layer.out_features))
    q = layer.merge_and_quantize(BaseQuantizeConfig(nbits=8, group_size=64))
    assert q.qweight.nbits == 8 and torch.equal(q.bias, torch.ones(layer.out_features))
    assert _rel(q.dequantize(torch.float32).numpy(), layer.merged_weight().detach().numpy()) < 1e-2


def test_lora_dropout():
    """Dropout draws its mask from the generator given; it is off when
    deterministic or without a generator (`hqq_tpu`'s rule), and keeps the
    expected term: each kept value scaled by 1 / (1 - p)."""
    base = tlin.Linear(torch.zeros(8, 512))
    layer = tp.LoRALinear.wrap(base, r=4, dropout=0.25)
    layer.lora_b.data = torch.randn(layer.lora_b.shape, generator=torch.Generator().manual_seed(1))
    x = torch.randn(64, 512, generator=torch.Generator().manual_seed(2))
    plain = layer(x)
    assert torch.equal(layer(x, torch.Generator().manual_seed(3)), plain)
    assert torch.equal(layer(x, None, deterministic=False), plain)
    a = layer(x, torch.Generator().manual_seed(3), deterministic=False)
    b = layer(x, torch.Generator().manual_seed(3), deterministic=False)
    assert torch.equal(a, b) and not torch.equal(a, plain)
    keep = torch.rand(x.shape, generator=torch.Generator().manual_seed(3)) < 0.75
    want = ((torch.where(keep, x / 0.75, 0.0) @ layer.lora_a) @ layer.lora_b) * layer.scaling
    torch.testing.assert_close(a, want, rtol=1e-5, atol=1e-5)
    assert abs(keep.float().mean().item() - 0.75) < 0.01


@pytest.mark.parametrize("nbits,g,dtype", [(4, 64, "float32"), (2, 32, "float32"),
                                           (4, 64, "bfloat16")])
def test_dequant_matmul_backward(nbits, g, dtype):
    """dx of the Function against jax.vjp of hqq_tpu's dequant_matmul, and
    what autograd saves for a QuantLinear: no float [out, in] tensor."""
    rng = np.random.default_rng(nbits)
    w = (rng.standard_normal((96, 256)) / 16).astype(np.float32)
    qj = j_quantize(jnp.asarray(w), nbits=nbits, group_size=g, axis=1,
                    compute_dtype=getattr(jnp, dtype))
    qt = params_from_numpy(_numpy(qj), "cpu")
    x = rng.standard_normal((5, 256)).astype(np.float32)
    gy = rng.standard_normal((5, 96)).astype(np.float32)
    xj = jnp.asarray(x, getattr(jnp, dtype))
    yj, vjp = jax.vjp(lambda x: jlin.dequant_matmul(x, qj), xj)
    (dxj,) = vjp(jnp.asarray(gy, getattr(jnp, dtype)))
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        yt = tlin.QuantLinear(qt)(xt)
    yt.backward(torch.from_numpy(gy).to(getattr(torch, dtype)))
    tol = 1e-6 if dtype == "float32" else 2.0**-7
    assert _rel(yt.detach().float().numpy(), np.asarray(yj, np.float32)) < tol
    assert xt.grad.dtype == xt.dtype
    assert _rel(xt.grad.float().numpy(), np.asarray(dxj, np.float32)) < tol
    assert not any(t.is_floating_point() and tuple(t.shape) == (96, 256) for t in saved)
