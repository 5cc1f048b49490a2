# SPDX-License-Identifier: Apache-2.0
"""hqq_tpu_torch.core.quantize against hqq_tpu.core.quantize on the same
weights, at the bars of the reference-parity test in test_quantize.py:
codes match > 0.999, scale rtol 1e-5, zero rtol 1e-4 (atol 5e-4), dequant
max diff < 5e-3. The input is that test's (seed 1234, 128x128 / 8): the
solver rounds ties, so a different input can flip a code on either side."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hqq_tpu.core.optimize import optimize_weights_proximal as j_opt
from hqq_tpu.core.quantize import BaseQuantizeConfig as JConfig
from hqq_tpu.core.quantize import dequantize as j_dequantize
from hqq_tpu.core.quantize import quantize as j_quantize
from hqq_tpu.core.quantize import unpack_codes as j_unpack
from hqq_tpu.nn.linear import QuantLinear as JQuantLinear
from hqq_tpu_torch.core.optimize import optimize_weights_proximal as t_opt
from hqq_tpu_torch.core.quantize import BaseQuantizeConfig as TConfig
from hqq_tpu_torch.core.quantize import dequantize as t_dequantize
from hqq_tpu_torch.core.quantize import quantize as t_quantize
from hqq_tpu_torch.core.quantize import unpack_codes as t_unpack
from hqq_tpu_torch.nn.linear import QuantLinear as TQuantLinear
from hqq_tpu_torch.utils.convert import params_from_numpy


def _weight():
    rng = np.random.default_rng(1234)
    return (rng.standard_normal((128, 128)) / 8).astype(np.float32)


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("nbits", [8, 4, 3, 2])
def test_quantize_matches_jax(nbits, axis, optimize):
    w = _weight()
    kw = dict(nbits=nbits, group_size=64, axis=axis, round_zero=(nbits == 4), optimize=optimize)
    qj = j_quantize(jnp.asarray(w), **kw)
    qt = t_quantize(torch.from_numpy(w), **kw)

    assert qt.packing == qj.packing and qt.shape == qj.shape
    assert tuple(qt.wq.shape) == qj.wq.shape
    match = np.mean(t_unpack(qt, torch.int32).numpy() == np.asarray(j_unpack(qj, jnp.int32)))
    assert match > 0.999, match
    np.testing.assert_allclose(qt.scale.numpy(), np.asarray(qj.scale), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(qt.zero.numpy(), np.asarray(qj.zero), rtol=1e-4, atol=5e-4)
    err = np.abs(t_dequantize(qt, torch.float32).numpy()
                 - np.asarray(j_dequantize(qj, jnp.float32))).max()
    assert err < 5e-3, err


@pytest.mark.parametrize("iters", [1, 2, 20])
def test_solver_zero_matches_jax(iters):
    """The early stop keeps the failing iteration's zero: the zero after
    any iteration count agrees with hqq_tpu's loop."""
    w = _weight().reshape(-1, 64)
    mn, mx = w.min(1, keepdims=True), w.max(1, keepdims=True)
    scale = (15.0 / (mx - mn)).astype(np.float32)
    zero = np.round(-mn * scale).astype(np.float32)
    opt = dict(iters=iters)
    _, _, zj = j_opt(jnp.asarray(w), jnp.asarray(scale), jnp.asarray(zero), (0, 15), axis=1,
                     opt_params=opt)
    wq, _, zt = t_opt(torch.from_numpy(w), torch.from_numpy(scale), torch.from_numpy(zero),
                      (0, 15), axis=1, opt_params=opt)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=1e-4, atol=5e-4)
    assert wq.min() >= 0 and wq.max() <= 15


@pytest.mark.parametrize("quant_zero,quant_scale", [(True, False), (False, True), (True, True)])
def test_meta_quantization_matches_jax(quant_zero, quant_scale):
    """quant_zero / quant_scale: scale and zero are themselves 8-bit
    QTensors; the dequantized weights agree, also after carrying the JAX
    QTensor across with params_from_numpy."""
    w = _weight()
    with pytest.warns(DeprecationWarning):
        jcfg = JConfig(nbits=4, group_size=64, quant_zero=quant_zero, quant_scale=quant_scale)
    with pytest.warns(DeprecationWarning):
        tcfg = TConfig(nbits=4, group_size=64, quant_zero=quant_zero, quant_scale=quant_scale)
    lj = JQuantLinear.quantize(jnp.asarray(w), quant_config=jcfg, compute_dtype=jnp.float32)
    lt = TQuantLinear.quantize(torch.from_numpy(w), quant_config=tcfg, compute_dtype=torch.float32)
    assert lt.qweight.is_meta_quantized and lj.qweight.is_meta_quantized
    ref = np.asarray(lj.dequantize(jnp.float32))
    err = np.abs(lt.dequantize(torch.float32).numpy() - ref).max()
    assert err < 5e-3, err

    carried = params_from_numpy(jax.tree_util.tree_map(np.asarray, lj.qweight), "cpu")
    np.testing.assert_allclose(t_dequantize(carried, torch.float32).numpy(), ref,
                               rtol=0, atol=1e-6)


def test_config_matches_jax():
    for kw in (dict(), dict(nbits=3, group_size=32, axis=0), dict(nbits=4, round_zero=False)):
        jc, tc = JConfig(**kw), TConfig(**kw)
        jw = dict(jc["weight_quant_params"], compute_dtype=None)
        tw = dict(tc["weight_quant_params"], compute_dtype=None)
        assert jw == tw
        assert jc["scale_quant_params"] == tc["scale_quant_params"]
        assert jc["zero_quant_params"] == tc["zero_quant_params"]
