# SPDX-License-Identifier: Apache-2.0
"""hqq_tpu_torch.ops.fused_matmul against hqq_tpu.ops.fused_matmul.

One JAX QTensor is carried across with params_from_numpy; each side builds
its own kernel layout from it. On the CPU the port's wrappers run their
plain versions and the JAX side runs its Pallas kernels in interpret mode.
Bars:
  * quant_matmul_pallas_a8, on every route of hqq_tpu's dispatch: rel err
    < 2e-5 of max|y| against hqq_tpu and against x8*sx @ W_dq^T (the bar of
    test_w4a8.py): the group dots are exact, fp32 epilogues sum in another
    order;
  * quant_matmul_pallas in fp32: rtol 1e-5 of max|y|;
  * dequant_pallas: equal to fp32 rounding. hqq_tpu's 4-bit layout stores
    zs = (zero - 8)*scale for signed codes, the port zero*scale for
    unsigned ones, so the two differ by the rounding of that product;
  * a layer served with bf16 scale and zs (axis=1): the port stores the
    bf16 values hqq_tpu stores, bit for bit (in the 4-bit container both
    keep (zero - 8)*scale); the int8 route (M <= 32) matches hqq_tpu to
    2e-5 of max|y|; hqq_tpu's bf16-operand kernel dequantizes in bf16
    arithmetic (each weight rounded to bf16, 2^-9 of it) where the port
    widens to fp32 first, so that route holds at 2^-7 of max|y|, and the
    port's output is within 1e-5 of the float64 product with the stored
    values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hqq_tpu.core.quantize import dequantize as j_dequantize
from hqq_tpu.core.quantize import quantize as j_quantize
from hqq_tpu.ops import fused_matmul as jf
from hqq_tpu_torch.ops import fused_matmul as tf
from hqq_tpu_torch.utils.convert import params_from_numpy

# (m, n_out, k, g, nbits, pad_k_groups of the JAX layout): each row names the
# hqq_tpu route it drives
_A8_CASES = [
    (1, 256, 2048, 64, 4, 32),  # M=1, K % 32g == 0: class-replicated S=32
    (1, 256, 1024, 64, 4, 16),  # M=1, K % 16g == 0 only: S=16
    (8, 256, 512, 64, 4, 8),    # M=8: class-replicated meff=8
    (24, 256, 512, 64, 4, 8),   # M=24: meff=32
    (4, 256, 256, 64, 4, 8),    # K % 8g != 0: batched per-group kernel
    (40, 256, 512, 64, 4, 8),   # M > 32: bf16-operand kernel
    (8, 256, 512, 64, 2, 8),    # 2-bit container
    (4, 128, 256, 32, 1, 8),    # 1-bit container
    (4, 128, 512, 64, 3, 8),    # 3-bit in the 4-bit container
    (4, 128, 512, 64, 8, 8),    # 8-bit: bf16-operand kernel
]


def _carry(m, n_out, k, g, nbits, pad_k):
    rng = np.random.default_rng(m * 1000 + k + nbits)
    w = (rng.standard_normal((n_out, k)) / np.sqrt(k)).astype(np.float32)
    qj = j_quantize(jnp.asarray(w), nbits=nbits, group_size=g, axis=1,
                    round_zero=(nbits == 4), compute_dtype=jnp.float32)
    kj = jf.to_kernel_layout(qj, pad_k_groups=pad_k)
    qt = params_from_numpy(jax.tree_util.tree_map(np.asarray, qj), "cpu")
    kt = tf.to_kernel_layout(qt)
    x = rng.standard_normal((m, k)).astype(np.float32)
    return qj, kj, kt, x


@pytest.mark.parametrize("m,n_out,k,g,nbits,pad_k", _A8_CASES)
def test_quant_matmul_pallas_a8(m, n_out, k, g, nbits, pad_k):
    qj, kj, kt, x = _carry(m, n_out, k, g, nbits, pad_k)
    yj = np.asarray(jf.quant_matmul_pallas_a8(jnp.asarray(x), kj))
    yt = tf.quant_matmul_pallas_a8(torch.from_numpy(x), kt).numpy()
    assert yt.shape == yj.shape == (m, n_out)

    w_dq = np.asarray(j_dequantize(qj, jnp.float32)).astype(np.float64)
    if m <= 32 and nbits != 8:
        x8, sx = jf.quantize_activations_int8(jnp.asarray(x))
        x8t, sxt = tf.quantize_activations_int8(torch.from_numpy(x))
        np.testing.assert_array_equal(x8t.numpy(), np.asarray(x8))
        np.testing.assert_array_equal(sxt.numpy(), np.asarray(sx))
        expected = (np.asarray(x8, np.float64) * np.asarray(sx)) @ w_dq.T
    else:
        expected = x.astype(np.float64) @ w_dq.T
    scale = np.abs(expected).max()
    assert np.abs(yt - yj).max() / scale < 2e-5
    assert np.abs(yt - expected).max() / scale < 2e-5


@pytest.mark.parametrize("m,n_out,k,g,nbits", [(3, 256, 512, 64, 4), (40, 128, 256, 32, 2),
                                               (5, 128, 512, 64, 8)])
def test_quant_matmul_pallas_fp32(m, n_out, k, g, nbits):
    _, kj, kt, x = _carry(m, n_out, k, g, nbits, 8)
    yj = np.asarray(jf.quant_matmul_pallas(jnp.asarray(x), kj))
    yt = tf.quant_matmul_pallas(torch.from_numpy(x), kt).numpy()
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-5 * np.abs(yj).max())
    # leading dims are kept
    y3 = tf.quant_matmul_pallas(torch.from_numpy(x).reshape(1, m, k), kt)
    assert tuple(y3.shape) == (1, m, n_out)


@pytest.mark.parametrize("n_out,k,g,nbits", [(256, 512, 64, 4), (128, 256, 32, 1),
                                             (128, 512, 64, 2), (128, 512, 64, 3),
                                             (128, 256, 64, 8)])
def test_dequant_pallas(n_out, k, g, nbits):
    qj, kj, kt, _ = _carry(1, n_out, k, g, nbits, 8)
    dj = np.asarray(jf.dequant_pallas(kj))
    dt = tf.dequant_pallas(kt).numpy()
    assert dt.shape == dj.shape == (k, n_out)
    ulp = np.finfo(np.float32).eps * np.abs(dj).max()
    np.testing.assert_allclose(dt, dj, rtol=0, atol=2 * ulp)
    # and the port's plain dequant equals its canonical QTensor dequantize
    qt = params_from_numpy(jax.tree_util.tree_map(np.asarray, qj), "cpu")
    canon = qt.dequantize(torch.float32).numpy()
    np.testing.assert_allclose(dt.T, canon, rtol=0, atol=2 * ulp)


@pytest.mark.parametrize("nbits,g", [(4, 64), (4, 32), (2, 64), (1, 32), (8, 16), (3, 64)])
def test_kernel_layout_roundtrip(nbits, g):
    """The word layout packs and unpacks every container exactly."""
    rng = np.random.default_rng(nbits * 100 + g)
    cb = tf._KERNEL_CONTAINER_BITS[nbits]
    codes = torch.from_numpy(rng.integers(0, 2 ** min(nbits, 8), size=(6, 4 * g)).astype(np.int32))
    packed = tf._pack_words(codes, cb)
    assert packed.dtype == torch.uint8 and tuple(packed.shape) == (6, 4 * g * cb // 8)
    torch.testing.assert_close(tf._unpack_words(packed, cb), codes)


def test_wrappers_count_nothing_on_cpu():
    """On CPU tensors the wrappers run their plain versions: no launch is
    counted."""
    _, _, kt, x = _carry(2, 128, 256, 64, 4, 8)
    tf.reset_launch_counts()
    tf.quant_matmul_pallas_a8(torch.from_numpy(x), kt)
    tf.quant_matmul_pallas(torch.from_numpy(x), kt)
    tf.dequant_pallas(kt)
    assert (tf.w4a8_matmul.launches, tf.quant_matmul.launches, tf.dequant.launches) == (0, 0, 0)


@pytest.mark.parametrize("m", [3, 40])
@pytest.mark.parametrize("nbits,g", [(4, 64), (2, 32), (3, 64), (8, 64)])
def test_bf16_meta_layer_matches_hqq_tpu(m, nbits, g):
    from hqq_tpu.backends import pallas_backend as jb
    from hqq_tpu.nn.linear import QuantLinear as JQuantLinear
    from hqq_tpu_torch.backends import pallas_backend as tb

    rng = np.random.default_rng(m + nbits * 10)
    w = (rng.standard_normal((256, 512)) / np.sqrt(512)).astype(np.float32)
    qj = j_quantize(jnp.asarray(w), nbits=nbits, group_size=g, axis=1,
                    round_zero=(nbits == 4), compute_dtype=jnp.float32)
    lj = JQuantLinear(qweight=qj)
    lt = params_from_numpy(jax.tree_util.tree_map(np.asarray, lj), "cpu")
    x = rng.standard_normal((m, 512)).astype(np.float32)
    groups = 512 // g
    for pj, pt in ((jb.patch_quantlinear_to_pallas, tb.patch_quantlinear_to_pallas),
                   (jb.patch_quantlinear_to_w4a8, tb.patch_quantlinear_to_w4a8)):
        mj, mt = pj(lj, meta_dtype=jnp.bfloat16), pt(lt, meta_dtype=torch.bfloat16)
        assert mt.kqt.scale.dtype == torch.bfloat16 and mt.kqt.scale.shape[1] % 8 == 0
        for name in ("scale", "zs"):
            want = np.asarray(getattr(mj.kqt, name).astype(jnp.float32))[:groups, :256].T
            assert np.array_equal(getattr(mt.kqt, name)[:, :groups].float().numpy(), want)
        yj = np.asarray(mj(jnp.asarray(x)))
        yt = mt(torch.from_numpy(x)).numpy()
        scale = np.abs(yj).max()
        int8_route = pt is tb.patch_quantlinear_to_w4a8 and m <= tf.A8_MAX_M and nbits != 8
        assert np.abs(yt - yj).max() / scale < (2e-5 if int8_route else 2.0**-7)
        if not int8_route:
            w64 = tf.dequant_plain(mt.kqt, torch.float64).numpy()
            expected = x.astype(np.float64) @ w64.T
            assert np.abs(yt - expected).max() / np.abs(expected).max() < 1e-5
