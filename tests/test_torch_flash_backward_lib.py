# SPDX-License-Identifier: Apache-2.0
"""The bf16 backward of the port's flash attention against the library's own
backward kernels, on the CPU.

`hqq_tpu`'s training step differentiates the Pallas library's
`flash_attention`, whose VJP runs two kernels (`_flash_attention_bwd_dkv`,
`_flash_attention_bwd_dq`). They round P and scale * dS to the inputs' type
before the products dV = P^T dO, dK = dS^T Q and dQ = dS K, and so do the
port's bf16 kernels and their plain twin, `flash_attention_backward_plain`.
Here the library's VJP runs in interpret mode (block sizes 128) on bf16
inputs from a numpy seed, and the twin is fed the library forward's own
residuals (its output and lse = m + log l), so that both sides start from the
same values and only the backward's arithmetic differs.

Bars, of each gradient:
  * the largest error at most one bf16 step of max|grad| (2^-7): both sides
    round each output once, and a value that falls between the two roundings
    of nearly equal sums lands one step apart;
  * the mean error at most 2^-12 of mean|grad|: the twin rounds where the
    library rounds, so nearly every value is bit-equal (all but 0.2% at
    most) and the mean stays 50x or more below the bar (at most 4.6e-6).
The control, the same twin on fp32 values (P and dS not rounded, outputs
rounded to bf16 afterwards), misses the mean bar by 6.6-7x (1.6e-3 to
1.7e-3): about 0.4 of its values differ from the library's. The largest
errors of the twin read 8.6e-5 to 2.7e-3 (the last a single output that
fell one step apart, so 2^-9 of max|grad| would be a bar below one output
step).

The library's kernel takes K and V repeated over each kv head's query heads
(as `hqq_tpu`'s model repeats them), so a GQA case holds the twin per query
head on the repeated K and V, and then its own sum over the group against
the library's per-head gradients summed in fp32: there the library's
rounding of each head's dK and dV before the sum leaves only the max bar.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu import flash_attention as lib

from hqq_tpu_torch.ops import attention as at

_BLOCKS = lib.BlockSizes(block_q=128, block_k_major=128, block_k=128, block_b=1,
                         block_q_major_dkv=128, block_k_major_dkv=128, block_k_dkv=128,
                         block_q_dkv=128, block_k_major_dq=128, block_k_dq=128, block_q_dq=128)
_MAX_BAR, _MEAN_BAR = 2.0**-7, 2.0**-12


def _errors(got, want):
    """(largest error / max|want|, mean error / mean|want|) of each pair."""
    out = []
    for g, w in zip(got, want):
        err = np.abs(g.float().numpy().astype(np.float64) - w)
        out.append((err.max() / np.abs(w).max(), err.mean() / np.abs(w).mean()))
    return out


@pytest.mark.parametrize("b,nh,n_kv,t,hd,causal", [
    (1, 2, 2, 256, 128, True), (1, 2, 2, 256, 64, False), (1, 4, 2, 384, 64, True),
    (1, 2, 2, 384, 128, False)])
def test_backward_plain_matches_library_kernels(b, nh, n_kv, t, hd, causal):
    rng = np.random.default_rng(t + hd + nh)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in (
        (b, nh, t, hd), (b, n_kv, t, hd), (b, n_kv, t, hd), (b, nh, t, hd)))
    rep, scale = nh // n_kv, hd**-0.5
    kr, vr = np.repeat(k, rep, axis=1), np.repeat(v, rep, axis=1)
    bf = lambda x: jnp.asarray(x, jnp.bfloat16)  # noqa: E731

    def fwd(q_, k_, v_):
        return lib.flash_attention(q_, k_, v_, causal=causal, sm_scale=scale,
                                   block_sizes=_BLOCKS)

    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(fwd, bf(q), bf(kr), bf(vr))
        want = [np.asarray(x.astype(jnp.float32), np.float64) for x in vjp(bf(do))]
        o, l, m = lib._flash_attention(bf(q), bf(kr), bf(vr), None, None, True, causal, scale,
                                       _BLOCKS, False)

    def t16(x):
        return torch.tensor(np.asarray(x, np.float32)).to(torch.bfloat16)

    out = t16(o.astype(jnp.float32))
    lse = torch.tensor(np.asarray(m + jnp.log(l), np.float32))
    args = (t16(q), t16(kr), t16(vr), out, lse, t16(do))
    got = at.flash_attention_backward_plain(*args, causal)
    control = [x.to(torch.bfloat16) for x in at.flash_attention_backward_plain(
        *(x.float() for x in args), causal)]
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == w.shape
    for max_err, mean_err in _errors(got, want):
        assert max_err <= _MAX_BAR and mean_err <= _MEAN_BAR, (max_err, mean_err)
    assert all(mean_err > _MEAN_BAR for _, mean_err in _errors(control, want))

    if rep > 1:  # the twin's own GQA: one rounding after the sum over the group
        grouped = at.flash_attention_backward_plain(t16(q), t16(k), t16(v), out, lse, t16(do),
                                                    causal)
        summed = [want[0]] + [w.reshape(b, n_kv, rep, t, hd).sum(axis=2) for w in want[1:]]
        for max_err, _ in _errors(grouped, summed):
            assert max_err <= _MAX_BAR, max_err
