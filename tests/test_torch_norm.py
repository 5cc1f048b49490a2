# SPDX-License-Identifier: Apache-2.0
"""hqq_tpu_torch's RMSNorm and LayerNorm (`ops/norm.py`, csrc/rms_norm.cu)
on the CPU.

* `norm_launch_plan`: the summation order by width and element size, and a
  numpy restatement of the kernel's walk (thread t's vectors t, t + threads,
  ... summed element by element in float32, the halving tree, ms / d,
  1 / sqrt, the two products) bit-equal to the plain twin.
* The twin is bit-equal for a row normed alone and the same row inside
  calls of 4, 32 and 1024 rows; PyTorch's own fp32 mean is the control
  whose order is not promised (not asserted to fail: on the CPU it may
  agree).
* Against `hqq_tpu`'s `rms_norm` and `_gemma_norm`: within 2e-6 of max|y| in
  fp32 (another summation order and rsqrt, a few ulps), within one bf16
  step (2^-7 of max|y|) in bf16.
* The autograd Function's backward against torch.autograd of the formula,
  and `models.llama.rms_norm` through it.
* On the card (skips here): the kernel bit-equal to the twin, rows
  invariant, one launch a call.
* LayerNorm likewise: `layer_norm_plain` bit-equal to a numpy walk of the
  kernel's two sums (with and without a bias, per-head weights [H, d]) in
  its own plan's order (`norm_launch_plan(..., layer=True)`: a row in
  registers, the fewest threads that hold it); rows invariant; within 2e-6
  of max|y| of each of `hqq_tpu`'s three LayerNorms in fp32
  (`vit._layer_norm`, `phi.layer_norm`, `cohere.cohere_norm`), also at the
  widths of the vision towers and the LayerNorm families; its Function's
  backward against autograd; on the card, the kernel bit-equal to the
  twin.
"""

import numpy as np
import pytest
import torch

from hqq_tpu_torch.models import llama as tl
from hqq_tpu_torch.ops import norm as nm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch ops on one thread: the suite's workers share the cores, and
    torch's intra-op threads would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(n, d, dtype=torch.bfloat16, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32) * 3).to(dtype)


def _weight(d, dtype=torch.bfloat16, seed=1):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(d).astype(np.float32) * 0.1).to(dtype)


@pytest.mark.parametrize("d,dtype,plan", [
    (4096, torch.bfloat16, (8, 256, 2, 1)),
    (3584, torch.bfloat16, (8, 128, 4, 2)),
    (3072, torch.bfloat16, (8, 128, 3, 2)),
    (1024, torch.bfloat16, (8, 64, 2, 4)),
    (256, torch.bfloat16, (8, 32, 1, 8)),
    (128, torch.bfloat16, (8, 32, 1, 8)),
    (96, torch.float16, (8, 32, 1, 8)),
    (100, torch.bfloat16, (1, 32, 4, 8)),
    (4096, torch.float32, (4, 512, 2, 1)),
    (14336, torch.bfloat16, (8, 512, 4, 1)),
    (65536, torch.float32, (4, 1024, 16, 1)),
    (1, torch.float32, (1, 32, 1, 8)),
    (4544, torch.bfloat16, (8, 256, 3, 1)),
    (1600, torch.bfloat16, (8, 64, 4, 4)),
    (2560, torch.bfloat16, (8, 128, 3, 2)),
    (12288, torch.bfloat16, (8, 512, 3, 1)),
])
def test_launch_plan(d, dtype, plan):
    p = nm.norm_launch_plan(d, dtype)
    assert (p.vec, p.threads, p.steps, p.rows_per_block) == plan
    assert p.threads == 1 << p.threads_log2 and 32 <= p.threads <= 1024
    nvec = d // p.vec
    assert (p.steps - 1) * p.threads < nvec <= p.steps * p.threads
    assert p.rows_per_block * p.threads <= 1024


@pytest.mark.parametrize("dtype,d", [(torch.int8, 64), (torch.float64, 64), (torch.bfloat16, 0)])
def test_launch_plan_refuses(dtype, d):
    with pytest.raises(ValueError):
        nm.norm_launch_plan(d, dtype)


def _kernel_walk(x: np.ndarray, w: np.ndarray, eps: float, offset: float, plan) -> np.ndarray:
    """The kernel's arithmetic, thread by thread, in numpy float32."""
    f32 = np.float32
    rows, d = x.shape
    nvec = d // plan.vec
    out = np.empty_like(x)
    for r in range(rows):
        part = np.zeros(plan.threads, f32)
        for t in range(plan.threads):
            acc = f32(0)
            for v in range(t, nvec, plan.threads):
                for j in range(plan.vec):
                    e = x[r, v * plan.vec + j]
                    acc = f32(acc + f32(e * e))
            part[t] = acc
        s = plan.threads // 2
        while s >= 1:
            part[:s] = part[:s] + part[s:2 * s]
            s //= 2
        rinv = f32(1) / np.sqrt(f32(f32(part[0] / f32(d)) + f32(eps)), dtype=f32)
        out[r] = (x[r] * rinv) * (w + f32(offset))
    return out


@pytest.mark.parametrize("d,dtype,offset", [(256, torch.bfloat16, 0.0), (100, torch.float32, 1.0),
                                            (96, torch.float16, 1.0), (1024, torch.float32, 0.0)])
def test_twin_is_the_kernel_walk(d, dtype, offset):
    x, w = _rows(3, d, dtype), _weight(d, torch.float32)
    plan = nm.norm_launch_plan(d, dtype)
    want = _kernel_walk(x.float().numpy(), w.numpy(), 1e-6, offset, plan)
    got = nm.rms_norm_plain(x, w, 1e-6, offset)
    assert torch.equal(got, torch.from_numpy(want).to(dtype))


@pytest.mark.parametrize("d,dtype,offset", [(4096, torch.bfloat16, 0.0), (3584, torch.bfloat16, 1.0),
                                            (128, torch.float32, 0.0), (100, torch.float16, 1.0)])
def test_rows_invariant(d, dtype, offset):
    x, w = _rows(1024, d, dtype, seed=d), _weight(d, dtype)
    alone = torch.cat([nm.rms_norm(x[i:i + 1], w, 1e-5, offset) for i in range(1024)])
    for c in (4, 32, 1024):
        got = torch.cat([nm.rms_norm(x[i:i + c], w, 1e-5, offset) for i in range(0, 1024, c)])
        assert torch.equal(got, alone), c


@pytest.fixture(scope="module")
def jax_norms():
    import jax.numpy as jnp

    from hqq_tpu.models.gemma import _gemma_norm
    from hqq_tpu.models.llama import rms_norm

    def run(fn, x, w, eps):
        out = fn(jnp.asarray(x.float().numpy()).astype(_jdtype(x.dtype)),
                 jnp.asarray(w.float().numpy()).astype(_jdtype(w.dtype)), eps)
        return torch.from_numpy(np.array(out.astype(jnp.float32)))

    return {0.0: lambda x, w, eps: run(rms_norm, x, w, eps),
            1.0: lambda x, w, eps: run(_gemma_norm, x, w, eps)}


def _jdtype(dt):
    import jax.numpy as jnp

    return {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dt]


@pytest.mark.parametrize("offset", [0.0, 1.0])
@pytest.mark.parametrize("dtype,d,bar", [(torch.float32, 4096, 2e-6), (torch.float32, 128, 2e-6),
                                         (torch.bfloat16, 3584, 2.0**-7)])
def test_against_hqq_tpu(jax_norms, offset, dtype, d, bar):
    x, w = _rows(16, d, dtype, seed=3), _weight(d, dtype)
    want = jax_norms[offset](x, w, 1e-6)
    got = nm.rms_norm(x, w, 1e-6, offset).float()
    assert (got - want).abs().max().item() <= bar * want.abs().max().item()


@pytest.mark.parametrize("offset,w_grad", [(0.0, False), (1.0, True)])
def test_backward_against_autograd(offset, w_grad):
    x = _rows(6, 256, torch.float32, seed=4).reshape(2, 3, 256).requires_grad_(True)
    w = _weight(256, torch.float32).requires_grad_(w_grad)
    g = _rows(6, 256, torch.float32, seed=5).reshape(2, 3, 256)
    y = nm.apply_rms_norm(x, w, 1e-5, offset)
    dx, *dw = torch.autograd.grad(y, [x, w] if w_grad else [x], g)

    x2, w2 = x.detach().clone().requires_grad_(True), w.detach().clone().requires_grad_(w_grad)
    ref = x2 * torch.rsqrt((x2 * x2).mean(-1, keepdim=True) + 1e-5) * (w2 + offset)
    rdx, *rdw = torch.autograd.grad(ref, [x2, w2] if w_grad else [x2], g)
    torch.testing.assert_close(y.detach(), ref.detach(), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(dx, rdx, rtol=1e-5, atol=1e-6)
    if w_grad:
        torch.testing.assert_close(dw[0], rdw[0], rtol=1e-5, atol=1e-5)


def test_llama_rms_norm_is_the_twin_on_the_cpu():
    x, w = _rows(5, 4096, torch.bfloat16, seed=6), _weight(4096)
    before = nm.rms_norm.launches
    assert torch.equal(tl.rms_norm(x, w, 1e-5), nm.rms_norm_plain(x, w, 1e-5))
    assert nm.rms_norm.launches == before  # the CPU route launches nothing


def test_other_devices_refused():
    """A tensor on another device than cpu or cuda gets no kernel."""
    x = torch.zeros((2, 64), device="meta")
    with pytest.raises(RuntimeError):
        nm.rms_norm(x, torch.zeros(64, device="meta"), 1e-5)


@pytest.mark.cuda
def test_kernel_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for dt in (torch.bfloat16, torch.float16, torch.float32):
        for d in (64, 100, 128, 3584, 4096):
            x, w = _rows(1024, d, dt, seed=d).cuda(), _weight(d, torch.float32).cuda()
            before = nm.rms_norm.launches
            y = nm.rms_norm(x, w, 1e-6, 1.0)
            assert nm.rms_norm.launches == before + 1
            assert torch.equal(y, nm.rms_norm_plain(x, w, 1e-6, 1.0))
            alone = torch.cat([nm.rms_norm(x[i:i + 1], w, 1e-6, 1.0) for i in range(32)])
            assert torch.equal(alone, y[:32])


def _ln_walk(x: np.ndarray, w: np.ndarray, b, eps: float, plan) -> np.ndarray:
    """The LayerNorm kernel's arithmetic, thread by thread, in numpy
    float32: the sum of x, mu = sum / d, the sum of (x - mu)^2, then
    ((x - mu) * r) * w (+ b). w and b are [H, d] (H = 1 for one weight
    row); row r reads row r % H."""
    f32 = np.float32
    rows, d = x.shape
    nvec = d // plan.vec

    def row_sum(vals):
        part = np.zeros(plan.threads, f32)
        for t in range(plan.threads):
            acc = f32(0)
            for v in range(t, nvec, plan.threads):
                for j in range(plan.vec):
                    acc = f32(acc + vals[v * plan.vec + j])
            part[t] = acc
        s = plan.threads // 2
        while s >= 1:
            part[:s] = part[:s] + part[s:2 * s]
            s //= 2
        return part[0]

    out = np.empty_like(x)
    for r in range(rows):
        mu = f32(row_sum(x[r]) / f32(d))
        c = (x[r] - mu).astype(f32)
        var = f32(row_sum((c * c).astype(f32)) / f32(d))
        rinv = f32(1) / np.sqrt(f32(var + f32(eps)), dtype=f32)
        h = r % w.shape[0]
        y = (c * rinv) * w[h]
        out[r] = y if b is None else y + b[h]
    return out


@pytest.mark.parametrize("d,dtype,bias,heads", [
    (256, torch.bfloat16, True, 1), (100, torch.float32, False, 1), (96, torch.float16, True, 1),
    (1600, torch.float32, True, 1), (128, torch.float32, False, 3)])
def test_layer_norm_twin_is_the_kernel_walk(d, dtype, bias, heads):
    x = _rows(3 * heads, d, dtype)
    w = torch.stack([_weight(d, torch.float32, seed=h) + 1 for h in range(heads)])
    b = (torch.stack([_weight(d, torch.float32, seed=10 + h) for h in range(heads)])
         if bias else None)
    plan = nm.norm_launch_plan(d, dtype, layer=True)
    want = _ln_walk(x.float().numpy(), w.numpy(), None if b is None else b.numpy(), 1e-5, plan)
    xs = x.reshape(3, heads, d)
    got = nm.layer_norm_plain(xs, w if heads > 1 else w[0],
                              None if b is None else (b if heads > 1 else b[0]), 1e-5)
    assert torch.equal(got.reshape(3 * heads, d), torch.from_numpy(want).to(dtype))


# the LayerNorm plan (vec, threads, steps, rows_per_block) at the widths of
# the vision towers (1024 CLIP and ViT-L, 1152 SigLIP, 1280 Qwen2-VL) and of
# the families (2560 phi-2, 4096 bloom, 4544 Falcon-7B): a row in at most 40
# values a thread, one warp a row up to 1280
_LN_PLANS = {
    (1024, torch.bfloat16): (8, 32, 4, 4), (1152, torch.bfloat16): (8, 32, 5, 4),
    (1280, torch.bfloat16): (8, 32, 5, 4), (2560, torch.bfloat16): (8, 64, 5, 2),
    (4096, torch.bfloat16): (8, 128, 4, 1), (4544, torch.bfloat16): (8, 128, 5, 1),
    (1024, torch.float32): (4, 32, 8, 4), (1152, torch.float32): (4, 32, 9, 4),
    (1280, torch.float32): (4, 32, 10, 4), (2560, torch.float32): (4, 64, 10, 2),
    (4096, torch.float32): (4, 128, 8, 1), (4544, torch.float32): (4, 128, 9, 1),
}


@pytest.mark.parametrize("d,dtype", list(_LN_PLANS))
def test_layer_norm_launch_plan(d, dtype):
    p = nm.norm_launch_plan(d, dtype, layer=True)
    assert (p.vec, p.threads, p.steps, p.rows_per_block) == _LN_PLANS[d, dtype]
    nvec = d // p.vec
    assert (p.steps - 1) * p.threads < nvec <= p.steps * p.threads
    assert p.steps * p.vec <= nm._LN_REG_FLOATS
    # the fewest threads that hold the row: half of them would not
    assert p.threads == 32 or -(-nvec // (p.threads // 2)) * p.vec > nm._LN_REG_FLOATS
    assert p.rows_per_block * p.threads == max(128, p.threads) <= nm._LN_MAX_ROW_THREADS


@pytest.mark.parametrize("d,dtype", [(4544, torch.bfloat16), (1600, torch.bfloat16),
                                     (128, torch.float32), (100, torch.float16)])
def test_layer_norm_rows_invariant(d, dtype):
    x, w, b = _rows(1024, d, dtype, seed=d), _weight(d, dtype), _weight(d, dtype, seed=2)
    alone = torch.cat([nm.layer_norm(x[i:i + 1], w, b, 1e-5) for i in range(1024)])
    for c in (4, 32, 1024):
        got = torch.cat([nm.layer_norm(x[i:i + c], w, b, 1e-5) for i in range(0, 1024, c)])
        assert torch.equal(got, alone), c


@pytest.mark.parametrize("d", [1024, 1152, 1280, 2560, 4096, 4544])
def test_layer_norm_rows_invariant_at_the_plan_widths(d):
    """The widths of `_LN_PLANS` in bf16: 128 rows normed alone, in calls of
    4 and 32 rows and all at once, bit-equal."""
    x, w, b = _rows(128, d, seed=d) + 1, _weight(d), _weight(d, seed=2)
    alone = torch.cat([nm.layer_norm(x[i:i + 1], w, b, 1e-5) for i in range(128)])
    for c in (4, 32, 128):
        got = torch.cat([nm.layer_norm(x[i:i + c], w, b, 1e-5) for i in range(0, 128, c)])
        assert torch.equal(got, alone), c


@pytest.fixture(scope="module")
def jax_layer_norms():
    import jax.numpy as jnp

    from hqq_tpu.models.cohere import cohere_norm
    from hqq_tpu.models.phi import layer_norm as phi_layer_norm
    from hqq_tpu.models.vit import _layer_norm

    def arr(t):
        return jnp.asarray(t.float().numpy()).astype(_jdtype(t.dtype))

    def out(y):
        return torch.from_numpy(np.array(y.astype(jnp.float32)))

    return {
        "vit": lambda x, w, b, eps: out(_layer_norm(arr(x), {"weight": arr(w), "bias": arr(b)},
                                                    eps)),
        "phi": lambda x, w, b, eps: out(phi_layer_norm(arr(x), {"weight": arr(w),
                                                                "bias": arr(b)}, eps)),
        "cohere": lambda x, w, b, eps: out(cohere_norm(arr(x), arr(w), eps)),
    }


@pytest.mark.parametrize("which", ["vit", "phi", "cohere"])
@pytest.mark.parametrize("dtype,d,bar", [
    (torch.float32, 4544, 2e-6), (torch.float32, 128, 2e-6), (torch.bfloat16, 2560, 2.0**-7),
    (torch.float32, 1024, 2e-6), (torch.float32, 1152, 2e-6), (torch.float32, 1280, 2e-6),
    (torch.float32, 2560, 2e-6), (torch.float32, 4096, 2e-6), (torch.bfloat16, 1152, 2.0**-7)])
def test_layer_norm_against_hqq_tpu(jax_layer_norms, which, dtype, d, bar):
    x, w, b = _rows(16, d, dtype, seed=3), _weight(d, dtype), _weight(d, dtype, seed=4)
    x = x + 1.5  # a mean far from 0: the two-pass form matters
    want = jax_layer_norms[which](x, w, b, 1e-5)
    got = nm.layer_norm(x, w, None if which == "cohere" else b, 1e-5).float()
    assert (got - want).abs().max().item() <= bar * want.abs().max().item()


def test_layer_norm_per_head_weights_against_hqq_tpu(jax_layer_norms):
    """Cohere's q/k norm: x [B, T, H, hd] with weights [H, hd]."""
    x = _rows(2 * 5 * 3, 128, torch.float32, seed=7).reshape(2, 5, 3, 128)
    w = torch.stack([_weight(128, torch.float32, seed=h) for h in range(3)])
    want = jax_layer_norms["cohere"](x, w, None, 1e-5)
    got = nm.layer_norm(x, w, None, 1e-5)
    assert (got - want).abs().max().item() <= 2e-6 * want.abs().max().item()


@pytest.mark.parametrize("bias,w_grad", [(True, True), (False, False)])
def test_layer_norm_backward_against_autograd(bias, w_grad):
    x = (_rows(6, 256, torch.float32, seed=4) + 0.5).reshape(2, 3, 256).requires_grad_(True)
    w = (_weight(256, torch.float32) + 1).requires_grad_(w_grad)
    b = _weight(256, torch.float32, seed=9).requires_grad_(w_grad) if bias else None
    g = _rows(6, 256, torch.float32, seed=5).reshape(2, 3, 256)
    wants = [x] + ([w] + ([b] if bias else []) if w_grad else [])
    y = nm.apply_layer_norm(x, w, b, 1e-5)
    got = torch.autograd.grad(y, wants, g)

    ref = torch.nn.functional.layer_norm(x, (256,), w, b, 1e-5)
    rgot = torch.autograd.grad(ref, wants, g)
    torch.testing.assert_close(y.detach(), ref.detach(), rtol=1e-5, atol=1e-5)
    for a, r in zip(got, rgot):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-5)


def test_models_layer_norm_is_the_twin_on_the_cpu():
    x, w, b = _rows(5, 4544, torch.bfloat16, seed=6), _weight(4544), _weight(4544, seed=2)
    before = nm.layer_norm.launches
    assert torch.equal(tl.layer_norm(x, {"weight": w, "bias": b}, 1e-5),
                       nm.layer_norm_plain(x, w, b, 1e-5))
    assert nm.layer_norm.launches == before  # the CPU route launches nothing


@pytest.mark.cuda
def test_layer_norm_kernel_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for dt in (torch.bfloat16, torch.float16, torch.float32):
        for d in (100, 128, 1600, 4544, 4096):
            x = (_rows(1024, d, dt, seed=d) + 1).cuda()
            w, b = _weight(d, torch.float32).cuda(), _weight(d, torch.float32, seed=2).cuda()
            for bias in (b, None):
                before = nm.layer_norm.launches
                y = nm.layer_norm(x, w, bias, 1e-5)
                assert nm.layer_norm.launches == before + 1
                assert torch.equal(y, nm.layer_norm_plain(x, w, bias, 1e-5))
                alone = torch.cat([nm.layer_norm(x[i:i + 1], w, bias, 1e-5) for i in range(32)])
                assert torch.equal(alone, y[:32])
