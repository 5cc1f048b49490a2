# SPDX-License-Identifier: Apache-2.0
"""The CUDA kernels of hqq_tpu_torch against their plain twins, on the card.

Marked ``cuda``: each test skips (at run time, never at import) where torch
sees no CUDA device, so on a CPU-only machine they all skip. On the GPU:
``python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q`` (the
suite's conftest imports JAX, which the GPU machine need not have). They
cover what ``chip_smoke.py`` does not: every container (1/2/4/8-bit), group sizes,
ragged N, K tails, M from 1 to 32 (w4a8) and beyond (quant_matmul, up to
1023: both token tiles of the Hopper mainloop, K split at decode sizes), LoRA
ranks 1 to 200 (above 16 the kernel walks K once per chunk of 64 ranks), fp32 and bf16 scale and zs of both layouts, the fp32
route (`qmm_fp32`) of the three matmuls, and every output type. Tolerances (of max|y|): w4a8 in fp32 1e-5 (exact group dots,
the fp32 epilogue sums in another order); bf16/fp16 outputs add one rounding
of the output (2^-7 / 2^-10), doubled for the tile kernels, whose fp32 sums
of bf16 products run in another order before that rounding; dequant exact.

The two attention kernels likewise: `paged_attention` over head sizes, GQA
ratios, page sizes, lengths at page edges and of 1, every page type, and
`flash_attention` over head sizes, GQA, ragged T, both types, causal and
not, its log-sum-exp, its fp32 route and its backward (the dK/dV and dQ
kernels) in every type, over the edges of their tiles. Their plain versions
round the probabilities to q's type before the second product, which the
kernels keep in fp32 (paged) or round unnormalised (flash); the backward's
kernels and twin both round P and dS where the library does; the bars are
stated at the tests.
"""

import pytest
import torch

from hqq_tpu_torch.core.quantize import quantize
from hqq_tpu_torch.ops import attention as at
from hqq_tpu_torch.ops import fused_matmul as fm
from hqq_tpu_torch.ops import paged as pa

pytestmark = pytest.mark.cuda

_OUT_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0**-7, torch.float16: 2.0**-10}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _kqt(n, k, g, nbits, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    w = torch.randn((n, k), generator=gen, device=device) / k**0.5
    return fm.to_kernel_layout(quantize(w, nbits=nbits, group_size=g, axis=1,
                                        round_zero=(nbits == 4)))


def _close(got, ref, tol):
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    assert torch.isfinite(got).all() and err <= tol * scale, (err, scale)


@pytest.mark.parametrize("m", [1, 3, 8, 17, 32])
@pytest.mark.parametrize("nbits,g,k,n", [
    (4, 64, 512, 1000),     # ragged N
    (4, 64, 64 * 67, 256),  # K not a multiple of 32 groups
    (4, 32, 1024, 384),
    (3, 64, 512, 256),      # 3-bit in the 4-bit container
    (2, 64, 1024, 256),
    (2, 16, 512, 256),      # group of one word per lane (4-byte loads)
    (1, 32, 512, 256),
    (1, 128, 1024, 256),
    (5, 64, 512, 256),      # 5-bit in the 8-bit container
    (4, 256, 2048, 128),    # a large group: > 48 KB of shared memory at M > 4
])
def test_w4a8_matmul(cuda, m, nbits, g, k, n):
    kqt = _kqt(n, k, g, nbits, cuda, seed=m)
    x = torch.randn((m, k), device=cuda)
    x8, sx = fm.quantize_activations_int8(x)
    for dtype, tol in _OUT_TOL.items():
        _close(fm.w4a8_matmul(x8, sx, kqt, dtype), fm.w4a8_matmul_plain(x8, sx, kqt, dtype), tol)


@pytest.mark.parametrize("m", [1, 8, 32])
@pytest.mark.parametrize("nbits,g,k,n,route", [
    (4, 8, 512, 256, "group_mma"), (4, 16, 512, 1000, "group_mma"),
    (4, 24, 960, 256, "group_mma"), (5, 8, 512, 256, "group_mma"), (2, 40, 960, 256, "group_mma"),
    (1, 32, 11008, 256, None),  # at 32 tokens the tensor-core route's meta leaves no ring
    (4, 16, 96, 256, "cuda_cores"),    # fp32 meta rows of 24 bytes
    (2, 8, 480, 256, "cuda_cores"),    # code rows of 120 bytes
])
def test_w4a8_matmul_small_groups(cuda, m, nbits, g, k, n, route):
    """Groups of 8, 16, 24 and 40 codes: the plan's small-group route; rows
    off the 16-byte rule: the CUDA-core kernel."""
    kqt = _kqt(n, k, g, nbits, cuda, seed=m)
    route = route or ("group_mma" if m > 16 else "tensor_cores")
    assert fm.w4a8_launch_plan(m, n, k, kqt.container_bits, g).route == route
    x = torch.randn((m, k), device=cuda)
    x8, sx = fm.quantize_activations_int8(x)
    for dtype, tol in _OUT_TOL.items():
        _close(fm.w4a8_matmul(x8, sx, kqt, dtype), fm.w4a8_matmul_plain(x8, sx, kqt, dtype), tol)


@pytest.mark.parametrize("nbits,g,k,n", [(2, 8, 4096, 1000), (1, 16, 1024, 256), (4, 24, 960, 256)])
def test_w4a8_small_groups_rows_do_not_depend_on_m(cuda, nbits, g, k, n):
    """The small-group route sums a row in one order at every M: row 0 of
    y is bit-equal at M = 1, 4, 8 and 32 given the same row of x."""
    kqt = _kqt(n, k, g, nbits, cuda, seed=5)
    x = torch.randn((32, k), device=cuda)
    rows = []
    for m in (1, 4, 8, 32):
        x8, sx = fm.quantize_activations_int8(x[:m])
        rows.append(fm.w4a8_matmul(x8, sx, kqt)[0])
    assert all(torch.equal(r, rows[0]) for r in rows[1:])


@pytest.mark.parametrize("meta_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n", [(4096, 4096), (4096, 11008), (11008, 4096)])
def test_w4a8_matmul_decode_8_slots(cuda, meta_dtype, k, n):
    """M = 8, the paged engine's decode of 8 slots, at the 7B shapes."""
    kqt = _kqt(n, k, 64, 4, cuda, seed=k + n)
    if meta_dtype == torch.bfloat16:
        kqt = _kqt_bf16(n, k, 64, 4, cuda, seed=k + n)
    x = torch.randn((8, k), device=cuda)
    x8, sx = fm.quantize_activations_int8(x)
    for dtype, tol in _OUT_TOL.items():
        _close(fm.w4a8_matmul(x8, sx, kqt, dtype), fm.w4a8_matmul_plain(x8, sx, kqt, dtype), tol)


def test_w4a8_matmul_repeats_bit_equal(cuda):
    """Three runs at (32, 11008, 4096): the k-slices' partials summed in a
    fixed order, no atomics."""
    kqt = _kqt(4096, 11008, 64, 4, cuda, seed=3)
    x8, sx = fm.quantize_activations_int8(torch.randn((32, 11008), device=cuda))
    first = fm.w4a8_matmul(x8, sx, kqt)
    assert all(torch.equal(fm.w4a8_matmul(x8, sx, kqt), first) for _ in range(3))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("m,nbits,g,k,n", [
    (1, 4, 64, 512, 1000),
    (33, 4, 64, 4096, 256),
    (100, 4, 32, 96, 200),    # K tail inside a 64-wide slab
    (512, 4, 64, 1024, 512),
    (70, 8, 64, 512, 256),
    (70, 2, 64, 512, 256),
    (70, 1, 32, 512, 256),
    (70, 3, 64, 512, 256),
])
def test_quant_matmul(cuda, dtype, m, nbits, g, k, n):
    kqt = _kqt(n, k, g, nbits, cuda)
    x = torch.randn((m, k), device=cuda).to(dtype)
    _close(fm.quant_matmul(x, kqt), fm.quant_matmul_plain(x, kqt), _OUT_TOL[dtype] * 2)


# the Hopper mainloop's edges: token tiles of 128 and 256 and their ragged
# ends, K split over blocks at decode sizes, codes by cp.async (1-bit),
# groups that straddle or do not tile the 64-wide slab
_SM90_CASES = [
    (1023, 4, 64, 512, 11008),   # token tile 256, its last tile ragged
    (1023, 4, 64, 1024, 512),
    (128, 4, 64, 1024, 384),
    (129, 4, 128, 1024, 200),    # a group across two slabs, ragged N
    (256, 2, 32, 512, 256),
    (256, 8, 64, 512, 256),
    (4, 4, 64, 4096, 4096),      # K split over blocks
    (17, 4, 64, 4096, 4096),
    (4, 4, 64, 11008, 4096),
    (17, 3, 64, 11008, 4096),
    (4, 1, 32, 4096, 512),       # 1-bit: codes by cp.async
    (40, 4, 96, 960, 200),       # g = 96 neither divides nor is a multiple of 64
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("m,nbits,g,k,n", _SM90_CASES)
def test_quant_matmul_sm90_edges(cuda, dtype, m, nbits, g, k, n):
    kqt = _kqt(n, k, g, nbits, cuda, seed=m)
    x = torch.randn((m, k), device=cuda).to(dtype)
    plan = fm.qmm_launch_plan(m, n, k, kqt.container_bits, g)
    assert plan.token_tile == 256 or (m, k, n) != (1023, 512, 11008)
    assert plan.splits > 1 or m > 17
    launches = fm.quant_matmul.launches
    _close(fm.quant_matmul(x, kqt), fm.quant_matmul_plain(x, kqt), _OUT_TOL[dtype] * 2)
    assert fm.quant_matmul.launches == launches + 1


@pytest.mark.parametrize("nbits,g", [(4, 64), (8, 16), (2, 64), (1, 32), (3, 128)])
def test_dequant_exact(cuda, nbits, g):
    kqt = _kqt(300, 1024, g, nbits, cuda)
    for dtype in _OUT_TOL:
        assert torch.equal(fm.dequant(kqt, dtype), fm.dequant_plain(kqt, dtype))


def _lora(k, n, r, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    a = (torch.rand((k, r), generator=gen, device=device) * 2 - 1) * (6.0 / k) ** 0.5
    b = torch.randn((r, n), generator=gen, device=device) * 0.05
    return a, b


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("m,nbits,g,k,n,r", [
    (1, 4, 64, 512, 1000, 8),     # ragged N
    (33, 4, 64, 4096, 256, 4),
    (100, 4, 32, 96, 200, 16),    # K tail inside a 64-wide slab
    (512, 4, 64, 1024, 512, 64),  # the widest single chunk
    (512, 4, 64, 1024, 512, 65),  # one rank into the second chunk
    (100, 4, 64, 512, 1000, 128), # two whole chunks, ragged N
    (40, 2, 64, 512, 256, 200),   # four chunks, the last one partial
    (70, 8, 64, 512, 256, 8),     # 8-bit: the route of every M
    (70, 2, 64, 512, 256, 24),    # a rank between fragment sizes
    (4, 1, 32, 512, 256, 33),
    (32, 3, 64, 512, 256, 8),
])
def test_quant_matmul_lora(cuda, dtype, m, nbits, g, k, n, r):
    kqt = _kqt(n, k, g, nbits, cuda)
    a, b = _lora(k, n, r, cuda, seed=m)
    x = torch.randn((m, k), device=cuda).to(dtype)
    ref = fm.quant_matmul_lora_plain(x, kqt, a, b)
    _close(fm.quant_matmul_lora(x, kqt, a, b), ref, _OUT_TOL[dtype] * 2)
    # the adapter is in the sum: the base alone misses the bar
    err = (fm.quant_matmul_plain(x, kqt).float() - ref.float()).abs().max()
    assert err > _OUT_TOL[dtype] * 2 * ref.float().abs().max()


# the LoRA kernel on the Hopper mainloop: token tiles of 8 to 128 and their
# ragged ends, K split over blocks at M <= 32 (each split applies B to its
# own partial), rank chunks of 16 and 64 and the passes over K above 64
_LORA_SM90_CASES = [
    (1023, 4, 64, 512, 11008, 8),    # token tile 128, its last tile ragged
    (128, 4, 64, 1024, 384, 1),
    (129, 4, 128, 1024, 200, 65),    # a group across two slabs, ragged N, two passes
    (256, 2, 32, 512, 256, 64),
    (512, 4, 64, 4096, 4096, 8),     # path E's prefill
    (4, 4, 64, 4096, 4096, 8),       # K split over blocks
    (17, 4, 64, 4096, 4096, 200),
    (4, 4, 64, 11008, 4096, 65),
    (17, 3, 64, 11008, 4096, 1),
    (4, 1, 32, 4096, 512, 8),        # 1-bit: codes by cp.async
    (40, 4, 96, 960, 200, 64),       # g = 96 neither divides nor is a multiple of 64
    (1023, 8, 64, 1024, 512, 200),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("m,nbits,g,k,n,r", _LORA_SM90_CASES)
def test_quant_matmul_lora_sm90_edges(cuda, dtype, m, nbits, g, k, n, r):
    kqt = _kqt(n, k, g, nbits, cuda, seed=m)
    a, b = _lora(k, n, r, cuda, seed=r)
    x = torch.randn((m, k), device=cuda).to(dtype)
    plan = fm.qmm_launch_plan(m, n, k, kqt.container_bits, g, rank=r)
    assert plan.token_tile <= 128 and (plan.splits > 1 or m > 17)
    launches = fm.quant_matmul_lora.launches
    ref = fm.quant_matmul_lora_plain(x, kqt, a, b)
    _close(fm.quant_matmul_lora(x, kqt, a, b), ref, _OUT_TOL[dtype] * 2)
    assert fm.quant_matmul_lora.launches == launches + 1
    err = (fm.quant_matmul_plain(x, kqt).float() - ref.float()).abs().max()
    assert err > _OUT_TOL[dtype] * 2 * ref.float().abs().max()


def test_quant_matmul_lora_rows_do_not_depend_on_m(cuda):
    """As `test_quant_matmul_rows_do_not_depend_on_m`, with an adapter of
    rank 8 and of rank 65 (two passes over K): above the split sizes (M >
    32) a row of y is the same whatever rows go with it."""
    kqt = _kqt(4096, 1024, 64, 4, cuda)
    x = torch.randn((600, 1024), device=cuda).to(torch.bfloat16)
    for r in (8, 65):
        a, b = _lora(1024, 4096, r, cuda, seed=r)
        whole = fm.quant_matmul_lora(x, kqt, a, b)
        for lo, hi in ((0, 256), (256, 512), (512, 600), (556, 600), (0, 33), (128, 161)):
            assert torch.equal(fm.quant_matmul_lora(x[lo:hi], kqt, a, b), whole[lo:hi]), (r, lo, hi)


@pytest.mark.parametrize("m,n,r", [(512, 4096, 8), (1023, 512, 65), (4, 4096, 8), (17, 4096, 200)])
def test_quant_matmul_lora_repeats_bit_equal(cuda, m, n, r):
    """The LoRA term stages the accumulators in the A tiles that the
    epilogue then writes: run after run, at the 128-token tile and at the
    small tiles with K split, the output is the same to the bit, and the
    serving layer gives what the wrapper gives."""
    from hqq_tpu_torch.backends.pallas_backend import PallasLoRAQuantLinear

    kqt = _kqt(n, 4096, 64, 4, cuda, seed=r)
    a, b = _lora(4096, n, r, cuda, seed=m)
    x = torch.randn((m, 4096), device=cuda).to(kqt.compute_dtype)
    first = fm.quant_matmul_lora(x, kqt, a, b)
    for _ in range(20):
        assert torch.equal(fm.quant_matmul_lora(x, kqt, a, b), first)
    assert torch.equal(PallasLoRAQuantLinear(kqt, a, b)(x), first)


@pytest.mark.parametrize("m", [1, 4, 8, 17, 32])
@pytest.mark.parametrize("nbits,g,k,n,r", [
    (4, 64, 512, 1000, 8),      # ragged N
    (4, 64, 64 * 67, 256, 4),   # K not a multiple of 32 groups
    (2, 16, 512, 256, 64),      # more ranks than lanes
    (1, 32, 512, 256, 8),
    (3, 64, 512, 256, 16),
])
def test_w4a8_lora_matmul(cuda, m, nbits, g, k, n, r):
    kqt = _kqt(n, k, g, nbits, cuda, seed=m)
    a, b = _lora(k, n, r, cuda, seed=m)
    x = torch.randn((m, k), device=cuda)
    x8, sx = fm.quantize_activations_int8(x)
    xa = x @ a
    for dtype, tol in _OUT_TOL.items():
        ref = fm.w4a8_lora_matmul_plain(x8, sx, kqt, xa, b, dtype)
        _close(fm.w4a8_lora_matmul(x8, sx, kqt, xa, b, dtype), ref, tol)
    err = (fm.w4a8_matmul_plain(x8, sx, kqt) - ref.float()).abs().max()
    assert err > 1e-3 * ref.float().abs().max()


def _kqt0(n, k, g, nbits, meta_dtype, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    w = torch.randn((n, k), generator=gen, device=device) / k**0.5
    return fm.to_kernel_layout_ax0(quantize(w, nbits=nbits, group_size=g, axis=0), meta_dtype)


_AX0_CASES = [
    (4, 64, 512, 1024),
    (3, 64, 512, 320),     # N not a multiple of 64: a ragged last tile
    (2, 16, 1024, 320),    # 2-bit g16, N not a multiple of 8*g
    (2, 64, 200, 256),     # K padded to 224, x padded to whole 16-byte chunks
    (1, 32, 512, 192),
    (1, 16, 96, 128),
    (8, 8, 72, 64),
    (3, 128, 4096, 256),   # a tile is half a group
]


@pytest.mark.parametrize("meta_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 4, 32, 33, 512])
@pytest.mark.parametrize("nbits,g,k,n", _AX0_CASES)
def test_quant_matmul_ax0(cuda, meta_dtype, m, nbits, g, k, n):
    kqt = _kqt0(n, k, g, nbits, meta_dtype, cuda, seed=m)
    for dtype in (torch.bfloat16, torch.float16):
        x = torch.randn((m, k), device=cuda).to(dtype)
        _close(fm.quant_matmul_ax0(x, kqt), fm.quant_matmul_ax0_plain(x, kqt), _OUT_TOL[dtype] * 2)


def test_quant_matmul_rows_do_not_depend_on_m(cuda):
    """Above the split sizes a row of y is the same whatever rows go with it
    (token tiles of 64, 128 and 256, never a split K): a prefill in chunks
    gives the numbers of a whole one."""
    kqt = _kqt(4096, 1024, 64, 4, cuda)
    kqt0 = _kqt0(1024, 1024, 16, 2, torch.bfloat16, cuda)
    x = torch.randn((600, 1024), device=cuda).to(torch.bfloat16)
    for fn, q in ((fm.quant_matmul, kqt), (fm.quant_matmul_ax0, kqt0)):
        whole = fn(x, q)
        for lo, hi in ((0, 256), (256, 512), (512, 600), (556, 600), (0, 33)):
            assert torch.equal(fn(x[lo:hi], q), whole[lo:hi]), (fn.__name__, lo, hi)


_AX0_SM90_CASES = [
    (1023, 2, 16, 512, 11008),  # token tile 256
    (128, 3, 64, 512, 320),
    (129, 4, 128, 1024, 256),   # a block's 128 rows are one group
    (256, 2, 16, 1024, 320),
    (4, 3, 64, 4096, 4096),     # K split over blocks
    (17, 2, 16, 4096, 11008),
    (4, 2, 16, 11008, 4096),
    (17, 1, 32, 4096, 512),     # 1-bit: codes by cp.async
    (40, 4, 72, 512, 288),      # groups of no multiple of 16 rows: part-empty a tiles
    (257, 3, 64, 4096, 4096),   # path F's attention: runs of 8 columns stored at once
    (31, 3, 128, 512, 1024),    # N/g = 8: one b tile, 8 a tiles
    (33, 4, 8, 256, 200),       # g = 8: tiles of 16 b by 8 a; N/g = 25, no runs
    (129, 2, 64, 1024, 11008),  # N/g = 172: the last b tile half empty
]


@pytest.mark.parametrize("meta_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,nbits,g,k,n", _AX0_SM90_CASES)
def test_quant_matmul_ax0_sm90_edges(cuda, meta_dtype, m, nbits, g, k, n):
    kqt = _kqt0(n, k, g, nbits, meta_dtype, cuda, seed=m)
    for dtype in (torch.bfloat16, torch.float16):
        x = torch.randn((m, k), device=cuda).to(dtype)
        _close(fm.quant_matmul_ax0(x, kqt), fm.quant_matmul_ax0_plain(x, kqt), _OUT_TOL[dtype] * 2)


@pytest.mark.parametrize("meta_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nbits,g,k,n", _AX0_CASES)
def test_dequant_ax0_exact(cuda, meta_dtype, nbits, g, k, n):
    kqt = _kqt0(n, k, g, nbits, meta_dtype, cuda)
    for dtype in _OUT_TOL:
        got = fm.dequant(kqt, dtype)
        assert tuple(got.shape) == (n, k) and torch.equal(got, fm.dequant_plain(kqt, dtype))


def test_routing_counts_and_no_fallback(cuda):
    kqt = _kqt(256, 512, 64, 4, cuda)
    kqt0 = _kqt0(256, 512, 16, 2, torch.bfloat16, cuda)
    a, b = _lora(512, 256, 8, cuda)
    decode = torch.randn(2, 3, 512, device=cuda).to(torch.bfloat16)   # M = 6
    prefill = torch.randn(5, 8, 512, device=cuda).to(torch.bfloat16)  # M = 40
    fm.reset_launch_counts()
    for x in (decode, prefill):
        fm.quant_matmul_pallas_a8(x, kqt)
        fm.quant_matmul_pallas_a8_lora(x, kqt, a, b)
        fm.quant_matmul_pallas_a8(x, kqt0)
    fm.dequant_pallas(kqt)
    fm.dequant_pallas(kqt0)
    counts = {w.__name__: w.launches for w in fm._WRAPPERS}
    assert counts == {"w4a8_matmul": 1, "quant_matmul": 1, "w4a8_lora_matmul": 1,
                      "quant_matmul_lora": 1, "quant_matmul_ax0": 2, "dequant": 2,
                      "dequant_canonical": 0, "qmm_fp32": 0, "grouped_matmul": 0}
    # fp32 activations take the fp32 route, never a bf16 kernel
    x32 = torch.randn(40, 512, device=cuda)
    _close(fm.quant_matmul(x32, kqt), fm.quant_matmul_plain(x32, kqt), _OUT_TOL[torch.float32])
    _close(fm.quant_matmul_ax0(x32, kqt0), fm.quant_matmul_ax0_plain(x32, kqt0),
           _OUT_TOL[torch.float32])
    assert fm.qmm_fp32.launches == 2 and fm.quant_matmul.launches == 1
    with pytest.raises(ValueError):  # int8 activations are the w4a8 kernel's alone
        fm.quant_matmul(torch.ones(40, 512, device=cuda, dtype=torch.int8), kqt)


# fp32 and int8 pages (q in fp32): fp32 sums in another order and another
# exp: 2e-5 of max|out|. bf16/fp16 pages: the kernel rounds the output once;
# the plain version also rounds the probabilities to q's type, an error of
# the size of one more rounding of the output (over random rows both are sums
# of about sqrt(length) terms). Two roundings that fall to different sides
# lie one step of the type apart (2^-7 of a bf16 value, 2^-10 of an fp16
# one): the bar is two steps of max|out|.
_PAGED_TOL = {torch.float32: 2e-5, torch.int8: 2e-5, torch.bfloat16: 2.0**-6,
              torch.float16: 2.0**-9}


def _paged_case(device, b, nh, h, hd, pg, mp, lengths, dtype, seed=0):
    """Random pools with every slot's pages drawn without repeats from a
    pool twice the table's size; page 0 stays scratch."""
    gen = torch.Generator(device=device).manual_seed(seed)
    num_pages = 1 + 2 * b * mp
    shape = (h, num_pages, pg, hd)
    k = torch.randn(shape, generator=gen, device=device)
    v = torch.randn(shape, generator=gen, device=device)
    q = torch.randn((b, nh, hd), generator=gen, device=device) * hd**-0.5
    perm = 1 + torch.randperm(num_pages - 1, generator=gen, device=device)[: b * mp]
    tab = perm.reshape(b, mp).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    # entries past each slot's pages point at the scratch page, as the engine's
    used = (lens[:, None] + pg - 1) // pg
    tab = torch.where(torch.arange(mp, device=device)[None, :] < used, tab, 0)
    if dtype == torch.int8:
        k8, ks = pa.quant_rows(k)
        v8, vs = pa.quant_rows(v)
        return q, k8, v8, lens, tab, ks, vs
    return q.to(dtype), k.to(dtype), v.to(dtype), lens, tab, None, None


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32, torch.int8])
@pytest.mark.parametrize("nh,h,hd", [
    (4, 4, 32), (8, 2, 64), (6, 3, 80), (4, 1, 96), (32, 32, 128), (32, 8, 128), (8, 4, 256),
])
def test_paged_attention_heads(cuda, dtype, nh, h, hd):
    args = _paged_case(cuda, 3, nh, h, hd, 16, 8, [1, 77, 128], dtype, seed=hd)
    _close(pa.paged_attention(*args), pa.paged_attention_plain(*args), _PAGED_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("pg", [8, 16, 32])
def test_paged_attention_page_edges(cuda, dtype, pg):
    mp = 512 // pg
    lengths = [1, pg - 1, pg, pg + 1, 2 * pg, 255, 256, 512]
    args = _paged_case(cuda, len(lengths), 8, 4, 128, pg, mp, lengths, dtype, seed=pg)
    launches = pa.paged_attention.launches
    _close(pa.paged_attention(*args), pa.paged_attention_plain(*args), _PAGED_TOL[dtype])
    assert pa.paged_attention.launches == launches + 1


@pytest.mark.parametrize("b,nh", [(1, 4), (2, 32), (8, 32), (24, 32)])
def test_paged_attention_splits(cuda, b, nh):
    """One split (many slots) up to eight (one slot, few heads)."""
    lengths = [1 + (997 * (i + 1)) % 1024 for i in range(b)]
    args = _paged_case(cuda, b, nh, nh // 4, 128, 16, 64, lengths, torch.bfloat16, seed=b)
    _close(pa.paged_attention(*args), pa.paged_attention_plain(*args),
           _PAGED_TOL[torch.bfloat16])


def test_paged_attention_reads_nothing_past_the_length(cuda):
    """NaN in every row at or beyond a slot's length, and in every page
    that no slot owns, changes nothing; a length of 0 gives zeros."""
    pg, mp, lengths = 16, 8, [0, 5, 16, 100]
    q, k, v, lens, tab, _, _ = _paged_case(cuda, 4, 8, 4, 128, pg, mp, lengths, torch.bfloat16)
    ref = pa.paged_attention(q, k, v, lens, tab)
    owned = torch.zeros(k.shape[1:3], dtype=torch.bool, device=cuda)  # [P, pg]
    for b, n in enumerate(lengths):
        for s in range(n):
            owned[tab[b, s // pg], s % pg] = True
    k2 = torch.where(owned[None, :, :, None], k, torch.nan)
    v2 = torch.where(owned[None, :, :, None], v, torch.nan)
    got = pa.paged_attention(q, k2, v2, lens, tab)
    assert torch.equal(got, ref) and torch.isfinite(got).all()
    assert (got[0] == 0).all()


def test_paged_attention_int8_gqa(cuda):
    """int8 pages with four query heads a kv head, lengths around 1024: a
    block serves two of them (`paged_launch_plan`), so each page is read by
    two blocks."""
    lengths = [1024, 1000, 990, 1010, 960, 1024, 1017, 975]
    args = _paged_case(cuda, 8, 32, 8, 128, 16, 64, lengths, torch.int8, seed=8)
    assert pa.paged_launch_plan(8, 32, 8, 128, 16, 64, torch.int8).heads_per_block == 2
    _close(pa.paged_attention(*args), pa.paged_attention_plain(*args), _PAGED_TOL[torch.int8])


def test_paged_attention_int8_reads_nothing_past_the_length(cuda):
    """int8 pages: NaN in the K and V scales of every row at or beyond a
    slot's length, and of every page no slot owns, and -128 in their codes,
    change nothing; a length of 0 gives zeros."""
    pg, mp, lengths = 16, 8, [0, 5, 16, 100]
    q, k, v, lens, tab, ks, vs = _paged_case(cuda, 4, 8, 4, 128, pg, mp, lengths, torch.int8)
    ref = pa.paged_attention(q, k, v, lens, tab, ks, vs)
    owned = torch.zeros(k.shape[1:3], dtype=torch.bool, device=cuda)  # [P, pg]
    for b, n in enumerate(lengths):
        for s in range(n):
            owned[tab[b, s // pg], s % pg] = True
    k2, v2 = (torch.where(owned[None, :, :, None], x, -128).to(torch.int8) for x in (k, v))
    ks2, vs2 = (torch.where(owned[None, :, :, None], x, torch.nan) for x in (ks, vs))
    got = pa.paged_attention(q, k2, v2, lens, tab, ks2, vs2)
    assert torch.equal(got, ref) and torch.isfinite(got).all()
    assert (got[0] == 0).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.int8])
def test_paged_attention_copy_path(cuda, dtype):
    """Pages of one row of head size 4 break the bulk copy's 16-byte rule
    (and rows are not whole 16-byte vectors; fp32 rows of 4 are 16 bytes):
    the producer copies them by cp.async, 16 pages a stage, and the
    consumers read words."""
    plan = pa.paged_launch_plan(3, 4, 2, 4, 1, 64, dtype)
    assert not plan.bulk and not plan.vec16 and plan.pages_per_stage == 16
    args = _paged_case(cuda, 3, 4, 2, 4, 1, 64, [1, 17, 64], dtype, seed=4)
    _close(pa.paged_attention(*args), pa.paged_attention_plain(*args), _PAGED_TOL[dtype])


def test_paged_attention_refuses(cuda):
    q, k, v, lens, tab, _, _ = _paged_case(cuda, 2, 4, 4, 64, 16, 4, [3, 9], torch.bfloat16)
    with pytest.raises(ValueError):
        pa.paged_attention(q.float(), k, v, lens, tab)  # q of another type than the pages
    with pytest.raises(ValueError):
        pa.paged_attention(q, k.to(torch.int8), v.to(torch.int8), lens, tab)  # no scales
    with pytest.raises(ValueError):
        pa.paged_attention(q, k.transpose(1, 2), v.transpose(1, 2), lens, tab)


def _flash_case(device, b, nh, n_kv, t, hd, dtype, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((b, nh, t, hd), generator=gen, device=device).to(dtype)
    k = torch.randn((b, n_kv, t, hd), generator=gen, device=device).to(dtype)
    v = torch.randn((b, n_kv, t, hd), generator=gen, device=device).to(dtype)
    return q, k, v


# both round the probabilities to q's type (the plain version normalised, the
# kernel before the division by the fp32 sum) and the output once; outputs
# rounded to different sides lie one step of the type apart: two steps of
# max|out|
_FLASH_TOL = {torch.bfloat16: 2.0**-6, torch.float16: 2.0**-9}


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("nh,n_kv,hd", [
    (2, 2, 32), (4, 2, 64), (2, 1, 80), (3, 3, 96), (8, 8, 128), (8, 2, 128), (2, 2, 256),
])
def test_flash_attention_heads(cuda, causal, dtype, nh, n_kv, hd):
    q, k, v = _flash_case(cuda, 2, nh, n_kv, 300, hd, dtype, seed=hd)
    _close(at.flash_attention(q, k, v, causal), at.flash_attention_plain(q, k, v, causal),
           _FLASH_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("t", [1, 63, 64, 65, 256, 257, 1023, 1024])
def test_flash_attention_ragged(cuda, dtype, t):
    q, k, v = _flash_case(cuda, 1, 4, 4, t, 128, dtype, seed=t)
    launches = at.flash_attention.launches
    _close(at.flash_attention(q, k, v, True, 0.05), at.flash_attention_plain(q, k, v, True, 0.05),
           _FLASH_TOL[dtype])
    assert at.flash_attention.launches == launches + 1


@pytest.mark.parametrize("t,kernel", [(255, False), (256, True), (257, True), (1023, True)])
def test_prefill_attention_route(cuda, t, kernel):
    """T = 255 is the naive path by the route; from 256 on, the kernel, at
    any T. An explicit mask is the naive path at any T."""
    q, k, v = _flash_case(cuda, 1, 4, 2, t, 128, torch.bfloat16, seed=t)
    launches = at.flash_attention.launches
    out = at.prefill_attention(q, k, v, causal=True)
    assert at.flash_attention.launches == launches + int(kernel)
    _close(out, at.flash_attention_plain(q, k, v, True), _FLASH_TOL[torch.bfloat16])
    masked = at.prefill_attention(q, k, v, mask=at._causal_mask(t, t, cuda))
    assert at.flash_attention.launches == launches + int(kernel)
    _close(masked, out, _FLASH_TOL[torch.bfloat16])


def test_flash_attention_refuses(cuda):
    q, k, v = _flash_case(cuda, 1, 2, 2, 256, 64, torch.bfloat16)
    with pytest.raises(ValueError):
        at.flash_attention(q.double(), k.double(), v.double())  # no fp64 kernel
    with pytest.raises(ValueError):
        at.flash_attention(q[..., :40], k[..., :40], v[..., :40])  # head_dim % 16
    with pytest.raises(ValueError):
        at.flash_attention(q, k.float(), v)  # k not of q's type


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("hd", [64, 80, 128, 256])
def test_flash_attention_head_pads(cuda, dtype, hd):
    """Each padded head size of the kernel (64, 128, 256; 80 pads to 128),
    causal and not, over three query tiles and a ragged end."""
    q, k, v = _flash_case(cuda, 1, 4, 2, 333, hd, dtype, seed=hd + 1)
    for causal in (True, False):
        _close(at.flash_attention(q, k, v, causal), at.flash_attention_plain(q, k, v, causal),
               _FLASH_TOL[dtype])


@pytest.mark.parametrize("b,nh,n_kv,t", [(1, 4, 4, 4096), (1, 8, 2, 4095), (4, 32, 32, 512)])
def test_flash_attention_long_and_wide(cuda, b, nh, n_kv, t):
    """T = 4096 (32 query tiles, the longest first) and B = 4 x 32 heads."""
    q, k, v = _flash_case(cuda, b, nh, n_kv, t, 128, torch.bfloat16, seed=t)
    _close(at.flash_attention(q, k, v, True), at.flash_attention_plain(q, k, v, True),
           _FLASH_TOL[torch.bfloat16])


# -- axis=1 layouts with bf16 scale and zs (`hqq_tpu` serves them) ----------

def _kqt_bf16(n, k, g, nbits, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    w = torch.randn((n, k), generator=gen, device=device) / k**0.5
    return fm.to_kernel_layout(quantize(w, nbits=nbits, group_size=g, axis=1,
                                        round_zero=(nbits == 4)), torch.bfloat16)


_BF16_META_CASES = [
    (4, 64, 512, 1000),     # ragged N
    (4, 64, 4096, 4096),    # K split at decode sizes
    (4, 32, 1024, 384),
    (4, 128, 1024, 256),    # a group across two slabs
    (4, 24, 960, 256),      # g = 24 neither divides nor is a multiple of 64: cp.async meta
    (2, 16, 512, 256),
    (1, 32, 512, 256),      # 1-bit: codes by cp.async
    (8, 64, 512, 256),
    (4, 64, 64 * 67, 256),  # 67 groups: bf16 rows padded to 72 columns
]


@pytest.mark.parametrize("m", [1, 4, 33, 512])
@pytest.mark.parametrize("nbits,g,k,n", _BF16_META_CASES)
def test_axis1_bf16_meta(cuda, m, nbits, g, k, n):
    """quant_matmul, quant_matmul_lora, w4a8 (both entries) and dequant on
    an axis=1 layout whose scale and zs are bf16, widened to fp32 as they
    are read: the bars of the fp32-meta cases against the plain versions."""
    kqt = _kqt_bf16(n, k, g, nbits, cuda, seed=m)
    assert kqt.scale.dtype == torch.bfloat16 and kqt.scale.shape[1] % 8 == 0
    a, b = _lora(k, n, 8, cuda, seed=m)
    x = torch.randn((m, k), device=cuda).to(torch.bfloat16)
    tol = _OUT_TOL[torch.bfloat16] * 2
    _close(fm.quant_matmul(x, kqt), fm.quant_matmul_plain(x, kqt), tol)
    _close(fm.quant_matmul_lora(x, kqt, a, b), fm.quant_matmul_lora_plain(x, kqt, a, b), tol)
    for dtype in _OUT_TOL:
        assert torch.equal(fm.dequant(kqt, dtype), fm.dequant_plain(kqt, dtype))
    if m <= fm.A8_MAX_M and nbits != 8:
        x8, sx = fm.quantize_activations_int8(x)
        xa = x.float() @ a
        for dtype, t in _OUT_TOL.items():
            _close(fm.w4a8_matmul(x8, sx, kqt, dtype), fm.w4a8_matmul_plain(x8, sx, kqt, dtype), t)
            _close(fm.w4a8_lora_matmul(x8, sx, kqt, xa, b, dtype),
                   fm.w4a8_lora_matmul_plain(x8, sx, kqt, xa, b, dtype), t)


# -- the fp32 route of the matmuls -----------------------------------------

@pytest.mark.parametrize("m", [1, 31, 33, 257, 512])
@pytest.mark.parametrize("layout,nbits,g,k,n,r", [
    ("ax1", 4, 64, 4096, 4096, 0),
    ("ax1", 4, 64, 512, 1000, 8),
    ("ax1-bf16", 4, 64, 1024, 384, 8),
    ("ax1", 2, 16, 512, 256, 20),     # three rank chunks of the LoRA term
    ("ax1", 3, 24, 960, 200, 1),      # a group across two 32-wide slabs
    ("ax1", 8, 64, 512, 256, 65),
    ("ax1-bf16", 8, 8, 512, 200, 0),  # g = 8, N not a multiple of 128
    ("ax1", 2, 128, 1024, 136, 0),    # 2-bit: codes by cp.async (8 bytes a slab row)
    ("ax0", 3, 64, 512, 320, 0),
    ("ax0-bf16", 2, 16, 200, 256, 0),  # K padded to 224
    ("ax0", 4, 8, 256, 200, 0),       # g = 8: tiles of 16 b by 8 a
    ("ax0-bf16", 2, 16, 512, 1008, 0),  # N/g = 63: no runs of 8
    ("ax0", 3, 128, 1024, 384, 0),
    ("ax0", 1, 32, 512, 256, 0),      # 1-bit: codes by cp.async
])
def test_qmm_fp32(cuda, m, layout, nbits, g, k, n, r):
    """fp32 x through quant_matmul / quant_matmul_ax0 / quant_matmul_lora
    takes the fp32 route and holds its plain version at the fp32 bar
    (1e-5 of max|y|: the same fp32 products, summed in another order); the
    same x rounded to bf16 first misses it."""
    meta = torch.bfloat16 if layout.endswith("bf16") else torch.float32
    if layout.startswith("ax0"):
        kqt = _kqt0(n, k, g, nbits, meta, cuda, seed=m)
    else:
        gen = torch.Generator(device=cuda).manual_seed(m)
        w = torch.randn((n, k), generator=gen, device=cuda) / k**0.5
        kqt = fm.to_kernel_layout(quantize(w, nbits=nbits, group_size=g, axis=1), meta)
    x = torch.randn((m, k), device=cuda)
    launches = fm.qmm_fp32.launches
    if r:
        a, b = _lora(k, n, r, cuda, seed=r)
        got, ref = fm.quant_matmul_lora(x, kqt, a, b), fm.quant_matmul_lora_plain(x, kqt, a, b)
        cast = fm.quant_matmul_lora_plain(x.to(torch.bfloat16), kqt, a, b)
    else:
        fn, plain = ((fm.quant_matmul_ax0, fm.quant_matmul_ax0_plain) if layout.startswith("ax0")
                     else (fm.quant_matmul, fm.quant_matmul_plain))
        got, ref, cast = fn(x, kqt), plain(x, kqt), plain(x.to(torch.bfloat16), kqt)
    assert got.dtype == torch.float32 and fm.qmm_fp32.launches == launches + 1
    _close(got, ref, _OUT_TOL[torch.float32])
    assert (cast.float() - ref).abs().max() > _OUT_TOL[torch.float32] * ref.abs().max()


def test_qmm_fp32_rows_do_not_depend_on_m(cuda):
    """Above the split sizes a row of the fp32 route's y is the same whatever
    rows go with it (token tiles of 64 and 128, never a split K)."""
    kqt = _kqt(1024, 1024, 64, 4, cuda)
    kqt0 = _kqt0(1024, 1024, 16, 2, torch.bfloat16, cuda)
    x = torch.randn((600, 1024), device=cuda)
    for fn, q in ((fm.quant_matmul, kqt), (fm.quant_matmul_ax0, kqt0)):
        whole = fn(x, q)
        for lo, hi in ((0, 256), (256, 512), (512, 600), (556, 600), (0, 33)):
            assert torch.equal(fn(x[lo:hi], q), whole[lo:hi]), (fn.__name__, lo, hi)


def test_qmm_fp32_misses_one_tf32_product(cuda):
    """The fp32 bar sees the split: one TF32 product (torch.matmul with TF32
    allowed, on the same dequantized weight) misses it where the kernel
    meets it."""
    kqt = _kqt(1024, 2048, 64, 4, cuda)
    x = torch.randn((257, 2048), device=cuda)
    ref = fm.quant_matmul_plain(x, kqt)
    _close(fm.quant_matmul(x, kqt), ref, _OUT_TOL[torch.float32])
    w = fm.dequant_plain(kqt, torch.float32)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        one = x @ w.t()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert (one - ref).abs().max() > _OUT_TOL[torch.float32] * ref.abs().max()


# -- flash attention: log-sum-exp, the fp32 route, the backward ------------

# fp32 kernels against fp32 plain versions: exp2 against exp and sums in
# another order; a bf16 rounding of the inputs is some 2^-9 of them
_FLASH_FP32_TOL = 1e-4
# backward, bf16/fp16: both sides round P and scale * dS to the inputs' type
# before the products dV, dK and dQ (where the library's kernels round them),
# sum every product in fp32 and round each output once; P and dS come from S
# and dP summed in another order, so a few of those roundings fall to the
# other side, one step apart: twice the step of the type, of max|grad|
_FLASH_BWD_TOL = {torch.bfloat16: 2.0**-7, torch.float16: 2.0**-10, torch.float32: 1e-4}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("hd,t", [(64, 300), (128, 1023), (256, 257), (80, 129)])
def test_flash_attention_lse(cuda, dtype, hd, t):
    """The forward under autograd writes each row's log-sum-exp; it equals
    the plain one (fp32 scores of the same inputs) to fp32 precision."""
    q, k, v = _flash_case(cuda, 1, 4, 2, t, hd, dtype, seed=hd)
    for causal in (True, False):
        out, lse = at._flash_forward(q, k, v, causal, None, with_lse=True)
        ref = at._plain_lse(q, k, causal, None)
        assert torch.isfinite(lse).all()
        assert (lse - ref).abs().max() <= 1e-5 * ref.abs().max() + 1e-5
        assert torch.equal(out, at.flash_attention(q, k, v, causal))


@pytest.mark.parametrize("nh,n_kv,t,hd", [
    (4, 2, 300, 64), (2, 2, 1, 128), (2, 1, 65, 128), (8, 8, 512, 128), (2, 2, 257, 256),
    (2, 2, 100, 16),
    # T not a multiple of the key tile (64, 32, 8 at head sizes 64, 128, 256)
    # nor of the 64 query rows; head sizes padded with zero columns
    (2, 2, 33, 64), (4, 2, 97, 80), (2, 1, 129, 256), (2, 2, 1023, 128),
])
def test_flash_attention_fp32(cuda, nh, n_kv, t, hd):
    q, k, v = _flash_case(cuda, 2, nh, n_kv, t, hd, torch.float32, seed=t)
    for causal in (True, False):
        launches = at.flash_attention_fp32.launches
        got = at.flash_attention(q, k, v, causal)
        ref = at.flash_attention_plain(q, k, v, causal)
        assert got.dtype == torch.float32 and at.flash_attention_fp32.launches == launches + 1
        _close(got, ref, _FLASH_FP32_TOL)
        out, lse = at.flash_attention_fp32(q, k, v, causal, None, with_lse=True)
        assert torch.equal(out, got)
        ref_lse = at._plain_lse(q, k, causal, None)
        assert (lse - ref_lse).abs().max() <= 1e-5 * ref_lse.abs().max() + 1e-5
    cast = at.flash_attention_plain(*(x.to(torch.bfloat16) for x in (q, k, v)), True)
    ref = at.flash_attention_plain(q, k, v, True)
    assert (cast.float() - ref).abs().max() > _FLASH_FP32_TOL * ref.abs().max()


def test_flash_attention_fp32_one_tf32_product(cuda):
    """The control of the fp32 bar: the plain version with TF32 allowed (one
    TF32 product for each of S and P.V) misses the bar the kernel meets."""
    q, k, v = _flash_case(cuda, 1, 8, 8, 512, 128, torch.float32, seed=512)
    ref = at.flash_attention_plain(q, k, v, True)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        one = at.flash_attention_plain(q, k, v, True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    _close(at.flash_attention(q, k, v, True), ref, _FLASH_FP32_TOL)
    assert (one - ref).abs().max() > _FLASH_FP32_TOL * ref.abs().max()


def _bwd_case(device, b, nh, n_kv, t, hd, dtype, causal, seed=0):
    q, k, v = _flash_case(device, b, nh, n_kv, t, hd, dtype, seed=seed)
    lse = at._plain_lse(q, k, causal, None)
    o = at.flash_attention_plain(q, k, v, causal)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    do = torch.randn(o.shape, generator=gen, device=device).to(dtype)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("b,nh,n_kv,t,hd", [
    (1, 4, 2, 300, 64), (2, 2, 2, 257, 128), (1, 4, 1, 129, 256), (1, 2, 2, 64, 80),
    (1, 2, 2, 1, 16), (1, 2, 2, 3, 16), (1, 8, 2, 1023, 128), (1, 2, 2, 65, 112),
    # the edges of the tiles (64 query rows and 128 keys of dK/dV, 128 rows
    # and 64 keys of dQ) and head sizes padded with zero columns
    (1, 2, 2, 63, 128), (1, 4, 1, 127, 64), (1, 4, 2, 129, 80), (1, 2, 2, 129, 112),
    (2, 2, 2, 65, 128),
    # head_pad 256 (fp32: a cluster of two blocks, 128 columns each; at 160
    # the second block's columns mostly past the head)
    (2, 2, 2, 257, 256), (1, 4, 2, 65, 160),
])
def test_flash_attention_backward(cuda, causal, dtype, b, nh, n_kv, t, hd):
    """dQ, dK and dV of the two kernels against the plain backward from the
    same saved statistics; each kernel launches once. At T = 1 the one key
    has P = 1, so dS = dO.V - D is 0 up to rounding and so are dQ and dK:
    they are held to an absolute bar of a few fp32 steps of the sums that
    make them (a relative bar would measure noise); dV = dO is held as at
    every T."""
    q, k, v, o, lse, do = _bwd_case(cuda, b, nh, n_kv, t, hd, dtype, causal, seed=t + hd)
    # fp32 inputs take the fp32 kernels, which count their own launches
    wrappers = ((at.flash_attention_backward_dkv_fp32, at.flash_attention_backward_dq_fp32)
                if dtype == torch.float32
                else (at.flash_attention_backward_dkv, at.flash_attention_backward_dq))
    launches = tuple(w.launches for w in wrappers)
    got = at.flash_attention_backward(q, k, v, o, lse, do, causal)
    ref = at.flash_attention_backward_plain(q, k, v, o, lse, do, causal)
    assert tuple(w.launches for w in wrappers) == (launches[0] + 1, launches[1] + 1)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.dtype == dtype and g.shape == r.shape
        if t == 1 and i < 2:
            # |D - dO.V| <= 2 hd^2 2^-24 max|dO| max|V|, times scale * max|K| (dQ) or |Q| (dK)
            other = (k, q)[i].float().abs().max()
            bar = 2 * hd * hd * 2.0**-24 * hd**-0.5 * other * do.float().abs().max() \
                * v.float().abs().max()
            err = max((g.float() - r.float()).abs().max(), g.float().abs().max())
            assert torch.isfinite(g).all() and err <= bar, (i, err.item(), bar.item())
        else:
            _close(g, r, _FLASH_BWD_TOL[dtype])


@pytest.mark.parametrize("nh,n_kv", [(8, 2), (8, 8)])
def test_flash_attention_backward_repeats_bit_equal(cuda, nh, n_kv):
    """No atomics: run after run, dQ, dK and dV are the same to the bit, with
    the dK/dV grid split over the query heads of a group (8/2: fp32
    partials summed by the wrapper) and without (8/8)."""
    q, k, v, o, lse, do = _bwd_case(cuda, 1, nh, n_kv, 777, 128, torch.bfloat16, True, seed=7)
    first = at.flash_attention_backward(q, k, v, o, lse, do, True)
    for _ in range(10):
        again = at.flash_attention_backward(q, k, v, o, lse, do, True)
        assert all(torch.equal(a, b) for a, b in zip(again, first))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_backward_fp32_long(cuda, causal):
    """The fp32 kernels sum dK, dV and dQ in the tensor core's fp32 over the
    whole walk, with no fold: at T = 4096 they still meet the fp32 bar,
    which one TF32 product (the plain backward with TF32 allowed) misses;
    GQA 8/2 repeats bit-equal."""
    q, k, v, o, lse, do = _bwd_case(cuda, 1, 4, 4, 4096, 128, torch.float32, causal, seed=9)
    got = at.flash_attention_backward(q, k, v, o, lse, do, causal)
    ref = at.flash_attention_backward_plain(q, k, v, o, lse, do, causal)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        one = at.flash_attention_backward_plain(q, k, v, o, lse, do, causal)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    for g, r, x in zip(got, ref, one):
        _close(g, r, _FLASH_BWD_TOL[torch.float32])
    assert max((x - r).abs().max() / r.abs().max() for x, r in zip(one, ref)) \
        > _FLASH_BWD_TOL[torch.float32]
    q, k, v, o, lse, do = _bwd_case(cuda, 1, 8, 2, 777, 128, torch.float32, causal, seed=7)
    first = at.flash_attention_backward(q, k, v, o, lse, do, causal)
    for _ in range(3):
        again = at.flash_attention_backward(q, k, v, o, lse, do, causal)
        assert all(torch.equal(a, b) for a, b in zip(again, first))


def test_flash_attention_backward_fp32_cluster(cuda):
    """Head size 256 in fp32 (a cluster of two blocks a resident tile, the
    partials of S and dP swapped between them): within the fp32 bar at T =
    2048 with GQA 16/8, which one TF32 product misses; repeated runs
    bit-equal."""
    q, k, v, o, lse, do = _bwd_case(cuda, 1, 16, 8, 2048, 256, torch.float32, True, seed=11)
    got = at.flash_attention_backward(q, k, v, o, lse, do, True)
    ref = at.flash_attention_backward_plain(q, k, v, o, lse, do, True)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        one = at.flash_attention_backward_plain(q, k, v, o, lse, do, True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    for g, r in zip(got, ref):
        _close(g, r, _FLASH_BWD_TOL[torch.float32])
    assert max((x - r).abs().max() / r.abs().max() for x, r in zip(one, ref)) \
        > _FLASH_BWD_TOL[torch.float32]
    for _ in range(3):
        again = at.flash_attention_backward(q, k, v, o, lse, do, True)
        assert all(torch.equal(a, b) for a, b in zip(again, got))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_autograd(cuda, dtype):
    """Gradients through `prefill_attention` at T >= 256 (the Function: the
    forward with its log-sum-exp, the two backward kernels) against autograd
    of the plain version in fp32; a shifted mask misses the bar."""
    q, k, v = _flash_case(cuda, 1, 4, 2, 384, 128, dtype, seed=3)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    do = torch.randn(q.shape, device=cuda).to(dtype)
    out = at.prefill_attention(q, k, v, causal=True)
    grads = torch.autograd.grad(out, (q, k, v), do)
    q32, k32, v32 = (x.detach().float().requires_grad_() for x in (q, k, v))
    ref = at.flash_attention_plain(q32, k32, v32, True)
    refs = torch.autograd.grad(ref, (q32, k32, v32), do.float())
    # bf16: the saved out is rounded and P is rounded in the forward only
    tol = 2.0**-6 if dtype == torch.bfloat16 else _FLASH_FP32_TOL
    for g, r in zip(grads, refs):
        _close(g, r, tol)


@pytest.mark.parametrize("m", [4, 64])
def test_lora_layer_follows_a(cuda, m):
    """After load_state_dict, or an in-place update of a, the serving
    layer serves the new adapter at M = 4 (int8 route) and M = 64 (the
    LoRA kernel) alike."""
    from hqq_tpu_torch.backends.pallas_backend import A8LoRAQuantLinear, PallasLoRAQuantLinear

    kqt = _kqt(512, 1024, 64, 4, cuda)
    a, b = _lora(1024, 512, 8, cuda, seed=1)
    a2, _ = _lora(1024, 512, 8, cuda, seed=2)
    x = torch.randn((m, 1024), device=cuda).to(torch.bfloat16)
    for cls in (A8LoRAQuantLinear, PallasLoRAQuantLinear):
        layer = cls(kqt, a.clone(), b)
        fresh = cls(kqt, a2.clone(), b)
        layer.load_state_dict(fresh.state_dict())
        assert torch.equal(layer(x), fresh(x))
        layer.a.data.copy_(a)
        assert torch.equal(layer(x), cls(kqt, a.clone(), b)(x))
        assert not torch.equal(layer(x), fresh(x))


# The dequant kernel's canonical entry (csrc/dequant.cu, `dequant_canonical`):
# every packing, both axes, group sizes 8-128 and None, per-tensor meta, meta
# in fp32, bf16 and fp16, meta-quantized scale and zero, two pack blocks,
# group-space rows that 3-bit pads to whole words (R % 10 != 0), rows of C
# values that no 16-byte vector divides (the plan's one-element vectors) and
# packing=None (the codes unpacked in fp32, bf16 or fp16, read as values):
# bit-equal to the plain twin, the same operations rounded in the same type.
# (nbits, group_size, axis, shape, extra quantize arguments, pack blocks)
_CANON_CASES = [
    (8, 64, 1, (96, 256), {}, 1),
    (6, 32, 1, (96, 256), {}, 1),
    (5, 16, 0, (96, 256), {}, 1),
    (4, 64, 1, (96, 256), {}, 1),
    (4, 64, 1, (96, 256), dict(meta_dtype=torch.bfloat16), 1),
    (4, 64, 1, (96, 256), dict(meta_dtype=torch.float16), 1),
    (4, 64, 0, (128, 96), {}, 1),
    (4, 8, 1, (40, 64), {}, 1),
    (4, 128, 1, (64, 384), {}, 2),
    (4, None, 1, (40, 100), {}, 1),          # C = 100: one-element bf16 vectors
    (4, None, 0, (160, 96), {}, 1),
    (4, 64, 1, (96, 256), dict(channel_wise=False), 1),
    (4, 64, 1, (96, 256), dict(scale_quant_params={}, zero_quant_params={}), 1),
    (3, 64, 1, (96, 256), {}, 1),            # R = 384: 3-bit pads 6 rows
    (3, 64, 0, (128, 96), dict(meta_dtype=torch.bfloat16), 1),
    (3, 16, 1, (40, 56), {}, 1),             # R = 140
    (3, 32, 0, (64, 96), {}, 1),             # R = 32: 3-bit pads 8 rows
    (2, 16, 0, (64, 96), {}, 1),
    (2, 32, 1, (96, 256), dict(meta_dtype=torch.float16), 2),
    (1.58, 64, 1, (96, 256), {}, 1),
    (1.58, 16, 0, (128, 96), dict(meta_dtype=torch.bfloat16), 1),
    (1, 32, 1, (96, 256), {}, 1),
    (1, 16, 0, (128, 96), {}, 2),
    (4, 64, 1, (96, 256), dict(bitpack_weights=False), 1),  # bf16 codes
    (8, 32, 0, (128, 96), dict(bitpack_weights=False, compute_dtype=torch.float32), 1),
    (4, None, 1, (40, 100), dict(bitpack_weights=False, compute_dtype=torch.float16), 1),
]


def _canonical_qt(nbits, g, axis, shape, extra, blocks, device, seed=0):
    import dataclasses

    from hqq_tpu_torch.core import bitpack
    from hqq_tpu_torch.core.quantize import unpack_codes

    gen = torch.Generator(device=device).manual_seed(seed)
    w = torch.randn(shape, generator=gen, device=device) / shape[1] ** 0.5
    qt = quantize(w, nbits=nbits, group_size=g, axis=axis, optimize=False, **extra)
    if blocks > 1:
        qt = dataclasses.replace(qt, pack_blocks=blocks, wq=bitpack.pack(
            unpack_codes(qt, torch.int32), qt.packing, blocks=blocks))
    return qt


@pytest.mark.parametrize("nbits,g,axis,shape,extra,blocks", _CANON_CASES)
def test_dequant_canonical_exact(cuda, nbits, g, axis, shape, extra, blocks):
    from unittest import mock

    qt = _canonical_qt(nbits, g, axis, shape, extra, blocks, cuda)
    for dtype in _OUT_TOL:
        launches = fm.dequant_canonical.launches
        got = fm.dequant_canonical(qt, dtype)
        assert fm.dequant_canonical.launches == launches + 1 + 2 * bool(
            extra.get("scale_quant_params") is not None)
        with mock.patch.object(fm, "dequant_canonical", fm.dequantize_plain):
            ref = fm.dequantize_plain(qt, dtype)  # meta-quantized meta plain too
        assert got.dtype == dtype and tuple(got.shape) == shape
        assert torch.equal(got, ref), (dtype, (got.float() - ref.float()).abs().max().item())


def test_dequant_runs_bit_equal(cuda):
    """Three runs of each entry give the same bits."""
    qt = _canonical_qt(4, 64, 1, (512, 1024), {}, 1, cuda)
    layouts = (fm.to_kernel_layout(qt), _kqt0(320, 1024, 16, 2, torch.bfloat16, cuda))
    for run in [lambda: fm.dequant_canonical(qt, torch.bfloat16)] + [
            lambda q=q: fm.dequant(q, torch.bfloat16) for q in layouts]:
        runs = [run() for _ in range(3)]
        assert all(torch.equal(r, runs[0]) for r in runs[1:])


@pytest.mark.parametrize("meta_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [100, 36])
def test_dequant_ax0_unaligned_rows(cuda, meta_dtype, k):
    """Rows of W that start off 16 bytes (K * 2 % 16 != 0): element stores."""
    kqt = _kqt0(64, k, 16, 4, meta_dtype, cuda)
    for dtype in _OUT_TOL:
        assert torch.equal(fm.dequant(kqt, dtype), fm.dequant_plain(kqt, dtype))


def test_quant_linear_launches_canonical(cuda):
    """A CUDA QuantLinear: its forward and its backward each launch the
    canonical dequant once, and the outputs equal the plain route's."""
    from unittest import mock

    from hqq_tpu_torch.nn.linear import QuantLinear

    gen = torch.Generator(device=cuda).manual_seed(3)
    layer = QuantLinear.quantize(torch.randn(256, 512, generator=gen, device=cuda) / 16,
                                 nbits=4, group_size=64)
    x = torch.randn(9, 512, generator=gen, device=cuda).to(torch.bfloat16).requires_grad_()
    g = torch.randn(9, 256, generator=gen, device=cuda).to(torch.bfloat16)
    fm.reset_launch_counts()
    y = layer(x)
    assert fm.dequant_canonical.launches == 1
    y.backward(g)
    assert fm.dequant_canonical.launches == 2
    x2 = x.detach().clone().requires_grad_()
    with mock.patch.object(fm, "dequant_canonical", fm.dequantize_plain):
        y2 = layer(x2)
        y2.backward(g)
    assert torch.equal(y, y2) and torch.equal(x.grad, x2.grad)


@pytest.mark.parametrize("compute", list(_OUT_TOL))
def test_dequant_canonical_packing_none(cuda, compute):
    """packing=None: the codes unpacked in the compute type, which the
    kernel reads as values, one field; one launch, bit-equal to the twin."""
    from hqq_tpu_torch.core.quantize import dequantize

    w = torch.randn(64, 128, device=cuda)
    qt = quantize(w, nbits=4, group_size=64, bitpack_weights=False, optimize=False,
                  compute_dtype=compute)
    assert qt.packing is None and qt.wq.dtype == compute
    assert fm.dequant_canonical_plan(qt, torch.bfloat16).container == -1 - fm._DTYPE_CODE[compute]
    launches = fm.dequant_canonical.launches
    got = dequantize(qt, torch.bfloat16)
    assert fm.dequant_canonical.launches == launches + 1
    assert torch.equal(got, fm.dequantize_plain(qt, torch.bfloat16))


# -- HQQ+'s sub-word groups: a 32-bit word spans 2 or 4 groups -------------

# (nbits, g): 2-bit and 1.58-bit g8 (2 groups a word), 1-bit g8 (4) and g16 (2)
_SUBWORD = [(2, 8), (1.58, 8), (1, 8), (1, 16)]


def _kqt_meta(n, k, g, nbits, meta, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    w = torch.randn((n, k), generator=gen, device=device) / k**0.5
    return fm.to_kernel_layout(quantize(w, nbits=nbits, group_size=g, axis=1), meta)


@pytest.mark.parametrize("meta", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nbits,g", _SUBWORD)
@pytest.mark.parametrize("k,n", [(512, 256), (4096, 1000)])
def test_subword_w4a8(cuda, k, n, nbits, g, meta):
    """Rows 2/3 and 8 on the small-group route at M = 1, 4, 8, 17, 32: each
    field with its own group's scale and zs, against the plain twins (1e-5
    in fp32, one output rounding more in bf16/fp16); three runs bit-equal."""
    kqt = _kqt_meta(n, k, g, nbits, meta, cuda, seed=k + g)
    a, b = _lora(k, n, 8, cuda, seed=g)
    for m in (1, 4, 8, 17, 32):
        assert fm.w4a8_launch_plan(m, n, k, kqt.container_bits, g, meta).route == "group_mma"
        x = torch.randn((m, k), device=cuda)
        x8, sx = fm.quantize_activations_int8(x)
        xa = x @ a
        for dtype, tol in _OUT_TOL.items():
            _close(fm.w4a8_matmul(x8, sx, kqt, dtype), fm.w4a8_matmul_plain(x8, sx, kqt, dtype), tol)
            _close(fm.w4a8_lora_matmul(x8, sx, kqt, xa, b, dtype),
                   fm.w4a8_lora_matmul_plain(x8, sx, kqt, xa, b, dtype), tol)
        first = fm.w4a8_matmul(x8, sx, kqt)
        assert all(torch.equal(fm.w4a8_matmul(x8, sx, kqt), first) for _ in range(2))


@pytest.mark.parametrize("meta", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nbits,g", _SUBWORD)
def test_subword_mainloops_and_dequant(cuda, nbits, g, meta):
    """Row 1 and row 7 on the `qmm_sm90.cuh` mainloop (bf16 x, M = 1, 33,
    512: K split at decode, token tiles up to 256), the fp32 route
    (`qmm_fp32`, 32-wide slabs) and the dequant kernel (exact), at 8 groups
    of a 64-column slab (4 of a 32-column one, 1-bit rows of 8 bytes by
    cp.async)."""
    k, n = 1024, 384
    kqt = _kqt_meta(n, k, g, nbits, meta, cuda, seed=g)
    a, b = _lora(k, n, 8, cuda, seed=1)
    for m in (1, 33, 512):
        x = torch.randn((m, k), device=cuda)
        xb = x.to(torch.bfloat16)
        tol = _OUT_TOL[torch.bfloat16] * 2
        _close(fm.quant_matmul(xb, kqt), fm.quant_matmul_plain(xb, kqt), tol)
        _close(fm.quant_matmul_lora(xb, kqt, a, b), fm.quant_matmul_lora_plain(xb, kqt, a, b), tol)
        launches = fm.qmm_fp32.launches
        _close(fm.quant_matmul(x, kqt), fm.quant_matmul_plain(x, kqt), _OUT_TOL[torch.float32])
        _close(fm.quant_matmul_lora(x, kqt, a, b), fm.quant_matmul_lora_plain(x, kqt, a, b),
               _OUT_TOL[torch.float32])
        assert fm.qmm_fp32.launches == launches + 2
    for dtype in _OUT_TOL:
        assert torch.equal(fm.dequant(kqt, dtype), fm.dequant_plain(kqt, dtype))
