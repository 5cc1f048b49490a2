# SPDX-License-Identifier: Apache-2.0
"""The dequant kernel (csrc/dequant.cu) on the CPU: its work split and its
arithmetic, emulated in numpy from the launch plans the wrappers hand it.

The canonical entry: which lane reads which packed elements (one load of
``load_bytes``), which output elements each bitfield of them lands on,
which meta it reads, which 3-bit padding rows it skips (with packing=None:
the codes' own fp32, bf16 or fp16 values, one field), and its rounding in
the meta type T (t = round_T(c - z), w = round_T(t * s), then the output
type). It is held bit-equal to the port's plain twin and to
`hqq_tpu.core.quantize.dequantize` on the same numpy inputs from a seed,
over every packing, both axes, group sizes 8-128 and None, per-tensor meta,
meta in fp32, bf16 and fp16, meta-quantized scale and zero, pack blocks
and 3-bit row padding. Against `hqq_tpu` the bar is bit-equal for every
meta type: run eagerly, XLA rounds each operation to its type as PyTorch
does (held in fp32 output, the arithmetic in T widened exactly, and on the
main path's case in every output type; fp32 meta through `jax.jit`, which
rounds the same there). The kernel layouts' split (both axes) is held bit-equal to
`dequant_plain`. A control must miss: the kernel layout's c*s - z*s in place
of (c - z)*s. On the CPU `dequantize` and the `dequant_matmul` Function
launch nothing and agree with `hqq_tpu`'s at the bars of
tests/test_torch_training.py.
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hqq_tpu.core.quantize import QTensor as JQTensor
from hqq_tpu.core.quantize import dequantize as j_dequantize
from hqq_tpu.nn import linear as jlin
from hqq_tpu_torch.core import bitpack
from hqq_tpu_torch.core.quantize import (BIT_TO_PACKING, QTensor, dequantize, dequantize_plain,
                                         quantize, resolve_meta, unpack_codes)
from hqq_tpu_torch.nn import linear as tlin
from hqq_tpu_torch.ops import fused_matmul as fm

_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}
# hqq_tpu's dequantize compiled whole: one compile a case in place of one a
# primitive. Only for fp32 meta, where XLA's fusion rounds as eager does; in
# bf16 or fp16 it keeps fp32 intermediates, so those cases run eagerly.
_J_DEQUANT = jax.jit(j_dequantize, static_argnums=1)
_OUT = (torch.float32, torch.bfloat16, torch.float16)


def _fdiv(x: np.ndarray, md: tuple) -> np.ndarray:
    """The kernels' `fdiv`: the multiply-high and the shift of `_fastdiv`."""
    mul, shift = md
    x = x.astype(np.uint64)
    return x if mul == 0 else ((x * np.uint64(mul)) >> np.uint64(32)) >> np.uint64(shift)


def _round(x: np.ndarray, dtype) -> np.ndarray:
    """fp32 values rounded to ``dtype`` (to nearest, ties to even), as fp32."""
    x = np.asarray(x, np.float32)
    if dtype == torch.float32:
        return x
    if dtype == torch.float16:
        return x.astype(np.float16).astype(np.float32)
    u = x.view(np.uint32).astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return u.astype(np.uint32).view(np.float32)


def _walk(positions: int, grid: int, threads: int, items: int):
    """The grid-stride walk of the kernels: per (pass, warp, item, lane) the
    vector it takes, -1 past the end. Lanes of a warp's item take
    neighbouring vectors."""
    warps = grid * threads // 32
    passes = -(-positions // (warps * 32 * items))
    pw = np.arange(passes)[:, None, None, None]
    w = np.arange(warps)[None, :, None, None]
    j = np.arange(items)[None, None, :, None]
    lane = np.arange(32)[None, None, None, :]
    p = (pw * warps + w) * 32 * items + j * 32 + lane
    return np.where(p < positions, p, -1)


def _meta_np(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.float32).numpy().reshape(-1)


def _emulate_canonical(qt: QTensor, dtype, control: bool = False) -> torch.Tensor:
    """The canonical entry's work on ``qt`` (scale and zero plain tensors),
    from its launch plan. ``control``: c*s - z*s in place of (c - z)*s."""
    plan = fm.dequant_canonical_plan(qt, dtype)
    total = int(np.prod(qt.shape))
    word_bytes = qt.wq.element_size()
    values = plan.container < 0  # packing=None: the codes as values, one field
    assert plan.container == (-1 - fm._DTYPE_CODE[qt.wq.dtype] if values else word_bytes)
    packed = qt.wq.contiguous().view(-1)
    packed = packed.float().numpy() if values else packed.numpy()
    if plan.container == 4:
        packed = packed.view(np.uint32)
    if not values:
        packed = packed.astype(np.uint64)
    walk = _walk(plan.positions, plan.grid[0], plan.threads, plan.items)
    p = walk[walk >= 0]
    assert np.array_equal(np.sort(p), np.arange(plan.positions))  # each vector once
    vec = plan.vec
    e = p * vec
    # one load of the vector's packed elements, aligned to its width (<= 16)
    assert plan.load_bytes == vec * word_bytes
    assert (e * word_bytes % min(16, plan.load_bytes) == 0).all()
    x = packed[e[:, None] + np.arange(vec)]  # [vectors, vec]
    o0 = e + _fdiv(e, plan.per_block).astype(np.int64) * plan.block_skip
    scale, zero = _meta_np(qt.scale), _meta_np(qt.zero)
    out = np.zeros(total, np.float32)
    written = np.zeros(total, np.int64)
    mask = (1 << plan.bits) - 1
    skipped = 0
    for f in range(plan.fields):
        o = o0 + f * plan.stride
        keep = o < plan.valid
        skipped += int((~keep).sum()) * vec
        oi = o[keep][:, None] + np.arange(vec)
        if values:
            c = x[keep]
        else:
            c = ((x[keep] >> np.uint64(plan.bits * (plan.fields - 1 - f))) & np.uint64(mask))
            c = c.astype(np.float32)
        if plan.meta_mode == 0:
            s, z = scale[0], zero[0]
        elif plan.meta_mode == 1:
            row = _fdiv(o[keep], plan.per_row).astype(np.int64)
            s, z = scale[row][:, None], zero[row][:, None]
        else:
            col = o[keep] - _fdiv(o[keep], plan.per_row).astype(np.int64) * plan.cols
            s, z = scale[col[:, None] + np.arange(vec)], zero[col[:, None] + np.arange(vec)]
        t_ = plan.meta_dtype
        if control:
            w = _round(_round(c * s, t_) - _round(z * s, t_), t_)
        else:
            w = _round(_round(c - z, t_) * s, t_)
        out[oi] = _round(w, dtype)
        written[oi] += 1
    assert (written == 1).all()  # every output once, no padding row written
    assert skipped == (plan.fields * plan.stride - plan.valid) * (qt.pack_blocks == 1)
    return torch.from_numpy(out.reshape(qt.shape)).to(dtype)


def _to_jax(qt):
    """The same QTensor in hqq_tpu (meta-quantized meta too)."""
    if not isinstance(qt, QTensor):
        return jnp.asarray(qt.to(torch.float32).numpy(), _JNP[qt.dtype])
    wq = qt.wq.numpy() if qt.packing else jnp.asarray(qt.wq.float().numpy(),
                                                       _JNP[qt.compute_dtype])
    return JQTensor(wq=jnp.asarray(wq), scale=_to_jax(qt.scale), zero=_to_jax(qt.zero),
                    nbits=qt.nbits, group_size=qt.group_size, axis=qt.axis, shape=qt.shape,
                    packing=qt.packing, compute_dtype=_JNP[qt.compute_dtype],
                    channel_wise=qt.channel_wise, pack_blocks=qt.pack_blocks)


# (nbits, group size, axis, shape, extra quantize arguments, pack blocks)
_GRID = [
    (8, 64, 1, (24, 128), {}, 1),
    (6, 32, 1, (24, 128), dict(meta_dtype=torch.bfloat16), 1),
    (5, 16, 0, (32, 48), {}, 1),
    (4, 64, 1, (24, 128), {}, 1),  # the main path's (hqq_tpu's recipe, round_zero)
    (4, 64, 1, (24, 128), dict(meta_dtype=torch.bfloat16), 1),
    (4, 64, 1, (24, 128), dict(meta_dtype=torch.float16), 1),
    (4, 64, 0, (64, 40), {}, 1),
    (4, 8, 1, (16, 64), {}, 2),
    (4, 128, 0, (128, 24), dict(meta_dtype=torch.float16), 1),
    (4, None, 1, (12, 100), {}, 1),  # C = 100: one-element bf16 vectors
    (4, None, 0, (40, 24), {}, 1),
    (4, 64, 1, (24, 128), dict(channel_wise=False), 1),
    (4, 64, 1, (48, 128), dict(scale_quant_params={}, zero_quant_params={}), 1),
    (3, 64, 1, (24, 128), {}, 1),  # R = 48: 3-bit pads 2 rows
    (3, 64, 0, (64, 56), dict(meta_dtype=torch.bfloat16), 1),
    (3, 16, 1, (20, 56), {}, 1),   # R = 70: no padding
    (3, 32, 0, (32, 56), {}, 1),   # R = 32: pads 8
    (2, 16, 0, (32, 48), {}, 1),
    (2, 32, 1, (24, 128), dict(meta_dtype=torch.float16), 2),
    (1.58, 64, 1, (24, 128), {}, 1),
    (1.58, 16, 0, (48, 32), dict(meta_dtype=torch.bfloat16), 1),
    (1, 32, 1, (24, 128), {}, 1),
    (1, 16, 0, (64, 24), {}, 2),
]


def _qt(nbits, g, axis, shape, extra, blocks, seed=0):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy((rng.standard_normal(shape) / 8).astype(np.float32))
    qt = quantize(w, nbits=nbits, group_size=g, axis=axis, optimize=False,
                  round_zero=nbits == 4 and g == 64, **extra)
    if blocks > 1:
        qt = dataclasses.replace(qt, pack_blocks=blocks, wq=bitpack.pack(
            unpack_codes(qt, torch.int32), qt.packing, blocks=blocks))
    return qt


def _case_id(case):
    nbits, g, axis, shape, extra, blocks = case
    return f"{nbits}b-g{g}-ax{axis}-{'x'.join(map(str, shape))}-" + \
        "-".join(sorted(extra)) + f"-blocks{blocks}"


@pytest.mark.parametrize("case", _GRID, ids=_case_id)
def test_canonical_emulation_matches_twin_and_hqq_tpu(case):
    qt = _qt(*case)
    rq = resolve_meta(qt)
    jq = _to_jax(qt)
    fp32_meta = torch.promote_types(rq.scale.dtype, rq.zero.dtype) == torch.float32
    j_run = _J_DEQUANT if fp32_meta else j_dequantize
    for dtype in _OUT:
        got = _emulate_canonical(rq, dtype)
        assert torch.equal(got, dequantize_plain(qt, dtype)), dtype
        # hqq_tpu in fp32 out (its arithmetic in T, widened exactly); every
        # output type on the main path's case (one JAX compile per shape)
        if dtype == torch.float32 or case == _GRID[3]:
            ref = np.asarray(j_run(jq, _JNP[dtype]).astype(jnp.float32))
            assert np.array_equal(got.float().numpy(), ref), dtype


def test_control_c_times_s_minus_zs_misses():
    """(c - z)*s and c*s - z*s round differently: in fp32 the emulated
    control is not bit-equal to the twin on the main path's case, nor on at
    least half of the grid. (A bf16 output hides most of the difference: at
    these sizes no element of the main path's case rounds to another bf16
    value.)"""
    qt = resolve_meta(_qt(*_GRID[3]))
    assert not torch.equal(_emulate_canonical(qt, torch.float32, control=True),
                           dequantize_plain(qt, torch.float32))
    misses = [not torch.equal(_emulate_canonical(rq, torch.float32, True),
                              dequantize_plain(rq, torch.float32))
              for rq in (resolve_meta(_qt(*c)) for c in _GRID)]
    assert sum(misses) >= len(_GRID) // 2, misses


def test_canonical_plan_covers_every_packing():
    """A route for every nbits of BIT_TO_PACKING, both axes, g 8-128 and
    None; 16-byte output vectors where C allows, one element where not; the
    load is the vector's packed elements, at most 32 bytes (two 16-byte
    loads) and aligned to its width up to 16."""
    for nbits, packing in BIT_TO_PACKING.items():
        for axis in (0, 1):
            for g in (8, 16, 32, 64, 128, None):
                qt = _qt(nbits, g, axis, (32, 128), {}, 1)
                for dtype in _OUT:
                    plan = fm.dequant_canonical_plan(qt, dtype)
                    full = 16 // (4 if dtype == torch.float32 else 2)
                    cols = int(np.prod(qt.shape)) // qt.wq.shape[0] if packing == "8bit_u8" \
                        else qt.wq.shape[1]
                    assert plan.fields == bitpack.VALS_PER_WORD[packing]
                    assert plan.vec == (full if cols % full == 0 else 1)
                    assert plan.container == (4 if packing == "3bit_32" else 1)
                    assert plan.load_bytes == plan.vec * plan.container <= 32
                    assert plan.grid[0] <= fm.DEQUANT_MAX_BLOCKS
    odd = _qt(4, None, 1, (12, 100), {}, 1)
    assert fm.dequant_canonical_plan(odd, torch.bfloat16).vec == 1
    assert fm.dequant_canonical_plan(odd, torch.float32).vec == 4


def test_canonical_plan_i_shapes():
    """Path I's linears (4-bit g64, fp32 meta, to bf16): 16-byte stores, 8-byte
    loads of two fields, one wave of 1056 blocks at most (1024 at 4096 x
    4096: one pass); a warp's 32 lanes store 32 neighbouring vectors of each
    field."""
    for n, k in ((4096, 4096), (11008, 4096), (4096, 11008)):
        rows = n * k // 64
        qt = QTensor(wq=torch.zeros((rows // 2, 64), dtype=torch.uint8),
                     scale=torch.ones((rows, 1)), zero=torch.zeros((rows, 1)), nbits=4,
                     group_size=64, axis=1, shape=(n, k), packing="4bit_u8")
        plan = fm.dequant_canonical_plan(qt, torch.bfloat16)
        assert (plan.vec, plan.load_bytes, plan.fields, plan.meta_mode) == (8, 8, 2, 1)
        assert plan.stride == n * k // 2 and plan.valid == n * k
        assert plan.positions == n * k // 16
        assert plan.grid == (min(fm.DEQUANT_MAX_BLOCKS, plan.positions // 1024),)
        walk = _walk(plan.positions, plan.grid[0], plan.threads, plan.items)[0]
        assert (np.diff(walk, axis=-1) == 1).all()  # lanes on neighbouring vectors


@pytest.mark.parametrize("compute", _OUT)
def test_packing_none_reads_the_codes_as_values(compute):
    """packing=None (bitpack_weights=False): the codes unpacked in the
    compute type, one field, read by their value; bit-equal to the twin and
    to hqq_tpu, whose codes are the same values."""
    qt = _qt(4, 64, 1, (24, 128), dict(bitpack_weights=False, compute_dtype=compute), 1)
    assert qt.packing is None and qt.wq.dtype == compute
    jq = _to_jax(qt)
    for dtype in _OUT:
        plan = fm.dequant_canonical_plan(qt, dtype)
        assert (plan.container, plan.fields) == (-1 - fm._DTYPE_CODE[compute], 1)
        assert plan.load_bytes == plan.vec * compute.itemsize
        got = _emulate_canonical(qt, dtype)
        assert torch.equal(got, dequantize(qt, dtype)), dtype
        if dtype == compute:  # one JAX call a compute type
            ref = np.asarray(j_dequantize(jq, _JNP[dtype]).astype(jnp.float32))
            assert np.array_equal(got.float().numpy(), ref)


def test_fastdiv_is_floor_division():
    rng = np.random.default_rng(5)
    for d in list(range(1, 300)) + [688, 1376, 11008, 2**20 + 1, 2**30 - 1, 2**31 - 1]:
        md = fm._fastdiv(d)
        assert 0 <= md[0] < 2**32
        q = rng.integers(0, (2**31 - 1) // d + 1, 64)
        x = np.concatenate([rng.integers(0, 2**31, 64), q * d, q * d - 1, q * d + d - 1,
                            [0, 2**31 - 1]])
        x = x[(x >= 0) & (x < 2**31)]
        assert np.array_equal(_fdiv(x, md), x // d), d


def _emulate_ax1(kqt, dtype):
    plan = fm.dequant_launch_plan(kqt.n, kqt.k, kqt.container_bits, kqt.group_size, dtype,
                                  kqt.scale.dtype)
    walk = _walk(plan.vectors, plan.grid[0], plan.threads, plan.items)
    v = walk[walk >= 0].astype(np.int64)
    assert np.array_equal(np.sort(v), np.arange(plan.vectors))
    cb, vec = kqt.container_bits, plan.vec
    words = kqt.wq.contiguous().view(-1).numpy().view(np.uint32).astype(np.uint64)
    e = v[:, None] * vec + np.arange(vec)  # the codes of a vector: W's elements
    kk = e % (32 // cb)
    code = (words[e // (32 // cb)] >> (cb * (kk // 4) + 8 * (kk % 4)).astype(np.uint64)) \
        & np.uint64((1 << cb) - 1)
    grp = _fdiv(v * vec, plan.per_group).astype(np.int64)
    mi = grp + _fdiv(grp, plan.per_row_groups).astype(np.int64) * plan.pad
    s, zs = _meta_np(kqt.scale)[mi][:, None], _meta_np(kqt.zs)[mi][:, None]
    offset = fm._ax1_zs_offset(cb, kqt.scale.dtype)
    z = (zs + np.float32(offset) * s).astype(np.float32) if offset else zs
    out = np.zeros(kqt.n * kqt.k, np.float32)
    out[e] = _round(code.astype(np.float32) * s - z, dtype)
    return torch.from_numpy(out.reshape(kqt.n, kqt.k)).to(dtype)


def _emulate_ax0(kqt, dtype):
    plan = fm.dequant_launch_plan(kqt.n, kqt.k, kqt.container_bits, kqt.group_size, dtype,
                                  kqt.scale.dtype, axis=0, k_pad=kqt.k_pad)
    gx, p_blocks, gz = plan.grid
    cb, vec, k, k_pad = kqt.container_bits, plan.vec, kqt.k, kqt.k_pad
    g = kqt.n // p_blocks
    k0 = (np.arange(gx * plan.threads) * vec)
    k0 = k0[k0 < k]
    a = np.arange(gz * plan.rows_per_block)
    a = a[a < g]  # slices of rows_per_block rows, the last cut at g
    b = np.arange(p_blocks)
    row = (a[:, None] * p_blocks + b[None, :]).reshape(-1)  # rows n = a*P + b
    col = k0[:, None] + np.arange(vec)  # [vectors, vec]
    words = kqt.wq.contiguous().view(-1).numpy().view(np.uint32).astype(np.uint64)
    c_ = 32 // cb
    wi = row[:, None, None] * (k_pad // c_) + col[None] // c_
    kk = col % c_
    code = (words[wi] >> (cb * (kk // 4) + 8 * (kk % 4)).astype(np.uint64)[None]) \
        & np.uint64((1 << cb) - 1)
    mi = (row % p_blocks)[:, None, None] * k_pad + col[None]
    s, z = _meta_np(kqt.scale)[mi], _meta_np(kqt.zs)[mi]
    val = _round(code.astype(np.float32) * s - z, dtype)
    out = np.full((kqt.n, k), np.nan, np.float32)
    written = np.zeros((kqt.n, k), np.int64)
    keep = np.broadcast_to(col[None] < k, val.shape)
    rr = np.broadcast_to(row[:, None, None], val.shape)
    cc = np.broadcast_to(col[None], val.shape)
    out[rr[keep], cc[keep]] = val[keep]
    np.add.at(written, (rr[keep], cc[keep]), 1)
    assert (written == 1).all()  # every element once, the K padding never
    return torch.from_numpy(out).to(dtype)


@pytest.mark.parametrize("meta_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nbits,g,n,k", [(4, 64, 24, 256), (3, 32, 16, 192), (2, 16, 8, 128),
                                         (1, 32, 8, 256), (8, 8, 16, 64)])
def test_kernel_layout_axis1_emulation(meta_dtype, nbits, g, n, k):
    rng = np.random.default_rng(nbits)
    w = torch.from_numpy((rng.standard_normal((n, k)) / 8).astype(np.float32))
    kqt = fm.to_kernel_layout(quantize(w, nbits=nbits, group_size=g, axis=1, optimize=False,
                                       round_zero=nbits == 4), meta_dtype)
    for dtype in _OUT:
        assert torch.equal(_emulate_ax1(kqt, dtype), fm.dequant_plain(kqt, dtype))


@pytest.mark.parametrize("meta_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nbits,g,n,k", [(4, 64, 128, 96), (3, 64, 128, 100), (2, 16, 64, 72),
                                         (1, 32, 64, 36), (8, 8, 32, 40)])
def test_kernel_layout_axis0_emulation(meta_dtype, nbits, g, n, k):
    rng = np.random.default_rng(nbits)
    w = torch.from_numpy((rng.standard_normal((n, k)) / 8).astype(np.float32))
    kqt = fm.to_kernel_layout_ax0(quantize(w, nbits=nbits, group_size=g, axis=0,
                                           optimize=False), meta_dtype)
    for dtype in _OUT:
        plan = fm.dequant_launch_plan(n, k, kqt.container_bits, g, dtype, meta_dtype, axis=0,
                                      k_pad=kqt.k_pad)
        assert plan.aligned == (k * (4 if dtype == torch.float32 else 2) % 16 == 0)
        assert torch.equal(_emulate_ax0(kqt, dtype), fm.dequant_plain(kqt, dtype))


def test_kernel_layout_plans_at_full_size():
    """Row 4's shapes: one wave of grid-stride blocks (axis=1); a block per
    residue class and 128 vectors of columns, sliced along its rows until
    16 blocks an SM (axis=0)."""
    p1 = fm.dequant_launch_plan(4096, 11008, 4, 64, torch.bfloat16)
    assert (p1.vec, p1.vectors, p1.grid, p1.pad) == (8, 4096 * 11008 // 8, (1056,), 0)
    assert fm.dequant_launch_plan(4096, 11008, 4, 64, torch.bfloat16, torch.bfloat16).pad == 4
    p0 = fm.dequant_launch_plan(11008, 4096, 2, 16, torch.bfloat16, torch.bfloat16, axis=0,
                                k_pad=4096)
    assert (p0.grid, p0.rows_per_block, p0.aligned) == ((4, 688, 1), 16, True)
    p0 = fm.dequant_launch_plan(4096, 4096, 4, 64, torch.bfloat16, axis=0, k_pad=4096)
    assert (p0.grid, p0.rows_per_block) == ((4, 64, 8), 8)


def test_cpu_route_launches_nothing_and_matches_hqq_tpu():
    """dequantize and the dequant_matmul Function on the CPU: the plain twin,
    no launch; forward and dx against hqq_tpu's dequant_matmul and its VJP
    in the main path's bf16 (the bar of test_dequant_matmul_backward, 2^-7;
    tests/test_torch_training.py holds fp32 at 1e-6)."""
    rng = np.random.default_rng(7)
    for dtype in (torch.bfloat16,):
        w = torch.from_numpy((rng.standard_normal((48, 128)) / 8).astype(np.float32))
        qt = quantize(w, nbits=4, group_size=64, compute_dtype=dtype, round_zero=True)
        jq = dataclasses.replace(_to_jax(qt))
        x = rng.standard_normal((5, 128)).astype(np.float32)
        gy = rng.standard_normal((5, 48)).astype(np.float32)

        def fwd_bwd(a, g):
            y, vjp = jax.vjp(lambda a_: jlin.dequant_matmul(a_, jq), a)
            return y, vjp(g)[0]

        yj, dxj = jax.jit(fwd_bwd)(jnp.asarray(x, _JNP[dtype]), jnp.asarray(gy, _JNP[dtype]))
        fm.reset_launch_counts()
        with mock.patch.object(fm, "dequant_canonical", wraps=fm.dequant_canonical) as route:
            xt = torch.from_numpy(x).to(dtype).requires_grad_()
            yt = tlin.dequant_matmul(xt, qt)
            yt.backward(torch.from_numpy(gy).to(dtype))
        assert route.call_count == 2 and fm.dequant_canonical.launches == 0
        tol = 1e-6 if dtype == torch.float32 else 2.0**-7
        for a, b in ((yt.detach(), yj), (xt.grad, dxj)):
            b = np.asarray(jnp.asarray(b, jnp.float32))
            assert np.abs(a.float().numpy() - b).max() <= tol * np.abs(b).max()
        assert qt.scale.dtype == qt.zero.dtype == torch.float32
        assert np.array_equal(dequantize(qt).float().numpy(),
                              np.asarray(_J_DEQUANT(jq, None).astype(jnp.float32)))


def test_training_step_dequantizes_each_linear_twice_but_three():
    """One HQQ+ step of `make_lora_train_step` on a tiny Llama: the route
    runs once per quantized linear in the forward and once in the backward
    of every linear whose input carries a gradient: all but layer 0's q, k
    and v projections, which read the frozen embedding's normed output. At
    Llama-2-7B, 224 + 221 = 445 launches a step."""
    from hqq_tpu_torch import BaseQuantizeConfig
    from hqq_tpu_torch.core.peft import PeftUtils, TrainableParams, lora_config
    from hqq_tpu_torch.models.base import quantize_model
    from hqq_tpu_torch.models.llama import LlamaConfig, init_params
    from hqq_tpu_torch.utils.training import causal_lm_loss, make_lora_train_step

    cfg = LlamaConfig.tiny()
    params = init_params(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    quantize_model(params, BaseQuantizeConfig(nbits=4, group_size=64, optimize=False),
                   compute_dtype=torch.float32)
    PeftUtils.add_lora(params, lora_config(r=4, lora_alpha=4),
                       generator=torch.Generator().manual_seed(1))
    trainable = TrainableParams(params)
    step = make_lora_train_step(cfg, trainable, torch.optim.SGD(trainable.values(), lr=1e-3))
    batch = torch.randint(0, cfg.vocab_size, (1, 17), generator=torch.Generator().manual_seed(2))
    calls = []

    def counted(qt, dtype=None):
        calls.append(qt.shape)
        return fm.dequantize_plain(qt, dtype)

    with mock.patch.object(fm, "dequant_canonical", counted):
        with torch.no_grad():
            causal_lm_loss(params, cfg, batch)
        forward = len(calls)
        step(params, batch)
    linears = 7 * cfg.num_hidden_layers
    assert forward == linears and len(calls) - 2 * forward == linears - 3
