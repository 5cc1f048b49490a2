# SPDX-License-Identifier: Apache-2.0
"""The host side of the Hopper dequant-matmul mainloop (csrc/qmm_sm90.cuh).

What the CPU can hold of it:
  * `qmm_launch_plan`, which `quant_matmul`, `quant_matmul_ax0` and
    `quant_matmul_lora` call: its grid covers every output and every K slab exactly once, its
    token tile is a multiple of 8 (wgmma's N) up to 256, its shared memory
    fits one block of an H100, and at decode sizes (M <= 32) K is split so
    that at least half the SMs have a block where K has the slabs for it
    (one wave of 128 blocks beats two of 256 on the card), while above that
    K is never split (a row of y does not depend on M); with an adapter
    the token tile stops at 128 and the rank goes in chunks of 16 or 64,
    one walk over K each, with at least two stages still in shared memory;
  * the adapter's A as the LoRA kernel reads it: A^T in x's type, the rank
    padded with zero rows, built once by the serving layer;
  * the axis=0 tile order, through a mirror of the kernel's map of tile
    rows to columns (`Ax0Layout`): 8 consecutive b by 16 consecutive a
    (16 by 8 at g = 8) cover every column once, 8-row runs are 8
    consecutive columns where N/g % 8 == 0, a thread's rows share their
    scale and zs, and a slot holds the bytes the launch plans count;
  * the build: every header a kernel source includes is hashed into its
    library's name (`_build._HEADERS`), so an edit to it rebuilds;
  * the entry points at the new tile edges (M = 127 and 129 around the
    128-token tile, a g = 128 group across two 64-wide K slabs, N = 200
    not a multiple of the 128 weight rows of a block) against hqq_tpu's
    interpret-mode Pallas kernels, with the bars of test_torch_fused_matmul
    (fp32 operands: 1e-5 of max|y|), test_torch_ax0 and test_torch_lora
    (2e-5 of max|y|).
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hqq_tpu.core.quantize import quantize as j_quantize
from hqq_tpu.ops import fused_matmul as jf
from hqq_tpu_torch.ops import _build
from hqq_tpu_torch.ops import fused_matmul as tf
from hqq_tpu_torch.utils.convert import params_from_numpy

_M = [1, 4, 8, 32, 33, 64, 65, 512, 1023]
# (cb, g) of both layouts: every container, groups of 8 to 128, and a group
# that neither divides nor is a multiple of the 64-wide slab (axis=1: 96)
_GEOMETRY = {1: [(8, 8), (4, 64), (4, 96), (2, 16), (2, 128), (1, 32)],
             0: [(8, 8), (4, 64), (4, 72), (2, 16), (2, 128), (1, 32)]}
# (n, k) of the 7B linears, a ragged N and a K tail inside a slab
_SHAPES = [(4096, 4096), (11008, 4096), (4096, 11008), (200, 96 * 4), (320, 1152)]


@pytest.mark.parametrize("axis", [1, 0])
@pytest.mark.parametrize("m", _M)
def test_launch_plan(m, axis):
    for cb, g in _GEOMETRY[axis]:
        for n, k in _SHAPES:
            if axis == 0 and n % g:
                continue
            for meta_size in ((4, 2) if axis == 0 else (4,)):
                plan = tf.qmm_launch_plan(m, n, k, cb, g, axis=axis, meta_size=meta_size)
                rows, tokens, splits = plan.grid
                slabs = -(-k // tf.QMM_SLAB)
                # every output once: tiles cover N and M with no empty one
                # (axis=0: b tiles by a tiles, `ax0_tile_rows`)
                if axis == 1:
                    assert (rows - 1) * tf.QMM_ROWS < n <= rows * tf.QMM_ROWS
                else:
                    b_rows, a_rows = tf.ax0_tile_rows(g)
                    b_tiles, a_tiles = -(-(n // g) // b_rows), -(-g // a_rows)
                    assert rows == b_tiles * a_tiles and b_rows * a_rows == tf.QMM_ROWS
                    assert (b_tiles - 1) * b_rows < n // g and (a_tiles - 1) * a_rows < g
                assert (tokens - 1) * plan.token_tile < m <= tokens * plan.token_tile
                # every K slab once, in splits of which none is empty
                assert splits == plan.splits >= 1
                assert (splits - 1) * plan.slabs_per_split < slabs <= splits * plan.slabs_per_split
                assert plan.token_tile % 8 == 0 and plan.token_tile <= 256
                assert plan.token_tile in tf.QMM_TOKEN_TILES
                assert 2 <= plan.stages <= tf.QMM_MAX_STAGES
                assert plan.smem <= tf.H100_SMEM_PER_BLOCK
                if splits > 1:  # fp32 partials are staged in the A tiles: BM <= 64
                    assert plan.token_tile <= 64
                if m <= 64:
                    assert plan.token_tile == min(t for t in tf.QMM_TOKEN_TILES if t >= m)
                else:
                    assert plan.token_tile in (128, 256)
                if m <= tf.QMM_SPLIT_MAX_M:  # half the SMs at least, where K allows
                    if rows * tokens * slabs >= tf.H100_SMS // 2:
                        assert rows * tokens * splits >= tf.H100_SMS // 2
                else:
                    assert splits == 1


def test_launch_plan_main_shapes():
    """The plans of the main paths' shapes, as the card timings name them."""
    plan = tf.qmm_launch_plan(512, 4096, 4096, 4, 64)
    assert (plan.token_tile, plan.splits, plan.grid) == (128, 1, (32, 4, 1))
    plan = tf.qmm_launch_plan(1023, 11008, 4096, 4, 64)
    assert (plan.token_tile, plan.grid) == (256, (86, 4, 1))
    plan = tf.qmm_launch_plan(4, 4096, 4096, 4, 64)
    assert (plan.token_tile, plan.splits, plan.slabs_per_split) == (8, 4, 16)
    plan = tf.qmm_launch_plan(4, 4096, 11008, 4, 64)
    assert (plan.splits, plan.grid) == (4, (32, 1, 4))
    plan = tf.qmm_launch_plan(4, 11008, 4096, 2, 16, axis=0, meta_size=2)
    assert (plan.token_tile, plan.splits) == (8, 3)


_RANKS = [1, 8, 64, 65, 200]


@pytest.mark.parametrize("r", _RANKS)
@pytest.mark.parametrize("m", [1, 4, 32, 33, 512, 1023])
def test_launch_plan_lora(m, r):
    for cb, g in _GEOMETRY[1]:
        for n, k in _SHAPES:
            plan = tf.qmm_launch_plan(m, n, k, cb, g, rank=r)
            rows, tokens, splits = plan.grid
            slabs = -(-k // tf.QMM_SLAB)
            assert (rows - 1) * tf.QMM_ROWS < n <= rows * tf.QMM_ROWS
            assert (tokens - 1) * plan.token_tile < m <= tokens * plan.token_tile
            assert (splits - 1) * plan.slabs_per_split < slabs <= splits * plan.slabs_per_split
            assert plan.token_tile in tf.QMM_TOKEN_TILES
            assert plan.token_tile <= tf.QMM_LORA_MAX_TILE
            # every rank in exactly one chunk of a pass, no pass empty
            assert plan.rank_tile == (16 if r <= 16 else 64)
            assert (plan.passes - 1) * plan.rank_tile < r <= plan.passes * plan.rank_tile
            assert 2 <= plan.stages <= tf.QMM_MAX_STAGES
            assert plan.smem <= tf.H100_SMEM_PER_BLOCK
            assert plan.smem == tf.qmm_smem_bytes(plan.token_tile, plan.stages, tf.QMM_ROWS * 8 * cb,
                                                  tf._slab_meta_bytes(g, 1, 4), plan.rank_tile)
            if splits > 1:
                assert m <= tf.QMM_SPLIT_MAX_M and plan.token_tile <= 64
            if m > tf.QMM_SPLIT_MAX_M:
                assert splits == 1
            # the base's plan but for the tile cap and the adapter's shared memory
            base = tf.qmm_launch_plan(m, n, k, cb, g)
            if base.token_tile <= tf.QMM_LORA_MAX_TILE:
                assert (plan.token_tile, plan.splits, plan.grid) == \
                    (base.token_tile, base.splits, base.grid)


def test_launch_plan_lora_main_shapes():
    """Path E's prefill (M = 512, rank 8) runs the base's 128-token tile."""
    for n, k in ((4096, 4096), (11008, 4096), (4096, 11008)):
        plan = tf.qmm_launch_plan(512, n, k, 4, 64, rank=8)
        assert (plan.token_tile, plan.splits, plan.rank_tile, plan.passes) == (128, 1, 16, 1)
    plan = tf.qmm_launch_plan(4, 4096, 4096, 4, 64, rank=8)
    assert (plan.token_tile, plan.splits, plan.slabs_per_split) == (8, 4, 16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("r", _RANKS)
def test_lora_a_kernel_layout(r, dtype):
    a = torch.from_numpy(np.random.default_rng(r).standard_normal((320, r)).astype(np.float32))
    plan = tf.qmm_launch_plan(40, 256, 320, 4, 64, rank=r)
    at = tf.lora_a_kernel_layout(a, dtype, plan.rank_tile)
    assert at.dtype == dtype and at.is_contiguous()
    assert tuple(at.shape) == (plan.passes * plan.rank_tile, 320)
    assert torch.equal(at[:r], a.to(dtype).t()) and not at[r:].any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("layer", ["PallasLoRAQuantLinear", "A8LoRAQuantLinear"])
def test_lora_layer_holds_a_in_kernel_layout(layer, dtype):
    """A patched HQQ+ layer holds A only as ``a``, from which the wrapper
    builds the kernel's layout at each call: A^T in the weight's compute
    type, its rank padded with zero rows to a whole chunk. Its forward is
    the wrapper's."""
    from hqq_tpu_torch.backends import pallas_backend as pb
    from hqq_tpu_torch.core.quantize import quantize

    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.standard_normal((256, 320)).astype(np.float32))
    kqt = tf.to_kernel_layout(quantize(w, nbits=4, group_size=64, axis=1, compute_dtype=dtype))
    a = torch.from_numpy(rng.standard_normal((320, 8)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((8, 256)).astype(np.float32))
    mod = getattr(pb, layer)(kqt, a, b)
    assert list(mod.named_buffers()) == [] and set(mod.state_dict()) == {"a", "b"}
    a_t = tf.lora_a_kernel_layout(mod.a, dtype, tf.lora_rank_tile(8))
    assert a_t.dtype == dtype and tuple(a_t.shape) == (16, 320) and not a_t.requires_grad
    assert torch.equal(a_t[:8], a.t().to(dtype)) and not a_t[8:].any()
    x = torch.from_numpy(rng.standard_normal((40, 320)).astype(np.float32)).to(dtype)
    torch.testing.assert_close(mod(x), tf.quant_matmul_lora_plain(x, kqt, a, b), rtol=0, atol=0)


def _includes(path):
    with open(path) as fh:
        return re.findall(r'^\s*#\s*include\s+"([^"]+)"', fh.read(), flags=re.M)


_CSRC = os.path.join(os.path.dirname(_build.__file__), "..", "csrc")
_SOURCES = sorted(f for f in os.listdir(_CSRC) if f.endswith((".cu", ".cuh")))


@pytest.mark.parametrize("source", _SOURCES)
def test_every_included_header_is_hashed(source):
    for header in _includes(os.path.join(_CSRC, source)):
        assert header in _build._HEADERS, f"{source} includes {header}, which no build hashes"
    if source.endswith(".cu"):
        assert source in {spec[0] for spec in _build.KERNELS.values()}


def test_every_header_is_a_header():
    for header in _build._HEADERS:
        assert header in _SOURCES and header.endswith(".cuh")


# (m, n_out, k, g, nbits): the 128-token tile's edges, a group across two slabs
_AX1_EDGES = [(127, 200, 1024, 128, 4), (129, 200, 1024, 128, 4), (127, 256, 512, 64, 2),
              (129, 128, 512, 32, 8), (129, 200, 512, 64, 3)]


def _ax1(m, n_out, k, g, nbits):
    rng = np.random.default_rng(m + n_out + k + g + nbits)
    w = (rng.standard_normal((n_out, k)) / np.sqrt(k)).astype(np.float32)
    qj = j_quantize(jnp.asarray(w), nbits=nbits, group_size=g, axis=1,
                    round_zero=(nbits == 4), compute_dtype=jnp.float32)
    kj = jf.to_kernel_layout(qj, pad_k_groups=8)
    kt = tf.to_kernel_layout(params_from_numpy(jax.tree_util.tree_map(np.asarray, qj), "cpu"))
    return kj, kt, rng.standard_normal((m, k)).astype(np.float32)


@pytest.mark.parametrize("m,n_out,k,g,nbits", _AX1_EDGES)
def test_quant_matmul_pallas_tile_edges(m, n_out, k, g, nbits):
    kj, kt, x = _ax1(m, n_out, k, g, nbits)
    yj = np.asarray(jf.quant_matmul_pallas(jnp.asarray(x), kj))
    yt = tf.quant_matmul_pallas(torch.from_numpy(x), kt).numpy()
    assert yt.shape == yj.shape == (m, n_out)
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-5 * np.abs(yj).max())


# (m, n_out, k, g, nbits): N = 200 in groups of 8 rows, a group of 128 rows
# (one block's weight rows), K padded inside a slab
_AX0_EDGES = [(127, 200, 512, 8, 4), (129, 200, 512, 8, 4), (129, 256, 512, 128, 3),
              (127, 320, 200, 16, 2)]


@pytest.mark.parametrize("m,n_out,k,g,nbits", _AX0_EDGES)
def test_quant_matmul_pallas_ax0_tile_edges(m, n_out, k, g, nbits):
    rng = np.random.default_rng(m + n_out + k + g)
    w = (rng.standard_normal((n_out, k)) / np.sqrt(k)).astype(np.float32)
    qj = j_quantize(jnp.asarray(w), nbits=nbits, group_size=g, axis=0,
                    round_zero=(nbits == 4), compute_dtype=jnp.float32)
    kj = jf.to_kernel_layout_ax0(qj)
    kt = tf.to_kernel_layout_ax0(params_from_numpy(jax.tree_util.tree_map(np.asarray, qj), "cpu"))
    x = rng.standard_normal((m, k)).astype(np.float32)
    yj = np.asarray(jf.quant_matmul_pallas(jnp.asarray(x), kj))
    yt = tf.quant_matmul_pallas(torch.from_numpy(x), kt).numpy()
    assert yt.shape == yj.shape == (m, n_out)
    assert np.abs(yt - yj).max() / np.abs(yj).max() < 2e-5


# (m, n_out, k, g, nbits, r): the 128-token tile's edges, N = 200, a group
# of 128 across two slabs, ranks in one chunk of 16, of 64 and in two passes
_LORA_EDGES = [(127, 200, 1024, 128, 4, 1), (129, 200, 1024, 128, 4, 8),
               (129, 200, 512, 64, 4, 65), (127, 256, 512, 64, 2, 8), (33, 200, 512, 128, 4, 65)]


@pytest.mark.parametrize("m,n_out,k,g,nbits,r", _LORA_EDGES)
def test_quant_matmul_pallas_lora_tile_edges(m, n_out, k, g, nbits, r):
    kj, kt, x = _ax1(m, n_out, k, g, nbits)
    rng = np.random.default_rng(r)
    a = (rng.standard_normal((k, r)) / np.sqrt(k)).astype(np.float32)
    b = (rng.standard_normal((r, n_out)) * 0.05).astype(np.float32)
    yj = np.asarray(jf.quant_matmul_pallas_lora(jnp.asarray(x), kj, jnp.asarray(a),
                                                jnp.asarray(b)))
    yt = tf.quant_matmul_pallas_lora(torch.from_numpy(x), kt, torch.from_numpy(a),
                                     torch.from_numpy(b)).numpy()
    assert yt.shape == yj.shape == (m, n_out)
    assert np.abs(yt - yj).max() / np.abs(yj).max() < 2e-5


@pytest.mark.parametrize("meta_size", [4, 2])
@pytest.mark.parametrize("g", [8, 16, 24, 32, 40, 48, 64, 72, 96, 128, 256])
def test_axis1_meta_slot_holds_every_group_of_a_slab(meta_size, g):
    """A pipeline slot of the axis=1 layout (`ax1_params` of qmm_sm90.cuh)
    holds slab_groups groups of scale and zs per row, from a base group
    aligned to the slot where g tiles the 64-wide slab, else to 4 bytes
    (bf16: an even group): every group that a slab's 64 columns touch lies
    in it, a row of it is at least 16 bytes, and the launch plan fits."""
    slab_groups = tf._slab_meta_bytes(g, 1, meta_size) // (2 * tf.QMM_ROWS * meta_size)
    assert slab_groups * meta_size >= 16
    tiles = tf.QMM_SLAB % g == 0 or g % tf.QMM_SLAB == 0
    align = slab_groups if tiles else 4 // meta_size
    k = 4 * g * tf.QMM_SLAB  # many slabs, each start against each group
    for k0 in range(0, k, tf.QMM_SLAB):
        first, last = k0 // g, (k0 + tf.QMM_SLAB - 1) // g
        base = first & ~(align - 1)
        assert base <= first and last < base + slab_groups, (k0, base, slab_groups)
    plan = tf.qmm_launch_plan(512, 4096, k, 4, g, meta_size=meta_size)
    assert plan.smem <= tf.H100_SMEM_PER_BLOCK and plan.stages >= 2


def test_bf16_meta_layout_pads_its_columns():
    """bf16 scale and zs of the axis=1 layout are padded to a multiple of 8
    columns (16-byte rows for TMA) with zeros; the plain dequant reads only
    the K/g groups and gives the 4-bit container's zs its 8 * scale back."""
    from hqq_tpu_torch.core.quantize import quantize, resolve_meta

    w = torch.from_numpy(np.random.default_rng(3).standard_normal((64, 64 * 67)).astype(np.float32))
    for nbits in (4, 2):
        qt = quantize(w, nbits=nbits, group_size=64, axis=1, compute_dtype=torch.float32)
        k32, k16 = tf.to_kernel_layout(qt), tf.to_kernel_layout(qt, torch.bfloat16)
        assert tuple(k16.scale.shape) == tuple(k16.zs.shape) == (64, 72)
        assert not k16.scale[:, 67:].any() and not k16.zs[:, 67:].any()
        assert torch.equal(k16.scale[:, :67], k32.scale.to(torch.bfloat16))
        offset = 8.0 if nbits == 4 else 0.0
        meta = resolve_meta(qt)
        scale, zero = (t.reshape(64, 67).to(torch.float32) for t in (meta.scale, meta.zero))
        assert torch.equal(k16.zs[:, :67], ((zero - offset) * scale).to(torch.bfloat16))
        w16 = tf.dequant_plain(k16)
        assert (w16 - tf.dequant_plain(k32)).abs().max() < 2.0**-7 * w.abs().max()


# -- the axis=0 tile order (`Ax0Layout` of csrc/qmm_sm90.cuh) ---------------


def _ax0_tile_columns(n, g, tile):
    """The kernel's map of a tile's 128 rows to columns of y, -1 where a row
    lies past the weight (`Ax0Layout::column`): tile = its b tile + b_tiles *
    its a tile, row r = a_l * b_rows + b_l, column a * P + b."""
    p = n // g
    b_rows, a_rows = tf.ax0_tile_rows(g)
    b_tiles = -(-p // b_rows)
    r = np.arange(tf.QMM_ROWS)
    a = tile // b_tiles * a_rows + r // b_rows
    b = tile % b_tiles * b_rows + r % b_rows
    return np.where((a < g) & (b < p), a * p + b, -1)


@pytest.mark.parametrize("n", [4096, 11008])
@pytest.mark.parametrize("g", [8, 16, 32, 64, 128])
def test_ax0_tile_order(g, n):
    """Every column of y is one tile row's, once; where P % 8 == 0 every
    8-row run of a tile is 8 consecutive columns starting at a multiple of 8
    (one 16-byte store of bf16, 32 bytes of fp32: `Ax0Layout::run_column`),
    and the rows a consumer thread dequantizes share their b, so one read of
    scale and zs serves them (4 rows r + 16i of the bf16 mainloop, 2 rows
    r + 32i of the fp32 route)."""
    p = n // g
    b_rows, _ = tf.ax0_tile_rows(g)
    tiles = tf._row_tiles(n, g, 0)
    cols = np.stack([_ax0_tile_columns(n, g, t) for t in range(tiles)])
    valid = cols[cols >= 0]
    assert valid.size == n and np.array_equal(np.sort(valid), np.arange(n))
    runs = cols.reshape(tiles, tf.QMM_ROWS // 8, 8)
    for run in runs.reshape(-1, 8):
        if run[0] < 0:
            assert (run < 0).all() or p % 8
            continue
        if p % 8 == 0:
            assert run[0] % 8 == 0 and np.array_equal(run, run[0] + np.arange(8))
    for ct in range(128):
        for wg in range(2):
            bf16_rows = [wg * 64 + 16 * i + ct // 8 for i in range(4)]
            fp32_rows = [wg * 64 + 32 * i + ct // 4 for i in range(2)]
            for rows in (bf16_rows, fp32_rows):
                assert len({r % b_rows for r in rows}) == 1


@pytest.mark.parametrize("meta_size", [4, 2])
@pytest.mark.parametrize("g", [8, 16, 24, 64, 72, 128, 256])
def test_ax0_meta_slot(g, meta_size):
    """A slot of scale and zs holds the slab's columns of the tile's b rows,
    scale then zs (`ax0_params`: a box of {slab, b_rows}); the launch plans
    count the same bytes, and every row's 8 values lie inside the scale half."""
    b_rows, a_rows = tf.ax0_tile_rows(g)
    assert b_rows * a_rows == tf.QMM_ROWS and b_rows == (16 if g == 8 else 8)
    for slab in (tf.QMM_SLAB, tf.QMM_FP32_SLAB):
        slot = tf._slab_meta_bytes(g, 0, meta_size, slab)
        assert slot == 2 * b_rows * slab * meta_size
        for r in range(tf.QMM_ROWS):
            for q in range(slab // 8):
                offset = r % b_rows * slab + 8 * q  # `Ax0Layout::meta_offset`, in elements
                assert (offset + 8) * meta_size <= slot // 2
    n = g * 64
    plan = tf.qmm_launch_plan(512, n, 4096, 4, g, axis=0, meta_size=meta_size)
    assert plan.smem == tf.qmm_smem_bytes(plan.token_tile, plan.stages, tf.QMM_ROWS * 8 * 4,
                                          tf._slab_meta_bytes(g, 0, meta_size))
