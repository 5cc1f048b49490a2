# SPDX-License-Identifier: Apache-2.0
"""The w4a8 kernel's arithmetic and launch plan, on the CPU.

`csrc/w4a8_matmul.cu` cannot run here, so its arithmetic is emulated in
numpy on the packed words, as the card runs it, and held to
`hqq_tpu.ops.fused_matmul.quant_matmul_pallas_a8` (its Pallas kernels in
interpret mode) and to the port's plain twin `w4a8_matmul_plain`:

  * tensor-core route (`w4a8_mma_kernel`): per k32 step, the A fragment of
    each thread t (threadID_in_group) unpacked from the words it reads
    (codes 8t .. 8t+3 of the step into the MMA's k = 4t .. 4t+3, codes
    8t+4 .. 8t+7 into k = 16+4t .. 16+4t+3), the B fragment of x8 in that
    same k order, the int32 MMA, the MMA of ones that gives xsum; F steps
    chained, then folded into fp32 with the group's scale and zs; stage i to
    k-slice i % slices, the slices' partials summed in order, times sx,
    plus the LoRA term;
  * small-group route (`w4a8_group_mma_kernel`, g % 32 != 0 or meta too
    large for a block): per k32 step, the same fragments; each of the
    step's groups ("pieces") its own MMA, the chunks (8 codes of a thread)
    of every other piece zeroed; xsum per (token, piece) from the stage's
    x8; each piece folded into fp32 with its group's scale and zs at once,
    the first half of the pieces into one set of accumulators and the
    second into another (the kernel's two column halves of an n8 tile);
    per k-slice the halves summed, stage i to k-slice i % slices, the
    slices summed in order, times sx, plus the LoRA term;
  * CUDA-core route (`w4a8_dp4a_kernel`, code or meta rows off the 16-byte
    rule): per lane its groups' exact dots folded in order, then the warp's
    butterfly sum.

Bars (of max|y|): 1e-5 in fp32 (exact dots, fp32 folds in another order),
2^-7 for a bf16 output (one rounding more). Control: B in the MMA's natural
k order while A is permuted must miss the fp32 bar. The plan: shared memory
against the formula and the card, every (weight row, stage) covered once,
the SMs filled or a reason given, the small-group route by shape, the
16-byte rule of every TMA source.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hqq_tpu.core.quantize import quantize as j_quantize
from hqq_tpu.ops import fused_matmul as jf
from hqq_tpu_torch.ops import fused_matmul as tf
from hqq_tpu_torch.utils.convert import params_from_numpy

_MAGIC = 12582912.0  # 0x4B400000 as fp32: the MMA chains' start


def _fma32(a, b, c):
    """fp32 fused multiply-add: the product exact in float64, one rounding
    to fp32 (a second rounding in float64 only where exponents part by more
    than 29 bits)."""
    f64 = np.float64
    return (np.asarray(a, f64) * np.asarray(b, f64) + np.asarray(c, f64)).astype(np.float32)


def _bytes(v: np.ndarray) -> np.ndarray:
    """uint32 [...] -> int64 [..., 4], byte 0 the least significant."""
    return (v[..., None].astype(np.int64) >> (8 * np.arange(4))) & 0xFF


def _fragments(words, x8, ks, cb, natural_b=False):
    """A [rows, 32] and B [32, tokens] of the k32 step at code ks, in the
    MMA's k order, as the kernel's threads hold them (`unpack_a`); words
    and codes past K are the TMA's zero fill."""
    n, nw = words.shape
    m, k = x8.shape
    mask = ((1 << cb) - 1) * 0x01010101
    a = np.zeros((n, 32), np.int64)
    b = np.zeros((32, m), np.int64)
    xpad = np.zeros((m, max(k, ks) + 32), np.int64)  # past K: the zero fill
    xpad[:, :k] = x8
    for t in range(4):
        wi = ks * cb // 32 + t * cb // 4
        w = words[:, wi] if wi < nw else np.zeros(n, np.uint32)
        if cb == 8:
            lo = w
            hi = words[:, wi + 1] if wi + 1 < nw else np.zeros(n, np.uint32)
        else:
            f = (2 * t) % (8 // cb)
            lo = (w >> np.uint32(cb * f)) & np.uint32(mask)
            hi = (w >> np.uint32(cb * f + cb)) & np.uint32(mask)
        a[:, 4 * t:4 * t + 4] = _bytes(lo)
        a[:, 16 + 4 * t:16 + 4 * t + 4] = _bytes(hi)
        b[4 * t:4 * t + 4] = xpad[:, ks + 8 * t:ks + 8 * t + 4].T
        b[16 + 4 * t:16 + 4 * t + 4] = xpad[:, ks + 8 * t + 4:ks + 8 * t + 8].T
    if natural_b:  # the control: x8 in the MMA's own k order
        b = xpad[:, ks:ks + 32].T.copy()
    return a, b


def _meta(kqt):
    """scale and zs [N, meta_cols] as the kernel reads them (fp32, bf16
    widened), zs with the 4-bit bf16 container's 8 * scale back."""
    s = kqt.scale.to(torch.float32).numpy()
    zs = kqt.zs.to(torch.float32).numpy()
    off = tf._ax1_zs_offset(kqt.container_bits, kqt.scale.dtype)
    return s, _fma32(np.float32(off), s, zs)


def _epilogue(v, sx, xa, b, dtype):
    """y = v * sx + sum_j xa[:, j] * b[j] (fp32 fma chains), rounded once."""
    l = np.zeros_like(v)
    if xa is not None:
        for j in range(xa.shape[1]):
            l = _fma32(xa[:, j][:, None], b[j][None, :], l)
    y = _fma32(v, sx.reshape(-1, 1), l)
    return torch.from_numpy(y).to(dtype)


def _emulate_tc(x8, sx, kqt, plan, xa=None, b=None, dtype=torch.float32, natural_b=False):
    m, k = x8.shape
    n, cb, g = kqt.n, kqt.container_bits, kqt.group_size
    words = kqt.wq.numpy().view(np.uint32).reshape(n, -1)
    s, z = _meta(kqt)
    cols = s.shape[1]
    cpg = g // 32
    fold = 4 if cpg % 4 == 0 else 2 if cpg % 2 == 0 else 1
    acc = np.zeros((plan.k_slices, n, m), np.float32)
    for i in range(plan.stages_total):
        k0 = i * plan.stage_codes
        grp = k0 // g  # the group of the stage's first step, and the step's place in it
        cig = (k0 - grp * g) // 32
        for c0 in range(0, plan.stage_codes // 32, fold):
            d = np.zeros((n, m), np.int64)
            dx = np.zeros(m, np.int64)
            for c in range(c0, c0 + fold):
                fa, fb = _fragments(words, x8, k0 + 32 * c, cb, natural_b)
                d += fa @ fb
                dx += fb.sum(axis=0)
            assert np.abs(d).max() < 2**22 and np.abs(dx).max() < 2**22  # the magic start holds
            sc = s[:, grp] if grp < cols else np.zeros(n, np.float32)  # past K: the zero fill
            zc = z[:, grp] if grp < cols else np.zeros(n, np.float32)
            a_ = acc[i % plan.k_slices]
            a_ = _fma32(sc[:, None], d.astype(np.float32), a_)
            acc[i % plan.k_slices] = _fma32(-dx.astype(np.float32)[None, :], zc[:, None], a_)
            cig += fold
            if cig == cpg:
                cig, grp = 0, grp + 1
    v = acc[0]
    for q in range(1, plan.k_slices):
        v = (v + acc[q]).astype(np.float32)
    return _epilogue(v.T, sx, xa, b, dtype)


def _pieces(ks, g, cols, moved=False):
    """The small-group route's pieces of the k32 step at code ks: for each
    piece p < `w4a8_group_pieces(g)`, the MMA's k mask of the threads whose
    chunk (codes ks + 8t .. + 7) lies in it, its group's meta column (a
    piece no chunk lies in takes the step's first group, as the kernel does:
    its dot and xsum are 0; None past the columns: the TMA's zero fill) and
    those threads. ``moved``: thread 0's mask moved to the next piece (the
    control)."""
    first = ks // g
    pieces = tf.w4a8_group_pieces(g)
    of_t = [(ks + 8 * t) // g - first for t in range(4)]
    shown = [(p + 1) % pieces if moved and t == 0 else p for t, p in enumerate(of_t)]
    out = []
    for p in range(pieces):
        mask = np.zeros(32, bool)
        for t in range(4):
            if shown[t] == p:
                mask[4 * t:4 * t + 4] = mask[16 + 4 * t:16 + 4 * t + 4] = True
        mine = [t for t in range(4) if of_t[t] == p]
        grp = first + p if mine else first
        out.append((mask, grp if grp < cols else None, mine))
    return out


def _emulate_gm(x8, sx, kqt, plan, xa=None, b=None, dtype=torch.float32, moved=False):
    """The small-group route on the packed words: steps of a stage in order,
    each piece's masked MMA, its xsum and its fold, acc += s * dot - xsum * z
    (fp32 fma), pieces p < P/2 into one half's accumulators and the rest
    into the other's (P = 1: all in the first); per k-slice the halves
    summed, then the slices in order, times sx, plus the LoRA term."""
    m, k = x8.shape
    n, cb, g = kqt.n, kqt.container_bits, kqt.group_size
    words = kqt.wq.numpy().view(np.uint32).reshape(n, -1)
    s, z = _meta(kqt)
    cols = s.shape[1]
    half = max(1, tf.w4a8_group_pieces(g) // 2)  # pieces a half
    xi = x8.astype(np.int64)
    acc = np.zeros((plan.k_slices, 2, n, m), np.float32)
    for i in range(plan.stages_total):
        k0 = i * plan.stage_codes
        for c in range(-(-min(plan.stage_codes, k - k0) // 32)):
            ks = k0 + 32 * c
            fa, fb = _fragments(words, x8, ks, cb)
            for p, (mask, grp, mine) in enumerate(_pieces(ks, g, cols, moved)):
                d = (fa * mask) @ fb
                xs = sum((xi[:, ks + 8 * t:ks + 8 * t + 8].sum(axis=1) for t in mine),
                         np.zeros(m, np.int64))
                sc = s[:, grp] if grp is not None else np.zeros(n, np.float32)
                zc = z[:, grp] if grp is not None else np.zeros(n, np.float32)
                a_ = _fma32(sc[:, None], d.astype(np.float32), acc[i % plan.k_slices, p // half])
                acc[i % plan.k_slices, p // half] = _fma32(-xs.astype(np.float32)[None, :],
                                                           zc[:, None], a_)
    v = (acc[:, 0] + acc[:, 1]).astype(np.float32)
    for q in range(1, plan.k_slices):
        v[0] = (v[0] + v[q]).astype(np.float32)
    return _epilogue(v[0].T, sx, xa, b, dtype)


def _emulate_cc(x8, sx, kqt, xa=None, b=None, dtype=torch.float32):
    """The CUDA-core route: lane l folds groups l, l + 32, ... in order,
    then the butterfly sum over the 32 lanes."""
    m, k = x8.shape
    n, g = kqt.n, kqt.group_size
    groups = k // g
    codes = tf._unpack_words(kqt.wq, kqt.container_bits).numpy().astype(np.int64)
    s, z = _meta(kqt)
    lanes = np.zeros((32, n, m), np.float32)
    xi = x8.astype(np.int64)
    for grp in range(groups):
        sl = slice(grp * g, (grp + 1) * g)
        idot = codes[:, sl] @ xi[:, sl].T
        xsum = xi[:, sl].sum(axis=1)
        lane = grp % 32
        a_ = _fma32(s[:, grp][:, None], idot.astype(np.float32), lanes[lane])
        lanes[lane] = _fma32(-xsum.astype(np.float32)[None, :], z[:, grp][:, None], a_)
    for off in (16, 8, 4, 2, 1):
        lanes = (lanes + lanes[np.arange(32) ^ off]).astype(np.float32)
    return _epilogue(lanes[0].T, sx, xa, b, dtype)


def emulate(x8, sx, kqt, xa=None, b=None, dtype=torch.float32, natural_b=False, moved=False):
    plan = tf.w4a8_launch_plan(x8.shape[0], kqt.n, kqt.k, kqt.container_bits, kqt.group_size,
                               kqt.scale.dtype)
    if plan.route == "tensor_cores":
        return _emulate_tc(x8, sx, kqt, plan, xa, b, dtype, natural_b)
    if plan.route == "group_mma":
        return _emulate_gm(x8, sx, kqt, plan, xa, b, dtype, moved)
    return _emulate_cc(x8, sx, kqt, xa, b, dtype)


# (m, n, k, g, nbits, bf16 meta, rank): 1/2/4-bit and 5-bit in the 8-bit
# container, g 16-128, M 1-32, ragged N, K % 8g != 0, both meta types, with
# and without an adapter
_CASES = [
    (1, 256, 1024, 64, 4, False, 0),
    (3, 200, 512, 32, 4, True, 0),     # ragged N, bf16 meta
    (8, 256, 512, 128, 2, False, 8),
    (17, 136, 768, 64, 1, False, 0),   # 1-bit
    (32, 256, 1024, 64, 5, False, 0),  # 5-bit in the 8-bit container
    (32, 256, 64 * 5, 64, 4, True, 8),  # K % 8g != 0, bf16 4-bit: the zs offset
    (4, 256, 64 * 7, 64, 3, False, 0),  # 3-bit in the 4-bit container, K % 8g != 0
    (8, 256, 512, 16, 4, False, 0),    # g 16: the CUDA-core route
    (17, 256, 512, 16, 2, True, 8),    # g 16, 2-bit: the CUDA-core route
    (3, 256, 1024, 32, 1, False, 8),
    (32, 300, 960, 32, 2, False, 0),   # ragged N, 30 groups
]


def _case(m, n, k, g, nbits, bf16, rank):
    rng = np.random.default_rng(m * 7 + k + (nbits if nbits == int(nbits) else int(nbits * 100)))
    w = (rng.standard_normal((n, k)) / np.sqrt(k)).astype(np.float32)
    qj = j_quantize(jnp.asarray(w), nbits=nbits, group_size=g, axis=1,
                    round_zero=(nbits == 4), compute_dtype=jnp.float32)
    kj = jf.to_kernel_layout(qj, meta_dtype=jnp.bfloat16 if bf16 else jnp.float32)
    qt = params_from_numpy(jax.tree_util.tree_map(np.asarray, qj), "cpu")
    kt = tf.to_kernel_layout(qt, torch.bfloat16 if bf16 else torch.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    a = (rng.standard_normal((k, rank)) / np.sqrt(k)).astype(np.float32) if rank else None
    b = (rng.standard_normal((rank, n)) * 0.05).astype(np.float32) if rank else None
    return kj, kt, x, a, b


def _rel(y, ref) -> float:
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    return np.abs(y - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("m,n,k,g,nbits,bf16,rank", _CASES)
def test_emulation_matches_hqq_tpu_and_plain(m, n, k, g, nbits, bf16, rank):
    kj, kt, x, a, b = _case(m, n, k, g, nbits, bf16, rank)
    x8t, sxt = tf.quantize_activations_int8(torch.from_numpy(x))
    x8, sx = x8t.numpy(), sxt.numpy()
    xa = x @ a if rank else None
    got = emulate(x8, sx, kt, xa, b).numpy()
    if rank and k % (8 * g) == 0:
        ref_j = np.asarray(jf.quant_matmul_pallas_a8_lora(jnp.asarray(x), kj, jnp.asarray(a),
                                                          jnp.asarray(b)))
    elif rank:  # hqq_tpu leaves the int8 route there: its int8 base plus the adapter
        ref_j = np.asarray(jf.quant_matmul_pallas_a8(jnp.asarray(x), kj)) + (
            x.astype(np.float64) @ a) @ b
    if rank:
        plain = tf.w4a8_lora_matmul_plain(x8t, sxt, kt, torch.from_numpy(xa), torch.from_numpy(b))
    else:
        ref_j = np.asarray(jf.quant_matmul_pallas_a8(jnp.asarray(x), kj))
        plain = tf.w4a8_matmul_plain(x8t, sxt, kt)
    assert got.shape == ref_j.shape == (m, n)
    assert _rel(got, ref_j) < 1e-5
    assert _rel(got, plain.numpy()) < 1e-5
    # a bf16 output: one rounding more
    got16 = emulate(x8, sx, kt, xa, b, torch.bfloat16).float().numpy()
    assert _rel(got16, plain.numpy()) < 2.0**-7


@pytest.mark.parametrize("m,n,k,g,nbits,bf16,rank", [c for c in _CASES if c[3] % 32 == 0][:4])
def test_permuted_a_with_natural_b_misses(m, n, k, g, nbits, bf16, rank):
    """The control: A unpacked as the kernel does, B in the MMA's natural k
    order: the group dots pair codes with the wrong activations."""
    _, kt, x, _, _ = _case(m, n, k, g, nbits, bf16, 0)
    x8t, sxt = tf.quantize_activations_int8(torch.from_numpy(x))
    bad = emulate(x8t.numpy(), sxt.numpy(), kt, natural_b=True).numpy()
    assert _rel(bad, tf.w4a8_matmul_plain(x8t, sxt, kt).numpy()) > 1e-2


# -- the launch plan ---------------------------------------------------------

# the 7B decode shapes (K, N) and the card tests' shapes
_PLAN_SHAPES = [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000), (4096 + 192, 4096),
                (512, 1000), (64 * 67, 256), (1024, 384), (512, 256), (2048, 128), (1024, 256)]


@pytest.mark.parametrize("k,n,nbits,g", [
    (k, n, nbits, g) for (k, n) in _PLAN_SHAPES
    for (nbits, g) in [(4, 64), (4, 32), (4, 128), (2, 64), (1, 32), (5, 64)] if k % g == 0])
def test_plan_smem_coverage_and_tma_rules(k, n, nbits, g):
    cb = tf._KERNEL_CONTAINER_BITS[nbits]
    for m in (1, 4, 8, 17, 32):
        for meta in (torch.float32, torch.bfloat16):
            p = tf.w4a8_launch_plan(m, n, k, cb, g, meta)
            if k * cb // 8 % 16:  # 1-bit rows of odd 16-byte length: the CUDA cores
                assert p.route == "cuda_cores" and "16-byte rule" in p.why
                continue
            if p.route == "group_mma":  # 1-bit g32 at K = 11008: the meta leaves no ring
                assert "no room for a ring" in p.why and cb == 1 and k > 8192
                _check_group_plan(p, m, n, k, cb, g, meta)
                continue
            assert p.route == "tensor_cores", p
            size = 2 if meta == torch.bfloat16 else 4
            # shared memory: the formula, within a block's limit
            assert p.smem == tf.w4a8_smem_bytes(p.stage_codes, p.token_tile, p.meta_cols,
                                                p.meta_boxes, size, p.stages, p.col_tile)
            assert p.smem <= tf.H100_SMEM_PER_BLOCK
            assert p.token_tile >= m and p.stages % p.k_slices == 0
            assert p.k_slices * p.col_tile // 16 == tf.W4A8_CONSUMERS
            # every (weight row, stage) once: blocks x row groups, slices x stages
            rows = np.zeros(n, int)
            for blk in range(p.grid[0]):
                for rg in range(p.col_tile // 16):
                    lo = blk * p.col_tile + 16 * rg
                    rows[lo:lo + 16] += 1
            assert (rows[:n] == 1).all()
            stages = np.zeros(p.stages_total, int)
            for sl in range(p.k_slices):
                stages[sl::p.k_slices] += 1
            assert (stages == 1).all() and p.stages_total * p.stage_codes >= k > (
                p.stages_total - 1) * p.stage_codes
            # the SMs filled, or the plan says why not
            assert p.grid[0] >= tf.H100_SMS or p.why, p
            # the 16-byte rule: code rows, x8 rows, the meta box rows (an odd
            # number of 16 bytes: bank groups) and their starts; the boxes
            # hold every group a step reads, those past K included
            assert k * cb // 8 % 16 == 0 and k % 16 == 0
            assert p.meta_cols * size % 16 == 0 and p.meta_cols * size // 16 % 2 == 1
            assert p.meta_cols <= 256 and p.col_tile <= 256 and p.token_tile <= 256
            assert p.meta_boxes * p.meta_cols >= -(-p.stages_total * p.stage_codes // g)
            assert all(b * p.meta_cols * size % 16 == 0 for b in range(p.meta_boxes))
            assert p.meta_tma == (tf.ax1_meta_cols(k // g, meta) * size % 16 == 0)


def _check_group_plan(p, m, n, k, cb, g, meta):
    """A small-group plan: its shared memory by the formula and within a
    block, every (weight row, stage) covered once, a grid over the column
    tiles alone, the TMA rules of its maps."""
    size = 2 if meta == torch.bfloat16 else 4
    pieces = tf.w4a8_group_pieces(g)
    assert p.stage_codes == 1024 // cb and p.stages_total == -(-k // p.stage_codes)
    assert p.meta_cols == 128 // size
    assert p.meta_boxes == tf.w4a8_group_meta_boxes(p.stage_codes, g, size)
    assert p.smem == tf.w4a8_group_smem(p.stage_codes, p.token_tile, p.col_tile, p.meta_boxes,
                                        pieces, p.k_slices, p.stages)
    assert p.smem <= tf.H100_SMEM_PER_BLOCK and p.token_tile >= m
    assert p.stages >= p.k_slices and p.stages % p.k_slices == 0
    assert p.col_tile // 16 * p.k_slices <= tf.W4A8_CONSUMERS
    # every (weight row, stage) once: blocks x row groups, slices x stages
    rows = np.zeros(p.grid[0] * p.col_tile, int)
    for blk in range(p.grid[0]):
        for rg in range(p.col_tile // 16):
            rows[blk * p.col_tile + 16 * rg:blk * p.col_tile + 16 * rg + 16] += 1
    assert (rows[:n] == 1).all() and len(p.grid) == 1 and p.grid[0] == -(-n // p.col_tile)
    stages = np.zeros(p.stages_total, int)
    for sl in range(p.k_slices):
        stages[sl::p.k_slices] += 1
    assert (stages == 1).all()
    # a stage's meta boxes, from its first group's column rounded down to
    # 16 bytes (a TMA box's start), hold every group its steps touch
    for i in range(p.stages_total):
        k0 = i * p.stage_codes
        first = k0 // g // (16 // size) * (16 // size)
        last = (min(k, k0 + p.stage_codes) - 1) // g
        assert last - first < p.meta_boxes * p.meta_cols and first * size % 16 == 0
    # TMA: code, x8 and meta rows of whole 16 bytes
    assert k * cb // 8 % 16 == 0 and k % 16 == 0
    assert tf.ax1_meta_cols(k // g, meta) * size % 16 == 0 and p.meta_tma
    assert p.grid[0] >= tf.H100_SMS or "blocks of" in p.why


@pytest.mark.parametrize("k,n,nbits,g,why", [
    (512, 256, 4, 16, "g = 16"), (960, 256, 4, 24, "g = 24"), (512, 256, 2, 16, "g = 16"),
    (512, 256, 4, 8, "g = 8"), (4096, 11008, 2, 8, "g = 8"), (4096, 11008, 1, 8, "g = 8"),
    (4096, 11008, 1, 16, "g = 16"), (11008, 4096, 2, 8, "g = 8"),
    (96, 256, 1, 32, "16-byte rule"), (32 * 3, 256, 2, 32, "16-byte rule"),
    (4544, 4672, 1, 8, "16-byte rule"), (96, 256, 4, 16, "meta rows of 24 bytes"),
])
def test_plan_routes_small_groups_to_cuda_cores(k, n, nbits, g, why):
    """g % 32 != 0: the small-group route, chosen by shape before any
    launch, its column tile and K split the same at every M (the grid over
    the column tiles alone); code or meta rows off the 16-byte rule: the
    CUDA-core kernel; the same shapes at g % 32 == 0 and whole 16-byte rows
    take the tensor cores."""
    cb = tf._KERNEL_CONTAINER_BITS[nbits]
    for meta in (torch.float32, torch.bfloat16):
        plans = {m: tf.w4a8_launch_plan(m, n, k, cb, g, meta) for m in (1, 4, 8, 17, 32)}
        off_rule = "16-byte rule" in why or (why.startswith("meta") and meta == torch.float32)
        for m, p in plans.items():
            if off_rule:
                assert p.route == "cuda_cores" and why in p.why
                # x8's 8 rows of a K-tile: 32 groups, or 32 * (32 // g) under 32 codes
                tile = 32 * max(1, 32 // g)
                assert p.grid == (-(-n // 16), -(-m // 8)) and p.smem == 8 * tile * (g // 4 + 1) * 4
                continue
            assert p.route == "group_mma" and (why in p.why or why.startswith("meta")), p
            _check_group_plan(p, m, n, k, cb, g, meta)
        if not off_rule:
            assert len({(p.col_tile, p.k_slices, p.stage_codes, p.grid) for p in plans.values()}) == 1
    assert tf.w4a8_launch_plan(4, n, 1024, cb, 64).route == "tensor_cores"
