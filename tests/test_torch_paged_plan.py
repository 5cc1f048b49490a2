# SPDX-License-Identifier: Apache-2.0
"""The host side of the paged decode-attention kernel
(csrc/paged_attention.cu) and a mirror of its walk, as far as the CPU can
hold them.

`paged_launch_plan` decides by shape alone how the kernel runs: whole pages
by bulk copy where a page (and, for int8, its run of scales) meets the bulk
copy's 16-byte rule, else by cp.async; how many query heads of a kv head a
block serves; pages per stage and ring slots within a block's shared
memory; how many splits share a slot's pages. `kernel_walk` below repeats
the kernel's arithmetic in torch (per block: the split's stages, stage i
to consumer warp (i % stages) % warps, steps of 2 * 32 / lanes rows, rows at
or past the slot's length never read, an online softmax per query head;
then the warps' and the splits' merges) and is held to the plain version,
also with NaN in every row past the lengths.
"""

import pytest
import torch

from hqq_tpu_torch.ops import paged as pa
from hqq_tpu_torch.ops.fused_matmul import H100_SMEM_PER_BLOCK

_TYPES = [torch.float32, torch.bfloat16, torch.float16, torch.int8]
_SIZE = {torch.float32: 4, torch.bfloat16: 2, torch.float16: 2, torch.int8: 1}


@pytest.mark.parametrize("dtype", _TYPES)
@pytest.mark.parametrize("hd", [4, 32, 80, 128, 256])
@pytest.mark.parametrize("pg", [1, 8, 16, 32])
def test_paged_plan_fits(dtype, hd, pg):
    """Shared memory is the source's formula and fits a block; the bulk path
    is taken exactly where the page and scale runs meet the 16-byte rule;
    a row's lanes cover its 16-byte vectors; each consumer warp owns as
    many slots as the others."""
    for b, nh, n_kv in [(8, 32, 32), (8, 32, 8), (3, 6, 3), (1, 4, 1)]:
        plan = pa.paged_launch_plan(b, nh, n_kv, hd, pg, 64, dtype)
        row = hd * _SIZE[dtype]
        quant = dtype == torch.int8
        assert plan.smem == pa.paged_smem_bytes(row, pg, plan.pages_per_stage, plan.stages, quant,
                                                plan.heads_per_block, hd, plan.warps)
        assert plan.smem <= H100_SMEM_PER_BLOCK
        assert plan.bulk == (pg * row % 16 == 0 and (not quant or pg * 4 % 16 == 0))
        assert plan.vec16 == (row % 16 == 0)
        vectors = -(-row // 16)
        lanes = 2**plan.lanes_log2
        assert lanes >= vectors or (lanes == 32 and vectors <= 64 and dtype == torch.float32)
        assert lanes == 1 or lanes // 2 < vectors
        assert plan.pages_per_stage * pg >= min(pa.PAGED_STAGE_ROWS, pg)
        assert plan.warps in (1, 2, 4, 8) and plan.stages >= 1
        assert plan.stages % plan.warps == 0 or plan.warps == 1
        rep = nh // n_kv
        assert rep % plan.heads_per_block == 0
        assert plan.heads_per_block in ((1, 2) if quant else (1, 2, 4))


@pytest.mark.parametrize("b,nh,n_kv,dtype,heads,warps,splits", [
    (8, 32, 32, torch.int8, 1, 8, 1), (8, 32, 32, torch.bfloat16, 1, 8, 1),
    (8, 32, 8, torch.bfloat16, 4, 8, 4), (8, 32, 8, torch.int8, 2, 8, 2),
    (1, 4, 4, torch.bfloat16, 1, 8, 8)])
def test_paged_plan_of_the_7b_shapes(b, nh, n_kv, dtype, heads, warps, splits):
    """Path G (32/32, pages of 16 rows of 128): one block per (slot, kv
    head), pages by bulk copy, eight consumer warps with a ring slot of one
    page each (4.2 KB at int8, 8.2 KB at bf16), two blocks an SM; GQA serves
    four query heads a block (two at int8), splitting where the blocks
    would not fill the card."""
    plan = pa.paged_launch_plan(b, nh, n_kv, 128, 16, 64, dtype)
    assert plan.bulk and plan.vec16 and plan.pages_per_stage == 1
    assert (plan.warps, plan.stages) == (warps, warps)
    assert (plan.heads_per_block, plan.splits) == (heads, splits)


def split_pages(plan, length: int, page_size: int, max_pages: int) -> list:
    """The block-table entries each split's block reads for a slot of
    ``length`` keys, as the kernel computes them: the slot's pages
    ceil(length / page_size) (length clamped to the table) in stages of
    ``pages_per_stage``, an equal share of the stages per split."""
    length = min(max(length, 0), max_pages * page_size)
    n_pages = -(-length // page_size)
    all_stages = -(-n_pages // plan.pages_per_stage)
    per = -(-all_stages // plan.splits)
    pps = plan.pages_per_stage
    return [range(min(n_pages, z * per * pps), min(n_pages, min(all_stages, (z + 1) * per) * pps))
            for z in range(plan.splits)]


@pytest.mark.parametrize("pg,mp", [(1, 64), (8, 16), (16, 64), (32, 8), (5, 20)])
@pytest.mark.parametrize("b,nh,n_kv", [(1, 4, 1), (8, 32, 8), (8, 32, 32)])
def test_paged_splits_cover_each_page_once(pg, mp, b, nh, n_kv):
    """The splits of a slot read its pages ceil(length / pg) exactly once,
    in order, and no table entry past them, for every length (past the
    table's capacity too)."""
    plan = pa.paged_launch_plan(b, nh, n_kv, 128, pg, mp, torch.bfloat16)
    for length in list(range(0, mp * pg + 3)):
        parts = split_pages(plan, length, pg, mp)
        assert len(parts) == plan.splits
        pages = [p for part in parts for p in part]
        assert pages == list(range(-(-min(length, mp * pg) // pg)))
        assert all(part.start % plan.pages_per_stage == 0 for part in parts if len(part))


def kernel_walk(plan, q, k, v, lengths, tab, ks=None, vs=None) -> torch.Tensor:
    """[B, nh, hd] in fp32 as the kernel computes it (see the module
    docstring); rows at or past a slot's length are never read."""
    b, nh, hd = q.shape
    n_kv, _, pg, _ = k.shape
    mp = tab.shape[1]
    rep, qh, pps = nh // n_kv, plan.heads_per_block, plan.pages_per_stage
    step = 2 * (32 >> plan.lanes_log2)
    warps = plan.warps
    neg = torch.tensor(-float("inf"))
    out = torch.zeros((b, nh, hd))
    for s in range(b):
        length = min(max(int(lengths[s]), 0), mp * pg)
        for kvh in range(n_kv):
            for g in range(rep // qh):
                heads = [kvh * rep + g * qh + j for j in range(qh)]
                qf = q[s, heads].float()
                splits = []
                for pages in split_pages(plan, length, pg, mp):
                    m = neg.repeat(warps, qh)
                    lsum = torch.zeros((warps, qh))
                    acc = torch.zeros((warps, qh, hd))
                    for i, p0 in enumerate(range(pages.start, pages.stop, pps)):
                        w = i % plan.stages % warps
                        rows = min(length - p0 * pg, pps * pg)
                        stage = [int(tab[s, p]) for p in range(p0, min(pages.stop, p0 + pps))]
                        kst = torch.cat([k[kvh, p] for p in stage]).float()
                        vst = torch.cat([v[kvh, p] for p in stage]).float()
                        if ks is not None:
                            kss = torch.cat([ks[kvh, p, :, 0] for p in stage]) / 127.0
                            vss = torch.cat([vs[kvh, p, :, 0] for p in stage]) / 127.0
                        for r0 in range(0, rows, step):
                            idx = torch.arange(r0, min(rows, r0 + step))
                            sc = qf @ kst[idx].T  # [qh, n]
                            if ks is not None:
                                sc = sc * kss[idx]
                            mx = sc.max(dim=1).values
                            moved = mx > m[w]
                            corr = torch.where(moved, torch.exp(m[w] - mx), torch.ones(qh))
                            m[w] = torch.where(moved, mx, m[w])
                            lsum[w] *= corr
                            acc[w] *= corr[:, None]
                            p = torch.exp(sc - m[w][:, None])
                            lsum[w] += p.sum(dim=1)
                            pv = p * vss[idx] if ks is not None else p
                            acc[w] += pv @ vst[idx]
                    big = m.max(dim=0).values
                    e = torch.where(big > -float("inf"), torch.exp(m - big), torch.zeros(qh))
                    splits.append((big, (lsum * e).sum(0), (acc * e[..., None]).sum(0)))
                big = torch.stack([x[0] for x in splits]).max(dim=0).values
                tot, o = torch.zeros(qh), torch.zeros((qh, hd))
                for mz, lz, oz in splits:
                    e = torch.where(big > -float("inf"), torch.exp(mz - big), torch.zeros(qh))
                    tot, o = tot + lz * e, o + oz * e[:, None]
                out[s, heads] = torch.where(tot[:, None] > 0, o / tot[:, None], 0.0)
    return out


def _pools(b, nh, n_kv, hd, pg, mp, lengths, int8, seed):
    gen = torch.Generator().manual_seed(seed)
    num_pages = 1 + b * mp
    k = torch.randn((n_kv, num_pages, pg, hd), generator=gen)
    v = torch.randn((n_kv, num_pages, pg, hd), generator=gen)
    q = torch.randn((b, nh, hd), generator=gen) * hd**-0.5
    tab = (1 + torch.randperm(num_pages - 1, generator=gen)).reshape(b, mp).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32)
    tab = torch.where(torch.arange(mp)[None] < (lens[:, None] + pg - 1) // pg, tab, 0)
    owned = torch.zeros((num_pages, pg), dtype=torch.bool)
    for s, n in enumerate(lengths):
        for r in range(n):
            owned[tab[s, r // pg], r % pg] = True
    if int8:
        k, ks = pa.quant_rows(k)
        v, vs = pa.quant_rows(v)
        nan = [k, v, torch.where(owned[None, :, :, None], ks, torch.nan),
               torch.where(owned[None, :, :, None], vs, torch.nan)]
        return q, (k, v, ks, vs), nan, lens, tab
    nan = [torch.where(owned[None, :, :, None], x, torch.nan) for x in (k, v)] + [None, None]
    return q, (k, v, None, None), nan, lens, tab


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("b,nh,n_kv,hd,pg,mp,lengths", [
    (4, 8, 4, 32, 16, 8, [0, 5, 16, 100]),     # bulk pages, one block a kv head pair
    (2, 4, 1, 4, 1, 48, [1, 45]),              # pages of one row: 16 a stage, cp.async
    (1, 4, 4, 32, 8, 32, [250]),               # one slot: split over blocks
    (3, 6, 3, 80, 5, 12, [7, 60, 33]),         # pages of 5 rows, 3 a stage
])
def test_kernel_walk_matches_the_plain_version(int8, b, nh, n_kv, hd, pg, mp, lengths):
    """The kernel's walk gives the plain version's result (fp32 sums in
    another order: the fp32/int8 bar of the card tests, 2e-5 of max|out|),
    and the same bits with NaN in every row past the lengths (int8: in their
    scales) and in every page no slot owns; a length of 0 gives zeros."""
    q, pools, nan_pools, lens, tab = _pools(b, nh, n_kv, hd, pg, mp, lengths, int8, seed=hd + pg)
    dtype = torch.int8 if int8 else torch.float32
    plan = pa.paged_launch_plan(b, nh, n_kv, hd, pg, mp, dtype)
    ref = pa.paged_attention_plain(q, pools[0], pools[1], lens, tab, pools[2], pools[3])
    got = kernel_walk(plan, q, *pools[:2], lens, tab, *pools[2:])
    live = lens > 0  # the plain version averages V over the masked keys at length 0
    assert (got[live] - ref[live]).abs().max() <= 2e-5 * ref[live].abs().max()
    tails = kernel_walk(plan, q, *nan_pools[:2], lens, tab, *nan_pools[2:])
    assert torch.isfinite(tails).all() and torch.equal(tails, got)
    for s, n in enumerate(lengths):
        if n == 0:
            assert (got[s] == 0).all()


def test_paged_plan_refuses():
    with pytest.raises(ValueError):
        pa.paged_launch_plan(1, 6, 4, 128, 16, 8, torch.bfloat16)  # heads not a multiple
    with pytest.raises(ValueError):
        pa.paged_launch_plan(1, 4, 4, 130, 16, 8, torch.bfloat16)  # head size not of 4s
    with pytest.raises(ValueError):
        pa.paged_launch_plan(1, 4, 4, 128, 16, 8, torch.int32)
