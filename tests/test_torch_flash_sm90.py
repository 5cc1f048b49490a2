# SPDX-License-Identifier: Apache-2.0
"""The host side of the Hopper flash-attention kernel (csrc/flash_prefill.cu).

What the CPU can hold of it: `flash_launch_plan`, which `flash_attention`
hands to the kernel. Its table of query tiles, which the kernel reads, has
every tile once, so the blocks cover every (batch, head, query tile) once;
the table starts with the query tiles that walk the most key tiles under
causality; the head size pads to the least of 64, 128 and 256 that holds it;
and its shared memory fits one block of an H100 with at least two slots of
K and V for every head size the kernel takes (16 to 256).
"""

import pytest

from hqq_tpu_torch.ops import attention as at
from hqq_tpu_torch.ops import fused_matmul as fm

_HEADS = list(range(16, 257, 16))


@pytest.mark.parametrize("hd", _HEADS)
def test_flash_plan_fits(hd):
    plan = at.flash_launch_plan(2, 8, 1023, hd)
    assert plan.head_pad == min(p for p in at.FLASH_HEAD_PADS if p >= hd)
    assert plan.key_tile in (64, 128) and plan.key_tile % 16 == 0
    assert 2 <= plan.stages <= at.FLASH_MAX_STAGES
    assert plan.smem == at.flash_smem_bytes(plan.head_pad, plan.key_tile, plan.stages)
    assert plan.smem <= fm.H100_SMEM_PER_BLOCK
    # one more slot would not fit, or the ring is at its most
    assert plan.stages == at.FLASH_MAX_STAGES or at.flash_smem_bytes(
        plan.head_pad, plan.key_tile, plan.stages + 1) > fm.H100_SMEM_PER_BLOCK


@pytest.mark.parametrize("b,nh,t", [(1, 32, 1023), (4, 32, 512), (3, 5, 4097), (2, 1, 1),
                                    (1, 4, 128), (1, 4, 129)])
def test_flash_plan_covers_every_tile_once(b, nh, t):
    """The kernel runs block i on query tile q_order[i // (b * nh)] of
    (batch, head) i % (b * nh): with blocks = b * nh * len(q_order), every
    (batch, head, query tile) once when the table holds every tile once."""
    plan = at.flash_launch_plan(b, nh, t, 128)
    q_tiles = len(plan.q_order)
    assert (q_tiles - 1) * at.FLASH_QUERY_TILE < t <= q_tiles * at.FLASH_QUERY_TILE
    assert sorted(plan.q_order) == list(range(q_tiles))
    assert plan.blocks == b * nh * q_tiles
    blocks = [(plan.q_order[i // (b * nh)], i % (b * nh)) for i in range(plan.blocks)]
    assert sorted(blocks) == sorted((q, h) for q in range(q_tiles) for h in range(b * nh))


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("b,nh,t", [(1, 32, 1023), (4, 8, 4096), (2, 3, 300)])
def test_flash_plan_longest_tiles_first(b, nh, t, hd):
    """Under causality a query tile walks the key tiles up to its diagonal:
    along the plan's table, the kernel's launch order, that count never
    grows."""
    plan = at.flash_launch_plan(b, nh, t, hd)
    walks = [-(-min(t, (q + 1) * at.FLASH_QUERY_TILE) // plan.key_tile) for q in plan.q_order]
    assert walks == sorted(walks, reverse=True)
    assert walks[0] == -(-t // plan.key_tile)


def test_flash_plan_refuses_other_heads():
    for hd in (8, 24, 272):
        with pytest.raises(ValueError):
            at.flash_launch_plan(1, 1, 256, hd)

