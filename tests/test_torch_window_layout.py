"""The row-walk kernel's launch layout (ops/window.py `walk_layout`), on the CPU.

A cluster of K blocks runs one segment; block r owns nodes
[r * slice, min(n, (r + 1) * slice)). The node state (8 int32 words a node)
lives in shared memory while a block's slice of it fits in the 232,448 bytes
an H100 block may use, and in global scratch past that.
"""

import pytest

from spark_scheduler_tpu_torch.ops.window import (
    CLUSTER_BLOCKS,
    SMEM_PER_BLOCK,
    STATE_WORDS,
    WALK_LANE_SMEM,
    WALK_STATIC_SMEM,
    ZONE_LANES,
    WalkLayout,
    walk_layout,
    walk_scratch_words,
)

SIZES = [1, 24, 300, 8191, 8192, 8193, 10000, 16384, 58000, 100000]


def _owned(layout: WalkLayout, n: int, r: int) -> range:
    lo = min(n, r * layout.slice)
    return range(lo, min(n, lo + layout.slice))


def _smem_need(n: int) -> int:
    return STATE_WORDS * 4 * -(-n // CLUSTER_BLOCKS) + WALK_STATIC_SMEM


@pytest.mark.parametrize("n", SIZES)
def test_walk_layout(n):
    layout = walk_layout(n)
    assert layout.k == CLUSTER_BLOCKS == 8
    # The K slices cover 0..n-1 exactly once, in order.
    nodes = [i for r in range(layout.k) for i in _owned(layout, n, r)]
    assert nodes == list(range(n))
    assert layout.smem_bytes <= SMEM_PER_BLOCK
    # Shared memory exactly while the state fits, global past that.
    fits = _smem_need(n) <= SMEM_PER_BLOCK
    assert layout.state == ("smem" if fits else "global")
    if fits:
        assert layout.smem_bytes == _smem_need(n)
    else:
        assert layout.smem_bytes == WALK_STATIC_SMEM
    # The global layout is available at every n (tests force it).
    forced = walk_layout(n, state="global")
    assert forced.slice == layout.slice and forced.k == layout.k
    assert forced.smem_bytes == WALK_STATIC_SMEM


def test_walk_layout_switches_exactly_past_the_limit():
    # 32 B x slice + 400 B <= 232,448 B  <=>  slice <= 7,251.
    last = 8 * ((SMEM_PER_BLOCK - WALK_STATIC_SMEM) // (STATE_WORDS * 4))
    assert last == 58_008
    assert walk_layout(last).state == "smem"
    assert walk_layout(last).smem_bytes <= SMEM_PER_BLOCK
    assert walk_layout(last + 1).state == "global"
    with pytest.raises(ValueError):
        walk_layout(last + 1, state="smem")
    with pytest.raises(ValueError):
        walk_layout(0)
    with pytest.raises(ValueError):
        walk_layout(24, state="registers")


@pytest.mark.parametrize("state", ["smem", "global"])
def test_walk_scratch_words(state):
    layout = walk_layout(16384, state=state)
    per_block = 2 * 32 + 2 * 4 + (STATE_WORDS * 2048 if state == "global" else 0)
    assert walk_scratch_words(layout, 32, 4) == 8 * per_block


@pytest.mark.parametrize("num_zones", [1, 6, 8, 17])
@pytest.mark.parametrize("state", ["smem", "global"])
def test_walk_scratch_words_zone_lanes(num_zones, state):
    # The single-AZ strategies' zone-parallel instantiation adds one slot
    # row a zone lane, min(num_zones, 8) rows of emax words a block; a
    # plain strategy's launch keeps the scratch it had.
    layout = walk_layout(16384, state=state, zone_lanes=True)
    plain = walk_layout(16384, state=state)
    assert layout.zone_lanes and not plain.zone_lanes
    base = 2 * 32 + 2 * num_zones + (STATE_WORDS * 2048 if state == "global" else 0)
    assert walk_scratch_words(plain, 32, num_zones) == 8 * base
    assert walk_scratch_words(layout, 32, num_zones) == 8 * (
        base + min(num_zones, ZONE_LANES) * 32)


def test_zone_lanes_walk_layout():
    # The lane buffers (3,408 B of static shared memory a block) move the
    # zone-parallel instantiation's switch to global state to n = 57,160.
    assert WALK_LANE_SMEM == 3_408
    static = WALK_STATIC_SMEM + WALK_LANE_SMEM
    last = 8 * ((SMEM_PER_BLOCK - static) // (STATE_WORDS * 4))
    assert last == 57_160
    fit = walk_layout(last, zone_lanes=True)
    assert fit.state == "smem"
    assert fit.smem_bytes == STATE_WORDS * 4 * fit.slice + static <= SMEM_PER_BLOCK
    assert walk_layout(last + 1, zone_lanes=True) == WalkLayout(
        8, -(-(last + 1) // 8), static, "global", True)
    assert walk_layout(last + 1).state == "smem"
    with pytest.raises(ValueError):
        walk_layout(last + 1, state="smem", zone_lanes=True)
