"""The queue kernel's launch layout (ops/fifo.py `queue_layout`), on the CPU.

A queue runs on one team of threads: one block ("block", below
QUEUE_CLUSTER_MIN_NODES nodes) or one cluster of CLUSTER_BLOCKS blocks
("cluster"), where block r owns nodes [r * slice, min(n, (r + 1) * slice)).
The node state (8 int32 words a node) lives in shared memory while a
block's slice of it fits beside the team's static buffers in the 232,448
bytes an H100 block may use, and in global scratch past that.
"""

import pytest

from spark_scheduler_tpu_torch.ops.fifo import (
    QUEUE_BLOCK_LANE_SMEM,
    QUEUE_BLOCK_STATIC_SMEM,
    QUEUE_CLUSTER_MIN_NODES,
    QueueLayout,
    queue_layout,
    queue_scratch_words,
)
from spark_scheduler_tpu_torch.ops.gang import strategy_params
from spark_scheduler_tpu_torch.ops.window import (
    CLUSTER_BLOCKS,
    SMEM_PER_BLOCK,
    STATE_WORDS,
    WALK_LANE_SMEM,
    WALK_STATIC_SMEM,
    ZONE_LANES,
)

SIZES = [1, 9, 10, 500, 1000, QUEUE_CLUSTER_MIN_NODES - 1,
         QUEUE_CLUSTER_MIN_NODES, QUEUE_CLUSTER_MIN_NODES + 1, 10000]
# The largest n whose state fits a block's shared memory:
# 32 B x n + 512 B <= 232,448 B.
BLOCK_SMEM_MAX = (SMEM_PER_BLOCK - QUEUE_BLOCK_STATIC_SMEM) // (STATE_WORDS * 4)


def _owned(layout: QueueLayout, n: int, r: int) -> range:
    lo = min(n, r * layout.slice)
    return range(lo, min(n, lo + layout.slice))


@pytest.mark.parametrize("n", SIZES)
def test_queue_layout_default(n):
    layout = queue_layout(n)
    cluster = n >= QUEUE_CLUSTER_MIN_NODES
    assert layout.team == ("cluster" if cluster else "block")
    assert layout.k == (CLUSTER_BLOCKS if cluster else 1)
    # The team's slices cover 0..n-1 exactly once, in order.
    nodes = [i for r in range(layout.k) for i in _owned(layout, n, r)]
    assert nodes == list(range(n))
    # The default always has the node state in shared memory up to 10,000
    # nodes: the crossover lies below the block's limit.
    assert layout.state == "smem"
    static = WALK_STATIC_SMEM if cluster else QUEUE_BLOCK_STATIC_SMEM
    assert layout.smem_bytes == STATE_WORDS * 4 * layout.slice + static
    assert layout.smem_bytes <= SMEM_PER_BLOCK


def test_crossover_lies_inside_the_block_limit():
    assert 1 < QUEUE_CLUSTER_MIN_NODES <= BLOCK_SMEM_MAX + 1


def test_cluster_blocks_may_own_no_nodes():
    # n = 9: slice 2, so blocks 5-7 own nothing but still take part.
    layout = queue_layout(9, team="cluster")
    assert layout.slice == 2
    assert [len(_owned(layout, 9, r)) for r in range(8)] == [2, 2, 2, 2, 1, 0, 0, 0]


def test_block_smem_limit():
    assert BLOCK_SMEM_MAX == 7_248
    below = queue_layout(BLOCK_SMEM_MAX, team="block")
    assert below == QueueLayout("block", 1, BLOCK_SMEM_MAX, SMEM_PER_BLOCK, "smem")
    above = queue_layout(BLOCK_SMEM_MAX + 1, team="block")
    assert above == QueueLayout("block", 1, BLOCK_SMEM_MAX + 1,
                                QUEUE_BLOCK_STATIC_SMEM, "global")
    with pytest.raises(ValueError):
        queue_layout(BLOCK_SMEM_MAX + 1, team="block", state="smem")


def test_cluster_smem_limit():
    # 32 B x ceil(n / 8) + 400 B <= 232,448 B  <=>  n <= 58,008.
    assert queue_layout(58_008).state == "smem"
    assert queue_layout(58_008).team == "cluster"
    assert queue_layout(58_008).smem_bytes <= SMEM_PER_BLOCK
    assert queue_layout(58_009) == QueueLayout(
        "cluster", 8, 7_252, WALK_STATIC_SMEM, "global")
    with pytest.raises(ValueError):
        queue_layout(58_009, state="smem")
    with pytest.raises(ValueError):
        queue_layout(58_009, team="cluster", state="smem")


@pytest.mark.parametrize("team", ["block", "cluster"])
@pytest.mark.parametrize("n", [1, 9, 300, 10000])
def test_queue_layout_forced(team, n):
    # The global state is available to both teams at every n.
    forced = queue_layout(n, team=team, state="global")
    assert forced.team == team and forced.state == "global"
    assert forced.slice == -(-n // forced.k)
    assert forced.smem_bytes == (
        WALK_STATIC_SMEM if team == "cluster" else QUEUE_BLOCK_STATIC_SMEM)


def test_queue_layout_rejects():
    with pytest.raises(ValueError):
        queue_layout(0)
    with pytest.raises(ValueError):
        queue_layout(24, state="registers")
    with pytest.raises(ValueError):
        queue_layout(24, team="grid")


@pytest.mark.parametrize("groups", [1, 5])
@pytest.mark.parametrize("team,state", [("block", "smem"), ("block", "global"),
                                        ("cluster", "smem"), ("cluster", "global")])
def test_queue_scratch_words(groups, team, state):
    n, emax, num_zones = 1000, 32, 4
    layout = queue_layout(n, team=team, state=state)
    k = 8 if team == "cluster" else 1
    slice_ = 125 if team == "cluster" else 1000
    per_block = 2 * emax + 2 * num_zones + (
        STATE_WORDS * slice_ if state == "global" else 0)
    assert queue_scratch_words(layout, groups, emax, num_zones) == groups * k * per_block


@pytest.mark.parametrize("num_zones", [1, 6, 8, 17])
@pytest.mark.parametrize("team,state", [("block", "smem"), ("block", "global"),
                                        ("cluster", "smem"), ("cluster", "global")])
def test_queue_scratch_words_zone_lanes(num_zones, team, state):
    # The zone-parallel instantiation adds one slot row a zone lane:
    # min(num_zones, 8) rows of emax words a block.
    n, emax, groups = 1000, 32, 3
    layout = queue_layout(n, team=team, state=state, zone_lanes=True)
    assert layout.zone_lanes
    k = 8 if team == "cluster" else 1
    slice_ = 125 if team == "cluster" else 1000
    per_block = 2 * emax + 2 * num_zones + min(num_zones, ZONE_LANES) * emax + (
        STATE_WORDS * slice_ if state == "global" else 0)
    assert queue_scratch_words(layout, groups, emax, num_zones) == groups * k * per_block


@pytest.mark.parametrize("fill", ["tightly-pack", "distribute-evenly",
                                  "minimal-fragmentation"])
@pytest.mark.parametrize("n", [300, 5000, 10000])
def test_plain_strategies_keep_their_scratch(fill, n):
    # A plain strategy's launch: no lane rows, the layout and scratch the
    # queue kernel had before the zone-parallel instantiation.
    emax, num_zones = 8, 4
    layout = queue_layout(n, zone_lanes=strategy_params(fill)[1])
    assert layout == queue_layout(n) and not layout.zone_lanes
    static = WALK_STATIC_SMEM if layout.team == "cluster" else QUEUE_BLOCK_STATIC_SMEM
    assert layout.smem_bytes == STATE_WORDS * 4 * layout.slice + static
    assert queue_scratch_words(layout, 1, emax, num_zones) == layout.k * (
        2 * emax + 2 * num_zones)


@pytest.mark.parametrize("team", ["block", "cluster"])
def test_zone_lanes_smem_limit(team):
    # The lane buffers are static shared memory of the zone-parallel
    # instantiation: 2,384 B for a block, 3,408 B for a cluster, so its
    # node state leaves shared memory sooner (n up to 7,173 / 57,160).
    extra = QUEUE_BLOCK_LANE_SMEM if team == "block" else WALK_LANE_SMEM
    assert extra == (2_384 if team == "block" else 3_408)
    static = (QUEUE_BLOCK_STATIC_SMEM if team == "block" else WALK_STATIC_SMEM) + extra
    k = 1 if team == "block" else CLUSTER_BLOCKS
    last = k * ((SMEM_PER_BLOCK - static) // (STATE_WORDS * 4))
    assert last == (7_173 if team == "block" else 57_160)
    fit = queue_layout(last, team=team, zone_lanes=True)
    assert fit.state == "smem" and fit.smem_bytes <= SMEM_PER_BLOCK
    assert fit.smem_bytes == STATE_WORDS * 4 * fit.slice + static
    past = queue_layout(last + 1, team=team, zone_lanes=True)
    assert past == QueueLayout(team, k, -(-(last + 1) // k), static, "global", True)
    assert queue_layout(last + 1, team=team).state == "smem"
    with pytest.raises(ValueError):
        queue_layout(last + 1, team=team, state="smem", zone_lanes=True)
