"""The kernels' launch layout (ops/launch.py `kernel_layout`), on the CPU.

A queue runs on one team of threads: one block ("block", below
QUEUE_CLUSTER_MIN_NODES nodes) or one cluster of CLUSTER_BLOCKS blocks
("cluster"), where block r owns nodes [r * slice, min(n, (r + 1) * slice)).
A row-walk segment runs on the same cluster team. The node state (8 int32
words a node) lives in shared memory while a block's slice of it fits
beside the team's static buffers in the 232,448 bytes an H100 block may
use, and in global scratch past that. The strategy alone picks the
instantiation: the single-AZ ones run the zone-parallel one, whose lane
buffers take more shared memory and whose gang slots take more scratch.
"""

import inspect

import pytest

from spark_scheduler_tpu_torch.ops import fifo, window
from spark_scheduler_tpu_torch.ops.launch import (
    CLUSTER_BLOCKS,
    LANE_SMEM,
    QUEUE_CLUSTER_MIN_NODES,
    SMEM_PER_BLOCK,
    STATE_WORDS,
    STATIC_SMEM,
    ZONE_LANES,
    KernelLayout,
    gang_scratch_words,
    kernel_layout,
)

PLAIN = "tightly-pack"
LANES = "single-az-tightly-pack"  # a strategy of the zone-parallel instantiation
STRATEGIES = ("tightly-pack", "distribute-evenly", "minimal-fragmentation",
              "single-az-tightly-pack", "single-az-minimal-fragmentation",
              "az-aware-tightly-pack")
SINGLE_AZ = STRATEGIES[3:]

SIZES = [1, 9, 10, 500, 1000, QUEUE_CLUSTER_MIN_NODES - 1,
         QUEUE_CLUSTER_MIN_NODES, QUEUE_CLUSTER_MIN_NODES + 1, 10000]
# The largest n whose state fits a block's shared memory:
# 32 B x n + 512 B <= 232,448 B.
BLOCK_SMEM_MAX = (SMEM_PER_BLOCK - STATIC_SMEM["block"]) // (STATE_WORDS * 4)
WALK_SIZES = [1, 24, 300, 8191, 8192, 8193, 10000, 16384, 58000, 100000]


def _owned(layout: KernelLayout, n: int, r: int) -> range:
    lo = min(n, r * layout.slice)
    return range(lo, min(n, lo + layout.slice))


def _walk_smem_need(n: int) -> int:
    return STATE_WORDS * 4 * -(-n // CLUSTER_BLOCKS) + STATIC_SMEM["cluster"]


# -- the queue kernel's layouts ----------------------------------------------


@pytest.mark.parametrize("n", SIZES)
def test_queue_layout_default(n):
    layout = kernel_layout(n, PLAIN)
    cluster = n >= QUEUE_CLUSTER_MIN_NODES
    assert layout.team == ("cluster" if cluster else "block")
    assert layout.k == (CLUSTER_BLOCKS if cluster else 1)
    # The team's slices cover 0..n-1 exactly once, in order.
    nodes = [i for r in range(layout.k) for i in _owned(layout, n, r)]
    assert nodes == list(range(n))
    # The default always has the node state in shared memory up to 10,000
    # nodes: the crossover lies below the block's limit.
    assert layout.state == "smem"
    assert layout.smem_bytes == STATE_WORDS * 4 * layout.slice + STATIC_SMEM[layout.team]
    assert layout.smem_bytes <= SMEM_PER_BLOCK


def test_crossover_lies_inside_the_block_limit():
    assert 1 < QUEUE_CLUSTER_MIN_NODES <= BLOCK_SMEM_MAX + 1


def test_cluster_blocks_may_own_no_nodes():
    # n = 9: slice 2, so blocks 5-7 own nothing but still take part.
    layout = kernel_layout(9, PLAIN, team="cluster")
    assert layout.slice == 2
    assert [len(_owned(layout, 9, r)) for r in range(8)] == [2, 2, 2, 2, 1, 0, 0, 0]


def test_block_smem_limit():
    assert BLOCK_SMEM_MAX == 7_248
    below = kernel_layout(BLOCK_SMEM_MAX, PLAIN, team="block")
    assert below == KernelLayout("block", 1, BLOCK_SMEM_MAX, SMEM_PER_BLOCK,
                                 "smem", False)
    above = kernel_layout(BLOCK_SMEM_MAX + 1, PLAIN, team="block")
    assert above == KernelLayout("block", 1, BLOCK_SMEM_MAX + 1,
                                 STATIC_SMEM["block"], "global", False)
    with pytest.raises(ValueError):
        kernel_layout(BLOCK_SMEM_MAX + 1, PLAIN, team="block", state="smem")


def test_cluster_smem_limit():
    # 32 B x ceil(n / 8) + 400 B <= 232,448 B  <=>  n <= 58,008.
    assert kernel_layout(58_008, PLAIN).state == "smem"
    assert kernel_layout(58_008, PLAIN).team == "cluster"
    assert kernel_layout(58_008, PLAIN).smem_bytes <= SMEM_PER_BLOCK
    assert kernel_layout(58_009, PLAIN) == KernelLayout(
        "cluster", 8, 7_252, STATIC_SMEM["cluster"], "global", False)
    with pytest.raises(ValueError):
        kernel_layout(58_009, PLAIN, state="smem")
    with pytest.raises(ValueError):
        kernel_layout(58_009, PLAIN, team="cluster", state="smem")


@pytest.mark.parametrize("team", ["block", "cluster"])
@pytest.mark.parametrize("n", [1, 9, 300, 10000])
def test_queue_layout_forced(team, n):
    # The global state is available to both teams at every n.
    forced = kernel_layout(n, PLAIN, team=team, state="global")
    assert forced.team == team and forced.state == "global"
    assert forced.slice == -(-n // forced.k)
    assert forced.smem_bytes == STATIC_SMEM[team]


def test_queue_layout_rejects():
    with pytest.raises(ValueError):
        kernel_layout(0, PLAIN)
    with pytest.raises(ValueError):
        kernel_layout(24, PLAIN, state="registers")
    with pytest.raises(ValueError):
        kernel_layout(24, PLAIN, team="grid")
    with pytest.raises(ValueError):
        kernel_layout(24, "first-fit")


@pytest.mark.parametrize("groups", [1, 5])
@pytest.mark.parametrize("team,state", [("block", "smem"), ("block", "global"),
                                        ("cluster", "smem"), ("cluster", "global")])
def test_queue_scratch_words(groups, team, state):
    n, emax, num_zones = 1000, 32, 4
    layout = kernel_layout(n, PLAIN, team=team, state=state)
    k = 8 if team == "cluster" else 1
    slice_ = 125 if team == "cluster" else 1000
    per_block = 2 * emax + 2 * num_zones + (
        STATE_WORDS * slice_ if state == "global" else 0)
    assert gang_scratch_words(layout, groups, emax, num_zones) == groups * k * per_block


@pytest.mark.parametrize("num_zones", [1, 6, 8, 17])
@pytest.mark.parametrize("team,state", [("block", "smem"), ("block", "global"),
                                        ("cluster", "smem"), ("cluster", "global")])
def test_queue_scratch_words_zone_lanes(num_zones, team, state):
    # The zone-parallel instantiation adds one slot row a zone lane:
    # min(num_zones, 8) rows of emax words a block.
    n, emax, groups = 1000, 32, 3
    layout = kernel_layout(n, LANES, team=team, state=state)
    assert layout.zone_lanes
    k = 8 if team == "cluster" else 1
    slice_ = 125 if team == "cluster" else 1000
    per_block = 2 * emax + 2 * num_zones + min(num_zones, ZONE_LANES) * emax + (
        STATE_WORDS * slice_ if state == "global" else 0)
    assert gang_scratch_words(layout, groups, emax, num_zones) == groups * k * per_block


@pytest.mark.parametrize("fill", ["tightly-pack", "distribute-evenly",
                                  "minimal-fragmentation"])
@pytest.mark.parametrize("n", [300, 5000, 10000])
def test_plain_strategies_keep_their_scratch(fill, n):
    # A plain strategy's launch: no lane rows, the layout and scratch the
    # queue kernel had before the zone-parallel instantiation.
    emax, num_zones = 8, 4
    layout = kernel_layout(n, fill)
    assert layout == kernel_layout(n, PLAIN) and not layout.zone_lanes
    assert layout.smem_bytes == STATE_WORDS * 4 * layout.slice + STATIC_SMEM[layout.team]
    assert gang_scratch_words(layout, 1, emax, num_zones) == layout.k * (
        2 * emax + 2 * num_zones)


@pytest.mark.parametrize("team", ["block", "cluster"])
def test_zone_lanes_smem_limit(team):
    # The lane buffers are static shared memory of the zone-parallel
    # instantiation: 2,384 B for a block, 3,408 B for a cluster, so its
    # node state leaves shared memory sooner (n up to 7,173 / 57,160).
    extra = LANE_SMEM[team]
    assert extra == (2_384 if team == "block" else 3_408)
    static = STATIC_SMEM[team] + extra
    k = 1 if team == "block" else CLUSTER_BLOCKS
    last = k * ((SMEM_PER_BLOCK - static) // (STATE_WORDS * 4))
    assert last == (7_173 if team == "block" else 57_160)
    fit = kernel_layout(last, LANES, team=team)
    assert fit.state == "smem" and fit.smem_bytes <= SMEM_PER_BLOCK
    assert fit.smem_bytes == STATE_WORDS * 4 * fit.slice + static
    past = kernel_layout(last + 1, LANES, team=team)
    assert past == KernelLayout(team, k, -(-(last + 1) // k), static, "global", True)
    assert kernel_layout(last + 1, PLAIN, team=team).state == "smem"
    with pytest.raises(ValueError):
        kernel_layout(last + 1, LANES, team=team, state="smem")


# -- the row walk's layouts: the cluster team --------------------------------


@pytest.mark.parametrize("n", WALK_SIZES)
def test_walk_layout(n):
    layout = kernel_layout(n, PLAIN, team="cluster")
    assert layout.k == CLUSTER_BLOCKS == 8
    # The K slices cover 0..n-1 exactly once, in order.
    nodes = [i for r in range(layout.k) for i in _owned(layout, n, r)]
    assert nodes == list(range(n))
    assert layout.smem_bytes <= SMEM_PER_BLOCK
    # Shared memory exactly while the state fits, global past that.
    fits = _walk_smem_need(n) <= SMEM_PER_BLOCK
    assert layout.state == ("smem" if fits else "global")
    if fits:
        assert layout.smem_bytes == _walk_smem_need(n)
    else:
        assert layout.smem_bytes == STATIC_SMEM["cluster"]
    # The global layout is available at every n (tests force it).
    forced = kernel_layout(n, PLAIN, team="cluster", state="global")
    assert forced.slice == layout.slice and forced.k == layout.k
    assert forced.smem_bytes == STATIC_SMEM["cluster"]


def test_walk_layout_switches_exactly_past_the_limit():
    # 32 B x slice + 400 B <= 232,448 B  <=>  slice <= 7,251.
    last = 8 * ((SMEM_PER_BLOCK - STATIC_SMEM["cluster"]) // (STATE_WORDS * 4))
    assert last == 58_008
    assert kernel_layout(last, PLAIN, team="cluster").state == "smem"
    assert kernel_layout(last, PLAIN, team="cluster").smem_bytes <= SMEM_PER_BLOCK
    assert kernel_layout(last + 1, PLAIN, team="cluster").state == "global"
    with pytest.raises(ValueError):
        kernel_layout(last + 1, PLAIN, team="cluster", state="smem")
    with pytest.raises(ValueError):
        kernel_layout(0, PLAIN, team="cluster")
    with pytest.raises(ValueError):
        kernel_layout(24, PLAIN, team="cluster", state="registers")


@pytest.mark.parametrize("state", ["smem", "global"])
def test_walk_scratch_words(state):
    layout = kernel_layout(16384, PLAIN, team="cluster", state=state)
    per_block = 2 * 32 + 2 * 4 + (STATE_WORDS * 2048 if state == "global" else 0)
    assert gang_scratch_words(layout, 1, 32, 4) == 8 * per_block


@pytest.mark.parametrize("num_zones", [1, 6, 8, 17])
@pytest.mark.parametrize("state", ["smem", "global"])
def test_walk_scratch_words_zone_lanes(num_zones, state):
    # The single-AZ strategies' zone-parallel instantiation adds one slot
    # row a zone lane, min(num_zones, 8) rows of emax words a block; a
    # plain strategy's launch keeps the scratch it had.
    layout = kernel_layout(16384, LANES, team="cluster", state=state)
    plain = kernel_layout(16384, PLAIN, team="cluster", state=state)
    assert layout.zone_lanes and not plain.zone_lanes
    base = 2 * 32 + 2 * num_zones + (STATE_WORDS * 2048 if state == "global" else 0)
    assert gang_scratch_words(plain, 1, 32, num_zones) == 8 * base
    assert gang_scratch_words(layout, 1, 32, num_zones) == 8 * (
        base + min(num_zones, ZONE_LANES) * 32)


def test_zone_lanes_walk_layout():
    # The lane buffers (3,408 B of static shared memory a block) move the
    # zone-parallel instantiation's switch to global state to n = 57,160.
    assert LANE_SMEM["cluster"] == 3_408
    static = STATIC_SMEM["cluster"] + LANE_SMEM["cluster"]
    last = 8 * ((SMEM_PER_BLOCK - static) // (STATE_WORDS * 4))
    assert last == 57_160
    fit = kernel_layout(last, LANES, team="cluster")
    assert fit.state == "smem"
    assert fit.smem_bytes == STATE_WORDS * 4 * fit.slice + static <= SMEM_PER_BLOCK
    assert kernel_layout(last + 1, LANES, team="cluster") == KernelLayout(
        "cluster", 8, -(-(last + 1) // 8), static, "global", True)
    assert kernel_layout(last + 1, PLAIN, team="cluster").state == "smem"
    with pytest.raises(ValueError):
        kernel_layout(last + 1, LANES, team="cluster", state="smem")


# -- the instantiation -------------------------------------------------------


@pytest.mark.parametrize("fill", STRATEGIES)
def test_instantiation_follows_the_fill(fill):
    """Whatever team and node-state place a caller forces, the strategy
    alone picks the instantiation, and its lane buffers are in the shared
    memory the layout counts; the wrappers take a forced team and state,
    never a layout of their own."""
    lanes = fill in SINGLE_AZ
    for n in (300, 5000):
        for team in (None, "block", "cluster"):
            for state in (None, "smem", "global"):
                lay = kernel_layout(n, fill, team=team, state=state)
                assert lay.zone_lanes == lanes
                static = STATIC_SMEM[lay.team] + (LANE_SMEM[lay.team] if lanes else 0)
                state_bytes = STATE_WORDS * 4 * lay.slice if lay.state == "smem" else 0
                assert lay.smem_bytes == static + state_bytes
    for fn, forced in ((fifo.fifo_queue, {"team", "state"}),
                       (fifo.fifo_kernel_info, {"team", "state"}),
                       (window.window_pack, {"state"}),
                       (window.window_kernel_info, {"state"})):
        params = set(inspect.signature(fn).parameters)
        assert forced <= params and not {"layout", "zone_lanes"} & params, fn
