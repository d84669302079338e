"""The launch shape of the port's two kernels, decided in one place.

Both hand-written kernels run the gang step of csrc/gang_solve.cuh on a
TEAM of threads: the queue kernel (csrc/fifo_kernel.cu, ops/fifo.py) one
team a queue, a block or a thread-block cluster by node count; the row walk
(csrc/window_kernel.cu, ops/window.py) one cluster a segment, the same
cluster team. `kernel_layout` picks the team, where the node state lives
and which instantiation runs (the zone-parallel one for the single-AZ
strategies, from the strategy alone); `gang_scratch_words` sizes a launch's
global scratch; `KernelLibrary` loads a kernel library with its entry
points typed and turns the CUDA error codes they return into exceptions;
`count_launch` keeps the wrappers' launch counts.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import torch

from spark_scheduler_tpu_torch.faults.errors import cuda_launch_error
from spark_scheduler_tpu_torch.ops.gang import strategy_params

CLUSTER_BLOCKS = 8  # kGsCluster: the largest portable cluster on Hopper
SMEM_PER_BLOCK = 232_448  # shared memory one H100 block may opt into
STATE_WORDS = 8  # int32 words of mutable state per node
# The single-AZ strategies run the zone-parallel instantiation
# (csrc/gang_solve.cuh `gs_gang_solve_lanes`): its reductions carry
# ZONE_LANES lanes, one a zone, and its gang slots take one row a lane.
ZONE_LANES = 8  # kGsLanes
# A team's lane buffers, in 8-byte words (gang_solve.cuh kGsLaneWords):
# three rotating accumulators of ZONE_LANES, the zone scores' warp partials
# (ZONE_LANES rows of 33), two int arrays of ZONE_LANES and the best zone
# so far (4 ints).
LANE_WORDS = 3 * ZONE_LANES + ZONE_LANES * 33 + ZONE_LANES + 2
# Static shared memory a block of each team: the block's two alternating
# buffers of 32 8-byte warp partials; the cluster's reduction buffers and
# mbarriers, (32 + 2 x 8 + 2) x 8 B.
STATIC_SMEM = {"block": 2 * 32 * 8, "cluster": 400}
# The zone-parallel instantiation's lane buffers beside them: LANE_WORDS,
# and for the cluster two rows of CLUSTER_BLOCKS x ZONE_LANES block
# partials (kGsClusterLaneWords).
LANE_SMEM = {"block": LANE_WORDS * 8,
             "cluster": (LANE_WORDS + 2 * CLUSTER_BLOCKS * ZONE_LANES) * 8}
# The team codes the kernels' C entry points take.
TEAM_CODES = {"block": 0, "cluster": 1}
# From this node count on, a queue runs on a cluster of CLUSTER_BLOCKS
# blocks, below it on one block. chip_smoke.py phase 4's crossover sweep
# (100 tightly-pack apps, both teams with the node state in shared memory,
# NVIDIA H100 80GB HBM3 at 700 W): the block was faster at 1,000 nodes (431
# against 481 us), the cluster from 1,250 on (480 against 509 us); at
# 10,000 nodes, where the block's state no longer fits in shared memory,
# 3.4x faster than the block (PERF.md).
QUEUE_CLUSTER_MIN_NODES = 1_250


class KernelLayout(NamedTuple):
    """Launch shape of a kernel for one node count and strategy."""

    team: str  # "block": one block a queue; "cluster": one cluster a queue or segment
    k: int  # blocks a team
    slice: int  # nodes a block owns, ceil(n / k)
    smem_bytes: int  # shared memory a block, static + dynamic
    state: str  # "smem": node state in shared memory; "global": in scratch
    zone_lanes: bool  # the zone-parallel (single-AZ) instantiation


def kernel_layout(
    n: int, fill: str, *, team: str | None = None, state: str | None = None
) -> KernelLayout:
    """The layout for `n` nodes under strategy `fill`: one block a queue
    below QUEUE_CLUSTER_MIN_NODES nodes, one cluster from there on (the row
    walk always asks for "cluster"); the node state (8 words a node) in
    shared memory where a block's slice of it fits beside the static
    buffers (n up to 7,248 for a block, 58,008 for a cluster), else in
    global scratch. The single-AZ strategies run the zone-parallel
    instantiation, whose lane buffers take LANE_SMEM more (n up to 7,173
    and 57,160); the strategy alone decides it. `team` and `state` force a
    layout (the row walk, tests and chip_smoke.py); a forced "smem" that
    does not fit raises."""
    zone_lanes = strategy_params(fill)[1]
    if n < 1:
        raise ValueError(f"kernel_layout needs n >= 1, got {n}")
    if team is None:
        team = "cluster" if n >= QUEUE_CLUSTER_MIN_NODES else "block"
    if team not in TEAM_CODES:
        raise ValueError(f"no {team!r} team")
    k = CLUSTER_BLOCKS if team == "cluster" else 1
    static = STATIC_SMEM[team] + (LANE_SMEM[team] if zone_lanes else 0)
    sl = -(-n // k)
    smem = STATE_WORDS * 4 * sl + static
    fits = smem <= SMEM_PER_BLOCK
    if state is None:
        state = "smem" if fits else "global"
    if state not in ("smem", "global") or (state == "smem" and not fits):
        raise ValueError(f"no {team!r}/{state!r} layout for n={n}")
    return KernelLayout(team, k, sl, smem if state == "smem" else static,
                        state, zone_lanes)


def gang_scratch_words(
    layout: KernelLayout, teams: int, emax: int, num_zones: int
) -> int:
    """Global scratch of one launch of `teams` teams of `layout`: per block,
    the gang's two slot buffers and the zone facts, with one slot row a
    zone lane in the zone-parallel instantiation, min(num_zones,
    ZONE_LANES) rows (gang_solve.cuh `gs_extra_words`), plus the node state
    in the global layout."""
    lanes = min(num_zones, ZONE_LANES) if layout.zone_lanes else 0
    per_block = (2 + lanes) * emax + 2 * num_zones
    if layout.state == "global":
        per_block += STATE_WORDS * layout.slice
    return teams * layout.k * per_block


def device_index(device) -> int:
    """The CUDA device index of `device` (None: the current device)."""
    if device is None:
        return torch.cuda.current_device()
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"kernel queries need a CUDA device, got {device}")
    return torch.cuda.current_device() if device.index is None else device.index


class KernelLibrary:
    """A kernel library of csrc/, built and loaded at first use, its entry
    points typed once. Every entry point returns a CUDA error code (0 on
    success), which `<prefix>_error` turns into its message."""

    def __init__(self, name: str, prefix: str, entries: dict):
        self.name = name  # csrc/<name>.cu
        self.prefix = prefix
        self.entries = entries  # {entry point: argtypes}
        self._lib = None
        self._lock = threading.Lock()

    def lib(self) -> ctypes.CDLL:
        """The loaded library (tests put a fake in its place)."""
        if self._lib is None:
            from spark_scheduler_tpu_torch.ops._build import load_library

            with self._lock:
                if self._lib is None:
                    lib = load_library(self.name)
                    for entry, argtypes in self.entries.items():
                        fn = getattr(lib, entry)
                        fn.argtypes = argtypes
                        fn.restype = ctypes.c_int
                    error = getattr(lib, f"{self.prefix}_error")
                    error.argtypes = [ctypes.c_int]
                    error.restype = ctypes.c_char_p
                    self._lib = lib
        return self._lib

    def call(self, entry: str, what: str, *args) -> None:
        """Call `entry`; raise the CUDA error it returns
        (faults/errors.cuda_launch_error)."""
        lib = self.lib()
        err = getattr(lib, entry)(*args)
        if err != 0:
            raise cuda_launch_error(
                err, what, getattr(lib, f"{self.prefix}_error")(err).decode()
            )

    def info(self, device, *args) -> dict:
        """What a card (`device`, default the current one) reports for one
        instantiation (`<prefix>_info`): registers and local (spill) bytes
        a thread, static shared bytes a block, and how many teams can be
        resident at once (0: the launch cannot run)."""
        out = (ctypes.c_int * 4)()
        self.call(f"{self.prefix}_info", f"{self.name} query",
                  device_index(device), *args, out)
        return dict(regs=out[0], local_bytes=out[1], static_smem=out[2],
                    max_active_teams=out[3])


# Several solvers (HA replicas, a standby beside its leader, the pool's
# slots) launch from threads of their own: every count's read-modify-write
# takes this lock.
_count_lock = threading.Lock()


def count_launch(wrapper, zone_parallel: bool = False) -> None:
    """Count one launch in `wrapper.launches`, and in
    `wrapper.zone_parallel_launches` when it ran the zone-parallel
    instantiation."""
    with _count_lock:
        wrapper.launches += 1
        if zone_parallel:
            wrapper.zone_parallel_launches += 1
