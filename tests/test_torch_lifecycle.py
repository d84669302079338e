"""The lifetime of the port's pooled part solves, each case in a child
process under a timeout (the port only: no JAX twin has these routes).

A pooled window's part solve runs on a daemon worker of the shared solve
pool (core/device_pool.py). Every route that ends or abandons a pooled
dispatch waits for its part solves, and interpreter exit waits up to
`PART_WAIT_S` for the ones still running: the interpreter ends a daemon
thread still inside a torch op with a forced unwind through C++ frames,
which aborts the process ("terminate called without an active exception").

  - A pooled window abandoned by a shed (the next dispatch faults under
    the shed policy), then an immediate exit while its part solve runs
    torch ops: rc 0, nothing on stderr about terminate.
  - close() with a slow part solve (its engine wrapped to sleep 0.5 s)
    returns only after the part ended, with every slot's in-flight count
    at 0 and no future of the solver left.
  - The greedy route waits the same way: a window on a carry an
    escalation dropped, whose scale-tier re-solve faults under the greedy
    policy, is answered only after its slow part solve ended.
  - A part solve stuck for 60 s holds exit for PART_WAIT_S, no longer.

The mesh slot is one (1, 4) mesh on `cpu` (four shards on the host).
"""

from __future__ import annotations

import subprocess
import sys
import textwrap
import time
from pathlib import Path

from spark_scheduler_tpu_torch.core.device_pool import PART_WAIT_S

REPO = Path(__file__).resolve().parent.parent

# The child's common part: a 128-node cluster, seeded windows of the kind
# tests/test_torch_scale_tier.py escalates, and wrappers that run `slow()`
# in each part solve on a worker of the solve pool: before its engine
# (`slowed`) or after its committed base is published (`slowed_pull`).
PRELUDE = '''
import sys, threading, time
import numpy as np
import torch
torch.set_num_threads(2)
from spark_scheduler_tpu_torch.core import solver as sm
from spark_scheduler_tpu_torch.core.device_pool import on_solve_worker
from spark_scheduler_tpu_torch.faults.degraded import DegradedModeController
from spark_scheduler_tpu_torch.faults.errors import CudaDeviceFault
from spark_scheduler_tpu_torch.models.kube import Node, ZONE_LABEL
from spark_scheduler_tpu_torch.models.resources import Resources

NODES = [
    Node(name=f"n{i:03d}",
         allocatable=Resources.from_quantities("8", "8Gi", "1", round_up=False),
         labels={ZONE_LABEL: f"z{i % 3}"})
    for i in range(128)
]
NAMES = [n.name for n in NODES]
ONE = Resources.from_quantities("1", "1Gi")


def windows(seed, n=6, per=4):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        reqs = []
        for _ in range(per):
            rows = [("1", int(rng.integers(1, 3)), bool(rng.random() < 0.5))
                    for _ in range(int(rng.integers(0, 3)))]
            size = "2" if rng.random() < 0.3 else "1"
            rows.append((size, int(rng.integers(1, 4)), False))
            reqs.append(sm.WindowRequest(
                rows=[(Resources.from_quantities(c, f"{c}Gi"), ONE, k, s)
                      for c, k, s in rows],
                driver_candidate_names=NAMES,
            ))
        out.append(reqs)
    return out


def mesh_solver(**kw):
    return sm.PlacementSolver(device="cpu", use_native=False, mesh=(1, 4),
                              pool_devices=["cpu"] * 4, **kw)


ENDS = []
STARTED = threading.Event()
real_engine = sm.node_sharded_fifo_pack


def slowed(slow):
    def engine(*a, **k):
        if on_solve_worker():
            STARTED.set()
            try:
                slow()
                return real_engine(*a, **k)
            finally:
                ENDS.append(time.monotonic())
        return real_engine(*a, **k)
    sm.node_sharded_fifo_pack = engine


real_rows = sm.PlacementSolver._blob_rows


def slowed_pull(slow):
    """`slow()` after the part's committed base is published (the next
    build no longer waits for the part), before its decisions are read."""
    def rows(*a, **k):
        STARTED.set()
        try:
            slow()
            return real_rows(*a, **k)
        finally:
            ENDS.append(time.monotonic())
    sm.PlacementSolver._blob_rows = staticmethod(rows)


def torch_busy(seconds):
    x = torch.ones(768, 768)
    end = time.monotonic() + seconds
    while time.monotonic() < end:
        x = (x @ x).clamp_(max=1.0)
'''


def run_child(body: str, timeout: float = 120.0):
    return subprocess.run(
        [sys.executable, "-c", PRELUDE + textwrap.dedent(body)], cwd=REPO,
        capture_output=True, text=True, timeout=timeout,
    )


def check_clean_exit(proc) -> None:
    assert proc.returncode == 0, (proc.returncode, proc.stderr[-3000:])
    assert "terminate called" not in proc.stderr, proc.stderr[-3000:]


def test_a_window_abandoned_by_a_shed_then_exit_exits_0():
    proc = run_child('''
        from spark_scheduler_tpu_torch.faults.errors import (
            DegradedUnavailableError,
        )
        slowed_pull(lambda: torch_busy(3.0))
        hits = []
        real_shim = sm._shim

        def shim(kind):
            # The second window's upload faults on the dispatcher thread.
            if kind == "h2d" and not on_solve_worker():
                hits.append(kind)
                if len(hits) == 2:
                    raise CudaDeviceFault(214, "uncorrectable ECC error")
            real_shim(kind)

        sm._shim = shim
        solver = mesh_solver()
        solver.degraded = DegradedModeController(policy="shed")
        w1, w2 = windows(3, n=2)
        t = solver.build_tensors_pipelined(NODES, {}, {})
        solver.pack_window_dispatch("tightly-pack", t, w1)
        assert STARTED.wait(60)
        t = solver.build_tensors_pipelined(NODES, {}, {})
        try:
            solver.pack_window_dispatch("tightly-pack", t, w2)
        except DegradedUnavailableError:
            print("shed")
        assert not ENDS, "the first window's part ended before the exit"
    ''')
    check_clean_exit(proc)
    assert "shed" in proc.stdout


def test_close_returns_after_a_running_part_solve_ended():
    proc = run_child('''
        slowed(lambda: time.sleep(0.5))
        solver = mesh_solver()
        t = solver.build_tensors_pipelined(NODES, {}, {})
        solver.pack_window_dispatch("tightly-pack", t, windows(5, n=1)[0])
        assert STARTED.wait(60)
        futures = list(solver._inflight_futures)
        assert futures and not ENDS
        solver.close()
        closed = time.monotonic()
        assert len(ENDS) == 1 and ENDS[0] <= closed, (ENDS, closed)
        assert all(f.done() for f in futures)
        assert not solver._inflight_futures
        assert [s.inflight for s in solver._pool.slots] == [0]
        print("closed")
    ''')
    check_clean_exit(proc)
    assert "closed" in proc.stdout


def test_the_greedy_route_returns_after_its_part_solves_ended():
    proc = run_child('''
        slowed(lambda: time.sleep(0.5))
        inside = threading.local()
        real_tier = sm.PlacementSolver._scale_tier_decisions
        engine = sm.node_sharded_fifo_pack

        def tier(self, *a, **k):
            inside.on = True
            try:
                return real_tier(self, *a, **k)
            finally:
                inside.on = False

        def faulting(*a, **k):
            if getattr(inside, "on", False):
                raise CudaDeviceFault(214, "uncorrectable ECC error")
            return engine(*a, **k)

        sm.PlacementSolver._scale_tier_decisions = tier
        sm.node_sharded_fifo_pack = faulting
        solver = mesh_solver(scale_tier=True, prune_top_k=1, prune_slack=0.01)
        solver.degraded = DegradedModeController(policy="greedy")
        wins = windows(9)
        greedy = 0
        for k in range(0, len(wins), 2):
            handles = []
            for w in wins[k:k + 2]:
                t = solver.build_tensors_pipelined(NODES, {}, {})
                handles.append(solver.pack_window_dispatch("tightly-pack", t, w))
            for h in handles:
                was_pooled = h.parts is not None
                solver.pack_window_fetch(h)
                fetched = time.monotonic()
                if was_pooled and h.greedy:
                    greedy += 1
                    assert h.parts is None
                    assert ENDS and max(ENDS) <= fetched, (ENDS, fetched)
        assert greedy > 0, greedy
        assert solver.scale_tier_stats["fallbacks"] > 0
        assert [s.inflight for s in solver._pool.slots] == [0]
        solver.close()
        print("greedy", greedy)
    ''')
    check_clean_exit(proc)
    assert "greedy" in proc.stdout


def test_a_stuck_part_solve_holds_exit_no_longer_than_the_bound():
    proc = run_child('''
        slowed(lambda: time.sleep(60))
        solver = mesh_solver()
        t = solver.build_tensors_pipelined(NODES, {}, {})
        solver.pack_window_dispatch("tightly-pack", t, windows(5, n=1)[0])
        assert STARTED.wait(60)
        print("exiting", time.time(), flush=True)
    ''')
    ended = time.time()
    assert proc.returncode == 0, (proc.returncode, proc.stderr[-3000:])
    exiting = float(proc.stdout.split("exiting")[1].split()[0])
    # The exit waits the bound out (the part never ends), then goes on
    # without it; 5 s covers the interpreter's own teardown.
    assert PART_WAIT_S - 0.5 <= ended - exiting <= PART_WAIT_S + 5.0, (
        ended - exiting
    )
