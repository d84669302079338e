"""The solo solve: the port's `PlacementSolver(device="cpu").pack` (one live
row of the window solve) against the JAX package's
`PlacementSolver(use_native=False).pack` (the closed-form fills), on
tests/test_packing_golden.py's random clusters, for all six strategies and
for the extender's executor-reschedule call (no driver, one executor,
tightly-pack).

Tolerance: none. Driver name, executor names (and so the padding: only
placed slots are named), `has_capacity` and the four efficiencies must be
equal. The single-AZ zone score is summed in float64 by the port against
the JAX package's float32 (a recorded deviation); no case here hits a tie
that the two sums break differently.
"""

import numpy as np
import pytest
import torch

from spark_scheduler_tpu.core.solver import PlacementSolver as JaxSolver
from spark_scheduler_tpu.models.resources import Resources as JaxResources
from spark_scheduler_tpu_torch.core.solver import PlacementSolver
from spark_scheduler_tpu_torch.models.cluster import cluster_from_numpy
from spark_scheduler_tpu_torch.models.resources import Resources
from tests.test_packing_golden import random_cluster

STRATEGIES = (
    "tightly-pack",
    "distribute-evenly",
    "minimal-fragmentation",
    "single-az-tightly-pack",
    "single-az-minimal-fragmentation",
    "az-aware-tightly-pack",
)
N = 17  # one node count for every case: the JAX solve compiles once per fill
NUM_ZONES = 4
TRIALS = 40


def _solvers():
    """A JAX and a port solver whose registries hold the same node names and
    zones (so node indices, names and the zone bucket agree)."""
    jax_solver = JaxSolver(use_native=False)
    port = PlacementSolver(device="cpu")
    for s in (jax_solver, port):
        for i in range(N):
            s.registry.intern(f"node-{i:02d}")
        for z in range(NUM_ZONES):
            s.registry.zone_id(f"zone-{z}")
    return jax_solver, port


def _res(cls, arr):
    """Resources of `cls` with the raw quantities in `arr` (cpu milli, mem
    KiB, gpu milli) — the same integers on both sides."""
    return cls(int(arr[0]), int(arr[1]), int(arr[2]))


def _assert_same(got, want, ctx):
    assert got.has_capacity == want.has_capacity, ctx
    assert got.driver_node == want.driver_node, ctx
    assert got.executor_nodes == want.executor_nodes, ctx
    for f in ("efficiency_max", "efficiency_cpu", "efficiency_memory",
              "efficiency_gpu"):
        assert getattr(got, f) == getattr(want, f), (ctx, f)


def _cases(rng, count_hi):
    for trial in range(TRIALS):
        c = random_cluster(rng, N, with_labels=trial % 3 == 0)
        driver_req = rng.integers(0, 12, size=3).astype(np.int32)
        exec_req = rng.integers(0, 10, size=3).astype(np.int32)
        # GPUs are scarce (0-2 a node): ask for at most one, so that the
        # cases fit as well as fail.
        driver_req[2] = rng.integers(0, 2)
        exec_req[2] = rng.integers(0, 2)
        if trial % 7 == 0:
            exec_req[:] = 0  # zero-request edge: unbounded capacity
        count = int(rng.integers(0, count_hi + 1))
        driver_mask = rng.random(N) < 0.7
        domain = rng.random(N) < 0.9
        yield trial, c, driver_req, exec_req, count, driver_mask, domain


def _pack_both(jax_solver, port, strategy, c, driver_req, exec_req, count,
               driver_mask, domain):
    names = [f"node-{i:02d}" for i in np.flatnonzero(driver_mask)]
    tensors = cluster_from_numpy(
        [np.asarray(getattr(c, f)) for f in c.__dataclass_fields__], "cpu"
    )
    avail_before = tensors.available.clone()
    got = port.pack(
        strategy, tensors, _res(Resources, driver_req), _res(Resources, exec_req),
        count, names, domain_mask=domain,
    )
    # The solo solve reads the availability and never writes it.
    assert torch.equal(tensors.available, avail_before)
    want = jax_solver.pack(
        strategy, c, _res(JaxResources, driver_req),
        _res(JaxResources, exec_req), count, names, domain_mask=domain,
    )
    return got, want


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_pack_matches_jax(strategy):
    jax_solver, port = _solvers()
    rng = np.random.default_rng(STRATEGIES.index(strategy))
    fits = 0
    for trial, *case in _cases(rng, 8):
        got, want = _pack_both(jax_solver, port, strategy, *case)
        _assert_same(got, want, (strategy, trial))
        if not got.has_capacity:
            # Infeasible: no driver, no executor slot named.
            assert got.driver_node is None and got.executor_nodes == []
        fits += got.has_capacity
    assert 0 < fits < TRIALS  # both outcomes were exercised
    assert port.last_solve_info == {"path": "reference", "nodes": N, "emax": 8}


def test_pack_driverless_one_executor_matches_jax():
    """The extender's executor reschedule (core/extender.py
    `_reschedule_executor`): zero driver request, one executor,
    tightly-pack, the candidates equal to the domain."""
    jax_solver, port = _solvers()
    rng = np.random.default_rng(7)
    placed = 0
    for trial in range(TRIALS):
        c = random_cluster(rng, N)
        exec_req = rng.integers(0, 30, size=3).astype(np.int32)
        exec_req[2] = rng.integers(0, 2)
        domain = rng.random(N) < 0.6
        got, want = _pack_both(
            jax_solver, port, "tightly-pack", c, np.zeros(3, np.int32),
            exec_req, 1, domain, domain,
        )
        _assert_same(got, want, trial)
        placed += bool(got.executor_nodes)
    assert 0 < placed < TRIALS


def test_pack_wider_gang_pads_to_the_next_emax_bucket():
    """Counts 9-16 take emax 16: the executor slots past the count stay
    unnamed on both sides."""
    jax_solver, port = _solvers()
    rng = np.random.default_rng(11)
    for trial, c, dreq, ereq, count, dmask, dom in _cases(rng, 16):
        count = max(count, 9)
        got, want = _pack_both(
            jax_solver, port, "tightly-pack", c, dreq, ereq, count, dmask, dom
        )
        _assert_same(got, want, trial)
        assert len(got.executor_nodes) in (0, count)
