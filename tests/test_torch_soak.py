"""The port's randomized invariant soak against the JAX package's.

The twins of tests/test_invariant_soak.py and tests/test_elastic_soak.py.
One seed drives `Soak` in each package, the port's on `device="cpu"`; the
engine itself asserts its invariants as it goes (no over-commit, every
admitted gang holds exactly its reservation, the drained availability
mirror equals the host truth, retries never double-book, the flight
recorder agrees with every placement; elastic: no reserved node drained).

Held equal across the packages, with no tolerance, for the three strategy
families: the op counts, the number of apps submitted, the admitted map
(driver node and bound executors per app) and every reservation's spec.
The steps are fewer than the JAX suites' (200 against 666 a strategy), and
200 is the first step that runs the in-loop drained-mirror check.

The elastic mode runs on a `SoakClock`: real elapsed time plus simulated
jumps, so whether a node crosses the drainer's idle TTL can depend on the
host's speed. Its cases hold each package to the counts the JAX test
asserts, not to each other.
"""

from __future__ import annotations

import importlib
import itertools

import numpy as np
import pytest

from tests.test_torch_native import load_jax_native

JAX = "spark_scheduler_tpu"
PORT = "spark_scheduler_tpu_torch"
STRATEGIES = ("tightly-pack", "az-aware-tightly-pack", "single-az-tightly-pack")


def soak_mod(root):
    """One package's soak module, its pod counters restarted so both
    packages stamp the same pods."""
    if root == JAX:
        load_jax_native()
    importlib.import_module(f"{root}.testing.harness")._ts = itertools.count(1)
    importlib.import_module(f"{root}.models.kube")._uid_counter = (
        itertools.count(1)
    )
    return importlib.import_module(f"{root}.testing.soak")


def dev(root):
    return {"device": "cpu"} if root == PORT else {}


def outcome(soak):
    """What the soak left behind, in comparable form."""
    admitted = {
        app_id: (e["node"], tuple(sorted(e["bound"].items())), e["min"])
        for app_id, e in soak.admitted.items()
    }
    specs = {
        (rr.namespace, rr.name): {
            slot: (r.node, r.resources.as_tuple())
            for slot, r in rr.spec.reservations.items()
        }
        for rr in soak.h.app.rr_cache.list()
    }
    return {
        "op_counts": dict(soak.op_counts),
        "app_seq": soak.app_seq,
        "steps": soak.steps,
        "admitted": admitted,
        "specs": specs,
    }


def run_soak(root, strategy, steps, seed=20260731, n_nodes=12, **kw):
    soak = soak_mod(root).Soak(
        np.random.default_rng(seed), strategy, n_nodes=n_nodes, **kw,
        **dev(root)
    )
    try:
        soak.run(steps)
        return soak, outcome(soak)
    finally:
        soak.h.app.stop()


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_invariant_soak_matches_jax(strategy):
    _, jax_out = run_soak(JAX, strategy, 200)
    soak, port_out = run_soak(PORT, strategy, 200)
    assert port_out["app_seq"] > 0 and port_out["op_counts"]
    assert port_out["op_counts"] == jax_out["op_counts"]
    assert port_out["app_seq"] == jax_out["app_seq"]
    assert port_out["admitted"] == jax_out["admitted"]
    assert port_out["specs"] == jax_out["specs"]
    # The port's soak ran its windows on the plain row walk only.
    paths = soak.h.app.solver.window_path_counts
    assert set(paths) == {"reference"}, paths


@pytest.mark.parametrize("root", (JAX, PORT))
@pytest.mark.parametrize("strategy", ("tightly-pack", "single-az-tightly-pack"))
def test_elastic_soak_closes_the_loop(root, strategy):
    """tests/test_elastic_soak.py's counts, in each package: demands were
    fulfilled, nodes added and drained, a burst rode autoscaled capacity
    (drain safety asserted in the engine after every autoscaler pass)."""
    soak, _ = run_soak(root, strategy, 150, seed=20260803, n_nodes=10,
                       elastic=True)
    counts = soak.h.autoscaler.metrics.counts()
    assert soak.op_counts.get("elastic_burst"), soak.op_counts
    assert counts["demands_fulfilled"] > 0, counts
    assert counts["nodes_added"] > 0, counts
    assert counts["nodes_drained"] > 0, counts
    assert soak.h.autoscaler.metrics.scaleup_latency_samples()


def test_port_soak_trace_replays_strictly(tmp_path):
    """A soak captured by the port (`trace_path=`: every op but the write
    faults) replays decision for decision on the port."""
    path = str(tmp_path / "soak.jsonl")
    soak, _ = run_soak(PORT, "single-az-tightly-pack", 120, seed=5,
                       trace_path=path)
    assert "write_fault" not in soak.op_counts
    rep = importlib.import_module(f"{PORT}.replay").replay_trace(
        path, strict=True, device="cpu"
    )
    assert rep.mismatches == []
    assert rep.compared == rep.decisions >= 40
    assert not rep.torn_tail and rep.malformed == 0
