"""Solver telemetry: the port's `foundry.spark.scheduler.solver.*` series
against the JAX package's.

Both packages' apps (the port on `device="cpu"`) behind their threaded
servers get the same seeded traffic: drivers, their binding, executors,
and node PUTs under an in-flight window (one of them forces a pipeline
drain). Then both `/metrics` snapshots must carry the same solver series
with equal counts. The stated exceptions, each a deviation the port
records (ROADMAP §C):
- the compile gauges (`solver.jit.*`) count library builds in the port,
  XLA compiles in the JAX package;
- `solver.transfer.bytes` carries the bytes each package really ships
  (the same directions, other amounts), and `solver.bucket.occupancy` the
  port's own [S, R] window bucket (the same sample counts);
- the port books how each build reached its one device
  (`solver.device.uploads`, `solver.device.inflight`), which the JAX
  package books per device-pool slot only.
Both packages sync their device mirrors over the event-fed dirty set of
the native arena's resident build (`solver.build.dirty.rows`, with equal
counts); neither runs a dense mirror sweep here
(`solver.build.rows.compared`).
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from tests.test_torch_server import (
    JAX,
    NODE_CHANGES,
    PORT,
    Served,
    _serve_with_node_put_in_flight,
    k8s_node,
    k8s_spark_pod,
    same,
)

SOLVER = "foundry.spark.scheduler.solver."
COMPILE_GAUGES = {SOLVER + "jit.compiles", SOLVER + "jit.compile.seconds"}
JAX_ONLY: set = set()
PORT_ONLY = {
    SOLVER + "device.uploads",
    SOLVER + "device.inflight",
}


def _solver_series(snapshot):
    return {k: v for k, v in snapshot.items() if k.startswith(SOLVER)}


def _by_tags(entries, drop=()):
    out = {}
    for e in entries:
        tags = tuple(sorted((k, v) for k, v in e["tags"].items() if k not in drop))
        out[tags] = e
    return out


def _traffic(pair, seed):
    """Seeded drivers (bound when admitted) and executors on both servers,
    then node PUTs under an in-flight window. Returns the answers."""
    rng = np.random.default_rng(seed)
    names = [f"n{i}" for i in range(12)]
    answers = [[], []]
    for i, n in enumerate(names):
        for s in pair:
            assert s.call("PUT", "/state/nodes", k8s_node(n, zone=f"zone{i % 2}"))[0] == 200
    for k in range(5):
        pod = k8s_spark_pod(
            f"t{k}", "driver", f"t{k}-driver",
            executors=int(rng.integers(1, 5)), created=f"2026-07-29T12:03:{k:02d}Z",
        )
        for side, s in enumerate(pair):
            s.call("PUT", "/state/pods", pod)
            status, body = s.call("POST", "/predicates", {"Pod": pod, "NodeNames": names})
            answers[side].append(body)
            res = json.loads(body)
            if res["NodeNames"]:
                bound = dict(pod, spec=dict(pod["spec"], nodeName=res["NodeNames"][0]),
                             status={"phase": "Running"})
                s.call("PUT", "/state/pods", bound)
                for e in range(int(pod["metadata"]["annotations"]["spark-executor-count"])):
                    ex = k8s_spark_pod(f"t{k}", "executor", f"t{k}-exec-{e}",
                                       created=f"2026-07-29T12:03:{k:02d}Z")
                    s.call("PUT", "/state/pods", ex)
                    answers[side].append(s.call(
                        "POST", "/predicates", {"Pod": ex, "NodeNames": names})[1])
    bodies = []
    for i in range(4):
        pod = k8s_spark_pod(f"w{i}", "driver", f"w{i}-driver", executors=2,
                            created=f"2026-07-29T12:04:{i:02d}Z")
        for s in pair:
            s.call("PUT", "/state/pods", pod)
        bodies.append({"Pod": pod, "NodeNames": names + ["late-0"]})
    runs = [
        _serve_with_node_put_in_flight(s, bodies, NODE_CHANGES["nodes_added_past_bucket"])
        for s in pair
    ]
    (want, want_calls), (got, got_calls) = runs
    assert got_calls == want_calls and "drain" in got_calls
    for side, run in enumerate((want, got)):
        answers[side].extend(b for _, b in run)
    return answers


@pytest.fixture(scope="module")
def snapshots():
    pair = [Served(JAX), Served(PORT)]
    try:
        answers = _traffic(pair, seed=11)
        snaps = [json.loads(s.call("GET", "/metrics")[1]) for s in pair]
        state = json.loads(pair[1].call("GET", "/debug/state")[1])
        decisions = json.loads(pair[1].call("GET", "/debug/decisions")[1])["decisions"]
    finally:
        for s in pair:
            s.stop()
    return answers, [_solver_series(s) for s in snaps], state, decisions


def test_traffic_answers_match_jax(snapshots):
    answers = snapshots[0]
    assert len(answers[1]) == len(answers[0]) > 10
    for p, j in zip(answers[1], answers[0]):
        assert same(p, j), (p[:300], j[:300])


def test_solver_series_names_match_jax(snapshots):
    jax, port = snapshots[1]
    assert set(jax) - set(port) == JAX_ONLY
    assert set(port) - set(jax) == PORT_ONLY
    assert COMPILE_GAUGES <= set(port)


COUNTED = sorted(
    [
        "window.dispatches", "pipeline.events", "dispatch.amortized.rtt.ms",
        "featurize.ms", "featurize.snapshots", "featurize.roster.rebuilds",
        "featurize.usage.refreshes", "featurize.overhead.refreshes", "build.ms",
        "bucket.occupancy", "transfer.bytes",
    ]
)


@pytest.mark.parametrize("series", COUNTED)
def test_solver_series_counts_match_jax(snapshots, series):
    jax, port = snapshots[1]
    name = SOLVER + series
    drop = {"apps"} if series == "bucket.occupancy" else set()
    want, got = _by_tags(jax[name], drop), _by_tags(port[name], drop)
    assert set(got) == set(want), (series, got.keys(), want.keys())
    for tags, w in want.items():
        g = got[tags]
        assert g["kind"] == w["kind"]
        if series == "transfer.bytes":
            assert g["value"] > 0 and w["value"] > 0
        elif w["kind"] == "histogram":
            assert g["count"] == w["count"], (series, tags)
        elif series.startswith("featurize.") or w["kind"] == "counter":
            assert g["value"] == w["value"], (series, tags)


def test_window_paths_and_drain_are_counted(snapshots):
    _, port = snapshots[1]
    dispatches = {e["tags"]["path"]: e["value"] for e in port[SOLVER + "window.dispatches"]}
    assert list(dispatches) == ["xla"] and dispatches["xla"] > 5
    events = {e["tags"]["event"]: e["value"] for e in port[SOLVER + "pipeline.events"]}
    assert events.get("drain", 0) >= 1


def test_device_uploads_count_every_pipelined_build(snapshots):
    _, port = snapshots[1]
    uploads = {e["tags"]["kind"]: e["value"] for e in port[SOLVER + "device.uploads"]}
    builds = port[SOLVER + "build.ms"][0]["count"]
    # A build that raised PipelineDrainRequired is timed but did not reach
    # the device.
    drains = {e["tags"]["event"]: e["value"] for e in port[SOLVER + "pipeline.events"]}
    assert sum(uploads.values()) == builds - drains.get("drain", 0)
    assert uploads.get("full", 0) >= 2  # the first build and the one after the drain
    assert {e["tags"]["device"] for e in port[SOLVER + "device.uploads"]} == {"cpu"}
    assert port[SOLVER + "device.inflight"][0]["value"] == 0


def test_decision_records_carry_the_build_cache_verdict(snapshots):
    decisions = snapshots[3]
    solves = [d["solve"] for d in decisions if d.get("solve")]
    assert solves
    assert {s["compile_cache_hit"] for s in solves} <= {True, False}
    assert snapshots[2]["solver"]["window_paths"]["reference"] > 5
    assert snapshots[2]["server"] == {
        "transport": "threaded", "ingest": {"ingest": "python", "degraded": 0}
    }


def test_compile_gauges_count_library_builds():
    from spark_scheduler_tpu_torch.metrics.registry import MetricRegistry
    from spark_scheduler_tpu_torch.observability.telemetry import SolverTelemetry
    from spark_scheduler_tpu_torch.ops import _build

    tel = SolverTelemetry(MetricRegistry())
    assert tel.compile_count() == 0
    _build.note_builds(2, 1.5)
    try:
        assert tel.compile_count() == 2
        tel.sync_compile_gauges()
        snap = tel.registry.snapshot()
        assert snap[SOLVER + "jit.compiles"][0]["value"] == 2
        assert snap[SOLVER + "jit.compile.seconds"][0]["value"] == 1.5
    finally:
        _build.note_builds(-2, -1.5)


def test_hooks_without_a_caller_publish_the_jax_series():
    """The hooks the port has no caller for yet keep the JAX package's
    series names (the fused dispatch, pruned solve, device pool and
    degraded mode wire them when they are ported)."""
    from spark_scheduler_tpu.metrics.registry import MetricRegistry as JaxRegistry
    from spark_scheduler_tpu.observability.telemetry import SolverTelemetry as JaxTel
    from spark_scheduler_tpu_torch.metrics.registry import MetricRegistry
    from spark_scheduler_tpu_torch.observability.telemetry import SolverTelemetry

    names = []
    for tel in (JaxTel(JaxRegistry()), SolverTelemetry(MetricRegistry())):
        tel.on_fused_dispatch(2, 0.5)
        tel.on_prune_dispatch(4, 16)
        tel.on_prune_escalation("zone")
        tel.on_prune_phases(1.0, 2.0, 3.0)
        tel.on_prune_gather_reuse()
        tel.on_device_mirror("d0", "catchup", 3, 12)
        tel.on_device_mirror("d0", "dense", 0)
        tel.on_device_age("d0", 1.25)
        tel.on_device_window("d0", 1.0, 2.0, inflight=1)
        tel.on_slot_event("quarantine", "d0")
        tel.on_quarantine_count(1)
        tel.on_degraded(True)
        names.append({k: [e.get("value", e.get("count")) for e in v]
                      for k, v in tel.registry.snapshot().items()
                      if "jit" not in k})
    assert names[1] == names[0]
