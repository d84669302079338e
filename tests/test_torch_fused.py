"""The fused multi-window dispatch in the port against the JAX package, on
the CPU.

K queued serving windows solved as ONE dispatch
(`PlacementSolver.pack_windows_dispatch`, the extender's
`predicate_windows_dispatch` and the predicate batcher's fused claim). The
scenarios of tests/test_fused_dispatch.py that need no device pool or mesh,
each run through both packages (the port on `device="cpu"`):

  - fused K-window decisions equal sequential single-window dispatch, and
    the JAX package's fused decisions, across seeded usage churn for
    K in {1, 2, 4, 8}, and for a single-AZ strategy;
  - close() / discard_pipeline() release a fused batch's decision buffer,
    and a later fetch fails fast; a failed fused fetch raises the same
    error for every window without a second pull;
  - the extender: fused == sequential, the in-flight dedup across
    sub-windows, and the claim without drivers;
  - a server on `solver.fuse-windows: 4` under a backlog: every
    `/predicates` body byte-identical to the JAX server's, the fused
    claim's stats and the solver's fused series equal.

Tolerance: none.
"""

from __future__ import annotations

import importlib
import json

import numpy as np
import pytest

from tests.test_torch_native import load_jax_native
from tests.test_torch_server import (
    JAX,
    PORT,
    Served,
    _serve_pinned_windows,
    k8s_node,
    k8s_spark_pod,
    same,
)


def _mod(root, name):
    return importlib.import_module(f"{root}.{name}")


def _solver(root):
    cls = _mod(root, "core.solver").PlacementSolver
    return cls(use_native=False) if root == JAX else cls(device="cpu")


def _env(root, n):
    """(Node list, Resources, WindowRequest) of one package: tests/
    test_fused_dispatch.py's cluster of n 8-CPU nodes over two zones."""
    kube = _mod(root, "models.kube")
    res = _mod(root, "models.resources").Resources
    nodes = [
        kube.Node(
            name=f"n{i:03d}",
            allocatable=res.from_quantities("8", "8Gi", "1", round_up=False),
            labels={kube.ZONE_LABEL: f"z{i % 2}"},
        )
        for i in range(n)
    ]
    return nodes, res, _mod(root, "core.solver").WindowRequest


def _random_windows(root, rng, nodes, k, per, *, fifo_rows=False):
    """K windows of `per` requests (tests/test_fused_dispatch.py
    `_random_windows`); fifo_rows adds hypothetical earlier drivers."""
    _, res, request = _env(root, 0)
    one = res.from_quantities("1", "1Gi")
    two = res.from_quantities("2", "2Gi")
    names = [n.name for n in nodes]
    windows = []
    for _ in range(k):
        reqs = []
        for _ in range(per):
            rows = []
            if fifo_rows:
                for _ in range(int(rng.integers(0, 3))):
                    rows.append((one, one, int(rng.integers(1, 3)),
                                 bool(rng.random() < 0.5)))
            drv = two if rng.random() < 0.3 else one
            rows.append((drv, one, int(rng.integers(1, 4)), False))
            reqs.append(request(rows=rows, driver_candidate_names=names))
        windows.append(reqs)
    return windows


def _random_usage(root, rng, nodes):
    res = _mod(root, "models.resources").Resources
    return {
        n.name: res.from_quantities(str(int(rng.integers(1, 4))), "1Gi")
        for n in nodes
        if rng.random() < 0.3
    }


def _run_sequential(solver, nodes, batches, usages, strategy):
    """The serving loop's order: inside a batch every window dispatched
    back to back, then all fetched; churn lands between batches."""
    out = []
    for usage, wins in zip(usages, batches):
        handles = []
        for w in wins:
            t = solver.build_tensors_pipelined(nodes, usage, {})
            handles.append(solver.pack_window_dispatch(strategy, t, w))
        for h in handles:
            out.extend(solver.pack_window_fetch(h))
    return out


def _run_fused(solver, nodes, batches, usages, strategy, view_cls):
    out = []
    for usage, wins in zip(usages, batches):
        t = solver.build_tensors_pipelined(nodes, usage, {})
        views = solver.pack_windows_dispatch(strategy, t, wins)
        assert all(isinstance(v, view_cls) for v in views)
        assert len({v.dispatch_id for v in views}) == 1
        assert [v.fused_k for v in views] == [len(wins)] * len(wins)
        for v in views:
            out.extend(solver.pack_window_fetch(v))
    return out


def _scenario(root, seed, k, n_nodes, n_batches, strategy, fifo_rows):
    """(sequential, fused) decisions of one package on seeded churn."""
    rng = np.random.default_rng(seed)
    nodes, _, _ = _env(root, n_nodes)
    batches = [
        _random_windows(root, rng, nodes, k, 2, fifo_rows=fifo_rows)
        for _ in range(n_batches)
    ]
    usages = [{}] + [_random_usage(root, rng, nodes) for _ in range(n_batches - 1)]
    view_cls = _mod(root, "core.solver").FusedWindowView
    seq = _run_sequential(_solver(root), nodes, batches, usages, strategy)
    fused = _run_fused(_solver(root), nodes, batches, usages, strategy, view_cls)
    return seq, fused


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_fused_matches_sequential_with_churn(k):
    got_seq, got_fused = _scenario(PORT, 100 + k, k, 16, 3, "tightly-pack", True)
    _, want_fused = _scenario(JAX, 100 + k, k, 16, 3, "tightly-pack", True)
    assert len(got_seq) == len(got_fused) == 3 * k * 2
    for i, (a, b) in enumerate(zip(got_seq, got_fused)):
        assert a == b, f"decision {i} diverged: {a} vs {b}"
    assert [tuple(d) for d in got_fused] == [tuple(d) for d in want_fused]
    assert any(d.admitted for d in got_fused)


def test_fused_matches_sequential_single_az_strategy():
    got_seq, got_fused = _scenario(
        PORT, 7, 4, 12, 1, "single-az-tightly-pack", False
    )
    _, want_fused = _scenario(JAX, 7, 4, 12, 1, "single-az-tightly-pack", False)
    assert got_seq == got_fused
    assert [tuple(d) for d in got_fused] == [tuple(d) for d in want_fused]


def _commit(res, usage, requests, decisions):
    """What the extender does after a fetch: every admitted gang's driver
    and executors join the usage (a {node: Resources} map)."""
    for req, d in zip(requests, decisions):
        if d.admitted:
            drv, exe = req.rows[-1][0], req.rows[-1][1]
            names = [d.packing.driver_node] + list(d.packing.executor_nodes)
            for i, name in enumerate(names):
                usage[name] = usage.get(name, res.zero()).add(drv if i == 0 else exe)


def _interleaved(root, fused):
    """Two windows dispatched together (fused or back to back), the first
    fetched and committed, then a third window built and dispatched BEFORE
    the second is fetched, as the batcher does when a dispatch lands
    between two completions. Returns every decision."""
    nodes, res, request = _env(root, 4)
    names = [n.name for n in nodes]
    drv = res.from_quantities("2", "2Gi")
    exe = res.from_quantities("3", "3Gi")  # two a node: 14 CPU a gang of 32

    def window(tag):
        return [request(rows=[(drv, exe, 4, False)], driver_candidate_names=names)]

    w1, w2, w3 = window(1), window(2), window(3)
    solver, usage = _solver(root), {}
    if fused:
        h1, h2 = solver.pack_windows_dispatch(
            "tightly-pack", solver.build_tensors_pipelined(nodes, usage, {}), [w1, w2]
        )
    else:
        h1 = solver.pack_window_dispatch(
            "tightly-pack", solver.build_tensors_pipelined(nodes, usage, {}), w1)
        h2 = solver.pack_window_dispatch(
            "tightly-pack", solver.build_tensors_pipelined(nodes, usage, {}), w2)
    out = []
    for h, w in ((h1, w1),):
        out += solver.pack_window_fetch(h)
        _commit(res, usage, w, out[-1:])
    h3 = solver.pack_window_dispatch(
        "tightly-pack", solver.build_tensors_pipelined(nodes, usage, {}), w3)
    for h, w in ((h2, w2), (h3, w3)):
        out += solver.pack_window_fetch(h)
        _commit(res, usage, w, out[-1:])
    for n in nodes:
        used = usage.get(n.name, res.zero())
        assert used.cpu_milli <= n.allocatable.cpu_milli, (root, fused, n.name)
    return out


def test_dispatch_between_fused_fetches_sees_the_later_windows():
    """A fused batch debits each window's placements from the pipeline
    mirror when that window's view is fetched: a build between two views'
    fetches keeps the second window's capacity taken on the device, so the
    third window packs exactly as after two sequential dispatches (and
    nothing is over-committed)."""
    seq = _interleaved(PORT, fused=False)
    assert _interleaved(PORT, fused=True) == seq
    assert [tuple(d) for d in _interleaved(JAX, fused=False)] == [tuple(d) for d in seq]
    assert sum(d.admitted for d in seq) == 2  # the third gang no longer fits
    # The JAX package debits all K windows at the first view's fetch, and
    # the third window lands on the second's capacity: a deliberate
    # deviation (ROADMAP §C.4).
    with pytest.raises(AssertionError):
        _interleaved(JAX, fused=True)


def _third_between_fetches(root, fused, fetch_first):
    """ROADMAP §C.5's case: 4 nodes of 64 CPU / 64 Gi, three one-request
    tightly-pack windows (a 2 CPU / 2 Gi driver and 3 executors of
    3 CPU / 3 Gi). Windows 1 and 2 are dispatched together (fused or back
    to back); the third is built and dispatched after window 1's fetch
    and commit (`fetch_first`) or before any fetch. Returns every
    decision, in dispatch order."""
    kube = _mod(root, "models.kube")
    res = _mod(root, "models.resources").Resources
    request = _mod(root, "core.solver").WindowRequest
    nodes = [
        kube.Node(
            name=f"n{i}",
            allocatable=res.from_quantities("64", "64Gi"),
            labels={kube.ZONE_LABEL: "z0"},
        )
        for i in range(4)
    ]
    names = [n.name for n in nodes]
    drv = res.from_quantities("2", "2Gi")
    exe = res.from_quantities("3", "3Gi")
    w1, w2, w3 = (
        [request(rows=[(drv, exe, 3, False)], driver_candidate_names=names)]
        for _ in range(3)
    )
    solver, usage = _solver(root), {}

    def build():
        return solver.build_tensors_pipelined(nodes, usage, {})

    if fused:
        h1, h2 = solver.pack_windows_dispatch("tightly-pack", build(), [w1, w2])
    else:
        h1 = solver.pack_window_dispatch("tightly-pack", build(), w1)
        h2 = solver.pack_window_dispatch("tightly-pack", build(), w2)
    out = []
    if fetch_first:
        out += solver.pack_window_fetch(h1)
        _commit(res, usage, w1, out[-1:])
    h3 = solver.pack_window_dispatch("tightly-pack", build(), w3)
    for h, w in ((h1, w1), (h2, w2), (h3, w3))[1 if fetch_first else 0:]:
        out += solver.pack_window_fetch(h)
        _commit(res, usage, w, out[-1:])
    return out


@pytest.mark.parametrize("fetch_first", [True, False])
def test_dispatch_between_fused_fetches_reconstructs_on_the_device_base(
    fetch_first,
):
    """A dispatch between two fused views' fetches: the host view it was
    built on already holds window 1's reservations, so its fetch-side base
    subtracts only window 2's placements, and the third window's
    efficiency is the sequential one (33 of 64 CPU: 0.515625). Dispatched
    before any view is fetched, the base still subtracts both windows."""
    seq = _third_between_fetches(PORT, fused=False, fetch_first=fetch_first)
    fused = _third_between_fetches(PORT, fused=True, fetch_first=fetch_first)
    want = _third_between_fetches(JAX, fused=False, fetch_first=fetch_first)
    assert [tuple(d) for d in seq] == [tuple(d) for d in want]
    assert fused == seq
    assert all(d.admitted for d in fused)
    assert fused[2].packing.driver_node == fused[0].packing.driver_node
    assert fused[2].packing.efficiency_max == 0.515625
    assert fused[2].packing.efficiency_cpu == 0.515625


def _dispatched(seed, k):
    rng = np.random.default_rng(seed)
    nodes, _, _ = _env(PORT, 8)
    solver = _solver(PORT)
    t = solver.build_tensors_pipelined(nodes, {}, {})
    views = solver.pack_windows_dispatch(
        "tightly-pack", t, _random_windows(PORT, rng, nodes, k, 1)
    )
    return solver, nodes, views


def test_close_releases_fused_buffers():
    """close() releases the fused batch's decision buffer and fails later
    fetches fast, even while views are still held outside the solver."""
    solver, _, views = _dispatched(11, 3)
    owner = views[0].owner
    solver.close()
    assert owner.released and owner.blob is None
    with pytest.raises(RuntimeError, match="discarded"):
        solver.pack_window_fetch(views[1])


def test_discard_pipeline_releases_fused_buffers():
    solver, nodes, views = _dispatched(12, 2)
    solver.discard_pipeline()
    assert views[0].owner.released and views[0].owner.blob is None
    with pytest.raises(RuntimeError, match="discarded"):
        solver.pack_window_fetch(views[0])
    # The pipeline rebuilds from host truth and serves fresh windows.
    rng = np.random.default_rng(13)
    t2 = solver.build_tensors_pipelined(nodes, {}, {})
    views2 = solver.pack_windows_dispatch(
        "tightly-pack", t2, _random_windows(PORT, rng, nodes, 2, 1)
    )
    decisions = [d for v in views2 for d in solver.pack_window_fetch(v)]
    assert decisions and all(d.admitted for d in decisions)


def test_failed_fused_fetch_raises_for_every_window_with_one_pull(monkeypatch):
    solver, _, views = _dispatched(14, 3)
    pulls = []

    def broken(handle):
        pulls.append(handle)
        raise RuntimeError("decision pull failed")

    monkeypatch.setattr(type(views[0].owner), "fetch_blob", broken)
    for v in views:
        with pytest.raises(RuntimeError, match="decision pull failed"):
            solver.pack_window_fetch(v)
    assert pulls == [views[0].owner]


# ---------------------------------------------------------------- extender


def _harness(root, **kw):
    h = _mod(root, "testing.harness")
    if root == PORT:
        kw["device"] = "cpu"
    else:
        load_jax_native()
    return h, h.Harness(**kw)


def _args(root, pod, names):
    return _mod(root, "core.extender").ExtenderArgs(pod=pod, node_names=names)


def _extender_fused_vs_sequential(root):
    def build(fuse):
        h, harness = _harness(root, binpack_algo="tightly-pack", fifo=True)
        harness.add_nodes(*[h.new_node(f"en{i}", zone=f"zone{i % 2}") for i in range(10)])
        names = [f"en{i}" for i in range(10)]
        argss = []
        for j in range(8):
            pod = h.static_allocation_spark_pods(f"fx-{fuse}-{j}", 2)[0]
            harness.add_pods(pod)
            argss.append(_args(root, pod, names))
        return harness, argss

    h_seq, args_seq = build("seq")
    tickets = [
        h_seq.extender.predicate_window_dispatch(args_seq[i:i + 4]) for i in (0, 4)
    ]
    seq = [r for t in tickets for r in h_seq.extender.predicate_window_complete(t)]
    h_fused, args_fused = build("fused")
    fused_tickets = h_fused.extender.predicate_windows_dispatch(
        [args_fused[:4], args_fused[4:]]
    )
    assert len(fused_tickets) == 2
    fused = [
        r for t in fused_tickets
        for r in h_fused.extender.predicate_window_complete(t)
    ]
    recs = h_fused.app.recorder.query(role="driver", limit=16)
    fused_recs = [r for r in recs if r.get("fused_k")]
    return seq, fused, fused_recs


def test_extender_fused_windows_dispatch_matches_sequential():
    """A fused 2-window dispatch through the extender's staging (in-flight
    dedup, FIFO rows, reservations) places every gang where the sequential
    dispatches do, in both packages, and the flight recorder carries
    fused_k and one dispatch id."""
    got_seq, got_fused, recs = _extender_fused_vs_sequential(PORT)
    want_seq, want_fused, want_recs = _extender_fused_vs_sequential(JAX)
    assert [r.node_names for r in got_seq] == [r.node_names for r in got_fused]
    assert [r.node_names for r in got_fused] == [r.node_names for r in want_fused]
    assert all(r.ok for r in got_fused)
    assert recs and all(r["fused_k"] == 2 for r in recs)
    assert len({r["dispatch_id"] for r in recs}) == 1
    assert len(recs) == len(want_recs)


def _dedup(root):
    h, harness = _harness(root, binpack_algo="tightly-pack", fifo=False)
    harness.add_nodes(*[h.new_node(f"dd{i}") for i in range(4)])
    names = [f"dd{i}" for i in range(4)]
    pod = h.static_allocation_spark_pods("fx-dup", 1)[0]
    other = h.static_allocation_spark_pods("fx-other", 1)[0]
    harness.add_pods(pod, other)
    args = _args(root, pod, names)
    tickets = harness.extender.predicate_windows_dispatch(
        [[args, _args(root, other, names)], [args]]
    )
    return [r for t in tickets for r in harness.extender.predicate_window_complete(t)]


def test_extender_fused_dedups_inflight_apps_across_subwindows():
    """The same app in two sub-windows of one fused claim: the duplicate
    defers to its own ticket's solo loop, which serves the reserved node."""
    got, want = _dedup(PORT), _dedup(JAX)
    assert all(r.ok for r in got), got
    assert got[0].node_names == got[2].node_names
    assert [(r.outcome, r.node_names) for r in got] == [
        (r.outcome, r.node_names) for r in want
    ]


def _no_drivers(root):
    h, harness = _harness(root, binpack_algo="tightly-pack", fifo=False)
    kube = _mod(root, "models.kube")
    one = _mod(root, "models.resources").Resources.from_quantities("1", "1Gi")
    harness.add_nodes(*[h.new_node(f"xe{i}") for i in range(4)])
    names = [f"xe{i}" for i in range(4)]

    def plain(name):
        p = kube.Pod(name=name, namespace="namespace",
                     containers=[kube.Container(requests=one)])
        harness.add_pods(p)
        return _args(root, p, names)

    before = dict(harness.app.solver.device_state_stats)
    tickets = harness.extender.predicate_windows_dispatch(
        [[plain("px-0"), plain("px-1")], [plain("px-2"), plain("px-3")]]
    )
    assert all(t.handle is None for t in tickets)
    assert harness.app.solver.device_state_stats == before
    return [r for t in tickets for r in harness.extender.predicate_window_complete(t)]


def test_fused_claim_without_drivers_dispatches_nothing():
    """A fused claim with no driver anywhere builds no tensors and
    dispatches nothing (no spurious PipelineDrainRequired)."""
    got, want = _no_drivers(PORT), _no_drivers(JAX)
    assert all(r.outcome == "failure-non-spark-pod" for r in got)
    assert [r.outcome for r in got] == [r.outcome for r in want]


# ------------------------------------------------------------------ server

SOLVER = "foundry.spark.scheduler.solver."


def test_server_fused_claim_bodies_match_jax():
    """Both servers on `solver.fuse-windows: 4` with a 3-request window:
    the first request's window is held in dispatch until 12 more have
    queued, so the next claim takes all 12 as one fused dispatch of four
    windows. Every body byte-identical to the JAX server's; the batcher's
    fused stats and the solver's fused series equal."""
    sides = [
        Served(root, solver_fuse_windows=4, predicate_max_window=3)
        for root in (JAX, PORT)
    ]
    try:
        rng = np.random.default_rng(17)
        names = [f"n{i}" for i in range(24)]
        for s in sides:
            for i, n in enumerate(names):
                assert s.call("PUT", "/state/nodes", k8s_node(n, zone=f"zone{i % 3}"))[0] == 200
        bodies = []
        for i in range(13):
            pod = k8s_spark_pod(
                f"fz-{i}", "driver", f"fz-{i}-driver",
                executors=int(rng.integers(1, 9)),
                created=f"2026-07-29T12:00:{i:02d}Z",
                exec_cpu=str(int(rng.integers(1, 4))),
            )
            for s in sides:
                assert s.call("PUT", "/state/pods", pod)[0] == 200
            bodies.append({"Pod": pod, "NodeNames": names})
        (want, want_sizes), (got, got_sizes) = (
            _serve_pinned_windows(s, bodies) for s in sides
        )
        assert got_sizes == want_sizes == [1]
        for i, (g, w) in enumerate(zip(got, want)):
            assert g[0] == w[0] == 200, i
            assert same(g[1], w[1]), (i, g[1][:300], w[1][:300])
        assert sum(bool(json.loads(g[1])["NodeNames"]) for g in got) >= 2
        keys = ("fuse_windows", "fused_dispatches", "max_fused_k",
                "windows_served", "requests_served", "max_window_seen")
        stats = [{k: s.server.batcher.stats()[k] for k in keys} for s in sides]
        assert stats[1] == stats[0]
        assert stats[1]["max_fused_k"] == 4 and stats[1]["fused_dispatches"] == 1
        snaps = [s.registry.snapshot() for s in sides]
        hist = "foundry.spark.scheduler.predicate.fused.windows"
        assert snaps[1][hist][0]["count"] == snaps[0][hist][0]["count"] == 1
        tels = [s.app.solver.telemetry.registry.snapshot() for s in sides]
        for name in ("dispatch.fused.k", "dispatch.amortized.rtt.ms"):
            counts = [
                sorted((tuple(sorted(e["tags"].items())), e["count"])
                       for e in t[SOLVER + name])
                for t in tels
            ]
            assert counts[1] == counts[0], name
    finally:
        for s in sides:
            s.stop()
