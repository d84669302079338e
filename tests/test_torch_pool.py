"""Pooled decision identity: the port's window-solve device pool against
the JAX package's pool and against the single-device path, on the CPU.

The cases of tests/test_window_serving.py (the pooled engine equivalence
over overlapped windows, the extender over a pool, overlapping domains
that must not partition), tests/test_fused_dispatch.py (fused dispatch on
a partitioned pool, close() of a fused pooled dispatch, the fused pooled
server smoke) and tests/test_prune_equivalence.py (pruning on a
partitioned pool). The JAX package's pools run on the conftest's 8
virtual CPU devices, the port's on slots of the one CPU device
(`pool_devices=["cpu"] * k`). Tolerance: none.
"""

from __future__ import annotations

import functools
import http.client
import importlib
import json
import threading
import time
from unittest import mock

import numpy as np
import pytest

from tests.test_torch_extender import JAX, PORT, canon


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def solver(pkg, pool=0, **kw):
    sm = mod(pkg, "core.solver")
    if pkg == PORT:
        if pool:
            kw["pool_devices"] = ["cpu"] * pool
        return sm.PlacementSolver(device="cpu", **kw)
    if pool:
        kw["device_pool"] = pool
    return sm.PlacementSolver(use_native=False, **kw)


def make_harness(pkg, pool=0, **kw):
    """`pkg`'s test Harness, on a pool of `pool` slots when `pool` > 0. The
    port's app then lays its slots on the one CPU device, through
    `build_scheduler_app`'s `pool_devices=`."""
    harness = mod(pkg, "testing.harness")
    if pool:
        kw["solver_device_pool"] = pool
    if pkg != PORT:
        return harness.Harness(**kw)
    build = harness.build_scheduler_app
    if pool:
        build = functools.partial(build, pool_devices=["cpu"] * pool)
    with mock.patch.object(harness, "build_scheduler_app", build):
        return harness.Harness(device="cpu", **kw)


# A world is plain data made once from a seed; each package builds its own
# objects from it.


def nodes_of(pkg, n, zones=2):
    kube = mod(pkg, "models.kube")
    res = mod(pkg, "models.resources").Resources
    return [
        kube.Node(
            name=f"n{i:03d}",
            allocatable=res.from_quantities("8", "8Gi", "1", round_up=False),
            labels={kube.ZONE_LABEL: f"z{i % zones}"},
        )
        for i in range(n)
    ]


def random_windows(rng, names, k, per, *, domains=None, fifo_rows=False):
    """K windows of `per` requests as plain data: (rows, candidates,
    domain), rows of ((cpu, mem), count, skippable)."""
    windows, r = [], 0
    for _ in range(k):
        reqs = []
        for _ in range(per):
            rows = []
            if fifo_rows:
                for _ in range(int(rng.integers(0, 3))):
                    rows.append((("1", "1Gi"), int(rng.integers(1, 3)),
                                 bool(rng.random() < 0.5)))
            size = ("2", "2Gi") if rng.random() < 0.3 else ("1", "1Gi")
            rows.append((size, int(rng.integers(1, 4)), False))
            dom = domains[r % len(domains)] if domains is not None else None
            reqs.append((rows, dom if dom is not None else names, dom))
            r += 1
        windows.append(reqs)
    return windows


def random_usage(rng, names):
    return {
        n: (str(int(rng.integers(1, 4))), "1Gi")
        for n in names if rng.random() < 0.3
    }


def build(pkg, windows, usage=None):
    sm = mod(pkg, "core.solver")
    res = mod(pkg, "models.resources").Resources
    one = res.from_quantities("1", "1Gi")
    built = [
        [
            sm.WindowRequest(
                rows=[(res.from_quantities(*size), one, c, s)
                      for size, c, s in rows],
                driver_candidate_names=list(cand),
                domain_node_names=None if dom is None else list(dom),
            )
            for rows, cand, dom in w
        ]
        for w in windows
    ]
    if usage is None:
        return built
    return built, {k: res.from_quantities(*v) for k, v in usage.items()}


def run_sequential(s, nodes, batches, usages, strategy="tightly-pack"):
    out = []
    for usage, wins in zip(usages, batches):
        handles = []
        for w in wins:
            t = s.build_tensors_pipelined(nodes, usage, {})
            handles.append(s.pack_window_dispatch(strategy, t, w))
        for h in handles:
            out.extend(s.pack_window_fetch(h))
    return out


def run_fused(s, nodes, batches, usages, strategy="tightly-pack"):
    out = []
    for usage, wins in zip(usages, batches):
        t = s.build_tensors_pipelined(nodes, usage, {})
        views = s.pack_windows_dispatch(strategy, t, wins)
        assert len({v.dispatch_id for v in views}) == 1
        for v in views:
            out.extend(s.pack_window_fetch(v))
    return out


def materialize(pkg, plain_batches, plain_usages):
    batches, usages = [], []
    for wins, usage in zip(plain_batches, plain_usages):
        b, u = build(pkg, wins, usage)
        batches.append(b)
        usages.append(u)
    return batches, usages


# -------------------------------------------- overlapped pooled windows


def group_world(seed, n_groups=4, nodes_per_group=4, n_requests=10):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        reqs = []
        for _ in range(n_requests):
            g = int(rng.integers(0, n_groups))
            names = [f"g{g}-n{i}" for i in range(nodes_per_group)]
            rows = [((("1", "1Gi")), int(rng.integers(1, 4)),
                     bool(rng.random() < 0.5))
                    for _ in range(int(rng.integers(0, 3)))]
            rows.append((("1", "1Gi"), int(rng.integers(1, 4)), False))
            reqs.append((rows, names, names))
        out.append(reqs)
    return out


def group_harness(pkg, pool=0, n_groups=4, nodes_per_group=4):
    harness = mod(pkg, "testing.harness")
    h = make_harness(pkg, pool, binpack_algo="tightly-pack", fifo=True)
    for g in range(n_groups):
        h.add_nodes(*[
            harness.new_node(f"g{g}-n{i}", zone=f"zone{i % 2}",
                             instance_group=f"group-{g}")
            for i in range(nodes_per_group)
        ])
    return h


@pytest.mark.parametrize("pool", [2, 4])
def test_pooled_window_decisions_equal_single_device_and_jax(pool):
    """Two overlapped windows (the second dispatched before the first is
    fetched) over four instance groups: the port's pool of `pool` slots,
    the port's single device, and the JAX package's pool and single device
    decide alike, every field."""
    plain = group_world(7)

    def scenario(pkg, p):
        h = group_harness(pkg, p)
        s = h.app.solver
        nodes = h.backend.list_nodes()
        w1, w2 = build(pkg, plain)
        t1 = s.build_tensors_pipelined(nodes, {}, {})
        h1 = s.pack_window_dispatch("tightly-pack", t1, w1)
        t2 = s.build_tensors_pipelined(nodes, {}, {})
        h2 = s.pack_window_dispatch("tightly-pack", t2, w2)
        out = s.pack_window_fetch(h1) + s.pack_window_fetch(h2)
        if p:
            assert s.last_solve_info["path"] == "pool"
            assert s.last_solve_info["partitions"] == 4
        return out

    want = scenario(JAX, 0)
    assert canon(scenario(JAX, pool)) == canon(want)
    assert canon(scenario(PORT, 0)) == canon(want)
    assert canon(scenario(PORT, pool)) == canon(want)


def test_pooled_serving_through_extender_matches_single_device():
    def scenario(pkg, pool):
        harness = mod(pkg, "testing.harness")
        ext = mod(pkg, "core.extender")
        h = group_harness(pkg, pool)
        args = []
        for g in range(4):
            for a in range(2):
                pod = harness.static_allocation_spark_pods(
                    f"mdx-{g}-{a}", 2, instance_group=f"group-{g}"
                )[0]
                h.add_pods(pod)
                args.append(ext.ExtenderArgs(
                    pod=pod, node_names=[f"g{g}-n{i}" for i in range(4)]
                ))
        results = h.extender.predicate_batch(args)
        rrs = {
            rr.name: {k: v.node for k, v in rr.spec.reservations.items()}
            for rr in h.backend.list("resourcereservations")
        }
        if pool:
            info = h.app.solver.last_solve_info
            assert info["path"] == "pool" and info["partitions"] == 4
            rec = h.app.recorder.query(role="driver", limit=1)[0]
            assert rec["device_id"] and rec["device_id"].startswith("cpu")
            assert rec["state_upload"] in ("full", "delta", "reuse")
        return [(r.outcome, tuple(r.node_names)) for r in results], rrs

    want = scenario(JAX, 0)
    assert canon(scenario(JAX, 4)) == canon(want)
    assert canon(scenario(PORT, 4)) == canon(want)


def test_pool_solves_overlapping_domains_whole():
    """Requests whose domains overlap must not partition: the window
    solves whole on one slot and decisions match the single device."""
    def scenario(pkg, pool):
        harness = mod(pkg, "testing.harness")
        ext = mod(pkg, "core.extender")
        h = make_harness(pkg, pool, binpack_algo="tightly-pack", fifo=True)
        h.add_nodes(*[harness.new_node(f"n{i}") for i in range(8)])
        names = [f"n{i}" for i in range(8)]
        args = []
        for a in range(4):
            pod = harness.static_allocation_spark_pods(f"ovl-{a}", 2)[0]
            h.add_pods(pod)
            args.append(ext.ExtenderArgs(pod=pod, node_names=list(names)))
        results = h.extender.predicate_batch(args)
        if pool:
            assert h.app.solver.last_solve_info["partitions"] == 1
        return [(r.outcome, tuple(r.node_names)) for r in results]

    want = scenario(JAX, 0)
    assert canon(scenario(JAX, 2)) == canon(want)
    assert canon(scenario(PORT, 2)) == canon(want)


# ----------------------------------------------------------- fused x pool


@pytest.mark.parametrize("k", [2, 4])
def test_fused_pooled_partitioned_matches_single_device(k):
    rng = np.random.default_rng(30 + k)
    names = [f"n{i:03d}" for i in range(16)]
    half = names[:8], names[8:]
    plain_batches = [
        random_windows(rng, names, k, 2, domains=half) for _ in range(2)
    ]
    plain_usages = [{}, random_usage(rng, names)]

    def scenario(pkg, pool, fused):
        batches, usages = materialize(pkg, plain_batches, plain_usages)
        s = solver(pkg, pool)
        assert s.pool_size == max(pool, 1)
        go = run_fused if fused else run_sequential
        return go(s, nodes_of(pkg, 16), batches, usages)

    want = scenario(JAX, 0, False)
    assert canon(scenario(JAX, 2, True)) == canon(want)
    assert canon(scenario(PORT, 0, False)) == canon(want)
    assert canon(scenario(PORT, 2, True)) == canon(want)


def test_close_releases_fused_pooled_dispatch():
    rng = np.random.default_rng(13)
    names = [f"n{i:03d}" for i in range(16)]
    plain = random_windows(rng, names, 2, 2, domains=(names[:8], names[8:]))
    for pkg in (JAX, PORT):
        s = solver(pkg, 2)
        t = s.build_tensors_pipelined(nodes_of(pkg, 16), {}, {})
        views = s.pack_windows_dispatch("tightly-pack", t, build(pkg, plain))
        s.close()
        assert views[0].owner.released
        for slot in s._pool.slots:
            assert slot.statics is None and not slot.sub_statics
        with pytest.raises(RuntimeError):
            s.pack_window_fetch(views[0])


def test_server_smoke_fused_pool_exports_dispatch_series():
    """A two-slot pool with fuse-windows 4 behind the HTTP server (the
    simulated-RTT shim keeps windows in flight long enough for a backlog
    to fuse): every gang lands in its group, fused dispatches happen, and
    the dispatch series reach /metrics, on both packages."""
    def scenario(pkg):
        if pkg == JAX:
            # Imported here: the card's tests (tests/test_torch_cuda.py)
            # import this module's helpers where the JAX package is absent.
            from tests.test_torch_native import load_jax_native

            load_jax_native()
        harness = mod(pkg, "testing.harness")
        metrics = mod(pkg, "metrics")
        kube_io = mod(pkg, "server.kube_io")
        backend = mod(pkg, "store.backend").InMemoryBackend()
        group_names: dict = {}
        for g in range(2):
            group_names[g] = []
            for i in range(6):
                n = harness.new_node(f"fg{g}-n{i}", zone=f"zone{i % 2}",
                                     instance_group=f"fgroup-{g}")
                backend.add_node(n)
                group_names[g].append(n.name)
        registry = metrics.MetricRegistry()
        kw = {"device": "cpu", "pool_devices": ["cpu", "cpu"]} if pkg == PORT else {}
        app = mod(pkg, "server.app").build_scheduler_app(
            backend,
            mod(pkg, "server.config").InstallConfig(
                fifo=True, sync_writes=True,
                instance_group_label=harness.INSTANCE_GROUP_LABEL,
                solver_device_pool=2, solver_fuse_windows=4,
                predicate_max_window=2,
            ),
            metrics=metrics.SchedulerMetrics(registry, harness.INSTANCE_GROUP_LABEL),
            **kw,
        )
        assert app.solver.pool_size == 2
        server = mod(pkg, "server.http").SchedulerHTTPServer(
            app, registry, host="127.0.0.1", port=0, request_timeout_s=120.0
        )
        server.start()
        shim = mod(pkg, "testing.rtt_shim").SimulatedRTT(
            rtt_ms=0.0, h2d_ms=25.0, d2h_ms=50.0
        )
        shim.install()
        n_clients = 12
        errors: list = []
        results: list = [None] * n_clients

        def client(i):
            try:
                g = i % 2
                pod = harness.static_allocation_spark_pods(
                    f"fsrv-{i}", 2, instance_group=f"fgroup-{g}"
                )[0]
                backend.add_pod(pod)
                conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                                  timeout=120)
                conn.request("POST", "/predicates", body=json.dumps(
                    {"Pod": kube_io.pod_to_k8s(pod), "NodeNames": group_names[g]}
                ).encode())
                results[i] = json.loads(conn.getresponse().read())
                conn.close()
            except Exception as exc:  # surfaced after join
                errors.append(exc)

        try:
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(n_clients)]
            for t in threads:
                t.start()
                time.sleep(0.002)
            for t in threads:
                t.join(timeout=120)
            assert not errors, errors
            for i, r in enumerate(results):
                assert r and r.get("NodeNames"), (i, r)
                assert r["NodeNames"][0] in group_names[i % 2]
            assert server.batcher.fused_dispatches >= 1
            conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
            conn.request("GET", "/metrics")
            snap = json.loads(conn.getresponse().read())
            conn.close()
            prefix = "foundry.spark.scheduler.solver.dispatch."
            series = sorted(n for n in snap if n.startswith(prefix))
            assert {prefix + "fused.k", prefix + "amortized.rtt.ms",
                    prefix + "overlap.occupancy"} <= set(series)
        finally:
            shim.uninstall()
            server.stop()
        assert app.solver._pipe is None
        for slot in app.solver._pool.slots:
            assert slot.statics is None and not slot.sub_statics
        # How many windows fuse depends on the threads' timing; that a
        # fused dispatch happened and wrote its series does not.
        return [prefix + k in series for k in
                ("fused.k", "amortized.rtt.ms", "overlap.occupancy")]

    assert scenario(PORT) == scenario(JAX) == [True] * 3


# ---------------------------------------------------------- prune x pool


@pytest.mark.parametrize("pool", [1, 2])
def test_pruned_matches_full_pooled_partitioned(pool):
    """Pruning on a pool: windows whose requests pin disjoint domains
    partition over the slots and each partition prunes its own gather; on
    one device (pool 1) a window shares one domain to prune. Pruned equals
    unpruned on the port, and equals the JAX package's pruned pool."""
    rng = np.random.default_rng(60 + pool)
    names = [f"n{i:03d}" for i in range(96)]
    half = names[:48], names[48:]
    plain_batches = []
    for _ in range(2):
        if pool == 1:
            wins = []
            for w in range(2):
                wins.extend(random_windows(rng, names, 1, 2,
                                           domains=[half[w % 2]], fifo_rows=True))
            plain_batches.append(wins)
        else:
            plain_batches.append(
                random_windows(rng, names, 2, 2, domains=half, fifo_rows=True)
            )
    plain_usages = [{}, random_usage(rng, names)]

    def scenario(pkg, **kw):
        batches, usages = materialize(pkg, plain_batches, plain_usages)
        s = solver(pkg, **kw)
        out = run_sequential(s, nodes_of(pkg, 96), batches, usages)
        return out, s

    full, _ = scenario(PORT, prune_top_k=0)
    pruned, ps = scenario(
        PORT, pool=pool if pool > 1 else 0, prune_top_k=4, prune_slack=0.3
    )
    jax_pruned, js = scenario(
        JAX, pool=pool if pool > 1 else 0, prune_top_k=4, prune_slack=0.3
    )
    assert canon(pruned) == canon(full)
    assert canon(jax_pruned) == canon(full)
    assert ps.prune_stats["windows"] > 0
    assert ps.prune_stats["windows"] == js.prune_stats["windows"]
    if pool > 1:
        assert ps.window_path_counts.get("pool", 0) > 0


def test_tight_k_on_a_pool_escalates_each_partition_on_the_row_walk():
    """K far too small on a partitioned pool: certificates fail, each
    failed partition re-solves on the row walk over the dense base (never
    on the host greedy: the card did not fail), and the decisions still
    equal the unpruned single device's and the JAX package's."""
    rng = np.random.default_rng(9)
    names = [f"n{i:03d}" for i in range(128)]
    half = names[:64], names[64:]
    plain_batches = [
        random_windows(rng, names, 2, 4, domains=half, fifo_rows=True)
        for _ in range(3)
    ]
    plain_usages = [{}] + [random_usage(rng, names) for _ in range(2)]

    def scenario(pkg, **kw):
        batches, usages = materialize(pkg, plain_batches, plain_usages)
        s = solver(pkg, **kw)
        return run_sequential(s, nodes_of(pkg, 128, zones=3), batches, usages), s

    full, _ = scenario(JAX, prune_top_k=0)
    tight, s = scenario(PORT, pool=2, prune_top_k=1, prune_slack=0.01)
    assert canon(tight) == canon(full)
    assert s.prune_stats["windows"] > 0
    assert s.prune_stats["escalations"] > 0, s.prune_stats
    assert "greedy-fallback" not in s.window_path_counts


@pytest.mark.parametrize("prune", [0, 4])
def test_killed_part_of_a_fused_pooled_dispatch_redispatches(prune):
    """A slot dies under one part of a fused dispatch on a partitioned
    pool (pruned or not): the part re-solves on the survivor and every
    view's decisions equal the sequential single device's."""
    rng = np.random.default_rng(44 + prune)
    names = [f"n{i:03d}" for i in range(64)]
    half = names[:32], names[32:]
    plain_batches = [
        random_windows(rng, names, 3, 2, domains=half, fifo_rows=True)
        for _ in range(2)
    ]
    plain_usages = [{}, random_usage(rng, names)]
    batches, usages = materialize(PORT, plain_batches, plain_usages)
    nodes = nodes_of(PORT, 64)
    want = run_sequential(solver(PORT), nodes, batches, usages)
    s = solver(PORT, pool=2, prune_top_k=prune, prune_slack=0.5)
    f = mod(PORT, "faults")
    with f.FaultInjector(f.FaultPlan(seed=0, specs=[f.FaultSpec(
        surface="device.dispatch", mode="error", at=[1], limit=1,
    )])) as inj:
        inj.install_device()
        got = run_fused(s, nodes, batches, usages)
    assert canon(got) == canon(want)
    assert s.redispatch_count == 1
    assert s.device_health()["healthy"] == 1
    assert s.probe_quarantined(force=True) == 1


def test_whole_window_slots_catch_up_a_static_row_delta():
    """Windows that do not partition (no domain pinned) solve whole on the
    next slot over its resident statics; a node cordoned and one uncordoned
    between windows ride a static row delta, and a slot whose replica
    lags catches up by scattering the journal's rows ("delta") instead of
    a full upload. Decisions equal the single device's and the JAX
    package's pool."""
    rng = np.random.default_rng(21)
    names = [f"n{i:03d}" for i in range(32)]
    plain = [random_windows(rng, names, 1, 3, fifo_rows=True) for _ in range(6)]

    def scenario(pkg, pool):
        s = solver(pkg, pool)
        nodes = nodes_of(pkg, 32)
        out = []
        for step, wins in enumerate(plain):
            if step in (2, 4):  # node 6 cordoned, then uncordoned
                nodes[6] = type(nodes[6])(**{**nodes[6].__dict__,
                                             "unschedulable": step == 2})
            out += run_sequential(s, nodes, [build(pkg, wins)], [{}])
        return out, s

    want, _ = scenario(JAX, 0)
    jax_pooled, _ = scenario(JAX, 2)
    got, s = scenario(PORT, 2)
    assert canon(jax_pooled) == canon(want)
    assert canon(got) == canon(want)
    assert s.device_state_stats["static_delta_uploads"] == 2
    stats = s.device_pool_stats()
    assert sum(v["delta"] for v in stats.values()) >= 1, stats
