"""The port's window-solve device pool: a serving smoke and its lifecycle,
held to the JAX package on the CPU.

The four cases of tests/test_multi_device.py, each run on both packages:
  - the real HTTP server on a two-slot pool serves a concurrent burst of
    multi-group /predicates, keeps each gang inside its group, and exports
    one `foundry.spark.scheduler.solver.device.*` series per slot;
  - close() cancels queued part solves, releases every slot's resident
    state, and a dispatch after it raises;
  - discard_pipeline() releases the pool replicas and the next window
    serves;
  - make_pool_slots clamps an oversized pool to the devices there are (the
    port's enumerator: one CPU device, every card), lays repeated devices
    out as slots of their own, and groups them into node-sharded mesh
    slots (node shards beyond the devices raise, as in the JAX package).

The JAX package's pool runs on the conftest's 8 virtual CPU devices, the
port's on two slots of the CPU (`pool_devices=["cpu"] * 2`). Decisions and
bodies must be equal across the packages. Tolerance: none.
"""

from __future__ import annotations

import http.client
import importlib
import json
import threading

import pytest
import torch

from tests.test_torch_extender import JAX, PORT, canon
from tests.test_torch_native import load_jax_native
from tests.test_torch_pool import make_harness

DEVICE_PREFIX = "foundry.spark.scheduler.solver.device."


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def pool_kw(pkg):
    return {"pool_devices": ["cpu", "cpu"], "device": "cpu"} if pkg == PORT else {}


def test_server_smoke_two_slot_pool_exports_device_series():
    def scenario(pkg):
        if pkg == JAX:
            load_jax_native()
        harness = mod(pkg, "testing.harness")
        metrics = mod(pkg, "metrics")
        kube_io = mod(pkg, "server.kube_io")
        backend = mod(pkg, "store.backend").InMemoryBackend()
        n_groups, nodes_per_group = 2, 6
        group_names: dict = {}
        for g in range(n_groups):
            group_names[g] = []
            for i in range(nodes_per_group):
                n = harness.new_node(
                    f"g{g}-n{i}", zone=f"zone{i % 2}", instance_group=f"group-{g}"
                )
                backend.add_node(n)
                group_names[g].append(n.name)
        registry = metrics.MetricRegistry()
        app = mod(pkg, "server.app").build_scheduler_app(
            backend,
            mod(pkg, "server.config").InstallConfig(
                fifo=True, sync_writes=True,
                instance_group_label=harness.INSTANCE_GROUP_LABEL,
                solver_device_pool=2,
            ),
            metrics=metrics.SchedulerMetrics(registry, harness.INSTANCE_GROUP_LABEL),
            **pool_kw(pkg),
        )
        assert app.solver.pool_size == 2
        server = mod(pkg, "server.http").SchedulerHTTPServer(
            app, registry, host="127.0.0.1", port=0, request_timeout_s=120.0
        )
        server.start()
        n_clients = 8
        errors: list = []
        results: list = [None] * n_clients

        def client(i):
            try:
                g = i % n_groups
                pod = harness.static_allocation_spark_pods(
                    f"md-{i}", 2, instance_group=f"group-{g}"
                )[0]
                backend.add_pod(pod)
                conn = http.client.HTTPConnection(
                    "127.0.0.1", server.port, timeout=120
                )
                body = json.dumps(
                    {"Pod": kube_io.pod_to_k8s(pod), "NodeNames": group_names[g]}
                ).encode()
                conn.request("POST", "/predicates", body=body)
                results[i] = json.loads(conn.getresponse().read())
                conn.close()
            except Exception as exc:  # surfaced after join
                errors.append(exc)

        try:
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(n_clients)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not errors, errors
            for i, r in enumerate(results):
                assert r and r.get("NodeNames"), (i, r)
                assert r["NodeNames"][0] in group_names[i % n_groups]
            assert app.solver.window_path_counts.get("pool", 0) >= 1
            conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
            conn.request("GET", "/metrics")
            snap = json.loads(conn.getresponse().read())
            conn.close()
            series = sorted(
                name for name, entries in snap.items()
                if isinstance(entries, list) and name.startswith(DEVICE_PREFIX)
            )
            uploads = snap.get(DEVICE_PREFIX + "uploads")
            assert uploads and snap.get(DEVICE_PREFIX + "solve.ms"), series
            devices_seen = {e["tags"]["device"] for e in uploads}
            assert len(devices_seen) >= 2, uploads
        finally:
            server.stop()
        assert app.solver._pipe is None
        for slot in app.solver._pool.slots:
            assert slot.statics is None and not slot.sub_statics
        # Which client lands in which window depends on the threads'
        # timing (and so do the series a window's timing feeds, such as a
        # slot's resident age); the per-slot series every served window
        # writes, and each gang's placement in its group, do not.
        required = ("uploads", "solve.ms", "fetch.ms", "inflight")
        return {"series": [DEVICE_PREFIX + k in series for k in required],
                "ok": [bool(r["NodeNames"]) for r in results]}

    assert canon(scenario(PORT)) == canon(scenario(JAX))


def _two_group_harness(pkg):
    harness = mod(pkg, "testing.harness")
    h = make_harness(pkg, 2, binpack_algo="tightly-pack", fifo=False)
    for g in range(2):
        h.add_nodes(*[
            harness.new_node(f"g{g}-n{i}", instance_group=f"group-{g}")
            for i in range(4)
        ])
    return h


def _args(pkg, h, prefix, groups):
    harness = mod(pkg, "testing.harness")
    ext = mod(pkg, "core.extender")
    out = []
    for g in groups:
        pod = harness.static_allocation_spark_pods(
            f"{prefix}-{g}", 2, instance_group=f"group-{g}"
        )[0]
        h.add_pods(pod)
        out.append(ext.ExtenderArgs(
            pod=pod, node_names=[f"g{g}-n{i}" for i in range(4)]
        ))
    return out


def test_close_cancels_queued_work_and_releases_state():
    def scenario(pkg):
        h = _two_group_harness(pkg)
        results = h.extender.predicate_batch(_args(pkg, h, "cl", (0, 1)))
        assert all(r.ok for r in results)
        solver = h.app.solver
        assert any(s.statics or s.sub_statics for s in solver._pool.slots)
        solver.close()
        assert solver._pipe is None and not solver._inflight_futures
        for slot in solver._pool.slots:
            assert slot.statics is None and not slot.sub_statics
        with pytest.raises(RuntimeError, match="after shutdown"):
            h.extender.predicate_batch(_args(pkg, h, "cl-fresh", (0, 1)))
        return [(r.ok, r.node_names) for r in results]

    assert canon(scenario(PORT)) == canon(scenario(JAX))


def test_discard_pipeline_releases_pool_replicas():
    def scenario(pkg):
        h = _two_group_harness(pkg)
        r = h.extender.predicate_batch(_args(pkg, h, "dp", (0,)))
        assert r[0].ok
        solver = h.app.solver
        solver.discard_pipeline()
        assert solver._pipe is None
        for slot in solver._pool.slots:
            assert slot.statics is None and not slot.sub_statics
        r2 = h.extender.predicate_batch(_args(pkg, h, "dp-next", (1,)))
        assert r2[0].ok
        return [(x.ok, x.node_names) for x in r + r2]

    assert canon(scenario(PORT)) == canon(scenario(JAX))


def test_make_pool_slots_clamps_to_available_devices():
    from spark_scheduler_tpu_torch.core.solver import PlacementSolver
    from spark_scheduler_tpu_torch.parallel.mesh import (
        local_devices,
        make_pool_slots,
    )

    # The one CPU device: a 64-slot config clamps to one slot, no pool.
    cpu = local_devices("cpu")
    assert make_pool_slots(64, devices=cpu) == [torch.device("cpu")]
    assert PlacementSolver(device="cpu", device_pool=64).pool_size == 1
    assert PlacementSolver(device="cpu", mesh=(4, 1)).pool_size == 1
    # Every card there is (none here): the default enumerator.
    assert len(local_devices("cuda")) == torch.cuda.device_count()
    # Named devices: one slot each, repeats allowed, clamped to the list.
    slots = make_pool_slots(3, devices=["cpu", "cpu"])
    assert slots == [torch.device("cpu")] * 2
    pooled = PlacementSolver(device="cpu", pool_devices=["cpu"] * 3)
    assert pooled.pool_size == 3
    assert list(pooled.device_pool_stats()) == ["cpu/0", "cpu/1", "cpu/2"]
    # Node-sharded slots: node shards beyond the devices raise the JAX
    # ValueError; on named devices each S entries are one mesh slot.
    with pytest.raises(ValueError, match="exceeds the 1 available"):
        make_pool_slots(2, 4, devices=cpu)
    with pytest.raises(ValueError, match="exceeds the 1 available"):
        PlacementSolver(device="cpu", mesh=(2, 2))
    mesh_slots = make_pool_slots(2, 4, devices=["cpu"] * 8)
    assert len(mesh_slots) == 2
    assert all(s.shape == {"groups": 1, "nodes": 4} for s in mesh_slots)
    meshed = PlacementSolver(device="cpu", mesh=(2, 4), pool_devices=["cpu"] * 8)
    assert meshed.pool_size == 2
    assert [s.is_mesh for s in meshed._pool.slots] == [True, True]
    assert list(meshed.device_pool_stats()) == ["cpu:0-0/0", "cpu:0-0/1"]
    with pytest.raises(ValueError, match="solver's type"):
        PlacementSolver(device="cpu", pool_devices=["meta", "meta"])
    # The JAX package on its 8 virtual devices clamps the same way.
    from spark_scheduler_tpu.parallel.mesh import make_pool_slots as jax_slots

    assert 1 <= len(jax_slots(64)) <= 8
