"""Synthetic workload generators emitting replayable traces.

The port's copy of spark_scheduler_tpu/replay/generators.py: for the same
kind, seed and sizing it writes the JAX package's trace byte for byte.

Each generator writes the SAME versioned trace format the live TraceWriter
captures, from nothing but a seed — so `python -m spark_scheduler_tpu_torch.replay
generate diurnal --seed 7` followed by `run` (replay with binding) yields a
fully captured trace, and the whole pipeline is exercisable without a
cluster, a server, or even the soak harness.

Determinism contract: same (kind, seed, sizing) → byte-identical output.
Everything varying is drawn from one `np.random.default_rng(seed)`; the
trace clock is a simulated epoch clock starting at T0 (no wall time
anywhere, header included); pod UIDs are explicit (`uid-<app>-<pod>`), so
no uuid4 sneaks in via `Pod.__post_init__`.

Scenarios
---------
  diurnal   sinusoidal arrival rate over a simulated day — static-allocation
            apps pile up at peak, drain at trough (teardown watermark).
  bursty    multi-tenant: per-tenant instance groups, long quiet gaps
            punctuated by back-to-back submission bursts from one tenant.
  churn     dynamic-allocation apps under heavy executor churn: kills
            (pod deletes), replacement executor requests against the freed
            reservations, app teardowns, periodic reconciles.

Generated traces are *input-only*: predicate windows carry `bind: true`
and no `result` events — the replay engine completes each window
immediately and binds placements itself (run mode).
"""

from __future__ import annotations

import math

import numpy as np

from spark_scheduler_tpu_torch.core.extender import ExtenderArgs
from spark_scheduler_tpu_torch.core.sparkpods import (
    DA_MAX_EXECUTOR_COUNT,
    DA_MIN_EXECUTOR_COUNT,
    DRIVER_CPU,
    DRIVER_MEMORY,
    DYNAMIC_ALLOCATION_ENABLED,
    EXECUTOR_COUNT,
    EXECUTOR_CPU,
    EXECUTOR_MEMORY,
    ROLE_DRIVER,
    ROLE_EXECUTOR,
    SPARK_APP_ID_LABEL,
    SPARK_ROLE_LABEL,
    SPARK_SCHEDULER_NAME,
)
from spark_scheduler_tpu_torch.models.kube import Container, Node, Pod, ZONE_LABEL
from spark_scheduler_tpu_torch.models.resources import Resources
from spark_scheduler_tpu_torch.replay.trace import TraceWriter
from spark_scheduler_tpu_torch.server.config import InstallConfig

INSTANCE_GROUP_LABEL = "resource_channel"
DEFAULT_GROUP = "batch-medium-priority"
T0 = 1_700_000_000.0  # simulated epoch origin — never wall time
NAMESPACE = "namespace"


def _pod(app_id, name, role, ts, group, annotations=None):
    return Pod(
        name=name,
        namespace=NAMESPACE,
        uid=f"uid-{name}",
        labels={SPARK_ROLE_LABEL: role, SPARK_APP_ID_LABEL: app_id},
        annotations=dict(annotations or {}),
        creation_timestamp=ts,
        scheduler_name=SPARK_SCHEDULER_NAME,
        node_selector={INSTANCE_GROUP_LABEL: group},
        containers=[Container(requests=Resources.from_quantities("1", "1Gi"))],
    )


class _App:
    __slots__ = ("app_id", "group", "pods", "next_exec", "annotations", "ts")

    def __init__(self, app_id, group, ts, annotations):
        self.app_id = app_id
        self.group = group
        self.ts = ts
        self.annotations = annotations
        self.pods: list[Pod] = []
        self.next_exec = 1


class _Sim:
    """Shared scenario plumbing: sim clock, node roster, app lifecycle."""

    def __init__(self, path, kind, seed, n_nodes, groups, binpack_algo):
        self.rng = np.random.default_rng(seed)
        self.t = T0
        self.writer = TraceWriter(
            path,
            clock=lambda: self.t,
            decisions=False,
            source=f"generator:{kind}",
        )
        config = InstallConfig(
            fifo=True,
            binpack_algo=binpack_algo,
            instance_group_label=INSTANCE_GROUP_LABEL,
            sync_writes=True,
        )
        self.writer.write_header(
            config,
            meta={
                "generator": kind,
                "seed": int(seed),
                "n_nodes": int(n_nodes),
                # replay is purely event-driven; don't let the simulated
                # multi-hour gaps trip the clock-based resync heuristic
                "resync_suppressed": True,
            },
        )
        self.nodes: list[str] = []
        zones = ("zone1", "zone2")
        for i in range(n_nodes):
            name = f"node-{i:04d}"
            self.writer.on_node_add(
                Node(
                    name=name,
                    allocatable=Resources.from_quantities(
                        "8", "8Gi", "1", round_up=False
                    ),
                    labels={
                        ZONE_LABEL: zones[i % len(zones)],
                        INSTANCE_GROUP_LABEL: groups[i % len(groups)],
                    },
                )
            )
            self.nodes.append(name)
        self.live: dict[str, _App] = {}

    def advance(self, dt) -> None:
        self.t += max(0.0, float(dt))

    def _window(self, pods) -> None:
        for p in pods:
            self.writer.on_pod_add(p)
        self.writer.on_predicate(
            [ExtenderArgs(pod=p, node_names=list(self.nodes)) for p in pods],
            mode="window",
            bind=True,
        )

    def submit(self, app_id, n_exec, group=DEFAULT_GROUP, dynamic=False,
               max_exec=None) -> _App:
        if dynamic:
            ann = {
                DRIVER_CPU: "1",
                DRIVER_MEMORY: "1Gi",
                EXECUTOR_CPU: "1",
                EXECUTOR_MEMORY: "1Gi",
                DYNAMIC_ALLOCATION_ENABLED: "true",
                DA_MIN_EXECUTOR_COUNT: str(n_exec),
                DA_MAX_EXECUTOR_COUNT: str(max_exec or n_exec),
            }
        else:
            ann = {
                DRIVER_CPU: "1",
                DRIVER_MEMORY: "1Gi",
                EXECUTOR_CPU: "1",
                EXECUTOR_MEMORY: "1Gi",
                EXECUTOR_COUNT: str(n_exec),
            }
        app = _App(app_id, group, self.t, ann)
        driver = _pod(app_id, f"{app_id}-driver", ROLE_DRIVER, app.ts, group, ann)
        app.pods.append(driver)
        self._window([driver])
        count = n_exec if not dynamic else (max_exec or n_exec)
        batch: list[Pod] = []
        for _ in range(count):
            e = self.new_executor(app)
            batch.append(e)
            if len(batch) == 6:
                self._window(batch)
                batch = []
        if batch:
            self._window(batch)
        self.live[app_id] = app
        return app

    def new_executor(self, app: _App) -> Pod:
        e = _pod(
            app.app_id,
            f"{app.app_id}-exec-{app.next_exec}",
            ROLE_EXECUTOR,
            app.ts,
            app.group,
        )
        app.next_exec += 1
        app.pods.append(e)
        return e

    def kill_executor(self, app: _App) -> None:
        execs = [
            p for p in app.pods
            if p.labels.get(SPARK_ROLE_LABEL) == ROLE_EXECUTOR
        ]
        if not execs:
            return
        victim = execs[int(self.rng.integers(0, len(execs)))]
        app.pods.remove(victim)
        self.writer.on_pod_delete(victim)

    def teardown(self, app_id) -> None:
        app = self.live.pop(app_id, None)
        if app is None:
            return
        for p in app.pods:
            self.writer.on_pod_delete(p)
        self.writer.emit_rr_delete(NAMESPACE, app_id)

    def finish(self) -> dict:
        self.writer.emit_reconcile()
        stats = self.writer.stats()
        self.writer.close()
        return stats


def gen_diurnal(path, seed, n_nodes=24, apps=48,
                binpack_algo="single-az-tightly-pack") -> dict:
    sim = _Sim(path, "diurnal", seed, n_nodes, (DEFAULT_GROUP,), binpack_algo)
    order: list[str] = []
    for i in range(apps):
        day_frac = ((sim.t - T0) % 86400.0) / 86400.0
        # peak (midday) ~9x trough arrival rate
        rate = 0.1 + 0.9 * (0.5 - 0.5 * math.cos(2 * math.pi * day_frac))
        sim.advance(sim.rng.exponential(400.0 / rate))
        app_id = f"diurnal-{i:04d}"
        sim.submit(app_id, int(sim.rng.integers(2, 7)))
        order.append(app_id)
        # drain the backlog: completed apps leave as new ones arrive
        while len(sim.live) > 10:
            sim.advance(sim.rng.exponential(30.0))
            sim.teardown(order.pop(0))
    for app_id in order[: len(order) // 2]:
        sim.advance(sim.rng.exponential(60.0))
        sim.teardown(app_id)
    return sim.finish()


def gen_bursty(path, seed, n_nodes=24, bursts=10,
               binpack_algo="single-az-tightly-pack") -> dict:
    tenants = ("tenant-a", "tenant-b", "tenant-c")
    sim = _Sim(path, "bursty", seed, n_nodes, tenants, binpack_algo)
    n = 0
    order: list[str] = []
    for b in range(bursts):
        sim.advance(sim.rng.exponential(1800.0))  # quiet gap
        tenant = tenants[int(sim.rng.integers(0, len(tenants)))]
        for _ in range(int(sim.rng.integers(3, 8))):
            sim.advance(sim.rng.exponential(2.0))  # back-to-back
            app_id = f"{tenant}-{n:04d}"
            n += 1
            sim.submit(app_id, int(sim.rng.integers(1, 5)), group=tenant)
            order.append(app_id)
        while len(sim.live) > 12:
            sim.teardown(order.pop(0))
    return sim.finish()


def gen_churn(path, seed, n_nodes=16, steps=120,
              binpack_algo="single-az-tightly-pack") -> dict:
    sim = _Sim(path, "churn", seed, n_nodes, (DEFAULT_GROUP,), binpack_algo)
    n = 0
    for _ in range(steps):
        sim.advance(sim.rng.exponential(45.0))
        ids = sorted(sim.live)
        op = sim.rng.random()
        if op < 0.35 or not ids:
            app_id = f"churn-{n:04d}"
            n += 1
            lo = int(sim.rng.integers(1, 4))
            sim.submit(app_id, lo, dynamic=True,
                       max_exec=lo + int(sim.rng.integers(0, 4)))
        elif op < 0.70:
            app = sim.live[ids[int(sim.rng.integers(0, len(ids)))]]
            sim.kill_executor(app)
            if sim.rng.random() < 0.6:
                # dynamic allocation asks for a replacement executor
                sim.advance(sim.rng.exponential(5.0))
                sim._window([sim.new_executor(app)])
        elif op < 0.90:
            sim.teardown(ids[int(sim.rng.integers(0, len(ids)))])
        else:
            sim.writer.emit_reconcile()
    return sim.finish()


GENERATORS = {
    "diurnal": gen_diurnal,
    "bursty": gen_bursty,
    "churn": gen_churn,
}


def generate(kind: str, path: str, seed: int, **sizing) -> dict:
    try:
        fn = GENERATORS[kind]
    except KeyError:
        raise ValueError(
            f"unknown generator {kind!r}; have {sorted(GENERATORS)}"
        ) from None
    return fn(path, seed, **sizing)
