"""GET /debug/state — one point-in-time snapshot of the scheduler's world.

The reference's operators reconstruct this by joining four kubectl queries
(reservations, demands, pending pods, node list); here it is one gated
endpoint: hard reservations (driver + executor slots with bound pods), soft
reservations, the FIFO queue in enforcement order with per-driver queue
positions, the unschedulable set (PodExceedsClusterCapacity), the demand
ledger, and the node fleet (with the autoscaler's view when it runs
in-process). Point-in-time, not transactional: each section lists its own
store, the same consistency every reporter tick has.

The port's copy of spark_scheduler_tpu/observability/state.py. It reports
what the port's app has: the autoscaler's fleet view and its `census`
block and the `faults` block (device-slot quarantine, re-dispatches, the
degraded-mode controller) and the trace sink's `trace` block as in the
JAX package; the solver section names the device, how each
window was served and the pool's per-slot state, the prune section the
two-tier solve's ledger, and the server section the transport and the
ingest lane.
"""

from __future__ import annotations

import time

from spark_scheduler_tpu_torch.core.sparkpods import (
    SPARK_APP_ID_LABEL,
    find_instance_group,
)
from spark_scheduler_tpu_torch.core.unschedulable import (
    POD_EXCEEDS_CLUSTER_CAPACITY_CONDITION,
)


def debug_state_snapshot(app, clock=time.time, server=None) -> dict:
    """The snapshot of `app`; with `server` (the SchedulerHTTPServer in
    front of it) also its transport and ingest lane."""
    now = clock()

    hard = []
    for rr in app.rr_cache.list():
        hard.append(
            {
                "namespace": rr.namespace,
                "name": rr.name,
                "reservations": {
                    slot: r.node for slot, r in rr.spec.reservations.items()
                },
                "bound_pods": dict(rr.status.pods),
            }
        )

    soft = {
        app_id: {name: r.node for name, r in sr.reservations.items()}
        for app_id, sr in app.soft_store.get_all_copy().items()
    }

    ig_label = app.pod_lister.instance_group_label
    fifo = []
    for pos, pod in enumerate(app.pod_lister.list_pending_drivers()):
        fifo.append(
            {
                "position": pos,
                "namespace": pod.namespace,
                "name": pod.name,
                "app_id": pod.labels.get(SPARK_APP_ID_LABEL, ""),
                "instance_group": find_instance_group(pod, ig_label) or "",
                "age_s": round(max(0.0, now - pod.creation_timestamp), 3),
            }
        )

    unschedulable = []
    for pod in app.backend.list_pods():
        cond = pod.get_condition(POD_EXCEEDS_CLUSTER_CAPACITY_CONDITION)
        if cond is not None and cond.status:
            unschedulable.append(
                {"namespace": pod.namespace, "name": pod.name}
            )

    try:
        demand_objs = app.backend.list("demands")
    except Exception:  # backend without the Demand CRD surface
        demand_objs = []
    demands = [
        {
            "namespace": d.namespace,
            "name": d.name,
            "phase": d.status.phase,
            "instance_group": d.spec.instance_group,
        }
        for d in demand_objs
    ]

    nodes = app.backend.list_nodes()
    by_zone: dict[str, int] = {}
    schedulable = 0
    for n in nodes:
        by_zone[n.zone] = by_zone.get(n.zone, 0) + 1
        if not n.unschedulable and n.ready:
            schedulable += 1
    fleet = {
        "count": len(nodes),
        "schedulable": schedulable,
        "by_zone": by_zone,
    }
    if app.autoscaler is not None:
        fleet["autoscaler"] = {
            "enabled": True,
            "max_cluster_size": app.autoscaler.max_cluster_size,
        }

    out = {
        "time": now,
        "hard_reservations": hard,
        "soft_reservations": soft,
        "fifo_queue": fifo,
        "unschedulable": unschedulable,
        "demands": demands,
        "nodes": fleet,
    }
    recorder = getattr(app, "recorder", None)
    if recorder is not None:
        out["flight_recorder"] = recorder.stats()
    trace_writer = getattr(app, "trace_writer", None)
    if trace_writer is not None:
        out["trace"] = trace_writer.stats()
    features = getattr(getattr(app, "extender", None), "features", None)
    if features is not None:
        # Host feature store: how often per-window featurize actually
        # re-walked state vs served the resident snapshot (the O(changed)
        # evidence, live).
        out["feature_store"] = features.stats()
    solver = getattr(app, "solver", None)
    if solver is not None:
        # The device the solver serves on and which path served each
        # dispatched window ("cuda": the row-walk kernel; "reference":
        # its plain version on the CPU).
        out["solver"] = {
            "device": str(solver.device),
            "window_paths": dict(solver.window_path_counts),
            "last_state_upload": solver.last_state_upload,
            "pool": solver.device_pool_stats(),
        }
        # Fault tolerance: device-slot quarantine state, the degraded-mode
        # controller, and how many parts were re-dispatched onto a
        # survivor — the operator's first stop when readiness reports
        # degraded.
        faults = {
            "device": solver.device_health(),
            "redispatches": solver.redispatch_count,
        }
        degraded = getattr(solver, "degraded", None)
        if degraded is not None:
            faults["degraded"] = degraded.snapshot()
        out["faults"] = faults
        prune = getattr(solver, "prune_stats", None)
        if prune is not None and prune.get("windows"):
            # Two-tier solve: pruned-window volume, kept-row ratio, the
            # certificate-escalation ledger by reason, and the O(K +
            # changed) planner evidence (phase-time means, reuse hits,
            # rows scanned). The nested reasons ledger is copied: a
            # concurrent escalation must not resize it under this
            # snapshot's JSON serialization.
            windows = max(int(prune.get("windows", 0)), 1)
            block = {**prune, "reasons": dict(prune["reasons"])}
            for phase in ("plan", "gather", "offset"):
                block[f"{phase}_ms_mean"] = round(
                    prune.get(f"{phase}_ms", 0.0) / windows, 4
                )
            planner = getattr(solver, "_planner", None)
            if planner is not None:
                block["planner"] = planner.index_stats()
            out["prune"] = block
        # The window-solve pool per slot label (a mesh slot's `cuda:0-3`)
        # and the scale tier's re-solve ledger once engaged, under the JAX
        # package's keys.
        pool_stats = solver.device_pool_stats()
        if pool_stats:
            out["device_pool"] = pool_stats
        scale = getattr(solver, "scale_tier_stats", None)
        if scale is not None and any(scale.values()):
            out["scale_tier"] = dict(scale)
        # Device-state upload mix: full uploads, availability and static
        # row deltas, reuses, and their h2d bytes.
        dev_state = getattr(solver, "device_state_stats", None)
        if dev_state is not None:
            out["device_state"] = dict(dev_state)
        # The host tensor build: pipelined builds and their wall time, the
        # dense-sweep against the dirty-set row ledgers, incremental builds
        # against full snapshots, the rows pooled fetches debited.
        build = getattr(solver, "build_stats", None)
        if build is not None and build.get("builds"):
            block = dict(build)
            block["build_ms_mean"] = round(
                build["build_ms"] / max(int(build["builds"]), 1), 4
            )
            out["build"] = block
    autoscaler = getattr(app, "autoscaler", None)
    census = getattr(autoscaler, "_census", None)
    if census is not None:
        # Control-loop census: the resident node/busy/reserved mirrors the
        # autoscaler and drainer read instead of per-pass full walks.
        out["census"] = census.stats()
    if server is not None:
        # The serving front end: which transport frames requests and which
        # ingest lane decodes predicate bodies (the native lane's decode
        # counters with it).
        out["server"] = {
            "transport": server.transport_name,
            "ingest": server.ingest_stats(),
        }
    return out
