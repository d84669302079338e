"""The scheduling flight recorder.

Every extender decision appends one `DecisionRecord` to a bounded
thread-safe ring. The record answers the operator questions the final
verdict alone cannot (SURVEY.md §0): why was this app denied, on which
nodes, at what FIFO queue position, which dispatch and padding bucket
served it, and how long did each phase
(featurize -> solve -> commit) take. Queryable at GET /debug/decisions;
the autoscaler annotates records whose demand it later fulfilled, closing
the denied -> demand -> scale-up -> fulfilled story on one object.

Appends are O(1) under one lock (a dict build + deque append) — the
recorder rides the serving hot path, and bench.py's recorder-overhead
section measures, rather than assumes, that this stays in the noise.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import deque
from typing import Any, Optional

# Sentinel key marking a failure map truncated to MAX_FAILED_NODES — never
# a real node name ("..." is not a valid k8s object name).
TRUNCATION_KEY = "..."

# Verdicts whose denial creates a Demand (extender: failed gang admission /
# executor reschedule) — the only records a fulfilled demand can originate
# from, and so the only ones annotate_demand_fulfilled may stamp.
DEMAND_CREATING_VERDICTS = frozenset(
    {"failure-fit", "failure-earlier-driver"}
)


def _truncation_marker(omitted: int) -> str:
    return f"truncated: {omitted} more nodes with the same verdict"


@dataclasses.dataclass
class DecisionRecord:
    """One extender decision, explained."""

    seq: int
    time: float
    namespace: str
    pod_name: str
    app_id: str
    instance_group: str
    role: str
    verdict: str
    node: Optional[str] = None
    message: str = ""
    # Per-node failure-reason map (the extender protocol's FailedNodes) —
    # empty on success.
    failed_nodes: dict[str, str] = dataclasses.field(default_factory=dict)
    # Number of earlier pending FIFO drivers this request re-packed
    # (None when FIFO is off or the path doesn't consult the queue).
    queue_position: Optional[int] = None
    # {"featurize_ms", "solve_ms", "commit_ms"} — whichever phases ran.
    phases: dict[str, float] = dataclasses.field(default_factory=dict)
    # Solver dispatch info: {"path", "nodes", "rows", "row_bucket", "emax",
    # "compile_cache_hit"} when a device solve served the decision.
    solve: Optional[dict[str, Any]] = None
    # Which pool slot solved this decision's window (partition), e.g.
    # "cpu:1" — None outside the multi-device engine. Lets /debug/decisions
    # attribute a latency outlier to one device.
    device_id: Optional[str] = None
    # Fused multi-window dispatch: how many serving windows shared this
    # decision's device dispatch (1 = unfused), and the solver's monotone
    # id of that dispatch — every decision of one fused batch shares the
    # id, so /debug/decisions groups the K windows one round trip served.
    fused_k: Optional[int] = None
    dispatch_id: Optional[int] = None
    # How the solve's cluster state reached the device: "full" re-upload,
    # "delta" row scatter, or "reuse" of the resident replica — a "full"
    # on a latency outlier marks a cold device replica.
    state_upload: Optional[str] = None
    # Set by the autoscaler when the demand this denial created is
    # fulfilled: {"fulfilled_at", "latency_s"}.
    demand: Optional[dict[str, float]] = None
    # Fault-tolerance provenance: True when NO device solved
    # this decision (the host greedy fallback served it under the
    # degraded-mode policy), and how many device-slot re-dispatches the
    # decision's window survived (None/0 = clean dispatch).
    degraded: Optional[bool] = None
    redispatches: Optional[int] = None
    # Policy subsystem: eviction set + costs when a preemption
    # search fired for this decision ({evicted, candidates, searched,
    # cost, search_ms}); None on the (default) no-policy path.
    preemption: Optional[dict] = None

    def to_dict(self) -> dict:
        # NOT dataclasses.asdict: its recursive deep-copy costs ~100x a
        # shallow copy and rides the serving path via the trace sink.
        out = dict(self.__dict__)
        out["failed_nodes"] = dict(self.failed_nodes)
        out["phases"] = {k: round(v, 3) for k, v in self.phases.items()}
        for key in ("solve", "demand", "preemption"):
            v = out[key]
            if v is not None:
                out[key] = dict(v)
        return out


class FlightRecorder:
    """Bounded ring of DecisionRecords + query/annotate surface."""

    # Per-record bound on the stored failure map: the reason message is
    # near-always uniform across nodes, and an unbounded map at 10k nodes
    # x 2048 ring slots is gigabytes. The extender's wire response keeps
    # the full map either way; the record keeps the first
    # MAX_FAILED_NODES entries plus a truncation marker with the count.
    MAX_FAILED_NODES = 256

    def __init__(self, capacity: int = 2048, clock=time.time):
        self._ring: deque[DecisionRecord] = deque(maxlen=max(1, capacity))
        self._lock = threading.Lock()
        self._clock = clock
        self._seq = itertools.count(1)
        self.capacity = max(1, capacity)
        self.total_recorded = 0
        # Durable trace sink (replay/trace.TraceWriter): when
        # attached, every record is ALSO journaled to the trace stream —
        # the ring stays the bounded query surface, the sink the durable
        # one. None keeps record() on the exact pre-sink path.
        self.sink = None

    def attach_sink(self, sink) -> None:
        self.sink = sink

    def record(
        self,
        *,
        namespace: str,
        pod_name: str,
        app_id: str,
        instance_group: str,
        role: str,
        verdict: str,
        node: Optional[str] = None,
        message: str = "",
        failed_nodes: Optional[dict[str, str]] = None,
        queue_position: Optional[int] = None,
        phases: Optional[dict[str, float]] = None,
        solve: Optional[dict] = None,
        device_id: Optional[str] = None,
        state_upload: Optional[str] = None,
        fused_k: Optional[int] = None,
        dispatch_id: Optional[int] = None,
        degraded: Optional[bool] = None,
        redispatches: Optional[int] = None,
        preemption: Optional[dict] = None,
    ) -> DecisionRecord:
        if (
            failed_nodes
            and len(failed_nodes) > self.MAX_FAILED_NODES
            # A map the producer already capped (build_failure_map) —
            # re-truncating would clobber its count with an
            # off-by-the-marker one.
            and TRUNCATION_KEY not in failed_nodes
        ):
            total = len(failed_nodes)
            failed_nodes = dict(
                itertools.islice(
                    failed_nodes.items(), self.MAX_FAILED_NODES
                )
            )
            failed_nodes[TRUNCATION_KEY] = _truncation_marker(
                total - self.MAX_FAILED_NODES
            )
        rec = DecisionRecord(
            seq=next(self._seq),
            time=self._clock(),
            namespace=namespace,
            pod_name=pod_name,
            app_id=app_id,
            instance_group=instance_group,
            role=role,
            verdict=verdict,
            node=node,
            message=message,
            failed_nodes=failed_nodes or {},
            queue_position=queue_position,
            phases=phases or {},
            solve=solve,
            device_id=device_id,
            state_upload=state_upload,
            fused_k=fused_k,
            dispatch_id=dispatch_id,
            degraded=degraded,
            redispatches=redispatches,
            preemption=preemption,
        )
        with self._lock:
            self._ring.append(rec)
            self.total_recorded += 1
        s = self.sink
        if s is not None:
            s.on_decision(rec)
        return rec

    def build_failure_map(self, node_names, reason: str) -> dict[str, str]:
        """A per-node failure map capped at MAX_FAILED_NODES entries (plus
        the truncation marker), built WITHOUT materializing the full map —
        the producer-side half of the truncation protocol (record() guards
        against double-truncating a map built here)."""
        out: dict[str, str] = {}
        names = list(node_names)
        for name in names:
            if len(out) >= self.MAX_FAILED_NODES:
                out[TRUNCATION_KEY] = _truncation_marker(
                    len(names) - self.MAX_FAILED_NODES
                )
                break
            out[name] = reason
        return out

    def query(
        self,
        app: Optional[str] = None,
        verdict: Optional[str] = None,
        role: Optional[str] = None,
        namespace: Optional[str] = None,
        limit: int = 100,
        instance_group: Optional[str] = None,
        since_seq: Optional[int] = None,
    ) -> list[dict]:
        """Newest-first records matching the filters. `verdict` matches
        exactly, or by prefix when it ends with '*' ("failure-*");
        `since_seq` keeps only records NEWER than that sequence number
        (incident-triage tailing: poll with the last seq you saw)."""
        out: list[dict] = []
        with self._lock:
            records = list(self._ring)
        for rec in reversed(records):
            if since_seq is not None and rec.seq <= since_seq:
                continue
            if app is not None and rec.app_id != app:
                continue
            if namespace is not None and rec.namespace != namespace:
                continue
            if role is not None and rec.role != role:
                continue
            if instance_group is not None and rec.instance_group != instance_group:
                continue
            if verdict is not None:
                if verdict.endswith("*"):
                    if not rec.verdict.startswith(verdict[:-1]):
                        continue
                elif rec.verdict != verdict:
                    continue
            out.append(rec.to_dict())
            if len(out) >= max(1, limit):
                break
        return out

    def latest_for_app(
        self, namespace: str, app_id: str, role: str = "driver"
    ) -> Optional[DecisionRecord]:
        """The newest record for (namespace, app_id, role) — the soak's
        verdict-vs-placement cross-check reads this."""
        with self._lock:
            for rec in reversed(self._ring):
                if (
                    rec.namespace == namespace
                    and rec.app_id == app_id
                    and rec.role == role
                ):
                    return rec
        return None

    def annotate_demand_fulfilled(
        self, namespace: str, pod_name: str, latency_s: float, now: float
    ) -> bool:
        """Stamp the newest DEMAND-CREATING denial of `pod_name` with its
        demand's fulfillment — called by the autoscaler when a demand this
        scheduler created flips to fulfilled. Only fit/earlier-driver
        denials create demands, so only those match (a later
        failure-internal retry of the same pod must not swallow the
        annotation). Returns False when no matching denial is in the ring
        (aged out, or the demand predates this process)."""
        with self._lock:
            for rec in reversed(self._ring):
                if (
                    rec.namespace == namespace
                    and rec.pod_name == pod_name
                    and rec.verdict in DEMAND_CREATING_VERDICTS
                ):
                    rec.demand = {
                        "fulfilled_at": now,
                        "latency_s": round(latency_s, 6),
                    }
                    return True
        return False

    def stats(self) -> dict:
        with self._lock:
            size = len(self._ring)
        return {
            "capacity": self.capacity,
            "size": size,
            "total_recorded": self.total_recorded,
            "dropped": max(0, self.total_recorded - size),
        }
