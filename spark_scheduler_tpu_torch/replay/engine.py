"""Deterministic trace replay + what-if simulation.

The port's copy of spark_scheduler_tpu/replay/engine.py. A lane's app is
built on `device` ("cuda" unless the caller asks for the CPU): on the card
every replayed window runs the row-walk kernel, on the CPU its plain
version.

`replay_trace` boots a backend-free harness — an InMemoryBackend plus the
full real scheduler from `build_scheduler_app`, under the trace header's
recorded config — and re-drives the extender event-for-event:

  * node/pod events apply to the backend (tolerantly: an `add` of an
    existing object becomes an update, a `delete` of a missing one is
    skipped — mid-life traces bootstrap-journal the world they attached
    to, so the stream is self-contained either way);
  * `predicate` events dispatch serving windows through the SAME two-phase
    API the live serving loop used (`predicate_window_dispatch` /
    `predicate_window_complete`), completing each window at its recorded
    `result` event — so backend events that landed between a window's
    dispatch and its completion replay in the exact pipelined
    interleaving, epoch bumps and in-flight dedup included;
  * recorded `result` rows are compared against the replayed verdict /
    placement / normalized failure map — any divergence is a
    ReplayMismatch (strict mode raises).

The clock is the trace's: an injected ReplayClock that only logged
entries move (monotonic max of every event's recorded wall time), read by
the whole app, so age thresholds and the resync-gap heuristic see what the
live run saw and nothing of the replaying host's clock leaks in.

The per-arm machinery lives in `ReplayLane`: one lane is one replayed
scheduler app plus its event-step state (roster mirror, pending windows,
placements). `replay_trace` drives a single lane event-by-event; the
sweep driver (replay/sweep.py) drives M lanes in LOCKSTEP over one shared
decoded stream — which is why the predicate step is split into a
dispatch phase (`predicate_begin`) and a completion phase
(`predicate_finish`): the sweep dispatches every arm's window first, so
the coordinator can solve the deferred ones as one stacked solve, then
completes them. Driving the two phases back-to-back is exactly the
sequential replay.

Per-window latencies subtract the seconds the solver's telemetry books
for building the kernel libraries (ops/_build.py, read through
observability/telemetry.compile_stats) and book them separately as
`replay_compile_ms`, so a first window's kernel build stays out of the
latency quantiles.

What-if (`what_if`) replays the same trace under the recorded config and
under overrides — a thin 2-arm sweep — and diffs the two runs: placement
changes, per-arm p50/p99 decision latency, denial counts, and final-state
utilization/fragmentation. Bind events are re-pointed at the replaying
arm's OWN placements (a pod the variant placed on node Y binds to Y, not
the recorded X), so each arm's world stays self-consistent.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

from spark_scheduler_tpu_torch.replay.trace import (
    ALL_NODES,
    TraceReader,
    config_from_fingerprint,
    config_hash,
    encode_result,
)

# Config fields every replay pins regardless of what the trace recorded:
# the harness is backend-free (no kube ingestion, no WAL, no HA group, no
# background loops) and must not re-write the trace it is reading.
FORCED_FIELDS = dict(
    sync_writes=True,
    kube_api_url=None,
    conversion_webhook_url=None,
    durable_store_path=None,
    runtime_config_path=None,
    metrics_log=None,
    jax_compilation_cache_dir=None,
    cert_file=None,
    key_file=None,
    ha_enabled=False,
    autoscaler_enabled=False,
    debug_routes=False,
    trace_path=None,
)


def _compile_seconds() -> float:
    from spark_scheduler_tpu_torch.observability.telemetry import compile_stats

    return compile_stats()["seconds"]


class ReplayClock:
    """Monotonic-max clock fed by event timestamps: the whole replayed app
    reads the wall time the LIVE run saw at this point of the stream."""

    def __init__(self, t0: float = 0.0):
        self._t = t0

    def __call__(self) -> float:
        return self._t

    def set(self, t) -> None:
        if isinstance(t, (int, float)) and t > self._t:
            self._t = float(t)


class ReplayMismatchError(AssertionError):
    pass


@dataclasses.dataclass
class ReplayReport:
    """One replay arm's outcome."""

    config_hash: str = ""
    events: int = 0
    decisions: int = 0
    compared: int = 0
    mismatches: list = dataclasses.field(default_factory=list)
    uncompared_windows: int = 0
    verdict_counts: dict = dataclasses.field(default_factory=dict)
    denials: int = 0
    # (namespace, pod_name) -> node, for every placed decision
    placements: dict = dataclasses.field(default_factory=dict)
    latencies_ms: list = dataclasses.field(default_factory=list)
    torn_tail: bool = False
    malformed: int = 0
    utilization: dict = dataclasses.field(default_factory=dict)
    fragmentation: dict = dataclasses.field(default_factory=dict)
    overcommit: int = 0
    # Kernel-library build wall time booked during this arm's windows,
    # kept OUT of latencies_ms (a build is a one-time process cost, not a
    # decision latency).
    replay_compile_ms: float = 0.0

    def latency_ms(self, q: float) -> Optional[float]:
        if not self.latencies_ms:
            return None
        xs = sorted(self.latencies_ms)
        return round(xs[min(len(xs) - 1, int(q * len(xs)))], 3)

    def summary(self) -> dict:
        return {
            "config_hash": self.config_hash,
            "events": self.events,
            "decisions": self.decisions,
            "compared": self.compared,
            "mismatches": len(self.mismatches),
            "uncompared_windows": self.uncompared_windows,
            "verdicts": dict(self.verdict_counts),
            "denials": self.denials,
            "latency_p50_ms": self.latency_ms(0.50),
            "latency_p99_ms": self.latency_ms(0.99),
            "replay_compile_ms": round(self.replay_compile_ms, 3),
            "utilization": self.utilization,
            "fragmentation": self.fragmentation,
            "overcommit": self.overcommit,
            "torn_tail": self.torn_tail,
            "malformed": self.malformed,
        }

    def decision_summary(self) -> dict:
        """The deterministic subset of `summary()` — everything that is a
        DECISION, nothing that is a wall-clock measurement. Two replays of
        the same trace under the same config produce identical
        decision_summary() dicts (the sweep-determinism pin)."""
        s = self.summary()
        for k in ("latency_p50_ms", "latency_p99_ms", "replay_compile_ms"):
            s.pop(k)
        return s


class _Pending:
    """A dispatched-but-uncompleted replay window."""

    __slots__ = ("wid", "ticket", "candidates", "bind", "t0")

    def __init__(self, wid, ticket, candidates, bind, t0):
        self.wid = wid
        self.ticket = ticket
        self.candidates = candidates
        self.bind = bind
        self.t0 = t0


class ReplayLane:
    """One replay arm: a full backend-free scheduler app plus the
    event-step state that drives it.

    The event loop is factored into per-kind step methods so a caller can
    interleave MULTIPLE lanes over one decoded stream (the sweep driver).
    `predicate` is two phases — `predicate_begin` dispatches the window
    (and, for solo-mode events, completes it too: solo predicates never
    pipeline), `predicate_finish` completes immediate-bind windows or
    parks the pending ticket. A sequential caller runs them back-to-back;
    the lockstep sweep runs every lane's begin, flushes the stacked
    cross-arm solve, then every lane's finish.
    """

    def __init__(
        self,
        header: dict,
        config,
        *,
        compare: bool,
        has_result_events: bool,
        record_path: Optional[str] = None,
        candidate_memo: Optional[dict] = None,
        device="cuda",
    ):
        from spark_scheduler_tpu_torch.server.app import build_scheduler_app
        from spark_scheduler_tpu_torch.store.backend import (
            DEMAND_CRD,
            InMemoryBackend,
        )

        self.compare = compare
        self.has_result_events = has_result_events
        self.record_path = record_path
        self.report = ReplayReport(config_hash=config_hash(header["config"]))
        self.backend = InMemoryBackend()
        self.backend.register_crd(DEMAND_CRD)
        self.clock = ReplayClock(float(header.get("t") or 0.0))
        self.app = build_scheduler_app(
            self.backend, config, clock=self.clock, device=device
        )
        self.ext = self.app.extender
        if candidate_memo is not None:
            # Sweep mode: cross-lane candidate-mask memo (registry state is
            # arm-invariant, so lane 2..M reuse lane 1's mask builds). The
            # sweep shares one memo only among lanes on one device.
            self.app.solver._sweep_shared = candidate_memo
        meta = header.get("meta") or {}
        if meta.get("resync_suppressed"):
            self.ext._last_request = float("inf")
            # carry the suppression into a re-capture trace (its header is
            # written by build_scheduler_app, which doesn't know this meta)
            if self.app.trace_writer is not None:
                self.app.trace_writer.emit_meta(resync_suppressed=True)

        self.roster: list[str] = []  # mirror of the WRITER's roster, for "*"
        self.pending: list[_Pending] = []
        self.parked: dict[int, tuple] = {}  # wid -> (results, candidates, ms)
        self.placed: dict[tuple, str] = {}

    # ------------------------------------------------------------- steps

    def begin_event(self, ev: dict) -> None:
        self.report.events += 1
        self.clock.set(ev.get("t"))

    def expand(self, names) -> list[str]:
        return list(self.roster) if names == ALL_NODES else list(names)

    def _note_results(self, p: _Pending, results, ms: float) -> None:
        report, backend = self.report, self.backend
        per_decision = ms / max(1, len(results))
        for args, res in zip(p.ticket.args_list, results):
            report.decisions += 1
            report.latencies_ms.append(per_decision)
            report.verdict_counts[res.outcome] = (
                report.verdict_counts.get(res.outcome, 0) + 1
            )
            if res.outcome.startswith("failure"):
                report.denials += 1
            key = (args.pod.namespace, args.pod.name)
            if res.node_names:
                self.placed[key] = res.node_names[0]
                report.placements[key] = res.node_names[0]
            if p.bind and res.node_names:
                cur = backend.get("pods", args.pod.namespace, args.pod.name)
                if cur is not None and not cur.node_name:
                    backend.bind_pod(cur, res.node_names[0])

    def _timed(self, fn):
        """Run `fn`, returning (result, seconds) with library build time
        subtracted from the measurement and booked to replay_compile_ms."""
        c0 = _compile_seconds()
        t0 = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t0
        dc = _compile_seconds() - c0
        if dc > 0.0:
            self.report.replay_compile_ms += dc * 1e3
            dt = max(0.0, dt - dc)
        return out, dt

    def _force_complete(self, p: _Pending) -> None:
        results, secs = self._timed(
            lambda: self.ext.predicate_window_complete(p.ticket)
        )
        ms = (secs + p.t0) * 1e3
        self._note_results(p, results, ms)
        self.parked[p.wid] = (results, p.candidates, ms)

    def predicate_begin(self, ev: dict, candidates=None) -> Optional[_Pending]:
        """Dispatch one predicate event's window. Returns the pending
        window for `predicate_finish`, or None when the event completed
        entirely in this phase (solo mode). `candidates` lets the sweep
        driver pass pre-expanded per-request candidate lists (shared
        across lanes); None expands from this lane's own roster mirror."""
        from spark_scheduler_tpu_torch.core.extender import ExtenderArgs
        from spark_scheduler_tpu_torch.core.solver import PipelineDrainRequired
        from spark_scheduler_tpu_torch.server.kube_io import pod_from_k8s

        wid = ev["w"]
        if candidates is None:
            candidates = [self.expand(r["nodes"]) for r in ev["reqs"]]
        backend = self.backend

        def resolve(r):
            if "ref" in r:
                ns, name = r["ref"]
                pod = backend.get("pods", ns, name)
                if pod is None:
                    raise AssertionError(
                        f"trace ref to unknown pod {ns}/{name}"
                    )
                return pod
            return pod_from_k8s(r["pod"])

        args_list = [
            ExtenderArgs(pod=resolve(r), node_names=c)
            for r, c in zip(ev["reqs"], candidates)
        ]
        bind = bool(ev.get("bind"))
        if ev.get("mode") == "solo":
            (res, secs) = self._timed(lambda: self.ext.predicate(args_list[0]))
            ms = secs * 1e3
            p = _Pending(wid, None, candidates, bind, 0.0)
            p.ticket = type("T", (), {"args_list": args_list})()
            self._note_results(p, [res], ms)
            self.parked[wid] = ([res], candidates, ms)
            return None

        def dispatch_once():
            for _ in range(4):
                try:
                    return self.ext.predicate_window_dispatch(args_list)
                except PipelineDrainRequired:
                    # The live loop drained and retried here too; its
                    # drained results are already behind us in the stream
                    # (journaled before this predicate event), so the
                    # pending list SHOULD be empty — but mirror the
                    # contract defensively.
                    if not self.pending:
                        raise
                    self._force_complete(self.pending.pop(0))
            raise AssertionError(
                "dispatch kept raising PipelineDrainRequired"
            )

        ticket, secs = self._timed(dispatch_once)
        return _Pending(wid, ticket, candidates, bind, secs)

    def predicate_finish(self, p: Optional[_Pending]) -> None:
        if p is None:
            return
        if p.bind and not self.has_result_events:
            # Input-only (generated) trace: no result event will arrive —
            # complete immediately so binds land before the next event.
            results, secs = self._timed(
                lambda: self.ext.predicate_window_complete(p.ticket)
            )
            self._note_results(p, results, (p.t0 + secs) * 1e3)
        else:
            self.pending.append(p)

    def result(self, ev: dict) -> None:
        wid = ev["w"]
        if wid in self.parked:
            results, candidates, ms = self.parked.pop(wid)
        else:
            # Completions are FIFO: anything older than this wid in the
            # pipeline completes (parking its results) first.
            while self.pending and self.pending[0].wid != wid:
                self._force_complete(self.pending.pop(0))
            if not self.pending:
                return  # result for a window we never saw dispatch
            p = self.pending.pop(0)
            results, secs = self._timed(
                lambda: self.ext.predicate_window_complete(p.ticket)
            )
            ms = (secs + p.t0) * 1e3
            self._note_results(p, results, ms)
            candidates = p.candidates
        if self.compare:
            report = self.report
            for i, (res, rec) in enumerate(zip(results, ev["res"])):
                got = encode_result(res, candidates[i])
                if got != rec:
                    report.mismatches.append(
                        {
                            "window": wid,
                            "index": i,
                            "recorded": rec,
                            "replayed": got,
                        }
                    )
            report.compared += len(ev["res"])

    def apply(self, ev: dict) -> None:
        """Every non-predicate, non-result event kind."""
        from spark_scheduler_tpu_torch.server.kube_io import node_from_k8s, pod_from_k8s

        app, backend = self.app, self.backend
        k = ev.get("k")
        if k == "node":
            op = ev["op"]
            if op == "delete":
                name = ev["name"]
                if name in self.roster:
                    self.roster.remove(name)
                if backend.get("nodes", "", name) is not None:
                    backend.delete("nodes", "", name)
            else:
                node = node_from_k8s(ev["node"])
                if op == "add" and node.name not in self.roster:
                    self.roster.append(node.name)
                if backend.get("nodes", "", node.name) is None:
                    backend.add_node(node)
                else:
                    backend.update("nodes", node)
        elif k == "pod":
            op = ev["op"]
            if op == "delete":
                if backend.get("pods", ev["ns"], ev["name"]) is not None:
                    backend.delete("pods", ev["ns"], ev["name"])
            else:
                pod = pod_from_k8s(ev["pod"])
                if pod.node_name:
                    # Re-point binds at THIS arm's placement so the world
                    # stays self-consistent under what-if configs (under
                    # the recorded config the two coincide bit-for-bit).
                    own = self.placed.get((pod.namespace, pod.name))
                    if own is not None and own != pod.node_name:
                        pod = dataclasses.replace(pod, node_name=own)
                if backend.get("pods", pod.namespace, pod.name) is None:
                    backend.add_pod(pod)
                else:
                    backend.update_pod(pod)
        elif k == "rr":
            from spark_scheduler_tpu_torch.store.durable import _rr_from_record

            rr = _rr_from_record(ev["rr"])
            if app.rr_cache.get(rr.namespace, rr.name) is None:
                app.rr_cache.create(rr)
        elif k == "rr_delete":
            if app.rr_cache.get(ev["ns"], ev["name"]) is not None:
                app.rr_cache.delete(ev["ns"], ev["name"])
            # Directives are INPUTS the backend subscriptions can't see
            # (the writer only watches nodes/pods — scheduler-originated
            # RR writes must stay un-journaled). Forward them into a
            # re-capture trace by hand or its verify run would drift.
            if app.trace_writer is not None:
                app.trace_writer.emit_rr_delete(ev["ns"], ev["name"])
        elif k == "reconcile":
            app.reconciler.sync_resource_reservations_and_demands()
            if app.trace_writer is not None:
                app.trace_writer.emit_reconcile()
        elif k == "meta":
            if ev.get("resync_suppressed"):
                self.ext._last_request = float("inf")
            if app.trace_writer is not None:
                app.trace_writer.emit_meta(
                    **{a: b for a, b in ev.items() if a not in ("k", "s", "t")}
                )
        # decision events are informational (the recorder's own records
        # ride the replayed app's recorder) — skipped.

    def drain(self) -> None:
        while self.pending:
            self.report.uncompared_windows += 1
            self._force_complete(self.pending.pop(0))

    def finish(self, reader: TraceReader) -> ReplayReport:
        self.report.torn_tail = reader.torn_tail
        self.report.malformed = reader.malformed
        _final_state_metrics(self.app, self.backend, self.report)
        if self.record_path and self.app.trace_writer is not None:
            self.app.trace_writer.close()
        self.app.solver.close()
        return self.report


def replay_trace(
    trace_path: str,
    overrides: Optional[dict] = None,
    strict: bool = False,
    record_path: Optional[str] = None,
    progress=None,
    device="cuda",
) -> ReplayReport:
    """Re-drive one trace. `overrides` switches the run into what-if
    territory (an altered config — recorded results are then informational
    and comparison is skipped); `record_path` re-captures the replay
    through the normal TraceWriter wiring, which is how generated
    input-only traces become full captured traces (`run` mode)."""
    reader = TraceReader(trace_path)
    config = config_from_fingerprint(
        reader.header["config"],
        overrides=overrides,
        forced={**FORCED_FIELDS, "trace_path": record_path},
    )
    # Input-only traces (generators) carry bind-predicates and no result
    # events; captured traces carry result events (and re-captured "run"
    # traces both). Sniff which shape this stream is once, up front.
    events = list(reader.events())
    has_results = any(ev.get("k") == "result" for ev in events)
    lane = ReplayLane(
        reader.header,
        config,
        compare=not overrides,
        has_result_events=has_results,
        record_path=record_path,
        device=device,
    )
    for ev in events:
        lane.begin_event(ev)
        if progress is not None and lane.report.events % 5000 == 0:
            progress(lane.report.events)
        k = ev.get("k")
        if k == "predicate":
            lane.predicate_finish(lane.predicate_begin(ev))
        elif k == "result":
            lane.result(ev)
        else:
            lane.apply(ev)
    lane.drain()
    report = lane.finish(reader)
    if strict and report.mismatches:
        raise ReplayMismatchError(
            f"{len(report.mismatches)} replay mismatches "
            f"(of {report.compared} compared decisions); first: "
            f"{report.mismatches[0]}"
        )
    return report


def _final_state_metrics(app, backend, report: ReplayReport) -> None:
    """End-of-trace cluster posture: reserved utilization, stranded free
    capacity on partially-used nodes (the fragmentation proxy a binpack
    strategy moves), and the over-commit invariant."""
    from spark_scheduler_tpu_torch.testing.harness import overcommit_violations

    nodes = backend.list_nodes()
    if not nodes:
        return
    usage = app.reservation_manager.get_reserved_resources()
    total = {"cpu": 0.0, "memory": 0.0}
    used = {"cpu": 0.0, "memory": 0.0}
    stranded = {"cpu": 0.0, "memory": 0.0}
    for n in nodes:
        total["cpu"] += n.allocatable.cpu_milli
        total["memory"] += n.allocatable.mem_kib
        u = usage.get(n.name)
        if u is None:
            continue
        used["cpu"] += u.cpu_milli
        used["memory"] += u.mem_kib
        if u.cpu_milli > 0 or u.mem_kib > 0:
            stranded["cpu"] += max(0, n.allocatable.cpu_milli - u.cpu_milli)
            stranded["memory"] += max(0, n.allocatable.mem_kib - u.mem_kib)
    report.utilization = {
        r: round(used[r] / total[r], 4) if total[r] else 0.0 for r in total
    }
    report.fragmentation = {
        r: round(stranded[r] / total[r], 4) if total[r] else 0.0
        for r in total
    }
    try:
        report.overcommit = len(overcommit_violations(app, backend))
    except Exception:
        report.overcommit = -1


# ----------------------------------------------------------------- what-if


def what_if(trace_path: str, overrides: dict, device="cuda") -> dict:
    """Replay under the recorded config AND under `overrides`; emit the
    structured diff report. This is a thin 2-arm wrapper over the sweep driver — the base arm replays once
    and both arms share the decoded stream, roster build, and candidate
    masks — with the output schema unchanged. The base arm's mismatch
    count doubles as the report's confidence check: a non-zero base
    mismatch means the trace itself doesn't replay cleanly and every
    delta should be read with suspicion."""
    from spark_scheduler_tpu_torch.replay.sweep import run_sweep

    sweep = run_sweep(trace_path, [{}, dict(overrides)], device=device)
    base, variant = sweep.reports
    return _whatif_diff(trace_path, overrides, base, variant)


def _whatif_diff(
    trace_path: str,
    overrides: dict,
    base: ReplayReport,
    variant: ReplayReport,
) -> dict:
    same = changed = 0
    moves = []
    for key, node in base.placements.items():
        v = variant.placements.get(key)
        if v is None:
            continue
        if v == node:
            same += 1
        else:
            changed += 1
            if len(moves) < 50:
                moves.append(
                    {"pod": f"{key[0]}/{key[1]}", "base": node, "variant": v}
                )
    only_base = sum(
        1 for k in base.placements if k not in variant.placements
    )
    only_variant = sum(
        1 for k in variant.placements if k not in base.placements
    )

    def delta(a, b):
        if a is None or b is None:
            return None
        return round(b - a, 4)

    return {
        "trace": trace_path,
        "overrides": dict(overrides),
        "base_config_hash": base.config_hash,
        "base_mismatches": len(base.mismatches),
        "decisions": {"base": base.decisions, "variant": variant.decisions},
        "verdicts": {
            "base": dict(base.verdict_counts),
            "variant": dict(variant.verdict_counts),
        },
        "denials": {
            "base": base.denials,
            "variant": variant.denials,
            "delta": variant.denials - base.denials,
        },
        "placements": {
            "same": same,
            "changed": changed,
            "only_base": only_base,
            "only_variant": only_variant,
            "moves_sample": moves,
        },
        "latency_ms": {
            "base": {"p50": base.latency_ms(0.5), "p99": base.latency_ms(0.99)},
            "variant": {
                "p50": variant.latency_ms(0.5),
                "p99": variant.latency_ms(0.99),
            },
            "p50_delta": delta(base.latency_ms(0.5), variant.latency_ms(0.5)),
            "p99_delta": delta(base.latency_ms(0.99), variant.latency_ms(0.99)),
        },
        "utilization": {
            "base": base.utilization,
            "variant": variant.utilization,
            "cpu_delta": delta(
                base.utilization.get("cpu"), variant.utilization.get("cpu")
            ),
        },
        "fragmentation": {
            "base": base.fragmentation,
            "variant": variant.fragmentation,
            "cpu_delta": delta(
                base.fragmentation.get("cpu"),
                variant.fragmentation.get("cpu"),
            ),
        },
        "overcommit": {"base": base.overcommit, "variant": variant.overcommit},
    }
