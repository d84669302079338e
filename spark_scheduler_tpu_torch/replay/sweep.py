"""Batched multi-arm what-if: one trace, M config arms, lockstep replay
with stacked cross-arm window solves.

The port's copy of spark_scheduler_tpu/replay/sweep.py. Almost everything
a replay does is decision-independent: the event decode, the roster
mirror, the registry interning order, the statics, and the candidate
masks are functions of the INPUT stream (node events are inputs, not
decisions), so they are arm-invariant. Only the availability carry —
what each arm's decisions subtracted — differs. `run_sweep` exploits that
split:

  * **Stream dedup.** Arms whose configs differ only in identity-pinned
    knobs (prune top-k/slack, delta statics, device pool, autoscaler
    tuning — every field the equivalence suites pin byte-identical) map
    to one decision STREAM: the trace replays once per stream, and each
    arm clones its stream's report.
  * **Lockstep lanes over one shared build.** Each stream is a
    `ReplayLane` (replay/engine.py) — a full, real scheduler app on the
    sweep's device. All lanes step through ONE decoded event list;
    predicate candidates expand once from the driver's shared roster
    mirror (a digest-keyed list the candidate-mask memo keys without
    hashing every name), and the lanes share one cross-lane
    candidate-mask memo (`solver._sweep_shared`).
  * **Stacked window solves on the CPU.** The predicate step is
    two-phase: every lane DISPATCHES its window, then the coordinator
    flushes. On a CPU solver a pipelined window defers into this
    coordinator (the solver's `_dispatch_lane`), and payloads whose app
    batches and statics digest-match are stacked `[M, N, 3]` and solved
    in one `ops/batched.arm_stacked_fifo_pack` call with one host copy
    of all arms' blobs. Equal fills are grouped, never branched on per
    arm. Payloads that diverge fall back to per-lane solves (the
    `lane_fallbacks` counter). On a CUDA solver the row-walk kernel
    serves every window, as the Pallas kernel does on a TPU in the JAX
    package: no window defers, `stacked_dispatches` stays 0, and each
    arm's windows run the row walk.
  * **Certified pruning as sweep fuel.** Streams whose strategy is
    prune-eligible ride the two-tier top-K solve even when the arm itself
    did not ask for it (`accelerate=True`): pruned decisions are
    certificate-verified at fetch with exact escalation, so they are
    byte-identical by construction. `accelerate=False` opts out.
  * **Builds booked separately.** Sweep lanes pad deferred windows' rows
    at quantum 8 (serving keeps 32), and every flush books kernel-library
    build time to `replay_compile_ms` instead of the solve time.

Correctness bar (tests/test_torch_replay_sweep.py): every arm's
verdicts/placements equal its own sequential `replay_trace()` under the
same config, and the JAX package's sweep. The serving path never sees any
of this — `_dispatch_lane` / `_sweep_shared` are None outside this driver
(the fleet dispatch coordinator, fleet/dispatch.py, installs its own
lane on fleet serving solvers when stacking is enabled).

CLI: `python -m spark_scheduler_tpu_torch.replay sweep TRACE
--grid binpack-algo=tightly-pack,distribute-evenly --set ... [--markdown]
[--device cpu]`.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import itertools
import time
from typing import Optional

import numpy as np
import torch

from spark_scheduler_tpu_torch.core.device_pool import PendingBase
from spark_scheduler_tpu_torch.replay.engine import (
    FORCED_FIELDS,
    ReplayLane,
    _compile_seconds,
)
from spark_scheduler_tpu_torch.replay.trace import (
    ALL_NODES,
    TraceReader,
    config_from_fingerprint,
)

# Config fields that cannot move decisions: the repo's equivalence suites
# pin each of them byte-identical (prune: certificate-verified with exact
# escalation; delta statics / scale tier / lazy warm start: delta-vs-full
# and parity suites; the flight recorder only observes; device pool /
# mesh / fused dispatch: the multi-device parity suites — pooling moves
# WALL time, never bytes; autoscaler policy knobs: replay forces
# autoscaler_enabled=False (FORCED_FIELDS), so its tuning cannot reach a
# decision). Arms that differ ONLY in these share one decision stream —
# which is exactly what makes `grid_arms` sweeps over device-pool and
# autoscaler policy grids cheap: F x A arms, one decision stream.
IDENTITY_PINNED_FIELDS = frozenset(
    {
        "solver_prune_top_k",
        "solver_prune_slack",
        "solver_delta_statics",
        "solver_scale_tier",
        "solver_build_oracle",
        "solver_lazy_warm_start",
        "flight_recorder",
        "flight_recorder_capacity",
        "solver_device_pool",
        "solver_mesh_groups",
        "solver_mesh_node_shards",
        "solver_fuse_windows",
        "autoscaler_max_cluster_size",
        "autoscaler_idle_ttl_s",
        "autoscaler_poll_interval_s",
        "autoscaler_node_cpu",
        "autoscaler_node_memory",
        "autoscaler_node_gpu",
        "autoscaler_zones",
    }
)

# Identity-pinned TOPOLOGY knobs a sweep lane must not actually build:
# the stacked sweep overlaps arms its own way (one shared roster, stacked
# solves), so a pooled/meshed/fused solver inside one lane would spend
# devices and builds for zero decision delta. Stripped from every stream's
# effective overrides (decisions pinned identical by the parity suites).
_NEUTRALIZED_TOPOLOGY_FIELDS = (
    "solver_device_pool",
    "solver_mesh_groups",
    "solver_mesh_node_shards",
    "solver_fuse_windows",
)

# Top-K injected into prune-eligible streams under accelerate=True. The
# planner lower-bounds K by window demand x slack, so small windows stay
# exact-by-construction and large rosters solve [K,3] instead of [N,3].
ACCEL_PRUNE_TOP_K = 64

# Row-bucket quantum for sweep lanes' deferred windows (serving keeps
# 32): the stacked solve runs every padding row, so tight buckets save
# solve time every window.
SWEEP_ROW_BUCKET = 8

# Last completed sweep's counters, for /debug/trace (server/routing.py):
# an embedding process that ran a sweep surfaces it next to the trace
# writer's stats.
_LAST_TELEMETRY: dict = {}


def last_sweep_telemetry() -> dict:
    return dict(_LAST_TELEMETRY)


class _SharedNames(list):
    """A candidate-name list with a content-version digest: the
    candidate-mask cache keys on the digest instead of materializing and
    hashing a 10k-string tuple per request (the same fast path native
    ingest tickets get). One instance per roster version is shared by
    every request of every lane — which is what makes the cross-lane mask
    memo hit without any per-lane hashing."""

    __slots__ = ("names_digest",)

    def __init__(self, names, digest):
        super().__init__(names)
        self.names_digest = digest

    def __hash__(self):  # type: ignore[override]
        return hash(self.names_digest)

    def __eq__(self, other):
        od = getattr(other, "names_digest", None)
        if od is not None:
            return od == self.names_digest
        return list.__eq__(self, other)

    def __ne__(self, other):
        return not self.__eq__(other)


class _SweepBlobFuture:
    """Future protocol (`result`/`done`/`cancel`) for a deferred window
    blob, fulfilled by the coordinator's stacked flush. A `result()`
    before the flush force-resolves the payload singly — correct, counted
    (`forced_resolves`), and never hit by the lockstep driver itself."""

    __slots__ = ("_coord", "payload", "_value", "_done")

    def __init__(self, coord):
        self._coord = coord
        self.payload = None
        self._value = None
        self._done = False

    def _set(self, value) -> None:
        self._value = value
        self._done = True

    def result(self, timeout=None):
        if not self._done:
            self._coord._force_resolve(self.payload)
        return self._value

    def done(self) -> bool:
        return self._done

    def cancel(self) -> bool:
        return False


class _Payload:
    """One lane's deferred window: everything the flush needs to solve it
    (stacked or singly) and patch the lane's pipeline."""

    __slots__ = (
        "solver", "apps", "avail", "statics", "host",
        "fill", "emax", "num_zones", "future", "avail_after", "_key",
    )

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)
        self.avail_after = None
        self._key = None

    def group_key(self):
        """Payloads stack iff this matches: same node axis, same static
        shapes, and a content digest over the app batch AND host statics —
        the proof that the window the arms are solving is the SAME window
        (strategies that already diverged the FIFO queue produce different
        app batches and fall out into their own groups)."""
        if self._key is None:
            from spark_scheduler_tpu_torch.models.cluster import (
                cluster_statics,
            )

            h = hashlib.blake2b(digest_size=16)
            for a in self.apps:
                if a is not None:
                    h.update(np.ascontiguousarray(a).tobytes())
            for a in cluster_statics(self.host):
                h.update(np.ascontiguousarray(np.asarray(a)).tobytes())
            self._key = (
                int(self.avail.shape[0]),
                self.emax,
                self.num_zones,
                h.digest(),
            )
        return self._key


class SweepCoordinator:
    """The solver-side hook object (`solver._dispatch_lane`): collects
    every lane's deferred window between lockstep barriers, then flushes
    them as stacked cross-arm dispatches."""

    # Dispatch-lane protocol (core/solver.py): the sweep drops the
    # solvers' own quantum to 8 at lane setup, so no per-lane override.
    row_bucket_quantum = None

    def __init__(self, telemetry: dict):
        self.tel = telemetry
        self.pending: list[_Payload] = []

    def accepts(self, solver) -> bool:
        """Every window the solver offers defers (only a CPU solver's plain
        window is offered) — replay lanes run in lockstep, so a stacking
        partner is always coming."""
        return True

    # Called from PlacementSolver.pack_window_dispatch (replay-only).
    def defer_window(
        self, solver, apps, *, avail, statics, host, fill, emax, num_zones
    ):
        fut = _SweepBlobFuture(self)
        payload = _Payload(
            solver=solver, apps=apps, avail=avail, statics=statics,
            host=host, fill=fill, emax=emax, num_zones=num_zones,
            future=fut,
        )
        fut.payload = payload
        self.pending.append(payload)
        return fut, PendingBase(lambda: self._base_after(payload))

    def _base_after(self, payload: _Payload):
        """The lane's committed base after its deferred window (resolved
        by the lane's next pipelined build)."""
        payload.future.result()
        return payload.avail_after

    def _solve_single(self, payload: _Payload) -> None:
        from spark_scheduler_tpu_torch.ops.batched import (
            _packing_blob,
            batched_fifo_pack_carry,
        )

        out = batched_fifo_pack_carry(
            payload.avail, payload.statics, payload.apps,
            fill=payload.fill, emax=payload.emax,
            num_zones=payload.num_zones,
        )
        payload.avail_after = out.available_after
        payload.future._set(_packing_blob(out).cpu().numpy())

    def _solve_stacked(self, members: list[_Payload]) -> None:
        from spark_scheduler_tpu_torch.ops.batched import (
            arm_stacked_fifo_pack,
        )

        fills = tuple(pl.fill for pl in members)
        # A new stack: no lane's base is written.
        stack = torch.stack([pl.avail for pl in members])
        lead = members[0]
        blob, avail_after = arm_stacked_fifo_pack(
            stack, lead.statics, lead.apps,
            fills=fills, emax=lead.emax, num_zones=lead.num_zones,
        )
        # One host copy for every arm's decisions.
        np_blob = blob.cpu().numpy()
        for i, pl in enumerate(members):
            pl.avail_after = avail_after[i]
            pl.future._set(np_blob[i])

    def _force_resolve(self, payload: _Payload) -> None:
        self.pending.remove(payload)
        self.tel["forced_resolves"] += 1
        self._solve_single(payload)

    def flush(self) -> None:
        if not self.pending:
            return
        payloads, self.pending = self.pending, []
        c0 = _compile_seconds()
        t0 = time.perf_counter()
        groups: dict = {}
        for pl in payloads:
            groups.setdefault(pl.group_key(), []).append(pl)
        for members in groups.values():
            if len(members) == 1:
                self.tel["lane_fallbacks"] += 1
                self._solve_single(members[0])
            else:
                self.tel["stacked_dispatches"] += 1
                self.tel["stacked_arm_windows"] += len(members)
                self._solve_stacked(members)
        dc = _compile_seconds() - c0
        self.tel["replay_compile_ms"] += dc * 1e3
        self.tel["windows"] += len(payloads)
        self.tel["solve_s"] += max(0.0, time.perf_counter() - t0 - dc)


@dataclasses.dataclass
class SweepReport:
    """M arms' replay outcomes plus the shared-build/stacking evidence."""

    trace: str
    arms: list  # [{"name", "overrides", "stream"}]
    reports: list  # per-ARM ReplayReport (stream reports cloned per arm)
    telemetry: dict
    wall_s: float

    def summary(self) -> dict:
        return {
            "trace": self.trace,
            "arms": [
                {**a, "report": r.summary()}
                for a, r in zip(self.arms, self.reports)
            ],
            "telemetry": dict(self.telemetry),
            "wall_s": round(self.wall_s, 3),
        }

    def decision_summary(self) -> dict:
        """Wall-clock-free projection — identical across runs of the same
        trace + grid (the sweep-determinism pin)."""
        return {
            "trace": self.trace,
            "arms": [
                {**a, "report": r.decision_summary()}
                for a, r in zip(self.arms, self.reports)
            ],
            "dedup": {
                k: self.telemetry[k]
                for k in ("arms", "streams", "dedup_arms")
            },
        }

    def markdown(self) -> str:
        """The grid study as a GitHub table, one row per arm."""
        head = (
            "| arm | decisions | placed | denials | util cpu | frag cpu "
            "| p50 ms | p99 ms |\n"
            "|---|---|---|---|---|---|---|---|"
        )
        rows = []
        for a, r in zip(self.arms, self.reports):
            rows.append(
                f"| {a['name']} | {r.decisions} | {len(r.placements)} "
                f"| {r.denials} | {r.utilization.get('cpu', 0.0)} "
                f"| {r.fragmentation.get('cpu', 0.0)} "
                f"| {r.latency_ms(0.5)} | {r.latency_ms(0.99)} |"
            )
        t = self.telemetry
        tail = (
            f"\n{t['arms']} arms / {t['streams']} streams · "
            f"{t['windows']} stacked-path windows · "
            f"{t['stacked_dispatches']} stacked dispatches "
            f"({t['stacked_arm_windows']} arm-windows) · "
            f"{t['lane_fallbacks']} lane fallbacks · "
            f"{t['shared_build_hits']} shared-build hits · "
            f"{round(t['windows_per_s'], 1)} windows/s · "
            f"wall {round(self.wall_s, 2)} s"
        )
        return "\n".join([head] + rows) + tail


def _normalize_arms(arms) -> list[dict]:
    """Accept [{overrides}] or [{"name":..., "overrides": {...}}]; emit
    [{"name", "overrides"}] with dash-keys normalized to field names."""
    out = []
    for i, arm in enumerate(arms):
        if isinstance(arm, dict) and "overrides" in arm and (
            "name" in arm or len(arm) <= 2
        ):
            name, ov = arm.get("name"), arm["overrides"]
        else:
            name, ov = None, arm
        ov = {str(k).replace("-", "_"): v for k, v in dict(ov).items()}
        if name is None:
            name = (
                ",".join(f"{k}={v}" for k, v in sorted(ov.items()))
                or "base"
            )
        out.append({"name": name, "overrides": ov})
    return out


def _stream_plan(norm_arms: list[dict], accelerate: bool):
    """Group arms into decision streams and pick each stream's effective
    override set (first member's, plus the prune acceleration)."""
    streams: list[dict] = []
    stream_of: list[int] = []
    index: dict = {}
    for arm in norm_arms:
        ov = arm["overrides"]
        key = tuple(
            sorted(
                (k, repr(v))
                for k, v in ov.items()
                if k not in IDENTITY_PINNED_FIELDS
            )
        )
        sid = index.get(key)
        if sid is None:
            sid = len(streams)
            index[key] = sid
            streams.append({"overrides": dict(ov), "members": []})
        streams[sid]["members"].append(arm)
        stream_of.append(sid)
    for s in streams:
        eff = s["overrides"]
        explicit = next(
            (
                m["overrides"]
                for m in s["members"]
                if m["overrides"].get("solver_prune_top_k")
            ),
            None,
        )
        if explicit is not None:
            for k in ("solver_prune_top_k", "solver_prune_slack"):
                if k in explicit:
                    eff[k] = explicit[k]
        elif accelerate and not eff.get("solver_prune_top_k"):
            # Certified pruning (decisions byte-identical by construction:
            # every pruned verdict is certificate-checked at fetch with
            # exact escalation) — free speed for eligible plain-fill
            # streams, a no-op for the rest.
            eff["solver_prune_top_k"] = ACCEL_PRUNE_TOP_K
        for k in _NEUTRALIZED_TOPOLOGY_FIELDS:
            eff.pop(k, None)
        # Comparison against recorded results is only meaningful when the
        # stream's DECISION config is the recorded one (identity-pinned
        # overrides don't move decisions, so they don't disqualify it).
        s["compare"] = not any(
            k not in IDENTITY_PINNED_FIELDS for k in s["overrides"]
        )
    return streams, stream_of


def run_sweep(
    trace_path: str,
    arms,
    *,
    accelerate: bool = True,
    progress=None,
    device="cuda",
) -> SweepReport:
    """Replay `trace_path` under every arm in `arms` (a list of override
    dicts, or {"name", "overrides"} entries) concurrently over one shared
    event stream. Returns a SweepReport whose `reports[i]` is bit-identical
    (verdicts/placements) to `replay_trace(trace_path, arms[i])`. Every
    lane runs on `device`, so the lanes' shared candidate-mask memo never
    crosses devices."""
    t_start = time.perf_counter()
    c_start = _compile_seconds()
    norm_arms = _normalize_arms(arms)
    streams, stream_of = _stream_plan(norm_arms, accelerate)

    reader = TraceReader(trace_path)
    header = reader.header
    events = list(reader.events())
    has_results = any(ev.get("k") == "result" for ev in events)

    telemetry = {
        "arms": len(norm_arms),
        "streams": len(streams),
        "dedup_arms": len(norm_arms) - len(streams),
        "windows": 0,
        "stacked_dispatches": 0,
        "stacked_arm_windows": 0,
        "lane_fallbacks": 0,
        "forced_resolves": 0,
        "shared_build_hits": 0,
        "replay_compile_ms": 0.0,
        "solve_s": 0.0,
    }
    coordinator = SweepCoordinator(telemetry)
    shared_masks: dict = {}

    lanes: list[ReplayLane] = []
    for s in streams:
        config = config_from_fingerprint(
            header["config"],
            overrides=s["overrides"],
            forced=dict(FORCED_FIELDS),
        )
        lane = ReplayLane(
            header,
            config,
            compare=s["compare"],
            has_result_events=has_results,
            candidate_memo=shared_masks,
            device=device,
        )
        lane.app.solver._dispatch_lane = coordinator
        lane.app.solver._row_bucket_quantum = SWEEP_ROW_BUCKET
        lanes.append(lane)

    # The driver's own roster mirror: candidates expand ONCE per event and
    # the shared list carries a (roster-version) digest, so every lane's
    # candidate-mask lookup is a cheap digest hit instead of an O(roster)
    # tuple hash — and lanes 2..S hit the cross-lane mask memo.
    roster: list[str] = []
    roster_version = 0
    roster_names: Optional[_SharedNames] = None

    def shared_expand(names):
        nonlocal roster_names
        if names == ALL_NODES:
            if roster_names is None:
                roster_names = _SharedNames(
                    roster, ("sweep-roster", roster_version)
                )
            return roster_names
        return list(names)

    n_events = 0
    for ev in events:
        n_events += 1
        if progress is not None and n_events % 5000 == 0:
            progress(n_events)
        k = ev.get("k")
        for lane in lanes:
            lane.begin_event(ev)
        if k == "predicate":
            candidates = [shared_expand(r["nodes"]) for r in ev["reqs"]]
            pends = [
                lane.predicate_begin(ev, candidates=list(candidates))
                for lane in lanes
            ]
            # The lockstep barrier: every arm's window is parked — solve
            # them as stacked cross-arm dispatches, then complete.
            coordinator.flush()
            for lane, p in zip(lanes, pends):
                lane.predicate_finish(p)
        elif k == "result":
            for lane in lanes:
                lane.result(ev)
        else:
            if k == "node":
                op = ev.get("op")
                if op == "delete":
                    if ev.get("name") in roster:
                        roster.remove(ev["name"])
                        roster_version += 1
                        roster_names = None
                elif op == "add":
                    name = ev["node"]["metadata"]["name"]
                    if name not in roster:
                        roster.append(name)
                        roster_version += 1
                        roster_names = None
            for lane in lanes:
                lane.apply(ev)
    for lane in lanes:
        lane.drain()
    coordinator.flush()

    stream_reports = [lane.finish(reader) for lane in lanes]
    telemetry["shared_build_hits"] = shared_masks.pop("__hits__", 0)
    telemetry["lane_roster_rebuilds"] = [
        lane.ext.features.stats()["roster_rebuilds"] for lane in lanes
    ]
    telemetry["lane_full_snapshots"] = [
        lane.app.solver.build_stats["full_snapshots"] for lane in lanes
    ]
    telemetry["lane_pruned_windows"] = [
        lane.app.solver.prune_stats["windows"] for lane in lanes
    ]
    wall = time.perf_counter() - t_start
    telemetry["replay_compile_ms"] = round(
        max(
            telemetry["replay_compile_ms"],
            (_compile_seconds() - c_start) * 1e3,
        ),
        3,
    )
    telemetry["windows_per_s"] = round(
        telemetry["windows"] / wall if wall > 0 else 0.0, 3
    )
    telemetry["solve_s"] = round(telemetry["solve_s"], 3)

    arms_out = []
    reports = []
    for arm, sid in zip(norm_arms, stream_of):
        arms_out.append({**arm, "stream": sid})
        # Clone so an arm's report is independently mutable/serializable
        # even when several arms share a stream.
        reports.append(copy.deepcopy(stream_reports[sid]))

    _LAST_TELEMETRY.clear()
    _LAST_TELEMETRY.update(
        {k: v for k, v in telemetry.items()}, wall_s=round(wall, 3)
    )
    return SweepReport(
        trace=trace_path,
        arms=arms_out,
        reports=reports,
        telemetry=telemetry,
        wall_s=wall,
    )


def grid_arms(grid: dict, base: Optional[dict] = None) -> list[dict]:
    """Cartesian product of `{field: [values...]}` into sweep arms, each
    carrying `base` plus its grid point. The CLI's `--grid` feeds this."""
    base = {str(k).replace("-", "_"): v for k, v in (base or {}).items()}
    fields = sorted(grid)
    arms = []
    for combo in itertools.product(*(grid[f] for f in fields)):
        ov = dict(base)
        ov.update(
            {
                str(f).replace("-", "_"): v
                for f, v in zip(fields, combo)
            }
        )
        arms.append(ov)
    return arms
