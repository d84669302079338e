"""SparkSchedulerExtender — the gang-admission predicate.

Rebuilds internal/extender/resource.go:59-639. The Predicate contract is the
kube-scheduler extender protocol: given a pod + candidate node names, return
the one node the pod should land on, or a per-node failure map. Driver
requests perform gang admission (FIFO-aware fit of the whole application
through the placement kernels, durable reservation creation on success);
executor requests walk the binding ladder (already-bound / unbound /
reschedule / soft reservation).

Outcome strings match the reference exactly (resource.go:43-57) so
dashboards keyed on them carry over.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional, Sequence

from spark_scheduler_tpu_torch.models.kube import Pod
from spark_scheduler_tpu_torch.core.binpacker import Binpacker
from spark_scheduler_tpu_torch.core.demands import DemandManager
from spark_scheduler_tpu_torch.core.feature_store import HostFeatureStore
from spark_scheduler_tpu_torch.core.lru import LRUCache
from spark_scheduler_tpu_torch.core.overhead import OverheadComputer
from spark_scheduler_tpu_torch.core.reservation_manager import (
    ReservationError,
    ResourceReservationManager,
)
from spark_scheduler_tpu_torch.core.solver import PlacementSolver, WindowRequest
from spark_scheduler_tpu_torch.core.sparkpods import (
    DRIVER_RESERVATION,
    ROLE_DRIVER,
    ROLE_EXECUTOR,
    SPARK_APP_ID_LABEL,
    SPARK_ROLE_LABEL,
    SparkPodError,
    SparkPodLister,
    find_instance_group,
    pod_matches_node,
    spark_resources,
)

# Outcomes (resource.go:43-57)
FAILURE_UNBOUND = "failure-unbound"
FAILURE_INTERNAL = "failure-internal"
FAILURE_FIT = "failure-fit"
FAILURE_EARLIER_DRIVER = "failure-earlier-driver"
FAILURE_NON_SPARK_POD = "failure-non-spark-pod"
SUCCESS = "success"
SUCCESS_RESCHEDULED = "success-rescheduled"
SUCCESS_ALREADY_BOUND = "success-already-bound"
SUCCESS_SCHEDULED_EXTRA_EXECUTOR = "success-scheduled-extra-executor"

SUCCESS_OUTCOMES = frozenset(
    {SUCCESS, SUCCESS_RESCHEDULED, SUCCESS_ALREADY_BOUND, SUCCESS_SCHEDULED_EXTRA_EXECUTOR}
)

LEADER_ELECTION_INTERVAL_S = 15.0  # resource.go:54-57

# `DRIVER_RESERVATION` lives in models.reservations; re-exported through
# sparkpods for core-layer convenience.


class _DomainNames(list):
    """A memoized affinity-domain name list with an O(1) identity digest —
    the in-process analog of server/ingest.NativeNodeNames. The domain
    cache reuses ONE object per (selector signature, topology version), so
    keying the solver's candidate-mask LRU and the window dispatch's
    domain memo on `names_digest` makes every steady-state lookup O(1)
    where tuple-keying hashed (and first built a tuple of) every name —
    a measured per-window O(N) host cost at the million-node tier.

    `patch_base`/`patch_added`/`patch_removed` record this
    ticket's LINEAGE when the domain cache patched membership through a
    node-event hint: the solver's candidate-mask patch follows the chain
    and applies the exact deltas instead of re-walking every name — the
    O(N) mask rebuild per node ADD that dominated the 1M add budget.
    The solver bounds the chain walk and clears the back-reference once
    it re-bases, so chains stay one-or-two links in practice."""

    __hash__ = object.__hash__

    patch_base = None
    patch_added: tuple = ()
    patch_removed: frozenset = frozenset()

    def __eq__(self, other):
        return self is other

    def __ne__(self, other):
        return self is not other

    @property
    def names_digest(self) -> int:
        return id(self)


class ExtenderArgs(NamedTuple):
    """schedulerapi.ExtenderArgs: the pod + kube-scheduler's candidates."""

    pod: Pod
    node_names: list[str]


class ExtenderFilterResult(NamedTuple):
    """schedulerapi.ExtenderFilterResult."""

    node_names: list[str]
    failed_nodes: dict[str, str]
    outcome: str

    @property
    def ok(self) -> bool:
        return bool(self.node_names)


@dataclasses.dataclass
class FifoConfig:
    """config.FifoConfig (config/config.go:57-64): age gate before an
    unschedulable earlier driver BLOCKS later drivers."""

    enforce_after_pod_age_s: float = 0.0
    enforce_after_pod_age_by_instance_group: dict[str, float] = dataclasses.field(
        default_factory=dict
    )


@dataclasses.dataclass
class ExtenderConfig:
    fifo: bool = False
    fifo_config: FifoConfig = dataclasses.field(default_factory=FifoConfig)
    instance_group_label: str = "instance-group"
    schedule_dynamically_allocated_executors_in_same_az: bool = False
    # One batched device solve per driver request (FIFO prefix + current
    # app, solver.pack_window) instead of a pack per earlier driver. All six
    # binpack strategies batch (solver.BATCHABLE_STRATEGIES). The batched
    # path sorts node orders ONCE per request like the reference
    # (resource.go:299); the sequential fallback (False) re-sorts after
    # each earlier driver's hypothetical placement, so the two paths can
    # pick different (both valid) nodes when FIFO subtractions reorder ties.
    batched_admission: bool = True
    # Request-gap resync threshold (`extender.resync-gap-seconds`): a gap
    # longer than this means the leader probably changed, so durable state
    # is resynced from observed pods before serving (resource.go:191-202).
    # Redundant — and skipped — while a real HA lease is held (see
    # SparkSchedulerExtender.ha_lease); float("inf") disables it outright
    # (sharded-group members, where the lease holder owns reconciliation).
    resync_gap_seconds: float = LEADER_ELECTION_INTERVAL_S


class WindowTicket:
    """A serving window between its dispatch and complete phases
    (predicate_window_dispatch / predicate_window_complete)."""

    __slots__ = (
        "args_list", "results", "roles", "timer_start", "window", "handle",
        "all_nodes", "by_name", "domains", "inflight_keys", "sync", "done",
        "epoch", "featurize_ms", "featurize_phases", "solve_started",
        "trace_wid",
    )

    def __init__(self, args_list):
        self.args_list = args_list
        self.results = None
        self.roles = None
        self.timer_start = 0.0
        self.window = []  # (arg index, pod, app_resources, args)
        self.handle = None  # solver WindowHandle when a window was dispatched
        self.all_nodes = []
        self.by_name = {}
        self.domains = {}
        self.inflight_keys = []
        self.sync = False  # single request: serve via the solo predicate()
        self.done = False  # results already final (e.g. reconcile failure)
        # Extender capacity epoch at dispatch: if a solo-path admission
        # changed capacity while this window was in flight, its device
        # decisions are stale and the complete phase re-solves serially.
        self.epoch = -1
        # Flight-recorder phase anchors: host featurize cost of the window
        # dispatch (with its sub-phase breakdown: snapshot / tensors /
        # domains / fifo), and the wall time the device solve started (the
        # complete phase's fetch closes the solve interval).
        self.featurize_ms = 0.0
        self.featurize_phases: dict[str, float] = {}
        self.solve_started = 0.0
        # Trace journal window id (replay/trace.TraceWriter): set when a
        # trace sink journaled this ticket's dispatch; the complete phase
        # journals its results under the same id. None = not journaled
        # (no sink, or a sync ticket — the solo path self-journals).
        self.trace_wid = None


class SparkSchedulerExtender:
    def __init__(
        self,
        backend,
        pod_lister: SparkPodLister,
        reservation_manager: ResourceReservationManager,
        demand_manager: DemandManager,
        overhead_computer: OverheadComputer,
        binpacker: Binpacker,
        solver: PlacementSolver,
        config: ExtenderConfig,
        reconciler=None,
        metrics=None,
        events=None,
        waste=None,
        recorder=None,
        clock=time.time,
        policy=None,
    ):
        self._backend = backend
        self._pod_lister = pod_lister
        self._rrm = reservation_manager
        self._demands = demand_manager
        self._overhead = overhead_computer
        self.binpacker = binpacker
        self._solver = solver
        self._config = config
        self._reconciler = reconciler
        self._metrics = metrics
        self._events = events
        self._waste = waste
        # Scheduling flight recorder (observability/recorder.py): every
        # decision below appends one explainable DecisionRecord.
        self._recorder = recorder
        # Policy engine (policy/engine.py) — None keeps every hook below on
        # the exact pre-policy branch (the FIFO byte-identity contract).
        self._policy = policy
        self._clock = clock
        self._last_request: float = 0.0
        # HA lease handle (ha/lease.LeaseManager), set by the replica
        # runtime: while the lease is HELD, the >gap "leader probably
        # changed" heuristic below is redundant (no silent leader change
        # can have happened — a takeover revokes the lease) and skipped.
        self.ha_lease = None
        # Apps whose gang admission is DISPATCHED but not yet applied (a
        # pipelined window in flight). A later window must not re-admit
        # them; their requests fall through to the solo loop of their own
        # window's complete phase, which runs after the prior window
        # applied — the idempotent-retry branch then returns the reserved
        # node (resource.go:273-286).
        self._inflight_apps: set[tuple[str, str]] = set()
        # Affinity-domain memo across windows: (selector/affinity
        # signature) -> (backend nodes_version, matching node names). The
        # O(nodes) pod_matches_node walk was a measured per-window hotspot
        # at 10k nodes even though serving workloads reuse a handful of
        # selector shapes; invalidated by the node-mutation counter, and
        # LRU-evicting so a 65th live signature keeps the 64 hottest
        # instead of wiping them all.
        self._domain_cache: LRUCache = LRUCache(64)
        # Event-sourced host feature store: the single featurize read of
        # every serving path (roster + by-name map + dense usage/overhead,
        # all epoch-versioned, O(changed) per window). Owns the
        # capture-before-list node versioning dance.
        self.features = HostFeatureStore(
            backend, solver.registry, overhead_computer, reservation_manager
        )
        # Bumped by every SOLO-path admission that changes capacity (a solo
        # driver's reservations, an executor reschedule / soft
        # reservation). Windows dispatched before such a change re-solve at
        # complete time instead of applying their stale device decisions —
        # pipelined serving stays decision-equivalent to a serialized
        # order.
        self._capacity_epoch = 0


    # ------------------------------------------------------------------ API
    #
    # Trace capture: each public serving entry point is a thin
    # wrapper journaling the request inputs + final results to the
    # recorder's trace sink (replay/trace.TraceWriter). Sink-off cost is
    # one attribute check per call. Window dispatches journal AFTER the
    # dispatch succeeds — PipelineDrainRequired propagates un-journaled,
    # so the caller's drain-and-retry appears in the trace exactly as the
    # serialization the replay engine re-drives (drained results first,
    # then the retried dispatch). Each wrapper holds the sink's order lock
    # from its first state read to its journal entry, and node and pod
    # events take the same lock, so no event lands between what a window
    # read and where the trace places it.

    def _trace_sink(self):
        rec = self._recorder
        return getattr(rec, "sink", None) if rec is not None else None

    def predicate(self, args: ExtenderArgs) -> ExtenderFilterResult:
        tw = self._trace_sink()
        if tw is None:
            return self._predicate_solo(args)
        with tw.order_lock:
            wid = tw.on_predicate([args], mode="solo")
            res = self._predicate_solo(args)
            tw.on_results(wid, [res])
        return res

    def predicate_window_dispatch(
        self, args_list: Sequence[ExtenderArgs]
    ) -> "WindowTicket":
        tw = self._trace_sink()
        if tw is None:
            return self._window_dispatch(args_list)
        with tw.order_lock:
            t = self._window_dispatch(args_list)
            if not t.sync and t.trace_wid is None:
                t.trace_wid = tw.on_predicate(t.args_list, mode="window")
        return t

    def predicate_window_complete(
        self, t: "WindowTicket"
    ) -> list[ExtenderFilterResult]:
        tw = self._trace_sink()
        if tw is None:
            return self._window_complete(t)
        with tw.order_lock:
            results = self._window_complete(t)
            # Sync tickets route through self.predicate() inside
            # _window_complete and self-journal there.
            if t.trace_wid is not None:
                tw.on_results(t.trace_wid, results)
        return results

    def predicate_windows_dispatch(
        self, args_lists: Sequence[Sequence[ExtenderArgs]]
    ) -> "list[WindowTicket]":
        tw = self._trace_sink()
        if tw is None:
            return self._windows_dispatch(args_lists)
        with tw.order_lock:
            tickets = self._windows_dispatch(args_lists)
            # Each fused sub-window journals as its own window dispatch,
            # in claim order — replaying them as sequential pipelined
            # dispatches is decision-equivalent by the fused==sequential
            # pin. The len==1 path delegated to the public
            # predicate_window_dispatch and already journaled.
            for t in tickets:
                if not t.sync and t.trace_wid is None:
                    t.trace_wid = tw.on_predicate(t.args_list, mode="window")
        return tickets

    def _predicate_solo(self, args: ExtenderArgs) -> ExtenderFilterResult:
        from spark_scheduler_tpu_torch.tracing import tracer

        pod = args.pod
        role = pod.labels.get(SPARK_ROLE_LABEL, "")
        timer_start = self._clock()

        try:
            self._reconcile_if_needed()
        except Exception as exc:  # failure to rebuild state is internal
            msg = f"failed to reconcile: {exc}"
            self._record_decision(
                pod, role, FAILURE_INTERNAL, None, args.node_names, msg
            )
            return self._fail(args, FAILURE_INTERNAL, msg)
        self._rrm.compact_dynamic_allocation_applications()

        ctx: dict = {}
        with tracer().span(
            "select-node", role=role or "unknown", pod=f"{pod.namespace}/{pod.name}"
        ) as sp:
            node, outcome, message = self._select_node(
                role, pod, args.node_names, ctx=ctx
            )
            sp.tag("outcome", outcome)

        if self._metrics is not None:
            self._metrics.mark_schedule_outcome(
                pod, role, outcome, self._clock() - timer_start
            )
        self._record_decision(
            pod, role, outcome, node, args.node_names, message, ctx=ctx
        )
        if node is None:
            return self._fail(args, outcome, message or outcome)
        return ExtenderFilterResult(node_names=[node], failed_nodes={}, outcome=outcome)

    def predicate_batch(
        self, args_list: Sequence[ExtenderArgs]
    ) -> list[ExtenderFilterResult]:
        """Serve a WINDOW of coalesced predicate calls.

        The window is serialized as: driver gang admissions first (one
        `pack_window` device program, each request a segment with exact
        solo-solve semantics — decisions identical to serving those drivers
        one at a time in list order), then executor/non-spark requests in
        list order against the reservations the window just created. All
        window requests arrived concurrently, so this driver-first order is
        one valid linearization (and the friendliest: an executor whose
        driver is in the same window finds its reservation). Reconciliation
        and soft-reservation compaction run once per window — the window IS
        the serialization point (SURVEY.md §7 "Mutable-state races").

        Synchronous form of the two-phase API: the PIPELINED serving loop
        (server/http.py PredicateBatcher) instead dispatches window k+1
        (predicate_window_dispatch) before completing window k
        (predicate_window_complete), overlapping the next window's host
        build + device dispatch with the previous window's blocking
        decision pull."""
        return self.predicate_window_complete(
            self.predicate_window_dispatch(args_list)
        )

    def _window_dispatch(
        self, args_list: Sequence[ExtenderArgs]
    ) -> "WindowTicket":
        """Phase 1: reconcile/compact, select the driver window, build the
        segmented requests, and DISPATCH the device solve (no blocking
        fetch). May raise solver.PipelineDrainRequired — the caller must
        complete the pending window and retry."""
        t = WindowTicket(args_list)
        if len(args_list) == 1 and (
            args_list[0].pod.labels.get(SPARK_ROLE_LABEL, "") != ROLE_DRIVER
            or not self._config.batched_admission
            or not self._solver.can_batch(self.binpacker.name)
        ):
            # Lone NON-driver request: the solo ladder (host-only, no device
            # solve to overlap). A lone DRIVER stays on the window path
            # below: the solo driver path would bump the capacity epoch
            # (forcing every in-flight window to re-solve) and its ticket
            # would drain the pipeline — one straggler client could
            # serialize the whole serving loop.
            t.sync = True
            return t
        t.timer_start = self._clock()
        try:
            self._reconcile_if_needed()
        except Exception as exc:
            msg = f"failed to reconcile: {exc}"
            for a in args_list:
                self._record_decision(
                    a.pod,
                    a.pod.labels.get(SPARK_ROLE_LABEL, ""),
                    FAILURE_INTERNAL, None, a.node_names, msg,
                )
            t.results = [
                self._fail(a, FAILURE_INTERNAL, msg) for a in args_list
            ]
            t.done = True
            return t
        self._rrm.compact_dynamic_allocation_applications()
        t.results = [None] * len(args_list)
        t.roles = [a.pod.labels.get(SPARK_ROLE_LABEL, "") for a in args_list]
        driver_ids = [i for i, r in enumerate(t.roles) if r == ROLE_DRIVER]
        if (
            driver_ids
            and self._config.batched_admission
            and self._solver.can_batch(self.binpacker.name)
        ):
            self._dispatch_driver_window(t, driver_ids)
        return t

    def _window_complete(
        self, t: "WindowTicket"
    ) -> list[ExtenderFilterResult]:
        """Phase 2: fetch + apply the window decisions (reservations,
        demands, events), then serve everything not window-served
        (executors, non-spark pods, deferred in-flight duplicates, drivers
        when batching is off) on the solo path in arrival order."""
        from spark_scheduler_tpu_torch.tracing import tracer

        if t.sync:
            return [self.predicate(t.args_list[0])]
        if t.done:
            return t.results
        if t.handle is not None and t.epoch != self._capacity_epoch:
            # A solo-path admission changed capacity while this window was
            # in flight: its device decisions could double-book. Discard
            # them and re-solve NOW — every earlier window has applied by
            # this point (completions are FIFO), so a fresh serialized
            # solve sees the full truth. The pipelined device state is
            # dropped with the stale decisions; later in-flight windows
            # detect the same epoch change and re-solve too.
            self._inflight_apps.difference_update(t.inflight_keys)
            self._solver.discard_pipeline()
            # The discard/re-solve is itself a capacity change: the re-solve
            # below may place this window's gangs on different nodes than the
            # (discarded) device decisions a LATER in-flight window's base
            # threads. Bump the epoch so every window dispatched before this
            # discard also re-solves from host truth instead of applying
            # decisions computed against the dropped placements.
            self._capacity_epoch += 1
            redo_ids = [
                i
                for i, r in enumerate(t.roles)
                if r == ROLE_DRIVER and t.results[i] is None
            ]
            t.window = []
            t.handle = None
            t.inflight_keys = []
            t.domains = {}
            if redo_ids:
                # Even a SINGLE invalidated driver redoes on the window
                # path: the solo ladder would bump the epoch again on
                # success, cascading re-solves through every other
                # in-flight window.
                self._dispatch_driver_window(t, redo_ids)
        # One write-back drain for the whole window instead of one per
        # mutation: every result below is only released to its client after
        # this context exits, so durability-before-response is unchanged.
        with self._rrm.rr_cache.deferred_sync(), \
                self._demands.deferred_sync():
            if t.handle is not None:
                self._complete_driver_window(t)
            args_list, results, roles = t.args_list, t.results, t.roles
            # Consecutive executor requests are served as ONE grouped ladder
            # pass + one grouped reschedule solve (_serve_executor_window);
            # a non-executor request between them flushes the run so the
            # arrival-order serialization is preserved.
            run: list[int] = []
            for i, args in enumerate(args_list):
                if results[i] is not None:
                    continue
                if roles[i] == ROLE_EXECUTOR:
                    run.append(i)
                    continue
                if run:
                    self._serve_executor_window(t, run)
                    run = []
                pod = args.pod
                ctx: dict = {}
                with tracer().span(
                    "select-node", role=roles[i] or "unknown",
                    pod=f"{pod.namespace}/{pod.name}",
                ) as sp:
                    node, outcome, message = self._select_node(
                        roles[i], pod, args.node_names, ctx=ctx
                    )
                    sp.tag("outcome", outcome)
                self._mark_outcome(pod, roles[i], outcome, t.timer_start)
                self._record_decision(
                    pod, roles[i], outcome, node, args.node_names, message,
                    ctx=ctx,
                )
                if node is None:
                    results[i] = self._fail(args, outcome, message or outcome)
                else:
                    results[i] = ExtenderFilterResult(
                        node_names=[node], failed_nodes={}, outcome=outcome
                    )
            if run:
                self._serve_executor_window(t, run)
        return results

    def _windows_dispatch(
        self, args_lists: Sequence[Sequence[ExtenderArgs]]
    ) -> "list[WindowTicket]":
        """Phase 1 of a FUSED K-window serve (the PredicateBatcher's
        fused claim, `solver.fuse-windows` > 1): reconcile/compact ONCE,
        take ONE feature-store snapshot + pipelined tensor build, stage
        every sub-window's driver requests, and dispatch them all in ONE
        fused device program (solver.pack_windows_dispatch) whose
        committed base carries on-device between the sub-windows — one
        h2d + one dispatch + one d2h where K sequential windows pay K
        round trips. Returns one ticket per sub-window; complete each IN
        ORDER via predicate_window_complete (the first completion pays
        the single decision pull, the rest are free).

        Decision-equivalent to dispatching the K windows sequentially
        back-to-back: the sub-windows were claimed at one instant, so no
        external state lands between them in either serialization, the
        in-flight app dedup threads across sub-windows exactly as
        _inflight_apps does across pipelined dispatches, and the shared
        FIFO pending scan sees the same backend state each sequential
        dispatch would. May raise PipelineDrainRequired BEFORE any ticket
        state is committed — the caller completes pending windows and
        retries the whole claim."""
        if len(args_lists) == 1:
            return [self.predicate_window_dispatch(args_lists[0])]
        tickets = [WindowTicket(a) for a in args_lists]
        can_window = (
            self._config.batched_admission
            and self._solver.can_batch(self.binpacker.name)
        )
        for t in tickets:
            if len(t.args_list) == 1 and (
                t.args_list[0].pod.labels.get(SPARK_ROLE_LABEL, "")
                != ROLE_DRIVER
                or not can_window
            ):
                # Same shortcut as predicate_window_dispatch: a lone
                # NON-driver sub-window serves on the solo ladder.
                t.sync = True
        live = [t for t in tickets if not t.sync]
        if not live:
            return tickets
        timer_start = self._clock()
        try:
            self._reconcile_if_needed()
        except Exception as exc:
            msg = f"failed to reconcile: {exc}"
            for t in live:
                for a in t.args_list:
                    self._record_decision(
                        a.pod,
                        a.pod.labels.get(SPARK_ROLE_LABEL, ""),
                        FAILURE_INTERNAL, None, a.node_names, msg,
                    )
                t.results = [
                    self._fail(a, FAILURE_INTERNAL, msg) for a in t.args_list
                ]
                t.done = True
            return tickets
        self._rrm.compact_dynamic_allocation_applications()
        for t in live:
            t.timer_start = timer_start
            t.results = [None] * len(t.args_list)
            t.roles = [
                a.pod.labels.get(SPARK_ROLE_LABEL, "") for a in t.args_list
            ]
        if not can_window:
            return tickets
        driver_ids_of = {
            id(t): [i for i, r in enumerate(t.roles) if r == ROLE_DRIVER]
            for t in live
        }
        if not any(driver_ids_of.values()):
            # No driver anywhere in the claim (executor-heavy burst):
            # nothing will dispatch, so skip the shared featurize — the
            # sequential path gates the same way on driver_ids, and a
            # spurious PipelineDrainRequired here would drain the whole
            # pipeline for a claim that needed no device work.
            return tickets
        # Shared featurize: ONE snapshot + ONE pipelined build (the only
        # raise site — PipelineDrainRequired propagates before any ticket
        # commits state) + ONE FIFO pending-driver scan for the whole
        # fused claim. The shared phase costs are attributed to the
        # sub-windows in equal shares — amortization is the point.
        featurize_start = self._clock()
        snap = self.features.snapshot()
        t_snap = self._clock()
        snapshot_ms = (t_snap - featurize_start) * 1e3
        tensors = self._solver.build_tensors_pipelined(
            snap.nodes, snap.usage, snap.overhead,
            topo_version=snap.nodes_version,
            statics_version=snap.statics_epoch,
            roster_rows=snap.roster_rows,
            dirty_hint=snap.dirty_hint,
            avail_epoch=snap.avail_epoch,
            avail_journal=snap.avail_journal,
        )
        t_tensors = self._clock()
        tensors_ms = (t_tensors - t_snap) * 1e3
        pending_supplier = self._pending_driver_supplier()
        share = max(1, len(live))
        seen_apps: set[tuple[str, str]] = set(self._inflight_apps)
        staged: list[tuple[WindowTicket, list[WindowRequest]]] = []
        for t in live:
            t.featurize_phases["featurize_snapshot_ms"] = snapshot_ms / share
            t.featurize_phases["featurize_tensors_ms"] = tensors_ms / share
            driver_ids = driver_ids_of[id(t)]
            if not driver_ids:
                continue
            requests = self._stage_driver_window(
                t, driver_ids, snap, seen_apps, pending_supplier
            )
            if requests:
                staged.append((t, requests))
        if staged:
            solve_started = self._clock()
            views = self._solver.pack_windows_dispatch(
                self.binpacker.name, tensors, [r for _, r in staged]
            )
            for (t, _), view in zip(staged, views):
                t.solve_started = solve_started
                t.handle = view
                self._mark_window_inflight(t)
        return tickets

    def _parse_pending_drivers(self) -> list[tuple]:
        """FIFO predecessor scan: one backend list + one annotation parse
        per pending driver, shared by every request of a window (and by
        every sub-window of a fused claim — each request then filters the
        shared snapshot, sparkpods.go:51-77 semantics unchanged)."""
        out: list[tuple] = []
        ig_label = self._pod_lister.instance_group_label
        for ed in self._pod_lister.list_pending_drivers():
            try:
                ed_res = spark_resources(ed)
            except SparkPodError:
                continue  # unparseable driver skipped (resource.go:228-233)
            out.append(
                (
                    ed,
                    find_instance_group(ed, ig_label),
                    ed_res,
                    self._should_skip_driver_fifo(ed),
                )
            )
        return out

    def _pending_driver_supplier(self):
        """LAZY, memoized form of _parse_pending_drivers for window
        staging: the O(pending-drivers) scan runs at most once per
        dispatch (shared across a fused claim's sub-windows) and ONLY when
        some sub-window actually stages a driver request — a window whose
        members all dedup away (in-flight duplicates, idempotent retries)
        costs nothing, as before the fused refactor. FIFO-off returns []
        for free."""
        memo: dict = {}

        def supply() -> list[tuple]:
            if "rows" not in memo:
                memo["rows"] = (
                    self._parse_pending_drivers() if self._config.fifo else []
                )
            return memo["rows"]

        return supply

    def _mark_window_inflight(self, t: WindowTicket) -> None:
        t.epoch = self._capacity_epoch
        t.inflight_keys = [
            (pod.namespace, pod.labels.get(SPARK_APP_ID_LABEL, ""))
            for _, pod, _, _ in t.window
        ]
        self._inflight_apps.update(t.inflight_keys)

    def _dispatch_driver_window(self, t: WindowTicket, driver_ids) -> None:
        """Gang-admit every driver request of the window in ONE device solve
        (solver.pack_window_dispatch; fetched in _complete_driver_window).
        Mirrors _select_driver_node's flow per request: idempotent retry,
        FIFO earlier-driver rows, demand lifecycle, reservation creation,
        metrics/events."""
        # Build the device tensors FIRST: build_tensors_pipelined is the
        # only raise site (PipelineDrainRequired), and raising before any
        # outcome is marked lets the serving loop retry the whole dispatch
        # without double-counting metrics or waste attempts.
        # ONE feature-store snapshot replaces the per-window list_nodes +
        # name->node dict + overhead dict + usage copy of the old path:
        # steady state it returns the resident epoch-versioned arrays
        # (O(changed), usually O(1)); the capture-before-list versioning
        # dance lives inside the store.
        featurize_start = self._clock()
        snap = self.features.snapshot()
        phases = t.featurize_phases
        t_snap = self._clock()
        phases["featurize_snapshot_ms"] = (t_snap - featurize_start) * 1e3
        # Device-resident state threaded ACROSS windows: the previous
        # window's committed base (still on device) plus additive external
        # deltas — what makes dispatch-before-fetch pipelining exact
        # (solver.build_tensors_pipelined). The statics epoch lets the
        # builder skip its per-window static-field array compares.
        tensors = self._solver.build_tensors_pipelined(
            snap.nodes, snap.usage, snap.overhead,
            topo_version=snap.nodes_version,
            statics_version=snap.statics_epoch,
            roster_rows=snap.roster_rows,
            dirty_hint=snap.dirty_hint,
            avail_epoch=snap.avail_epoch,
            avail_journal=snap.avail_journal,
        )
        phases["featurize_tensors_ms"] = (self._clock() - t_snap) * 1e3
        requests = self._stage_driver_window(
            t, driver_ids, snap, set(self._inflight_apps),
            self._pending_driver_supplier(),
        )
        if not requests:
            return
        t.solve_started = self._clock()
        t.handle = self._solver.pack_window_dispatch(
            self.binpacker.name, tensors, requests
        )
        self._mark_window_inflight(t)

    def _stage_driver_window(
        self, t: WindowTicket, driver_ids, snap, seen_apps, pending_supplier
    ) -> "list[WindowRequest]":
        """Select the window's members (idempotent retry, in-flight dedup,
        resource parse), match affinity domains, and build the segmented
        WindowRequests — everything of a driver-window dispatch EXCEPT the
        tensor build and the device dispatch, so the fused path can stage
        K sub-windows against one shared snapshot/tensor build.
        `seen_apps` is MUTATED (the fused claim threads one set across its
        sub-windows, exactly as _inflight_apps threads across pipelined
        dispatches); `pending_supplier` is the lazy shared FIFO pending
        scan (_pending_driver_supplier), invoked only once a window is
        known non-empty — its cost lands inside this ticket's fifo
        featurize phase."""
        all_nodes, topo = snap.nodes, snap.nodes_version
        t.all_nodes = all_nodes
        by_name = t.by_name = snap.by_name
        args_list, results, timer_start = t.args_list, t.results, t.timer_start
        phases = t.featurize_phases
        t_stage = self._clock()
        window = t.window
        for i in driver_ids:
            args = args_list[i]
            pod = args.pod
            app_id = pod.labels.get(SPARK_APP_ID_LABEL, "")
            if (pod.namespace, app_id) in seen_apps:
                # Duplicate submission of the same app in one window (client
                # retry) OR an app whose admission is still in flight in a
                # previous pipelined window: leave it for the post-window
                # solo loop — it runs after every prior window applied, so
                # the idempotent-retry branch returns the node the first
                # submission reserved (resource.go:273-286).
                continue
            rr = self._rrm.get_resource_reservation(app_id, pod.namespace)
            if rr is not None:
                # Idempotent retry (resource.go:273-286).
                node = rr.spec.reservations[DRIVER_RESERVATION].node
                self._mark_outcome(pod, ROLE_DRIVER, SUCCESS, timer_start)
                self._record_decision(
                    pod, ROLE_DRIVER, SUCCESS, node, args.node_names
                )
                results[i] = ExtenderFilterResult(
                    node_names=[node], failed_nodes={}, outcome=SUCCESS
                )
                continue
            try:
                res = spark_resources(pod)
            except SparkPodError as exc:
                msg = f"failed to get spark resources: {exc}"
                self._mark_outcome(pod, ROLE_DRIVER, FAILURE_INTERNAL, timer_start)
                self._record_decision(
                    pod, ROLE_DRIVER, FAILURE_INTERNAL, None,
                    args.node_names, msg,
                )
                results[i] = self._fail(args, FAILURE_INTERNAL, msg)
                continue
            seen_apps.add((pod.namespace, app_id))
            window.append((i, pod, res, args))
        if not window:
            return []

        # Domain (node-affinity) matching, deduplicated by affinity
        # signature: requests without selector/affinity — the overwhelmingly
        # common case — share the all-nodes domain (None => pack_window uses
        # every valid node), and identical selectors run the O(nodes)
        # matcher walk once per window instead of once per request. A node
        # event no longer invalidates the cache wholesale: an
        # update/add burst PATCHES the cached membership through the
        # snapshot's dirty hint — O(changed) matcher calls — and when
        # membership is unchanged (the common event: capacity drift,
        # cordons; labels untouched) the SAME domain object survives, so
        # the solver's digest-keyed candidate-mask memo keeps hitting.
        domains = t.domains
        hint = snap.dirty_hint
        domain_by_sig: dict[tuple, list[str] | None] = {}
        for i, pod, res, args in window:
            sig = (
                tuple(sorted(pod.node_selector.items())),
                tuple(sorted(
                    (k, tuple(v)) for k, v in pod.node_affinity.items()
                )),
            )
            if sig not in domain_by_sig:
                if not pod.node_selector and not pod.node_affinity:
                    domain_by_sig[sig] = None  # all valid nodes
                else:
                    cached = (
                        self._domain_cache.get(sig)
                        if topo is not None
                        else None
                    )
                    if cached is not None and cached[0] == topo:
                        domain_by_sig[sig] = cached[1]
                    elif (
                        cached is not None
                        and hint is not None
                        and cached[0] == hint[0]
                    ):
                        # Version chain verified: the cache was current as
                        # of the hint's base version, and the hint carries
                        # exactly the nodes changed since.
                        names, name_set = cached[1], cached[2]
                        added = [
                            n.name
                            for n in hint[1]
                            if n.name not in name_set
                            and pod_matches_node(pod, n)
                        ]
                        removed = {
                            n.name
                            for n in hint[1]
                            if n.name in name_set
                            and not pod_matches_node(pod, n)
                        }
                        # Deleted nodes (hint[2]): drop them
                        # from the cached membership — a delete no longer
                        # rebuilds the domain cache wholesale.
                        removed |= {
                            nm
                            for nm in (
                                hint[2] if len(hint) > 2 else ()
                            )
                            if nm in name_set
                        }
                        if added or removed:
                            prev_names = names
                            if removed:
                                names = _DomainNames(
                                    nm for nm in names if nm not in removed
                                )
                                names.extend(added)
                                name_set = (name_set - removed) | set(added)
                            else:
                                # Adds-only (the node-ADD burst case): one
                                # pointer copy of the name list, and the
                                # member set grows IN PLACE — rebuilding a
                                # million-entry set per event was the
                                # dominant 1M ADD cost. The set
                                # is owned by this cache entry alone, and
                                # the ticket object must still be NEW (its
                                # digest keys the solver's mask memo).
                                names = _DomainNames(names)
                                names.extend(added)
                                name_set.update(added)
                            # Lineage for the solver's candidate-mask
                            # patch: the new ticket names its
                            # exact membership deltas so the mask updates
                            # O(changed) instead of re-walking N names.
                            # The solver clears the back-reference once it
                            # re-bases its mask on this ticket, so chains
                            # stay one-or-two links in practice.
                            names.patch_base = prev_names
                            names.patch_added = tuple(added)
                            names.patch_removed = frozenset(removed)
                        domain_by_sig[sig] = names
                        self._domain_cache.put(sig, (topo, names, name_set))
                    else:
                        names = _DomainNames(
                            n.name
                            for n in all_nodes
                            if pod_matches_node(pod, n)
                        )
                        domain_by_sig[sig] = names
                        if topo is not None:
                            self._domain_cache.put(
                                sig, (topo, names, set(names))
                            )
            domains[i] = domain_by_sig[sig]
        t_domains = self._clock()
        phases["featurize_domains_ms"] = (t_domains - t_stage) * 1e3
        # First non-empty window of the dispatch pays the (memoized)
        # pending-driver scan here, inside its fifo phase interval.
        parsed_pending = pending_supplier()

        requests: list[WindowRequest] = []
        kept: list[tuple] = []
        now_policy = self._clock()
        for i, pod, res, args in window:
            rows: list[tuple] = []
            if self._config.fifo:
                group = find_instance_group(
                    pod, self._pod_lister.instance_group_label
                )
                if self._policy is not None:
                    # Policy window ordering (policy/ordering.py): blocker
                    # rows by the configured strategy; a DRF cross-group
                    # yield denies without consuming a solve (disjoint
                    # domains — capacity rows cannot express it).
                    blockers, hard = self._policy.ordering.blockers(
                        pod, group, parsed_pending, now_policy
                    )
                    if hard:
                        msg = (
                            "yielding to instance group with smaller "
                            "dominant share"
                        )
                        self._demands.create_demand_for_application(pod, res)
                        self._mark_outcome(
                            pod, ROLE_DRIVER, FAILURE_EARLIER_DRIVER,
                            timer_start,
                        )
                        self._record_decision(
                            pod, ROLE_DRIVER, FAILURE_EARLIER_DRIVER, None,
                            args.node_names, msg,
                        )
                        results[i] = self._fail(
                            args, FAILURE_EARLIER_DRIVER, msg
                        )
                        continue
                    for _ed, _ed_group, ed_res, ed_skip in blockers:
                        rows.append(
                            (
                                ed_res.driver_resources,
                                ed_res.executor_resources,
                                ed_res.min_executor_count,
                                ed_skip,
                            )
                        )
                else:
                    for ed, ed_group, ed_res, ed_skip in parsed_pending:
                        if not SparkPodLister.is_earlier_driver(
                            ed, ed_group, pod, group
                        ):
                            continue
                        rows.append(
                            (
                                ed_res.driver_resources,
                                ed_res.executor_resources,
                                ed_res.min_executor_count,
                                ed_skip,
                            )
                        )
            rows.append(
                (
                    res.driver_resources,
                    res.executor_resources,
                    res.min_executor_count,
                    False,
                )
            )
            kept.append((i, pod, res, args))
            requests.append(
                WindowRequest(
                    rows=rows,
                    driver_candidate_names=args.node_names,
                    domain_node_names=domains[i],
                )
            )
        if len(kept) != len(window):
            window[:] = kept  # t.window stays aligned with `requests`

        now = self._clock()
        phases["featurize_fifo_ms"] = (now - t_domains) * 1e3
        # The window's featurize cost is the sum of its contiguous phases
        # (shared snapshot/tensor costs arrive as the fused claim's equal
        # shares, so fused sub-windows report their amortized featurize).
        t.featurize_ms = sum(phases.values())
        tel = self._solver.telemetry
        if tel is not None:
            tel.on_featurize(phases, self.features)
        return requests

    def _complete_driver_window(self, t: WindowTicket) -> None:
        """Fetch the dispatched window's decisions and apply them:
        reservations, demand lifecycle, events, metrics."""
        from spark_scheduler_tpu_torch.tracing import tracer

        try:
            decisions = self._solver.pack_window_fetch(t.handle)
        finally:
            self._inflight_apps.difference_update(t.inflight_keys)
        # Solve interval for the recorder: device dispatch -> decisions on
        # host. On the pipelined path the blocking pull overlapped other
        # windows' host work, so this is the wall time the WINDOW waited,
        # not pure device time.
        solve_ms = (self._clock() - t.solve_started) * 1e3
        dispatch_info = t.handle.info
        requests = t.handle.requests
        window, results, timer_start = t.window, t.results, t.timer_start
        all_nodes, by_name, domains = t.all_nodes, t.by_name, t.domains
        commit_t0 = self._clock()

        def record(k, pod, args, outcome, node, msg="", extra=None):
            self._record_decision(
                pod, ROLE_DRIVER, outcome, node, args.node_names, msg,
                ctx={
                    **(extra or {}),
                    "featurize_ms": t.featurize_ms,
                    **t.featurize_phases,
                    "solve_ms": solve_ms,
                    # The window-coalesced commit: classification + ONE
                    # batched reservation write-back, measured from the
                    # decisions landing on host to this record.
                    "commit_ms": (self._clock() - commit_t0) * 1e3,
                    # None when FIFO is off (rows then carries only
                    # the request's own app — 0 would misread as
                    # "first in queue").
                    "queue_position": (
                        len(requests[k].rows) - 1
                        if self._config.fifo
                        else None
                    ),
                    "solve_info": dispatch_info,
                    # Multi-device engine: the pool slot whose
                    # partition solved THIS request (None on the
                    # single-device path).
                    "device_id": (
                        t.handle.request_device[k]
                        if t.handle.request_device is not None
                        else None
                    ),
                },
            )

        # Pass 1 — classify: denials finalize immediately (demand +
        # record + failure response); admitted gangs queue for ONE
        # coalesced reservation write-back below instead of a cache
        # write + listener fan-out per decision.
        admitted: list[tuple] = []  # (k, i, pod, res, args, packing)
        for k, (i, pod, res, args) in enumerate(window):
            d = decisions[k]
            if d.admitted:
                admitted.append((k, i, pod, res, args, d.packing))
                continue
            # Per-request trace span over the decision apply, same
            # name/tags as the solo path's — dashboards keyed on
            # select-node cover windowed serving too.
            with tracer().span(
                "select-node", role=ROLE_DRIVER,
                pod=f"{pod.namespace}/{pod.name}",
            ) as sp:
                self._demands.create_demand_for_application(pod, res)
                extra = None
                if d.earlier_blocked:
                    outcome, msg = (
                        FAILURE_EARLIER_DRIVER,
                        "earlier drivers do not fit to the cluster",
                    )
                else:
                    outcome, msg = (
                        FAILURE_FIT,
                        "application does not fit to the cluster",
                    )
                    pre = self._try_preempt_for(
                        pod, res, args.node_names, domains[i]
                    )
                    if pre is not None:
                        # Evictions freed capacity; this round still denies
                        # and the pod's retry admits against the freed
                        # cluster (the solo path re-solves inline instead).
                        msg = (
                            "application does not fit; preempted "
                            f"{len(pre['evicted'])} lower-priority gang(s)"
                        )
                        extra = {"preemption": pre}
                sp.tag("outcome", outcome)
                self._mark_outcome(pod, ROLE_DRIVER, outcome, timer_start)
                record(k, pod, args, outcome, None, msg, extra)
                results[i] = self._fail(args, outcome, msg)

        # One batched reservation write-back for the whole window: one
        # write-mutex hold, one batched usage-tracker/overhead delta
        # application, one (deferred) queue drain — instead of the full
        # chain per admitted gang. Per-entry failures surface exactly as
        # the serial create's ReservationError did.
        errors = self._rrm.create_reservations_batch(
            [
                (pod, res, packing.driver_node, packing.executor_nodes)
                for _k, _i, pod, res, _args, packing in admitted
            ]
        )

        # Pass 2 — finalize admitted gangs against the batch outcome.
        for (k, i, pod, res, args, packing), err in zip(admitted, errors):
            with tracer().span(
                "select-node", role=ROLE_DRIVER,
                pod=f"{pod.namespace}/{pod.name}",
            ) as sp:
                if self._metrics is not None:
                    self._metrics.report_packing_efficiency(
                        self.binpacker.name, packing
                    )
                    self._metrics.report_cross_zone(
                        packing.driver_node,
                        packing.executor_nodes,
                        all_nodes
                        if domains[i] is None
                        else [by_name[nm] for nm in domains[i]],
                    )
                self._demands.delete_demand_if_exists(pod)
                if err is not None:
                    # No rollback of the window's committed base: later
                    # window decisions stand even though this app holds
                    # nothing. That is the reference's own durability
                    # stance — reservation writes are fire-and-forget and
                    # "some writes will be lost on leader change"
                    # (failover.go:35-41); the failed app retries, and
                    # failover reconciliation repairs drift.
                    sp.tag("outcome", FAILURE_INTERNAL)
                    self._mark_outcome(
                        pod, ROLE_DRIVER, FAILURE_INTERNAL, timer_start
                    )
                    record(k, pod, args, FAILURE_INTERNAL, None, str(err))
                    results[i] = self._fail(args, FAILURE_INTERNAL, str(err))
                    continue
                if self._events is not None:
                    self._events.emit_application_scheduled(pod, res)
                sp.tag("outcome", SUCCESS)
                self._mark_outcome(pod, ROLE_DRIVER, SUCCESS, timer_start)
                record(k, pod, args, SUCCESS, packing.driver_node)
                results[i] = ExtenderFilterResult(
                    node_names=[packing.driver_node],
                    failed_nodes={},
                    outcome=SUCCESS,
                )

    def _build_serving_tensors(self, snap):
        """Device tensors for the SOLO serving paths from a feature-store
        snapshot, shared with the pipelined window cache: one
        device-resident copy of cluster state, and solo solves see the
        gangs of still-in-flight windows (the threaded base) instead of a
        stale host-only view. If the pipelined build is refused (topology
        changed while windows are in flight, or a pruned window's
        escalation dropped the carry), fall back to an uncached host-truth
        build for this one solve that still debits the windows dispatched
        on a dropped carry (solver.build_tensors_solo)."""
        from spark_scheduler_tpu_torch.core.solver import PipelineDrainRequired

        try:
            return self._solver.build_tensors_pipelined(
                snap.nodes, snap.usage, snap.overhead,
                topo_version=snap.nodes_version,
                statics_version=snap.statics_epoch,
                roster_rows=snap.roster_rows,
                dirty_hint=snap.dirty_hint,
                avail_epoch=snap.avail_epoch,
                avail_journal=snap.avail_journal,
            )
        except PipelineDrainRequired:
            return self._solver.build_tensors_solo(
                snap.nodes, snap.usage, snap.overhead,
                full_node_list=True, topo_version=snap.nodes_version,
                roster_rows=snap.roster_rows,
                avail_epoch=snap.avail_epoch,
                avail_journal=snap.avail_journal,
            )

    def _mark_outcome(self, pod, role, outcome, timer_start) -> None:
        if self._metrics is not None:
            self._metrics.mark_schedule_outcome(
                pod, role, outcome, self._clock() - timer_start
            )

    def _try_preempt_for(
        self, pod, res, candidate_names, domain_names
    ) -> Optional[dict]:
        """Vectorized preemption on a fit denial (policy subsystem): ONE
        batched masked-fit pass over candidate eviction sets, then evict
        the minimal feasible set through the normal teardown path and bump
        the capacity epoch. Best-effort — any failure leaves the denial as
        is, and is counted (`policy.preemption.search.failures`), so that a
        failed launch on the card does not pass for an ordinary denial.
        Returns the recorder payload (eviction set + costs) or None."""
        if self._policy is None or self._policy.preemption is None:
            return None
        try:
            snap = self.features.snapshot()
            tensors = self._build_serving_tensors(snap)
            domain_mask = (
                self._solver.candidate_mask(tensors, list(domain_names))
                if domain_names is not None
                else None
            )
            result = self._policy.try_preempt(
                self._solver,
                self.binpacker.name,
                tensors,
                pod,
                res,
                candidate_names,
                set(domain_names) if domain_names is not None else None,
                domain_mask=domain_mask,
            )
        except Exception as exc:
            from spark_scheduler_tpu_torch.tracing import svc1log

            self._policy.note_search_failure()
            svc1log().warn(
                "preemption search failed; keeping fit denial",
                pod=f"{pod.namespace}/{pod.name}",
                error=repr(exc),
            )
            return None
        if result is None:
            return None
        self._capacity_epoch += 1
        return dataclasses.asdict(result)

    def _record_decision(
        self, pod, role, outcome, node, node_names, message="", ctx=None,
    ) -> None:
        """Append one flight-recorder DecisionRecord. `ctx` is the per-
        decision scratch dict the select paths fill: phase wall times
        ("featurize_ms"/"solve_ms"/"commit_ms"), "queue_position" (earlier
        FIFO drivers re-packed), and "solve_info" (the solver's dispatch
        bucket + compile-cache verdict)."""
        rec = self._recorder
        if rec is None:
            return
        ctx = ctx or {}
        # Capped at the recorder's per-record bound up front: on a
        # 10k-node denial the reason is one identical message, and
        # materializing the full map just for the recorder to truncate it
        # would be an O(nodes) allocation per denial. (The wire response's
        # full FailedNodes map is built by _fail as before.)
        failed_nodes = (
            rec.build_failure_map(node_names, message or outcome)
            if node is None
            else {}
        )
        solve_info = ctx.get("solve_info")
        rec.record(
            namespace=pod.namespace,
            pod_name=pod.name,
            app_id=pod.labels.get(SPARK_APP_ID_LABEL, ""),
            instance_group=(
                find_instance_group(pod, self._config.instance_group_label)
                or ""
            ),
            role=role or "unknown",
            verdict=outcome,
            node=node,
            message=message,
            failed_nodes=failed_nodes,
            queue_position=ctx.get("queue_position"),
            phases={
                k: v
                for k, v in ctx.items()
                if k in ("featurize_ms", "solve_ms", "commit_ms")
                or k.startswith("featurize_")
            },
            solve=solve_info,
            device_id=ctx.get("device_id"),
            state_upload=(
                solve_info.get("state_upload")
                if isinstance(solve_info, dict)
                else None
            ),
            fused_k=(
                solve_info.get("fused_k")
                if isinstance(solve_info, dict)
                else None
            ),
            dispatch_id=(
                solve_info.get("dispatch_id")
                if isinstance(solve_info, dict)
                else None
            ),
            degraded=(
                solve_info.get("degraded")
                if isinstance(solve_info, dict)
                else None
            ),
            redispatches=(
                solve_info.get("redispatches")
                if isinstance(solve_info, dict)
                else None
            ),
            preemption=ctx.get("preemption"),
        )

    # ------------------------------------------------------------- plumbing

    def _fail(self, args: ExtenderArgs, outcome: str, message: str) -> ExtenderFilterResult:
        if self._metrics is not None:
            self._metrics.mark_failed_scheduling_attempt(args.pod, outcome)
        if self._waste is not None:
            self._waste.mark_failed_scheduling_attempt(args.pod, outcome)
        return ExtenderFilterResult(
            node_names=[],
            failed_nodes={name: message for name in args.node_names},
            outcome=outcome,
        )

    def _reconcile_if_needed(self) -> None:
        """Request gap > `extender.resync-gap-seconds` => leader probably
        changed => resync durable state from observed pods
        (resource.go:191-202). Under a HELD HA lease the gap can prove
        nothing (leadership is affirmed every heartbeat, and losing it
        already forces a promotion-time reconcile on the successor), so
        the heuristic is skipped entirely."""
        now = self._clock()
        lease = self.ha_lease
        if lease is not None and lease.is_held():
            self._last_request = now
            return
        if now > self._last_request + self._config.resync_gap_seconds:
            if self._reconciler is not None:
                from spark_scheduler_tpu_torch.tracing import tracer

                with tracer().span("reconcile", reason="leader-election-gap"):
                    self._reconciler.sync_resource_reservations_and_demands()
        self._last_request = now

    def _select_node(
        self, role: str, pod: Pod, node_names: list[str], ctx=None
    ) -> tuple[Optional[str], str, str]:
        if role == ROLE_DRIVER:
            return self._select_driver_node(pod, node_names, ctx=ctx)
        if role == ROLE_EXECUTOR:
            node, outcome, msg = self._select_executor_node(pod, node_names)
            if outcome in SUCCESS_OUTCOMES:
                self._demands.delete_demand_if_exists(pod)
            return node, outcome, msg
        return None, FAILURE_NON_SPARK_POD, "can not schedule non spark pod"

    # --------------------------------------------------------------- driver

    def _select_driver_node(
        self, driver: Pod, node_names: list[str], ctx=None
    ) -> tuple[Optional[str], str, str]:
        if ctx is None:
            ctx = {}
        t0 = self._clock()
        app_id = driver.labels.get(SPARK_APP_ID_LABEL, "")
        rr = self._rrm.get_resource_reservation(app_id, driver.namespace)
        if rr is not None:
            # Idempotent retry: return the previously reserved node even if
            # absent from the candidate list (resource.go:273-286).
            return rr.spec.reservations[DRIVER_RESERVATION].node, SUCCESS, ""

        snap = self.features.snapshot()
        all_nodes = snap.nodes
        available_nodes = [n for n in all_nodes if pod_matches_node(driver, n)]

        try:
            app_resources = spark_resources(driver)
        except SparkPodError as exc:
            return None, FAILURE_INTERNAL, f"failed to get spark resources: {exc}"

        earlier: Sequence[Pod] = ()
        if self._config.fifo:
            if self._policy is not None:
                group = find_instance_group(
                    driver, self._config.instance_group_label
                )
                blockers, hard = self._policy.ordering.blockers(
                    driver, group, self._parse_pending_drivers(), self._clock()
                )
                if hard:
                    self._demands.create_demand_for_application(
                        driver, app_resources
                    )
                    return (
                        None,
                        FAILURE_EARLIER_DRIVER,
                        "yielding to instance group with smaller dominant share",
                    )
                earlier = [row[0] for row in blockers]
            else:
                earlier = self._pod_lister.list_earlier_drivers(driver)
            # None (not 0) when FIFO is off: the record must distinguish
            # "first in queue" from "queue never consulted".
            ctx["queue_position"] = len(earlier)

        if self._config.batched_admission and self._solver.can_batch(
            self.binpacker.name
        ):
            # ONE device program admits the whole FIFO prefix + this driver
            # (SURVEY.md §2d row 1) — replaces fitEarlierDrivers' per-driver
            # re-pack loop (resource.go:221-258) AND the final pack with a
            # single batched solve, sorting once per request like the
            # reference (resource.go:299; see ExtenderConfig.batched_admission
            # for how this can differ from the sequential fallback). Cluster
            # state is device-resident: full node list + delta upload,
            # affinity filtering via the domain mask.
            tensors = self._build_serving_tensors(snap)
            domain = self._solver.candidate_mask(
                tensors, [n.name for n in available_nodes]
            )
            s0 = self._clock()
            ctx["featurize_ms"] = (s0 - t0) * 1e3
            packing, outcome, message = self._admit_driver_batched(
                driver, app_resources, earlier, tensors, node_names, domain
            )
            ctx["solve_ms"] = (self._clock() - s0) * 1e3
            ctx["solve_info"] = self._solver.last_solve_info
            if packing is None:
                if outcome == FAILURE_FIT and not ctx.get("preempted"):
                    pre = self._try_preempt_for(
                        driver,
                        app_resources,
                        node_names,
                        [n.name for n in available_nodes],
                    )
                    if pre is not None:
                        # Inline one-shot retry against the freed cluster
                        # (the windowed path instead denies and lets the
                        # pod's retry admit — see _complete_driver_window).
                        ctx["preempted"] = True
                        ctx["preemption"] = pre
                        return self._select_driver_node(
                            driver, node_names, ctx=ctx
                        )
                self._demands.create_demand_for_application(driver, app_resources)
                return None, outcome, message
        else:
            # Sequential fallback (batching disabled by config).
            overhead = self._overhead.get_overhead(available_nodes)
            tensors = self._solver.build_tensors(
                available_nodes, snap.usage, overhead
            )
            s0 = self._clock()
            ctx["featurize_ms"] = (s0 - t0) * 1e3
            if earlier:
                tensors, ok = self._fit_earlier_drivers(earlier, tensors, node_names)
                if not ok:
                    ctx["solve_ms"] = (self._clock() - s0) * 1e3
                    self._demands.create_demand_for_application(driver, app_resources)
                    return None, FAILURE_EARLIER_DRIVER, "earlier drivers do not fit to the cluster"

            packing = self._solver.pack(
                self.binpacker.name,
                tensors,
                app_resources.driver_resources,
                app_resources.executor_resources,
                app_resources.min_executor_count,
                node_names,
            )
            ctx["solve_ms"] = (self._clock() - s0) * 1e3
            ctx["solve_info"] = self._solver.last_solve_info
            if not packing.has_capacity:
                if not ctx.get("preempted"):
                    pre = self._try_preempt_for(
                        driver,
                        app_resources,
                        node_names,
                        [n.name for n in available_nodes],
                    )
                    if pre is not None:
                        ctx["preempted"] = True
                        ctx["preemption"] = pre
                        return self._select_driver_node(
                            driver, node_names, ctx=ctx
                        )
                self._demands.create_demand_for_application(driver, app_resources)
                return None, FAILURE_FIT, "application does not fit to the cluster"

        c0 = self._clock()
        if self._metrics is not None:
            self._metrics.report_packing_efficiency(self.binpacker.name, packing)
            self._metrics.report_cross_zone(
                packing.driver_node, packing.executor_nodes, available_nodes
            )
        self._demands.delete_demand_if_exists(driver)
        try:
            self._rrm.create_reservations(
                driver,
                app_resources,
                packing.driver_node,
                packing.executor_nodes,
            )
        except ReservationError as exc:
            ctx["commit_ms"] = (self._clock() - c0) * 1e3
            return None, FAILURE_INTERNAL, str(exc)
        # Solo-path capacity change: stale in-flight windows must re-solve.
        self._capacity_epoch += 1
        if self._events is not None:
            # Only on fresh admission — the idempotent-retry branch above
            # must not double-emit application_scheduled (events.go:27-50).
            self._events.emit_application_scheduled(driver, app_resources)
        ctx["commit_ms"] = (self._clock() - c0) * 1e3
        return packing.driver_node, SUCCESS, ""

    def _admit_driver_batched(
        self,
        driver: Pod,
        app_resources,
        earlier: Sequence[Pod],
        tensors,
        node_names: list[str],
        domain_mask=None,
    ):
        """Batched FIFO admission: earlier drivers + the current driver as
        one single-segment `pack_window` solve — the same device program the
        coalesced serving window runs. Returns (packing|None, outcome,
        message); None packing means the caller creates a demand and fails
        the request (resource.go:241-249 / :342-345 outcome split)."""
        rows = []
        for ed in earlier:
            try:
                res = spark_resources(ed)
            except SparkPodError:
                continue  # unparseable driver is skipped (resource.go:228-233)
            rows.append(
                (
                    res.driver_resources,
                    res.executor_resources,
                    res.min_executor_count,
                    self._should_skip_driver_fifo(ed),
                )
            )
        rows.append(
            (
                app_resources.driver_resources,
                app_resources.executor_resources,
                app_resources.min_executor_count,
                False,
            )
        )
        # ONE single-segment pack_window: the same program the coalesced
        # serving window runs, so solo and windowed serving share semantics
        # exactly — including sorting ONCE per request (resource.go:299).
        decision = self._solver.pack_window(
            self.binpacker.name,
            tensors,
            [
                WindowRequest(
                    rows=rows,
                    driver_candidate_names=node_names,
                    domain_mask=domain_mask,
                )
            ],
        )[0]
        if decision.admitted:
            return decision.packing, SUCCESS, ""
        if decision.earlier_blocked:
            return None, FAILURE_EARLIER_DRIVER, "earlier drivers do not fit to the cluster"
        return None, FAILURE_FIT, "application does not fit to the cluster"

    def _fit_earlier_drivers(
        self, drivers: Sequence[Pod], tensors, node_names: list[str]
    ):
        """FIFO prefix admission (resource.go:221-258): every earlier driver
        must hypothetically fit (or be young enough to skip); each fit
        subtracts its placements from availability.

        Deviation from the reference, deliberate: the reference's
        `sparkResourceUsage` (sparkpods.go:141-149) OVERWRITES per-node usage
        (one executor's worth per distinct node, driver slot clobbered by
        executors on the same node), under-reserving for earlier drivers. We
        scatter-ADD the true usage of every placement.
        """
        for driver in drivers:
            try:
                app_resources = spark_resources(driver)
            except SparkPodError:
                continue  # unparseable driver is skipped (resource.go:228-233)
            packing = self._solver.pack(
                self.binpacker.name,
                tensors,
                app_resources.driver_resources,
                app_resources.executor_resources,
                app_resources.min_executor_count,
                node_names,
            )
            if not packing.has_capacity:
                if self._should_skip_driver_fifo(driver):
                    continue
                return tensors, False
            usage: dict = {}
            from spark_scheduler_tpu_torch.models.resources import Resources as _R

            usage[packing.driver_node] = app_resources.driver_resources.copy()
            for node in packing.executor_nodes:
                usage.setdefault(node, _R.zero()).add(app_resources.executor_resources)
            tensors = self._solver.subtract_usage(tensors, usage)
        return tensors, True

    def _should_skip_driver_fifo(self, pod: Pod) -> bool:
        """Age-gated FIFO enforcement (resource.go:260-270)."""
        from spark_scheduler_tpu_torch.core.sparkpods import find_instance_group

        group = find_instance_group(pod, self._config.instance_group_label) or ""
        age_gate = self._config.fifo_config.enforce_after_pod_age_by_instance_group.get(
            group, self._config.fifo_config.enforce_after_pod_age_s
        )
        return pod.creation_timestamp + age_gate > self._clock()

    # ------------------------------------------------------------- executor

    def _serve_executor_window(self, t: WindowTicket, ids: list[int]) -> None:
        """Serve a run of consecutive executor requests of a window with
        grouped passes instead of one full ladder per request:

        1. Per app: ONE pass over the reservation/soft stores resolves
           already-bound / unbound / needs-spot for the whole batch
           (rrm.executor_ladder_batch — one fetch, one active-pod listing,
           one cache write per app per window).
        2. ONE grouped device solve places all reschedule stragglers
           (pack_window, one 1-executor segment per straggler; each segment
           commits into the threaded base, so later stragglers see earlier
           placements — replacing one `pack` device round trip per
           straggler with one for the whole window).

        Decisions match serving the run serially through
        _select_executor_node, with two documented conservative deviations:
        a straggler's slot-move frees its OLD node only after this window
        (a later straggler in the same window does not see that freed
        capacity), and when a straggler's solve fails, later same-app
        executors that were classified no-spots fail failure-fit (the
        outcome the serial re-attempt would reach) without re-solving.
        Anchor: resource.go:376-428."""
        from spark_scheduler_tpu_torch.tracing import tracer

        args_list, results = t.args_list, t.results

        def finish(i, node, outcome, message=""):
            pod = args_list[i].pod
            with tracer().span(
                "select-node", role=ROLE_EXECUTOR,
                pod=f"{pod.namespace}/{pod.name}",
            ) as sp:
                sp.tag("outcome", outcome)
            self._mark_outcome(pod, ROLE_EXECUTOR, outcome, t.timer_start)
            self._record_decision(
                pod, ROLE_EXECUTOR, outcome, node,
                args_list[i].node_names, message,
            )
            if node is None:
                results[i] = self._fail(args_list[i], outcome, message or outcome)
            else:
                self._demands.delete_demand_if_exists(pod)
                results[i] = ExtenderFilterResult(
                    node_names=[node], failed_nodes={}, outcome=outcome
                )

        by_app: dict[tuple[str, str], list[int]] = {}
        for i in ids:
            pod = args_list[i].pod
            key = (pod.namespace, pod.labels.get(SPARK_APP_ID_LABEL, ""))
            by_app.setdefault(key, []).append(i)

        stragglers: list[dict] = []
        straggler_by_pod: dict[tuple[str, str], dict] = {}
        dup_waiters: dict[tuple[str, str], list[int]] = {}
        deferred_no_spots: dict[tuple[str, str], list[int]] = {}
        app_ctx: dict[tuple[str, str], tuple] = {}
        for key, app_ids in by_app.items():
            namespace, app_id = key
            try:
                rungs = self._rrm.executor_ladder_batch(
                    app_id, namespace,
                    [(args_list[i].pod, args_list[i].node_names) for i in app_ids],
                )
            except ReservationError as exc:
                for i in app_ids:
                    finish(
                        i, None, FAILURE_INTERNAL,
                        f"error when looking for already bound reservations: {exc}",
                    )
                continue
            for i, (kind, val) in zip(app_ids, rungs):
                pod = args_list[i].pod
                if kind == "already":
                    finish(i, val, SUCCESS_ALREADY_BOUND)
                elif kind == "bound":
                    finish(i, val, SUCCESS)
                elif kind == "no-spots":
                    deferred_no_spots.setdefault(key, []).append(i)
                elif kind == "dup-reschedule":
                    # Same pod submitted twice in one window; resolved from
                    # the first occurrence's result after the solve.
                    dup_waiters.setdefault(
                        (pod.namespace, pod.name), []
                    ).append(i)
                else:  # reschedule
                    ctx = app_ctx.get(key)
                    if ctx is None:
                        ctx = app_ctx[key] = self._reschedule_context(pod)
                    pod_key = (pod.namespace, pod.name)
                    if ctx[0] is None:
                        finish(i, None, FAILURE_INTERNAL, ctx[2])
                        straggler_by_pod[pod_key] = {
                            "result": ("internal", ctx[2])
                        }
                        continue
                    exec_res, zone, _ = ctx
                    names = [
                        n.name
                        for name in args_list[i].node_names
                        if (n := self._backend.get_node(name)) is not None
                        and (zone is None or n.zone == zone)
                    ]
                    entry = {
                        "i": i, "key": key, "exec_res": exec_res,
                        "zone": zone, "names": names, "is_extra": not val,
                        "result": None,
                    }
                    stragglers.append(entry)
                    straggler_by_pod[pod_key] = entry
        # Solve stragglers in ARRIVAL order: pack_window commits segment
        # placements sequentially, so under capacity contention the earlier
        # request must win the spot exactly as serial serving would.
        stragglers.sort(key=lambda s: s["i"])

        app_failed: set[tuple[str, str]] = set()
        app_internal: dict[tuple[str, str], str] = {}
        if stragglers:
            from spark_scheduler_tpu_torch.models.resources import Resources as _R

            tensors = self._build_serving_tensors(self.features.snapshot())
            decisions = self._solver.pack_window(
                "tightly-pack",
                tensors,
                [
                    WindowRequest(
                        rows=[(_R.zero(), s["exec_res"], 1, False)],
                        driver_candidate_names=s["names"],
                        domain_node_names=s["names"],
                    )
                    for s in stragglers
                ],
            )
            rescheduled = False
            for s, d in zip(stragglers, decisions):
                i = s["i"]
                pod = args_list[i].pod
                if d.admitted and d.packing.executor_nodes:
                    node = d.packing.executor_nodes[0]
                    try:
                        self._rrm.reserve_for_executor_on_rescheduled_node(
                            pod, node
                        )
                    except ReservationError as exc:
                        msg = f"failed to reserve node for rescheduled executor: {exc}"
                        finish(i, None, FAILURE_INTERNAL, msg)
                        s["result"] = ("internal", msg)
                        # NOT app_failed: capacity exists (the solve
                        # admitted); a serial re-attempt by a later same-app
                        # executor would hit the same write failure, so
                        # those fail internal below, not failure-fit.
                        app_internal[s["key"]] = msg
                        continue
                    rescheduled = True
                    s["result"] = ("ok", node)
                    finish(
                        i, node,
                        SUCCESS_SCHEDULED_EXTRA_EXECUTOR
                        if s["is_extra"]
                        else SUCCESS_RESCHEDULED,
                    )
                else:
                    self._demands.create_demand_for_executor(
                        pod, s["exec_res"], zone=s["zone"]
                    )
                    s["result"] = ("fit", None)
                    finish(
                        i, None, FAILURE_FIT,
                        "not enough capacity to reschedule the executor",
                    )
                    app_failed.add(s["key"])
            if rescheduled:
                # New usage on nodes the reservations did not cover: stale
                # in-flight windows must re-solve (one bump covers the run).
                self._capacity_epoch += 1

        # Duplicate submissions resolve from their first occurrence: success
        # means the bind has applied, so the serial rung 1 would now return
        # already-bound (only for an OFFERED node — rung 1 checks the
        # request's own candidates; a non-offered node fails unbound, a
        # conservative stand-in for the serial path's rebind-on-new-spot,
        # and the client's next retry walks the full ladder); a failed
        # first occurrence means the retry would re-attempt the identical
        # reschedule and fail the identical way.
        for pod_key, idxs in dup_waiters.items():
            first = straggler_by_pod.get(pod_key)
            result = first.get("result") if first is not None else None
            for i in idxs:
                if result is not None and result[0] == "ok":
                    if result[1] in args_list[i].node_names:
                        finish(i, result[1], SUCCESS_ALREADY_BOUND)
                    else:
                        finish(
                            i, None, FAILURE_UNBOUND,
                            "application has no free executor spots to schedule this one",
                        )
                elif result is not None and result[0] == "internal":
                    finish(i, None, FAILURE_INTERNAL, result[1])
                else:
                    finish(
                        i, None, FAILURE_FIT,
                        "not enough capacity to reschedule the executor",
                    )

        for key, idxs in deferred_no_spots.items():
            ctx = app_ctx.get(key)
            if ctx is not None and ctx[0] is None:
                # Serial equivalence: the spot was only pre-consumed by an
                # executor whose reschedule context failed (spot never
                # actually used), so these would have re-attempted and hit
                # the same internal error.
                for i in idxs:
                    finish(i, None, FAILURE_INTERNAL, ctx[2])
            elif key in app_internal:
                # The spot was freed by a reservation-write failure, not a
                # capacity shortage — a serial re-attempt hits the same
                # write failure.
                for i in idxs:
                    finish(i, None, FAILURE_INTERNAL, app_internal[key])
            elif key in app_failed:
                # Serial equivalence: the failed straggler left its spot
                # unconsumed, so these executors would have re-attempted the
                # identical reschedule and failed the identical way.
                for i in idxs:
                    pod = args_list[i].pod
                    if ctx is not None and ctx[0] is not None:
                        exec_res, zone, _ = ctx
                        self._demands.create_demand_for_executor(
                            pod, exec_res, zone=zone
                        )
                    finish(
                        i, None, FAILURE_FIT,
                        "not enough capacity to reschedule the executor",
                    )
            else:
                for i in idxs:
                    finish(
                        i, None, FAILURE_UNBOUND,
                        "application has no free executor spots to schedule this one",
                    )

    def _reschedule_context(
        self, executor: Pod
    ) -> tuple[Optional["Resources"], Optional[str], Optional[str]]:
        """Per-app context for reschedule stragglers:
        (exec_resources, single-az zone restriction | None, None) on
        success, (None, None, error message) on failure — the error rides
        its own slot so no caller can mistake it for a zone name."""
        driver = self._pod_lister.get_driver_for_executor(executor)
        if driver is None:
            return None, None, "failed to get driver pod for executor"
        try:
            app_resources = spark_resources(driver)
        except SparkPodError as exc:
            return None, None, str(exc)
        zone = None
        if (
            self.binpacker.is_single_az
            and self._config.schedule_dynamically_allocated_executors_in_same_az
        ):
            try:
                z, all_same_az = self._common_zone_for_app(executor)
            except ReservationError as exc:
                return None, None, str(exc)
            if all_same_az:
                zone = z
        return app_resources.executor_resources, zone, None

    def _select_executor_node(
        self, executor: Pod, node_names: list[str]
    ) -> tuple[Optional[str], str, str]:
        try:
            bound_node, found = self._rrm.find_already_bound_reservation_node(executor)
        except ReservationError as exc:
            return None, FAILURE_INTERNAL, f"error when looking for already bound reservations: {exc}"
        if found:
            if bound_node in node_names:
                return bound_node, SUCCESS_ALREADY_BOUND, ""
            # bound node not offered; fall through (resource.go:377-388)

        try:
            chosen, unbound_count = self._rrm.reserve_executor_on_unbound(
                executor, node_names
            )
        except ReservationError as exc:
            return None, FAILURE_INTERNAL, f"error when looking for unbound reservations: {exc}"
        if chosen is not None:
            return chosen, SUCCESS, ""
        found_unbound = unbound_count > 0

        try:
            free_spots = self._rrm.get_remaining_allowed_executor_count(
                executor.labels.get(SPARK_APP_ID_LABEL, ""), executor.namespace,
                unbound_count=unbound_count,
            )
        except ReservationError as exc:
            return None, FAILURE_INTERNAL, f"error when checking for remaining allowed executor count: {exc}"
        if free_spots > 0:
            is_extra = not found_unbound
            node, outcome, msg = self._reschedule_executor(executor, node_names, is_extra)
            if node is None:
                return None, outcome, msg
            try:
                self._rrm.reserve_for_executor_on_rescheduled_node(executor, node)
            except ReservationError as exc:
                return None, FAILURE_INTERNAL, f"failed to reserve node for rescheduled executor: {exc}"
            # New usage on a node the reservation did not already cover:
            # stale in-flight windows must re-solve.
            self._capacity_epoch += 1
            return node, outcome, msg

        return None, FAILURE_UNBOUND, "application has no free executor spots to schedule this one"

    def _reschedule_executor(
        self, executor: Pod, node_names: list[str], is_extra: bool
    ) -> tuple[Optional[str], str, str]:
        """First executor-priority-ordered node with room (resource.go:565-639),
        optionally restricted to the app's common AZ for single-AZ dynamic
        allocation. Context derivation (driver lookup, resources, single-AZ
        zone — incl. the reference's error-the-request semantics,
        resource.go:583-586) is shared with the windowed path via
        _reschedule_context so the two ladders cannot drift."""
        exec_res, single_az_zone, ctx_error = self._reschedule_context(
            executor
        )
        if exec_res is None:
            return None, FAILURE_INTERNAL, ctx_error

        nodes = [
            n
            for name in node_names
            if (n := self._backend.get_node(name)) is not None
        ]
        if single_az_zone is not None:
            nodes = [n for n in nodes if n.zone == single_az_zone]

        tensors = self._build_serving_tensors(self.features.snapshot())
        domain = self._solver.candidate_mask(tensors, [n.name for n in nodes])
        # A 1-executor gang with no driver = "first sorted node with room".
        packing = self._solver.pack(
            "tightly-pack",
            tensors,
            type(exec_res).zero(),
            exec_res,
            1,
            [n.name for n in nodes],
            domain_mask=domain,
        )
        if packing.has_capacity and packing.executor_nodes:
            outcome = SUCCESS_SCHEDULED_EXTRA_EXECUTOR if is_extra else SUCCESS_RESCHEDULED
            return packing.executor_nodes[0], outcome, ""

        self._demands.create_demand_for_executor(
            executor, exec_res, zone=single_az_zone
        )
        return None, FAILURE_FIT, "not enough capacity to reschedule the executor"

    def _common_zone_for_app(self, executor: Pod) -> tuple[Optional[str], bool]:
        """(zone, running pods all in one AZ?) (resource.go:472-506). Raises
        ReservationError for the reference's error cases: no app-id label, no
        running pods, or an unresolvable node — callers must fail the request
        rather than fall back to any-AZ scheduling."""
        app_id = executor.labels.get(SPARK_APP_ID_LABEL)
        if app_id is None:
            raise ReservationError(
                "executor does not have a Spark app id label, could not create label selector"
            )
        pods = self._pod_lister.list_app_pods(app_id, executor.namespace)
        zones = set()
        for pod in pods:
            if pod.phase != "Running" or not pod.node_name:
                continue
            node = self._backend.get_node(pod.node_name)
            if node is None:
                raise ReservationError(
                    f"could not read zone label from node {pod.node_name}"
                )
            zones.add(node.zone)
        if len(zones) > 1:
            return None, False
        if not zones:
            raise ReservationError(
                "application has no scheduled pods, can't make scheduling decisions based on AZ"
            )
        return next(iter(zones)), True
