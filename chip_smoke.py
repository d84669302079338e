#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (spark_scheduler_tpu_torch) on one
NVIDIA GPU: the quickest proof that the port still builds, starts and
decides right on the card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

  1. Build every CUDA source of the port with nvcc (one process per source,
     all at once) and, beside them, the port's native runtime
     (spark_scheduler_tpu_torch/native/runtime.cpp) with g++; launch the
     probe kernel and check it, print the card. First, an app whose
     `jax-compilation-cache-dir` is a fresh temporary directory builds the
     native runtime and the probe's library there, and the probe launches
     from that library.
  2. Kernel vs plain, small: the CUDA window kernel (`window_pack` on CUDA
     tensors, one thread-block cluster per segment) against its plain
     PyTorch version (`window_pack_reference`) on the same CUDA inputs, all
     six strategies, seeded random windows at N = 24 and N = 300 (roomy and
     tight clusters) and N = 8,193 and 10,000 with the node state in shared
     memory, at N = 300 and 10,000 with it forced into global memory, and
     gangs up to 2,048 executors wide. Every output must be identical
     (tolerance: none).
  2b. The same for the CUDA queue kernel: `fifo_pack` on CUDA tensors
     against `fifo_pack_reference` on the same CUDA inputs, all six
     strategies, N = 24 and N = 300 (roomy and tight), B = 9 padded to 12
     with gangs up to emax + 2 wide; then per strategy negative
     availability with zero-count gangs, strict-FIFO blocking behind a
     too-big gang, an empty queue (B = 0: no launch), and a grouped solve of
     3 queues (`grouped_fifo_pack`, one launch). Then each of the kernel's
     four layouts forced (block or cluster team, node state in shared or
     global memory; `ops/fifo.queue_layout`) where it fits, at N = 9 to
     10,000 and with gangs up to 2,048 wide. Tolerance: none.
  3. Main path at full width: a 10,000-node cluster (4 zones, heterogeneous
     nodes, ~10% with GPUs, 30-70% prior usage) built through
     `PlacementSolver(device="cuda").build_tensors`; 4 windows of 32
     requests with `pack_window("tightly-pack", ...)`, then one window per
     other strategy. Each request carries 0-63 FIFO-earlier pending drivers
     plus its own application; some gangs are 2-32 executors wide (emax 32).
     Admitted gangs are committed into the usage between windows. Every
     window's decisions must equal those of `PlacementSolver(device="cpu")`
     on the same state. Kernel launch counts are read around this phase.
  4. Measurements: at a main-path window, the window kernel wrapper's time,
     its plain version's time on the card, the bound, a device-time split,
     for the shared-memory layout (the main path's) and the global-state
     layout in turns; the kernel's registers and the card's resident-cluster
     count; at a config-5 queue window (10,000 nodes, 100 apps), the same
     for the queue kernel; the probe and `torch.add`, by CUDA events and
     device time. Then the queue kernel's registers, spills and resident
     teams per layout, its device time in every layout that fits at the
     first window of configs 5, 3, 2 and 4 (in turns A B .. B A), and the
     block/cluster crossover sweep (N = 500 to 10,000) behind
     `QUEUE_CLUSTER_MIN_NODES`.
  5. The queue path at full width: BASELINE.json configs 1, 2, 2b, 3, 4
     and 5, generated as bench.py does (`_make_cluster`, `_make_batches`,
     numpy from a seed), the availability threaded from window to window as
     bench.py's `_windowed_chain` does. Config 5: 10,000 nodes, 1,000 apps
     in 10 windows of 100 (tightly-pack), then one window per other
     strategy; config 4: 5 instance groups of 1,000 nodes solved by
     `grouped_fifo_pack`, one launch per call. Every decision and every
     `available_after` must equal the CPU plain path on the same state.
     Queue-kernel launch counts are read around this phase.

  6. The extender on the card: two `SparkSchedulerExtender`s wired from the
     port's parts, one on `PlacementSolver(device="cuda")` and one on
     `PlacementSolver(device="cpu")`, each on its own in-memory backend
     holding phase 3's 10,000 nodes (one instance group, the prior usage as
     one running pod of another scheduler per node); `tightly-pack`, FIFO
     on, synchronous write-back, one fixed clock. Both get the same
     traffic: 256 driver predicates in 8 windows of 32, window k+1
     dispatched (`predicate_window_dispatch`) before window k completes,
     as the server's PredicateBatcher does (gangs of 2-8 executors, ~15%
     32 wide); the admitted apps' executors in the following windows; 16
     dynamic-allocation extra executors (soft reservations); a pod deletion
     and a node add, each while windows are in flight (the availability
     and static deltas of the pipelined build); then 16 executor
     reschedules, each a solo `pack` (one row of the row-walk kernel).
     Every result, reservation and demand must be equal on both sides;
     every driver window must launch the row walk once per segment and
     every solo pack once. Prints the launches, the build kinds
     (full / delta / reuse) and the p50 / p99 wall time of
     `predicate_window_complete` and of a solo pack on the card.
  7. The HTTP server on the card: the port's `build_scheduler_app(...,
     device="cuda")` behind `SchedulerHTTPServer` on port 0 (threaded
     transport, flight recorder and debug routes on, `tightly-pack`, FIFO
     on, synchronous write-back, one fixed clock). Readiness answers 503
     until the first nodes arrive through PUT /state/nodes, then 200; the
     rest of phase 3's 10,000 nodes (one instance group, the prior usage as
     one running pod each) are added in process. 32 client threads post
     256 driver predicates as k8s JSON, each after its pod's PUT
     /state/pods (gangs of 2-8 executors, ~15% 32 wide); a pod DELETE and a
     node PUT land while the third window is in flight; then the admitted
     drivers are bound and their executors posted; then GET /metrics and
     GET /status/readiness. Every pod and node change and every window the
     batcher dispatched and completed is recorded in order, and a `cpu`
     app of the port replays them: every response must equal its answer
     byte for byte. The driver windows must be the ones /debug/decisions
     reports (`dispatch_id`), the over-commit check
     (`testing.harness.overcommit_violations`) must find nothing, and the
     row-walk launches must equal the live segments of the dispatched
     windows plus the solo packs. Prints the windows formed, the mean
     window and the client-side p50 / p99 latency and decisions per second
     of driver and executor predicates.
  8. Phase 7's traffic at the same width on the async transport with the
     native ingest lane: `SchedulerHTTPServer(transport="async",
     ingest="native")` in front of a fresh `build_scheduler_app(...,
     device="cuda")`. Half the client threads post the k8s JSON body, the
     other half the binary `application/x-spark-predicate` body with the
     same content. The same record, cpu replay (byte for byte), decisions,
     over-commit and launch checks as phase 7; besides, every native
     decode must be a fast-path hit (hit ratio 1.0), and /metrics'
     `solver.window.dispatches`, `solver.device.uploads` and d2h
     `solver.transfer.bytes` must equal the dispatches, pipelined builds
     (by kind) and decision bytes this script counted. Prints the windows,
     the client-side p50 / p99 and decisions per second beside phase 7's,
     the batcher's busy time per stage, the native decode hit ratio and
     decode-ns p50, and the async transport's parse, queue and write
     means and keep-alive reuse.

  9. Apiserver ingestion and the WAL store at full width: the port's
     `FakeKubeAPIServer` holds phase 3's 10,000 nodes and one prior-usage
     pod a node; `build_scheduler_app(DurableBackend(wal),
     InstallConfig(kube_api_url=..., durable_store_path=wal, ...),
     device="cuda")` behind `SchedulerHTTPServer` (threaded, recorder on)
     answers readiness 503 until its reflectors have listed, then 200. 128
     driver pods are created in the apiserver, and 32 clients post their
     predicates (10,000 names each) once the watch has brought each pod in;
     admitted drivers are bound by a pod update in the apiserver; a node
     add and a pod delete land in the apiserver and reach the backend while
     the third window is in flight; then half of each admitted app's
     executors, each bound. The recorder wraps the backend's generic
     create / update / delete, which the watch writes through. Then the
     stop: a fresh `cuda` app on the same WAL and apiserver waits for the
     sync, reconciles, and only then serves; its reservations must equal
     those before the stop, and the other executors must land on their
     apps' reserved nodes. Every response must equal a cpu replay byte for
     byte (the restarted server's on a cpu app restarted from a copy of the
     WAL, with the same reconcile summary); driver windows, over-commit and
     launches as phase 7. Prints the sync time, the informer delay
     (apiserver create to backend, host clock), the WAL's records and bytes,
     the reconcile time and the driver and executor p50 / p99.
 10. HA failover on the card: replicas r0 and r1 from `build_replica(...,
     device="cuda")`, each on `DurableBackend(wal, follow=True)` over phase
     9's WAL with `FileLeaseStore(wal + ".lease")` (TTL 1 s) and ingestion
     from phase 9's apiserver, each behind its own server. r0 wins the
     election and serves 64 drivers; 64 more drivers are created, and r0 is
     killed (`ReplicaRuntime.kill()`, its ingestion stopped) while the
     first of their windows is in flight. r1 must take over within the TTL,
     one heartbeat and its promotion; r0's answers after the kill are
     dropped (a dead process's) and posted again to r1, which then serves
     them and every admitted app's executors. Readiness and role per
     replica, before and after, are the JAX package's; every admitted
     driver has exactly one reservation in the WAL; no over-commit; r0's
     and r1's responses equal cpu replicas promoted from copies of the WAL
     (as phase 10 found it, and at the kill), with the same reconcile
     summaries. Prints the promotion and reconcile times and the time from
     the kill to r1's first 200.

 11. Fused claims: phase 7's cluster, traffic and checks (every response
     byte-identical to a cpu replay, driver windows as /debug/decisions
     reports them, no over-commit, row-walk launches = live segments + solo
     packs, /metrics against this script's count) with
     `solver.fuse-windows: 4` and windows of 8, so the 32 clients back up
     past one window and the batcher dispatches up to four windows as one
     row-walk dispatch with one decision pull; at least one claim must
     fuse. Prints the fused dispatches, the fused_k histogram, the
     per-window amortized round trip and the latencies beside phase 7's.
     Then, below the server: `pack_windows_dispatch` of four phase-3-style
     windows on a `cuda` solver must equal four back-to-back
     `pack_window_dispatch` calls on the same state and launch the row walk
     once a segment; `batched_fifo_pack` (plain PyTorch on CUDA tensors)
     must equal the row walk's `window_pack` on phase 3's last
     tightly-pack window (window mode) and the queue kernel's `fifo_pack`
     on a config-5 queue of 100 apps (queue mode), each call's time beside
     the kernel's. These comparison launches count toward no kernel's
     main-path launches.
 12. The pruned two-tier solve (`solver.prune-top-k`) on the card. (a)
     Phase 3's cluster and prior usage: 16 pipelined windows of 8
     tightly-pack requests shaped as phase 7's apps (gangs of 2-8
     executors, ~15% 32 wide, 0-1 FIFO-earlier drivers each), dispatched
     two at a time before either is fetched, with churn between pairs
     (64 nodes' usage, a node added, a node's zone label moved); then the
     same with one fused K = 2 dispatch a pair; then a tight arm (top-k 8,
     slack 0.25, 4 windows) that must escalate. Each arm runs, in
     lockstep, a `cuda` solver with `prune_top_k=64, prune_slack=2.0`, a
     `cuda` solver without pruning and a `cpu` solver with pruning: every
     WindowDecision must be equal, and so must the two pruned solvers'
     prune_stats; at least 12 of the 16 windows must be dispatched pruned;
     the pruned solver's row-walk launches must equal the live segments of
     every dispatch (pruned, declined, and again for each full re-solve
     after an escalation). (b) Phase 7's server with `solver.prune-top-k:
     64`, 4 client threads, 128 drivers (each request carries the other
     clients' pending drivers as FIFO-earlier rows), a pod DELETE and a
     node PUT mid-window, then the executors: every response equal to a
     cpu replay on an UNPRUNED app, at least half the driver-window
     dispatches pruned (/debug/state's prune block), no over-commit. (c)
     100,000 nodes: 20 windows of 32 requests, pruned against unpruned on
     `cuda`, decisions equal. Prints per arm the pruned dispatches, kept
     rows, escalations by reason, launches, the host planning means
     (plan, gather, offset) and planner rows, the window p50 pruned
     against unpruned (host clock ending in a synchronise; pair 0 warms
     up and the profiled pair is not timed) and, on one profiled pair,
     the row walk's device ms a window and µs a row, the other device
     work and the device idle share. The launch counts are the pruned
     solvers' and the server's, never the comparison solvers'.
 13. The policy engine and the elastic autoscaler through the server on
     the card, each on phase 3's cluster behind `build_scheduler_app(...,
     device="cuda")` (threaded transport, python ingest) with an injected
     clock that moves only through marked log entries, so a `cpu` app
     replays the record (every predicate's answers in order, byte for
     byte; every marked step returns the same on it). (a) `policy.enabled`
     with priority ordering, preemption (8 evictions at most, `system`
     protected) and defrag (budget 4); the clients offer a 512-node
     instance group of its own: a `system` gang, 4 small low gangs with
     dynamic allocation and all their executors (the soft extras), then
     low gangs of 64 executors until the group is full; then 6 high gangs
     twice that size, each denied with an eviction (one
     `preemption_search` on the card over up to 8 nested eviction sets)
     and admitted on its retry; a high gang no eviction admits stays
     pending; the highs end, the low drivers without a reservation queue
     behind the pending high one, the clock passes two promotion
     intervals and they admit; one forced defrag pass. Checks: the
     replay, the same eviction sets and reservations, the `system` gang
     never evicted, no over-commit after every stage, a preemption and a
     promotion-driven admission, fragmentation not above its value before
     the pass, `preemption_search` on the card with 0 search failures.
     Prints the preemptions, evictions, the search's p50 (host clock),
     the last `preemption_batched_fit` call's time on the card (CUDA
     events) beside the cpu's, the fragmentation before and after, and
     row-walk launches = live segments + segments solved at completion +
     solo packs. (b) `autoscaler.enabled` (phase 3's zones, a template
     node of phase 3's largest, max-cluster-size 10,400, idle-ttl 60 s)
     with `solver.delta-statics: false`, so a node added mid-window drains
     the pipeline: 8 running dynamic-allocation apps; 16 drivers of a full
     64-node instance group are denied with demands; they retry while the
     running apps' extra executors arrive, and one `autoscaler.run_once()`
     runs right after a dispatch that leaves a window with extra
     executors in flight behind it: the solo solve of those executors
     builds across the topology change and debits the windows in flight;
     the retried drivers admit on the new nodes; the apps end but one,
     the clock passes the idle TTL, and the drainer cordons, then removes,
     the idle provisioned nodes. Checks: the replay, every demand
     fulfilled and gone, the drained nodes exactly the provisioned nodes
     no reservation names (no static node), no over-commit. Prints the
     nodes added and drained, denial-to-admission latency (client host
     clock), the pipeline drains and the solo builds that debited
     in-flight windows.
 14. Device-fault tolerance on the card: phase 3's cluster labelled into 4
     instance groups of 2,500 nodes; requests cycle the groups (each
     pinned to its group's nodes), so every window partitions. (a) A pool
     of two slots on cuda:0 (`pool_devices=[cuda:0] * 2`, each slot on
     its own stream): 16 windows of 32 requests in pipelined pairs against
     a pool-less `cuda` solver and a `cpu` solver; every decision equal,
     every window partitioned, row-walk launches = the live segments of
     all parts; prints the per-slot statics uploads, the slots a dispatch
     keeps busy and the window p50 pooled against pool-less (host clock
     ending in a synchronise, pair 0 untimed). (b) The same windows on a
     fresh pool; `FaultInjector` kills slot 1's third part solve
     (`device.dispatch.slot1`): one quarantine, the part re-dispatched on
     slot 0, decisions equal to (a)'s cpu solver's; after the probe
     interval on an injected clock the probe kernel reinstates slot 1,
     which serves again; prints the host time from the quarantine to the
     reinstatement. (c) Both slots
     killed for windows 3-4: the host greedy serves them (`greedy`
     degraded mode), 64 fallback decisions equal to the cpu solver's, one
     engagement cleared when the probe reinstates the slots; prints the
     greedy ms a window beside the card's. (d) A pool-less `cuda` solver:
     one injected h2d fault serves one window on the greedy, the next
     window on the card clears degraded mode. (e) Phase 7's app on
     `solver.device-pool: 2` (two slots of cuda:0), 4 clients: 32 drivers
     on the pool, 32 with every slot killed, 8 after a forced probe; under
     `server.degraded-mode: shed` every killed-pool driver answers 503
     with Retry-After 7 and readiness 503, and /debug/state carries the
     `faults` block; under `greedy` readiness stays 200 but degraded and
     every body equals a cpu replay. Phases 3-13 and 15 fail if degraded
     mode ever engaged, a slot was quarantined, a fallback decision was
     made or a part was re-dispatched there.
 15. Decision traces, replay and the fleet on the card, 10,000 nodes a
     cluster. (a) Capture: phase 7's cluster behind
     `build_scheduler_app(..., device="cuda")` with `trace.path` and the
     flight recorder (threaded transport, 16 clients): 64 drivers (gangs
     of 2-8, ~15% 32 wide), a pod DELETE and a node PUT from another
     connection while windows are in flight, then every admitted app's
     executors; /debug/trace must report 0 write errors, no over-commit.
     (b) `replay_trace(strict=True)` of that trace on a `cuda` lane and on
     a `cpu` lane: 0 mismatches, every decision compared, no uncompared
     window, the same placements on both; the `cuda` replay's row-walk
     launches equal the capture's. (c) `what_if` under `binpack:
     distribute-evenly`: a clean base, a non-empty diff. (d) `run_sweep`
     over tightly-pack, distribute-evenly, minimal-fragmentation and
     single-az-tightly-pack on the card: each arm equal to its own
     sequential replay; no window defers on the card (stacked dispatches
     0: the row walk serves every arm's windows). (e)
     `arm_stacked_fifo_pack` (4 arms over one 10,000-node cluster) and
     `bucket_stacked_fifo_pack` (3 different 10,000-node clusters, one
     bucket) on the card: every member's blob and `available_after` equal
     its own row walk (`window_pack`) and the same call on the cpu; both
     times (CUDA events) beside the row walks'. (f) `fleet.enabled` with 3
     clusters of 10,000 nodes (`max-spillover-hops: 1`, `stack-window-ms:
     5`, record_ops) behind the HTTP server: cluster-tagged drivers (some
     forwarded), a spill group homed on cluster 0's 8 small nodes whose
     drivers spill to cluster 1, cluster 2 killed mid-run (its placed
     apps' executors deny, its pending app is re-routed) and rejoined;
     GET /debug/fleet and the `fleet.*` series read; no window defers on
     the card; `verify_cluster_equivalence` on the card and on the cpu.
     Every main-path phase here checks row-walk launches = live segments
     + solo packs, and one probe a `cuda` solver.
 16. The native arena's resident host build at full width (every solver
     of phases 3-15 builds on it too). (a) Phase 3's 10,000 nodes behind
     three extenders, each with the feature store's availability journal
     (the usage tracker the app attaches): a `cuda` solver on the arena
     with `solver.build-oracle`, a `cuda` solver on the dense Python build
     (`use_native=False`) and a `cpu` solver on the arena. 16 pipelined
     windows of 16 drivers with churn between and under windows in flight:
     base-pod deletes (overhead rows), 4 node adds, a label and a zone
     update, and, after a drain, 2 idle nodes deleted with their pods,
     whose registry rows the later adds take. Every result, reservation
     and demand equal across the three; oracle checks > 0 and none missed
     a row; no dense mirror sync after the first build; tombstones
     recycled; the resident solver's row walks = its live segments.
     Prints each side's `solver.build.ms` p50/p99, incremental builds
     against full snapshots and window p50. (b) Phase 12 (c)'s 100,000
     nodes at the solver level, 8 pipelined windows of 32, the resident
     `cuda` solver (fed the journal of its commits) against the dense
     `cuda` solver: equal decisions, the same figures. Phases 7 and 12 (c)
     print /debug/state's `build` block (12 (c): the pruned solver's
     build stats) and phase 7 the batcher's busy share.
 17. The soak engines (spark_scheduler_tpu_torch/testing/soak.py) on the
     card; each `cuda` leg runs with the launch counts set to 0 just
     before it and read just after: row walks = live segments + solo
     packs, one probe a `cuda` solver. (a) `Soak`'s dense op mix (seeds
     42, 43, 44 with tightly-pack, az-aware-tightly-pack and
     single-az-tightly-pack; 12 nodes, 200 steps) on the card and again
     on the cpu: equal op counts, admitted map, reservation specs and
     final availability; then one single-az-tightly-pack leg at 10,000
     nodes, 200 steps, every request naming every node, on the card only:
     the engine's invariants with a drained-mirror check before the last,
     only the row walk serving (no greedy, no deferred window); prints
     steps, windows served, step p50/p99 and wall seconds. (b) The
     elastic soak (seeds 47 and 48, 10 nodes, 300 steps): demands
     fulfilled, nodes added and drained, drain safety held; prints the
     demand-to-fulfilled p50/p99 on the soak clock. (c) `ChaosMatrixSoak`
     on all five surfaces (seed 9, 12 nodes, 120 steps), card then cpu:
     equal verdicts field for field; the device leg's one greedy window,
     the row walk after it, no slot quarantined. (d) `HAChaosSoak`'s
     three scenarios of tests/test_ha_chaos_soak.py with the replicas on
     the card. (e) `FleetSoak`'s two scenarios of
     tests/test_fleet_soak.py, three clusters on the card, every cluster
     identical to its standalone replay.
 18. Parallel across cards (spark_scheduler_tpu_torch/parallel/), shards
     on cuda:0 with a stream each. (a) The node-sharded engine at S = 1,
     2 and 4 against the kernels on the same CUDA inputs and against 4
     cpu shards, no tolerance: a config-5 queue (10,000 nodes padded to
     16,384) against fifo_pack, phase-3 rows as one-row skippable
     segments (masked mode) and the first segments of a phase-3 window
     (window mode) against window_pack; then the six strategies at 300
     nodes, roomy and tight, queue and window mode, on 4 shards; prints
     ms a call (CUDA events) beside the kernel's and the bytes that cross
     shards. (b) Config 4's five groups on a (5, 1) groups mesh: exactly
     five queue-kernel launches, equal to the single launch and the plain
     version. (c) Phase 3's 10,000 nodes behind
     `PlacementSolver(mesh=(1, 4))`: 4 pipelined windows of 8 drivers,
     churn between the pairs, equal to a pool-less and a cpu solver. (d)
     Phase 12 (c)'s 100,000 nodes, a tight top-k, the scale tier on the
     shards of a `mesh=(1, 4)` slot: escalations, sharded re-solves, no
     fallback, equal to the tier off and a cpu run. (e) A `solver: {mesh: {groups: 1,
     node-shards: 4}, scale-tier: true}` app from YAML, 32 drivers from 4
     clients, every body equal to a cpu replay. (f) (c)'s slot with (d)'s
     tight top-k, the tier on and the greedy degraded policy, a
     classified CudaDeviceFault(214) raised in every tier re-solve on the
     tier's thread only: fallbacks, no resolve, no slot quarantined,
     decisions equal to a cpu mesh run with the same injection and to the
     tier-off row walk; after close() every future done and every slot's
     in-flight count 0. (g) A child python3 dispatches a pooled mesh
     window on the card, abandons it while its part solve runs and exits:
     rc 0, no "terminate called". Its main-path launches (the
     group-sharded route's five, the row walks and probes of (c)-(f))
     count; the comparisons do not.

Prints the card, a {"kernels": [...]} line and, last, the result line.
Needs one card; exits non-zero without CUDA or without the package beside it.

    python3 chip_smoke.py --mesh-cards

lays phase 18's shards and groups on distinct cards (shard k on card k
modulo the cards) when there are two or more.

    python3 chip_smoke.py --trace-race ROUNDS [--nodes N] [--device cpu]

checks the trace capture's event order instead (ROADMAP §C.9): ROUNDS
pairs of phase 15 (a) captures, with the trace's order lock on the
backend and without it (an event can then land between a window's state
reads and its journal entry), in turns A B B A, each replayed on the same
device and compared. Prints one JSON line a capture (mismatches, the
capture's driver p50/p99), then a summary line a side. No result line;
exits 0 when every capture with the lock replayed with no mismatch.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

N_MAIN = 10_000
WINDOWS = 4
REQUESTS = 32
STRATEGIES = (
    "tightly-pack",
    "distribute-evenly",
    "minimal-fragmentation",
    "single-az-tightly-pack",
    "single-az-minimal-fragmentation",
    "az-aware-tightly-pack",
)
# Published H100 SXM peaks (NVIDIA data sheet): HBM rate, and the float32
# rate outside the tensor cores, which stands in for scalar int32 work.
PEAK_BYTES_S = 3.35e12
PEAK_SCALAR_OPS_S = 67e12
# int32 operations per node per live row that any implementation of the
# row walk must do: the capacity identity (5 per dim + 3) and the driver
# feasibility test (6).
OPS_PER_NODE_ROW = 24


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def fault_free(solver, phase):
    """On a healthy card no device-fault machinery may engage: no degraded
    engagement, no host-greedy (fallback) decision and no shed, no slot
    quarantined, no part re-dispatched (phases 3-13)."""
    d = getattr(solver, "degraded", None)
    seen = {
        "engagements": d.engagements if d is not None else 0,
        "fallback_decisions": d.fallback_decisions if d is not None else 0,
        "shed_requests": d.shed_requests if d is not None else 0,
        "quarantined": len(solver.device_health()["quarantined"]),
        "redispatches": solver.redispatch_count,
        "greedy_windows": solver.window_path_counts.get("greedy-fallback", 0),
    }
    check(not any(seen.values()),
          f"phase {phase}: device-fault machinery engaged on a healthy card: "
          f"{seen}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else (
        "nvidia-smi failed: " + out.stderr.strip()
    )


# ---------------------------------------------------------------- phase 2


def small_cluster(rng, n, hi, device):
    """Random cluster fields (the generator of the JAX package's window
    parity tests; a small `hi` makes gangs fail and block), as the port's
    ClusterTensors on `device`."""
    from spark_scheduler_tpu_torch.models.cluster import cluster_from_numpy
    from spark_scheduler_tpu_torch.models.resources import INT32_INF

    avail = rng.integers(0, hi, size=(n, 3)).astype(np.int32)
    avail[:, 2] = rng.integers(0, 3, size=n)
    return cluster_from_numpy(
        [
            avail, avail.copy(),
            rng.integers(0, 4, size=n).astype(np.int32),
            rng.permutation(n).astype(np.int32),
            np.full(n, INT32_INF, np.int32), np.full(n, INT32_INF, np.int32),
            rng.random(n) < 0.1, rng.random(n) > 0.05, np.ones(n, bool),
        ],
        device=device,
    )


def small_window(rng, n, n_requests, max_rows, emax):
    from spark_scheduler_tpu_torch.ops.window import make_segmented_window

    requests, cands, doms = [], [], []
    for _ in range(n_requests):
        rows = []
        for _ in range(rng.integers(1, max_rows + 1)):
            dr = rng.integers(0, 5, size=3).astype(np.int32)
            er = rng.integers(1, 4, size=3).astype(np.int32)
            dr[2] = 0
            er[2] = rng.integers(0, 2)
            rows.append((dr, er, int(rng.integers(0, emax + 1)),
                         bool(rng.random() < 0.3)))
        requests.append(rows)
        cands.append(rng.random(n) < (0.95 if rng.random() < 0.7 else 0.4))
        doms.append(rng.random(n) < (1.0 if rng.random() < 0.6 else 0.6))
    return make_segmented_window(requests, cands, doms, pad_segments=n_requests + 2)


def max_abs_diff(a, b) -> int:
    return max(int((x.long() - y.long()).abs().max()) for x, y in zip(a, b))


def wide_window(device):
    """Gangs of 1,100-2,048 executors (emax 2,048) on 300 roomy nodes: the
    slot writes stride past one block's 1,024 threads."""
    from spark_scheduler_tpu_torch.models.cluster import cluster_from_numpy
    from spark_scheduler_tpu_torch.models.resources import INT32_INF
    from spark_scheduler_tpu_torch.ops.window import make_segmented_window

    rng = np.random.default_rng(8)
    n = 300
    avail = rng.integers(0, 64, size=(n, 3)).astype(np.int32)
    avail[:, 2] = 0
    cluster = cluster_from_numpy(
        [avail, avail.copy(), rng.integers(0, 4, size=n).astype(np.int32),
         rng.permutation(n).astype(np.int32),
         np.full(n, INT32_INF, np.int32), np.full(n, INT32_INF, np.int32),
         np.zeros(n, bool), np.ones(n, bool), np.ones(n, bool)],
        device=device,
    )
    one = np.array([1, 1, 0], np.int32)
    ones = [np.ones(n, bool)] * 2
    win = make_segmented_window(
        [[(one, one, 1500, True), (one, one, 1100, False)],
         [(one, one, 2048, False)]], ones, ones)
    return cluster, win


def compare_small(device) -> int:
    """Phase 2. Returns the largest |kernel - plain| over every output."""
    import torch

    from spark_scheduler_tpu_torch.ops.window import (
        walk_layout,
        window_pack,
        window_pack_reference,
    )

    worst, cases = 0, 0

    def run(label, cluster, win, fill, emax, layout):
        nonlocal worst, cases
        got = window_pack(cluster, win, fill=fill, emax=emax, num_zones=4,
                          layout=layout)
        want = window_pack_reference(cluster, win, fill=fill, emax=emax,
                                     num_zones=4)
        torch.cuda.synchronize()
        err = max_abs_diff(got, want)
        if err:
            for name, g, w in zip(("meta", "execs", "base"), got, want):
                bad = (g != w).nonzero()[:8].tolist()
                print(f"  mismatch {label} {name} at {bad}", flush=True)
        check(err == 0, f"kernel != plain: {label}")
        worst = max(worst, err)
        cases += 1

    # (n, requests, max rows, availability bound, seeds, node-state layout):
    # the default layout (shared memory) at every n, the global layout
    # forced at a small and a large n.
    grid = ((24, 5, 4, 24, 3, None), (300, 8, 8, 24, 3, None),
            (300, 8, 8, 6, 3, None), (8193, 3, 3, 24, 1, None),
            (10_000, 3, 3, 24, 1, None), (300, 8, 8, 6, 1, "global"),
            (10_000, 3, 3, 24, 1, "global"))
    for n, n_req, max_rows, hi, seeds, state in grid:
        layout = walk_layout(n, state=state)
        for fill in STRATEGIES:
            for seed in range(seeds):
                rng = np.random.default_rng(1000 * n + 10 * hi + seed)
                cluster = small_cluster(rng, n, hi, device)
                win = small_window(rng, n, n_req, max_rows, 8)
                run(f"{fill} n={n} hi={hi} seed={seed} {layout.state}",
                    cluster, win, fill, 8, layout)
    cluster, win = wide_window(device)
    for fill in STRATEGIES:
        run(f"{fill} wide gangs", cluster, win, fill, 2048, None)
    print(f"phase 2: {cases} windows (n = 24, 300, 8,193, 10,000; node state "
          f"in shared and in global memory; gangs up to 2,048 wide), kernel "
          f"== plain on every output", flush=True)
    return worst


# --------------------------------------------------------------- phase 2b


def queue_cluster_fields(rng, n, hi=40):
    """Nine cluster fields as numpy arrays (tests/test_packing_golden.py's
    generator: ~10% unschedulable, ~10% not ready, ~5% invalid nodes; a
    small `hi` makes a tight cluster)."""
    from spark_scheduler_tpu_torch.models.resources import INT32_INF

    avail = rng.integers(0, hi, size=(n, 3)).astype(np.int32)
    avail[:, 1] = rng.integers(0, 64 * hi // 40, size=n)
    avail[:, 2] = rng.integers(0, 3, size=n) * rng.integers(0, 2, size=n)
    sched = (avail + rng.integers(0, 8, size=(n, 3))).astype(np.int32)
    return [
        avail, sched, rng.integers(0, 4, size=n).astype(np.int32),
        rng.permutation(n).astype(np.int32),
        np.full(n, INT32_INF, np.int32), np.full(n, INT32_INF, np.int32),
        rng.random(n) < 0.1, rng.random(n) > 0.1, rng.random(n) > 0.05,
    ]


def queue_apps(rng, b, pad_to, emax=8):
    """tests/test_pallas_fifo.py's queue: gangs 0..emax+2 wide (too-big
    included), ~30% skippable."""
    from spark_scheduler_tpu_torch.ops.batched import make_app_batch

    driver = rng.integers(1, 6, size=(b, 3)).astype(np.int32)
    driver[:, 2] = rng.integers(0, 2, size=b)
    execs = rng.integers(1, 8, size=(b, 3)).astype(np.int32)
    execs[:, 2] = rng.integers(0, 2, size=b)
    counts = rng.integers(0, emax + 3, size=b).astype(np.int32)
    return make_app_batch(driver, execs, counts, pad_to=pad_to,
                          skippable=rng.random(b) < 0.3)


def packing_diff(got, want) -> int:
    """Largest |a - b| over the five BatchedPacking outputs; raises if a
    shape differs."""
    worst = 0
    for name, g, w in zip(got._fields, got, want):
        check(tuple(g.shape) == tuple(w.shape),
              f"{name}: shape {tuple(g.shape)} != {tuple(w.shape)}")
        if g.numel():
            worst = max(worst, int((g.long().cpu() - w.long().cpu()).abs().max()))
    return worst


def compare_queue_small(device) -> int:
    """Phase 2b. Returns the largest |kernel - plain| over every output."""
    import torch

    from spark_scheduler_tpu_torch.models.cluster import cluster_from_numpy
    from spark_scheduler_tpu_torch.ops.batched import (
        app_batch_to_device,
        make_app_batch,
    )
    from spark_scheduler_tpu_torch.ops.fifo import (
        fifo_pack,
        fifo_pack_reference,
        queue_layout,
    )
    from spark_scheduler_tpu_torch.parallel import (
        grouped_fifo_pack,
        grouped_fifo_pack_reference,
        stack_groups,
    )

    kw = dict(emax=8, num_zones=4)
    worst, cases = 0, 0

    def run(label, fields, apps, fill):
        nonlocal worst, cases
        cluster = cluster_from_numpy(fields, device=device)
        dev_apps = app_batch_to_device(apps, device)
        before = fifo_pack.launches
        got = fifo_pack(cluster, dev_apps, fill=fill, **kw)
        torch.cuda.synchronize()
        b = int(np.asarray(apps.app_valid).shape[0])
        check(fifo_pack.launches == before + (1 if b else 0),
              f"{label}: {fifo_pack.launches - before} launches")
        want = fifo_pack_reference(cluster, dev_apps, fill=fill, **kw)
        err = packing_diff(got, want)
        if err:
            for name, g, w in zip(got._fields, got, want):
                bad = (g != w).nonzero()[:8].tolist()
                print(f"  mismatch {label} {fill} {name} at {bad}", flush=True)
        check(err == 0, f"queue kernel != plain: {label} {fill}")
        check(got.available_after.data_ptr() != cluster.available.data_ptr(),
              f"{label}: available_after aliases the input")
        worst = max(worst, err)
        cases += 1
        return got

    for fill in STRATEGIES:
        for n, hi in ((24, 40), (300, 40), (300, 8)):
            for seed in range(3):
                rng = np.random.default_rng(100 * n + hi + seed)
                run(f"n={n} hi={hi} seed={seed}", queue_cluster_fields(rng, n, hi),
                    queue_apps(rng, 9, pad_to=12), fill)
        rng = np.random.default_rng(11)
        fields = queue_cluster_fields(rng, 24)
        fields[0][3] = -5
        fields[0][7, 0] = -1
        ones = np.ones((3, 3), np.int32)
        run("negative availability, zero-count", fields,
            make_app_batch(ones, ones, [0, 3, 0], pad_to=4), fill)
        execs = np.ones((4, 3), np.int32)
        execs[1] = 1000
        out = run("blocking", queue_cluster_fields(rng, 24),
                  make_app_batch(np.ones((5, 3)), np.vstack([execs, ones[:1]]),
                                 [2, 8, 2, 11, 2], skippable=np.zeros(5, bool)),
                  fill)
        check(not bool(out.packed[1]) and not out.admitted[2:].any(),
              f"blocking: {fill} admitted behind a blocked gang")
        out = run("empty queue", queue_cluster_fields(rng, 24),
                  make_app_batch(np.zeros((0, 3)), np.zeros((0, 3)), []), fill)
        check(out.driver_node.shape == (0,), "empty queue shape")
        # Three instance groups in one launch.
        clusters, batches = [], []
        for _ in range(3):
            clusters.append(cluster_from_numpy(queue_cluster_fields(rng, 300),
                                               device=device))
            batches.append(app_batch_to_device(queue_apps(rng, 9, 12), device))
        sc, sa = stack_groups(clusters, batches)
        before = fifo_pack.launches
        got = grouped_fifo_pack(sc, sa, fill=fill, **kw)
        torch.cuda.synchronize()
        check(fifo_pack.launches == before + 1, "grouped: not one launch")
        err = packing_diff(got, grouped_fifo_pack_reference(sc, sa, fill=fill, **kw))
        check(err == 0, f"grouped queue kernel != plain: {fill}")
        cases += 1
    # Every layout forced, where it fits, at node counts on both sides of
    # the crossover and of the block's shared-memory limit (n = 9 leaves
    # cluster blocks 5-7 without nodes), and gangs 1,100-2,048 wide.
    forced = 0
    for team, state in QUEUE_LAYOUTS:
        for n in (9, 300, 1_000, 4_000, 8_193, 10_000):
            layout = fitting_layout(n, team, state)
            if layout is None:
                continue
            for fill in STRATEGIES:
                rng = np.random.default_rng(7 * n + 1)
                cluster = cluster_from_numpy(queue_cluster_fields(rng, n), device=device)
                apps = app_batch_to_device(queue_apps(rng, 9, pad_to=12), device)
                got = forced_queue(cluster, apps, layout, fill=fill, **kw)
                want = fifo_pack_reference(cluster, apps, fill=fill, **kw)
                err = packing_diff(got, want)
                check(err == 0, f"queue kernel != plain: {fill} n={n} {layout}")
                forced += 1
        cluster, apps = wide_queue(device)
        for fill in STRATEGIES:
            layout = queue_layout(300, team=team, state=state)
            got = forced_queue(cluster, apps, layout, fill=fill, emax=2048,
                               num_zones=4)
            want = fifo_pack_reference(cluster, apps, fill=fill, emax=2048,
                                       num_zones=4)
            check(bool(want.admitted[0]), "wide queue: the first gang not admitted")
            check(packing_diff(got, want) == 0,
                  f"queue kernel != plain: {fill} wide gangs {layout}")
            forced += 1
    print(f"phase 2b: {cases} queues through fifo_pack / grouped_fifo_pack and "
          f"{forced} with the layout forced (block and cluster teams, node "
          f"state in shared and in global memory, n = 9 to 10,000, gangs up to "
          f"2,048 wide): queue kernel == plain on every output", flush=True)
    return worst


# The queue kernel's four layouts: (team, node-state place).
QUEUE_LAYOUTS = (("block", "smem"), ("block", "global"),
                 ("cluster", "smem"), ("cluster", "global"))


def fitting_layout(n, team, state):
    """queue_layout(n, team=..., state=...), or None where the node state
    does not fit in shared memory."""
    from spark_scheduler_tpu_torch.ops.fifo import queue_layout

    try:
        return queue_layout(n, team=team, state=state)
    except ValueError:
        return None


def queue_args(cluster, apps, num_zones):
    """fifo_queue's operands for one queue or, for a stacked cluster, for
    G queues."""
    from spark_scheduler_tpu_torch.ops.fifo import device_apps, queue_operands
    from spark_scheduler_tpu_torch.parallel import grouped_queue_operands

    dev = cluster.available.device
    if cluster.available.dim() == 3:
        g = cluster.available.shape[0]
        return grouped_queue_operands(
            cluster, device_apps(apps, dev, lead=(g,)), num_zones)
    return queue_operands(cluster, device_apps(apps, dev), num_zones)


def forced_queue(cluster, apps, layout, **kw):
    """fifo_pack's launch with the kernel layout forced."""
    import torch

    from spark_scheduler_tpu_torch.ops.batched import BatchedPacking
    from spark_scheduler_tpu_torch.ops.fifo import fifo_queue, queue_packing

    out = queue_packing(*fifo_queue(*queue_args(cluster, apps, kw["num_zones"]),
                                    layout=layout, **kw))
    torch.cuda.synchronize()
    return BatchedPacking(*(x[0] for x in out))


def wide_queue(device):
    """Three queue-mode gangs of 1,100-2,048 executors (emax 2,048) on 300
    roomy nodes."""
    from spark_scheduler_tpu_torch.ops.batched import (
        app_batch_to_device,
        make_app_batch,
    )

    cluster, _ = wide_window(device)
    one = np.ones((3, 3), np.int32)
    one[:, 2] = 0
    apps = make_app_batch(one, one, [1500, 1100, 2048],
                          skippable=np.array([True, False, False]))
    return cluster, app_batch_to_device(apps, device)


# ---------------------------------------------------------------- phase 3


def main_cluster(seed, n=N_MAIN):
    """n (10,000) nodes over 4 zones: 8-64 CPU, 32-256 Gi, ~10% with 1-8
    GPUs, and a dense prior usage of 30-70% per dimension (registry-row
    order)."""
    from spark_scheduler_tpu_torch.models.kube import Node, ZONE_LABEL
    from spark_scheduler_tpu_torch.models.resources import Resources

    rng = np.random.default_rng(seed)
    cpu = rng.choice([8, 16, 32, 48, 64], n)
    mem = rng.choice([32, 64, 128, 192, 256], n)
    gpu = np.where(rng.random(n) < 0.1, rng.integers(1, 9, n), 0)
    nodes = [
        Node(
            name=f"node-{i:05d}" if n <= N_MAIN else f"node-{i:06d}",
            allocatable=Resources(
                int(cpu[i]) * 1000, int(mem[i]) << 20, int(gpu[i]) * 1000
            ),
            labels={ZONE_LABEL: f"zone-{i % 4}"},
        )
        for i in range(n)
    ]
    frac = rng.uniform(0.3, 0.7, size=(n, 3))
    usage = np.stack(
        [
            (cpu * 1000 * frac[:, 0]).astype(np.int64),
            ((mem << 20) * frac[:, 1]).astype(np.int64),
            np.floor(gpu * frac[:, 2]).astype(np.int64) * 1000,
        ],
        axis=1,
    )
    return nodes, usage


def main_window(rng, names, zone_names):
    """32 requests; each carries 0-63 FIFO-earlier pending drivers (a
    shared queue prefix) plus its own application."""
    from spark_scheduler_tpu_torch.core.solver import WindowRequest
    from spark_scheduler_tpu_torch.models.resources import Resources

    def app(skippable):
        gpu = 1000 if rng.random() < 0.05 else 0
        count = int(rng.integers(2, 33)) if rng.random() < 0.15 else 8
        return (
            Resources(1000 * int(rng.integers(1, 3)),
                      int(rng.integers(2, 5)) << 20, 0),
            Resources(1000 * int(rng.integers(1, 5)),
                      int(rng.integers(4, 17)) << 20, gpu),
            count,
            skippable,
        )

    queue = [app(bool(rng.random() < 0.3)) for _ in range(63)]
    requests = []
    for _ in range(REQUESTS):
        k = int(rng.integers(0, 64))
        cands = names
        if rng.random() < 0.2:
            cands = zone_names[int(rng.integers(0, 4))]
        dom = None
        if rng.random() < 0.1:
            z = int(rng.integers(0, 4))
            dom = zone_names[z] + zone_names[(z + 1) % 4]
        requests.append(
            WindowRequest(
                rows=queue[:k] + [app(False)],
                driver_candidate_names=cands,
                domain_node_names=dom,
            )
        )
    return requests


def commit(usage, registry, requests, decisions):
    """Reserve every admitted gang: its driver and executors' requests
    join the usage (what the extender does on admission)."""
    for req, dec in zip(requests, decisions):
        if not dec.admitted:
            continue
        drv, exe = req.rows[-1][0].as_array(), req.rows[-1][1].as_array()
        usage[registry.index_of(dec.packing.driver_node)] += drv
        for name in dec.packing.executor_nodes:
            usage[registry.index_of(name)] += exe


def run_main_path(device):
    """Phase 3. Returns the launch counts, per-window stats and the last
    tightly-pack window's inputs for phase 4."""
    import torch

    from spark_scheduler_tpu_torch.core.solver import PlacementSolver
    from spark_scheduler_tpu_torch.ops.probe import probe_add_one
    from spark_scheduler_tpu_torch.ops.window import window_pack

    nodes, usage = main_cluster(seed=7)
    names = [nd.name for nd in nodes]
    zone_names = [names[z::4] for z in range(4)]
    rng = np.random.default_rng(11)
    schedule = ["tightly-pack"] * WINDOWS + list(STRATEGIES[1:])
    windows = [main_window(rng, names, zone_names) for _ in schedule]

    window_pack.launches = 0
    probe_add_one.launches = 0
    gpu = PlacementSolver(device=device)
    cpu = PlacementSolver(device="cpu")
    stats, last = [], None
    for strategy, requests in zip(schedule, windows):
        t_gpu = gpu.build_tensors(nodes, usage, {})
        t_cpu = cpu.build_tensors(nodes, usage, {})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = gpu.pack_window(strategy, t_gpu, requests)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        want = cpu.pack_window(strategy, t_cpu, requests)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        batch = gpu.window_batch(t_gpu, requests)
        batch_ms = (time.perf_counter() - t0) * 1e3
        rows = int(batch.win.row_count.sum())
        segs = int((batch.win.row_count > 0).sum())
        bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
        check(not bad, f"{strategy}: card decisions differ from the CPU "
                       f"solver's at requests {bad[:8]}")
        admitted = sum(d.admitted for d in got)
        stats.append(dict(strategy=strategy, ms=ms, cpu_ms=cpu_ms, rows=rows,
                          segments=segs, emax=batch.emax, admitted=admitted,
                          batch_ms=batch_ms))
        print(f"  window {len(stats)}: {strategy} segments={segs} rows={rows} "
              f"emax={batch.emax} admitted={admitted}/{len(requests)} "
              f"card {ms:.2f} ms (host window layout {batch_ms:.2f} ms), "
              f"cpu plain {cpu_ms:.1f} ms", flush=True)
        if strategy == "tightly-pack":
            last = (t_gpu, batch)
        commit(usage, gpu.registry, requests, got)
    launches = {"window": window_pack.launches, "probe": probe_add_one.launches}
    fault_free(gpu, 3)
    check(launches["window"] > 0, "the window kernel never launched")
    check(launches["probe"] > 0, "the probe kernel never launched")
    path = "cuda" if gpu.device.type == "cuda" else "reference"
    check(gpu.window_path_counts == {path: len(schedule)},
          f"window path counts {gpu.window_path_counts}")
    check(cpu.window_path_counts == {"reference": len(schedule)},
          f"cpu path counts {cpu.window_path_counts}")
    return launches, stats, last


# ---------------------------------------------------------------- phase 4


def cuda_time_ms(fn, repeats):
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(repeats):
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def window_bound(cluster, batch, fill):
    """Least time for one window_pack call: bytes (inputs read once,
    outputs written once) over the HBM rate, and the int32 work this
    window's live rows need over the scalar peak; the larger wins."""
    win = batch.win
    n = cluster.num_nodes
    s, r = win.exec_count.shape
    live_rows = int(win.row_count.sum())
    live_segs = int((win.row_count > 0).sum())
    in_bytes = sum(t.numel() * t.element_size() for t in cluster.fields())
    in_bytes += sum(np.asarray(a).nbytes for a in win)
    out_bytes = s * r * 4 * 4 + s * r * batch.emax * 4 + n * 3 * 4
    zone_passes = batch.num_zones if fill.startswith(("single-az", "az-aware")) else 1
    ops = live_rows * n * OPS_PER_NODE_ROW * zone_passes
    # Two priority orders of six stable sorts each, per live segment.
    ops += live_segs * 2 * 6 * n * int(np.ceil(np.log2(n)))
    t_bytes = (in_bytes + out_bytes) / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_SCALAR_OPS_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def device_split(fn, name="window_row_walk"):
    """Device time of one call, split into the named kernel and the rest
    (sorts, masks, copies): kernel events of torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernel = other = 0.0
    for evt in prof.events():
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            us = evt.time_range.elapsed_us()
            if name in evt.name:
                kernel += us
            else:
                other += us
    return kernel / 1e3, other / 1e3


def device_us_per_call(fn, calls, name=""):
    """Profiled device time of one call of `fn` in microseconds, over
    `calls` calls: the kernels whose name holds `name` (every device event
    for ""). "not measured" when the profiler recorded none."""
    kern, _ = device_split(lambda: [fn() for _ in range(calls)], name)
    return f"{kern * 1e3 / calls:.3f} us" if kern else "not measured"


def measure(last, device, card, worst_small):
    import torch

    from spark_scheduler_tpu_torch.ops.probe import (
        probe_add_one,
        probe_reference,
    )
    from spark_scheduler_tpu_torch.ops.window import (
        WALK_STATIC_SMEM,
        walk_layout,
        window_kernel_info,
        window_pack,
        window_pack_reference,
    )

    cluster, batch = last
    args = dict(fill="tightly-pack", emax=batch.emax, num_zones=batch.num_zones)
    n = cluster.num_nodes
    main = walk_layout(n)
    info = window_kernel_info(main)
    check(main.state == "smem", f"the main path's node state is not in "
                                f"shared memory at n={n}: {main}")
    check(info["static_smem"] == WALK_STATIC_SMEM,
          f"static shared memory {info['static_smem']} B != {WALK_STATIC_SMEM}")
    check(info["max_active_clusters"] >= 1, f"cluster cannot run: {info}")
    got = window_pack(cluster, batch.win, **args)
    t0 = time.perf_counter()
    want = window_pack_reference(cluster, batch.win, **args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max(worst_small, max_abs_diff(got, want))
    check(err == 0, "kernel != plain at the main-path window")
    bound, bound_by = window_bound(cluster, batch, "tightly-pack")
    rows = int(batch.win.row_count.sum())

    # The two layouts in turns (A B A B): node state in shared memory (the
    # main path's) and in global memory. Both must give the same outputs.
    layouts = {"smem": main, "global": walk_layout(n, state="global")}
    print(f"window kernel at n={n}: {main}; ptxas/runtime {info}", flush=True)
    timed = {}
    for turn in range(2):
        for label, lay in layouts.items():
            def call(lay=lay):
                return window_pack(cluster, batch.win, **args, layout=lay)
            check(max_abs_diff(call(), got) == 0, f"{label} layout != main")
            ms = cuda_time_ms(call, 5)
            kern, other = device_split(call)
            timed.setdefault(label, []).append((ms, kern, other))
            idle = max(0.0, 1 - (kern + other) / ms) if kern else None
            print(f"window kernel, {label} state, turn {turn + 1} ({card}): "
                  f"{ms:.3f} ms per window_pack call (CUDA events, median "
                  f"of 5) for {rows} rows; profiled device time: row-walk "
                  f"kernel {kern:.3f} ms ({kern * 1e3 / rows:.2f} us per row), "
                  f"other device work {other:.3f} ms; device idle share "
                  f"{'not measured' if idle is None else f'{idle:.3f}'}",
                  flush=True)
    ms = float(np.median([t[0] for t in timed["smem"]]))
    print(f"window kernel at the main path ({card}): {ms:.3f} ms per "
          f"window_pack call; plain version on the card {plain_ms:.1f} ms; "
          f"bound {bound:.5f} ms ({bound_by})", flush=True)

    x = torch.zeros((8, 128), dtype=torch.int32, device=device)
    p_err = int((probe_add_one(x) - probe_reference(x)).abs().max())
    check(p_err == 0, "probe kernel != plain")
    p_ms = cuda_time_ms(lambda: probe_add_one(x), 100)
    p_plain = cuda_time_ms(lambda: probe_reference(x), 100)
    p_lib = cuda_time_ms(lambda: torch.add(x, 1), 100)
    p_dev = device_us_per_call(lambda: probe_add_one(x), 100, "probe_add_one")
    lib_dev = device_us_per_call(lambda: torch.add(x, 1), 100)
    p_bound = 2 * x.numel() * 4 / PEAK_BYTES_S * 1e3
    # The card's floor for one launch: a library spin kernel of zero
    # cycles, beside the probe's byte bound.
    floor_dev = device_us_per_call(lambda: torch.cuda._sleep(0), 100)
    print(f"probe ({card}): probe_add_one {p_ms:.5f} ms, torch.add "
          f"{p_lib:.5f} ms per call (CUDA events, median of 100); profiled "
          f"device time per call: probe kernel {p_dev}, torch.add {lib_dev}, "
          f"launch floor (torch.cuda._sleep(0)) {floor_dev}; the probe's "
          f"byte bound {p_bound * 1e3:.5f} us", flush=True)
    layout_keys = dict(layout=main.state, cluster=main.k,
                       smem_bytes=main.smem_bytes, regs=info["regs"])
    return {
        "window": dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=bound, bound_by=bound_by, library_ms=None,
                       **layout_keys),
        "probe": dict(max_abs_err=p_err, ms=p_ms, plain_ms=p_plain,
                      bound_ms=p_bound, bound_by="bytes", library_ms=p_lib),
    }


def queue_bound(cluster, apps, emax, num_zones, fill):
    """Least time for one fifo_pack call, reckoned as `window_bound` is:
    bytes (inputs read once, the five outputs written once) over the HBM
    rate, and the int32 work this queue's valid apps need (the same
    OPS_PER_NODE_ROW basis, times the zones for single-AZ) plus the one
    pair of priority sorts, over the scalar peak; the larger wins."""
    n = cluster.num_nodes
    b = int(apps.app_valid.shape[0])
    live = int(apps.app_valid.sum())
    in_bytes = sum(t.numel() * t.element_size() for t in cluster.fields())
    in_bytes += sum(t.numel() * t.element_size() for t in apps if t is not None)
    out_bytes = b * 4 + b * emax * 4 + 2 * b + n * 3 * 4
    zone_passes = num_zones if fill.startswith(("single-az", "az-aware")) else 1
    ops = live * n * OPS_PER_NODE_ROW * zone_passes
    ops += 2 * 6 * n * int(np.ceil(np.log2(n)))
    t_bytes = (in_bytes + out_bytes) / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_SCALAR_OPS_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def measure_queue(device, card, worst_small):
    """Phase 4, queue kernel: at the first config-5 window (10,000 nodes,
    100 apps, tightly-pack) the wrapper's time and that of its sorts alone
    (CUDA events), the kernel's device time (profiler), the plain version's
    time on the card, the bound."""
    import torch

    from spark_scheduler_tpu_torch.models.cluster import cluster_from_numpy
    from spark_scheduler_tpu_torch.ops.batched import app_batch_to_device
    from spark_scheduler_tpu_torch.ops.fifo import (
        fifo_pack,
        fifo_pack_reference,
        kernel_orders,
    )

    rng = np.random.default_rng(CONFIG_SEEDS["config5"])
    cluster = cluster_from_numpy(baseline_cluster(rng, 10_000), device=device)
    apps = app_batch_to_device(baseline_batches(rng, 100, 100, 8)[0], device)
    args = dict(fill="tightly-pack", emax=8, num_zones=4)
    got = fifo_pack(cluster, apps, **args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = fifo_pack_reference(cluster, apps, **args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max(worst_small, packing_diff(got, want))
    check(err == 0, "queue kernel != plain at the config-5 window")
    ms = cuda_time_ms(lambda: fifo_pack(cluster, apps, **args), 20)
    sort_ms = cuda_time_ms(lambda: kernel_orders(cluster, 4), 20)
    bound, bound_by = queue_bound(cluster, apps, 8, 4, "tightly-pack")
    kern, other = device_split(lambda: fifo_pack(cluster, apps, **args),
                               "fifo_queue_kernel")
    idle = max(0.0, 1 - (kern + other) / ms) if kern else None
    print(f"queue kernel at a config-5 window ({card}): {ms:.3f} ms per "
          f"fifo_pack call (CUDA events, median of 20) for 100 apps on "
          f"10,000 nodes, of which the priority sorts and masks alone take "
          f"{sort_ms:.3f} ms; plain version on the card {plain_ms:.1f} ms; bound "
          f"{bound:.5f} ms ({bound_by}); profiled device time: queue kernel "
          f"{kern:.3f} ms ({kern * 10:.1f} us per app), other device work "
          f"{other:.3f} ms; device idle share of the call "
          f"{'not measured' if idle is None else f'{idle:.3f}'}", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=bound_by, library_ms=None)


def device_us(fn, calls):
    """Device time of one call of `fn` in microseconds, by CUDA events
    around `calls` back-to-back calls, and the results of those calls and
    of one call before them. Each call is one kernel launch that runs
    longer than the host takes to enqueue the next, so the card never
    waits for the host between the events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    outs = [fn()]  # the card runs it while the host queues the rest
    start.record()
    outs += [fn() for _ in range(calls)]
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / calls, outs


def time_layouts(label, cluster, apps, layouts, card, *, fill, emax, calls=5):
    """The queue kernel's device time at one shape for each layout of
    `layouts`, in turns A B ... B A; every call's outputs must equal those
    of the first layout. Returns {layout: [us a launch, one per turn]}."""
    from spark_scheduler_tpu_torch.ops.fifo import fifo_queue

    args = queue_args(cluster, apps, 4)
    b = int(args[4][0].shape[1])
    kw = dict(fill=fill, emax=emax, num_zones=4)
    first = fifo_queue(*args, layout=layouts[0], **kw)
    times = {}
    for lay in list(layouts) + list(reversed(layouts)):
        us, outs = device_us(lambda lay=lay: fifo_queue(*args, layout=lay, **kw),
                             calls)
        for out in outs:
            check(max_abs_diff(out, first) == 0,
                  f"{label}: {lay.team}/{lay.state} != {layouts[0].team}/"
                  f"{layouts[0].state}")
        times.setdefault(lay, []).append(us)
        print(f"    {label} {lay.team}/{lay.state}: device time {us:.2f} us a "
              f"launch (CUDA events over {calls} back-to-back launches), "
              f"{us / b:.3f} us an app ({b} apps a queue)", flush=True)
    return times


def turns(t):
    return " / ".join(f"{x:.2f}" for x in t)


def measure_queue_layouts(device, card):
    """Phase 4, queue kernel layouts: device time of every layout that fits
    at the first window of configs 5, 3, 2 and 4 (in turns), the kernel's
    registers per instantiation, and the block/cluster crossover sweep."""
    from spark_scheduler_tpu_torch.models.cluster import cluster_from_numpy
    from spark_scheduler_tpu_torch.ops.batched import app_batch_to_device
    from spark_scheduler_tpu_torch.ops.fifo import (
        QUEUE_BLOCK_STATIC_SMEM,
        QUEUE_CLUSTER_MIN_NODES,
        fifo_kernel_info,
        queue_layout,
    )
    from spark_scheduler_tpu_torch.ops.window import WALK_STATIC_SMEM
    from spark_scheduler_tpu_torch.parallel import stack_groups

    for team, state in QUEUE_LAYOUTS:
        for n in (1_000, 10_000):
            lay = fitting_layout(n, team, state)
            if lay is None:
                continue
            info = fifo_kernel_info(lay)
            static = WALK_STATIC_SMEM if team == "cluster" else QUEUE_BLOCK_STATIC_SMEM
            check(info["static_smem"] == static,
                  f"{lay}: static shared memory {info['static_smem']} B != {static}")
            check(info["max_active_teams"] >= 1, f"{lay} cannot run: {info}")
            print(f"  queue kernel {team}/{state} at n={n}: slice {lay.slice}, "
                  f"{lay.smem_bytes} B shared a block; ptxas/runtime {info}",
                  flush=True)

    def up(fields):
        return cluster_from_numpy(fields, device=device)

    def first_window(seed, n, window, emax, **kw):
        rng = np.random.default_rng(seed)
        cluster = up(baseline_cluster(rng, n))
        apps = baseline_batches(rng, window, window, emax, **kw)[0]
        return cluster, app_batch_to_device(apps, device)

    rng = np.random.default_rng(CONFIG_SEEDS["config4"])
    groups, group_apps = [], []
    for cpu, mem, gpu in CONFIG4_SHAPES:
        groups.append(up(baseline_cluster(rng, 1_000, cpu=cpu, mem=mem, gpu=gpu)))
        group_apps.append(app_batch_to_device(baseline_batches(rng, 40, 40, 8)[0],
                                              device))
    shapes = [
        ("config 5 (10,000 nodes, 100 apps, tightly-pack)", "tightly-pack", 8,
         *first_window(CONFIG_SEEDS["config5"], 10_000, 100, 8)),
        ("config 3 (1,000 nodes, 200 apps, emax 32, tightly-pack)", "tightly-pack",
         32, *first_window(CONFIG_SEEDS["config3"], 1_000, 200, 32, exec_count=2)),
        ("config 2 (500 nodes, 100 apps, distribute-evenly)", "distribute-evenly", 8,
         *first_window(CONFIG_SEEDS["config2"], 500, 100, 8, exec_count=8,
                       skippable=False)),
        ("config 4 (5 groups x 1,000 nodes, 40 apps each, tightly-pack)",
         "tightly-pack", 8, *stack_groups(groups, group_apps)),
    ]
    for label, fill, emax, cluster, apps in shapes:
        n = cluster.available.shape[-2]
        default = queue_layout(n)
        layouts = [default] + [
            lay for lay in (fitting_layout(n, t, st) for t, st in QUEUE_LAYOUTS)
            if lay is not None and lay != default]
        print(f"  queue kernel at {label}, {card}, default layout "
              f"{default.team}/{default.state}:", flush=True)
        t = time_layouts(label.split(" (")[0], cluster, apps, layouts, card,
                         fill=fill, emax=emax)
        med = {lay: float(np.median(v)) for lay, v in t.items()}
        old = queue_layout(n, team="block", state="global")
        fastest = min(med, key=med.get)
        print(f"  queue kernel at {label}: default {default.team}/{default.state} "
              f"{turns(t[default])} us, block/global (the parent's layout) "
              f"{turns(t[old])} us ({med[old] / med[default]:.2f}x the default); "
              f"fastest {fastest.team}/{fastest.state} {turns(t[fastest])} us "
              f"(device time a launch, one per turn)", flush=True)

    # The crossover: block against cluster, both with the state in shared
    # memory (block/global where the block's state does not fit), on one
    # 100-app tightly-pack queue of config 5's kind.
    print(f"  queue kernel crossover sweep ({card}), 100 apps, tightly-pack:",
          flush=True)
    apps = app_batch_to_device(
        baseline_batches(np.random.default_rng(55), 100, 100, 8)[0], device)
    cluster_faster = []
    for n in (500, 1_000, 1_250, 1_500, 1_750, 2_000, 3_000, 4_000, 5_500,
              7_000, 10_000):
        cluster = up(baseline_cluster(np.random.default_rng(n), n))
        block = queue_layout(n, team="block")
        team = queue_layout(n, team="cluster")
        t = time_layouts(f"n={n}", cluster, apps, [block, team], card,
                         fill="tightly-pack", emax=8)
        b_us, c_us = float(np.median(t[block])), float(np.median(t[team]))
        print(f"  crossover n={n}: block/{block.state} {turns(t[block])} us, "
              f"cluster/{team.state} {turns(t[team])} us, cluster/block "
              f"{c_us / b_us:.3f}", flush=True)
        cluster_faster.append((n, c_us < b_us))
    slower = [n for n, faster in cluster_faster if not faster]
    crossover = next((n for n, faster in cluster_faster
                      if faster and all(m < n for m in slower)), None)
    print(f"  crossover: the cluster team is faster from n = {crossover} of the "
          f"sweep on (block faster at {slower}); QUEUE_CLUSTER_MIN_NODES = "
          f"{QUEUE_CLUSTER_MIN_NODES}", flush=True)


# ---------------------------------------------------------------- phase 5

# bench.py:330-336, (cpu, mem, gpu) ranges of config 4's five groups.
CONFIG4_SHAPES = (
    ((4, 16), (8, 32), (0, 1)),
    ((8, 32), (32, 128), (0, 1)),
    ((16, 96), (64, 512), (0, 2)),
    ((8, 64), (16, 128), (1, 5)),
    ((32, 128), (128, 1024), (0, 1)),
)

# One numpy seed per BASELINE config (bench.py draws them from one stream).
CONFIG_SEEDS = {"config1": 1, "config2": 2, "config2b": 22, "config3": 3,
                "config4": 4, "config5": 5}


def baseline_cluster(rng, n_nodes, num_zones=4, *, cpu=(8, 96), mem=(16, 256),
                     gpu=(0, 2)):
    """bench.py `_make_cluster` (:65-86): nine cluster fields as numpy."""
    from spark_scheduler_tpu_torch.models.resources import INT32_INF

    avail = np.empty((n_nodes, 3), np.int32)
    avail[:, 0] = rng.integers(*cpu, size=n_nodes)
    avail[:, 1] = rng.integers(*mem, size=n_nodes)
    avail[:, 2] = rng.integers(*gpu, size=n_nodes)
    return [
        avail, avail.copy(),
        rng.integers(0, num_zones, size=n_nodes).astype(np.int32),
        rng.permutation(n_nodes).astype(np.int32),
        np.full(n_nodes, INT32_INF, np.int32),
        np.full(n_nodes, INT32_INF, np.int32),
        np.zeros(n_nodes, bool), np.ones(n_nodes, bool), np.ones(n_nodes, bool),
    ]


def baseline_batches(rng, n_apps, window, emax, *, exec_count=None,
                     skippable=True):
    """bench.py `_make_batches` (:89-112): host AppBatches of `window`
    apps each."""
    from spark_scheduler_tpu_torch.ops.batched import make_app_batch

    driver = rng.integers(1, 4, size=(n_apps, 3)).astype(np.int32)
    driver[:, 2] = 0
    execs = rng.integers(1, 6, size=(n_apps, 3)).astype(np.int32)
    execs[:, 2] = 0
    if exec_count is None:
        counts = rng.integers(1, emax + 1, size=n_apps).astype(np.int32)
    else:
        counts = np.full(n_apps, exec_count, np.int32)
    return [
        make_app_batch(
            driver[lo:lo + window], execs[lo:lo + window],
            counts[lo:lo + window],
            skippable=np.full(min(window, n_apps - lo), skippable, bool),
        )
        for lo in range(0, n_apps, window)
    ]


def queue_chain(device, solve, clusters, batches, fills, **kw):
    """Thread the availability through the windows on the card and, with
    the same solve on CPU tensors, through the plain path; every window's
    five outputs must be equal. `solve` is fifo_pack or grouped_fifo_pack;
    `clusters` a ClusterTensors on the card (stacked for grouped);
    `batches` card AppBatches. Returns (per-window card ms from CUDA events,
    admitted per window, CPU plain seconds)."""
    import dataclasses

    import torch

    from spark_scheduler_tpu_torch.models.cluster import ClusterTensors
    from spark_scheduler_tpu_torch.ops.batched import AppBatch

    def to_cpu(x):
        return type(x)(*(None if t is None else t.cpu() for t in (
            x.fields() if isinstance(x, ClusterTensors) else x)))

    gpu_c, cpu_c = clusters, to_cpu(clusters)
    cpu_batches = [to_cpu(AppBatch(*b)) for b in batches]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    ms, admitted, cpu_s = [], [], 0.0
    for i, (apps, fill) in enumerate(zip(batches, fills)):
        torch.cuda.synchronize()
        start.record()
        got = solve(gpu_c, apps, fill=fill, **kw)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        t0 = time.perf_counter()
        want = solve(cpu_c, cpu_batches[i], fill=fill, **kw)
        cpu_s += time.perf_counter() - t0
        err = packing_diff(got, want)
        check(err == 0, f"window {i} ({fill}): card != CPU plain path")
        admitted.append(int(got.admitted.sum()))
        gpu_c = dataclasses.replace(gpu_c, available=got.available_after)
        cpu_c = dataclasses.replace(cpu_c, available=want.available_after)
    return ms, admitted, cpu_s


def run_queue_path(device):
    """Phase 5: BASELINE configs 1, 2, 2b, 3, 4, 5 through the queue path at
    full size. Returns the queue-kernel launches of this phase."""
    from spark_scheduler_tpu_torch.models.cluster import cluster_from_numpy
    from spark_scheduler_tpu_torch.ops.batched import app_batch_to_device
    from spark_scheduler_tpu_torch.ops.fifo import fifo_pack
    from spark_scheduler_tpu_torch.ops.probe import probe_add_one
    from spark_scheduler_tpu_torch.ops.window import window_pack
    from spark_scheduler_tpu_torch.parallel import grouped_fifo_pack, stack_groups

    def up(fields):
        return cluster_from_numpy(fields, device=device)

    def ups(batches):
        return [app_batch_to_device(b, device) for b in batches]

    configs = []
    rng = np.random.default_rng(CONFIG_SEEDS["config5"])
    c5 = up(baseline_cluster(rng, 10_000))
    b5 = ups(baseline_batches(rng, 1_500, 100, 8))
    configs.append(("config5", "10,000 nodes, 1,000 apps in windows of 100, "
                    "then one window per other strategy", fifo_pack, c5, b5,
                    ["tightly-pack"] * 10 + list(STRATEGIES[1:]), 8, 10))
    rng = np.random.default_rng(CONFIG_SEEDS["config2"])
    c2 = up(baseline_cluster(rng, 500))
    b2 = ups(baseline_batches(rng, 1_200, 100, 8, exec_count=8, skippable=False))
    configs.append(("config2", "500 nodes, 12 windows of 100, strict FIFO",
                    fifo_pack, c2, b2, ["distribute-evenly"] * 12, 8, 12))
    rng = np.random.default_rng(CONFIG_SEEDS["config2b"])
    c2b = up(baseline_cluster(rng, 500))
    b2b = ups(baseline_batches(rng, 1_200, 100, 8, exec_count=8, skippable=False))
    configs.append(("config2b", "500 nodes, 12 windows of 100, strict FIFO",
                    fifo_pack, c2b, b2b, ["az-aware-tightly-pack"] * 12, 8, 12))
    rng = np.random.default_rng(CONFIG_SEEDS["config3"])
    c3 = up(baseline_cluster(rng, 1_000))
    b3 = ups(baseline_batches(rng, 2_400, 200, 32, exec_count=2))
    configs.append(("config3", "1,000 nodes, 12 windows of 200, emax 32",
                    fifo_pack, c3, b3, ["tightly-pack"] * 12, 32, 12))
    rng = np.random.default_rng(CONFIG_SEEDS["config4"])
    groups, group_apps = [], []
    for cpu, mem, gpu in CONFIG4_SHAPES:
        groups.append(up(baseline_cluster(rng, 1_000, cpu=cpu, mem=mem, gpu=gpu)))
        group_apps.append(ups(baseline_batches(rng, 40, 40, 8))[0])
    c4, a4 = stack_groups(groups, group_apps)
    configs.append(("config4", "5 groups x 1,000 nodes, 40 apps each, "
                    "grouped_fifo_pack, 3 chained calls", grouped_fifo_pack,
                    c4, [a4] * 3, ["tightly-pack"] * 3, 8, 3))
    rng = np.random.default_rng(CONFIG_SEEDS["config1"])
    c1 = up(baseline_cluster(rng, 10))
    b1 = ups(baseline_batches(rng, 12, 1, 8, exec_count=8))
    configs.append(("config1", "10 nodes, 12 windows of 1 app", fifo_pack, c1,
                    b1, ["tightly-pack"] * 12, 8, 12))

    fifo_pack.launches = 0
    window_pack.launches = 0
    probe_add_one.launches = 0
    stats = {}
    for name, what, solve, cluster, batches, fills, emax, timed in configs:
        before = fifo_pack.launches
        ms, admitted, cpu_s = queue_chain(device, solve, cluster, batches,
                                          fills, emax=emax, num_zones=4)
        launches = fifo_pack.launches - before
        check(launches == len(batches),
              f"{name}: {launches} queue-kernel launches for {len(batches)} calls")
        head = ms[:timed]
        stats[name] = dict(what=what, windows=len(batches), emax=emax,
                           admitted=admitted, p50_ms=float(np.percentile(head, 50)),
                           p99_ms=float(np.percentile(head, 99)),
                           ms=ms, launches=launches, cpu_plain_s=cpu_s)
        apps = sum(int(b.app_valid.sum()) for b in batches)
        print(f"  {name} ({what}): admitted {sum(admitted)}/{apps} "
              f"(per call {admitted}); {fills[0]} fifo_pack per call p50 "
              f"{stats[name]['p50_ms']:.3f} ms p99 {stats[name]['p99_ms']:.3f} "
              f"ms over {len(head)} calls (CUDA events); queue-kernel launches "
              f"{launches}; CPU plain path {cpu_s:.1f} s", flush=True)
        if len(ms) > timed:
            print("    other strategies, one window each: " + ", ".join(
                f"{f} {m:.3f} ms ({a} admitted)" for f, m, a in
                zip(fills[timed:], ms[timed:], admitted[timed:])), flush=True)
    check(window_pack.launches == 0 and probe_add_one.launches == 0,
          "phase 5 launched another kernel")
    check(stats["config4"]["launches"] == 3, "config 4: not one launch per call")
    return fifo_pack.launches


# ---------------------------------------------------------------- phase 6

EXT_IG_LABEL = "resource_channel"
EXT_IG = "batch-medium-priority"
EXT_NS = "namespace"
EXT_CLOCK = 2.0e9  # one fixed clock for both extenders (FIFO age gates)
EXT_WINDOWS = 8
EXT_WINDOW = 32
EXT_EXTRAS = 16
EXT_RESCHEDULES = 16


def build_extender(device, track_usage=False, **solver_kw):
    """A port extender wired from its parts as the JAX package's
    server/app.py `build_scheduler_app` wires its own: an in-memory backend
    with the Demand CRD, synchronous write-back, `tightly-pack`, FIFO on,
    reconciler / metrics / events / waste / recorder / policy off, one
    fixed clock; `solver_kw` goes to the PlacementSolver. With
    `track_usage` the reservation manager carries the ReservedUsageTracker
    the app attaches, so the feature store journals the usage rows each
    reservation changes (the resident build's feed). Returns (extender,
    backend, solver)."""
    from spark_scheduler_tpu_torch.core.binpacker import select_binpacker
    from spark_scheduler_tpu_torch.core.demands import DemandManager
    from spark_scheduler_tpu_torch.core.extender import (
        ExtenderConfig,
        SparkSchedulerExtender,
    )
    from spark_scheduler_tpu_torch.core.overhead import OverheadComputer
    from spark_scheduler_tpu_torch.core.reservation_manager import (
        ResourceReservationManager,
    )
    from spark_scheduler_tpu_torch.core.soft_reservations import (
        SoftReservationStore,
    )
    from spark_scheduler_tpu_torch.core.solver import PlacementSolver
    from spark_scheduler_tpu_torch.core.sparkpods import SparkPodLister
    from spark_scheduler_tpu_torch.store.backend import (
        DEMAND_CRD,
        InMemoryBackend,
    )
    from spark_scheduler_tpu_torch.store.cache import (
        ResourceReservationCache,
        SafeDemandCache,
    )

    def clock():
        return EXT_CLOCK

    backend = InMemoryBackend()
    backend.register_crd(DEMAND_CRD)
    rr_cache = ResourceReservationCache(backend, sync_writes=True)
    demand_cache = SafeDemandCache(backend, sync_writes=True)
    soft_store = SoftReservationStore(backend)
    lister = SparkPodLister(backend, EXT_IG_LABEL)
    rrm = ResourceReservationManager(backend, rr_cache, soft_store, lister)
    overhead = OverheadComputer(backend, rrm)
    binpacker = select_binpacker("tightly-pack")
    demands = DemandManager(backend, demand_cache, EXT_IG_LABEL,
                            is_single_az_binpacker=binpacker.is_single_az,
                            events=None, waste=None, clock=clock)
    solver = PlacementSolver(device=device, **solver_kw)
    if track_usage:
        from spark_scheduler_tpu_torch.core.usage_tracker import (
            ReservedUsageTracker,
        )

        rrm.attach_usage_tracker(
            ReservedUsageTracker(solver.registry, rr_cache, soft_store)
        )
    ext = SparkSchedulerExtender(
        backend, lister, rrm, demands, overhead, binpacker, solver,
        config=ExtenderConfig(fifo=True, instance_group_label=EXT_IG_LABEL),
        reconciler=None, metrics=None, events=None, waste=None,
        recorder=None, clock=clock, policy=None,
    )
    ext._last_request = float("inf")  # no time-gap resync
    return ext, backend, solver


def extender_cluster(backend, n=N_MAIN):
    """Phase 3's 10,000 nodes (4 zones, one instance group), with its prior
    usage as one running pod of another scheduler on each node (the
    extender counts it as overhead)."""
    from spark_scheduler_tpu_torch.models.kube import Container, Pod
    from spark_scheduler_tpu_torch.models.resources import Resources

    nodes, usage = main_cluster(seed=7, n=n)
    for i, node in enumerate(nodes):
        node.labels[EXT_IG_LABEL] = EXT_IG
        backend.add_node(node)
        backend.add_pod(Pod(
            name=f"base-{i:05d}", namespace="other", uid=f"uid-base-{i:05d}",
            scheduler_name="default-scheduler", node_name=node.name,
            phase="Running",
            containers=[Container(requests=Resources(*map(int, usage[i])))],
        ))
    return [n.name for n in nodes]


def extender_apps(rng):
    """256 apps for the driver windows (2-8 executors, ~15% 32 wide), the
    first 16 with dynamic allocation (min 2, max 3: one extra executor
    each). As (app id, executors, dynamic)."""
    apps = []
    for i in range(EXT_WINDOWS * EXT_WINDOW):
        dyn = i < EXT_EXTRAS
        n = 2 if dyn else (32 if rng.random() < 0.15 else int(rng.integers(2, 9)))
        apps.append((f"app-{i:03d}", n + (1 if dyn else 0), dyn))
    return apps


def spark_pods(app_id, executors, dynamic, ts):
    """The driver and executor pods of one app (both extenders get their
    own objects, made alike)."""
    from spark_scheduler_tpu_torch.core import sparkpods as sp
    from spark_scheduler_tpu_torch.models.kube import Container, Pod
    from spark_scheduler_tpu_torch.models.resources import Resources

    ann = {sp.DRIVER_CPU: "1", sp.DRIVER_MEMORY: "2Gi",
           sp.EXECUTOR_CPU: "2", sp.EXECUTOR_MEMORY: "4Gi"}
    if dynamic:
        ann.update({sp.DYNAMIC_ALLOCATION_ENABLED: "true",
                    sp.DA_MIN_EXECUTOR_COUNT: str(executors - 1),
                    sp.DA_MAX_EXECUTOR_COUNT: str(executors)})
    else:
        ann[sp.EXECUTOR_COUNT] = str(executors)

    def pod(name, role, annotations, req):
        return Pod(
            name=name, namespace=EXT_NS, uid=f"uid-{name}",
            labels={sp.SPARK_ROLE_LABEL: role, sp.SPARK_APP_ID_LABEL: app_id},
            annotations=annotations, creation_timestamp=ts,
            scheduler_name=sp.SPARK_SCHEDULER_NAME,
            node_selector={EXT_IG_LABEL: EXT_IG},
            containers=[Container(requests=Resources.from_quantities(*req))],
        )

    return [pod(f"{app_id}-driver", sp.ROLE_DRIVER, ann, ("1", "2Gi"))] + [
        pod(f"{app_id}-exec-{k + 1}", sp.ROLE_EXECUTOR, {}, ("2", "4Gi"))
        for k in range(executors)
    ]


class ExtenderSide:
    """One extender of phase 6 with its own backend and pod objects."""

    def __init__(self, device, apps, n_nodes=N_MAIN, **solver_kw):
        self.ext, self.backend, self.solver = build_extender(
            device, **solver_kw)
        self.names = extender_cluster(self.backend, n_nodes)
        self.pods = {
            app: spark_pods(app, n, dyn, float(1 + i))
            for i, (app, n, dyn) in enumerate(apps)
        }

    def args(self, pod, names=None):
        from spark_scheduler_tpu_torch.core.extender import ExtenderArgs

        return ExtenderArgs(pod=pod, node_names=list(names or self.names))

    def state(self):
        """Every reservation (hard and soft) and every demand, by name."""
        def by_name(kind):
            return sorted(self.backend.list(kind),
                          key=lambda o: (o.namespace, o.name))

        return (by_name("resourcereservations"),
                self.ext._rrm.soft_store.get_all_copy(),
                by_name("demands"))

    def bind(self, pods, results):
        for pod, res in zip(pods, results):
            if res.ok:
                self.backend.bind_pod(pod, res.node_names[0])


def run_extender_phase(device, card):
    """Phase 6: the extender on the card (see the module docstring). Returns
    the row-walk and probe launches of the phase."""
    import torch

    from spark_scheduler_tpu_torch.models.kube import Node, ZONE_LABEL
    from spark_scheduler_tpu_torch.models.resources import Resources
    from spark_scheduler_tpu_torch.ops.probe import probe_add_one
    from spark_scheduler_tpu_torch.ops.window import window_pack

    t_setup = time.perf_counter()
    apps = extender_apps(np.random.default_rng(17))
    gpu = ExtenderSide(device, apps)
    cpu = ExtenderSide("cpu", apps)
    sides = (gpu, cpu)
    print(f"phase 6: two extenders (cuda, cpu) on {len(gpu.names)} nodes, "
          f"set up in {time.perf_counter() - t_setup:.1f} s", flush=True)

    # Held back from the windows: each dynamic app's extra executor (served
    # in a window after the drivers) and one executor each of 16 other apps
    # (rescheduled at the end through the solo pack).
    extras = [app for app, _, dyn in apps if dyn]
    resched = [app for app, _, dyn in apps if not dyn][:EXT_RESCHEDULES]

    def held(app, k):
        return (app in extras and k == len(gpu.pods[app]) - 1) or (
            app in resched and k == 1)

    upload_kinds: dict[str, int] = {}
    complete_ms, pack_ms = [], []
    counts = {"window": 0}
    window_pack.launches = 0
    probe_add_one.launches = 0
    solo_packs = [0]
    orig_pack = gpu.solver.pack

    def timed_pack(*a, **kw):
        before = window_pack.launches
        t0 = time.perf_counter()
        out = orig_pack(*a, **kw)
        torch.cuda.synchronize()
        pack_ms.append((time.perf_counter() - t0) * 1e3)
        check(window_pack.launches == before + 1,
              "a solo pack did not launch the row walk once")
        solo_packs[0] += 1
        return out

    gpu.solver.pack = timed_pack

    def same(got, want, what):
        check(got == want, f"phase 6: cuda != cpu at {what}")

    def dispatch(batch):
        """Dispatch one window on both sides; batch = [(app, pod index)]."""
        out = []
        for s in sides:
            for app, k in batch:
                s.backend.add_pod(s.pods[app][k])
            before = window_pack.launches
            t = s.ext.predicate_window_dispatch(
                [s.args(s.pods[app][k]) for app, k in batch])
            if s is gpu:
                kind = s.solver.last_state_upload if t.handle is not None else None
                if kind:
                    upload_kinds[kind] = upload_kinds.get(kind, 0) + 1
                segs = len(t.handle.requests) if t.handle is not None else 0
                check(window_pack.launches - before == segs,
                      f"window dispatch launched {window_pack.launches - before}"
                      f" row walks for {segs} segments")
                counts["window"] += bool(segs)
            out.append(t)
        return out

    def complete(batch, tickets):
        results = []
        for s, t in zip(sides, tickets):
            t0 = time.perf_counter()
            res = s.ext.predicate_window_complete(t)
            if s is gpu:
                complete_ms.append((time.perf_counter() - t0) * 1e3)
            s.bind([s.pods[app][k] for app, k in batch], res)
            results.append(res)
        same(results[0], results[1], f"window results {batch[:2]}...")
        same(gpu.state(), cpu.state(), "reservations and demands")
        return results[0]

    admitted_queue: list = []
    pending = None
    t0 = time.perf_counter()
    mid_events = {3: "pod-delete", 5: "node-add"}
    for w in range(EXT_WINDOWS + 2):
        batch = []
        if w < EXT_WINDOWS:
            batch += [(app, 0) for app, _, _ in
                      apps[w * EXT_WINDOW:(w + 1) * EXT_WINDOW]]
        while admitted_queue:
            app = admitted_queue.pop(0)
            batch += [(app, k) for k in range(1, len(gpu.pods[app]))
                      if not held(app, k)]
        if w == EXT_WINDOWS + 1:
            batch += [(app, len(gpu.pods[app]) - 1) for app in extras]
        tickets = dispatch(batch) if batch else None
        if w in mid_events and pending is not None:
            # Lands while the window just dispatched (and the one before
            # it) is in flight.
            for s in sides:
                if mid_events[w] == "pod-delete":
                    s.backend.delete_pod(
                        s.backend.get("pods", "other", "base-00000"))
                else:
                    s.backend.add_node(Node(
                        name="node-10000",
                        allocatable=Resources(64_000, 256 << 20, 0),
                        labels={ZONE_LABEL: "zone-0", EXT_IG_LABEL: EXT_IG},
                    ))
                    s.names = s.names + ["node-10000"]
        if pending is not None:
            res = complete(*pending)
            for (app, k), r in zip(pending[0], res):
                if k == 0 and r.ok:
                    admitted_queue.append(app)
        pending = (batch, tickets) if batch else None
    if pending is not None:
        complete(*pending)
    windows_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    outcomes = []
    for app in resched:
        results = []
        for s in sides:
            rr = s.ext._rrm.get_resource_reservation(app, EXT_NS)
            taken = {r.node for r in rr.spec.reservations.values()}
            pod = s.pods[app][1]
            s.backend.add_pod(pod)
            res = s.ext.predicate(
                s.args(pod, [n for n in s.names if n not in taken]))
            s.bind([pod], [res])
            results.append(res)
        same(results[0], results[1], f"reschedule of {app}")
        outcomes.append(results[0].outcome)
    same(gpu.state(), cpu.state(), "reservations and demands after reschedules")
    resched_s = time.perf_counter() - t0
    torch.cuda.synchronize()

    rr = gpu.backend.list("resourcereservations")
    check(len(rr) == len(apps), f"{len(rr)} reservations for {len(apps)} apps")
    check(outcomes.count("success-rescheduled") == EXT_RESCHEDULES,
          f"reschedule outcomes {outcomes}")
    check(solo_packs[0] == EXT_RESCHEDULES, f"{solo_packs[0]} solo packs")
    soft = gpu.ext._rrm.soft_store.get_all_copy()
    n_soft = sum(len(v.reservations) for v in soft.values())
    check(n_soft == EXT_EXTRAS, f"{n_soft} soft reservations for "
                                f"{EXT_EXTRAS} extra executors")
    check(upload_kinds.get("delta", 0) >= 2,
          f"the mid-flight pod deletion and node add did not ship as deltas: "
          f"{upload_kinds}")
    launches = {"window": window_pack.launches, "probe": probe_add_one.launches}
    check(launches["probe"] == 1, f"probe launches {launches['probe']}")
    p = np.percentile
    print(f"phase 6: {len(apps)} driver predicates in {EXT_WINDOWS} pipelined "
          f"windows of {EXT_WINDOW} (window k+1 dispatched before window k "
          f"completes), then the admitted apps' executors in the following "
          f"windows, {EXT_EXTRAS} dynamic-allocation extra executors (soft "
          f"reservations), a pod deletion (window 4) and a node add (window 6) "
          f"while windows were in flight, and {EXT_RESCHEDULES} executor "
          f"reschedules through the solo pack: cuda == cpu on every result, "
          f"reservation and demand ({len(rr)} reservations, {n_soft} soft) "
          f"in {windows_s:.1f} s + {resched_s:.1f} s", flush=True)
    print(f"phase 6 ({card}): row-walk launches {launches['window']} "
          f"({counts['window']} driver windows, {solo_packs[0]} solo packs); "
          f"builds {upload_kinds}; predicate_window_complete p50 "
          f"{p(complete_ms, 50):.3f} ms p99 {p(complete_ms, 99):.3f} ms over "
          f"{len(complete_ms)} windows; solo pack p50 {p(pack_ms, 50):.3f} ms "
          f"p99 {p(pack_ms, 99):.3f} ms over {len(pack_ms)} calls "
          f"(host clock, ending in torch.cuda.synchronize)", flush=True)
    fault_free(gpu.solver, 6)
    return launches


# ---------------------------------------------------------------- phase 7

SRV_CLIENTS = 32
SRV_DRIVERS = 256
SRV_ROUTE_NODES = 4  # nodes synced through PUT /state/nodes


class RecordedServer:
    """The port's app behind its HTTP server, with a recorder around it:
    every pod and node change the routes (or this script) make, and every
    window dispatch and completion the batcher runs, land in `log` in the
    order they took effect. One lock orders the changes against each
    dispatch and each completion, so a replay of `log` on another app
    sees, at each window, the state this server saw.

    `backend` replaces the in-memory backend (phases 9-10: the durable
    store). With `kinds`, the recorder wraps the backend's generic
    `create` / `update` / `delete` for those kinds instead of the routes'
    typed calls: watch ingestion writes through them. `app_factory(backend,
    registry, metrics)` returns (app, HA runtime or None) in place of
    `build_scheduler_app`. With `start=False` the HTTP server is built but
    not started. `clock` replaces the fixed clock (phase 13's injected
    clock). With `quiet_ops`, the backend changes made inside a window's
    dispatch or completion (a preemption's evictions) are not logged: the
    replay's own dispatch and completion make them. `marked(fn)` runs
    `fn(app)` under the lock as one log entry, its own changes unlogged,
    for the replay to run on its app (phase 13's autoscaler passes, clock
    advances and teardowns)."""

    def __init__(self, device, config, transport="threaded", ingest="python",
                 *, backend=None, kinds=None, app_factory=None, start=True,
                 clock=None, quiet_ops=False):
        import copy
        import threading

        from spark_scheduler_tpu_torch.core.solver import PipelineDrainRequired
        from spark_scheduler_tpu_torch.metrics import (
            MetricRegistry,
            SchedulerMetrics,
        )
        from spark_scheduler_tpu_torch.ops.window import window_pack
        from spark_scheduler_tpu_torch.server.app import build_scheduler_app
        from spark_scheduler_tpu_torch.server.http import SchedulerHTTPServer
        from spark_scheduler_tpu_torch.store.backend import (
            DEMAND_CRD,
            InMemoryBackend,
        )

        if backend is None:
            backend = InMemoryBackend()
            backend.register_crd(DEMAND_CRD)
        self.backend = backend
        self.registry = MetricRegistry()
        metrics = SchedulerMetrics(self.registry, EXT_IG_LABEL)
        self.runtime = None
        if app_factory is None:
            self.app = build_scheduler_app(
                self.backend, config, metrics=metrics,
                clock=clock or (lambda: EXT_CLOCK), device=device,
            )
        else:
            self.app, self.runtime = app_factory(self.backend, self.registry,
                                                 metrics)
        self.lock = threading.RLock()
        self.log: list = []
        self.solo_packs = {"batcher": 0, "other": 0, "d2h": 0}
        # Dispatches so far, and windows dispatched but not yet completed.
        self.counts = {"dispatched": 0, "inflight": 0}
        # Called on the dispatcher thread, outside the lock, right after the
        # `trigger_at`-th dispatch: that window is in flight meanwhile.
        self.trigger_at, self.on_trigger = None, None
        # Or, with `trigger_when(entry, in-flight entries)`, right after the
        # first dispatch for which it holds.
        self.trigger_when = None
        # Set on a thread while its changes are not to be logged.
        self.quiet = threading.local()
        quiet = self.quiet
        # Host clock at which each pod's create reached the backend, and at
        # which the recorder's lock let it apply (phases 9-10).
        self.seen: dict = {}
        backend, log, lock, counts = self.backend, self.log, self.lock, self.counts
        seen = self.seen

        def recorded_verb(name):
            orig = getattr(backend, name)

            def call(kind, *args):
                if kind not in kinds or getattr(quiet, "on", False):
                    return orig(kind, *args)
                reached = time.perf_counter()
                with lock:
                    out = orig(kind, *args)
                    log.append(("change", name, copy.deepcopy((kind, *args)),
                                counts["inflight"]))
                    if name == "create" and kind == "pods":
                        seen.setdefault(args[0].name,
                                        (reached, time.perf_counter()))
                return out

            setattr(backend, name, call)

        def recorded(name):
            orig = getattr(backend, name)

            def call(*args):
                if (name == "update" and args[0] != "nodes") or getattr(
                        quiet, "on", False):
                    return orig(*args)
                with lock:
                    out = orig(*args)
                    log.append(("change", name, copy.deepcopy(args),
                                counts["inflight"]))
                return out

            setattr(backend, name, call)

        if kinds is None:
            for name in ("add_node", "update", "add_pod", "update_pod",
                         "delete_pod"):
                recorded(name)
        else:
            for name in ("create", "update", "delete"):
                recorded_verb(name)

        ext = self.app.extender
        dispatch, complete = ext.predicate_window_dispatch, ext.predicate_window_complete
        entries = {}
        resolved_owners: set = set()

        def recorded_dispatch(args_list):
            from spark_scheduler_tpu_torch.core.extender import ExtenderArgs

            with lock:
                # A native ticket (NativeNodeNames) is immutable and is
                # recorded as it is: listing it would decode its names.
                e = {"op": "dispatch", "drain": False,
                     "args": [ExtenderArgs(pod=copy.deepcopy(a.pod),
                                           node_names=(
                                               a.node_names
                                               if hasattr(a.node_names,
                                                          "names_digest")
                                               else list(a.node_names)))
                              for a in args_list]}
                log.append(e)
                before = window_pack.launches
                t0 = time.perf_counter()
                quiet.on = quiet_ops
                try:
                    t = dispatch(args_list)
                except PipelineDrainRequired:
                    e["drain"] = True
                    raise
                finally:
                    quiet.on = False
                e["ms"] = (time.perf_counter() - t0) * 1e3
                counts["dispatched"] += 1
                counts["inflight"] += 1
                e["launches"] = window_pack.launches - before
                e["segments"] = len(t.handle.requests) if t.handle is not None else 0
                e["dispatch_id"] = (
                    t.handle.info["dispatch_id"] if t.handle is not None else None
                )
                e["rows"] = t.handle.info["rows"] if t.handle is not None else 0
                # The decision blob each window's fetch copies to the host.
                e["d2h"] = (getattr(t.handle.blob, "nbytes", 0)
                            if t.handle is not None else 0)
                entries[id(t)] = e
                fire = self.trigger_when is not None and self.trigger_when(
                    e, list(entries.values()))
            if fire:
                self.trigger_when = None
                self.on_trigger()
            if counts["dispatched"] == self.trigger_at and self.on_trigger:
                self.on_trigger()
            return t

        def recorded_complete(t):
            with lock:
                e = {"op": "complete", "dispatch": entries.pop(id(t))}
                log.append(e)
                counts["inflight"] -= 1
                before = window_pack.launches
                t0 = time.perf_counter()
                quiet.on = quiet_ops
                try:
                    out = complete(t)
                finally:
                    quiet.on = False
                e["ms"] = (time.perf_counter() - t0) * 1e3
                e["launches"] = window_pack.launches - before
                # A pruned window whose certificate failed (or a window
                # dispatched on its carry) re-solves in full at its
                # completion, once per dispatch.
                h = t.handle
                owner = getattr(h, "owner", h)
                resolved = (owner.info or {}).get("resolved") if owner else None
                if resolved is not None and owner not in resolved_owners:
                    resolved_owners.add(owner)
                    e["resolved"] = resolved
                return out

        fused_dispatch = ext.predicate_windows_dispatch

        def recorded_fused(args_lists):
            """A fused claim: one device dispatch for K windows. Each
            window gets its own entry ("sub") for its completion; the
            dispatch's launches, rows and decision bytes go to the first."""
            from spark_scheduler_tpu_torch.core.extender import ExtenderArgs

            with lock:
                e = {"op": "fused", "drain": False,
                     "args_lists": [[ExtenderArgs(pod=copy.deepcopy(a.pod),
                                                  node_names=(
                                                      a.node_names
                                                      if hasattr(a.node_names,
                                                                 "names_digest")
                                                      else list(a.node_names)))
                                     for a in args] for args in args_lists]}
                log.append(e)
                before = window_pack.launches
                t0 = time.perf_counter()
                try:
                    tickets = fused_dispatch(args_lists)
                except PipelineDrainRequired:
                    e["drain"] = True
                    raise
                e["ms"] = (time.perf_counter() - t0) * 1e3
                counts["dispatched"] += 1
                counts["inflight"] += len(tickets)
                e["launches"] = window_pack.launches - before
                e["subs"], owners = [], set()
                for args, t in zip(e["args_lists"], tickets):
                    h = t.handle
                    owner = getattr(h, "owner", h)
                    first = h is not None and id(owner) not in owners
                    owners.add(id(owner))
                    sub = {"op": "sub", "args": args, "fused_k": len(tickets),
                           "segments": len(h.requests) if h is not None else 0,
                           "dispatch_id": (h.info["dispatch_id"]
                                           if h is not None else None),
                           "rows": h.info["rows"] if first else 0,
                           "d2h": (getattr(owner.blob, "nbytes", 0)
                                   if first else 0)}
                    e["subs"].append(sub)
                    entries[id(t)] = sub
            if counts["dispatched"] == self.trigger_at and self.on_trigger:
                self.on_trigger()
            return tickets

        ext.predicate_window_dispatch = recorded_dispatch
        ext.predicate_windows_dispatch = recorded_fused
        ext.predicate_window_complete = recorded_complete
        pack, solo = self.app.solver.pack, self.solo_packs
        from spark_scheduler_tpu_torch.models.cluster import pad_bucket

        def counted_pack(*a, **kw):
            who = ("batcher" if threading.current_thread().name == "predicate-batcher"
                   else "other")
            solo[who] += 1
            # The decision row a solo pack copies to the host: driver,
            # admitted, packed and the executor slots, int32.
            count = kw["executor_count"] if "executor_count" in kw else a[4]
            solo["d2h"] += 4 * (3 + pad_bucket(max(count, 1), 8))
            return pack(*a, **kw)

        self.app.solver.pack = counted_pack
        # How every successful pipelined build reached the card.
        self.builds = {"full": 0, "delta": 0, "reuse": 0}
        build, solver = self.app.solver.build_tensors_pipelined, self.app.solver

        def counted_build(*a, **kw):
            out = build(*a, **kw)
            self.builds[solver.last_state_upload] += 1
            return out

        self.app.solver.build_tensors_pipelined = counted_build
        self.server = SchedulerHTTPServer(
            self.app, self.registry, port=0, debug_routes=True,
            request_timeout_s=300.0, transport=transport, ingest=ingest,
            ha=self.runtime,
        )
        # Native decode times of the fast-path hits (the codec's own
        # telemetry keeps only their sum).
        self.decode_ns: list = []
        codec = self.server.ingest_codec
        if codec is not None:
            finish, decode_ns = codec._finish, self.decode_ns

            def timed_finish(slot, hit, binary):
                if hit:
                    decode_ns.append(slot.decode_ns)
                return finish(slot, hit, binary)

            codec._finish = timed_finish
        if start:
            self.server.start()

    def marked(self, fn, label=""):
        """Run `fn(app)` under the lock as one log entry ({"op": "marked"}),
        with the changes it makes unlogged; returns its result, which the
        replay's run of `fn` on its app must equal."""
        with self.lock:
            e = {"op": "marked", "fn": fn, "label": label}
            self.log.append(e)
            self.quiet.on = True
            try:
                e["result"] = fn(self.app)
            finally:
                self.quiet.on = False
        return e["result"]


def k8s_node_json(node):
    a = node.allocatable
    return {
        "metadata": {"name": node.name, "labels": dict(node.labels)},
        "status": {
            "allocatable": {"cpu": str(a.cpu_milli // 1000),
                            "memory": f"{a.mem_kib >> 20}Gi",
                            "nvidia.com/gpu": str(a.gpu_milli // 1000)},
            "conditions": [{"type": "Ready", "status": "True"}],
        },
    }


def k8s_spark_pod_json(app_id, role, name, executors, created):
    import datetime

    ts = datetime.datetime.fromtimestamp(created, datetime.timezone.utc)
    return {
        "metadata": {
            "name": name, "namespace": EXT_NS, "uid": f"uid-{name}",
            "labels": {"spark-role": role, "spark-app-id": app_id},
            "annotations": {
                "spark-driver-cpu": "1", "spark-driver-mem": "2Gi",
                "spark-executor-cpu": "2", "spark-executor-mem": "4Gi",
                "spark-executor-count": str(executors),
            },
            "creationTimestamp": ts.strftime("%Y-%m-%dT%H:%M:%SZ"),
        },
        "spec": {
            "schedulerName": "spark-scheduler",
            "nodeSelector": {EXT_IG_LABEL: EXT_IG},
            "containers": [{"name": "main", "resources": {"requests": (
                {"cpu": "1", "memory": "2Gi"} if role == "driver"
                else {"cpu": "2", "memory": "4Gi"})}}],
        },
        "status": {"phase": "Pending"},
    }


def binary_predicate(pod, names, _frames={}):
    """The `application/x-spark-predicate` body of {"Pod": pod, "NodeNames":
    names}, as server/ingest.encode_predicate_binary writes it; the names
    frame is encoded once per list."""
    import struct

    from spark_scheduler_tpu_torch.server.ingest import encode_predicate_binary

    frame = _frames.get(id(names))
    if frame is None:
        frame = encode_predicate_binary(b"", names)[9:]
        _frames[id(names)] = frame
    raw = json.dumps(pod).encode()
    return b"SPRD\x01" + struct.pack("<I", len(raw)) + raw + frame


def run_clients(port, jobs, n_clients, binary=False, keep_all=False):
    """Run `jobs` on `n_clients` threads (job i on thread i % n_clients),
    each thread on one keep-alive connection. A job is a list of
    (method, path, payload) requests, or a function that makes its
    requests through the `send(method, path, payload)` it is given (and
    may look at the answers). With `binary`, the odd-numbered threads post
    their predicates as binary bodies. Returns {pod name: (status, body)}
    for the predicates (with `keep_all`, {pod name: [(status, body), ...]}
    in the order sent) and their client-side latencies in ms."""
    import http.client
    import socket
    import threading

    out, lat, errors = {}, [], []
    mu = threading.Lock()

    def worker(k):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        # As kube-scheduler's Go client does: no Nagle delay between a
        # request's header and body writes.
        conn.connect()
        conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

        as_binary = binary and k % 2 == 1

        def send(method, path, payload):
            ctype = "application/json"
            if as_binary and path == "/predicates":
                body = binary_predicate(payload["Pod"], payload["NodeNames"])
                ctype = "application/x-spark-predicate"
            else:
                body = json.dumps(payload).encode() if payload is not None else None
            t0 = time.perf_counter()
            conn.request(method, path, body=body,
                         headers={"Content-Type": ctype})
            resp = conn.getresponse()
            data = resp.read()
            ms = (time.perf_counter() - t0) * 1e3
            with mu:
                if path.split("?")[0] == "/predicates":
                    name = payload["Pod"]["metadata"]["name"]
                    if keep_all:
                        out.setdefault(name, []).append((resp.status, data))
                    else:
                        out[name] = (resp.status, data)
                    lat.append(ms)
                elif resp.status != 200:
                    errors.append((method, path, resp.status, data[:200]))
            return resp.status, data

        try:
            for job in jobs[k::n_clients]:
                if callable(job):
                    job(send)
                    continue
                for method, path, payload in job:
                    send(method, path, payload)
        except Exception as exc:  # surfaced below
            with mu:
                errors.append(repr(exc))
        finally:
            conn.close()

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    check(not errors, f"client errors: {errors[:4]}")
    return out, lat


def http_get(port, path):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("GET", path)
    resp = conn.getresponse()
    out = (resp.status, resp.read())
    conn.close()
    return out


def series(snapshot, name):
    """{tags as a sorted tuple: value} of one counter in a /metrics JSON
    snapshot."""
    return {tuple(sorted(e["tags"].items())): e["value"]
            for e in snapshot.get(name, [])}


def run_server_phase(device, card, n_nodes=N_MAIN, n_drivers=SRV_DRIVERS,
                     n_clients=SRV_CLIENTS, *, phase=7, transport="threaded",
                     ingest="python", before=None, fuse=1, max_window=32,
                     prune=0):
    """Phase 7 (threaded transport, python ingest), phase 8 (async
    transport, native ingest, half the clients on binary bodies), phase
    11 (phase 7's, with `solver.fuse-windows: fuse` and windows of
    `max_window`) or phase 12b (`solver.prune-top-k: prune`, replayed on
    an unpruned cpu app): the port's HTTP server on the card (see the
    module docstring). `before` is phase 7's stats, printed beside this
    phase's. Returns the row-walk and probe launches of the phase and its
    stats."""
    import copy
    import dataclasses
    import threading

    import torch

    from spark_scheduler_tpu_torch.models.kube import Container, Pod
    from spark_scheduler_tpu_torch.models.resources import Resources
    from spark_scheduler_tpu_torch.ops.probe import probe_add_one
    from spark_scheduler_tpu_torch.ops.window import window_pack
    from spark_scheduler_tpu_torch.server.config import InstallConfig
    from spark_scheduler_tpu_torch.testing.harness import overcommit_violations

    on_card = torch.device(device).type == "cuda"
    t_phase = time.perf_counter()
    config = InstallConfig(
        fifo=True, binpack_algo="tightly-pack",
        instance_group_label=EXT_IG_LABEL, sync_writes=True,
        debug_routes=True, solver_fuse_windows=fuse,
        predicate_max_window=max_window, solver_prune_top_k=prune,
    )
    native = ingest == "native"
    window_pack.launches = 0
    probe_add_one.launches = 0
    srv = RecordedServer(device, config, transport=transport, ingest=ingest)
    port = srv.server.port
    try:
        nodes, usage = main_cluster(seed=7)
        nodes, usage = nodes[:n_nodes], usage[:n_nodes]
        for node in nodes:
            node.labels[EXT_IG_LABEL] = EXT_IG
        names = [n.name for n in nodes]
        ready0 = http_get(port, "/status/readiness")
        check(ready0[0] == 503, f"readiness before any node: {ready0}")
        run_clients(port, [[("PUT", "/state/nodes", k8s_node_json(nd))]
                           for nd in nodes[:SRV_ROUTE_NODES]], 1)
        ready1 = http_get(port, "/status/readiness")
        check(ready1 == (200, b'{"ready": true}'),
              f"readiness after PUT /state/nodes: {ready1}")
        for i, node in enumerate(nodes):
            if i >= SRV_ROUTE_NODES:
                srv.backend.add_node(node)
            srv.backend.add_pod(Pod(
                name=f"base-{i:05d}", namespace="other", uid=f"uid-base-{i:05d}",
                scheduler_name="default-scheduler", node_name=node.name,
                phase="Running",
                containers=[Container(requests=Resources(*map(int, usage[i])))],
            ))
        rng = np.random.default_rng(23)
        apps = []
        for i in range(n_drivers):
            n_exec = 32 if rng.random() < 0.15 else int(rng.integers(2, 9))
            created = EXT_CLOCK - 500 + i  # younger than the marker's timeout
            apps.append((f"srv-{i:03d}", n_exec, created))
        drivers = {a: k8s_spark_pod_json(a, "driver", f"{a}-driver", n, c)
                   for a, n, c in apps}
        created = {a: c for a, _, c in apps}
        t_setup = time.perf_counter() - t_phase
        print(f"phase {phase}: server on port {port} ({srv.app.solver.device}, "
              f"{transport} transport, {ingest} ingest), "
              f"{len(nodes)} nodes ({SRV_ROUTE_NODES} through PUT "
              f"/state/nodes), set up in {t_setup:.1f} s", flush=True)

        # Drivers: each client PUTs its pod, then POSTs its predicate. A pod
        # deletion and a node PUT land while windows are in flight.
        extra = copy.deepcopy(nodes[0])
        extra.name = f"node-{n_nodes:05d}"

        def mid_flight():
            # Through the routes, from another thread, while the third
            # dispatched window is in flight.
            side = threading.Thread(target=run_clients, args=(port, [[
                ("DELETE", "/state/pods/other/base-00001", None),
                ("PUT", "/state/nodes", k8s_node_json(extra))]], 1))
            side.start()
            side.join()

        srv.trigger_at, srv.on_trigger = 3, mid_flight

        def driver_job(app):
            def job(send):
                pod = drivers[app]
                send("PUT", "/state/pods", pod)
                status, data = send("POST", "/predicates",
                                    {"Pod": pod, "NodeNames": names})
                res = json.loads(data) if status == 200 else {}
                if res.get("NodeNames"):
                    # kube-scheduler binds the admitted driver.
                    bound = copy.deepcopy(pod)
                    bound["spec"]["nodeName"] = res["NodeNames"][0]
                    bound["status"]["phase"] = "Running"
                    send("PUT", "/state/pods", bound)
            return job

        t0 = time.perf_counter()
        got, lat_drv = run_clients(port, [driver_job(a) for a, _, _ in apps],
                                   n_clients, binary=native)
        drv_s = time.perf_counter() - t0
        stage_mark = len(srv.log)
        status, body = http_get(port, "/debug/decisions?role=driver&limit=100000")
        check(status == 200, f"/debug/decisions: {status}")
        recorded = json.loads(body)["decisions"]

        # Executors of the admitted apps.
        admitted = []
        for a, n, _ in apps:
            st, data = got[f"{a}-driver"]
            res = json.loads(data)
            check(st == 200 and not res["Error"], f"driver {a}: {st} {data[:200]}")
            if res["NodeNames"]:
                admitted.append((a, n, res["NodeNames"][0]))
        jobs = []
        for a, n, node in admitted:
            job = []
            for k in range(n):
                ex = k8s_spark_pod_json(a, "executor", f"{a}-exec-{k + 1}", n,
                                        created[a])
                job += [("PUT", "/state/pods", ex),
                        ("POST", "/predicates", {"Pod": ex, "NodeNames": names})]
            jobs.append(job)
        t0 = time.perf_counter()
        got_exec, lat_exec = run_clients(port, jobs, n_clients, binary=native)
        exec_s = time.perf_counter() - t0
        got.update(got_exec)
        metrics = http_get(port, "/metrics")
        ready2 = http_get(port, "/status/readiness")
        check(metrics[0] == 200, f"/metrics: {metrics[0]}")
        check(ready2 == (200, b'{"ready": true}'), f"readiness at the end: {ready2}")
        snapshot = json.loads(metrics[1])
        batcher = snapshot["predicate_batcher"]
        state = http_get(port, "/debug/state")
        check(state[0] == 200, f"/debug/state: {state[0]}")
        state_json = json.loads(state[1])
        prune_block = state_json.get("prune", {})
        build_state = state_json.get("build", {})
        violations = overcommit_violations(srv.app, srv.backend)
        check(not violations, f"phase {phase} over-commit: {violations[:8]}")
        fault_free(srv.app.solver, phase)
    finally:
        srv.server.stop()
    launches = {"window": window_pack.launches, "probe": probe_add_one.launches}
    serve_s = time.perf_counter() - t_phase

    # What the log says: the windows, their segments and solo packs. A
    # fused claim is one dispatch of several windows ("sub" entries).
    log = srv.log
    dispatches = [e for e in log if isinstance(e, dict)
                  and e["op"] in ("dispatch", "fused")]
    drains = sum(e["drain"] for e in dispatches)
    done = [w for e in dispatches if not e["drain"]
            for w in (e["subs"] if e["op"] == "fused" else [e])]
    driver_windows = [e for e in done if e["dispatch_id"] is not None]
    device_dispatches = len({e["dispatch_id"] for e in driver_windows})
    fused_ks = [len(e["subs"]) for e in dispatches
                if e["op"] == "fused" and not e["drain"]]
    segments = sum(e["segments"] for e in done)
    resolved = [e["resolved"] for e in log
                if isinstance(e, dict) and "resolved" in e]
    resolved_segments = sum(r["segments"] for r in resolved)
    solo = srv.solo_packs
    check(solo["other"] == 0, f"solo packs off the batcher thread: {solo}")
    if on_card:
        window_launches = sum(e["launches"] for e in log
                              if isinstance(e, dict) and "launches" in e)
        check(window_launches == launches["window"],
              f"launches outside dispatch/complete: {launches['window']} vs "
              f"{window_launches}")
        check(launches["window"] == segments + resolved_segments + solo["batcher"],
              f"row-walk launches {launches['window']} != {segments} live "
              f"segments + {resolved_segments} re-solved + "
              f"{solo['batcher']} solo packs")
        check(launches["probe"] == 1, f"probe launches {launches['probe']}")
    # The driver windows the server formed, as /debug/decisions reports
    # them (dispatch_id), equal the recorded ones.
    by_id: dict = {}
    for d in recorded:
        if d.get("dispatch_id") is not None:
            by_id.setdefault(d["dispatch_id"], set()).add(d["pod_name"])
    want_ids: dict = {}
    for e in driver_windows:
        want_ids.setdefault(e["dispatch_id"], set()).update(
            a.pod.name for a in e["args"]
            if a.pod.labels.get("spark-role") == "driver")
    want_ids = {k: v for k, v in want_ids.items() if v}
    check(by_id == want_ids, f"phase {phase}: /debug/decisions windows differ "
                             "from the dispatched ones")

    # The solver telemetry on /metrics against what this script counted.
    path = "pallas" if on_card else "xla"
    dispatches = series(snapshot, "foundry.spark.scheduler.solver.window.dispatches")
    pruned_windows = dispatches.get((("path", path + "-pruned"),), 0)
    check(pruned_windows == prune_block.get("windows", 0),
          f"phase {phase}: {pruned_windows} pruned dispatches on /metrics, "
          f"{prune_block.get('windows', 0)} on /debug/state")
    check(set(dispatches) <= {(("path", path),), (("path", path + "-pruned"),)}
          and sum(dispatches.values()) == device_dispatches,
          f"phase {phase}: solver.window.dispatches {dispatches} != "
          f"{device_dispatches} device dispatches of driver windows")
    uploads = series(snapshot, "foundry.spark.scheduler.solver.device.uploads")
    label = str(srv.app.solver.device)
    want_uploads = {(("device", label), ("kind", k)): v
                    for k, v in srv.builds.items() if v}
    check(uploads == want_uploads, f"phase {phase}: solver.device.uploads "
                                   f"{uploads} != builds {srv.builds}")
    transfer = series(snapshot, "foundry.spark.scheduler.solver.transfer.bytes")
    d2h = (sum(e.get("d2h", 0) for e in done) + solo["d2h"]
           + sum(r["d2h"] for r in resolved))
    check(transfer.get((("direction", "d2h"),)) == d2h,
          f"phase {phase}: d2h solver.transfer.bytes {transfer} != {d2h} "
          f"decision bytes")
    h2d = transfer.get((("direction", "h2d"),), 0)
    check(h2d > 0, f"phase {phase}: no h2d solver.transfer.bytes")

    # Native tickets the serving path decoded into Python strings (before
    # the replay below decodes any): a ticket whose names were iterated
    # keeps its decoded list.
    decoded = {}
    if native:
        for e in done:
            for a in e["args"]:
                role = a.pod.labels.get("spark-role", "")
                n_dec, n_all = decoded.get(role, (0, 0))
                decoded[role] = (n_dec + (a.node_names._list is not None), n_all + 1)

    # Replay: a cpu app of the port fed the same changes and windows in the
    # same order must answer every predicate with the same bytes.
    t0 = time.perf_counter()
    compared = replay_server_log(
        log, dataclasses.replace(config, solver_prune_top_k=0), got,
        skip_drains=bool(prune))
    check(compared == len(got), f"compared {compared} of {len(got)} responses")
    mid = [(e[1], e[3]) for e in log if isinstance(e, tuple)
           and (e[1] == "delete_pod" or (e[1] == "add_node"
                                         and e[2][0].name == f"node-{n_nodes:05d}"))]
    check(len(mid) == 2, f"mid-flight changes {mid}")
    replay_s = time.perf_counter() - t0
    ingest_stats = snapshot["server_ingest"]
    transport_stats = snapshot["server_transport"]
    if native:
        posts = len(lat_drv) + len(lat_exec)
        check(ingest_stats["decode_fallbacks"] == 0
              and ingest_stats["decode_hits"] == posts
              and len(srv.decode_ns) == posts,
              f"phase {phase}: native decodes {ingest_stats} for {posts} "
              f"predicates (every one must be a fast-path hit)")
        check(ingest_stats["binary_requests"] > 0, "phase 8: no binary body")

    def busy_s(entries):
        return sum(e.get("ms", 0.0) for e in entries if isinstance(e, dict)) / 1e3

    drv_busy, exec_busy = busy_s(log[:stage_mark]), busy_s(log[stage_mark:])
    n_windows = batcher["windows_served"]
    p = np.percentile
    n_admitted = len(admitted)
    # Dispatch -> decisions on the host, per window of each dispatch
    # (solver telemetry): a fused dispatch's round trip divided by its K.
    rtt = snapshot.get("foundry.spark.scheduler.solver.dispatch.amortized.rtt.ms", [])
    rtt_n = sum(e["count"] for e in rtt)
    rtt_mean = sum(e["sum"] for e in rtt) / rtt_n if rtt_n else float("nan")
    rtt_by_k = {int(e["tags"]["fused"]): (e["count"], e["p50"]) for e in rtt}
    if fuse > 1:
        check(batcher["max_fused_k"] >= 2 and fused_ks and max(fused_ks) >= 2,
              f"phase {phase}: no fused claim (max_fused_k "
              f"{batcher['max_fused_k']}, fused dispatches {fused_ks})")
        check(batcher["fused_dispatches"] == len(fused_ks),
              f"phase {phase}: the batcher counts {batcher['fused_dispatches']} "
              f"fused dispatches, the log {len(fused_ks)}")
    stats = {
        "drv_p50": p(lat_drv, 50), "drv_p99": p(lat_drv, 99),
        "drv_rate": n_drivers / drv_s,
        "exec_p50": p(lat_exec, 50), "exec_p99": p(lat_exec, 99),
        "exec_rate": len(lat_exec) / exec_s,
        "drv_busy": drv_busy, "exec_busy": exec_busy, "rtt_mean": rtt_mean,
        "driver_windows": len(driver_windows), "prune": prune_block,
        "resolved": len(resolved), "device_dispatches": device_dispatches,
        "build": build_state,
    }
    print(f"phase {phase}: {n_drivers} driver predicates from {n_clients} client "
          f"threads ({n_admitted} admitted), then {len(lat_exec)} executor "
          f"predicates; {drains} pipeline drains; a pod DELETE and a node PUT "
          f"with {mid[0][1]} and {mid[1][1]} windows in flight; responses "
          f"byte-identical to a cpu "
          f"replay of the same {len(done)} windows ({compared} compared, "
          f"replay {replay_s:.1f} s); over-commit none", flush=True)
    print(f"phase {phase} ({card}): windows formed {n_windows} (driver windows "
          f"{len(driver_windows)}, mean window {batcher['mean_window']}, "
          f"largest {batcher['max_window_seen']}, pipelined "
          f"{batcher['pipelined_windows']}); driver /predicates p50 "
          f"{p(lat_drv, 50):.3f} ms p99 {p(lat_drv, 99):.3f} ms, "
          f"{n_drivers / drv_s:.1f} decisions/s; executor /predicates p50 "
          f"{p(lat_exec, 50):.3f} ms p99 {p(lat_exec, 99):.3f} ms, "
          f"{len(lat_exec) / exec_s:.1f} decisions/s (client host clock); "
          f"the batcher's dispatch + complete took {drv_busy:.2f} s of the "
          f"driver stage's {drv_s:.2f} s and {exec_busy:.2f} s of the "
          f"executor stage's {exec_s:.2f} s; "
          f"row-walk launches {launches['window']} = {segments} live segments "
          f"({sum(e['rows'] for e in done)} rows) + {resolved_segments} "
          f"re-solved + {solo['batcher']} solo packs; probe {launches['probe']}; "
          f"served in {serve_s:.1f} s", flush=True)
    print(f"phase {phase} ({card}): /debug/state build block {build_state}; "
          f"the batcher busy {drv_busy / drv_s:.3f} of the driver stage",
          flush=True)
    print(f"phase {phase}: /metrics solver.window.dispatches {dispatches}, "
          f"solver.device.uploads {srv.builds}, "
          f"solver.transfer.bytes h2d {h2d} d2h {d2h}: equal to this "
          f"script's count", flush=True)
    if fuse > 1:
        hist = {k: fused_ks.count(k) for k in sorted(set(fused_ks))}
        print(f"phase {phase} ({card}): windows of {max_window}, "
              f"fuse-windows {fuse}: {len(fused_ks)} fused dispatches "
              f"(fused_k histogram {hist}, largest {batcher['max_fused_k']}), "
              f"{device_dispatches} device dispatches for "
              f"{len(driver_windows)} driver windows; per-window amortized "
              f"round trip mean {rtt_mean:.3f} ms against phase 7's "
              f"{before['rtt_mean']:.3f} ms; by the solver's fused_k (the "
              f"windows with drivers; count, p50 ms): {rtt_by_k}", flush=True)
    if before is not None:
        print(f"phase {phase} against phase 7 ({card}, same run): driver p50 "
              f"{stats['drv_p50']:.3f} / {before['drv_p50']:.3f} ms, p99 "
              f"{stats['drv_p99']:.3f} / {before['drv_p99']:.3f} ms, "
              f"{stats['drv_rate']:.1f} / {before['drv_rate']:.1f} decisions/s; "
              f"executor p50 {stats['exec_p50']:.3f} / {before['exec_p50']:.3f} "
              f"ms, p99 {stats['exec_p99']:.3f} / {before['exec_p99']:.3f} ms, "
              f"{stats['exec_rate']:.1f} / {before['exec_rate']:.1f} "
              f"decisions/s; batcher busy {stats['drv_busy']:.2f} / "
              f"{before['drv_busy']:.2f} s (driver stage), "
              f"{stats['exec_busy']:.2f} / {before['exec_busy']:.2f} s "
              f"(executor stage)", flush=True)
    if native:
        print(f"phase {phase}: native ingest {ingest_stats['decode_hits']} "
              f"decodes, hit ratio {ingest_stats['zero_copy_hit_ratio']}, "
              f"{ingest_stats['binary_requests']} binary; decode p50 "
              f"{np.percentile(srv.decode_ns, 50):.0f} ns, p99 "
              f"{np.percentile(srv.decode_ns, 99):.0f} ns; {transport} "
              f"transport: parse mean {transport_stats['parse_mean_ms']} ms, "
              f"queue mean {transport_stats['queue_mean_ms']} ms, write mean "
              f"{transport_stats['write_mean_ms']} ms, keep-alive reuse "
              f"{transport_stats['keepalive_reuse_ratio']} "
              f"({transport_stats['requests_total']} requests on "
              f"{transport_stats['connections_total']} connections); "
              f"tickets whose names the serving path decoded into Python "
              f"strings: "
              + ", ".join(f"{role} {n} of {m}" for role, (n, m) in sorted(decoded.items())),
              flush=True)
    return launches, stats


def replay_server_log(log, config, got, *, ref=None, backend=None,
                      markers=None, label="phase 7", unfinished_ok=False,
                      skip_drains=False):
    """Feed a `cpu` app of the port the recorded changes and windows in
    their order; every answer must equal, byte for byte, the body the
    server sent for that pod (`got`). Returns how many were compared.
    The recorded objects are private copies, so the replay consumes them
    as they are. `ref` and `backend` replace the fresh in-memory app;
    `markers` maps the other ops of the log (a reconcile, a promotion) to
    the call that replays them; with `unfinished_ok` the log may end with
    windows in flight (a leader killed mid-window), which are dropped.
    With `skip_drains` the replay skips every dispatch the server had to
    drain before (a pruned server drains after an escalation, which an
    unpruned app never does) instead of asking the replay to drain there
    too: the server dispatched nothing at that point either."""
    from spark_scheduler_tpu_torch.core.solver import PipelineDrainRequired
    from spark_scheduler_tpu_torch.server.app import build_scheduler_app
    from spark_scheduler_tpu_torch.server.routing import encode_filter_result
    from spark_scheduler_tpu_torch.store.backend import DEMAND_CRD, InMemoryBackend

    if ref is None:
        backend = InMemoryBackend()
        backend.register_crd(DEMAND_CRD)
        ref = build_scheduler_app(backend, config, clock=lambda: EXT_CLOCK,
                                  device="cpu")
    tickets, compared = {}, 0
    for e in log:
        if isinstance(e, tuple):
            getattr(backend, e[1])(*e[2])
            continue
        if e["op"] not in ("dispatch", "fused", "complete"):
            markers[e["op"]](e)
            continue
        if skip_drains and e["op"] in ("dispatch", "fused") and e["drain"]:
            continue
        if e["op"] == "fused":
            try:
                ts = ref.extender.predicate_windows_dispatch(e["args_lists"])
            except PipelineDrainRequired:
                check(e["drain"], "replay drained where the server did not")
                continue
            check(not e["drain"], "the server drained where the replay did not")
            check(len(ts) == len(e["subs"]), "the replay's fused claim split "
                                             "into other windows")
            for sub, t in zip(e["subs"], ts):
                tickets[id(sub)] = t
        elif e["op"] == "dispatch":
            try:
                t = ref.extender.predicate_window_dispatch(e["args"])
            except PipelineDrainRequired:
                check(e["drain"], "replay drained where the server did not")
                continue
            check(not e["drain"], "the server drained where the replay did not")
            tickets[id(e)] = t
        else:
            args = e["dispatch"]["args"]
            res = ref.extender.predicate_window_complete(
                tickets.pop(id(e["dispatch"])))
            for a, r in zip(args, res):
                status, body = got[a.pod.name]
                want = encode_filter_result(r, a.node_names)
                check(status == 200 and body == want,
                      f"{label}: {a.pod.name}: the server answered {body[:160]} "
                      f"where the cpu replay answers {want[:160]}")
                compared += 1
    check(unfinished_ok or not tickets, f"{len(tickets)} windows never completed")
    ref.stop()
    return compared


# ------------------------------------------------------------ phases 9-10

P9_DRIVERS = 128
P9_AFTER = 16  # drivers the restarted server admits beside the executors
P10_DRIVERS = 64  # a stage: r0 serves the first, r1 the second
P10_TTL_S = 1.0
WATCH_WAIT_S = 120.0


def wait_for(cond, what, timeout=WATCH_WAIT_S):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise SmokeFailure(f"timed out after {timeout:.0f} s waiting for {what}")
        time.sleep(0.002)


def apiserver_cluster(n_nodes):
    """Phase 3's nodes (one instance group) and one running prior-usage pod
    of another scheduler per node, as the k8s JSON an apiserver holds."""
    from spark_scheduler_tpu_torch.models.kube import Container, Pod
    from spark_scheduler_tpu_torch.models.resources import Resources
    from spark_scheduler_tpu_torch.server.kube_io import node_to_k8s, pod_to_k8s

    nodes, usage = main_cluster(seed=7)
    nodes, usage = nodes[:n_nodes], usage[:n_nodes]
    born = EXT_CLOCK - 86_400.0
    for node in nodes:
        node.labels[EXT_IG_LABEL] = EXT_IG
        node.creation_timestamp = born
    base = [
        pod_to_k8s(Pod(
            name=f"base-{i:05d}", namespace="other", uid=f"uid-base-{i:05d}",
            scheduler_name="default-scheduler", node_name=node.name,
            phase="Running", creation_timestamp=born,
            containers=[Container(requests=Resources(*map(int, usage[i])))],
        ))
        for i, node in enumerate(nodes)
    ]
    return nodes, [node_to_k8s(n) for n in nodes], base


def bound_json(raw, node):
    import copy

    out = copy.deepcopy(raw)
    out["spec"]["nodeName"] = node
    out["status"]["phase"] = "Running"
    return out


def wait_ingested(api, backend, what):
    """Until the backend holds exactly the apiserver's nodes, and its pods
    with the apiserver's bindings."""
    def same():
        with api._lock:
            want_nodes = set(n for _, n in api.collections["nodes"].objects)
            want_pods = {k: (o.get("spec") or {}).get("nodeName", "")
                         for k, o in api.collections["pods"].objects.items()}
        have_pods = {(p.namespace, p.name): p.node_name for p in backend.list("pods")}
        return (set(n.name for n in backend.list("nodes")) == want_nodes
                and have_pods == want_pods)

    wait_for(same, f"{what}: the backend to hold the apiserver's objects")


def reservations_of(backend):
    """The reservations a backend holds, as wire JSON with the metadata cut
    to what the model interprets: the resourceVersion is a process-local
    counter the WAL replay renumbers, and a replayed record carries its
    ownerReferences as uninterpreted metadata."""
    from spark_scheduler_tpu_torch.server.conversion import rr_v1beta2_to_wire

    out = []
    for rr in backend.list("resourcereservations"):
        wire = rr_v1beta2_to_wire(rr)
        wire["metadata"] = {"name": rr.name, "namespace": rr.namespace,
                            "labels": rr.labels, "annotations": rr.annotations,
                            "owner": rr.owner_pod_uid}
        out.append(json.dumps(wire, sort_keys=True))
    return sorted(out)


def post_jobs(api, srv, names, pods, *, bind, delays):
    """One client job a pod list: create each pod in the apiserver, wait
    until the server's backend has it (the host-clock delays until the
    create reached the backend and until it applied, behind the recorder's
    lock, land in `delays`), post its predicate with every node name, and
    bind it through the apiserver when `bind` and the answer names a
    node."""
    def job(send):
        for raw in pods:
            name = raw["metadata"]["name"]
            t0 = time.perf_counter()
            api.create("pods", json.loads(json.dumps(raw)))
            wait_for(lambda: name in srv.seen, f"pod {name} ingested")
            reached, applied = srv.seen[name]
            delays.append((reached - t0, applied - t0))
            status, data = send("POST", "/predicates",
                                {"Pod": raw, "NodeNames": names})
            res = json.loads(data) if status == 200 else {}
            if bind and res.get("NodeNames"):
                api.update("pods", bound_json(raw, res["NodeNames"][0]))
    return job


def server_checks(srv, phase, on_card, healthy=True):
    """Phase 7's checks on one recorded server: the driver windows equal
    /debug/decisions' dispatch ids, no over-commit, no solo pack off the
    batcher thread, and (`healthy`) no device-fault machinery engaged.
    Returns the log's (done windows, live segments, solo packs)."""
    from spark_scheduler_tpu_torch.testing.harness import overcommit_violations

    status, body = http_get(srv.server.port,
                            "/debug/decisions?role=driver&limit=100000")
    check(status == 200, f"phase {phase}: /debug/decisions {status}")
    by_id: dict = {}
    for d in json.loads(body)["decisions"]:
        if d.get("dispatch_id") is not None:
            by_id.setdefault(d["dispatch_id"], set()).add(d["pod_name"])
    done = [e for e in srv.log if isinstance(e, dict) and e["op"] == "dispatch"
            and not e["drain"] and "ms" in e]
    want = {e["dispatch_id"]: {a.pod.name for a in e["args"]
                               if a.pod.labels.get("spark-role") == "driver"}
            for e in done if e["dispatch_id"] is not None}
    want = {k: v for k, v in want.items() if v}
    check(by_id == want, f"phase {phase}: /debug/decisions windows differ from "
                         "the dispatched ones")
    violations = overcommit_violations(srv.app, srv.backend)
    check(not violations, f"phase {phase} over-commit: {violations[:8]}")
    check(srv.solo_packs["other"] == 0,
          f"phase {phase}: solo packs off the batcher thread: {srv.solo_packs}")
    if healthy:
        fault_free(srv.app.solver, phase)
    segments = sum(e["segments"] for e in done)
    return done, segments, srv.solo_packs["batcher"]


def check_launches(phase, servers, launches, probes, on_card, serial=True):
    """Row-walk launches = the live segments of every dispatched window +
    every solo pack; one probe a solver. With `serial` (one server launches
    at a time) every launch must also fall inside a recorded dispatch or
    completion: a window's before/after reading of the shared count would
    take in another server's launches when two serve at once."""
    for s in servers:
        fault_free(s.app.solver, phase)
    if not on_card:
        return 0, 0
    inside = sum(e["launches"] for s in servers for e in s.log
                 if isinstance(e, dict) and "launches" in e)
    segments = solo = 0
    for s in servers:
        segments += sum(e["segments"] for e in s.log if isinstance(e, dict)
                        and e["op"] == "dispatch" and not e["drain"])
        solo += s.solo_packs["batcher"]
    check(not serial or inside == launches["window"],
          f"phase {phase}: {launches['window']} launches, {inside} inside "
          f"the recorded dispatches and completions")
    check(launches["window"] == segments + solo,
          f"phase {phase}: row-walk launches {launches['window']} != "
          f"{segments} live segments + {solo} solo packs")
    check(launches["probe"] == probes,
          f"phase {phase}: probe launches {launches['probe']} != {probes}")
    return segments, solo


def pctl(xs, q):
    return float(np.percentile(xs, q)) if xs else float("nan")


def run_durable_phase(device, card, n_nodes=N_MAIN, n_drivers=P9_DRIVERS,
                      n_clients=SRV_CLIENTS):
    """Phase 9: the port's server fed by apiserver watch ingestion, with
    the WAL as its store, then restarted on the same WAL (see the module
    docstring). Returns the phase's row-walk and probe launches and what
    phase 10 goes on from (the apiserver, the WAL, the node names)."""
    import copy
    import dataclasses
    import shutil
    import tempfile

    import torch

    from spark_scheduler_tpu_torch.kube.apiserver import FakeKubeAPIServer
    from spark_scheduler_tpu_torch.ops.probe import probe_add_one
    from spark_scheduler_tpu_torch.ops.window import window_pack
    from spark_scheduler_tpu_torch.server.app import build_scheduler_app
    from spark_scheduler_tpu_torch.server.config import InstallConfig
    from spark_scheduler_tpu_torch.store.backend import DEMAND_CRD
    from spark_scheduler_tpu_torch.store.durable import DurableBackend

    on_card = torch.device(device).type == "cuda"
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-wal-")
    wal = os.path.join(tmp, "state.jsonl")
    api = FakeKubeAPIServer()  # listening; it serves once started below
    nodes, node_json, base_json = apiserver_cluster(n_nodes)
    api.create_many("nodes", node_json)
    api.create_many("pods", base_json)
    names = [n.name for n in nodes]
    config = InstallConfig(
        fifo=True, binpack_algo="tightly-pack",
        instance_group_label=EXT_IG_LABEL, sync_writes=True,
        debug_routes=True, kube_api_url=api.base_url, durable_store_path=wal,
    )
    replay_config = dataclasses.replace(config, kube_api_url=None,
                                        durable_store_path=None)
    window_pack.launches = 0
    probe_add_one.launches = 0
    backend = DurableBackend(wal)
    backend.register_crd(DEMAND_CRD)
    srv = RecordedServer(device, config, backend=backend,
                         kinds=("nodes", "pods"))
    port = srv.server.port
    # The reflectors' LIST waits on the apiserver, which is not serving.
    ready0 = http_get(port, "/status/readiness")
    check(ready0[0] == 503, f"phase 9: readiness before the sync: {ready0}")
    t0 = time.perf_counter()
    api.start()
    try:
        wait_for(lambda: srv.app.ingestion.wait_synced(0.01), "the first sync")
        sync_s = time.perf_counter() - t0
        wait_for(srv.server.ready.is_set, "readiness after the sync")
        ready1 = http_get(port, "/status/readiness")
        check(ready1 == (200, b'{"ready": true}'),
              f"phase 9: readiness after the sync: {ready1}")
        check(len(backend.list_nodes()) == n_nodes,
              f"phase 9: {len(backend.list_nodes())} nodes synced")
        print(f"phase 9: server on port {port} ({srv.app.solver.device}, "
              f"threaded transport, WAL store, apiserver ingestion); "
              f"{n_nodes} nodes and {n_nodes} pods listed and applied in "
              f"{sync_s:.3f} s ({card})", flush=True)

        rng = np.random.default_rng(29)
        apps = []
        for i in range(n_drivers):
            n_exec = 32 if rng.random() < 0.15 else int(rng.integers(2, 9))
            apps.append((f"wal-{i:03d}", n_exec, EXT_CLOCK - 500 + i))
        drivers = {a: k8s_spark_pod_json(a, "driver", f"{a}-driver", n, c)
                   for a, n, c in apps}
        delays: list = []

        # A node add and a pod delete land in the apiserver while the third
        # window is in flight; both reach the backend before it completes.
        extra = copy.deepcopy(nodes[0])
        extra.name = f"node-{n_nodes:05d}"
        from spark_scheduler_tpu_torch.server.kube_io import node_to_k8s

        def mid_flight():
            api.delete("pods", "other", "base-00001")
            api.create("nodes", node_to_k8s(extra))
            wait_for(lambda: backend.get_node(extra.name) is not None
                     and backend.get("pods", "other", "base-00001") is None,
                     "the mid-flight changes ingested")

        srv.trigger_at, srv.on_trigger = 3, mid_flight
        t0 = time.perf_counter()
        got, lat_drv = run_clients(port, [post_jobs(
            api, srv, names, [drivers[a]], bind=True, delays=delays)
            for a, _, _ in apps], n_clients)
        drv_s = time.perf_counter() - t0
        names.append(extra.name)
        admitted = []
        for a, n, _ in apps:
            st, data = got[f"{a}-driver"]
            res = json.loads(data)
            check(st == 200 and not res["Error"], f"driver {a}: {st} {data[:200]}")
            if res["NodeNames"]:
                admitted.append((a, n))
        execs = {a: [k8s_spark_pod_json(a, "executor", f"{a}-exec-{k + 1}", n,
                                        EXT_CLOCK - 500)
                     for k in range(n)] for a, n in admitted}
        first = {a: pods[: (len(pods) + 1) // 2] for a, pods in execs.items()}
        rest = {a: pods[(len(pods) + 1) // 2:] for a, pods in execs.items()}
        t0 = time.perf_counter()
        got_exec, lat_exec = run_clients(port, [post_jobs(
            api, srv, names, first[a], bind=True, delays=delays)
            for a, _ in admitted], n_clients)
        exec_s = time.perf_counter() - t0
        got.update(got_exec)
        wait_ingested(api, backend, "phase 9 before the stop")
        done, segments, solo = server_checks(srv, 9, on_card)
        mid = [(e[1], e[3]) for e in srv.log if isinstance(e, tuple)
               and ((e[1] == "delete" and e[2][2] == "base-00001")
                    or (e[1] == "create" and e[2][0] == "nodes"
                        and e[2][1].name == extra.name))]
        check(len(mid) == 2 and all(k >= 1 for _, k in mid),
              f"phase 9: mid-flight changes {mid}")
    except BaseException:
        srv.server.stop()
        api.stop()
        raise

    # The stop: a clean shutdown, then a fresh app on the same WAL and
    # apiserver, which waits for the sync, reconciles, and only then serves.
    srv.server.stop()
    backend.close()
    before = reservations_of(backend)
    wal_bytes = os.path.getsize(wal)
    with open(wal, "rb") as f:
        wal_records = sum(1 for _ in f)
    wal_copy = os.path.join(tmp, "restart-copy.jsonl")
    shutil.copy(wal, wal_copy)
    t0 = time.perf_counter()
    backend2 = DurableBackend(wal)
    backend2.register_crd(DEMAND_CRD)
    srv2 = RecordedServer(device, config, backend=backend2,
                          kinds=("nodes", "pods"), start=False)
    try:
        srv2.app.start_background()
        wait_for(lambda: srv2.app.ingestion.wait_synced(0.01), "the restart sync")
        restart_sync_s = time.perf_counter() - t0
        with srv2.lock:
            r0 = time.perf_counter()
            summary = srv2.app.reconciler.sync_resource_reservations_and_demands()
            reconcile_ms = (time.perf_counter() - r0) * 1e3
            srv2.log.append({"op": "reconcile", "summary": summary})
        after = reservations_of(backend2)
        check(after == before, f"phase 9: {len(after)} reservations after the "
                               f"restart, {len(before)} before, or they differ")
        srv2.server.start()
        reserved = {}
        for rr in srv2.app.rr_cache.list():
            reserved[rr.name] = {r.node for k, r in rr.spec.reservations.items()
                                 if k != "driver"}
        # The rest of the executors, and new drivers, which must see the
        # restored reservations' usage.
        late = [k8s_spark_pod_json(f"wal-r{i:02d}", "driver", f"wal-r{i:02d}-driver",
                                   int(rng.integers(2, 9)), EXT_CLOCK - 300 + i)
                for i in range(P9_AFTER)]
        t0 = time.perf_counter()
        got2, lat2 = run_clients(srv2.server.port, [post_jobs(
            api, srv2, names, rest[a], bind=True, delays=delays)
            for a, _ in admitted if rest[a]] + [post_jobs(
                api, srv2, names, [raw], bind=True, delays=delays)
                for raw in late], n_clients)
        exec2_s = time.perf_counter() - t0
        late_names = {raw["metadata"]["name"] for raw in late}
        # `got2` takes each pod's answer as `lat2` takes its latency, under
        # one lock: their orders agree.
        lat_exec2 = [ms for ms, name in zip(lat2, got2) if name not in late_names]
        late_admitted = sum(bool(json.loads(got2[n][1])["NodeNames"])
                            for n in late_names)
        for a, _ in admitted:
            for raw in rest[a]:
                st, data = got2[raw["metadata"]["name"]]
                res = json.loads(data)
                check(st == 200 and res["NodeNames"]
                      and res["NodeNames"][0] in reserved[a],
                      f"phase 9: executor {raw['metadata']['name']} after the "
                      f"restart: {data[:200]} (reserved {sorted(reserved[a])})")
        wait_ingested(api, backend2, "phase 9 after the restart")
        done2, segments2, solo2 = server_checks(srv2, 9, on_card)
    finally:
        srv2.server.stop()
        backend2.close()
    launches = {"window": window_pack.launches, "probe": probe_add_one.launches}
    check_launches(9, (srv, srv2), launches, 2, on_card)

    # The cpu replays: the first server's record on a fresh app; the
    # restarted server's on a cpu app restarted from a copy of the WAL.
    t0 = time.perf_counter()
    compared = replay_server_log(srv.log, replay_config, got, label="phase 9")
    check(compared == len(got), f"phase 9: compared {compared} of {len(got)}")
    ref_backend = DurableBackend(wal_copy)
    ref_backend.register_crd(DEMAND_CRD)
    ref = build_scheduler_app(ref_backend, replay_config,
                              clock=lambda: EXT_CLOCK, device="cpu")
    ref_summary = {}

    def replay_reconcile(e):
        ref_summary.update(ref.reconciler.sync_resource_reservations_and_demands())
        check(ref_summary == e["summary"],
              f"phase 9: the cpu app reconciles to {ref_summary}, the "
              f"restarted server to {e['summary']}")
        check(reservations_of(ref_backend) == after,
              "phase 9: the cpu app's reservations differ after the reconcile")

    compared2 = replay_server_log(srv2.log, replay_config, got2, ref=ref,
                                  backend=ref_backend, label="phase 9 restart",
                                  markers={"reconcile": replay_reconcile})
    check(ref_summary, "phase 9: the replay never reconciled")
    check(compared2 == len(got2), f"phase 9: compared {compared2} of {len(got2)}")
    ref_backend.close()
    replay_s = time.perf_counter() - t0
    serve_s = time.perf_counter() - t_phase
    n_exec = len(lat_exec) + len(lat_exec2)
    reach = [r for r, _ in delays]
    applied = [a for _, a in delays]
    print(f"phase 9: {n_drivers} driver pods created in the apiserver and "
          f"their predicates posted by {n_clients} client threads "
          f"({len(admitted)} admitted and bound through the apiserver), then "
          f"{len(lat_exec)} executors; a node add and a pod delete with "
          f"{mid[0][1]} and {mid[1][1]} windows in flight; stop, restart on "
          f"the same WAL: {len(after)} reservations restored, equal to the "
          f"{len(before)} before the stop; reconcile {summary}; then "
          f"{len(lat_exec2)} executors, each on its app's reserved nodes, "
          f"and {P9_AFTER} new drivers ({late_admitted} admitted); "
          f"responses byte-identical to cpu replays ({compared} + {compared2} "
          f"compared, the second on a cpu app restarted from a copy of the "
          f"WAL, replays {replay_s:.1f} s); over-commit none", flush=True)
    print(f"phase 9 ({card}): sync of {n_nodes} nodes + {n_nodes} pods "
          f"{sync_s:.3f} s, restart (WAL replay + compaction + sync) "
          f"{restart_sync_s:.3f} s; informer delay (apiserver create -> "
          f"backend, host clock, {len(delays)} pods) p50 "
          f"{pctl(reach, 50) * 1e3:.3f} ms p99 {pctl(reach, 99) * 1e3:.3f} ms, "
          f"applied behind the recorder's lock p50 {pctl(applied, 50) * 1e3:.3f} "
          f"ms p99 {pctl(applied, 99) * 1e3:.3f} ms; "
          f"WAL at the stop {wal_records} records, {wal_bytes} bytes; "
          f"reconcile {reconcile_ms:.3f} ms; driver /predicates p50 "
          f"{pctl(lat_drv, 50):.3f} ms p99 {pctl(lat_drv, 99):.3f} ms "
          f"({n_drivers / drv_s:.1f} decisions/s); executor p50 "
          f"{pctl(lat_exec + lat_exec2, 50):.3f} ms p99 "
          f"{pctl(lat_exec + lat_exec2, 99):.3f} ms ({n_exec} in "
          f"{exec_s + exec2_s:.2f} s); row-walk launches {launches['window']} "
          f"= {segments + segments2} live segments + {solo + solo2} solo "
          f"packs; probe {launches['probe']}; {len(done) + len(done2)} "
          f"windows; phase {serve_s:.1f} s", flush=True)
    ctx = {"api": api, "wal": wal, "tmp": tmp, "names": names,
           "apps": len(admitted)}
    return launches, ctx


def failover_clients(ports, jobs, n_clients, dead):
    """Stage B of phase 10: job i on thread i % n_clients, each thread on
    one keep-alive connection to r0 and one to r1. A job posts its
    predicate to r0; an answer r0 gave after its kill (its pod is in
    `dead`) is a dead process's answer, which a client never receives, so
    the job posts again to r1. Returns r0's and r1's answers by pod name,
    r1's latencies in ms, and the host clock of each r1 200."""
    import http.client
    import socket
    import threading

    r0_out, r1_out, lat, oks, errors = {}, {}, [], [], []
    mu = threading.Lock()

    def worker(k):
        conns = {}
        for role, port in ports.items():
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
            conn.connect()
            conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conns[role] = conn

        def post(role, payload):
            t0 = time.perf_counter()
            conns[role].request("POST", "/predicates",
                                body=json.dumps(payload).encode(),
                                headers={"Content-Type": "application/json"})
            resp = conns[role].getresponse()
            data = resp.read()
            return resp.status, data, t0, time.perf_counter()

        try:
            for job in jobs[k::n_clients]:
                payload = job()
                name = payload["Pod"]["metadata"]["name"]
                answer = post("r0", payload)
                with mu:
                    r0_out[name] = answer[:2]
                if name not in dead:
                    continue
                status, data, t0, t1 = post("r1", payload)
                with mu:
                    r1_out[name] = (status, data)
                    lat.append((t1 - t0) * 1e3)
                    if status == 200:
                        oks.append(t1)
        except Exception as exc:  # surfaced below
            with mu:
                errors.append(repr(exc))
        finally:
            for conn in conns.values():
                conn.close()

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    check(not errors, f"phase 10 client errors: {errors[:4]}")
    return r0_out, r1_out, lat, oks


def run_failover_phase(device, card, ctx, n_drivers=P10_DRIVERS,
                       n_clients=SRV_CLIENTS, ttl=P10_TTL_S):
    """Phase 10: two HA replicas of the port on the card over phase 9's WAL
    and apiserver; the leader is killed with a window in flight and the
    standby takes over (see the module docstring). Returns the phase's
    row-walk and probe launches."""
    import dataclasses
    import shutil

    import torch

    from spark_scheduler_tpu_torch.ha import FileLeaseStore, LeaseManager
    from spark_scheduler_tpu_torch.ha.replica import build_replica
    from spark_scheduler_tpu_torch.ops.probe import probe_add_one
    from spark_scheduler_tpu_torch.ops.window import window_pack
    from spark_scheduler_tpu_torch.server.config import InstallConfig
    from spark_scheduler_tpu_torch.store.backend import DEMAND_CRD
    from spark_scheduler_tpu_torch.store.durable import DurableBackend
    from spark_scheduler_tpu_torch.testing.harness import overcommit_violations

    on_card = torch.device(device).type == "cuda"
    t_phase = time.perf_counter()
    api, wal, tmp, names = ctx["api"], ctx["wal"], ctx["tmp"], ctx["names"]
    heartbeat = ttl / 3.0
    config = InstallConfig(
        fifo=True, binpack_algo="tightly-pack",
        instance_group_label=EXT_IG_LABEL, sync_writes=True,
        debug_routes=True, kube_api_url=api.base_url, durable_store_path=wal,
        ha_enabled=True, ha_lease_ttl_s=ttl, ha_heartbeat_s=heartbeat,
    )
    replay_config = dataclasses.replace(config, kube_api_url=None,
                                        durable_store_path=None)
    start_copy = os.path.join(tmp, "failover-start.jsonl")
    kill_copy = os.path.join(tmp, "failover-kill.jsonl")
    shutil.copy(wal, start_copy)
    window_pack.launches = 0
    probe_add_one.launches = 0
    reps, summaries = {}, {}
    for rid in ("r0", "r1"):
        backend = DurableBackend(wal, follow=True)
        backend.register_crd(DEMAND_CRD)
        lease = LeaseManager(FileLeaseStore(wal + ".lease"), rid, ttl_s=ttl)

        def factory(backend, registry, metrics, rid=rid, lease=lease):
            runtime = build_replica(
                backend, rid, config=dataclasses.replace(config, ha_replica_id=rid),
                lease=lease, metrics=metrics, registry=registry,
                clock=lambda: EXT_CLOCK, device=device,
            )
            return runtime.app, runtime

        reps[rid] = RecordedServer(device, config, backend=backend,
                                   kinds=("nodes", "pods"), app_factory=factory,
                                   start=False)
    r0, r1 = reps["r0"], reps["r1"]
    for rid, srv in reps.items():
        promote = srv.runtime.promote

        def recorded_promote(srv=srv, promote=promote, rid=rid):
            # The promotion reconciles; the replay repeats it at this point.
            with srv.lock:
                out = promote()
                summaries[rid] = out
                srv.log.append({"op": "promote", "summary": out})
            return out

        srv.runtime.promote = recorded_promote
    try:
        for srv in (r0, r1):
            srv.app.start_background()
        for srv in (r0, r1):
            wait_for(lambda srv=srv: srv.app.ingestion.wait_synced(0.01),
                     "a replica's sync")
        # As the CLI does: after the sync, one election tick, then serve.
        check(r0.runtime.run_election_once() == "leader", "r0 did not lead")
        r0.server.start()
        check(r1.runtime.run_election_once() == "standby", "r1 did not stand by")
        r1.server.start()
        ready = {rid: http_get(s.server.port, "/status/readiness")
                 for rid, s in reps.items()}
        check(ready == {"r0": (200, b'{"ready": true, "role": "leader"}'),
                        "r1": (503, b'{"ready": false, "role": "standby"}')},
              f"phase 10: readiness before the kill: {ready}")
        print(f"phase 10: replicas r0 (leader) and r1 (standby) on ports "
              f"{r0.server.port} and {r1.server.port} "
              f"({r0.app.solver.device}), one WAL (follower mode until "
              f"promoted), lease {wal}.lease with TTL {ttl} s, heartbeat "
              f"{heartbeat:.3f} s ({card})", flush=True)

        rng = np.random.default_rng(31)

        def stage(tag, k):
            out = []
            for i in range(k):
                n_exec = 32 if rng.random() < 0.15 else int(rng.integers(2, 9))
                a = f"{tag}-{i:03d}"
                out.append((a, n_exec, k8s_spark_pod_json(
                    a, "driver", f"{a}-driver", n_exec, EXT_CLOCK - 400 + i)))
            return out

        delays: list = []
        stage_a = stage("ha-a", n_drivers)
        t0 = time.perf_counter()
        got_a, lat_a = run_clients(r0.server.port, [post_jobs(
            api, r0, names, [raw], bind=True, delays=delays)
            for _, _, raw in stage_a], n_clients)
        a_s = time.perf_counter() - t0
        for srv in (r0, r1):
            wait_ingested(api, srv.backend, "phase 10 after stage A")
        check(r1.runtime.role == "standby" and r0.runtime.role == "leader",
              f"phase 10: roles moved during stage A: r0 {r0.runtime.role}, "
              f"r1 {r1.runtime.role}")
        admitted = [(a, n) for a, n, raw in stage_a
                    if json.loads(got_a[raw["metadata"]["name"]][1])["NodeNames"]]

        # Stage B: the drivers exist in the apiserver and in both replicas
        # before the first is posted, so the WAL at the kill holds them.
        stage_b = stage("ha-b", n_drivers)
        for _, _, raw in stage_b:
            api.create("pods", json.loads(json.dumps(raw)))
        for srv in (r0, r1):
            wait_ingested(api, srv.backend, "phase 10 before the kill")
        dead: set = set()
        kill = {}

        def kill_r0():
            # On r0's dispatcher thread, its first stage-B window in flight.
            kill["at"] = time.perf_counter()
            r0.runtime.kill()
            r0.app.ingestion.stop()  # a dead process ingests nothing
            with r0.lock:
                kill["mark"] = len(r0.log)
            shutil.copy(wal, kill_copy)
            wait_for(lambda: r1.runtime.role == "leader", "r1's promotion",
                     timeout=ttl + heartbeat + 60.0)
            kill["leader_at"] = time.perf_counter()
            kill["r1_state"] = sorted((p.namespace, p.name, p.node_name)
                                      for p in r1.backend.list("pods"))
            kill["ready"] = {rid: http_get(s.server.port, "/status/readiness")
                             for rid, s in reps.items()}

        r0.trigger_at, r0.on_trigger = r0.counts["dispatched"] + 1, kill_r0
        complete = r0.app.extender.predicate_window_complete

        def complete_marking(t):
            out = complete(t)
            if "at" in kill:
                dead.update(a.pod.name for a in t.args_list)
            return out

        r0.app.extender.predicate_window_complete = complete_marking
        t0 = time.perf_counter()
        r0_b, got_b, lat_b, oks = failover_clients(
            {"r0": r0.server.port, "r1": r1.server.port},
            [lambda raw=raw: {"Pod": raw, "NodeNames": names}
             for _, _, raw in stage_b], n_clients, dead)
        b_s = time.perf_counter() - t0
        check("at" in kill, "phase 10: the kill never ran")
        check(set(r0_b) == dead == set(got_b),
              f"phase 10: {len(r0_b)} stage-B answers from r0, {len(dead)} "
              f"after the kill, {len(got_b)} posted again to r1")
        takeover_s = kill["leader_at"] - kill["at"]
        promotion_ms = r1.runtime.last_promotion_ms
        check(takeover_s <= ttl + heartbeat + promotion_ms / 1e3 + 0.05,
              f"phase 10: r1 led {takeover_s:.3f} s after the kill, beyond "
              f"TTL + one heartbeat + its promotion")
        check(kill["ready"] == {
            "r0": (503, b'{"ready": false, "role": "leader"}'),
            "r1": (200, b'{"ready": true, "role": "leader"}')},
            f"phase 10: readiness after the takeover: {kill['ready']}")
        status, body = http_get(r1.server.port, "/debug/ha")
        ha_state = json.loads(body)
        check(status == 200 and ha_state["role"] == "leader"
              and ha_state["lease"]["lease_epoch"]
              == r0.runtime.lease.acquired_epoch + 1,
              f"phase 10: r1's /debug/ha {status} {body[:300]}")
        fenced = r0.runtime.lease.fenced_rejects
        for a, n, raw in stage_b:
            res = json.loads(got_b[raw["metadata"]["name"]][1])
            if res["NodeNames"]:
                api.update("pods", bound_json(raw, res["NodeNames"][0]))
                admitted.append((a, n))

        # Every admitted app's executors, on r1.
        jobs = [post_jobs(api, r1, names, [
            k8s_spark_pod_json(a, "executor", f"{a}-exec-{k + 1}", n,
                               EXT_CLOCK - 400) for k in range(n)],
            bind=True, delays=delays) for a, n in admitted]
        t0 = time.perf_counter()
        got_x, lat_x = run_clients(r1.server.port, jobs, n_clients)
        x_s = time.perf_counter() - t0
        got_b.update(got_x)
        wait_ingested(api, r1.backend, "phase 10 at the end")
        done1, segments1, solo1 = server_checks(r1, 10, on_card)
        violations = overcommit_violations(r1.app, r1.backend)
        check(not violations, f"phase 10 over-commit: {violations[:8]}")
    finally:
        for srv in (r1, r0):
            srv.server.stop()
            srv.backend.close()
        api.stop()
    launches = {"window": window_pack.launches, "probe": probe_add_one.launches}
    # The killed leader's late windows run beside the new leader's.
    segments, solo = check_launches(10, (r0, r1), launches, 2, on_card,
                                    serial=False)

    # Exactly one reservation in the WAL for every admitted driver.
    final = DurableBackend(wal, compact_on_load=False)
    by_app: dict = {}
    for rr in final.list("resourcereservations"):
        by_app.setdefault(rr.name, []).append(rr)
    final.close()
    for a, _ in admitted:
        rrs = by_app.get(a, [])
        check(len(rrs) == 1 and rrs[0].status.pods.get("driver") == f"{a}-driver",
              f"phase 10: app {a} has {len(rrs)} reservations in the WAL")
    ours = {a for a in by_app if a.startswith("ha-")}
    check(ours == {a for a, _ in admitted},
          f"phase 10: reservations {len(ours)} for {len(admitted)} admitted apps")

    # The cpu replays: r0's term on a cpu replica promoted from the WAL as
    # phase 10 found it, r1's on one promoted from the WAL at the kill.
    def cpu_replica(path, rid):
        backend = DurableBackend(path, follow=True)
        backend.register_crd(DEMAND_CRD)
        lease = LeaseManager(FileLeaseStore(path + ".lease"), rid, ttl_s=3600.0)
        runtime = build_replica(backend, rid, config=replay_config, lease=lease,
                                clock=lambda: EXT_CLOCK, device="cpu")
        return backend, runtime

    def promoted(runtime, rid):
        def replay_promote(e):
            check(runtime.lease.try_acquire(), f"the cpu {rid} lost the lease")
            got_summary = runtime.promote()
            check(got_summary == e["summary"],
                  f"phase 10: the cpu replica of {rid} reconciles to "
                  f"{got_summary}, {rid} on the card to {e['summary']}")
        return replay_promote

    t0 = time.perf_counter()
    b0, rep0 = cpu_replica(start_copy, "r0")
    compared0 = replay_server_log(
        r0.log[: kill["mark"]], replay_config, got_a, ref=rep0.app, backend=b0,
        label="phase 10 r0", markers={"promote": promoted(rep0, "r0")},
        unfinished_ok=True)
    check(compared0 == len(got_a), f"phase 10: compared {compared0} of "
                                   f"{len(got_a)} r0 answers")
    b0.close()
    b1, rep1 = cpu_replica(kill_copy, "r1")
    state = sorted((p.namespace, p.name, p.node_name) for p in b1.list("pods"))
    check(state == kill["r1_state"],
          "phase 10: r1's pods at its promotion differ from the WAL at the kill")
    mark = next(i for i, e in enumerate(r1.log)
                if isinstance(e, dict) and e["op"] == "promote")
    compared1 = replay_server_log(
        r1.log[mark:], replay_config, got_b, ref=rep1.app, backend=b1,
        label="phase 10 r1", markers={"promote": promoted(rep1, "r1")})
    check(compared1 == len(got_b), f"phase 10: compared {compared1} of "
                                   f"{len(got_b)} r1 answers")
    b1.close()
    replay_s = time.perf_counter() - t0
    shutil.rmtree(tmp, ignore_errors=True)
    serve_s = time.perf_counter() - t_phase
    first_ok = min(oks) - kill["at"] if oks else float("nan")
    print(f"phase 10: r0 served {n_drivers} drivers ({len(got_a)} answers); "
          f"killed with a window in flight; r1 took over "
          f"{takeover_s * 1e3:.3f} ms after the kill (TTL {ttl * 1e3:.0f} ms + "
          f"heartbeat {heartbeat * 1e3:.0f} ms), reconciled "
          f"{summaries['r1']}; r0's {len(dead)} answers after the kill "
          f"dropped ({fenced} fenced write attempts) and posted again to "
          f"r1; r1 then served {len(lat_b)} drivers and {len(lat_x)} "
          f"executors; {len(admitted)} admitted apps, one reservation each in "
          f"the WAL; readiness 200/503 by role before and after; responses "
          f"byte-identical to cpu replicas promoted from copies of the WAL "
          f"({compared0} + {compared1} compared, same reconcile summaries, "
          f"replays {replay_s:.1f} s); over-commit none", flush=True)
    print(f"phase 10 ({card}): promotion {promotion_ms:.3f} ms (reconcile "
          f"{r1.runtime.last_reconcile_ms:.3f} ms); kill -> r1's first 200 "
          f"{first_ok * 1e3:.3f} ms; r0 driver p50 {pctl(lat_a, 50):.3f} ms "
          f"p99 {pctl(lat_a, 99):.3f} ms ({n_drivers / a_s:.1f}/s); r1 driver "
          f"p50 {pctl(lat_b, 50):.3f} ms p99 {pctl(lat_b, 99):.3f} ms (stage "
          f"{b_s:.2f} s); r1 executor p50 {pctl(lat_x, 50):.3f} ms p99 "
          f"{pctl(lat_x, 99):.3f} ms ({len(lat_x)} in {x_s:.2f} s); row-walk "
          f"launches {launches['window']} = {segments} live segments (r0's "
          f"and r1's) + {solo} solo packs; probe {launches['probe']}; phase "
          f"{serve_s:.1f} s", flush=True)
    return launches


# --------------------------------------------------------------- phase 11

FUSE_WINDOWS = 4
FUSE_MAX_WINDOW = 8  # phase 7's 32 clients then back up past one window


def segmented_to_app_batch(win):
    """The flat window-mode AppBatch of a SegmentedWindow: each live
    segment's rows in order, `reset` on its first row, `commit` on its
    last, the segment's masks on every row. Returns (batch, [(s, r)])."""
    from spark_scheduler_tpu_torch.ops.batched import make_app_batch

    pos = [(s, r) for s in range(len(win.row_count))
           for r in range(int(win.row_count[s]))]
    si = np.asarray([s for s, _ in pos])
    ri = np.asarray([r for _, r in pos])
    reset = ri == 0
    commit = ri == win.row_count[si] - 1
    return make_app_batch(
        win.driver_req[si, ri], win.exec_req[si, ri], win.exec_count[si, ri],
        skippable=win.skippable[si, ri], driver_cand=win.driver_cand[si],
        domain=win.domain[si], commit=commit, reset=reset,
    ), (si, ri)


def timed_ms(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def run_engine_phase(device, card, last):
    """Phase 11's checks below the server, on the card: the fused K = 4
    dispatch against four back-to-back dispatches on the same state, and
    the batched engine (`batched_fifo_pack`, plain PyTorch on CUDA tensors)
    against the row walk on a phase-3 window and against the queue kernel
    on a config-5 queue. The row-walk and queue-kernel launches here are
    comparisons and count toward no kernel's main-path launches."""
    import torch

    from spark_scheduler_tpu_torch.core.solver import (
        FusedWindowView,
        PlacementSolver,
    )
    from spark_scheduler_tpu_torch.models.cluster import cluster_from_numpy
    from spark_scheduler_tpu_torch.ops.batched import (
        app_batch_to_device,
        batched_fifo_pack,
    )
    from spark_scheduler_tpu_torch.ops.fifo import fifo_pack
    from spark_scheduler_tpu_torch.ops.window import window_pack

    saved = (window_pack.launches, fifo_pack.launches)
    # The solver: K = 4 fused against four sequential dispatches.
    nodes, usage = main_cluster(seed=7)
    names = [nd.name for nd in nodes]
    zone_names = [names[z::4] for z in range(4)]
    rng = np.random.default_rng(31)
    windows = [main_window(rng, names, zone_names) for _ in range(FUSE_WINDOWS)]
    seq_solver = PlacementSolver(device=device)
    fused_solver = PlacementSolver(device=device)

    def sequential():
        # Each dispatch's pipelined build threads the base the previous
        # window left on the card (no change lands between them).
        handles = [
            seq_solver.pack_window_dispatch(
                "tightly-pack",
                seq_solver.build_tensors_pipelined(nodes, usage, {}), w)
            for w in windows
        ]
        return [d for h in handles for d in seq_solver.pack_window_fetch(h)]

    want, seq_ms = timed_ms(sequential)
    tf = fused_solver.build_tensors_pipelined(nodes, usage, {})
    before = window_pack.launches

    def fused():
        views = fused_solver.pack_windows_dispatch("tightly-pack", tf, windows)
        check(all(isinstance(v, FusedWindowView) for v in views)
              and len({v.dispatch_id for v in views}) == 1,
              "phase 11: the fused dispatch returned no single-dispatch views")
        return [d for v in views for d in fused_solver.pack_window_fetch(v)]

    got, fused_ms = timed_ms(fused)
    fused_launches = window_pack.launches - before
    segments = sum(len(w) for w in windows)
    check(got == want, "phase 11: the fused K = 4 dispatch differs from four "
                       "sequential dispatches")
    check(fused_launches == segments or torch.device(device).type != "cuda",
          f"phase 11: fused dispatch launched {fused_launches} row walks for "
          f"{segments} segments")
    admitted = sum(d.admitted for d in got)
    print(f"phase 11: pack_windows_dispatch of K = {FUSE_WINDOWS} windows "
          f"({segments} segments) on the card equals {FUSE_WINDOWS} "
          f"back-to-back pack_window_dispatch calls ({admitted} admitted); "
          f"{fused_launches} row-walk launches; fused {fused_ms:.2f} ms, "
          f"sequential {seq_ms:.2f} ms, host clock ({card})", flush=True)

    # The engine against the row walk: one phase-3 window, window mode.
    cluster, batch = last
    apps, (si, ri) = segmented_to_app_batch(batch.win)
    kw = dict(fill="tightly-pack", emax=batch.emax, num_zones=batch.num_zones)
    (meta, execs, base), walk_ms = timed_ms(
        lambda: window_pack(cluster, batch.win, **kw))
    eng, eng_ms = timed_ms(lambda: batched_fifo_pack(
        cluster, app_batch_to_device(apps, device), **kw))
    meta, execs = meta.cpu().numpy(), execs.cpu().numpy()
    rows = len(si)
    same = (
        np.array_equal(eng.driver_node.cpu().numpy(), meta[si, ri, 0])
        and np.array_equal(eng.admitted.cpu().numpy()[:rows], meta[si, ri, 1] == 1)
        and np.array_equal(eng.packed.cpu().numpy()[:rows], meta[si, ri, 2] == 1)
        and np.array_equal(eng.executor_nodes.cpu().numpy(), execs[si, ri])
        and torch.equal(eng.available_after, base)
    )
    check(same, "phase 11: batched_fifo_pack (window mode) on the card differs "
                "from the row walk's window_pack")
    print(f"phase 11: batched_fifo_pack, window mode, on a phase-3 window "
          f"({int((batch.win.row_count > 0).sum())} segments, {rows} rows, "
          f"N {cluster.num_nodes}) equals window_pack: {eng_ms:.1f} ms against "
          f"the row walk's {walk_ms:.1f} ms, host clock ({card})", flush=True)

    # The engine against the queue kernel: one config-5 queue, queue mode.
    rng = np.random.default_rng(CONFIG_SEEDS["config5"])
    c5 = cluster_from_numpy(baseline_cluster(rng, 10_000), device=device)
    q = app_batch_to_device(baseline_batches(rng, 100, 100, 8)[0], device)
    kw = dict(fill="tightly-pack", emax=8, num_zones=4)
    want_q, kernel_ms = timed_ms(lambda: fifo_pack(c5, q, **kw))
    got_q, eng_q_ms = timed_ms(lambda: batched_fifo_pack(c5, q, **kw))
    err = packing_diff(got_q, want_q)
    check(err == 0, "phase 11: batched_fifo_pack (queue mode) on the card "
                    "differs from fifo_pack")
    print(f"phase 11: batched_fifo_pack, queue mode, on a config-5 queue "
          f"(10,000 nodes, 100 apps, {int(got_q.admitted.sum())} admitted) "
          f"equals fifo_pack: {eng_q_ms:.1f} ms against the queue kernel's "
          f"{kernel_ms:.2f} ms, host clock ({card})", flush=True)
    window_pack.launches, fifo_pack.launches = saved
    fault_free(seq_solver, 11)
    fault_free(fused_solver, 11)


# --------------------------------------------------------------- phase 12

PRUNE_TOP_K = 64
PRUNE_SLACK = 2.0
PRUNE_WINDOWS = 16
PRUNE_WINDOW = 8  # requests a window: phase 11's predicate-max-window
PRUNE_MIN_PRUNED = 12  # of the 16 solver-level windows, on the card
PRUNE_TIGHT = (8, 0.25, 4)  # top-k, slack, windows of the tight arm
PRUNE_CLIENTS = 4  # a server window then holds ~16 rows: it prunes
PRUNE_DRIVERS = 128
PRUNE_BIG_NODES = 100_000
# A warm-up pair and a profiled pair, then 8 timed pairs for the median.
PRUNE_BIG_WINDOWS = 20
PRUNE_BIG_WINDOW = 32


def prune_window(rng, names, n_requests):
    """`n_requests` tightly-pack requests shaped as phase 7's apps (a
    1 CPU / 2 Gi driver, executors of 2 CPU / 4 Gi, gangs of 2-8 executors,
    ~15% 32 wide, every node a driver candidate), each with 0-1
    FIFO-earlier pending drivers."""
    from spark_scheduler_tpu_torch.core.solver import WindowRequest
    from spark_scheduler_tpu_torch.models.resources import Resources

    driver = Resources.from_quantities("1", "2Gi")
    executor = Resources.from_quantities("2", "4Gi")

    def app(skippable):
        count = 32 if rng.random() < 0.15 else int(rng.integers(2, 9))
        return (driver, executor, count, skippable)

    requests = []
    for _ in range(n_requests):
        rows = [app(bool(rng.random() < 0.3))
                for _ in range(int(rng.integers(0, 2)))]
        rows.append(app(False))
        requests.append(WindowRequest(rows=rows, driver_candidate_names=names))
    return requests


def prune_churn(rng, nodes, usage, step):
    """The churn between two pairs of windows: 64 nodes' usage changes,
    one node is added, and one node's zone label moves (an availability
    delta and a static row delta of the pipelined build). Returns the new
    (nodes, usage)."""
    import copy

    from spark_scheduler_tpu_torch.models.kube import ZONE_LABEL

    n = len(nodes)
    usage = usage.copy()
    rows = rng.choice(n, size=64, replace=False)
    usage[rows, 0] = np.maximum(usage[rows, 0] + rng.integers(-4000, 4000, 64), 0)
    usage[rows, 1] = np.maximum(
        usage[rows, 1] + (rng.integers(-8, 8, 64) << 20), 0)
    added = copy.deepcopy(nodes[int(rng.integers(0, n))])
    added.name = f"node-add-{step:03d}"
    added.labels = {**added.labels, ZONE_LABEL: f"zone-{step % 4}"}
    i = int(rng.integers(0, n))
    moved = copy.deepcopy(nodes[i])
    zone = int(moved.labels[ZONE_LABEL].rsplit("-", 1)[1])
    moved.labels = {**moved.labels, ZONE_LABEL: f"zone-{(zone + 1) % 4}"}
    nodes = nodes[:i] + [moved] + nodes[i + 1:] + [added]
    usage = np.vstack([usage, np.zeros((1, 3), usage.dtype)])
    return nodes, usage


def prune_pair(solver, nodes, usage, windows, fused):
    """Two windows: two pipelined dispatches back to back (the second's
    build sees the first in flight, so it has a prior) or one fused K = 2
    dispatch; then both fetched. Returns (decisions per window, the
    dispatches' handles)."""
    if fused:
        t = solver.build_tensors_pipelined(nodes, usage, {})
        views = solver.pack_windows_dispatch("tightly-pack", t, windows)
        return [solver.pack_window_fetch(v) for v in views], [views[0].owner]
    handles = []
    for w in windows:
        t = solver.build_tensors_pipelined(nodes, usage, {})
        handles.append(solver.pack_window_dispatch("tightly-pack", t, w))
    return [solver.pack_window_fetch(h) for h in handles], handles


def profiled(fn):
    """(fn's result, wall ms ending in a synchronise, row-walk device ms,
    other device ms) of one call under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernel = other = 0.0
    for evt in prof.events():
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            us = evt.time_range.elapsed_us()
            if "window_row_walk" in evt.name:
                kernel += us
            else:
                other += us
    return out, wall, kernel / 1e3, other / 1e3


def dispatch_segments(handle) -> int:
    """Row-walk launches a dispatch makes on the card: one a live segment,
    and again for each live segment of a full re-solve."""
    live = len(handle.requests)
    resolved = (handle.info or {}).get("resolved")
    return live + (resolved["segments"] if resolved else 0)


def run_prune_arm(device, card, label, nodes, usage, windows, *, fused,
                  top_k, slack, churn_seed, with_cpu=True, profile_pair=1):
    """One arm of phase 12 at the solver level: a `cuda` solver with
    pruning, a `cuda` solver without, and (`with_cpu`) a `cpu` solver
    with pruning, fed the same windows in pairs with churn between pairs,
    in lockstep; every WindowDecision must be equal across them. Pair 0
    warms up (the planner's cold sync, each solver's first full upload and
    probe) and pair `profile_pair` (None: none) runs under torch.profiler;
    neither is timed. Returns the arm's figures; the pruned cuda solver's
    row-walk and probe launches are the main path's, the unpruned
    solver's a comparison."""
    import torch

    from spark_scheduler_tpu_torch.core.solver import PlacementSolver
    from spark_scheduler_tpu_torch.ops.probe import probe_add_one
    from spark_scheduler_tpu_torch.ops.window import window_pack

    on_card = torch.device(device).type == "cuda"
    solvers = {
        "pruned": PlacementSolver(device=device, prune_top_k=top_k,
                                  prune_slack=slack),
        "full": PlacementSolver(device=device),
    }
    if with_cpu:
        solvers["cpu"] = PlacementSolver(device="cpu", prune_top_k=top_k,
                                         prune_slack=slack)
    rng = np.random.default_rng(churn_seed)
    usage = usage.copy()
    times = {"pruned": [], "full": []}
    launches = {"pruned": 0, "full": 0}
    probes = {"pruned": 0, "full": 0}
    prof, handles, rows = {}, [], []
    for i in range(0, len(windows), 2):
        pair = i // 2
        if pair:
            nodes, usage = prune_churn(rng, nodes, usage, pair)
        wins = windows[i:i + 2]
        got = {}
        for name, solver in solvers.items():
            def go(solver=solver):
                return prune_pair(solver, nodes, usage, wins, fused)

            before = window_pack.launches
            probes_before = probe_add_one.launches
            if on_card and name != "cpu" and pair == profile_pair:
                out, ms, kern, other = profiled(go)
                prof[name] = (ms, kern, other)
            else:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = go()
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                if name != "cpu" and pair > 0:
                    times[name].append(ms / len(wins))
            if name != "cpu":
                launches[name] += window_pack.launches - before
                probes[name] += probe_add_one.launches - probes_before
            got[name] = out
        decisions, pair_handles = got["pruned"]
        for name in solvers:
            check(got[name][0] == decisions,
                  f"phase 12 {label}: window pair {pair}: the {name} solver's "
                  f"decisions differ from the pruned cuda solver's")
        handles += pair_handles
        rows.append(sum(sum(len(r.rows) for r in w) for w in wins))
        for w, d in zip(wins, decisions):
            commit(usage, solvers["pruned"].registry, w, d)
    for solver in solvers.values():
        fault_free(solver, 12)
    pruned = solvers["pruned"]
    st = pruned.prune_stats
    if with_cpu:
        want = {k: solvers["cpu"].prune_stats[k]
                for k in ("windows", "kept_rows", "escalations", "reasons")}
        check({k: st[k] for k in want} == want,
              f"phase 12 {label}: the cpu solver's prune_stats {want} differ "
              f"from the card's {st}")
    want_launches = sum(dispatch_segments(h) for h in handles)
    if on_card:
        check(launches["pruned"] == want_launches,
              f"phase 12 {label}: {launches['pruned']} row-walk launches on the "
              f"pruned solver for {want_launches} live segments (pruned, "
              f"declined and re-solved)")
    n_pruned = sum(h.prune is not None for h in handles)
    resolved = [h for h in handles if (h.info or {}).get("resolved")]
    out = dict(
        label=label, windows=len(windows), dispatches=len(handles),
        pruned_dispatches=n_pruned, prune_windows=st["windows"],
        kept_rows=st["kept_rows"], candidate_rows=st["candidate_rows"],
        escalations=st["escalations"], reasons=dict(st["reasons"]),
        resolved=len(resolved), launches=launches, want_launches=want_launches,
        probes=probes, times=times, prof=prof, rows=rows,
        n=pruned.registry.capacity, build=build_block(pruned),
    )
    kept = st["kept_rows"] / max(st["windows"], 1)
    cand = st["candidate_rows"] / max(st["windows"], 1)
    print(f"phase 12 {label} ({card}): {len(windows)} windows of "
          f"{len(windows[0])} requests in {len(handles)} dispatches "
          f"({'fused K = 2' if fused else 'pipelined pairs'}), {n_pruned} "
          f"pruned, {len(handles) - n_pruned} declined by the planner; kept "
          f"rows {kept:.1f} a pruned dispatch of {cand:.1f} candidate rows; "
          f"escalations {st['escalations']} {dict(st['reasons'])}, "
          f"{len(resolved)} dispatches re-solved in full; row-walk launches "
          f"{launches['pruned']} = {want_launches} live segments (unpruned "
          f"solver: {launches['full']}); decisions equal across "
          f"{', '.join(solvers)}; host planning means plan "
          f"{st['plan_ms'] / max(st['windows'], 1):.4f} / gather "
          f"{st['gather_ms'] / max(st['windows'], 1):.4f} / offset "
          f"{st['offset_ms'] / max(st['windows'], 1):.4f} ms a pruned "
          f"dispatch, planner rows cold {st['planner_cold_rows']} scanned "
          f"{st['planner_rows_scanned']}", flush=True)
    if times["pruned"]:
        p50 = {k: float(np.percentile(v, 50)) for k, v in times.items()}
        line = (f"phase 12 {label} ({card}): window p50 pruned "
                f"{p50['pruned']:.3f} ms against unpruned {p50['full']:.3f} ms "
                f"(host clock ending in a synchronise, {len(times['pruned'])} "
                f"timed pairs after a warm-up pair, the profiled pair "
                f"untimed)")
        for name in ("pruned", "full"):
            if name in prof:
                ms, kern, other = prof[name]
                walked = rows[profile_pair]
                idle = max(0.0, 1.0 - (kern + other) / ms)
                line += (f"; {name}, profiled pair {profile_pair}: row walk "
                         f"{kern / 2:.3f} ms a window, {kern * 1e3 / walked:.2f} "
                         f"us a row ({walked} rows), other device work "
                         f"{other / 2:.3f} ms a window, device idle share "
                         f"{idle:.3f} of {ms:.1f} ms")
        print(line, flush=True)
    return out


def run_prune_phase(device, card):
    """Phase 12: the pruned two-tier solve on the card (see the module
    docstring). Returns the main path's row-walk and probe launches: the
    pruned solvers' and the server's, not the unpruned comparisons'."""
    import torch

    from spark_scheduler_tpu_torch.ops.probe import probe_add_one

    on_card = torch.device(device).type == "cuda"
    nodes, usage = main_cluster(seed=7)
    names = [nd.name for nd in nodes]
    rng = np.random.default_rng(41)
    windows = [prune_window(rng, names, PRUNE_WINDOW)
               for _ in range(PRUNE_WINDOWS)]
    # Each arm counts the pruned solver's launches only: the unpruned and
    # cpu solvers beside it are comparisons.
    probe_add_one.launches = 0
    seq = run_prune_arm(device, card, "(a) sequential", nodes, usage, windows,
                        fused=False, top_k=PRUNE_TOP_K, slack=PRUNE_SLACK,
                        churn_seed=43)
    check(not on_card or seq["pruned_dispatches"] >= PRUNE_MIN_PRUNED,
          f"phase 12 (a): {seq['pruned_dispatches']} of {PRUNE_WINDOWS} "
          f"windows took the pruned path (at least {PRUNE_MIN_PRUNED})")
    fused = run_prune_arm(device, card, "(a) fused", nodes, usage, windows,
                          fused=True, top_k=PRUNE_TOP_K, slack=PRUNE_SLACK,
                          churn_seed=43)
    top_k, slack, n_tight = PRUNE_TIGHT
    tight = run_prune_arm(device, card, "(a) tight", nodes, usage,
                          windows[:n_tight], fused=False, top_k=top_k,
                          slack=slack, churn_seed=43, profile_pair=None)
    check(tight["escalations"] > 0,
          f"phase 12 (a) tight: no escalation at top-k {top_k}, slack {slack}")
    window_launches = sum(a["launches"]["pruned"] for a in (seq, fused, tight))
    probes = sum(a["probes"]["pruned"] for a in (seq, fused, tight))

    # (b) Through the server: phase 7's cluster with solver.prune-top-k.
    srv_launches, srv = run_server_phase(
        device, card, n_drivers=PRUNE_DRIVERS, n_clients=PRUNE_CLIENTS,
        phase=12, prune=PRUNE_TOP_K)
    block = srv["prune"]
    check(block.get("windows", 0) * 2 >= srv["device_dispatches"],
          f"phase 12 (b): {block.get('windows', 0)} of "
          f"{srv['device_dispatches']} driver-window dispatches pruned "
          f"(at least half)")
    print(f"phase 12 (b) ({card}): {block.get('windows', 0)} of "
          f"{srv['device_dispatches']} driver-window dispatches pruned, kept "
          f"rows {block.get('kept_rows', 0)} of {block.get('candidate_rows', 0)} "
          f"candidate rows in all, escalations {block.get('escalations', 0)} "
          f"{block.get('reasons', {})}, {srv['resolved']} dispatches re-solved; "
          f"plan / gather / offset means {block.get('plan_ms_mean')} / "
          f"{block.get('gather_ms_mean')} / {block.get('offset_ms_mean')} ms; "
          f"driver p50 {srv['drv_p50']:.3f} ms p99 {srv['drv_p99']:.3f} ms "
          f"(client host clock)", flush=True)

    # (c) The JAX package's own pruning tier: 100,000 nodes.
    t0 = time.perf_counter()
    big_nodes, big_usage = main_cluster(seed=7, n=PRUNE_BIG_NODES)
    big_names = [nd.name for nd in big_nodes]
    rng = np.random.default_rng(47)
    big_windows = [prune_window(rng, big_names, PRUNE_BIG_WINDOW)
                   for _ in range(PRUNE_BIG_WINDOWS)]
    big = run_prune_arm(device, card, "(c) 100,000 nodes", big_nodes, big_usage,
                        big_windows, fused=False, top_k=PRUNE_TOP_K,
                        slack=PRUNE_SLACK, churn_seed=53, with_cpu=False)
    check(big["pruned_dispatches"] > 0 or not on_card,
          "phase 12 (c): no window pruned at 100,000 nodes")
    print(f"phase 12 (c): ran in {time.perf_counter() - t0:.1f} s; the "
          f"pruned solver's build block (as /debug/state shows it) "
          f"{big['build']}", flush=True)
    window_launches += big["launches"]["pruned"]
    probes += big["probes"]["pruned"]
    return {"window": window_launches + srv_launches["window"],
            "probe": probes + srv_launches["probe"]}


# ------------------------------------------------------------ phase 13

P13_CLIENTS = 16
P13_GROUP = "policy-group"
P13_GROUP_NODES = 512  # the instance group the policy clients offer
P13_EXECS = 64  # executors of a policy gang (8 CPU / 32 Gi each)
P13_HIGHS = 6
P13_DA = 4  # small low gangs with dynamic allocation: the soft extras
P13_TRIES = 40  # posts of one driver before a client gives up
P13_ELASTIC = "elastic-group"
P13_ELASTIC_NODES = 64  # a full instance group
P13_ELASTIC_APPS = 16
P13_STATIC_DA = 8  # running apps whose extra executors mix into (b)'s windows
P13_SAMPLE = 256  # candidate names of a main-group app (a scored sample)
P13_POLICY_YAML = {
    "enabled": True, "ordering": "priority", "preemption": True,
    "max-evictions": 8, "protected-class": "system",
    "defrag": {"enabled": True, "budget": 4},
}


class ManualClock:
    """The injected clock of phase 13: it moves only when told, so the
    `cpu` replay sees the same times (through a marked log entry)."""

    def __init__(self, t):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt
        return self.t


def p13_config(raw):
    """`raw` (a YAML install block) on phase 7's serving settings. The
    injected clock jumps: the request-gap resync and the unschedulable
    marker (whose solo pack would run on its own thread) stay out of the
    way, as in the JAX package's policy soak."""
    import dataclasses

    from spark_scheduler_tpu_torch.server.config import InstallConfig

    return dataclasses.replace(
        InstallConfig.from_dict(raw), fifo=True, binpack_algo="tightly-pack",
        instance_group_label=EXT_IG_LABEL, sync_writes=True, debug_routes=True,
        resync_gap_seconds=1e12, unschedulable_pod_timeout_s=86_400.0,
    )


def p13_pod(app_id, role, name, *, group, created, execs=0, cpu=8, mem=32,
            pclass=None, da=None):
    """k8s JSON of a Spark pod in `group`; `da` = (min, max) executors for
    dynamic allocation, `pclass` the priority class annotation."""
    pod = k8s_spark_pod_json(app_id, role, name, execs, created)
    ann = pod["metadata"]["annotations"]
    ann.update({"spark-executor-cpu": str(cpu),
                "spark-executor-mem": f"{mem}Gi"})
    if da is not None:
        del ann["spark-executor-count"]
        ann.update({"spark-dynamic-allocation-enabled": "true",
                    "spark-dynamic-allocation-min-executor-count": str(da[0]),
                    "spark-dynamic-allocation-max-executor-count": str(da[1])})
    if pclass is not None:
        ann["spark-priority-class"] = pclass
    pod["spec"]["nodeSelector"] = {EXT_IG_LABEL: group}
    if role == "executor":
        pod["spec"]["containers"][0]["resources"]["requests"] = {
            "cpu": str(cpu), "memory": f"{mem}Gi"}
    return pod


def p13_server(device, config, clock, groups, n_nodes):
    """A recorded server on phase 3's cluster: `groups` maps an instance
    group to (node indices, use): those nodes carry its label (the rest
    phase 7's group), and with `use` "full" their prior usage is all they
    hold, with "none" they have none (a node pool of its own)."""
    from spark_scheduler_tpu_torch.models.kube import Container, Pod
    from spark_scheduler_tpu_torch.models.resources import Resources

    srv = RecordedServer(device, config, clock=clock, quiet_ops=True)
    srv.app.smoke_clock = clock
    nodes, usage = main_cluster(seed=7)
    nodes, usage = nodes[:n_nodes], usage[:n_nodes].copy()
    member = {}
    for group, (idx, use) in groups.items():
        for i in idx:
            member[int(i)] = group
            a = nodes[i].allocatable
            usage[i] = ((a.cpu_milli, a.mem_kib, a.gpu_milli) if use == "full"
                        else (0, 0, 0))
    for i, node in enumerate(nodes):
        node.labels[EXT_IG_LABEL] = member.get(i, EXT_IG)
        srv.backend.add_node(node)
        if not usage[i].any():
            continue
        srv.backend.add_pod(Pod(
            name=f"base-{i:05d}", namespace="other", uid=f"uid-base-{i:05d}",
            scheduler_name="default-scheduler", node_name=node.name,
            phase="Running",
            containers=[Container(requests=Resources(*map(int, usage[i])))],
        ))
    return srv, nodes, usage


class Answers(dict):
    """{pod name: [(status, body), ...]} whose lookup hands out a pod's
    answers in the order the server sent them (the replay compares each
    of a pod's predicates with the matching answer)."""

    def __getitem__(self, name):
        return dict.__getitem__(self, name).pop(0)


def p13_replay(srv, config, got, label):
    """Replay the log on a `cpu` app of the same config with its own
    injected clock; marked entries run on it and must return what they
    returned on the server. Returns the predicates compared."""
    from spark_scheduler_tpu_torch.server.app import build_scheduler_app
    from spark_scheduler_tpu_torch.store.backend import DEMAND_CRD, InMemoryBackend

    backend = InMemoryBackend()
    backend.register_crd(DEMAND_CRD)
    clock = ManualClock(EXT_CLOCK)
    ref = build_scheduler_app(backend, config, clock=clock, device="cpu")
    ref.smoke_clock = clock

    def marked(e):
        want = json.dumps(e["result"], sort_keys=True, default=str)
        have = json.dumps(e["fn"](ref), sort_keys=True, default=str)
        check(have == want, f"{label}: the cpu replay's {e['label']} gave "
                            f"{have[:300]} where the server's gave {want[:300]}")

    answers = Answers({k: list(v) for k, v in got.items()})
    n = sum(len(v) for v in got.values())
    compared = replay_server_log(srv.log, config, answers, ref=ref,
                                 backend=backend, markers={"marked": marked},
                                 label=label)
    check(compared == n, f"{label}: compared {compared} of {n} responses")
    return compared


def p13_teardown(app_ids):
    """A marked op: the apps end (their pods and reservations go)."""
    def teardown(app):
        for a in app_ids:
            for pod in app.pod_lister.list_app_pods(a, EXT_NS):
                cur = app.backend.get("pods", pod.namespace, pod.name)
                if cur is not None:
                    app.backend.delete_pod(cur)
            if app.rr_cache.get(EXT_NS, a) is not None:
                app.rr_cache.delete(EXT_NS, a)
        return sorted(app_ids)
    return teardown


def p13_advance(dt):
    return lambda app: app.smoke_clock.advance(dt)


def p13_state(app):
    """What the replay must reproduce: every reservation (v1beta2 wire),
    the soft reservations, every preemption record and the over-commit
    check."""
    from spark_scheduler_tpu_torch.server.conversion import rr_v1beta2_to_wire
    from spark_scheduler_tpu_torch.testing.harness import overcommit_violations

    return {
        "reservations": sorted(json.dumps(rr_v1beta2_to_wire(rr), sort_keys=True)
                               for rr in app.rr_cache.list()),
        "soft": sorted((a, sorted((p, r.node) for p, r in sr.reservations.items()))
                       for a, sr in app.soft_store.get_all_copy().items()),
        "preemptions": [rec["preemption"] for rec in
                        reversed(app.recorder.query(limit=1_000_000))
                        if rec.get("preemption")],
        "overcommit": overcommit_violations(app, app.backend),
    }


def p13_driver_job(pod, names, *, bind=True, tries=1, on_answer=None):
    """A client job: PUT the driver pod, POST its predicate up to `tries`
    times until admitted, then bind it. `on_answer(status, body)` sees each
    answer."""
    def job(send):
        send("PUT", "/state/pods", pod)
        for k in range(tries):
            status, data = send("POST", "/predicates",
                                {"Pod": pod, "NodeNames": names})
            res = json.loads(data) if status == 200 else {}
            if on_answer is not None:
                on_answer(status, res)
            if res.get("NodeNames"):
                if bind:
                    bound = json.loads(json.dumps(pod))
                    bound["spec"]["nodeName"] = res["NodeNames"][0]
                    bound["status"]["phase"] = "Running"
                    send("PUT", "/state/pods", bound)
                return
            if k + 1 < tries:
                time.sleep(0.02)
    return job


def p13_executor_job(pods, names):
    """PUT and POST each executor pod; bind the admitted ones."""
    def job(send):
        for pod in pods:
            send("PUT", "/state/pods", pod)
            status, data = send("POST", "/predicates",
                                {"Pod": pod, "NodeNames": names})
            res = json.loads(data) if status == 200 else {}
            if res.get("NodeNames"):
                bound = json.loads(json.dumps(pod))
                bound["spec"]["nodeName"] = res["NodeNames"][0]
                bound["status"]["phase"] = "Running"
                send("PUT", "/state/pods", bound)
    return job


def p13_clients(srv, jobs, n_clients, got, lat):
    out, lats = run_clients(srv.server.port, jobs, n_clients, keep_all=True)
    for k, v in out.items():
        got.setdefault(k, []).extend(v)
    lat.extend(lats)
    return out


def p13_outcome(body):
    res = json.loads(body)
    if res.get("NodeNames"):
        return "success"
    msgs = " ".join(res.get("FailedNodes", {}).values())
    if "earlier drivers" in msgs:
        return "earlier"
    return "preempted" if "preempted" in msgs else "fit"


def p13_launches(phase, srv, launches, on_card, solved):
    """Row-walk launches = the live segments of every window solve the
    solver dispatched (`solved`: the batcher's windows, the re-solves of
    windows a capacity change made stale, and the windows a completion
    solves: executor stragglers, lone drivers) + every solo pack; one
    probe. Every launch falls inside a recorded dispatch or completion.
    Returns (the batcher's window segments, the segments solved at
    completion, the solo packs)."""
    log = srv.log
    segments = sum(e["segments"] for e in log if isinstance(e, dict)
                   and e["op"] == "dispatch" and not e["drain"])
    solo = srv.solo_packs
    check(solo["other"] == 0, f"phase {phase}: solo packs off the batcher "
                              f"thread: {solo}")
    fault_free(srv.app.solver, phase)
    if on_card:
        inside = sum(e["launches"] for e in log
                     if isinstance(e, dict) and "launches" in e)
        check(inside == launches["window"],
              f"phase {phase}: {launches['window']} launches, {inside} "
              f"inside the recorded dispatches and completions")
        check(launches["window"] == solved[0] + solo["batcher"],
              f"phase {phase}: row-walk launches {launches['window']} != "
              f"{solved[0]} live segments solved + {solo['batcher']} solo "
              f"packs")
        check(launches["probe"] == 1, f"phase {phase}: probe launches "
                                      f"{launches['probe']}")
    check(solved[0] >= segments, f"phase {phase}: {solved[0]} segments "
                                 f"solved, {segments} dispatched")
    return segments, solved[0] - segments, solo["batcher"]


def p13_count_segments(srv):
    """Count the segments (requests) of every `pack_window_dispatch` call
    of the server's solver; `pack_window` reaches it too."""
    counted = [0]
    dispatch = srv.app.solver.pack_window_dispatch

    def counting(strategy, tensors, requests):
        counted[0] += len(requests)
        return dispatch(strategy, tensors, requests)

    srv.app.solver.pack_window_dispatch = counting
    return counted


def run_policy_phase(device, card, n_nodes=N_MAIN, group_nodes=P13_GROUP_NODES,
                     n_clients=P13_CLIENTS, highs=P13_HIGHS, execs=P13_EXECS):
    """Phase 13(a): the policy engine through the server (see the module
    docstring). Returns the row-walk and probe launches and the stats."""
    import torch

    import spark_scheduler_tpu_torch.core.solver as solver_mod
    from spark_scheduler_tpu_torch.models.cluster import cluster_from_numpy
    from spark_scheduler_tpu_torch.ops.probe import probe_add_one
    from spark_scheduler_tpu_torch.ops.window import window_pack
    from spark_scheduler_tpu_torch.policy.engine import PREEMPTION_SEARCH_FAILURES
    from spark_scheduler_tpu_torch.testing.harness import overcommit_violations

    on_card = torch.device(device).type == "cuda"
    t_phase = time.perf_counter()
    config = p13_config({"policy": P13_POLICY_YAML})
    clock = ManualClock(EXT_CLOCK)
    window_pack.launches = 0
    probe_add_one.launches = 0
    group_idx = np.arange(group_nodes) * (n_nodes // group_nodes)
    srv, nodes, usage = p13_server(device, config, clock,
                                   {P13_GROUP: (group_idx, "none")}, n_nodes)
    solved = p13_count_segments(srv)
    solver = srv.app.solver
    engine = srv.app.extender._policy
    # The preemption searches' wall time (host clock: the injected clock
    # reads 0 ms for each), and the last batched fit's inputs.
    search_ms, fit_args = [], []
    search = solver.preemption_search

    def timed_search(*a, **kw):
        t0 = time.perf_counter()
        try:
            return search(*a, **kw)
        finally:
            search_ms.append((time.perf_counter() - t0) * 1e3)

    solver.preemption_search = timed_search
    batched_fit = solver_mod.preemption_batched_fit

    def captured_fit(*a, **kw):
        fit_args[:] = [(a, kw)]
        return batched_fit(*a, **kw)

    solver_mod.preemption_batched_fit = captured_fit
    got, lat = {}, []
    names = [nodes[i].name for i in group_idx]
    free = np.stack([[nodes[i].allocatable.cpu_milli, nodes[i].allocatable.mem_kib]
                     for i in group_idx]) - usage[group_idx, :2]
    gang = np.array([8000 * execs + 1000, (32 * execs + 2) << 20])
    n_lows = int((free.sum(axis=0) // gang).min()) + 4
    created = iter(range(int(EXT_CLOCK) - 400, int(EXT_CLOCK)))
    try:
        def violations(stage):
            with srv.lock:
                v = overcommit_violations(srv.app, srv.backend)
            check(not v, f"phase 13a: over-commit after {stage}: {v[:8]}")

        # 1. The system gang, then the low gangs: the small dynamic-
        # allocation ones with all their executors, then the rest at once.
        sys_pod = p13_pod("sys-0", "driver", "sys-0-driver", group=P13_GROUP,
                          created=next(created), execs=execs // 2,
                          pclass="system")
        p13_clients(srv, [p13_driver_job(sys_pod, names)], 1, got, lat)
        lows = {}
        for k in range(P13_DA):
            a = f"da-{k}"
            ts = next(created)
            lows[a] = (p13_pod(a, "driver", f"{a}-driver", group=P13_GROUP,
                               created=ts, pclass="low", da=(2, 6)), ts)
        p13_clients(srv, [p13_driver_job(pod, names) for pod, _ in lows.values()],
                    n_clients, got, lat)
        da_execs = [[p13_pod(a, "executor", f"{a}-exec-{j + 1}", group=P13_GROUP,
                             created=ts, da=(2, 6)) for j in range(6)]
                    for a, (_, ts) in lows.items()]
        p13_clients(srv, [p13_executor_job(p, names) for p in da_execs],
                    n_clients, got, lat)
        for k in range(n_lows):
            a = f"low-{k:02d}"
            ts = next(created)
            lows[a] = (p13_pod(a, "driver", f"{a}-driver", group=P13_GROUP,
                               created=ts, execs=execs, pclass="low"), ts)
        p13_clients(srv, [p13_driver_job(lows[f"low-{k:02d}"][0], names)
                          for k in range(n_lows)], n_clients, got, lat)
        fill = {a: p13_outcome(got[f"{a}-driver"][-1][1]) for a in lows}
        check(list(fill.values()).count("success") >= 2,
              f"phase 13a: the low gangs did not fill the group: {fill}")
        violations("the fill")

        # 2. High gangs twice a low gang's size that fit only after
        # evictions; each client retries.
        high_ids = [f"high-{k}" for k in range(highs)]
        high_pods = [p13_pod(a, "driver", f"{a}-driver", group=P13_GROUP,
                             created=next(created), execs=2 * execs,
                             pclass="high")
                     for a in high_ids]
        p13_clients(srv, [p13_driver_job(p, names, tries=P13_TRIES)
                          for p in high_pods], n_clients, got, lat)
        high_out = [[p13_outcome(b) for _, b in got[f"{a}-driver"]] for a in high_ids]
        check(all(o[-1] == "success" for o in high_out),
              f"phase 13a: high gangs not admitted: {high_out}")
        check(any("preempted" in o for o in high_out),
              f"phase 13a: no high gang was denied with an eviction: {high_out}")
        # A high gang no eviction set admits: an executor larger than any
        # node. It stays pending, ahead of every low driver.
        big = p13_pod("high-big", "driver", "high-big-driver", group=P13_GROUP,
                      created=next(created), execs=2, cpu=128, mem=32,
                      pclass="high")
        p13_clients(srv, [p13_driver_job(big, names)], 1, got, lat)
        check(p13_outcome(got["high-big-driver"][-1][1]) == "fit",
              "phase 13a: the too-big high gang was not denied for fit")
        violations("the preemptions")

        # 3. The high apps end. The low gangs without a reservation queue
        # behind the pending high gang; past two promotion intervals they
        # rank with it and, older, ahead of it, and admit.
        srv.marked(p13_teardown(high_ids), "teardown")
        pending = [a for a in lows if srv.app.rr_cache.get(EXT_NS, a) is None]
        check(pending, "phase 13a: no low gang is waiting")
        retry = [p13_pod(a, "driver", f"{a}-driver", group=P13_GROUP,
                         created=lows[a][1], pclass="low",
                         **({"da": (2, 6)} if a.startswith("da-")
                            else {"execs": execs}))
                 for a in pending]
        p13_clients(srv, [p13_driver_job(p, names) for p in retry], n_clients,
                    got, lat)
        queued = [a for a in pending
                  if p13_outcome(got[f"{a}-driver"][-1][1]) == "earlier"]
        check(queued, f"phase 13a: no low driver queued behind the high one "
                      f"({[p13_outcome(got[f'{a}-driver'][-1][1]) for a in pending]})")
        srv.marked(p13_advance(2 * config.policy_promote_after_s + 1), "clock")
        p13_clients(srv, [p13_driver_job(p, names, tries=3) for p in retry],
                    n_clients, got, lat)
        promoted = [a for a in queued
                    if p13_outcome(got[f"{a}-driver"][-1][1]) == "success"]
        check(promoted, "phase 13a: no queued low driver admitted after "
                        "the promotion")
        violations("the promotion")

        # 4. One forced defragmentation pass.
        frag = srv.marked(
            lambda app: app.extender._policy.defrag.run_once(force=True),
            "defrag")
        check(frag["fragmentation_after"] <= frag["fragmentation_before"],
              f"phase 13a: fragmentation rose: {frag}")
        violations("the defrag pass")
        state = srv.marked(p13_state, "state")
        status, body = http_get(srv.server.port, "/metrics")
        check(status == 200, f"/metrics: {status}")
        snapshot = json.loads(body)
    finally:
        srv.server.stop()
        solver.preemption_search = search
        solver_mod.preemption_batched_fit = batched_fit
    launches = {"window": window_pack.launches, "probe": probe_add_one.launches}
    serve_s = time.perf_counter() - t_phase

    pre = state["preemptions"]
    evicted = [a for p in pre for a in p["evicted"]]
    check(pre and evicted, "phase 13a: no preemption")
    check("sys-0" not in evicted and any(
        '"name": "sys-0"' in r for r in state["reservations"]),
        "phase 13a: the system gang was evicted")
    check(state["overcommit"] == [], f"phase 13a: over-commit {state['overcommit']}")
    check(engine.search_failures == 0
          and not series(snapshot, PREEMPTION_SEARCH_FAILURES),
          f"phase 13a: {engine.search_failures} preemption search failures")
    kind = torch.device(device).type
    check(solver.preemption_searches.get(kind, 0) >= 1,
          f"phase 13a: preemption_search never ran on {kind}: "
          f"{solver.preemption_searches}")
    segments, redone, solo = p13_launches("13a", srv, launches, on_card, solved)

    # The last search's batched fit again, on the card and on the cpu.
    (a, kw), = fit_args
    c = int(a[1].shape[0])
    want = batched_fit(*a, **kw)
    # The card's inputs as the search saw them: the device tensors (the
    # host view behind them is the resident build's, patched since).
    cpu_cluster = cluster_from_numpy(
        [t.cpu().numpy() for t in a[0].fields()], device="cpu")
    cpu_args = (cpu_cluster,) + tuple(x.cpu() if torch.is_tensor(x) else x
                                      for x in a[1:])
    t0 = time.perf_counter()
    got_cpu = batched_fit(*cpu_args, **kw)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    for g, w in zip(got_cpu, want):
        check(torch.equal(g, w.cpu()), "phase 13a: the batched fit on the cpu "
                                       "differs from the card's")
    if on_card:
        card_ms = cuda_time_ms(lambda: batched_fit(*a, **kw), 5)
        fit_line = f"{card_ms:.3f} ms a call on the card (CUDA events)"
    else:
        fit_line = "not measured on the card"
    t0 = time.perf_counter()
    compared = p13_replay(srv, config, got, "phase 13a")
    replay_s = time.perf_counter() - t0
    drains = sum(1 for e in srv.log if isinstance(e, dict) and e.get("drain"))
    stats = {"preemptions": len(pre), "evictions": len(evicted),
             "search_ms_p50": pctl(search_ms, 50), "fit_cpu_ms": cpu_ms,
             "frag": frag, "promoted": len(promoted)}
    print(f"phase 13a ({card}): {len(got)} pods, {compared} predicates "
          f"byte-identical to a cpu replay (replay {replay_s:.1f} s); "
          f"{n_lows} low gangs + {P13_DA} dynamic-allocation ones on a "
          f"{group_nodes}-node instance group: {list(fill.values()).count('success')} "
          f"admitted; {highs} high gangs: {len(pre)} preemptions evicted "
          f"{len(evicted)} gangs ({sorted(set(evicted))}), the system gang "
          f"never; preemption_search {solver.preemption_searches} "
          f"p50 {pctl(search_ms, 50):.3f} ms (host clock), 0 failures; "
          f"preemption_batched_fit at C = {c}: {fit_line}, {cpu_ms:.3f} ms on "
          f"the cpu (host clock); {len(queued)} low drivers queued behind the "
          f"pending high one, {len(promoted)} admitted after the promotion; "
          f"defrag {frag['migrations']} migrations, fragmentation "
          f"{frag['fragmentation_before']:.6f} -> {frag['fragmentation_after']:.6f}; "
          f"{drains} pipeline drains; row-walk launches {launches['window']} = "
          f"{segments} live segments of the batcher's windows + {redone} "
          f"solved at completion + {solo} solo packs; probe "
          f"{launches['probe']}; client p50 "
          f"{pctl(lat, 50):.3f} ms p99 {pctl(lat, 99):.3f} ms; served in "
          f"{serve_s:.1f} s; over-commit none", flush=True)
    return launches, stats


def run_autoscaler_phase(device, card, n_nodes=N_MAIN,
                         elastic_nodes=P13_ELASTIC_NODES,
                         n_apps=P13_ELASTIC_APPS, n_da=P13_STATIC_DA,
                         n_clients=P13_CLIENTS):
    """Phase 13(b): the elastic autoscaler through the server (see the
    module docstring). Returns the row-walk and probe launches."""
    import torch

    from spark_scheduler_tpu_torch.autoscaler import (
        PROVISIONED_BY_LABEL,
        PROVISIONER_NAME,
    )
    from spark_scheduler_tpu_torch.ops.probe import probe_add_one
    from spark_scheduler_tpu_torch.ops.window import window_pack
    from spark_scheduler_tpu_torch.testing.harness import overcommit_violations

    on_card = torch.device(device).type == "cuda"
    t_phase = time.perf_counter()
    nodes0, _ = main_cluster(seed=7)
    big = max(nodes0[:n_nodes], key=lambda n: (n.allocatable.cpu_milli,
                                               n.allocatable.mem_kib,
                                               n.allocatable.gpu_milli))
    a = big.allocatable
    # Static row deltas off: a node added mid-window then drains the
    # pipeline (with them on it rides a row scatter inside the padding
    # bucket), so a solo solve in that gap builds through the fallback.
    config = p13_config({
        "autoscaler": {
            "enabled": True, "zones": [f"zone-{z}" for z in range(4)],
            "node-cpu": str(a.cpu_milli // 1000),
            "node-memory": f"{a.mem_kib >> 20}Gi",
            "node-gpu": str(a.gpu_milli // 1000),
            "max-cluster-size": n_nodes + 400, "idle-ttl": 60.0,
            "poll-interval": 3600.0,
        },
        "solver": {"delta-statics": False},
    })
    clock = ManualClock(EXT_CLOCK)
    window_pack.launches = 0
    probe_add_one.launches = 0
    step = n_nodes // elastic_nodes
    elastic_idx = np.arange(elastic_nodes) * step + 1
    srv, nodes, _ = p13_server(device, config, clock,
                               {P13_ELASTIC: (elastic_idx, "full")}, n_nodes)
    # The server started the autoscaler's loop; this phase runs its passes.
    srv.app.autoscaler.stop()
    solved = p13_count_segments(srv)
    solver = srv.app.solver
    got, lat = {}, []
    elastic = [nodes[i].name for i in elastic_idx]
    grown = elastic + [f"autoscaled-{k}" for k in range(64)]
    rng = np.random.default_rng(31)
    main = [n.name for i, n in enumerate(nodes) if i not in set(elastic_idx)]
    sample = sorted(rng.choice(main, min(P13_SAMPLE, len(main)), replace=False))
    created = iter(range(int(EXT_CLOCK) - 400, int(EXT_CLOCK)))
    try:
        def violations(stage):
            with srv.lock:
                v = overcommit_violations(srv.app, srv.backend)
            check(not v, f"phase 13b: over-commit after {stage}: {v[:8]}")

        # 0. Running dynamic-allocation apps in phase 7's group, with their
        # minimum executors.
        das = {}
        for k in range(n_da):
            ap = f"dyn-{k}"
            ts = next(created)
            das[ap] = (p13_pod(ap, "driver", f"{ap}-driver", group=EXT_IG,
                               created=ts, cpu=2, mem=4, da=(2, 8)), ts)
        p13_clients(srv, [p13_driver_job(p, sample) for p, _ in das.values()],
                    n_clients, got, lat)
        p13_clients(srv, [p13_executor_job(
            [p13_pod(ap, "executor", f"{ap}-exec-{j + 1}", group=EXT_IG,
                     created=ts, cpu=2, mem=4, da=(2, 8)) for j in range(2)],
            sample) for ap, (_, ts) in das.items()], n_clients, got, lat)

        # 1. Drivers of the full group: denied, each with a demand.
        apps = {}
        for k in range(n_apps):
            ap = f"elastic-{k:02d}"
            apps[ap] = p13_pod(ap, "driver", f"{ap}-driver", group=P13_ELASTIC,
                               created=next(created), execs=8, cpu=2, mem=4)
        first_denied = {}

        def note(ap):
            def on_answer(status, res):
                if not res.get("NodeNames"):
                    first_denied.setdefault(ap, time.perf_counter())
                else:
                    admitted_at[ap] = time.perf_counter()
            return on_answer

        admitted_at = {}
        p13_clients(srv, [p13_driver_job(p, grown, on_answer=note(ap))
                          for ap, p in apps.items()], n_clients, got, lat)
        demands = srv.backend.list("demands")
        check(len(first_denied) == n_apps and len(
            [d for d in demands if d.spec.instance_group == P13_ELASTIC]) == n_apps,
            f"phase 13b: {len(first_denied)} denials, demands {len(demands)}")
        violations("the denials")

        # 2. The drivers retry while the running apps' extra executors
        # arrive; the autoscaler runs right after a dispatch that leaves a
        # window with extra executors in flight behind it (or, failing
        # that, once every extra executor has been answered), so the node
        # adds land mid-window.
        passes, extras_done = [], []

        def autoscale():
            passes.append(srv.marked(lambda app: app.autoscaler.run_once(),
                                     "autoscaler pass"))

        def ready(e, inflight):
            prev = [x for x in inflight if x is not e]
            mixed = any(
                any(a.pod.labels.get("spark-role") == "executor" for a in x["args"])
                for x in prev)
            return (mixed and e["dispatch_id"] is not None) or (
                len(extras_done) == len(extras))

        srv.trigger_when, srv.on_trigger = ready, autoscale
        extras = [[p13_pod(ap, "executor", f"{ap}-exec-{j + 1}", group=EXT_IG,
                           created=ts, cpu=2, mem=4, da=(2, 8))
                   for j in range(2, 8)] for ap, (_, ts) in das.items()]
        def extras_job(pods):
            job = p13_executor_job(pods, sample)

            def run(send):
                job(send)
                extras_done.append(1)
            return run

        jobs = []
        for k, (ap, p) in enumerate(apps.items()):
            jobs.append(p13_driver_job(p, grown, tries=P13_TRIES * 3,
                                       on_answer=note(ap)))
            if k < len(extras):
                jobs.append(extras_job(extras[k]))
        p13_clients(srv, jobs, n_clients, got, lat)
        check(len(passes) == 1, f"phase 13b: {len(passes)} autoscaler passes")
        summary = passes[0]
        check(summary["fulfilled"] == n_apps and summary["nodes_added"] >= 1,
              f"phase 13b: autoscaler pass {summary}")
        on_new = {ap: json.loads(got[f"{ap}-driver"][-1][1])["NodeNames"]
                  for ap in apps}
        check(all(v and v[0].startswith("autoscaled-") for v in on_new.values()),
              f"phase 13b: drivers not admitted on the new nodes: {on_new}")
        check(not [d for d in srv.backend.list("demands")
                   if d.spec.instance_group == P13_ELASTIC],
              "phase 13b: demands left after the admissions")
        violations("the scale-up")

        # 3. The apps end but one; past the idle TTL the drainer cordons,
        # then removes, the provisioned nodes no reservation names.
        keep = next(iter(apps))
        srv.marked(p13_teardown([ap for ap in apps if ap != keep]), "teardown")
        srv.marked(lambda app: app.autoscaler.run_once(), "autoscaler pass")
        srv.marked(p13_advance(config.autoscaler_idle_ttl_s + 1), "clock")
        srv.marked(lambda app: app.autoscaler.run_once(), "autoscaler pass")
        last = srv.marked(lambda app: app.autoscaler.run_once(),
                          "autoscaler pass")
        drained = set(last["drained"])
        provisioned = {n.name for n in srv.backend.list_nodes()
                       if n.labels.get(PROVISIONED_BY_LABEL) == PROVISIONER_NAME}
        added = {f"autoscaled-{k}" for k in range(summary["nodes_added"])}
        kept_rr = srv.app.rr_cache.get(EXT_NS, keep)
        reserved = {r.node for r in kept_rr.spec.reservations.values()}
        check(drained and drained == added - reserved
              and provisioned == added & reserved,
              f"phase 13b: drained {sorted(drained)}, added {sorted(added)}, "
              f"reserved {sorted(reserved)}")
        violations("the drain")
        state = srv.marked(p13_state, "state")
        counts = srv.app.autoscaler.metrics.counts()
    finally:
        srv.server.stop()
    launches = {"window": window_pack.launches, "probe": probe_add_one.launches}
    serve_s = time.perf_counter() - t_phase
    check(state["overcommit"] == [], f"phase 13b: over-commit {state['overcommit']}")
    check(counts["demands_fulfilled"] == n_apps
          and counts["nodes_drained"] == len(drained),
          f"phase 13b: autoscaler counts {counts}")
    segments, redone, solo = p13_launches("13b", srv, launches, on_card, solved)
    t0 = time.perf_counter()
    compared = p13_replay(srv, config, got, "phase 13b")
    replay_s = time.perf_counter() - t0
    drains = sum(1 for e in srv.log if isinstance(e, dict) and e.get("drain"))
    waits = [(admitted_at[ap] - first_denied[ap]) * 1e3 for ap in apps]
    print(f"phase 13b ({card}): {compared} predicates byte-identical to a cpu "
          f"replay (replay {replay_s:.1f} s); {n_apps} drivers of a full "
          f"{elastic_nodes}-node group denied with demands; the autoscaler "
          f"pass with windows in flight added {summary['nodes_added']} nodes "
          f"(template {a.cpu_milli // 1000} CPU / {a.mem_kib >> 20} Gi / "
          f"{a.gpu_milli // 1000} GPU) and fulfilled {summary['fulfilled']} "
          f"demands; every retried driver admitted on them; denial to "
          f"admission p50 {pctl(waits, 50):.3f} ms max {max(waits):.3f} ms "
          f"(client host clock); {drains} pipeline drains, "
          f"{solver.solo_inflight_debits} solo builds debited in-flight "
          f"windows; drained {len(drained)} idle provisioned nodes, kept "
          f"{len(provisioned)} reserved, no static node; row-walk launches "
          f"{launches['window']} = {segments} live segments of the batcher's "
          f"windows + {redone} solved at completion + {solo} solo packs; "
          f"probe {launches['probe']}; "
          f"served in {serve_s:.1f} s; over-commit none", flush=True)
    return launches, {"drains": drains, "debits": solver.solo_inflight_debits,
                      "waits": waits, "summary": summary}



# --------------------------------------------------------------- phase 14

P14_GROUPS = 4  # instance groups of 2,500 nodes
P14_WINDOWS = 16
P14_WINDOW = 32
P14_KILL_AT = 2  # slot 1's third part solve dies in (b)
P14_DRIVERS = 64
P14_CLIENTS = 4


def p14_groups(names, groups=P14_GROUPS):
    """The node names of each instance group: contiguous blocks."""
    size = len(names) // groups
    return [names[g * size:(g + 1) * size] for g in range(groups)]


def p14_window(rng, groups, n_requests):
    """`n_requests` tightly-pack requests shaped as phase 7's apps, each
    pinned to an instance group (candidates and domain: the group's
    nodes), the groups cycled so that every window partitions; 0-1
    FIFO-earlier pending drivers each."""
    from spark_scheduler_tpu_torch.core.solver import WindowRequest
    from spark_scheduler_tpu_torch.models.resources import Resources

    driver = Resources.from_quantities("1", "2Gi")
    executor = Resources.from_quantities("2", "4Gi")

    def app(skippable):
        count = 32 if rng.random() < 0.15 else int(rng.integers(2, 9))
        return (driver, executor, count, skippable)

    out = []
    for r in range(n_requests):
        g = groups[r % len(groups)]
        rows = [app(bool(rng.random() < 0.3))
                for _ in range(int(rng.integers(0, 2)))]
        rows.append(app(False))
        out.append(WindowRequest(rows=rows, driver_candidate_names=g,
                                 domain_node_names=g))
    return out


class SlotTarget:
    """Names the pool slot whose part solve is running on this thread, so a
    fault spec can target one slot: a part solve on slot k fires
    `device.dispatch.slot<k>` through the injector (every other boundary
    fires `device.<kind>` as the injector's own shim does)."""

    def __init__(self, solver, injector):
        import threading

        self.local = threading.local()
        self.injector = injector
        solve = solver._part_solve
        labels = {id(s): i for i, s in enumerate(solver._pool.slots)}
        local = self.local

        def part_solve(slot, *a):
            local.slot = labels[id(slot)]
            try:
                return solve(slot, *a)
            finally:
                local.slot = None

        solver._part_solve = part_solve

    def __call__(self, kind):
        slot = getattr(self.local, "slot", None)
        if kind == "dispatch" and slot is not None:
            self.injector.fire(f"device.dispatch.slot{slot}")
        else:
            self.injector.fire(f"device.{kind}")


def p14_run(solver, nodes, usage, windows):
    """Serve `windows` in pipelined pairs (two dispatches, then both
    fetches), committing each fetched window's gangs into `usage` as the
    extender's reservations would. A build that must drain (a device fault
    dropped the pipeline) first fetches and commits the windows in flight,
    then retries. Returns (decisions per window, the dispatched handles,
    pair wall times in ms ending in a synchronise)."""
    import torch

    from spark_scheduler_tpu_torch.core.solver import PipelineDrainRequired

    decisions, handles, pair_ms = [], [], []
    on_card = solver.device.type == "cuda"

    def fetch(pending):
        for w, h in pending:
            got = solver.pack_window_fetch(h)
            decisions.append(got)
            commit(usage, solver.registry, w, got)
        pending.clear()

    for i in range(0, len(windows), 2):
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        pending = []
        for w in windows[i:i + 2]:
            while True:
                try:
                    t = solver.build_tensors_pipelined(nodes, usage, {})
                    break
                except PipelineDrainRequired:
                    fetch(pending)
            h = solver.pack_window_dispatch("tightly-pack", t, w)
            handles.append(h)
            pending.append((w, h))
        fetch(pending)
        if on_card:
            torch.cuda.synchronize()
        pair_ms.append((time.perf_counter() - t0) * 1e3)
    return decisions, handles, pair_ms


def p14_launched(handle) -> int:
    """Row-walk launches a pooled dispatch made: one a live segment of
    every part whose solve ran (a part that died at its launch made
    none), and again for each part re-dispatched on a survivor."""
    if handle.parts is None:
        return 0 if handle.greedy else len(handle.requests)
    ran = sum(len(p.requests) for p in handle.parts
              if p.future.exception() is None)
    return ran + sum(len(p.requests) for p in handle.parts
                     if p.future.exception() is not None
                     and handle.request_device[p.req_ids[0]] != p.slot.label)


def run_pool_phase(device, card, n_nodes=N_MAIN):
    """Phase 14 (a)-(d): the device pool at the solver level (see the
    module docstring). Returns the main path's row-walk and probe launches
    (the pooled and faulted solvers', not the comparison solvers')."""
    import torch

    from spark_scheduler_tpu_torch.core.solver import PlacementSolver
    from spark_scheduler_tpu_torch.faults import (
        DegradedModeController,
        FaultInjector,
        FaultPlan,
        FaultSpec,
    )
    from spark_scheduler_tpu_torch.ops.probe import probe_add_one
    from spark_scheduler_tpu_torch.ops.window import window_pack

    on_card = torch.device(device).type == "cuda"
    nodes, usage0 = main_cluster(seed=7)
    nodes, usage0 = nodes[:n_nodes], usage0[:n_nodes]
    names = [nd.name for nd in nodes]
    groups = p14_groups(names)
    rng = np.random.default_rng(14)
    windows = [p14_window(rng, groups, P14_WINDOW) for _ in range(P14_WINDOWS)]
    pool_devices = [device, device]
    main = {"window": 0, "probe": 0}

    def counted(fn):
        w0, p0 = window_pack.launches, probe_add_one.launches
        out = fn()
        main["window"] += window_pack.launches - w0
        main["probe"] += probe_add_one.launches - p0
        return out, window_pack.launches - w0, probe_add_one.launches - p0

    # (a) two slots on one card against a pool-less cuda and a cpu solver.
    pooled = PlacementSolver(device=device, pool_devices=pool_devices)
    check(pooled.pool_size == 2, f"phase 14: pool of {pooled.pool_size}")
    occupancy = []
    (got, handles, pooled_ms), w_launched, probes = counted(lambda: p14_run(
        pooled, nodes, usage0.copy(), windows))
    for h in handles:
        occupancy.append(len({p.slot.label for p in h.parts}) / pooled.pool_size)
    w0 = window_pack.launches
    flat, _, flat_ms = p14_run(PlacementSolver(device=device), nodes,
                               usage0.copy(), windows)
    flat_launches = window_pack.launches - w0
    cpu_solver = PlacementSolver(device="cpu")
    t0 = time.perf_counter()
    want, _, _ = p14_run(cpu_solver, nodes, usage0.copy(), windows)
    cpu_s = time.perf_counter() - t0
    for i, (g, f, w) in enumerate(zip(got, flat, want)):
        check(g == w and f == w, f"phase 14 (a): window {i}: the pooled, "
                                 "pool-less and cpu decisions differ")
    parts = [len(h.parts) for h in handles]
    check(all(h.info["path"] == "pool" for h in handles) and min(parts) > 1,
          f"phase 14 (a): windows not partitioned: {parts}")
    want_launches = sum(p14_launched(h) for h in handles)
    if on_card:
        check(w_launched == want_launches,
              f"phase 14 (a): {w_launched} row-walk launches for "
              f"{want_launches} live segments of the parts")
        check(probes == 1, f"phase 14 (a): {probes} probe launches")
    fault_free(pooled, "14 (a)")
    uploads = {label: {k: v[k] for k in ("full", "delta", "reuse")}
               for label, v in pooled.device_pool_stats().items()}
    admitted = sum(d.admitted for w in got for d in w)
    p50 = lambda xs: float(np.percentile([x / 2 for x in xs[1:]], 50))  # noqa: E731
    pooled_p50 = p50(pooled_ms)
    print(f"phase 14 (a) ({card}): {len(windows)} windows of {P14_WINDOW} "
          f"requests over {P14_GROUPS} instance groups of {len(groups[0])} "
          f"nodes, in pipelined pairs, on 2 slots of {device}: every window "
          f"partitioned ({min(parts)}-{max(parts)} parts), {admitted} gangs "
          f"admitted, decisions equal to the pool-less cuda and the cpu "
          f"solvers'; row-walk launches {w_launched} = {want_launches} live "
          f"segments of the parts (pool-less: {flat_launches}); per-slot "
          f"statics uploads {uploads}, slots busy a dispatch {np.mean(occupancy):.2f}; window p50 "
          f"pooled {pooled_p50:.3f} ms against pool-less "
          f"{p50(flat_ms):.3f} ms (host clock ending in a synchronise, pair "
          f"0 untimed); the cpu solver {cpu_s:.1f} s", flush=True)

    # (b) slot 1 killed mid-burst, re-dispatched, then reinstated by the
    # probe kernel after the probe interval on an injected clock.
    clock = ManualClock(1000.0)
    pooled_b = PlacementSolver(device=device, pool_devices=pool_devices,
                               quarantine_probe_s=5.0)
    pooled_b._clock = clock
    # The host clock at the first quarantine and the first reinstatement.
    marks = {}
    on_slot_event = pooled_b._on_slot_event

    def mark_slot_event(event, label):
        marks.setdefault(event, time.perf_counter())
        on_slot_event(event, label)

    pooled_b._on_slot_event = mark_slot_event
    plan = FaultPlan(seed=0, name="slot1-kill", specs=[FaultSpec(
        surface="device.dispatch.slot1", mode="error", at=[P14_KILL_AT],
        limit=1)])
    half = len(windows) // 2
    usage_b = usage0.copy()

    from spark_scheduler_tpu_torch.core import solver as solver_mod

    with FaultInjector(plan) as inj:
        target = SlotTarget(pooled_b, inj)
        prior = solver_mod._DEVICE_SHIM
        solver_mod.set_device_shim(target)
        try:
            (got_b1, handles_b1, _), w_b1, p_b1 = counted(lambda: p14_run(
                pooled_b, nodes, usage_b, windows[:half]))
        finally:
            solver_mod.set_device_shim(prior)
        fired = inj.schedule()
    health = pooled_b.device_health()
    check(len(fired) == 1 and health["healthy"] == 1
          and health["quarantined"] == [pooled_b._pool.slots[1].label],
          f"phase 14 (b): fired {fired}, health {health}")
    check(pooled_b.redispatch_count >= 1, "phase 14 (b): no re-dispatch")
    clock.advance(5.0)
    (got_b2, handles_b2, _), w_b2, p_b2 = counted(lambda: p14_run(
        pooled_b, nodes, usage_b, windows[half:]))
    check(pooled_b.device_health()["healthy"] == 2
          and {"quarantine", "reinstate"} <= set(marks),
          f"phase 14 (b): slot 1 not reinstated: {pooled_b.device_health()}")
    reinstated_s = marks["reinstate"] - marks["quarantine"]
    served = {p.slot.label for h in handles_b2 for p in h.parts}
    check(pooled_b._pool.slots[1].label in served,
          "phase 14 (b): the reinstated slot served nothing")
    for i, (g, w) in enumerate(zip(got_b1 + got_b2, want)):
        check(g == w, f"phase 14 (b): window {i} differs from the cpu solver's")
    want_b = sum(p14_launched(h) for h in handles_b1 + handles_b2)
    if on_card:
        check(w_b1 + w_b2 == want_b,
              f"phase 14 (b): {w_b1 + w_b2} row-walk launches for {want_b}")
        check(p_b1 + p_b2 == 2, f"phase 14 (b): {p_b1 + p_b2} probe launches "
                                "(first solve, reinstatement)")
    print(f"phase 14 (b) ({card}): slot 1 killed at its part solve "
          f"{P14_KILL_AT} (FaultInjector device.dispatch.slot1): 1 "
          f"quarantine, {pooled_b.redispatch_count} part(s) re-dispatched on "
          f"slot 0, all {len(windows)} windows equal to the cpu solver's; "
          f"after the 5 s probe interval (injected clock) the probe kernel "
          f"reinstated slot 1 at the first dispatch after it and the slot "
          f"served again; quarantine to reinstatement "
          f"{reinstated_s * 1e3:.1f} ms host clock (the windows served in "
          f"between, then the probe)", flush=True)

    # (c) every slot killed for two windows: the host greedy serves them.
    clock_c = ManualClock(1000.0)
    pooled_c = PlacementSolver(device=device, pool_devices=pool_devices)
    pooled_c._clock = clock_c
    pooled_c.degraded = DegradedModeController(policy="greedy", clock=clock_c)
    usage_c = usage0.copy()
    (got_c0, h_c0, _), w_c0, p_c0 = counted(lambda: p14_run(
        pooled_c, nodes, usage_c, windows[:2]))
    kill_all = FaultPlan(seed=0, name="pool-down", specs=[FaultSpec(
        surface="device.dispatch", mode="partition")])
    with FaultInjector(kill_all) as inj:
        inj.install_device()
        t0 = time.perf_counter()
        (got_c1, h_c1, _), w_c1, p_c1 = counted(lambda: p14_run(
            pooled_c, nodes, usage_c, windows[2:4]))
        greedy_ms = (time.perf_counter() - t0) * 1e3 / 2
    snap = pooled_c.degraded.snapshot()
    check(snap["active"] and snap["engagements"] == 1
          and snap["fallback_decisions"] == 2 * P14_WINDOW,
          f"phase 14 (c): degraded {snap}")
    check(pooled_c.device_health()["healthy"] == 0, "phase 14 (c): a slot "
                                                    "survived the kill")
    clock_c.advance(5.0)
    (got_c2, h_c2, _), w_c2, p_c2 = counted(lambda: p14_run(
        pooled_c, nodes, usage_c, windows[4:6]))
    snap2 = pooled_c.degraded.snapshot()
    check(not snap2["active"] and snap2["engagements"] == 1,
          f"phase 14 (c): degraded after reinstatement {snap2}")
    for i, (g, w) in enumerate(zip(got_c0 + got_c1 + got_c2, want)):
        check(g == w, f"phase 14 (c): window {i} differs from the cpu solver's")
    want_c = sum(p14_launched(h) for h in h_c0 + h_c1 + h_c2)
    if on_card:
        check(w_c0 + w_c1 + w_c2 == want_c,
              f"phase 14 (c): {w_c0 + w_c1 + w_c2} row-walk launches for "
              f"{want_c}")
        check(p_c0 + p_c1 + p_c2 == 3, f"phase 14 (c): probe launches "
                                       f"{p_c0 + p_c1 + p_c2}")
    print(f"phase 14 (c) ({card}): both slots killed for windows 3-4: "
          f"degraded mode engaged once, the host greedy made "
          f"{snap['fallback_decisions']} decisions, equal to the cpu "
          f"solver's; {greedy_ms:.1f} ms a greedy window (host clock) against "
          f"(a)'s pooled window p50 on the card {pooled_p50:.1f} ms; the "
          f"probe reinstated both slots and cleared degraded mode",
          flush=True)

    # (d) no pool: one injected h2d fault serves one window on the greedy.
    flat_d = PlacementSolver(device=device)
    flat_d.degraded = DegradedModeController(policy="greedy")
    one = FaultPlan(seed=0, name="h2d-once", specs=[FaultSpec(
        surface="device.h2d", mode="error", at=[0], limit=1)])
    with FaultInjector(one) as inj:
        inj.install_device()
        (got_d, h_d, _), w_d, p_d = counted(lambda: p14_run(
            flat_d, nodes, usage0.copy(), windows[:2]))
    snap_d = flat_d.degraded.snapshot()
    check([h.greedy for h in h_d] == [True, False],
          f"phase 14 (d): greedy handles {[h.greedy for h in h_d]}")
    check(snap_d["engagements"] == 1 and not snap_d["active"]
          and snap_d["fallback_decisions"] == P14_WINDOW,
          f"phase 14 (d): degraded {snap_d}")
    for i, (g, w) in enumerate(zip(got_d, want)):
        check(g == w, f"phase 14 (d): window {i} differs from the cpu solver's")
    if on_card:
        check(w_d == P14_WINDOW and p_d == 1,
              f"phase 14 (d): launches {w_d} row walk, {p_d} probe")
    print(f"phase 14 (d) ({card}): pool-less cuda solver, one injected h2d "
          f"fault: window 1 served on the host greedy, window 2 on the card "
          f"cleared degraded mode; decisions equal to the cpu solver's",
          flush=True)
    return main


def p14_pod_json(app_id, group, created):
    pod = k8s_spark_pod_json(app_id, "driver", f"{app_id}-driver",
                             int(app_id.rsplit("-", 1)[1]) % 7 + 2, created)
    pod["spec"]["nodeSelector"] = {EXT_IG_LABEL: group}
    return pod


def run_pool_server_phase(device, card, policy, n_drivers=P14_DRIVERS,
                          n_clients=P14_CLIENTS, n_nodes=N_MAIN):
    """Phase 14 (e): phase 7's app on `solver.device-pool: 2` (two slots of
    `device`), `server.degraded-mode: policy`, four instance groups. The
    first half of the drivers are served on the pool; then every slot is
    killed and the second half posted; then the fault ends, a forced probe
    reinstates the slots and 8 more drivers are served. Returns the
    launches (row walk, probe)."""
    import dataclasses

    import torch

    from spark_scheduler_tpu_torch.faults import FaultInjector, FaultPlan, FaultSpec
    from spark_scheduler_tpu_torch.models.kube import Container, Pod
    from spark_scheduler_tpu_torch.models.resources import Resources
    from spark_scheduler_tpu_torch.ops.probe import probe_add_one
    from spark_scheduler_tpu_torch.ops.window import window_pack
    from spark_scheduler_tpu_torch.server.app import build_scheduler_app
    from spark_scheduler_tpu_torch.server.config import InstallConfig
    from spark_scheduler_tpu_torch.testing.harness import overcommit_violations

    on_card = torch.device(device).type == "cuda"
    config = InstallConfig(
        fifo=True, binpack_algo="tightly-pack",
        instance_group_label=EXT_IG_LABEL, sync_writes=True,
        debug_routes=True, solver_device_pool=2, degraded_mode=policy,
        degraded_retry_after_s=7.0,
    )

    def factory(backend, registry, metrics):
        app = build_scheduler_app(backend, config, metrics=metrics,
                                  clock=lambda: EXT_CLOCK, device=device,
                                  pool_devices=[device, device])
        return app, None

    w0, p0 = window_pack.launches, probe_add_one.launches
    srv = RecordedServer(device, config, app_factory=factory)
    port = srv.server.port
    label = f"phase 14 (e) {policy}"
    try:
        check(srv.app.solver.pool_size == 2, f"{label}: pool "
                                             f"{srv.app.solver.pool_size}")
        nodes, usage = main_cluster(seed=7)
        nodes, usage = nodes[:n_nodes], usage[:n_nodes]
        names = [nd.name for nd in nodes]
        groups = p14_groups(names)
        for g, members in enumerate(groups):
            for name in members:
                nodes[names.index(name)].labels[EXT_IG_LABEL] = f"group-{g}"
        # Readiness turns 200 with the first nodes through the routes.
        run_clients(port, [[("PUT", "/state/nodes", k8s_node_json(nd))]
                           for nd in nodes[:SRV_ROUTE_NODES]], 1)
        for i, node in enumerate(nodes):
            if i >= SRV_ROUTE_NODES:
                srv.backend.add_node(node)
            srv.backend.add_pod(Pod(
                name=f"base-{i:05d}", namespace="other", uid=f"uid-base-{i:05d}",
                scheduler_name="default-scheduler", node_name=node.name,
                phase="Running",
                containers=[Container(requests=Resources(*map(int, usage[i])))],
            ))

        def jobs(lo, hi):
            out = []
            for i in range(lo, hi):
                g = i % P14_GROUPS
                pod = p14_pod_json(f"p14-{policy}-{i:03d}", f"group-{g}",
                                   EXT_CLOCK - 500 + i)
                out.append([("PUT", "/state/pods", pod),
                            ("POST", "/predicates",
                             {"Pod": pod, "NodeNames": groups[g]})])
            return out

        half = n_drivers // 2
        got, lat = run_clients(port, jobs(0, half), n_clients)
        check(all(st == 200 for st, _ in got.values()),
              f"{label}: a healthy driver was refused")
        check(srv.app.solver.window_path_counts.get("pool", 0) > 0,
              f"{label}: no window served on the pool")
        kill_all = FaultPlan(seed=0, name="pool-down", specs=[FaultSpec(
            surface="device.dispatch", mode="partition")])
        with FaultInjector(kill_all) as inj:
            inj.install_device()
            got2, lat2 = run_clients(port, jobs(half, n_drivers - 1), n_clients)
            # One more, by hand, for its headers.
            last = jobs(n_drivers - 1, n_drivers)[0]
            run_clients(port, [last[:1]], 1)
            status, headers, body = post_raw(port, last[1][2])
            got2[last[1][2]["Pod"]["metadata"]["name"]] = (status, body)
            ready = http_get(port, "/status/readiness")
            state = json.loads(http_get(port, "/debug/state")[1])
        faults = state.get("faults", {})
        check(faults.get("device", {}).get("healthy") == 0
              and faults.get("degraded", {}).get("active"),
              f"{label}: /debug/state faults {faults}")
        if policy == "shed":
            check(all(st == 503 for st, _ in got2.values()),
                  f"{label}: {sorted({st for st, _ in got2.values()})} "
                  "where every driver must be shed")
            check(all(json.loads(body).get("degraded") for _, body in got2.values()),
                  f"{label}: a shed body without degraded")
            check(ready[0] == 503 and json.loads(ready[1])["degraded"],
                  f"{label}: readiness {ready}")
            check(headers.get("Retry-After") == "7",
                  f"{label}: Retry-After {headers.get('Retry-After')}")
        else:
            check(all(st == 200 for st, _ in got2.values()),
                  f"{label}: a degraded driver was refused")
            body = json.loads(ready[1])
            check(ready[0] == 200 and body["degraded"] and body["policy"] == "greedy",
                  f"{label}: readiness {ready}")
            got.update(got2)
        # The fault ends: a forced probe reinstates both slots.
        reinstated = srv.app.solver.probe_quarantined(force=True)
        check(reinstated == 2, f"{label}: {reinstated} slots reinstated")
        got3, _ = run_clients(port, jobs(n_drivers, n_drivers + 8), n_clients)
        check(all(st == 200 for st, _ in got3.values()),
              f"{label}: a driver after the recovery was refused")
        got.update(got3)
        ready2 = http_get(port, "/status/readiness")
        check(ready2 == (200, b'{"ready": true}'), f"{label}: readiness after "
                                                   f"the recovery {ready2}")
        if policy == "greedy":
            server_checks(srv, label, on_card, healthy=False)
        else:
            # A shed window records no decision: only the over-commit and
            # solo-pack checks apply.
            violations = overcommit_violations(srv.app, srv.backend)
            check(not violations, f"{label} over-commit: {violations[:8]}")
            check(srv.solo_packs["other"] == 0, f"{label}: solo packs off "
                                                 "the batcher thread")
        snap = srv.app.solver.degraded.snapshot()
    finally:
        srv.server.stop()
    launches = {"window": window_pack.launches - w0,
                "probe": probe_add_one.launches - p0}
    if policy == "greedy":
        compared = replay_server_log(
            srv.log, dataclasses.replace(config, solver_device_pool=1), got,
            label=label, skip_drains=True)
        check(compared == len(got), f"{label}: compared {compared} of "
                                    f"{len(got)} responses")
    print(f"{label} ({card}): {len(groups)} instance groups, {n_clients} "
          f"clients; {half} drivers on the pool, {n_drivers - half} with every "
          f"slot killed ({'503 Retry-After 7, readiness 503' if policy == 'shed' else 'served on the host greedy, readiness 200 degraded'}), "
          f"8 after the probe reinstated both slots; degraded engagements "
          f"{snap['engagements']}, fallback decisions "
          f"{snap['fallback_decisions']}, sheds {snap['shed_requests']}"
          + (f"; every body equal to a cpu replay ({len(got)})"
             if policy == "greedy" else ""), flush=True)
    return launches


def post_raw(port, payload):
    """(status, headers, body) of one POST /predicates."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    conn.request("POST", "/predicates", body=json.dumps(payload).encode(),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = (resp.status, dict(resp.getheaders()), resp.read())
    conn.close()
    return out


# ---------------------------------------------------------------- phase 15

P15_DRIVERS = 64  # cut from 128 to hold phase 15 near 90 s of the limit
P15_CLIENTS = 16
P15_ARMS = ("tightly-pack", "distribute-evenly", "minimal-fragmentation",
            "single-az-tightly-pack")
P15_STACK_REQUESTS = 8
P15_CLUSTERS = 3
P15_FLEET_DRIVERS = 24
P15_FLEET_CLIENTS = 6
P15_SMALL_NODES = 8  # the spill group's nodes in cluster 0 (2 CPU, 4 Gi)


class SolverTap:
    """While open, counts what every PlacementSolver does: the live
    segments of each window dispatch and the solo packs of `cuda` solvers
    (one row-walk launch each) and the solvers themselves, for
    `fault_free`."""

    def __init__(self):
        import threading

        from spark_scheduler_tpu_torch.core.solver import PlacementSolver

        self.cls = PlacementSolver
        self.solo = 0
        self.handles: list = []
        self.solvers: list = []
        self._mu = threading.Lock()

    @property
    def segments(self) -> int:
        """Live segments of the `cuda` dispatches, and again those of each
        full re-solve after an escalation (known once fetched)."""
        return sum(dispatch_segments(h) for h in self.handles)

    def _seen(self, solver):
        if all(s is not solver for s in self.solvers):
            self.solvers.append(solver)

    def __enter__(self):
        cls, tap = self.cls, self
        dispatch, pack = cls.pack_window_dispatch, cls.pack
        self._orig = (dispatch, pack)

        def pack_window_dispatch(solver, *a, **kw):
            h = dispatch(solver, *a, **kw)
            with tap._mu:
                tap._seen(solver)
                if solver.device.type == "cuda":
                    tap.handles.append(h)
            return h

        def solo_pack(solver, *a, **kw):
            with tap._mu:
                tap._seen(solver)
                if solver.device.type == "cuda":
                    tap.solo += 1
            return pack(solver, *a, **kw)

        cls.pack_window_dispatch, cls.pack = pack_window_dispatch, solo_pack
        return self

    def __exit__(self, *exc):
        self.cls.pack_window_dispatch, self.cls.pack = self._orig

    def check(self, label, launches, on_card):
        for s in self.solvers:
            fault_free(s, 15)
        if on_card:
            check(launches == self.segments + self.solo,
                  f"{label}: row-walk launches {launches} != "
                  f"{self.segments} live segments + {self.solo} solo packs")


def p15_capture(device, card, path, n_nodes, n_drivers, n_clients):
    """Phase 15 (a): phase 7's cluster behind the port's server with
    `trace.path` and the flight recorder; drivers with churn mid-window,
    then the executors. Returns (decisions, stats)."""
    import copy
    import threading

    from spark_scheduler_tpu_torch.metrics import MetricRegistry, SchedulerMetrics
    from spark_scheduler_tpu_torch.models.kube import Container, Pod
    from spark_scheduler_tpu_torch.models.resources import Resources
    from spark_scheduler_tpu_torch.server.app import build_scheduler_app
    from spark_scheduler_tpu_torch.server.config import InstallConfig
    from spark_scheduler_tpu_torch.server.http import SchedulerHTTPServer
    from spark_scheduler_tpu_torch.store.backend import DEMAND_CRD, InMemoryBackend
    from spark_scheduler_tpu_torch.testing.harness import overcommit_violations

    config = InstallConfig(
        fifo=True, binpack_algo="tightly-pack",
        instance_group_label=EXT_IG_LABEL, sync_writes=True,
        debug_routes=True, flight_recorder=True, trace_path=path,
    )
    backend = InMemoryBackend()
    backend.register_crd(DEMAND_CRD)
    registry = MetricRegistry()
    app = build_scheduler_app(
        backend, config, metrics=SchedulerMetrics(registry, EXT_IG_LABEL),
        clock=lambda: EXT_CLOCK, device=device,
    )
    server = SchedulerHTTPServer(app, registry, host="127.0.0.1", port=0,
                                 debug_routes=True)
    server.start()
    port = server.port
    try:
        nodes, usage = main_cluster(seed=7)
        nodes, usage = nodes[:n_nodes], usage[:n_nodes]
        for node in nodes:
            node.labels[EXT_IG_LABEL] = EXT_IG
        names = [n.name for n in nodes]
        run_clients(port, [[("PUT", "/state/nodes", k8s_node_json(nd))]
                           for nd in nodes[:SRV_ROUTE_NODES]], 1)
        for i, node in enumerate(nodes):
            if i >= SRV_ROUTE_NODES:
                backend.add_node(node)
            backend.add_pod(Pod(
                name=f"base-{i:05d}", namespace="other", uid=f"uid-base-{i:05d}",
                scheduler_name="default-scheduler", node_name=node.name,
                phase="Running",
                containers=[Container(requests=Resources(*map(int, usage[i])))],
            ))
        rng = np.random.default_rng(29)
        apps = []
        for i in range(n_drivers):
            n_exec = 32 if rng.random() < 0.15 else int(rng.integers(2, 9))
            apps.append((f"p15-{i:03d}", n_exec, EXT_CLOCK - 500 + i))
        extra = copy.deepcopy(nodes[0])
        extra.name = f"node-{n_nodes:05d}"
        churned = threading.Event()
        # The candidate list a client sends: every node, in the order they
        # joined (as kube-scheduler's node lister keeps it), so the trace
        # stores "*" instead of the names.
        current = {"names": names}

        def churn():
            run_clients(port, [[
                ("DELETE", "/state/pods/other/base-00001", None),
                ("PUT", "/state/nodes", k8s_node_json(extra))]], 1)
            current["names"] = names + [extra.name]

        def driver_job(k, app_id, n_exec, created):
            pod = k8s_spark_pod_json(app_id, "driver", f"{app_id}-driver",
                                     n_exec, created)

            def job(send):
                send("PUT", "/state/pods", pod)
                send("POST", "/predicates",
                     {"Pod": pod, "NodeNames": current["names"]})
                # Churn mid-window: a pod DELETE and a node PUT from another
                # connection while the other clients' windows are in flight.
                if k == n_drivers // 3 and not churned.is_set():
                    churned.set()
                    churn()
            return job

        t0 = time.perf_counter()
        got, lat = run_clients(
            port, [driver_job(k, *a) for k, a in enumerate(apps)], n_clients)
        t_drivers = time.perf_counter() - t0
        check(churned.is_set(), "phase 15 (a): the churn never ran")
        check(all(st == 200 for st, _ in got.values()),
              "phase 15 (a): a driver was refused")
        admitted = {}
        for app_id, n_exec, created in apps:
            body = json.loads(got[f"{app_id}-driver"][1])
            if body.get("NodeNames"):
                admitted[app_id] = (body["NodeNames"][0], n_exec, created)
        check(admitted, "phase 15 (a): no driver admitted")

        def exec_job(app_id, node, n_exec, created):
            pod = k8s_spark_pod_json(app_id, "driver", f"{app_id}-driver",
                                     n_exec, created)
            bound = dict(pod, spec=dict(pod["spec"], nodeName=node),
                         status={"phase": "Running"})
            out = [("PUT", "/state/pods", bound)]
            for e in range(n_exec):
                ex = k8s_spark_pod_json(app_id, "executor",
                                        f"{app_id}-exec-{e}", n_exec, created)
                out += [("PUT", "/state/pods", ex),
                        ("POST", "/predicates",
                         {"Pod": ex, "NodeNames": current["names"]})]
            return out

        t0 = time.perf_counter()
        got_e, lat_e = run_clients(
            port, [exec_job(a, *v) for a, v in sorted(admitted.items())],
            n_clients)
        t_execs = time.perf_counter() - t0
        check(all(st == 200 for st, _ in got_e.values()),
              "phase 15 (a): an executor was refused")
        status, body = http_get(port, "/debug/trace")
        check(status == 200, f"phase 15 (a): /debug/trace {status}")
        trace_stats = json.loads(body)
        violations = overcommit_violations(app, backend)
        check(not violations, f"phase 15 (a) over-commit: {violations[:8]}")
        fault_free(app.solver, 15)
    finally:
        server.stop()
    stats = {
        "drivers": len(apps), "admitted": len(admitted),
        "executors": len(got_e), "events": trace_stats["events"],
        "bytes": trace_stats["bytes"], "windows": trace_stats["windows"],
        "write_errors": trace_stats["write_errors"],
        "drivers_s": t_drivers, "executors_s": t_execs,
        "driver_p50": pctl(lat, 50), "driver_p99": pctl(lat, 99),
    }
    check(stats["write_errors"] == 0, "phase 15 (a): trace write errors")
    return {**got, **got_e}, stats


def p15_stacked(device, card, n_nodes, n_requests=P15_STACK_REQUESTS):
    """Phase 15 (e): `arm_stacked_fifo_pack` (4 arms over one cluster) and
    `bucket_stacked_fifo_pack` (3 different clusters, one bucket) on
    `device`, each member against `window_pack` (the row walk on the card)
    and the `cpu` plain path. Comparison launches are not main-path
    launches. Returns the timings (CUDA events on the card)."""
    import dataclasses

    import torch

    from spark_scheduler_tpu_torch.core.solver import PlacementSolver, WindowRequest
    from spark_scheduler_tpu_torch.models.cluster import cluster_statics, pad_bucket
    from spark_scheduler_tpu_torch.models.resources import Resources
    from spark_scheduler_tpu_torch.ops.batched import (
        arm_stacked_fifo_pack,
        bucket_stacked_fifo_pack,
        pad_app_batch,
        stack_app_batches,
    )
    from spark_scheduler_tpu_torch.ops.window import window_pack

    on_card = torch.device(device).type == "cuda"
    rng = np.random.default_rng(31)

    def cluster(seed):
        nodes, usage = main_cluster(seed=seed)
        nodes, usage = nodes[:n_nodes], usage[:n_nodes]
        solver = PlacementSolver(device=device)
        usage_map = {nd.name: Resources(*map(int, usage[i]))
                     for i, nd in enumerate(nodes)}
        return solver, solver.build_tensors(nodes, usage_map, {}), nodes

    def requests(nodes):
        names = [nd.name for nd in nodes]
        out = []
        for _ in range(n_requests):
            rows = []
            for _ in range(int(rng.integers(0, 3))):
                rows.append((Resources(1000, 2 << 20, 0),
                             Resources(2000, 4 << 20, 0),
                             int(rng.integers(2, 9)), bool(rng.random() < 0.3)))
            n_exec = 32 if rng.random() < 0.15 else int(rng.integers(2, 9))
            rows.append((Resources(1000, 2 << 20, 0),
                         Resources(2000, 4 << 20, 0), n_exec, False))
            out.append(WindowRequest(rows=rows, driver_candidate_names=names))
        return out

    def row_walk(solver, tensors, rows, fill):
        batch = solver._layout(rows)
        meta, execs, after = window_pack(tensors, batch.win, fill=fill,
                                         emax=rows.emax,
                                         num_zones=rows.num_zones)
        blob = torch.cat([meta[:, :, :3], execs], dim=2)
        s, r = batch.seg_map
        return blob[torch.as_tensor(s), torch.as_tensor(r)], after

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def timed(fn):
        if on_card:
            return cuda_time_ms(fn, 3)
        return timed_ms(fn)[1]

    w0 = window_pack.launches
    # (e1) 4 arms over one cluster: per-arm availability differs by a
    # different debit of the same usage.
    solver, tensors, nodes = cluster(7)
    rows = solver._window_rows(tensors, requests(nodes))
    b = len(rows.skip_arr)
    apps = solver.window_app_batch(rows, pad_bucket(b, 8))
    fills = tuple(sorted(P15_ARMS))
    arm_avail = torch.stack([
        tensors.available - int(i) * (tensors.available > 0).to(torch.int32)
        for i in range(len(fills))
    ])
    statics = cluster_statics(tensors)
    blob, after = arm_stacked_fifo_pack(arm_avail, statics, apps, fills=fills,
                                        emax=rows.emax, num_zones=rows.num_zones)
    cpu_stat = tuple(x.cpu() for x in statics)
    cblob, cafter = arm_stacked_fifo_pack(arm_avail.cpu(), cpu_stat, apps,
                                          fills=fills, emax=rows.emax,
                                          num_zones=rows.num_zones)
    check(torch.equal(blob.cpu(), cblob) and torch.equal(after.cpu(), cafter),
          "phase 15 (e): arm stack on the card != the cpu plain path")
    for i, fill in enumerate(fills):
        arm_t = dataclasses.replace(tensors, available=arm_avail[i].clone())
        want, want_after = row_walk(solver, arm_t, rows, fill)
        check(torch.equal(blob[i, :b].cpu(), want.cpu())
              and torch.equal(after[i].cpu(), want_after.cpu()),
              f"phase 15 (e): arm {fill} != the row walk")
    arm_ms = timed(lambda: arm_stacked_fifo_pack(
        arm_avail, statics, apps, fills=fills, emax=rows.emax,
        num_zones=rows.num_zones))
    arm_walk_ms = timed(lambda: [row_walk(
        solver, dataclasses.replace(tensors, available=arm_avail[i]), rows, f)
        for i, f in enumerate(fills)])
    solver.close()
    # (e2) 3 different clusters padded to one bucket.
    members = []
    for seed, fill in ((11, "tightly-pack"), (12, "distribute-evenly"),
                       (13, "tightly-pack")):
        s, t, nds = cluster(seed)
        r = s._window_rows(t, requests(nds))
        members.append((s, t, r, fill))
    check(len({(m[1].num_nodes, m[2].emax, m[2].num_zones) for m in members})
          == 1, "phase 15 (e): members differ in bucket")
    members.sort(key=lambda m: m[3])
    b_rows = [len(m[2].skip_arr) for m in members]
    bucket = pad_bucket(max(b_rows), 8)
    host_apps = [m[0].window_app_batch(m[2], bucket) for m in members]
    apps_stack = stack_app_batches([pad_app_batch(a, bucket) for a in host_apps])
    st = tuple(torch.stack([cluster_statics(m[1])[i] for m in members])
               for i in range(len(cluster_statics(members[0][1]))))
    av = torch.stack([m[1].available for m in members])
    bfills = tuple(m[3] for m in members)
    lead = members[0][2]
    bblob, bafter = bucket_stacked_fifo_pack(
        av, st, apps_stack, fills=bfills, emax=lead.emax,
        num_zones=lead.num_zones)
    cbblob, cbafter = bucket_stacked_fifo_pack(
        av.cpu(), tuple(x.cpu() for x in st), apps_stack, fills=bfills,
        emax=lead.emax, num_zones=lead.num_zones)
    check(torch.equal(bblob.cpu(), cbblob) and torch.equal(bafter.cpu(), cbafter),
          "phase 15 (e): bucket stack on the card != the cpu plain path")
    for i, (s, t, r, fill) in enumerate(members):
        want, want_after = row_walk(s, t, r, fill)
        check(torch.equal(bblob[i, :b_rows[i]].cpu(), want.cpu())
              and torch.equal(bafter[i].cpu(), want_after.cpu()),
              f"phase 15 (e): cluster {i} != the row walk")
    bucket_ms = timed(lambda: bucket_stacked_fifo_pack(
        av, st, apps_stack, fills=bfills, emax=lead.emax,
        num_zones=lead.num_zones))
    bucket_walk_ms = timed(lambda: [row_walk(s, t, r, f)
                                   for s, t, r, f in members])
    for m in members:
        m[0].close()
    sync()
    out = {"arm_ms": arm_ms, "arm_row_walk_ms": arm_walk_ms,
           "bucket_ms": bucket_ms, "bucket_row_walk_ms": bucket_walk_ms,
           "arm_rows": b, "bucket_rows": b_rows,
           "comparison_launches": window_pack.launches - w0}
    print(f"phase 15 (e) ({card}): arm_stacked_fifo_pack M={len(fills)} over "
          f"one {n_nodes}-node cluster ({b} rows, bucket {apps.driver_req.shape[0]}) "
          f"and bucket_stacked_fifo_pack M={len(members)} clusters ({b_rows} rows, "
          f"bucket {bucket}) equal to each member's row walk and to the cpu "
          f"plain path; {'CUDA events' if on_card else 'host clock'}: arm stack "
          f"{arm_ms:.2f} ms vs {len(fills)} row walks {arm_walk_ms:.2f} ms, "
          f"bucket stack {bucket_ms:.2f} ms vs {len(members)} row walks "
          f"{bucket_walk_ms:.2f} ms", flush=True)
    return out


def p15_fleet(device, card, n_nodes, n_drivers=P15_FLEET_DRIVERS,
              n_clients=P15_FLEET_CLIENTS):
    """Phase 15 (f): a fleet of 3 clusters of `n_nodes` behind the HTTP
    server (`fleet.enabled`, `max-spillover-hops: 1`, `stack-window-ms: 5`,
    record_ops): cluster-tagged drivers (some forwarded), a spill group
    whose home in cluster 0 is too small so its drivers spill to cluster 1,
    cluster 2 killed mid-run (its placed apps' executors deny, its pending
    app is re-routed) and rejoined; then `verify_cluster_equivalence` on
    the card and on the cpu. Returns stats."""
    import dataclasses

    import torch

    from spark_scheduler_tpu_torch.fleet import FleetFacade, verify_cluster_equivalence
    from spark_scheduler_tpu_torch.metrics import MetricRegistry
    from spark_scheduler_tpu_torch.models.resources import Resources
    from spark_scheduler_tpu_torch.server.config import InstallConfig
    from spark_scheduler_tpu_torch.server.http import SchedulerHTTPServer

    on_card = torch.device(device).type == "cuda"
    # The fleet block from YAML; synchronous write-back (not a YAML key),
    # so each cluster's reservations reach its backend as they are made.
    config = dataclasses.replace(InstallConfig.from_dict({
        "fifo": True, "binpack-algo": "tightly-pack",
        "instance-group-label": EXT_IG_LABEL,
        "fleet": {"enabled": True, "clusters": P15_CLUSTERS,
                  "max-spillover-hops": 1, "stack-window-ms": 5},
    }), sync_writes=True)
    check(config.fleet_enabled and config.fleet_stack_window_ms == 5.0,
          f"phase 15 (f): fleet block {config.fleet_clusters}")
    registry = MetricRegistry()
    t0 = time.perf_counter()
    f = FleetFacade(config.fleet_clusters, config, registry=registry,
                    record_ops=True,
                    max_spillover_hops=config.fleet_max_spillover_hops,
                    device=device)
    groups = {0: "ig-c0", 1: "ig-shared", 2: "ig-c2"}
    for c in range(P15_CLUSTERS):
        nodes, _ = main_cluster(seed=40 + c)
        for i, node in enumerate(nodes[:n_nodes]):
            node.labels[EXT_IG_LABEL] = groups[c]
            if c == 0 and i < P15_SMALL_NODES:
                # The spill group's home in cluster 0: a few small nodes.
                node.labels[EXT_IG_LABEL] = "ig-shared"
                node = dataclasses.replace(
                    node, allocatable=Resources(2000, 4 << 20, 0))
            f.add_node(c, node)
    t_setup = time.perf_counter() - t0
    server = SchedulerHTTPServer(f.stacks[0].app, registry, host="127.0.0.1",
                                 port=0, fleet=f)
    server.start()
    port = server.port
    rng = np.random.default_rng(37)

    def pod(app_id, role, name, n_exec, group, created):
        p = k8s_spark_pod_json(app_id, role, name, n_exec, created)
        p["spec"]["nodeSelector"] = {EXT_IG_LABEL: group}
        return p

    def predicate(p, via):
        path = "/predicates" + (f"?cluster={via}" if via is not None else "")
        return ("POST", path, {"Pod": p, "NodeNames": []})

    try:
        apps = []
        for i in range(n_drivers):
            group = ("ig-c0", "ig-c2", "ig-shared")[i % 3]
            n_exec = 32 if rng.random() < 0.15 else int(rng.integers(2, 9))
            via = int(rng.integers(0, P15_CLUSTERS))  # some are the wrong one
            apps.append((f"f15-{i:03d}", group, n_exec, via,
                         EXT_CLOCK - 900 + i))
        # The spill group's apps are homed on cluster 0, whose 8 small
        # nodes cannot hold their gangs: they spill to cluster 1.
        for app_id, group, *_ in apps:
            if group == "ig-shared":
                f.router.bind(app_id, 0)
        got, lat = run_clients(port, [[predicate(
            pod(a, "driver", f"{a}-driver", n, g, c), via)]
            for a, g, n, via, c in apps], n_clients)
        check(all(st == 200 for st, _ in got.values()),
              "phase 15 (f): a driver was refused")
        placed = {}
        for a, g, n, via, c in apps:
            body = json.loads(got[f"{a}-driver"][1])
            if body.get("NodeNames"):
                placed[a] = (g, n, c)
        spilled = f.spillover.spilled
        check(spilled > 0, "phase 15 (f): no driver spilled over")
        check(f.forwarded > 0, "phase 15 (f): no call was forwarded")
        # A pending app on cluster 2 (a gang no node holds), then the kill.
        big = pod("f15-pending", "driver", "f15-pending-driver", 100000,
                  "ig-c2", EXT_CLOCK - 100)
        run_clients(port, [[predicate(big, 2)]], 1)
        before_kill = f.unavailable_denials
        orphans = f.kill_cluster(2)
        check(orphans >= 1, f"phase 15 (f): {orphans} orphans at the kill")

        def exec_jobs(which, via=None):
            out = []
            for a in which:
                g, n, c = placed[a]
                out.append([predicate(pod(a, "executor", f"{a}-exec-{e}", n,
                                          g, c), via) for e in range(n)])
            return out

        down = [a for a, (g, *_ ) in sorted(placed.items()) if g == "ig-c2"]
        up = [a for a in sorted(placed) if a not in down]
        got_down, _ = run_clients(port, exec_jobs(down[:4]), n_clients)
        denied = f.unavailable_denials - before_kill
        check(denied == len(got_down) > 0,
              f"phase 15 (f): {denied} unavailable denials for "
              f"{len(got_down)} executors of apps placed on the dead cluster")
        check(all(not json.loads(b).get("NodeNames")
                  for _, b in got_down.values()),
              "phase 15 (f): an executor of a dead cluster's app was placed")
        got_up, lat_e = run_clients(port, exec_jobs(up), n_clients)
        run_clients(port, [[predicate(big, None)]], 1)  # the orphan retries
        f.rejoin_cluster(2)
        got_back, _ = run_clients(port, exec_jobs(down[:4]), n_clients)
        check(all(st == 200 for st, _ in
                  list(got_up.values()) + list(got_back.values())),
              "phase 15 (f): an executor was refused")
        status, body = http_get(port, "/debug/fleet")
        check(status == 200, f"phase 15 (f): /debug/fleet {status}")
        fleet_state = json.loads(body)
        check([c["live"] for c in fleet_state["clusters"]] == [True] * 3,
              f"phase 15 (f): /debug/fleet live {fleet_state['clusters']}")
        series = sorted({k.split("[")[0] for k in registry.snapshot()
                         if "scheduler.fleet." in k})
        check(len(series) >= 5, f"phase 15 (f): fleet series {series}")
        stacking = fleet_state["stacking"]
        deferred = sum(s.app.solver.window_path_counts.get("deferred", 0)
                       for s in f.stacks)
        if on_card:
            # `stack-window-ms` is inert on the card: no coordinator, and
            # the row walk serves every window.
            check(stacking == {"enabled": False} and deferred == 0,
                  f"phase 15 (f): stacking on the card: {stacking}, "
                  f"{deferred} windows deferred")
    finally:
        server.stop()
    t0 = time.perf_counter()
    reports = {}
    try:
        for dev in (None, "cpu"):
            reports[str(dev)] = verify_cluster_equivalence(f, device=dev)
            check(all(r["identical"] for r in reports[str(dev)].values()),
                  f"phase 15 (f): verify on {dev}")
    finally:
        f.stop()
    t_verify = time.perf_counter() - t0
    for s in f.stacks:
        fault_free(s.app.solver, 15)
    stats = {
        "setup_s": t_setup, "verify_s": t_verify, "drivers": len(apps),
        "placed": len(placed), "spilled": spilled, "forwarded": f.forwarded,
        "orphans": orphans, "unavailable": f.unavailable_denials,
        "decisions": [r["decisions"] for r in reports["None"].values()],
        "picks": fleet_state["router"]["picks"], "series": len(series),
        # Too few drivers for a p99: the slowest one is reported as such.
        "driver_p50": pctl(lat, 50), "driver_max": float(max(lat)),
        "executor_p50": pctl(lat_e, 50), "stacking": stacking,
    }
    print(f"phase 15 (f) ({card}): {P15_CLUSTERS} clusters x {n_nodes} nodes "
          f"(set up in {t_setup:.1f} s), {len(apps)} drivers over HTTP "
          f"({len(placed)} placed, {f.forwarded} forwarded, {spilled} spilled "
          f"0 -> 1, picks {stats['picks']}), cluster 2 killed "
          f"({orphans} orphan re-routed, {stats['unavailable']} executors "
          f"denied while down) and rejoined; decisions per cluster "
          f"{stats['decisions']} equal to a standalone replay on the card "
          f"({device}) and on the cpu ({t_verify:.1f} s); stacking "
          f"{'on' if stacking['enabled'] else 'off'}, {deferred} deferred, "
          f"{stacking.get('stacked_dispatches', 0)} stacked; "
          f"{len(series)} fleet series; driver p50 {stats['driver_p50']:.1f} "
          f"max {stats['driver_max']:.1f} ms (of {len(lat)}), executor p50 "
          f"{stats['executor_p50']:.1f} ms (client host clock)", flush=True)
    return stats


def run_replay_phase(device, card, n_nodes=N_MAIN, n_drivers=P15_DRIVERS,
                     n_clients=P15_CLIENTS, out_dir=None):
    """Phase 15: trace capture (a), strict replay on `device` and on the
    cpu (b), a what-if (c), a 4-arm sweep (d), the stacked solves (e) and
    the fleet (f). Returns the main-path launches (row walk, probe) of
    (a)-(d) and (f)."""
    import shutil
    import tempfile

    import torch

    from spark_scheduler_tpu_torch.ops.probe import probe_add_one
    from spark_scheduler_tpu_torch.ops.window import window_pack
    from spark_scheduler_tpu_torch.replay import replay_trace, run_sweep, what_if

    on_card = torch.device(device).type == "cuda"
    tmp = tempfile.mkdtemp(prefix="p15-", dir=out_dir)
    path = os.path.join(tmp, "capture.jsonl")
    launches = {"window": 0, "probe": 0}

    def main_path(label, fn):
        window_pack.launches = 0
        probe_add_one.launches = 0
        with SolverTap() as tap:
            out = fn()
        got = {"window": window_pack.launches, "probe": probe_add_one.launches}
        tap.check(label, got["window"], on_card)
        if on_card:
            check(got["probe"] == sum(s.device.type == "cuda"
                                      for s in tap.solvers),
                  f"{label}: probe launches {got['probe']}")
        for k in launches:
            launches[k] += got[k]
        return out, got, tap

    t0 = time.perf_counter()
    (answers, cap), got_a, _ = main_path("phase 15 (a)", lambda: p15_capture(
        device, card, path, n_nodes, n_drivers, n_clients))
    print(f"phase 15 (a) ({card}): {cap['drivers']} drivers "
          f"({cap['admitted']} admitted) and {cap['executors']} executors "
          f"over HTTP on {n_nodes} nodes, churn mid-window; trace "
          f"{cap['events']} events, {cap['bytes']} bytes, {cap['windows']} "
          f"windows, 0 write errors; drivers {cap['drivers_s']:.1f} s "
          f"(p50 {cap['driver_p50']:.1f} ms, p99 {cap['driver_p99']:.1f} ms, "
          f"client host clock), executors {cap['executors_s']:.1f} s; "
          f"row-walk launches {got_a['window']} ({time.perf_counter() - t0:.1f} s)",
          flush=True)

    reps = {}
    for dev in (device, "cpu"):
        t0 = time.perf_counter()
        rep, got_b, tap = main_path(f"phase 15 (b) {dev}", lambda: replay_trace(
            path, strict=True, device=dev))
        check(not rep.mismatches and rep.compared == rep.decisions > 0
              and rep.uncompared_windows == 0 and not rep.malformed
              and rep.overcommit == 0,
              f"phase 15 (b) {dev}: {rep.summary()}")
        check(rep.decisions == len(answers),
              f"phase 15 (b) {dev}: {rep.decisions} decisions for "
              f"{len(answers)} answers")
        if on_card and dev == device:
            check(got_b["window"] == got_a["window"],
                  f"phase 15 (b): replay launches {got_b['window']} != live "
                  f"{got_a['window']}")
        reps[str(dev)] = rep
        print(f"phase 15 (b) ({card}): strict replay on {dev}: "
              f"{rep.decisions} decisions, {rep.compared} compared, 0 "
              f"mismatches, 0 uncompared windows; row-walk launches "
              f"{got_b['window']} = {tap.segments} live segments + {tap.solo} "
              f"solo packs; decision p50 {rep.latency_ms(0.5)} ms p99 "
              f"{rep.latency_ms(0.99)} ms (host clock); "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(reps[str(device)].placements == reps["cpu"].placements,
          "phase 15 (b): card and cpu replays placed differently")

    t0 = time.perf_counter()
    diff, got_c, _ = main_path("phase 15 (c)", lambda: what_if(
        path, {"binpack-algo": "distribute-evenly"}, device=device))
    p = diff["placements"]
    check(diff["base_mismatches"] == 0 and p["same"] + p["changed"] > 0
          and diff["decisions"]["base"] == diff["decisions"]["variant"] > 0
          and p["changed"] > 0,
          f"phase 15 (c): what-if diff {p} {diff['decisions']}")
    print(f"phase 15 (c) ({card}): what-if distribute-evenly: placements "
          f"same {p['same']} changed {p['changed']}, denials delta "
          f"{diff['denials']['delta']}, fragmentation cpu delta "
          f"{diff['fragmentation']['cpu_delta']}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    arms = [{"binpack_algo": a} for a in P15_ARMS]
    sweep, got_d, _ = main_path("phase 15 (d)", lambda: run_sweep(
        path, arms, device=device))
    tel = sweep.telemetry
    check(tel["streams"] == len(arms) and tel["forced_resolves"] == 0,
          f"phase 15 (d): {tel}")
    if on_card:
        check(tel["stacked_dispatches"] == 0 and tel["windows"] == 0,
              f"phase 15 (d): windows deferred on the card: {tel}")
    for arm, rep in zip(arms, sweep.reports):
        seq, _, _ = main_path("phase 15 (d) sequential", lambda: replay_trace(
            path, overrides=arm, device=device))
        check(rep.placements == seq.placements
              and rep.verdict_counts == seq.verdict_counts
              and rep.decision_summary() == seq.decision_summary(),
              f"phase 15 (d): arm {arm} != its sequential replay")
    print(f"phase 15 (d) ({card}): sweep of {len(arms)} arms "
          f"({', '.join(P15_ARMS)}) on one shared stream of events, each "
          f"arm equal to its own sequential replay; stacked dispatches "
          f"{tel['stacked_dispatches']}, shared mask hits "
          f"{tel['shared_build_hits']}, row-walk launches {got_d['window']}; "
          f"denials per arm {[r.denials for r in sweep.reports]}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    stacked = p15_stacked(device, card, n_nodes)
    print(f"phase 15 (e): {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    fleet, got_f, _ = main_path("phase 15 (f)", lambda: p15_fleet(
        device, card, n_nodes))
    print(f"phase 15 (f): row-walk launches {got_f['window']}, probe "
          f"{got_f['probe']}; {time.perf_counter() - t0:.1f} s", flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    return launches, {"capture": cap, "stacked": stacked, "fleet": fleet}


# ------------------------------------------------------------ phase 16

P16_WINDOWS = 16
P16_WINDOW = 16  # cut from 32: the cpu side held ~90 s of the 1,200 s limit
P16_SYNC = 9  # the window before which the pipeline drains and 2 nodes go
P16_BIG_WINDOWS = 8
P16_BIG_WINDOW = 32


def build_block(solver) -> dict:
    """The solver's `build_stats` as /debug/state's `build` block shows
    them (observability/state.py)."""
    block = dict(solver.build_stats)
    block["build_ms_mean"] = round(
        block["build_ms"] / max(int(block["builds"]), 1), 4
    )
    return block


def build_hist(solver) -> dict:
    """p50 / p99 / count of the solver's `solver.build.ms` histogram."""
    from spark_scheduler_tpu_torch.observability.telemetry import BUILD_MS

    st = solver.telemetry.registry.histogram(BUILD_MS).stats()
    return {"p50": st["p50"], "p99": st["p99"], "count": st["count"]}


def with_telemetry(solver):
    from spark_scheduler_tpu_torch.metrics.registry import MetricRegistry
    from spark_scheduler_tpu_torch.observability.telemetry import SolverTelemetry

    solver.telemetry = SolverTelemetry(MetricRegistry())
    return solver


def p16_idle_nodes(side, k):
    """`k` node names no reservation (hard or soft) names, from the end of
    the roster: nodes whose deletion leaves no usage behind."""
    taken = set()
    for rr in side.backend.list("resourcereservations"):
        taken.update(r.node for r in rr.spec.reservations.values())
    for soft in side.ext._rrm.soft_store.get_all_copy().values():
        taken.update(r.node for r in soft.reservations.values())
    return [n for n in reversed(side.names)
            if n not in taken and not n.startswith("node-b16")][:k]


def run_build_extender_arm(device, card, n_windows=P16_WINDOWS,
                           window=P16_WINDOW, n_nodes=N_MAIN, sync=P16_SYNC):
    """Phase 16 (a): the resident build behind the extender at 10,000 nodes
    against the dense build and the cpu (see the module docstring).
    Returns the resident cuda solver's row-walk and probe launches."""
    import torch

    from spark_scheduler_tpu_torch.models.kube import Node, ZONE_LABEL
    from spark_scheduler_tpu_torch.models.resources import Resources
    from spark_scheduler_tpu_torch.ops.probe import probe_add_one
    from spark_scheduler_tpu_torch.ops.window import window_pack

    on_card = torch.device(device).type == "cuda"
    rng = np.random.default_rng(61)
    apps = [
        (f"b16-{i:03d}", 32 if rng.random() < 0.15 else int(rng.integers(2, 9)),
         False)
        for i in range(n_windows * window)
    ]
    t_setup = time.perf_counter()
    window_pack.launches = 0
    probe_add_one.launches = 0
    res = ExtenderSide(device, apps, n_nodes, track_usage=True,
                       build_oracle=True)
    probes_res = probe_add_one.launches
    dense = ExtenderSide(device, apps, n_nodes, track_usage=True,
                         use_native=False)
    cpu = ExtenderSide("cpu", apps, n_nodes, track_usage=True)
    sides = {"resident": res, "dense": dense, "cpu": cpu}
    for s in sides.values():
        with_telemetry(s.solver)
    check(res.solver.uses_native_arena and cpu.solver.uses_native_arena
          and not dense.solver.uses_native_arena,
          "phase 16 (a): the arena sides do not build on the arena")
    print(f"phase 16 (a): three extenders (cuda resident with the build "
          f"oracle, cuda dense, cpu resident) on {len(res.names)} nodes, set "
          f"up in {time.perf_counter() - t_setup:.1f} s", flush=True)

    launches = {"resident": 0, "dense": 0}
    segments = {"resident": 0, "dense": 0}
    window_ms = {k: [] for k in sides}
    events = []
    added = [0]

    def add_node(s, name, zone):
        s.backend.add_node(Node(
            name=name, allocatable=Resources(64_000, 256 << 20, 0),
            labels={ZONE_LABEL: zone, EXT_IG_LABEL: EXT_IG},
        ))
        s.names = s.names + [name]

    def event(w, kind):
        """One churn event, alike on the three sides."""
        for s in sides.values():
            if kind == "pod-delete":
                for j in range(4):
                    s.backend.delete_pod(
                        s.backend.get("pods", "other", f"base-{4 * w + j:05d}"))
            elif kind == "node-add":
                add_node(s, f"node-b16-{added[0]:02d}", f"zone-{added[0] % 4}")
            elif kind in ("node-label", "node-zone"):
                name = s.names[100 + w]
                cur = s.backend.get_node(name)
                labels = dict(cur.labels)
                if kind == "node-label":
                    labels["example.com/tier"] = "b16"
                else:
                    z = int(labels[ZONE_LABEL].rsplit("-", 1)[1])
                    labels[ZONE_LABEL] = f"zone-{(z + 1) % 4}"
                s.backend.update("nodes", dataclasses.replace(cur, labels=labels))
        if kind == "node-add":
            added[0] += 1
        events.append((w, kind))

    def dispatch(w):
        batch = [app for app, _, _ in apps[w * window:(w + 1) * window]]
        out = {}
        for name, s in sides.items():
            for app in batch:
                s.backend.add_pod(s.pods[app][0])
            before = window_pack.launches
            t0 = time.perf_counter()
            t = s.ext.predicate_window_dispatch(
                [s.args(s.pods[app][0]) for app in batch])
            if on_card and name != "cpu":
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            if name in launches:
                segs = len(t.handle.requests) if t.handle is not None else 0
                n = window_pack.launches - before
                check(n == segs or not on_card,
                      f"phase 16 (a) {name}: window {w} launched {n} row "
                      f"walks for {segs} segments")
                launches[name] += n
                segments[name] += segs
            out[name] = (batch, t, ms)
        return out

    def complete(w, pend):
        results = {}
        for name, s in sides.items():
            batch, t, ms = pend[name]
            t0 = time.perf_counter()
            r = s.ext.predicate_window_complete(t)
            window_ms[name].append(ms + (time.perf_counter() - t0) * 1e3)
            s.bind([s.pods[app][0] for app in batch], r)
            results[name] = r
        for name in ("dense", "cpu"):
            check(results[name] == results["resident"],
                  f"phase 16 (a): window {w}: the {name} side's results "
                  f"differ from the resident cuda side's")
            check(sides[name].state() == res.state(),
                  f"phase 16 (a): window {w}: the {name} side's reservations "
                  f"or demands differ")

    between = {1: "pod-delete", 3: "node-label", 5: "node-zone", 12: "node-add",
               13: "node-add", 14: "pod-delete"}
    in_flight = {2: "node-add", 4: "pod-delete", 7: "node-add",
                 11: "pod-delete"}
    deleted: list = []
    t0 = time.perf_counter()
    pending = None
    for w in range(n_windows):
        if w == sync:
            # Drain, then delete two nodes no reservation names, with their
            # pods, as Kubernetes does: the next build (no window in
            # flight) recycles their registry rows, and the node adds after
            # it take them. (A pod left on a deleted node keeps its
            # overhead on the row, and the next node there inherits it:
            # ROADMAP §C.8.)
            complete(w - 1, pending)
            pending = None
            deleted = p16_idle_nodes(res, 2)
            for s in sides.values():
                for name in deleted:
                    for pod in list(s.backend.list_pods()):
                        if pod.node_name == name:
                            s.backend.delete_pod(pod)
                    s.backend.delete("nodes", "", name)
                s.names = [n for n in s.names if n not in deleted]
            events.append((w, f"node-delete {deleted}"))
        if w in between:
            event(w, between[w])
        cur = dispatch(w)
        if w in in_flight and pending is not None:
            event(w, in_flight[w])
        if pending is not None:
            complete(w - 1, pending)
        pending = cur
    complete(n_windows - 1, pending)
    windows_s = time.perf_counter() - t0
    if on_card:
        torch.cuda.synchronize()

    rs = res.solver
    bs = rs.build_stats
    fault_free(rs, 16)
    fault_free(dense.solver, 16)
    check(bs["oracle_checks"] > 0, "phase 16 (a): the build oracle never ran")
    check(bs["mirror_dense_syncs"] == 0,
          f"phase 16 (a): {bs['mirror_dense_syncs']} dense mirror syncs on "
          f"the resident solver after its first build")
    check(cpu.solver.build_stats["mirror_dense_syncs"] == 0,
          "phase 16 (a): dense mirror syncs on the cpu resident solver")
    check(rs.tombstones_recycled >= 1 and cpu.solver.tombstones_recycled >= 1,
          f"phase 16 (a): no deleted row recycled ({rs.tombstones_recycled})")
    recycled_rows = [rs.registry.index_of(f"node-b16-{k:02d}")
                     for k in range(added[0])]
    check(bs["incremental_builds"] > 0 and bs["full_snapshots"] >= 1,
          f"phase 16 (a): build mix {bs}")
    if on_card:
        check(launches["resident"] == segments["resident"],
              f"phase 16 (a): {launches['resident']} row walks for "
              f"{segments['resident']} live segments")
    p = np.percentile
    hist = {k: build_hist(s.solver) for k, s in sides.items()}
    print(f"phase 16 (a) ({card}): {n_windows} pipelined windows of {window} "
          f"drivers, churn {events}: results, reservations and demands equal "
          f"across the resident cuda, dense cuda and resident cpu extenders "
          f"in {windows_s:.1f} s; oracle checks {bs['oracle_checks']} (no "
          f"missed row), dense mirror syncs {bs['mirror_dense_syncs']}, "
          f"tombstones recycled {rs.tombstones_recycled} (the added nodes' "
          f"rows {recycled_rows}); row-walk launches {launches['resident']} "
          f"= {segments['resident']} live segments (dense side "
          f"{launches['dense']})", flush=True)
    for name, s in sides.items():
        b = s.solver.build_stats
        print(f"phase 16 (a) {name} ({card}): build ms p50 "
              f"{hist[name]['p50']:.4f} p99 {hist[name]['p99']:.4f} over "
              f"{hist[name]['count']} builds (solver.build.ms); "
              f"{b['incremental_builds']} incremental builds, "
              f"{b['full_snapshots']} full snapshots, dense mirror syncs "
              f"{b['mirror_dense_syncs']}, dirty-set rows {b['dirty_rows']}; "
              f"window p50 {p(window_ms[name], 50):.3f} ms p99 "
              f"{p(window_ms[name], 99):.3f} ms (dispatch + complete, host "
              f"clock)", flush=True)
    print(f"phase 16 (a) resident build block: {build_block(rs)}", flush=True)
    return {"window": launches["resident"], "probe": probes_res}


class P16Feed:
    """The feature store's build hints for a solver-level run: one
    topology version (the roster does not change) and the availability
    journal, one epoch a commit naming the usage rows it changed."""

    def __init__(self):
        self.epoch = 0
        self.journal: dict = {}

    def note(self, rows) -> None:
        empty = np.empty(0, np.int64)
        self.epoch += 1
        self.journal[self.epoch] = (np.unique(np.asarray(rows, np.int64)),
                                    empty, empty)

    def hints(self) -> dict:
        return dict(topo_version=1, avail_epoch=self.epoch,
                    avail_journal=self.journal)


def p16_run(solver, nodes, usage, windows):
    """Pipelined windows (window k+1 dispatched before window k is fetched)
    on one solver, fed the journal of its commits. Returns (decisions,
    window ms after the first, dispatched handles)."""
    import torch

    usage = usage.copy()
    feed = P16Feed()
    out, times, handles = [], [], []
    pending = None
    sync = (torch.cuda.synchronize if solver.device.type == "cuda"
            else (lambda: None))

    def fetch(w, h):
        d = solver.pack_window_fetch(h)
        before = usage.copy()
        commit(usage, solver.registry, w, d)
        feed.note(np.flatnonzero((usage != before).any(axis=1)))
        out.append(d)

    for w in windows:
        sync()
        t0 = time.perf_counter()
        t = solver.build_tensors_pipelined(nodes, usage, {}, **feed.hints())
        h = solver.pack_window_dispatch("tightly-pack", t, w)
        handles.append(h)
        if pending is not None:
            fetch(*pending)
        sync()
        if pending is not None:
            times.append((time.perf_counter() - t0) * 1e3)
        pending = (w, h)
    fetch(*pending)
    return out, times, handles


def run_build_solver_arm(device, card, n_nodes=PRUNE_BIG_NODES,
                         n_windows=P16_BIG_WINDOWS, window=P16_BIG_WINDOW):
    """Phase 16 (b): phase 12 (c)'s 100,000 nodes at the solver level, the
    resident cuda solver against the dense cuda solver. Returns the
    resident solver's row-walk and probe launches."""
    import torch

    from spark_scheduler_tpu_torch.core.solver import PlacementSolver
    from spark_scheduler_tpu_torch.ops.probe import probe_add_one
    from spark_scheduler_tpu_torch.ops.window import window_pack

    on_card = torch.device(device).type == "cuda"
    nodes, usage = main_cluster(seed=7, n=n_nodes)
    names = [nd.name for nd in nodes]
    rng = np.random.default_rng(67)
    windows = [prune_window(rng, names, window) for _ in range(n_windows)]
    got, times, launched = {}, {}, {}
    solvers = {
        "resident": with_telemetry(PlacementSolver(device=device,
                                                   build_oracle=True)),
        "dense": with_telemetry(PlacementSolver(device=device, use_native=False)),
    }
    probes = 0
    for name, solver in solvers.items():
        before, probes_before = window_pack.launches, probe_add_one.launches
        got[name], times[name], handles = p16_run(solver, nodes, usage, windows)
        launched[name] = window_pack.launches - before
        if name == "resident":
            probes = probe_add_one.launches - probes_before
            segs = sum(len(h.requests) for h in handles)
        fault_free(solver, 16)
    check(got["resident"] == got["dense"],
          "phase 16 (b): the resident solver's decisions differ from the "
          "dense solver's")
    rs = solvers["resident"]
    bs = rs.build_stats
    check(bs["mirror_dense_syncs"] == 0 and bs["oracle_checks"] > 0,
          f"phase 16 (b): resident build block {bs}")
    check(bs["incremental_builds"] >= n_windows - 1,
          f"phase 16 (b): {bs['incremental_builds']} incremental builds")
    if on_card:
        check(launched["resident"] == segs,
              f"phase 16 (b): {launched['resident']} row walks for {segs} "
              f"live segments")
    admitted = sum(d.admitted for w in got["resident"] for d in w)
    p = np.percentile
    for name, solver in solvers.items():
        h = build_hist(solver)
        b = solver.build_stats
        print(f"phase 16 (b) {name} ({card}): {n_nodes} nodes, {n_windows} "
              f"pipelined windows of {window} requests ({admitted} admitted, "
              f"equal on both solvers); build ms p50 {h['p50']:.4f} p99 "
              f"{h['p99']:.4f} over {h['count']} builds (solver.build.ms); "
              f"{b['incremental_builds']} incremental builds, "
              f"{b['full_snapshots']} full snapshots, dense mirror syncs "
              f"{b['mirror_dense_syncs']}; window p50 "
              f"{p(times[name], 50):.3f} ms (build + dispatch + the previous "
              f"window's fetch, host clock ending in a synchronise, "
              f"{len(times[name])} windows); row-walk launches "
              f"{launched[name]}", flush=True)
    print(f"phase 16 (b) resident build block: {build_block(rs)}", flush=True)
    return {"window": launched["resident"], "probe": probes}


def run_build_phase(device, card):
    """Phase 16: the native arena's resident build at full width."""
    a = run_build_extender_arm(device, card)
    b = run_build_solver_arm(device, card)
    return {k: a[k] + b[k] for k in a}



# ---------------------------------------------------------------- phase 17

P17_LEGS = ((42, "tightly-pack"), (43, "az-aware-tightly-pack"),
            (44, "single-az-tightly-pack"))
P17_NODES = 12
P17_STEPS = 200
P17_BIG_STEPS = 200
P17_ELASTIC = ((47, "tightly-pack"), (48, "single-az-tightly-pack"))
P17_ELASTIC_NODES = 10
P17_ELASTIC_STEPS = 300
P17_CHAOS_SEED = 9
P17_CHAOS_STEPS = 120


class SoakLaunches:
    """Phase 17's main-path tally: each `cuda` soak leg runs with the
    row-walk and probe counts set to 0 just before it and read just after,
    under a `SolverTap`; the row walks must equal the live segments of the
    card's dispatches (a greedy window's handle launches nothing) plus its
    solo packs, and the probes one a `cuda` solver."""

    def __init__(self, on_card):
        self.on_card = on_card
        self.total = {"window": 0, "probe": 0}

    def run(self, label, fn, *, healthy=True):
        from spark_scheduler_tpu_torch.ops.probe import probe_add_one
        from spark_scheduler_tpu_torch.ops.window import window_pack

        window_pack.launches = 0
        probe_add_one.launches = 0
        with SolverTap() as tap:
            out = fn()
        got = {"window": window_pack.launches, "probe": probe_add_one.launches}
        if healthy:
            for s in tap.solvers:
                fault_free(s, 17)
        if self.on_card:
            live = sum(dispatch_segments(h) for h in tap.handles
                       if not getattr(h, "greedy", False))
            check(got["window"] == live + tap.solo,
                  f"phase 17 {label}: row-walk launches {got['window']} != "
                  f"{live} live segments + {tap.solo} solo packs")
            cuda = [s for s in tap.solvers if s.device.type == "cuda"]
            check(got["probe"] == len(cuda),
                  f"phase 17 {label}: {got['probe']} probes for {len(cuda)} "
                  f"cuda solvers")
            for k in got:
                self.total[k] += got[k]
        return out, got, tap


def soak_outcome(soak):
    """What a `Soak` left behind, in comparable form: op counts, apps
    submitted, the admitted map (driver node, bound executors), every
    reservation's spec and the final availability."""
    admitted = {
        a: (e["node"], tuple(sorted(e["bound"].items())), e["min"])
        for a, e in soak.admitted.items()
    }
    specs = {
        rr.name: {k: (r.node, r.resources.as_tuple())
                  for k, r in rr.spec.reservations.items()}
        for rr in soak.h.app.rr_cache.list()
    }
    host = soak.h.app.solver._pipe["host"]
    avail = {}
    for node in soak.h.backend.list_nodes():
        row = soak.h.app.solver.registry.index_of(node.name)
        avail[node.name] = tuple(int(x) for x in np.asarray(host.available)[row])
    return {"op_counts": dict(soak.op_counts), "apps": soak.app_seq,
            "admitted": admitted, "specs": specs, "available": avail}


def timed_ops(soak):
    """Time each op of a non-elastic `soak` (its run loop reads
    `self.OPS`); returns the list the step times (seconds) land in."""
    times = []

    def timed(fn):
        def op(self):
            t0 = time.perf_counter()
            fn(self)
            times.append(time.perf_counter() - t0)
        return op

    soak.OPS = tuple((n, w, timed(fn)) for n, w, fn in type(soak).OPS)
    return times


def p17_soak(device, seed, strategy, n_nodes, steps, **kw):
    """One `Soak` run; returns (soak, its outcome, wall seconds). The app
    is stopped before it returns."""
    from spark_scheduler_tpu_torch.testing.soak import Soak

    soak = Soak(np.random.default_rng(seed), strategy, n_nodes=n_nodes,
                device=device, **kw)
    t0 = time.perf_counter()
    try:
        soak.run(steps)
        return soak, soak_outcome(soak), time.perf_counter() - t0
    finally:
        soak.h.app.stop()


def p17_dense(device, card, tally):
    """Phase 17 (a): the dense op mix, 12 nodes, `device` then the cpu."""
    for seed, strategy in P17_LEGS:
        label = f"(a) seed {seed} {strategy}"
        (soak, got, secs), _, _ = tally.run(
            label, lambda: p17_soak(device, seed, strategy, P17_NODES,
                                    P17_STEPS))
        _, want, ref_secs = p17_soak("cpu", seed, strategy, P17_NODES,
                                     P17_STEPS)
        for field in want:
            check(got[field] == want[field],
                  f"phase 17 {label}: {field} differs from the cpu soak")
        paths = soak.h.app.solver.window_path_counts
        print(f"phase 17 {label} ({card}): {P17_STEPS} steps on "
              f"{P17_NODES} nodes, op counts, {got['apps']} apps, the "
              f"admitted map ({len(got['admitted'])} apps), "
              f"{len(got['specs'])} reservation specs and the final "
              f"availability equal on {device} and cpu; windows {paths}; "
              f"wall {secs:.2f} s ({device}) {ref_secs:.2f} s (cpu)",
              flush=True)


def p17_wide(device, card, tally, n_nodes):
    """Phase 17 (a), full width: `n_nodes` nodes, every request naming
    every node, on `device` only."""
    strategy = "single-az-tightly-pack"
    mirror_checks = []

    def run():
        from spark_scheduler_tpu_torch.testing.soak import Soak

        soak = Soak(np.random.default_rng(45), strategy, n_nodes=n_nodes,
                    device=device)
        check_mirror = soak.check_drained_mirror

        def counted():
            mirror_checks.append(soak.steps)
            check_mirror()

        soak.check_drained_mirror = counted
        times = timed_ops(soak)
        t0 = time.perf_counter()
        try:
            soak.run(P17_BIG_STEPS)
            return soak, times, time.perf_counter() - t0
        finally:
            soak.h.app.stop()

    (soak, times, secs), got, _ = tally.run("(a) full width", run)
    paths = soak.h.app.solver.window_path_counts
    want = "cuda" if tally.on_card else "reference"
    check(set(paths) == {want},
          f"phase 17 (a) full width: window paths {paths}")
    check(len(mirror_checks) >= 2,
          f"phase 17 (a) full width: drained-mirror checks at steps "
          f"{mirror_checks}")
    ms = [t * 1e3 for t in times]
    print(f"phase 17 (a) full width ({card}): {soak.steps} steps on "
          f"{n_nodes} nodes ({strategy}, every request names every node), "
          f"invariants held, drained-mirror checks at steps {mirror_checks}; "
          f"windows served {paths[want]}; step p50 {pctl(ms, 50):.3f} ms "
          f"p99 {pctl(ms, 99):.3f} ms; wall {secs:.2f} s; row-walk "
          f"launches {got['window']}, probe {got['probe']}; ops "
          f"{soak.op_counts}", flush=True)


def p17_elastic(device, card, tally):
    """Phase 17 (b): the elastic soak on `device`."""
    for seed, strategy in P17_ELASTIC:
        label = f"(b) seed {seed} {strategy}"
        (soak, _, secs), got, _ = tally.run(
            label, lambda: p17_soak(device, seed, strategy,
                                    P17_ELASTIC_NODES, P17_ELASTIC_STEPS,
                                    elastic=True))
        counts = soak.h.autoscaler.metrics.counts()
        for key in ("demands_fulfilled", "nodes_added", "nodes_drained"):
            check(counts[key] > 0, f"phase 17 {label}: {key} = 0 ({counts})")
        lat = [s * 1e3 for s in soak.h.autoscaler.metrics.scaleup_latency_samples()]
        print(f"phase 17 {label} ({card}): {P17_ELASTIC_STEPS} steps from "
              f"{P17_ELASTIC_NODES} nodes, {counts['demands_fulfilled']} "
              f"demands fulfilled, {counts['nodes_added']} nodes added, "
              f"{counts['nodes_drained']} drained (drain safety held after "
              f"every autoscaler pass); demand to fulfilled p50 "
              f"{pctl(lat, 50):.3f} ms p99 {pctl(lat, 99):.3f} ms on the "
              f"soak clock ({len(lat)} samples); wall {secs:.2f} s; row-walk "
              f"launches {got['window']}", flush=True)


def p17_chaos(device, card, tally, tmp):
    """Phase 17 (c): every chaos-matrix surface on `device`, then the cpu;
    the verdicts must be equal field for field."""
    from spark_scheduler_tpu_torch.testing.soak import ChaosMatrixSoak

    def leg(dev, surface, tag):
        m = ChaosMatrixSoak(surface, seed=P17_CHAOS_SEED, n_nodes=P17_NODES,
                            wal_path=os.path.join(tmp, f"{surface}-{tag}.wal"),
                            device=dev)
        try:
            return m, m.run(P17_CHAOS_STEPS)
        finally:
            m.soak.h.app.stop()

    for surface in ChaosMatrixSoak.SURFACES:
        label = f"(c) {surface}"
        (m, verdict), got, tap = tally.run(
            label, lambda: leg(device, surface, "dev"),
            healthy=surface != "device")
        _, ref = leg("cpu", surface, "cpu")
        check(verdict["fired"], f"phase 17 {label}: no fault fired")
        check(verdict["write_back"]["dropped"] == 0,
              f"phase 17 {label}: write-back dropped work")
        check(verdict["apps"] > 0, f"phase 17 {label}: no apps")
        for field in ref:
            check(verdict.get(field) == ref[field],
                  f"phase 17 {label}: verdict field {field} differs from the "
                  f"cpu's: {verdict.get(field)} != {ref[field]}")
        solver = m.soak.h.app.solver
        paths = solver.window_path_counts
        extra = ""
        if surface == "device":
            want = "cuda" if tally.on_card else "reference"
            greedy = [h for h in tap.handles if getattr(h, "greedy", False)]
            later = [h for h in tap.handles if greedy
                     and h.info["dispatch_id"] > greedy[0].info["dispatch_id"]]
            check(paths.get("greedy-fallback") == 1,
                  f"phase 17 {label}: window paths {paths}")
            check(not tally.on_card or (
                later and all(not getattr(h, "greedy", False) for h in later)),
                  f"phase 17 {label}: the row walk did not serve the windows "
                  f"after the greedy one")
            check(paths.get(want, 0) > 0, f"phase 17 {label}: {paths}")
            check(not solver.device_health()["quarantined"],
                  f"phase 17 {label}: a slot stayed quarantined")
            extra = (f"; device {verdict['device']}, "
                     f"{len(later)} row-walk windows after the greedy one")
        print(f"phase 17 {label} ({card}): verdict equal to the cpu's field "
              f"for field; fired {verdict['fired']}; apps {verdict['apps']}; "
              f"write-back {verdict['write_back']}; windows {paths}{extra}; "
              f"row-walk launches {got['window']}", flush=True)


def p17_stop_replicas(soak):
    for r in soak.replicas:
        r.app.stop()


def p17_ha(device, card, tally, tmp):
    """Phase 17 (d): tests/test_ha_chaos_soak.py's three scenarios with the
    replicas on `device`, each held to that test's counts."""
    from spark_scheduler_tpu_torch.faults import FaultPlan, FaultSpec
    from spark_scheduler_tpu_torch.store.durable import DurableBackend
    from spark_scheduler_tpu_torch.testing.soak import HAChaosSoak

    for strategy in ("tightly-pack", "distribute-evenly"):
        label = f"(d) {strategy}"

        def run():
            soak = HAChaosSoak(strategy=strategy, n_nodes=16, ttl_s=2.0,
                               device=device)
            return soak, soak.run(cycles=3, burst=4)

        (soak, stats), got, _ = tally.run(label, run)
        check(stats["promotions"] == 3 and stats["fenced_drops"] >= 3
              and stats["apps_placed"] >= 18, f"phase 17 {label}: {stats}")
        soak.check_invariants()
        p17_stop_replicas(soak)
        print(f"phase 17 {label} ({card}): {stats}; row-walk launches "
              f"{got['window']}, probe {got['probe']}", flush=True)

    path = os.path.join(tmp, "ha-chaos.jsonl")

    def durable():
        backend = DurableBackend(path)
        soak = HAChaosSoak(strategy="tightly-pack", n_nodes=12,
                           backend=backend, device=device)
        stats = soak.run(cycles=2, burst=3)
        backend.close()
        return soak, stats

    (soak, stats), got, _ = tally.run("(d) durable", durable)
    p17_stop_replicas(soak)
    replayed = DurableBackend(path)
    rrs = {rr.name: rr for rr in replayed.list("resourcereservations")}
    check(set(rrs) == set(soak.placed),
          "phase 17 (d) durable: the WAL replay holds other apps")
    check(all(rrs[a].spec.reservations["driver"].node == n
              for a, n in soak.placed.items()),
          "phase 17 (d) durable: a replayed driver slot moved")
    replayed.close()
    print(f"phase 17 (d) durable ({card}): {stats}; the WAL replays to the "
          f"{len(rrs)} surviving placements; row-walk launches "
          f"{got['window']}", flush=True)

    plan = FaultPlan(
        seed=7, name="ha-kill-alternate",
        specs=[FaultSpec(surface="replica.kill", mode="error", every=2),
               FaultSpec(surface="lease.read", mode="error", p=0.1, limit=6)],
    )

    def planned():
        soak = HAChaosSoak(strategy="tightly-pack", n_nodes=16, ttl_s=2.0,
                           fault_plan=plan, device=device)
        return soak, soak.run(cycles=4, burst=3)

    (soak, stats), got, _ = tally.run("(d) replica.kill plan", planned)
    check(stats["kills"] == 2 and stats["spared_cycles"] == 2
          and stats["promotions"] == 2
          and stats["fault_stats"]["fired"].get("replica.kill") == 2,
          f"phase 17 (d) replica.kill plan: {stats}")
    soak.check_invariants()
    p17_stop_replicas(soak)
    print(f"phase 17 (d) replica.kill plan ({card}): kills "
          f"{stats['kills']}, spared {stats['spared_cycles']}, promotions "
          f"{stats['promotions']}, faults fired "
          f"{stats['fault_stats']['fired']}; row-walk launches "
          f"{got['window']}", flush=True)


def p17_fleet(device, card, tally):
    """Phase 17 (e): tests/test_fleet_soak.py's two scenarios, three
    clusters on `device`, `verify_cluster_equivalence` replaying each on
    `device` too."""
    from spark_scheduler_tpu_torch.testing.soak import FleetSoak

    for steps, kill_at, rejoin_at in ((40, 25, 32), (45, 25, 36)):
        label = f"(e) {steps} steps"

        def run():
            soak = FleetSoak(n_clusters=3, nodes_per_cluster=2, seed=1,
                             device=device)
            try:
                return soak.run(steps=steps, kill_at=kill_at,
                                rejoin_at=rejoin_at).verdict()
            finally:
                soak.stop()

        v, got, _ = tally.run(label, run)
        for key in ("double_placements", "overcommit", "oracle_mismatches",
                    "orphans_unrouted"):
            check(v[key] == [], f"phase 17 {label}: {key} {v[key]}")
        check(all(r["identical"] for r in v["equivalence"].values()),
              f"phase 17 {label}: equivalence {v['equivalence']}")
        check(v["placed"] > 0, f"phase 17 {label}: nothing placed")
        if steps == 40:
            check(v["spillovers"] > 0, f"phase 17 {label}: no spillover")
        else:
            check(v["orphans_at_kill"] > 0, f"phase 17 {label}: no orphans")
        summary = {k: v[k] for k in ("placed", "pending", "spillovers",
                                     "orphans_at_kill", "orphans_rerouted",
                                     "stacking")}
        print(f"phase 17 {label} ({card}): every invariant held, every "
              f"cluster identical to its standalone replay on {device}; "
              f"{summary}; row-walk launches {got['window']}, probe "
              f"{got['probe']}", flush=True)


def run_soak_phase(device, card, big_nodes=N_MAIN, out_dir=None):
    """Phase 17: the soak engines on `device`. Returns the row-walk and
    probe launches of its `device` legs."""
    import shutil
    import tempfile

    import torch

    tally = SoakLaunches(torch.device(device).type == "cuda")
    tmp = tempfile.mkdtemp(prefix="p17-", dir=out_dir)
    try:
        t0 = time.perf_counter()
        p17_dense(device, card, tally)
        p17_wide(device, card, tally, big_nodes)
        t1 = time.perf_counter()
        p17_elastic(device, card, tally)
        t2 = time.perf_counter()
        p17_chaos(device, card, tally, tmp)
        t3 = time.perf_counter()
        p17_ha(device, card, tally, tmp)
        t4 = time.perf_counter()
        p17_fleet(device, card, tally)
        t5 = time.perf_counter()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 17 seconds: (a) {t1 - t0:.1f} (b) {t2 - t1:.1f} "
          f"(c) {t3 - t2:.1f} (d) {t4 - t3:.1f} (e) {t5 - t4:.1f}; row-walk "
          f"launches {tally.total['window']}, probe {tally.total['probe']} "
          f"({card})", flush=True)
    return tally.total


# --------------------------------------------------------------- phase 18

P18_SHARDS = (1, 2, 4)
P18_QUEUE_APPS = 32  # of a config-5 queue
P18_MASKED_ROWS = 16
P18_WINDOW_ROWS = 96  # the first segments of a phase-3 window
P18_SMALL_NODES = 300
P18_SMALL_APPS = 24
P18_WINDOWS = 4  # (c) and (d): two pipelined pairs, churn between them
P18_WINDOW = 8
P18_TIGHT = (8, 0.25)  # (d): phase 12's tight top-k and slack
P18_DRIVERS = 32
P18_CLIENTS = 4


def mesh_devices(device, s, mesh_cards):
    """S shard devices: `device` repeated (one stream each), or with
    `mesh_cards` and two or more cards, shard k on card k % cards."""
    import torch

    if mesh_cards and torch.cuda.device_count() >= 2:
        return [torch.device("cuda", k % torch.cuda.device_count())
                for k in range(s)]
    return [torch.device(device)] * s


def pad_fields(fields, n):
    """Nine cluster fields padded to n rows with invalid slots."""
    from spark_scheduler_tpu_torch.models.resources import INT32_INF

    k = n - len(fields[0])
    pads = [np.zeros((k, 3), np.int32), np.zeros((k, 3), np.int32),
            np.zeros(k, np.int32), np.arange(len(fields[0]), n, dtype=np.int32),
            np.full(k, INT32_INF, np.int32), np.full(k, INT32_INF, np.int32),
            np.zeros(k, bool), np.zeros(k, bool), np.zeros(k, bool)]
    return [np.concatenate([f, p]) for f, p in zip(fields, pads)]


def window_outputs(meta, execs, base, si, ri):
    """A row walk's outputs as flat BatchedPacking fields (numpy)."""
    meta, execs = meta.cpu().numpy(), execs.cpu().numpy()
    return (meta[si, ri, 0], execs[si, ri], meta[si, ri, 1] == 1,
            meta[si, ri, 2] == 1, base.cpu().numpy())


def same_outputs(got, want) -> bool:
    """A BatchedPacking's real rows against flat (driver, execs, admitted,
    packed, available_after) arrays."""
    rows = len(want[0])
    g = (got.driver_node.cpu().numpy()[:rows],
         got.executor_nodes.cpu().numpy()[:rows],
         got.admitted.cpu().numpy()[:rows], got.packed.cpu().numpy()[:rows],
         got.available_after.cpu().numpy())
    return all(np.array_equal(a, b) for a, b in zip(g, want))


def p18_engine_case(label, card, cluster, apps, want, devs_of, kernel_ms, **kw):
    """The node-sharded engine at S = 1, 2, 4 on the card and S = 4 on
    `cpu` shards against `want` (the kernel's outputs); prints ms per call
    (CUDA events) beside the kernel's and the cross-shard bytes per row."""
    import torch

    from spark_scheduler_tpu_torch.parallel import (
        node_sharded_fifo_pack,
        shard_cluster,
    )

    rows = int(torch.as_tensor(apps.app_valid).sum())
    line = []
    for s in P18_SHARDS:
        shards = shard_cluster(devs_of(s), cluster)
        stats: dict = {}
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        got = node_sharded_fifo_pack(shards, apps, stats=stats, **kw)
        end.record()
        torch.cuda.synchronize()
        check(same_outputs(got, want),
              f"phase 18 (a) {label}: the engine on {s} shards differs from "
              "the kernel")
        line.append(f"S={s} {start.elapsed_time(end):.1f} ms "
                    f"({stats.get('xbytes', 0) / max(rows, 1):.0f} B a row "
                    f"of summaries and {stats.get('xbytes_keys', 0):,} B of "
                    f"sort keys, ranks and chunks across shards)")
    cpu = cluster.__class__(*(f.cpu() for f in cluster.fields()))
    got = node_sharded_fifo_pack(shard_cluster(["cpu"] * 4, cpu), apps, **kw)
    check(same_outputs(got, want),
          f"phase 18 (a) {label}: the engine on 4 cpu shards differs")
    print(f"phase 18 (a) {label} ({card}): {rows} rows, N "
          f"{cluster.num_nodes}, identical to the kernel and to 4 cpu shards; "
          f"per call {'; '.join(line)}; the kernel {kernel_ms:.3f} ms "
          f"(CUDA events)", flush=True)


def p18_engine(device, card, last, mesh_cards):
    """(a) The node-sharded engine against the kernels: a config-5 queue
    (10,000 nodes padded to 16,384) against fifo_pack, a masked batch of
    one-row segments against window_pack, the first segments of a phase-3
    window against window_pack; then the six strategies at 300 nodes,
    roomy and tight, queue and window mode, on 4 shards. Every launch here
    is a comparison."""
    import torch

    from spark_scheduler_tpu_torch.models.cluster import cluster_from_numpy
    from spark_scheduler_tpu_torch.ops.batched import (
        app_batch_to_device,
        make_app_batch,
    )
    from spark_scheduler_tpu_torch.ops.fifo import fifo_pack
    from spark_scheduler_tpu_torch.ops.window import (
        SegmentedWindow,
        segmented_window_from_flat,
        window_pack,
    )
    from spark_scheduler_tpu_torch.parallel import (
        node_sharded_fifo_pack,
        shard_cluster,
    )

    def devs_of(s):
        return mesh_devices(device, s, mesh_cards)

    def kernel(fn):
        out, ms = None, 0.0
        for _ in range(2):  # the second call is timed
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
        return out, ms

    # Queue mode: a config-5 queue against the queue kernel.
    rng = np.random.default_rng(CONFIG_SEEDS["config5"])
    c5 = cluster_from_numpy(pad_fields(baseline_cluster(rng, 10_000), 16_384),
                            device=device)
    q = app_batch_to_device(
        baseline_batches(rng, P18_QUEUE_APPS, P18_QUEUE_APPS, 8)[0], device)
    kw = dict(fill="tightly-pack", emax=8, num_zones=4)
    want, k_ms = kernel(lambda: fifo_pack(c5, q, **kw))
    want = tuple(x.cpu().numpy() for x in want)
    p18_engine_case("queue mode, config 5", card, c5, q, want, devs_of, k_ms, **kw)

    # Masked mode: rows of a phase-3 window, each with its own masks; all
    # skippable, so no FIFO block carries and one-row window segments that
    # all commit solve the same rows.
    cluster, batch = last
    win, n = batch.win, cluster.num_nodes
    live = np.flatnonzero(win.valid.reshape(-1))[:P18_MASKED_ROWS]
    r = len(live)

    def flat(a):
        return a.reshape(-1, *a.shape[2:])[live]

    mrng = np.random.default_rng(71)
    valid = cluster.valid.cpu().numpy()
    cand = (mrng.random((r, n)) < 0.7) & valid
    dom = (mrng.random((r, n)) < 0.9) & valid
    skip = np.ones(r, bool)
    mwin, si, ri = segmented_window_from_flat(
        flat(win.driver_req), flat(win.exec_req), flat(win.exec_count), skip,
        np.ones(r, np.int64), list(cand), list(dom), pad_segments=r, pad_rows=1)
    wkw = dict(fill="tightly-pack", emax=batch.emax, num_zones=batch.num_zones)
    out, k_ms = kernel(lambda: window_pack(cluster, mwin, **wkw))
    masked = make_app_batch(flat(win.driver_req), flat(win.exec_req),
                            flat(win.exec_count), skippable=skip,
                            driver_cand=cand, domain=dom)
    p18_engine_case("masked mode, phase-3 rows", card, cluster, masked,
                    window_outputs(*out, si, ri), devs_of, k_ms, **wkw)

    # Window mode: the first segments of the phase-3 window.
    k = max(1, int(np.searchsorted(np.cumsum(win.row_count), P18_WINDOW_ROWS,
                                   side="right")))
    cut = SegmentedWindow(*(f[:k] for f in win))
    apps, (si, ri) = segmented_to_app_batch(cut)
    out, k_ms = kernel(lambda: window_pack(cluster, cut, **wkw))
    p18_engine_case(f"window mode, {k} phase-3 segments", card, cluster, apps,
                    window_outputs(*out, si, ri), devs_of, k_ms, **wkw)

    # The six strategies at 300 nodes, roomy and tight, queue and window
    # mode, on 4 shards.
    srng = np.random.default_rng(73)
    done = []
    for hi, label in ((40, "roomy"), (8, "tight")):
        c = cluster_from_numpy(queue_cluster_fields(srng, P18_SMALL_NODES, hi),
                               device=device)
        shards = shard_cluster(devs_of(4), c)
        qa = app_batch_to_device(
            queue_apps(srng, P18_SMALL_APPS, P18_SMALL_APPS), device)
        sw = small_window(srng, P18_SMALL_NODES, 8, 4, 8)
        wa, (si, ri) = segmented_to_app_batch(sw)
        for fill in STRATEGIES:
            skw = dict(fill=fill, emax=8, num_zones=4)
            want = tuple(x.cpu().numpy() for x in fifo_pack(c, qa, **skw))
            got = node_sharded_fifo_pack(shards, qa, **skw)
            check(same_outputs(got, want),
                  f"phase 18 (a) {label} {fill}: the engine on 4 shards "
                  "differs from the queue kernel")
            wwant = window_outputs(*window_pack(c, sw, **skw), si, ri)
            wgot = node_sharded_fifo_pack(shards, wa, **skw)
            check(same_outputs(wgot, wwant),
                  f"phase 18 (a) {label} {fill}: the engine on 4 shards "
                  "differs from the row walk")
            done.append((int(got.admitted.sum()), int(wgot.admitted.sum())))
    print(f"phase 18 (a) ({card}): six strategies x roomy/tight at "
          f"{P18_SMALL_NODES} nodes on 4 shards identical to the queue kernel "
          f"and the row walk (admitted, queue / window: {done})", flush=True)


def p18_grouped(device, card, mesh_cards):
    """(b) The group-sharded queue kernel: config 4's five groups of 1,000
    nodes on a (5, 1) groups mesh, one launch a groups device, against the
    single-launch `grouped_fifo_pack` and the plain version. Returns the
    route's queue-kernel launches (the main path's)."""
    import torch

    from spark_scheduler_tpu_torch.models.cluster import cluster_from_numpy
    from spark_scheduler_tpu_torch.ops.batched import app_batch_to_device
    from spark_scheduler_tpu_torch.ops.fifo import fifo_pack
    from spark_scheduler_tpu_torch.parallel import (
        grouped_fifo_pack,
        grouped_fifo_pack_auto,
        grouped_fifo_pack_reference,
        make_solver_mesh,
        stack_groups,
    )

    rng = np.random.default_rng(CONFIG_SEEDS["config4"])
    groups, group_apps = [], []
    for cpu, mem, gpu in CONFIG4_SHAPES:
        groups.append(cluster_from_numpy(
            baseline_cluster(rng, 1_000, cpu=cpu, mem=mem, gpu=gpu), device=device))
        group_apps.append(app_batch_to_device(
            baseline_batches(rng, 40, 40, 8)[0], device))
    c4, a4 = stack_groups(groups, group_apps)
    mesh = make_solver_mesh(5, 1, devices=mesh_devices(device, 5, mesh_cards))
    kw = dict(fill="tightly-pack", emax=8, num_zones=4)
    on_card = torch.device(device).type == "cuda"
    before = fifo_pack.launches
    got, route_ms = timed_ms(lambda: grouped_fifo_pack_auto(mesh, c4, a4, **kw))
    launches = fifo_pack.launches - before
    check(launches == 5 or not on_card,
          f"phase 18 (b): {launches} queue-kernel launches on a (5, 1) groups "
          "mesh (one a groups device)")
    single, single_ms = timed_ms(lambda: grouped_fifo_pack(c4, a4, **kw))
    fifo_pack.launches = before + launches  # the single launch compares
    plain = grouped_fifo_pack_reference(c4, a4, **kw)
    check(packing_diff(got, single) == 0 and packing_diff(got, plain) == 0,
          "phase 18 (b): the group-sharded route differs from the single "
          "launch or the plain version")
    print(f"phase 18 (b) ({card}): config 4 on a (5, 1) groups mesh "
          f"({[str(d) for d in mesh.devices]}): {launches} queue-kernel "
          f"launches, identical to the single-launch grouped_fifo_pack and the "
          f"plain version ({int(got.admitted.sum())} admitted); "
          f"{route_ms:.2f} ms against the single launch's {single_ms:.2f} ms "
          f"(host clock)", flush=True)
    return launches


def p18_pairs(solver, nodes, usage, windows, seed):
    """Pipelined pairs of windows with phase 12's churn between them."""
    crng = np.random.default_rng(seed)
    out = []
    for k in range(0, len(windows), 2):
        decisions, _ = prune_pair(solver, nodes, usage, windows[k:k + 2], False)
        out.append(decisions)
        nodes, usage = prune_churn(crng, nodes, usage, k)
    return out


def p18_mesh_slot(device, card, mesh_cards):
    """(c) Serving on a mesh slot: phase 3's 10,000 nodes behind
    PlacementSolver(mesh=(1, 4)), 4 pipelined windows of 8 drivers, churn
    between the pairs, against a pool-less solver (the row walk) and a cpu
    solver. Returns the mesh solver's launches."""
    from spark_scheduler_tpu_torch.core.solver import PlacementSolver
    from spark_scheduler_tpu_torch.ops.probe import probe_add_one
    from spark_scheduler_tpu_torch.ops.window import window_pack

    nodes, usage = main_cluster(seed=7)
    names = [nd.name for nd in nodes]
    rng = np.random.default_rng(61)
    windows = [prune_window(rng, names, P18_WINDOW) for _ in range(P18_WINDOWS)]
    devs = mesh_devices(device, 4, mesh_cards)
    w0, p0 = window_pack.launches, probe_add_one.launches
    t0 = time.perf_counter()
    mesh = PlacementSolver(device=device, mesh=(1, 4), pool_devices=devs)
    got = p18_pairs(mesh, nodes, usage, windows, 67)
    mesh_s = time.perf_counter() - t0
    launches = {"window": window_pack.launches - w0,
                "probe": probe_add_one.launches - p0}
    check(mesh.pool_size == 1 and mesh._pool.slots[0].is_mesh,
          f"phase 18 (c): the mesh solver's pool {mesh.device_pool_stats()}")
    check(mesh.window_path_counts == {"pool": P18_WINDOWS},
          f"phase 18 (c): window paths {mesh.window_path_counts}")
    check(launches["window"] == 0,
          f"phase 18 (c): {launches['window']} row walks on the mesh slot")
    t0 = time.perf_counter()
    plain = p18_pairs(PlacementSolver(device=device), nodes, usage, windows, 67)
    plain_s = time.perf_counter() - t0
    window_pack.launches = w0 + launches["window"]
    probe_add_one.launches = p0 + launches["probe"]
    cpu = p18_pairs(PlacementSolver(device="cpu"), nodes, usage, windows, 67)
    check(got == plain, "phase 18 (c): the mesh slot's decisions differ from "
                        "the pool-less solver's")
    check(got == cpu, "phase 18 (c): the mesh slot's decisions differ from "
                      "the cpu solver's")
    fault_free(mesh, 18)
    admitted = sum(d.admitted for pair in got for w in pair for d in w)
    print(f"phase 18 (c) ({card}): {P18_WINDOWS} pipelined windows of "
          f"{P18_WINDOW} drivers on one 4-shard mesh slot "
          f"{list(mesh.device_pool_stats())} ({[str(d) for d in devs]}): "
          f"identical to the pool-less row walk and the cpu solver, "
          f"{admitted} admitted; window paths {mesh.window_path_counts}; "
          f"{mesh_s:.1f} s against the row walk's {plain_s:.1f} s (host clock, "
          f"builds included)", flush=True)
    return launches


def p18_scale_tier(device, card, mesh_cards):
    """(d) The scale tier: phase 12 (c)'s 100,000 nodes, a tight top-k, a
    4-shard mesh slot whose shards the tier re-solves on, against the same
    solver with the tier off and a cpu run. Returns the tier solver's
    launches."""
    from spark_scheduler_tpu_torch.core.solver import PlacementSolver
    from spark_scheduler_tpu_torch.ops.probe import probe_add_one
    from spark_scheduler_tpu_torch.ops.window import window_pack

    nodes, usage = main_cluster(seed=7, n=PRUNE_BIG_NODES)
    names = [nd.name for nd in nodes]
    rng = np.random.default_rng(79)
    windows = [prune_window(rng, names, P18_WINDOW) for _ in range(P18_WINDOWS)]
    top_k, slack = P18_TIGHT
    devs = mesh_devices(device, 4, mesh_cards)
    kw = dict(prune_top_k=top_k, prune_slack=slack)
    w0, p0 = window_pack.launches, probe_add_one.launches
    t0 = time.perf_counter()
    tier = PlacementSolver(device=device, mesh=(1, 4), scale_tier=True,
                           pool_devices=devs, **kw)
    got = p18_pairs(tier, nodes, usage, windows, 83)
    tier_s = time.perf_counter() - t0
    launches = {"window": window_pack.launches - w0,
                "probe": probe_add_one.launches - p0}
    st, esc = dict(tier.scale_tier_stats), tier.prune_stats["escalations"]
    check(esc > 0 and st["resolves"] > 0 and st["sharded"] > 0
          and st["fallbacks"] == 0,
          f"phase 18 (d): escalations {esc}, scale tier {st}")
    t0 = time.perf_counter()
    off = p18_pairs(PlacementSolver(device=device, mesh=(1, 4),
                                    pool_devices=devs, **kw),
                    nodes, usage, windows, 83)
    off_s = time.perf_counter() - t0
    window_pack.launches = w0 + launches["window"]
    probe_add_one.launches = p0 + launches["probe"]
    cpu = p18_pairs(PlacementSolver(device="cpu", **kw), nodes, usage, windows, 83)
    check(got == off, "phase 18 (d): the tier's decisions differ from the "
                      "same run with the tier off")
    check(got == cpu, "phase 18 (d): the tier's decisions differ from the "
                      "cpu run")
    fault_free(tier, 18)
    print(f"phase 18 (d) ({card}): {len(nodes)} nodes, top-k {top_k}, slack "
          f"{slack}, {P18_WINDOWS} windows of {P18_WINDOW}: escalations {esc}, "
          f"scale tier {st} over {[str(d) for d in devs]}; identical to the "
          f"tier off and the cpu run; {tier_s:.1f} s against {off_s:.1f} s "
          f"with the tier off (host clock, builds included)", flush=True)
    return launches


def p18_server(device, card, mesh_cards, n_drivers=P18_DRIVERS,
               n_clients=P18_CLIENTS, n_nodes=N_MAIN):
    """(e) The app from YAML, `solver: {mesh: {groups: 1, node-shards: 4},
    scale-tier: true}`, on phase 7's cluster: drivers from `n_clients`
    threads; every body must equal a cpu replay's. Returns the launches."""
    from spark_scheduler_tpu_torch.ops.probe import probe_add_one
    from spark_scheduler_tpu_torch.ops.window import window_pack
    from spark_scheduler_tpu_torch.server.app import build_scheduler_app
    from spark_scheduler_tpu_torch.server.config import InstallConfig
    from spark_scheduler_tpu_torch.testing.harness import overcommit_violations

    raw = {"fifo": True, "binpack-algo": "tightly-pack",
           "solver": {"mesh": {"groups": 1, "node-shards": 4},
                      "scale-tier": True}}
    config = dataclasses.replace(
        InstallConfig.from_dict(raw), instance_group_label=EXT_IG_LABEL,
        sync_writes=True, debug_routes=True)
    devs = mesh_devices(device, 4, mesh_cards)

    def factory(backend, registry, metrics):
        return build_scheduler_app(backend, config, metrics=metrics,
                                   clock=lambda: EXT_CLOCK, device=device,
                                   pool_devices=devs), None

    w0, p0 = window_pack.launches, probe_add_one.launches
    srv = RecordedServer(device, config, app_factory=factory)
    port = srv.server.port
    label = "phase 18 (e)"
    try:
        solver = srv.app.solver
        check(solver.pool_size == 1 and solver._pool.slots[0].is_mesh
              and solver._scale_tier, f"{label}: {solver.device_pool_stats()}")
        nodes, usage = main_cluster(seed=7)
        nodes, usage = nodes[:n_nodes], usage[:n_nodes]
        for node in nodes:
            node.labels[EXT_IG_LABEL] = EXT_IG
        names = [nd.name for nd in nodes]
        run_clients(port, [[("PUT", "/state/nodes", k8s_node_json(nd))]
                           for nd in nodes[:SRV_ROUTE_NODES]], 1)
        from spark_scheduler_tpu_torch.models.kube import Container, Pod
        from spark_scheduler_tpu_torch.models.resources import Resources

        for i, node in enumerate(nodes):
            if i >= SRV_ROUTE_NODES:
                srv.backend.add_node(node)
            srv.backend.add_pod(Pod(
                name=f"base-{i:05d}", namespace="other", uid=f"uid-base-{i:05d}",
                scheduler_name="default-scheduler", node_name=node.name,
                phase="Running",
                containers=[Container(requests=Resources(*map(int, usage[i])))],
            ))
        rng = np.random.default_rng(89)
        jobs = []
        for i in range(n_drivers):
            n_exec = 32 if rng.random() < 0.15 else int(rng.integers(2, 9))
            pod = k8s_spark_pod_json(f"p18-{i:03d}", "driver",
                                     f"p18-{i:03d}-driver", n_exec,
                                     EXT_CLOCK - 500 + i)
            jobs.append([("PUT", "/state/pods", pod),
                         ("POST", "/predicates", {"Pod": pod, "NodeNames": names})])
        got, lat = run_clients(port, jobs, n_clients)
        check(all(st == 200 for st, _ in got.values()),
              f"{label}: a driver was refused")
        state = json.loads(http_get(port, "/debug/state")[1])
        paths = state["solver"]["window_paths"]
        check(paths.get("pool", 0) > 0, f"{label}: window paths {paths}")
        violations = overcommit_violations(srv.app, srv.backend)
        check(not violations, f"{label} over-commit: {violations[:8]}")
        check(srv.solo_packs["other"] == 0, f"{label}: solo packs off the "
                                            "batcher thread")
        fault_free(solver, 18)
    finally:
        srv.server.stop()
    launches = {"window": window_pack.launches - w0,
                "probe": probe_add_one.launches - p0}
    compared = replay_server_log(
        srv.log, dataclasses.replace(config, solver_mesh_groups=None,
                                     solver_mesh_node_shards=None),
        got, label=label)
    check(compared == len(got), f"{label}: compared {compared} of {len(got)}")
    admitted = sum(bool(json.loads(b).get("NodeNames")) for _, b in got.values())
    print(f"{label} ({card}): the YAML app (mesh 1 x 4 on "
          f"{[str(d) for d in devs]}, scale tier) served {n_drivers} drivers "
          f"from {n_clients} clients ({admitted} admitted), window paths "
          f"{paths}, device_pool {list(state.get('device_pool', {}))}; every "
          f"body equal to a cpu replay ({compared}); driver p50 "
          f"{np.percentile(lat, 50):.3f} ms p99 {np.percentile(lat, 99):.3f} ms "
          f"(client host clock)", flush=True)
    return launches


def p18_tier_fault(device, card, mesh_cards, n_nodes=N_MAIN):
    """(f) A device fault in the scale tier's re-solve: (c)'s 10,000 nodes
    on a 4-shard mesh slot with (d)'s tight top-k, the tier on and the
    greedy degraded policy. The node-sharded engine raises a classified
    CudaDeviceFault(214) on the tier's thread only (the mesh slot's own
    part solves, on the solve pool's workers, run clean). Against the same
    injection on a cpu mesh slot and the tier-off row walk on the card;
    after close() no future of the solver runs and every slot's in-flight
    count is 0. Returns the tier solver's launches."""
    import threading

    from spark_scheduler_tpu_torch.core import solver as sm
    from spark_scheduler_tpu_torch.faults.degraded import DegradedModeController
    from spark_scheduler_tpu_torch.faults.errors import CudaDeviceFault
    from spark_scheduler_tpu_torch.ops.probe import probe_add_one
    from spark_scheduler_tpu_torch.ops.window import window_pack

    nodes, usage = main_cluster(seed=7, n=n_nodes)
    names = [nd.name for nd in nodes]
    rng = np.random.default_rng(89)
    windows = [prune_window(rng, names, P18_WINDOW) for _ in range(P18_WINDOWS)]
    top_k, slack = P18_TIGHT
    devs = mesh_devices(device, 4, mesh_cards)
    kw = dict(prune_top_k=top_k, prune_slack=slack)
    real_tier = sm.PlacementSolver._scale_tier_decisions
    real_engine = sm.node_sharded_fifo_pack
    inside = threading.local()
    faults = []

    def tier(self, *a, **k):
        inside.on = True
        try:
            return real_tier(self, *a, **k)
        finally:
            inside.on = False

    def engine(*a, **k):
        if getattr(inside, "on", False):
            faults.append(threading.current_thread().name)
            raise CudaDeviceFault(
                214, "phase 18 (f): uncorrectable ECC error (injected)")
        return real_engine(*a, **k)

    def faulted(dev, pool):
        solver = sm.PlacementSolver(device=dev, mesh=(1, 4), scale_tier=True,
                                    pool_devices=pool, **kw)
        solver.degraded = DegradedModeController(policy="greedy")
        return solver

    sm.PlacementSolver._scale_tier_decisions = tier
    sm.node_sharded_fifo_pack = engine
    try:
        w0, p0 = window_pack.launches, probe_add_one.launches
        t0 = time.perf_counter()
        solver = faulted(device, devs)
        got = p18_pairs(solver, nodes, usage, windows, 97)
        tier_s = time.perf_counter() - t0
        launches = {"window": window_pack.launches - w0,
                    "probe": probe_add_one.launches - p0}
        st, esc = dict(solver.scale_tier_stats), solver.prune_stats["escalations"]
        card_faults, card_degraded = len(faults), solver.degraded.fallback_decisions
        health = solver.device_health()
        futures = list(solver._inflight_futures)
        t0 = time.perf_counter()
        solver.close()
        close_ms = (time.perf_counter() - t0) * 1e3
        inflight = [s.inflight for s in solver._pool.slots]
        cpu_solver = faulted("cpu", ["cpu"] * 4)
        cpu = p18_pairs(cpu_solver, nodes, usage, windows, 97)
        cpu_st = dict(cpu_solver.scale_tier_stats)
    finally:
        sm.PlacementSolver._scale_tier_decisions = real_tier
        sm.node_sharded_fifo_pack = real_engine
    t0 = time.perf_counter()
    off = p18_pairs(sm.PlacementSolver(device=device, mesh=(1, 4),
                                       pool_devices=devs, **kw),
                    nodes, usage, windows, 97)
    off_s = time.perf_counter() - t0
    window_pack.launches = w0 + launches["window"]
    probe_add_one.launches = p0 + launches["probe"]
    check(esc > 0 and st["fallbacks"] > 0 and st["resolves"] == 0
          and st["sharded"] == 0,
          f"phase 18 (f): escalations {esc}, scale tier {st}")
    check(cpu_st["fallbacks"] > 0 and cpu_st["resolves"] == cpu_st["sharded"] == 0,
          f"phase 18 (f): the cpu run's scale tier {cpu_st}")
    check(card_faults >= st["fallbacks"] and card_degraded > 0,
          f"phase 18 (f): {card_faults} injected faults, {card_degraded} "
          f"greedy decisions")
    check(set(faults) == {threading.current_thread().name},
          f"phase 18 (f): the fault fired off the tier's thread: {set(faults)}")
    check(not health["quarantined"],
          f"phase 18 (f): a tier fault quarantined a slot: {health}")
    check(all(f.done() for f in futures) and not solver._inflight_futures
          and inflight == [0],
          f"phase 18 (f): after close(): futures done "
          f"{[f.done() for f in futures]}, left {len(solver._inflight_futures)}, "
          f"in flight {inflight}")
    check(got == cpu, "phase 18 (f): the decisions differ from the cpu run "
                      "with the same injection")
    check(got == off, "phase 18 (f): the decisions differ from the tier-off "
                      "row walk")
    admitted = sum(d.admitted for pair in got for w in pair for d in w)
    print(f"phase 18 (f) ({card}): {len(nodes)} nodes, top-k {top_k}, slack "
          f"{slack}, {P18_WINDOWS} windows of {P18_WINDOW} on a 4-shard mesh "
          f"slot, a device fault in every tier re-solve: escalations {esc}, "
          f"scale tier {st}, {card_degraded} greedy decisions, no slot "
          f"quarantined; identical to the cpu run with the same injection "
          f"and to the tier-off row walk, {admitted} admitted; close() "
          f"{close_ms:.1f} ms, every future done, in flight {inflight}; "
          f"{tier_s:.1f} s against {off_s:.1f} s with the tier off (host "
          f"clock, builds included)", flush=True)
    return launches


# (g)'s child: it dispatches one pooled mesh window and exits with it
# unfetched while the part solve, held in a CUDA wait after its decisions
# were copied out, still runs on the solve pool's worker.
P18_ABANDON_CHILD = """
import sys, time
sys.path.insert(0, {here!r})
import numpy as np
import torch
import chip_smoke as c
from spark_scheduler_tpu_torch.core.solver import PlacementSolver

real_rows = PlacementSolver._blob_rows
held = []


def rows(*a, **k):
    held.append(time.perf_counter())
    torch.cuda._sleep(int(2e9))  # about a second of the card's clock
    torch.cuda.synchronize()
    return real_rows(*a, **k)


PlacementSolver._blob_rows = staticmethod(rows)
dev = torch.device("cuda", 0)
nodes, usage = c.main_cluster(seed=7)
names = [nd.name for nd in nodes]
solver = PlacementSolver(device=dev, mesh=(1, 4), pool_devices=[dev] * 4)
t = solver.build_tensors_pipelined(nodes, usage, {{}})
window = c.prune_window(np.random.default_rng(101), names, c.P18_WINDOW)
solver.pack_window_dispatch("tightly-pack", t, window)
while not held:
    time.sleep(0.001)
print("abandoned", time.time(), flush=True)
"""


def p18_abandon(device, card):
    """(g) A child python3 on the card dispatches a pooled mesh window,
    abandons it and exits while its part solve runs: exit waits for the
    part (core/device_pool.py PART_WAIT_S), so the child exits 0, with no
    "terminate called" from a worker unwound inside a CUDA call."""
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", P18_ABANDON_CHILD.format(here=here)], cwd=here,
        capture_output=True, text=True, timeout=300,
    )
    ended = time.time()
    child_s = time.perf_counter() - t0
    check(proc.returncode == 0 and "terminate called" not in proc.stderr
          and "abandoned" in proc.stdout,
          f"phase 18 (g): the child exited {proc.returncode}: "
          f"{proc.stdout[-500:]} {proc.stderr[-2000:]}")
    exit_s = ended - float(proc.stdout.split("abandoned")[1].split()[0])
    print(f"phase 18 (g) ({card}): a child abandoned a pooled mesh window "
          f"on the card and exited 0, no 'terminate called'; exit took "
          f"{exit_s:.2f} s after the abandon (host clock; the part held "
          f"about 1 s of card time), the child {child_s:.1f} s in all",
          flush=True)


def run_mesh_phase(device, card, last, mesh_cards=False):
    """Phase 18: parallel across cards (ROADMAP §A.6) on the card: the
    node-sharded engine against the kernels (a), the group-sharded queue
    kernel (b), serving on a mesh slot (c), the scale tier (d), the app
    from YAML (e), a device fault in the tier's re-solve (f) and a pooled
    window abandoned at exit (g). Shards go on `device`, repeated (one
    stream each), or with `mesh_cards` on distinct cards. Returns the main
    path's launches (row walk, probe, queue kernel)."""
    from spark_scheduler_tpu_torch.ops.fifo import fifo_pack
    from spark_scheduler_tpu_torch.ops.probe import probe_add_one
    from spark_scheduler_tpu_torch.ops.window import window_pack

    seconds = {}
    saved = (window_pack.launches, fifo_pack.launches, probe_add_one.launches)
    t0 = time.perf_counter()
    p18_engine(device, card, last, mesh_cards)
    seconds["a"] = time.perf_counter() - t0
    window_pack.launches, fifo_pack.launches, probe_add_one.launches = saved
    t0 = time.perf_counter()
    queue = p18_grouped(device, card, mesh_cards)
    seconds["b"] = time.perf_counter() - t0
    out = {"window": 0, "probe": 0}
    for key, fn in (("c", p18_mesh_slot), ("d", p18_scale_tier),
                    ("e", p18_server), ("f", p18_tier_fault)):
        t0 = time.perf_counter()
        got = fn(device, card, mesh_cards)
        seconds[key] = time.perf_counter() - t0
        for k in out:
            out[k] += got[k]
    t0 = time.perf_counter()
    p18_abandon(device, card)
    seconds["g"] = time.perf_counter() - t0
    out["queue"] = queue
    print(f"phase 18 seconds: " + ", ".join(
        f"({k}) {v:.1f}" for k, v in seconds.items())
        + f"; main-path launches: row walk {out['window']}, probe "
        f"{out['probe']}, queue kernel {queue} ({card})", flush=True)
    return out


def build_into_cache_dir(device) -> float:
    """Phase 1's install-key step: an app whose `jax-compilation-cache-dir`
    is a fresh temporary directory builds the native runtime (g++) and the
    probe's library (nvcc) there, and the probe launches from that library
    (ops/_build.py `use_build_dir`). The build directory then returns to
    the package's; the loaded libraries stay loaded. Returns the seconds."""
    import shutil
    import tempfile

    from spark_scheduler_tpu_torch import native
    from spark_scheduler_tpu_torch.ops import _build
    from spark_scheduler_tpu_torch.ops.probe import PROBE_SHAPE, probe_add_one
    from spark_scheduler_tpu_torch.server.app import build_scheduler_app
    from spark_scheduler_tpu_torch.server.config import InstallConfig
    from spark_scheduler_tpu_torch.store.backend import InMemoryBackend
    import torch

    t0 = time.perf_counter()
    cache = tempfile.mkdtemp(prefix="chip-smoke-build-")
    try:
        check("probe" not in _build._loaded and native._lib is None,
              "phase 1: a library was loaded before the cache-dir step")
        app = build_scheduler_app(
            InMemoryBackend(), InstallConfig(jax_compilation_cache_dir=cache),
            device=device)
        try:
            x = torch.zeros(PROBE_SHAPE, dtype=torch.int32, device=device)
            ok = bool((probe_add_one(x) == 1).all())
            built = sorted(os.listdir(cache))
            probe_path = _build.library_path("probe")
            check(ok and probe_path.parent == _build.Path(cache).resolve()
                  and probe_path.name in built
                  and native.library_path().name in built
                  and _build._loaded["probe"]._name == str(probe_path),
                  f"phase 1: the cache dir {cache} holds {built}; the probe "
                  f"loaded from {_build._loaded['probe']._name}, ok {ok}")
        finally:
            app.stop()
    finally:
        _build.use_build_dir(_build.DEFAULT_BUILD_DIR)
        shutil.rmtree(cache, ignore_errors=True)
    return time.perf_counter() - t0


def main(mesh_cards: bool = False) -> int:
    try:
        import torch
    except ImportError as exc:
        print(f"chip_smoke: torch is not importable: {exc}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on the card only",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        from spark_scheduler_tpu_torch.ops._build import build_all
        from spark_scheduler_tpu_torch.ops.probe import probe
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script: {exc}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    t_start = time.perf_counter()

    cache_s = build_into_cache_dir(device)

    t0 = time.perf_counter()
    # The native runtime (g++) builds beside the CUDA sources (nvcc); a
    # failure of either raises.
    from concurrent.futures import ThreadPoolExecutor

    from spark_scheduler_tpu_torch import native

    with ThreadPoolExecutor(1) as pool:
        native_built = pool.submit(native.build)
        logs = build_all()
        if native_built.result():
            logs["native runtime (g++)"] = ""
    native.load()
    print(f"phase 1: built {sorted(logs) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                print(f"  {name}: {line.strip()}")
    probe(device)
    card = card_line()
    print(f"phase 1: probe ok on {torch.cuda.get_device_name(0)}; "
          f"card: {card}", flush=True)
    print(f"phase 1: an app with jax-compilation-cache-dir built the native "
          f"runtime and the probe's library into its directory and launched "
          f"the probe from it in {cache_s:.2f} s ({card})", flush=True)

    worst_small = compare_small(device)
    worst_queue = compare_queue_small(device)

    t0 = time.perf_counter()
    launches, stats, last = run_main_path(device)
    tp = [s["ms"] for s in stats if s["strategy"] == "tightly-pack"]
    print(f"phase 3: {len(stats)} windows identical to the CPU solver in "
          f"{time.perf_counter() - t0:.1f} s; tightly-pack per window p50 "
          f"{np.percentile(tp, 50):.2f} ms p99 {np.percentile(tp, 99):.2f} ms "
          f"over {len(tp)} windows; segments/window "
          f"{np.mean([s['segments'] for s in stats]):.1f}, rows/window "
          f"{np.mean([s['rows'] for s in stats]):.1f}; kernel launches "
          f"window={launches['window']} probe={launches['probe']} ({card})",
          flush=True)

    m = measure(last, device, card, worst_small)
    m_queue = measure_queue(device, card, worst_queue)
    measure_queue_layouts(device, card)

    t0 = time.perf_counter()
    queue_launches = run_queue_path(device)
    print(f"phase 5: BASELINE configs 1, 2, 2b, 3, 4, 5 identical to the CPU "
          f"plain path in {time.perf_counter() - t0:.1f} s; queue-kernel "
          f"launches {queue_launches} ({card})", flush=True)

    t0 = time.perf_counter()
    ext_launches = run_extender_phase(device, card)
    print(f"phase 6: passed in {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    srv_launches, srv_stats = run_server_phase(device, card)
    print(f"phase 7: passed in {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    async_launches, _ = run_server_phase(device, card, phase=8,
                                         transport="async", ingest="native",
                                         before=srv_stats)
    print(f"phase 8: passed in {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    wal_launches, ctx = run_durable_phase(device, card)
    print(f"phase 9: passed in {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    ha_launches = run_failover_phase(device, card, ctx)
    print(f"phase 10: passed in {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    fused_launches, _ = run_server_phase(
        device, card, phase=11, fuse=FUSE_WINDOWS, max_window=FUSE_MAX_WINDOW,
        before=srv_stats)
    run_engine_phase(device, card, last)
    print(f"phase 11: passed in {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    prune_launches = run_prune_phase(device, card)
    print(f"phase 12: passed in {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    policy_launches, _ = run_policy_phase(device, card)
    elastic_launches, _ = run_autoscaler_phase(device, card)
    print(f"phase 13: passed in {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    pool_launches = run_pool_phase(device, card)
    shed_launches = run_pool_server_phase(device, card, "shed")
    greedy_launches = run_pool_server_phase(device, card, "greedy")
    p14 = {k: pool_launches[k] + shed_launches[k] + greedy_launches[k]
           for k in pool_launches}
    print(f"phase 14: passed in {time.perf_counter() - t0:.1f} s; row-walk "
          f"launches {p14['window']} ((a)-(d) {pool_launches['window']}, "
          f"(e) {shed_launches['window']} + {greedy_launches['window']}), "
          f"probe {p14['probe']}", flush=True)

    t0 = time.perf_counter()
    replay_launches, _ = run_replay_phase(device, card)
    print(f"phase 15: passed in {time.perf_counter() - t0:.1f} s; row-walk "
          f"launches {replay_launches['window']}, probe "
          f"{replay_launches['probe']} ({card})", flush=True)
    t0 = time.perf_counter()
    build_launches = run_build_phase(device, card)
    print(f"phase 16: passed in {time.perf_counter() - t0:.1f} s; row-walk "
          f"launches {build_launches['window']}, probe "
          f"{build_launches['probe']} ({card})", flush=True)
    t0 = time.perf_counter()
    soak_launches = run_soak_phase(device, card)
    print(f"phase 17: passed in {time.perf_counter() - t0:.1f} s; row-walk "
          f"launches {soak_launches['window']}, probe "
          f"{soak_launches['probe']} ({card})", flush=True)
    t0 = time.perf_counter()
    mesh_launches = run_mesh_phase(device, card, last, mesh_cards)
    print(f"phase 18: passed in {time.perf_counter() - t0:.1f} s; row-walk "
          f"launches {mesh_launches['window']}, probe "
          f"{mesh_launches['probe']}, queue kernel {mesh_launches['queue']} "
          f"({card})", flush=True)
    # The row walk and the probe serve the main path at each of its entry
    # points: the solver's windows (phase 3), the extender's (phase 6), the
    # HTTP server's on both transports (phases 7 and 8), fed by apiserver
    # ingestion over the WAL store (phase 9), as HA replicas (phase 10),
    # with fused claims (phase 11), over pruned windows (phase 12), under
    # the policy engine and the autoscaler (phase 13), over the device
    # pool, its re-dispatches and its quarantine probes (phase 14), under
    # trace capture, replay, what-if, sweep and the fleet (phase 15), fed
    # by the resident host build under churn (phase 16), driven by the
    # soak engines under chaos (phase 17), and beside mesh slots and the
    # scale tier (phase 18). The queue kernel serves phase 5's configs and
    # phase 18's group-sharded route.
    for k in launches:
        launches[k] += (ext_launches[k] + srv_launches[k] + async_launches[k]
                        + wal_launches[k] + ha_launches[k] + fused_launches[k]
                        + prune_launches[k] + policy_launches[k]
                        + elastic_launches[k] + pool_launches[k]
                        + shed_launches[k] + greedy_launches[k]
                        + replay_launches[k] + build_launches[k]
                        + soak_launches[k] + mesh_launches[k])
    queue_launches += mesh_launches["queue"]
    kernels = [
        dict(name="window_row_walk", route="cuda",
             source="spark_scheduler_tpu_torch/csrc/window_kernel.cu",
             replaces="spark_scheduler_tpu/ops/pallas_window.py:85",
             launches=launches["window"], **m["window"]),
        dict(name="fifo_queue", route="cuda",
             source="spark_scheduler_tpu_torch/csrc/fifo_kernel.cu",
             replaces="spark_scheduler_tpu/ops/pallas_fifo.py:413",
             launches=queue_launches, **m_queue),
        dict(name="probe_add_one", route="cuda",
             source="spark_scheduler_tpu_torch/csrc/probe.cu",
             replaces="spark_scheduler_tpu/ops/pallas_fifo.py:720",
             launches=launches["probe"], **m["probe"]),
    ]
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


def trace_race(argv) -> int:
    """`--trace-race ROUNDS [--nodes N] [--device cpu]` (module docstring)."""
    import argparse
    import shutil
    import tempfile

    ap = argparse.ArgumentParser(prog="chip_smoke.py")
    ap.add_argument("--trace-race", type=int, required=True, metavar="ROUNDS")
    ap.add_argument("--nodes", type=int, default=N_MAIN)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    if args.device != "cpu" and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from spark_scheduler_tpu_torch import native
    from spark_scheduler_tpu_torch.replay import replay_trace
    from spark_scheduler_tpu_torch.store.backend import InMemoryBackend

    device = torch.device("cpu")
    card = "cpu"
    if args.device != "cpu":
        from spark_scheduler_tpu_torch.ops._build import build_all
        from spark_scheduler_tpu_torch.ops.probe import probe

        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        build_all()
        probe(device)
        card = card_line()
    native.build()
    native.load()
    print(card, flush=True)
    ordered = InMemoryBackend.order_events_with
    sides: dict = {"lock": [], "no-lock": []}
    for i in range(2 * args.trace_race):
        side = "lock" if i % 4 in (0, 3) else "no-lock"
        tmp = tempfile.mkdtemp(prefix="trace-race-")
        path = os.path.join(tmp, "capture.jsonl")
        t0 = time.perf_counter()
        if side == "no-lock":
            InMemoryBackend.order_events_with = lambda self, lock: None
        try:
            _, cap = p15_capture(device, card, path, args.nodes,
                                 P15_DRIVERS, P15_CLIENTS)
        finally:
            InMemoryBackend.order_events_with = ordered
        rep = replay_trace(path, strict=False, device=device)
        shutil.rmtree(tmp, ignore_errors=True)
        row = {"capture": i, "side": side, "compared": rep.compared,
               "mismatches": len(rep.mismatches),
               "first": rep.mismatches[:1],
               "driver_p50_ms": cap["driver_p50"],
               "driver_p99_ms": cap["driver_p99"],
               "seconds": time.perf_counter() - t0}
        sides[side].append(row)
        print(json.dumps(row), flush=True)
    for side, rows in sides.items():
        print(f"trace race ({card}, {args.nodes} nodes) {side}: "
              f"{sum(r['mismatches'] > 0 for r in rows)} of {len(rows)} "
              f"captures mismatched; driver p50 "
              f"{[round(r['driver_p50_ms'], 1) for r in rows]} ms", flush=True)
    return 0 if not any(r["mismatches"] for r in sides["lock"]) else 1


if __name__ == "__main__":
    if sys.argv[1:] in ([], ["--mesh-cards"]):
        sys.exit(main(mesh_cards=bool(sys.argv[1:])))
    sys.exit(trace_race(sys.argv[1:]))
