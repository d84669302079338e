#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (spark_scheduler_tpu_torch) on one
NVIDIA GPU: the quickest proof that the port still builds, starts and
decides right on the card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

  1. Build every CUDA source of the port with nvcc (one process per source,
     all at once) and, beside them, the port's native runtime
     (spark_scheduler_tpu_torch/native/runtime.cpp) with g++; launch the
     probe kernel and check it, print the card.
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
     `PlacementSolver(device="cuda").build_tensors`; 8 windows of 32
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

Prints the card, a {"kernels": [...]} line and, last, the result line.
Needs one card; exits non-zero without CUDA or without the package beside it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

N_MAIN = 10_000
WINDOWS = 8
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


def main_cluster(seed):
    """10,000 nodes over 4 zones: 8-64 CPU, 32-256 Gi, ~10% with 1-8 GPUs,
    and a dense prior usage of 30-70% per dimension (registry-row order)."""
    from spark_scheduler_tpu_torch.models.kube import Node, ZONE_LABEL
    from spark_scheduler_tpu_torch.models.resources import Resources

    rng = np.random.default_rng(seed)
    n = N_MAIN
    cpu = rng.choice([8, 16, 32, 48, 64], n)
    mem = rng.choice([32, 64, 128, 192, 256], n)
    gpu = np.where(rng.random(n) < 0.1, rng.integers(1, 9, n), 0)
    nodes = [
        Node(
            name=f"node-{i:05d}",
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
    print(f"probe ({card}): probe_add_one {p_ms:.5f} ms, torch.add "
          f"{p_lib:.5f} ms per call (CUDA events, median of 100); profiled "
          f"device time per call: probe kernel {p_dev}, torch.add {lib_dev}",
          flush=True)
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


def build_extender(device):
    """A port extender wired from its parts as the JAX package's
    server/app.py `build_scheduler_app` wires its own: an in-memory backend
    with the Demand CRD, synchronous write-back, `tightly-pack`, FIFO on,
    reconciler / metrics / events / waste / recorder / policy off, one
    fixed clock. Returns (extender, backend, solver)."""
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
    solver = PlacementSolver(device=device)
    ext = SparkSchedulerExtender(
        backend, lister, rrm, demands, overhead, binpacker, solver,
        config=ExtenderConfig(fifo=True, instance_group_label=EXT_IG_LABEL),
        reconciler=None, metrics=None, events=None, waste=None,
        recorder=None, clock=clock, policy=None,
    )
    ext._last_request = float("inf")  # no time-gap resync
    return ext, backend, solver


def extender_cluster(backend):
    """Phase 3's 10,000 nodes (4 zones, one instance group), with its prior
    usage as one running pod of another scheduler on each node (the
    extender counts it as overhead)."""
    from spark_scheduler_tpu_torch.models.kube import Container, Pod
    from spark_scheduler_tpu_torch.models.resources import Resources

    nodes, usage = main_cluster(seed=7)
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

    def __init__(self, device, apps):
        self.ext, self.backend, self.solver = build_extender(device)
        self.names = extender_cluster(self.backend)
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
    sees, at each window, the state this server saw."""

    def __init__(self, device, config, transport="threaded", ingest="python"):
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

        self.backend = InMemoryBackend()
        self.backend.register_crd(DEMAND_CRD)
        self.registry = MetricRegistry()
        self.app = build_scheduler_app(
            self.backend, config,
            metrics=SchedulerMetrics(self.registry, EXT_IG_LABEL),
            clock=lambda: EXT_CLOCK, device=device,
        )
        self.lock = threading.RLock()
        self.log: list = []
        self.solo_packs = {"batcher": 0, "other": 0, "d2h": 0}
        # Dispatches so far, and windows dispatched but not yet completed.
        self.counts = {"dispatched": 0, "inflight": 0}
        # Called on the dispatcher thread, outside the lock, right after the
        # `trigger_at`-th dispatch: that window is in flight meanwhile.
        self.trigger_at, self.on_trigger = None, None
        backend, log, lock, counts = self.backend, self.log, self.lock, self.counts

        def recorded(name):
            orig = getattr(backend, name)

            def call(*args):
                if name == "update" and args[0] != "nodes":
                    return orig(*args)
                with lock:
                    out = orig(*args)
                    log.append(("change", name, copy.deepcopy(args),
                                counts["inflight"]))
                return out

            setattr(backend, name, call)

        for name in ("add_node", "update", "add_pod", "update_pod", "delete_pod"):
            recorded(name)

        ext = self.app.extender
        dispatch, complete = ext.predicate_window_dispatch, ext.predicate_window_complete
        entries = {}

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
                try:
                    t = dispatch(args_list)
                except PipelineDrainRequired:
                    e["drain"] = True
                    raise
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
                e["d2h"] = t.handle.blob.nbytes if t.handle is not None else 0
                entries[id(t)] = e
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
                out = complete(t)
                e["ms"] = (time.perf_counter() - t0) * 1e3
                e["launches"] = window_pack.launches - before
                return out

        ext.predicate_window_dispatch = recorded_dispatch
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
        self.server.start()


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


def run_clients(port, jobs, n_clients, binary=False):
    """Run `jobs` on `n_clients` threads (job i on thread i % n_clients),
    each thread on one keep-alive connection. A job is a list of
    (method, path, payload) requests, or a function that makes its
    requests through the `send(method, path, payload)` it is given (and
    may look at the answers). With `binary`, the odd-numbered threads post
    their predicates as binary bodies. Returns {pod name: (status, body)}
    for the predicates and their client-side latencies in ms."""
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
                if path == "/predicates":
                    out[payload["Pod"]["metadata"]["name"]] = (resp.status, data)
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
                     ingest="python", before=None):
    """Phase 7 (threaded transport, python ingest), or phase 8 (async
    transport, native ingest, half the clients on binary bodies): the
    port's HTTP server on the card (see the module docstring). `before` is
    phase 7's stats, printed beside phase 8's. Returns the row-walk and
    probe launches of the phase and its stats."""
    import copy
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
        debug_routes=True,
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
        violations = overcommit_violations(srv.app, srv.backend)
        check(not violations, f"phase {phase} over-commit: {violations[:8]}")
    finally:
        srv.server.stop()
    launches = {"window": window_pack.launches, "probe": probe_add_one.launches}
    serve_s = time.perf_counter() - t_phase

    # What the log says: the windows, their segments and solo packs.
    log = srv.log
    dispatches = [e for e in log if isinstance(e, dict) and e["op"] == "dispatch"]
    done = [e for e in dispatches if not e["drain"]]
    drains = len(dispatches) - len(done)
    driver_windows = [e for e in done if e["dispatch_id"] is not None]
    segments = sum(e["segments"] for e in done)
    solo = srv.solo_packs
    check(solo["other"] == 0, f"solo packs off the batcher thread: {solo}")
    if on_card:
        window_launches = sum(e["launches"] for e in log
                              if isinstance(e, dict) and "launches" in e)
        check(window_launches == launches["window"],
              f"launches outside dispatch/complete: {launches['window']} vs "
              f"{window_launches}")
        check(launches["window"] == segments + solo["batcher"],
              f"row-walk launches {launches['window']} != {segments} live "
              f"segments + {solo['batcher']} solo packs")
        check(launches["probe"] == 1, f"probe launches {launches['probe']}")
    # The driver windows the server formed, as /debug/decisions reports
    # them (dispatch_id), equal the recorded ones.
    by_id: dict = {}
    for d in recorded:
        if d.get("dispatch_id") is not None:
            by_id.setdefault(d["dispatch_id"], set()).add(d["pod_name"])
    want_ids = {e["dispatch_id"]: {a.pod.name for a in e["args"]
                                   if a.pod.labels.get("spark-role") == "driver"}
                for e in driver_windows}
    want_ids = {k: v for k, v in want_ids.items() if v}
    check(by_id == want_ids, f"phase {phase}: /debug/decisions windows differ "
                             "from the dispatched ones")

    # The solver telemetry on /metrics against what this script counted.
    path = "pallas" if on_card else "xla"
    dispatches = series(snapshot, "foundry.spark.scheduler.solver.window.dispatches")
    check(dispatches == {(("path", path),): len(driver_windows)},
          f"phase {phase}: solver.window.dispatches {dispatches} != "
          f"{len(driver_windows)} driver windows")
    uploads = series(snapshot, "foundry.spark.scheduler.solver.device.uploads")
    label = str(srv.app.solver.device)
    want_uploads = {(("device", label), ("kind", k)): v
                    for k, v in srv.builds.items() if v}
    check(uploads == want_uploads, f"phase {phase}: solver.device.uploads "
                                   f"{uploads} != builds {srv.builds}")
    transfer = series(snapshot, "foundry.spark.scheduler.solver.transfer.bytes")
    d2h = sum(e.get("d2h", 0) for e in done) + solo["d2h"]
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
    compared = replay_server_log(log, config, got)
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
    stats = {
        "drv_p50": p(lat_drv, 50), "drv_p99": p(lat_drv, 99),
        "drv_rate": n_drivers / drv_s,
        "exec_p50": p(lat_exec, 50), "exec_p99": p(lat_exec, 99),
        "exec_rate": len(lat_exec) / exec_s,
        "drv_busy": drv_busy, "exec_busy": exec_busy,
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
          f"({sum(e['rows'] for e in done)} rows) + {solo['batcher']} solo "
          f"packs; probe {launches['probe']}; "
          f"served in {serve_s:.1f} s", flush=True)
    print(f"phase {phase}: /metrics solver.window.dispatches {path} "
          f"{len(driver_windows)}, solver.device.uploads {srv.builds}, "
          f"solver.transfer.bytes h2d {h2d} d2h {d2h}: equal to this "
          f"script's count", flush=True)
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


def replay_server_log(log, config, got):
    """Feed a `cpu` app of the port the recorded changes and windows in
    their order; every answer must equal, byte for byte, the body the
    server sent for that pod (`got`). Returns how many were compared.
    The recorded objects are private copies, so the replay consumes them
    as they are."""
    from spark_scheduler_tpu_torch.core.solver import PipelineDrainRequired
    from spark_scheduler_tpu_torch.server.app import build_scheduler_app
    from spark_scheduler_tpu_torch.server.routing import encode_filter_result
    from spark_scheduler_tpu_torch.store.backend import DEMAND_CRD, InMemoryBackend

    backend = InMemoryBackend()
    backend.register_crd(DEMAND_CRD)
    ref = build_scheduler_app(backend, config, clock=lambda: EXT_CLOCK,
                              device="cpu")
    tickets, compared = {}, 0
    for e in log:
        if isinstance(e, tuple):
            getattr(backend, e[1])(*e[2])
            continue
        if e["op"] == "dispatch":
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
                      f"phase 7: {a.pod.name}: the server answered {body[:160]} "
                      f"where the cpu replay answers {want[:160]}")
                compared += 1
    check(not tickets, f"{len(tickets)} windows never completed")
    ref.stop()
    return compared


def main() -> int:
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
    # The row walk and the probe serve the main path at each of its entry
    # points: the solver's windows (phase 3), the extender's (phase 6) and
    # the HTTP server's on both transports (phases 7 and 8).
    for k in launches:
        launches[k] += ext_launches[k] + srv_launches[k] + async_launches[k]
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


if __name__ == "__main__":
    sys.exit(main())
