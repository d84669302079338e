#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (spark_scheduler_tpu_torch) on one
NVIDIA GPU: the quickest proof that the port still builds, starts and
decides right on the card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

  1. Build every CUDA source of the port with nvcc (one process per source,
     all at once), launch the probe kernel and check it, print the card.
  2. Kernel vs plain, small: the CUDA window kernel (`window_pack` on CUDA
     tensors) against its plain PyTorch version (`window_pack_reference`) on
     the same CUDA inputs, all six strategies, seeded random windows at
     N = 24 and N = 300 (roomy and tight clusters). Every output must be
     identical (tolerance: none).
  3. Main path at full width: a 10,000-node cluster (4 zones, heterogeneous
     nodes, ~10% with GPUs, 30-70% prior usage) built through
     `PlacementSolver(device="cuda").build_tensors`; 8 windows of 32
     requests with `pack_window("tightly-pack", ...)`, then one window per
     other strategy. Each request carries 0-63 FIFO-earlier pending drivers
     plus its own application; some gangs are 2-32 executors wide (emax 32).
     Admitted gangs are committed into the usage between windows. Every
     window's decisions must equal those of `PlacementSolver(device="cpu")`
     on the same state. Kernel launch counts are read around this phase.
  4. Measurements at a main-path window: the kernel wrapper's time, its
     plain version's time on the card, the bound, a device-time split.

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


def compare_small(device) -> int:
    """Phase 2. Returns the largest |kernel - plain| over every output."""
    import torch

    from spark_scheduler_tpu_torch.ops.window import (
        window_pack,
        window_pack_reference,
    )

    worst, cases = 0, 0
    for n, n_req, max_rows, hi in ((24, 5, 4, 24), (300, 8, 8, 24),
                                   (300, 8, 8, 6)):
        for fill in STRATEGIES:
            for seed in range(3):
                rng = np.random.default_rng(1000 * n + 10 * hi + seed)
                cluster = small_cluster(rng, n, hi, device)
                win = small_window(rng, n, n_req, max_rows, 8)
                got = window_pack(cluster, win, fill=fill, emax=8, num_zones=4)
                want = window_pack_reference(
                    cluster, win, fill=fill, emax=8, num_zones=4
                )
                torch.cuda.synchronize()
                err = max_abs_diff(got, want)
                if err:
                    for name, g, w in zip(("meta", "execs", "base"), got, want):
                        bad = (g != w).nonzero()[:8].tolist()
                        print(f"  mismatch {fill} n={n} hi={hi} "
                              f"seed={seed} {name} at {bad}", flush=True)
                check(err == 0, f"kernel != plain for {fill} n={n} hi={hi} "
                                f"seed={seed}")
                worst = max(worst, err)
                cases += 1
    print(f"phase 2: {cases} windows, kernel == plain on every output",
          flush=True)
    return worst


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


def device_split(fn):
    """Device time of one call, split into the row-walk kernel and the rest
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
            if "window_row_walk" in evt.name:
                kernel += us
            else:
                other += us
    return kernel / 1e3, other / 1e3


def measure(last, device, card, worst_small):
    import torch

    from spark_scheduler_tpu_torch.ops.probe import (
        probe_add_one,
        probe_reference,
    )
    from spark_scheduler_tpu_torch.ops.window import (
        window_pack,
        window_pack_reference,
    )

    cluster, batch = last
    args = dict(fill="tightly-pack", emax=batch.emax, num_zones=batch.num_zones)
    got = window_pack(cluster, batch.win, **args)
    t0 = time.perf_counter()
    want = window_pack_reference(cluster, batch.win, **args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max(worst_small, max_abs_diff(got, want))
    check(err == 0, "kernel != plain at the main-path window")
    ms = cuda_time_ms(lambda: window_pack(cluster, batch.win, **args), 5)
    bound, bound_by = window_bound(cluster, batch, "tightly-pack")
    kern, other = device_split(lambda: window_pack(cluster, batch.win, **args))
    rows = int(batch.win.row_count.sum())
    idle = max(0.0, 1 - (kern + other) / ms) if kern else None
    print(f"window kernel at the main path ({card}): {ms:.3f} ms per "
          f"window_pack call (CUDA events, median of 5) for {rows} rows; "
          f"plain version on the card {plain_ms:.1f} ms; bound {bound:.5f} "
          f"ms ({bound_by}); profiled device time: row-walk kernel "
          f"{kern:.3f} ms ({kern * 1e3 / rows:.1f} us per row), other device "
          f"work {other:.3f} ms; device idle share of the call "
          f"{'not measured' if idle is None else f'{idle:.3f}'}",
          flush=True)

    x = torch.zeros((8, 128), dtype=torch.int32, device=device)
    p_err = int((probe_add_one(x) - probe_reference(x)).abs().max())
    check(p_err == 0, "probe kernel != plain")
    p_ms = cuda_time_ms(lambda: probe_add_one(x), 100)
    p_plain = cuda_time_ms(lambda: probe_reference(x), 100)
    p_lib = cuda_time_ms(lambda: torch.add(x, 1), 100)
    p_bound = 2 * x.numel() * 4 / PEAK_BYTES_S * 1e3
    return {
        "window": dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=bound, bound_by=bound_by, library_ms=None),
        "probe": dict(max_abs_err=p_err, ms=p_ms, plain_ms=p_plain,
                      bound_ms=p_bound, bound_by="bytes", library_ms=p_lib),
    }


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
    logs = build_all()
    print(f"phase 1: built {sorted(logs) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    probe(device)
    card = card_line()
    print(f"phase 1: probe ok on {torch.cuda.get_device_name(0)}; "
          f"card: {card}", flush=True)

    worst_small = compare_small(device)

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
    kernels = [
        dict(name="window_row_walk", route="cuda",
             source="spark_scheduler_tpu_torch/csrc/window_kernel.cu",
             replaces="spark_scheduler_tpu/ops/pallas_window.py:85",
             launches=launches["window"], **m["window"]),
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
