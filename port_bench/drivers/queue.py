"""The queue traffic driver: BASELINE.json's queue windows.

A queue of apps runs through the program's queue path,
`ops.fifo.fifo_pack`, cut into windows. Each window starts from the
availability the previous one left (`available_after`), and its decisions
are copied to the host before the next window is dispatched. After the
last window the chain restarts from the starting availability on the next
of a set of queues made from the seed.

The reference checks every window of `sample_chains` chains drawn
uniformly, by reservoir sampling from the seed, from all the chains the
measured window ran, so a fault that sets in late in the window is as
likely to be compared as one at its start. What a kept chain keeps (its
decisions, already on the host, and its availability after each window)
costs the timed path nothing.

Traffic keys (`workloads/<cell>.json`): `apps` (the app table),
`apps_per_group`, `window`, `emax`, `queues`, `skippable`,
`warmup_chains`, `sample_chains`, and `profile_windows` (the traced
slice).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from port_bench import generators, roofline
from port_bench.harness import Check, DeviceProfile
from port_bench.reference import gang as ref


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        t = ctx.traffic
        self.fill = ctx.config["fill"]
        self.emax = int(t["emax"])
        self.window = int(t["window"])
        self.n_apps = int(t["apps_per_group"])
        self.windows_per_chain = -(-self.n_apps // self.window)
        self.num_zones = int(ctx.config["cluster"]["zones"])
        self.kept: dict = {}

    # -------------------------------------------------------------- inputs

    def _queue_np(self, q: int) -> tuple:
        """Queue q: (driver, executor, count, skippable)."""
        t = self.ctx.traffic
        mix = generators.apps(generators.rng_for(self.ctx.seed, 1, q),
                              t["apps"], self.n_apps)
        if int(mix["executors"].max()) > self.emax:
            raise ValueError("an app of the table has more executors than emax")
        return (*generators.queue_apps(mix),
                np.full(self.n_apps, bool(t["skippable"])))

    def _window_rows(self, apps, w):
        lo = w * self.window
        return tuple(a[lo:lo + self.window] for a in apps)

    def setup(self) -> None:
        from spark_scheduler_tpu_torch.models.cluster import cluster_from_numpy
        from spark_scheduler_tpu_torch.ops.batched import (
            app_batch_to_device,
            make_app_batch,
        )
        from spark_scheduler_tpu_torch.ops.fifo import fifo_pack

        dev = self.ctx.device
        t = self.ctx.traffic
        self.fields = generators.queue_fields(
            generators.cluster(self.ctx.config["cluster"]))
        self.queues_np = [self._queue_np(q) for q in range(int(t["queues"]))]
        self.cluster = cluster_from_numpy(self.fields, device=dev)
        self.queues = []
        for apps in self.queues_np:
            wins = []
            for w in range(self.windows_per_chain):
                rows = self._window_rows(apps, w)
                wins.append(app_batch_to_device(make_app_batch(
                    *rows[:3], skippable=rows[3]), dev))
            self.queues.append(wins)
        self.solve = fifo_pack
        self.start_avail = self.cluster.available
        self.sampler = generators.rng_for(self.ctx.seed, 2)
        self.chain = 0

    # --------------------------------------------------------------- timed

    def _window(self, avail, apps):
        """One queue window: dispatch, then its decisions to the host."""
        out = self.solve(dataclasses.replace(self.cluster, available=avail),
                         apps, fill=self.fill, emax=self.emax,
                         num_zones=self.num_zones)
        host = (out.admitted.cpu(), out.driver_node.cpu(),
                out.executor_nodes.cpu())
        return out.available_after, host

    def _chain(self, deadline=None, record=None):
        """Run the next chain's windows (stopping at `deadline`); returns
        the windows' host seconds."""
        k = self.chain
        self.chain += 1
        q = k % len(self.queues)
        slot = self._slot(k) if record is not None else None
        if slot is not None:
            record[slot] = (k, q, [])
        avail, times = self.start_avail, []
        for w, apps in enumerate(self.queues[q]):
            if deadline is not None and time.perf_counter() >= deadline:
                break
            t0 = time.perf_counter()
            avail, host = self._window(avail, apps)
            t1 = time.perf_counter()
            times.append(t1 - t0)
            self.ctx.spans.add("queue.window", t0, t1)
            if slot is not None:
                record[slot][2].append((host, avail))
        return times

    def _slot(self, k: int):
        """Reservoir sampling (Vitter's algorithm R) of `sample_chains`
        chains over the measured chains: chain k takes a slot, or None."""
        m = int(self.ctx.traffic["sample_chains"])
        if k < m:
            return k
        j = int(self.sampler.integers(0, k + 1))
        return j if j < m else None

    def warmup(self) -> None:
        import torch

        for _ in range(int(self.ctx.traffic["warmup_chains"])):
            self._chain()
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize()
        self.chain = 0

    def measure(self, seconds: float) -> dict:
        kept: dict = {}
        times: list = []
        profile = None
        t0 = time.perf_counter()
        deadline = t0 + seconds
        slice_at = t0 + 0.4 * seconds
        want = int(self.ctx.traffic["profile_windows"])
        while time.perf_counter() < deadline:
            if (self.ctx.trace and profile is None
                    and time.perf_counter() >= slice_at):
                profile = DeviceProfile()
                n0 = len(times)
                with profile.slice():
                    while len(times) - n0 < want:
                        times += self._chain(record=kept)
                self.profiled = len(times) - n0
                continue
            times += self._chain(deadline, record=kept)
        elapsed = time.perf_counter() - t0
        self.kept = kept
        apps = len(times) * self.window
        records = self._records(profile) if profile is not None else None
        return {
            "end_to_end": {
                "queue_window_p95_ms": float(np.percentile(times, 95)) * 1e3,
                "queue_apps_per_s": apps / elapsed,
            },
            "attempted": len(times), "failed": 0,
            "records": records, "profile": profile,
            "notes": {"windows": len(times), "chains": self.chain,
                      "window p50 ms": float(np.percentile(times, 50)) * 1e3,
                      "sampled chains": sorted(k for k, _, _ in kept.values())},
        }

    def _records(self, profile) -> dict:
        """What the per-layer readers read: the profiled slice's device
        operations and the least time the queue kernel could take on each
        of its windows."""
        bound = roofline.queue_kernel_bound(
            nodes=len(self.fields[0]), groups=1, apps=self.window, live=self.window,
            emax=self.emax, num_zones=self.num_zones, fill=self.fill)
        return {
            "profile": profile, "windows": self.profiled,
            "kernel": "fifo_queue_kernel",
            "kernel_bound_s": bound * self.profiled,
        }

    def release(self) -> None:
        """Results of the sampled chains to the host; program state freed."""
        self.kept = {slot: (k, q, [(h, a.cpu().numpy()) for h, a in wins])
                     for slot, (k, q, wins) in self.kept.items()}
        self.queues = self.cluster = self.start_avail = None

    # --------------------------------------------------------------- check

    def reference_chain(self, q, windows, stale_by_one=False):
        """The plain reference over the first `windows` windows of queue q:
        per window, (rows, availability after). With `stale_by_one` each
        window starts from the availability the window before it started
        from, as a solve dispatched before the previous window's commit
        would (the control)."""
        out = []
        start = self.fields[0].astype(np.int64)
        avail, before = start, start
        for w in range(windows):
            apps = self._window_rows(self.queues_np[q], w)
            cl = _cl(self.fields, before if stale_by_one else avail)
            rows, after = ref.queue_pack(self.fill, cl, apps, self.emax,
                                         self.num_zones)
            before, avail = avail, after
            out.append((rows, after))
        return out

    def compare(self, stale_by_one=False) -> tuple[int, int, int]:
        """(windows compared, app decisions that differ, node availabilities
        that differ) between the kept chains and the reference."""
        windows = apps_bad = nodes_bad = 0
        for _slot, (_k, q, wins) in sorted(self.kept.items()):
            want = self.reference_chain(q, len(wins), stale_by_one)
            for (host, avail), (rows, ref_avail) in zip(wins, want):
                admitted, driver, execs = (np.asarray(x) for x in host)
                for j, (adm, _packed, drv, ex) in enumerate(rows):
                    got_ex = [int(e) for e in execs[j] if e >= 0]
                    if (bool(admitted[j]) != adm
                            or (adm and (int(driver[j]) != drv or got_ex != ex))):
                        apps_bad += 1
                nodes_bad += int((avail != ref_avail).any(axis=1).sum())
                windows += 1
        return windows, apps_bad, nodes_bad

    def check(self, control=False) -> list:
        """The kept chains against the reference; with `control`, against
        the reference whose windows start one window behind (the control)."""
        windows, apps_bad, nodes_bad = self.compare(stale_by_one=control)
        return [
            Check("windows_compared", windows, self.windows_per_chain, ">="),
            Check("decisions_differing", apps_bad, 0),
            Check("availability_nodes_differing", nodes_bad, 0),
        ]


def _cl(fields, available) -> dict:
    """A reference cluster from the generator's nine numpy fields."""
    return {
        "available": np.asarray(available, np.int64),
        "zone": fields[2].astype(np.int64),
        "name_rank": fields[3].astype(np.int64),
        "label_rank_driver": fields[4].astype(np.int64),
        "label_rank_executor": fields[5].astype(np.int64),
        "unschedulable": fields[6], "ready": fields[7], "valid": fields[8],
    }
