"""The single-AZ queue driver: the queue driver's windows, timing,
reservoir sampling and control, checked against the plain single-AZ
reference (`reference/single_az.py`) in place of `reference/gang.py`, and
its records with a second bound. Traffic keys as the queue driver's.

The program's solve is `ops.fifo.fifo_pack_with_scores`, the same solve
as `fifo_pack` with the score of the zone each packed row chose. The
scores of the kept chains stay on the device until `release`, so the timed
path copies to the host only what the queue driver copies. The check
compares each row's score with the reference's float32 score, relative
difference at most SCORE_REL_LIMIT: the decisions alone cannot tell a
float32 score from a float16 one on this traffic. A program without the
scores cannot be checked, and gives no result.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from port_bench import harness, roofline
from port_bench.harness import BenchError, Check
from port_bench.reference import single_az

queue = harness.load_module("drivers", "queue")

# Largest relative difference between a row's zone score and the
# reference's: 84 float32 spacings of a score (2^-23 each), and a 49th of
# float16's rounding step (2^-11), which a score computed in float16 misses
# by.
SCORE_REL_LIMIT = 1e-5


class Driver(queue.Driver):
    def setup(self) -> None:
        from spark_scheduler_tpu_torch.ops import fifo

        if not hasattr(fifo, "fifo_pack_with_scores"):
            raise BenchError("the program reports no zone scores "
                             "(ops.fifo.fifo_pack_with_scores)")
        super().setup()
        self.solve = fifo.fifo_pack_with_scores

    def _window(self, avail, apps):
        """One queue window, as the queue driver's; the zone scores ride
        with the host copies, still on the device."""
        out, scores = self.solve(
            dataclasses.replace(self.cluster, available=avail), apps,
            fill=self.fill, emax=self.emax, num_zones=self.num_zones)
        host = (out.admitted.cpu(), out.driver_node.cpu(),
                out.executor_nodes.cpu(), scores)
        return out.available_after, host

    def _records(self, profile) -> dict:
        """The queue driver's records, and `one_pass_bound_s`: the least
        time with one pass over the nodes a live row. The zones partition
        the nodes, so the zone fills of a gang together need no more node
        work than one plain fill."""
        records = super()._records(profile)
        bound = roofline.queue_kernel_bound(
            nodes=len(self.fields[0]), groups=1, apps=self.window,
            live=self.window, emax=self.emax, num_zones=1, fill="tightly-pack")
        records["one_pass_bound_s"] = bound * self.profiled
        return records

    def release(self) -> None:
        super().release()
        self.kept = {slot: (k, q, [((*h[:3], h[3].cpu().numpy()), a)
                                   for h, a in wins])
                     for slot, (k, q, wins) in self.kept.items()}

    def reference_chain(self, q, windows, stale_by_one=False):
        """As the queue driver's, with the single-AZ reference, which also
        reads the nodes' schedulable resources (the zone score's
        denominators)."""
        out = []
        start = self.fields[0].astype(np.int64)
        sched = self.fields[1].astype(np.int64)
        avail, before = start, start
        for w in range(windows):
            apps = self._window_rows(self.queues_np[q], w)
            cl = dict(queue._cl(self.fields, before if stale_by_one else avail),
                      schedulable=sched)
            rows, after = single_az.queue_pack(self.fill, cl, apps, self.emax,
                                               self.num_zones)
            before, avail = avail, after
            out.append((rows, after))
        return out

    def compare(self, stale_by_one=False) -> tuple[int, int, int, float]:
        """As the queue driver's, and the largest relative difference
        between a row's zone score and the reference's (`_rel`)."""
        windows = apps_bad = nodes_bad = 0
        worst = 0.0
        for _slot, (_k, q, wins) in sorted(self.kept.items()):
            want = self.reference_chain(q, len(wins), stale_by_one)
            for (host, avail), (rows, ref_avail) in zip(wins, want):
                admitted, driver, execs, scores = (np.asarray(x) for x in host)
                for j, (adm, _packed, drv, ex, score) in enumerate(rows):
                    got_ex = [int(e) for e in execs[j] if e >= 0]
                    if (bool(admitted[j]) != adm
                            or (adm and (int(driver[j]) != drv or got_ex != ex))):
                        apps_bad += 1
                    worst = max(worst, _rel(scores[j], score))
                nodes_bad += int((avail != ref_avail).any(axis=1).sum())
                windows += 1
        return windows, apps_bad, nodes_bad, worst

    def check(self, control=False) -> list:
        windows, apps_bad, nodes_bad, worst = self.compare(stale_by_one=control)
        return [
            Check("windows_compared", windows, self.windows_per_chain, ">="),
            Check("decisions_differing", apps_bad, 0),
            Check("availability_nodes_differing", nodes_bad, 0),
            Check("zone_score_max_rel_diff", worst, SCORE_REL_LIMIT),
        ]


def _rel(got, want) -> float:
    """|got - want| over the larger magnitude: 0 where they are equal, 1
    where one is 0 and the other not, and 1 for a score that is not a
    finite number."""
    got, want = float(got), float(want)
    if got == want:
        return 0.0
    if not math.isfinite(got):
        return 1.0
    return abs(got - want) / max(abs(got), abs(want))
