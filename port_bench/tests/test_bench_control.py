"""The correctness check fails what it must: the control (the reference
starting each queue window from the availability one commit behind) reads
above the limit on the port's own output, and a run whose timed path is
broken underneath reads `correct` false: a step that returns its state
unchanged, half of a window left out, an answer altered where it is
produced. One card, so no exchange between chips can be left out."""

import time

import pytest
import torch

from port_bench import control, run

DIFFERING = {"queue-10k-w100": "decisions_differing"}


@pytest.mark.parametrize("cell", sorted(DIFFERING))
def test_the_control_fails_and_the_reference_passes(cell, small):
    r = control.readings(cell, 2**31 + 21, 3.0, device="cpu")
    assert r["correct"] and r["reference"][DIFFERING[cell]] == 0
    assert r["control"][DIFFERING[cell]] > 0


def _queue_fault(kind):
    def patch(driver):
        solve = driver.solve

        def broken(cluster, apps, **kw):
            out = solve(cluster, apps, **kw)
            if kind == "state_unchanged":
                return out._replace(available_after=cluster.available.clone())
            if kind == "half_left_out":
                adm = out.admitted.clone()
                adm[..., adm.shape[-1] // 2:] = False
                return out._replace(admitted=adm)
            hits = torch.nonzero(out.admitted.reshape(-1))
            if len(hits) == 0:
                return out
            drv = out.driver_node.clone()
            flat = drv.reshape(-1)
            flat[int(hits[0])] = (flat[int(hits[0])] + 1) % cluster.available.shape[-2]
            return out._replace(driver_node=drv)

        driver.solve = broken
    return patch


@pytest.mark.parametrize("cell,kind", [
    (c, k) for c in ("queue-10k-w100",)
    for k in ("state_unchanged", "half_left_out", "answer_altered")])
def test_a_broken_timed_path_reads_incorrect(cell, kind, small):
    out = run.run_cell(cell, 2**31 + 31, 1.5, False, device="cpu",
                       t_start=time.perf_counter(), patch=_queue_fault(kind))
    assert not out["correct"], out["checks"]
