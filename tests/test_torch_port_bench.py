"""The benchmark's queue cell on the CPU at a small size, so that a change
to the queue path (`ops/fifo.fifo_pack`, its orders, its outputs) that
would break the cell shows in this suite before a run on the card:

  - the driver's windows agree with the plain reference
    (`port_bench/reference/gang.py`) and the run reads `correct`;
  - the control (each window started from where the window before it
    started) reads `correct` false on the port's own output;
  - a timed path broken underneath (state left unchanged, half a window
    left out, an answer altered) reads `correct` false.

The cell is shrunk by `port_bench/tests/conftest.py::shrink` (400 nodes,
short queues, seconds of traffic) and runs on one CPU thread; the cache
variables the harness sets are put back after each test.
"""

import os
import time

import pytest
import torch

from port_bench import control, harness, run
from port_bench.tests.conftest import shrink
from port_bench.tests.test_bench_control import _queue_fault

CELL = "queue-10k-w100"


@pytest.fixture
def small(monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("USE_FLAX", os.environ.get("USE_FLAX", "0"))
    for key in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR"):
        monkeypatch.setenv(key, os.environ.get(key, ""))
    load = harness.load_json
    monkeypatch.setattr(harness, "load_json",
                        lambda kind, name: shrink(load(kind, name), kind))
    yield
    torch.set_num_threads(threads)


def test_queue_cell_windows_match_the_reference(small):
    out = run.run_cell(CELL, 2**31 + 2201, 2.0, False, device="cpu",
                       t_start=time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["checks"]["windows_compared"]["value"] >= 4
    assert out["checks"]["decisions_differing"]["value"] == 0
    assert out["failed"] == 0 and out["attempted"] > 0


def test_queue_cell_control_reads_incorrect(small):
    r = control.readings(CELL, 2**31 + 2202, 2.0, device="cpu")
    assert r["correct"] and r["reference"]["decisions_differing"] == 0
    assert r["control"]["decisions_differing"] > 0


@pytest.mark.parametrize(
    "kind", ["state_unchanged", "half_left_out", "answer_altered"]
)
def test_queue_cell_broken_path_reads_incorrect(kind, small):
    out = run.run_cell(CELL, 2**31 + 2203, 1.5, False, device="cpu",
                       t_start=time.perf_counter(), patch=_queue_fault(kind))
    assert not out["correct"], out["checks"]
