"""The plain reference agrees with the port on the CPU at a small size:
every window of the kept queue chains."""

import time

from port_bench import run


def test_queue_reference_agrees_with_the_port(small):
    out = run.run_cell("queue-10k-w100", 2**31 + 11, 3.0, False, device="cpu",
                       t_start=time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["checks"]["windows_compared"]["value"] >= 4
