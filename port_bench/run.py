#!/usr/bin/env python3
"""Run one benchmark cell of the PyTorch/CUDA port once.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's configuration and traffic (`workloads/<cell>.json`,
`configs/<config>.json`), builds the port's kernels into `port_bench/.build/`
(the first run of a checkout compiles; later runs load), sets the cell up
from the seed, warms it up, measures for `--seconds`, then checks what the
timed path produced against the plain reference in `reference/`. Earlier
lines on standard error say what ran where; the last lines there are the
numbers compared, each beside its limit. The last line on standard output
is the result: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics with `--trace 0`, its per-layer metrics with
`--trace 1`), `device`, with `--trace 1` a `breakdown`, and `checks`.

Exits non-zero, with no result line, without a CUDA card, when the cell's
files are missing, or when JAX or the JAX package got loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from port_bench import harness  # noqa: E402
from port_bench.harness import BenchError, log  # noqa: E402


class Context:
    """What a traffic driver gets: the cell, its configuration, the seed,
    the device, and the spans it records."""

    def __init__(self, name, cell, config, seed, seconds, device, trace):
        self.name, self.cell, self.config = name, cell, config
        self.traffic = cell["traffic"]
        self.seed, self.seconds = seed, seconds
        self.device, self.trace = device, trace
        self.spans = harness.Spans()


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device=None, t_start: float | None = None, patch=None) -> dict:
    """One run of cell `name`; returns the result object. `device` None
    asks for the card the cell needs (tests pass "cpu"); `patch(driver)`
    may break the timed path after set-up (the fault tests). The driver is
    kept as `run_cell.last_driver` (the control reads it)."""
    import torch

    t_start = T_START if t_start is None else t_start
    bench = harness.benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise BenchError(f"BENCHMARK.json has no cell {name!r}")
    cell = harness.load_json("workloads", name)
    config = harness.load_json("configs", cell["config"])
    harness.pin_caches()
    on_card = device is None
    if on_card:
        device = harness.require_cards(entry["chips"])
        harness.build_program()
        card = {"kind": torch.cuda.get_device_name(device),
                "count": torch.cuda.device_count()}
        log(f"card: {card['kind']} ({card['count']} CUDA devices); "
            f"nvidia-smi {harness.smi_sample()}")
    else:
        device = torch.device(device)
    ctx = Context(name, cell, config, seed, seconds, device, trace)
    driver = harness.load_module("drivers", cell["driver"]).Driver(ctx)
    try:
        if trace:
            # Kineto initialises on the thread that first profiles.
            harness.DeviceProfile.init_here()
        driver.setup()
        if patch is not None:
            patch(driver)
        driver.warmup()
        setup_s = time.perf_counter() - t_start
        log(f"{name}: set up and warmed up in {setup_s:.3f} s; measuring "
            f"{seconds} s (trace {int(trace)})")
        smi_before = harness.smi_sample() if on_card else {}
        out = driver.measure(seconds)
        smi_after = harness.smi_sample() if on_card else {}
        peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    finally:
        driver.release()
    run_cell.last_driver = driver
    t_check = time.perf_counter()
    checks = driver.check()
    log(f"{name}: the reference took {time.perf_counter() - t_check:.3f} s")
    e2e, per_layer = harness.cell_metrics(bench, name)
    metrics = {}
    if not trace:
        values = dict(out["end_to_end"], setup_s=setup_s)
        for m in e2e:
            if m["name"] not in values:
                raise BenchError(f"driver {cell['driver']} gave no {m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        for m in per_layer:
            value = harness.load_module("metrics", m["name"]).read(out["records"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": bool(checks) and all(c.ok for c in checks),
        "attempted": out["attempted"],
        "failed": out["failed"],
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else str(device),
            "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
            "count": 1,
            "memory_peak_bytes": peak,
        },
    }
    profile = out.get("profile")
    if trace and profile is not None:
        result["device"]["busy_s"] = profile.busy_s()
        result["device"]["window_s"] = profile.window_s
        result["breakdown"] = profile.breakdown(ctx.spans)
    result["checks"] = {c.name: c.as_json() for c in checks}
    log(f"{name}: nvidia-smi beside the window: before {smi_before}, after "
        f"{smi_after}")
    for key, val in out.get("notes", {}).items():
        log(f"{name}: {key}: {val}")
    for m, v in metrics.items():
        log(f"{name}: {m} = {v['value']!r} {v['unit']}")
    log(f"{name}: attempted {out['attempted']}, failed {out['failed']}, "
        f"memory peak {peak} bytes, correct {result['correct']}")
    for c in checks:
        log(f"check {c.name}: {c.value!r} (limit {c.rule} {c.limit!r}) "
            f"{'ok' if c.ok else 'FAILED'}")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace))
    except BenchError as exc:
        log(f"no result: {exc}")
        return 2
    bad = harness.forbidden_modules()
    if bad:
        log(f"no result: loaded in this process: {', '.join(bad)}")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
