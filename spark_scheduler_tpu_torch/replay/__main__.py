"""Trace replay CLI, the port's copy of spark_scheduler_tpu/replay/__main__.py.

  python -m spark_scheduler_tpu_torch.replay info    TRACE
  python -m spark_scheduler_tpu_torch.replay verify  TRACE [--strict]
  python -m spark_scheduler_tpu_torch.replay whatif  TRACE --set binpack-algo=distribute-evenly [...]
  python -m spark_scheduler_tpu_torch.replay sweep   TRACE --grid binpack-algo=tightly-pack,distribute-evenly [...]
  python -m spark_scheduler_tpu_torch.replay generate {diurnal|bursty|churn} OUT --seed N [...]
  python -m spark_scheduler_tpu_torch.replay run     TRACE OUT

`verify` re-drives a captured trace and exits non-zero on any decision
divergence. `run` replays an input-only (generated) trace with binding
and re-captures it through the live TraceWriter wiring — its output is a
full captured trace that `verify` can then pin. `--set` takes repeated
`field=value` pairs (JSON parsed, falling back to raw string; dashes OK).

`sweep` replays ONE trace under the cartesian product of repeated
`--grid field=v1,v2,...` axes (plus `--set` overrides common to every
arm) concurrently over one shared host build — see replay/sweep.py.
Default output is the JSON summary; `--markdown` prints the grid-study
table instead. `verify`, `whatif`, `sweep` and `run` replay on the card
(`--device cuda`, the default) or on the CPU (`--device cpu`).
"""

from __future__ import annotations

import argparse
import json
import sys

from spark_scheduler_tpu_torch.replay.engine import replay_trace, what_if
from spark_scheduler_tpu_torch.replay.generators import GENERATORS, generate
from spark_scheduler_tpu_torch.replay.trace import TraceReader, config_hash


def _parse_sets(pairs: list[str]) -> dict:
    out = {}
    for p in pairs:
        key, sep, raw = p.partition("=")
        if not sep:
            raise SystemExit(f"--set expects field=value, got {p!r}")
        try:
            out[key] = json.loads(raw)
        except ValueError:
            out[key] = raw
    return out


def _parse_grid(pairs: list[str]) -> dict:
    """`--grid field=v1,v2,...` -> {field: [v1, v2, ...]} with each value
    JSON-parsed (falling back to raw string, same as `--set`)."""
    grid: dict = {}
    for p in pairs:
        key, sep, raw = p.partition("=")
        if not sep or not raw:
            raise SystemExit(f"--grid expects field=v1,v2,..., got {p!r}")
        vals = []
        for v in raw.split(","):
            try:
                vals.append(json.loads(v))
            except ValueError:
                vals.append(v)
        grid[key] = vals
    return grid


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m spark_scheduler_tpu_torch.replay")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("info", help="print a trace's header + event census")
    p.add_argument("trace")

    p = sub.add_parser("verify", help="replay; report decision divergence")
    p.add_argument("trace")
    p.add_argument("--strict", action="store_true",
                   help="raise on first summary of mismatches")

    p = sub.add_parser("whatif", help="replay base vs overridden config")
    p.add_argument("trace")
    p.add_argument("--set", dest="sets", action="append", default=[],
                   metavar="FIELD=VALUE", required=True)

    p = sub.add_parser("sweep", help="replay one trace under a config grid")
    p.add_argument("trace")
    p.add_argument("--grid", dest="grid", action="append", default=[],
                   metavar="FIELD=V1,V2,...",
                   help="grid axis; repeat for a cartesian product")
    p.add_argument("--set", dest="sets", action="append", default=[],
                   metavar="FIELD=VALUE",
                   help="override applied to every arm")
    p.add_argument("--no-accel", action="store_true",
                   help="disable certified top-K prune acceleration")
    p.add_argument("--markdown", action="store_true",
                   help="print the grid-study markdown table, not JSON")

    p = sub.add_parser("generate", help="emit a synthetic workload trace")
    p.add_argument("kind", choices=sorted(GENERATORS))
    p.add_argument("out")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--nodes", type=int, default=None)
    p.add_argument("--bursts", type=int, default=None,
                   help="burst count (bursty kind only)")
    p.add_argument("--binpack-algo", default=None)

    p = sub.add_parser("run", help="replay with binding; re-capture output")
    p.add_argument("trace")
    p.add_argument("out")

    for name in ("verify", "whatif", "sweep", "run"):
        sub.choices[name].add_argument(
            "--device", default="cuda", choices=("cuda", "cpu"),
            help="device of the replayed scheduler (default: the card)",
        )

    args = ap.parse_args(argv)

    if args.cmd == "info":
        r = TraceReader(args.trace)
        census: dict[str, int] = {}
        for ev in r.events():
            k = ev.get("k", "?")
            census[k] = census.get(k, 0) + 1
        print(json.dumps({
            "version": r.header.get("v"),
            "source": r.header.get("source"),
            "config_hash": config_hash(r.header["config"]),
            "meta": r.header.get("meta"),
            "events": census,
            "torn_tail": r.torn_tail,
            "malformed": r.malformed,
        }, indent=2, sort_keys=True))
        return 0

    if args.cmd == "verify":
        rep = replay_trace(
            args.trace, strict=args.strict, device=args.device
        )
        print(json.dumps(rep.summary(), indent=2, sort_keys=True))
        if rep.mismatches:
            for m in rep.mismatches[:10]:
                print(f"MISMATCH {m}", file=sys.stderr)
            return 1
        return 0

    if args.cmd == "whatif":
        print(json.dumps(
            what_if(args.trace, _parse_sets(args.sets), device=args.device),
            indent=2, sort_keys=True,
        ))
        return 0

    if args.cmd == "sweep":
        from spark_scheduler_tpu_torch.replay.sweep import grid_arms, run_sweep

        grid = _parse_grid(args.grid)
        base = _parse_sets(args.sets)
        arms = grid_arms(grid, base) if grid else [base]
        sw = run_sweep(
            args.trace, arms, accelerate=not args.no_accel,
            device=args.device,
        )
        if args.markdown:
            print(sw.markdown())
        else:
            print(json.dumps(sw.summary(), indent=2, sort_keys=True))
        return 0

    if args.cmd == "generate":
        sizing = {}
        if args.nodes is not None:
            sizing["n_nodes"] = args.nodes
        if args.bursts is not None:
            sizing["bursts"] = args.bursts
        if args.binpack_algo is not None:
            sizing["binpack_algo"] = args.binpack_algo
        stats = generate(args.kind, args.out, args.seed, **sizing)
        print(json.dumps(stats, indent=2, sort_keys=True))
        return 0

    if args.cmd == "run":
        rep = replay_trace(
            args.trace, record_path=args.out, device=args.device
        )
        print(json.dumps(rep.summary(), indent=2, sort_keys=True))
        return 0

    return 2


if __name__ == "__main__":
    sys.exit(main())
