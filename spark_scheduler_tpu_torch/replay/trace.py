"""Versioned JSONL decision-trace codec.

The port's copy of spark_scheduler_tpu/replay/trace.py. The byte format
is the contract: for the same session the port writes the same bytes as
the JAX package, header and `config_hash` included (the two packages'
InstallConfig carry the same fields in the same order).

A trace is a complete, self-contained re-execution input for the
extender/solver: one header line carrying the active InstallConfig
fingerprint, then every INPUT a decision consumed in arrival order —
backend node/pod events (keyed by the registry epoch), predicate requests,
and explicit reconcile / reservation-delete directives. Scheduler-
ORIGINATED writes (reservations, demands, binds the engine itself makes)
are deliberately NOT journaled: replay regenerates them, which is exactly
what makes bit-identity a checkable property rather than a tautology.
Recorded `result` events carry the verdict/placement/failure-map the live
run answered, so replay (replay/engine.py) can assert byte-identical
decisions event-for-event.

Format: one canonical JSON object per line (sorted keys, no spaces), so
write -> read -> write round-trips byte-identically. Event kinds:

  header     {"k","v","config","hash","source","t","meta"}
  node       {"k","s","t","op":add|update|delete, "node"|"name", "epoch"}
  pod        {"k","s","t","op":add|update|delete, "pod"|{"ns","name"}}
  rr         {"k","s","t","op":"add","rr":<wire>}      (bootstrap only)
  predicate  {"k","s","t","w","mode":solo|window,"bind","reqs":[...]}
  result     {"k","s","t","w","res":[[outcome,node,failed],...]}
  decision   {"k","s","t","rec":<DecisionRecord>}       (informational)
  rr_delete  {"k","s","t","ns","name"}
  reconcile  {"k","s","t"}
  meta       {"k","s","t", ...free-form...}

`failed` in a result row is None (success), the compressed uniform form
["u", message, count] when every candidate carries the same reason (the
overwhelmingly common denial shape), or the explicit per-node map. A
predicate request whose candidate list equals the writer's full roster
mirror stores "*" instead of repeating 10k names per request, and one
whose pod is identity-equal to the object the backend holds (i.e. the
stream already carries its bytes in a pod add/update event) stores
{"ref": [ns, name]} instead of the full wire pod.

Durability posture mirrors store/durable.py: the reader tolerates a torn
final line (crash mid-append) silently and counts mid-file corruption,
and the writer NEVER fails the serving path — IO errors are swallowed
and surfaced as a counter (/debug/trace, foundry.spark.scheduler.trace.*).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import threading
import time
from typing import Any, Iterator, Optional

TRACE_VERSION = 1

# Candidate-list sentinel: "the writer's full node roster at this point of
# the stream" ("*" is not a valid k8s node name).
ALL_NODES = "*"


# One shared encoder instance: json.dumps() with non-default options
# builds a fresh JSONEncoder per call, and dumps_event rides the serving
# path once per journaled event.
_ENCODER = json.JSONEncoder(
    separators=(",", ":"), sort_keys=True, ensure_ascii=False
)


def dumps_event(ev: dict) -> str:
    """THE canonical encoding — sorted keys, no spaces — shared by the
    writer, the round-trip test, and the generators' byte-identity
    contract."""
    return _ENCODER.encode(ev)


# --------------------------------------------------------------- fingerprint


def config_fingerprint(config) -> dict:
    """The InstallConfig as plain JSON-able data (nested dataclasses —
    FifoConfig, LabelPriorityOrder — become dicts)."""
    return dataclasses.asdict(config)


def config_hash(fingerprint: dict) -> str:
    return hashlib.sha256(dumps_event(fingerprint).encode()).hexdigest()[:16]


def config_from_fingerprint(
    fingerprint: dict,
    overrides: Optional[dict] = None,
    forced: Optional[dict] = None,
):
    """Rebuild an InstallConfig from a trace header. Unknown keys (a trace
    written by a newer build) are dropped; `overrides` is the what-if
    surface (field names, dashes accepted); `forced` wins last (the replay
    engine pins the backend-free harness fields)."""
    from spark_scheduler_tpu_torch.core.extender import FifoConfig
    from spark_scheduler_tpu_torch.server.config import (
        InstallConfig,
        LabelPriorityOrder,
    )

    known = {f.name for f in dataclasses.fields(InstallConfig)}
    kw = {k: v for k, v in fingerprint.items() if k in known}
    if isinstance(kw.get("fifo_config"), dict):
        kw["fifo_config"] = FifoConfig(**kw["fifo_config"])
    for key in (
        "driver_prioritized_node_label",
        "executor_prioritized_node_label",
    ):
        if isinstance(kw.get(key), dict):
            kw[key] = LabelPriorityOrder(**kw[key])
    for src in (overrides or {}), (forced or {}):
        for k, v in src.items():
            k = k.replace("-", "_")
            if k not in known:
                raise KeyError(f"unknown config field: {k}")
            kw[k] = v
    return InstallConfig(**kw)


# ------------------------------------------------------------- failure maps


def normalize_failed(
    failed: Optional[dict], candidates: list[str]
) -> Optional[Any]:
    """Canonical encoding of an ExtenderFilterResult failure map. The
    extender's _fail builds {name: message for name in candidates} — one
    uniform reason across exactly the candidate set — so that shape
    compresses to ["u", message, count]; anything else (solver-built maps,
    truncated maps) stays explicit. Success (empty map) is None."""
    if not failed:
        return None
    msgs = set(failed.values())
    if (
        len(msgs) == 1
        and len(failed) == len(candidates)
        and set(failed) == set(candidates)
    ):
        return ["u", next(iter(msgs)), len(failed)]
    return dict(failed)


def encode_result(res, candidates: list[str]) -> list:
    """[outcome, placed-node-or-None, normalized failure map] — the
    bit-identity tuple replay compares."""
    return [
        res.outcome,
        res.node_names[0] if res.node_names else None,
        normalize_failed(res.failed_nodes, candidates),
    ]


# ------------------------------------------------------------------- writer


class TraceWriter:
    """Append-only JSONL trace sink.

    One instance serves three producers: backend subscriptions (node/pod
    events), the extender's capture wrappers (predicate/result events),
    and the FlightRecorder sink hook (decision events). All three ride the
    serving path, so every write is one lock + one buffered file append,
    and an IO failure is counted, never raised."""

    def __init__(
        self,
        path: str,
        *,
        clock=time.time,
        decisions: bool = False,
        epoch_fn=None,
        source: str = "server",
    ):
        self.path = path
        self._clock = clock
        self._decisions = decisions
        self._epoch_fn = epoch_fn
        self._source = source
        self._lock = threading.Lock()
        self._seq = 0
        self._wid = 0
        # Node-roster mirror for the "*" candidate compression: appended on
        # add, removed on delete, order-stable on update — exactly the dict
        # insertion order backend.list_nodes() yields.
        self._roster: list[str] = []
        self._roster_set: set[str] = set()
        # (ns, name) -> id(pod) of the object the backend currently holds,
        # maintained by the pod hooks. A predicate request whose pod IS
        # that object (identity, not equality — cheap and sufficient)
        # journals as {"ref": [ns, name]} instead of re-dumping the full
        # wire pod the stream already carries; replay resolves the ref
        # against its backend. This halves the serving-path encode cost:
        # the pod bytes ride the trace exactly once.
        self._pod_ids: dict[tuple, int] = {}
        # wid -> per-request candidate lists, parked between on_predicate
        # and on_results so result rows normalize against the REAL request
        # candidates (the uniform ["u", msg, count] form must not equate
        # two different node sets of the same size).
        self._candidates: dict[int, list[list[str]]] = {}
        self.events = 0
        self.bytes = 0
        self.write_errors = 0
        # 1 MiB buffer: the serving path pays one syscall per megabyte of
        # trace instead of one per ~8 KiB; flush()/close() still make the
        # stream durable at the points the harness and tests rely on.
        self._fh = open(path, "w", encoding="utf-8", buffering=1 << 20)

    # -- plumbing ----------------------------------------------------------

    def _emit(self, ev: dict) -> None:
        with self._lock:
            self._seq += 1
            ev["s"] = self._seq
            ev.setdefault("t", self._clock())
            try:
                line = dumps_event(ev)
                self._fh.write(line + "\n")
                self.events += 1
                self.bytes += len(line) + 1
            except Exception:
                self.write_errors += 1

    def _next_wid(self) -> int:
        with self._lock:
            self._wid += 1
            return self._wid

    def _epoch(self):
        fn = self._epoch_fn
        if fn is None:
            return None
        try:
            return fn()
        except Exception:
            return None

    # -- header / bootstrap ------------------------------------------------

    def write_header(self, config, meta: Optional[dict] = None) -> None:
        fp = config_fingerprint(config)
        # The trace's own output path is self-referential noise: it can't
        # influence a decision, and keeping it would make two otherwise
        # identical re-captures differ byte-wise on their header line.
        fp["trace_path"] = None
        self._emit(
            {
                "k": "header",
                "v": TRACE_VERSION,
                "config": fp,
                "hash": config_hash(fp),
                "source": self._source,
                "meta": meta or {},
            }
        )

    def bootstrap(self, backend) -> None:
        """Journal the pre-existing world (a writer attached to a live
        server mid-life): nodes, pods, and hard reservations, so the trace
        stands alone. Call BEFORE subscribing the event hooks."""
        from spark_scheduler_tpu_torch.server.kube_io import node_to_k8s, pod_to_k8s
        from spark_scheduler_tpu_torch.store.durable import _rr_to_record

        for node in backend.list_nodes():
            self.on_node_add(node)
        for pod in backend.list("pods"):
            self._emit({"k": "pod", "op": "add", "pod": pod_to_k8s(pod)})
        try:
            rrs = backend.list("resourcereservations")
        except Exception:
            rrs = []
        for rr in rrs:
            self._emit({"k": "rr", "op": "add", "rr": _rr_to_record(rr)})

    # -- backend event hooks ----------------------------------------------

    def on_node_add(self, node) -> None:
        from spark_scheduler_tpu_torch.server.kube_io import node_to_k8s

        with self._lock:
            if node.name not in self._roster_set:
                self._roster.append(node.name)
                self._roster_set.add(node.name)
        self._emit(
            {
                "k": "node",
                "op": "add",
                "node": node_to_k8s(node),
                "epoch": self._epoch(),
            }
        )

    def on_node_update(self, old, new) -> None:
        from spark_scheduler_tpu_torch.server.kube_io import node_to_k8s

        self._emit(
            {
                "k": "node",
                "op": "update",
                "node": node_to_k8s(new),
                "epoch": self._epoch(),
            }
        )

    def on_node_delete(self, node) -> None:
        with self._lock:
            if node.name in self._roster_set:
                self._roster.remove(node.name)
                self._roster_set.discard(node.name)
        self._emit(
            {
                "k": "node",
                "op": "delete",
                "name": node.name,
                "epoch": self._epoch(),
            }
        )

    def on_pod_add(self, pod) -> None:
        from spark_scheduler_tpu_torch.server.kube_io import pod_to_k8s

        self._pod_ids[(pod.namespace, pod.name)] = id(pod)
        self._emit({"k": "pod", "op": "add", "pod": pod_to_k8s(pod)})

    def on_pod_update(self, old, new) -> None:
        from spark_scheduler_tpu_torch.server.kube_io import pod_to_k8s

        self._pod_ids[(new.namespace, new.name)] = id(new)
        self._emit({"k": "pod", "op": "update", "pod": pod_to_k8s(new)})

    def on_pod_delete(self, pod) -> None:
        self._pod_ids.pop((pod.namespace, pod.name), None)
        self._emit(
            {
                "k": "pod",
                "op": "delete",
                "ns": pod.namespace,
                "name": pod.name,
            }
        )

    # -- extender capture --------------------------------------------------

    def on_predicate(self, args_list, mode: str, bind: bool = False) -> int:
        """Journal one serving window's (or solo request's) inputs; returns
        the window id its `result` event will carry."""
        from spark_scheduler_tpu_torch.server.kube_io import pod_to_k8s

        wid = self._next_wid()
        reqs = []
        candidates = []
        with self._lock:
            roster = list(self._roster)
        for args in args_list:
            names = list(args.node_names)
            candidates.append(names)
            stored: Any = ALL_NODES if names == roster else names
            pod = args.pod
            key = (pod.namespace, pod.name)
            if self._pod_ids.get(key) == id(pod):
                # the stream already carries these exact pod bytes (the
                # add/update event for THIS object) — reference, don't
                # re-dump. A distinct-but-equal object (e.g. a pod parsed
                # fresh from an HTTP body) journals inline: identity is
                # the only cheap proof the backend copy matches.
                reqs.append({"ref": [pod.namespace, pod.name], "nodes": stored})
            else:
                reqs.append({"pod": pod_to_k8s(pod), "nodes": stored})
        with self._lock:
            self._candidates[wid] = candidates
        ev: dict = {"k": "predicate", "w": wid, "mode": mode, "reqs": reqs}
        if bind:
            ev["bind"] = True
        self._emit(ev)
        return wid

    def on_results(self, wid: int, results) -> None:
        with self._lock:
            candidates = self._candidates.pop(wid, None)
        if candidates is None:
            candidates = [list(r.failed_nodes) for r in results]
        self._emit(
            {
                "k": "result",
                "w": wid,
                "res": [
                    encode_result(r, c) for r, c in zip(results, candidates)
                ],
            }
        )

    # -- recorder sink -----------------------------------------------------

    def on_decision(self, rec) -> None:
        if self._decisions:
            self._emit({"k": "decision", "rec": rec.to_dict()})

    # -- directives --------------------------------------------------------

    def emit_rr_delete(self, namespace: str, name: str) -> None:
        self._emit({"k": "rr_delete", "ns": namespace, "name": name})

    def emit_reconcile(self) -> None:
        self._emit({"k": "reconcile"})

    def emit_meta(self, **kw) -> None:
        self._emit({"k": "meta", **kw})

    # -- lifecycle ---------------------------------------------------------

    def stats(self) -> dict:
        return {
            "path": self.path,
            "events": self.events,
            "bytes": self.bytes,
            "write_errors": self.write_errors,
            "windows": self._wid,
        }

    def flush(self) -> None:
        try:
            self._fh.flush()
        except Exception:
            self.write_errors += 1

    def close(self) -> None:
        try:
            self._fh.flush()
            self._fh.close()
        except Exception:
            self.write_errors += 1


# ------------------------------------------------------------------- reader


class TraceReader:
    """Streaming trace reader with durable.py's tail discipline: a parse
    failure on the LAST line is a torn tail (crash mid-append) and is
    silently ignored; a failure mid-file is corruption, counted and
    skipped so the rest of the trace still replays."""

    def __init__(self, path: str):
        self.path = path
        self.header: Optional[dict] = None
        self.malformed = 0
        self.torn_tail = False
        with open(path, "r", encoding="utf-8") as fh:
            first = fh.readline()
        try:
            header = json.loads(first)
        except (json.JSONDecodeError, ValueError):
            raise ValueError(f"trace {path}: unreadable header line")
        if header.get("k") != "header":
            raise ValueError(f"trace {path}: first line is not a header")
        version = header.get("v")
        if version != TRACE_VERSION:
            raise ValueError(
                f"trace {path}: version {version} "
                f"(this build reads {TRACE_VERSION})"
            )
        self.header = header

    def events(self) -> Iterator[dict]:
        """Every event after the header, in stream order."""
        with open(self.path, "r", encoding="utf-8") as fh:
            lines = fh.read().split("\n")
        if lines and lines[-1] == "":
            lines.pop()
        last = len(lines) - 1
        for i, line in enumerate(lines):
            if i == 0:
                continue  # header, parsed in __init__
            try:
                yield json.loads(line)
            except (json.JSONDecodeError, ValueError):
                if i == last:
                    self.torn_tail = True
                else:
                    self.malformed += 1

    def raw_lines(self) -> list[str]:
        """Parseable lines verbatim (round-trip tests)."""
        with open(self.path, "r", encoding="utf-8") as fh:
            out = fh.read().split("\n")
        if out and out[-1] == "":
            out.pop()
        return out
