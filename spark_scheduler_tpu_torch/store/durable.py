"""File-backed durable ClusterBackend (the etcd slot).

In the reference, reservations/demands persist in etcd via CRDs — the CRDs
*are* the checkpoint (SURVEY.md §5.4): a restarted leader refills its cache
from the apiserver (cache/resourcereservations.go:53-60) and reconciles
drift from observed pods (failover.go:35-72). `DurableBackend` gives a
standalone deployment the same property without an apiserver: every
mutation appends one JSON-line record (k8s wire-shaped object payloads) to
a log; on startup the log replays into memory, after which the normal
failover reconciliation runs against real persisted state.

Record format (one JSON object per line):

    {"verb": "create|update|delete", "kind": "<collection>",
     "ns": "...", "name": "...", "object": {<k8s wire form>}}
    {"verb": "register_crd"|"unregister_crd", "name": "...",
     "definition": {...}}

`compact()` rewrites the log as one create per live object (the etcd
compaction analog) — callable any time; the scheduler also compacts on
startup after replay so the log stays bounded across restart cycles.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Optional

from spark_scheduler_tpu_torch.models.demands import Demand
from spark_scheduler_tpu_torch.models.kube import Node, Pod
from spark_scheduler_tpu_torch.models.reservations import ResourceReservation
from spark_scheduler_tpu_torch.store.backend import InMemoryBackend


def _rr_to_record(rr: ResourceReservation) -> dict:
    from spark_scheduler_tpu_torch.server.conversion import rr_v1beta2_to_wire

    wire = rr_v1beta2_to_wire(rr)
    # The ownerReference to the driver pod normally lives in ObjectMeta
    # (newResourceReservation sets it); models carry it as owner_pod_uid.
    if rr.owner_pod_uid and not wire["metadata"].get("ownerReferences"):
        wire["metadata"]["ownerReferences"] = [
            {"apiVersion": "v1", "kind": "Pod", "uid": rr.owner_pod_uid}
        ]
    return wire


def _rr_from_record(raw: dict) -> ResourceReservation:
    from spark_scheduler_tpu_torch.server.conversion import rr_v1beta2_from_wire

    rr = rr_v1beta2_from_wire(raw)
    for ref in (raw.get("metadata") or {}).get("ownerReferences") or []:
        if ref.get("kind") == "Pod" and ref.get("uid"):
            rr.owner_pod_uid = ref["uid"]
            break
    return rr


def _demand_to_record(d: Demand) -> dict:
    from spark_scheduler_tpu_torch.server.conversion import demand_v1alpha2_to_wire

    return demand_v1alpha2_to_wire(d)


def _demand_from_record(raw: dict) -> Demand:
    from spark_scheduler_tpu_torch.server.conversion import demand_v1alpha2_from_wire

    return demand_v1alpha2_from_wire(raw)


def _pod_to_record(p: Pod) -> dict:
    from spark_scheduler_tpu_torch.server.kube_io import pod_to_k8s

    return pod_to_k8s(p)


def _pod_from_record(raw: dict) -> Pod:
    from spark_scheduler_tpu_torch.server.kube_io import pod_from_k8s

    return pod_from_k8s(raw)


def _node_to_record(n: Node) -> dict:
    from spark_scheduler_tpu_torch.server.kube_io import node_to_k8s

    return node_to_k8s(n)


def _node_from_record(raw: dict) -> Node:
    from spark_scheduler_tpu_torch.server.kube_io import node_from_k8s

    return node_from_k8s(raw)


def _lease_to_record(lease) -> dict:
    return lease.to_wire()


def _lease_from_record(raw: dict):
    from spark_scheduler_tpu_torch.ha.lease import LeaseRecord

    return LeaseRecord.from_wire(raw)


_CODECS = {
    "pods": (_pod_to_record, _pod_from_record),
    "nodes": (_node_to_record, _node_from_record),
    "resourcereservations": (_rr_to_record, _rr_from_record),
    "demands": (_demand_to_record, _demand_from_record),
    # HA leader lease (ha/lease.py): renewals ride the WAL like any other
    # mutation; replay restores the epoch so fencing stays monotonic
    # across restarts. (Multi-PROCESS deployments arbitrate through the
    # flock-guarded FileLeaseStore sidecar instead — the WAL has no
    # cross-process CAS.)
    "leases": (_lease_to_record, _lease_from_record),
}


class DurableBackend(InMemoryBackend):
    """InMemoryBackend + JSONL write-ahead persistence. Replays the log on
    construction (before any component subscribes, so no spurious events
    fire), then compacts it."""

    def __init__(
        self,
        path: str,
        fsync: bool = False,
        compact_on_load: bool = True,
        follow: bool = False,
    ):
        super().__init__()
        self.path = path
        self._fsync = fsync
        self._log_lock = threading.Lock()
        self._replaying = False
        self._file: Optional[Any] = None
        # FOLLOWER mode (HA warm standby over a shared WAL): read-only —
        # never compacts, never truncates, never opens an append handle;
        # `poll_log()` tails the leader's appended records and applies
        # them WITH events so subscribed caches stay warm. A promoted
        # follower calls `promote_to_writer()` before its first write.
        self._follow = follow
        # End offset of the last complete record consumed (replay/poll).
        self._log_offset = 0
        # FaultInjector seam (wal.<op>.<kind>): fn(op, record) fired
        # inside _append — raising makes the commit fail exactly where a
        # full disk or torn fsync would.
        self.wal_fault_hook = None
        # Records whose append FAILED after their in-memory commit. The
        # base backend commits, then _on_committed appends — so by the
        # time an append can fail, the state change is already visible
        # and a caller's retry is an AlreadyExists no-op that never
        # re-appends. Parking the record and draining the buffer ahead of
        # the next successful append (commit order preserved: the lock is
        # held across both) keeps the log complete — a faulted append
        # delays durability, it never silently drops a committed record.
        self._wal_pending: list = []
        self.wal_append_failures = 0
        if os.path.exists(path):
            self._replay()
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        if follow:
            return
        if compact_on_load:
            self.compact()
        else:
            self._file = open(self.path, "a", encoding="utf-8")

    # -- persistence plumbing ------------------------------------------------

    def _append(self, record: dict) -> None:
        # Followers never write the shared log (promote_to_writer flips
        # the flag); replay/poll application must not re-append.
        if self._replaying or self._follow:
            return
        with self._log_lock:
            hook = self.wal_fault_hook
            try:
                if hook is not None:
                    hook("append", record)
                if self._file is None:
                    self._file = open(self.path, "a", encoding="utf-8")
                while self._wal_pending:
                    self._file.write(json.dumps(self._wal_pending[0]) + "\n")
                    del self._wal_pending[0]
                self._file.write(json.dumps(record) + "\n")
                self._file.flush()
            except Exception:
                self.wal_append_failures += 1
                self._wal_pending.append(record)
                raise
            # Past this point the record is written and flushed: an fsync
            # fault below must NOT park it — it is already on disk.
            if hook is not None:
                hook("fsync", record)
            if self._fsync:
                os.fsync(self._file.fileno())

    def wal_flush(self) -> int:
        """Drain any parked (append-faulted) records to the log; returns
        how many were flushed. Called by close() and by chaos soaks before
        comparing the log against live state."""
        with self._log_lock:
            if not self._wal_pending or self._follow:
                return 0
            if self._file is None:
                self._file = open(self.path, "a", encoding="utf-8")
            n = 0
            while self._wal_pending:
                self._file.write(json.dumps(self._wal_pending[0]) + "\n")
                del self._wal_pending[0]
                n += 1
            self._file.flush()
            if self._fsync:
                os.fsync(self._file.fileno())
            return n

    def _replay(self) -> None:
        """Replay the log, tracking the byte offset of the last COMPLETE
        record. A torn trailing line (crash mid-append) is TRUNCATED away
        with a warning — leaving the partial bytes in place would corrupt
        the next appended record too (it would land on the same line).
        A torn record mid-log (good records after it) can only be skipped;
        that is data damage worth a loud warning, not a raise."""
        import warnings

        self._replaying = True
        good_end = 0
        bad = 0
        tail_torn = False
        try:
            with open(self.path, "rb") as f:
                pos = 0
                for raw in f:
                    pos += len(raw)
                    line = raw.strip()
                    if not line:
                        if not tail_torn:
                            good_end = pos
                        continue
                    try:
                        record = json.loads(line)
                    except ValueError:
                        bad += 1
                        tail_torn = True
                        continue
                    tail_torn = False
                    self._apply_record(record)
                    good_end = pos
        finally:
            self._replaying = False
        if bad:
            if tail_torn and not self._follow:
                warnings.warn(
                    f"durable log {self.path}: torn trailing record (crash "
                    f"mid-append) — truncated to the last complete record "
                    f"({good_end} bytes)",
                    RuntimeWarning,
                    stacklevel=2,
                )
                with open(self.path, "r+b") as f:
                    f.truncate(good_end)
            elif tail_torn and bad == 1:
                # Follower booting while the live writer is mid-append: a
                # healthy log, not damage — poll_log consumes the line
                # once the writer completes it. Stay silent.
                pass
            else:
                warnings.warn(
                    f"durable log {self.path}: {bad} undecodable record(s) "
                    "skipped on replay",
                    RuntimeWarning,
                    stacklevel=2,
                )
        self._log_offset = good_end

    # -- follower mode (HA warm standby over a shared WAL) -------------------

    def poll_log(self) -> int:
        """Apply records the writer appended since the last replay/poll,
        WITH events (subscribed caches, feature stores, and standby
        tailers observe them like any live mutation). Only complete lines
        are consumed — a partially flushed tail stays for the next poll.
        Returns the number of records applied."""
        if not self._follow:
            return 0
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return 0
        if size < self._log_offset:
            # The writer compacted (rewrote) the log under us — which no
            # HA writer ever does (promote_to_writer never compacts);
            # this means a NON-HA writer was pointed at a tailed log.
            # Re-applying from the top converges for upserts, but a
            # deletion that happened past our offset AND was compacted
            # away is invisible: this follower keeps the deleted object
            # (stale usage) until its next promotion reconcile. Warn
            # loudly — this is an operational misconfiguration.
            import warnings

            warnings.warn(
                f"durable log {self.path} was compacted under a live "
                "follower (mixed HA/non-HA writers?): re-syncing from the "
                "top; deletions compacted past this follower's offset are "
                "lost until the next promotion reconcile",
                RuntimeWarning,
                stacklevel=2,
            )
            self._log_offset = 0
        if size == self._log_offset:
            return 0
        with open(self.path, "rb") as f:
            f.seek(self._log_offset)
            buf = f.read()
        applied = 0
        pos = 0
        while True:
            nl = buf.find(b"\n", pos)
            if nl < 0:
                break  # incomplete tail: the writer is mid-append
            line = buf[pos:nl].strip()
            pos = nl + 1
            if not line:
                continue
            try:
                record = json.loads(line)
            except ValueError:
                continue  # torn mid-log line; the writer's restart repairs
            self._apply_record_live(record)
            applied += 1
        self._log_offset += pos
        return applied

    def _apply_record_live(self, record: dict) -> None:
        """Apply one tailed record through the PUBLIC mutators (events
        fire, pod indexes and nodes_version maintained) with WAL re-append
        suppressed. Verbs are applied as idempotent upserts: the follower
        may observe a create for an object it already holds (log
        compaction) or a delete for one it never saw."""
        from spark_scheduler_tpu_torch.store.backend import (
            AlreadyExistsError,
            NotFoundError,
        )

        self._replaying = True
        try:
            verb = record.get("verb")
            if verb == "register_crd":
                self.register_crd(record["name"], record.get("definition"))
                return
            if verb == "unregister_crd":
                self.unregister_crd(record["name"])
                return
            kind = record.get("kind")
            if kind not in _CODECS:
                return
            ns, name = record.get("ns", ""), record.get("name", "")
            if verb == "delete":
                try:
                    self.delete(kind, ns, name)
                except NotFoundError:
                    pass
                return
            if verb not in ("create", "update"):
                return
            obj = _CODECS[kind][1](record["object"])
            cur = self.get(kind, ns, name)
            try:
                if cur is None:
                    if hasattr(obj, "resource_version"):
                        obj.resource_version = 0
                    self.create(kind, obj)
                else:
                    if hasattr(obj, "resource_version") and hasattr(
                        cur, "resource_version"
                    ):
                        obj.resource_version = cur.resource_version
                    self.update(kind, obj)
            except (AlreadyExistsError, NotFoundError):
                pass  # single poller; a race here means test-injected state
        finally:
            self._replaying = False

    def promote_to_writer(self) -> None:
        """A promoted follower becomes the WAL's writer: consume any
        complete records still unpolled, truncate the dead leader's torn
        mid-append tail (appending onto partial bytes would weld our first
        record to them into one undecodable line — losing BOTH on the next
        replay), then stop tailing and open the append handle.

        NOTE: a promoted writer never compacts the log — followers tail by
        byte offset, and a rewrite under them would tear their position
        mid-record. Compacting an HA log is a maintenance operation for
        the whole replica group (generation files are future work)."""
        if not self._follow:
            return
        import warnings

        self.poll_log()  # final catch-up: only a newline-less tail remains
        self._follow = False
        with self._log_lock:
            try:
                size = os.path.getsize(self.path)
            except OSError:
                size = self._log_offset
            if size > self._log_offset:
                # The residual bytes are either a COMPLETE record whose
                # trailing newline never hit the disk — a committed write
                # that cold-restart replay (`for raw in f`) would keep, so
                # losing it here would make failover stricter than restart
                # — or genuinely torn bytes.
                with open(self.path, "rb") as f:
                    f.seek(self._log_offset)
                    tail = f.read()
                try:
                    record = json.loads(tail)
                except ValueError:
                    record = None
                if record is not None:
                    self._apply_record_live(record)
                    with open(self.path, "ab") as f:
                        f.write(b"\n")  # terminate it for the next replay
                    self._log_offset = size + 1
                else:
                    warnings.warn(
                        f"durable log {self.path}: dead writer's torn "
                        f"mid-append tail ({size - self._log_offset} bytes) "
                        f"truncated at promotion",
                        RuntimeWarning,
                        stacklevel=2,
                    )
                    with open(self.path, "r+b") as f:
                        f.truncate(self._log_offset)
            if self._file is None:
                self._file = open(self.path, "a", encoding="utf-8")

    def _apply_record(self, record: dict) -> None:
        verb = record.get("verb")
        if verb == "register_crd":
            self._crds.add(record["name"])
            if record.get("definition"):
                self._crd_definitions[record["name"]] = record["definition"]
            return
        if verb == "unregister_crd":
            self._crds.discard(record["name"])
            self._crd_definitions.pop(record["name"], None)
            return
        # fall through to object records
        kind = record.get("kind")
        if kind not in _CODECS:
            return
        decode = _CODECS[kind][1]
        key = (record.get("ns", ""), record.get("name", ""))
        if verb == "delete":
            self._objects[kind].pop(key, None)
        elif verb in ("create", "update"):
            obj = decode(record["object"])
            if hasattr(obj, "resource_version"):
                # Fresh rv domain per process life; replayed order preserves
                # monotonicity.
                obj.resource_version = self._next_rv()
            self._objects[kind][key] = obj
        # No handler fires during replay: components subscribe only after
        # the backend is constructed (build_scheduler_app ordering).

    def compact(self) -> None:
        """Rewrite the log to one create per live object + the CRD registry
        (atomic via rename)."""
        tmp = self.path + ".tmp"
        # Same lock order as the mutation path (backend lock, then log lock).
        with self._lock, self._log_lock:
            with open(tmp, "w", encoding="utf-8") as f:
                for name in sorted(self._crds):
                    f.write(
                        json.dumps(
                            {
                                "verb": "register_crd",
                                "name": name,
                                **(
                                    {"definition": self._crd_definitions[name]}
                                    if name in self._crd_definitions
                                    else {}
                                ),
                            }
                        )
                        + "\n"
                    )
                for kind, (encode, _) in _CODECS.items():
                    for (ns, name), obj in sorted(self._objects[kind].items()):
                        f.write(
                            json.dumps(
                                {
                                    "verb": "create",
                                    "kind": kind,
                                    "ns": ns,
                                    "name": name,
                                    "object": encode(obj),
                                }
                            )
                            + "\n"
                        )
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
            # The snapshot subsumes any append-faulted parked records —
            # draining them after it would replay stale mutations.
            self._wal_pending.clear()
            if self._file is not None:
                self._file.close()
            self._file = open(self.path, "a", encoding="utf-8")

    def close(self) -> None:
        self.wal_flush()
        with self._log_lock:
            if self._file is not None:
                self._file.close()
                self._file = None

    # -- logged mutations ----------------------------------------------------
    # WAL records are appended from _on_committed / _on_crd_committed, which
    # the base backend invokes INSIDE its mutation lock: log order therefore
    # equals commit order even with concurrent writers (request threads +
    # async write-back workers). Lock order is backend._lock -> _log_lock
    # everywhere, including compact().

    def _on_committed(self, kind: str, verb: str, obj: Any) -> None:
        if kind not in _CODECS:
            return
        if verb == "delete":
            ns, name = obj
            self._append({"verb": "delete", "kind": kind, "ns": ns, "name": name})
            return
        encode = _CODECS[kind][0]
        self._append(
            {
                "verb": verb,
                "kind": kind,
                "ns": getattr(obj, "namespace", ""),
                "name": obj.name,
                "object": encode(obj),
            }
        )

    def _on_crd_committed(self, verb: str, name: str, definition) -> None:
        self._append(
            {
                "verb": verb,
                "name": name,
                **({"definition": definition} if definition is not None else {}),
            }
        )
