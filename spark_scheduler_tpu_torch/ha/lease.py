"""Fenced leader lease.

One lease record arbitrates which replica is the leader. The record
carries a monotonically increasing **epoch** that bumps on every takeover
(never on renewal); reservation/demand writes are gated on the writer's
acquired epoch still being the live one (see fencing.FencedBackend), so a
deposed leader's in-flight commit is rejected instead of double-placing —
the classic fencing-token discipline the reference never needed because
its leader was a Kubernetes lease + a whole process.

Two stores back the record:

  BackendLeaseStore  the lease lives as a backend object of kind
                     "leases"; compare-and-swap rides the backend's
                     optimistic concurrency (resourceVersion conflicts).
                     The in-process replica group and the kube-backend
                     deployment (apiserver CAS) use this.
  FileLeaseStore     a JSON sidecar next to the WAL, every mutation under
                     an exclusive flock on `<path>.lock` with a
                     read-check-write inside the critical section — the
                     multi-process DurableBackend deployment's arbiter
                     (the WAL itself has no cross-process CAS).

Expiry is wall-clock based (`renewed_at + ttl`), evaluated by readers: a
leader that misses heartbeats for a TTL is take-over-able; its next
fenced write then sees the bumped epoch and fails.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Optional

from spark_scheduler_tpu_torch.store.backend import AlreadyExistsError, ConflictError

LEASE_NAME = "scheduler-leader"


class FencingError(RuntimeError):
    """A write carried a stale fencing epoch (the writer was deposed)."""


@dataclasses.dataclass
class LeaseRecord:
    """The lease object. `epoch` bumps on takeover only; `renewed_at` is
    seconds on the shared clock; `holder` is the replica id ('' after a
    clean release — epoch survives so fencing stays monotonic)."""

    holder: str
    epoch: int
    renewed_at: float
    ttl_s: float
    name: str = LEASE_NAME
    namespace: str = ""
    resource_version: int = 0

    def expired(self, now: float) -> bool:
        return not self.holder or now > self.renewed_at + self.ttl_s

    def to_wire(self) -> dict:
        return {
            "holder": self.holder,
            "epoch": self.epoch,
            "renewed_at": self.renewed_at,
            "ttl_s": self.ttl_s,
            "name": self.name,
        }

    @classmethod
    def from_wire(cls, raw: dict) -> "LeaseRecord":
        return cls(
            holder=raw.get("holder", ""),
            epoch=int(raw.get("epoch", 0)),
            renewed_at=float(raw.get("renewed_at", 0.0)),
            ttl_s=float(raw.get("ttl_s", 0.0)),
            name=raw.get("name", LEASE_NAME),
        )


class BackendLeaseStore:
    """Lease record as a backend object; CAS via resourceVersion."""

    def __init__(self, backend):
        self._backend = backend

    def read(self) -> Optional[LeaseRecord]:
        return self._backend.get("leases", "", LEASE_NAME)

    def compare_and_swap(self, expect: Optional[LeaseRecord], record: LeaseRecord) -> bool:
        """Write `record` iff the stored lease is still `expect` (None =
        must not exist). Returns False when another replica won the race."""
        try:
            if expect is None:
                record.resource_version = 0
                self._backend.create("leases", record)
            else:
                record.resource_version = expect.resource_version
                self._backend.update("leases", record)
            return True
        except (ConflictError, AlreadyExistsError):
            return False


class FileLeaseStore:
    """Lease record in a JSON sidecar file; mutations under an exclusive
    flock on `<path>.lock`, with the read re-done INSIDE the lock so the
    compare half of the CAS cannot race another process."""

    def __init__(self, path: str):
        self.path = path
        self._lock_path = path + ".lock"
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def _read_unlocked(self) -> Optional[LeaseRecord]:
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                return LeaseRecord.from_wire(json.load(f))
        except (OSError, ValueError):
            return None

    def read(self) -> Optional[LeaseRecord]:
        return self._read_unlocked()

    def _flock(self):
        import fcntl

        fd = os.open(self._lock_path, os.O_CREAT | os.O_RDWR)
        fcntl.flock(fd, fcntl.LOCK_EX)
        return fd

    def compare_and_swap(self, expect: Optional[LeaseRecord], record: LeaseRecord) -> bool:
        import fcntl

        fd = self._flock()
        try:
            cur = self._read_unlocked()
            if (cur is None) != (expect is None):
                return False
            if cur is not None and (
                cur.epoch != expect.epoch
                or cur.holder != expect.holder
                # Renewals move ONLY renewed_at: without comparing it, a
                # standby's takeover CAS (read just as the TTL lapsed)
                # would overwrite a renewal that landed in between —
                # deposing a healthy leader mid-term. json round-trips
                # floats exactly (repr), so equality is sound.
                or cur.renewed_at != expect.renewed_at
            ):
                return False
            tmp = self.path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(record.to_wire(), f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
            return True
        finally:
            fcntl.flock(fd, fcntl.LOCK_UN)
            os.close(fd)


class LeaseManager:
    """One replica's view of the lease: acquisition, renewal, and the
    fencing checks the write path and the extender's resync heuristic key
    on. Thread-safe — the heartbeat thread renews while request threads
    check the fence."""

    def __init__(
        self,
        store,
        holder: str,
        ttl_s: float = 3.0,
        clock=time.time,
        retry_policy=None,
        breaker=None,
    ):
        self._store = store
        self.holder = holder
        self.ttl_s = ttl_s
        self._clock = clock
        # Lease-store IO rides the shared retry ladder: a
        # transient store blip must not read as "deposed" — the renew
        # retries inside the heartbeat's budget. Defaults keep total
        # retry time well under the TTL (a renew that outlives the TTL
        # is worse than one that fails: the next tick re-elects). The
        # breaker stops a dead store being hammered at heartbeat rate.
        from spark_scheduler_tpu_torch.faults.retry import RetryPolicy

        self._retry_policy = retry_policy or RetryPolicy(
            max_attempts=3,
            base_delay_s=min(0.05, ttl_s / 30.0),
            multiplier=2.0,
            max_delay_s=max(0.05, ttl_s / 6.0),
        )
        self._breaker = breaker
        self._lock = threading.Lock()
        # The epoch THIS replica acquired (0 = never held). Fenced writes
        # compare it against the live record's epoch.
        self.acquired_epoch = 0
        self.fenced_rejects = 0
        # Clock time of the last successful acquire/renew: while it is
        # fresher than the TTL no other replica CAN have taken over (a
        # takeover requires the record we renewed to expire first), so
        # is_held() answers from memory — keeping the per-request resync
        # heuristic off the lease store (for FileLeaseStore that read is
        # open+parse of the sidecar on the predicate hot path).
        self._last_affirmed = float("-inf")

    # -- store IO (retry ladder) -------------------------------------------

    def _read(self):
        return self._retry_policy.call(
            self._store.read, breaker=self._breaker
        )

    def _cas(self, expect, record) -> bool:
        # Only the STORE-level failure retries; a lost CAS returns False
        # immediately (someone else won — retrying would be a livelock).
        return self._retry_policy.call(
            lambda: self._store.compare_and_swap(expect, record),
            breaker=self._breaker,
        )

    # -- election ----------------------------------------------------------

    def try_acquire(self) -> bool:
        """Acquire or re-affirm leadership. Takeover of an absent/expired
        lease bumps the epoch (the fencing token); holding it already just
        renews. False when another holder's lease is live or the CAS lost."""
        now = self._clock()
        cur = self._read()
        if cur is None:
            ok = self._cas(None,
                LeaseRecord(self.holder, 1, now, self.ttl_s),
            )
            if ok:
                with self._lock:
                    self.acquired_epoch = 1
                    self._last_affirmed = now
            return ok
        if cur.holder == self.holder and cur.epoch == self.acquired_epoch:
            return self.renew()
        if not cur.expired(now):
            return False
        ok = self._cas(cur,
            LeaseRecord(self.holder, cur.epoch + 1, now, self.ttl_s),
        )
        if ok:
            with self._lock:
                self.acquired_epoch = cur.epoch + 1
                self._last_affirmed = now
        return ok

    def renew(self) -> bool:
        """Heartbeat: extend the lease without changing the epoch. False =
        deposed (the record moved under us) — the caller must stop serving."""
        with self._lock:
            epoch = self.acquired_epoch
        if not epoch:
            return False
        cur = self._read()
        if cur is None or cur.holder != self.holder or cur.epoch != epoch:
            return False
        now = self._clock()
        ok = self._cas(cur,
            LeaseRecord(self.holder, epoch, now, self.ttl_s),
        )
        if ok:
            with self._lock:
                self._last_affirmed = now
        return ok

    def release(self) -> None:
        """Clean shutdown: expire the lease NOW (holder cleared, epoch kept
        so the next takeover still bumps past every fenced write we made)."""
        with self._lock:
            epoch = self.acquired_epoch
            self.acquired_epoch = 0
            self._last_affirmed = float("-inf")
        if not epoch:
            return
        cur = self._read()
        if cur is not None and cur.holder == self.holder and cur.epoch == epoch:
            self._cas(cur, LeaseRecord("", epoch, 0.0, self.ttl_s)
            )

    # -- fencing -----------------------------------------------------------

    def is_held(self) -> bool:
        """Local view: we acquired the lease and our epoch is still the
        live one and unexpired. The extender's >gap resync heuristic keys
        on this (a held lease means no silent leader change can have
        happened during a request gap). Answered from memory while the
        last successful acquire/renew is fresher than the TTL — within
        that window the record we wrote cannot have expired, so no
        takeover can have happened; the store is consulted only when the
        heartbeat has gone stale."""
        with self._lock:
            epoch = self.acquired_epoch
            last = self._last_affirmed
        if not epoch:
            return False
        if self._clock() - last < self.ttl_s:
            return True
        cur = self._read()
        return (
            cur is not None
            and cur.holder == self.holder
            and cur.epoch == epoch
            and not cur.expired(self._clock())
        )

    def check_fence(self) -> None:
        """Raise FencingError unless this replica's acquired epoch is the
        live lease epoch. Called by FencedBackend INSIDE the mutation path
        of reservation/demand writes — the read is one dict get (backend
        store) or one small file read (WAL sidecar)."""
        with self._lock:
            epoch = self.acquired_epoch
        cur = self._read()
        if (
            not epoch
            or cur is None
            or cur.holder != self.holder
            or cur.epoch != epoch
        ):
            with self._lock:
                self.fenced_rejects += 1
            live = "none" if cur is None else f"{cur.holder}@{cur.epoch}"
            raise FencingError(
                f"fenced write rejected: {self.holder}@{epoch} is not the "
                f"live lease ({live})"
            )

    # -- introspection -----------------------------------------------------

    def state(self) -> dict:
        cur = self._read()
        now = self._clock()
        return {
            "holder": self.holder,
            "acquired_epoch": self.acquired_epoch,
            "lease_holder": cur.holder if cur is not None else None,
            "lease_epoch": cur.epoch if cur is not None else 0,
            "lease_age_s": (
                round(now - cur.renewed_at, 3) if cur is not None else None
            ),
            "lease_ttl_s": self.ttl_s,
            "lease_expired": cur.expired(now) if cur is not None else True,
            "fenced_rejects": self.fenced_rejects,
        }
