"""FaultPlan / FaultInjector — deterministic fault schedules over named
surfaces.

Before this module the repo had exactly one injection point (the
backend's `fault_injector` lambda, store/backend.py) and one latency shim
(testing/rtt_shim.py), each hand-wired per test. The injector unifies
them: a PLAN is a seed plus a list of SPECS, each spec a (surface
pattern, trigger, action) triple; the injector instantiates one seeded
RNG stream PER SPEC, so the schedule of fired faults is a pure function
of (plan, sequence of fire() calls) — the same seed against the same
workload fires the same faults in the same places, which is what makes
chaos soaks replayable (same seed => same schedule => same verdicts).

Named surfaces (dot-paths; specs match with fnmatch patterns):

  backend.<kind>.<verb>   every ClusterBackend mutation (create/update/
                          delete per kind) — via backend_hook(), the same
                          seam the ad-hoc lambda used
  kube.write.<verb>       the async write-back client draining a request
  device.h2d|dispatch|d2h the solver's device boundaries — via
                          device_shim(), composing with SimulatedRTT
  lease.read|write        the HA lease store — via FaultyLeaseStore
  wal.<op>.<kind>         the durable backend's log (op: append|fsync;
                          kind: the record's, `crd` for the registry) —
                          via wal_hook()

Actions: "error" (raise; DeviceFaultError on device.* so the solver's
slot classifier quarantines), "latency" (sleep latency_ms), "partition"
(a contiguous window of matching events all error — a dead apiserver /
lost device, not a blip).
"""

from __future__ import annotations

import dataclasses
import fnmatch
import random
import threading
import time
from typing import Callable, Optional, Sequence

from spark_scheduler_tpu_torch.faults.errors import DeviceFaultError, InjectedFault


@dataclasses.dataclass
class FaultSpec:
    """One (surface, trigger, action). Triggers compose as: `limit` caps
    total fires; then `partition` (start/length window over this spec's
    MATCHING-event index), `at` (explicit indices), `every` (every Nth),
    or `p` (per-event coin from the spec's seeded stream) — first
    configured wins, checked in that order."""

    surface: str  # fnmatch pattern, e.g. "backend.resourcereservations.*"
    mode: str = "error"  # error | latency | partition
    p: Optional[float] = None
    at: Optional[Sequence[int]] = None
    every: Optional[int] = None
    start: int = 0  # partition window start (matching-event index)
    length: int = 0  # partition window length (0 = open-ended)
    limit: Optional[int] = None
    latency_ms: float = 0.0
    error: Optional[Callable[[], Exception]] = None
    name: str = ""

    def label(self, idx: int) -> str:
        return self.name or f"{self.surface}#{idx}"


@dataclasses.dataclass
class FaultPlan:
    """A seed + specs. Loadable from plain dicts (the chaos-matrix CI leg
    and bench arms define plans as literals)."""

    seed: int
    specs: list[FaultSpec] = dataclasses.field(default_factory=list)
    name: str = ""

    @classmethod
    def from_dict(cls, raw: dict) -> "FaultPlan":
        return cls(
            seed=int(raw.get("seed", 0)),
            name=str(raw.get("name", "")),
            specs=[
                FaultSpec(**{k.replace("-", "_"): v for k, v in s.items()})
                for s in raw.get("specs", [])
            ],
        )


class FaultInjector:
    """Instantiated from a plan; `fire(surface)` is the single hot-path
    entry every adapter funnels into. Thread-safe (device shims fire from
    pool workers while backend hooks fire from request threads)."""

    def __init__(
        self,
        plan: FaultPlan,
        sleep: Callable[[float], None] = time.sleep,
        on_fire: Optional[Callable[[str, str], None]] = None,
    ):
        self.plan = plan
        self._sleep = sleep
        # Telemetry seam: fn(surface, action) per fired fault (see
        # RetryTelemetry.fault_hook — foundry.spark.scheduler.faults.
        # injected). Called outside the injector lock.
        self.on_fire = on_fire
        self._lock = threading.Lock()
        self._rngs = [
            random.Random(f"{plan.seed}:{i}") for i in range(len(plan.specs))
        ]
        self._match_counts = [0] * len(plan.specs)
        self._fired_counts = [0] * len(plan.specs)
        self._seq = 0
        self.counts: dict[str, int] = {}  # events seen per surface
        self.fired: dict[str, int] = {}  # faults fired per surface
        # (seq, surface, spec label, action) — the deterministic schedule
        # replay tests compare.
        self.log: list[tuple[int, str, str, str]] = []
        # Installed-seam bookkeeping for uninstall().
        self._installed_backends: list = []
        self._installed_clients: list = []
        self._installed_wals: list = []
        self._device_prior = None
        self._device_installed = False

    # -- core ---------------------------------------------------------------

    def _decide(self, i: int, spec: FaultSpec) -> bool:
        idx = self._match_counts[i]
        self._match_counts[i] += 1
        if spec.limit is not None and self._fired_counts[i] >= spec.limit:
            return False
        if spec.mode == "partition":
            if idx < spec.start:
                return False
            return spec.length <= 0 or idx < spec.start + spec.length
        if spec.at is not None:
            return idx in spec.at
        if spec.every is not None:
            return spec.every > 0 and idx % spec.every == 0
        if spec.p is not None:
            return self._rngs[i].random() < spec.p
        return True  # unconditional (one-shot specs pair this with limit=1)

    def fire(self, surface: str) -> None:
        """Count one event on `surface`; sleep and/or raise per the plan.
        Latency faults sleep OUTSIDE the lock (a slow apiserver must not
        serialize unrelated surfaces through the injector)."""
        sleep_ms = 0.0
        raise_exc: Exception | None = None
        fired: list[str] = []
        with self._lock:
            self.counts[surface] = self.counts.get(surface, 0) + 1
            for i, spec in enumerate(self.plan.specs):
                if not fnmatch.fnmatch(surface, spec.surface):
                    continue
                if not self._decide(i, spec):
                    continue
                self._fired_counts[i] += 1
                self.fired[surface] = self.fired.get(surface, 0) + 1
                self._seq += 1
                action = "latency" if spec.mode == "latency" else "error"
                self.log.append((self._seq, surface, spec.label(i), action))
                fired.append(action)
                if spec.mode == "latency":
                    sleep_ms += spec.latency_ms
                    continue
                if spec.error is not None:
                    raise_exc = spec.error()
                elif surface.startswith("device."):
                    raise_exc = DeviceFaultError(surface)
                else:
                    raise_exc = InjectedFault(surface)
                break  # first erroring spec wins
        if self.on_fire is not None:
            for action in fired:
                self.on_fire(surface, action)
        if sleep_ms > 0:
            self._sleep(sleep_ms / 1e3)
        if raise_exc is not None:
            raise raise_exc

    def schedule(self) -> tuple:
        """The fired-fault schedule as a hashable value (replay tests pin
        same seed => same schedule)."""
        with self._lock:
            return tuple(self.log)

    def stats(self) -> dict:
        with self._lock:
            return {
                "plan": self.plan.name,
                "seed": self.plan.seed,
                "events": dict(self.counts),
                "fired": dict(self.fired),
            }

    # -- adapters -----------------------------------------------------------

    def backend_hook(self):
        """A `backend.fault_injector`-compatible fn(kind, verb, obj):
        latency faults sleep inline and return None; error faults RETURN
        the exception (the backend raises it inside its mutation lock) —
        the exact contract of the ad-hoc hook this subsumes."""

        def hook(kind, verb, obj):
            try:
                self.fire(f"backend.{kind}.{verb}")
            except Exception as exc:
                return exc
            return None

        return hook

    def install_backend(self, backend) -> None:
        # Remember the hook we displaced so nested injectors compose:
        # e.g. the soak's one-shot write-fault op installs its own
        # injector INSIDE a chaos-matrix run and must hand the seam back.
        self._installed_backends.append(
            (backend, getattr(backend, "fault_injector", None))
        )
        backend.fault_injector = self.backend_hook()

    def async_client_hook(self):
        """fn(request) for AsyncClient.fault_hook: fires on every drained
        write-back request BEFORE it reaches the backend (the kube client
        failing, not the apiserver) — raising routes into the client's
        RetryPolicy ladder."""

        def hook(req) -> None:
            self.fire(f"kube.write.{req.type.value}")

        return hook

    def install_async_client(self, client) -> None:
        self._installed_clients.append(
            (client, getattr(client, "fault_hook", None))
        )
        client.fault_hook = self.async_client_hook()

    def device_shim(self, inner=None):
        """A core.solver.set_device_shim-compatible callable: fires
        device.<kind> then delegates to `inner` (e.g. a SimulatedRTT) —
        fault injection and RTT simulation compose at one seam."""

        def shim(kind: str) -> None:
            self.fire(f"device.{kind}")
            if inner is not None:
                inner(kind)

        return shim

    def install_device(self, inner=None) -> None:
        from spark_scheduler_tpu_torch.core import solver as _solver

        if not self._device_installed:
            self._device_prior = _solver._DEVICE_SHIM
            self._device_installed = True
        _solver.set_device_shim(
            self.device_shim(inner if inner is not None else self._device_prior)
        )

    def lease_store(self, store) -> "FaultyLeaseStore":
        return FaultyLeaseStore(store, self)

    def wal_hook(self):
        """fn(op, record=None) for DurableBackend.wal_fault_hook: op is
        "append" or "fsync"; raising makes the commit fail exactly where
        a full disk or torn fsync would. The surface is kind-granular —
        `wal.<op>.<kind>` (`crd` for registry records) — so a plan can
        fault reservation appends without also failing every pod/node
        bookkeeping write (match broadly with `wal.append.*`)."""

        def hook(op: str, record=None) -> None:
            kind = (record or {}).get("kind", "crd")
            self.fire(f"wal.{op}.{kind}")

        return hook

    def install_wal(self, durable_backend) -> None:
        self._installed_wals.append(
            (durable_backend, getattr(durable_backend, "wal_fault_hook", None))
        )
        durable_backend.wal_fault_hook = self.wal_hook()

    def uninstall(self) -> None:
        for b, prior in self._installed_backends:
            b.fault_injector = prior
        self._installed_backends.clear()
        for c, prior in self._installed_clients:
            c.fault_hook = prior
        self._installed_clients.clear()
        for w, prior in self._installed_wals:
            w.wal_fault_hook = prior
        self._installed_wals.clear()
        if self._device_installed:
            from spark_scheduler_tpu_torch.core import solver as _solver

            _solver.set_device_shim(self._device_prior)
            self._device_installed = False
            self._device_prior = None

    def __enter__(self) -> "FaultInjector":
        return self

    def __exit__(self, *exc) -> None:
        self.uninstall()


class FaultyLeaseStore:
    """Lease-store wrapper firing lease.read / lease.write around the
    delegate — the lease surface of the chaos matrix. Duck-typed to the
    BackendLeaseStore/FileLeaseStore surface (read / compare_and_swap)."""

    def __init__(self, delegate, injector: FaultInjector):
        self._delegate = delegate
        self._injector = injector

    def read(self):
        self._injector.fire("lease.read")
        return self._delegate.read()

    def compare_and_swap(self, expect, record) -> bool:
        self._injector.fire("lease.write")
        return self._delegate.compare_and_swap(expect, record)
