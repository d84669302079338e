"""Soak engines of the port: `SoakClock` and `PolicySoak`.

The port's copy of the parts of spark_scheduler_tpu/testing/soak.py that
the policy slice needs: the manual-offset clock and the priority /
preemption soak, run through the port's harness (`device=` as
`Harness` takes it: the card by default, "cpu" in tests). The randomized
invariant soak (`Soak`, with its elastic mode) and the chaos, HA and fleet
soaks drive faults/injector.py, which the port does not have yet (ROADMAP
A.8).
"""

from __future__ import annotations

import time

from spark_scheduler_tpu_torch.testing.harness import (
    Harness,
    new_node,
    overcommit_violations,
    static_allocation_spark_pods,
)


class SoakClock:
    """Monotonic wall clock with a manual offset. Real elapsed time flows
    through (so demand-to-fulfilled latencies the bench reports are real),
    while elastic ops advance the offset to cross the drainer's idle TTL
    deterministically without sleeping."""

    def __init__(self):
        self._offset = 0.0

    def __call__(self) -> float:
        return time.monotonic() + self._offset

    def advance(self, dt: float) -> None:
        self._offset += dt


class PolicySoak:
    """Priority/preemption soak: sustained
    high-priority pressure against a fixed set of low-priority gangs plus
    one protected "system" gang, through the REAL policy-enabled extender
    (priority ordering + vectorized preemption search + age promotion).

    Deterministic manual clock: pods are stamped with the soak clock so
    age promotion is driven by `advance()`, not wall time. Each step:

      submit 1 fresh high-priority gang (evicts low gangs while they are
      young; denied once they age into the promotion cap), retire the
      oldest high gang past a small working-set bound (so capacity keeps
      turning over), retry every pending/evicted low gang, advance the
      clock one `step_s`.

    Invariants collected for the test layer (`verdict()`):
      * no starvation — every low gang holds a reservation at the end,
        and every admission happened within `starvation_bound_s` of its
        original submission (the age-promotion bound: once promoted to
        the cap a low gang is neither blocked behind fresh high gangs
        nor evictable by them);
      * the system gang's hard reservation survives every step;
      * zero over-commit at every step.
    """

    def __init__(
        self,
        n_low: int = 3,
        n_nodes: int = 3,
        promote_after_s: float = 120.0,
        step_s: float = 30.0,
        device="cuda",
    ):
        class _Clock:
            def __init__(self):
                self.t = 1_000.0

            def __call__(self):
                return self.t

            def advance(self, dt):
                self.t += dt

        self.clock = _Clock()
        self.promote_after_s = promote_after_s
        self.step_s = step_s
        self.h = Harness(
            binpack_algo="tightly-pack",
            fifo=True,
            clock=self.clock,
            policy_enabled=True,
            policy_ordering="priority",
            policy_preemption=True,
            policy_promote_after_s=promote_after_s,
            # The manual clock jumps step_s per step — without this every
            # request would cross the leader-gap heuristic and run a full
            # failover reconcile mid-soak (resurrecting evicted gangs
            # from their leftover pending pods).
            resync_gap_seconds=1e12,
            device=device,
        )
        for i in range(n_nodes):
            self.h.add_nodes(new_node(f"pn{i}", zone=f"zone{i % 3}"))
        self.names = [f"pn{i}" for i in range(n_nodes)]
        self.seq = 0
        self.highs: list[tuple[str, list]] = []  # (app_id, pods) admitted
        self.evictions = 0
        self.denied_high = 0
        self.system_rr_lost = False
        self.overcommit: list = []
        # app_id -> {"pods", "submitted", "admitted"(clock time or None)}
        self.lows: dict[str, dict] = {}

        from spark_scheduler_tpu_torch.models.reservations import (
            PRIORITY_CLASS_ANNOTATION,
        )

        self._ann = PRIORITY_CLASS_ANNOTATION

        # One protected gang: its reservation must survive the whole soak.
        sys_pods = self._gang("system-app", 2, "system")
        assert self._admit_gang(sys_pods), "system gang must admit first"

        for i in range(n_low):
            app_id = f"low-{i}"
            pods = self._gang(app_id, 2, "low")
            self.lows[app_id] = {
                "pods": pods,
                "submitted": self.clock(),
                "admitted": None,
            }

    def _gang(self, app_id: str, execs: int, pclass: str):
        pods = static_allocation_spark_pods(app_id, execs)
        pods[0].annotations[self._ann] = pclass
        for p in pods:  # stamp with the SOAK clock, not the global counter
            p.creation_timestamp = self.clock()
        return pods

    def _admit_gang(self, pods) -> bool:
        r = self.h.schedule(pods[0], self.names)
        if not r.ok:
            return False
        for p in pods[1:]:
            self.h.schedule(p, self.names)
        return True

    def _teardown(self, app_id: str, pods) -> None:
        for p in pods:
            cur = self.h.backend.get("pods", p.namespace, p.name)
            if cur is not None:
                self.h.backend.delete_pod(cur)
        rr = self.h.get_reservation("namespace", app_id)
        if rr is not None:
            self.h.app.rr_cache.delete(rr.namespace, rr.name)

    def step(self) -> None:
        # Sustained pressure: one fresh high gang per step.
        app_id = f"high-{self.seq}"
        self.seq += 1
        pods = self._gang(app_id, 2, "high")
        if self._admit_gang(pods):
            self.highs.append((app_id, pods))
        else:
            self.denied_high += 1
        if len(self.highs) > 4:
            old_id, old_pods = self.highs.pop(0)
            self._teardown(old_id, old_pods)

        # Low gangs retry every step (the kube retry loop). Resubmission
        # uses FRESH pod objects carrying the ORIGINAL creation stamp:
        # binding mutates the stored pod's node_name in place, so reusing
        # the old objects would re-add pods that look already-bound (a
        # phantom the availability mirror would count as usage) — while a
        # fresh stamp would reset the gang's promotion clock.
        import dataclasses as _dc

        for low_id, entry in self.lows.items():
            rr = self.h.get_reservation("namespace", low_id)
            if rr is not None:
                continue
            if entry["admitted"] is not None:
                self.evictions += 1
                entry["admitted"] = None
            entry["pods"] = [
                _dc.replace(p, node_name=None, phase="Pending")
                for p in entry["pods"]
            ]
            if self._admit_gang(entry["pods"]):
                entry["admitted"] = self.clock()

        if self.h.get_reservation("namespace", "system-app") is None:
            self.system_rr_lost = True
        self.overcommit.extend(overcommit_violations(self.h.app, self.h.backend))
        self.clock.advance(self.step_s)

    def run(self, steps: int) -> dict:
        for _ in range(steps):
            self.step()
        return self.verdict()

    def verdict(self) -> dict:
        waits = {}
        for low_id, entry in self.lows.items():
            waits[low_id] = (
                entry["admitted"] - entry["submitted"]
                if entry["admitted"] is not None
                else None
            )
        return {
            "steps": self.seq,
            "low_waits_s": waits,
            "evictions": self.evictions,
            "denied_high": self.denied_high,
            "system_rr_lost": self.system_rr_lost,
            "overcommit": self.overcommit,
            "preemptions": [
                rec["preemption"]
                for rec in self.h.app.recorder.query(limit=10_000)
                if rec.get("preemption")
            ],
        }
