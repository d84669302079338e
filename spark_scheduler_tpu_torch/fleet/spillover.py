"""SpilloverCoordinator — the Demand hand-off routed to a sibling cluster
(the port's copy of spark_scheduler_tpu/fleet/spillover.py).

The reference's Demand signal (demand.go:58-126) tells an autoscaler
"this gang did not fit — buy capacity". In a fleet there is a cheaper
fulfiller first: a sibling cluster that already HAS the capacity. A
driver denied FAILURE_FIT at its home cluster (its Demand CRD just
created by the extender, exactly as standalone) is retried on the best
siblings in aggregate-headroom order, bounded by `max_hops`:

  placed on a sibling   the home copy is released (pod + demand deleted —
                        the demand was routed to a sibling instead of an
                        autoscaler), the app's affinity re-binds to the
                        sibling so its executors follow, and the hand-off
                        is journaled in the home cluster's FlightRecorder.
  denied everywhere     every sibling copy is released (its denial AND
                        the release are ordinary ops in that sibling's
                        stream — it stays byte-identical to standalone),
                        the home demand STANDS, and the autoscaler path
                        takes over exactly as a single cluster.

Executors never spill: the gang's home is wherever its driver's
reservation lives — spilling an executor would split the gang across
clusters and void the per-cluster byte-identity contract.
"""

from __future__ import annotations

import copy
import dataclasses

from spark_scheduler_tpu_torch.core.extender import ExtenderFilterResult
from spark_scheduler_tpu_torch.core.sparkpods import SPARK_APP_ID_LABEL


@dataclasses.dataclass
class FleetDecision:
    """A facade decision: the in-cluster result plus its fleet routing."""

    result: ExtenderFilterResult
    cluster: int
    spilled_from: int | None = None
    spillover_attempts: int = 0
    unavailable: bool = False

    @property
    def ok(self) -> bool:
        return self.result.ok


class SpilloverCoordinator:
    def __init__(self, stacks, router, telemetry, max_hops: int = 1):
        self._stacks = stacks
        self._router = router
        self._tel = telemetry
        self.max_hops = max(0, int(max_hops))
        self.spilled = 0
        self.denied = 0

    def try_spillover(
        self, pod, app_id: str, group: str, home: int, home_result
    ) -> FleetDecision:
        attempts = 0
        for sib in self._router.siblings(home, group):
            if attempts >= self.max_hops:
                break
            attempts += 1
            # The sibling serves a COPY: the home backend still owns the
            # original pod object until the hand-off commits.
            pod_copy = copy.deepcopy(pod)
            res = self._stacks[sib].schedule(pod_copy, None)
            self._tel.on_decision(sib)
            if res.ok:
                self._stacks[home].release(pod)
                self._router.bind(app_id, sib)
                self._tel.on_spillover(home, sib)
                self.spilled += 1
                self._journal(pod, group, home, sib, res)
                return FleetDecision(
                    res, sib, spilled_from=home,
                    spillover_attempts=attempts,
                )
            # Keep the sibling standalone-equivalent: the failed copy (and
            # the demand its denial created) leaves through the same ops a
            # standalone operator would issue.
            self._stacks[sib].release(pod_copy)
        if attempts:
            self._tel.on_spillover_denied(home)
            self.denied += 1
        return FleetDecision(
            home_result, home, spillover_attempts=attempts
        )

    def _journal(self, pod, group: str, home: int, sib: int, res) -> None:
        recorder = self._stacks[home].app.recorder
        if recorder is None:
            return
        recorder.record(
            namespace=pod.namespace,
            pod_name=pod.name,
            app_id=pod.labels.get(SPARK_APP_ID_LABEL, pod.name),
            instance_group=group,
            role="driver",
            verdict="spillover",
            node=res.node_names[0] if res.node_names else None,
            message=(
                f"demand spilled: home cluster {home} denied fit, "
                f"placed on sibling cluster {sib}"
            ),
        )
