"""PolicyEngine: the one object the extender consults.

Constructed by `build_scheduler_app` ONLY when `InstallConfig.policy_enabled`
— every extender hook takes the exact pre-policy branch when the engine is
absent, keeping the FIFO path byte-identical.

Composes the four policy parts behind three hooks:

  ordering.blockers(...)       window/solo queue ordering (fifo|priority|drf)
  try_preempt(...)             vectorized preemption search + eviction
  maybe_defrag() / defrag      pool-idle fragmentation passes

Every preemption decision is recorded into the FlightRecorder by the
extender (eviction set, candidate count, slot cost, search wall time) and
counted in the policy metric family.

The port's copy of spark_scheduler_tpu/policy/engine.py.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

from spark_scheduler_tpu_torch.policy.defrag import Defragmenter
from spark_scheduler_tpu_torch.policy.ordering import (
    DrfOrdering,
    FifoOrdering,
    GroupUsageAggregates,
    PriorityOrdering,
)
from spark_scheduler_tpu_torch.policy.preemption import PreemptionResult, PreemptionSearch
from spark_scheduler_tpu_torch.policy.priority import (
    PROTECTED_PRIORITY,
    parse_priority_class,
    pod_priority,
)
from spark_scheduler_tpu_torch.policy.registry import resolve

PREEMPTIONS = "foundry.spark.scheduler.policy.preemptions"
PREEMPTION_EVICTIONS = "foundry.spark.scheduler.policy.preemption.evictions"
PREEMPTION_SEARCH_MS = "foundry.spark.scheduler.policy.preemption.search-ms"
# Searches that raised (a failed launch on the card included): the extender
# keeps the fit denial, as the JAX package does, and counts the failure
# here so that it is not mistaken for an ordinary denial.
PREEMPTION_SEARCH_FAILURES = (
    "foundry.spark.scheduler.policy.preemption.search.failures"
)


@dataclasses.dataclass
class PolicyConfig:
    ordering: str = "fifo"  # fifo | priority | drf
    preemption: bool = False
    max_evictions: int = 8
    promote_after_s: float = 300.0
    defrag: bool = False
    defrag_interval_s: float = 30.0
    defrag_budget: int = 4
    protected_class: str = "system"


class PolicyEngine:
    def __init__(
        self,
        config: PolicyConfig,
        *,
        backend,
        rr_cache,
        pod_lister,
        soft_store,
        reservation_manager,
        solver,
        clock,
        metrics_registry=None,
    ):
        self.config = config
        self._clock = clock
        self._metrics = metrics_registry
        self._lock = threading.Lock()
        self._last_defrag = 0.0
        self.search_failures = 0

        # Ordering plug-board: same registry/error shape as select_binpacker.
        shares: Optional[GroupUsageAggregates] = None
        if config.ordering == "drf":
            shares = GroupUsageAggregates(backend, rr_cache, pod_lister)
        strategies = {
            "fifo": lambda: FifoOrdering(),
            "priority": lambda: PriorityOrdering(config.promote_after_s),
            "drf": lambda: DrfOrdering(shares),
        }
        self.ordering = resolve(
            config.ordering, strategies, "policy ordering strategy"
        )()
        self.shares = shares

        self.preemption: Optional[PreemptionSearch] = None
        if config.preemption:
            self.preemption = PreemptionSearch(
                rr_cache,
                pod_lister,
                soft_store,
                backend,
                clock,
                max_evictions=config.max_evictions,
                protected_priority=parse_priority_class(
                    config.protected_class
                )
                if config.protected_class
                else PROTECTED_PRIORITY,
                promote_after_s=config.promote_after_s,
            )

        self.defrag: Optional[Defragmenter] = None
        if config.defrag:
            self.defrag = Defragmenter(
                backend,
                soft_store,
                reservation_manager,
                clock,
                budget=config.defrag_budget,
                registry=metrics_registry,
                solver=solver,
            )

    # -- preemption ----------------------------------------------------------

    def try_preempt(
        self,
        solver,
        strategy: str,
        tensors,
        pod,
        app_resources,
        driver_candidate_names,
        domain_names,
        domain_mask=None,
    ) -> Optional[PreemptionResult]:
        """Search + execute: one batched masked-fit pass over candidate
        eviction sets; on a feasible minimal set, evict it and return the
        result (the caller bumps the capacity epoch and re-solves). None
        when preemption is off, the gang is not above the floor, or no
        eviction set admits it."""
        if self.preemption is None:
            return None
        requester = pod_priority(pod)
        result, victims = self.preemption.search(
            solver,
            strategy,
            tensors,
            app_resources,
            driver_candidate_names,
            set(domain_names) if domain_names is not None else None,
            requester,
            domain_mask=domain_mask,
        )
        if result is None:
            return None
        self.preemption.execute(victims)
        if self._metrics is not None:
            self._metrics.counter(PREEMPTIONS).inc()
            self._metrics.counter(PREEMPTION_EVICTIONS).inc(
                len(result.evicted)
            )
            self._metrics.histogram(PREEMPTION_SEARCH_MS).update(
                result.search_ms
            )
        return result

    def note_search_failure(self) -> None:
        """One preemption search or eviction raised; the caller keeps the
        fit denial."""
        with self._lock:
            self.search_failures += 1
        if self._metrics is not None:
            self._metrics.counter(PREEMPTION_SEARCH_FAILURES).inc()

    # -- defragmenter --------------------------------------------------------

    def maybe_defrag(self) -> Optional[dict]:
        """Interval-gated defrag pass (called from the serving loop's idle
        moments / the background cadence). Returns the pass summary when a
        pass ran."""
        if self.defrag is None:
            return None
        now = self._clock()
        with self._lock:
            if now - self._last_defrag < self.config.defrag_interval_s:
                return None
            self._last_defrag = now
        return self.defrag.run_once()
