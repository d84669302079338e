"""ShardMap — instance group -> owning replica.

The active-active traffic partition: live predicate traffic is sharded by
the pod's instance group, the same boundary the solver's domain partitioning
proved commutes (a group's gangs only ever place on that group's nodes,
so per-group solves are independent and order-free across groups). The
map is a pure function of (group, replica count) — stable CRC32 — so
every replica computes the same ownership with no coordination, and
kube-scheduler can hit any replica: non-owners forward to the owner
(in-process delegation or an HTTP redirect) instead of failing.

The membership/remap mechanics live in core/membership.py
(StableMembership), the JAX package's shared membership core, copied as
it is so the two packages cannot fork the remap logic.
"""

from __future__ import annotations

from spark_scheduler_tpu_torch.core.membership import StableMembership


class ShardMap:
    def __init__(self, n_replicas: int):
        if n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        # Live membership: removing a member remaps its groups onto the
        # survivors (modulo over the live list — every replica computes
        # the same map from the same membership, no coordination beyond
        # agreeing on who is live).
        self._members = StableMembership(n_replicas)

    @property
    def n_replicas(self) -> int:
        return self._members.n_slots

    @property
    def _live(self) -> list[int]:
        return self._members._live

    def remove(self, index: int) -> None:
        if len(self._members._live) <= 1:
            raise ValueError("cannot remove the last live replica")
        self._members.remove(index)

    def owner(self, instance_group: str) -> int:
        """Owning replica index for a group — stable across processes and
        runs (CRC32, not Python's salted hash). Assignment is over the
        ORIGINAL slot space: removing a member moves only ITS groups onto
        survivors — a surviving member's groups never change owner, so an
        in-flight window on a survivor cannot silently lose ownership
        mid-commit (only the removed member moves, and it is fenced)."""
        return self._members.owner(instance_group)

    def owned_by(self, index: int, groups) -> list[str]:
        return self._members.owned_by(index, groups)

    def describe(self, groups=()) -> dict:
        return {
            "replicas": self.n_replicas,
            "live": self._members.live(),
            "assignments": {g: self.owner(g) for g in groups},
        }
