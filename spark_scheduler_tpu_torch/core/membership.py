"""StableMembership — the live-membership/remap core shared by the
instance-group ShardMap (ha/shard.py) and, in the JAX package, the fleet
ClusterMap.

One rule, two layers: ownership is a pure function of (key, slot count)
— stable CRC32 over the ORIGINAL slot space — with a live-list fallback
for dead slots. Removing a member moves only ITS keys onto survivors; a
surviving member's keys never change owner, so an in-flight window on a
survivor cannot silently lose ownership mid-commit. Every participant
computes the same map from the same membership with no coordination
beyond agreeing on who is live.
"""

from __future__ import annotations

import zlib


class StableMembership:
    """Live membership over a fixed original slot space [0, n_slots)."""

    __slots__ = ("n_slots", "_live")

    def __init__(self, n_slots: int):
        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        self.n_slots = n_slots
        self._live = list(range(n_slots))

    def live(self) -> list[int]:
        return list(self._live)

    def is_live(self, index: int) -> bool:
        return index in self._live

    def remove(self, index: int) -> None:
        if len(self._live) <= 1:
            raise ValueError("cannot remove the last live member")
        if index in self._live:
            self._live.remove(index)

    def rejoin(self, index: int) -> None:
        if not 0 <= index < self.n_slots:
            raise ValueError(f"index {index} outside slot space")
        if index not in self._live:
            self._live.append(index)
            self._live.sort()

    def owner(self, key: str) -> int:
        """Owning slot for a key — stable across processes and runs
        (CRC32, not Python's salted hash). Assignment is over the
        ORIGINAL slot space: only a dead slot's keys fall through to the
        live-list modulo, so survivors' keys are never remapped."""
        h = zlib.crc32(key.encode("utf-8"))
        idx = h % self.n_slots
        live = self._live  # never empty: remove() refuses the last member
        if idx in live:
            return idx
        return live[h % len(live)]

    def owned_by(self, index: int, keys) -> list[str]:
        return [k for k in keys if self.owner(k) == index]

    def describe(self, keys=()) -> dict:
        return {
            "slots": self.n_slots,
            "live": list(self._live),
            "assignments": {k: self.owner(k) for k in keys},
        }
