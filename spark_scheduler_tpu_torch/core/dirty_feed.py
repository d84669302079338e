"""DirtyRowFeed — the shared dirty-row drain protocol of the resident
masters.

Both delta-maintained dense mirrors (core/usage_tracker.
ReservedUsageTracker, core/overhead.OverheadComputer's dense feed) name
the registry rows they change so the HostFeatureStore can patch its
resident masters O(changed) instead of copying the whole [cap, 3] array
per refresh. The protocol is identical in both and correctness-coupled
— the store's patch is sound only if every mutation is either noted or
surfaced as UNKNOWN — so it lives here once:

  note(idx)       record one changed row; past the cap the backlog is
                  dropped and the feed goes UNKNOWN (the single consumer
                  stopped draining — a full copy resyncs it);
  mark_unknown()  a from-scratch rebuild/attach cannot name its rows;
  drain(dense)    single-consumer drain: (rows, vals) of the changes
                  since the last drain — vals copied from `dense` so the
                  values are consistent with the owner's version counter
                  — or (None, None) when unknown. The OWNER'S lock must
                  be held (the same lock guarding `dense` mutations).
"""

from __future__ import annotations

import numpy as np


class DirtyRowFeed:
    __slots__ = ("_rows", "_unknown", "_cap")

    def __init__(self, cap: int = 1 << 20):
        self._rows: list[int] = []
        self._unknown = True
        self._cap = cap

    def note(self, idx: int) -> None:
        if self._unknown:
            return
        if len(self._rows) >= self._cap:
            self._rows.clear()
            self._unknown = True
        else:
            self._rows.append(idx)

    def mark_unknown(self) -> None:
        self._rows.clear()
        self._unknown = True

    def drain(self, dense: np.ndarray):
        """(rows, vals) changed since the last drain, or (None, None)
        when the feed cannot name them. Caller holds the owner's lock."""
        if self._unknown:
            self._rows.clear()
            self._unknown = False
            return None, None
        if not self._rows:
            return (
                np.empty(0, np.int64),
                np.empty((0, dense.shape[1]), np.int64),
            )
        rows = np.unique(np.asarray(self._rows, dtype=np.int64))
        self._rows.clear()
        return rows, dense[rows].copy()
