"""ZoneAggregates — resident per-zone availability totals for the prune
planner (core/prune.py), the port's copy of
spark_scheduler_tpu/core/zone_aggregates.py.

The planner derives each window's `zone_base` offsets (the excluded rows'
per-zone availability sums that keep the gathered sub-cluster's zone ranks
exact, ops/sorting.zone_ranks) as `total − Σ kept` in O(K). The totals
live here, event-maintained:

  cnt[z]   number of valid rows in zone z;
  mem[z] / cpu[z]
           int64 sums of available memory / cpu over the valid rows of
           zone z (exact integer arithmetic at any roster size).

`update_rows` applies a set of changed rows in O(changed): each row's old
contribution (from the int64 snapshots kept here) is subtracted and its
new contribution added, handling validity flips and zone moves (static
row-deltas) in the same pass.

`diff_rows` is the resync fallback: when a serving path that does not
report its rows touched the availability, the planner asks for the rows
whose host availability drifted from the snapshots (one vectorized
compare).

`rebuild` is the from-scratch build (attach / invalidate) and the
consistency tests' twin.
"""

from __future__ import annotations

import numpy as np

from spark_scheduler_tpu_torch.models.resources import CPU_DIM, GPU_DIM, MEM_DIM


class ZoneAggregates:
    __slots__ = (
        "_mem", "_cpu", "_gpu", "_valid", "_zone",
        "cnt", "mem", "cpu", "num_zones",
        "rebuilds", "updates", "rows_applied",
    )

    def __init__(self):
        self._mem: np.ndarray | None = None  # [N] int64 snapshots
        self._cpu: np.ndarray | None = None
        self._gpu: np.ndarray | None = None
        self._valid: np.ndarray | None = None  # [N] bool
        self._zone: np.ndarray | None = None  # [N] int32
        self.cnt: np.ndarray | None = None  # [Zb] int64
        self.mem: np.ndarray | None = None  # [Zb] int64
        self.cpu: np.ndarray | None = None  # [Zb] int64
        self.num_zones = 0
        self.rebuilds = 0
        self.updates = 0
        self.rows_applied = 0

    @property
    def valid(self) -> bool:
        return self._mem is not None

    def invalidate(self) -> None:
        self._mem = None

    def rebuild(
        self,
        avail: np.ndarray,  # [N,3] int32 host availability
        zone_id: np.ndarray,  # [N] int32
        valid: np.ndarray,  # [N] bool
        num_zones: int,
    ) -> None:
        self._mem = avail[:, MEM_DIM].astype(np.int64)
        self._cpu = avail[:, CPU_DIM].astype(np.int64)
        self._gpu = avail[:, GPU_DIM].astype(np.int64)
        self._valid = np.asarray(valid, bool).copy()
        self._zone = np.asarray(zone_id).astype(np.int32)
        self.num_zones = int(num_zones)
        vz = self._zone[self._valid]
        self.cnt = np.bincount(vz, minlength=num_zones).astype(np.int64)
        # int64 integer sums — exact at any roster size.
        self.mem = np.zeros(num_zones, np.int64)
        self.cpu = np.zeros(num_zones, np.int64)
        np.add.at(self.mem, vz, self._mem[self._valid])
        np.add.at(self.cpu, vz, self._cpu[self._valid])
        self.rebuilds += 1

    def update_rows(
        self,
        avail: np.ndarray,
        zone_id: np.ndarray,
        valid: np.ndarray,
        rows: np.ndarray,
    ) -> None:
        """Apply the changed rows' new (availability, validity, zone)
        state to the totals and snapshots — O(changed)."""
        rows = np.asarray(rows)
        if rows.size == 0:
            return
        rows = np.unique(rows)
        old_v = self._valid[rows]
        old_z = self._zone[rows]
        # Remove old contributions (valid rows only).
        ov = rows[old_v]
        if ov.size:
            oz = self._zone[ov]
            np.add.at(self.cnt, oz, -1)
            np.add.at(self.mem, oz, -self._mem[ov])
            np.add.at(self.cpu, oz, -self._cpu[ov])
        new_v = np.asarray(valid, bool)[rows]
        new_z = np.asarray(zone_id)[rows].astype(np.int32)
        new_mem = avail[rows, MEM_DIM].astype(np.int64)
        new_cpu = avail[rows, CPU_DIM].astype(np.int64)
        nv = new_v.nonzero()[0]
        if nv.size:
            nz = new_z[nv]
            np.add.at(self.cnt, nz, 1)
            np.add.at(self.mem, nz, new_mem[nv])
            np.add.at(self.cpu, nz, new_cpu[nv])
        self._mem[rows] = new_mem
        self._cpu[rows] = new_cpu
        self._gpu[rows] = avail[rows, GPU_DIM].astype(np.int64)
        self._valid[rows] = new_v
        self._zone[rows] = new_z
        self.updates += 1
        self.rows_applied += int(rows.size)

    def diff_rows(self, avail: np.ndarray) -> np.ndarray:
        """Rows whose host availability drifted from the snapshots (any
        dim) — the O(N) resync fallback for un-reported churn."""
        return np.flatnonzero(
            (self._mem != avail[:, MEM_DIM])
            | (self._cpu != avail[:, CPU_DIM])
            | (self._gpu != avail[:, GPU_DIM])
        )

    def zone_of(self, rows: np.ndarray) -> np.ndarray:
        """Snapshot zone of `rows` (pre-update classification)."""
        return self._zone[rows]

    def valid_of(self, rows: np.ndarray) -> np.ndarray:
        return self._valid[rows]

    def mem_of(self, rows: np.ndarray) -> np.ndarray:
        """Snapshot available-memory of `rows` — the OLD contribution a
        per-domain total must subtract before applying the new state
        (core/prune.py domain plan contexts)."""
        return self._mem[rows]

    def cpu_of(self, rows: np.ndarray) -> np.ndarray:
        return self._cpu[rows]

    def stats(self) -> dict:
        return {
            "rebuilds": self.rebuilds,
            "updates": self.updates,
            "rows_applied": self.rows_applied,
            "zones": int((self.cnt > 0).sum()) if self.cnt is not None else 0,
        }
