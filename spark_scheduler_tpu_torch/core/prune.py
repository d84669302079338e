"""Sound top-K candidate pruning for the window solve (the two-tier solve).

The port's copy of spark_scheduler_tpu/core/prune.py. The logic is host
numpy in both packages and stays line for line equal, so the two planners
keep the same rows and certify the same windows; only the imports differ.

A 32-request window can only touch a few hundred of a large cluster's rows,
yet the full solve sorts and walks every row of every segment. The two-tier
solve makes the device's work O(K):

  Tier 1 (host prefilter, this module): rank the window domain's nodes by
  the solver's own placement key (zone rank, available mem asc, cpu asc,
  name rank), riding the per-zone orders of core/feature_store.RankIndex,
  and gather the top-K candidate rows per zone, K sized from the window's
  aggregate demand x `solver.prune-slack`. The device then solves a [K,3]
  gathered sub-cluster: on the card the row-walk kernel, with the excluded
  rows' per-zone availability sums passed as constant offsets
  (ops/sorting.zone_ranks `zone_base`), so the sub-cluster ranks its zones
  exactly as the full cluster does.

  Tier 2 (the certificate, also this module): after the pruned solve,
  `certify_window` replays the window's availability thread host-side and
  verifies that no pruned-away row could have altered any decision:

    - a DENIAL is certified only if no excluded row could have cured it
      (capacity bound over the excluded rows' per-zone maxima, for the
      driver fit and the executor capacity);
    - an ADMISSION is certified only if (a) no excluded driver candidate
      with a better priority key could fit the driver, (b) no excluded
      executor-capable row ranks before the worst chosen executor row,
      (c) excluded capacity could not have flipped the feasibility of a
      better-ranked kept driver candidate the pruned solve rejected, and
      (d) no strategy-specific order hazard applies (minimal-fragmentation
      consumes by capacity DESC, so any excluded capacity escalates;
      distribute-evenly escalates on multi-round fills).

  A failed certificate ESCALATES the window: the solver re-solves it in
  full from the exact host reconstruction (core/solver.py
  `_escalate_pruned`), so decisions equal the unpruned path's by
  construction, and the escalation is counted in
  `foundry.spark.scheduler.solver.prune.*`.

Every test here is CONSERVATIVE (it may escalate a window the full solve
would have decided identically, never the reverse).

The planner is O(K + changed) a window:

  - per-zone availability TOTALS live in event-maintained aggregates
    (core/zone_aggregates.ZoneAggregates) for the full valid mask, and
    every SUBSET domain keeps its own [Zb] totals, delta-maintained from
    the same dirty-row feed, so a window's `zone_base` derives as
    `total − Σ kept` in O(K);
  - the top-K kept rows, the excluded lexmin keys and the excluded
    per-dim maxima are CACHED per (domain, zone) and reused while the
    zone's excluded rows are untouched: churn confined to the kept rows
    (gang placements, the steady serving case) reuses the entry
    verbatim; a newly valid row merges in exactly; a merged row beating
    the kept-set boundary is INSERTED into the kept order directly;
    depletion, static flips on kept rows and exhausted leftover budgets
    re-scan the zone;
  - a no-churn window therefore re-serves the identical kept row set
    (`plan_reuse`), which keys the solver's statics-gather reuse.

A subset domain's FIRST plan pays one vectorized O(N) sweep
(`sweep_rows`); after that it absorbs churn in O(changed). A domain
MEMBERSHIP change re-keys the window's domain mask and cold-starts a fresh
context.

Gating (checked by the solver before planning): plain fills only (the
single-AZ wrappers score zones by subset-dependent efficiencies), no
configured label priorities (the keys above assume a uniform label rank),
and one shared domain per window.
"""

from __future__ import annotations

import dataclasses
import time as _time

import numpy as np

from spark_scheduler_tpu_torch.models.resources import CPU_DIM, MEM_DIM

PLAIN_FILLS = frozenset(
    {"tightly-pack", "distribute-evenly", "minimal-fragmentation"}
)

_I64_MAX = np.iinfo(np.int64).max
_I64_MIN = np.iinfo(np.int64).min


from spark_scheduler_tpu_torch.models.cluster import pad_bucket as _bucket  # noqa: E402


def zone_ranks_host(
    mem_sum: np.ndarray,  # [Z] int64 — per-zone available-memory sums
    cpu_sum: np.ndarray,  # [Z] int64
    present: np.ndarray,  # [Z] bool — zone has a (domain & valid) node
) -> np.ndarray:  # [Z] int32 — rank of each zone (0 = highest priority)
    """Host replica of ops/sorting.zone_ranks: ascending (mem, cpu), absent
    zones last, zone-id tiebreak. The kernel's chunked int32 aggregation is
    an exact int64 sum in normal form, so comparing int64 sums here yields
    the identical order — the certificate depends on that equality."""
    z = mem_sum.shape[0]
    absent = np.where(present, 0, 1)
    order = np.lexsort((np.arange(z), cpu_sum, mem_sum, absent))
    ranks = np.empty(z, np.int32)
    ranks[order] = np.arange(z, dtype=np.int32)
    return ranks


def split_zone_sums(sums: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """int64 per-zone sums -> (hi, lo) int32 limbs for the device offset
    (hi = S >> 24 arithmetic, lo = S & 0xFFFFFF; exact for |S| < 2^55)."""
    return (
        (sums >> 24).astype(np.int32),
        (sums & 0xFFFFFF).astype(np.int32),
    )


def _lex_lt(a0, a1, a2, a3, b0, b1, b2, b3):
    """Vectorized (a0,a1,a2,a3) < (b0,b1,b2,b3) — the priority-key compare
    (az rank, mem, cpu, name rank), lower = higher priority."""
    return (a0 < b0) | (
        (a0 == b0)
        & (
            (a1 < b1)
            | (
                (a1 == b1)
                & ((a2 < b2) | ((a2 == b2) & (a3 < b3)))
            )
        )
    )


@dataclasses.dataclass
class PrunePlan:
    """One window's candidate-pruning decision: the kept row set, the
    device zone-sum offsets, and the excluded-row summaries the
    certificate tests against. All arrays are host numpy. Kept-row
    MEMBERSHIP is answered by bisecting the sorted real part of `keep`
    (no dense [N] kept mask: that would be an O(N) allocation per
    window)."""

    keep: np.ndarray  # [Kp] int32 — kept global rows, real part SORTED
    #                     ascending, padding repeats keep[0]
    k_real: int  # number of real kept rows
    dom_mask: np.ndarray  # [N] bool — window domain & valid
    num_zones: int  # the solver's zone bucket Zb
    # Device offsets: excluded-row zone sums as int32 limbs + present.
    zone_base: tuple  # (mem_hi, mem_lo, cpu_hi, cpu_lo, present) [Zb] each
    # Dispatch-time zone sums over the WHOLE domain (kept + excluded) —
    # the certificate threads these (minus committed placements) to
    # replicate the kernel's per-segment zone ranks.
    zone_mem: np.ndarray  # [Zb] int64
    zone_cpu: np.ndarray  # [Zb] int64
    present: np.ndarray  # [Zb] bool
    # Excluded-row summaries, per zone, over rows RELEVANT to this window
    # (rows fitting the window's per-dim minimum demand; rows that fit no
    # request are provably transparent — zero capacity, no driver fit).
    # e_cnt_* is consumed as a PRESENCE flag (> 0) by the certificate; the
    # resident-cache fast path stores 0/1.
    e_cnt_exec: np.ndarray  # [Zb] int64 — relevant excluded exec-eligible
    e_max_exec: np.ndarray  # [Zb,3] int64 — per-dim avail max (conservative fit)
    e_key_exec: np.ndarray  # [Zb,3] int64 — lexmin (mem,cpu,name), I64_MAX pad
    e_cnt_drv: np.ndarray  # [Zb] int64
    e_max_drv: np.ndarray  # [Zb,3] int64
    e_key_drv: np.ndarray  # [Zb,3] int64
    # Per-request driver candidate masks gathered onto the kept rows.
    cand_kept: list  # [B_req] of [Kp] bool
    dom_rows: int  # |domain| (stats)
    # True when the kept row set (`keep` array object) was re-served from
    # the per-zone cache unchanged — the key for the solver's
    # statics-gather reuse.
    reused: bool = False
    plan_ms: float = 0.0  # prefilter planning wall time
    offset_ms: float = 0.0  # zone_base offset derivation wall time


class _ZoneEntry:
    """Cached per-(domain, zone) prefilter state: the kept rows and the
    excluded-row summaries for one zone. An excluded-row change keeps the
    entry SOUND by merging the row's new state (exact-direction: min/max/
    presence can only extend) while the old contribution lingers as a
    conservative leftover; `stale` counts those leftovers so the zone
    re-scans before conservatism drifts into spurious escalations."""

    __slots__ = (
        "kept_e", "kept_d", "keep", "has_e", "has_d",
        "key_e", "key_d", "max_e", "max_d", "stale", "depleted",
        "last_key_e", "last_key_d",
    )

    def __init__(self, kept_e, kept_d, has_e, has_d, key_e, key_d,
                 max_e, max_d, last_key_e=None, last_key_d=None):
        self.kept_e = kept_e
        self.kept_d = kept_d
        self.keep = np.unique(np.concatenate([kept_e, kept_d]))
        self.has_e = has_e
        self.has_d = has_d
        self.key_e = key_e  # int64[3] lexmin (mem, cpu, name) or I64_MAX
        self.key_d = key_d
        self.max_e = max_e  # int64[3] per-dim max or I64_MIN
        self.max_d = max_d
        self.stale = 0
        # Kept rows whose availability dropped below the window minima:
        # still sound to keep (the kernel just skips them), but a zone
        # whose kept set depletes while fresh excluded capacity sits
        # outside WILL eventually fail the certificate (the full solve
        # would place there) — refresh the entry before that costs an
        # escalation.
        self.depleted = 0
        # Key of the K-th (worst) kept row per class at build time — the
        # kept-set BOUNDARY. A merged row whose key beats it belongs in
        # the kept set: it is INSERTED directly (the old K-th row evicts
        # into the excluded summaries — O(K)) instead of
        # forcing the O(zone) re-scan. None = the zone kept every
        # fitting row, so ANY new fitting row simply joins the set.
        self.last_key_e = last_key_e
        self.last_key_d = last_key_d


class _DomCtx:
    """Resident planning context for ONE window domain: the per-zone
    entries, the assembled kept set, and the minima/K the entries were
    built for. The FULL-domain context (`dom_mask is None`) reads its
    per-zone availability totals live from the resident ZoneAggregates;
    a SUBSET domain (a pooled partition's instance group) owns [Zb]
    totals of its member rows, delta-maintained from the same dirty-row
    feed — the per-partition analog of the aggregates."""

    __slots__ = (
        "dom_mask", "entries", "keep", "keep_real",
        "min_dr", "min_er", "k", "zone_mem", "zone_cpu", "zcnt",
    )

    def __init__(self, dom_mask=None):
        self.dom_mask = dom_mask  # None = the full valid mask
        self.entries: dict[int, _ZoneEntry] = {}
        self.keep: np.ndarray | None = None  # assembled padded keep
        self.keep_real = 0
        self.min_dr: np.ndarray | None = None  # None = COLD
        self.min_er: np.ndarray | None = None
        self.k = 0
        # Subset domains only: event-maintained per-zone totals.
        self.zone_mem: np.ndarray | None = None
        self.zone_cpu: np.ndarray | None = None
        self.zcnt: np.ndarray | None = None


def _key_lt(a, b) -> bool:
    """Lexicographic (mem, cpu, name) triple compare."""
    for x, y in zip(a, b):
        if x != y:
            return x < y
    return False


def _merge_excluded(
    entry, r: int, avail, min_dr, min_er, unsched, ready, name_rank
) -> None:
    """Fold one EXCLUDED row's current state into a zone entry's
    summaries — presence / lexmin key / per-dim maxima, per class, exact
    direction (joining a summary can only extend it). The single shared
    body of the merge, boundary-insert eviction and depletion-refresh
    paths: the certificate's summary contract lives here once."""
    av = avail[r].astype(np.int64)
    key = (
        int(avail[r, MEM_DIM]),
        int(avail[r, CPU_DIM]),
        int(name_rank[r]),
    )
    if (av >= min_dr).all():
        entry.has_d = True
        if _key_lt(key, entry.key_d):
            entry.key_d = key
        entry.max_d = np.maximum(entry.max_d, av)
    if (av >= min_er).all() and not unsched[r] and ready[r]:
        entry.has_e = True
        if _key_lt(key, entry.key_e):
            entry.key_e = key
        entry.max_e = np.maximum(entry.max_e, av)


class PrunePlanner:
    """O(K + changed) window planning over resident per-(domain, zone)
    state.

    Owns the per-zone RankIndex (priority orders), the ZoneAggregates
    (availability totals), the full-domain plan context and one cached
    context per subset domain (the pooled partition path). The solver
    feeds it the EXACT changed rows it already knows (pipelined-build
    delta rows, static row-deltas, fetched placement rows); a serving
    path that cannot name its rows marks the planner UNKNOWN and the next
    sync pays one vectorized snapshot compare instead.
    """

    # Cached subset-domain contexts (pooled partitions): enough for a
    # realistic instance-group fan-out; overflow clears the oldest-built.
    _MAX_DOM_CTXS = 16

    def __init__(self, stats: dict | None = None):
        from spark_scheduler_tpu_torch.core.feature_store import RankIndex
        from spark_scheduler_tpu_torch.core.zone_aggregates import ZoneAggregates

        self.index = RankIndex()
        self.agg = ZoneAggregates()
        self._full = _DomCtx(None)
        self._dom_ctxs: dict = {}  # dom_key -> _DomCtx (subset domains)
        # [N] bool exec-eligibility snapshot (~unschedulable & ready):
        # distinguishes a RANK-only static relabel (benign for a kept
        # row) from an eligibility flip (re-scan) at absorb time.
        self._elig: np.ndarray | None = None
        # Pending change feed (drained at sync): explicit dirty rows,
        # static-delta rows, or None = unknown (snapshot compare).
        self._dirty: list | None = []
        self._static: list = []
        self.stats = stats if stats is not None else {}
        for key in (
            "planner_rows_scanned", "planner_cold_rows",
            "planner_sweep_rows", "planner_resync_rows",
            "planner_zone_rescans", "planner_zone_refreshes",
            "planner_merges", "planner_boundary_inserts", "plan_reuse",
        ):
            self.stats.setdefault(key, 0)

    # -- change feed ---------------------------------------------------------

    def invalidate(self) -> None:
        self.index.invalidate()
        self.agg.invalidate()
        self._full = _DomCtx(None)  # next build is COLD (counter attribution)
        self._dom_ctxs.clear()
        self._dirty = []
        self._static = []

    def note_dirty(self, rows) -> None:
        """Rows whose availability changed (exact — pipelined build deltas,
        fetched placement rows)."""
        if self._dirty is not None and len(rows):
            self._dirty.append(np.asarray(rows))

    def note_static(self, rows) -> None:
        """Rows whose STATIC fields changed (static row-delta: validity,
        zone, name rank, eligibility flags)."""
        if len(rows):
            self._static.append(np.asarray(rows))

    def mark_unknown(self) -> None:
        """A serving path touched availability without naming rows (dense
        unpruned fetch): the next sync diff-scans the snapshots."""
        self._dirty = None

    def reset_plan_entries(self) -> None:
        """Drop every cached kept set / excluded summary while KEEPING
        the resident index and aggregates (re-scans are O(zone), not the
        O(N log N) cold rebuild). Called after a certificate escalation:
        conservative drift (depletion-refresh carry-overs, stale merge
        leftovers) may have caused it, and re-scanning to exactness
        guarantees an escalation can never loop on the same stale entry."""
        self._full.entries.clear()
        self._full.keep = None
        for ctx in self._dom_ctxs.values():
            ctx.entries.clear()
            ctx.keep = None

    # -- sync ----------------------------------------------------------------

    def sync(self, host, num_zones: int) -> None:
        """Bring the resident index/aggregates/contexts up to the CURRENT
        host view, in O(changed) when the change feed is exact."""
        avail = np.asarray(host.available)
        zid = np.asarray(host.zone_id)
        valid = np.asarray(host.valid)
        name_rank = np.asarray(host.name_rank)
        n = avail.shape[0]
        if (
            not self.index.valid
            or not self.agg.valid
            or self.index.rows != n
            or self.index.num_zones != num_zones
        ):
            self._rebuild(avail, name_rank, zid, valid, num_zones)
            return
        if self._elig is None or self._elig.shape[0] != n:
            # Eligibility snapshot as of THIS sync's entry (pre-absorb):
            # initialized here — never inside absorb, where host already
            # reflects the very events being classified.
            self._elig = (
                ~np.asarray(host.unschedulable, bool)
                & np.asarray(host.ready, bool)
            ).copy()
        if self._dirty is None:
            dirty = self.agg.diff_rows(avail)
            self.stats["planner_resync_rows"] += n
        else:
            dirty = (
                np.unique(np.concatenate(self._dirty))
                if self._dirty
                else np.empty(0, np.int64)
            )
        static = (
            np.unique(np.concatenate(self._static))
            if self._static
            else np.empty(0, np.int64)
        )
        self._dirty = []
        self._static = []
        if dirty.size == 0 and static.size == 0:
            return
        all_dirty = (
            np.union1d(dirty, static) if static.size else dirty
        )
        if all_dirty.size > max(1024, n // 4):
            self._rebuild(avail, name_rank, zid, valid, num_zones)
            return
        self._absorb(all_dirty, static, avail, zid, valid, host)
        self.index.update_rows(avail, name_rank, all_dirty, zone_id=zid)
        self.agg.update_rows(avail, zid, valid, all_dirty)
        if self._elig is not None and all_dirty.size:
            rows = all_dirty[all_dirty < self._elig.shape[0]]
            self._elig[rows] = (
                ~np.asarray(host.unschedulable, bool)[rows]
                & np.asarray(host.ready, bool)[rows]
            )

    def _rebuild(self, avail, name_rank, zid, valid, num_zones) -> None:
        self.index.rebuild(avail, name_rank, zid, num_zones)
        self.agg.rebuild(avail, zid, valid, num_zones)
        self._full.entries.clear()
        self._full.keep = None
        self._dom_ctxs.clear()
        self._dirty = []
        self._static = []
        self._elig = None  # re-snapshotted lazily at the next absorb

    # Conservative-leftover budget per zone entry: each absorbed
    # excluded-row change leaves the row's OLD contribution behind in the
    # per-zone summaries (sound, but it can only over-approximate); past
    # this many leftovers the zone re-scans to restore exactness before
    # the drift causes spurious escalations.
    _STALE_BUDGET = 32

    def _absorb(self, all_dirty, static, avail, zid, valid, host) -> None:
        """Absorb the changed rows into every cached plan context, BEFORE
        the snapshots move:

          benign  — a non-static change to a KEPT row: the excluded-row
                    summaries depend only on excluded rows, so the entry
                    stands verbatim (the steady-serving case: gang
                    placements land on kept rows);
          insert  — a change to a NON-KEPT row whose key BEATS the kept
                    boundary (a node ADD whose name sorts first): the row
                    is inserted into the kept order directly and the old
                    K-th row evicts into the excluded summaries — O(K),
                    no re-scan;
          merge   — any other change to a NON-KEPT row: the row's NEW
                    state merges exactly (joining a summary can only
                    extend min/max/presence), while its old contribution
                    lingers as a conservative leftover — sound by the
                    certificate's over-approximation contract. Leftovers
                    are budgeted (`_STALE_BUDGET`) per zone;
          rescan  — a STATIC flip on a kept row (validity/zone/rank of a
                    kept row breaks the `total − kept` offset identity),
                    kept-set depletion past the budget, or an exhausted
                    leftover budget: drop the zone's entry; the next plan
                    re-scans just that zone.
        """
        ctxs = [self._full] + list(self._dom_ctxs.values())
        live = [
            c for c in ctxs
            if c.entries or (c.dom_mask is not None and c.zcnt is not None)
        ]
        if not live:
            return
        if all_dirty.size > 4096:
            # A bulk churn burst (resync after a dense fetch, a huge
            # delta): dropping every context is cheaper and exact — the
            # next plan re-scans the zones (or domains) it needs.
            self._full.entries.clear()
            self._full.keep = None
            self._dom_ctxs.clear()
            return
        n = avail.shape[0]
        all_dirty = all_dirty[all_dirty < n]
        if not all_dirty.size:
            return
        old_zone = self.agg.zone_of(all_dirty)
        new_zone = zid[all_dirty].astype(np.int32)
        was_valid = self.agg.valid_of(all_dirty)
        is_static = (
            np.isin(all_dirty, static) if static.size else
            np.zeros(all_dirty.shape[0], bool)
        )
        unsched = np.asarray(host.unschedulable, bool)
        ready = np.asarray(host.ready, bool)
        name_rank = np.asarray(host.name_rank)
        # A kept row's static flip forces a zone re-scan ONLY when it
        # breaks the `total − kept` offset identity (zone move, validity
        # flip) or the row's exec eligibility. Rank/label relabels — the
        # name-rank REBALANCE a node-ADD burst scatters over the insert
        # point's neighborhood — leave sums, membership, eligibility and
        # the excluded summaries exact: treating them as re-scans made
        # every burst add O(zone) again.
        elig_new = ~unsched[all_dirty] & ready[all_dirty]
        keeps_identity = (
            (old_zone == new_zone)
            & (was_valid == np.asarray(valid, bool)[all_dirty])
            & (self._elig[all_dirty] == elig_new)
        )
        for ctx in live:
            if ctx.dom_mask is not None and ctx.zcnt is not None:
                # Per-domain totals: subtract the rows' old contribution
                # (agg snapshots — not yet updated this sync) and add the
                # new, restricted to domain members.
                sel = all_dirty[ctx.dom_mask[all_dirty]]
                if sel.size:
                    self._ctx_totals_update(ctx, sel, avail, zid, valid)
            if not ctx.entries:
                continue
            self._absorb_ctx(
                ctx, all_dirty, old_zone, new_zone, was_valid, is_static,
                keeps_identity, avail, valid, unsched, ready, name_rank,
            )

    def _ctx_totals_update(self, ctx, rows, avail, zid, valid) -> None:
        old_v = self.agg.valid_of(rows)
        ov = rows[old_v]
        if ov.size:
            oz = self.agg.zone_of(ov)
            np.add.at(ctx.zcnt, oz, -1)
            np.add.at(ctx.zone_mem, oz, -self.agg.mem_of(ov))
            np.add.at(ctx.zone_cpu, oz, -self.agg.cpu_of(ov))
        nv = rows[np.asarray(valid, bool)[rows]]
        if nv.size:
            nz = np.asarray(zid)[nv]
            np.add.at(ctx.zcnt, nz, 1)
            np.add.at(ctx.zone_mem, nz, avail[nv, MEM_DIM].astype(np.int64))
            np.add.at(ctx.zone_cpu, nz, avail[nv, CPU_DIM].astype(np.int64))

    def _absorb_ctx(
        self, ctx, all_dirty, old_zone, new_zone, was_valid, is_static,
        keeps_identity, avail, valid, unsched, ready, name_rank,
    ) -> None:
        dm = ctx.dom_mask
        for i, r in enumerate(all_dirty):
            if dm is not None and not dm[r]:
                continue
            oz, nz = int(old_zone[i]), int(new_zone[i])
            entry = ctx.entries.get(nz)
            in_keep = False
            if entry is not None and entry.keep.size:
                p = np.searchsorted(entry.keep, r)
                in_keep = bool(
                    p < entry.keep.size and entry.keep[p] == r
                )
            if in_keep:
                if not is_static[i] or keeps_identity[i]:
                    # Benign: kept-row value churn, or a static relabel
                    # (name/label rank) that leaves zone and validity —
                    # the offset identity's inputs — untouched. Track
                    # DEPLETION either way: a kept row that no longer
                    # fits either class minimum (or lost exec
                    # eligibility) is dead weight, and a zone serving
                    # mostly-depleted kept rows while fresh excluded
                    # capacity exists will fail its certificate;
                    # refresh first.
                    av = avail[r]
                    if ctx.min_dr is not None and (
                        not (
                            (av >= ctx.min_dr).all()
                            or (av >= ctx.min_er).all()
                        )
                        or (is_static[i] and (unsched[r] or not ready[r]))
                    ):
                        entry.depleted += 1
                        # Aggressive on purpose: a zone serving depleted
                        # kept rows ranks FIRST (lowest totals), so the
                        # full solve would reach for its excluded rows
                        # almost immediately. The refresh re-picks the
                        # kept set by an EARLY-EXIT walk of the order —
                        # O(K + consumed prefix), not O(zone) — far
                        # cheaper than the escalation it prevents.
                        if entry.depleted > max(1, ctx.k // 8):
                            self._refresh_zone(
                                ctx, nz, entry, avail, valid, unsched,
                                ready, name_rank,
                            )
                    continue
                # Zone move / validity flip of a KEPT row: the offset
                # identity needs every kept row live in its zone —
                # re-scan.
                ctx.entries.pop(nz, None)
                ctx.keep = None
                continue
            # Non-kept row: merge its new state (exact direction), note
            # the leftover. A zone move leaves its old zone's summaries
            # as leftovers too.
            if oz != nz:
                old_entry = ctx.entries.get(oz)
                if old_entry is not None:
                    kp = old_entry.keep
                    p = np.searchsorted(kp, r) if kp.size else 0
                    if kp.size and p < kp.size and kp[p] == r:
                        # The moved row was KEPT under its old zone: the
                        # old entry's offset identity is broken — re-scan.
                        ctx.entries.pop(oz, None)
                        ctx.keep = None
                    else:
                        old_entry.stale += 1
                        if old_entry.stale > self._STALE_BUDGET:
                            ctx.entries.pop(oz, None)
                            ctx.keep = None
            if entry is None:
                continue
            if bool(valid[r]):
                self._merge_row(
                    ctx, entry, int(r), avail, unsched, ready, name_rank
                )
            if not was_valid[i]:
                # A brand-new valid row (node ADD) merged EXACTLY — it
                # has no old contribution, so no leftover to budget.
                continue
            if is_static[i] and keeps_identity[i]:
                # Rank/label-only relabel of an excluded row (the ADD
                # burst's rebalance neighborhood): sums, counts and
                # per-dim maxima are untouched; only the lexmin keys'
                # NAME component can go conservative-stale. Charging the
                # leftover budget made every ~32 relabels force an
                # O(zone) re-scan — a steady add stream relabels
                # hundreds. Certificate soundness is unaffected (stale
                # keys only over-approximate).
                continue
            entry.stale += 1
            if entry.stale > self._STALE_BUDGET:
                ctx.entries.pop(nz, None)
                ctx.keep = None

    def _merge_row(
        self, ctx, entry, r, avail, unsched, ready, name_rank
    ) -> None:
        """Absorb one non-kept row's NEW state into the zone entry. A row
        BEATING a class's kept-set boundary is inserted into that class's
        kept order directly (evicting the tail into the excluded
        summaries — O(K), no re-scan); anything else merges into the
        excluded summaries (exact direction)."""
        av = avail[r].astype(np.int64)
        key = (
            int(avail[r, MEM_DIM]),
            int(avail[r, CPU_DIM]),
            int(name_rank[r]),
        )
        fits_d = bool((av >= ctx.min_dr).all())
        fits_e = bool(
            (av >= ctx.min_er).all() and not unsched[r] and ready[r]
        )
        ins_d = fits_d and (
            entry.last_key_d is None or _key_lt(key, entry.last_key_d)
        )
        ins_e = fits_e and (
            entry.last_key_e is None or _key_lt(key, entry.last_key_e)
        )
        if ins_d or ins_e:
            self._boundary_insert(
                ctx, entry, r, key, ins_d, ins_e,
                avail, unsched, ready, name_rank,
            )
            return
        _merge_excluded(
            entry, r, avail, ctx.min_dr, ctx.min_er,
            unsched, ready, name_rank,
        )
        self.stats["planner_merges"] += 1

    def _boundary_insert(
        self, ctx, entry, r, key, ins_d, ins_e,
        avail, unsched, ready, name_rank,
    ) -> None:
        """Insert a boundary-beating row into the kept order: O(K) — the row takes its key position per class, the old
        K-th row evicts into the excluded summaries exactly (an evicted
        row joins a summary for the first time, so there is no leftover
        to budget), and the class boundary key refreshes from the new
        tail. The assembled window keep is invalidated (reassembled in
        O(K) at the next plan); the per-zone summaries stay exact."""
        self.stats["planner_boundary_inserts"] += 1
        evicted: list[int] = []
        for cls, ins in (("d", ins_d), ("e", ins_e)):
            if not ins:
                continue
            kept = entry.kept_d if cls == "d" else entry.kept_e
            mem = avail[kept, MEM_DIM].astype(np.int64)
            cpu = avail[kept, CPU_DIM].astype(np.int64)
            nr = name_rank[kept].astype(np.int64)
            after = (mem > key[0]) | (
                (mem == key[0])
                & ((cpu > key[1]) | ((cpu == key[1]) & (nr > key[2])))
            )
            pos = int(np.argmax(after)) if bool(after.any()) else int(kept.size)
            new = np.insert(kept, pos, np.int32(r))
            if new.size > ctx.k:
                evicted.append(int(new[-1]))
                new = new[: ctx.k]
            if new.size >= ctx.k:
                last = int(new[-1])
                lk = (
                    int(avail[last, MEM_DIM]),
                    int(avail[last, CPU_DIM]),
                    int(name_rank[last]),
                )
            else:
                lk = None
            if cls == "d":
                entry.kept_d, entry.last_key_d = new, lk
            else:
                entry.kept_e, entry.last_key_e = new, lk
        entry.keep = np.unique(
            np.concatenate([entry.kept_e, entry.kept_d])
        )
        keep = entry.keep
        for ev in evicted:
            p = np.searchsorted(keep, ev)
            if p < keep.size and keep[p] == ev:
                continue  # still kept via the other class
            _merge_excluded(
                entry, ev, avail, ctx.min_dr, ctx.min_er,
                unsched, ready, name_rank,
            )
        ctx.keep = None

    def _refresh_zone(
        self, ctx, z, entry, avail, valid, unsched, ready, name_rank
    ) -> None:
        """Depletion refresh: re-pick the zone's
        kept rows by walking the resident order with EARLY EXIT — the
        depleted (most-consumed) rows sort FIRST in the order, so the
        walk costs O(K + consumed prefix), not O(zone). Rows leaving the
        kept set merge into the excluded summaries exactly; everything
        beyond the scanned prefix keeps its old (excluded) contribution
        — conservative, and budgeted like any other leftover, so the
        exact O(zone) re-scan still runs when conservatism accumulates.
        """
        zo = self.index.zone_order(z)
        k = ctx.k
        if zo.size <= max(4096, 8 * k):
            # Small zone: the exact re-scan costs about the same as the
            # walk — take exactness (no conservative carry-over).
            ctx.entries.pop(z, None)
            ctx.keep = None
            return
        dm = ctx.dom_mask
        sel_e: list = []
        sel_d: list = []
        n_e = n_d = 0
        pos = 0
        step = max(512, 4 * k)
        scanned = 0
        while pos < zo.size and (n_e <= k or n_d <= k):
            chunk = zo[pos:pos + step]
            pos += step
            scanned += int(chunk.size)
            live = (
                valid[chunk] if dm is None else (dm[chunk] & valid[chunk])
            )
            chunk = chunk[live]
            if not chunk.size:
                continue
            av = avail[chunk]
            fd = (av >= ctx.min_dr).all(axis=1)
            fe = (
                (av >= ctx.min_er).all(axis=1)
                & ~unsched[chunk]
                & ready[chunk]
            )
            if fd.any():
                sel_d.append(chunk[fd])
                n_d += int(fd.sum())
            if fe.any():
                sel_e.append(chunk[fe])
                n_e += int(fe.sum())
        self.stats["planner_rows_scanned"] += scanned
        self.stats["planner_zone_refreshes"] = (
            self.stats.get("planner_zone_refreshes", 0) + 1
        )
        fit_d = (
            np.concatenate(sel_d).astype(np.int32)
            if sel_d
            else np.empty(0, np.int32)
        )
        fit_e = (
            np.concatenate(sel_e).astype(np.int32)
            if sel_e
            else np.empty(0, np.int32)
        )

        def _key_of(r: int):
            return (
                int(avail[r, MEM_DIM]),
                int(avail[r, CPU_DIM]),
                int(name_rank[r]),
            )

        old_keep = entry.keep
        entry.kept_d = fit_d[:k]
        entry.kept_e = fit_e[:k]
        entry.keep = np.unique(
            np.concatenate([entry.kept_e, entry.kept_d])
        )
        entry.depleted = 0
        entry.stale += 1  # conservative carry-over: budget the drift
        entry.last_key_d = (
            _key_of(int(entry.kept_d[k - 1]))
            if entry.kept_d.size >= k
            else None
        )
        entry.last_key_e = (
            _key_of(int(entry.kept_e[k - 1]))
            if entry.kept_e.size >= k
            else None
        )
        # First fitting row past each kept prefix joins the lexmin/max
        # conservatively (it is the class's new excluded best within the
        # scanned prefix; beyond-scan rows were excluded before and keep
        # their old contributions).
        if fit_d.size > k:
            _merge_excluded(
                entry, int(fit_d[k]), avail, ctx.min_dr, ctx.min_er,
                unsched, ready, name_rank,
            )
        if fit_e.size > k:
            _merge_excluded(
                entry, int(fit_e[k]), avail, ctx.min_dr, ctx.min_er,
                unsched, ready, name_rank,
            )
        # Rows LEAVING the kept set merge in exactly (first membership in
        # the excluded summaries — their current state).
        if old_keep.size and entry.keep.size:
            p = np.clip(
                np.searchsorted(entry.keep, old_keep),
                0, entry.keep.size - 1,
            )
            gone = old_keep[entry.keep[p] != old_keep]
        else:
            gone = old_keep
        for r in gone:
            r = int(r)
            if bool(valid[r]) and (dm is None or bool(dm[r])):
                _merge_excluded(
                    entry, r, avail, ctx.min_dr, ctx.min_er,
                    unsched, ready, name_rank,
                )
        if entry.stale > self._STALE_BUDGET:
            ctx.entries.pop(z, None)  # exact re-scan at the next plan
        ctx.keep = None

    # -- planning ------------------------------------------------------------

    def plan_full_domain(
        self, host, *, cand_per_req, drv_arr, exc_arr, counts,
        num_zones, top_k, slack,
    ) -> PrunePlan | None:
        """O(K + changed) plan for a window whose shared domain is the
        full valid mask (the resident aggregates' coverage)."""
        return self._plan_ctx(
            self._full, host,
            cand_per_req=cand_per_req, drv_arr=drv_arr, exc_arr=exc_arr,
            counts=counts, num_zones=num_zones, top_k=top_k, slack=slack,
        )

    def plan_with_masks(
        self, host, *, dom_mask, cand_per_req, drv_arr, exc_arr, counts,
        num_zones, top_k, slack, dom_key=None,
    ) -> PrunePlan | None:
        """Plan for a window whose shared domain is a SUBSET of the
        cluster (instance-group pinned domains — the pooled partition
        path). The FIRST plan per domain pays one vectorized O(N) sweep
        to derive the domain's per-zone membership and totals (counted in
        `planner_sweep_rows`); the resulting context is cached under
        `dom_key` and every later window plans in O(K + changed) exactly
        like the full domain — including kept-set reuse, which keys the
        solver's per-partition statics-gather reuse. Reuse requires the
        SAME dom_mask object: a domain
        MEMBERSHIP change re-keys the mask and cold-starts the context."""
        ctx = self._dom_ctxs.get(dom_key) if dom_key is not None else None
        if ctx is not None and ctx.dom_mask is not dom_mask:
            dm = np.asarray(dom_mask, bool)
            if ctx.dom_mask.shape == dm.shape and np.array_equal(
                ctx.dom_mask, dm
            ):
                # A node event ELSEWHERE re-keyed the mask object without
                # changing this domain's content (an add/delete in another
                # instance group flips `valid` rows outside the domain):
                # adopt the new object and keep the context. One O(N)
                # compare per node event per domain — never per window.
                ctx.dom_mask = dm
            else:
                ctx = None  # membership changed: cold-start fresh
        if ctx is None:
            ctx = self._cold_dom_ctx(host, dom_mask, num_zones)
            if dom_key is not None:
                while len(self._dom_ctxs) >= self._MAX_DOM_CTXS:
                    # Evict the oldest-built context only — clearing the
                    # whole cache would cold-start every warm domain.
                    self._dom_ctxs.pop(next(iter(self._dom_ctxs)))
                self._dom_ctxs[dom_key] = ctx
        return self._plan_ctx(
            ctx, host,
            cand_per_req=cand_per_req, drv_arr=drv_arr, exc_arr=exc_arr,
            counts=counts, num_zones=num_zones, top_k=top_k, slack=slack,
        )

    def _cold_dom_ctx(self, host, dom_mask, num_zones) -> _DomCtx:
        """One vectorized sweep deriving a subset domain's per-zone
        membership counts and availability totals — the context's only
        O(N) moment (legacy `planner_sweep_rows` semantics)."""
        avail = np.asarray(host.available)
        zone_id = np.asarray(host.zone_id)
        valid = np.asarray(host.valid)
        n = avail.shape[0]
        self.stats["planner_sweep_rows"] += n
        ctx = _DomCtx(np.asarray(dom_mask, bool))
        live = ctx.dom_mask & valid
        lz = zone_id[live]
        ctx.zcnt = np.bincount(lz, minlength=num_zones).astype(np.int64)
        ctx.zone_mem = np.zeros(num_zones, np.int64)
        ctx.zone_cpu = np.zeros(num_zones, np.int64)
        np.add.at(ctx.zone_mem, lz, avail[live, MEM_DIM].astype(np.int64))
        np.add.at(ctx.zone_cpu, lz, avail[live, CPU_DIM].astype(np.int64))
        return ctx

    def _plan_ctx(
        self, ctx, host, *, cand_per_req, drv_arr, exc_arr, counts,
        num_zones, top_k, slack,
    ) -> PrunePlan | None:
        t0 = _time.perf_counter()
        avail = np.asarray(host.available)
        valid = np.asarray(host.valid)
        zid = np.asarray(host.zone_id)
        b = drv_arr.shape[0]
        min_dr = drv_arr.min(axis=0).astype(np.int64)
        min_er = exc_arr.min(axis=0).astype(np.int64)
        demand = int(counts.sum()) + b
        # Power-of-two bucketed K: keeps the per-zone cache (and the kept
        # row set) stable across window-demand jitter at the cost of at
        # most 2x extra kept rows.
        k = _bucket(max(int(top_k), int(np.ceil(demand * slack))), 1)
        full = ctx.dom_mask is None
        # Cache-key drift: a LOWER per-dim minimum demand or a LARGER K
        # widens the relevant-row sets, which the cached excluded
        # summaries cannot soundly describe — full re-scan.
        # COLD = building from nothing (first plan, or right after an
        # invalidate — invalidate() resets the cached minima). Everything
        # else (K/minima widening, churn-dropped entries) counts as rows
        # SCANNED, so the CI O(K) assertion sees every incremental sweep.
        cold = ctx.min_dr is None
        if cold or (
            k > ctx.k
            or (min_dr < ctx.min_dr).any()
            or (min_er < ctx.min_er).any()
        ):
            ctx.entries.clear()
            ctx.keep = None
            ctx.min_dr = min_dr
            ctx.min_er = min_er
            ctx.k = k
        counter = "planner_cold_rows" if cold else "planner_rows_scanned"
        unsched = np.asarray(host.unschedulable, bool)
        ready = np.asarray(host.ready, bool)
        name_rank = np.asarray(host.name_rank)
        zcnt = self.agg.cnt if full else ctx.zcnt
        zones = np.flatnonzero(zcnt > 0)
        changed = ctx.keep is None
        for z in zones:
            if int(z) not in ctx.entries:
                self._rescan_zone(
                    ctx, int(z), avail, valid, unsched, ready, name_rank,
                    counter,
                )
                changed = True
        dom_rows = int(zcnt.sum())
        if changed:
            keeps = [
                ctx.entries[int(z)].keep
                for z in zones
                if int(z) in ctx.entries
            ]
            keep_real = (
                np.sort(np.concatenate(keeps)).astype(np.int32)
                if keeps
                else np.empty(0, np.int32)
            )
            k_real = int(keep_real.shape[0])
            if k_real == 0 or k_real >= 0.7 * dom_rows:
                ctx.keep = None
                return None
            kp = _bucket(k_real, 64)
            keep_padded = np.full(kp, keep_real[0], np.int32)
            keep_padded[:k_real] = keep_real
            ctx.keep = keep_padded
            ctx.keep_real = k_real
        else:
            keep_padded = ctx.keep
            k_real = ctx.keep_real
            if k_real == 0 or k_real >= 0.7 * dom_rows:
                return None
            self.stats["plan_reuse"] += 1
        keep_real_v = keep_padded[:k_real]

        # Assemble the certificate's per-zone summary arrays from the
        # entries (Zb is small).
        zb = num_zones
        e_cnt_e = np.zeros(zb, np.int64)
        e_cnt_d = np.zeros(zb, np.int64)
        e_max_e = np.full((zb, avail.shape[1]), _I64_MIN, np.int64)
        e_max_d = np.full((zb, avail.shape[1]), _I64_MIN, np.int64)
        e_key_e = np.full((zb, 3), _I64_MAX, np.int64)
        e_key_d = np.full((zb, 3), _I64_MAX, np.int64)
        for z in zones:
            entry = ctx.entries.get(int(z))
            if entry is None:
                continue
            if entry.has_e:
                e_cnt_e[z] = 1
                e_max_e[z] = entry.max_e
                e_key_e[z] = entry.key_e
            if entry.has_d:
                e_cnt_d[z] = 1
                e_max_d[z] = entry.max_d
                e_key_d[z] = entry.key_d

        # Offsets: excluded sums = resident totals − Σ kept, O(K).
        t1 = _time.perf_counter()
        tot_mem = self.agg.mem if full else ctx.zone_mem
        tot_cpu = self.agg.cpu if full else ctx.zone_cpu
        kept_avail = avail[keep_real_v].astype(np.int64)
        kz = zid[keep_real_v]
        kept_mem = np.zeros(zb, np.int64)
        kept_cpu = np.zeros(zb, np.int64)
        np.add.at(kept_mem, kz, kept_avail[:, MEM_DIM])
        np.add.at(kept_cpu, kz, kept_avail[:, CPU_DIM])
        s_mem = tot_mem - kept_mem
        s_cpu = tot_cpu - kept_cpu
        present = zcnt > 0
        mem_hi, mem_lo = split_zone_sums(s_mem)
        cpu_hi, cpu_lo = split_zone_sums(s_cpu)
        t2 = _time.perf_counter()

        # Gather the per-request candidate masks onto the kept rows,
        # deduplicated by mask identity — serving requests overwhelmingly
        # share ONE candidate ticket, so the window pays one [K] gather
        # instead of B.
        gather_memo: dict[int, np.ndarray] = {}
        cand_kept = []
        for c in cand_per_req:
            g = gather_memo.get(id(c))
            if g is None:
                g = np.asarray(c)[keep_padded]
                gather_memo[id(c)] = g
            cand_kept.append(g)
        return PrunePlan(
            keep=keep_padded,
            k_real=k_real,
            dom_mask=valid if full else ctx.dom_mask,
            num_zones=zb,
            zone_base=(mem_hi, mem_lo, cpu_hi, cpu_lo, present),
            zone_mem=np.asarray(tot_mem).copy(),
            zone_cpu=np.asarray(tot_cpu).copy(),
            present=present,
            e_cnt_exec=e_cnt_e,
            e_max_exec=e_max_e,
            e_key_exec=e_key_e,
            e_cnt_drv=e_cnt_d,
            e_max_drv=e_max_d,
            e_key_drv=e_key_d,
            cand_kept=cand_kept,
            dom_rows=dom_rows,
            reused=not changed,
            plan_ms=(t2 - t0) * 1e3,
            offset_ms=(t2 - t1) * 1e3,
        )

    def _rescan_zone(
        self, ctx, z, avail, valid, unsched, ready, name_rank, counter,
    ) -> None:
        """Exact per-zone prefilter state from the zone's resident order:
        first K fitting rows per class, the first fitting row beyond them
        (the excluded lexmin by construction — the order IS sorted by the
        key), and the per-dim maxima over the rest. Subset domains filter
        the zone order through their membership mask and refresh their
        zone totals exactly in the same pass."""
        zo = self.index.zone_order(z)
        self.stats[counter] += int(zo.shape[0])
        self.stats["planner_zone_rescans"] += 1
        if ctx.dom_mask is None:
            rows = zo[valid[zo]]
        else:
            rows = zo[ctx.dom_mask[zo] & valid[zo]]
            # Re-derive this zone's domain totals exactly: after a churn
            # drop the delta-maintained values are still exact, but the
            # recompute is O(zone) and kills any possibility of drift.
            ctx.zcnt[z] = rows.size
            ctx.zone_mem[z] = int(avail[rows, MEM_DIM].astype(np.int64).sum())
            ctx.zone_cpu[z] = int(avail[rows, CPU_DIM].astype(np.int64).sum())
        k = ctx.k
        if not rows.size:
            ctx.entries[z] = _ZoneEntry(
                np.empty(0, np.int32), np.empty(0, np.int32),
                False, False,
                (_I64_MAX,) * 3, (_I64_MAX,) * 3,
                np.full(avail.shape[1], _I64_MIN, np.int64),
                np.full(avail.shape[1], _I64_MIN, np.int64),
            )
            return
        av = avail[rows]
        fit_d = (av >= ctx.min_dr).all(axis=1)
        fit_e = (
            (av >= ctx.min_er).all(axis=1)
            & ~unsched[rows]
            & ready[rows]
        )
        sel_e = np.flatnonzero(fit_e)
        sel_d = np.flatnonzero(fit_d)
        kept_e = rows[sel_e[:k]].astype(np.int32)
        kept_d = rows[sel_d[:k]].astype(np.int32)
        # Excluded = fitting rows beyond the UNION of both classes' kept
        # prefixes (a row kept for the exec class is kept, full stop —
        # the legacy sweep's excl semantics, which the exactness oracle
        # pins): the first such row in order is the class's lexmin key.
        un = np.zeros(rows.shape[0], bool)
        un[sel_e[:k]] = True
        un[sel_d[:k]] = True

        def _class(sel):
            rel = sel[~un[sel]]
            if rel.size:
                first = rows[rel[0]]
                key = (
                    int(avail[first, MEM_DIM]),
                    int(avail[first, CPU_DIM]),
                    int(name_rank[first]),
                )
                mx = av[rel].max(axis=0).astype(np.int64)
                return True, key, mx
            return (
                False, (_I64_MAX,) * 3,
                np.full(avail.shape[1], _I64_MIN, np.int64),
            )

        has_e, key_e, max_e = _class(sel_e)
        has_d, key_d, max_d = _class(sel_d)

        def _last_key(sel):
            if sel.size < k:
                return None  # every fitting row kept: new rows belong in
            last = rows[sel[k - 1]]
            return (
                int(avail[last, MEM_DIM]),
                int(avail[last, CPU_DIM]),
                int(name_rank[last]),
            )

        ctx.entries[z] = _ZoneEntry(
            kept_e, kept_d, has_e, has_d, key_e, key_d, max_e, max_d,
            last_key_e=_last_key(sel_e), last_key_d=_last_key(sel_d),
        )

    def index_stats(self) -> dict:
        return {
            "index": self.index.stats(),
            "aggregates": self.agg.stats(),
            "cached_zones": len(self._full.entries),
            "cached_domains": len(self._dom_ctxs),
        }


def certify_window(
    plan: PrunePlan,
    *,
    strategy: str,
    requests,  # the window's WindowRequests (row counts per segment)
    drivers: np.ndarray,  # [B] int64 GLOBAL node indices (-1 = none)
    admitted: np.ndarray,  # [B] bool
    packed: np.ndarray,  # [B] bool
    execs: np.ndarray,  # [B, Emax] int64 GLOBAL indices
    drv64: np.ndarray,  # [B, 3] int64 per-row driver request
    exc64: np.ndarray,  # [B, 3] int64 per-row executor request
    base_kept: np.ndarray,  # [k_real, 3] int64 — EXACT dispatch base on the
    #                     kept rows (host view minus in-flight priors'
    #                     placements); OWNED by the certificate (mutated)
    host,  # host ClusterTensors view at dispatch
    prior_rows: np.ndarray,  # rows any in-flight prior placed on (global)
    prior_deltas: np.ndarray,  # [len(prior_rows), 3] int64 — the priors'
    #                     summed placements on those rows
) -> tuple[bool, str | None]:
    """Replay the window's availability thread and certify that the pruned
    solve's decisions equal the full solve's. Returns (ok, reason) —
    reason names the first failed test (telemetry label).

    O(K + rows): every input is either per-kept-row or per-zone (the
    caller gathers `base_kept` on the kept rows; membership tests bisect
    the sorted keep)."""
    keep = plan.keep[: plan.k_real]  # sorted ascending

    # The device offsets assumed excluded rows kept their host-view
    # availability; a prior window's placement on an excluded row breaks
    # that (the plan was built before the prior's placements were known).
    # Rows outside the window domain are transparent to every choice
    # (masked from eligibility and zone sums alike), so only domain rows
    # are tested.
    in_dom = plan.dom_mask[prior_rows]
    prior_rows = prior_rows[in_dom]
    prior_deltas = prior_deltas[in_dom]
    if prior_rows.size:
        pp = np.clip(
            np.searchsorted(keep, prior_rows), 0, max(keep.size - 1, 0)
        )
        if keep.size == 0 or not bool(
            (keep[pp] == prior_rows).all()
        ):
            return False, "prior-placed-excluded"

    zone_id = np.asarray(host.zone_id)
    name_rank = np.asarray(host.name_rank)

    def to_local(g: np.ndarray) -> np.ndarray:
        """Global rows -> kept-local indices, -1 for non-kept."""
        p = np.searchsorted(keep, g)
        pc = np.clip(p, 0, keep.size - 1)
        return np.where(
            (g >= 0) & (keep[pc] == g), pc, -1
        ).astype(np.int64)

    # Hoisted once for the whole window: the per-row loop below only
    # indexes into these (the old [N] lut without the [N] allocation).
    drivers_local = to_local(drivers)
    execs_local = to_local(execs)

    k_zone = zone_id[keep]
    k_name = name_rank[keep].astype(np.int64)
    zs_mem = plan.zone_mem.copy()
    zs_cpu = plan.zone_cpu.copy()
    # Priors placed only on kept rows (verified above): fold their
    # placements out of the dispatch sums to reach the true base sums.
    # base == host view - priors, and plan sums were over the host view.
    if prior_rows.size:
        np.add.at(
            zs_mem, zone_id[prior_rows], -prior_deltas[:, MEM_DIM]
        )
        np.add.at(
            zs_cpu, zone_id[prior_rows], -prior_deltas[:, CPU_DIM]
        )

    # Per-row conservative excluded-fit tables, vectorized across the batch.
    fit_e_zb = (
        (plan.e_max_exec[None, :, :] >= exc64[:, None, :]).all(axis=2)
        & (plan.e_cnt_exec > 0)[None, :]
    )  # [B, Zb]
    fit_d_zb = (
        (plan.e_max_drv[None, :, :] >= drv64[:, None, :]).all(axis=2)
        & (plan.e_cnt_drv > 0)[None, :]
    )

    az = zone_ranks_host(zs_mem, zs_cpu, plan.present)
    az_dirty = False
    row = 0
    for req_i, req in enumerate(requests):
        nrows = len(req.rows)
        if az_dirty:
            az = zone_ranks_host(zs_mem, zs_cpu, plan.present)
            az_dirty = False
        # Segment-start keys: the kernel computes priority orders ONCE per
        # segment from the segment-start availability and reuses them while
        # only availability mutates (resource.go:299 semantics) — so every
        # key comparison below uses these, while fit/capacity tests use the
        # current in-segment availability.
        k_az = az[k_zone].astype(np.int64)
        k_mem = base_kept[:, MEM_DIM].copy()
        k_cpu = base_kept[:, CPU_DIM].copy()
        cand_k = plan.cand_kept[req_i][: plan.k_real]
        seg_kept = None  # lazy copy — only hypothetical commits mutate it
        for j in range(nrows):
            r = row + j
            cur = base_kept if seg_kept is None else seg_kept
            dr = drv64[r]
            er = exc64[r]
            any_e = bool(fit_e_zb[r].any())
            any_d = bool(fit_d_zb[r].any())
            if not packed[r]:
                # Denial: could an excluded row have cured it? Excluded
                # rows' availability is static during the window, so the
                # per-zone maxima are a sound (conservative) upper bound.
                if any_e or any_d:
                    return False, "denial-curable"
            elif admitted[r]:
                # Only admitted rows subtract availability, so only their
                # CHOICES must be pinned; a packed-but-blocked row's flags
                # are already implied identical by the preceding checks.
                if strategy == "minimal-fragmentation" and any_e:
                    # Consumption order is capacity DESC — any excluded
                    # capacity can reorder it regardless of priority rank.
                    return False, "minfrag-excluded-capacity"
                d = int(drivers[r])
                dl = int(drivers_local[r])
                sel = execs[r] >= 0
                ev = execs[r][sel]
                el = execs_local[r][sel]
                if d < 0 or dl < 0 or (ev.size and (el < 0).any()):
                    return False, "non-kept-choice"  # cannot happen; belt+braces
                key_d = (k_az[dl], k_mem[dl], k_cpu[dl], k_name[dl])
                # (a) Excluded driver candidate with a better key that fits.
                zsel = fit_d_zb[r]
                if zsel.any():
                    better = _lex_lt(
                        az[zsel].astype(np.int64),
                        plan.e_key_drv[zsel, 0],
                        plan.e_key_drv[zsel, 1],
                        plan.e_key_drv[zsel, 2],
                        *key_d,
                    )
                    if better.any():
                        return False, "driver-excluded-better"
                # (c) Feasibility flip: the pruned solve rejected every
                # better-ranked kept fitting candidate for capacity; with
                # excluded capacity in play the full solve might not have.
                if any_e:
                    fits_kept = (cur >= dr[None, :]).all(axis=1) & cand_k
                    if fits_kept.any():
                        better_kept = fits_kept & _lex_lt(
                            k_az, k_mem, k_cpu, k_name, *key_d
                        )
                        if better_kept.any():
                            return False, "driver-feasibility-flip"
                if ev.size:
                    # (b) Worst chosen executor row vs best excluded
                    # executor-capable row, by segment-start keys.
                    cu = np.unique(el)
                    worst = cu[
                        np.lexsort(
                            (k_name[cu], k_cpu[cu], k_mem[cu], k_az[cu])
                        )[-1]
                    ]
                    key_w = (
                        k_az[worst], k_mem[worst], k_cpu[worst], k_name[worst]
                    )
                    zsel = fit_e_zb[r]
                    if zsel.any():
                        better = _lex_lt(
                            az[zsel].astype(np.int64),
                            plan.e_key_exec[zsel, 0],
                            plan.e_key_exec[zsel, 1],
                            plan.e_key_exec[zsel, 2],
                            *key_w,
                        )
                        if better.any():
                            return False, "executor-excluded-better"
                    # (d) distribute-evenly revisits nodes round-robin: a
                    # second round would have visited excluded open rows
                    # before re-filling kept ones.
                    if (
                        strategy == "distribute-evenly"
                        and any_e
                        and ev.size > len(cu)
                    ):
                        return False, "distribute-multi-round"
                # Apply the row's placements to the thread.
                is_commit = j == nrows - 1
                if is_commit:
                    target = base_kept
                    if dl >= 0:
                        np.add.at(zs_mem, [k_zone[dl]], -int(dr[MEM_DIM]))
                        np.add.at(zs_cpu, [k_zone[dl]], -int(dr[CPU_DIM]))
                    if ev.size:
                        np.add.at(
                            zs_mem, k_zone[el], -int(er[MEM_DIM])
                        )
                        np.add.at(
                            zs_cpu, k_zone[el], -int(er[CPU_DIM])
                        )
                    az_dirty = True
                else:
                    if seg_kept is None:
                        seg_kept = base_kept.copy()
                    target = seg_kept
                target[dl] -= dr
                np.subtract.at(target, el, er[None, :])
        row += nrows
    return True, None
