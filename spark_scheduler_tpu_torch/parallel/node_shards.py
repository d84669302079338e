"""Node-sharded batched FIFO admission: one cluster's node axis split over S
shards, the port's counterpart of what GSPMD makes of
spark_scheduler_tpu/ops/batched.batched_fifo_pack under a ("nodes",) mesh
(JAX parallel/solve.py:92-117 `sharded_fifo_pack`).

The JAX package declares the sharding and lets XLA insert the collectives;
its node-sharded solve is an XLA scan, not a Pallas kernel (its own note,
parallel/solve.py:158-163), so its counterpart here is PyTorch. The
semantics are those of ops/batched.py `batched_fifo_pack` and
ops/packing.py `pack_one_app`, and one shard IS the unsharded engine
(ops/batched.py `batched_fifo_pack` calls this one with S = 1). The
decisions at any S equal those at S = 1, with one exception: a
single-AZ strategy adds its shards' float64 zone-score sums in another
order than one shard does, so a cross-zone tie within one float32 ulp of
the score may break differently.

Layout. Every [N, ...] field and every [B, N] mask is split into S
contiguous chunks of N / S nodes; chunk s lives on shard s's device. The
devices may repeat (parallel/mesh.py): each shard has a CUDA stream of its
own, so S shards on one card run their work side by side.

Per shard, on the shard's stream: the elementwise work (`node_capacities`,
`fits`, eligibility, the debit of an admitted gang).

Across shards, the reductions XLA turns into collectives. Each moves a
summary of bounded size to the lead shard (shard 0), never a row's [N]
tensors:
  - the executor total: one int64 from each shard;
  - the driver: each shard's best (driver rank, node) among its feasible
    nodes;
  - the executor fill: each shard's first min(emax, N/S) open nodes in the
    fill's own order, with their capacities, merged on the lead into the
    first emax of the whole cluster (`_Engine._fill` proves per fill that
    they decide it); minimal-fragmentation adds its whole-gang node
    (one candidate a shard) and a second small round for its last node;
  - the single-AZ zone scores: each shard's float64 term sums and its
    per-zone first-driver rank and executor presence.

Global sorts. `zone_ranks` and `priority_orders` gather their keys (the
availability and the eligibility masks; the static keys once a call) to
the lead shard and run there: the very functions the unsharded engine
calls, so ties, `zone_base` and the exact zone sums break alike. The
node ranks are scattered back to the shards. A sort runs once per queue,
once per window segment, or once per masked row, as the unsharded engine
sorts.

No host reads per row: host copies of the row flags steer the loop, and
shard streams wait on events, never on `synchronize()`. On CPU tensors the
shards live on `cpu` and the same cross-shard logic runs there.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from spark_scheduler_tpu_torch.models.cluster import (
    ClusterTensors,
    cluster_from_statics,
)
from spark_scheduler_tpu_torch.models.resources import INT32_INF
from spark_scheduler_tpu_torch.ops.batched import (
    _SINGLE_AZ_INNER,
    AppBatch,
    BatchedPacking,
    _device_zone_base,
    app_batch_to_device,
    queue_mode_orders,
)
from spark_scheduler_tpu_torch.ops.capacity import fits, node_capacities
from spark_scheduler_tpu_torch.ops.efficiency import zone_score_sum
from spark_scheduler_tpu_torch.ops.packing import (
    _FILLS,
    _check_cumsum_bound,
    single_az_orders,
)
from spark_scheduler_tpu_torch.ops.sorting import (
    _rank_of_position,
    priority_orders,
    zone_ranks,
)

_DEAD = torch.iinfo(torch.int64).max  # the key of a node that is no candidate
_SHIFT = 2**31  # (primary, rank) packed as primary * 2^31 + rank < 2^63


def _check_divisible(n: int, s: int) -> None:
    if n % s:
        raise ValueError(
            f'node count {n} not divisible by mesh "nodes" axis {s}; '
            "pad with invalid slots"
        )


def shard_fields(devices, fields) -> list:
    """Per shard s, the tuple of every node-axis (axis 0) field's chunk s,
    copied to devices[s]: the S contiguous chunks of the JAX
    `node_sharding` placement. Every chunking of the node axis in the
    port goes through here. N must divide by S."""
    devices = [torch.device(d) for d in devices]
    n, s = fields[0].shape[0], len(devices)
    _check_divisible(n, s)
    c = n // s
    return [
        tuple(f[k * c:(k + 1) * c].to(d) for f in fields)
        for k, d in enumerate(devices)
    ]


def shard_cluster(devices, cluster: ClusterTensors) -> list:
    """The cluster's S node chunks as ClusterTensors, chunk s on
    devices[s] (`shard_fields`)."""
    return [ClusterTensors(*t) for t in shard_fields(devices, cluster.fields())]


class NodeShards:
    """S node chunks on their devices, each with its stream, and the
    hand-offs between them and the lead shard. `xbytes` counts the bytes
    that cross shards: "rows", the per-row summaries (`bcast`, `gather`),
    and "keys", the sort keys, ranks and whole chunks (`scatter`, `cat`)."""

    def __init__(self, devices, n: int, streams=None):
        self.devices = [torch.device(d) for d in devices]
        self.s = len(self.devices)
        _check_divisible(n, self.s)
        types = {d.type for d in self.devices}
        if len(types) != 1 or not types <= {"cpu", "cuda"}:
            raise ValueError(
                f"shards run on cuda or cpu devices of one type, got "
                f"{[str(d) for d in self.devices]}"
            )
        self.cuda = types == {"cuda"}
        self.n, self.chunk = n, n // self.s
        self.lead = self.devices[0]
        if self.cuda:
            self.devices = [
                torch.device("cuda", torch.cuda.current_device())
                if d.index is None else d
                for d in self.devices
            ]
            self.lead = self.devices[0]
            self.streams = list(streams) if streams is not None else [
                torch.cuda.Stream(device=d) for d in self.devices
            ]
            self.lead_stream = torch.cuda.current_stream(self.lead)
        else:
            self.streams = [None] * self.s
            self.lead_stream = None
        self.offsets = [k * self.chunk for k in range(self.s)]
        self.gidx = [
            torch.arange(o, o + self.chunk, dtype=torch.int32, device=d)
            for o, d in zip(self.offsets, self.devices)
        ]
        self.xbytes = {"rows": 0, "keys": 0}
        self.ready()

    # -- streams ----------------------------------------------------------

    def ctx(self, k: int):
        """Shard k's stream as the current stream (a no-op on the CPU)."""
        if self.streams[k] is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.streams[k])

    def ready(self) -> None:
        """Queue every shard stream behind the work queued so far on its
        device's current stream (inputs placed by the caller)."""
        if self.cuda:
            for d, st in zip(self.devices, self.streams):
                st.wait_stream(torch.cuda.current_stream(d))

    def join(self) -> None:
        """Queue the current streams behind every shard's work."""
        if self.cuda:
            for d, st in zip(self.devices, self.streams):
                torch.cuda.current_stream(d).wait_stream(st)

    def _cross(self, t, src_stream, dst_stream, dst_device):
        if not self.cuda:
            return t.to(dst_device)
        if t.device == dst_device:
            t.record_stream(dst_stream)
            return t
        with torch.cuda.stream(src_stream), torch.cuda.stream(dst_stream):
            return t.to(dst_device)

    def bcast(self, *ts) -> list:
        """Lead-stream tensors to every shard: per shard, the tuple `ts`
        usable on its stream."""
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record(self.lead_stream)
        out = []
        for k in range(self.s):
            if self.cuda and self.devices[k] == self.lead:
                self.streams[k].wait_event(ev)
            out.append(tuple(
                self._cross(t, self.lead_stream, self.streams[k], self.devices[k])
                for t in ts
            ))
        if self.s > 1:
            self.xbytes["rows"] += (self.s - 1) * sum(
                t.numel() * t.element_size() for t in ts
            )
        return out

    def scatter(self, t, axis: int = -1) -> list:
        """A lead-stream [..., N] tensor's chunk s to shard s."""
        out = []
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record(self.lead_stream)
        for k in range(self.s):
            part = t.narrow(axis, self.offsets[k], self.chunk)
            if self.cuda and self.devices[k] == self.lead:
                self.streams[k].wait_event(ev)
            out.append(self._cross(
                part, self.lead_stream, self.streams[k], self.devices[k]
            ))
            if k:
                self.xbytes["keys"] += part.numel() * part.element_size()
        return out

    def gather(self, outs, kind: str = "rows") -> list:
        """Per shard, the tuple of tensors its stream just made, usable on
        the lead stream (which waits for each shard's work)."""
        landed = []
        for k, ts in enumerate(outs):
            if self.cuda and self.devices[k] == self.lead:
                ev = torch.cuda.Event()
                ev.record(self.streams[k])
                self.lead_stream.wait_event(ev)
            landed.append(tuple(
                self._cross(t, self.streams[k], self.lead_stream, self.lead)
                for t in ts
            ))
            if k:
                self.xbytes[kind] += sum(t.numel() * t.element_size() for t in ts)
        return landed

    def cat(self, parts, dim: int = 0) -> torch.Tensor:
        """Per-shard chunks (on the shards' streams) joined on the lead;
        one shard's chunk is itself (no copy)."""
        landed = [p for (p,) in self.gather([(p,) for p in parts], "keys")]
        return landed[0] if self.s == 1 else torch.cat(landed, dim)


def shard_apps(apps: AppBatch, sh: NodeShards) -> list:
    """Per shard, the app batch on its device: the row fields replicated,
    the [B, N] masks cut to the shard's chunk (the counterpart of JAX
    `shard_apps`). Placed on the current streams; `NodeShards.ready`
    orders the shard streams after it."""
    per_dev: dict = {}
    out = []
    for k, d in enumerate(sh.devices):
        if d not in per_dev:
            per_dev[d] = app_batch_to_device(apps, d)
        full = per_dev[d]
        lo, hi = sh.offsets[k], sh.offsets[k] + sh.chunk
        out.append(full._replace(
            driver_cand=None if full.driver_cand is None
            else full.driver_cand[:, lo:hi],
            domain=None if full.domain is None else full.domain[:, lo:hi],
        ))
    sh.ready()
    return out


class _Engine:
    """One call of `node_sharded_fifo_pack`: the shards' state and the
    cross-shard steps of one gang pack."""

    def __init__(self, sh: NodeShards, shards: list, emax: int, inner: str):
        self.sh = sh
        self.shards = shards
        self.emax = emax
        self.inner = inner

    def _each(self, fn, *per_shard):
        """fn(k, *args of shard k) on shard k's stream, for every shard."""
        out = []
        for k in range(self.sh.s):
            with self.sh.ctx(k):
                out.append(fn(k, *(a[k] for a in per_shard)))
        return out

    # -- one gang pack (ops/packing.py pack_one_app) ----------------------

    def pack(self, avail, exec_elig, driver_elig, d_rank, e_rank, rows, count):
        """`pack_one_app` over the shards. Per-shard lists in, lead tensors
        out: (driver_node 0-d i32, exec_nodes [emax] i32, ok 0-d bool).
        `rows[k]` = (driver_req, exec_req, count) on shard k."""
        sh = self.sh
        capc = [None] * sh.s

        def totals(k, av, el, row):
            dreq, ereq, cnt = row
            cap = torch.where(el, node_capacities(av, torch.zeros_like(av), ereq), 0)
            capc[k] = torch.minimum(cap, cnt)
            return (capc[k].sum(),)

        total = torch.stack(
            [t for (t,) in sh.gather(self._each(totals, avail, exec_elig, rows))]
        ).sum()

        def drivers(k, av, el, de, dr, row, tot):
            dreq, ereq, cnt = row
            (tot,) = tot
            cwd = torch.where(
                el, node_capacities(av, dreq[None, :].expand_as(av), ereq), 0
            )
            total_if = tot - capc[k] + torch.minimum(cwd, cnt)
            feasible = de & fits(av, dreq) & (total_if >= cnt)
            r = torch.where(feasible, dr, torch.full_like(dr, INT32_INF))
            i = torch.argmin(r)
            return (torch.stack([r[i].long(), sh.gidx[k][i].long()]),)

        best = torch.stack([t for (t,) in sh.gather(self._each(
            drivers, avail, exec_elig, driver_elig, d_rank, rows,
            sh.bcast(total),
        ))])
        k_best = torch.argmin(best[:, 0])
        found = best[k_best, 0] < INT32_INF
        driver_node = torch.where(found, best[k_best, 1], -1).to(torch.int32)

        exec_nodes, fill_ok = self._fill(
            avail, exec_elig, e_rank, rows, sh.bcast(driver_node), count
        )
        return driver_node, exec_nodes, found & fill_ok

    def _fill(self, avail, exec_elig, e_rank, rows, drv, count):
        """The executor fill with the driver reserved, from each shard's
        first min(emax, N/S) open nodes (capacity > 0) in the fill's order,
        merged on the lead into the first emax of the cluster.

        Why emax candidates decide the fill: the gang's `count` is clamped
        to emax, and every open node holds at least one executor.
          - tightly-pack: slot j lands on the first node, in executor rank
            order, whose running capacity exceeds j; closed nodes never
            raise the running sum, so slots 0..count-1 land on the first
            `count` open nodes at most. Feasibility `sum(min(cap, count))
            >= count` is exact when the candidates are every open node, and
            true on both sides when there are emax of them or more.
          - distribute-evenly: round 0 visits every open node in rank
            order. With `count` or more open nodes every slot lands in round
            0, on the first `count` of them; with fewer, the candidates are
            every open node and the round sizes M[r] = #{cap > r} are exact.
          - minimal-fragmentation: branch B consumes nodes in (cap desc,
            rank asc) order while the running total stays <= count: a
            prefix of at most `count` open nodes, so the first emax in that
            order hold it, with its total and remainder. Branch A (the
            smallest (cap, rank) node holding the whole gang) and the last
            node (the smallest (cap, rank) unconsumed node holding the
            remainder) are not bounded this way: each shard sends its own
            best for A with the candidates, and for the last node a second
            round sends the remainder and the consumed nodes (at most emax)
            back to the shards, each of which answers with its best."""
        sh, emax = self.sh, self.emax
        k_top = min(emax, sh.chunk)
        caps_of = [None] * sh.s
        mf = self.inner == "minimal-fragmentation"

        def candidates(k, av, el, er, row, d):
            dreq, ereq, cnt = row
            (d,) = d
            one_hot = (sh.gidx[k] == d)[:, None]
            reserved = torch.where(one_hot, dreq[None, :], 0).to(av.dtype)
            caps = torch.where(el, node_capacities(av, reserved, ereq), 0)
            caps_of[k] = caps
            rank = er.long()
            open_ = caps > 0
            if mf:
                capc = torch.minimum(caps, cnt)
                key = torch.where(
                    open_, (emax - capc.long()) * _SHIFT + rank, _DEAD
                )
                val = capc
            else:
                key = torch.where(open_, rank, _DEAD)
                val = caps
            keys, idx = torch.topk(key, k_top, largest=False, sorted=True)
            out = [torch.stack([keys, sh.gidx[k][idx].long(), val[idx].long()])]
            if mf:
                # Branch A's candidate: the smallest (cap, rank) node that
                # holds the whole gang.
                a = torch.where(
                    open_ & (caps >= cnt), caps.long() * _SHIFT + rank, _DEAD
                )
                i = torch.argmin(a)
                out.append(torch.stack([a[i], sh.gidx[k][i].long()]))
            return tuple(out)

        landed = sh.gather(self._each(
            candidates, avail, exec_elig, e_rank, rows, drv
        ))
        cand = torch.cat([t[0] for t in landed], dim=1)  # [3, S*k_top]
        order = torch.sort(cand[0], stable=True).indices[:emax]
        cand = cand[:, order]
        if cand.shape[1] < emax:
            pad = torch.tensor(
                [[_DEAD], [0], [0]], dtype=torch.int64, device=cand.device
            ).expand(3, emax - cand.shape[1])
            cand = torch.cat([cand, pad], dim=1)
        live = cand[0] != _DEAD
        caps_list = torch.where(live, cand[2], 0).to(torch.int32)
        nodes_list = torch.where(live, cand[1], 0).to(torch.int32)
        if not mf:
            return _FILLS[self.inner](caps_list, nodes_list, count, emax)

        # minimal-fragmentation: the consumed prefix of (cap desc, rank
        # asc), branch A across shards, and the last node's second round.
        a = torch.stack([t[1] for t in landed])  # [S, 2]
        k_a = torch.argmin(a[:, 0])
        exists_a = a[k_a, 0] != _DEAD
        node_a = a[k_a, 1].to(torch.int32)
        cum = torch.cumsum(caps_list, 0, dtype=torch.int32)
        consumed = cum <= count
        total = torch.where(consumed, caps_list, 0).sum()
        remainder = (count - total).to(torch.int32)
        used = torch.where(consumed & live, cand[1], -1).to(torch.int32)
        ok = caps_list.sum() >= count

        def last_node(k, msg):
            rem, used_nodes = msg
            caps = caps_of[k]
            rank = e_rank[k].long()
            free = ~torch.isin(sh.gidx[k], used_nodes)
            f = torch.where(
                (caps > 0) & free & (caps >= rem), caps.long() * _SHIFT + rank,
                _DEAD,
            )
            i = torch.argmin(f)
            return (torch.stack([f[i], sh.gidx[k][i].long()]),)

        fin = torch.stack([t for (t,) in sh.gather(self._each(
            last_node, sh.bcast(remainder, used)
        ))])
        node_f = fin[torch.argmin(fin[:, 0]), 1].to(torch.int32)
        j = torch.arange(emax, dtype=torch.int32, device=cand.device)
        idx = torch.clamp(torch.searchsorted(cum, j, right=True), 0, emax - 1)
        node_b = torch.where(j < total, nodes_list[idx], node_f)
        chosen = torch.where(exists_a, node_a, node_b)
        return torch.where(j < count, chosen, -1).to(torch.int32), ok

    # -- the single-AZ wrappers (ops/packing.py pack_one_app_single_az) ---

    def pack_single_az(self, avail, orders, driver_elig, exec_elig, rows,
                       count, num_zones, include_exec):
        """`pack_one_app_single_az` over the shards: the pack in every
        zone, then the zone scores from the shards' float64 term sums."""
        sh = self.sh
        d_rank, _e_rank, d_elig_z, e_elig_z, d_rank_z, e_rank_z = orders
        drivers, execs, oks = [], [], []
        for z in range(num_zones):
            drv, ex, ok = self.pack(
                avail, [e[z] for e in e_elig_z], [e[z] for e in d_elig_z],
                [r[z] for r in d_rank_z], [r[z] for r in e_rank_z], rows, count,
            )
            drivers.append(drv)
            execs.append(ex)
            oks.append(ok)
        drivers = torch.stack(drivers)
        execs = torch.stack(execs)
        oks = torch.stack(oks)

        def zone_terms(k, av, de, ee, dr, row, msg):
            dreq, ereq, _cnt = row
            drv_z, exec_z = msg
            c = self.shards[k]
            zone = c.zone_id.long()
            inf = torch.full((num_zones,), INT32_INF, dtype=torch.int32,
                             device=av.device)
            first = inf.scatter_reduce(
                0, zone,
                torch.where(de, dr, INT32_INF).to(torch.int32), reduce="amin",
            )
            has_exec = torch.zeros(
                num_zones, dtype=torch.int32, device=av.device
            ).scatter_reduce(0, zone, ee.to(torch.int32), reduce="amax")
            sums = []
            for z in range(num_zones):
                is_drv = (sh.gidx[k] == drv_z[z]).to(torch.int32)
                local = exec_z[z] - sh.offsets[k]
                here = (exec_z[z] >= 0) & (local >= 0) & (local < sh.chunk)
                placed = torch.zeros(sh.chunk, dtype=torch.int32, device=av.device)
                placed.index_add_(
                    0, torch.clamp(local, 0, sh.chunk - 1).long(),
                    here.to(torch.int32),
                )
                sums.append(zone_score_sum(
                    is_drv, placed, c.schedulable, av, dreq, ereq, include_exec,
                ))
            return first, has_exec, torch.stack(sums)

        landed = sh.gather(self._each(
            zone_terms, avail, driver_elig, exec_elig, d_rank, rows,
            sh.bcast(drivers, execs),
        ))
        zone_first = torch.stack([t[0] for t in landed]).amin(0)
        zone_has_exec = torch.stack([t[1] for t in landed]).amax(0) > 0
        total = torch.stack([t[2] for t in landed]).sum(0).to(torch.float32)
        effs = total / (count + 1).to(torch.float32)
        inf = torch.full((num_zones,), INT32_INF, dtype=torch.int32,
                         device=effs.device)
        valid_zone = oks & (zone_first < INT32_INF) & zone_has_exec
        effs = torch.where(valid_zone, effs, -torch.inf)
        best_eff = effs.max()
        any_valid = valid_zone.any() & (best_eff > 0.0)
        tie = valid_zone & (effs == best_eff)
        best_zone = torch.argmin(torch.where(tie, zone_first, inf))
        driver_node = torch.where(any_valid, drivers[best_zone], -1)
        exec_nodes = torch.where(any_valid, execs[best_zone], -1)
        return driver_node.to(torch.int32), exec_nodes.to(torch.int32), any_valid

    # -- the debit of an admitted gang ------------------------------------

    def debit(self, avail, base, rows, msg, commit):
        """Subtract the admitted gang from every shard's availability (and
        from the committed base on a committing window row)."""
        sh = self.sh

        def one(k, av, bs, row, m, cm):
            dreq, ereq, _cnt = row
            drv, ex, adm = m
            local = ex - sh.offsets[k]
            here = (ex >= 0) & (local >= 0) & (local < sh.chunk)
            counts = torch.zeros(sh.chunk, dtype=torch.int32, device=av.device)
            counts.index_add_(
                0, torch.clamp(local, 0, sh.chunk - 1).long(),
                here.to(torch.int32),
            )
            delta = counts[:, None] * ereq[None, :] + torch.where(
                (sh.gidx[k] == drv)[:, None], dreq[None, :], 0
            ).to(torch.int32)
            av2 = torch.where(adm, av - delta, av)
            if bs is not None:
                bs = torch.where(adm & cm, bs - delta, bs)
            return av2, bs

        out = self._each(one, avail, base, rows, msg, commit)
        return [o[0] for o in out], [o[1] for o in out]


def node_sharded_fifo_pack(
    shards: list,
    apps: AppBatch,
    *,
    fill: str = "tightly-pack",
    emax: int,
    num_zones: int,
    zone_base: tuple | None = None,
    streams=None,
    stats: dict | None = None,
) -> BatchedPacking:
    """`batched_fifo_pack` over a node-sharded cluster: `shards` are the S
    per-shard ClusterTensors of `shard_cluster` (chunk s on its device),
    `apps` any AppBatch (numpy or tensors). Queue, masked and window mode,
    all six strategies, `zone_base` for the plain fills, exactly as the
    unsharded engine. The outputs, `available_after` included, land on
    the lead shard's device (shard 0); the inputs are left as they were.
    `streams` (one a shard) reuses a caller's streams; `stats["xbytes"]`
    and `stats["xbytes_keys"]` gain the bytes that crossed shards in the
    per-row summaries and in the sort keys and chunks (`NodeShards`).

    Window mode's first valid row must be a reset row (every window batch
    starts a segment there; the unsharded engine would pack it against
    placeholder orders)."""
    single_az = fill in _SINGLE_AZ_INNER
    if zone_base is not None and single_az:
        raise ValueError(
            "zone_base offsets are only sound for plain fills; "
            f"got single-AZ strategy {fill!r}"
        )
    inner = _SINGLE_AZ_INNER.get(fill, fill)
    if inner not in _FILLS:
        raise ValueError(f"unknown strategy {fill!r}")
    az_fallback = fill == "az-aware-tightly-pack"
    include_exec = inner != "minimal-fragmentation"
    if (apps.commit is None) != (apps.reset is None):
        raise ValueError("window mode requires commit AND reset together")
    devices = [c.device for c in shards]
    n = sum(c.num_nodes for c in shards)
    _check_cumsum_bound(n, emax)
    sh = NodeShards(devices, n, streams=streams)
    if any(c.num_nodes != sh.chunk for c in shards):
        raise ValueError("node shards must be equal contiguous chunks")
    lead = sh.lead
    apps_lead = app_batch_to_device(apps, lead)
    per_apps = shard_apps(apps_lead, sh)
    zone_base = _device_zone_base(zone_base, lead)
    b = apps_lead.driver_req.shape[0]
    segmented = apps.commit is not None
    masked = segmented or apps.driver_cand is not None or apps.domain is not None
    eng = _Engine(sh, shards, emax, inner)
    # The static sort keys, gathered to the lead once a call.
    statics = tuple(
        sh.cat([c.fields()[f] for c in shards]) for f in range(1, 9)
    )

    def lead_cluster(avail):
        return cluster_from_statics(avail, statics)

    def scatter_orders(d_order, e_order, extra):
        d_rank = _rank_of_position(d_order)
        e_rank = _rank_of_position(e_order)
        out = (sh.scatter(d_rank), sh.scatter(e_rank))
        if single_az:
            d_elig_z, e_elig_z, _, d_rank_z, e_order_z = extra
            e_rank_z = torch.stack([_rank_of_position(o) for o in e_order_z])
            out = out + (
                sh.scatter(d_elig_z), sh.scatter(e_elig_z),
                sh.scatter(d_rank_z), sh.scatter(e_rank_z),
            )
        return out

    def fresh_orders(avail, driver_elig, exec_elig, domain):
        """The sort at resource.go:299, on the lead over gathered keys."""
        av = sh.cat(avail)
        de, ee, dom = sh.cat(driver_elig), sh.cat(exec_elig), sh.cat(domain)
        cl = lead_cluster(av)
        zrank = zone_ranks(cl, dom, num_zones, available=av, zone_base=zone_base)
        d_order, e_order = priority_orders(cl, de, ee, zrank, available=av)
        extra = (
            single_az_orders(cl, de, ee, zrank, num_zones, available=av)
            if single_az else None
        )
        return scatter_orders(d_order, e_order, extra)

    avail = [c.available for c in shards]
    base = list(avail) if segmented else [None] * sh.s
    orders = None
    if not masked:
        cl = lead_cluster(sh.cat(avail))
        driver_elig_l, exec_elig_l, d_order, _, e_order, zrank = (
            queue_mode_orders(cl, num_zones)
        )
        extra = (
            single_az_orders(cl, driver_elig_l, exec_elig_l, zrank, num_zones)
            if single_az else None
        )
        orders = scatter_orders(d_order, e_order, extra)
        exec_elig = eng._each(lambda k, c: c.valid & ~c.unschedulable & c.ready,
                              shards)
        driver_elig = exec_elig

    # Host copies of the row flags steer the loop; no device value is read.
    valid_h = apps_lead.app_valid.cpu().numpy()
    reset_h = apps_lead.reset.cpu().numpy() if segmented else None
    if segmented:
        first_valid = np.flatnonzero(valid_h)
        if first_valid.size and not reset_h[: first_valid[0] + 1].any():
            raise ValueError(
                "window mode: the first valid row must start a segment "
                "(reset)"
            )
    blocked = torch.zeros((), dtype=torch.bool, device=lead)
    none_placed = torch.full((emax,), -1, dtype=torch.int32, device=lead)
    minus_one = torch.full((), -1, dtype=torch.int32, device=lead)
    false = torch.zeros((), dtype=torch.bool, device=lead)
    out_driver, out_execs, out_admitted, out_packed = [], [], [], []
    for i in range(b):
        if segmented and reset_h[i]:
            avail = list(base)
            blocked = false
        if masked:
            def masks(k, c, a, i=i):
                cand = a.driver_cand[i] if a.driver_cand is not None else None
                dom = a.domain[i] if a.domain is not None else None
                domain = c.valid if dom is None else dom & c.valid
                de = domain if cand is None else domain & cand
                ee = domain & ~c.unschedulable & c.ready
                return de, ee, domain

            m = eng._each(masks, shards, per_apps)
            driver_elig = [x[0] for x in m]
            exec_elig = [x[1] for x in m]
            if (not segmented and valid_h[i]) or (segmented and reset_h[i]):
                orders = fresh_orders(
                    avail, driver_elig, exec_elig, [x[2] for x in m]
                )
        if not valid_h[i]:
            # Padding: packs nothing, debits nothing, blocks nothing.
            out_driver.append(minus_one)
            out_execs.append(none_placed)
            out_admitted.append(false)
            out_packed.append(false)
            continue
        too_big = apps_lead.exec_count[i] > emax
        count = torch.clamp(apps_lead.exec_count[i], max=emax)
        rows = eng._each(
            lambda k, a, i=i: (
                a.driver_req[i], a.exec_req[i],
                torch.clamp(a.exec_count[i], max=emax),
            ),
            per_apps,
        )
        d_rank, e_rank = orders[:2]
        if single_az:
            driver_node, exec_nodes, ok = eng.pack_single_az(
                avail, orders, driver_elig, exec_elig, rows, count, num_zones,
                include_exec,
            )
            if az_fallback:
                # az-aware: plain tightly-pack when no single zone fits.
                p_driver, p_execs, p_ok = eng.pack(
                    avail, exec_elig, driver_elig, d_rank, e_rank, rows, count
                )
                driver_node = torch.where(ok, driver_node, p_driver)
                exec_nodes = torch.where(ok, exec_nodes, p_execs)
                ok = ok | p_ok
        else:
            driver_node, exec_nodes, ok = eng.pack(
                avail, exec_elig, driver_elig, d_rank, e_rank, rows, count
            )
        packed = ok & ~too_big
        admitted = packed & ~blocked
        avail, base = eng.debit(
            avail, base, rows, sh.bcast(driver_node, exec_nodes, admitted),
            [a.commit[i] if segmented else None for a in per_apps],
        )
        blocked = blocked | (~packed & ~apps_lead.skippable[i])
        out_driver.append(torch.where(admitted, driver_node, -1).to(torch.int32))
        out_execs.append(torch.where(admitted, exec_nodes, -1).to(torch.int32))
        out_admitted.append(admitted)
        out_packed.append(packed)
    after = sh.cat(base if segmented else avail)
    if after is shards[0].available:
        after = after.clone()  # one shard and nothing debited
    sh.join()
    if stats is not None:
        stats["xbytes"] = stats.get("xbytes", 0) + sh.xbytes["rows"]
        stats["xbytes_keys"] = stats.get("xbytes_keys", 0) + sh.xbytes["keys"]
    if not b:
        return BatchedPacking(
            driver_node=torch.zeros(0, dtype=torch.int32, device=lead),
            executor_nodes=torch.zeros((0, emax), dtype=torch.int32, device=lead),
            admitted=torch.zeros(0, dtype=torch.bool, device=lead),
            packed=torch.zeros(0, dtype=torch.bool, device=lead),
            available_after=after,
        )
    return BatchedPacking(
        driver_node=torch.stack(out_driver),
        executor_nodes=torch.stack(out_execs),
        admitted=torch.stack(out_admitted),
        packed=torch.stack(out_packed),
        available_after=after,
    )
