"""The pruned two-tier solve in the port against the JAX package, on the CPU.

`solver.prune-top-k` (core/prune.py, core/zone_aggregates.py and the
solver's `_dispatch_pruned` / `_fetch_pruned`): the planner gathers a
window's top-K rows per zone, the row walk solves that sub-cluster with the
excluded rows' zone sums as offsets (`window_pack(..., zone_base=...)`),
and a certificate either accepts the decisions or re-solves the dispatch
in full. The scenarios of tests/test_prune_equivalence.py that need no
device pool, each run through the JAX solver
(`PlacementSolver(use_native=False, ...)`) and the port's
(`device="cpu"`), with an unpruned port solver beside them:

  - pruned == unpruned == the JAX package's pruned decisions across usage
    churn and FIFO prefixes for every plain fill, and under fused K in
    {1, 4}; `prune_stats` (windows, kept rows, escalations and their
    reasons) equal the JAX solver's;
  - a tight K escalates and still matches; minimal-fragmentation
    escalates on excluded capacity; an unconfigured solver never prunes;
  - the host pieces (`zone_ranks_host`, `split_zone_sums`,
    `certify_window`, `PrunePlanner.plan_full_domain`) equal the JAX
    functions on random clusters with ties, negative availability and
    absent zones;
  - `window_pack_reference(..., zone_base=...)` on a gathered sub-cluster
    ranks its zones as the full cluster does, and decides as the full
    cluster does when the left-out rows can take nothing;
  - the planner fed the exact changed rows plans as one that re-scans
    every window;
  - the surfaces: `/debug/state`'s prune block, the
    `foundry.spark.scheduler.solver.prune.*` series, and `/predicates`
    bodies byte-identical to the JAX server's with `prune-top-k` on.

Seeds are fixed numbers (never `hash(...)`, which is salted per process).
Tolerance: none.
"""

from __future__ import annotations

import importlib
import json

import numpy as np
import pytest
import torch

from tests.test_torch_server import (
    JAX,
    PORT,
    Served,
    k8s_node,
    k8s_spark_pod,
    same,
)

PLAIN = ("tightly-pack", "distribute-evenly", "minimal-fragmentation")
STAT_KEYS = ("windows", "kept_rows", "escalations", "reasons")


def _mod(root, name):
    return importlib.import_module(f"{root}.{name}")


def _solver(root, **kw):
    cls = _mod(root, "core.solver").PlacementSolver
    return cls(use_native=False, **kw) if root == JAX else cls(device="cpu", **kw)


def _nodes(root, n, zones=2):
    kube = _mod(root, "models.kube")
    res = _mod(root, "models.resources").Resources
    return [
        kube.Node(
            name=f"n{i:03d}",
            allocatable=res.from_quantities("8", "8Gi", "1", round_up=False),
            labels={kube.ZONE_LABEL: f"z{i % zones}"},
        )
        for i in range(n)
    ]


def _random_windows(root, rng, nodes, k, per, *, domains=None, fifo_rows=True):
    """tests/test_prune_equivalence.py `_random_windows`, per package."""
    res = _mod(root, "models.resources").Resources
    request = _mod(root, "core.solver").WindowRequest
    one = res.from_quantities("1", "1Gi")
    two = res.from_quantities("2", "2Gi")
    names = [n.name for n in nodes]
    windows = []
    for w in range(k):
        reqs = []
        for _ in range(per):
            rows = []
            if fifo_rows:
                for _ in range(int(rng.integers(0, 3))):
                    rows.append((one, one, int(rng.integers(1, 3)),
                                 bool(rng.random() < 0.5)))
            drv = two if rng.random() < 0.3 else one
            rows.append((drv, one, int(rng.integers(1, 4)), False))
            if domains is not None:
                # One shared domain a window, alternating across windows.
                dom = cand = domains[w % len(domains)]
            else:
                dom, cand = None, names
            reqs.append(request(rows=rows, driver_candidate_names=cand,
                                domain_node_names=dom))
        windows.append(reqs)
    return windows


def _random_usage(root, rng, nodes):
    res = _mod(root, "models.resources").Resources
    return {
        n.name: res.from_quantities(str(int(rng.integers(1, 4))), "1Gi")
        for n in nodes
        if rng.random() < 0.3
    }


def _run(solver, nodes, batches, usages, strategy):
    """Pipelined serving order: every window of a batch dispatched back to
    back, then all fetched; churn lands between batches."""
    out = []
    for usage, wins in zip(usages, batches):
        handles = []
        for w in wins:
            t = solver.build_tensors_pipelined(nodes, usage, {})
            handles.append(solver.pack_window_dispatch(strategy, t, w))
        for h in handles:
            out.extend(solver.pack_window_fetch(h))
    return out


def _run_fused(solver, nodes, batches, usages, strategy):
    out = []
    for usage, wins in zip(usages, batches):
        t = solver.build_tensors_pipelined(nodes, usage, {})
        for v in solver.pack_windows_dispatch(strategy, t, wins):
            out.extend(solver.pack_window_fetch(v))
    return out


def _scenario(root, seed, *, n_nodes, zones, k, per, n_batches, fifo_rows=True,
              domains=None):
    """(nodes, batches, usages) of one package from one seed."""
    rng = np.random.default_rng(seed)
    nodes = _nodes(root, n_nodes, zones)
    doms = None
    if domains is not None:
        names = [n.name for n in nodes]
        doms = [names[lo:hi] for lo, hi in domains]
    batches = [
        _random_windows(root, rng, nodes, k, per, domains=doms,
                        fifo_rows=fifo_rows)
        for _ in range(n_batches)
    ]
    usages = [{}] + [_random_usage(root, rng, nodes) for _ in range(n_batches - 1)]
    return nodes, batches, usages


def _three_way(seed, strategy, *, runner=_run, top_k, slack, **shape):
    """Decisions and prune_stats of the JAX pruned solver, the port's
    pruned solver and the port's unpruned solver on the same scenario."""
    out = {}
    for name, root, kw in (
        ("jax", JAX, dict(prune_top_k=top_k, prune_slack=slack)),
        ("port", PORT, dict(prune_top_k=top_k, prune_slack=slack)),
        ("full", PORT, dict(prune_top_k=0)),
    ):
        solver = _solver(root, **kw)
        decisions = runner(solver, *_scenario(root, seed, **shape), strategy)
        out[name] = ([tuple(d) for d in decisions], solver)
    return out


def _assert_same(out):
    jax_d, jax_solver = out["jax"]
    port_d, port_solver = out["port"]
    full_d, _ = out["full"]
    assert len(port_d) == len(full_d) == len(jax_d)
    for i, (a, b) in enumerate(zip(port_d, full_d)):
        assert a == b, f"decision {i}: pruned {a} vs unpruned {b}"
    assert port_d == jax_d
    want = {k: jax_solver.prune_stats[k] for k in STAT_KEYS}
    got = {k: port_solver.prune_stats[k] for k in STAT_KEYS}
    assert got == want
    assert got["windows"] > 0, port_solver.window_path_counts
    return port_solver.prune_stats


@pytest.mark.parametrize("strategy,seed", list(zip(PLAIN, (401, 402, 403))))
def test_pruned_matches_unpruned_and_jax_with_churn(strategy, seed):
    _assert_same(_three_way(
        seed, strategy, top_k=4, slack=0.75,
        n_nodes=96, zones=2, k=2, per=3, n_batches=3,
    ))


@pytest.mark.parametrize("k", [1, 4])
def test_pruned_matches_unpruned_and_jax_fused(k):
    """The fused umbrella prunes as one batch; its views slice it."""
    _assert_same(_three_way(
        40 + k, "tightly-pack", runner=_run_fused, top_k=4, slack=0.3,
        n_nodes=192, zones=2, k=k, per=2, n_batches=2,
    ))


def test_pruned_shared_named_domain_matches_jax():
    """One named domain per window (half the cluster, alternating across
    windows): the planner's subset-domain contexts."""
    _assert_same(_three_way(
        61, "tightly-pack", top_k=4, slack=0.3,
        n_nodes=96, zones=2, k=2, per=2, n_batches=2,
        domains=[(0, 48), (48, 96)],
    ))


def test_tight_k_escalates_and_still_matches():
    """K too small for the workload: the certificate fires, and every
    escalated window (re-solved in full, with the windows dispatched on
    its carry) still equals the unpruned solve."""
    st = _assert_same(_three_way(
        9, "tightly-pack", top_k=1, slack=0.01,
        n_nodes=128, zones=3, k=2, per=4, n_batches=3,
    ))
    assert st["escalations"] > 0 and st["reasons"], st


def test_minimal_fragmentation_escalates_on_excluded_capacity():
    st = _assert_same(_three_way(
        11, "minimal-fragmentation", top_k=2, slack=0.25,
        n_nodes=96, zones=2, k=2, per=2, n_batches=1,
    ))
    assert st["reasons"].get("minfrag-excluded-capacity", 0) >= 1, st


def test_unconfigured_solver_never_prunes():
    solver = _solver(PORT)
    nodes, batches, usages = _scenario(
        PORT, 3, n_nodes=96, zones=2, k=2, per=2, n_batches=1
    )
    _run(solver, nodes, batches, usages, "tightly-pack")
    assert solver.prune_stats["windows"] == 0
    assert solver._planner is None
    assert solver.window_path_counts == {"reference": 2}


def test_pruned_handles_carry_plan_and_debit_per_window():
    """A pruned dispatch keeps its plan and kept-row base; its placements
    are recorded per window in registry rows, on kept rows only."""
    solver = _solver(PORT, prune_top_k=4, prune_slack=0.3)
    nodes, batches, usages = _scenario(
        PORT, 5, n_nodes=96, zones=2, k=2, per=2, n_batches=1, fifo_rows=False
    )
    t = solver.build_tensors_pipelined(nodes, usages[0], {})
    views = solver.pack_windows_dispatch("tightly-pack", t, batches[0])
    owner = views[0].owner
    assert owner.prune is not None and owner.info["pruned"]
    assert owner.base_kept.shape == (owner.prune.k_real, 3)
    for v in views:
        solver.pack_window_fetch(v)
    keep = owner.prune.keep[: owner.prune.k_real]
    assert len(owner.window_placements) == 2
    for rows, amounts in owner.window_placements:
        assert np.isin(rows, keep).all()
        assert amounts.shape == (len(rows), 3)
    assert solver.window_path_counts == {"reference-pruned": 1}


def _dispatch_after_escalation(root, top_k, slack):
    """Windows A and B dispatched back to back; A fetched (a tight K
    escalates it) and its gangs committed; then C built and dispatched
    before B is fetched, as the predicate batcher does. A build that
    raises PipelineDrainRequired is answered as the batcher answers it:
    fetch B first, then build again. Returns (decisions, drains, nodes
    over-committed)."""
    solver_mod = _mod(root, "core.solver")
    res = _mod(root, "models.resources").Resources
    solver = _solver(root, prune_top_k=top_k, prune_slack=slack)
    nodes, batches, _ = _scenario(root, 0, n_nodes=48, zones=3, k=3, per=4,
                                  n_batches=1)
    (wa, wb, wc), usage = batches[0], {}

    def build():
        return solver.build_tensors_pipelined(nodes, usage, {})

    def fetch(h, w):
        got = solver.pack_window_fetch(h)
        for req, d in zip(w, got):
            if d.admitted:
                drv, exe = req.rows[-1][0], req.rows[-1][1]
                names = [d.packing.driver_node] + list(d.packing.executor_nodes)
                for i, name in enumerate(names):
                    usage[name] = usage.get(name, res.zero()).add(drv if i == 0 else exe)
        return got

    ha = solver.pack_window_dispatch("tightly-pack", build(), wa)
    hb = solver.pack_window_dispatch("tightly-pack", build(), wb)
    out = fetch(ha, wa)
    drains = 0
    try:
        t = build()
    except solver_mod.PipelineDrainRequired:
        drains += 1
        out += fetch(hb, wb)
        hb = None
        t = build()
    hc = solver.pack_window_dispatch("tightly-pack", t, wc)
    if hb is not None:
        out += fetch(hb, wb)
    out += fetch(hc, wc)
    over = [n.name for n in nodes
            if usage.get(n.name, res.zero()).cpu_milli > n.allocatable.cpu_milli]
    if top_k:
        assert solver.prune_stats["escalations"] > 0
    return [tuple(d) for d in out], drains, over


def test_dispatch_after_an_escalation_drains_first():
    """After an escalation dropped the carry, a build waits (raises
    PipelineDrainRequired) until the windows dispatched on that carry are
    fetched; window C then sees B's gangs, decides as the unpruned solve
    does and over-commits nothing. The JAX package builds at once from the
    host view, which lacks B's gangs, and C over-commits: a deliberate
    deviation (ROADMAP §C.6)."""
    want, drains_full, over_full = _dispatch_after_escalation(PORT, 0, 2.0)
    got, drains, over = _dispatch_after_escalation(PORT, 1, 0.01)
    assert drains_full == 0 and over_full == []
    assert drains == 1
    assert got == want
    assert over == []
    _, jax_drains, jax_over = _dispatch_after_escalation(JAX, 1, 0.01)
    assert jax_drains == 0 and jax_over


def _solo_after_escalation(top_k, slack, fallback):
    """Windows A and B dispatched back to back; A fetched (a tight K
    escalates it, poisoning B's carry) and its gangs committed; then a solo
    pack asks for every core the host view shows free, built as the
    extender builds a solo solve (the pipelined build, and `fallback` when
    that raises PipelineDrainRequired); then B fetched. Returns (the solo
    packing and B's decisions, nodes over-committed, B's handle)."""
    solver_mod = _mod(PORT, "core.solver")
    res = _mod(PORT, "models.resources").Resources
    solver = _solver(PORT, prune_top_k=top_k, prune_slack=slack)
    nodes, batches, _ = _scenario(PORT, 0, n_nodes=48, zones=3, k=3, per=4,
                                  n_batches=1)
    (wa, wb, _), usage = batches[0], {}

    def commit(name, amount):
        usage[name] = usage.get(name, res.zero()).add(amount)

    def fetch(h, w):
        got = solver.pack_window_fetch(h)
        for req, d in zip(w, got):
            if d.admitted:
                drv, exe = req.rows[-1][0], req.rows[-1][1]
                commit(d.packing.driver_node, drv)
                for name in d.packing.executor_nodes:
                    commit(name, exe)
        return [tuple(d) for d in got]

    ha = solver.pack_window_dispatch(
        "tightly-pack", solver.build_tensors_pipelined(nodes, usage, {}), wa)
    hb = solver.pack_window_dispatch(
        "tightly-pack", solver.build_tensors_pipelined(nodes, usage, {}), wb)
    fetch(ha, wa)
    try:
        t = solver.build_tensors_pipelined(nodes, usage, {})
    except solver_mod.PipelineDrainRequired:
        t = getattr(solver, fallback)(nodes, usage, {})
    free = sum(n.allocatable.cpu_milli - usage.get(n.name, res.zero()).cpu_milli
               for n in nodes) // 1000
    one = res.from_quantities("1", "1Gi")
    solo = solver.pack("tightly-pack", t, one, one, free - 1,
                       [n.name for n in nodes])
    if solo.has_capacity:
        commit(solo.driver_node, one)
        for name in solo.executor_nodes:
            commit(name, one)
    out = [(solo.has_capacity, solo.driver_node, tuple(solo.executor_nodes))]
    out += fetch(hb, wb)
    over = [n.name for n in nodes
            if usage.get(n.name, res.zero()).cpu_milli > n.allocatable.cpu_milli]
    if top_k:
        assert solver.prune_stats["escalations"] > 0
    return out, over, hb


def test_solo_pack_after_an_escalation_sees_the_poisoned_windows():
    """A solo solve between an escalated fetch and the next fetch: the
    pipelined build is refused, and the solo build re-solves the window
    dispatched on the dropped carry and debits its gangs, so the solo pack
    decides as it does on the unpruned threaded base and B's gangs are not
    taken twice. The bare host view lacks B's gangs: the same solo pack
    then over-commits (ROADMAP §C.6)."""
    want, over_full, _ = _solo_after_escalation(0, 2.0, "build_tensors_solo")
    got, over, hb = _solo_after_escalation(1, 0.01, "build_tensors_solo")
    assert over_full == [] and over == []
    assert hb.use_fallback and hb.resolved is not None
    assert got == want
    bare, bare_over, _ = _solo_after_escalation(1, 0.01, "build_tensors")
    assert bare[0][0] and bare_over


# ------------------------------------------------------------ host pieces


def _random_cluster(rng, n, zb, *, neg=True, absent=True):
    """Host numpy fields of a random cluster with availability ties,
    negative rows and (optionally) zones with no valid row."""
    hi = 6
    avail = rng.integers(-2 if neg else 0, hi, size=(n, 3)).astype(np.int32)
    avail[:, 1] *= 1 << 20
    zones = zb - 1 if absent else zb
    zone_id = rng.integers(0, zones, size=n).astype(np.int32)
    return dict(
        available=avail,
        schedulable=np.abs(avail) + 8,
        zone_id=zone_id,
        name_rank=rng.permutation(n).astype(np.int32),
        label_rank_driver=np.zeros(n, np.int32),
        label_rank_executor=np.zeros(n, np.int32),
        unschedulable=rng.random(n) < 0.1,
        ready=rng.random(n) < 0.95,
        valid=rng.random(n) < 0.9,
    )


def _host(root, fields):
    return _mod(root, "models.cluster").ClusterTensors(**fields)


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_zone_ranks_host_and_split_zone_sums_match_jax(seed):
    jp = _mod(JAX, "core.prune")
    pp = _mod(PORT, "core.prune")
    rng = np.random.default_rng(seed)
    z = 8
    mem = rng.integers(-(1 << 40), 1 << 40, size=z)
    mem[: z // 2] = mem[0]  # ties
    cpu = rng.integers(-50, 50, size=z)
    cpu[1] = cpu[0]
    present = rng.random(z) < 0.7
    assert np.array_equal(
        pp.zone_ranks_host(mem, cpu, present), jp.zone_ranks_host(mem, cpu, present)
    )
    for a, b in zip(pp.split_zone_sums(mem), jp.split_zone_sums(mem)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_plan_full_domain_and_certificate_match_jax(seed):
    """Both planners, fed one random cluster and two windows' demand,
    choose the same kept rows and summaries; both certificates judge the
    same random decision blobs alike."""
    rng = np.random.default_rng(seed)
    n, zb = 160, 4
    fields = _random_cluster(rng, n, zb)
    drv = np.asarray([[2, 2 << 20, 0], [1, 1 << 20, 0]], np.int32)
    exc = np.asarray([[1, 1 << 20, 0], [2, 1 << 20, 0]], np.int32)
    counts = np.asarray([2, 3], np.int32)
    cand = [rng.random(n) < 0.8, np.ones(n, bool)]
    plans = []
    for root in (JAX, PORT):
        host = _host(root, fields)
        planner = _mod(root, "core.prune").PrunePlanner()
        planner.sync(host, zb)
        plans.append(planner.plan_full_domain(
            host, cand_per_req=cand, drv_arr=drv, exc_arr=exc, counts=counts,
            num_zones=zb, top_k=4, slack=0.5,
        ))
    want, got = plans
    assert want is not None and got is not None
    for f in ("keep", "k_real", "zone_mem", "zone_cpu", "present", "e_cnt_exec",
              "e_max_exec", "e_key_exec", "e_cnt_drv", "e_max_drv", "e_key_drv",
              "dom_rows"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    for a, b in zip(got.zone_base, want.zone_base):
        assert np.array_equal(a, b)
    for a, b in zip(got.cand_kept, want.cand_kept):
        assert np.array_equal(a, b)

    # The certificate on decision blobs that choose kept rows (some
    # admitted, some denied), against the same base and priors.
    keep = got.keep[: got.k_real]
    rows = 4
    emax = 4
    for trial in range(6):
        trng = np.random.default_rng(seed * 100 + trial)
        drivers = trng.choice(keep, size=rows).astype(np.int64)
        execs = np.full((rows, emax), -1, np.int64)
        for r in range(rows):
            k = int(trng.integers(0, emax + 1))
            execs[r, :k] = trng.choice(keep, size=k)
        admitted = trng.random(rows) < 0.6
        packed = admitted | (trng.random(rows) < 0.3)
        drivers[~packed] = -1
        drv64 = np.repeat(drv[:1].astype(np.int64), rows, axis=0)
        exc64 = np.repeat(exc[:1].astype(np.int64), rows, axis=0)
        prior_rows = np.sort(trng.choice(keep, size=2, replace=False)).astype(np.int64)
        prior_deltas = trng.integers(0, 3, size=(2, 3)).astype(np.int64)
        if trial % 3 == 2:
            # A prior placement on an excluded row.
            excl = np.setdiff1d(np.flatnonzero(fields["valid"]), keep)
            prior_rows = np.sort(np.r_[prior_rows[:1], excl[:1]]).astype(np.int64)
        verdicts = []
        for root, plan in ((JAX, want), (PORT, got)):
            request = _mod(root, "core.solver").WindowRequest
            reqs = [request(rows=[(None, None, 0, False)] * 2,
                            driver_candidate_names=()) for _ in range(2)]
            base_kept = fields["available"][keep].astype(np.int64)
            verdicts.append(_mod(root, "core.prune").certify_window(
                plan, strategy=PLAIN[trial % 3], requests=reqs,
                drivers=drivers, admitted=admitted, packed=packed,
                execs=execs, drv64=drv64, exc64=exc64, base_kept=base_kept,
                host=_host(root, fields), prior_rows=prior_rows,
                prior_deltas=prior_deltas,
            ))
        assert verdicts[1] == verdicts[0], (trial, verdicts)


def _port_cluster(fields):
    return _mod(PORT, "models.cluster").cluster_from_numpy(
        [fields[f] for f in ("available", "schedulable", "zone_id", "name_rank",
                             "label_rank_driver", "label_rank_executor",
                             "unschedulable", "ready", "valid")],
        device="cpu",
    )


@pytest.mark.parametrize("seed", [31, 32, 33])
def test_zone_base_on_a_gathered_subcluster_ranks_as_the_full_cluster(
    seed, monkeypatch
):
    """`window_pack_reference(..., zone_base=...)` over kept rows: every
    segment's zone ranks equal those of the full cluster, and so do the
    decisions when the left-out rows can take no driver or executor (not
    candidates, unschedulable) yet stay in the domain's zone sums."""
    import spark_scheduler_tpu_torch.ops.window as window
    from spark_scheduler_tpu.models.cluster import ClusterTensors as JaxTensors
    from spark_scheduler_tpu.ops.sorting import zone_ranks as jax_zone_ranks
    from spark_scheduler_tpu_torch.core.prune import split_zone_sums
    from spark_scheduler_tpu_torch.ops.sorting import zone_ranks

    rng = np.random.default_rng(seed)
    n, zb = 64, 4
    fields = _random_cluster(rng, n, zb)
    fields["available"] = np.abs(fields["available"]) * 4
    keep = np.sort(rng.choice(n, size=24, replace=False))
    excl = np.setdiff1d(np.arange(n), keep)
    full_fields = dict(fields)
    full_fields["unschedulable"] = fields["unschedulable"].copy()
    full_fields["unschedulable"][excl] = True
    sub_fields = {k: v[keep] for k, v in fields.items()}
    live = excl[fields["valid"][excl]]
    sums = []
    for dim in (1, 0):
        s = np.zeros(zb, np.int64)
        np.add.at(s, fields["zone_id"][live],
                  fields["available"][live, dim].astype(np.int64))
        sums.extend(split_zone_sums(s))
    present = np.zeros(zb, bool)
    present[fields["zone_id"][live]] = True
    zone_base = tuple(torch.as_tensor(a) for a in sums) + (torch.as_tensor(present),)

    full = _port_cluster(full_fields)
    sub = _port_cluster(sub_fields)
    ones = torch.ones(n, dtype=torch.bool)
    jfull = JaxTensors(**{k: np.asarray(v) for k, v in full_fields.items()})
    want0 = np.asarray(jax_zone_ranks(jfull, np.ones(n, bool), zb))
    assert np.array_equal(zone_ranks(full, ones, zb).numpy(), want0)
    got0 = zone_ranks(sub, torch.ones(len(keep), dtype=torch.bool), zb,
                      zone_base=zone_base)
    assert np.array_equal(got0.numpy(), want0)

    cand_full = np.zeros(n, bool)
    cand_full[keep] = True
    requests = [
        [(np.asarray([1, 1 << 20, 0], np.int32), np.asarray([2, 1 << 20, 0], np.int32),
          int(rng.integers(1, 4)), bool(rng.random() < 0.3))
         for _ in range(int(rng.integers(1, 4)))]
        for _ in range(5)
    ]
    seen = {"sub": [], "full": []}
    tag = {"now": None}
    orig = window.zone_ranks

    def spy(*args, **kw):
        out = orig(*args, **kw)
        seen[tag["now"]].append(out.clone())
        return out

    monkeypatch.setattr(window, "zone_ranks", spy)
    outs = {}
    for name, cluster, cand, size in (
        ("full", full, cand_full, n), ("sub", sub, np.ones(len(keep), bool), len(keep))
    ):
        win = window.make_segmented_window(
            requests, [cand] * len(requests), [np.ones(size, bool)] * len(requests)
        )
        tag["now"] = name
        outs[name] = window.window_pack_reference(
            cluster, win, fill="tightly-pack", emax=8, num_zones=zb,
            zone_base=zone_base if name == "sub" else None,
        )
    assert len(seen["sub"]) == len(seen["full"]) == len(requests)
    for a, b in zip(seen["sub"], seen["full"]):
        assert torch.equal(a, b)
    (fm, fe, fb), (sm, se, sb) = outs["full"], outs["sub"]
    gmap = np.r_[keep, -1]
    assert np.array_equal(gmap[sm[..., 0].numpy()], fm[..., 0].numpy())
    assert torch.equal(sm[..., 1:], fm[..., 1:])
    assert np.array_equal(gmap[se.numpy()], fe.numpy())
    assert torch.equal(sb, fb[keep])


def test_zone_base_refused_for_single_az_fills():
    from spark_scheduler_tpu_torch.ops.window import make_segmented_window, window_pack

    rng = np.random.default_rng(2)
    fields = _random_cluster(rng, 16, 4)
    cluster = _port_cluster(fields)
    win = make_segmented_window(
        [[(np.ones(3, np.int32), np.ones(3, np.int32), 1, False)]],
        [np.ones(16, bool)], [np.ones(16, bool)],
    )
    zb = tuple(torch.zeros(4, dtype=torch.int32) for _ in range(4)) + (
        torch.zeros(4, dtype=torch.bool),)
    with pytest.raises(ValueError, match="plain fills"):
        window_pack(cluster, win, fill="single-az-tightly-pack", emax=8,
                    num_zones=4, zone_base=zb)
    with pytest.raises(ValueError, match="zone_base"):
        window_pack(cluster, win, fill="tightly-pack", emax=8, num_zones=4,
                    zone_base=zb[:4] + (torch.zeros(4, dtype=torch.int32),))


def test_planner_fed_exact_rows_plans_as_a_rescan_every_window():
    """Two pruned port solvers on the same churn: one keeps its planner
    fed with the exact changed rows, the other invalidates its planner
    before every window, so every plan is built from a fresh scan. The
    decisions agree, every plan's zone totals agree, and each incremental
    plan's offsets are the left-out rows' sums of its own kept set."""
    plans = {"fed": [], "rescan": []}
    decisions = {}
    for mode in plans:
        solver = _solver(PORT, prune_top_k=4, prune_slack=0.5)
        nodes, batches, usages = _scenario(
            PORT, 77, n_nodes=128, zones=3, k=2, per=3, n_batches=4
        )
        out = []
        for usage, wins in zip(usages, batches):
            handles = []
            for w in wins:
                t = solver.build_tensors_pipelined(nodes, usage, {})
                if mode == "rescan" and solver._planner is not None:
                    solver._planner.invalidate()
                h = solver.pack_window_dispatch("tightly-pack", t, w)
                handles.append(h)
                plans[mode].append((h.prune, h.host_tensors))
            for h in handles:
                out.extend(solver.pack_window_fetch(h))
        decisions[mode] = out
    assert decisions["fed"] == decisions["rescan"]
    assert sum(p is not None for p, _ in plans["fed"]) > 0
    for (a, host), (b, _) in zip(plans["fed"], plans["rescan"]):
        assert (a is None) == (b is None)
        if a is None:
            continue
        for f in ("zone_mem", "zone_cpu", "present"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
        avail = np.asarray(host.available).astype(np.int64)
        valid = np.asarray(host.valid, bool).copy()
        valid[a.keep[: a.k_real]] = False
        zid = np.asarray(host.zone_id)
        for dim, (hi, lo) in ((1, a.zone_base[:2]), (0, a.zone_base[2:4])):
            s = np.zeros(a.num_zones, np.int64)
            np.add.at(s, zid[valid], avail[valid, dim])
            assert np.array_equal((hi.astype(np.int64) << 24) + lo, s)


# --------------------------------------------------------------- surfaces


def _serve_pruned_traffic(s, names, rng):
    """A dozen drivers posted one at a time (each its own window), each
    admitted driver bound and its executors posted, a node PUT half way.
    Returns every (status, body)."""
    out = []
    for i in range(12):
        pod = k8s_spark_pod(
            f"pr-{i}", "driver", f"pr-{i}-driver",
            executors=int(rng.integers(1, 6)),
            created=f"2026-07-29T12:00:{i:02d}Z",
            exec_cpu=str(int(rng.integers(1, 3))),
        )
        assert s.call("PUT", "/state/pods", pod)[0] == 200
        status, body = s.call("POST", "/predicates", {"Pod": pod, "NodeNames": names})
        out.append((status, body))
        got = json.loads(body)["NodeNames"]
        if got:
            pod["spec"]["nodeName"] = got[0]
            pod["status"]["phase"] = "Running"
            s.call("PUT", "/state/pods", pod)
            count = int(pod["metadata"]["annotations"]["spark-executor-count"])
            for e in range(count):
                ex = k8s_spark_pod(f"pr-{i}", "executor", f"pr-{i}-exec-{e}",
                                   created=f"2026-07-29T12:00:{i:02d}Z")
                s.call("PUT", "/state/pods", ex)
                status, body = s.call("POST", "/predicates",
                                      {"Pod": ex, "NodeNames": names})
                out.append((status, body))
                node = json.loads(body)["NodeNames"]
                if node:
                    ex["spec"]["nodeName"] = node[0]
                    ex["status"]["phase"] = "Running"
                    s.call("PUT", "/state/pods", ex)
        if i == 5:
            assert s.call("PUT", "/state/nodes",
                          k8s_node("n-extra", zone="zone0", cpu="16"))[0] == 200
    return out


def test_server_with_prune_top_k_matches_jax_and_reports_prune():
    """Both servers on `solver.prune-top-k: 4` (slack 0.5), tightly-pack,
    ~100 nodes over 3 zones: every body byte-identical to the JAX
    server's; the port's /debug/state shows a prune block whose windows,
    kept rows, escalations and reasons equal the JAX server's; the
    `foundry.spark.scheduler.solver.prune.*` series land in the solver's
    registry."""
    sides = [
        Served(root, binpack_algo="tightly-pack", solver_prune_top_k=4,
               solver_prune_slack=0.5)
        for root in (JAX, PORT)
    ]
    try:
        names = [f"n{i}" for i in range(96)]
        bodies = []
        for s in sides:
            for i, n in enumerate(names):
                assert s.call("PUT", "/state/nodes",
                              k8s_node(n, zone=f"zone{i % 3}", cpu="16"))[0] == 200
            bodies.append(_serve_pruned_traffic(s, names, np.random.default_rng(23)))
        want, got = bodies
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert g[0] == w[0] == 200, i
            assert same(g[1], w[1]), (i, g[1][:300], w[1][:300])
        assert sum(bool(json.loads(g[1])["NodeNames"]) for g in got) >= 12
        states = [json.loads(s.call("GET", "/debug/state")[1]) for s in sides]
        prune = [st["prune"] for st in states]
        assert prune[1]["windows"] > 0
        assert {k: prune[1][k] for k in STAT_KEYS} == {k: prune[0][k] for k in STAT_KEYS}
        for k in ("plan_ms_mean", "gather_ms_mean", "offset_ms_mean", "planner"):
            assert k in prune[1], k
        assert states[1]["solver"]["window_paths"].get("reference-pruned", 0) > 0
        snap = sides[1].app.solver.telemetry.registry.snapshot()
        series = "foundry.spark.scheduler.solver.prune."
        assert snap[series + "windows"][0]["value"] == prune[1]["windows"]
        for name in ("kept.rows", "kept.ratio", "plan.ms", "gather.ms", "offset.ms"):
            assert snap[series + name][0]["count"] == prune[1]["windows"], name
        paths = {e["tags"].get("path") for e in
                 snap["foundry.spark.scheduler.solver.window.dispatches"]}
        assert "xla-pruned" in paths
    finally:
        for s in sides:
            s.stop()


def test_cli_takes_prune_options(monkeypatch):
    """`server --prune-top-k / --prune-slack` reach the install config the
    app is built from, as in the JAX CLI."""
    import spark_scheduler_tpu_torch.server.app as app_mod
    from spark_scheduler_tpu_torch.__main__ import main

    seen = {}

    class Built(Exception):
        pass

    def capture(backend, config, **kw):
        seen["config"] = config
        raise Built

    monkeypatch.setattr(app_mod, "build_scheduler_app", capture)
    with pytest.raises(Built):
        main(["server", "--port", "0", "--prune-top-k", "16",
              "--prune-slack", "1.5"])
    assert seen["config"].solver_prune_top_k == 16
    assert seen["config"].solver_prune_slack == 1.5
