"""The policy engine of the port (`policy.enabled`): priority tiers, the
strategy registry, priority and DRF ordering, the preemption search and
its evictions, the defragmenter, the policy-off identity and the policy
soak, each scenario run on the JAX package and on the port
(`device="cpu"`) with the same inputs.

The scenarios are those of tests/test_policy.py (18),
tests/test_policy_identity.py (2) and tests/test_policy_soak.py, with
their own assertions kept; besides, every decision (outcome, nodes,
failure message), every reservation (its v1beta2 wire form), every
eviction set and preemption record, the `policy.*` metric values and the
defragmenter's before / after must be equal across the two packages.
Pods are stamped from a counter local to each run, so both packages see
the same creation times. Tolerance: none.
"""

from __future__ import annotations

import copy
import importlib
import itertools
import json

import numpy as np
import pytest

from tests.test_torch_extender import JAX, PORT, canon


class ManualClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class Pkg:
    """One package's modules, harness and pod factories; pods get creation
    times from a counter of this run (overridden where a scenario stamps
    them from its clock)."""

    def __init__(self, root):
        self.root = root
        self._ts = itertools.count(1)

    def mod(self, name):
        return importlib.import_module(f"{self.root}.{name}")

    @property
    def hm(self):
        return self.mod("testing.harness")

    def harness(self, **kw):
        if self.root == PORT:
            kw["device"] = "cpu"
        return self.hm.Harness(**kw)

    def _stamp(self, pods):
        ts = float(next(self._ts))
        for p in pods:
            p.creation_timestamp = ts
        return pods

    def static(self, app_id, execs, **kw):
        return self._stamp(self.hm.static_allocation_spark_pods(app_id, execs, **kw))

    def dynamic(self, app_id, lo, hi):
        return self._stamp(self.hm.dynamic_allocation_spark_pods(app_id, lo, hi))

    def node(self, name, **kw):
        return self.hm.new_node(name, **kw)

    def registry(self):
        return self.mod("metrics.registry").MetricRegistry()


def both(scenario, *args):
    """Run `scenario(pkg, *args)` on each package; the observations must be
    equal."""
    want = canon(scenario(Pkg(JAX), *args))
    got = canon(scenario(Pkg(PORT), *args))
    assert got == want
    return got


def res_key(r):
    return (r.outcome, list(r.node_names), sorted(r.failed_nodes.items()))


def wires(h, pkg):
    to_wire = pkg.mod("server.conversion").rr_v1beta2_to_wire
    return sorted(
        json.dumps(to_wire(rr), sort_keys=True) for rr in h.app.rr_cache.list()
    )


def policy_series(reg):
    return {
        name: [{k: v for k, v in e.items()} for e in entries]
        for name, entries in reg.snapshot().items()
        if name.startswith("foundry.spark.scheduler.policy")
    }


def preemption_records(h):
    return [rec["preemption"] for rec in h.app.recorder.query(limit=10_000)
            if rec.get("preemption")]


# ------------------------------------------------------------ scenarios


def _policy_harness(pkg, clock=None, **kw):
    kw.setdefault("policy_enabled", True)
    kw.setdefault("resync_gap_seconds", 1e12)
    return pkg.harness(clock=clock, **kw)


def _stamped(pkg, app_id, execs, pclass, clock, instance_group=None):
    kw = {} if instance_group is None else {"instance_group": instance_group}
    pods = pkg.static(app_id, execs, **kw)
    if pclass is not None:
        pods[0].annotations[pkg.mod("models.reservations").PRIORITY_CLASS_ANNOTATION] = pclass
    for p in pods:
        p.creation_timestamp = clock()
    return pods


def _admit(h, pods, names, out):
    r = h.schedule(pods[0], names)
    out.append((pods[0].name, res_key(r)))
    if r.ok:
        for p in pods[1:]:
            rp = h.schedule(p, names)
            out.append((p.name, res_key(rp)))
            assert rp.ok
    return r


def registry_unknown_binpacker(pkg):
    err = pkg.mod("policy").UnknownStrategyError
    packing = pkg.mod("ops.packing")
    table = getattr(packing, "BINPACK_FUNCTIONS", None) or packing.BINPACK_STRATEGIES
    with pytest.raises(err) as exc:
        pkg.mod("core.binpacker").select_binpacker("nope")
    assert isinstance(exc.value, ValueError)
    for name in table:
        assert name in str(exc.value)
    assert exc.value.name == "nope"
    assert exc.value.valid == sorted(table)
    return [str(exc.value), exc.value.name, exc.value.valid]


def registry_unknown_ordering(pkg):
    eng = pkg.mod("policy.engine")
    with pytest.raises(pkg.mod("policy").UnknownStrategyError) as exc:
        eng.PolicyEngine(
            eng.PolicyConfig(ordering="wrongo"), backend=None, rr_cache=None,
            pod_lister=None, soft_store=None, reservation_manager=None,
            solver=None, clock=lambda: 0.0,
        )
    assert "fifo" in str(exc.value) and "drf" in str(exc.value)
    return [str(exc.value)]


def registry_resolve_known(pkg):
    resolve = pkg.mod("policy").resolve
    assert resolve("a", {"a": 1, "b": 2}, "thing") == 1
    return [resolve(k, {"a": 1, "b": 2}, "thing") for k in ("a", "b")]


def priority_parse(pkg):
    pri = pkg.mod("policy.priority")
    classes = pkg.mod("policy").PRIORITY_CLASSES
    assert pri.parse_priority_class(None) == classes["default"]
    assert pri.parse_priority_class("system") == 300
    assert pri.parse_priority_class("HIGH") == 200
    assert pri.parse_priority_class("250") == 250
    assert pri.parse_priority_class("junk") == classes["default"]
    rng = np.random.default_rng(5)
    values = [None, " Low ", "DEFAULT", "-7", "", "1e3"]
    values += [str(int(x)) for x in rng.integers(-500, 500, 16)]
    return [pri.parse_priority_class(v) for v in values] + [dict(classes)]


def priority_effective(pkg):
    ep = pkg.mod("policy").effective_priority
    assert ep(0, 0.0, 300.0) == 0
    assert ep(0, 299.0, 300.0) == 0
    assert ep(0, 300.0, 300.0) == 100
    assert ep(0, 900.0, 300.0) == 200
    assert ep(200, 10_000.0, 300.0) == 200
    assert ep(300, 10_000.0, 300.0) == 300
    assert ep(0, 10_000.0, 0.0) == 0
    rng = np.random.default_rng(6)
    return [
        ep(int(b), float(a), float(s))
        for b, a, s in zip(rng.choice([0, 100, 200, 300, 150], 32),
                           rng.uniform(-10, 2000, 32),
                           rng.choice([0.0, 60.0, 300.0], 32))
    ]


def priority_annotation_stamped(pkg):
    out = []
    ann = pkg.mod("models.reservations").PRIORITY_CLASS_ANNOTATION
    clk = ManualClock()
    h = _policy_harness(pkg, clock=clk)
    h.add_nodes(pkg.node("n1"))
    pods = _stamped(pkg, "app-pc", 1, "high", clk)
    assert _admit(h, pods, ["n1"], out).ok
    rr = h.get_reservation("namespace", "app-pc")
    assert rr.annotations[ann] == "high"
    pods2 = _stamped(pkg, "app-none", 1, None, clk)
    assert _admit(h, pods2, ["n1"], out).ok
    rr2 = h.get_reservation("namespace", "app-none")
    assert ann not in rr2.annotations
    pod_priority = pkg.mod("policy").pod_priority
    assert pod_priority(pods[0]) == 200
    out += [pod_priority(pods[0]), pod_priority(pods2[0]), wires(h, pkg)]
    return out


def priority_wire_roundtrip(pkg):
    conv = pkg.mod("server.conversion")
    rmod = pkg.mod("models.reservations")
    ann = rmod.PRIORITY_CLASS_ANNOTATION
    one = pkg.mod("models.resources").Resources.from_quantities(
        "1", "1Gi", "0", round_up=False)
    driver = pkg.static("app-w", 1)[0]
    driver.annotations[ann] = "system"
    rr = rmod.new_resource_reservation("n0", ["n0"], driver, one, one)
    wire = conv.rr_v1beta2_to_wire(rr)
    assert wire["spec"]["priorityClass"] == "system"
    assert ann not in wire["metadata"].get("annotations", {})
    back = conv.rr_v1beta2_from_wire(wire)
    assert back.annotations[ann] == "system"
    driver2 = pkg.static("app-w2", 1)[0]
    rr2 = rmod.new_resource_reservation("n0", ["n0"], driver2, one, one)
    wire2 = conv.rr_v1beta2_to_wire(rr2)
    assert "priorityClass" not in wire2["spec"]
    back2 = conv.rr_v1beta2_from_wire(wire2)
    assert ann not in back2.annotations
    return [wire, wire2, dict(back.annotations), dict(back2.annotations)]


def priority_crd_schema(pkg):
    crd = pkg.mod("models.crds").resource_reservation_crd()
    v2 = next(v for v in crd["spec"]["versions"] if v["name"] == "v1beta2")
    spec_props = v2["schema"]["openAPIV3Schema"]["properties"]["spec"]["properties"]
    assert spec_props["priorityClass"] == {"type": "string"}
    return [spec_props]


def _free_app(h, app_id):
    rr = h.get_reservation("namespace", app_id)
    for pod in h.app.pod_lister.list_app_pods(app_id, "namespace"):
        h.delete_pod(pod)
    if rr is not None:
        h.app.rr_cache.delete(rr.namespace, rr.name)


def ordering_priority_promotes(pkg):
    out = []
    clk = ManualClock()
    h = _policy_harness(pkg, clock=clk, policy_ordering="priority",
                        policy_promote_after_s=100.0)
    h.add_nodes(pkg.node("n1"))
    names = ["n1"]
    fill_a = _stamped(pkg, "fill-a", 3, "system", clk)
    fill_b = _stamped(pkg, "fill-b", 2, "system", clk)
    assert _admit(h, fill_a, names, out).ok
    assert _admit(h, fill_b, names, out).ok
    low = _stamped(pkg, "low-a", 2, "low", clk)
    clk.advance(1.0)
    high = _stamped(pkg, "high-a", 2, "high", clk)
    for pod in (low[0], high[0]):
        r = h.schedule(pod, names)
        out.append((pod.name, res_key(r)))
        assert not r.ok
    _free_app(h, "fill-b")
    r = h.schedule(low[0], names)
    out.append(res_key(r))
    assert not r.ok
    r = h.schedule(high[0], names)
    out.append(res_key(r))
    assert r.ok
    _free_app(h, "fill-a")
    clk.advance(250.0)
    fresh_high = _stamped(pkg, "high-b", 2, "high", clk)
    h.add_pods(fresh_high[0])
    r = h.schedule(low[0], names)
    out.append(res_key(r))
    assert r.ok
    assert pkg.hm.overcommit_violations(h.app, h.backend) == []
    return out + [wires(h, pkg)]


def ordering_drf_blocks(pkg):
    out = []
    clk = ManualClock()
    h = _policy_harness(pkg, clock=clk, policy_ordering="drf")
    h.add_nodes(pkg.node("ga-1", instance_group="group-a"),
                pkg.node("gb-1", instance_group="group-b"))
    a1 = _stamped(pkg, "a-1", 4, None, clk, instance_group="group-a")
    assert _admit(h, a1, ["ga-1"], out).ok
    shares = h.app.extender._policy.shares
    assert shares.dominant_share("group-a") > shares.dominant_share("group-b")
    out.append([shares.dominant_share(g) for g in ("group-a", "group-b", None)])
    clk.advance(10.0)
    b1 = _stamped(pkg, "b-1", 1, None, clk, instance_group="group-b")
    h.add_pods(b1[0])
    a2 = _stamped(pkg, "a-2", 1, None, clk, instance_group="group-a")
    r = h.schedule(a2[0], ["ga-1"])
    out.append(res_key(r))
    assert not r.ok and r.outcome == "failure-earlier-driver"
    assert _admit(h, b1, ["gb-1"], out).ok
    r2 = h.schedule(a2[0], ["ga-1"])
    out.append(res_key(r2))
    assert r2.ok
    assert pkg.hm.overcommit_violations(h.app, h.backend) == []
    return out + [shares.snapshot(), wires(h, pkg)]


def ordering_drf_oracle(pkg):
    out = []
    clk = ManualClock()
    h = _policy_harness(pkg, clock=clk, policy_ordering="drf")
    h.add_nodes(pkg.node("ga-1", instance_group="group-a"),
                pkg.node("gb-1", instance_group="group-b"))
    a1 = _stamped(pkg, "a-or-1", 2, None, clk, instance_group="group-a")
    b1 = _stamped(pkg, "b-or-1", 3, None, clk, instance_group="group-b")
    assert _admit(h, a1, ["ga-1"], out).ok
    assert _admit(h, b1, ["gb-1"], out).ok
    for p in a1:
        h.delete_pod(p)
    rr = h.get_reservation("namespace", "a-or-1")
    h.app.rr_cache.delete(rr.namespace, rr.name)
    shares = h.app.extender._policy.shares
    live = {g: u for g, u in shares.snapshot().items() if any(u)}
    shares.rebuild()
    oracle = {g: u for g, u in shares.snapshot().items() if any(u)}
    assert live == oracle and "group-b" in oracle
    return out + [live, oracle]


def _fill_then_preempt(pkg, clk, out, **kw):
    h = _policy_harness(pkg, clock=clk, policy_ordering="priority",
                        policy_preemption=True, **kw)
    h.add_nodes(pkg.node("n1"), pkg.node("n2"))
    names = ["n1", "n2"]
    for i, pclass in enumerate(["low", "low", "default"]):
        pods = _stamped(pkg, f"bg-{i}", 3, pclass, clk)
        assert _admit(h, pods, names, out).ok
    filler = _stamped(pkg, "bg-fill", 2, "default", clk)
    assert _admit(h, filler, names, out).ok
    return h, names


def preemption_solo_minimal(pkg):
    out = []
    clk = ManualClock()
    h, names = _fill_then_preempt(pkg, clk, out)
    solver = h.app.solver
    calls = []
    orig = solver.preemption_search

    def counting(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    solver.preemption_search = counting
    eng = pkg.mod("policy.engine")
    reg = pkg.registry()
    h.app.extender._policy._metrics = reg
    high = _stamped(pkg, "hi", 4, "high", clk)
    r = h.schedule(high[0], names)
    out.append(res_key(r))
    assert r.ok
    assert reg.counter(eng.PREEMPTIONS).value == 1
    assert reg.counter(eng.PREEMPTION_EVICTIONS).value == 1
    assert len(calls) == 1
    recs = preemption_records(h)
    assert len(recs) == 1
    pre = recs[0]
    assert pre["candidates"] >= 2
    assert len(pre["evicted"]) == 1
    evicted = pre["evicted"][0]
    assert evicted.startswith("bg-")
    assert h.get_reservation("namespace", evicted) is None
    assert h.get_reservation("namespace", "hi") is not None
    assert pkg.hm.overcommit_violations(h.app, h.backend) == []
    return out + [recs, policy_series(reg), wires(h, pkg)]


def preemption_protected(pkg):
    out = []
    clk = ManualClock()
    h = _policy_harness(pkg, clock=clk, policy_ordering="priority",
                        policy_preemption=True)
    h.add_nodes(pkg.node("n1"))
    sys_pods = _stamped(pkg, "sys-1", 5, "system", clk)
    assert _admit(h, sys_pods, ["n1"], out).ok
    high = _stamped(pkg, "hi-p", 3, "high", clk)
    r = h.schedule(high[0], ["n1"])
    out.append(res_key(r))
    assert not r.ok and r.outcome == "failure-fit"
    assert h.get_reservation("namespace", "sys-1") is not None
    return out + [preemption_records(h), wires(h, pkg)]


def preemption_age_promoted(pkg):
    out = []
    clk = ManualClock()
    h = _policy_harness(pkg, clock=clk, policy_ordering="priority",
                        policy_preemption=True, policy_promote_after_s=100.0)
    h.add_nodes(pkg.node("n1"))
    low = _stamped(pkg, "low-old", 5, "low", clk)
    assert _admit(h, low, ["n1"], out).ok
    clk.advance(500.0)
    high = _stamped(pkg, "hi-late", 3, "high", clk)
    r = h.schedule(high[0], ["n1"])
    out.append(res_key(r))
    assert not r.ok
    assert h.get_reservation("namespace", "low-old") is not None
    return out + [preemption_records(h), wires(h, pkg)]


def preemption_windowed(pkg):
    out = []
    clk = ManualClock()
    h, names = _fill_then_preempt(pkg, clk, out)
    args = pkg.mod("core.extender").ExtenderArgs
    high = _stamped(pkg, "hi-w", 4, "high", clk)
    h.add_pods(high[0])
    t = h.app.extender.predicate_window_dispatch(
        [args(pod=high[0], node_names=names)])
    (res,) = h.app.extender.predicate_window_complete(t)
    out.append(res_key(res))
    assert not res.ok
    assert "preempted" in list(res.failed_nodes.values())[0]
    r2 = h.schedule(high[0], names)
    out.append(res_key(r2))
    assert r2.ok
    assert pkg.hm.overcommit_violations(h.app, h.backend) == []
    return out + [preemption_records(h), wires(h, pkg)]


def preemption_prefixes(pkg):
    out = []
    clk = ManualClock()
    h, names = _fill_then_preempt(pkg, clk, out)
    eng = h.app.extender._policy
    victims = eng.preemption.enumerate_victims(200, None)
    assert len(victims) == 4
    assert [v[0] for v in victims] == sorted(v[0] for v in victims)
    freed = eng.preemption.freed_prefixes(victims, h.app.solver.registry)
    assert freed.shape[0] == 4
    totals = freed.sum(axis=(1, 2))
    assert all(totals[i] < totals[i + 1] for i in range(3))
    return out + [
        [(pc, created, rr.name) for pc, created, rr in victims],
        freed.tolist(),
        [(n, h.app.solver.registry.index_of(n)) for n in names],
    ]


def _fragmented_cluster(pkg, clk, out):
    h = _policy_harness(pkg, clock=clk)
    for i in range(3):
        h.add_nodes(pkg.node(f"fn{i}"))
    for i in range(3):
        pods = pkg.dynamic(f"frag-{i}", 5, 6)
        for p in pods:
            p.creation_timestamp = clk()
        assert _admit(h, pods, [f"fn{i}"], out).ok
    soft = h.soft_reservations()
    assert sum(len(sr.reservations) for sr in soft.values()) == 3
    return h


def defrag_reduces(pkg):
    out = []
    defrag = pkg.mod("policy.defrag")
    res = pkg.mod("models.resources").Resources
    clk = ManualClock()
    h = _fragmented_cluster(pkg, clk, out)
    d = defrag.Defragmenter(
        h.backend, h.app.soft_store, h.app.reservation_manager, clk,
        budget=2, unit=res.from_quantities("2", "2Gi", "0", round_up=False),
    )
    before = d.fragmentation()
    assert before == 1.0
    first = d.run_once(force=True)
    assert first["migrations"] == 2
    assert first["fragmentation_after"] < first["fragmentation_before"]
    for i in range(3):
        rr = h.get_reservation("namespace", f"frag-{i}")
        assert rr is not None and len(rr.spec.reservations) >= 6
    assert pkg.hm.overcommit_violations(h.app, h.backend) == []
    second = d.run_once(force=True)
    assert second["fragmentation_after"] == 0.0
    assert d.migrations == 3
    soft = {a: sorted(sr.reservations) for a, sr in h.soft_reservations().items()}
    return out + [before, first, second, d.passes, d.migrations, soft,
                  wires(h, pkg)]


def defrag_engine_interval(pkg):
    defrag = pkg.mod("policy.defrag")
    clk = ManualClock()
    reg = pkg.registry()
    h = _policy_harness(pkg, clock=clk, policy_defrag=True,
                        policy_defrag_interval_s=30.0, metrics=None)
    h.add_nodes(pkg.node("n1"))
    eng = h.app.extender._policy
    eng._metrics = reg
    eng.defrag._metrics = reg
    first = eng.maybe_defrag()
    assert first is not None
    assert eng.maybe_defrag() is None
    clk.advance(31.0)
    second = eng.maybe_defrag()
    assert second is not None
    assert reg.gauge(defrag.FRAGMENTATION_GAUGE).value == 0.0
    return [first, second, policy_series(reg)]


POLICY_SCENARIOS = {
    f.__name__: f
    for f in (
        registry_unknown_binpacker, registry_unknown_ordering,
        registry_resolve_known, priority_parse, priority_effective,
        priority_annotation_stamped, priority_wire_roundtrip,
        priority_crd_schema, ordering_priority_promotes, ordering_drf_blocks,
        ordering_drf_oracle, preemption_solo_minimal, preemption_protected,
        preemption_age_promoted, preemption_windowed, preemption_prefixes,
        defrag_reduces, defrag_engine_interval,
    )
}


@pytest.mark.parametrize("name", sorted(POLICY_SCENARIOS))
def test_policy_scenario_matches_jax(name):
    both(POLICY_SCENARIOS[name])


# --------------------------------------------------------------- identity


class TickClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        self.t += 0.25
        return self.t


def _scenario_pods(pkg):
    groups = {
        "solo-a": pkg.static("solo-a", 2),
        "solo-big": pkg.static("solo-big", 20),
        "solo-dyn": pkg.dynamic("solo-dyn", 2, 4),
        "win-a": pkg.static("win-a", 3),
        "win-b": pkg.static("win-b", 2),
        "win-big": pkg.static("win-big", 30),
    }
    for i, (_, pods) in enumerate(sorted(groups.items())):
        for p in pods:
            p.creation_timestamp = 100.0 + i
    return groups


def _identity_run(pkg, scenario, **kw):
    g = copy.deepcopy(scenario)
    h = pkg.harness(clock=TickClock(), resync_gap_seconds=1e12, **kw)
    h.add_nodes(pkg.node("n1", zone="zone1"), pkg.node("n2", zone="zone1"),
                pkg.node("n3", zone="zone2"), pkg.node("n4", zone="zone2"))
    names = ["n1", "n2", "n3", "n4"]
    args = pkg.mod("core.extender").ExtenderArgs
    transcript = []
    for app in ("solo-a", "solo-big", "solo-dyn"):
        for p in g[app]:
            transcript.append((p.name, res_key(h.schedule(p, names))))
        if app == "solo-big":
            for p in g[app]:
                h.delete_pod(p)
    drivers = [g["win-a"][0], g["win-b"][0], g["win-big"][0]]
    h.add_pods(*drivers)
    t = h.app.extender.predicate_window_dispatch(
        [args(pod=p, node_names=names) for p in drivers])
    for p, res in zip(drivers, h.app.extender.predicate_window_complete(t)):
        transcript.append((p.name, res_key(res)))
        if res.ok:
            h.backend.bind_pod(p, res.node_names[0])
    for app in ("win-a", "win-b"):
        for p in g[app][1:]:
            transcript.append((p.name, res_key(h.schedule(p, names))))
    out = (transcript, wires(h, pkg), h.app.extender._policy)
    h.app.stop()
    return out


def identity_batched(pkg):
    scenario = _scenario_pods(pkg)
    base_t, base_w, base_p = _identity_run(pkg, scenario)
    assert base_p is None
    neut_t, neut_w, neut_p = _identity_run(
        pkg, scenario, policy_enabled=True, policy_ordering="fifo",
        policy_preemption=False, policy_defrag=False)
    assert neut_p is not None and neut_p.preemption is None
    assert neut_t == base_t
    assert neut_w == base_w
    outcomes = {k[0] for _, k in base_t}
    assert "success" in outcomes and "failure-fit" in outcomes
    assert len(base_w) >= 4
    return [base_t, base_w]


def identity_sequential(pkg):
    scenario = _scenario_pods(pkg)
    base_t, base_w, _ = _identity_run(pkg, scenario, batched_admission=False)
    neut_t, neut_w, neut_p = _identity_run(
        pkg, scenario, batched_admission=False, policy_enabled=True)
    assert neut_p is not None
    assert neut_t == base_t
    assert neut_w == base_w
    return [base_t, base_w]


@pytest.mark.parametrize("scenario", [identity_batched, identity_sequential],
                         ids=["batched", "sequential"])
def test_policy_off_and_neutral_are_identical_and_match_jax(scenario):
    both(scenario)


# ------------------------------------------------------------------- soak


def policy_soak(pkg, steps):
    kw = {"device": "cpu"} if pkg.root == PORT else {}
    soak = pkg.mod("testing.soak").PolicySoak(
        n_low=3, n_nodes=3, promote_after_s=120.0, step_s=30.0, **kw)
    v = soak.run(steps=steps)
    assert v["evictions"] >= 1
    assert len(v["preemptions"]) >= 1
    for pre in v["preemptions"]:
        assert "system-app" not in pre["evicted"]
    assert v["system_rr_lost"] is False
    assert v["denied_high"] >= 1
    bound = 2 * soak.promote_after_s + 2 * soak.step_s
    for low_id, wait in v["low_waits_s"].items():
        assert wait is not None, f"{low_id} starved"
        assert wait <= bound, f"{low_id} waited {wait}s > {bound}s"
    assert v["overcommit"] == []
    pre = v["preemptions"][0]
    assert pre["candidates"] >= 1 and pre["cost"] >= 1
    assert pre["search_ms"] >= 0.0
    return v


def test_policy_soak_verdict_matches_jax():
    v = both(policy_soak, 30)
    assert v["steps"] == 30


# ------------------------------------------------- preemption failures


def test_failed_preemption_search_keeps_the_denial_and_is_counted():
    """A search that raises (a failed launch on the card) keeps the fit
    denial, as the JAX package does, and counts one
    `policy.preemption.search.failures`; nothing is evicted."""
    pkg = Pkg(PORT)
    out = []
    clk = ManualClock()
    h, names = _fill_then_preempt(pkg, clk, out)
    reg = pkg.registry()
    eng = h.app.extender._policy
    eng._metrics = reg

    def broken(*a, **kw):
        raise RuntimeError("launch failed")

    h.app.solver.preemption_search = broken
    before = wires(h, pkg)
    high = _stamped(pkg, "hi-f", 4, "high", clk)
    r = h.schedule(high[0], names)
    assert not r.ok and r.outcome == "failure-fit"
    assert eng.search_failures == 1
    failures = pkg.mod("policy.engine").PREEMPTION_SEARCH_FAILURES
    assert reg.counter(failures).value == 1
    assert wires(h, pkg) == before
    assert preemption_records(h) == []
