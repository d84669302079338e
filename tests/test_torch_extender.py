"""The extender core: the port's `SparkSchedulerExtender`, built from the
port's parts on `PlacementSolver(device="cpu")`, against the JAX package's,
built by hand from its parts on `PlacementSolver(use_native=False)`.

Both are wired by `Side` below, which mirrors the JAX package's
server/app.py `build_scheduler_app` with the reconciler, metrics, events,
waste, recorder and policy hooks off, synchronous write-back and one fixed
clock. A scenario drives both sides with the same calls; after every
request the results, the reservations (hard and soft) and the demands are
recorded, and the two records must be equal.

Tolerance: none. The efficiencies inside the decisions come from the same
integers through the same numpy code; the single-AZ zone score is summed in
float64 by the port against the JAX package's float32 (a recorded
deviation), and no scenario here hits a tie the two sums break differently.
"""

from __future__ import annotations

import dataclasses
import importlib
import itertools

import numpy as np
import pytest

JAX = "spark_scheduler_tpu"
PORT = "spark_scheduler_tpu_torch"
IG_LABEL = "resource_channel"
DEFAULT_IG = "batch-medium-priority"
NS = "namespace"
NOW = 1_000_000.0
STRATEGIES = (
    "tightly-pack",
    "distribute-evenly",
    "minimal-fragmentation",
    "single-az-tightly-pack",
    "single-az-minimal-fragmentation",
    "az-aware-tightly-pack",
)


def canon(x):
    """A package-independent form of a result or a stored object: nested
    dataclasses and named tuples become (type name, fields)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (
            type(x).__name__,
            {f.name: canon(getattr(x, f.name)) for f in dataclasses.fields(x)},
        )
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return (type(x).__name__, tuple(canon(v) for v in x))
    if isinstance(x, dict):
        return {k: canon(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [canon(v) for v in x]
    if isinstance(x, (set, frozenset)):
        return sorted(canon(v) for v in x)
    if isinstance(x, np.generic):
        return x.item()
    return x


class Side:
    """One scheduler wired from one package's parts (`root` is the package
    name), in the order of server/app.py `build_scheduler_app`, with an
    in-memory backend holding the Demand CRD. Every serving call records
    its results and the durable state after it in `log`."""

    def __init__(
        self,
        root: str,
        *,
        binpack: str = "single-az-tightly-pack",
        fifo: bool = True,
        same_az: bool = False,
        batched_admission: bool = True,
        delta_statics: bool = True,
        device: str = "cpu",
        clock=lambda: NOW,
    ):
        def mod(name):
            return importlib.import_module(f"{root}.{name}")

        self.root = root
        self.kube = mod("models.kube")
        self.resources = mod("models.resources")
        self.sparkpods = mod("core.sparkpods")
        self.ext_mod = mod("core.extender")
        backend_mod, cache = mod("store.backend"), mod("store.cache")
        self.backend = backend_mod.InMemoryBackend()
        self.backend.register_crd(backend_mod.DEMAND_CRD)
        self.rr_cache = cache.ResourceReservationCache(
            self.backend, sync_writes=True
        )
        self.demand_cache = cache.SafeDemandCache(self.backend, sync_writes=True)
        self.soft_store = mod("core.soft_reservations").SoftReservationStore(
            self.backend
        )
        pod_lister = self.sparkpods.SparkPodLister(self.backend, IG_LABEL)
        rrm_mod = mod("core.reservation_manager")
        self.reservation_error = rrm_mod.ReservationError
        self.rrm = rrm_mod.ResourceReservationManager(
            self.backend, self.rr_cache, self.soft_store, pod_lister
        )
        overhead = mod("core.overhead").OverheadComputer(self.backend, self.rrm)
        binpacker = mod("core.binpacker").select_binpacker(binpack)
        demands = mod("core.demands").DemandManager(
            self.backend,
            self.demand_cache,
            IG_LABEL,
            is_single_az_binpacker=binpacker.is_single_az,
            events=None,
            waste=None,
            clock=clock,
        )
        solver_cls = mod("core.solver").PlacementSolver
        if root == JAX:
            self.solver = solver_cls(use_native=False, delta_statics=delta_statics)
        else:
            self.solver = solver_cls(device=device, delta_statics=delta_statics)
        self.extender = self.ext_mod.SparkSchedulerExtender(
            self.backend,
            pod_lister,
            self.rrm,
            demands,
            overhead,
            binpacker,
            self.solver,
            config=self.ext_mod.ExtenderConfig(
                fifo=fifo,
                instance_group_label=IG_LABEL,
                schedule_dynamically_allocated_executors_in_same_az=same_az,
                batched_admission=batched_admission,
            ),
            reconciler=None,
            metrics=None,
            events=None,
            waste=None,
            recorder=None,
            clock=clock,
            policy=None,
        )
        # No time-gap resync in deterministic runs (as the JAX harness).
        self.extender._last_request = float("inf")
        self._ts = itertools.count(1)
        self.log: list = []

    # -- fixtures -----------------------------------------------------------

    def node(self, name, zone="zone1", ig=DEFAULT_IG, cpu="8", mem="8Gi",
             gpu="1"):
        """The JAX harness's 8 CPU / 8 GiB / 1 GPU node by default."""
        return self.kube.Node(
            name=name,
            allocatable=self.resources.Resources.from_quantities(
                cpu, mem, gpu, round_up=False
            ),
            labels={self.kube.ZONE_LABEL: zone, IG_LABEL: ig},
        )

    def add_nodes(self, *nodes):
        for n in nodes:
            self.backend.add_node(n)

    def spark_pods(self, app_id, executors, *, dynamic=None, ig=DEFAULT_IG,
                   exec_cpu="1", exec_mem="1Gi", ts=None):
        """Driver + `executors` executor pods (the JAX harness's fixtures),
        with uids and creation timestamps that do not depend on how many
        pods the process made before. `dynamic` = (min, max) turns on
        dynamic allocation."""
        sp = self.sparkpods
        ann = {
            sp.DRIVER_CPU: "1",
            sp.DRIVER_MEMORY: "1Gi",
            sp.EXECUTOR_CPU: exec_cpu,
            sp.EXECUTOR_MEMORY: exec_mem,
        }
        if dynamic is None:
            ann[sp.EXECUTOR_COUNT] = str(executors)
        else:
            ann[sp.DYNAMIC_ALLOCATION_ENABLED] = "true"
            ann[sp.DA_MIN_EXECUTOR_COUNT] = str(dynamic[0])
            ann[sp.DA_MAX_EXECUTOR_COUNT] = str(dynamic[1])
        ts = float(next(self._ts)) if ts is None else ts
        req = self.resources.Resources.from_quantities("1", "1Gi")

        def pod(name, role, annotations):
            return self.kube.Pod(
                name=name,
                namespace=NS,
                uid=f"uid-{name}",
                labels={sp.SPARK_ROLE_LABEL: role, sp.SPARK_APP_ID_LABEL: app_id},
                annotations=annotations,
                creation_timestamp=ts,
                scheduler_name=sp.SPARK_SCHEDULER_NAME,
                node_selector={IG_LABEL: ig},
                containers=[self.kube.Container(requests=req.copy())],
            )

        return [pod(f"{app_id}-driver", sp.ROLE_DRIVER, dict(ann))] + [
            pod(f"{app_id}-exec-{i + 1}", sp.ROLE_EXECUTOR, {})
            for i in range(executors)
        ]

    def plain_pod(self, name):
        return self.kube.Pod(
            name=name,
            namespace=NS,
            uid=f"uid-{name}",
            containers=[
                self.kube.Container(
                    requests=self.resources.Resources.from_quantities("1", "1Gi")
                )
            ],
        )

    def add_pods(self, *pods):
        for p in pods:
            if self.backend.get("pods", p.namespace, p.name) is None:
                self.backend.add_pod(p)

    def args(self, pod, names):
        return self.ext_mod.ExtenderArgs(pod=pod, node_names=list(names))

    def terminate_pod(self, pod):
        cur = self.backend.get("pods", pod.namespace, pod.name)
        for c in cur.containers:
            c.terminated = True
        self.backend.update_pod(cur)

    def delete_pod(self, pod):
        self.backend.delete_pod(pod)

    # -- serving (each call logs its results and the state after it) -------

    def state(self):
        """Hard reservations, soft reservations and demands, by name."""

        def by_name(kind):
            return sorted(
                (canon(o) for o in self.backend.list(kind)),
                key=lambda c: (c[1]["namespace"], c[1]["name"]),
            )

        return {
            "reservations": by_name("resourcereservations"),
            "soft": canon(self.soft_store.get_all_copy()),
            "demands": by_name("demands"),
        }

    def _record(self, results):
        self.log.append((canon(results), self.state()))
        return results

    def bind(self, pod, result):
        if result.ok:
            self.backend.bind_pod(pod, result.node_names[0])

    def schedule(self, pod, names):
        """The JAX harness's `schedule`: the real predicate, then a
        kube-scheduler bind on success."""
        self.add_pods(pod)
        res = self.extender.predicate(self.args(pod, names))
        self._record([res])
        self.bind(pod, res)
        return res

    def predicate(self, args):
        return self._record([self.extender.predicate(args)])[0]

    def batch(self, args_list):
        return self._record(self.extender.predicate_batch(args_list))

    def dispatch(self, args_list):
        return self.extender.predicate_window_dispatch(args_list)

    def complete(self, ticket):
        return self._record(self.extender.predicate_window_complete(ticket))


def run_both(scenario, **kw):
    """Run `scenario(side)` on a JAX side and on a port side built alike;
    returns (jax side, port side) after checking their logs are equal
    request by request."""
    sides = [Side(root, **kw) for root in (JAX, PORT)]
    for s in sides:
        scenario(s)
    want, got = sides[0].log, sides[1].log
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g[0] == w[0], f"request {i}: results differ"
        assert g[1] == w[1], f"request {i}: reservations or demands differ"
    return sides


# ------------------------------------------- tests/test_extender_scenarios.py


def gang_then_extra_executor(h):
    h.add_nodes(h.node("n1"))
    pods = h.spark_pods("app-1", 2)
    for p in pods:
        assert h.schedule(p, ["n1"]).ok
    extra = h.spark_pods("app-1", 3)[3]
    extra.name = "app-1-exec-extra"
    assert h.schedule(extra, ["n1"]).outcome == "failure-unbound"


def replace_reservation_after_termination(h):
    h.add_nodes(h.node("n1"))
    pods = h.spark_pods("app-2", 2)
    for p in pods:
        h.schedule(p, ["n1"])
    h.terminate_pod(pods[2])
    repl = h.spark_pods("app-2", 3)[3]
    repl.name = "app-2-exec-replacement"
    assert h.schedule(repl, ["n1"]).outcome == "success"


def executor_and_driver_retries_are_idempotent(h):
    h.add_nodes(h.node("n1"), h.node("n2"))
    pods = h.spark_pods("app-3", 1)
    for p in pods:
        h.schedule(p, ["n1", "n2"])
    assert h.predicate(h.args(pods[1], ["n1", "n2"])).outcome == (
        "success-already-bound"
    )
    assert h.predicate(h.args(pods[0], ["n1", "n2"])).ok


def gang_does_not_fit_creates_demand(h):
    h.add_nodes(h.node("n1"))
    pods = h.spark_pods("app-5", 100)
    assert h.schedule(pods[0], ["n1"]).outcome == "failure-fit"
    h.add_nodes(*(h.node(f"n{i}") for i in range(2, 15)))
    assert h.schedule(pods[0], [f"n{i}" for i in range(1, 15)]).ok


def fifo_earlier_driver_blocks_later_driver(h):
    h.add_nodes(h.node("n1"))
    big = h.spark_pods("app-old", 20)
    small = h.spark_pods("app-new", 1)
    h.add_pods(*big)
    assert h.schedule(big[0], ["n1"]).outcome == "failure-fit"
    assert h.schedule(small[0], ["n1"]).outcome == "failure-earlier-driver"


def fifo_age_gate_skips_young_drivers(h):
    gate = h.extender._config.fifo_config
    gate.enforce_after_pod_age_s = 3600.0
    h.add_nodes(h.node("n1"))
    big = h.spark_pods("app-old2", 20, ts=NOW - 10)  # young: skipped
    small = h.spark_pods("app-new2", 1, ts=NOW)
    h.add_pods(*big)
    assert not h.schedule(big[0], ["n1"]).ok
    assert h.schedule(small[0], ["n1"]).ok


def dynamic_allocation_soft_reservation_over_min(h):
    h.add_nodes(h.node("n1"))
    driver, exec1, exec2 = h.spark_pods("app-da", 2, dynamic=(1, 2))
    for p in (driver, exec1, exec2):
        assert h.schedule(p, ["n1"]).ok
    extra = h.spark_pods("app-da", 3, dynamic=(1, 2))[3]
    assert h.schedule(extra, ["n1"]).outcome == "failure-unbound"


def dynamic_allocation_compaction(h):
    h.add_nodes(h.node("n1"))
    driver, exec1, exec2 = h.spark_pods("app-da2", 2, dynamic=(1, 2))
    for p in (driver, exec1, exec2):
        h.schedule(p, ["n1"])
    h.delete_pod(exec1)  # the hard-slot executor dies
    h.schedule(h.spark_pods("probe", 0)[0], ["n1"])  # compaction runs


def fifo_mixed_queue(h):
    """tests/test_extender_scenarios.py `_run_fifo_scenario`."""
    nodes = [f"n{i}" for i in range(4)]
    h.add_nodes(*(h.node(n) for n in nodes))
    a = h.spark_pods("app-a", 2)
    h.schedule(a[0], nodes)
    b = h.spark_pods("app-b", 30)
    h.add_pods(b[0])
    c = h.spark_pods("app-c", 1)
    assert h.schedule(c[0], nodes).outcome == "failure-earlier-driver"
    h.delete_pod(b[0])
    assert h.schedule(c[0], nodes).ok
    for p in a[1:] + c[1:]:
        h.schedule(p, nodes)


SCENARIOS = {
    f.__name__: f
    for f in (
        gang_then_extra_executor,
        replace_reservation_after_termination,
        executor_and_driver_retries_are_idempotent,
        gang_does_not_fit_creates_demand,
        fifo_earlier_driver_blocks_later_driver,
        fifo_age_gate_skips_young_drivers,
        dynamic_allocation_soft_reservation_over_min,
        dynamic_allocation_compaction,
    )
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax(name):
    run_both(SCENARIOS[name])


@pytest.mark.parametrize("batched", [True, False])
def test_fifo_mixed_queue_matches_jax(batched):
    """`batched=False` is the sequential admission path: solo `pack` per
    earlier driver and `subtract_usage` between them."""
    jax_side, port_side = run_both(
        fifo_mixed_queue, binpack="tightly-pack", batched_admission=batched
    )
    if not batched:
        assert port_side.solver.last_solve_info["path"] == "reference"


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_all_strategies_end_to_end_match_jax(strategy):
    def scenario(h):
        h.add_nodes(h.node("n1", zone="zone1"), h.node("n2", zone="zone2"))
        for p in h.spark_pods(f"app-{strategy}", 3):
            assert h.schedule(p, ["n1", "n2"]).ok

    run_both(scenario, binpack=strategy)


def mixed_workload(h, seed, windows):
    """A seeded workload over three zones: driver windows (batched or one at
    a time), each admitted app's executors (some offered only a subset of
    the nodes, which reschedules them through the solo `pack`),
    dynamic-allocation extras, executor deaths and pod deletions."""
    rng = np.random.default_rng(seed)
    nodes = [f"n{i:02d}" for i in range(12)]
    h.add_nodes(*(
        h.node(n, zone=f"zone{i % 3}", cpu=str(int(rng.integers(4, 17))),
               mem=f"{int(rng.integers(4, 17))}Gi")
        for i, n in enumerate(nodes)
    ))
    apps = []
    for w in range(4):
        window = []
        for k in range(int(rng.integers(2, 5))):
            app = f"app-{w}-{k}"
            n_exec = int(rng.integers(1, 7))
            dyn = (n_exec, n_exec + 2) if rng.random() < 0.3 else None
            pods = h.spark_pods(app, n_exec + (2 if dyn else 0), dynamic=dyn,
                                exec_cpu=str(int(rng.integers(1, 3))))
            h.add_pods(pods[0])
            window.append(pods)
        arglist = [h.args(p[0], nodes) for p in window]
        if windows:
            results = h.batch(arglist)
        else:
            results = [h.predicate(a) for a in arglist]
        for pods, res in zip(window, results):
            h.bind(pods[0], res)
            if res.ok:
                apps.append(pods)
        # The admitted apps' executors, extras included.
        for pods in apps[-len(window):]:
            for p in pods[1:]:
                offered = nodes
                if rng.random() < 0.3:
                    offered = [n for n in nodes if rng.random() < 0.5]
                h.schedule(p, offered)
        if apps and rng.random() < 0.5:
            victim = apps[int(rng.integers(0, len(apps)))]
            h.terminate_pod(victim[-1])
    done = apps[0]
    for p in done:
        h.delete_pod(p)
    h.schedule(h.spark_pods("late", 2)[0], nodes)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("windows", [True, False])
def test_mixed_workload_matches_jax(strategy, windows):
    run_both(
        lambda h: mixed_workload(h, STRATEGIES.index(strategy), windows),
        binpack=strategy,
    )


# ------------------------------------- tests/test_window_serving.py:254-352


def _predicate_batch_vs_sequential(h_seq, h_win, strategy, fifo):
    names = [f"n{i}" for i in range(6)]
    for h in (h_seq, h_win):
        h.add_nodes(*(h.node(n, zone=f"zone{i % 2}") for i, n in enumerate(names)))
    seq = [h_seq.spark_pods(f"w-{strategy}-{fifo}-{i}", 4)[0] for i in range(6)]
    win = [h_win.spark_pods(f"w-{strategy}-{fifo}-{i}", 4)[0] for i in range(6)]
    h_seq.add_pods(*seq)
    h_win.add_pods(*win)
    seq_res = [h_seq.predicate(h_seq.args(d, names)) for d in seq]
    win_res = h_win.batch([h_win.args(d, names) for d in win])
    return seq_res, win_res


def _slot_nodes(h):
    """{app: {reservation slot: node}} of the hard reservations."""
    return {
        rr.name: {k: v.node for k, v in rr.spec.reservations.items()}
        for rr in h.backend.list("resourcereservations")
    }


@pytest.mark.parametrize("strategy", ["tightly-pack", "az-aware-tightly-pack"])
@pytest.mark.parametrize("fifo", [True, False])
def test_predicate_batch_matches_sequential_and_jax(strategy, fifo):
    """The port's predicate_batch equals its own sequential predicates, and
    both equal the JAX package's."""
    out = {}
    for root in (JAX, PORT):
        h_seq = Side(root, binpack=strategy, fifo=fifo)
        h_win = Side(root, binpack=strategy, fifo=fifo)
        seq, win = _predicate_batch_vs_sequential(h_seq, h_win, strategy, fifo)
        assert [canon(r) for r in seq] == [canon(r) for r in win]
        assert _slot_nodes(h_seq) == _slot_nodes(h_win)
        out[root] = (h_seq.log, h_win.log)
    assert out[PORT] == out[JAX]


def test_predicate_batch_mixed_roles_matches_jax():
    """A window mixing an idempotent driver retry, fresh drivers, an
    executor of a reserved app, a non-spark pod and a duplicate driver."""

    def scenario(h):
        names = [f"n{i}" for i in range(8)]
        h.add_nodes(*(h.node(n, zone=f"zone{i % 2}") for i, n in enumerate(names)))
        first = h.spark_pods("mix-first", 2)
        h.schedule(first[0], names)
        fresh = [h.spark_pods(f"mix-{i}", 2) for i in range(2)]
        batch = [
            h.args(first[0], names),
            h.args(fresh[0][0], names),
            h.args(first[1], names),
            h.args(fresh[1][0], names),
            h.args(h.plain_pod("plain-pod"), names),
            h.args(fresh[1][0], names),
        ]
        for a in batch:
            h.add_pods(a.pod)
        res = h.batch(batch)
        assert res[4].outcome == "failure-non-spark-pod"
        assert res[3].node_names == res[5].node_names

    run_both(scenario, binpack="tightly-pack")


