"""Device-fault tolerance of the port, held to the JAX package on the CPU.

- The injector and the degraded-mode controller: the cases of
  tests/test_faults.py (same seed gives the same schedule; `at`, `every`,
  `partition`; the device surface raises slot-fatal; shim composition and
  uninstall; backend, lease and WAL surfaces; plan round trip; the
  controller's engage, clear and counts; fault telemetry), each run on
  both packages with the results compared.
- The classifier's taxonomy, with the CUDA device-fault codes the port's
  kernel wrappers raise (`CudaDeviceFault`: an uncorrectable ECC error, a
  device unavailable) and those that stay programming errors, the faults
  a wrong kernel raises (an illegal address, a launch failure) included.
- Only a classified device fault engages degraded mode: a wrapper that
  raises a build failure, a launch-configuration error or an illegal
  address propagates.
- The host greedy (core/greedy.py, core/fallback.py): the port's
  `GreedyFallbackSolver.window_decisions` against the JAX package's and
  against the port's own row walk over all six strategies, and a
  single-AZ near tie where the port's greedy decides as its kernels do.

Tolerance: none.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest

from tests.test_torch_extender import JAX, PORT, canon

PKGS = (JAX, PORT)


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _plan(pkg, **spec):
    f = mod(pkg, "faults")
    return f.FaultPlan(seed=1, specs=[f.FaultSpec(**spec)])


def both(fn):
    """fn(pkg) on both packages; the two results must be equal."""
    out = [fn(pkg) for pkg in PKGS]
    assert canon(out[1]) == canon(out[0])
    return out[1]


# ------------------------------------------------------------- the injector


def test_injector_same_seed_same_schedule():
    surfaces = (
        ["backend.resourcereservations.create"] * 10
        + ["device.dispatch"] * 10
        + ["backend.demands.update"] * 10
    )

    def run(pkg, seed=42):
        f = mod(pkg, "faults")
        plan = f.FaultPlan(
            seed=seed, name="replay",
            specs=[
                f.FaultSpec(surface="backend.*", mode="error", p=0.3),
                f.FaultSpec(surface="device.*", mode="error", p=0.5),
            ],
        )
        inj = f.FaultInjector(plan)
        for s in surfaces:
            try:
                inj.fire(s)
            except f.InjectedFault:
                pass
        return inj.schedule()

    first = both(run)
    assert first and run(PORT) == first
    assert both(lambda pkg: run(pkg, seed=43)) != first


def test_injector_at_every_limit_partition_triggers():
    def run(pkg):
        f = mod(pkg, "faults")
        out = []
        for spec, n in (
            (dict(surface="a.*", at=[1, 3]), 5),
            (dict(surface="a.*", every=3, limit=2), 10),
            (dict(surface="a.*", mode="partition", start=2, length=3), 8),
        ):
            inj = f.FaultInjector(_plan(pkg, **spec))
            fired = []
            for i in range(n):
                try:
                    inj.fire("a.x")
                except f.InjectedFault:
                    fired.append(i)
            out.append(fired)
        return out

    assert both(run) == [[1, 3], [0, 3], [2, 3, 4]]


def test_injector_latency_mode_sleeps_injected_duration():
    def run(pkg):
        slept: list = []
        inj = mod(pkg, "faults").FaultInjector(
            _plan(pkg, surface="backend.*", mode="latency", latency_ms=25.0),
            sleep=slept.append,
        )
        inj.fire("backend.nodes.update")
        return slept, inj.schedule()

    slept, schedule = both(run)
    assert slept == [0.025] and schedule[0][3] == "latency"


def test_injector_device_surface_raises_slot_fatal():
    def run(pkg):
        f = mod(pkg, "faults")
        inj = f.FaultInjector(_plan(pkg, surface="device.*", limit=1))
        with pytest.raises(f.DeviceFaultError) as ei:
            inj.fire("device.d2h")
        inj2 = f.FaultInjector(_plan(pkg, surface="wal.*", limit=1))
        with pytest.raises(f.InjectedFault) as ei2:
            inj2.fire("wal.append")
        return (
            f.classify_slot_failure(ei.value),
            isinstance(ei2.value, f.DeviceFaultError),
            ei.value.surface,
        )

    assert both(run) == (True, False, "device.d2h")


def test_backend_hook_returns_exception_and_install_nests():
    def run(pkg):
        f = mod(pkg, "faults")
        inj = f.FaultInjector(
            _plan(pkg, surface="backend.resourcereservations.create", limit=1)
        )
        hook = inj.backend_hook()
        first = type(hook("resourcereservations", "create", object())).__name__
        rest = (
            hook("resourcereservations", "create", object()),
            hook("pods", "update", object()),
        )

        class StubBackend:
            fault_injector = None

        b = StubBackend()
        prior_calls: list = []
        b.fault_injector = lambda *a: prior_calls.append(a) or None
        outer = f.FaultInjector(_plan(pkg, surface="backend.*", p=0.0))
        outer.install_backend(b)
        inner = f.FaultInjector(_plan(pkg, surface="backend.*", p=0.0))
        with inner:
            inner.install_backend(b)
            b.fault_injector("pods", "create", None)
        b.fault_injector("pods", "create", None)
        outer.uninstall()
        b.fault_injector("pods", "create", None)
        return (first, rest, inner.counts, outer.counts, len(prior_calls))

    first, rest, inner, outer, prior = both(run)
    assert first == "InjectedFault" and rest == (None, None)
    assert inner == outer == {"backend.pods.create": 1} and prior == 1


def test_device_shim_composes_with_inner_and_uninstall_restores():
    def run(pkg):
        f = mod(pkg, "faults")
        solver_mod = mod(pkg, "core.solver")
        prior = solver_mod._DEVICE_SHIM
        inner_events: list = []
        inj = f.FaultInjector(_plan(pkg, surface="device.dispatch", at=[0]))
        try:
            inj.install_device(inner=inner_events.append)
            with pytest.raises(f.DeviceFaultError):
                solver_mod._shim("dispatch")
            solver_mod._shim("h2d")
            counts = dict(inj.counts)
        finally:
            inj.uninstall()
        return inner_events, counts, solver_mod._DEVICE_SHIM is prior

    assert both(run) == (
        ["h2d"], {"device.dispatch": 1, "device.h2d": 1}, True
    )


def test_rtt_shim_counts_boundaries_and_uninstalls():
    def run(pkg):
        rtt_mod = mod(pkg, "testing.rtt_shim")
        solver_mod = mod(pkg, "core.solver")
        prior = solver_mod._DEVICE_SHIM
        with rtt_mod.SimulatedRTT(0.0) as rtt:
            for kind in ("h2d", "dispatch", "d2h", "h2d"):
                solver_mod._shim(kind)
            counts = dict(rtt.counts)
        return counts, solver_mod._DEVICE_SHIM is prior

    assert both(run) == ({"h2d": 2, "dispatch": 1, "d2h": 1}, True)


def test_faulty_lease_store_and_wal_surfaces():
    def run(pkg):
        f = mod(pkg, "faults")

        class StubStore:
            def read(self):
                return "record"

            def compare_and_swap(self, expect, record):
                return True

        inj = f.FaultInjector(_plan(pkg, surface="lease.write", limit=1))
        store = f.FaultyLeaseStore(StubStore(), inj)
        out = [store.read()]
        with pytest.raises(f.InjectedFault):
            store.compare_and_swap(None, "r")
        out.append(store.compare_and_swap(None, "r"))

        class StubWal:
            wal_fault_hook = None

        wal = StubWal()
        winj = f.FaultInjector(_plan(pkg, surface="wal.append.*", at=[1]))
        winj.install_wal(wal)
        wal.wal_fault_hook("append", {"kind": "pods"})
        with pytest.raises(f.InjectedFault):
            wal.wal_fault_hook("append")
        wal.wal_fault_hook("fsync")
        winj.uninstall()
        return out, inj.counts, winj.counts, wal.wal_fault_hook

    out, lease, wal, hook = both(run)
    assert out == ["record", True]
    assert lease == {"lease.read": 1, "lease.write": 2}
    assert wal == {"wal.append.pods": 1, "wal.append.crd": 1,
                   "wal.fsync.crd": 1}
    assert hook is None


def test_async_client_hook_fires_kube_write_surface():
    def run(pkg):
        f = mod(pkg, "faults")
        inj = f.FaultInjector(_plan(pkg, surface="kube.write.*", at=[0]))

        class Client:
            fault_hook = None

        class Req:
            class type:
                value = "create"

        c = Client()
        inj.install_async_client(c)
        with pytest.raises(f.InjectedFault):
            c.fault_hook(Req())
        c.fault_hook(Req())
        inj.uninstall()
        return inj.counts, c.fault_hook

    assert both(run) == ({"kube.write.create": 2}, None)


def test_plan_from_dict_round_trip():
    def run(pkg):
        plan = mod(pkg, "faults").FaultPlan.from_dict(
            {
                "seed": 9,
                "name": "matrix-backend",
                "specs": [
                    {"surface": "backend.*", "mode": "latency",
                     "latency-ms": 5.0, "p": 0.2},
                    {"surface": "wal.append", "at": [4]},
                ],
            }
        )
        return plan

    plan = both(run)
    assert plan.seed == 9 and plan.name == "matrix-backend"
    assert plan.specs[0].latency_ms == 5.0 and plan.specs[1].at == [4]


def test_injector_on_fire_publishes_fault_telemetry():
    def run(pkg):
        registry = mod(pkg, "metrics").MetricRegistry()
        tel_mod = mod(pkg, "observability.telemetry")
        tel = tel_mod.RetryTelemetry(registry)
        f = mod(pkg, "faults")
        inj = f.FaultInjector(
            _plan(pkg, surface="backend.*", limit=2), on_fire=tel.fault_hook()
        )
        for _ in range(3):
            try:
                inj.fire("backend.resourcereservations.create")
            except f.InjectedFault:
                pass
        return registry.counter(
            tel_mod.FAULTS_INJECTED,
            surface="backend.resourcereservations.create", action="error",
        ).value

    assert both(run) == 2


# --------------------------------------------------------------- degraded


def test_degraded_controller_engage_clear_and_counts():
    def run(pkg):
        now = {"t": 100.0}
        changes: list = []
        d = mod(pkg, "faults").DegradedModeController(
            policy="greedy", clock=lambda: now["t"], on_change=changes.append
        )
        out = [d.active, d.sheds]
        d.engage("slot died")
        d.engage("slot died again")
        out += [d.active, d.engagements, d.since, d.reason]
        d.on_fallback_decision(3)
        d.on_shed(2)
        d.clear()
        d.clear()
        shed = mod(pkg, "faults").DegradedModeController(
            policy="shed", retry_after_s=7.0
        )
        return out, changes, d.snapshot(), shed.sheds, shed.snapshot()

    out, changes, snap, sheds, shed_snap = both(run)
    assert out == [False, False, True, 1, 100.0, "slot died again"]
    assert changes == [True, False] and sheds
    assert snap["engagements"] == 1 and snap["fallback_decisions"] == 3
    assert snap["shed_requests"] == 2 and snap["since"] is None
    assert shed_snap["retry_after_s"] == 7.0


@pytest.mark.parametrize("pkg", PKGS)
def test_degraded_controller_rejects_unknown_policy(pkg):
    with pytest.raises(ValueError, match="degraded-mode policy"):
        mod(pkg, "faults").DegradedModeController(policy="panic")


# ----------------------------------------------------------- the classifier


def test_classify_slot_failure_taxonomy():
    def run(pkg):
        f = mod(pkg, "faults")

        class XlaRuntimeError(RuntimeError):
            pass

        return [
            f.classify_slot_failure(e)
            for e in (
                f.DeviceFaultError("device.d2h"),
                ConnectionError("link drop"),
                TimeoutError("rpc deadline"),
                OSError("broken pipe"),
                XlaRuntimeError("device failed"),
                TypeError("programming error"),
                ValueError("bad shape"),
                f.InjectedFault("backend.pods.create"),
                RuntimeError("CUDA build failed: nvcc exit 1"),
            )
        ]

    assert both(run) == [True] * 5 + [False] * 4


DEVICE_CODES = {
    214: "cudaErrorECCUncorrectable",
    46: "cudaErrorDevicesUnavailable",
}
# What a wrong kernel raises: propagated, so that the host greedy never
# hides a faulty kernel.
KERNEL_CODES = {
    700: ("cudaErrorIllegalAddress", "an illegal memory access was encountered"),
    719: ("cudaErrorLaunchFailure", "unspecified launch failure"),
    714: ("cudaErrorHardwareStackError", "hardware stack error"),
    715: ("cudaErrorIllegalInstruction", "an illegal instruction was encountered"),
    716: ("cudaErrorMisalignedAddress", "misaligned address"),
    702: ("cudaErrorLaunchTimeout", "the launch timed out and was terminated"),
}
PROGRAMMING_CODES = {
    1: "cudaErrorInvalidValue",
    9: "cudaErrorInvalidConfiguration",
    701: "cudaErrorLaunchOutOfResources",
    209: "cudaErrorNoKernelImageForDevice",
}


@pytest.mark.parametrize(
    "code", sorted(DEVICE_CODES) + sorted(KERNEL_CODES) + sorted(PROGRAMMING_CODES)
)
def test_cuda_codes_classify_device_faults_only(code):
    from spark_scheduler_tpu_torch.faults.errors import (
        CUDA_DEVICE_FAULT_CODES,
        CudaDeviceFault,
        classify_slot_failure,
        cuda_launch_error,
    )

    exc = cuda_launch_error(code, "window row-walk kernel launch", "detail")
    device = code in DEVICE_CODES
    assert isinstance(exc, CudaDeviceFault) == device
    assert classify_slot_failure(exc) == device
    if device:
        assert exc.code == code
        assert CUDA_DEVICE_FAULT_CODES[code][0] == DEVICE_CODES[code]
        # torch's own runtime error carrying the code's string, or its name.
        text = CUDA_DEVICE_FAULT_CODES[code][1]
        assert classify_slot_failure(RuntimeError(f"CUDA error: {text}"))
        assert classify_slot_failure(
            RuntimeError(f"CUDA error: {DEVICE_CODES[code]}")
        )
    elif code in KERNEL_CODES:
        assert code not in CUDA_DEVICE_FAULT_CODES
        name, text = KERNEL_CODES[code]
        # torch raises its asynchronous kernel faults at the next sync.
        assert not classify_slot_failure(RuntimeError(f"CUDA error: {text}"))
        assert not classify_slot_failure(RuntimeError(f"CUDA error: {name}"))
    else:
        assert not classify_slot_failure(
            RuntimeError(f"CUDA error: {PROGRAMMING_CODES[code]}")
        )
    # A device-fault string outside a CUDA error is not a device fault.
    assert not classify_slot_failure(
        RuntimeError("uncorrectable ECC error encountered in a parser")
    )


# ------------------------------------ only a device fault engages degraded


def _cpu_solver(**kw):
    from spark_scheduler_tpu_torch.core.solver import PlacementSolver
    from spark_scheduler_tpu_torch.faults import DegradedModeController

    s = PlacementSolver(device="cpu", **kw)
    s.degraded = DegradedModeController(policy="greedy")
    return s


def _small_cluster(n=12):
    from spark_scheduler_tpu_torch.models.kube import ZONE_LABEL, Node
    from spark_scheduler_tpu_torch.models.resources import Resources

    return [
        Node(
            name=f"n{i:02d}",
            allocatable=Resources.from_quantities("8", "8Gi"),
            labels={ZONE_LABEL: f"z{i % 2}"},
        )
        for i in range(n)
    ]


def _requests(nodes, k=3):
    from spark_scheduler_tpu_torch.core.solver import WindowRequest
    from spark_scheduler_tpu_torch.models.resources import Resources

    one = Resources.from_quantities("1", "1Gi")
    names = [n.name for n in nodes]
    return [
        WindowRequest(rows=[(one, one, 2 + i, False)],
                      driver_candidate_names=names)
        for i in range(k)
    ]


def _raiser(exc):
    def f(*_a, **_k):
        raise exc

    return f


def _wrapper_errors():
    from spark_scheduler_tpu_torch.faults.errors import cuda_launch_error

    return {
        "ecc": cuda_launch_error(214, "launch", "uncorrectable ECC error"),
        "torch-ecc": RuntimeError("CUDA error: uncorrectable ECC error encountered"),
        "illegal-address": cuda_launch_error(700, "launch", "illegal address"),
        "torch-illegal-address": RuntimeError(
            "CUDA error: an illegal memory access was encountered"
        ),
        "launch-failure": cuda_launch_error(719, "launch", "launch failure"),
        "build-failure": RuntimeError("CUDA build failed: window_kernel (nvcc exit 1)"),
        "invalid-configuration": cuda_launch_error(9, "launch", "invalid configuration"),
        "out-of-resources": cuda_launch_error(701, "launch", "too many resources"),
        "no-kernel-image": cuda_launch_error(209, "launch", "no kernel image"),
        "invalid-value": cuda_launch_error(1, "launch", "invalid argument"),
    }


@pytest.mark.parametrize("kind", sorted(_wrapper_errors()))
def test_only_a_device_fault_engages_degraded_mode(kind, monkeypatch):
    """A wrapper raising each kind of error from the row walk, on a window
    and on a solo pack: a device fault serves the host greedy (equal to
    the healthy row walk's decisions); a build failure, a launch the
    configuration refuses, or an illegal address or launch failure (what a
    wrong kernel raises) raises, and degraded mode never engages."""
    from spark_scheduler_tpu_torch.core import solver as solver_mod
    from spark_scheduler_tpu_torch.models.resources import Resources

    exc = _wrapper_errors()[kind]
    device_fault = kind.endswith("ecc")
    nodes = _small_cluster()
    healthy = _cpu_solver()
    want = healthy.pack_window(
        "tightly-pack", healthy.build_tensors_pipelined(nodes, {}, {}),
        _requests(nodes),
    )
    one = Resources.from_quantities("1", "1Gi")
    want_solo = healthy.pack(
        "tightly-pack", healthy.build_tensors(nodes, {}, {}), one, one, 3,
        [n.name for n in nodes],
    )
    s = _cpu_solver()
    t = s.build_tensors_pipelined(nodes, {}, {})
    monkeypatch.setattr(solver_mod, "window_pack", _raiser(exc))
    if device_fault:
        got = s.pack_window("tightly-pack", t, _requests(nodes))
        assert canon(got) == canon(want)
        assert s.degraded.active and s.degraded.fallback_decisions == 3
        assert s.last_solve_info["path"] == "greedy-fallback"
        solo = s.pack("tightly-pack", s.build_tensors(nodes, {}, {}), one,
                      one, 3, [n.name for n in nodes])
        assert canon(solo) == canon(want_solo)
        assert s.degraded.fallback_decisions == 4
        monkeypatch.undo()
        # The card answers again: the next solve clears degraded mode.
        s.pack_window("tightly-pack", s.build_tensors_pipelined(nodes, {}, {}),
                      _requests(nodes))
        assert not s.degraded.active
    else:
        with pytest.raises(RuntimeError):
            s.pack_window("tightly-pack", t, _requests(nodes))
        with pytest.raises(RuntimeError):
            s.pack("tightly-pack", s.build_tensors(nodes, {}, {}), one, one,
                   3, [n.name for n in nodes])
        assert not s.degraded.active and s.degraded.engagements == 0


def test_probe_wrong_values_raise_and_faults_keep_the_slot_out(monkeypatch):
    """The quarantine probe is the probe kernel on the slot's device: a
    classified fault keeps the slot quarantined; wrong values or an
    illegal address raise (a programming error, never a reinstatement)."""
    import torch

    from spark_scheduler_tpu_torch.core import solver as solver_mod
    from spark_scheduler_tpu_torch.faults.errors import cuda_launch_error

    s = _cpu_solver(pool_devices=["cpu", "cpu"])
    slot = s._pool.slots[1]
    s._quarantine_slot(slot, RuntimeError("test"))
    monkeypatch.setattr(
        solver_mod, "probe_add_one",
        _raiser(cuda_launch_error(214, "probe kernel launch", "ECC error")),
    )
    assert s.probe_quarantined(force=True) == 0
    assert s.device_health()["quarantined"] == [slot.label]
    monkeypatch.setattr(
        solver_mod, "probe_add_one",
        _raiser(cuda_launch_error(700, "probe kernel launch", "illegal address")),
    )
    with pytest.raises(RuntimeError, match="cudaError 700"):
        s.probe_quarantined(force=True)
    assert s.device_health()["quarantined"] == [slot.label]
    monkeypatch.setattr(solver_mod, "probe_add_one", lambda x: x + 2)
    with pytest.raises(RuntimeError, match="wrong values"):
        s.probe_quarantined(force=True)
    monkeypatch.setattr(solver_mod, "probe_add_one", lambda x: x + 1)
    assert s.probe_quarantined(force=True) == 1
    assert s.device_health() == {"slots": 2, "healthy": 2, "quarantined": []}
    assert torch.equal(solver_mod.probe_add_one(torch.zeros(2, dtype=torch.int32)),
                       torch.ones(2, dtype=torch.int32))


# --------------------------------------------------------- the host greedy

STRATEGIES = (
    "tightly-pack",
    "distribute-evenly",
    "minimal-fragmentation",
    "single-az-tightly-pack",
    "single-az-minimal-fragmentation",
    "az-aware-tightly-pack",
)


def _greedy_world(seed, max_count=7):
    """A seeded cluster (4 zones, mixed shapes, prior usage, a cordoned and
    a not-ready node) and two windows of FIFO requests with earlier
    drivers (gangs of 0 to `max_count` - 1 executors), in a form both
    packages build."""
    rng = np.random.default_rng(seed)
    n = 48
    nodes = []
    for i in range(n):
        nodes.append(dict(
            name=f"g{i:03d}",
            cpu=str(int(rng.choice([4, 8, 16]))),
            mem=f"{int(rng.choice([8, 16, 32]))}Gi",
            gpu=str(int(rng.choice([0, 0, 0, 2]))),
            zone=f"zone{int(rng.integers(0, 4))}",
            unschedulable=(i == 5), ready=(i != 7),
        ))
    usage = {
        f"g{i:03d}": (f"{int(rng.integers(0, 4))}", f"{int(rng.integers(0, 6))}Gi")
        for i in rng.choice(n, 20, replace=False)
    }
    windows = []
    for _ in range(2):
        reqs = []
        for _ in range(6):
            rows = []
            for _ in range(int(rng.integers(1, 4))):
                rows.append((
                    (f"{int(rng.integers(1, 3))}", f"{int(rng.integers(1, 4))}Gi"),
                    (f"{int(rng.integers(1, 4))}", f"{int(rng.integers(1, 6))}Gi"),
                    int(rng.integers(0, max_count)),
                    bool(rng.random() < 0.3),
                ))
            reqs.append(rows)
        windows.append(reqs)
    return nodes, usage, windows


def _build(pkg, world, strategy):
    """(solver, host view, requests per window) of one package."""
    nodes_d, usage_d, windows = world
    kube = mod(pkg, "models.kube")
    res = mod(pkg, "models.resources").Resources
    nodes = [
        kube.Node(
            name=d["name"],
            allocatable=res.from_quantities(d["cpu"], d["mem"], d["gpu"]),
            labels={kube.ZONE_LABEL: d["zone"]},
            unschedulable=d["unschedulable"], ready=d["ready"],
        )
        for d in nodes_d
    ]
    usage = {k: res.from_quantities(*v) for k, v in usage_d.items()}
    sm = mod(pkg, "core.solver")
    solver = (
        sm.PlacementSolver(device="cpu") if pkg == PORT
        else sm.PlacementSolver(use_native=False)
    )
    tensors = solver.build_tensors(nodes, usage, {})
    names = [n.name for n in nodes]
    reqs = [
        [
            sm.WindowRequest(
                rows=[(res.from_quantities(*d), res.from_quantities(*e), c, s)
                      for d, e, c, s in rows],
                driver_candidate_names=names,
            )
            for rows in window
        ]
        for window in windows
    ]
    return solver, tensors, reqs


def _greedy_decisions(pkg, world, strategy):
    from spark_scheduler_tpu_torch.models.cluster import host_view

    solver, tensors, reqs = _build(pkg, world, strategy)
    host = host_view(tensors) if pkg == PORT else mod(pkg, "core.solver")._host_view(tensors)
    base = np.asarray(host.available).astype(np.int64)
    out = []
    for window in reqs:
        decisions, placements = solver.fallback.window_decisions(
            strategy, host, base, window
        )
        base = base - placements
        out.append((decisions, placements.tolist()))
    return out


def _walk_decisions(world, strategy):
    """The port's row walk over the world's windows, each window's
    placements threaded into the next one's base."""
    import dataclasses as _dc

    from spark_scheduler_tpu_torch.models.cluster import host_view

    solver, tensors, reqs = _build(PORT, world, strategy)
    walk = []
    for window in reqs:
        handle = solver.pack_window_dispatch(strategy, tensors, window)
        walk.append(solver.pack_window_fetch(handle))
        host = host_view(tensors)
        rows, amounts = handle.window_placements[0]
        avail = host.available.astype(np.int64)
        avail[rows] -= amounts
        tensors = solver._upload(_dc.replace(host, available=avail.astype(np.int32)))
    return walk


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_greedy_wide_gangs_match_the_row_walk(strategy):
    """Gangs up to 23 executors: the efficiencies the greedy reports sum
    over the dispatch's executor slots as the row walk's blob holds them,
    so they round as the kernels' do (a mean over 8 or more entries sums
    in an order that depends on the slot count)."""
    world = _greedy_world(5, max_count=24)
    got = _greedy_decisions(PORT, world, strategy)
    walk = _walk_decisions(world, strategy)
    assert canon([d for d, _ in got]) == canon(walk)
    assert max(len(d.packing.executor_nodes) for w in walk for d in w) >= 8


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("seed", [3, 17])
def test_greedy_window_decisions_match_the_row_walk_and_jax(strategy, seed):
    """The port's greedy equals the port's row walk (both windows solved
    back to back on one carry) on every strategy, and the JAX package's
    greedy on every strategy its greedy serves (it has no entry for
    az-aware-tightly-pack and raises KeyError there)."""
    world = _greedy_world(seed)
    got = _greedy_decisions(PORT, world, strategy)
    walk = _walk_decisions(world, strategy)
    assert canon([d for d, _ in got]) == canon(walk)
    assert any(d.admitted for w in walk for d in w)
    if strategy == "az-aware-tightly-pack":
        with pytest.raises(KeyError):
            _greedy_decisions(JAX, world, strategy)
        return
    want = _greedy_decisions(JAX, world, strategy)
    assert canon(got) == canon(want)


def test_single_az_near_tie_decides_as_the_kernels():
    """Two single-node zones whose float64 zone scores differ by 2^-27 and
    whose float32 scores tie: the row walk (float32 scores, ties to the
    zone appearing first) and the port's greedy put the gang in zone zb;
    the JAX package's greedy compares float64 means and picks za."""
    from spark_scheduler_tpu_torch.core.solver import PlacementSolver, WindowRequest
    from spark_scheduler_tpu_torch.models.kube import ZONE_LABEL, Node
    from spark_scheduler_tpu_torch.models.resources import Resources

    sched_a, sched_b = 1 << 27, 1 << 26  # KiB: 128 Gi and 64 Gi
    r = 1 << 21  # driver + executor memory, KiB
    used_a = (1 << 26) + 1 - r  # reserved after the gang: 2^26 + 1
    used_b = (1 << 25) - r  # reserved after the gang: 2^25
    nodes = [
        Node(name="a0", allocatable=Resources(16000, sched_a, 0),
             labels={ZONE_LABEL: "za"}),
        Node(name="b0", allocatable=Resources(16000, sched_b, 0),
             labels={ZONE_LABEL: "zb"}),
    ]
    usage = {"a0": Resources(0, sched_a - ((1 << 27) + r - (1 << 26) - 1), 0),
             "b0": Resources(0, sched_b - ((1 << 26) + r - (1 << 25)), 0)}
    assert usage["a0"].mem_kib == used_a and usage["b0"].mem_kib == used_b
    gig = Resources(1000, 1 << 20, 0)
    req = [WindowRequest(rows=[(gig, gig, 1, False)],
                         driver_candidate_names=["a0", "b0"])]
    for strategy in ("single-az-tightly-pack", "az-aware-tightly-pack"):
        s = PlacementSolver(device="cpu")
        t = s.build_tensors(nodes, usage, {})
        walk = s.pack_window(strategy, t, req)
        greedy, _ = s.fallback.window_decisions(
            strategy, t.host, t.host.available.astype(np.int64), req
        )
        assert walk[0].packing.driver_node == "b0"
        assert canon(greedy) == canon(walk)
    from spark_scheduler_tpu.core.solver import (
        PlacementSolver as JaxSolver,
        WindowRequest as JaxRequest,
        _host_view,
    )
    from spark_scheduler_tpu.models.kube import Node as JNode
    from spark_scheduler_tpu.models.resources import Resources as JRes

    js = JaxSolver(use_native=False)
    jt = js.build_tensors(
        [JNode(name=n.name, allocatable=JRes(*n.allocatable.as_tuple()),
               labels=dict(n.labels)) for n in nodes],
        {k: JRes(*v.as_tuple()) for k, v in usage.items()}, {},
    )
    jgig = JRes(1000, 1 << 20, 0)
    jh = _host_view(jt)
    jax_greedy, _ = js.fallback.window_decisions(
        "single-az-tightly-pack", jh, np.asarray(jh.available).astype(np.int64),
        [JaxRequest(rows=[(jgig, jgig, 1, False)],
                    driver_candidate_names=["a0", "b0"])],
    )
    assert jax_greedy[0].packing.driver_node == "a0"


@pytest.mark.parametrize("how", ["nvcc-missing", "nvcc-fails", "load-fails"])
def test_kernel_build_and_load_failures_are_not_device_faults(
    how, monkeypatch, tmp_path
):
    """A kernel library that cannot be built or loaded raises a
    RuntimeError the classifier does not count as a device fault (an
    OSError would be: a build must never engage degraded mode)."""
    import ctypes

    from spark_scheduler_tpu_torch.faults.errors import classify_slot_failure
    from spark_scheduler_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(
        _build, "library_path", lambda name: tmp_path / "build" / f"lib{name}.so"
    )
    if how == "nvcc-missing":
        monkeypatch.setattr(_build, "nvcc_path", lambda: str(tmp_path / "absent"))
    else:
        # A fake nvcc: exits 2, or writes every "-o" target and exits 0.
        fake = tmp_path / "nvcc"
        fake.write_text(
            "#!/bin/sh\n"
            + ("exit 2\n" if how == "nvcc-fails" else
               'while [ $# -gt 0 ]; do if [ "$1" = "-o" ]; then : > "$2"; fi; '
               "shift; done\n")
        )
        fake.chmod(0o755)
        monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    if how == "load-fails":
        def refuse(path):
            raise OSError(f"{path}: invalid ELF header")

        monkeypatch.setattr(ctypes, "CDLL", refuse)
    with pytest.raises(RuntimeError, match="CUDA (build|library load) failed") as ei:
        _build.load_library("probe")
    assert not isinstance(ei.value, OSError)
    assert not classify_slot_failure(ei.value)
