"""Import hygiene and the device contract of the PyTorch port.

The port must import and build with `jax`, `jaxlib` and the JAX package
blocked, and its entry points must ask for CUDA unless told otherwise: on a
machine without a card, `PlacementSolver()` raises instead of running on the
CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "spark_scheduler_tpu_torch"

_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "spark_scheduler_tpu")


class Refuse:
    def find_spec(self, name, path=None, target=None):
        for b in BLOCKED:
            if name == b or name.startswith(b + "."):
                raise ImportError(f"blocked import: {name}")
        return None


sys.meta_path.insert(0, Refuse())
import spark_scheduler_tpu_torch as pkg

mods = [pkg.__name__]
for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(info.name)
    mods.append(info.name)
leaked = [m for m in sys.modules
          if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
assert not leaked, leaked
print(len(mods))
"""


def _port_modules():
    return sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in PORT.rglob("*.py")
        if p.name != "__init__.py"
    )


def test_port_imports_with_jax_blocked():
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    # Every module file of the port was imported (plus the package inits).
    assert int(out.stdout.strip()) >= len(_port_modules())


DURABLE_AND_FAILOVER = (
    "spark_scheduler_tpu_torch.kube.apiserver",
    "spark_scheduler_tpu_torch.kube.reflector",
    "spark_scheduler_tpu_torch.kube.backend",
    "spark_scheduler_tpu_torch.store.durable",
    "spark_scheduler_tpu_torch.core.membership",
    "spark_scheduler_tpu_torch.ha.lease",
    "spark_scheduler_tpu_torch.ha.fencing",
    "spark_scheduler_tpu_torch.ha.shard",
    "spark_scheduler_tpu_torch.ha.standby",
    "spark_scheduler_tpu_torch.ha.replica",
)


def test_durable_and_failover_modules_import_with_jax_blocked():
    """The apiserver, WAL and HA modules are the port's own copies: each
    imports, with its lazy imports run, while jax and the JAX package are
    refused."""
    assert set(DURABLE_AND_FAILOVER) <= set(_port_modules())
    code = _BLOCKED_IMPORT.split("import spark_scheduler_tpu_torch as pkg")[0] + (
        "import importlib\n"
        f"for name in {DURABLE_AND_FAILOVER!r}:\n"
        "    importlib.import_module(name)\n"
        "from spark_scheduler_tpu_torch.kube import FakeKubeAPIServer\n"
        "from spark_scheduler_tpu_torch.store.durable import _lease_from_record\n"
        "from spark_scheduler_tpu_torch.ha.replica import build_replica\n"
        "api = FakeKubeAPIServer()\n"
        "api._server.server_close()\n"
        "_lease_from_record({'holder': 'a', 'epoch': 1})\n"
        "leaked = [m for m in sys.modules\n"
        "          if any(m == b or m.startswith(b + '.') for b in BLOCKED)]\n"
        "assert not leaked, leaked\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


FUSED_AND_BATCHED = (
    "spark_scheduler_tpu_torch.ops.packing",
    "spark_scheduler_tpu_torch.ops.batched",
    "spark_scheduler_tpu_torch.ops.efficiency",
    "spark_scheduler_tpu_torch.core.solver",
    "spark_scheduler_tpu_torch.server.http",
)


def test_fused_and_batched_modules_run_with_jax_blocked():
    """The closed-form packing, the batched engine and the fused dispatch
    import and run (a window-mode batch, a preemption fit, a K = 2 fused
    dispatch on the CPU) while jax and the JAX package are refused."""
    assert set(FUSED_AND_BATCHED) <= set(_port_modules())
    code = _BLOCKED_IMPORT.split("import spark_scheduler_tpu_torch as pkg")[0] + (
        "import importlib\n"
        f"for name in {FUSED_AND_BATCHED!r}:\n"
        "    importlib.import_module(name)\n"
        "import numpy as np, torch\n"
        "from spark_scheduler_tpu_torch.core.solver import PlacementSolver, WindowRequest\n"
        "from spark_scheduler_tpu_torch.models.cluster import cluster_from_numpy\n"
        "from spark_scheduler_tpu_torch.models.kube import Node\n"
        "from spark_scheduler_tpu_torch.models.resources import INT32_INF, Resources\n"
        "from spark_scheduler_tpu_torch.ops.batched import batched_fifo_pack, make_app_batch\n"
        "from spark_scheduler_tpu_torch.ops.packing import preemption_batched_fit\n"
        "n = 6\n"
        "avail = np.full((n, 3), 8, np.int32)\n"
        "c = cluster_from_numpy([avail, avail.copy(), (np.arange(n) % 2).astype(np.int32),\n"
        "    np.arange(n, dtype=np.int32), np.full(n, INT32_INF, np.int32),\n"
        "    np.full(n, INT32_INF, np.int32), np.zeros(n, bool), np.ones(n, bool),\n"
        "    np.ones(n, bool)], device='cpu')\n"
        "one = [[1, 1, 0]]\n"
        "out = batched_fifo_pack(c, make_app_batch(one, one, [3], commit=[True], reset=[True]),\n"
        "    fill='single-az-tightly-pack', emax=8, num_zones=2)\n"
        "assert bool(out.admitted[0])\n"
        "t = lambda a, d=torch.int32: torch.tensor(a, dtype=d)\n"
        "ok, _, _ = preemption_batched_fit(c, t(np.zeros((2, n, 3))), t([1, 1, 0]),\n"
        "    t([1, 1, 0]), 2, t(np.ones(n), torch.bool), t(np.ones(n), torch.bool),\n"
        "    fill='tightly-pack', emax=8, num_zones=2)\n"
        "assert ok.tolist() == [True, True]\n"
        "solver = PlacementSolver(device='cpu')\n"
        "nodes = [Node(name=f'n{i}', allocatable=Resources.from_quantities('8', '8Gi'))\n"
        "         for i in range(n)]\n"
        "r = Resources.from_quantities('1', '1Gi')\n"
        "req = WindowRequest(rows=[(r, r, 2, False)], driver_candidate_names=[x.name for x in nodes])\n"
        "views = solver.pack_windows_dispatch('tightly-pack',\n"
        "    solver.build_tensors_pipelined(nodes, {}, {}), [[req], [req]])\n"
        "assert [d.admitted for v in views for d in solver.pack_window_fetch(v)] == [True, True]\n"
        "leaked = [m for m in sys.modules\n"
        "          if any(m == b or m.startswith(b + '.') for b in BLOCKED)]\n"
        "assert not leaked, leaked\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


POLICY_AND_AUTOSCALER = (
    "spark_scheduler_tpu_torch.policy.priority",
    "spark_scheduler_tpu_torch.policy.ordering",
    "spark_scheduler_tpu_torch.policy.preemption",
    "spark_scheduler_tpu_torch.policy.defrag",
    "spark_scheduler_tpu_torch.policy.engine",
    "spark_scheduler_tpu_torch.core.census",
    "spark_scheduler_tpu_torch.autoscaler.provisioner",
    "spark_scheduler_tpu_torch.autoscaler.drainer",
    "spark_scheduler_tpu_torch.autoscaler.metrics",
    "spark_scheduler_tpu_torch.autoscaler.controller",
    "spark_scheduler_tpu_torch.testing.soak",
)


def test_policy_and_autoscaler_modules_run_with_jax_blocked():
    """The policy engine, the census, the autoscaler and the policy soak
    are the port's own copies: each imports, and an app built with
    `policy.enabled` and `autoscaler.enabled` serves a preemption and a
    scale-up on the CPU, while jax and the JAX package are refused."""
    assert set(POLICY_AND_AUTOSCALER) <= set(_port_modules())
    code = _BLOCKED_IMPORT.split("import spark_scheduler_tpu_torch as pkg")[0] + (
        "import importlib\n"
        f"for name in {POLICY_AND_AUTOSCALER!r}:\n"
        "    importlib.import_module(name)\n"
        "from spark_scheduler_tpu_torch.testing.harness import Harness, new_node, static_allocation_spark_pods\n"
        "from spark_scheduler_tpu_torch.policy import PRIORITY_CLASS_ANNOTATION\n"
        "h = Harness(device='cpu', policy_enabled=True, policy_ordering='priority',\n"
        "            policy_preemption=True, policy_promote_after_s=0.0,\n"
        "            autoscaler_enabled=True,\n"
        "            resync_gap_seconds=1e12, clock=lambda: 1000.0)\n"
        "h.add_nodes(new_node('n1'))\n"
        "low = static_allocation_spark_pods('low', 5)\n"
        "low[0].annotations[PRIORITY_CLASS_ANNOTATION] = 'low'\n"
        "assert all(h.schedule(p, ['n1']).ok for p in low)\n"
        "high = static_allocation_spark_pods('high', 4)\n"
        "high[0].annotations[PRIORITY_CLASS_ANNOTATION] = 'high'\n"
        "assert h.schedule(high[0], ['n1']).ok\n"
        "assert h.get_reservation('namespace', 'low') is None\n"
        "big = static_allocation_spark_pods('big', 20)\n"
        "assert not h.schedule(big[0], ['n1']).ok\n"
        "assert h.autoscaler.run_once()['fulfilled'] == 1\n"
        "leaked = [m for m in sys.modules\n"
        "          if any(m == b or m.startswith(b + '.') for b in BLOCKED)]\n"
        "assert not leaked, leaked\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_blocker_does_not_refuse_the_port_prefix():
    """The finder matches `spark_scheduler_tpu` exactly or with a dot, so
    the port (which shares the prefix) still imports while the JAX
    package does not."""
    code = _BLOCKED_IMPORT.split("sys.meta_path.insert")[0] + (
        "sys.meta_path.insert(0, Refuse())\n"
        "import spark_scheduler_tpu_torch.models.resources\n"
        "try:\n"
        "    import spark_scheduler_tpu.models.resources\n"
        "except ImportError:\n"
        "    print('refused')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "refused"


def test_no_port_source_names_jax():
    for path in PORT.rglob("*.py"):
        for line in path.read_text().splitlines():
            stripped = line.strip()
            if stripped.startswith(("import ", "from ")):
                assert "jax" not in stripped, (path, line)
                assert not stripped.startswith(
                    ("import spark_scheduler_tpu.", "from spark_scheduler_tpu.",
                     "import spark_scheduler_tpu ", "from spark_scheduler_tpu ")
                ), (path, line)


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top == "jax" or top.startswith("jax") or top == "spark_scheduler_tpu"


def _imported_modules(tree: ast.AST):
    """Every module an AST imports, at any depth (function bodies, class
    bodies, branches), with `importlib.import_module` / `__import__` calls
    on a constant name counted as imports."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.lineno, node.module
        elif isinstance(node, ast.Call) and node.args:
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            arg = node.args[0]
            if name in ("import_module", "__import__") and isinstance(
                arg, ast.Constant
            ) and isinstance(arg.value, str):
                yield node.lineno, arg.value


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_no_jax_import_at_any_depth(path):
    """An AST scan: no `import jax*` and no import of the JAX package
    (`spark_scheduler_tpu`, not `spark_scheduler_tpu_torch`), however deep
    in a function it sits."""
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(line, m) for line, m in _imported_modules(tree) if _forbidden(m)]
    assert not bad, (path, bad)


def test_import_scan_sees_nested_and_dynamic_imports():
    src = (
        "def f():\n"
        "    if True:\n"
        "        from spark_scheduler_tpu.core import solver\n"
        "    import jaxlib\n"
        "    importlib.import_module('jax.numpy')\n"
        "import spark_scheduler_tpu_torch.core\n"
    )
    found = [m for _, m in _imported_modules(ast.parse(src)) if _forbidden(m)]
    assert sorted(found) == ["jax.numpy", "jaxlib", "spark_scheduler_tpu.core"]


def test_solver_defaults_to_cuda_and_never_falls_back():
    from spark_scheduler_tpu_torch.core.solver import PlacementSolver

    if torch.cuda.is_available():
        assert PlacementSolver().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        PlacementSolver()
    assert PlacementSolver(device="cpu").device.type == "cpu"


def test_window_pack_refuses_other_devices():
    import numpy as np

    from spark_scheduler_tpu_torch.models.cluster import cluster_from_numpy
    from spark_scheduler_tpu_torch.ops.window import (
        make_segmented_window,
        window_pack,
    )

    n = 8
    cluster = cluster_from_numpy(
        [np.ones((n, 3), np.int32), np.ones((n, 3), np.int32),
         np.zeros(n, np.int32), np.arange(n, dtype=np.int32),
         np.zeros(n, np.int32), np.zeros(n, np.int32), np.zeros(n, bool),
         np.ones(n, bool), np.ones(n, bool)],
        device="meta",
    )
    row = (np.ones(3, np.int32), np.ones(3, np.int32), 1, False)
    win = make_segmented_window([[row]], [np.ones(n, bool)], [np.ones(n, bool)])
    with pytest.raises(ValueError, match="cuda or cpu"):
        window_pack(cluster, win, fill="tightly-pack", emax=8, num_zones=2)
    with pytest.raises(ValueError, match="window path supports"):
        window_pack(cluster, win, fill="first-fit", emax=8, num_zones=2)


FAULT_TOLERANCE = (
    "spark_scheduler_tpu_torch.core.device_pool",
    "spark_scheduler_tpu_torch.core.fallback",
    "spark_scheduler_tpu_torch.core.greedy",
    "spark_scheduler_tpu_torch.faults.degraded",
    "spark_scheduler_tpu_torch.faults.injector",
    "spark_scheduler_tpu_torch.parallel.mesh",
    "spark_scheduler_tpu_torch.testing.rtt_shim",
)


def test_fault_tolerance_modules_run_with_jax_blocked():
    """The device pool, the injector, the degraded-mode controller and the
    host greedy are the port's own copies: each imports, and a two-slot
    pool on the CPU re-dispatches a killed part and then serves the host
    greedy with every slot down, while jax and the JAX package are
    refused."""
    assert set(FAULT_TOLERANCE) <= set(_port_modules())
    code = _BLOCKED_IMPORT.split("import spark_scheduler_tpu_torch as pkg")[0] + (
        "import importlib\n"
        f"for name in {FAULT_TOLERANCE!r}:\n"
        "    importlib.import_module(name)\n"
        "from spark_scheduler_tpu_torch.core.solver import PlacementSolver, WindowRequest\n"
        "from spark_scheduler_tpu_torch.faults import DegradedModeController, FaultInjector, FaultPlan, FaultSpec\n"
        "from spark_scheduler_tpu_torch.models.kube import Node\n"
        "from spark_scheduler_tpu_torch.models.resources import Resources\n"
        "one = Resources.from_quantities('1', '1Gi')\n"
        "nodes = [Node(name=f'n{i}', allocatable=Resources.from_quantities('8', '8Gi')) for i in range(8)]\n"
        "halves = [n.name for n in nodes[:4]], [n.name for n in nodes[4:]]\n"
        "reqs = [WindowRequest(rows=[(one, one, 2, False)], driver_candidate_names=h, domain_node_names=h) for h in halves]\n"
        "s = PlacementSolver(device='cpu', pool_devices=['cpu', 'cpu'])\n"
        "s.degraded = DegradedModeController(policy='greedy')\n"
        "for spec in (FaultSpec(surface='device.dispatch', at=[0], limit=1),\n"
        "             FaultSpec(surface='device.dispatch', mode='partition')):\n"
        "    with FaultInjector(FaultPlan(seed=0, specs=[spec])) as inj:\n"
        "        inj.install_device()\n"
        "        out = s.pack_window('tightly-pack', s.build_tensors_pipelined(nodes, {}, {}), reqs)\n"
        "    assert all(d.admitted for d in out)\n"
        "assert s.redispatch_count == 1 and s.degraded.active\n"
        "assert s.degraded.fallback_decisions == 2\n"
        "leaked = [m for m in sys.modules\n"
        "          if any(m == b or m.startswith(b + '.') for b in BLOCKED)]\n"
        "assert not leaked, leaked\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


REPLAY_AND_FLEET = (
    "spark_scheduler_tpu_torch.replay.trace",
    "spark_scheduler_tpu_torch.replay.engine",
    "spark_scheduler_tpu_torch.replay.generators",
    "spark_scheduler_tpu_torch.replay.sweep",
    "spark_scheduler_tpu_torch.replay.__main__",
    "spark_scheduler_tpu_torch.fleet.aggregates",
    "spark_scheduler_tpu_torch.fleet.router",
    "spark_scheduler_tpu_torch.fleet.spillover",
    "spark_scheduler_tpu_torch.fleet.facade",
    "spark_scheduler_tpu_torch.fleet.dispatch",
)


def test_replay_and_fleet_modules_run_with_jax_blocked(tmp_path):
    """The trace codec, the replay engine, the generators, the sweep and
    the fleet are the port's own copies: each imports, and a generated
    trace runs with re-capture, replays strictly, sweeps two arms with a
    stacked solve, and a two-cluster stacked fleet serves and verifies on
    the CPU, while jax and the JAX package are refused."""
    assert set(REPLAY_AND_FLEET) <= set(_port_modules())
    code = _BLOCKED_IMPORT.split("import spark_scheduler_tpu_torch as pkg")[0] + (
        "import importlib\n"
        f"for name in {REPLAY_AND_FLEET!r}:\n"
        "    importlib.import_module(name)\n"
        "from spark_scheduler_tpu_torch.replay import generate, replay_trace, run_sweep\n"
        "from spark_scheduler_tpu_torch.fleet import FleetFacade, verify_cluster_equivalence\n"
        "from spark_scheduler_tpu_torch.server.config import InstallConfig\n"
        "from spark_scheduler_tpu_torch.testing.harness import INSTANCE_GROUP_LABEL, new_node, static_allocation_spark_pods\n"
        f"gen, cap = {str(tmp_path / 'g.jsonl')!r}, {str(tmp_path / 'c.jsonl')!r}\n"
        "generate('churn', gen, seed=1, n_nodes=8, steps=12)\n"
        "assert replay_trace(gen, record_path=cap, device='cpu').decisions > 0\n"
        "rep = replay_trace(cap, strict=True, device='cpu')\n"
        "assert rep.compared == rep.decisions > 0\n"
        "sw = run_sweep(cap, [{}, {'binpack_algo': 'distribute-evenly'}], device='cpu')\n"
        "assert sw.telemetry['stacked_dispatches'] > 0\n"
        "cfg = InstallConfig(fifo=True, sync_writes=True, instance_group_label=INSTANCE_GROUP_LABEL)\n"
        "f = FleetFacade(2, cfg, record_ops=True, stack_window_ms=5.0, device='cpu')\n"
        "for c in range(2):\n"
        "    f.add_node(c, new_node(f'c{c}-n0', instance_group=f'ig-{c}'))\n"
        "assert f.schedule(static_allocation_spark_pods('a', 1, instance_group='ig-1')[0]).cluster == 1\n"
        "assert all(r['identical'] for r in verify_cluster_equivalence(f).values())\n"
        "f.stop()\n"
        "leaked = [m for m in sys.modules\n"
        "          if any(m == b or m.startswith(b + '.') for b in BLOCKED)]\n"
        "assert not leaked, leaked\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_replay_and_fleet_entry_points_default_to_cuda():
    """Each new entry point asks for the card unless told otherwise."""
    import inspect

    from spark_scheduler_tpu_torch.fleet import (
        ClusterStack,
        FleetFacade,
        replay_standalone,
    )
    from spark_scheduler_tpu_torch.replay import replay_trace, run_sweep, what_if
    from spark_scheduler_tpu_torch.replay.engine import ReplayLane

    for fn in (replay_trace, run_sweep, what_if, ReplayLane, FleetFacade,
               ClusterStack, replay_standalone):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            FleetFacade(2)


def test_soak_engines_run_with_jax_blocked(tmp_path):
    """The soak engines are the port's own copies: testing.soak imports,
    and a short invariant soak, a chaos-matrix leg, an HA cycle and a
    fleet soak run on the CPU, while jax and the JAX package are
    refused."""
    code = _BLOCKED_IMPORT.split("import spark_scheduler_tpu_torch as pkg")[0] + (
        "import numpy as np\n"
        "from spark_scheduler_tpu_torch.testing import soak\n"
        "s = soak.Soak(np.random.default_rng(0), 'tightly-pack', n_nodes=8, device='cpu')\n"
        "s.run(40)\n"
        "assert s.app_seq > 0 and sum(s.op_counts.values()) == 40\n"
        "s.h.app.stop()\n"
        f"m = soak.ChaosMatrixSoak('wal', seed=1, n_nodes=8, wal_path={str(tmp_path / 'w.log')!r}, device='cpu')\n"
        "assert m.run(30)['fired']\n"
        "m.soak.h.app.stop()\n"
        "ha = soak.HAChaosSoak(n_nodes=8, ttl_s=2.0, device='cpu')\n"
        "assert ha.run(cycles=1, burst=2)['promotions'] == 1\n"
        "f = soak.FleetSoak(seed=1, device='cpu')\n"
        "v = f.run(steps=12, kill_at=6, rejoin_at=9).verdict()\n"
        "f.stop()\n"
        "assert all(r['identical'] for r in v['equivalence'].values())\n"
        "leaked = [m for m in sys.modules\n"
        "          if any(m == b or m.startswith(b + '.') for b in BLOCKED)]\n"
        "assert not leaked, leaked\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_soak_engines_default_to_cuda():
    import inspect

    from spark_scheduler_tpu_torch.testing import soak

    for engine in (soak.Soak, soak.ChaosMatrixSoak, soak.HAChaosSoak,
                   soak.PolicySoak, soak.FleetSoak):
        assert inspect.signature(engine).parameters["device"].default == (
            "cuda"
        ), engine


PARALLEL = (
    "spark_scheduler_tpu_torch.parallel.mesh",
    "spark_scheduler_tpu_torch.parallel.node_shards",
    "spark_scheduler_tpu_torch.parallel.solve",
)


def test_parallel_modules_run_with_jax_blocked():
    """The mesh, the node-sharded engine and the grouped routes are the
    port's own: with jax and the JAX package refused, each imports, and a
    one-slot 4-shard mesh solver with the scale tier serves a window on
    `cpu` shards."""
    assert set(PARALLEL) <= set(_port_modules())
    code = _BLOCKED_IMPORT.split("import spark_scheduler_tpu_torch as pkg")[0] + (
        "import importlib\n"
        f"for name in {PARALLEL!r}:\n"
        "    importlib.import_module(name)\n"
        "from spark_scheduler_tpu_torch.core.solver import PlacementSolver, WindowRequest\n"
        "from spark_scheduler_tpu_torch.models.kube import Node\n"
        "from spark_scheduler_tpu_torch.models.resources import Resources\n"
        "one = Resources.from_quantities('1', '1Gi')\n"
        "nodes = [Node(name=f'n{i}', allocatable=Resources.from_quantities('8', '8Gi')) for i in range(8)]\n"
        "names = [n.name for n in nodes]\n"
        "reqs = [WindowRequest(rows=[(one, one, 2, False)], driver_candidate_names=names) for _ in range(3)]\n"
        "s = PlacementSolver(device='cpu', mesh=(1, 4), scale_tier=True, pool_devices=['cpu'] * 4)\n"
        "assert s._pool.slots[0].is_mesh\n"
        "out = s.pack_window('tightly-pack', s.build_tensors_pipelined(nodes, {}, {}), reqs)\n"
        "assert all(d.admitted for d in out) and s.window_path_counts == {'pool': 1}\n"
        "leaked = [m for m in sys.modules\n"
        "          if any(m == b or m.startswith(b + '.') for b in BLOCKED)]\n"
        "assert not leaked, leaked\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
