"""The slice as a whole: the PyTorch port's `PlacementSolver(device="cpu")
.pack_window` against the JAX package's `PlacementSolver(use_native=False)
.pack_window` on the CPU, for all six strategies, plus the port's
state carry-over (`cluster_from_numpy`) and its device contract.

Tolerance: none. Names, `admitted`, `earlier_blocked` and `has_capacity`
must be equal, and the efficiencies equal as floats: both packages compute
them with the same numpy code (ops/efficiency.avg_packing_efficiency_np) from
the same integer decisions.
"""

import numpy as np
import pytest
import torch

from spark_scheduler_tpu.core.solver import (
    PlacementSolver as JaxSolver,
    WindowRequest as JaxRequest,
)
from spark_scheduler_tpu.models.kube import Node as JaxNode, ZONE_LABEL
from spark_scheduler_tpu.models.resources import Resources as JaxResources
from spark_scheduler_tpu_torch.core.solver import (
    PlacementSolver,
    WindowRequest,
)
from spark_scheduler_tpu_torch.models.cluster import cluster_from_numpy
from spark_scheduler_tpu_torch.models.kube import Node
from spark_scheduler_tpu_torch.models.resources import Resources

STRATEGIES = (
    "tightly-pack",
    "distribute-evenly",
    "minimal-fragmentation",
    "single-az-tightly-pack",
    "single-az-minimal-fragmentation",
    "az-aware-tightly-pack",
)

LABEL = "instance-group"


def _assert_decisions_equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.admitted == w.admitted, i
        assert g.earlier_blocked == w.earlier_blocked, i
        assert g.packing.driver_node == w.packing.driver_node, i
        assert g.packing.executor_nodes == w.packing.executor_nodes, i
        assert g.packing.has_capacity == w.packing.has_capacity, i
        for f in ("efficiency_max", "efficiency_cpu", "efficiency_memory",
                  "efficiency_gpu"):
            assert getattr(g.packing, f) == getattr(w.packing, f), (i, f)


def _solve_both(strategy, node_specs, usage_specs, request_specs,
                label_priority=None):
    """Build the same cluster and window in both packages and solve it.
    node_specs: (name, cpu, mem, gpu, zone, label value, unschedulable);
    usage_specs: {name: (cpu, mem, gpu)}; request_specs: list of
    (rows [(drv q, exec q, count, skip)], candidate names, domain names)."""
    out = []
    for mk_solver, node_t, res_t, req_t in (
        (lambda: JaxSolver(
            driver_label_priority=label_priority,
            executor_label_priority=label_priority, use_native=False),
         JaxNode, JaxResources, JaxRequest),
        (lambda: PlacementSolver(
            driver_label_priority=label_priority,
            executor_label_priority=label_priority, device="cpu",
            use_native=False),
         Node, Resources, WindowRequest),
    ):
        solver = mk_solver()
        nodes = [
            node_t(
                name=name,
                allocatable=res_t.from_quantities(cpu, mem, gpu),
                labels={ZONE_LABEL: zone, LABEL: group},
                unschedulable=unsched,
            )
            for name, cpu, mem, gpu, zone, group, unsched in node_specs
        ]
        usage = {
            name: res_t.from_quantities(*q) for name, q in usage_specs.items()
        }
        tensors = solver.build_tensors(nodes, usage, {})
        requests = [
            req_t(
                rows=[
                    (res_t.from_quantities(*d), res_t.from_quantities(*e),
                     cnt, skip)
                    for d, e, cnt, skip in rows
                ],
                driver_candidate_names=cands,
                domain_node_names=dom,
            )
            for rows, cands, dom in request_specs
        ]
        out.append((solver, solver.pack_window(strategy, tensors, requests)))
    return out


def _pallas_scenario():
    """tests/test_pallas_window.py::test_solver_window_route_parity."""
    names = [f"n{i}" for i in range(12)]
    nodes = [(n, "8", "8Gi", "0", "default", "a", False) for n in names]
    one, two = ("1", "1Gi"), ("2", "2Gi")
    requests = [
        ([(one, one, 3, False)], names, None),
        ([(one, one, 3, False), (two, one, 2, False)], names, None),
        ([(one, two, 4, True), (one, one, 1, False)], names[:8], None),
    ]
    return nodes, {}, requests


def _random_scenario(seed):
    """Four zones, heterogeneous nodes, prior usage, a GPU pool, label
    priorities, affinity domains and FIFO prefixes with blocking rows."""
    rng = np.random.default_rng(seed)
    n = 40
    names = [f"node-{i:03d}" for i in rng.permutation(n)]
    nodes, usage = [], {}
    for i, name in enumerate(names):
        cpu = int(rng.choice([4, 8, 16]))
        mem = int(rng.choice([8, 16, 32]))
        gpu = int(rng.choice([0, 0, 0, 2]))
        nodes.append((name, str(cpu), f"{mem}Gi", str(gpu),
                      f"zone-{i % 4}", str(rng.choice(["a", "b", "c"])),
                      bool(rng.random() < 0.05)))
        if rng.random() < 0.7:
            usage[name] = (f"{int(rng.integers(0, cpu))}",
                           f"{int(rng.integers(0, mem))}Gi", "0")
    pending = []
    for _ in range(6):
        gpu = "1" if rng.random() < 0.15 else "0"
        pending.append((
            (str(int(rng.integers(1, 3))), f"{int(rng.integers(1, 4))}Gi"),
            (str(int(rng.integers(1, 5))), f"{int(rng.integers(1, 8))}Gi",
             gpu),
            int(rng.integers(0, 9)),
            bool(rng.random() < 0.4),
        ))
    requests = []
    for k in range(8):
        prefix = pending[: int(rng.integers(0, len(pending) + 1))]
        own = pending[k % len(pending)][:3] + (False,)
        cands = [nm for nm in names if rng.random() < 0.8]
        dom = [nm for nm in names if rng.random() < 0.7] if k % 3 == 2 else None
        requests.append((prefix + [own], cands, dom))
    return nodes, usage, requests


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_pack_window_matches_jax_solver(strategy):
    (jax_s, want), (port_s, got) = _solve_both(strategy, *_pallas_scenario())
    _assert_decisions_equal(got, want)
    assert port_s.window_path_counts == {"reference": 1}
    assert any(d.admitted for d in got)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("seed", [0, 1])
def test_pack_window_matches_jax_solver_random(strategy, seed):
    (_, want), (_, got) = _solve_both(
        strategy, *_random_scenario(seed), label_priority=(LABEL, ["b", "a"])
    )
    _assert_decisions_equal(got, want)
    assert any(d.admitted for d in got)


def test_cluster_from_numpy_copies_not_aliases():
    n = 8
    fields = [
        np.arange(n * 3, dtype=np.int32).reshape(n, 3),
        np.ones((n, 3), np.int32),
        np.zeros(n, np.int32),
        np.arange(n, dtype=np.int32),
        np.zeros(n, np.int32),
        np.zeros(n, np.int32),
        np.zeros(n, bool),
        np.ones(n, bool),
        np.ones(n, bool),
    ]
    c = cluster_from_numpy(fields, device="cpu")
    c.available[0, 0] = -99
    fields[1][0, 0] = 77
    assert fields[0][0, 0] == 0
    assert int(c.schedulable[0, 0]) == 1
    assert c.available.dtype == torch.int32 and c.valid.dtype == torch.bool
    with pytest.raises(ValueError):
        cluster_from_numpy(fields[:8], device="cpu")


def test_port_solver_carries_jax_cluster_state():
    """A JAX-built ClusterTensors carried into the port (field by field)
    solves a window to the same decisions as the port's own build."""
    nodes, usage, _ = _random_scenario(3)
    (jax_s, _), (port_s, _) = _solve_both("tightly-pack", nodes, usage, [
        ([(("1", "1Gi"), ("1", "1Gi"), 1, False)], [nodes[0][0]], None)
    ])
    jax_t = jax_s.build_tensors(
        [JaxNode(name=nm, allocatable=JaxResources.from_quantities(c, m, g),
                 labels={ZONE_LABEL: z, LABEL: lb}, unschedulable=u)
         for nm, c, m, g, z, lb, u in nodes],
        {k: JaxResources.from_quantities(*v) for k, v in usage.items()}, {},
    )
    carried = cluster_from_numpy(
        [np.asarray(f) for f in jax_t.tree_flatten()[0]], device="cpu"
    )
    own = port_s.build_tensors(
        [Node(name=nm, allocatable=Resources.from_quantities(c, m, g),
              labels={ZONE_LABEL: z, LABEL: lb}, unschedulable=u)
         for nm, c, m, g, z, lb, u in nodes],
        {k: Resources.from_quantities(*v) for k, v in usage.items()}, {},
    )
    for a, b in zip(carried.fields(), own.fields()):
        assert torch.equal(a, b)
    names = [nd[0] for nd in nodes]
    reqs = [
        WindowRequest(
            rows=[(Resources.from_quantities("1", "2Gi"),
                   Resources.from_quantities("2", "4Gi"), 4, False)],
            driver_candidate_names=names,
        )
    ] * 3
    _assert_decisions_equal(
        port_s.pack_window("tightly-pack", carried, reqs),
        port_s.pack_window("tightly-pack", own, reqs),
    )
