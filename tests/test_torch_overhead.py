"""The port's incremental overhead aggregates against the JAX package's.

The twin of tests/test_overhead_incremental.py: its 3 tests run once per
package (the port's harness on `device="cpu"`), each holding the
incremental aggregates equal to the per-query oracle walk through the
scheduling lifecycle (foreign pods, reserved and unreserved Spark pods,
dynamic allocation, executor death), and the recomputes delta-scoped.
After every lifecycle step the two packages' overhead and non-schedulable
overhead maps must also be equal, with no tolerance.
"""

from __future__ import annotations

import functools
import importlib
import types

import pytest

from tests.test_torch_native import load_jax_native

JAX = "spark_scheduler_tpu"
PORT = "spark_scheduler_tpu_torch"
ROOTS = (JAX, PORT)


def package(root):
    if root == JAX:
        load_jax_native()

    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    hm = mod("testing.harness")
    return types.SimpleNamespace(
        hm=hm,
        Harness=functools.partial(
            hm.Harness, **({"device": "cpu"} if root == PORT else {})
        ),
        Pod=mod("models.kube").Pod,
        Container=mod("models.kube").Container,
        Resources=mod("models.resources").Resources,
    )


@pytest.fixture(params=ROOTS)
def p(request):
    return package(request.param)


def assert_overhead_consistent(p, h):
    oc = h.app.overhead_computer
    nodes = h.backend.list_nodes()
    inc = oc.get_overhead(nodes)
    inc_ns = oc.get_non_schedulable_overhead(nodes)
    for n in nodes:
        want, want_ns = oc.compute_node_overhead_oracle(n.name)
        got = inc.get(n.name, p.Resources.zero())
        got_ns = inc_ns.get(n.name, p.Resources.zero())
        assert got.as_tuple() == want.as_tuple(), f"overhead mismatch on {n.name}"
        assert got_ns.as_tuple() == want_ns.as_tuple(), (
            f"non-schedulable overhead mismatch on {n.name}"
        )


def other_scheduler_pod(p, name, node, cpu="2", mem="2Gi"):
    return p.Pod(
        name=name,
        namespace="kube-system",
        node_name=node,
        phase="Running",
        scheduler_name="default-scheduler",
        containers=[p.Container(requests=p.Resources.from_quantities(cpu, mem))],
    )


def lifecycle(p, check):
    """The JAX suite's lifecycle, calling `check(h)` after every step."""
    hm = p.hm
    h = p.Harness()
    h.add_nodes(*[hm.new_node(f"n{i}") for i in range(5)])
    names = [f"n{i}" for i in range(5)]
    h.backend.add_pod(other_scheduler_pod(p, "daemon-1", "n0"))
    h.backend.add_pod(
        other_scheduler_pod(p, "daemon-2", "n3", cpu="1", mem="512Mi")
    )
    check(h)
    pods = hm.static_allocation_spark_pods("app-1", 3)
    assert all(r.ok for r in h.schedule_app(pods, names))
    check(h)
    dpods = hm.dynamic_allocation_spark_pods("app-2", 1, 3)
    assert all(r.ok for r in h.schedule_app(dpods, names))
    check(h)
    h.terminate_pod(pods[2])
    h.delete_pod(pods[2])
    check(h)
    h.backend.delete("pods", "kube-system", "daemon-1")
    check(h)
    h.app.stop()


def test_overhead_tracks_scheduling_lifecycle(p):
    lifecycle(p, functools.partial(assert_overhead_consistent, p))


def test_overhead_counts_unreserved_spark_pod(p):
    hm = p.hm
    h = p.Harness()
    h.add_nodes(hm.new_node("n0"), hm.new_node("n1"))
    driver = hm.static_allocation_spark_pods("app-x", 1)[0]
    h.backend.add_pod(driver)
    h.backend.bind_pod(driver, "n0")
    assert_overhead_consistent(p, h)
    got = h.app.overhead_computer.get_overhead(h.backend.list_nodes()).get("n0")
    assert got is not None and got.cpu_milli > 0
    h.app.stop()


def test_overhead_recomputes_are_delta_scoped(p):
    hm = p.hm
    h = p.Harness()
    h.add_nodes(*[hm.new_node(f"n{i}") for i in range(8)])
    names = [f"n{i}" for i in range(8)]
    oc = h.app.overhead_computer
    before = oc.recomputes
    pods = hm.static_allocation_spark_pods("app-solo", 2)
    assert all(r.ok for r in h.schedule_app(pods, names))
    per_app = oc.recomputes - before
    before = oc.recomputes
    for i in range(4):
        extra = hm.static_allocation_spark_pods(f"app-{i}", 2)
        assert all(r.ok for r in h.schedule_app(extra, names))
    assert oc.recomputes - before <= 4 * (per_app + 4)
    h.app.stop()


def test_lifecycle_aggregates_match_jax():
    """Both packages' overhead maps, non-schedulable maps and recompute
    counts after every lifecycle step."""
    seen = {}
    for root in ROOTS:
        p = package(root)
        steps = seen[root] = []

        def check(h):
            oc = h.app.overhead_computer
            nodes = h.backend.list_nodes()
            steps.append((
                {k: v.as_tuple() for k, v in oc.get_overhead(nodes).items()},
                {k: v.as_tuple()
                 for k, v in oc.get_non_schedulable_overhead(nodes).items()},
                oc.recomputes,
            ))

        lifecycle(p, check)
    assert seen[PORT] == seen[JAX]
