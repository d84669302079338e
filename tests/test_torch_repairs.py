"""Two faults of the JAX package that the port repairs, each held against
the JAX package's behaviour, with the divergence asserted.

- A fleet served with async write-back (`sync_writes` off, the CLI's
  default). The JAX CLI starts the background loops of cluster 0's app
  only, so clusters 1..F-1 never write their reservations back, and
  `kill_cluster`, which reads the dead cluster's backend to tell placed
  apps from pending ones, counts their placed apps as orphans: a retry
  could then place the gang a second time. The port's CLI boots every
  stack through `FleetFacade.start_background`, and `kill_cluster` also
  counts the apps in the cluster's reservation cache, whose write-back
  may still be queued.
- A registry row recycled under pods of a deleted node. The JAX solver
  frees a deleted node's row once its usage and overhead rows read zero,
  which the feature store's live mask guarantees, while the overhead
  computer still aggregates pods bound to that name: the node that next
  takes the row inherits their overhead, and when those pods go the old
  name is interned again. The port keeps the row parked while the
  overhead computer holds a pod bound to the name
  (`NodeRegistry.row_holder`).
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest

from tests.test_torch_build import _harness, _serve, _stop
from tests.test_torch_kube import wait_until
from tests.test_torch_native import load_jax_native

JAX = "spark_scheduler_tpu"
PORT = "spark_scheduler_tpu_torch"


def mod(root, name):
    if root == JAX:
        load_jax_native()
    return importlib.import_module(f"{root}.{name}")


# ------------------------------------------------ the fleet's write-back


def async_fleet(root):
    """A 3-cluster fleet with async write-back, booted as each package's
    CLI boots it. Cluster c alone hosts instance group ig-c."""
    hm = mod(root, "testing.harness")
    cfg = mod(root, "server.config").InstallConfig(
        fifo=True, sync_writes=False,
        instance_group_label=hm.INSTANCE_GROUP_LABEL,
    )
    kw = {"device": "cpu"} if root == PORT else {}
    facade = mod(root, "fleet").FleetFacade(3, cfg, record_ops=True, **kw)
    for c in range(3):
        for i in range(3):
            facade.add_node(c, hm.new_node(f"c{c}-n{i}", instance_group=f"ig-{c}"))
    if root == PORT:
        facade.start_background()
    else:
        # The JAX CLI: the HTTP server's start runs cluster 0's loops only.
        facade.stacks[0].app.start_background()
    return hm, facade


def place(hm, facade, cluster, n):
    apps = []
    for k in range(n):
        app_id = f"wb-{cluster}-{k}"
        pods = hm.static_allocation_spark_pods(
            app_id, 1, instance_group=f"ig-{cluster}"
        )
        for d in facade.schedule_app(pods):
            assert d.ok and d.cluster == cluster, (app_id, d)
        apps.append(app_id)
    return apps


def written_back(facade, cluster, apps):
    stored = {
        rr.name
        for rr in facade.stacks[cluster].backend.list("resourcereservations")
    }
    return set(apps) <= stored


@pytest.mark.parametrize("victim", [1, 2])
def test_killed_async_cluster_counts_no_placed_app_as_orphan(victim):
    placed = {}
    for root in (JAX, PORT):
        hm, facade = async_fleet(root)
        try:
            apps = {c: place(hm, facade, c, 3) for c in (1, 2)}
            settled = wait_until(
                lambda: all(written_back(facade, c, apps[c]) for c in (1, 2)),
                timeout=3.0,
            )
            orphans = facade.kill_cluster(victim)
            # Placed apps keep their home: a retry is denied while the
            # cluster is down, never placed on a sibling.
            retry = facade.schedule(
                hm.static_allocation_spark_pods(
                    apps[victim][0], 1, instance_group=f"ig-{victim}"
                )[0]
            )
            placed[root] = (settled, orphans, retry.unavailable)
        finally:
            facade.stop()
        if root == PORT:
            # stop flushed every cluster and joined its workers.
            for c in (1, 2):
                assert written_back(facade, c, apps[c])
            for s in facade.stacks:
                assert not s.app.rr_cache.client._threads
    assert placed[PORT] == (True, 0, True)
    # The JAX fleet never wrote clusters 1 and 2 back: the kill counts
    # every app placed on the victim as an orphan (the divergence).
    assert placed[JAX] == (False, 3, False)


def test_kill_counts_apps_whose_write_back_is_still_queued():
    """With no write-back at all (the loops never started), the port's
    kill still counts the victim's placed apps from its reservation
    cache: none is an orphan, and a retry is denied while the cluster is
    down."""
    hm = mod(PORT, "testing.harness")
    cfg = mod(PORT, "server.config").InstallConfig(
        fifo=True, sync_writes=False,
        instance_group_label=hm.INSTANCE_GROUP_LABEL,
    )
    facade = mod(PORT, "fleet").FleetFacade(3, cfg, device="cpu")
    try:
        for c in range(3):
            facade.add_node(c, hm.new_node(f"c{c}-n0", instance_group=f"ig-{c}"))
        apps = place(hm, facade, 1, 2)
        assert not written_back(facade, 1, apps)
        assert facade.kill_cluster(1) == 0
        retry = facade.schedule(hm.static_allocation_spark_pods(
            apps[0], 1, instance_group="ig-1")[0])
        assert retry.unavailable
    finally:
        facade.stop()


def test_cli_fleet_boot_starts_every_stack():
    """The port's CLI boot step: every stack's write-back workers run."""
    _, facade = async_fleet(PORT)
    try:
        for s in facade.stacks:
            assert s.app._background_started
            assert s.app.rr_cache.client._threads
    finally:
        facade.stop()


# ------------------------------------------------------ the recycled row


def foreign_pod(h, node, cpu="2", mem="2Gi"):
    root = h.mod.__name__.split(".")[0]
    km = mod(root, "models.kube")
    res = mod(root, "models.resources")
    return km.Pod(
        name="daemon", namespace="kube-system", node_name=node,
        phase="Running", scheduler_name="default-scheduler",
        containers=[km.Container(requests=res.Resources.from_quantities(cpu, mem))],
    )


def overhead_row(h, name):
    """The overhead computer's dense row under `name`'s registry row, and
    the pipeline's host `schedulable` row."""
    row = h.app.solver.registry.index_of(name)
    dense = h.app.overhead_computer.dense_values(np.asarray([row]))[0]
    sched = np.asarray(h.app.solver._pipe["host"].schedulable)[row]
    return row, tuple(int(x) for x in dense), tuple(int(x) for x in sched)


def test_row_is_not_recycled_under_pods_of_a_deleted_node():
    sides = {s: _harness(s, 1, 0, n0=16) for s in ("jax", "port")}
    live = [f"n{i:03d}" for i in range(16)]
    victim = "n015"  # tightly-pack fills the first rows: n015 is empty
    seen = {}
    for side, h in sides.items():
        assert _serve(h, live, (0,))[0]
        h.backend.add_pod(foreign_pod(h, victim))
        _serve(h, live, (4,))
        old_row = h.app.solver.registry.index_of(victim)
        h.backend.delete("nodes", "", victim)  # the daemon pod survives it
        _serve(h, live[:-1], (1,))
        recycled = h.app.solver.tombstones_recycled
        h.add_nodes(h.mod.new_node("fresh", zone="zone0"))
        _serve(h, live[:-1] + ["fresh"], (2,))
        fresh_row, fresh_dense, fresh_sched = overhead_row(h, "fresh")
        h.backend.delete("pods", "kube-system", "daemon")
        _serve(h, live[:-1] + ["fresh"], (3,))
        seen[side] = dict(
            recycled_at_delete=recycled,
            took_old_row=fresh_row == old_row,
            fresh_dense=fresh_dense,
            fresh_schedulable=fresh_sched,
            old_name_row=h.app.solver.registry.index_of(victim),
            after_pod_gone=overhead_row(h, "fresh")[1],
            recycled_at_end=h.app.solver.tombstones_recycled,
        )
    full = (8000, 8 * 1024 * 1024, 1000)
    port = seen["port"]
    assert port["recycled_at_delete"] == 0
    assert not port["took_old_row"]
    assert port["fresh_dense"] == (0, 0, 0)
    assert port["fresh_schedulable"] == full
    # The pods went: the parked row frees, no name is interned again.
    assert port["old_name_row"] is None
    assert port["after_pod_gone"] == (0, 0, 0)
    assert port["recycled_at_end"] == 1
    # The JAX solver recycled the row under the daemon: the fresh node
    # inherited its 2 CPU / 2 GiB, and the pod's deletion interned the
    # deleted name again and drove the fresh row's overhead negative.
    jax = seen["jax"]
    assert jax["recycled_at_delete"] == 1 and jax["took_old_row"]
    assert jax["fresh_dense"] == (2000, 2 * 1024 * 1024, 0)
    assert jax["fresh_schedulable"] == (6000, 6 * 1024 * 1024, 1000)
    assert jax["old_name_row"] is not None
    _stop(*sides.values())
