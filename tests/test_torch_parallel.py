"""The port's parallel/ package against the JAX package's, on the CPU.

The JAX side runs as its own tests run it: GSPMD over the conftest's 8
virtual CPU devices, the Pallas routes in interpret mode. The port lays its
shards (and its groups devices) on `cpu`, repeated: the node-sharded
engine's cross-shard logic (parallel/node_shards.py) runs there exactly as
on the card.

Twins, case for case:
  - tests/test_batched.py `test_sharded_matches_unsharded`,
    `test_masked_sharded_matches_unsharded`,
    `test_grouped_2d_parallel_matches_per_group` and
    `test_grouped_pallas_sharded_matches_per_group`;
  - tests/test_window_serving.py `test_segmented_sharded_matches_unsharded`
    and `test_multi_device_window_decisions_byte_identical[sharded-mesh]`;
  - tests/test_pallas_fifo.py `test_grouped_pallas_fast_path_interpret` and
    `test_grouped_auto_falls_back_on_cpu`, for the port's routing.

The port's own: every fill and single-AZ wrapper at S in {1, 2, 3, 4} in
all three modes against the unsharded port (ties, negative availability,
unranked labels, `zone_base`, zero-count gangs, gangs wider than emax), a
pruned window on a mesh slot against the pool-less solver, and the
refusals. Tolerance: none; every output must be equal.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from spark_scheduler_tpu.ops.batched import batched_fifo_pack as jax_batched
from spark_scheduler_tpu.ops.batched import make_app_batch as jax_make_app_batch
from spark_scheduler_tpu.parallel import grouped_fifo_pack as jax_grouped
from spark_scheduler_tpu.parallel import make_solver_mesh as jax_mesh
from spark_scheduler_tpu.parallel import sharded_fifo_pack as jax_sharded
from spark_scheduler_tpu.parallel import stack_groups as jax_stack
from spark_scheduler_tpu_torch.ops import batched as TB
from spark_scheduler_tpu_torch.ops.packing import BINPACK_STRATEGIES
from spark_scheduler_tpu_torch.parallel import (
    grouped_fifo_pack,
    grouped_fifo_pack_auto,
    grouped_queue_sharded,
    grouped_sharded_fifo_pack,
    make_solver_mesh,
    node_sharded_fifo_pack,
    shard_cluster,
    sharded_fifo_pack,
    stack_groups,
)
from tests.test_batched import random_apps, random_masks
from tests.test_packing_golden import random_cluster
from tests.test_torch_batched import (
    masked_batch,
    queue_batch,
    window_batch,
)
from tests.test_torch_extender import JAX, PORT, canon
from tests.test_torch_fifo import port_cluster
from tests.test_torch_pool import build, group_harness, group_world, mod

FIELDS = ("driver_node", "executor_nodes", "admitted", "packed", "available_after")
EMAX = 16  # tests/test_batched.py
NUM_ZONES = 4


def cpu_mesh(groups=1, shards=8):
    return make_solver_mesh(groups, shards, devices=["cpu"] * (groups * shards))


def assert_same(got, want, fields=FIELDS):
    for f in fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(got, f)), np.asarray(getattr(want, f)), err_msg=f
        )


# ------------------------------------------------------ JAX twins: engine


def test_sharded_matches_unsharded():
    rng = np.random.default_rng(3)
    c = random_cluster(rng, 64)  # divisible by the 8-shard "nodes" axis
    apps = random_apps(rng, 8)
    kw = dict(fill="tightly-pack", emax=EMAX, num_zones=NUM_ZONES)
    want = jax_batched(c, apps, **kw)
    jax_got = jax_sharded(jax_mesh(), c, apps, **kw)
    got = sharded_fifo_pack(cpu_mesh(), port_cluster(c), apps, **kw)
    assert_same(got, jax_got)
    assert_same(got, want)
    assert_same(got, TB.batched_fifo_pack(port_cluster(c), apps, **kw))


def test_masked_sharded_matches_unsharded():
    """Per-row sorts and masks survive node-axis sharding."""
    rng = np.random.default_rng(17)
    c = random_cluster(rng, 64)
    n = np.asarray(c.available).shape[0]
    b = 6
    driver = rng.integers(1, 5, size=(b, 3)).astype(np.int32)
    execs = rng.integers(1, 6, size=(b, 3)).astype(np.int32)
    counts = rng.integers(1, 9, size=b).astype(np.int32)
    dcand, dom = random_masks(rng, b, n)
    apps = jax_make_app_batch(
        driver, execs, counts, driver_cand=dcand, domain=dom
    )
    kw = dict(fill="tightly-pack", emax=EMAX, num_zones=NUM_ZONES)
    want = jax_batched(c, apps, **kw)
    jax_got = jax_sharded(jax_mesh(), c, apps, **kw)
    got = sharded_fifo_pack(cpu_mesh(), port_cluster(c), apps, **kw)
    assert_same(got, jax_got, FIELDS[:3])
    assert_same(got, want)


def test_segmented_sharded_matches_unsharded():
    """Serving windows (per-segment sorts, base threading, commit/reset
    rows) on 8 shards equal the unsharded solve and the JAX sharded one."""
    from tests.test_window_serving import EMAX as W_EMAX
    from tests.test_window_serving import _random_segments, _segment_batch

    rng = np.random.default_rng(21)
    c = random_cluster(rng, 64)
    apps, _ = _segment_batch(_random_segments(rng, 4, 64), 64)
    kw = dict(fill="tightly-pack", emax=W_EMAX, num_zones=NUM_ZONES)
    want = jax_batched(c, apps, **kw)
    jax_got = jax_sharded(jax_mesh(), c, apps, **kw)
    got = sharded_fifo_pack(cpu_mesh(), port_cluster(c), apps, **kw)
    assert_same(got, jax_got, ("driver_node", "executor_nodes", "admitted",
                               "available_after"))
    assert_same(got, want)


def test_grouped_2d_parallel_matches_per_group():
    rng = np.random.default_rng(11)
    clusters = [random_cluster(rng, 32) for _ in range(4)]
    batches = [random_apps(rng, 6, pad_to=8) for _ in range(4)]
    kw = dict(fill="tightly-pack", emax=EMAX, num_zones=NUM_ZONES)
    jax_got = jax_grouped(
        jax_mesh(n_groups=2, n_nodes_shards=4), *jax_stack(clusters, batches),
        **kw,
    )
    sc, sa = stack_groups([port_cluster(c) for c in clusters],
                          [TB.app_batch_to_device(b, "cpu") for b in batches])
    got = grouped_sharded_fifo_pack(cpu_mesh(2, 4), sc, sa, **kw)
    for gi in range(4):
        want = jax_batched(clusters[gi], batches[gi], **kw)
        for f in FIELDS:
            np.testing.assert_array_equal(
                np.asarray(getattr(got, f)[gi]), np.asarray(getattr(want, f)),
                err_msg=f"group {gi} {f}",
            )
            np.testing.assert_array_equal(
                np.asarray(getattr(got, f)[gi]),
                np.asarray(getattr(jax_got, f)[gi]), err_msg=f"group {gi} {f}",
            )


def test_grouped_pallas_sharded_matches_per_group():
    """The group-sharded queue route: 16 groups over an (8, 1) groups mesh,
    the queue path per device (its plain version on `cpu`), against the
    JAX Pallas route under shard_map in interpret mode and the unsharded
    solve, group for group."""
    from spark_scheduler_tpu.parallel.solve import _grouped_pallas_sharded

    rng = np.random.default_rng(17)
    n_dev = 8
    clusters = [random_cluster(rng, 24) for _ in range(2 * n_dev)]
    batches = [random_apps(rng, 4, pad_to=4) for _ in range(2 * n_dev)]
    kw = dict(fill="tightly-pack", emax=EMAX, num_zones=NUM_ZONES)
    jax_got = _grouped_pallas_sharded(
        jax_mesh(n_groups=n_dev, n_nodes_shards=1), *jax_stack(clusters, batches),
        interpret=True, **kw,
    )
    sc, sa = stack_groups([port_cluster(c) for c in clusters],
                          [TB.app_batch_to_device(b, "cpu") for b in batches])
    got = grouped_queue_sharded(cpu_mesh(n_dev, 1), sc, sa, **kw)
    for gi in range(2 * n_dev):
        want = jax_batched(clusters[gi], batches[gi], **kw)
        for f in FIELDS:
            for ref in (getattr(want, f), getattr(jax_got, f)[gi]):
                np.testing.assert_array_equal(
                    np.asarray(getattr(got, f)[gi]), np.asarray(ref),
                    err_msg=f"group {gi} {f}",
                )
    with pytest.raises(ValueError, match="not divisible"):
        grouped_queue_sharded(cpu_mesh(3, 1), sc, sa, **kw)


# ---------------------------------------------------- JAX twins: routing


def _jax_grouped_inputs(seed, n, g, b):
    from tests.test_pallas_fifo import random_apps as fifo_apps

    rng = np.random.default_rng(seed)
    clusters = [random_cluster(rng, n, num_zones=NUM_ZONES) for _ in range(g)]
    batches = [fifo_apps(rng, b) for _ in range(g)]
    port = stack_groups([port_cluster(c) for c in clusters],
                        [TB.app_batch_to_device(x, "cpu") for x in batches])
    return jax_stack(clusters, batches), port


def test_grouped_pallas_fast_path_interpret():
    """The single-card route (`grouped_fifo_pack`, one launch with one team
    a group; its plain version here) and the auto router on a one-device
    mesh equal the JAX per-group Pallas path in interpret mode and the JAX
    2-D scan."""
    from spark_scheduler_tpu.parallel.solve import _grouped_pallas
    from tests.test_pallas_fifo import EMAX as F_EMAX

    (jsc, jsa), (sc, sa) = _jax_grouped_inputs(29, 24, 3, 5)
    kw = dict(fill="tightly-pack", emax=F_EMAX, num_zones=NUM_ZONES)
    want = jax_grouped(jax_mesh(n_groups=1), jsc, jsa, **kw)
    jax_got = _grouped_pallas(jsc, jsa, g=3, interpret=True, **kw)
    assert_same(jax_got, want)
    assert_same(grouped_fifo_pack(sc, sa, **kw), want)
    assert_same(grouped_fifo_pack_auto(cpu_mesh(1, 1), sc, sa, **kw), want)


def test_grouped_auto_falls_back_on_cpu():
    """On CPU tensors every route of `grouped_fifo_pack_auto` takes the
    plain versions and equals the JAX vmapped scan: a one-device mesh, a
    groups-only mesh (the group-sharded route), and a node-sharded mesh
    (the 2-D route)."""
    from tests.test_pallas_fifo import EMAX as F_EMAX

    (jsc, jsa), (sc, sa) = _jax_grouped_inputs(17, 16, 2, 4)
    kw = dict(fill="tightly-pack", emax=F_EMAX, num_zones=NUM_ZONES)
    want = jax_grouped(jax_mesh(n_groups=1), jsc, jsa, **kw)
    for mesh in (cpu_mesh(1, 1), cpu_mesh(2, 1), cpu_mesh(1, 4), cpu_mesh(2, 2)):
        assert_same(grouped_fifo_pack_auto(mesh, sc, sa, **kw), want)


# ------------------------------------- JAX twin: the sharded-mesh engine


def mesh_harness(pkg, groups=1, shards=4, n_groups=4, nodes_per_group=4, **kw):
    """`group_harness` on a `solver.mesh {groups, node-shards}` pool: the
    JAX package's on its virtual devices, the port's on `cpu` shards."""
    harness = mod(pkg, "testing.harness")
    kw.update(solver_mesh_groups=groups, solver_mesh_node_shards=shards)
    if pkg == PORT:
        import functools
        from unittest import mock

        build_app = functools.partial(
            harness.build_scheduler_app, pool_devices=["cpu"] * (groups * shards)
        )
        with mock.patch.object(harness, "build_scheduler_app", build_app):
            h = harness.Harness(device="cpu", binpack_algo="tightly-pack",
                                fifo=True, **kw)
    else:
        h = harness.Harness(binpack_algo="tightly-pack", fifo=True, **kw)
    for g in range(n_groups):
        h.add_nodes(*[
            harness.new_node(f"g{g}-n{i}", zone=f"zone{i % 2}",
                             instance_group=f"group-{g}")
            for i in range(nodes_per_group)
        ])
    return h


def test_multi_device_window_decisions_byte_identical_sharded_mesh():
    """Two overlapped windows (the second dispatched before the first is
    fetched) through one 4-shard mesh slot decide as the single-device
    solver and as the JAX package's sharded mesh, every field of every
    WindowDecision, efficiency floats included."""
    plain = group_world(7)

    def scenario(pkg, mesh):
        h = mesh_harness(pkg) if mesh else group_harness(pkg, 0)
        s = h.app.solver
        nodes = h.backend.list_nodes()
        w1, w2 = build(pkg, plain)
        t1 = s.build_tensors_pipelined(nodes, {}, {})
        h1 = s.pack_window_dispatch("tightly-pack", t1, w1)
        t2 = s.build_tensors_pipelined(nodes, {}, {})
        h2 = s.pack_window_dispatch("tightly-pack", t2, w2)
        out = s.pack_window_fetch(h1) + s.pack_window_fetch(h2)
        if mesh and pkg == PORT:
            assert s.pool_size == 1 and s._pool.slots[0].is_mesh
            assert s.last_solve_info["path"] == "pool"
            assert s.last_solve_info["partitions"] == 1
        return out

    want = scenario(JAX, False)
    assert canon(scenario(JAX, True)) == canon(want)
    single = scenario(PORT, False)
    assert canon(single) == canon(want)
    sharded = scenario(PORT, True)
    assert canon(sharded) == canon(want)
    assert sharded == single  # WindowDecision equality, bit for bit


# --------------------------------------------------------- the port's own


def _port_case(seed, n, mode, labels=False, negative=False, ties=False):
    rng = np.random.default_rng(seed)
    c = random_cluster(rng, n, with_labels=labels)
    if negative:
        avail = np.asarray(c.available).copy()
        neg = rng.random(n) < 0.3
        avail[neg, 0] -= 50
        avail[neg & (rng.random(n) < 0.5), 1] -= 80
        c = dataclasses.replace(c, available=avail)
    if ties:
        c = dataclasses.replace(
            c,
            available=np.tile(np.asarray([[16, 32, 0]], np.int32), (n, 1)),
            schedulable=np.tile(np.asarray([[16, 32, 0]], np.int32), (n, 1)),
            zone_id=(np.arange(n) % 2).astype(np.int32),
            unschedulable=np.zeros(n, bool), ready=np.ones(n, bool),
            valid=np.ones(n, bool),
        )
    kw = {"queue": lambda: queue_batch(rng),
          "masked": lambda: masked_batch(rng, n),
          "window": lambda: window_batch(rng, n)}[mode]()
    kw["exec_counts"][0] = 0  # a zero-count gang on every batch
    return port_cluster(c), TB.make_app_batch(**kw, pad_to=12)


def _check_shards(cluster, apps, fill, shards=(1, 2, 3, 4), emax=8, **kw):
    want = TB.batched_fifo_pack(cluster, apps, fill=fill, emax=emax,
                                num_zones=NUM_ZONES, **kw)
    for s in shards:
        stats: dict = {}
        got = node_sharded_fifo_pack(
            shard_cluster(["cpu"] * s, cluster), apps, fill=fill, emax=emax,
            num_zones=NUM_ZONES, stats=stats, **kw,
        )
        for f in FIELDS:
            assert torch.equal(getattr(got, f), getattr(want, f)), (s, f)
        assert (stats["xbytes"] > 0) == (s > 1)
    return want


@pytest.mark.parametrize("mode", ("queue", "masked", "window"))
@pytest.mark.parametrize("fill", BINPACK_STRATEGIES)
def test_every_fill_and_shard_count_matches_unsharded(fill, mode):
    """S in {1, 2, 3, 4} shards of 36 nodes (9 a shard, wider gangs than a
    shard holds), emax 8 with gangs up to emax + 2: a wide gang never
    packs, a zero-count gang always does, unranked and ranked labels."""
    for seed in (0, 1):
        cluster, apps = _port_case(seed, 36, mode, labels=seed == 1)
        want = _check_shards(cluster, apps, fill)
        if seed == 0 and fill == "tightly-pack":
            assert bool(want.admitted.any())


@pytest.mark.parametrize("mode", ("queue", "masked", "window"))
def test_ties_and_negative_availability_match_unsharded(mode):
    for fill in BINPACK_STRATEGIES:
        _check_shards(*_port_case(3, 36, mode, ties=True), fill, shards=(2, 3))
        _check_shards(*_port_case(11, 36, mode, negative=True), fill,
                      shards=(3, 4))


@pytest.mark.parametrize("fill", ("tightly-pack", "distribute-evenly",
                                  "minimal-fragmentation"))
def test_zone_base_offsets_match_unsharded(fill):
    rng = np.random.default_rng(21)
    sums = rng.integers(0, 2**40, size=(2, NUM_ZONES)).astype(np.int64)
    zb = (
        (sums[0] >> 24).astype(np.int32), (sums[0] & 0xFFFFFF).astype(np.int32),
        (sums[1] >> 24).astype(np.int32), (sums[1] & 0xFFFFFF).astype(np.int32),
        np.asarray([True, False, True, True]),
    )
    for mode in ("masked", "window"):
        _check_shards(*_port_case(5, 36, mode), fill, zone_base=zb)


def test_node_count_not_divisible_raises():
    cluster, apps = _port_case(0, 36, "queue")
    with pytest.raises(ValueError, match="pad with invalid slots"):
        shard_cluster(["cpu"] * 5, cluster)
    with pytest.raises(ValueError, match="pad with invalid slots"):
        sharded_fifo_pack(cpu_mesh(1, 8), cluster, apps, fill="tightly-pack",
                          emax=8, num_zones=NUM_ZONES)
    with pytest.raises(ValueError, match="mesh 2x3 != 4 devices"):
        make_solver_mesh(2, 3, devices=["cpu"] * 4)


@pytest.mark.parametrize("shards", (3, 6))
def test_mesh_slot_shard_count_must_divide_the_node_buckets(shards):
    """The solver pads its node axis to powers of two, so a mesh of 3 or 6
    node shards could never divide it: the solver refuses it at
    construction, and a mesh slot refuses statics it cannot cut evenly,
    never dropping the last rows."""
    from spark_scheduler_tpu_torch.core.device_pool import PoolSlot

    sm = mod(PORT, "core.solver")
    with pytest.raises(ValueError, match="not divisible.*pad with invalid"):
        sm.PlacementSolver(device="cpu", mesh=(1, shards),
                           pool_devices=["cpu"] * shards)
    slot = PoolSlot(cpu_mesh(1, shards), "cpu:0-0")
    fields = [np.zeros(64, np.int32)] * 8
    with pytest.raises(ValueError, match="pad with invalid slots"):
        slot.upload_statics(fields)


def test_pruned_window_on_a_mesh_slot_matches_pool_less():
    """A tight top-K on a one-slot 4-shard mesh: every window solves its
    pruned gather (with its zone_base) on the node-sharded engine, some
    escalate, and the decisions equal the pool-less pruned and unpruned
    solvers'."""
    from tests.test_torch_pool import (
        materialize,
        nodes_of,
        random_windows,
        run_sequential,
    )

    sm = mod(PORT, "core.solver")
    nodes = nodes_of(PORT, 128, zones=3)
    names = [n.name for n in nodes]
    rng = np.random.default_rng(9)
    plain = [random_windows(rng, names, 2, 4, fifo_rows=True) for _ in range(3)]
    batches, usages = materialize(PORT, plain, [{}] * 3)

    def run(**kw):
        s = sm.PlacementSolver(device="cpu", use_native=False, **kw)
        return s, run_sequential(s, nodes, batches, usages)

    _, full = run()
    _, pruned = run(prune_top_k=1, prune_slack=0.01)
    mesh, got = run(prune_top_k=1, prune_slack=0.01, mesh=(1, 4),
                    pool_devices=["cpu"] * 4)
    assert got == pruned == full
    assert mesh.prune_stats["windows"] > 0
    assert mesh.prune_stats["escalations"] > 0
    assert mesh.window_path_counts == {"pool": 6}
    assert list(mesh.device_pool_stats()) == ["cpu:0-0"]
