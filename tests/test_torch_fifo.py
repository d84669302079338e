"""Parity of the PyTorch port's queue-mode admission with the JAX package, on
the CPU.

The same inputs, made with numpy from a seed (the generators of
tests/test_pallas_fifo.py), go through the JAX functions and their port
counterparts:

  - ops/batched: `queue_mode_orders` and `make_app_batch`;
  - ops/fifo: `fifo_pack` on CPU tensors (its plain version,
    `fifo_pack_reference`) against the JAX package's Mosaic queue kernel run
    by the Pallas interpreter (`fifo_pack_pallas(..., interpret=True)`) AND
    its XLA scan (`batched_fifo_pack`), for all six strategies;
  - parallel/solve: `grouped_fifo_pack` against `_grouped_pallas` (Pallas
    interpreter) and `grouped_fifo_pack` on a one-group mesh;
  - the slice as a whole: a threaded chain of windows in the shape of
    BASELINE config 5 against `fifo_pack_auto`.

Tolerance: none. Every output (drivers, executor slots, both flags, the
availability after) is integer and must be equal exactly. Single-AZ zone
scores are float32 in both packages and only steer integer decisions; with
these seeds no zone tie falls within the 1-ulp band where the two summation
orders may disagree. Most cases share the cluster and batch shapes
(37 nodes, 12 rows) so the JAX programs compile once per strategy.
"""

import dataclasses

import numpy as np
import pytest
import torch

from spark_scheduler_tpu.models.cluster import INT32_INF
from spark_scheduler_tpu.models.cluster import ClusterTensors as JaxCluster
from spark_scheduler_tpu.ops.batched import batched_fifo_pack
from spark_scheduler_tpu.ops.batched import make_app_batch as jax_make_app_batch
from spark_scheduler_tpu.ops.batched import (
    queue_mode_orders as jax_queue_mode_orders,
)
from spark_scheduler_tpu.ops.pallas_fifo import fifo_pack_auto, fifo_pack_pallas
from spark_scheduler_tpu.parallel import grouped_fifo_pack as jax_grouped
from spark_scheduler_tpu.parallel import make_solver_mesh
from spark_scheduler_tpu.parallel import stack_groups as jax_stack_groups
from spark_scheduler_tpu.parallel.solve import _grouped_pallas
from spark_scheduler_tpu_torch.models.cluster import cluster_from_numpy
from spark_scheduler_tpu_torch.ops.batched import (
    AppBatch,
    app_batch_to_device,
    make_app_batch,
    queue_mode_orders,
)
from spark_scheduler_tpu_torch.ops.fifo import (
    fifo_eligible,
    fifo_pack,
    fifo_pack_reference,
)
from spark_scheduler_tpu_torch.parallel import grouped_fifo_pack, stack_groups
from tests.test_packing_golden import random_cluster
from tests.test_pallas_fifo import random_apps

EMAX = 8
NUM_ZONES = 4
N = 37
B_PAD = 12
FILLS = ("tightly-pack", "distribute-evenly", "minimal-fragmentation")
SINGLE_AZ = (
    "single-az-tightly-pack",
    "single-az-minimal-fragmentation",
    "az-aware-tightly-pack",
)
STRATEGIES = FILLS + SINGLE_AZ
FIELDS = ("driver_node", "executor_nodes", "admitted", "packed", "available_after")


def port_cluster(c):
    """The port's CPU ClusterTensors from a JAX-package one (copied)."""
    return cluster_from_numpy(
        [np.asarray(getattr(c, f.name)) for f in dataclasses.fields(c)],
        device="cpu",
    )


def port_apps(apps):
    return app_batch_to_device(apps, "cpu")


def assert_same(got, want, msg=""):
    for field in FIELDS:
        g = getattr(got, field)
        assert isinstance(g, torch.Tensor), field
        np.testing.assert_array_equal(
            g.numpy(), np.asarray(getattr(want, field)), err_msg=f"{msg} {field}"
        )


def solve_all(c, apps, fill):
    """(port fifo_pack, JAX Pallas interpreter, JAX XLA scan)."""
    got = fifo_pack(
        port_cluster(c), port_apps(apps), fill=fill, emax=EMAX,
        num_zones=NUM_ZONES,
    )
    pallas = fifo_pack_pallas(
        c, apps, fill=fill, emax=EMAX, num_zones=NUM_ZONES, interpret=True
    )
    scan = batched_fifo_pack(c, apps, fill=fill, emax=EMAX, num_zones=NUM_ZONES)
    return got, pallas, scan


def check_all(c, apps, fill, msg=""):
    got, pallas, scan = solve_all(c, apps, fill)
    assert_same(got, pallas, f"{fill} {msg} vs pallas")
    assert_same(got, scan, f"{fill} {msg} vs scan")
    return got


@pytest.mark.parametrize("fill", STRATEGIES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fifo_pack_matches_pallas_and_scan(fill, seed):
    rng = np.random.default_rng(seed * 13 + 5)
    c = random_cluster(rng, N, num_zones=NUM_ZONES)
    apps = random_apps(rng, 9, pad_to=B_PAD)
    got = check_all(c, apps, fill, f"seed={seed}")
    assert got.executor_nodes.shape == (B_PAD, EMAX)
    assert not got.admitted[9:].any() and not got.packed[9:].any()


@pytest.mark.parametrize("fill", STRATEGIES)
def test_strict_fifo_blocking(fill):
    """A huge non-skippable gang blocks everything behind it; its own
    `packed` is False and the later rows still report theirs."""
    rng = np.random.default_rng(7)
    c = random_cluster(rng, N, num_zones=NUM_ZONES)
    driver = np.ones((4, 3), np.int32)
    execs = np.ones((4, 3), np.int32)
    execs[1] = 1000  # unpackable
    counts = np.array([2, 8, 2, 2], np.int32)
    apps = jax_make_app_batch(
        driver, execs, counts, pad_to=B_PAD, skippable=np.zeros(4, bool)
    )
    got = check_all(c, apps, fill, "blocking")
    assert not bool(got.packed[1])
    assert not got.admitted[2:].any()


@pytest.mark.parametrize("fill", STRATEGIES)
def test_negative_availability_and_zero_count(fill):
    """Overcommitted nodes (negative availability) have capacity 0, and a
    zero-executor gang admits a driver only."""
    rng = np.random.default_rng(11)
    c = random_cluster(rng, N, num_zones=NUM_ZONES)
    avail = np.asarray(c.available).copy()
    avail[3] = -5
    avail[7, 0] = -1
    c = dataclasses.replace(c, available=avail)
    apps = jax_make_app_batch(
        np.ones((3, 3), np.int32), np.ones((3, 3), np.int32),
        np.array([0, 3, 0], np.int32), pad_to=B_PAD,
    )
    got = check_all(c, apps, fill, "negative")
    admitted = got.admitted.numpy()
    for r in (0, 2):
        if admitted[r]:
            assert (got.executor_nodes[r] == -1).all()
            assert int(got.driver_node[r]) not in (3, 7)


@pytest.mark.parametrize("fill", SINGLE_AZ)
def test_single_az_gpu_scoring(fill):
    """The zone score's per-node max includes the GPU ratio only where
    schedulable GPU exists (efficiency.go:139-144)."""
    rng = np.random.default_rng(37)
    c = random_cluster(rng, N, num_zones=NUM_ZONES)
    sched = np.asarray(c.schedulable).copy()
    avail = np.asarray(c.available).copy()
    sched[::2, 2] = 4
    avail[::2, 2] = rng.integers(0, 5, size=len(avail[::2]))
    c = dataclasses.replace(c, schedulable=sched, available=np.minimum(avail, sched))
    execs = np.ones((6, 3), np.int32)
    execs[:, 2] = rng.integers(0, 2, size=6)
    counts = rng.integers(1, EMAX + 1, size=6).astype(np.int32)
    apps = jax_make_app_batch(
        np.ones((6, 3), np.int32), execs, counts, pad_to=B_PAD
    )
    check_all(c, apps, fill, "gpu scoring")


def test_single_az_rejects_when_no_zone_fits():
    """A gang that no single zone holds: the single-AZ strategies reject
    it, az-aware admits it through the plain fallback."""
    n = N
    avail = np.zeros((n, 3), np.int32)
    avail[:20] = (4, 4, 0)  # five roomy nodes per zone; a gang needs nine
    c = JaxCluster(
        available=avail, schedulable=np.full((n, 3), 4, np.int32),
        zone_id=(np.arange(n) % NUM_ZONES).astype(np.int32),
        name_rank=np.arange(n, dtype=np.int32),
        label_rank_driver=np.full(n, INT32_INF, np.int32),
        label_rank_executor=np.full(n, INT32_INF, np.int32),
        unschedulable=np.zeros(n, bool), ready=np.ones(n, bool),
        valid=np.ones(n, bool),
    )
    apps = jax_make_app_batch(
        np.array([[1, 1, 0]], np.int32), np.array([[4, 4, 0]], np.int32),
        np.array([EMAX], np.int32), pad_to=B_PAD,
    )
    for fill, admit in (
        ("single-az-tightly-pack", False),
        ("single-az-minimal-fragmentation", False),
        ("az-aware-tightly-pack", True),
    ):
        got = check_all(c, apps, fill, "no zone fits")
        assert bool(got.admitted[0]) is admit, fill


def test_empty_batch():
    """B = 0: no launch, empty outputs, and a COPY of the availability."""
    rng = np.random.default_rng(13)
    c = random_cluster(rng, 16, num_zones=NUM_ZONES)
    apps = jax_make_app_batch(
        np.zeros((0, 3), np.int32), np.zeros((0, 3), np.int32),
        np.zeros(0, np.int32),
    )
    pc = port_cluster(c)
    want = fifo_pack_pallas(
        c, apps, fill="tightly-pack", emax=EMAX, num_zones=NUM_ZONES,
        interpret=True,
    )
    for fn in (fifo_pack, fifo_pack_reference):
        got = fn(pc, port_apps(apps), fill="tightly-pack", emax=EMAX,
                 num_zones=NUM_ZONES)
        assert got.driver_node.shape == (0,)
        assert got.executor_nodes.shape == (0, EMAX)
        assert_same(got, want, "empty")
        assert got.available_after.data_ptr() != pc.available.data_ptr()


def test_masked_and_segmented_batches_raise():
    rng = np.random.default_rng(3)
    c = port_cluster(random_cluster(rng, 16, num_zones=NUM_ZONES))
    apps = port_apps(random_apps(rng, 4))
    assert fifo_eligible(apps, "tightly-pack")
    ones = torch.ones((4, 16), dtype=torch.bool)
    flags = torch.zeros(4, dtype=torch.bool)
    bad = [
        apps._replace(domain=ones),
        apps._replace(driver_cand=ones),
        apps._replace(commit=flags, reset=flags),
    ]
    for b in bad:
        assert not fifo_eligible(b, "tightly-pack")
        for fn in (fifo_pack, fifo_pack_reference):
            with pytest.raises(ValueError, match="queue mode"):
                fn(c, b, fill="tightly-pack", emax=EMAX, num_zones=NUM_ZONES)
    with pytest.raises(ValueError, match="queue mode"):
        fifo_pack(c, apps, fill="first-fit", emax=EMAX, num_zones=NUM_ZONES)
    sc, sa = stack_groups([c, c], [bad[0], bad[0]])
    with pytest.raises(ValueError, match="queue mode"):
        grouped_fifo_pack(sc, sa, emax=EMAX, num_zones=NUM_ZONES)


def test_fifo_pack_refuses_other_devices():
    rng = np.random.default_rng(4)
    c = random_cluster(rng, 8, num_zones=NUM_ZONES)
    meta_c = cluster_from_numpy(
        [np.asarray(getattr(c, f.name)) for f in dataclasses.fields(c)],
        device="meta",
    )
    apps = app_batch_to_device(random_apps(rng, 2), "meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fifo_pack(meta_c, apps, emax=EMAX, num_zones=NUM_ZONES)
    sc, sa = stack_groups([meta_c], [apps])
    with pytest.raises(ValueError, match="cuda or cpu"):
        grouped_fifo_pack(sc, sa, emax=EMAX, num_zones=NUM_ZONES)


@pytest.mark.parametrize("fill", ["tightly-pack", "az-aware-tightly-pack"])
def test_inputs_left_unchanged(fill):
    """`available_after` is a new tensor: after any call the caller's
    availability (and app batch) are as they were, and the host arrays
    handed to the port are never aliased."""
    rng = np.random.default_rng(21)
    c = random_cluster(rng, N, num_zones=NUM_ZONES)
    apps = random_apps(rng, 9, pad_to=B_PAD)
    apps = apps._replace(skippable=np.ones(B_PAD, bool))  # nothing blocks
    host_avail = np.asarray(c.available).copy()
    pc = port_cluster(c)
    pa = port_apps(apps)
    before = pc.available.clone()
    apps_before = [None if t is None else t.clone() for t in pa]
    outs = [
        fifo_pack(pc, pa, fill=fill, emax=EMAX, num_zones=NUM_ZONES),
        fifo_pack_reference(pc, pa, fill=fill, emax=EMAX, num_zones=NUM_ZONES),
    ]
    sc, sa = stack_groups([pc, pc], [pa, pa])
    stacked_before = sc.available.clone()
    grouped = grouped_fifo_pack(sc, sa, fill=fill, emax=EMAX, num_zones=NUM_ZONES)
    assert torch.equal(sc.available, stacked_before)
    assert torch.equal(pc.available, before)
    for t, t0 in zip(pa, apps_before):
        assert t is None or torch.equal(t, t0)
    for out in outs:
        assert out.admitted.any()
        assert not torch.equal(out.available_after, before)
        assert out.available_after.data_ptr() != pc.available.data_ptr()
        assert torch.equal(grouped.available_after[1], out.available_after)
    # Copies, not aliases: writing to the port's tensors leaves the host
    # arrays alone, and the reverse.
    pc.available.zero_()
    pa.exec_count.zero_()
    np.testing.assert_array_equal(np.asarray(c.available), host_avail)
    assert np.asarray(apps.exec_count).any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_queue_mode_orders_match_jax(seed):
    rng = np.random.default_rng(seed + 50)
    c = random_cluster(rng, 64, num_zones=5, with_labels=True)
    want = jax_queue_mode_orders(c, 6)  # zone 5 is empty and ranks last
    got = queue_mode_orders(port_cluster(c), 6)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=str(i))


def test_make_app_batch_matches_jax():
    rng = np.random.default_rng(8)
    b, n = 5, 11
    drv = rng.integers(0, 9, (b, 3))
    exe = rng.integers(0, 9, (b, 3))
    cnt = rng.integers(0, 9, b)
    skip = rng.random(b) < 0.5
    cand = rng.random((b, n)) < 0.5
    dom = rng.random((b, n)) < 0.5
    commit = rng.random(b) < 0.5
    reset = rng.random(b) < 0.5
    for kwargs in (
        {},
        {"pad_to": 8},
        {"pad_to": 3, "skippable": skip},
        {"pad_to": 8, "skippable": skip, "driver_cand": cand, "domain": dom},
        {"pad_to": 8, "commit": commit, "reset": reset},
    ):
        got = make_app_batch(drv, exe, cnt, **kwargs)
        want = jax_make_app_batch(drv, exe, cnt, **kwargs)
        assert isinstance(got, AppBatch)
        for field in AppBatch._fields:
            g, w = getattr(got, field), getattr(want, field)
            assert (g is None) == (w is None), field
            if g is not None:
                assert g.dtype == np.asarray(w).dtype, field
                np.testing.assert_array_equal(g, np.asarray(w), err_msg=field)
    for fn in (make_app_batch, jax_make_app_batch):
        with pytest.raises(ValueError, match="commit AND reset"):
            fn(drv, exe, cnt, commit=commit)


@pytest.mark.parametrize("fill", ["tightly-pack", "single-az-tightly-pack"])
def test_grouped_matches_jax(fill):
    """Three groups: the port's grouped solve equals the JAX package's
    single-chip Pallas route and its vmapped scan on a one-group mesh."""
    rng = np.random.default_rng(29)
    # 24 nodes: divisible by the virtual mesh's 8-way node axis.
    clusters = [random_cluster(rng, 24, num_zones=NUM_ZONES) for _ in range(3)]
    batches = [random_apps(rng, 5, pad_to=8) for _ in range(3)]
    sc, sa = jax_stack_groups(clusters, batches)
    want_p = _grouped_pallas(sc, sa, fill=fill, emax=EMAX,
                             num_zones=NUM_ZONES, g=3, interpret=True)
    want_s = jax_grouped(make_solver_mesh(n_groups=1), sc, sa, fill=fill,
                         emax=EMAX, num_zones=NUM_ZONES)
    pc, pa = stack_groups(
        [port_cluster(c) for c in clusters], [port_apps(a) for a in batches]
    )
    got = grouped_fifo_pack(pc, pa, fill=fill, emax=EMAX, num_zones=NUM_ZONES)
    assert got.executor_nodes.shape == (3, 8, EMAX)
    assert_same(got, want_p, "grouped vs pallas")
    assert_same(got, want_s, "grouped vs scan")
    # Each group equals its own single-queue solve.
    for g in range(3):
        one = fifo_pack(port_cluster(clusters[g]), port_apps(batches[g]),
                        fill=fill, emax=EMAX, num_zones=NUM_ZONES)
        for field in FIELDS:
            assert torch.equal(getattr(got, field)[g], getattr(one, field))


def test_stack_groups_refuses_mixed_shapes():
    rng = np.random.default_rng(2)
    c1 = port_cluster(random_cluster(rng, 16, num_zones=NUM_ZONES))
    c2 = port_cluster(random_cluster(rng, 24, num_zones=NUM_ZONES))
    a = port_apps(random_apps(rng, 4))
    with pytest.raises(ValueError, match="one padded shape"):
        stack_groups([c1, c2], [a, a])
    with pytest.raises(ValueError, match="one padded shape"):
        stack_groups([c1, c1], [a, port_apps(random_apps(rng, 5))])
    masked = a._replace(domain=torch.ones((4, 16), dtype=torch.bool))
    with pytest.raises(ValueError, match="every group or none"):
        stack_groups([c1, c1], [a, masked])


def _baseline_cluster(rng, n_nodes, num_zones):
    """bench.py `_make_cluster` (:65-86), as numpy."""
    avail = np.empty((n_nodes, 3), np.int32)
    avail[:, 0] = rng.integers(8, 96, size=n_nodes)
    avail[:, 1] = rng.integers(16, 256, size=n_nodes)
    avail[:, 2] = rng.integers(0, 2, size=n_nodes)
    return JaxCluster(
        available=avail, schedulable=avail.copy(),
        zone_id=rng.integers(0, num_zones, size=n_nodes).astype(np.int32),
        name_rank=rng.permutation(n_nodes).astype(np.int32),
        label_rank_driver=np.full(n_nodes, INT32_INF, np.int32),
        label_rank_executor=np.full(n_nodes, INT32_INF, np.int32),
        unschedulable=np.zeros(n_nodes, bool), ready=np.ones(n_nodes, bool),
        valid=np.ones(n_nodes, bool),
    )


def _baseline_batches(rng, n_apps, window, emax):
    """bench.py `_make_batches` (:89-112), as JAX-package app batches."""
    driver = rng.integers(1, 4, size=(n_apps, 3)).astype(np.int32)
    driver[:, 2] = 0
    execs = rng.integers(1, 6, size=(n_apps, 3)).astype(np.int32)
    execs[:, 2] = 0
    counts = rng.integers(1, emax + 1, size=n_apps).astype(np.int32)
    return [
        jax_make_app_batch(
            driver[lo:lo + window], execs[lo:lo + window],
            counts[lo:lo + window],
            skippable=np.full(min(window, n_apps - lo), True, bool),
        )
        for lo in range(0, n_apps, window)
    ]


def test_config5_chain_matches_fifo_pack_auto():
    """The slice as a whole: BASELINE config 5's shape (4 zones, windows of
    100 apps, emax 8, tightly-pack) at 200 nodes, three windows with the
    availability threaded from window to window, as bench.py's
    `_windowed_chain` does: each window is sorted from the availability the
    previous one left."""
    rng = np.random.default_rng(5)
    c = _baseline_cluster(rng, 200, NUM_ZONES)
    batches = _baseline_batches(rng, 300, 100, EMAX)
    pc = port_cluster(c)
    start = pc.available.clone()
    debit = np.zeros(3, np.int64)
    for apps in batches:
        want = fifo_pack_auto(c, apps, fill="tightly-pack", emax=EMAX,
                              num_zones=NUM_ZONES)
        got = fifo_pack(pc, port_apps(apps), fill="tightly-pack", emax=EMAX,
                        num_zones=NUM_ZONES)
        assert_same(got, want, "chain")
        c = dataclasses.replace(c, available=np.asarray(want.available_after))
        pc = dataclasses.replace(pc, available=got.available_after)
        adm = got.admitted.numpy()
        counts = np.asarray(apps.exec_count)
        debit += np.asarray(apps.driver_req)[adm].sum(0)
        debit += (np.asarray(apps.exec_req)[adm] * counts[adm, None]).sum(0)
    assert debit[0] > 0
    np.testing.assert_array_equal(
        (start - pc.available).sum(0).numpy(), debit
    )
