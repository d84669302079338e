"""The benchmark's single-AZ queue cell, `queue-5k-6az-single-az-w100`, and
its plain reference (`port_bench/reference/single_az.py`), on the CPU.

  - The cell, shrunk by `port_bench/tests/conftest.py::shrink` (400 nodes,
    short queues, seconds of traffic), agrees with the reference, zone
    scores included, and reads `correct`; the control (each window started
    from where the window before it started), a timed path with one
    window's decisions altered and one whose zone scores are rounded to
    float16 read `correct` false.
  - The reference against the port's plain queue path
    (`ops/fifo.fifo_pack_reference`, through `fifo_pack` on CPU tensors)
    and the JAX package's XLA scan (`batched_fifo_pack`) under
    `single-az-tightly-pack`, on seeded clusters: identical zones (exact
    cross-zone ties), a zone with no eligible node, a zone with no node,
    a gang that fits only across zones, GPU nodes with GPU gangs, and 1, 6
    and 8 zones. The port must equal the reference exactly, the zone
    score of every packed row (`fifo_pack_with_scores`) too. The JAX
    package sums a zone's score in float32 in tile order, so it may break
    a cross-zone tie closer than one float32 ulp the other way
    (`ops/gang.py`); where it differs, the test recomputes the two zones'
    scores at the first row that differs and shows they lie within one
    ulp.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

from port_bench import control, run
from port_bench.reference import gang as plain
from port_bench.reference import single_az
from spark_scheduler_tpu.models.cluster import INT32_INF
from spark_scheduler_tpu.models.cluster import ClusterTensors as JaxCluster
from spark_scheduler_tpu.ops.batched import batched_fifo_pack
from spark_scheduler_tpu.ops.batched import make_app_batch as jax_make_app_batch
from spark_scheduler_tpu_torch.ops.fifo import fifo_pack, fifo_pack_with_scores
from tests.test_torch_fifo import port_apps, port_cluster
from tests.test_torch_port_bench import small  # noqa: F401 (the fixture)

CELL = "queue-5k-6az-single-az-w100"
FILL = "single-az-tightly-pack"
EMAX = 8
N = 48
B_PAD = 12


# ------------------------------------------------------------------ the cell


def test_single_az_cell_windows_match_the_reference(small):
    out = run.run_cell(CELL, 2**31 + 2401, 2.0, False, device="cpu",
                       t_start=time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["checks"]["windows_compared"]["value"] >= 4
    assert out["checks"]["decisions_differing"]["value"] == 0
    assert out["checks"]["availability_nodes_differing"]["value"] == 0
    assert out["checks"]["zone_score_max_rel_diff"]["value"] == 0
    assert out["failed"] == 0 and out["attempted"] > 0
    driver = run.run_cell.last_driver
    assert driver.fill == FILL and driver.num_zones == 6


def test_single_az_cell_control_reads_incorrect(small):
    r = control.readings(CELL, 2**31 + 2402, 2.0, device="cpu")
    assert r["correct"] and r["reference"]["decisions_differing"] == 0
    assert r["control"]["decisions_differing"] > 0


def _one_window_altered(driver):
    """The timed path with the driver node of the first admitted app of
    every chain's third window moved to the next node."""
    solve = driver.solve
    calls = []

    def broken(cluster, apps, **kw):
        out, scores = solve(cluster, apps, **kw)
        calls.append(1)
        if len(calls) % driver.windows_per_chain != 3:
            return out, scores
        hits = torch.nonzero(out.admitted)
        if len(hits) == 0:
            return out, scores
        drv = out.driver_node.clone()
        drv[int(hits[0])] = (drv[int(hits[0])] + 1) % cluster.available.shape[0]
        return out._replace(driver_node=drv), scores

    driver.solve = broken


def test_single_az_cell_with_one_window_altered_reads_incorrect(small):
    out = run.run_cell(CELL, 2**31 + 2403, 1.5, False, device="cpu",
                       t_start=time.perf_counter(), patch=_one_window_altered)
    assert not out["correct"], out["checks"]
    assert out["checks"]["decisions_differing"]["value"] > 0


def _scores_in_float16(driver):
    """The timed path with every zone score rounded to float16, as a
    program scoring in float16 would give it."""
    solve = driver.solve

    def half(cluster, apps, **kw):
        out, scores = solve(cluster, apps, **kw)
        return out, scores.half().float()

    driver.solve = half


def test_single_az_cell_with_float16_scores_reads_incorrect(small):
    out = run.run_cell(CELL, 2**31 + 2404, 1.5, False, device="cpu",
                       t_start=time.perf_counter(), patch=_scores_in_float16)
    assert not out["correct"], out["checks"]
    assert out["checks"]["decisions_differing"]["value"] == 0
    worst = out["checks"]["zone_score_max_rel_diff"]
    assert worst["value"] > worst["limit"]


# ------------------------------------------- the reference against the port


def _cluster(rng, num_zones, zone=None, gpus=False):
    """A seeded cluster of N nodes (numpy fields in the JAX package's
    order): roomy nodes, some unschedulable, unready or invalid."""
    avail = np.stack([rng.integers(2, 40, N), rng.integers(4, 64, N),
                      np.zeros(N, np.int64)], 1).astype(np.int32)
    if gpus:
        avail[::2, 2] = rng.integers(0, 5, len(avail[::2]))
    sched = (avail + rng.integers(0, 8, (N, 3)) * (avail > 0)).astype(np.int32)
    if zone is None:
        zone = rng.integers(0, num_zones, N)
    return JaxCluster(
        available=avail, schedulable=sched,
        zone_id=np.asarray(zone, np.int32),
        name_rank=rng.permutation(N).astype(np.int32),
        label_rank_driver=np.full(N, INT32_INF, np.int32),
        label_rank_executor=np.full(N, INT32_INF, np.int32),
        unschedulable=rng.random(N) < 0.1, ready=rng.random(N) > 0.1,
        valid=rng.random(N) > 0.05,
    )


def _apps(rng, b=10, gpus=False):
    driver = rng.integers(1, 6, (b, 3)).astype(np.int32)
    execs = rng.integers(1, 6, (b, 3)).astype(np.int32)
    driver[:, 2] = 0
    execs[:, 2] = rng.integers(0, 2, b) if gpus else 0
    counts = rng.integers(0, EMAX + 1, b).astype(np.int32)
    counts[-1] = EMAX + 1  # never packs
    skip = rng.random(b) < 0.5
    return driver, execs, counts, skip


def case_random(seed, num_zones):
    rng = np.random.default_rng(seed)
    return _cluster(rng, num_zones), _apps(rng), num_zones


def case_identical_zones(seed):
    """Six zones of eight nodes each, node i in zone i % 6, every zone a
    copy of the first (resources and flags; the name ranks differ): every
    zone scores alike, so each gang goes to the zone first in driver
    priority order."""
    rng = np.random.default_rng(seed)
    c = _cluster(rng, 6, zone=np.arange(N) % 6)
    rep = np.repeat(np.arange(N // 6) * 6, 6)
    c = dataclasses.replace(
        c, available=c.available[rep], schedulable=c.schedulable[rep],
        unschedulable=c.unschedulable[rep], ready=c.ready[rep],
        valid=np.ones(N, bool))
    return c, _apps(rng), 6


def case_zone_without_eligible_nodes(seed):
    """Zone 2's nodes are all unschedulable or unready: no driver- or
    executor-eligible node (queue mode makes the two alike)."""
    rng = np.random.default_rng(seed)
    c = _cluster(rng, 6, zone=np.arange(N) % 6)
    i = np.arange(N)  # zone 2 holds nodes 2, 8, 14, ...
    c = dataclasses.replace(c, unschedulable=c.unschedulable | (i % 12 == 2),
                            ready=c.ready & (i % 12 != 8))
    return c, _apps(rng), 6


def case_empty_zone(seed):
    """Eight zones, of which zone 5 has no node."""
    rng = np.random.default_rng(seed)
    zone = rng.choice([0, 1, 2, 3, 4, 6, 7], N)
    return _cluster(rng, 8, zone=zone), _apps(rng), 8


def case_fits_only_across_zones(seed):
    """Four zones of five 4x4 nodes (the rest empty): a gang of 8
    executors of 4x4 fits the cluster but no zone, and is rejected."""
    del seed
    avail = np.zeros((N, 3), np.int32)
    avail[:20] = (4, 4, 0)
    c = JaxCluster(
        available=avail, schedulable=np.full((N, 3), 4, np.int32),
        zone_id=(np.arange(N) % 4).astype(np.int32),
        name_rank=np.arange(N, dtype=np.int32),
        label_rank_driver=np.full(N, INT32_INF, np.int32),
        label_rank_executor=np.full(N, INT32_INF, np.int32),
        unschedulable=np.zeros(N, bool), ready=np.ones(N, bool),
        valid=np.ones(N, bool),
    )
    apps = (np.array([[1, 1, 0], [1, 1, 0]], np.int32),
            np.array([[4, 4, 0], [1, 1, 0]], np.int32),
            np.array([EMAX, 2], np.int32), np.array([True, True]))
    return c, apps, 4


def case_zero_score(seed):
    """Nodes with nothing reserved and gangs that ask for nothing: every
    zone scores exactly 0, so the single-AZ solve rejects what the plain
    tightly-pack admits; a gang that asks for something still packs."""
    rng = np.random.default_rng(seed)
    c = _cluster(rng, 6)
    c = dataclasses.replace(c, schedulable=c.available.copy())
    zero = np.zeros((3, 3), np.int32)
    some = np.array([[0, 0, 0], [0, 0, 0], [1, 1, 0]], np.int32)
    return c, (zero, some, np.array([2, 0, 2], np.int32), np.ones(3, bool)), 6


def case_gpus(seed):
    """Half the nodes carry GPUs and some gangs ask for one an executor:
    the score's GPU dimension counts on GPU nodes only."""
    rng = np.random.default_rng(seed)
    return _cluster(rng, 6, gpus=True), _apps(rng, gpus=True), 6


CASES = {
    "one_zone": lambda: case_random(2401, 1),
    "six_zones": lambda: case_random(2402, 6),
    "eight_zones": lambda: case_random(2403, 8),
    "identical_zones": lambda: case_identical_zones(2404),
    "zone_without_eligible_nodes": lambda: case_zone_without_eligible_nodes(2405),
    "empty_zone": lambda: case_empty_zone(2406),
    "fits_only_across_zones": lambda: case_fits_only_across_zones(2407),
    "gpus": lambda: case_gpus(2408),
    "zero_score": lambda: case_zero_score(2409),
}


def _plain_cluster(c, available=None):
    f = {k.name: np.asarray(getattr(c, k.name)) for k in dataclasses.fields(c)}
    out = {
        "available": (f["available"] if available is None else available).astype(np.int64),
        "schedulable": f["schedulable"].astype(np.int64),
        "zone": f["zone_id"].astype(np.int64),
        "name_rank": f["name_rank"].astype(np.int64),
        "label_rank_driver": f["label_rank_driver"].astype(np.int64),
        "label_rank_executor": f["label_rank_executor"].astype(np.int64),
    }
    out.update({k: f[k] for k in ("unschedulable", "ready", "valid")})
    return out


def _decisions(out, b):
    """(admitted, packed, driver, executors) per row of a packing, as the
    reference's rows give them without their zone scores."""
    adm, packed, drv, execs = (np.asarray(getattr(out, k)) for k in (
        "admitted", "packed", "driver_node", "executor_nodes"))
    return [(bool(adm[j]), bool(packed[j]), int(drv[j]) if adm[j] else -1,
             [int(e) for e in execs[j] if e >= 0] if adm[j] else [])
            for j in range(b)]


def _zone_of_row(c, row):
    return int(np.asarray(c.zone_id)[row[2]]) if row[0] else None


def _sub_ulp_tie(c, apps, num_zones, want, got, r):
    """At row r, where two solves chose different zones: both zones' scores
    by the reference's rule on the availability the row starts from, and
    whether they lie within one float32 ulp."""
    cl = _plain_cluster(c)
    rows = tuple(a[:r] for a in apps)
    _, avail = single_az.queue_pack(FILL, cl, rows, EMAX, num_zones)
    dreq, ereq, count = apps[0][r], apps[1][r], int(apps[2][r])
    views = single_az.zone_views(cl, plain.queue_orders(cl, num_zones), num_zones)
    scores = {}
    for z, (nodes, z_ords, _first, _has) in enumerate(views):
        ok, drv, execs = plain.solve_gang("tightly-pack", count, avail[nodes],
                                          dreq, ereq, z_ords)
        if ok:
            scores[z] = single_az.zone_score(
                cl["schedulable"], avail, int(nodes[drv]),
                [int(nodes[e]) for e in execs], dreq, ereq)
    a, b = scores[_zone_of_row(c, want[r])], scores[_zone_of_row(c, got[r])]
    return abs(float(a) - float(b)) <= float(np.spacing(max(a, b))), (a, b)


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_matches_the_port_and_the_jax_package(case):
    c, apps, num_zones = CASES[case]()
    b = len(apps[2])
    rows, after = single_az.queue_pack(FILL, _plain_cluster(c), apps, EMAX,
                                       num_zones)
    want = [r[:4] for r in rows]
    batch = jax_make_app_batch(*apps[:3], pad_to=B_PAD, skippable=apps[3])

    port, scores = fifo_pack_with_scores(
        port_cluster(c), port_apps(batch), fill=FILL, emax=EMAX,
        num_zones=num_zones)
    assert _decisions(port, b) == want
    np.testing.assert_array_equal(
        scores.numpy(), np.asarray([r[4] for r in rows] + [0.0] * (B_PAD - b),
                                   np.float32))
    assert (scores.numpy()[:b] > 0).sum() == sum(p for _, p, *_ in want)
    assert not port.admitted[b:].any() and not port.packed[b:].any()
    np.testing.assert_array_equal(port.available_after.numpy(), after)

    scan = batched_fifo_pack(c, batch, fill=FILL, emax=EMAX, num_zones=num_zones)
    got = _decisions(scan, b)
    if got != want:
        r = next(j for j in range(b) if got[j] != want[j])
        tie, scores = _sub_ulp_tie(c, apps, num_zones, want, got, r)
        assert tie, (case, r, want[r], got[r], scores)
    else:
        np.testing.assert_array_equal(np.asarray(scan.available_after), after)
    assert sum(adm for adm, *_ in want) > 0


def test_identical_zones_go_to_the_zone_first_in_driver_order():
    c, apps, num_zones = case_identical_zones(2404)
    cl = _plain_cluster(c)
    views = single_az.zone_views(cl, plain.queue_orders(cl, num_zones), num_zones)
    first_zone = min(range(num_zones), key=lambda z: views[z][2])
    rows, _ = single_az.queue_pack(FILL, cl, tuple(a[:1] for a in apps), EMAX,
                                   num_zones)
    assert rows[0][0] and _zone_of_row(c, rows[0]) == first_zone


def test_a_gang_that_fits_only_across_zones_is_rejected():
    c, apps, num_zones = case_fits_only_across_zones(0)
    cl = _plain_cluster(c)
    rows, after = single_az.queue_pack(FILL, cl, apps, EMAX, num_zones)
    assert rows[0] == (False, False, -1, [], 0.0)
    # The plain tightly-pack admits it across zones; the next gang still packs.
    plain_rows, _ = plain.queue_pack("tightly-pack", cl, apps, EMAX, num_zones)
    assert plain_rows[0][0] and rows[1][0]
    zones = {int(cl["zone"][n]) for n in [rows[1][2], *rows[1][3]]}
    assert len(zones) == 1


def test_a_best_score_of_zero_rejects():
    c, apps, num_zones = case_zero_score(2409)
    cl = _plain_cluster(c)
    rows, _ = single_az.queue_pack(FILL, cl, apps, EMAX, num_zones)
    plain_rows, _ = plain.queue_pack("tightly-pack", cl, apps, EMAX, num_zones)
    assert [r[0] for r in rows] == [False, False, True]
    assert [r[0] for r in plain_rows] == [True, True, True]


def test_the_reference_runs_only_its_strategy():
    c, apps, num_zones = case_random(2401, 1)
    with pytest.raises(ValueError):
        single_az.queue_pack("tightly-pack", _plain_cluster(c), apps, EMAX,
                             num_zones)


def test_scores_are_zero_outside_the_zone_strategies():
    c, apps, num_zones = case_random(2402, 6)
    batch = jax_make_app_batch(*apps[:3], pad_to=B_PAD, skippable=apps[3])
    kw = dict(fill="tightly-pack", emax=EMAX, num_zones=num_zones)
    out, scores = fifo_pack_with_scores(port_cluster(c), port_apps(batch), **kw)
    plain_out = fifo_pack(port_cluster(c), port_apps(batch), **kw)
    assert out.admitted.any() and scores.dtype == torch.float32
    assert not scores.any()
    for got, want in zip(out, plain_out):
        assert torch.equal(got, want)

