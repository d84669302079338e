"""The port's closed-form packing and batched engine against the JAX package,
on the CPU.

The same inputs, made with numpy from a seed (the generators of
tests/test_packing_golden.py and tests/test_pallas_fifo.py), go through the
JAX functions and their port counterparts:

  - ops/packing: `spark_bin_pack`, the six strategy functions of
    `BINPACK_FUNCTIONS` on the golden random clusters, and
    `preemption_batched_fit`;
  - ops/batched: `batched_fifo_pack` in queue, masked and window mode for
    all six strategies, with ties, negative availability, a too-big gang
    blocking strict FIFO, and `zone_base` offsets for the plain fills;
    `batched_fifo_pack_carry`; `fuse_app_batches` (fused == sequential);
  - core/solver: `preemption_search`.

Tolerance: none. Every output is integer and must be equal exactly. The
single-AZ zone scores are float32 in both packages and only steer integer
decisions; with these seeds no zone tie falls within the 1-ulp band where
the two summation orders may disagree (ops/efficiency.py `zone_score`).
Most cases share the cluster and batch shapes (37 nodes, 12 rows) so the
JAX programs compile once per strategy and mode.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_scheduler_tpu.ops import batched as JB
from spark_scheduler_tpu.ops import packing as JP
from spark_scheduler_tpu_torch.models.cluster import cluster_statics
from spark_scheduler_tpu_torch.ops import batched as TB
from spark_scheduler_tpu_torch.ops import packing as TP
from tests.test_packing_golden import random_cluster
from tests.test_torch_fifo import port_cluster

EMAX = 8
NUM_ZONES = 4
N = 37
B_PAD = 12
PLAIN = ("tightly-pack", "distribute-evenly", "minimal-fragmentation")
STRATEGIES = TP.BINPACK_STRATEGIES
FIELDS = ("driver_node", "executor_nodes", "admitted", "packed", "available_after")


def t(a, dtype=torch.int32):
    return torch.tensor(np.asarray(a), dtype=dtype)


def assert_same(got, want, fields=FIELDS):
    for f in fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(got, f)), np.asarray(getattr(want, f)), err_msg=f
        )


# ------------------------------------------------------------ spark_bin_pack


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_strategy_functions_match_jax_on_golden_clusters(strategy):
    """Every entry of BINPACK_FUNCTIONS on the golden random clusters (the
    sizes, requests, zero-request edge and masks of
    tests/test_packing_golden.py)."""
    rng = np.random.default_rng(sum(map(ord, strategy)))
    jfn, tfn = JP.BINPACK_FUNCTIONS[strategy], TP.BINPACK_FUNCTIONS[strategy]
    emax = 24
    for trial in range(40):
        n = int(rng.choice([1, 2, 3, 5, 9, 17]))
        c = random_cluster(rng, n, with_labels=trial % 3 == 0)
        driver_req = rng.integers(0, 12, size=3).astype(np.int32)
        exec_req = rng.integers(0, 10, size=3).astype(np.int32)
        if trial % 7 == 0:
            exec_req[:] = 0  # zero request: unbounded capacity
        count = int(rng.integers(0, emax + 1))
        driver_mask = rng.random(n) < 0.7
        domain = rng.random(n) < 0.9
        want = jfn(
            c, jnp.asarray(driver_req), jnp.asarray(exec_req), jnp.int32(count),
            jnp.asarray(driver_mask), jnp.asarray(domain),
            emax=emax, num_zones=NUM_ZONES,
        )
        got = tfn(
            port_cluster(c), t(driver_req), t(exec_req), count,
            t(driver_mask, torch.bool), t(domain, torch.bool),
            emax=emax, num_zones=NUM_ZONES,
        )
        for f in TP.Packing._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(got, f)), np.asarray(getattr(want, f)),
                err_msg=f"{strategy} trial {trial} {f}",
            )


@pytest.mark.parametrize("fill", PLAIN)
def test_spark_bin_pack_with_zone_ranks_given(fill):
    rng = np.random.default_rng(5)
    c = random_cluster(rng, N)
    zrank = np.asarray([2, 0, 3, 1], np.int32)
    args = (
        rng.integers(1, 5, size=3).astype(np.int32),
        rng.integers(1, 6, size=3).astype(np.int32),
    )
    driver_mask = rng.random(N) < 0.8
    domain = np.ones(N, bool)
    want = JP.spark_bin_pack(
        c, *map(jnp.asarray, args), jnp.int32(6), jnp.asarray(driver_mask),
        jnp.asarray(domain), fill=fill, emax=EMAX, num_zones=NUM_ZONES,
        zrank=jnp.asarray(zrank),
    )
    got = TP.spark_bin_pack(
        port_cluster(c), *map(t, args), 6, t(driver_mask, torch.bool),
        t(domain, torch.bool), fill=fill, emax=EMAX, num_zones=NUM_ZONES,
        zrank=t(zrank),
    )
    assert_same(got, want, TP.Packing._fields)


# -------------------------------------------------------- batched_fifo_pack


def random_rows(rng, b):
    driver = rng.integers(1, 6, size=(b, 3)).astype(np.int32)
    driver[:, 2] = rng.integers(0, 2, size=b)
    execs = rng.integers(1, 8, size=(b, 3)).astype(np.int32)
    execs[:, 2] = rng.integers(0, 2, size=b)
    counts = rng.integers(0, EMAX + 3, size=b).astype(np.int32)  # incl. too big
    skip = rng.random(b) < 0.3
    return driver, execs, counts, skip


def queue_batch(rng, b=9):
    driver, execs, counts, skip = random_rows(rng, b)
    return dict(driver_reqs=driver, exec_reqs=execs, exec_counts=counts,
                skippable=skip)


def masked_batch(rng, n, b=9):
    kw = queue_batch(rng, b)
    kw["driver_cand"] = rng.random((b, n)) < 0.7
    kw["domain"] = rng.random((b, n)) < 0.85
    return kw


def window_batch(rng, n, segs=(3, 1, 2, 3)):
    """Segments of FIFO rows: earlier drivers then the committing row; one
    candidate / domain mask per segment."""
    b = sum(segs)
    kw = queue_batch(rng, b)
    commit = np.zeros(b, bool)
    reset = np.zeros(b, bool)
    cand = np.zeros((b, n), bool)
    dom = np.zeros((b, n), bool)
    r = 0
    for s in segs:
        reset[r] = True
        commit[r + s - 1] = True
        cand[r:r + s] = rng.random(n) < 0.7
        dom[r:r + s] = rng.random(n) < 0.9
        r += s
    kw.update(commit=commit, reset=reset, driver_cand=cand, domain=dom)
    return kw


def run_both(c, kw, fill, *, pad_to=B_PAD, emax=EMAX, zone_base=None):
    want = JB.batched_fifo_pack(
        c, JB.make_app_batch(**{**kw}, pad_to=pad_to), fill=fill, emax=emax,
        num_zones=NUM_ZONES,
        zone_base=None if zone_base is None else tuple(map(jnp.asarray, zone_base)),
    )
    got = TB.batched_fifo_pack(
        port_cluster(c), TB.make_app_batch(**kw, pad_to=pad_to), fill=fill,
        emax=emax, num_zones=NUM_ZONES, zone_base=zone_base,
    )
    assert_same(got, want)
    return got


MODES = ("queue", "masked", "window")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fill", STRATEGIES)
def test_batched_fifo_pack_matches_jax(fill, mode):
    for seed in (0, 1):
        rng = np.random.default_rng(seed)
        c = random_cluster(rng, N, with_labels=seed == 1)
        kw = {
            "queue": lambda: queue_batch(rng),
            "masked": lambda: masked_batch(rng, N),
            "window": lambda: window_batch(rng, N),
        }[mode]()
        got = run_both(c, kw, fill)
        if seed == 0 and fill == "tightly-pack":
            assert bool(got.admitted.any())


@pytest.mark.parametrize("mode", MODES)
def test_ties_resolve_like_jax(mode):
    """Identical nodes in two zones with equal sums: every order key ties
    except the node name and the zone id."""
    rng = np.random.default_rng(3)
    c = random_cluster(rng, N)
    c = dataclasses.replace(
        c,
        available=np.tile(np.asarray([[16, 32, 0]], np.int32), (N, 1)),
        schedulable=np.tile(np.asarray([[16, 32, 0]], np.int32), (N, 1)),
        zone_id=(np.arange(N) % 2).astype(np.int32),
        unschedulable=np.zeros(N, bool),
        ready=np.ones(N, bool),
        valid=np.ones(N, bool),
    )
    kw = {"queue": queue_batch, "masked": lambda r: masked_batch(r, N),
          "window": lambda r: window_batch(r, N)}[mode](rng)
    for fill in STRATEGIES:
        run_both(c, kw, fill)


@pytest.mark.parametrize("fill", STRATEGIES)
def test_negative_availability_matches_jax(fill):
    """Over-committed nodes (availability below zero in some dimension)
    have no capacity and rank first in the ascending sorts."""
    rng = np.random.default_rng(11)
    c = random_cluster(rng, N)
    avail = np.asarray(c.available).copy()
    neg = rng.random(N) < 0.3
    avail[neg, 0] -= 50
    avail[neg & (rng.random(N) < 0.5), 1] -= 80
    c = dataclasses.replace(c, available=avail)
    for kw in (queue_batch(rng), masked_batch(rng, N), window_batch(rng, N)):
        run_both(c, kw, fill)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fill", PLAIN)
def test_too_big_gang_blocks_strict_fifo(fill, mode):
    """A non-skippable gang that cannot pack (or is wider than emax) blocks
    every later app in both packages; its `packed` flag still says so."""
    rng = np.random.default_rng(7)
    c = random_cluster(rng, 24)
    b = 5
    driver = np.ones((b, 3), np.int32)
    execs = np.ones((b, 3), np.int32)
    execs[1] = 1000  # unpackable
    counts = np.array([2, 3, 2, EMAX + 4, 2], np.int32)
    kw = dict(driver_reqs=driver, exec_reqs=execs, exec_counts=counts,
              skippable=np.zeros(b, bool))
    if mode == "masked":
        kw.update(driver_cand=np.ones((b, 24), bool), domain=np.ones((b, 24), bool))
    if mode == "window":
        kw.update(commit=np.asarray([0, 0, 0, 0, 1], bool),
                  reset=np.asarray([1, 0, 0, 0, 0], bool))
    got = run_both(c, kw, fill, pad_to=8)
    assert not bool(got.admitted[2:b].any())
    assert not bool(got.packed[3])


@pytest.mark.parametrize("mode", ("masked", "window"))
@pytest.mark.parametrize("fill", PLAIN)
def test_zone_base_offsets_match_jax(fill, mode):
    """Per-zone offsets of rows outside a gathered sub-cluster, as int32
    limbs, reorder the zones in both packages alike; a zone populated only
    by excluded rows counts as present."""
    rng = np.random.default_rng(21)
    c = random_cluster(rng, N)
    sums = rng.integers(0, 2**40, size=(2, NUM_ZONES)).astype(np.int64)
    mem_hi, mem_lo = (sums[0] >> 24).astype(np.int32), (sums[0] & 0xFFFFFF).astype(np.int32)
    cpu_hi, cpu_lo = (sums[1] >> 24).astype(np.int32), (sums[1] & 0xFFFFFF).astype(np.int32)
    present = np.asarray([True, False, True, True])
    zb = (mem_hi, mem_lo, cpu_hi, cpu_lo, present)
    kw = masked_batch(rng, N) if mode == "masked" else window_batch(rng, N)
    with_base = run_both(c, kw, fill, zone_base=zb)
    without = run_both(c, kw, fill)
    assert with_base.driver_node.shape == without.driver_node.shape


@pytest.mark.parametrize("fill", ("single-az-tightly-pack", "az-aware-tightly-pack"))
def test_zone_base_refused_for_single_az(fill):
    rng = np.random.default_rng(1)
    c = port_cluster(random_cluster(rng, N))
    zb = tuple(np.zeros(NUM_ZONES, np.int32) for _ in range(4)) + (
        np.zeros(NUM_ZONES, bool),)
    with pytest.raises(ValueError, match="plain fills"):
        TB.batched_fifo_pack(
            c, TB.make_app_batch(**masked_batch(rng, N)), fill=fill,
            emax=EMAX, num_zones=NUM_ZONES, zone_base=zb,
        )


def test_carry_variant_equals_the_plain_call():
    rng = np.random.default_rng(4)
    c = port_cluster(random_cluster(rng, N))
    apps = TB.make_app_batch(**window_batch(rng, N), pad_to=B_PAD)
    before = c.available.clone()
    want = TB.batched_fifo_pack(c, apps, fill="tightly-pack", emax=EMAX,
                                num_zones=NUM_ZONES)
    got = TB.batched_fifo_pack_carry(
        c.available, cluster_statics(c), apps, fill="tightly-pack",
        emax=EMAX, num_zones=NUM_ZONES,
    )
    assert_same(got, want)
    assert torch.equal(c.available, before)  # the input carry is untouched


# -------------------------------------------------------- fuse_app_batches


@pytest.mark.parametrize("fill", ("tightly-pack", "single-az-minimal-fragmentation"))
def test_fuse_app_batches_fused_equals_sequential(fill):
    """K window batches fused into one equal the K batches run one after
    another with `available_after` threaded between them, and the fused
    batch equals the JAX package's."""
    rng = np.random.default_rng(9)
    c = port_cluster(random_cluster(rng, N))
    kws = [window_batch(rng, N, segs) for segs in ((2, 1), (1, 3, 1), (2,))]
    # The middle batch carries no masks: all-true ones stand in for them.
    kws[1].pop("driver_cand")
    kws[1].pop("domain")
    batches = [TB.make_app_batch(**kw, pad_to=8) for kw in kws]
    fused = TB.fuse_app_batches(batches, pad_to=16)
    jfused = JB.fuse_app_batches(
        [JB.make_app_batch(**kw, pad_to=8) for kw in kws], pad_to=16
    )
    for f in TB.AppBatch._fields:
        np.testing.assert_array_equal(getattr(fused, f), getattr(jfused, f), f)
    out = TB.batched_fifo_pack(c, fused, fill=fill, emax=EMAX, num_zones=NUM_ZONES)
    avail = c.available
    rows = []
    for apps in batches:
        one = TB.batched_fifo_pack(
            dataclasses.replace(c, available=avail), apps, fill=fill,
            emax=EMAX, num_zones=NUM_ZONES,
        )
        real = np.flatnonzero(apps.app_valid)
        rows.append((one.driver_node[real], one.executor_nodes[real],
                     one.admitted[real], one.packed[real]))
        avail = one.available_after
    k = sum(len(r[0]) for r in rows)
    for i, f in enumerate(("driver_node", "executor_nodes", "admitted", "packed")):
        assert torch.equal(getattr(out, f)[:k], torch.cat([r[i] for r in rows])), f
    assert torch.equal(out.available_after, avail)
    assert bool(out.admitted.any())


def test_fuse_app_batches_refuses_queue_batches():
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError, match="segmented"):
        TB.fuse_app_batches([TB.make_app_batch(**queue_batch(rng))])
    with pytest.raises(ValueError, match="at least one"):
        TB.fuse_app_batches([])


# --------------------------------------------------------------- preemption


def freed_sets(rng, c, k):
    """Nested candidate eviction sets: set i frees victims 0..i."""
    victims = rng.integers(0, 40, size=(k, N, 3)).astype(np.int32)
    victims[:, rng.random(N) < 0.6] = 0
    return np.cumsum(victims, axis=0).astype(np.int32)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_preemption_batched_fit_matches_jax(strategy):
    rng = np.random.default_rng(31)
    c = random_cluster(rng, N)
    freed = freed_sets(rng, c, 5)
    driver_req = np.asarray([2, 4, 0], np.int32)
    exec_req = np.asarray([30, 50, 0], np.int32)
    driver_mask = rng.random(N) < 0.8
    domain = rng.random(N) < 0.9
    fill = TP.PREEMPTION_FILL[strategy]
    assert fill == JP.PREEMPTION_FILL[strategy]
    want = JP.preemption_batched_fit(
        c, jnp.asarray(freed), jnp.asarray(driver_req), jnp.asarray(exec_req),
        jnp.int32(7), jnp.asarray(driver_mask), jnp.asarray(domain),
        fill=fill, emax=EMAX, num_zones=NUM_ZONES,
    )
    got = TP.preemption_batched_fit(
        port_cluster(c), t(freed), t(driver_req), t(exec_req), 7,
        t(driver_mask, torch.bool), t(domain, torch.bool),
        fill=fill, emax=EMAX, num_zones=NUM_ZONES,
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    ok = np.asarray(got[0])
    assert not ok.all()  # the search has a first feasible index to find
