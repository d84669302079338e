"""Parity of the PyTorch port's window path with the JAX package, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX function and
its port counterpart:

  - ops/capacity.node_capacities, ops/sorting.zone_ranks,
    ops/sorting.priority_order and ops/sorting.priority_orders (the shared
    passes over packed int64 keys) against the JAX functions, on clusters at
    the edges of those keys (availability at +-INT32_INF, the whole int32
    range, ties, padding rows, unranked labels, empty zones, 1-64 zones, a
    negative zone_base);
  - the port's plain window solve (`window_pack_reference`, built on
    ops/gang.gang_solve) and its CPU wrapper `window_pack` against the JAX
    package's Mosaic window kernel run by the Pallas interpreter
    (`window_pack_pallas(..., interpret=True)`), for all six strategies.

Tolerance: none. Every compared output is integer (capacities, ranks,
orders, drivers, executor slots, flags, the committed base) and must be
equal exactly. The single-AZ zone scores are float32 in both packages and
only steer integer decisions; with these seeds no zone tie falls within the
1-ulp band where the two summation orders may disagree.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from spark_scheduler_tpu.models.cluster import ClusterTensors, INT32_INF
from spark_scheduler_tpu.ops.capacity import node_capacities as jax_caps
from spark_scheduler_tpu.ops.pallas_window import (
    make_segmented_window as jax_make_window,
    window_pack_pallas,
)
from spark_scheduler_tpu.ops.batched import (
    queue_mode_orders as jax_queue_mode_orders,
)
from spark_scheduler_tpu.ops.sorting import (
    priority_order as jax_priority_order,
    zone_ranks as jax_zone_ranks,
)
from spark_scheduler_tpu_torch.models.cluster import cluster_from_numpy
from spark_scheduler_tpu_torch.ops.capacity import node_capacities
from spark_scheduler_tpu_torch.ops.batched import queue_mode_orders
from spark_scheduler_tpu_torch.ops.sorting import (
    MAX_PACKED_ZONES,
    priority_order,
    priority_orders,
    zone_ranks,
)
from spark_scheduler_tpu_torch.ops.window import (
    make_segmented_window,
    window_pack,
    window_pack_reference,
)

FILLS = ("tightly-pack", "distribute-evenly", "minimal-fragmentation")
STRATEGIES = FILLS + (
    "single-az-tightly-pack",
    "single-az-minimal-fragmentation",
    "az-aware-tightly-pack",
)


def _cluster_np(rng, n, num_zones=4, hi=24):
    """Nine ClusterTensors fields as numpy arrays (tests/test_pallas_window.py
    generator; a small `hi` makes a tight cluster where gangs fail)."""
    avail = rng.integers(0, hi, size=(n, 3)).astype(np.int32)
    avail[:, 2] = rng.integers(0, 3, size=n)
    return [
        avail,
        avail.copy(),
        rng.integers(0, num_zones, size=n).astype(np.int32),
        rng.permutation(n).astype(np.int32),
        np.full(n, INT32_INF, np.int32),
        np.full(n, INT32_INF, np.int32),
        rng.random(n) < 0.1,
        rng.random(n) > 0.05,
        np.ones(n, bool),
    ]


def _both(fields):
    jax_c = ClusterTensors(*(jnp.asarray(f) for f in fields))
    return jax_c, cluster_from_numpy(fields, device="cpu")


def _random_requests(rng, n, n_requests, max_rows, emax):
    """Per-request FIFO rows + masks (tests/test_pallas_window.py)."""
    requests, cands, doms = [], [], []
    for _ in range(n_requests):
        rows = []
        for _ in range(rng.integers(1, max_rows + 1)):
            dr = rng.integers(0, 5, size=3).astype(np.int32)
            er = rng.integers(1, 4, size=3).astype(np.int32)
            dr[2] = 0
            er[2] = rng.integers(0, 2)
            cnt = int(rng.integers(0, emax + 1))
            rows.append((dr, er, cnt, bool(rng.random() < 0.3)))
        requests.append(rows)
        cands.append(rng.random(n) < (0.95 if rng.random() < 0.7 else 0.4))
        doms.append(rng.random(n) < (1.0 if rng.random() < 0.6 else 0.6))
    return requests, cands, doms


def _pallas(jax_c, requests, cands, doms, fill, emax, num_zones):
    win = jax_make_window(requests, cands, doms)
    meta, execs, base = window_pack_pallas(
        jax_c, win, fill=fill, emax=emax, num_zones=num_zones, interpret=True
    )
    return np.asarray(meta), np.asarray(execs), np.asarray(base)


def _assert_same(got, want, msg):
    for name, g, w in zip(("meta", "execs", "base_after"), got, want):
        np.testing.assert_array_equal(
            g.numpy(), w, err_msg=f"{msg} {name}"
        )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_node_capacities_match_jax(seed):
    rng = np.random.default_rng(seed)
    n = 64
    avail = rng.integers(-4, 40, size=(n, 3)).astype(np.int32)
    reserved = rng.integers(0, 8, size=(n, 3)).astype(np.int32)
    for request in (
        rng.integers(0, 6, size=3).astype(np.int32),
        np.array([0, 0, 0], np.int32),
        np.array([3, 0, 1], np.int32),
    ):
        want = np.asarray(
            jax_caps(jnp.asarray(avail), jnp.asarray(reserved),
                     jnp.asarray(request))
        )
        got = node_capacities(
            torch.tensor(avail), torch.tensor(reserved), torch.tensor(request)
        )
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_zone_ranks_and_priority_order_match_jax(seed):
    rng = np.random.default_rng(seed + 100)
    n, num_zones = 96, 8  # zones 5..7 are absent and must rank last
    fields = _cluster_np(rng, n, num_zones=5)
    # Large and negative availability exercise the 8-bit-chunk zone sums.
    fields[0][:, :2] = rng.integers(-2**20, 2**30, size=(n, 2))
    fields[4] = rng.integers(0, 3, size=n).astype(np.int32)
    fields[8] = rng.random(n) < 0.9
    jax_c, port_c = _both(fields)
    dom = rng.random(n) < 0.8
    elig = dom & (rng.random(n) < 0.7)
    want_z = np.asarray(jax_zone_ranks(jax_c, jnp.asarray(dom), num_zones))
    got_z = zone_ranks(port_c, torch.tensor(dom), num_zones)
    np.testing.assert_array_equal(got_z.numpy(), want_z)
    for label in (jax_c.label_rank_driver, jax_c.label_rank_executor):
        want_o, want_c = jax_priority_order(
            jax_c, jnp.asarray(elig), jnp.asarray(want_z), label
        )
        got_o, got_c = priority_order(
            port_c, torch.tensor(elig), got_z, torch.tensor(np.asarray(label))
        )
        np.testing.assert_array_equal(got_o.numpy(), np.asarray(want_o))
        assert int(got_c) == int(want_c)


EDGE_KINDS = (
    "inf_zones", "full_range", "ties", "padding", "unranked_labels",
    "empty_zones",
)


def _edge_cluster(kind, rng, n, num_zones):
    """(fields, domain) at one edge of the exact zone sums or the packed
    keys. With more than one zone the last one never has a node."""
    fields = _cluster_np(rng, n, num_zones=max(num_zones - 1, 1))
    avail, zone = fields[0], fields[2]
    dom = rng.random(n) < 0.8
    if kind == "inf_zones":  # every node of a zone at +-INT32_INF
        avail[:, :2] = np.where((zone % 2 == 0)[:, None], INT32_INF, -INT32_INF)
    elif kind == "full_range":  # int32's ends included
        avail[:, :2] = rng.integers(-2**31, 2**31, size=(n, 2))
        avail[:4, :2] = [[-2**31, -2**31], [-1, -2**31], [2**31 - 1] * 2,
                         [-2**31, 2**31 - 1]]
    elif kind == "ties":  # (mem, cpu) ties broken by name rank
        avail[:, :2] = rng.integers(0, 2, size=(n, 2))
    elif kind == "padding":
        pad = rng.random(n) < 0.25
        fields[3] = np.where(pad, INT32_INF, fields[3]).astype(np.int32)
        fields[8] = ~pad
    elif kind == "unranked_labels":
        for f in (4, 5):
            fields[f] = np.where(
                rng.random(n) < 0.5, INT32_INF, rng.integers(0, 3, size=n)
            ).astype(np.int32)
    elif kind == "empty_zones":  # a populated zone with no domain node
        dom &= zone != 0
    return fields, dom


@pytest.mark.parametrize("num_zones", [1, 4, 64])
@pytest.mark.parametrize("kind", EDGE_KINDS)
def test_packed_orders_match_jax_at_the_key_edges(kind, num_zones):
    rng = np.random.default_rng(EDGE_KINDS.index(kind) * 101 + num_zones)
    n = 80
    fields, dom = _edge_cluster(kind, rng, n, num_zones)
    jax_c, port_c = _both(fields)
    d_elig = dom & (rng.random(n) < 0.7)
    e_elig = dom & ~fields[6] & fields[7]
    want_z = np.asarray(jax_zone_ranks(jax_c, jnp.asarray(dom), num_zones))
    got_z = zone_ranks(port_c, torch.tensor(dom), num_zones)
    np.testing.assert_array_equal(got_z.numpy(), want_z)
    want = []
    for elig, label in (
        (d_elig, jax_c.label_rank_driver), (e_elig, jax_c.label_rank_executor)
    ):
        want_o, want_c = jax_priority_order(
            jax_c, jnp.asarray(elig), jnp.asarray(want_z), label
        )
        got_o, got_c = priority_order(
            port_c, torch.tensor(elig), got_z, torch.tensor(np.asarray(label))
        )
        np.testing.assert_array_equal(got_o.numpy(), np.asarray(want_o))
        assert int(got_c) == int(want_c)
        want.append(np.asarray(want_o))
    got = priority_orders(
        port_c, torch.tensor(d_elig), torch.tensor(e_elig), got_z
    )
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)
    for i, (g, w) in enumerate(zip(
        queue_mode_orders(port_c, num_zones),
        jax_queue_mode_orders(jax_c, num_zones),
    )):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=str(i))


@pytest.mark.parametrize("decides", ["mem", "cpu"])
@pytest.mark.parametrize("num_zones", [1, 4, 64])
def test_zone_ranks_with_a_negative_zone_base_match_jax(num_zones, decides):
    rng = np.random.default_rng(num_zones + 7)
    n = 80
    fields, dom = _edge_cluster("full_range", rng, n, num_zones)
    # Per-zone offsets past int32, of either sign and of the local sums'
    # size. Where the cpu sums decide, every zone's mem sum is the same.
    sums = rng.integers(-2**34, 2**34, size=(2, num_zones))
    if decides == "cpu":
        fields[0][:, 1] = 0
        sums[0] = -2**33 - 5
    jax_c, port_c = _both(fields)
    limbs = []
    for s in sums:  # mem, then cpu, as (hi, lo) limbs
        limbs += [(s >> 24).astype(np.int32), (s & 0xFFFFFF).astype(np.int32)]
    present = rng.random(num_zones) < 0.5
    want = np.asarray(jax_zone_ranks(
        jax_c, jnp.asarray(dom), num_zones,
        zone_base=tuple(jnp.asarray(x) for x in (*limbs, present)),
    ))
    got = zone_ranks(
        port_c, torch.tensor(dom), num_zones,
        zone_base=tuple(torch.tensor(x) for x in (*limbs, present)),
    )
    np.testing.assert_array_equal(got.numpy(), want)


def test_more_zones_than_the_packed_key_holds_raise():
    rng = np.random.default_rng(3)
    _, port_c = _both(_cluster_np(rng, 8))
    elig = torch.ones(8, dtype=torch.bool)
    # A zero-stride view: the check reads the zone count, not the values.
    zrank = torch.zeros(1, dtype=torch.int32).expand(MAX_PACKED_ZONES + 1)
    with pytest.raises(ValueError, match="zones"):
        priority_order(port_c, elig, zrank, port_c.label_rank_driver)
    with pytest.raises(ValueError, match="zones"):
        priority_orders(port_c, elig, elig, zrank)


@pytest.mark.parametrize("fill", STRATEGIES)
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("hi", [24, 6])
def test_window_reference_matches_pallas(fill, seed, hi):
    rng = np.random.default_rng(seed * 7 + 3)
    n, emax = 24, 8
    jax_c, port_c = _both(_cluster_np(rng, n, hi=hi))
    requests, cands, doms = _random_requests(rng, n, 5, 4, emax)
    want = _pallas(jax_c, requests, cands, doms, fill, emax, 4)
    win = make_segmented_window(requests, cands, doms)
    got = window_pack_reference(
        port_c, win, fill=fill, emax=emax, num_zones=4
    )
    _assert_same(got, want, f"{fill} seed={seed} hi={hi}")
    # The wrapper on CPU tensors is the plain version, bit for bit.
    _assert_same(
        window_pack(port_c, win, fill=fill, emax=emax, num_zones=4),
        want, f"{fill} seed={seed} hi={hi} wrapper",
    )


def test_window_strict_fifo_blocking_is_segment_local():
    """A non-skippable failure blocks LATER rows of its own segment only;
    the next segment starts unblocked."""
    rng = np.random.default_rng(11)
    n, emax = 16, 8
    jax_c, port_c = _both(_cluster_np(rng, n))
    big = (np.full(3, 500, np.int32), np.ones(3, np.int32), 4, False)
    small = (np.ones(3, np.int32), np.ones(3, np.int32), 2, False)
    requests = [[big, small], [small]]
    ones = [np.ones(n, bool)] * 2
    want = _pallas(jax_c, requests, ones, ones, "tightly-pack", emax, 4)
    got = window_pack_reference(
        port_c, make_segmented_window(requests, ones, ones),
        fill="tightly-pack", emax=emax, num_zones=4,
    )
    _assert_same(got, want, "blocking")
    meta = got[0].numpy()
    assert meta[0, 0, 2] == 0  # big does not pack
    assert meta[0, 1, 1] == 0  # same-segment follower is FIFO-blocked
    assert meta[1, 0, 1] == 1  # next segment starts unblocked


def test_window_commit_rows_thread_the_base():
    """Only COMMIT rows persist into the base: two identical segments on a
    one-gang cluster -> the first admits, the second sees the committed
    usage and rejects."""
    n, emax = 8, 8
    avail = np.zeros((n, 3), np.int32)
    avail[0] = (4, 4, 0)
    fields = [
        avail, avail.copy(), np.zeros(n, np.int32),
        np.arange(n, dtype=np.int32), np.full(n, INT32_INF, np.int32),
        np.full(n, INT32_INF, np.int32), np.zeros(n, bool),
        np.ones(n, bool), np.ones(n, bool),
    ]
    jax_c, port_c = _both(fields)
    gang = (np.array([1, 1, 0], np.int32), np.array([1, 1, 0], np.int32), 3,
            False)
    requests = [[gang], [gang]]
    ones = [np.ones(n, bool)] * 2
    want = _pallas(jax_c, requests, ones, ones, "tightly-pack", emax, 2)
    got = window_pack_reference(
        port_c, make_segmented_window(requests, ones, ones),
        fill="tightly-pack", emax=emax, num_zones=2,
    )
    _assert_same(got, want, "commit")
    meta = got[0].numpy()
    assert meta[0, 0, 1] == 1  # first request admitted (1+3 = 4 CPU)
    assert meta[1, 0, 1] == 0  # second sees the committed base: full
    assert got[2].numpy()[0, 0] == 0


def test_window_empty_candidates_and_emax_edges():
    """A segment whose candidate mask excludes every node rejects without
    disturbing its neighbors; count == emax and count == 0 rows match."""
    rng = np.random.default_rng(31)
    n, emax = 16, 8
    jax_c, port_c = _both(_cluster_np(rng, n))
    one = np.ones(3, np.int32)
    requests = [
        [(one, one, emax, False)],  # full-width gang
        [(one, one, 0, False)],  # zero-executor gang
        [(one, one, 2, False)],  # starved: empty candidate mask
    ]
    cands = [np.ones(n, bool), np.ones(n, bool), np.zeros(n, bool)]
    doms = [np.ones(n, bool)] * 3
    want = _pallas(jax_c, requests, cands, doms, "tightly-pack", emax, 4)
    got = window_pack_reference(
        port_c, make_segmented_window(requests, cands, doms),
        fill="tightly-pack", emax=emax, num_zones=4,
    )
    _assert_same(got, want, "edges")
    assert got[0].numpy()[2, 0, 1] == 0  # starved segment rejected


@pytest.mark.parametrize("fill", STRATEGIES)
def test_window_padding_segments_and_oversized_gangs(fill):
    """Padding segments (row_count 0) and gangs larger than emax
    (too_big -> never packed) match the JAX kernel exactly."""
    rng = np.random.default_rng(41)
    n, emax = 32, 8
    jax_c, port_c = _both(_cluster_np(rng, n))
    requests, cands, doms = _random_requests(rng, n, 3, 3, emax)
    requests[1][-1] = (requests[1][-1][0], requests[1][-1][1], emax + 3,
                       False)
    jax_win = jax_make_window(requests, cands, doms, pad_segments=5)
    meta, execs, base = window_pack_pallas(
        jax_c, jax_win, fill=fill, emax=emax, num_zones=4, interpret=True
    )
    got = window_pack_reference(
        port_c, make_segmented_window(requests, cands, doms, pad_segments=5),
        fill=fill, emax=emax, num_zones=4,
    )
    _assert_same(
        got, (np.asarray(meta), np.asarray(execs), np.asarray(base)), fill
    )
    assert got[0].numpy()[1, len(requests[1]) - 1, 2] == 0
