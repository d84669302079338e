"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and nvcc; without them they skip (a CUDA
kernel has no interpret mode). On a machine with a card:

    python -m pytest tests/test_torch_cuda.py -m cuda

Tolerance: none. The window and queue kernels' outputs are integers, and
their single-AZ zone scores are summed in float64 and rounded once, exactly
as the plain versions do, so every output must be identical.
"""

import numpy as np
import pytest
import torch

STRATEGIES = (
    "tightly-pack",
    "distribute-evenly",
    "minimal-fragmentation",
    "single-az-tightly-pack",
    "single-az-minimal-fragmentation",
    "az-aware-tightly-pack",
)

SINGLE_AZ = STRATEGIES[3:]

# Zone cases of the kernel comparisons: (num_zones, kind). Every strategy
# runs the 4-zone case, the single-AZ strategies (the zone-parallel
# instantiation) every case. "random": zone ids drawn in [0, num_zones),
# zone 1 left empty from 5 zones on, and (queue kernel) a few nodes with
# ids outside [0, num_zones). "uniform": every node alike, so zones tie on
# their scores and the zone first in driver priority order must win.
ZONE_CASES = [(4, "random")] + [(z, "random") for z in (1, 2, 6, 8, 9, 17)] + [
    (6, "uniform")]
STRATEGY_ZONES = [(f, *zc) for f in STRATEGIES for zc in ZONE_CASES
                  if f in SINGLE_AZ or zc == ZONE_CASES[0]]

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the port's kernels run on the card only")
    from spark_scheduler_tpu_torch.ops._build import nvcc_path

    try:
        nvcc_path()
    except RuntimeError:
        pytest.skip("no nvcc: the port's kernels build from source")
    return torch.device("cuda", 0)


def test_probe_kernel(cuda_device):
    from spark_scheduler_tpu_torch.ops.probe import probe, probe_add_one

    before = probe_add_one.launches
    probe(cuda_device)
    assert probe_add_one.launches == before + 1


def _zone_column(rng, n, zones, kind):
    """A test cluster's zone ids for a ZONE_CASES entry: "uniform" deals
    the nodes round the zones; "random" draws them, and from 5 zones on
    leaves zone 1 empty."""
    if kind == "uniform":
        return (np.arange(n) % zones).astype(np.int32)
    z = rng.integers(0, zones, size=n).astype(np.int32)
    if zones >= 5:
        z[z == 1] = 0
    return z


@pytest.mark.parametrize("fill,zones,kind", STRATEGY_ZONES)
@pytest.mark.parametrize("n", [24, 300, 8193, 10000])
@pytest.mark.parametrize("state", ["smem", "global"])
def test_window_kernel_matches_plain(cuda_device, fill, zones, kind, n, state):
    """The cluster kernel in both node-state layouts (global forced at every
    n through the launcher's `state` argument) against the plain version;
    the single-AZ strategies in the zone-parallel instantiation, at every
    zone case."""
    from spark_scheduler_tpu_torch.models.cluster import cluster_from_numpy
    from spark_scheduler_tpu_torch.models.resources import INT32_INF
    from spark_scheduler_tpu_torch.ops.window import (
        make_segmented_window,
        window_pack,
        window_pack_reference,
    )

    rng = np.random.default_rng(5)
    emax = 8
    avail = rng.integers(0, 24, size=(n, 3)).astype(np.int32)
    avail[:, 2] = rng.integers(0, 3, size=n)
    if kind == "uniform":
        avail[:] = avail[0]
    cluster = cluster_from_numpy(
        [avail, avail.copy(), _zone_column(rng, n, zones, kind),
         rng.permutation(n).astype(np.int32),
         np.full(n, INT32_INF, np.int32), np.full(n, INT32_INF, np.int32),
         rng.random(n) < 0.1, rng.random(n) > 0.05, np.ones(n, bool)],
        device=cuda_device,
    )
    requests = [
        [(rng.integers(0, 5, 3).astype(np.int32) * [1, 1, 0],
          rng.integers(1, 4, 3).astype(np.int32),
          int(rng.integers(0, emax + 1)), bool(rng.random() < 0.3))
         for _ in range(int(rng.integers(1, 6)))]
        for _ in range(6)
    ]
    masks = [rng.random(n) < 0.9 for _ in requests]
    win = make_segmented_window(requests, masks, [np.ones(n, bool)] * 6)
    before = window_pack.launches
    zone_parallel = window_pack.zone_parallel_launches
    got = window_pack(cluster, win, fill=fill, emax=emax, num_zones=zones,
                      state=state)
    torch.cuda.synchronize()
    assert window_pack.launches == before + len(requests)
    assert window_pack.zone_parallel_launches == zone_parallel + (
        len(requests) if fill in SINGLE_AZ else 0)
    want = window_pack_reference(cluster, win, fill=fill, emax=emax,
                                 num_zones=zones)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("fill", STRATEGIES)
def test_window_kernel_wide_gangs(cuda_device, fill):
    """Gangs of more than 1,024 executors: the slot writes stride past one
    block's threads."""
    from spark_scheduler_tpu_torch.models.cluster import cluster_from_numpy
    from spark_scheduler_tpu_torch.models.resources import INT32_INF
    from spark_scheduler_tpu_torch.ops.window import (
        make_segmented_window,
        window_pack,
        window_pack_reference,
    )

    rng = np.random.default_rng(8)
    n, emax = 300, 2048
    avail = rng.integers(0, 64, size=(n, 3)).astype(np.int32)
    avail[:, 2] = 0
    cluster = cluster_from_numpy(
        [avail, avail.copy(), rng.integers(0, 4, size=n).astype(np.int32),
         rng.permutation(n).astype(np.int32),
         np.full(n, INT32_INF, np.int32), np.full(n, INT32_INF, np.int32),
         np.zeros(n, bool), np.ones(n, bool), np.ones(n, bool)],
        device=cuda_device,
    )
    one = np.array([1, 1, 0], np.int32)
    requests = [[(one, one, 1500, True), (one, one, 1100, False)],
                [(one, one, 2048, False)]]
    masks = [np.ones(n, bool)] * 2
    win = make_segmented_window(requests, masks, masks)
    got = window_pack(cluster, win, fill=fill, emax=emax, num_zones=4)
    torch.cuda.synchronize()
    want = window_pack_reference(cluster, win, fill=fill, emax=emax,
                                 num_zones=4)
    assert int(want[0][0, 0, 1]) == 1  # the first gang was admitted
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _queue_case(rng, n, b, device, hi=40, zones=4, kind="random"):
    """A random cluster (tests/test_packing_golden.py's generator) and a
    queue of b apps padded to b + 3 (tests/test_pallas_fifo.py's), with
    gangs up to emax + 2 wide and some non-skippable; zone ids by
    `_zone_column` ("uniform": every node alike too)."""
    from spark_scheduler_tpu_torch.models.cluster import cluster_from_numpy
    from spark_scheduler_tpu_torch.models.resources import INT32_INF
    from spark_scheduler_tpu_torch.ops.batched import (
        app_batch_to_device,
        make_app_batch,
    )

    avail = rng.integers(0, hi, size=(n, 3)).astype(np.int32)
    avail[:, 2] = rng.integers(0, 3, size=n) * rng.integers(0, 2, size=n)
    sched = avail + rng.integers(0, 8, size=(n, 3)).astype(np.int32)
    if kind == "uniform":
        avail[:] = (hi - 1, hi - 1, 4)
        sched[:] = (hi + 3, hi + 3, 4)
    cluster = cluster_from_numpy(
        [avail, sched, _zone_column(rng, n, zones, kind),
         rng.permutation(n).astype(np.int32),
         np.full(n, INT32_INF, np.int32), np.full(n, INT32_INF, np.int32),
         rng.random(n) < 0.1, rng.random(n) > 0.1, rng.random(n) > 0.05],
        device=device,
    )
    driver = rng.integers(1, 6, size=(b, 3)).astype(np.int32)
    driver[:, 2] = rng.integers(0, 2, size=b)
    execs = rng.integers(1, 8, size=(b, 3)).astype(np.int32)
    execs[:, 2] = rng.integers(0, 2, size=b)
    apps = make_app_batch(
        driver, execs, rng.integers(0, 8 + 3, size=b).astype(np.int32),
        pad_to=b + 3, skippable=rng.random(b) < 0.3,
    )
    return cluster, app_batch_to_device(apps, device)


# The queue kernel's four layouts: (team, node-state place).
QUEUE_LAYOUTS = [("block", "smem"), ("block", "global"),
                 ("cluster", "smem"), ("cluster", "global")]


def _forced_layout(n, team, state, fill):
    """The queue layout forced to (team, state) for `fill`, or a skip where
    the node state does not fit in shared memory at n."""
    from spark_scheduler_tpu_torch.ops.launch import kernel_layout

    try:
        return kernel_layout(n, fill, team=team, state=state)
    except ValueError:
        pytest.skip(f"no {team}/{state} layout at n={n}: the state does not fit")


def _one_queue_operands(cluster, apps, num_zones):
    """`fifo_queue`'s operands for one queue: a stacked group of one."""
    from spark_scheduler_tpu_torch.ops.fifo import device_apps, queue_operands
    from spark_scheduler_tpu_torch.parallel import stack_groups

    sc, sa = stack_groups([cluster], [apps])
    return queue_operands(sc, device_apps(sa, cluster.device, lead=(1,)),
                          num_zones)


def _forced_queue(cluster, apps, team, state, **kw):
    """`fifo_pack`'s launch with the kernel's team and node-state place
    forced."""
    from spark_scheduler_tpu_torch.ops.batched import BatchedPacking
    from spark_scheduler_tpu_torch.ops.fifo import (
        fifo_pack,
        fifo_queue,
        queue_packing,
    )

    before = fifo_pack.launches
    zone_parallel = fifo_pack.zone_parallel_launches
    out = queue_packing(*fifo_queue(
        *_one_queue_operands(cluster, apps, kw["num_zones"]),
        team=team, state=state, **kw,
    ))
    torch.cuda.synchronize()
    assert fifo_pack.launches == before + 1
    assert fifo_pack.zone_parallel_launches == zone_parallel + (kw["fill"] in SINGLE_AZ)
    return BatchedPacking(*(x[0] for x in out))


@pytest.mark.parametrize("fill", STRATEGIES)
@pytest.mark.parametrize("n", [9, 37, 300, 1000, 8193, 10000])
@pytest.mark.parametrize("team,state", QUEUE_LAYOUTS)
def test_queue_kernel_matches_plain(cuda_device, fill, n, team, state):
    """Every forced layout against the plain version, on a roomy and a
    tight cluster (n = 9 leaves cluster blocks 5-7 without nodes)."""
    from spark_scheduler_tpu_torch.ops.fifo import fifo_pack_reference

    layout = _forced_layout(n, team, state, fill)
    for seed, hi in enumerate((40, 8)):
        cluster, apps = _queue_case(np.random.default_rng(seed), n, 9, cuda_device, hi)
        got = _forced_queue(cluster, apps, team, state, fill=fill, emax=8,
                            num_zones=4)
        want = fifo_pack_reference(cluster, apps, fill=fill, emax=8, num_zones=4)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (fill, n, hi, layout)


@pytest.mark.parametrize("fill", STRATEGIES)
def test_queue_kernel_default_layout(cuda_device, fill):
    """`fifo_pack` itself, in the layout `kernel_layout` picks, on either
    side of the block/cluster crossover."""
    from spark_scheduler_tpu_torch.ops.fifo import fifo_pack, fifo_pack_reference
    from spark_scheduler_tpu_torch.ops.launch import QUEUE_CLUSTER_MIN_NODES

    for seed, n in enumerate((QUEUE_CLUSTER_MIN_NODES - 1, QUEUE_CLUSTER_MIN_NODES)):
        cluster, apps = _queue_case(np.random.default_rng(seed), n, 9, cuda_device)
        before = fifo_pack.launches
        got = fifo_pack(cluster, apps, fill=fill, emax=8, num_zones=4)
        torch.cuda.synchronize()
        assert fifo_pack.launches == before + 1
        want = fifo_pack_reference(cluster, apps, fill=fill, emax=8, num_zones=4)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (fill, n)


def _plain_queue(cluster, apps, *, fill, emax, num_zones, zone=None):
    """`fifo_pack_reference`'s walk as the queue kernel's raw outputs (meta
    [B,4] with the score bits, execs, availability after), on the CPU;
    `zone` overrides the zone ids the gang solve reads (the orders are the
    cluster's)."""
    import dataclasses

    from spark_scheduler_tpu_torch.ops.fifo import kernel_orders
    from spark_scheduler_tpu_torch.ops.gang import walk_rows

    orders = kernel_orders(cluster, num_zones)
    if zone is not None:
        cluster = dataclasses.replace(cluster, zone_id=zone)
    avail = cluster.available.clone()
    meta, execs = walk_rows(
        fill, num_zones=num_zones, emax=emax, cluster=cluster, avail=avail,
        orders=orders, driver_req=apps.driver_req.numpy(),
        exec_req=apps.exec_req.numpy(), exec_count=apps.exec_count.numpy(),
        valid=apps.app_valid.numpy(), skippable=apps.skippable.numpy(),
        with_score=True,
    )
    return torch.tensor(meta), torch.tensor(execs), avail


@pytest.mark.parametrize("fill,zones,kind", STRATEGY_ZONES)
@pytest.mark.parametrize("n", [9, 300, 5000])
@pytest.mark.parametrize("team,state", QUEUE_LAYOUTS)
def test_queue_kernel_scores_match_the_plain_walk(cuda_device, fill, zones,
                                                   kind, n, team, state):
    """The queue kernel's outputs, its zone scores' bits included (0
    outside the zone strategies), in every forced layout, equal the plain
    walk's, on a roomy and a tight cluster; the single-AZ strategies in the
    zone-parallel instantiation, at every zone case, with a few nodes of
    the "random" cases (beside 4 zones) given ids outside [0, zones), which
    belong to no zone."""
    from spark_scheduler_tpu_torch.ops.fifo import (
        fifo_pack,
        fifo_queue,
        zone_scores,
    )

    layout = _forced_layout(n, team, state, fill)
    fallbacks = 0
    for seed, hi in enumerate((40, 8)):
        got_cl, got_apps = _queue_case(np.random.default_rng(seed), n, 9,
                                       cuda_device, hi, zones, kind)
        want_cl, want_apps = _queue_case(np.random.default_rng(seed), n, 9,
                                         torch.device("cpu"), hi, zones, kind)
        zone = None
        ops = _one_queue_operands(got_cl, got_apps, zones)
        if kind == "random" and zones != 4:  # ids -1 and `zones` on ~5% of nodes
            stray = torch.from_numpy(np.random.default_rng(seed).random(n) < 0.05)
            zone = want_cl.zone_id.clone()
            zone[stray] = torch.where(torch.arange(n)[stray] % 2 == 0, -1,
                                      zones).to(torch.int32)
            ops = (*ops[:2], zone.to(cuda_device)[None].contiguous(), *ops[3:])
        zone_parallel = fifo_pack.zone_parallel_launches
        meta, execs, after = fifo_queue(*ops, fill=fill, emax=8,
                                        num_zones=zones, team=team, state=state)
        assert fifo_pack.zone_parallel_launches == zone_parallel + (fill in SINGLE_AZ)
        want = _plain_queue(want_cl, want_apps, fill=fill, emax=8,
                            num_zones=zones, zone=zone)
        for g, w in zip((meta[0], execs[0], after[0]), want):
            assert torch.equal(g.cpu(), w), (fill, zones, kind, n, hi, layout)
        scores = zone_scores(want[0])
        packed = want[0][:, 2] != 0
        if fill in SINGLE_AZ and packed.any():
            fallbacks += int((scores[packed] == 0).sum())
            assert fill == "az-aware-tightly-pack" or (scores[packed] > 0).all()
    if fill == "az-aware-tightly-pack" and zones == 17 and n == 300:
        assert fallbacks > 0  # no zone fits some gang: the plain fallback packed it


@pytest.mark.parametrize("fill", STRATEGIES)
@pytest.mark.parametrize("team", ["block", "cluster"])
def test_queue_kernel_wide_gangs(cuda_device, fill, team):
    """Queue-mode gangs of more than 1,024 executors (emax 2,048): the slot
    writes stride past one block's threads."""
    from spark_scheduler_tpu_torch.models.cluster import cluster_from_numpy
    from spark_scheduler_tpu_torch.models.resources import INT32_INF
    from spark_scheduler_tpu_torch.ops.batched import (
        app_batch_to_device,
        make_app_batch,
    )
    from spark_scheduler_tpu_torch.ops.fifo import fifo_pack_reference

    rng = np.random.default_rng(8)
    n, emax = 300, 2048
    avail = rng.integers(0, 64, size=(n, 3)).astype(np.int32)
    avail[:, 2] = 0
    cluster = cluster_from_numpy(
        [avail, avail.copy(), rng.integers(0, 4, size=n).astype(np.int32),
         rng.permutation(n).astype(np.int32),
         np.full(n, INT32_INF, np.int32), np.full(n, INT32_INF, np.int32),
         np.zeros(n, bool), np.ones(n, bool), np.ones(n, bool)],
        device=cuda_device,
    )
    one = np.ones((3, 3), np.int32)
    one[:, 2] = 0
    apps = app_batch_to_device(make_app_batch(
        one, one, [1500, 1100, 2048], skippable=np.array([True, False, False]),
    ), cuda_device)
    got = _forced_queue(cluster, apps, team, None, fill=fill, emax=emax,
                        num_zones=4)
    want = fifo_pack_reference(cluster, apps, fill=fill, emax=emax, num_zones=4)
    assert bool(want.admitted[0])  # the first gang was admitted
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("groups", [5, 20])
@pytest.mark.parametrize("team", ["block", "cluster"])
def test_grouped_queue_kernel_is_one_launch(cuda_device, groups, team):
    """G queues as G teams of one launch; G = 20 clusters is more than can
    be resident at once, so some wait for others to finish."""
    from spark_scheduler_tpu_torch.ops.fifo import (
        device_apps,
        fifo_pack,
        fifo_queue,
        queue_operands,
        queue_packing,
    )
    from spark_scheduler_tpu_torch.parallel import (
        grouped_fifo_pack,
        grouped_fifo_pack_reference,
        stack_groups,
    )

    rng = np.random.default_rng(9)
    cases = [_queue_case(rng, 200, 20, cuda_device) for _ in range(groups)]
    clusters, apps = stack_groups([c for c, _ in cases], [a for _, a in cases])
    kw = dict(fill="tightly-pack", emax=8, num_zones=4)
    want = grouped_fifo_pack_reference(clusters, apps, **kw)
    before = fifo_pack.launches
    got = queue_packing(*fifo_queue(
        *queue_operands(
            clusters, device_apps(apps, cuda_device, lead=(groups,)), 4),
        team=team, **kw,
    ))
    default = grouped_fifo_pack(clusters, apps, **kw)
    torch.cuda.synchronize()
    assert fifo_pack.launches == before + 2
    for g, d, w in zip(got, default, want):
        assert torch.equal(g, w)
        assert torch.equal(d, w)


def test_kernels_launch_on_the_tensors_device(cuda_device):
    """Each kernel library keeps its own current device (it links the
    static CUDA runtime); every entry point must set the device of the
    tensors it is handed. With cuda:0 current, the probe, a window and a
    queue on cuda:1 must give the plain versions' results."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from spark_scheduler_tpu_torch.models.cluster import cluster_from_numpy
    from spark_scheduler_tpu_torch.models.resources import INT32_INF
    from spark_scheduler_tpu_torch.ops.fifo import (
        fifo_kernel_info,
        fifo_pack,
        fifo_pack_reference,
    )
    from spark_scheduler_tpu_torch.ops.probe import probe_add_one
    from spark_scheduler_tpu_torch.ops.window import (
        make_segmented_window,
        window_kernel_info,
        window_pack,
        window_pack_reference,
    )

    torch.cuda.set_device(0)
    dev1 = torch.device("cuda", 1)
    x = torch.arange(1024, dtype=torch.int32, device=dev1)
    assert torch.equal(probe_add_one(x).cpu(), x.cpu() + 1)

    rng = np.random.default_rng(13)
    n, emax = 3000, 8
    avail = rng.integers(0, 24, size=(n, 3)).astype(np.int32)
    fields = [avail, avail.copy(), rng.integers(0, 4, size=n).astype(np.int32),
              rng.permutation(n).astype(np.int32),
              np.full(n, INT32_INF, np.int32), np.full(n, INT32_INF, np.int32),
              np.zeros(n, bool), np.ones(n, bool), np.ones(n, bool)]
    on1 = cluster_from_numpy(fields, device=dev1)
    on_cpu = cluster_from_numpy(fields, device="cpu")
    one = np.array([1, 1, 0], np.int32)
    win = make_segmented_window(
        [[(one, one, 5, False)], [(one, one, 7, True), (one, one, 3, False)]],
        [np.ones(n, bool)] * 2, [np.ones(n, bool)] * 2,
    )
    kw = dict(fill="tightly-pack", emax=emax, num_zones=4)
    got = window_pack(on1, win, **kw)
    torch.cuda.synchronize(dev1)
    want = window_pack_reference(on_cpu, win, **kw)
    for g, w in zip(got, want):
        assert g.device == dev1
        assert torch.equal(g.cpu(), w)
    assert window_kernel_info(n, kw["fill"], device=dev1)["max_active_teams"] > 0

    _, apps1 = _queue_case(np.random.default_rng(3), n, 12, dev1)
    cluster_cpu, apps_cpu = _queue_case(np.random.default_rng(3), n, 12, "cpu")
    cluster1 = cluster_from_numpy(
        [f.numpy() for f in cluster_cpu.fields()], device=dev1
    )
    got = fifo_pack(cluster1, apps1, **kw)
    torch.cuda.synchronize(dev1)
    want = fifo_pack_reference(cluster_cpu, apps_cpu, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert fifo_kernel_info(n, kw["fill"], device=dev1)["max_active_teams"] > 0
    assert torch.cuda.current_device() == 0


def test_extender_on_cuda_matches_cpu(cuda_device):
    """The port's extender on the card against the port's extender on the
    CPU at 300 nodes: two pipelined driver windows (the second dispatched
    before the first completes), the admitted apps' executors, and an
    executor reschedule through the solo `pack`. Results, reservations and
    demands must be equal after every request, and every driver window and
    the solo pack must have launched the row walk."""
    from spark_scheduler_tpu_torch.ops.window import window_pack
    # By the module's own name (pytest puts tests/ on the path): the card's
    # machine runs this file with --noconftest, where `tests` may name
    # another package.
    from test_torch_extender import PORT, Side

    def scenario(h):
        names = [f"node-{i:03d}" for i in range(300)]
        h.add_nodes(*(h.node(n, zone=f"zone{i % 4}") for i, n in enumerate(names)))
        apps = [h.spark_pods(f"app-{i}", 2 + i % 7) for i in range(24)]
        for pods in apps:
            h.add_pods(pods[0])
        groups = [apps[0::2], apps[1::2]]
        tickets = [h.dispatch([h.args(p[0], names) for p in g]) for g in groups]
        for g, t in zip(groups, tickets):
            for pods, res in zip(g, h.complete(t)):
                assert res.ok
                h.bind(pods[0], res)
        for pods in apps[:4]:
            for p in pods[1:]:
                h.schedule(p, names)
        # An executor offered only nodes outside its reservations:
        # rescheduled through the solo pack.
        late = apps[5][1]
        reserved = {
            r.node for r in h.rr_cache.get("namespace", "app-5").spec.reservations.values()
        }
        res = h.schedule(late, [n for n in names if n not in reserved])
        assert res.outcome == "success-rescheduled"

    before = window_pack.launches
    gpu = Side(PORT, binpack="tightly-pack", device="cuda")
    scenario(gpu)
    launches = window_pack.launches - before
    cpu = Side(PORT, binpack="tightly-pack", device="cpu")
    scenario(cpu)
    assert gpu.log == cpu.log
    # 24 one-row segments in two windows, and one solo pack.
    assert launches == 25, launches
    assert gpu.solver.window_path_counts == {"cuda": 2}
    assert gpu.solver.last_solve_info["path"] == "cuda"


def _port_server(device):
    """The port's app on `device` behind its HTTP server on port 0."""
    from spark_scheduler_tpu_torch.metrics import MetricRegistry, SchedulerMetrics
    from spark_scheduler_tpu_torch.server.app import build_scheduler_app
    from spark_scheduler_tpu_torch.server.config import InstallConfig
    from spark_scheduler_tpu_torch.server.http import SchedulerHTTPServer
    from spark_scheduler_tpu_torch.store.backend import DEMAND_CRD, InMemoryBackend

    backend = InMemoryBackend()
    backend.register_crd(DEMAND_CRD)
    registry = MetricRegistry()
    app = build_scheduler_app(
        backend,
        InstallConfig(fifo=True, binpack_algo="tightly-pack",
                      instance_group_label="resource_channel", sync_writes=True),
        metrics=SchedulerMetrics(registry, "resource_channel"),
        clock=lambda: 2.0e9,
        device=device,
    )
    server = SchedulerHTTPServer(app, registry, port=0)
    server.start()
    return server


def _call(server, method, path, payload=None):
    import http.client
    import json

    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=120)
    body = json.dumps(payload).encode() if payload is not None else None
    conn.request(method, path, body=body, headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = (resp.status, resp.read())
    conn.close()
    return out


def test_server_on_cuda_matches_cpu(cuda_device):
    """The port's HTTP server with its app on the card against the same
    server with its app on the CPU, at 300 nodes, fed the same requests one
    at a time (each its own window): node and pod PUTs, 24 driver
    predicates, the admitted drivers' binds and their executors. Every
    response must be byte-identical, and every driver window must have run
    the row-walk kernel."""
    import json

    from spark_scheduler_tpu_torch.ops.window import window_pack

    rng = np.random.default_rng(5)
    nodes = [
        {
            "metadata": {
                "name": f"node-{i:03d}",
                "labels": {
                    "failure-domain.beta.kubernetes.io/zone": f"zone{i % 4}",
                    "resource_channel": "batch",
                },
            },
            "status": {"allocatable": {
                "cpu": str(int(rng.choice([8, 16, 32]))),
                "memory": f"{int(rng.choice([16, 32, 64]))}Gi",
                "nvidia.com/gpu": "0",
            }},
        }
        for i in range(300)
    ]
    names = [n["metadata"]["name"] for n in nodes]

    def pod(app, role, name, executors):
        return {
            "metadata": {
                "name": name, "namespace": "ns", "uid": f"uid-{name}",
                "labels": {"spark-role": role, "spark-app-id": app},
                "annotations": {
                    "spark-driver-cpu": "1", "spark-driver-mem": "2Gi",
                    "spark-executor-cpu": "2", "spark-executor-mem": "4Gi",
                    "spark-executor-count": str(executors),
                },
                "creationTimestamp": 1.9999e9 + len(app),
            },
            "spec": {"schedulerName": "spark-scheduler",
                     "nodeSelector": {"resource_channel": "batch"},
                     "containers": [{"name": "main"}]},
            "status": {"phase": "Pending"},
        }

    servers = [_port_server("cuda"), _port_server("cpu")]
    try:
        def both(method, path, payload=None):
            got, want = (_call(s, method, path, payload) for s in servers)
            assert got == want, (method, path, got[1][:300], want[1][:300])
            return got

        for n in nodes:
            both("PUT", "/state/nodes", n)
        before = window_pack.launches
        apps = [(f"app-{i:02d}", 32 if i % 7 == 0 else 2 + i % 6) for i in range(24)]
        for app, n in apps:
            drv = pod(app, "driver", f"{app}-driver", n)
            both("PUT", "/state/pods", drv)
            status, body = both("POST", "/predicates", {"Pod": drv, "NodeNames": names})
            res = json.loads(body)
            if not res["NodeNames"]:
                continue
            drv["spec"]["nodeName"] = res["NodeNames"][0]
            both("PUT", "/state/pods", drv)
            for k in range(n):
                ex = pod(app, "executor", f"{app}-exec-{k + 1}", n)
                both("PUT", "/state/pods", ex)
                both("POST", "/predicates", {"Pod": ex, "NodeNames": names})
        solver = servers[0].app.solver
        assert window_pack.launches - before >= len(apps)
        assert set(solver.window_path_counts) <= {"cuda"}
        assert both("GET", "/status/readiness")[0] == 200
    finally:
        for s in servers:
            s.stop()


def test_cli_serves_async_native_on_the_card(cuda_device):
    """`python -m spark_scheduler_tpu_torch server --transport async
    --ingest native` builds the native runtime and serves a binary
    predicate body from the card."""
    import json
    import socket
    import subprocess
    import sys
    import time
    import urllib.request
    from pathlib import Path

    from spark_scheduler_tpu_torch.server.ingest import (
        BINARY_CONTENT_TYPE,
        encode_predicate_binary,
    )

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = Path(__file__).resolve().parent.parent
    proc = subprocess.Popen(
        [sys.executable, "-m", "spark_scheduler_tpu_torch", "server",
         "--host", "127.0.0.1", "--port", str(port),
         "--transport", "async", "--ingest", "native"],
        cwd=repo, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
    )
    base = f"http://127.0.0.1:{port}"

    def call(method, path, body=None, ctype="application/json"):
        req = urllib.request.Request(base + path, data=body, method=method,
                                     headers={"Content-Type": ctype})
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.read()

    try:
        deadline = time.monotonic() + 180
        while True:
            try:
                assert call("GET", "/status/liveness")[0] == 200
                break
            except OSError:
                assert proc.poll() is None, proc.stderr.read()[-2000:]
                assert time.monotonic() < deadline, "server never came up"
                time.sleep(0.5)
        node = {
            "metadata": {"name": "n0", "labels": {"resource_channel": "batch"}},
            "status": {"allocatable": {"cpu": "16", "memory": "32Gi"},
                       "conditions": [{"type": "Ready", "status": "True"}]},
        }
        assert call("PUT", "/state/nodes", json.dumps(node).encode())[0] == 200
        pod = {
            "metadata": {
                "name": "d0", "namespace": "ns", "uid": "uid-d0",
                "labels": {"spark-role": "driver", "spark-app-id": "a0"},
                "annotations": {
                    "spark-driver-cpu": "1", "spark-driver-mem": "1Gi",
                    "spark-executor-cpu": "1", "spark-executor-mem": "1Gi",
                    "spark-executor-count": "2",
                },
                "creationTimestamp": "2026-07-29T12:00:00Z",
            },
            "spec": {"schedulerName": "spark-scheduler",
                     "containers": [{"name": "main", "resources": {
                         "requests": {"cpu": "1", "memory": "1Gi"}}}]},
            "status": {"phase": "Pending"},
        }
        assert call("PUT", "/state/pods", json.dumps(pod).encode())[0] == 200
        status, body = call("POST", "/predicates",
                            encode_predicate_binary(pod, ["n0"]), BINARY_CONTENT_TYPE)
        assert status == 200 and json.loads(body)["NodeNames"] == ["n0"], body
        metrics = json.loads(call("GET", "/metrics")[1])
        assert metrics["server_transport"]["transport"] == "async"
        assert metrics["server_ingest"]["decode_hits"] == 1
        dispatches = metrics["foundry.spark.scheduler.solver.window.dispatches"]
        assert [e["tags"]["path"] for e in dispatches] == ["pallas"]
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_cli_serves_from_apiserver_with_a_wal_and_restarts(cuda_device, tmp_path):
    """`python -m spark_scheduler_tpu_torch server --kube-api-url ...
    --durable-store ...` on the card: it does not answer ready before its
    reflectors have listed, answers a driver and its first executor from
    the watch stream, and after a SIGKILL and a restart on the same WAL the
    second executor lands on a node its app reserved."""
    import json
    import signal
    import socket
    import subprocess
    import sys
    import time
    import urllib.error
    import urllib.request
    from pathlib import Path

    from spark_scheduler_tpu_torch.kube.apiserver import FakeKubeAPIServer
    from spark_scheduler_tpu_torch.store.durable import DurableBackend

    repo = Path(__file__).resolve().parent.parent
    wal = str(tmp_path / "state.jsonl")
    api = FakeKubeAPIServer()  # listening, not serving yet
    for i in range(4):
        api.create("nodes", {
            "metadata": {"name": f"n{i}", "labels": {"instance-group": "batch"},
                         "creationTimestamp": 1.0},
            "status": {"allocatable": {"cpu": "16", "memory": "32Gi"},
                       "conditions": [{"type": "Ready", "status": "True"}]},
        })

    def pod(name, role):
        return {
            "metadata": {
                "name": name, "namespace": "ns", "uid": f"uid-{name}",
                "labels": {"spark-role": role, "spark-app-id": "a0"},
                "annotations": {
                    "spark-driver-cpu": "1", "spark-driver-mem": "1Gi",
                    "spark-executor-cpu": "4", "spark-executor-mem": "8Gi",
                    "spark-executor-count": "2",
                },
                "creationTimestamp": "2026-07-29T12:00:00Z",
            },
            "spec": {"schedulerName": "spark-scheduler",
                     "nodeSelector": {"instance-group": "batch"},
                     "containers": [{"name": "main", "resources": {"requests": (
                         {"cpu": "1", "memory": "1Gi"} if role == "driver"
                         else {"cpu": "4", "memory": "8Gi"})}}]},
            "status": {"phase": "Pending"},
        }

    def bound(raw, node):
        out = json.loads(json.dumps(raw))
        out["spec"]["nodeName"] = node
        out["status"]["phase"] = "Running"
        return out

    log = tmp_path / "server.log"

    def start_cli():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        with open(log, "ab") as err:
            proc = subprocess.Popen(
                [sys.executable, "-m", "spark_scheduler_tpu_torch", "server",
                 "--host", "127.0.0.1", "--port", str(port),
                 "--kube-api-url", api.base_url, "--durable-store", wal],
                cwd=repo, stdout=subprocess.DEVNULL, stderr=err,
            )
        return proc, f"http://127.0.0.1:{port}"

    def call(base, method, path, payload=None, timeout=120):
        body = json.dumps(payload).encode() if payload is not None else None
        req = urllib.request.Request(base + path, data=body, method=method,
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as err:
            return err.code, err.read()

    def wait_ready(proc, base):
        deadline = time.monotonic() + 300
        while True:
            try:
                if call(base, "GET", "/status/readiness", timeout=2)[0] == 200:
                    return
            except OSError:
                pass
            assert proc.poll() is None, log.read_text()[-2000:]
            assert time.monotonic() < deadline, "server never became ready"
            time.sleep(0.2)

    names = [f"n{i}" for i in range(4)]
    serving = False
    proc, base = start_cli()
    try:
        # The apiserver does not answer yet: the server is never ready.
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            try:
                assert call(base, "GET", "/status/readiness", timeout=1)[0] != 200
            except OSError:
                pass
            time.sleep(0.2)
        api.start()
        serving = True
        wait_ready(proc, base)
        driver = pod("a0-driver", "driver")
        api.create("pods", json.loads(json.dumps(driver)))
        time.sleep(1.0)  # the watch brings the pod in
        status, body = call(base, "POST", "/predicates",
                            {"Pod": driver, "NodeNames": names})
        res = json.loads(body)
        assert status == 200 and res["NodeNames"], body
        api.update("pods", bound(driver, res["NodeNames"][0]))
        ex1 = pod("a0-exec-1", "executor")
        api.create("pods", json.loads(json.dumps(ex1)))
        time.sleep(1.0)
        status, body = call(base, "POST", "/predicates",
                            {"Pod": ex1, "NodeNames": names})
        res1 = json.loads(body)
        assert status == 200 and res1["NodeNames"], body
        api.update("pods", bound(ex1, res1["NodeNames"][0]))
        dispatches = json.loads(call(base, "GET", "/metrics")[1])[
            "foundry.spark.scheduler.solver.window.dispatches"]
        assert [e["tags"]["path"] for e in dispatches] == ["pallas"]
        time.sleep(1.0)
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)

        copy = DurableBackend(wal, compact_on_load=False, follow=True)
        (rr,) = copy.list("resourcereservations")
        reserved = {r.node for k, r in rr.spec.reservations.items() if k != "driver"}
        assert res1["NodeNames"][0] in reserved

        proc, base = start_cli()
        wait_ready(proc, base)
        ex2 = pod("a0-exec-2", "executor")
        api.create("pods", json.loads(json.dumps(ex2)))
        time.sleep(1.0)
        status, body = call(base, "POST", "/predicates",
                            {"Pod": ex2, "NodeNames": names})
        res2 = json.loads(body)
        assert status == 200 and res2["NodeNames"], body
        assert res2["NodeNames"][0] in reserved
    finally:
        if proc.poll() is None:
            proc.terminate()
            proc.wait(timeout=30)
        if serving:
            api.stop()
        else:
            api._server.server_close()


# ------------------------------------------ fused dispatch, batched engine


@pytest.mark.parametrize("k", [2, 4])
def test_fused_dispatch_on_cuda_matches_sequential(cuda_device, k):
    """`pack_windows_dispatch` of K windows on a `cuda` solver equals K
    back-to-back dispatches, and launches the row walk once a segment."""
    from spark_scheduler_tpu_torch.core.solver import PlacementSolver, WindowRequest
    from spark_scheduler_tpu_torch.models.kube import ZONE_LABEL, Node
    from spark_scheduler_tpu_torch.models.resources import Resources
    from spark_scheduler_tpu_torch.ops.window import window_pack

    rng = np.random.default_rng(100 + k)
    nodes = [
        Node(name=f"n{i:03d}", allocatable=Resources.from_quantities("8", "8Gi", "1"),
             labels={ZONE_LABEL: f"z{i % 2}"})
        for i in range(300)
    ]
    names = [n.name for n in nodes]
    one, two = Resources.from_quantities("1", "1Gi"), Resources.from_quantities("2", "2Gi")

    def request():
        rows = [(one, one, int(rng.integers(1, 3)), bool(rng.random() < 0.5))
                for _ in range(int(rng.integers(0, 3)))]
        rows.append((two if rng.random() < 0.3 else one, one,
                     int(rng.integers(1, 4)), False))
        return WindowRequest(rows=rows, driver_candidate_names=names)

    windows = [[request() for _ in range(3)] for _ in range(k)]
    usage = {n.name: Resources.from_quantities(str(int(rng.integers(1, 4))), "1Gi")
             for n in nodes if rng.random() < 0.3}
    seq, fused = (PlacementSolver(device=cuda_device) for _ in range(2))
    handles = [
        seq.pack_window_dispatch(
            "tightly-pack", seq.build_tensors_pipelined(nodes, usage, {}), w)
        for w in windows
    ]
    want = [d for h in handles for d in seq.pack_window_fetch(h)]
    t = fused.build_tensors_pipelined(nodes, usage, {})
    before = window_pack.launches
    views = fused.pack_windows_dispatch("tightly-pack", t, windows)
    got = [d for v in views for d in fused.pack_window_fetch(v)]
    assert window_pack.launches - before == k * 3
    assert got == want
    assert any(d.admitted for d in got)


@pytest.mark.parametrize("top_k,slack", [(4, 0.5), (1, 0.01)])
def test_pruned_window_on_cuda_matches_cpu(cuda_device, top_k, slack):
    """The pruned two-tier solve on the card against its `cpu` twin and an
    unpruned `cuda` solver: pipelined pairs of windows with usage churn
    between them. Decisions and prune_stats equal the cpu twin's; the row
    walk launches once a live segment of every dispatch, pruned or
    declined, and again for each segment a full re-solve walks; the tight
    K escalates."""
    from spark_scheduler_tpu_torch.core.solver import PlacementSolver, WindowRequest
    from spark_scheduler_tpu_torch.models.kube import ZONE_LABEL, Node
    from spark_scheduler_tpu_torch.models.resources import Resources
    from spark_scheduler_tpu_torch.ops.window import window_pack

    rng = np.random.default_rng(7)
    nodes = [
        Node(name=f"n{i:03d}", allocatable=Resources.from_quantities("8", "8Gi", "1"),
             labels={ZONE_LABEL: f"z{i % 3}"})
        for i in range(300)
    ]
    names = [n.name for n in nodes]
    one, two = Resources.from_quantities("1", "1Gi"), Resources.from_quantities("2", "2Gi")

    def request():
        rows = [(one, one, int(rng.integers(1, 3)), bool(rng.random() < 0.5))
                for _ in range(int(rng.integers(0, 3)))]
        rows.append((two if rng.random() < 0.3 else one, one,
                     int(rng.integers(1, 4)), False))
        return WindowRequest(rows=rows, driver_candidate_names=names)

    batches = [[[request() for _ in range(3)] for _ in range(2)] for _ in range(3)]
    usages = [{}] + [
        {n.name: Resources.from_quantities(str(int(rng.integers(1, 4))), "1Gi")
         for n in nodes if rng.random() < 0.3}
        for _ in range(2)
    ]
    solvers = {
        "cuda": PlacementSolver(device=cuda_device, prune_top_k=top_k,
                                prune_slack=slack),
        "cpu": PlacementSolver(device="cpu", prune_top_k=top_k, prune_slack=slack),
        "full": PlacementSolver(device=cuda_device),
    }
    got, launches, handles = {}, 0, []
    for name, solver in solvers.items():
        out = []
        before = window_pack.launches
        for usage, wins in zip(usages, batches):
            hs = [solver.pack_window_dispatch(
                "tightly-pack", solver.build_tensors_pipelined(nodes, usage, {}), w)
                for w in wins]
            out += [d for h in hs for d in solver.pack_window_fetch(h)]
            if name == "cuda":
                handles += hs
        if name == "cuda":
            launches = window_pack.launches - before
        got[name] = out
    assert got["cuda"] == got["cpu"] == got["full"]
    keys = ("windows", "kept_rows", "escalations", "reasons")
    st = solvers["cuda"].prune_stats
    assert {k: st[k] for k in keys} == {k: solvers["cpu"].prune_stats[k] for k in keys}
    assert st["windows"] > 0
    assert solvers["cuda"].window_path_counts.get("cuda-pruned", 0) > 0
    want = sum(len(h.requests) + (h.info.get("resolved") or {}).get("segments", 0)
               for h in handles)
    assert launches == want
    if top_k == 1:
        assert st["escalations"] > 0, st


@pytest.mark.parametrize("fill", STRATEGIES)
def test_batched_engine_on_cuda_matches_window_pack(cuda_device, fill):
    """`batched_fifo_pack` in window mode on CUDA tensors (plain PyTorch)
    against the row-walk kernel on the same window."""
    from spark_scheduler_tpu_torch.models.cluster import cluster_from_numpy
    from spark_scheduler_tpu_torch.models.resources import INT32_INF
    from spark_scheduler_tpu_torch.ops.batched import batched_fifo_pack
    from spark_scheduler_tpu_torch.ops.window import make_segmented_window, window_pack
    from chip_smoke import segmented_to_app_batch

    rng = np.random.default_rng(9)
    n, emax = 300, 8
    avail = rng.integers(0, 24, size=(n, 3)).astype(np.int32)
    avail[:, 2] = rng.integers(0, 3, size=n)
    cluster = cluster_from_numpy(
        [avail, avail.copy(), rng.integers(0, 4, size=n).astype(np.int32),
         rng.permutation(n).astype(np.int32),
         np.full(n, INT32_INF, np.int32), np.full(n, INT32_INF, np.int32),
         rng.random(n) < 0.1, rng.random(n) > 0.05, np.ones(n, bool)],
        device=cuda_device,
    )
    requests = [
        [(rng.integers(0, 5, 3).astype(np.int32) * [1, 1, 0],
          rng.integers(1, 4, 3).astype(np.int32),
          int(rng.integers(0, emax + 1)), bool(rng.random() < 0.3))
         for _ in range(int(rng.integers(1, 6)))]
        for _ in range(6)
    ]
    win = make_segmented_window(
        requests, [rng.random(n) < 0.9 for _ in requests], [np.ones(n, bool)] * 6
    )
    meta, execs, base = window_pack(cluster, win, fill=fill, emax=emax, num_zones=4)
    apps, (si, ri) = segmented_to_app_batch(win)
    got = batched_fifo_pack(cluster, apps, fill=fill, emax=emax, num_zones=4)
    assert got.driver_node.is_cuda
    meta, execs = meta.cpu().numpy(), execs.cpu().numpy()
    np.testing.assert_array_equal(got.driver_node.cpu().numpy(), meta[si, ri, 0])
    np.testing.assert_array_equal(got.admitted.cpu().numpy(), meta[si, ri, 1] == 1)
    np.testing.assert_array_equal(got.packed.cpu().numpy(), meta[si, ri, 2] == 1)
    np.testing.assert_array_equal(got.executor_nodes.cpu().numpy(), execs[si, ri])
    assert torch.equal(got.available_after, base)


@pytest.mark.parametrize("fill", STRATEGIES)
@pytest.mark.parametrize("n", [37, 10000])
def test_batched_engine_on_cuda_matches_fifo_pack(cuda_device, fill, n):
    """`batched_fifo_pack` in queue mode on CUDA tensors against the queue
    kernel on the same queue."""
    from spark_scheduler_tpu_torch.ops.batched import batched_fifo_pack
    from spark_scheduler_tpu_torch.ops.fifo import fifo_pack

    cluster, apps = _queue_case(np.random.default_rng(3), n, 9, cuda_device)
    want = fifo_pack(cluster, apps, fill=fill, emax=8, num_zones=4)
    got = batched_fifo_pack(cluster, apps, fill=fill, emax=8, num_zones=4)
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g, w), (fill, n)


@pytest.mark.parametrize("strategy", ["tightly-pack", "single-az-tightly-pack",
                                      "distribute-evenly"])
def test_preemption_search_on_cuda_matches_cpu(cuda_device, strategy):
    """`PlacementSolver.preemption_search` (the policy engine's search,
    ops/packing.py `preemption_batched_fit`) on a `cuda` solver against a
    `cpu` solver at 10,000 nodes with 8 nested candidate eviction sets:
    the same first feasible set, and the same per-candidate fits."""
    from spark_scheduler_tpu_torch.core.solver import PlacementSolver
    from spark_scheduler_tpu_torch.models.kube import ZONE_LABEL, Node
    from spark_scheduler_tpu_torch.models.resources import Resources

    rng = np.random.default_rng(12)
    n = 10_000
    nodes = [
        Node(name=f"node-{i:05d}",
             allocatable=Resources.from_quantities(
                 str(int(rng.integers(8, 65))), f"{int(rng.integers(32, 257))}Gi",
                 str(int(rng.integers(0, 2)))),
             labels={ZONE_LABEL: f"zone{i % 4}"})
        for i in range(n)
    ]
    # Full nodes: only the evictions free whole executor slots.
    usage = {nd.name: Resources(nd.allocatable.cpu_milli, nd.allocatable.mem_kib, 0)
             for nd in nodes}
    names = [nd.name for nd in nodes]
    solvers = [PlacementSolver(device=d) for d in (cuda_device, "cpu")]
    tensors = [s.build_tensors(nodes, usage, {}) for s in solvers]
    cap = solvers[0].registry.capacity
    assert cap == solvers[1].registry.capacity
    steps = np.zeros((8, cap, 3), np.int64)
    for c in range(8):
        rows = rng.choice(n, 24, replace=False)
        steps[c, rows, 0] = 4000
        steps[c, rows, 1] = 16 * 1024 * 1024
    freed = np.cumsum(steps, axis=0)
    drv = Resources.from_quantities("2", "8Gi")
    exe = Resources.from_quantities("4", "16Gi")
    got = [s.preemption_search(strategy, t, drv, exe, 160, names, freed)
           for s, t in zip(solvers, tensors)]
    assert got[0] == got[1]
    assert got[0][0] >= 1  # the first sets do not fit; a later one does
    assert solvers[0].preemption_searches == {"cuda": 1}


@pytest.mark.parametrize("prune", [0, 4])
def test_pool_on_one_card_redispatches_a_killed_slot(cuda_device, prune):
    """Two slots on cuda:0, each on its own stream, windows partitioned over
    two instance groups; the injector kills one part's launch. The part
    re-dispatches on the survivor: its blob equals the pool-less solve's
    (the decisions, every field), the slot is quarantined, and the probe
    kernel reinstates it on its stream."""
    from spark_scheduler_tpu_torch.core.solver import PlacementSolver, WindowRequest
    from spark_scheduler_tpu_torch.faults import FaultInjector, FaultPlan, FaultSpec
    from spark_scheduler_tpu_torch.models.kube import ZONE_LABEL, Node
    from spark_scheduler_tpu_torch.models.resources import Resources
    from spark_scheduler_tpu_torch.ops.probe import probe_add_one

    one = Resources.from_quantities("1", "1Gi")
    two = Resources.from_quantities("2", "2Gi")
    nodes = [Node(name=f"n{i:03d}",
                  allocatable=Resources.from_quantities("8", "8Gi", "1",
                                                        round_up=False),
                  labels={ZONE_LABEL: f"z{i % 2}"}) for i in range(300)]
    names = [n.name for n in nodes]
    half = names[:150], names[150:]

    def random_windows(rng):
        out, r = [], 0
        for _ in range(2):
            reqs = []
            for _ in range(4):
                rows = [(one, one, int(rng.integers(1, 3)), bool(rng.random() < 0.5))
                        for _ in range(int(rng.integers(0, 3)))]
                rows.append((two if rng.random() < 0.3 else one, one,
                             int(rng.integers(1, 4)), False))
                dom = half[r % 2]
                reqs.append(WindowRequest(rows=rows, driver_candidate_names=dom,
                                          domain_node_names=dom))
                r += 1
            out.append(reqs)
        return out

    def random_usage(rng):
        return {n: Resources.from_quantities(str(int(rng.integers(1, 4))), "1Gi")
                for n in names if rng.random() < 0.3}

    def run_sequential(s, batches, usages):
        out = []
        for usage, wins in zip(usages, batches):
            handles = [s.pack_window_dispatch(
                "tightly-pack", s.build_tensors_pipelined(nodes, usage, {}), w)
                for w in wins]
            for h in handles:
                out.extend(s.pack_window_fetch(h))
        return out

    rng = np.random.default_rng(70 + prune)
    batches = [random_windows(rng) for _ in range(3)]
    usage_objs = [{}] + [random_usage(rng) for _ in range(2)]
    want = run_sequential(PlacementSolver(device=cuda_device), batches, usage_objs)
    cpu = run_sequential(PlacementSolver(device="cpu"), batches, usage_objs)
    assert want == cpu
    pooled = PlacementSolver(device=cuda_device, pool_devices=[cuda_device] * 2,
                             prune_top_k=prune, prune_slack=0.5)
    assert [s.stream is not None for s in pooled._pool.slots] == [True, True]
    plan = FaultPlan(seed=0, specs=[FaultSpec(surface="device.dispatch",
                                              at=[3], limit=1)])
    with FaultInjector(plan) as inj:
        inj.install_device()
        got = run_sequential(pooled, batches, usage_objs)
    assert got == want
    assert pooled.redispatch_count == 1
    assert pooled.device_health()["healthy"] == 1
    before = probe_add_one.launches
    assert pooled.probe_quarantined(force=True) == 1
    assert probe_add_one.launches == before + 1
    assert pooled.device_health()["healthy"] == 2


def test_cuda_device_fault_from_a_wrapper_is_slot_fatal(cuda_device, monkeypatch,
                                                        tmp_path):
    """The wrappers map a device-side cudaError (an uncorrectable ECC
    error) to CudaDeviceFault (slot-fatal); an illegal address, which a
    wrong kernel raises, and a build failure stay plain errors."""
    from spark_scheduler_tpu_torch.faults.errors import (
        CudaDeviceFault,
        classify_slot_failure,
    )
    from spark_scheduler_tpu_torch.ops import _build, probe as probe_mod

    lib = probe_mod._PROBE.lib()

    class Faulting:
        code = 214  # cudaErrorECCUncorrectable

        def probe_add_one(self, *a):
            return self.code

        def probe_error(self, code):
            return lib.probe_error(code)

    faulting = Faulting()
    monkeypatch.setattr(probe_mod._PROBE, "lib", lambda: faulting)
    x = torch.zeros(probe_mod.PROBE_SHAPE, dtype=torch.int32, device=cuda_device)
    with pytest.raises(CudaDeviceFault) as ei:
        probe_mod.probe_add_one(x)
    assert ei.value.code == 214 and classify_slot_failure(ei.value)
    faulting.code = 700  # cudaErrorIllegalAddress
    with pytest.raises(RuntimeError, match="cudaError 700") as ei:
        probe_mod.probe_add_one(x)
    assert not isinstance(ei.value, CudaDeviceFault)
    assert not classify_slot_failure(ei.value)
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no such architecture'\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "library_path",
                        lambda name: _build.BUILD_DIR / f"missing-{name}.so")
    with pytest.raises(RuntimeError, match="CUDA build failed") as build_err:
        _build.load_library("probe")
    assert not classify_slot_failure(build_err.value)


# A real illegal address inside the row walk: the base pointer of the
# second window's launches is replaced by one no allocation holds. Run in
# a process of its own, since the fault poisons that process's CUDA
# context.
_ILLEGAL_ADDRESS_SCRIPT = r"""
import json, os, sys
import torch
from spark_scheduler_tpu_torch.core.solver import PlacementSolver, WindowRequest
from spark_scheduler_tpu_torch.faults import DegradedModeController
from spark_scheduler_tpu_torch.models.kube import ZONE_LABEL, Node
from spark_scheduler_tpu_torch.models.resources import Resources
from spark_scheduler_tpu_torch.ops import window

pool = sys.argv[1] == "pool"
dev = torch.device("cuda", 0)
kw = {"pool_devices": [dev, dev]} if pool else {}
s = PlacementSolver(device=dev, **kw)
s.degraded = DegradedModeController(policy="greedy")
nodes = [Node(name=f"n{i:02d}", allocatable=Resources.from_quantities("8", "8Gi"),
              labels={ZONE_LABEL: f"z{i % 2}"}) for i in range(12)]
one = Resources.from_quantities("1", "1Gi")
names = [n.name for n in nodes]
reqs = [WindowRequest(rows=[(one, one, 2 + i, False)], driver_candidate_names=names)
        for i in range(3)]
healthy = s.pack_window("tightly-pack", s.build_tensors_pipelined(nodes, {}, {}), reqs)
torch.cuda.synchronize()
real = window._ROW_WALK.lib()


class Corrupt:
    def __getattr__(self, name):
        return getattr(real, name)

    def window_row_walk(self, *args):
        args = list(args)
        args[8] = 0x100  # the availability base
        return real.window_row_walk(*args)


window._ROW_WALK.lib = lambda: Corrupt()
raised = None
try:
    s.pack_window("tightly-pack", s.build_tensors_pipelined(nodes, {}, {}), reqs)
    torch.cuda.synchronize()
except Exception as exc:
    raised = f"{type(exc).__name__}: {exc}"
snap = s.degraded.snapshot()
print(json.dumps({
    "healthy": sum(d.admitted for d in healthy),
    "raised": raised,
    "engagements": snap["engagements"],
    "fallback_decisions": snap["fallback_decisions"],
    "quarantined": s.device_health()["quarantined"],
    "redispatches": s.redispatch_count,
}), flush=True)
os._exit(0)
"""


@pytest.mark.parametrize("mode", ["single", "pool"])
def test_illegal_address_from_the_row_walk_raises(cuda_device, mode):
    """An illegal address inside the row walk (a wrong kernel's fault) on a
    cuda solver with the greedy degraded policy wired, pool-less and on a
    pool of two slots: the window raises, degraded mode never engages, no
    slot is quarantined and no part re-dispatched."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    proc = subprocess.run(
        [sys.executable, "-c", _ILLEGAL_ADDRESS_SCRIPT, mode],
        cwd=repo, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["healthy"] == 3
    assert got["raised"] is not None and (
        "illegal memory access" in got["raised"] or "cudaError 700" in got["raised"]
    ), got["raised"]
    assert got["engagements"] == 0 and got["fallback_decisions"] == 0, got
    assert got["quarantined"] == [] and got["redispatches"] == 0, got


def _random_port_cluster(rng, n, device):
    from spark_scheduler_tpu_torch.models.cluster import cluster_from_numpy
    from spark_scheduler_tpu_torch.models.resources import INT32_INF

    avail = rng.integers(0, 24, size=(n, 3)).astype(np.int32)
    avail[:, 2] = rng.integers(0, 3, size=n)
    return cluster_from_numpy(
        [avail, avail.copy(), rng.integers(0, 4, size=n).astype(np.int32),
         rng.permutation(n).astype(np.int32),
         np.full(n, INT32_INF, np.int32), np.full(n, INT32_INF, np.int32),
         rng.random(n) < 0.05, rng.random(n) < 0.97, np.ones(n, bool)],
        device=device,
    )


def _random_window_batch(rng, n, segs):
    from spark_scheduler_tpu_torch.ops.batched import make_app_batch

    b = sum(segs)
    drv = rng.integers(0, 4, size=(b, 3)).astype(np.int32)
    exc = rng.integers(0, 6, size=(b, 3)).astype(np.int32)
    drv[:, 2] = exc[:, 2] = 0
    commit, reset = np.zeros(b, bool), np.zeros(b, bool)
    cand, dom = np.zeros((b, n), bool), np.zeros((b, n), bool)
    r = 0
    for s in segs:
        reset[r] = True
        commit[r + s - 1] = True
        cand[r:r + s] = rng.random(n) < 0.8
        dom[r:r + s] = rng.random(n) < 0.9
        r += s
    return make_app_batch(
        drv, exc, rng.integers(0, 8, size=b).astype(np.int32),
        skippable=rng.random(b) < 0.3, driver_cand=cand, domain=dom,
        commit=commit, reset=reset,
    )


def test_cuda_solver_lane_declines_and_launches_the_row_walk(cuda_device):
    """A dispatch lane on a `cuda` solver is never asked: the row walk
    serves every window (as the Pallas kernel does on a TPU), and the
    same lane on a `cpu` solver defers the same window."""
    from spark_scheduler_tpu_torch.core.solver import PlacementSolver, WindowRequest
    from spark_scheduler_tpu_torch.models.kube import Node
    from spark_scheduler_tpu_torch.models.resources import Resources
    from spark_scheduler_tpu_torch.ops.window import window_pack
    from spark_scheduler_tpu_torch.replay.sweep import SweepCoordinator

    nodes = [Node(name=f"n{i}", allocatable=Resources.from_quantities("8", "8Gi"))
             for i in range(64)]
    one = Resources.from_quantities("1", "1Gi")
    reqs = [WindowRequest(rows=[(one, one, 2, False)],
                          driver_candidate_names=[n.name for n in nodes])
            for _ in range(3)]
    got = {}
    for dev in (cuda_device, "cpu"):
        tel = {k: 0 for k in ("windows", "stacked_dispatches",
                              "stacked_arm_windows", "lane_fallbacks",
                              "forced_resolves")}
        tel.update(replay_compile_ms=0.0, solve_s=0.0)
        lane = SweepCoordinator(tel)
        solver = PlacementSolver(device=dev)
        solver._dispatch_lane = lane
        before = window_pack.launches
        h = solver.pack_window_dispatch(
            "tightly-pack", solver.build_tensors_pipelined(nodes, {}, {}), reqs
        )
        lane.flush()
        got[str(dev)] = [d.packing.driver_node for d in solver.pack_window_fetch(h)]
        if dev == cuda_device:
            assert window_pack.launches - before == 3
            assert solver.window_path_counts == {"cuda": 1}
            assert tel["windows"] == 0 and not lane.pending
        else:
            assert solver.window_path_counts == {"deferred": 1}
            assert tel["windows"] == 1
        solver.close()
    assert got[str(cuda_device)] == got["cpu"]


@pytest.mark.parametrize("seed", [0, 1])
def test_stacked_solves_on_cuda_match_cpu(cuda_device, seed):
    """`arm_stacked_fifo_pack` and `bucket_stacked_fifo_pack` on CUDA
    tensors equal the same calls on CPU tensors, and leave the caller's
    stack as it was."""
    from spark_scheduler_tpu_torch.models.cluster import cluster_statics
    from spark_scheduler_tpu_torch.ops.batched import (
        arm_stacked_fifo_pack,
        bucket_stacked_fifo_pack,
        pad_app_batch,
        stack_app_batches,
    )

    rng = np.random.default_rng(seed)
    n, emax, zones = 300, 8, 4
    base = _random_port_cluster(rng, n, "cpu")
    apps = _random_window_batch(rng, n, (2, 1, 3))
    fills = ("distribute-evenly", "single-az-tightly-pack", "tightly-pack",
             "tightly-pack")
    stack = torch.stack([base.available - int(i) for i in range(4)])
    out = {}
    for dev in ("cpu", cuda_device):
        s = stack.to(dev)
        before = s.clone()
        blob, after = arm_stacked_fifo_pack(
            s, tuple(x.to(dev) for x in cluster_statics(base)), apps,
            fills=fills, emax=emax, num_zones=zones,
        )
        assert torch.equal(s, before)
        out[str(dev)] = (blob.cpu(), after.cpu())
    assert torch.equal(out["cpu"][0], out[str(cuda_device)][0])
    assert torch.equal(out["cpu"][1], out[str(cuda_device)][1])

    clusters = [_random_port_cluster(rng, n, "cpu") for _ in range(3)]
    batches = [_random_window_batch(rng, n, segs) for segs in ((1,), (2, 2), (3,))]
    rows = max(b.driver_req.shape[0] for b in batches)
    apps_stack = stack_app_batches([pad_app_batch(b, rows) for b in batches])
    fills = ("minimal-fragmentation", "tightly-pack", "tightly-pack")
    out = {}
    for dev in ("cpu", cuda_device):
        statics = tuple(
            torch.stack([cluster_statics(c)[i] for c in clusters]).to(dev)
            for i in range(len(cluster_statics(clusters[0])))
        )
        avail = torch.stack([c.available for c in clusters]).to(dev)
        blob, after = bucket_stacked_fifo_pack(
            avail, statics, apps_stack, fills=fills, emax=emax,
            num_zones=zones,
        )
        out[str(dev)] = (blob.cpu(), after.cpu())
    assert torch.equal(out["cpu"][0], out[str(cuda_device)][0])
    assert torch.equal(out["cpu"][1], out[str(cuda_device)][1])


def test_fleet_on_cuda_matches_its_cpu_replay(cuda_device):
    """A short stacked-config fleet on the card: `stack-window-ms` is inert
    there (no coordinator, stacking reported disabled), no window defers,
    every driver window launches the row walk, and each cluster's oplog
    replays byte-identically on a `cpu` standalone stack and on the
    card."""
    from spark_scheduler_tpu_torch.fleet import FleetFacade, verify_cluster_equivalence
    from spark_scheduler_tpu_torch.ops.window import window_pack
    from spark_scheduler_tpu_torch.server.config import InstallConfig
    from spark_scheduler_tpu_torch.testing.harness import (
        INSTANCE_GROUP_LABEL,
        new_node,
        static_allocation_spark_pods,
    )

    cfg = InstallConfig(fifo=True, sync_writes=True,
                        instance_group_label=INSTANCE_GROUP_LABEL)
    f = FleetFacade(3, cfg, record_ops=True, stack_window_ms=5.0,
                    device=cuda_device)
    try:
        for c in range(3):
            for i in range(40):
                f.add_node(c, new_node(f"c{c}-n{i}", zone=f"zone{i % 2}",
                                       instance_group="ig-s" if c < 2 else "ig-x"))
        before = window_pack.launches
        drivers = 0
        for k in range(12):
            pods = static_allocation_spark_pods(
                f"cf-{k}", 1 + k % 3, instance_group="ig-s" if k % 4 else "ig-x"
            )
            for p in pods:
                f.schedule(p, via=k % 3)
            drivers += 1
        f.kill_cluster(2)
        f.rejoin_cluster(2)
        st = f.state()
        assert f.dispatch is None
        assert st["stacking"] == {"enabled": False}
        assert window_pack.launches - before >= drivers
        assert all(s.app.solver.window_path_counts.get("deferred", 0) == 0
                   for s in f.stacks)
        for dev in ("cpu", None):
            report = verify_cluster_equivalence(f, device=dev)
            assert all(r["identical"] for r in report.values())
    finally:
        f.stop()


@pytest.mark.parametrize("prune", [0, 4])
def test_resident_build_on_cuda_matches_cpu_under_churn(cuda_device, prune):
    """The native arena's resident build feeding a `cuda` solver against a
    `cpu` one, both with `solver.build-oracle`, through the port's harness
    on 300 nodes: node updates, adds and deletes between pipelined windows
    of 4 drivers. Every window's node names are equal, every mirror sync
    rides the dirty set (no dense sync, the oracle checked each), and every
    driver window launched the row walk on the card."""
    import dataclasses

    from spark_scheduler_tpu_torch.core.extender import ExtenderArgs
    from spark_scheduler_tpu_torch.ops.window import window_pack
    from spark_scheduler_tpu_torch.testing import harness as hm

    runs, stats = [], []
    for device in (cuda_device, "cpu"):
        h = hm.Harness(binpack_algo="tightly-pack", fifo=False, device=device,
                       solver_build_oracle=True, solver_prune_top_k=prune,
                       solver_prune_slack=0.75)
        live = [f"n{i:03d}" for i in range(300)]
        h.add_nodes(*[hm.new_node(n, zone=f"zone{i % 4}")
                      for i, n in enumerate(live)])
        rng = np.random.default_rng(5)
        before = window_pack.launches
        out = []
        for step in range(12):
            op = step % 3
            if op == 0:
                name = f"add-{step:02d}"
                h.add_nodes(hm.new_node(name, zone=f"zone{step % 4}"))
                live.append(name)
            elif op == 1:
                name = live[int(rng.integers(0, len(live)))]
                cur = h.backend.get_node(name)
                h.backend.update("nodes", dataclasses.replace(
                    cur, unschedulable=not cur.unschedulable))
            else:
                h.backend.delete("nodes", "", live.pop(int(rng.integers(0, len(live)))))
            drivers = []
            for j in range(4):
                d = hm.static_allocation_spark_pods(f"rc-{step}-{j}", 3)[0]
                h.add_pods(d)
                drivers.append(d)
            t = h.extender.predicate_window_dispatch(
                [ExtenderArgs(pod=d, node_names=list(live)) for d in drivers])
            out.append([tuple(r.node_names)
                        for r in h.extender.predicate_window_complete(t)])
        bs = h.app.solver.build_stats
        assert bs["mirror_dense_syncs"] == 0 and bs["oracle_checks"] >= 11, bs
        assert bs["incremental_builds"] >= 11, bs
        if device != "cpu":
            assert window_pack.launches - before >= 12
        runs.append(out)
        stats.append(dict(bs))
        h.app.stop()
    assert runs[0] == runs[1]
    assert stats[0]["dirty_rows"] == stats[1]["dirty_rows"]


# ------------------------------------------- parallel across cards (§A.6)


def _sharded_case(seed, n, mode):
    """A cpu cluster (`_queue_case`'s) and a batch of 9 rows padded to 12
    in `mode`: a zero-count gang first, gangs up to emax + 2 wide, per-row
    masks (masked), segments of 3, 1, 2 and 3 rows (window)."""
    from spark_scheduler_tpu_torch.ops.batched import make_app_batch

    rng = np.random.default_rng(seed)
    cluster, _ = _queue_case(rng, n, 1, "cpu")
    b = 9
    driver = rng.integers(1, 6, size=(b, 3)).astype(np.int32)
    execs = rng.integers(1, 8, size=(b, 3)).astype(np.int32)
    counts = rng.integers(0, 11, size=b).astype(np.int32)
    counts[0] = 0
    kw = dict(skippable=rng.random(b) < 0.3, pad_to=12)
    if mode == "masked":
        kw.update(driver_cand=rng.random((b, n)) < 0.7,
                  domain=rng.random((b, n)) < 0.9)
    if mode == "window":
        reset, commit = np.zeros(b, bool), np.zeros(b, bool)
        cand, dom = np.zeros((b, n), bool), np.zeros((b, n), bool)
        r = 0
        for seg in (3, 1, 2, 3):
            reset[r], commit[r + seg - 1] = True, True
            cand[r:r + seg] = rng.random(n) < 0.7
            dom[r:r + seg] = rng.random(n) < 0.9
            r += seg
        kw.update(commit=commit, reset=reset, driver_cand=cand, domain=dom)
    return cluster, make_app_batch(driver, execs, counts, **kw)


@pytest.mark.parametrize("mode", ["queue", "masked", "window"])
@pytest.mark.parametrize("fill", STRATEGIES)
def test_node_sharded_engine_on_cuda_matches_unsharded(cuda_device, fill, mode):
    """The node-sharded engine on 1, 2 and 4 shards of the card (one stream
    each) against the unsharded engine on the card and the 4 cpu shards."""
    from spark_scheduler_tpu_torch.ops.batched import batched_fifo_pack
    from spark_scheduler_tpu_torch.parallel import (
        node_sharded_fifo_pack,
        shard_cluster,
    )

    for seed in (0, 1):
        cluster, apps = _sharded_case(seed, 36, mode)
        kw = dict(fill=fill, emax=8, num_zones=4)
        cpu = node_sharded_fifo_pack(shard_cluster(["cpu"] * 4, cluster), apps, **kw)
        card = cluster.__class__(*(f.to(cuda_device) for f in cluster.fields()))
        want = batched_fifo_pack(card, apps, **kw)
        for s in (1, 2, 4):
            got = node_sharded_fifo_pack(
                shard_cluster([cuda_device] * s, card), apps, **kw
            )
            for g, w, c in zip(got, want, cpu):
                assert g.device == cuda_device
                assert torch.equal(g, w) and torch.equal(g.cpu(), c), (s, seed)


def test_node_sharded_engine_on_two_cards(cuda_device):
    """The engine with its two shards on distinct cards (the cross-card
    copies of the hand-offs) against the unsharded engine; needs two
    cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: the shards go on distinct cards")
    from spark_scheduler_tpu_torch.ops.batched import batched_fifo_pack
    from spark_scheduler_tpu_torch.parallel import (
        node_sharded_fifo_pack,
        shard_cluster,
    )

    devs = [torch.device("cuda", 0), torch.device("cuda", 1)]
    for mode in ("queue", "masked", "window"):
        for fill in STRATEGIES:
            cluster, apps = _sharded_case(2, 36, mode)
            kw = dict(fill=fill, emax=8, num_zones=4)
            want = batched_fifo_pack(cluster, apps, **kw)
            got = node_sharded_fifo_pack(shard_cluster(devs, cluster), apps, **kw)
            for g, w in zip(got, want):
                assert g.device == devs[0]
                assert torch.equal(g.cpu(), w), (mode, fill)


def test_group_sharded_queue_kernel_launches_once_a_device(cuda_device):
    """Four groups on a (4, 1) groups mesh of the card: four launches of the
    queue kernel, one a groups device, equal to the single launch."""
    from spark_scheduler_tpu_torch.ops.fifo import fifo_pack
    from spark_scheduler_tpu_torch.parallel import (
        grouped_fifo_pack,
        grouped_fifo_pack_auto,
        make_solver_mesh,
        stack_groups,
    )
    rng = np.random.default_rng(3)
    cases = [_queue_case(rng, 300, 12, cuda_device) for _ in range(4)]
    sc, sa = stack_groups([c for c, _ in cases], [a for _, a in cases])
    kw = dict(fill="tightly-pack", emax=8, num_zones=4)
    before = fifo_pack.launches
    got = grouped_fifo_pack_auto(
        make_solver_mesh(4, 1, devices=[cuda_device] * 4), sc, sa, **kw
    )
    assert fifo_pack.launches == before + 4
    want = grouped_fifo_pack(sc, sa, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_mesh_slot_and_scale_tier_on_cuda_match_cpu(cuda_device):
    """A one-slot 4-shard mesh on the card with a tight top-K and the scale
    tier (tests/test_torch_scale_tier.py's world, 128 nodes): pruned windows
    on the mesh, escalations re-solved node-sharded, every decision equal
    to a cpu solver's."""
    from spark_scheduler_tpu_torch.core.solver import PlacementSolver, WindowRequest
    from spark_scheduler_tpu_torch.models.kube import ZONE_LABEL, Node
    from spark_scheduler_tpu_torch.models.resources import Resources

    nodes = [
        Node(name=f"n{i:03d}",
             allocatable=Resources.from_quantities("8", "8Gi", "1", round_up=False),
             labels={ZONE_LABEL: f"z{i % 3}"})
        for i in range(128)
    ]
    names = [n.name for n in nodes]
    one = Resources.from_quantities("1", "1Gi")
    rng = np.random.default_rng(9)
    batches = []
    for _ in range(3):
        wins = []
        for _ in range(2):
            reqs = []
            for _ in range(4):
                rows = [(one, one, int(rng.integers(1, 3)), bool(rng.random() < 0.5))
                        for _ in range(int(rng.integers(0, 3)))]
                res = Resources.from_quantities("2", "2Gi") if rng.random() < 0.3 else one
                rows.append((res, one, int(rng.integers(1, 4)), False))
                reqs.append(WindowRequest(rows=rows, driver_candidate_names=names))
            wins.append(reqs)
        batches.append(wins)

    def run(solver):
        out = []
        for wins in batches:
            handles = [
                solver.pack_window_dispatch(
                    "tightly-pack", solver.build_tensors_pipelined(nodes, {}, {}), w)
                for w in wins
            ]
            out.extend(d for h in handles for d in solver.pack_window_fetch(h))
        return out

    tight = dict(prune_top_k=1, prune_slack=0.01)
    mesh = PlacementSolver(device=cuda_device, mesh=(1, 4), scale_tier=True,
                           pool_devices=[cuda_device] * 4, **tight)
    assert run(mesh) == run(PlacementSolver(device="cpu", **tight))
    assert mesh.prune_stats["escalations"] > 0
    st = mesh.scale_tier_stats
    assert st["sharded"] > 0 and st["fallbacks"] == 0, st
