"""The multi-arm sweep (replay/sweep.py) and the stacked solves
(ops/batched.py) of the port, against the JAX package, on the CPU.

Pinned, as tests/test_replay_sweep.py pins them for the JAX package, and
across the packages:

  * every arm of an M-arm sweep (the JAX suite's ARM_SETS, M in {2, 4, 8})
    equals its own sequential port replay AND the JAX sweep's arm:
    verdicts, placements, denials, utilization, fragmentation, mismatch
    census;
  * determinism, stream dedup and the shared-build accounting (the whole
    telemetry dict equals the JAX package's, wall times aside), the report
    shapes, `grid_arms`, `what_if` as a 2-arm sweep, and the device-pool x
    autoscaler grid collapsing to one stream;
  * on a CPU solver the lane defers every plain window (stacked dispatches
    happen, quantum 8); the stacked solves `arm_stacked_fifo_pack` and
    `bucket_stacked_fifo_pack` equal the JAX ones on random inputs with
    mixed fills, padding and masks, are pad-invariant, leave the caller's
    tensors as they were, and raise on a mismatched `fills` length and on
    mixed None-ness.

Tolerance: none.
"""

from __future__ import annotations

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_scheduler_tpu.models.cluster import cluster_statics as j_statics
from spark_scheduler_tpu.ops import batched as JB
from spark_scheduler_tpu_torch.models.cluster import cluster_statics
from spark_scheduler_tpu_torch.ops import batched as TB
from tests.test_packing_golden import random_cluster
from tests.test_replay_sweep import ARM_SETS
from tests.test_torch_batched import window_batch
from tests.test_torch_extender import JAX, PORT
from tests.test_torch_fifo import port_cluster
from tests.test_torch_native import load_jax_native


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    load_jax_native()


def _replay(root):
    return importlib.import_module(f"{root}.replay")


def _sweep(root, path, arms, **kw):
    if root == PORT:
        kw["device"] = "cpu"
    return _replay(root).run_sweep(path, arms, **kw)


def _seq(root, path, arm):
    kw = {"device": "cpu"} if root == PORT else {}
    return _replay(root).replay_trace(path, overrides=arm or None, **kw)


@pytest.fixture(scope="module")
def bursty_trace(tmp_path_factory):
    """The JAX suite's trace: bursty, seed 11, 24 nodes, 6 bursts."""
    path = str(tmp_path_factory.mktemp("torch_sweep") / "bursty.jsonl")
    _replay(JAX).generate("bursty", path, seed=11, n_nodes=24, bursts=6)
    return path


def _assert_arm_equiv(arm, rep, seq):
    assert rep.placements == seq.placements, arm
    assert rep.verdict_counts == seq.verdict_counts, arm
    assert rep.denials == seq.denials, arm
    assert rep.decisions == seq.decisions, arm
    assert rep.utilization == seq.utilization, arm
    assert rep.fragmentation == seq.fragmentation, arm
    assert len(rep.mismatches) == len(seq.mismatches), arm


def _telemetry(sweep):
    t = dict(sweep.telemetry)
    for k in ("replay_compile_ms", "solve_s", "windows_per_s"):
        t.pop(k)
    return t


@pytest.mark.parametrize("m", sorted(ARM_SETS))
def test_sweep_arms_equal_sequential_replays_and_jax(bursty_trace, m):
    arms = ARM_SETS[m]
    sweep = _sweep(PORT, bursty_trace, arms)
    want = _sweep(JAX, bursty_trace, arms)
    assert len(sweep.reports) == m
    for arm, rep, jrep in zip(arms, sweep.reports, want.reports):
        _assert_arm_equiv(arm, rep, _seq(PORT, bursty_trace, arm))
        _assert_arm_equiv(arm, rep, jrep)
        assert rep.decision_summary() == jrep.decision_summary(), arm
    assert sweep.telemetry["forced_resolves"] == 0
    # The CPU lanes defer their plain windows into stacked solves, as the
    # JAX package's XLA lanes do.
    assert sweep.telemetry["stacked_dispatches"] > 0
    assert _telemetry(sweep) == _telemetry(want)


def test_sweep_accelerate_off_still_bit_identical(bursty_trace):
    arms = ARM_SETS[2]
    sweep = _sweep(PORT, bursty_trace, arms, accelerate=False)
    for arm, rep in zip(arms, sweep.reports):
        _assert_arm_equiv(arm, rep, _seq(PORT, bursty_trace, arm))
    assert sweep.telemetry["lane_pruned_windows"] == [0, 0]


def test_sweep_determinism(bursty_trace):
    arms = ARM_SETS[4]
    a = _sweep(PORT, bursty_trace, arms).decision_summary()
    b = _sweep(PORT, bursty_trace, arms).decision_summary()
    assert a == b == _sweep(JAX, bursty_trace, arms).decision_summary()


def test_stream_dedup_and_shared_build_accounting(bursty_trace):
    arms = [
        {},
        {"solver_prune_top_k": 4, "solver_prune_slack": 0.75},
        {"binpack_algo": "distribute-evenly"},
        {"binpack_algo": "minimal-fragmentation"},
    ]
    sweep = _sweep(PORT, bursty_trace, arms)
    t = sweep.telemetry
    assert t["arms"] == 4 and t["streams"] == 3 and t["dedup_arms"] == 1
    assert sweep.arms[0]["stream"] == sweep.arms[1]["stream"]
    assert t["lane_roster_rebuilds"] == [1] * t["streams"]
    assert t["lane_full_snapshots"] == [1] * t["streams"]
    assert t["stacked_dispatches"] > 0
    assert t["stacked_arm_windows"] >= 2 * t["stacked_dispatches"]
    assert t["windows"] == t["stacked_arm_windows"] + t["lane_fallbacks"]
    assert t["shared_build_hits"] > 0
    assert sweep.reports[0] is not sweep.reports[1]
    assert sweep.reports[0].placements == sweep.reports[1].placements
    assert _telemetry(sweep) == _telemetry(_sweep(JAX, bursty_trace, arms))


def test_sweep_report_shapes(bursty_trace):
    sweep = _sweep(PORT, bursty_trace, ARM_SETS[2])
    s = sweep.summary()
    assert [a["name"] for a in s["arms"]] == [
        "base",
        "binpack_algo=distribute-evenly",
    ]
    assert all("report" in a for a in s["arms"])
    assert s["telemetry"]["arms"] == 2
    md = sweep.markdown()
    assert md.count("\n") >= 3 and "| arm |" in md
    assert "stacked dispatches" in md
    last = importlib.import_module(f"{PORT}.replay.sweep").last_sweep_telemetry()
    assert last["arms"] == 2 and "wall_s" in last


def test_grid_arms_cartesian_equals_jax():
    grid = {"binpack-algo": ["a", "b"], "solver_prune_top_k": [0, 64]}
    arms = importlib.import_module(f"{PORT}.replay.sweep").grid_arms(
        grid, base={"fifo": True}
    )
    assert len(arms) == 4 and all(a["fifo"] is True for a in arms)
    assert arms == importlib.import_module(f"{JAX}.replay.sweep").grid_arms(
        grid, base={"fifo": True}
    )


def test_what_if_is_a_two_arm_sweep(bursty_trace, monkeypatch):
    engine = importlib.import_module(f"{PORT}.replay.engine")
    sweep_mod = importlib.import_module(f"{PORT}.replay.sweep")
    seen = {}
    real = sweep_mod.run_sweep

    def spy(trace, arms, **kw):
        seen["arms"] = list(arms)
        seen["device"] = kw.get("device")
        return real(trace, arms, **kw)

    monkeypatch.setattr(sweep_mod, "run_sweep", spy)
    diff = engine.what_if(
        bursty_trace, {"binpack-algo": "distribute-evenly"}, device="cpu"
    )
    assert seen["arms"] == [{}, {"binpack-algo": "distribute-evenly"}]
    assert seen["device"] == "cpu"
    for key in (
        "trace", "overrides", "decisions", "verdicts", "denials",
        "placements", "latency_ms", "utilization", "fragmentation",
        "overcommit", "base_mismatches",
    ):
        assert key in diff, key
    assert diff["decisions"]["base"] == diff["decisions"]["variant"]


def test_device_pool_and_autoscaler_grid_shares_one_stream(bursty_trace):
    arms = importlib.import_module(f"{PORT}.replay.sweep").grid_arms(
        {
            "solver-device-pool": [1, 2],
            "autoscaler-idle-ttl-s": [60.0, 300.0],
        }
    )
    assert len(arms) == 4
    sweep = _sweep(PORT, bursty_trace, arms)
    t = sweep.telemetry
    assert t["arms"] == 4 and t["streams"] == 1 and t["dedup_arms"] == 3
    assert len({a["stream"] for a in sweep.arms}) == 1
    assert t["lane_roster_rebuilds"] == [1] and t["lane_full_snapshots"] == [1]
    seq = _seq(PORT, bursty_trace, {})
    for arm, rep in zip(sweep.arms, sweep.reports):
        _assert_arm_equiv(arm, rep, seq)


def test_cli_sweep_on_the_cpu(bursty_trace, capsys):
    main = importlib.import_module(f"{PORT}.replay.__main__").main
    assert main([
        "sweep", bursty_trace, "--grid",
        "binpack-algo=tightly-pack,distribute-evenly", "--device", "cpu",
    ]) == 0
    import json

    out = json.loads(capsys.readouterr().out)
    assert [a["name"] for a in out["arms"]] == [
        "binpack_algo=tightly-pack", "binpack_algo=distribute-evenly",
    ]


# ------------------------------------------------------- stacked solves

EMAX, ZONES, N = 8, 4, 24


def _jax_blob(out):
    return np.concatenate(
        [
            np.asarray(out.driver_node)[:, None],
            np.asarray(out.admitted)[:, None].astype(np.int32),
            np.asarray(out.packed)[:, None].astype(np.int32),
            np.asarray(out.executor_nodes),
        ],
        axis=1,
    )


MIXED_FILLS = (
    ("distribute-evenly", "tightly-pack", "tightly-pack",
     "single-az-minimal-fragmentation"),
    ("minimal-fragmentation", "minimal-fragmentation", "az-aware-tightly-pack"),
)


@pytest.mark.parametrize("fills", MIXED_FILLS)
@pytest.mark.parametrize("seed", [0, 4])
def test_arm_stacked_equals_jax_and_sequential(seed, fills):
    rng = np.random.default_rng(seed)
    base = random_cluster(rng, N)
    apps = TB.make_app_batch(**window_batch(rng, N), pad_to=16)
    fills = tuple(sorted(fills))  # equal fills adjacent
    m = len(fills)
    # Per-arm availability: the shared cluster less a different random
    # debit per arm (negative entries included).
    avails = [
        np.asarray(base.available)
        - rng.integers(0, 3, size=(N, 3)).astype(np.int32)
        for _ in range(m)
    ]
    stack = torch.tensor(np.stack(avails))
    before = stack.clone()
    host = port_cluster(base)
    blob, after = TB.arm_stacked_fifo_pack(
        stack, cluster_statics(host), apps, fills=fills, emax=EMAX,
        num_zones=ZONES,
    )
    assert torch.equal(stack, before)  # the caller's stack is not written
    jblob, jafter = JB.arm_stacked_fifo_pack(
        jnp.asarray(np.stack(avails)), j_statics(base), apps,
        fills=fills, emax=EMAX, num_zones=ZONES,
    )
    np.testing.assert_array_equal(blob.numpy(), np.asarray(jblob))
    np.testing.assert_array_equal(after.numpy(), np.asarray(jafter))
    for i, fill in enumerate(fills):
        out = TB.batched_fifo_pack(
            TB.cluster_from_statics(torch.tensor(avails[i]),
                                    cluster_statics(host)),
            apps, fill=fill, emax=EMAX, num_zones=ZONES,
        )
        np.testing.assert_array_equal(
            blob[i].numpy(), TB._packing_blob(out).numpy(), err_msg=fill
        )


@pytest.mark.parametrize("seed", [0, 3])
def test_bucket_stacked_equals_jax_and_per_member_solves(seed):
    rng = np.random.default_rng(seed)
    members = []
    for segs, fill in (
        ((3, 1, 1), "tightly-pack"),
        ((2,), "distribute-evenly"),
        ((1, 2, 3, 1), "tightly-pack"),
    ):
        members.append((
            random_cluster(rng, N),
            TB.make_app_batch(**window_batch(rng, N, segs=segs)),
            fill,
        ))
    members.sort(key=lambda x: x[2])
    rows = max(x[1].driver_req.shape[0] for x in members)
    fills = tuple(x[2] for x in members)
    apps_stack = TB.stack_app_batches(
        [TB.pad_app_batch(x[1], rows) for x in members]
    )
    hosts = [port_cluster(x[0]) for x in members]
    statics = tuple(
        torch.stack([cluster_statics(h)[i] for h in hosts])
        for i in range(len(cluster_statics(hosts[0])))
    )
    avail = torch.stack([h.available for h in hosts])
    blob, after = TB.bucket_stacked_fifo_pack(
        avail, statics, apps_stack, fills=fills, emax=EMAX, num_zones=ZONES
    )
    j_stack = JB.stack_app_batches(
        [JB.pad_app_batch(x[1], rows) for x in members]
    )
    jstat = tuple(
        jnp.stack([jnp.asarray(j_statics(x[0])[i]) for x in members])
        for i in range(len(j_statics(members[0][0])))
    )
    jblob, jafter = JB.bucket_stacked_fifo_pack(
        jnp.stack([jnp.asarray(x[0].available) for x in members]), jstat,
        j_stack, fills=fills, emax=EMAX, num_zones=ZONES,
    )
    np.testing.assert_array_equal(blob.numpy(), np.asarray(jblob))
    np.testing.assert_array_equal(after.numpy(), np.asarray(jafter))
    for i, (c, apps, fill) in enumerate(members):
        want = JB.batched_fifo_pack(c, apps, fill=fill, emax=EMAX,
                                    num_zones=ZONES)
        b = apps.driver_req.shape[0]
        np.testing.assert_array_equal(blob[i, :b].numpy(), _jax_blob(want))
        np.testing.assert_array_equal(
            after[i].numpy(), np.asarray(want.available_after)
        )


def test_stacked_solves_are_pad_invariant():
    rng = np.random.default_rng(9)
    c = port_cluster(random_cluster(rng, N))
    apps = TB.make_app_batch(**window_batch(rng, N))
    b = apps.driver_req.shape[0]
    stack = c.available[None].repeat(2, 1, 1)
    fills = ("distribute-evenly", "tightly-pack")
    small = TB.arm_stacked_fifo_pack(
        stack, cluster_statics(c), apps, fills=fills, emax=EMAX,
        num_zones=ZONES,
    )
    padded = TB.pad_app_batch(apps, 32)
    assert padded.driver_req.shape[0] == 32
    assert TB.pad_app_batch(apps, b) is apps
    big = TB.arm_stacked_fifo_pack(
        stack, cluster_statics(c), padded, fills=fills, emax=EMAX,
        num_zones=ZONES,
    )
    assert torch.equal(small[0], big[0][:, :b])
    assert not big[0][:, b:, 1].any()  # padding rows admit nothing
    assert torch.equal(small[1], big[1])


def test_mismatched_fills_raise():
    for fn, args in (
        (TB.arm_stacked_fifo_pack, ((), None)),
        (TB.bucket_stacked_fifo_pack, ((), None)),
    ):
        with pytest.raises(ValueError, match="fills"):
            fn(torch.zeros((2, 8, 3), dtype=torch.int32), *args,
               fills=("tightly-pack",), emax=8, num_zones=2)


def test_stack_app_batches_rejects_mixed_noneness():
    rng = np.random.default_rng(5)
    a = TB.make_app_batch(**window_batch(rng, 8, segs=(2, 2)))
    b = TB.make_app_batch(**window_batch(rng, 8, segs=(2, 2)))
    b = b._replace(driver_cand=None)
    with pytest.raises(ValueError, match="mixed None-ness"):
        TB.stack_app_batches([a, b])
