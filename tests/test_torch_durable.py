"""The durable store: the port's store/durable.py against the JAX package's.

The cases of tests/test_durable_store.py run once per package, each on its
own `tmp_path` WAL, with the same objects (sizes drawn with numpy from a
seed). The replayed objects and the log's bytes must be equal across the
packages, since the port keeps the JAX package's record format. The
cross-replay tests open a WAL that one package wrote in the other, plain
and compacted, which is an operator's migration path between the two
packages. The writer killed mid-record is a real subprocess of each
package, killed with SIGKILL. The port's apps run on `device="cpu"`.

Tolerance: none.
"""

from __future__ import annotations

import os
import shutil
import signal
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

from tests.test_torch_extender import canon
from tests.test_torch_kube import (
    JAX,
    PORT,
    ROOTS,
    backend_state,
    pkg as kube_pkg,
)

REPO = Path(__file__).resolve().parent.parent


def pkg(root):
    import importlib

    m = kube_pkg(root)
    for attr, name in (
        ("durable", "store.durable"),
        ("crds", "models.crds"),
        ("demands", "models.demands"),
        ("reservations", "models.reservations"),
        ("resources", "models.resources"),
        ("kube", "models.kube"),
    ):
        setattr(m, attr, importlib.import_module(f"{root}.{name}"))
    return m


def both(scenario, tmp_path, *args):
    """Run `scenario(m, directory, *args)` per package in its own directory
    of `tmp_path`; the two results must be equal."""
    out = []
    for root in ROOTS:
        d = tmp_path / root
        d.mkdir()
        out.append(scenario(pkg(root), d, *args))
    assert out[1] == out[0]
    return out[1]


def durable_state(backend):
    state = backend_state(backend)
    state["crds"] = sorted(backend._crds)
    state["crd_definitions"] = canon(backend._crd_definitions)
    return state


def log_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def sample_rr(m, rng, name="app-1"):
    R = m.reservations
    res = m.resources.Resources

    def q():
        return res.from_quantities(
            str(int(rng.integers(1, 5))), f"{int(rng.integers(1, 9))}Gi",
            str(int(rng.integers(0, 2))),
        )

    return R.ResourceReservation(
        name=name,
        namespace="ns",
        labels={"a": "b"},
        owner_pod_uid=f"uid-{name}-driver",
        spec=R.ReservationSpec(
            {
                "driver": R.Reservation("n0", q()),
                "executor-1": R.Reservation("n1", q()),
                "executor-2": R.Reservation("n2", q()),
            }
        ),
        status=R.ReservationStatus({"driver": f"{name}-driver"}),
    )


def sample_demand(m, rng, name="demand-app-2-driver"):
    D = m.demands
    return D.Demand(
        name=name,
        namespace="ns",
        spec=D.DemandSpec(
            units=[
                D.DemandUnit(
                    resources=m.resources.Resources.from_quantities(
                        str(int(rng.integers(1, 5))), f"{int(rng.integers(1, 9))}Gi"
                    ),
                    count=int(rng.integers(1, 6)),
                    pod_names_by_namespace={"ns": ["app-2-driver"]},
                )
            ],
            instance_group="ig1",
            is_long_lived=False,
        ),
        status=D.DemandStatus(phase="pending"),
    )


def populate(m, backend, seed):
    """Nodes, pods, a reservation, a demand, a bind, an update and a
    delete: every record kind and verb."""
    rng = np.random.default_rng(seed)
    h = m.harness
    for i in range(4):
        backend.add_node(h.new_node(f"n{i}", zone=f"zone{i % 2 + 1}"))
    pods = h.static_allocation_spark_pods("app-rt", 2)
    for p in pods:
        backend.add_pod(p)
    backend.create("resourcereservations", sample_rr(m, rng))
    backend.register_crd(m.backend.DEMAND_CRD)
    backend.create("demands", sample_demand(m, rng))
    backend.bind_pod(pods[0], "n0")
    rr = backend.get("resourcereservations", "ns", "app-1")
    rr.status.pods["executor-1"] = pods[1].name
    backend.update("resourcereservations", rr)
    backend.delete("nodes", "", "n3")
    return pods


# --------------------------------------------- tests/test_durable_store.py


def sc_round_trip(m, d, seed):
    path = str(d / "state.jsonl")
    backend = m.durable.DurableBackend(path, compact_on_load=False)
    populate(m, backend, seed)
    written = durable_state(backend)
    backend.close()
    raw = log_bytes(path)
    again = m.durable.DurableBackend(path)
    replayed = durable_state(again)
    again.close()
    return raw, written == replayed, replayed, log_bytes(path)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_object_round_trip_matches_jax(tmp_path, seed):
    raw, equal, state, compacted = both(sc_round_trip, tmp_path, seed)
    assert raw.count(b"\n") > compacted.count(b"\n")
    assert state["pods"][0][1]["node_name"] == "n0"
    assert len(state["nodes"]) == 3 and state["demands"]
    assert state["resourcereservations"][0][1]["owner_pod_uid"] == "uid-app-1-driver"
    # Replay renumbers resource versions; everything else survives.
    assert not equal


def sc_delete_survives(m, d):
    path = str(d / "state.jsonl")
    backend = m.durable.DurableBackend(path)
    backend.add_node(m.harness.new_node("n0"))
    backend.add_node(m.harness.new_node("n1"))
    backend.delete("nodes", "", "n0")
    backend.close()
    again = m.durable.DurableBackend(path)
    out = durable_state(again), log_bytes(path)
    again.close()
    return out


def test_delete_survives_matches_jax(tmp_path):
    state, _ = both(sc_delete_survives, tmp_path)
    assert [n[1]["name"] for n in state["nodes"]] == ["n1"]


def sc_compaction(m, d, updates):
    path = str(d / "state.jsonl")
    backend = m.durable.DurableBackend(path)
    node = backend.add_node(m.harness.new_node("n0"))
    for _ in range(updates):
        backend.update("nodes", node)
    before = log_bytes(path)
    backend.compact()
    after = log_bytes(path)
    again = m.durable.DurableBackend(path)
    state = durable_state(again)
    again.close()
    backend.close()
    return before.count(b"\n"), after, state


@pytest.mark.parametrize("updates", [5, 50])
def test_compaction_bounds_log_matches_jax(tmp_path, updates):
    before, after, state = both(sc_compaction, tmp_path, updates)
    assert before > updates and after.count(b"\n") <= 3
    assert len(state["nodes"]) == 1


TORN = '{"verb": "create", "kind": "nodes", "na'


def sc_torn_tail(m, d):
    path = str(d / "state.jsonl")
    backend = m.durable.DurableBackend(path, compact_on_load=False)
    backend.add_node(m.harness.new_node("n0"))
    backend.close()
    good = os.path.getsize(path)
    with open(path, "a") as f:
        f.write(TORN)
    with pytest.warns(RuntimeWarning, match="torn trailing record"):
        again = m.durable.DurableBackend(path, compact_on_load=False)
    repaired = os.path.getsize(path) == good
    again.add_node(m.harness.new_node("n1"))
    again.close()
    third = m.durable.DurableBackend(path, compact_on_load=False)
    out = repaired, durable_state(third), log_bytes(path)
    third.close()
    return out


def test_torn_tail_write_truncated_with_warning_matches_jax(tmp_path):
    repaired, state, _ = both(sc_torn_tail, tmp_path)
    assert repaired and len(state["nodes"]) == 2


def sc_promotion_torn(m, d):
    path = str(d / "state.jsonl")
    leader = m.durable.DurableBackend(path, compact_on_load=False)
    leader.add_node(m.harness.new_node("n0"))
    follower = m.durable.DurableBackend(path, follow=True)
    leader.close()
    with open(path, "a") as f:
        f.write(TORN)
    with pytest.warns(RuntimeWarning, match="torn mid-append tail"):
        follower.promote_to_writer()
    follower.add_node(m.harness.new_node("n1"))
    follower.close()
    replayed = m.durable.DurableBackend(path, compact_on_load=False)
    out = durable_state(replayed), log_bytes(path)
    replayed.close()
    return out


def test_promotion_truncates_dead_writers_torn_tail_matches_jax(tmp_path):
    state, _ = both(sc_promotion_torn, tmp_path)
    assert len(state["nodes"]) == 2


def sc_promotion_unterminated(m, d):
    path = str(d / "state.jsonl")
    leader = m.durable.DurableBackend(path, compact_on_load=False)
    leader.add_node(m.harness.new_node("n0"))
    follower = m.durable.DurableBackend(path, follow=True)
    leader.close()
    with open(path) as f:
        template = f.readline().rstrip("\n")
    with open(path, "a") as f:
        f.write(template.replace('"n0"', '"n1"'))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        follower.promote_to_writer()
    follower.add_node(m.harness.new_node("n2"))
    follower.close()
    replayed = m.durable.DurableBackend(path, compact_on_load=False)
    out = durable_state(replayed), log_bytes(path)
    replayed.close()
    return out


def test_promotion_keeps_complete_unterminated_tail_matches_jax(tmp_path):
    state, _ = both(sc_promotion_unterminated, tmp_path)
    assert [n[1]["name"] for n in state["nodes"]] == ["n0", "n1", "n2"]


def sc_follower_boot(m, d):
    path = str(d / "state.jsonl")
    leader = m.durable.DurableBackend(path, compact_on_load=False)
    leader.add_node(m.harness.new_node("n0"))
    with open(path, "a") as f:
        f.write(TORN)
    size = os.path.getsize(path)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        follower = m.durable.DurableBackend(path, follow=True)
    out = durable_state(follower), os.path.getsize(path) == size
    leader.close()
    return out


def test_follower_boot_silent_on_in_progress_append_matches_jax(tmp_path):
    state, untouched = both(sc_follower_boot, tmp_path)
    assert untouched and len(state["nodes"]) == 1


def sc_follower_polls(m, d, seed):
    """A follower tails the writer's appends with events, and a promoted
    follower becomes the writer."""
    path = str(d / "state.jsonl")
    writer = m.durable.DurableBackend(path, compact_on_load=False)
    follower = m.durable.DurableBackend(path, follow=True)
    seen = []
    follower.subscribe("nodes", on_add=lambda n: seen.append(("add", n.name)),
                       on_delete=lambda n: seen.append(("delete", n.name)))
    populate(m, writer, seed)
    applied = follower.poll_log()
    mirrored = durable_state(follower) == durable_state(writer)
    writer.close()
    follower.promote_to_writer()
    follower.add_node(m.harness.new_node("n9"))
    follower.close()
    replayed = m.durable.DurableBackend(path, compact_on_load=False)
    out = applied, seen, mirrored, durable_state(replayed), log_bytes(path)
    replayed.close()
    return out


@pytest.mark.parametrize("seed", [3, 4])
def test_follower_poll_and_promotion_match_jax(tmp_path, seed):
    applied, seen, _, state, _ = both(sc_follower_polls, tmp_path, seed)
    assert applied > 0 and ("delete", "n3") in seen
    assert "n9" in {n[1]["name"] for n in state["nodes"]}


_KILLED_CHILD = """
import json, sys
from {root}.store.durable import DurableBackend
from {root}.testing.harness import new_node
b = DurableBackend({path!r}, compact_on_load=False)
b.add_node(new_node("k0"))
b.add_node(new_node("k1"))
# Crash mid-append: half a record, flushed, no newline.
b._file.write(json.dumps({{"verb": "create", "kind": "nodes"}})[:21])
b._file.flush()
print("TORN", flush=True)
import time; time.sleep(60)
"""


def sc_writer_killed(m, d):
    path = str(d / "killed.jsonl")
    child = subprocess.Popen(
        [sys.executable, "-c", _KILLED_CHILD.format(root=m.root, path=path)],
        stdout=subprocess.PIPE,
        cwd=REPO,
        env={**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(REPO)},
    )
    try:
        assert child.stdout.readline().strip() == b"TORN"
        child.send_signal(signal.SIGKILL)
        child.wait(timeout=30)
    finally:
        if child.poll() is None:
            child.kill()
        child.stdout.close()
    with pytest.warns(RuntimeWarning, match="torn trailing record"):
        backend = m.durable.DurableBackend(path, compact_on_load=False)
    out = [n.name for n in backend.list_nodes()], log_bytes(path)
    backend.close()
    return out


def test_writer_killed_mid_record_matches_jax(tmp_path):
    names, raw = both(sc_writer_killed, tmp_path)
    assert sorted(names) == ["k0", "k1"] and raw.endswith(b"}\n")


def sc_restart_recovery(m, d, executors):
    """Kill the scheduler after gang admission; a new process over the same
    log restores reservations, reconciles and keeps scheduling."""
    path = str(d / "state.jsonl")
    backend = m.durable.DurableBackend(path)
    h = m.harness.Harness(backend=backend, clock=lambda: 1e6, **m.cpu)
    names = [f"n{i}" for i in range(4)]
    h.add_nodes(*(m.harness.new_node(n) for n in names))
    pods = m.harness.static_allocation_spark_pods("app-surv", executors)
    results = [canon(h.schedule(pods[0], names)), canon(h.schedule(pods[1], names))]
    h.app.stop()
    backend.close()
    backend2 = m.durable.DurableBackend(path)
    h2 = m.harness.Harness(backend=backend2, clock=lambda: 1e6, **m.cpu)
    summary = h2.app.reconciler.sync_resource_reservations_and_demands()
    for p in pods[2:]:
        results.append(canon(h2.schedule(p, names)))
    out = results, canon(summary), durable_state(backend2)
    h2.app.stop()
    backend2.close()
    return out + (log_bytes(path),)


@pytest.mark.parametrize("executors", [2, 4])
def test_reservations_survive_restart_matches_jax(tmp_path, executors):
    results, _, state, _ = both(sc_restart_recovery, tmp_path, executors)
    (rr,) = state["resourcereservations"]
    reserved = {
        r[1]["node"] for slot, r in rr[1]["spec"][1]["reservations"].items()
        if slot != "driver"
    }
    for res in results[2:]:
        assert res[1][0] and res[1][0][0] in reserved


def test_port_apiserver_enforces_crd_schema_like_jax():
    out = []
    for root in ROOTS:
        m = pkg(root)
        api = m.apiserver.FakeKubeAPIServer()
        api.start()
        api.register_crd(m.crds.resource_reservation_crd())
        bad = {"apiVersion": "sparkscheduler.palantir.com/v1beta2",
               "kind": "ResourceReservation",
               "metadata": {"name": "x", "namespace": "ns"},
               "spec": {"reservations": {"driver": {"node": 5}}}}
        with pytest.raises(m.apiserver.ValidationError) as err:
            api.create("resourcereservations", bad)
        api.stop()
        out.append(str(err.value))
    assert out[1] == out[0]


# ------------------------------------------------------------ cross-replay


def write_wal(m, path, seed, compacted):
    backend = m.durable.DurableBackend(path, compact_on_load=False)
    populate(m, backend, seed)
    if compacted:
        backend.compact()
    backend.close()


def replay(m, path):
    backend = m.durable.DurableBackend(path, compact_on_load=False)
    out = durable_state(backend)
    backend.close()
    return out


@pytest.mark.parametrize("compacted", [False, True], ids=["log", "compacted"])
@pytest.mark.parametrize("writer", ROOTS)
def test_wal_written_by_one_package_replays_in_the_other(tmp_path, writer, compacted):
    """A WAL written by either package opens in the other to equal objects;
    the log's bytes are the same whichever package wrote it."""
    written = {}
    for root in ROOTS:
        path = str(tmp_path / f"{root}.jsonl")
        write_wal(pkg(root), path, 5, compacted)
        written[root] = log_bytes(path)
    assert written[PORT] == written[JAX]
    path = str(tmp_path / f"{writer}.jsonl")
    states = {reader: replay(pkg(reader), path) for reader in ROOTS}
    assert states[PORT] == states[JAX]
    assert states[PORT]["resourcereservations"] and states[PORT]["demands"]


def test_compacted_on_load_by_the_other_package(tmp_path):
    """The default open compacts: a JAX WAL opened by the port is rewritten
    to the bytes the JAX package's own compaction writes, and the reverse."""
    out = {}
    for writer, reader in ((JAX, PORT), (PORT, JAX), (JAX, JAX)):
        path = str(tmp_path / f"{writer}-{reader}.jsonl")
        write_wal(pkg(writer), path, 6, compacted=False)
        backend = pkg(reader).durable.DurableBackend(path)
        out[(writer, reader)] = (durable_state(backend), log_bytes(path))
        backend.close()
    assert out[(JAX, PORT)] == out[(JAX, JAX)]
    assert out[(PORT, JAX)] == out[(JAX, JAX)]


def test_restarted_app_on_a_copied_jax_wal_matches_jax(tmp_path):
    """A scheduler of either package restarted on a copy of one WAL (the
    JAX package's) reconciles to the same summary and serves the remaining
    executors onto the same nodes."""
    m = pkg(JAX)
    path = str(tmp_path / "jax.jsonl")
    backend = m.durable.DurableBackend(path)
    h = m.harness.Harness(backend=backend, clock=lambda: 1e6)
    names = [f"n{i}" for i in range(4)]
    h.add_nodes(*(m.harness.new_node(n) for n in names))
    pods = m.harness.static_allocation_spark_pods("app-x", 3)
    for p in pods[:2]:
        assert h.schedule(p, names).ok
    h.app.stop()
    backend.close()
    out = []
    for root in ROOTS:
        r = pkg(root)
        copy_path = str(tmp_path / f"copy-{root}.jsonl")
        shutil.copy(path, copy_path)
        b = r.durable.DurableBackend(copy_path)
        h2 = r.harness.Harness(backend=b, clock=lambda: 1e6, **r.cpu)
        summary = h2.app.reconciler.sync_resource_reservations_and_demands()
        # The same fixtures again, from the package's own harness: the
        # counter restarts (pkg) and runs through the nodes first.
        for n in names:
            r.harness.new_node(n)
        again = r.harness.static_allocation_spark_pods("app-x", 3)
        rest = [canon(h2.schedule(p, names)) for p in again[2:]]
        out.append((canon(summary), rest, durable_state(b)))
        h2.app.stop()
        b.close()
    assert out[1] == out[0]
