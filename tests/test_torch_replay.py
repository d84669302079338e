"""Decision traces and their replay in the port (`trace.path`, replay/),
against the JAX package.

The same inputs, made from a seed, go through both packages; every port
call passes `device="cpu"`. Pinned:

  * the generators write the JAX package's bytes for each kind and seed;
  * a generated trace run with re-capture (`run`) in each package gives
    byte-equal captured traces, and a live session captured through
    `trace.path` gives byte-equal trace files, header and config hash
    included;
  * the port strictly replays a JAX-captured trace with 0 mismatches and
    the JAX package strictly replays the port's, a JAX `Soak` session
    included (the mix of tests/test_replay.py::test_soak_trace_replays_
    bit_identically);
  * the codec, the reader's torn-tail and mid-file handling, the config
    fingerprint and the what-if diff, as tests/test_replay.py pins them;
  * in the port alone, a pod event racing a traced serving call waits
    for the call's journal entry (the trace writer's order lock).

Tolerance: none (bytes and decisions).
"""

from __future__ import annotations

import dataclasses
import importlib
import json

import numpy as np
import pytest

from tests.test_torch_extender import JAX, PORT
from tests.test_torch_native import load_jax_native


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    # The JAX apps load the JAX package's native runtime; load it the way
    # every parity module does.
    load_jax_native()


def _mod(root, name):
    return importlib.import_module(f"{root}.{name}")


def _dev(root) -> dict:
    return {"device": "cpu"} if root == PORT else {}


def _read(path) -> str:
    with open(path, encoding="utf-8") as fh:
        return fh.read()


GEN_SIZING = {
    "diurnal": dict(n_nodes=12, apps=10),
    "bursty": dict(n_nodes=12, bursts=3),
    "churn": dict(n_nodes=12, steps=40),
}


def _generate(root, kind, path, seed):
    return _mod(root, "replay").generate(kind, str(path), seed=seed,
                                         **GEN_SIZING[kind])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per generator kind: the generated trace and each package's
    re-captured run of it."""
    d = tmp_path_factory.mktemp("torch_replay")
    out = {}
    for kind in sorted(GEN_SIZING):
        gen = d / f"{kind}.jsonl"
        _generate(JAX, kind, gen, seed=3)
        caps = {}
        for root in (JAX, PORT):
            cap = d / f"{kind}-{root}.jsonl"
            rep = _mod(root, "replay").replay_trace(
                str(gen), record_path=str(cap), **_dev(root)
            )
            assert rep.decisions > 0
            caps[root] = str(cap)
        out[kind] = (str(gen), caps)
    return out


# ------------------------------------------------------------- generators


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("kind", sorted(GEN_SIZING))
def test_generated_trace_equals_jax_bytes(tmp_path, kind, seed):
    a, b = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    sa = _generate(JAX, kind, a, seed)
    sb = _generate(PORT, kind, b, seed)
    assert _read(a) == _read(b)
    assert {k: v for k, v in sa.items() if k != "path"} == {
        k: v for k, v in sb.items() if k != "path"
    }


def test_generator_seed_determinism(tmp_path):
    for kind in sorted(GEN_SIZING):
        a, b, c = (tmp_path / f"{kind}-{i}.jsonl" for i in "abc")
        _generate(PORT, kind, a, 7)
        _generate(PORT, kind, b, 7)
        _generate(PORT, kind, c, 8)
        assert _read(a) == _read(b), kind
        assert _read(a) != _read(c), kind


def test_unknown_generator_is_an_error(tmp_path):
    with pytest.raises(ValueError, match="unknown generator"):
        _mod(PORT, "replay").generate("nope", str(tmp_path / "x.jsonl"), seed=0)


# ------------------------------------------------------------------ codec


@pytest.mark.parametrize("kind", sorted(GEN_SIZING))
def test_recaptured_run_equals_jax_bytes(runs, kind):
    _, caps = runs[kind]
    assert _read(caps[PORT]) == _read(caps[JAX])


def test_roundtrip_byte_identity(runs):
    trace = _mod(PORT, "replay.trace")
    for kind in sorted(runs):
        gen, caps = runs[kind]
        for path in (gen, caps[PORT]):
            reader = trace.TraceReader(path)
            raw = reader.raw_lines()
            assert raw, path
            assert [trace.dumps_event(json.loads(x)) for x in raw] == raw
            assert reader.header["v"] == 1


def test_torn_tail_tolerated_and_midfile_corruption_counted(runs, tmp_path):
    reader_cls = _mod(PORT, "replay.trace").TraceReader
    gen, _ = runs["churn"]
    lines = _read(gen).splitlines()

    torn = tmp_path / "torn.jsonl"
    torn.write_text("\n".join(lines) + '\n{"k":"pod","op":"ad')
    r = reader_cls(str(torn))
    events = list(r.events())
    assert r.torn_tail and r.malformed == 0
    assert len(events) == len(lines) - 1

    corrupt = list(lines)
    corrupt[len(corrupt) // 2] = "#### not json ####"
    bad = tmp_path / "corrupt.jsonl"
    bad.write_text("\n".join(corrupt) + "\n")
    r = reader_cls(str(bad))
    events = list(r.events())
    assert r.malformed == 1 and not r.torn_tail
    assert len(events) == len(lines) - 2
    # The port's replay of the corrupt trace counts what the JAX one does.
    reps = [
        _mod(root, "replay").replay_trace(str(bad), **_dev(root))
        for root in (JAX, PORT)
    ]
    assert reps[0].malformed == reps[1].malformed == 1
    assert reps[0].placements == reps[1].placements

    headless = tmp_path / "headless.jsonl"
    headless.write_text("\n".join(lines[1:]) + "\n")
    with pytest.raises(ValueError):
        reader_cls(str(headless))


def test_config_fingerprint_roundtrip_and_hash_equal_jax():
    fps = {}
    for root in (JAX, PORT):
        trace = _mod(root, "replay.trace")
        cfg = _mod(root, "server.config").InstallConfig(
            fifo=True, binpack_algo="distribute-evenly", sync_writes=True,
            solver_prune_top_k=4,
        )
        fp = trace.config_fingerprint(cfg)
        rebuilt = trace.config_from_fingerprint(fp)
        assert dataclasses.asdict(rebuilt) == fp
        over = trace.config_from_fingerprint(
            fp, overrides={"binpack-algo": "tightly-pack"}
        )
        assert over.binpack_algo == "tightly-pack"
        with pytest.raises(KeyError):
            trace.config_from_fingerprint(fp, overrides={"no-such-field": 1})
        fp2 = dict(fp, field_from_the_future=42)
        assert (
            trace.config_from_fingerprint(fp2).binpack_algo
            == "distribute-evenly"
        )
        fps[root] = fp
    assert fps[JAX] == fps[PORT]
    assert (
        _mod(JAX, "replay.trace").config_hash(fps[JAX])
        == _mod(PORT, "replay.trace").config_hash(fps[PORT])
    )


# ------------------------------------------------------------------ replay


@pytest.mark.parametrize("kind", sorted(GEN_SIZING))
def test_port_strictly_replays_the_jax_capture(runs, kind):
    _, caps = runs[kind]
    rep = _mod(PORT, "replay").replay_trace(
        caps[JAX], strict=True, device="cpu"
    )
    assert rep.mismatches == [] and rep.compared == rep.decisions > 0
    assert rep.uncompared_windows == 0 and rep.overcommit == 0


@pytest.mark.parametrize("kind", sorted(GEN_SIZING))
def test_jax_strictly_replays_the_port_capture(runs, kind):
    _, caps = runs[kind]
    rep = _mod(JAX, "replay").replay_trace(caps[PORT], strict=True)
    assert rep.mismatches == [] and rep.compared == rep.decisions > 0
    assert rep.uncompared_windows == 0


def test_generated_trace_closes_the_loop_on_the_port(runs):
    _, caps = runs["churn"]
    jax_rep = _mod(JAX, "replay").replay_trace(caps[PORT])
    rep = _mod(PORT, "replay").replay_trace(caps[PORT], strict=True,
                                            device="cpu")
    assert rep.mismatches == [] and rep.compared == rep.decisions > 0
    assert rep.decision_summary() == jax_rep.decision_summary()
    assert rep.placements == jax_rep.placements


def test_soak_trace_replays_strictly_on_the_port(tmp_path):
    """A recorded JAX invariant-soak session (churn, teardowns, reconciles,
    retries, pipelined windows) replays decision for decision on the port.
    No recorded decision of this session is one of the JAX over-commits
    the port repairs (ROADMAP §C.4-§C.6), so no mismatch is allowed."""
    from spark_scheduler_tpu.testing.soak import Soak

    path = str(tmp_path / "soak.jsonl")
    soak = Soak(
        np.random.default_rng(5), "single-az-tightly-pack", trace_path=path
    )
    soak.run(150)
    soak.h.app.stop()
    rep = _mod(PORT, "replay").replay_trace(path, strict=True, device="cpu")
    assert rep.mismatches == []
    assert rep.compared == rep.decisions >= 50
    assert rep.uncompared_windows == 0
    assert rep.verdict_counts.get("success", 0) > 0
    assert not rep.torn_tail and rep.malformed == 0


# ------------------------------------------------------- live capture


def _session(root, path):
    """One traced session on a Harness: nodes, solo predicates with binds,
    a pipelined window with a node update between dispatch and complete,
    an executor deletion, a reconcile directive; pods carry explicit uids
    and timestamps so both packages journal the same objects."""
    hm = _mod(root, "testing.harness")
    ext_mod = _mod(root, "core.extender")
    h = hm.Harness(
        binpack_algo="tightly-pack", clock=lambda: 1_700_000_000.0,
        trace_path=str(path), **_dev(root),
    )
    nodes = [hm.new_node(f"n{i}", zone=f"zone{i % 2}") for i in range(6)]
    h.add_nodes(*nodes)
    names = [n.name for n in nodes]

    def pods(app, n, ts):
        return [
            dataclasses.replace(p, uid=f"uid-{p.name}", creation_timestamp=ts)
            for p in hm.static_allocation_spark_pods(app, n)
        ]

    out = []
    a = pods("app-a", 3, 10.0)
    out += [r.node_names for r in h.schedule_app(a, names)]
    drivers = [pods(f"app-w{i}", 2, 20.0 + i)[0] for i in range(3)]
    h.add_pods(*drivers)
    t = h.extender.predicate_window_dispatch(
        [ext_mod.ExtenderArgs(pod=p, node_names=names) for p in drivers]
    )
    h.backend.update("nodes", dataclasses.replace(nodes[5], labels={
        **nodes[5].labels, "extra": "x"}))
    out += [r.node_names for r in h.extender.predicate_window_complete(t)]
    h.delete_pod(a[1])
    h.app.trace_writer.emit_reconcile()
    h.app.reconciler.sync_resource_reservations_and_demands()
    big = pods("app-big", 40, 30.0)
    out += [r.outcome for r in h.schedule_app(big[:1], names)]
    h.app.stop()
    return out


def test_live_capture_equals_jax_bytes_and_cross_replays(tmp_path):
    got = {}
    for root in (JAX, PORT):
        path = tmp_path / f"{root}.jsonl"
        got[root] = (_session(root, path), _read(path))
    assert got[PORT][0] == got[JAX][0]
    assert got[PORT][1] == got[JAX][1]
    header = json.loads(got[PORT][1].splitlines()[0])
    assert header["config"]["trace_path"] is None
    assert header["hash"] == _mod(JAX, "replay.trace").config_hash(
        header["config"]
    )
    path = str(tmp_path / f"{PORT}.jsonl")
    rep = _mod(PORT, "replay").replay_trace(path, strict=True, device="cpu")
    assert rep.compared == rep.decisions > 0 and rep.mismatches == []
    rep = _mod(JAX, "replay").replay_trace(
        str(tmp_path / f"{JAX}.jsonl"), strict=True
    )
    assert rep.compared == rep.decisions > 0


@pytest.mark.parametrize("mode", ["window", "solo"])
def test_event_racing_a_serving_call_lands_on_one_side_of_it(tmp_path, mode):
    """A pod add racing a traced serving call waits for the call's journal
    entry, so the trace orders it as the call observed it and the strict
    replay agrees. The racing add is an earlier driver whose gang leaves
    no room for the served one: replayed on the wrong side of the call,
    the served driver would be denied. It starts after the call's state
    reads (a window journals after its dispatch) or before them (a solo
    call journals first)."""
    import threading

    hm = _mod(PORT, "testing.harness")
    ext_mod = _mod(PORT, "core.extender")
    path = tmp_path / f"race-{mode}.jsonl"
    h = hm.Harness(
        binpack_algo="tightly-pack", clock=lambda: 1_700_000_000.0,
        trace_path=str(path), device="cpu",
    )
    nodes = [hm.new_node(f"n{i}") for i in range(2)]
    h.add_nodes(*nodes)
    names = [n.name for n in nodes]

    def driver(app, n, ts):
        pod = hm.static_allocation_spark_pods(app, n)[0]
        return dataclasses.replace(pod, uid=f"uid-{pod.name}",
                                   creation_timestamp=ts)

    earlier, served = driver("app-a", 9, 10.0), driver("app-b", 6, 20.0)
    h.add_pods(served)
    racer = threading.Thread(target=h.backend.add_pod, args=(earlier,))
    blocked = []

    def race(fn):
        def hooked(*a, **kw):
            if not blocked:
                racer.start()
                racer.join(0.5)
                blocked.append(racer.is_alive())
            return fn(*a, **kw)
        return hooked

    args = ext_mod.ExtenderArgs(pod=served, node_names=names)
    if mode == "window":
        solver = h.app.solver
        solver.pack_window_dispatch = race(solver.pack_window_dispatch)
        t = h.extender.predicate_window_dispatch([args])
        racer.join()
        res = h.extender.predicate_window_complete(t)[0]
    else:
        h.extender._reconcile_if_needed = race(h.extender._reconcile_if_needed)
        res = h.extender.predicate(args)
        racer.join()
    h.app.stop()
    assert blocked == [True]
    assert res.node_names
    rep = _mod(PORT, "replay").replay_trace(str(path), strict=True,
                                            device="cpu")
    assert rep.compared == rep.decisions == 1 and rep.mismatches == []


def test_trace_path_without_recorder_warns_and_writes_nothing(tmp_path):
    hm = _mod(PORT, "testing.harness")
    path = tmp_path / "off.jsonl"
    with pytest.warns(RuntimeWarning, match="flight recorder"):
        h = hm.Harness(trace_path=str(path), flight_recorder=False,
                       device="cpu")
    assert h.app.trace_writer is None and not path.exists()
    h.app.stop()


# ------------------------------------------------------------------ what-if


def test_what_if_diff_equals_jax(runs):
    _, caps = runs["churn"]
    diffs = {}
    for root in (JAX, PORT):
        diff = _mod(root, "replay").what_if(
            caps[JAX], {"binpack-algo": "distribute-evenly"}, **_dev(root)
        )
        assert diff["base_mismatches"] == 0
        p = diff["placements"]
        assert p["same"] + p["changed"] > 0 and p["changed"] > 0
        assert diff["decisions"]["base"] == diff["decisions"]["variant"]
        for arm in ("base", "variant"):
            assert diff["latency_ms"][arm]["p50"] is not None
            assert diff["fragmentation"][arm]["cpu"] is not None
        assert isinstance(diff["denials"]["delta"], int)
        diff.pop("latency_ms")
        diffs[root] = diff
    assert diffs[PORT] == diffs[JAX]


def test_cli_verify_info_and_generate_on_the_cpu(runs, tmp_path, capsys):
    main = _mod(PORT, "replay.__main__").main
    _, caps = runs["bursty"]
    assert main(["info", caps[JAX]]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["events"]["result"] > 0 and info["malformed"] == 0
    assert main(["verify", caps[JAX], "--strict", "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out)["mismatches"] == 0
    out = tmp_path / "gen.jsonl"
    assert main(["generate", "churn", str(out), "--seed", "2",
                 "--nodes", "8"]) == 0
    capsys.readouterr()
    jax_out = tmp_path / "gen-jax.jsonl"
    _mod(JAX, "replay.__main__").main(
        ["generate", "churn", str(jax_out), "--seed", "2", "--nodes", "8"]
    )
    assert _read(out) == _read(jax_out)
