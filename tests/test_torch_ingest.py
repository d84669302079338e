"""The ingest lanes: the port's server/ingest.py against the JAX package's.

The pure-Python binary codec, the native codec's decodes and tickets, the
solver's candidate-mask memo on a native ticket, and the threaded
transport's `/predicates` answers on both lanes, JSON and binary, each
against the JAX package fed the same bytes (the port on `device="cpu"`).
Tolerance: none.
"""

from __future__ import annotations

import json
import struct

import numpy as np
import pytest

from spark_scheduler_tpu.server import ingest as jax_ingest
from spark_scheduler_tpu_torch.server import ingest as port_ingest
from tests.test_torch_native import check_native_lane, load_jax_native
from tests.test_torch_server import JAX, PORT, Served, k8s_node, k8s_spark_pod, same

INGESTS = (jax_ingest, port_ingest)


def _names(seed, n):
    rng = np.random.default_rng(seed)
    return [f"node-{int(i):05d}" for i in rng.choice(100_000, n, replace=False)]


# ---------------------------------------------------------- binary codec

BINARY_CASES = {
    "plain": (k8s_spark_pod("app", "driver", "drv"), _names(1, 100)),
    "unicode": (k8s_spark_pod("app", "driver", "drv"), ["zone-é/n", "n1"]),
    "empty-names": (k8s_spark_pod("app", "driver", "drv"), []),
    "pod-bytes": (json.dumps(k8s_spark_pod("a", "driver", "d")).encode(), ["n0"]),
}


@pytest.mark.parametrize("case", sorted(BINARY_CASES))
def test_binary_codec_matches_jax(case):
    pod, names = BINARY_CASES[case]
    bodies = [m.encode_predicate_binary(pod, names) for m in INGESTS]
    assert bodies[1] == bodies[0]
    (jpod, jnames), (ppod, pnames) = (
        m.decode_predicate_binary_py(bodies[0]) for m in INGESTS
    )
    assert pnames == jnames == list(names)
    assert (ppod.name, ppod.namespace, ppod.labels) == (jpod.name, jpod.namespace, jpod.labels)


MALFORMED = [
    b"",
    b"SPRD",
    b"XXXX\x01\x00\x00\x00\x00\x00\x00\x00\x00",
    b"SPRD\x02" + b"\x00" * 8,
    b"SPRD\x01\xff\xff\xff\xff" + b"\x00" * 8,
    b"SPRD\x01\x02\x00\x00\x00{}\x01\x00\x00\x00",
    b"SPRD\x01\x02\x00\x00\x00{}\x00\x00\x00\x00x",
]


@pytest.mark.parametrize("body", MALFORMED)
def test_binary_codec_rejects_malformed_like_jax(body):
    messages = []
    for m in INGESTS:
        with pytest.raises(m.BinaryPredicateError) as err:
            m.decode_predicate_binary_py(body)
        messages.append(str(err.value))
    assert messages[1] == messages[0]


def test_encoder_refuses_an_overlong_name():
    with pytest.raises(port_ingest.BinaryPredicateError, match="too long"):
        port_ingest.encode_predicate_binary({}, ["x" * 70_000])


@pytest.mark.parametrize(
    "ctype,want",
    [
        ("application/x-spark-predicate", True),
        ("Application/X-Spark-Predicate; charset=binary", True),
        ("application/json", False),
        (None, False),
        ("", False),
    ],
)
def test_binary_content_type_matches_jax(ctype, want):
    assert [m.is_binary_content_type(ctype) for m in INGESTS] == [want, want]


# ------------------------------------------------------- the native codec


@pytest.fixture
def codecs():
    load_jax_native()
    return [m.NativeIngestCodec() for m in INGESTS]


@pytest.mark.parametrize("binary", [False, True], ids=["json", "binary"])
def test_native_decode_matches_jax_and_python(codecs, binary):
    pod = k8s_spark_pod("app", "driver", "drv")
    names = _names(3, 500)
    body = (
        port_ingest.encode_predicate_binary(pod, names)
        if binary
        else json.dumps({"Pod": pod, "NodeNames": names}).encode()
    )
    (jpod, jnames), (ppod, pnames) = (
        c.decode_predicate_body(body, binary=binary) for c in codecs
    )
    assert isinstance(pnames, port_ingest.NativeNodeNames)
    assert pnames.names_digest == jnames.names_digest
    assert list(pnames) == list(jnames) == names
    assert ppod.name == jpod.name == "drv"
    stats = [c.stats() for c in codecs]
    keys = ("ingest", "degraded", "decode_hits", "decode_fallbacks", "binary_requests")
    assert [{k: s[k] for k in keys} for s in stats][1] == {k: stats[0][k] for k in keys}


def test_native_ticket_semantics(codecs):
    codec = codecs[1]
    body = json.dumps(
        {"Pod": {"metadata": {"name": "p"}}, "NodeNames": [f"n{i}" for i in range(100)]}
    ).encode()
    _, names1 = codec.decode_predicate_body(body, binary=False)
    _, names2 = codec.decode_predicate_body(body, binary=False)
    assert hash(names1) == hash(names2) and names1 == names2
    assert names1._list is None and names2._list is None
    assert len(names1) == 100
    assert names1[3] == "n3" and names1[-1] == "n99"
    assert "n42" in names1 and "nope" not in names1
    assert names1[:3] == ["n0", "n1", "n2"]
    assert names1 == [f"n{i}" for i in range(100)]
    _, other = codec.decode_predicate_body(body.replace(b'"n99"', b'"nXX"'), binary=False)
    assert names1 != other


def test_escaped_body_misses_and_is_counted(codecs):
    body = b'{"\\u0050od": {"metadata": {"name": "real"}}, "NodeNames": ["n1"]}'
    assert [c.decode_predicate_body(body, binary=False) for c in codecs] == [None, None]
    assert [c.stats()["decode_fallbacks"] for c in codecs] == [1, 1]


def test_warm_candidate_mask_on_a_ticket_iterates_no_name(codecs, monkeypatch):
    """The second `candidate_mask` call on an equal native ticket is a memo
    hit keyed on the digest: no name is decoded, iterated or looked up."""
    from spark_scheduler_tpu_torch.core.solver import PlacementSolver
    from spark_scheduler_tpu_torch.models.kube import Node
    from spark_scheduler_tpu_torch.models.resources import Resources

    solver = PlacementSolver(device="cpu")
    nodes = [
        Node(name=f"n{i}", allocatable=Resources.from_quantities("8", "8Gi", "0"))
        for i in range(16)
    ]
    tensors = solver.build_tensors(nodes, {}, {})
    body = json.dumps({"Pod": {}, "NodeNames": [f"n{i}" for i in range(0, 16, 2)]}).encode()
    codec = codecs[1]
    _, t1 = codec.decode_predicate_body(body, binary=False)
    _, t2 = codec.decode_predicate_body(body, binary=False)

    seen = {"iter": 0, "getitem": 0, "index_of": 0}
    cls = port_ingest.NativeNodeNames
    orig_iter, orig_getitem = cls.__iter__, cls.__getitem__

    def counting_iter(self):
        seen["iter"] += 1
        return orig_iter(self)

    def counting_getitem(self, i):
        seen["getitem"] += 1
        return orig_getitem(self, i)

    orig_index_of = solver.registry.index_of

    def counting_index_of(name):
        seen["index_of"] += 1
        return orig_index_of(name)

    monkeypatch.setattr(cls, "__iter__", counting_iter)
    monkeypatch.setattr(cls, "__getitem__", counting_getitem)
    monkeypatch.setattr(solver.registry, "index_of", counting_index_of)
    m1 = solver.candidate_mask(tensors, t1)
    assert seen["iter"] == 1 and seen["index_of"] == 8  # the cold miss
    cold = dict(seen)
    m2 = solver.candidate_mask(tensors, t2)
    assert m2 is m1
    assert seen == cold, "the warm hit touched a name"
    assert t2._list is None
    assert np.array_equal(
        m1, solver.candidate_mask(tensors, [f"n{i}" for i in range(0, 16, 2)])
    )


# -------------------------------------------- both lanes on the threaded server


@pytest.fixture(params=["python", "native"])
def threaded_pair(request):
    if request.param == "native":
        load_jax_native()
    sides = [
        Served(JAX, server_ingest=request.param),
        Served(PORT, server_ingest=request.param),
    ]
    if request.param == "native":
        for s in sides:
            check_native_lane(s)
    yield request.param, sides
    for s in sides:
        s.stop()


def _post(s, body, ctype):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", s.port, timeout=30)
    conn.request("POST", "/predicates", body=body, headers={"Content-Type": ctype})
    resp = conn.getresponse()
    out = (resp.status, resp.read())
    conn.close()
    return out


def test_binary_and_json_bodies_on_both_lanes_match_jax(threaded_pair):
    lane, sides = threaded_pair
    rng = np.random.default_rng(5)
    names = [f"n{i}" for i in range(16)]
    for s in sides:
        for i, n in enumerate(names):
            assert s.call("PUT", "/state/nodes", k8s_node(n, zone=f"zone{i % 3}"))[0] == 200
    answers = [[], []]
    for k in range(6):
        pod = k8s_spark_pod(
            f"app-{k}", "driver", f"app-{k}-driver",
            executors=int(rng.integers(1, 12)), created=f"2026-07-29T12:01:{k:02d}Z",
        )
        binary = k % 2 == 1
        body = (
            port_ingest.encode_predicate_binary(pod, names)
            if binary
            else json.dumps({"Pod": pod, "NodeNames": names}).encode()
        )
        ctype = port_ingest.BINARY_CONTENT_TYPE if binary else "application/json"
        for side, s in enumerate(sides):
            assert s.call("PUT", "/state/pods", pod)[0] == 200
            answers[side].append(_post(s, body, ctype))
    for (js, jb), (ps, pb) in zip(*answers):
        assert ps == js == 200
        assert same(pb, jb), (pb[:300], jb[:300])
    assert any(json.loads(b)["NodeNames"] for _, b in answers[1])
    stats = [s.server.ingest_stats() for s in sides]
    keys = ("ingest", "degraded", "decode_hits", "decode_fallbacks", "binary_requests")
    assert {k: stats[1].get(k) for k in keys} == {k: stats[0].get(k) for k in keys}
    assert stats[1]["ingest"] == lane
    if lane == "native":
        assert stats[1]["decode_hits"] == 6 and stats[1]["binary_requests"] == 3


def test_native_lane_binds_python_lane_does_not():
    """`ingest="native"` builds the codec; an unknown lane is refused."""
    from spark_scheduler_tpu_torch.server.app import build_scheduler_app
    from spark_scheduler_tpu_torch.server.http import SchedulerHTTPServer
    from spark_scheduler_tpu_torch.store.backend import InMemoryBackend

    app = build_scheduler_app(InMemoryBackend(), device="cpu")
    try:
        srv = SchedulerHTTPServer(app, port=0, ingest="native")
        assert isinstance(srv.ingest_codec, port_ingest.NativeIngestCodec)
        assert srv.ingest_stats()["ingest"] == "native"
        assert SchedulerHTTPServer(app, port=0).ingest_codec is None
        with pytest.raises(ValueError, match="unknown server ingest"):
            SchedulerHTTPServer(app, port=0, ingest="rust")
    finally:
        app.stop()


def test_install_config_parses_server_ingest_and_transport():
    from spark_scheduler_tpu_torch.server.config import InstallConfig

    cfg = InstallConfig.from_dict({"server": {"ingest": "native", "transport": "async"}})
    assert (cfg.server_ingest, cfg.server_transport) == ("native", "async")
    assert InstallConfig.from_dict({}).server_ingest == "python"


# ------------------------------------------------ response encoding parity


def test_encode_filter_result_on_a_ticket_matches_a_list(codecs):
    """The failure-map cache keyed on a ticket's digest encodes the bytes a
    plain list gives, on the first call and on the cached second."""
    from spark_scheduler_tpu_torch.core.extender import ExtenderFilterResult
    from spark_scheduler_tpu_torch.server.routing import encode_filter_result

    names = [f"node-{i}" for i in range(40)]
    _, ticket = codecs[1].decode_predicate_body(
        json.dumps({"Pod": {}, "NodeNames": names}).encode(), binary=False
    )
    result = ExtenderFilterResult(
        node_names=[], failed_nodes={n: "does not fit" for n in names},
        outcome="failure-fit",
    )
    want = encode_filter_result(result, names)
    assert encode_filter_result(result, ticket) == want
    assert encode_filter_result(result, ticket) == want


def test_canned_bodies_match_json_dumps():
    from spark_scheduler_tpu_torch.server import routing

    assert routing._NOT_FOUND_BODY == json.dumps({"error": "not found"}).encode()
    assert routing._LIVENESS_BODY == json.dumps({"status": "up"}).encode()
    assert routing._READY_BODY == json.dumps({"ready": True}).encode()
    assert routing._NOT_READY_BODY == json.dumps({"ready": False}).encode()
    assert routing._SHED_PRE + b"7}" == json.dumps(
        {"error": "scheduler overloaded", "queue_depth": 7}
    ).encode()


def test_binary_frame_layout():
    body = port_ingest.encode_predicate_binary(b"{}", ["ab", "c"])
    assert body == (
        b"SPRD\x01" + struct.pack("<I", 2) + b"{}" + struct.pack("<I", 2)
        + struct.pack("<H", 2) + b"ab" + struct.pack("<H", 1) + b"c"
    )
