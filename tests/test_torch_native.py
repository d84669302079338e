"""The port's native runtime bindings against the JAX package's.

Both packages build the same C++ runtime (each from its own copy of
runtime.cpp) and bind it with ctypes. The same seeded inputs go through
each: predicate bodies decoded into a `PredicateSlot` (pod span, names
blob, offsets, digest, and which bodies miss the fast path), byte streams
framed by an `IngestConn` (every event field, fed whole and byte by byte),
`ClusterArena` snapshots, and `NativeShardedQueue` pop order. Tolerance:
none. The arena's live predicate slots return to their baseline after
every test, and a build whose compiler is missing raises instead of
degrading.
"""

from __future__ import annotations

import ctypes
import fcntl
import gc
import hashlib
import json
import os
import shutil
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from spark_scheduler_tpu import native as jax_native
from spark_scheduler_tpu_torch import native as port_native

REPO = Path(__file__).resolve().parent.parent
SIDES = (jax_native, port_native)


def load_jax_native():
    """The JAX package's runtime, built from its own source into a file no
    other process writes, and loaded from there.

    The JAX package compiles straight to its final path
    (`native/build/libsched_runtime.so`) and loads whatever file it finds
    there; its own native test modules call `native.available()` at
    collection, so every test worker builds that path at once on a fresh
    tree. The linker unlinks the old file and writes a new one, so a worker
    that loads it meanwhile gets a partial library: "file too short", a
    failed build that the package then never retries, or a library that
    loads and frames requests wrongly. Here the build is serialized across
    workers by a lock, compiled with the JAX package's own command to a
    temporary name and renamed atomically to a name keyed by the source's
    digest; then the JAX package's loader is pointed at that finished file,
    whatever it loaded (or failed to load) before. The finished file also
    fills the shared path when that is missing."""
    lock = Path(os.environ.get("TMPDIR", "/tmp")) / "spark-scheduler-jax-native.lock"
    with open(lock, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            src = Path(jax_native._SRC)
            digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
            shared = Path(jax_native._SO).parent
            built = shared / f"libsched_runtime-{digest}.so"
            if jax_native._SO != str(built) or jax_native._lib is None:
                if not built.exists():
                    shared.mkdir(parents=True, exist_ok=True)
                    tmp = built.with_name(f"{built.name}.{os.getpid()}.tmp")
                    subprocess.run(
                        [os.environ.get("CXX", "g++"), "-O2", "-std=c++17",
                         "-fPIC", "-shared", "-o", str(tmp), str(src)],
                        check=True, capture_output=True, timeout=120,
                    )
                    os.replace(tmp, built)
                final = shared / "libsched_runtime.so"
                if not final.exists():
                    tmp = final.with_name(f"{final.name}.{os.getpid()}.tmp")
                    shutil.copyfile(built, tmp)
                    os.replace(tmp, final)
                # Re-point the loader: drop what an earlier load in this
                # process left behind (a library read while another worker
                # wrote it, or a failed build it would never retry).
                jax_native._SO = str(built)
                jax_native._lib = None
                jax_native._load_failed = False
                jax_native._load_error = None
            assert jax_native.available(), jax_native.load_error()
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def check_native_lane(served) -> None:
    """Raise unless `served` (either package's server on the native ingest
    lane) really serves on it: a JAX server whose runtime failed to load
    serves on the python lane instead, and must fail with that cause, not
    as a framing mismatch. Stops the server before raising."""
    stats = served.server.ingest_stats()
    if stats.get("degraded") or stats.get("ingest") != "native":
        served.stop()
        raise AssertionError(
            f"{served.root} server is not on the native lane ({stats}): "
            f"{jax_native.load_error()}"
        )


@pytest.fixture(autouse=True)
def slots_return_to_baseline():
    load_jax_native()
    gc.collect()
    base = port_native.live_slot_count()
    yield
    gc.collect()
    assert port_native.live_slot_count() == base


# ------------------------------------------------------------ predicate slots


def _names(seed, n=64):
    rng = np.random.default_rng(seed)
    return [f"node-{int(i):05d}" for i in rng.choice(100_000, n, replace=False)]


def _pod(name="drv"):
    return {
        "metadata": {"name": name, "namespace": "ns", "labels": {"spark-role": "driver"}},
        "spec": {"containers": [{"name": "main"}]},
    }


def _json(pod, names, key="NodeNames"):
    return json.dumps({"Pod": pod, key: names}).encode()


def _binary(pod_raw: bytes, names) -> bytes:
    out = bytearray(b"SPRD\x01") + struct.pack("<I", len(pod_raw)) + pod_raw
    out += struct.pack("<I", len(names))
    for n in names:
        b = n if isinstance(n, bytes) else n.encode()
        out += struct.pack("<H", len(b)) + b
    return bytes(out)


SLOT_BODIES = {
    "json": (_json(_pod(), _names(1)), False),
    "json-compact": (
        json.dumps({"Pod": _pod(), "NodeNames": _names(2)}, separators=(",", ":")).encode(),
        False,
    ),
    "json-names-first": (
        json.dumps({"NodeNames": _names(3), "Pod": _pod()}).encode(), False
    ),
    "json-unicode-name": (_json(_pod(), ["zone-é/n", "n1"]), False),
    "json-empty-names": (_json(_pod(), []), False),
    "json-large": (_json(_pod(), _names(4, n=10_000)), False),
    "json-escaped-name": (
        b'{"Pod": {"metadata": {"name": "p"}}, "NodeNames": ["n0", "n\\u0031"]}',
        False,
    ),
    "json-escaped-key": (
        b'{"\\u0050od": {"metadata": {"name": "real"}}, "NodeNames": ["n1"]}',
        False,
    ),
    "json-duplicate-names-key": (
        b'{"Pod": {}, "NodeNames": ["a"], "NodeNames": ["b"]}', False
    ),
    "json-duplicate-pod-key": (
        b'{"Pod": {"a": 1}, "Pod": {"b": 2}, "NodeNames": ["n"]}', False
    ),
    "json-nodes-form": (_json(_pod(), [], key="Nodes"), False),
    "json-lowercase-key": (_json(_pod(), ["n0"], key="nodeNames"), False),
    "json-garbage": (b"{not json", False),
    "json-empty": (b"", False),
    "binary": (_binary(json.dumps(_pod()).encode(), _names(5)), True),
    "binary-large": (_binary(b"{}", _names(6, n=10_000)), True),
    "binary-empty-pod": (_binary(b"", ["n0"]), True),
    "binary-bomb": (b"SPRD\x01" + struct.pack("<I", 0) + struct.pack("<I", 10**9), True),
    "binary-nul-name": (_binary(b"{}", [b"a\x00b"]), True),
    "binary-bad-magic": (b"XXXX\x01" + b"\x00" * 8, True),
    "binary-bad-version": (b"SPRD\x02" + b"\x00" * 8, True),
    "binary-trailing": (_binary(b"{}", ["n"]) + b"x", True),
    "binary-truncated": (_binary(b"{}", ["node-1", "node-2"])[:-3], True),
}


def _offsets(slot) -> list:
    count = slot.names_count
    if not count:
        return []
    ptr = ctypes.cast(slot._lib.pslot_offs_ptr(slot._h), ctypes.POINTER(ctypes.c_int32))
    return [ptr[i] for i in range(count + 1)]


def _slot_view(native, body, binary):
    slot = native.PredicateSlot()
    hit = slot.decode_binary(body) if binary else slot.decode_json(body)
    view = {"hit": hit}
    if hit:
        view.update(
            pod=slot.pod_json(),
            blob=slot.names_blob(),
            offsets=_offsets(slot),
            digest=slot.digest,
            count=slot.names_count,
            first=slot.name_at(0) if slot.names_count else None,
        )
    del slot
    return view


@pytest.mark.parametrize("case", sorted(SLOT_BODIES))
def test_predicate_slot_matches_jax(case):
    body, binary = SLOT_BODIES[case]
    want, got = (_slot_view(n, body, binary) for n in SIDES)
    assert got == want
    misses = {
        "json-escaped-name", "json-escaped-key", "json-duplicate-names-key",
        "json-nodes-form", "json-lowercase-key",
        # json.dumps writes "é" as an escape, which the fast path refuses;
        # it refuses an empty candidate list too.
        "json-unicode-name", "json-empty-names", "json-garbage", "json-empty", "binary-bomb", "binary-nul-name",
        "binary-bad-magic", "binary-bad-version", "binary-trailing",
        "binary-truncated",
    }
    assert got["hit"] == (case not in misses)


def test_slot_blob_equality_and_digest_follow_content():
    a, b, c = (port_native.PredicateSlot() for _ in range(3))
    assert a.decode_json(_json(_pod("x"), _names(9)))
    assert b.decode_binary(_binary(b"{}", _names(9)))
    assert c.decode_json(_json(_pod("x"), _names(9)[:-1] + ["other"]))
    assert a.digest == b.digest and a.blob_equal(b)
    assert a.digest != c.digest and not a.blob_equal(c)


# ------------------------------------------------------------- HTTP framing

FRAMING = {
    "get": b"GET /status/liveness HTTP/1.1\r\nHost: x\r\n\r\n",
    "pipelined": (
        b"GET /status/liveness HTTP/1.1\r\nHost: x\r\n\r\n"
        b"POST /predicates HTTP/1.1\r\nContent-Length: 2\r\n\r\n{}"
        b"GET /status/readiness HTTP/1.1\r\nConnection: close\r\n\r\n"
    ),
    "predicate-query": b"POST /predicates?x=1 HTTP/1.1\r\nContent-Length: 3\r\n\r\nabc",
    "http10": b"GET / HTTP/1.0\r\n\r\n",
    "http10-keepalive": b"GET / HTTP/1.0\r\nConnection: Keep-Alive\r\n\r\n",
    "connection-close": b"GET / HTTP/1.1\r\nConnection: close\r\n\r\n",
    "garbage": b"GARBAGE\r\n\r\n",
    "bad-version": b"GET /status/liveness HTTP-WRONG\r\n\r\n",
    "no-colon": b"GET /x HTTP/1.1\r\nno-colon-header\r\n\r\n",
    "header-too-large": b"GET / HTTP/1.1\r\nX-Junk: " + b"j" * 70_000,
    "chunked": b"POST /predicates HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\n5\r\nhello",
    "empty-te": b"POST /predicates HTTP/1.1\r\nTransfer-Encoding:\r\nContent-Length: 2\r\n\r\n{}",
    "cl-conflict": b"POST /predicates HTTP/1.1\r\nContent-Length: 5\r\nContent-Length: 6\r\n\r\n",
    "cl-duplicate-same": b"POST /p HTTP/1.1\r\nContent-Length: 2\r\nContent-Length: 2\r\n\r\nab",
    "cl-negative": b"POST /predicates HTTP/1.1\r\nContent-Length: -5\r\n\r\n",
    "cl-underscore": b"POST /predicates HTTP/1.1\r\nContent-Length: 1_6\r\n\r\n",
    "cl-empty": b"POST /p HTTP/1.1\r\nContent-Length:\r\n\r\n",
    "cl-huge": b"POST /p HTTP/1.1\r\nContent-Length: 99999999999999999999999\r\n\r\n",
    "too-large-then-get": (
        b"POST /predicates HTTP/1.1\r\nContent-Length: 200\r\n\r\n" + b"x" * 200
        + b"GET /status/liveness HTTP/1.1\r\n\r\n"
    ),
    "partial-body": b"POST /p HTTP/1.1\r\nContent-Length: 10\r\n\r\nabc",
}


def _events(native, data: bytes, chunk: int, max_body=64):
    """Every framing event of `data` fed `chunk` bytes at a time, with the
    request's method, target, head and body read out of the buffer."""
    conn = native.IngestConn(max_body, 65536)
    out = []
    for i in range(0, len(data), chunk):
        conn.feed(data[i:i + chunk])
        while True:
            ev = conn.next()
            if ev.kind == native.EV_NEED_MORE:
                break
            rec = (
                ev.kind, ev.status, ev.flags, ev.body_error, ev.err_code,
                ev.declared_len,
            )
            if ev.kind == native.EV_REQUEST:
                rec += (
                    conn.read(ev.method_off, ev.method_len),
                    conn.read(ev.target_off, ev.target_len),
                    conn.read(ev.head_off, ev.head_len),
                    conn.read(ev.body_off, ev.body_len),
                )
            out.append(rec)
            if ev.kind == native.EV_REJECT:
                break
    conn.close()
    return out


@pytest.mark.parametrize("chunk", [1 << 20, 7, 1], ids=["whole", "7-bytes", "bytewise"])
@pytest.mark.parametrize("case", sorted(FRAMING))
def test_ingest_conn_events_match_jax(case, chunk):
    data = FRAMING[case]
    if chunk == 1 and len(data) > 4096:
        chunk = 4096  # the 70 KB header case, fed in pages
    want, got = (_events(n, data, chunk) for n in SIDES)
    assert got == want
    assert got or case in ("partial-body",)


def test_ingest_conn_decode_into_slot_matches_jax():
    body = _json(_pod(), _names(11, n=500))
    req = b"POST /predicates HTTP/1.1\r\nContent-Length: %d\r\n\r\n" % len(body) + body
    views = []
    for native in SIDES:
        conn = native.IngestConn(None, 65536)
        conn.feed(req)
        ev = conn.next()
        assert ev.kind == native.EV_REQUEST and ev.flags & native.FLAG_PREDICATE
        slot = native.PredicateSlot()
        assert conn.decode_into(slot, binary=False)
        views.append((slot.digest, slot.names_blob(), slot.pod_json()))
        del slot
        conn.close()
    assert views[1] == views[0]


# ------------------------------------------------------------- cluster arena


def _arena_ops(seed, n=48):
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(n):
        alloc = rng.integers(0, 64_000, 3)
        ops.append(("upsert", i, alloc, int(rng.integers(0, 4)),
                    bool(rng.random() < 0.1), bool(rng.random() > 0.1),
                    int(rng.integers(-1, 3)), int(rng.integers(-1, 3))))
    for i in rng.choice(n, 6, replace=False):
        ops.append(("remove", int(i)))
    ops.append(("ranks", rng.permutation(n)))
    ops.append(("rank_values", rng.choice(n, 5, replace=False),
                rng.integers(0, 1000, 5)))
    return ops, rng.integers(0, 8_000, (n, 3)), rng.integers(0, 2_000, (n, 3))


def _run_arena(native, ops, usage, overhead):
    arena = native.ClusterArena()
    for op in ops:
        if op[0] == "upsert":
            arena.upsert(*op[1:])
        elif op[0] == "remove":
            arena.remove(op[1])
        elif op[0] == "ranks":
            arena.set_name_ranks(op[1])
        else:
            arena.set_name_rank_values(op[1], op[2])
    n = len(usage)
    full = arena.snapshot(n, usage, overhead)
    raw = arena.snapshot_raw(n, usage, overhead)
    rows = np.asarray([1, 5, 9, 30], np.int64)
    usage2 = usage.copy()
    usage2[rows] += 7
    arena.snapshot_rows(rows, usage2, overhead, *raw)
    return [np.asarray(a) for a in full] + [np.asarray(a) for a in raw], arena.capacity()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cluster_arena_snapshot_matches_jax(seed):
    ops, usage, overhead = _arena_ops(seed)
    (want, wcap), (got, gcap) = (_run_arena(n, ops, usage, overhead) for n in SIDES)
    assert gcap == wcap
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


# -------------------------------------------------------------------- queue


class _Req:
    def __init__(self, key, kind):
        self.key = key
        self.type = type("T", (), {"name": kind})()


def _queue_run(native, seed):
    rng = np.random.default_rng(seed)
    q = native.NativeShardedQueue(4, buffer_size=16)
    accepted = []
    for i in range(60):
        key = ("ns", f"k{int(rng.integers(0, 20))}")
        kind = ("CREATE", "UPDATE", "DELETE")[int(rng.integers(0, 3))]
        accepted.append(q.try_add_if_absent(_Req(key, kind)))
    lengths = q.queue_lengths()
    popped = []
    for b in range(q.num_buckets):
        while (r := q.pop(b, timeout_s=0)) is not None:
            popped.append((b, r.key, r.type.name))
    return accepted, lengths, popped


@pytest.mark.parametrize("seed", [0, 1])
def test_native_queue_order_matches_jax(seed):
    want, got = (_queue_run(n, seed) for n in SIDES)
    assert got == want
    assert got[2], "nothing was queued"


# ---------------------------------------------------------------- the build


def test_library_is_named_by_its_digest_under_build():
    path = port_native.library_path()
    assert path.parent == REPO / "spark_scheduler_tpu_torch" / "_build"
    assert path.name.startswith("libsched_runtime-") and path.exists()
    assert port_native.build() is False  # built already: nothing to do


_MISSING_COMPILER = r"""
import sys, tempfile
from pathlib import Path
import spark_scheduler_tpu_torch.native as native
out = Path(tempfile.mkdtemp()) / "libsched_runtime-test.so"
native.library_path = lambda: out
try:
    native.load()
except RuntimeError as exc:
    assert "compiler not found" in str(exc), exc
    assert not out.exists()
    from spark_scheduler_tpu_torch.server.ingest import NativeIngestCodec
    try:
        NativeIngestCodec()
    except RuntimeError:
        print("raised")
        sys.exit(0)
sys.exit(1)
"""


def test_missing_compiler_raises_and_does_not_degrade():
    env = dict(os.environ, CXX="/nonexistent/g++")
    out = subprocess.run(
        [sys.executable, "-c", _MISSING_COMPILER], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "raised"


_RACE = r"""
import sys
from pathlib import Path
import spark_scheduler_tpu_torch.native as native
native.library_path = lambda: Path(sys.argv[1])
slot = native.PredicateSlot()
assert slot.decode_json(b'{"Pod": {}, "NodeNames": ["a", "b"]}')
assert slot.names_count == 2
"""


def test_parallel_builds_of_one_library_all_load(tmp_path):
    """Processes that build the same missing library at once (as test
    workers do) each write their own temporary file and move it into
    place: every one of them loads a whole library."""
    out = tmp_path / "libsched_runtime-race.so"
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _RACE, str(out)], cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for _ in range(4)
    ]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-2000:]
    assert out.exists()
    assert not list(tmp_path.glob("*.tmp"))

