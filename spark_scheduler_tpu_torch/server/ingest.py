"""Ingest lanes: how a framed POST /predicates body becomes ExtenderArgs.

Two lanes, selected by `server.ingest` (install YAML `server.ingest:
python|native`, CLI `--ingest`):

  python (default)  the route parses the body with json.loads and walks the
                    k8s-shaped dict (server/kube_io.extender_args_from_k8s)
                    — ~200 KB of JSON and ~10k PyUnicode/dict allocations
                    per request at 10k nodes, all under the GIL the batcher
                    is competing for.
  native            native/runtime.cpp tokenizes the body into a reusable
                    arena slot: the pod sub-document (a ~1 KB JSON span —
                    still parsed by json.loads, it is off the bulk path)
                    plus the candidate-node-name bulk as a '\0'-separated
                    blob with an offsets table and an FNV-1a 64 digest.
                    The slot IS the ticket: `NativeNodeNames` wraps it as a
                    lazy Sequence[str] whose hash/equality ride the digest,
                    so the solver's candidate-mask cache hits WITHOUT ever
                    materializing the 10k names (the zero-copy hit).

Wire formats (both lanes serve both):

  JSON              the existing extender schema
                    {"Pod": {...}, "NodeNames": [...]} — the native lane
                    fast-paths exactly this shape and falls back to the
                    Python parser on ANY deviation (escapes, duplicate
                    keys, "Nodes" form), counted in the hit-ratio gauge.
  binary            Content-Type application/x-spark-predicate —
                    length-prefixed frames:
                      "SPRD" | u8 version=1 | u32le pod_len | pod JSON
                      | u32le count | count x (u16le len | name bytes)
                    decoded natively on the native lane, by the pure-Python
                    decoder here otherwise.

The port's copy of spark_scheduler_tpu/server/ingest.py over the port's
own native library (spark_scheduler_tpu_torch/native). Unlike the JAX
package, a native lane whose library fails to build does not degrade to
the python lane: `NativeIngestCodec()` raises with the compiler's output.
The data fallback above stays: a JSON body off the fast-path shape is
parsed by the Python parser and counted in the hit-ratio gauge.
"""

from __future__ import annotations

import json
import struct
import threading
from collections.abc import Sequence

BINARY_CONTENT_TYPE = "application/x-spark-predicate"

INGESTS = ("python", "native")


def is_binary_content_type(content_type: str | None) -> bool:
    if not content_type:
        return False
    return content_type.split(";", 1)[0].strip().lower() == BINARY_CONTENT_TYPE


class BinaryPredicateError(ValueError):
    """Malformed application/x-spark-predicate body (same 500-with-Error
    mapping as garbage JSON on the python lane)."""


def encode_predicate_binary(pod_raw, node_names) -> bytes:
    """Client-side encoder (bench, tests): `pod_raw` is the k8s-shaped Pod
    dict (or pre-serialized JSON bytes)."""
    pod = pod_raw if isinstance(pod_raw, bytes) else json.dumps(pod_raw).encode()
    out = bytearray(b"SPRD\x01")
    out += struct.pack("<I", len(pod))
    out += pod
    names = [n.encode() if isinstance(n, str) else n for n in node_names]
    out += struct.pack("<I", len(names))
    for n in names:
        if len(n) > 0xFFFF:
            raise BinaryPredicateError(f"node name too long: {len(n)} bytes")
        out += struct.pack("<H", len(n))
        out += n
    return bytes(out)


def decode_predicate_binary_py(body: bytes):
    """Pure-Python binary decoder — the python lane's handler for binary
    bodies. Returns (pod, node_names)."""
    from spark_scheduler_tpu_torch.server.kube_io import pod_from_k8s

    if len(body) < 13 or body[:4] != b"SPRD":
        raise BinaryPredicateError("bad magic: not a SPRD predicate body")
    if body[4] != 1:
        raise BinaryPredicateError(f"unsupported SPRD version {body[4]}")
    (pod_len,) = struct.unpack_from("<I", body, 5)
    pos = 9
    if pos + pod_len + 4 > len(body):
        raise BinaryPredicateError("truncated pod frame")
    pod_raw = json.loads(body[pos : pos + pod_len] or b"{}")
    pos += pod_len
    (count,) = struct.unpack_from("<I", body, pos)
    pos += 4
    names = []
    for _ in range(count):
        if pos + 2 > len(body):
            raise BinaryPredicateError("truncated name frame")
        (n,) = struct.unpack_from("<H", body, pos)
        pos += 2
        if pos + n > len(body):
            raise BinaryPredicateError("truncated name frame")
        names.append(body[pos : pos + n].decode("utf-8"))
        pos += n
    if pos != len(body):
        raise BinaryPredicateError("trailing bytes after name frames")
    return pod_from_k8s(pod_raw), names


class NativeNodeNames(Sequence):
    """The candidate-node-names half of a predicate ticket: a Sequence[str]
    view over a native arena slot. Hash and equality ride the slot's
    FNV-1a 64 digest (equality memcmps the blobs natively — a colliding
    digest can never alias two different candidate lists), so the solver's
    candidate-mask LRU keys on this object directly and a steady-state
    request never materializes its 10k names. Iteration/indexing decode
    lazily and memoize for the slow paths (failure maps, logging)."""

    __slots__ = ("slot", "names_digest", "_count", "_list", "_set")

    def __init__(self, slot):
        self.slot = slot
        self.names_digest = slot.digest
        self._count = slot.names_count
        self._list = None
        self._set = None

    def _materialize(self) -> list:
        if self._list is None:
            blob = self.slot.names_blob()
            self._list = (
                [s.decode("utf-8") for s in blob.split(b"\0")[:-1]]
                if blob
                else []
            )
        return self._list

    def __len__(self) -> int:
        return self._count

    def __getitem__(self, i):
        if self._list is not None:
            return self._list[i]
        if isinstance(i, slice):
            return self._materialize()[i]
        if i < 0:
            i += self._count
        return self.slot.name_at(i)

    def __iter__(self):
        return iter(self._materialize())

    def __contains__(self, name) -> bool:
        if self._set is None:
            self._set = set(self._materialize())
        return name in self._set

    def __hash__(self) -> int:
        return hash(self.names_digest)

    def __eq__(self, other) -> bool:
        if self is other:
            return True
        if isinstance(other, NativeNodeNames):
            return (
                self.names_digest == other.names_digest
                and self._count == other._count
                and self.slot.blob_equal(other.slot)
            )
        if isinstance(other, (list, tuple)):
            return self._materialize() == list(other)
        return NotImplemented

    def __repr__(self) -> str:
        return (
            f"NativeNodeNames(count={self._count}, "
            f"digest={self.names_digest:#x})"
        )


class IngestTelemetry:
    """`foundry.spark.scheduler.server.ingest.*` — the native lane's
    internals: decode time, fast-path hit ratio and arena occupancy.
    `degraded` keeps the JAX package's schema and stays 0: the port's
    native lane never degrades. Counter methods take the lock (the
    threaded transport decodes from many handler threads); `stats()` is
    the pull snapshot GET /metrics surfaces in both formats."""

    def __init__(self, lane: str):
        self.lane = lane
        self._lock = threading.Lock()
        self.decode_hits = 0  # native fast-path decodes (zero-copy tickets)
        self.decode_fallbacks = 0  # deviating bodies parsed by json.loads
        self.binary_requests = 0
        self.parse_ns_total = 0  # native framer time (async transport)
        self.decode_ns_total = 0  # native body-decode time
        self.degraded = False  # always False in the port (no degrade)

    def on_decode(self, *, hit: bool, binary: bool, decode_ns: int) -> None:
        with self._lock:
            if hit:
                self.decode_hits += 1
            else:
                self.decode_fallbacks += 1
            if binary:
                self.binary_requests += 1
            self.decode_ns_total += decode_ns

    def on_parse_ns(self, ns: int) -> None:
        with self._lock:
            self.parse_ns_total += ns

    def stats(self) -> dict:
        from spark_scheduler_tpu_torch import native

        hits, misses = self.decode_hits, self.decode_fallbacks
        total = hits + misses
        return {
            "ingest": self.lane,
            "degraded": int(self.degraded),
            "decode_hits": hits,
            "decode_fallbacks": misses,
            "zero_copy_hit_ratio": round(hits / total, 4) if total else 0.0,
            "binary_requests": self.binary_requests,
            "native_parse_ns_total": self.parse_ns_total,
            "native_decode_ns_total": self.decode_ns_total,
            "decode_mean_us": (
                round(self.decode_ns_total / total / 1e3, 2) if total else 0.0
            ),
            "arena_live_slots": native.live_slot_count(),
        }


class NativeIngestCodec:
    """The native lane: framer factory + body decoders, shared by the
    async transport (decode straight from the connection buffer) and the
    routing layer (decode from an already-copied body on the threaded
    transport)."""

    def __init__(self, telemetry: IngestTelemetry | None = None):
        from spark_scheduler_tpu_torch import native

        native.load()  # builds the library; raises if it cannot
        self._native = native
        self.telemetry = telemetry or IngestTelemetry("native")

    # ------------------------------------------------------------- framing

    def new_conn(self, max_body_bytes: int | None, max_header_bytes: int):
        return self._native.IngestConn(max_body_bytes, max_header_bytes)

    # ------------------------------------------------------------ decoding

    def _finish(self, slot, hit: bool, binary: bool):
        self.telemetry.on_decode(
            hit=hit, binary=binary, decode_ns=slot.decode_ns if hit else 0
        )
        if not hit:
            return None
        from spark_scheduler_tpu_torch.server.kube_io import pod_from_k8s

        pod = pod_from_k8s(json.loads(slot.pod_json()))
        return pod, NativeNodeNames(slot)

    def decode_predicate_body(self, body: bytes, *, binary: bool):
        """(pod, node_names) on a fast-path hit, None when the caller must
        fall back to the Python parser."""
        slot = self._native.PredicateSlot()
        hit = slot.decode_binary(body) if binary else slot.decode_json(body)
        return self._finish(slot, hit, binary)

    def decode_from_conn(self, conn, *, binary: bool):
        """Same, but tokenizing straight out of the connection buffer (the
        async transport's zero-copy hand-off: the body bytes never become
        a Python object)."""
        slot = self._native.PredicateSlot()
        hit = conn.decode_into(slot, binary=binary)
        return self._finish(slot, hit, binary)

    def stats(self) -> dict:
        return self.telemetry.stats()
