"""Native (C++) runtime bindings of the port.

The port's copy of spark_scheduler_tpu/native/__init__.py over its own
source, `native/runtime.cpp` beside this file. Exposes:

  ClusterArena       — incremental dense cluster state + one-call snapshot
                       (feeds ClusterTensors without a per-request Python
                       walk over every node).
  NativeShardedQueue — the write-back queue of store/queue.py with the
                       dedup/shard/blocking semantics implemented in C++
                       (store/queue.go:22-144 parity).
  IngestConn         — incremental HTTP/1.1 request framer over a
                       connection-owned C++ buffer (the async transport's
                       `server.ingest: native` lane).
  PredicateSlot      — reusable arena slot a predicate body decodes into
                       (pod JSON span + '\\0'-separated candidate-name blob
                       with offsets and an FNV-1a 64 digest) — the
                       zero-copy ticket server/ingest.py wraps.

The library is compiled at first use with `g++ -O2 -std=c++17 -fPIC
-shared` (`$CXX` overrides the compiler) into
`BUILD_DIR/libsched_runtime-<digest>.so` (`spark_scheduler_tpu_torch/_build/`,
or the directory `ops/_build.use_build_dir` sets), named by a
hash of the flags and the source, as ops/_build.py names the CUDA kernels:
the compiler writes a `.<pid>.tmp` file that `os.replace` moves into place,
so test workers building at once never load a half-written library. A
build or load failure raises with the compiler's output; nothing degrades
to a pure-Python lane. `ClusterArena` is the solver's host tensor build
(core/solver.py `_build_tensors_native`, every solver unless
`use_native=False`); `NativeShardedQueue` is bound but not wired into the
port yet (ROADMAP A.8).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

from spark_scheduler_tpu_torch.ops._build import BUILD_DIR, note_builds

SOURCE = Path(__file__).resolve().parent / "runtime.cpp"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")

_lib = None
_lib_lock = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libsched_runtime-{h.hexdigest()[:16]}.so"


def build() -> bool:
    """Compile the library unless it is already built. Returns True when
    this call compiled it; raises with the compiler's output on failure."""
    out = library_path()
    if out.exists():
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except FileNotFoundError as exc:
        raise RuntimeError(
            f"native runtime build failed: compiler not found: {cmd[0]}"
        ) from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"native runtime build failed ({cmd[0]} exit {proc.returncode}):\n"
            + (proc.stderr or proc.stdout)[-2000:]
        )
    os.replace(tmp, out)
    note_builds(1, time.perf_counter() - t0)
    return True


class IngestEvent(ctypes.Structure):
    """Mirror of native/runtime.cpp's IngestEvent: one framed request (or
    reject / need-more) from the incremental HTTP/1.1 framer. Offsets index
    the connection buffer (`IngestConn.ptr`), valid until the next
    `next()` call."""

    _fields_ = [
        ("kind", ctypes.c_int32),
        ("status", ctypes.c_int32),
        ("flags", ctypes.c_int32),
        ("body_error", ctypes.c_int32),
        ("err_code", ctypes.c_int32),
        ("pad_", ctypes.c_int32),
        ("method_off", ctypes.c_int64),
        ("method_len", ctypes.c_int64),
        ("target_off", ctypes.c_int64),
        ("target_len", ctypes.c_int64),
        ("head_off", ctypes.c_int64),
        ("head_len", ctypes.c_int64),
        ("body_off", ctypes.c_int64),
        ("body_len", ctypes.c_int64),
        ("declared_len", ctypes.c_int64),
        ("parse_ns", ctypes.c_int64),
    ]


# Event kinds.
EV_NEED_MORE, EV_REQUEST, EV_REJECT = 0, 1, 2
# Deferred body-error codes (mapped to the routing layer's exceptions).
BODY_ERR_TRANSFER_ENCODING, BODY_ERR_CONTENT_LENGTH, BODY_ERR_TOO_LARGE = (
    1, 2, 3,
)
# Reject detail codes.
REJECT_HEADER_TOO_LARGE, REJECT_REQUEST_LINE, REJECT_HEADER_LINE = 1, 2, 3
# Request flags.
FLAG_KEEP_ALIVE, FLAG_CLOSE_AFTER, FLAG_PREDICATE = 1, 2, 4


def _bind(lib) -> None:
    i64, i32, u64, u8 = (
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.c_uint64,
        ctypes.c_uint8,
    )
    p = ctypes.POINTER
    lib.arena_create.restype = ctypes.c_void_p
    lib.arena_destroy.argtypes = [ctypes.c_void_p]
    lib.arena_upsert.argtypes = [
        ctypes.c_void_p, i64, p(i64), i32, i32, i32, i32, i32,
    ]
    lib.arena_remove.argtypes = [ctypes.c_void_p, i64]
    lib.arena_set_name_ranks.argtypes = [ctypes.c_void_p, p(i64), i64]
    lib.arena_set_name_rank_values.argtypes = [
        ctypes.c_void_p, p(i64), p(i32), i64,
    ]
    lib.arena_snapshot.argtypes = [
        ctypes.c_void_p, i64, p(i64), p(i64), p(i32), p(i32), p(i32), p(i32),
        p(i32), p(i32), p(u8), p(u8), p(u8),
    ]
    lib.arena_snapshot_rows.argtypes = [
        ctypes.c_void_p, p(i64), i64, i64, p(i64), p(i64), p(i32), p(i32),
        p(i32), p(i32), p(i32), p(i32), p(u8), p(u8), p(u8),
    ]
    lib.arena_capacity.argtypes = [ctypes.c_void_p]
    lib.arena_capacity.restype = i64
    lib.queue_create.argtypes = [i64, i64]
    lib.queue_create.restype = ctypes.c_void_p
    lib.queue_destroy.argtypes = [ctypes.c_void_p]
    lib.queue_bucket.argtypes = [ctypes.c_void_p, ctypes.c_char_p, i64]
    lib.queue_bucket.restype = i64
    lib.queue_add_if_absent.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, i64, u64, i32,
    ]
    lib.queue_add_if_absent.restype = i32
    lib.queue_try_add_if_absent.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, i64, u64, i32,
    ]
    lib.queue_try_add_if_absent.restype = i32
    lib.queue_pop.argtypes = [ctypes.c_void_p, i64, i64, p(u64)]
    lib.queue_pop.restype = i32
    lib.queue_release.argtypes = [ctypes.c_void_p, ctypes.c_char_p, i64]
    lib.queue_len.argtypes = [ctypes.c_void_p, i64]
    lib.queue_len.restype = i64
    lib.queue_num_buckets.argtypes = [ctypes.c_void_p]
    lib.queue_num_buckets.restype = i64
    # ---- ingest lane (predicate slots + HTTP framer) ----
    lib.pslot_create.restype = ctypes.c_void_p
    lib.pslot_destroy.argtypes = [ctypes.c_void_p]
    lib.ingest_live_slots.restype = i64
    lib.predicate_decode_json.argtypes = [ctypes.c_void_p, ctypes.c_char_p, i64]
    lib.predicate_decode_json.restype = i32
    lib.predicate_decode_binary.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, i64,
    ]
    lib.predicate_decode_binary.restype = i32
    lib.pslot_pod_ptr.argtypes = [ctypes.c_void_p]
    lib.pslot_pod_ptr.restype = ctypes.c_void_p
    lib.pslot_pod_len.argtypes = [ctypes.c_void_p]
    lib.pslot_pod_len.restype = i64
    lib.pslot_blob_ptr.argtypes = [ctypes.c_void_p]
    lib.pslot_blob_ptr.restype = ctypes.c_void_p
    lib.pslot_blob_len.argtypes = [ctypes.c_void_p]
    lib.pslot_blob_len.restype = i64
    lib.pslot_offs_ptr.argtypes = [ctypes.c_void_p]
    lib.pslot_offs_ptr.restype = ctypes.c_void_p
    lib.pslot_names_count.argtypes = [ctypes.c_void_p]
    lib.pslot_names_count.restype = i64
    lib.pslot_digest.argtypes = [ctypes.c_void_p]
    lib.pslot_digest.restype = u64
    lib.pslot_decode_ns.argtypes = [ctypes.c_void_p]
    lib.pslot_decode_ns.restype = i64
    lib.pslot_blob_equal.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.pslot_blob_equal.restype = i32
    lib.ingest_conn_create.argtypes = [i64, i64]
    lib.ingest_conn_create.restype = ctypes.c_void_p
    lib.ingest_conn_destroy.argtypes = [ctypes.c_void_p]
    lib.ingest_conn_feed.argtypes = [ctypes.c_void_p, ctypes.c_char_p, i64]
    lib.ingest_conn_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(IngestEvent),
    ]
    lib.ingest_conn_next.restype = i32
    lib.ingest_conn_ptr.argtypes = [ctypes.c_void_p]
    lib.ingest_conn_ptr.restype = ctypes.c_void_p
    lib.ingest_conn_decode_json.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.ingest_conn_decode_json.restype = i32
    lib.ingest_conn_decode_binary.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.ingest_conn_decode_binary.restype = i32


def load():
    """The loaded library, built first if needed (raises on failure)."""
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                build()
                lib = ctypes.CDLL(str(library_path()))
                _bind(lib)
                _lib = lib
    return _lib


def live_slot_count() -> int:
    """Live predicate arena slots (the ingest telemetry's arena-occupancy
    gauge)."""
    return int(load().ingest_live_slots())


def _i64p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _i32p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _u8p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class ClusterArena:
    """Incremental cluster-state arena (see native/runtime.cpp)."""

    def __init__(self):
        self._lib = load()
        self._h = self._lib.arena_create()

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.arena_destroy(self._h)
            self._h = None

    def upsert(
        self,
        idx: int,
        alloc,  # length-3 int array (cpu_milli, mem_kib, gpu_milli)
        zone_id: int,
        unschedulable: bool,
        ready: bool,
        lr_driver: int,
        lr_executor: int,
    ) -> None:
        buf = np.ascontiguousarray(alloc, dtype=np.int64)
        self._lib.arena_upsert(
            self._h, idx, _i64p(buf), zone_id, int(unschedulable), int(ready),
            lr_driver, lr_executor,
        )

    def remove(self, idx: int) -> None:
        self._lib.arena_remove(self._h, idx)

    def set_name_ranks(self, sorted_indices) -> None:
        buf = np.ascontiguousarray(sorted_indices, dtype=np.int64)
        self._lib.arena_set_name_ranks(self._h, _i64p(buf), len(buf))

    def set_name_rank_values(self, indices, ranks) -> None:
        """Scatter explicit (gapped) rank VALUES onto slots; unlisted
        slots keep theirs. The O(changed) twin of set_name_ranks — see
        arena_set_name_rank_values in native/runtime.cpp."""
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        val = np.ascontiguousarray(ranks, dtype=np.int32)
        self._lib.arena_set_name_rank_values(
            self._h, _i64p(idx), _i32p(val), len(idx)
        )

    def capacity(self) -> int:
        return int(self._lib.arena_capacity(self._h))

    def snapshot_raw(self, n: int, usage: np.ndarray, overhead: np.ndarray):
        """snapshot() but returning the three mask fields as their uint8
        BACKING buffers (callers expose `.view(np.bool_)` of the same
        memory) — a resident tensor build keeps these buffers and patches
        them in place via snapshot_rows."""
        usage = np.ascontiguousarray(usage, dtype=np.int64)
        overhead = np.ascontiguousarray(overhead, dtype=np.int64)
        available = np.empty((n, 3), dtype=np.int32)
        schedulable = np.empty((n, 3), dtype=np.int32)
        zone_id = np.empty(n, dtype=np.int32)
        name_rank = np.empty(n, dtype=np.int32)
        lr_driver = np.empty(n, dtype=np.int32)
        lr_executor = np.empty(n, dtype=np.int32)
        unschedulable = np.empty(n, dtype=np.uint8)
        ready = np.empty(n, dtype=np.uint8)
        valid = np.empty(n, dtype=np.uint8)
        self._lib.arena_snapshot(
            self._h, n, _i64p(usage), _i64p(overhead), _i32p(available),
            _i32p(schedulable), _i32p(zone_id), _i32p(name_rank),
            _i32p(lr_driver), _i32p(lr_executor), _u8p(unschedulable),
            _u8p(ready), _u8p(valid),
        )
        return (
            available,
            schedulable,
            zone_id,
            name_rank,
            lr_driver,
            lr_executor,
            unschedulable,
            ready,
            valid,
        )

    def snapshot(self, n: int, usage: np.ndarray, overhead: np.ndarray):
        """Materialize ClusterTensors fields for slots [0, n).

        usage/overhead: [n, 3] int64 (caller scatters the sparse maps).
        Returns the 9 arrays in ClusterTensors field order.
        """
        fields = self.snapshot_raw(n, usage, overhead)
        return fields[:6] + tuple(f.astype(bool) for f in fields[6:])

    def snapshot_rows(
        self,
        rows: np.ndarray,
        usage: np.ndarray,
        overhead: np.ndarray,
        available: np.ndarray,
        schedulable: np.ndarray,
        zone_id: np.ndarray,
        name_rank: np.ndarray,
        lr_driver: np.ndarray,
        lr_executor: np.ndarray,
        unschedulable: np.ndarray,
        ready: np.ndarray,
        valid: np.ndarray,
    ) -> None:
        """Recompute ONLY `rows` into the caller's RESIDENT field buffers
        (an O(K + changed) tensor build). Buffers must be the C-contiguous
        arrays of one prior full `snapshot` materialization;
        unschedulable/ready/valid are the uint8 backing stores (callers
        expose bool views of the same memory). usage/overhead are the FULL
        [n, 3] int64 inputs — only their `rows` entries are read."""
        idx = np.ascontiguousarray(rows, dtype=np.int64)
        usage = np.ascontiguousarray(usage, dtype=np.int64)
        overhead = np.ascontiguousarray(overhead, dtype=np.int64)
        self._lib.arena_snapshot_rows(
            self._h, _i64p(idx), len(idx), available.shape[0], _i64p(usage),
            _i64p(overhead), _i32p(available), _i32p(schedulable),
            _i32p(zone_id), _i32p(name_rank), _i32p(lr_driver),
            _i32p(lr_executor), _u8p(unschedulable), _u8p(ready), _u8p(valid),
        )


class NativeShardedQueue:
    """C++-backed ShardedUniqueQueue (store/queue.py interface parity).

    Tickets (u64) index a Python-side table carrying the Request payloads;
    the C++ side owns dedup, sharding, buffering, and blocking.
    """

    def __init__(self, buckets: int, buffer_size: int = 100):
        self._lib = load()
        self._h = self._lib.queue_create(buckets, buffer_size)
        self._payloads: dict[int, object] = {}
        self._next_ticket = 0
        self._lock = threading.Lock()

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.queue_destroy(self._h)
            self._h = None

    def _ticket_for(self, payload) -> int:
        with self._lock:
            self._next_ticket += 1
            t = self._next_ticket
            self._payloads[t] = payload
        return t

    @staticmethod
    def _key_bytes(key) -> bytes:
        return f"{key[0]}/{key[1]}".encode() if isinstance(key, tuple) else str(key).encode()

    def add_if_absent(self, req) -> None:
        kb = self._key_bytes(req.key)
        is_delete = 1 if req.type.name == "DELETE" else 0
        t = self._ticket_for(req)
        if not self._lib.queue_add_if_absent(self._h, kb, len(kb), t, is_delete):
            with self._lock:
                self._payloads.pop(t, None)  # deduped: drop the ticket

    def try_add_if_absent(self, req) -> bool:
        kb = self._key_bytes(req.key)
        is_delete = 1 if req.type.name == "DELETE" else 0
        t = self._ticket_for(req)
        rc = self._lib.queue_try_add_if_absent(self._h, kb, len(kb), t, is_delete)
        if rc != 1:
            with self._lock:
                self._payloads.pop(t, None)
        # Deduped (0) counts as success — a pending request already covers
        # this key; only a full buffer (-1) reports failure (queue.go:73-88).
        return rc != -1

    def pop(self, bucket: int, timeout_s: float | None):
        """Blocking pop for consumer `bucket`; None on timeout. Releases the
        key from the inflight set so later writes re-enqueue
        (queue.go:90-104)."""
        ms = int((timeout_s if timeout_s is not None else 3600.0) * 1000)
        out = ctypes.c_uint64()
        if not self._lib.queue_pop(self._h, bucket, ms, ctypes.byref(out)):
            return None
        with self._lock:
            req = self._payloads.pop(out.value)
        kb = self._key_bytes(req.key)
        self._lib.queue_release(self._h, kb, len(kb))
        return req

    def queue_lengths(self) -> list[int]:
        n = self._lib.queue_num_buckets(self._h)
        return [int(self._lib.queue_len(self._h, b)) for b in range(n)]

    @property
    def num_buckets(self) -> int:
        return int(self._lib.queue_num_buckets(self._h))


class PredicateSlot:
    """One reusable arena slot a predicate body decodes into. The slot owns
    the tokenized candidate-name blob and the pod JSON span; it is the
    TICKET the serving path carries (server/ingest.py wraps it in a
    NativeNodeNames) — freed when the last reference drops."""

    __slots__ = ("_lib", "_h")

    def __init__(self):
        self._lib = load()
        self._h = self._lib.pslot_create()

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.pslot_destroy(self._h)
            self._h = None

    def decode_json(self, body: bytes) -> bool:
        return bool(
            self._lib.predicate_decode_json(self._h, body, len(body))
        )

    def decode_binary(self, body: bytes) -> bool:
        return bool(
            self._lib.predicate_decode_binary(self._h, body, len(body))
        )

    @property
    def names_count(self) -> int:
        return int(self._lib.pslot_names_count(self._h))

    @property
    def digest(self) -> int:
        return int(self._lib.pslot_digest(self._h))

    @property
    def decode_ns(self) -> int:
        return int(self._lib.pslot_decode_ns(self._h))

    def pod_json(self) -> bytes:
        n = self._lib.pslot_pod_len(self._h)
        if not n:
            return b"{}"
        return ctypes.string_at(self._lib.pslot_pod_ptr(self._h), n)

    def names_blob(self) -> bytes:
        n = self._lib.pslot_blob_len(self._h)
        if not n:
            return b""
        return ctypes.string_at(self._lib.pslot_blob_ptr(self._h), n)

    def name_at(self, i: int) -> str:
        count = self.names_count
        if not 0 <= i < count:
            raise IndexError(i)
        offs = ctypes.cast(
            self._lib.pslot_offs_ptr(self._h),
            ctypes.POINTER(ctypes.c_int32),
        )
        start, end = offs[i], offs[i + 1] - 1  # exclude the '\0'
        return ctypes.string_at(
            self._lib.pslot_blob_ptr(self._h) + start, end - start
        ).decode("utf-8")

    def blob_equal(self, other: "PredicateSlot") -> bool:
        return bool(self._lib.pslot_blob_equal(self._h, other._h))


class IngestConn:
    """Per-connection incremental HTTP/1.1 framer (the native ingest lane's
    transport half). `feed` appends received bytes; `next` returns the next
    IngestEvent — offsets valid until the FOLLOWING `next` call, which
    reclaims the consumed prefix. `decode_into` tokenizes the last framed
    request's body straight from the connection buffer into a slot (the
    body bytes never materialize as a Python object)."""

    __slots__ = ("_lib", "_h", "_ev")

    def __init__(self, max_body_bytes: int | None, max_header_bytes: int):
        self._lib = load()
        self._h = self._lib.ingest_conn_create(
            -1 if max_body_bytes is None else int(max_body_bytes),
            int(max_header_bytes),
        )
        self._ev = IngestEvent()

    def __del__(self):
        self.close()

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.ingest_conn_destroy(self._h)
            self._h = None

    def feed(self, data: bytes) -> None:
        self._lib.ingest_conn_feed(self._h, data, len(data))

    def next(self) -> IngestEvent:
        self._lib.ingest_conn_next(self._h, ctypes.byref(self._ev))
        return self._ev

    def read(self, off: int, length: int) -> bytes:
        if not length:
            return b""
        return ctypes.string_at(self._lib.ingest_conn_ptr(self._h) + off, length)

    def decode_into(self, slot: PredicateSlot, *, binary: bool) -> bool:
        fn = (
            self._lib.ingest_conn_decode_binary
            if binary
            else self._lib.ingest_conn_decode_json
        )
        return bool(fn(self._h, slot._h))
