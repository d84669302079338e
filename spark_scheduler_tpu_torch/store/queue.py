"""Sharded unique write queue.

Rebuilds internal/cache/store/queue.go:22-144: per-key dedup via an
"inflight" set (consecutive create/update requests for the same key are
compacted — the consumer reads the latest object from the store when it
drains), FNV-1a sharding so one key always drains on one consumer (write
ordering per object), bounded buffers with a non-blocking TryAdd variant.
Delete requests are never compacted into a prior create/update
(queue.go:58-62) so freshly-created objects still reach the backend.
"""

from __future__ import annotations

import dataclasses
import enum
import queue as _queue
import threading
from typing import Callable

Key = tuple[str, str]

QUEUE_BUFFER_SIZE = 100  # asyncRequestBufferSize, queue.go:22-27


class RequestType(enum.Enum):
    CREATE = "create"
    UPDATE = "update"
    DELETE = "delete"


@dataclasses.dataclass
class Request:
    key: Key
    type: RequestType
    retry_count: int = 0

    def with_increased_retry(self) -> "Request":
        return Request(self.key, self.type, self.retry_count + 1)


def _fnv1a_32(data: bytes) -> int:
    h = 0x811C9DC5
    for b in data:
        h ^= b
        h = (h * 0x01000193) & 0xFFFFFFFF
    return h


class ShardedUniqueQueue:
    def __init__(self, buckets: int, buffer_size: int = QUEUE_BUFFER_SIZE):
        self._queues = [_queue.Queue(maxsize=buffer_size) for _ in range(buckets)]
        self._inflight: set[Key] = set()
        self._lock = threading.Lock()

    def _bucket(self, key: Key) -> int:
        return _fnv1a_32(f"{key[0]}/{key[1]}".encode()) % len(self._queues)

    def _add_inflight_if_absent(self, key: Key) -> bool:
        with self._lock:
            if key in self._inflight:
                return False
            self._inflight.add(key)
            return True

    def _release(self, req: Request) -> Request:
        """Consumers call this when taking a request: clears the inflight
        mark so later writes re-enqueue (queue.go:100-112)."""
        with self._lock:
            self._inflight.discard(req.key)
        return req

    def add_if_absent(self, req: Request) -> None:
        added = self._add_inflight_if_absent(req.key)
        if added or req.type == RequestType.DELETE:
            self._queues[self._bucket(req.key)].put(lambda: self._release(req))

    def try_add_if_absent(self, req: Request) -> bool:
        added = self._add_inflight_if_absent(req.key)
        if added or req.type == RequestType.DELETE:
            try:
                self._queues[self._bucket(req.key)].put_nowait(
                    lambda: self._release(req)
                )
                return True
            except _queue.Full:
                if added:
                    with self._lock:
                        self._inflight.discard(req.key)
                return False
        return True

    def consumers(self) -> list[_queue.Queue]:
        return self._queues

    def queue_lengths(self) -> list[int]:
        return [q.qsize() for q in self._queues]

    @property
    def num_buckets(self) -> int:
        return len(self._queues)

    def pop(self, bucket: int, timeout_s: float | None) -> Request | None:
        """Consumer-side take (same surface as the native queue): one request
        from shard `bucket`, or None on timeout/empty."""
        return drain_one(self._queues[bucket], timeout=timeout_s)


def drain_one(q: _queue.Queue, timeout: float | None = None) -> Request | None:
    """Take one request thunk off a consumer queue (returns None on timeout)."""
    try:
        if timeout == 0:
            thunk: Callable[[], Request] = q.get_nowait()
        else:
            thunk = q.get(timeout=timeout)
    except _queue.Empty:
        return None
    return thunk()


def make_sharded_queue(
    buckets: int,
    buffer_size: int = QUEUE_BUFFER_SIZE,
    prefer_native: bool = True,
):
    """The native C++ queue (`native.NativeShardedQueue`) by default, as the
    JAX package picks when its library loads; `prefer_native=False` is the
    pure-Python queue. The port builds the native runtime or raises: a
    missing compiler is an error, never a silent fall back to Python. Both
    expose add_if_absent / try_add_if_absent / pop / queue_lengths /
    num_buckets."""
    if prefer_native:
        from spark_scheduler_tpu_torch import native

        return native.NativeShardedQueue(buckets, buffer_size)
    return ShardedUniqueQueue(buckets, buffer_size)
