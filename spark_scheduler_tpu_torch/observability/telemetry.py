"""Serving-path telemetry: the retry ladder and the HTTP transport.

The port's copy of `RetryTelemetry` and `TransportTelemetry` from
spark_scheduler_tpu/observability/telemetry.py. The JAX package's
`SolverTelemetry` (and its jax.monitoring compile listener), `HATelemetry`
and `FleetTelemetry` are not ported yet (ROADMAP A.3c, A.9).
"""

from __future__ import annotations

import threading

from spark_scheduler_tpu_torch.metrics.registry import MetricRegistry

# Fault-tolerance subsystem: injected-fault counts per surface, retry-ladder
# activity and breaker state.
FAULTS_INJECTED = "foundry.spark.scheduler.faults.injected"
RETRY_ATTEMPTS = "foundry.spark.scheduler.retry.attempts"
RETRY_BACKOFF_MS = "foundry.spark.scheduler.retry.backoff.ms"
RETRY_BREAKER_STATE = "foundry.spark.scheduler.retry.breaker.state"
RETRY_BREAKER_OPENS = "foundry.spark.scheduler.retry.breaker.opens"

# Breaker-state gauge encoding (a label would fragment the series).
BREAKER_STATE_VALUES = {"closed": 0, "half-open": 1, "open": 2}


class RetryTelemetry:
    """`foundry.spark.scheduler.retry.*` — the shared retry ladder's
    activity, tagged by consumer (kube-write-back, lease, reflector,
    autoscaler) so one hammering consumer is attributable."""

    def __init__(self, registry: MetricRegistry | None = None):
        self.registry = registry or MetricRegistry()

    def on_retry(self, consumer: str, attempt: int, backoff_s: float) -> None:
        self.registry.counter(RETRY_ATTEMPTS, consumer=consumer).inc()
        self.registry.histogram(RETRY_BACKOFF_MS, consumer=consumer).update(
            round(backoff_s * 1e3, 3)
        )

    def retry_hook(self, consumer: str):
        """fn(attempt, exc, pause) for RetryPolicy.call's on_retry."""

        def hook(attempt, exc, pause) -> None:
            self.on_retry(consumer, attempt, pause)

        return hook

    def breaker_hook(self, consumer: str):
        """fn(old, new) for CircuitBreaker's on_transition."""

        def hook(old: str, new: str) -> None:
            self.registry.gauge(
                RETRY_BREAKER_STATE, consumer=consumer
            ).set(BREAKER_STATE_VALUES.get(new, -1))
            if new == "open":
                self.registry.counter(
                    RETRY_BREAKER_OPENS, consumer=consumer
                ).inc()

        return hook

    def fault_hook(self):
        """fn(surface, action) for FaultInjector.on_fire: per-surface
        injected-fault counts, so a chaos run's blast radius reads
        straight off /metrics."""

        def hook(surface: str, action: str) -> None:
            self.registry.counter(
                FAULTS_INJECTED, surface=surface, action=action
            ).inc()

        return hook


class TransportTelemetry:
    """`foundry.spark.scheduler.server.*` — HTTP transport internals.

    The event-loop transport mutates the phase accumulators (`parse_s`,
    `queue_s`, `write_s`, `bytes_in/out`) directly from its single loop
    thread — no lock on the hot path; the method hooks (connections,
    requests, sheds) take the lock because the threaded transport calls
    them from many handler threads. `stats()` renders the snapshot that
    GET /metrics surfaces (JSON key `server_transport`, Prometheus extra
    gauges under the server prefix) — the same pull discipline as the
    predicate batcher's stats."""

    def __init__(self, transport: str, ingest: str = "python"):
        self.transport = transport
        # Which ingest lane the server resolved to (post-degrade): rides
        # the transport snapshot so a scrape shows transport x ingest.
        self.ingest = ingest
        self._lock = threading.Lock()
        self.open_connections = 0
        self.connections_total = 0
        self.requests_total = 0
        # Requests beyond the first on a persistent connection: the
        # keep-alive reuse the transport actually delivered.
        self.keepalive_requests = 0
        self.connection_sheds = 0  # max-connections 503s
        self.queue_sheds = 0  # batcher-depth 503s (routing layer)
        self.body_rejections = 0  # max-body-bytes 413s
        # Phase accumulators (seconds + sample counts): request parse,
        # dispatch->respond (the batcher window for predicates), and
        # response assembly+write.
        self.parse_s = 0.0
        self.parse_samples = 0
        self.queue_s = 0.0
        self.queue_samples = 0
        self.write_s = 0.0
        self.write_samples = 0
        self.bytes_in = 0
        self.bytes_out = 0

    def on_connection_open(self) -> None:
        with self._lock:
            self.open_connections += 1
            self.connections_total += 1

    def on_connection_close(self) -> None:
        with self._lock:
            self.open_connections = max(0, self.open_connections - 1)

    def on_connection_shed(self) -> None:
        with self._lock:
            self.connection_sheds += 1

    def on_queue_shed(self) -> None:
        with self._lock:
            self.queue_sheds += 1

    def on_request(self, *, reused: bool) -> None:
        with self._lock:
            self.requests_total += 1
            if reused:
                self.keepalive_requests += 1

    def on_body_rejected(self) -> None:
        with self._lock:
            self.body_rejections += 1

    def on_bytes_out(self, nbytes: int) -> None:
        with self._lock:
            self.bytes_out += nbytes

    @staticmethod
    def _mean_ms(total_s: float, samples: int):
        return round(total_s * 1e3 / samples, 4) if samples else None

    def stats(self) -> dict:
        requests = self.requests_total
        return {
            "transport": self.transport,
            "ingest": self.ingest,
            "open_connections": self.open_connections,
            "connections_total": self.connections_total,
            "requests_total": requests,
            "keepalive_requests": self.keepalive_requests,
            "keepalive_reuse_ratio": round(
                self.keepalive_requests / requests, 4
            )
            if requests
            else 0.0,
            "connection_sheds": self.connection_sheds,
            "queue_sheds": self.queue_sheds,
            "body_rejections": self.body_rejections,
            "parse_mean_ms": self._mean_ms(self.parse_s, self.parse_samples),
            "queue_mean_ms": self._mean_ms(self.queue_s, self.queue_samples),
            "write_mean_ms": self._mean_ms(self.write_s, self.write_samples),
            "bytes_in": self.bytes_in,
            "bytes_out": self.bytes_out,
        }
