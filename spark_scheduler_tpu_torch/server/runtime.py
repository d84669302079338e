"""Refreshable runtime configuration.

The reference embeds witchcraft Install+Runtime config
(/root/reference/config/config.go:24-47): install config is immutable for
the process lifetime, while RUNTIME config (logging level etc.) reloads
without a restart. This module is that slot: a `RuntimeConfig` read from a
YAML file, re-applied live when the file changes (mtime poll) or on SIGHUP.

Reloadable knobs:
  logging.level                -> svc1log minimum level
  fifo                         -> ExtenderConfig.fifo
  batched-admission            -> ExtenderConfig.batched_admission
  async-client-retry-count     -> write-back retry budget of both caches
  autoscaler.idle-ttl          -> ScaleDownDrainer idle TTL (live resize of
                                  the scale-down window)
  autoscaler.max-cluster-size  -> ElasticAutoscaler provisioning cap

Unknown keys are ignored (forward compatibility); a missing/unparseable
file keeps the last good config (witchcraft behaviour: a bad runtime refresh
must never take down the server).
"""

from __future__ import annotations

import dataclasses
import gc
import os
import signal
import threading
from typing import Optional


def freeze_boot_heap() -> int:
    """Move every object allocated during boot into the GC's permanent
    generation (`gc.freeze`) so steady-state collections never re-scan the
    multi-hundred-MB boot heap — solver tensors, compiled-program wrappers,
    caches. The 1M-node bench showed full gen-2 sweeps over the boot heap
    as a serving-tail spike (production-tail hardening in
    the server itself, not just the bench). Called once from
    SchedulerApp.start_background() after construction; idempotent — a
    second call freezes only what was allocated since. Returns the number
    of objects now frozen."""
    gc.collect()
    gc.freeze()
    return gc.get_freeze_count()


@dataclasses.dataclass
class RuntimeConfig:
    """The reloadable subset (config.go:24-47 Runtime embed)."""

    log_level: Optional[str] = None
    fifo: Optional[bool] = None
    batched_admission: Optional[bool] = None
    async_client_retry_count: Optional[int] = None
    autoscaler_idle_ttl_s: Optional[float] = None
    autoscaler_max_cluster_size: Optional[int] = None

    @classmethod
    def from_dict(cls, raw: dict) -> "RuntimeConfig":
        logging_block = raw.get("logging") or {}
        level = logging_block.get("level", raw.get("log-level"))
        fifo = raw.get("fifo")
        batched = raw.get("batched-admission")
        retries = raw.get("async-client-retry-count")
        autoscaler_block = raw.get("autoscaler") or {}
        idle_ttl = autoscaler_block.get("idle-ttl")
        max_cluster = autoscaler_block.get("max-cluster-size")
        if idle_ttl is not None:
            from spark_scheduler_tpu_torch.server.config import _parse_duration

            idle_ttl = _parse_duration(idle_ttl)
        return cls(
            log_level=str(level) if level is not None else None,
            fifo=bool(fifo) if fifo is not None else None,
            batched_admission=bool(batched) if batched is not None else None,
            async_client_retry_count=int(retries) if retries is not None else None,
            autoscaler_idle_ttl_s=idle_ttl,
            autoscaler_max_cluster_size=(
                int(max_cluster) if max_cluster is not None else None
            ),
        )


class RuntimeConfigManager:
    """Watches a runtime-config YAML and applies changes to a live app.

    `check_now()` is the reload primitive (used by the file-watch thread,
    the SIGHUP handler, and tests); `start()` begins the watch thread and
    installs the SIGHUP handler when running on the main thread."""

    def __init__(self, app, path: str, poll_interval_s: float = 2.0):
        self._app = app
        self._path = path
        self._poll_interval_s = poll_interval_s
        self._mtime: float | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.current = RuntimeConfig()
        self.reloads = 0

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self.check_now()
        self._thread = threading.Thread(
            target=self._watch, daemon=True, name="runtime-config-watch"
        )
        self._thread.start()
        try:
            signal.signal(signal.SIGHUP, lambda *_: self.check_now(force=True))
        except ValueError:
            pass  # not the main thread (embedded/test use) — file watch only

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self._poll_interval_s + 1)

    def _watch(self) -> None:
        while not self._stop.wait(self._poll_interval_s):
            self.check_now()

    # -- reload --------------------------------------------------------------

    def check_now(self, force: bool = False) -> bool:
        """Reload if the file changed (or `force`). Returns True when a new
        config was applied."""
        try:
            mtime = os.stat(self._path).st_mtime
        except OSError:
            return False
        if not force and mtime == self._mtime:
            return False
        self._mtime = mtime
        try:
            import yaml

            with open(self._path) as f:
                raw = yaml.safe_load(f) or {}
            cfg = RuntimeConfig.from_dict(raw)
        except Exception as exc:  # bad refresh keeps the last good config
            from spark_scheduler_tpu_torch.tracing import svc1log

            svc1log().warn(
                "runtime config refresh failed; keeping previous",
                path=self._path,
                error=repr(exc),
            )
            return False
        self.apply(cfg)
        return True

    def apply(self, cfg: RuntimeConfig) -> None:
        from spark_scheduler_tpu_torch.tracing import svc1log

        app = self._app
        if cfg.log_level is not None:
            svc1log().set_level(cfg.log_level)
        if cfg.fifo is not None:
            app.extender._config.fifo = cfg.fifo
        if cfg.batched_admission is not None:
            app.extender._config.batched_admission = cfg.batched_admission
        if cfg.async_client_retry_count is not None:
            for cache in (app.rr_cache, app.demand_cache):
                setter = getattr(cache, "set_max_retries", None)
                if setter is not None:
                    setter(cfg.async_client_retry_count)
        autoscaler = getattr(app, "autoscaler", None)
        if autoscaler is not None:
            if cfg.autoscaler_idle_ttl_s is not None:
                autoscaler.drainer.idle_ttl_s = cfg.autoscaler_idle_ttl_s
            if cfg.autoscaler_max_cluster_size is not None:
                autoscaler.max_cluster_size = cfg.autoscaler_max_cluster_size
        self.current = cfg
        self.reloads += 1
        svc1log().info(
            "runtime config applied",
            log_level=cfg.log_level,
            fifo=cfg.fifo,
            batched_admission=cfg.batched_admission,
            async_client_retry_count=cfg.async_client_retry_count,
            autoscaler_idle_ttl_s=cfg.autoscaler_idle_ttl_s,
            autoscaler_max_cluster_size=cfg.autoscaler_max_cluster_size,
        )
