"""KubeBackend — the ClusterBackend over a real Kubernetes apiserver.

The last process boundary of the reference (SURVEY.md §3.5): reservation
and demand writes go to the apiserver as CRs through rate-limited typed
clients (cmd/server.go:57-96 builds clientsets with config QPS/Burst;
internal/cache/async.go drives them), while the local store remains the
read path and watch streams carry external changes back.

This backend extends InMemoryBackend so every component (caches, managers,
reconciler) works unchanged:

  - pods / nodes: read-only, fed by KubeIngestion reflectors (the app
    wires those when kube-api-url is set);
  - resourcereservations / demands: create/update/delete are forwarded to
    the apiserver REST API FIRST (409 -> ConflictError/AlreadyExistsError,
    404 -> NotFoundError — the AsyncClient's retry ladder maps 1:1), then
    applied locally with the apiserver-assigned resourceVersion;
  - their watch streams echo back: external ADDs/DELETEs apply fully
    (failover: a new leader sees the previous leader's reservations),
    while MODIFIEDs of locally-owned objects only fast-forward the
    resourceVersion — the cache owner is the sole writer
    (internal/cache/cache.go:106-133 tryOverrideResourceVersion);
  - the CRD registry reads/writes apiextensions
    customresourcedefinitions through the same API;
  - every REST call passes a token-bucket rate limiter (config QPS/Burst,
    config/config.go:30-31).
"""

from __future__ import annotations

import http.client
import json
import threading
import time
from typing import Any, Optional
from urllib.parse import urlparse

from spark_scheduler_tpu_torch.store.backend import (
    AlreadyExistsError,
    BackendError,
    ConflictError,
    InMemoryBackend,
    NamespaceTerminatingError,
    NotFoundError,
)

RR_PATH = "/apis/sparkscheduler.palantir.com/v1beta2"
DEMAND_PATH = "/apis/scaler.palantir.com/v1alpha2"
CRD_PATH = "/apis/apiextensions.k8s.io/v1/customresourcedefinitions"


class TokenBucket:
    """Client-side rate limiter (client-go flowcontrol slot; config
    qps/burst, config/config.go:30-31). acquire() blocks until a token is
    available."""

    def __init__(self, qps: float, burst: int, clock=time.monotonic, sleep=time.sleep):
        self.qps = float(qps)
        self.burst = max(1, int(burst))
        self._tokens = float(self.burst)
        self._last = clock()
        self._clock = clock
        self._sleep = sleep
        self._lock = threading.Lock()

    def acquire(self) -> None:
        while True:
            with self._lock:
                now = self._clock()
                self._tokens = min(
                    self.burst, self._tokens + (now - self._last) * self.qps
                )
                self._last = now
                if self._tokens >= 1.0:
                    self._tokens -= 1.0
                    return
                wait = (1.0 - self._tokens) / self.qps
            self._sleep(wait)


class RestClient:
    """Minimal JSON REST client with TLS/bearer auth + rate limiting."""

    def __init__(
        self,
        base_url: str,
        rate_limiter: Optional[TokenBucket] = None,
        ca_file: Optional[str] = None,
        token_file: Optional[str] = None,
        insecure_skip_tls_verify: bool = False,
        timeout_s: float = 10.0,
        metrics=None,
    ):
        # `metrics`: a MetricRegistry; each request records a latency
        # histogram tagged by verb + outcome family (the reference's
        # client-latency adapters, internal/metrics/metrics.go:253-297).
        self._metrics = metrics
        parsed = urlparse(base_url)
        self._host = parsed.hostname or "127.0.0.1"
        self._tls = parsed.scheme == "https"
        self._port = parsed.port or (443 if self._tls else 80)
        self._ca_file = ca_file
        self._token_file = token_file
        self._insecure = insecure_skip_tls_verify
        self._timeout_s = timeout_s
        self._limiter = rate_limiter

    def _connect(self) -> http.client.HTTPConnection:
        if not self._tls:
            return http.client.HTTPConnection(
                self._host, self._port, timeout=self._timeout_s
            )
        import ssl

        ctx = ssl.create_default_context(cafile=self._ca_file)
        if self._insecure:
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
        return http.client.HTTPSConnection(
            self._host, self._port, timeout=self._timeout_s, context=ctx
        )

    def _headers(self) -> dict[str, str]:
        headers = {"Content-Type": "application/json"}
        if self._token_file:
            try:
                with open(self._token_file, "r", encoding="utf-8") as f:
                    headers["Authorization"] = f"Bearer {f.read().strip()}"
            except OSError:
                pass
        return headers

    def request(self, method: str, path: str, payload: Optional[dict] = None):
        if self._limiter is not None:
            self._limiter.acquire()
        start = time.perf_counter()
        status = 0
        conn = self._connect()
        try:
            conn.request(
                method,
                path,
                body=json.dumps(payload).encode() if payload is not None else None,
                headers=self._headers(),
            )
            resp = conn.getresponse()
            raw = resp.read()
            body = json.loads(raw) if raw else {}
            status = resp.status
            return status, body
        finally:
            conn.close()
            if self._metrics is not None:
                self._metrics.histogram(
                    "foundry.spark.scheduler.kubeclient.request",
                    verb=method,
                    family=f"{status // 100}xx" if status else "error",
                ).update(time.perf_counter() - start)


def _raise_for_status(status: int, body: dict, context: str) -> None:
    reason = body.get("reason", "")
    message = body.get("message", "")
    if status == 409 and reason == "AlreadyExists":
        raise AlreadyExistsError(f"{context}: {message}")
    if status == 409:
        raise ConflictError(f"{context}: {message}")
    if status == 403 and reason == "NamespaceTerminating":
        # Not retryable: the async write-back drops the create outright
        # (async.go:88-96).
        raise NamespaceTerminatingError(f"{context}: {message}")
    if status == 404:
        raise NotFoundError(f"{context}: {message}")
    if status == 422:
        raise BackendError(f"{context}: invalid: {message}")
    if status >= 400:
        raise BackendError(f"{context}: HTTP {status}: {message}")


class KubeBackend(InMemoryBackend):
    def __init__(
        self,
        base_url: str,
        qps: float = 5.0,
        burst: int = 10,
        ca_file: Optional[str] = None,
        token_file: Optional[str] = None,
        insecure_skip_tls_verify: bool = False,
        watch: bool = True,
        watch_timeout_s: float = 30.0,
        metrics=None,
    ):
        super().__init__()
        self._crds.clear()  # the apiserver's CRD registry is authoritative
        self.rate_limiter = TokenBucket(qps, burst)
        self._rest = RestClient(
            base_url,
            rate_limiter=self.rate_limiter,
            ca_file=ca_file,
            token_file=token_file,
            insecure_skip_tls_verify=insecure_skip_tls_verify,
            metrics=metrics,
        )
        self._base_url = base_url
        self._watch = watch
        self._watch_timeout_s = watch_timeout_s
        self._ca_file = ca_file
        self._token_file = token_file
        self._insecure = insecure_skip_tls_verify
        self._reflectors: list = []

    # -- codecs / paths ------------------------------------------------------

    @staticmethod
    def _codec(kind: str):
        from spark_scheduler_tpu_torch.server import conversion as C

        if kind == "resourcereservations":
            return C.rr_v1beta2_to_wire, C.rr_v1beta2_from_wire
        if kind == "demands":
            return C.demand_v1alpha2_to_wire, C.demand_v1alpha2_from_wire
        raise KeyError(kind)

    @staticmethod
    def _collection(kind: str, namespace: Optional[str] = None) -> str:
        base = RR_PATH if kind == "resourcereservations" else DEMAND_PATH
        if namespace:
            return f"{base}/namespaces/{namespace}/{kind}"
        return f"{base}/{kind}"

    def _is_remote(self, kind: str) -> bool:
        return kind in ("resourcereservations", "demands")

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        """Initial REST list of reservations + demands into the local store
        (cache fill, cache/resourcereservations.go:53-60), then watch from
        the listed resourceVersion."""
        from spark_scheduler_tpu_torch.kube.reflector import BackendSyncTarget, Reflector

        for kind in ("resourcereservations", "demands"):
            _, from_wire = self._codec(kind)
            target = _ExternalTarget(self, kind)
            reflector = Reflector(
                self._base_url,
                self._collection(kind),
                from_wire,
                target,
                name=kind,
                watch_timeout_s=self._watch_timeout_s,
                ca_file=self._ca_file,
                token_file=self._token_file,
                insecure_skip_tls_verify=self._insecure,
                # A 404'd collection means its CRD isn't installed yet:
                # sync as empty and poll slowly. The reservation CRD is
                # created by the scheduler itself moments later
                # (ensure_resource_reservations_crd), so it re-polls fast;
                # the Demand CRD belongs to the external autoscaler and
                # may never appear (demand_informer.go:75-97).
                tolerate_absent=True,
                absent_poll_s=5.0 if kind == "resourcereservations" else 60.0,
            )
            if self._watch:
                reflector.start()
                self._reflectors.append(reflector)
            else:
                reflector._list()  # one synchronous fill

    def wait_synced(self, timeout: Optional[float] = None) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        for r in self._reflectors:
            remaining = (
                None if deadline is None else max(0.0, deadline - time.monotonic())
            )
            if not r.wait_synced(remaining):
                return False
        return True

    def stop(self) -> None:
        for r in self._reflectors:
            r.stop()
        self._reflectors.clear()

    # -- remote-kind CRUD ----------------------------------------------------

    def create(self, kind: str, obj: Any) -> Any:
        if not self._is_remote(kind):
            return super().create(kind, obj)
        to_wire, from_wire = self._codec(kind)
        ns = getattr(obj, "namespace", "")
        status, body = self._rest.request(
            "POST", self._collection(kind, ns), to_wire(obj)
        )
        _raise_for_status(status, body, f"create {kind} {ns}/{obj.name}")
        created = from_wire(body)
        self._apply_external(kind, created, replace=True)
        return created

    def update(self, kind: str, obj: Any) -> Any:
        if not self._is_remote(kind):
            return super().update(kind, obj)
        to_wire, from_wire = self._codec(kind)
        ns = getattr(obj, "namespace", "")
        status, body = self._rest.request(
            "PUT", f"{self._collection(kind, ns)}/{obj.name}", to_wire(obj)
        )
        _raise_for_status(status, body, f"update {kind} {ns}/{obj.name}")
        updated = from_wire(body)
        self._apply_external(kind, updated, replace=True)
        return updated

    def delete(self, kind: str, namespace: str, name: str) -> None:
        if not self._is_remote(kind):
            return super().delete(kind, namespace, name)
        status, body = self._rest.request(
            "DELETE", f"{self._collection(kind, namespace)}/{name}"
        )
        _raise_for_status(status, body, f"delete {kind} {namespace}/{name}")
        self._remove_local(kind, namespace, name)

    def get(self, kind: str, namespace: str, name: str) -> Optional[Any]:
        """Remote kinds re-read through the API — the AsyncClient's conflict
        fast-forward (async.go:111-120) needs the apiserver's CURRENT
        resourceVersion, not the possibly-stale local echo."""
        if not self._is_remote(kind):
            return super().get(kind, namespace, name)
        _, from_wire = self._codec(kind)
        try:
            status, body = self._rest.request(
                "GET", f"{self._collection(kind, namespace)}/{name}"
            )
        except OSError:
            return super().get(kind, namespace, name)
        if status == 404:
            return None
        if status != 200:
            return super().get(kind, namespace, name)
        obj = from_wire(body)
        self._apply_external(kind, obj)  # rv fast-forward if already known
        return obj

    # -- external application (watch echoes, failover fills) -----------------
    # Objects carry APISERVER resourceVersions; the base class's local rv
    # counter never touches remote kinds (it would clobber the apiserver rv
    # and wedge every subsequent PUT in 409s), so application manipulates
    # the store directly and fires handlers itself.

    def _apply_external(self, kind: str, obj: Any, replace: bool = False) -> None:
        """Unknown keys apply fully (fires add handlers — failover
        discovery); known keys fast-forward the resourceVersion, replacing
        the object (firing update) only for our own write's response
        (`replace=True`) — the cache owner is the sole writer, external
        MODIFIEDs only bump the rv (cache.go:106-133)."""
        key = (getattr(obj, "namespace", ""), obj.name)
        event = None
        with self._lock:
            cur = self._objects[kind].get(key)
            if cur is None:
                self._objects[kind][key] = obj
                event = ("add", (obj,))
            elif replace:
                self._objects[kind][key] = obj
                event = ("update", (cur, obj))
            else:
                obj_rv = getattr(obj, "resource_version", 0)
                if getattr(cur, "resource_version", 0) < obj_rv:
                    cur.resource_version = obj_rv
        if event is not None:
            self._fire(kind, event[0], *event[1])

    def _remove_local(self, kind: str, namespace: str, name: str) -> None:
        with self._lock:
            cur = self._objects[kind].pop((namespace, name), None)
        if cur is not None:
            self._fire(kind, "delete", cur)

    # -- CRD registry over apiextensions ------------------------------------

    def register_crd(self, name: str, definition: Optional[dict] = None) -> None:
        if definition is None:
            from spark_scheduler_tpu_torch.models.crds import (
                DEMAND_CRD_NAME,
                RESERVATION_CRD_NAME,
                demand_crd,
                resource_reservation_crd,
            )

            if name == DEMAND_CRD_NAME:
                definition = demand_crd()
            elif name == RESERVATION_CRD_NAME:
                definition = resource_reservation_crd()
            else:
                definition = {
                    "apiVersion": "apiextensions.k8s.io/v1",
                    "kind": "CustomResourceDefinition",
                    "metadata": {"name": name},
                    "spec": {"names": {"plural": name.split(".")[0]}},
                }
        status, body = self._rest.request("POST", CRD_PATH, definition)
        if status == 409:
            # create-or-upgrade (crd/utils.go:98-133): fetch current rv, PUT
            get_status, current = self._rest.request("GET", f"{CRD_PATH}/{name}")
            if get_status == 200:
                definition = dict(definition)
                definition.setdefault("metadata", {})
                definition["metadata"] = {
                    **definition["metadata"],
                    "resourceVersion": current.get("metadata", {}).get(
                        "resourceVersion", ""
                    ),
                }
                status, body = self._rest.request(
                    "PUT", f"{CRD_PATH}/{name}", definition
                )
        if status not in (200, 201):
            raise BackendError(f"register CRD {name}: HTTP {status}")
        super().register_crd(name, definition)

    def crd_exists(self, name: str) -> bool:
        # Positive results are cached locally: SafeDemandCache gates every
        # demand operation on this, and a REST GET per gate would burn the
        # rate budget (established CRDs effectively never disappear; the
        # reference also only checks until first establishment).
        if super().crd_exists(name):
            return True
        try:
            status, _ = self._rest.request("GET", f"{CRD_PATH}/{name}")
        except OSError:
            return False
        if status == 200:
            with self._lock:
                self._crds.add(name)
            return True
        return False

    def unregister_crd(self, name: str) -> None:
        self._rest.request("DELETE", f"{CRD_PATH}/{name}")
        super().unregister_crd(name)


class _ExternalTarget:
    """Reflector sync target for apiserver-owned reservation/demand echoes
    (the informer hookup of the write-through cache, cache.go:95-133)."""

    def __init__(self, backend: KubeBackend, kind: str):
        self._backend = backend
        self._kind = kind

    def replace(self, objects: list) -> None:
        known = {
            (getattr(o, "namespace", ""), o.name): o
            for o in self._backend.list(self._kind)
        }
        fresh = {(getattr(o, "namespace", ""), o.name): o for o in objects}
        for key, obj in fresh.items():
            self._backend._apply_external(self._kind, obj)
        for key, obj in known.items():
            if key not in fresh:
                self._backend._remove_local(self._kind, key[0], key[1])

    def add(self, obj) -> None:
        self._backend._apply_external(self._kind, obj)

    def update(self, obj) -> None:
        self._backend._apply_external(self._kind, obj)

    def delete(self, obj) -> None:
        self._backend._remove_local(
            self._kind, getattr(obj, "namespace", ""), obj.name
        )
