"""List+watch reflectors feeding the ClusterBackend.

The client-go informer slot (SURVEY.md L3): the reference builds a
SharedInformerFactory per API group, lists then watches each resource,
and hands add/update/delete events to components (cmd/server.go:111-147).
`Reflector` reproduces the reflector/informer contract natively:

  1. LIST the collection, remember the collection resourceVersion,
     replace the local state wholesale (firing synthetic deletes for
     objects that vanished during a watch gap);
  2. WATCH from that resourceVersion, applying ADDED/MODIFIED/DELETED
     incrementally and advancing the resume point with every event;
  3. on stream end / network error: re-watch from the last seen
     resourceVersion (resume, no relist);
  4. on `410 Gone` (history expired): relist, then watch again — the
     informer resync path;
  5. `wait_synced` = WaitForCacheSync (cmd/server.go:140-147).

`KubeIngestion` wires node + pod reflectors into a ClusterBackend and
measures the creation→ingestion delay histogram the reference records per
informer add (internal/metrics/informer.go:28-51).
"""

from __future__ import annotations

import http.client
import json
import threading
import time
from typing import Any, Callable, Optional
from urllib.parse import urlparse

from spark_scheduler_tpu_torch.faults.retry import RetryPolicy
from spark_scheduler_tpu_torch.server.kube_io import node_from_k8s, pod_from_k8s

LIST_TIMEOUT_S = 10.0
WATCH_TIMEOUT_S = 30.0  # per-request watch window; the loop re-arms
RELIST_BACKOFF_S = 0.2
RELIST_BACKOFF_CAP_S = 30.0  # a down apiserver is probed, not hammered
INFORMER_DELAY_METRIC = "foundry.spark.scheduler.informer.delay"


class GoneError(Exception):
    """Watch history expired (HTTP 410 / ERROR event) — relist required."""


class CollectionAbsentError(Exception):
    """404 on a tolerate_absent collection (CRD not installed yet) — sync
    as empty, poll slowly until the CRD appears (demand_informer.go:75-97
    semantics: the Demand CRD belongs to the external autoscaler)."""


class BackendSyncTarget:
    """Applies decoded watch events to a ClusterBackend kind, diffing
    wholesale relists into the add/update/delete stream subscribers expect
    (the informer cache replace semantics)."""

    def __init__(
        self,
        backend,
        kind: str,
        on_add: Optional[Callable[[Any], None]] = None,
    ):
        self._backend = backend
        self._kind = kind
        self._on_add = on_add

    @staticmethod
    def _key(obj) -> tuple[str, str]:
        return (getattr(obj, "namespace", ""), obj.name)

    def replace(self, objects: list) -> None:
        new = {self._key(o): o for o in objects}
        current = {self._key(o): o for o in self._backend.list(self._kind)}
        for key, obj in current.items():
            if key not in new:
                self._backend.delete(self._kind, key[0], key[1])
        for key, obj in new.items():
            if key in current:
                if current[key] != obj:  # dataclass field equality
                    self._backend.update(self._kind, obj)
            else:
                self._backend.create(self._kind, obj)
                if self._on_add:
                    self._on_add(obj)

    def add(self, obj) -> None:
        if self._backend.get(self._kind, *self._key(obj)) is None:
            self._backend.create(self._kind, obj)
            if self._on_add:
                self._on_add(obj)
        else:
            self._backend.update(self._kind, obj)

    def update(self, obj) -> None:
        if self._backend.get(self._kind, *self._key(obj)) is None:
            self.add(obj)
        else:
            self._backend.update(self._kind, obj)

    def delete(self, obj) -> None:
        key = self._key(obj)
        if self._backend.get(self._kind, *key) is not None:
            self._backend.delete(self._kind, key[0], key[1])


class Reflector:
    """One resource's list+watch loop against a k8s-API base URL."""

    def __init__(
        self,
        base_url: str,
        collection_path: str,
        decode: Callable[[dict], Any],
        target: BackendSyncTarget,
        name: str = "",
        watch_timeout_s: float = WATCH_TIMEOUT_S,
        relist_backoff_s: float = RELIST_BACKOFF_S,
        retry_policy: Optional[RetryPolicy] = None,
        ca_file: Optional[str] = None,
        token_file: Optional[str] = None,
        insecure_skip_tls_verify: bool = False,
        tolerate_absent: bool = False,
        absent_poll_s: float = 60.0,
    ):
        """`ca_file`/`token_file` enable in-cluster operation against a real
        apiserver (https://kubernetes.default.svc with the serviceaccount CA
        bundle + bearer token, the client-go rest.InClusterConfig slot).
        The token file is re-read per connection: serviceaccount tokens are
        rotated by the kubelet. https endpoints are ALWAYS verified
        (against `ca_file` or the system CAs) unless
        `insecure_skip_tls_verify` is explicitly set."""
        parsed = urlparse(base_url)
        self._host = parsed.hostname or "127.0.0.1"
        self._tls = parsed.scheme == "https"
        self._port = parsed.port or (443 if self._tls else 80)
        self._ca_file = ca_file
        self._token_file = token_file
        self._insecure = insecure_skip_tls_verify
        self._token_error_logged = False
        self._tolerate_absent = tolerate_absent
        self._absent_poll_s = absent_poll_s
        self._path = collection_path
        self._decode = decode
        self._target = target
        self.name = name or collection_path
        self._watch_timeout_s = watch_timeout_s
        self._relist_backoff_s = relist_backoff_s
        # Relist/rewatch backoff: `relist_backoff_s` is the policy's BASE
        # — consecutive failures back off exponentially (full jitter,
        # capped), so a down apiserver is probed, not hammered, and any
        # successful list or watch window resets the ladder.
        # max_attempts=None: a reflector retries forever by contract.
        self._retry_policy = retry_policy or RetryPolicy(
            max_attempts=None,
            base_delay_s=relist_backoff_s,
            multiplier=2.0,
            max_delay_s=RELIST_BACKOFF_CAP_S,
        )
        self._consecutive_failures = 0
        self.backoff_total_s = 0.0  # observable: cumulative backoff slept
        self._stop = threading.Event()
        self._synced = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._conn_lock = threading.Lock()
        self._watch_conn: Optional[http.client.HTTPConnection] = None
        self.last_resource_version = 0
        self.relist_count = 0  # observable: how many LISTs happened

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"reflector-{self.name}"
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        with self._conn_lock:
            if self._watch_conn is not None:
                try:
                    # shutdown() (not just close()) so a reader blocked in
                    # recv() on another thread wakes immediately.
                    sock = self._watch_conn.sock
                    if sock is not None:
                        import socket as _socket

                        sock.shutdown(_socket.SHUT_RDWR)
                    self._watch_conn.close()
                except OSError:
                    pass
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def has_synced(self) -> bool:
        return self._synced.is_set()

    # -- backoff ------------------------------------------------------------

    def _note_success(self) -> None:
        self._consecutive_failures = 0

    def _failure_backoff(self) -> float:
        """Delay before the next attempt: exponential in the consecutive-
        failure count, full-jittered, capped. Split from the wait so
        tests pin the ladder without a live socket."""
        delay = self._retry_policy.delay(self._consecutive_failures)
        self._consecutive_failures += 1
        return delay

    def _backoff_wait(self) -> None:
        delay = self._failure_backoff()
        self.backoff_total_s += delay
        self._stop.wait(delay)

    def wait_synced(self, timeout: Optional[float] = None) -> bool:
        return self._synced.wait(timeout)

    # -- the loop -----------------------------------------------------------

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self._list_and_watch()
            except GoneError:
                continue  # relist immediately
            except CollectionAbsentError:
                # Synced-as-empty; poll slowly for the CRD to appear —
                # never hammer the apiserver over a missing collection.
                self._synced.set()
                self._stop.wait(self._absent_poll_s)
            except Exception:
                if self._stop.is_set():
                    return
                self._backoff_wait()

    def _list_and_watch(self) -> None:
        rv = self._list()
        self.last_resource_version = rv
        self._synced.set()
        self._note_success()
        while not self._stop.is_set():
            try:
                self._watch_once()
                # A watch window that ended cleanly (server closed it, or
                # events flowed) means the apiserver is healthy again.
                self._note_success()
            except (GoneError, CollectionAbsentError):
                raise
            except (OSError, http.client.HTTPException):
                if self._stop.is_set():
                    return
                # Transient stream loss: resume from the last seen rv
                # without relisting (reflector resume semantics), backing
                # off on consecutive failures.
                self._backoff_wait()

    def _connect(self, timeout: float) -> http.client.HTTPConnection:
        if not self._tls:
            return http.client.HTTPConnection(self._host, self._port, timeout=timeout)
        import ssl

        # Secure by default: ca_file if given, else the system trust store.
        # Verification is only disabled on an EXPLICIT insecure opt-in — a
        # missing CA must fail loudly, not silently accept any peer (the
        # watch stream is the scheduler's entire world view).
        ctx = ssl.create_default_context(cafile=self._ca_file)
        if self._insecure:
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
        return http.client.HTTPSConnection(
            self._host, self._port, timeout=timeout, context=ctx
        )

    def _headers(self) -> dict[str, str]:
        if not self._token_file:
            return {}
        try:
            with open(self._token_file, "r", encoding="utf-8") as f:
                return {"Authorization": f"Bearer {f.read().strip()}"}
        except OSError as exc:
            # A configured-but-unreadable token means every request will be
            # rejected 401 — say so once instead of silently retrying
            # unauthenticated forever.
            if not self._token_error_logged:
                self._token_error_logged = True
                from spark_scheduler_tpu_torch.tracing import svc1log

                svc1log().warn(
                    "serviceaccount token unreadable; requests go out "
                    "unauthenticated",
                    tokenFile=self._token_file,
                    error=repr(exc),
                    reflector=self.name,
                )
            return {}

    def _list(self) -> int:
        conn = self._connect(LIST_TIMEOUT_S)
        try:
            conn.request("GET", self._path, headers=self._headers())
            resp = conn.getresponse()
            if resp.status == 404 and self._tolerate_absent:
                resp.read()
                self.relist_count += 1
                self._target.replace([])
                raise CollectionAbsentError(self._path)
            if resp.status != 200:
                raise http.client.HTTPException(f"list {self._path}: {resp.status}")
            body = json.loads(resp.read())
        finally:
            conn.close()
        self.relist_count += 1
        items = [self._decode(raw) for raw in body.get("items", [])]
        self._target.replace(items)
        try:
            return int((body.get("metadata") or {}).get("resourceVersion") or 0)
        except ValueError:
            return 0

    def _watch_once(self) -> None:
        conn = self._connect(self._watch_timeout_s + LIST_TIMEOUT_S)
        with self._conn_lock:
            self._watch_conn = conn
        try:
            conn.request(
                "GET",
                f"{self._path}?watch=true"
                f"&resourceVersion={self.last_resource_version}"
                f"&timeoutSeconds={self._watch_timeout_s:g}",
                headers=self._headers(),
            )
            resp = conn.getresponse()
            if resp.status == 410:
                raise GoneError()
            if resp.status == 404 and self._tolerate_absent:
                raise CollectionAbsentError(self._path)
            if resp.status != 200:
                raise http.client.HTTPException(f"watch {self._path}: {resp.status}")
            while not self._stop.is_set():
                line = resp.readline()
                if not line:
                    return  # server closed the window; re-arm
                line = line.strip()
                if not line:
                    continue
                event = json.loads(line)
                self._apply(event)
        finally:
            with self._conn_lock:
                self._watch_conn = None
            conn.close()

    def _apply(self, event: dict) -> None:
        etype = event.get("type")
        raw = event.get("object") or {}
        if etype == "ERROR":
            if raw.get("code") == 410:
                raise GoneError()
            raise http.client.HTTPException(f"watch error: {raw}")
        if etype == "BOOKMARK":
            rv = (raw.get("metadata") or {}).get("resourceVersion")
            if rv:
                self.last_resource_version = int(rv)
            return
        obj = self._decode(raw)
        if etype == "ADDED":
            self._target.add(obj)
        elif etype == "MODIFIED":
            self._target.update(obj)
        elif etype == "DELETED":
            self._target.delete(obj)
        rv = (raw.get("metadata") or {}).get("resourceVersion")
        if rv:
            try:
                self.last_resource_version = int(rv)
            except ValueError:
                pass


class KubeIngestion:
    """Node + pod reflectors for a scheduler app — the informer-factory
    slot of initServer (cmd/server.go:111-147). Also records the
    pod-creation→ingestion delay histogram (internal/metrics/informer.go:
    28-51: time from pod creationTimestamp to the informer add callback)."""

    def __init__(
        self,
        backend,
        base_url: str,
        metrics=None,
        clock: Callable[[], float] = time.time,
        watch_timeout_s: float = WATCH_TIMEOUT_S,
        ca_file: Optional[str] = None,
        token_file: Optional[str] = None,
        insecure_skip_tls_verify: bool = False,
    ):
        def on_pod_add(pod) -> None:
            if metrics is not None and pod.creation_timestamp:
                delay = max(0.0, clock() - pod.creation_timestamp)
                metrics.histogram(INFORMER_DELAY_METRIC, kind="pods").update(delay)

        self.node_reflector = Reflector(
            base_url,
            "/api/v1/nodes",
            node_from_k8s,
            BackendSyncTarget(backend, "nodes"),
            name="nodes",
            watch_timeout_s=watch_timeout_s,
            ca_file=ca_file,
            token_file=token_file,
            insecure_skip_tls_verify=insecure_skip_tls_verify,
        )
        self.pod_reflector = Reflector(
            base_url,
            "/api/v1/pods",
            pod_from_k8s,
            BackendSyncTarget(backend, "pods", on_add=on_pod_add),
            name="pods",
            watch_timeout_s=watch_timeout_s,
            ca_file=ca_file,
            token_file=token_file,
            insecure_skip_tls_verify=insecure_skip_tls_verify,
        )
        self.reflectors = [self.node_reflector, self.pod_reflector]

    def start(self) -> None:
        for r in self.reflectors:
            r.start()

    def stop(self) -> None:
        for r in self.reflectors:
            r.stop()

    def wait_synced(self, timeout: Optional[float] = None) -> bool:
        """WaitForCacheSync: all reflectors listed at least once
        (cmd/server.go:140-147)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        for r in self.reflectors:
            remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
            if not r.wait_synced(remaining):
                return False
        return True


SERVICEACCOUNT_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


def in_cluster_config() -> tuple[str, str, str]:
    """(base_url, ca_file, token_file) from the pod's serviceaccount — the
    rest.InClusterConfig slot (cmd/server.go:57-75 "in-cluster").

    Raises FileNotFoundError when the serviceaccount CA bundle or token is
    missing: outside a pod "in-cluster" has nothing to connect with, and a
    reflector started without them would retry a failing TLS handshake
    (or send unauthenticated requests) forever. The JAX package returns
    the paths unchecked."""
    import os

    for name in ("ca.crt", "token"):
        path = f"{SERVICEACCOUNT_DIR}/{name}"
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f"kube-api-url in-cluster: serviceaccount file {path} is "
                "missing (not running in a pod?)"
            )
    host = os.environ.get("KUBERNETES_SERVICE_HOST", "kubernetes.default.svc")
    port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
    if ":" in host and not host.startswith("["):
        host = f"[{host}]"  # IPv6 literal needs brackets in a URL
    return (
        f"https://{host}:{port}",
        f"{SERVICEACCOUNT_DIR}/ca.crt",
        f"{SERVICEACCOUNT_DIR}/token",
    )


def in_cluster_ingestion(backend, metrics=None, **kw) -> KubeIngestion:
    """KubeIngestion configured from the pod's serviceaccount."""
    base_url, ca_file, token_file = in_cluster_config()
    return KubeIngestion(
        backend,
        base_url,
        metrics=metrics,
        ca_file=ca_file,
        token_file=token_file,
        **kw,
    )
