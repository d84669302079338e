"""In-process fake Kubernetes apiserver (list/watch REST subset).

Implements the part of the k8s API machinery the scheduler's ingestion
needs — the same protocol the reference consumes through client-go
informers (cmd/server.go:111-147) and fakes with in-memory clientsets in
tests (extendertest harness):

  - typed collections with a single monotonically increasing
    resourceVersion domain (etcd revision model);
  - `GET <collection>` list responses carrying the collection
    resourceVersion to resume watching from;
  - `GET <collection>?watch=true&resourceVersion=N` chunked streams of
    `{"type": ADDED|MODIFIED|DELETED|ERROR, "object": ...}` JSON lines;
  - bounded event history: a watch from an expired resourceVersion gets a
    `410 Gone` ERROR event, forcing the client to relist (the reflector
    relist path);
  - optimistic-concurrency writes (409 on resourceVersion conflict,
    404/409 on missing/duplicate objects) for tests that drive cluster
    state through the API.

Collections served:

  /api/v1/nodes                                       (cluster-scoped)
  /api/v1/pods                                        (all-namespace list+watch)
  /api/v1/namespaces/{ns}/pods[/{name}]               (namespaced CRUD)
  /apis/sparkscheduler.palantir.com/v1beta2/resourcereservations
  /apis/scaler.palantir.com/v1alpha2/demands          (+ namespaced forms)

Objects are stored as raw k8s-shaped JSON dicts — this *is* the wire
format; decoding to framework models happens client-side (kube_io).
"""

from __future__ import annotations

import collections
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional
from urllib.parse import parse_qs, urlparse


class _Collection:
    def __init__(self, resource: str, namespaced: bool, list_kind: str, api_prefix: str):
        self.resource = resource
        self.namespaced = namespaced
        self.list_kind = list_kind
        self.api_prefix = api_prefix  # e.g. "/api/v1" or "/apis/<group>/<version>"
        self.objects: dict[tuple[str, str], dict] = {}

    @property
    def collection_path(self) -> str:
        return f"{self.api_prefix}/{self.resource}"


COLLECTIONS = (
    ("nodes", False, "NodeList", "/api/v1"),
    ("pods", True, "PodList", "/api/v1"),
    (
        "resourcereservations",
        True,
        "ResourceReservationList",
        "/apis/sparkscheduler.palantir.com/v1beta2",
    ),
    ("demands", True, "DemandList", "/apis/scaler.palantir.com/v1alpha2"),
    (
        "customresourcedefinitions",
        False,
        "CustomResourceDefinitionList",
        "/apis/apiextensions.k8s.io/v1",
    ),
)


class ValidationError(Exception):
    """Object rejected by its CRD's openAPI schema (HTTP 422 Invalid)."""


def _meta(obj: dict) -> dict:
    return obj.setdefault("metadata", {})


def _obj_key(obj: dict) -> tuple[str, str]:
    m = _meta(obj)
    return (m.get("namespace", ""), m.get("name", ""))


class FakeKubeAPIServer:
    """Thread-safe fake apiserver. `history_limit` bounds the watch-event
    replay window; a small limit forces 410-Gone relists (the etcd
    compaction analog), which tests use to exercise the reflector's
    resync path."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        history_limit: int = 4096,
        cert_file: str | None = None,
        key_file: str | None = None,
        required_token: str | None = None,
    ):
        """`cert_file`/`key_file` serve HTTPS; `required_token` enforces
        `Authorization: Bearer <token>` on every request (401 otherwise) —
        together they emulate a real apiserver's serviceaccount auth for
        testing the in-cluster reflector path."""
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._rv = 0
        self._closed = False
        self._required_token = required_token
        # Fault injection (chaos soaks). All default off:
        #   chaos_conflict_rate      spurious 409 Conflict on create/update
        #   chaos_drop_rate          connection closed mid-request
        #   terminating_namespaces   creates rejected 403 NamespaceTerminating
        import random as _random

        self.chaos_conflict_rate = 0.0
        self.chaos_drop_rate = 0.0
        self.terminating_namespaces: set[str] = set()
        self._chaos_rng = _random.Random(0)
        self.chaos_injected = {"conflicts": 0, "drops": 0, "ns_terminating": 0}
        self.collections: dict[str, _Collection] = {
            res: _Collection(res, namespaced, kind, prefix)
            for res, namespaced, kind, prefix in COLLECTIONS
        }
        # CRD manifests by plural resource name; writes to a collection with
        # a registered CRD are validated against its openAPI schema the way
        # the real apiserver's structural validation would reject them.
        self._crds: dict[str, dict] = {}
        # (rv, resource, event_type, object-snapshot); single global window,
        # mirroring etcd's single revision domain.
        self._history: collections.deque = collections.deque(maxlen=history_limit)

        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def _authorized(self) -> bool:
                if outer._required_token is None:
                    return True
                header = self.headers.get("Authorization", "")
                if header == f"Bearer {outer._required_token}":
                    return True
                FakeKubeAPIServer._write_json(
                    self, 401, outer._status(401, "Unauthorized", "bad bearer token")
                )
                return False

            def do_GET(self):
                if self._authorized():
                    outer._handle_get(self)

            def do_POST(self):
                if self._authorized():
                    outer._handle_write(self, "create")

            def do_PUT(self):
                if self._authorized():
                    outer._handle_write(self, "update")

            def do_DELETE(self):
                if self._authorized():
                    outer._handle_write(self, "delete")

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        # Same per-connection TLS machinery as the scheduler's own threaded
        # transport — one implementation to maintain.
        from spark_scheduler_tpu_torch.server.transport_threaded import (
            _maybe_wrap_tls,
        )

        self.tls = _maybe_wrap_tls(self._server, cert_file, key_file)
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------------

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    @property
    def base_url(self) -> str:
        host, port = self._server.server_address[:2]
        scheme = "https" if self.tls else "http"
        return f"{scheme}://{host}:{port}"

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True, name="fake-apiserver"
        )
        self._thread.start()

    def stop(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)

    # -- CRD registration ----------------------------------------------------

    def register_crd(self, crd: dict) -> None:
        plural = crd["spec"]["names"]["plural"]
        with self._lock:
            self._crds[plural] = crd

    def _validate(self, resource: str, obj: dict) -> None:
        with self._lock:
            crd = self._crds.get(resource)
        # Validation only applies to CRDs whose manifest carries schemas
        # (a minimally-registered CRD behaves like preserveUnknownFields).
        if crd is None or not (crd.get("spec") or {}).get("versions"):
            return
        from spark_scheduler_tpu_torch.models.crds import validate_custom_resource

        errors = validate_custom_resource(crd, obj)
        if errors:
            raise ValidationError("; ".join(errors))

    def _maybe_track_crd(self, resource: str, obj: dict, deleted: bool = False) -> None:
        """CRDs created/updated THROUGH the API register their schemas for
        validation, like the real apiserver establishing a CRD."""
        if resource != "customresourcedefinitions":
            return
        plural = ((obj.get("spec") or {}).get("names") or {}).get("plural")
        if not plural:
            return
        with self._lock:
            if deleted:
                self._crds.pop(plural, None)
            else:
                self._crds[plural] = obj

    # -- state mutation (also the test-driver API) --------------------------

    def create(self, resource: str, obj: dict) -> dict:
        col = self.collections[resource]
        self._validate(resource, obj)
        with self._cond:
            key = _obj_key(obj)
            if key in col.objects:
                raise KeyError(f"{resource} {key} exists")
            self._rv += 1
            _meta(obj)["resourceVersion"] = str(self._rv)
            # Store a snapshot, not the caller's dict: later caller-side
            # mutation must not change apiserver state without a watch event.
            snapshot = json.loads(json.dumps(obj))
            col.objects[key] = snapshot
            self._history.append((self._rv, resource, "ADDED", snapshot))
            self._cond.notify_all()
        self._maybe_track_crd(resource, snapshot)
        return obj

    def create_many(self, resource: str, objs: list[dict]) -> None:
        """Create a batch under ONE lock acquisition — no watcher can
        interleave, so a batch larger than the history window deterministically
        forces the mid-stream 410 path (tests) and bulk seeding is fast."""
        col = self.collections[resource]
        for obj in objs:
            self._validate(resource, obj)
        snapshots = []
        with self._cond:
            for obj in objs:
                key = _obj_key(obj)
                if key in col.objects:
                    raise KeyError(f"{resource} {key} exists")
                self._rv += 1
                _meta(obj)["resourceVersion"] = str(self._rv)
                snapshot = json.loads(json.dumps(obj))
                col.objects[key] = snapshot
                self._history.append((self._rv, resource, "ADDED", snapshot))
                snapshots.append(snapshot)
            self._cond.notify_all()
        for snapshot in snapshots:
            self._maybe_track_crd(resource, snapshot)

    def update(self, resource: str, obj: dict, check_rv: bool = False) -> dict:
        col = self.collections[resource]
        self._validate(resource, obj)
        with self._cond:
            key = _obj_key(obj)
            cur = col.objects.get(key)
            if cur is None:
                raise LookupError(f"{resource} {key} not found")
            if check_rv:
                sent = _meta(obj).get("resourceVersion")
                if sent and sent != _meta(cur).get("resourceVersion"):
                    raise ValueError(
                        f"conflict: rv {sent} != {_meta(cur).get('resourceVersion')}"
                    )
            self._rv += 1
            _meta(obj)["resourceVersion"] = str(self._rv)
            snapshot = json.loads(json.dumps(obj))
            col.objects[key] = snapshot
            self._history.append((self._rv, resource, "MODIFIED", snapshot))
            self._cond.notify_all()
        self._maybe_track_crd(resource, snapshot)
        return obj

    def delete(self, resource: str, namespace: str, name: str) -> None:
        col = self.collections[resource]
        with self._cond:
            cur = col.objects.pop((namespace, name), None)
            if cur is None:
                raise LookupError(f"{resource} {(namespace, name)} not found")
            self._rv += 1
            # DELETED events carry the final object state at the deletion
            # revision (k8s watch semantics).
            final = json.loads(json.dumps(cur))
            _meta(final)["resourceVersion"] = str(self._rv)
            self._history.append((self._rv, resource, "DELETED", final))
            self._cond.notify_all()
        self._maybe_track_crd(resource, cur, deleted=True)

    def current_rv(self) -> int:
        with self._lock:
            return self._rv

    # -- request handling ---------------------------------------------------

    def _resolve(self, path: str) -> Optional[tuple[_Collection, Optional[str], Optional[str]]]:
        """path -> (collection, namespace|None, name|None). namespace None
        means the cluster/all-namespace collection path."""
        for col in self.collections.values():
            base = col.collection_path
            if path == base:
                return (col, None, None)
            if path.startswith(base + "/") and not col.namespaced:
                return (col, None, path[len(base) + 1 :])
            if col.namespaced:
                ns_prefix = f"{col.api_prefix}/namespaces/"
                if path.startswith(ns_prefix):
                    rest = path[len(ns_prefix) :].split("/")
                    if len(rest) >= 2 and rest[1] == col.resource:
                        ns = rest[0]
                        name = rest[2] if len(rest) > 2 else None
                        return (col, ns, name)
        return None

    @staticmethod
    def _write_json(handler, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        handler.send_response(code)
        handler.send_header("Content-Type", "application/json")
        handler.send_header("Content-Length", str(len(body)))
        handler.end_headers()
        handler.wfile.write(body)

    @staticmethod
    def _status(code: int, reason: str, message: str) -> dict:
        return {
            "kind": "Status",
            "apiVersion": "v1",
            "status": "Failure",
            "reason": reason,
            "message": message,
            "code": code,
        }

    def _handle_get(self, handler) -> None:
        parsed = urlparse(handler.path)
        resolved = self._resolve(parsed.path)
        if resolved is None:
            self._write_json(handler, 404, self._status(404, "NotFound", parsed.path))
            return
        col, ns, name = resolved
        if self._drop_connection(handler):
            return
        query = parse_qs(parsed.query)
        if name:
            with self._lock:
                obj = col.objects.get((ns or "", name))
            if obj is None:
                self._write_json(handler, 404, self._status(404, "NotFound", name))
            else:
                self._write_json(handler, 200, obj)
            return
        if query.get("watch", ["false"])[0] in ("true", "1"):
            self._serve_watch(handler, col, ns, query)
            return
        with self._lock:
            items = [
                obj
                for key, obj in sorted(col.objects.items())
                if ns is None or key[0] == ns
            ]
            rv = self._rv
        self._write_json(
            handler,
            200,
            {
                "kind": col.list_kind,
                "apiVersion": "v1",
                "metadata": {"resourceVersion": str(rv)},
                "items": items,
            },
        )

    def _serve_watch(self, handler, col: _Collection, ns: Optional[str], query) -> None:
        """Chunked watch stream. Replays history after `resourceVersion`,
        then blocks for new events until timeoutSeconds / client
        disconnect / server shutdown."""
        try:
            since = int(query.get("resourceVersion", ["0"])[0] or 0)
        except ValueError:
            since = 0
        try:
            timeout_s = float(query.get("timeoutSeconds", ["300"])[0])
        except ValueError:
            timeout_s = 300.0

        handler.send_response(200)
        handler.send_header("Content-Type", "application/json")
        handler.send_header("Transfer-Encoding", "chunked")
        handler.end_headers()

        def send_event(event: dict) -> bool:
            data = (json.dumps(event) + "\n").encode()
            try:
                handler.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
                handler.wfile.flush()
                return True
            except (BrokenPipeError, ConnectionResetError, OSError):
                return False

        import time as _time

        deadline = _time.monotonic() + timeout_s
        last_sent = since
        with self._cond:
            # Expired-history check: if the requested rv predates the replay
            # window (events pruned past it), the client must relist — the
            # etcd-compaction 410 path reflectors recover from by relisting.
            expired = bool(self._history) and since + 1 < self._history[0][0]
        if expired:
            send_event(
                {
                    "type": "ERROR",
                    "object": self._status(
                        410, "Expired", f"too old resource version: {since}"
                    ),
                }
            )
            self._finish_chunks(handler)
            return

        while True:
            batch: list[tuple[str, dict]] = []
            expired_mid_stream = False
            with self._cond:
                # Events the client hasn't consumed yet can be pruned while
                # the stream is blocked on a slow writer; silently skipping
                # them would let the client diverge forever. Error the watch
                # (410) so it relists — real apiserver behavior.
                if self._history and self._history[0][0] > last_sent + 1:
                    expired_mid_stream = True
                else:
                    for rv, resource, etype, obj in self._history:
                        if rv <= last_sent:
                            continue
                        if resource != col.resource or (
                            ns is not None and _obj_key(obj)[0] != ns
                        ):
                            # Filtered/foreign events still advance the
                            # cursor — otherwise a watcher of a QUIET
                            # collection trips the pruning check as soon as
                            # a busy collection slides the shared history
                            # window past it.
                            last_sent = rv
                            continue
                        batch.append((etype, obj))
                        last_sent = rv
                if not batch and not expired_mid_stream:
                    if self._closed:
                        break
                    remaining = deadline - _time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(timeout=min(remaining, 1.0))
                    if self._closed:
                        break
                    continue
            if expired_mid_stream:
                send_event(
                    {
                        "type": "ERROR",
                        "object": self._status(
                            410,
                            "Expired",
                            f"events pruned past resource version {last_sent}",
                        ),
                    }
                )
                break
            ok = True
            for etype, obj in batch:
                if not send_event({"type": etype, "object": obj}):
                    ok = False
                    break
            if not ok:
                return  # client went away; no terminating chunk possible
        self._finish_chunks(handler)

    @staticmethod
    def _finish_chunks(handler) -> None:
        try:
            handler.wfile.write(b"0\r\n\r\n")
            handler.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass

    def _drop_connection(self, handler) -> bool:
        """Chaos: abruptly close the socket (client sees a reset/short read)."""
        if self.chaos_drop_rate and self._chaos_rng.random() < self.chaos_drop_rate:
            self.chaos_injected["drops"] += 1
            try:
                handler.connection.close()
            except OSError:
                pass
            handler.close_connection = True
            return True
        return False

    def _handle_write(self, handler, verb: str) -> None:
        parsed = urlparse(handler.path)
        resolved = self._resolve(parsed.path)
        if resolved is None:
            self._write_json(handler, 404, self._status(404, "NotFound", parsed.path))
            return
        col, ns, name = resolved
        if self._drop_connection(handler):
            return
        if (
            verb == "create"
            and ns in self.terminating_namespaces
        ):
            self.chaos_injected["ns_terminating"] += 1
            self._write_json(
                handler,
                403,
                self._status(
                    403,
                    "NamespaceTerminating",
                    f"namespace {ns} is being terminated",
                ),
            )
            return
        if (
            verb in ("create", "update")
            and self.chaos_conflict_rate
            and self._chaos_rng.random() < self.chaos_conflict_rate
        ):
            self.chaos_injected["conflicts"] += 1
            self._write_json(
                handler,
                409,
                self._status(409, "Conflict", "chaos: injected write conflict"),
            )
            return
        body: dict[str, Any] = {}
        length = int(handler.headers.get("Content-Length") or 0)
        if length:
            try:
                body = json.loads(handler.rfile.read(length))
            except json.JSONDecodeError as exc:
                self._write_json(handler, 400, self._status(400, "BadRequest", str(exc)))
                return
        try:
            if verb == "create":
                if ns is not None:
                    _meta(body).setdefault("namespace", ns)
                created = self.create(col.resource, body)
                self._write_json(handler, 201, created)
            elif verb == "update":
                if name and not _meta(body).get("name"):
                    _meta(body)["name"] = name
                if ns is not None:
                    _meta(body).setdefault("namespace", ns)
                updated = self.update(col.resource, body, check_rv=True)
                self._write_json(handler, 200, updated)
            else:  # delete
                if not name:
                    self._write_json(
                        handler, 400, self._status(400, "BadRequest", "delete needs a name")
                    )
                    return
                self.delete(col.resource, ns or "", name)
                self._write_json(handler, 200, self._status(200, "Success", name))
        except ValidationError as exc:
            self._write_json(handler, 422, self._status(422, "Invalid", str(exc)))
        except KeyError as exc:
            self._write_json(handler, 409, self._status(409, "AlreadyExists", str(exc)))
        except LookupError as exc:
            self._write_json(handler, 404, self._status(404, "NotFound", str(exc)))
        except ValueError as exc:
            self._write_json(handler, 409, self._status(409, "Conflict", str(exc)))
