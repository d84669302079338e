"""Install-time configuration (config/config.go:24-84).

The port's copy of spark_scheduler_tpu/server/config.py without the JAX
compilation-cache helpers. Every key parses as it does there, and the port
serves every one (`jax-compilation-cache-dir` names the directory its
compiled libraries build into); a key it could not serve would be refused
by `server.app.build_scheduler_app` (`unsupported_keys`).

YAML-loadable install config with the reference's option surface: FIFO mode
+ age-based enforcement per instance group, binpack algorithm selection,
async write-back retry budget, unschedulable-pod timeout, prioritized node
labels for driver/executor sorting, single-AZ dynamic-allocation flag, and
the serving port. `from_yaml` accepts the reference's field names.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from spark_scheduler_tpu_torch.core.extender import FifoConfig


@dataclasses.dataclass
class LabelPriorityOrder:
    """config.LabelPriorityOrder (config/config.go:66-70)."""

    name: str
    descending_priority_values: list[str]

    def as_tuple(self) -> tuple[str, list[str]]:
        return (self.name, self.descending_priority_values)


@dataclasses.dataclass
class InstallConfig:
    fifo: bool = False
    fifo_config: FifoConfig = dataclasses.field(default_factory=FifoConfig)
    binpack_algo: str = "tightly-pack"
    instance_group_label: str = "instance-group"
    async_client_retry_count: int = 5
    unschedulable_pod_timeout_s: float = 600.0
    should_schedule_dynamically_allocated_executors_in_same_az: bool = False
    driver_prioritized_node_label: Optional[LabelPriorityOrder] = None
    executor_prioritized_node_label: Optional[LabelPriorityOrder] = None
    port: int = 8484
    sync_writes: bool = False  # drain write-back inline (tests/single-thread)
    # One batched device solve per driver request (FIFO prefix + current
    # app, core/solver.py pack_window); False forces the per-earlier-driver
    # sequential loop.
    batched_admission: bool = True
    # Append a JSON line per metric series on every reporter tick (the
    # reference's 30s metric flush, metrics/metrics.go:79). None = off;
    # metrics remain pollable at GET /metrics either way.
    metrics_log: Optional[str] = None
    # Kubernetes apiserver base URL for list+watch ingestion (the informer
    # slot, cmd/server.go:111-147). None = state arrives via PUT /state/*
    # or an embedding program driving the backend directly.
    kube_api_url: Optional[str] = None
    # Conversion webhook client URL wired into the ResourceReservation CRD
    # (config.go:79-84 WebhookServiceConfig + conversionwebhook client
    # config). None = conversion strategy "None".
    conversion_webhook_url: Optional[str] = None
    # JSONL write-ahead log path for the durable backend (the etcd slot);
    # used by the CLI to construct a DurableBackend. None = in-memory only.
    durable_store_path: Optional[str] = None
    # TLS material (the witchcraft server slot: reference install config
    # server.cert-file / key-file / client-ca-files, examples/extender.yml
    # :75-80). Both cert+key set => serve HTTPS; client_ca_files (any
    # number of CAs) additionally requires client certificates (mTLS).
    cert_file: Optional[str] = None
    key_file: Optional[str] = None
    client_ca_files: list[str] = dataclasses.field(default_factory=list)
    # Disable TLS verification of the kube-api-url endpoint (self-signed
    # dev apiservers). NEVER the default: without it, https endpoints are
    # verified against system CAs (or the serviceaccount CA in-cluster).
    kube_api_insecure_skip_tls_verify: bool = False
    # Client-side rate limit for apiserver writes/reads (reference config
    # qps/burst, config/config.go:30-31).
    kube_api_qps: float = 5.0
    kube_api_burst: int = 10
    # Per-connection socket read timeout (extender protocol budget is 30 s,
    # examples/extender.yml:59).
    request_timeout_s: float = 30.0
    # Serving transport: "threaded" (stdlib thread-per-connection stack —
    # the default until the bench A/B proves the async floor on the target
    # box) or "async" (single-threaded event loop with pipelined keep-alive
    # framing and explicit backpressure; the JAX package's
    # server/transport_async.py, not ported yet).
    # YAML: `server.transport`.
    server_transport: str = "threaded"
    # Serving ingest lane: "python" (json.loads + dict walk per predicate
    # body) or "native" (the JAX package's C++ framer/decoder in its
    # native/runtime.cpp, not ported yet:
    # request framing and the candidate-name bulk never touch Python on
    # the hot path). The port refuses it. YAML: `server.ingest`.
    server_ingest: str = "python"
    # Largest request body either transport will buffer; bigger bodies are
    # answered 413 with the body drained (keep-alive survives). The 10k-node
    # predicate bodies measure ~200 KB, so 16 MiB is generous headroom.
    # YAML: `server.max-body-bytes`.
    max_body_bytes: int = 16 * 1024 * 1024
    # Async-transport connection cap: connections past it are answered with
    # a canned 503 + close instead of accumulating per-connection state
    # (the threaded transport's analogue is its bounded listen backlog).
    # YAML: `server.max-connections`.
    max_connections: int = 512
    # Predicate load shedding: when the batcher's un-claimed backlog
    # reaches this depth, new /predicates calls get an immediate 503
    # instead of parking until the request timeout. 0 disables.
    # YAML: `server.shed-queue-depth`.
    shed_queue_depth: int = 256
    # Expose /debug/* (trace dump + torch.profiler control). Off by default:
    # on the cluster-exposed port these routes are unauthenticated.
    debug_routes: bool = False
    # Structured per-request access logging (the witchcraft req2log slot):
    # one request.2 line per HTTP call with method, path, status, duration,
    # trace id. Off by default (one log line per predicate call is real
    # I/O at serving rates).
    request_log: bool = False
    # Predicate window tuning: max coalesced requests per device solve, and
    # the busy-period accumulation hold (how long the dispatcher waits for
    # stragglers after a coalesced window — a throughput/latency tradeoff;
    # a lone request on an idle server is never held).
    predicate_max_window: int = 32
    predicate_hold_ms: float = 25.0
    # In-process elastic autoscaler (spark_scheduler_tpu_torch/autoscaler/): when
    # enabled, pending Demand CRDs are consumed IN PROCESS — simulated
    # nodes are provisioned (zone-affine, template-shaped) and demand
    # phases flip pending -> fulfilled / cannot-fulfill; nodes idle past
    # the TTL are cordoned then drained, never a node holding a hard or
    # soft reservation. Off by default: on a real cluster the Demand CRD
    # belongs to the external autoscaler.
    autoscaler_enabled: bool = False
    # Hard cap on total node count; demands that would push past it are
    # marked cannot-fulfill.
    autoscaler_max_cluster_size: int = 1000
    # A node idle (no reservations, no bound pods) this long is cordoned,
    # then removed on the next pass if still idle.
    autoscaler_idle_ttl_s: float = 300.0
    autoscaler_poll_interval_s: float = 2.0
    # Template shape of provisioned nodes (k8s quantity strings).
    autoscaler_node_cpu: str = "8"
    autoscaler_node_memory: str = "8Gi"
    autoscaler_node_gpu: str = "1"
    # Zones provisioned nodes spread across (round-robin) when a demand
    # doesn't pin one; empty = the default zone.
    autoscaler_zones: list[str] = dataclasses.field(default_factory=list)
    # Path to the REFRESHABLE runtime-config YAML (the witchcraft Runtime
    # embed, config.go:24-47): log level, fifo, batched-admission, and the
    # async retry budget reload live on file change or SIGHUP
    # (server/runtime.py). None = no runtime reloads.
    runtime_config_path: Optional[str] = None
    # The JAX package's persistent compilation cache directory; in the port
    # the directory its CUDA kernels and native runtime build into and load
    # from (ops/_build.py `use_build_dir`, applied by the app builder; None
    # = spark_scheduler_tpu_torch/_build/). Libraries a process has
    # already loaded stay loaded.
    jax_compilation_cache_dir: Optional[str] = None
    # Multi-device window-solve engine (core/solver.py): `solver.device-pool`
    # keeps a resident cluster replica on N devices and round-robins
    # concurrent window solves (disjoint-domain windows partition across the
    # pool — instance groups solve in parallel); `solver.mesh` is the full
    # {groups, node-shards} form, where node-shards > 1 additionally shards
    # each slot's node axis over a GSPMD sub-mesh (when a single window's
    # 10k-node solve is the bottleneck and the interconnect is fast — see
    # README "Multi-device serving" for when sharded vs pooled wins).
    # device-pool N is shorthand for mesh {groups: N, node-shards: 1}.
    # 1 / unset = the classic single-device serving path.
    solver_device_pool: int = 1
    solver_mesh_groups: Optional[int] = None
    solver_mesh_node_shards: Optional[int] = None
    # Sound top-K candidate pruning (`solver.prune-top-k` /
    # `solver.prune-slack`, core/prune.py — the two-tier solve): when
    # top-k > 0, eligible serving windows solve a gathered top-K
    # sub-cluster (K per zone = max(top-k, window aggregate demand x
    # slack)) instead of the full [N,3] tensor, and every pruned decision
    # is verified by a post-solve certificate — a failed certificate
    # escalates the window to the exact full re-solve, so decisions stay
    # byte-identical to the unpruned path by construction
    # (`foundry.spark.scheduler.solver.prune.*` counts the escalations).
    # 0 (the default) = off: the classic full-tensor paths byte-for-byte.
    solver_prune_top_k: int = 0
    solver_prune_slack: float = 2.0
    # Delta STATIC uploads (`solver.delta-statics`): node events
    # touching few rows ship a row-scatter of the changed static-field
    # rows to the resident device state (and lagging pool replicas catch
    # up from the epoch journal) instead of re-uploading the full
    # multi-MB statics blob per epoch per slot. ON by default — pinned
    # byte-identical to the full-upload path by the delta-equivalence
    # suite; false restores full uploads (and the drain-on-any-statics-
    # change pipeline contract).
    solver_delta_statics: bool = True
    # Million-node scale tier (`solver.scale-tier`): certificate
    # escalations and cold full-tensor re-solves run as a node-sharded
    # device solve across the local device mesh (parallel/solve
    # node_sharding) instead of the host-Python greedy walk. Decisions
    # byte-identical (same kernels; escalation-parity test pinned); any
    # device failure falls back to the host greedy oracle. OFF by
    # default — node-axis sharding wants an ICI-class interconnect.
    solver_scale_tier: bool = False
    # O(K + changed) tensor build. `solver.build-oracle`: after
    # every event-fed dirty-set mirror sync, ALSO run the dense [N]-wide
    # compare as an oracle and fail loudly on a missed row — the
    # equivalence suites' guard; off in production (it re-adds the O(N)
    # sweep the dirty set retires). `solver.lazy-warm-start`: a full
    # device upload whose host-side change feed stayed exact keeps the
    # prune planner's resident per-zone orders (a warm restart skips the
    # O(N log N) cold replan); false restores the hard invalidate.
    solver_build_oracle: bool = False
    solver_lazy_warm_start: bool = True
    # Fused multi-window device dispatch (`solver.fuse-windows`): when the
    # predicate backlog holds more than one window's worth of requests,
    # the batcher claims up to fuse-windows x predicate-max-window of them
    # and dispatches the sub-windows as ONE fused device program carrying
    # the committed base on-device between windows — K windows share one
    # h2d + dispatch + d2h round trip (a device round-trip floor
    # amortizes by K). Decisions are byte-identical
    # to sequential single-window dispatch (equivalence-suite pinned).
    # 1 (default) = today's one-window-per-dispatch behavior.
    solver_fuse_windows: int = 1
    # Scheduling flight recorder (observability/): every extender decision
    # appends an explainable DecisionRecord (verdict, per-node failure map,
    # FIFO queue position, padding bucket, compile-cache hit, phase wall
    # times) to a bounded ring queryable at GET /debug/decisions, and the
    # solver publishes foundry.spark.scheduler.solver.* telemetry. On by
    # default — bench.py's recorder-overhead section keeps the hot-path
    # cost measured; False strips both for the control measurement.
    flight_recorder: bool = True
    flight_recorder_capacity: int = 2048
    # Durable decision trace (spark_scheduler_tpu_torch/replay/): when
    # a path is set (and the flight recorder is on), a TraceWriter journals
    # every input a decision consumed — node/pod events, predicate
    # requests, the config fingerprint — plus the answered verdicts, as a
    # versioned JSONL stream `python -m spark_scheduler_tpu_torch.replay` can
    # re-execute bit-identically or what-if under an altered config.
    #   trace: {path, decisions}
    # `decisions: true` additionally journals the informational
    # DecisionRecord copies (replay never needs them — the result events
    # carry every compared verdict — and they roughly double the
    # serving-path encode cost, so they are opt-in).
    trace_path: Optional[str] = None
    trace_decisions: bool = False
    # Active-active HA (spark_scheduler_tpu_torch/ha/): run this process as one
    # replica of a lease-elected group. The replica starts as a warm
    # standby (caches tailed hot from backend events / the shared WAL) and
    # serves only after winning the lease and running the failover
    # reconcile; reservation/demand writes carry the lease's fencing epoch
    # so a deposed leader's in-flight commits are rejected. YAML block:
    #   ha: {enabled, replica-id, lease-ttl, heartbeat-interval}
    ha_enabled: bool = False
    ha_replica_id: str = "replica-0"
    ha_lease_ttl_s: float = 3.0
    # None = lease-ttl / 3 (three renew chances before takeover).
    ha_heartbeat_s: Optional[float] = None
    # Fleet federation (fleet/): the server boots F independent
    # per-cluster solver stacks behind one FleetFacade instead of a
    # single-cluster app. YAML block:
    #   fleet: {enabled, clusters, max-spillover-hops, stack-window-ms}
    # `stack-window-ms` > 0 turns on fused fleet dispatch: a
    # cluster's staged window waits up to that long for windows from the
    # other live clusters, and same-shape-bucket windows flush as ONE
    # stacked device launch (fleet/dispatch.py). 0 (default) = off; every
    # serving blob and decision is then byte-identical to the unstacked
    # fleet.
    fleet_enabled: bool = False
    fleet_clusters: int = 2
    fleet_max_spillover_hops: int = 1
    fleet_stack_window_ms: float = 0.0
    # Request-gap resync threshold (`extender.resync-gap-seconds`,
    # resource.go:191-202): a gap longer than this resyncs durable state
    # from observed pods. Skipped entirely while the HA lease is held.
    resync_gap_seconds: float = 15.0
    # Degraded-mode policy (`server.degraded-mode`): what the
    # scheduler does when NO device slot can serve (every pool slot
    # quarantined, or the single device died).
    #   greedy  keep serving decisions via the host-side greedy fallback
    #           (core/fallback.py — byte-identical packing semantics,
    #           O(nodes) Python per row); readiness stays 200 but reports
    #           degraded.
    #   shed    answer /predicates 503 with Retry-After
    #           (`server.degraded-retry-after`); readiness flips 503 so
    #           load balancers drain the replica.
    degraded_mode: str = "greedy"
    degraded_retry_after_s: float = 5.0
    # How often a quarantined device slot is probed for reinstatement
    # (`solver.quarantine-probe`): a tiny device program runs on the slot;
    # success puts it back into rotation (statics re-upload lazily).
    quarantine_probe_s: float = 5.0
    # Shared retry-ladder shape (`retry:` block): base/multiplier/cap for
    # the exponential-backoff-with-full-jitter policy the kube write-back
    # clients ride. `async-client-retry-count` remains the attempt budget
    # (back-compat alias).
    retry_base_delay_s: float = 0.02
    retry_multiplier: float = 2.0
    retry_max_delay_s: float = 2.0
    # Circuit breaker over backend write-back: consecutive failures
    # before opening, and how long an open breaker waits before admitting
    # a half-open probe. 0 failures disables the breaker.
    breaker_failure_threshold: int = 8
    breaker_reset_timeout_s: float = 5.0
    # Policy engine (spark_scheduler_tpu_torch/policy/): priority
    # tiers, vectorized preemption search, DRF window ordering, and the
    # pool-driven continuous defragmenter. OFF by default — with
    # `policy.enabled: false` no PolicyEngine is constructed and every
    # extender decision takes the exact pre-policy FIFO branch
    # (byte-identity pinned by tests/test_policy_identity.py + CI).
    #   policy:
    #     enabled: true
    #     ordering: fifo | priority | drf
    #     preemption: true
    #     max-evictions: 8
    #     promote-after: 5m        # anti-starvation age promotion step
    #     protected-class: system  # never evicted
    #     defrag: {enabled, interval, budget}
    policy_enabled: bool = False
    policy_ordering: str = "fifo"
    policy_preemption: bool = False
    policy_max_evictions: int = 8
    policy_promote_after_s: float = 300.0
    policy_protected_class: str = "system"
    policy_defrag: bool = False
    policy_defrag_interval_s: float = 30.0
    policy_defrag_budget: int = 4

    @classmethod
    def from_dict(cls, raw: dict) -> "InstallConfig":
        fifo_cfg = FifoConfig()
        if "fifo-config" in raw:
            fc = raw["fifo-config"]
            fifo_cfg = FifoConfig(
                enforce_after_pod_age_s=_parse_duration(
                    fc.get("default-enforce-after-pod-age", 0)
                ),
                enforce_after_pod_age_by_instance_group={
                    k: _parse_duration(v)
                    for k, v in fc.get("enforce-after-pod-age-by-instance-group", {}).items()
                },
            )

        def label_prio(key):
            if key not in raw:
                return None
            return LabelPriorityOrder(
                name=raw[key]["name"],
                descending_priority_values=list(
                    raw[key]["descending-priority-values"]
                ),
            )

        # Reference nests TLS + port under a "server" block
        # (examples/extender.yml:73-80); flat keys also accepted.
        server_block = raw.get("server") or {}
        ca_files = server_block.get("client-ca-files") or []
        autoscaler_block = raw.get("autoscaler") or {}
        solver_block = raw.get("solver") or {}
        mesh_block = solver_block.get("mesh") or {}
        ha_block = raw.get("ha") or {}
        fleet_block = raw.get("fleet") or {}
        trace_block = raw.get("trace") or {}
        extender_block = raw.get("extender") or {}
        retry_block = raw.get("retry") or {}
        policy_block = raw.get("policy") or {}
        defrag_block = policy_block.get("defrag") or {}

        def block_key(block, key, default):
            # Present-but-null keys (`device-pool:` with no value) must
            # read as the default, not None — same YAML idiom the
            # autoscaler block defends against.
            v = block.get(key)
            return default if v is None else v

        def autoscaler_key(key, default):
            return block_key(autoscaler_block, key, default)
        return cls(
            fifo=bool(raw.get("fifo", False)),
            fifo_config=fifo_cfg,
            binpack_algo=raw.get("binpack-algo", "tightly-pack"),
            instance_group_label=raw.get("instance-group-label", "instance-group"),
            async_client_retry_count=int(raw.get("async-client-retry-count", 5)),
            unschedulable_pod_timeout_s=_parse_duration(
                raw.get("unschedulable-pod-timeout", 600.0)
            ),
            should_schedule_dynamically_allocated_executors_in_same_az=bool(
                raw.get(
                    "should-schedule-dynamically-allocated-executors-in-same-az",
                    False,
                )
            ),
            driver_prioritized_node_label=label_prio("driver-prioritized-node-label"),
            executor_prioritized_node_label=label_prio("executor-prioritized-node-label"),
            port=int(server_block.get("port", raw.get("port", 8484))),
            batched_admission=bool(raw.get("batched-admission", True)),
            metrics_log=raw.get("metrics-log"),
            kube_api_url=raw.get("kube-api-url"),
            conversion_webhook_url=raw.get("conversion-webhook-url"),
            durable_store_path=raw.get("durable-store-path"),
            cert_file=server_block.get("cert-file", raw.get("cert-file")),
            key_file=server_block.get("key-file", raw.get("key-file")),
            client_ca_files=list(ca_files),
            kube_api_insecure_skip_tls_verify=bool(
                raw.get("kube-api-insecure-skip-tls-verify", False)
            ),
            kube_api_qps=float(raw.get("qps", 5.0)),
            kube_api_burst=int(raw.get("burst", 10)),
            request_timeout_s=_parse_duration(raw.get("request-timeout", 30.0)),
            server_transport=str(
                server_block.get("transport", raw.get("transport", "threaded"))
            ),
            server_ingest=str(
                server_block.get("ingest", raw.get("ingest", "python"))
            ),
            max_body_bytes=int(
                server_block.get(
                    "max-body-bytes",
                    raw.get("max-body-bytes", 16 * 1024 * 1024),
                )
            ),
            max_connections=int(
                server_block.get(
                    "max-connections", raw.get("max-connections", 512)
                )
            ),
            shed_queue_depth=int(
                server_block.get(
                    "shed-queue-depth", raw.get("shed-queue-depth", 256)
                )
            ),
            debug_routes=bool(raw.get("debug-routes", False)),
            request_log=bool(raw.get("request-log", False)),
            predicate_max_window=int(raw.get("predicate-max-window", 32)),
            predicate_hold_ms=float(raw.get("predicate-hold-ms", 25.0)),
            autoscaler_enabled=bool(autoscaler_key("enabled", False)),
            autoscaler_max_cluster_size=int(
                autoscaler_key("max-cluster-size", 1000)
            ),
            autoscaler_idle_ttl_s=_parse_duration(
                autoscaler_key("idle-ttl", 300.0)
            ),
            autoscaler_poll_interval_s=_parse_duration(
                autoscaler_key("poll-interval", 2.0)
            ),
            autoscaler_node_cpu=str(autoscaler_key("node-cpu", "8")),
            autoscaler_node_memory=str(autoscaler_key("node-memory", "8Gi")),
            autoscaler_node_gpu=str(autoscaler_key("node-gpu", "1")),
            autoscaler_zones=list(autoscaler_key("zones", [])),
            solver_device_pool=int(block_key(solver_block, "device-pool", 1)),
            solver_mesh_groups=(
                int(v)
                if (v := block_key(mesh_block, "groups", None)) is not None
                else None
            ),
            solver_mesh_node_shards=(
                int(v)
                if (v := block_key(mesh_block, "node-shards", None))
                is not None
                else None
            ),
            solver_fuse_windows=int(
                block_key(solver_block, "fuse-windows", 1)
            ),
            solver_prune_top_k=int(
                block_key(solver_block, "prune-top-k", 0)
            ),
            solver_prune_slack=float(
                block_key(solver_block, "prune-slack", 2.0)
            ),
            solver_delta_statics=bool(
                block_key(solver_block, "delta-statics", True)
            ),
            solver_scale_tier=bool(
                block_key(solver_block, "scale-tier", False)
            ),
            solver_build_oracle=bool(
                block_key(solver_block, "build-oracle", False)
            ),
            solver_lazy_warm_start=bool(
                block_key(solver_block, "lazy-warm-start", True)
            ),
            runtime_config_path=raw.get("runtime-config-path"),
            jax_compilation_cache_dir=raw.get("jax-compilation-cache-dir"),
            flight_recorder=bool(raw.get("flight-recorder", True)),
            flight_recorder_capacity=int(
                raw.get("flight-recorder-capacity", 2048)
            ),
            trace_path=trace_block.get("path", raw.get("trace-path")),
            trace_decisions=bool(block_key(trace_block, "decisions", False)),
            ha_enabled=bool(block_key(ha_block, "enabled", False)),
            ha_replica_id=str(
                block_key(ha_block, "replica-id", "replica-0")
            ),
            ha_lease_ttl_s=_parse_duration(
                block_key(ha_block, "lease-ttl", 3.0)
            ),
            ha_heartbeat_s=(
                _parse_duration(v)
                if (v := block_key(ha_block, "heartbeat-interval", None))
                is not None
                else None
            ),
            fleet_enabled=bool(block_key(fleet_block, "enabled", False)),
            fleet_clusters=int(block_key(fleet_block, "clusters", 2)),
            fleet_max_spillover_hops=int(
                block_key(fleet_block, "max-spillover-hops", 1)
            ),
            fleet_stack_window_ms=float(
                block_key(fleet_block, "stack-window-ms", 0.0)
            ),
            resync_gap_seconds=_parse_duration(
                block_key(
                    extender_block,
                    "resync-gap-seconds",
                    raw.get("resync-gap-seconds", 15.0),
                )
            ),
            degraded_mode=str(
                block_key(server_block, "degraded-mode", "greedy")
            ),
            degraded_retry_after_s=_parse_duration(
                block_key(server_block, "degraded-retry-after", 5.0)
            ),
            quarantine_probe_s=_parse_duration(
                block_key(solver_block, "quarantine-probe", 5.0)
            ),
            retry_base_delay_s=_parse_duration(
                block_key(retry_block, "base-delay", 0.02)
            ),
            retry_multiplier=float(
                block_key(retry_block, "multiplier", 2.0)
            ),
            retry_max_delay_s=_parse_duration(
                block_key(retry_block, "max-delay", 2.0)
            ),
            breaker_failure_threshold=int(
                block_key(retry_block, "breaker-failure-threshold", 8)
            ),
            breaker_reset_timeout_s=_parse_duration(
                block_key(retry_block, "breaker-reset-timeout", 5.0)
            ),
            policy_enabled=bool(block_key(policy_block, "enabled", False)),
            policy_ordering=str(block_key(policy_block, "ordering", "fifo")),
            policy_preemption=bool(
                block_key(policy_block, "preemption", False)
            ),
            policy_max_evictions=int(
                block_key(policy_block, "max-evictions", 8)
            ),
            policy_promote_after_s=_parse_duration(
                block_key(policy_block, "promote-after", 300.0)
            ),
            policy_protected_class=str(
                block_key(policy_block, "protected-class", "system")
            ),
            policy_defrag=bool(block_key(defrag_block, "enabled", False)),
            policy_defrag_interval_s=_parse_duration(
                block_key(defrag_block, "interval", 30.0)
            ),
            policy_defrag_budget=int(block_key(defrag_block, "budget", 4)),
        )


def _parse_duration(val) -> float:
    """'10m' / '30s' / '1h' / numeric seconds -> seconds."""
    if isinstance(val, (int, float)):
        return float(val)
    s = str(val).strip()
    units = {"ms": 1e-3, "s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0}
    for suffix in ("ms", "s", "m", "h", "d"):
        if s.endswith(suffix):
            return float(s[: -len(suffix)]) * units[suffix]
    return float(s)
