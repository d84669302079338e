"""The port's tracer on the queue path, on the CPU.

- `tracing.Tracer` times spans on `time.perf_counter` (the clock the
  benchmark aligns device traces to) and still reports `timestamp_s` in
  epoch seconds; a clock passed in is used as given.
- `tracing.profiled_span` records nothing and makes no ids while no torch
  profiler runs, and under one records a span joined to the thread's
  current span that also shows by name in the exported Chrome trace, also
  in /debug/profile's trace when the span ran on another thread.
- `fifo_pack` is one `queue.pack` span with one `queue.orders` child, and
  `grouped_fifo_pack` over G groups one `queue.pack` with G children.
- A small traced run of the benchmark's `queue-10k-w100` cell reads the
  three per-layer metrics built on those spans, and reads none of them when
  the spans are patched away.
"""

import contextlib
import json
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from port_bench import generators, harness, run
from port_bench.tests.conftest import shrink
from spark_scheduler_tpu_torch import tracing
from spark_scheduler_tpu_torch.models.cluster import cluster_from_numpy
from spark_scheduler_tpu_torch.ops import fifo
from spark_scheduler_tpu_torch.ops.batched import make_app_batch
from spark_scheduler_tpu_torch.parallel import solve, stack_groups

CELL = "queue-10k-w100"
SPAN_METRICS = ("queue_pack_host_ms.queue", "queue_orders_host_ms.queue",
                "queue_idle_in_pack_share.queue")


@pytest.fixture
def fresh_tracer(monkeypatch):
    """A new default tracer, so spans other tests left in the ring do not
    count."""
    t = tracing.Tracer()
    monkeypatch.setattr(tracing, "_default_tracer", t)
    return t


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_tracer_spans_are_on_perf_counter_and_timestamps_are_epoch():
    t = tracing.Tracer()
    before_wall, before = time.time(), time.perf_counter()
    with t.span("outer"):
        with t.span("inner"):
            pass
    detached = tracing.Span("detached", "ab", "cd", None)
    t.begin_detached(detached)
    t.finish_detached(detached)
    after, after_wall = time.perf_counter(), time.time()
    spans = t.finished()
    assert [s.name for s in spans] == ["inner", "outer", "detached"]
    for s in spans:
        assert before <= s.start <= s.end <= after
    inner, outer, _ = spans
    assert inner.parent_id == outer.span_id and inner.trace_id == outer.trace_id
    dicts = t.finished_spans()
    for d, s in zip(dicts, spans):
        assert before_wall - 1e-3 <= d["timestamp_s"] <= after_wall + 1e-3
        assert d["duration_ms"] == round(s.duration_ms, 3)
    assert set(dicts[0]) == {"name", "traceId", "id", "parentId",
                             "timestamp_s", "duration_ms", "tags"}


def test_a_clock_passed_in_is_used_as_given():
    ticks = iter([100.0, 102.5])
    t = tracing.Tracer(clock=lambda: next(ticks))
    with t.span("s"):
        pass
    (d,) = t.finished_spans()
    assert d["timestamp_s"] == 100.0 and d["duration_ms"] == 2500.0
    (s,) = t.finished()
    assert (s.start, s.end) == (100.0, 102.5)


def test_device_path_span_records_nothing_without_a_profiler(fresh_tracer,
                                                             monkeypatch):
    made = []
    new_id = tracing._new_id
    monkeypatch.setattr(tracing, "_new_id",
                        lambda *a: made.append(a) or new_id(*a))
    assert not torch.autograd.profiler._is_profiler_enabled
    first = tracing.profiled_span("queue.pack", nodes=3)
    with first as span:
        span.tag("k", 1)
        with tracing.profiled_span("queue.orders") as child:
            assert child is first
    assert tracing.profiled_span("other") is first
    assert made == [] and fresh_tracer.finished() == []
    assert fresh_tracer.current() is None


def test_device_path_span_under_a_cpu_profiler(fresh_tracer, tmp_path):
    with cpu_profile() as prof:
        with fresh_tracer.span("request"):
            with tracing.profiled_span("queue.pack", nodes=3) as span:
                span.tag("rows", 2)
                torch.ones(3).add_(1)
        with pytest.raises(RuntimeError):
            with tracing.profiled_span("queue.orders"):
                raise RuntimeError("inside the span")
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    by_name = {s.name: s for s in fresh_tracer.finished()}
    pack, request = by_name["queue.pack"], by_name["request"]
    assert pack.parent_id == request.span_id
    assert pack.trace_id == request.trace_id
    assert request.start <= pack.start <= pack.end <= request.end
    assert pack.tags == {"nodes": 3, "rows": 2}
    assert by_name["queue.orders"].parent_id is None
    assert "error" in by_name["queue.orders"].tags
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert {"queue.pack", "queue.orders"} <= names
    # The profiler stopped: the span is the shared no-op again.
    with tracing.profiled_span("queue.pack"):
        pass
    assert len(fresh_tracer.finished()) == 3


def _queue(seed, nodes=48, rows=6):
    spec = dict(harness.load_json("configs", "spark-10k-tightly-pack")["cluster"],
                nodes=nodes)
    cluster = cluster_from_numpy(generators.queue_fields(generators.cluster(spec)),
                                 device="cpu")
    table = harness.load_json("workloads", CELL)["traffic"]["apps"]
    mix = generators.apps(generators.rng_for(seed, 1), table, rows)
    apps = make_app_batch(*generators.queue_apps(mix),
                          skippable=np.zeros(rows, bool))
    return cluster, apps


def _children(spans, parent):
    return [s for s in spans if s.parent_id == parent.span_id]


def test_fifo_pack_is_one_queue_pack_with_one_queue_orders(fresh_tracer):
    cluster, apps = _queue(3)
    with cpu_profile():
        out = fifo.fifo_pack(cluster, apps, emax=8, num_zones=4)
    spans = fresh_tracer.finished()
    packs = [s for s in spans if s.name == "queue.pack"]
    assert len(packs) == 1 and len(spans) == 2
    (orders,) = _children(spans, packs[0])
    assert orders.name == "queue.orders"
    assert packs[0].start <= orders.start <= orders.end <= packs[0].end
    assert packs[0].tags == {"nodes": 48, "rows": 6, "groups": 1}
    assert bool(out.admitted.any())


def test_debug_profile_trace_holds_the_queue_spans_of_other_threads(
        fresh_tracer, tmp_path):
    """/debug/profile's trace runs on a worker thread of its own; a queue
    solve on another thread still shows in it by name."""
    cluster, apps = _queue(5)
    assert tracing.start_torch_profile(str(tmp_path))
    try:
        worker = threading.Thread(
            target=fifo.fifo_pack, args=(cluster, apps),
            kwargs=dict(emax=8, num_zones=4))
        worker.start()
        worker.join(timeout=60)
        assert not worker.is_alive()
    finally:
        assert tracing.stop_torch_profile() == str(tmp_path)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"queue.pack", "queue.orders"} <= names
    assert [s.name for s in fresh_tracer.finished()] == ["queue.orders",
                                                         "queue.pack"]


@pytest.mark.parametrize("groups", [1, 3])
def test_grouped_fifo_pack_is_one_queue_pack_with_a_child_a_group(fresh_tracer,
                                                                 groups):
    subs = [_queue(10 + g) for g in range(groups)]
    clusters, apps = stack_groups([c for c, _ in subs], [a for _, a in subs])
    with cpu_profile():
        solve.grouped_fifo_pack(clusters, apps, emax=8, num_zones=4)
    spans = fresh_tracer.finished()
    (pack,) = [s for s in spans if s.name == "queue.pack"]
    children = _children(spans, pack)
    assert [s.name for s in children] == ["queue.orders"] * groups
    assert len(spans) == groups + 1
    assert pack.tags == {"nodes": 48, "rows": 6, "groups": groups}


@pytest.fixture
def small_cell(monkeypatch):
    """The benchmark's cells at the size its own CPU tests use, on one CPU
    thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    load = harness.load_json
    monkeypatch.setattr(harness, "load_json",
                        lambda kind, name: shrink(load(kind, name), kind))
    yield
    torch.set_num_threads(threads)


def _traced_run(seed):
    return run.run_cell(CELL, seed, 3.0, True, device="cpu",
                        t_start=time.perf_counter())


def test_a_traced_queue_run_reads_the_span_metrics(fresh_tracer, small_cell):
    out = _traced_run(2**31 + 41)
    assert out["correct"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(SPAN_METRICS) <= set(m)
    assert 0 < m["queue_orders_host_ms.queue"] <= m["queue_pack_host_ms.queue"]
    assert 0 < m["queue_idle_in_pack_share.queue"] <= m["device_idle_share.queue"]
    # The readers read only a slice holding one `queue.pack` a window.
    assert any(s.name == "queue.pack" for s in fresh_tracer.finished())


def test_a_traced_queue_run_without_the_spans_reads_none(fresh_tracer,
                                                         small_cell,
                                                         monkeypatch):
    monkeypatch.setattr(fifo, "profiled_span",
                        lambda name, **tags: contextlib.nullcontext())
    out = _traced_run(2**31 + 43)
    assert out["correct"] and "device_idle_share.queue" in out["metrics"]
    assert not set(SPAN_METRICS) & set(out["metrics"])
    assert fresh_tracer.finished() == []
