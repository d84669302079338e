"""The native write-back queue lane, in each package.

The twin of the queue cases of tests/test_native_runtime.py: the sharded
queue that each package's write-through caches drain through. Every case
runs against the JAX package (its native library loaded with
tests/test_torch_native.py `load_jax_native`) and the port. Both select
the native queue by default and the Python queue with
`prefer_native=False`, and the two queues share their dedup, delete,
sharding, buffering and blocking semantics. A case that pushes one
sequence through all four queues holds their observable states equal.
The port's own case: a failing compiler raises from the factory, where
the JAX package falls back to the Python queue.
"""

from __future__ import annotations

import importlib
import threading

import pytest

from tests.test_torch_native import load_jax_native

JAX = "spark_scheduler_tpu"
PORT = "spark_scheduler_tpu_torch"
ROOTS = (JAX, PORT)


def mods(root):
    if root == JAX:
        load_jax_native()
    native = importlib.import_module(f"{root}.native")
    queue = importlib.import_module(f"{root}.store.queue")
    return native, queue


def req(queue, ns, name, typ="CREATE"):
    return queue.Request(key=(ns, name), type=queue.RequestType[typ])


@pytest.mark.parametrize("root", ROOTS)
def test_native_queue_is_selected_and_python_queue_on_request(root):
    native, queue = mods(root)
    assert isinstance(queue.make_sharded_queue(5), native.NativeShardedQueue)
    assert isinstance(
        queue.make_sharded_queue(5, prefer_native=False),
        queue.ShardedUniqueQueue,
    )


@pytest.mark.parametrize("root", ROOTS)
def test_native_queue_dedup_and_delete_semantics(root):
    _, queue = mods(root)
    for q in (queue.make_sharded_queue(4), queue.ShardedUniqueQueue(4)):
        q.add_if_absent(req(queue, "ns", "a"))
        q.add_if_absent(req(queue, "ns", "a", "UPDATE"))  # deduped
        q.add_if_absent(req(queue, "ns", "a", "DELETE"))  # never deduped
        assert sum(q.queue_lengths()) == 2, type(q).__name__
        popped = []
        for b in range(q.num_buckets):
            while (r := q.pop(b, timeout_s=0)) is not None:
                popped.append(r)
        assert [r.type.name for r in popped] == ["CREATE", "DELETE"]
        # Released on pop: the same key enqueues again.
        q.add_if_absent(req(queue, "ns", "a", "UPDATE"))
        assert sum(q.queue_lengths()) == 1


@pytest.mark.parametrize("root", ROOTS)
def test_native_queue_same_key_same_bucket_and_blocking_pop(root):
    native, queue = mods(root)
    q = queue.make_sharded_queue(4)
    assert isinstance(q, native.NativeShardedQueue)
    for i in range(32):
        q.add_if_absent(req(queue, "ns", f"k{i}"))
    lengths = q.queue_lengths()
    assert sum(lengths) == 32 and len(lengths) == 4

    q2 = queue.make_sharded_queue(4)
    q2.add_if_absent(req(queue, "ns", "stable"))
    b1 = [i for i, n in enumerate(q2.queue_lengths()) if n][0]
    assert q2.pop(b1, timeout_s=0).key == ("ns", "stable")
    q2.add_if_absent(req(queue, "ns", "stable"))
    b2 = [i for i, n in enumerate(q2.queue_lengths()) if n][0]
    assert b1 == b2

    got = []
    t = threading.Thread(target=lambda: got.append(q2.pop(b1, timeout_s=5.0)))
    q2.pop(b1, timeout_s=0)  # drain first
    t.start()
    q2.add_if_absent(req(queue, "ns", "stable"))
    t.join(timeout=10)
    assert got and got[0] is not None and got[0].key == ("ns", "stable")


@pytest.mark.parametrize("root", ROOTS)
def test_native_queue_try_add_full_buffer(root):
    native, queue = mods(root)
    q = native.NativeShardedQueue(1, buffer_size=2)
    assert q.try_add_if_absent(req(queue, "ns", "x1"))
    assert q.try_add_if_absent(req(queue, "ns", "x2"))
    assert not q.try_add_if_absent(req(queue, "ns", "x3"))  # full
    assert q.try_add_if_absent(req(queue, "ns", "x1", "UPDATE"))  # deduped
    q.pop(0, timeout_s=0)
    assert q.try_add_if_absent(req(queue, "ns", "x3"))


@pytest.mark.parametrize("root", ROOTS)
def test_native_queue_concurrent_producers_consumers(root):
    _, queue = mods(root)
    q = queue.make_sharded_queue(3, buffer_size=1000)
    n_per, n_prod = 200, 4
    consumed = []
    consumed_lock = threading.Lock()
    stop = threading.Event()

    def consumer(bucket):
        while not stop.is_set():
            r = q.pop(bucket, timeout_s=0.02)
            if r is not None:
                with consumed_lock:
                    consumed.append(r.key)

    consumers = [threading.Thread(target=consumer, args=(b,)) for b in range(3)]
    for c in consumers:
        c.start()

    def producer(p):
        for i in range(n_per):
            q.add_if_absent(req(queue, f"ns{p}", f"key-{p}-{i}"))

    producers = [
        threading.Thread(target=producer, args=(p,)) for p in range(n_prod)
    ]
    for t in producers:
        t.start()
    for t in producers:
        t.join()
    wait = threading.Event()
    for _ in range(200):
        with consumed_lock:
            if len(consumed) == n_per * n_prod:
                break
        wait.wait(0.05)
    stop.set()
    for c in consumers:
        c.join(timeout=5)
    assert len(consumed) == n_per * n_prod
    assert len(set(consumed)) == n_per * n_prod


def test_one_sequence_leaves_every_queue_in_one_state():
    """The same adds, dedups, deletes and pops through the native and the
    Python queue of both packages: equal bucket lengths after every step
    and equal pops."""
    queues = []
    for root in ROOTS:
        _, queue = mods(root)
        queues += [
            (queue, queue.make_sharded_queue(5)),
            (queue, queue.make_sharded_queue(5, prefer_native=False)),
        ]
    steps = [("add", f"k{i % 7}", ("CREATE", "UPDATE", "DELETE")[i % 3])
             for i in range(40)]
    steps[10:10] = [("pop", 1, None), ("pop", 3, None)]
    steps.append(("pop", 0, None))
    for step in steps:
        seen = []
        for queue, q in queues:
            if step[0] == "add":
                q.add_if_absent(req(queue, "ns", step[1], step[2]))
                seen.append(tuple(q.queue_lengths()))
            else:
                r = q.pop(step[1], timeout_s=0)
                seen.append((None if r is None else (r.key, r.type.name),
                             tuple(q.queue_lengths())))
        assert len(set(seen)) == 1, (step, seen)


def test_port_queue_raises_without_a_compiler(tmp_path, monkeypatch):
    """No silent degrade: the port's factory builds the native runtime or
    raises (the JAX factory falls back to the Python queue)."""
    native, queue = mods(PORT)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="compiler not found"):
        queue.make_sharded_queue(5)
    assert isinstance(
        queue.make_sharded_queue(5, prefer_native=False),
        queue.ShardedUniqueQueue,
    )
