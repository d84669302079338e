"""Host time a queue window of the program's `queue.orders` span
(`kernel_orders`: the priority sorts and masks `fifo_pack` enqueues), from
the spans the port's tracer recorded in the traced slice; null where
`queue_pack_host_ms.queue` finds no span a window."""

from port_bench import harness


def read(records):
    spans = harness.load_module("metrics", "queue_pack_host_ms.queue").slice_spans(
        records)
    if spans is None:
        return None
    return sum(s.end - s.start for s in spans
               if s.name == "queue.orders") / records["windows"] * 1e3
