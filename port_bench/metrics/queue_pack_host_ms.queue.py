"""Host time a queue window of the program's `queue.pack` span (`fifo_pack`,
entry to return: checks, orders, operands, the kernel's launch, outputs),
from the spans the port's tracer recorded in the traced slice."""

from spark_scheduler_tpu_torch import tracing


def slice_spans(records):
    """The finished spans that start and end inside the traced slice, or
    None unless they hold exactly one `queue.pack` span a window: a route
    that bypasses the span, a program without it, or a ring that overflowed
    reads null, not a wrong number."""
    if not records:
        return None
    finished = getattr(tracing.tracer(), "finished", None)
    if finished is None:
        return None
    p = records["profile"]
    spans = [s for s in finished() if p.t0 <= s.start and s.end <= p.t1]
    packs = sum(s.name == "queue.pack" for s in spans)
    if not packs or packs != records["windows"]:
        return None
    return spans


def read(records):
    spans = slice_spans(records)
    if spans is None:
        return None
    return sum(s.end - s.start for s in spans
               if s.name == "queue.pack") / records["windows"] * 1e3
