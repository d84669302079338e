"""Share of the traced slice's wall time in which no operation ran on the
card while the host was inside the program's `queue.pack` span: the
measure of (the slice less the union of profiled device intervals) within
the `queue.pack` spans, over the slice's wall time. What
`device_idle_share.queue` holds beyond it is idle time outside the
program: the caller's copies and loop. Null where
`queue_pack_host_ms.queue` finds no span a window."""

from port_bench import harness


def _overlap(a, b):
    """Measure of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(records):
    spans = harness.load_module("metrics", "queue_pack_host_ms.queue").slice_spans(
        records)
    p = records and records["profile"]
    if spans is None or p.window_s <= 0:
        return None
    packs = []
    for a, b in sorted((s.start, s.end) for s in spans if s.name == "queue.pack"):
        if packs and a <= packs[-1][1]:
            packs[-1][1] = max(packs[-1][1], b)
        else:
            packs.append([a, b])
    inside = sum(b - a for a, b in packs)
    return (inside - _overlap(packs, p.busy_intervals())) / p.window_s
