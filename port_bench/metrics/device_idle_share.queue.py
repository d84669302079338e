"""Share of the traced slice's wall time in which no operation ran on the
card: 1 - the union of profiled device intervals over the slice."""


def read(records):
    if not records or records["profile"].window_s <= 0:
        return None
    p = records["profile"]
    return 1.0 - p.busy_s() / p.window_s
