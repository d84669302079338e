"""Profiled device time of the queue kernel a traced window, in ms: in the
single-AZ cell every gang runs one fill and one zone score a zone there."""


def read(records):
    if not records or not records.get("windows"):
        return None
    spent = records["profile"].kernel_s(match=records["kernel"])
    if spent <= 0:
        return None
    return spent / records["windows"] * 1e3
