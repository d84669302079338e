"""The queue kernel's share of its roofline in the single-AZ cell: the
least time with one pass over the nodes a live row (`one_pass_bound_s`
of the single-AZ driver's records; the zones partition the nodes, so a
gang's zone fills together need no more node work than one plain fill)
over the profiled time of the kernel, in percent of the H100 SXM peaks.
Null without that record."""


def read(records):
    if not records or "one_pass_bound_s" not in records:
        return None
    spent = records["profile"].kernel_s(match=records["kernel"])
    if spent <= 0:
        return None
    return records["one_pass_bound_s"] / spent * 100.0
