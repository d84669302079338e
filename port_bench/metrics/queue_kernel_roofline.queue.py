"""The queue kernel's share of its roofline: the least time
`roofline.queue_kernel_bound` allows for the traced windows over the
profiled time of the kernel on them, in percent of the H100 SXM peaks."""


def read(records):
    if not records:
        return None
    spent = records["profile"].kernel_s(match=records["kernel"])
    if spent <= 0:
        return None
    return records["kernel_bound_s"] / spent * 100.0
