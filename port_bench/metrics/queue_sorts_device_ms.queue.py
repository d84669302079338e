"""Device time per queue window of every kernel but the queue kernel (the
orders' sorts and masks), from the traced slice's torch.profiler record."""


def read(records):
    if not records or not records.get("windows"):
        return None
    other = records["profile"].kernel_s(exclude=records["kernel"],
                                        kernels_only=True)
    return other / records["windows"] * 1e3
