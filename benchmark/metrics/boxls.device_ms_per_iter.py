"""Device busy time (union of the device operations' intervals) of the
traced batches per ADMM iteration, in ms."""


def read(trace, ctx):
    b, it = trace.counters.get("batches", 0), trace.counters.get(
        "admm_iters", 0)
    if not trace.device_ops or not b or not it:
        return None
    return trace.busy_s() / (b * it) * 1e3
