"""Device kernels launched per served batch in the traced window."""


def read(trace, ctx):
    b = trace.counters.get("batches", 0)
    if not trace.device_ops or not b:
        return None
    return len(trace.kernels()) / b
