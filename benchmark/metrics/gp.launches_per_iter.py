"""Device kernels of the traced GP-ROM trainings per Adam iteration of the
slowest mode."""


def read(trace, ctx):
    it = trace.counters.get("iterations", 0)
    n = trace.counters.get("trainings", 0)
    if not trace.device_ops or not it or not n:
        return None
    return len(trace.kernels()) / (n * it)
