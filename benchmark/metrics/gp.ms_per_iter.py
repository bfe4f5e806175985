"""Host wall of the traced GP-ROM training (the profiler recording the
device alone) per Adam iteration of its slowest mode
(``GPRResult.iterations``), in ms."""


def read(trace, ctx):
    it = trace.counters.get("iterations", 0)
    if not trace.call_walls or not it:
        return None
    return trace.call_walls[0] / it * 1e3
