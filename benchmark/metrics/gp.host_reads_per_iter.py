"""Reads of the card that the host waits on, per Adam iteration, in one
GP-ROM flow recorded by the program's recorder after the traced window:
its ``host_reads`` (each stop test of the Adam loop, one a block of
iterations, and the fit's ``eigh`` reads) over its ``gp.iter`` spans.
Nothing where the program records no iteration, or where there is no
card (a CPU run reads nothing back)."""


def read(trace, ctx):
    it = trace.counters.get("gp_iters", 0)
    if not trace.device_ops or not it:
        return None
    return trace.counters.get("host_reads", 0) / it
