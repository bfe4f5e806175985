"""``csrc/chol.cu``'s share of its roofline, in %: the least time its work
at the traced (B, p) takes at the published peaks (``roofline/chol.py``),
over the median device time of its launches in the trace."""

import statistics


def read(trace, ctx):
    from benchmark import roofline
    rf = roofline.kernel("chol")
    ts = [e - s for _, s, e in trace.kernels(rf.KERNEL)]
    shape = trace.counters.get("chol_shape")
    if not ts or shape is None:
        return None
    return 100.0 * roofline.bound_s(*rf.work(shape)) / statistics.median(ts)
