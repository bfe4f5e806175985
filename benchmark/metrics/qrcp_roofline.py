"""``csrc/qrcp.cu``'s share of its roofline, in %: the least time its work
at the traced shape takes at the published peaks (``roofline/qrcp.py``),
over the median device time of its launches in the trace."""

import statistics


def read(trace, ctx):
    from benchmark import roofline
    rf = roofline.kernel("qrcp")
    ts = [e - s for _, s, e in trace.kernels(rf.KERNEL)]
    shape = trace.counters.get("qrcp_shape")
    if not ts or shape is None:
        return None
    return 100.0 * roofline.bound_s(*rf.work(shape)) / statistics.median(ts)
