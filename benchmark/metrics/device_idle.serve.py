"""The device's idle share of the traced window, in %: 100 × (1 − the
union of the device operations' intervals over the window)."""


def read(trace, ctx):
    return trace.idle_pct()
