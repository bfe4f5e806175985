"""Device time of the matrix-product kernels (names holding ``gemm`` or
``gemv``) per fit in the traced window, in ms."""


def read(trace, ctx):
    fits = trace.counters.get("fits", 0)
    ks = [k for k in trace.kernels()
          if "gemm" in k[0].lower() or "gemv" in k[0].lower()]
    if not ks or not fits:
        return None
    return sum(e - s for _, s, e in ks) / fits * 1e3
