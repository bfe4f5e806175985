"""``csrc/qrcp.cu``: the first k greedy column pivots of an fp32 (r, n)
panel, row-scaled by an (r,) factor.

Bytes: the panel and the scale read once, the k pivots written once.
Operations: the initial column norms (2 r n), and at each of the k steps
the projection of every column on the new direction (2 r n) and the norm
downdate (2 n)."""

KERNEL = "qrcp_kernel"


def work(shape):
    """``shape = (r, n, k)`` → (operations, bytes)."""
    r, n, k = shape
    ops = 2.0 * r * n * (k + 1) + 2.0 * n * k
    nbytes = (r * n + r + k) * 4.0
    return ops, nbytes
