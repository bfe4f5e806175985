"""``csrc/chol.cu``: a batch of B fp32 SPD (p, p) matrices to their
inverses and log-determinants.

Bytes: the matrices read once, the inverses and the log-determinants
written once.  Operations, counted on the triangles: the Cholesky Schur
updates (a multiply and a subtract per trailing lower-triangle element),
the forward substitution for L⁻¹ (a multiply and an add per element below
the step, per column up to it), the Gram L⁻ᵀL⁻¹ on its lower triangle,
and one reciprocal square root and one logarithm per pivot."""

KERNEL = "chol_inv_logdet_kernel"


def work(shape):
    """``shape = (B, p)`` → (operations, bytes)."""
    B, p = shape
    ops = (sum((p - 1 - j) * (p - j) for j in range(p))
           + sum(2 * (p - 1 - j) * (j + 1) for j in range(p))
           + sum(2 * (p - k) * (k + 1) for k in range(p)) + 2 * p) * B
    nbytes = (2 * B * p * p + B) * 4.0
    return float(ops), nbytes
