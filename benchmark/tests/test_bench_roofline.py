"""The roofline work of the two hand-written kernels, against counts
worked out by hand at one shape each."""

from conftest import CHECKOUT  # noqa: F401


def test_qrcp_work_by_hand():
    from benchmark import roofline
    ops, nbytes = roofline.kernel("qrcp").work((14, 1_723_599, 14))
    # bytes: the 14 x 1,723,599 fp32 panel, its 14 scales and 14 pivots
    assert nbytes == (24_130_386 + 14 + 14) * 4 == 96_521_656
    # initial norms 2·14·n, per step a projection 2·14·n and a downdate 2·n
    n = 1_723_599
    assert ops == 2 * 14 * n + 14 * (2 * 14 * n + 2 * n) == 772_172_352
    bound = roofline.bound_s(ops, nbytes)
    assert abs(bound - 96_521_656 / 3.35e12) < 1e-15   # bytes bind


def test_chol_work_by_hand():
    from benchmark import roofline
    ops, nbytes = roofline.kernel("chol").work((14, 41))
    # bytes: 14 matrices of 41 x 41 in, their inverses out, 14 logdets
    assert nbytes == (2 * 14 * 41 * 41 + 14) * 4 == 188_328
    p = 41
    schur = sum(q * (q + 1) for q in range(p))          # 22,960
    subst = 2 * sum((p - 1 - j) * (j + 1) for j in range(p))  # 22,960
    gram = 2 * sum((p - k) * (k + 1) for k in range(p))       # 24,682
    assert (schur, subst, gram) == (22_960, 22_960, 24_682)
    assert ops == 14 * (schur + subst + gram + 2 * p) == 989_576
    assert roofline.bound_s(ops, nbytes) == max(989_576 / 67e12,
                                                188_328 / 3.35e12)
