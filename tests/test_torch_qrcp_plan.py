"""The launch plan of the QRCP CUDA kernel (``qrcp_cuda._plan``), on the CPU.

The plan is pure arithmetic on the panel's shape and the device's SM
count, shared memory and occupancy, so it is tested here with those given
explicitly: an H100 SXM (132 SMs, 227 KB of dynamic shared memory a block,
one 1024-thread block per SM) and a few other devices.
"""

import pytest

from openmeasure_torch.linalg import qrcp_cuda as TQC

H100 = dict(sms=132, smem_optin=232448, blocks_per_sm=1)

CASES = [
    # (r, n, k, device)
    (14, 165258, 14, H100),                  # flagship: all resident
    (14, 1723599, 14, H100),                 # 3D: part resident
    (14, 2000000, 14, H100),                 # part resident, card test size
    (14, 100, 14, H100),                     # n smaller than the grid
    (5, 1001, 5, H100),                      # ragged last block
    (1, 1, 1, H100),                         # one column
    (14, 14, 14, H100),                      # k = n
    (8192, 2048, 4, H100),                   # tall: a few resident columns
    (60000, 300, 4, H100),                   # taller than a block's smem
    (70000, 300, 4, H100),                   # none resident
    (14, 165258, 14, dict(sms=114, smem_optin=232448, blocks_per_sm=1)),
    (14, 1723599, 14, dict(sms=132, smem_optin=101376, blocks_per_sm=2)),
    (14, 2 ** 31 - 1, 128, H100),            # largest n the wrapper takes
    (17, 500000, 14, H100),
]


def _owned(plan, n):
    """Column ranges of the blocks, in block order."""
    return [(b * plan.cols_per_block,
             min(n, (b + 1) * plan.cols_per_block)) for b in range(plan.grid)]


@pytest.mark.parametrize("r,n,k,dev", CASES)
def test_plan_covers_every_column_once_within_the_device(r, n, k, dev):
    p = TQC._plan(r, n, k, **dev)
    ranges = _owned(p, n)
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(hi > lo for lo, hi in ranges)                  # no empty block
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert 1 <= p.grid <= dev["sms"] * dev["blocks_per_sm"]
    assert p.grid <= -(-n // TQC.MIN_COLS)
    assert p.smem_bytes == 4 * (p.q_floats + p.resident * r)
    assert p.smem_bytes <= dev["smem_optin"]
    assert 0 <= p.resident <= p.cols_per_block
    if p.resident < p.cols_per_block:     # columns streamed: L1 keeps room
        assert p.smem_bytes <= max(4 * p.q_floats,
                                   dev["smem_optin"] - TQC.L1_KEEP)
    assert p.resident_cols == sum(min(p.resident, hi - lo)
                                  for lo, hi in ranges)
    assert p.q_floats == (k * r if k * r <= TQC.Q_STAGE_FLOATS else 0)
    assert p.barriers == 2 * k


@pytest.mark.parametrize("r,n,regime", [
    (14, 165258, "all"), (14, 50000, "all"), (14, 5000, "all"),
    (14, 1723599, "part"), (14, 2000000, "part"), (8192, 2048, "part"),
    (60000, 300, "none"), (70000, 300, "none"),
])
def test_plan_residency_regimes(r, n, regime):
    p = TQC._plan(r, n, 4, **H100)
    if regime == "all":
        assert p.resident_cols == n
    elif regime == "part":
        assert 0 < p.resident_cols < n
    else:
        assert p.resident == p.resident_cols == 0


def test_plan_flagship_and_3d_numbers():
    """The main path's two panels on an H100: the flagship's 9.25 MB panel
    is held whole, 1252 columns (70 KB) a block, beside Q (14 × 14); of the
    3D panel's 13,058 columns a block, as many as fit in all but the 64 KB
    left to L1, about 23 %."""
    f = TQC._plan(14, 165258, 14, **H100)
    assert (f.grid, f.cols_per_block, f.resident) == (132, 1252, 1252)
    assert f.q_floats == 196
    assert f.smem_bytes == 4 * (196 + 1252 * 14)
    c = TQC._plan(14, 1723599, 14, **H100)
    assert (c.grid, c.cols_per_block) == (132, 13058)
    assert c.resident == (232448 - 4 * 196 - TQC.L1_KEEP) // (4 * 14)
    assert 0.22 < c.resident_cols / 1723599 < 0.24


def test_plan_tall_panels():
    """r = 8192 leaves room for 5 columns a block beside the 64 KB kept
    for L1, and does not stage Q; r = 70,000 holds nothing in shared
    memory."""
    t = TQC._plan(8192, 2048, 4, **H100)
    assert (t.q_floats, t.resident) == (0, 5)
    assert t.grid == 64 and t.cols_per_block == 32
    z = TQC._plan(70000, 300, 4, **H100)
    assert (z.q_floats, z.resident, z.smem_bytes) == (0, 0, 0)


def test_plan_small_and_ragged_panels():
    """n below the SM count gives fewer, fuller blocks; a ragged n leaves
    a short last block that still owns at least one column."""
    s = TQC._plan(14, 100, 14, **H100)
    assert s.grid == 4 and s.cols_per_block == 25
    g = TQC._plan(5, 1001, 5, **H100)
    assert g.grid == 32 and g.cols_per_block == 32
    assert 1001 - (g.grid - 1) * g.cols_per_block == 9


@pytest.mark.parametrize("sms,per_sm", [(0, 1), (132, 0)])
def test_plan_refuses_a_device_with_no_coresident_block(sms, per_sm):
    with pytest.raises(ValueError, match="co-resident"):
        TQC._plan(14, 1000, 14, sms=sms, smem_optin=232448,
                  blocks_per_sm=per_sm)
