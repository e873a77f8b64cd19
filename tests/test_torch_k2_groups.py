"""Kernel K2's plan for many types (``pair_train_cuda.pair_groups``) on the
CPU: the ranges cover every type pair once, every pass's block fits the
card's shared memory, the train shapes (capacities 48-72, K = 16) sum
every pair in one pass up to eight types, and the passes write every
moment column of the ``[n_cells, P * 2K]`` partial sums exactly once, at
the column of its pair in ``chebyshev.type_pairs`` order."""

import pytest

from hoomd_tf_tpu_torch.ops import pair_train_cuda as ptc
from hoomd_tf_tpu_torch.ops.chebyshev import type_pairs

MAX_SMEM = 232448


@pytest.mark.parametrize("f64", [0, 1])
@pytest.mark.parametrize("K", [8, 16, 32])
def test_groups_cover_types_and_fit(f64, K):
    for T in list(range(1, 9)) + [40, 60]:
        P = T * (T + 1) // 2
        top = ptc.max_capacity(f64, K, T)
        assert top >= 200
        for cap in sorted({1, 16, 29, 48, 72, 100, top // 2, top}):
            groups = ptc.pair_groups(f64, cap, K, T)
            assert [p for lo, hi in groups for p in range(lo, hi)] == \
                list(range(P))
            Q = groups[0][1] - groups[0][0]
            assert all(hi - lo == Q for lo, hi in groups[:-1])
            assert 0 < groups[-1][1] - groups[-1][0] <= Q
            assert ptc.smem_bytes(f64, cap, K, T, Q) <= MAX_SMEM
            if Q < P:  # the most pairs a pass that fit
                assert ptc.smem_bytes(f64, cap, K, T, Q + 1) > MAX_SMEM
        with pytest.raises(ValueError, match="shared memory"):
            ptc.pair_groups(f64, top + 1, K, T)


@pytest.mark.parametrize("f64", [0, 1])
@pytest.mark.parametrize("T", [1, 2])
def test_train_shapes_keep_one_group(f64, T):
    """The train shapes (one and two types, capacities 48 and 72, K = 16)
    sum every type pair in one pass; the untyped block keeps the
    register path's bytes (the staging and 2K sums a warp)."""
    for cap in (48, 72):
        assert ptc.pair_groups(f64, cap, 16, T) == [(0, T * (T + 1) // 2)]
    s = 8 if f64 else 4
    staging = 14 * 48 * (8 * s + 4) + ptc._stage_bytes(s)
    assert ptc.smem_bytes(f64, 48, 16, 1, 1) == staging + s * 9 * 32


def test_failing_shapes_split():
    """The shapes the per-thread moment sets had to split into type groups
    (three types and up in double, six and up in float32, capacity 48,
    K = 16) take one pass of every pair; the plan splits only past ~34
    types in double and ~53 in float32 at the train capacities."""
    assert ptc.pair_groups(1, 48, 16, 3) == [(0, 6)]
    assert ptc.pair_groups(1, 48, 16, 5) == [(0, 15)]
    assert ptc.pair_groups(1, 72, 16, 8) == [(0, 36)]
    assert ptc.pair_groups(0, 48, 16, 8) == [(0, 36)]
    assert len(ptc.pair_groups(1, 72, 16, 33)) == 1
    assert len(ptc.pair_groups(1, 72, 16, 40)) == 2
    assert len(ptc.pair_groups(0, 72, 16, 52)) == 1
    assert len(ptc.pair_groups(0, 72, 16, 60)) == 2


@pytest.mark.parametrize("T,Q", [(1, 1), (2, 3), (3, 2), (5, 4), (8, 36),
                                 (8, 5), (7, 1)])
def test_pair_groups_write_each_column_once(T, Q):
    """The passes of ``Q`` pairs (``tile_block``'s loop over ``p0``):
    every column ``p * 2K + m`` of a partial row once, ``p`` the pair's
    place in ``type_pairs`` order, which the kernel finds from the pass's
    local pair index by walking the types (``a`` pairs with ``a .. T -
    1``)."""
    K2 = 4
    pairs = type_pairs(T)
    P = len(pairs)
    written = []
    for p0 in range(0, P, Q):
        for q in range(min(Q, P - p0)):
            a, l = 0, p0 + q
            while l >= T - a:
                l -= T - a
                a += 1
            assert pairs[p0 + q] == (a, a + l)
            written += [(p0 + q) * K2 + m for m in range(K2)]
    assert sorted(written) == list(range(P * K2))
