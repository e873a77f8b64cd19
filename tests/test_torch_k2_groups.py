"""Kernel K2's plan for many types (``pair_train_cuda.type_groups``) on the
CPU: the groups cover every type once, every group's block fits the card's
shared memory, one and two types keep the one-row launch at the train
shapes (capacity 48, K = 16), and a model of the kernel's grid rows
(``csrc/proxy_bwd.cu::GroupPair``) writes every moment column of the
``[n_cells, P * 2K]`` partial sums exactly once, with every ordered lane
type (ti, tj) walked by exactly one row."""

import itertools

import pytest

from hoomd_tf_tpu_torch.ops import pair_train_cuda as ptc
from hoomd_tf_tpu_torch.ops.chebyshev import type_pairs

MAX_SMEM = 232448


@pytest.mark.parametrize("f64", [0, 1])
@pytest.mark.parametrize("K", [8, 16, 32])
def test_groups_cover_types_and_fit(f64, K):
    for T in range(1, 9):
        top = ptc.max_capacity(f64, K, T)
        assert top >= 48 or K == 32
        for cap in sorted({1, 16, 29, 48, 72, 100, top // 2, top}):
            if cap > top:
                continue
            groups = ptc.type_groups(f64, cap, K, T)
            assert [t for lo, hi in groups for t in range(lo, hi)] == \
                list(range(T))
            G = groups[0][1] - groups[0][0]
            assert all(hi - lo == G for lo, hi in groups[:-1])
            assert 0 < groups[-1][1] - groups[-1][0] <= G
            assert ptc.smem_bytes(f64, cap, K, T, G) <= MAX_SMEM
            if G < T:  # the largest group that fits
                assert ptc.smem_bytes(f64, cap, K, T, G + 1) > MAX_SMEM
        with pytest.raises(ValueError, match="shared memory"):
            ptc.type_groups(f64, top + 1, K, T)


@pytest.mark.parametrize("f64", [0, 1])
@pytest.mark.parametrize("T", [1, 2])
def test_train_shapes_keep_one_group(f64, T):
    """Today's phases (one and two types, capacity 48, K = 16) launch one
    grid row, with the bytes of the one-group block."""
    assert ptc.type_groups(f64, 48, 16, T) == [(0, T)]


def test_failing_shapes_split():
    """The shapes the wrapper refused before: three types and up in double,
    six and up in float32 (capacity 48, K = 16)."""
    assert ptc.smem_bytes(1, 48, 16, 3, 3) > MAX_SMEM
    assert ptc.smem_bytes(0, 48, 16, 6, 6) > MAX_SMEM
    assert ptc.type_groups(1, 48, 16, 3) == [(0, 2), (2, 3)]
    assert ptc.type_groups(1, 48, 16, 5) == [(0, 2), (2, 4), (4, 5)]
    assert ptc.type_groups(0, 48, 16, 8) == [(0, 5), (5, 8)]


def _grid_rows(T, G):
    """``GroupPair`` for every grid row: ``(a0, a1, b0, b1, same)``."""
    G = min(G, T)
    nb = -(-T // G)
    rows = []
    for i, j in itertools.combinations_with_replacement(range(nb), 2):
        rows.append((i * G, min(T, i * G + G), j * G, min(T, j * G + G),
                     i == j))
    return rows


def _row_pairs(a0, a1, b0, b1, same):
    return [(a, b) for a in range(a0, a1)
            for b in range(a if same else b0, b1)]


@pytest.mark.parametrize("T,G", [(1, 1), (2, 2), (3, 2), (5, 2), (8, 5),
                                 (8, 3), (7, 1)])
def test_grid_rows_write_each_column_once(T, G):
    K2 = 4
    order = {p: k for k, p in enumerate(type_pairs(T))}
    written = []
    lanes = []
    for a0, a1, b0, b1, same in _grid_rows(T, G):
        pairs = _row_pairs(a0, a1, b0, b1, same)
        for lp, (a, b) in enumerate(pairs):
            for m in range(K2):
                col = (a * T - a * (a - 1) // 2 + (b - a)) * K2 + m
                assert col == order[(a, b)] * K2 + m
                written.append(col)
        # the lanes a row walks: row type in one group, candidate type in
        # the other (GroupPair.other)
        for ti in range(T):
            if a0 <= ti < a1:
                lanes += [(ti, tj) for tj in range(b0, b1)]
            elif b0 <= ti < b1:
                lanes += [(ti, tj) for tj in range(a0, a1)]
    assert sorted(written) == list(range(len(order) * K2))
    assert sorted(lanes) == sorted(itertools.product(range(T), repeat=2))
