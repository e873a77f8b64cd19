"""Kernel K3's design on the CPU: the float32 thresholds of its minimum
image against float64 reckoning, its minimum-image rule bit for bit
against ``d - round(d / L) * L``, its launch shapes, and a numpy model of
its strip algorithm (window staging, keys on the candidate's index in the
query's range, ranking, the rows written whole, the rows of particles
that hold no slot) against the plain version ``nlist_select_reference``.

The kernel itself runs only on the card (tests/test_torch_cuda.py); the
model here repeats its indexing and arithmetic so that a fault in them
shows on the CPU. Tolerances: none; the model and the rule compute the
same float32 operations as the reference, so results are equal
(displacements compared as numbers, the rule compared as bits)."""

import numpy as np
import pytest
import torch

from hoomd_tf_tpu_torch.ops import nlist_cuda as tnc
from hoomd_tf_tpu_torch.ops.nlist import f32

from torch_helpers import k3_inputs, np_

# the 64k fluid's box (density 0.4) and boxes of a 3 x 3 x 3 grid at
# r_cut 3
LENGTHS = [float((65536 / 0.4) ** (1 / 3)), 9.0, 10.0, 11.5, 11.999]


def f32_neighbours(x, k=4):
    """``x`` as float32 and its ``k`` float32 neighbours on either side."""
    v = np.float32(x)
    out = [v]
    lo = hi = v
    for _ in range(k):
        lo = np.nextafter(lo, np.float32(-np.inf))
        hi = np.nextafter(hi, np.float32(np.inf))
        out += [lo, hi]
    return out


@pytest.mark.parametrize("L", LENGTHS + [1.0, 3.0e-3, 7.77e5])
def test_thresholds_against_float64(L):
    """Each threshold is the float32 nearest its mark on the inward side
    (float64 reckoning), and float32 division puts it on the side of 0.5
    and 1.5 that it decides."""
    L32 = np.float32(L)
    Lf = float(L32)
    t0, t1, t2 = tnc.image_thresholds(L)
    for t in (t0, t1, t2):
        assert isinstance(t, np.float32)
    up = np.float32(np.inf)
    down = np.float32(-np.inf)
    assert float(t0) <= 0.49 * Lf < float(np.nextafter(t0, up))
    assert float(np.nextafter(t1, down)) < 0.51 * Lf <= float(t1)
    assert float(t2) <= 1.49 * Lf < float(np.nextafter(t2, up))
    assert np.rint(t0 / L32) == 0 and np.rint(t1 / L32) == 1 and \
        np.rint(t2 / L32) == 1
    assert np.rint(-t1 / L32) == -1 and np.rint(-t2 / L32) == -1


def sweep(L, seed):
    """float32 displacements for one axis of box ``L``: random ones out to
    3 L, and every critical value with its float32 neighbours: 0, +-L/2,
    +-L, +-1.5 L, the thresholds, 0.49/0.51/1.49 L, subnormals and what K3
    sees from an empty slot's far sentinel."""
    rng = np.random.RandomState(seed)
    L32 = np.float32(L)
    vals = list(rng.uniform(-3 * L, 3 * L, 4000).astype(np.float32))
    vals += list((rng.uniform(-1, 1, 2000) * L / 2).astype(np.float32))
    marks = [0.0, L32 / 2, L32, 1.5 * L32, 2 * L32, 2.5 * L32,
             0.49 * L32, 0.51 * L32, 1.49 * L32, 1e30, 1e30 - 7.0,
             np.float32(1e-40), np.float32(1.4e-45), np.float32(1.1e-38)]
    marks += [float(t) for t in tnc.image_thresholds(L)]
    for m in marks:
        for s in (1.0, -1.0):
            vals += f32_neighbours(np.float32(s * m), k=6)
    vals.append(np.float32(-0.0))
    return torch.as_tensor(np.asarray(vals, dtype=np.float32))


@pytest.mark.parametrize("L", LENGTHS)
def test_threshold_min_image_bit_equal(L):
    """The kernel's rule (thresholds, then the shift or the IEEE
    fallback) equals ``d - round(d / L) * L`` in every bit, signed zeros
    included, and the sweep reaches every branch of the rule."""
    d = sweep(L, seed=int(L * 1000) % 2 ** 31)
    Lt = torch.tensor(L, dtype=torch.float32)
    th = tnc.image_thresholds(L)
    got = tnc.threshold_min_image(d, Lt, th)
    want = d - torch.round(d / Lt) * Lt
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    a = d.abs()
    near = a <= float(th[0])
    one = (a >= float(th[1])) & (a <= float(th[2]))
    assert near.any() and one.any() and (~(near | one)).any()
    assert (d == Lt / 2).any() and (d.abs() < 1.2e-38).any()


def test_threshold_min_image_on_cell_slots():
    """The rule on K3's own inputs: candidate minus query over the 27-cell
    stencil of a 3 x 3 x 3 grid, where many |d| fall in the band around
    L / 2 that the thresholds leave to the division, and of an unwrapped
    copy shifted by whole boxes."""
    from hoomd_tf_tpu_torch.ops.cell_stencil import neighbor_cells
    (slots4, counts, pid, grid, cap, L), _ = k3_inputs(300, 10.0, seed=1,
                                                      unwrap=True)
    neigh = neighbor_cells(grid, "cpu")
    g = slots4.reshape(-1, cap, 4)[neigh].reshape(-1, 27 * cap, 4)
    q = slots4.reshape(-1, cap, 4)
    for a in range(3):
        d = (g[:, None, :, a] - q[:, :, None, a]).reshape(-1)
        d = d[d.abs() < 1e29]
        Lt = torch.tensor(L[a], dtype=torch.float32)
        th = tnc.image_thresholds(L[a])
        got = tnc.threshold_min_image(d, Lt, th)
        want = d - torch.round(d / Lt) * Lt
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        band = (d.abs() > float(th[0])) & (d.abs() < float(th[1]))
        assert band.any()


def test_launch_shape():
    """The packed path's plan (18^3, capacity 29, NN 64) gets 8 warps and
    strips of 2 cells, two blocks to an SM at least; a grid whose nx the
    strip does not divide gets a ragged last strip; large capacities
    shrink the strip, then the warps; a shape that cannot fit raises."""
    s, w, smem = tnc.launch_shape(18, 29, 64)
    assert (s, w) == (tnc.STRIP, 8) == (2, 8)
    assert smem == tnc.smem_bytes(29, 64, 2, 8)
    assert 2 * (smem + tnc._SMEM_RESERVED) <= tnc.SMEM_PER_SM
    s, w, _ = tnc.launch_shape(7, 29, 64)
    assert (s, w) == (2, 8) and 7 % s != 0
    assert tnc.launch_shape(3, 29, 64)[0] == 2
    s, w, smem = tnc.launch_shape(18, 80, 64)
    assert (s, w) == (1, 8) and smem > 48 * 1024
    s, w, smem = tnc.launch_shape(12, 200, 64)
    assert s == 1 and w < 8 and smem <= tnc.SMEM_PER_BLOCK
    assert tnc.launch_shape(18, 29, 64, strip=18) == \
        (18, 8, tnc.smem_bytes(29, 64, 18, 8))
    with pytest.raises(ValueError, match="does not fit"):
        tnc.launch_shape(18, 200, 64, strip=6, warps=8)
    with pytest.raises(ValueError, match="shared memory"):
        tnc.launch_shape(3, 2000, 64)


def test_launch_params():
    """The constants of a plan are made once and carry what the kernel
    reads: the shape, the slot mask of the JAX lane-padded width, the
    float32 cuts, lengths and thresholds."""
    L = (54.7, 54.7, 50.1)
    p = tnc.launch_params((18, 18, 16), 29, 64, 3.0, L)
    assert tnc.launch_params((18, 18, 16), 29, 64, 3.0, L) is p
    assert (p.nx, p.ny, p.nz, p.cap, p.nn) == (18, 18, 16, 29, 64)
    assert (p.strip, p.warps, p.n_strips) == (2, 8, 9)
    assert p.slot_mask == (1 << tnc.slot_bits(27 * 29)) - 1 == 1023
    assert p.rc2 == f32(9.0) and p.lo2 == f32(25e-8)
    assert list(p.L) == [f32(v) for v in L]
    for a in range(3):
        assert (p.t0[a], p.t1[a], p.t2[a]) == tuple(
            float(t) for t in tnc.image_thresholds(L[a]))
    with pytest.raises(ValueError, match=">= 3 cells"):
        tnc.launch_params((18, 2, 18), 29, 64, 3.0, L)


# ---------------------------------------------------------------------------
# A numpy model of the kernel's strip algorithm
# ---------------------------------------------------------------------------

def emulate_k3(slots4, counts, pid, grid, cap, NN, r_cut, lengths, n,
               strip=None):
    """K3's algorithm step by step on the CPU (csrc/nlist_select.cu):
    strips of cells along x, the window staged column by column, keys on
    the candidate's index in the query's contiguous range, 32-candidate
    chunks that skip the minimum image when every |d| <= t0, the winners
    in rank order, rows written whole (NaN first, as torch.empty may
    leave them), and zero rows for particles that hold no slot."""
    nx, ny, nz = grid
    s_len = strip or tnc.launch_shape(nx, cap, NN)[0]
    slots, cnt, pids = np_(slots4), np_(counts), np_(pid)
    L = [torch.tensor(f32(v), dtype=torch.float32) for v in lengths]
    th = [tnc.image_thresholds(v) for v in lengths]
    t0 = np.asarray([t[0] for t in th], np.float32)
    mask = np.uint32((1 << tnc.slot_bits(27 * cap)) - 1)
    rc2, lo2 = np.float32(f32(r_cut * r_cut)), np.float32(f32(25e-8))
    out = np.full((n, NN, 4), np.nan, np.float32)
    held = np.zeros(n, bool)

    def exact(d):
        return np.stack([np_(tnc.threshold_min_image(
            torch.as_tensor(d[:, a]), L[a], th[a])) for a in range(3)], 1)

    for z0 in range(nz):
        for y0 in range(ny):
            for x0 in range(0, nx, s_len):
                S = min(s_len, nx - x0)
                cells = []
                for xw in range(S + 2):
                    for row in range(9):
                        ry, rz = divmod(row, 3)
                        cells.append(((x0 - 1 + xw) % nx) + nx * (
                            ((y0 - 1 + ry) % ny) + ny * ((z0 - 1 + rz) % nz)))
                start = np.concatenate([[0], np.cumsum(cnt[cells])])
                cand = np.concatenate(
                    [slots[c * cap:c * cap + cnt[c]] for c in cells] +
                    [np.zeros((0, 4), np.float32)])
                for i in range(S):
                    wq = 9 * (i + 1) + 4
                    lo, hi = start[9 * i], start[9 * i + 27]
                    g = cand[lo:hi]
                    for qr in range(cnt[cells[wq]]):
                        q = cand[start[wq] + qr]
                        d = g[:, :3] - q[:3]
                        kept = np.zeros(0, np.uint32)
                        for c0 in range(0, len(d), 32):
                            ch = d[c0:c0 + 32]
                            if (np.abs(ch) > t0).any():
                                ch = exact(ch)
                            d2 = (ch[:, 0] * ch[:, 0] +
                                  ch[:, 1] * ch[:, 1]) + ch[:, 2] * ch[:, 2]
                            ok = (d2 <= rc2) & (d2 >= lo2)
                            key = (d2.view(np.uint32) & ~mask) | np.arange(
                                c0, c0 + len(ch), dtype=np.uint32)
                            kept = np.concatenate([kept, key[ok]])
                        win = np.sort(kept)[:NN] & mask
                        row = np.zeros((NN, 4), np.float32)
                        if len(win):
                            gw = g[win]
                            row[:len(win), :3] = exact(gw[:, :3] - q[:3])
                            row[:len(win), 3] = gw[:, 3]
                        p = pids[cells[wq] * cap + qr]
                        out[p] = row
                        held[p] = True
    out[~held] = 0.0
    return out


@pytest.mark.parametrize("case", [
    "3x3x3 grid", "3x3x3 unwrapped", "ragged strips", "one-cell strips",
    "three-cell strips", "whole-row strip", "empty and half-full cells",
    "NN below valid", "lattice ties", "overflow"])
def test_strip_algorithm_matches_plain(case):
    """The kernel's algorithm (numpy model) equals the plain version on
    the same slots: a 3 x 3 x 3 grid (the window holds a column twice, and
    many |d| fall in the band the thresholds leave to the division),
    unwrapped positions, a 7-cell x axis in its ragged default strips and
    in strips of 3, 3 and 1, strips of one cell and of the whole row,
    empty and half-full cells, NN = 8 against ~40 valid, an exact lattice
    (rows of tied distances, ordered by the candidate slot alone) and an
    overflowed cell (rows of particles that hold no slot are zero)."""
    n, L, NN, strip, cap, kw = 300, 10.0, 64, None, None, {}
    if case == "3x3x3 unwrapped":
        kw = dict(unwrap=True)
    elif case == "ragged strips":
        n, L = 700, 21.5
    elif case == "one-cell strips":
        n, L, strip = 500, 15.5, 1
    elif case == "whole-row strip":
        n, L, strip = 500, 15.5, 5
    elif case == "three-cell strips":
        n, L, strip = 700, 21.5, 3
    elif case == "empty and half-full cells":
        n, L, kw = 250, 15.5, dict(sparse=0.5, unwrap=True)
    elif case == "NN below valid":
        NN = 8
    elif case == "lattice ties":
        n, kw = 512, dict(lattice=True, unwrap=True)
    elif case == "overflow":
        cap = 6
    (slots4, counts, pid, grid, cap, lengths), _ = k3_inputs(
        n, L, seed=3, cap=cap, **kw)
    if case == "ragged strips":
        assert grid[0] == 7 and 7 % tnc.launch_shape(7, cap, NN)[0]
    if case == "empty and half-full cells":
        occ = np_(counts)
        assert (occ == 0).any() and ((occ > 0) & (occ < cap / 2)).any()
    if case == "overflow":
        assert int(counts.sum()) < n
    got = emulate_k3(slots4, counts, pid, grid, cap, NN, 3.0, lengths, n,
                     strip)
    want = np_(tnc.nlist_select_reference(slots4, counts, pid, grid, cap,
                                          NN, 3.0, lengths, n))
    np.testing.assert_array_equal(got, want)
    filled = (want[..., :3] != 0).any(-1).sum(1)
    assert filled.max() > 0
    if case == "NN below valid":
        assert (filled == NN).mean() > 0.5
