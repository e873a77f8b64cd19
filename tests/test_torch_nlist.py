"""Port vs JAX package: the neighbor-list builds of the packed path (the
dense ``compute_nlist``, the cell list's sort method and kernel K3's
plain version), on the same numpy inputs.

Tolerances: K3's plain version equals the JAX ``pallas_cell_select``
element for element, order included (atol 1e-6; the arithmetic is the
same float32 operations, so the expected difference is 0). The dense
build and the sort method compare at 1e-6 where no two distances tie,
and as neighbor sets rounded to 4 places (tests/test_cell_list.py's
oracle) where sort order may differ; types exactly."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import hoomd_tf_tpu as htf
from hoomd_tf_tpu.ops import cell_list as jcl
from hoomd_tf_tpu.ops.nlist_pallas import pallas_cell_select
import hoomd_tf_tpu_torch as htt
from hoomd_tf_tpu_torch.ops import cell_list as tcl
from hoomd_tf_tpu_torch.ops import nlist_cuda as tnc
from hoomd_tf_tpu_torch.ops.cell_stencil import neighbor_cells

from torch_helpers import np_


def random_system(n, L, seed=0, ntypes=2):
    rng = np.random.RandomState(seed)
    pos = (rng.rand(n, 3) * L - L / 2).astype(np.float32)
    types = rng.randint(0, ntypes, n).astype(np.float32)
    return np.concatenate([pos, types[:, None]], axis=1)


def sets_from_nlist(nlist):
    out = []
    for i in range(nlist.shape[0]):
        s = set()
        for row in nlist[i]:
            if np.any(row[:3] != 0):
                s.add(tuple(np.round(row, 4)))
        out.append(s)
    return out


@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("types", [False, True])
def test_compute_nlist_matches_jax(sort, types):
    """Sorted keeps the nearest, unsorted the largest (the reference's
    quirk) -- NN = 12 is below the neighbor count, so both truncate."""
    pos4 = random_system(150, 8.0, seed=1)
    kw = dict(sorted=sort, return_types=types)
    got = htt.compute_nlist(pos4, 3.0, 12, [8.0] * 3, device="cpu", **kw)
    want = htf.compute_nlist(jnp.asarray(pos4), 3.0, 12, [8.0] * 3, **kw)
    np.testing.assert_allclose(np_(got), np_(want), rtol=0, atol=1e-6)


def test_compute_nlist_typed_cutoffs_and_box():
    pos4 = random_system(120, 7.0, seed=2)
    rcm = [[2.5, 1.5], [1.5, -1.0]]
    box = np.array([[-3.5] * 3, [3.5] * 3, [0, 0, 0]], np.float32)
    got = htt.compute_nlist(torch.as_tensor(pos4), 2.5, 40,
                            torch.as_tensor(box), sorted=True,
                            return_types=True, r_cut_matrix=rcm)
    want = htf.compute_nlist(jnp.asarray(pos4), 2.5, 40, jnp.asarray(box),
                             sorted=True, return_types=True,
                             r_cut_matrix=rcm)
    np.testing.assert_allclose(np_(got), np_(want), rtol=0, atol=1e-6)
    t = np_(got)
    ti = pos4[:, 3]
    pairs = (t[..., :3] != 0).any(-1)
    assert not np.any(pairs & (ti[:, None] == 1) & (t[..., 3] == 1))


def test_nlist_from_positions_matches_jax():
    pos4 = random_system(100, 7.0, seed=3)
    box = np.array([[-3.5] * 3, [3.5] * 3, [0, 0, 0]], np.float32)
    got = htt.nlist_from_positions(torch.as_tensor(pos4[:, :3]),
                                   torch.as_tensor(pos4[:, 3]).int(), 3.0,
                                   48, torch.as_tensor(box))
    want = htf.nlist_from_positions(jnp.asarray(pos4[:, :3]),
                                    jnp.asarray(pos4[:, 3]).astype(int),
                                    3.0, 48, jnp.asarray(box))
    np.testing.assert_allclose(np_(got), np_(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("typed", [False, True])
def test_sort_method_matches_jax(typed):
    """The port's sort method against the JAX package's: the same
    neighbor sets, ascending; and against the dense oracle."""
    n, L, r_cut, NN = 400, 12.0, 3.0, 48
    pos4 = random_system(n, L)
    rcm = [[3.0, 2.2], [2.2, 2.6]] if typed else None
    got = np_(htt.cell_list_nlist(torch.as_tensor(pos4), r_cut, NN,
                                  torch.as_tensor([L, L, L]),
                                  rcut_matrix=rcm))
    want = np_(htf.cell_list_nlist(jnp.asarray(pos4), r_cut, NN,
                                   jnp.asarray([L, L, L]), rcut_matrix=rcm))
    dense = np_(htt.compute_nlist(torch.as_tensor(pos4), r_cut, NN, [L] * 3,
                                  sorted=True, return_types=True,
                                  r_cut_matrix=rcm))
    a, b, c = (sets_from_nlist(x) for x in (got, want, dense))
    for i in range(n):
        assert a[i] == b[i] == c[i], f"particle {i}"
    r = np.linalg.norm(got[..., :3], axis=-1)
    for i in range(n):
        ri = r[i][r[i] > 0]
        assert np.all(np.diff(ri) >= 0)


def k3_planes(n, L, cap=None, seed=0):
    """The port's cell slots of a random system, and the JAX kernel's
    inputs made from the same slots: ``[n_cells, cpad]`` candidate planes
    (27-cell stencil, far sentinel in the lane padding) and ``[n_cells,
    cap]`` query planes, block-padded as ``cell_list.py:170-188`` pads
    them."""
    from hoomd_tf_tpu.ops.nlist_pallas import _BLOCK
    pos4 = torch.as_tensor(random_system(n, L, seed=seed))
    grid, c = tcl.plan(n, [L] * 3, 3.0)
    cap = cap or c
    slots4, counts, pid, ovf = tcl.build_planes(pos4, grid, cap,
                                                torch.tensor([L] * 3))
    assert not bool(ovf)
    n_cells = int(np.prod(grid))
    neigh = neighbor_cells(grid, "cpu")
    cand = np_(slots4.reshape(-1, cap, 4)[neigh].reshape(n_cells, -1, 4))
    q = np_(slots4.reshape(-1, cap, 4))
    cpad = -(-27 * cap // 128) * 128
    blocks = -(-n_cells // _BLOCK) * _BLOCK
    planes = []
    for a, fill in enumerate((1e30, 1e30, 1e30, 0.0)):
        p = np.full((blocks, cpad), fill, np.float32)
        p[:n_cells, :27 * cap] = cand[..., a]
        planes.append(p)
    for a in range(3):
        p = np.full((blocks, cap), 1e30, np.float32)
        p[:n_cells] = q[..., a]
        planes.append(p)
    return (slots4, counts, pid, grid, cap), planes


@pytest.mark.parametrize("case", ["sparse", "more than NN valid"])
def test_k3_plain_matches_jax_pallas(case):
    """K3's plain version against the JAX Pallas kernel (interpreted off
    the TPU), both called directly on the same cell slots: equal element
    for element, order included, also where more than NN candidates are
    valid (NN = 8 against ~40 valid neighbours at the fluid's density)."""
    n, L, NN = (60, 10.0, 16) if case == "sparse" else (160, 9.5, 8)
    (slots4, counts, pid, grid, cap), planes = k3_planes(n, L, seed=4)
    got = tnc.nlist_select_reference(slots4, counts, pid, grid, cap, NN,
                                     3.0, (L, L, L), n)
    want = pallas_cell_select(*(jnp.asarray(p) for p in planes),
                              capacity=cap, NN=NN, r_cut=3.0,
                              lengths=(L, L, L))
    rows = np.stack([np_(w) for w in want], axis=-1)
    n_slots = slots4.shape[0]
    occupied = np_(pid) >= 0
    want_p = np.zeros((n, NN, 4), np.float32)
    want_p[np_(pid)[occupied]] = rows[:n_slots][occupied]
    np.testing.assert_allclose(np_(got), want_p, rtol=0, atol=1e-6)
    filled = (np_(got)[..., :3] != 0).any(-1).sum(1)
    if case == "sparse":
        assert filled.max() < NN
    else:
        assert (filled == NN).mean() > 0.5


@pytest.mark.parametrize("NN", [32, 8])
def test_pallas_method_matches_jax(NN):
    """The whole 'pallas' cell list, the port's (K3's plain version on
    the CPU) against the JAX package's (its kernel interpreted): the
    same list, order included; NN = 8 truncates most rows."""
    n, L = 200, 10.0
    pos4 = random_system(n, L, seed=5)
    got = htt.cell_list_nlist(torch.as_tensor(pos4), 3.0, NN,
                              torch.as_tensor([L, L, L]), method="pallas")
    want = htf.cell_list_nlist(jnp.asarray(pos4), 3.0, NN,
                               jnp.asarray([L, L, L]), method="pallas")
    np.testing.assert_allclose(np_(got), np_(want), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(np_(got)[..., 3], np_(want)[..., 3])
    if NN == 8:
        assert ((np_(got)[..., :3] != 0).any(-1).sum(1) == NN).mean() > 0.5


def test_kernel_interface_plain_version():
    """nlist_select on CPU tensors is its plain version and counts no
    launch; the slot counts are the occupied prefix of each cell."""
    n, L, NN = 300, 11.0, 40
    (slots4, counts, pid, grid, cap), _ = k3_planes(n, L, seed=6)
    before = tnc.nlist_select.launches
    got = tnc.nlist_select(slots4, counts, pid, grid, cap, NN, 3.0,
                           (L, L, L), n)
    assert tnc.nlist_select.launches == before
    want = tnc.nlist_select_reference(slots4, counts, pid, grid, cap, NN,
                                      3.0, (L, L, L), n)
    np.testing.assert_array_equal(np_(got), np_(want))
    occ = (pid.reshape(-1, cap) >= 0).int()
    assert torch.equal(counts, occ.sum(1).int())
    assert torch.equal(occ, (torch.arange(cap) < counts[:, None]).int())


def test_planes_match_jax():
    """Binning: the same slot of every particle and the same slot rows as
    the JAX package's _build_planes."""
    n, L = 300, 11.0
    pos4 = random_system(n, L, seed=7)
    grid, cap = tcl.plan(n, [L] * 3, 3.0)
    assert (grid, cap) == jcl.plan(n, [L] * 3, 3.0)
    slots4, counts, pid, ovf = tcl.build_planes(
        torch.as_tensor(pos4), grid, cap, torch.tensor([L, L, L]))
    jx, jy, jz, jt, jsop, jovf = jcl._build_planes(
        jnp.asarray(pos4), grid, cap, jnp.asarray([L, L, L]))
    # the slot of each particle, from the particle of each slot
    sop = np.full(n, slots4.shape[0])
    held = np_(pid) >= 0
    sop[np_(pid)[held]] = np.nonzero(held)[0]
    np.testing.assert_array_equal(sop, np_(jsop))
    for a, p in enumerate((jx, jy, jz, jt)):
        np.testing.assert_array_equal(np_(slots4[:, a]), np_(p).ravel())
    assert bool(ovf) == bool(jovf) is False


def test_overflow_flag():
    n, L = 100, 9.0
    pos4 = torch.as_tensor(random_system(n, L, seed=4))
    for method in ("sort", "pallas"):
        nl, over = htt.cell_list_nlist(pos4, 3.0, 32, torch.tensor([L] * 3),
                                       config=htt.CellList(capacity=2),
                                       return_overflow=True, method=method)
        assert bool(over) and torch.isfinite(nl).all()
        _, over = htt.cell_list_nlist(pos4, 3.0, 32, torch.tensor([L] * 3),
                                      config=htt.CellList(capacity=128),
                                      return_overflow=True, method=method)
        assert not bool(over)


def test_small_box_and_typed_pallas_raise():
    pos4 = torch.as_tensor(random_system(50, 8.0))
    with pytest.raises(ValueError, match="too small"):
        htt.cell_list_nlist(pos4, 3.0, 16, torch.tensor([8.0] * 3))
    with pytest.raises(ValueError, match="per-type r_cut"):
        htt.cell_list_nlist(pos4, 3.0, 16, torch.tensor([12.0] * 3),
                            method="pallas", rcut_matrix=[[3.0]])


def test_cell_list_config_matches_jax():
    for lengths, r_cut in (([12.0, 9.5, 30.0], 3.0), ([8.0] * 3, 2.5)):
        t, j = htt.CellList(skin=0.2), htf.CellList(skin=0.2)
        assert t.grid_for(lengths, r_cut) == j.grid_for(lengths, r_cut)
        assert t.usable(lengths, r_cut) == j.usable(lengths, r_cut)
        assert t.default_capacity(500, lengths, r_cut) == \
            j.default_capacity(500, lengths, r_cut)
    pos = random_system(500, 12.0, seed=8)
    assert tcl.max_occupancy(pos, [12.0] * 3, (4, 4, 4)) == \
        jcl.max_occupancy(pos, [12.0] * 3, (4, 4, 4))
