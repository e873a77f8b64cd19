"""The wide-direct planes of the port against the JAX package: the same
numpy-seeded systems through ``direct_cell_planes`` (particle order) and
``cellwise_planes`` (slot order), and the planes helpers (``nlist_rinv``,
``masked_nlist``, ``compute_nlist_forces`` with its virial).

Masks and types are compared exactly; displacements within 1e-6 (the
same IEEE operations: candidate minus query, ``d - round(d / L) * L``);
forces and virials within 1e-5."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import hoomd_tf_tpu as htf
from hoomd_tf_tpu.ops import cell_list as jcl
from hoomd_tf_tpu.ops.direct import direct_cell_planes as jdirect
import hoomd_tf_tpu_torch as htt
from hoomd_tf_tpu_torch.ops import cell_list as tcl
from hoomd_tf_tpu_torch.ops import cellwise as tcw
from hoomd_tf_tpu_torch.ops.direct import NlistPlanes, direct_cell_planes

from torch_helpers import fluid_arrays, np_, packed_pair

RCM = np.array([[2.5, 2.0], [2.0, 2.2]], np.float32)
DISP = dict(rtol=0, atol=1e-6)


def _system(n=400, density=0.35, seed=0, typed=True):
    pos, _, lengths = fluid_arrays(n, density, seed)
    types = (np.arange(n) % 2) if typed else np.zeros(n)
    pos4 = np.concatenate([pos, types[:, None]], 1).astype(np.float32)
    return pos4, np.asarray(lengths, np.float32)


def _assert_planes(t, j):
    """Exact masks and types, displacements within 1e-6."""
    tz = np.stack([np_(c) != 0 for c in t[:3]]).any(0)
    jz = np.stack([np.asarray(c) != 0 for c in j[:3]]).any(0)
    np.testing.assert_array_equal(tz, jz)
    np.testing.assert_array_equal(np_(t.type), np.asarray(j.type))
    for a in range(3):
        np.testing.assert_allclose(np_(t[a]), np.asarray(j[a]), **DISP)


@pytest.mark.parametrize("rcm", [None, "matrix"])
def test_direct_cell_planes_match_jax(rcm):
    pos4, lengths = _system()
    grid, cap = jcl.plan(pos4.shape[0], lengths, 2.5)
    cap = max(cap, jcl.max_occupancy(pos4, lengths, grid))
    rc = None if rcm is None else RCM
    jp, jo = jdirect(jnp.asarray(pos4), 2.5, grid, cap,
                     jnp.asarray(lengths), rcut_matrix=rc)
    tab = None if rc is None else tcw.rc2_table(rc, device="cpu")
    tp, to = direct_cell_planes(torch.as_tensor(pos4), 2.5, grid, cap,
                                torch.as_tensor(lengths), tab)
    assert isinstance(tp, NlistPlanes) and tp.shape == (400, 27 * cap)
    assert not bool(to) and not bool(jo)
    _assert_planes(tp, jp)
    # each pair within the cut appears once per row, self excluded
    n_nb = (np_(tp.r2()) > 0).sum(1)
    assert n_nb.max() > 0
    np.testing.assert_array_equal(n_nb, (np.asarray(jp.r2()) > 0).sum(1))


def test_direct_cell_planes_overflow_flag():
    pos4, lengths = _system(n=200)
    grid, _ = tcl.plan(200, lengths, 2.5)
    _, over = direct_cell_planes(torch.as_tensor(pos4), 2.5, grid, 1,
                                 torch.as_tensor(lengths))
    _, jover = jdirect(jnp.asarray(pos4), 2.5, grid, 1, jnp.asarray(lengths))
    assert bool(over) and bool(jover)


@pytest.mark.parametrize("rcm", [None, "matrix"])
def test_cellwise_planes_match_jax(rcm):
    from hoomd_tf_tpu.ops import cellwise as jcw
    rc = None if rcm is None else RCM
    (jl, jss, jaux), (tl, tss, taux) = packed_pair(256, 0.35, 7, 2.5,
                                                   typed=True, rc_matrix=rc)
    jp = jcw.cellwise_planes(jss.positions, jss.types, jaux["valid"],
                             jl.plan, rcut_matrix=rc)
    tp = tl.planes(tss, taux)
    assert tp.shape == (tl.plan.n_slots, tl.plan.width)
    _assert_planes(tp, jp)
    ghost = np_(taux["valid"]) == 0
    assert np.all(np_(tp.dx)[ghost] == 0)
    # the rows of a range of cells are those rows of the whole planes
    c0, c1 = 3, 11
    part = tl.planes(tss, taux, cells=(c0, c1))
    rows = slice(c0 * tl.plan.capacity, c1 * tl.plan.capacity)
    for a in range(4):
        torch.testing.assert_close(part[a], tp[a][rows], rtol=0, atol=0)


def _planes_pair(seed=0):
    pos4, lengths = _system(n=300, seed=seed)
    grid, cap = tcl.plan(300, lengths, 2.5)
    cap = max(cap, tcl.max_occupancy(pos4, lengths, grid))
    jp, _ = jdirect(jnp.asarray(pos4), 2.5, grid, cap, jnp.asarray(lengths))
    tp, _ = direct_cell_planes(torch.as_tensor(pos4), 2.5, grid, cap,
                               torch.as_tensor(lengths))
    return pos4, jp, tp


def test_nlist_rinv_and_masked_nlist_on_planes():
    pos4, jp, tp = _planes_pair()
    np.testing.assert_allclose(np_(htt.nlist_rinv(tp)),
                               np.asarray(htf.nlist_rinv(jp)), rtol=1e-6,
                               atol=1e-6)
    zero_row = np_(htt.nlist_rinv(tp))[np_(tp.r2()) == 0]
    assert np.all(zero_row == 0)
    types = pos4[:, 3]
    for ti, tj in ((0, None), (None, 1), (1, 0)):
        t = htt.masked_nlist(tp, torch.as_tensor(types), ti, tj)
        j = htf.masked_nlist(jp, jnp.asarray(types), ti, tj)
        assert isinstance(t, NlistPlanes)
        for a in range(4):
            np.testing.assert_array_equal(np_(t[a]), np.asarray(j[a]))


def test_zero_rows_have_zero_gradient():
    """The double-where: an all-zero planes row gives zero 1/r and zero
    gradient, not NaN."""
    z = torch.zeros((2, 5))
    dx = torch.tensor([[1.5, 0, 0, 0, 0], [0.0] * 5], requires_grad=True)
    p = NlistPlanes(dx, z, z, z)
    htt.nlist_rinv(p).sum().backward()
    g = dx.grad.numpy()
    assert np.isfinite(g).all() and np.all(g[1] == 0) and g[0, 0] != 0


@pytest.mark.parametrize("virial", [False, True])
def test_compute_nlist_forces_on_planes(virial):
    """Callable energies on planes, forces f = 2 dE/d(dx) summed per row
    and the virial from the same gradient, against JAX."""
    _, jp, tp = _planes_pair(seed=3)

    def tenergy(p):
        r = htt.nlist_rinv(p)
        return torch.sum(2.0 * (r ** 12 - r ** 6) + 0.1 * p.dx * r, dim=1)

    def jenergy(p):
        r = htf.nlist_rinv(p)
        return jnp.sum(2.0 * (r ** 12 - r ** 6) + 0.1 * p.dx * r, axis=1)

    t = htt.compute_nlist_forces(tp, tenergy, virial=virial)
    j = htf.compute_nlist_forces(jp, jenergy, virial=virial)
    if not virial:
        t, j = (t,), (j,)
    for a, b in zip(t, j):
        scale = np.abs(np.asarray(b)).max()
        np.testing.assert_allclose(np_(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-5 * scale)


def test_simmodel_takes_planes():
    """A SimModel called on planes differentiates against their
    components: the same forces as the callable form."""

    def energy(p):
        r = htt.nlist_rinv(p)
        return torch.sum(2.0 * (r ** 12 - r ** 6), dim=1)

    class LJ(htt.SimModel):
        def compute(self, nlist, positions, box):
            return htt.compute_nlist_forces(nlist, energy(nlist))

    pos4, _, tp = _planes_pair()
    box = htt.ops.box_from_lengths([20.0] * 3, device="cpu")
    f = LJ(8)([tp, torch.as_tensor(pos4), box])[0]
    want = htt.compute_nlist_forces(tp, energy)
    torch.testing.assert_close(f, want, rtol=0, atol=0)
    assert f.shape == (300, 4) and f[:, :3].abs().max() > 0
