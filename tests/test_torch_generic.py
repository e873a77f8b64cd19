"""Kernel K1's generic form on the CPU: its plain list-and-reduce version
(``cellwise_cuda.generic_plain``, the wrapper's CPU path) against the JAX
Pallas K1 run in interpret mode with the same non-LJ pair function, at the
JAX package's own bar for its kernel, rtol = atol = 1e-4
(tests/test_cellwise.py); the lane list against a brute-force count in
numpy; a list budget that overflows sets the flag."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import hoomd_tf_tpu_torch as htt
from hoomd_tf_tpu_torch.ops import cellwise as tcw
from hoomd_tf_tpu_torch.ops import cellwise_cuda as tcc

from torch_helpers import hole_permutation, np_, packed_pair

TOL = dict(rtol=1e-4, atol=1e-4)
RCM = np.array([[2.5, 2.0], [2.0, 2.2]], np.float32)


def morse_yukawa_jax(r2, ti, tj):
    """A typed pair function no kernel form covers: Morse between like
    types, a screened Coulomb (Yukawa) between unlike ones."""
    r = jnp.sqrt(r2)
    e = jnp.exp(-1.5 * (r - 1.1))
    um, dm = e * e - 2.0 * e, (-3.0 * e * e + 3.0 * e) / (2.0 * r)
    y = jnp.exp(-0.8 * r) / r
    uy, dy = 0.7 * y, 0.7 * y * (-0.8 - 1.0 / r) / (2.0 * r)
    like = ti == tj
    return jnp.where(like, um, uy), jnp.where(like, dm, dy)


def morse_yukawa_torch(r2, ti, tj):
    r = torch.sqrt(r2)
    e = torch.exp(-1.5 * (r - 1.1))
    um, dm = e * e - 2.0 * e, (-3.0 * e * e + 3.0 * e) / (2.0 * r)
    y = torch.exp(-0.8 * r) / r
    uy, dy = 0.7 * y, 0.7 * y * (-0.8 - 1.0 / r) / (2.0 * r)
    like = ti == tj
    return torch.where(like, um, uy), torch.where(like, dm, dy)


def _jax_k1(jl, jss, jaux, rc, interpret=True):
    from hoomd_tf_tpu.ops.cellwise_pallas import half_stencil_pair_forces
    return half_stencil_pair_forces(
        jss.positions, jss.types, jaux["valid"], jl.plan, jl.lo,
        morse_yukawa_jax, needs_virial=True, with_types=True,
        rcut_matrix=rc, interpret=interpret)


@pytest.mark.parametrize("rcm", [None, "matrix"])
def test_generic_plain_matches_jax_pallas(rcm):
    rc = None if rcm is None else RCM
    (jl, jss, jaux), (tl, tss, taux) = packed_pair(125, 0.2, 11, 2.5,
                                                   typed=True, rc_matrix=rc)
    f_j, w_j = _jax_k1(jl, jss, jaux, rc)
    lanes = tcc.LaneBudget(tcc.lane_budget(tl.plan, 125), "cpu")
    f_t, w_t = tcc.generic_pair_forces(
        tss.positions, tss.types, taux["valid"], tl.plan, tl.lo,
        morse_yukawa_torch, needs_virial=True, rc2_tab=tl.rc2_tab,
        geometry=tl.geometry, lanes=lanes)
    np.testing.assert_allclose(np_(f_t), np_(f_j), **TOL)
    np.testing.assert_allclose(np_(w_t), np_(w_j), **TOL)
    assert not bool(lanes.overflow()) and 0 < int(lanes.needed)
    assert np.abs(np_(f_t)[:, :3]).max() > 1e-2


@pytest.mark.parametrize("flags", [(True, True), (False, False),
                                   (True, False)])
def test_generic_plain_equals_half_tensor_form(flags):
    """The plain list-and-reduce against the 'half' tensor form with the
    same pair function: the same lanes, summed in another order."""
    energy, virial = flags
    _, (tl, tss, taux) = packed_pair(256, 0.35, 7, 2.5, typed=True)
    args = (tss.positions, tss.types, taux["valid"], tl.plan, tl.lo,
            morse_yukawa_torch)
    f_h, w_h = tcw.analytic_pair_forces(
        *args, needs_virial=virial, with_types=True, stencil="half",
        needs_energy=energy, geometry=tl.geometry)
    f_g, w_g = tcw.analytic_pair_forces(
        *args, needs_virial=virial, with_types=True, stencil="kernel",
        needs_energy=energy, geometry=tl.geometry)
    torch.testing.assert_close(f_g, f_h, rtol=1e-5, atol=1e-5)
    assert (w_g is None) == (not virial)
    if virial:
        torch.testing.assert_close(w_g, w_h, rtol=1e-5, atol=1e-5)
    assert bool((f_g[:, 3] != 0).any()) == energy


def test_lane_list_order_and_count():
    """Each cell's lanes row-major in slot order, the self pair left out,
    r2 clamped at min_r2; every unordered pair within the cut listed
    once from the half stencil's directed blocks and twice (both orders)
    within a cell: counted by brute force over the occupied slots."""
    _, (tl, tss, taux) = packed_pair(200, 0.3, 2, 2.5, typed=True)
    plan, cap = tl.plan, tl.plan.capacity
    lst = tcc.generic_list_plain(tss.positions, tss.types, taux["valid"],
                                 plan, tl.lo, min_r2=0.5, geometry=tl.geometry)
    key = (np_(lst["cell"]) * cap + np_(lst["row"])) * 10 ** 6 + \
        np_(lst["col"])
    assert np.all(np.diff(key) > 0)
    assert np_(lst["r2"]).min() >= 0.5
    pos = np_(tss.positions)[np_(taux["valid"]) > 0]
    cell = (np.nonzero(np_(taux["valid"]) > 0)[0] // cap)
    L = np.asarray(plan.lengths)
    d = pos[None] - pos[:, None]
    d = d - np.round(d / L) * L
    inside = ((d * d).sum(-1) <= 2.5 ** 2) & ~np.eye(len(pos), dtype=bool)
    same = cell[None] == cell[:, None]
    want = int((inside & ~same).sum() // 2 + (inside & same).sum())
    assert lst["needed"] == want == len(lst["r2"])


def test_budget_overflow_sets_the_flag():
    (jl, jss, jaux), (tl, tss, taux) = packed_pair(125, 0.2, 11, 2.5,
                                                   typed=True)
    full = tcc.LaneBudget(10 ** 6, "cpu")
    f_full, _ = tcc.generic_pair_forces(
        tss.positions, tss.types, taux["valid"], tl.plan, tl.lo,
        morse_yukawa_torch, geometry=tl.geometry, lanes=full)
    need = int(full.needed)
    short = tcc.LaneBudget(need // 2, "cpu")
    f_short, _ = tcc.generic_pair_forces(
        tss.positions, tss.types, taux["valid"], tl.plan, tl.lo,
        morse_yukawa_torch, geometry=tl.geometry, lanes=short)
    assert bool(short.overflow()) and int(short.needed) == need
    assert not bool(full.overflow())
    # the cells that fit keep their lanes; the rest add nothing
    assert 0 < float(f_short.abs().sum()) < float(f_full.abs().sum())
    short.grow()
    assert short.budget >= 1.25 * need and int(short.needed) == 0


def test_valid_not_a_prefix():
    """Occupied slots in any pattern: moving a cell's first particle into
    its first empty slot moves its forces with it."""
    _, (tl, tss, taux) = packed_pair(200, 0.3, 4, 2.5, typed=True)
    perm = hole_permutation(taux["valid"], tl.plan.capacity)
    args = dict(needs_virial=True, geometry=tl.geometry)
    f0, _ = tcc.generic_pair_forces(tss.positions, tss.types, taux["valid"],
                                    tl.plan, tl.lo, morse_yukawa_torch, **args)
    f1, _ = tcc.generic_pair_forces(tss.positions[perm], tss.types[perm],
                                    taux["valid"][perm], tl.plan, tl.lo,
                                    morse_yukawa_torch, **args)
    torch.testing.assert_close(f1, f0[perm], rtol=1e-5, atol=1e-5)


def test_wrapper_takes_plain_version_on_cpu():
    """On a CPU tensor: no launch, the untyped call form ``pair_fn(r2)``,
    and a pair function returning a scalar broadcast to the lanes."""
    _, (tl, tss, taux) = packed_pair(125, 0.2, 11, 2.5)
    before = tcc.generic_pair_forces.launches
    f, w = tcc.generic_pair_forces(
        tss.positions, tss.types, taux["valid"], tl.plan, tl.lo,
        lambda r2: (torch.tensor(0.0), torch.tensor(-1.0)), typed_fn=False,
        geometry=tl.geometry)
    assert tcc.generic_pair_forces.launches == before and w is None
    assert f.shape == (tl.plan.n_slots, 4)
    assert np.all(np_(f)[np_(taux["valid"]) == 0] == 0)
    # a constant slope -1: each pair pulls with 2 (dx, dy, dz) on both
    assert float(f[:, :3].abs().max()) > 0
    torch.testing.assert_close(f[:, :3].sum(0), torch.zeros(3), rtol=0,
                               atol=1e-3)


def test_pair_model_without_form_runs_generic_on_kernel_stencil():
    """A PairModel with no kernel form, stencil='kernel' on the CPU: the
    generic form's plain version, the same forces as the tensor form."""

    class Morse(htt.PairModel):
        def pair_energy(self, r2):
            e = torch.exp(-1.5 * (torch.sqrt(r2) - 1.1))
            return e * e - 2.0 * e

    forces = {}
    for stencil in ("kernel", "full"):
        sim = htt.Simulation(dt=0.005, integrator=htt.md.NVE(), seed=2,
                             device="cpu")
        sim.init_lattice(300, density=0.35, kT_init=1.0)
        sim.stencil = stencil
        htt.tfcompute(Morse(32)).attach(sim, r_cut=2.5, nlist="cellwise")
        sim.run(3)
        forces[stencil] = sim.state.forces
    torch.testing.assert_close(forces["kernel"], forces["full"], rtol=1e-4,
                               atol=1e-4)


def test_generic_source_digest_covers_its_headers():
    """The generic form's library is keyed on the staging and the finish
    it shares with K1's pair forms."""
    from hoomd_tf_tpu_torch import _build
    text = (_build._PKG / "csrc" / "cellwise_generic.cu").read_bytes()
    heads = {h.decode() for h in _build._INCLUDE.findall(text)}
    assert {"half_stencil_stage.cuh", "half_stencil_home.cuh"} <= heads
