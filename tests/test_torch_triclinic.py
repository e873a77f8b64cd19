"""Triclinic (tilted) boxes in the port against the JAX package and the
27-image numpy oracle of tests/test_triclinic.py: the box math, the
built-in LJ and a PairModel on 'cellwise', a generic SimModel on 'n2',
the full-box dense neighbor list, sheared NVE energy conservation and the
guards. Inputs come from numpy seeds and go to both packages.

Tolerances: the box math 1e-5 absolute (float32 rounding of lengths up to
a few boxes); forces against JAX rtol = atol = 1e-4 (the same algorithm
in float32, summed in another order); against the float64 oracle the JAX
test's own rtol 2e-4, atol 2e-3; neighbor distances 1e-4 (the JAX
test's)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import hoomd_tf_tpu as htf
import hoomd_tf_tpu_torch as htt
from hoomd_tf_tpu_torch.interop import state_from_numpy
from hoomd_tf_tpu_torch.ops import box as tbox

from torch_helpers import (TILT, cell_matrix, jax_state_numpy, min_image_27,
                           np_, numpy_lj_tri, tri_positions)

R_CUT = 1.4
LENGTHS = np.array([6.0, 6.0, 6.0])


def tilted_box(lengths=LENGTHS, tilt=TILT):
    return np.stack([-lengths / 2, lengths / 2, tilt]).astype(np.float32)


class TestBoxMath:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_wrap_vector_and_box_matrix_match_jax(self, seed):
        """Random tilts in [-0.5, 0.5] and random box corners: the port's
        ``wrap_vector`` and ``box_matrix`` equal the JAX package's."""
        rng = np.random.RandomState(seed)
        tilt = rng.uniform(-0.5, 0.5, 3).astype(np.float32)
        lo = rng.uniform(-4, -2, 3).astype(np.float32)
        hi = lo + rng.uniform(3, 8, 3).astype(np.float32)
        box = np.stack([lo, hi, tilt])
        r = (rng.randn(200, 3) * 7.0).astype(np.float32)
        got = htt.wrap_vector(torch.as_tensor(r), torch.as_tensor(box))
        want = htf.wrap_vector(jnp.asarray(r), jnp.asarray(box))
        np.testing.assert_allclose(np_(got), np_(want), rtol=0, atol=1e-5)
        np.testing.assert_allclose(
            np_(tbox.box_matrix(torch.as_tensor(box))),
            np_(htf.ops.box.box_matrix(jnp.asarray(box))), rtol=0,
            atol=1e-6)

    def test_wrap_is_the_27_image_minimum_for_short_vectors(self):
        h = cell_matrix(np.array([6.0, 7.0, 8.0]), TILT)
        box = np.stack([[-3., -3.5, -4.], [3., 3.5, 4.], TILT])
        rng = np.random.RandomState(3)
        short = rng.randn(256, 3) * 0.8
        shifts = rng.randint(-2, 3, size=(256, 3)) @ h.T
        wrapped = htt.wrap_vector(
            torch.as_tensor((short + shifts).astype(np.float32)),
            torch.as_tensor(box.astype(np.float32)))
        np.testing.assert_allclose(np_(wrapped), short, atol=1e-4)


def lj_sigma(sigma):
    """``(U, dU/dr2)`` of LJ with ``sigma`` for both packages."""
    s6 = sigma ** 6

    def fn(r2):
        inv6 = s6 / (r2 * r2 * r2)
        return (4.0 * (inv6 * inv6 - inv6),
                -12.0 * (2.0 * inv6 - 1.0) * inv6 / r2)
    return fn


def cellwise_both(pos, box, r_cut, pair_fn, stencil="full"):
    """Pair forces ``[n, 4]`` in particle order from the JAX package's
    cellwise tensor form and the port's (``stencil``), each on its own
    tilted slot layout of the same positions and the same plan."""
    from hoomd_tf_tpu.md.slots import SlotLayout as JLayout
    from hoomd_tf_tpu.ops import cellwise as jcw
    from hoomd_tf_tpu_torch.md.slots import SlotLayout as TLayout
    from hoomd_tf_tpu_torch.ops import cellwise as tcw
    n = pos.shape[0]
    lengths, lo = box[1] - box[0], box[0]
    tilt = tuple(float(t) for t in box[2])
    jplan = jcw.plan_cellwise(n, lengths, r_cut, positions=pos, lo=lo,
                              tilt=tilt)
    tplan = tcw.plan_cellwise(n, lengths, r_cut, positions=pos, lo=lo,
                              tilt=tilt)
    assert (tplan.grid, tplan.capacity) == (jplan.grid, jplan.capacity)
    js = htf.md.state.init_state(pos, box)
    jl = JLayout(jplan, n, lo)
    jslot, jaux, _ = jl.pack(js)
    f4, _ = jcw.analytic_pair_forces(
        jslot.positions, jslot.types, jaux["valid"], jplan, lo, pair_fn,
        stencil="full")
    _, (jf,) = jl.unpack(jslot, jaux, (f4,))
    ts = htt.md.state.init_state(pos, box, device="cpu")
    tl = TLayout(tplan, n, lo, device="cpu", box=ts.box)
    tslot, taux = tl.pack(ts)
    f4, _ = tcw.analytic_pair_forces(
        tslot.positions, tslot.types, taux["valid"], tplan, lo, pair_fn,
        stencil=stencil, geometry=tl.geometry,
        form=(htt.md.LennardJones(sigma=0.9, r_cut=np.inf).kernel_form()
              if stencil == "kernel" else None))
    tf = np.zeros((n + 1, 4), np.float32)
    tf[np_(taux["orig"])] = np_(f4)
    return tf[:n], np.asarray(jf)


def oracle_close(got, pos, sigma):
    f_ref, _ = numpy_lj_tri(pos, LENGTHS, TILT, R_CUT, sigma=sigma)
    np.testing.assert_allclose(got, f_ref, rtol=2e-4, atol=2e-3)


class TestForces:
    @pytest.mark.parametrize("stencil", ["full", "half", "kernel"])
    def test_cellwise_forms_match_jax(self, stencil):
        """The cellwise pair forces at a tilted box, the port's tensor
        forms (full and half stencil) and K1's plain version (LJ form)
        against the JAX package's full-stencil form on the same positions
        at rtol = atol = 1e-4, and against the oracle."""
        pos = tri_positions(160, LENGTHS, TILT, seed=0)
        tf, jf = cellwise_both(pos, tilted_box(), R_CUT, lj_sigma(0.9),
                               stencil)
        np.testing.assert_allclose(tf, jf, rtol=1e-4, atol=1e-4)
        oracle_close(tf[:, :3], pos, 0.9)

    def test_builtin_lj_cellwise(self):
        """Built-in LJ on 'cellwise' in a tilted box through the engine:
        the port plans the JAX package's grid (by perpendicular widths),
        and its forces match the oracle step after step."""
        pos = tri_positions(160, LENGTHS, TILT, seed=0)
        jsim = htf.Simulation(dt=0.001, seed=0)
        jsim.init_state(pos, tilted_box(), kT_init=0.7)
        sim = htt.Simulation(dt=0.001, seed=0, device="cpu")
        sim.init_state(pos, tilted_box(), kT_init=0.7)
        for s, m in ((jsim, htf), (sim, htt)):
            s.add_force(m.md.LennardJones(epsilon=1.0, sigma=0.9,
                                          r_cut=R_CUT))
            assert s._use_cellwise()
        jsim.run(1)
        sim.run(1)
        assert sim._layout.plan.tilted
        assert sim._layout.plan.grid == jsim._layout.plan.grid
        for _ in range(2):
            oracle_close(np_(sim.state.forces[:, :3]),
                         np_(sim.state.positions), 0.9)
            sim.run(5)

    def test_pair_model_cellwise(self):
        class TPair(htt.PairModel):
            def pair_energy(self, r2):
                inv6 = (0.81 / r2) ** 3
                return 4.0 * (inv6 * inv6 - inv6)

        pos = tri_positions(160, LENGTHS, TILT, seed=4)
        sim = htt.Simulation(dt=0.001, seed=4, device="cpu")
        sim.init_state(pos, tilted_box(), kT_init=0.7)
        tt = htt.tfcompute(TPair(64))
        tt.attach(sim, r_cut=R_CUT, nlist="cellwise")
        sim.run(2)
        assert sim._layout.plan.tilted
        oracle_close(tt.get_forces_array()[:, :3],
                     np_(sim.state.positions), 0.9)

    def test_generic_simmodel_n2(self):
        """A generic SimModel in a tilted box through the engine ('auto'
        picks the dense build, which takes the full box's triclinic
        minimum image): against the oracle; and the model on the same
        dense list as the JAX package's at 1e-4."""
        n = 96
        pos = tri_positions(n, LENGTHS, TILT, seed=2)
        sim = htt.Simulation(dt=0.001, seed=2, device="cpu")
        sim.init_state(pos, tilted_box(), kT_init=0.7)
        tt = htt.tfcompute(htt.LJPotential(n - 1))
        tt.attach(sim, r_cut=R_CUT)
        sim.run(2)
        assert sim._packed_build().method == "n2"
        got = tt.get_forces_array()[:, :3]
        oracle_close(got, np_(sim.state.positions), 1.0)
        pos = np_(sim.state.positions)
        pos4 = np.concatenate([pos, np.zeros((n, 1), np.float32)], 1)
        box = tilted_box()
        tnl = htt.compute_nlist(torch.as_tensor(pos4), R_CUT, n - 1,
                                torch.as_tensor(box), sorted=True,
                                return_types=True)
        jnl = htf.compute_nlist(jnp.asarray(pos4), R_CUT, n - 1,
                                jnp.asarray(box), sorted=True,
                                return_types=True)
        jm = htf.LJPotential(n - 1)
        # an eager call keeps the reference's "box is skewed" guard, in
        # both packages; the engine's calls (above) pass the tilted box
        with pytest.raises(ValueError, match="skewed"):
            tt.model([tnl, torch.as_tensor(pos4), torch.as_tensor(box)])
        with pytest.raises(ValueError, match="skewed"):
            jm([jnl, jnp.asarray(pos4), jnp.asarray(box)])
        flat = box.copy()
        flat[2] = 0.0
        tf = tt.model([tnl, torch.as_tensor(pos4), torch.as_tensor(flat)])
        jf = jm([jnl, jnp.asarray(pos4), jnp.asarray(flat)])
        np.testing.assert_allclose(np_(tf[0]), np_(jf[0]), rtol=1e-4,
                                   atol=1e-4)

    def test_compute_nlist_full_box(self):
        n = 64
        pos = tri_positions(n, LENGTHS, TILT, seed=9)
        box = tilted_box()
        pos4 = np.concatenate([pos, np.zeros((n, 1), np.float32)], 1)
        nl = np_(htt.compute_nlist(torch.as_tensor(pos4), R_CUT, 32,
                                   torch.as_tensor(box), sorted=True))
        jnl = np.asarray(htf.compute_nlist(jnp.asarray(pos4), R_CUT, 32,
                                           jnp.asarray(box), sorted=True))
        np.testing.assert_allclose(nl, jnl, rtol=0, atol=1e-5)
        d = min_image_27(pos[None] - pos[:, None],
                         cell_matrix(LENGTHS, TILT))
        rd = np.linalg.norm(d, axis=-1)
        np.fill_diagonal(rd, np.inf)
        for i in range(n):
            want = np.sort(rd[i][rd[i] <= R_CUT])
            got = np.linalg.norm(nl[i, :, :3], axis=-1)
            np.testing.assert_allclose(np.sort(got[got > 1e-6]), want,
                                       atol=1e-4)


class TestShearedNVE:
    def test_energy_conservation(self):
        """NVE in a sheared box after a quench: the total energy drifts by
        less than 5e-3 of its size per 100 steps (the JAX test's bar)."""
        n = 128
        lengths = np.array([6.5, 6.5, 6.5])
        pos = tri_positions(n, lengths, TILT, seed=11)
        box = np.stack([-lengths / 2, lengths / 2, TILT])
        sim = htt.Simulation(dt=0.0005, seed=1, device="cpu",
                             integrator=htt.md.Minimize(max_disp=0.02))
        sim.init_state(pos, box)
        sim.add_force(htt.md.LennardJones(epsilon=1.0, sigma=0.85,
                                          r_cut=1.6))
        sim.run(200)
        sim.thermalize_velocities(0.3)
        sim.integrator = htt.md.NVE()
        sim.run(10)
        energies = []
        for _ in range(3):
            sim.run(100)
            t = sim.thermo()
            energies.append(t["kinetic_energy"] + t["potential_energy"])
        for a, b in zip(energies, energies[1:]):
            np.testing.assert_allclose(
                a, b, atol=5e-3 * max(1.0, abs(energies[0])))
        assert sim._layout.plan.tilted


class TestGuards:
    def test_overtilted_rejected(self):
        pos = tri_positions(32, LENGTHS, (0.7, 0.0, 0.0), seed=1)
        box = np.stack([-LENGTHS / 2, LENGTHS / 2, [0.7, 0, 0]])
        sim = htt.Simulation(dt=0.001, device="cpu")
        sim.init_state(pos, box)
        with pytest.raises(ValueError, match="tilt"):
            htt.tfcompute(htt.LJPotential(16)).attach(sim, r_cut=1.2)

    def test_npt_tilted_raises(self):
        pos = tri_positions(64, LENGTHS, TILT, seed=1)
        sim = htt.Simulation(dt=0.001, device="cpu", integrator=htt.md.NPT(
            kT=1.0, tau=0.5, P=1.0, tauP=1.0))
        sim.init_state(pos, tilted_box(), kT_init=1.0)
        sim.add_force(htt.md.LennardJones(epsilon=1.0, sigma=0.9,
                                          r_cut=1.2))
        with pytest.raises(NotImplementedError, match="NPT"):
            sim.run(2)

    def test_cell_tier_tilted_raises(self):
        pos = tri_positions(64, LENGTHS, TILT, seed=1)
        sim = htt.Simulation(dt=0.001, device="cpu")
        sim.init_state(pos, tilted_box(), kT_init=1.0)
        htt.tfcompute(htt.LJPotential(32)).attach(sim, r_cut=1.2,
                                                 nlist="cell")
        with pytest.raises(NotImplementedError, match="triclinic"):
            sim.run(2)
