"""Port vs JAX package: the cellwise machinery and kernel K1's plain
version, on the same numpy inputs.

Tolerances: integer outputs (plans, cell ids, rolls, source maps,
overflow, occupancy) must be exactly equal. Pair forces, energies and
virials use rtol = atol = 1e-4, the JAX package's own bar for its Pallas
kernel against the XLA form (tests/test_cellwise.py): the port sums the
same float32 terms in another order."""

import ast
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import hoomd_tf_tpu as htf
from hoomd_tf_tpu.ops import cellwise as jcw
import hoomd_tf_tpu_torch as htt
from hoomd_tf_tpu_torch.ops import cellwise as tcw
from hoomd_tf_tpu_torch.ops import cellwise_cuda as tcc

from torch_helpers import lj_slope_jax, lj_slope_torch, np_, packed_pair

TOL = dict(rtol=1e-4, atol=1e-4)
RCM = np.array([[2.5, 1.8], [1.8, 2.2]], dtype=np.float32)


class TestPlan:
    @pytest.mark.parametrize("case", [
        "blind", "positions", "half-width+drift", "observed", "config",
        "too-small"])
    def test_plan_matches_jax(self, case):
        rng = np.random.RandomState(0)
        n, L, kw = 2000, [24.0] * 3, {}
        pos = rng.uniform(-12, 12, size=(n, 3)).astype(np.float32)
        if case == "blind":
            n, L = 512, [12.0] * 3
        elif case == "positions":
            kw = dict(positions=pos)
        elif case == "half-width+drift":
            kw = dict(positions=pos, width_blocks=14, drift_per_step=0.01)
        elif case == "observed":
            kw = dict(positions=pos, occ_observed=((7, 7, 7), 12))
        elif case == "config":
            kw = dict(positions=pos)
            jkw = dict(kw, config=htf.Cellwise(capacity=11, skin=0.5))
            tkw = dict(kw, config=htt.Cellwise(capacity=11, skin=0.5))
        else:
            n, L = 8, [5.0] * 3
        if case != "config":
            jkw = tkw = kw
        jp = jcw.plan_cellwise(n, L, 3.0, **jkw)
        tp = tcw.plan_cellwise(n, L, 3.0, **tkw)
        if jp is None:
            assert tp is None
            return
        assert (tp.grid, tp.capacity) == (jp.grid, jp.capacity)
        assert tp.skin == pytest.approx(jp.skin)
        assert tp.n_slots == jp.n_slots and tp.width == jp.width

    def test_snap_free_capacity(self):
        for wb in (14, 27):
            for cap in range(4, 90):
                assert tcw._snap_free_capacity(cap, wb) == \
                    jcw._snap_free_capacity(cap, wb)


class TestIntegerOps:
    def test_bin_cells_exact(self):
        rng = np.random.RandomState(1)
        pos = rng.uniform(-9, 9, size=(3000, 3)).astype(np.float32)
        plan_j = jcw.plan_cellwise(3000, [13.0] * 3, 2.5)
        plan_t = tcw.plan_cellwise(3000, [13.0] * 3, 2.5)
        lo = np.full(3, -6.5, np.float32)
        want = jcw.bin_cells(jnp.asarray(pos), lo, plan_j)
        got = tcw.bin_cells(torch.as_tensor(pos), lo, plan_t)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(np_(got), np_(want))

    def test_rolls_exact(self):
        plan_j = jcw.CellwisePlan((3, 4, 5), 3, (9.0, 12.0, 15.0), 2.5)
        plan_t = tcw.CellwisePlan((3, 4, 5), 3, (9.0, 12.0, 15.0), 2.5)
        plane = np.arange(plan_j.n_slots, dtype=np.float32)
        for offs in (jcw._HALF_OFFS, jcw._OFFS):
            np.testing.assert_array_equal(
                np_(tcw._roll_offs(torch.as_tensor(plane), plan_t, offs)),
                np_(jcw._roll_offs(jnp.asarray(plane), plan_j, offs)))
        block = plane.reshape(plan_j.n_cells, 3)
        for off in jcw._HALF_OFFS[1:]:
            np.testing.assert_array_equal(
                np_(tcw._roll_back(torch.as_tensor(block), plan_t, off)),
                np_(jcw._roll_back(jnp.asarray(block), plan_j, off)))

    def test_slot_cell_centers(self):
        plan_j = jcw.CellwisePlan((3, 4, 5), 3, (9.0, 12.0, 15.0), 2.5)
        plan_t = tcw.CellwisePlan((3, 4, 5), 3, (9.0, 12.0, 15.0), 2.5)
        lo = np.array([-4.5, -6.0, -7.5], np.float32)
        np.testing.assert_allclose(
            np_(tcw.slot_cell_centers(plan_t, lo, device="cpu")),
            np_(jcw.slot_cell_centers(plan_j, lo)), rtol=0, atol=1e-6)

    @pytest.mark.parametrize("case", ["pack", "rebuild", "overflow"])
    def test_repack_src_exact(self, case):
        (jl, jss, jaux), (tl, tss, taux) = packed_pair(256, 0.3, 2, 2.5)
        plan_j, plan_t = jl.plan, tl.plan
        lo = jl.lo
        if case == "pack":
            pos = np_(jss.positions)[np_(jaux["valid"]) > 0]
            valid = np.ones(len(pos), np.float32)
        else:
            # drift the slot state: some particles change cells
            rng = np.random.RandomState(4)
            pos = np_(jss.positions) + 0.6 * rng.uniform(
                -1, 1, np_(jss.positions).shape).astype(np.float32)
            valid = np.array(jaux["valid"])
        if case == "overflow":
            plan_j = jcw.CellwisePlan(plan_j.grid, 6, plan_j.lengths, 2.5)
            plan_t = tcw.CellwisePlan(plan_t.grid, 6, plan_t.lengths, 2.5)
            pos, valid = pos[:plan_j.n_slots], valid[:plan_j.n_slots]
        js, jo, jocc = jcw.repack_src(jnp.asarray(pos), jnp.asarray(valid),
                                      lo, plan_j, with_occ=True)
        ts, to, tocc = tcw.repack_src(torch.as_tensor(pos),
                                      torch.as_tensor(valid), lo, plan_t,
                                      with_occ=True)
        assert ts.dtype == torch.int32 and tocc.dtype == torch.int32
        np.testing.assert_array_equal(np_(ts), np_(js))
        assert bool(to) == bool(jo) == (case == "overflow")
        assert int(tocc) == int(jocc)


def _forces_jax_full(jl, jss, jaux, rc_matrix, pair_fn=lj_slope_jax,
                     min_r2=1e-4):
    return jcw.analytic_pair_forces(
        jss.positions, jss.types, jaux["valid"], jl.plan, jl.lo, pair_fn,
        needs_virial=True, with_types=True, rcut_matrix=rc_matrix,
        stencil="full", min_r2=min_r2)


TYPED_FORM = htt.md.LennardJones([[1.0, 0.5], [0.5, 0.5]], 1.0,
                                 r_cut=np.inf).kernel_form()


class TestPairForces:
    @pytest.mark.parametrize("stencil", ["full", "half", "kernel"])
    @pytest.mark.parametrize("rcm", [None, "matrix"])
    def test_matches_jax_full(self, stencil, rcm):
        """Torch forms and the K1 wrapper (its plain version on the CPU)
        against the JAX full stencil: forces, energy, virial, two types
        with a per-type epsilon, and a per-type cutoff matrix."""
        rc = None if rcm is None else RCM
        (jl, jss, jaux), (tl, tss, taux) = packed_pair(
            256, 0.35, 7, 2.5, typed=True, rc_matrix=rc)
        f_j, w_j = _forces_jax_full(jl, jss, jaux, rc)
        f_t, w_t = tcw.analytic_pair_forces(
            tss.positions, tss.types, taux["valid"], tl.plan, tl.lo,
            lj_slope_torch, needs_virial=True, with_types=True,
            rcut_matrix=rc, stencil=stencil, form=TYPED_FORM)
        np.testing.assert_allclose(np_(f_t), np_(f_j), **TOL)
        np.testing.assert_allclose(np_(w_t), np_(w_j), **TOL)
        gh = np_(taux["valid"]) == 0
        assert np.all(np_(f_t)[gh] == 0)

    @pytest.mark.parametrize("stencil", ["full", "half"])
    def test_untyped_pair_fn_with_cutoff_matrix(self, stencil):
        """An untyped pair function under a per-type cutoff matrix: the
        types feed the mask only."""
        (jl, jss, jaux), (tl, tss, taux) = packed_pair(
            256, 0.35, 7, 2.5, typed=True, rc_matrix=RCM)

        def lj(r2):
            u = 1.0 / r2
            sr6 = u * u * u
            return 4.0 * (sr6 * sr6 - sr6), -12.0 * (2.0 * sr6 - 1.0) * sr6 * u

        f_j, w_j = jcw.analytic_pair_forces(
            jss.positions, jss.types, jaux["valid"], jl.plan, jl.lo, lj,
            needs_virial=True, rcut_matrix=RCM, stencil="full")
        f_t, w_t = tcw.analytic_pair_forces(
            tss.positions, tss.types, taux["valid"], tl.plan, tl.lo, lj,
            needs_virial=True, rcut_matrix=RCM, stencil=stencil)
        np.testing.assert_allclose(np_(f_t), np_(f_j), **TOL)
        np.testing.assert_allclose(np_(w_t), np_(w_j), **TOL)

    def test_kernel_plain_matches_jax_pallas(self):
        """The K1 wrapper's plain version against the JAX Pallas kernel
        run in interpret mode, typed with a cutoff matrix."""
        from hoomd_tf_tpu.ops.cellwise_pallas import half_stencil_pair_forces
        (jl, jss, jaux), (tl, tss, taux) = packed_pair(
            125, 0.2, 11, 2.5, typed=True, rc_matrix=RCM)
        f_j, w_j = half_stencil_pair_forces(
            jss.positions, jss.types, jaux["valid"], jl.plan, jl.lo,
            lj_slope_jax, needs_virial=True, with_types=True,
            rcut_matrix=RCM, interpret=True)
        f_t, w_t = tcc.half_stencil_pair_forces(
            tss.positions, tss.types, taux["valid"], tl.plan, tl.lo,
            TYPED_FORM, needs_virial=True, rc2_tab=tl.rc2_tab)
        np.testing.assert_allclose(np_(f_t), np_(f_j), **TOL)
        np.testing.assert_allclose(np_(w_t), np_(w_j), **TOL)

    @pytest.mark.parametrize("flags", [(True, True), (False, False)])
    def test_planes_contract(self, flags):
        """The wrapper's output contract: ``forces4 [n_slots, 4]`` and the
        ``[n_slots, 3, 3]`` virial (or None), ghost rows and an untrained
        energy column zero, and on a CPU tensor it is the plain version
        (no launch)."""
        energy, virial = flags
        _, (tl, tss, taux) = packed_pair(256, 0.35, 7, 2.5)
        plan = tl.plan
        form = htt.md.LennardJones(r_cut=2.5).kernel_form()
        args = (tss.positions, tss.types, taux["valid"], plan, tl.lo, form)
        kw = dict(needs_energy=energy, needs_virial=virial,
                  geometry=tl.geometry)
        before = tcc.half_stencil_pair_forces.launches
        f, w = tcc.half_stencil_pair_forces(*args, **kw)
        assert tcc.half_stencil_pair_forces.launches == before
        assert f.shape == (plan.n_slots, 4) and f.dtype == torch.float32
        assert (w is None) == (not virial)
        if virial:
            assert w.shape == (plan.n_slots, 3, 3)
            torch.testing.assert_close(w, w.transpose(1, 2), rtol=0, atol=0)
        ghost = np_(taux["valid"]) == 0
        assert np.all(np_(f)[ghost] == 0)
        assert np.any(np_(f)[:, 3] != 0) == energy
        f_p, w_p = tcc.half_stencil_plain(*args, **kw)
        torch.testing.assert_close(f, f_p, rtol=0, atol=0)
        if virial:
            torch.testing.assert_close(w, w_p, rtol=0, atol=0)

    def test_wrapper_rejects_bad_inputs(self):
        form = htt.md.LennardJones().kernel_form()
        typed = htt.md.LennardJones([[1, 1], [1, 1]], 1.0).kernel_form()
        plan = tcw.CellwisePlan((3, 3, 3), 2, (9.,) * 3, 2.5)
        n = plan.n_slots
        types, valid = torch.zeros(n, dtype=torch.int32), torch.ones(n)
        for bad in (torch.zeros(n - 1, 3), torch.zeros(n, 4)):
            with pytest.raises(ValueError, match="n_slots"):
                tcc.half_stencil_pair_forces(bad, types, valid, plan,
                                             (-4.5,) * 3, typed)
        with pytest.raises(ValueError, match="valid: expected shape"):
            tcc.half_stencil_pair_forces(torch.zeros(n, 3), types,
                                         valid[:-1], plan, (-4.5,) * 3, form)
        with pytest.raises(ValueError, match="kernel form|LJ-family"):
            tcw.analytic_pair_forces(
                torch.zeros(8, 3), torch.zeros(8, dtype=torch.int32),
                torch.ones(8), tcw.CellwisePlan((3, 3, 3), 2, (9.,) * 3,
                                                2.5),
                (-4.5,) * 3, None, stencil="kernel")
        assert form.ntypes == 1 and typed.ntypes == 2

    @pytest.mark.parametrize("stencil", ["full", "half", "kernel"])
    def test_ghost_forces_finite_for_steep_potentials(self, stencil):
        """Port of the JAX ghost-finite test: co-resident ghosts are
        pushed apart by rank, so no ghost lane evaluates the clamp, even
        for an r^-24 slope (tensor forms) or an LJ form (kernel) at
        min_r2 = 1e-8; the tensor forms also match JAX there."""
        (jl, jss, jaux), (tl, tss, taux) = packed_pair(96, 0.2, 3, 2.5)
        occ = np_(taux["valid"]).reshape(tl.plan.n_cells, -1).sum(1)
        assert (tl.plan.capacity - occ.max()) >= 2

        def steep_t(r2):
            u = 1.0 / r2
            s12 = (u * u * u) ** 4
            return s12, -12.0 * s12 * u

        def steep_j(r2):
            u = 1.0 / r2
            s12 = (u * u * u) ** 4
            return s12, -12.0 * s12 * u

        f, w = tcw.analytic_pair_forces(
            tss.positions, tss.types, taux["valid"], tl.plan, tl.lo,
            steep_t, stencil=stencil, min_r2=1e-8, needs_virial=True,
            form=htt.md.LennardJones(r_cut=2.5).kernel_form())
        gh = np_(taux["valid"]) == 0
        assert np.isfinite(np_(f)).all() and np.isfinite(np_(w)).all()
        assert np.all(np_(f)[gh] == 0)
        if stencil != "kernel":
            f_j, _ = jcw.analytic_pair_forces(
                jss.positions, jss.types, jaux["valid"], jl.plan, jl.lo,
                steep_j, stencil="full", min_r2=1e-8, needs_virial=True)
            np.testing.assert_allclose(np_(f), np_(f_j), **TOL)


def _smooth_energy(r2):
    u = 1.0 / r2
    return (u * u - 2.0 * u) / (1.0 + u * u)


class TestPlainVersion:
    """Kernel K1's plain version (``half_stencil_plain``, what the wrapper
    runs on a CPU tensor) against the tensor forms and the JAX package."""

    @pytest.mark.parametrize("case", ["lj", "typed_rcut", "proxy"])
    def test_plain_equals_half_tensor_form(self, case):
        """Exactly ``analytic_pair_forces(stencil='half')`` with the same
        pair function: forces, energy and virial."""
        typed = case == "typed_rcut"
        _, (tl, tss, taux) = packed_pair(256, 0.35, 7, 2.5, typed=typed,
                                         rc_matrix=RCM if typed else None)
        if case == "proxy":
            from hoomd_tf_tpu_torch.ops.chebyshev import make_pair_proxy
            fit, ev = make_pair_proxy(8, (0.25 * 2.5) ** 2, 2.5 ** 2,
                                      device="cpu")
            coeffs = fit(_smooth_energy)
            form = ev.kernel_form(coeffs)
            pair_fn = lambda r2: ev(coeffs, r2)   # noqa: E731
        else:
            form = TYPED_FORM if typed else \
                htt.md.LennardJones(r_cut=2.5).kernel_form()
            pair_fn = form.evaluate
        common = (tss.positions, tss.types, taux["valid"], tl.plan, tl.lo)
        f_p, w_p = tcc.half_stencil_plain(
            *common, form, needs_virial=True, rc2_tab=tl.rc2_tab,
            geometry=tl.geometry)
        f_h, w_h = tcw.analytic_pair_forces(
            *common, pair_fn, needs_virial=True, with_types=typed,
            rcut_matrix=tl.rc2_tab, stencil="half", geometry=tl.geometry)
        torch.testing.assert_close(f_p, f_h, rtol=0, atol=0)
        torch.testing.assert_close(w_p, w_h, rtol=0, atol=0)
        assert np_(f_p)[:, 3].any()

    def test_plain_matches_jax_pallas(self):
        """Untyped, with energy and virial, against the JAX Pallas kernel
        run in interpret mode."""
        from hoomd_tf_tpu.ops.cellwise_pallas import half_stencil_pair_forces
        (jl, jss, jaux), (tl, tss, taux) = packed_pair(125, 0.2, 5, 2.5)

        def lj_jax(r2):
            u = 1.0 / r2
            sr6 = u * u * u
            inside = r2 <= 2.5 ** 2
            return (jnp.where(inside, 4.0 * (sr6 * sr6 - sr6), 0.0),
                    jnp.where(inside, -12.0 * (2.0 * sr6 - 1.0) * sr6 * u,
                              0.0))
        f_j, w_j = half_stencil_pair_forces(
            jss.positions, jss.types, jaux["valid"], jl.plan, jl.lo, lj_jax,
            needs_virial=True, interpret=True)
        f_t, w_t = tcc.half_stencil_plain(
            tss.positions, tss.types, taux["valid"], tl.plan, tl.lo,
            htt.md.LennardJones(r_cut=2.5).kernel_form(), needs_virial=True,
            geometry=tl.geometry)
        np.testing.assert_allclose(np_(f_t), np_(f_j), **TOL)
        np.testing.assert_allclose(np_(w_t), np_(w_j), **TOL)

    def test_valid_not_a_prefix(self):
        """Occupied slots need not be a prefix of their cell: moving each
        cell's first particle into its first empty slot moves its forces,
        energy and virial with it and changes nothing else."""
        from torch_helpers import hole_permutation
        _, (tl, tss, taux) = packed_pair(256, 0.35, 7, 2.5, typed=True,
                                         rc_matrix=RCM)
        plan = tl.plan
        perm = hole_permutation(taux["valid"], plan.capacity)
        valid = taux["valid"][perm]
        v = np_(valid).reshape(plan.n_cells, -1)
        assert (v[:, 0] == 0).any() and v.sum() == 256
        kw = dict(needs_virial=True, rc2_tab=tl.rc2_tab,
                  geometry=tl.geometry)
        f0, w0 = tcc.half_stencil_pair_forces(
            tss.positions, tss.types, taux["valid"], plan, tl.lo,
            TYPED_FORM, **kw)
        f1, w1 = tcc.half_stencil_pair_forces(
            tss.positions[perm], tss.types[perm], valid, plan, tl.lo,
            TYPED_FORM, **kw)
        np.testing.assert_allclose(np_(f1), np_(f0[perm]), **TOL)
        np.testing.assert_allclose(np_(w1), np_(w0[perm]), **TOL)
        assert np.all(np_(f1)[np_(valid) == 0] == 0)


def _bench_lj():
    """bench.py's LJ PairModel class, taken from the file's source (the
    module itself is not imported: it configures a JAX compile cache)."""
    src = (pathlib.Path(__file__).resolve().parents[1] / "bench.py")
    tree = ast.parse(src.read_text())
    cls = next(n for n in tree.body
               if isinstance(n, ast.ClassDef) and n.name == "LJ")
    ns = {"htf": htf}
    exec(compile(ast.Module([cls], []), str(src), "exec"), ns)
    return ns["LJ"](64)


class TestForms:
    @pytest.mark.parametrize("case", ["lj", "lj-shift", "lj-typed", "wca",
                                      "bench"])
    def test_form_matches_jax(self, case):
        """The LJ-family form's evaluation (the kernel's pair function,
        in torch) equals the JAX potentials' pair_energy_and_slope, and
        so does the port's own md potential."""
        rng = np.random.RandomState(0)
        r2 = rng.uniform(0.6, 10.0, size=(40, 50)).astype(np.float32)
        ti = rng.randint(0, 2, size=(40, 50))
        tj = rng.randint(0, 2, size=(40, 50))
        eps = np.array([[1.0, 0.7], [0.7, 0.4]], np.float32)
        sig = np.array([[1.0, 1.1], [1.1, 0.9]], np.float32)
        if case == "lj":
            jp, tp = htf.md.LennardJones(1.2, 0.9, 2.5), \
                htt.md.LennardJones(1.2, 0.9, 2.5)
        elif case == "lj-shift":
            jp, tp = htf.md.LennardJones(1.0, 1.0, 2.5, shift=True), \
                htt.md.LennardJones(1.0, 1.0, 2.5, shift=True)
        elif case == "lj-typed":
            jp, tp = htf.md.LennardJones(eps, sig, 2.5), \
                htt.md.LennardJones(eps, sig, 2.5)
        elif case == "wca":
            jp, tp = htf.md.WCA(1.0, 1.0), htt.md.WCA(1.0, 1.0)
        else:
            model = _bench_lj()
            jp = None
            tp = htt.md.LennardJones(1.0, 1.0, r_cut=np.inf)
        if jp is None:
            U_j, dU_j = model.pair_energy_and_slope(jnp.asarray(r2))
        else:
            U_j, dU_j = jp.pair_energy_and_slope(
                jnp.asarray(r2), jnp.asarray(ti), jnp.asarray(tj))
        r2_t, ti_t, tj_t = (torch.as_tensor(a) for a in (r2, ti, tj))
        form = tp.kernel_form()
        for U, dU in (form.evaluate(r2_t, ti_t, tj_t),
                      tp.pair_energy_and_slope(r2_t, ti_t, tj_t)):
            np.testing.assert_allclose(np_(U), np_(U_j), rtol=1e-5,
                                       atol=1e-6)
            np.testing.assert_allclose(np_(dU), np_(dU_j), rtol=1e-5,
                                       atol=1e-6)
