"""The port's ``parallel`` slice against the JAX package on the CPU: the
planner's mesh divisor, K1's slab plain version, the sharded engine
(``Simulation(mesh=)`` and ``ShardedSimulation``) on virtual CPU shards
(``make_mesh(S, devices=[cpu] * S)``), the explicit ring halo and frame
data-parallel training.

Tolerances: plans equal exactly. The slab plain version summed over
shards, with the reverse halos added, equals the unsharded plain version
at rtol = atol = 1e-5 (the same float32 terms, only the boundary layer's
back sums added in another order), and the JAX ``analytic_pair_forces``
at 1e-4 (the JAX package's kernel bar, tests/test_cellwise.py). Eight
NVT steps against the JAX package's single-device ``'n2'`` engine at
atol 5e-4 with the repack interval pinned to 3 (tests/test_parallel.py's
bar: other summation orders, chaos-amplified over the steps). The halo
ring against the model on the whole system at rtol 1e-4, atol 1e-5
(tests/test_parallel.py). Frame-sharded gradients against one device's
at rtol 1e-4 (the summation order of the frame means).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import hoomd_tf_tpu as htf
import zoo
from hoomd_tf_tpu.ops import cellwise as jcw
import hoomd_tf_tpu_torch as htt
from hoomd_tf_tpu_torch.md.slots import SlotLayout
from hoomd_tf_tpu_torch.ops import cellwise as tcw
from hoomd_tf_tpu_torch.ops import cellwise_cuda as tcc
from hoomd_tf_tpu_torch.parallel import (ShardedSimulation, make_mesh,
                                         sharded_train_step)

from hoomd_tf_tpu_torch.interop import state_from_numpy
from test_torch_layers import JEDSModel, TEDSModel
from torch_helpers import (fluid_arrays, jax_state_numpy, np_,
                           torch_state)

CPU = torch.device("cpu")


def cpu_mesh(S):
    return make_mesh(S, devices=[CPU] * S)


class TLJ(htt.PairModel):
    """LJ (epsilon = sigma = 1) declaring K1's LJ form."""

    def pair_energy(self, r2):
        return self.pair_energy_and_slope(r2)[0]

    def pair_energy_and_slope(self, r2):
        u = 1.0 / r2
        sr6 = u * u * u
        return (4.0 * (sr6 * sr6 - sr6),
                -12.0 * (2.0 * sr6 - 1.0) * sr6 * u)

    def pair_kernel_form(self):
        return htt.md.LennardJones(1.0, 1.0, r_cut=np.inf)


class TLJModel(htt.SimModel):
    """tests/zoo.py's LJModel: a generic SimModel, lane-separable."""

    def compute(self, nlist, positions, box):
        rinv = htt.nlist_rinv(nlist)
        inv_r6 = rinv ** 6
        p_energy = 4.0 / 2.0 * (inv_r6 * inv_r6 - inv_r6)
        return htt.compute_nlist_forces(nlist, torch.sum(p_energy, dim=1))


# ----------------------------------------------------------------------
# the planner
# ----------------------------------------------------------------------
@pytest.mark.parametrize("case", [
    (2000, 24.0, 3.0, 2), (2000, 24.0, 3.0, 4), (4096, 21.7, 2.5, 8),
    (4096, 21.7, 2.5, 4), (20000, 40.0, 2.5, 8), (1000, 13.6, 2.5, 2),
    (512, 10.0, 2.5, 4)])
def test_plan_z_divisor_matches_jax(case):
    """``plan_cellwise(z_divisor=S)`` gives JAX's grid and capacity, with
    ``nz % S == 0``, or ``None`` with it (a box of 4 cells per axis on a
    4-shard mesh leaves no z grid of 3 or more that 4 divides... but 4
    itself; at 10.0 / 2.5 only 4 fits, and 8 does not)."""
    n, L, r_cut, S = case
    rng = np.random.RandomState(n)
    pos = rng.uniform(-L / 2, L / 2, (n, 3)).astype(np.float32)
    for kw in (dict(), dict(positions=pos, width_blocks=14,
                             drift_per_step=0.01)):
        jp = jcw.plan_cellwise(n, [L] * 3, r_cut, z_divisor=S, **kw)
        tp = tcw.plan_cellwise(n, [L] * 3, r_cut, z_divisor=S, **kw)
        if jp is None:
            assert tp is None
            continue
        assert (tp.grid, tp.capacity) == (jp.grid, jp.capacity)
        assert tp.grid[2] % S == 0


def test_plan_z_divisor_none_matches_jax():
    """No z grid of 3 or more layers that 8 divides: ``None`` in both."""
    assert jcw.plan_cellwise(2000, [16.0] * 3, 2.5, z_divisor=8) is None
    assert tcw.plan_cellwise(2000, [16.0] * 3, 2.5, z_divisor=8) is None


# ----------------------------------------------------------------------
# K1's slab plain version
# ----------------------------------------------------------------------
def slab_case(S, typed=False, n=1000, density=0.35, r_cut=2.5, seed=3):
    """One fluid packed on a plan with ``nz % S == 0`` in both packages:
    ``(port layout, slot state, aux), (JAX layout, slot state, aux)``."""
    from hoomd_tf_tpu.md.slots import SlotLayout as JLayout
    pos, vel, lengths = fluid_arrays(n, density, seed)
    types = (np.arange(n) % 2) if typed else None
    rcm = np.array([[2.5, 1.8], [1.8, 2.2]], np.float32) if typed else None
    lo = -np.asarray(lengths, np.float64) / 2
    plan = tcw.plan_cellwise(n, lengths, r_cut, positions=pos, lo=lo,
                             z_divisor=S)
    jplan = jcw.plan_cellwise(n, lengths, r_cut, positions=pos, lo=lo,
                              z_divisor=S)
    assert (plan.grid, plan.capacity) == (jplan.grid, jplan.capacity)
    assert plan.grid[2] % S == 0 and plan.grid[2] // S < plan.grid[2]
    tl = SlotLayout(plan, n, lo, rc_matrix=rcm, device="cpu")
    ts, taux = tl.pack(torch_state(pos, vel, lengths, types=types))
    from hoomd_tf_tpu.md.state import init_state
    jl = JLayout(jplan, n, lo, rc_matrix=rcm)
    js, jaux, _ = jl.pack(init_state(pos, lengths, types=types,
                                     velocities=vel))
    return (tl, ts, taux), (jl, js, jaux)


def _smooth_energy(r2):
    return 4.0 * (r2 ** -6 - r2 ** -3)


def slab_form(kind, r_cut=2.5):
    """``(port form, JAX pair_fn, with_types)`` of a pair form."""
    if kind == "lj":
        form = htt.md.LennardJones(r_cut=r_cut).kernel_form()

        def jfn(r2):
            u = 1.0 / r2
            sr6 = u * u * u
            return (4.0 * (sr6 * sr6 - sr6),
                    -12.0 * (2.0 * sr6 - 1.0) * sr6 * u)
        return form, jfn, False
    if kind == "typed":
        eps = [[1.0, 0.5], [0.5, 0.5]]
        form = htt.md.LennardJones(eps, 1.0, r_cut=r_cut).kernel_form()

        def jfn(r2, ti, tj):
            e = jnp.where((ti == 0) & (tj == 0), 1.0, 0.5)
            u = 1.0 / r2
            sr6 = u * u * u
            return (4.0 * e * (sr6 * sr6 - sr6),
                    -12.0 * e * (2.0 * sr6 - 1.0) * sr6 * u)
        return form, jfn, True
    # the Chebyshev proxy of a smooth LJ, fitted by the port; JAX takes
    # the port's form as its pair function on numpy-made lanes
    from hoomd_tf_tpu_torch.ops.chebyshev import make_pair_proxy
    fit, ev = make_pair_proxy(8, (0.25 * r_cut) ** 2, r_cut ** 2,
                              device="cpu")
    form = ev.kernel_form(fit(_smooth_energy))

    def jfn(r2):
        u, s = form.evaluate(torch.as_tensor(np.asarray(r2)))
        return jnp.asarray(u.numpy()), jnp.asarray(s.numpy())
    return form, jfn, False


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("kind", ["lj", "proxy", "typed"])
@pytest.mark.parametrize("ev", [True, False])
def test_slab_plain_sums_to_unsharded_and_jax(S, kind, ev):
    """Summed over shards with the reverse halos added, the slab plain
    version equals the unsharded plain version (1e-5) and JAX's
    ``analytic_pair_forces`` (1e-4); forces, energy and virial on or
    off together."""
    typed = kind == "typed"
    (tl, ts, taux), (jl, js, jaux) = slab_case(S, typed=typed)
    form, jfn, with_types = slab_form(kind)
    common = (ts.positions, ts.types, taux["valid"], tl.plan, tl.lo)
    f0, w0 = tcc.half_stencil_plain(
        *common, form, needs_virial=ev, needs_energy=ev,
        rc2_tab=tl.rc2_tab, geometry=tl.geometry)
    f1, w1 = tcw.analytic_pair_forces(
        *common, form.evaluate, needs_virial=ev, needs_energy=ev,
        with_types=with_types, rcut_matrix=tl.rc2_tab, form=form,
        geometry=tl.geometry, mesh=cpu_mesh(S))
    torch.testing.assert_close(f1, f0, rtol=1e-5, atol=1e-5)
    assert (w1 is None) == (not ev)
    if ev:
        torch.testing.assert_close(w1, w0, rtol=1e-5, atol=1e-5)
        assert np_(f1)[:, 3].any()
    if kind == "proxy":
        return  # the proxy's JAX counterpart is the port's own form
    fj, wj = jcw.analytic_pair_forces(
        js.positions, js.types, jaux["valid"], jl.plan, jl.lo, jfn,
        needs_virial=ev, needs_energy=ev, with_types=with_types,
        rcut_matrix=jl.rc_matrix, stencil="full")
    np.testing.assert_allclose(np_(f1), np_(fj), rtol=1e-4, atol=1e-4)
    if ev:
        np.testing.assert_allclose(np_(w1), np_(wj), rtol=1e-4, atol=1e-4)


def test_slab_shards_and_wrappers():
    """Each shard's slab plain version: K1's group wrapper's CPU branch on
    the shard as its group of one is it (the generic form's is its list
    plain version, ``generic_group_plain``); its home rows plus the
    previous shard's reverse halo give the unsharded forces of its
    slab."""
    S = 4
    (tl, ts, taux), _ = slab_case(S)
    plan, lo = tl.plan, tl.lo
    form = htt.md.LennardJones(r_cut=2.5).kernel_form()
    f0, _ = tcc.half_stencil_plain(ts.positions, ts.types, taux["valid"],
                                   plan, lo, form, geometry=tl.geometry)
    layer = plan.grid[0] * plan.grid[1] * plan.capacity
    outs = []
    for s, (z0, nzl) in enumerate(tcw.slab_layers(plan, S)):
        a, b = tcw.slab_rows(plan, z0, nzl)
        buf = [torch.cat([t[a], t[b]]) for t in
               (ts.positions, ts.types, taux["valid"])]
        one = tcw.SlabGroup(torch.device("cpu"), (s,), ((z0, nzl),), (-1,),
                            (-1,))
        (f_w,), _ = tcc.half_stencil_group_forces(
            *([t] for t in buf), plan, lo, form, one, geometry=tl.geometry)
        (f_g,), _ = tcc.generic_group_pair_forces(
            *([t] for t in buf), plan, lo, form.evaluate, one,
            typed_fn=False, geometry=tl.geometry)
        f_p, _ = tcw.half_stencil_slab_plain(
            *buf, plan, lo, form.evaluate, z0, nzl, geometry=tl.geometry)
        (f_gp,), _, _ = tcc.generic_group_plain(
            *([t] for t in buf), plan, lo, form.evaluate, one,
            typed_fn=False, geometry=tl.geometry)
        torch.testing.assert_close(f_w, f_p, rtol=0, atol=0)
        torch.testing.assert_close(f_g, f_gp, rtol=0, atol=0)
        assert f_p.shape[0] == (nzl + 1) * layer
        outs.append((z0, nzl, f_p))
    for s, (z0, nzl, f) in enumerate(outs):
        rev = outs[s - 1][2][outs[s - 1][1] * layer:]
        home = f[:nzl * layer].clone()
        home[:layer] += rev
        torch.testing.assert_close(
            home, f0[z0 * layer:(z0 + nzl) * layer], rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="not divisible"):
        tcw.slab_layers(plan, 3 if plan.grid[2] % 3 else 5)


# ----------------------------------------------------------------------
# the sharded engine on 4 virtual CPU shards
# ----------------------------------------------------------------------
def fluid_pair(n, model_j, model_t, mesh, nlist="cellwise", seed=0,
               integrator="NVT"):
    """One fluid (density 0.4, jitter 0.08) in the JAX package's
    single-device engine on ``'n2'`` and in the port's sharded engine on
    ``nlist``, each with its model at r_cut 2.5."""
    pos, vel, lengths = fluid_arrays(n, 0.4, seed, jitter=0.08)
    integ = {"NVT": lambda pkg: pkg.md.NVT(kT=1.0, tau=0.5),
             "NVE": lambda pkg: pkg.md.NVE()}[integrator]
    jsim = htf.Simulation(dt=0.005, integrator=integ(htf), seed=seed)
    jsim.init_state(pos, lengths, velocities=vel)
    htf.tfcompute(model_j).attach(jsim, r_cut=2.5, nlist="n2")
    tsim = htt.Simulation(dt=0.005, integrator=integ(htt), seed=seed,
                          mesh=mesh)
    tsim.init_state(pos, lengths, velocities=vel)
    htt.tfcompute(model_t).attach(tsim, r_cut=2.5, nlist=nlist)
    return jsim, tsim


def min_image_diff(a, b, lengths):
    d = np_(a) - np_(b)
    L = np.asarray(lengths)
    return d - np.round(d / L) * L


def test_sharded_evaluation_equals_unsharded():
    """One evaluation of the sharded engine (4 shards, K1's slab plain
    version) equals the unsharded port's at the same plan (1e-5), the
    virial too."""
    pos, vel, lengths = fluid_arrays(2000, 0.4, 0, jitter=0.08)
    sims = []
    for mesh in (cpu_mesh(4), None):
        sim = htt.Simulation(mesh=mesh, device=None if mesh else "cpu")
        sim.init_state(pos, lengths, velocities=vel)
        htt.tfcompute(TLJ(48)).attach(sim, r_cut=2.5, nlist="cellwise")
        sims.append(sim)
    shd, ref = sims
    ls = shd._ensure_layout()
    lr = ref._ensure_layout(ls.plan)
    assert ls.plan.grid[2] % 4 == 0 and lr.plan == ls.plan
    st, aux = lr.pack(ref.state)
    f_s, w_s = shd._forces(st, aux, ls, shd._route(ls, st, aux), True, True)
    f_r, w_r = ref._forces(st, aux, lr, ref._route(lr, st, aux), True, True)
    torch.testing.assert_close(f_s, f_r, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(w_s, w_r, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["pair", "probe", "prime"])
def test_sharded_nvt_matches_jax(case):
    """8 NVT steps of the port's sharded engine (4 shards on 'cellwise',
    the repack interval pinned to 3: two mid-run repacks) against the JAX
    package's single-device engine on 'n2' (atol 5e-4). 'probe':
    tests/zoo.py's LJModel, which the probe accepts, in K1's generic
    form; 'prime': n = 1999, so the shards hold different numbers of
    particles."""
    n = 1999 if case == "prime" else 2000
    if case == "probe":
        models = (zoo.LJModel(48), TLJModel(48))
    else:
        models = (zoo.PairLJ(48), TLJ(48))
    jsim, tsim = fluid_pair(n, *models, cpu_mesh(4))
    layout = tsim._ensure_layout()
    assert layout.plan.grid[2] % 4 == 0
    tsim._choose_repack_interval = lambda layout: 3
    jsim.run(8)
    tsim.run(8)
    if case == "probe":
        assert tsim.tfc._lane_fast_ok
    if case == "prime":
        # the shards' slabs hold unequal numbers of particles (each
        # shard's resident valid column, its home rows)
        slots, (_, aux) = tsim._packed[1], tsim._packed[2]
        valid = torch.stack([v[:slots.home(s)].sum()
                             for s, v in enumerate(aux["valid"])])
        assert len(set(np_(valid).tolist())) > 1
    d = min_image_diff(tsim.state.positions, jsim.state.positions,
                       tsim._lengths)
    np.testing.assert_allclose(d, np.zeros_like(d), atol=5e-4)
    t = tsim.thermo()["temperature"]
    assert 0.3 < t < 2.5, t


# ----------------------------------------------------------------------
# ShardedSimulation
# ----------------------------------------------------------------------
def lattice_state(n, a, seed=0, jitter=0.05):
    pos, lengths = htt.md.lattice_positions(n, a=a)
    rng = np.random.RandomState(seed)
    pos = (pos + jitter * rng.randn(*pos.shape)).astype(np.float32)
    return pos, lengths


def test_nvt_run_and_thermo():
    """tests/test_parallel.py's ShardedSimulation run on 8 shards: 128
    particles (a box too small for the mesh's z grid: the 'n2' rows),
    NVT 50 steps, against the JAX package's single-device 'n2' run from
    the same state (atol 1e-4)."""
    pos, lengths = lattice_state(128, 1.4, seed=1, jitter=0.0)
    rng = np.random.RandomState(1)
    vel = (0.8 ** 0.5 * rng.randn(128, 3)).astype(np.float32)
    vel -= vel.mean(0)
    sim = ShardedSimulation(dt=0.002, kT=0.8, tau=0.5, mesh=cpu_mesh(8),
                            seed=1)
    sim.init_state(pos, lengths, velocities=vel)
    tfc = sim.attach(TLJModel(24), r_cut=2.5)
    assert tfc.nlist_method == "n2" and sim.n_devices == 8
    sim.run(50)
    t = sim.thermo()
    assert np.isfinite(t["potential_energy"])
    assert 0.1 < t["temperature"] < 3.0
    assert int(sim.state.step) == 50
    assert sim.nlist_builds == 50
    jsim = htf.Simulation(dt=0.002, integrator=htf.md.NVT(kT=0.8, tau=0.5))
    jsim.init_state(pos, lengths, velocities=vel)
    htf.tfcompute(zoo.LJModel(24)).attach(jsim, r_cut=2.5, nlist="n2")
    jsim.run(50)
    d = min_image_diff(sim.state.positions, jsim.state.positions, lengths)
    np.testing.assert_allclose(d, np.zeros_like(d), atol=1e-4)


def test_matches_single_device():
    """NVE through ShardedSimulation (8 shards, 64 particles) equals the
    JAX package's single-device 'n2' run (atol 1e-4), as
    tests/test_parallel.py holds its own."""
    n, r_cut, NN, dt, steps = 64, 2.5, 16, 0.001, 10
    pos, lengths = lattice_state(n, 1.3, seed=9)
    ssim = ShardedSimulation(dt=dt, mesh=cpu_mesh(8), seed=0)
    ssim.init_state(pos, lengths, velocities=np.zeros((n, 3), np.float32))
    ssim._shard_state()
    ssim.attach(TLJModel(NN), r_cut=r_cut)
    ssim.run(steps)
    jsim = htf.Simulation(dt=dt, integrator=htf.md.NVE(), seed=0)
    jsim.init_state(pos, lengths, velocities=np.zeros((n, 3), np.float32))
    htf.tfcompute(zoo.LJModel(NN)).attach(jsim, r_cut=r_cut, nlist="n2")
    jsim.run(steps)
    np.testing.assert_allclose(np_(ssim.state.positions),
                               np_(jsim.state.positions), atol=1e-4)


def test_small_box_falls_back_to_n2():
    sim = ShardedSimulation(dt=0.005, kT=0.8, mesh=cpu_mesh(8), seed=5)
    sim.init_lattice(128, a=1.4, kT_init=0.8)
    assert not sim.cellwise_feasible(2.5)
    tfc = sim.attach(TLJModel(24), r_cut=2.5)
    assert tfc.nlist_method == "n2"
    sim.run(10)
    assert np.isfinite(sim.thermo()["potential_energy"])


def sharded_and_single(n, S, integrator, seed, period=1, builtin=False):
    """The same fluid in ShardedSimulation (S shards) and in the port's
    unsharded engine."""
    pos, vel, lengths = fluid_arrays(n, 0.4, seed, jitter=0.08)
    out = []
    for mesh in (cpu_mesh(S), None):
        if mesh is None:
            sim = htt.Simulation(dt=0.005, integrator=integrator(),
                                 seed=seed, device="cpu")
        else:
            sim = ShardedSimulation(dt=0.005, mesh=mesh, seed=seed,
                                    integrator=integrator())
        sim.init_state(pos, lengths, velocities=vel)
        if builtin:
            sim.add_force(htt.md.LennardJones(epsilon=0.5, sigma=1.0,
                                              r_cut=2.5))
        tfc = htt.tfcompute(TLJModel(48))
        tfc.attach(sim, r_cut=2.5, nlist="cellwise", period=period)
        out.append(sim)
    # the same plan, so the trajectories are comparable
    shd, ref = out
    ref._layout = None
    ref._plan_from_current = lambda: shd._ensure_layout().plan
    shd._choose_repack_interval = ref._choose_repack_interval = \
        lambda layout: 3
    return shd, ref


def test_sharded_langevin_and_logging():
    """Langevin on 4 shards with run(30, log_period=10): three finite
    records, T healthy, and the records (and the state) those of the
    unsharded port with the same seed (the noise is drawn per particle
    from the simulation's generator, whatever the shards)."""
    shd, ref = sharded_and_single(
        1000, 4, lambda: htt.md.Langevin(kT=0.9, gamma=1.0), seed=2)
    for sim in (shd, ref):
        sim.run(30, log_period=10)
    assert shd.log["temperature"].shape == (3,)
    assert np.all(np.isfinite(shd.log["potential_energy"]))
    t = shd.thermo()["temperature"]
    assert 0.3 < t < 2.5, t
    for k in ("temperature", "potential_energy"):
        np.testing.assert_allclose(shd.log[k], ref.log[k], rtol=1e-4)
    d = min_image_diff(shd.state.positions, ref.state.positions,
                       shd._lengths)
    np.testing.assert_allclose(d, np.zeros_like(d), atol=5e-4)


def test_sharded_builtin_forces_and_period():
    """A built-in LJ beside the model evaluated every 2nd step, on 4
    shards: 10 steps, finite, equal to the unsharded port."""
    shd, ref = sharded_and_single(
        1500, 4, lambda: htt.md.NVT(kT=1.0, tau=0.5), seed=3, period=2,
        builtin=True)
    for sim in (shd, ref):
        sim.run(10)
    assert int(shd.state.step) == 10
    f = np_(shd.state.forces)
    assert np.all(np.isfinite(f))
    np.testing.assert_allclose(f, np_(ref.state.forces), rtol=1e-3,
                               atol=1e-3)


def test_replan_on_mesh_keeps_z_divisibility():
    """replan() under a mesh re-plans with the divisor and the sharded
    run goes on."""
    sim = ShardedSimulation(dt=0.002, kT=0.9, mesh=cpu_mesh(4), seed=6)
    sim.init_lattice(1500, density=0.4, kT_init=0.9)
    tfc = sim.attach(TLJ(48), r_cut=2.5)
    assert tfc.nlist_method == "cellwise"
    sim.run(10)
    sim.replan()
    plan = sim._ensure_layout().plan
    assert plan.grid[2] % 4 == 0, plan
    sim.run(5)
    assert np.isfinite(sim.thermo()["potential_energy"])


def test_stateful_model_on_mesh_matches_jax():
    """Reference example 03's stateful model (an EDS bias and the Mean of
    its CV) on 4 shards on 'n2': the dense build is split by shard rows
    and the model runs once a step on the whole list, so after 50 steps
    its EDS coupling, Adam count and mean CV equal the JAX package's
    single-device run's (rtol 1e-4, as tests/test_torch_stateful.py
    holds the unsharded port)."""
    jsim = htf.Simulation(dt=0.05, seed=2)
    jsim.init_lattice(n=27, a=4.0, kT_init=0.2)
    tsim = htt.Simulation(dt=0.05, seed=2, mesh=cpu_mesh(4))
    tsim.set_state(state_from_numpy(jax_state_numpy(jsim.state),
                                    device="cpu"))
    jm, tm = JEDSModel(16, set_point=4.0), TEDSModel(16, set_point=4.0)
    htf.tfcompute(jm).attach(jsim, r_cut=3.0, nlist="n2")
    htt.tfcompute(tm).attach(tsim, r_cut=3.0, nlist="n2")
    jsim.run(50)
    tsim.run(50)
    assert tsim.nlist_builds == 50
    assert int(tm.eds_bias.adam_t.value) == 10
    assert float(tm.cv_avg.count.value) == 50
    np.testing.assert_allclose(float(tm.eds_bias.alpha.value.detach()),
                               float(jm.eds_bias.alpha.value), rtol=1e-4)
    np.testing.assert_allclose(float(tm.cv_avg.result()),
                               float(jnp.asarray(jm.cv_avg.result())),
                               rtol=1e-4)
    d = min_image_diff(tsim.state.positions, jsim.state.positions,
                       tsim._lengths)
    np.testing.assert_allclose(d, np.zeros_like(d), atol=1e-4)


def test_batched_model_on_mesh_equals_unsharded():
    """attach(batch_size=) on 4 shards on 'n2': the rows' lists built by
    shard, the model in particle chunks on the gathered list, so 5 NVT
    steps equal the unsharded port's (atol 1e-5)."""
    pos, vel, lengths = fluid_arrays(300, 0.4, 4, jitter=0.08)
    sims = []
    for mesh in (cpu_mesh(4), None):
        sim = htt.Simulation(dt=0.005, seed=4, mesh=mesh,
                             device=None if mesh else "cpu",
                             integrator=htt.md.NVT(kT=1.0, tau=0.5))
        sim.init_state(pos, lengths, velocities=vel)
        htt.tfcompute(TLJModel(32)).attach(sim, r_cut=2.5, nlist="n2",
                                           batch_size=64)
        sim.run(5)
        sims.append(sim)
    d = min_image_diff(sims[0].state.positions, sims[1].state.positions,
                       lengths)
    np.testing.assert_allclose(d, np.zeros_like(d), atol=1e-5)
    assert sims[0].nlist_builds == 5


# ----------------------------------------------------------------------
# refusals under a mesh
# ----------------------------------------------------------------------
@pytest.mark.parametrize("case", ["tilted"])
def test_unsharded_routes_refused(case):
    """A tilted box on 'cellwise' raises NotImplementedError under a mesh,
    the JAX package's own refusal, instead of running unsharded. Every
    other route runs under a mesh: training, the planes route and NPT
    (tests/test_torch_parallel_train.py), the packed routes and mapped
    models (tests/test_torch_parallel_packed.py)."""
    sim = htt.Simulation(dt=0.002, mesh=cpu_mesh(2), seed=0)
    pos, vel, lengths = fluid_arrays(600, 0.4, 1, jitter=0.05)
    box = htt.make_box(-np.asarray(lengths) / 2, np.asarray(lengths) / 2,
                       tilt=[0.1, 0.0, 0.0], device="cpu")
    sim.init_state(pos, box, velocities=vel)
    htt.tfcompute(TLJ(48)).attach(sim, r_cut=2.5, nlist="cellwise")
    with pytest.raises(NotImplementedError) as e:
        sim.run(2)
    assert "mesh" in str(e.value)
    assert int(sim.state.step) == 0


# ----------------------------------------------------------------------
# the explicit ring halo
# ----------------------------------------------------------------------
def test_halo_force_fn_matches_whole_system_and_jax():
    """Slabs along x on 4 shards, the ring exchange and dense rows per
    shard: the model's forces on the whole system (rtol 1e-4, atol 1e-5),
    and the JAX package's halo_force_fn on make_mesh(4) on the same
    input."""
    from hoomd_tf_tpu.parallel import halo_force_fn as jhalo
    from hoomd_tf_tpu.parallel import make_mesh as jmesh
    from hoomd_tf_tpu_torch.models.module import get_state
    from hoomd_tf_tpu_torch.parallel import domain_decompose, halo_force_fn
    n, r_cut, NN, S = 512, 2.0, 32, 4
    pos, lengths = lattice_state(n, 1.1, seed=4)
    pos4 = np.concatenate([pos, np.zeros((n, 1), np.float32)], axis=1)
    L = float(lengths[0])
    assert L / S >= r_cut
    box = htt.box_from_lengths(lengths, device="cpu")
    perm, counts = domain_decompose(pos4, box, S, r_cut=r_cut)
    assert counts.sum() == n
    cmax = int(counts.max())
    slabs, offs = [], 0
    for c in counts:
        pad = np.full((cmax - c, 4), np.nan, np.float32)
        slabs.append(np.concatenate([pos4[perm][offs:offs + c], pad]))
        offs += c
    sharded = np.concatenate(slabs)

    model = TLJModel(NN)
    p4 = torch.as_tensor(pos4)
    nlist = htt.compute_nlist(p4, r_cut, NN, [L, L, L], sorted=True,
                              return_types=True)
    want = np_(model([nlist, p4, box])[0])[perm]
    fn = halo_force_fn(model, r_cut, cpu_mesh(S), halo_capacity=256)
    got, overflow, _ = fn(get_state(model), torch.as_tensor(sharded), box)
    assert not bool(overflow)
    got = np_(got)
    jm = zoo.LJModel(NN)
    jbox = htf.box_from_lengths(lengths)
    jnl = htf.compute_nlist(jnp.asarray(pos4), r_cut, NN, [L, L, L],
                            sorted=True, return_types=True)
    jm.ensure_built([jnl, jnp.asarray(pos4), jbox])
    from hoomd_tf_tpu.models.module import get_state as jget
    jf, jof, _ = jax.jit(jhalo(jm, r_cut, jmesh(S), halo_capacity=256))(
        jget(jm), jnp.asarray(sharded), jbox)
    assert not bool(jof)
    jf = np.asarray(jf)
    offs = row = 0
    for c in counts:
        np.testing.assert_allclose(got[row:row + c], want[offs:offs + c],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got[row:row + c], jf[row:row + c],
                                   rtol=1e-4, atol=1e-5)
        offs += c
        row += cmax
    # too small a capacity sets the flag
    _, overflow, _ = halo_force_fn(model, r_cut, cpu_mesh(S), 4)(
        get_state(model), torch.as_tensor(sharded), box)
    assert bool(overflow)


# ----------------------------------------------------------------------
# frame data-parallel training
# ----------------------------------------------------------------------
class TLJLayer(htt.Layer):
    """tests/zoo.py's LJLayer: trainable (sigma, epsilon), kept >= 0."""

    def __init__(self, sig, eps):
        super().__init__(name="lj")
        self.w = self.add_weight(
            (2,), initializer=np.asarray([sig, eps], np.float32),
            constraint=lambda x: torch.clamp_min(x, 0.0), name="lj-params")

    def forward(self, r):
        r6 = htt.divide_no_nan(self.w[1] ** 6, r ** 6)
        return self.w[0] * 4.0 * (r6 ** 2 - r6) / 2.0


class TTrainableGraph(htt.SimModel):
    def setup(self):
        self.lj = TLJLayer(1.0, 1.0)

    def compute(self, nlist, positions, box):
        r = htt.safe_norm(nlist[:, :, :3], axis=2)
        return htt.compute_nlist_forces(nlist,
                                        torch.sum(self.lj(r), dim=1))


def frames(n=64, NN=16, r_cut=3.0, n_frames=8, seed=2):
    """tests/test_parallel.py's frames: jittered lattices and LJ labels."""
    rng = np.random.RandomState(seed)
    base, lengths = htt.md.lattice_positions(n, a=1.3)
    L = float(lengths[0])
    box = htt.box_from_lengths(lengths, device="cpu")
    lj = htt.md.LennardJones(r_cut=r_cut)
    sim = htt.Simulation(device="cpu")
    nls, p4s, labs = [], [], []
    for _ in range(n_frames):
        pos = (base + 0.05 * rng.randn(n, 3)).astype(np.float32)
        pos4 = torch.as_tensor(np.concatenate(
            [pos, np.zeros((n, 1), np.float32)], axis=1))
        nl = htt.compute_nlist(pos4, r_cut, NN, [L, L, L], sorted=True,
                               return_types=True)
        sim.init_state(pos, [L, L, L])
        lab, _ = lj(sim.state, nl)
        nls.append(nl)
        p4s.append(pos4)
        labs.append(lab)
    return torch.stack(nls), torch.stack(p4s), torch.stack(labs), box


def test_sharded_grads_match_single_device():
    """With SGD(lr = 1), the update of the frame-sharded step (8 shards)
    is minus the gradient of the mean-over-frames loss on one device."""
    NN = 8
    model = TTrainableGraph(NN)
    nlist_b, pos4_b, labels_b, box = frames(n=32, NN=NN, seed=3)
    model([nlist_b[0], pos4_b[0], box])
    w0 = model.lj.w.detach().clone()
    with torch.enable_grad():
        loss = torch.stack([
            torch.mean((model([nl, p4, box], training=True)[0][:, :3] -
                        lab[:, :3]) ** 2)
            for nl, p4, lab in zip(nlist_b, pos4_b, labels_b)]).mean()
        (g_single,) = torch.autograd.grad(loss, [model.lj.w])
    opt = torch.optim.SGD(model.trainable_weights(), lr=1.0)
    step = sharded_train_step(model, opt, cpu_mesh(8))
    step(nlist_b, pos4_b, box, labels_b)
    g_sharded = w0 - model.lj.w.detach()
    torch.testing.assert_close(g_sharded, g_single, rtol=1e-4, atol=1e-6)


def test_sharded_training_loss_decreases():
    NN = 16
    model = TTrainableGraph(NN)
    nlist_b, pos4_b, labels_b, box = frames(NN=NN)
    model([nlist_b[0], pos4_b[0], box])
    with torch.no_grad():
        model.lj.w.copy_(torch.tensor([0.7, 1.2]))
    opt = torch.optim.Adam(model.trainable_weights(), lr=5e-2)
    step = sharded_train_step(model, opt, cpu_mesh(8))
    losses = [float(step(nlist_b, pos4_b, box, labels_b))
              for _ in range(30)]
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])
    with pytest.raises(ValueError, match="divisible"):
        step(nlist_b[:6], pos4_b[:6], box, labels_b[:6])


def test_data_parallel_grads_sums_shards():
    from hoomd_tf_tpu_torch.parallel import data_parallel_grads
    rng = np.random.RandomState(0)
    grads = [[torch.as_tensor(rng.randn(3, 2).astype(np.float32)),
              torch.as_tensor(rng.randn(4).astype(np.float32))]
             for _ in range(4)]
    got = data_parallel_grads(grads)
    for k in range(2):
        torch.testing.assert_close(got[k], sum(g[k] for g in grads))


def test_make_mesh():
    """The JAX signature: the first n devices of a list, one axis; with
    no card and no devices it raises."""
    m = make_mesh(3, axis="x", devices=[CPU] * 5)
    assert m.shape == {"x": 3} and m.devices == (CPU,) * 3
    assert m.axis_names == ("x",) and m.size == 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh()
    with pytest.raises(ValueError):
        htt.Simulation(mesh=m, device="cpu", shard_axis="d")
