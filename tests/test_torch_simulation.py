"""The port's main path as a whole against the JAX package: the same
starting state (carried across with ``interop.state_from_numpy``) through
``Simulation.run`` with a PairModel on ``nlist='cellwise'``.

Tolerances are the JAX package's own for its cellwise path against the
dense one (tests/test_cellwise.py): one-step forces rtol 2e-4, atol 2e-5;
a 15-step NVE trajectory positions atol 2e-3 (modulo the box) and
velocities rtol 1e-2, atol 2e-3 -- a different float32 summation order
grows chaotically, so trajectories are compared over short runs only."""

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import hoomd_tf_tpu as htf
import hoomd_tf_tpu_torch as htt
from hoomd_tf_tpu_torch.interop import (build_model, load_jax_variables,
                                        state_from_numpy)
from hoomd_tf_tpu_torch.ops import cellwise_cuda as tcc

from torch_helpers import (fluid_arrays, jax_state, jax_state_numpy,
                           nn_pair_class, np_)


class JLJ(htf.PairModel):
    def pair_energy(self, r2):
        u = 1.0 / r2
        sr6 = u * u * u
        return 4.0 * (sr6 * sr6 - sr6)

    def pair_energy_and_slope(self, r2):
        u = 1.0 / r2
        sr6 = u * u * u
        return (4.0 * (sr6 * sr6 - sr6),
                -12.0 * (2.0 * sr6 - 1.0) * sr6 * u)


class TLJ(htt.PairModel):
    def pair_energy(self, r2):
        return self.pair_energy_and_slope(r2)[0]

    def pair_energy_and_slope(self, r2):
        u = 1.0 / r2
        sr6 = u * u * u
        return (4.0 * (sr6 * sr6 - sr6),
                -12.0 * (2.0 * sr6 - 1.0) * sr6 * u)

    def pair_kernel_form(self):
        return htt.md.LennardJones(1.0, 1.0, r_cut=np.inf)


def pair_sims(n=256, density=0.25, seed=0, kT=1.0, jax_nlist="cellwise",
              r_cut=3.0, skin=None):
    """A JAX and a port simulation (NVE) from the same starting state; the
    port runs the cellwise mode, JAX runs ``jax_nlist``."""
    pos, vel, lengths = fluid_arrays(n, density, seed, kT=kT)
    js = jax_state(pos, vel, lengths)
    jsim = htf.Simulation(dt=0.005, integrator=htf.md.NVE(), seed=seed)
    jsim.set_state(js)
    tsim = htt.Simulation(dt=0.005, integrator=htt.md.NVE(), seed=seed,
                          device="cpu")
    tsim.set_state(state_from_numpy(jax_state_numpy(js), device="cpu"))
    jcfg = htf.Cellwise(skin=skin) if skin and \
        jax_nlist == "cellwise" else jax_nlist
    tcfg = htt.Cellwise(skin=skin) if skin else "cellwise"
    htf.tfcompute(JLJ(64)).attach(jsim, r_cut=r_cut, nlist=jcfg)
    htt.tfcompute(TLJ(64)).attach(tsim, r_cut=r_cut, nlist=tcfg)
    return jsim, tsim


def assert_wrapped_close(a, b, lengths, atol):
    d = np_(a) - np_(b)
    L = np.asarray(lengths)
    d = d - np.round(d / L) * L
    np.testing.assert_allclose(d, np.zeros_like(d), atol=atol)


def test_one_step_forces_match_jax():
    jsim, tsim = pair_sims()
    jsim.run(1)
    tsim.run(1)
    np.testing.assert_allclose(np_(tsim.state.forces),
                               np_(jsim.state.forces), rtol=2e-4,
                               atol=2e-5)
    assert tsim.state.step == 1
    th_t, th_j = tsim.thermo(), jsim.thermo()
    for k in ("kinetic_energy", "potential_energy", "temperature"):
        assert th_t[k] == pytest.approx(th_j[k], rel=1e-4), k


def test_nve_trajectory_with_rebuilds_matches_jax():
    """15 NVE steps with the port's repack interval pinned to 5 (two
    mid-run rebuilds) against the JAX package's dense O(N^2) path, the
    exact oracle its own cellwise test uses. (The JAX cellwise path itself
    is off here by ~6e-3 in velocity: its repack leaves the carried
    forces in the old slot order for the next half-kick -- ROADMAP.md
    Queue 3. The port moves them with their particles.)"""
    jsim, tsim = pair_sims(kT=0.8, seed=3, r_cut=2.5, skin=0.3,
                           jax_nlist="n2")
    tsim._choose_repack_interval = lambda layout: 5
    jsim.run(15)
    tsim.run(15)
    assert_wrapped_close(tsim.state.positions, jsim.state.positions,
                         tsim._lengths, atol=2e-3)
    np.testing.assert_allclose(np_(tsim.state.velocities),
                               np_(jsim.state.velocities), rtol=1e-2,
                               atol=2e-3)


def bench_like(n=512, device="cpu", capacity=None):
    """The benchmark protocol's start: a jittered lattice at density 0.4
    under a Minimize quench, LJ PairModel on the cellwise mode."""
    sim = htt.Simulation(dt=0.005, integrator=htt.md.Minimize(0.05),
                         seed=0, device=device)
    sim.init_lattice(n, density=0.4, kT_init=1.5)
    rng = np.random.RandomState(0)
    sim.state.positions = sim.state.positions + torch.as_tensor(
        0.3 * rng.randn(n, 3).astype(np.float32), device=device)
    nlist = htt.Cellwise(capacity=capacity) if capacity else "cellwise"
    tfc = htt.tfcompute(TLJ(64))
    tfc.attach(sim, r_cut=3.0, nlist=nlist)
    return sim, tfc


def test_quench_then_nvt_stays_finite():
    sim, tfc = bench_like()
    sim.run(40)
    sim.thermalize_velocities(1.5)
    sim.integrator = htt.md.NVT(kT=1.5, tau=0.5)
    sim.run(150)
    assert np.isfinite(tfc.get_positions_array()).all()
    f = tfc.get_forces_array()
    assert f.shape == (512, 4) and np.isfinite(f).all()
    assert 0.8 < sim.thermo()["temperature"] < 2.5
    # every force evaluation of the run went through the analytic route
    assert sim.force_evals == 40 + 1 + 150 + 1


@pytest.mark.parametrize("auto_replan", [True, False])
def test_capacity_overflow(auto_replan):
    """An undersized capacity rolls the run back and replans with a
    raised floor (self-heal); with auto_replan off it is an error."""
    sim, tfc = bench_like(n=256, capacity=4)
    sim.auto_replan = auto_replan
    start = sim.state
    if not auto_replan:
        with pytest.raises(ValueError, match="capacity"):
            sim.run(5)
        return
    with pytest.warns(UserWarning, match="capacity 4 exceeded"):
        sim.run(5)
    assert sim._layout.plan.capacity >= sim._capacity_floor > 4
    assert sim.state is not start and sim.state.step == 5
    assert np.isfinite(tfc.get_forces_array()).all()


def test_staleness_rolls_back():
    """A repack interval far beyond the Verlet bound sets the staleness
    bit: the attempt is rolled back (nothing committed) and the interval
    capped one grid notch lower."""
    sim, _ = bench_like(n=256)
    sim.run(30)                           # quench the overlaps first
    sim.thermalize_velocities(3.0)
    sim.integrator = htt.md.NVE()
    sim._vmax_now = lambda: 1e-4          # the interval estimate lies
    start = sim.state
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ok = sim._run_once(200, allow_retry=True)
    assert ok is False and sim.state is start and start.step == 30
    assert sim._static_K_cap == 96


def test_kernel_stencil_through_the_engine():
    """stencil='kernel' runs the engine through the K1 wrapper (its plain
    version on the CPU: no launch) and follows the full tensor form."""
    runs = []
    for stencil in ("kernel", "full"):
        sim, _ = bench_like(n=256)
        sim.stencil = stencil
        sim.run(10)
        runs.append(sim)
    assert tcc.half_stencil_pair_forces.launches == 0
    assert runs[0]._layout.plan.capacity >= 1
    assert_wrapped_close(runs[0].state.positions, runs[1].state.positions,
                         runs[0]._lengths, atol=2e-3)


class _TGeneric(htt.SimModel):
    def compute(self, nlist):
        return htt.compute_nlist_forces(
            nlist, torch.sum(htt.nlist_rinv(nlist), dim=1))


@pytest.mark.parametrize("case", ["nlist", "train", "simmodel", "proxy"])
def test_attach_rejects_unported(case):
    """What later slices bring: the wide-direct neighbor mode, training a
    PairModel without the Chebyshev proxy (the non-proxy NN row), a
    generic SimModel on the cellwise route, and the period / batch knobs
    of proxy training."""
    sim, _ = bench_like(n=256)
    with pytest.raises(NotImplementedError):
        if case == "nlist":
            htt.tfcompute(TLJ(64)).attach(sim, r_cut=3.0, nlist="direct")
        elif case == "train":
            htt.tfcompute(TLJ(64)).attach(sim, r_cut=3.0, nlist="cellwise",
                                          train=True)
        elif case == "simmodel":
            htt.tfcompute(_TGeneric(16)).attach(sim, r_cut=3.0,
                                                nlist="cellwise")
        else:
            model = TLJ(64, proxy_degree=8)
            model.compile(loss="mse")
            htt.tfcompute(model).attach(sim, r_cut=3.0, nlist="cellwise",
                                        train=True, period=2)


def _nn():
    return nn_pair_class()(16, proxy_degree=8)


def _typed_proxy(**kw):
    from hoomd_tf_tpu_torch.ops.chebyshev import make_typed_pair_proxy
    fit, _ = make_typed_pair_proxy(8, 0.4, 6.25, 2, **kw)
    return fit(lambda r2, ti, tj: 1.0 / (r2 * (1.0 + ti + tj)))["c"]


def _slot_layout(**kw):
    from hoomd_tf_tpu_torch.md.slots import SlotLayout
    from hoomd_tf_tpu_torch.ops import cellwise as tcw
    plan = tcw.CellwisePlan((3, 3, 3), 4, (9.0, 9.0, 9.0), 2.5)
    return SlotLayout(plan, 64, (-4.5, -4.5, -4.5), rc_matrix=[[2.5]],
                      **kw).rc2_tab


def _state_arrays():
    pos, vel, lengths = fluid_arrays(64, 0.3, seed=4)
    return dict(positions=pos, velocities=vel, types=np.zeros(64, np.int32),
                masses=np.ones(64, np.float32),
                box=np.stack([-lengths / 2, lengths / 2, np.zeros(3)]))


# every public entry point that makes tensors, each returning one of them
DEVICE_ENTRIES = {
    "Simulation": lambda **kw: htt.Simulation(**kw).generator,
    "init_state": lambda **kw: htt.md.state.init_state(
        *fluid_arrays(64, 0.3)[::2], **kw).positions,
    "state_from_numpy": lambda **kw: state_from_numpy(
        _state_arrays(), **kw).positions,
    "SlotLayout": _slot_layout,
    "make_box": lambda **kw: htt.ops.make_box([-1, -2, -3], [1, 2, 3],
                                              **kw),
    "box_from_lengths": lambda **kw: htt.ops.box_from_lengths(
        [4.0, 5.0, 6.0], **kw),
    "make_typed_pair_proxy": _typed_proxy,
    "build_model": lambda **kw: build_model(
        _nn(), 2.5, **kw).variables[-1],
    "proxy_pair_fn": lambda **kw: _nn().proxy_pair_fn(2.5, **kw)(
        torch.ones(3, device=kw.get("device")))[0],
    "pair_kernel_form": lambda **kw: _nn().pair_kernel_form(
        2.5, **kw).table,
    "compute_nlist": lambda **kw: htt.compute_nlist(
        fluid_arrays(64, 0.3)[0], 3.0, 8, [6.0] * 3, **kw),
    "cell_list_nlist": lambda **kw: htt.cell_list_nlist(
        np.concatenate([fluid_arrays(64, 0.3)[0], np.zeros((64, 1))], 1),
        3.0, 8, [9.5] * 3, **kw),
    "divide_no_nan": lambda **kw: htt.divide_no_nan([1.0, 2.0], [0.0, 4.0],
                                                    **kw),
    "multiply_no_nan": lambda **kw: htt.multiply_no_nan(1.0, [0.0, 4.0],
                                                        **kw),
}


@pytest.mark.parametrize("entry", sorted(DEVICE_ENTRIES))
def test_default_device_is_the_card(entry):
    """Every entry point runs on the CUDA card unless the caller asks for
    the CPU; with no card it raises instead of falling back."""
    make = DEVICE_ENTRIES[entry]
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    assert make(device="cpu").device.type == "cpu"


def test_state_from_numpy_roundtrip():
    pos, vel, lengths = fluid_arrays(64, 0.3, seed=4)
    js = jax_state(pos, vel, lengths, types=np.arange(64) % 2)
    ts = state_from_numpy(jax_state_numpy(js), device="cpu")
    for f in ("positions", "velocities", "types", "masses", "box",
              "forces", "virial"):
        np.testing.assert_array_equal(np_(getattr(ts, f)),
                                      np_(getattr(js, f)), err_msg=f)
    assert ts.types.dtype == torch.int32 and ts.step == 0


def test_load_jax_variables():
    """A model with a trainable weight: the JAX model's variables copied
    into the port's module give the same pair function and forces."""
    class JEps(htf.PairModel):
        def setup(self):
            self.log_eps = self.add_weight(shape=(), initializer=0.0)

        def pair_energy(self, r2):
            u = 1.0 / r2
            sr6 = u * u * u
            return 4.0 * jnp.exp(self.log_eps.value) * (sr6 * sr6 - sr6)

    class TEps(htt.PairModel):
        def setup(self):
            self.log_eps = self.add_weight(shape=(), initializer=0.0)

        def pair_energy(self, r2):
            u = 1.0 / r2
            sr6 = u * u * u
            return 4.0 * torch.exp(self.log_eps) * (sr6 * sr6 - sr6)

    jm, tm = JEps(16), TEps(16)
    jm.log_eps.assign(jnp.float32(np.log(0.7)))
    assert len(tm.variables) == len(jm.variables) == 3
    load_jax_variables(tm, jm.get_weights())
    for a, b in zip(tm.get_weights(), jm.get_weights()):
        np.testing.assert_array_equal(a, b)
    assert tm.log_eps.requires_grad
    r2 = np.linspace(0.8, 8.0, 97, dtype=np.float32)
    U_j, dU_j = jm.pair_energy_and_slope(jnp.asarray(r2))
    U_t, dU_t = tm.pair_energy_and_slope(torch.as_tensor(r2))
    np.testing.assert_allclose(np_(U_t), np_(U_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np_(dU_t), np_(dU_j), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        load_jax_variables(tm, jm.get_weights()[:2])
