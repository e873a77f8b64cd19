"""NPT (Nose-Hoover plus the Berendsen barostat) in the port: one step
against the JAX package, the dynamic-box slot layout against the dense
build, the static repack schedule under a barostat, the geometry guard
and the refusals (the JAX package's tests/test_md.py::TestNPT, at small
sizes).

Tolerances: one step rtol = atol = 1e-4 (float32; the two packages sum
the forces in another order); 'cellwise' against 'n2' over 20 steps the
JAX test's bars (box rtol 1e-5, positions 2e-4 modulo the box)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import hoomd_tf_tpu as htf
import hoomd_tf_tpu_torch as htt
from hoomd_tf_tpu_torch.interop import state_from_numpy

from torch_helpers import jax_state_numpy, np_


def jittered(sim, n, seed=7):
    """The lattice state of ``sim`` moved by a seeded jitter of 0.05."""
    rng = np.random.RandomState(seed)
    d = (0.05 * rng.uniform(-1, 1, (n, 3))).astype(np.float32)
    return d


def port_npt(mode, n=512, r_cut=2.0, steps=20, P=0.5):
    sim = htt.Simulation(dt=0.002, seed=7, device="cpu",
                         integrator=htt.md.NPT(kT=0.9, tau=0.5, P=P,
                                               tauP=0.5))
    sim.init_lattice(n, density=0.4, kT_init=0.9)
    sim.state.positions = sim.state.positions + torch.as_tensor(
        jittered(sim, n))
    tfc = htt.tfcompute(htt.LJPotential(48, virial=True))
    tfc.attach(sim, r_cut=r_cut, nlist=mode)
    sim.run(steps)
    return sim


def test_one_step_matches_jax():
    """One NPT step (built-in LJ, the dynamic-box 'cellwise' layout in
    both packages) from the same state: positions, box and virial."""
    n = 512
    jsim = htf.Simulation(dt=0.002, seed=7, integrator=htf.md.NPT(
        kT=0.9, tau=0.5, P=0.5, tauP=0.5))
    jsim.init_lattice(n, density=0.4, kT_init=0.9)
    jsim.state = dataclasses.replace(
        jsim.state, positions=jsim.state.positions + jnp.asarray(
            jittered(jsim, n)))
    tsim = htt.Simulation(dt=0.002, seed=7, device="cpu",
                          integrator=htt.md.NPT(kT=0.9, tau=0.5, P=0.5,
                                                tauP=0.5))
    tsim.set_state(state_from_numpy(jax_state_numpy(jsim.state),
                                    device="cpu"))
    box0 = np_(tsim.state.box).copy()
    for sim, m in ((jsim, htf), (tsim, htt)):
        sim.add_force(m.md.LennardJones(r_cut=2.5))
        sim.run(1)
    assert tsim._layout.dynamic_box and jsim._layout.dynamic_box
    assert tsim._layout.plan.grid == jsim._layout.plan.grid
    assert tsim._layout.plan.capacity == jsim._layout.plan.capacity
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np_(tsim.state.box), np_(jsim.state.box),
                               **tol)
    np.testing.assert_allclose(np_(tsim.state.positions),
                               np_(jsim.state.positions), **tol)
    np.testing.assert_allclose(np_(tsim.state.virial),
                               np_(jsim.state.virial), **tol)
    # the barostat moved the box
    assert np.abs(np_(tsim.state.box) - box0).max() > 1e-6


def test_barostat_step_matches_jax():
    """NPT's post_force alone on the same arrays (forces, virial, box):
    the thermostat half, the pressure from the virial, the clamped
    isotropic rescale of box and positions, at rtol = atol = 1e-6."""
    n = 64
    rng = np.random.RandomState(3)
    L = np.float32(5.0)
    pos = rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
    js = htf.md.state.init_state(pos, np.array([L, L, L]),
                                 velocities=rng.randn(n, 3).astype(
                                     np.float32))
    js = dataclasses.replace(
        js, forces=jnp.asarray(rng.randn(n, 4).astype(np.float32)),
        virial=jnp.asarray(rng.randn(n, 3, 3).astype(np.float32)))
    ji = htf.md.NPT(kT=1.0, tau=0.5, P=2.0, tauP=0.7, kappa=1.3)
    js = dataclasses.replace(js, thermostat=ji.init(js))
    ts = state_from_numpy(jax_state_numpy(js), device="cpu")
    ti = htt.md.NPT(kT=1.0, tau=0.5, P=2.0, tauP=0.7, kappa=1.3)
    js, ts = ji.post_force(js, 0.005), ti.post_force(ts, 0.005)
    for f in ("positions", "velocities", "box"):
        np.testing.assert_allclose(np_(getattr(ts, f)),
                                   np_(getattr(js, f)), rtol=1e-6,
                                   atol=1e-6, err_msg=f)
    assert not np.allclose(np_(ts.box)[1], L / 2)


def test_cellwise_matches_dense():
    """NPT through the dynamic slot layout (geometry from the current box
    each step, K1's tensor form on the CPU) reproduces the dense build's
    trajectory and box over 20 steps."""
    cw = port_npt("cellwise")
    n2 = port_npt("n2")
    assert cw._layout is not None and cw._layout.dynamic_box
    box_cw = np_(htt.box_size(cw.state.box))
    box_n2 = np_(htt.box_size(n2.state.box))
    np.testing.assert_allclose(box_cw, box_n2, rtol=1e-5)
    d = np_(cw.state.positions) - np_(n2.state.positions)
    d = d - np.round(d / box_n2) * box_n2
    np.testing.assert_allclose(d, np.zeros_like(d), atol=2e-4)
    # the box moved from the lattice's (512 / 0.4) ** (1 / 3)
    assert np.abs(box_cw - (512 / 0.4) ** (1 / 3)).max() > 1e-4


def test_static_repack_schedule_engages():
    """The dynamic-box layout rides the static repack schedule, K bounded
    from the live box, and the live box reaches the host in the run's one
    readback (no extra fetch at the next boundary)."""
    sim = port_npt("cellwise", steps=25)
    assert sim._layout.dynamic_box
    assert sim._static_K_last is not None and sim._static_K_last >= 1
    assert sim._box_host[0] is sim.state.box
    np.testing.assert_allclose(sim._box_host[1], np_(sim.state.box),
                               rtol=0, atol=0)
    assert np.isfinite(np_(sim.state.positions)).all()


def test_overcompression_raises_and_rolls_back():
    """A box crushed past the static grid's reach (min(edge) < r_cut) is
    the overflow error, not silent wrong forces; the run is rolled back."""
    sim = htt.Simulation(dt=0.002, seed=8, device="cpu",
                         integrator=htt.md.NPT(kT=0.9, tau=0.5, P=0.5,
                                               tauP=0.5))
    sim.init_lattice(512, density=0.4, kT_init=0.9)
    htt.tfcompute(htt.LJPotential(48, virial=True)).attach(
        sim, r_cut=2.0, nlist="cellwise")
    sim.run(2)
    s = sim.state
    center = 0.5 * (s.box[0] + s.box[1])
    mu = 0.5
    crushed = dataclasses.replace(
        s, positions=center + mu * (s.positions - center),
        box=torch.stack([center + mu * (s.box[0] - center),
                         center + mu * (s.box[1] - center), s.box[2]]))
    sim.state = crushed
    with pytest.raises(ValueError, match="apacity"):
        sim.run(2)
    assert sim.state is crushed and sim.state.step == 2
    assert sim._layout.geometry_bad(crushed)


def test_auto_falls_back_to_dense():
    sim = htt.Simulation(dt=0.002, device="cpu", integrator=htt.md.NPT(
        kT=0.9, tau=0.5, P=0.5))
    sim.init_lattice(64, density=0.4, kT_init=0.9)
    htt.tfcompute(htt.LJPotential(24, virial=True)).attach(sim, r_cut=2.5)
    sim.run(5)
    assert sim._packed_build().method == "n2"
    assert np.isfinite(np_(sim.state.positions)).all()


@pytest.mark.parametrize("mode", ["cell", "direct", "pallas"])
def test_static_geometry_modes_raise(mode):
    sim = htt.Simulation(dt=0.002, device="cpu", integrator=htt.md.NPT(
        kT=0.9, tau=0.5, P=0.5))
    sim.init_lattice(216, density=0.4, kT_init=0.9)
    htt.tfcompute(htt.LJPotential(24, virial=True)).attach(
        sim, r_cut=2.5, nlist=mode)
    with pytest.raises(ValueError, match="n2"):
        sim.run(2)


def test_pressure_approaches_target():
    """The JAX test's protocol (64 particles, 'n2', a virial-returning
    model): the barostat pulls the pressure towards P = 0.5 and the
    volume responds."""
    n = 64
    sim = htt.Simulation(dt=0.002, seed=5, device="cpu",
                         integrator=htt.md.NPT(kT=0.9, tau=0.5, P=0.5,
                                               tauP=0.5))
    sim.init_lattice(n, density=0.5, kT_init=0.9)
    htt.tfcompute(htt.LJPotential(n - 1, virial=True)).attach(
        sim, r_cut=2.5, nlist="n2")
    vol0 = float(torch.prod(htt.box_size(sim.state.box)))
    sim.run(150)
    ps = []
    for _ in range(15):
        sim.run(10)
        ps.append(sim.thermo()["pressure"])
    vol1 = float(torch.prod(htt.box_size(sim.state.box)))
    assert abs(float(np.mean(ps)) - 0.5) < 0.4, ps
    assert abs(vol1 - vol0) > 1e-3
