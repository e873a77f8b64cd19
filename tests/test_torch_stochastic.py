"""The stochastic integrators of the port (Langevin by BAOAB, Brownian)
against the JAX package, and the port's noise: drawn from the
simulation's ``torch.Generator``, one draw per step, per particle (so a
particle's noise does not depend on the cell layout), and replayed when a
run is rolled back.

The two packages' generators give different numbers for any seed, so the
one-step comparisons hand both the same noise from a numpy seed: the test
replaces ``jax.random.normal`` (which ``hoomd_tf_tpu.md.integrators``
calls) and the port's draw (``hoomd_tf_tpu_torch.md.integrators._normal``)
for its duration; no file of the JAX package changes. Tolerances: one
step's positions and velocities rtol = atol = 1e-4 (float32, forces summed
in another order); trajectories of one seed 1e-5 (the same noise, forces
rounded alike up to summation order over 30 steps)."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hoomd_tf_tpu as htf
import hoomd_tf_tpu_torch as htt
from hoomd_tf_tpu_torch.interop import state_from_numpy
from hoomd_tf_tpu_torch.md import integrators as tint

from torch_helpers import fluid_arrays, jax_state, jax_state_numpy, np_


def shared_noise(monkeypatch, noise):
    """Both packages draw ``noise`` (numpy ``[N, 3]``) at every draw."""
    def jax_normal(key, shape, dtype=jnp.float32):
        assert tuple(shape) == noise.shape
        return jnp.asarray(noise, dtype=dtype)

    def port_normal(state, shape):
        assert tuple(shape) == noise.shape
        return torch.as_tensor(noise, dtype=state.positions.dtype)

    monkeypatch.setattr(jax.random, "normal", jax_normal)
    monkeypatch.setattr(tint, "_normal", port_normal)


@pytest.mark.parametrize("name", ["Langevin", "Brownian"])
def test_one_step_matches_jax_with_shared_noise(monkeypatch, name):
    """One step of a 256-particle LJ fluid on the dense build, the same
    state and the same noise in both packages."""
    n = 256
    pos, vel, lengths = fluid_arrays(n, 0.3, seed=5)
    noise = np.random.RandomState(9).randn(n, 3).astype(np.float32)
    shared_noise(monkeypatch, noise)
    js = jax_state(pos, vel, lengths)
    jsim = htf.Simulation(dt=0.005, integrator=getattr(htf.md, name)(
        kT=1.2, gamma=0.7))
    jsim.set_state(js)
    tsim = htt.Simulation(dt=0.005, integrator=getattr(htt.md, name)(
        kT=1.2, gamma=0.7), device="cpu")
    tsim.set_state(state_from_numpy(jax_state_numpy(js), device="cpu"))
    htf.tfcompute(htf.LJPotential(64)).attach(jsim, r_cut=2.5, nlist="n2")
    htt.tfcompute(htt.LJPotential(64)).attach(tsim, r_cut=2.5, nlist="n2")
    jsim.run(1)
    tsim.run(1)
    for f in ("positions", "velocities", "forces"):
        np.testing.assert_allclose(np_(getattr(tsim.state, f)),
                                   np_(getattr(jsim.state, f)),
                                   rtol=1e-4, atol=1e-4, err_msg=f)
    # the noise moved the state: without it the step differs
    assert np.abs(np_(tsim.state.positions) - pos).max() > 1e-4


def test_langevin_integrator_step_matches_jax(monkeypatch):
    """The integrator alone (B, A, O, A, then B with given forces) on the
    same arrays and noise, ghost-free: rtol = atol = 1e-5."""
    n = 64
    pos, vel, lengths = fluid_arrays(n, 0.3, seed=1)
    rng = np.random.RandomState(2)
    noise = rng.randn(n, 3).astype(np.float32)
    forces = rng.randn(n, 4).astype(np.float32)
    masses = rng.uniform(0.5, 2.0, n).astype(np.float32)
    shared_noise(monkeypatch, noise)
    import dataclasses
    js = dataclasses.replace(jax_state(pos, vel, lengths),
                             forces=jnp.asarray(forces),
                             masses=jnp.asarray(masses))
    ts = state_from_numpy(jax_state_numpy(js), device="cpu")
    ji, ti = htf.md.Langevin(kT=0.8, gamma=2.0), htt.md.Langevin(
        kT=0.8, gamma=2.0)
    js = ji.post_force(ji.pre_force(js, 0.01), 0.01)
    ts = ti.post_force(ti.pre_force(ts, 0.01), 0.01)
    for f in ("positions", "velocities"):
        np.testing.assert_allclose(np_(getattr(ts, f)),
                                   np_(getattr(js, f)), rtol=1e-5,
                                   atol=1e-5, err_msg=f)


def lj_pair():
    class P(htt.PairModel):
        def pair_energy(self, r2):
            u = 1.0 / r2
            s = u * u * u
            return 4.0 * (s * s - s)
    return P(64)


def langevin_sim(seed=3, n=512, mode="cellwise", capacity=None, kT=1.5):
    sim = htt.Simulation(dt=0.005, seed=seed, device="cpu",
                         integrator=htt.md.Langevin(kT=kT, gamma=1.0))
    sim.init_lattice(n, density=0.4, kT_init=kT)
    if mode == "n2":
        htt.tfcompute(htt.LJPotential(64)).attach(sim, r_cut=2.5,
                                                  nlist="n2")
    else:
        htt.tfcompute(lj_pair()).attach(
            sim, r_cut=2.5, nlist=htt.Cellwise(capacity=capacity)
            if capacity else "cellwise")
    return sim


def test_langevin_thermalizes():
    """Langevin at kT 1.5 from a cold (kT 0.2) start: the mean kinetic
    temperature of the last 200 of 600 steps lies within 10% of kT."""
    sim = langevin_sim(n=256, kT=1.5)
    sim.thermalize_velocities(0.2)
    sim.run(400)
    temps = []
    for _ in range(10):
        sim.run(20)
        temps.append(sim.thermo()["temperature"])
    assert abs(np.mean(temps) - 1.5) < 0.15, temps


def test_same_seed_same_trajectory_other_seed_not():
    a = langevin_sim(seed=3)
    b = langevin_sim(seed=3)
    c = langevin_sim(seed=4)
    for s in (a, b, c):
        s.run(30)
    np.testing.assert_array_equal(np_(a.state.positions),
                                  np_(b.state.positions))
    assert np.abs(np_(a.state.positions) - np_(c.state.positions)).max() \
        > 1e-2


def test_noise_is_per_particle():
    """The same seed on 'cellwise' (noise gathered into the slot rows of a
    layout that repacks) and on 'n2' (particle order): the same
    trajectory, up to the forces' summation order."""
    a = langevin_sim(seed=3)
    b = langevin_sim(seed=3, mode="n2")
    a.run(30)
    b.run(30)
    np.testing.assert_allclose(np_(a.state.positions),
                               np_(b.state.positions), rtol=0, atol=1e-5)


def test_rollback_replays_the_noise():
    """A run forced through a capacity-overflow rollback (capacity 3, then
    the replanned floor) draws the same noise as a run that needed none:
    the generator's state is restored with the simulation's."""
    a = langevin_sim(seed=3)
    b = langevin_sim(seed=3, capacity=3)
    a.run(30)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        b.run(30)
    assert any("capacity 3 exceeded" in str(x.message) for x in w)
    assert b._layout.plan.capacity > 3
    np.testing.assert_allclose(np_(a.state.positions),
                               np_(b.state.positions), rtol=0, atol=1e-5)


def test_brownian_moves_and_stays_finite():
    """Brownian dynamics at kT 1.5 (dt 2e-4: each step moves a particle
    by ~sqrt(2 kT dt / gamma) = 0.024 of noise, well inside LJ's core) on
    'cellwise', which repacks every step under it: finite positions, zero
    velocities, and the mean squared displacement per axis near the free
    diffusion's 2 kT dt steps / gamma = 0.12 after 200 steps."""
    sim = htt.Simulation(dt=2e-4, seed=1, device="cpu",
                         integrator=htt.md.Brownian(kT=1.5, gamma=1.0))
    sim.init_lattice(512, density=0.4)
    htt.tfcompute(lj_pair()).attach(sim, r_cut=2.5, nlist="cellwise")
    p0 = np_(sim.state.positions).copy()
    sim.run(200)
    p1 = np_(sim.state.positions)
    assert np.isfinite(p1).all()
    assert np.isfinite(np_(sim.state.forces)).all()
    d = p1 - p0
    L = np_(sim.state.box[1] - sim.state.box[0])
    d = d - np.round(d / L) * L
    assert 0.05 < float(np.mean(d * d)) < 0.25
    assert float(sim.state.velocities.abs().max()) == 0.0
