"""Port vs JAX package: one step of NVE, NVT and Minimize on the same
numpy state, including the overflow guards (an infinite instantaneous
temperature in NVT; clamped-overlap forces of 1e27 in Minimize).
Tolerance: 1e-6 relative plus 1e-6 absolute (float32 kinetic sums may be
taken in another order)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import hoomd_tf_tpu as htf
import hoomd_tf_tpu_torch as htt

from torch_helpers import fluid_arrays, jax_state, np_, torch_state

TOL = dict(rtol=1e-6, atol=1e-6)


def states(forces_scale=5.0, velocity_scale=1.0, seed=0):
    pos, vel, lengths = fluid_arrays(64, 0.3, seed)
    # a few particles just inside the box edge, so the drift wraps them
    pos[:4, 0] = np.float32(lengths[0] / 2 - 1e-3)
    vel = (vel * velocity_scale).astype(np.float32)
    rng = np.random.RandomState(seed + 1)
    f = (forces_scale * rng.normal(size=(64, 4))).astype(np.float32)
    js = dataclasses.replace(jax_state(pos, vel, lengths),
                             forces=jnp.asarray(f))
    ts = torch_state(pos, vel, lengths)
    ts.forces = torch.as_tensor(f)
    return js, ts


def integrators(name):
    if name == "nve":
        return htf.md.NVE(), htt.md.NVE()
    if name == "nvt":
        return htf.md.NVT(kT=1.2, tau=0.5), htt.md.NVT(kT=1.2, tau=0.5)
    return (htf.md.Minimize(max_disp=0.05), htt.md.Minimize(max_disp=0.05))


def assert_states_close(ts, js):
    for f in ("positions", "velocities"):
        np.testing.assert_allclose(np_(getattr(ts, f)),
                                   np_(getattr(js, f)), err_msg=f, **TOL)
    for k, v in (js.thermostat or {}).items():
        np.testing.assert_allclose(np_(ts.thermostat[k]), np_(v),
                                   err_msg=k, **TOL)


@pytest.mark.parametrize("name", ["nve", "nvt", "minimize"])
def test_one_step_matches_jax(name):
    js, ts = states()
    ji, ti = integrators(name)
    js = dataclasses.replace(js, thermostat=ji.init(js))
    ts.thermostat = ti.init(ts)
    dt = 0.005
    js, ts = ji.pre_force(js, dt), ti.pre_force(ts, dt)
    assert_states_close(ts, js)
    js, ts = ji.post_force(js, dt), ti.post_force(ts, dt)
    assert_states_close(ts, js)


def test_nvt_inf_temperature_guard():
    """A kinetic sum past float32 max must not latch xi at inf: the
    thermostat keeps finite velocities and xi, as in JAX."""
    js, ts = states(velocity_scale=1e19)
    ji, ti = integrators("nvt")
    js = dataclasses.replace(js, thermostat=ji.init(js))
    ts.thermostat = ti.init(ts)
    js, ts = ji.pre_force(js, 0.005), ti.pre_force(ts, 0.005)
    xi = float(ts.thermostat["xi"])
    assert np.isfinite(xi) and xi == pytest.approx(float(js.thermostat["xi"]))
    assert torch.isfinite(ts.velocities).all()
    assert_states_close(ts, js)


def test_minimize_overflow_guard():
    """Clamped-overlap forces (~1e27, whose square overflows float32) and
    non-finite entries still give a capped, finite displacement."""
    js, ts = states(forces_scale=1e27)
    f = np_(ts.forces).copy()
    f[5, 1] = np.inf
    f[6, 2] = np.nan
    js = dataclasses.replace(js, forces=jnp.asarray(f))
    ts.forces = torch.as_tensor(f)
    before = np_(ts.positions).copy()
    ji, ti = integrators("minimize")
    js, ts = ji.post_force(js, 0.005), ti.post_force(ts, 0.005)
    assert torch.isfinite(ts.positions).all()
    assert_states_close(ts, js)
    d = np_(ts.positions) - before
    L = np_(htt.box_size(ts.box))
    d = d - np.round(d / L) * L
    assert np.linalg.norm(d, axis=1).max() <= 0.05 + 1e-6
