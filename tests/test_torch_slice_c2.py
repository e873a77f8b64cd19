"""Slice C2 as a whole against the JAX package: the ready-made generic
potentials attached with ``nlist='cellwise'`` (the lane-separability
probe, then the synthesized pair function on the analytic route) and with
``nlist='direct'`` (the model on the candidate planes), from the same
state under NVT. One-step forces at the JAX package's bar for its
cellwise path (rtol 2e-4, atol 2e-5 times the largest force); a 5-step
trajectory at its trajectory bar (positions atol 2e-3 modulo the box,
velocities rtol 1e-2, atol 2e-3): a different float32 summation order
grows chaotically, so only short runs are compared (docs/testing.md)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import hoomd_tf_tpu as htf
import hoomd_tf_tpu_torch as htt
from hoomd_tf_tpu_torch.interop import (build_model, load_jax_variables,
                                        state_from_numpy)

from torch_helpers import (fluid_arrays, jax_state, jax_state_numpy, np_,
                           seed_jax_weights)

NN = 64


def _models(kind):
    if kind == "lj":
        return htf.LJPotential(NN), htt.LJPotential(NN)
    kw = dict(hidden=8, layers=1, count=8)
    jm = htf.NeuralPairPotential(NN, **kw)
    jm.ensure_built([jnp.zeros((1, NN, 4)), jnp.zeros((1, 4)),
                     jnp.zeros((3, 3))])
    seed_jax_weights(jm, seed=7)
    tm = build_model(htt.NeuralPairPotential(NN, **kw), 2.5, device="cpu")
    load_jax_variables(tm, jm.get_weights())
    return jm, tm


def _sims(kind, mode, n=300, seed=1):
    pos, vel, lengths = fluid_arrays(n, 0.3, seed, kT=1.2)
    js = jax_state(pos, vel, lengths)
    jsim = htf.Simulation(dt=0.005, integrator=htf.md.NVT(kT=1.2, tau=0.5),
                          seed=seed)
    jsim.set_state(js)
    tsim = htt.Simulation(dt=0.005, integrator=htt.md.NVT(kT=1.2, tau=0.5),
                          seed=seed, device="cpu")
    tsim.set_state(state_from_numpy(jax_state_numpy(js), device="cpu"))
    jm, tm = _models(kind)
    jt, tt = htf.tfcompute(jm), htt.tfcompute(tm)
    jt.attach(jsim, r_cut=2.5, nlist=mode)
    tt.attach(tsim, r_cut=2.5, nlist=mode)
    return (jsim, jt), (tsim, tt)


def _wrapped_close(a, b, lengths, atol):
    d = np_(a) - np_(b)
    L = np.asarray(lengths)
    d = d - np.round(d / L) * L
    np.testing.assert_allclose(d, 0.0, atol=atol)


@pytest.mark.parametrize("kind", ["lj", "nn"])
@pytest.mark.parametrize("mode", ["cellwise", "direct"])
def test_potential_runs_like_jax(kind, mode):
    (jsim, jt), (tsim, tt) = _sims(kind, mode)
    jsim.run(1)
    tsim.run(1)
    fj, ft = np_(jsim.state.forces), np_(tsim.state.forces)
    scale = np.abs(fj[:, :3]).max()
    assert scale > 1e-3
    np.testing.assert_allclose(ft, fj, rtol=2e-4, atol=2e-5 * scale)
    if mode == "cellwise":
        assert tt._lane_fast_ok is True
        assert bool(jt._lane_fast_ok) is True
    else:
        assert tsim._packed_build().method == "direct"
    jsim.run(4)
    tsim.run(4)
    _wrapped_close(tsim.state.positions, jsim.state.positions,
                   tsim._lengths, atol=2e-3)
    np.testing.assert_allclose(np_(tsim.state.velocities),
                               np_(jsim.state.velocities), rtol=1e-2,
                               atol=2e-3)
    assert tsim.state.step == 5


def test_direct_nlist_array_is_the_planes():
    """get_nlist_array in the direct mode: the stacked planes, each
    particle's neighbors within the cut once."""
    (_, _), (tsim, tt) = _sims("lj", "direct", n=200)
    nl = tt.get_nlist_array()
    grid, cap = tsim._packed_build().plan
    assert nl.shape == (200, 27 * cap, 4)
    r = np.linalg.norm(nl[..., :3], axis=-1)
    assert r.max() <= 2.5 + 1e-6 and (r > 0).sum(1).min() > 0


def test_direct_overflow_self_heals():
    """A capacity too small for the direct mode's cells: the run rolls
    back, re-plans with a larger capacity and ends as a clean run does."""
    (_, _), (a, _) = _sims("lj", "direct", n=200)
    (_, _), (b, _) = _sims("lj", "direct", n=200)
    b._cl_capacity_floor = 0
    orig = b._make_nlist_build

    def small_first(*args):
        build = orig(*args)
        if not getattr(b, "_shrunk", False):
            b._shrunk = True
            build.capacity = 2
        return build

    b._make_nlist_build = small_first
    with pytest.warns(UserWarning, match="capacity"):
        b.run(3)
    a.run(3)
    assert b._packed_build().capacity > 2
    np.testing.assert_allclose(np_(b.state.positions),
                               np_(a.state.positions), rtol=0, atol=1e-6)


def test_generic_simmodel_on_planes_route_matches_packed():
    """A model the probe rejects (energy quadratic in the lane sum) runs
    on the cellwise planes route: the same trajectory as on the packed
    cell list."""

    class CrossLane(htt.SimModel):
        def compute(self, nlist, positions, box):
            s = torch.sum(htt.nlist_rinv(nlist) ** 6, dim=1)
            return htt.compute_nlist_forces(nlist, 0.01 * s * s)

    out = {}
    for mode in ("cellwise", "cell"):
        sim = htt.Simulation(dt=0.005, integrator=htt.md.NVE(), seed=3,
                             device="cpu")
        sim.init_lattice(200, density=0.3, kT_init=1.0)
        tfc = htt.tfcompute(CrossLane(48))
        tfc.attach(sim, r_cut=2.5, nlist=mode)
        sim.run(5)
        out[mode] = sim.state
        if mode == "cellwise":
            assert tfc._lane_fast_ok is False
    _wrapped_close(out["cellwise"].positions, out["cell"].positions,
                   sim._lengths, atol=2e-3)


def test_lane_budget_overflow_self_heals():
    """K1's generic-form list too short in the step loop: the run rolls
    back and re-runs with a list sized from the lanes it needed, ending
    as a clean run does (the generic form's plain version, on the CPU
    with stencil='kernel')."""
    runs = []
    for short in (False, True):
        sim = htt.Simulation(dt=0.005, integrator=htt.md.NVE(), seed=3,
                             device="cpu")
        sim.init_lattice(200, density=0.3, kT_init=1.0)
        sim.stencil = "kernel"
        tfc = htt.tfcompute(htt.LJPotential(48))
        tfc.attach(sim, r_cut=2.5, nlist="cellwise")
        sim.run(1)
        assert tfc._lane_fast_ok is True
        if short:
            sim._lanes.budget = 10
            with pytest.warns(UserWarning, match="too short"):
                sim.run(3)
            assert sim._lanes.budget > 10 and \
                not bool(sim._lanes.overflow())
        else:
            sim.run(3)
        runs.append(sim.state)
    np.testing.assert_allclose(np_(runs[1].positions),
                               np_(runs[0].positions), rtol=0, atol=1e-6)
    assert runs[1].step == runs[0].step == 4
