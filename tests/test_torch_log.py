"""``Simulation.run(n, log_period=k)`` and ``sim.log``, port against the
JAX package: the keys and the logged steps, accumulation across runs
(tests/test_md.py:295-309), the values on the packed and the cellwise
routes, and a rolled-back attempt, which commits no rows.

Tolerances: the logged values at rtol 1e-4 against the JAX package over
20 steps (atol 1e-6 for the pressure of a near-ideal gas); a log row
against ``sim.thermo()`` of the same state at rtol 1e-6; a run through
a rollback against a clean run at rtol 1e-5."""

import warnings

import numpy as np
import pytest
import torch

import hoomd_tf_tpu as htf
import hoomd_tf_tpu_torch as htt
from hoomd_tf_tpu_torch.interop import state_from_numpy

from torch_helpers import fluid_arrays, jax_state, jax_state_numpy
from test_torch_layers import TMeanModel
from test_torch_simulation import JLJ, TLJ

KEYS = {"kinetic_energy", "potential_energy", "temperature", "pressure",
        "step"}


class JLJModel(htf.SimModel):
    def compute(self, nlist, positions, box):
        rinv = htf.nlist_rinv(nlist)
        r6 = rinv ** 6
        return htf.compute_nlist_forces(
            nlist, (2.0 * (r6 * r6 - r6)).sum(axis=1), virial=self.virial)


class TLJModel(htt.SimModel):
    def compute(self, nlist, positions, box):
        rinv = htt.nlist_rinv(nlist)
        r6 = rinv ** 6
        return htt.compute_nlist_forces(
            nlist, torch.sum(2.0 * (r6 * r6 - r6), dim=1),
            virial=self.virial)


def test_log_period_steps_and_accumulation():
    """The JAX test's case in the port: 9 particles, steps 0, 5, 10, 15,
    and the records of a second run appended."""
    n = 9
    sim = htt.Simulation(dt=0.001, seed=1, device="cpu")
    sim.init_lattice(n, a=4.0, kT_init=0.8)
    htt.tfcompute(TLJModel(n - 1)).attach(sim, r_cut=5.0)
    assert sim.log is None
    sim.run(20, log_period=5)
    assert set(sim.log) == KEYS
    np.testing.assert_array_equal(sim.log["step"], [0, 5, 10, 15])
    assert all(np.all(np.isfinite(v)) for v in sim.log.values())
    sim.run(10, log_period=5)
    assert len(sim.log["step"]) == 6
    np.testing.assert_array_equal(sim.log["step"], [0, 5, 10, 15, 20, 25])
    sim.run(5)
    assert len(sim.log["step"]) == 6


def _pair(route, virial, n=256, density=0.3, seed=4):
    """A JAX and a port simulation from one state, NVE at kT 1, LJ with or
    without its virial: the port on ``route``, JAX on 'n2' (its cellwise
    repack leaves the carried forces unpermuted, ROADMAP.md Queue 3)."""
    pos, vel, lengths = fluid_arrays(n, density, seed, kT=1.0)
    js = jax_state(pos, vel, lengths)
    jsim = htf.Simulation(dt=0.004, integrator=htf.md.NVE(), seed=seed)
    jsim.set_state(js)
    tsim = htt.Simulation(dt=0.004, integrator=htt.md.NVE(), seed=seed,
                          device="cpu")
    tsim.set_state(state_from_numpy(jax_state_numpy(js), device="cpu"))
    if route == "cellwise":
        jm, tm = JLJ(64, virial=virial), TLJ(64, virial=virial)
    else:
        jm, tm = JLJModel(64, virial=virial), TLJModel(64, virial=virial)
    htf.tfcompute(jm).attach(jsim, r_cut=2.5, nlist="n2")
    htt.tfcompute(tm).attach(tsim, r_cut=2.5, nlist=route)
    return jsim, tsim


@pytest.mark.parametrize("route", ["n2", "cellwise"])
@pytest.mark.parametrize("virial", [True, False])
def test_log_values_match_jax(route, virial):
    """20 steps logged every 4 through two runs: every value against the
    JAX package's. A model that declares no virial contributes none to
    the logged pressure, as in JAX (the ideal-gas term alone)."""
    jsim, tsim = _pair(route, virial)
    for s in (jsim, tsim):
        s.run(12, log_period=4)
        s.run(8, log_period=4)
    np.testing.assert_array_equal(tsim.log["step"], [0, 4, 8, 12, 16])
    np.testing.assert_array_equal(tsim.log["step"], jsim.log["step"])
    for k in KEYS - {"step"}:
        np.testing.assert_allclose(tsim.log[k], np.asarray(jsim.log[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    ke, p = tsim.log["kinetic_energy"], tsim.log["pressure"]
    vol = float(np.prod(tsim._lengths))
    ideal = np.allclose(p, 2.0 * ke / (3.0 * vol), rtol=1e-5)
    assert ideal == (not virial)


@pytest.mark.parametrize("route", ["n2", "cellwise"])
def test_last_row_is_the_final_state(route):
    """A row holds the state at the end of its step: a run whose last step
    is logged ends at that row's values (on 'cellwise', summed over the
    real particles only, ghost slots left out)."""
    _, tsim = _pair(route, True)
    tsim.run(9, log_period=4)
    th = tsim.thermo()
    assert tsim.log["step"][-1] == 8
    for k in KEYS - {"step"}:
        assert float(tsim.log[k][-1]) == pytest.approx(th[k], rel=1e-6), k
    if route == "cellwise":
        assert tsim._layout.plan.n_slots > 256


def _rolled_back(route, seed=6):
    """A run of 30 steps logged every 10, forced through capacity-overflow
    rollbacks (the packed cell list grows 1.3x a retry), and the same run
    without one."""
    out = []
    for cap in (2, None):
        pos, vel, lengths = fluid_arrays(600, 0.3, seed, kT=1.0)
        sim = htt.Simulation(dt=0.004, integrator=htt.md.NVE(), seed=seed,
                             device="cpu")
        sim.init_state(pos, lengths, velocities=vel)
        if route == "cellwise":
            nlist = htt.Cellwise(capacity=cap) if cap else "cellwise"
            model = TLJ(64, virial=True)
        else:
            nlist = htt.CellList(capacity=cap) if cap else "cell"
            model = TLJModel(64, virial=True)
        htt.tfcompute(model).attach(sim, r_cut=2.5, nlist=nlist)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            sim.run(30, log_period=10)
        rolled = [x for x in w if "exceeded" in str(x.message)]
        assert (len(rolled) > 0) == bool(cap)
        out.append(sim.log)
    return out


@pytest.mark.parametrize("route", ["cell", "cellwise"])
def test_rolled_back_attempt_commits_no_rows(route):
    forced, clean = _rolled_back(route)
    np.testing.assert_array_equal(forced["step"], [0, 10, 20])
    for k in KEYS - {"step"}:
        np.testing.assert_allclose(forced[k], clean[k], rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def test_log_with_stateful_model_and_period():
    """Logging leaves the model's calls as they were: a metric counts one
    update per evaluation, ``period`` 2 evaluating every other step."""
    sim = htt.Simulation(dt=0.002, seed=1, device="cpu")
    sim.init_lattice(27, a=1.6, kT_init=0.5)
    model = TMeanModel(26)
    tfc = htt.tfcompute(model)
    tfc.attach(sim, r_cut=3.0, nlist="n2", period=2)
    sim.run(10, log_period=3)
    np.testing.assert_array_equal(sim.log["step"], [0, 3, 6, 9])
    assert float(model.avg_energy.count.value) == 27 * 5
