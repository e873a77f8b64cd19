"""``period`` > 1 for a model evaluated on 'cellwise', port against the
JAX package: the model runs every ``period`` steps and its last forces
stand between, following their particles through each repack and
persisting across ``run()`` calls (the JAX package's
``tfcompute.persisted_model_forces``); with a built-in force attached
only the model's part is carried.

The JAX cellwise repack leaves carried forces in the old slot order
(ROADMAP.md Queue 3), so the port is held against the JAX package's
'n2' route, over two runs with repacks pinned every 5 steps (mid-run
repacks at steps 5 and 13, and one at each run's start).

Tolerances: positions atol 2e-5 (modulo the box), velocities and forces
(the state's and the carried model forces) rtol 1e-5, atol 1e-5 after
15 steps of a gentle fluid."""

import numpy as np
import pytest

import hoomd_tf_tpu as htf
import hoomd_tf_tpu_torch as htt
from hoomd_tf_tpu_torch.interop import state_from_numpy

from torch_helpers import fluid_arrays, jax_state, jax_state_numpy, np_
from test_torch_simulation import JLJ, TLJ, assert_wrapped_close


def _pair(builtin, virial, seed=3):
    pos, vel, lengths = fluid_arrays(256, 0.25, seed, kT=0.8)
    js = jax_state(pos, vel, lengths)
    jsim = htf.Simulation(dt=0.004, integrator=htf.md.NVE(), seed=seed)
    jsim.set_state(js)
    tsim = htt.Simulation(dt=0.004, integrator=htt.md.NVE(), seed=seed,
                          device="cpu")
    tsim.set_state(state_from_numpy(jax_state_numpy(js), device="cpu"))
    if builtin:
        jsim.add_force(htf.md.LennardJones(0.5, 0.9, r_cut=2.5))
        tsim.add_force(htt.md.LennardJones(0.5, 0.9, r_cut=2.5))
    jtfc = htf.tfcompute(JLJ(64, virial=virial))
    ttfc = htt.tfcompute(TLJ(64, virial=virial))
    jtfc.attach(jsim, r_cut=2.5, nlist="n2", period=3)
    ttfc.attach(tsim, r_cut=2.5, nlist=htt.Cellwise(skin=0.3), period=3)
    tsim._choose_repack_interval = lambda layout: 5
    return (jsim, jtfc), (tsim, ttfc)


@pytest.mark.parametrize("builtin,virial", [(False, False), (True, True)])
def test_period_on_cellwise_matches_jax(builtin, virial):
    (jsim, jtfc), (tsim, ttfc) = _pair(builtin, virial)
    evals = tsim.force_evals
    r0 = tsim.repacks
    for k in (8, 7):
        jsim.run(k)
        tsim.run(k)
    # the model ran at steps 0, 3, 6, 9, 12 and at no run's end; a
    # built-in force at every step and once more at each run's end
    assert tsim.force_evals - evals == 5 + (17 if builtin else 0)
    assert tsim.repacks - r0 == 4
    assert_wrapped_close(tsim.state.positions, jsim.state.positions,
                         tsim._lengths, atol=2e-5)
    np.testing.assert_allclose(np_(tsim.state.velocities),
                               np_(jsim.state.velocities), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(np_(tsim.state.forces),
                               np_(jsim.state.forces), rtol=1e-5, atol=1e-5)
    # the carried model forces (and virial), in particle order
    tf, tw = ttfc.model_forces(tsim.state)
    jf, jw = jtfc.persisted_model_forces(256, np.float32)
    np.testing.assert_allclose(np_(tf), np_(jf), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np_(tw), np_(jw), rtol=1e-5, atol=1e-5)
    assert np.abs(np_(tw)).max() > 0.01 if virial else \
        np.abs(np_(tw)).max() == 0
    if virial:
        np.testing.assert_allclose(np_(tsim.state.virial),
                                   np_(jsim.state.virial), rtol=1e-5,
                                   atol=1e-5)


def test_period_one_is_every_step():
    """``period=1`` on 'cellwise' keeps the slim loop: one model
    evaluation a step and one at the end, nothing carried."""
    sim = htt.Simulation(dt=0.004, integrator=htt.md.NVE(), device="cpu")
    pos, vel, lengths = fluid_arrays(256, 0.25, 1, kT=0.8)
    sim.init_state(pos, lengths, velocities=vel)
    tfc = htt.tfcompute(TLJ(64))
    tfc.attach(sim, r_cut=2.5, nlist="cellwise")
    sim.run(6)
    assert sim.force_evals == 7
    assert tfc._model_forces is None
