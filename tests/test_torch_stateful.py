"""Stateful models in the engine, port against the JAX package: a run
that is rolled back (a capacity overflow) restores every model variable,
a metric's count and a lazily built ``MeanTensor`` included, on the
packed and the cellwise routes; reference examples 03 (``EDSLayer``,
``Mean``) and 04 (``WCARepulsion``, ``MeanTensor``, ``compute_rdf``,
``Langevin``) at their own sizes with their own asserts; and the EDS
coupling after 50 steps against the JAX package.

Tolerances: counts exactly; the EDS state after a rolled-back run and
the EDS coupling and the mean CV after 50 steps at rtol 1e-4 (NVE
trajectories, float32 sums in another order)."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hoomd_tf_tpu as htf
import hoomd_tf_tpu_torch as htt
from hoomd_tf_tpu_torch.interop import state_from_numpy

from torch_helpers import fluid_arrays, jax_state, jax_state_numpy, np_
from test_torch_layers import JEDSModel, JMeanModel, TEDSModel, TMeanModel


class JWCARDF(htf.SimModel):
    """Reference example 04's model."""

    def setup(self):
        self.wca = htf.WCARepulsion(0.9)
        self.avg_rdf = htf.MeanTensor()

    def compute(self, nlist, positions, box):
        forces = htf.compute_nlist_forces(nlist, self.wca(nlist))
        rdf, rs = htf.compute_rdf(nlist, [0.5, 3.0], positions[:, 3])
        self.avg_rdf.update_state(rdf)
        return forces


class TWCARDF(htt.SimModel):
    def setup(self):
        self.wca = htt.WCARepulsion(0.9)
        self.avg_rdf = htt.MeanTensor()

    def compute(self, nlist, positions, box):
        forces = htt.compute_nlist_forces(nlist, self.wca(nlist))
        rdf, rs = htt.compute_rdf(nlist, [0.5, 3.0], positions[:, 3])
        self.avg_rdf.update_state(rdf)
        return forces


def _sims(jm, tm, jnl, tnl, n=600, seed=8):
    """A JAX and a port simulation (NVE) from one state, ``jm`` / ``tm``
    attached with ``jnl`` / ``tnl``."""
    pos, vel, lengths = fluid_arrays(n, 0.3, seed, kT=1.0)
    js = jax_state(pos, vel, lengths)
    jsim = htf.Simulation(dt=0.004, integrator=htf.md.NVE(), seed=seed)
    jsim.set_state(js)
    tsim = htt.Simulation(dt=0.004, integrator=htt.md.NVE(), seed=seed,
                          device="cpu")
    tsim.set_state(state_from_numpy(jax_state_numpy(js), device="cpu"))
    jtfc, ttfc = htf.tfcompute(jm), htt.tfcompute(tm)
    jtfc.attach(jsim, r_cut=2.5, nlist=jnl)
    ttfc.attach(tsim, r_cut=2.5, nlist=tnl)
    return (jsim, jtfc), (tsim, ttfc)


def _run_rolled(sim, steps):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        sim.run(steps)
    return len([x for x in w if "exceeded" in str(x.message)])


@pytest.mark.parametrize("model", ["mean", "mean_tensor"])
def test_packed_rollback_restores_model_state(model):
    """A packed cell list too small at first: the run rolls back and
    re-plans; the metric counts the committed calls only, as in JAX. The
    ``MeanTensor`` is built during the first, rolled-back attempt."""
    if model == "mean":
        jm, tm = JMeanModel(64), TMeanModel(64)
    else:
        jm, tm = JWCARDF(64), TWCARDF(64)
    (jsim, _), (tsim, ttfc) = _sims(jm, tm, htf.CellList(capacity=2),
                                    htt.CellList(capacity=2))
    assert _run_rolled(tsim, 6) > 0
    jsim.run(6)
    if model == "mean":
        got, want = tm.avg_energy.count.value, jm.avg_energy.count.value
        assert float(got) == 600 * 6
    else:
        got, want = tm.avg_rdf.count.value, jm.avg_rdf.count.value
        assert np.all(np_(got) == 6)
    assert ttfc._calls == 6
    np.testing.assert_array_equal(np_(got), np.asarray(want))


def test_cellwise_rollback_restores_model_state(monkeypatch):
    """On 'cellwise' (the planes route: the model sees every slot row) a
    capacity overflow rolls back and replans: the count is the committed
    calls' rows on the final plan, as in JAX."""
    monkeypatch.setenv("HTF_LANE_FAST", "0")
    (jsim, _), (tsim, _) = _sims(JMeanModel(64), TMeanModel(64),
                                 htf.Cellwise(capacity=4),
                                 htt.Cellwise(capacity=4))
    assert _run_rolled(tsim, 4) > 0
    jsim.run(4)
    n_slots = tsim._layout.plan.n_slots
    assert float(tsim.tfc.model.avg_energy.count.value) == 4 * n_slots
    assert float(jsim.tfc.model.avg_energy.count.value) == 4 * n_slots


class JEDSLJ(htf.SimModel):
    """LJ whose first particle's energy is an EDS layer's collective
    variable."""

    def setup(self):
        self.eds = htf.EDSLayer(-0.5, period=5, learning_rate=0.2)

    def compute(self, nlist, positions, box):
        rinv = htf.nlist_rinv(nlist)
        r6 = rinv ** 6
        energy = jnp.sum(2.0 * (r6 * r6 - r6), axis=1)
        alpha = self.eds(energy[0])
        return htf.compute_nlist_forces(nlist, energy), alpha


class TEDSLJ(htt.SimModel):
    def setup(self):
        self.eds = htt.EDSLayer(-0.5, period=5, learning_rate=0.2)

    def compute(self, nlist, positions, box):
        rinv = htt.nlist_rinv(nlist)
        r6 = rinv ** 6
        energy = torch.sum(2.0 * (r6 * r6 - r6), dim=1)
        alpha = self.eds(energy[0])
        return htt.compute_nlist_forces(nlist, energy), alpha


def test_rollback_restores_eds_state():
    """The EDS layer's statistics, int32 counters and Adam state after a
    run forced through rollbacks are the committed calls' only, as in
    JAX (the layer built during the first, rolled-back attempt)."""
    (jsim, _), (tsim, _) = _sims(JEDSLJ(64), TEDSLJ(64),
                                 htf.CellList(capacity=2),
                                 htt.CellList(capacity=2))
    assert _run_rolled(tsim, 7) > 0
    jsim.run(7)
    te, je = tsim.tfc.model.eds, jsim.tfc.model.eds
    assert int(te.n.value) == 2 and int(te.adam_t.value) == 1
    for tv, jv in zip(te.variables, je.variables):
        np.testing.assert_allclose(np_(tv), np.asarray(jv.value),
                                   rtol=1e-4, err_msg=jv.name)


def test_example_03_eds_biasing():
    """Reference example 03 as it stands, on the port."""
    model = TEDSModel(0, set_point=4.0)
    sim = htt.Simulation(dt=0.05, seed=2, device="cpu")
    sim.init_lattice(n=9, a=4.0, kT_init=0.2)
    tfc = htt.tfcompute(model)
    tfc.attach(sim, r_cut=0, save_output_period=10)
    sim.run(1000)
    cv = float(model.cv_avg.result())
    assert (cv - 4.0) ** 2 < 0.8, cv
    assert float(model.cv_avg.count.value) == 1000
    assert tfc.outputs[0].shape[0] == 100
    assert np.all(np.isfinite(tfc.outputs[0]))


def test_example_04_particle_simulations():
    """Reference example 04 as it stands, on the port (216 particles,
    Langevin at kT 0.8, 1000 steps)."""
    model = TWCARDF(48)
    sim = htt.Simulation(dt=0.002, integrator=htt.md.Langevin(kT=0.8,
                                                              gamma=1.0),
                         seed=7, device="cpu")
    sim.init_lattice(n=216, density=0.5, kT_init=0.8)
    tfc = htt.tfcompute(model)
    tfc.attach(sim, r_cut=3.0)
    sim.run(1000)
    rdf = model.avg_rdf.result()
    t = sim.thermo()
    assert float(torch.sum(rdf)) > 0.0
    assert abs(t["temperature"] - 0.8) < 0.5, t
    assert tfc._calls == 1000
    assert np.all(np_(model.avg_rdf.count.value) == 1000)


def test_eds_after_50_steps_matches_jax():
    """Example 03's system for 50 steps from one state: the coupling and
    the mean CV against the JAX package's."""
    jsim = htf.Simulation(dt=0.05, seed=2)
    jsim.init_lattice(n=9, a=4.0, kT_init=0.2)
    tsim = htt.Simulation(dt=0.05, seed=2, device="cpu")
    tsim.set_state(state_from_numpy(jax_state_numpy(jsim.state),
                                    device="cpu"))
    jm, tm = JEDSModel(0, set_point=4.0), TEDSModel(0, set_point=4.0)
    htf.tfcompute(jm).attach(jsim, r_cut=0)
    htt.tfcompute(tm).attach(tsim, r_cut=0)
    jsim.run(50)
    tsim.run(50)
    alpha = float(tm.eds_bias.alpha.value.detach())
    assert alpha != 0.0 and int(tm.eds_bias.adam_t.value) == 10
    np.testing.assert_allclose(alpha, float(jm.eds_bias.alpha.value),
                               rtol=1e-4)
    np.testing.assert_allclose(float(tm.cv_avg.result()),
                               float(jnp.asarray(jm.cv_avg.result())),
                               rtol=1e-4)
