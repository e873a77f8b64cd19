"""The packed neighbor-list path as a whole against the JAX package: the
JAX package's typical use (a generic SimModel, LJ from ``nlist_rinv``,
forces by autodiff) through ``Simulation(device="cpu")`` in each neighbor
mode, from the same state (``interop.state_from_numpy``) and the same
weights (``interop.load_jax_variables``).

Compared after one step, as tests/test_cell_list.py compares its modes:
positions atol 1e-6, forces (and the virial) atol 1e-4 -- the sums run
in another order, and trajectories are compared over single steps only
(docs/testing.md)."""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import hoomd_tf_tpu as htf
import hoomd_tf_tpu_torch as htt
from hoomd_tf_tpu_torch.interop import (build_model, load_jax_variables,
                                        state_from_numpy)

from torch_helpers import (fluid_arrays, jax_state, jax_state_numpy, np_,
                           seed_jax_weights)

POS_TOL = dict(rtol=0, atol=1e-6)
F_TOL = dict(rtol=0, atol=1e-4)


class JLJ(htf.SimModel):
    def compute(self, nlist, positions, box):
        rinv = htf.nlist_rinv(nlist)
        inv_r6 = rinv ** 6
        energy = jnp.sum(4.0 / 2.0 * (inv_r6 * inv_r6 - inv_r6), axis=1)
        return htf.compute_nlist_forces(nlist, energy, virial=self.virial)


class TLJ(htt.SimModel):
    """The JAX package's typical use with jnp.sum -> torch.sum."""

    def compute(self, nlist, positions, box):
        rinv = htt.nlist_rinv(nlist)
        inv_r6 = rinv ** 6
        energy = torch.sum(4.0 / 2.0 * (inv_r6 * inv_r6 - inv_r6), dim=1)
        return htt.compute_nlist_forces(nlist, energy, virial=self.virial)


class JNN(htf.SimModel):
    """run_benchmarks.py's TrainableNN, in eval: Dense(16), tanh,
    Dense(1) per neighbor on 1/r."""

    def setup(self):
        self.dense1 = htf.Dense(16)
        self.last = htf.Dense(1)

    def compute(self, nlist, positions, box):
        rinv = htf.nlist_rinv(nlist)
        x = jax.nn.tanh(self.dense1(rinv[..., None]))
        e = jnp.sum(self.last(x)[..., 0], axis=1)
        return htf.compute_nlist_forces(nlist, e)


class TNN(htt.SimModel):
    def setup(self):
        self.dense1 = htt.Dense(16)
        self.last = htt.Dense(1)

    def compute(self, nlist, positions, box):
        rinv = htt.nlist_rinv(nlist)
        x = torch.tanh(self.dense1(rinv[..., None]))
        e = torch.sum(self.last(x)[..., 0], dim=1)
        return htt.compute_nlist_forces(nlist, e)


def sims(n, density, jmodel, tmodel, nlist, seed=0, forces=(), r_cut=3.0,
         integrator="NVE"):
    """A JAX and a port simulation from the same state with the models
    attached (``jmodel``/``tmodel`` may be None) and the built-in forces
    ``forces`` (pairs of JAX and port objects) added."""
    pos, vel, lengths = fluid_arrays(n, density, seed, kT=1.0)
    js = jax_state(pos, vel, lengths)
    integ = dict(NVE=(htf.md.NVE(), htt.md.NVE()),
                 NVT=(htf.md.NVT(kT=1.0, tau=0.5),
                      htt.md.NVT(kT=1.0, tau=0.5)))[integrator]
    jsim = htf.Simulation(dt=0.005, integrator=integ[0], seed=seed)
    jsim.set_state(js)
    tsim = htt.Simulation(dt=0.005, integrator=integ[1], seed=seed,
                          device="cpu")
    tsim.set_state(state_from_numpy(jax_state_numpy(js), device="cpu"))
    for jf, tf in forces:
        jsim.add_force(jf)
        tsim.add_force(tf)
    jtfc = ttfc = None
    if jmodel is not None:
        jtfc = htf.tfcompute(jmodel)
        jtfc.attach(jsim, r_cut=r_cut, nlist=nlist)
        ttfc = htt.tfcompute(tmodel)
        ttfc.attach(tsim, r_cut=r_cut, nlist=nlist)
    return (jsim, jtfc), (tsim, ttfc)


def step_and_compare(jsim, tsim, virial=False, steps=1):
    jsim.run(steps)
    tsim.run(steps)
    np.testing.assert_allclose(np_(tsim.state.positions),
                               np_(jsim.state.positions), **POS_TOL)
    np.testing.assert_allclose(np_(tsim.state.forces),
                               np_(jsim.state.forces), **F_TOL)
    if virial:
        np.testing.assert_allclose(np_(tsim.state.virial),
                                   np_(jsim.state.virial), **F_TOL)


@pytest.mark.parametrize("nlist", ["n2", "cell", "pallas", None])
def test_typical_use_matches_jax(nlist):
    """The JAX package's typical use, LJModel(64) attached with
    attach(sim, r_cut=3.0): None resolves to the sort method on the CPU
    (N = 600 >= 512), as in the JAX package off the TPU."""
    (jsim, _), (tsim, _) = sims(600, 0.35, JLJ(64), TLJ(64), nlist)
    step_and_compare(jsim, tsim)
    want = {"n2": "n2", "cell": "sort", "pallas": "pallas", None: "sort"}
    assert tsim._packed_build().method == want[nlist]
    assert tsim.nlist_builds == 1
    f = np_(tsim.state.forces)
    assert np.abs(f[:, :3]).max() > 1e-2 and np.abs(f[:, 3]).max() > 1e-2


def test_nn_model_matches_jax():
    """A per-neighbor MLP on 1/r with weights from a numpy seed, carried
    across by interop."""
    NN = 48
    jm = JNN(NN)
    jm.ensure_built([jnp.zeros((1, NN, 4)), jnp.zeros((1, 4)),
                     jnp.zeros((3, 3))])
    seed_jax_weights(jm, seed=3)
    tm = build_model(TNN(NN), 3.0, device="cpu")
    load_jax_variables(tm, jm.get_weights())
    (jsim, _), (tsim, _) = sims(300, 0.35, jm, tm, "cell", seed=1)
    step_and_compare(jsim, tsim)


def test_virial_model_matches_jax():
    (jsim, _), (tsim, _) = sims(300, 0.35, JLJ(48, virial=True),
                                TLJ(48, virial=True), "pallas", seed=2,
                                integrator="NVT")
    step_and_compare(jsim, tsim, virial=True)
    th_t, th_j = tsim.thermo(), jsim.thermo()
    np.testing.assert_allclose(th_t["pressure"], th_j["pressure"],
                               rtol=1e-4)


def test_builtin_beside_the_model():
    """A built-in md.LennardJones evaluated on the same packed list and
    summed with the model's forces (the reference benchmark's combined
    protocol)."""
    forces = [(htf.md.LennardJones(epsilon=0.5, r_cut=3.0),
               htt.md.LennardJones(epsilon=0.5, r_cut=3.0))]
    (jsim, _), (tsim, _) = sims(300, 0.35, JLJ(48), TLJ(48), "cell",
                                seed=3, forces=forces)
    step_and_compare(jsim, tsim, virial=True)


def test_builtins_alone_in_a_small_box():
    """Built-in forces alone in a box of fewer than 3 cells per axis take
    the dense packed build (the port used to refuse this)."""
    forces = [(htf.md.LennardJones(r_cut=3.0), htt.md.LennardJones(r_cut=3.0)),
              (htf.md.WCA(), htt.md.WCA())]
    (jsim, _), (tsim, _) = sims(100, 0.35, None, None, None, seed=4,
                                forces=forces)
    assert not tsim._use_cellwise()
    step_and_compare(jsim, tsim, virial=True)
    assert tsim._packed_build().method == "n2"


def test_get_nlist_array_matches_jax():
    (jsim, jtfc), (tsim, ttfc) = sims(300, 0.35, JLJ(48), TLJ(48), "n2",
                                      seed=5)
    np.testing.assert_allclose(ttfc.get_nlist_array(),
                               jtfc.get_nlist_array(), rtol=0, atol=1e-6)


def test_capacity_overflow_self_heals():
    """An undersized CellList(capacity=8) overflows, warns, rolls back,
    re-plans with a larger floor (1.3x + 1 per retry) and ends where a
    clean run ends."""
    out = []
    for cfg in (htt.CellList(capacity=8), "cell"):
        (_, _), (tsim, _) = sims(300, 0.35, None, None, None, seed=6)
        htt.tfcompute(TLJ(48)).attach(tsim, r_cut=3.0, nlist=cfg)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            tsim.run(3)
        out.append((np_(tsim.state.positions), np_(tsim.state.forces),
                    [str(x.message) for x in w]))
    assert any("capacity 8 exceeded" in m for m in out[0][2])
    assert not any("exceeded" in m for m in out[1][2])
    np.testing.assert_allclose(out[0][0], out[1][0], **POS_TOL)
    np.testing.assert_allclose(out[0][1], out[1][1], **F_TOL)


def test_check_nlist_raises_on_a_full_list():
    (jsim, _), (tsim, _) = sims(300, 0.35, JLJ(8, check_nlist=True),
                                TLJ(8, check_nlist=True), "cell", seed=7)
    with pytest.raises(ValueError, match="Neighbor list is full"):
        jsim.run(1)
    with pytest.raises(ValueError, match="Neighbor list is full"):
        tsim.run(1)
    assert not bool(tsim.tfc.model.nlist_overflow)   # cleared on raise
