"""``tfcompute``'s array accessors, port against the JAX package:
``get_forces_array`` in training mode (the staged label forces of the
selected built-ins, tests/test_driver.py:141-156) and
``get_virial_array`` on the packed and the cellwise routes. Each pair of
simulations starts from one JAX state carried to the port
(``interop.state_from_numpy``).

Tolerances: forces atol 1e-5 (the JAX test's); on 'cellwise' against
the dense list rtol 2e-4, atol 2e-5 (the JAX package's bar for its
cellwise forces against the dense build, tests/test_cellwise.py); the
virial rtol 1e-4, atol 1e-5 after one step (float32 sums in another
order)."""

import jax.numpy as jnp
import numpy as np
import torch

import hoomd_tf_tpu as htf
import hoomd_tf_tpu_torch as htt
from hoomd_tf_tpu_torch.interop import state_from_numpy

from torch_helpers import (fluid_arrays, jax_state, jax_state_numpy,
                           nn_pair_class, np_)
from test_torch_simulation import JLJ, TLJ


class JGraph(htf.SimModel):
    """A trainable generic model (tests/zoo.py's TrainableGraph: LJ with a
    trainable strength)."""

    def setup(self):
        self.eps = htf.Variable(1.0, name="eps")

    def compute(self, nlist, positions, box):
        rinv = htf.nlist_rinv(nlist)
        r6 = rinv ** 6
        energy = self.eps * jnp.sum(2.0 * (r6 * r6 - r6), axis=1)
        return htf.compute_nlist_forces(nlist, energy)


class TGraph(htt.SimModel):
    def setup(self):
        self.eps = htt.Variable(1.0, name="eps")

    def compute(self, nlist, positions, box):
        rinv = htt.nlist_rinv(nlist)
        r6 = rinv ** 6
        energy = self.eps * torch.sum(2.0 * (r6 * r6 - r6), dim=1)
        return htt.compute_nlist_forces(nlist, energy)


def _train_pair(n=16, nlist="n2"):
    """The JAX test's set-up in both packages: two built-in LJs, the model
    trained against the first one's forces; 5 steps."""
    r_cut = 3.0
    jsim = htf.Simulation(dt=0.001, integrator=htf.md.NVE(), seed=1)
    jsim.init_lattice(n, a=1.5, kT_init=0.5)
    tsim = htt.Simulation(dt=0.001, integrator=htt.md.NVE(), seed=1,
                          device="cpu")
    tsim.set_state(state_from_numpy(jax_state_numpy(jsim.state),
                                    device="cpu"))
    out = []
    for pkg, sim, model in ((htf, jsim, JGraph(n - 1, output_forces=False)),
                            (htt, tsim, TGraph(n - 1, output_forces=False))):
        model.compile(optimizer="adam", loss="mse")
        lj = sim.add_force(pkg.md.LennardJones(r_cut=r_cut))
        sim.add_force(pkg.md.LennardJones(epsilon=4.0, sigma=0.8,
                                          r_cut=r_cut))
        tfc = pkg.tfcompute(model)
        tfc.attach(sim, r_cut=r_cut, train=True, nlist=nlist)
        tfc.set_reference_forces(lj)
        sim.run(5)
        out.append((sim, tfc, lj))
    return out


def test_get_forces_array_returns_labels_in_train_mode():
    """With ``train=True`` and reference forces selected, the accessor
    gives the selected built-in's forces at the current state, as the
    JAX package's does, not the net forces."""
    (jsim, jtfc, jlj), (tsim, ttfc, tlj) = _train_pair()
    staged = ttfc.get_forces_array()
    nlist = tsim._build_nlist(tsim.state)
    f_lj, _ = tlj(tsim.state, nlist)
    np.testing.assert_allclose(staged, np_(f_lj), atol=1e-5)
    np.testing.assert_allclose(staged, jtfc.get_forces_array(), atol=1e-5)
    net = np_(tsim.state.forces)
    assert np.abs(net - staged).max() > 1e-2   # the second LJ is left out


def test_get_forces_array_labels_on_cellwise():
    """The same accessor on 'cellwise', where the state is held in slot
    order during a run: the labels of the selected built-in, in particle
    order, equal its forces on a dense list of the same state."""
    pos, vel, lengths = fluid_arrays(256, 0.25, seed=5, kT=1.0)
    sim = htt.Simulation(dt=0.002, integrator=htt.md.NVE(), seed=5,
                         device="cpu")
    sim.init_state(pos, lengths, velocities=vel)
    lj = sim.add_force(htt.md.LennardJones(r_cut=2.5))
    sim.add_force(htt.md.LennardJones(epsilon=4.0, sigma=0.8, r_cut=2.5))
    model = nn_pair_class()(64, output_forces=False)
    model.compile(optimizer="sgd", loss="mse", learning_rate=1e-4)
    tfc = htt.tfcompute(model)
    tfc.attach(sim, r_cut=2.5, nlist="cellwise", train=True)
    tfc.set_reference_forces(lj)
    sim.run(3)
    staged = tfc.get_forces_array()
    dense = htt.compute_nlist(sim.state.positions4, 2.5, 128,
                              htt.box_size(sim.state.box), sorted=True,
                              return_types=True)
    want, _ = lj(sim.state, dense)
    np.testing.assert_allclose(staged, np_(want), rtol=2e-4, atol=2e-5)
    assert staged.shape == (256, 4)


def _virial_pair(nlist, n=256):
    pos, vel, lengths = fluid_arrays(n, 0.35, seed=2, kT=1.0)
    js = jax_state(pos, vel, lengths)
    jsim = htf.Simulation(dt=0.002, integrator=htf.md.NVE(), seed=2)
    jsim.set_state(js)
    tsim = htt.Simulation(dt=0.002, integrator=htt.md.NVE(), seed=2,
                          device="cpu")
    tsim.set_state(state_from_numpy(jax_state_numpy(js), device="cpu"))
    jtfc = htf.tfcompute(JLJ(64, virial=True))
    ttfc = htt.tfcompute(TLJ(64, virial=True))
    jtfc.attach(jsim, r_cut=2.5, nlist=nlist)
    ttfc.attach(tsim, r_cut=2.5, nlist=nlist)
    jsim.run(1)
    tsim.run(1)
    return jtfc, ttfc


def test_get_virial_array_packed():
    jtfc, ttfc = _virial_pair("n2")
    got, want = ttfc.get_virial_array(), np.asarray(jtfc.get_virial_array())
    assert got.shape == want.shape == (256, 9)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_get_virial_array_cellwise():
    """On 'cellwise' the virial of a model that declares one, in particle
    order after the run, against the JAX package's cellwise route (one
    step: no repack, where the JAX route's carried forces stay
    unpermuted)."""
    jtfc, ttfc = _virial_pair("cellwise")
    got, want = ttfc.get_virial_array(), np.asarray(jtfc.get_virial_array())
    assert got.shape == want.shape == (256, 9)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
