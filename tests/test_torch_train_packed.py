"""Training on the packed neighbor list and the model-level training
surface, port against the JAX package: online training through
``tfcompute.attach(train=True)`` with ``batch_size`` particle chunks and
``period``; the ``outputs`` capture of ``save_output_period``;
``SimModel.train_on_batch``; :class:`Variable` and the weights'
constraints (the cases of tests/test_model.py:173-230 and the ready-made
``TrainableLJ``). Inputs are made with numpy and handed to both packages,
weights through ``interop.load_jax_variables``.

Tolerances: losses and weights after a few SGD steps at rtol 1e-4 (one
batch) and 1e-3 (an MD trajectory, whose float32 sums drift in another
order), atol 1e-6; captured outputs at rtol 1e-4, atol 1e-5."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hoomd_tf_tpu as htf
import hoomd_tf_tpu_torch as htt
from hoomd_tf_tpu_torch.interop import (build_model, load_jax_variables,
                                        state_from_numpy)
from hoomd_tf_tpu_torch.ops import box as tbox

from torch_helpers import (fluid_arrays, jax_state, jax_state_numpy, np_,
                           seed_jax_weights)

from test_torch_train_generic import build_jax, trainable
from test_torch_train_pair import JNN, TNN

R_CUT = 2.5


class JOut(htf.SimModel):
    """LJ forces and, past them, the summed energy (an output to save)."""

    def compute(self, nlist, positions, box):
        rinv = htf.nlist_rinv(nlist)
        r6 = rinv ** 6
        e = jnp.sum(2.0 * (r6 * r6 - r6), axis=1)
        return htf.compute_nlist_forces(nlist, e), jnp.sum(e)


class TOut(htt.SimModel):
    def compute(self, nlist, positions, box):
        rinv = htt.nlist_rinv(nlist)
        r6 = rinv ** 6
        e = torch.sum(2.0 * (r6 * r6 - r6), dim=1)
        return htt.compute_nlist_forces(nlist, e), torch.sum(e)


def sims(jm, tm, n=64, seed=2, **attach):
    """A JAX and a port simulation (NVT at kT 1.5 under a built-in LJ)
    from the same jittered fluid, ``jm`` and ``tm`` attached on the packed
    list (``nlist='n2'``) with ``attach``."""
    pos, vel, lengths = fluid_arrays(n, 0.4, seed, kT=1.5)
    js = jax_state(pos, vel, lengths)
    jsim = htf.Simulation(dt=0.005, integrator=htf.md.NVT(kT=1.5, tau=0.5),
                          seed=seed)
    jsim.set_state(js)
    jsim.add_force(htf.md.LennardJones(r_cut=R_CUT))
    jtfc = htf.tfcompute(jm)
    jtfc.attach(jsim, r_cut=R_CUT, nlist="n2", **attach)
    tsim = htt.Simulation(dt=0.005, integrator=htt.md.NVT(kT=1.5, tau=0.5),
                          seed=seed, device="cpu")
    tsim.set_state(state_from_numpy(jax_state_numpy(js), device="cpu"))
    tsim.add_force(htt.md.LennardJones(r_cut=R_CUT))
    ttfc = htt.tfcompute(tm)
    ttfc.attach(tsim, r_cut=R_CUT, nlist="n2", **attach)
    return (jsim, jtfc), (tsim, ttfc)


def nn_pair(lr=1e-3):
    jm = seed_jax_weights(build_jax(JNN(32, output_forces=False)), 1)
    tm = TNN(32, output_forces=False)
    build_model(tm, R_CUT, "cpu")
    load_jax_variables(tm, jm.get_weights())
    jm.compile(optimizer="sgd", loss="mse", learning_rate=lr)
    tm.compile(optimizer="sgd", loss="mse", learning_rate=lr)
    return jm, tm


@pytest.mark.parametrize("batch_size,period", [(None, 1), (16, 2),
                                               (24, 1)])
def test_packed_training_matches_jax(batch_size, period):
    """Online training of TrainableNN (width 8) on the packed list at
    N = 64: with ``batch_size`` one SGD step per particle chunk (the last
    chunk zero-padded), the step's loss the chunks' mean; ``period=2``
    trains on the even steps only. Losses and weights after 6 steps equal
    the JAX package's."""
    jm, tm = nn_pair()
    (jsim, jtfc), (tsim, ttfc) = sims(jm, tm, train=True,
                                      batch_size=batch_size, period=period)
    jsim.run(6)
    tsim.run(6)
    assert len(ttfc.loss_history) == len(jtfc.loss_history) == 6 // period
    assert tsim.train_steps == 6 // period
    np.testing.assert_allclose(ttfc.loss_history, jtfc.loss_history,
                               rtol=1e-3)
    for a, b in zip(trainable(tm.get_weights()), trainable(jm.get_weights())):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(np_(tsim.state.positions),
                               np.asarray(jsim.state.positions), atol=1e-4)


@pytest.mark.parametrize("batch_size", [None, 24])
def test_saved_outputs_match_jax(batch_size):
    """``save_output_period=2`` with ``period=2``: the model runs on the
    even steps and every second call's outputs past the forces are kept
    (each particle chunk's on its own with ``batch_size``), as the JAX
    package keeps them; the carried model forces drive the odd steps."""
    (jsim, jtfc), (tsim, ttfc) = sims(JOut(32), TOut(32), period=2,
                                      save_output_period=2,
                                      batch_size=batch_size)
    jsim.run(4)
    tsim.run(4)
    jsim.run(4)
    tsim.run(4)
    want = [np.asarray(o) for o in jtfc.outputs]
    assert len(ttfc.outputs) == len(want) == 1
    assert ttfc.outputs[0].shape == want[0].shape
    assert want[0].shape[0] == 2 * (1 if batch_size is None else 3)
    np.testing.assert_allclose(ttfc.outputs[0], want[0], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(np_(tsim.state.positions),
                               np.asarray(jsim.state.positions), atol=1e-4)


def test_overflow_rolls_back_packed_training():
    """A cell-list capacity overflow rolls a packed training run back: the
    retried run commits like a clean one from the same start (the
    weights, the losses)."""
    runs = []
    for capacity in (2, None):
        jm, tm = nn_pair()
        sim = htt.Simulation(dt=0.005,
                             integrator=htt.md.NVT(kT=1.5, tau=0.5),
                             seed=0, device="cpu")
        pos, vel, lengths = fluid_arrays(512, 0.4, 3, kT=1.5)
        sim.set_state(state_from_numpy(jax_state_numpy(
            jax_state(pos, vel, lengths)), device="cpu"))
        sim.add_force(htt.md.LennardJones(r_cut=R_CUT))
        tfc = htt.tfcompute(tm)
        tfc.attach(sim, r_cut=R_CUT, train=True,
                   nlist=htt.CellList(capacity=capacity))
        if capacity:
            with pytest.warns(UserWarning, match="capacity 2 exceeded"):
                sim.run(3)
        else:
            sim.run(3)
        runs.append((tfc.loss_history, trainable(tm.get_weights()),
                     sim.train_steps))
    (l_retry, w_retry, n_retry), (l_clean, w_clean, n_clean) = runs
    assert n_retry > n_clean == 3 and len(l_retry) == 3
    np.testing.assert_allclose(l_retry, l_clean, rtol=1e-5)
    for a, b in zip(w_retry, w_clean):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-8)


# ----------------------------------------------------------------------
# the model-level surface
# ----------------------------------------------------------------------
def make_inputs(n=9, NN=8, seed=0, L=8.0, r_cut=4.0):
    """tests/test_model.py's inputs, in both packages."""
    rng = np.random.RandomState(seed)
    box_l = np.array([L, L, L], dtype=np.float32)
    pos = (rng.rand(n, 3) * box_l - box_l / 2).astype(np.float32)
    pos4 = np.concatenate([pos, np.zeros((n, 1), np.float32)], axis=1)
    nlist = np.asarray(htf.compute_nlist(jnp.asarray(pos4), r_cut, NN,
                                         box_l, sorted=True,
                                         return_types=True))
    jin = [jnp.asarray(nlist), jnp.asarray(pos4), htf.box_from_lengths(box_l)]
    tin = [torch.as_tensor(nlist), torch.as_tensor(pos4),
           tbox.box_from_lengths(box_l, device="cpu")]
    return jin, tin


class JTrainModel(htf.SimModel):
    """tests/zoo.py's TrainModel."""

    def setup(self, dim, top_neighs):
        self.dense1 = htf.Dense(dim)
        self.dense2 = htf.Dense(dim)
        self.last = htf.Dense(1)
        self.top_neighs = top_neighs

    def compute(self, nlist, positions, training):
        rinv = htf.nlist_rinv(nlist)
        top_n = jnp.sort(rinv, axis=1)[:, ::-1][:, :self.top_neighs]
        energy = self.last(self.dense2(self.dense1(top_n)))
        if training:
            energy = energy * 2
        return htf.compute_nlist_forces(nlist, energy), jnp.sum(energy)


class TTrainModel(htt.SimModel):
    def setup(self, dim, top_neighs):
        self.dense1 = htt.Dense(dim)
        self.dense2 = htt.Dense(dim)
        self.last = htt.Dense(1)
        self.top_neighs = top_neighs

    def compute(self, nlist, positions, training):
        rinv = htt.nlist_rinv(nlist)
        top_n = torch.sort(rinv, dim=1, descending=True)[0][
            :, :self.top_neighs]
        energy = self.last(self.dense2(self.dense1(top_n)))
        if training:
            energy = energy * 2
        return htt.compute_nlist_forces(nlist, energy), torch.sum(energy)


def train_models(optimizer="sgd", lr=1e-2):
    jin, tin = make_inputs()
    jm = JTrainModel(8, dim=4, top_neighs=4)
    jm(jin)
    seed_jax_weights(jm, 3)
    tm = TTrainModel(8, dim=4, top_neighs=4)
    tm(tin)
    load_jax_variables(tm, jm.get_weights())
    jm.compile(optimizer=optimizer, loss=["mse", None], learning_rate=lr)
    tm.compile(optimizer=optimizer, loss=["mse", None], learning_rate=lr)
    return jm, tm, jin, tin


def test_training_flag_changes_output():
    _, tm, _, tin = train_models()
    f_train = tm(tin, training=True)[0]
    f_infer = tm(tin, training=False)[0]
    np.testing.assert_allclose(np_(f_train[:, :3]), 2 * np_(f_infer[:, :3]),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_train_on_batch_matches_jax(optimizer):
    """Five ``train_on_batch`` steps (the model with ``training=True``,
    the loss of its first output, one optimizer step): the losses fall,
    and they and the weights equal the JAX package's."""
    jm, tm, jin, tin = train_models(optimizer, 1e-2)
    labels = np.zeros((9, 4), np.float32)
    lj = [float(jm.train_on_batch(jin, jnp.asarray(labels)))
          for _ in range(5)]
    lt = [float(tm.train_on_batch(tin, torch.as_tensor(labels)))
          for _ in range(5)]
    assert lt[-1] < lt[0]
    np.testing.assert_allclose(lt, lj, rtol=1e-4)
    for a, b in zip(tm.get_weights(), jm.get_weights()):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-6)


def test_train_on_batch_uncompiled_raises():
    _, tin = make_inputs()
    tm = TTrainModel(8, dim=4, top_neighs=4)
    with pytest.raises(ValueError, match="compiled"):
        tm.train_on_batch(tin, torch.zeros((9, 4)))


class JVarModel(htf.SimModel):
    def setup(self):
        self.scale = htf.Variable(0.5, name="scale")
        self.count = htf.Variable(0.0, trainable=False, name="count")

    def compute(self, nlist):
        rinv = htf.nlist_rinv(nlist)
        return htf.compute_nlist_forces(
            nlist, jnp.sum(self.scale.value * rinv ** 6, axis=1))


class TVarModel(htt.SimModel):
    def setup(self):
        self.scale = htt.Variable(0.5, name="scale")
        self.count = htt.Variable(0.0, trainable=False, name="count")

    def compute(self, nlist):
        rinv = htt.nlist_rinv(nlist)
        return htt.compute_nlist_forces(
            nlist, torch.sum(self.scale.value * rinv ** 6, dim=1))


def test_variable_assign_and_order():
    """A Variable on a model's attribute is one of its weights, in the JAX
    package's order; ``assign`` writes in place with no gradient; a
    non-trainable one is not stepped; SGD trains the trainable one as the
    JAX package does."""
    jin, tin = make_inputs()
    jm, tm = JVarModel(8), TVarModel(8)
    assert len(tm.variables) == len(jm.variables) == 4
    assert isinstance(tm.scale.value, torch.nn.Parameter)
    assert not tm.count.trainable and tm.count.value.requires_grad is False
    tm.scale.assign(0.75)
    jm.scale.assign(0.75)
    assert float(tm.scale.value) == 0.75 and tm.scale.value.requires_grad
    np.testing.assert_array_equal(np.asarray(tm.get_weights()[2]), 0.75)
    assert tm.scale * 2.0 == 1.5 and float(2.0 - tm.scale) == 1.25
    load_jax_variables(tm, jm.get_weights())
    for m in (jm, tm):
        m.compile(optimizer="sgd", loss="mse", learning_rate=1e-2)
    labels = np.zeros((9, 4), np.float32)
    for _ in range(3):
        lj = float(jm.train_on_batch(jin, jnp.asarray(labels)))
        lt = float(tm.train_on_batch(tin, torch.as_tensor(labels)))
    np.testing.assert_allclose(lt, lj, rtol=1e-4)
    for a, b in zip(tm.get_weights(), jm.get_weights()):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-7)
    assert float(tm.count.value) == 0.0


def test_constraints_apply_after_each_step():
    """TrainableLJ's ``nonneg`` constraints: labels that pull epsilon
    below zero leave it at exactly 0 after each step (and sigma moves as
    in the JAX package)."""
    jin, tin = make_inputs(r_cut=3.0)
    jm, tm = htf.TrainableLJ(8), htt.TrainableLJ(8)
    assert tm.variable_constraints[2] is not None
    out = np.asarray(jm(jin)[0])
    labels = -10.0 * out
    for m in (jm, tm):
        m.compile(optimizer="sgd", loss="mse", learning_rate=10.0)
    for _ in range(2):
        jm.train_on_batch(jin, jnp.asarray(labels))
        tm.train_on_batch(tin, torch.as_tensor(labels))
        assert float(tm.eps) == 0.0 == float(jm.eps.value)
    np.testing.assert_allclose(float(tm.sig), float(jm.sig.value),
                               rtol=1e-4)


def test_trainable_lj_trains_online_with_constraints():
    """TrainableLJ attached with ``train=True`` on 'cellwise' (the probe
    validates it: the lane route): three SGD steps equal the JAX
    package's, with the constraints applied each step."""
    pos, vel, lengths = fluid_arrays(256, 0.4, 1, kT=1.5)
    js = jax_state(pos, vel, lengths)
    out = []
    for pkg in (htf, htt):
        kw = {} if pkg is htf else {"device": "cpu"}
        sim = pkg.Simulation(dt=0.005, integrator=pkg.md.NVT(kT=1.5,
                                                             tau=0.5),
                             seed=1, **kw)
        sim.set_state(js if pkg is htf else state_from_numpy(
            jax_state_numpy(js), device="cpu"))
        sim.add_force(pkg.md.LennardJones(r_cut=R_CUT))
        m = pkg.TrainableLJ(64, output_forces=False, epsilon=0.5, sigma=1.1)
        m.compile(optimizer="sgd", loss="mse", learning_rate=1e-4)
        tfc = pkg.tfcompute(m)
        tfc.attach(sim, r_cut=R_CUT, nlist="cellwise", train=True)
        sim.run(3)
        out.append((list(tfc.loss_history),
                    [float(np.asarray(w)) for w in m.get_weights()[2:]],
                    bool(tfc._lane_fast_ok)))
    (lj, wj, okj), (lt, wt, okt) = out
    assert okj and okt
    np.testing.assert_allclose(lt, lj, rtol=1e-3)
    np.testing.assert_allclose(wt, wj, rtol=1e-4)
    assert wt[0] != 0.5 and min(wt) >= 0.0
