"""Online training on 'cellwise' through the public API, port against the
JAX package, for the model kinds slice D adds: a PairModel without a
Chebyshev proxy (north_star.py's TrainableNNPair), a generic SimModel the
lane-separability probe validates (its TrainableNN, reference example
08) and one it rejects (trained by autograd on the planes), each from the
same state (``interop.state_from_numpy``) and weights
(``interop.load_jax_variables``); plus ``period``, the route each
package's probe picks, the list route's plain version in the engine and
the rollback of a too-short generic-form list after optimizer steps.

Tolerances: one SGD step's loss at rtol 1e-4 and its weight gradients
(read off the update at lr 1) at rtol 2e-4, atol 2e-5 max|g| (the JAX
bar for its Pallas backward); 5-step SGD trajectories' losses and weights
at rtol 1e-3, atol 1e-6 (a float32 trajectory summed in another order
drifts; SGD, since Adam's first step is about lr * sign(g))."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hoomd_tf_tpu as htf
import hoomd_tf_tpu_torch as htt
from hoomd_tf_tpu_torch.interop import (build_model, load_jax_variables,
                                        state_from_numpy)
from hoomd_tf_tpu_torch.ops import cellwise_cuda as tcc

from torch_helpers import (fluid_arrays, jax_state, jax_state_numpy, np_,
                           seed_jax_weights)

from test_torch_train_pair import JNN, JNNPair, TNN, TNNPair

R_CUT = 2.5


class JCoupled(JNN):
    """A generic SimModel whose energy couples a particle's lanes (the
    probe rejects it): it trains on the planes."""

    def compute(self, nlist, positions, box):
        rinv = htf.nlist_rinv(nlist)
        x = jax.nn.tanh(self.dense1(rinv[..., None]))
        e = jnp.sum(self.last(x)[..., 0], axis=1)
        e = e * (1.0 + 0.1 * jnp.sum(rinv, axis=1))
        return htf.compute_nlist_forces(nlist, e)[:, :3]


class TCoupled(TNN):
    def compute(self, nlist, positions, box):
        rinv = htt.nlist_rinv(nlist)
        x = torch.tanh(self.dense1(rinv[..., None]))
        e = torch.sum(self.last(x)[..., 0], dim=1)
        e = e * (1.0 + 0.1 * torch.sum(rinv, dim=1))
        return htt.compute_nlist_forces(nlist, e)[:, :3]


def j_force_loss(yt, yp):
    return jnp.mean((yt[:, :3] - yp[:, :3]) ** 2)


def t_force_loss(yt, yp):
    return torch.mean((yt[:, :3] - yp[:, :3]) ** 2)


#: kind -> (JAX model, port model, JAX loss, port loss, the port's branch)
KINDS = {
    "pair": (lambda: JNNPair(64, output_forces=False),
             lambda: TNNPair(64, output_forces=False),
             j_force_loss, t_force_loss, "pair"),
    "lane": (lambda: JNN(64, output_forces=False),
             lambda: TNN(64, output_forces=False), "mse", "mse", "lane"),
    "planes": (lambda: JCoupled(64, output_forces=False),
               lambda: TCoupled(64, output_forces=False), "mse", "mse",
               "planes"),
}


def build_jax(jm):
    if isinstance(jm, htf.PairModel):
        jm.pair_energy(jnp.ones(4))
    else:
        jm([jnp.zeros((1, 4, 4)), jnp.zeros((1, 4)), jnp.zeros((3, 3))])
    return jm


def trainer_pair(kind, optimizer, lr, n=256, seed=1, period=1,
                 stencil="auto"):
    """A JAX and a port simulation from the same state and weights, each
    training ``kind`` online on 'cellwise' against its built-in LJ:
    ``(jsim, jtfc, jm), (tsim, ttfc, tm)``."""
    jmk, tmk, jloss, tloss, _ = KINDS[kind]
    pos, vel, lengths = fluid_arrays(n, 0.4, seed, kT=1.5)
    js = jax_state(pos, vel, lengths)
    jsim = htf.Simulation(dt=0.005, integrator=htf.md.NVT(kT=1.5, tau=0.5),
                          seed=seed)
    jsim.set_state(js)
    jsim.add_force(htf.md.LennardJones(r_cut=R_CUT))
    jm = seed_jax_weights(build_jax(jmk()), 0)
    jm.compile(optimizer=optimizer, loss=jloss, learning_rate=lr)
    jtfc = htf.tfcompute(jm)
    jtfc.attach(jsim, r_cut=R_CUT, nlist="cellwise", train=True,
                period=period)

    tsim = htt.Simulation(dt=0.005, integrator=htt.md.NVT(kT=1.5, tau=0.5),
                          seed=seed, device="cpu")
    tsim.stencil = stencil
    tsim.set_state(state_from_numpy(jax_state_numpy(js), device="cpu"))
    tsim.add_force(htt.md.LennardJones(r_cut=R_CUT))
    tm = tmk()
    build_model(tm, R_CUT, "cpu")
    load_jax_variables(tm, jm.get_weights())
    tm.compile(optimizer=optimizer, loss=tloss, learning_rate=lr)
    ttfc = htt.tfcompute(tm)
    ttfc.attach(tsim, r_cut=R_CUT, nlist="cellwise", train=True,
                period=period)
    return (jsim, jtfc, jm), (tsim, ttfc, tm)


def trainable(weights):
    """The NN's four weights (after SimModel's two bookkeeping ones)."""
    return [np.asarray(w, np.float64) for w in weights[2:]]


def branch(tsim):
    return tsim._route(tsim._layout, *tsim._layout.pack(tsim.state)) \
        .trainer.kind


@pytest.mark.parametrize("kind", list(KINDS))
def test_one_train_step_matches_jax(kind):
    """One SGD step at lr 1 from the same state and weights: the loss,
    and the weights' gradient read off the update."""
    (jsim, jtfc, jm), (tsim, ttfc, tm) = trainer_pair(kind, "sgd", 1.0)
    w0 = trainable(jm.get_weights())
    jsim.run(1)
    tsim.run(1)
    assert branch(tsim) == KINDS[kind][4]
    assert len(ttfc.loss_history) == len(jtfc.loss_history) == 1
    np.testing.assert_allclose(ttfc.loss_history[0], jtfc.loss_history[0],
                               rtol=1e-4)
    g_j = [a - b for a, b in zip(w0, trainable(jm.get_weights()))]
    g_t = [a - b for a, b in zip(w0, trainable(tm.get_weights()))]
    scale = max(np.abs(g).max() for g in g_j)
    assert scale > 0
    for a, b in zip(g_t, g_j):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5 * scale)
    assert tsim.train_steps == 1


@pytest.mark.parametrize("kind", list(KINDS))
def test_sgd_trajectory_matches_jax(kind):
    (jsim, jtfc, jm), (tsim, ttfc, tm) = trainer_pair(kind, "sgd", 1e-3)
    jsim.run(5)
    tsim.run(5)
    np.testing.assert_allclose(ttfc.loss_history, jtfc.loss_history,
                               rtol=1e-3)
    for a, b in zip(trainable(tm.get_weights()), trainable(jm.get_weights())):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-6)
    # the dynamics are the built-in LJ's alone, as in the JAX package
    np.testing.assert_allclose(np_(tsim.state.velocities),
                               np_(jsim.state.velocities), rtol=1e-2,
                               atol=2e-3)


def test_period_gates_training_like_jax():
    """``period=2``: the model trains on the even steps only; the losses
    and the weights after 6 steps equal the JAX package's."""
    (jsim, jtfc, jm), (tsim, ttfc, tm) = trainer_pair("lane", "sgd", 1e-3,
                                                      period=2)
    jsim.run(6)
    tsim.run(6)
    assert len(ttfc.loss_history) == len(jtfc.loss_history) == 3
    assert tsim.train_steps == 3
    np.testing.assert_allclose(ttfc.loss_history, jtfc.loss_history,
                               rtol=1e-3)
    for a, b in zip(trainable(tm.get_weights()), trainable(jm.get_weights())):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("kind", ["pair", "lane"])
def test_list_route_in_the_engine_matches_contraction(kind):
    """``stencil='kernel'`` on the CPU trains through the list route's
    plain versions (the card's route: K1's generic form and the backward
    of its reduction); three SGD steps equal the lane contraction's (the
    CPU oracle) and the JAX package's."""
    runs = []
    for stencil in ("kernel", "auto"):
        (jsim, jtfc, jm), (tsim, ttfc, tm) = trainer_pair(
            kind, "sgd", 1e-3, stencil=stencil)
        tsim.run(3)
        runs.append((ttfc.loss_history, trainable(tm.get_weights())))
    jsim.run(3)
    for losses, weights in runs:
        np.testing.assert_allclose(losses, jtfc.loss_history, rtol=1e-3)
        for a, b in zip(weights, trainable(jm.get_weights())):
            np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-6)
    assert tcc.generic_reduce_bwd.launches == 0


@pytest.mark.parametrize("kind", ["lane", "planes"])
def test_saved_predictions_match_jax(kind):
    """``save_output_period=2`` while training on 'cellwise': every
    second train step's prediction (the model's single output, in slot
    order) is kept, as the JAX package keeps it, the calls counted across
    runs: of run(1) then run(2), the second step's. (Later captures are
    not compared: the trajectories, summed in another order, part.)"""
    (jsim, jtfc, jm), (tsim, ttfc, tm) = trainer_pair(kind, "sgd", 1e-3)
    for sim, tfc in ((jsim, jtfc), (tsim, ttfc)):
        tfc.save_output_period = 2
        sim.run(1)
        assert tfc.outputs is None
        sim.run(2)
    want = [np.asarray(o) for o in jtfc.outputs]
    assert len(ttfc.outputs) == len(want) == 1
    assert ttfc.outputs[0].shape == want[0].shape
    assert want[0].shape[0] == 1
    scale = np.abs(want[0]).max()
    np.testing.assert_allclose(ttfc.outputs[0], want[0], rtol=1e-3,
                               atol=1e-4 * scale)


def _train_state(tsim, model):
    opt = tsim.tfc.opt_state
    return ([w.copy() for w in model.get_weights()],
            {k: {n: np_(v).copy() for n, v in st.items()}
             for k, st in opt.state_dict()["state"].items()})


def test_short_list_rolls_back_weights_and_optimizer_state():
    """A generic-form list too short for the run (flag bit 3), found after
    optimizer steps were taken: the attempt commits nothing (the weights,
    Adam's moments and step count are what they were before it), the list
    grows, and the re-run trains from the same start."""
    (_, _, _), (tsim, ttfc, tm) = trainer_pair("pair", "adam", 1e-2,
                                               stencil="kernel")
    tsim.run(2)
    before = _train_state(tsim, tm)
    steps = tsim.train_steps
    assert before[1] and len(ttfc.loss_history) == 2
    tsim._lanes.budget = 64
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert tsim._run_once(4, allow_retry=True) is False
    assert tsim.train_steps == steps + 4 and tsim.lane_reruns == 1
    after = _train_state(tsim, tm)
    for x, y in zip(after[0], before[0]):
        np.testing.assert_array_equal(x, y)
    for k in before[1]:
        for n in before[1][k]:
            np.testing.assert_array_equal(after[1][k][n], before[1][k][n])
    assert len(ttfc.loss_history) == 2
    tsim.run(4)
    assert len(ttfc.loss_history) == 6 and tsim._lanes.budget > 64


def test_probe_verdicts_of_both_packages():
    """The lane-separability probe under training picks the route: both
    packages' verdicts for TrainableNN and for the coupled model on the
    parity state, printed and pinned (the port leaves out rows within
    2e-5 of the cut, the JAX package compares every row: ROADMAP.md
    Queue 3)."""
    verdicts = {}
    for kind in ("lane", "planes"):
        (jsim, jtfc, _), (tsim, ttfc, _) = trainer_pair(kind, "sgd", 1e-3)
        jsim.run(1)
        tsim.run(1)
        verdicts[kind] = (bool(jtfc._lane_fast_ok), bool(ttfc._lane_fast_ok),
                          ttfc._lane_fast_report.get("rows_at_the_cut"))
    print(f"probe verdicts (JAX, port, port's rows at the cut): {verdicts}")
    assert verdicts["lane"][:2] == (True, True)
    assert verdicts["planes"][:2] == (False, False)


@pytest.mark.parametrize("name", ["NPT", "Langevin", "Brownian"])
def test_remaining_integrators_name_their_item(name):
    """The JAX package's other integrators, refused before the port's
    slice E, now construct with the JAX package's flags (the engine reads
    ``stochastic``, ``changes_box`` and ``needs_virial``); their dynamics
    are held against JAX in tests/test_torch_{stochastic,npt}.py."""
    kw = dict(kT=1.0, tau=0.5, P=1.0) if name == "NPT" else dict(kT=1.0)
    j, t = getattr(htf.md, name)(**kw), getattr(htt.md, name)(**kw)
    for flag in ("stochastic", "changes_box", "needs_virial"):
        assert getattr(t, flag, False) == getattr(j, flag, False), flag
