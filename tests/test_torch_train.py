"""Online training on the port against the JAX package: the same starting
state (``interop.state_from_numpy``) and the same NN weights
(``interop.load_jax_variables``), through ``tfcompute.attach(train=True)``
and ``Simulation.run``; plus the optimizer mapping, the energy probe and
the rollback of a retried run.

Tolerances: one train step's loss at rtol 1e-4 and its weight gradients
at rtol 2e-4, atol 2e-5 max|g| (the JAX package's bar for its proxy
backward); a 5-step SGD trajectory's losses and weights at rtol 1e-3 (a
float32 trajectory summed in another order drifts, so trajectories are
compared with SGD over few steps; Adam's first steps are about lr *
sign(g), which a near-zero gradient can flip); the port's Adam against
optax.adam on given gradients at rtol 1e-6."""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import hoomd_tf_tpu as htf
from hoomd_tf_tpu.md.simulation import _loss_consumes_energy as j_probe
import hoomd_tf_tpu_torch as htt
from hoomd_tf_tpu_torch.interop import (build_model, load_jax_variables,
                                        state_from_numpy)
from hoomd_tf_tpu_torch.md.simulation import _loss_consumes_energy as t_probe
from hoomd_tf_tpu_torch.ops import pair_train_cuda as tptc

from torch_helpers import (fluid_arrays, force_loss, jax_state,
                           jax_state_numpy, nn_pair_class, np_,
                           quenched_state, seed_jax_weights, train_sim)

R_CUT = 2.5


class JNNPair(htf.PairModel):
    """north_star.py's TrainableNNPair (JAX)."""

    def setup(self):
        self.dense1 = htf.Dense(16)
        self.last = htf.Dense(1)

    def pair_energy(self, r2):
        x = jax.nn.tanh(self.dense1(jax.lax.rsqrt(r2)[..., None]))
        return 2.0 * self.last(x)[..., 0]


def j_force_loss(yt, yp):
    return jnp.mean((yt[:, :3] - yp[:, :3]) ** 2)


def trainer_pair(optimizer, lr, n=512, seed=1, weight_seed=0):
    """A JAX and a port simulation from the same state and NN weights,
    each training online against its built-in LJ: ``(jsim, jtfc, jm),
    (tsim, ttfc, tm)``."""
    pos, vel, lengths = fluid_arrays(n, 0.4, seed, kT=1.5)
    js = jax_state(pos, vel, lengths)
    jsim = htf.Simulation(dt=0.005, integrator=htf.md.NVT(kT=1.5, tau=0.5),
                          seed=seed)
    jsim.set_state(js)
    jsim.add_force(htf.md.LennardJones(r_cut=R_CUT))
    jm = JNNPair(64, output_forces=False, proxy_degree=16)
    jm.pair_energy(jnp.ones(4))
    seed_jax_weights(jm, weight_seed)
    jm.compile(optimizer=optimizer, loss=j_force_loss, learning_rate=lr)
    jtfc = htf.tfcompute(jm)
    jtfc.attach(jsim, r_cut=R_CUT, nlist="cellwise", train=True)

    tsim = htt.Simulation(dt=0.005, integrator=htt.md.NVT(kT=1.5, tau=0.5),
                          seed=seed, device="cpu")
    tsim.set_state(state_from_numpy(jax_state_numpy(js), device="cpu"))
    tsim.add_force(htt.md.LennardJones(r_cut=R_CUT))
    tm = nn_pair_class()(64, output_forces=False, proxy_degree=16)
    build_model(tm, R_CUT, "cpu")
    load_jax_variables(tm, jm.get_weights())
    tm.compile(optimizer=optimizer, loss=force_loss, learning_rate=lr)
    ttfc = htt.tfcompute(tm)
    ttfc.attach(tsim, r_cut=R_CUT, nlist="cellwise", train=True)
    return (jsim, jtfc, jm), (tsim, ttfc, tm)


def trainable(weights):
    """The four NN weights (the list starts with SimModel's two
    bookkeeping variables)."""
    return [np.asarray(w, np.float64) for w in weights[2:]]


def test_one_train_step_matches_jax():
    """One SGD step from the same state and weights: the loss, and the
    weight gradient read off the update (``(w0 - w1) / lr``; lr 1, so the
    float32 rounding of the weights, ~3e-8, stays far below the bar).
    Each package evaluates its own NN at the proxy's nodes, and their tanh
    and rsqrt differ in the last bit, which the derivative series
    magnifies: over six weight draws the worst gradient element came to
    0.4-2.0 of the bar; this draw's is 0.67."""
    lr = 1.0
    (jsim, jtfc, jm), (tsim, ttfc, tm) = trainer_pair("sgd", lr)
    w0 = trainable(jm.get_weights())
    jsim.run(1)
    tsim.run(1)
    assert len(ttfc.loss_history) == len(jtfc.loss_history) == 1
    np.testing.assert_allclose(ttfc.loss_history[0], jtfc.loss_history[0],
                               rtol=1e-4)
    g_j = [(a - b) / lr for a, b in zip(w0, trainable(jm.get_weights()))]
    g_t = [(a - b) / lr for a, b in zip(w0, trainable(tm.get_weights()))]
    scale = max(np.abs(g).max() for g in g_j)
    for a, b in zip(g_t, g_j):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5 * scale)
    assert tsim.train_steps == 1
    assert tptc.proxy_bwd_moments.launches == 0      # plain version on CPU


def test_sgd_trajectory_matches_jax():
    (jsim, jtfc, jm), (tsim, ttfc, tm) = trainer_pair("sgd", 1e-3)
    jsim.run(5)
    tsim.run(5)
    np.testing.assert_allclose(ttfc.loss_history, jtfc.loss_history,
                               rtol=1e-3)
    # atol: the last bias only shifts the energy, so the force loss gives
    # it a gradient of float32 noise (it stays within 1e-8 of zero)
    for a, b in zip(trainable(tm.get_weights()), trainable(jm.get_weights())):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-6)
    # the dynamics are the built-in LJ's alone, as in the JAX package
    np.testing.assert_allclose(np_(tsim.state.velocities),
                               np_(jsim.state.velocities), rtol=1e-2,
                               atol=2e-3)


def test_adam_matches_optax():
    """The port's 'adam' (torch.optim.Adam) against optax.adam on the same
    gradients, three steps."""
    rng = np.random.RandomState(0)
    shapes = [(1, 16), (16,), (16, 1), (1,)]
    w = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rng.randn(*s).astype(np.float32) * 10.0 ** -k for s in shapes]
             for k in range(3)]
    model = nn_pair_class()(16)
    model.compile(optimizer="adam", learning_rate=1e-2)
    params = [torch.nn.Parameter(torch.tensor(a)) for a in w]   # copies
    opt = model._optimizer(params)
    assert isinstance(opt, torch.optim.Adam)
    tx = optax.adam(1e-2)
    jw = [jnp.asarray(a) for a in w]
    state = tx.init(jw)
    for g in grads:
        for p, gi in zip(params, g):
            p.grad = torch.as_tensor(gi)
        opt.step()
        upd, state = tx.update([jnp.asarray(gi) for gi in g], state, jw)
        jw = optax.apply_updates(jw, upd)
    for p, b in zip(params, jw):
        np.testing.assert_allclose(np_(p), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("loss,consumes", [("mse", True),
                                           ("forces", False)])
def test_loss_consumes_energy(loss, consumes):
    """'mse' on [N, 4] reads the energy column; force matching on
    ``[:, :3]`` does not, and training then drops the energy lanes."""
    jm, tm = JNNPair(16), nn_pair_class()(16)
    jm.compile(loss=j_force_loss if loss == "forces" else loss)
    tm.compile(loss=force_loss if loss == "forces" else loss)
    assert t_probe(tm) is consumes
    assert j_probe(jm) is consumes


def _train_state(sim, model):
    opt = sim.tfc.opt_state
    return ([w.copy() for w in model.get_weights()],
            {k: {n: np_(v).copy() for n, v in st.items()}
             for k, st in opt.state_dict()["state"].items()})


def _assert_same_train_state(a, b):
    for x, y in zip(a[0], b[0]):
        np.testing.assert_array_equal(x, y)
    assert a[1].keys() == b[1].keys()
    for k in a[1]:
        for n in a[1][k]:
            np.testing.assert_array_equal(a[1][k][n], b[1][k][n])


@pytest.mark.parametrize("allow_retry", [True, False],
                         ids=["retried", "last_attempt"])
def test_retry_restores_weights_and_optimizer_state(allow_retry):
    """A rolled-back attempt (staleness) commits no training, whether it
    is retried or is the last and raises: the weights and Adam's moments
    and step count are what they were before it, and the loss history has
    no entry of it."""
    sim, tfc, model = train_sim(quenched_state(256))
    sim.run(3)
    before = _train_state(sim, model)
    assert before[1] and len(tfc.loss_history) == 3
    sim._vmax_now = lambda: 1e-4          # the interval estimate lies
    sim.thermalize_velocities(3.0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if allow_retry:
            assert sim._run_once(200, allow_retry=True) is False
        else:
            with pytest.raises(ValueError, match="skin/2"):
                sim._run_once(200, allow_retry=False)
    assert sim.train_steps > 3
    _assert_same_train_state(_train_state(sim, model), before)
    assert len(tfc.loss_history) == 3


def test_retried_run_commits_like_a_clean_one():
    """A capacity overflow rolls the run back and replans; the committed
    training equals a clean run's from the same start on the plan the
    retry ended with (SGD, rtol 1e-4). The loss averages over slot rows,
    ghosts included, as the JAX package's does, so it depends on the
    capacity (ROADMAP.md Queue 3)."""
    state = quenched_state(256)
    runs = []
    capacity = 4
    for _ in range(2):
        sim, tfc, model = train_sim(state, optimizer="sgd", lr=1e-3,
                                    nlist=htt.Cellwise(capacity=capacity),
                                    weights=runs[0][1] if runs else None)
        w0 = model.get_weights()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            sim.run(5)
        runs.append((list(tfc.loss_history), w0, model.get_weights(),
                     sim.train_steps, sim._layout.plan))
        capacity = sim._layout.plan.capacity
    (l_retry, _, w_retry, n_retry, p_retry), \
        (l_clean, _, w_clean, n_clean, p_clean) = runs
    assert n_retry > n_clean == 5 and len(l_retry) == 5
    assert p_retry == p_clean
    np.testing.assert_allclose(l_retry, l_clean, rtol=1e-4)
    for a, b in zip(w_retry, w_clean):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-7)


def test_train_knobs_and_rejections():
    sim, tfc, model = train_sim(quenched_state(256))
    assert tfc.train and tfc.output_offset == 0
    assert model.loss == [force_loss]
    assert isinstance(tfc.ensure_opt_state(), torch.optim.Adam)
    assert tfc.ensure_opt_state() is tfc.opt_state
    tfc.set_reference_forces(sim.forces[0])
    with pytest.raises(ValueError, match="simulation force"):
        tfc.set_reference_forces(htt.md.LennardJones(r_cut=R_CUT))
    sim.run(2)
    assert len(tfc.loss_history) == 2 and np.isfinite(tfc.loss_history).all()
    uncompiled = nn_pair_class()(16, proxy_degree=8)
    with pytest.raises(AttributeError, match="loss"):
        htt.tfcompute(uncompiled).attach(sim, r_cut=R_CUT,
                                         nlist="cellwise", train=True)
    # labels need a built-in force
    bare = htt.Simulation(device="cpu")
    bare.set_state(dataclasses.replace(sim.state, thermostat={}))
    m = nn_pair_class()(16, proxy_degree=8)
    m.compile(loss=force_loss)
    htt.tfcompute(m).attach(bare, r_cut=R_CUT, nlist="cellwise", train=True)
    with pytest.raises(ValueError, match="label forces"):
        bare.run(1)
