"""The port's ``serialize``: models saved as ``(class name, config,
weights)`` and loaded through the ``custom_objects`` registry give the same
outputs; a checkpoint restores the weights, the optimizer, the state and
the generator, and a resumed run continues bit for bit as the
uninterrupted one (tests/test_fp64.py::TestCheckpointF64, ported, and the
exact resume the JAX package's serialize claims). All on the CPU, with
JAX only for the checkpoint of a JAX float64 model's weights."""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hoomd_tf_tpu as htf
import hoomd_tf_tpu_torch as htt
from hoomd_tf_tpu_torch import serialize as ts
from hoomd_tf_tpu_torch.interop import build_model, load_jax_variables

from torch_helpers import (fluid_arrays, force_loss, nn_pair_class, np_,
                           seed_jax_weights)

F64 = torch.float64
NN = 16


class TLJPair(htt.PairModel):
    def pair_energy(self, r2):
        u = 1.0 / r2
        sr6 = u * u * u
        return 4.0 * (sr6 * sr6 - sr6)


class TLJMol(htt.MolSimModel):
    """tests/zoo.py's LJMolModel."""

    def mol_compute(self, nlist, positions, mol_nlist, mol_positions, box):
        rinv = htt.nlist_rinv(mol_nlist)
        total_e = torch.sum(4.0 / 2.0 * (rinv ** 12 - rinv ** 6))
        return htt.compute_nlist_forces(nlist, total_e)


def inputs(n=120, dtype=torch.float32):
    """A packed list of a jittered fluid: ``[nlist, positions4, box]``."""
    pos, _, lengths = fluid_arrays(n, 0.35, 2)
    pos4 = np.concatenate([pos, (np.arange(n) % 2)[:, None]], axis=1)
    p4 = torch.as_tensor(pos4, dtype=dtype)
    nl = htt.compute_nlist(p4, 2.5, NN, torch.as_tensor(lengths, dtype=dtype),
                           sorted=True, return_types=True, device="cpu")
    return [nl, p4, htt.box_from_lengths(lengths, dtype=dtype, device="cpu")]


def make(kind, dtype=torch.float32):
    """A model of a built-in class (or a subclass passed by
    ``custom_objects``), its lazy layers built, with non-default
    weights."""
    if kind == "LJPotential":
        m = htt.LJPotential(NN, virial=True, epsilon=0.7, sigma=1.1,
                            dtype=dtype)
    elif kind == "TrainableLJ":
        m = htt.TrainableLJ(NN, epsilon=0.8, sigma=0.95, dtype=dtype)
    elif kind == "NeuralPairPotential":
        m = htt.NeuralPairPotential(NN, hidden=8, layers=1, count=8,
                                    dtype=dtype)
    elif kind == "PairModel":
        m = TLJPair(NN, dtype=dtype)
    else:
        m = TLJMol(3, [list(range(i, i + 3)) for i in range(0, 120, 3)],
                   NN, dtype=dtype)
    build_model(m, 2.5, "cpu", rows=120)
    rng = np.random.RandomState(3)
    m.set_weights([w + 0.1 * rng.randn(*np.shape(w)).astype(w.dtype)
                   if np.issubdtype(np.asarray(w).dtype, np.floating)
                   and np.ndim(w) else w for w in m.get_weights()])
    return m


@pytest.mark.parametrize("kind", ["LJPotential", "TrainableLJ",
                                  "NeuralPairPotential", "PairModel",
                                  "MolSimModel"])
@pytest.mark.parametrize("dtype", [torch.float32, F64])
def test_save_load_model_same_forces(kind, dtype, tmp_path):
    """A save/load of each model class gives the same forces, bit for bit,
    and keeps the weights' dtype; subclasses come back through
    ``custom_objects``."""
    m = make(kind, dtype)
    x = inputs(dtype=dtype)
    path = str(tmp_path / "model.pkl")
    ts.save_model(m, path)
    extra = {"TLJPair": TLJPair, "TLJMol": TLJMol}
    if kind in ("PairModel", "MolSimModel"):
        with pytest.raises(ValueError, match="custom_objects"):
            ts.load_model(path)
    got = ts.load_model(path, custom_objects_arg=extra,
                        build_inputs=x if kind == "NeuralPairPotential"
                        else None)
    assert type(got) is type(m) and got.dtype == dtype
    for a, b in zip(got.get_weights(), m.get_weights()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got(x), m(x)):
        assert torch.equal(a, b)


def test_save_load_layers(tmp_path):
    """The built-in layers round-trip too: Dense, RBFExpansion and
    WCARepulsion give the same outputs, EDSLayer the same state."""
    x = torch.as_tensor(np.random.RandomState(0).rand(5, 3),
                        dtype=torch.float32)
    nl = inputs()[0]
    dense = htt.Dense(4)
    dense(x)
    layers = [(dense, x), (htt.RBFExpansion(0.0, 2.5, 6), x),
              (htt.WCARepulsion(0.9), nl)]
    for i, (layer, arg) in enumerate(layers):
        path = str(tmp_path / f"layer{i}.pkl")
        ts.save_model(layer, path)
        got = ts.load_model(path, build_inputs=arg if layer is dense
                            else None)
        assert torch.equal(got(arg), layer(arg))
    eds = htt.EDSLayer(1.5, 10, learning_rate=0.1)
    eds(torch.tensor(1.0))
    path = str(tmp_path / "eds.pkl")
    ts.save_model(eds, path)
    got = ts.load_model(path, build_inputs=torch.tensor(0.0))
    for a, b in zip(got.get_weights(), eds.get_weights()):
        np.testing.assert_array_equal(a, b)
    assert set(ts.custom_objects) >= {
        "RBFExpansion", "WCARepulsion", "EDSLayer", "Dense", "SimModel",
        "MolSimModel", "PairModel", "LJPotential", "TrainableLJ",
        "NeuralPairPotential"}
    assert htt.save_model is ts.save_model and \
        htt.custom_objects is ts.custom_objects


def fluid64(integrator, kT=1.5, n=216, nlist="cellwise"):
    sim = htt.Simulation(dt=0.004, integrator=integrator, seed=3,
                         device="cpu")
    sim.init_lattice(n, density=0.35, kT_init=kT, dtype=F64)
    rng = np.random.RandomState(3)
    sim.set_state(dataclasses.replace(
        sim.state, positions=sim.state.positions + 0.2 * torch.as_tensor(
            rng.uniform(-1, 1, (n, 3)))))
    model = TLJPair(64, dtype=F64)
    tfc = htt.tfcompute(model)
    tfc.attach(sim, r_cut=2.5, nlist=nlist)
    return sim, model, tfc


def test_checkpoint_roundtrip_exact(tmp_path):
    """tests/test_fp64.py::TestCheckpointF64: a float64 'cellwise' run
    under NVT, checkpointed, run on, restored: the positions are the
    saved ones, at float64."""
    sim, model, tfc = fluid64(htt.md.NVT(kT=0.8, tau=0.5), kT=0.8)
    sim.run(20)
    path = str(tmp_path / "ckpt64.pkl")
    ts.save_checkpoint(path, model=model, sim=sim, tfc=tfc, extra={"a": 1})
    saved = np_(sim.state.positions).copy()
    assert saved.dtype == np.float64
    sim.run(20)
    assert ts.load_checkpoint(path, model=model, sim=sim, tfc=tfc) == \
        {"a": 1}
    restored = np_(sim.state.positions)
    assert restored.dtype == np.float64
    np.testing.assert_array_equal(restored, saved)
    assert sim.state.step == 20


@pytest.mark.parametrize("integrator", ["nvt", "langevin"])
@pytest.mark.parametrize("nlist", ["cellwise", "cell"])
def test_exact_resume(integrator, nlist, tmp_path):
    """save_checkpoint, run(20), load_checkpoint, run(20): the resumed
    run's positions are bit-equal to the first continuation's, under NVT
    and under Langevin (whose noise comes from the restored generator).
    The run is warmed past the planner's first re-plan check, so the
    slot order the next run starts from is the engine's own, not a fresh
    pack's: the checkpoint restores it."""
    integ = (htt.md.NVT(kT=1.5, tau=0.5) if integrator == "nvt" else
             htt.md.Langevin(kT=1.5, gamma=1.0))
    sim, model, tfc = fluid64(integ, nlist=nlist)
    sim.run(150)
    sim.run(50)
    path = str(tmp_path / "ckpt.pkl")
    ts.save_checkpoint(path, model=model, sim=sim, tfc=tfc)
    saved = sim.state.positions.clone()
    sim.run(20)
    first = sim.state.positions.clone()
    ts.load_checkpoint(path, model=model, sim=sim, tfc=tfc)
    assert torch.equal(sim.state.positions, saved)
    sim.run(20)
    assert torch.equal(sim.state.positions, first)
    assert sim.state.step == 220


def test_training_checkpoint_resumes_optimizer(tmp_path):
    """Online training (the proxy NN, Adam): a checkpoint keeps the
    weights and the optimizer's state; the resumed training's losses and
    weights equal the uninterrupted run's bit for bit."""
    sim = htt.Simulation(dt=0.005, integrator=htt.md.NVT(kT=1.5, tau=0.5),
                         seed=1, device="cpu")
    sim.init_lattice(216, density=0.4, kT_init=1.5)
    sim.add_force(htt.md.LennardJones(r_cut=2.5))
    model = nn_pair_class()(64, output_forces=False, proxy_degree=16)
    model.compile(optimizer="adam", loss=force_loss, learning_rate=1e-2)
    tfc = htt.tfcompute(model)
    tfc.attach(sim, r_cut=2.5, nlist="cellwise", train=True)
    sim.run(3)
    path = str(tmp_path / "train.pkl")
    ts.save_checkpoint(path, model=model, sim=sim, tfc=tfc)
    sim.run(3)
    losses, weights = list(tfc.loss_history[3:]), model.get_weights()
    ts.load_checkpoint(path, model=model, sim=sim, tfc=tfc)
    del tfc.loss_history[3:]
    sim.run(3)
    assert tfc.loss_history[3:] == losses
    for a, b in zip(model.get_weights(), weights):
        np.testing.assert_array_equal(a, b)


class JNNPair64(htf.PairModel):
    """north_star.py's TrainableNNPair (JAX), its layers in float64."""

    def setup(self):
        self.dense1 = htf.Dense(16, dtype=jnp.float64)
        self.last = htf.Dense(1, dtype=jnp.float64)

    def pair_energy(self, r2):
        x = jax.nn.tanh(self.dense1(jax.lax.rsqrt(r2)[..., None]))
        return 2.0 * self.last(x)[..., 0]


class TNNPair64(htt.PairModel):
    def setup(self):
        self.dense1 = htt.Dense(16, dtype=F64)
        self.last = htt.Dense(1, dtype=F64)

    def pair_energy(self, r2):
        x = torch.tanh(self.dense1(torch.rsqrt(r2)[..., None]))
        return 2.0 * self.last(x)[..., 0]


def test_jax_float64_weights_carried_exactly(tmp_path):
    """A JAX x64 model's float64 weights enter a float64 port model without
    rounding (interop), and survive its save/load with its forces."""
    jax.config.update("jax_enable_x64", True)
    try:
        jm = JNNPair64(NN, dtype=jnp.float64)
        jm.pair_energy(jnp.ones(4, jnp.float64))
        seed_jax_weights(jm, 5)
        jw = [np.asarray(w) for w in jm.get_weights()]
    finally:
        jax.config.update("jax_enable_x64", False)
    assert all(w.dtype == np.float64 for w in jw[2:])
    tm = TNNPair64(NN, dtype=F64)
    build_model(tm, 2.5, "cpu")
    load_jax_variables(tm, jw)
    path = str(tmp_path / "nn64.pkl")
    ts.save_model(tm, path)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = ts.load_model(path, custom_objects_arg={"TNNPair64": TNNPair64},
                            build_inputs=inputs(dtype=F64))
    for a, b in zip(got.get_weights(), jw):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    x = inputs(dtype=F64)
    for a, b in zip(got(x), tm(x)):
        assert a.dtype == F64 and torch.equal(a, b)
