"""The port's example scripts (``examples/torch/``) on the CPU: each
example's model against its JAX twin (``examples/``) on the same seeded
inputs, with the JAX weights carried into the port's model, and every
script's ``main(device="cpu")`` with its own asserts as the gate."""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hoomd_tf_tpu_torch as htt
from hoomd_tf_tpu_torch.interop import build_model, load_jax_variables

from torch_helpers import fluid_arrays

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
NAMES = ["01_quickstart", "02_mapped_cg_simulation", "03_eds_biasing",
         "04_particle_simulations", "05_running_from_trajectory",
         "06_force_matching", "07_cg_mapping_from_files",
         "08_nbody_neural_force_field", "09_cg_properties",
         "10_cg_force_matching", "11_external_models"]
TOL = dict(rtol=1e-4, atol=1e-4)


def load(name, port=True):
    """An example script as a module (its ``__main__`` block not run)."""
    path = os.path.join(EXAMPLES, "torch" if port else "", name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"_example_{'torch' if port else 'jax'}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def inputs(n=64, density=0.4, nn=32, r_cut=3.0, seed=0):
    """One fluid's ``[nlist, positions, box]`` as numpy (the port's dense
    list, nearest first, the neighbor index in the last channel), for
    both packages."""
    pos, _, lengths = fluid_arrays(n, density, seed)
    pos4 = np.concatenate([pos, np.zeros((n, 1), np.float32)], axis=1)
    nlist = htt.compute_nlist(torch.as_tensor(pos4), r_cut, nn,
                              torch.as_tensor(lengths, dtype=torch.float32),
                              sorted=True, device="cpu")
    box = np.array([-lengths / 2, lengths / 2, [0, 0, 0]], np.float32)
    return [nlist.numpy(), pos4, box]


def run_both(jm, tm, x):
    jo = jm([jnp.asarray(a) for a in x])
    to = tm([torch.as_tensor(a) for a in x])
    jo = jo if isinstance(jo, (list, tuple)) else [jo]
    to = to if isinstance(to, (list, tuple)) else [to]
    return [np.asarray(a) for a in jo], [b.detach().numpy() for b in to]


def carry(jm, tm, x, r_cut=3.0):
    """Build both models on ``x`` and copy the JAX weights into the
    port's."""
    jm([jnp.asarray(a) for a in x])
    build_model(tm, r_cut, "cpu", rows=x[0].shape[0])
    load_jax_variables(tm, jm.get_weights())


# the RDF's bins: the two packages round r/width apart by a few float32
# ulps of hi / width (tests/test_torch_rdf.py's bar)
RDF_RTOL = 4 * 2.0 ** -23 * 3.0 / (2.5 / 100)


@pytest.mark.parametrize("name,cls,args,density", [
    ("01_quickstart", "LJModel", (32,), 0.4),
    ("04_particle_simulations", "WCARDF", (32,), 0.9),
    ("06_force_matching", "TrainableLJ", (32,), 0.4),
])
def test_model_forces_match_jax(name, cls, args, density):
    """01's LJModel, 04's WCARDF (forces and the RDF it accumulates; at
    density 0.9 pairs fall inside its 2^(1/6) 0.9 cut) and 06's
    TrainableLJ (eps 0.8, sig 1.1) against their JAX twins."""
    x = inputs(density=density)
    jm = getattr(load(name, port=False), cls)(*args)
    tm = getattr(load(name), cls)(*args)
    carry(jm, tm, x)
    jo, to = run_both(jm, tm, x)
    np.testing.assert_allclose(to[0], jo[0], **TOL)
    assert np.abs(jo[0]).max() > 0
    if name.startswith("04"):
        np.testing.assert_allclose(
            tm.avg_rdf.result().detach().numpy(),
            np.asarray(jm.avg_rdf.result()), rtol=RDF_RTOL)


def test_06_train_step_matches_jax():
    """06's fit: one Adam step (2e-2) on the same frame and labels moves
    eps and sig as the JAX model's step does."""
    x = inputs(seed=3)
    labels = np.random.RandomState(3).randn(64, 3).astype(np.float32)
    jm = load("06_force_matching", port=False).TrainableLJ(32)
    tm = load("06_force_matching").TrainableLJ(32)
    carry(jm, tm, x)
    jm.compile(optimizer="adam", loss="mse", learning_rate=2e-2)
    tm.compile(optimizer="adam", loss="mse", learning_rate=2e-2)
    for _ in range(3):
        jl = jm.train_on_batch([jnp.asarray(a) for a in x],
                               jnp.asarray(labels))
        tl = tm.train_on_batch([torch.as_tensor(a) for a in x],
                               torch.as_tensor(labels))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    np.testing.assert_allclose(float(tm.eps.value.detach()),
                               float(jm.eps.value), rtol=1e-5)
    np.testing.assert_allclose(float(tm.sig.value.detach()),
                               float(jm.sig.value), rtol=1e-5)


def test_05_rdf_matches_jax(tmp_path):
    """05's RDFModel over a trajectory file: the port's trajectory RDF on
    the port's universe against the JAX model's on the JAX universe."""
    from hoomd_tf_tpu.utils.gsd_io import GSDUniverse as JUniverse
    import hoomd_tf_tpu as htf
    port = load("05_running_from_trajectory")
    rng = np.random.RandomState(5)
    pos, _, lengths = fluid_arrays(64, 0.4, 5)
    frames = [{"positions": (pos + 0.05 * rng.randn(*pos.shape)).astype(
        np.float32), "typeid": np.zeros(64, np.uint32)} for _ in range(3)]
    path = str(tmp_path / "t.gsd")
    htt.write_gsd_frames(path, frames, box=lengths)
    rdf, rs = port.trajectory_rdf(path, device="cpu")
    jm = load("05_running_from_trajectory", port=False).RDFModel(32)
    for x, _ in htf.iter_from_trajectory(32, JUniverse(path), r_cut=3.0):
        jm(x)
    want = np.asarray(jm.avg_rdf.result())
    np.testing.assert_allclose(rdf, want, rtol=RDF_RTOL)
    assert want.sum() > 0
    port.check_rdf(rdf, rs)


def test_08_nn_potential_matches_jax():
    """08's NNPotential (RBF, Dense + tanh, Dense) with the JAX weights:
    the same forces."""
    x = inputs(nn=32)
    jm = load("08_nbody_neural_force_field", port=False).NNPotential(32)
    tm = load("08_nbody_neural_force_field").NNPotential(32)
    carry(jm, tm, x)
    jo, to = run_both(jm, tm, x)
    np.testing.assert_allclose(to[0], jo[0], **TOL)
    assert np.abs(jo[0]).max() > 0


def test_11_mlp_matches_flax():
    """11's torch MLP with the flax module's parameters carried by
    ``interop.sequential_params_from_flax``: the same forces; and the
    MLP's weights are the SimModel's trainables."""
    pytest.importorskip("flax")
    from hoomd_tf_tpu_torch.interop import sequential_params_from_flax
    x = inputs(nn=32)
    jm = load("11_external_models", port=False).FlaxPotential(32)
    tm = load("11_external_models").TorchMLPPotential(32)
    params = jax.tree_util.tree_map(np.asarray, jm._flax_params())
    carried = sequential_params_from_flax(params)
    assert set(carried) == {n for n, _ in tm._names}
    for name, attr in tm._names:
        getattr(tm, attr).assign(torch.from_numpy(carried[name].copy()))
    assert len(tm.trainable_weights()) == 6
    assert [tuple(p.shape) for p in tm.trainable_weights()] == \
        [tuple(p.shape) for p in tm.mlp.parameters()]
    jo, to = run_both(jm, tm, x)
    np.testing.assert_allclose(to[0], jo[0], **TOL)
    assert np.abs(jo[0]).max() > 0


@pytest.mark.parametrize("name", NAMES)
def test_main_on_cpu(name, monkeypatch):
    """Each script's ``main(device="cpu")``: its asserts are the gate."""
    monkeypatch.setattr(sys, "argv", [name + ".py"])
    torch.manual_seed(0)
    load(name).main(device="cpu")
