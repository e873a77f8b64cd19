"""The ready-made potentials and ``RBFExpansion`` of the port against the
JAX package: ``LJPotential``, ``TrainableLJ`` and ``NeuralPairPotential``
(hidden 8, one layer), their weights carried by ``interop``, on the same
packed neighbor list and on the same planes. Forces, per-particle
energies and virials within 1e-5 (relative to the largest force for the
absolute part): float32 with a different summation order."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import hoomd_tf_tpu as htf
from hoomd_tf_tpu.ops.direct import direct_cell_planes as jdirect
import hoomd_tf_tpu_torch as htt
from hoomd_tf_tpu_torch.interop import build_model, load_jax_variables
from hoomd_tf_tpu_torch.ops import cell_list as tcl
from hoomd_tf_tpu_torch.ops.direct import NlistPlanes

from torch_helpers import fluid_arrays, np_, seed_jax_weights

NN = 48


def _inputs(form, n=250, seed=0):
    """The same system as JAX and port model inputs: ``(jax_inputs,
    port_inputs)`` on a packed list or planes."""
    pos, _, lengths = fluid_arrays(n, 0.35, seed)
    pos4 = np.concatenate([pos, (np.arange(n) % 2)[:, None]], 1)
    pos4 = pos4.astype(np.float32)
    lengths = np.asarray(lengths, np.float32)
    jbox = htf.box_from_lengths(lengths)
    tbox = htt.ops.box_from_lengths(lengths, device="cpu")
    if form == "packed":
        jl = htf.compute_nlist(jnp.asarray(pos4), 2.5, NN, lengths,
                               sorted=True, return_types=True)
        tl = torch.as_tensor(np.array(jl))
    else:
        grid, cap = tcl.plan(n, lengths, 2.5)
        cap = max(cap, tcl.max_occupancy(pos4, lengths, grid))
        jl, _ = jdirect(jnp.asarray(pos4), 2.5, grid, cap,
                        jnp.asarray(lengths))
        tl = NlistPlanes(*(torch.as_tensor(np.array(c)) for c in jl))
    return ([jl, jnp.asarray(pos4), jbox],
            [tl, torch.as_tensor(pos4), tbox])


def _pair(kind, virial):
    if kind == "lj":
        return (htf.LJPotential(NN, virial=virial, epsilon=0.7, sigma=1.1),
                htt.LJPotential(NN, virial=virial, epsilon=0.7, sigma=1.1))
    if kind == "trainable":
        return (htf.TrainableLJ(NN, virial=virial, epsilon=0.8, sigma=0.95),
                htt.TrainableLJ(NN, virial=virial, epsilon=0.8, sigma=0.95))
    kw = dict(hidden=8, layers=1, count=8)
    return (htf.NeuralPairPotential(NN, virial=virial, **kw),
            htt.NeuralPairPotential(NN, virial=virial, **kw))


@pytest.mark.parametrize("kind", ["lj", "trainable", "nn"])
@pytest.mark.parametrize("form", ["packed", "planes"])
def test_potential_matches_jax(kind, form):
    jm, tm = _pair(kind, virial=True)
    jin, tin = _inputs(form)
    jm.ensure_built([jnp.zeros((1, NN, 4)), jnp.zeros((1, 4)),
                     jnp.zeros((3, 3))])
    if kind == "nn":
        seed_jax_weights(jm, seed=5)
    build_model(tm, 2.5, device="cpu")
    load_jax_variables(tm, jm.get_weights())
    jf, jw = jm(jin)
    tf, tw = tm(tin)
    scale = float(np.abs(np.asarray(jf)[:, :3]).max())
    assert scale > 1e-3
    np.testing.assert_allclose(np_(tf), np.asarray(jf), rtol=1e-5,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(np_(tw), np.asarray(jw), rtol=1e-5,
                               atol=1e-5 * scale)


def test_weights_line_up_with_jax():
    """The port's weight list is the JAX package's, name for name and
    shape for shape: TrainableLJ's epsilon and sigma, the NN's hidden
    kernels and biases then the output kernel."""
    jt, tt = _pair("trainable", False)
    want = [np.float32(0.8), np.float32(0.95)]
    assert [w for w in tt.get_weights()[2:]] == \
        [np.asarray(w) for w in jt.get_weights()[2:]] == want
    jn, tn = _pair("nn", False)
    jn.ensure_built([jnp.zeros((1, NN, 4)), jnp.zeros((1, 4)),
                     jnp.zeros((3, 3))])
    build_model(tn, 2.5, device="cpu")
    assert [w.shape for w in tn.get_weights()] == \
        [np.asarray(w).shape for w in jn.get_weights()]
    assert [w.shape for w in tn.get_weights()[2:]] == [(8, 8), (8,), (8, 1)]


def test_rbf_expansion_matches_jax():
    x = np.random.RandomState(0).uniform(0.2, 3.3, (30, 11))
    x = x.astype(np.float32)
    for low, high, count in ((0.5, 3.0, 32), (0.1, 2.0, 7)):
        t = htt.RBFExpansion(low, high, count)
        j = htf.RBFExpansion(low, high, count)
        assert t.variables == [] and not list(t.parameters())
        out = t(torch.as_tensor(x))
        assert out.shape == (30, 11, count)
        np.testing.assert_allclose(np_(out), np.asarray(j(jnp.asarray(x))),
                                   rtol=1e-5, atol=1e-6)


def test_nn_zero_rows_zero_force():
    """Isolated particles (no neighbors) feel exactly zero force."""
    n = 4
    pos4 = np.zeros((n, 4), np.float32)
    pos4[:, 0] = np.arange(n) * 20.0 - 30
    nl = htt.compute_nlist(torch.as_tensor(pos4), 3.0, 6, [100.0] * 3,
                           device="cpu")
    m = htt.NeuralPairPotential(6, hidden=8, layers=1, count=4)
    f = m([nl, torch.as_tensor(pos4),
           htt.ops.box_from_lengths([100.0] * 3, device="cpu")])[0]
    assert torch.all(f[:, :3] == 0)
