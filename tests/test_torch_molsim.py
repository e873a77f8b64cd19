"""MolSimModel on the port against the JAX package: the guards and the
molecule views of tests/test_model.py, the reverse indices, the config
round trip, the attach guards of tests/test_driver.py (molecule and
particle batching, the planes modes), and a simulation's forces.

Inputs are the same numpy arrays through both packages. Tolerances: the
views are gathers (exact); forces atol 1e-4 after one step (the port's
parity bar, tests/test_torch_packed.py), and a direct model call's
forces atol 1e-5 (one float32 gradient of the same sums)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hoomd_tf_tpu as htf
import hoomd_tf_tpu_torch as htt
from hoomd_tf_tpu.models.simmodel import _make_reverse_indices as j_rmi
from hoomd_tf_tpu_torch.interop import state_from_numpy
from hoomd_tf_tpu_torch.models.simmodel import _make_reverse_indices as t_rmi

from torch_helpers import fluid_arrays, jax_state, jax_state_numpy, np_


class JLJMol(htf.MolSimModel):
    """tests/zoo.py's LJMolModel."""

    def mol_compute(self, nlist, positions, mol_nlist, mol_positions, box):
        rinv = htf.nlist_rinv(mol_nlist)
        total_e = jnp.sum(4.0 / 2.0 * (rinv ** 12 - rinv ** 6))
        return htf.compute_nlist_forces(nlist, total_e)


class TLJMol(htt.MolSimModel):
    """The same in torch."""

    def mol_compute(self, nlist, positions, mol_nlist, mol_positions, box):
        rinv = htt.nlist_rinv(mol_nlist)
        total_e = torch.sum(4.0 / 2.0 * (rinv ** 12 - rinv ** 6))
        return htt.compute_nlist_forces(nlist, total_e)


def mol_inputs():
    """tests/test_model.py's: 4 molecules of 3 atoms on a line."""
    n = 12
    pos = np.zeros((n, 4), dtype=np.float32)
    pos[:, 0] = np.arange(n) * 1.2 - 6
    pos[:, 1] = (np.arange(n) % 3) * 0.7
    box_l = np.array([20.0, 20, 20], np.float32)
    NN = 6
    jin = [htf.compute_nlist(jnp.asarray(pos), 2.5, NN, box_l, sorted=True,
                             return_types=True),
           jnp.asarray(pos), htf.box_from_lengths(box_l)]
    tin = [htt.compute_nlist(torch.as_tensor(pos), 2.5, NN,
                             torch.as_tensor(box_l), sorted=True,
                             return_types=True),
           torch.as_tensor(pos), htt.box_from_lengths(box_l, device="cpu")]
    return jin, tin, NN


def test_requires_mol_compute():
    with pytest.raises(AttributeError):
        htt.MolSimModel(3, [[0, 1, 2]], 4)


def test_too_many_atoms_raises():
    class M(htt.MolSimModel):
        def mol_compute(self, nlist, positions, mol_nlist):
            return torch.sum(mol_nlist)

    with pytest.raises(ValueError, match="more than MN"):
        M(2, [[0, 1, 2]], 4)


def test_too_few_args_raises():
    class M(htt.MolSimModel):
        def mol_compute(self, nlist, positions):
            return torch.sum(nlist)

    with pytest.raises(AttributeError):
        M(3, [[0, 1, 2]], 4)


@pytest.mark.parametrize("ragged", [False, True])
def test_mol_views_match_jax(ragged):
    """mol_positions [M, MN, 4] and mol_nlist [M, MN, NN, 4] equal the
    JAX package's; ragged molecules read the dummy row 0 (zeros)."""
    jin, tin, NN = mol_inputs()
    mol_indices = ([[0, 1, 2], [3, 4], [5], [6, 7, 8], [9, 10, 11]]
                   if ragged else
                   [[3 * i, 3 * i + 1, 3 * i + 2] for i in range(4)])

    class JViews(htf.MolSimModel):
        def mol_compute(self, nlist, positions, mol_nlist, mol_pos):
            return mol_pos, mol_nlist

    class TViews(htt.MolSimModel):
        def mol_compute(self, nlist, positions, mol_nlist, mol_pos):
            return mol_pos, mol_nlist

    jpos, jnl = JViews(3, mol_indices, NN)(jin)
    tpos, tnl = TViews(3, mol_indices, NN)(tin)
    m = len(mol_indices)
    assert tuple(tpos.shape) == (m, 3, 4)
    assert tuple(tnl.shape) == (m, 3, NN, 4)
    np.testing.assert_array_equal(np_(tpos), np.asarray(jpos))
    np.testing.assert_allclose(np_(tnl), np.asarray(jnl), rtol=0, atol=1e-6)
    if ragged:
        np.testing.assert_array_equal(np_(tpos)[1, 2], 0.0)
        np.testing.assert_array_equal(np_(tpos)[2, 1:], 0.0)
    else:
        np.testing.assert_array_equal(np_(tpos)[1, 2], np_(tin[1])[5])


def test_mol_forces_match_jax():
    """LJMolModel's forces through the gather equal the JAX package's;
    momentum is conserved."""
    jin, tin, NN = mol_inputs()
    mol_indices = [[3 * i, 3 * i + 1, 3 * i + 2] for i in range(4)]
    jf = np.asarray(JLJMol(MN=3, mol_indices=mol_indices,
                           nneighbor_cutoff=NN)(jin)[0])
    tf = np_(TLJMol(MN=3, mol_indices=mol_indices,
                    nneighbor_cutoff=NN)(tin)[0])
    assert tf.shape == (12, 4) and np.abs(tf[:, :3]).sum() > 0
    np.testing.assert_allclose(tf, jf, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tf[:, :3].sum(axis=0), 0.0, atol=1e-3)


@pytest.mark.parametrize("mol_indices", [[[1, 2, 0], [3, 0, 0]],
                                         [[1, 2], [4, 0]]])
def test_reverse_indices_match_jax(mol_indices, capsys):
    """The reverse map (atom -> [molecule, slot]) equals the JAX
    package's, the warning for atoms in no molecule included."""
    assert t_rmi([list(m) for m in mol_indices]) == \
        j_rmi([list(m) for m in mol_indices])
    assert t_rmi([[1, 2, 0], [3, 0, 0]])[2] == [1, 0]


def test_config_round_trip():
    """get_config keeps MN and the 1-indexed, padded indices (the JAX
    package's tests/test_model.py::test_mol_model_config);
    from_config rebuilds the model."""
    kw = dict(MN=2, mol_indices=[[0, 1], [2]], nneighbor_cutoff=4)
    t = TLJMol(**kw).get_config()
    j = JLJMol(**kw).get_config()
    assert t["MN"] == j["MN"] == 2
    assert t["mol_indices"] == j["mol_indices"] == [[1, 2], [3, 0]]
    m2 = TLJMol.from_config({**t, "mol_indices": [[0, 1], [2]]})
    assert m2.MN == 2 and m2.mol_indices == [[1, 2], [3, 0]]
    assert m2.nneighbor_cutoff == 4


def _sim(n=9):
    sim = htt.Simulation(dt=0.001, device="cpu")
    sim.init_lattice(n, a=2.0, kT_init=0.5)
    return sim


def test_batch_size_conflict():
    """Molecule batching and particle batching exclude each other
    (tests/test_driver.py::test_mol_batch_size_conflict)."""
    model = TLJMol(MN=1, mol_indices=[[i] for i in range(9)],
                   nneighbor_cutoff=8)
    with pytest.raises(ValueError, match="batch"):
        htt.tfcompute(model).attach(_sim(), r_cut=5.0, batch_size=3)


@pytest.mark.parametrize("mode", ["cellwise", "direct"])
def test_planes_modes_refused(mode):
    """The planes modes change the nlist form the model sees: refused
    for a MolSimModel, as in the JAX package."""
    model = TLJMol(MN=1, mol_indices=[[i] for i in range(512)],
                   nneighbor_cutoff=64)
    sim = htt.Simulation(dt=0.001, device="cpu")
    sim.init_lattice(512, density=0.4)
    with pytest.raises(ValueError, match="molecule batching"):
        htt.tfcompute(model).attach(sim, r_cut=3.0, nlist=mode)


@pytest.mark.parametrize("mode", ["n2", "cell"])
def test_run_matches_jax(mode):
    """A MolSimModel of 4-atom molecules driving NVT for one step from
    the same state: positions 1e-6, forces 1e-4 against the JAX package;
    as a plain LJ model on the same list it sums the same energy (every
    atom in exactly one molecule), so its forces equal it too."""
    n = 512
    pos, vel, lengths = fluid_arrays(n, 0.4, seed=2, kT=1.0)
    js = jax_state(pos, vel, lengths)
    mol = [list(range(4 * i, 4 * i + 4)) for i in range(n // 4)]
    jsim = htf.Simulation(dt=0.005, integrator=htf.md.NVT(kT=1.0, tau=0.5))
    jsim.set_state(js)
    htf.tfcompute(JLJMol(4, mol, 64)).attach(jsim, r_cut=3.0, nlist=mode)
    jsim.run(1)
    res = []
    for model in (TLJMol(4, mol, 64), None):
        tsim = htt.Simulation(dt=0.005, integrator=htt.md.NVT(kT=1.0,
                                                              tau=0.5),
                              device="cpu")
        tsim.set_state(state_from_numpy(jax_state_numpy(js), device="cpu"))
        if model is None:
            from test_torch_packed import TLJ
            model = TLJ(64)
        htt.tfcompute(model).attach(tsim, r_cut=3.0, nlist=mode)
        tsim.run(1)
        res.append(tsim)
    np.testing.assert_allclose(np_(res[0].state.positions),
                               np.asarray(jsim.state.positions), rtol=0,
                               atol=1e-6)
    f = np_(res[0].state.forces)
    assert np.abs(f[:, :3]).max() > 0.1
    np.testing.assert_allclose(f, np.asarray(jsim.state.forces), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(f[:, :3], np_(res[1].state.forces)[:, :3],
                               rtol=0, atol=1e-4)
