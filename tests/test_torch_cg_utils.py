"""The port's CG utilities (``hoomd_tf_tpu_torch.utils``: cg, graph,
mol_features, pdb_io, trajectory) against the JAX package on the cases
of tests/test_utils.py (with its duck-typed MDAnalysis stand-ins) and the
PDB + DSGPM pipeline of tests/test_real_formats.py, less its GSD parts.

Host-side results (molecule lists, mapping matrices, exclusions, graph
index tuples, PDB topology) must be equal. Float results: the mapping
operator exactly (float32 values of the same numbers); centers of mass,
features and neighbor lists atol 1e-5 (float32 sums in another order);
model outputs rtol 1e-5, atol 1e-5.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hoomd_tf_tpu as htf
import hoomd_tf_tpu_torch as htt
from hoomd_tf_tpu.utils.pdb_io import PDBUniverse as JPDB
from hoomd_tf_tpu_torch.utils.pdb_io import PDBUniverse as TPDB

import zoo
from test_torch_driver import TGraph
from test_utils import FakeAtoms, FakeUniverse
from torch_helpers import np_

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
PDB = os.path.join(FIXTURES, "peg2.pdb")
CGMAP = os.path.join(FIXTURES, "peg2_cgmap.json")
CHAIN = ["C1", "C2", "O1", "C3", "C4", "O2", "C5", "C6", "O3", "C7", "C8",
         "O4"]
ATOL = dict(rtol=0, atol=1e-5)


class TLJModel(htt.SimModel):
    """tests/zoo.py's LJModel in torch."""

    def compute(self, nlist, positions, box):
        inv_r6 = htt.nlist_rinv(nlist) ** 6
        energy = torch.sum(4.0 / 2.0 * (inv_r6 * inv_r6 - inv_r6), dim=1)
        return htt.compute_nlist_forces(nlist, energy)


def cpu_sim(n, bonds=None, masses=None):
    sim = htt.Simulation(device="cpu")
    sim.init_lattice(n, a=2.0)
    jsim = htf.Simulation()
    jsim.init_lattice(n, a=2.0)
    if bonds is not None:
        sim.bonds = jsim.bonds = bonds
    if masses is not None:
        import dataclasses
        sim.state.masses = torch.as_tensor(masses, dtype=torch.float32)
        jsim.state = dataclasses.replace(jsim.state,
                                         masses=jnp.asarray(masses))
    return sim, jsim


# ---------------------------------------------------------------------------
# utils.cg
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bonds,want", [
    ([[0, 1], [1, 2], [4, 5]], [[0, 1, 2], [3], [4, 5]]),
    ([[0, 2], [2, 1], [2, 3], [3, 4], [5, 3]], [[0, 1, 2, 3, 4, 5]]),
    ([[5, 4], [3, 1]], [[0], [1, 3], [2], [4, 5]]),
])
def test_find_molecules(bonds, want):
    sim, jsim = cpu_sim(6, bonds=bonds)
    assert htt.find_molecules(sim) == htf.find_molecules(jsim) == want


def test_find_molecules_from_topology():
    u = FakeUniverse([np.zeros((6, 3))],
                     names=["O", "H", "H", "O", "H", "H"],
                     resnames=["W"] * 6)
    want = htf.find_molecules_from_topology(u, [["O", "H", "H"]])
    assert htt.find_molecules_from_topology(u, [["O", "H", "H"]]) == want
    assert want == [[0, 1, 2], [3, 4, 5]]


@pytest.mark.parametrize("names,masses,beads", [
    (["O", "H1", "H2"], [16.0, 1.0, 1.0], [["O", "H1", "H2"]]),
    (["C1", "C2", "N1", "N2"], [12.0, 12.0, 14.0, 14.0],
     [["C1", "C2"], ["N1", "N2"]]),
    (["O", "H1", "H2", "C1", "C2"], [16.0, 1.0, 1.0, 12.0, 12.0],
     [["O", "H1", "H2"], ["C1", "C2"]]),
])
def test_matrix_mapping(names, masses, beads):
    mol = FakeAtoms(names, masses)
    np.testing.assert_array_equal(htt.matrix_mapping(mol, beads),
                                  htf.matrix_mapping(mol, beads))
    t = htt.matrix_mapping(mol, beads, mass_weighted=False)
    j = htf.matrix_mapping(mol, beads, mass_weighted=False)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("weighted", [False, True])
def test_sparse_mapping_matches_bcoo(weighted):
    """The CSR operator densely equals the JAX BCOO's todense(), with and
    without the simulation's masses; coalesced, float32, on the device
    asked for."""
    masses = [2.0, 1.0, 1.0, 2.0, 1.0, 1.0] if weighted else None
    sim, jsim = cpu_sim(6, masses=masses)
    mm = np.array([[1.0, 1.0, 1.0]]) / (1 if weighted else 3)
    mmi = [[0, 1, 2], [3, 4, 5]]
    t = htt.sparse_mapping([mm, mm], mmi,
                           system=sim if weighted else None, device="cpu")
    j = htf.sparse_mapping([mm, mm], mmi, system=jsim if weighted else None)
    assert t.layout == torch.sparse_csr and t.dtype == torch.float32
    assert tuple(t.shape) == tuple(j.shape) == (2, 6)
    np.testing.assert_array_equal(np_(t.to_dense()), np.asarray(j.todense()))
    if weighted:
        np.testing.assert_allclose(np_(t.to_dense())[0, :3],
                                   [0.5, 0.25, 0.25])


def test_sparse_mapping_system_device():
    """With a simulation and no device, the operator lives on the
    simulation's device."""
    sim, _ = cpu_sim(6)
    mm = np.ones((1, 3)) / 3
    op = htt.sparse_mapping([mm, mm], [[0, 1, 2], [3, 4, 5]], system=sim)
    assert op.device == sim.device


def test_sparse_mapping_many_molecules():
    """Ragged molecules of two templates, interleaved atom indices."""
    rng = np.random.RandomState(0)
    mmi = [[0, 5, 2], [1, 3], [4, 6, 7], [8, 9]]
    mms = [rng.rand(2, 3), rng.rand(1, 2), rng.rand(2, 3), rng.rand(1, 2)]
    t = htt.sparse_mapping(mms, mmi, device="cpu")
    j = htf.sparse_mapping(mms, mmi)
    np.testing.assert_allclose(np_(t.to_dense()), np.asarray(j.todense()),
                               rtol=1e-7, atol=0)


def test_sparse_mapping_errors():
    with pytest.raises(ValueError):
        htt.sparse_mapping([np.array([[1.0, 1.0]])], [[0, 1, 2]],
                           device="cpu")
    with pytest.raises(ValueError):
        htt.sparse_mapping([np.ones((1, 2))] * 2, [[0, 1]], device="cpu")
    with pytest.raises(TypeError):
        htt.sparse_mapping([[0, 1]], [[0, 1]], device="cpu")


@pytest.mark.parametrize("case", ["straddle", "inside", "random"])
@pytest.mark.parametrize("dense", [False, True])
def test_center_of_mass(case, dense):
    """The circular mean equals the JAX package's (sparse or dense
    operator); a pair straddling the boundary maps to the boundary."""
    box = [10.0, 10.0, 10.0]
    if case == "random":
        rng = np.random.RandomState(1)
        pos = (rng.rand(40, 3) * 10 - 5).astype(np.float32)
        mmi = [list(range(4 * i, 4 * i + 4)) for i in range(10)]
        mms = [rng.rand(2, 4) for _ in range(10)]
    else:
        pos = np.array([[4.8, 0, 0], [-4.8, 0, 0]] if case == "straddle"
                       else [[1.0, 1, 0], [2.0, 3, 0]], np.float32)
        mmi, mms = [[0, 1]], [np.ones((1, 2)) / 2]
    t_op = htt.sparse_mapping(mms, mmi, device="cpu")
    j_op = htf.sparse_mapping(mms, mmi)
    if dense:
        t_op = t_op.to_dense()
    got = np_(htt.center_of_mass(torch.as_tensor(pos), t_op, box))
    want = np.asarray(htf.center_of_mass(jnp.asarray(pos), j_op, box))
    d = got - want
    np.testing.assert_allclose(d - np.round(d / 10.0) * 10.0, 0.0, **ATOL)
    if case == "straddle":
        assert abs(abs(got[0, 0]) - 5.0) < 1e-4
    if case == "inside":
        np.testing.assert_allclose(got[0], [1.5, 2.0, 0.0], atol=1e-3)


def test_ohe_matches_jax():
    rng = np.random.RandomState(2)
    pos_bt = rng.randint(0, 3, 5)
    nl_bt = rng.randint(0, 3, (5, 4))
    got = htt.compute_ohe_bead_type_interactions(pos_bt, nl_bt, 3,
                                                 device="cpu")
    want = htf.compute_ohe_bead_type_interactions(pos_bt, nl_bt, 3)
    assert got.dtype == torch.float32 and tuple(got.shape) == (5, 4, 6)
    np.testing.assert_array_equal(np_(got), np.asarray(want))


def _excl_universe():
    return FakeUniverse([np.zeros((6, 3))],
                        names=["A", "B", "C", "A", "B", "C"],
                        bonds=[[0, 1], [1, 2], [3, 4], [4, 5]])


def test_exclusions_match_jax():
    mol = FakeAtoms(["A", "B", "C"], [1.0, 1.0, 1.0])
    t = htt.gen_mapped_exclusion_list(_excl_universe(), mol,
                                      [["A", "B"], ["C"]])
    j = htf.gen_mapped_exclusion_list(_excl_universe(), mol,
                                      [["A", "B"], ["C"]])
    np.testing.assert_array_equal(t, j)
    assert t[0, 1] and t[2, 3] and not t[0, 2]
    np.testing.assert_array_equal(htt.gen_bonds_group(t),
                                  htf.gen_bonds_group(j))


# ---------------------------------------------------------------------------
# utils.graph
# ---------------------------------------------------------------------------

def _adj(n, edges):
    adj = np.zeros((n, n))
    for a, b in edges:
        adj[a, b] = adj[b, a] = 1
    return adj


@pytest.mark.parametrize("n,edges", [
    (4, [(0, 1), (1, 2), (2, 3)]),                          # chain
    (6, [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 0)]),  # ring: 2 paths
    (6, [(0, 1), (0, 2), (0, 3), (3, 4), (4, 5), (2, 4)]),  # branched ring
    (5, [(0, 1), (2, 3)]),                                   # disconnected
])
def test_cg_graph_matches_jax(n, edges):
    """Bonds, angles and dihedrals equal the JAX package's networkx
    result, in its order (several shortest paths per pair included)."""
    adj = _adj(n, edges)
    got = htt.compute_cg_graph(DSGPM=False, adj_mat=adj, cg_beads=n)
    want = htf.compute_cg_graph(DSGPM=False, adj_mat=adj, cg_beads=n)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_dsgpm_json(tmp_path):
    obj = {"cgnodes": [[0, 1], [2], [3]],
           "edges": [{"source": 1, "target": 2},
                     {"source": 2, "target": 3}]}
    path = tmp_path / "cg.json"
    path.write_text(json.dumps(obj))
    np.testing.assert_array_equal(htt.compute_adj_mat(obj),
                                  htf.compute_adj_mat(obj))
    for g, w in zip(htt.compute_cg_graph(DSGPM=True, infile=str(path)),
                    htf.compute_cg_graph(DSGPM=True, infile=str(path))):
        np.testing.assert_array_equal(g, w)
    assert htt.compute_cg_graph(DSGPM=False) is None
    cg = [[0, 3], [1], [2, 4]]
    for atom in range(6):
        assert htt.find_cgnode_id(atom, cg) == htf.find_cgnode_id(atom, cg)


def test_mol_features_multiple():
    kw = dict(bnd_indices=np.array([[0, 1], [1, 2]]),
              ang_indices=np.array([[0, 1, 2]]),
              dih_indices=np.array([[0, 1, 2, 3]]), molecules=2, beads=4)
    for g, w in zip(htt.mol_features_multiple(**kw),
                    htf.mol_features_multiple(**kw)):
        np.testing.assert_array_equal(g, w)
    b, a, d = htt.mol_features_multiple(bnd_indices=kw["bnd_indices"],
                                        molecules=3, beads=2)
    assert b.shape == (6, 2) and a.shape == (0, 3) and d.shape == (0, 4)


# ---------------------------------------------------------------------------
# utils.mol_features
# ---------------------------------------------------------------------------

def test_mol_features_batched():
    """Bond, angle and dihedral on [M, MN, 4] views (slots 0..3 and the
    zoo's 2, 1 / 1, 2, 3 / 1, 2, 3, 4 orders) equal the JAX package's,
    with boundary crossings in a small box."""
    rng = np.random.RandomState(3)
    mol = (rng.rand(6, 5, 4) * 6 - 3).astype(np.float32)
    tb = htt.box_from_lengths([5.0, 5.0, 5.0], device="cpu")
    jb = htf.box_from_lengths([5.0, 5.0, 5.0])
    tm, jm = torch.as_tensor(mol), jnp.asarray(mol)
    pairs = [
        (htt.mol_bond_distance(tm, 2, 1, box=tb),
         htf.mol_bond_distance(jm, 2, 1, box=jb)),
        (htt.mol_angle(tm, 1, 2, 3, box=tb),
         htf.mol_angle(jm, 1, 2, 3, box=jb)),
        (htt.mol_dihedral(tm, 1, 2, 3, 4, box=tb),
         htf.mol_dihedral(jm, 1, 2, 3, 4, box=jb)),
    ]
    for g, w in pairs:
        assert tuple(g.shape) == (6,)
        np.testing.assert_allclose(np_(g), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    square = np.zeros((1, 4, 4), np.float32)
    square[0, :, :3] = [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0.5]]
    big = htt.box_from_lengths([100.0] * 3, device="cpu")
    sq = torch.as_tensor(square)
    np.testing.assert_allclose(np_(htt.mol_bond_distance(sq, 0, 1,
                                                         box=big)), [1.0])
    np.testing.assert_allclose(np_(htt.mol_angle(sq, 0, 1, 2, box=big)),
                               [np.pi / 2], rtol=1e-6)


def test_mol_features_cg():
    """The CG forms on bead index lists equal the JAX package's."""
    rng = np.random.RandomState(4)
    cg = (rng.rand(12, 3) * 8 - 4).astype(np.float32)
    ids = rng.randint(0, 12, (7, 4))
    tb = htt.box_from_lengths([8.0] * 3, device="cpu")
    jb = htf.box_from_lengths([8.0] * 3)
    tcg, jcg = torch.as_tensor(cg), jnp.asarray(cg)
    got = [htt.mol_bond_distance(CG=True, cg_positions=tcg, b1=ids[:, 0],
                                 b2=ids[:, 1], box=tb),
           htt.mol_angle(CG=True, cg_positions=tcg, b1=ids[:, 0],
                         b2=ids[:, 1], b3=ids[:, 2], box=tb),
           htt.mol_dihedral(CG=True, cg_positions=tcg, b1=ids[:, 0],
                            b2=ids[:, 1], b3=ids[:, 2], b4=ids[:, 3],
                            box=tb)]
    want = [htf.mol_bond_distance(CG=True, cg_positions=jcg, b1=ids[:, 0],
                                  b2=ids[:, 1], box=jb),
            htf.mol_angle(CG=True, cg_positions=jcg, b1=ids[:, 0],
                          b2=ids[:, 1], b3=ids[:, 2], box=jb),
            htf.mol_dihedral(CG=True, cg_positions=jcg, b1=ids[:, 0],
                             b2=ids[:, 1], b3=ids[:, 2], b4=ids[:, 3],
                             box=jb)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(np_(g), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
    with pytest.raises(ValueError):
        htt.mol_angle(CG=True, box=tb)
    with pytest.raises(ValueError):
        htt.mol_bond_distance(box=tb)


# ---------------------------------------------------------------------------
# utils.trajectory
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims", [(8, 8, 8, 90, 90, 90),
                                  (8, 8, 8, 80, 85, 75)])
def test_iter_from_trajectory_matches_jax(dims):
    """Per frame the same list (recomputed every frame, the triclinic
    minimum image for a skewed box), positions with types from the
    sorted unique type names, and box; tensors on the device asked
    for."""
    rng = np.random.RandomState(0)
    frames = [rng.rand(8, 3) * 8 for _ in range(5)]
    u = FakeUniverse(frames, types=["C"] * 4 + ["H"] * 4, dimensions=dims)
    got = list(htt.iter_from_trajectory(4, u, r_cut=3.0, device="cpu"))
    want = list(htf.iter_from_trajectory(4, u, r_cut=3.0))
    assert len(got) == len(want) == 5
    for (t_in, t_ts), (j_in, j_ts) in zip(got, want):
        assert all(x.device.type == "cpu" for x in t_in)
        assert tuple(t_in[0].shape) == (8, 4, 4)
        for a, b in zip(t_in, j_in):
            np.testing.assert_allclose(np_(a), np.asarray(b), **ATOL)
        np.testing.assert_array_equal(t_ts.positions, j_ts.positions)
    np.testing.assert_array_equal(np_(got[0][0][1])[:, 3],
                                  [0, 0, 0, 0, 1, 1, 1, 1])


def test_nlist_recomputed_per_frame():
    f0 = np.zeros((2, 3), dtype=np.float32)
    f0[1, 0] = 1.0
    f1 = np.zeros((2, 3), dtype=np.float32)
    f1[1, 0] = 2.5
    u = FakeUniverse([f0, f1], dimensions=(10, 10, 10, 90, 90, 90))
    outs = list(htt.iter_from_trajectory(2, u, r_cut=4.0, device="cpu"))
    assert abs(float(outs[0][0][0][0, 0, 0]) - 1.0) < 1e-5
    assert abs(float(outs[1][0][0][0, 0, 0]) - 2.5) < 1e-5


def test_period_window_and_model():
    """period, start and end pick the JAX package's frames; the model's
    forces on each equal the JAX LJModel's."""
    rng = np.random.RandomState(1)
    frames = [rng.rand(6, 3) * 6 for _ in range(7)]
    u = FakeUniverse(frames, dimensions=(6, 6, 6, 90, 90, 90))
    kw = dict(r_cut=2.0, period=2, start=1, end=5)
    got = list(htt.iter_from_trajectory(4, u, device="cpu", **kw))
    want = list(htf.iter_from_trajectory(4, u, **kw))
    assert [t.frame for _, t in got] == [t.frame for _, t in want] == [2, 4]
    tm, jm = TLJModel(4), zoo.LJModel(4)
    for (t_in, _), (j_in, _) in zip(got, want):
        np.testing.assert_allclose(np_(tm(t_in)[0]), np.asarray(jm(j_in)[0]),
                                   rtol=1e-5, atol=1e-5)


def test_frame_forces_and_velocities():
    rng = np.random.RandomState(3)
    frames = [rng.rand(6, 3) * 6 for _ in range(3)]
    forces = [rng.randn(6, 3).astype(np.float32) for _ in range(3)]
    vels = [rng.randn(6, 3).astype(np.float32) for _ in range(3)]
    u = FakeUniverse(frames, dimensions=(6, 6, 6, 90, 90, 90),
                     forces_frames=forces, velocities_frames=vels)
    outs = list(htt.iter_from_trajectory(4, u, r_cut=2.0, device="cpu"))
    for i, (_, ts) in enumerate(outs):
        np.testing.assert_allclose(ts.forces, forces[i])
        np.testing.assert_allclose(ts.velocities, vels[i])
        assert ts.frame == i
    u2 = FakeUniverse([np.zeros((4, 3))], dimensions=(6, 6, 6, 90, 90, 90))
    (_, ts), = list(htt.iter_from_trajectory(2, u2, r_cut=2.0,
                                             device="cpu"))
    with pytest.raises(AttributeError):
        ts.forces


def test_force_matching_on_frame_labels():
    """Offline force matching on ts.forces labels (the reference's
    examples 06 / 08) with a trainable LJ strength (tests/
    test_torch_driver.py's TGraph): finite losses, the weight moves."""
    rng = np.random.RandomState(4)
    frames = [rng.rand(8, 3) * 6 for _ in range(4)]
    forces = [np.zeros((8, 3), dtype=np.float32) for _ in range(4)]
    u = FakeUniverse(frames, dimensions=(6, 6, 6, 90, 90, 90),
                     forces_frames=forces)
    model = TGraph(6)
    model.compile(optimizer="adam", loss="mse", learning_rate=1e-2)
    w0 = np_(model.eps.value).copy()
    losses = [float(model.train_on_batch(inputs, torch.as_tensor(ts.forces)))
              for inputs, ts in htt.iter_from_trajectory(6, u, r_cut=2.5,
                                                         device="cpu")]
    assert len(losses) == 4 and np.all(np.isfinite(losses))
    assert np.abs(np_(model.eps.value) - w0).max() > 0


def test_compute_pairwise_matches_jax():
    r = np.linspace(0.9, 2.5, 9)
    got = htt.compute_pairwise(TLJModel(4), r, device="cpu")
    want = htf.utils.compute_pairwise(zoo.LJModel(4), r)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (9, 2, 4)
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_create_frame():
    pos = np.zeros((3, 3), np.float32)
    t = htt.create_frame(7, 3, ["A"], [0, 0, 0], pos, [5, 5, 5, 0, 0, 0])
    j = htf.create_frame(7, 3, ["A"], [0, 0, 0], pos, [5, 5, 5, 0, 0, 0])
    assert t.configuration.step == j.configuration.step == 7
    assert t.particles.N == 3 and t.particles.position is pos
    assert t.particles.types == j.particles.types


# ---------------------------------------------------------------------------
# utils.pdb_io and the real-format CG pipeline
# ---------------------------------------------------------------------------

def test_pdb_topology_matches_jax():
    t, j = TPDB(PDB), JPDB(PDB)
    assert len(t.atoms) == 24 and t.n_frames == j.n_frames == 3
    for attr in ("names", "masses", "types", "resnames", "resids",
                 "positions"):
        np.testing.assert_array_equal(getattr(t.atoms, attr),
                                      getattr(j.atoms, attr), err_msg=attr)
    np.testing.assert_array_equal(t.atoms.bonds.to_indices(),
                                  j.atoms.bonds.to_indices())
    assert len(t.atoms.bonds.to_indices()) == 22
    np.testing.assert_array_equal(t.dimensions, j.dimensions)
    for sel in ("all", "name C1", "name C*", "not name O*", "type O",
                "resname PEG"):
        assert len(t.select_atoms(sel)) == len(j.select_atoms(sel)), sel
    with pytest.raises(ValueError):
        t.select_atoms("around 5 name C1")
    sub = t.select_atoms("resname PEG").select_atoms("name C1 C2 O1")
    assert len(sub) == 6 and len(sub.bonds.to_indices()) == 4
    np.testing.assert_allclose(
        sub.center_of_mass(),
        JPDB(PDB).select_atoms("name C1 C2 O1").center_of_mass(),
        rtol=1e-6)


def test_pdb_frames_and_gsd_refused():
    u = TPDB(PDB)
    frames = [u.atoms.positions.copy() for _ in u.trajectory]
    assert len(frames) == 3 and np.abs(frames[2] - frames[0]).max() > 1e-3
    with pytest.raises(NotImplementedError, match="item 6"):
        TPDB(PDB, traj="frames.gsd")


def test_pdb_parser_robustness(tmp_path):
    p = tmp_path / "t.pdb"
    p.write_text("\n".join([
        "CRYST1   20.000   20.000   20.000  90.00  90.00  90.00 P 1",
        "ATOM      1  CA  ALA A   1       1.000   2.000   3.000"
        "  1.00  0.00",
        "HETATM    2  O   HOH A   2       4.000   5.000   6.000"
        "  1.00  0.00           O",
        "ATOM      3 1HB  ALA A   1       7.000   8.000   9.000"
        "  1.00  0.00",
        "CONECT    1    2",
        "CONECT    1    2",
        "CONECT    2    9",
    ]) + "\n")
    t, j = TPDB(str(p)), JPDB(str(p))
    assert list(t.atoms.types) == list(j.atoms.types) == ["C", "O", "H"]
    np.testing.assert_array_equal(t.atoms.masses, j.atoms.masses)
    np.testing.assert_array_equal(t.atoms.bonds.to_indices(), [[0, 1]])
    assert t.n_frames == 1


def test_real_format_pipeline():
    """PDB + DSGPM -> molecules -> mapping -> tiled features -> internal
    coordinates per frame, each step against the JAX package."""
    tu, ju = TPDB(PDB), JPDB(PDB)
    t_mols = htt.find_molecules_from_topology(tu, [CHAIN])
    assert t_mols == htf.find_molecules_from_topology(ju, [CHAIN]) == \
        [list(range(12)), list(range(12, 24))]

    class FirstMol:
        names = list(tu.atoms.names[:12])
        masses = list(tu.atoms.masses[:12])
        n_atoms = 12

        def __len__(self):
            return 12

    names = FirstMol.names
    beads = [names[0:3], names[3:6], names[6:9], names[9:12]]
    mapping = htt.matrix_mapping(FirstMol(), beads)
    np.testing.assert_array_equal(mapping,
                                  htf.matrix_mapping(FirstMol(), beads))
    t_op = htt.sparse_mapping([mapping] * 2, t_mols, device="cpu")
    j_op = htf.sparse_mapping([mapping] * 2, t_mols)
    assert tuple(t_op.shape) == (8, 24)
    bonds, angles, dihedrals = htt.compute_cg_graph(DSGPM=True, infile=CGMAP)
    for g, w in zip((bonds, angles, dihedrals),
                    htf.compute_cg_graph(DSGPM=True, infile=CGMAP)):
        np.testing.assert_array_equal(g, w)
    assert dihedrals.shape == (1, 4)
    b_ids, a_ids, d_ids = htt.mol_features_multiple(
        bnd_indices=bonds, ang_indices=angles, dih_indices=dihedrals,
        molecules=2, beads=4)
    tb = htt.box_from_lengths(tu.dimensions[:3], device="cpu")
    jb = htf.box_from_lengths(ju.dimensions[:3])
    dense_t, dense_j = t_op.to_dense(), np.asarray(j_op.todense())
    for _ in zip(tu.trajectory, ju.trajectory):
        t_cg = dense_t @ torch.as_tensor(tu.atoms.positions)
        j_cg = jnp.asarray(dense_j @ ju.atoms.positions)
        rs = htt.mol_bond_distance(CG=True, cg_positions=t_cg,
                                   b1=b_ids[:, 0], b2=b_ids[:, 1], box=tb)
        dihs = htt.mol_dihedral(CG=True, cg_positions=t_cg, b1=d_ids[:, 0],
                                b2=d_ids[:, 1], b3=d_ids[:, 2],
                                b4=d_ids[:, 3], box=tb)
        np.testing.assert_allclose(
            np_(rs), np.asarray(htf.mol_bond_distance(
                CG=True, cg_positions=j_cg, b1=b_ids[:, 0], b2=b_ids[:, 1],
                box=jb)), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            np_(dihs), np.asarray(htf.mol_dihedral(
                CG=True, cg_positions=j_cg, b1=d_ids[:, 0], b2=d_ids[:, 1],
                b3=d_ids[:, 2], b4=d_ids[:, 3], box=jb)),
            rtol=1e-4, atol=1e-4)
        assert 2.0 < float(rs.mean()) < 6.0


def test_iter_from_trajectory_on_pdb():
    """Real-PDB frames into the model, types from the elements, against
    the JAX package."""
    got = list(htt.iter_from_trajectory(8, TPDB(PDB), r_cut=3.0,
                                        device="cpu"))
    want = list(htf.iter_from_trajectory(8, JPDB(PDB), r_cut=3.0))
    assert len(got) == len(want) == 3
    tm, jm = TLJModel(8), zoo.LJModel(8)
    for (t_in, _), (j_in, _) in zip(got, want):
        assert tuple(t_in[0].shape) == (24, 8, 4)
        np.testing.assert_allclose(np_(t_in[0]), np.asarray(j_in[0]), **ATOL)
        np.testing.assert_allclose(np_(tm(t_in)[0]), np.asarray(jm(j_in)[0]),
                                   rtol=1e-5, atol=1e-5)
