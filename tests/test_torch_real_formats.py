"""The port's real-file-format tests that read GSD (tests/
test_real_formats.py's ``test_pdb_topology_with_gsd_frames`` and
``TestCommittedGSDFixture``, ported): PDB topology with GSD frames, and
the committed trajectory ``examples/data/dimer_fluid.gsd`` through the
port's native reader, each against the JAX package on the same file."""

import os

import numpy as np

import hoomd_tf_tpu as htf
import hoomd_tf_tpu_torch as htt
from hoomd_tf_tpu.utils.pdb_io import PDBUniverse as JPDBUniverse
from hoomd_tf_tpu_torch.utils.gsd_io import write_gsd_frames
from hoomd_tf_tpu_torch.utils.pdb_io import PDBUniverse

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
PDB = os.path.join(FIXTURES, "peg2.pdb")


class TestPDBUniverse:
    def test_pdb_topology_with_gsd_frames(self, tmp_path):
        """Topology from PDB + frames from GSD (the native analog of
        mda.Universe(pdb, trr)), frame for frame the JAX universe's."""
        rng = np.random.RandomState(0)
        u0 = PDBUniverse(PDB)
        base = u0.atoms.positions
        frames = [{"positions":
                   (base + 0.1 * rng.randn(*base.shape)).astype(
                       np.float32)} for _ in range(5)]
        gsd_path = str(tmp_path / "frames.gsd")
        write_gsd_frames(gsd_path, frames, box=[40, 40, 40])
        u = PDBUniverse(PDB, traj=gsd_path)
        assert u.n_frames == 5
        ju = JPDBUniverse(PDB, traj=gsd_path)
        np.testing.assert_array_equal(u.atoms.positions,
                                      frames[0]["positions"])
        seen = 0
        for (inputs, ts), (jin, jts) in zip(
                htt.iter_from_trajectory(8, u, r_cut=3.0, device="cpu"),
                htf.iter_from_trajectory(8, ju, r_cut=3.0)):
            np.testing.assert_allclose(
                ts.positions, frames[seen]["positions"], atol=1e-6)
            np.testing.assert_array_equal(ts.positions, jts.positions)
            np.testing.assert_allclose(inputs[0].numpy(),
                                       np.asarray(jin[0]), atol=1e-6)
            seen += 1
        assert seen == 5


class TestCommittedGSDFixture:
    """The committed real-data trajectory (``examples/data/dimer_fluid.gsd``)
    drives the port's trajectory pipeline end to end."""

    DATA = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "data", "dimer_fluid.gsd")

    def test_fixture_contents(self):
        u = htt.GSDUniverse(self.DATA)
        group = u.select_atoms("all")
        assert len(group) == 64
        assert u.bonds.shape == (32, 2)
        f = htt.GSDFile(self.DATA)
        assert f.nframes == 15
        assert f.chunk_exists(0, "log/particles/force")
        np.testing.assert_allclose(u.dimensions[3:], 90.0)
        np.testing.assert_array_equal(u.dimensions,
                                      htf.GSDUniverse(self.DATA).dimensions)
        f.close()

    def test_iter_and_force_match(self):
        u = htt.GSDUniverse(self.DATA)
        frames = list(htt.iter_from_trajectory(32, u, r_cut=3.0,
                                               device="cpu"))
        assert len(frames) == 15
        inputs, frame = frames[0]
        assert tuple(inputs[1].shape) == (64, 4)
        assert frame.forces.shape == (64, 3)
        jframes = list(htf.iter_from_trajectory(
            32, htf.GSDUniverse(self.DATA), r_cut=3.0))
        for (pi, pf), (ji, jf) in zip(frames, jframes):
            np.testing.assert_array_equal(pf.forces, jf.forces)
            np.testing.assert_allclose(pi[0].numpy(), np.asarray(ji[0]),
                                       atol=1e-6)

        # molecules recoverable from the file's bond topology
        class _Top:
            bonds = htt.GSDUniverse(self.DATA).bonds
            particles = range(64)
        mols = htt.find_molecules(_Top())
        assert len(mols) == 32
        assert all(len(m) == 2 for m in mols)

    def test_bonds_roundtrip(self, tmp_path):
        pos = np.random.RandomState(0).rand(6, 3).astype(np.float32)
        path = str(tmp_path / "b.gsd")
        write_gsd_frames(path, [{"positions": pos}], box=[3, 3, 3],
                         bonds=[[0, 1], [2, 3], [4, 5]])
        u = htt.GSDUniverse(path)
        np.testing.assert_array_equal(u.bonds, [[0, 1], [2, 3], [4, 5]])
        np.testing.assert_array_equal(htf.GSDUniverse(path).bonds, u.bonds)
