"""GSD trajectory I/O of the port (``hoomd_tf_tpu_torch.utils.gsd_io`` on
its own native library, ``csrc/gsd.cpp``) against the JAX package's:
tests/test_gsd.py ported, files written by either package read by the
other chunk for chunk bit-equal, the committed fixture read by both, and
``iter_from_trajectory`` over both packages' universes on one file."""

import os

import numpy as np
import pytest
import torch

import hoomd_tf_tpu as htf
import hoomd_tf_tpu_torch as htt
from hoomd_tf_tpu.utils import gsd_io as jgsd
from hoomd_tf_tpu_torch.utils.gsd_io import (GSDFile, GSDUniverse,
                                             write_gsd_frames)

REFERENCE_GSD = "/root/reference/htf/test-py/meth.gsd"
FIXTURE = os.path.join(os.path.dirname(__file__), "..", "examples", "data",
                       "dimer_fluid.gsd")
CPU = torch.device("cpu")


def np_(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def frames_of(seed, n=12, count=4, forces=True):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(count):
        fr = {"positions": (rng.rand(n, 3) * 6 - 3).astype(np.float32),
              "typeid": (np.arange(n) % 3).astype(np.uint32),
              "velocity": rng.randn(n, 3).astype(np.float32),
              "step": 10 * i}
        if forces:
            fr["forces"] = rng.randn(n, 3).astype(np.float32)
        out.append(fr)
    return out


def chunks(cls, path):
    """Every chunk of every frame: ``{(frame, name): array}`` read with
    ``cls`` (either package's GSDFile)."""
    names = ["configuration/step", "configuration/box", "particles/N",
             "particles/position", "particles/typeid", "particles/velocity",
             "log/particles/force", "bonds/N", "bonds/group"]
    out = {}
    with cls(path) as f:
        for i in range(f.nframes):
            for name in names:
                if f.chunk_exists(i, name):
                    out[(i, name)] = f.read_chunk(i, name)
    return out


def assert_bit_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


class TestRead:
    @pytest.mark.skipif(not os.path.exists(REFERENCE_GSD),
                        reason="reference fixture not available")
    def test_reads_hoomd_written_file(self):
        with GSDFile(REFERENCE_GSD) as f:
            assert f.schema == "hoomd"
            assert f.nframes == 1
            n = int(f.read_chunk(0, "particles/N")[0])
            pos = f.read_chunk(0, "particles/position")
            box = f.read_chunk(0, "configuration/box")
            assert pos.shape == (n, 3)
            assert pos.dtype == np.float32
            assert np.all(np.abs(pos) <= box[:3].max() / 2 + 1e-3)

    def test_missing_file_raises(self, tmp_path):
        with pytest.raises(OSError):
            GSDFile(str(tmp_path / "definitely_not_here.gsd"))

    def test_bad_mode_raises(self, tmp_path):
        with pytest.raises(ValueError):
            GSDFile(str(tmp_path / "t.gsd"), mode="a")


class TestRoundtrip:
    def test_write_read(self, tmp_path):
        frames = frames_of(0, forces=False)
        path = str(tmp_path / "traj.gsd")
        write_gsd_frames(path, frames, box=[6, 6, 6])
        with GSDFile(path) as f:
            assert f.nframes == 4
            assert f.schema == "hoomd"
            for i, fr in enumerate(frames):
                np.testing.assert_array_equal(
                    f.read_chunk(i, "particles/position"), fr["positions"])
                np.testing.assert_array_equal(
                    f.read_chunk(i, "particles/typeid"), fr["typeid"])
            # box written once at frame 0, falls back for later frames
            np.testing.assert_allclose(
                f.read_chunk(3, "configuration/box")[:3], [6, 6, 6])

    def test_chunk_fallback_semantics(self, tmp_path):
        path = str(tmp_path / "t.gsd")
        with GSDFile(path, mode="w") as f:
            f.write_chunk("particles/N", np.array([3], np.uint32))
            f.write_chunk("particles/position",
                          np.zeros((3, 3), np.float32))
            f.end_frame()
            f.write_chunk("particles/position",
                          np.ones((3, 3), np.float32))
            f.end_frame()
        with GSDFile(path) as f:
            # N absent in frame 1 -> falls back to frame 0
            assert int(f.read_chunk(1, "particles/N")[0]) == 3
            np.testing.assert_allclose(
                f.read_chunk(1, "particles/position"), 1.0)

    def test_missing_chunk_raises(self, tmp_path):
        path = str(tmp_path / "t.gsd")
        with GSDFile(path, mode="w") as f:
            f.write_chunk("particles/N", np.array([1], np.uint32))
            f.end_frame()
        with GSDFile(path) as f:
            with pytest.raises(KeyError):
                f.read_chunk(0, "particles/nope")

    def test_unsupported_dtype_raises(self, tmp_path):
        with GSDFile(str(tmp_path / "t.gsd"), mode="w") as f:
            with pytest.raises(TypeError):
                f.write_chunk("particles/x", np.zeros(3, np.complex64))

    def test_tensor_frames(self, tmp_path):
        """Tensors (float64 included) are written as the hoomd schema's
        float32, as numpy frames are."""
        frames = frames_of(3, forces=True)
        tframes = [{k: (torch.as_tensor(v, dtype=torch.float64)
                        if k in ("positions", "velocity", "forces") else v)
                    for k, v in fr.items()} for fr in frames]
        a, b = str(tmp_path / "a.gsd"), str(tmp_path / "b.gsd")
        write_gsd_frames(a, frames, box=[6.0, 6.0, 6.0])
        write_gsd_frames(b, tframes, box=torch.tensor([6.0, 6.0, 6.0]))
        assert_bit_equal(chunks(GSDFile, a), chunks(GSDFile, b))


class TestCrossPackage:
    @pytest.mark.parametrize("writer", ["port", "jax"])
    def test_read_by_the_other(self, tmp_path, writer):
        """A file either package writes reads chunk for chunk bit-equal
        through both readers, and equals the file the other writer makes
        of the same frames, byte for byte."""
        frames = frames_of(4)
        bonds = [[0, 1], [2, 3], [4, 5]]
        paths = {}
        for who, fn in (("port", write_gsd_frames),
                        ("jax", jgsd.write_gsd_frames)):
            paths[who] = str(tmp_path / f"{who}.gsd")
            fn(paths[who], frames, box=[6, 6, 6, 0.1, 0.0, 0.2],
               bonds=bonds)
        path = paths[writer]
        port, jax_ = chunks(GSDFile, path), chunks(jgsd.GSDFile, path)
        assert_bit_equal(port, jax_)
        np.testing.assert_array_equal(port[(2, "log/particles/force")],
                                      frames[2]["forces"])
        with open(paths["port"], "rb") as f1, open(paths["jax"], "rb") as f2:
            assert f1.read() == f2.read()

    def test_committed_fixture_read_by_both(self):
        assert_bit_equal(chunks(GSDFile, FIXTURE),
                         chunks(jgsd.GSDFile, FIXTURE))
        u, v = GSDUniverse(FIXTURE), jgsd.GSDUniverse(FIXTURE)
        np.testing.assert_array_equal(u.dimensions, v.dimensions)
        np.testing.assert_array_equal(u.bonds, v.bonds)
        for _ in zip(u.trajectory, v.trajectory):
            a, b = u.select_atoms("all"), v.select_atoms("all")
            np.testing.assert_array_equal(a.positions, b.positions)
            np.testing.assert_array_equal(a.forces, b.forces)
            np.testing.assert_array_equal(a.velocities, b.velocities)
            np.testing.assert_array_equal(a.types, b.types)

    def test_both_libraries_loaded(self, tmp_path):
        """The two native libraries (the same C symbols) live in one
        process under their own handles: each package's calls reach its
        own file."""
        from hoomd_tf_tpu.native import gsd_lib as jax_lib
        from hoomd_tf_tpu_torch.utils.gsd_io import gsd_lib
        assert gsd_lib()._name != jax_lib()._name
        assert os.path.basename(gsd_lib()._name).startswith("libgsd-")
        path = str(tmp_path / "t.gsd")
        write_gsd_frames(path, frames_of(5, count=2), box=[6, 6, 6])
        assert_bit_equal(chunks(GSDFile, path), chunks(jgsd.GSDFile, path))

    @pytest.mark.parametrize("tilt", [False, True])
    def test_iter_from_trajectory_both_universes(self, tmp_path, tilt):
        """``iter_from_trajectory`` over both packages' GSDUniverse on one
        file: the same positions and box, and lists within 1e-6."""
        rng = np.random.RandomState(6)
        frames = [{"positions": (rng.rand(40, 3) * 8 - 4).astype(
            np.float32), "typeid": (np.arange(40) % 2).astype(np.uint32)}
            for _ in range(3)]
        box = [8, 8, 8, 0.2, 0.1, 0.0] if tilt else [8, 8, 8]
        path = str(tmp_path / "traj.gsd")
        write_gsd_frames(path, frames, box=box)
        port = list(htt.iter_from_trajectory(
            12, GSDUniverse(path), r_cut=3.0, device="cpu"))
        jax_ = list(htf.iter_from_trajectory(
            12, jgsd.GSDUniverse(path), r_cut=3.0))
        assert len(port) == len(jax_) == 3
        for (pi, pts), (ji, jts) in zip(port, jax_):
            np.testing.assert_array_equal(np_(pi[1]), np.asarray(ji[1]))
            np.testing.assert_allclose(np_(pi[2]), np.asarray(ji[2]),
                                       atol=1e-7)
            np.testing.assert_allclose(np_(pi[0]), np.asarray(ji[0]),
                                       atol=1e-6)
            np.testing.assert_array_equal(pts.positions, jts.positions)


class TestUniverseAdapter:
    def test_iter_from_trajectory(self, tmp_path):
        rng = np.random.RandomState(1)
        frames = [{"positions": (rng.rand(10, 3) * 8 - 4).astype(np.float32)}
                  for _ in range(3)]
        path = str(tmp_path / "traj.gsd")
        write_gsd_frames(path, frames, box=[8, 8, 8])
        u = GSDUniverse(path)
        outs = list(htt.iter_from_trajectory(6, u, r_cut=3.0, device="cpu"))
        assert len(outs) == 3
        nlist, positions, box = outs[1][0]
        assert tuple(nlist.shape) == (10, 6, 4)
        np.testing.assert_allclose(np_(positions)[:, :3],
                                   frames[1]["positions"], atol=1e-6)

    def test_forces_and_velocities_roundtrip(self, tmp_path):
        """Force/velocity labels survive the GSD roundtrip and surface on
        the yielded frame."""
        rng = np.random.RandomState(2)
        frames = [{"positions": (rng.rand(8, 3) * 6 - 3).astype(np.float32),
                   "velocity": rng.randn(8, 3).astype(np.float32),
                   "forces": rng.randn(8, 3).astype(np.float32)}
                  for _ in range(3)]
        path = str(tmp_path / "traj.gsd")
        write_gsd_frames(path, frames, box=[6, 6, 6])
        u = GSDUniverse(path)
        outs = list(htt.iter_from_trajectory(4, u, r_cut=2.0, device="cpu"))
        assert len(outs) == 3
        for i, (inputs, ts) in enumerate(outs):
            np.testing.assert_array_equal(ts.forces, frames[i]["forces"])
            np.testing.assert_array_equal(ts.velocities,
                                          frames[i]["velocity"])

    def test_forces_absent_raises(self, tmp_path):
        path = str(tmp_path / "t.gsd")
        write_gsd_frames(
            path, [{"positions": np.zeros((3, 3), np.float32)}],
            box=[5, 5, 5])
        u = GSDUniverse(path)
        (inputs, ts), = list(htt.iter_from_trajectory(2, u, r_cut=2.0,
                                                      device="cpu"))
        with pytest.raises(AttributeError):
            ts.forces
        with pytest.raises(AttributeError):
            u.particles.velocities
        with pytest.raises(ValueError):
            u.select_atoms("name C")

    def test_simulation_trajectory_to_gsd_and_back(self, tmp_path):
        """End to end on the port's CPU engine: run MD, dump the state's
        tensors through the native writer, re-read them bit-equal (float32)
        and evaluate a model over the file, against the JAX model on the
        JAX universe of the same file."""
        import zoo
        n = 16
        sim = htt.Simulation(dt=0.002, seed=0, device="cpu",
                             integrator=htt.md.NVT(kT=0.8, tau=0.5))
        sim.init_lattice(n, a=1.5, kT_init=0.8)
        sim.add_force(htt.md.LennardJones(r_cut=3.0))

        class Observer(htt.SimModel):
            def compute(self, nlist, positions):
                return torch.linalg.norm(positions, dim=1)

        htt.tfcompute(Observer(n - 1, output_forces=False)).attach(
            sim, r_cut=3.0)
        frames = []
        for _ in range(3):
            sim.run(5)
            st = sim.state
            frames.append({"positions": st.positions.clone(),
                           "velocity": st.velocities.clone(),
                           "forces": st.forces[:, :3].clone(),
                           "typeid": np.zeros(n, np.uint32),
                           "step": st.step})
        path = str(tmp_path / "md.gsd")
        write_gsd_frames(path, frames, box=htt.box_size(sim.state.box))
        with GSDFile(path) as f:
            assert f.nframes == 3
            for i, fr in enumerate(frames):
                np.testing.assert_array_equal(
                    f.read_chunk(i, "particles/position"),
                    np_(fr["positions"]))
                np.testing.assert_array_equal(
                    f.read_chunk(i, "log/particles/force"),
                    np_(fr["forces"]))
                assert int(f.read_chunk(i, "configuration/step")[0]) == \
                    fr["step"]

        class LJ(htt.SimModel):
            def compute(self, nlist, positions, box):
                rinv = htt.nlist_rinv(nlist)
                inv_r6 = rinv ** 6
                energy = torch.sum(2.0 * (inv_r6 * inv_r6 - inv_r6), dim=1)
                return htt.compute_nlist_forces(nlist, energy)

        port = [LJ(n - 1)(inputs)[0].detach().numpy() for inputs, _ in
                htt.iter_from_trajectory(n - 1, GSDUniverse(path),
                                         r_cut=3.0, device="cpu")]
        jax_ = [np.asarray(zoo.LJModel(n - 1)(inputs)[0]) for inputs, _ in
                htf.iter_from_trajectory(n - 1, jgsd.GSDUniverse(path),
                                         r_cut=3.0)]
        assert len(port) == len(jax_) == 3
        for a, b in zip(port, jax_):
            assert np.all(np.isfinite(a))
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
