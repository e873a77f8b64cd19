"""GSD trajectory I/O on the package's own native library
(``csrc/gsd.cpp``, built with ``g++`` at first use), plus a universe
adapter so :func:`.iter_from_trajectory` consumes .gsd files directly (no
MDAnalysis or ``gsd`` package required). PyTorch counterpart of
``hoomd_tf_tpu/utils/gsd_io.py``: the same file format and the same
chunks, so a file written by either package is read by the other.

The hoomd schema stores positions, velocities and forces as float32, so
the frames of a float64 simulation are written rounded to float32.
"""

import ctypes

import numpy as np
import torch

__all__ = ["GSDFile", "GSDUniverse", "write_gsd_frames"]

_DTYPES = {1: np.uint8, 2: np.uint16, 3: np.uint32, 4: np.uint64,
           5: np.int8, 6: np.int16, 7: np.int32, 8: np.int64,
           9: np.float32, 10: np.float64}
_TYPE_IDS = {np.dtype(v).name: k for k, v in _DTYPES.items()}

_LIB = None


def gsd_lib():
    """The native GSD library (built from ``csrc/gsd.cpp`` on first use)."""
    global _LIB
    if _LIB is None:
        from .._build import build_host_library
        lib = ctypes.CDLL(str(build_host_library("gsd")))
        lib.htf_gsd_open.restype = ctypes.c_void_p
        lib.htf_gsd_open.argtypes = [ctypes.c_char_p]
        lib.htf_gsd_nframes.restype = ctypes.c_uint64
        lib.htf_gsd_nframes.argtypes = [ctypes.c_void_p]
        lib.htf_gsd_schema.restype = ctypes.c_char_p
        lib.htf_gsd_schema.argtypes = [ctypes.c_void_p]
        lib.htf_gsd_chunk_info.restype = ctypes.c_int
        lib.htf_gsd_chunk_info.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint8)]
        lib.htf_gsd_read_chunk.restype = ctypes.c_int
        lib.htf_gsd_read_chunk.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p,
            ctypes.c_void_p]
        lib.htf_gsd_create.restype = ctypes.c_void_p
        lib.htf_gsd_create.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                       ctypes.c_char_p, ctypes.c_uint32]
        lib.htf_gsd_write_chunk.restype = ctypes.c_int
        lib.htf_gsd_write_chunk.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint8,
            ctypes.c_uint64, ctypes.c_uint32, ctypes.c_void_p]
        lib.htf_gsd_end_frame.restype = ctypes.c_int
        lib.htf_gsd_end_frame.argtypes = [ctypes.c_void_p]
        lib.htf_gsd_close.restype = ctypes.c_int
        lib.htf_gsd_close.argtypes = [ctypes.c_void_p]
        _LIB = lib
    return _LIB


class GSDFile:
    """Read/write GSD files through the native library.

    Read mode::

        with GSDFile("traj.gsd") as f:
            pos = f.read_chunk(0, "particles/position")

    Write mode::

        with GSDFile("out.gsd", mode="w", schema="hoomd") as f:
            f.write_chunk("particles/N", np.array([n], np.uint32))
            f.write_chunk("particles/position", pos.astype(np.float32))
            f.end_frame()
    """

    def __init__(self, path, mode="r", application="hoomd_tf_tpu",
                 schema="hoomd", schema_version=(1, 4)):
        self._lib = gsd_lib()
        path = str(path)
        if mode == "r":
            self._h = self._lib.htf_gsd_open(path.encode())
            if not self._h:
                raise OSError(f"Could not open GSD file {path!r}")
        elif mode == "w":
            ver = (schema_version[0] << 16) | schema_version[1]
            self._h = self._lib.htf_gsd_create(
                path.encode(), application.encode(), schema.encode(), ver)
            if not self._h:
                raise OSError(f"Could not create GSD file {path!r}")
        else:
            raise ValueError(f"bad mode {mode!r}")

    # -- read ---------------------------------------------------------------
    @property
    def nframes(self):
        return int(self._lib.htf_gsd_nframes(self._h))

    @property
    def schema(self):
        return self._lib.htf_gsd_schema(self._h).decode()

    def _info(self, frame, name):
        n, m, t = ctypes.c_uint64(), ctypes.c_uint32(), ctypes.c_uint8()
        ok = self._lib.htf_gsd_chunk_info(
            self._h, frame, name.encode(), ctypes.byref(n), ctypes.byref(m),
            ctypes.byref(t))
        return ok, n.value, m.value, t.value

    def chunk_exists(self, frame, name):
        return bool(self._info(frame, name)[0])

    def read_chunk(self, frame, name):
        """Chunk as a numpy array ``[N, M]`` (``[N]`` if M == 1); GSD's
        fall-back-to-frame-0 semantics apply."""
        ok, n, m, t = self._info(frame, name)
        if not ok:
            raise KeyError(f"chunk {name!r} not in frame {frame}")
        out = np.empty((n, m), dtype=_DTYPES[t])
        if not self._lib.htf_gsd_read_chunk(
                self._h, frame, name.encode(),
                out.ctypes.data_as(ctypes.c_void_p)):
            raise OSError(f"failed reading chunk {name!r}")
        return out[:, 0] if m == 1 else out

    # -- write --------------------------------------------------------------
    def write_chunk(self, name, data):
        data = np.ascontiguousarray(data)
        if data.ndim == 0:
            data = data.reshape(1)
        n = data.shape[0]
        m = int(np.prod(data.shape[1:])) if data.ndim > 1 else 1
        tid = _TYPE_IDS.get(data.dtype.name)
        if tid is None:
            raise TypeError(f"unsupported dtype {data.dtype}")
        if not self._lib.htf_gsd_write_chunk(
                self._h, name.encode(), tid, n, m,
                data.ctypes.data_as(ctypes.c_void_p)):
            raise OSError(f"failed writing chunk {name!r}")

    def end_frame(self):
        self._lib.htf_gsd_end_frame(self._h)

    # -- lifecycle ----------------------------------------------------------
    def close(self):
        if self._h:
            ok = self._lib.htf_gsd_close(self._h)
            self._h = None
            if not ok:
                raise OSError("failed closing GSD file")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _host_frame(fr):
    """A frame's arrays on the host: the tensors among them, when they
    share a device other than the CPU, copied in one transfer of their
    bytes."""
    keys = [k for k, v in fr.items() if torch.is_tensor(v)]
    if not keys:
        return fr
    out = dict(fr)
    parts = [fr[k].detach().contiguous() for k in keys]
    dev = parts[0].device
    if dev.type == "cpu" or any(p.device != dev for p in parts):
        out.update((k, p.cpu().numpy()) for k, p in zip(keys, parts))
        return out
    raw = torch.cat([p.reshape(-1).view(torch.uint8) for p in parts])
    raw = raw.cpu().numpy()
    o = 0
    for k, p in zip(keys, parts):
        nbytes = p.numel() * p.element_size()
        dtype = torch.empty((), dtype=p.dtype).numpy().dtype
        out[k] = raw[o:o + nbytes].view(dtype).reshape(p.shape)
        o += nbytes
    return out


def write_gsd_frames(path, frames, box=None, types=None, bonds=None):
    """Write a trajectory of hoomd-schema frames.

    :param path: output file.
    :param frames: iterable of dicts with ``positions`` [N,3] (and optional
        ``typeid`` [N], ``velocity`` [N,3], ``forces`` [N,3], ``step``),
        numpy arrays or tensors (on the card, a frame's tensors are copied
        to the host in one transfer). Stored as float32 (the hoomd
        schema): a float64 state's frames are rounded.
    :param box: ``[Lx, Ly, Lz]`` or 6-vector (with tilts).
    :param types: list of type-name strings.
    :param bonds: optional ``[B, 2]`` int bond topology, written to frame 0
        as the hoomd-schema ``bonds/N`` + ``bonds/group`` chunks (what
        HOOMD-blue writes and MDAnalysis reads as universe bonds).
    """
    if torch.is_tensor(box):
        box = box.detach().cpu().numpy()
    with GSDFile(path, mode="w") as f:
        for i, fr in enumerate(frames):
            fr = _host_frame(fr)
            if i == 0 and bonds is not None:
                b2 = np.asarray(bonds, dtype=np.uint32).reshape(-1, 2)
                f.write_chunk("bonds/N", np.array([b2.shape[0]], np.uint32))
                f.write_chunk("bonds/group", b2)
            pos = np.asarray(fr["positions"], dtype=np.float32)
            n = pos.shape[0]
            f.write_chunk("configuration/step",
                          np.array([fr.get("step", i)], np.uint64))
            if box is not None and (i == 0 or "box" in fr):
                b = np.asarray(fr.get("box", box), dtype=np.float32).ravel()
                if b.size == 3:
                    b = np.concatenate([b, np.zeros(3, np.float32)])
                f.write_chunk("configuration/box", b.astype(np.float32))
            f.write_chunk("particles/N", np.array([n], np.uint32))
            f.write_chunk("particles/position", pos[:, :3])
            if "typeid" in fr:
                f.write_chunk("particles/typeid",
                              np.asarray(fr["typeid"], np.uint32))
            if "velocity" in fr:
                f.write_chunk("particles/velocity",
                              np.asarray(fr["velocity"], np.float32))
            if "forces" in fr:
                # hoomd-v3 logging convention for per-particle net force
                f.write_chunk("log/particles/force",
                              np.asarray(fr["forces"], np.float32)[:, :3])
            f.end_frame()


class _GSDAtomGroup:
    def __init__(self, universe):
        self._u = universe
        self.atoms = self

    @property
    def positions(self):
        return self._u._positions

    @property
    def types(self):
        return self._u._types

    @property
    def velocities(self):
        if self._u._velocities is None:
            raise AttributeError("this GSD trajectory has no velocities")
        return self._u._velocities

    @property
    def forces(self):
        if self._u._forces is None:
            raise AttributeError("this GSD trajectory has no forces")
        return self._u._forces

    @property
    def n_atoms(self):
        return self._u._n

    def __len__(self):
        return self._u._n


class _GSDTimestep:
    def __init__(self, frame):
        self.frame = frame


class GSDUniverse:
    """MDAnalysis-Universe-like adapter over a GSD trajectory, sufficient
    for :func:`.iter_from_trajectory`: trajectory I/O with no optional
    dependency, through the native library. Arrays are numpy, on the
    host.
    """

    def __init__(self, path):
        self._file = GSDFile(path)
        self._group = _GSDAtomGroup(self)
        self._load_frame(0)
        box = self._file.read_chunk(0, "configuration/box").astype(
            np.float64).ravel()
        # gsd box: [lx, ly, lz, xy, xz, yz] -> MDAnalysis-style
        # [lx, ly, lz, alpha, beta, gamma]. The angle formulas are the
        # exact inverse of iter_from_trajectory's angle->tilt conversion
        # (xy = cot(gamma), xz = cos(beta), yz = cos(alpha) - xy*xz with
        # its b = c = 1 normalization), so tilted GSD boxes round-trip.
        xy, xz, yz = box[3], box[4], box[5]
        gamma = np.degrees(np.pi / 2 - np.arctan(xy))
        beta = np.degrees(np.arccos(np.clip(xz, -1.0, 1.0)))
        alpha = np.degrees(np.arccos(np.clip(yz + xy * xz, -1.0, 1.0)))
        self.dimensions = np.array(
            [box[0], box[1], box[2], alpha, beta, gamma])

    def _load_frame(self, i):
        self._positions = np.asarray(
            self._file.read_chunk(i, "particles/position"),
            dtype=np.float32)
        self._n = self._positions.shape[0]
        if self._file.chunk_exists(i, "particles/typeid"):
            self._types = self._file.read_chunk(
                i, "particles/typeid").astype(str)
        else:
            self._types = np.zeros(self._n, dtype=np.int32).astype(str)
        self._velocities = None
        if self._file.chunk_exists(i, "particles/velocity"):
            self._velocities = np.asarray(self._file.read_chunk(
                i, "particles/velocity"), dtype=np.float32)
        self._forces = None
        for name in ("log/particles/force", "particles/force",
                     "log/particles/net_force"):
            if self._file.chunk_exists(i, name):
                self._forces = np.asarray(self._file.read_chunk(
                    i, name), dtype=np.float32)
                break

    @property
    def bonds(self):
        """``[B, 2]`` int bond topology from frame 0 (``bonds/group``), or
        an empty array when the file carries none (duck-compatible with
        :func:`.cg.find_molecules` system objects)."""
        if self._file.chunk_exists(0, "bonds/group"):
            return self._file.read_chunk(0, "bonds/group").astype(
                np.int64).reshape(-1, 2)
        return np.zeros((0, 2), dtype=np.int64)

    @property
    def particles(self):
        return self._group

    def select_atoms(self, selection):
        if selection != "all":
            raise ValueError(
                "GSDUniverse supports selection='all' only; use MDAnalysis "
                "for rich selections")
        return self._group

    @property
    def trajectory(self):
        def gen():
            for i in range(self._file.nframes):
                self._load_frame(i)
                yield _GSDTimestep(i)
        return gen()
