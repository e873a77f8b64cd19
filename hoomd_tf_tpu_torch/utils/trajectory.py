"""Trajectory-driven workflows, with no simulation engine (PyTorch port
of ``hoomd_tf_tpu/utils/trajectory.py``, the reference's
``utils.py:164-233, 627-749``): iterate a trajectory into model inputs,
scan a two-particle separation, build gsd snapshots. Any object with the
small universe protocol (``select_atoms``, ``trajectory``,
``dimensions``, atom ``positions`` / ``types``) works: an MDAnalysis
Universe, a :class:`.gsd_io.GSDUniverse`, a :class:`.pdb_io.PDBUniverse`,
or the tests' stand-ins.
"""

import numpy as np
import torch

from .._device import resolve_device
from ..models.module import StateSnapshot
from ..ops.nlist import compute_nlist

__all__ = ["iter_from_trajectory", "compute_pairwise", "create_frame",
           "TrajectoryFrame"]


class TrajectoryFrame:
    """A selection-consistent view of one trajectory frame (the
    reference's sub-universe, ``utils.py:666-686``): ``positions``,
    ``velocities`` and ``forces`` are the selection's numpy arrays taken
    when the frame is yielded (MDAnalysis mutates one live Timestep per
    frame; the copies keep frames collected with ``list(...)`` apart);
    everything else (``frame``, ``time``, ...) reads the underlying
    timestep. ``velocities`` and ``forces`` raise ``AttributeError`` when
    the trajectory has none, as MDAnalysis does."""

    def __init__(self, ts, atom_group):
        self._ts = ts
        self.positions = np.array(atom_group.positions, dtype=np.float32)
        self._velocities = self._snap(atom_group, "velocities")
        self._forces = self._snap(atom_group, "forces")

    @staticmethod
    def _snap(group, name):
        # MDAnalysis raises NoDataError (both an AttributeError and a
        # ValueError) when the trajectory lacks the attribute
        try:
            return np.array(getattr(group, name), dtype=np.float32)
        except (AttributeError, ValueError):
            return None

    @property
    def velocities(self):
        if self._velocities is None:
            raise AttributeError("this trajectory has no velocities")
        return self._velocities

    @property
    def forces(self):
        if self._forces is None:
            raise AttributeError("this trajectory has no forces")
        return self._forces

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "_ts"), name)

    def __repr__(self):
        return f"TrajectoryFrame({self._ts!r})"


def iter_from_trajectory(nneighbor_cutoff, universe, selection="all",
                         r_cut=10.0, period=1, start=0, end=None,
                         progress=False, device=None):
    """Yield ``([nlist, positions, box], frame)`` per trajectory frame,
    the inputs of a :class:`.SimModel` (``model(inputs)``) as tensors on
    ``device``, and the frame as a :class:`TrajectoryFrame` (its
    ``forces`` are offline force matching's labels). The box angles become
    HOOMD tilt factors as in the reference (``utils.py:689-702``).

    The neighbor list (:func:`..ops.nlist.compute_nlist`, the neighbor's
    index in its last channel) is built for **every** frame: the JAX
    package's deliberate fix of the reference, which built it once from
    frame 0 (``utils.py:717-749``).

    :param nneighbor_cutoff: maximum neighbors NN.
    :param universe: an MDAnalysis universe or one with its protocol.
    :param selection: atom selection string.
    :param r_cut: neighbor cutoff radius.
    :param period: yield every ``period``-th frame.
    :param start: first frame to include.
    :param end: last frame to include (inclusive; default: all).
    :param progress: show a tqdm progress bar if available.
    :param device: where the tensors go (default: the CUDA card; pass
        ``device="cpu"`` for the CPU).
    """
    device = resolve_device(device, "iter_from_trajectory")
    atom_group = universe.select_atoms(selection)
    box = np.asarray(universe.dimensions, dtype=np.float64)
    # lattice angles -> hoomd tilt factors (the reference's, its b = c = 1
    # normalization included, utils.py:690-700)
    b = 1.0
    c = 1.0
    alpha, beta, gamma = np.deg2rad(box[3]), np.deg2rad(box[4]), \
        np.deg2rad(box[5])
    xy = 1.0 / np.tan(gamma)
    xz = c * np.cos(beta)
    yz = b * c * np.cos(alpha) - xy * xz
    hoomd_box = np.array([[0, 0, 0], [box[0], box[1], box[2]],
                          [xy, xz, yz]], dtype=np.float32)
    box_t = torch.as_tensor(hoomd_box, device=device)
    # skewed frames get the triclinic minimum image
    tilted = bool(np.any(np.abs(hoomd_box[2]) > 1e-6))
    nlist_box = box_t if tilted else torch.as_tensor(
        box[:3], dtype=torch.float32, device=device)
    try:
        types = list(np.unique(atom_group.atoms.types))
        type_array = np.array(
            [types.index(t) for t in atom_group.atoms.types],
            dtype=np.float32).reshape(-1, 1)
    except Exception:
        type_array = np.zeros((len(atom_group), 1), dtype=np.float32)

    frames = universe.trajectory
    if progress:
        try:
            from tqdm import tqdm
            frames = tqdm(frames)
        except ImportError:
            pass
    if end is None:
        end = float("inf")
    for i, ts in enumerate(frames):
        frame = getattr(ts, "frame", i)
        if frame < start or frame > end:
            continue
        if i % period != 0:
            continue
        positions = torch.as_tensor(np.concatenate(
            [np.asarray(atom_group.positions, dtype=np.float32),
             type_array], axis=1), device=device)
        nlist = compute_nlist(positions[:, :3], r_cut=r_cut,
                              NN=nneighbor_cutoff, box_size=nlist_box)
        yield ([nlist, positions, box_t], TrajectoryFrame(ts, atom_group))


def compute_pairwise(model, r, type_i=0, type_j=0, device=None):
    """A model's outputs for a two-particle system at each separation of
    ``r`` (the reference's ``utils.py:164-201``). One model call per
    separation (the JAX package maps one call over them); what the calls
    update in the model (a metric) is restored afterwards.

    :param model: a :class:`.SimModel`; it is moved to ``device``.
    :param r: 1D array of separations.
    :param type_i, type_j: the types of the two particles.
    :param device: where the model runs (default: the CUDA card; pass
        ``device="cpu"`` for the CPU).
    :return: list of numpy outputs, each stacked on a leading axis of
        ``len(r)``.
    """
    device = resolve_device(device, "compute_pairwise")
    model.to(device)
    NN = model.nneighbor_cutoff
    kw = dict(dtype=model.dtype, device=device)
    box = torch.tensor([[0.0, 0, 0], [1e10, 1e10, 1e10], [0, 0, 0]], **kw)
    base = np.zeros((2, NN, 4), dtype=np.float32)
    base[0, :, 3] = type_j
    base[1, :, 3] = type_i
    positions = np.zeros((2, 4), dtype=np.float32)
    positions[0, 3] = type_i
    positions[1, 3] = type_j
    positions = torch.as_tensor(positions, **kw)
    r = np.asarray(r, dtype=np.float32)
    nlists = np.broadcast_to(base, (len(r),) + base.shape).copy()
    nlists[:, 0, 0, 1] = r
    nlists[:, 1, 0, 1] = -r
    nlists = torch.as_tensor(nlists, **kw)
    snap = StateSnapshot(model)
    try:
        outs = [model([nl, positions, box]) for nl in nlists]
    finally:
        snap.restore()
    return [np.stack([o[k].detach().cpu().numpy() for o in outs])
            for k in range(len(outs[0]))]


def create_frame(frame_number, N, types, typeids, positions, box):
    """A gsd snapshot (the reference's ``utils.py:204-233``): the ``gsd``
    package's when it is installed, else a lightweight snapshot of the
    same schema, which the native GSD writer
    (:func:`.gsd_io.write_gsd_frames` / :class:`.gsd_io.GSDFile`)
    understands, so the workflow needs no optional dependency."""
    try:
        import gsd.hoomd
        s = gsd.hoomd.Snapshot()
    except ImportError:
        from types import SimpleNamespace
        s = SimpleNamespace(configuration=SimpleNamespace(),
                            particles=SimpleNamespace())
    s.configuration.step = frame_number
    s.configuration.box = box
    s.particles.N = N
    s.particles.types = types
    s.particles.typeid = typeids
    s.particles.position = positions
    return s
