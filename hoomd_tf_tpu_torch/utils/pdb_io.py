"""Minimal native PDB topology/trajectory reader (PyTorch port of
``hoomd_tf_tpu/utils/pdb_io.py``, numpy only).

The reference runs its CG pipeline on real PDB/TRR files through
MDAnalysis (``test-py/test_utils.py:571-596``); MDAnalysis is an optional
dependency here, so this module provides a small self-contained
``PDBUniverse`` implementing the same universe protocol
(``select_atoms`` / ``trajectory`` / ``dimensions`` / atom ``names`` /
``masses`` / ``types`` / ``resnames`` / ``resids`` / ``bonds``) that
:func:`.trajectory.iter_from_trajectory`, :func:`.cg.matrix_mapping`,
:func:`.cg.find_molecules_from_topology` and friends consume.

Parsed PDB features: ``ATOM``/``HETATM`` fixed-column records, ``CRYST1``
box, ``CONECT`` bonds, multi-frame ``MODEL``/``ENDMDL`` trajectories.
The JAX package's GSD frames (``traj=``) need its GSD reader, which the
port does not have yet (ROADMAP.md Queue 1 item 6).

The universe's arrays stay numpy, as MDAnalysis' do; they become tensors
where a consumer makes them so (:func:`.trajectory.iter_from_trajectory`,
:func:`.cg.center_of_mass`), on that consumer's device.
"""

import fnmatch

import numpy as np

__all__ = ["PDBUniverse", "ELEMENT_MASSES"]

ELEMENT_MASSES = {
    "H": 1.008, "C": 12.011, "N": 14.007, "O": 15.999, "F": 18.998,
    "NA": 22.990, "MG": 24.305, "P": 30.974, "S": 32.06, "CL": 35.45,
    "K": 39.098, "CA": 40.078, "FE": 55.845, "ZN": 65.38, "BR": 79.904,
    "I": 126.904,
}


def _guess_element(name, element_field):
    e = element_field.strip().upper()
    if e:
        return e
    # PDB convention: element is the first alphabetic char of the name
    # (names like '1HB' start with a digit)
    for ch in name.strip():
        if ch.isalpha():
            return ch.upper()
    return "C"


class _PDBAtomGroup:
    """A subset of a PDBUniverse's atoms (the MDAnalysis AtomGroup
    protocol subset the CG utilities use)."""

    def __init__(self, universe, indices):
        self._u = universe
        self._idx = np.asarray(indices, dtype=np.int64)
        self.atoms = self

    def __len__(self):
        return len(self._idx)

    @property
    def n_atoms(self):
        return len(self._idx)

    @property
    def names(self):
        return self._u._names[self._idx]

    @property
    def masses(self):
        return self._u._masses[self._idx]

    @property
    def types(self):
        return self._u._elements[self._idx]

    @property
    def resnames(self):
        return self._u._resnames[self._idx]

    @property
    def resids(self):
        return self._u._resids[self._idx]

    @property
    def positions(self):
        return self._u._positions[self._idx]

    @property
    def bonds(self):
        return _Bonds(self._u, self._idx)

    def center_of_mass(self):
        m = self.masses[:, None]
        return (self.positions * m).sum(0) / m.sum()

    def select_atoms(self, selection):
        keep = self._u._match(selection)
        return _PDBAtomGroup(self._u,
                             self._idx[keep[self._idx]])

    def __add__(self, other):
        return _PDBAtomGroup(
            self._u, np.concatenate([self._idx, other._idx]))


class _Bonds:
    def __init__(self, universe, indices):
        idx = set(int(i) for i in indices)
        self._pairs = np.asarray(
            [p for p in universe._bonds
             if p[0] in idx and p[1] in idx], dtype=np.int64).reshape(-1, 2)

    def to_indices(self):
        return self._pairs

    def __len__(self):
        return len(self._pairs)


class _PDBTimestep:
    def __init__(self, frame):
        self.frame = frame


class PDBUniverse:
    """Universe over a PDB file.

    :param pdb_path: topology (+ frames, via MODEL/ENDMDL blocks).
    :param traj: a GSD file of frames: not ported yet (raises).
    """

    def __init__(self, pdb_path, traj=None):
        if traj is not None:
            raise NotImplementedError(
                "GSD frames (traj=) arrive with the GSD reader, a later "
                "slice of the PyTorch port (ROADMAP.md Queue 1 item 6)")
        names, elements, resnames, resids, xyz = [], [], [], [], []
        frames = []
        bonds = set()
        box = np.array([0.0, 0, 0, 90, 90, 90])
        serial_to_index = {}
        in_first_model = True
        with open(pdb_path) as f:
            for line in f:
                rec = line[:6]
                if rec in ("ATOM  ", "HETATM"):
                    if in_first_model:
                        serial = line[6:11].strip()
                        serial_to_index[serial] = len(names)
                        names.append(line[12:16].strip())
                        resnames.append(line[17:20].strip() or "MOL")
                        resids.append(int(line[22:26] or 0))
                        elements.append(
                            _guess_element(line[12:16], line[76:78]))
                    xyz.append([float(line[30:38]), float(line[38:46]),
                                float(line[46:54])])
                elif rec == "CRYST1":
                    box = np.array([float(line[6:15]), float(line[15:24]),
                                    float(line[24:33]), float(line[33:40]),
                                    float(line[40:47]), float(line[47:54])])
                elif rec == "CONECT":
                    fields = line.split()[1:]
                    a = serial_to_index.get(fields[0])
                    for s in fields[1:]:
                        b = serial_to_index.get(s)
                        if a is not None and b is not None and a != b:
                            bonds.add((min(a, b), max(a, b)))
                elif rec.startswith("ENDMDL"):
                    if xyz:
                        frames.append(np.asarray(xyz, dtype=np.float32))
                        xyz = []
                    in_first_model = False
        if xyz:
            frames.append(np.asarray(xyz, dtype=np.float32))

        self._names = np.asarray(names)
        self._elements = np.asarray(elements)
        self._resnames = np.asarray(resnames)
        self._resids = np.asarray(resids, dtype=np.int64)
        self._masses = np.asarray(
            [ELEMENT_MASSES.get(e, 12.011) for e in elements])
        self._bonds = sorted(bonds)
        self._frames = frames
        self._positions = self._read_frame(0)
        self.dimensions = box
        self.atoms = _PDBAtomGroup(self, np.arange(len(self._names)))

    # -- frames ---------------------------------------------------------
    @property
    def n_frames(self):
        return len(self._frames)

    def _read_frame(self, i):
        return self._frames[i]

    @property
    def trajectory(self):
        def gen():
            for i in range(self.n_frames):
                self._positions = self._read_frame(i)
                yield _PDBTimestep(i)
        return gen()

    # -- selection ------------------------------------------------------
    def _match(self, selection):
        """Boolean mask over all atoms for a (deliberately small)
        selection grammar: ``all``, ``name A B*``, ``type C H``,
        ``resname X``, each optionally prefixed with ``not``."""
        sel = selection.strip()
        n = len(self._names)
        if sel == "all":
            return np.ones(n, dtype=bool)
        invert = False
        if sel.startswith("not "):
            invert = True
            sel = sel[4:].strip()
        parts = sel.split()
        field = {"name": self._names, "type": self._elements,
                 "resname": self._resnames}.get(parts[0])
        if field is None or len(parts) < 2:
            raise ValueError(
                f"PDBUniverse supports 'all', '[not] name/type/resname "
                f"<patterns>' selections only, got {selection!r}")
        keep = np.zeros(n, dtype=bool)
        for pat in parts[1:]:
            keep |= np.asarray(
                [fnmatch.fnmatch(v, pat) for v in field])
        return ~keep if invert else keep

    def select_atoms(self, selection):
        return _PDBAtomGroup(self, np.nonzero(self._match(selection))[0])
