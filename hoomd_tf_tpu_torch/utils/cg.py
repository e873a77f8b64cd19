"""Coarse-graining utilities: molecule discovery, mapping operators,
PBC-aware centers of mass, exclusion lists (PyTorch port of
``hoomd_tf_tpu/utils/cg.py``, the reference's ``htf/utils.py`` CG stack).

Molecule discovery, the per-molecule mapping matrices and the exclusion
lists are host-side numpy, as in the JAX package. :func:`sparse_mapping`
returns a coalesced ``torch.sparse_csr`` operator made once on the
device, so :func:`center_of_mass`'s per-step product waits on nothing.
"""

import warnings

import numpy as np
import torch

from .._device import device_for, resolve_device

__all__ = ["find_molecules", "find_molecules_from_topology",
           "matrix_mapping", "sparse_mapping", "center_of_mass",
           "gen_mapped_exclusion_list", "gen_bonds_group",
           "compute_ohe_bead_type_interactions"]


def _bonds_of(system):
    """An ``[B, 2]`` int bond array of a system-like object: a
    :class:`..md.simulation.Simulation` (``.bonds``) or any object with
    ``.bonds`` as index pairs (or HOOMD-style bonds with ``a``, ``b``)."""
    bonds = getattr(system, "bonds", None)
    if bonds is None:
        raise ValueError("system has no bonds; set sim.bonds to an "
                         "[n_bonds, 2] index array")
    out = []
    for b in bonds:
        a = getattr(b, "a", None)
        if a is not None:
            out.append([int(a), int(b.b)])
        else:
            out.append([int(b[0]), int(b[1])])
    return np.asarray(out, dtype=np.int64).reshape(-1, 2)


def _n_particles_of(system):
    if getattr(system, "state", None) is not None:
        return system.state.n_particles
    particles = getattr(system, "particles", None)
    if particles is not None:
        return len(particles)
    raise ValueError("cannot determine particle count of system")


def find_molecules(system):
    """Molecule index lists from a system's bond graph (the reference's
    ``utils.py:236-284``): per molecule its atom indices ascending, the
    molecules ordered by their smallest index. Union-find over the bonds.

    :param system: a :class:`.Simulation` with ``bonds`` set (or anything
        exposing ``bonds`` and a particle count).
    """
    n = _n_particles_of(system)
    bonds = _bonds_of(system)
    parent = np.arange(n)

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for a, b in bonds:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[rb] = ra
    groups = {}
    for i in range(n):
        groups.setdefault(find(i), []).append(i)
    mapping = sorted(groups.values(), key=lambda m: m[0])
    return [sorted(m) for m in mapping]


def find_molecules_from_topology(universe, atoms_in_molecule_list,
                                 selection="all"):
    """Molecule index lists from an MDAnalysis-style topology (the
    reference's ``utils.py:287-337``): molecules are contiguous, and each
    atom's residue name picks the template whose length groups them.

    :param universe: an MDAnalysis Universe, a :class:`.pdb_io.
        PDBUniverse` or any object with ``select_atoms`` and
        ``atoms.resnames``.
    :param atoms_in_molecule_list: per residue type, its atom names.
    :param selection: atom selection string.
    """
    total = universe.select_atoms(selection).n_atoms
    resnames = np.asarray(universe.atoms.resnames)
    _, idx = np.unique(resnames, return_index=True)
    resname_list = resnames[np.sort(idx)].tolist()
    molecules = []
    current = []
    for i in range(total):
        mol_type = resname_list.index(resnames[i])
        mol_len = len(atoms_in_molecule_list[mol_type])
        if len(current) < mol_len:
            current.append(i)
        if len(current) == mol_len:
            molecules.append(current)
            current = []
    if molecules[-1][-1] != total - 1:
        raise Exception(
            "Mismatch found between the number of atoms in the system and "
            "the final index value. Check your atoms_in_molecule_list "
            "input.")
    return molecules


def matrix_mapping(molecule, beads_mappings, mass_weighted=True):
    """A molecule's ``M x N`` mapping matrix from bead definitions (the
    reference's ``utils.py:752-786``): rows are beads, columns atoms in
    topology order, entries the atom masses normalized per bead.

    :param molecule: an atom selection with ``names``, ``masses``,
        ``n_atoms`` and ``len``.
    :param beads_mappings: per bead, its atom names.
    :param mass_weighted: if False, returns ``(mass_weighted, binary)``.
    """
    mass_of = dict(zip(molecule.names, molecule.masses))
    m, n = len(beads_mappings), len(molecule)
    cg = np.zeros((m, n))
    col = 0
    for s, bead in enumerate(beads_mappings):
        for i, atom in enumerate(bead):
            matches = [v for k, v in mass_of.items() if atom in k]
            cg[s, col + i] = matches[0]
        col += np.count_nonzero(cg[s])
        cg[s] = cg[s] / np.sum(cg[s])
    assert col == molecule.n_atoms, (
        "Number of atoms in the beads mapping list does not match the "
        "number of atoms in topology.")
    if mass_weighted:
        return cg
    return cg, np.where(cg == 0, cg, 1)


def sparse_mapping(molecule_mapping, molecule_mapping_index, system=None,
                   device=None):
    """The system's sparse ``B x N`` mapping operator (the reference's
    ``utils.py:1040-1125``; the JAX package returns a ``BCOO``): a
    coalesced float32 ``torch.sparse_csr`` tensor, made once on the
    device.

    :param molecule_mapping: per molecule, an ``L x M`` numpy matrix
        (rows beads, columns that molecule's atoms).
    :param molecule_mapping_index: the output of :func:`find_molecules`.
    :param system: optional, for mass weighting: a :class:`.Simulation`
        (its masses are read back once) or an object with
        ``particles[i].mass``.
    :param device: where the operator lives: by default the simulation's
        device when ``system`` has a state, else the CUDA card (pass
        ``device="cpu"`` for the CPU).
    """
    if not isinstance(molecule_mapping[0], np.ndarray):
        raise TypeError("molecule_mapping should be list of numpy arrays")
    if len(molecule_mapping_index) != len(molecule_mapping):
        raise ValueError(
            "Length of molecule_mapping_index and molecule_mapping must "
            "match")
    state = getattr(system, "state", None)
    device = (device_for(state.masses, device, "sparse_mapping")
              if state is not None else
              resolve_device(device, "sparse_mapping"))
    n = sum(len(m) for m in molecule_mapping_index)
    b = sum(m.shape[0] for m in molecule_mapping)
    masses = None
    if state is not None:
        masses = state.masses.detach().cpu().numpy().astype(np.float64)
    elif system is not None:
        masses = np.asarray([p.mass for p in system.particles],
                            dtype=np.float64)
    rows, cols, vals = [], [], []
    bead_base = 0
    for k, (mmi, mm) in enumerate(zip(molecule_mapping_index,
                                      molecule_mapping)):
        if len(mmi) != mm.shape[1]:
            raise ValueError(
                f"Mismatch in shapes of molecule_mapping_index and "
                f"molecule_mapping at index {k}. shape {len(mmi)} is "
                f"incompatible with {mm.shape}")
        local_rows, local_cols = np.nonzero(mm > 0)
        atoms = np.asarray(mmi, dtype=np.int64)[local_cols]
        if masses is not None:
            local_vals = masses[atoms]
            # normalized per bead by its total mass
            bead_mass = np.zeros(mm.shape[0])
            np.add.at(bead_mass, local_rows, local_vals)
            assert np.all(bead_mass[np.unique(local_rows)] > 0)
            local_vals = local_vals / bead_mass[local_rows]
        else:
            local_vals = mm[local_rows, local_cols]
        rows.append(local_rows + bead_base)
        cols.append(atoms)
        vals.append(local_vals)
        bead_base += mm.shape[0]
    assert bead_base == b, "Indices failed!"
    indices = torch.as_tensor(np.stack([np.concatenate(rows),
                                        np.concatenate(cols)]))
    values = torch.as_tensor(np.concatenate(vals).astype(np.float32))
    with torch.sparse.check_sparse_tensor_invariants(), \
            warnings.catch_warnings():
        warnings.filterwarnings("ignore", "Sparse CSR tensor support")
        coo = torch.sparse_coo_tensor(indices, values, (b, n)).coalesce()
        return coo.to_sparse_csr().to(device)


def center_of_mass(positions, mapping, box_size, name="center-of-mass",
                   device=None):
    """PBC-aware mapped positions by the circular mean (the reference's
    ``utils.py:11-49``): each axis' coordinate is an angle on the box,
    its cosine and sine are mapped, and the mean angle comes back by
    ``atan2``, so a bead whose atoms straddle the boundary lands at the
    boundary.

    :param positions: ``[N, 3+]`` positions (extra columns ignored).
    :param mapping: the ``[M, N]`` operator: :func:`sparse_mapping`'s, or
        a dense tensor or array.
    :param box_size: ``[Lx, Ly, Lz]``: a tensor, or host numbers.
    :param device: where the product runs: by default the device of
        ``positions`` when it is a tensor, else of ``mapping`` when it
        is one, else the CUDA card (pass ``device="cpu"`` for the CPU).
        Inputs elsewhere are moved there.
    :return: ``[M, 3]`` mapped positions.
    """
    device = device_for(positions if torch.is_tensor(positions)
                        else mapping, device, "center_of_mass")
    if torch.is_tensor(mapping):
        mapping = mapping.to(device)
    else:
        mapping = torch.as_tensor(np.asarray(mapping, dtype=np.float32),
                                  device=device)
    if torch.is_tensor(positions):
        positions = positions.to(device)
    else:
        positions = torch.as_tensor(np.asarray(positions),
                                    dtype=mapping.dtype, device=device)
    positions = positions[:, :3]
    box_dim = torch.as_tensor(box_size, dtype=positions.dtype,
                              device=positions.device)
    theta = positions / box_dim * 2 * np.pi
    xi = torch.cos(theta).to(mapping.dtype)
    zeta = torch.sin(theta).to(mapping.dtype)
    ximean = (mapping @ xi).to(positions.dtype)
    zetamean = (mapping @ zeta).to(positions.dtype)
    thetamean = torch.atan2(zetamean, ximean)
    return thetamean / (2 * np.pi) * box_dim


def gen_mapped_exclusion_list(universe, atoms_in_molecule, beads_mappings,
                              selection="all"):
    """Bead-bead exclusion matrix from the atomic bonds, ``M A M^T``
    (the reference's ``utils.py:357-396``); numpy bool ``[B, B]``."""
    n = len(universe.select_atoms(selection))
    bonds = np.asarray(
        universe.select_atoms(selection).bonds.to_indices())
    adj = np.zeros((n, n), dtype=bool)
    adj[bonds[:, 0], bonds[:, 1]] = True
    adj[bonds[:, 1], bonds[:, 0]] = True
    mm_mol = matrix_mapping(atoms_in_molecule, beads_mappings,
                            mass_weighted=False)[1]
    n_mol = n // mm_mol.shape[1]
    mm_sys = np.kron(np.eye(n_mol, dtype=int), mm_mol).astype(bool)
    excl = mm_sys @ adj @ mm_sys.T
    np.fill_diagonal(excl, False)
    return excl


def gen_bonds_group(mapped_exclusion_list):
    """Upper-triangular bond pairs of an exclusion matrix (the
    reference's ``utils.py:399-412``)."""
    rows, cols = np.where(mapped_exclusion_list)
    keep = rows <= cols
    return np.stack([rows[keep], cols[keep]], axis=1)


def compute_ohe_bead_type_interactions(pos_btype, nlist_btype, n_btypes,
                                       device=None):
    """One-hot encoding of the unordered bead-type pair of each
    interaction (the reference's ``utils.py:52-72``).

    :param pos_btype: ``[N]`` int bead types of the centers.
    :param nlist_btype: ``[N, M]`` int bead types of the neighbors.
    :param n_btypes: number of bead types.
    :param device: for host inputs (default the CUDA card; a tensor stays
        on its device).
    :return: ``[N, M, I]`` float32, ``I = n_btypes (n_btypes + 1) / 2``.
    """
    device = device_for(pos_btype, device,
                        "compute_ohe_bead_type_interactions")
    pos_btype = torch.as_tensor(pos_btype, device=device).long()
    nlist_btype = torch.as_tensor(nlist_btype, device=device).long()
    lo = torch.minimum(pos_btype[..., None], nlist_btype)
    hi = torch.maximum(pos_btype[..., None], nlist_btype)
    idx = lo * (2 * n_btypes - lo + 1) // 2 + hi - lo
    total = n_btypes * (n_btypes - 1) // 2 + n_btypes
    return torch.eye(total, dtype=torch.float32, device=device)[idx]
