"""Molecules CG mapping from real files: PDB topology + DSGPM mapping
JSON -> mapping operators, CG connectivity (bonds/angles/dihedrals) and
internal-coordinate features (PyTorch port of
examples/07_cg_mapping_from_files.py, reference example 07 'Molecules CG
Mapping', which runs on a PDB + DSGPM json via MDAnalysis; here the
native readers do it with no optional dependency).

Uses the committed test fixtures: two PEG-like 12-atom chains with a
4-bead DSGPM mapping. Runs on the CUDA card unless ``--device cpu`` is
given.

Run: python examples/torch/07_cg_mapping_from_files.py [--device cpu]
"""

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import hoomd_tf_tpu_torch as htt  # noqa: E402
from hoomd_tf_tpu_torch.utils.pdb_io import PDBUniverse  # noqa: E402

FIXTURES = os.path.join(HERE, "..", "..", "tests", "fixtures")


class FirstMolecule:
    """matrix_mapping consumes an MDAnalysis-style molecule (names +
    masses); adapt one chain of the universe."""

    def __init__(self, u, n):
        self.names = list(u.atoms.names[:n])
        self.masses = list(u.atoms.masses[:n])
        self.n_atoms = n

    def __len__(self):
        return self.n_atoms


def main(device=None):
    device = device or "cuda"
    pdb = os.path.join(FIXTURES, "peg2.pdb")
    cgmap = os.path.join(FIXTURES, "peg2_cgmap.json")

    # 1. topology from the PDB (names, elements->masses, CONECT bonds)
    u = PDBUniverse(pdb)
    print(f"{len(u.atoms)} atoms, {len(u.atoms.bonds.to_indices())} bonds,"
          f" {u.n_frames} frames")

    # 2. molecules from the topology
    chain = ["C1", "C2", "O1", "C3", "C4", "O2",
             "C5", "C6", "O3", "C7", "C8", "O4"]
    mols = htt.find_molecules_from_topology(u, [chain])
    print(f"found {len(mols)} molecules of {len(mols[0])} atoms")

    # 3. mass-weighted per-molecule mapping + system sparse operator
    names = list(u.atoms.names[:12])
    beads = [names[0:3], names[3:6], names[6:9], names[9:12]]
    mol_map = htt.matrix_mapping(FirstMolecule(u, 12), beads)
    print("per-molecule mapping matrix (4 beads x 12 atoms):")
    print(np.round(mol_map, 3))
    sparse = htt.sparse_mapping([mol_map] * len(mols), mols, device=device)
    print(f"system mapping operator: {tuple(sparse.shape)}")

    # 4. CG connectivity from the DSGPM mapping file
    bonds, angles, dihedrals = htt.compute_cg_graph(DSGPM=True,
                                                    infile=cgmap)
    print(f"CG graph: {len(bonds)} bonds, {len(angles)} angles, "
          f"{len(dihedrals)} dihedrals per molecule")
    b_ids, a_ids, d_ids = htt.mol_features_multiple(
        bnd_indices=bonds, ang_indices=angles, dih_indices=dihedrals,
        molecules=len(mols), beads=len(beads))

    # 5. CG coordinates + internal-coordinate features per frame
    box = htt.box_from_lengths(u.dimensions[:3], device=device)
    M = sparse.to_dense()
    means = []
    for ts in u.trajectory:
        cg_pos = M @ torch.as_tensor(u.atoms.positions, device=M.device)
        rs = htt.mol_bond_distance(CG=True, cg_positions=cg_pos,
                                   b1=b_ids[:, 0], b2=b_ids[:, 1], box=box)
        angs = htt.mol_angle(CG=True, cg_positions=cg_pos,
                             b1=a_ids[:, 0], b2=a_ids[:, 1],
                             b3=a_ids[:, 2], box=box)
        dihs = htt.mol_dihedral(CG=True, cg_positions=cg_pos,
                                b1=d_ids[:, 0], b2=d_ids[:, 1],
                                b3=d_ids[:, 2], b4=d_ids[:, 3], box=box)
        print(f"frame: mean CG bond {float(torch.mean(rs)):.3f}  "
              f"mean angle {float(torch.mean(angs)):.3f} rad  "
              f"mean dihedral {float(torch.mean(dihs)):.3f} rad")
        assert 2.0 < float(torch.mean(rs)) < 6.0
        assert bool(torch.isfinite(dihs).all())
        means.append(float(torch.mean(rs)))
    return means


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    main(ap.parse_args().device)
