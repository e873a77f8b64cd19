"""Computing coarse-grained properties: mapping operators, PBC centers of
mass, CG bond/angle features (PyTorch port of examples/09_cg_properties.py,
reference examples 02/07/09). Runs on the CUDA card unless
``--device cpu`` is given.

Run: python examples/torch/09_cg_properties.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import hoomd_tf_tpu_torch as htt  # noqa: E402


class Mol:
    """Minimal MDAnalysis-like atom selection for matrix_mapping."""

    def __init__(self, names, masses):
        self.names = names
        self.masses = masses
        self.n_atoms = len(names)

    def __len__(self):
        return self.n_atoms


def main(device=None):
    # three-bead molecules: (O,H,H)(C,C)
    mol = Mol(["O", "H1", "H2", "C1", "C2"],
              [16.0, 1.0, 1.0, 12.0, 12.0])
    mol_map = htt.matrix_mapping(mol, [["O", "H1", "H2"], ["C1", "C2"]])
    print("molecule mapping (mass weighted):")
    print(np.round(mol_map, 3))

    # 8 molecules on a simulation; system-level sparse operator
    n_mol = 8
    sim = htt.Simulation(seed=0, device=device)
    sim.init_lattice(n_mol * 5, a=2.0)
    sim.bonds = [[5 * i + a, 5 * i + b] for i in range(n_mol)
                 for a, b in [(0, 1), (0, 2), (0, 3), (3, 4)]]
    mol_indices = htt.find_molecules(sim)
    assert len(mol_indices) == n_mol
    mapping = htt.sparse_mapping([mol_map] * n_mol, mol_indices, system=sim)
    print("system mapping:", tuple(mapping.shape))

    # PBC-aware centers of mass of the beads
    box_l = htt.box_size(sim.state.box)
    cg_pos = htt.center_of_mass(sim.state.positions, mapping, box_l)
    print("CG positions:", tuple(cg_pos.shape))

    # CG connectivity from an adjacency matrix (DSGPM-style)
    adj = np.zeros((2, 2))
    adj[0, 1] = adj[1, 0] = 1
    bonds, angles, dihedrals = htt.compute_cg_graph(
        DSGPM=False, adj_mat=adj, cg_beads=2)
    b, a, d = htt.mol_features_multiple(
        bnd_indices=bonds, molecules=n_mol, beads=2)
    print("CG bond index pairs (first 4):", b[:4].tolist())

    # bond lengths of the CG beads
    r = htt.mol_bond_distance(CG=True, cg_positions=cg_pos,
                              b1=b[:, 0], b2=b[:, 1],
                              box=sim.state.box)
    print("CG bond lengths:", np.round(r.detach().cpu().numpy(), 3))
    assert bool(torch.isfinite(r).all())
    assert bool((r > 0).all())
    return r


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    main(ap.parse_args().device)
