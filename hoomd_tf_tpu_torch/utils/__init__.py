"""Utilities of the PyTorch port (``hoomd_tf_tpu/utils``): the CG mapping
stack, CG graph analysis, internal-coordinate features, the native PDB
reader and the trajectory workflows. The GSD I/O and the profiling
helpers are still to come (ROADMAP.md Queue 1 item 6)."""

from .cg import (find_molecules, find_molecules_from_topology,
                 matrix_mapping, sparse_mapping, center_of_mass,
                 gen_mapped_exclusion_list, gen_bonds_group,
                 compute_ohe_bead_type_interactions)
from .graph import (compute_adj_mat, compute_cg_graph, find_cgnode_id,
                    mol_features_multiple)
from .mol_features import mol_bond_distance, mol_angle, mol_dihedral
from .trajectory import iter_from_trajectory, compute_pairwise, create_frame
from .pdb_io import PDBUniverse

__all__ = [
    "find_molecules", "find_molecules_from_topology", "matrix_mapping",
    "sparse_mapping", "center_of_mass", "gen_mapped_exclusion_list",
    "gen_bonds_group", "compute_ohe_bead_type_interactions",
    "compute_adj_mat", "compute_cg_graph", "find_cgnode_id",
    "mol_features_multiple", "mol_bond_distance", "mol_angle",
    "mol_dihedral", "iter_from_trajectory", "compute_pairwise",
    "create_frame", "PDBUniverse",
]
