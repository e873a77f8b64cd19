"""Utilities of the PyTorch port (``hoomd_tf_tpu/utils``): the CG mapping
stack, CG graph analysis, internal-coordinate features, the native PDB
reader, GSD trajectory I/O on the package's own native library, the
trajectory workflows and the profiling helpers."""

from .cg import (find_molecules, find_molecules_from_topology,
                 matrix_mapping, sparse_mapping, center_of_mass,
                 gen_mapped_exclusion_list, gen_bonds_group,
                 compute_ohe_bead_type_interactions)
from .graph import (compute_adj_mat, compute_cg_graph, find_cgnode_id,
                    mol_features_multiple)
from .mol_features import mol_bond_distance, mol_angle, mol_dihedral
from .trajectory import iter_from_trajectory, compute_pairwise, create_frame
from .gsd_io import GSDFile, GSDUniverse, write_gsd_frames
from .pdb_io import PDBUniverse
from .profiling import trace, time_steps, benchmark_simulation

__all__ = [
    "find_molecules", "find_molecules_from_topology", "matrix_mapping",
    "sparse_mapping", "center_of_mass", "gen_mapped_exclusion_list",
    "gen_bonds_group", "compute_ohe_bead_type_interactions",
    "compute_adj_mat", "compute_cg_graph", "find_cgnode_id",
    "mol_features_multiple", "mol_bond_distance", "mol_angle",
    "mol_dihedral", "iter_from_trajectory", "compute_pairwise",
    "create_frame", "GSDFile", "GSDUniverse", "write_gsd_frames",
    "PDBUniverse", "trace", "time_steps", "benchmark_simulation",
]
