"""hoomd_tf_tpu_torch: the PyTorch / CUDA port of ``hoomd_tf_tpu``.

The package mirrors the JAX package's module paths and public names and
imports ``torch`` and numpy only, never JAX. It carries three paths:

- the JAX package's typical use: a generic :class:`SimModel` whose
  ``compute(nlist, positions, box)`` builds an energy from
  :func:`nlist_rinv` and returns :func:`compute_nlist_forces`, attached
  with ``tfcompute(model).attach(sim, r_cut=...)`` on a packed
  ``[N, NN, 4]`` neighbor list (cell list with the selection kernel K3
  on a CUDA device, the sort method or the dense build otherwise);
- a :class:`PairModel` attached with ``nlist='cellwise'`` to a
  :class:`Simulation` running NVE, NVT, NPT, Langevin, Brownian or a
  Minimize quench, in an orthorhombic or tilted box, with the pair
  forces from the hand-written Hopper kernel K1 on a CUDA device;
- online training of a Chebyshev-proxy NN pair potential during live MD
  (``attach(train=True)``), whose gradient runs in kernel K2;
- a generic SimModel on ``nlist='cellwise'`` (the ready-made
  :class:`LJPotential`, :class:`TrainableLJ`, :class:`NeuralPairPotential`
  among them): validated lane-separable, its pair function runs in K1's
  generic form, else on the masked candidate planes; and the wide-direct
  mode ``nlist='direct'`` (:class:`NlistPlanes`, no selection);
- stateful models: the running metrics :class:`Mean` and
  :class:`MeanTensor`, the EDS bias :class:`EDSLayer` and the trainable
  :class:`WCARepulsion`, whose state a rolled-back run restores; and
  ``Simulation.run(n, log_period=k)``, which records the thermodynamic
  quantities into ``sim.log``;
- coarse-grained models: mapped neighbor lists
  (``tfcompute.enable_mapped_nlist``, CG beads beside the atoms on the
  packed routes and on ``'cellwise'``), the molecule-batched
  :class:`MolSimModel`, and the CG utilities of :mod:`.utils` (mapping
  operators, centers of mass, CG graphs and features, the PDB reader,
  trajectory iteration), GSD trajectory I/O on the package's own native
  library and the profiling helpers (``utils.trace``, ``time_steps``,
  ``benchmark_simulation``);
- double precision end to end: ``init_lattice(..., dtype=torch.float64)``
  runs the engine in float64, every kernel in its double instantiation
  on the card; and :mod:`.serialize`: models saved as ``(class, config,
  weights)`` and checkpoints that resume a run exactly;
- :mod:`.parallel`: a device mesh (``make_mesh``), ``Simulation(mesh=)``
  and :class:`~.parallel.ShardedSimulation`, which split the pair work
  into z-slabs run by K1's group launch, frame data-parallel training and
  the explicit ring-halo reference.
"""

from .ops import (box_size, wrap_vector, make_box, box_from_lengths,
                  safe_norm, nlist_rinv, masked_nlist, divide_no_nan,
                  multiply_no_nan, compute_nlist_forces,
                  compute_positions_forces, compute_nlist,
                  nlist_from_positions, CellList, cell_list_nlist,
                  NlistPlanes, direct_cell_planes, Cellwise, compute_rdf)
from .models import (Variable, Layer, Mean, MeanTensor, SimModel,
                     MolSimModel, PairModel, RBFExpansion, WCARepulsion,
                     EDSLayer, Dense, LJPotential, TrainableLJ,
                     NeuralPairPotential)
from . import ops
from . import models
from . import md
from .md.simulation import Simulation
from .driver import tfcompute
from . import parallel
from . import utils
from .utils.cg import (find_molecules, find_molecules_from_topology,
                       matrix_mapping, sparse_mapping, center_of_mass,
                       gen_mapped_exclusion_list, gen_bonds_group,
                       compute_ohe_bead_type_interactions)
from .utils.graph import (compute_adj_mat, compute_cg_graph, find_cgnode_id,
                          mol_features_multiple)
from .utils.mol_features import mol_bond_distance, mol_angle, mol_dihedral
from .utils.trajectory import iter_from_trajectory, compute_pairwise, \
    create_frame
from .utils.gsd_io import GSDFile, GSDUniverse, write_gsd_frames
from .serialize import save_model, load_model, custom_objects

# the JAX package's names
__all__ = [
    "box_size", "wrap_vector", "make_box", "box_from_lengths",
    "safe_norm", "nlist_rinv", "masked_nlist", "divide_no_nan",
    "multiply_no_nan", "compute_nlist_forces", "compute_positions_forces",
    "compute_nlist", "nlist_from_positions", "CellList", "cell_list_nlist",
    "NlistPlanes", "direct_cell_planes", "Cellwise", "compute_rdf",
    "Variable", "Layer", "Mean", "MeanTensor", "SimModel", "MolSimModel",
    "PairModel",
    "RBFExpansion", "WCARepulsion", "EDSLayer", "Dense",
    "LJPotential", "TrainableLJ", "NeuralPairPotential",
    "Simulation", "tfcompute",
    "find_molecules", "find_molecules_from_topology", "matrix_mapping",
    "sparse_mapping", "center_of_mass", "gen_mapped_exclusion_list",
    "gen_bonds_group", "compute_ohe_bead_type_interactions",
    "compute_adj_mat", "compute_cg_graph", "find_cgnode_id",
    "mol_features_multiple", "mol_bond_distance", "mol_angle", "mol_dihedral",
    "iter_from_trajectory", "compute_pairwise", "create_frame",
    "GSDFile", "GSDUniverse", "write_gsd_frames",
    "save_model", "load_model", "custom_objects",
    "md", "ops", "models", "utils", "parallel",
]
