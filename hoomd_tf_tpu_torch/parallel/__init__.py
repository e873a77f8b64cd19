"""Multi-device execution (PyTorch port of ``hoomd_tf_tpu/parallel``):
the :class:`.mesh.Mesh` of ``make_mesh``, the sharded engine's front end
:class:`ShardedSimulation` (``Simulation(mesh=)``: kernel K1's z-slab
mode with the halo written out), frame data-parallel training
(:func:`sharded_train_step`) and the explicit ring-halo reference
(:func:`halo_force_fn`). One process drives every shard, as one JAX
program does."""

from .mesh import make_mesh
from .shard import data_parallel_grads, sharded_train_step
from .domain import domain_decompose, halo_force_fn
from .sharded_simulation import ShardedSimulation

__all__ = ["make_mesh", "data_parallel_grads", "sharded_train_step",
           "domain_decompose", "halo_force_fn", "ShardedSimulation"]
