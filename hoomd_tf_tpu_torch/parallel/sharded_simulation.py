"""ShardedSimulation: the multi-device Simulation front end (PyTorch
port of ``hoomd_tf_tpu/parallel/sharded_simulation.py``).

A thin subclass of :class:`..md.simulation.Simulation`: passing a
``mesh`` to Simulation decomposes the cellwise mode's slot state into
z-slabs, one per shard, each resident on its shard's device during a run
(``md/slots.py::SlabSlots``, the analog of the JAX package's row-sharded
slot arrays): kernel K1's group launch runs on each device's shards'
rows in place with the halo exchange between devices written out (``ops/cellwise.py::
resident_pair_forces``), the integrators, built-in forces, ``period``
gating and logging run per shard with the thermostat's, barostat's and
log's sums added on the first device (the analog of the reference's MPI
path), and particles migrate between neighbouring shards at each repack.
Online training (``attach(..., train=True)``) keeps the state so too on
its proxy, pair and lane branches: the labels, the model's forward and
its backward (kernels K2 or ``generic_reduce_bwd``) run on each device's
shards' buffers (``ops/pair_train.py::resident_train_forces``), the loss,
the optimizer and the weights on the first device. Every ``'cellwise'``
route is resident so: the planes route (a SimModel the lane-separability
probe rejects, training's planes branch, a mapped model) builds each
shard's planes on its device and runs the model once on every row
joined on the first device. The packed routes (``'n2'``, ``'cell'``,
``'pallas'``, ``'direct'``) keep the particle-order state by contiguous
particle rows per shard, and so does every route between runs
(``md/state.py::RowState``): reading ``state`` joins the rows on the first
device.

The class only adds convenience, as in the JAX package: a default mesh
over the visible cards, the ``kT``/``tau`` shorthand for NVT, and an
``attach`` that falls back to the dense build when the box is too small
for a z-decomposed cell grid.
"""

import numpy as np
import torch

from ..md import integrators as _integrators
from ..md.state import RowState
from ..md.simulation import Simulation
from .mesh import make_mesh

__all__ = ["ShardedSimulation"]


class ShardedSimulation(Simulation):
    """Multi-device MD over a 1-D mesh.

    :param dt: timestep.
    :param kT: if given (and no ``integrator``), Nose-Hoover NVT at this
        temperature; else NVE.
    :param tau: thermostat coupling time.
    :param mesh: device mesh (default: :func:`.mesh.make_mesh` over the
        visible cards).
    :param integrator: explicit integrator (overrides ``kT``/``tau``).
    """

    def __init__(self, dt=0.005, kT=None, tau=0.5, mesh=None, seed=0,
                 axis="d", integrator=None):
        if integrator is None:
            integrator = (_integrators.NVT(kT=kT, tau=tau)
                          if kT is not None else _integrators.NVE())
        super().__init__(dt=dt, integrator=integrator, seed=seed,
                         mesh=mesh or make_mesh(axis=axis), shard_axis=axis)

    @property
    def n_devices(self):
        return self.mesh.shape[self.shard_axis]

    def _shard_state(self):
        """Check where the state lies: a state just set on the mesh's
        first device, or, once a run has started, each shard's particle
        rows on its own device (:class:`..md.state.RowState`, the JAX
        package's row-sharded placement, kept between runs)."""
        st = self._state
        if st is None:
            return
        if isinstance(st, RowState):
            for s, p in enumerate(st.shards):
                want = torch.empty(0, device=self.mesh.devices[s]).device
                if p.positions.device != want:
                    raise ValueError(
                        f"shard {s}'s rows are on {p.positions.device}, "
                        f"its mesh device is {want}")
            return
        if st.positions.device != self.mesh.devices[0]:
            raise ValueError(
                f"the state is on {st.positions.device}, the mesh's "
                f"first device is {self.mesh.devices[0]}")

    def cellwise_feasible(self, r_cut):
        """Can the box hold a cellwise grid with ``nz`` divisible by the
        mesh?"""
        from ..ops.cellwise import plan_cellwise
        lengths = np.asarray(self._lengths, dtype=np.float64)
        return plan_cellwise(self._state.n_particles, lengths, r_cut,
                             z_divisor=self.n_devices) is not None

    def attach(self, model, r_cut, nlist=None, **kwargs):
        """Attach a :class:`..models.simmodel.SimModel` through a
        :class:`..driver.tfcompute` (returned; also kept on ``self.tfc``).

        :param nlist: neighbor strategy; default the sharded cellwise
            mode when the box is large enough for the mesh's z
            decomposition, else the dense build (row-sharded; only small
            systems land there).
        :param kwargs: forwarded to :meth:`..driver.tfcompute.attach`
            (``period``, ``save_output_period``, ...).
        """
        from ..driver import tfcompute
        if self._state is None:
            raise RuntimeError("Initialize the simulation state first")
        if nlist is None:
            nlist = "cellwise" if self.cellwise_feasible(r_cut) else "n2"
        tfc = tfcompute(model)
        tfc.attach(self, r_cut=r_cut, nlist=nlist, **kwargs)
        return tfc
