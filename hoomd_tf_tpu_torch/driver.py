"""tfcompute: the attach-style driver (PyTorch port of the
``nlist='cellwise'`` part of ``hoomd_tf_tpu/driver.py``)."""

import numpy as np

from .models.pair import PairModel
from .ops.cellwise import Cellwise

__all__ = ["tfcompute"]


class tfcompute:
    """Applies a :class:`.models.pair.PairModel` to a :class:`.Simulation`.

    :param model: the model.
    """

    def __init__(self, model):
        self.model = model
        self.sim = None

    def attach(self, sim, nlist=None, r_cut=0, period=1, batch_size=None,
               train=False, save_output_period=None):
        """Attach the model to a simulation.

        :param nlist: ``'cellwise'`` or a :class:`.ops.cellwise.Cellwise`
            config; the other neighbor modes are still to port.
        :param r_cut: cutoff radius, or an ``[ntypes, ntypes]`` matrix
            (negative = never neighbors).
        """
        if sim is None or sim.state is None:
            raise RuntimeError("Must initialize the simulation first")
        if not (nlist == "cellwise" or isinstance(nlist, Cellwise)):
            raise NotImplementedError(
                f"nlist={nlist!r}: only the cellwise mode is ported so far "
                "(the packed and dense neighbor lists arrive with slice C)")
        if train:
            raise NotImplementedError(
                "train=True (online training) arrives with slice B")
        if batch_size or period != 1 or save_output_period:
            raise NotImplementedError(
                "batch_size, period and save_output_period are not ported")
        if not isinstance(self.model, PairModel):
            raise NotImplementedError(
                "only PairModel runs on the port so far (the generic "
                "SimModel route arrives with slice C)")
        if getattr(self.model, "_map_nlist", False):
            raise NotImplementedError("mapped neighbor lists are not ported")
        r_arr = np.asarray(r_cut, dtype=np.float64)
        if r_arr.ndim == 0:
            self.r_cut = float(r_arr)
            self.r_cut_matrix = None
        elif r_arr.ndim == 2 and r_arr.shape[0] == r_arr.shape[1]:
            self.r_cut_matrix = r_arr.astype(np.float32)
            pos = r_arr[r_arr > 0]
            self.r_cut = float(pos.max()) if pos.size else 0.0
        else:
            raise ValueError(
                f"r_cut must be a scalar or square [ntypes, ntypes] "
                f"matrix, got shape {r_arr.shape}")
        if self.r_cut <= 0:
            raise ValueError("Must provide a positive r_cut")
        self.nlist_method = nlist
        self.sim = sim
        sim.tfc = self
        sim.replan()
        return self

    def get_positions_array(self):
        return self.sim.state.positions4.detach().cpu().numpy()

    def get_forces_array(self):
        """The net forces ``[N, 4]`` (energy in column 4)."""
        return self.sim.state.forces.detach().cpu().numpy()
