"""tfcompute: the attach-style driver (PyTorch port of the
``nlist='cellwise'`` part of ``hoomd_tf_tpu/driver.py``, online training
included)."""

import numpy as np
import torch

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
        self.train = False
        self.reference_forces = []
        #: per-step training losses of the committed runs (host floats)
        self.loss_history = []
        #: the torch optimizer, made by :meth:`ensure_opt_state`
        self.opt_state = None
        self.trainable_idx = None
        self._train_energy = None

    def attach(self, sim, nlist=None, r_cut=0, period=1, batch_size=None,
               train=False, save_output_period=None):
        """Attach the model to a simulation.

        :param nlist: ``'cellwise'`` or a :class:`.ops.cellwise.Cellwise`
            config; the other neighbor modes are still to port.
        :param r_cut: cutoff radius, or an ``[ntypes, ntypes]`` matrix
            (negative = never neighbors).
        :param train: train the model online each step against the
            simulation's built-in forces as labels (the reference's
            hoomd2tf mode); needs ``model.compile`` first.
        """
        if sim is None or sim.state is None:
            raise RuntimeError("Must initialize the simulation first")
        if not (nlist == "cellwise" or isinstance(nlist, Cellwise)):
            raise NotImplementedError(
                f"nlist={nlist!r}: only the cellwise mode is ported so far "
                "(the packed and dense neighbor lists arrive with slice C)")
        if batch_size or period != 1 or save_output_period:
            raise NotImplementedError(
                "batch_size, period and save_output_period are not ported")
        if not isinstance(self.model, PairModel):
            raise NotImplementedError(
                "only PairModel runs on the port so far (the generic "
                "SimModel route arrives with slice C)")
        if getattr(self.model, "_map_nlist", False):
            raise NotImplementedError("mapped neighbor lists are not ported")
        if train and not self.model.proxy_degree:
            raise NotImplementedError(
                "online training of a PairModel without proxy_degree (the "
                "non-proxy NN row) arrives with slice C of the port")
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
        # output offset bookkeeping (reference tensorflowcompute.py:81-96)
        self.output_offset = 0
        if self.model.output_forces:
            self.output_offset = 1
        if self.model.virial:
            self.output_offset = 2
        if train:
            i = 0
            for i, loss in enumerate(self.model.loss):  # raises if not
                if loss is None:                          # compiled
                    break
            self.output_offset = i
        self.train = bool(train)
        self.nlist_method = nlist
        self.sim = sim
        self.model.to(sim.device)
        self.opt_state = None
        self._train_energy = None
        sim.tfc = self
        sim.replan()
        return self

    @property
    def optimizer(self):
        """The optimizer factory ``compile`` configured."""
        opt = getattr(self.model, "_optimizer", None)
        if opt is None:
            raise ValueError("SimModel has not been compiled")
        return opt

    def set_reference_forces(self, *forces):
        """Choose which built-in forces are the training labels (default:
        all of them, the analog of HOOMD's net force)."""
        if not self.train and self.model.output_forces:
            raise ValueError("Only valid to set reference forces if mode "
                             "is hoomd2tf")
        for f in forces:
            if self.sim is not None and \
                    not any(f is g for g in self.sim.forces):
                raise ValueError("given force does not seem like a "
                                 "simulation force (add it with "
                                 "sim.add_force first)")
        self.reference_forces = list(forces)

    def ensure_opt_state(self):
        """The torch optimizer over the model's trainable weights, made
        once (after one call at the proxy's nodes builds the lazy layers
        on the simulation's device)."""
        if self.opt_state is None:
            model = self.model
            if model.proxy_degree:
                with torch.no_grad():
                    model.proxy_coeffs(self.r_cut, self.sim.device)
            variables = model.variables
            self.trainable_idx = [i for i, v in enumerate(variables)
                                  if isinstance(v, torch.nn.Parameter) and
                                  v.requires_grad]
            self.opt_state = self.optimizer(
                [variables[i] for i in self.trainable_idx])
        return self.opt_state

    def train_energy(self):
        """Does training need the energy column (does the loss read it)?
        Probed once per attach."""
        if self._train_energy is None:
            from .md.simulation import _loss_consumes_energy
            self._train_energy = _loss_consumes_energy(self.model)
        return self._train_energy

    def get_positions_array(self):
        return self.sim.state.positions4.detach().cpu().numpy()

    def get_forces_array(self):
        """The net forces ``[N, 4]`` (energy in column 4)."""
        return self.sim.state.forces.detach().cpu().numpy()
