"""tfcompute, which attaches a model to a simulation (PyTorch port of
the JAX package's ``tfcompute``): any SimModel on a packed neighbor list
(``nlist=None``/``'auto'``, ``'n2'``, ``'cell'``, ``'pallas'`` or a
``CellList``), on the wide-direct planes (``'direct'``) or on the
slot-resident cellwise mode (``'cellwise'``), and online training of a
Chebyshev-proxy PairModel on ``'cellwise'``."""

import numpy as np
import torch

from .models.pair import PairModel
from .ops.cell_list import CellList
from .ops.cellwise import Cellwise
from .ops.direct import NlistPlanes

# what each refusal names: the part of the port that brings it
_LATER = "a later slice of the PyTorch port (ROADMAP.md Queue 1)"
_TRAINING = ("the rest of online training, a later slice of the PyTorch "
             "port (ROADMAP.md Queue 1 item 4)")

__all__ = ["tfcompute"]


class tfcompute:
    """Applies a :class:`.models.simmodel.SimModel` to a
    :class:`.Simulation`.

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
        #: the lane-separability probe's verdict on a generic SimModel on
        #: 'cellwise' (set by the first run(); False for a PairModel)
        self._lane_fast_ok = False
        #: why: the validation's per-column errors and limits, or the
        #: model's exception
        self._lane_fast_report = {}

    def attach(self, sim, nlist=None, r_cut=0, period=1, batch_size=None,
               train=False, save_output_period=None):
        """Attach the model to a simulation.

        :param nlist: the neighbor mode: ``None`` / ``'auto'`` (the cell
            list for 512 particles or more in a box of 3 cells per axis,
            selecting with kernel K3 on a CUDA device; the dense build
            otherwise), ``'n2'`` (dense O(N^2)), ``'cell'`` or a
            :class:`.ops.cell_list.CellList` (the sort method),
            ``'pallas'`` (kernel K3; its plain version on the CPU),
            ``'direct'`` (the model takes the masked 27-cell candidate
            planes, :class:`.ops.direct.NlistPlanes`, with no
            selection), or ``'cellwise'`` / a
            :class:`.ops.cellwise.Cellwise` (slot-resident: a PairModel,
            or a generic SimModel the lane-separability probe validates,
            on kernel K1; any other SimModel on the planes route).
        :param r_cut: cutoff radius, or an ``[ntypes, ntypes]`` matrix
            (negative = never neighbors).
        :param train: train the model online each step against the
            simulation's built-in forces as labels (the reference's
            hoomd2tf mode; cellwise proxy PairModels only); needs
            ``model.compile`` first.

        The probe's verdict on a generic SimModel is ``_lane_fast_ok``
        after the first ``run()``.
        """
        if sim is None or sim.state is None:
            raise RuntimeError("Must initialize the simulation first")
        cellwise = nlist == "cellwise" or isinstance(nlist, Cellwise)
        packed = nlist in (None, "auto", "n2", "cell", "pallas",
                           "direct") or \
            (isinstance(nlist, CellList) and not cellwise)
        if not (cellwise or packed):
            raise NotImplementedError(
                f"nlist={nlist!r} is not ported; it arrives with {_LATER}")
        if batch_size or period != 1 or save_output_period:
            raise NotImplementedError(
                "batch_size, period and save_output_period are not ported; "
                f"they arrive with {_LATER}")
        if getattr(self.model, "_map_nlist", False):
            raise NotImplementedError(
                f"mapped neighbor lists arrive with {_LATER}")
        if train and not cellwise:
            raise NotImplementedError(
                "online training on a packed neighbor list arrives with "
                f"{_TRAINING}; train a proxy PairModel on nlist='cellwise'")
        if train and not isinstance(self.model, PairModel):
            raise NotImplementedError(
                "online training of a generic SimModel (the lane-fast and "
                f"planes training routes) arrives with {_TRAINING}")
        if train and not self.model.proxy_degree:
            raise NotImplementedError(
                "online training of a PairModel without proxy_degree (the "
                f"non-proxy NN row) arrives with {_TRAINING}")
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
        if self.r_cut <= 0 and (cellwise or
                                self.model.nneighbor_cutoff > 0):
            raise ValueError("Must provide an r_cut if you have "
                             "nneighbor_cutoff > 0")
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

    def config_key(self):
        """What the lane-separability probe's cached verdict depends on
        besides the plan and the model's trace version."""
        rcm = (None if self.r_cut_matrix is None else
               self.r_cut_matrix.tobytes())
        return (id(self.model), self.r_cut, rcm, self.train)

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

    def check_overflow(self, full=None):
        """Raise (and clear the flag) when the model's ``check_nlist``
        saw a full neighbor list; ``full`` is the flag as the run's
        readback gave it (read from the device when ``None``)."""
        if not self.model.check_nlist:
            return
        flag = self.model.nlist_overflow
        if full is None:
            full = bool(flag)
        if full:
            flag.zero_()
            raise ValueError("Neighbor list is full!")

    def get_positions_array(self):
        return self.sim.state.positions4.detach().cpu().numpy()

    def get_nlist_array(self):
        """The packed ``[N, NN, 4]`` neighbor list of the current state
        (``'direct'``: the planes, stacked ``[N, 27 cap, 4]``)."""
        nlist = self.sim._build_nlist(self.sim.state)
        if isinstance(nlist, NlistPlanes):
            nlist = nlist.stack()  # 'direct': the planes as [N, C, 4]
        return nlist.detach().cpu().numpy()

    def get_forces_array(self):
        """The net forces ``[N, 4]`` (energy in column 4)."""
        return self.sim.state.forces.detach().cpu().numpy()
