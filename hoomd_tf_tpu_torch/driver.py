"""tfcompute, which attaches a model to a simulation (PyTorch port of
the JAX package's ``tfcompute``): any SimModel on a packed neighbor list
(``nlist=None``/``'auto'``, ``'n2'``, ``'cell'``, ``'pallas'`` or a
``CellList``), on the wide-direct planes (``'direct'``) or on the
slot-resident cellwise mode (``'cellwise'``), evaluated or trained online
(``train=True``), with the ``period``, ``batch_size`` and
``save_output_period`` knobs and the ``outputs`` capture of the
reference; and the mapped coarse-grained neighbor lists of
:meth:`tfcompute.enable_mapped_nlist`."""

import dataclasses

import numpy as np
import torch

from .md.state import first_rows
from .models.simmodel import MolSimModel
from .ops.box import box_size, check_tilt
from .ops.cell_list import CellList
from .ops.cellwise import Cellwise
from .ops.direct import NlistPlanes

# what a refusal names: the part of the port that brings it
_LATER = "a later slice of the PyTorch port (ROADMAP.md Queue 1)"

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
        #: the captured outputs (``save_output_period``): one numpy array
        #: per model output past ``output_offset``, captures stacked on
        #: axis 0
        self.outputs = None
        self.period = 1
        self.batch_size = 0
        self.save_output_period = None
        self._calls = 0
        # captures of the run in flight and its call count (a model call
        # outside a run, a test's say, is counted nowhere)
        self._pending = ([], 0)
        self._model_forces = None

    @property
    def map_enabled(self):
        """CG beads follow the atoms: the model's mapping
        (``_map_nlist``, set by :meth:`enable_mapped_nlist`) is on."""
        return bool(getattr(self.model, "_map_nlist", False))

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
        :param period: run (or train) the model every ``period`` MD
            steps; between, its last forces and virial stand (on
            ``'cellwise'`` they follow their particles through each
            repack), also across ``run()`` calls.
        :param batch_size: run (and train) the model on particle chunks
            of this size, one optimizer step each (not with ``'direct'``
            or ``'cellwise'``, whose planes are the model's rows).
        :param train: train the model online against the simulation's
            built-in forces as labels (the reference's hoomd2tf mode);
            needs ``model.compile`` first.
        :param save_output_period: capture the model's outputs past its
            forces (or the trained prediction) every this many model
            calls into :attr:`outputs`.

        The probe's verdict on a generic SimModel is ``_lane_fast_ok``
        after the first ``run()``.
        """
        if sim is None or sim.state is None:
            raise RuntimeError("Must initialize the simulation first")
        # the reference rejects any skew (simmodel.py:195 'box is
        # skewed'); tilted boxes run up to HOOMD's |tilt| <= 0.5, where
        # the sequential minimum image is exact
        check_tilt(sim.state.box[2])
        cellwise = nlist == "cellwise" or isinstance(nlist, Cellwise)
        packed = nlist in (None, "auto", "n2", "cell", "pallas",
                           "direct") or \
            (isinstance(nlist, CellList) and not cellwise)
        if not (cellwise or packed):
            raise NotImplementedError(
                f"nlist={nlist!r} is not ported; it arrives with {_LATER}")
        molsim = isinstance(self.model, MolSimModel)
        if molsim and batch_size:
            raise ValueError("Cannot batch by molecule and by batch_number")
        if (batch_size or molsim) and (cellwise or nlist == "direct"):
            raise ValueError(
                f"nlist={nlist!r} is incompatible with particle batching "
                "and molecule batching (it changes the nlist form the "
                "model sees). Mapped neighbor lists ARE supported: the "
                "model receives particle-order NlistPlanes")
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
        if self.map_enabled and self.r_cut_matrix is None and \
                self.model.nneighbor_cutoff > 0:
            # mapped: atoms and CG beads never neighbor each other -- the
            # reference's rcut() matrix (tensorflowcompute.py:284-305),
            # negative across the two groups, which every build applies
            types = sim.state.types
            ntypes = int(types.max()) + 1
            # the beads' types start past the atoms'
            k = int(types[:self.model._map_i].max()) + 1
            m = np.full((ntypes, ntypes), self.r_cut, dtype=np.float32)
            m[:k, k:] = -1.0
            m[k:, :k] = -1.0
            self.r_cut_matrix = m
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
        self.period = int(period)
        if self.period < 1:
            raise ValueError(f"period must be >= 1, got {period}")
        self.batch_size = 0 if batch_size is None else int(batch_size)
        self.save_output_period = save_output_period
        self.outputs = None
        self._calls = 0
        self._pending = ([], 0)
        self._model_forces = None
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
        return (id(self.model), self.r_cut, rcm, self.train,
                self.map_enabled)

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

    def enable_mapped_nlist(self, sim, mapping_fxn):
        """Append CG beads to the simulation, so the engine builds the
        bead-bead neighbor lists too (the reference's
        ``tensorflowcompute.py:198-263``); call before :meth:`attach`.

        :param mapping_fxn: ``f(positions4, box_lengths) -> [M, 4]``, the
            bead positions and bead types of the ``[N, 4]`` atom rows. It
            gets a list of three host floats here and the ``[3]`` box
            lengths tensor in :meth:`apply_mapping`, as in the JAX
            package. The beads' types are offset by ``max(type) + 1``;
            they start at rest with unit masses.
        :returns: ``(aa_group, map_group)``, numpy row indices of the
            atoms and of the beads.
        """
        state = sim.state
        if state is None:
            raise RuntimeError("Must initialize the simulation first")
        bs = box_size(state.box).detach().cpu().numpy()
        cg = torch.as_tensor(mapping_fxn(
            state.positions4, [float(bs[0]), float(bs[1]), float(bs[2])]))
        cg = cg.to(device=state.positions.device)
        m = cg.shape[0]
        aan = state.n_particles
        start = int(state.types.max()) + 1
        dtype = state.positions.dtype
        kw = dict(dtype=dtype, device=state.positions.device)
        n = aan + m
        sim.set_state(dataclasses.replace(
            state,
            positions=torch.cat([state.positions, cg[:, :3].to(dtype)]),
            types=torch.cat([state.types,
                             cg[:, 3].to(torch.int32) + start]),
            velocities=torch.cat([state.velocities,
                                  torch.zeros((m, 3), **kw)]),
            masses=torch.cat([state.masses, torch.ones(m, **kw)]),
            forces=torch.zeros((n, 4), **kw),
            virial=torch.zeros((n, 3, 3), **kw)))
        self.model._map_nlist = True
        self.model._map_fxn = mapping_fxn
        self.model._map_i = aan
        return np.arange(aan), np.arange(aan, n)

    def apply_mapping(self, state):
        """The per-step write-back of the bead positions from the current
        atom positions (the reference's precompute, ``simmodel.py:
        289-339``), in particle order; the types stay."""
        aan = self.model._map_i
        cg3 = self.bead_positions(state.positions4[:aan], state.box)
        return dataclasses.replace(
            state, positions=torch.cat([state.positions[:aan], cg3]))

    def bead_positions(self, atoms4, box):
        """``[M, 3]``: the mapping of the ``[N, 4]`` atom rows ``atoms4``
        in the ``[3, 3]`` ``box`` (its lengths go to the mapping as a
        device tensor), in the positions' dtype."""
        cg = self.model._map_fxn(atoms4, box_size(box))
        return torch.as_tensor(cg)[:, :3].to(atoms4.dtype)

    def ensure_opt_state(self):
        """The torch optimizer over the model's trainable weights, made
        once, after the lazy layers are built on the simulation's device
        (:func:`..interop.build_model`: one call at a proxy's nodes or on
        a zero neighbor list of the simulation's rows, beads included)."""
        if self.opt_state is None:
            from .interop import build_model
            from .models.layers import Dense
            model = self.model
            if getattr(model, "proxy_degree", None) or any(
                    isinstance(m, Dense) and m.kernel is None
                    for m in model.modules()):
                build_model(model, self.r_cut, self.sim.device,
                            rows=self.sim.state.n_particles)
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

    # ------------------------------------------------------------------
    # hooks of Simulation.run
    # ------------------------------------------------------------------
    def begin_outputs(self):
        """Start an attempt at a run: captures and the model-call count
        stay pending until :meth:`commit_outputs` (a rolled-back attempt
        commits none)."""
        self._pending = ([], self._calls)

    def capture(self, *chunks):
        """One model call: count it, and at every ``save_output_period``-th
        call keep its outputs past ``output_offset`` (one tuple per
        particle chunk; each chunk a capture of its own, as the reference
        appends per batch). Device tensors are kept (detached) until the
        run's end: no host sync."""
        kept, calls = self._pending
        calls += 1
        self._pending = (kept, calls)
        sop = self.save_output_period
        if sop and calls % sop == 0:
            for extras in chunks:
                if extras:
                    kept.append([torch.as_tensor(e).detach().clone()
                                 for e in extras])

    def commit_outputs(self):
        """The attempt's run committed: its captures join :attr:`outputs`
        (one readback, after the step loop)."""
        kept, calls = self._pending
        self._calls = calls
        self._pending = ([], calls)
        if not kept:
            return
        captured = [np.stack([c[j].cpu().numpy() for c in kept])
                    for j in range(len(kept[0]))]
        if self.outputs is None:
            self.outputs = captured
        else:
            self.outputs = [np.concatenate([o, c], axis=0)
                            for o, c in zip(self.outputs, captured)]

    def model_forces(self, state):
        """The model's forces and virial carried over from the last run
        (zeros at first): with ``period`` > 1 they stand until the model
        runs again, as the reference's force buffer does."""
        n = state.n_particles
        like = first_rows(state)
        kw = dict(dtype=like.dtype, device=like.device)
        mf = self._model_forces
        if mf is not None and mf[0].shape[0] == n:
            return mf
        return torch.zeros((n, 4), **kw), torch.zeros((n, 3, 3), **kw)

    def keep_model_forces(self, forces4, virial):
        self._model_forces = (forces4, virial)

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
        """The net forces ``[N, 4]`` (energy in column 4); in training
        mode with reference forces selected, the staged label forces of
        those built-ins at the current state, as the reference's forces
        buffer holds (``TensorflowCompute.cc:177-187``)."""
        if self.train and self.reference_forces:
            f = self.sim._label_forces(self.reference_forces)
            return f.detach().cpu().numpy()
        return self.sim.state.forces.detach().cpu().numpy()

    def get_virial_array(self):
        """The per-particle virial as ``[N, 9]``."""
        return self.sim.state.virial.detach().cpu().numpy().reshape(-1, 9)
