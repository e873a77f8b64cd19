"""SimModel: the user-facing model API (PyTorch port of
``hoomd_tf_tpu/models/simmodel.py``).

A subclass implements ``compute(nlist, positions, box, training)``,
taking 1-3 of the tensor arguments and optionally a trailing
``training`` flag, and returns one or more outputs: the first is the
forces when ``output_forces``, the second the virial when
``virial=True``. Tensor conventions are the reference's:

- ``nlist``: ``[N, NN, 4]``, the minimum-image displacement to each
  neighbor and the neighbor's type; all-zero rows pad short lists (or,
  in the ``'direct'`` mode and the cellwise planes route,
  :class:`..ops.direct.NlistPlanes`);
- ``positions``: ``[N, 4]``, xyz and type;
- ``box``: ``[3, 3]``, rows low, high and tilt.

:meth:`SimModel.__call__` runs ``compute`` under grad mode on a detached
nlist and positions that require grad, so
:func:`..ops.forces.compute_nlist_forces` differentiates the energy with
``torch.autograd`` (the JAX package's capture-and-replay has no
counterpart here), so a row slice of the nlist (the all-atom part of a
mapped list, :meth:`SimModel.mapped_nlist`) differentiates as any other
tensor derived from it.

:class:`MolSimModel` batches the rows by molecule: its ``mol_compute``
also gets ``mol_positions [M, MN, 4]`` and ``mol_nlist [M, MN, NN, 4]``,
gathered through a dummy row 0 that absorbs the padding.
"""

import functools

import torch

from .module import Layer
from ..ops.forces import model_call

__all__ = ["SimModel", "MolSimModel"]


def _sniff_compute(fn, max_args, name):
    """How many of the positional tensor arguments does ``compute`` take,
    and does it end with a ``training`` flag? (the reference's arity
    sniffing, ``simmodel.py:51-68``)"""
    try:
        code = fn.__code__
    except AttributeError:
        raise AttributeError(
            f"{name} child class must implement {fn} method")
    arg_count = code.co_argcount - 1  # drop self
    pass_training = (arg_count >= 1 and
                     code.co_varnames[arg_count] == "training")
    if pass_training:
        arg_count -= 1
    if arg_count > max_args:
        raise ValueError(
            f"compute takes at most {max_args} tensor arguments, got "
            f"{arg_count}")
    return arg_count, pass_training


class SimModel(Layer):
    """Base model for per-particle computation inside the MD step.

    :param nneighbor_cutoff: max number of neighbors NN (can be 0).
    :param output_forces: the model computes forces for the simulation.
    :param virial: the model also outputs the virial.
    :param check_nlist: raise if the neighbor list overflows.
    :param dtype: floating point dtype of the model.

    Extra ``kwargs`` go to :meth:`setup`.
    """

    def __init__(self, nneighbor_cutoff, output_forces=True, virial=False,
                 check_nlist=False, dtype=torch.float32, name="htf-model",
                 **kwargs):
        super().__init__(name=name, dtype=dtype)
        self.nneighbor_cutoff = int(nneighbor_cutoff)
        self.output_forces = output_forces
        self.virial = virial
        self.check_nlist = check_nlist
        # the mapped split (tfcompute.enable_mapped_nlist sets them): the
        # all-atom rows are the first _map_i
        self._map_nlist = False
        self._map_fxn = None
        self._map_i = None
        if SimModel.compute is type(self).compute:
            raise AttributeError(
                "You must implement compute method in subclass")
        self._arg_count, self._pass_training = _sniff_compute(
            self.compute, 3, "SimModel")
        # the JAX SimModel's two bookkeeping variables, kept so weight
        # lists line up with a JAX model's one to one; the first is the
        # device flag _check_nlist ORs into (a buffer: read it through
        # the nlist_overflow property, which follows .to(device))
        self.add_weight((), trainable=False, dtype=torch.bool,
                        name="nlist-overflow")
        self._overflow_attr = self._weight_names[-1]
        self.add_weight((), trainable=False, dtype=torch.int32,
                        name="htf-batch-steps")
        self._optimizer = None
        self._loss = None
        # bumped by retrace_compute: the engine's cached verdicts about
        # compute (the lane-separability probe) are keyed on it
        self._trace_version = 0
        self._setup_kwargs = dict(kwargs)
        self.setup(**kwargs)

    def setup(self, **kwargs):
        """Optional hook run at construction with leftover kwargs."""

    @property
    def nlist_overflow(self):
        """Device bool flag: some call saw a full neighbor list (set by
        ``check_nlist``; tfcompute raises on it after the run)."""
        return getattr(self, self._overflow_attr)

    # ------------------------------------------------------------------
    # the generic route
    # ------------------------------------------------------------------
    def compute(self, nlist, positions, box, training=True):
        """The model's computation; implemented by the subclass. It may
        take fewer arguments (``(nlist, positions)``, say) and a trailing
        ``training`` flag. Derive forces from an energy with
        :func:`..ops.forces.compute_nlist_forces` or
        :func:`..ops.forces.compute_positions_forces`."""
        raise AttributeError("You must implement compute in your subclass")

    def retrace_compute(self):
        """Invalidate what the engine derived from ``compute`` (the
        lane-separability probe's verdict); call after mutating plain
        Python state that ``compute`` reads (the JAX package's
        ``retrace_compute``)."""
        self._trace_version += 1

    def _check_nlist(self, nlist):
        """The reference's overflow check (``simmodel.py:216-224``), in
        the JAX package's traced form: ORs a device flag and never reads
        it back (tfcompute raises after the run's one readback)."""
        from ..ops.direct import NlistPlanes
        x = nlist.dx if isinstance(nlist, NlistPlanes) else nlist[:, :, 0]
        count = torch.amax(torch.sum((x > 0).to(torch.int32), dim=1))
        with torch.no_grad():
            self.nlist_overflow.logical_or_(count >= self.nneighbor_cutoff)

    def _prepare_args(self, inputs, training):
        from ..ops.direct import NlistPlanes
        inputs = list(inputs)
        args = [a.map(lambda c: c.to(self.dtype))
                if isinstance(a, NlistPlanes) else
                torch.as_tensor(a).to(self.dtype)
                for a in inputs[: self._arg_count]]
        planes = self._arg_count >= 1 and isinstance(args[0], NlistPlanes)
        if self._arg_count >= 1 and not planes and args[0].ndim == 2:
            # flat [N*NN, 4] nlist -> [N, NN, 4]
            args[0] = args[0].reshape(-1, max(1, self.nneighbor_cutoff), 4)
        # the tensors compute differentiates against: detached leaves
        # that require grad (the tape then ends at them); of planes, the
        # three displacement components
        for i in range(min(2, self._arg_count)):
            if i == 0 and planes:
                p = args[0]
                args[0] = NlistPlanes(*(c.detach().requires_grad_()
                                        for c in p[:3]), p.type.detach())
            else:
                args[i] = args[i].detach().requires_grad_()
        if self._arg_count >= 3 and not args[2].is_cuda and \
                not self.__dict__.get("_in_engine", False):
            # the reference's box-skew guard (simmodel.py:195), on eager
            # calls only, as the JAX package's (its engine's calls are
            # traced; the port's engine marks its own, and a card's box
            # would wait on the device)
            if float(torch.sum(torch.abs(args[2][2]))) >= 1e-4:
                raise ValueError("box is skewed")
        if self.check_nlist and self._arg_count >= 1:
            self._check_nlist(args[0])
        if self._pass_training:
            args.append(training)
        return args

    def __call__(self, inputs, training=False, keep_graph=None):
        """Run the model on ``inputs = [nlist, positions, box, ...]``;
        returns a tuple of its outputs. ``compute`` runs under grad mode
        whatever the caller's mode; the force gradients keep their graph
        only when ``keep_graph``, by default ``training`` (the lane-fast
        training route keeps it with ``training=False``, as the JAX
        package calls the model there)."""
        from ..ops.direct import NlistPlanes
        if torch.is_tensor(inputs) or isinstance(inputs, NlistPlanes):
            inputs = [inputs]
        args = self._prepare_args(inputs, training)
        with torch.enable_grad(), model_call(training, keep_graph):
            out = self.compute(*args)
        if not isinstance(out, (tuple, list)):
            out = (out,)
        return tuple(out)

    def get_config(self):
        config = {
            "nneighbor_cutoff": self.nneighbor_cutoff,
            "output_forces": self.output_forces,
            "virial": self.virial,
            "check_nlist": self.check_nlist,
            "name": self.name,
            "dtype": str(self.dtype).replace("torch.", ""),
        }
        config.update(self._setup_kwargs)
        return config

    @classmethod
    def from_config(cls, config):
        config = dict(config)
        if "dtype" in config:
            config["dtype"] = getattr(torch, config["dtype"])
        return cls(**config)

    # ------------------------------------------------------------------
    # the mapped split (the reference's simmodel.py:257-287)
    # ------------------------------------------------------------------
    def mapped_nlist(self, nlist):
        """Split ``nlist`` into its all-atom and mapped (CG bead) rows
        after ``tfcompute.enable_mapped_nlist``: a packed ``[N, NN, 4]``
        list or :class:`..ops.direct.NlistPlanes` (each component sliced
        by rows). Forces derived from either part differentiate through
        the slice."""
        from ..ops.direct import NlistPlanes
        self._check_mapped()
        k = self._map_i
        if isinstance(nlist, NlistPlanes):
            return nlist.map(lambda c: c[:k]), nlist.map(lambda c: c[k:])
        return nlist[:k], nlist[k:]

    def mapped_positions(self, positions):
        """Split ``positions`` into its all-atom and mapped rows after
        ``tfcompute.enable_mapped_nlist``."""
        self._check_mapped()
        return positions[:self._map_i], positions[self._map_i:]

    def _check_mapped(self):
        if not self._map_nlist:
            raise ValueError(
                "You must call tfcompute.enable_mapped_nlist before using "
                "mapped_nlist")

    # ------------------------------------------------------------------
    # Training surface
    # ------------------------------------------------------------------
    def compile(self, optimizer="adam", loss="mse", learning_rate=1e-3):
        """Configure for training.

        :param optimizer: ``'adam'`` or ``'sgd'``, or a callable
            ``params -> torch.optim.Optimizer``. The optimizer is made
            when training starts (``tfcompute.ensure_opt_state``), once
            the lazy layers have built on the simulation's device.
        :param loss: a callable ``f(y_true, y_pred)``, ``'mse'`` /
            ``'mae'``, or a list aligned with the model outputs where
            ``None`` marks outputs not compared to labels.
        """
        if isinstance(optimizer, str):
            # optax.adam and torch.optim.Adam take the same step,
            # lr * m_hat / (sqrt(v_hat) + eps), with eps = 1e-8 and
            # betas (0.9, 0.999) in both; on a CUDA device the bias
            # corrections stay on the device (capturable), so a step
            # never waits on the host
            name = optimizer.lower()
            if name not in ("adam", "sgd"):
                raise ValueError(f"unknown optimizer {optimizer!r}")
            optimizer = functools.partial(_make_optimizer, name,
                                          float(learning_rate))
        self._optimizer = optimizer
        self._loss = loss

    @property
    def loss(self):
        if getattr(self, "_loss", None) is None:
            raise AttributeError("SimModel has not been compiled")
        return self._loss if isinstance(self._loss, (list, tuple)) \
            else [self._loss]

    def _loss_fns(self):
        def resolve(spec):
            if spec is None:
                return None
            if callable(spec):
                return spec
            return {
                "mse": lambda yt, yp: torch.mean((yt - yp) ** 2),
                "mae": lambda yt, yp: torch.mean(torch.abs(yt - yp)),
            }[spec.lower()]
        spec = self._loss
        if isinstance(spec, (list, tuple)):
            return [resolve(s) for s in spec]
        return [resolve(spec)]

    def compute_loss(self, outputs, y):
        """Total training loss: per-output losses plus the layers'
        regularization losses."""
        fns = self._loss_fns()
        ys = y if isinstance(y, (list, tuple)) else [y]
        total = torch.zeros((), dtype=self.dtype, device=ys[0].device)
        yi = 0
        for i, fn in enumerate(fns):
            if fn is None or i >= len(outputs):
                continue
            yt = ys[yi].to(self.dtype)
            yp = outputs[i]
            # labels may be [N, 4] net forces with the energy column
            # while the model emits [N, 3]: compare the common columns
            if yt.ndim == 2 and yp.ndim == 2 and \
                    yt.shape[1] != yp.shape[1]:
                m = min(yt.shape[1], yp.shape[1])
                yt, yp = yt[:, :m], yp[:, :m]
            total = total + fn(yt, yp)
            yi = min(yi + 1, len(ys) - 1)
        for reg in self.losses:
            total = total + reg
        return total

    def trainable_weights(self):
        """The weights an optimizer steps: the ``nn.Parameter`` s of
        :attr:`variables` that require grad, in that order."""
        return [v for v in self.variables
                if isinstance(v, torch.nn.Parameter) and v.requires_grad]

    def train_on_batch(self, x, y, reset_metrics=False):
        """One optimizer step on one batch (Keras' ``train_on_batch``, the
        JAX package's ``simmodel.py:340-390``): the model on ``x`` with
        ``training=True``, :meth:`compute_loss` against ``y``, one step of
        the compiled optimizer (made at the first call, once the lazy
        layers have built), then the weights' constraints.

        :param x: model inputs ``[nlist, positions, box, ...]``.
        :param y: labels (typically reference forces ``[N, 3 or 4]``).
        :returns: the loss, a 0-d tensor (detached).
        """
        if self._optimizer is None:
            raise ValueError("SimModel has not been compiled")
        out = self(x, training=True)
        loss = self.compute_loss(out, torch.as_tensor(y))
        params = self.trainable_weights()
        opt = getattr(self, "_batch_opt", None)
        if opt is None or [id(p) for g in opt.param_groups
                           for p in g["params"]] != [id(p) for p in params]:
            opt = self._batch_opt = self._optimizer(params)
        opt.zero_grad()
        loss.backward()
        opt.step()
        self.apply_constraints(params)
        return loss.detach()


def _make_optimizer(name, lr, params):
    params = list(params)
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr)
    cuda = bool(params) and params[0].is_cuda
    return torch.optim.Adam(params, lr=lr, capturable=cuda)


def _make_reverse_indices(mol_indices):
    """Atom index -> ``[molecule, position]`` (the reference's
    ``simmodel.py:714-733``), from 1-indexed, zero-padded
    ``mol_indices``; an atom in no molecule gets ``[-1, -1]`` (with one
    printed warning)."""
    num_atoms = 0
    for m in mol_indices:
        num_atoms = max(num_atoms, max(m))
    rmi = [[] for _ in range(num_atoms)]
    for i in range(len(mol_indices)):
        for j in range(len(mol_indices[i])):
            index = mol_indices[i][j]
            if index > 0:
                rmi[index - 1] = [i, j]
    warned = False
    for r in rmi:
        if len(r) != 2 and not warned:
            warned = True
            print("Not all of your atoms are in a molecule\n")
            r.extend([-1, -1])
    return rmi


class MolSimModel(SimModel):
    """A :class:`SimModel` batched by molecule (the reference's
    ``simmodel.py:342-489``).

    A subclass implements ``mol_compute(nlist, positions, mol_nlist,
    mol_positions, box, training)``, taking at least the first three
    tensor arguments. The per-particle rows are gathered into
    ``mol_positions [M, MN, 4]`` and ``mol_nlist [M, MN, NN, 4]`` through
    ``mol_indices`` made 1-indexed and zero-padded to ``MN``, with a
    dummy zero row 0 that the padding reads. Forces still come from
    ``nlist`` (the gradient flows back through the gather).

    :param MN: the most atoms of a molecule.
    :param mol_indices: per molecule, its atoms' (0-based) indices.
    """

    def __init__(self, MN, mol_indices, nneighbor_cutoff, output_forces=True,
                 virial=False, check_nlist=False, dtype=torch.float32,
                 name="htf-mol-model", **kwargs):
        if MolSimModel.mol_compute is type(self).mol_compute:
            raise AttributeError(
                "You must implement mol_compute method in subclass of "
                "MolSimModel")
        self.MN = int(MN)
        # 1-indexed and zero-padded (the reference's simmodel.py:386-397)
        raw = [list(m) for m in mol_indices]
        for mi in raw:
            for i in range(len(mi)):
                mi[i] += 1
            if len(mi) > MN:
                raise ValueError("One of your molecule indices"
                                 " has more than MN indices."
                                 "Increase MN in your graph.")
            while len(mi) < MN:
                mi.append(0)
        self.mol_indices = raw
        self.rev_mol_indices = _make_reverse_indices(raw)
        self._mol_arg_count, self._mol_pass_training = _sniff_compute(
            self.mol_compute, 5, "MolSimModel")
        if self._mol_arg_count < 3:
            raise AttributeError(
                "You are creating a molecular batched model, but are only "
                "using per atom nlist/positions. Either use only SimModel or "
                "increase your argument count to mol_compute")
        super().__init__(nneighbor_cutoff, output_forces=output_forces,
                         virial=virial, check_nlist=check_nlist, dtype=dtype,
                         name=name, **kwargs)
        # the gather index, made once; a buffer, so it follows the model
        # to the simulation's device (no variable: no weight of the JAX
        # model's)
        self.register_buffer(
            "_mol_flat_idx",
            torch.as_tensor(raw, dtype=torch.long).reshape(-1),
            persistent=False)

    def get_config(self):
        config = super().get_config()
        config.update({"MN": self.MN, "mol_indices": self.mol_indices})
        return config

    def mol_compute(self, nlist, positions, mol_nlist, mol_positions, box,
                    training=True):
        """The molecule-batched computation; implemented by the subclass
        (tensor conventions of :meth:`SimModel.compute`, plus
        ``mol_nlist [M, MN, NN, 4]`` and ``mol_positions [M, MN, 4]``).
        Derive forces from ``nlist``."""
        raise AttributeError("You must implement mol_compute method")

    def compute(self, nlist, positions, box, training=True):
        idx = self._mol_flat_idx
        if idx.device != positions.device:
            idx = idx.to(positions.device)
        nn = max(1, self.nneighbor_cutoff)
        # dummy row 0 absorbs the padded (zero) indices
        ap = torch.cat([positions.new_zeros((1, 4)), positions])
        an = torch.cat([nlist.new_zeros((1, nn, 4)), nlist])
        mol_positions = ap[idx].reshape(-1, self.MN, 4)
        mol_nlist = an[idx].reshape(-1, self.MN, nn, 4)
        args = [nlist, positions, mol_nlist, mol_positions,
                box][:self._mol_arg_count]
        if self._mol_pass_training:
            args.append(training)
        return self.mol_compute(*args)
