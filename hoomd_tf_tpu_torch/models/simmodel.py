"""SimModel base (PyTorch port of the parts of
``hoomd_tf_tpu/models/simmodel.py`` that the pair fast route and online
training read: the model attributes and the training surface,
``compile`` / ``loss`` / ``compute_loss``).

The generic ``compute(nlist, positions, box)`` route with autodiff
forces and ``MolSimModel`` are still to port (ROADMAP.md Queue 1,
slice C).
"""

import functools

import torch

from .module import Layer

__all__ = ["SimModel"]


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
        # the JAX SimModel's two bookkeeping variables, kept so weight
        # lists line up with a JAX model's one to one
        self.nlist_overflow = self.add_weight(
            (), trainable=False, dtype=torch.bool, name="nlist-overflow")
        self.batch_steps = self.add_weight(
            (), trainable=False, dtype=torch.int32, name="htf-batch-steps")
        self._optimizer = None
        self._loss = None
        self._setup_kwargs = dict(kwargs)
        self.setup(**kwargs)

    def setup(self, **kwargs):
        """Optional hook run at construction with leftover kwargs."""

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

    def compute(self, nlist, positions, box):
        raise NotImplementedError(
            "the generic SimModel compute route (autodiff forces over "
            "neighbor lists) is not ported yet: it arrives with slice C "
            "of the PyTorch port. Declare the model as a PairModel.")


def _make_optimizer(name, lr, params):
    params = list(params)
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr)
    cuda = bool(params) and params[0].is_cuda
    return torch.optim.Adam(params, lr=lr, capturable=cuda)
