"""SimModel base (PyTorch port of the attributes of
``hoomd_tf_tpu/models/simmodel.py`` that the pair fast route reads).

The generic ``compute(nlist, positions, box)`` route with autodiff
forces, training (``compile``) and ``MolSimModel`` are still to port
(ROADMAP.md Queue 1, slices B and C).
"""

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
        self._setup_kwargs = dict(kwargs)
        self.setup(**kwargs)

    def setup(self, **kwargs):
        """Optional hook run at construction with leftover kwargs."""

    def compute(self, nlist, positions, box):
        raise NotImplementedError(
            "the generic SimModel compute route (autodiff forces over "
            "neighbor lists) is not ported yet: it arrives with slice C "
            "of the PyTorch port. Declare the model as a PairModel.")
