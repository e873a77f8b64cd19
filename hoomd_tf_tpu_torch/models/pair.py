"""PairModel: the pair-potential model (PyTorch port of
``hoomd_tf_tpu/models/pair.py``, without the Chebyshev proxy).

A subclass implements ``pair_energy(r2)`` or ``pair_energy(r2, type_i,
type_j)`` returning the full pair energy per lane; the engine evaluates
it on the analytic forward-only route of the cellwise mode. On a CUDA
device that route is kernel K1, which evaluates an LJ-family form
instead of Python code: a model opts in by returning that form from
:meth:`PairModel.pair_kernel_form` (an ``md.LennardJones`` or ``md.WCA``).
"""

import torch

from .simmodel import SimModel

__all__ = ["PairModel"]


def _n_tensor_args(fn):
    code = fn.__code__
    return code.co_argcount - 1  # drop self


class PairModel(SimModel):
    """A :class:`.SimModel` defined by a per-pair energy.

    :param nneighbor_cutoff: max neighbors NN (as in SimModel).
    :param min_r2: squared-distance clamp applied before the pair
        function (overlap guard).
    :param proxy_degree: the Chebyshev proxy of the JAX package; not
        ported yet (raises).
    """

    def __init__(self, nneighbor_cutoff, min_r2=1e-4, proxy_degree=None,
                 **kwargs):
        if proxy_degree:
            raise NotImplementedError(
                "PairModel(proxy_degree=...) (the Chebyshev proxy) arrives "
                "with slice B of the PyTorch port (online training)")
        self.min_r2 = float(min_r2)
        n_args = _n_tensor_args(type(self).pair_energy)
        if n_args not in (1, 3):
            raise ValueError(
                "pair_energy must take (r2) or (r2, type_i, type_j), "
                f"got {n_args} tensor arguments")
        self.pair_with_types = n_args == 3
        super().__init__(nneighbor_cutoff, **kwargs)

    def pair_energy(self, r2, type_i=None, type_j=None):
        raise NotImplementedError(
            "PairModel subclasses implement pair_energy")

    def pair_energy_and_slope(self, r2, type_i=None, type_j=None):
        """``(U, dU/dr2)`` per lane. The default differentiates
        :meth:`pair_energy` with one forward-mode product; override to
        share subexpressions."""
        if self.pair_with_types:
            fn = lambda x: self.pair_energy(x, type_i, type_j)
        else:
            fn = self.pair_energy
        return torch.func.jvp(fn, (r2,), (torch.ones_like(r2),))

    def pair_kernel_form(self):
        """The LJ-family potential (``md.LennardJones`` / ``md.WCA``) this
        model's pair energy equals, for kernel K1 on CUDA; ``None`` (the
        default) declares none, and the model then needs
        ``stencil='half'`` or ``'full'`` on a CUDA device."""
        return None

    def compute(self, nlist, positions, box):
        raise NotImplementedError(
            "PairModel runs on the cellwise analytic route only in this "
            "slice of the port (attach with nlist='cellwise')")
