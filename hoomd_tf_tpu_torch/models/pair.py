"""PairModel: the pair-potential model (PyTorch port of
``hoomd_tf_tpu/models/pair.py``).

A subclass implements ``pair_energy(r2)`` or ``pair_energy(r2, type_i,
type_j)`` returning the full pair energy per lane; the engine evaluates
it on the analytic forward-only route of the cellwise mode. On a CUDA
device that route is kernel K1, which evaluates a pair form from a table
instead of Python code. A model gets one in either of two ways:

- it declares an LJ-family potential (``md.LennardJones`` / ``md.WCA``)
  from :meth:`PairModel.pair_kernel_form`;
- it sets ``proxy_degree``: the engine then evaluates the model through
  its Chebyshev proxy (:mod:`..ops.chebyshev`), whose coefficient table
  K1 takes as its proxy form. This is also the route online training
  takes (the gradient runs in kernel K2).
"""

import torch

from .._device import resolve_device
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
    :param proxy_degree: evaluate the pair function through a
        ``proxy_degree``-term Chebyshev interpolant in ``1/r^2``
        (:mod:`..ops.chebyshev`): the model runs only at the K nodes per
        step and every lane is a Clenshaw recurrence. A typed
        ``pair_energy(r2, ti, tj)`` also needs ``proxy_types``.
    :param proxy_r_lo: inner edge (a distance) of the proxy fit range;
        below it the potential continues C^1-linearly in ``1/r^2``.
        Default ``0.25 * r_cut``.
    :param proxy_types: number of particle types of a typed proxy (one
        coefficient set per unordered type pair).
    """

    def __init__(self, nneighbor_cutoff, min_r2=1e-4, proxy_degree=None,
                 proxy_r_lo=None, proxy_types=None, **kwargs):
        self.min_r2 = float(min_r2)
        n_args = _n_tensor_args(type(self).pair_energy)
        if n_args not in (1, 3):
            raise ValueError(
                "pair_energy must take (r2) or (r2, type_i, type_j), "
                f"got {n_args} tensor arguments")
        self.pair_with_types = n_args == 3
        self.proxy_degree = int(proxy_degree) if proxy_degree else None
        self.proxy_r_lo = float(proxy_r_lo) if proxy_r_lo else None
        self.proxy_types = int(proxy_types) if proxy_types else None
        if self.proxy_degree and self.pair_with_types and \
                not self.proxy_types:
            raise ValueError(
                "a typed pair_energy(r2, ti, tj) with proxy_degree "
                "needs proxy_types=<number of particle types> (one "
                "coefficient set per unordered type pair); untyped "
                "pair_energy(r2) needs neither")
        self._proxy_parts = {}
        super().__init__(nneighbor_cutoff, **kwargs)

    def proxy_parts(self, r_cut, device=None):
        """``(fit, evaluate)`` of this model's Chebyshev proxy at
        ``r_cut``, with its constants on ``device`` (made once per
        ``(r_cut, device)``); typed models get the per-type-pair
        variant. Here and in the methods below, ``device`` defaults to
        the CUDA card; pass ``device="cpu"`` for the CPU."""
        from ..ops.chebyshev import make_pair_proxy, make_typed_pair_proxy
        device = resolve_device(device, "PairModel.proxy_parts")
        key = (float(r_cut), str(device))
        if key not in self._proxy_parts:
            r_lo = self.proxy_r_lo if self.proxy_r_lo is not None \
                else 0.25 * float(r_cut)
            r2_lo = max(r_lo * r_lo, self.min_r2)
            r2_hi = float(r_cut) ** 2
            if self.pair_with_types:
                parts = make_typed_pair_proxy(
                    self.proxy_degree, r2_lo, r2_hi, self.proxy_types,
                    dtype=self.dtype, device=device)
            else:
                parts = make_pair_proxy(self.proxy_degree, r2_lo, r2_hi,
                                        dtype=self.dtype, device=device)
            self._proxy_parts[key] = parts
        return self._proxy_parts[key]

    def proxy_coeffs(self, r_cut, device=None):
        """The proxy's coefficients ``{"c", "cd"}`` from the model's
        current weights (one ``pair_energy`` call at the nodes;
        differentiable in the weights)."""
        fit, _ = self.proxy_parts(r_cut, device)
        return fit(self.pair_energy)

    def proxy_pair_fn(self, r_cut, device=None):
        """The Chebyshev-proxy pair function at ``r_cut``
        (``r2[, ti, tj] -> (U, dU/dr2)``), fitted now."""
        device = resolve_device(device, "PairModel.proxy_pair_fn")
        _, evaluate = self.proxy_parts(r_cut, device)
        coeffs = self.proxy_coeffs(r_cut, device)
        if self.pair_with_types:
            return lambda r2, ti, tj: evaluate(coeffs, r2, ti, tj)
        return lambda r2: evaluate(coeffs, r2)

    def get_config(self):
        config = super().get_config()
        config["min_r2"] = self.min_r2
        if self.proxy_degree:
            config["proxy_degree"] = self.proxy_degree
            config["proxy_r_lo"] = self.proxy_r_lo
            if self.proxy_types:
                config["proxy_types"] = self.proxy_types
        return config

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

    def pair_kernel_form(self, r_cut=None, device=None):
        """The pair form kernel K1 evaluates for this model on CUDA.

        With ``proxy_degree`` set: the :class:`..ops.cellwise_cuda.
        ChebForm` of the proxy's current coefficients at ``r_cut`` (fitted
        without gradient, on ``device``). Otherwise what a subclass
        declares: an LJ-family potential (``md.LennardJones`` /
        ``md.WCA``) equal to its pair energy, whose ``kernel_form()`` K1
        takes, or ``None`` (the default), and the model then needs
        ``stencil='half'`` or ``'full'`` on a CUDA device."""
        if not self.proxy_degree:
            return None
        if r_cut is None:
            raise ValueError("a proxy model's kernel form needs r_cut")
        device = resolve_device(device, "PairModel.pair_kernel_form")
        _, evaluate = self.proxy_parts(r_cut, device)
        with torch.no_grad():
            return evaluate.kernel_form(self.proxy_coeffs(r_cut, device))

    def compute(self, nlist, positions, box):
        raise NotImplementedError(
            "PairModel runs on the cellwise analytic route only in this "
            "slice of the port (attach with nlist='cellwise')")
