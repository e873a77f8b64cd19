"""Built-in LJ-family pair potentials (PyTorch port of the analytic parts
of ``hoomd_tf_tpu/md/pair.py``): ``pair_energy`` and
``pair_energy_and_slope`` per lane from ``r2``, plus ``kernel_form()``,
the per-type-pair table kernel K1 evaluates (:class:`..ops.cellwise_cuda.
LJForm`). The neighbor-list force-compute form (``__call__``) comes with
the generic routes in a later slice."""

import numpy as np
import torch

from ..ops.cellwise_cuda import LJForm

__all__ = ["LennardJones", "WCA"]

_R_MIN = 2.0 ** (1 / 6)


def _param(v, like):
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def _per_pair(eps, sig, type_i, type_j, like):
    """Per-lane parameters: a ``[T, T]`` table is indexed by the lane's
    types, a scalar applies to every lane."""
    out = []
    for v in (_param(eps, like), _param(sig, like)):
        if v.ndim == 2:
            v = v[type_i.long(), type_j.long()]
        out.append(v)
    return out


class LennardJones:
    """Lennard-Jones 12-6 pair potential with a sharp cutoff.

    :param epsilon: well depth (scalar or ``[ntypes, ntypes]``).
    :param sigma: size parameter (scalar or ``[ntypes, ntypes]``).
    :param r_cut: cutoff radius.
    :param shift: shift the energy to zero at ``r_cut``.
    """

    def __init__(self, epsilon=1.0, sigma=1.0, r_cut=3.0, shift=False):
        self.epsilon = np.asarray(epsilon, dtype=np.float32)
        self.sigma = np.asarray(sigma, dtype=np.float32)
        self.r_cut = float(r_cut)
        self.shift = shift

    def _shift(self, e, s):
        sc6 = (s / self.r_cut) ** 6
        return 4.0 * e * (sc6 * sc6 - sc6)

    def pair_energy(self, r2, type_i=None, type_j=None):
        return self.pair_energy_and_slope(r2, type_i, type_j)[0]

    def pair_energy_and_slope(self, r2, type_i=None, type_j=None):
        """``(U, dU/dr2)`` per lane."""
        e, s = _per_pair(self.epsilon, self.sigma, type_i, type_j, r2)
        inv = 1.0 / r2
        sr6 = (s * s * inv) ** 3
        u = 4.0 * e * (sr6 * sr6 - sr6)
        du = -12.0 * e * (2.0 * sr6 - 1.0) * sr6 * inv
        if self.shift:
            u = u - self._shift(e, s)
        inside = r2 <= self.r_cut * self.r_cut
        zero = torch.zeros((), dtype=r2.dtype, device=r2.device)
        return torch.where(inside, u, zero), torch.where(inside, du, zero)

    def kernel_form(self):
        """The :class:`LJForm` kernel K1 evaluates for this potential."""
        e = self.epsilon.astype(np.float64)
        s = self.sigma.astype(np.float64)
        shift = -self._shift(e, s) if self.shift else 0.0
        return LJForm(e, self.sigma * self.sigma, shift,
                      self.r_cut * self.r_cut)


class WCA:
    """Weeks-Chandler-Anderson: the full LJ cut at its minimum
    ``2^(1/6) sigma`` and shifted up by ``epsilon``."""

    def __init__(self, epsilon=1.0, sigma=1.0):
        self.epsilon = np.asarray(epsilon, dtype=np.float32)
        self.sigma = np.asarray(sigma, dtype=np.float32)

    def pair_energy(self, r2, type_i=None, type_j=None):
        return self.pair_energy_and_slope(r2, type_i, type_j)[0]

    def pair_energy_and_slope(self, r2, type_i=None, type_j=None):
        eps, sig = _param(self.epsilon, r2), _param(self.sigma, r2)
        inv = 1.0 / r2
        sr6 = (sig * sig * inv) ** 3
        u = 4.0 * eps * (sr6 * sr6 - sr6) + eps
        du = -12.0 * eps * (2.0 * sr6 - 1.0) * sr6 * inv
        inside = r2 < (sig * _R_MIN) ** 2
        zero = torch.zeros((), dtype=r2.dtype, device=r2.device)
        return torch.where(inside, u, zero), torch.where(inside, du, zero)

    def kernel_form(self):
        rc = (self.sigma * np.float32(_R_MIN)) ** 2
        return LJForm(self.epsilon, self.sigma * self.sigma, self.epsilon,
                      rc, strict=True)
