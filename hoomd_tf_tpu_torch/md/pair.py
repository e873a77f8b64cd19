"""Built-in LJ-family pair potentials (PyTorch port of
``hoomd_tf_tpu/md/pair.py``).

Each is a force compute on a packed neighbor list, ``force(state,
nlist) -> (forces [N, 4], virial [N, 3, 3])`` with the per-particle
energy in column 4 (the particle-order route), and gives the cellwise
route ``pair_energy`` / ``pair_energy_and_slope`` per lane from ``r2``
plus ``kernel_form()``, the per-type-pair table kernel K1 evaluates
(:class:`..ops.cellwise_cuda.LJForm`)."""

import numpy as np
import torch

from ..ops.cellwise_cuda import LJForm
from ..ops.direct import NlistPlanes
from ..ops.forces import compute_nlist_forces
from ..ops.numerics import nlist_rinv

__all__ = ["LennardJones", "WCA", "pair_force_from_energy_fn"]

_R_MIN = 2.0 ** (1 / 6)


def _param(v, like):
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def _cached(obj, like):
    """``(epsilon, sigma)`` of ``obj`` as tensors on ``like``'s device and
    type (``like`` a tensor or planes), copied once (a host-to-device copy
    in the step loop would be a host sync)."""
    if isinstance(like, NlistPlanes):
        like = like.dx
    key = (str(like.device), like.dtype)
    cache = obj.__dict__.setdefault("_on", {})
    if key not in cache:
        cache[key] = (_param(obj.epsilon, like), _param(obj.sigma, like))
    return cache[key]


def pair_force_from_energy_fn(pair_energy_fn):
    """Lift a per-pair energy ``u(1/r, type_i, type_j)`` (already
    half-counted) into a force compute over a packed neighbor list or
    planes,
    through the callable form of :func:`..ops.forces.
    compute_nlist_forces`. Padded slots (``r == 0``) must give exactly
    zero energy and slope: use :func:`..ops.numerics.nlist_rinv`-style
    guards inside."""

    def force(state, nlist):
        types_i = state.types

        def total_energy(nl):
            rinv = nlist_rinv(nl)
            tj = (nl.type if isinstance(nl, NlistPlanes)
                  else nl[:, :, 3]).to(torch.int32)
            return torch.sum(pair_energy_fn(rinv, types_i[:, None], tj),
                             dim=1)

        return compute_nlist_forces(nlist, total_energy, virial=True)

    return force


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

    def prepare(self, like):
        """Copy the parameters to ``like``'s device before a step loop
        (the loop then makes no host-to-device copy)."""
        _cached(self, like)

    def __call__(self, state, nlist):
        eps, sig = _cached(self, nlist)

        def energy(rinv, ti, tj):
            if eps.ndim == 2:
                e, s = eps[ti.long(), tj.long()], sig[ti.long(), tj.long()]
            else:
                e, s = eps, sig
            sr6 = (s * rinv) ** 6
            u = 4.0 * e * (sr6 * sr6 - sr6)
            if self.shift:
                u = u - self._shift(e, s) * (rinv > 0)
            inside = rinv > (1.0 / self.r_cut)
            return torch.where(inside, u, torch.zeros_like(u)) / 2.0

        return pair_force_from_energy_fn(energy)(state, nlist)

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

    prepare = LennardJones.prepare

    def __call__(self, state, nlist):
        eps, sig = _cached(self, nlist)

        def energy(rinv, ti, tj):
            sr6 = (sig * rinv) ** 6
            u = 4.0 * eps * (sr6 * sr6 - sr6) + eps * (rinv > 0)
            inside = (sig * rinv) > (1.0 / _R_MIN)
            return torch.where(inside, u, torch.zeros_like(u)) / 2.0

        return pair_force_from_energy_fn(energy)(state, nlist)

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
