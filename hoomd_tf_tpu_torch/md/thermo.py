"""Thermodynamic observables (PyTorch port of
``hoomd_tf_tpu/md/thermo.py``). Each returns a 0-dim device tensor."""

import torch

from .._device import to_device
from ..ops.box import box_size

__all__ = ["kinetic_energy", "temperature", "potential_energy", "pressure",
           "thermo"]

#: the quantities ``Simulation.run(log_period=)`` records, in the order of
#: :func:`log_row`
LOG_KEYS = ("kinetic_energy", "potential_energy", "temperature", "pressure")


def kinetic_energy(state):
    return 0.5 * torch.sum(state.masses[:, None] * state.velocities ** 2)


def temperature(state):
    """Instantaneous kinetic temperature with ``dof = 3N - 3``, or the real
    degrees of freedom a slot layout records in ``thermostat['dof']``
    (ghost rows have zero velocity)."""
    dof = (state.thermostat or {}).get("dof")
    if dof is None:
        dof = 3 * state.n_particles - 3
    return 2.0 * kinetic_energy(state) / dof


def potential_energy(state):
    """Sum of the per-particle energies in forces column 4."""
    return torch.sum(state.forces[:, 3])


def pressure(state):
    """``P = (2 KE + W) / (3 V)`` with ``W = sum_i tr(virial_i)``."""
    vol = torch.prod(box_size(state.box))
    w = torch.sum(torch.diagonal(state.virial, dim1=-2, dim2=-1))
    return (2.0 * kinetic_energy(state) + w) / (3.0 * vol)


def thermo(state):
    """Dict of the standard log quantities."""
    return {
        "kinetic_energy": kinetic_energy(state),
        "potential_energy": potential_energy(state),
        "temperature": temperature(state),
        "pressure": pressure(state),
    }


def _sums(state, valid):
    """``[3]``: the kinetic energy, the potential energy and the virial's
    trace of ``state``'s rows (``valid`` > 0 only, when given)."""
    v, f, w = state.velocities, state.forces, state.virial
    if valid is not None:
        v, f = v * valid[:, None], f * valid[:, None]
        w = w * valid[:, None, None]
    return torch.stack([0.5 * torch.sum(state.masses[:, None] * v ** 2),
                        torch.sum(f[:, 3]),
                        torch.sum(torch.diagonal(w, dim1=-2, dim2=-1))])


def log_row(state, valid=None):
    """The :data:`LOG_KEYS` quantities of ``state`` as one ``[4]`` device
    tensor of the state's dtype (nothing is read back); ``valid``
    (``[n_slots]``, slot order) leaves the ghost rows out of every sum.
    Of a :class:`.state.SlabState` (``valid`` its shards') or a
    :class:`.state.RowState` each shard's partial sums, added on the first
    shard's device."""
    shards = getattr(state, "shards", None)
    if shards is None:
        ke, pe, w = _sums(state, valid)
    else:
        valid = [None] * len(shards) if valid is None else valid
        parts = [_sums(p, v) for p, v in zip(shards, valid)]
        dev = parts[0].device
        ke, pe, w = torch.stack([to_device(t, dev) for t in parts]).sum(0)
    dof = (state.thermostat or {}).get("dof")
    if dof is None:
        dof = 3 * state.n_particles - 3
    vol = torch.prod(box_size(state.box))
    return torch.stack([ke, pe, 2.0 * ke / dof,
                        (2.0 * ke + w) / (3.0 * vol)]).to(ke.dtype)
