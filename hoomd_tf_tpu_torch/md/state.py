"""Simulation state (PyTorch port of ``hoomd_tf_tpu/md/state.py``).

One dataclass of device tensors. Unlike the JAX package, whose pure
functions return replaced copies, the port's integrators and slot layout
update a ``SimState`` object by rebinding its fields; callers that need
the old state (``Simulation.run``'s rollback) keep their own reference
to the tensors, which are never written in place.
"""

import dataclasses

import numpy as np
import torch

from .._device import resolve_device
from ..ops.box import box_from_lengths, host_tilt

__all__ = ["SimState", "lattice_positions", "init_state"]


@dataclasses.dataclass
class SimState:
    """All mutable simulation state.

    :param positions: ``[N, 3]`` particle positions.
    :param velocities: ``[N, 3]`` velocities.
    :param types: ``[N]`` int32 particle types.
    :param masses: ``[N]`` masses.
    :param box: ``[3, 3]`` box (rows: low, high, tilt).
    :param forces: ``[N, 4]`` net forces, per-particle energy in column 4.
    :param virial: ``[N, 3, 3]`` per-particle virial.
    :param step: the timestep (a host int: the host always knows it, so
        reading it never waits for the device).
    :param thermostat: integrator auxiliary state (dict of tensors or
        host numbers).
    :param tilted: whether the box has a nonzero tilt row (a host bool:
        the integrators' wrap takes the triclinic form then; a barostat
        keeps the tilt row, so it never changes during a run).
    :param rng: the ``torch.Generator`` (on the state's device) stochastic
        integrators draw their noise from: the ``Simulation``'s own. The
        JAX package carries a PRNG key here.
    :param noise_rows: in slot order, ``(rows, n)``: the particle index of
        each row (``n`` on a ghost row) and the number of particles. The
        noise is drawn per particle and gathered into the rows, so a
        particle's noise does not depend on the cell layout, its capacity
        or the repack schedule (``None`` in particle order).
    """
    positions: torch.Tensor
    velocities: torch.Tensor
    types: torch.Tensor
    masses: torch.Tensor
    box: torch.Tensor
    forces: torch.Tensor
    virial: torch.Tensor
    step: int = 0
    thermostat: dict = dataclasses.field(default_factory=dict)
    tilted: bool = False
    rng: object = None
    noise_rows: object = None

    @property
    def n_particles(self):
        return self.positions.shape[0]

    @property
    def positions4(self):
        """``[N, 4]`` positions with the type in the last column."""
        return torch.cat([self.positions,
                          self.types.to(self.positions.dtype)[:, None]],
                         dim=-1)


def lattice_positions(n, density=None, a=None, kind="sc"):
    """Positions for ``n`` particles on a simple-cubic or fcc lattice in a
    centered cubic box; returns numpy ``(positions [n, 3], lengths [3])``
    (identical to the JAX package's)."""
    if kind == "sc":
        basis = np.zeros((1, 3))
    elif kind == "fcc":
        basis = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5],
                          [0, 0.5, 0.5]])
    else:
        raise ValueError(f"unknown lattice kind {kind!r}")
    per_cell = len(basis)
    cells = int(np.ceil((n / per_cell) ** (1 / 3)))
    if density is not None:
        if a is not None:
            raise ValueError("give density or a, not both")
        a = (per_cell / density) ** (1 / 3)
    elif a is None:
        a = 1.0
    grid = np.stack(np.meshgrid(*([np.arange(cells)] * 3),
                                indexing="ij"), axis=-1).reshape(-1, 3)
    pos = (grid[:, None, :] + basis[None, :, :]).reshape(-1, 3) * a
    pos = pos[:n]
    L = cells * a
    pos = pos - L / 2 + a / 2
    return pos.astype(np.float32), np.array([L, L, L], dtype=np.float32)


def init_state(positions, box, types=None, velocities=None, masses=None,
               kT_init=None, generator=None, dtype=torch.float32,
               device=None):
    """Build a :class:`SimState` on ``device`` (default: the CUDA card;
    pass ``device="cpu"`` for the CPU).

    :param positions: ``[N, 3]`` or ``[N, 4]`` (type in column 4).
    :param box: ``[3, 3]`` box (rows low, high, tilt) or ``[Lx, Ly,
        Lz]`` lengths (centered).
    :param kT_init: if given (and no velocities), draw Maxwell-Boltzmann
        velocities at this temperature with zero net momentum, from
        ``generator`` (a ``torch.Generator`` on ``device``), which also
        becomes the state's ``rng``.
    """
    device = resolve_device(device, "init_state")
    kw = dict(dtype=dtype, device=device)
    positions = torch.as_tensor(np.asarray(positions), **kw)
    if positions.shape[-1] == 4:
        if types is None:
            types = positions[:, 3].to(torch.int32)
        positions = positions[:, :3].contiguous()
    n = positions.shape[0]
    if types is None:
        types = torch.zeros(n, dtype=torch.int32, device=device)
    else:
        types = torch.as_tensor(np.asarray(types), dtype=torch.int32,
                                device=device)
    masses = (torch.ones(n, **kw) if masses is None
              else torch.as_tensor(np.asarray(masses), **kw))
    box = torch.as_tensor(np.asarray(box), **kw)
    if box.ndim == 1:
        box = box_from_lengths(box, dtype=dtype, device=device)
    tilted = any(host_tilt(box[2]))
    if velocities is not None:
        velocities = torch.as_tensor(np.asarray(velocities), **kw)
    elif kT_init is not None:
        velocities = (torch.randn((n, 3), generator=generator, **kw) *
                      torch.sqrt(kT_init / masses)[:, None])
        velocities = velocities - velocities.mean(dim=0)
    else:
        velocities = torch.zeros((n, 3), **kw)
    return SimState(positions=positions, velocities=velocities,
                    types=types, masses=masses, box=box,
                    forces=torch.zeros((n, 4), **kw),
                    virial=torch.zeros((n, 3, 3), **kw), tilted=tilted,
                    rng=generator)
