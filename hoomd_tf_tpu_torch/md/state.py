"""Simulation state (PyTorch port of ``hoomd_tf_tpu/md/state.py``).

One dataclass of device tensors (and, under a mesh, :class:`SlabState`,
one per z-slab shard of the slot state, or :class:`RowState`, one per
shard of the particle rows). Unlike the JAX package, whose pure
functions return replaced copies, the port's integrators and slot layout
update a ``SimState`` object by rebinding its fields; callers that need
the old state (``Simulation.run``'s rollback) keep their own reference
to the tensors, which are never written in place.
"""

import dataclasses

import numpy as np
import torch

from .._device import resolve_device, to_device
from ..ops.box import box_from_lengths, host_tilt

__all__ = ["SimState", "SlabState", "RowState", "Shards",
           "lattice_positions", "init_state"]


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


class Shards(tuple):
    """One tensor per mesh shard of a :class:`SlabState`, in shard order,
    each on its shard's device; ``+`` adds shard by shard."""

    def __add__(self, other):
        return Shards(a + b for a, b in zip(self, other))


def zeros_like(t):
    """``torch.zeros_like`` of a tensor or of each tensor of a
    :class:`Shards`."""
    if isinstance(t, Shards):
        return Shards(torch.zeros_like(x) for x in t)
    return torch.zeros_like(t)


def _rows(name):
    def get(self):
        return Shards(getattr(p, name) for p in self.shards)

    def put(self, values):
        for p, v in zip(self.shards, values):
            setattr(p, name, v)
    return property(get, put)


class _Sharded:
    """What :class:`SlabState` and :class:`RowState` share: ``shards[s]``,
    a :class:`SimState` on ``mesh.devices[s]``, and the run-wide values --
    the box, the step, the thermostat, ``tilted``, the generator and the
    number of particles -- on the first shard's device; setting ``box``
    copies it to every shard. The row fields (``positions``,
    ``velocities``, ``types``, ``masses``, ``forces``, ``virial``) read
    and write :class:`Shards`."""

    positions = _rows("positions")
    velocities = _rows("velocities")
    types = _rows("types")
    masses = _rows("masses")
    forces = _rows("forces")
    virial = _rows("virial")

    def __init__(self, shards, box, n, step=0, thermostat=None,
                 tilted=False, rng=None):
        self.shards = list(shards)
        self.n = int(n)
        self.step = step
        self.thermostat = dict(thermostat or {})
        self.tilted = tilted
        self.rng = rng
        self.box = box

    @property
    def box(self):
        return self._box

    @box.setter
    def box(self, box):
        self._box = box
        for p in self.shards:
            p.box = to_device(box, p.positions.device)

    @property
    def n_particles(self):
        return self.n

    @property
    def dtype(self):
        return self.shards[0].positions.dtype

    @property
    def device(self):
        """The first shard's device, where the run-wide values live."""
        return self.shards[0].positions.device


class SlabState(_Sharded):
    """A slot state resident per z-slab shard of a mesh.

    ``shards[s]`` is a :class:`SimState` on ``mesh.devices[s]`` over the
    rows of shard ``s``'s buffer (:class:`.slots.SlabSlots`): its home
    layers, then one forward halo layer, which holds the next shard's
    first home layer (positions, types) for the pair kernel and is
    otherwise inert (zero velocity, force and virial, unit mass, no
    noise). The run-wide values are :class:`_Sharded`'s.
    """

    def copy(self):
        """A shallow copy whose shards are shallow copies too: fields are
        rebound, so the copy's steps leave this state as it is."""
        return SlabState([dataclasses.replace(p) for p in self.shards],
                         self._box, self.n, self.step, self.thermostat,
                         self.tilted, self.rng)


class RowState(_Sharded):
    """A particle-order state resident by contiguous particle rows per
    mesh shard (the JAX package's row-sharded particle arrays).

    ``shards[s]`` is a :class:`SimState` on ``devices[s]`` of the rows
    ``rows[s]`` (a ``slice``), with no halo; its ``noise_rows`` is
    ``(rows[s], n)``, so the stochastic integrators take each shard's rows
    of one ``[n, 3]`` draw on the first device
    (:func:`.integrators._noise`). The run-wide values are
    :class:`_Sharded`'s. :meth:`whole` joins the rows on the first device
    (a reader's :class:`SimState`, made on read); :meth:`split` and
    :meth:`join` move a tensor of every particle's rows to the shards and
    back.
    """

    def __init__(self, shards, rows, box, n, step=0, thermostat=None,
                 tilted=False, rng=None):
        self.rows = list(rows)
        super().__init__(shards, box, n, step, thermostat, tilted, rng)

    @classmethod
    def of(cls, state, devices, rows):
        """The particle-order :class:`SimState` ``state`` split into the
        ``rows`` (``slice``s) of each of ``devices``; a shard on
        ``state``'s own device holds views of its tensors."""
        shards = []
        for dev, r in zip(devices, rows):
            shards.append(SimState(
                **{k: to_device(getattr(state, k)[r], dev)
                   for k in _ROW_FIELDS},
                box=to_device(state.box, dev), step=state.step,
                tilted=state.tilted, noise_rows=(r, state.n_particles)))
        return cls(shards, rows, state.box, state.n_particles, state.step,
                   state.thermostat, state.tilted, state.rng)

    def copy(self):
        """A shallow copy whose shards are shallow copies too (see
        :meth:`SlabState.copy`)."""
        return RowState([dataclasses.replace(p) for p in self.shards],
                        self.rows, self._box, self.n, self.step,
                        self.thermostat, self.tilted, self.rng)

    def split(self, t):
        """A tensor of every particle's rows (on any device) -> each
        shard's rows on its device, :class:`Shards`."""
        return Shards(to_device(t[r], p.positions.device)
                      for r, p in zip(self.rows, self.shards))

    def join(self, vals):
        """Each shard's rows (:class:`Shards`) joined in particle order on
        the first shard's device."""
        dev = self.device
        return torch.cat([to_device(v, dev) for v in vals])

    def whole(self):
        """The particle-order :class:`SimState` on the first shard's
        device: the row fields joined (new tensors, made on each call),
        the run-wide values shared. Setting one of its fields writes the
        value through to this state (a row field split into the shards);
        a write into one of its tensors stays in that tensor."""
        st = _Joined(**{k: self.join(getattr(self, k)) for k in _ROW_FIELDS},
                     box=self.box, step=self.step,
                     thermostat=dict(self.thermostat), tilted=self.tilted,
                     rng=self.rng)
        object.__setattr__(st, "_owner", self)
        return st


class _Joined(SimState):
    """:meth:`RowState.whole`'s :class:`SimState`, whose field writes go
    through to the :class:`RowState` it was read from."""

    def __setattr__(self, name, value):
        object.__setattr__(self, name, value)
        owner = self.__dict__.get("_owner")
        if owner is None:
            return
        if name in _ROW_FIELDS:
            setattr(owner, name, owner.split(value))
        elif name in ("box", "step", "thermostat", "tilted", "rng"):
            setattr(owner, name, value)


_ROW_FIELDS = ("positions", "velocities", "types", "masses", "forces",
               "virial")


def shard_rows(n, S):
    """The contiguous particle rows of each of ``S`` mesh shards, ``n s //
    S`` on: ``slice``s."""
    return [slice(n * s // S, n * (s + 1) // S) for s in range(S)]


def first_rows(state):
    """A row tensor of ``state`` (a :class:`SimState`, or a sharded
    state's first shard's) for its dtype and device."""
    shards = getattr(state, "shards", None)
    return state.positions if shards is None else shards[0].positions


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
