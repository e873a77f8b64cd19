"""Wide-direct neighbor mode: component-separated candidate planes
(PyTorch port of ``hoomd_tf_tpu/ops/direct.py``).

The packed ``[N, NN, 4]`` list costs a nearest-NN selection. This mode
skips it: the model receives the 27-cell candidate planes directly,

    NlistPlanes(dx, dy, dz, type)    # each [N, C], C = 27 * cell capacity

with invalid slots exactly zero (the packed list's padding contract, only
wider). Models written against the helpers (:func:`.numerics.nlist_rinv`,
:func:`.forces.compute_nlist_forces`) work unchanged, since both accept
the planes; a model indexing ``nlist[:, :, :3]`` needs the packed mode.
"""

from typing import NamedTuple

import torch

from .._device import to_device
from .cell_list import build_planes
from .cell_stencil import neighbor_cells

__all__ = ["NlistPlanes", "direct_cell_planes", "direct_rows",
           "DirectPlanes"]


class NlistPlanes(NamedTuple):
    """Component-separated neighbor candidates, each ``[N, C]``; invalid
    slots are exactly zero in all four."""
    dx: torch.Tensor
    dy: torch.Tensor
    dz: torch.Tensor
    type: torch.Tensor

    @property
    def shape(self):
        return self.dx.shape

    def r2(self):
        return self.dx ** 2 + self.dy ** 2 + self.dz ** 2

    def stack(self):
        """The packed ``[N, C, 4]`` view (host and debug use)."""
        return torch.stack([self.dx, self.dy, self.dz, self.type], dim=-1)

    def map(self, fn):
        """The planes with ``fn`` applied to each component."""
        return NlistPlanes(*(fn(c) for c in self))


def _cell_of(pos3, grid, lengths):
    """Flat cell id of each particle (the binning of ``build_planes``)."""
    nx, ny, _ = grid
    frac = pos3 / lengths
    frac = frac - torch.floor(frac)
    xyz = [torch.clamp_max((frac[:, a] * float(d)).to(torch.int64), d - 1)
           for a, d in enumerate(grid)]
    return xyz[0] + nx * (xyz[1] + ny * xyz[2])


def direct_cell_planes(pos4, r_cut, grid, capacity, box_lengths,
                       rcut_matrix=None, neigh=None):
    """Candidate planes in particle order, with no selection.

    :param pos4: ``[N, 4]`` positions and type.
    :param r_cut: cutoff (slots beyond it are zero).
    :param grid, capacity: the plan of :func:`.cell_list.plan`.
    :param box_lengths: ``[3]`` box lengths tensor on ``pos4``'s device.
    :param rcut_matrix: ``[T, T]`` squared per-type cutoffs
        (:func:`.cellwise.rc2_table`), or ``None``.
    :param neigh: :func:`.cell_stencil.neighbor_cells` of the grid.
    :return: ``(NlistPlanes [N, 27 * capacity], overflow flag)``.
    """
    lengths = box_lengths.to(pos4.dtype)
    if neigh is None:
        neigh = neighbor_cells(grid, pos4.device)
    slots4, _, _, overflow = build_planes(pos4, grid, capacity, lengths)
    cell = _cell_of(pos4[:, :3], grid, lengths)
    return (direct_rows(pos4, slots4, cell, neigh, capacity, lengths, r_cut,
                        rcut_matrix), overflow)


def direct_rows(pos4, slots4, cell, neigh, cap, lengths, r_cut,
                rcut_matrix=None, rows=None):
    """The planes of the particle rows ``rows`` (a ``slice``, all by
    default) from the binned slots: each row's 27-cell candidates, equal
    to its row of the whole planes (a mesh shard's rows, as
    :func:`.nlist._compute_nlist`'s ``rows=``).

    :param slots4: ``[n_cells * cap, 4]`` slot rows of every cell.
    :param cell: ``[N]`` cell of each particle.
    :param lengths: ``[3]`` box lengths tensor of ``pos4``'s dtype.
    """
    from .cellwise import pair_rc2
    rows = slice(None) if rows is None else rows
    q4 = pos4[rows]
    ar = torch.arange(cap, device=pos4.device)
    gidx = (neigh[cell[rows]][:, :, None] * cap + ar).reshape(
        q4.shape[0], 27 * cap)
    g = slots4[gidx]                                     # [rows, C, 4]
    dd = []
    for a in range(3):
        d = g[:, :, a] - q4[:, a:a + 1]
        dd.append(d - torch.round(d / lengths[a]) * lengths[a])
    d2 = dd[0] * dd[0] + dd[1] * dd[1] + dd[2] * dd[2]
    valid = (d2 <= r_cut * r_cut) & (d2 >= 25e-8)
    gt = g[:, :, 3]
    if rcut_matrix is not None:
        valid = valid & (d2 <= pair_rc2(q4[:, 3:4], gt, rcut_matrix))
    zero = torch.zeros((), dtype=pos4.dtype, device=pos4.device)
    return NlistPlanes(*(torch.where(valid, v, zero)
                         for v in (dd[0], dd[1], dd[2], gt)))


class DirectPlanes:
    """The ``'direct'`` neighbor build for a fixed plan, its device
    constants made once: ``build(pos4, box_lengths) -> (NlistPlanes,
    overflow)``.

    :param rcut_matrix: per-type-pair cutoffs (numpy), or ``None``.
    :param dtype: the positions' dtype (the cutoff table's).
    """

    method = "direct"

    def __init__(self, grid, capacity, r_cut, device, rcut_matrix=None,
                 dtype=torch.float32):
        from .cellwise import rc2_table
        self.grid, self.capacity = tuple(int(g) for g in grid), int(capacity)
        self.r_cut = float(r_cut)
        self.neigh = neighbor_cells(self.grid, device)
        self.rc2_tab = (None if rcut_matrix is None else
                        rc2_table(rcut_matrix, dtype, device))
        self._shard_consts = {}

    @property
    def plan(self):
        """``(grid, capacity)``."""
        return self.grid, self.capacity

    def __call__(self, pos4, box_lengths):
        return direct_cell_planes(pos4, self.r_cut, self.grid, self.capacity,
                                  box_lengths, self.rc2_tab, self.neigh)

    def sharded(self, pos4, box_lengths, devices):
        """The build under a device mesh of the shards on ``devices``: the
        particles binned once on ``pos4``'s device; each shard's contiguous
        particle rows (``N s // S`` on) get their planes on its device from
        a copy of the slots (:func:`direct_rows`), gathered on ``pos4``'s
        device. Equal to a call's planes bit for bit; the overflow flag is
        the binning's, over every cell.

        :returns: ``(NlistPlanes [N, 27 * capacity], overflow)``."""
        lengths = box_lengths.to(pos4.dtype)
        slots4, _, _, overflow = build_planes(pos4, self.grid, self.capacity,
                                              lengths)
        cell = _cell_of(pos4[:, :3], self.grid, lengths)
        n, S = pos4.shape[0], len(devices)
        parts = []
        for s, dev in enumerate(devices):
            rows = slice(n * s // S, n * (s + 1) // S)
            dev = torch.device(dev)
            neigh, rc2 = self._consts(dev)
            pl = direct_rows(to_device(pos4[rows], dev),
                             to_device(slots4, dev),
                             to_device(cell[rows], dev), neigh,
                             self.capacity, to_device(lengths, dev),
                             self.r_cut, rc2)
            parts.append(pl.map(lambda c: to_device(c, pos4.device)))
        return NlistPlanes(*(torch.cat(cs) for cs in zip(*parts))), overflow

    def prepare(self, devices):
        """Make each shard's device constants now (see
        :meth:`.cell_list.CellNlist.prepare`)."""
        for dev in devices:
            self._consts(torch.device(dev))

    def _consts(self, device):
        """The neighbour ids and the typed-cutoff table on a shard's
        ``device`` (made once per device)."""
        key = str(device)
        c = self._shard_consts.get(key)
        if c is None:
            c = self._shard_consts[key] = (
                to_device(self.neigh, device),
                None if self.rc2_tab is None else
                to_device(self.rc2_tab, device))
        return c
