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

from .cell_list import build_planes
from .cell_stencil import neighbor_cells

__all__ = ["NlistPlanes", "direct_cell_planes", "DirectPlanes"]


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
    from .cellwise import pair_rc2
    n = pos4.shape[0]
    cap = capacity
    lengths = box_lengths.to(pos4.dtype)
    if neigh is None:
        neigh = neighbor_cells(grid, pos4.device)
    slots4, _, _, overflow = build_planes(pos4, grid, cap, lengths)
    cell = _cell_of(pos4[:, :3], grid, lengths)
    ar = torch.arange(cap, device=pos4.device)
    gidx = (neigh[cell][:, :, None] * cap + ar).reshape(n, 27 * cap)
    g = slots4[gidx]                                     # [N, C, 4]
    dd = []
    for a in range(3):
        d = g[:, :, a] - pos4[:, a:a + 1]
        dd.append(d - torch.round(d / lengths[a]) * lengths[a])
    d2 = dd[0] * dd[0] + dd[1] * dd[1] + dd[2] * dd[2]
    valid = (d2 <= r_cut * r_cut) & (d2 >= 25e-8)
    gt = g[:, :, 3]
    if rcut_matrix is not None:
        valid = valid & (d2 <= pair_rc2(pos4[:, 3:4], gt, rcut_matrix))
    zero = torch.zeros((), dtype=pos4.dtype, device=pos4.device)
    return (NlistPlanes(*(torch.where(valid, v, zero)
                          for v in (dd[0], dd[1], dd[2], gt))), overflow)


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

    @property
    def plan(self):
        """``(grid, capacity)``."""
        return self.grid, self.capacity

    def __call__(self, pos4, box_lengths):
        return direct_cell_planes(pos4, self.r_cut, self.grid, self.capacity,
                                  box_lengths, self.rc2_tab, self.neigh)
