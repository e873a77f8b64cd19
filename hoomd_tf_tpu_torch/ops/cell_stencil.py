"""The 27-cell stencil over cell slots, shared by the cell list's sort
method (:mod:`.cell_list`) and kernel K3's plain version
(:mod:`.nlist_cuda`): neighbour cell ids, minimum-image displacements
from query slots to their candidates in the JAX package's operation
order, and the scatter of slot rows to particle order."""

import numpy as np
import torch

__all__ = ["neighbor_cells", "chunk_pairs", "cell_chunks",
           "to_particle_order"]


def neighbor_cells(grid, device):
    """``[n_cells, 27]`` ids of each cell's 27 neighbours (periodic), the
    offsets in the JAX package's order: ``k = 9 (a+1) + 3 (b+1) + (c+1)``
    for the offset ``(a, b, c)`` added to ``(x, y, z)``."""
    nx, ny, nz = grid
    z, y, x = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx),
                          indexing="ij")
    base = np.stack([x.ravel(), y.ravel(), z.ravel()], axis=-1)
    offs = np.asarray([(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1)
                       for c in (-1, 0, 1)])
    nb = (base[:, None, :] + offs[None, :, :]) % np.asarray(grid)
    ids = nb[..., 0] + nx * (nb[..., 1] + ny * nb[..., 2])
    return torch.as_tensor(ids, dtype=torch.int64, device=device)


def chunk_pairs(slots4, neigh, cap, L, c0, c1):
    """Minimum-image displacements from the query slots of cells
    ``c0:c1`` to their 27-cell candidates: ``(ddx, ddy, ddz, d2, qt,
    gt)``, each ``[cells, cap, 27 cap]`` (``qt`` ``[cells, cap, 1]``, ``gt``
    ``[cells, 1, 27 cap]``), in the JAX package's operation order
    (candidate minus query, ``d - round(d / L) * L``).

    :param slots4: ``[n_cells * cap, 4]`` slot rows ``(x, y, z, type)``.
    :param neigh: :func:`neighbor_cells` of the grid.
    :param L: ``[3]`` box lengths tensor on the slots' device.
    """
    m = c1 - c0
    dev = slots4.device
    ar = torch.arange(cap, device=dev)
    gidx = (neigh[c0:c1, :, None] * cap + ar).reshape(m, 27 * cap)
    g = slots4[gidx]                                    # [m, C, 4]
    q = slots4[(torch.arange(c0, c1, device=dev)[:, None] * cap +
                ar).reshape(-1)].reshape(m, cap, 4)
    dd = []
    for a in range(3):
        d = g[:, None, :, a] - q[:, :, None, a]
        dd.append(d - torch.round(d / L[a]) * L[a])
    d2 = dd[0] * dd[0] + dd[1] * dd[1] + dd[2] * dd[2]
    return dd[0], dd[1], dd[2], d2, q[:, :, None, 3], g[:, None, :, 3]


def cell_chunks(n_cells, cap, budget=1 << 22):
    """``(c0, c1)`` ranges of cells whose ``[cells, cap, 27 cap]`` pair
    planes hold about ``budget`` elements each."""
    step = max(1, budget // (cap * 27 * cap))
    for c0 in range(0, n_cells, step):
        yield c0, min(n_cells, c0 + step)


def to_particle_order(rows, pid, n):
    """``[n, ...]`` rows of the particles from ``rows`` in slot order,
    through ``pid`` (the particle of each slot, ``-1`` when empty). A
    particle that holds no slot (past a full cell's capacity) gets a zero
    row; empty slots scatter into a dump row that is sliced off."""
    dest = torch.where(pid >= 0, pid.to(torch.int64), n)
    out = torch.zeros((n + 1,) + tuple(rows.shape[1:]), dtype=rows.dtype,
                      device=rows.device)
    out[dest] = rows
    return out[:n]
