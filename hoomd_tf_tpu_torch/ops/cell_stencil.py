"""The 27-cell stencil over cell slots, shared by the cell list's sort
method (:mod:`.cell_list`) and kernel K3's plain version
(:mod:`.nlist_cuda`): neighbour cell ids, minimum-image displacements
from query slots to their candidates in the JAX package's operation
order, and the scatter of slot rows to particle order; under a device
mesh each z-slab shard's layers and the buffer of its home layers with
one halo layer on each side, which the full stencil reaches (K3's slab
mode, the sort method per shard, the planes per shard)."""

import numpy as np
import torch

from .._device import to_device

__all__ = ["neighbor_cells", "chunk_pairs", "cell_chunks",
           "to_particle_order", "z_slabs", "check_slab", "halo_slab"]


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


def z_slabs(nz, n_shards):
    """``[(z0, nzl), ...]``: each of ``n_shards`` shards' z-layers of a
    packed cell grid of ``nz`` layers, ``z0 = nz s // S``, uneven when
    ``S`` does not divide ``nz`` (the packed plan has no divisor, as in
    the JAX package); ``nzl`` is 0 for a shard with no layer (``nz <
    S``), which has no work."""
    S = int(n_shards)
    return [(nz * s // S, nz * (s + 1) // S - nz * s // S) for s in range(S)]


def check_slab(grid, slab):
    """Raise unless ``slab = (z0, nzl)`` lies inside ``grid``'s layers."""
    nz = int(grid[2])
    z0, nzl = (int(v) for v in slab)
    if not (0 <= z0 and 1 <= nzl and z0 + nzl <= nz):
        raise ValueError(f"slab {slab} of a grid of {nz} layers")


def halo_slab(t, grid, per_cell, z0, nzl, device=None):
    """The rows a z-slab shard's full 27-cell stencil reads from ``t``, a
    tensor whose leading axis holds ``per_cell`` rows per cell of
    ``grid`` in the z-major cell order (slots: ``per_cell = cap``; counts:
    1): the halo layer ``(z0 - 1) % nz``, the home layers ``z0 .. z0 + nzl
    - 1`` and the halo layer ``(z0 + nzl) % nz``, on ``device`` when
    given. A halo layer may repeat a home layer (``nzl + 2 > nz``): the
    buffer is a list of layers, not a set."""
    nx, ny, nz = (int(g) for g in grid)
    check_slab(grid, (z0, nzl))
    layer = nx * ny * int(per_cell)
    # a shard's home layers end at z0 + nzl <= nz: only the halos wrap
    spans = [((z0 - 1) % nz, 1), (z0, nzl), ((z0 + nzl) % nz, 1)]
    buf = torch.cat([t[z * layer:(z + k) * layer] for z, k in spans])
    return buf if device is None else to_device(buf, device)
