"""The 27-cell stencil over cell slots, shared by the cell list's sort
method (:mod:`.cell_list`) and kernel K3's plain version
(:mod:`.nlist_cuda`): neighbour cell ids, minimum-image displacements
from query slots to their candidates in the JAX package's operation
order, and the scatter of slot rows to particle order; under a device
mesh each z-slab shard's layers, the runs of layers a device's group of
shards holds, and the buffer of home layers with one halo layer on each
side, which the full stencil reaches (K3's group mode off the binning
device, the sort method per device, the planes per shard)."""

import numpy as np
import torch

from .._device import to_device

__all__ = ["neighbor_cells", "chunk_pairs", "cell_chunks",
           "to_particle_order", "z_slabs", "check_slab", "group_layers",
           "check_group", "joined_slab", "group_cells"]


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


def chunk_pairs(slots4, neigh, cap, L, c0, c1, qcells=None):
    """Minimum-image displacements from the query slots of cells
    ``c0:c1`` to their 27-cell candidates: ``(ddx, ddy, ddz, d2, qt,
    gt)``, each ``[cells, cap, 27 cap]`` (``qt`` ``[cells, cap, 1]``, ``gt``
    ``[cells, 1, 27 cap]``), in the JAX package's operation order
    (candidate minus query, ``d - round(d / L) * L``).

    :param slots4: ``[n_cells * cap, 4]`` slot rows ``(x, y, z, type)``.
    :param neigh: :func:`neighbor_cells` of the grid, or with ``qcells``
        the 27 neighbours of each of those cells (:func:`group_cells`).
    :param L: ``[3]`` box lengths tensor on the slots' device.
    :param qcells: ``[M]`` query cells: ``c0:c1`` then index them (default:
        the cells ``c0:c1`` themselves).
    """
    m = c1 - c0
    dev = slots4.device
    ar = torch.arange(cap, device=dev)
    gidx = (neigh[c0:c1, :, None] * cap + ar).reshape(m, 27 * cap)
    g = slots4[gidx]                                    # [m, C, 4]
    qc = (torch.arange(c0, c1, device=dev) if qcells is None else
          qcells[c0:c1])
    q = slots4[(qc[:, None] * cap + ar).reshape(-1)].reshape(m, cap, 4)
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


def group_layers(slabs):
    """The runs of consecutive layers of a group of z-slab shards (its
    ``(z0, nzl)`` each): ``((z0, nzl), ...)`` in layer order, adjacent
    shards merged, shards with no layer left out (a run does not wrap past
    the last layer)."""
    runs = []
    for z0, nzl in sorted((int(z0), int(k)) for z0, k in slabs if k):
        if runs and runs[-1][0] + runs[-1][1] == z0:
            runs[-1] = (runs[-1][0], runs[-1][1] + nzl)
        else:
            runs.append((z0, nzl))
    return tuple(runs)


def check_group(grid, group):
    """``group`` (runs of layers, :func:`group_layers`) as a tuple of
    ``(z0, nzl)`` int pairs; ``None`` is every layer. Raises unless each
    run lies inside ``grid``'s layers and no two overlap."""
    nz = int(grid[2])
    if group is None:
        return ((0, nz),)
    runs = tuple((int(z0), int(k)) for z0, k in group)
    for sl in runs:
        check_slab(grid, sl)
    if not runs or sum(k for _, k in runs) != len(
            {z for z0, k in runs for z in range(z0, z0 + k)}):
        raise ValueError(f"runs of layers {group} are empty or overlap")
    return runs


def joined_slab(t, grid, per_cell, runs, device=None):
    """The rows the full 27-cell stencil of a group's runs of layers
    (:func:`group_layers`; a z-slab shard alone: one run) reads from
    ``t``, a tensor whose leading axis holds ``per_cell`` rows per cell of
    ``grid`` in the z-major cell order (slots: ``per_cell = cap``; counts:
    1): for each run its halo layer below, its home layers and its halo
    layer above, one copy in all, on ``device`` when given. A halo layer
    may repeat a home layer (``nzl + 2 > nz``): the buffer is a list of
    layers, not a set."""
    nx, ny, nz = (int(g) for g in grid)
    layer = nx * ny * int(per_cell)
    spans = []
    for z0, nzl in check_group(grid, runs):
        spans += [((z0 - 1) % nz, 1), (z0, nzl), ((z0 + nzl) % nz, 1)]
    buf = torch.cat([t[z * layer:(z + k) * layer] for z, k in spans])
    return buf if device is None else to_device(buf, device)


def group_cells(grid, runs, joined, device):
    """``(qcells, neigh)``: the home cells of a group's runs of layers, in
    layer order, as ``[M]`` int64 ids of the table the group reads, and
    their 27 neighbours ``[M, 27]`` in :func:`neighbor_cells`' order. In
    place (``joined`` false) the table is the whole grid and the stencil
    wraps; joined, it is :func:`joined_slab`'s buffer, each run's window
    inside its own layers."""
    nx, ny, nz = (int(g) for g in grid)
    cells = nx * ny
    runs = check_group(grid, runs)
    if not joined:
        q = torch.cat([torch.arange(z0 * cells, (z0 + k) * cells)
                       for z0, k in runs])
        return (q.to(device),
                neighbor_cells((nx, ny, nz), "cpu")[q].to(device))
    qs, ns, base = [], [], 0
    for _, k in runs:
        home = torch.arange(cells, (k + 1) * cells)
        qs.append(home + base)
        ns.append(neighbor_cells((nx, ny, k + 2), "cpu")[home] + base)
        base += (k + 2) * cells
    return torch.cat(qs).to(device), torch.cat(ns).to(device)
