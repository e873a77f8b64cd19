"""O(N) cell-list neighbor build (PyTorch port of
``hoomd_tf_tpu/ops/cell_list.py``): the packed ``[N, NN, 4]`` neighbor
list of the ``'cell'`` / ``'pallas'`` neighbor modes.

1. bin the particles into an ``nx x ny x nz`` grid (cell edge >= r_cut)
   and scatter them into fixed-capacity cell slots, ``[n_cells * cap]``
   rows of ``(x, y, z, type)``; empty slots hold a far sentinel
   (:func:`build_planes`, overflow flagged);
2. per query slot, test the 27 neighbouring cells' slots with the
   minimum-image distance and keep the nearest NN:

   - ``method='sort'``: plain PyTorch, a per-row sort of the distance
     key (XLA code in the JAX package, not a Pallas kernel), chunked
     over cells so the ``[cells, cap, 27 cap]`` work stays bounded;
   - ``method='pallas'`` (the JAX name, kept so scripts run unchanged):
     kernel K3 (:mod:`.nlist_cuda`), hand-written for Hopper, on a CUDA
     tensor; its plain version on a CPU tensor.

Binning uses a stable ``argsort``, so in-cell ranks (and with them the
candidate slot order K3's key breaks ties on) equal the JAX package's.
Torch has no scatter "drop" mode: particles past a full cell's capacity
go to one extra dump slot, which is sliced off; their rows of the list
are zero. Either way the overflow flag is set and the caller re-plans.
"""

import math

import numpy as np
import torch

from .._device import device_for, to_device
from .box import box_size as _box_size, host_tilt
from .cell_stencil import (cell_chunks, chunk_pairs, group_cells,
                           group_layers, joined_slab, neighbor_cells,
                           to_particle_order, z_slabs)
from .nlist_cuda import cut_values, host_length, nlist_select


__all__ = ["CellList", "CellNlist", "cell_list_nlist", "plan",
           "max_occupancy", "build_planes"]

#: far sentinel coordinate of an empty slot
FAR = 1e30


class CellList:
    """Configuration for the cell-list neighbor build.

    :param capacity: max particles per cell (default: estimated from the
        mean density with 2x headroom, and from measured occupancy in a
        simulation).
    :param skin: extra margin added to the cell edge.
    """

    def __init__(self, capacity=None, skin=0.0):
        self.capacity = capacity
        self.skin = float(skin)

    def grid_for(self, box_lengths, r_cut):
        edge = r_cut + self.skin
        return tuple(max(1, int(math.floor(L / edge))) for L in box_lengths)

    def usable(self, box_lengths, r_cut):
        """Cell lists need >= 3 cells per dimension so the 27-cell
        stencil covers the cutoff without double counting."""
        return all(d >= 3 for d in self.grid_for(box_lengths, r_cut))

    def default_capacity(self, n, box_lengths, r_cut):
        # 2x headroom over the mean occupancy: lattice starts and density
        # fluctuations routinely reach ~2x the mean per cell; overflow is
        # still detected at run time
        vol = float(np.prod(box_lengths))
        edge = r_cut + self.skin
        per_cell = n / vol * edge ** 3
        return max(4, int(math.ceil(per_cell * 2.0)) + 4)


def max_occupancy(positions, box_lengths, grid):
    """Measured max particles per cell for concrete positions (host side;
    sizes the capacity against structured initial conditions)."""
    if torch.is_tensor(positions):
        positions = positions.detach().cpu().numpy()
    positions = np.asarray(positions)[:, :3].astype(np.float64)
    lengths = np.asarray(box_lengths, dtype=np.float64)
    frac = positions / lengths
    frac = frac - np.floor(frac)
    dims = np.asarray(grid)
    xyz = np.minimum((frac * dims).astype(np.int64), dims - 1)
    cid = xyz[:, 0] + dims[0] * (xyz[:, 1] + dims[1] * xyz[:, 2])
    return int(np.bincount(cid, minlength=int(np.prod(dims))).max())


def plan(n, box_lengths, r_cut, config=None):
    """Static geometry of the build, ``(grid, capacity)`` from concrete
    box lengths; ``(None, None)`` when the box holds fewer than 3 cells
    per axis."""
    config = config or CellList()
    np_lengths = np.asarray(box_lengths, dtype=np.float64)
    grid = config.grid_for(np_lengths, r_cut)
    if not all(d >= 3 for d in grid):
        return None, None
    capacity = config.capacity or config.default_capacity(
        n, np_lengths, r_cut)
    return tuple(grid), int(capacity)


def build_planes(pos4, grid, capacity, lengths):
    """Bin the particles and scatter them into cell slots.

    :param lengths: ``[3]`` box lengths tensor on the positions' device.
    :return: ``(slots4, counts, pid, overflow)``: ``[n_cells * cap, 4]``
        slot rows ``(x, y, z, type)`` (empty: ``(FAR, FAR, FAR, 0)``),
        ``[n_cells]`` int32 occupancy (clipped at ``cap``), ``[n_cells *
        cap]`` int32 particle of each slot (``-1`` empty; a particle past
        a full cell's capacity holds none) and the 0-d bool overflow
        flag.
    """
    n = pos4.shape[0]
    nx, ny, nz = grid
    n_cells = nx * ny * nz
    cap = capacity
    n_slots = n_cells * cap
    dev = pos4.device
    pos3 = pos4[:, :3]

    frac = pos3 / lengths
    frac = frac - torch.floor(frac)
    cell_xyz = [torch.clamp_max((frac[:, a] * float(d)).to(torch.int64),
                                d - 1) for a, d in enumerate(grid)]
    cell_id = cell_xyz[0] + nx * (cell_xyz[1] + ny * cell_xyz[2])

    order = torch.argsort(cell_id, stable=True)
    sorted_cells = cell_id[order]
    starts = torch.searchsorted(
        sorted_cells, torch.arange(n_cells + 1, device=dev), side="left")
    counts = starts[1:] - starts[:-1]
    rank = torch.arange(n, device=dev) - starts[sorted_cells]
    overflow = torch.any(rank >= cap)
    slot_of_sorted = torch.where(rank < cap, sorted_cells * cap + rank,
                                 torch.full_like(rank, n_slots))

    slots4 = torch.full((n_slots + 1, 4), FAR, dtype=pos4.dtype, device=dev)
    slots4[:, 3] = 0.0
    slots4[slot_of_sorted] = pos4[order]
    pid = torch.full((n_slots + 1,), -1, dtype=torch.int32, device=dev)
    pid[slot_of_sorted] = order.to(torch.int32)
    return (slots4[:n_slots], torch.clamp_max(counts, cap).to(torch.int32),
            pid[:n_slots], overflow)


def sort_nlist(slots4, pid, n, grid, cap, NN, r_cut, lengths, rc2_tab=None,
               neigh=None):
    """The ``'sort'`` selection in plain PyTorch: per query slot, the
    candidates inside the cut ordered by ``d2`` (ties in another order
    than XLA's sort, so neighbor *sets* match the JAX package exactly and
    the order up to equal distances); ``[N, NN, 4]`` in particle order.

    :param pid: ``[n_cells * cap]`` particle of each slot (``-1`` empty).
    :param n: number of particles.
    :param lengths: ``[3]`` box lengths tensor on the slots' device.
    :param rc2_tab: ``[T, T]`` squared per-type cutoffs, or ``None``.
    """
    rows = sort_rows(slots4, grid, cap, NN, r_cut, lengths, rc2_tab, neigh)
    return to_particle_order(rows, pid, n)


def sort_rows(slots4, grid, cap, NN, r_cut, lengths, rc2_tab=None,
              neigh=None, qcells=None):
    """:func:`sort_nlist`'s rows in slot order, ``[cells cap, NN, 4]``, of
    the query slots of every cell of ``grid``, or of the cells
    ``qcells`` (a group's home cells; ``neigh`` then their neighbour ids,
    :func:`.cell_stencil.group_cells`). An empty slot's row is zero."""
    from .cellwise import pair_rc2
    m = int(np.prod(grid)) if qcells is None else qcells.shape[0]
    if neigh is None:
        neigh = neighbor_cells(grid, slots4.device)
    C = 27 * cap
    k = min(NN, C)
    rc2, lo2 = cut_values(r_cut, slots4.dtype)
    # the key: d2's bits as an integer of d2's width (d2 >= 0, so integer
    # order is value order), the integer's max where invalid
    itype = torch.int64 if slots4.dtype == torch.float64 else torch.int32
    out = torch.zeros((m * cap, NN, 4), dtype=slots4.dtype,
                      device=slots4.device)
    for a0, a1 in cell_chunks(m, cap):
        ddx, ddy, ddz, d2, qt, gt = chunk_pairs(slots4, neigh, cap, lengths,
                                                a0, a1, qcells)
        valid = (d2 <= rc2) & (d2 >= lo2)
        if rc2_tab is not None:
            valid = valid & (d2 <= pair_rc2(qt, gt, rc2_tab))
        rows = (a1 - a0) * cap
        key = torch.where(valid, d2.view(itype),
                          torch.iinfo(itype).max).reshape(rows, C)
        idx = torch.sort(key, dim=1, stable=True).indices[:, :k]
        gt_b = gt.expand_as(d2).reshape(rows, C)
        pay = torch.stack([torch.gather(p.reshape(rows, C), 1, idx) for p in
                           (ddx, ddy, ddz, gt_b)], dim=-1)
        keep = torch.gather(valid.reshape(rows, C), 1, idx)
        out[a0 * cap:a1 * cap, :k] = pay * keep[..., None].to(pay.dtype)
    return out


class CellNlist:
    """The cell-list build for a fixed plan, with its device constants
    (neighbour ids, the typed-cutoff table) made once, so that calling it
    in the step loop copies nothing from the host.

    :param grid, capacity: the plan (:func:`plan`).
    :param lengths: host box lengths (their values in ``dtype``'s
        precision are the ones kernel K3 takes, as the JAX package's
        ``static_lengths``).
    :param method: ``'sort'`` or ``'pallas'`` (kernel K3).
    :param rcut_matrix: per-type-pair cutoffs (``'sort'`` only).
    :param dtype: the positions' dtype (float32 or float64): the precision
        of K3's lengths and of the cutoff table.
    """

    def __init__(self, grid, capacity, lengths, r_cut, NN, method, device,
                 rcut_matrix=None, dtype=torch.float32):
        from .cellwise import rc2_table
        if rcut_matrix is not None and method == "pallas":
            raise ValueError("per-type r_cut is not supported by the "
                             "selection kernel K3; use method='sort'")
        if method not in ("sort", "pallas"):
            raise ValueError(f"unknown cell-list method {method!r}")
        self.grid, self.capacity = tuple(int(g) for g in grid), int(capacity)
        self.lengths = tuple(host_length(v, dtype) for v in lengths)
        self.r_cut, self.NN, self.method = float(r_cut), int(NN), method
        # K3 gathers the stencil itself
        self.neigh = (neighbor_cells(self.grid, device) if method == "sort"
                      else None)
        self.rc2_tab = (None if rcut_matrix is None else
                        rc2_table(rcut_matrix, dtype, device))
        # each mesh's groups of shards by device (:meth:`_groups`)
        self._shard_consts = {}

    @property
    def plan(self):
        """``(grid, capacity)``."""
        return self.grid, self.capacity

    def __call__(self, pos4, box_lengths):
        """``(nlist [N, NN, 4], overflow)`` for ``pos4`` in a box of
        ``box_lengths`` (a ``[3]`` tensor on the positions' device)."""
        lengths = box_lengths.to(pos4.dtype)
        n = pos4.shape[0]
        slots4, counts, pid, overflow = build_planes(pos4, self.grid,
                                                     self.capacity, lengths)
        if self.method == "pallas":
            nlist = nlist_select(slots4, counts, pid, self.grid,
                                 self.capacity, self.NN, self.r_cut,
                                 self.lengths, n)
        else:
            nlist = sort_nlist(slots4, pid, n, self.grid, self.capacity,
                               self.NN, self.r_cut, lengths, self.rc2_tab,
                               self.neigh)
        return nlist, overflow

    def _groups(self, devices, home):
        """The mesh's z-slab shards on ``devices`` (as a :class:`.Mesh`
        holds them: a card with its index) (:func:`.cell_stencil.
        z_slabs`: ``nz s // S`` on, uneven where ``S`` does not divide
        ``nz``) grouped by device (:func:`.cellwise.slab_groups`), one
        entry a device that holds a layer: ``(device, runs, joined,
        qcells, neigh, rc2)``, its runs of layers
        (:func:`.cell_stencil.group_layers`), whether it reads a joined
        buffer (any device but ``home``, the binning one) or the table in
        place, and the sort method's cells, neighbour ids and typed-cutoff
        table on the device (:func:`.cell_stencil.group_cells`). Made once
        per mesh and binning device."""
        from .cellwise import slab_groups
        key = (tuple(devices), home)
        groups = self._shard_consts.get(key)
        if groups is None:
            slabs = [(d, z0, nzl) for d, (z0, nzl) in
                     zip(devices, z_slabs(self.grid[2], len(devices)))]
            groups = []
            for g in slab_groups(slabs):
                runs = group_layers(g.slabs)
                if not runs:
                    continue
                dev, joined = g.device, g.device != home
                qcells = neigh = rc2 = None
                if self.method == "sort":
                    qcells, neigh = group_cells(self.grid, runs, joined, dev)
                    rc2 = (None if self.rc2_tab is None else
                           to_device(self.rc2_tab, dev))
                groups.append((dev, runs, joined, qcells, neigh, rc2))
            groups = self._shard_consts[key] = tuple(groups)
        return groups

    def prepare(self, devices):
        """Make the groups' device constants (:meth:`sharded`'s) now, so a
        step loop's first sharded call copies nothing from the host; the
        particles are binned on the first shard's device (a mesh
        simulation's own)."""
        self._groups(devices, devices[0])

    def sharded(self, pos4, box_lengths, devices):
        """The build under a device mesh of the shards on ``devices``:
        the particles binned once on ``pos4``'s device, then each device's
        z-slab shards (:meth:`_groups`) selected in one call over their
        layers -- K3's group mode, or the sort method over the group's
        cells. On the binning device the call reads the cell table in
        place and writes its particles' rows (K3: and zero rows for
        particles without a slot) straight into the list; any other
        device selects from one joined buffer of its layers with a halo
        layer each side, and its home slots' rows are scattered in by
        ``pid``. Every row equals the unsharded call's bit for bit. The
        overflow flag is the binning's over every cell.

        :returns: ``(nlist [N, NN, 4], overflow)``, as a call."""
        lengths = box_lengths.to(pos4.dtype)
        slots4, counts, pid, overflow = build_planes(pos4, self.grid,
                                                     self.capacity, lengths)
        n, home = pos4.shape[0], pos4.device
        nx, ny, _ = self.grid
        layer = nx * ny * self.capacity
        groups = self._groups(devices, home)
        k3 = self.method == "pallas"
        # one dump row past the particles for the scatters' empty slots; K3
        # in place writes every row it owns, else the list starts at zero
        fill = torch.empty if k3 and any(not g[2] for g in groups) \
            else torch.zeros
        out = fill((n + 1, self.NN, 4), dtype=pos4.dtype, device=home)
        for dev, runs, joined, qcells, neigh, rc2 in groups:
            if k3 and not joined:
                nlist_select(slots4, counts, pid, self.grid, self.capacity,
                             self.NN, self.r_cut, self.lengths, n,
                             group=runs, out=out)
                continue
            if joined:
                buf = joined_slab(slots4, self.grid, self.capacity, runs,
                                  dev)
            if k3:
                rows = nlist_select(
                    buf, joined_slab(counts, self.grid, 1, runs, dev), None,
                    self.grid, self.capacity, self.NN, self.r_cut,
                    self.lengths, None, group=runs)
            else:
                rows = sort_rows(buf if joined else slots4, self.grid,
                                 self.capacity, self.NN, self.r_cut,
                                 to_device(lengths, dev), rc2, neigh,
                                 qcells=qcells)
            p = torch.cat([pid[z0 * layer:(z0 + k) * layer]
                           for z0, k in runs])
            out[torch.where(p >= 0, p.long(), n)] = to_device(rows, home)
        return out[:n], overflow


def cell_list_nlist(pos4, r_cut, NN, box, config=None, return_overflow=False,
                    grid=None, capacity=None, method="sort",
                    static_lengths=None, rcut_matrix=None, device=None):
    """Padded ``[N, NN, 4]`` neighbor list (displacement and neighbor
    type) by a fixed-capacity cell list, nearest first (approximately for
    ``'pallas'``: the slot index breaks ties in the low mantissa bits).

    :param pos4: ``[N, 4]`` positions with the type in the last column.
    :param box: ``[3, 3]`` box (or ``[3]`` lengths).
    :param config: a :class:`CellList` (default constructed).
    :param return_overflow: also return the 0-d bool flag, set when a
        cell exceeded its capacity (neighbors may then be missing).
    :param grid, capacity: a plan from :func:`plan` (default: planned
        from the box).
    :param method: ``'sort'`` or ``'pallas'`` (kernel K3 on a CUDA tensor,
        its plain version on a CPU one).
    :param static_lengths: ``(Lx, Ly, Lz)`` for K3 (default: the box's).
    :param rcut_matrix: per-type-pair ``[ntypes, ntypes]`` cutoffs
        (negative = never neighbors; ``r_cut`` must be its max). Not
        supported by ``method='pallas'``.
    :param device: where the list is built: by default a tensor's own
        device, and the CUDA card for host data (``device="cpu"`` for the
        CPU). Host data becomes float32; a float64 tensor keeps float64
        (the selection keys are made from d2 in the positions' dtype).
    """
    pos4 = torch.as_tensor(
        pos4, dtype=None if torch.is_tensor(pos4) else torch.float32,
        device=device_for(pos4, device, "cell_list_nlist"))
    box = torch.as_tensor(box, dtype=pos4.dtype, device=pos4.device)
    if box.ndim == 2:
        if any(host_tilt(box[2])):
            raise NotImplementedError(
                "the packed cell-list tier is orthorhombic-only; tilted "
                "(triclinic) boxes take compute_nlist (O(N^2)) or "
                "nlist='cellwise'")
        lengths = _box_size(box)
    else:
        lengths = box
    np_lengths = lengths.detach().cpu().numpy().astype(np.float64)
    if grid is None or capacity is None:
        grid, capacity = plan(pos4.shape[0], np_lengths, r_cut, config)
        if grid is None:
            raise ValueError(
                f"Box {np_lengths} too small for a cell list at "
                f"r_cut={r_cut}; use compute_nlist (O(N^2)) instead")
    build = CellNlist(grid, capacity, static_lengths or np_lengths, r_cut,
                      NN, method, pos4.device, rcut_matrix, pos4.dtype)
    nlist, overflow = build(pos4, lengths)
    if return_overflow:
        return nlist, overflow
    return nlist
