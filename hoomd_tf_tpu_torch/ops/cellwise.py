"""Slot-resident ("cellwise") neighbor machinery -- PyTorch port of
``hoomd_tf_tpu/ops/cellwise.py``.

The state lives in cell-slot layout: ``n_slots = n_cells * capacity``
rows, row ``cell * capacity + k`` holds the k-th particle of that cell,
surplus rows are ghosts (``valid == 0``) parked at their cell center.
The tensor forms build candidate planes from static ``torch.roll`` calls
on the ``[nz, ny, nx, cap]`` view (the kernels of
:mod:`.cellwise_cuda` gather the same cells themselves); a sort-based
repack re-bins the state every
K steps (:func:`repack_src`). See the JAX module for the full design
rationale; this port keeps its layouts and numerics so the two can be
compared element for element.

Triclinic (tilted) boxes: cells are a regular grid in fractional space,
binning solves the upper-triangular cell matrix, centers and stencil
offsets go through the box matrix, and the minimum image is the
sequential z, y, x wrap (:func:`_wrap_tri`); the grid is sized by the
perpendicular layer widths (:func:`_perp_widths`). Every geometric
quantity the tensor forms and the kernels use -- lengths, cell edges,
centers, offsets -- is derived in the state's dtype (float32, or float64
for a float64 state) from a ``[3, 3]`` box tensor on the device
(:class:`SlotGeometry`), so a barostat's box (the dynamic-box layout,
:class:`..md.slots.SlotLayout`) needs no new plan.
"""

import dataclasses
import functools
import math

import numpy as np
import torch

from .._device import resolve_device, to_device
from .cell_list import CellList

__all__ = ["Cellwise", "CellwisePlan", "plan_cellwise",
           "analytic_pair_forces", "cellwise_planes", "repack_order", "repack_src",
           "slot_cell_centers", "bin_cells", "SlotGeometry",
           "half_stencil_slab_plain", "slab_layers", "slab_rows"]


class Cellwise(CellList):
    """Configuration selecting the slot-resident neighbor mode
    (``tfc.attach(sim, nlist=Cellwise(...))``; the bare string
    ``nlist='cellwise'`` uses the defaults).

    :param capacity: slots per cell (default: planned from occupancy).
    :param skin: *minimum* Verlet margin; the planner may pick a larger
        one when a coarser grid is cheaper.
    """


# 27-cell stencil offsets in (ox, oy, oz) order
_OFFS = [(ox, oy, oz) for oz in (-1, 0, 1) for oy in (-1, 0, 1)
         for ox in (-1, 0, 1)]

# Half stencil for Newton's-third-law accumulation: the self cell plus
# the 13 offsets whose first nonzero component (z-major) is positive.
_HALF_OFFS = [(0, 0, 0)] + [o for o in _OFFS
                            if (o[2], o[1], o[0]) > (0, 0, 0)]


def _perp_widths(lengths, tilt):
    """Perpendicular widths of a triclinic box: per axis the distance
    between the two faces spanned by the other two lattice vectors (``V /
    |b x c|`` etc.). These, not the edge lengths, are what a layer of
    cells must cover for the 27-stencil to see every pair within
    ``r_cut``; with zero tilt they are the edge lengths."""
    Lx, Ly, Lz = (float(v) for v in lengths)
    xy, xz, yz = (float(v) for v in tilt)
    a = np.array([Lx, 0.0, 0.0])
    b = np.array([xy * Ly, Ly, 0.0])
    c = np.array([xz * Lz, yz * Lz, Lz])
    V = Lx * Ly * Lz
    return (V / float(np.linalg.norm(np.cross(b, c))),
            V / float(np.linalg.norm(np.cross(a, c))),
            V / float(np.linalg.norm(np.cross(a, b))))


def _wrap_tri(r, lengths, tilt):
    """Sequential (z, then y, then x) triclinic minimum image of
    ``[..., 3]`` displacements, the convention of :func:`.box.wrap_vector`
    (exact for ``|tilt| <= 0.5``). ``lengths`` and ``tilt`` are ``[3]``
    tensors (or host sequences), in the JAX form's order of operations."""
    dtype = r.dtype
    Lx, Ly, Lz = (torch.as_tensor(v, dtype=dtype, device=r.device)
                  for v in lengths)
    xy, xz, yz = (torch.as_tensor(t, dtype=dtype, device=r.device)
                  for t in tilt)
    rx, ry, rz = r[..., 0], r[..., 1], r[..., 2]
    iz = torch.round(rz / Lz)
    rx = rx - iz * xz * Lz
    ry = ry - iz * yz * Lz
    rz = rz - iz * Lz
    iy = torch.round(ry / Ly)
    rx = rx - iy * xy * Ly
    ry = ry - iy * Ly
    rx = rx - torch.round(rx / Lx) * Lx
    return torch.stack([rx, ry, rz], dim=-1)


@dataclasses.dataclass(frozen=True)
class CellwisePlan:
    """Static geometry of the slot-resident layout.

    :param grid: cells per axis ``(nx, ny, nz)``.
    :param capacity: slots per cell.
    :param lengths: box lengths ``(Lx, Ly, Lz)`` at planning time.
    :param r_cut: cutoff radius the planes are exact for.
    :param tilt: tilt factors ``(xy, xz, yz)`` (all zero: orthorhombic);
        cells are a regular grid in fractional space.
    """
    grid: tuple
    capacity: int
    lengths: tuple
    r_cut: float
    tilt: tuple = (0.0, 0.0, 0.0)

    @property
    def n_cells(self):
        nx, ny, nz = self.grid
        return nx * ny * nz

    @property
    def n_slots(self):
        return self.n_cells * self.capacity

    @property
    def width(self):
        """Full-stencil candidate width ``27 * capacity``."""
        return 27 * self.capacity

    @property
    def edges(self):
        return tuple(L / d for L, d in zip(self.lengths, self.grid))

    @property
    def tilted(self):
        return any(self.tilt)

    @property
    def perp_cell_widths(self):
        """Per-axis perpendicular width of one cell layer, the quantity
        the stencil criterion bounds (``edges`` with zero tilt)."""
        if not self.tilted:
            return self.edges
        return tuple(w / d for w, d in
                     zip(_perp_widths(self.lengths, self.tilt), self.grid))

    @property
    def skin(self):
        """Verlet margin: the slot assignment stays valid while the
        largest displacement since the last repack is below skin / 2."""
        return min(self.perp_cell_widths) - self.r_cut


def _measured_occupancy(positions, lo, lengths, dims, tilt=(0., 0., 0.)):
    """Max, mean and std of particles-per-cell for host positions
    (a tilted box bins by the upper-triangular cell-matrix solve)."""
    pos = np.asarray(positions)[:, :3].astype(np.float64)
    lengths = np.asarray(lengths, dtype=np.float64)
    r = pos - np.asarray(lo)
    if any(tilt):
        xy, xz, yz = (float(v) for v in tilt)
        fz = r[:, 2] / lengths[2]
        fy = (r[:, 1] - yz * lengths[2] * fz) / lengths[1]
        fx = (r[:, 0] - xy * lengths[1] * fy - xz * lengths[2] * fz) \
            / lengths[0]
        frac = np.stack([fx, fy, fz], axis=-1)
    else:
        frac = r / lengths
    frac = frac - np.floor(frac)
    dims = np.asarray(dims)
    xyz = np.minimum((frac * dims).astype(np.int64), dims - 1)
    cid = xyz[:, 0] + dims[0] * (xyz[:, 1] + dims[1] * xyz[:, 2])
    counts = np.bincount(cid, minlength=int(np.prod(dims)))
    return int(counts.max()), float(counts.mean()), float(counts.std())


# Planner cost constants, ported unchanged from the JAX package so the
# port plans the same grid and capacity on the same inputs. They are
# TPU v5e calibrations (per padded lane of the 27-wide XLA form and the
# 14-wide Pallas kernel, per repacked slot, per scan segment) and the
# (8, 128) padding below is the TPU tile: all of it is still to be
# re-measured on the H100 (ROADMAP.md Queue 2, K1 follow-ups).
_PAIR_LANE_COST = 14e-12
_PAIR_LANE_COST_PALLAS = 3e-12
_REPACK_SLOT_COST = 14e-9
_SEGMENT_FIXED_COST = 2e-3


def _pad_to(x, m):
    return -(-x // m) * m


def _snap_free_capacity(cap, width_blocks):
    """Largest capacity with the same padded lane cost as ``cap``."""
    s8, s128 = _pad_to(cap, 8), _pad_to(width_blocks * cap, 128)
    c = int(cap)
    while (c + 1 <= s8 and
           _pad_to(width_blocks * (c + 1), 128) == s128):
        c += 1
    return c


def plan_cellwise(n, box_lengths, r_cut, config=None, positions=None,
                  lo=None, drift_per_step=None, z_divisor=1, width_blocks=27,
                  occ_observed=None, lane_cost_scale=1.0,
                  tilt=(0.0, 0.0, 0.0)):
    """Choose ``(grid, capacity)`` minimizing the modelled per-step cost
    (pair lanes plus amortized repack). Same algorithm and arguments as
    the JAX ``plan_cellwise``; a tilted box is gridded by its
    perpendicular widths.

    :param z_divisor: force ``nz`` to a multiple of this: a mesh of that
        many shards splits the z-major slot order into equal z-slabs
        (:func:`analytic_pair_forces` with ``mesh=``).
    :param width_blocks: 14 when the half-stencil kernel is the hot
        loop, 27 for the full-stencil tensor form.
    :returns: a :class:`CellwisePlan`, or ``None`` if no grid with >= 3
        cells per axis exists.
    """
    config = config if isinstance(config, CellList) else CellList()
    lengths = np.asarray(box_lengths, dtype=np.float64)
    tilt = tuple(float(t) for t in tilt)
    if lo is None:
        lo = -lengths / 2.0
    min_edge = r_cut + max(config.skin, 0.0)
    widths = (np.asarray(_perp_widths(lengths, tilt)) if any(tilt)
              else lengths)
    best = None
    for scale in np.linspace(1.0, 1.8, 9):
        dims = [int(math.floor(W / (min_edge * scale))) for W in widths]
        if z_divisor > 1:
            dims[2] = (dims[2] // z_divisor) * z_divisor
        dims = tuple(dims)
        if any(d < 3 for d in dims):
            continue
        edges = [W / d for W, d in zip(widths, dims)]
        if min(edges) < min_edge:
            continue
        n_cells_d = float(np.prod(dims))
        mean = n / n_cells_d
        # capacity must cover the RUNNING max over a run (~100 repack
        # snapshots per 1000 steps), near-Poisson variance
        c = math.sqrt(2.0 * math.log(max(n_cells_d, 2.0) * 100.0))
        est = int(math.ceil(mean + c * math.sqrt(0.9 * max(mean, 1.0))))
        if occ_observed is not None:
            cal_grid, cal_occ = occ_observed
            cal_mean = n / float(np.prod(cal_grid))
            excess = max(float(cal_occ) - cal_mean, 0.0)
            est_obs = int(math.ceil(
                mean + excess * math.sqrt(mean / max(cal_mean, 1e-9)))) + 2
            est = min(est, est_obs)
        if config.capacity is not None:
            cap = int(config.capacity)
        elif positions is not None:
            occ_max, _, _ = _measured_occupancy(positions, lo, lengths,
                                                dims, tilt=tilt)
            cap = (max(occ_max + 1, est) if occ_observed is not None
                   else max(occ_max, est) + 3)
            cap = _snap_free_capacity(cap, width_blocks)
        elif occ_observed is not None:
            cap = _snap_free_capacity(est, width_blocks)
        else:
            cap = _snap_free_capacity(est + 4, width_blocks)
        n_cells = int(np.prod(dims))
        skin = min(edges) - r_cut
        lane_cost = (_PAIR_LANE_COST_PALLAS if width_blocks == 14
                     else _PAIR_LANE_COST)
        cost = (n_cells * _pad_to(cap, 8) *
                _pad_to(width_blocks * cap, 128) * lane_cost *
                lane_cost_scale)
        if drift_per_step and drift_per_step > 0:
            interval = max(1.0, (skin * 0.98 / 2.0) / drift_per_step)
            cost += (n_cells * cap * _REPACK_SLOT_COST +
                     _SEGMENT_FIXED_COST) / interval
        key = (cost, -skin)
        if best is None or key < best[0]:
            best = (key, CellwisePlan(
                grid=dims, capacity=cap,
                lengths=tuple(float(L) for L in lengths),
                r_cut=float(r_cut), tilt=tilt))
    return best[1] if best else None


def _box_terms(box, dims):
    """``(lo, L, e, tilt)``: the ``[3]`` terms every geometric quantity
    derives from, in the box's dtype, ``L = high - low`` and the cell edge
    ``e = L / grid`` (the order the kernels' staging repeats, with the
    ``_rn`` intrinsics of that type)."""
    L = box[1] - box[0]
    return box[0], L, L / dims, box[2]


def _cell_centers(cells, lo, e, tilt, tilted):
    """Cartesian centers of the cells at integer coordinates ``cells``
    (float ``[..., 3]``): the fractional center ``(c + 0.5) * e`` through
    the box matrix, left to right."""
    f = (cells + 0.5) * e
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    if tilted:
        xy, xz, yz = tilt[0], tilt[1], tilt[2]
        return torch.stack([lo[0] + fx + xy * fy + xz * fz,
                            lo[1] + fy + yz * fz, lo[2] + fz], dim=-1)
    return torch.stack([lo[0] + fx, lo[1] + fy, lo[2] + fz], dim=-1)


def _stencil_offsets(ioffs, e, tilt, tilted):
    """``[n_offs, 3]`` Cartesian offsets of integer cell offsets ``ioffs``
    (float): ``o = ioffs * e`` through the box matrix."""
    o = ioffs * e
    if tilted:
        xy, xz, yz = tilt[0], tilt[1], tilt[2]
        return torch.stack([o[:, 0] + xy * o[:, 1] + xz * o[:, 2],
                            o[:, 1] + yz * o[:, 2], o[:, 2]], dim=-1)
    return o


class SlotGeometry:
    """Device-resident geometry of one plan at one box: the box tensor
    ``[3, 3]`` the kernels read, and what the tensor forms derive from it
    in ``dtype`` (the state's) -- corner, lengths, cell edges, tilt, the
    ghost parking spots (``centers``) and the per-lane stencil offsets --
    plus the box-free in-cell slot ranks. Built once per static layout, so
    the hot loop never copies a host constant to the device (each such
    copy is a host sync); a dynamic-box layout makes one per box with
    :meth:`at`.

    :param dtype: float32 or float64 (default: the box tensor's when one
        is given, else float32).
    :param box: the ``[3, 3]`` box (default: the plan's, rows ``lo``,
        ``lo + lengths`` and the plan's tilt; ``lo`` centers it by
        default).
    """

    def __init__(self, plan, lo=None, dtype=None, device=None,
                 box=None, base=None):
        self.plan = plan
        if dtype is None:
            dtype = torch.float32 if box is None else box.dtype
        self.dtype = dtype
        if base is not None:
            self.device = base.device
            self.dims, self.dims_i = base.dims, base.dims_i
            self._consts = base._consts
        else:
            self.device = resolve_device(device, "SlotGeometry")
            kw = dict(dtype=dtype, device=self.device)
            self.dims = torch.as_tensor(plan.grid, **kw)
            self.dims_i = torch.as_tensor(plan.grid, dtype=torch.int32,
                                          device=self.device)
            # integer stencil offsets and the box-free per-slot constants
            # (whole grid: '_cells', 'rank'; a z-slab's: '_slab_cells')
            # on the device, shared by the geometries of every box, each
            # made at its first use (a mesh shard's copy never makes the
            # whole grid's)
            self._consts = {}
        if box is None:
            L = np.asarray(plan.lengths, np.float64)
            lo = -L / 2.0 if lo is None else np.asarray(lo, np.float64)
            box = torch.as_tensor(
                np.stack([lo, lo + L, np.asarray(plan.tilt, np.float64)]),
                dtype=dtype, device=self.device)
        self.box = box.to(dtype).contiguous()
        self.tilted = plan.tilted
        self.lo, self.lengths, self.edges, self.tilt = _box_terms(
            self.box, self.dims)
        self._centers = None
        self._offs = {}
        self._slab_centers = {}
        # the geometry this one was made from by at() (a dynamic box's)
        self._base = base
        # copies on a mesh's other devices (on())
        self._on = {}

    def _const(self, key, make):
        """A box-free device constant, made once and shared with the
        geometries of every box (:meth:`at`)."""
        if key not in self._consts:
            self._consts[key] = make()
        return self._consts[key]

    @property
    def _cells(self):
        """``[n_slots, 3]`` grid coordinates of every slot's cell."""
        def make():
            nx, ny, _ = self.plan.grid
            cell = (torch.arange(self.plan.n_slots, device=self.device) //
                    self.plan.capacity)
            return torch.stack([cell % nx, (cell // nx) % ny,
                                cell // (nx * ny)], dim=-1).to(self.dtype)
        return self._const("cells", make)

    @property
    def rank(self):
        """``[n_slots]`` in-cell rank of every slot."""
        return self._const("rank", lambda: (
            torch.arange(self.plan.n_slots, device=self.device) %
            self.plan.capacity).to(self.dtype))

    def _slab_cells(self, z0, nzl):
        """``[(nzl + 1) nx ny cap, 3]`` global grid coordinates of the
        cells of a z-slab buffer's rows (:func:`slab_rows`)."""
        def make():
            nx, ny, nz = self.plan.grid
            cell = torch.arange((nzl + 1) * nx * ny, device=self.device)
            ijk = torch.stack([cell % nx, (cell // nx) % ny,
                               (z0 + cell // (nx * ny)) % nz], dim=-1)
            return torch.repeat_interleave(
                ijk, self.plan.capacity, dim=0).to(self.dtype)
        return self._const(("slab", z0, nzl), make)

    def slab_centers(self, z0, nzl):
        """``[(nzl + 1) nx ny cap, 3]`` cell centers of a z-slab buffer's
        rows (home layers, then the forward halo layer): the ghost parking
        spots of a shard's resident rows, at their global cells."""
        key = (z0, nzl)
        if key not in self._slab_centers:
            self._slab_centers[key] = _cell_centers(
                self._slab_cells(z0, nzl), self.lo, self.edges, self.tilt,
                self.tilted)
        return self._slab_centers[key]

    def at(self, box):
        """This plan's geometry at another box (same grid and capacity)."""
        return SlotGeometry(self.plan, dtype=self.dtype, box=box, base=self)

    def on(self, device):
        """This geometry on ``device`` (itself when it is there already):
        a mesh shard's copy, made once, its box copied device to device.
        A dynamic box's geometry (made by :meth:`at`) is its base's copy
        at the copied box, so a barostat's step copies no host constant
        to a shard."""
        device = torch.device(device)
        if device == self.device:
            return self
        key = str(device)
        if key not in self._on:
            box = to_device(self.box, device)
            self._on[key] = (
                SlotGeometry(self.plan, dtype=self.dtype, device=device,
                             box=box) if self._base is None else
                self._base.on(device).at(box))
        return self._on[key]

    @property
    def centers(self):
        """``[n_slots, 3]`` cell centers, the ghost parking spots."""
        if self._centers is None:
            self._centers = _cell_centers(self._cells, self.lo, self.edges,
                                          self.tilt, self.tilted)
        return self._centers

    def wrap(self, d):
        """Minimum image of ``[..., 3]`` displacements in this box."""
        if self.tilted:
            return _wrap_tri(d, self.lengths, self.tilt)
        return d - torch.round(d / self.lengths) * self.lengths

    def offsets(self, offs_list):
        """``[3, n_offs * cap]`` per-lane Cartesian stencil offsets."""
        key = tuple(offs_list)
        if key not in self._offs:
            ioffs = self._const(key, lambda: torch.as_tensor(
                np.asarray(offs_list, np.float64), dtype=self.dtype,
                device=self.device))
            o = _stencil_offsets(ioffs, self.edges, self.tilt,
                                 self.tilted)
            self._offs[key] = torch.repeat_interleave(
                o.T.contiguous(), self.plan.capacity, dim=1)
        return self._offs[key]


def _as_geometry(plan, lo, like, geometry):
    if geometry is not None:
        return geometry
    return SlotGeometry(plan, lo, like.dtype, like.device)


def slot_cell_centers(plan, lo, dtype=torch.float32, device=None):
    """``[n_slots, 3]`` cell-center coordinates -- the parking spot for
    ghost slots."""
    return SlotGeometry(plan, lo, dtype,
                        resolve_device(device, "slot_cell_centers")).centers


def _fractional(pos3, g):
    """Fractional coordinates of ``pos3`` in ``g``'s box, not yet reduced
    ``mod 1`` (the upper-triangular solve when tilted, in the JAX form's
    order)."""
    r = pos3 - g.lo
    L = g.lengths
    if not g.tilted:
        return r / L
    xy, xz, yz = g.tilt[0], g.tilt[1], g.tilt[2]
    fz = r[:, 2] / L[2]
    fy = (r[:, 1] - yz * L[2] * fz) / L[1]
    fx = (r[:, 0] - xy * L[1] * fy - xz * L[2] * fz) / L[0]
    return torch.stack([fx, fy, fz], dim=-1)


def bin_cells(pos3, lo, plan, geometry=None):
    """Flat int32 cell id per row (x-minor / z-major, matching the
    ``[nz, ny, nx, cap]`` slot view)."""
    g = _as_geometry(plan, lo, pos3, geometry)
    frac = _fractional(pos3, g)
    frac = frac - torch.floor(frac)
    xyz = torch.minimum((frac * g.dims).to(torch.int32), g.dims_i - 1)
    nx, ny, _ = plan.grid
    return xyz[:, 0] + nx * (xyz[:, 1] + ny * xyz[:, 2])


def _roll_offs(plane, plan, offs_list):
    """``[n_slots]`` plane -> ``[n_cells, len(offs) * cap]`` candidate
    rows: block ``k`` of cell ``c`` holds the slots of cell
    ``c + offs[k]`` (a roll by ``-off`` gathers them)."""
    nx, ny, nz = plan.grid
    cap = plan.capacity
    a = plane.reshape(nz, ny, nx, cap)
    outs = [torch.roll(a, shifts=(-oz, -oy, -ox), dims=(0, 1, 2))
            for (ox, oy, oz) in offs_list]
    return torch.stack(outs, dim=3).reshape(plan.n_cells,
                                            len(offs_list) * cap)


def _roll_back(block, plan, off):
    """Push a ``[n_cells, cap]`` per-candidate partial (computed at cell
    ``c`` for the slots of cell ``c + off``) onto the rows of cell
    ``c + off``: the inverse roll (``+off``) of the candidate gather."""
    ox, oy, oz = off
    nx, ny, nz = plan.grid
    a = block.reshape(nz, ny, nx, plan.capacity)
    return torch.roll(a, shifts=(oz, oy, ox), dims=(0, 1, 2)).reshape(
        plan.n_cells, plan.capacity)


def cellwise_planes(positions, types, valid, plan, rcut_matrix=None,
                    cells=None, box=None):
    """Masked 27-block candidate planes of slot-resident state (the
    JAX ``cellwise_planes``): the planes route a generic SimModel takes
    on ``'cellwise'`` when the lane-separability probe rejects it.

    :param positions: ``[n_slots, 3]`` slot positions (ghosts at centers).
    :param types: ``[n_slots]`` integer types (ghosts 0).
    :param valid: ``[n_slots]`` 1.0 for real rows, 0.0 for ghosts.
    :param rcut_matrix: ``[T, T]`` squared per-type cutoffs
        (:func:`rc2_table`), or ``None``.
    :param cells: ``(c0, c1)``: the planes of the rows of cells
        ``c0 .. c1 - 1`` only (all cells by default).
    :param box: the ``[3, 3]`` box tensor on the positions' device
        (default: the plan's lengths and tilt, copied from the host).
    :returns: :class:`.direct.NlistPlanes` of ``[rows, 27 * cap]``
        components; ghost rows and ghost candidates are exactly zero.
    """
    from .direct import NlistPlanes
    dtype = positions.dtype
    cap, C = plan.capacity, plan.width
    c0, c1 = cells if cells is not None else (0, plan.n_cells)
    m = c1 - c0
    rc2 = plan.r_cut * plan.r_cut
    tt = types.to(dtype)
    rows = slice(c0 * cap, c1 * cap)
    if box is not None:
        lengths, tilt = box[1] - box[0], box[2]
    else:
        lengths = torch.as_tensor(plan.lengths, dtype=dtype,
                                  device=positions.device)
        tilt = plan.tilt

    def cand(plane):
        return _roll_offs(plane, plan, _OFFS)[c0:c1].reshape(m, 1, C)

    dd = [cand(positions[:, a]) - positions[rows, a].reshape(m, cap, 1)
          for a in range(3)]
    if plan.tilted:
        dd = _wrap_tri(torch.stack(dd, dim=-1), lengths, tilt).unbind(-1)
    else:
        dd = [d - torch.round(d / lengths[a]) * lengths[a]
              for a, d in enumerate(dd)]
    d2 = dd[0] * dd[0] + dd[1] * dd[1] + dd[2] * dd[2]
    ok = ((d2 <= rc2) & (d2 >= 25e-8) & (cand(valid) > 0) &
          (valid[rows].reshape(m, cap, 1) > 0))
    gt = cand(tt)
    if rcut_matrix is not None:
        ok = ok & (d2 <= pair_rc2(tt[rows].reshape(m, cap, 1), gt,
                                  rcut_matrix))
    zero = torch.zeros((), dtype=dtype, device=positions.device)
    return NlistPlanes(*(torch.where(ok, v, zero).reshape(m * cap, C)
                         for v in (dd[0], dd[1], dd[2], gt)))


def sharded_planes(positions, types, valid, plan, mesh, boxes,
                   shard_axis=None, rcut_matrix=None):
    """:func:`cellwise_planes` of every cell of a slot state resident per
    z-slab shard of ``mesh`` (:class:`..md.slots.SlabSlots`): each shard
    builds the planes of its home cells on its device, and they are joined
    in global slot order on the first shard's device, equal to the
    unsharded planes bit for bit (the same operations on the same values).
    The full 27-cell stencil reaches ``z - 1`` as well as ``z + 1``, so a
    shard's planes read a buffer of the previous shard's last home layer,
    its own home layers and the next shard's first home layer, each copied
    only when that shard lies on another device (a shard's own halo rows
    are not read: between repacks they hold the positions of the last halo
    exchange).

    :param positions, types, valid: each shard's buffer, in shard order
        (:func:`resident_pair_forces`'); only its home rows are read.
    :param boxes: each shard's ``[3, 3]`` box tensor on its device.
    :param rcut_matrix: a :func:`rc2_table` tensor, or ``None``."""
    from .direct import NlistPlanes
    nx, ny, _ = plan.grid
    L = halo_layer(plan)
    slabs = mesh_slabs(plan, mesh, shard_axis)
    S = len(slabs)
    primary = positions[0].device
    parts = []
    for s, (dev, z0, nzl) in enumerate(slabs):
        nzp = slabs[(s - 1) % S][2]
        buf = [torch.cat([to_device(t[(s - 1) % S][(nzp - 1) * L:nzp * L],
                                    dev), t[s][:nzl * L],
                          to_device(t[(s + 1) % S][:L], dev)])
               for t in (positions, types, valid)]
        bp = dataclasses.replace(plan, grid=(nx, ny, nzl + 2))
        rc = None if rcut_matrix is None else to_device(rcut_matrix, dev)
        pl = cellwise_planes(*buf, bp, rcut_matrix=rc,
                             cells=(nx * ny, (nzl + 1) * nx * ny),
                             box=boxes[s])
        parts.append(pl.map(lambda c: to_device(c, primary)))
    return NlistPlanes(*(torch.cat(cs) for cs in zip(*parts)))


def _relative_coords(positions, valid, plan, lo, offs_list, geometry=None):
    """Cell-relative coordinates (ghosts pushed FAR along x, a distinct
    distance per in-cell rank) and the per-direction candidate planes
    with the stencil offsets pre-added, so displacements need no
    min-image rounding. Everything geometric comes from ``geometry``'s
    box (the kernels' staging repeats these operations, float32 or
    float64, in this order: ``q = wrap(p - center) + offset``)."""
    g = _as_geometry(plan, lo, positions, geometry)
    FAR = 4.0 * float(max(plan.lengths))
    q = g.wrap(positions - g.centers)
    # rank-scaled FAR: a uniform push would put co-resident ghosts at
    # d2 = 0, where a steep pair function overflows to inf and inf * 0
    # poisons ghost rows with NaN
    qx = q[:, 0] + (1.0 - valid) * FAR * (1.0 + g.rank)
    qy, qz = q[:, 1], q[:, 2]
    off = g.offsets(offs_list)
    gx = _roll_offs(qx, plan, offs_list) + off[0]
    gy = _roll_offs(qy, plan, offs_list) + off[1]
    gz = _roll_offs(qz, plan, offs_list) + off[2]
    return qx, qy, qz, gx, gy, gz


def rc2_table(rcut_matrix, dtype=torch.float32, device=None):
    """``[T, T]`` squared per-pair cutoffs from an ``[ntypes, ntypes]``
    cutoff matrix; a negative entry (never neighbors) maps to ``-1``."""
    m = np.asarray(rcut_matrix, dtype=np.float64)
    return torch.as_tensor(np.where(m < 0, -1.0, m * m), dtype=dtype,
                           device=resolve_device(device, "rc2_table"))


def pair_rc2(ti, tj, table):
    """Per-lane squared cutoff from :func:`rc2_table`; type ids outside
    the table get 0, as the JAX ``pair_rc2`` mask sum does."""
    T = table.shape[0]
    ti = ti.long()
    tj = tj.long()
    inside = (ti >= 0) & (ti < T) & (tj >= 0) & (tj < T)
    v = table[ti.clamp(0, T - 1), tj.clamp(0, T - 1)]
    return torch.where(inside, v, torch.zeros_like(v))


# channel coefficients of the dual reductions: (row side, candidate side)
_E_COEF = (0.5, 0.5)
_F_COEF = (2.0, -2.0)
_W_COEF = (-1.0, -1.0)


def _channel_coefs(needs_energy, needs_virial):
    return (([_E_COEF] if needs_energy else []) + [_F_COEF] * 3 +
            ([_W_COEF] * 6 if needs_virial else []))


def lane_sums(qx, qy, qz, gx, gy, gz, ti, tj, pair_fn, cap, rc2, min_r2,
              self_col0, needs_energy, needs_virial, rc2_tab=None,
              want_cols=True, typed_fn=True,
              chunk_elems=1 << 24):
    """Pair lanes of every cell's ``cap`` rows against its ``C``-wide
    candidate plane, reduced both ways.

    Channels, in order: energy ``U`` (if ``needs_energy``), ``s*dx``,
    ``s*dy``, ``s*dz``, then (if ``needs_virial``) ``s*dx*dx``,
    ``s*dy*dy``, ``s*dz*dz``, ``s*dx*dy``, ``s*dx*dz``, ``s*dy*dz``, with
    ``s`` the masked slope ``dU/dr2``.

    :param qx, qy, qz: ``[n_cells, cap]`` row coordinates.
    :param gx, gy, gz: ``[n_cells, C]`` candidate coordinates.
    :param ti, tj: ``[n_cells, cap]`` / ``[n_cells, C]`` row and
        candidate types (``None`` when neither the cutoff table nor the
        pair function reads them).
    :param typed_fn: call ``pair_fn(r2, ti, tj)`` rather than
        ``pair_fn(r2)``.
    :param self_col0: candidate column of row 0's own slot (0 for the
        half stencil's block 0, ``13 * cap`` for the full stencil).
    :returns: ``(rows [nch, n_cells, cap], cols [nch, n_cells, C] or
        None)`` -- the unweighted row-side and candidate-side sums.
    """
    n_cells, C = gx.shape
    dev = gx.device
    row = torch.arange(cap, device=dev)[:, None]
    col = torch.arange(C, device=dev)[None, :]
    not_self = (col != self_col0 + row)[None]
    step = max(1, chunk_elems // max(1, cap * C))
    rows_out, cols_out = [], []
    for a in range(0, n_cells, step):
        b = min(n_cells, a + step)
        dx = gx[a:b, None, :] - qx[a:b, :, None]
        dy = gy[a:b, None, :] - qy[a:b, :, None]
        dz = gz[a:b, None, :] - qz[a:b, :, None]
        d2 = dx * dx + dy * dy + dz * dz
        ok = (d2 <= rc2) & not_self
        tia = tja = None
        if ti is not None:
            tia, tja = ti[a:b, :, None], tj[a:b, None, :]
        if rc2_tab is not None:
            ok = ok & (d2 <= pair_rc2(tia, tja, rc2_tab))
        r2 = torch.clamp_min(d2, min_r2)
        U, dU = pair_fn(r2, tia, tja) if typed_fn else pair_fn(r2)
        zero = torch.zeros((), dtype=d2.dtype, device=dev)
        s = torch.where(ok, dU, zero)
        prods = []
        if needs_energy:
            prods.append(torch.where(ok, U, zero))
        sdx, sdy, sdz = s * dx, s * dy, s * dz
        prods += [sdx, sdy, sdz]
        if needs_virial:
            prods += [sdx * dx, sdy * dy, sdz * dz,
                      sdx * dy, sdx * dz, sdy * dz]
        rows_out.append(torch.stack([p.sum(dim=2) for p in prods]))
        if want_cols:
            cols_out.append(torch.stack([p.sum(dim=1) for p in prods]))
    rows = torch.cat(rows_out, dim=1)
    cols = torch.cat(cols_out, dim=1) if want_cols else None
    return rows, cols


def assemble_half(planes, plan):
    """``[nch, n_cells, 14 * cap]`` half-stencil planes (block 0 = row
    side, blocks 1..13 = weighted candidate side) -> ``[nch, n_slots]``:
    the 13 inverse rolls (by ``+off``) push each candidate block onto its
    home cell."""
    nx, ny, nz = plan.grid
    cap = plan.capacity
    nch = planes.shape[0]
    a = planes.reshape(nch, nz, ny, nx, len(_HALF_OFFS), cap)
    acc = a[..., 0, :]
    for t in range(1, len(_HALF_OFFS)):
        ox, oy, oz = _HALF_OFFS[t]
        acc = acc + torch.roll(a[..., t, :], shifts=(oz, oy, ox),
                               dims=(1, 2, 3))
    return acc.reshape(nch, -1)


def finish_forces(chans, valid, needs_energy, needs_virial):
    """``[nch, n_slots]`` summed channels -> ``(forces4, virial)`` with
    ghost rows zeroed."""
    n = valid.shape[0]
    oi = 1 if needs_energy else 0
    e = chans[0] if needs_energy else torch.zeros(
        n, dtype=chans.dtype, device=chans.device)
    forces4 = torch.stack([chans[oi], chans[oi + 1], chans[oi + 2], e],
                          dim=-1) * valid[:, None]
    virial = None
    if needs_virial:
        wxx, wyy, wzz, wxy, wxz, wyz = chans[oi + 3:oi + 9]
        W = torch.stack([torch.stack([wxx, wxy, wxz], -1),
                         torch.stack([wxy, wyy, wyz], -1),
                         torch.stack([wxz, wyz, wzz], -1)], -2)
        virial = W * valid[:, None, None]
    return forces4, virial


def slab_layers(plan, n_shards):
    """``[(z0, nzl), ...]``: the z-layers of each of ``n_shards`` equal
    z-slabs of ``plan``'s grid (the slot order is z-major, so each slab is
    a contiguous block of slot rows). Raises unless ``nz`` divides."""
    nz = plan.grid[2]
    if nz % n_shards:
        raise ValueError(
            f"{nz} z-layers of cells are not divisible by the {n_shards}-"
            f"shard mesh (plan with z_divisor={n_shards})")
    nzl = nz // n_shards
    return [(s * nzl, nzl) for s in range(n_shards)]


def slab_rows(plan, z0, nzl):
    """The slot rows of a slab buffer: the home layers ``z0 .. z0 + nzl -
    1`` then the forward halo layer ``(z0 + nzl) % nz``, as two
    ``slice``s of the z-major slot order."""
    nx, ny, nz = plan.grid
    layer = nx * ny * plan.capacity
    z1 = (z0 + nzl) % nz
    return (slice(z0 * layer, (z0 + nzl) * layer),
            slice(z1 * layer, (z1 + 1) * layer))


def _slab_plan(plan, nzl):
    """The plan of a slab buffer's ``nzl + 1`` layers (for the rolls of
    the tensor form; its geometry stays the global plan's)."""
    nx, ny, _ = plan.grid
    return dataclasses.replace(plan, grid=(nx, ny, nzl + 1))


def slab_buffer(t, plan, z0, nzl, device=None):
    """The rows of the slot-ordered ``t`` a z-slab shard reads: its home
    layers ``z0 .. z0 + nzl - 1``, then the forward halo layer ``(z0 +
    nzl) % nz`` (:func:`slab_rows`), on ``device`` when given. The state's
    columns are cut so for the forward; the forces' cotangent ``ct`` is
    cut so for the backward, where a halo row carries the cotangent of
    the next shard's first home layer, the rows its reverse halo was added
    to."""
    a, b = slab_rows(plan, z0, nzl)
    # home and halo layers are adjacent rows but for the last shard's,
    # whose halo wraps to layer 0
    t = (t[a.start:b.stop] if a.stop == b.start else
         torch.cat([t[a], t[b]]))
    return t if device is None else to_device(t, device)


def slab_split(t, plan, slabs):
    """The slot-ordered whole ``t`` split into each z-slab shard's buffer
    (:func:`slab_buffer`: its home layers, then its forward halo layer) on
    its device, ``slabs`` :func:`mesh_slabs`' ``(device, z0, nzl)``; each
    buffer a copy, so a halo exchange into it leaves ``t`` as it is."""
    out = []
    for dev, z0, nzl in slabs:
        a, b = slab_rows(plan, z0, nzl)
        out.append(to_device(torch.cat([t[a], t[b]]), dev))
    return out


def slab_join(ts, plan, slabs, device):
    """The inverse of :func:`slab_split` for outputs: each shard's home
    rows of ``ts`` joined in global slot order on ``device``."""
    L = halo_layer(plan)
    return torch.cat([to_device(t[:nzl * L], device)
                      for t, (_, _, nzl) in zip(ts, slabs)])


def mesh_slabs(plan, mesh, shard_axis=None):
    """``[(device, z0, nzl), ...]``: each shard of ``mesh``'s axis
    ``shard_axis`` (default its first) with its z-slab of ``plan``
    (:func:`slab_layers`)."""
    axis = shard_axis or mesh.axis_names[0]
    return [(torch.device(mesh.devices[s]), z0, nzl) for s, (z0, nzl) in
            enumerate(slab_layers(plan, mesh.shape[axis]))]


def _slab_relative_coords(positions, valid, plan, lo, z0, nzl,
                          geometry=None):
    """:func:`_relative_coords` of a slab buffer's rows (:func:`slab_rows`):
    ``(bp, qx, qy, qz, gx, gy, gz)``, ``bp`` the plan of the buffer's
    ``nzl + 1`` layers (:func:`_slab_plan`, for rolls), ``q*`` over every
    buffer row and the candidate planes ``g*`` of the ``nzl * nx * ny``
    home cells only. Each slot's cell center and stencil offset come from
    its *global* cell and ``geometry``'s box, so every value equals the
    unsharded form's at that slot."""
    nx, ny, nz = plan.grid
    if not 1 <= nzl < nz:
        raise ValueError(f"a slab of {nzl} layers in a grid of {nz}")
    cap = plan.capacity
    bp = _slab_plan(plan, nzl)
    n_home = nzl * nx * ny
    if positions.shape[0] != bp.n_slots:
        raise ValueError(f"a slab buffer of {nzl} + 1 layers holds "
                         f"{bp.n_slots} rows, got {positions.shape[0]}")
    g = _as_geometry(plan, lo, positions, geometry)
    dtype, dev = positions.dtype, positions.device
    # the buffer's cells at their global grid coordinates
    centers = g.slab_centers(z0, nzl)
    rank = (torch.arange(bp.n_slots, device=dev) % cap).to(dtype)
    FAR = 4.0 * float(max(plan.lengths))
    q = g.wrap(positions - centers)
    qx = q[:, 0] + (1.0 - valid) * FAR * (1.0 + rank)
    qy, qz = q[:, 1], q[:, 2]
    off = g.offsets(_HALF_OFFS)
    gx, gy, gz = (_roll_offs(c, bp, _HALF_OFFS)[:n_home] + off[a]
                  for a, c in enumerate((qx, qy, qz)))
    return bp, qx, qy, qz, gx, gy, gz


def half_frame(positions, valid, plan, lo, geometry=None, slab=None):
    """The half-stencil frame of a call on the whole state (``slab``
    ``None``) or on a z-slab shard's buffer (``slab = (z0, nzl)``):
    ``(roll_plan, n_home, qx, qy, qz, gx, gy, gz)``, ``roll_plan`` the plan
    whose :func:`_roll_offs` gathers a candidate plane (its first
    ``n_home`` cells are the call's home cells), ``q*`` over every row,
    ``g*`` ``[n_home, 14 cap]``."""
    if slab is None:
        return (plan, plan.n_cells) + _relative_coords(
            positions, valid, plan, lo, _HALF_OFFS, geometry)
    bp, *coords = _slab_relative_coords(positions, valid, plan, lo, *slab,
                                        geometry)
    nx, ny, _ = plan.grid
    return (bp, slab[1] * nx * ny) + tuple(coords)


def half_stencil_slab_plain(positions, types, valid, plan, lo, pair_fn, z0,
                            nzl, needs_virial=False, min_r2=1e-4,
                            with_types=False, rcut_matrix=None,
                            needs_energy=True, geometry=None):
    """Plain PyTorch version of one z-slab shard of kernel K1: the Newton
    half-stencil tensor form (``lane_sums``, ``assemble_half``,
    ``finish_forces``) over the home cells of layers ``z0 .. z0 + nzl - 1``
    of ``plan``'s grid, ``nzl < nz``.

    The inputs are the slab buffer's ``(nzl + 1) * nx * ny * cap`` rows
    (:func:`slab_rows`): the home layers, then the forward halo layer
    ``(z0 + nzl) % nz``, which is enough because the half stencil reaches
    ``z + 1`` only. Each slot's cell center and stencil offset come from
    its *global* cell and ``geometry``'s box, so the cut masks are the
    unsharded form's. The home slots get their row sums and the back sums
    of the home cells; the halo layer's slots get the back sums the last
    home layer pushes into it (the ``oz = +1`` blocks), which the caller
    adds to the next shard's first layer (the reverse halo). The back sums
    the previous shard pushes into layer ``z0`` are left out here.

    :param pair_fn: ``U(r2[, ti, tj]) -> (U, dU/dr2)`` per lane.
    :param geometry: the global plan's :class:`SlotGeometry` on the
        buffer's device.
    :returns: ``(forces4, virial or None)`` over the buffer's rows: the
        home slots finished, then the reverse-halo partial of the halo
        layer's slots (also multiplied by their ``valid``).
    """
    bp = _slab_plan(plan, nzl)
    planes = _slab_planes(positions, types, valid, plan, lo, pair_fn, z0,
                          nzl, needs_virial, min_r2, with_types, rcut_matrix,
                          needs_energy, geometry)
    # the halo layer has no home cells: zero planes, so the inverse rolls
    # push nothing from it (nor, wrapping, into layer 0)
    planes = torch.cat([planes, planes.new_zeros(
        (planes.shape[0], bp.n_cells - planes.shape[1], planes.shape[2]))],
        dim=1)
    return finish_forces(assemble_half(planes, bp), valid, needs_energy,
                         needs_virial)


def _slab_planes(positions, types, valid, plan, lo, pair_fn, z0, nzl,
                 needs_virial, min_r2, with_types, rcut_matrix, needs_energy,
                 geometry):
    """The weighted half-stencil planes ``[n_ch, nzl nx ny, 14 cap]`` of a
    z-slab buffer's home cells (:func:`half_stencil_slab_plain`'s
    arguments): block 0 the row sums times the row-side coefficients,
    blocks 1..13 the candidate sums times the candidate-side ones, before
    :func:`assemble_half` pushes them home."""
    nx, ny, _ = plan.grid
    cap = plan.capacity
    n_home = nzl * nx * ny
    dtype = positions.dtype
    bp, qx, qy, qz, gx, gy, gz = _slab_relative_coords(
        positions, valid, plan, lo, z0, nzl, geometry)
    ti = tj = None
    if with_types or rcut_matrix is not None:
        tt = types.to(dtype)
        ti = tt[:n_home * cap].reshape(n_home, cap)
        tj = _roll_offs(tt, bp, _HALF_OFFS)[:n_home]
    rows, cols = lane_sums(
        qx[:n_home * cap].reshape(n_home, cap),
        qy[:n_home * cap].reshape(n_home, cap),
        qz[:n_home * cap].reshape(n_home, cap), gx, gy, gz, ti, tj,
        pair_fn, cap, plan.r_cut ** 2, min_r2, 0, needs_energy,
        needs_virial, rc2_tab=rcut_matrix, typed_fn=with_types)
    coefs = _channel_coefs(needs_energy, needs_virial)
    out = torch.stack([rows[k] * c[0] for k, c in enumerate(coefs)])
    cols = torch.stack([cols[k] * c[1] for k, c in enumerate(coefs)])
    return torch.cat([out, cols[:, :, cap:]], dim=2)


@dataclasses.dataclass(frozen=True)
class SlabGroup:
    """The z-slab shards of a mesh that one ``device`` holds, in ring
    order: ``members`` their shard indices, ``slabs`` their ``(z0, nzl)``, and
    per member the index in the group of the shard before (``prev``) and
    after (``next``) it on the ring, ``-1`` when that shard lies on
    another device. K1's group launch reads a member's forward halo layer
    in place from its next member's first home layer and adds the back
    sums across the boundary from its previous member's raw sums
    (:func:`half_stencil_group_plain`); between devices the halo is
    exchanged as copies and adds (:func:`resident_pair_forces`)."""
    device: torch.device
    members: tuple
    slabs: tuple
    prev: tuple
    next: tuple


def slab_groups(slabs, whole=True):
    """``(SlabGroup, ...)``: the shards of ``slabs`` (:func:`mesh_slabs`'
    ``(device, z0, nzl)`` in shard order) partitioned by device, each in
    ring order, the groups in the order their devices first appear; with
    ``whole=False`` one group per shard, none linked (the per-shard
    exchange of the tensor forms). Made once per mesh and plan."""
    return _slab_groups(tuple((str(d), z0, nzl) for d, z0, nzl in slabs),
                        whole)


@functools.lru_cache(maxsize=None)
def _slab_groups(slabs, whole):
    S = len(slabs)
    by_dev = {}
    for s, (dev, _, _) in enumerate(slabs):
        by_dev.setdefault(dev if whole else s, []).append(s)
    groups = []
    for members in by_dev.values():
        at = {s: k for k, s in enumerate(members)}
        groups.append(SlabGroup(
            torch.device(slabs[members[0]][0]), tuple(members),
            tuple((slabs[s][1], slabs[s][2]) for s in members),
            tuple(at.get((s - 1) % S, -1) for s in members),
            tuple(at.get((s + 1) % S, -1) for s in members)))
    return tuple(groups)


def group_rows(t, group, k, layer):
    """Member ``k``'s buffer of ``t`` (the members' buffers in group order)
    as K1's group launch reads it: its own home rows, the forward halo
    layer taken from the next member's first home layer when that is in
    the group (a linked member's own buffer may hold its home layers
    only)."""
    n = group.next[k]
    if n < 0:
        return t[k]
    return torch.cat([t[k][:group.slabs[k][1] * layer], t[n][:layer]])


def assemble_group(planes, valid, plan, group, needs_energy, needs_virial):
    """The group home pass in tensor ops: each member's weighted planes
    (:func:`_slab_planes`) pushed home in the order ``t = 1..13`` of
    :func:`assemble_half`, a first home layer taking the back sums pushed
    across the boundary from the previous member's last home layer when
    that is in the group, then finished with the member's ``valid``. A
    member's halo rows are zero when its next member is in the group, else
    they hold the reverse-halo partial.

    :returns: ``(forces4, virial or None)``: lists over the members'
        buffer rows."""
    nx, ny, _ = plan.grid
    cells = nx * ny
    layer = cells * plan.capacity
    fs, ws = [], []
    for k, ((z0, nzl), p) in enumerate(zip(group.slabs, planes)):
        prev = group.prev[k]
        below = (planes[prev][:, (nzl - 1) * cells:] if prev >= 0 else
                 p.new_zeros((p.shape[0], cells, p.shape[2])))
        # layers: the one below, the home layers, the halo layer (no home
        # cells: zero planes); the z roll of the top into the bottom layer
        # lands on the layer below, which is dropped
        ext = torch.cat([below, p, p.new_zeros((p.shape[0], cells,
                                                p.shape[2]))], dim=1)
        acc = assemble_half(ext, _slab_plan(plan, nzl + 1))[:, cells *
                                                            plan.capacity:]
        if group.next[k] >= 0:
            acc = torch.cat([acc[:, :-layer], acc.new_zeros(
                (acc.shape[0], layer))], dim=1)
        f, w = finish_forces(acc, group_rows(valid, group, k, layer),
                             needs_energy, needs_virial)
        fs.append(f)
        ws.append(w)
    return fs, (ws if needs_virial else None)


def half_stencil_group_plain(positions, types, valid, plan, lo, pair_fn,
                             group, needs_virial=False, min_r2=1e-4,
                             with_types=False, rcut_matrix=None,
                             needs_energy=True, geometry=None):
    """Plain PyTorch version of K1's group launch over the members of
    ``group`` (a :class:`SlabGroup`) on one device: each member's
    weighted half-stencil planes on its buffer, the forward halo read in
    place from the next member's first home layer when that is in the
    group (:func:`group_rows`), then :func:`assemble_group`: the back sums
    across a boundary inside the group added in the whole state's order
    ``t = 1..13``, so no reverse halo and no halo copy within the group.

    :param positions, types, valid: the members' buffers in group order
        (``(nzl + 1) nx ny cap`` rows each, :func:`slab_rows`; a member
        whose next member is in the group may hold its home layers
        only).
    :param geometry: the global plan's :class:`SlotGeometry` on their
        device.
    :returns: ``(forces4, virial or None)``: lists over the members'
        buffer rows (``(nzl + 1) nx ny cap`` each), as
        :func:`assemble_group`.
    """
    layer = halo_layer(plan)
    planes = []
    for k, (z0, nzl) in enumerate(group.slabs):
        buf = [group_rows(t, group, k, layer)
               for t in (positions, types, valid)]
        planes.append(_slab_planes(*buf, plan, lo, pair_fn, z0, nzl,
                                   needs_virial, min_r2, with_types,
                                   rcut_matrix, needs_energy, geometry))
    return assemble_group(planes, valid, plan, group, needs_energy,
                          needs_virial)


def _check_pair_fn(form, stencil, pair_fn):
    if form is None and stencil in ("auto", "kernel") and pair_fn is None:
        raise ValueError("stencil='kernel' needs a kernel form or a pair "
                         "function (K1's generic form)")


def halo_layer(plan):
    """Slot rows of one z-layer of ``plan``'s grid: a slab buffer's
    forward halo, and the migration buffers of a resident repack."""
    nx, ny, _ = plan.grid
    return nx * ny * plan.capacity


def put_rows(dst, src):
    """Copy ``src`` into ``dst`` (rows of a shard's buffer) across
    devices: queued on a card, blocking into the host (which reads it
    next)."""
    dst.copy_(src, non_blocking=dst.device.type == "cuda")


def resident_pair_forces(positions, types, valid, plan, lo, pair_fn, mesh,
                         geometries, shard_axis=None, needs_virial=False,
                         min_r2=1e-4, with_types=False, rcut_matrix=None,
                         stencil="auto", needs_energy=True, form=None,
                         lanes=None, shard_fn=None, group_call=None):
    """:func:`analytic_pair_forces` on a slot state resident per z-slab
    shard of ``mesh`` (:class:`..md.slots.SlabSlots`): the shards are
    partitioned by device (:func:`slab_groups`), and each device makes one
    grouped call of K1 over its shards' buffers in place
    (:func:`.cellwise_cuda.half_stencil_group_forces`, or the generic
    form's :func:`.cellwise_cuda.generic_group_pair_forces`, whose pair
    function runs once on the group's joined list; their plain versions
    on the CPU). Nothing of the whole state is made.

    Within a group nothing is copied: a shard's forward halo is read in
    place from the next shard's first home layer, and the back sums across
    the boundary are added in the whole state's order. Between devices the
    halo is exchanged as copies: before the calls, a shard whose next
    shard lies on another device gets that shard's first home layer of
    positions in its halo layer (the types' and ``valid``'s halo rows
    change at a repack only, which writes them); after them, its halo-layer
    output (the reverse halo) is added into that shard's first home layer
    on its device, and its halo rows are zeroed, both out of place (a
    group's outputs may be views of one tensor, and may carry a graph:
    training's list route). The last shard's next is
    shard 0. The ``'half'`` and ``'full'`` stencils run K1's slab plain
    version per shard, every shard exchanging so.

    :param positions, types, valid: each shard's buffer, in shard order:
        ``(nzl + 1) nx ny cap`` rows on its device, its home layers then
        its forward halo layer (:func:`slab_rows`).
    :param geometries: each shard's :class:`SlotGeometry` of the global
        plan on its device.
    :param rcut_matrix: a :func:`rc2_table` tensor, or ``None``.
    :param lanes: as :func:`analytic_pair_forces`' (each shard's share of
        the generic form's list; a group's list holds its shards' shares).
    :param shard_fn: as :func:`analytic_pair_forces`'.
    :param group_call: ``group_call(bufs, group, geometry) -> forces4``, a
        device's call on its members' buffers ``bufs = (positions, types,
        valid)`` in place of K1's (training's list route,
        :func:`.cellwise_cuda.generic_group_train_forces`); no virial.
    :returns: ``(forces4, virial or None)``: lists of each shard's buffer
        rows, the halo rows zero.
    """
    axis = shard_axis or mesh.axis_names[0]
    slabs = mesh_slabs(plan, mesh, axis)
    S = len(slabs)
    if group_call is None:
        _check_pair_fn(form, stencil, pair_fn)
    if stencil not in ("auto", "kernel", "half", "full"):
        raise ValueError(f"unknown stencil {stencil!r}")
    primary = positions[0].device
    layer = halo_layer(plan)
    groups = slab_groups(slabs, whole=stencil not in ("half", "full"))
    sends = [s for g in groups for s, n in zip(g.members, g.next) if n < 0]
    for s in sends:
        put_rows(positions[s][-layer:], positions[(s + 1) % S][:layer])
    fs, ws = [None] * S, [None] * S
    for g in groups:
        m = g.members
        bufs = [[t[s] for s in m] for t in (positions, types, valid)]
        if group_call is not None:
            f, w = group_call(bufs, g, geometries[m[0]]), None
        else:
            fn = pair_fn if shard_fn is None else shard_fn(g.device)
            f, w = _group_forces(
                bufs, plan, lo, fn, g, needs_virial, min_r2, with_types,
                rcut_matrix, stencil, needs_energy, form, geometries[m[0]],
                lanes, primary)
        for k, s in enumerate(m):
            fs[s] = f[k]
            ws[s] = None if w is None else w[k]
    for t in (fs, ws if needs_virial else None):
        if t is None:
            continue
        for s in sends:
            n = (s + 1) % S
            t[n] = torch.cat([t[n][:layer] + to_device(t[s][-layer:],
                                                       t[n].device),
                              t[n][layer:]])
        for s in sends:
            t[s] = torch.cat([t[s][:-layer],
                              t[s].new_zeros(t[s][-layer:].shape)])
    return fs, (ws if needs_virial else None)


def _group_forces(bufs, plan, lo, fn, group, needs_virial, min_r2,
                  with_types, rcut_matrix, stencil, needs_energy, form, g,
                  lanes, primary):
    """One group's call (:func:`resident_pair_forces`) on its members'
    buffers ``bufs =
    (positions, types, valid)`` (lists in group order) on its device,
    ``g`` the global plan's geometry there: K1's group launch in a pair
    form, or in the generic form with ``lanes.budget`` lanes a member (its
    need recorded in ``lanes`` on ``primary``); for a ``'half'`` /
    ``'full'`` stencil K1's slab plain version on the one member of each
    group, and for a CPU group without a form and no ``'kernel'`` stencil
    the group's plain tensor form."""
    from . import cellwise_cuda as cc
    p, ty, v = bufs
    dev = group.device
    rc = None if rcut_matrix is None else to_device(rcut_matrix, dev)
    if stencil in ("half", "full"):
        f, w = half_stencil_slab_plain(
            p[0], ty[0], v[0], plan, lo, fn, *group.slabs[0], needs_virial,
            min_r2, with_types, rc, needs_energy, g)
        return [f], [w]
    if form is not None:
        return cc.half_stencil_group_forces(
            p, ty, v, plan, lo, cc.form_on(form, dev), group, needs_virial,
            min_r2, rc, needs_energy, g)
    if dev.type != "cuda" and stencil == "auto":
        return half_stencil_group_plain(p, ty, v, plan, lo, fn, group,
                                        needs_virial, min_r2, with_types, rc,
                                        needs_energy, g)
    own = None if lanes is None else cc.LaneBudget(lanes.budget, dev)
    out = cc.generic_group_pair_forces(
        p, ty, v, plan, lo, fn, group, with_types, needs_virial, min_r2, rc,
        needs_energy, g, own)
    if lanes is not None:
        lanes.record(to_device(own.needed, primary))
    return out


def analytic_pair_forces(positions, types, valid, plan, lo, pair_fn,
                         needs_virial=False, min_r2=1e-4, with_types=False,
                         rcut_matrix=None, stencil="auto",
                         needs_energy=True, form=None, geometry=None,
                         lanes=None, mesh=None, shard_axis=None,
                         shard_fn=None):
    """Forces/energy (and optionally virial) of a pair potential on
    slot-resident state -- the fast path behind
    :class:`..models.pair.PairModel`. Same contract as the JAX function.

    With a ``mesh`` of ``S > 1`` shards (:func:`..parallel.make_mesh`)
    this whole state is split into ``S`` z-slabs of ``nz / S`` layers,
    which must divide: each shard's buffer (its home layers and forward
    halo layer, :func:`slab_split`) is copied to its device, the call runs
    as :func:`resident_pair_forces` on them (one group call a device), and
    the shards' home rows are joined on the state's device. The engine's
    own runs keep their state resident per shard and call
    :func:`resident_pair_forces` directly. A one-shard mesh takes the
    unsharded call.

    :param pair_fn: ``U(r2[, ti, tj]) -> (U, dU/dr2)`` per lane (a torch
        function; used by the tensor forms).
    :param rcut_matrix: per-type-pair ``[ntypes, ntypes]`` cutoffs (numpy,
        or a precomputed :func:`rc2_table` tensor).
    :param stencil: ``'auto'`` (the hand-written half-stencil kernel K1
        on a CUDA tensor, the ``'full'`` tensor form on a CPU tensor),
        ``'kernel'`` (the K1 wrappers: the kernel on CUDA, its plain
        version on CPU), ``'half'`` (Newton half stencil in tensor ops)
        or ``'full'`` (27 blocks, both sides evaluated independently).
    :param form: the pair form the kernel evaluates in place of
        ``pair_fn`` (:class:`.cellwise_cuda.LJForm` or ``ChebForm``);
        without one, ``'kernel'`` runs K1's generic form on ``pair_fn``
        (:func:`.cellwise_cuda.generic_pair_forces`).
    :param geometry: precomputed :class:`SlotGeometry` of the plan.
    :param lanes: the generic form's :class:`.cellwise_cuda.LaneBudget`
        (under a mesh: each shard's list holds ``lanes.budget`` lanes, and
        the most any shard needed is recorded in it).
    :param mesh: a :class:`..parallel.mesh.Mesh` (or ``None``).
    :param shard_axis: the mesh axis of the shards (default its only one).
    :param shard_fn: ``device -> pair_fn`` for a shard on another device
        than the state (default: ``pair_fn`` itself).
    :returns: ``(forces4 [n_slots, 4], virial [n_slots, 3, 3] or None)``
        with the per-particle energy in force column 4 (zero when
        ``needs_energy`` is False); ghost rows all zero.
    """
    if rcut_matrix is not None and not torch.is_tensor(rcut_matrix):
        rcut_matrix = rc2_table(rcut_matrix, positions.dtype,
                                positions.device)
    if mesh is not None:
        axis = shard_axis or mesh.axis_names[0]
        if mesh.shape[axis] > 1:
            slabs = mesh_slabs(plan, mesh, axis)
            geometry = _as_geometry(plan, lo, positions, geometry)
            fs, ws = resident_pair_forces(
                *(slab_split(t, plan, slabs) for t in (positions, types,
                                                       valid)),
                plan, lo, pair_fn, mesh, [geometry.on(d) for d, _, _ in
                                          slabs], axis,
                needs_virial=needs_virial, min_r2=min_r2,
                with_types=with_types, rcut_matrix=rcut_matrix,
                stencil=stencil, needs_energy=needs_energy, form=form,
                lanes=lanes, shard_fn=shard_fn)
            return tuple(None if t is None else slab_join(
                t, plan, slabs, positions.device) for t in (fs, ws))
    if stencil == "auto":
        stencil = "kernel" if positions.is_cuda else "full"
    if stencil == "kernel":
        if form is None:
            if pair_fn is None:
                raise ValueError("stencil='kernel' needs a kernel form "
                                 "(LJ-family or Chebyshev proxy) or a pair "
                                 "function (K1's generic form)")
            from .cellwise_cuda import generic_pair_forces
            return generic_pair_forces(
                positions, types, valid, plan, lo, pair_fn,
                typed_fn=with_types, needs_virial=needs_virial,
                min_r2=min_r2, rc2_tab=rcut_matrix,
                needs_energy=needs_energy, geometry=geometry, lanes=lanes)
        from .cellwise_cuda import half_stencil_pair_forces
        return half_stencil_pair_forces(
            positions, types, valid, plan, lo, form,
            needs_virial=needs_virial, min_r2=min_r2,
            rc2_tab=rcut_matrix, needs_energy=needs_energy,
            geometry=geometry)
    if stencil not in ("half", "full"):
        raise ValueError(f"unknown stencil {stencil!r}")
    geometry = _as_geometry(plan, lo, positions, geometry)
    n_cells, cap = plan.n_cells, plan.capacity
    offs_list = _HALF_OFFS if stencil == "half" else _OFFS
    qx, qy, qz, gx, gy, gz = _relative_coords(
        positions, valid, plan, lo, offs_list, geometry)
    ti = tj = None
    if with_types or rcut_matrix is not None:
        # float types, as the JAX package hands them to pair_fn
        tt = types.to(positions.dtype)
        ti, tj = tt.reshape(n_cells, cap), _roll_offs(tt, plan, offs_list)
    rows, cols = lane_sums(
        qx.reshape(n_cells, cap), qy.reshape(n_cells, cap),
        qz.reshape(n_cells, cap), gx, gy, gz, ti, tj,
        pair_fn, cap, plan.r_cut ** 2, min_r2,
        0 if stencil == "half" else 13 * cap, needs_energy, needs_virial,
        rc2_tab=rcut_matrix, want_cols=stencil == "half",
        typed_fn=with_types)
    coefs = _channel_coefs(needs_energy, needs_virial)
    out = torch.stack([rows[k] * c[0] for k, c in enumerate(coefs)])
    if stencil == "half":
        cols = torch.stack([cols[k] * c[1] for k, c in enumerate(coefs)])
        out = assemble_half(torch.cat([out, cols[:, :, cap:]], dim=2),
                            plan).reshape(len(coefs), n_cells, cap)
    return finish_forces(out.reshape(len(coefs), -1), valid,
                         needs_energy, needs_virial)


def repack_order(positions, valid, lo, plan, geometry=None):
    """Slot permutation for a rebuild.

    :returns: ``(order, new_slot, kept, overflow, occ)``:
        ``new[new_slot[j]] = old[order[j]]`` for each sorted row ``j``
        with ``kept[j]``; ``new_slot`` is ``n_slots`` for dropped rows;
        ``overflow`` (bool tensor) flags a cell over capacity; ``occ``
        (int32 tensor) is this snapshot's max cell occupancy.
    """
    n_slots, cap, n_cells = plan.n_slots, plan.capacity, plan.n_cells
    rows = positions.shape[0]
    dev = positions.device
    cell = bin_cells(positions, lo, plan, geometry)
    key = torch.where(valid > 0, cell, torch.full_like(cell, n_cells))
    # stable, like jax.lax.sort(num_keys=1): equal keys keep row order,
    # so the in-cell ranks (and the source map) match the JAX package
    sk, order = torch.sort(key, stable=True)
    idx = torch.arange(rows, device=dev)
    seg_start = torch.ones(rows, dtype=torch.bool, device=dev)
    seg_start[1:] = sk[1:] != sk[:-1]
    rank = idx - torch.cummax(
        torch.where(seg_start, idx, torch.zeros_like(idx)), dim=0).values
    sk = sk.long()
    real = sk < n_cells
    overflow = torch.any(real & (rank >= cap))
    kept = real & (rank < cap)
    new_slot = torch.where(kept, sk * cap + torch.clamp_max(rank, cap - 1),
                           torch.full_like(sk, n_slots))
    occ = (torch.max(torch.where(real, rank, torch.full_like(rank, -1)))
           + 1).to(torch.int32)
    return (order.to(torch.int32), new_slot.to(torch.int32), kept,
            overflow, occ)


def repack_src(positions, valid, lo, plan, with_occ=False, geometry=None):
    """Per-slot source-row map: ``src[i] = j`` means new slot ``i`` takes
    old row ``j``; ``src[i] == rows`` marks a ghost slot.

    The JAX form scatters with ``mode='drop'`` and lets the overflowed
    rows' out-of-range index fall away. Torch has no drop mode (and an
    out-of-range index is a device-side assert on CUDA), so the scatter
    goes into one extra dump row that is sliced off.

    :returns: ``(src [n_slots] int32, overflow)``, plus the snapshot max
        occupancy when ``with_occ``.
    """
    order, new_slot, kept, overflow, occ = repack_order(
        positions, valid, lo, plan, geometry)
    rows = positions.shape[0]
    src = torch.full((plan.n_slots + 1,), rows, dtype=torch.int32,
                     device=positions.device)
    src.scatter_(0, new_slot.long(), order)
    src = src[:plan.n_slots]
    if with_occ:
        return src, overflow, occ
    return src, overflow
