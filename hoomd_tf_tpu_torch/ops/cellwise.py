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

Orthorhombic boxes only in this slice of the port.
"""

import dataclasses
import math

import numpy as np
import torch

from .._device import resolve_device
from .cell_list import CellList

__all__ = ["Cellwise", "CellwisePlan", "plan_cellwise",
           "analytic_pair_forces", "cellwise_planes", "repack_order", "repack_src",
           "slot_cell_centers", "bin_cells", "SlotGeometry"]


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


@dataclasses.dataclass(frozen=True)
class CellwisePlan:
    """Static geometry of the slot-resident layout.

    :param grid: cells per axis ``(nx, ny, nz)``.
    :param capacity: slots per cell.
    :param lengths: box lengths ``(Lx, Ly, Lz)``.
    :param r_cut: cutoff radius the planes are exact for.
    """
    grid: tuple
    capacity: int
    lengths: tuple
    r_cut: float

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
    def skin(self):
        """Verlet margin: the slot assignment stays valid while the
        largest displacement since the last repack is below skin / 2."""
        return min(self.edges) - self.r_cut


def _measured_occupancy(positions, lo, lengths, dims):
    """Max, mean and std of particles-per-cell for host positions."""
    pos = np.asarray(positions)[:, :3].astype(np.float64)
    lengths = np.asarray(lengths, dtype=np.float64)
    frac = (pos - np.asarray(lo)) / lengths
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
                  lo=None, drift_per_step=None, width_blocks=27,
                  occ_observed=None, lane_cost_scale=1.0):
    """Choose ``(grid, capacity)`` minimizing the modelled per-step cost
    (pair lanes plus amortized repack). Same algorithm and arguments as
    the JAX ``plan_cellwise`` (minus tilt and the mesh divisor).

    :param width_blocks: 14 when the half-stencil kernel is the hot
        loop, 27 for the full-stencil tensor form.
    :returns: a :class:`CellwisePlan`, or ``None`` if no grid with >= 3
        cells per axis exists.
    """
    config = config if isinstance(config, CellList) else CellList()
    lengths = np.asarray(box_lengths, dtype=np.float64)
    if lo is None:
        lo = -lengths / 2.0
    min_edge = r_cut + max(config.skin, 0.0)
    best = None
    for scale in np.linspace(1.0, 1.8, 9):
        dims = tuple(int(math.floor(W / (min_edge * scale)))
                     for W in lengths)
        if any(d < 3 for d in dims):
            continue
        edges = [W / d for W, d in zip(lengths, dims)]
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
                                                dims)
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
                r_cut=float(r_cut)))
    return best[1] if best else None


class SlotGeometry:
    """Device-resident constants of one plan: box corner and lengths,
    ghost parking spots, in-cell slot ranks and the per-lane stencil
    offsets. Built once per layout, so the hot loop never copies a host
    constant to the device (each such copy is a host sync)."""

    def __init__(self, plan, lo, dtype=torch.float32, device=None):
        self.plan = plan
        self.dtype = dtype
        self.device = resolve_device(device, "SlotGeometry")
        kw = dict(dtype=dtype, device=self.device)
        self.lo = torch.as_tensor(np.asarray(lo, np.float64), **kw)
        self.lengths = torch.as_tensor(plan.lengths, **kw)
        self.dims = torch.as_tensor(plan.grid, **kw)
        self.dims_i = torch.as_tensor(plan.grid, dtype=torch.int32,
                                      device=self.device)
        self.centers = _slot_cell_centers(plan, self.lo, dtype)
        self.rank = (torch.arange(plan.n_slots, device=self.device) %
                     plan.capacity).to(dtype)
        self._offs = {}

    def offsets(self, offs_list):
        """``[3, n_offs * cap]`` per-lane Cartesian stencil offsets."""
        key = tuple(offs_list)
        if key not in self._offs:
            ex, ey, ez = self.plan.edges
            noffs = np.array([(ox * ex, oy * ey, oz * ez)
                              for (ox, oy, oz) in offs_list])
            rep = np.repeat(noffs, self.plan.capacity, axis=0).T
            self._offs[key] = torch.as_tensor(
                np.ascontiguousarray(rep), dtype=self.dtype,
                device=self.device)
        return self._offs[key]


def _as_geometry(plan, lo, like, geometry):
    if geometry is not None:
        return geometry
    return SlotGeometry(plan, lo, like.dtype, like.device)


def _slot_cell_centers(plan, lo_t, dtype):
    nx, ny, nz = plan.grid
    ex, ey, ez = plan.edges
    cell = torch.arange(plan.n_slots, device=lo_t.device) // plan.capacity
    cx = (cell % nx).to(dtype)
    cy = ((cell // nx) % ny).to(dtype)
    cz = (cell // (nx * ny)).to(dtype)
    return torch.stack([lo_t[0] + (cx + 0.5) * ex,
                        lo_t[1] + (cy + 0.5) * ey,
                        lo_t[2] + (cz + 0.5) * ez], dim=-1)


def slot_cell_centers(plan, lo, dtype=torch.float32, device=None):
    """``[n_slots, 3]`` cell-center coordinates -- the parking spot for
    ghost slots."""
    lo_t = torch.as_tensor(np.asarray(lo, np.float64), dtype=dtype,
                           device=resolve_device(device,
                                                 "slot_cell_centers"))
    return _slot_cell_centers(plan, lo_t, dtype)


def bin_cells(pos3, lo, plan, geometry=None):
    """Flat int32 cell id per row (x-minor / z-major, matching the
    ``[nz, ny, nx, cap]`` slot view)."""
    g = _as_geometry(plan, lo, pos3, geometry)
    frac = (pos3 - g.lo) / g.lengths
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
                    cells=None, lengths=None):
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
    :param lengths: ``[3]`` box lengths tensor on the positions' device
        (default: the plan's, copied from the host).
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
    if lengths is None:
        lengths = torch.as_tensor(plan.lengths, dtype=dtype,
                                  device=positions.device)

    def cand(plane):
        return _roll_offs(plane, plan, _OFFS)[c0:c1].reshape(m, 1, C)

    dd = []
    for a in range(3):
        p = positions[:, a]
        d = cand(p) - p[rows].reshape(m, cap, 1)
        dd.append(d - torch.round(d / lengths[a]) * lengths[a])
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


def _relative_coords(positions, valid, plan, lo, offs_list, geometry=None):
    """Cell-relative coordinates (ghosts pushed FAR along x, a distinct
    distance per in-cell rank) and the per-direction candidate planes
    with the static stencil offsets pre-added, so displacements need no
    min-image rounding."""
    g = _as_geometry(plan, lo, positions, geometry)
    FAR = 4.0 * float(max(plan.lengths))
    q = positions - g.centers
    q = q - torch.round(q / g.lengths) * g.lengths
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


def analytic_pair_forces(positions, types, valid, plan, lo, pair_fn,
                         needs_virial=False, min_r2=1e-4, with_types=False,
                         rcut_matrix=None, stencil="auto",
                         needs_energy=True, form=None, geometry=None,
                         lanes=None):
    """Forces/energy (and optionally virial) of a pair potential on
    slot-resident state -- the fast path behind
    :class:`..models.pair.PairModel`. Same contract as the JAX function.

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
    :param lanes: the generic form's :class:`.cellwise_cuda.LaneBudget`.
    :returns: ``(forces4 [n_slots, 4], virial [n_slots, 3, 3] or None)``
        with the per-particle energy in force column 4 (zero when
        ``needs_energy`` is False); ghost rows all zero.
    """
    if stencil == "auto":
        stencil = "kernel" if positions.is_cuda else "full"
    if rcut_matrix is not None and not torch.is_tensor(rcut_matrix):
        rcut_matrix = rc2_table(rcut_matrix, positions.dtype,
                                positions.device)
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
