"""SlotLayout: the engine adapter for the slot-resident ("cellwise")
neighbor mode (PyTorch port of ``hoomd_tf_tpu/md/slots.py``).

- ``pack`` / ``unpack`` convert at ``run()`` boundaries;
- ``needs_rebuild`` (the Verlet criterion) and ``rebuild`` (the repack)
  run in the step loop every K steps;
- ``planes`` gives the masked 27-block candidate planes (the cellwise
  planes route of a generic SimModel);
- ``ghost_pin`` keeps ghost slots parked at their cell centers with zero
  velocity; ``mask_rows`` zeroes ghost force/energy/virial rows.

The thermostat degrees of freedom are those of the real particles;
``pack`` records them in ``state.thermostat['dof']``.

Every operation stays on the device and reads nothing back to the host:
the overflow bit, the running max occupancy and the running max speed
ride in ``aux`` as device tensors until ``run()`` fetches them once.
**Dynamic-box mode** (``dynamic_box=True``, for NPT): the grid and the
capacity stay, every geometric quantity (corner, lengths, cell edges,
centers, stencil offsets, binning) derives from the current
``state.box`` inside the step (:meth:`geom`, one
:class:`..ops.cellwise.SlotGeometry` per box; the kernels read the box
tensor itself). A barostat rescale is affine, so fractional coordinates,
and with them the slot assignment, are preserved; the Verlet criterion
runs in fractional space scaled by the current box (``ref`` holds
fractional coordinates), and :meth:`geometry_bad` flags a box shrunk to
``min(edge) < r_cut`` or gone non-finite. Tilted boxes are static only.
"""

import dataclasses

import torch

from .._device import resolve_device
from ..ops import cellwise as cw

__all__ = ["SlotLayout"]


class SlotLayout:
    """Slot-resident layout for ``n_real`` particles under a
    :class:`..ops.cellwise.CellwisePlan`.

    :param plan: static geometry (grid, capacity, box lengths, r_cut).
    :param n_real: number of real particles.
    :param lo: box lower corner (host ``[3]``).
    :param rc_matrix: per-type-pair cutoffs (numpy) or ``None``.
    :param device: where its constants live (default: the CUDA card;
        pass ``device="cpu"`` for the CPU).
    :param box: the ``[3, 3]`` box tensor the geometry derives from
        (default: the plan's, from ``lo``).
    :param dynamic_box: derive the geometry from ``state.box`` each step.
    """

    def __init__(self, plan, n_real, lo, rc_matrix=None,
                 dtype=torch.float32, device=None, box=None,
                 dynamic_box=False):
        device = resolve_device(device, "SlotLayout")
        if dynamic_box and plan.tilted:
            raise NotImplementedError(
                "dynamic-box (NPT) mode does not support tilted boxes")
        self.plan = plan
        self.n = int(n_real)
        self.lo = tuple(float(v) for v in lo)
        self.rc_matrix = rc_matrix
        self.dynamic_box = bool(dynamic_box)
        self.geometry = cw.SlotGeometry(plan, self.lo, dtype, device,
                                        box=box)
        self._live, self._live_box = self.geometry, None
        self.rc2_tab = (None if rc_matrix is None else
                        cw.rc2_table(rc_matrix, dtype, device))

    def geom(self, state=None):
        """The geometry of ``state``'s box: the layout's own, or in
        dynamic-box mode one per box tensor (kept while the box is)."""
        if not self.dynamic_box or state is None:
            return self.geometry
        if self._live_box is not state.box:
            self._live = self.geometry.at(state.box)
            self._live_box = state.box
        return self._live

    def centers(self, state=None):
        return self.geom(state).centers

    def _repack(self, st, valid):
        g = self.geom(st)
        return cw.repack_src(st.positions, valid, self.lo, self.plan,
                             with_occ=True, geometry=g)

    def _ref(self, st):
        """What the Verlet criterion measures drift from: the positions,
        or in dynamic-box mode their fractional coordinates."""
        if not self.dynamic_box:
            return st.positions
        f = cw._fractional(st.positions, self.geom(st))
        return f - torch.floor(f)

    @staticmethod
    def _vmax(velocities):
        return torch.sqrt(torch.max(torch.sum(velocities * velocities,
                                              dim=-1)))

    # ------------------------------------------------------------------
    def pack(self, state, src=None):
        """Particle-order ``SimState`` -> ``(slot-order state, aux)``.

        :param src: the particle of each slot (``n`` on a ghost slot), the
            ``aux['orig']`` of an earlier pack or rebuild to restore that
            slot order (a checkpoint's); default: binned from the
            positions."""
        dtype = state.positions.dtype
        if src is None:
            valid_n = torch.ones(self.n, dtype=dtype,
                                 device=state.positions.device)
            src, overflow, occ = self._repack(state, valid_n)
        else:
            src = src.to(torch.int32)
            overflow = torch.zeros((), dtype=torch.bool, device=src.device)
            occ = torch.zeros((), dtype=torch.int32, device=src.device)
        has = src < self.n
        idx = torch.clamp_max(src, self.n - 1).long()

        def put(vals, default):
            sel = has.reshape((-1,) + (1,) * (vals.ndim - 1))
            return torch.where(sel, vals[idx], default)

        positions = put(state.positions, self.centers(state))
        velocities = put(state.velocities, 0.0)
        slot_state = dataclasses.replace(
            state, positions=positions, velocities=velocities,
            types=put(state.types, 0), masses=put(state.masses, 1.0),
            forces=put(state.forces, 0.0), virial=put(state.virial, 0.0),
            thermostat={**(state.thermostat or {}),
                        "dof": float(3 * self.n - 3)})
        orig = torch.where(has, src, self.n).to(torch.int32)
        slot_state.noise_rows = (orig.long(), self.n)
        aux = {"valid": has.to(dtype), "orig": orig,
               "ref": self._ref(slot_state), "overflow": overflow,
               "occ_max": occ,
               "vmax": self._vmax(velocities)}
        return slot_state, aux

    def to_particles(self, vals, aux):
        """Rows of slot order -> particle order. Ghost rows scatter into
        one dump row past the end, which is sliced off."""
        out = torch.zeros((self.n + 1,) + tuple(vals.shape[1:]),
                          dtype=vals.dtype, device=vals.device)
        out.index_copy_(0, aux["orig"].long(), vals)
        return out[:self.n]

    def to_slots(self, vals, aux):
        """Rows of particle order -> slot order, zero on ghost rows."""
        orig = aux["orig"].long()
        got = vals[torch.clamp_max(orig, self.n - 1)]
        has = (orig < self.n).reshape((-1,) + (1,) * (vals.ndim - 1))
        return torch.where(has, got, torch.zeros_like(got))

    def unpack(self, slot_state, aux):
        """Slot-order state -> particle-order ``SimState`` (original
        indexing restored, the layout's ``dof`` key removed)."""
        def back(vals):
            return self.to_particles(vals, aux)

        thermostat = dict(slot_state.thermostat or {})
        thermostat.pop("dof", None)
        return dataclasses.replace(
            slot_state, positions=back(slot_state.positions),
            velocities=back(slot_state.velocities),
            types=back(slot_state.types), masses=back(slot_state.masses),
            forces=back(slot_state.forces), virial=back(slot_state.virial),
            thermostat=thermostat, noise_rows=None)

    # ------------------------------------------------------------------
    def needs_rebuild(self, slot_state, aux):
        """Verlet criterion as a bool tensor: a particle drifted at least
        ``0.98 * skin / 2`` since the last repack (a boundary crossing's
        lattice-vector jump removed by the box's minimum image).

        Dynamic-box mode: the drift is the fractional displacement times
        the current lengths (a box rescale moves no particle in fractional
        space), the skin the current ``min(edge) - r_cut``."""
        if self.dynamic_box:
            g = self.geom(slot_state)
            d = self._ref(slot_state) - aux["ref"]
            d = (d - torch.round(d)) * g.lengths
            half_skin = torch.clamp_min(
                torch.min(g.edges) - self.plan.r_cut, 0.0) / 2.0
            return torch.max(torch.sum(d * d, dim=-1)) >= \
                (half_skin * 0.98) ** 2
        d = self.geometry.wrap(slot_state.positions - aux["ref"])
        half_skin = max(self.plan.skin, 0.0) / 2.0
        return torch.max(torch.sum(d * d, dim=-1)) >= (half_skin * 0.98) ** 2

    def geometry_bad(self, slot_state):
        """Dynamic-box failure check, a bool tensor: the box shrank until
        ``min(edge) < r_cut`` (the static grid's 27-stencil no longer
        covers the cut; a repack cannot fix it), or went non-finite (the
        integrator diverged). Written ``not (edge >= r_cut)`` so a NaN
        counts as bad."""
        return torch.logical_not(
            torch.min(self.geom(slot_state).edges) >= self.plan.r_cut)

    def rebuild(self, slot_state, aux):
        """Repack the slot assignment from the current positions.

        One gather of a ``[n_slots, 20]`` block of the state's dtype moves
        every floating column, and one of a ``[n_slots, 2]`` int32 block
        the particle index and the type: exact in float32 and in float64
        (no column is bitcast into another type). Unlike the JAX package,
        the forces and virial move with their particles: the first
        half-kick after a repack reads them (see ROADMAP.md Queue 3 on the
        reference's unpermuted forces). So do the model forces and virial
        a ``period`` > 1 run carries between evaluations (``aux['mf']``,
        ``aux['mw']``, when present)."""
        n_slots = self.plan.n_slots
        st = slot_state
        src, overflow, occ = self._repack(st, aux["valid"])
        has = src < n_slots
        carried = [k for k in ("mf", "mw") if aux.get(k) is not None]
        blk = torch.cat([
            st.positions, st.velocities, st.masses[:, None],
            st.forces, st.virial.reshape(-1, 9)] +
            [aux[k].reshape(n_slots, -1) for k in carried], dim=1)
        ints = torch.stack([aux["orig"], st.types], dim=1)
        at = torch.clamp(src, 0, n_slots - 1).long()
        g, gi = blk[at], ints[at]
        h = has[:, None]
        positions = torch.where(h, g[:, 0:3], self.centers(st))
        velocities = torch.where(h, g[:, 3:6], 0.0)
        masses = torch.where(has, g[:, 6], 1.0)
        forces = torch.where(h, g[:, 7:11], 0.0)
        virial = torch.where(h, g[:, 11:20], 0.0).reshape(-1, 3, 3)
        orig = torch.where(has, gi[:, 0], self.n)
        types = torch.where(has, gi[:, 1], 0)
        new_state = dataclasses.replace(
            st, positions=positions, velocities=velocities, types=types,
            masses=masses, forces=forces, virial=virial,
            noise_rows=(orig.long(), self.n))
        vm = self._vmax(velocities)
        new_aux = {"valid": has.to(positions.dtype), "orig": orig,
                   "ref": self._ref(new_state),
                   "overflow": aux["overflow"] | overflow,
                   "occ_max": torch.maximum(aux["occ_max"], occ),
                   "vmax": torch.maximum(aux["vmax"], vm)}
        col = 20
        for k in carried:
            w = aux[k][0].numel()
            new_aux[k] = torch.where(h, g[:, col:col + w], 0.0).reshape(
                aux[k].shape)
            col += w
        return new_state, new_aux

    # ------------------------------------------------------------------
    def planes(self, slot_state, aux, cells=None):
        """Masked :class:`..ops.direct.NlistPlanes` of the current slot
        positions (:func:`..ops.cellwise.cellwise_planes`), of the rows
        of ``cells = (c0, c1)`` only when given."""
        return cw.cellwise_planes(slot_state.positions, slot_state.types,
                                  aux["valid"], self.plan,
                                  rcut_matrix=self.rc2_tab, cells=cells,
                                  box=self.geom(slot_state).box)

    # ------------------------------------------------------------------
    def ghost_pin(self, slot_state, aux):
        """Re-pin ghosts: zero velocity, parked at the cell center."""
        valid = aux["valid"][:, None]
        slot_state.positions = torch.where(valid > 0, slot_state.positions,
                                           self.centers(slot_state))
        slot_state.velocities = slot_state.velocities * valid
        return slot_state

    def mask_rows(self, forces4, virial, aux):
        """Zero force/energy/virial rows of ghost slots."""
        valid = aux["valid"]
        return (forces4 * valid[:, None],
                None if virial is None else virial * valid[:, None, None])
