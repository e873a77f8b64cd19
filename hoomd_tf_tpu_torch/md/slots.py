"""SlotLayout: the engine adapter for the slot-resident ("cellwise")
neighbor mode (PyTorch port of ``hoomd_tf_tpu/md/slots.py``, static box).

- ``pack`` / ``unpack`` convert at ``run()`` boundaries;
- ``needs_rebuild`` (the Verlet criterion) and ``rebuild`` (the repack)
  run in the step loop every K steps;
- ``ghost_pin`` keeps ghost slots parked at their cell centers with zero
  velocity; ``mask_rows`` zeroes ghost force/energy/virial rows.

The thermostat degrees of freedom are those of the real particles;
``pack`` records them in ``state.thermostat['dof']``.

Every operation stays on the device and reads nothing back to the host:
the overflow bit, the running max occupancy and the running max speed
ride in ``aux`` as device tensors until ``run()`` fetches them once.
The dynamic-box (NPT) mode is still to port.
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
    """

    def __init__(self, plan, n_real, lo, rc_matrix=None,
                 dtype=torch.float32, device=None):
        device = resolve_device(device, "SlotLayout")
        self.plan = plan
        self.n = int(n_real)
        self.lo = tuple(float(v) for v in lo)
        self.rc_matrix = rc_matrix
        self.geometry = cw.SlotGeometry(plan, self.lo, dtype, device)
        self.rc2_tab = (None if rc_matrix is None else
                        cw.rc2_table(rc_matrix, dtype, device))

    def centers(self):
        return self.geometry.centers

    def _repack(self, positions, valid):
        return cw.repack_src(positions, valid, self.lo, self.plan,
                             with_occ=True, geometry=self.geometry)

    @staticmethod
    def _vmax(velocities):
        return torch.sqrt(torch.max(torch.sum(velocities * velocities,
                                              dim=-1)))

    # ------------------------------------------------------------------
    def pack(self, state):
        """Particle-order ``SimState`` -> ``(slot-order state, aux)``."""
        dtype = state.positions.dtype
        valid_n = torch.ones(self.n, dtype=dtype,
                             device=state.positions.device)
        src, overflow, occ = self._repack(state.positions, valid_n)
        has = src < self.n
        idx = torch.clamp_max(src, self.n - 1).long()

        def put(vals, default):
            sel = has.reshape((-1,) + (1,) * (vals.ndim - 1))
            return torch.where(sel, vals[idx], default)

        positions = put(state.positions, self.centers())
        velocities = put(state.velocities, 0.0)
        slot_state = dataclasses.replace(
            state, positions=positions, velocities=velocities,
            types=put(state.types, 0), masses=put(state.masses, 1.0),
            forces=put(state.forces, 0.0), virial=put(state.virial, 0.0),
            thermostat={**(state.thermostat or {}),
                        "dof": float(3 * self.n - 3)})
        aux = {"valid": has.to(dtype),
               "orig": torch.where(has, src, self.n).to(torch.int32),
               "ref": positions, "overflow": overflow, "occ_max": occ,
               "vmax": self._vmax(velocities)}
        return slot_state, aux

    def unpack(self, slot_state, aux):
        """Slot-order state -> particle-order ``SimState`` (original
        indexing restored, the layout's ``dof`` key removed). Ghost rows
        scatter into one dump row past the end, which is sliced off."""
        orig = aux["orig"].long()

        def back(vals):
            out = torch.zeros((self.n + 1,) + tuple(vals.shape[1:]),
                              dtype=vals.dtype, device=vals.device)
            out.index_copy_(0, orig, vals)
            return out[:self.n]

        thermostat = dict(slot_state.thermostat or {})
        thermostat.pop("dof", None)
        return dataclasses.replace(
            slot_state, positions=back(slot_state.positions),
            velocities=back(slot_state.velocities),
            types=back(slot_state.types), masses=back(slot_state.masses),
            forces=back(slot_state.forces), virial=back(slot_state.virial),
            thermostat=thermostat)

    # ------------------------------------------------------------------
    def needs_rebuild(self, slot_state, aux):
        """Verlet criterion as a bool tensor: a particle drifted at least
        ``0.98 * skin / 2`` since the last repack."""
        L = self.geometry.lengths
        d = slot_state.positions - aux["ref"]
        d = d - torch.round(d / L) * L
        half_skin = max(self.plan.skin, 0.0) / 2.0
        return torch.max(torch.sum(d * d, dim=-1)) >= (half_skin * 0.98) ** 2

    def rebuild(self, slot_state, aux):
        """Repack the slot assignment from the current positions.

        One gather of a ``[n_slots, 22]`` block moves every per-row
        column; int32 columns ride bitcast as float32 (exact). Unlike the
        JAX package, the forces and virial move with their particles: the
        first half-kick after a repack reads them (see ROADMAP.md Queue
        3 on the reference's unpermuted forces)."""
        n_slots = self.plan.n_slots
        st = slot_state
        src, overflow, occ = self._repack(st.positions, aux["valid"])
        has = src < n_slots
        blk = torch.cat([
            st.positions, st.velocities,
            aux["orig"].view(torch.float32)[:, None], st.masses[:, None],
            st.types.view(torch.float32)[:, None],
            st.forces, st.virial.reshape(-1, 9)], dim=1)
        g = blk[torch.clamp(src, 0, n_slots - 1).long()]
        h = has[:, None]
        positions = torch.where(h, g[:, 0:3], self.centers())
        velocities = torch.where(h, g[:, 3:6], 0.0)
        orig = torch.where(has, g[:, 6].contiguous().view(torch.int32),
                           self.n)
        masses = torch.where(has, g[:, 7], 1.0)
        types = torch.where(has, g[:, 8].contiguous().view(torch.int32), 0)
        forces = torch.where(h, g[:, 9:13], 0.0)
        virial = torch.where(h, g[:, 13:22], 0.0).reshape(-1, 3, 3)
        new_state = dataclasses.replace(
            st, positions=positions, velocities=velocities, types=types,
            masses=masses, forces=forces, virial=virial)
        vm = self._vmax(velocities)
        new_aux = {"valid": has.to(positions.dtype), "orig": orig,
                   "ref": positions,
                   "overflow": aux["overflow"] | overflow,
                   "occ_max": torch.maximum(aux["occ_max"], occ),
                   "vmax": torch.maximum(aux["vmax"], vm)}
        return new_state, new_aux

    # ------------------------------------------------------------------
    def ghost_pin(self, slot_state, aux):
        """Re-pin ghosts: zero velocity, parked at the cell center."""
        valid = aux["valid"][:, None]
        slot_state.positions = torch.where(valid > 0, slot_state.positions,
                                           self.centers())
        slot_state.velocities = slot_state.velocities * valid
        return slot_state

    def mask_rows(self, forces4, virial, aux):
        """Zero force/energy/virial rows of ghost slots."""
        valid = aux["valid"]
        return (forces4 * valid[:, None],
                None if virial is None else virial * valid[:, None, None])
