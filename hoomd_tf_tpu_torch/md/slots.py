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

from .._device import resolve_device, to_device
from ..ops import cellwise as cw
from .state import RowState, Shards, SimState, SlabState, shard_rows

__all__ = ["SlotLayout", "SlabSlots"]


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
        return _frac(st.positions, self.geom(st))

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
        blk = _block(st, extra=[aux[k].reshape(n_slots, -1)
                                for k in carried])
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
        col = _COLS
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

    def resident(self, mesh, shard_axis=None):
        """This layout's slot state resident per z-slab shard of ``mesh``
        (:class:`SlabSlots`), made once per mesh."""
        cache = self.__dict__.setdefault("_resident", {})
        axis = shard_axis or mesh.axis_names[0]
        key = (id(mesh), axis)
        if key not in cache:
            cache[key] = (mesh, SlabSlots(self, mesh, axis))
        return cache[key][1]


class SlabSlots:
    """The slot state of a :class:`SlotLayout` resident per z-slab shard
    of a mesh (the JAX package's row-sharded slot arrays under
    ``Simulation(mesh=)``): no tensor of all ``n_slots`` rows exists
    between :meth:`pack` and :meth:`unpack`.

    Shard ``s`` of the mesh, with the z-layers ``z0 .. z0 + nzl - 1``
    (:func:`..ops.cellwise.slab_layers`), keeps its buffers on
    ``mesh.devices[s]``: a :class:`.state.SimState` (positions,
    velocities, masses, types, forces, virial) in a
    :class:`.state.SlabState`, and ``valid``, ``orig`` and ``ref`` in
    ``aux`` as :class:`.state.Shards`. Each holds ``(nzl + 1) * layer``
    rows: the home layers in slot order, then one forward halo layer
    (:func:`..ops.cellwise.slab_rows`), which K1's group launch reads in
    place (:func:`..ops.cellwise.resident_pair_forces` writes its
    positions before each evaluation; the repack writes its types and
    ``valid``). The halo rows are otherwise inert: zero velocity, force
    and virial, unit mass, ``orig = n``, no noise.

    The methods are :class:`SlotLayout`'s, per shard: the integrators run
    on each shard (:mod:`.integrators`), and what the run reads back --
    the overflow bit, the running max occupancy and speed, the Verlet
    test -- is combined on the first shard's device. The planes route's
    model reads every row joined on the first shard's device
    (:meth:`planes`, :meth:`whole`) and its forces go back to the shards
    (:meth:`split`); a mapped model's beads are written per shard
    (:meth:`write_particles`).

    **The migrating repack** (:meth:`rebuild`) is local to each shard: a
    repack comes before any particle drifted ``skin / 2`` (the Verlet
    test), so a particle can reach only an adjacent cell, and shard
    ``s``'s new rows come from its home layers, the last home layer of
    shard ``s - 1`` and the first of shard ``s + 1``, the two fixed-size
    migration buffers (no ``nonzero``, no host sync). The window is
    sorted stably by ``(cell, old global slot row)``, so the in-cell
    ranks are :func:`..ops.cellwise.repack_order`'s on the whole state,
    bit for bit. A particle that no shard's window can take sets the
    overflow bit, and the run rolls back as for a full cell.
    """

    def __init__(self, layout, mesh, shard_axis=None):
        self.layout = layout
        self.mesh = mesh
        self.plan, self.lo, self.n = layout.plan, layout.lo, layout.n
        self.rc2_tab, self.dynamic_box = layout.rc2_tab, layout.dynamic_box
        self.geometry = layout.geometry
        self.slabs = cw.mesh_slabs(layout.plan, mesh, shard_axis)
        self.shard_axis = shard_axis
        self.layer = cw.halo_layer(layout.plan)
        self.device = layout.geometry.device
        #: each shard's home rows' global slot numbers (int64, on its
        #: device)
        self.slot_rows = Shards(
            torch.arange(z0 * self.layer, (z0 + nzl) * self.layer,
                         device=dev) for dev, z0, nzl in self.slabs)

    def geom(self, state=None):
        return self.layout.geom(state)

    def geometry_bad(self, slot_state):
        return self.layout.geometry_bad(slot_state)

    def geoms(self, state=None):
        """Each shard's geometry of the global plan at ``state``'s box, on
        its device (:meth:`..ops.cellwise.SlotGeometry.on`)."""
        g = self.geom(state)
        return [g.on(dev) for dev, _, _ in self.slabs]

    def home(self, s):
        """Shard ``s``'s home rows (its buffer's rows before the halo)."""
        return self.slabs[s][2] * self.layer

    def _first(self, vals):
        """Per-shard 0-dim ``vals`` stacked on the first shard's device."""
        return torch.stack([to_device(v, self.device) for v in vals])

    def _refs(self, st):
        """Each shard's :meth:`SlotLayout._ref` (the fractional
        coordinates in dynamic-box mode)."""
        if not self.dynamic_box:
            return st.positions
        return Shards(_frac(p.positions, g)
                      for p, g in zip(st.shards, self.geoms(st)))

    def _vmax(self, velocities):
        return torch.sqrt(self._first(
            [torch.max(torch.sum(v * v, dim=-1)) for v in velocities]).max())

    def _buffer(self, s, g, cols):
        """Shard ``s``'s buffer from its home rows ``cols`` (a dict of the
        state's row fields, ``valid`` and ``orig``): the halo layer's rows
        appended as ghosts parked at their cell centers (its positions,
        types and ``valid`` are the next shard's once :meth:`_fill_halos`
        ran)."""
        _, z0, nzl = self.slabs[s]
        L = self.layer

        def pad(t, value):
            return torch.cat([t, torch.full((L,) + tuple(t.shape[1:]),
                                            value, dtype=t.dtype,
                                            device=t.device)])
        out = {k: pad(cols[k], v) for k, v in (
            ("velocities", 0), ("masses", 1), ("types", 0), ("forces", 0),
            ("virial", 0), ("valid", 0), ("orig", self.n))}
        out["positions"] = torch.cat([cols["positions"],
                                      g.slab_centers(z0, nzl)[-L:]])
        for k in ("mf", "mw"):
            if cols.get(k) is not None:
                out[k] = pad(cols[k], 0)
        return out

    def _fill_halos(self, bufs):
        """Each shard's halo layer of positions, types and ``valid``: the
        next shard's first home layer."""
        L = self.layer
        for s, b in enumerate(bufs):
            nxt = bufs[(s + 1) % len(bufs)]
            for k in ("positions", "types", "valid"):
                cw.put_rows(b[k][-L:], nxt[k][:L])

    def _assemble(self, like, bufs, overflow, occ, vmax=None):
        """``(SlabState, aux)`` from each shard's buffer dict; ``like``
        gives the run-wide fields (box, step, thermostat, tilted, rng)."""
        self._fill_halos(bufs)
        shards = [SimState(
            positions=b["positions"], velocities=b["velocities"],
            types=b["types"], masses=b["masses"],
            box=to_device(like.box, dev), forces=b["forces"],
            virial=b["virial"], step=like.step, tilted=like.tilted,
            noise_rows=(b["orig"].long(), self.n))
            for b, (dev, _, _) in zip(bufs, self.slabs)]
        st = SlabState(shards, like.box, self.n, like.step, like.thermostat,
                       like.tilted, like.rng)
        vm = self._vmax(st.velocities)
        aux = {"valid": Shards(b["valid"] for b in bufs),
               "orig": Shards(b["orig"] for b in bufs),
               "ref": self._refs(st), "overflow": overflow,
               "occ_max": occ,
               "vmax": vm if vmax is None else torch.maximum(vmax, vm)}
        for k in ("mf", "mw"):
            if k in bufs[0]:
                aux[k] = Shards(b[k] for b in bufs)
        return st, aux

    # ------------------------------------------------------------------
    def pack(self, state, src=None):
        """Particle-order state -> ``(SlabState, aux)``: the slot
        assignment of :meth:`SlotLayout.pack` (``src`` as there; binned
        from the positions joined on the first device), then each shard's
        slot rows gathered on its own device from the particle rows of
        every row shard (a :class:`.state.RowState`, the state the engine
        keeps between runs, or a whole :class:`.state.SimState` as one row
        shard), its ghosts parked at their cell centers."""
        layout, n, L = self.layout, self.n, self.layer
        if not isinstance(state, RowState):
            state = RowState.of(state, [state.positions.device],
                                [slice(0, n)])
        dtype = state.dtype
        if src is None:
            valid_n = torch.ones(n, dtype=dtype, device=self.device)
            src, overflow, occ = cw.repack_src(
                state.join(state.positions), valid_n, self.lo, self.plan,
                with_occ=True, geometry=layout.geom(state))
        else:
            src = src.to(torch.int32)
            overflow = torch.zeros((), dtype=torch.bool, device=src.device)
            occ = torch.zeros((), dtype=torch.int32, device=src.device)
        g = layout.geom(state)
        blocks = [(r, _block(p), p.types)
                  for r, p in zip(state.rows, state.shards)]
        bufs = []
        for s, (dev, z0, nzl) in enumerate(self.slabs):
            rows = to_device(src[z0 * L:(z0 + nzl) * L], dev).long()
            has = rows < n
            blk = torch.zeros((nzl * L, _COLS), dtype=dtype, device=dev)
            types = torch.zeros((nzl * L,), dtype=torch.int32, device=dev)
            for r, b, t in blocks:
                loc = rows - r.start
                sel = (loc >= 0) & (loc < r.stop - r.start)
                at = torch.clamp(loc, 0, r.stop - r.start - 1)
                blk = torch.where(sel[:, None], to_device(b, dev)[at], blk)
                types = torch.where(sel, to_device(t, dev)[at], types)
            cols = _unblock(blk, has)
            cols.update(types=types, valid=has.to(dtype),
                        orig=torch.where(has, rows, n).to(torch.int32))
            gd = g.on(dev)
            cols["positions"] = torch.where(
                cols["valid"][:, None] > 0, cols["positions"],
                gd.slab_centers(z0, nzl)[:nzl * L])
            bufs.append(self._buffer(s, gd, cols))
        like = dataclasses.replace(state.shards[0], box=state.box,
                                   step=state.step, tilted=state.tilted,
                                   rng=state.rng, thermostat={
                                       **(state.thermostat or {}),
                                       "dof": float(3 * n - 3)})
        return self._assemble(like, bufs, overflow, occ)

    def to_particles(self, vals, aux):
        """Each shard's home rows (:class:`.state.Shards`) -> particle
        order on the first shard's device."""
        first = self.device
        out = torch.zeros((self.n + 1,) + tuple(vals[0].shape[1:]),
                          dtype=vals[0].dtype, device=first)
        for s, (v, o) in enumerate(zip(vals, aux["orig"])):
            H = self.home(s)
            out.index_copy_(0, to_device(o[:H], first).long(),
                            to_device(v[:H], first))
        return out[:self.n]

    def whole(self, vals):
        """Each shard's home rows joined in global slot order on the first
        shard's device (a checkpoint's slot order, the model's rows on the
        planes route, a test's view)."""
        return torch.cat([to_device(v[:self.home(s)], self.device)
                          for s, v in enumerate(vals)])

    def split(self, vals):
        """The inverse of :meth:`whole`: rows of every slot in global slot
        order (on the first shard's device) -> each shard's buffer rows on
        its device, its home rows, then zero halo rows."""
        out = []
        for dev, z0, nzl in self.slabs:
            home = to_device(vals[z0 * self.layer:(z0 + nzl) * self.layer],
                             dev)
            out.append(torch.cat([home, home.new_zeros(
                (self.layer,) + tuple(home.shape[1:]))]))
        return Shards(out)

    def write_particles(self, vals, rows, aux, first):
        """Each shard's ``vals`` with the rows of the particles ``first ..
        n - 1`` (the CG beads of a mapped model) taken from ``rows``
        (their values in particle order, ``[n - first, ...]``); every other
        row, a halo row too, as it was."""
        out = []
        for v, orig in zip(vals, aux["orig"]):
            o = orig.long()
            got = to_device(rows, v.device)[
                torch.clamp(o - first, 0, self.n - first - 1)]
            sel = ((o >= first) & (o < self.n)).reshape(
                (-1,) + (1,) * (v.ndim - 1))
            out.append(torch.where(sel, got, v))
        return Shards(out)

    def to_slots(self, vals, aux):
        """Rows of particle order -> each shard's buffer rows, zero on
        ghost and halo rows."""
        out = []
        for orig in aux["orig"]:
            o = to_device(orig, vals.device).long()
            got = vals[torch.clamp_max(o, self.n - 1)]
            has = (o < self.n).reshape((-1,) + (1,) * (vals.ndim - 1))
            out.append(to_device(torch.where(has, got, torch.zeros_like(got)),
                                 orig.device))
        return Shards(out)

    def unpack(self, slot_state, aux):
        """``SlabState`` -> :class:`.state.RowState`: each mesh shard's
        contiguous particle rows (:func:`.state.shard_rows`) written on
        its device from every z-slab shard's home rows, scattered by their
        particles (the run's one exchange of the shards: no whole-state
        gather on the first device)."""
        st, n = slot_state, self.n
        devices = [dev for dev, _, _ in self.slabs]
        sent = []
        for s, p in enumerate(st.shards):
            H = self.home(s)
            sent.append((_block(p, H), torch.stack(
                [aux["orig"][s][:H], p.types[:H]], dim=1)))
        rows = shard_rows(n, len(devices))
        shards = []
        for dev, r in zip(devices, rows):
            m = r.stop - r.start
            blk = torch.zeros((m + 1, _COLS), dtype=st.dtype, device=dev)
            ints = torch.zeros((m + 1, 2), dtype=torch.int32, device=dev)
            for b, i in sent:
                i = to_device(i, dev)
                o = i[:, 0].long()
                # rows of other shards' particles (and ghosts, halo rows)
                # land in the dump row past the end
                at = torch.where((o >= r.start) & (o < r.stop),
                                 o - r.start, m)
                blk.index_copy_(0, at, to_device(b, dev))
                ints.index_copy_(0, at, i)
            cols = _unblock(blk[:m])
            shards.append(SimState(
                **cols, types=ints[:m, 1].contiguous(),
                box=to_device(st.box, dev), step=st.step, tilted=st.tilted,
                noise_rows=(r, n)))
        thermostat = dict(st.thermostat or {})
        thermostat.pop("dof", None)
        return RowState(shards, rows, st.box, n, st.step, thermostat,
                        st.tilted, st.rng)

    # ------------------------------------------------------------------
    def needs_rebuild(self, slot_state, aux):
        """:meth:`SlotLayout.needs_rebuild`: each shard's largest drift
        over its home rows, the max taken on the first device."""
        st = slot_state
        d2 = []
        for s, (p, ref, g) in enumerate(zip(st.shards, aux["ref"],
                                            self.geoms(st))):
            H = self.home(s)
            if self.dynamic_box:
                d = _frac(p.positions[:H], g) - ref[:H]
                d = (d - torch.round(d)) * g.lengths
            else:
                d = g.wrap(p.positions[:H] - ref[:H])
            d2.append(torch.max(torch.sum(d * d, dim=-1)))
        d2 = self._first(d2).max()
        if self.dynamic_box:
            half_skin = torch.clamp_min(
                torch.min(self.geom(st).edges) - self.plan.r_cut, 0.0) / 2.0
        else:
            half_skin = max(self.plan.skin, 0.0) / 2.0
        return d2 >= (half_skin * 0.98) ** 2

    def ghost_pin(self, slot_state, aux):
        """Re-pin ghosts on every shard: zero velocity, parked at the cell
        center."""
        for p, v, g, (_, z0, nzl) in zip(slot_state.shards, aux["valid"],
                                         self.geoms(slot_state),
                                         self.slabs):
            v = v[:, None]
            p.positions = torch.where(v > 0, p.positions,
                                      g.slab_centers(z0, nzl))
            p.velocities = p.velocities * v
        return slot_state

    def mask_rows(self, forces4, virial, aux):
        """Zero force/energy/virial rows of ghost slots, per shard."""
        f = Shards(f * v[:, None] for f, v in zip(forces4, aux["valid"]))
        return f, (None if virial is None else Shards(
            w * v[:, None, None] for w, v in zip(virial, aux["valid"])))

    def planes(self, slot_state, aux):
        """:meth:`SlotLayout.planes` of every cell, each shard's home cells
        built on its device from the shards' home rows and joined in
        global slot order on the first shard's device
        (:func:`..ops.cellwise.sharded_planes`), bit for bit the whole
        state's."""
        st = slot_state
        return cw.sharded_planes(
            st.positions, st.types, aux["valid"], self.plan, self.mesh,
            [g.box for g in self.geoms(st)], self.shard_axis,
            rcut_matrix=self.rc2_tab)

    def pair_forces(self, slot_state, aux, pair_fn, **kw):
        """:func:`..ops.cellwise.resident_pair_forces` on the shards:
        ``(forces4, virial or None)`` as :class:`.state.Shards`."""
        st = slot_state
        f, w = cw.resident_pair_forces(
            st.positions, st.types, aux["valid"], self.plan, self.lo,
            pair_fn, self.mesh, self.geoms(st), self.shard_axis,
            rcut_matrix=self.rc2_tab, **kw)
        return Shards(f), None if w is None else Shards(w)

    # ------------------------------------------------------------------
    def rebuild(self, slot_state, aux):
        """The migrating repack, per shard (see the class): each shard
        sorts its window -- the previous shard's last home layer, its own
        home layers and the next shard's first home layer, in global slot
        order -- by the new cell of each real row and keeps the rows whose
        cell is one of its own; forces, virial and the carried model
        forces move with their particles (:meth:`SlotLayout.rebuild`)."""
        st, plan, n, L = slot_state, self.plan, self.n, self.layer
        nx, ny, nz = plan.grid
        cap, S = plan.capacity, len(self.slabs)
        carried = [k for k in ("mf", "mw") if aux.get(k) is not None]
        blks, ints = [], []
        for s, p in enumerate(st.shards):
            H = self.home(s)
            blks.append(_block(p, H, [aux[k][s][:H].reshape(H, -1)
                                      for k in carried]))
            ints.append(torch.stack([aux["orig"][s][:H], p.types[:H]],
                                    dim=1))
        geoms = self.geoms(st)
        bufs, flags, occs = [], [], []
        for s, (dev, z0, nzl) in enumerate(self.slabs):
            H = nzl * L
            prev = [to_device(t[(s - 1) % S][-L:], dev) for t in (blks, ints)]
            nxt = [to_device(t[(s + 1) % S][:L], dev) for t in (blks, ints)]
            home = [blks[s], ints[s]]
            # the window in global slot-row order: shard 0's previous rows
            # (the last shard's) come after its own, the last shard's next
            # rows (shard 0's) before them
            parts = ([home, nxt, prev] if s == 0 else
                     [nxt, prev, home] if s == S - 1 else
                     [prev, home, nxt])
            at_home = sum(q[0].shape[0] for q in
                          parts[:[q is home for q in parts].index(True)])
            wb = torch.cat([q[0] for q in parts])
            wi = torch.cat([q[1] for q in parts])
            W = wb.shape[0]
            has_w = wi[:, 0] < n
            cell = cw.bin_cells(wb[:, 0:3], self.lo, plan, geoms[s])
            zc = cell // (nx * ny)
            mine = has_w & (zc >= z0) & (zc < z0 + nzl)
            n_cells = nzl * nx * ny
            key = torch.where(mine, cell - z0 * nx * ny,
                              torch.full_like(cell, n_cells))
            # stable: equal cells keep the window's (global) row order
            sk, order = torch.sort(key, stable=True)
            idx = torch.arange(W, device=dev)
            seg = torch.ones(W, dtype=torch.bool, device=dev)
            seg[1:] = sk[1:] != sk[:-1]
            rank = idx - torch.cummax(
                torch.where(seg, idx, torch.zeros_like(idx)), dim=0).values
            sk = sk.long()
            real = sk < n_cells
            kept = real & (rank < cap)
            new_slot = torch.where(kept, sk * cap + torch.clamp_max(
                rank, cap - 1), torch.full_like(sk, H))
            src = torch.full((H + 1,), W, dtype=torch.int32, device=dev)
            src.scatter_(0, new_slot, order.to(torch.int32))
            src = src[:H]
            occs.append((torch.max(torch.where(
                real, rank, torch.full_like(rank, -1))) + 1).to(torch.int32))
            # a home row whose new cell no shard's window takes in: not its
            # own, and not the previous (next) shard's from its first (last)
            # home layer
            zn = zc[at_home:at_home + H]
            layer_of = torch.arange(H, device=dev) // L
            (_, zp, np_), (_, zq, nq) = (self.slabs[(s - 1) % S],
                                         self.slabs[(s + 1) % S])
            taken = (((zn >= z0) & (zn < z0 + nzl)) |
                     ((layer_of == 0) & (zn >= zp) & (zn < zp + np_)) |
                     ((layer_of == nzl - 1) & (zn >= zq) & (zn < zq + nq)))
            lost = has_w[at_home:at_home + H] & ~taken
            flags.append(torch.any(real & (rank >= cap)) | torch.any(lost))
            has = src < W
            h = has[:, None]
            at = torch.clamp(src, 0, W - 1).long()
            g, gi = wb[at], wi[at]
            centers = geoms[s].slab_centers(z0, nzl)[:H]
            cols = dict(
                positions=torch.where(h, g[:, 0:3], centers),
                velocities=torch.where(h, g[:, 3:6], 0.0),
                masses=torch.where(has, g[:, 6], 1.0),
                forces=torch.where(h, g[:, 7:11], 0.0),
                virial=torch.where(h, g[:, 11:20], 0.0).reshape(-1, 3, 3),
                orig=torch.where(has, gi[:, 0], n),
                types=torch.where(has, gi[:, 1], 0),
                valid=has.to(wb.dtype))
            col = _COLS
            for k in carried:
                w = aux[k][s][0].numel()
                cols[k] = torch.where(h, g[:, col:col + w], 0.0).reshape(
                    (H,) + tuple(aux[k][s].shape[1:]))
                col += w
            bufs.append(self._buffer(s, geoms[s], cols))
        overflow = aux["overflow"] | self._first(flags).any()
        occ = torch.maximum(aux["occ_max"], self._first(occs).max())
        return self._assemble(st, bufs, overflow, occ, aux["vmax"])


#: the float columns of :func:`_block`
_COLS = 20


def _block(p, rows=None, extra=()):
    """The float row fields of the :class:`.state.SimState` ``p`` (its
    first ``rows``) as one ``[rows, 20]`` block: positions, velocities,
    mass, forces4, virial; then the columns of ``extra``."""
    r = slice(rows)
    n = p.positions[r].shape[0]
    return torch.cat([p.positions[r], p.velocities[r], p.masses[r, None],
                      p.forces[r], p.virial[r].reshape(n, 9)] + list(extra),
                     dim=1)


def _unblock(blk, has=None):
    """:func:`_block`'s fields of ``blk`` (contiguous tensors); with
    ``has`` the mass of every other row 1."""
    masses = blk[:, 6] if has is None else torch.where(has, blk[:, 6], 1.0)
    return dict(positions=blk[:, 0:3].contiguous(),
                velocities=blk[:, 3:6].contiguous(),
                masses=masses.contiguous(),
                forces=blk[:, 7:11].contiguous(),
                virial=blk[:, 11:20].reshape(-1, 3, 3))


def _frac(positions, g):
    """:meth:`SlotLayout._ref` of ``positions`` in ``g``'s box: fractional
    coordinates reduced ``mod 1``."""
    f = cw._fractional(positions, g)
    return f - torch.floor(f)
