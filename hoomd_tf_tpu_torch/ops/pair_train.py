"""Online-training pair forces with a hand-written backward (PyTorch port
of ``hoomd_tf_tpu/ops/pair_train.py``).

With ``F_i = 2 sum_j U'(r2_ij) d_ij`` and ``E_i = 0.5 sum_j U(r2_ij)``,
the gradient of ``<ct, F4>`` in the pair function's parameters is the
gradient of ONE weighted scalar lane sum,

    sum_lanes ok_ij * [wF_ij * dU'(r2_ij)/dtheta + wE_ij * dU(r2_ij)/dtheta]

with per-lane weights that are pure data (the Newton-combined
``wF = 2 (ct_i - ct_j) . d`` and ``wE = 0.5 (cte_i + cte_j)`` on the half
lane set). Nothing of the stencil rolls or the dual reductions is ever
differentiated, and the forward runs on the fastest primal: kernel K1 on
a CUDA tensor, the tensor stencil on a CPU one.

The backward takes kernel K2 (:mod:`.pair_train_cuda`) when the pair
function is a Chebyshev proxy whose coefficients are the parameters
(its evaluator carries a ``basis``). Any other pair function takes the
list route on a CUDA tensor: K1's generic form lists the lanes, the pair
function runs once on the list with grad, and the reduction's backward
is the kernel ``generic_reduce_bwd``, whose per-lane cotangents are
exactly the weights above (:func:`.cellwise_cuda.generic_train_forces`);
autograd carries them through the pair function into the weights. On
the CPU the generic lane contraction, ``torch.autograd.grad`` of the
weighted sum, is the oracle; ``bwd_impl='list'`` takes the list route's
plain version there.

On a slot state resident per z-slab shard of a mesh (the engine's
training under ``Simulation(mesh=)``, :class:`..md.slots.SlabSlots`),
:func:`resident_train_forces` takes each shard's own buffers and runs
once per device over the home cells of its shards (the shards
partitioned by device, :func:`.cellwise.slab_groups`): the forward is
:func:`.cellwise.resident_pair_forces` (one group call of K1 a device,
in the proxy form or the generic form); a proxy's backward is one K2
group launch pair a device on the members' buffers in place, where a
shard whose next shard lies on another device reads, in its halo rows,
that shard's first home layer of the forces' cotangent (the backward of
the forward's reverse-halo add); the list route lists once a device,
runs the pair function once on the joined list with grad and takes
``generic_reduce_bwd`` over the group
(:func:`.cellwise_cuda.generic_group_train_forces`) as the group call
of :func:`.cellwise.resident_pair_forces`; the CPU contraction runs per shard on its slab
buffer. The devices' gradients are summed on the first shard's device
in device order. Each unordered pair belongs to one home cell's half
stencil, so the sum is the whole state's gradient, and nothing of the
whole state is made. :func:`pair_train_forces` with ``mesh=`` (the JAX
signature) splits a whole state into those buffers and joins the home
rows of the result.

Geometry inputs (positions, types, validity) get no gradient: neighbor
membership is piecewise constant and training never differentiates the
state.
"""

import dataclasses

import torch

from .._device import to_device
from . import cellwise as _cw
from .cellwise import _HALF_OFFS, _roll_offs, half_frame

__all__ = ["pair_train_forces"]


def _params_match_basis(params, basis):
    """Are ``params`` exactly the proxy coefficients K2 returns gradients
    for? (``{"c": [K], "cd": [K]}`` untyped, ``[P, K]`` each typed.)"""
    if not (isinstance(params, dict) and set(params) == {"c", "cd"}):
        return False
    K = basis["K"]
    shape = (K,) if basis["pairs"] is None else (len(basis["pairs"]), K)
    return all(torch.is_tensor(params[k]) and
               tuple(params[k].shape) == shape for k in ("c", "cd"))


class _PairTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, *tensors):
        ctx.run = run
        ctx.save_for_backward(*tensors)
        return run.forward([t.detach() for t in tensors])

    @staticmethod
    def backward(ctx, *cts):
        return (None,) + tuple(ctx.run.backward(list(ctx.saved_tensors),
                                                *cts))


@dataclasses.dataclass
class _Run:
    """The constants of one :func:`pair_train_forces` call."""
    keys: list
    pair_apply: object
    positions: torch.Tensor
    types: torch.Tensor
    valid: torch.Tensor
    plan: object
    lo: object
    min_r2: float
    with_types: bool
    rcut_matrix: object
    needs_energy: bool
    fwd_stencil: str
    bwd_impl: str
    geometry: object

    @property
    def dtype(self):
        return self.positions.dtype

    def unflatten(self, tensors):
        return dict(zip(self.keys, tensors))

    def bind(self, p):
        if self.with_types:
            return lambda r2, ti, tj: self.pair_apply(p, r2, ti, tj)
        return lambda r2: self.pair_apply(p, r2)

    @staticmethod
    def on_device(p, device):
        """The parameters ``p`` on a shard's ``device`` (differentiable
        copies where they lie elsewhere)."""
        return {k: v if v.device == device else to_device(v, device)
                for k, v in p.items()}

    def form(self, p):
        """The evaluator's kernel form of ``p`` for K1, or ``None``."""
        if self.fwd_stencil in ("auto", "kernel") and \
                hasattr(self.pair_apply, "kernel_form"):
            return self.pair_apply.kernel_form(p)
        return None

    def forward(self, tensors):
        p = self.unflatten(tensors)
        f4, _ = _cw.analytic_pair_forces(
            self.positions, self.types, self.valid, self.plan, self.lo,
            self.bind(p), needs_virial=False, min_r2=self.min_r2,
            with_types=self.with_types, rcut_matrix=self.rcut_matrix,
            stencil=self.fwd_stencil, needs_energy=self.needs_energy,
            form=self.form(p), geometry=self.geometry)
        return f4

    def backward(self, tensors, ct):
        params = self.unflatten(tensors)
        if self.uses_k2(params):
            return self._k2(params, self.positions, self.types, self.valid,
                            ct, self.geometry, self.rcut_matrix, None)
        return self._contract(tensors, ct)

    def _k2(self, params, positions, types, valid, ct, geometry, rc,
            group):
        """The proxy coefficients' gradients by kernel K2 over the whole
        state (``group`` ``None``) or over a group's members' buffers
        (lists, on its device)."""
        from .pair_train_cuda import proxy_bwd_moments
        g_c, g_cd = proxy_bwd_moments(
            positions, types, valid, ct, self.plan, self.lo,
            self.pair_apply.basis, min_r2=self.min_r2, rc2_tab=rc,
            needs_energy=self.needs_energy, geometry=geometry, group=group)
        grads = {"c": g_c, "cd": g_cd}
        return [grads[k].to(params[k].dtype) for k in params]

    def uses_k2(self, params):
        """Does the backward run in kernel K2 (a Chebyshev proxy whose
        coefficients are the parameters; float32, or float64 in its double
        instantiation)?"""
        basis = getattr(self.pair_apply, "basis", None)
        return (self.bwd_impl == "auto" and basis is not None and
                _params_match_basis(params, basis) and
                self.dtype in (torch.float32, torch.float64))

    def _contract(self, tensors, ct, chunk_lanes=None, slab=None):
        """The generic lane contraction over the half lane set
        (``pair_train.py:161-233``), in chunks of cells of about
        ``chunk_lanes`` lanes (default ``_CONTRACT_LANES``), the weights'
        gradients summed: over the whole state, or with ``slab = (
        positions, types, valid, geometry, rc2 table, (z0, nzl))`` over a
        z-slab shard's home cells from its slab buffers (``ct`` cut so
        too), on their device."""
        plan = self.plan
        if slab is None:
            positions, types, valid = self.positions, self.types, self.valid
            geometry, rcut_matrix = self.geometry, self.rcut_matrix
        else:
            positions, types, valid, geometry, rcut_matrix, slab = slab
        dtype, dev = positions.dtype, positions.device
        cap = plan.capacity
        C = len(_HALF_OFFS) * cap
        rp, n_cells, qx, qy, qz, gx, gy, gz = half_frame(
            positions, valid, plan, self.lo, geometry, slab)

        def rows(t, *shape):
            return t[:n_cells * cap].reshape(n_cells, cap, *shape)

        def roll(t):
            return _roll_offs(t.contiguous(), rp, _HALF_OFFS)[:n_cells]

        qx, qy, qz = (rows(q) for q in (qx, qy, qz))
        col = torch.arange(C, device=dev)[None, :]
        not_self = ~((col < cap) &
                     (col == torch.arange(cap, device=dev)[:, None]))[None]
        directed = (col >= cap).to(dtype)[None]
        ti_all = tj_all = None
        if self.with_types or rcut_matrix is not None:
            tt = types.to(dtype)
            ti_all = rows(tt)[:, :, None]
            tj_all = roll(tt)[:, None, :]
        # the primal ends with `* valid`; fold it into the cotangent
        ctv = ct * valid[:, None]
        ctf = rows(ctv[:, :3], 3)
        cte = rows(ctv[:, 3], 1)
        # a directed block's lane carries both ordered pairs; the self
        # block (0) is evaluated from both rows already
        cg = [roll(ctv[:, k])[:, None, :] for k in range(4)]
        zero = torch.zeros((), dtype=dtype, device=dev)
        leaves = [to_device(t.detach(), dev).requires_grad_()
                  for t in tensors]
        grads = [torch.zeros_like(t) for t in tensors]
        chunk_lanes = chunk_lanes or _CONTRACT_LANES
        step = max(1, chunk_lanes // (cap * C))
        for a in range(0, n_cells, step):
            c = slice(a, min(n_cells, a + step))
            dx = gx[c, None, :] - qx[c, :, None]
            dy = gy[c, None, :] - qy[c, :, None]
            dz = gz[c, None, :] - qz[c, :, None]
            d2 = dx * dx + dy * dy + dz * dz
            ok = (d2 <= plan.r_cut * plan.r_cut) & not_self
            ti = None if ti_all is None else ti_all[c]
            tj = None if tj_all is None else tj_all[c]
            if rcut_matrix is not None:
                ok = ok & (d2 <= _cw.pair_rc2(ti, tj, rcut_matrix))
            r2 = torch.clamp_min(d2, self.min_r2)
            wF = (ctf[c, :, 0:1] * dx + ctf[c, :, 1:2] * dy +
                  ctf[c, :, 2:3] * dz)
            wF = wF - directed * (cg[0][c] * dx + cg[1][c] * dy +
                                  cg[2][c] * dz)
            wF = torch.where(ok, 2.0 * wF, zero)
            wE = None
            if self.needs_energy:
                wE = torch.where(ok, 0.5 * (cte[c] + directed * cg[3][c]),
                                 zero)
            with torch.enable_grad():
                p = self.unflatten(leaves)
                if self.with_types:
                    U, dU = self.pair_apply(p, r2, ti, tj)
                else:
                    U, dU = self.pair_apply(p, r2)
                tot = torch.sum(wF * dU)
                if wE is not None:
                    tot = tot + torch.sum(wE * U)
                part = torch.autograd.grad(tot, leaves, allow_unused=True)
            grads = [g if q is None else g + q for g, q in zip(grads, part)]
        return grads


# lanes of one chunk of the lane contraction ([cells, cap, 14 cap])
_CONTRACT_LANES = 1 << 24


@dataclasses.dataclass
class _ResidentRun(_Run):
    """The constants of one :func:`resident_train_forces` call:
    ``positions``, ``types``, ``valid`` and ``geometry`` are each shard's
    (lists in shard order), ``slabs`` the mesh's ``(device, z0, nzl)``."""
    mesh: object = None
    shard_axis: object = None
    slabs: list = None

    @property
    def dtype(self):
        return self.positions[0].dtype

    @property
    def layer(self):
        return _cw.halo_layer(self.plan)

    def forward(self, tensors):
        p = self.unflatten(tensors)
        fs, _ = _cw.resident_pair_forces(
            self.positions, self.types, self.valid, self.plan, self.lo,
            self.bind(p), self.mesh, self.geometry, self.shard_axis,
            min_r2=self.min_r2, with_types=self.with_types,
            rcut_matrix=self.rcut_matrix, stencil=self.fwd_stencil,
            needs_energy=self.needs_energy, form=self.form(p),
            shard_fn=lambda dev: self.bind(self.on_device(p, dev)))
        return tuple(fs)

    def with_halo(self, ts, s):
        """Shard ``s``'s buffer of the per-shard ``ts`` with the next
        shard's first home layer in its halo rows (of the forces'
        cotangent: where the forward's reverse halo was added), a new
        tensor: the callers' tensors stay as they are."""
        L, dev = self.layer, ts[s].device
        return torch.cat([ts[s][:-L], to_device(ts[(s + 1) % len(ts)][:L],
                                                dev)])

    def backward(self, tensors, *cts):
        params = self.unflatten(tensors)
        if self.uses_k2(params):
            # one launch pair a device over its members' buffers in place;
            # a member whose next shard is on another device reads that
            # shard's first layer of the cotangent in its halo rows
            parts = []
            for g in _cw.slab_groups(self.slabs):
                m = g.members
                ct = [self.with_halo(cts, s) if n < 0 else cts[s]
                      for s, n in zip(m, g.next)]
                rc = (None if self.rcut_matrix is None else
                      to_device(self.rcut_matrix, g.device))
                parts.append(self._k2(
                    params, [self.positions[s] for s in m],
                    [self.types[s] for s in m], [self.valid[s] for s in m],
                    ct, self.geometry[m[0]], rc, g))
        else:
            # the CPU's oracle: the lane contraction per shard on its slab
            # buffer (the next shard's first layer in its halo rows)
            parts = []
            for s, (dev, z0, nzl) in enumerate(self.slabs):
                rc = (None if self.rcut_matrix is None else
                      to_device(self.rcut_matrix, dev))
                parts.append(self._contract(
                    tensors, self.with_halo(cts, s), slab=(
                        *(self.with_halo(t, s) for t in (
                            self.positions, self.types, self.valid)),
                        self.geometry[s], rc, (z0, nzl))))
        primary = self.positions[0].device
        grads = None
        for part in parts:
            part = [to_device(g, primary) for g in part]
            grads = part if grads is None else [
                a + b for a, b in zip(grads, part)]
        return grads


def _rc2_table(rcut_matrix, dtype, device):
    if rcut_matrix is None or torch.is_tensor(rcut_matrix):
        return rcut_matrix
    return _cw.rc2_table(rcut_matrix, dtype, device)


def _uses_list(run, params, bwd_impl):
    """Does this call take the list route (K1's generic form with
    ``generic_reduce_bwd``)?"""
    cuda = (run.positions[0] if isinstance(run, _ResidentRun) else
            run.positions).is_cuda
    if bwd_impl == "list" or (cuda and bwd_impl == "auto" and
                              not run.uses_k2(params)):
        return True
    if cuda and bwd_impl == "generic":
        raise ValueError("the generic lane contraction is the CPU oracle; "
                         "on a CUDA tensor training takes K2 or the list "
                         "route")
    return False


def pair_train_forces(params, pair_apply, positions, types, valid, plan,
                      lo, *, min_r2=1e-4, with_types=False,
                      rcut_matrix=None, needs_energy=True,
                      fwd_stencil="auto", bwd_impl="auto", geometry=None,
                      lanes=None, mesh=None, shard_axis=None):
    """Analytic pair forces, differentiable in ``params`` only.

    :param params: a dict of tensors, the only differentiable input (for
        a proxy: its ``{"c", "cd"}`` coefficients).
    :param pair_apply: ``pair_apply(params, r2[, ti, tj]) -> (U, dU/dr2)``
        (symmetric under ``(ti, tj)`` swap). A Chebyshev-proxy evaluator
        (:mod:`.chebyshev`) carries ``basis`` and ``kernel_form``.
    :param positions, types, valid: slot state (constants).
    :param plan, lo: the cellwise plan and box corner.
    :param rcut_matrix: per-type-pair cutoffs (numpy, or a
        :func:`.cellwise.rc2_table` tensor).
    :param needs_energy: compute (and differentiate) the energy column.
    :param fwd_stencil: the primal's stencil (see
        :func:`.cellwise.analytic_pair_forces`; ``'auto'`` is K1 on CUDA,
        with the evaluator's ``kernel_form(params)``).
    :param bwd_impl: ``'auto'`` (K2 for a proxy evaluator; else the list
        route on a CUDA tensor and the generic contraction on a CPU one),
        ``'generic'`` (the contraction; CPU only) or ``'list'`` (the list
        route; its plain version on the CPU).
    :param lanes: the list route's :class:`.cellwise_cuda.LaneBudget`
        (default: sized from this call's occupied slots, one host sync;
        under a mesh each shard's list holds ``lanes.budget`` lanes and
        the most any group needed is recorded in it).
    :param mesh: a :class:`..parallel.mesh.Mesh` (or ``None``): with two
        shards or more the state is split into each z-slab shard's slab
        buffer on its device (a copy) and the call runs as
        :func:`resident_train_forces` does; the home rows of the shards'
        forces are joined on the state's device. ``pair_apply`` is then
        also called with ``params`` copied to a shard's device.
    :param shard_axis: the mesh axis of the shards (default its only one).
    :returns: ``forces4 [n_slots, 4]`` with the energy in column 4.
    """
    rcut_matrix = _rc2_table(rcut_matrix, positions.dtype, positions.device)
    kw = dict(min_r2=min_r2, with_types=with_types, rcut_matrix=rcut_matrix,
              needs_energy=needs_energy, fwd_stencil=fwd_stencil,
              bwd_impl=bwd_impl, lanes=lanes)
    if mesh is not None and \
            mesh.shape[shard_axis or mesh.axis_names[0]] > 1:
        slabs = _cw.mesh_slabs(plan, mesh, shard_axis)
        geometry = _cw._as_geometry(plan, lo, positions, geometry)
        fs = resident_train_forces(
            params, pair_apply,
            *(_cw.slab_split(t, plan, slabs) for t in (positions, types,
                                                       valid)),
            plan, lo, mesh, [geometry.on(dev) for dev, _, _ in slabs],
            shard_axis=shard_axis, **kw)
        return _cw.slab_join(fs, plan, slabs, positions.device)
    keys = list(params)
    run = _Run(keys, pair_apply, positions, types, valid, plan, lo, min_r2,
               with_types, rcut_matrix, needs_energy, fwd_stencil, bwd_impl,
               geometry)
    if _uses_list(run, params, bwd_impl):
        from .cellwise_cuda import generic_train_forces
        return generic_train_forces(
            positions, types, valid, plan, lo, run.bind(params),
            typed_fn=with_types, min_r2=min_r2, rc2_tab=rcut_matrix,
            needs_energy=needs_energy, geometry=geometry, lanes=lanes)
    return _PairTrain.apply(run, *(params[k] for k in keys))


def resident_train_forces(params, pair_apply, positions, types, valid, plan,
                          lo, mesh, geometries, *, shard_axis=None,
                          min_r2=1e-4, with_types=False, rcut_matrix=None,
                          needs_energy=True, fwd_stencil="auto",
                          bwd_impl="auto", lanes=None):
    """:func:`pair_train_forces` on a slot state resident per z-slab shard
    of ``mesh`` (:class:`..md.slots.SlabSlots`; see the module
    docstring): each device's group call reads its shards' own buffers,
    and nothing of the whole state is made.

    :param positions, types, valid: each shard's buffer, in shard order:
        ``(nzl + 1) nx ny cap`` rows on its device, its home layers then
        its forward halo layer (:func:`.cellwise.slab_rows`; the forward
        writes a halo's positions where the next shard lies on another
        device, as :func:`.cellwise.resident_pair_forces` does).
    :param geometries: each shard's :class:`.cellwise.SlotGeometry` of
        the global plan on its device.
    :param lanes: as :func:`pair_train_forces`' (each group's list holds
        ``lanes.budget`` lanes a member; the most any group needed is
        recorded in it, on the first shard's device).
    :returns: each shard's ``forces4`` (a list in shard order, its
        buffer's rows, the halo rows zero), differentiable in ``params``.
    """
    keys = list(params)
    rcut_matrix = _rc2_table(rcut_matrix, positions[0].dtype,
                             positions[0].device)
    run = _ResidentRun(keys, pair_apply, list(positions), list(types),
                       list(valid), plan, lo, min_r2, with_types, rcut_matrix,
                       needs_energy, fwd_stencil, bwd_impl, list(geometries),
                       mesh, shard_axis,
                       _cw.mesh_slabs(plan, mesh, shard_axis))
    if _uses_list(run, params, bwd_impl):
        return _resident_list_forces(run, params, lanes)
    return list(_PairTrain.apply(run, *(params[k] for k in keys)))


def _resident_list_forces(run, params, lanes):
    """The list route on the resident shards: per device one list over its
    shards' home cells on their buffers, the pair function (under the
    parameters copied there) run once on the joined list with grad, and
    ``generic_reduce_bwd`` over the group as its backward
    (:func:`.cellwise_cuda.generic_group_train_forces`), as the group call
    of :func:`.cellwise.resident_pair_forces`, which exchanges the halo
    between devices."""
    from .cellwise_cuda import LaneBudget, generic_group_train_forces
    primary = run.positions[0].device

    def group_call(bufs, g, geometry):
        dev = g.device
        rc = (None if run.rcut_matrix is None else
              to_device(run.rcut_matrix, dev))
        own = None if lanes is None else LaneBudget(lanes.budget, dev)
        f4 = generic_group_train_forces(
            *bufs, run.plan, run.lo, run.bind(run.on_device(params, dev)), g,
            typed_fn=run.with_types, min_r2=run.min_r2, rc2_tab=rc,
            needs_energy=run.needs_energy, geometry=geometry, lanes=own)
        if lanes is not None:
            lanes.record(to_device(own.needed, primary))
        return f4
    fs, _ = _cw.resident_pair_forces(
        run.positions, run.types, run.valid, run.plan, run.lo, None,
        run.mesh, run.geometry, run.shard_axis, group_call=group_call)
    return fs
