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

Geometry inputs (positions, types, validity) get no gradient: neighbor
membership is piecewise constant and training never differentiates the
state.
"""

import dataclasses

import torch

from . import cellwise as _cw
from .cellwise import _HALF_OFFS, _relative_coords, _roll_offs

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
    def backward(ctx, ct):
        return (None,) + tuple(ctx.run.backward(list(ctx.saved_tensors),
                                                ct))


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

    def unflatten(self, tensors):
        return dict(zip(self.keys, tensors))

    def bind(self, p):
        if self.with_types:
            return lambda r2, ti, tj: self.pair_apply(p, r2, ti, tj)
        return lambda r2: self.pair_apply(p, r2)

    def forward(self, tensors):
        p = self.unflatten(tensors)
        form = None
        if self.fwd_stencil in ("auto", "kernel") and \
                hasattr(self.pair_apply, "kernel_form"):
            form = self.pair_apply.kernel_form(p)
        f4, _ = _cw.analytic_pair_forces(
            self.positions, self.types, self.valid, self.plan, self.lo,
            self.bind(p), needs_virial=False, min_r2=self.min_r2,
            with_types=self.with_types, rcut_matrix=self.rcut_matrix,
            stencil=self.fwd_stencil, needs_energy=self.needs_energy,
            form=form, geometry=self.geometry)
        return f4

    def backward(self, tensors, ct):
        params = self.unflatten(tensors)
        if self.uses_k2(params):
            from .pair_train_cuda import proxy_bwd_moments
            g_c, g_cd = proxy_bwd_moments(
                self.positions, self.types, self.valid, ct, self.plan,
                self.lo, self.pair_apply.basis, min_r2=self.min_r2,
                rc2_tab=self.rcut_matrix, needs_energy=self.needs_energy,
                geometry=self.geometry)
            grads = {"c": g_c, "cd": g_cd}
            return [grads[k].to(params[k].dtype) for k in params]
        return self._contract(tensors, ct)

    def uses_k2(self, params):
        """Does the backward run in kernel K2 (a Chebyshev proxy whose
        coefficients are the parameters; float32, or float64 in its double
        instantiation)?"""
        basis = getattr(self.pair_apply, "basis", None)
        return (self.bwd_impl == "auto" and basis is not None and
                _params_match_basis(params, basis) and
                self.positions.dtype in (torch.float32, torch.float64))

    def _contract(self, tensors, ct, chunk_lanes=None):
        """The generic lane contraction over the half lane set
        (``pair_train.py:161-233``), in chunks of cells of about
        ``chunk_lanes`` lanes (default ``_CONTRACT_LANES``), the weights'
        gradients summed."""
        plan, positions = self.plan, self.positions
        dtype, dev = positions.dtype, positions.device
        n_cells, cap = plan.n_cells, plan.capacity
        offs_list = _HALF_OFFS
        C = len(offs_list) * cap
        geometry = _cw._as_geometry(plan, self.lo, positions, self.geometry)
        qx, qy, qz, gx, gy, gz = _relative_coords(
            positions, self.valid, plan, self.lo, offs_list, geometry)
        qx, qy, qz = (q.reshape(n_cells, cap) for q in (qx, qy, qz))
        col = torch.arange(C, device=dev)[None, :]
        not_self = ~((col < cap) &
                     (col == torch.arange(cap, device=dev)[:, None]))[None]
        directed = (col >= cap).to(dtype)[None]
        ti_all = tj_all = None
        if self.with_types or self.rcut_matrix is not None:
            tt = self.types.to(dtype)
            ti_all = tt.reshape(n_cells, cap)[:, :, None]
            tj_all = _roll_offs(tt, plan, offs_list)[:, None, :]
        # the primal ends with `* valid`; fold it into the cotangent
        ctv = ct * self.valid[:, None]
        ctf = ctv[:, :3].reshape(n_cells, cap, 3)
        cte = ctv[:, 3].reshape(n_cells, cap, 1)
        # a directed block's lane carries both ordered pairs; the self
        # block (0) is evaluated from both rows already
        cg = [_roll_offs(ctv[:, k].contiguous(), plan,
                         offs_list)[:, None, :] for k in range(4)]
        zero = torch.zeros((), dtype=dtype, device=dev)
        leaves = [t.detach().requires_grad_() for t in tensors]
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
            if self.rcut_matrix is not None:
                ok = ok & (d2 <= _cw.pair_rc2(ti, tj, self.rcut_matrix))
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


def pair_train_forces(params, pair_apply, positions, types, valid, plan,
                      lo, *, min_r2=1e-4, with_types=False,
                      rcut_matrix=None, needs_energy=True,
                      fwd_stencil="auto", bwd_impl="auto", geometry=None,
                      lanes=None):
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
        (default: sized from this call's occupied slots, one host sync).
    :returns: ``forces4 [n_slots, 4]`` with the energy in column 4.
    """
    keys = list(params)
    if rcut_matrix is not None and not torch.is_tensor(rcut_matrix):
        rcut_matrix = _cw.rc2_table(rcut_matrix, positions.dtype,
                                    positions.device)
    run = _Run(keys, pair_apply, positions, types, valid, plan, lo, min_r2,
               with_types, rcut_matrix, needs_energy, fwd_stencil, bwd_impl,
               geometry)
    cuda = positions.is_cuda
    if bwd_impl == "list" or (cuda and bwd_impl == "auto" and
                              not run.uses_k2(params)):
        from .cellwise_cuda import generic_train_forces
        return generic_train_forces(
            positions, types, valid, plan, lo, run.bind(params),
            typed_fn=with_types, min_r2=min_r2, rc2_tab=rcut_matrix,
            needs_energy=needs_energy, geometry=geometry, lanes=lanes)
    if cuda and bwd_impl == "generic":
        raise ValueError("the generic lane contraction is the CPU oracle; "
                         "on a CUDA tensor training takes K2 or the list "
                         "route")
    return _PairTrain.apply(run, *(params[k] for k in keys))
