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
(its evaluator carries a ``basis``); otherwise the generic lane
contraction, ``torch.autograd.grad`` of the weighted sum, which is the
CPU oracle. On a CUDA tensor a pair function with no basis raises: it
has no kernel in this slice of the port.

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
        basis = getattr(self.pair_apply, "basis", None)
        cuda = self.positions.is_cuda
        if cuda and self.positions.dtype != torch.float32:
            raise NotImplementedError(
                "float64 training on the card is not ported yet (kernel "
                "K2 is float32; float64 arrives with slice C)")
        if self.bwd_impl == "auto" and basis is not None and \
                _params_match_basis(params, basis) and \
                self.positions.dtype == torch.float32:
            from .pair_train_cuda import proxy_bwd_moments
            g_c, g_cd = proxy_bwd_moments(
                self.positions, self.types, self.valid, ct, self.plan,
                self.lo, basis, min_r2=self.min_r2,
                rc2_tab=self.rcut_matrix, needs_energy=self.needs_energy,
                geometry=self.geometry)
            grads = {"c": g_c, "cd": g_cd}
            return [grads[k].to(params[k].dtype) for k in params]
        if cuda:
            raise ValueError(
                "on a CUDA tensor the training backward runs in kernel K2, "
                "which needs a Chebyshev-proxy pair function "
                "(PairModel(proxy_degree=...)); this pair function has "
                "none. The generic lane contraction is the CPU oracle.")
        return self._contract(tensors, ct)

    def _contract(self, tensors, ct):
        """The generic lane contraction over the half lane set
        (``pair_train.py:161-233``)."""
        plan, positions = self.plan, self.positions
        dtype = positions.dtype
        n_cells, cap = plan.n_cells, plan.capacity
        offs_list = _HALF_OFFS
        C = len(offs_list) * cap
        geometry = _cw._as_geometry(plan, self.lo, positions, self.geometry)
        qx, qy, qz, gx, gy, gz = _relative_coords(
            positions, self.valid, plan, self.lo, offs_list, geometry)
        dx = gx[:, None, :] - qx.reshape(n_cells, cap)[:, :, None]
        dy = gy[:, None, :] - qy.reshape(n_cells, cap)[:, :, None]
        dz = gz[:, None, :] - qz.reshape(n_cells, cap)[:, :, None]
        d2 = dx * dx + dy * dy + dz * dz
        row = torch.arange(cap)[:, None]
        col = torch.arange(C)[None, :]
        not_self = ~((col < cap) & (col == row))[None]
        ok = (d2 <= plan.r_cut * plan.r_cut) & not_self
        ti = tj = None
        if self.with_types or self.rcut_matrix is not None:
            tt = self.types.to(dtype)
            ti = tt.reshape(n_cells, cap)[:, :, None]
            tj = _roll_offs(tt, plan, offs_list)[:, None, :]
        if self.rcut_matrix is not None:
            ok = ok & (d2 <= _cw.pair_rc2(ti, tj, self.rcut_matrix))
        r2 = torch.clamp_min(d2, self.min_r2)
        # the primal ends with `* valid`; fold it into the cotangent
        ctv = ct * self.valid[:, None]
        ctf = ctv[:, :3].reshape(n_cells, cap, 3)
        zero = torch.zeros((), dtype=dtype)
        wF = ctf[:, :, 0:1] * dx + ctf[:, :, 1:2] * dy + \
            ctf[:, :, 2:3] * dz
        wE = ctv[:, 3].reshape(n_cells, cap, 1) if self.needs_energy \
            else None
        # a directed block's lane carries both ordered pairs; the self
        # block (0) is evaluated from both rows already
        cg = [_roll_offs(ctv[:, k].contiguous(), plan,
                         offs_list)[:, None, :] for k in range(4)]
        directed = (torch.arange(C) >= cap).to(dtype)[None, None, :]
        wF = wF - directed * (cg[0] * dx + cg[1] * dy + cg[2] * dz)
        if wE is not None:
            wE = wE + directed * cg[3]
        wF = torch.where(ok, 2.0 * wF, zero)
        if wE is not None:
            wE = torch.where(ok, 0.5 * wE, zero)
        leaves = [t.detach().requires_grad_() for t in tensors]
        with torch.enable_grad():
            p = self.unflatten(leaves)
            if self.with_types:
                U, dU = self.pair_apply(p, r2, ti, tj)
            else:
                U, dU = self.pair_apply(p, r2)
            tot = torch.sum(wF * dU)
            if wE is not None:
                tot = tot + torch.sum(wE * U)
            grads = torch.autograd.grad(tot, leaves, allow_unused=True)
        return [torch.zeros_like(t) if g is None else g
                for t, g in zip(tensors, grads)]


def pair_train_forces(params, pair_apply, positions, types, valid, plan,
                      lo, *, min_r2=1e-4, with_types=False,
                      rcut_matrix=None, needs_energy=True,
                      fwd_stencil="auto", bwd_impl="auto", geometry=None):
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
    :param bwd_impl: ``'auto'`` (K2 for a proxy evaluator, else the
        generic contraction) or ``'generic'`` (the contraction; CPU
        only).
    :returns: ``forces4 [n_slots, 4]`` with the energy in column 4.
    """
    keys = list(params)
    if rcut_matrix is not None and not torch.is_tensor(rcut_matrix):
        rcut_matrix = _cw.rc2_table(rcut_matrix, positions.dtype,
                                    positions.device)
    run = _Run(keys, pair_apply, positions, types, valid, plan, lo, min_r2,
               with_types, rcut_matrix, needs_energy, fwd_stencil, bwd_impl,
               geometry)
    return _PairTrain.apply(run, *(params[k] for k in keys))
