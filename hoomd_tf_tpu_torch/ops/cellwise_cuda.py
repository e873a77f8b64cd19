"""Kernel K1: the half-stencil (Newton's third law) pair-force kernel,
hand-written in CUDA C++ for Hopper (``csrc/cellwise_half.cu``).

PyTorch counterpart of ``hoomd_tf_tpu/ops/cellwise_pallas.py``, with the
same contract as its ``half_stencil_pair_forces``: the tensor code builds
the 14-block candidate planes (``_relative_coords``), the kernel does the
pair lanes and the dual reductions into one ``[n_cells, 14*cap]`` plane
per channel, and the tensor code applies the 13 inverse rolls
(``assemble_half``).

The Pallas kernel inlines any traced pair function. A CUDA kernel cannot
take an arbitrary torch function, so the port's kernel is templated on
one of two pair forms, each read from a table:

- :class:`LJForm`, ``U = 4 eps (sr6^2 - sr6) + shift`` with
  ``sr6 = (sigma^2 / r2)^3`` per type pair: a plain LJ,
  ``md.LennardJones`` with or without shift, and ``md.WCA``;
- :class:`ChebForm`, the Chebyshev proxy of :mod:`.chebyshev` (the form
  the JAX package inlines as its pair function for a
  ``PairModel(proxy_degree=...)``, ``cellwise_pallas.py:542-589``): a
  ``[P, 2, K]`` device table of the coefficients ``c`` and ``cd``, which
  training rewrites every step with no host copy.

A :class:`..models.pair.PairModel` opts in by returning its form from
``pair_kernel_form()``; a proxy model does so by itself.

The wrapper :func:`half_stencil_planes` launches the kernel for CUDA
tensors and uses the plain PyTorch version, :func:`half_stencil_reference`,
only for CPU tensors. The kernel is built with ``nvcc`` from the package's
own source at first use (``_build.py``).
"""

import ctypes

import numpy as np
import torch

from .cellwise import (_HALF_OFFS, _as_geometry, _channel_coefs,
                       _relative_coords, _roll_offs, assemble_half,
                       finish_forces, lane_sums)
from .chebyshev import proxy_lanes

__all__ = ["LJForm", "ChebForm", "half_stencil_planes",
           "half_stencil_reference", "half_stencil_pair_forces"]


class LJForm:
    """Per-type-pair table of the LJ-family pair form the kernel takes.

    :param epsilon, sigma2, shift, rc2: scalars or ``[T, T]`` arrays:
        well depth, squared size, energy shift added inside the form's
        cut, and the form's own squared cut (``inf`` for none).
    :param strict: cut with ``r2 < rc2`` (WCA) instead of ``<=``.
    """

    def __init__(self, epsilon, sigma2, shift=0.0, rc2=np.inf,
                 strict=False):
        parts = np.broadcast_arrays(*(np.asarray(v, dtype=np.float64)
                                      for v in (epsilon, sigma2, shift,
                                                rc2)))
        T = 1 if parts[0].ndim == 0 else parts[0].shape[0]
        self.ntypes = T
        self.table = np.stack([p.reshape(T, T) if p.ndim else
                               p.reshape(1, 1) for p in parts],
                              axis=-1).astype(np.float32)  # [T, T, 4]
        self.strict = bool(strict)
        self._on = {}

    def tensor(self, device):
        """The ``[T*T, 4]`` table on ``device`` (copied once, then
        cached: a host-to-device copy in the step loop is a host sync)."""
        device = torch.device(device)
        key = str(device)
        if key not in self._on:
            self._on[key] = torch.as_tensor(
                self.table.reshape(-1, 4), device=device).contiguous()
        return self._on[key]

    def evaluate(self, r2, ti=None, tj=None):
        """``(U, dU/dr2)`` per lane, in the same operation order as the
        kernel (the plain version of its pair function)."""
        tab = self.tensor(r2.device)
        if self.ntypes == 1:
            eps, sig2, shift, rc2 = tab[0]
        else:
            idx = ti.long() * self.ntypes + tj.long()
            eps, sig2, shift, rc2 = (tab[idx, k] for k in range(4))
        inv = 1.0 / r2
        x = sig2 * inv
        sr6 = x * x * x
        u = 4.0 * eps * (sr6 * sr6 - sr6) + shift
        du = -12.0 * eps * (2.0 * sr6 - 1.0) * sr6 * inv
        inside = (r2 < rc2) if self.strict else (r2 <= rc2)
        zero = torch.zeros((), dtype=r2.dtype, device=r2.device)
        return torch.where(inside, u, zero), torch.where(inside, du, zero)

    #: floats of shared memory the kernel stages for this form
    smem_floats = 0


class _PairRows:
    """``rows[k]`` is the lane tensor of term ``k`` of each lane's type
    pair (gathered on demand, so the plain version holds one lane tensor
    per term at a time)."""

    def __init__(self, col, p):
        self.col, self.p = col, p

    def __len__(self):
        return self.col.shape[1]

    def __getitem__(self, k):
        return self.col[:, k][self.p]


class ChebForm:
    """The Chebyshev-proxy pair form kernel K1 takes: the coefficients of
    a :func:`.chebyshev.make_pair_proxy` (or typed) evaluator as one
    ``[P, 2, K]`` float32 device table (``P = 1`` untyped, else one row
    per unordered type pair in :func:`.chebyshev.type_pairs` order).

    :param basis: the evaluator's ``.basis`` dict.
    :param coeffs: ``{"c", "cd"}`` tensors, ``[K]`` or ``[P, K]``; taken
        detached, on their own device.
    """

    def __init__(self, basis, coeffs):
        self.K = int(basis["K"])
        self.mid = float(basis["mid"])
        self.inv_half = float(basis["inv_half"])
        self.u_hi = float(basis["u_hi"])
        pairs = basis["pairs"]
        self.ntypes = 1 if pairs is None else max(b for _, b in pairs) + 1
        tab = torch.stack([coeffs["c"], coeffs["cd"]], dim=-2).detach()
        if pairs is None:
            tab = tab[None]
        self.table = tab.to(torch.float32).contiguous()      # [P, 2, K]
        P = self.table.shape[0]
        self.smem_floats = P * 2 * self.K + P * 2

    def tensor(self, device):
        if self.table.device != torch.device(device):
            raise ValueError(f"the coefficient table is on "
                             f"{self.table.device}, not {device}")
        return self.table

    def evaluate(self, r2, ti=None, tj=None):
        """``(U, dU/dr2)`` per lane, in the kernel's order of operations
        (the plain version of its pair function)."""
        tab = self.table.to(r2.device, r2.dtype)
        if self.ntypes == 1:
            c, cd = tab[0, 0], tab[0, 1]
        else:
            T = self.ntypes
            ti, tj = ti.long(), tj.long()
            known = (ti >= 0) & (ti < T) & (tj >= 0) & (tj < T)
            a, b = torch.minimum(ti, tj), torch.maximum(ti, tj)
            p = a * T - a * (a - 1) // 2 + (b - a)
            p = torch.where(known, p, torch.full_like(p, tab.shape[0]))
            # an extra zero row: types outside the table add nothing
            ext = torch.cat([tab, torch.zeros_like(tab[:1])])
            c, cd = _PairRows(ext[:, 0], p), _PairRows(ext[:, 1], p)
        return proxy_lanes(c, cd, r2, self.mid, self.inv_half, self.u_hi)


def half_stencil_reference(occ, gx, gy, gz, gt, form, cap, rc2, min_r2,
                           needs_energy=True, needs_virial=False,
                           rc2_tab=None):
    """Plain PyTorch version of the kernel, with the same outputs:
    ``[n_ch, n_cells, 14*cap]`` planes, block 0 the row-side sums (zero
    for rows at or above ``occ``), blocks 1..13 the weighted
    candidate-side sums."""
    n_cells = gx.shape[0]
    ti = None if gt is None else gt[:, :cap]
    rows, cols = lane_sums(
        gx[:, :cap], gy[:, :cap], gz[:, :cap], gx, gy, gz, ti, gt,
        form.evaluate, cap, rc2, min_r2, 0, needs_energy, needs_virial,
        rc2_tab=rc2_tab, occ=occ, typed_fn=gt is not None)
    coefs = _channel_coefs(needs_energy, needs_virial)
    out = torch.stack([torch.cat([rows[k] * fwd, cols[k][:, cap:] * back],
                                 dim=1)
                       for k, (fwd, back) in enumerate(coefs)])
    return out.reshape(len(coefs), n_cells, 14 * cap)


def half_stencil_planes(occ, gx, gy, gz, gt, form, cap, rc2, min_r2,
                        needs_energy=True, needs_virial=False,
                        rc2_tab=None):
    """Kernel K1. Launches the CUDA kernel on CUDA tensors (and counts the
    launch in ``half_stencil_planes.launches``, a proxy-form launch also
    in ``half_stencil_planes.proxy_launches``); CPU tensors take
    :func:`half_stencil_reference`. Anything else raises.

    :param occ: ``[n_cells]`` int32 occupancy.
    :param gx, gy, gz: ``[n_cells, 14*cap]`` float32 candidate planes.
    :param gt: ``[n_cells, 14*cap]`` int32 type plane, or ``None``.
    :param form: the :class:`LJForm` or :class:`ChebForm`.
    :param rc2_tab: ``[T, T]`` float32 squared cutoffs, or ``None``.
    :returns: ``[n_ch, n_cells, 14*cap]`` float32 planes.
    """
    typed = form.ntypes > 1 or rc2_tab is not None
    if typed and gt is None:
        raise ValueError("a typed form or rc2 table needs the type plane")
    if not gx.is_cuda:
        return half_stencil_reference(occ, gx, gy, gz, gt, form, cap, rc2,
                                      min_r2, needs_energy, needs_virial,
                                      rc2_tab)
    n_cells, C = gx.shape
    if C != 14 * cap:
        raise ValueError(f"planes are {C} wide, expected 14*cap={14 * cap}")
    _check(occ, (n_cells,), torch.int32, gx.device, "occ")
    for name, t in (("gx", gx), ("gy", gy), ("gz", gz)):
        _check(t, (n_cells, C), torch.float32, gx.device, name)
    if gt is not None:
        _check(gt, (n_cells, C), torch.int32, gx.device, "gt")
    tab = form.tensor(gx.device)
    if rc2_tab is not None:
        T = rc2_tab.shape[0]
        _check(rc2_tab, (T, T), torch.float32, gx.device, "rc2_tab")
    n_ch = len(_channel_coefs(needs_energy, needs_virial))
    lib = _library()
    smem = lib.htf_half_stencil_smem(cap, n_ch, form.smem_floats)
    if smem > _MAX_SMEM:
        raise ValueError(f"capacity {cap} needs {smem} bytes of shared "
                         f"memory per block, above {_MAX_SMEM}")
    out = torch.empty((n_ch, n_cells, C), dtype=torch.float32,
                      device=gx.device)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr() if t is not None else 0)
    rest = (ptr(rc2_tab), 0 if rc2_tab is None else rc2_tab.shape[0],
            n_cells, cap, float(rc2), float(min_r2), int(needs_energy),
            int(needs_virial), ptr(out),
            ctypes.c_void_p(torch.cuda.current_stream(gx.device).cuda_stream))
    if isinstance(form, ChebForm):
        err = lib.htf_half_stencil_cheb(
            ptr(occ), ptr(gx), ptr(gy), ptr(gz), ptr(gt), ptr(tab),
            form.ntypes, form.K, form.mid, form.inv_half, form.u_hi, *rest)
    else:
        err = lib.htf_half_stencil(
            ptr(occ), ptr(gx), ptr(gy), ptr(gz), ptr(gt), ptr(tab),
            form.ntypes, int(form.strict), *rest)
    if err != 0:
        raise RuntimeError("half-stencil kernel launch failed: " +
                           lib.htf_error_string(err).decode())
    half_stencil_planes.launches += 1
    if isinstance(form, ChebForm):
        half_stencil_planes.proxy_launches += 1
    return out


#: launches of the kernel, all forms; and of its Chebyshev-proxy form alone
half_stencil_planes.launches = 0
half_stencil_planes.proxy_launches = 0

# dynamic shared memory one H100 block may use (227 KB)
_MAX_SMEM = 232448


def _check(t, shape, dtype, device, name):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous {dtype} tensor of shape {shape} "
            f"on {device}, got {t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


_LIB = None


def _library():
    """The compiled kernel library (built from ``csrc/`` on first use)."""
    global _LIB
    if _LIB is None:
        from .._build import build_shared_library
        lib = ctypes.CDLL(str(build_shared_library("cellwise_half")))
        lib.htf_half_stencil.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p] +
            [ctypes.c_int] * 3 + [ctypes.c_float] * 2 +
            [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_void_p])
        lib.htf_half_stencil.restype = ctypes.c_int
        lib.htf_half_stencil_cheb.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 +
            [ctypes.c_float] * 3 + [ctypes.c_void_p] +
            [ctypes.c_int] * 3 + [ctypes.c_float] * 2 +
            [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_void_p])
        lib.htf_half_stencil_cheb.restype = ctypes.c_int
        lib.htf_half_stencil_smem.argtypes = [ctypes.c_int] * 3
        lib.htf_half_stencil_smem.restype = ctypes.c_long
        lib.htf_error_string.argtypes = [ctypes.c_int]
        lib.htf_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def half_stencil_pair_forces(positions, types, valid, plan, lo, form,
                             needs_virial=False, min_r2=1e-4, rc2_tab=None,
                             needs_energy=True, geometry=None):
    """Drop-in for :func:`.cellwise.analytic_pair_forces` computed by
    kernel K1 (same returns: ``forces4 [n_slots, 4]`` with the energy in
    column 4, and the ``[n_slots, 3, 3]`` virial or ``None``)."""
    geometry = _as_geometry(plan, lo, positions, geometry)
    n_cells, cap = plan.n_cells, plan.capacity
    _, _, _, gx, gy, gz = _relative_coords(positions, valid, plan, lo,
                                           _HALF_OFFS, geometry)
    gt = None
    if form.ntypes > 1 or rc2_tab is not None:
        gt = _roll_offs(types.to(torch.int32), plan, _HALF_OFFS)
    occ = valid.reshape(n_cells, cap).sum(dim=1).to(torch.int32)
    planes = half_stencil_planes(occ, gx, gy, gz, gt, form, cap,
                                 plan.r_cut ** 2, min_r2, needs_energy,
                                 needs_virial, rc2_tab)
    return finish_forces(assemble_half(planes, plan), valid, needs_energy,
                         needs_virial)
