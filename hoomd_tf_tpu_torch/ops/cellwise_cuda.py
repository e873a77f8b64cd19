"""Kernel K1: the half-stencil (Newton's third law) pair-force kernel,
hand-written in CUDA C++ for Hopper (``csrc/cellwise_half.cu``).

PyTorch counterpart of ``hoomd_tf_tpu/ops/cellwise_pallas.py``, with the
same contract as its ``half_stencil_pair_forces``: slot-ordered state in,
``forces4 [n_slots, 4]`` (energy in column 4) and the virial out. The
kernel gathers the occupied slots of each cell's 14 half-stencil cells
itself (``csrc/half_stencil_stage.cuh``) and a second launch adds the
Newton back sums home, so no candidate plane and no roll exists on the
card.

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

The wrapper :func:`half_stencil_pair_forces` launches the kernel for CUDA
tensors and takes the plain PyTorch version, :func:`half_stencil_plain`,
only for CPU tensors. The kernel is built with ``nvcc`` from the
package's own source at first use (``_build.py``).
"""

import ctypes
import functools

import numpy as np
import torch

from .cellwise import (_HALF_OFFS, _as_geometry, _channel_coefs,
                       analytic_pair_forces)
from .chebyshev import proxy_lanes

__all__ = ["LJForm", "ChebForm", "half_stencil_plain",
           "half_stencil_pair_forces"]


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


def half_stencil_plain(positions, types, valid, plan, lo, form,
                       needs_virial=False, min_r2=1e-4, rc2_tab=None,
                       needs_energy=True, geometry=None):
    """Plain PyTorch version of kernel K1, with the wrapper's contract: the
    Newton half-stencil tensor form (``_relative_coords``, ``lane_sums``,
    ``assemble_half``, ``finish_forces``) with ``form.evaluate`` as the
    pair function. Any ``valid`` pattern works: the tensor form pushes
    empty slots out of every cut by rank, as the kernel never stages
    them."""
    return analytic_pair_forces(
        positions, types, valid, plan, lo, form.evaluate,
        needs_virial=needs_virial, min_r2=min_r2,
        with_types=form.ntypes > 1, rcut_matrix=rc2_tab, stencil="half",
        needs_energy=needs_energy, geometry=geometry)


class _HalfGeom(ctypes.Structure):
    """``HalfGeom`` of ``csrc/half_stencil_stage.cuh``: the grid, the
    capacity, the float32 box lengths and, per half-stencil block, its
    integer cell offset and its float32 Cartesian offset."""
    _fields_ = [("nx", ctypes.c_int), ("ny", ctypes.c_int),
                ("nz", ctypes.c_int), ("cap", ctypes.c_int),
                ("lx", ctypes.c_float), ("ly", ctypes.c_float),
                ("lz", ctypes.c_float),
                ("off", (ctypes.c_int * 3) * len(_HALF_OFFS)),
                ("offf", (ctypes.c_float * 3) * len(_HALF_OFFS))]


@functools.lru_cache(maxsize=None)
def half_geom(plan):
    """The kernels' :class:`_HalfGeom` of ``plan``: the same constants,
    rounded to float32 the same way, as :class:`.cellwise.SlotGeometry`
    holds (``lengths``, ``offsets(_HALF_OFFS)``)."""
    ex, ey, ez = plan.edges
    offf = np.array([(ox * ex, oy * ey, oz * ez)
                     for (ox, oy, oz) in _HALF_OFFS]).astype(np.float32)
    g = _HalfGeom(*plan.grid, plan.capacity,
                  *np.asarray(plan.lengths, np.float32).tolist())
    for t, (o, f) in enumerate(zip(_HALF_OFFS, offf)):
        g.off[t][:] = o
        g.offf[t][:] = f.tolist()
    return g


def check_slot_inputs(positions, types, valid, plan):
    """Raise unless ``positions [n_slots, 3]``, ``types [n_slots]`` and
    ``valid [n_slots]`` fit ``plan`` and lie on one device."""
    n = plan.n_slots
    for name, t, shape in (("positions", positions, (n, 3)),
                           ("types", types, (n,)), ("valid", valid, (n,))):
        if tuple(t.shape) != shape or t.device != positions.device:
            raise ValueError(
                f"{name}: expected shape {shape} (n_slots = {n}) on "
                f"{positions.device}, got {tuple(t.shape)} on {t.device}")


def _check(t, shape, dtype, device, name):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous {dtype} tensor of shape {shape} "
            f"on {device}, got {t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


def cuda_slot_args(positions, types, valid, plan, geometry, typed):
    """Check the slot state a half-stencil kernel reads on the card and
    return its pointers: ``(positions, types or null, valid, centers)``."""
    dev = positions.device
    n = plan.n_slots
    _check(positions, (n, 3), torch.float32, dev, "positions")
    _check(valid, (n,), torch.float32, dev, "valid")
    _check(geometry.centers, (n, 3), torch.float32, dev, "geometry.centers")
    if typed:
        _check(types, (n,), torch.int32, dev, "types")
    return (_ptr(positions), _ptr(types if typed else None), _ptr(valid),
            _ptr(geometry.centers))


def _ptr(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def half_stencil_pair_forces(positions, types, valid, plan, lo, form,
                             needs_virial=False, min_r2=1e-4, rc2_tab=None,
                             needs_energy=True, geometry=None):
    """Kernel K1: :func:`.cellwise.analytic_pair_forces` of the pair form
    ``form`` on slot-resident state. Launches the kernel on CUDA tensors
    (counting each call in ``half_stencil_pair_forces.launches``, a
    proxy-form call also in ``.proxy_launches``); CPU tensors take
    :func:`half_stencil_plain`. Anything else raises.

    :param positions: ``[n_slots, 3]`` float32 slot positions.
    :param types: ``[n_slots]`` int32 types (read when the form is typed
        or ``rc2_tab`` is given).
    :param valid: ``[n_slots]`` float32, nonzero on occupied slots (any
        pattern within a cell).
    :param form: the :class:`LJForm` or :class:`ChebForm`.
    :param rc2_tab: ``[T, T]`` float32 squared cutoffs, or ``None``.
    :returns: ``(forces4 [n_slots, 4], virial [n_slots, 3, 3] or None)``,
        the energy in column 4 (zero when ``needs_energy`` is False);
        ghost rows all zero.
    """
    check_slot_inputs(positions, types, valid, plan)
    if not positions.is_cuda:
        return half_stencil_plain(positions, types, valid, plan, lo, form,
                                  needs_virial, min_r2, rc2_tab,
                                  needs_energy, geometry)
    geometry = _as_geometry(plan, lo, positions, geometry)
    dev = positions.device
    typed = form.ntypes > 1 or rc2_tab is not None
    state = cuda_slot_args(positions, types, valid, plan, geometry, typed)
    tab = form.tensor(dev)
    rc_t = 0
    if rc2_tab is not None:
        rc_t = rc2_tab.shape[0]
        _check(rc2_tab, (rc_t, rc_t), torch.float32, dev, "rc2_tab")
    n_ch = len(_channel_coefs(needs_energy, needs_virial))
    lib = _library()
    smem = lib.htf_half_stencil_smem(plan.capacity, n_ch, form.smem_floats)
    if smem > _MAX_SMEM:
        raise ValueError(f"capacity {plan.capacity} needs {smem} bytes of "
                         f"shared memory per block, above {_MAX_SMEM}")
    n = plan.n_slots
    sums = torch.empty((n_ch, len(_HALF_OFFS), n), dtype=torch.float32,
                       device=dev)
    forces4 = torch.empty((n, 4), dtype=torch.float32, device=dev)
    virial = (torch.empty((n, 3, 3), dtype=torch.float32, device=dev)
              if needs_virial else None)
    geom = ctypes.byref(half_geom(plan))
    rest = (_ptr(rc2_tab), rc_t, float(plan.r_cut ** 2), float(min_r2),
            int(needs_energy), int(needs_virial), _ptr(sums), _ptr(forces4),
            _ptr(virial),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if isinstance(form, ChebForm):
        err = lib.htf_half_stencil_cheb(
            *state, geom, plan.n_cells, _ptr(tab), form.ntypes, form.K,
            form.mid, form.inv_half, form.u_hi, *rest)
    else:
        err = lib.htf_half_stencil(*state, geom, plan.n_cells, _ptr(tab),
                                   form.ntypes, int(form.strict), *rest)
    if err != 0:
        raise RuntimeError("half-stencil kernel launch failed: " +
                           lib.htf_error_string(err).decode())
    half_stencil_pair_forces.launches += 1
    if isinstance(form, ChebForm):
        half_stencil_pair_forces.proxy_launches += 1
    return forces4, virial


#: calls that launched the kernel (two launches each), all forms; and those
#: of its Chebyshev-proxy form alone
half_stencil_pair_forces.launches = 0
half_stencil_pair_forces.proxy_launches = 0

# dynamic shared memory one H100 block may use (227 KB)
_MAX_SMEM = 232448

_LIB = None


def _library():
    """The compiled kernel library (built from ``csrc/`` on first use)."""
    global _LIB
    if _LIB is None:
        from .._build import build_shared_library
        lib = ctypes.CDLL(str(build_shared_library("cellwise_half")))
        state = [ctypes.c_void_p] * 5 + [ctypes.c_int]
        rest = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_float] * 2 +
                [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4)
        lib.htf_half_stencil.argtypes = (
            state + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + rest)
        lib.htf_half_stencil.restype = ctypes.c_int
        lib.htf_half_stencil_cheb.argtypes = (
            state + [ctypes.c_void_p] + [ctypes.c_int] * 2 +
            [ctypes.c_float] * 3 + rest)
        lib.htf_half_stencil_cheb.restype = ctypes.c_int
        lib.htf_half_stencil_smem.argtypes = [ctypes.c_int] * 3
        lib.htf_half_stencil_smem.restype = ctypes.c_long
        lib.htf_error_string.argtypes = [ctypes.c_int]
        lib.htf_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB
