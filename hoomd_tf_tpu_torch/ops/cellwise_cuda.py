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

Any other pair function takes K1's generic form,
:func:`generic_pair_forces` (``csrc/cellwise_generic.cu``): a list kernel
writes the in-cut lanes ``(r2, ti, tj)``, PyTorch evaluates the pair
function on the list (the counterpart of the jaxpr the Pallas kernel
inlines), and a reduction kernel makes K1's dual reduction from each
lane's ``(U, dU/dr2)``. The list is sized by a :class:`LaneBudget`; a
call that needs more lanes than it holds is seen in ``lanes.needed``
with no host sync, and the engine re-runs it with a larger budget.

For online training, :func:`generic_train_forces` evaluates the pair
function on the list with grad and hands ``(U, dU/dr2)`` to
:class:`GenericReduce`, whose backward is the kernel
``generic_reduce_bwd``: the reduction is linear in each lane's ``(U, s)``,
so its vector-Jacobian product is a pair of per-lane weights of the
forces' cotangent, and autograd carries them through the pair function
into the weights.

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
                       _relative_coords, _roll_offs, analytic_pair_forces,
                       assemble_half, finish_forces, pair_rc2)
from .chebyshev import proxy_lanes

__all__ = ["LJForm", "ChebForm", "half_stencil_plain",
           "half_stencil_pair_forces", "LaneBudget", "lane_budget",
           "same_cell_share", "generic_list_plain", "generic_plain",
           "generic_pair_forces", "GenericList", "generic_list",
           "generic_reduce", "generic_reduce_plain", "GenericReduce",
           "generic_reduce_bwd", "generic_reduce_bwd_plain",
           "generic_train_forces", "kernel_lane_index"]


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
        # [T, T, 4] in float64; each scalar type takes its own rounding
        self.table = np.stack([p.reshape(T, T) if p.ndim else
                               p.reshape(1, 1) for p in parts], axis=-1)
        self.strict = bool(strict)
        self._on = {}

    def tensor(self, device, dtype=torch.float32):
        """The ``[T*T, 4]`` table on ``device`` in ``dtype`` (the state's:
        float32 or float64), copied once, then cached: a host-to-device
        copy in the step loop is a host sync."""
        device = torch.device(device)
        key = (str(device), dtype)
        if key not in self._on:
            self._on[key] = torch.as_tensor(
                self.table.reshape(-1, 4), dtype=dtype,
                device=device).contiguous()
        return self._on[key]

    def evaluate(self, r2, ti=None, tj=None):
        """``(U, dU/dr2)`` per lane, in the same operation order as the
        kernel (the plain version of its pair function), in ``r2``'s
        dtype."""
        tab = self.tensor(r2.device, r2.dtype)
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

    #: scalars of shared memory the kernel stages for this form
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
    ``[P, 2, K]`` device table (``P = 1`` untyped, else one row per
    unordered type pair in :func:`.chebyshev.type_pairs` order), float64
    when the coefficients are, else float32.

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
        dtype = (torch.float64 if tab.dtype == torch.float64 else
                 torch.float32)
        self.table = tab.to(dtype).contiguous()              # [P, 2, K]
        P = self.table.shape[0]
        self.smem_floats = P * 2 * self.K + P * 2

    def tensor(self, device, dtype=None):
        """The table, on its own device, in ``dtype`` (a device-side
        cast when it differs: no host copy)."""
        if self.table.device != torch.device(device):
            raise ValueError(f"the coefficient table is on "
                             f"{self.table.device}, not {device}")
        return self.table if dtype is None else \
            self.table.to(dtype).contiguous()

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
    """``HalfGeom`` of ``csrc/half_stencil_stage.cuh``: the plan's
    integers -- the grid, the capacity, whether the box is tilted, and
    per half-stencil block its integer cell offset. The kernels read
    everything else from the box on the card."""
    _fields_ = [("nx", ctypes.c_int), ("ny", ctypes.c_int),
                ("nz", ctypes.c_int), ("cap", ctypes.c_int),
                ("tilted", ctypes.c_int),
                ("off", (ctypes.c_int * 3) * len(_HALF_OFFS))]


@functools.lru_cache(maxsize=None)
def half_geom(plan):
    """The kernels' :class:`_HalfGeom` of ``plan`` (made once per plan:
    it holds no box value, so a rescaled box needs no new one)."""
    g = _HalfGeom(*plan.grid, plan.capacity, int(plan.tilted))
    for t, o in enumerate(_HALF_OFFS):
        g.off[t][:] = o
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


def kernel_dtype(t):
    """``(dtype, f64)``: the scalar type of a kernel call, from its
    positions (float32, or float64 for the double instantiation), and the
    flag the C entry points take. Any other dtype raises: nothing is cast
    on the way."""
    if t.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the kernels take float32 or float64 tensors, "
                         f"not {t.dtype}")
    return t.dtype, int(t.dtype == torch.float64)


def cuda_slot_args(positions, types, valid, plan, geometry, typed):
    """Check the slot state a half-stencil kernel reads on the card and
    return its pointers: ``(positions, types or null, valid, box)``, the
    box the ``[3, 3]`` tensor of ``geometry`` (the kernels derive the
    lengths, centers and offsets from it at each launch). Every floating
    input has the positions' dtype."""
    dev = positions.device
    n = plan.n_slots
    dtype, _ = kernel_dtype(positions)
    _check(positions, (n, 3), dtype, dev, "positions")
    _check(valid, (n,), dtype, dev, "valid")
    _check(geometry.box, (3, 3), dtype, dev, "geometry.box")
    if typed:
        _check(types, (n,), torch.int32, dev, "types")
    return (_ptr(positions), _ptr(types if typed else None), _ptr(valid),
            _ptr(geometry.box))


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

    :param positions: ``[n_slots, 3]`` slot positions, float32 or float64
        (the kernel's double instantiation); every floating input and
        output has their dtype.
    :param types: ``[n_slots]`` int32 types (read when the form is typed
        or ``rc2_tab`` is given).
    :param valid: ``[n_slots]``, nonzero on occupied slots (any pattern
        within a cell).
    :param form: the :class:`LJForm` or :class:`ChebForm`.
    :param rc2_tab: ``[T, T]`` squared cutoffs, or ``None``.
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
    dtype, f64 = kernel_dtype(positions)
    typed = form.ntypes > 1 or rc2_tab is not None
    state = cuda_slot_args(positions, types, valid, plan, geometry, typed)
    tab = form.tensor(dev, dtype)
    rc_t = 0
    if rc2_tab is not None:
        rc_t = rc2_tab.shape[0]
        _check(rc2_tab, (rc_t, rc_t), dtype, dev, "rc2_tab")
    n_ch = len(_channel_coefs(needs_energy, needs_virial))
    lib = _library()
    smem = lib.htf_half_stencil_smem(f64, plan.capacity, n_ch,
                                     form.smem_floats)
    if smem > _MAX_SMEM:
        raise ValueError(f"capacity {plan.capacity} needs {smem} bytes of "
                         f"shared memory per block, above {_MAX_SMEM}")
    n = plan.n_slots
    sums = torch.empty((n_ch, len(_HALF_OFFS), n), dtype=dtype, device=dev)
    forces4 = torch.empty((n, 4), dtype=dtype, device=dev)
    virial = (torch.empty((n, 3, 3), dtype=dtype, device=dev)
              if needs_virial else None)
    geom = ctypes.byref(half_geom(plan))
    rest = (_ptr(rc2_tab), rc_t, float(plan.r_cut ** 2), float(min_r2),
            int(needs_energy), int(needs_virial), _ptr(sums), _ptr(forces4),
            _ptr(virial),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if isinstance(form, ChebForm):
        err = lib.htf_half_stencil_cheb(
            f64, *state, geom, plan.n_cells, _ptr(tab), form.ntypes, form.K,
            form.mid, form.inv_half, form.u_hi, *rest)
    else:
        err = lib.htf_half_stencil(f64, *state, geom, plan.n_cells,
                                   _ptr(tab), form.ntypes, int(form.strict),
                                   *rest)
    if err != 0:
        raise RuntimeError("half-stencil kernel launch failed: " +
                           lib.htf_error_string(err).decode())
    half_stencil_pair_forces.launches += 1
    if isinstance(form, ChebForm):
        half_stencil_pair_forces.proxy_launches += 1
    half_stencil_pair_forces.f64_launches += f64
    return forces4, virial


#: calls that launched the kernel (two launches each), all forms and both
#: scalar types; those of its Chebyshev-proxy form alone; and those of the
#: double instantiation alone (any form)
half_stencil_pair_forces.launches = 0
half_stencil_pair_forces.proxy_launches = 0
half_stencil_pair_forces.f64_launches = 0

# dynamic shared memory one H100 block may use (227 KB)
_MAX_SMEM = 232448

_LIB = None


def _library():
    """The compiled kernel library (built from ``csrc/`` on first use)."""
    global _LIB
    if _LIB is None:
        from .._build import build_shared_library
        lib = ctypes.CDLL(str(build_shared_library("cellwise_half")))
        state = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int]
        rest = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_double] * 2 +
                [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4)
        lib.htf_half_stencil.argtypes = (
            state + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + rest)
        lib.htf_half_stencil.restype = ctypes.c_int
        lib.htf_half_stencil_cheb.argtypes = (
            state + [ctypes.c_void_p] + [ctypes.c_int] * 2 +
            [ctypes.c_double] * 3 + rest)
        lib.htf_half_stencil_cheb.restype = ctypes.c_int
        lib.htf_half_stencil_smem.argtypes = [ctypes.c_int] * 4
        lib.htf_half_stencil_smem.restype = ctypes.c_long
        lib.htf_error_string.argtypes = [ctypes.c_int]
        lib.htf_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


# ----------------------------------------------------------------------
# K1's generic form: a pair function the kernel cannot compile
# ----------------------------------------------------------------------
# the generic form's list: the first estimate's headroom over the lanes
# expected (also an overflow's over the lanes needed), the plain version's
# mask work per chunk (elements of [cells, cap, 14 cap]) and its pair
# function's lanes per call
_HEADROOM = 1.25
_LIST_CHUNK = 1 << 24
_PAIR_CHUNK = 1 << 20


@functools.lru_cache(maxsize=None)
def same_cell_share(edges, r_cut, n=48):
    """The probability that two points drawn uniformly in one cell of
    edges ``edges`` lie within ``r_cut``: each axis' difference has the
    density ``2 (e - x) / e^2`` on ``[0, e]``; a midpoint rule of ``n``
    points per axis."""
    axes, weights = [], []
    for e in edges:
        x = (np.arange(n) + 0.5) / n * e
        axes.append(x)
        weights.append(2.0 * (e - x) / e ** 2 * (e / n))
    x, y, z = np.meshgrid(*axes, indexing="ij")
    w = (weights[0][:, None, None] * weights[1][None, :, None] *
         weights[2][None, None, :])
    return float((w * (x * x + y * y + z * z <= r_cut ** 2)).sum())


def lane_budget(plan, n_real):
    """The first estimate of K1's generic-form list for ``n_real``
    particles on ``plan``, before any run has counted its need: per
    particle, half its neighbors within the cut (``2 pi / 3 r_cut^3
    rho``, each pair once) plus half its cell's mean occupancy times the
    share of a cell's pairs within the cut (:func:`same_cell_share`;
    block 0 lists those in both orders), with 25% headroom."""
    rho = n_real / float(np.prod(plan.lengths))
    share = same_cell_share(tuple(float(e) for e in plan.edges),
                            float(plan.r_cut))
    per = (2.0 * np.pi / 3.0 * plan.r_cut ** 3 * rho +
           0.5 * n_real / plan.n_cells * share)
    return int(np.ceil(_HEADROOM * n_real * per)) + 1024


def _round_lanes(n):
    """``n`` rounded up to a multiple of 1/64 of the power of two at or
    below it (at most 1.6% more)."""
    n = max(int(np.ceil(n)), 64)
    step = 1 << (n.bit_length() - 7)
    return -(-n // step) * step


class LaneBudget:
    """The size of K1's generic-form list and, on the device, the most
    lanes a call has needed since :meth:`reset` (a running max; no host
    sync). ``budget`` lanes are evaluated by the pair function per call,
    padding included.

    The engine sizes it from what the runs need: :meth:`fit` after each
    committed run (the need read in the run's one readback), and
    :meth:`grow` after an overflow, which rolls the run back."""

    #: a fitted budget over the need it was fitted to: the least margin
    #: :meth:`fit` leaves for the next run's need to rise (phase 7 of
    #: chip_smoke.py prints the rises), and the most budget / need at
    #: which it keeps a larger list
    headroom, shrink_above = 1.05, 1.12

    def __init__(self, budget, device):
        self.budget = int(budget)
        self.needed = torch.zeros((), dtype=torch.int32, device=device)
        #: the most lanes the last committed run needed (a host int)
        self.committed = None

    def reset(self):
        self.needed = torch.zeros_like(self.needed)

    def record(self, needed):
        self.needed = torch.maximum(self.needed, needed.to(torch.int32))

    def overflow(self):
        """0-d bool device tensor: some call needed more than the budget."""
        return self.needed > self.budget

    def fit(self, need):
        """Size the list for the next run from ``need``, the most lanes a
        committed run needed: ``headroom`` times it, rounded up by
        :func:`_round_lanes`, unless the budget already lies within
        ``[headroom, shrink_above]`` times it (so the list and the pair
        function's buffers are not remade every run). Returns whether the
        budget changed."""
        need = int(need)
        if need <= 0:
            return False
        self.committed = need
        if self.headroom * need <= self.budget <= self.shrink_above * need:
            return False
        self.budget = _round_lanes(self.headroom * need)
        return True

    def grow(self):
        """Raise the budget to 1.25 times the most lanes needed (one
        readback) and reset the count."""
        need = int(self.needed)
        self.budget = max(self.budget, int(np.ceil(need * _HEADROOM)) + 1024)
        self.reset()


def _lane_state(positions, types, valid, plan, lo, geometry, typed):
    """The half-stencil tensor form's coordinates for listing lanes:
    ``(qx, qy, qz, gx, gy, gz)`` (:func:`.cellwise._relative_coords`),
    the row and candidate ``valid`` and float types (zero when untyped,
    as the kernel stages them)."""
    n_cells, cap = plan.n_cells, plan.capacity
    qx, qy, qz, gx, gy, gz = _relative_coords(positions, valid, plan, lo,
                                              _HALF_OFFS, geometry)
    tt = (types.to(positions.dtype) if typed else
          torch.zeros_like(valid))
    return (qx.reshape(n_cells, cap), qy.reshape(n_cells, cap),
            qz.reshape(n_cells, cap), gx, gy, gz,
            valid.reshape(n_cells, cap) > 0,
            _roll_offs(valid, plan, _HALF_OFFS) > 0,
            tt.reshape(n_cells, cap), _roll_offs(tt, plan, _HALF_OFFS))


def generic_list_plain(positions, types, valid, plan, lo, min_r2=1e-4,
                       rc2_tab=None, geometry=None, budget=None,
                       typed=True):
    """Plain PyTorch version of the generic form's list kernel: the
    in-cut lanes of the half stencil, cell by cell, each cell's lanes
    row-major (rows and candidates in slot order, occupied slots only) as
    the kernel lists them, the self pair left out in block 0, ``r2 =
    max(d2, min_r2)``. Cells are placed in cell order; a cell whose lanes
    would pass ``budget`` is left out whole.

    :returns: a dict of per-lane tensors ``r2``, ``ti``, ``tj`` (float
        types), ``dx``, ``dy``, ``dz``, ``cell``, ``row`` and ``col``
        (the candidate's column in the ``14 * cap`` half-stencil plane),
        and ``needed``, the lanes of every cell (a Python int).
    """
    geometry = _as_geometry(plan, lo, positions, geometry)
    n_cells, cap = plan.n_cells, plan.capacity
    C = len(_HALF_OFFS) * cap
    qx, qy, qz, gx, gy, gz, vr, vc, ti, tj = _lane_state(
        positions, types, valid, plan, lo, geometry,
        typed or rc2_tab is not None)
    dev = positions.device
    not_self = (torch.arange(C, device=dev)[None, :] !=
                torch.arange(cap, device=dev)[:, None])[None]
    step = max(1, _LIST_CHUNK // (cap * C))
    parts = []
    for a in range(0, n_cells, step):
        b = min(n_cells, a + step)
        dx = gx[a:b, None, :] - qx[a:b, :, None]
        dy = gy[a:b, None, :] - qy[a:b, :, None]
        dz = gz[a:b, None, :] - qz[a:b, :, None]
        d2 = dx * dx + dy * dy + dz * dz
        ok = ((d2 <= plan.r_cut ** 2) & not_self & vr[a:b, :, None] &
              vc[a:b, None, :])
        if rc2_tab is not None:
            ok = ok & (d2 <= pair_rc2(ti[a:b, :, None], tj[a:b, None, :],
                                      rc2_tab))
        c, r, j = ok.nonzero(as_tuple=True)
        parts.append(dict(
            r2=torch.clamp_min(d2[c, r, j], min_r2), dx=dx[c, r, j],
            dy=dy[c, r, j], dz=dz[c, r, j], ti=ti[a + c, r],
            tj=tj[a + c, j], cell=c + a, row=r, col=j))
    lst = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    needed = int(lst["r2"].shape[0])
    if budget is not None and needed > budget:
        counts = torch.bincount(lst["cell"], minlength=n_cells)
        fits = torch.cumsum(counts, 0) <= budget
        keep = fits[lst["cell"]]
        lst = {k: v[keep] for k, v in lst.items()}
    lst["needed"] = needed
    return lst


def _eval_pair_fn(pair_fn, typed_fn, r2, ti, tj, grad=False):
    """``(U, dU/dr2)`` of the pair function on the list, as tensors of
    the list's length and dtype (float32, or float64 for a float64
    state); with ``grad``, differentiable in the pair function's weights
    (training), else under ``no_grad``."""
    with torch.set_grad_enabled(grad):
        U, dU = pair_fn(r2, ti, tj) if typed_fn else pair_fn(r2)
        return (torch.broadcast_to(U, r2.shape).to(r2.dtype),
                torch.broadcast_to(dU, r2.shape).to(r2.dtype))


def generic_plain(positions, types, valid, plan, lo, pair_fn,
                  typed_fn=True, needs_virial=False, min_r2=1e-4,
                  rc2_tab=None, needs_energy=True, geometry=None, lanes=None):
    """Plain PyTorch version of K1's generic form, list and reduction:
    :func:`generic_list_plain`, the pair function on the list (in chunks
    of ``_PAIR_CHUNK`` lanes), each lane's channel products added to its
    row and, for blocks 1..13, to its candidate, pushed home as
    :func:`.cellwise.assemble_half` does. Records the lanes needed in
    ``lanes`` when given (a cell that does not fit its budget adds
    nothing, as in the kernel)."""
    geometry = _as_geometry(plan, lo, positions, geometry)
    n_cells, cap = plan.n_cells, plan.capacity
    C = len(_HALF_OFFS) * cap
    lst = generic_list_plain(
        positions, types, valid, plan, lo, min_r2, rc2_tab, geometry,
        None if lanes is None else lanes.budget, typed_fn)
    if lanes is not None:
        lanes.record(torch.tensor(lst["needed"], device=positions.device))
    n = lst["r2"].shape[0]
    Us, Ss = [], []
    for a in range(0, n, _PAIR_CHUNK):
        sl = slice(a, a + _PAIR_CHUNK)
        u, s = _eval_pair_fn(pair_fn, typed_fn, lst["r2"][sl],
                             lst["ti"][sl], lst["tj"][sl])
        Us.append(u)
        Ss.append(s)
    U = torch.cat(Us) if Us else lst["r2"]
    S = torch.cat(Ss) if Ss else lst["r2"]
    return generic_reduce_plain(lst, U, S, valid, plan, needs_energy,
                                needs_virial)


def generic_reduce_plain(lst, U, S, valid, plan, needs_energy=True,
                         needs_virial=False):
    """Plain PyTorch version of the generic form's reduction and finish:
    each listed lane's channel products (its first ``len(lst["r2"])``
    values of ``U`` and ``S``; later lanes are ignored) added to its row
    and, for blocks 1..13, to its candidate, pushed home as
    :func:`.cellwise.assemble_half` does. Differentiable in ``U`` and
    ``S`` (``index_add_``), so autograd through it is the oracle of
    :func:`generic_reduce_bwd_plain`.

    :param lst: :func:`generic_list_plain`'s lanes.
    :returns: ``(forces4, virial or None)``.
    """
    n_cells, cap = plan.n_cells, plan.capacity
    C = len(_HALF_OFFS) * cap
    dtype = valid.dtype
    n = lst["r2"].shape[0]
    U, S = U[:n].to(dtype), S[:n].to(dtype)
    dx, dy, dz = lst["dx"], lst["dy"], lst["dz"]
    sdx, sdy, sdz = S * dx, S * dy, S * dz
    prods = ([U] if needs_energy else []) + [sdx, sdy, sdz]
    if needs_virial:
        prods += [sdx * dx, sdy * dy, sdz * dz, sdx * dy, sdx * dz,
                  sdy * dz]
    prods = torch.stack(prods)
    coefs = _channel_coefs(needs_energy, needs_virial)
    nch = len(coefs)
    dev = valid.device
    rows = torch.zeros((nch, plan.n_slots), dtype=dtype, device=dev)
    rows = rows.index_add(1, lst["cell"] * cap + lst["row"], prods)
    back = lst["col"] >= cap
    cols = torch.zeros((nch, n_cells * C), dtype=dtype, device=dev)
    cols = cols.index_add(1, (lst["cell"] * C + lst["col"])[back],
                          prods[:, back])
    fwd = torch.tensor([c[0] for c in coefs], dtype=dtype,
                       device=dev)[:, None]
    bwd = torch.tensor([c[1] for c in coefs], dtype=dtype,
                       device=dev)[:, None]
    out = (rows * fwd).reshape(nch, n_cells, cap)
    cols = (cols * bwd).reshape(nch, n_cells, C)
    out = assemble_half(torch.cat([out, cols[:, :, cap:]], dim=2), plan)
    return finish_forces(out, valid, needs_energy, needs_virial)


class GenericList:
    """The generic form's list of one call (:func:`generic_list`): the
    lanes ``r2``, ``ti``, ``tj`` the pair function is evaluated on and
    what the reduction and its backward read. On a CUDA device the list
    kernel's output: the ``budget``-lane list (the tail past the lanes
    needed holds earlier, finite ``r2``), the cells' bases and records in
    the per-device buffers, and the ``generation`` of those buffers; on
    the CPU the plain version's lanes (``lst``, the listed lanes only)."""

    def __init__(self, plan, valid, typed_fn, r2, ti, tj, lst=None, *,
                 lanes=None, counter=None, rec=None, cell_base=None,
                 sums=None, stream=None, generation=None):
        self.plan, self.valid, self.typed_fn = plan, valid, typed_fn
        self.r2, self.ti, self.tj = r2, ti, tj
        self.lst = lst
        # CUDA only: the LaneBudget, the device's lane counter and records,
        # the cells' bases, the reduction's [n_ch][14][n_slots] scratch, the
        # stream and the generation of the shared buffers at the launch
        self.lanes, self.counter, self.rec = lanes, counter, rec
        self.cell_base, self.sums, self.stream = cell_base, sums, stream
        self.generation = generation
        if lst is None:
            self.budget, self.sums_ch = r2.shape[0], sums.shape[0]
            self.geom = ctypes.byref(half_geom(plan))
        #: the lanes the call needed, a device int32 (CUDA: set by the
        #: reduction)
        self.needed = None

    def evaluate(self, pair_fn, grad=False):
        """``(U, dU/dr2)`` of ``pair_fn`` on the list (its dtype); with
        ``grad``, differentiable in its weights. On a CUDA device a
        failure of the pair function zeroes the lane counter the
        reduction would have zeroed."""
        try:
            return _eval_pair_fn(pair_fn, self.typed_fn, self.r2, self.ti,
                                 self.tj, grad)
        except BaseException:
            if self.lst is None:
                # the reduction, which zeroes it, will not run
                self.counter.zero_()
            raise


def generic_list(positions, types, valid, plan, lo, typed_fn=True,
                 min_r2=1e-4, rc2_tab=None, geometry=None, lanes=None,
                 needs_energy=True, needs_virial=False):
    """The generic form's list kernel on CUDA tensors (its plain version,
    :func:`generic_list_plain`, on CPU tensors, which records the lanes
    needed in ``lanes`` itself): a :class:`GenericList` for a reduction
    of at most the channels ``needs_energy`` and ``needs_virial`` ask
    for. A failed build or launch raises. Each launch rewrites the
    device's shared list and records and counts a new generation."""
    check_slot_inputs(positions, types, valid, plan)
    if lanes is None:
        lanes = LaneBudget(lane_budget(plan, int((valid > 0).sum())),
                           positions.device)
    if not positions.is_cuda:
        lst = generic_list_plain(positions, types, valid, plan, lo, min_r2,
                                 rc2_tab, geometry, lanes.budget, typed_fn)
        lanes.record(torch.tensor(lst["needed"], device=positions.device))
        return GenericList(plan, valid, typed_fn, lst["r2"], lst["ti"],
                           lst["tj"], lst)
    geometry = _as_geometry(plan, lo, positions, geometry)
    dev = positions.device
    dtype, f64 = kernel_dtype(positions)
    typed = typed_fn or rc2_tab is not None
    state = cuda_slot_args(positions, types, valid, plan, geometry, typed)
    rc_t = 0
    if rc2_tab is not None:
        rc_t = rc2_tab.shape[0]
        _check(rc2_tab, (rc_t, rc_t), dtype, dev, "rc2_tab")
    lib = _generic_library()
    smem = max(lib.htf_generic_smem(f64, plan.capacity),
               lib.htf_generic_reduce_smem(f64, plan.capacity))
    if smem > _MAX_SMEM:
        raise ValueError(f"capacity {plan.capacity} needs {smem} bytes of "
                         f"shared memory per block, above {_MAX_SMEM}")
    budget = lanes.budget
    counter, lst, rec = _generic_buffers(
        dev, dtype, budget, plan.r_cut ** 2,
        plan.n_cells * lib.htf_generic_record_words(f64, plan.capacity))
    _GENERATION[str(dev)] = generation = _GENERATION.get(str(dev), 0) + 1
    # the list kernel writes the zero back sums of the slots the box test
    # left out into the reduction's scratch
    n_ch = len(_channel_coefs(needs_energy, needs_virial))
    gl = GenericList(
        plan, valid, typed_fn, lst[0], lst[1], lst[2], lanes=lanes,
        counter=counter, rec=rec,
        cell_base=torch.empty(plan.n_cells, dtype=torch.int32, device=dev),
        sums=torch.empty((n_ch, len(_HALF_OFFS), plan.n_slots),
                         dtype=dtype, device=dev),
        stream=ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
        generation=generation)
    err = lib.htf_generic_list(f64, *state, gl.geom, plan.n_cells,
                               _ptr(rc2_tab), rc_t, float(plan.r_cut ** 2),
                               float(min_r2), budget, _ptr(counter),
                               _ptr(gl.cell_base), _ptr(gl.r2), _ptr(gl.ti),
                               _ptr(gl.tj), _ptr(rec), _ptr(gl.sums),
                               gl.sums_ch, gl.stream)
    if err != 0:
        counter.zero_()
        raise RuntimeError("generic list kernel launch failed: " +
                           lib.htf_generic_error_string(err).decode())
    return gl


def generic_reduce(gl, U, S, needs_energy=True, needs_virial=False):
    """The generic form's reduction kernel and finish on the list ``gl``
    and the pair function's ``(U, S)`` on it (CUDA); the plain version,
    :func:`generic_reduce_plain`, for a CPU list. Records the lanes the
    list needed in ``gl.lanes``; a CUDA launch counts in
    ``generic_pair_forces.launches``. Returns ``(forces4, virial or
    None)``."""
    if gl.lst is not None:
        return generic_reduce_plain(gl.lst, U, S, gl.valid, gl.plan,
                                    needs_energy, needs_virial)
    plan, dev = gl.plan, gl.r2.device
    dtype, f64 = kernel_dtype(gl.r2)
    n_ch = len(_channel_coefs(needs_energy, needs_virial))
    if n_ch > gl.sums_ch:
        raise ValueError(f"a reduction of {n_ch} channels on a list made "
                         f"for {gl.sums_ch}")
    n = plan.n_slots
    U, S = U.contiguous(), S.contiguous()
    _check(U, (gl.budget,), dtype, dev, "U")
    _check(S, (gl.budget,), dtype, dev, "S")
    forces4 = torch.empty((n, 4), dtype=dtype, device=dev)
    virial = (torch.empty((n, 3, 3), dtype=dtype, device=dev)
              if needs_virial else None)
    gl.needed = torch.empty((), dtype=torch.int32, device=dev)
    lib = _generic_library()
    err = lib.htf_generic_reduce(f64, gl.geom, plan.n_cells, _ptr(gl.rec),
                                 _ptr(gl.cell_base), _ptr(U), _ptr(S),
                                 int(needs_energy), int(needs_virial),
                                 _ptr(gl.valid), _ptr(gl.sums), _ptr(forces4),
                                 _ptr(virial), _ptr(gl.counter),
                                 _ptr(gl.needed), gl.stream)
    if err != 0:
        gl.counter.zero_()
        raise RuntimeError("generic reduction kernel launch failed: " +
                           lib.htf_generic_error_string(err).decode())
    generic_pair_forces.launches += 1
    generic_pair_forces.f64_launches += f64
    gl.lanes.record(gl.needed)
    return forces4, virial


def generic_pair_forces(positions, types, valid, plan, lo, pair_fn,
                        typed_fn=True, needs_virial=False, min_r2=1e-4,
                        rc2_tab=None, needs_energy=True, geometry=None,
                        lanes=None):
    """Kernel K1's generic form: :func:`.cellwise.analytic_pair_forces`
    of any pair function ``pair_fn(r2[, ti, tj]) -> (U, dU/dr2)``. On
    CUDA tensors it launches the list kernel, evaluates ``pair_fn`` on
    the list's ``lanes.budget`` lanes (the tail past the needed lanes
    holds earlier, finite ``r2``), then launches the reduction and the
    finish (counted in ``generic_pair_forces.launches``); CPU tensors
    take :func:`generic_plain`. A failed build or launch raises.

    :param typed_fn: call ``pair_fn(r2, ti, tj)`` (float types) rather
        than ``pair_fn(r2)``.
    :param rc2_tab: ``[T, T]`` squared cutoffs (the positions' dtype), or
        ``None``.
    :param lanes: the :class:`LaneBudget` to size the list by and record
        the lanes needed in (default: :func:`lane_budget` of this call's
        occupied slots, counted with one host sync).
    :returns: ``(forces4 [n_slots, 4], virial [n_slots, 3, 3] or None)``.
    """
    check_slot_inputs(positions, types, valid, plan)
    if lanes is None:
        lanes = LaneBudget(lane_budget(plan, int((valid > 0).sum())),
                           positions.device)
    if not positions.is_cuda:
        return generic_plain(positions, types, valid, plan, lo, pair_fn,
                             typed_fn, needs_virial, min_r2, rc2_tab,
                             needs_energy, geometry, lanes)
    gl = generic_list(positions, types, valid, plan, lo, typed_fn, min_r2,
                      rc2_tab, geometry, lanes, needs_energy, needs_virial)
    U, S = gl.evaluate(pair_fn)
    return generic_reduce(gl, U, S, needs_energy, needs_virial)


#: calls that launched the generic form's reduction (generic_reduce, after
#: its list kernel: three launches each), training's forward included; and
#: those of the double instantiation alone
generic_pair_forces.launches = 0
generic_pair_forces.f64_launches = 0


def _shifted_cells(cell, t, plan):
    """The cell ``cell + _HALF_OFFS[t]`` on the periodic grid (x-minor,
    z-major ids), elementwise."""
    nx, ny, nz = plan.grid
    offs = torch.tensor(_HALF_OFFS, dtype=cell.dtype, device=cell.device)
    o = offs[t]
    x = (cell % nx + o[:, 0]) % nx
    y = (cell // nx % ny + o[:, 1]) % ny
    z = (cell // (nx * ny) + o[:, 2]) % nz
    return x + nx * (y + ny * z)


def generic_reduce_bwd_plain(lst, ct, valid, plan, needs_energy=True,
                             n_lanes=None):
    """Plain PyTorch version of ``generic_reduce_bwd``: the transpose of
    :func:`generic_reduce_plain` in ``(U, S)``. Per listed lane, with the
    cotangent folded with ``valid`` (the finish multiplies by it), ``gU =
    0.5 ct_e[i] + [block >= 1] 0.5 ct_e[j]`` and ``gS = sum_k d_k (2
    ct_k[i] - [block >= 1] 2 ct_k[j])``, ``i`` the lane's row slot and
    ``j`` its candidate's own slot (block 0 lists both orders: the row
    term only).

    :param n_lanes: the length of the returned cotangents (default the
        listed lanes); lanes past the listed ones get exactly zero.
    :returns: ``(gU or None when not needs_energy, gS)``.
    """
    cap = plan.capacity
    n = lst["r2"].shape[0]
    n_lanes = n if n_lanes is None else int(n_lanes)
    ctv = ct.to(valid.dtype) * valid[:, None]
    row = lst["cell"] * cap + lst["row"]
    t = lst["col"] // cap
    back = t >= 1
    cand = _shifted_cells(lst["cell"], t, plan) * cap + lst["col"] % cap
    ci, cj = ctv[row], ctv[cand] * back[:, None].to(ctv.dtype)
    gS = (lst["dx"] * (2.0 * ci[:, 0] - 2.0 * cj[:, 0]) +
          lst["dy"] * (2.0 * ci[:, 1] - 2.0 * cj[:, 1]) +
          lst["dz"] * (2.0 * ci[:, 2] - 2.0 * cj[:, 2]))
    gU = 0.5 * ci[:, 3] + 0.5 * cj[:, 3] if needs_energy else None
    pad = n_lanes - n
    if pad > 0:
        gS = torch.nn.functional.pad(gS, (0, pad))
        gU = None if gU is None else torch.nn.functional.pad(gU, (0, pad))
    return gU, gS


def generic_reduce_bwd(gl, ct, needs_energy=True):
    """Kernel ``generic_reduce_bwd``, the backward of the generic form's
    reduction: the cotangents ``(gU or None, gS)`` of the pair function's
    ``(U, S)`` on the list ``gl``, given the cotangent ``ct`` of the
    forces ``[n_slots, 4]``. On a CUDA list it launches the kernel
    (counted in ``generic_reduce_bwd.launches``), which reads the list
    kernel's records of ``gl`` and writes every lane of the budget (zero
    where no pair is listed); it raises when a later list call has
    rewritten those records. On a CPU list it takes
    :func:`generic_reduce_bwd_plain`."""
    plan = gl.plan
    if gl.lst is not None:
        return generic_reduce_bwd_plain(gl.lst, ct, gl.valid, plan,
                                        needs_energy, gl.r2.shape[0])
    dev = gl.r2.device
    if _GENERATION.get(str(dev)) != gl.generation:
        raise RuntimeError(
            "the generic form's list and records were rewritten by a later "
            "generic-form call before this call's backward ran")
    if gl.needed is None:
        raise RuntimeError("the backward of a generic-form list whose "
                           "reduction did not run")
    dtype, f64 = kernel_dtype(gl.r2)
    ct = ct.contiguous()
    _check(ct, (plan.n_slots, 4), dtype, dev, "ct")
    gS = torch.empty(gl.budget, dtype=dtype, device=dev)
    gU = torch.empty_like(gS) if needs_energy else None
    lib = _generic_library()
    err = lib.htf_generic_reduce_bwd(
        f64, gl.geom, plan.n_cells, _ptr(gl.rec), _ptr(gl.cell_base), _ptr(ct),
        _ptr(gl.valid), int(needs_energy), _ptr(gl.needed), gl.budget,
        _ptr(gU), _ptr(gS),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError("generic reduction backward launch failed: " +
                           lib.htf_generic_error_string(err).decode())
    generic_reduce_bwd.launches += 1
    generic_reduce_bwd.f64_launches += f64
    return gU, gS


#: calls that launched generic_reduce_bwd; those of its double
#: instantiation alone
generic_reduce_bwd.launches = 0
generic_reduce_bwd.f64_launches = 0


class GenericReduce(torch.autograd.Function):
    """The generic form's reduction and finish as a differentiable
    function of the pair function's ``(U, S)`` on a :class:`GenericList`:
    forward :func:`generic_reduce` (forces only, no virial), backward
    :func:`generic_reduce_bwd`. ``apply(U, S, gl, needs_energy) ->
    forces4``; without the energy, ``U`` gets no gradient."""

    @staticmethod
    def forward(ctx, U, S, gl, needs_energy):
        ctx.gl, ctx.needs_energy = gl, needs_energy
        f4, _ = generic_reduce(gl, U.detach(), S.detach(), needs_energy)
        return f4

    @staticmethod
    def backward(ctx, ct):
        gU, gS = generic_reduce_bwd(ctx.gl, ct, ctx.needs_energy)
        return gU, gS, None, None


def generic_train_forces(positions, types, valid, plan, lo, pair_fn,
                         typed_fn=True, min_r2=1e-4, rc2_tab=None,
                         needs_energy=True, geometry=None, lanes=None):
    """K1's generic form for training: ``forces4 [n_slots, 4]``
    differentiable in the weights ``pair_fn`` reads. The list kernel (its
    plain version on CPU tensors), the pair function on the list with
    grad, then :class:`GenericReduce`, whose backward is the kernel
    ``generic_reduce_bwd`` (its plain version on the CPU). A CUDA call
    counts in ``generic_pair_forces.launches`` (at its reduction).
    Arguments as
    :func:`generic_pair_forces`; no virial."""
    gl = generic_list(positions, types, valid, plan, lo, typed_fn, min_r2,
                      rc2_tab, geometry, lanes, needs_energy)
    U, S = gl.evaluate(pair_fn, grad=True)
    if not needs_energy:
        U = U.detach()
    return GenericReduce.apply(U, S, gl, needs_energy).to(positions.dtype)


def kernel_lane_index(lst, cell_base, plan):
    """Where each lane of the plain list ``lst`` (:func:`generic_list_plain`,
    cells in order) lies in the kernel's list of the same state: its
    cell's base plus its index within the cell (both lists order a cell's
    lanes alike). Cells the kernel did not list (negative base) give -1.
    For comparing per-lane outputs of the two."""
    counts = torch.bincount(lst["cell"], minlength=plan.n_cells)
    first = torch.cumsum(counts, 0) - counts
    k = torch.arange(lst["cell"].shape[0], device=lst["cell"].device)
    base = cell_base.to(lst["cell"].device).long()[lst["cell"]]
    return torch.where(base >= 0, base + k - first[lst["cell"]],
                       torch.full_like(base, -1))


# per device: the generation of the shared list and records below (one
# more at each list launch; a backward checks its call's)
_GENERATION = {}

# per device and scalar type: the lane counter (zero between calls), the
# list buffer ([3, budget] r2, ti, tj in the state's dtype), first filled
# with harmless in-cut values, so that later calls leave earlier lanes'
# finite values in its tail, and the cells' records the list kernel hands
# the reduction
_GENERIC = {}


def _generic_buffers(device, dtype, budget, rc2, rec_words):
    key = (str(device), dtype)
    counter, lst, rec = _GENERIC.get(key, (None, None, None))
    if counter is None:
        counter = torch.zeros(1, dtype=torch.int32, device=device)
    if lst is None or lst.shape[1] != budget:
        lst = torch.zeros((3, budget), dtype=dtype, device=device)
        lst[0] = rc2
    if rec is None or rec.numel() != rec_words:
        rec = torch.zeros(rec_words, dtype=torch.int32, device=device)
    _GENERIC[key] = (counter, lst, rec)
    return counter, lst, rec


_GLIB = None


def _generic_library():
    """The compiled generic-form library (built from ``csrc/`` at first
    use)."""
    global _GLIB
    if _GLIB is None:
        from .._build import build_shared_library
        lib = ctypes.CDLL(str(build_shared_library("cellwise_generic")))
        state = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int]
        geo = [ctypes.c_void_p, ctypes.c_int, ctypes.c_double]
        lib.htf_generic_list.argtypes = (
            state + geo + [ctypes.c_double, ctypes.c_int] +
            [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_void_p])
        lib.htf_generic_list.restype = ctypes.c_int
        lib.htf_generic_reduce.argtypes = (
            [ctypes.c_int, ctypes.c_void_p, ctypes.c_int] +
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 +
            [ctypes.c_void_p] * 7)
        lib.htf_generic_reduce.restype = ctypes.c_int
        lib.htf_generic_reduce_bwd.argtypes = (
            [ctypes.c_int, ctypes.c_void_p, ctypes.c_int] +
            [ctypes.c_void_p] * 4 +
            [ctypes.c_int, ctypes.c_void_p, ctypes.c_int] +
            [ctypes.c_void_p] * 3)
        lib.htf_generic_reduce_bwd.restype = ctypes.c_int
        lib.htf_generic_smem.argtypes = [ctypes.c_int] * 2
        lib.htf_generic_smem.restype = ctypes.c_long
        lib.htf_generic_reduce_smem.argtypes = [ctypes.c_int] * 2
        lib.htf_generic_reduce_smem.restype = ctypes.c_long
        lib.htf_generic_record_words.argtypes = [ctypes.c_int] * 2
        lib.htf_generic_record_words.restype = ctypes.c_long
        lib.htf_generic_error_string.argtypes = [ctypes.c_int]
        lib.htf_generic_error_string.restype = ctypes.c_char_p
        _GLIB = lib
    return _GLIB
