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

import copy
import ctypes
import functools

import numpy as np
import torch

from .cellwise import (_HALF_OFFS, _as_geometry, _channel_coefs,
                       _roll_offs, _slab_plan, analytic_pair_forces,
                       assemble_group, assemble_half, finish_forces,
                       group_rows, half_frame, half_stencil_group_plain,
                       halo_layer, pair_rc2)
from .chebyshev import proxy_lanes

__all__ = ["LJForm", "ChebForm", "half_stencil_plain",
           "half_stencil_pair_forces", "half_stencil_group_forces",
           "generic_group_plain", "generic_group_pair_forces",
           "LaneBudget", "lane_budget",
           "same_cell_share", "generic_list_plain", "generic_plain",
           "generic_pair_forces", "GenericList", "generic_list",
           "generic_reduce", "generic_reduce_plain", "GenericReduce",
           "generic_reduce_bwd", "generic_reduce_bwd_plain",
           "generic_train_forces", "generic_group_train_forces",
           "generic_group_list_plain", "generic_group_reduce_plain",
           "kernel_lane_index"]


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
    integers -- the grid, the capacity, whether the box is tilted, per
    half-stencil block its integer cell offset, and ``nzl``, the home
    layers of each shard a launch covers (``nz`` for a whole state). The
    kernels read everything else from the box on the card."""
    _fields_ = [("nx", ctypes.c_int), ("ny", ctypes.c_int),
                ("nz", ctypes.c_int), ("cap", ctypes.c_int),
                ("tilted", ctypes.c_int),
                ("off", (ctypes.c_int * 3) * len(_HALF_OFFS)),
                ("nzl", ctypes.c_int)]


@functools.lru_cache(maxsize=None)
def half_geom(plan, nzl=None):
    """The kernels' :class:`_HalfGeom` of ``plan``, for shards of ``nzl``
    home layers (default: the whole state's ``nz``); made once per plan
    and ``nzl``: it holds no box value, so a rescaled box needs no new
    one."""
    g = _HalfGeom(*plan.grid, plan.capacity, int(plan.tilted))
    for t, o in enumerate(_HALF_OFFS):
        g.off[t][:] = o
    g.nzl = plan.grid[2] if nzl is None else nzl
    return g


def slab_shape(plan, slab):
    """``(home cells, rows)`` of a call: every cell and slot unsharded;
    for the z-slab ``slab = (z0, nzl)`` (``1 <= nzl < nz``) its
    ``nzl * nx * ny`` home cells and the ``nzl + 1`` layers of its
    buffer's rows."""
    if slab is None:
        return plan.n_cells, plan.n_slots
    nx, ny, nz = plan.grid
    z0, nzl = slab
    if not (0 <= z0 < nz and 1 <= nzl < nz):
        raise ValueError(f"slab {slab} of a grid of {nz} layers")
    return nzl * nx * ny, (nzl + 1) * nx * ny * plan.capacity


def form_on(form, device):
    """``form`` with its table on ``device``: an :class:`LJForm` keeps a
    copy per device itself; a :class:`ChebForm` on another device is
    copied (a mesh shard's)."""
    if isinstance(form, ChebForm) and form.table.device != \
            torch.device(device):
        on = copy.copy(form)
        on.table = form.table.to(device)
        return on
    return form


def check_slot_inputs(positions, types, valid, plan, n=None):
    """Raise unless ``positions [n, 3]``, ``types [n]`` and ``valid [n]``
    (``n`` the plan's slots by default, a slab buffer's rows) fit and lie
    on one device."""
    n = plan.n_slots if n is None else n
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


def cuda_slot_args(positions, types, valid, plan, geometry, typed, n=None):
    """Check the slot state a half-stencil kernel reads on the card and
    return its pointers: ``(positions, types or null, valid, box)``, the
    box the ``[3, 3]`` tensor of ``geometry`` (the kernels derive the
    lengths, centers and offsets from it at each launch). Every floating
    input has the positions' dtype; ``n`` rows (default the plan's
    slots)."""
    dev = positions.device
    n = plan.n_slots if n is None else n
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

    A z-slab shard of a mesh is :func:`half_stencil_group_forces`' group
    of one.
    """
    n_cells, n = plan.n_cells, plan.n_slots
    check_slot_inputs(positions, types, valid, plan)
    if not positions.is_cuda:
        return half_stencil_plain(positions, types, valid, plan, lo, form,
                                  needs_virial, min_r2, rc2_tab,
                                  needs_energy, geometry)
    geometry = _as_geometry(plan, lo, positions, geometry)
    dev = positions.device
    dtype, f64 = kernel_dtype(positions)
    typed = form.ntypes > 1 or rc2_tab is not None
    state = cuda_slot_args(positions, types, valid, plan, geometry, typed, n)
    tab = form.tensor(dev, dtype)
    rc_t = 0
    if rc2_tab is not None:
        rc_t = rc2_tab.shape[0]
        _check(rc2_tab, (rc_t, rc_t), dtype, dev, "rc2_tab")
    n_ch = len(_channel_coefs(needs_energy, needs_virial))
    lib = _library()
    smem = lib.htf_half_stencil_smem(f64, plan.capacity, n_ch,
                                     form.smem_floats)
    dtab = None
    if smem > _MAX_SMEM and isinstance(form, ChebForm):
        # a proxy table too large to stage: the kernel reads it from
        # device memory
        dtab = torch.empty((form.smem_floats,), dtype=dtype, device=dev)
        smem = lib.htf_half_stencil_smem(f64, plan.capacity, n_ch, 0)
    if smem > _MAX_SMEM:
        raise ValueError(f"capacity {plan.capacity} needs {smem} bytes of "
                         f"shared memory per block, above {_MAX_SMEM}")
    sums = torch.empty((n_ch, len(_HALF_OFFS), n_cells * plan.capacity),
                       dtype=dtype, device=dev)
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
            f64, *state, geom, n_cells, _ptr(tab), form.ntypes, form.K,
            form.mid, form.inv_half, form.u_hi, _ptr(dtab), *rest)
    else:
        err = lib.htf_half_stencil(f64, *state, geom, n_cells, _ptr(tab),
                                   form.ntypes, int(form.strict), *rest)
    if err != 0:
        raise RuntimeError("half-stencil kernel launch failed: " +
                           lib.htf_error_string(err).decode())
    half_stencil_pair_forces.launches += 1
    if isinstance(form, ChebForm):
        half_stencil_pair_forces.proxy_launches += 1
    half_stencil_pair_forces.f64_launches += f64
    half_stencil_pair_forces.device_table_launches += dtab is not None
    return forces4, virial


#: calls that launched the kernel (two launches each), all forms and both
#: scalar types; those of its Chebyshev-proxy form alone; those of the
#: double instantiation alone (any form); those that read the proxy
#: table from device memory
half_stencil_pair_forces.launches = 0
half_stencil_pair_forces.proxy_launches = 0
half_stencil_pair_forces.f64_launches = 0
half_stencil_pair_forces.device_table_launches = 0
#: calls of the group launch (half_stencil_group_forces; also counted in
#: .launches and, by form and dtype, in the counters above)
half_stencil_pair_forces.group_launches = 0


def _ptrs(ts):
    """A ctypes array of the tensors' data pointers (null for ``None``)."""
    return (ctypes.c_void_p * len(ts))(
        *(None if t is None else t.data_ptr() for t in ts))


# the group launch's z0, prev and next of a whole state: its group of one
_WHOLE = ((ctypes.c_int * 1)(0), (ctypes.c_int * 1)(-1),
          (ctypes.c_int * 1)(-1))


@functools.lru_cache(maxsize=None)
def group_args(plan, group):
    """The group launch's integers of ``group`` (a
    :class:`.cellwise.SlabGroup` of ``plan``), made once per plan and
    group: ``(HalfGeom of its nzl, z0, prev, next)``, the last three
    ctypes int arrays. The buffers' pointers change from call to call and
    are passed beside them; nothing goes to the device."""
    nzl = group.slabs[0][1]
    if any(n != nzl for _, n in group.slabs):
        raise ValueError(f"a group of unequal slabs {group.slabs}")
    if len(group.slabs) > _MAX_GROUP:
        raise ValueError(f"a group of {len(group.slabs)} shards, above "
                         f"{_MAX_GROUP}")
    slab_shape(plan, group.slabs[0])
    arr = ctypes.c_int * len(group.slabs)
    return (half_geom(plan, nzl), arr(*(z0 for z0, _ in group.slabs)),
            arr(*group.prev), arr(*group.next))


def member_rows(plan, group, k, t):
    """The rows member ``k`` of ``group`` passes in ``t``: its slab
    buffer's ``(nzl + 1) nx ny cap``, or, when its next member is in the
    group and ``t`` holds just its home layers, ``nzl nx ny cap``."""
    n = slab_shape(plan, group.slabs[k])[1]
    if group.next[k] >= 0 and t.shape[0] == n - halo_layer(plan):
        return n - halo_layer(plan)
    return n


def check_group_inputs(positions, types, valid, plan, group, ct=None):
    """Raise unless the members' buffers (lists in group order) fit: one a
    member of the rows :func:`member_rows` allows, on one device, and
    ``ct`` (when given) ``[rows, 4]`` beside them."""
    G = len(group.slabs)
    if not (len(positions) == len(types) == len(valid) == G):
        raise ValueError(f"a group of {G} shards takes {G} buffers each")
    for k, (p, ty, v) in enumerate(zip(positions, types, valid)):
        n = member_rows(plan, group, k, p)
        check_slot_inputs(p, ty, v, plan, n)
        if ct is not None and tuple(ct[k].shape) != (n, 4):
            raise ValueError(f"ct: expected shape {(n, 4)}, got "
                             f"{tuple(ct[k].shape)}")


def _group_inputs(positions, types, valid, plan, group, geometry, typed):
    """Check a group call's buffers (one device, each a slab buffer's rows,
    a linked member's its home rows only) and return ``(n home cells a
    member, rows of a member's output, dtype, f64, the pointer arrays of
    positions, types (or None), valid, the box)``."""
    n_cells, rows = slab_shape(plan, group.slabs[0])
    G = len(group.slabs)
    if not (len(positions) == len(types) == len(valid) == G):
        raise ValueError(f"a group of {G} shards takes {G} buffers each")
    dev = positions[0].device
    dtype, f64 = kernel_dtype(positions[0])
    _check(geometry.box, (3, 3), dtype, dev, "geometry.box")
    for k, (p, ty, v) in enumerate(zip(positions, types, valid)):
        n = member_rows(plan, group, k, p)
        # one test of the common case; the full checks name what is wrong
        ok = (p.device == dev and v.device == dev and p.dtype == dtype and
              v.dtype == dtype and p.shape == (n, 3) and v.shape == (n,) and
              p.is_contiguous() and v.is_contiguous())
        if typed:
            ok = (ok and ty.device == dev and ty.dtype == torch.int32 and
                  ty.shape == (n,) and ty.is_contiguous())
        if not ok:
            if p.device != dev:
                raise ValueError(
                    f"a group's buffers lie on {p.device} and {dev}")
            cuda_slot_args(p, ty, v, plan, geometry, typed, n)
    return (n_cells, rows, dtype, f64, _ptrs(positions),
            _ptrs(types) if typed else None, _ptrs(valid),
            _ptr(geometry.box))


def half_stencil_group_forces(positions, types, valid, plan, lo, form, group,
                              needs_virial=False, min_r2=1e-4, rc2_tab=None,
                              needs_energy=True, geometry=None):
    """Kernel K1 in one launch over every home cell of the z-slab shards
    of ``group`` (a :class:`.cellwise.SlabGroup`), whose buffers lie on
    one device: a member's forward halo layer is read in place from the
    next member's first home layer when that is in the group, and the
    back sums across such a boundary are added in the whole state's order
    ``t = 1..13`` (``csrc/half_stencil_home.cuh``), so a group of every
    shard gives the unsharded K1's forces bit for bit. On CUDA tensors it
    launches the kernels (counted in ``half_stencil_pair_forces.launches``
    and ``.group_launches``, by form and dtype as that wrapper counts);
    CPU tensors take :func:`.cellwise.half_stencil_group_plain`.

    :param positions, types, valid: lists of the members' buffers in group
        order (a z-slab buffer's rows each, :func:`.cellwise.slab_rows`:
        its home layers then its forward halo layer; a member whose next
        member is in the group may pass its home rows only).
    :param geometry: the global plan's geometry on their device.
    :returns: ``(forces4, virial or None)``: lists over the members'
        buffer rows (views of one joined tensor each); a halo row is zero
        when the next member is in the group, else it holds the reverse
        halo the caller adds to the next shard.
    """
    if not positions[0].is_cuda:
        check_group_inputs(positions, types, valid, plan, group)
        return half_stencil_group_plain(
            positions, types, valid, plan, lo, form.evaluate, group,
            needs_virial, min_r2, form.ntypes > 1, rc2_tab, needs_energy,
            geometry)
    geometry = _as_geometry(plan, lo, positions[0], geometry)
    dev = positions[0].device
    typed = form.ntypes > 1 or rc2_tab is not None
    n_cells, n, dtype, f64, *state = _group_inputs(
        positions, types, valid, plan, group, geometry, typed)
    geom, z0, prev, nxt = group_args(plan, group)
    G = len(group.slabs)
    tab = form.tensor(dev, dtype)
    rc_t = 0
    if rc2_tab is not None:
        rc_t = rc2_tab.shape[0]
        _check(rc2_tab, (rc_t, rc_t), dtype, dev, "rc2_tab")
    n_ch = len(_channel_coefs(needs_energy, needs_virial))
    lib = _library()
    cheb = isinstance(form, ChebForm)
    smem = lib.htf_half_stencil_smem(f64, plan.capacity, n_ch,
                                     form.smem_floats)
    dtab = None
    if smem > _MAX_SMEM and cheb:
        dtab = torch.empty((form.smem_floats,), dtype=dtype, device=dev)
        smem = lib.htf_half_stencil_smem(f64, plan.capacity, n_ch, 0)
    if smem > _MAX_SMEM:
        raise ValueError(f"capacity {plan.capacity} needs {smem} bytes of "
                         f"shared memory per block, above {_MAX_SMEM}")
    sums = torch.empty((n_ch, len(_HALF_OFFS),
                        G * n_cells * plan.capacity), dtype=dtype, device=dev)
    forces4 = torch.empty((G, n, 4), dtype=dtype, device=dev)
    virial = (torch.empty((G, n, 3, 3), dtype=dtype, device=dev)
              if needs_virial else None)
    head = (f64, G, *state[:3], z0, prev, nxt, state[3], ctypes.byref(geom))
    rest = (_ptr(rc2_tab), rc_t, float(plan.r_cut ** 2), float(min_r2),
            int(needs_energy), int(needs_virial), _ptr(sums), _ptr(forces4),
            _ptr(virial),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if cheb:
        err = lib.htf_half_stencil_group_cheb(
            *head, _ptr(tab), form.ntypes, form.K, form.mid, form.inv_half,
            form.u_hi, _ptr(dtab), *rest)
    else:
        err = lib.htf_half_stencil_group(*head, _ptr(tab), form.ntypes,
                                         int(form.strict), *rest)
    if err != 0:
        raise RuntimeError("half-stencil group launch failed: " +
                           lib.htf_error_string(err).decode())
    k1 = half_stencil_pair_forces
    k1.launches += 1
    k1.group_launches += 1
    k1.proxy_launches += cheb
    k1.f64_launches += f64
    k1.device_table_launches += dtab is not None
    return forces4.unbind(0), (None if virial is None else virial.unbind(0))


# dynamic shared memory one H100 block may use (227 KB)
_MAX_SMEM = 232448
# shards a group launch takes (csrc/half_stencil_stage.cuh: kMaxGroup)
_MAX_GROUP = 16

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
            [ctypes.c_double] * 3 + [ctypes.c_void_p] + rest)
        lib.htf_half_stencil_cheb.restype = ctypes.c_int
        group = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 8
        lib.htf_half_stencil_group.argtypes = (
            group + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + rest)
        lib.htf_half_stencil_group.restype = ctypes.c_int
        lib.htf_half_stencil_group_cheb.argtypes = (
            group + [ctypes.c_void_p] + [ctypes.c_int] * 2 +
            [ctypes.c_double] * 3 + [ctypes.c_void_p] + rest)
        lib.htf_half_stencil_group_cheb.restype = ctypes.c_int
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


def lane_budget(plan, n_real, slab=None):
    """The first estimate of K1's generic-form list for ``n_real``
    particles on ``plan``, before any run has counted its need: per
    particle, half its neighbors within the cut (``2 pi / 3 r_cut^3
    rho``, each pair once) plus half its cell's mean occupancy times the
    share of a cell's pairs within the cut (:func:`same_cell_share`;
    block 0 lists those in both orders), with 25% headroom. With ``slab``
    (``(z0, nzl)``, a z-slab shard's) the share of its ``nzl`` home
    layers, whose cells own its lanes."""
    rho = n_real / float(np.prod(plan.lengths))
    share = same_cell_share(tuple(float(e) for e in plan.edges),
                            float(plan.r_cut))
    per = (2.0 * np.pi / 3.0 * plan.r_cut ** 3 * rho +
           0.5 * n_real / plan.n_cells * share)
    whole = int(np.ceil(_HEADROOM * n_real * per)) + 1024
    if slab is None:
        return whole
    return int(whole * slab[1] / plan.grid[2]) + 1024


def _default_lanes(plan, valid, slab=None):
    """A :class:`LaneBudget` of :func:`lane_budget` for the occupied slots
    of ``valid`` (one host sync); a slab buffer's layers (``nzl + 1``, or
    a group member's ``nzl`` home layers alone) stand for that share of a
    whole state as dense."""
    n_real = int((valid > 0).sum())
    if slab is not None:
        layers = valid.shape[0] // halo_layer(plan)
        n_real = int(n_real * plan.grid[2] / layers)
    return LaneBudget(lane_budget(plan, n_real, slab), valid.device)


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


def _lane_state(positions, types, valid, plan, lo, geometry, typed,
                slab=None):
    """The half-stencil tensor form's coordinates for listing lanes over
    the call's home cells (:func:`.cellwise.half_frame`; a z-slab shard's
    with ``slab``): ``(qx, qy, qz, gx, gy, gz)``, the row and candidate
    ``valid`` and float types (zero when untyped, as the kernel stages
    them)."""
    cap = plan.capacity
    rp, n, qx, qy, qz, gx, gy, gz = half_frame(positions, valid, plan, lo,
                                               geometry, slab)
    tt = (types.to(positions.dtype) if typed else
          torch.zeros_like(valid))

    def rows(t):
        return t[:n * cap].reshape(n, cap)

    def roll(t):
        return _roll_offs(t, rp, _HALF_OFFS)[:n]

    return (rows(qx), rows(qy), rows(qz), gx, gy, gz, rows(valid) > 0,
            roll(valid) > 0, rows(tt), roll(tt))


def generic_list_plain(positions, types, valid, plan, lo, min_r2=1e-4,
                       rc2_tab=None, geometry=None, budget=None,
                       typed=True, slab=None):
    """Plain PyTorch version of the generic form's list kernel: the
    in-cut lanes of the half stencil, cell by cell, each cell's lanes
    row-major (rows and candidates in slot order, occupied slots only) as
    the kernel lists them, the self pair left out in block 0, ``r2 =
    max(d2, min_r2)``. Cells are placed in cell order; a cell whose lanes
    would pass ``budget`` is left out whole. With ``slab = (z0, nzl)`` the
    inputs are a z-slab shard's buffer (:func:`.cellwise.slab_buffer`)
    and the lanes those of its home cells (``cell`` counts them from the
    slab's first; ``row`` and the candidates are buffer slots).

    :returns: a dict of per-lane tensors ``r2``, ``ti``, ``tj`` (float
        types), ``dx``, ``dy``, ``dz``, ``cell``, ``row`` and ``col``
        (the candidate's column in the ``14 * cap`` half-stencil plane),
        and ``needed``, the lanes of every cell (a Python int).
    """
    geometry = _as_geometry(plan, lo, positions, geometry)
    cap = plan.capacity
    n_cells = slab_shape(plan, slab)[0]
    C = len(_HALF_OFFS) * cap
    qx, qy, qz, gx, gy, gz, vr, vc, ti, tj = _lane_state(
        positions, types, valid, plan, lo, geometry,
        typed or rc2_tab is not None, slab)
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

    :param lst: :func:`generic_list_plain`'s lanes of a whole state.
    :returns: ``(forces4, virial or None)``.
    """
    planes = _list_planes(lst, U, S, plan.n_cells, plan.capacity,
                          needs_energy, needs_virial, valid.dtype)
    out = assemble_half(planes, plan)
    return finish_forces(out, valid, needs_energy, needs_virial)


def _list_planes(lst, U, S, n_cells, cap, needs_energy, needs_virial,
                 dtype):
    """The weighted half-stencil planes ``[n_ch, n_cells, 14 cap]`` of a
    plain list's lanes (its first ``len(lst["r2"])`` values of ``U`` and
    ``S``): block 0 each lane's channel products added to its row times
    the row-side coefficients, blocks 1..13 added to its candidate times
    the candidate-side ones (``index_add``: differentiable in ``U`` and
    ``S``)."""
    C = len(_HALF_OFFS) * cap
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
    dev = dx.device
    rows = torch.zeros((nch, n_cells * cap), dtype=dtype, device=dev)
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
    cols = (cols * bwd).reshape(nch, n_cells, C)[:, :, cap:]
    return torch.cat([out, cols], dim=2)


def generic_group_list_plain(positions, types, valid, plan, lo, group,
                             min_r2=1e-4, rc2_tab=None, geometry=None,
                             lanes=None, typed=True):
    """Plain PyTorch version of the generic form's list kernel over a group
    of z-slab shards on one device (:func:`generic_group_list`): each
    member's lanes (:func:`generic_list_plain` with its ``slab``, the
    forward halo read in place from the next member when that is in the
    group, :func:`.cellwise.group_rows`) joined member after member.
    ``lanes`` (one member's share) records ``ceil(need / members)``; cells
    past the group's list of ``members * lanes.budget`` lanes (in joined
    order) are left out.

    :returns: the joined list, a dict of per-lane tensors with ``member``
        (each member's ``cell`` counted from its slab's first home cell,
        ``row`` and the candidates its buffer's slots) and ``needed``."""
    G = len(group.slabs)
    layer = halo_layer(plan)
    lsts = []
    for k, slab in enumerate(group.slabs):
        buf = [group_rows(t, group, k, layer)
               for t in (positions, types, valid)]
        lst = generic_list_plain(*buf, plan, lo, min_r2, rc2_tab, geometry,
                                 None, typed, slab)
        lst["member"] = torch.full_like(lst["cell"], k)
        lsts.append(lst)
    joined = {key: torch.cat([x[key] for x in lsts]) for key in lsts[0]
              if key != "needed"}
    need = int(joined["r2"].shape[0])
    if lanes is not None:
        budget = G * lanes.budget
        if need > budget:
            n_cells = slab_shape(plan, group.slabs[0])[0]
            cell = joined["member"] * n_cells + joined["cell"]
            counts = torch.bincount(cell, minlength=G * n_cells)
            keep = (torch.cumsum(counts, 0) <= budget)[cell]
            joined = {key: v[keep] for key, v in joined.items()}
        lanes.record(torch.tensor(-(-need // G), device=valid[0].device))
    joined["needed"] = need
    return joined


def generic_group_reduce_plain(joined, U, S, valid, plan, group,
                               needs_energy=True, needs_virial=False):
    """Plain PyTorch version of the generic form's reduction over a group's
    joined list (:func:`generic_group_list_plain`; its first
    ``len(joined["r2"])`` values of ``U`` and ``S``): each member's
    weighted planes from its share of the lanes, then
    :func:`.cellwise.assemble_group`. Differentiable in ``U`` and ``S``.

    :returns: ``(forces4, virial or None)``: lists over the members'
        buffer rows."""
    n_cells = slab_shape(plan, group.slabs[0])[0]
    n = joined["r2"].shape[0]
    U, S = U[:n], S[:n]
    planes = []
    for k in range(len(group.slabs)):
        mine = joined["member"] == k
        lst = {key: v[mine] for key, v in joined.items() if key != "needed"}
        planes.append(_list_planes(lst, U[mine], S[mine], n_cells,
                                   plan.capacity, needs_energy, needs_virial,
                                   valid[k].dtype))
    return assemble_group(planes, valid, plan, group, needs_energy,
                          needs_virial)


def generic_group_plain(positions, types, valid, plan, lo, pair_fn, group,
                        typed_fn=True, needs_virial=False, min_r2=1e-4,
                        rc2_tab=None, needs_energy=True, geometry=None,
                        lanes=None):
    """Plain PyTorch version of K1's generic form over a group of z-slab
    shards on one device (:func:`generic_group_pair_forces`): the joined
    list (:func:`generic_group_list_plain`), the pair function called once
    on it, then :func:`generic_group_reduce_plain`.

    :returns: ``(forces4, virial or None, joined)``: lists over the
        members' buffer rows, and the joined list.
    """
    joined = generic_group_list_plain(positions, types, valid, plan, lo,
                                      group, min_r2, rc2_tab, geometry,
                                      lanes, typed_fn or rc2_tab is not None)
    U, S = _eval_pair_fn(pair_fn, typed_fn, joined["r2"], joined["ti"],
                         joined["tj"])
    f, w = generic_group_reduce_plain(joined, U, S, valid, plan, group,
                                      needs_energy, needs_virial)
    return f, w, joined


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
                 sums=None, stream=None, generation=None, group=None,
                 tables=None):
        self.plan, self.valid, self.typed_fn = plan, valid, typed_fn
        self.r2, self.ti, self.tj = r2, ti, tj
        self.lst = lst
        #: the :class:`.cellwise.SlabGroup` of a group's joined list
        #: (``valid`` then the members' buffers), or None for a whole
        #: state's
        self.group = group
        #: a group list's pointer arrays and links (the reduction's
        #: GroupTab: the buffers, z0, prev, next)
        self.tables = tables
        # CUDA only: the LaneBudget, the device's lane counter and records,
        # the cells' bases, the reduction's [n_ch][14][n_slots] scratch, the
        # stream and the generation of the shared buffers at the launch
        self.lanes, self.counter, self.rec = lanes, counter, rec
        self.cell_base, self.sums, self.stream = cell_base, sums, stream
        self.generation = generation
        if lst is None:
            self.budget, self.sums_ch = r2.shape[0], sums.shape[0]
            if group is None:
                self.geom = ctypes.byref(half_geom(plan))
                self.n_cells, self.rows = plan.n_cells, plan.n_slots
            else:
                self.geom = ctypes.byref(group_args(plan, group)[0])
                n_cells, self.rows = slab_shape(plan, group.slabs[0])
                self.n_cells = len(group.slabs) * n_cells
        #: the lanes the call needed, a device int32 (CUDA: set by the
        #: reduction)
        self.needed = None
        #: the key of the shared buffers this list lives in (its device, or
        #: its device and group: ``_GENERATION``)
        self.key = None

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
    list and records it shares on its device (a group's are kept apart:
    :func:`generic_group_list`) and counts a new generation of them. A
    z-slab shard's list is :func:`generic_group_list`'s group of one."""
    n_cells, n = plan.n_cells, plan.n_slots
    check_slot_inputs(positions, types, valid, plan)
    if lanes is None:
        lanes = _default_lanes(plan, valid)
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
    state = cuda_slot_args(positions, types, valid, plan, geometry, typed, n)
    rc_t = 0
    if rc2_tab is not None:
        rc_t = rc2_tab.shape[0]
        _check(rc2_tab, (rc_t, rc_t), dtype, dev, "rc2_tab")
    lib = _generic_library()
    smem = max(lib.htf_generic_smem(f64, plan.capacity),
               lib.htf_generic_reduce_smem(f64, plan.capacity),
               lib.htf_generic_reduce_bwd_smem(f64, plan.capacity))
    if smem > _MAX_SMEM:
        raise ValueError(f"capacity {plan.capacity} needs {smem} bytes of "
                         f"shared memory per block, above {_MAX_SMEM}")
    budget = lanes.budget
    counter, lst, rec = _generic_buffers(
        dev, dtype, budget, plan.r_cut ** 2,
        n_cells * lib.htf_generic_record_words(f64, plan.capacity))
    key = (str(dev), None)
    _GENERATION[key] = generation = _GENERATION.get(key, 0) + 1
    # the list kernel writes the zero back sums of the slots the box test
    # left out into the reduction's scratch
    n_ch = len(_channel_coefs(needs_energy, needs_virial))
    gl = GenericList(
        plan, valid, typed_fn, lst[0], lst[1], lst[2], lanes=lanes,
        counter=counter, rec=rec,
        cell_base=torch.empty(n_cells, dtype=torch.int32, device=dev),
        sums=torch.empty((n_ch, len(_HALF_OFFS), n_cells * plan.capacity),
                         dtype=dtype, device=dev),
        stream=ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
        generation=generation)
    gl.key = key
    err = lib.htf_generic_list(f64, *state, gl.geom, n_cells,
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
    ``generic_pair_forces.launches`` (and a group's in
    ``.group_launches``). Returns ``(forces4, virial or None)``; for a
    group's list, lists over the members' buffer rows."""
    if gl.lst is not None and gl.group is not None:
        return generic_group_reduce_plain(gl.lst, U, S, gl.valid, gl.plan,
                                          gl.group, needs_energy,
                                          needs_virial)
    if gl.lst is not None:
        return generic_reduce_plain(gl.lst, U, S, gl.valid, gl.plan,
                                    needs_energy, needs_virial)
    if gl.group is not None:
        f, w = _group_reduce(gl, U, S, needs_energy, needs_virial)
        return f.unbind(0), (None if w is None else w.unbind(0))
    plan, dev = gl.plan, gl.r2.device
    dtype, f64 = kernel_dtype(gl.r2)
    n_ch = len(_channel_coefs(needs_energy, needs_virial))
    if n_ch > gl.sums_ch:
        raise ValueError(f"a reduction of {n_ch} channels on a list made "
                         f"for {gl.sums_ch}")
    n = gl.rows
    U, S = U.contiguous(), S.contiguous()
    _check(U, (gl.budget,), dtype, dev, "U")
    _check(S, (gl.budget,), dtype, dev, "S")
    forces4 = torch.empty((n, 4), dtype=dtype, device=dev)
    virial = (torch.empty((n, 3, 3), dtype=dtype, device=dev)
              if needs_virial else None)
    gl.needed = torch.empty((), dtype=torch.int32, device=dev)
    lib = _generic_library()
    err = lib.htf_generic_reduce(f64, gl.geom, gl.n_cells, _ptr(gl.rec),
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


def generic_group_list(positions, types, valid, plan, lo, group,
                       typed_fn=True, min_r2=1e-4, rc2_tab=None,
                       geometry=None, lanes=None, needs_energy=True,
                       needs_virial=False):
    """The generic form's list kernel over the home cells of every member
    of ``group`` (a :class:`.cellwise.SlabGroup`; the members' buffers on
    one card, :func:`half_stencil_group_forces`' arguments): one launch
    writes every member's lanes into one joined list, each cell's segment
    placed by the one lane counter, of ``members * lanes.budget`` lanes
    (``lanes``: one member's share). Returns a :class:`GenericList` for
    :func:`generic_reduce` and :func:`generic_reduce_bwd`. The group's list
    and records are kept per device and group, a generation apart per
    launch. CPU tensors take :func:`generic_group_list_plain`."""
    typed = typed_fn or rc2_tab is not None
    G = len(group.slabs)
    if lanes is None:
        lanes = _default_lanes(plan, valid[0], group.slabs[0])
    if not positions[0].is_cuda:
        check_group_inputs(positions, types, valid, plan, group)
        joined = generic_group_list_plain(positions, types, valid, plan, lo,
                                          group, min_r2, rc2_tab, geometry,
                                          lanes, typed)
        return GenericList(plan, valid, typed_fn, joined["r2"], joined["ti"],
                           joined["tj"], joined, group=group)
    geometry = _as_geometry(plan, lo, positions[0], geometry)
    n_cells, _, dtype, f64, *state = _group_inputs(
        positions, types, valid, plan, group, geometry, typed)
    dev = positions[0].device
    rc_t = 0
    if rc2_tab is not None:
        rc_t = rc2_tab.shape[0]
        _check(rc2_tab, (rc_t, rc_t), dtype, dev, "rc2_tab")
    lib = _generic_library()
    smem = max(lib.htf_generic_smem(f64, plan.capacity),
               lib.htf_generic_reduce_smem(f64, plan.capacity),
               lib.htf_generic_reduce_bwd_smem(f64, plan.capacity))
    if smem > _MAX_SMEM:
        raise ValueError(f"capacity {plan.capacity} needs {smem} bytes of "
                         f"shared memory per block, above {_MAX_SMEM}")
    geom, z0, prev, nxt = group_args(plan, group)
    budget = G * lanes.budget
    key = ("group", group.slabs)
    counter, lst, rec = _generic_buffers(
        dev, dtype, budget, plan.r_cut ** 2,
        G * n_cells * lib.htf_generic_record_words(f64, plan.capacity), key)
    _GENERATION[(str(dev), key)] = generation = \
        _GENERATION.get((str(dev), key), 0) + 1
    n_ch = len(_channel_coefs(needs_energy, needs_virial))
    gl = GenericList(
        plan, valid, typed_fn, lst[0], lst[1], lst[2], lanes=lanes,
        counter=counter, rec=rec,
        cell_base=torch.empty(G * n_cells, dtype=torch.int32, device=dev),
        sums=torch.empty((n_ch, len(_HALF_OFFS),
                          G * n_cells * plan.capacity), dtype=dtype,
                         device=dev),
        stream=ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
        generation=generation, group=group,
        tables=(state[:3], z0, prev, nxt))
    gl.key = (str(dev), key)
    err = lib.htf_generic_group_list(
        f64, G, *state[:3], z0, prev, nxt, state[3], gl.geom, _ptr(rc2_tab),
        rc_t, float(plan.r_cut ** 2), float(min_r2), budget, _ptr(counter),
        _ptr(gl.cell_base), _ptr(gl.r2), _ptr(gl.ti), _ptr(gl.tj),
        _ptr(rec), _ptr(gl.sums), gl.sums_ch, gl.stream)
    if err != 0:
        counter.zero_()
        raise RuntimeError("generic group list launch failed: " +
                           lib.htf_generic_error_string(err).decode())
    return gl


def _group_reduce(gl, U, S, needs_energy, needs_virial):
    """:func:`generic_reduce` of a group's joined list on the card: the
    reduction over the group's home cells and the group home pass;
    ``(forces4 [members, rows, 4], virial [members, rows, 3, 3] or
    None)``, a member's buffer rows each. Records ``ceil(need /
    members)`` in ``gl.lanes``."""
    dev = gl.r2.device
    dtype, f64 = kernel_dtype(gl.r2)
    n_ch = len(_channel_coefs(needs_energy, needs_virial))
    if n_ch > gl.sums_ch:
        raise ValueError(f"a reduction of {n_ch} channels on a list made "
                         f"for {gl.sums_ch}")
    G = len(gl.group.slabs)
    U, S = U.contiguous(), S.contiguous()
    _check(U, (gl.budget,), dtype, dev, "U")
    _check(S, (gl.budget,), dtype, dev, "S")
    forces4 = torch.empty((G, gl.rows, 4), dtype=dtype, device=dev)
    virial = (torch.empty((G, gl.rows, 3, 3), dtype=dtype, device=dev)
              if needs_virial else None)
    gl.needed = torch.empty((), dtype=torch.int32, device=dev)
    (pos, types, valid), z0, prev, nxt = gl.tables
    lib = _generic_library()
    err = lib.htf_generic_group_reduce(
        f64, G, pos, types, valid, z0, prev, nxt, gl.geom, _ptr(gl.rec),
        _ptr(gl.cell_base), _ptr(U), _ptr(S), int(needs_energy),
        int(needs_virial), _ptr(gl.sums), _ptr(forces4), _ptr(virial),
        _ptr(gl.counter), _ptr(gl.needed), gl.stream)
    if err != 0:
        gl.counter.zero_()
        raise RuntimeError("generic group reduction launch failed: " +
                           lib.htf_generic_error_string(err).decode())
    gen = generic_pair_forces
    gen.launches += 1
    gen.group_launches += 1
    gen.f64_launches += f64
    gl.lanes.record(torch.div(gl.needed + (G - 1), G,
                              rounding_mode="floor"))
    return forces4, virial


def generic_group_pair_forces(positions, types, valid, plan, lo, pair_fn,
                              group, typed_fn=True, needs_virial=False,
                              min_r2=1e-4, rc2_tab=None, needs_energy=True,
                              geometry=None, lanes=None):
    """K1's generic form over a group of z-slab shards on one device
    (:func:`half_stencil_group_forces`' contract): the list kernel over
    every member's home cells into one joined list
    (:func:`generic_group_list`), the pair function called once on it,
    then one reduction and the group home pass, counted in
    ``generic_pair_forces.launches`` and ``.group_launches``. CPU tensors
    take :func:`generic_group_plain`. ``lanes`` is one member's share of
    the list (the group's holds ``members * lanes.budget`` lanes) and
    records ``ceil(need / members)``, so it overflows exactly when the
    joined list does. Returns lists over the members' buffer rows."""
    if not positions[0].is_cuda:
        f, w, _ = generic_group_plain(
            positions, types, valid, plan, lo, pair_fn, group, typed_fn,
            needs_virial, min_r2, rc2_tab, needs_energy, geometry, lanes)
        return f, w
    gl = generic_group_list(positions, types, valid, plan, lo, group,
                            typed_fn, min_r2, rc2_tab, geometry, lanes,
                            needs_energy, needs_virial)
    U, S = gl.evaluate(pair_fn)
    return generic_reduce(gl, U, S, needs_energy, needs_virial)


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

    A z-slab shard of a mesh is :func:`generic_group_pair_forces`' group
    of one.
    """
    check_slot_inputs(positions, types, valid, plan)
    if lanes is None:
        lanes = _default_lanes(plan, valid)
    if not positions.is_cuda:
        return generic_plain(positions, types, valid, plan, lo, pair_fn,
                             typed_fn, needs_virial, min_r2, rc2_tab,
                             needs_energy, geometry, lanes)
    gl = generic_list(positions, types, valid, plan, lo, typed_fn, min_r2,
                      rc2_tab, geometry, lanes, needs_energy, needs_virial)
    U, S = gl.evaluate(pair_fn)
    return generic_reduce(gl, U, S, needs_energy, needs_virial)


#: calls that launched the generic form's reduction (generic_reduce, after
#: its list kernel: three launches each), training's forward included;
#: and those of the double instantiation alone
generic_pair_forces.launches = 0
generic_pair_forces.f64_launches = 0
#: those over a group of z-slab shards (generic_group_pair_forces)
generic_pair_forces.group_launches = 0


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
                             n_lanes=None, slab=None, group=None):
    """Plain PyTorch version of ``generic_reduce_bwd``: the transpose of
    :func:`generic_reduce_plain` in ``(U, S)``. Per listed lane, with the
    cotangent folded with ``valid`` (the finish multiplies by it), ``gU =
    0.5 ct_e[i] + [block >= 1] 0.5 ct_e[j]`` and ``gS = sum_k d_k (2
    ct_k[i] - [block >= 1] 2 ct_k[j])``, ``i`` the lane's row slot and
    ``j`` its candidate's own slot (block 0 lists both orders: the row
    term only).

    :param n_lanes: the length of the returned cotangents (default the
        listed lanes); lanes past the listed ones get exactly zero.
    :param slab: ``(z0, nzl)``: ``lst`` is a z-slab shard's list and
        ``ct``, ``valid`` its buffers (:func:`.cellwise.slab_buffer`): a
        candidate in the halo layer reads the cotangent of the next
        shard's first home layer there.
    :param group: a :class:`.cellwise.SlabGroup`: ``lst`` is the group's
        joined list (:func:`generic_group_list_plain`), ``ct`` and
        ``valid`` the members' buffers in group order (``ct`` also the
        joined ``[members, rows, 4]``): a member's candidate in its halo
        layer reads the next member's first home layer when that is in
        the group. A z-slab shard's list is its group of one.
    :returns: ``(gU or None when not needs_energy, gS)``.
    """
    if group is not None:
        layer = halo_layer(plan)
        parts = []
        for k, sl in enumerate(group.slabs):
            mine = lst["member"] == k
            sub = {key: v[mine] for key, v in lst.items() if key != "needed"}
            parts.append(generic_reduce_bwd_plain(
                sub, group_rows(list(ct), group, k, layer),
                group_rows(valid, group, k, layer), plan, needs_energy,
                slab=sl))
        gS = torch.cat([x[1] for x in parts])
        gU = torch.cat([x[0] for x in parts]) if needs_energy else None
        # the joined list is member after member: the parts in its order
        return _pad_lanes(gU, gS, n_lanes)
    cap = plan.capacity
    if slab is not None:
        # a home cell's half stencil reaches z + 1 only: its candidates'
        # cells are the buffer plan's, with no wrap in z
        plan = _slab_plan(plan, slab[1])
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
    return _pad_lanes(gU, gS, n_lanes)


def _pad_lanes(gU, gS, n_lanes):
    """``(gU, gS)`` padded with zeros to ``n_lanes`` (``None``: as they
    are)."""
    pad = 0 if n_lanes is None else int(n_lanes) - gS.shape[0]
    if pad > 0:
        gS = torch.nn.functional.pad(gS, (0, pad))
        gU = None if gU is None else torch.nn.functional.pad(gU, (0, pad))
    return gU, gS


def generic_reduce_bwd(gl, ct, needs_energy=True):
    """Kernel ``generic_reduce_bwd``, the backward of the generic form's
    reduction: the cotangents ``(gU or None, gS)`` of the pair function's
    ``(U, S)`` on the list ``gl``, given the cotangent ``ct`` of the
    forces: ``[n_slots, 4]`` of a whole state's list, or for a group's
    joined list (:func:`generic_group_list`) ``[members,
    rows, 4]`` (or a list of the members' ``[rows, 4]``), a member's halo
    rows read only when its next member lies outside the group. On a CUDA
    list it launches the kernel over every home cell of the list (counted
    in ``generic_reduce_bwd.launches``, and in ``.group_launches`` for a
    group's list; a whole state's runs as its group of one), which reads
    the list
    kernel's records of ``gl`` and writes every lane of the budget (zero
    where no pair is listed); it raises when a later list call has
    rewritten those records. On a CPU list it takes
    :func:`generic_reduce_bwd_plain`."""
    plan = gl.plan
    if gl.lst is not None:
        return generic_reduce_bwd_plain(gl.lst, ct, gl.valid, plan,
                                        needs_energy, gl.r2.shape[0],
                                        group=gl.group)
    dev = gl.r2.device
    if _GENERATION.get(gl.key) != gl.generation:
        raise RuntimeError(
            "the generic form's list and records were rewritten by a later "
            "generic-form call before this call's backward ran")
    if gl.needed is None:
        raise RuntimeError("the backward of a generic-form list whose "
                           "reduction did not run")
    dtype, f64 = kernel_dtype(gl.r2)
    if gl.group is None:
        ct = ct.contiguous()
        _check(ct, (gl.rows, 4), dtype, dev, "ct")
        tab = (1, _ptrs([ct]), _ptrs([gl.valid]), *_WHOLE)
    else:
        G = len(gl.group.slabs)
        cts = []
        for k, c in enumerate(ct):
            c = c.contiguous()
            _check(c, (member_rows(plan, gl.group, k, c), 4), dtype, dev,
                   "ct")
            cts.append(c)
        _, z0, prev, nxt = gl.tables
        tab = (G, _ptrs(cts), gl.tables[0][2], z0, prev, nxt)
    gS = torch.empty(gl.budget, dtype=dtype, device=dev)
    gU = torch.empty_like(gS) if needs_energy else None
    lib = _generic_library()
    err = lib.htf_generic_reduce_bwd(
        f64, *tab, gl.geom, _ptr(gl.rec), _ptr(gl.cell_base),
        int(needs_energy), _ptr(gl.needed), gl.budget, _ptr(gU), _ptr(gS),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError("generic reduction backward launch failed: " +
                           lib.htf_generic_error_string(err).decode())
    bwd = generic_reduce_bwd
    bwd.launches += 1
    bwd.f64_launches += f64
    bwd.group_launches += gl.group is not None
    return gU, gS


#: calls that launched generic_reduce_bwd; those of its double
#: instantiation alone; those on a group's joined list
generic_reduce_bwd.launches = 0
generic_reduce_bwd.f64_launches = 0
generic_reduce_bwd.group_launches = 0


class GenericReduce(torch.autograd.Function):
    """The generic form's reduction and finish as a differentiable
    function of the pair function's ``(U, S)`` on a :class:`GenericList`:
    forward :func:`generic_reduce` (forces only, no virial), backward
    :func:`generic_reduce_bwd`. ``apply(U, S, gl, needs_energy) ->
    forces4`` (a group's list: ``[members, rows, 4]``); without the
    energy, ``U`` gets no gradient."""

    @staticmethod
    def forward(ctx, U, S, gl, needs_energy):
        ctx.gl, ctx.needs_energy = gl, needs_energy
        U, S = U.detach(), S.detach()
        if gl.group is not None and gl.lst is None:
            return _group_reduce(gl, U, S, needs_energy, False)[0]
        f4, _ = generic_reduce(gl, U, S, needs_energy)
        return torch.stack(f4) if gl.group is not None else f4

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
    Arguments as :func:`generic_pair_forces`; no virial."""
    gl = generic_list(positions, types, valid, plan, lo, typed_fn, min_r2,
                      rc2_tab, geometry, lanes, needs_energy)
    U, S = gl.evaluate(pair_fn, grad=True)
    if not needs_energy:
        U = U.detach()
    return GenericReduce.apply(U, S, gl, needs_energy).to(positions.dtype)


def generic_group_train_forces(positions, types, valid, plan, lo, pair_fn,
                               group, typed_fn=True, min_r2=1e-4,
                               rc2_tab=None, needs_energy=True,
                               geometry=None, lanes=None):
    """K1's generic form for training over a group of z-slab shards on one
    device: one list over every member's home cells
    (:func:`generic_group_list`, its plain version on the CPU), the pair
    function run once on the joined list with grad, then
    :class:`GenericReduce`, whose backward is ``generic_reduce_bwd`` over
    the group. Arguments as :func:`generic_group_pair_forces`; no virial.

    :returns: ``forces4 [members, (nzl + 1) nx ny cap, 4]``, differentiable
        in the weights ``pair_fn`` reads (a member's halo rows zero when
        its next member is in the group, else its reverse halo)."""
    gl = generic_group_list(positions, types, valid, plan, lo, group,
                            typed_fn, min_r2, rc2_tab, geometry, lanes,
                            needs_energy)
    U, S = gl.evaluate(pair_fn, grad=True)
    if not needs_energy:
        U = U.detach()
    return GenericReduce.apply(U, S, gl, needs_energy).to(
        positions[0].dtype)


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


# per device and None (a whole state) or group (("group", its slabs)):
# the generation of the shared list and records below (one more
# at each list launch; a backward checks its call's)
_GENERATION = {}

# per device, scalar type and None or group: the lane counter (zero between
# calls), the list buffer ([3, budget] r2, ti, tj in the state's dtype),
# first filled with harmless in-cut values, so that later calls leave
# earlier lanes' finite values in its tail, and the cells' records the
# list kernel hands the reduction. Each device of a mesh keeps its group's
# own: a training step lists every group before the first backward reads
# its records, and the pair function's graph holds its list's r2.
_GENERIC = {}


def _generic_buffers(device, dtype, budget, rc2, rec_words, group=None):
    key = (str(device), dtype, group)
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
            [ctypes.c_int] * 2 + [ctypes.c_void_p] * 8 +
            [ctypes.c_int, ctypes.c_void_p, ctypes.c_int] +
            [ctypes.c_void_p] * 3)
        lib.htf_generic_reduce_bwd.restype = ctypes.c_int
        lib.htf_generic_reduce_bwd_smem.argtypes = [ctypes.c_int] * 2
        lib.htf_generic_reduce_bwd_smem.restype = ctypes.c_long
        group = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6
        lib.htf_generic_group_list.argtypes = (
            group + [ctypes.c_void_p] * 2 + geo +
            [ctypes.c_double, ctypes.c_int] +
            [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_void_p])
        lib.htf_generic_group_list.restype = ctypes.c_int
        lib.htf_generic_group_reduce.argtypes = (
            group + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 +
            [ctypes.c_void_p] * 6)
        lib.htf_generic_group_reduce.restype = ctypes.c_int
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
