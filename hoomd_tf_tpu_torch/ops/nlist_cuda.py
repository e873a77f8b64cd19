"""Kernel K3: the cell-list neighbor selection, hand-written in CUDA C++
for Hopper (``csrc/nlist_select.cu``).

PyTorch counterpart of ``hoomd_tf_tpu/ops/nlist_pallas.py``
(``pallas_cell_select``, the kernel ``_kernel`` at line 43). It computes
the same function: for every occupied query slot of the cell list, the
minimum-image displacement ``d`` to each candidate of the 27 neighbouring
cells, valid when ``2.5e-7 <= d2 <= r_cut^2``; the NN smallest by an
int32 key, the float32 bits of ``d2`` with the low ``slot_bits`` cleared
and OR-ed with the candidate slot ``j = k cap + r`` (offset ``k`` of the
stencil, rank ``r`` in the cell); for float64 slots an int64 key, the
float64 bits of ``d2`` with the same low bits cleared (the kernel's double
instantiation). ``slot_bits`` is the bit length of
``cpad - 1`` with ``cpad`` the JAX package's lane-padded width
``ceil(27 cap / 128) 128``: kept though nothing here is padded, so the
port's neighbor order equals the JAX package's. Columns fill nearest
first; columns past the row's valid count are zero.

The TPU kernel takes ``[n_cells, 27 cap]`` candidate matrices that XLA
gathers beforehand, and lifts rows with one-hot matmuls. The CUDA kernel
stages each strip of cells' neighbourhood once from the ``[n_cells cap,
4]`` slot rows, so the candidate matrix never reaches device memory, and
writes each particle-order row of the ``[N, NN, 4]`` list once, padding
included (the TPU path's four row gathers and stack fused away; the
wrapper allocates the list with ``torch.empty``). Its minimum image
decides the shift by thresholds of the slots' dtype
(:func:`image_thresholds`, :func:`threshold_min_image`) and divides only
where they cannot decide.

:func:`nlist_select` launches the kernel for CUDA tensors and uses the
plain version, :func:`nlist_select_reference`, only for CPU tensors.
The launch constants of a plan are made once (:func:`launch_params`).

The group mode (``group=``, runs of layers) is one launch for the z-slab
shards of a device mesh that one device holds
(:meth:`.cell_list.CellNlist.sharded`), over the strips of their home
layers only. On the device that binned the particles it reads the cell
table in place and writes each held query's row by ``pid`` into the
particle-order list (and zeroes the rows of particles without a slot);
on any other device (``pid=None``) it reads the group's joined buffer
(:func:`.cell_stencil.joined_slab`: each run's home layers with one halo
layer on each side, since the 27-cell window reaches ``z - 1`` and ``z +
1``) and writes the home slots' rows in slot order, which the binning
device scatters in by ``pid``. Either way a row equals the unsharded
call's row of its particle bit for bit: the window's cells, their order
and the arithmetic are the same. A shard alone is a group of one.
"""

import ctypes
import functools

import numpy as np
import torch

from .cell_stencil import (cell_chunks, check_group, chunk_pairs,
                           group_cells)
from .nlist import f32

__all__ = ["nlist_select", "nlist_select_reference", "selection_keys",
           "slot_bits", "image_thresholds", "threshold_min_image",
           "launch_shape", "launch_params", "launch"]

#: key of an invalid candidate (bit pattern of a huge positive float), and
#: its float64 counterpart (of a huge positive double)
FAR_KEY = 0x7F000000
FAR_KEY64 = 0x7FE0000000000000


def cut_values(r_cut, dtype):
    """``(rc2, lo2)``: the selection's squared cuts in ``dtype``'s
    precision, as Python floats: float32-rounded for float32 (the JAX
    package's values), exact for float64."""
    rc2, lo2 = float(r_cut) * float(r_cut), 25e-8
    if dtype == torch.float64:
        return rc2, lo2
    return f32(rc2), f32(lo2)


def host_length(v, dtype):
    """A box length as the kernel takes it: float32-rounded for float32
    slots, as given for float64."""
    return float(v) if dtype == torch.float64 else f32(v)


def slot_bits(width):
    """Low key bits that carry the candidate slot, for ``width``
    candidates per row (the JAX package's lane-padded width)."""
    cpad = -(-int(width) // 128) * 128
    return max(1, cpad - 1).bit_length()


def selection_keys(ddx, ddy, ddz, r_cut, bits):
    """``(key, d2)`` of candidate lanes from their displacements, in the
    kernel's arithmetic (``d2 = dx dx + dy dy + dz dz``, left to right,
    no fused multiply-add): slot-tagged keys along the last axis, int32
    from float32 ``d2`` (:data:`FAR_KEY` where invalid), int64 from
    float64 ``d2`` (:data:`FAR_KEY64`)."""
    d2 = ddx * ddx + ddy * ddy + ddz * ddz
    rc2, lo2 = cut_values(r_cut, d2.dtype)
    valid = (d2 <= rc2) & (d2 >= lo2)
    itype, far = ((torch.int64, FAR_KEY64) if d2.dtype == torch.float64
                  else (torch.int32, FAR_KEY))
    slot = torch.arange(d2.shape[-1], dtype=itype, device=d2.device)
    key = (d2.view(itype) & ~((1 << bits) - 1)) | slot
    return torch.where(valid, key, far), d2


def _select(ddx, ddy, ddz, gt, r_cut, NN, bits):
    """Rows of the list from ``[rows, C]`` displacement and type lanes:
    ``[rows, NN, 4]``."""
    rows, C = ddx.shape
    key, _ = selection_keys(ddx, ddy, ddz, r_cut, bits)
    k = min(NN, C)
    sel, idx = torch.topk(key, k, dim=1, largest=False, sorted=True)
    far = FAR_KEY64 if key.dtype == torch.int64 else FAR_KEY
    keep = (sel != far).to(ddx.dtype)
    out = torch.zeros((rows, NN, 4), dtype=ddx.dtype, device=ddx.device)
    for a, p in enumerate((ddx, ddy, ddz, gt)):
        out[:, :k, a] = torch.gather(p, 1, idx) * keep
    return out


def nlist_select_reference(slots4, counts, pid, grid, capacity, NN, r_cut,
                           lengths, n, group=None, out=None):
    """Plain PyTorch version of K3 with the kernel's interface (see
    :func:`nlist_select`), chunked over cells to bound its memory; with
    ``group`` its group mode: in place (``pid`` given) the rows of the
    particles held in the group's layers and of the particles without a
    slot written into ``out`` (default a zero list), the other rows left
    as they are; joined (``pid=None``) the rows of the home slots of the
    joined buffer in slot order (zero rows for empty slots)."""
    cap = int(capacity)
    joined = pid is None
    if joined and group is None:
        raise ValueError("a joined buffer needs its group's runs")
    runs = check_group(grid, group)
    dev = slots4.device
    qcells, neigh = group_cells(grid, runs, joined, dev)
    L = torch.tensor([host_length(v, slots4.dtype) for v in lengths],
                     dtype=slots4.dtype, device=dev)
    bits = slot_bits(27 * cap)
    rows = []
    for c0, c1 in cell_chunks(qcells.shape[0], cap):
        ddx, ddy, ddz, _, _, gt = chunk_pairs(slots4, neigh, cap, L, c0, c1,
                                              qcells)
        C = ddx.shape[-1]
        rows.append(_select(ddx.reshape(-1, C), ddy.reshape(-1, C),
                            ddz.reshape(-1, C),
                            gt.expand_as(ddx).reshape(-1, C), r_cut, NN,
                            bits))
    rows = torch.cat(rows)
    if joined:
        return rows
    # the group's held rows by pid, and the rows of particles that hold
    # no slot (zero); ``out`` keeps the rows held outside the group
    p = pid.long()[(qcells[:, None] * cap +
                    torch.arange(cap, device=dev)).reshape(-1)]
    dest = torch.where(p >= 0, p, n)
    mine = torch.zeros((n + 1,) + tuple(rows.shape[1:]), dtype=rows.dtype,
                       device=dev)
    mine[dest] = rows
    if out is None:
        return mine[:n]
    keep = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    keep[torch.where(pid >= 0, pid.long(), n)] = True
    keep[dest] = False
    out[:n] = torch.where(keep[:n, None, None], out[:n], mine[:n])
    return out


def image_thresholds(length, dtype=torch.float32):
    """``(t0, t1, t2)``: thresholds on ``|d|`` that decide the
    minimum-image shift ``s = rint(fl(d / L))`` for the length ``L`` in
    ``dtype`` (float32, or float64 for the double kernel): ``|d| <= t0``
    gives ``s = 0`` and ``t1 <= |d| <= t2`` gives ``s = sign(d)``. Values
    of ``dtype``, rounded inward from ``0.49 L``, ``0.51 L`` and ``1.49
    L``, so that the division in ``dtype``, monotone in ``d``, lands on the
    same side of ``0.5`` and ``1.5`` as the thresholds do."""
    ntype = np.float64 if dtype == torch.float64 else np.float32
    L = float(ntype(length))

    def down(x):
        v = ntype(x)
        return v if float(v) <= x else np.nextafter(v, ntype(-np.inf))

    def up(x):
        v = ntype(x)
        return v if float(v) >= x else np.nextafter(v, ntype(np.inf))
    return down(0.49 * L), up(0.51 * L), down(1.49 * L)


def threshold_min_image(d, L, thresholds):
    """Plain version of K3's minimum-image rule: the shift decided by
    :func:`image_thresholds`, the IEEE ``round(d / L)`` only where they
    cannot decide (``|d|`` near ``L / 2`` or past ``1.49 L``), then ``d - s
    L``. Equal bit for bit to ``d - torch.round(d / L) * L``.

    :param d: float32 (or float64) tensor of displacements along one axis.
    :param L: 0-d tensor of ``d``'s dtype, the box length.
    :param thresholds: ``image_thresholds(L, d.dtype)``.
    """
    t0, t1, t2 = (float(t) for t in thresholds)
    a = d.abs()
    near = a <= t0
    one = (a >= t1) & (a <= t2)
    s = torch.copysign(torch.where(near, 0.0, 1.0).to(d.dtype), d)
    s = torch.where(near | one, s, torch.round(d / L))
    return d - s * L


#: shared memory of one H100 SM, and the most one block may take
SMEM_PER_SM = 233472
SMEM_PER_BLOCK = 232448
#: the runtime's own shared memory per block, and the kernel's static array
_SMEM_RESERVED = 1024 + 32
#: the most runs of layers a group launch takes (``kMaxRuns`` of
#: csrc/nlist_select.cu)
MAX_RUNS = 16
#: the most warps a block runs, and the cells of a strip the launch aims
#: at (the fastest of strips of 1 to 18 cells at the packed path's plan,
#: measured on an H100: profile_step.py --mode calls)
MAX_WARPS = 8
STRIP = 2


def smem_bytes(cap, nn, strip, warps, f64=False):
    """Dynamic shared memory of one K3 block (csrc/nlist_select.cu's
    ``smem_bytes``, which checks it at launch): the window's ``(strip + 2)
    x 9`` cells of ``cap`` slots (16 bytes each, 32 in float64), per warp
    a key buffer of ``27 cap`` keys (4 bytes each, 8 in float64; a
    multiple of 4 keys) and ``nn`` winners, the window's prefix and cell
    ids and the strip's query prefix."""
    nw = (strip + 2) * 9
    slot, key = (32, 8) if f64 else (16, 4)
    return (slot * nw * cap + key * warps * ((27 * cap + 3) // 4 * 4) +
            4 * warps * nn + 4 * (nw + 1) + 4 * nw + 4 * (strip + 1))


def launch_shape(nx, cap, nn, strip=None, warps=None, f64=False):
    """``(strip, warps, smem)`` of a K3 launch: the warps per block (up to
    8) and blocks per SM (two, else one) that run the most warps on an SM
    when the strip is one cell, preferring two blocks; then the longest
    strip up to :data:`STRIP` cells that keeps that, evened out over
    ``nx``: ``ceil(nx / strip)`` strips of ``ceil(nx / n_strips)`` cells,
    the last one ragged where ``nx`` does not divide. ``strip`` and
    ``warps`` force a shape (to measure one); ``ValueError`` when no block
    fits. ``f64``: the double instantiation's shared memory."""
    budgets = {2: SMEM_PER_SM // 2 - _SMEM_RESERVED,
               1: SMEM_PER_BLOCK - _SMEM_RESERVED}
    if strip is not None or warps is not None:
        s = min(int(strip or STRIP), nx)
        w = int(warps or MAX_WARPS)
        if not (1 <= s and 1 <= w <= MAX_WARPS and
                smem_bytes(cap, nn, s, w, f64) <= budgets[1]):
            raise ValueError(f"K3 launch shape strip {s}, warps {w} does "
                             f"not fit capacity {cap}, NN {nn}")
        return s, w, smem_bytes(cap, nn, s, w, f64)
    shapes = [(w * blocks, blocks, w) for blocks in (2, 1)
              for w in range(MAX_WARPS, 0, -1)
              if smem_bytes(cap, nn, 1, w, f64) <= budgets[blocks]]
    if not shapes:
        raise ValueError(f"capacity {cap}, NN {nn}: one K3 block needs "
                         "more shared memory than an H100 block has")
    _, blocks, w = max(shapes)
    longest = max(s for s in range(1, min(STRIP, nx) + 1)
                  if smem_bytes(cap, nn, s, w, f64) <= budgets[blocks])
    s = -(-nx // -(-nx // longest))
    return s, w, smem_bytes(cap, nn, s, w, f64)


class K3Params(ctypes.Structure):
    """The kernel's launch constants (``K3Params`` of
    csrc/nlist_select.cu, field for field): the lengths, cuts and
    thresholds as doubles (exact for a float32 plan), ``f64`` the scalar
    type of the slots and the list, ``joined`` the table a joined buffer
    (``nz`` then its layers), and the runs of home layers the launch
    covers, as layers of that table."""
    _fields_ = ([(f, ctypes.c_int) for f in
                 ("nx", "ny", "nz", "cap", "nn", "strip", "warps",
                  "n_strips", "smem", "f64", "joined", "n_runs")] +
                [(f, ctypes.c_int * MAX_RUNS) for f in
                 ("run_z0", "run_nzl")] +
                [("slot_mask", ctypes.c_uint), ("rc2", ctypes.c_double),
                 ("lo2", ctypes.c_double)] +
                [(f, ctypes.c_double * 3) for f in ("L", "t0", "t1", "t2")])


@functools.lru_cache(maxsize=32)
def launch_params(grid, capacity, NN, r_cut, lengths, strip=None,
                  warps=None, dtype=torch.float32, group=None, joined=False):
    """The launch constants of one plan, made once (cached): the launch
    shape, the slot mask, the cuts, lengths and minimum-image thresholds
    in ``dtype`` (float32, or float64 for the double kernel). ``strip`` and
    ``warps`` force a shape (:func:`launch_shape`). ``group``: the runs of
    layers of a group launch (default every layer, the unsharded call);
    ``joined``: on the group's joined buffer (its layers then the
    kernel's table) instead of the cell table in place."""
    nx, ny, nz = (int(g) for g in grid)
    if min(nx, ny, nz) < 3:
        raise ValueError(f"grid {grid}: the 27-cell stencil needs >= 3 "
                         "cells per axis")
    runs = check_group(grid, group)
    if len(runs) > MAX_RUNS:
        raise ValueError(f"{len(runs)} runs of layers: a K3 launch takes "
                         f"at most {MAX_RUNS}")
    if joined:
        # run r's home layers start after the runs before it, their halo
        # layers, and its own lower halo layer
        starts = np.cumsum([0] + [k + 2 for _, k in runs])
        table = tuple((int(b) + 1, k) for b, (_, k) in zip(starts, runs))
        nz = int(starts[-1])
    else:
        table = runs
    cap, nn = int(capacity), int(NN)
    f64 = dtype == torch.float64
    s, w, smem = launch_shape(nx, cap, nn, strip, warps, f64)
    L = [host_length(v, dtype) for v in lengths]
    th = [image_thresholds(v, dtype) for v in L]
    pad = [0] * (MAX_RUNS - len(table))
    return K3Params(
        nx, ny, nz, cap, nn, s, w, -(-nx // s), smem, int(f64), int(joined),
        len(table), (ctypes.c_int * MAX_RUNS)(*[z for z, _ in table], *pad),
        (ctypes.c_int * MAX_RUNS)(*[k for _, k in table], *pad),
        (1 << slot_bits(27 * cap)) - 1, *cut_values(r_cut, dtype),
        (ctypes.c_double * 3)(*L),
        *((ctypes.c_double * 3)(*(float(t[a]) for t in th))
          for a in range(3)))


def nlist_select(slots4, counts, pid, grid, capacity, NN, r_cut, lengths,
                 n, group=None, out=None):
    """Kernel K3. Launches the CUDA kernel on CUDA tensors (and counts the
    launch in ``nlist_select.launches``, a group launch also in
    ``nlist_select.group_launches``); CPU tensors take
    :func:`nlist_select_reference`. Anything else raises.

    :param slots4: ``[n_cells * cap, 4]`` cell slots ``(x, y, z, type)``,
        float32 or float64 (the double kernel); empty slots hold a far
        sentinel.
    :param counts: ``[n_cells]`` int32 occupied slots per cell (a prefix
        of each cell's slots).
    :param pid: ``[n_cells * cap]`` int32 particle of each slot, ``-1``
        when empty.
    :param grid: ``(nx, ny, nz)``; cell ``x + nx (y + ny z)``.
    :param lengths: host box lengths (taken in the slots' precision).
    :param n: number of particles.
    :param group: ``((z0, nzl), ...)``: the group mode over these runs of
        ``grid``'s layers (:func:`.cell_stencil.group_layers` of a
        device's z-slab shards). With ``pid`` the cell table is read in
        place: the rows of the particles held in those layers and of the
        particles without a slot are written, the others are left as
        ``out`` holds them. With ``pid=None`` ``slots4`` and ``counts``
        are the group's joined buffer (:func:`.cell_stencil.joined_slab`)
        and ``n`` is not read.
    :param out: in place, the ``[>= n, NN, 4]`` contiguous list to write
        into (default a new one).
    :returns: ``[n, NN, 4]`` neighbor list of the slots' dtype, particle
        order (``out``'s first ``n`` rows when given); joined, ``[sum nzl
        nx ny cap, NN, 4]``, the rows of the home slots (empty slots'
        rows are zero in the plain version and not written by the
        kernel).
    """
    joined = pid is None
    if joined and (group is None or out is not None):
        raise ValueError("a joined buffer needs its group's runs, and "
                         "takes no out")
    if not slots4.is_cuda:
        return nlist_select_reference(slots4, counts, pid, grid, capacity,
                                      NN, r_cut, lengths, n, group, out)
    runs = None if group is None else tuple(
        (int(z0), int(k)) for z0, k in group)
    p = launch_params(tuple(grid), capacity, NN, r_cut, tuple(lengths),
                      dtype=slots4.dtype, group=runs, joined=joined)
    if joined:
        nx, ny, _ = (int(g) for g in grid)
        n = sum(k for _, k in runs) * nx * ny * int(capacity)
    return launch(p, slots4, counts, pid, n, out, group=group is not None)


def launch(params, slots4, counts, pid, n, out=None, group=False):
    """One launch of K3 with the constants ``params``
    (:func:`launch_params`) on CUDA tensors: the ``[n, NN, 4]`` list (on a
    joined buffer ``n`` is the home slots' count and ``pid`` is None), in
    ``out``'s first ``n`` rows when given; ``group``: a group mode's launch
    (counted in ``nlist_select.group_launches`` too)."""
    p = params
    n_cells = p.nx * p.ny * p.nz
    dev = slots4.device
    if dev.type != "cuda":
        raise ValueError(f"K3 launches on CUDA tensors, not {dev}")
    dtype = torch.float64 if p.f64 else torch.float32
    _check(slots4, (n_cells * p.cap, 4), dtype, dev, "slots4")
    _check(counts, (n_cells,), torch.int32, dev, "counts")
    if not p.joined:
        _check(pid, (n_cells * p.cap,), torch.int32, dev, "pid")
    if out is None:
        out = torch.empty((n, p.nn, 4), dtype=dtype, device=dev)
    elif p.joined or out.shape[0] < n:
        raise ValueError("out: a joined launch takes none, an in-place "
                         f"one at least {n} rows")
    else:
        _check(out, (out.shape[0], p.nn, 4), dtype, dev, "out")
    lib = _library()
    err = lib.htf_nlist_select(
        ctypes.addressof(p), slots4.data_ptr(), counts.data_ptr(),
        None if p.joined else pid.data_ptr(), int(n), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("neighbor selection kernel launch failed: " +
                           lib.htf_nlist_error_string(err).decode())
    nlist_select.launches += 1
    nlist_select.f64_launches += int(p.f64)
    nlist_select.group_launches += int(group)
    return out[:n]


#: launches of the kernel; those of its double instantiation alone; those
#: of the group mode (one a device holding z-slab shards, per build)
nlist_select.launches = 0
nlist_select.f64_launches = 0
nlist_select.group_launches = 0


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
        lib = ctypes.CDLL(str(build_shared_library("nlist_select")))
        lib.htf_nlist_select.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] +
            [ctypes.c_void_p] * 2)
        lib.htf_nlist_select.restype = ctypes.c_int
        lib.htf_nlist_error_string.argtypes = [ctypes.c_int]
        lib.htf_nlist_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB
