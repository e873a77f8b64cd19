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
"""

import ctypes
import functools

import numpy as np
import torch

from .cell_stencil import (cell_chunks, chunk_pairs, neighbor_cells,
                           to_particle_order)
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
                           lengths, n):
    """Plain PyTorch version of K3 with the kernel's interface (see
    :func:`nlist_select`), chunked over cells to bound its memory."""
    cap = int(capacity)
    n_cells = int(np.prod(grid))
    dev = slots4.device
    neigh = neighbor_cells(tuple(grid), dev)
    L = torch.tensor([host_length(v, slots4.dtype) for v in lengths],
                     dtype=slots4.dtype, device=dev)
    bits = slot_bits(27 * cap)
    rows = []
    for c0, c1 in cell_chunks(n_cells, cap):
        ddx, ddy, ddz, _, _, gt = chunk_pairs(slots4, neigh, cap, L, c0, c1)
        C = ddx.shape[-1]
        rows.append(_select(ddx.reshape(-1, C), ddy.reshape(-1, C),
                            ddz.reshape(-1, C),
                            gt.expand_as(ddx).reshape(-1, C), r_cut, NN,
                            bits))
    return to_particle_order(torch.cat(rows), pid, n)


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
    type of the slots and the list."""
    _fields_ = ([(f, ctypes.c_int) for f in
                 ("nx", "ny", "nz", "cap", "nn", "strip", "warps",
                  "n_strips", "smem", "f64")] +
                [("slot_mask", ctypes.c_uint), ("rc2", ctypes.c_double),
                 ("lo2", ctypes.c_double)] +
                [(f, ctypes.c_double * 3) for f in ("L", "t0", "t1", "t2")])


@functools.lru_cache(maxsize=16)
def launch_params(grid, capacity, NN, r_cut, lengths, strip=None,
                  warps=None, dtype=torch.float32):
    """The launch constants of one plan, made once (cached): the launch
    shape, the slot mask, the cuts, lengths and minimum-image thresholds
    in ``dtype`` (float32, or float64 for the double kernel). ``strip`` and
    ``warps`` force a shape (:func:`launch_shape`)."""
    nx, ny, nz = (int(g) for g in grid)
    if min(nx, ny, nz) < 3:
        raise ValueError(f"grid {grid}: the 27-cell stencil needs >= 3 "
                         "cells per axis")
    cap, nn = int(capacity), int(NN)
    f64 = dtype == torch.float64
    s, w, smem = launch_shape(nx, cap, nn, strip, warps, f64)
    L = [host_length(v, dtype) for v in lengths]
    th = [image_thresholds(v, dtype) for v in L]
    return K3Params(
        nx, ny, nz, cap, nn, s, w, -(-nx // s), smem, int(f64),
        (1 << slot_bits(27 * cap)) - 1, *cut_values(r_cut, dtype),
        (ctypes.c_double * 3)(*L),
        *((ctypes.c_double * 3)(*(float(t[a]) for t in th))
          for a in range(3)))


def nlist_select(slots4, counts, pid, grid, capacity, NN, r_cut, lengths,
                 n):
    """Kernel K3. Launches the CUDA kernel on CUDA tensors (and counts the
    launch in ``nlist_select.launches``); CPU tensors take
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
    :returns: ``[n, NN, 4]`` neighbor list of the slots' dtype, particle
        order.
    """
    if not slots4.is_cuda:
        return nlist_select_reference(slots4, counts, pid, grid, capacity,
                                      NN, r_cut, lengths, n)
    return launch(launch_params(tuple(grid), capacity, NN, r_cut,
                                tuple(lengths), dtype=slots4.dtype),
                  slots4, counts, pid, n)


def launch(params, slots4, counts, pid, n):
    """One launch of K3 with the constants ``params``
    (:func:`launch_params`) on CUDA tensors: the ``[n, NN, 4]`` list."""
    p = params
    n_cells = p.nx * p.ny * p.nz
    dev = slots4.device
    if dev.type != "cuda":
        raise ValueError(f"K3 launches on CUDA tensors, not {dev}")
    dtype = torch.float64 if p.f64 else torch.float32
    _check(slots4, (n_cells * p.cap, 4), dtype, dev, "slots4")
    _check(counts, (n_cells,), torch.int32, dev, "counts")
    _check(pid, (n_cells * p.cap,), torch.int32, dev, "pid")
    lib = _library()
    out = torch.empty((n, p.nn, 4), dtype=dtype, device=dev)
    err = lib.htf_nlist_select(
        ctypes.addressof(p), slots4.data_ptr(), counts.data_ptr(),
        pid.data_ptr(), int(n), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("neighbor selection kernel launch failed: " +
                           lib.htf_nlist_error_string(err).decode())
    nlist_select.launches += 1
    nlist_select.f64_launches += int(p.f64)
    return out


#: launches of the kernel; those of its double instantiation alone
nlist_select.launches = 0
nlist_select.f64_launches = 0


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
