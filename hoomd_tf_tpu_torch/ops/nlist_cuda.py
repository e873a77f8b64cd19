"""Kernel K3: the cell-list neighbor selection, hand-written in CUDA C++
for Hopper (``csrc/nlist_select.cu``).

PyTorch counterpart of ``hoomd_tf_tpu/ops/nlist_pallas.py``
(``pallas_cell_select``, the kernel ``_kernel`` at line 43). It computes
the same function: for every occupied query slot of the cell list, the
minimum-image displacement ``d`` to each candidate of the 27 neighbouring
cells, valid when ``2.5e-7 <= d2 <= r_cut^2``; the NN smallest by an
int32 key, the float32 bits of ``d2`` with the low ``slot_bits`` cleared
and OR-ed with the candidate slot ``j = k cap + r`` (offset ``k`` of the
stencil, rank ``r`` in the cell). ``slot_bits`` is the bit length of
``cpad - 1`` with ``cpad`` the JAX package's lane-padded width
``ceil(27 cap / 128) 128``: kept though nothing here is padded, so the
port's neighbor order equals the JAX package's. Columns fill nearest
first; columns past the row's valid count are zero.

The TPU kernel takes ``[n_cells, 27 cap]`` candidate matrices that XLA
gathers beforehand, and lifts rows with one-hot matmuls. The CUDA kernel
gathers the 27 cells itself from the ``[n_cells cap, 4]`` slot rows, so
the candidate matrix never reaches device memory, and writes straight
into the particle-order ``[N, NN, 4]`` list through the slot's particle
id (the TPU path's four row gathers and stack fused away).

:func:`nlist_select` launches the kernel for CUDA tensors and uses the
plain version, :func:`nlist_select_reference`, only for CPU tensors.
"""

import ctypes

import numpy as np
import torch

from .cell_stencil import (cell_chunks, chunk_pairs, neighbor_cells,
                           to_particle_order)
from .nlist import f32

__all__ = ["nlist_select", "nlist_select_reference", "selection_keys",
           "slot_bits"]

#: key of an invalid candidate (bit pattern of a huge positive float)
FAR_KEY = 0x7F000000


def slot_bits(width):
    """Low key bits that carry the candidate slot, for ``width``
    candidates per row (the JAX package's lane-padded width)."""
    cpad = -(-int(width) // 128) * 128
    return max(1, cpad - 1).bit_length()


def selection_keys(ddx, ddy, ddz, r_cut, bits):
    """``(key, d2)`` of candidate lanes from their displacements, in the
    kernel's arithmetic (``d2 = dx dx + dy dy + dz dz``, left to right,
    no fused multiply-add): slot-tagged int32 keys along the last axis,
    :data:`FAR_KEY` where invalid."""
    d2 = ddx * ddx + ddy * ddy + ddz * ddz
    valid = (d2 <= f32(r_cut * r_cut)) & (d2 >= f32(25e-8))
    slot = torch.arange(d2.shape[-1], dtype=torch.int32, device=d2.device)
    key = (d2.view(torch.int32) & ~((1 << bits) - 1)) | slot
    return torch.where(valid, key, FAR_KEY), d2


def _select(ddx, ddy, ddz, gt, r_cut, NN, bits):
    """Rows of the list from ``[rows, C]`` displacement and type lanes:
    ``[rows, NN, 4]``."""
    rows, C = ddx.shape
    key, _ = selection_keys(ddx, ddy, ddz, r_cut, bits)
    k = min(NN, C)
    sel, idx = torch.topk(key, k, dim=1, largest=False, sorted=True)
    keep = (sel != FAR_KEY).to(ddx.dtype)
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
    L = torch.tensor([f32(v) for v in lengths], dtype=slots4.dtype,
                     device=dev)
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


def nlist_select(slots4, counts, pid, grid, capacity, NN, r_cut, lengths,
                 n):
    """Kernel K3. Launches the CUDA kernel on CUDA tensors (and counts the
    launch in ``nlist_select.launches``); CPU tensors take
    :func:`nlist_select_reference`. Anything else raises.

    :param slots4: ``[n_cells * cap, 4]`` float32 cell slots ``(x, y, z,
        type)``; empty slots hold a far sentinel.
    :param counts: ``[n_cells]`` int32 occupied slots per cell (a prefix
        of each cell's slots).
    :param pid: ``[n_cells * cap]`` int32 particle of each slot, ``-1``
        when empty.
    :param grid: ``(nx, ny, nz)``; cell ``x + nx (y + ny z)``.
    :param lengths: host box lengths (taken as float32).
    :param n: number of particles.
    :returns: ``[n, NN, 4]`` float32 neighbor list, particle order.
    """
    if not slots4.is_cuda:
        return nlist_select_reference(slots4, counts, pid, grid, capacity,
                                      NN, r_cut, lengths, n)
    cap = int(capacity)
    nx, ny, nz = (int(g) for g in grid)
    n_cells = nx * ny * nz
    if min(nx, ny, nz) < 3:
        raise ValueError(f"grid {grid}: the 27-cell stencil needs >= 3 "
                         "cells per axis")
    dev = slots4.device
    _check(slots4, (n_cells * cap, 4), torch.float32, dev, "slots4")
    _check(counts, (n_cells,), torch.int32, dev, "counts")
    _check(pid, (n_cells * cap,), torch.int32, dev, "pid")
    lib = _library()
    warps = lib.htf_nlist_select_warps(cap)
    if warps <= 0:
        raise ValueError(f"capacity {cap} needs more shared memory per "
                         "block than one H100 block has")
    out = torch.zeros((n, NN, 4), dtype=torch.float32, device=dev)
    lx, ly, lz = (f32(v) for v in lengths)
    err = lib.htf_nlist_select(
        ctypes.c_void_p(slots4.data_ptr()), ctypes.c_void_p(counts.data_ptr()),
        ctypes.c_void_p(pid.data_ptr()), nx, ny, nz, cap, int(NN),
        f32(r_cut * r_cut), f32(25e-8), lx, ly, lz,
        slot_bits(27 * cap), warps, ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError("neighbor selection kernel launch failed: " +
                           lib.htf_nlist_error_string(err).decode())
    nlist_select.launches += 1
    return out


#: launches of the kernel
nlist_select.launches = 0


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
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 +
            [ctypes.c_float] * 5 + [ctypes.c_int] * 2 +
            [ctypes.c_void_p, ctypes.c_void_p])
        lib.htf_nlist_select.restype = ctypes.c_int
        lib.htf_nlist_select_warps.argtypes = [ctypes.c_int]
        lib.htf_nlist_select_warps.restype = ctypes.c_int
        lib.htf_nlist_error_string.argtypes = [ctypes.c_int]
        lib.htf_nlist_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB
