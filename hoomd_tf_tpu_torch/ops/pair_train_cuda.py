"""Kernel K2: the Chebyshev-proxy backward of online training,
hand-written in CUDA C++ for Hopper (``csrc/proxy_bwd.cu``).

PyTorch counterpart of ``hoomd_tf_tpu/ops/pair_train_pallas.py``. For a
proxy pair function (:mod:`.chebyshev`) the lane function is linear in its
coefficients, so the parameter gradient of the training primal collapses
to ``2K`` (typed: ``P * 2K``) weighted lane-moment sums of the Chebyshev
basis over the half-stencil lanes:

    d/dc_k  <ct, F4> = sum_lanes  wE * T_k(w)
    d/dcd_k <ct, F4> = sum_lanes (wE * over - wF * u^2) * T_k(w)

with the Newton-combined cotangent weights ``wF``/``wE`` of
:func:`.pair_train.pair_train_forces`. The kernel gathers the occupied
slots of each cell's 14 half-stencil cells and their cotangents itself
(``csrc/half_stencil_stage.cuh``, shared with kernel K1), walks the lanes
and sums the moments, over cells too, with no float atomics.

The wrapper :func:`proxy_bwd_moments` launches the kernel for CUDA tensors
and takes the plain PyTorch version, :func:`proxy_bwd_plain`, only for CPU
tensors. The kernel is built from the package's source at first use, by
the same ``_build.py`` as K1.
"""

import ctypes

import torch

from .cellwise import (_HALF_OFFS, _as_geometry, _relative_coords,
                       _roll_offs, pair_rc2)
from .cellwise_cuda import (_MAX_SMEM, _check, _ptr, check_slot_inputs,
                            cuda_slot_args, half_geom, kernel_dtype)

__all__ = ["proxy_bwd_moments", "proxy_bwd_plain", "proxy_bwd_reference"]


def _n_types(basis):
    pairs = basis["pairs"]
    return 1 if pairs is None else max(b for _, b in pairs) + 1


def _split(out, basis):
    """``[P * 2K]`` moments -> ``(g_c, g_cd)``: ``[K]`` each untyped,
    ``[P, K]`` typed."""
    out = out.reshape(-1, 2, int(basis["K"]))
    if basis["pairs"] is None:
        return out[0, 0], out[0, 1]
    return out[:, 0], out[:, 1]


def proxy_bwd_reference(gx, gy, gz, gt, cgx, cgy, cgz, cge, basis, cap, rc2,
                        min_r2, rc2_tab=None, chunk_elems=1 << 22):
    """The kernel's lane math on ``[n_cells, 14*cap]`` candidate planes
    (``_relative_coords``; the cotangent planes with ``valid`` folded in):
    the ``[P * 2K]`` moment sums (pair ``p``: the ``c`` moments at
    ``p * 2K + k``, the ``cd`` moments at ``p * 2K + K + k``; the ``c``
    moments are zero when ``cge`` is ``None``). Empty slots add nothing:
    their rows are pushed out of every cut and their cotangents are
    zero."""
    K = int(basis["K"])
    mid, inv_half = float(basis["mid"]), float(basis["inv_half"])
    u_hi = float(basis["u_hi"])
    pairs = basis["pairs"]
    n_cells, C = gx.shape
    dev, dtype = gx.device, gx.dtype
    P = 1 if pairs is None else len(pairs)
    acc = [torch.zeros((), dtype=dtype, device=dev)
           for _ in range(P * 2 * K)]
    row = torch.arange(cap, device=dev)[:, None]
    col = torch.arange(C, device=dev)[None, :]
    not_self = (col != row)[None]
    directed = (col >= cap).to(dtype)[None]
    step = max(1, chunk_elems // max(1, cap * C))
    zero = torch.zeros((), dtype=dtype, device=dev)
    for a0 in range(0, n_cells, step):
        sl = slice(a0, min(n_cells, a0 + step))
        g = [t[sl] for t in (gx, gy, gz)]
        q = [t[:, :cap] for t in g]
        dx, dy, dz = (gj[:, None, :] - qj[:, :, None]
                      for gj, qj in zip(g, q))
        d2 = dx * dx + dy * dy + dz * dz
        ok = (d2 <= rc2) & not_self
        ti = tj = None
        if gt is not None:
            ti, tj = gt[sl, :cap][:, :, None], gt[sl][:, None, :]
        if rc2_tab is not None:
            ok = ok & (d2 <= pair_rc2(ti, tj, rc2_tab))
        r2 = torch.clamp_min(d2, min_r2)
        c = [t[sl] for t in (cgx, cgy, cgz)]
        wF = (c[0][:, :cap, None] * dx + c[1][:, :cap, None] * dy +
              c[2][:, :cap, None] * dz)
        wF = wF - directed * (c[0][:, None, :] * dx + c[1][:, None, :] * dy +
                              c[2][:, None, :] * dz)
        wF = torch.where(ok, 2.0 * wF, zero)
        u = 1.0 / r2
        over = torch.clamp_min(u - u_hi, 0.0)
        if cge is not None:
            ce = cge[sl]
            wE = ce[:, :cap, None] + directed * ce[:, None, :]
            wE = torch.where(ok, 0.5 * wE, zero)
            A, B = wE, wE * over - wF * (u * u)
        else:
            A, B = None, -wF * (u * u)
        w = torch.clamp((u - mid) * inv_half, -1.0, 1.0)
        if pairs is None:
            masks = [None]
        else:
            masks = []
            for a, b in pairs:
                m = (ti == a) & (tj == b)
                if a != b:
                    m = m | ((ti == b) & (tj == a))
                masks.append(m.to(dtype))
        t_prev, t_cur = torch.ones_like(w), w
        two_w = 2.0 * w
        for k in range(K):
            t_k = t_prev if k == 0 else t_cur
            for p, m in enumerate(masks):
                base = p * 2 * K
                if A is not None:
                    term = A * t_k if m is None else A * m * t_k
                    acc[base + k] = acc[base + k] + term.sum()
                term = B * t_k if m is None else B * m * t_k
                acc[base + K + k] = acc[base + K + k] + term.sum()
            if k >= 1:
                t_prev, t_cur = t_cur, two_w * t_cur - t_prev
    return torch.stack(acc)


def proxy_bwd_plain(positions, types, valid, ct, plan, lo, basis, *,
                    min_r2=1e-4, rc2_tab=None, needs_energy=True,
                    geometry=None):
    """Plain PyTorch version of kernel K2, with the wrapper's contract: the
    candidate and cotangent planes of the half stencil
    (``_relative_coords``, ``_roll_offs``) through
    :func:`proxy_bwd_reference`'s lane math."""
    geometry = _as_geometry(plan, lo, positions, geometry)
    _, _, _, gx, gy, gz = _relative_coords(positions, valid, plan, lo,
                                           _HALF_OFFS, geometry)
    ctv = ct * valid[:, None]
    gt = None
    if basis["pairs"] is not None or rc2_tab is not None:
        gt = _roll_offs(types.to(torch.int32), plan, _HALF_OFFS)
    cg = [_roll_offs(ctv[:, k].contiguous(), plan, _HALF_OFFS)
          for k in range(4 if needs_energy else 3)]
    out = proxy_bwd_reference(gx, gy, gz, gt, cg[0], cg[1], cg[2],
                              cg[3] if needs_energy else None, basis,
                              plan.capacity, plan.r_cut ** 2, min_r2,
                              rc2_tab)
    return _split(out, basis)


def proxy_bwd_moments(positions, types, valid, ct, plan, lo, basis, *,
                      min_r2=1e-4, rc2_tab=None, needs_energy=True,
                      geometry=None):
    """Kernel K2: the proxy backward's moment sums over the half-stencil
    lanes (the counterpart of the JAX ``proxy_bwd_moments``). Launches the
    kernel on CUDA tensors (counting each call in
    ``proxy_bwd_moments.launches``); CPU tensors take
    :func:`proxy_bwd_plain`. Anything else raises.

    :param positions, types, valid: the slot state (``[n_slots, 3]``
        float32 or float64 -- the kernel's double instantiation --,
        ``[n_slots]`` int32, ``[n_slots]`` of the positions' dtype, nonzero
        on occupied slots, any pattern within a cell).
    :param ct: ``[n_slots, 4]`` cotangent of the forces, the positions'
        dtype (this function folds ``valid`` in).
    :param rc2_tab: ``[T, T]`` squared-cutoff table (``cellwise.rc2_table``)
        or ``None``.
    :returns: ``(g_c, g_cd)``: ``[K]`` tensors (untyped) or ``[P, K]``
        (typed, :func:`.chebyshev.type_pairs` order).
    """
    check_slot_inputs(positions, types, valid, plan)
    if not positions.is_cuda:
        return proxy_bwd_plain(positions, types, valid, ct, plan, lo, basis,
                               min_r2=min_r2, rc2_tab=rc2_tab,
                               needs_energy=needs_energy, geometry=geometry)
    geometry = _as_geometry(plan, lo, positions, geometry)
    dev = positions.device
    dtype, f64 = kernel_dtype(positions)
    T = _n_types(basis)
    K = int(basis["K"])
    typed = T > 1 or rc2_tab is not None
    state = cuda_slot_args(positions, types, valid, plan, geometry, typed)
    ct = ct.contiguous()
    if ct.data_ptr() % 16:
        ct = ct.clone()  # the kernel reads a row as one float4
    _check(ct, (plan.n_slots, 4), dtype, dev, "ct")
    rc_t = 0
    if rc2_tab is not None:
        rc_t = rc2_tab.shape[0]
        _check(rc2_tab, (rc_t, rc_t), dtype, dev, "rc2_tab")
    lib = _library()
    smem = lib.htf_proxy_bwd_smem(f64, plan.capacity, K, T)
    if smem > _MAX_SMEM:
        raise ValueError(f"capacity {plan.capacity}, K={K} and {T} types "
                         f"need {smem} bytes of shared memory per block, "
                         f"above {_MAX_SMEM}")
    M = T * (T + 1) // 2 * 2 * K
    partial = torch.empty((plan.n_cells, M), dtype=dtype, device=dev)
    out = torch.empty((M,), dtype=dtype, device=dev)
    err = lib.htf_proxy_bwd(
        f64, *state, _ptr(ct), ctypes.byref(half_geom(plan)), plan.n_cells,
        _ptr(rc2_tab), rc_t, K, T, float(plan.r_cut ** 2), float(min_r2),
        float(basis["mid"]), float(basis["inv_half"]),
        float(basis["u_hi"]), int(needs_energy), _ptr(partial), _ptr(out),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError("proxy backward kernel launch failed: " +
                           lib.htf_proxy_error_string(err).decode())
    proxy_bwd_moments.launches += 1
    proxy_bwd_moments.f64_launches += f64
    return _split(out, basis)


#: calls that launched the kernel (the moment pass and the cross-cell sum);
#: those of its double instantiation alone
proxy_bwd_moments.launches = 0
proxy_bwd_moments.f64_launches = 0

_LIB = None


def _library():
    """The compiled kernel library (built from ``csrc/`` on first use)."""
    global _LIB
    if _LIB is None:
        from .._build import build_shared_library
        lib = ctypes.CDLL(str(build_shared_library("proxy_bwd")))
        lib.htf_proxy_bwd.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 6 +
            [ctypes.c_int, ctypes.c_void_p] +
            [ctypes.c_int] * 3 + [ctypes.c_double] * 5 + [ctypes.c_int] +
            [ctypes.c_void_p] * 3)
        lib.htf_proxy_bwd.restype = ctypes.c_int
        lib.htf_proxy_bwd_smem.argtypes = [ctypes.c_int] * 4
        lib.htf_proxy_bwd_smem.restype = ctypes.c_long
        lib.htf_proxy_error_string.argtypes = [ctypes.c_int]
        lib.htf_proxy_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB
