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

from .cellwise import (_HALF_OFFS, _as_geometry, _roll_offs, group_rows,
                       half_frame, halo_layer, pair_rc2)
from .cellwise_cuda import (_MAX_SMEM, _check, _group_inputs, _ptr, _ptrs,
                            check_group_inputs, check_slot_inputs,
                            cuda_slot_args, group_args, half_geom,
                            kernel_dtype, member_rows)

__all__ = ["proxy_bwd_moments", "proxy_bwd_plain", "proxy_bwd_reference",
           "pair_groups", "smem_bytes", "max_capacity"]

# csrc/half_stencil_stage.cuh's block constants; the tile path's moments a
# lane holds (csrc/proxy_bwd.cu::kMom)
_K_HALF, _K_WARPS, _K_MOM = 14, 8, 32


def _stage_bytes(s):
    """``htf::stage_bytes<S>()`` for a scalar of ``s`` bytes."""
    return 4 * (_K_HALF + _K_WARPS) + s * (6 * _K_WARPS + 6 + 6 * _K_HALF)


def _register_degree(K, T):
    """``csrc/proxy_bwd.cu::register_degree``: K for the register path
    (untyped, K = 8 or 16), else 0 (the tile path)."""
    return K if T == 1 and K in (8, 16) else 0


def smem_bytes(f64, cap, K, T, Q):
    """Shared-memory bytes of one K2 block for ``T`` types, ``Q`` type
    pairs a pass on the tile path: ``csrc/proxy_bwd.cu::smem_bytes``,
    which the wrapper checks this against at every launch."""
    s = 8 if f64 else 4
    C = _K_HALF * cap
    staging = C * (2 * 4 * s + 4) + _stage_bytes(s)
    if _register_degree(K, T):
        return staging + s * (_K_WARPS + 1) * 2 * K
    NB = T + 1
    ints = C + 4 * NB + 1 + _K_WARPS * NB + 2 * Q + 1 + _K_WARPS
    return staging + s * (_K_WARPS + Q) * _K_MOM + 4 * ints


def pair_groups(f64, cap, K, T):
    """K2's plan of the ``P = T (T + 1) / 2`` type pairs: consecutive
    ranges ``[(p0, p1), ...]`` of :func:`.chebyshev.type_pairs` order
    that cover every pair once, each of the largest size ``Q`` whose
    block (:func:`smem_bytes`) fits the card's shared memory. Why a plan:
    on the tile path a block keeps one ``[32]`` row of sums per pair of a
    pass in shared memory beside its staging, which at the train plans'
    capacities (48-72) fits every pair up to about 34 types in double and
    53 in float32, but not any T; past that the block stages once and
    sums its pairs in several passes of ``Q`` (one range per pass). The
    register path (untyped, K = 8 or 16) has one range. Raises when not
    even one pair a pass fits (:func:`max_capacity`)."""
    P = T * (T + 1) // 2
    Q = P
    if not _register_degree(K, T):
        # the bytes grow by a [32] row of sums and two ints a pair
        per_pair = smem_bytes(f64, cap, K, T, 1) - smem_bytes(f64, cap, K, T,
                                                                0)
        Q = min(P, (_MAX_SMEM - smem_bytes(f64, cap, K, T, 0)) // per_pair)
    if Q < 1 or smem_bytes(f64, cap, K, T, Q) > _MAX_SMEM:
        raise ValueError(f"capacity {cap} and K={K} need "
                         f"{smem_bytes(f64, cap, K, T, 1)} bytes of shared "
                         f"memory per block for one type pair a pass, "
                         f"above {_MAX_SMEM}")
    return [(p0, min(P, p0 + Q)) for p0 in range(0, P, Q)]


def max_capacity(f64, K, T):
    """The largest cell capacity :func:`pair_groups` plans for."""
    fixed = smem_bytes(f64, 0, K, T, 1)
    return (_MAX_SMEM - fixed) // (smem_bytes(f64, 1, K, T, 1) - fixed)


def tile_walk(keys, n0, T, Q):
    """A model of the tile path's walk in one block
    (``csrc/proxy_bwd.cu::tile_block``), for tests: ``keys`` the staged
    entries' sort keys (their types, ``T`` outside the table; all 0
    untyped), the first ``n0`` the home rows; ``Q`` the pairs a pass.
    Returns ``(lanes, flushes)``: ``lanes`` the ``(p, warp, i, j)`` each
    walked lane (self pairs included; the kernel skips them), ``flushes``
    the ``(p, warp, dest)`` each warp flush, ``dest`` ``'first'`` (the
    warp's slot) or ``'row'`` (the pair's row of the block's sums)."""
    NB = T + 1
    cord = sorted(range(len(keys)), key=lambda k: (keys[k], k))
    cnt = [sum(1 for k in keys if k == t) for t in range(NB)]
    nrow = [sum(1 for k in keys[:n0] if k == t) for t in range(NB)]
    coff = [sum(cnt[:t]) for t in range(NB + 1)]
    P = T * (T + 1) // 2
    pairs = [(a, b) for a in range(T) for b in range(a, T)]
    lanes, flushes = [], []
    for p0 in range(0, P, Q):
        pab = pairs[p0:p0 + Q]
        n = [nrow[a] * cnt[b] + (nrow[b] * cnt[a] if a != b else 0)
             for a, b in pab]
        pstart = [0]
        for v in n:
            pstart.append(pstart[-1] + -(-v // 32))
        steps = pstart[-1]
        for w in range(_K_WARPS):
            q = first = None
            for s in range(steps * w // _K_WARPS, steps * (w + 1) // _K_WARPS):
                if q is None or s >= pstart[q + 1]:
                    if q is not None:
                        flushes.append((p0 + q, w,
                                        "first" if q == first else "row"))
                    q = 0 if q is None else q
                    while s >= pstart[q + 1]:
                        q += 1
                    first = q if first is None else first
                a, b = pab[q]
                n1 = nrow[a] * cnt[b]
                for lane in range(32):
                    l = (s - pstart[q]) * 32 + lane
                    if l >= n[q]:
                        continue
                    if l < n1:
                        i = cord[coff[a] + l // cnt[b]]
                        j = cord[coff[b] + l % cnt[b]]
                    else:
                        l -= n1
                        i = cord[coff[b] + l // cnt[a]]
                        j = cord[coff[a] + l % cnt[a]]
                    lanes.append((p0 + q, w, i, j))
            if q is not None:
                flushes.append((p0 + q, w, "first" if q == first else "row"))
    return lanes, flushes


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
                    geometry=None, group=None):
    """Plain PyTorch version of kernel K2, with the wrapper's contract: the
    candidate and cotangent planes of the half stencil
    (:func:`.cellwise.half_frame`, ``_roll_offs``) through
    :func:`proxy_bwd_reference`'s lane math. With ``group`` (a
    :class:`.cellwise.SlabGroup`) the inputs and ``ct`` are the members'
    buffers in group order (:func:`proxy_bwd_moments`' group mode) and the
    moments those of the members' home cells' lanes: each member's planes
    from its buffer, the forward halo read from the next member's first
    home layer when that is in the group (:func:`.cellwise.group_rows`),
    joined member after member (the group's global cell order) into one
    pass of the lane math. A group of every shard gives the whole state's
    planes, chunks and sums, so its moments equal the unsharded ones bit
    for bit."""
    if group is None:
        frames = [_planes(positions, types, valid, ct, plan, lo, basis,
                          rc2_tab, needs_energy, geometry, None)]
    else:
        layer = halo_layer(plan)
        frames = [_planes(*(group_rows(list(t), group, k, layer)
                            for t in (positions, types, valid, ct)),
                          plan, lo, basis, rc2_tab, needs_energy, geometry,
                          slab)
                  for k, slab in enumerate(group.slabs)]
    planes = [None if f[0] is None else torch.cat(f)
              for f in zip(*frames)]
    out = proxy_bwd_reference(*planes, basis, plan.capacity,
                              plan.r_cut ** 2, min_r2, rc2_tab)
    return _split(out, basis)


def _planes(positions, types, valid, ct, plan, lo, basis, rc2_tab,
            needs_energy, geometry, slab):
    """``(gx, gy, gz, gt or None, cgx, cgy, cgz, cge or None)``: the
    half-stencil candidate, type and cotangent planes (``valid`` folded
    into the cotangent) of the home cells of a whole state or of a z-slab
    buffer (``slab = (z0, nzl)``)."""
    geometry = _as_geometry(plan, lo, positions, geometry)
    rp, n_home, _, _, _, gx, gy, gz = half_frame(positions, valid, plan, lo,
                                                 geometry, slab)

    def roll(t):
        return _roll_offs(t, rp, _HALF_OFFS)[:n_home]

    ctv = ct * valid[:, None]
    gt = None
    if basis["pairs"] is not None or rc2_tab is not None:
        gt = roll(types.to(torch.int32))
    cg = [roll(ctv[:, k].contiguous())
          for k in range(4 if needs_energy else 3)]
    return (gx, gy, gz, gt, *cg, *([] if needs_energy else [None]))


def proxy_bwd_moments(positions, types, valid, ct, plan, lo, basis, *,
                      min_r2=1e-4, rc2_tab=None, needs_energy=True,
                      geometry=None, group=None):
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
    :param group: a :class:`.cellwise.SlabGroup` of z-slab shards on one
        card (the training backward under a mesh): ``positions``,
        ``types``, ``valid`` and ``ct`` are lists of the members' buffers
        in group order (a resident shard's slab buffer, or a member's
        home layers, then its forward halo layer unless its next member
        is in the group, whose first home layer is then read in place; a
        halo row of ``ct`` read
        carries the next shard's first home layer's cotangent), one
        launch pair covers every member's home cells, and
        the moments are those of their lanes, summed over the cells in
        the group's global cell order (counted also in
        ``.group_launches``). A group of every shard gives the unsharded
        moments bit for bit; a z-slab shard alone is its group of one. On
        CPU tensors :func:`proxy_bwd_plain` with ``group``.
    :returns: ``(g_c, g_cd)``: ``[K]`` tensors (untyped) or ``[P, K]``
        (typed, :func:`.chebyshev.type_pairs` order).
    """
    kw = dict(min_r2=min_r2, rc2_tab=rc2_tab, needs_energy=needs_energy,
              geometry=geometry)
    first = positions if group is None else positions[0]
    if group is None:
        check_slot_inputs(positions, types, valid, plan)
    elif not first.is_cuda:
        check_group_inputs(positions, types, valid, plan, group, ct)
    if not first.is_cuda:
        return proxy_bwd_plain(positions, types, valid, ct, plan, lo, basis,
                               group=group, **kw)
    geometry = _as_geometry(plan, lo, first, geometry)
    dev = first.device
    dtype, f64 = kernel_dtype(first)
    T = _n_types(basis)
    K = int(basis["K"])
    typed = T > 1 or rc2_tab is not None
    if group is None:
        n_cells = plan.n_cells
        state = cuda_slot_args(positions, types, valid, plan, geometry,
                               typed)
        ct = _aligned(ct)
        _check(ct, (plan.n_slots, 4), dtype, dev, "ct")
    else:
        n_cells, _, _, _, *state = _group_inputs(
            positions, types, valid, plan, group, geometry, typed)
        n_cells *= len(group.slabs)
        ct = [_aligned(c) for c in ct]
        for k, c in enumerate(ct):
            _check(c, (member_rows(plan, group, k, c), 4), dtype, dev, "ct")
    rc_t = 0
    if rc2_tab is not None:
        rc_t = rc2_tab.shape[0]
        _check(rc2_tab, (rc_t, rc_t), dtype, dev, "rc2_tab")
    lib = _library()
    groups = pair_groups(f64, plan.capacity, K, T)
    Q = groups[0][1]
    smem = lib.htf_proxy_bwd_smem(f64, plan.capacity, K, T, Q)
    planned = smem_bytes(f64, plan.capacity, K, T, Q)
    if smem != planned:
        raise RuntimeError(f"K2's shared memory ({smem} bytes) differs from "
                           f"its plan's ({planned})")
    M = T * (T + 1) // 2 * 2 * K
    partial = torch.empty((n_cells, M), dtype=dtype, device=dev)
    out = torch.empty((M,), dtype=dtype, device=dev)
    rest = (_ptr(rc2_tab), rc_t, K, T, Q, float(plan.r_cut ** 2),
            float(min_r2), float(basis["mid"]), float(basis["inv_half"]),
            float(basis["u_hi"]), int(needs_energy), _ptr(partial), _ptr(out),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if group is None:
        err = lib.htf_proxy_bwd(f64, *state, _ptr(ct),
                                ctypes.byref(half_geom(plan)), n_cells, *rest)
    else:
        geom, z0, prev, nxt = group_args(plan, group)
        err = lib.htf_proxy_bwd_group(f64, len(group.slabs), *state[:3],
                                      _ptrs(ct), z0, prev, nxt, state[3],
                                      ctypes.byref(geom), *rest)
    if err != 0:
        raise RuntimeError("proxy backward kernel launch failed: " +
                           lib.htf_proxy_error_string(err).decode())
    proxy_bwd_moments.launches += 1
    proxy_bwd_moments.f64_launches += f64
    proxy_bwd_moments.type_group_launches += len(groups) > 1
    proxy_bwd_moments.group_launches += group is not None
    return _split(out, basis)


def _aligned(ct):
    """``ct`` contiguous and 16-byte aligned (the kernel reads a row as one
    vector)."""
    ct = ct.contiguous()
    return ct.clone() if ct.data_ptr() % 16 else ct


#: calls that launched the kernel (the moment pass and the cross-cell sum);
#: those of its double instantiation alone; those whose type pairs the
#: plan splits into more than one pass (:func:`pair_groups`); those over a
#: group of z-slab shards (``group=``)
proxy_bwd_moments.launches = 0
proxy_bwd_moments.f64_launches = 0
proxy_bwd_moments.type_group_launches = 0
proxy_bwd_moments.group_launches = 0

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
            [ctypes.c_int] * 4 + [ctypes.c_double] * 5 + [ctypes.c_int] +
            [ctypes.c_void_p] * 3)
        lib.htf_proxy_bwd.restype = ctypes.c_int
        lib.htf_proxy_bwd_group.argtypes = (
            [ctypes.c_int] * 2 + [ctypes.c_void_p] * 9 +
            [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_int] * 3 +
            [ctypes.c_double] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 3)
        lib.htf_proxy_bwd_group.restype = ctypes.c_int
        lib.htf_proxy_bwd_smem.argtypes = [ctypes.c_int] * 5
        lib.htf_proxy_bwd_smem.restype = ctypes.c_long
        lib.htf_proxy_error_string.argtypes = [ctypes.c_int]
        lib.htf_proxy_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB
