"""The training backward under a mesh as one group call per device, the
port against itself and the JAX package on the CPU: K2's group mode
(``proxy_bwd_moments(group=)``, its plain version ``proxy_bwd_plain(
group=)``) and ``generic_reduce_bwd`` over a group's joined list
(``generic_reduce_bwd_plain(group=)``), on virtual CPU shards.

A group is the z-slab shards one device holds (``cellwise.slab_groups``).
Besides the group of every shard of a one-device mesh, the tests split a
mesh into two groups of consecutive shards on the CPU (``split``: each
group's end members linked outside it, as on two cards), so a member's
halo layer is filled from the whole state and the reverse halo crosses
between groups (``cellwise.resident_pair_forces``).

Tolerances: a group of every shard against the unsharded plain versions
bit for bit (its planes, chunks and sums, or its lanes, are the
unsharded ones); a group of one against the z-slab buffer's own lane
math bit for bit; split groups' summed moments and the weights' gradient
through ``pair_train_forces(mesh=)`` against the unsharded call and
JAX's XLA contraction at rtol 2e-4, atol 2e-5 max|g| (the JAX package's
bar for its Pallas proxy backward); their ``generic_reduce_bwd`` lanes
against the unsharded lanes at 1e-4 (the same products); three sharded
SGD train steps against JAX's unsharded engine at the bars of
tests/test_torch_parallel_train.py (losses rtol 2e-4, weights rtol 2e-4
atol 1e-6); in float64 the group routes' gradients against the port's
unsharded plain versions at rtol 1e-12 and JAX's float64 contraction at
rtol 1e-9 (tests/test_torch_fp64.py's K2 bar).
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hoomd_tf_tpu.md.slots import SlotLayout as JLayout
from hoomd_tf_tpu.md.state import init_state as j_init_state
from hoomd_tf_tpu.ops import cellwise as jcw
from hoomd_tf_tpu.ops import chebyshev as jch
from hoomd_tf_tpu.ops.pair_train import pair_train_forces as j_ptf
from hoomd_tf_tpu_torch.md.slots import SlotLayout
from hoomd_tf_tpu_torch.md.state import init_state as t_init_state
from hoomd_tf_tpu_torch.ops import cellwise as tcw
from hoomd_tf_tpu_torch.ops import cellwise_cuda as tcc
from hoomd_tf_tpu_torch.ops import chebyshev as tch
from hoomd_tf_tpu_torch.ops import pair_train_cuda as tpc
from hoomd_tf_tpu_torch.ops.cellwise import _HALF_OFFS, _roll_offs
from hoomd_tf_tpu_torch.ops.pair_train import pair_train_forces as t_ptf

from test_torch_parallel import cpu_mesh, slab_case
from test_torch_parallel_train import (assert_grads, branch, cotangent,
                                       jax_proxy_grads, proxy_basis,
                                       train_pair_sharded)
from test_torch_train_generic import trainable
from torch_helpers import fluid_arrays, member_rows, np_

CPU = torch.device("cpu")
F64 = torch.float64


def groups_of(plan, S, parts):
    """The ``S`` shards of ``plan`` on the CPU as one group (``parts``
    1, what ``slab_groups`` makes of a one-device mesh) or as ``parts``
    groups of consecutive shards, each group's end members linked outside
    it (as on ``parts`` devices)."""
    slabs = tcw.mesh_slabs(plan, cpu_mesh(S))
    if parts == 1:
        return tcw.slab_groups(slabs)
    k = S // parts
    return tuple(tcw.SlabGroup(CPU, tuple(range(a, a + k)),
                               tuple(sl[1:] for sl in slabs[a:a + k]),
                               (-1,) + tuple(range(k - 1)),
                               tuple(range(1, k)) + (-1,))
                 for a in range(0, S, k))


@contextlib.contextmanager
def split_groups(monkeypatch, parts):
    """Every ``slab_groups`` of a whole mesh made ``parts`` groups of
    consecutive shards (:func:`groups_of`), so the routes run as on
    ``parts`` devices."""
    real = tcw.slab_groups

    def fake(slabs, whole=True):
        if not whole or parts == 1:
            return real(slabs, whole)
        S = len(slabs)
        k = S // parts
        return tuple(tcw.SlabGroup(CPU, tuple(range(a, a + k)),
                                   tuple(sl[1:] for sl in slabs[a:a + k]),
                                   (-1,) + tuple(range(k - 1)),
                                   tuple(range(1, k)) + (-1,))
                     for a in range(0, S, k))
    monkeypatch.setattr(tcw, "slab_groups", fake)
    try:
        yield
    finally:
        monkeypatch.setattr(tcw, "slab_groups", real)


def members(t, plan, group):
    """The members' rows of ``t`` (``torch_helpers.member_rows``)."""
    return member_rows(t, plan, group)


# ----------------------------------------------------------------------
# K2's group mode, plain version
# ----------------------------------------------------------------------
@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("typed", [False, True])
@pytest.mark.parametrize("energy", [True, False])
def test_proxy_group_of_every_shard_is_unsharded(S, typed, energy):
    """``proxy_bwd_moments(group=)`` over the group of every shard (its
    plain version on the CPU, the members views of the whole state) equals
    the unsharded plain version bit for bit, and launches nothing."""
    (tl, ts, taux), _ = slab_case(S, typed=typed, n=2000)
    plan, lo = tl.plan, tl.lo
    ev, _ = proxy_basis(typed)
    ct = torch.as_tensor(cotangent(plan, energy))
    whole = (ts.positions, ts.types, taux["valid"], ct)
    kw = dict(rc2_tab=tl.rc2_tab, needs_energy=energy, geometry=tl.geometry)
    want = tpc.proxy_bwd_plain(*whole, plan, lo, ev.basis, **kw)
    grp, = groups_of(plan, S, 1)
    assert grp.members == tuple(range(S)) and all(n >= 0 for n in grp.next)
    bufs = [members(t, plan, grp) for t in whole]
    # linked members hold their home layers only, as views
    assert all(b.shape[0] == tcw.halo_layer(plan) * grp.slabs[0][1]
               for b in bufs[0])
    assert bufs[0][0].data_ptr() == ts.positions.data_ptr()
    got = tpc.proxy_bwd_moments(*bufs, plan, lo, ev.basis, group=grp, **kw)
    assert tpc.proxy_bwd_moments.launches == 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def slab_lane_math(positions, types, valid, ct, plan, lo, basis, slab,
                   rc2_tab, energy, geometry):
    """K2's lane math on one z-slab buffer (the slab plain version before
    the group mode): its half-stencil candidate, type and cotangent
    planes through ``proxy_bwd_reference``."""
    rp, n_home, _, _, _, gx, gy, gz = tcw.half_frame(positions, valid, plan,
                                                     lo, geometry, slab)

    def roll(t):
        return _roll_offs(t, rp, _HALF_OFFS)[:n_home]
    ctv = ct * valid[:, None]
    gt = (roll(types.to(torch.int32)) if basis["pairs"] is not None or
          rc2_tab is not None else None)
    cg = [roll(ctv[:, k].contiguous()) for k in range(4)]
    out = tpc.proxy_bwd_reference(gx, gy, gz, gt, *cg[:3],
                                  cg[3] if energy else None, basis,
                                  plan.capacity, plan.r_cut ** 2, 1e-4,
                                  rc2_tab)
    return tpc._split(out, basis)


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("typed", [False, True])
def test_proxy_group_of_one_is_the_slab(S, typed):
    """Each shard alone, its group of one (``slab_groups(whole=False)``:
    its slab buffer with its halo layer), gives the slab buffer's own
    lane math bit for bit, and the shards' moments summed equal the
    unsharded ones at the JAX bar."""
    (tl, ts, taux), _ = slab_case(S, typed=typed, n=2000)
    plan, lo = tl.plan, tl.lo
    ev, _ = proxy_basis(typed)
    ct = torch.as_tensor(cotangent(plan, True))
    whole = (ts.positions, ts.types, taux["valid"], ct)
    kw = dict(rc2_tab=tl.rc2_tab, geometry=tl.geometry)
    acc = None
    for one in tcw.slab_groups(tcw.mesh_slabs(plan, cpu_mesh(S)),
                               whole=False):
        assert one.next == (-1,) and len(one.members) == 1
        bufs = [members(t, plan, one) for t in whole]
        got = tpc.proxy_bwd_moments(*bufs, plan, lo, ev.basis, group=one,
                                    **kw)
        want = slab_lane_math(*(b[0] for b in bufs), plan, lo, ev.basis,
                              one.slabs[0], tl.rc2_tab, True, tl.geometry)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        acc = got if acc is None else [a + b for a, b in zip(acc, got)]
    assert_grads(acc, tpc.proxy_bwd_plain(*whole, plan, lo, ev.basis, **kw))


@pytest.mark.parametrize("typed", [False, True])
@pytest.mark.parametrize("energy", [True, False])
def test_proxy_split_groups_match_unsharded_and_jax(typed, energy):
    """Four shards as two groups of two (each group's halo layer filled
    from the whole state): their summed moments equal the unsharded plain
    version and JAX's proxy backward through its XLA contraction at the
    JAX bar."""
    S = 4
    (tl, ts, taux), (jl, js, jaux) = slab_case(S, typed=typed, n=2000)
    plan, lo = tl.plan, tl.lo
    ev, _ = proxy_basis(typed)
    ct_np = cotangent(plan, energy)
    ct = torch.as_tensor(ct_np)
    whole = (ts.positions, ts.types, taux["valid"], ct)
    kw = dict(rc2_tab=tl.rc2_tab, needs_energy=energy, geometry=tl.geometry)
    acc = None
    for grp in groups_of(plan, S, 2):
        assert grp.next[-1] == -1 and grp.next[0] >= 0
        bufs = [members(t, plan, grp) for t in whole]
        assert bufs[0][-1].shape[0] == \
            tcw.halo_layer(plan) * (grp.slabs[-1][1] + 1)
        got = tpc.proxy_bwd_moments(*bufs, plan, lo, ev.basis, group=grp,
                                    **kw)
        acc = got if acc is None else [a + b for a, b in zip(acc, got)]
    want = tpc.proxy_bwd_plain(*whole, plan, lo, ev.basis, **kw)
    if not energy:
        assert not np_(acc[0]).any()
        acc, want = acc[1:], want[1:]
    assert_grads(acc, want)
    jwant = jax_proxy_grads(typed, energy, jl, js, jaux, ct_np)
    got = [np_(a).reshape(jwant[0].shape) for a in acc]
    assert_grads(got, jwant if energy else jwant[1:])


def test_proxy_group_refuses_wrong_buffers():
    """The group wrapper refuses members' buffers of the wrong length and
    a cotangent that does not fit them."""
    (tl, ts, taux), _ = slab_case(2, n=1000)
    plan, lo = tl.plan, tl.lo
    ev, _ = proxy_basis(False)
    ct = torch.as_tensor(cotangent(plan, True))
    grp, = groups_of(plan, 2, 1)
    bufs = [members(t, plan, grp) for t in
            (ts.positions, ts.types, taux["valid"], ct)]
    short = [b[:-1] for b in bufs[0]]
    with pytest.raises(ValueError, match="expected shape"):
        tpc.proxy_bwd_moments(short, *bufs[1:], plan, lo, ev.basis,
                              group=grp)
    with pytest.raises(ValueError, match="ct: expected shape"):
        tpc.proxy_bwd_moments(*bufs[:3], [c[:-1] for c in bufs[3]], plan,
                              lo, ev.basis, group=grp)


# ----------------------------------------------------------------------
# generic_reduce_bwd over a group's joined list, plain version
# ----------------------------------------------------------------------
def joined_list(tl, ts, taux, grp, typed):
    """The group's joined list on the CPU (``generic_group_list``) and the
    members' rows of the state."""
    plan = tl.plan
    bufs = [members(t, plan, grp) for t in
            (ts.positions, ts.types, taux["valid"])]
    gl = tcc.generic_group_list(*bufs, plan, tl.lo, grp, typed_fn=typed,
                                rc2_tab=tl.rc2_tab, geometry=tl.geometry)
    return gl, bufs


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("typed", [False, True])
@pytest.mark.parametrize("energy", [True, False])
def test_reduce_bwd_group_of_every_shard_is_unsharded(S, typed, energy):
    """The group of every shard's joined list is the unsharded plain list
    (lane for lane, cells in order), and ``generic_reduce_bwd`` on it (its
    plain version on the CPU, the cotangent the members' joined
    ``[members, rows, 4]``, halo rows zero) gives the unsharded lanes bit
    for bit."""
    (tl, ts, taux), _ = slab_case(S, typed=typed, n=2000)
    plan = tl.plan
    ct = torch.as_tensor(cotangent(plan, energy))
    lst0 = tcc.generic_list_plain(ts.positions, ts.types, taux["valid"],
                                  plan, tl.lo, rc2_tab=tl.rc2_tab,
                                  geometry=tl.geometry, typed=typed)
    gU0, gS0 = tcc.generic_reduce_bwd_plain(lst0, ct, taux["valid"], plan,
                                            energy)
    grp, = groups_of(plan, S, 1)
    gl, _ = joined_list(tl, ts, taux, grp, typed)
    home = grp.slabs[0][1] * plan.grid[0] * plan.grid[1]
    assert torch.equal(gl.r2, lst0["r2"])
    assert torch.equal(gl.lst["member"] * home + gl.lst["cell"],
                       lst0["cell"])
    layer = tcw.halo_layer(plan)
    rows = (grp.slabs[0][1] + 1) * layer
    ctj = torch.zeros((S, rows, 4))
    for k, (z0, nzl) in enumerate(grp.slabs):
        ctj[k, :nzl * layer] = ct[z0 * layer:(z0 + nzl) * layer]
    gU, gS = tcc.generic_reduce_bwd(gl, ctj, energy)
    assert tcc.generic_reduce_bwd.launches == 0
    assert torch.equal(gS, gS0)
    if energy:
        assert torch.equal(gU, gU0)
    else:
        assert gU is None


@pytest.mark.parametrize("S", [2, 4])
def test_reduce_bwd_group_of_one_is_the_slab(S):
    """A shard's slab list as its group of one: ``generic_reduce_bwd_plain
    (group=)`` on the one-member joined list equals ``slab=`` on the slab
    list bit for bit."""
    (tl, ts, taux), _ = slab_case(S, typed=True, n=2000)
    plan = tl.plan
    ct = torch.as_tensor(cotangent(plan, True))
    for one in tcw.slab_groups(tcw.mesh_slabs(plan, cpu_mesh(S)),
                               whole=False):
        gl, bufs = joined_list(tl, ts, taux, one, True)
        c = members(ct, plan, one)
        slab = one.slabs[0]
        lst = tcc.generic_list_plain(*(b[0] for b in bufs), plan, tl.lo,
                                     rc2_tab=tl.rc2_tab,
                                     geometry=tl.geometry, slab=slab)
        assert torch.equal(gl.r2, lst["r2"])
        got = tcc.generic_reduce_bwd(gl, c, True)
        want = tcc.generic_reduce_bwd_plain(lst, c[0], bufs[2][0], plan,
                                            True, slab=slab)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("typed", [False, True])
def test_reduce_bwd_split_groups_match_unsharded(typed):
    """Four shards as two groups of two: every lane of the two joined
    lists gets the unsharded backward's value for the same pair (matched
    by global cell, row and candidate column) at 1e-4, and together the
    lists hold every unsharded lane once."""
    S = 4
    (tl, ts, taux), _ = slab_case(S, typed=typed, n=2000)
    plan = tl.plan
    nx, ny, _ = plan.grid
    C = len(_HALF_OFFS) * plan.capacity
    ct = torch.as_tensor(cotangent(plan, True))
    lst0 = tcc.generic_list_plain(ts.positions, ts.types, taux["valid"],
                                  plan, tl.lo, rc2_tab=tl.rc2_tab,
                                  geometry=tl.geometry, typed=typed)
    gU0, gS0 = tcc.generic_reduce_bwd_plain(lst0, ct, taux["valid"], plan)
    k0 = (lst0["cell"] * plan.capacity + lst0["row"]) * C + lst0["col"]
    seen = 0
    for grp in groups_of(plan, S, 2):
        gl, _ = joined_list(tl, ts, taux, grp, typed)
        gU, gS = tcc.generic_reduce_bwd(gl, members(ct, plan, grp))
        z0 = torch.tensor([z for z, _ in grp.slabs])[gl.lst["member"]]
        cell = gl.lst["cell"] + z0 * nx * ny
        k = (cell * plan.capacity + gl.lst["row"]) * C + gl.lst["col"]
        idx = torch.searchsorted(k0, k)
        assert bool((k0[idx] == k).all())
        np.testing.assert_allclose(np_(gS), np_(gS0[idx]), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(np_(gU), np_(gU0[idx]), rtol=1e-4,
                                   atol=1e-4)
        seen += k.shape[0]
    assert seen == k0.shape[0]


# ----------------------------------------------------------------------
# the group routes through pair_train_forces(mesh=) against JAX
# ----------------------------------------------------------------------
def lj_params(dtype):
    return {"a": torch.tensor([4.0, 4.0], dtype=dtype)}


def t_lj_apply(p, r2):
    """A pair function linear in its weights: ``U = a0 r^-12 - a1 r^-6``
    and its slope in r2."""
    u = 1.0 / r2
    s6 = u * u * u
    a0, a1 = p["a"][0], p["a"][1]
    return (a0 * s6 * s6 - a1 * s6,
            (-6.0 * a0 * s6 * s6 + 3.0 * a1 * s6) * u)


def j_lj_apply(p, r2):
    u = 1.0 / r2
    s6 = u * u * u
    a0, a1 = p["a"][0], p["a"][1]
    return (a0 * s6 * s6 - a1 * s6,
            (-6.0 * a0 * s6 * s6 + 3.0 * a1 * s6) * u)


@pytest.mark.parametrize("parts", [1, 2])
@pytest.mark.parametrize("route", ["proxy", "list"])
def test_group_routes_match_jax(monkeypatch, parts, route):
    """The coefficients' (proxy: K2's group mode) or the weights' (the
    list route: one list per group, the pair function once on the joined
    list, ``generic_reduce_bwd`` over the group) gradient of ``<ct,
    forces4>`` through ``pair_train_forces(mesh=)`` on 4 shards, as one
    group or two, against the unsharded call and JAX's
    ``pair_train_forces`` (XLA contraction, ``bwd_stencil='half'``) at
    the JAX bar; the forces against the unsharded call's at rtol 1e-5,
    atol 1e-5 max|F|."""
    S = 4
    (tl, ts, taux), (jl, js, jaux) = slab_case(S, n=2000)
    ct_np = cotangent(tl.plan, True)
    ct = torch.as_tensor(ct_np)
    args = (ts.positions, ts.types, taux["valid"], tl.plan, tl.lo)
    if route == "proxy":
        ev, coeffs = proxy_basis(False)
        params, apply, kw = coeffs, ev, {}
        jwant = jax_proxy_grads(False, True, jl, js, jaux, ct_np)
    else:
        params, apply = lj_params(torch.float32), t_lj_apply
        kw = dict(bwd_impl="list")

        def primal(p):
            f4 = j_ptf(p, j_lj_apply, js.positions, js.types, jaux["valid"],
                       jl.plan, jl.lo, fwd_stencil="full", bwd_impl="xla",
                       bwd_stencil="half")
            return jnp.sum(f4 * jnp.asarray(ct_np))
        jwant = [np.asarray(jax.grad(primal)(
            {"a": jnp.asarray([4.0, 4.0], jnp.float32)})["a"])]
    out = []
    with split_groups(monkeypatch, parts):
        for mesh in (cpu_mesh(S), None):
            p = {k: v.detach().clone().requires_grad_()
                 for k, v in params.items()}
            f4 = t_ptf(p, apply, *args, geometry=tl.geometry, mesh=mesh,
                       **kw)
            grads = torch.autograd.grad(torch.sum(f4 * ct), list(p.values()))
            out.append((f4.detach(), grads))
    (f_s, g_s), (f_u, g_u) = out
    # the unsharded proxy forward on the CPU is the full-stencil tensor
    # form, the group's the half stencil: sums in another order
    torch.testing.assert_close(f_s, f_u, rtol=1e-5,
                               atol=1e-5 * float(f_u.abs().max()))
    assert_grads(g_s, g_u)
    got = [np_(g).reshape(np.shape(w)) for g, w in zip(g_s, jwant)]
    assert_grads(got, jwant)
    assert tcc.generic_reduce_bwd.launches == 0
    assert tpc.proxy_bwd_moments.launches == 0


@pytest.mark.parametrize("kind", ["proxy", "pair"])
def test_split_group_train_steps_match_jax(monkeypatch, kind):
    """Three SGD train steps of the sharded engine on 4 shards split into
    two groups (the proxy row through K2's group plain version, the pair
    row through the list route's, ``stencil='kernel'``) against JAX's
    unsharded engine on the same plan: the losses and the weights at the
    bars of tests/test_torch_parallel_train.py."""
    with split_groups(monkeypatch, 2):
        (jsim, jtfc, jm), (tsim, ttfc, tm) = train_pair_sharded(
            kind, 4, stencil="kernel" if kind == "pair" else "auto")
        jsim.run(3)
        tsim.run(3)
        assert branch(tsim) == kind
    np.testing.assert_allclose(ttfc.loss_history, jtfc.loss_history,
                               rtol=2e-4)
    for a, b in zip(trainable(tm.get_weights()), trainable(jm.get_weights())):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-6)
    assert tsim.train_steps == 3


# ----------------------------------------------------------------------
# float64
# ----------------------------------------------------------------------
@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def case64(S, n=1500, seed=3):
    """A float64 fluid packed by both packages on one plan with ``nz %
    S == 0``."""
    pos, vel, lengths = fluid_arrays(n, 0.35, seed)
    pos, vel = pos.astype(np.float64), vel.astype(np.float64)
    lo = -np.asarray(lengths, np.float64) / 2
    plan = tcw.plan_cellwise(n, lengths, 2.5, positions=pos, lo=lo,
                             z_divisor=S)
    jplan = jcw.plan_cellwise(n, lengths, 2.5, positions=pos, lo=lo,
                              z_divisor=S)
    assert (plan.grid, plan.capacity) == (jplan.grid, jplan.capacity)
    tl = SlotLayout(plan, n, lo, dtype=F64, device="cpu")
    ts, taux = tl.pack(t_init_state(pos, lengths, velocities=vel, dtype=F64,
                                    device="cpu"))
    jl = JLayout(jplan, n, lo)
    js, jaux, _ = jl.pack(j_init_state(pos, lengths, velocities=vel,
                                       dtype=jnp.float64))
    return (tl, ts, taux), (jl, js, jaux)


@pytest.mark.parametrize("parts", [1, 2])
@pytest.mark.parametrize("route", ["proxy", "list"])
def test_group_routes_float64(x64, monkeypatch, parts, route):
    """The group routes in float64: the gradient through
    ``pair_train_forces(mesh=)`` on 4 shards (one group or two) against
    the port's unsharded float64 call at rtol 1e-12 and JAX's float64
    XLA contraction at rtol 1e-9."""
    S = 4
    (tl, ts, taux), (jl, js, jaux) = case64(S)
    ct_np = np.random.RandomState(6).randn(tl.plan.n_slots, 4)
    ct = torch.as_tensor(ct_np)
    args = (ts.positions, ts.types, taux["valid"], tl.plan, tl.lo)
    r2_lo = (0.25 * 2.5) ** 2
    if route == "proxy":
        tfit, tev = tch.make_pair_proxy(16, r2_lo, 2.5 ** 2, dtype=F64,
                                        device="cpu")
        jfit, jev = jch.make_pair_proxy(16, r2_lo, 2.5 ** 2,
                                        dtype=jnp.float64)

        def energy(r2):
            u = 1.0 / r2
            return (u * u - 2.0 * u) / (1.0 + u * u)
        params, apply, kw = tfit(energy), tev, {}
        jparams, japply = jfit(lambda r2: (energy(r2), None)), jev
    else:
        params, apply, kw = lj_params(F64), t_lj_apply, dict(bwd_impl="list")
        jparams = {"a": jnp.asarray([4.0, 4.0], jnp.float64)}
        japply = j_lj_apply
    out = []
    with split_groups(monkeypatch, parts):
        for mesh in (cpu_mesh(S), None):
            p = {k: v.detach().clone().requires_grad_()
                 for k, v in params.items()}
            f4 = t_ptf(p, apply, *args, geometry=tl.geometry, mesh=mesh,
                       **kw)
            assert f4.dtype == F64
            out.append(torch.autograd.grad(torch.sum(f4 * ct),
                                           list(p.values())))
    g_s, g_u = out

    def primal(p):
        f4 = j_ptf(p, japply, js.positions, js.types, jaux["valid"],
                   jl.plan, jl.lo, fwd_stencil="full", bwd_impl="xla",
                   bwd_stencil="half")
        return jnp.sum(f4 * jnp.asarray(ct_np))
    jg = jax.grad(primal)(jparams)
    want = [np.asarray(jg[k]) for k in params]
    for a, b, w in zip(g_s, g_u, want):
        assert a.dtype == F64
        np.testing.assert_allclose(np_(a), np_(b), rtol=1e-12,
                                   atol=1e-12 * np.abs(np_(b)).max())
        np.testing.assert_allclose(np_(a), w, rtol=1e-9,
                                   atol=1e-9 * np.abs(w).max())
