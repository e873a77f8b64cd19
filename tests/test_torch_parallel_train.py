"""Online training, the planes route and NPT under a device mesh, the
port against the JAX package on the CPU: the training backward per z-slab
shard (K2's slab plain version, ``generic_reduce_bwd``'s and the list
route's, the lane contraction over slab buffers), ``pair_train_forces(
mesh=)``, the sharded engine's ``train=True`` for every model kind, the
sharded planes route and NPT, on virtual CPU shards (``make_mesh(S,
devices=[cpu] * S)``); and ``sharded_train_step`` where a weight
constraint binds.

Tolerances: the shards' summed proxy moments against the unsharded plain
version and JAX's XLA contraction at rtol 2e-4, atol 2e-5 max|g| (the JAX
package's bar for its Pallas proxy backward); ``generic_reduce_bwd``'s
slab lanes against the unsharded lanes at 1e-4 (the same float32
products, so in fact equal); weight gradients through
``pair_train_forces(mesh=)`` against JAX's at the same bar as K2's; three
sharded SGD train steps against JAX's unsharded engine on the same plan
in losses and weights at rtol 2e-4 (atol 1e-6 on the weights: the last
bias gets a gradient of float32 noise under a force loss); the planes
kind in float64 (its three float32 steps diverge, the loss 5.9 -> 241 ->
4.5e5 at 2000 particles, so the last step's huge gradient carries every
earlier rounding into the weights), at 1000 particles: the losses at
rtol 1e-10 and the weights at rtol 1e-9 against JAX's float64 engine,
the weights at rtol 1e-11 against the port's own unsharded engine; 8 NPT
steps
against JAX's NPT at atol 5e-4 in positions (tests/test_parallel.py's
bar), rtol 1e-5 in volume; the sharded planes against the unsharded ones
exactly, and the forces of a model with a cross-row reduction at 1e-5;
the constrained ``sharded_train_step`` against JAX's at rtol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import hoomd_tf_tpu as htf
from hoomd_tf_tpu.ops import cellwise as jcw
from hoomd_tf_tpu.ops.pair_train import pair_train_forces as j_ptf
import hoomd_tf_tpu_torch as htt
from hoomd_tf_tpu_torch.interop import (build_model, load_jax_variables,
                                        state_from_numpy)
from hoomd_tf_tpu_torch.md.simulation import _module_pair_apply
from hoomd_tf_tpu_torch.ops import cellwise as tcw
from hoomd_tf_tpu_torch.ops import cellwise_cuda as tcc
from hoomd_tf_tpu_torch.ops import pair_train_cuda as tpc
from hoomd_tf_tpu_torch.ops.chebyshev import make_pair_proxy
from hoomd_tf_tpu_torch.ops.pair_train import pair_train_forces as t_ptf
from hoomd_tf_tpu_torch.parallel import ShardedSimulation

from test_torch_parallel import (TLJ, TLJLayer, cpu_mesh, min_image_diff,
                                 slab_case)
from test_torch_train import JNNPair as JProxyNN
from test_torch_train_generic import (KINDS, JCoupled, TCoupled, build_jax,
                                      trainable)
from test_torch_train_pair import WIDTH
from test_torch_train_pair import models as nn_models
from test_torch_train_pair import j_pair_apply
from torch_helpers import (fluid_arrays, force_loss, jax_state,
                           jax_state_numpy, nn_pair_class, np_,
                           seed_jax_weights)

R_CUT = 2.5


def assert_grads(got, want):
    scale = max(float(np.abs(np_(w)).max()) for w in want)
    assert scale > 0
    for a, b in zip(got, want):
        np.testing.assert_allclose(np_(a), np_(b), rtol=2e-4,
                                   atol=2e-5 * scale)


def cotangent(plan, energy, seed=5):
    ct = np.random.RandomState(seed).randn(plan.n_slots, 4).astype(
        np.float32)
    if not energy:
        ct[:, 3] = 0.0
    return ct


def shard_bufs(plan, S, *tensors):
    """Each shard's ``(device, z0, nzl)`` and its slab buffers."""
    return [((dev, z0, nzl), [tcw.slab_buffer(t, plan, z0, nzl, dev)
                              for t in tensors])
            for dev, z0, nzl in tcw.mesh_slabs(plan, cpu_mesh(S))]


# ----------------------------------------------------------------------
# the backward's slab plain versions
# ----------------------------------------------------------------------
def proxy_basis(typed):
    """A fitted Chebyshev proxy (K 8) of a smooth LJ: the port's evaluator
    and coefficients, untyped or over two types."""
    from hoomd_tf_tpu_torch.ops.chebyshev import make_typed_pair_proxy
    lo2, hi2 = (0.25 * R_CUT) ** 2, R_CUT ** 2
    if not typed:
        fit, ev = make_pair_proxy(8, lo2, hi2, device="cpu")
        return ev, fit(lambda r2: 4.0 * (r2 ** -6 - r2 ** -3))
    fit, ev = make_typed_pair_proxy(8, lo2, hi2, 2, device="cpu")
    return ev, fit(lambda r2, ti, tj: 4.0 * (r2 ** -6 - r2 ** -3) *
                   torch.where((ti == 0) & (tj == 0), 1.0, 0.6))


def jax_proxy_grads(typed, energy, jl, js, jaux, ct):
    """The JAX package's proxy gradient of ``<ct, forces4>`` in the
    coefficients, by its XLA lane contraction, as the port's ``[P * 2K]``
    ``(g_c, g_cd)`` (the proxy is linear in its coefficients, so any
    coefficients give it)."""
    from hoomd_tf_tpu.ops import chebyshev as jch
    lo2, hi2 = (0.25 * R_CUT) ** 2, R_CUT ** 2
    if typed:
        fit, ev = jch.make_typed_pair_proxy(8, lo2, hi2, 2)
        params = fit(lambda r2, ti, tj: (r2, r2))
    else:
        fit, ev = jch.make_pair_proxy(8, lo2, hi2)
        params = fit(lambda r2: (r2, r2))

    def primal(p):
        f4 = j_ptf(p, ev, js.positions, js.types, jaux["valid"], jl.plan,
                   jl.lo, with_types=typed, rcut_matrix=jl.rc_matrix,
                   needs_energy=energy, fwd_stencil="full", bwd_impl="xla")
        return jnp.sum(f4 * jnp.asarray(ct))
    g = jax.grad(primal)(params)
    sets = [g[ab] for ab in ev.basis["pairs"]] if typed else [g]
    return (np.stack([np.asarray(s["c"]) for s in sets]),
            np.stack([np.asarray(s["cd"]) for s in sets]))


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("typed", [False, True])
@pytest.mark.parametrize("energy", [True, False])
def test_proxy_slab_moments_sum_to_unsharded_and_jax(S, typed, energy):
    """The shards' ``proxy_bwd_moments(group=)``, each shard a group of
    one with its halo layer (the plain version on the CPU), summed, equal
    the unsharded plain version and JAX's proxy backward through its XLA
    contraction."""
    (tl, ts, taux), (jl, js, jaux) = slab_case(S, typed=typed, n=2000)
    plan, lo = tl.plan, tl.lo
    ev, _ = proxy_basis(typed)
    ct_np = cotangent(plan, energy)
    ct = torch.as_tensor(ct_np)
    args = (ts.positions, ts.types, taux["valid"])
    kw = dict(rc2_tab=tl.rc2_tab, needs_energy=energy)
    g0 = tpc.proxy_bwd_plain(*args, ct, plan, lo, ev.basis,
                             geometry=tl.geometry, **kw)
    acc = None
    ones = tcw.slab_groups(tcw.mesh_slabs(plan, cpu_mesh(S)), whole=False)
    for one, ((dev, _, _), buf) in zip(ones, shard_bufs(plan, S, *args,
                                                         ct)):
        part = tpc.proxy_bwd_moments(*([b] for b in buf), plan, lo,
                                     ev.basis, geometry=tl.geometry.on(dev),
                                     group=one, **kw)
        acc = part if acc is None else [a + b for a, b in zip(acc, part)]
    assert tpc.proxy_bwd_moments.launches == 0   # plain on the CPU
    if not energy:
        assert not np_(acc[0]).any()
        acc, g0 = acc[1:], g0[1:]
    assert_grads(acc, g0)
    want = jax_proxy_grads(typed, energy, jl, js, jaux, ct_np)
    got = [np_(a).reshape(want[0].shape) for a in acc]
    assert_grads(got, want if energy else want[1:])


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("case", ["pair", "typed"])
def test_reduce_bwd_slab_lanes_equal_unsharded(S, case):
    """``generic_reduce_bwd`` on each shard's slab list (its plain version
    on the CPU, the shard its group of one) gives every lane the unsharded
    backward gives the same pair (matched by global cell, row and
    candidate column), at 1e-4; the shards' lanes together are the whole
    state's."""
    typed = case == "typed"
    (tl, ts, taux), _ = slab_case(S, typed=typed, n=2000)
    plan, lo = tl.plan, tl.lo
    nx, ny, _ = plan.grid
    ct = torch.as_tensor(cotangent(plan, True))
    args = (ts.positions, ts.types, taux["valid"])
    lst0 = tcc.generic_list_plain(*args, plan, lo, rc2_tab=tl.rc2_tab,
                                  geometry=tl.geometry, typed=typed)
    gU0, gS0 = tcc.generic_reduce_bwd_plain(lst0, ct, taux["valid"], plan)
    C = 14 * plan.capacity

    def key(lst, z0=0):
        return ((lst["cell"] + z0 * nx * ny) * plan.capacity +
                lst["row"]) * C + lst["col"]

    k0 = key(lst0)
    assert bool((k0[1:] > k0[:-1]).all())
    seen = 0
    for s, ((dev, z0, nzl), buf) in enumerate(shard_bufs(plan, S, *args,
                                                         ct)):
        one = tcw.SlabGroup(torch.device(dev), (s,), ((z0, nzl),), (-1,),
                            (-1,))
        gl = tcc.generic_group_list(*([t] for t in buf[:3]), plan, lo, one,
                                    typed_fn=typed, rc2_tab=tl.rc2_tab,
                                    geometry=tl.geometry.on(dev))
        lst = gl.lst
        gU, gS = tcc.generic_reduce_bwd(gl, [buf[3]])
        k = key(lst, z0)
        idx = torch.searchsorted(k0, k)
        assert bool((k0[idx] == k).all())
        np.testing.assert_allclose(np_(gS), np_(gS0[idx]), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(np_(gU), np_(gU0[idx]), rtol=1e-4,
                                   atol=1e-4)
        seen += k.shape[0]
    assert seen == k0.shape[0]
    assert tcc.generic_reduce_bwd.launches == 0


def test_slab_list_reduce_equals_slab_plain():
    """The list route's plain reduction on a shard as its group of one
    (list, pair function, ``generic_group_reduce_plain``) equals K1's slab
    plain version, reverse halo included."""
    S = 4
    (tl, ts, taux), _ = slab_case(S, n=2000)
    plan, lo = tl.plan, tl.lo
    form = htt.md.LennardJones(r_cut=R_CUT).kernel_form()
    for k, ((dev, z0, nzl), buf) in enumerate(shard_bufs(
            plan, S, ts.positions, ts.types, taux["valid"])):
        one = tcw.SlabGroup(torch.device(dev), (k,), ((z0, nzl),), (-1,),
                            (-1,))
        gl = tcc.generic_group_list(*([t] for t in buf), plan, lo, one,
                                    typed_fn=False, geometry=tl.geometry)
        U, s = gl.evaluate(form.evaluate)
        (f_l,), (w_l,) = tcc.generic_reduce(gl, U, s, needs_virial=True)
        f_p, w_p = tcw.half_stencil_slab_plain(
            *buf, plan, lo, form.evaluate, z0, nzl, needs_virial=True,
            geometry=tl.geometry)
        torch.testing.assert_close(f_l, f_p, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(w_l, w_p, rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------------
# pair_train_forces(mesh=)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("route", ["contract", "list"])
@pytest.mark.parametrize("kind", ["pair", "synth"])
def test_pair_train_forces_mesh_grads_match_jax(kind, route):
    """The weights' gradient of ``<ct, forces4>`` through ``pair_train_
    forces(mesh=)`` on 4 shards (the CPU contraction over slab buffers, or
    the list route's slab plain versions) against JAX's ``pair_train_
    forces`` (XLA contraction), and its forces against the unsharded
    call's at 1e-5."""
    from hoomd_tf_tpu.ops.lane_fast import synthesize_pair_fn as j_synth
    from hoomd_tf_tpu_torch.ops.lane_fast import synthesize_pair_fn as \
        t_synth
    S = 4
    (tl, ts, taux), (jl, js, jaux) = slab_case(S, n=2000)
    ct = cotangent(tl.plan, True)
    jm, tm = nn_models(kind)
    if kind == "pair":
        apply, params = j_pair_apply(jm, lambda: jm.pair_energy_and_slope)
        fn, typed = tm.pair_energy_and_slope, False
    else:
        apply, params = j_pair_apply(jm, lambda: j_synth(jm, js.box))
        fn, typed = t_synth(tm, ts.box, differentiable=True), True

    def primal(p):
        f4 = j_ptf(p, apply, js.positions, js.types, jaux["valid"],
                   jl.plan, jl.lo, with_types=typed, fwd_stencil="full",
                   bwd_impl="xla")
        return jnp.sum(f4 * jnp.asarray(ct))
    want = [np.asarray(g) for g in jax.grad(primal)(params)]
    named = {k: v for k, v in tm.named_parameters() if v.requires_grad}
    args = (ts.positions, ts.types, taux["valid"], tl.plan, tl.lo)
    kw = dict(with_types=typed, geometry=tl.geometry,
              bwd_impl="list" if route == "list" else "auto")
    f4 = t_ptf(named, _module_pair_apply(tm, fn), *args, mesh=cpu_mesh(S),
               **kw)
    got = torch.autograd.grad(torch.sum(f4 * torch.as_tensor(ct)),
                              tm.trainable_weights())
    assert_grads(got, want)
    f0 = t_ptf(named, _module_pair_apply(tm, fn), *args, **kw)
    torch.testing.assert_close(f4.detach(), f0.detach(), rtol=1e-5,
                               atol=1e-5)
    assert tcc.generic_reduce_bwd.launches == 0


def test_pair_train_forces_mesh_proxy_matches_jax():
    """A proxy through ``pair_train_forces(mesh=)`` on 4 shards (K2's slab
    plain version per shard): the gradient of the coefficients equals
    JAX's ``pair_train_forces`` (its XLA contraction) and the unsharded
    call's."""
    S = 4
    (tl, ts, taux), (jl, js, jaux) = slab_case(S, n=2000)
    ev, coeffs = proxy_basis(False)
    ct_np = cotangent(tl.plan, True)
    ct = torch.as_tensor(ct_np)
    args = (ts.positions, ts.types, taux["valid"], tl.plan, tl.lo)
    grads = []
    for mesh in (cpu_mesh(S), None):
        p = {k: v.clone().requires_grad_() for k, v in coeffs.items()}
        f4 = t_ptf(p, ev, *args, geometry=tl.geometry, mesh=mesh)
        grads.append(torch.autograd.grad(torch.sum(f4 * ct),
                                         [p["c"], p["cd"]]))
    assert_grads(*grads)
    want = jax_proxy_grads(False, True, jl, js, jaux, ct_np)
    assert_grads([np_(g).reshape(want[0].shape) for g in grads[0]], want)


# ----------------------------------------------------------------------
# the sharded engine's training against JAX's unsharded engine
# ----------------------------------------------------------------------
class JCoupled64(JCoupled):
    """test_torch_train_generic.py's coupled SimModel (the probe rejects
    it) with its layers in the model's dtype."""

    def setup(self):
        self.dense1 = htf.Dense(WIDTH, dtype=self.dtype)
        self.last = htf.Dense(1, dtype=self.dtype)


class TCoupled64(TCoupled):
    def setup(self):
        self.dense1 = htt.Dense(WIDTH, dtype=self.dtype)
        self.last = htt.Dense(1, dtype=self.dtype)


def train_pair_sharded(kind, S, n=2000, seed=1, lr=1e-3, stencil="auto",
                       f64=False):
    """A JAX simulation (unsharded) and a port simulation on an ``S``-shard
    CPU mesh (``S`` None: unsharded) from the same state and weights, each
    training ``kind`` online with SGD against its built-in LJ on the same
    cellwise plan (the port's, ``nz % S == 0``; the loss averages over slot
    rows, so both must share it): ``(jsim, jtfc, jm), (tsim, ttfc, tm)``.
    ``f64``: state and model in float64 (JAX's x64 must be on)."""
    pos, vel, lengths = fluid_arrays(n, 0.4, seed, kT=1.5)
    if f64:
        from hoomd_tf_tpu.md.state import init_state
        js = init_state(pos.astype(np.float64), lengths,
                        velocities=vel.astype(np.float64), dtype=jnp.float64)
    else:
        js = jax_state(pos, vel, lengths)
    if f64:
        jloss, tloss = "mse", "mse"
        jm = seed_jax_weights(build_jax(JCoupled64(
            64, output_forces=False, dtype=jnp.float64)), 0)
        tm = TCoupled64(64, output_forces=False, dtype=torch.float64)
    elif kind == "proxy":
        jm = JProxyNN(64, output_forces=False, proxy_degree=16)
        jm.pair_energy(jnp.ones(4))
        seed_jax_weights(jm, 0)
        jloss, tm, tloss = ("mse", nn_pair_class()(
            64, output_forces=False, proxy_degree=16), force_loss)
        from test_torch_train import j_force_loss
        jloss = j_force_loss
    else:
        jmk, tmk, jloss, tloss, _ = KINDS[kind]
        jm = seed_jax_weights(build_jax(jmk()), 0)
        tm = tmk()
    jsim = htf.Simulation(dt=0.005, integrator=htf.md.NVT(kT=1.5, tau=0.5),
                          seed=seed)
    jsim.set_state(js)
    jsim.add_force(htf.md.LennardJones(r_cut=R_CUT))
    jm.compile(optimizer="sgd", loss=jloss, learning_rate=lr)
    jtfc = htf.tfcompute(jm)
    jtfc.attach(jsim, r_cut=R_CUT, nlist="cellwise", train=True)

    tsim = htt.Simulation(dt=0.005, integrator=htt.md.NVT(kT=1.5, tau=0.5),
                          seed=seed, mesh=None if S is None else cpu_mesh(S),
                          device="cpu" if S is None else None)
    tsim.stencil = stencil
    tsim.set_state(state_from_numpy(jax_state_numpy(js), device="cpu"))
    tsim.add_force(htt.md.LennardJones(r_cut=R_CUT))
    build_model(tm, R_CUT, "cpu")
    load_jax_variables(tm, jm.get_weights())
    tm.compile(optimizer="sgd", loss=tloss, learning_rate=lr)
    ttfc = htt.tfcompute(tm)
    ttfc.attach(tsim, r_cut=R_CUT, nlist="cellwise", train=True)
    tp = tsim._ensure_layout().plan
    assert tp.grid[2] % (S or 1) == 0
    jplan = jcw.CellwisePlan(grid=tp.grid, capacity=tp.capacity,
                             lengths=tp.lengths, r_cut=tp.r_cut)
    jsim._plan_from_current = lambda: jplan
    return (jsim, jtfc, jm), (tsim, ttfc, tm)


def branch(tsim):
    return tsim._route(tsim._layout, *tsim._layout.pack(tsim.state)) \
        .trainer.kind


@pytest.mark.parametrize("kind", ["proxy", "pair", "lane", "planes"])
def test_sharded_train_steps_match_jax(kind):
    """Three SGD train steps of the port's sharded engine (4 shards) against
    JAX's unsharded engine on the same plan: the losses and the weights at
    rtol 2e-4; each kind on its own branch. The planes kind runs in
    float64 (:func:`sharded_planes_train_f64`): its three float32 steps
    diverge (the loss 5.9 -> 241 -> 4.5e5 at 2000 particles), and the
    port lands 1.1e-4 (unsharded) and 2.2e-4 (sharded) from JAX in one
    weight; in float64 the sharded and unsharded ports agree to 4e-15
    there, so the float32 gap is rounding the last, huge gradient
    carries, not the mesh."""
    if kind == "planes":
        jax.config.update("jax_enable_x64", True)
        try:
            sharded_planes_train_f64()
        finally:
            jax.config.update("jax_enable_x64", False)
        return
    (jsim, jtfc, jm), (tsim, ttfc, tm) = train_pair_sharded(kind, 4)
    jsim.run(3)
    tsim.run(3)
    assert branch(tsim) == kind
    assert jsim._layout.plan.grid == tsim._layout.plan.grid
    assert len(ttfc.loss_history) == len(jtfc.loss_history) == 3
    np.testing.assert_allclose(ttfc.loss_history, jtfc.loss_history,
                               rtol=2e-4)
    for a, b in zip(trainable(tm.get_weights()), trainable(jm.get_weights())):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-6)
    assert tsim.train_steps == 3


def sharded_planes_train_f64():
    """Three float64 SGD steps of the planes branch at 1000 particles on 4
    shards against JAX's float64 engine (losses rtol 1e-10, weights rtol
    1e-9) and the port's unsharded engine on the same plan (weights rtol
    1e-11)."""
    (jsim, jtfc, jm), (tsim, ttfc, tm) = train_pair_sharded(
        "planes", 4, n=1000, f64=True)
    _, (usim, utfc, um) = train_pair_sharded("planes", None, n=1000,
                                             f64=True)
    plan = tsim._ensure_layout().plan
    usim._plan_from_current = lambda: plan
    usim.replan()
    for sim in (jsim, tsim, usim):
        sim.run(3)
    assert branch(tsim) == branch(usim) == "planes"
    assert usim._layout.plan == plan
    assert jsim._layout.plan.grid == plan.grid
    assert tsim.state.positions.dtype == torch.float64
    assert len(ttfc.loss_history) == len(jtfc.loss_history) == 3
    np.testing.assert_allclose(ttfc.loss_history, jtfc.loss_history,
                               rtol=1e-10)
    np.testing.assert_allclose(utfc.loss_history, ttfc.loss_history,
                               rtol=1e-12)
    wj, wt, wu = (trainable(m.get_weights()) for m in (jm, tm, um))
    assert all(w.dtype == np.float64 for w in wt)
    for a, b, c in zip(wt, wj, wu):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(a, c, rtol=1e-11, atol=1e-14)
    assert tsim.train_steps == usim.train_steps == 3


@pytest.mark.parametrize("kind", ["pair", "lane"])
def test_sharded_list_route_matches_jax(kind):
    """``stencil='kernel'`` on the CPU: the sharded list route's slab plain
    versions (K1's generic form and ``generic_reduce_bwd`` per shard, the
    card's route), two shards, three steps against JAX's engine."""
    (jsim, jtfc, jm), (tsim, ttfc, tm) = train_pair_sharded(
        kind, 2, stencil="kernel")
    jsim.run(3)
    tsim.run(3)
    np.testing.assert_allclose(ttfc.loss_history, jtfc.loss_history,
                               rtol=2e-4)
    for a, b in zip(trainable(tm.get_weights()), trainable(jm.get_weights())):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-6)


class TTrainablePlanes(htt.SimModel):
    """tests/test_cellwise.py's TrainablePlanes: a trainable LJ (zoo's
    LJLayer) written against the planes-compatible helpers; the probe
    accepts it, so it trains on the 'lane' branch."""

    def setup(self):
        self.lj = TLJLayer(1.0, 1.0)

    def compute(self, nlist, positions, box):
        rinv = htt.nlist_rinv(nlist)
        r = htt.divide_no_nan(1.0, rinv)
        return htt.compute_nlist_forces(nlist, torch.sum(self.lj(r), dim=1))


def test_sharded_lane_training_loss_decreases():
    """tests/test_parallel.py's sharded online training (Langevin at kT
    0.8, Adam 5e-2, the trainable LJ from weights (0.6, 1.3), the built-in
    LJ named by ``set_reference_forces``) through ShardedSimulation on 4
    shards, 2000 particles: a lane model, and the loss falls."""
    sim = ShardedSimulation(dt=0.005, mesh=cpu_mesh(4), seed=4,
                            integrator=htt.md.Langevin(kT=0.8, gamma=1.0))
    pos, vel, lengths = fluid_arrays(2000, 0.4, 4, kT=0.8)
    sim.init_state(pos, lengths, velocities=vel)
    lj = sim.add_force(htt.md.LennardJones(r_cut=R_CUT))
    model = TTrainablePlanes(48, output_forces=False)
    build_model(model, R_CUT, "cpu")
    with torch.no_grad():
        model.lj.w.copy_(torch.tensor([0.6, 1.3]))
    model.compile(optimizer="adam", loss="mse", learning_rate=5e-2)
    tfc = sim.attach(model, r_cut=R_CUT, train=True)
    assert tfc.nlist_method == "cellwise"
    tfc.set_reference_forces(lj)
    sim.run(40)
    losses = np.asarray(tfc.loss_history)
    assert len(losses) == 40 and np.all(np.isfinite(losses))
    assert branch(sim) == "lane"
    assert np.mean(losses[-10:]) < np.mean(losses[:10])


# ----------------------------------------------------------------------
# NPT and the planes route under a mesh
# ----------------------------------------------------------------------
def test_sharded_npt_matches_jax():
    """8 NPT steps of the port's sharded engine (4 shards, the dynamic-box
    layout planned with the mesh's divisor) against JAX's NPT on one
    device: positions at atol 5e-4, the volume at rtol 1e-5, and the
    barostat moved the box."""
    n = 2000
    pos, vel, lengths = fluid_arrays(n, 0.4, 2, jitter=0.08, kT=1.2)
    integ = dict(kT=1.2, tau=0.5, P=0.3, tauP=0.5)
    jsim = htf.Simulation(dt=0.004, integrator=htf.md.NPT(**integ), seed=2)
    jsim.init_state(pos, lengths, velocities=vel)
    htf.tfcompute(KINDS_J_LJ()).attach(jsim, r_cut=R_CUT, nlist="n2")
    tsim = htt.Simulation(dt=0.004, integrator=htt.md.NPT(**integ), seed=2,
                          mesh=cpu_mesh(4))
    tsim.init_state(pos, lengths, velocities=vel)
    htt.tfcompute(TLJ(48, virial=True)).attach(tsim, r_cut=R_CUT,
                                               nlist="cellwise")
    layout = tsim._ensure_layout()
    assert layout.dynamic_box and layout.plan.grid[2] % 4 == 0
    v0 = float(np.prod(lengths))
    jsim.run(8)
    tsim.run(8)
    vj = float(np.prod(np.asarray(jsim.state.box[1] - jsim.state.box[0])))
    vt = float(torch.prod(tsim.state.box[1] - tsim.state.box[0]))
    np.testing.assert_allclose(vt, vj, rtol=1e-5)
    assert abs(vt - v0) > 1e-4 * v0
    d = min_image_diff(tsim.state.positions, jsim.state.positions,
                       np.asarray(tsim.state.box[1] - tsim.state.box[0]))
    np.testing.assert_allclose(d, np.zeros_like(d), atol=5e-4)


def KINDS_J_LJ():
    import zoo
    return zoo.PairLJ(48, virial=True)


class TPlanesMean(htt.SimModel):
    """A many-body SimModel (the probe rejects it) with a cross-row
    reduction: each particle's energy scaled by the mean coordination."""

    def compute(self, nlist, positions, box):
        rinv = htt.nlist_rinv(nlist)
        s = torch.sum(rinv ** 6, dim=1)
        e = 0.1 * s * s * (1.0 + 0.1 * torch.mean(torch.sum(rinv, dim=1)))
        return htt.compute_nlist_forces(nlist, e)


@pytest.mark.parametrize("S", [2, 4])
def test_sharded_planes_equal_unsharded(S):
    """The planes built per resident shard (its home layers and its
    neighbours' boundary layers) equal the unsharded planes exactly, and a
    model with a cross-row reduction gives the same forces and, after 5
    NVT steps, the same state sharded and unsharded (1e-5)."""
    pos, vel, lengths = fluid_arrays(2000, 0.4, 3, jitter=0.08)
    sims = []
    for mesh in (cpu_mesh(S), None):
        sim = htt.Simulation(dt=0.005, integrator=htt.md.NVT(kT=1.0, tau=0.5),
                             seed=3, mesh=mesh,
                             device=None if mesh else "cpu")
        sim.init_state(pos, lengths, velocities=vel)
        htt.tfcompute(TPlanesMean(48)).attach(sim, r_cut=R_CUT,
                                              nlist="cellwise")
        sims.append(sim)
    shd, ref = sims
    ls = shd._ensure_layout()
    lr = ref._ensure_layout(ls.plan)
    st, aux = lr.pack(ref.state)
    slots = ls.resident(shd.mesh)
    sst, saux = slots.pack(shd.state)
    p_s = slots.planes(sst, saux)
    p_r = lr.planes(st, aux)
    for a, b in zip(p_s, p_r):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    r_s = shd._route(ls, sst, saux)
    assert r_s.planes
    f_s, _ = shd._forces(sst, saux, slots, r_s, True, False)
    f_r, _ = ref._forces(st, aux, lr, ref._route(lr, st, aux), True, False)
    torch.testing.assert_close(slots.whole(f_s), f_r, rtol=1e-5, atol=1e-5)
    ref._plan_from_current = lambda: ls.plan
    shd._choose_repack_interval = ref._choose_repack_interval = \
        lambda layout: 3
    shd.run(5)
    ref.run(5)
    torch.testing.assert_close(shd.state.positions, ref.state.positions,
                               rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------------
# sharded_train_step where a constraint binds
# ----------------------------------------------------------------------
def lj_frames(n=64, NN=16, n_frames=4, seed=2):
    """Jittered lattices and LJ labels at epsilon 1, sigma 1, numpy."""
    rng = np.random.RandomState(seed)
    base, lengths = htt.md.lattice_positions(n, a=1.3)
    L = float(lengths[0])
    lj = htt.md.LennardJones(r_cut=3.0)
    sim = htt.Simulation(device="cpu")
    nls, p4s, labs = [], [], []
    for _ in range(n_frames):
        pos = (base + 0.05 * rng.randn(n, 3)).astype(np.float32)
        pos4 = torch.as_tensor(np.concatenate(
            [pos, np.zeros((n, 1), np.float32)], axis=1))
        nl = htt.compute_nlist(pos4, 3.0, NN, [L, L, L], sorted=True,
                               return_types=True)
        sim.init_state(pos, [L, L, L])
        lab, _ = lj(sim.state, nl)
        nls.append(np_(nl))
        p4s.append(np_(pos4))
        labs.append(np_(lab))
    return np.stack(nls), np.stack(p4s), np.stack(labs), L


def test_sharded_train_step_leaves_constraints_like_jax():
    """One Adam step of ``sharded_train_step`` (4 shards, 4 frames) with
    TrainableLJ, whose epsilon and sigma are constrained nonnegative,
    from (0.5, 1.0) against the negated LJ labels, which pull both down:
    Adam's first step moves each weight by about the learning rate, so at
    lr 10 both go below 0. The port's weights equal the JAX step's (rtol
    1e-5), which applies no constraint: both end negative. (optax rounds
    its bias correction ``1 - 0.999`` in float32, which makes its step
    6.5e-6 shorter than torch's; a step of 10 from 0.5 keeps that below
    the tolerance.)"""
    import optax
    from hoomd_tf_tpu.parallel import make_mesh as j_make_mesh
    from hoomd_tf_tpu.parallel import sharded_train_step as j_step
    from hoomd_tf_tpu.models.module import get_state as j_get_state
    from hoomd_tf_tpu_torch.parallel import sharded_train_step as t_step
    NN, lr = 16, 10.0
    nl, p4, lab, L = lj_frames(NN=NN)
    lab = -lab
    jm = htf.TrainableLJ(NN, epsilon=0.5, sigma=1.0)
    jbox = htf.box_from_lengths([L] * 3)
    jm([jnp.asarray(nl[0]), jnp.asarray(p4[0]), jbox])
    opt = optax.adam(lr)
    vals = j_get_state(jm)
    tidx = [i for i, v in enumerate(jm.variables) if v.trainable]
    params = [vals[i] for i in tidx]
    step = j_step(jm, opt, j_make_mesh(4))
    _, params, _ = step(params, vals, opt.init(params), jnp.asarray(nl),
                        jnp.asarray(p4), jbox, jnp.asarray(lab))
    want = [float(p) for p in params]

    tm = htt.TrainableLJ(NN, epsilon=0.5, sigma=1.0)
    tbox = htt.box_from_lengths([L] * 3, device="cpu")
    tm([torch.as_tensor(nl[0]), torch.as_tensor(p4[0]), tbox])
    topt = torch.optim.Adam(tm.trainable_weights(), lr=lr)
    tstep = t_step(tm, topt, cpu_mesh(4))
    tstep(torch.as_tensor(nl), torch.as_tensor(p4), tbox,
          torch.as_tensor(lab))
    got = [float(w.detach()) for w in tm.trainable_weights()]
    assert want[0] < 0 and want[1] < 0, want
    np.testing.assert_allclose(got, want, rtol=1e-5)
