"""Online training under a mesh on the slot state resident per z-slab
shard (``Simulation(mesh=)`` on ``'cellwise'``, the ``'proxy'``,
``'pair'`` and ``'lane'`` branches of ``_Trainer``), on virtual CPU
shards (``make_mesh(4, devices=[cpu] * 4)``): the labels, K1's group
forward, the loss on the shards' home rows and the backward (K2's group
plain version, the lane contraction per shard, or with
``stencil='kernel'`` the list route's plain versions) on each shard's own
buffers, against the JAX package's unsharded engine and the port's.

Tolerances: three SGD train steps against JAX's unsharded engine on the
same plan in losses and weights at rtol 2e-4, the weights with atol 1e-6
(tests/test_torch_parallel_train.py's bar), and against the port's
unsharded engine at rtol 1e-5 (atol 1e-7 on the weights: the last bias
of a force loss takes float32 noise), the typed proxy on an 80:20
mixture too; in float64 against JAX's x64 engine, the losses at rtol
1e-10 and the weights at rtol 1e-9, and against the port's unsharded
float64 engine the losses at rtol 1e-12 and the weights at rtol 1e-11
(the bars of ``sharded_planes_train_f64``). Two groups of shards against
one: the weights' gradient at 1e-6 of max|g|, the forces at 1e-5 of
max|F|. The run-control cases (rollback, a too-short list, ``period``,
``label_subset``, a checkpoint) against a clean run of the same engine
bit for bit, or against the unsharded engine at the bars above.
"""

import os
import tempfile
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hoomd_tf_tpu as htf
from hoomd_tf_tpu.ops import cellwise as jcw
import hoomd_tf_tpu_torch as htt
from hoomd_tf_tpu_torch.interop import (build_model, load_jax_variables,
                                        state_from_numpy)
from hoomd_tf_tpu_torch.md.slots import SlabSlots, SlotLayout
from hoomd_tf_tpu_torch.md.state import SlabState
from hoomd_tf_tpu_torch.ops import cellwise as tcw
from hoomd_tf_tpu_torch.ops import cellwise_cuda as tcc
from hoomd_tf_tpu_torch.ops import pair_train_cuda as tpc
from hoomd_tf_tpu_torch.ops.pair_train import pair_train_forces as t_ptf
from hoomd_tf_tpu_torch.ops.pair_train import resident_train_forces

from test_torch_parallel import cpu_mesh
from test_torch_parallel_train import R_CUT, branch, train_pair_sharded
from test_torch_train_generic import (j_force_loss, t_force_loss,
                                      trainable)
from test_torch_train_group import lj_params, split_groups, t_lj_apply
from test_torch_train_pair import WIDTH, JNNPair, TNNPair
from test_torch_typed_train import (KA_EPS, KA_SIG, JTypedNN, TTypedNN,
                                    mixture_types)
from torch_helpers import (fluid_arrays, force_loss, jax_state,
                           jax_state_numpy, seed_jax_weights)

S = 4


def pin_plan(sim, plan):
    """``sim`` replanned to ``plan`` (the loss averages over slot rows:
    two training runs compare only on one plan)."""
    sim._plan_from_current = lambda: plan
    sim.replan()
    assert sim._ensure_layout().plan == plan


def unsharded_twin(kind, plan, **kw):
    """The port's unsharded engine of :func:`train_pair_sharded` on
    ``plan``."""
    _, (usim, utfc, um) = train_pair_sharded(kind, None, **kw)
    pin_plan(usim, plan)
    return usim, utfc, um


def typed_trainers(n=1500, seed=1, lr=1e-3):
    """tests/test_torch_typed_train.py's typed proxy NN on the 80:20
    Kob-Andersen mixture from one state and weights: JAX's unsharded
    engine, the port's engine on 4 CPU shards and its unsharded engine,
    all on the sharded plan."""
    pos, vel, lengths = fluid_arrays(n, 0.4, seed, kT=1.5)
    types = mixture_types(n, seed)
    js = jax_state(pos, vel, lengths, types=types)
    jsim = htf.Simulation(dt=0.005, integrator=htf.md.NVT(kT=1.5, tau=0.5),
                          seed=seed)
    jsim.set_state(js)
    jsim.add_force(htf.md.LennardJones(epsilon=KA_EPS, sigma=KA_SIG,
                                       r_cut=R_CUT))
    jm = JTypedNN(64, output_forces=False, proxy_degree=16, proxy_types=2)
    jm.pair_energy(jnp.ones(4), jnp.zeros(4), jnp.zeros(4))
    seed_jax_weights(jm, 0)
    from test_torch_typed_train import j_force_loss as j_typed_loss
    jm.compile(optimizer="sgd", loss=j_typed_loss, learning_rate=lr)
    jtfc = htf.tfcompute(jm)
    jtfc.attach(jsim, r_cut=R_CUT, nlist="cellwise", train=True)
    out = []
    for mesh in (cpu_mesh(S), None):
        sim = htt.Simulation(dt=0.005, integrator=htt.md.NVT(kT=1.5,
                                                             tau=0.5),
                             seed=seed, mesh=mesh,
                             device=None if mesh else "cpu")
        sim.set_state(state_from_numpy(jax_state_numpy(js), device="cpu"))
        sim.add_force(htt.md.LennardJones(epsilon=KA_EPS, sigma=KA_SIG,
                                          r_cut=R_CUT))
        tm = TTypedNN(64, output_forces=False, proxy_degree=16,
                      proxy_types=2)
        build_model(tm, R_CUT, "cpu")
        load_jax_variables(tm, jm.get_weights())
        tm.compile(optimizer="sgd", loss=force_loss, learning_rate=lr)
        tfc = htt.tfcompute(tm)
        tfc.attach(sim, r_cut=R_CUT, nlist="cellwise", train=True)
        out.append((sim, tfc, tm))
    (tsim, _, _), (usim, _, _) = out
    plan = tsim._ensure_layout().plan
    assert plan.grid[2] % S == 0
    pin_plan(usim, plan)
    jplan = jcw.CellwisePlan(grid=plan.grid, capacity=plan.capacity,
                             lengths=plan.lengths, r_cut=plan.r_cut)
    jsim._plan_from_current = lambda: jplan
    return (jsim, jtfc, jm), out[0], out[1]


def assert_resident(sim):
    slots, (st, aux) = sim._packed[1], sim._packed[2]
    assert isinstance(slots, SlabSlots) and isinstance(st, SlabState)
    for s, (dev, _, nzl) in enumerate(slots.slabs):
        assert st.shards[s].positions.shape[0] == (nzl + 1) * slots.layer
        assert aux["valid"][s].device == dev


def assert_close_runs(got, want, rtol, atol):
    """Losses at ``rtol``, trainable weights at ``rtol``, ``atol``."""
    (gtfc, gm), (wtfc, wm) = got, want
    assert len(gtfc.loss_history) == len(wtfc.loss_history) == 3
    np.testing.assert_allclose(gtfc.loss_history, wtfc.loss_history,
                               rtol=rtol)
    for a, b in zip(trainable(gm.get_weights()), trainable(wm.get_weights())):
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64), rtol=rtol,
                                   atol=atol)


# ----------------------------------------------------------------------
# parity
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["proxy", "pair", "lane", "typed"])
def test_resident_train_steps_match_jax_and_unsharded(kind):
    """Three SGD train steps on the resident shards (4 CPU shards): each
    branch against JAX's unsharded engine (rtol 2e-4) and the port's
    unsharded engine (rtol 1e-5) on the same plan; the state a
    ``SlabState`` on each shard's device through the run. ``'typed'``: the
    typed proxy on the 80:20 Kob-Andersen mixture."""
    if kind == "typed":
        (jsim, jtfc, jm), (tsim, ttfc, tm), (usim, utfc, um) = \
            typed_trainers()
        want = "proxy"
    else:
        (jsim, jtfc, jm), (tsim, ttfc, tm) = train_pair_sharded(
            kind, S, n=1500)
        plan = tsim._ensure_layout().plan
        usim, utfc, um = unsharded_twin(kind, plan, n=1500)
        want = kind
    before = tpc.proxy_bwd_moments.launches
    for sim in (jsim, tsim, usim):
        sim.run(3)
    assert_resident(tsim)
    assert branch(tsim) == branch(usim) == want
    assert tsim.train_steps == usim.train_steps == 3
    assert tpc.proxy_bwd_moments.launches == before
    assert_close_runs((ttfc, tm), (jtfc, jm), 2e-4, 1e-6)
    assert_close_runs((ttfc, tm), (utfc, um), 1e-5, 1e-7)


class JNNPair64(JNNPair):
    def setup(self):
        self.dense1 = htf.Dense(WIDTH, dtype=self.dtype)
        self.last = htf.Dense(1, dtype=self.dtype)


class TNNPair64(TNNPair):
    def setup(self):
        self.dense1 = htt.Dense(WIDTH, dtype=self.dtype)
        self.last = htt.Dense(1, dtype=self.dtype)


def f64_pair_trainers(n=1500, seed=1, lr=1e-3):
    """The ``'pair'`` branch in float64 (tests/test_torch_train_pair.py's
    NN pair potential with float64 layers): JAX's x64 engine, the port's
    on 4 CPU shards and its unsharded engine, on the sharded plan."""
    from hoomd_tf_tpu.md.state import init_state
    pos, vel, lengths = fluid_arrays(n, 0.4, seed, kT=1.5)
    js = init_state(pos.astype(np.float64), lengths,
                    velocities=vel.astype(np.float64), dtype=jnp.float64)
    jm = JNNPair64(64, output_forces=False, dtype=jnp.float64)
    jm.pair_energy(jnp.ones(4, jnp.float64))
    seed_jax_weights(jm, 0)
    jm.compile(optimizer="sgd", loss=j_force_loss, learning_rate=lr)
    jsim = htf.Simulation(dt=0.005, integrator=htf.md.NVT(kT=1.5, tau=0.5),
                          seed=seed)
    jsim.set_state(js)
    jsim.add_force(htf.md.LennardJones(r_cut=R_CUT))
    jtfc = htf.tfcompute(jm)
    jtfc.attach(jsim, r_cut=R_CUT, nlist="cellwise", train=True)
    out = []
    for mesh in (cpu_mesh(S), None):
        sim = htt.Simulation(dt=0.005, integrator=htt.md.NVT(kT=1.5,
                                                             tau=0.5),
                             seed=seed, mesh=mesh,
                             device=None if mesh else "cpu")
        sim.set_state(state_from_numpy(jax_state_numpy(js), device="cpu"))
        sim.add_force(htt.md.LennardJones(r_cut=R_CUT))
        tm = TNNPair64(64, output_forces=False, dtype=torch.float64)
        build_model(tm, R_CUT, "cpu")
        load_jax_variables(tm, jm.get_weights())
        tm.compile(optimizer="sgd", loss=t_force_loss, learning_rate=lr)
        tfc = htt.tfcompute(tm)
        tfc.attach(sim, r_cut=R_CUT, nlist="cellwise", train=True)
        out.append((sim, tfc, tm))
    plan = out[0][0]._ensure_layout().plan
    pin_plan(out[1][0], plan)
    jplan = jcw.CellwisePlan(grid=plan.grid, capacity=plan.capacity,
                             lengths=plan.lengths, r_cut=plan.r_cut)
    jsim._plan_from_current = lambda: jplan
    return (jsim, jtfc, jm), out[0], out[1]


def test_resident_train_float64_matches_jax_and_unsharded():
    """The ``'pair'`` branch in float64 on the resident shards: three SGD
    steps against JAX's x64 engine (losses rtol 1e-10, weights 1e-9) and
    the port's unsharded float64 engine (losses 1e-12, weights 1e-11)."""
    jax.config.update("jax_enable_x64", True)
    try:
        (jsim, jtfc, jm), (tsim, ttfc, tm), (usim, utfc, um) = \
            f64_pair_trainers()
        for sim in (jsim, tsim, usim):
            sim.run(3)
    finally:
        jax.config.update("jax_enable_x64", False)
    assert_resident(tsim)
    assert tsim._packed[2][0].shards[0].positions.dtype == torch.float64
    assert branch(tsim) == "pair"
    assert len(ttfc.loss_history) == len(jtfc.loss_history) == 3
    np.testing.assert_allclose(ttfc.loss_history, jtfc.loss_history,
                               rtol=1e-10)
    np.testing.assert_allclose(ttfc.loss_history, utfc.loss_history,
                               rtol=1e-12)
    wt, wj, wu = (trainable(m.get_weights()) for m in (tm, jm, um))
    assert all(w.dtype == np.float64 for w in wt)
    for a, b, c in zip(wt, wj, wu):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(a, c, rtol=1e-11, atol=1e-14)


# ----------------------------------------------------------------------
# residency
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["proxy", "pair", "lane"])
def test_training_holds_no_whole_slot_tensor(kind):
    """At the end of every training step of a resident run no live tensor
    made since the simulation was has all ``n_slots`` rows (the loss's
    joined rows are freed with the step; no output is saved)."""
    import gc
    gc.collect()
    old = {id(t) for t in gc.get_objects() if torch.is_tensor(t)}
    _, (sim, tfc, _) = train_pair_sharded(kind, S, n=1500)
    assert not tfc.save_output_period
    sim.run(2)
    n_slots = sim._layout.plan.n_slots
    step, seen = sim._step, []

    def spy(*args, **kwargs):
        out = step(*args, **kwargs)
        seen.append([tuple(t.shape) for t in gc.get_objects()
                     if torch.is_tensor(t) and id(t) not in old and
                     t.ndim and t.shape[0] == n_slots])
        return out
    sim._step = spy
    sim.run(3)
    assert_resident(sim)
    assert sim.train_steps == 5 and len(tfc.loss_history) == 5
    assert len(seen) == 3 and not any(seen), seen


# ----------------------------------------------------------------------
# two groups of shards (as on two devices)
# ----------------------------------------------------------------------
def resident_case(n=1500, seed=3, dtype=torch.float32):
    """A fluid packed resident on 4 CPU shards: ``(slots, state, aux)``."""
    from hoomd_tf_tpu_torch.md.state import init_state
    pos, vel, lengths = fluid_arrays(n, 0.4, seed, jitter=0.08)
    lo = -np.asarray(lengths, np.float64) / 2
    plan = tcw.plan_cellwise(n, lengths, R_CUT, positions=pos, lo=lo,
                             z_divisor=S)
    state = init_state(pos.astype(np.float64), lengths,
                       velocities=vel.astype(np.float64), dtype=dtype,
                       device="cpu")
    layout = SlotLayout(plan, n, lo, dtype=dtype, device="cpu",
                        box=state.box)
    slots = layout.resident(cpu_mesh(S))
    st, aux = slots.pack(state)
    return slots, st, aux


def proxy_case(dtype):
    """A fitted untyped Chebyshev proxy (K 8) of a smooth LJ in ``dtype``:
    ``(evaluator, coefficients)``."""
    from hoomd_tf_tpu_torch.ops.chebyshev import make_pair_proxy
    fit, ev = make_pair_proxy(8, (0.25 * R_CUT) ** 2, R_CUT ** 2,
                              dtype=dtype, device="cpu")
    return ev, fit(lambda r2: 4.0 * (r2 ** -6 - r2 ** -3))


@pytest.mark.parametrize("route,dtype", [
    ("proxy", torch.float32), ("contract", torch.float32),
    ("proxy", torch.float64), ("contract", torch.float64),
    ("list", torch.float64)])
def test_split_groups_match_one_group(monkeypatch, route, dtype):
    """``resident_train_forces`` with the 4 shards as two groups (each
    group's end shards exchanging their halo with the other group: the
    positions' halo copy, the reverse-halo add, out of place on the list
    route, the cotangent's halo rows) against one group: the weights'
    gradient of ``<ct, forces4>`` at 1e-6 of max|g| in float32 and 1e-12
    in float64, the forces at 1e-5 and 1e-12 of max|F|; the halo rows of
    every shard's forces zero. K2's group plain version, the lane
    contraction and the list route's plain versions (``bwd_impl=
    'list'``). The list route runs in float64 only: its pair function's
    gradient is a float32 sum over each group's joined list, whose order
    differs between one group and two (2.7e-6 of max|g| apart in float32,
    2.7e-15 in float64)."""
    slots, st, aux = resident_case(dtype=dtype)
    geoms = slots.geoms(st)
    if route == "proxy":
        apply, params = proxy_case(dtype)
        kw = {}
    else:
        params, apply = lj_params(dtype), t_lj_apply
        kw = dict(bwd_impl="list" if route == "list" else "auto")
    tol_f, tol_g = (1e-5, 1e-6) if dtype == torch.float32 else (1e-12,
                                                                1e-12)
    ct = [torch.as_tensor(np.random.RandomState(s).randn(
        p.shape[0], 4)).to(dtype) for s, p in enumerate(st.positions)]
    L = slots.layer
    out = []
    for parts in (1, 2):
        with split_groups(monkeypatch, parts):
            p = {k: v.detach().clone().requires_grad_()
                 for k, v in params.items()}
            fs = resident_train_forces(
                p, apply, st.positions, st.types, aux["valid"], slots.plan,
                slots.lo, slots.mesh, geoms, **kw)
            assert len(fs) == S
            for f in fs:
                assert not f[-L:].detach().any()
            tot = sum(torch.sum(f[:-L] * c[:-L]) for f, c in zip(fs, ct))
            grads = torch.autograd.grad(tot, list(p.values()))
        out.append((torch.cat([f[:-L] for f in fs]).detach(), grads))
    (f1, g1), (f2, g2) = out
    torch.testing.assert_close(f2, f1, rtol=0,
                               atol=tol_f * float(f1.abs().max()))
    scale = max(float(g.abs().max()) for g in g1)
    assert scale > 0
    for a, b in zip(g2, g1):
        assert a.dtype == dtype
        torch.testing.assert_close(a, b, rtol=0, atol=tol_g * scale)
    assert tpc.proxy_bwd_moments.launches == 0
    assert tcc.generic_reduce_bwd.launches == 0


def test_pair_train_forces_mesh_is_the_resident_form():
    """``pair_train_forces(mesh=)`` on a whole state equals the home rows
    of ``resident_train_forces`` on the same state packed resident, bit
    for bit, forces and the weights' gradient."""
    slots, st, aux = resident_case()
    params, apply = lj_params(torch.float32), t_lj_apply
    w = slots.whole
    whole = [w(t) for t in (st.positions, st.types, aux["valid"])]
    ct = torch.as_tensor(np.random.RandomState(0).randn(
        slots.plan.n_slots, 4).astype(np.float32))
    out = []
    for resident in (True, False):
        p = {k: v.detach().clone().requires_grad_()
             for k, v in params.items()}
        if resident:
            f = w(resident_train_forces(
                p, apply, st.positions, st.types, aux["valid"], slots.plan,
                slots.lo, slots.mesh, slots.geoms(st)))
        else:
            f = t_ptf(p, apply, *whole, slots.plan, slots.lo,
                      geometry=slots.geometry, mesh=slots.mesh)
        out.append((f.detach(), torch.autograd.grad(torch.sum(f * ct),
                                                    list(p.values()))))
    (fr, gr), (fw, gw) = out
    assert torch.equal(fr, fw)
    assert all(torch.equal(a, b) for a, b in zip(gr, gw))


# ----------------------------------------------------------------------
# run control
# ----------------------------------------------------------------------
def proxy_pair(optimizer="sgd", period=1, lr=1e-3):
    """Two port engines of the proxy branch on 4 CPU shards from one state
    and weights (``optimizer``), repack interval pinned to 3."""
    out = []
    for _ in range(2):
        _, (sim, tfc, m) = train_pair_sharded("proxy", S, n=1500, lr=lr)
        if optimizer != "sgd":
            m.compile(optimizer=optimizer, loss=force_loss,
                      learning_rate=lr)
            tfc.opt_state = None
        tfc.period = period
        sim._choose_repack_interval = lambda layout: 3
        out.append((sim, tfc, m))
    return out


def same_weights(a, b):
    return all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(a.get_weights(), b.get_weights()))


def test_rollback_restores_model_and_optimizer(monkeypatch):
    """A stale attempt of a resident Adam training run commits nothing:
    the weights and the optimizer's state are those of its start, and the
    next run ends bit for bit as a run that never failed."""
    (a, atfc, am), (b, btfc, bm) = proxy_pair("adam")
    a.run(2)
    b.run(2)
    start = a._state
    w0 = [np.asarray(x).copy() for x in am.get_weights()]
    o0 = {k: [t.clone() for t in v.values() if torch.is_tensor(t)]
          for k, v in atfc.opt_state.state.items()}
    real = SlabSlots.needs_rebuild
    monkeypatch.setattr(SlabSlots, "needs_rebuild",
                        lambda self, st, aux: real(self, st, aux) | True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert a._run_once(4, allow_retry=True) is False
    monkeypatch.setattr(SlabSlots, "needs_rebuild", real)
    assert a._state is start and a.train_steps == 6
    assert all(np.array_equal(np.asarray(x), y)
               for x, y in zip(am.get_weights(), w0))
    for k, v in atfc.opt_state.state.items():
        now = [t for t in v.values() if torch.is_tensor(t)]
        assert all(torch.equal(x, y) for x, y in zip(now, o0[k]))
    assert len(atfc.loss_history) == 2
    a._static_K_cap = None
    a.run(4)
    b.run(4)
    assert_resident(a)
    assert atfc.loss_history == btfc.loss_history
    assert same_weights(am, bm)
    assert torch.equal(a.state.positions, b.state.positions)


def test_short_list_reruns(monkeypatch):
    """The list route (``stencil='kernel'``, ``'pair'``) on the resident
    shards with a list too short: the run rolls back, re-runs with a
    larger list and ends bit for bit as a run with a long enough list."""
    sims = []
    for _ in range(2):
        _, (sim, tfc, m) = train_pair_sharded("pair", S, n=1500,
                                              stencil="kernel")
        sim._choose_repack_interval = lambda layout: 3
        sims.append((sim, tfc, m))
    (a, atfc, am), (b, btfc, bm) = sims
    a.run(1)
    b.run(1)
    a._lanes.budget = 10
    with pytest.warns(UserWarning, match="too short"):
        a.run(3)
    b.run(3)
    assert a.lane_reruns == 1 and b.lane_reruns == 0
    assert_resident(a)
    assert atfc.loss_history == btfc.loss_history
    assert same_weights(am, bm)


def test_period_two_trains_on_its_steps():
    """``period = 2`` on the resident shards trains on every second step
    only, as the unsharded engine does (losses and weights at rtol
    1e-5)."""
    _, (tsim, ttfc, tm) = train_pair_sharded("proxy", S, n=1500)
    usim, utfc, um = unsharded_twin("proxy", tsim._ensure_layout().plan,
                                    n=1500)
    for sim, tfc in ((tsim, ttfc), (usim, utfc)):
        tfc.period = 2
        sim._choose_repack_interval = lambda layout: 3
        sim.run(6)
    assert_resident(tsim)
    assert tsim.train_steps == usim.train_steps == 3
    assert_close_runs((ttfc, tm), (utfc, um), 1e-5, 1e-7)


def test_label_subset_matches_unsharded():
    """A second built-in force drives the dynamics, the labels come from
    the LJ alone (``set_reference_forces``): on the resident shards as on
    the unsharded engine (losses and weights at rtol 1e-5)."""
    _, (tsim, ttfc, tm) = train_pair_sharded("pair", S, n=1500)
    usim, utfc, um = unsharded_twin("pair", tsim._ensure_layout().plan,
                                    n=1500)
    for sim, tfc in ((tsim, ttfc), (usim, utfc)):
        lj = sim.forces[0]
        sim.add_force(htt.md.LennardJones(epsilon=0.3, sigma=1.1,
                                          r_cut=R_CUT))
        tfc.set_reference_forces(lj)
        sim._choose_repack_interval = lambda layout: 3
        sim.run(3)
    assert_resident(tsim)
    assert tsim._route(tsim._layout, *tsim._layout.pack(
        tsim.state)).label_subset is not None
    assert_close_runs((ttfc, tm), (utfc, um), 1e-5, 1e-7)


def test_serialize_resumes_resident_training():
    """A checkpoint of a resident training run (weights, Adam's state, the
    shards' slot order) resumed in a fresh engine continues bit for bit as
    the saved one does."""
    from hoomd_tf_tpu_torch.serialize import load_checkpoint, \
        save_checkpoint
    (a, atfc, am), (b, btfc, bm) = proxy_pair("adam")
    a.run(4)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ck")
        save_checkpoint(path, am, a, atfc)
        load_checkpoint(path, bm, b, btfc)
    assert isinstance(b._packed[1], SlabSlots)
    assert torch.equal(b._packed[1].whole(b._packed[2][1]["orig"]),
                       a._packed[1].whole(a._packed[2][1]["orig"]))
    n0 = len(atfc.loss_history)
    a.run(3)
    b.run(3)
    assert_resident(b)
    assert atfc.loss_history[n0:] == btfc.loss_history
    assert same_weights(am, bm)
    assert torch.equal(a.state.positions, b.state.positions)
