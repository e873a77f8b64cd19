"""The planes route, its training branch and mapped models under a mesh on
the slot state resident per z-slab shard (``Simulation(mesh=)`` on
``'cellwise'``), on virtual CPU shards (``make_mesh(S, devices=...)``,
the devices ``"cpu"`` and, for a partition into groups, ``"cpu:k"``):
every route keeps its state in :class:`SlabSlots`; each shard builds its
home cells' planes from its own rows and its neighbours' boundary layers
(``SlabSlots.planes``), the model runs once on every row joined on the
first device, its forces go back per shard (``SlabSlots.split``), and a
mapped model's beads are written per shard
(``SlabSlots.write_particles``).

Tolerances: the joined planes equal ``SlotLayout.planes`` of the whole
state bit for bit (the same operations on the same values), also at one
z-layer a shard (S = nz) and past a step, whose halo rows are stale. The
planes route's and the mapped route's steps equal the unsharded port's
bit for bit (the model sees the unsharded inputs; the thermostat's
shard-summed kinetic energy leaves ``exp(-xi dt / 2)`` equal). Against
the JAX package: three NVT steps of the planes route against JAX's
sharded engine, forces atol 1e-4, positions atol 1e-5
(tests/test_torch_parallel_train.py's bars); three float64 SGD steps of
the planes training branch against JAX's x64 engine, losses rtol 1e-10,
weights rtol 1e-9 (``sharded_planes_train_f64``'s), and against the
port's unsharded engine at rtol 1e-12; the mapped model's first step at
``test_mapped_model_on_mesh_matches_jax``'s bars (positions atol 1e-5,
forces rtol = atol = 1e-4). A migrating repack with beads present equals
``repack_src`` and ``SlotLayout.rebuild`` of the gathered state bit for
bit.
"""

import gc

import jax
import numpy as np
import pytest
import torch

import hoomd_tf_tpu as htf
from hoomd_tf_tpu.ops import cellwise as jcw
from hoomd_tf_tpu.parallel import make_mesh as jmesh
import hoomd_tf_tpu_torch as htt
from hoomd_tf_tpu_torch.interop import (build_model, load_jax_variables,
                                        state_from_numpy)
from hoomd_tf_tpu_torch.md.integrators import _wrap_positions
from hoomd_tf_tpu_torch.md.slots import SlabSlots
from hoomd_tf_tpu_torch.md.state import Shards, SlabState
from hoomd_tf_tpu_torch.ops import cellwise as tcw
from hoomd_tf_tpu_torch.parallel import make_mesh

from test_torch_mapped import TMapped, torch_mapping
from test_torch_parallel import TLJ, TLJModel, cpu_mesh
from test_torch_parallel_packed import mapped_pair, wrapped
from test_torch_parallel_resident import gathered
from test_torch_parallel_train import (JCoupled64, R_CUT, TCoupled64,
                                       TPlanesMean, train_pair_sharded)
from test_torch_train_generic import KINDS, build_jax, trainable
from torch_helpers import (fluid_arrays, force_loss, jax_state,
                           jax_state_numpy, nn_pair_class, np_,
                           seed_jax_weights)


def mesh_of(S, part="whole"):
    """``S`` virtual CPU shards: on one device (``'whole'``), or
    alternating between ``"cpu"`` and ``"cpu:1"`` (``'split'``: groups
    of non-adjacent shards, the halo exchanged between them)."""
    if part == "whole":
        return cpu_mesh(S)
    return make_mesh(S, devices=[torch.device("cpu" if s % 2 == 0 else
                                              "cpu:1") for s in range(S)])


def planes_pair(S, part="whole", n=1000, seed=3, period=1, alone=False):
    """``TPlanesMean`` (the probe rejects it: a cross-row reduction) on
    ``'cellwise'`` (NVT, evaluated every ``period`` steps) in the port on
    ``S`` shards and, unless ``alone``, unsharded, from one state on one
    plan (``nz % S == 0``), the repack interval pinned to 1 (a migrating
    repack every step)."""
    pos, vel, lengths = fluid_arrays(n, 0.4, seed, jitter=0.08)
    sims = []
    for mesh in (mesh_of(S, part), None)[:1 if alone else 2]:
        sim = htt.Simulation(dt=0.005, integrator=htt.md.NVT(kT=1.0,
                                                             tau=0.5),
                             seed=seed, mesh=mesh,
                             device=None if mesh else "cpu")
        sim.init_state(pos, lengths, velocities=vel)
        htt.tfcompute(TPlanesMean(48)).attach(sim, r_cut=R_CUT,
                                             nlist="cellwise", period=period)
        sim._choose_repack_interval = lambda layout: 1
        sims.append(sim)
    if alone:
        return sims[0]
    shd, ref = sims
    plan = shd._ensure_layout().plan
    ref._plan_from_current = lambda: plan
    return shd, ref


# ----------------------------------------------------------------------
# every route resident
# ----------------------------------------------------------------------
def route_sim(route, S=2):
    """A 1000-particle fluid on ``S`` shards with the model of ``route``
    attached on ``'cellwise'`` (training routes: against a built-in LJ,
    SGD): ``(sim, branch)``, ``branch`` the trainer's expected one."""
    pos, vel, lengths = fluid_arrays(1000, 0.4, 2, kT=1.5)
    sim = htt.Simulation(dt=0.005, integrator=htt.md.NVT(kT=1.5, tau=0.5),
                         seed=2, mesh=cpu_mesh(S))
    sim.init_state(pos, lengths, velocities=vel)
    kind = route[len("train-"):] if route.startswith("train-") else None
    if kind is None:
        model = {"pair": lambda: TLJ(48), "lane": lambda: TLJModel(48),
                 "planes": lambda: TPlanesMean(48),
                 "mapped": lambda: TMapped(96)}[route]()
        tfc = htt.tfcompute(model)
        if route == "mapped":
            tfc.enable_mapped_nlist(sim, torch_mapping(1000))
        tfc.attach(sim, r_cut=R_CUT, nlist="cellwise")
        return sim, None
    sim.add_force(htt.md.LennardJones(r_cut=R_CUT))
    if kind == "proxy":
        model, loss = nn_pair_class()(64, output_forces=False,
                                      proxy_degree=16), force_loss
    else:
        _, make, _, loss, _ = KINDS[kind]
        model = make()
    build_model(model, R_CUT, "cpu")
    model.compile(optimizer="sgd", loss=loss, learning_rate=1e-3)
    htt.tfcompute(model).attach(sim, r_cut=R_CUT, nlist="cellwise",
                                train=True)
    return sim, kind


@pytest.mark.parametrize("route", ["pair", "lane", "planes", "mapped",
                                   "train-proxy", "train-pair",
                                   "train-lane", "train-planes"])
def test_every_cellwise_route_is_resident(route):
    """Under a mesh ``_slots`` is the layout's ``SlabSlots`` on every
    route, a run keeps a ``SlabState``, and ``_route`` on the resident
    state picks the route's model form or trainer branch (the probe
    validating on a whole pack of its own)."""
    sim, kind = route_sim(route)
    layout = sim._ensure_layout()
    slots = sim._slots(layout)
    assert isinstance(slots, SlabSlots)
    assert slots is layout.resident(sim.mesh, sim.shard_axis)
    sim.run(1)
    assert sim._packed[1] is slots
    assert isinstance(sim._packed[2][0], SlabState)
    st, aux = slots.pack(sim.state)
    r = sim._route(layout, st, aux)
    if kind is not None:
        assert r.trainer.kind == kind
        assert len(sim.tfc.loss_history) == 1
    else:
        assert r.planes == (route in ("planes", "mapped"))
        assert (r.model_fn is not None) == (route in ("pair", "lane"))
    assert np.all(np.isfinite(np_(sim.state.positions)))


# ----------------------------------------------------------------------
# the planes from the resident shards
# ----------------------------------------------------------------------
@pytest.mark.parametrize("S,part", [(2, "whole"), (3, "whole"),
                                    (4, "whole"), (4, "split")])
def test_joined_planes_equal_whole_planes(S, part):
    """The planes each shard builds from the resident buffers, joined on
    the first device, equal ``SlotLayout.planes`` of the gathered state
    bit for bit: at the pack, and after a step (the halo rows then hold
    the last exchange's positions, and are not read). S = 4 on 1000
    particles is one z-layer a shard (S = nz), the previous layer of
    shard 0 the last shard's. ``split`` inverts ``whole``; ``slot_rows``
    numbers each shard's home rows in global slot order."""
    shd = planes_pair(S, part, alone=True)
    layout = shd._ensure_layout()
    slots = shd._slots(layout)
    assert layout.plan.grid[2] % S == 0
    if S == 4:
        assert layout.plan.grid[2] == S
    st, aux = slots.pack(shd.state)
    for _ in range(2):
        ws, waux = gathered(slots, st, aux)
        want = layout.planes(ws, waux)
        got = slots.planes(st, aux)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        shd.run(1)
        st, aux = shd._packed[2]
    f = torch.randn(layout.plan.n_slots, 4)
    parts = slots.split(f)
    assert torch.equal(slots.whole(parts), f)
    assert all(not p[-slots.layer:].any() for p in parts)
    assert torch.equal(slots.whole(slots.slot_rows),
                       torch.arange(layout.plan.n_slots))


# ----------------------------------------------------------------------
# the planes route's steps
# ----------------------------------------------------------------------
@pytest.mark.parametrize("S,part,period", [(2, "split", 1),
                                           (4, "whole", 2)])
def test_planes_route_steps_equal_unsharded(S, part, period):
    """Three NVT steps of the planes route on the resident shards (a
    migrating repack every step) equal the unsharded port's bit for bit
    in positions, velocities and forces, the state resident after each
    step; with ``period=2`` the model's forces carried per shard between
    evaluations."""
    shd, ref = planes_pair(S, part, period=period)
    for _ in range(3):
        shd.run(1)
        ref.run(1)
        assert isinstance(shd._packed[2][0], SlabState)
        for f in ("positions", "velocities", "forces"):
            assert torch.equal(getattr(shd.state, f), getattr(ref.state, f))
    assert shd.repacks >= 3


def test_planes_route_matches_jax_sharded_engine():
    """Three NVT steps of the planes route (a coupled SimModel, the probe
    rejects it) on 4 resident shards against the JAX package's sharded
    engine on 4 virtual devices at the same plan: forces atol 1e-4,
    positions atol 1e-5."""
    n = 1000
    pos, vel, lengths = fluid_arrays(n, 0.4, 1, kT=1.0)
    js = jax_state(pos, vel, lengths)
    jm = seed_jax_weights(build_jax(JCoupled64(64)), 0)
    jsim = htf.Simulation(dt=0.005, integrator=htf.md.NVT(kT=1.0, tau=0.5),
                          seed=1, mesh=jmesh(4))
    jsim.set_state(js)
    htf.tfcompute(jm).attach(jsim, r_cut=R_CUT, nlist="cellwise")
    tm = TCoupled64(64)
    build_model(tm, R_CUT, "cpu")
    load_jax_variables(tm, jm.get_weights())
    tsim = htt.Simulation(dt=0.005, integrator=htt.md.NVT(kT=1.0, tau=0.5),
                          seed=1, mesh=cpu_mesh(4))
    tsim.set_state(state_from_numpy(jax_state_numpy(js), device="cpu"))
    htt.tfcompute(tm).attach(tsim, r_cut=R_CUT, nlist="cellwise")
    tp = tsim._ensure_layout().plan
    jsim._plan_from_current = lambda: jcw.CellwisePlan(
        grid=tp.grid, capacity=tp.capacity, lengths=tp.lengths,
        r_cut=tp.r_cut)
    jsim.run(3)
    tsim.run(3)
    assert jsim._layout.plan.grid == tp.grid and tp.grid[2] % 4 == 0
    assert tsim._route(tsim._layout, *tsim._packed[2]).planes
    assert isinstance(tsim._packed[2][0], SlabState)
    np.testing.assert_allclose(np_(tsim.state.forces),
                               np.asarray(jsim.state.forces), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(
        wrapped(np_(tsim.state.positions), np.asarray(jsim.state.positions),
                np.asarray(lengths)), 0.0, rtol=0, atol=1e-5)


def test_planes_training_f64_matches_jax_and_unsharded():
    """Three float64 SGD steps of the planes training branch on 3
    resident shards of one z-layer each (S = nz) against JAX's float64
    engine (losses rtol 1e-10, weights rtol 1e-9) and the port's
    unsharded engine on the same plan (losses and weights rtol 1e-12)."""
    jax.config.update("jax_enable_x64", True)
    try:
        (jsim, jtfc, jm), (tsim, ttfc, tm) = train_pair_sharded(
            "planes", 3, n=500, f64=True)
        _, (usim, utfc, um) = train_pair_sharded("planes", None, n=500,
                                                 f64=True)
        plan = tsim._ensure_layout().plan
        assert plan.grid[2] == 3
        usim._plan_from_current = lambda: plan
        usim.replan()
        for sim in (jsim, tsim, usim):
            sim.run(3)
    finally:
        jax.config.update("jax_enable_x64", False)
    st, aux = tsim._packed[2]
    assert isinstance(st, SlabState)
    assert tsim._route(tsim._layout, st, aux).trainer.kind == "planes"
    assert usim._layout.plan == plan
    assert len(ttfc.loss_history) == len(jtfc.loss_history) == 3
    np.testing.assert_allclose(ttfc.loss_history, jtfc.loss_history,
                               rtol=1e-10)
    np.testing.assert_allclose(ttfc.loss_history, utfc.loss_history,
                               rtol=1e-12)
    for a, b, c in zip(*(trainable(m.get_weights()) for m in (tm, jm, um))):
        assert a.dtype == np.float64
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(a, c, rtol=1e-12, atol=1e-15)


# ----------------------------------------------------------------------
# mapped models
# ----------------------------------------------------------------------
def test_mapped_model_matches_jax_and_unsharded():
    """Reference example 02's mapped model on ``'cellwise'`` on 4 resident
    shards (one z-layer each): the first step against JAX (positions, the
    beads' too, atol 1e-5; forces rtol = atol = 1e-4; the beads' forces
    zero; the beads' RDF), three steps equal to the unsharded port's bit
    for bit, the beads at the mapping of the atoms."""
    (jsim, jtfc), (tsim, ttfc), usim = mapped_pair("cellwise", 4)
    n = 1000
    for sim in (jsim, tsim, usim):
        sim.run(1)
    assert isinstance(tsim._packed[2][0], SlabState)
    assert tsim._layout.plan.grid[2] == 4
    np.testing.assert_allclose(
        wrapped(np_(tsim.state.positions), np_(jsim.state.positions),
                np.asarray(tsim._lengths)), 0.0, rtol=0, atol=1e-5)
    f = np_(tsim.state.forces)
    np.testing.assert_allclose(f, np_(jsim.state.forces), rtol=1e-4,
                               atol=1e-4)
    assert np.abs(f[:n, :3]).max() > 0.1 and np.abs(f[n:]).max() == 0.0
    np.testing.assert_allclose(np_(ttfc.model.rdf.result()),
                               np_(jtfc.model.rdf.result()), rtol=1e-4,
                               atol=1e-6)
    for sim in (tsim, usim):
        sim.run(2)
    for k in ("positions", "velocities", "forces"):
        assert torch.equal(getattr(tsim.state, k), getattr(usim.state, k))
    beads = ttfc.bead_positions(tsim.state.positions4[:n], tsim.state.box)
    assert torch.equal(tsim.state.positions[n:], beads)


def test_mapped_repack_moves_beads_across_shards():
    """Every real row of a mapped run's resident state moved 0.45 of a
    cell edge up in z, the beads written from the atoms per shard
    (``_map_slots``), then one migrating repack: beads change shard, and
    the repack equals ``repack_src`` and ``SlotLayout.rebuild`` of the
    gathered state bit for bit; the bead rows stay the mapping of the atom
    rows; a bead row's forces are zero after a step."""
    sim, _ = route_sim("mapped", S=2)
    sim.run(1)
    layout = sim._layout
    slots, (st, aux) = sim._packed[1], sim._packed[2]
    n_atoms, n = 1000, slots.n
    st = st.copy()
    edge = float(layout.plan.lengths[2]) / layout.plan.grid[2]
    for p, v in zip(st.shards, aux["valid"]):
        up = torch.zeros_like(p.positions)
        up[:, 2] = 0.45 * edge
        p.positions = torch.where(v[:, None] > 0, _wrap_positions(
            p.positions + up, p.box), p.positions)
    route = sim._route(layout, st, aux)
    st = sim._map_slots(st, aux, slots, route)

    def bead_shards(a):
        return [set(np_(o[(o >= n_atoms) & (o < n)]).tolist())
                for o in a["orig"]]
    before = bead_shards(aux)
    ws, waux = gathered(slots, st, aux)
    new, naux = slots.rebuild(st, aux)
    after = bead_shards(naux)
    assert before[0] - after[0] and before[1] - after[1]
    assert not bool(naux["overflow"])
    src, ovf = tcw.repack_src(ws.positions, waux["valid"], layout.lo,
                              layout.plan, geometry=layout.geometry)
    assert not bool(ovf)
    n_slots = layout.plan.n_slots
    want = torch.where(src < n_slots, waux["orig"][src.clamp_max(
        n_slots - 1).long()], n).to(torch.int32)
    assert torch.equal(slots.whole(naux["orig"]), want)
    wnew, _ = layout.rebuild(ws, waux)
    for f in ("positions", "velocities", "types", "masses", "forces"):
        assert torch.equal(slots.whole(getattr(new, f)), getattr(wnew, f))
    pos4 = slots.to_particles([p.positions4 for p in new.shards], naux)
    beads = sim.tfc.bead_positions(pos4[:n_atoms], new.box)
    assert torch.equal(pos4[n_atoms:, :3], beads)
    sim.run(1)
    assert np.abs(np_(sim.state.forces)[n_atoms:]).max() == 0.0


# ----------------------------------------------------------------------
# residency
# ----------------------------------------------------------------------
@pytest.mark.parametrize("route", ["planes", "mapped", "train-planes"])
def test_no_whole_slot_tensor_after_a_step(route):
    """After every step of a resident run of the planes route, a mapped
    model and the planes training branch no live tensor made since the
    simulation was has all ``n_slots`` rows: the model's joined inputs
    and outputs are transient."""
    gc.collect()
    old = [t for t in gc.get_objects() if torch.is_tensor(t)]
    ids = {id(t) for t in old}
    sim, _ = route_sim(route, S=2)
    sim.run(1)
    n_slots = sim._layout.plan.n_slots
    step, seen = sim._step, []

    def spy(*args, **kwargs):
        out = step(*args, **kwargs)
        seen.append([tuple(t.shape) for t in gc.get_objects()
                     if torch.is_tensor(t) and id(t) not in ids and
                     t.ndim and t.shape[0] == n_slots])
        return out
    sim._step = spy
    sim.run(3)
    assert isinstance(sim._packed[2][0], SlabState)
    assert len(seen) == 3 and not any(seen), seen
    assert all(isinstance(v, Shards) for k, v in sim._packed[2][1].items()
               if k in ("valid", "orig", "ref"))
