"""The particle-order state held by rows per mesh shard
(``md/state.py::RowState``) on virtual CPU shards whose devices are named
``"cpu"`` and ``"cpu:k"`` (``torch.device("cpu") != torch.device(
"cpu:1")``, so every path between two shards' devices runs): the packed
routes ``'cell'``, ``'pallas'``, ``'n2'``, ``'direct'`` and ``'auto'``
under NVT and NPT, packed training, reference example 02's mapped model
on ``'cell'`` and ``'n2'``, the capacity overflow's self-heal, the
state between runs on every route (``'cellwise'``'s run ends in the row
shards, ``SlabSlots.unpack``, and the next run starts from them), the
readers and writers of ``Simulation.state``, and the row counts the mesh
does not divide.

Tolerances: a sharded run equals the unsharded port's run exactly (the
same operations per row; the thermostat's and barostat's sums add the
shards' partial sums, which leaves ``exp(-xi dt / 2)`` and the box scale
equal over these runs); against the JAX package after one step,
positions atol 1e-6 and forces atol 1e-4 (tests/test_torch_packed.py's
bar), after three steps positions atol 1e-5 (tests/test_torch_mapped.py's);
mapped bead positions atol 1e-5; three SGD steps of packed training,
losses and weights at rtol 1e-3, atol 1e-6
(tests/test_torch_train_packed.py's bar). ``'cellwise'`` is held to the
unsharded port with ``stencil='kernel'`` (K1's plain version, which the
group of every shard equals bit for bit) exactly, and its rows to the
whole-state gather of the slot shards exactly.
"""

import dataclasses
import os
import tempfile
import warnings

import numpy as np
import pytest
import torch

import hoomd_tf_tpu as htf
from hoomd_tf_tpu.parallel import make_mesh as jmesh
import hoomd_tf_tpu_torch as htt
from hoomd_tf_tpu_torch.interop import (build_model, load_jax_variables,
                                        state_from_numpy)
from hoomd_tf_tpu_torch.md.slots import SlabSlots
from hoomd_tf_tpu_torch.md.state import RowState, SimState, shard_rows
from hoomd_tf_tpu_torch.parallel import ShardedSimulation, make_mesh

from test_torch_mapped import JMapped, TMapped, jax_mapping, torch_mapping
from test_torch_packed import JLJ, TLJ
from test_torch_parallel import TLJ as TLJPair
from test_torch_train_generic import build_jax, trainable
from torch_helpers import (fluid_arrays, jax_state, jax_state_numpy, np_,
                           seed_jax_weights)

POS_TOL = dict(rtol=0, atol=1e-6)
F_TOL = dict(rtol=0, atol=1e-4)
R_CUT = 3.0
ROW_FIELDS = ("positions", "velocities", "types", "masses", "forces",
              "virial")


def row_mesh(S):
    """``S`` shards on devices ``"cpu"``, ``"cpu:1"``, ..."""
    return make_mesh(S, devices=["cpu"] + [f"cpu:{k}" for k in range(1, S)])


def assert_rows(sim, st=None):
    """``st`` (default: the engine's state) is held by particle rows:
    shard ``s`` holds ``n s // S`` on of every row field, on its mesh
    device."""
    st = sim._state if st is None else st
    assert isinstance(st, RowState)
    S, n = sim.n_shards, st.n_particles
    assert st.rows == shard_rows(n, S)
    for s, (p, r) in enumerate(zip(st.shards, st.rows)):
        dev = torch.empty(0, device=sim.mesh.devices[s]).device
        for f in ROW_FIELDS:
            t = getattr(p, f)
            assert t.shape[0] == r.stop - r.start and t.device == dev, f
        assert p.noise_rows == (r, n)


def watch(sim):
    """Record the state after every step of ``sim``'s packed loop."""
    seen = []
    step = sim._packed_step

    def spy(*args, **kw):
        out = step(*args, **kw)
        seen.append(out[0])
        return out
    sim._packed_step = spy
    return seen


def same_state(a, b, fields=ROW_FIELDS):
    """Two simulations' states equal field for field, the box and the
    step too."""
    sa, sb = a.state, b.state
    for f in fields:
        assert torch.equal(getattr(sa, f), getattr(sb, f)), f
    assert torch.equal(sa.box, sb.box) and sa.step == sb.step


INTEG = dict(NVT=(htf.md.NVT, htt.md.NVT, dict(kT=1.0, tau=0.5)),
             NPT=(htf.md.NPT, htt.md.NPT,
                  dict(kT=1.0, tau=0.5, P=0.3, tauP=1.0)))


def packed_trio(nlist, S, integrator="NVT", n=600, seed=0):
    """The JAX package's simulation, the port's on an ``S``-shard row
    mesh and the port's unsharded one, from the same state,
    tests/test_torch_packed.py's LJ SimModel on ``nlist``."""
    pos, vel, lengths = fluid_arrays(n, 0.35, seed, kT=1.0)
    js = jax_state(pos, vel, lengths)
    jI, tI, kw = INTEG[integrator]
    jsim = htf.Simulation(dt=0.005, integrator=jI(**kw), seed=seed)
    jsim.set_state(js)
    htf.tfcompute(JLJ(64)).attach(jsim, r_cut=R_CUT, nlist=nlist)
    out = [jsim]
    for mesh in (row_mesh(S), None):
        tsim = htt.Simulation(dt=0.005, integrator=tI(**kw), seed=seed,
                              mesh=mesh, device=None if mesh else "cpu")
        tsim.set_state(state_from_numpy(jax_state_numpy(js), device="cpu"))
        htt.tfcompute(TLJ(64)).attach(tsim, r_cut=R_CUT, nlist=nlist)
        out.append(tsim)
    return out


@pytest.mark.parametrize("nlist,S,integrator", [
    ("cell", 2, "NVT"), ("pallas", 4, "NVT"), ("n2", 3, "NVT"),
    ("direct", 4, "NVT"), (None, 4, "NVT"), ("n2", 4, "NPT"),
    (None, 2, "NPT")])
def test_packed_rows_resident_and_equal(nlist, S, integrator):
    """Each packed route under NVT (NPT: the dense build, which reads the
    live box): every step of the run and the state after it held by rows
    per shard; one step against JAX (positions 1e-6, forces 1e-4), two
    more (positions 1e-5); each run equal to the unsharded port's run
    exactly, the NPT box too."""
    jsim, tsim, usim = packed_trio(nlist, S, integrator)
    box0 = usim.state.box.clone()
    seen = watch(tsim)
    for sim in (jsim, tsim, usim):
        sim.run(1)
    assert_rows(tsim)
    np.testing.assert_allclose(np_(tsim.state.positions),
                               np_(jsim.state.positions), **POS_TOL)
    np.testing.assert_allclose(np_(tsim.state.forces),
                               np_(jsim.state.forces), **F_TOL)
    assert np.abs(np_(tsim.state.forces)[:, :3]).max() > 1e-2
    same_state(tsim, usim)
    start = tsim._state
    for sim in (jsim, tsim, usim):
        sim.run(2)
    np.testing.assert_allclose(np_(tsim.state.positions),
                               np_(jsim.state.positions), rtol=0, atol=1e-5)
    same_state(tsim, usim)
    # the second run started from the first run's shards, which it left
    # as they were (fields are rebound, never written in place)
    assert len(seen) == 3 and start.step == 1
    for st in seen:
        assert_rows(tsim, st)
    if integrator == "NPT":
        assert not torch.equal(tsim.state.box, box0)
        np.testing.assert_allclose(np_(tsim.state.box),
                                   np.asarray(jsim.state.box), rtol=1e-5)


def test_packed_training_on_rows_matches_jax():
    """Online training of TrainableNN on ``'cell'`` on a 4-shard row mesh:
    every step held by rows; three SGD steps' losses and weights against
    the JAX package's unsharded engine, and equal to the port's unsharded
    run (losses, weights, positions)."""
    from test_torch_train_pair import JNN as JTrain, TNN as TTrain
    pos, vel, lengths = fluid_arrays(600, 0.4, 2, kT=1.5)
    js = jax_state(pos, vel, lengths)
    jm = seed_jax_weights(build_jax(JTrain(32, output_forces=False)), 1)
    jm.compile(optimizer="sgd", loss="mse", learning_rate=1e-3)
    jsim = htf.Simulation(dt=0.005, integrator=htf.md.NVT(kT=1.5, tau=0.5),
                          seed=2)
    jsim.set_state(js)
    jsim.add_force(htf.md.LennardJones(r_cut=2.5))
    jtfc = htf.tfcompute(jm)
    jtfc.attach(jsim, r_cut=2.5, nlist="cell", train=True)
    runs = []
    for mesh in (row_mesh(4), None):
        tm = TTrain(32, output_forces=False)
        build_model(tm, 2.5, "cpu")
        load_jax_variables(tm, jm.get_weights())
        tm.compile(optimizer="sgd", loss="mse", learning_rate=1e-3)
        tsim = htt.Simulation(dt=0.005, seed=2, mesh=mesh,
                              integrator=htt.md.NVT(kT=1.5, tau=0.5),
                              device=None if mesh else "cpu")
        tsim.set_state(state_from_numpy(jax_state_numpy(js), device="cpu"))
        tsim.add_force(htt.md.LennardJones(r_cut=2.5))
        ttfc = htt.tfcompute(tm)
        ttfc.attach(tsim, r_cut=2.5, nlist="cell", train=True)
        seen = watch(tsim) if mesh is not None else []
        tsim.run(3)
        for st in seen:
            assert_rows(tsim, st)
        assert tsim.train_steps == 3
        runs.append((ttfc.loss_history, trainable(tm.get_weights()), tsim))
    jsim.run(3)
    (l_s, w_s, s_sim), (l_u, w_u, u_sim) = runs
    assert_rows(s_sim)
    np.testing.assert_allclose(l_s, jtfc.loss_history, rtol=1e-3)
    for a, b in zip(w_s, trainable(jm.get_weights())):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-6)
    assert l_s == l_u
    assert all(np.array_equal(a, b) for a, b in zip(w_s, w_u))
    same_state(s_sim, u_sim)


@pytest.mark.parametrize("nlist,S", [("cell", 4), ("n2", 2)])
def test_mapped_model_on_rows_matches_jax(nlist, S):
    """Example 02's mapped model (512 atoms, 128 beads) on a row mesh: the
    mapping on the atom rows joined on the first device, each bead
    written into the shard that holds its row, every step held by rows;
    one step against JAX (positions 1e-5 by minimum image, forces 1e-4,
    zero bead forces), equal to the unsharded port's run exactly."""
    n = 512
    pos, vel, lengths = fluid_arrays(n, 0.4, 5, kT=1.0)
    js = jax_state(pos, vel, lengths)
    jsim = htf.Simulation(dt=0.005, integrator=htf.md.NVT(kT=1.0, tau=0.5),
                          seed=0)
    jsim.set_state(js)
    jtfc = htf.tfcompute(JMapped(96))
    jtfc.enable_mapped_nlist(jsim, jax_mapping(n))
    jtfc.attach(jsim, r_cut=R_CUT, nlist=nlist)
    sims = []
    for mesh in (row_mesh(S), None):
        tsim = htt.Simulation(dt=0.005, seed=0, mesh=mesh,
                              integrator=htt.md.NVT(kT=1.0, tau=0.5),
                              device=None if mesh else "cpu")
        tsim.set_state(state_from_numpy(jax_state_numpy(js), device="cpu"))
        ttfc = htt.tfcompute(TMapped(96))
        ttfc.enable_mapped_nlist(tsim, torch_mapping(n))
        ttfc.attach(tsim, r_cut=R_CUT, nlist=nlist)
        sims.append((tsim, ttfc))
    (tsim, ttfc), (usim, _) = sims
    seen = watch(tsim)
    for sim in (jsim, tsim, usim):
        sim.run(1)
    L = np.asarray(tsim._lengths)
    d = np_(tsim.state.positions) - np_(jsim.state.positions)
    np.testing.assert_allclose(d - np.round(d / L) * L, 0.0, rtol=0,
                               atol=1e-5)
    f = np_(tsim.state.forces)
    np.testing.assert_allclose(f, np_(jsim.state.forces), **F_TOL)
    assert np.abs(f[:n, :3]).max() > 0.1 and np.abs(f[n:]).max() == 0.0
    same_state(tsim, usim)
    for sim in (tsim, usim):
        sim.run(2)
    same_state(tsim, usim)
    for st in seen:
        assert_rows(tsim, st)
    # the bead rows straddle a shard boundary on 'cell' (640 rows on 4
    # shards of 160: the beads are rows 512 on, in the last shard only)
    assert_rows(tsim)


def test_logged_period_run_on_rows():
    """``run(4, log_period=2)`` of a ``period=2`` model beside a built-in
    LJ on ``'n2'`` on a 3-shard row mesh: the model's forces carried per
    shard between its evaluations, the built-in's added per shard; equal
    to the unsharded port's run exactly, its log records (the shards'
    partial sums added on the first device) at rtol 1e-5, and the carried
    forces tfcompute keeps equal too."""
    pos, vel, lengths = fluid_arrays(600, 0.35, 4, kT=1.0)
    sims = []
    for mesh in (row_mesh(3), None):
        sim = htt.Simulation(dt=0.005, seed=4, mesh=mesh,
                             integrator=htt.md.NVT(kT=1.0, tau=0.5),
                             device=None if mesh else "cpu")
        sim.init_state(pos, lengths, velocities=vel)
        sim.add_force(htt.md.LennardJones(0.5, 1.0, r_cut=2.5))
        htt.tfcompute(TLJ(64)).attach(sim, r_cut=R_CUT, nlist="n2",
                                      period=2)
        seen = watch(sim) if mesh is not None else []
        sim.run(5, log_period=2)
        for st in seen:
            assert_rows(sim, st)
        sims.append(sim)
    shd, ref = sims
    assert_rows(shd)
    same_state(shd, ref)
    assert np.array_equal(shd.log["step"], ref.log["step"])
    for k in ("kinetic_energy", "potential_energy", "temperature",
              "pressure"):
        np.testing.assert_allclose(shd.log[k], ref.log[k], rtol=1e-5)
    for a, b in zip(shd.tfc.model_forces(shd._state),
                    ref.tfc.model_forces(ref._state)):
        assert torch.equal(a, b)


def test_overflow_heals_on_rows():
    """An undersized ``CellList(capacity=8)`` on a 2-shard row mesh
    overflows, warns, rolls back to the rows it started from, re-plans
    with a larger floor and ends equal to the unsharded port's clean
    run."""
    pos, vel, lengths = fluid_arrays(600, 0.35, 6, kT=1.0)
    out = []
    for mesh, cfg in ((row_mesh(2), htt.CellList(capacity=8)),
                      (None, "cell")):
        sim = htt.Simulation(dt=0.005, seed=6, mesh=mesh,
                             device=None if mesh else "cpu")
        sim.init_state(pos, lengths, velocities=vel)
        htt.tfcompute(TLJ(48)).attach(sim, r_cut=R_CUT, nlist=cfg)
        out.append(sim)
    s_sim, u_sim = out
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert s_sim._run_packed(3, allow_retry=True) is False
    assert any("capacity 8 exceeded" in str(x.message) for x in w)
    start = s_sim._state
    assert_rows(s_sim)
    assert start.step == 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        s_sim.run(3)
    u_sim.run(3)
    assert s_sim._packed_build().plan[1] > 8
    assert start.step == 0
    assert_rows(s_sim)
    same_state(s_sim, u_sim)


# ----------------------------------------------------------------------
# the state between runs
# ----------------------------------------------------------------------
def cellwise_pair(S, n=1500, seed=3):
    """A fluid on ``'cellwise'`` in the port's sharded engine (an
    ``S``-shard row mesh, K1's group plain version) and its unsharded
    engine with ``stencil='kernel'`` (K1's plain version), at the same
    plan and repack interval 3."""
    pos, vel, lengths = fluid_arrays(n, 0.4, seed, jitter=0.08)
    out = []
    for mesh in (row_mesh(S), None):
        sim = htt.Simulation(dt=0.005, integrator=htt.md.NVT(kT=1.0,
                                                             tau=0.5),
                             seed=seed, mesh=mesh,
                             device=None if mesh else "cpu")
        sim.init_state(pos, lengths, velocities=vel)
        htt.tfcompute(TLJPair(48, virial=True)).attach(sim, r_cut=2.5,
                                                       nlist="cellwise")
        sim.stencil = "kernel"
        out.append(sim)
    shd, ref = out
    plan = shd._ensure_layout().plan
    ref._plan_from_current = lambda: plan
    shd._choose_repack_interval = ref._choose_repack_interval = \
        lambda layout: 3
    return shd, ref


def gathered_rows(slots, st, aux):
    """The particle-order state of a resident slot state by the whole-state
    gather (every slot shard's home rows joined in global slot order on
    the first device, then scattered by particle)."""
    w = slots.whole
    ws = SimState(positions=w(st.positions), velocities=w(st.velocities),
                  types=w(st.types), masses=w(st.masses), box=st.box,
                  forces=w(st.forces), virial=w(st.virial), step=st.step)
    return slots.layout.unpack(ws, {"orig": w(aux["orig"])})


@pytest.mark.parametrize("S", [2, 4])
def test_cellwise_ends_in_row_shards(S, monkeypatch):
    """A ``'cellwise'`` run ends in the row shards (``SlabSlots.unpack``
    on each row shard's device, equal to the whole-state gather of the
    slot shards exactly); the next run starts from the cached slot shards
    and, after a re-plan, packs from the row shards; no run joins the
    whole state (``RowState.whole`` is never called inside ``run()``);
    every read of ``sim.state`` equals the unsharded port's exactly."""
    shd, ref = cellwise_pair(S)
    shd.run(4)
    ref.run(4)
    assert_rows(shd)
    slots, (st, aux) = shd._packed[1], shd._packed[2]
    assert isinstance(slots, SlabSlots) and shd._packed[0] is shd._state
    want = gathered_rows(slots, st, aux)
    got = shd.state
    for f in ROW_FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert "dof" not in got.thermostat
    same_state(shd, ref)

    def no_join(self):
        raise AssertionError("a run joined the whole state")
    packs = []
    pack = SlabSlots.pack
    monkeypatch.setattr(SlabSlots, "pack",
                        lambda self, state, src=None: packs.append(
                            type(state)) or pack(self, state, src))
    whole = RowState.whole
    monkeypatch.setattr(RowState, "whole", no_join)
    shd.run(3)
    ref.run(3)
    assert packs == []
    shd.replan()
    ref.replan()
    plan = shd._ensure_layout().plan
    ref._plan_from_current = lambda: plan
    shd.run(3)
    ref.run(3)
    assert packs == [RowState]
    monkeypatch.setattr(RowState, "whole", whole)
    assert_rows(shd)
    same_state(shd, ref)


def test_state_writers_and_readers_route_through_rows():
    """After a run on a row mesh: ``thermalize_velocities``, swapping the
    integrator, a field set on a read ``sim.state``, ``set_state`` and a
    checkpoint act on the row shards as the unsharded port's act on its
    state, so the next runs stay equal exactly."""
    from hoomd_tf_tpu_torch.serialize import load_checkpoint, \
        save_checkpoint
    _, shd, ref = packed_trio("cell", 4)
    for sim in (shd, ref):
        sim.run(2)
        sim.thermalize_velocities(1.2)
        sim.integrator = htt.md.NVE()
        sim.integrator = htt.md.NVT(kT=1.2, tau=0.5)
        sim.state.positions = sim.state.positions * 1.0001
    assert_rows(shd)
    same_state(shd, ref)
    for sim in (shd, ref):
        sim.run(2)
    same_state(shd, ref)
    assert shd.thermo() == pytest.approx(ref.thermo(), rel=1e-6)
    ShardedSimulation._shard_state(shd)
    pos = ref.state.positions.clone()
    # a checkpoint of the row shards resumes as the saved run goes on
    other = htt.Simulation(dt=0.005, seed=0, mesh=row_mesh(4),
                           integrator=htt.md.NVT(kT=1.2, tau=0.5))
    other.set_state(dataclasses.replace(ref.state))
    htt.tfcompute(TLJ(64)).attach(other, r_cut=R_CUT, nlist="cell")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ck")
        save_checkpoint(path, shd.tfc.model, shd, shd.tfc)
        load_checkpoint(path, other.tfc.model, other, other.tfc)
    assert torch.equal(other.state.positions, pos)
    for sim in (shd, other, ref):
        sim.run(2)
    same_state(shd, other)
    same_state(shd, ref)
    assert_rows(other)


def test_uneven_rows_split_where_jax_refuses():
    """602 particles on a 4-shard mesh: the JAX package's packed route
    refuses the rows (``_apply_mesh``: not divisible by the mesh); the
    port splits them unevenly (150 or 151 rows a shard, ``n s // S`` on:
    tests/test_torch_parallel.py's 27 particles on 4 shards depend on
    that) and equals its unsharded run exactly (ROADMAP Queue 3's
    quirk)."""
    pos, vel, lengths = fluid_arrays(602, 0.35, 1, kT=1.0)
    jsim = htf.Simulation(dt=0.005, seed=0, mesh=jmesh(4))
    jsim.set_state(jax_state(pos, vel, lengths))
    htf.tfcompute(JLJ(64)).attach(jsim, r_cut=R_CUT, nlist="n2")
    with pytest.raises(ValueError, match="not divisible"):
        jsim.run(1)
    sims = []
    for mesh in (row_mesh(4), None):
        sim = htt.Simulation(dt=0.005, seed=0, mesh=mesh,
                             device=None if mesh else "cpu")
        sim.init_state(pos, lengths, velocities=vel)
        htt.tfcompute(TLJ(64)).attach(sim, r_cut=R_CUT, nlist="n2")
        sim.run(2)
        sims.append(sim)
    assert_rows(sims[0])
    assert [r.stop - r.start for r in sims[0]._state.rows] == \
        [150, 151, 150, 151]
    same_state(*sims)
