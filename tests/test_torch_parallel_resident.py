"""The slot state resident per z-slab shard (``Simulation(mesh=)`` on
``'cellwise'`` without training, a mapped model or the planes route) on
virtual CPU shards (``make_mesh(S, devices=[cpu] * S)``): the migrating
repack, the per-shard integrators with their shard-summed thermostat and
barostat, logging, ``period`` and the buffers' residency.

Tolerances: the migrating repack equals ``repack_src`` and
``SlotLayout.rebuild`` on the gathered state bit for bit (the same sort
keys in the same row order, the same gathers). One evaluation on the
resident shards equals the unsharded port's at rtol = atol = 1e-5
(tests/test_torch_parallel.py's bar: the boundary layer's back sums
added in another order). Eight NVT steps, the repack interval pinned to
3, against JAX's sharded engine on 8 virtual devices and against the
unsharded port at atol 5e-4 in positions (tests/test_parallel.py's
bar: other summation orders, chaos-amplified over the steps). The other
integrators and options against the unsharded port: positions 5e-4, log
records rtol 1e-4, forces rtol = atol = 1e-3 (the bars of
tests/test_torch_parallel.py's Langevin, logging and period tests), the
NPT volume rtol 1e-5 (tests/test_torch_parallel_train.py's).
"""

import numpy as np
import pytest
import torch

import hoomd_tf_tpu as htf
import zoo
import hoomd_tf_tpu_torch as htt
from hoomd_tf_tpu_torch.md.integrators import _wrap_positions
from hoomd_tf_tpu_torch.md.slots import SlabSlots, SlotLayout
from hoomd_tf_tpu_torch.md.state import Shards, SimState, SlabState
from hoomd_tf_tpu_torch.ops import cellwise as tcw
from hoomd_tf_tpu_torch.parallel import ShardedSimulation, make_mesh

from test_torch_parallel import TLJ, TLJModel, min_image_diff
from torch_helpers import fluid_arrays, np_, torch_state

CPU = torch.device("cpu")


def cpu_mesh(S):
    return make_mesh(S, devices=[CPU] * S)


# ----------------------------------------------------------------------
# the migrating repack
# ----------------------------------------------------------------------
def resident_case(S, seed=3, carried=True):
    """A fluid (2000 particles, 4096 on 8 shards) on a plan with ``nz % S
    == 0``, packed whole and resident on ``S`` CPU shards, with random
    carried model forces and virial: ``(layout, slots, state, aux)``."""
    n = 4096 if S == 8 else 2000
    pos, vel, lengths = fluid_arrays(n, 0.4, seed, jitter=0.08)
    lo = -np.asarray(lengths, np.float64) / 2
    plan = tcw.plan_cellwise(n, lengths, 2.5, positions=pos, lo=lo,
                             z_divisor=S)
    state = torch_state(pos, vel, lengths, types=np.arange(n) % 3)
    rng = np.random.RandomState(seed)
    state.forces = torch.as_tensor(rng.randn(n, 4).astype(np.float32))
    state.virial = torch.as_tensor(rng.randn(n, 3, 3).astype(np.float32))
    layout = SlotLayout(plan, n, lo, device="cpu", box=state.box)
    slots = layout.resident(cpu_mesh(S))
    st, aux = slots.pack(state)
    if carried:
        aux["mf"] = slots.to_slots(torch.as_tensor(
            rng.randn(n, 4).astype(np.float32)), aux)
        aux["mw"] = slots.to_slots(torch.as_tensor(
            rng.randn(n, 3, 3).astype(np.float32)), aux)
    return layout, slots, st, aux


def move(slots, st, aux, shift):
    """Every shard's positions moved by ``shift(s, p, valid)`` (added,
    wrapped into the box)."""
    for s, (p, v) in enumerate(zip(st.shards, aux["valid"])):
        p.positions = _wrap_positions(p.positions + shift(s, p, v), p.box)


def gathered(slots, st, aux):
    """The whole slot state (global slot order) of a resident one."""
    w = slots.whole
    ws = SimState(positions=w(st.positions), velocities=w(st.velocities),
                  types=w(st.types), masses=w(st.masses), box=st.box,
                  forces=w(st.forces), virial=w(st.virial), step=st.step,
                  noise_rows=None)
    waux = {"valid": w(aux["valid"]), "orig": w(aux["orig"]),
            "overflow": torch.zeros((), dtype=torch.bool),
            "occ_max": torch.zeros((), dtype=torch.int32),
            "vmax": torch.zeros(())}
    for k in ("mf", "mw"):
        if aux.get(k) is not None:
            waux[k] = w(aux[k])
    return ws, waux


def crossing_shift(slots, edge):
    """Moves that cross every slab boundary both ways, the wrap from the
    last slab to shard 0 included: the even rows of each shard's first
    home layer step down 0.6 of a cell edge in z (shard 0's into the last
    shard), the other rows of its last home layer step up, the rest
    jitter."""
    L = slots.layer

    def shift(s, p, v):
        H = slots.home(s)
        rows = torch.arange(p.positions.shape[0])
        layer_of = rows // L
        nzl = slots.slabs[s][2]
        g = torch.Generator().manual_seed(s)
        d = 0.2 * edge * (torch.rand(p.positions.shape, generator=g) - 0.5)
        down = (layer_of == 0) & (rows % 2 == 0)
        d[:, 2] += torch.where(down, -0.6 * edge,
                               torch.where(layer_of == nzl - 1,
                                           0.6 * edge, 0.0))
        d[H:] = 0
        return d
    return shift


@pytest.mark.parametrize("S", [2, 4, 8])
def test_migrating_repack_equals_repack_src(S):
    """Particles cross every slab boundary, both ways and through the wrap
    from the last slab to shard 0: one repack per shard equals
    ``repack_src`` on the gathered state (``orig``, ``valid``) and
    ``SlotLayout.rebuild`` of it in every column (the carried model
    forces and virial too), bit for bit; each shard's halo layer holds the
    next shard's new first layer; no flag is set."""
    layout, slots, st, aux = resident_case(S)
    edge = float(np.min(np.asarray(layout.plan.lengths) /
                        np.asarray(layout.plan.grid)))
    move(slots, st, aux, crossing_shift(slots, edge))
    ws, waux = gathered(slots, st, aux)
    # some particles changed shard, across every boundary
    n_slots = layout.plan.n_slots
    src, ovf = tcw.repack_src(ws.positions, waux["valid"], layout.lo,
                              layout.plan, geometry=layout.geometry)
    assert not bool(ovf)
    nzl_rows = [slots.home(s) for s in range(S)]
    bounds = np.cumsum([0] + nzl_rows)
    src_np = np_(src)
    moved = [(src_np[a:b] < n_slots) & ((src_np[a:b] < a) |
                                         (src_np[a:b] >= b))
             for a, b in zip(bounds[:-1], bounds[1:])]
    assert all(m.any() for m in moved)
    new, naux = slots.rebuild(st, aux)
    assert not bool(naux["overflow"])
    worig = torch.where(src < n_slots, waux["orig"][src.clamp_max(
        n_slots - 1).long()], layout.n)
    assert torch.equal(slots.whole(naux["orig"]), worig.to(torch.int32))
    assert torch.equal(slots.whole(naux["valid"]),
                       (src < n_slots).to(torch.float32))
    wnew, wnaux = layout.rebuild(ws, waux)
    for f in ("positions", "velocities", "types", "masses", "forces",
              "virial"):
        assert torch.equal(slots.whole(getattr(new, f)),
                           getattr(wnew, f)), f
    for k in ("orig", "valid", "mf", "mw"):
        assert torch.equal(slots.whole(naux[k]), wnaux[k]), k
    assert int(naux["occ_max"]) == int(wnaux["occ_max"])
    assert float(naux["vmax"]) == float(wnaux["vmax"])
    # the halo layers: the next shard's first layer of positions, types
    # and valid; inert otherwise
    L = slots.layer
    for s, (p, v) in enumerate(zip(new.shards, naux["valid"])):
        q, w = new.shards[(s + 1) % S], naux["valid"][(s + 1) % S]
        assert torch.equal(p.positions[-L:], q.positions[:L])
        assert torch.equal(p.types[-L:], q.types[:L])
        assert torch.equal(v[-L:], w[:L])
        assert not p.velocities[-L:].any() and not p.forces[-L:].any()
        assert bool((naux["orig"][s][-L:] == layout.n).all())


def window_takes(slots, z_from, z_to):
    """Does some shard's repack window hold layer ``z_from`` while layer
    ``z_to`` is one of its home layers? (A shard's window: the layer below
    its slab, its slab, the layer above it, z wrapping.)"""
    nz = slots.plan.grid[2]
    for _, z0, nzl in slots.slabs:
        window = {(z0 - 1) % nz, (z0 + nzl) % nz} | set(range(z0, z0 + nzl))
        if z0 <= z_to < z0 + nzl and z_from in window:
            return True
    return False


@pytest.mark.parametrize("S", [2, 4])
def test_particle_past_its_window_sets_overflow(S):
    """A particle of shard 0's middle home layer moved two cell layers up
    in z, where no shard's window takes it in, sets the overflow bit;
    moved one layer it does not."""
    layout, slots, _, aux = resident_case(S, carried=False)
    nz = layout.plan.grid[2]
    edge = float(layout.plan.lengths[2]) / nz
    L = slots.layer
    z = slots.slabs[0][2] // 2
    row = z * L + int(torch.nonzero(aux["valid"][0][z * L:(z + 1) * L])[0])
    for layers in (1, 2):
        assert window_takes(slots, z, (z + layers) % nz) == (layers == 1)
        _, _, st, aux = resident_case(S, carried=False)

        def shift(s, p, v):
            d = torch.zeros_like(p.positions)
            if s == 0:
                d[row, 2] = layers * edge
            return d
        move(slots, st, aux, shift)
        _, naux = slots.rebuild(st, aux)
        assert bool(naux["overflow"]) == (layers == 2), layers


# ----------------------------------------------------------------------
# the engine: against JAX's sharded engine and the unsharded port
# ----------------------------------------------------------------------
def test_nvt_matches_jax_sharded_engine():
    """8 NVT steps (repack interval pinned to 3: two mid-run repacks) of
    the port's resident shards (8 CPU shards, one z-layer each) against
    the JAX package's sharded engine on 8 virtual devices, at the same
    plan (atol 5e-4)."""
    from hoomd_tf_tpu.parallel import make_mesh as jmesh
    n = 4096
    pos, vel, lengths = fluid_arrays(n, 0.4, 0, jitter=0.08)
    jsim = htf.Simulation(dt=0.005, integrator=htf.md.NVT(kT=1.0, tau=0.5),
                          seed=0, mesh=jmesh(8))
    jsim.init_state(pos, lengths, velocities=vel)
    htf.tfcompute(zoo.PairLJ(48)).attach(jsim, r_cut=2.5, nlist="cellwise")
    tsim = htt.Simulation(dt=0.005, integrator=htt.md.NVT(kT=1.0, tau=0.5),
                          seed=0, mesh=cpu_mesh(8))
    tsim.init_state(pos, lengths, velocities=vel)
    htt.tfcompute(TLJ(48)).attach(tsim, r_cut=2.5, nlist="cellwise")
    jp, tp = jsim._ensure_layout().plan, tsim._ensure_layout().plan
    assert (tp.grid, tp.capacity) == (jp.grid, jp.capacity)
    assert tp.grid[2] == 8
    jsim._choose_repack_interval = tsim._choose_repack_interval = \
        lambda layout: 3
    jsim.run(8)
    tsim.run(8)
    assert isinstance(tsim._packed[2][0], SlabState)
    d = min_image_diff(tsim.state.positions, jsim.state.positions,
                       tsim._lengths)
    np.testing.assert_allclose(d, np.zeros_like(d), atol=5e-4)


def resident_and_unsharded(integrator, n=1500, S=4, seed=3, period=1,
                           builtin=False, model=TLJ, stencil=None,
                           kT=1.0):
    """The same fluid in the port's sharded engine (S CPU shards) and its
    unsharded engine, at the same plan and repack interval 3."""
    pos, vel, lengths = fluid_arrays(n, 0.4, seed, jitter=0.08, kT=kT)
    out = []
    for mesh in (cpu_mesh(S), None):
        sim = htt.Simulation(dt=0.005, integrator=integrator(), seed=seed,
                             mesh=mesh, device=None if mesh else "cpu")
        sim.init_state(pos, lengths, velocities=vel)
        if builtin:
            sim.add_force(htt.md.LennardJones(epsilon=0.5, sigma=1.0,
                                              r_cut=2.5))
        if model is not None:
            htt.tfcompute(model(48)).attach(sim, r_cut=2.5,
                                            nlist="cellwise", period=period)
        if stencil:
            sim.stencil = stencil
        out.append(sim)
    shd, ref = out
    plan = shd._ensure_layout().plan
    ref._plan_from_current = lambda: plan
    if not getattr(integrator(), "changes_box", False):
        shd._choose_repack_interval = ref._choose_repack_interval = \
            lambda layout: 3
    return shd, ref


def test_nvt_and_one_evaluation_match_unsharded_port():
    """8 NVT steps of the resident shards against the unsharded port at
    the same plan (atol 5e-4), the state resident on every step of the
    loop; one evaluation on the resident shards (K1's slab plain version
    on each shard's buffer, the halos written in place) against the
    unsharded one on the same state (rtol = atol = 1e-5), the virial
    too."""
    shd, ref = resident_and_unsharded(
        lambda: htt.md.NVT(kT=1.0, tau=0.5), n=2000,
        model=lambda nn: TLJ(nn, virial=True))
    layout = shd._ensure_layout()
    slots = layout.resident(shd.mesh)
    st, aux = slots.pack(shd.state)
    lr = ref._ensure_layout()
    wst, waux = lr.pack(ref.state)
    f_s, w_s = shd._forces(st, aux, slots, shd._route(layout, st, aux),
                           True, True)
    f_r, w_r = ref._forces(wst, waux, lr, ref._route(lr, wst, waux), True,
                           True)
    torch.testing.assert_close(slots.whole(f_s), f_r, rtol=1e-5, atol=1e-5)
    assert w_s is not None
    torch.testing.assert_close(slots.whole(w_s), w_r, rtol=1e-5, atol=1e-5)
    for f, w in zip(f_s, w_s):
        assert not f[-slots.layer:].any() and not w[-slots.layer:].any()
    shd.run(8)
    ref.run(8)
    assert shd._packed[1] is slots
    d = min_image_diff(shd.state.positions, ref.state.positions,
                       shd._lengths)
    np.testing.assert_allclose(d, np.zeros_like(d), atol=5e-4)
    np.testing.assert_allclose(shd.thermo()["temperature"],
                               ref.thermo()["temperature"], rtol=1e-4)


@pytest.mark.parametrize("case", ["langevin", "brownian", "npt",
                                  "minimize", "log", "period2_builtin",
                                  "probe"])
def test_integrators_and_options_match_unsharded_port(case):
    """Each integrator and option on the resident shards against the
    unsharded port from the same state at the same plan: Langevin and
    Brownian (the noise drawn once per step, each shard gathering its
    rows), NPT (the kinetic and virial sums added over shards, the box
    sent to every shard), Minimize, run(log_period=) (the records from
    per-shard partial sums), a built-in LJ beside the model evaluated
    every 2nd step (the carried forces move with their particles), and a
    SimModel the probe accepts (K1's generic form's slab plain version
    on each shard)."""
    integ = {
        "langevin": lambda: htt.md.Langevin(kT=0.9, gamma=1.0),
        "brownian": lambda: htt.md.Brownian(kT=0.5, gamma=1.0),
        "npt": lambda: htt.md.NPT(kT=1.2, tau=0.5, P=0.3, tauP=0.5),
        "minimize": lambda: htt.md.Minimize(max_disp=0.05),
    }.get(case, lambda: htt.md.NVT(kT=1.0, tau=0.5))
    kw = dict(period=2, builtin=True) if case == "period2_builtin" else {}
    if case == "probe":
        kw = dict(model=TLJModel)
    if case == "npt":
        kw = dict(kT=1.2)
    shd, ref = resident_and_unsharded(integ, **kw)
    steps = 30 if case == "log" else 10
    for sim in (shd, ref):
        if case == "brownian":
            sim.dt = 2e-4
        sim.run(steps, log_period=10 if case == "log" else None)
    assert isinstance(shd._packed[2][0], SlabState)
    assert int(shd.state.step) == steps
    box = np_(ref.state.box[1] - ref.state.box[0])
    d = min_image_diff(shd.state.positions, ref.state.positions, box)
    np.testing.assert_allclose(d, np.zeros_like(d), atol=5e-4)
    f = np_(shd.state.forces)
    assert np.all(np.isfinite(f))
    np.testing.assert_allclose(f, np_(ref.state.forces), rtol=1e-3,
                               atol=1e-3)
    if case == "npt":
        vs = float(torch.prod(shd.state.box[1] - shd.state.box[0]))
        vr = float(torch.prod(ref.state.box[1] - ref.state.box[0]))
        np.testing.assert_allclose(vs, vr, rtol=1e-5)
        assert shd._layout.dynamic_box
    if case == "log":
        assert shd.log["temperature"].shape == (3,)
        for k in ("temperature", "potential_energy", "kinetic_energy",
                  "pressure"):
            np.testing.assert_allclose(shd.log[k], ref.log[k], rtol=1e-4)
    if case == "probe":
        assert shd.tfc._lane_fast_ok
    if case == "minimize":
        assert not np_(shd.state.velocities).any()


def test_checkpoint_resumes_resident_order():
    """A checkpoint of the sharded engine keeps the resident shards' slot
    order (gathered once), and the resumed simulation continues as the
    saved one does, bit for bit on the CPU."""
    import os
    import tempfile
    from hoomd_tf_tpu_torch.serialize import load_checkpoint, \
        save_checkpoint
    sims = []
    for _ in range(2):
        sim, _ = resident_and_unsharded(lambda: htt.md.NVT(kT=1.0, tau=0.5))
        sims.append(sim)
    a, b = sims
    a.run(5)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ck")
        save_checkpoint(path, a.tfc.model, a, a.tfc)
        load_checkpoint(path, b.tfc.model, b, b.tfc)
    assert isinstance(b._packed[1], SlabSlots)
    assert torch.equal(b._packed[1].whole(b._packed[2][1]["orig"]),
                       a._packed[1].whole(a._packed[2][1]["orig"]))
    a.run(5)
    b.run(5)
    assert torch.equal(a.state.positions, b.state.positions)


# ----------------------------------------------------------------------
# residency
# ----------------------------------------------------------------------
def test_shard_buffers_are_resident():
    """After run(), each shard's buffers hold (nzl + 1) * layer rows on
    its own mesh device, the state between runs is gathered in particle
    order on the first device, ``mask_rows`` zeroes each shard's ghost
    rows, and the next run starts from the kept shards."""
    sim = ShardedSimulation(dt=0.005, kT=1.0, mesh=cpu_mesh(4), seed=1)
    pos, vel, lengths = fluid_arrays(1500, 0.4, 1, jitter=0.08)
    sim.init_state(pos, lengths, velocities=vel)
    sim.attach(TLJ(48), r_cut=2.5)
    sim.run(6)
    slots, (st, aux) = sim._packed[1], sim._packed[2]
    assert isinstance(slots, SlabSlots) and isinstance(st, SlabState)
    assert sim.state.positions.shape == (1500, 3)
    for s, (dev, z0, nzl) in enumerate(slots.slabs):
        rows = (nzl + 1) * slots.layer
        assert dev == sim.mesh.devices[s]
        p = st.shards[s]
        for t in (p.positions, p.velocities, p.types, p.masses, p.forces,
                  p.virial, aux["valid"][s], aux["orig"][s], aux["ref"][s]):
            assert t.shape[0] == rows and t.device == dev
        assert rows < slots.plan.n_slots
    assert sum(int((o < 1500).sum()) for o in aux["orig"]) == 1500
    assert all(bool((o[-slots.layer:] == 1500).all()) for o in aux["orig"])
    ones = Shards(torch.ones_like(p.forces) for p in st.shards)
    f, w = slots.mask_rows(ones, Shards(torch.ones_like(p.virial)
                                        for p in st.shards), aux)
    for x, y, v in zip(f, w, aux["valid"]):
        assert torch.equal(x, v[:, None].expand_as(x))
        assert torch.equal(y, v[:, None, None].expand_as(y))
    kept = sim._packed
    sim.run(2)
    assert sim._packed[1] is kept[1]


@pytest.mark.parametrize("case", ["pair", "probe", "npt"])
def test_step_loop_holds_no_whole_slot_tensor(case):
    """At every step of a resident run (logged, so the log's sums run
    too) no live tensor made since the simulation was has all ``n_slots``
    rows: a PairModel, a SimModel the probe accepts (validated on a whole
    pack of its own before the loop), and NPT's geometry per box."""
    import gc
    gc.collect()
    # what other tests of this process left alive (held, so no id of it is
    # reused by a tensor of this run)
    before = [t for t in gc.get_objects() if torch.is_tensor(t)]
    old = {id(t) for t in before}
    integ = (htt.md.NPT(kT=1.0, tau=0.5, P=0.3, tauP=0.5) if case == "npt"
             else htt.md.NVT(kT=1.0, tau=0.5))
    sim = ShardedSimulation(dt=0.005, mesh=cpu_mesh(4), seed=1,
                            integrator=integ)
    pos, vel, lengths = fluid_arrays(1500, 0.4, 1, jitter=0.08)
    sim.init_state(pos, lengths, velocities=vel)
    sim.attach(TLJModel(48) if case == "probe" else TLJ(48, virial=True),
               r_cut=2.5)
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
    sim.run(6, log_period=2)
    assert isinstance(sim._packed[2][0], SlabState)
    assert len(seen) == 6 and not any(seen), seen

