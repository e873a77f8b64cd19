"""K1's group launch on the CPU: the shards of a mesh that one device holds
evaluated as one group (``ops/cellwise.py::half_stencil_group_plain``,
the plain version of ``cellwise_cuda.half_stencil_group_forces``, and the
generic form's ``cellwise_cuda.generic_group_plain``), on virtual CPU
shards (``make_mesh(S, devices=[cpu] * S)``) of a 6^3-cell plan.

Tolerances: the group's forces, energy and virial against each shard's
slab plain version with today's halo exchange (copies, reverse-halo adds)
and against the unsharded plain K1 at 1e-6 of max|F| in float32 and
1e-12 in float64 (the same terms; the exchange adds the boundary layer's
back sums in another order), and bit for bit against the unsharded plain
K1 (the group adds them in its order ``t = 1..13``). Against the JAX
package's K1, sharded (its Pallas kernel under ``shard_map`` on 8 virtual
devices, interpreted) and unsharded, at rtol = atol = 1e-4, the JAX
kernel's bar (tests/test_cellwise.py). The generic form's joined list
equals each shard's list lane for lane. Eight NVT steps through the
group against the unsharded port at atol 5e-4 in positions
(tests/test_parallel.py's bar).
"""

import functools

import numpy as np
import pytest
import torch

from hoomd_tf_tpu.md.slots import SlotLayout as JLayout
from hoomd_tf_tpu.md.state import init_state as jinit
from hoomd_tf_tpu.ops import cellwise as jcw
from hoomd_tf_tpu.parallel import make_mesh as jmesh
import hoomd_tf_tpu_torch as htt
from hoomd_tf_tpu_torch.md.slots import SlotLayout
from hoomd_tf_tpu_torch.md.state import init_state
from hoomd_tf_tpu_torch.ops import cellwise as tcw
from hoomd_tf_tpu_torch.ops import cellwise_cuda as tcc
from hoomd_tf_tpu_torch.parallel import make_mesh

from test_torch_parallel import TLJ, TLJModel, min_image_diff
from torch_helpers import fluid_arrays, np_

CPU = torch.device("cpu")
F64 = torch.float64
RCM = np.array([[2.5, 1.8], [1.8, 2.2]], np.float32)
# 1500 particles at density 0.4: a 6^3-cell plan (cap 23) for S = 2, 3
N = 1500


def cpu_mesh(S):
    return make_mesh(S, devices=[CPU] * S)


def group_case(S, dtype=torch.float32, typed=False):
    """The fluid packed whole and resident on S CPU shards:
    ``(layout, slots, mesh, slot state, aux, numpy (pos, vel, lengths))``."""
    pos, vel, lengths = fluid_arrays(N, 0.4, 3, jitter=0.08)
    types = (np.arange(N) % 2) if typed else None
    lo = -np.asarray(lengths, np.float64) / 2
    plan = tcw.plan_cellwise(N, lengths, 2.5, positions=pos, lo=lo,
                             z_divisor=S)
    assert plan.grid[2] % S == 0
    st = init_state(pos, lengths, types=types, velocities=vel, dtype=dtype,
                    device="cpu")
    layout = SlotLayout(plan, N, lo, rc_matrix=RCM if typed else None,
                        dtype=dtype, device="cpu", box=st.box)
    mesh = cpu_mesh(S)
    slots = layout.resident(mesh)
    sst, aux = slots.pack(st)
    return layout, slots, mesh, sst, aux, (pos, vel, lengths)


def lj_form(typed):
    pot = (htt.md.LennardJones([[1.0, 0.5], [0.5, 0.5]], 1.0, r_cut=2.5)
           if typed else htt.md.LennardJones(r_cut=2.5))
    return pot.kernel_form()


def assert_rel(got, want, dtype):
    tol = (1e-12 if dtype == F64 else 1e-6) * float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("S", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, F64])
@pytest.mark.parametrize("typed", [False, True])
def test_group_matches_exchange_and_unsharded(S, dtype, typed):
    """The group of every shard (the wrapper's CPU branch) against each
    shard's slab plain version with the halo exchange (the ``'half'``
    stencil of ``resident_pair_forces``) and against the unsharded plain
    K1: forces, energy and virial, the halo rows zero, and the unsharded
    plain K1's forces bit for bit."""
    layout, slots, mesh, st, aux, _ = group_case(S, dtype, typed)
    plan, lo = layout.plan, layout.lo
    assert plan.grid == (6, 6, 6)
    form = lj_form(typed)
    geoms = slots.geoms(st)
    args = (st.positions, st.types, aux["valid"], plan, lo, form.evaluate,
            mesh, geoms)
    kw = dict(needs_virial=True, with_types=typed,
              rcut_matrix=layout.rc2_tab)
    f_g, w_g = tcw.resident_pair_forces(*args, form=form, **kw)
    f_x, w_x = tcw.resident_pair_forces(*args, stencil="half", **kw)
    whole = [slots.whole(t) for t in (st.positions, st.types, aux["valid"])]
    f_u, w_u = tcc.half_stencil_plain(*whole, plan, lo, form,
                                      needs_virial=True,
                                      rc2_tab=layout.rc2_tab,
                                      geometry=layout.geometry)
    w = slots.whole
    for got, want in ((w(f_g), f_u), (w(w_g), w_u), (w(f_x), f_u),
                      (w(w_x), w_u), (w(f_g), w(f_x))):
        assert got.dtype == dtype
        assert_rel(got, want, dtype)
    assert torch.equal(w(f_g), f_u) and torch.equal(w(w_g), w_u)
    for f, v in zip(f_g, w_g):
        assert not f[-slots.layer:].any() and not v[-slots.layer:].any()
    assert np_(f_u)[:, 3].any()


@functools.lru_cache(maxsize=None)
def jax_k1(typed):
    """The JAX package's K1 on group_case's fluid at its plan for 2
    shards, the same for S = 2 and 3 (computed once a module): the Pallas
    kernel (interpreted) under shard_map on 8 virtual devices, and
    unsharded; returns ``(plan, (sharded, unsharded))``, forces and
    virials in slot order, as numpy arrays.

    The sharded call runs under ``jax.jit``, as one program: called
    eagerly, each step of its assembly on the shard_map's sharded outputs
    (the rolls of ``_roll_back``, collective permutes) is a program of
    its own on the 8 devices, and XLA:CPU's in-process rendezvous of such
    a permute can wait with 6 of its 8 participants for the 40 s of
    ``xla_cpu_collective_call_terminate_timeout_seconds`` and then abort
    the process (it did so in about one run in six of this call alone,
    and took a test worker down under the suite's load)."""
    import jax
    pos, vel, lengths = fluid_arrays(N, 0.4, 3, jitter=0.08)
    lo = -np.asarray(lengths, np.float64) / 2
    types = (np.arange(N) % 2) if typed else None
    jplan = jcw.plan_cellwise(N, lengths, 2.5, positions=pos, lo=lo,
                              z_divisor=2)
    jl = JLayout(jplan, N, lo, rc_matrix=RCM if typed else None)
    js, jaux, _ = jl.pack(jinit(pos, lengths, types=types, velocities=vel))

    def lj(r2, ti=None, tj=None):
        import jax.numpy as jnp
        u = 1.0 / r2
        sr6 = u * u * u
        e = (jnp.where((ti == 0) & (tj == 0), 1.0, 0.5) if typed else 1.0)
        return (4.0 * e * (sr6 * sr6 - sr6),
                -12.0 * e * (2.0 * sr6 - 1.0) * sr6 * u)
    kw = dict(needs_virial=True, with_types=typed, rcut_matrix=jl.rc_matrix)

    def k1(stencil, mesh=None):
        def call(p, t, v):
            return jcw.analytic_pair_forces(
                p, t, v, jplan, jl.lo, lj, stencil=stencil, mesh=mesh,
                shard_axis="d", **kw)
        return call
    args = (js.positions, js.types, jaux["valid"])
    sharded = jax.jit(k1("pallas", jmesh(8)))(*args)
    whole = k1("full")(*args)
    return jplan, tuple(tuple(np.asarray(t) for t in out)
                        for out in (sharded, whole))


@pytest.mark.parametrize("S", [2, 3])
def test_group_matches_jax_sharded_and_unsharded(S):
    """The group of every shard (typed LJ with a cut table) against the
    JAX package's K1 under its mesh (8 virtual devices) and unsharded, at
    the JAX kernel's bar."""
    layout, slots, mesh, st, aux, (pos, vel, lengths) = group_case(
        S, typed=True)
    form = lj_form(True)
    f_g, w_g = tcw.resident_pair_forces(
        st.positions, st.types, aux["valid"], layout.plan, layout.lo,
        form.evaluate, mesh, slots.geoms(st), needs_virial=True,
        with_types=True, rcut_matrix=layout.rc2_tab, form=form)
    jplan, ((fs, ws), (fw, ww)) = jax_k1(True)
    assert (jplan.grid, jplan.capacity) == (layout.plan.grid,
                                            layout.plan.capacity)
    for got, want in ((slots.whole(f_g), fs), (slots.whole(w_g), ws),
                      (slots.whole(f_g), fw), (slots.whole(w_g), ww)):
        np.testing.assert_allclose(np_(got), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)


def test_slab_groups_partition_by_device():
    """Shards partitioned by device in ring order, each member's ring
    neighbours in its group or -1; whole=False: one group per shard."""
    slabs = [(d, 2 * s, 2) for s, d in enumerate(
        ["cuda:0", "cuda:0", "cpu", "cpu", "cuda:0"])]
    g = tcw.slab_groups(slabs)
    assert [x.members for x in g] == [(0, 1, 4), (2, 3)]
    assert g[0].prev == (2, 0, -1) and g[0].next == (1, -1, 0)
    assert g[1].prev == (-1, 0) and g[1].next == (1, -1)
    assert g[0].device == torch.device("cuda", 0)
    assert g[0].slabs == ((0, 2), (2, 2), (8, 2))
    one = tcw.slab_groups(slabs, whole=False)
    assert [x.members for x in one] == [(s,) for s in range(5)]
    assert all(x.prev == x.next == (-1,) for x in one)


@pytest.mark.parametrize("blocks", [(2, 2), (1, 3)])
def test_groups_exchange_between_devices(monkeypatch, blocks):
    """Four shards in two groups, as two devices would hold them in turn
    of blocks (ring order kept): within a group nothing is copied, between
    the groups the halo positions are copied and the reverse halos added;
    the result equals the unsharded plain K1 (1e-6 of max|F|), the halo
    rows are zero, and the sending shards' halo positions are the next
    shard's first layer."""
    layout, slots, mesh4, st, aux, _ = group_case(4)
    a = blocks[0]
    members = [tuple(range(a)), tuple(range(a, 4))]
    real = tcw.slab_groups

    def fake(slabs, whole=True):
        if not whole:
            return real(slabs, whole)
        out = []
        for m in members:
            at = {s: k for k, s in enumerate(m)}
            out.append(tcw.SlabGroup(
                CPU, m, tuple((slabs[s][1], slabs[s][2]) for s in m),
                tuple(at.get((s - 1) % 4, -1) for s in m),
                tuple(at.get((s + 1) % 4, -1) for s in m)))
        return out
    monkeypatch.setattr(tcw, "slab_groups", fake)
    L = slots.layer
    for s in range(4):
        st.shards[s].positions[-L:] = 0.0
    form = lj_form(False)
    f, w = tcw.resident_pair_forces(
        st.positions, st.types, aux["valid"], layout.plan, layout.lo,
        form.evaluate, mesh4, slots.geoms(st), needs_virial=True, form=form)
    whole = [slots.whole(t) for t in (st.positions, st.types, aux["valid"])]
    f_u, w_u = tcc.half_stencil_plain(*whole, layout.plan, layout.lo, form,
                                      needs_virial=True,
                                      geometry=layout.geometry)
    assert_rel(slots.whole(f), f_u, torch.float32)
    assert_rel(slots.whole(w), w_u, torch.float32)
    for s in range(4):
        assert not f[s][-L:].any() and not w[s][-L:].any()
        sends = s in (members[0][-1], members[1][-1])
        copied = torch.equal(st.shards[s].positions[-L:],
                             st.shards[(s + 1) % 4].positions[:L])
        assert copied == sends, s


@pytest.mark.parametrize("S", [2, 3])
def test_generic_group_joins_lists_and_calls_once(S):
    """K1's generic form over the group: its joined list holds each
    shard's lanes (its slab list on the exchanged buffer) lane for lane,
    the pair function runs once per evaluation on it, and the forces,
    energy and virial equal the unsharded generic plain version (1e-6 of
    max|F|); a list too short for the group records its need per shard
    and overflows."""
    layout, slots, mesh, st, aux, _ = group_case(S)
    plan, lo = layout.plan, layout.lo
    form = lj_form(False)
    calls = []

    def fn(r2):
        calls.append(r2.shape[0])
        return form.evaluate(r2)
    geoms = slots.geoms(st)
    lanes = tcc.LaneBudget(tcc.lane_budget(plan, N, (0, plan.grid[2] // S)),
                           CPU)
    f, w = tcw.resident_pair_forces(
        st.positions, st.types, aux["valid"], plan, lo, fn, mesh, geoms,
        needs_virial=True, stencil="kernel", lanes=lanes)
    assert len(calls) == 1
    group = tcw.slab_groups(tcw.mesh_slabs(plan, mesh))[0]
    _, _, joined = tcc.generic_group_plain(
        st.positions, st.types, aux["valid"], plan, lo, form.evaluate,
        group, typed_fn=False, geometry=geoms[0])
    assert calls[0] == joined["r2"].shape[0]
    whole = [slots.whole(t) for t in (st.positions, st.types, aux["valid"])]
    parts = []
    for z0, nzl in tcw.slab_layers(plan, S):
        buf = [tcw.slab_buffer(t, plan, z0, nzl) for t in whole]
        parts.append(tcc.generic_list_plain(*buf, plan, lo,
                                            geometry=layout.geometry,
                                            typed=False, slab=(z0, nzl)))
    for key in ("r2", "cell", "row", "col"):
        assert torch.equal(joined[key], torch.cat([p[key] for p in parts]))
    need = joined["r2"].shape[0]
    assert int(lanes.needed) == -(-need // S) and not bool(lanes.overflow())
    f_u, w_u = tcc.generic_plain(*whole, plan, lo, form.evaluate,
                                 typed_fn=False, needs_virial=True,
                                 geometry=layout.geometry)
    assert_rel(slots.whole(f), f_u, torch.float32)
    assert_rel(slots.whole(w), w_u, torch.float32)
    short = tcc.LaneBudget(need // S // 2, CPU)
    tcc.generic_group_pair_forces(
        st.positions, st.types, aux["valid"], plan, lo, form.evaluate,
        group, typed_fn=False, geometry=geoms[0], lanes=short)
    assert bool(short.overflow())


@pytest.mark.parametrize("model", ["pair", "generic"])
def test_nvt_through_group_matches_unsharded(monkeypatch, model):
    """Eight NVT steps (repack interval 3) of ShardedSimulation on 3 CPU
    shards through the group (each evaluation one group call: counted by
    a spy on the wrappers) against the unsharded port at the same plan;
    'generic': a SimModel the probe accepts, in the generic form's group
    plain version (``stencil='kernel'``)."""
    pos, vel, lengths = fluid_arrays(N, 0.4, 3, jitter=0.08)
    name = ("half_stencil_group_forces" if model == "pair" else
            "generic_group_pair_forces")
    real = getattr(tcc, name)
    seen = []

    def spy(*args, **kwargs):
        seen.append(1)
        return real(*args, **kwargs)
    monkeypatch.setattr(tcc, name, spy)
    sims = []
    for mesh in (cpu_mesh(3), None):
        sim = htt.Simulation(dt=0.005, integrator=htt.md.NVT(kT=1.0,
                                                              tau=0.5),
                             seed=3, mesh=mesh,
                             device=None if mesh else "cpu")
        sim.init_state(pos, lengths, velocities=vel)
        htt.tfcompute(TLJ(48) if model == "pair" else TLJModel(48)).attach(
            sim, r_cut=2.5, nlist="cellwise")
        sim.stencil = "kernel"
        sims.append(sim)
    shd, ref = sims
    plan = shd._ensure_layout().plan
    ref._plan_from_current = lambda: plan
    shd._choose_repack_interval = ref._choose_repack_interval = \
        lambda layout: 3
    e0, p0 = shd.force_evals, shd.probe_evals
    shd.run(8)
    ref.run(8)
    assert len(seen) == shd.force_evals - e0 - (shd.probe_evals - p0) >= 8
    d = min_image_diff(shd.state.positions, ref.state.positions,
                       shd._lengths)
    np.testing.assert_allclose(d, np.zeros_like(d), atol=5e-4)


def test_group_wrapper_checks_its_inputs():
    """The group wrappers refuse buffers of the wrong length and groups
    of unequal slabs or past kMaxGroup shards."""
    layout, slots, mesh, st, aux, _ = group_case(2)
    group = tcw.slab_groups(tcw.mesh_slabs(layout.plan, mesh))[0]
    form = lj_form(False)
    bad = [p[:-1] for p in st.positions]
    with pytest.raises(ValueError, match="expected shape"):
        tcc.half_stencil_group_forces(bad, st.types, aux["valid"],
                                      layout.plan, layout.lo, form, group)
    uneven = tcw.SlabGroup(CPU, (0, 1), ((0, 2), (2, 4)), (1, 0), (1, 0))
    with pytest.raises(ValueError, match="unequal"):
        tcc.group_args(layout.plan, uneven)
    many = tcw.SlabGroup(CPU, tuple(range(17)), ((0, 1),) * 17,
                         (-1,) * 17, (-1,) * 17)
    with pytest.raises(ValueError, match="above"):
        tcc.group_args(layout.plan, many)
