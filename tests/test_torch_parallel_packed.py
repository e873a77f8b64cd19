"""The packed routes and mapped models under a device mesh, the port
against the JAX package on the CPU, on virtual CPU shards (``make_mesh(S,
devices=[cpu] * S)``): kernel K3's group plain version and the sort
build per device's group of z-slab shards (whole, groups of one, partial:
the shards' devices named ``"cpu"`` and ``"cpu:k"``), the ``'direct'``
planes per particle rows, the sharded
engine on ``'cell'``, ``'pallas'``, ``'direct'`` and ``'auto'``, packed
training, reference example 02's mapped model on ``'cell'``,
``'cellwise'`` and ``'n2'``, mapped training, and the capacity overflow's
self-heal under a mesh.

The packed cell grid has no divisor (the JAX package plans it without
one): shard ``s`` of ``S`` takes the z-layers ``nz s // S`` on, uneven
where ``S`` does not divide ``nz``, so the sharded and unsharded builds
and the JAX package's share one plan.

Tolerances: every gathered list and every gathered set of planes equals
the unsharded port's exactly (the same operations on the same values per
row), and a sharded run equals the unsharded port's run exactly; against
the JAX package after one step, positions atol 1e-6 and forces atol 1e-4
(tests/test_torch_packed.py's bar), after three steps positions atol 1e-5
(tests/test_torch_mapped.py's); mapped bead positions atol 1e-5 and one
step's forces atol 1e-4 (tests/test_torch_mapped.py's); three SGD steps
of packed training, losses and weights at rtol 1e-3, atol 1e-6
(tests/test_torch_train_packed.py's bar for a trajectory).
"""

import functools
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hoomd_tf_tpu as htf
from hoomd_tf_tpu.ops import cellwise as jcw
import hoomd_tf_tpu_torch as htt
from hoomd_tf_tpu_torch.interop import (build_model, load_jax_variables,
                                        state_from_numpy)
from hoomd_tf_tpu_torch.ops import cell_list as tcl
from hoomd_tf_tpu_torch.ops import cell_stencil as tcs
from hoomd_tf_tpu_torch.ops import direct as tdr
from hoomd_tf_tpu_torch.ops import nlist_cuda as tnc

from test_torch_mapped import (JMapped, TMapped, TMappedEps, jax_mapping,
                               torch_mapping)
from test_torch_packed import JLJ, JNN, TLJ, TNN
from test_torch_parallel import cpu_mesh
from test_torch_train_generic import build_jax, trainable
from torch_helpers import (fluid_arrays, jax_state, jax_state_numpy, np_,
                           seed_jax_weights)

POS_TOL = dict(rtol=0, atol=1e-6)
F_TOL = dict(rtol=0, atol=1e-4)
R_CUT = 3.0


def binned(n=1500, density=0.35, seed=2, dtype=torch.float32, r_cut=2.5):
    """A two-type fluid binned into its cell-list plan: ``(pos4, lengths
    tensor, host lengths, grid, capacity)``."""
    pos, _, lengths = fluid_arrays(n, density, seed)
    types = (np.arange(n) % 2).astype(np.float32)
    pos4 = torch.as_tensor(np.concatenate([pos, types[:, None]], 1),
                           dtype=dtype)
    grid, cap = tcl.plan(n, lengths, r_cut)
    cap = max(cap, int(np.ceil(tcl.max_occupancy(pos, lengths, grid) * 1.3))
              + 1)
    return pos4, torch.as_tensor(lengths, dtype=dtype), lengths, grid, cap


# ----------------------------------------------------------------------
# the builds per shard
# ----------------------------------------------------------------------
def test_slab_layers_cover_the_grid():
    """``nz s // S`` on: the shards' layers tile the grid in order, uneven
    where S does not divide nz, empty for a shard past nz."""
    assert tcs.z_slabs(6, 4) == [(0, 1), (1, 2), (3, 1), (4, 2)]
    assert tcs.z_slabs(8, 2) == [(0, 4), (4, 4)]
    assert tcs.z_slabs(3, 4) == [(0, 0), (0, 1), (1, 1), (2, 1)]
    for nz, S in ((6, 4), (7, 3), (3, 4), (12, 4)):
        layers = [(z0, k) for z0, k in tcs.z_slabs(nz, S) if k]
        assert layers[0][0] == 0 and sum(k for _, k in layers) == nz
        assert all(a + k == b for (a, k), (b, _) in zip(layers, layers[1:]))


def partitions(S):
    """Device lists of ``S`` virtual CPU shards, each grouped by device name
    (``"cpu"`` the binning device, ``"cpu:k"`` another): a group of every
    shard on the binning device; groups of one, none on it; a partial
    group on it, non-adjacent shards, beside one elsewhere."""
    return {"whole": ["cpu"] * S,
            "ones": [f"cpu:{s + 1}" for s in range(S)],
            "partial": ["cpu" if s % 2 == 0 else "cpu:1" for s in range(S)]}


@functools.lru_cache(maxsize=None)
def jax_pallas_list(NN=40):
    """The JAX package's ``cell_list_nlist(method='pallas')`` of
    :func:`binned`'s float32 system on the same plan."""
    pos4, _, L, grid, cap = binned()
    return np_(htf.cell_list_nlist(jnp.asarray(np_(pos4)), 2.5, NN,
                                   jnp.asarray(L), grid=grid, capacity=cap,
                                   method="pallas"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("S", [2, 3, 4])
def test_k3_slab_plain_gathers_to_unsharded(S, dtype):
    """Kernel K3's group plain version, one call per device's group of
    z-slab shards, in three partitions (:func:`partitions`): in place on
    the cell table, the group's particles' rows and the rows of particles
    without a slot written into the list and the other rows left alone;
    on a joined buffer (each run of layers with a halo layer each side),
    the occupied home slots' rows, the empty slots' rows zero. Every row
    equals the unsharded plain version's row of its particle exactly, and
    each gathered list (``CellNlist.sharded``) equals the unsharded list
    exactly and, in float32, the JAX package's 'pallas' list at
    tests/test_torch_nlist.py's bar."""
    from hoomd_tf_tpu_torch.ops.cellwise import slab_groups
    pos4, Lt, L, grid, cap = binned(dtype=dtype)
    n, NN = pos4.shape[0], 40
    slots4, counts, pid, ovf = tcl.build_planes(pos4, grid, cap, Lt)
    assert not bool(ovf)
    want = tnc.nlist_select_reference(slots4, counts, pid, grid, cap, NN,
                                      2.5, L, n)
    nx, ny, nz = grid
    layer = nx * ny * cap
    build = tcl.CellNlist(grid, cap, L, 2.5, NN, "pallas", "cpu",
                          dtype=dtype)
    for kind, devices in partitions(S).items():
        slabs = [(d, z0, k) for d, (z0, k) in
                 zip(devices, tcs.z_slabs(nz, S))]
        seen = 0
        for g in slab_groups(slabs):
            runs = tcs.group_layers(g.slabs)
            p = torch.cat([pid[z0 * layer:(z0 + k) * layer]
                           for z0, k in runs]).long()
            held = p >= 0
            seen += int(held.sum())
            if g.device == torch.device("cpu"):
                nan = torch.full((n, NN, 4), float("nan"), dtype=dtype)
                rows = tnc.nlist_select(slots4, counts, pid, grid, cap, NN,
                                        2.5, L, n, group=runs, out=nan)
                assert rows.data_ptr() == nan.data_ptr()
                mine = torch.zeros(n, dtype=torch.bool)
                mine[p[held]] = True
                assert torch.equal(rows[mine], want[mine])
                assert bool(rows[~mine].isnan().all())
                continue
            buf = tcs.joined_slab(slots4, grid, cap, runs)
            cnt = tcs.joined_slab(counts, grid, 1, runs)
            assert buf.shape[0] == sum(k + 2 for _, k in runs) * layer
            rows = tnc.nlist_select(buf, cnt, None, grid, cap, NN, 2.5, L,
                                    None, group=runs)
            assert rows.shape == (len(p), NN, 4) and rows.dtype == dtype
            assert torch.equal(rows[held], want[p[held]])
            assert not bool(rows[~held].any())
        assert seen == n, kind
        got, ovf = build.sharded(pos4, Lt, devices)
        assert torch.equal(got, want) and not bool(ovf), kind
        if dtype == torch.float32:
            np.testing.assert_allclose(np_(got), jax_pallas_list(), rtol=0,
                                       atol=1e-6)
            np.testing.assert_array_equal(np_(got)[..., 3],
                                          jax_pallas_list()[..., 3])
    assert tnc.nlist_select.launches == tnc.nlist_select.group_launches == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("S", [2, 3, 4])
def test_sort_build_per_shard_equals_unsharded(S, dtype):
    """The sort method per device's group of z-slab shards (one sort over
    the group's home cells: in place on the binning device, else on its
    joined buffer) in each partition of :func:`partitions`, untyped and
    with a typed cut (the mapped models' route): the gathered list equals
    the unsharded one exactly, in particle order; the overflow flag
    agrees."""
    pos4, Lt, L, grid, cap = binned(dtype=dtype)
    rcm = np.array([[2.5, 1.8], [1.8, 2.2]])
    for devices in partitions(S).values():
        for rc in (None, rcm):
            build = tcl.CellNlist(grid, cap, L, 2.5, 40, "sort", "cpu", rc,
                                  dtype)
            want, ovf = build(pos4, Lt)
            got, ovf_s = build.sharded(pos4, Lt, devices)
            assert torch.equal(got, want)
            assert bool(ovf) == bool(ovf_s) is False
        # an undersized capacity: the flag is set sharded too, and the
        # rows of particles without a slot are zero in both
        for method in ("sort", "pallas"):
            small = tcl.CellNlist(grid, 4, L, 2.5, 40, method, "cpu", None,
                                  dtype)
            want, ovf = small(pos4, Lt)
            got, ovf_s = small.sharded(pos4, Lt, devices)
            assert bool(ovf) and bool(ovf_s) and torch.equal(got, want)


@pytest.mark.parametrize("S", [2, 4])
def test_direct_rows_per_shard_equal_whole_planes(S):
    """``'direct'``: each shard's particle rows' 27-cell planes, gathered,
    equal the whole planes exactly, typed cut included."""
    pos4, Lt, L, grid, cap = binned(n=1200)
    for rc in (None, np.array([[2.5, 1.8], [1.8, 2.2]])):
        build = tdr.DirectPlanes(grid, cap, 2.5, "cpu", rc)
        want, _ = build(pos4, Lt)
        got, ovf = build.sharded(pos4, Lt, ["cpu"] * S)
        assert not bool(ovf)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        rows = slice(300, 700)
        cell = tdr._cell_of(pos4[:, :3], grid, Lt)
        slots4 = tcl.build_planes(pos4, grid, cap, Lt)[0]
        part = tdr.direct_rows(pos4, slots4, cell, build.neigh, cap, Lt, 2.5,
                               build.rc2_tab, rows=rows)
        assert all(torch.equal(a, b[rows]) for a, b in zip(part, want))


# ----------------------------------------------------------------------
# the sharded engine against JAX's unsharded engine
# ----------------------------------------------------------------------
def packed_sims(nlist, S, n=600, jmodel=None, tmodel=None, seed=0,
                integrator="NVE"):
    """The JAX package's simulation, the port's on an ``S``-shard CPU mesh
    and the port's unsharded one, from the same state, the LJ SimModel of
    tests/test_torch_packed.py attached on ``nlist``."""
    pos, vel, lengths = fluid_arrays(n, 0.35, seed, kT=1.0)
    js = jax_state(pos, vel, lengths)
    integ = dict(NVE=(htf.md.NVE, htt.md.NVE, {}),
                 NVT=(htf.md.NVT, htt.md.NVT, dict(kT=1.0, tau=0.5)))
    jI, tI, kw = integ[integrator]
    jsim = htf.Simulation(dt=0.005, integrator=jI(**kw), seed=seed)
    jsim.set_state(js)
    htf.tfcompute(jmodel or JLJ(64)).attach(jsim, r_cut=R_CUT, nlist=nlist)
    out = [jsim]
    for mesh in (cpu_mesh(S), None):
        tsim = htt.Simulation(dt=0.005, integrator=tI(**kw), seed=seed,
                              mesh=mesh, device=None if mesh else "cpu")
        tsim.set_state(state_from_numpy(jax_state_numpy(js), device="cpu"))
        htt.tfcompute(tmodel() if tmodel else TLJ(64)).attach(
            tsim, r_cut=R_CUT, nlist=nlist)
        out.append(tsim)
    return out


@pytest.mark.parametrize("nlist,S", [("cell", 2), ("pallas", 4),
                                     ("direct", 4), (None, 4)])
def test_sharded_evaluation_matches_jax(nlist, S):
    """The JAX package's typical use on each packed route under a mesh:
    one step against JAX (positions 1e-6, forces 1e-4), two more against
    JAX (positions 1e-5), and every step's list or planes built per shard,
    so the sharded run equals the unsharded port's exactly. ``None``
    ('auto') resolves as without a mesh (the sort method on the CPU at
    N >= 512)."""
    jsim, tsim, usim = packed_sims(nlist, S)
    for sim in (jsim, tsim, usim):
        sim.run(1)
    want = {"cell": "sort", "pallas": "pallas", "direct": "direct",
            None: "sort"}[nlist]
    assert tsim._packed_build().method == usim._packed_build().method == want
    assert tsim._packed_build().plan == usim._packed_build().plan
    np.testing.assert_allclose(np_(tsim.state.positions),
                               np_(jsim.state.positions), **POS_TOL)
    np.testing.assert_allclose(np_(tsim.state.forces),
                               np_(jsim.state.forces), **F_TOL)
    f = np_(tsim.state.forces)
    assert np.abs(f[:, :3]).max() > 1e-2
    for sim in (jsim, tsim, usim):
        sim.run(2)
    np.testing.assert_allclose(np_(tsim.state.positions),
                               np_(jsim.state.positions), rtol=0, atol=1e-5)
    assert torch.equal(tsim.state.positions, usim.state.positions)
    assert torch.equal(tsim.state.forces, usim.state.forces)
    assert tsim.nlist_builds == 3


def test_sharded_nn_on_pallas_with_nvt_matches_jax():
    """An NN SimModel (tests/test_torch_packed.py's, JAX's weights) under
    NVT on ``'pallas'`` (K3's group plain version) on 2 shards: one step
    against JAX, then equal to the unsharded port."""
    jm = JNN(48)
    jm.ensure_built([jnp.zeros((1, 48, 4)), jnp.zeros((1, 4)),
                     jnp.zeros((3, 3))])
    seed_jax_weights(jm, seed=3)

    def tmodel():
        tm = build_model(TNN(48), R_CUT, device="cpu")
        return load_jax_variables(tm, jm.get_weights())
    jsim, tsim, usim = packed_sims("pallas", 2, jmodel=jm, tmodel=tmodel,
                                   seed=1, integrator="NVT")
    for sim in (jsim, tsim, usim):
        sim.run(1)
    np.testing.assert_allclose(np_(tsim.state.positions),
                               np_(jsim.state.positions), **POS_TOL)
    np.testing.assert_allclose(np_(tsim.state.forces),
                               np_(jsim.state.forces), **F_TOL)
    assert torch.equal(tsim.state.forces, usim.state.forces)


def test_sharded_packed_training_matches_jax():
    """Online training of TrainableNN on ``'cell'`` under a 4-shard mesh:
    three SGD steps' losses and weights against the JAX package's
    unsharded engine, and equal to the port's unsharded run."""
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
    for mesh in (cpu_mesh(4), None):
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
        tsim.run(3)
        assert tsim.train_steps == 3 and tsim.nlist_builds == 3
        runs.append((ttfc.loss_history, trainable(tm.get_weights()),
                     tsim.state.positions))
    jsim.run(3)
    (l_s, w_s, p_s), (l_u, w_u, p_u) = runs
    np.testing.assert_allclose(l_s, jtfc.loss_history, rtol=1e-3)
    for a, b in zip(w_s, trainable(jm.get_weights())):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-6)
    assert l_s == l_u
    assert all(np.array_equal(a, b) for a, b in zip(w_s, w_u))
    assert torch.equal(p_s, p_u)


def test_overflow_heals_under_a_mesh():
    """An undersized ``CellList(capacity=8)`` on 2 shards overflows (the
    OR of the shards' flags), warns, rolls back, re-plans with a larger
    floor and ends where the unsharded port's clean run ends."""
    pos, vel, lengths = fluid_arrays(600, 0.35, 6, kT=1.0)
    out = []
    for mesh, cfg in ((cpu_mesh(2), htt.CellList(capacity=8)),
                      (None, "cell")):
        sim = htt.Simulation(dt=0.005, seed=6, mesh=mesh,
                             device=None if mesh else "cpu")
        sim.init_state(pos, lengths, velocities=vel)
        htt.tfcompute(TLJ(48)).attach(sim, r_cut=R_CUT, nlist=cfg)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            sim.run(3)
        out.append((sim, [str(x.message) for x in w]))
    (s_sim, s_msg), (u_sim, u_msg) = out
    assert any("capacity 8 exceeded" in m for m in s_msg)
    assert not any("exceeded" in m for m in u_msg)
    assert s_sim._packed_build().plan[1] > 8
    np.testing.assert_allclose(np_(s_sim.state.positions),
                               np_(u_sim.state.positions), **POS_TOL)
    assert int(s_sim.state.step) == 3


# ----------------------------------------------------------------------
# mapped models under a mesh
# ----------------------------------------------------------------------
def atoms_for(nlist):
    """Atoms of a mapped case: 512 (tests/test_torch_mapped.py's), 1000 on
    ``'cellwise'``, whose z-layers must divide over the mesh (4 cells of
    3.4 at density 0.4)."""
    return 1000 if nlist == "cellwise" else 512


def mapped_pair(nlist, S):
    """Reference example 02's mapped model (tests/test_torch_mapped.py's
    JMapped / TMapped: LJ forces from the atom rows, an RDF of the bead
    rows into a MeanTensor) in the JAX package, unsharded, in the port on
    an ``S``-shard CPU mesh and in the port unsharded, from the same state;
    on ``'cellwise'`` JAX and the unsharded port are held to the sharded
    port's plan (``nz % S == 0``)."""
    n = atoms_for(nlist)
    pos, vel, lengths = fluid_arrays(n, 0.4, 5, kT=1.0)
    js = jax_state(pos, vel, lengths)
    jsim = htf.Simulation(dt=0.005, integrator=htf.md.NVT(kT=1.0, tau=0.5),
                          seed=0)
    jsim.set_state(js)
    jtfc = htf.tfcompute(JMapped(96))
    jtfc.enable_mapped_nlist(jsim, jax_mapping(n))
    jtfc.attach(jsim, r_cut=R_CUT, nlist=nlist)
    ports = []
    for mesh in (cpu_mesh(S), None):
        tsim = htt.Simulation(dt=0.005, seed=0, mesh=mesh,
                              integrator=htt.md.NVT(kT=1.0, tau=0.5),
                              device=None if mesh else "cpu")
        tsim.set_state(state_from_numpy(jax_state_numpy(js), device="cpu"))
        ttfc = htt.tfcompute(TMapped(96))
        ttfc.enable_mapped_nlist(tsim, torch_mapping(n))
        ttfc.attach(tsim, r_cut=R_CUT, nlist=nlist)
        ports.append((tsim, ttfc))
    if nlist == "cellwise":
        tp = ports[0][0]._ensure_layout().plan
        assert tp.grid[2] % S == 0
        jplan = jcw.CellwisePlan(grid=tp.grid, capacity=tp.capacity,
                                 lengths=tp.lengths, r_cut=tp.r_cut)
        jsim._plan_from_current = lambda: jplan
        ports[1][0]._plan_from_current = lambda: tp
    return (jsim, jtfc), ports[0], ports[1][0]


def wrapped(a, b, lengths):
    d = a - b
    return d - np.round(d / lengths) * lengths


@pytest.mark.parametrize("nlist,S", [("cell", 4), ("cellwise", 2),
                                     ("n2", 4)])
def test_mapped_model_on_mesh_matches_jax(nlist, S):
    """Example 02's mapped model under a mesh: the mapping on the whole
    state, then the list (``'cell'``: the sort method with the synthesized
    typed cut, per z-slab shard; ``'n2'``: the dense rows) or the planes
    (``'cellwise'``: per shard, the model once in particle order). One
    step against JAX: positions (beads included) 1e-5, forces 1e-4 (on
    ``'cellwise'`` rtol = atol = 1e-4: a row's planes are 27 cap lanes
    wide, the sum over them runs in another order than JAX's), zero bead
    forces, the beads' RDF; three steps: positions 1e-5 on ``'cell'`` and
    ``'n2'``. Each step equals the unsharded port's exactly. (Three steps
    of ``'cellwise'`` are held to the unsharded port alone: the JAX
    package's own mapped ``'cellwise'`` run leaves its ``'cell'`` run
    from the second or third step at 1000 atoms, where the port's stays
    with its ``'cell'``.)"""
    (jsim, jtfc), (tsim, ttfc), usim = mapped_pair(nlist, S)
    n = atoms_for(nlist)
    np.testing.assert_array_equal(ttfc.r_cut_matrix, jtfc.r_cut_matrix)
    for sim in (jsim, tsim, usim):
        sim.run(1)
    assert torch.equal(tsim.state.forces, usim.state.forces)
    if nlist == "cell":
        assert tsim._packed_build().method == "sort"
    if nlist == "cellwise":
        assert ttfc._lane_fast_ok is False
    lengths = np.asarray(tsim._lengths)
    np.testing.assert_allclose(
        wrapped(np_(tsim.state.positions), np_(jsim.state.positions),
                lengths), 0.0, rtol=0, atol=1e-5)
    f = np_(tsim.state.forces)
    np.testing.assert_allclose(
        f, np_(jsim.state.forces),
        **(dict(rtol=1e-4, atol=1e-4) if nlist == "cellwise" else F_TOL))
    assert np.abs(f[:n, :3]).max() > 0.1
    assert np.abs(f[n:]).max() == 0.0
    np.testing.assert_allclose(np_(ttfc.model.rdf.result()),
                               np_(jtfc.model.rdf.result()), rtol=1e-4,
                               atol=1e-6)
    for sim in (jsim, tsim, usim):
        sim.run(2)
    if nlist != "cellwise":
        np.testing.assert_allclose(
            wrapped(np_(tsim.state.positions), np_(jsim.state.positions),
                    lengths), 0.0, rtol=0, atol=1e-5)
    assert torch.equal(tsim.state.positions, usim.state.positions)
    assert torch.equal(tsim.state.forces, usim.state.forces)


@pytest.mark.parametrize("nlist", ["cell", "n2", "cellwise"])
def test_mapped_training_on_mesh(nlist):
    """Mapped training under a 2-shard mesh: on ``'cell'`` and ``'n2'`` it
    trains (the list built per shard), the bead rows' net force zero, and
    equals the unsharded port's run exactly; on ``'cellwise'`` it raises
    the ValueError naming the mapping, as in the JAX package."""
    n = 1000 if nlist == "cellwise" else 256
    pos, vel, lengths = fluid_arrays(n, 0.4, 0, kT=1.0)
    runs = []
    for mesh in (cpu_mesh(2), None):
        model = TMappedEps(96)
        model.compile(loss="mse")
        sim = htt.Simulation(dt=0.005, seed=0, mesh=mesh,
                             integrator=htt.md.NVT(kT=1.0, tau=0.5),
                             device=None if mesh else "cpu")
        sim.init_state(pos, lengths, velocities=vel)
        sim.add_force(htt.md.LennardJones(1.0, 1.0, r_cut=R_CUT))
        tfc = htt.tfcompute(model)
        tfc.enable_mapped_nlist(sim, torch_mapping(n))
        tfc.attach(sim, r_cut=R_CUT, nlist=nlist, train=True)
        if nlist == "cellwise":
            with pytest.raises(ValueError, match="mapped"):
                sim.run(1)
            return
        sim.run(2)
        assert len(tfc.loss_history) == 2
        assert np.all(np.isfinite(tfc.loss_history))
        assert float(sim.state.forces[n:].abs().max()) == 0.0
        runs.append((tfc.loss_history, np_(model.eps.value),
                     sim.state.positions))
    (l_s, w_s, p_s), (l_u, w_u, p_u) = runs
    assert l_s == l_u
    np.testing.assert_array_equal(w_s, w_u)
    assert not np.array_equal(w_s, [0.5, 0.1])
    assert torch.equal(p_s, p_u)
