"""Mapped coarse-grained neighbor lists (``tfcompute.enable_mapped_nlist``)
on the port against the JAX package, from the same state
(``interop.state_from_numpy``): the beads' rows, types and positions,
the synthesized atom/bead cutoff matrix, the group separation in the
list, zero bead forces, one step's forces, the thermodynamics (the
beads count as degrees of freedom, as in the JAX package), and the
routes against each other.

The mapping is each package's own ``center_of_mass(pos4,
sparse_mapping(...), box)`` over groups of four consecutive atoms, bead
type 0.

Tolerances: bead positions atol 1e-5 (tests/test_driver.py's), one
step's forces atol 1e-4 (the port's parity bar, tests/test_torch_packed.
py), mapped 'cell' against dense at rtol 2e-4, atol 2e-5
(tests/test_typed_rcut.py's), 'cellwise' against 'cell' at rtol = atol
= 5e-4 (tests/test_cellwise.py's), a rolled-back run at atol 1e-5
(tests/test_torch_stochastic.py's).
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hoomd_tf_tpu as htf
import hoomd_tf_tpu_torch as htt
from hoomd_tf_tpu_torch.interop import state_from_numpy

from torch_helpers import fluid_arrays, jax_state, jax_state_numpy, np_

N, DENSITY, R_CUT, NN, GROUP = 512, 0.4, 3.0, 96, 4
POS_TOL = dict(rtol=0, atol=1e-5)
F_TOL = dict(rtol=0, atol=1e-4)


def groups(n, k=GROUP):
    return [list(range(k * i, k * i + k)) for i in range(n // k)]


def jax_mapping(n):
    op = htf.sparse_mapping([np.ones((1, GROUP)) / GROUP] * (n // GROUP),
                            groups(n))

    def mapping(pos4, box):
        com = htf.center_of_mass(pos4, op, box)
        return jnp.concatenate([com, jnp.zeros_like(com[:, :1])], axis=1)
    return mapping


def torch_mapping(n, device="cpu"):
    op = htt.sparse_mapping([np.ones((1, GROUP)) / GROUP] * (n // GROUP),
                            groups(n), device=device)

    def mapping(pos4, box):
        com = htt.center_of_mass(pos4, op, box)
        return torch.cat([com, torch.zeros_like(com[:, :1])], dim=1)
    return mapping


class JMapped(htf.SimModel):
    """Reference example 02's structure with LJ: forces from the atom
    rows' list, an RDF of the bead rows' list into a MeanTensor."""

    def setup(self):
        self.rdf = htf.MeanTensor()

    def compute(self, nlist, positions, box):
        aa, cg = self.mapped_nlist(nlist)
        rdf, _ = htf.compute_rdf(cg, [0.5, 3.0], nbins=20)
        self.rdf.update_state(rdf)
        inv_r6 = htf.nlist_rinv(aa) ** 6
        e = jnp.sum(4.0 / 2.0 * (inv_r6 * inv_r6 - inv_r6), axis=1)
        return htf.compute_nlist_forces(aa, e)


class TMapped(htt.SimModel):
    def setup(self):
        self.rdf = htt.MeanTensor()

    def compute(self, nlist, positions, box):
        aa, cg = self.mapped_nlist(nlist)
        rdf, _ = htt.compute_rdf(cg, [0.5, 3.0], nbins=20)
        self.rdf.update_state(rdf)
        inv_r6 = htt.nlist_rinv(aa) ** 6
        e = torch.sum(4.0 / 2.0 * (inv_r6 * inv_r6 - inv_r6), dim=1)
        return htt.compute_nlist_forces(aa, e)


def start_arrays(seed=0, n=N, kT=1.0):
    pos, vel, lengths = fluid_arrays(n, DENSITY, seed=seed, kT=kT)
    return pos, vel, lengths


def jax_sim(arrays, integrator=None):
    sim = htf.Simulation(dt=0.005, integrator=integrator or
                         htf.md.NVT(kT=1.0, tau=0.5), seed=0)
    sim.set_state(jax_state(*arrays))
    return sim


def torch_sim(arrays, integrator=None, state=None):
    """The port's simulation from the JAX state's arrays."""
    sim = htt.Simulation(dt=0.005, integrator=integrator or
                         htt.md.NVT(kT=1.0, tau=0.5), seed=0, device="cpu")
    if state is None:
        state = state_from_numpy(jax_state_numpy(jax_state(*arrays)),
                                 device="cpu")
    sim.set_state(state)
    return sim


def torch_mapped(arrays, nlist, model=None, capacity=None, **run_kw):
    """A mapped port simulation attached on ``nlist``."""
    sim = torch_sim(arrays)
    tfc = htt.tfcompute(model or TMapped(NN))
    aa, cg = tfc.enable_mapped_nlist(sim, torch_mapping(len(arrays[0])))
    if capacity is not None:
        nlist = htt.Cellwise(capacity=capacity)
    tfc.attach(sim, r_cut=R_CUT, nlist=nlist, **run_kw)
    return sim, tfc, aa, cg


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's mapped simulation: its rows after
    enable_mapped_nlist, its matrix, and the state after one step on
    'n2' and on 'cell'."""
    arrays = start_arrays()
    out = {}
    for mode in ("n2", "cell"):
        sim = jax_sim(arrays)
        tfc = htf.tfcompute(JMapped(NN))
        aa, cg = tfc.enable_mapped_nlist(sim, jax_mapping(N))
        mapped = jax_state_numpy(sim.state)
        tfc.attach(sim, r_cut=R_CUT, nlist=mode)
        sim.run(1)
        out[mode] = dict(aa=aa, cg=cg, mapped=mapped,
                         matrix=tfc.r_cut_matrix,
                         after=jax_state_numpy(sim.state),
                         thermo={k: float(v) for k, v in
                                 sim.thermo().items()},
                         nlist=tfc.get_nlist_array(),
                         rdf=np.asarray(sim.tfc.model.rdf.result()))
    return arrays, out


def wrapped(a, b, lengths):
    d = a - b
    return d - np.round(d / lengths) * lengths


@pytest.mark.parametrize("mode", ["n2", "cell"])
def test_enable_and_one_step_match_jax(mode, jax_run):
    """enable_mapped_nlist appends the same rows (bead positions within
    1e-5, types offset by max(type) + 1, zero velocities, unit masses),
    attach synthesizes the same matrix, and one step leaves the same
    positions (beads within 1e-5), forces (1e-4) and zero bead forces."""
    arrays, out = jax_run
    ref = out[mode]
    sim, tfc, aa, cg = torch_mapped(arrays, None)
    np.testing.assert_array_equal(aa, ref["aa"])
    np.testing.assert_array_equal(cg, ref["cg"])
    st = sim.state
    np.testing.assert_array_equal(np_(st.types), ref["mapped"]["types"])
    np.testing.assert_allclose(np_(st.positions)[N:],
                               ref["mapped"]["positions"][N:], **POS_TOL)
    assert float(st.velocities[N:].abs().max()) == 0.0
    np.testing.assert_array_equal(np_(st.masses)[N:], 1.0)
    tfc.attach(sim, r_cut=R_CUT, nlist=mode)
    np.testing.assert_array_equal(tfc.r_cut_matrix, ref["matrix"])
    assert tfc.r_cut_matrix[0, 1] == -1.0 and tfc.r_cut_matrix[1, 1] == R_CUT
    sim.run(1)
    after = ref["after"]
    lengths = arrays[2]
    np.testing.assert_allclose(
        wrapped(np_(sim.state.positions), after["positions"], lengths),
        0.0, **POS_TOL)
    got = np_(sim.state.forces)
    assert np.abs(after["forces"][:N, :3]).max() > 0.1
    np.testing.assert_allclose(got, after["forces"], **F_TOL)
    assert np.abs(got[N:]).max() == 0.0
    np.testing.assert_allclose(np_(tfc.model.rdf.result()), ref["rdf"],
                               rtol=1e-4, atol=1e-6)


def test_group_separation(jax_run):
    """No atom row lists a bead, and no bead row lists an atom: the
    neighbor type channel, as in the JAX package's list."""
    arrays, out = jax_run
    sim, tfc, _, _ = torch_mapped(arrays, "n2")
    sim.run(1)
    for nl in (tfc.get_nlist_array(), out["n2"]["nlist"]):
        listed = np.abs(nl[..., :3]).sum(-1) > 0
        assert not np.any(nl[:N][listed[:N]][:, 3] != 0)
        assert np.all(nl[N:][listed[N:]][:, 3] == 1)
        assert listed[N:].any() and listed[:N].any()


def test_thermo_matches_jax(jax_run):
    """The mapped state's thermodynamics equal the JAX package's: the
    bead rows count as degrees of freedom, dof = 3 (n + m) - 3 (the
    JAX package's md/thermo.py, a reference quirk the port keeps)."""
    arrays, out = jax_run
    sim, tfc, _, _ = torch_mapped(arrays, "n2")
    sim.run(1)
    th = sim.thermo()
    for k, v in out["n2"]["thermo"].items():
        np.testing.assert_allclose(th[k], v, rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    rows = sim.state.n_particles
    assert rows == N + N // GROUP
    np.testing.assert_allclose(
        th["temperature"], 2.0 * th["kinetic_energy"] / (3 * rows - 3),
        rtol=1e-6)


def test_langevin_kicks_beads_as_jax():
    """Langevin noise reaches the bead rows in the JAX package (its
    integrator acts on every row): the port follows it. The beads are
    repositioned by the mapping all the same."""
    arrays = start_arrays(n=256)
    jsim = jax_sim(arrays, htf.md.Langevin(kT=1.0, gamma=1.0))
    jtfc = htf.tfcompute(JMapped(NN))
    jtfc.enable_mapped_nlist(jsim, jax_mapping(256))
    jtfc.attach(jsim, r_cut=R_CUT, nlist="n2")
    jsim.run(2)
    tsim = torch_sim(arrays, htt.md.Langevin(kT=1.0, gamma=1.0))
    ttfc = htt.tfcompute(TMapped(NN))
    ttfc.enable_mapped_nlist(tsim, torch_mapping(256))
    ttfc.attach(tsim, r_cut=R_CUT, nlist="n2")
    tsim.run(2)
    jv = np.abs(np.asarray(jsim.state.velocities)[256:]).max()
    tv = float(tsim.state.velocities[256:].abs().max())
    assert jv > 0.0 and tv > 0.0
    assert np.abs(np_(tsim.state.forces)[256:]).max() == 0.0
    com = htt.center_of_mass(tsim.state.positions[:256],
                             torch_mapping_op(256), tsim._lengths)
    np.testing.assert_allclose(
        wrapped(np_(tsim.state.positions)[256:], np_(com), tsim._lengths),
        0.0, **POS_TOL)


def torch_mapping_op(n):
    return htt.sparse_mapping([np.ones((1, GROUP)) / GROUP] * (n // GROUP),
                              groups(n), device="cpu")


def test_mapped_cell_matches_dense():
    """Mapped 'cell' (the sort method: the synthesized matrix is a typed
    cut) against the dense build after one step, the JAX package's
    test_typed_rcut.py::test_mapped_cell_matches_dense on the port."""
    arrays = start_arrays(seed=3, n=600)
    res = {}
    for mode in ("n2", "cell"):
        sim, tfc, _, _ = torch_mapped(arrays, mode)
        sim.run(1)
        if mode == "cell":
            assert sim._packed_build().method == "sort"
        res[mode] = (np_(sim.state.forces), np_(sim.state.positions))
    np.testing.assert_allclose(res["cell"][0], res["n2"][0], rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(res["cell"][1], res["n2"][1], rtol=2e-4,
                               atol=2e-5)


def test_cellwise_matches_cell():
    """The 'cellwise' planes route (the model on particle-order planes,
    bead positions written into their slot rows) against 'cell' after
    one step and after five, at rtol = atol = 5e-4; the beads' rows stay
    the mapping of the atoms' and carry no force."""
    arrays = start_arrays(seed=5)
    res = {}
    for mode in ("cell", "cellwise"):
        sim, tfc, _, _ = torch_mapped(arrays, mode)
        sim.run(1)
        f1 = np_(sim.state.forces)
        sim.run(4)
        res[mode] = (f1, np_(sim.state.positions), np_(sim.state.forces),
                     np_(tfc.model.rdf.result()))
        if mode == "cellwise":
            assert tfc._lane_fast_ok is False
            assert not sim._kernel_eligible()
    a, b = res["cell"], res["cellwise"]
    assert np.abs(a[0][:N, :3]).max() > 0.1
    np.testing.assert_allclose(b[0], a[0], rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(b[2], a[2], rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(wrapped(b[1], a[1], arrays[2]), 0.0,
                               rtol=0, atol=5e-4)
    np.testing.assert_allclose(b[3], a[3], rtol=5e-4, atol=5e-4)
    assert np.abs(b[2][N:]).max() == 0.0
    com = htt.center_of_mass(torch.as_tensor(b[1][:N]),
                             torch_mapping_op(N), arrays[2])
    np.testing.assert_allclose(wrapped(b[1][N:], np_(com), arrays[2]),
                               0.0, **POS_TOL)


def test_cellwise_nlist_is_particle_order():
    """On 'cellwise' a mapped model's accessor list is the planes in
    particle order, as the model sees them (the JAX package's
    _build_nlist): atom rows list no bead."""
    arrays = start_arrays(seed=5)
    sim, tfc, _, _ = torch_mapped(arrays, "cellwise")
    sim.run(1)
    nl = tfc.get_nlist_array()
    assert nl.shape[0] == N + N // GROUP
    listed = np.abs(nl[..., :3]).sum(-1) > 0
    assert not np.any(nl[:N][listed[:N]][:, 3] != 0)
    assert np.all(nl[N:][listed[N:]][:, 3] == 1)


class TMappedEps(htt.SimModel):
    """A mapped LJ with a trainable energy scale on the atoms' rows and
    another on the beads', forces of every row (the loss compares them
    with the labels' rows)."""

    def setup(self):
        self.eps = htt.Variable([0.5, 0.1], name="eps")

    def compute(self, nlist, positions, box):
        parts = self.mapped_nlist(nlist)
        e = []
        for k, part in enumerate(parts):
            inv_r6 = htt.nlist_rinv(part) ** 6
            e.append(torch.sum(2.0 * self.eps.value[k] *
                               (inv_r6 * inv_r6 - inv_r6), dim=1))
        return htt.compute_nlist_forces(nlist, torch.cat(e))


@pytest.mark.parametrize("nlist", ["cellwise", "cell"])
def test_mapped_training(nlist):
    """Training a mapped model on 'cellwise' raises a ValueError naming
    the mapping, as in the JAX package; on 'cell' it trains, with the
    bead rows' net force zero."""
    arrays = start_arrays(n=256)
    model = TMappedEps(NN)
    model.compile(loss="mse")
    sim = torch_sim(arrays)
    sim.add_force(htt.md.LennardJones(1.0, 1.0, r_cut=R_CUT))
    tfc = htt.tfcompute(model)
    tfc.enable_mapped_nlist(sim, torch_mapping(256))
    tfc.attach(sim, r_cut=R_CUT, nlist=nlist, train=True)
    if nlist == "cellwise":
        with pytest.raises(ValueError, match="mapped"):
            sim.run(1)
        return
    sim.run(2)
    assert len(tfc.loss_history) == 2
    assert np.all(np.isfinite(tfc.loss_history))
    assert float(sim.state.forces[256:].abs().max()) == 0.0


class TMappedDense(htt.SimModel):
    """A mapped model with a lazily built Dense layer on the atom rows'
    list and a running mean of the bead positions, whose shape is the
    bead count: the driver builds both before training, on a list of
    the simulation's rows."""

    def setup(self):
        self.dense = htt.Dense(1)
        self.beads = htt.MeanTensor()

    def compute(self, nlist, positions, box):
        aa, _ = self.mapped_nlist(nlist)
        _, p_cg = self.mapped_positions(positions)
        self.beads.update_state(p_cg[:, :3])
        inv_r6 = htt.nlist_rinv(aa) ** 6
        e = torch.sum(self.dense(inv_r6[..., None])[..., 0], dim=1)
        e = torch.cat([e, torch.zeros_like(p_cg[:, 0])])
        return htt.compute_nlist_forces(nlist, e)


def test_mapped_training_builds_lazy_layers():
    """Training a mapped model whose layers are built lazily: the driver
    builds them on a zero list of the simulation's atoms and beads, so
    the bead mean has the beads' shape, and training runs."""
    arrays = start_arrays(n=256)
    model = TMappedDense(NN)
    model.compile(loss="mse")
    sim = torch_sim(arrays)
    sim.add_force(htt.md.LennardJones(1.0, 1.0, r_cut=R_CUT))
    tfc = htt.tfcompute(model)
    tfc.enable_mapped_nlist(sim, torch_mapping(256))
    tfc.attach(sim, r_cut=R_CUT, nlist="cell", train=True)
    assert model.dense.kernel is None
    sim.run(2)
    assert model.dense.kernel is not None
    assert tuple(model.beads.total.value.shape) == (256 // GROUP, 3)
    assert len(tfc.loss_history) == 2
    assert np.all(np.isfinite(tfc.loss_history))
    assert float(sim.state.forces[256:].abs().max()) == 0.0


def test_rolled_back_run_replays():
    """A mapped 'cellwise' run forced through a capacity-overflow
    rollback (capacity 3, then the replanned floor) ends where a run
    that needed none does, beads included."""
    arrays = start_arrays(seed=7)
    a, _, _, _ = torch_mapped(arrays, "cellwise")
    b, _, _, _ = torch_mapped(arrays, "cellwise", capacity=3)
    a.run(5)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        b.run(5)
    assert any("capacity 3 exceeded" in str(x.message) for x in w)
    np.testing.assert_allclose(np_(b.state.positions),
                               np_(a.state.positions), rtol=0, atol=1e-5)
    np.testing.assert_allclose(np_(b.state.forces), np_(a.state.forces),
                               rtol=0, atol=1e-4)


def test_carried_state_round_trip(jax_run):
    """The n + m rows the JAX package's enable_mapped_nlist leaves carry
    across (interop.state_from_numpy, types included) and run on the
    port's mapped model as on its own."""
    arrays, out = jax_run
    st = state_from_numpy(out["n2"]["mapped"], device="cpu")
    sim = torch_sim(arrays, state=st)
    model = TMapped(NN)
    # the model's mapping, without appending the rows again
    model._map_nlist, model._map_fxn, model._map_i = \
        True, torch_mapping(N), N
    tfc = htt.tfcompute(model)
    assert tfc.map_enabled
    tfc.attach(sim, r_cut=R_CUT, nlist="n2")
    np.testing.assert_array_equal(tfc.r_cut_matrix, out["n2"]["matrix"])
    sim.run(1)
    np.testing.assert_allclose(np_(sim.state.forces),
                               out["n2"]["after"]["forces"], **F_TOL)


def test_mapped_nlist_guards():
    """mapped_nlist and mapped_positions raise before
    enable_mapped_nlist, as in the JAX package, and split packed lists
    and planes by rows after it."""
    model = TMapped(8)
    with pytest.raises(ValueError, match="enable_mapped_nlist"):
        model.mapped_nlist(torch.zeros((4, 8, 4)))
    with pytest.raises(ValueError, match="enable_mapped_nlist"):
        model.mapped_positions(torch.zeros((4, 4)))
    model._map_nlist, model._map_i = True, 3
    aa, cg = model.mapped_nlist(torch.zeros((5, 8, 4)))
    assert aa.shape == (3, 8, 4) and cg.shape == (2, 8, 4)
    planes = htt.NlistPlanes(*(torch.zeros((5, 6)) for _ in range(4)))
    aa, cg = model.mapped_nlist(planes)
    assert aa.shape == (3, 6) and cg.dx.shape == (2, 6)
    p_aa, p_cg = model.mapped_positions(torch.zeros((5, 4)))
    assert p_aa.shape == (3, 4) and p_cg.shape == (2, 4)

