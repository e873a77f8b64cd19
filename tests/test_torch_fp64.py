"""Double precision end to end in the port, against the JAX package run
in float64 (``jax_enable_x64``, the fixture of tests/test_fp64.py) and
against numpy float64 oracles, on the same numpy inputs.

Covers the port of each test of tests/test_fp64.py (the 64-particle
smoke, the PairModel, the generic SimModel's dtype and delta-limited
bound, time reversal on ``'n2'``, the repack round trip; the checkpoint
round trip is in tests/test_torch_serialize.py), the repairs float64
needed (``init_lattice(dtype=)``, the float64 repack, the sort method's
64-bit key, the log and the losses at the state's dtype), every neighbor
mode in float64 on the CPU, and each kernel's plain version in float64:
K1's LJ, proxy and generic forms, K2's moments, ``generic_reduce_bwd``
lane by lane and K3's selection.

Tolerances, relative to max|F| or max|g| unless said: forces against
the numpy oracle 1e-10 (the JAX bar, tests/test_fp64.py:80), the
PairModel 1e-9 and the generic SimModel 2e-5 (the JAX bars: nlist_rinv's
3e-6 displacement deltas limit the latter at any precision), time
reversal 1e-12 absolute, K2's moments rtol 1e-9 against the JAX XLA
contraction, ``generic_reduce_bwd`` 1e-10 lane by lane, K3's
displacements 1e-12 absolute, one train step's gradients 1e-8 against
JAX's float64 gradients, the log 1e-10 relative to JAX's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hoomd_tf_tpu as htf
from hoomd_tf_tpu.md.slots import SlotLayout as JLayout
from hoomd_tf_tpu.ops import cellwise as jcw
from hoomd_tf_tpu.ops import chebyshev as jch
from hoomd_tf_tpu.ops.pair_train import pair_train_forces as j_ptf
import hoomd_tf_tpu_torch as htt
from hoomd_tf_tpu_torch.interop import (build_model, load_jax_variables,
                                        state_from_numpy)
from hoomd_tf_tpu_torch.md.slots import SlotLayout as TLayout
from hoomd_tf_tpu_torch.ops import cell_list as tcl
from hoomd_tf_tpu_torch.ops import cellwise as tcw
from hoomd_tf_tpu_torch.ops import cellwise_cuda as tcc
from hoomd_tf_tpu_torch.ops import chebyshev as tch
from hoomd_tf_tpu_torch.ops import nlist_cuda as tnc
from hoomd_tf_tpu_torch.ops import pair_train_cuda as tptc

from torch_helpers import (fluid_arrays, force_loss, jax_state_numpy, np_,
                           seed_jax_weights)

F64 = torch.float64


@pytest.fixture(autouse=True)
def x64():
    """Enable x64 for the JAX side of this module; restore the suite
    default after."""
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def lj_oracle(pos, lengths, r_cut):
    """Dense numpy float64 LJ forces (minimum image), tests/test_fp64.py's
    oracle."""
    pos = np.asarray(pos, dtype=np.float64)
    L = np.asarray(lengths, dtype=np.float64)
    d = pos[None, :, :] - pos[:, None, :]
    d = d - np.round(d / L) * L
    r2 = np.sum(d * d, axis=-1)
    np.fill_diagonal(r2, np.inf)
    mask = r2 <= r_cut * r_cut
    inv = np.where(mask, 1.0 / r2, 0.0)
    sr6 = inv ** 3
    s = np.where(mask, -12.0 * (2.0 * sr6 - 1.0) * sr6 / r2, 0.0)
    return 2.0 * np.sum(s[:, :, None] * d, axis=1)


def assert_oracle(f, pos, lengths, r_cut, bound):
    ref = lj_oracle(np_(pos), np_(lengths), r_cut)
    err = np.abs(np_(f)[:, :3] - ref).max()
    assert err < bound * np.abs(ref).max(), err / np.abs(ref).max()


class TLJPair(htt.PairModel):
    def pair_energy(self, r2):
        u = 1.0 / r2
        sr6 = u * u * u
        return 4.0 * (sr6 * sr6 - sr6)


class JLJPair(htf.PairModel):
    def pair_energy(self, r2):
        u = 1.0 / r2
        sr6 = u * u * u
        return 4.0 * (sr6 * sr6 - sr6)


def _exact_energy(nlist, xp, where, total):
    """LJ from the list's own r2 (no nlist_rinv deltas), zero on padding:
    exact forces by autodiff, in either package."""
    r2 = (nlist.r2() if hasattr(nlist, "r2") else
          total(nlist[..., :3] ** 2, -1))
    inside = r2 > 0
    inv = where(inside, 1.0 / where(inside, r2, xp.ones_like(r2)), 0.0)
    sr6 = inv ** 3
    return total(2.0 * (sr6 * sr6 - sr6), 1)


class TExactLJ(htt.SimModel):
    def compute(self, nlist, positions, box):
        e = _exact_energy(nlist, torch, torch.where,
                          lambda a, d: torch.sum(a, dim=d))
        return htt.compute_nlist_forces(nlist, e)


class JExactLJ(htf.SimModel):
    def compute(self, nlist, positions, box):
        e = _exact_energy(nlist, jnp, jnp.where,
                          lambda a, d: jnp.sum(a, axis=d))
        return htf.compute_nlist_forces(nlist, e)


class TRinvLJ(htt.SimModel):
    def compute(self, nlist, positions, box):
        rinv = htt.nlist_rinv(nlist)
        inv6 = rinv ** 6
        e = torch.sum(2.0 * (inv6 * inv6 - inv6), dim=1)
        return htt.compute_nlist_forces(nlist, e)


def fluid64(n=216, density=0.35, seed=3, integrator=None, kT=0.8):
    """The port's tests/test_fp64.py::_fluid64: a float64 lattice jittered
    by 0.2 from a numpy seed, on the CPU."""
    sim = htt.Simulation(dt=0.004, integrator=integrator or htt.md.NVE(),
                         seed=seed, device="cpu")
    sim.init_lattice(n, density=density, kT_init=kT, dtype=F64)
    rng = np.random.RandomState(seed)
    sim.set_state(dataclasses.replace(
        sim.state, positions=sim.state.positions + 0.2 * torch.as_tensor(
            rng.uniform(-1, 1, (n, 3)))))
    assert sim.state.positions.dtype == F64
    return sim


def lengths_of(sim):
    return np_(sim.state.box[1] - sim.state.box[0])


# ---------------------------------------------------------------------------
# The repairs
# ---------------------------------------------------------------------------

def test_init_lattice_dtype():
    """``init_lattice(dtype=)`` and ``init_state(dtype=)`` as in JAX, with
    float32 the default."""
    sim = htt.Simulation(device="cpu")
    st = sim.init_lattice(64, density=0.3, kT_init=1.0, dtype=F64)
    for t in (st.positions, st.velocities, st.masses, st.box, st.forces,
              st.virial):
        assert t.dtype == F64
    assert st.types.dtype == torch.int32
    assert sim.init_lattice(64, density=0.3).positions.dtype == \
        torch.float32
    pos, lengths = htt.md.state.lattice_positions(27, density=0.3)
    assert sim.init_state(pos, lengths, dtype=F64).positions.dtype == F64


def test_rebuild_roundtrip():
    """tests/test_fp64.py::TestRepackF64: a float64 repack moves every
    column exactly (the int columns ride beside the float block) and
    keeps the slot invariants."""
    sim = fluid64(n=343, density=0.3)
    state = dataclasses.replace(
        sim.state, types=torch.as_tensor(np.arange(343) % 3,
                                         dtype=torch.int32),
        masses=torch.as_tensor(1.0 + 0.1 * (np.arange(343) % 5),
                               dtype=F64))
    lengths = lengths_of(sim)
    lo = np_(state.box[0])
    plan = tcw.plan_cellwise(343, lengths, 2.5, positions=np_(
        state.positions), lo=lo)
    layout = TLayout(plan, 343, lo, dtype=F64, device="cpu")
    slot, aux = layout.pack(state)
    assert slot.positions.dtype == F64
    rng = np.random.RandomState(0)
    moved = dataclasses.replace(
        slot, positions=slot.positions + 0.05 * torch.as_tensor(
            rng.uniform(-1, 1, tuple(slot.positions.shape))),
        forces=torch.as_tensor(rng.randn(plan.n_slots, 4)),
        virial=torch.as_tensor(rng.randn(plan.n_slots, 3, 3)))
    new, new_aux = layout.rebuild(moved, aux)
    assert new.positions.dtype == F64 and new.forces.dtype == F64
    assert not bool(new_aux["overflow"])
    orig_old, orig_new = np_(aux["orig"]), np_(new_aux["orig"])
    real = orig_new < 343
    assert sorted(orig_new[real]) == sorted(orig_old[orig_old < 343])
    at = {int(o): i for i, o in enumerate(orig_old) if o < 343}
    j = np.array([at[int(o)] for o in orig_new[real]])
    for name in ("positions", "velocities", "masses", "types", "forces",
                 "virial"):
        np.testing.assert_array_equal(np_(getattr(new, name))[real],
                                      np_(getattr(moved, name))[j], name)
    ghost = ~real
    assert not np_(new.velocities)[ghost].any()
    assert not np_(new.forces)[ghost].any()


def test_sort_key_float64_and_float32_order():
    """The sort method's key: the int64 bits of a float64 ``d2`` (the
    float32 view broke on float64), the same neighbors in the same order
    as a float64 ``d2`` ranking; a float32 list keeps its order."""
    pos, _, lengths = fluid_arrays(400, 0.35, 4)
    types = (np.arange(400) % 2).astype(np.float64)
    pos4 = np.concatenate([pos, types[:, None]], axis=1)
    nl = tcl.cell_list_nlist(torch.as_tensor(pos4, dtype=F64), 2.5, 48,
                             torch.as_tensor(lengths, dtype=F64),
                             device="cpu")
    assert nl.dtype == F64
    want = dense_ranking(pos4, lengths, 2.5, 48)
    np.testing.assert_array_equal(np_(nl)[..., 3], want[..., 3])
    np.testing.assert_allclose(np_(nl), want, rtol=0, atol=1e-12)
    nl32 = tcl.cell_list_nlist(torch.as_tensor(pos4, dtype=torch.float32),
                               2.5, 48, torch.as_tensor(lengths),
                               device="cpu")
    assert nl32.dtype == torch.float32
    d2 = np.sum(np_(nl32)[..., :3].astype(np.float64) ** 2, -1)
    d2 = np.where(d2 > 0, d2, np.inf)
    assert np.all(np.diff(d2, axis=1)[np.isfinite(d2[:, 1:])] >= -1e-5)


def dense_ranking(pos4, lengths, r_cut, NN):
    """numpy float64: each particle's neighbors within the cut, nearest
    first (ties by index), as ``(dx, dy, dz, type)``, zero padded."""
    pos = np.asarray(pos4[:, :3], np.float64)
    L = np.asarray(lengths, np.float64)
    d = pos[None, :, :] - pos[:, None, :]
    d = d - np.round(d / L) * L
    d2 = np.sum(d * d, -1)
    n = len(pos)
    out = np.zeros((n, NN, 4))
    for i in range(n):
        ok = np.nonzero((d2[i] <= r_cut * r_cut) & (d2[i] >= 25e-8))[0]
        ok = ok[np.lexsort((ok, d2[i, ok]))][:NN]
        out[i, :len(ok), :3] = d[i, ok]
        out[i, :len(ok), 3] = pos4[ok, 3]
    return out


# ---------------------------------------------------------------------------
# tests/test_fp64.py, ported
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stencil", ["auto", "kernel"])
def test_smoke_small_lj_matches_numpy_oracle(stencil):
    """64 particles, built-in LJ at r_cut 1.9 on ``'cellwise'``: the
    tensor form, and with ``stencil='kernel'`` K1's plain version (its
    LJ form, once 2.4e-8 off: float32 tables), against the oracle at
    1e-10 max|F|."""
    sim = fluid64(n=64, density=0.3)
    sim.stencil = stencil
    sim.add_force(htt.md.LennardJones(epsilon=1.0, sigma=1.0, r_cut=1.9))
    sim.run(1)
    assert sim._layout is not None, "cellwise path did not engage"
    assert sim.state.forces.dtype == F64
    assert_oracle(sim.state.forces, sim.state.positions, lengths_of(sim),
                  1.9, 1e-10)


@pytest.mark.parametrize("stencil", ["auto", "kernel"])
def test_pair_model_forces_f64(stencil):
    """A PairModel on ``'cellwise'`` keeps float64 end to end: 1e-9
    max|F| (the tensor form; ``'kernel'``: K1's generic form's plain
    version, whose list once held float32 r2)."""
    sim = fluid64()
    sim.stencil = stencil
    tfc = htt.tfcompute(TLJPair(64, dtype=F64))
    tfc.attach(sim, r_cut=2.5, nlist="cellwise")
    sim.run(1)
    f = tfc.get_forces_array()
    assert f.dtype == np.float64
    assert_oracle(f, sim.state.positions, lengths_of(sim), 2.5, 1e-9)


def test_generic_model_dtype_propagates():
    """A generic SimModel on ``nlist_rinv`` keeps float64 through the
    driver; its values are delta-limited (2e-5 max|F|)."""
    sim = fluid64()
    tfc = htt.tfcompute(TRinvLJ(64, dtype=F64))
    tfc.attach(sim, r_cut=2.5, nlist="cellwise")
    sim.run(1)
    f = tfc.get_forces_array()
    assert f.dtype == np.float64
    assert_oracle(f, sim.state.positions, lengths_of(sim), 2.5, 2e-5)


def test_time_reversal_at_double_precision():
    """Velocity Verlet on ``'n2'`` run forward 60 steps, the velocities
    flipped, 60 back: the positions return below 1e-12 (float32: ~1e-5)."""
    sim = fluid64(kT=0.5)
    tfc = htt.tfcompute(TLJPair(64, dtype=F64))
    tfc.attach(sim, r_cut=2.5, nlist="n2")
    sim.run(30)
    p0 = np_(sim.state.positions).copy()
    sim.run(60)
    sim.set_state(dataclasses.replace(sim.state,
                                      velocities=-sim.state.velocities))
    sim.run(60)
    L = lengths_of(sim)
    d = np_(sim.state.positions) - p0
    d = d - np.round(d / L) * L
    assert np.abs(d).max() < 1e-12, np.abs(d).max()


# ---------------------------------------------------------------------------
# Every route in float64, against the oracle and JAX's float64 'n2'
# ---------------------------------------------------------------------------

def jax_n2_forces(pos, vel, lengths):
    """JAX's float64 ``'n2'`` forces of the exact-r LJ SimModel after one
    step, and the positions (JAX's own ``'cell'`` raises in float64: its
    sort key is a 32-bit bitcast)."""
    js = htf.md.state.init_state(pos, lengths, velocities=vel,
                                 dtype=jnp.float64)
    jsim = htf.Simulation(dt=0.004, integrator=htf.md.NVE())
    jsim.set_state(js)
    tfc = htf.tfcompute(JExactLJ(64, dtype=jnp.float64))
    tfc.attach(jsim, r_cut=2.5, nlist="n2")
    jsim.run(1)
    return np.asarray(tfc.get_forces_array()), np.asarray(
        jsim.state.positions)


@pytest.mark.parametrize("nlist", ["cellwise", "cell", "pallas", "direct"])
def test_routes_in_float64(nlist):
    """Each neighbor route runs a float64 state on the CPU (``'cell'``:
    the sort method's 64-bit key; ``'pallas'``: K3's plain version in
    float64): one step's forces against the numpy oracle at 1e-10 max|F|
    and against JAX's float64 ``'n2'`` from the same state at 1e-10."""
    pos, vel, lengths = fluid_arrays(216, 0.35, 3, kT=0.8)
    pos, vel = pos.astype(np.float64), vel.astype(np.float64)
    want, jpos = jax_n2_forces(pos, vel, lengths)
    sim = htt.Simulation(dt=0.004, integrator=htt.md.NVE(), device="cpu")
    sim.init_state(pos, lengths, velocities=vel, dtype=F64)
    model = (TLJPair(64, dtype=F64) if nlist == "cellwise" else
             TExactLJ(64, dtype=F64))
    tfc = htt.tfcompute(model)
    tfc.attach(sim, r_cut=2.5, nlist=nlist)
    sim.run(1)
    f = tfc.get_forces_array()
    assert f.dtype == np.float64
    np.testing.assert_allclose(np_(sim.state.positions), jpos, rtol=0,
                               atol=1e-13)
    assert_oracle(f, sim.state.positions, lengths, 2.5, 1e-10)
    scale = np.abs(want).max()
    assert np.abs(np_(f)[:, :3] - want[:, :3]).max() < 1e-10 * scale


def test_log_matches_jax_in_float64():
    """``sim.log`` of a float64 run keeps float64 and matches JAX's
    float64 log at 1e-10 relative (a float32 log is ~1e-7 off)."""
    pos, vel, lengths = fluid_arrays(216, 0.35, 5, kT=0.8)
    js = htf.md.state.init_state(pos, lengths, velocities=vel,
                                 dtype=jnp.float64)
    jsim = htf.Simulation(dt=0.004, integrator=htf.md.NVT(kT=0.8, tau=0.5))
    jsim.set_state(js)
    htf.tfcompute(JLJPair(64, dtype=jnp.float64)).attach(
        jsim, r_cut=2.5, nlist="cellwise")
    jsim.run(20, log_period=5)
    tsim = htt.Simulation(dt=0.004, integrator=htt.md.NVT(kT=0.8, tau=0.5),
                          device="cpu")
    tsim.set_state(state_from_numpy(jax_state_numpy(js), device="cpu"))
    assert tsim.state.positions.dtype == F64
    htt.tfcompute(TLJPair(64, dtype=F64)).attach(tsim, r_cut=2.5,
                                                 nlist="cellwise")
    tsim.run(20, log_period=5)
    np.testing.assert_array_equal(tsim.log["step"],
                                  np.asarray(jsim.log["step"]))
    for k in ("kinetic_energy", "potential_energy", "temperature",
              "pressure"):
        got, want = tsim.log[k], np.asarray(jsim.log[k])
        assert got.dtype == np.float64, k
        np.testing.assert_allclose(got, want, rtol=1e-10, err_msg=k)


# ---------------------------------------------------------------------------
# The kernels' plain versions in float64
# ---------------------------------------------------------------------------

def packed64(n=300, density=0.35, seed=7, typed=False):
    """The same float64 fluid packed by both packages on one plan."""
    pos, vel, lengths = fluid_arrays(n, density, seed)
    pos, vel = pos.astype(np.float64), vel.astype(np.float64)
    types = (np.arange(n) % 2) if typed else None
    js = htf.md.state.init_state(pos, lengths, types=types, velocities=vel,
                                 dtype=jnp.float64)
    ts = htt.md.state.init_state(pos, lengths, types=types, velocities=vel,
                                 dtype=F64, device="cpu")
    lo = np.asarray(js.box[0])
    plan = tcw.plan_cellwise(n, lengths, 2.5, positions=pos, lo=lo,
                             width_blocks=14)
    jplan = jcw.plan_cellwise(n, lengths, 2.5, positions=pos, lo=lo,
                              width_blocks=14)
    assert (plan.grid, plan.capacity) == (jplan.grid, jplan.capacity)
    jl = JLayout(jplan, n, lo)
    jslot, jaux, _ = jl.pack(js)
    tl = TLayout(plan, n, lo, dtype=F64, device="cpu")
    tslot, taux = tl.pack(ts)
    np.testing.assert_array_equal(np_(taux["orig"]), np_(jaux["orig"]))
    return (jl, jslot, jaux), (tl, tslot, taux), pos, lengths


def k1_args(t):
    tl, tslot, taux = t
    return (tslot.positions, tslot.types, taux["valid"], tl.plan, tl.lo)


def slot_forces(t, f4):
    tl, _, taux = t
    return np_(tl.to_particles(f4, taux))


def lj_slope(r2):
    u = 1.0 / r2
    sr6 = u * u * u
    return 4.0 * (sr6 * sr6 - sr6), -12.0 * (2.0 * sr6 - 1.0) * sr6 * u


def test_k1_lj_and_generic_forms_plain():
    """K1's LJ form and generic form, plain versions in float64 (the
    generic form's list holds float64 r2, and the pair function's (U, s)
    stay float64): against the oracle at 1e-10 max|F|, the virial and
    energy against JAX's float64 half-stencil form at 1e-10."""
    j, t, pos, lengths = packed64()
    jl, jslot, jaux = j
    want = jcw.analytic_pair_forces(
        jslot.positions, jslot.types, jaux["valid"], jl.plan, jl.lo,
        lj_slope, needs_virial=True, stencil="half")
    form = htt.md.LennardJones(r_cut=2.5).kernel_form()
    lanes = tcc.LaneBudget(tcc.lane_budget(t[0].plan, 300), "cpu")
    for got in (tcc.half_stencil_pair_forces(*k1_args(t), form,
                                             needs_virial=True),
                tcc.generic_pair_forces(*k1_args(t), lj_slope,
                                        typed_fn=False, needs_virial=True,
                                        lanes=lanes)):
        assert got[0].dtype == F64 and got[1].dtype == F64
        assert_oracle(slot_forces(t, got[0]), pos, lengths, 2.5, 1e-10)
        for a, b in ((got[0], want[0]), (got[1], want[1])):
            scale = np.abs(np.asarray(b)).max()
            assert np.abs(np_(a) - np.asarray(b)).max() < 1e-10 * scale
    assert tcc.half_stencil_pair_forces.launches == 0
    assert tcc.generic_pair_forces.launches == 0


def proxy_parts64():
    """The same float64 Chebyshev proxy of an LJ-like energy in both
    packages: ``(jax evaluator, jax coefficients, port evaluator, port
    coefficients)``."""
    r2_lo = (0.25 * 2.5) ** 2

    def energy(r2):
        u = 1.0 / r2
        return (u * u - 2.0 * u) / (1.0 + u * u)

    jfit, jev = jch.make_pair_proxy(16, r2_lo, 2.5 ** 2, dtype=jnp.float64)
    tfit, tev = tch.make_pair_proxy(16, r2_lo, 2.5 ** 2, dtype=F64,
                                    device="cpu")
    return jev, jfit(lambda r2: (energy(r2), None)), tev, tfit(energy)


def test_k1_proxy_form_plain():
    """K1's proxy form, plain version: a float64 table (once rounded to
    float32) against JAX's float64 half-stencil form of the same proxy at
    1e-10 max|F|."""
    j, t, _, _ = packed64()
    jl, jslot, jaux = j
    jev, jc, tev, tc = proxy_parts64()
    form = tev.kernel_form(tc)
    assert form.table.dtype == F64
    got = tcc.half_stencil_pair_forces(*k1_args(t), form, needs_virial=True)
    want = jcw.analytic_pair_forces(
        jslot.positions, jslot.types, jaux["valid"], jl.plan, jl.lo,
        lambda r2: jev(jc, r2), needs_virial=True, stencil="half")
    for a, b in zip(got, want):
        scale = np.abs(np.asarray(b)).max()
        assert np.abs(np_(a) - np.asarray(b)).max() < 1e-10 * scale


@pytest.mark.parametrize("energy", [True, False])
def test_k2_moments_plain(energy):
    """K2's plain version in float64 against the JAX package's float64
    proxy backward (its XLA lane contraction) at rtol 1e-9."""
    j, t, _, _ = packed64()
    jl, jslot, jaux = j
    tl, tslot, taux = t
    jev, jc, tev, tc = proxy_parts64()
    ct = np.random.RandomState(5).randn(tl.plan.n_slots, 4)
    if not energy:
        ct[:, 3] = 0.0
    g_c, g_cd = tptc.proxy_bwd_moments(
        tslot.positions, tslot.types, taux["valid"], torch.as_tensor(ct),
        tl.plan, tl.lo, tev.basis, needs_energy=energy)
    assert g_c.dtype == F64

    def primal(c):
        return j_ptf(c, jev, jslot.positions, jslot.types, jaux["valid"],
                     jl.plan, jl.lo, needs_energy=energy,
                     fwd_stencil="full", bwd_impl="xla")
    _, vjp = jax.vjp(primal, jc)
    gj = vjp(jnp.asarray(ct))[0]
    got = np.concatenate([np_(g_c), np_(g_cd)])
    want = np.concatenate([np.asarray(gj["c"]), np.asarray(gj["cd"])])
    np.testing.assert_allclose(got, want, rtol=1e-9,
                               atol=1e-9 * np.abs(want).max())


@pytest.mark.parametrize("energy", [True, False])
def test_generic_reduce_bwd_plain_lane_by_lane(energy):
    """``generic_reduce_bwd_plain`` in float64, lane by lane at 1e-10:
    against autograd through the reduction's plain version, and against
    the JAX contraction's Newton-combined lane weights written out in
    numpy (``wF = 2 (ct_i - [directed] ct_j) . d``, ``wE = 0.5 (cte_i +
    [directed] cte_j)``, ct folded with ``valid``)."""
    _, t, _, _ = packed64()
    tl, tslot, taux = t
    plan = tl.plan
    lst = tcc.generic_list_plain(tslot.positions, tslot.types, taux["valid"],
                                 plan, tl.lo)
    assert lst["r2"].dtype == F64
    ct = torch.as_tensor(np.random.RandomState(2).randn(plan.n_slots, 4))
    n = lst["r2"].shape[0]
    rng = np.random.RandomState(1)
    U = torch.tensor(rng.randn(n), requires_grad=True)
    S = torch.tensor(rng.randn(n), requires_grad=True)
    f4, _ = tcc.generic_reduce_plain(lst, U, S, taux["valid"], plan, energy)
    gU_a, gS_a = torch.autograd.grad(torch.sum(f4 * ct), [U, S],
                                     allow_unused=True)
    gU, gS = tcc.generic_reduce_bwd_plain(lst, ct, taux["valid"], plan,
                                          energy)
    assert gS.dtype == F64
    cap = plan.capacity
    ctv = np_(ct) * np_(taux["valid"])[:, None]
    cell, row, col = (np_(lst[k]) for k in ("cell", "row", "col"))
    t_blk = col // cap
    cand = np_(tcc._shifted_cells(lst["cell"], torch.as_tensor(t_blk),
                                  plan)) * cap + col % cap
    d = np.stack([np_(lst[k]) for k in ("dx", "dy", "dz")], -1)
    ci, cj = ctv[cell * cap + row], ctv[cand] * (t_blk >= 1)[:, None]
    wF = 2.0 * np.sum((ci[:, :3] - cj[:, :3]) * d, -1)
    wE = 0.5 * (ci[:, 3] + cj[:, 3])
    for got, want in ((gS, gS_a), (gS, wF)) + (
            ((gU, gU_a), (gU, wE)) if energy else ()):
        want = np_(want)
        assert np.abs(np_(got) - want).max() < 1e-10 * np.abs(want).max()
    if not energy:
        assert gU is None


def test_k3_plain_float64():
    """K3's plain version in float64 (the int64 key of d2's bits): the
    same neighbors in the same order as a numpy float64 ``d2`` ranking,
    the displacements within 1e-12."""
    pos, _, lengths = fluid_arrays(400, 0.35, 6)
    pos4 = np.concatenate([pos.astype(np.float64),
                           (np.arange(400) % 2)[:, None]], axis=1)
    p4 = torch.as_tensor(pos4, dtype=F64)
    grid, cap = tcl.plan(400, lengths, 2.5)
    slots4, counts, pid, over = tcl.build_planes(
        p4, grid, cap, torch.as_tensor(lengths, dtype=F64))
    assert not bool(over)
    got = tnc.nlist_select(slots4, counts, pid, grid, cap, 48, 2.5,
                           tuple(float(v) for v in lengths), 400)
    assert got.dtype == F64 and tnc.nlist_select.launches == 0
    want = dense_ranking(pos4, lengths, 2.5, 48)
    np.testing.assert_array_equal(np_(got)[..., 3], want[..., 3])
    np.testing.assert_allclose(np_(got), want, rtol=0, atol=1e-12)
    key, d2 = tnc.selection_keys(*(torch.as_tensor(want[..., a])
                                   for a in range(3)), 2.5, 10)
    assert key.dtype == torch.int64 and d2.dtype == F64


def test_k3_thresholds_float64():
    """K3's minimum-image thresholds in float64 reproduce ``d - round(d /
    L) * L`` bit for bit, as the float32 ones do in float32."""
    L = 17.3
    th = tnc.image_thresholds(L, F64)
    assert all(isinstance(t, np.float64) for t in th)
    d = torch.as_tensor(np.random.RandomState(0).uniform(-2.2 * L, 2.2 * L,
                                                         200000))
    d = torch.cat([d, torch.as_tensor([float(t) for t in th]),
                   torch.as_tensor([0.5 * L, -0.5 * L, 1.5 * L, 0.0])])
    Lt = torch.tensor(L, dtype=F64)
    got = tnc.threshold_min_image(d, Lt, th)
    want = d - torch.round(d / Lt) * Lt
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# Training in float64
# ---------------------------------------------------------------------------

class JNNPair(htf.PairModel):
    """north_star.py's TrainableNNPair (JAX), its layers in float64."""

    def setup(self):
        self.dense1 = htf.Dense(16, dtype=jnp.float64)
        self.last = htf.Dense(1, dtype=jnp.float64)

    def pair_energy(self, r2):
        x = jax.nn.tanh(self.dense1(jax.lax.rsqrt(r2)[..., None]))
        return 2.0 * self.last(x)[..., 0]


class TNNPair(htt.PairModel):
    """The same in the port."""

    def setup(self):
        self.dense1 = htt.Dense(16, dtype=F64)
        self.last = htt.Dense(1, dtype=F64)

    def pair_energy(self, r2):
        x = torch.tanh(self.dense1(torch.rsqrt(r2)[..., None]))
        return 2.0 * self.last(x)[..., 0]


def j_force_loss(yt, yp):
    return jnp.mean((yt[:, :3] - yp[:, :3]) ** 2)


@pytest.mark.parametrize("row", ["proxy", "pair"])
def test_one_train_step_matches_jax(row):
    """One float64 SGD step (lr 1) of the proxy row (its backward K2's
    plain version, which float64 now takes) and of the pair row (the lane
    contraction) from the same state and weights: the loss at 1e-10
    relative, kept at float64, and the weights' gradients against JAX's
    float64 ones at 1e-8 max|g|. (``stencil='kernel'`` would cost the
    plan at K1's 14-block width, another capacity than JAX's, and the
    loss averages over slot rows, ghosts included.)"""
    degree = 16 if row == "proxy" else None
    pos, vel, lengths = fluid_arrays(216, 0.4, 1, kT=1.5)
    js = htf.md.state.init_state(pos, lengths, velocities=vel,
                                 dtype=jnp.float64)
    jsim = htf.Simulation(dt=0.005, integrator=htf.md.NVT(kT=1.5, tau=0.5))
    jsim.set_state(js)
    jsim.add_force(htf.md.LennardJones(r_cut=2.5))
    jm = JNNPair(64, output_forces=False, proxy_degree=degree,
                 dtype=jnp.float64)
    jm.pair_energy(jnp.ones(4, jnp.float64))
    seed_jax_weights(jm, 0)
    jm.compile(optimizer="sgd", loss=j_force_loss, learning_rate=1.0)
    jtfc = htf.tfcompute(jm)
    jtfc.attach(jsim, r_cut=2.5, nlist="cellwise", train=True)
    tsim = htt.Simulation(dt=0.005, integrator=htt.md.NVT(kT=1.5, tau=0.5),
                          device="cpu")
    tsim.set_state(state_from_numpy(jax_state_numpy(js), device="cpu"))
    tsim.add_force(htt.md.LennardJones(r_cut=2.5))
    tm = TNNPair(64, output_forces=False, proxy_degree=degree, dtype=F64)
    build_model(tm, 2.5, "cpu")
    load_jax_variables(tm, jm.get_weights())
    tm.compile(optimizer="sgd", loss=force_loss, learning_rate=1.0)
    ttfc = htt.tfcompute(tm)
    ttfc.attach(tsim, r_cut=2.5, nlist="cellwise", train=True)
    w0 = [np.asarray(w) for w in jm.get_weights()[2:]]
    assert all(w.dtype == np.float64 for w in w0)
    np.testing.assert_array_equal(np.concatenate([
        w.ravel() for w in tm.get_weights()[2:]]),
        np.concatenate([w.ravel() for w in w0]))
    jsim.run(1)
    tsim.run(1)
    assert tsim.train_steps == 1
    assert ttfc.loss_history[0] == pytest.approx(jtfc.loss_history[0],
                                                 rel=1e-10)
    g_j = [a - np.asarray(b) for a, b in zip(w0, jm.get_weights()[2:])]
    g_t = [a - b for a, b in zip(w0, tm.get_weights()[2:])]
    scale = max(np.abs(g).max() for g in g_j)
    for a, b in zip(g_t, g_j):
        assert a.dtype == np.float64
        assert np.abs(a - b).max() < 1e-8 * scale
    assert tptc.proxy_bwd_moments.launches == 0
    assert tcc.generic_reduce_bwd.launches == 0
