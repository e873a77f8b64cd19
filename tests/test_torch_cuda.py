"""Card-only checks of the port: kernel K1 (LJ and Chebyshev-proxy forms),
kernel K2 and kernel K3 against their plain versions, the step loops of
the cellwise and the packed paths free of host syncs, and online training
on the card against the CPU. Every test here
needs a CUDA device and
skips without one. This file imports no JAX, so it runs on the machine
with the card, where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py pins JAX to the CPU.) chip_smoke.py
runs the same checks at the 64k fluid's shapes."""

import dataclasses
import re

import numpy as np
import pytest
import torch

import hoomd_tf_tpu_torch as htt
from hoomd_tf_tpu_torch.md.slots import SlotLayout
from hoomd_tf_tpu_torch.ops import cellwise as tcw
from hoomd_tf_tpu_torch.ops import cellwise_cuda as tcc

from torch_helpers import cuda_device, fluid_arrays, np_, torch_state  # noqa

pytestmark = pytest.mark.requires_cuda

TOL = dict(rtol=1e-4, atol=1e-4)
RCM = np.array([[2.5, 1.8], [1.8, 2.2]], dtype=np.float32)


def packed(device, typed, capacity=None, n=500):
    pos, vel, lengths = fluid_arrays(n, 0.35, 7)
    types = (np.arange(n) % 2) if typed else None
    st = torch_state(pos, vel, lengths, types=types, device=device)
    lo = -lengths / 2
    plan = tcw.plan_cellwise(n, lengths, 2.5, positions=pos, lo=lo,
                             width_blocks=14)
    if capacity:
        plan = dataclasses.replace(plan, capacity=capacity)
    layout = SlotLayout(plan, n, lo, rc_matrix=RCM if typed else None,
                        device=device)
    slot, aux = layout.pack(st)
    return layout, slot, aux


@pytest.mark.parametrize("typed", [False, True])
@pytest.mark.parametrize("capacity", [None, 80, 200])
@pytest.mark.parametrize("flags", [(True, True), (False, False)])
def test_kernel_matches_plain(cuda_device, typed, capacity, flags):
    """K1's forces, energy and virial on the card against its plain
    version on the CPU, on the same inputs (capacity 80 and 200: 1120 and
    2800 slots staged in chunks of the thread block, and past 48 KB of
    shared memory at 200)."""
    energy, virial = flags
    pot = (htt.md.LennardJones([[1.0, 0.5], [0.5, 0.5]], 1.0, r_cut=2.5)
           if typed else htt.md.LennardJones(r_cut=2.5))
    form = pot.kernel_form()
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        layout, slot, aux = packed(dev, typed, capacity)
        before = tcc.half_stencil_pair_forces.launches
        f, w = tcc.half_stencil_pair_forces(
            slot.positions, slot.types, aux["valid"], layout.plan,
            layout.lo, form, needs_virial=virial, needs_energy=energy,
            rc2_tab=layout.rc2_tab, geometry=layout.geometry)
        assert tcc.half_stencil_pair_forces.launches - before == \
            (1 if dev.type == "cuda" else 0)
        outs.append((np_(f), None if w is None else np_(w)))
    np.testing.assert_allclose(outs[0][0], outs[1][0], **TOL)
    if virial:
        np.testing.assert_allclose(outs[0][1], outs[1][1], **TOL)


def test_wrapper_checks_inputs(cuda_device):
    layout, slot, aux = packed(cuda_device, False)
    plan = layout.plan
    form = htt.md.LennardJones(r_cut=2.5).kernel_form()
    args = [slot.positions, slot.types, aux["valid"], plan, layout.lo, form]
    bad = list(args)
    bad[0] = slot.positions.double()
    with pytest.raises(ValueError, match="float32"):
        tcc.half_stencil_pair_forces(*bad, geometry=layout.geometry)
    bad[0] = slot.positions.t().contiguous().t()
    with pytest.raises(ValueError, match="contiguous"):
        tcc.half_stencil_pair_forces(*bad, geometry=layout.geometry)
    bad = list(args)
    bad[1] = slot.types.long()
    with pytest.raises(ValueError, match="int32"):
        tcc.half_stencil_pair_forces(*bad, rc2_tab=tcw.rc2_table(
            RCM, device=cuda_device), geometry=layout.geometry)
    with pytest.raises(ValueError, match="LJ-family"):
        tcw.analytic_pair_forces(slot.positions, slot.types, aux["valid"],
                                 plan, layout.lo, None)


def test_valid_not_a_prefix_on_card(cuda_device):
    """Occupied slots that are not a prefix of their cell: K1 and K2 on
    the card against their plain versions on the CPU."""
    from hoomd_tf_tpu_torch.ops import pair_train_cuda as ptc
    from torch_helpers import hole_permutation
    form = htt.md.LennardJones([[1.0, 0.5], [0.5, 0.5]], 1.0,
                               r_cut=2.5).kernel_form()
    ev, _ = proxy_parts(True)
    ct = np.random.RandomState(2).randn(4096, 4).astype(np.float32)
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        layout, slot, aux = packed(dev, True)
        perm = hole_permutation(aux["valid"], layout.plan.capacity)
        state = (slot.positions[perm], slot.types[perm], aux["valid"][perm],
                 layout.plan, layout.lo)
        f, w = tcc.half_stencil_pair_forces(
            *state, form, needs_virial=True, rc2_tab=layout.rc2_tab,
            geometry=layout.geometry)
        ctt = torch.as_tensor(ct[:layout.plan.n_slots], device=dev)
        g = ptc.proxy_bwd_moments(*state[:3], ctt, *state[3:], ev.basis,
                                  rc2_tab=layout.rc2_tab,
                                  geometry=layout.geometry)
        outs.append((np_(f), np_(w), np.concatenate([np_(x).ravel()
                                                     for x in g])))
    np.testing.assert_allclose(outs[0][0], outs[1][0], **TOL)
    np.testing.assert_allclose(outs[0][1], outs[1][1], **TOL)
    scale = np.abs(outs[1][2]).max()
    np.testing.assert_allclose(outs[0][2], outs[1][2], rtol=2e-4,
                               atol=2e-5 * scale)


def test_dense_cells_more_rows_than_threads(cuda_device):
    """Cells of ~300 particles, more rows than the block's 256 threads:
    K1 (forces, energy, virial) and K2 (untyped, K = 16, moments in
    registers) on the card against their plain versions on the card."""
    from hoomd_tf_tpu_torch.ops import pair_train_cuda as ptc
    from hoomd_tf_tpu_torch.ops.chebyshev import make_pair_proxy
    n = 8000
    pos, vel, lengths = fluid_arrays(n, 11.0, 5, jitter=0.05)
    st = torch_state(pos, vel, lengths, device=cuda_device)
    plan = tcw.CellwisePlan((3, 3, 3), 360, tuple(float(v) for v in lengths),
                            2.5)
    layout = SlotLayout(plan, n, -lengths / 2, device=cuda_device)
    slot, aux = layout.pack(st)
    assert not bool(aux["overflow"])
    occ = aux["valid"].reshape(plan.n_cells, -1).sum(1)
    assert int(occ.max()) > 256
    # a soft LJ (sigma 0.3) over the 0.45 lattice spacing
    form = htt.md.LennardJones(1.0, 0.3, r_cut=2.5).kernel_form()
    state = (slot.positions, slot.types, aux["valid"], plan, layout.lo)
    kw = dict(needs_virial=True, geometry=layout.geometry)
    f_k, w_k = tcc.half_stencil_pair_forces(*state, form, **kw)
    f_p, w_p = tcc.half_stencil_plain(*state, form, **kw)
    np.testing.assert_allclose(np_(f_k), np_(f_p), **TOL)
    np.testing.assert_allclose(np_(w_k), np_(w_p), **TOL)
    fit, ev = make_pair_proxy(16, 0.3, 2.5 ** 2, device=cuda_device)
    ct = torch.as_tensor(np.random.RandomState(3).randn(
        plan.n_slots, 4).astype(np.float32), device=cuda_device)
    args = state[:3] + (ct,) + state[3:] + (ev.basis,)
    got = np.concatenate([np_(x) for x in ptc.proxy_bwd_moments(
        *args, needs_energy=False, geometry=layout.geometry)])
    want = np.concatenate([np_(x) for x in ptc.proxy_bwd_plain(
        *args, needs_energy=False, geometry=layout.geometry)])
    np.testing.assert_allclose(got, want, rtol=2e-4,
                               atol=2e-5 * np.abs(want).max())


class LJModel(htt.PairModel):
    """LJ (epsilon = sigma = 1, r_cut 3) declaring its kernel form."""

    def pair_energy(self, r2):
        return self.pair_kernel_form().pair_energy(r2)

    def pair_kernel_form(self):
        return htt.md.LennardJones(r_cut=3.0)


def test_run_has_no_host_sync(cuda_device):
    """The step loop makes no host sync (run under
    set_sync_debug_mode('error')), and every force evaluation of the main
    path launched K1."""
    sim = htt.Simulation(dt=0.005, integrator=htt.md.Minimize(0.05),
                         device=cuda_device)
    sim.init_lattice(4096, density=0.4, kT_init=1.5)
    sim.state.positions = sim.state.positions + torch.as_tensor(
        0.3 * np.random.RandomState(0).randn(4096, 3).astype(np.float32),
        device=cuda_device)
    tfc = htt.tfcompute(LJModel(64))
    tfc.attach(sim, r_cut=3.0, nlist="cellwise")
    sim.check_syncs = True
    before = tcc.half_stencil_pair_forces.launches
    sim.run(30)
    sim.thermalize_velocities(1.5)
    sim.integrator = htt.md.NVT(kT=1.5, tau=0.5)
    sim.run(200)
    assert tcc.half_stencil_pair_forces.launches - before == sim.force_evals
    assert np.isfinite(tfc.get_forces_array()).all()
    assert 0.8 < sim.thermo()["temperature"] < 2.5


# ---------------------------------------------------------------------------
# Online training: K1's Chebyshev-proxy form and kernel K2
# ---------------------------------------------------------------------------

def proxy_parts(typed, K=16, n_types=2, r_cut=2.5):
    """A fitted Chebyshev proxy of an LJ-like pair energy: ``(evaluate,
    coeffs)`` on the CPU (typed: ``n_types`` types, epsilon by pair)."""
    from hoomd_tf_tpu_torch.ops.chebyshev import (make_pair_proxy,
                                                  make_typed_pair_proxy)
    r2_lo, r2_hi = (0.25 * r_cut) ** 2, r_cut ** 2

    def lj(r2, eps=1.0):
        u = 1.0 / r2
        sr6 = u * u * u
        return 4.0 * eps * (sr6 * sr6 - sr6)

    if typed:
        fit, ev = make_typed_pair_proxy(K, r2_lo, r2_hi, n_types,
                                        device="cpu")
        coeffs = fit(lambda r2, ti, tj: lj(r2, 1.0 / (1.0 + ti + tj)))
    else:
        fit, ev = make_pair_proxy(K, r2_lo, r2_hi, device="cpu")
        coeffs = fit(lj)
    return ev, coeffs


def on(coeffs, device):
    return {k: v.to(device) for k, v in coeffs.items()}


def packed_types(device, n_types, n=500, rcm=None, capacity=None):
    pos, vel, lengths = fluid_arrays(n, 0.35, 7)
    st = torch_state(pos, vel, lengths, types=np.arange(n) % n_types,
                     device=device)
    lo = -lengths / 2
    plan = tcw.plan_cellwise(n, lengths, 2.5, positions=pos, lo=lo,
                             width_blocks=14)
    if capacity:
        plan = dataclasses.replace(plan, capacity=capacity)
    layout = SlotLayout(plan, n, lo, rc_matrix=rcm, device=device)
    slot, aux = layout.pack(st)
    return layout, slot, aux


@pytest.mark.parametrize("typed", [False, True])
@pytest.mark.parametrize("capacity", [None, 200])
@pytest.mark.parametrize("flags", [(True, True), (False, False)])
def test_proxy_form_matches_plain(cuda_device, typed, capacity, flags):
    """K1's Chebyshev-proxy form on the card against its plain version
    (``ChebForm.evaluate`` through the half-stencil tensor form) on the
    CPU."""
    energy, virial = flags
    ev, coeffs = proxy_parts(typed)
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        layout, slot, aux = packed(dev, typed, capacity)
        form = ev.kernel_form(on(coeffs, dev))
        before = tcc.half_stencil_pair_forces.launches
        f, w = tcc.half_stencil_pair_forces(
            slot.positions, slot.types, aux["valid"], layout.plan,
            layout.lo, form, needs_virial=virial, needs_energy=energy,
            rc2_tab=layout.rc2_tab, geometry=layout.geometry)
        assert tcc.half_stencil_pair_forces.launches - before == \
            (1 if dev.type == "cuda" else 0)
        outs.append((np_(f), None if w is None else np_(w)))
    np.testing.assert_allclose(outs[0][0], outs[1][0], **TOL)
    if virial:
        np.testing.assert_allclose(outs[0][1], outs[1][1], **TOL)


@pytest.mark.parametrize("case", ["untyped", "forces_only", "typed_rcut",
                                  "three_types"])
@pytest.mark.parametrize("capacity", [None, 200])
def test_proxy_backward_matches_plain(cuda_device, case, capacity):
    """Kernel K2 on the card against its plain version on the CPU (the JAX
    bar: rtol 2e-4, atol 2e-5 max|g|). Three types at K = 16 give
    2*K*P = 192 moments, above the Pallas kernel's 128-lane cap."""
    from hoomd_tf_tpu_torch.ops import pair_train_cuda as ptc
    n_types = {"untyped": 1, "forces_only": 1, "typed_rcut": 2,
               "three_types": 3}[case]
    rcm = RCM if case == "typed_rcut" else None
    ev, _ = proxy_parts(n_types > 1, n_types=n_types)
    energy = case != "forces_only"
    ct = np.random.RandomState(1).randn(4096, 4).astype(np.float32)
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        layout, slot, aux = packed_types(dev, n_types, rcm=rcm,
                                         capacity=capacity)
        ct_full = np.resize(ct, (layout.plan.n_slots, 4))
        ctt = torch.as_tensor(ct_full, device=dev)
        before = ptc.proxy_bwd_moments.launches
        g_c, g_cd = ptc.proxy_bwd_moments(
            slot.positions, slot.types, aux["valid"], ctt, layout.plan,
            layout.lo, ev.basis, rc2_tab=layout.rc2_tab,
            needs_energy=energy, geometry=layout.geometry)
        assert ptc.proxy_bwd_moments.launches - before == \
            (1 if dev.type == "cuda" else 0)
        outs.append(np.concatenate([np_(g_c).ravel(), np_(g_cd).ravel()]))
    assert outs[0].size == 2 * 16 * n_types * (n_types + 1) // 2
    if not energy:
        assert not outs[0][:16].any()
    scale = np.abs(outs[1]).max()
    np.testing.assert_allclose(outs[0], outs[1], rtol=2e-4,
                               atol=2e-5 * scale)


def test_training_on_the_card(cuda_device):
    """Online training of the proxy NN on the card: no host sync in the
    step loop, K2 launched once per train step, K1 once per force
    evaluation, and the loss trajectory of 20 SGD steps equal to the CPU
    run's from the same state and weights (rtol 1e-3)."""
    from hoomd_tf_tpu_torch.ops import pair_train_cuda as ptc
    from torch_helpers import quenched_state, train_sim
    state = quenched_state(512)
    runs = {}
    weights = None
    for dev in (cuda_device, torch.device("cpu")):
        sim, tfc, model = train_sim(state, dev, optimizer="sgd", lr=1e-3,
                                    weights=weights)
        weights = model.get_weights()
        if dev.type == "cuda":
            sim.check_syncs = True
        k1, k2 = tcc.half_stencil_pair_forces.launches, \
            ptc.proxy_bwd_moments.launches
        evals, steps = sim.force_evals, sim.train_steps
        sim.run(20)
        if dev.type == "cuda":
            assert ptc.proxy_bwd_moments.launches - k2 == \
                sim.train_steps - steps == 20
            assert tcc.half_stencil_pair_forces.launches - k1 == \
                sim.force_evals - evals
        runs[dev.type] = np.asarray(tfc.loss_history)
        assert np.isfinite(tfc.get_forces_array()).all()
    np.testing.assert_allclose(runs["cuda"], runs["cpu"], rtol=1e-3)


def kernel_names(run):
    """Names of the CUDA kernels ``run()`` launched, by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def rolls(names):
    """The torch.roll kernels among ``names`` (not, say, PyTorch's
    unrolled elementwise kernels)."""
    return [n for n in names if re.search(r"(?<![a-z])roll", n.lower())]


def test_steps_launch_no_roll_kernel(cuda_device):
    """An eval step and a train step gather the half stencil in K1 and K2:
    no torch.roll kernel runs in either (and a torch.roll of its own is
    seen by the same check)."""
    from torch_helpers import quenched_state, train_sim
    probe = kernel_names(lambda: torch.roll(
        torch.ones((4, 4), device=cuda_device), 1, 0))
    assert rolls(probe)
    state = quenched_state(512)
    sim = htt.Simulation(dt=0.005, integrator=htt.md.NVT(kT=1.5, tau=0.5),
                         seed=0, device=cuda_device)
    from torch_helpers import on_device
    sim.set_state(on_device(state, cuda_device))
    htt.tfcompute(LJModel(64)).attach(sim, r_cut=2.5, nlist="cellwise")
    sim.run(2)
    names = kernel_names(lambda: sim.run(3))
    assert any("half_stencil_forces" in n for n in names)
    assert any("half_stencil_home" in n for n in names)
    assert not rolls(names)
    tsim, _, _ = train_sim(state, cuda_device)
    tsim.run(2)
    names = kernel_names(lambda: tsim.run(3))
    assert any("proxy_bwd_kernel" in n for n in names)
    assert any("ChebForm" in n for n in names)
    assert not rolls(names)


def test_backward_without_basis_raises(cuda_device):
    """On the card the training backward is kernel K2: a pair function
    that is no Chebyshev proxy has no kernel there, and raises rather
    than taking the plain lane contraction."""
    from hoomd_tf_tpu_torch.ops.pair_train import pair_train_forces
    layout, slot, aux = packed(cuda_device, False)
    eps = torch.tensor(1.0, device=cuda_device, requires_grad=True)

    def lj(p, r2):
        u = 1.0 / r2
        sr6 = u * u * u
        return (4.0 * p["eps"] * (sr6 * sr6 - sr6),
                -12.0 * p["eps"] * (2.0 * sr6 - 1.0) * sr6 * u)

    f4 = pair_train_forces({"eps": eps}, lj, slot.positions, slot.types,
                           aux["valid"], layout.plan, layout.lo,
                           fwd_stencil="half", geometry=layout.geometry)
    with pytest.raises(ValueError, match="Chebyshev"):
        f4.sum().backward()


# ---------------------------------------------------------------------------
# The packed neighbor-list path: kernel K3
# ---------------------------------------------------------------------------

class SimLJ(htt.SimModel):
    """The JAX package's typical use (LJ from nlist_rinv, autodiff)."""

    def compute(self, nlist, positions, box):
        rinv = htt.nlist_rinv(nlist)
        inv_r6 = rinv ** 6
        energy = torch.sum(4.0 / 2.0 * (inv_r6 * inv_r6 - inv_r6), dim=1)
        return htt.compute_nlist_forces(nlist, energy)


def k3_args(device, n=3000, cap=None, NN=64, density=0.4):
    """K3's inputs from a jittered fluid: ``(slots4, counts, pid, grid,
    cap, NN, r_cut, lengths, n)``."""
    from hoomd_tf_tpu_torch.ops import cell_list as tcl
    pos, _, lengths = fluid_arrays(n, density, 11, jitter=0.4)
    pos4 = torch.as_tensor(np.concatenate(
        [pos, (np.arange(n) % 3)[:, None]], axis=1).astype(np.float32),
        device=device)
    grid, c = tcl.plan(n, lengths, 3.0)
    c = cap or max(c, int(np.ceil(tcl.max_occupancy(pos, lengths, grid) *
                                  1.3)) + 1)
    L = torch.as_tensor(lengths, device=device)
    slots4, counts, pid, _ = tcl.build_planes(pos4, grid, c, L)
    return (slots4, counts, pid, grid, c, NN, 3.0,
            tuple(float(v) for v in lengths), n)


@pytest.mark.parametrize("NN,cap", [(64, None), (16, None), (64, 80)])
def test_k3_matches_plain(cuda_device, NN, cap):
    """K3 on the card against its plain version on the CPU: the same
    order, displacements at 1e-6 (NN = 16: more valid candidates than
    NN; capacity 80: 112 KB of shared memory per block, past the 48 KB
    that needs the opt-in attribute)."""
    from hoomd_tf_tpu_torch.ops import nlist_cuda as tnc
    args = k3_args(cuda_device, cap=cap, NN=NN)
    before = tnc.nlist_select.launches
    got = np_(tnc.nlist_select(*args))
    torch.cuda.synchronize()
    assert tnc.nlist_select.launches - before == 1
    cpu = [a.cpu() if torch.is_tensor(a) else a for a in args]
    want = np_(tnc.nlist_select(*cpu))
    np.testing.assert_array_equal(got[..., 3], want[..., 3])
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (got[..., :3] != 0).any(-1).sum(1).max() == NN or NN == 64


def test_k3_wrapper_checks_inputs(cuda_device):
    from hoomd_tf_tpu_torch.ops import nlist_cuda as tnc
    args = list(k3_args(cuda_device))
    bad = list(args)
    bad[0] = args[0].double()
    with pytest.raises(ValueError, match="float32"):
        tnc.nlist_select(*bad)
    bad = list(args)
    bad[1] = args[1][:-1]
    with pytest.raises(ValueError, match="shape"):
        tnc.nlist_select(*bad)


def test_auto_selects_k3_without_host_sync(cuda_device):
    """'auto' on the card resolves to the cell list with K3; every nlist
    build of the run launched it, and the step loop made no host sync."""
    from hoomd_tf_tpu_torch.ops import nlist_cuda as tnc
    sim = htt.Simulation(dt=0.005, integrator=htt.md.Minimize(0.05),
                         device=cuda_device)
    sim.init_lattice(4096, density=0.4, kT_init=1.5)
    sim.state.positions = sim.state.positions + torch.as_tensor(
        0.3 * np.random.RandomState(0).randn(4096, 3).astype(np.float32),
        device=cuda_device)
    tfc = htt.tfcompute(SimLJ(64))
    tfc.attach(sim, r_cut=3.0)
    sim.add_force(htt.md.LennardJones(epsilon=0.5, r_cut=3.0))
    sim.check_syncs = True
    before = tnc.nlist_select.launches
    sim.run(30)
    sim.thermalize_velocities(1.5)
    sim.integrator = htt.md.NVT(kT=1.5, tau=0.5)
    sim.run(100)
    assert sim._packed_build().method == "pallas"
    assert tnc.nlist_select.launches - before == sim.nlist_builds == 130
    assert np.isfinite(tfc.get_forces_array()).all()
    assert 0.8 < sim.thermo()["temperature"] < 2.5
