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
@pytest.mark.parametrize("capacity", [None, 80])
@pytest.mark.parametrize("flags", [(True, True), (False, False)])
def test_kernel_matches_plain(cuda_device, typed, capacity, flags):
    """K1's planes and forces on the card against its plain version on
    the CPU, on the same inputs (capacity 80: 1120 candidate lanes, more
    than one pass of the thread block)."""
    energy, virial = flags
    pot = (htt.md.LennardJones([[1.0, 0.5], [0.5, 0.5]], 1.0, r_cut=2.5)
           if typed else htt.md.LennardJones(r_cut=2.5))
    form = pot.kernel_form()
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        layout, slot, aux = packed(dev, typed, capacity)
        before = tcc.half_stencil_planes.launches
        f, w = tcc.half_stencil_pair_forces(
            slot.positions, slot.types, aux["valid"], layout.plan,
            layout.lo, form, needs_virial=virial, needs_energy=energy,
            rc2_tab=layout.rc2_tab, geometry=layout.geometry)
        assert tcc.half_stencil_planes.launches - before == \
            (1 if dev.type == "cuda" else 0)
        outs.append((np_(f), None if w is None else np_(w)))
    np.testing.assert_allclose(outs[0][0], outs[1][0], **TOL)
    if virial:
        np.testing.assert_allclose(outs[0][1], outs[1][1], **TOL)


def test_wrapper_checks_inputs(cuda_device):
    layout, slot, aux = packed(cuda_device, False)
    plan = layout.plan
    _, _, _, gx, gy, gz = tcw._relative_coords(
        slot.positions, aux["valid"], plan, layout.lo, tcw._HALF_OFFS,
        layout.geometry)
    occ = aux["valid"].reshape(plan.n_cells, -1).sum(1).int()
    form = htt.md.LennardJones(r_cut=2.5).kernel_form()
    with pytest.raises(ValueError, match="float32"):
        tcc.half_stencil_planes(occ, gx.double(), gy, gz, None, form,
                                plan.capacity, 6.25, 1e-4)
    with pytest.raises(ValueError, match="contiguous"):
        tcc.half_stencil_planes(occ, gx.t().contiguous().t(), gy, gz, None,
                                form, plan.capacity, 6.25, 1e-4)
    with pytest.raises(ValueError, match="LJ-family"):
        tcw.analytic_pair_forces(slot.positions, slot.types, aux["valid"],
                                 plan, layout.lo, None)


def test_run_has_no_host_sync(cuda_device):
    """The step loop makes no host sync (run under
    set_sync_debug_mode('error')), and every force evaluation of the main
    path launched K1."""
    class LJ(htt.PairModel):
        def pair_energy(self, r2):
            return self.pair_kernel_form().pair_energy(r2)

        def pair_kernel_form(self):
            return htt.md.LennardJones(r_cut=3.0)

    sim = htt.Simulation(dt=0.005, integrator=htt.md.Minimize(0.05),
                         device=cuda_device)
    sim.init_lattice(4096, density=0.4, kT_init=1.5)
    sim.state.positions = sim.state.positions + torch.as_tensor(
        0.3 * np.random.RandomState(0).randn(4096, 3).astype(np.float32),
        device=cuda_device)
    tfc = htt.tfcompute(LJ(64))
    tfc.attach(sim, r_cut=3.0, nlist="cellwise")
    sim.check_syncs = True
    before = tcc.half_stencil_planes.launches
    sim.run(30)
    sim.thermalize_velocities(1.5)
    sim.integrator = htt.md.NVT(kT=1.5, tau=0.5)
    sim.run(200)
    assert tcc.half_stencil_planes.launches - before == sim.force_evals
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


def packed_types(device, n_types, n=500, rcm=None):
    pos, vel, lengths = fluid_arrays(n, 0.35, 7)
    st = torch_state(pos, vel, lengths, types=np.arange(n) % n_types,
                     device=device)
    lo = -lengths / 2
    plan = tcw.plan_cellwise(n, lengths, 2.5, positions=pos, lo=lo,
                             width_blocks=14)
    layout = SlotLayout(plan, n, lo, rc_matrix=rcm, device=device)
    slot, aux = layout.pack(st)
    return layout, slot, aux


@pytest.mark.parametrize("typed", [False, True])
@pytest.mark.parametrize("flags", [(True, True), (False, False)])
def test_proxy_form_matches_plain(cuda_device, typed, flags):
    """K1's Chebyshev-proxy form on the card against its plain version
    (``ChebForm.evaluate`` through the tensor reference) on the CPU."""
    energy, virial = flags
    ev, coeffs = proxy_parts(typed)
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        layout, slot, aux = packed(dev, typed)
        form = ev.kernel_form(on(coeffs, dev))
        before = tcc.half_stencil_planes.launches
        f, w = tcc.half_stencil_pair_forces(
            slot.positions, slot.types, aux["valid"], layout.plan,
            layout.lo, form, needs_virial=virial, needs_energy=energy,
            rc2_tab=layout.rc2_tab, geometry=layout.geometry)
        assert tcc.half_stencil_planes.launches - before == \
            (1 if dev.type == "cuda" else 0)
        outs.append((np_(f), None if w is None else np_(w)))
    np.testing.assert_allclose(outs[0][0], outs[1][0], **TOL)
    if virial:
        np.testing.assert_allclose(outs[0][1], outs[1][1], **TOL)


@pytest.mark.parametrize("case", ["untyped", "forces_only", "typed_rcut",
                                  "three_types"])
def test_proxy_backward_matches_plain(cuda_device, case):
    """Kernel K2 on the card against ``proxy_bwd_reference`` on the CPU
    (the JAX bar: rtol 2e-4, atol 2e-5 max|g|). Three types at K = 16 give
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
        layout, slot, aux = packed_types(dev, n_types, rcm=rcm)
        ctt = torch.as_tensor(ct[:layout.plan.n_slots], device=dev)
        before = ptc.proxy_bwd_planes.launches
        g_c, g_cd = ptc.proxy_bwd_moments(
            slot.positions, slot.types, aux["valid"], ctt, layout.plan,
            layout.lo, ev.basis, rc2_tab=layout.rc2_tab,
            needs_energy=energy, geometry=layout.geometry)
        assert ptc.proxy_bwd_planes.launches - before == \
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
        k1, k2 = tcc.half_stencil_planes.launches, \
            ptc.proxy_bwd_planes.launches
        evals, steps = sim.force_evals, sim.train_steps
        sim.run(20)
        if dev.type == "cuda":
            assert ptc.proxy_bwd_planes.launches - k2 == \
                sim.train_steps - steps == 20
            assert tcc.half_stencil_planes.launches - k1 == \
                sim.force_evals - evals
        runs[dev.type] = np.asarray(tfc.loss_history)
        assert np.isfinite(tfc.get_forces_array()).all()
    np.testing.assert_allclose(runs["cuda"], runs["cpu"], rtol=1e-3)


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
