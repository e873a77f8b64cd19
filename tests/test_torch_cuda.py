"""Card-only checks of the port: kernel K1 (LJ and Chebyshev-proxy forms),
kernel K2, kernel K3 and the generic form's backward
(``generic_reduce_bwd``) against their plain versions (also at a tilted
and at a rescaled box, which the kernels read from the card, and in
float64, each kernel's double instantiation), the step loops of
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
import hoomd_tf_tpu_torch.interop  # noqa: F401
from hoomd_tf_tpu_torch.md.slots import SlotLayout
from hoomd_tf_tpu_torch.ops import cellwise as tcw
from hoomd_tf_tpu_torch.ops import cellwise_cuda as tcc

from torch_helpers import (cuda_device, fluid_arrays, geometry_case, np_,  # noqa
                           torch_state)

pytestmark = pytest.mark.requires_cuda

TOL = dict(rtol=1e-4, atol=1e-4)
RCM = np.array([[2.5, 1.8], [1.8, 2.2]], dtype=np.float32)


def packed(device, typed, capacity=None, n=500, dtype=torch.float32):
    pos, vel, lengths = fluid_arrays(n, 0.35, 7)
    types = (np.arange(n) % 2) if typed else None
    st = htt.md.state.init_state(pos, lengths, types=types, velocities=vel,
                                 dtype=dtype, device=device)
    lo = -lengths / 2
    plan = tcw.plan_cellwise(n, lengths, 2.5, positions=pos, lo=lo,
                             width_blocks=14)
    if capacity:
        plan = dataclasses.replace(plan, capacity=capacity)
    layout = SlotLayout(plan, n, lo, rc_matrix=RCM if typed else None,
                        dtype=dtype, device=device)
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
    """On the card the training backward is a kernel: K2 for a Chebyshev
    proxy, ``generic_reduce_bwd`` (the list route) for any other pair
    function. Asking for the plain lane contraction there raises rather
    than running the CPU oracle on the card."""
    from hoomd_tf_tpu_torch.ops.pair_train import pair_train_forces
    layout, slot, aux = packed(cuda_device, False)
    eps = torch.tensor(1.0, device=cuda_device, requires_grad=True)

    def lj(p, r2):
        u = 1.0 / r2
        sr6 = u * u * u
        return (4.0 * p["eps"] * (sr6 * sr6 - sr6),
                -12.0 * p["eps"] * (2.0 * sr6 - 1.0) * sr6 * u)

    with pytest.raises(ValueError, match="oracle"):
        pair_train_forces({"eps": eps}, lj, slot.positions, slot.types,
                          aux["valid"], layout.plan, layout.lo,
                          bwd_impl="generic", geometry=layout.geometry)
    before = tcc.generic_reduce_bwd.launches
    f4 = pair_train_forces({"eps": eps}, lj, slot.positions, slot.types,
                           aux["valid"], layout.plan, layout.lo,
                           geometry=layout.geometry)
    f4.sum().backward()
    assert tcc.generic_reduce_bwd.launches - before == 1
    assert eps.grad is not None and bool(torch.isfinite(eps.grad))


def bwd_case(dev, typed, capacity, energy, budget=None):
    """K1's generic form's list and reduction on ``dev`` (the plain
    version on the CPU) with a cotangent from a seed: ``(gl, ct)``. The
    reduction counts one launch of the form on the card, none on the
    CPU."""
    layout, slot, aux = packed(dev, typed, capacity)
    lanes = tcc.LaneBudget(budget or tcc.lane_budget(layout.plan, 500), dev)
    before = tcc.generic_pair_forces.launches
    gl = tcc.generic_list(slot.positions, slot.types, aux["valid"],
                          layout.plan, layout.lo, rc2_tab=layout.rc2_tab,
                          geometry=layout.geometry, lanes=lanes,
                          needs_energy=energy)
    U, S = gl.evaluate(morse_yukawa)
    tcc.generic_reduce(gl, U, S, energy)
    assert tcc.generic_pair_forces.launches - before == \
        (1 if dev.type == "cuda" else 0)
    ct = torch.as_tensor(np.random.RandomState(4).randn(
        layout.plan.n_slots, 4).astype(np.float32), device=dev)
    return gl, ct, lanes


@pytest.mark.parametrize("typed", [False, True])
@pytest.mark.parametrize("capacity", [None, 80, 200])
@pytest.mark.parametrize("energy", [True, False])
def test_generic_reduce_bwd_matches_plain(cuda_device, typed, capacity,
                                          energy):
    """The backward kernel on the card against its plain version on the
    CPU, lane by lane (the kernel's list holds each cell's lanes at its
    base in the plain list's order), rtol = atol = 1e-4; every lane of the
    budget past the lanes needed is exactly zero; one launch counted."""
    gl, ct, lanes = bwd_case(cuda_device, typed, capacity, energy)
    before = tcc.generic_reduce_bwd.launches
    gU, gS = tcc.generic_reduce_bwd(gl, ct, energy)
    assert tcc.generic_reduce_bwd.launches - before == 1
    need = int(lanes.needed)
    assert need < lanes.budget
    cpu = torch.device("cpu")
    pl, pct, _ = bwd_case(cpu, typed, capacity, energy)
    pU, pS = tcc.generic_reduce_bwd(pl, pct, energy)
    idx = tcc.kernel_lane_index(pl.lst, gl.cell_base, gl.plan)
    assert sorted(idx.tolist()) == list(range(need))
    np.testing.assert_allclose(np_(gS)[np_(idx)], np_(pS), **TOL)
    assert not np_(gS)[need:].any()
    if energy:
        np.testing.assert_allclose(np_(gU)[np_(idx)], np_(pU), **TOL)
        assert not np_(gU)[need:].any()
    else:
        assert gU is None and pU is None


def test_generic_reduce_bwd_short_list_zeroes_unlisted(cuda_device):
    """A budget of half the lanes needed: the cells that did not fit carry
    exactly zero over their share of the list, the listed cells' lanes
    equal the plain version's."""
    gl, ct, lanes = bwd_case(cuda_device, True, None, True)
    need = int(lanes.needed)
    gl, ct, lanes = bwd_case(cuda_device, True, None, True,
                             budget=need // 2)
    assert bool(lanes.overflow())
    gU, gS = tcc.generic_reduce_bwd(gl, ct)
    pl, pct, _ = bwd_case(torch.device("cpu"), True, None, True)
    pU, pS = tcc.generic_reduce_bwd(pl, pct)
    idx = np_(tcc.kernel_lane_index(pl.lst, gl.cell_base, gl.plan))
    listed = idx >= 0
    assert listed.any() and not listed.all()
    np.testing.assert_allclose(np_(gS)[idx[listed]], np_(pS)[listed], **TOL)
    rest = np.ones(lanes.budget, bool)
    rest[idx[listed]] = False
    assert not np_(gS)[rest].any() and not np_(gU)[rest].any()


def test_generic_reduce_bwd_refuses_rewritten_records(cuda_device):
    """The backward reads its forward call's records; a later list call
    rewrites them, and the backward then raises."""
    gl, ct, _ = bwd_case(cuda_device, False, None, True)
    bwd_case(cuda_device, False, None, True)
    with pytest.raises(RuntimeError, match="rewritten"):
        tcc.generic_reduce_bwd(gl, ct)


@pytest.mark.parametrize("kind", ["pair", "synthesized"])
def test_generic_train_forces_gradients_match_cpu(cuda_device, kind):
    """The weights' gradient of <ct, forces4> through K1's generic form
    and ``generic_reduce_bwd`` on the card against the CPU's lane
    contraction on the same state and weights (rtol 2e-4, atol 2e-5
    max|g|, the JAX bar for its Pallas backward)."""
    from hoomd_tf_tpu_torch.interop import build_model
    from hoomd_tf_tpu_torch.md.simulation import _module_pair_apply
    from hoomd_tf_tpu_torch.ops.lane_fast import synthesize_pair_fn
    from hoomd_tf_tpu_torch.ops.pair_train import pair_train_forces
    from torch_helpers import nn_pair_class
    grads, weights = [], None
    for dev in (cuda_device, torch.device("cpu")):
        layout, slot, aux = packed(dev, False)
        model = (nn_pair_class()(16) if kind == "pair" else
                 htt.NeuralPairPotential(16, count=8, hidden=8, layers=1))
        build_model(model, 2.5, dev)
        if weights is None:
            weights = model.get_weights()
        model.set_weights(weights)
        fn = (model.pair_energy_and_slope if kind == "pair" else
              synthesize_pair_fn(model, slot.box, differentiable=True))
        named = {k: v for k, v in model.named_parameters()}
        f4 = pair_train_forces(named, _module_pair_apply(model, fn),
                               slot.positions, slot.types, aux["valid"],
                               layout.plan, layout.lo,
                               with_types=kind != "pair",
                               geometry=layout.geometry)
        ct = torch.as_tensor(np.random.RandomState(4).randn(
            layout.plan.n_slots, 4).astype(np.float32), device=dev)
        grads.append([np_(g) for g in torch.autograd.grad(
            torch.sum(f4 * ct), list(named.values()))])
    scale = max(np.abs(g).max() for g in grads[1])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5 * scale)


@pytest.mark.parametrize("kind", ["pair", "lane"])
def test_generic_training_on_the_card(cuda_device, kind):
    """Online training of a non-proxy NN PairModel and of a lane-fast
    generic SimModel on the card: no host sync in the step loop, the
    generic form's forward and ``generic_reduce_bwd`` launched once per
    train step, K1's LJ form once per label evaluation, and 20 SGD steps'
    losses equal to the CPU run's (the lane contraction) at rtol 1e-3."""
    from torch_helpers import force_loss, nn_pair_class, on_device
    from torch_helpers import quenched_state
    state = quenched_state(512)
    runs, weights = {}, None
    for dev in (cuda_device, torch.device("cpu")):
        sim = htt.Simulation(dt=0.005,
                             integrator=htt.md.NVT(kT=1.5, tau=0.5),
                             seed=0, device=dev)
        sim.set_state(on_device(state, dev))
        sim.add_force(htt.md.LennardJones(r_cut=2.5))
        model = (nn_pair_class()(64, output_forces=False) if kind == "pair"
                 else htt.NeuralPairPotential(64, output_forces=False,
                                              count=8, hidden=8, layers=1))
        htt.interop.build_model(model, 2.5, dev)
        if weights is None:
            weights = model.get_weights()
        model.set_weights(weights)
        model.compile(optimizer="sgd", loss=force_loss, learning_rate=1e-3)
        tfc = htt.tfcompute(model)
        tfc.attach(sim, r_cut=2.5, nlist="cellwise", train=True)
        sim.check_syncs = dev.type == "cuda"
        gen, bwd = tcc.generic_pair_forces.launches, \
            tcc.generic_reduce_bwd.launches
        k1, evals = tcc.half_stencil_pair_forces.launches, sim.force_evals
        steps = sim.train_steps
        sim.run(20)
        if dev.type == "cuda":
            n = sim.train_steps - steps
            assert n == 20 and tcc.generic_reduce_bwd.launches - bwd == n
            # the probe's validation launches the generic form too; every
            # other evaluation is a label evaluation in K1's LJ form
            g = tcc.generic_pair_forces.launches - gen
            assert g >= n
            assert tcc.half_stencil_pair_forces.launches - k1 == \
                sim.force_evals - evals - g
        runs[dev.type] = np.asarray(tfc.loss_history)
        assert np.isfinite(tfc.get_forces_array()).all()
    np.testing.assert_allclose(runs["cuda"], runs["cpu"], rtol=1e-3)


# ---------------------------------------------------------------------------
# float64 on the card: every kernel's double instantiation
# ---------------------------------------------------------------------------

F64 = torch.float64


def assert_rel(got, want, tol):
    """``max |got - want| <= tol * max |want|``."""
    got, want = np_(got), np_(want)
    assert got.dtype == np.float64 and want.dtype == np.float64
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= tol * scale, \
        np.abs(got - want).max() / scale


@pytest.mark.parametrize("form_kind", ["lj", "proxy"])
@pytest.mark.parametrize("typed", [False, True])
@pytest.mark.parametrize("capacity", [None, 200])
def test_double_k1_matches_plain(cuda_device, form_kind, typed, capacity):
    """K1's double instantiation (LJ and proxy forms, a float64 table) on
    a float64 state against its plain version on the CPU at 1e-11 max|F|
    (chip_smoke.py phase 22's bar), energy and virial included; the
    double launch is counted."""
    if form_kind == "lj":
        pot = (htt.md.LennardJones([[1.0, 0.5], [0.5, 0.5]], 1.0, r_cut=2.5)
               if typed else htt.md.LennardJones(r_cut=2.5))
        forms = {d: pot.kernel_form() for d in ("cuda", "cpu")}
    else:
        from hoomd_tf_tpu_torch.ops.chebyshev import (make_pair_proxy,
                                                      make_typed_pair_proxy)
        r2_lo = (0.25 * 2.5) ** 2

        def lj(r2, eps=1.0):
            u = 1.0 / r2
            sr6 = u * u * u
            return 4.0 * eps * (sr6 * sr6 - sr6)
        if typed:
            fit, ev = make_typed_pair_proxy(16, r2_lo, 6.25, 2, dtype=F64,
                                            device="cpu")
            coeffs = fit(lambda r2, ti, tj: lj(r2, 1.0 / (1.0 + ti + tj)))
        else:
            fit, ev = make_pair_proxy(16, r2_lo, 6.25, dtype=F64,
                                      device="cpu")
            coeffs = fit(lj)
        forms = {d: ev.kernel_form(on(coeffs, torch.device(
            cuda_device if d == "cuda" else "cpu"))) for d in ("cuda", "cpu")}
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        layout, slot, aux = packed(dev, typed, capacity, dtype=F64)
        before = tcc.half_stencil_pair_forces.f64_launches
        f, w = tcc.half_stencil_pair_forces(
            slot.positions, slot.types, aux["valid"], layout.plan,
            layout.lo, forms[dev.type], needs_virial=True,
            rc2_tab=layout.rc2_tab, geometry=layout.geometry)
        assert tcc.half_stencil_pair_forces.f64_launches - before == \
            (1 if dev.type == "cuda" else 0)
        assert f.dtype == F64 and w.dtype == F64
        outs.append((f, w))
    assert_rel(outs[0][0], outs[1][0], 1e-11)
    assert_rel(outs[0][1], outs[1][1], 1e-11)


@pytest.mark.parametrize("typed", [False, True])
@pytest.mark.parametrize("capacity", [None, 200])
def test_double_generic_form_matches_plain(cuda_device, typed, capacity):
    """K1's generic form in double: the list holds float64 r2, the pair
    function's float64 (U, s) are reduced in double; forces, energy and
    virial against the plain version at 1e-11 max|F|."""
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        layout, slot, aux = packed(dev, typed, capacity, dtype=F64)
        lanes = tcc.LaneBudget(tcc.lane_budget(layout.plan, 500), dev)
        before = tcc.generic_pair_forces.f64_launches
        f, w = tcc.generic_pair_forces(
            slot.positions, slot.types, aux["valid"], layout.plan,
            layout.lo, morse_yukawa, needs_virial=True,
            rc2_tab=layout.rc2_tab, geometry=layout.geometry, lanes=lanes)
        assert tcc.generic_pair_forces.f64_launches - before == \
            (1 if dev.type == "cuda" else 0)
        assert not bool(lanes.overflow())
        outs.append((f, w))
    assert_rel(outs[0][0], outs[1][0], 1e-11)
    assert_rel(outs[0][1], outs[1][1], 1e-11)


@pytest.mark.parametrize("energy", [True, False])
def test_double_generic_reduce_bwd_matches_plain(cuda_device, energy):
    """``generic_reduce_bwd`` in double, lane by lane against its plain
    version at 1e-11 max|g| (phase 23's bar); lanes past the need zero."""
    res = []
    for dev in (cuda_device, torch.device("cpu")):
        layout, slot, aux = packed(dev, True, None, dtype=F64)
        lanes = tcc.LaneBudget(tcc.lane_budget(layout.plan, 500), dev)
        gl = tcc.generic_list(slot.positions, slot.types, aux["valid"],
                              layout.plan, layout.lo,
                              rc2_tab=layout.rc2_tab,
                              geometry=layout.geometry, lanes=lanes,
                              needs_energy=energy)
        assert gl.r2.dtype == F64
        U, S = gl.evaluate(morse_yukawa)
        tcc.generic_reduce(gl, U, S, energy)
        ct = torch.as_tensor(np.random.RandomState(4).randn(
            layout.plan.n_slots, 4), device=dev)
        before = tcc.generic_reduce_bwd.f64_launches
        gU, gS = tcc.generic_reduce_bwd(gl, ct, energy)
        assert tcc.generic_reduce_bwd.f64_launches - before == \
            (1 if dev.type == "cuda" else 0)
        res.append((gl, lanes, gU, gS))
    (gl, lanes, gU, gS), (pl, _, pU, pS) = res
    need = int(lanes.needed)
    idx = np_(tcc.kernel_lane_index(pl.lst, gl.cell_base, gl.plan))
    assert sorted(idx.tolist()) == list(range(need))
    assert_rel(np_(gS)[idx], pS, 1e-11)
    assert not np_(gS)[need:].any()
    if energy:
        assert_rel(np_(gU)[idx], pU, 1e-11)


@pytest.mark.parametrize("case", ["untyped", "forces_only", "two_types"])
def test_double_k2_matches_plain(cuda_device, case):
    """K2's double instantiation (the register moments untyped, the
    shared-memory moment sets with two types; three types at K = 16 pass
    the block's shared memory in double, and the wrapper refuses them)
    against its plain version at rtol 1e-10 (phase 23's bar)."""
    from hoomd_tf_tpu_torch.ops import pair_train_cuda as ptc
    from hoomd_tf_tpu_torch.ops.chebyshev import (make_pair_proxy,
                                                  make_typed_pair_proxy)
    n_types = 2 if case == "two_types" else 1
    r2_lo = (0.25 * 2.5) ** 2
    if n_types > 1:
        _, ev = make_typed_pair_proxy(16, r2_lo, 6.25, n_types, dtype=F64,
                                      device="cpu")
    else:
        _, ev = make_pair_proxy(16, r2_lo, 6.25, dtype=F64, device="cpu")
    energy = case != "forces_only"
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        pos, vel, lengths = fluid_arrays(500, 0.35, 7)
        st = htt.md.state.init_state(pos, lengths, types=np.arange(500) %
                                     n_types, velocities=vel, dtype=F64,
                                     device=dev)
        lo = -lengths / 2
        plan = tcw.plan_cellwise(500, lengths, 2.5, positions=pos, lo=lo,
                                 width_blocks=14)
        layout = SlotLayout(plan, 500, lo, dtype=F64, device=dev)
        slot, aux = layout.pack(st)
        ct = torch.as_tensor(np.random.RandomState(1).randn(
            plan.n_slots, 4), device=dev)
        before = ptc.proxy_bwd_moments.f64_launches
        g_c, g_cd = ptc.proxy_bwd_moments(
            slot.positions, slot.types, aux["valid"], ct, plan, layout.lo,
            ev.basis, needs_energy=energy, geometry=layout.geometry)
        assert ptc.proxy_bwd_moments.f64_launches - before == \
            (1 if dev.type == "cuda" else 0)
        outs.append(np.concatenate([np_(g_c).ravel(), np_(g_cd).ravel()]))
    assert outs[0].dtype == np.float64
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-10,
                               atol=1e-10 * np.abs(outs[1]).max())


@pytest.mark.parametrize("NN,cap", [(64, None), (16, 80)])
def test_double_k3_matches_plain(cuda_device, NN, cap):
    """K3's double instantiation (64-bit keys, float64 thresholds) equal to
    its plain version element for element (phase 24's bar)."""
    from hoomd_tf_tpu_torch.ops import nlist_cuda as tnc
    args = list(k3_args(cuda_device, cap=cap, NN=NN))
    args[0] = args[0].double()
    before = tnc.nlist_select.f64_launches
    got = tnc.nlist_select(*args)
    assert tnc.nlist_select.f64_launches - before == 1
    cpu = [a.cpu() if torch.is_tensor(a) else a for a in args]
    want = tnc.nlist_select_reference(*cpu)
    assert got.dtype == F64
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("row", ["proxy", "pair"])
def test_float64_training_on_the_card(cuda_device, row):
    """float64 online training on the card (once refused): the proxy row
    launches K1's proxy form and K2 in double, the pair row K1's generic
    form and ``generic_reduce_bwd`` in double; no host sync; 10 SGD
    steps' losses equal the CPU run's (the plain versions) at rtol
    1e-9."""
    from hoomd_tf_tpu_torch.ops import pair_train_cuda as ptc
    from torch_helpers import force_loss, quenched_state

    class NNPair64(htt.PairModel):
        def setup(self):
            self.dense1 = htt.Dense(16, dtype=F64)
            self.last = htt.Dense(1, dtype=F64)

        def pair_energy(self, r2):
            x = torch.tanh(self.dense1(torch.rsqrt(r2)[..., None]))
            return 2.0 * self.last(x)[..., 0]

    state = quenched_state(512)
    runs, weights = {}, None
    for dev in (cuda_device, torch.device("cpu")):
        sim = htt.Simulation(dt=0.005,
                             integrator=htt.md.NVT(kT=1.5, tau=0.5),
                             device=dev)
        sim.set_state(dataclasses.replace(state, **{
            f: getattr(state, f).to(dev, F64) for f in (
                "positions", "velocities", "masses", "box", "forces",
                "virial")}, types=state.types.to(dev), thermostat={},
            rng=None))
        if dev.type == "cpu":
            sim.stencil = "kernel"
        sim.add_force(htt.md.LennardJones(r_cut=2.5))
        model = NNPair64(64, output_forces=False, dtype=F64,
                         proxy_degree=16 if row == "proxy" else None)
        model.compile(optimizer="sgd", loss=force_loss, learning_rate=1e-3)
        htt.interop.build_model(model, 2.5, dev)
        if weights is not None:
            model.set_weights(weights)
        weights = model.get_weights()
        tfc = htt.tfcompute(model)
        tfc.attach(sim, r_cut=2.5, nlist="cellwise", train=True)
        counts = (tcc.half_stencil_pair_forces.f64_launches,
                  ptc.proxy_bwd_moments.f64_launches,
                  tcc.generic_pair_forces.f64_launches,
                  tcc.generic_reduce_bwd.f64_launches)
        if dev.type == "cuda":
            sim.check_syncs = True
        sim.run(10)
        now = (tcc.half_stencil_pair_forces.f64_launches,
               ptc.proxy_bwd_moments.f64_launches,
               tcc.generic_pair_forces.f64_launches,
               tcc.generic_reduce_bwd.f64_launches)
        d = [b - a for a, b in zip(counts, now)]
        if dev.type == "cuda":
            if row == "proxy":
                assert d[1] == 10 and d[0] > 0
            else:
                assert d[3] == 10 and d[2] >= 10
        runs[dev.type] = np.asarray(tfc.loss_history)
        assert np.isfinite(tfc.get_forces_array()).all()
    np.testing.assert_allclose(runs["cuda"], runs["cpu"], rtol=1e-9)


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


def k3_agrees(got, want):
    """K3's bar: the same type column and nonzero pattern (the same
    neighbor order), displacements within 1e-6 (the expected error is
    0)."""
    np.testing.assert_array_equal(got[..., 3], want[..., 3])
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


K3_CASES = {
    # a 3 x 3 x 3 grid: the window holds a column twice, and many |d|
    # fall in the band around L / 2 that the thresholds leave to the
    # division
    "3x3x3 grid": dict(n=300, L=10.0),
    # positions shifted by +-1 and +-2 boxes (the binning wraps them)
    "unwrapped": dict(n=3000, L=19.5, unwrap=True),
    "empty and half-full cells": dict(n=900, L=19.5, sparse=0.5,
                                      unwrap=True),
    # ~217 KB of shared memory per block (past 48 KB: the opt-in
    # attribute), one block to an SM
    "capacity 200": dict(n=3000, L=19.5, cap=200),
    # nx = 7 in strips of 2, 2, 2 and 1
    "ragged strips": dict(n=1500, L=21.5),
    # tied distances everywhere: the candidate slot alone orders a row
    "lattice ties": dict(n=1728, L=18.0, lattice=True, unwrap=True),
    # cells past capacity: particles that hold no slot get zero rows
    "overflow": dict(n=1500, L=19.5, cap=8),
}


@pytest.mark.parametrize("case", sorted(K3_CASES))
def test_k3_cases_match_plain(cuda_device, case):
    """K3 on the card against its plain version on the CPU, at the cases
    that exercise the redesign (K3_CASES)."""
    from hoomd_tf_tpu_torch.ops import nlist_cuda as tnc
    from torch_helpers import k3_inputs
    kw = dict(K3_CASES[case])
    (slots4, counts, pid, grid, cap, L), pos4 = k3_inputs(
        kw.pop("n"), kw.pop("L"), seed=5, **kw)
    n = pos4.shape[0]
    if case == "ragged strips":
        assert grid[0] == 7 and 7 % tnc.launch_shape(7, cap, 64)[0]
    if case == "capacity 200":
        assert tnc.launch_shape(grid[0], cap, 64)[2] > 200 * 1024
    if case == "overflow":
        assert int(counts.sum()) < n
    args = (grid, cap, 64, 3.0, L, n)
    cuda = [t.to(cuda_device) for t in (slots4, counts, pid)]
    before = tnc.nlist_select.launches
    got = np_(tnc.nlist_select(*cuda, *args))
    torch.cuda.synchronize()
    assert tnc.nlist_select.launches - before == 1
    want = np_(tnc.nlist_select_reference(slots4, counts, pid, *args))
    k3_agrees(got, want)
    assert (want[..., :3] != 0).any()


@pytest.mark.parametrize("strip", [1, 4, 6])
def test_k3_forced_strips_match_plain(cuda_device, strip):
    """Every strip length gives the plain version's list on a 6-cell x
    axis: strips of one cell, a ragged 4 + 2, and the whole row."""
    from hoomd_tf_tpu_torch.ops import nlist_cuda as tnc
    args = k3_args(torch.device("cpu"))
    slots4, counts, pid, grid, cap, NN, r_cut, L, n = args
    assert grid[0] == 6
    params = tnc.launch_params(grid, cap, NN, r_cut, L, strip=strip)
    assert (params.strip, params.n_strips) == (strip, -(-6 // strip))
    got = np_(tnc.launch(params, *(t.to(cuda_device) for t in
                                   (slots4, counts, pid)), n))
    want = np_(tnc.nlist_select_reference(*args))
    k3_agrees(got, want)


def test_k3_writes_its_padding(cuda_device):
    """The kernel writes every row whole: the list comes from
    torch.empty, so first a NaN-filled tensor of its size is made and
    freed (the caching allocator then hands that memory back); every
    column past a row's valid count must be exactly 0, and no NaN is
    left anywhere, the rows of particles that hold no slot included."""
    from hoomd_tf_tpu_torch.ops import nlist_cuda as tnc
    from torch_helpers import k3_inputs
    (slots4, counts, pid, grid, cap, L), pos4 = k3_inputs(
        1500, 19.5, seed=6, cap=8)
    n = pos4.shape[0]
    cuda = [t.to(cuda_device) for t in (slots4, counts, pid)]
    torch.cuda.synchronize()
    dirty = torch.full((n, 64, 4), float("nan"), device=cuda_device)
    ptr = dirty.data_ptr()
    del dirty
    out = tnc.nlist_select(*cuda, grid, cap, 64, 3.0, L, n)
    assert out.data_ptr() == ptr
    got = np_(out)
    assert not np.isnan(got).any()
    want = np_(tnc.nlist_select_reference(slots4, counts, pid, grid, cap,
                                          64, 3.0, L, n))
    k3_agrees(got, want)
    valid = (want[..., :3] != 0).any(-1).sum(1)
    assert int(counts.sum()) < n and (valid == 0).any()
    past = np.arange(64)[None, :] >= valid[:, None]
    assert (got[past] == 0).all() and past.any()


def counted_kernels(run, calls, tries=3):
    """Names of the CUDA kernels of ``calls`` back-to-back ``run()``s, by
    torch.profiler. The profiler can leave the first kernels after it
    starts unrecorded, so the window opens with three marker kernels
    (``torch.cuda._sleep``) and a synchronize, ends with one more, and
    only the kernels between the last opening marker and the closing one
    count; a window without both, or whose count is no multiple of the
    calls, is run again, up to ``tries`` windows."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(calls):
                run()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        ev = sorted((e.time_range.start, e.name) for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
        marks = [k for k, e in enumerate(ev) if "spin_kernel" in e[1]]
        if len(marks) >= 2:
            names = [e[1] for e in ev[marks[-2] + 1:marks[-1]]]
            if names and len(names) % calls == 0:
                return names
    raise AssertionError(f"the profiler lost kernels in {tries} windows; "
                         f"the last saw markers at {marks} in "
                         f"{[e[1][:40] for e in ev]}")


def test_k3_one_kernel_per_call(cuda_device):
    """One K3 call is one CUDA kernel (no fill before it), over 10
    calls under the profiler."""
    from hoomd_tf_tpu_torch.ops import nlist_cuda as tnc
    args = k3_args(cuda_device)
    tnc.nlist_select(*args)
    names = counted_kernels(lambda: tnc.nlist_select(*args), 10)
    assert len(names) == 10
    assert all("nlist_select" in n for n in names)


def test_k3_wrapper_checks_inputs(cuda_device):
    from hoomd_tf_tpu_torch.ops import nlist_cuda as tnc
    args = list(k3_args(cuda_device))
    bad = list(args)
    bad[0] = args[0].half()
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


# ---------------------------------------------------------------------------
# K1's generic form: the list kernel, the pair function, the reduction
# ---------------------------------------------------------------------------

def morse_yukawa(r2, ti, tj):
    """A typed pair function no kernel form covers (as in
    tests/test_torch_generic.py)."""
    r = torch.sqrt(r2)
    e = torch.exp(-1.5 * (r - 1.1))
    um, dm = e * e - 2.0 * e, (-3.0 * e * e + 3.0 * e) / (2.0 * r)
    y = torch.exp(-0.8 * r) / r
    uy, dy = 0.7 * y, 0.7 * y * (-0.8 - 1.0 / r) / (2.0 * r)
    like = ti == tj
    return torch.where(like, um, uy), torch.where(like, dm, dy)


@pytest.mark.parametrize("typed", [False, True])
@pytest.mark.parametrize("capacity", [None, 80, 200])
@pytest.mark.parametrize("flags", [(True, True), (False, False)])
def test_generic_form_matches_plain(cuda_device, typed, capacity, flags):
    """The generic form's list and reduction kernels on the card against
    their plain version on the CPU, on the same inputs; the lanes needed
    agree exactly (bit-equal masks), one launch counted per call."""
    energy, virial = flags
    outs, needed = [], []
    for dev in (cuda_device, torch.device("cpu")):
        layout, slot, aux = packed(dev, typed, capacity)
        lanes = tcc.LaneBudget(tcc.lane_budget(layout.plan, 500), dev)
        before = tcc.generic_pair_forces.launches
        f, w = tcc.generic_pair_forces(
            slot.positions, slot.types, aux["valid"], layout.plan,
            layout.lo, morse_yukawa, typed_fn=True, needs_virial=virial,
            needs_energy=energy, rc2_tab=layout.rc2_tab,
            geometry=layout.geometry, lanes=lanes)
        assert tcc.generic_pair_forces.launches - before == \
            (1 if dev.type == "cuda" else 0)
        assert not bool(lanes.overflow())
        needed.append(int(lanes.needed))
        outs.append((np_(f), None if w is None else np_(w)))
    assert needed[0] == needed[1] > 0
    np.testing.assert_allclose(outs[0][0], outs[1][0], **TOL)
    if virial:
        np.testing.assert_allclose(outs[0][1], outs[1][1], **TOL)


def test_generic_form_is_deterministic_and_flags_a_short_list(cuda_device):
    """Two calls give the same bits (the list's placement varies, the
    sums' order does not); a budget of half the lanes needed reports the
    count, and the next call with room is right again (the counter was
    reset)."""
    layout, slot, aux = packed(cuda_device, True)
    args = (slot.positions, slot.types, aux["valid"], layout.plan,
            layout.lo, morse_yukawa)
    kw = dict(needs_virial=True, rc2_tab=layout.rc2_tab,
              geometry=layout.geometry)
    big = tcc.LaneBudget(tcc.lane_budget(layout.plan, 500), cuda_device)
    f1, w1 = tcc.generic_pair_forces(*args, lanes=big, **kw)
    f2, w2 = tcc.generic_pair_forces(*args, lanes=big, **kw)
    torch.testing.assert_close(f1, f2, rtol=0, atol=0)
    torch.testing.assert_close(w1, w2, rtol=0, atol=0)
    need = int(big.needed)
    short = tcc.LaneBudget(need // 2, cuda_device)
    tcc.generic_pair_forces(*args, lanes=short, **kw)
    assert bool(short.overflow()) and int(short.needed) == need
    f3, _ = tcc.generic_pair_forces(*args, lanes=big, **kw)
    torch.testing.assert_close(f3, f1, rtol=0, atol=0)


def test_generic_form_against_lj_form(cuda_device):
    """The generic form with the LJ pair function against K1's LJ form on
    the same state: one function, two routes."""
    layout, slot, aux = packed(cuda_device, False)
    lj = htt.md.LennardJones(r_cut=2.5)
    args = (slot.positions, slot.types, aux["valid"], layout.plan,
            layout.lo)
    kw = dict(needs_virial=True, geometry=layout.geometry)
    f_g, w_g = tcc.generic_pair_forces(*args, lj.pair_energy_and_slope, **kw)
    f_l, w_l = tcc.half_stencil_pair_forces(*args, lj.kernel_form(), **kw)
    np.testing.assert_allclose(np_(f_g), np_(f_l), **TOL)
    np.testing.assert_allclose(np_(w_g), np_(w_l), **TOL)


def test_generic_simmodel_runs_on_card_without_host_sync(cuda_device):
    """LJPotential on 'cellwise': the probe validates it, every force
    evaluation launches the generic form, and the step loop makes no host
    sync; 'direct' runs too."""
    sim = htt.Simulation(dt=0.005, integrator=htt.md.Minimize(0.05),
                         device=cuda_device)
    sim.init_lattice(4096, density=0.4, kT_init=1.5)
    sim.state.positions = sim.state.positions + torch.as_tensor(
        0.3 * np.random.RandomState(0).randn(4096, 3).astype(np.float32),
        device=cuda_device)
    tfc = htt.tfcompute(htt.LJPotential(64))
    tfc.attach(sim, r_cut=3.0, nlist="cellwise")
    sim.run(1)  # the probe (it reads the device back) runs here
    assert tfc._lane_fast_ok is True
    sim.check_syncs = True
    before, ev0 = tcc.generic_pair_forces.launches, sim.force_evals
    sim.run(30)
    sim.thermalize_velocities(1.5)
    sim.integrator = htt.md.NVT(kT=1.5, tau=0.5)
    sim.run(100)
    assert tcc.generic_pair_forces.launches - before == \
        sim.force_evals - ev0
    assert np.isfinite(tfc.get_forces_array()).all()
    d = htt.Simulation(dt=0.005, integrator=htt.md.NVT(kT=1.5, tau=0.5),
                       device=cuda_device)
    d.set_state(sim.state)
    htt.tfcompute(htt.LJPotential(64)).attach(d, r_cut=3.0, nlist="direct")
    d.check_syncs = True
    d.run(20)
    assert np.isfinite(d.state.forces.cpu().numpy()).all()


def test_planes_route_runs_on_card_without_host_sync(cuda_device):
    """A generic SimModel the probe rejects runs on the masked planes with
    no host sync in the step loop, and matches the CPU's first step."""

    class CrossLane(htt.SimModel):
        def compute(self, nlist, positions, box):
            s = torch.sum(htt.nlist_rinv(nlist) ** 6, dim=1)
            return htt.compute_nlist_forces(nlist, 0.01 * s * s)

    forces = []
    for dev in (cuda_device, torch.device("cpu")):
        sim = htt.Simulation(dt=0.005, integrator=htt.md.NVE(), seed=3,
                             device=dev)
        # at rest: the two devices' generators draw different velocities
        sim.init_lattice(512, density=0.3)
        tfc = htt.tfcompute(CrossLane(48))
        tfc.attach(sim, r_cut=2.5, nlist="cellwise")
        sim.run(1)
        assert tfc._lane_fast_ok is False
        forces.append(np_(sim.state.forces))
        if dev.type == "cuda":
            sim.check_syncs = True
            sim.run(10)
    np.testing.assert_allclose(forces[0], forces[1], rtol=1e-4, atol=1e-4)


def test_k3_dynamic_smem_just_under_48kb(cuda_device):
    """K3 at a launch whose dynamic shared memory is just under 48 KB
    (capacity 31, NN 128: 49136 bytes) but whose static array takes the
    block past it: the launch sets the opt-in attribute and matches its
    plain version."""
    from hoomd_tf_tpu_torch.ops import nlist_cuda as tnc
    args = k3_args(cuda_device, cap=31, NN=128)
    p = tnc.launch_params(args[3], 31, 128, 3.0, args[7])
    assert 48 * 1024 - 32 < p.smem <= 48 * 1024
    got = np_(tnc.nlist_select(*args))
    torch.cuda.synchronize()
    want = np_(tnc.nlist_select(*[a.cpu() if torch.is_tensor(a) else a
                                  for a in args]))
    np.testing.assert_array_equal(got[..., 3], want[..., 3])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("typed", [False, True])
@pytest.mark.parametrize("capacity", [64, 52, 29])
def test_generic_kernels_match_plain_at_capacities(cuda_device, typed,
                                                   capacity):
    """The list and reduction kernels, handing each cell's record through
    device memory, against the plain version on the CPU at capacity 64
    and 52 (the 64k fluid's plans) and 29 (rows of no multiple of 16
    bytes), typed with a cutoff table and untyped; the lanes needed agree
    exactly."""
    outs, needed = [], []
    for dev in (cuda_device, torch.device("cpu")):
        layout, slot, aux = packed(dev, typed, capacity)
        lanes = tcc.LaneBudget(tcc.lane_budget(layout.plan, 500), dev)
        f, w = tcc.generic_pair_forces(
            slot.positions, slot.types, aux["valid"], layout.plan,
            layout.lo, morse_yukawa, needs_virial=True,
            rc2_tab=layout.rc2_tab, geometry=layout.geometry, lanes=lanes)
        assert not bool(lanes.overflow())
        needed.append(int(lanes.needed))
        outs.append((np_(f), np_(w)))
    assert needed[0] == needed[1] > 0
    np.testing.assert_allclose(outs[0][0], outs[1][0], **TOL)
    np.testing.assert_allclose(outs[0][1], outs[1][1], **TOL)


def test_generic_records_across_capacities_bit_equal(cuda_device):
    """Calls at the default capacity, at 200 (a larger record per cell,
    the records' buffer remade) and at the default again give the same
    bits as the first call, call after call."""
    runs = {}
    for capacity in (None, 200, None, 200):
        layout, slot, aux = packed(cuda_device, True, capacity)
        lanes = tcc.LaneBudget(tcc.lane_budget(layout.plan, 500),
                               cuda_device)
        for _ in range(2):
            f, w = tcc.generic_pair_forces(
                slot.positions, slot.types, aux["valid"], layout.plan,
                layout.lo, morse_yukawa, needs_virial=True,
                rc2_tab=layout.rc2_tab, geometry=layout.geometry,
                lanes=lanes)
            assert not bool(lanes.overflow())
            if capacity not in runs:
                runs[capacity] = (f, w)
            torch.testing.assert_close(f, runs[capacity][0], rtol=0, atol=0)
            torch.testing.assert_close(w, runs[capacity][1], rtol=0, atol=0)


def test_generic_short_list_sets_flag_bit_3(cuda_device):
    """A list forced short in the engine's step loop sets bit 3 of the
    run's flags, the run rolls back and re-runs once with a list sized
    from the need, and ends as a run with a generous list does; the next
    runs fit the list to their need and re-run nothing."""
    states = []
    for short in (False, True):
        sim = htt.Simulation(dt=0.005, integrator=htt.md.Minimize(0.05),
                             seed=3, device=cuda_device)
        sim.init_lattice(4096, density=0.4, kT_init=1.5)
        sim.state.positions = sim.state.positions + torch.as_tensor(
            0.3 * np.random.RandomState(0).randn(4096, 3).astype(np.float32),
            device=cuda_device)
        tfc = htt.tfcompute(htt.LJPotential(64))
        tfc.attach(sim, r_cut=3.0, nlist="cellwise")
        sim.run(30)
        assert tfc._lane_fast_ok is True
        sim.thermalize_velocities(1.5)
        sim.integrator = htt.md.NVT(kT=1.5, tau=0.5)
        sim.run(200)
        sim.lane_reruns = 0
        seen = []
        fetch = sim._fetch_run_scalars

        def spy(*a, **k):
            out = fetch(*a, **k)
            seen.append(out[0])
            return out
        sim._fetch_run_scalars = spy
        sim.check_syncs = True
        if short:
            sim._lanes.budget = 10
            with pytest.warns(UserWarning, match="too short"):
                sim.run(20)
            assert seen[0] & 8 and not seen[1] & 8
            assert sim.lane_reruns == 1
        else:
            sim._lanes.budget = 10 ** 7
            sim.run(20)
        states.append(sim.state.positions.clone())
        for _ in range(3):
            sim.run(20)
            assert sim._lanes.budget <= 1.12 * sim._lanes.committed
        assert sim.lane_reruns == int(short)
    torch.testing.assert_close(states[1], states[0], rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# Tilted and rescaled boxes: the kernels read the box from the card
# ---------------------------------------------------------------------------

GEOM_RCM = np.array([[2.5, 2.0], [2.0, 2.2]], dtype=np.float32)


@pytest.mark.parametrize("kind", ["tilted", "scaled"])
def test_kernels_match_plain_at_new_geometry(cuda_device, kind):
    """At a tilted box (the JAX tests' TILT) and at a box rescaled by 0.97
    under a dynamic-box layout: K1's LJ form (energy and virial, typed,
    per-type cutoffs), its proxy form, its generic form, the generic
    form's backward and K2, each on the card against its plain version on
    the CPU (K1 at rtol = atol = 1e-4, K2 at the JAX bar); the generic
    form lists exactly the plain version's lanes, with bit-equal r2 (the
    staged geometry rounds as the tensor form does)."""
    from hoomd_tf_tpu_torch.ops import pair_train_cuda as ptc
    lj = htt.md.LennardJones([[1.0, 0.5], [0.5, 0.5]], 1.0, r_cut=2.5)
    ev, coeffs = proxy_parts(True)
    ct = np.random.RandomState(3).randn(200000, 4).astype(np.float32)
    res = {}
    for dev in (cuda_device, torch.device("cpu")):
        layout, slot, aux = geometry_case(kind, dev, typed=True,
                                          rc_matrix=GEOM_RCM)
        g = layout.geom(slot)
        args = (slot.positions, slot.types, aux["valid"], layout.plan,
                layout.lo)
        out = {}
        out["lj"] = tcc.half_stencil_pair_forces(
            *args, lj.kernel_form(), needs_virial=True,
            rc2_tab=layout.rc2_tab, geometry=g)
        out["proxy"] = tcc.half_stencil_pair_forces(
            *args, ev.kernel_form(on(coeffs, dev)), needs_virial=True,
            rc2_tab=layout.rc2_tab, geometry=g)
        lanes = tcc.LaneBudget(tcc.lane_budget(layout.plan, 3000), dev)
        gl = tcc.generic_list(*args, rc2_tab=layout.rc2_tab, geometry=g,
                              lanes=lanes)
        U, S = gl.evaluate(morse_yukawa)
        out["generic"] = tcc.generic_reduce(gl, U, S, True, False)
        ctt = torch.as_tensor(ct[:layout.plan.n_slots], device=dev)
        out["bwd"] = tcc.generic_reduce_bwd(gl, ctt, True)
        out["k2"] = ptc.proxy_bwd_moments(
            slot.positions, slot.types, aux["valid"], ctt, layout.plan,
            layout.lo, ev.basis, rc2_tab=layout.rc2_tab, geometry=g)
        res[dev.type] = (out, gl, int(lanes.needed))
    (card, gl, need), (cpu, pl, pneed) = res["cuda"], res["cpu"]
    assert need == pneed > 0
    for k in ("lj", "proxy"):
        np.testing.assert_allclose(np_(card[k][0]), np_(cpu[k][0]), **TOL)
        np.testing.assert_allclose(np_(card[k][1]), np_(cpu[k][1]), **TOL)
    np.testing.assert_allclose(np_(card["generic"][0]),
                               np_(cpu["generic"][0]), **TOL)
    idx = np_(tcc.kernel_lane_index(pl.lst, gl.cell_base, gl.plan))
    assert sorted(idx.tolist()) == list(range(need))
    np.testing.assert_array_equal(np_(gl.r2)[idx], np_(pl.lst["r2"]))
    for a, b in zip(card["bwd"], cpu["bwd"]):
        np.testing.assert_allclose(np_(a)[idx], np_(b), **TOL)
    got = np.concatenate([np_(x).ravel() for x in card["k2"]])
    want = np.concatenate([np_(x).ravel() for x in cpu["k2"]])
    np.testing.assert_allclose(got, want, rtol=2e-4,
                               atol=2e-5 * np.abs(want).max())


def test_box_changed_in_place_is_followed(cuda_device):
    """The kernels read the box at every launch: rescaling the layout's
    box tensor (and the positions) in place between two calls of K1 needs
    no new plan or HalfGeom, and the second call equals the plain version
    at the new box, not the first call."""
    lj = htt.md.LennardJones(r_cut=2.5).kernel_form()
    layout, slot, aux = geometry_case("scaled", cuda_device)
    g = layout.geom(slot)
    args = (slot.positions, slot.types, aux["valid"], layout.plan,
            layout.lo)
    geoms = tcc.half_geom.cache_info().currsize
    f1, _ = tcc.half_stencil_pair_forces(*args, lj, geometry=g)
    with torch.no_grad():
        g.box.mul_(0.99)
        slot.positions.mul_(0.99)
    f2, w2 = tcc.half_stencil_pair_forces(*args, lj, needs_virial=True,
                                          geometry=g)
    assert tcc.half_geom.cache_info().currsize == geoms
    cpu = torch.device("cpu")
    box = g.box.cpu()
    ref = tcw.SlotGeometry(layout.plan, box=box, device=cpu)
    pf, pw = tcc.half_stencil_pair_forces(
        slot.positions.cpu(), slot.types.cpu(), aux["valid"].cpu(),
        layout.plan, layout.lo, lj, needs_virial=True, geometry=ref)
    np.testing.assert_allclose(np_(f2), np_(pf), **TOL)
    np.testing.assert_allclose(np_(w2), np_(pw), **TOL)
    assert np.abs(np_(f2) - np_(f1)).max() > 1e-3


def test_npt_and_tilted_runs_have_no_host_sync(cuda_device):
    """NPT on 'cellwise' (the dynamic-box layout, the virial every step)
    and NVT in a tilted box, each a short run with the step loop under
    set_sync_debug_mode('error'): finite positions, the box changed under
    NPT and not under NVT, K1 launched at every step."""
    from torch_helpers import TILT, tri_positions
    n = 4000
    for kind in ("npt", "tilted"):
        integ = (htt.md.NPT(kT=1.2, tau=0.5, P=0.3, tauP=0.5)
                 if kind == "npt" else htt.md.NVT(kT=1.2, tau=0.5))
        sim = htt.Simulation(dt=0.002, integrator=integ,
                             device=cuda_device)
        if kind == "npt":
            sim.init_lattice(n, density=0.4, kT_init=1.2)
        else:
            L = (n / 0.4) ** (1 / 3)
            lengths = np.array([L, L, L])
            box = np.stack([-lengths / 2, lengths / 2, TILT])
            sim.init_state(tri_positions(n, lengths, TILT), box,
                           kT_init=1.2)
        sim.add_force(htt.md.LennardJones(r_cut=2.5))
        sim.run(10)
        box0 = np_(sim.state.box).copy()
        sim.check_syncs = True
        before = tcc.half_stencil_pair_forces.launches
        sim.run(20)
        assert tcc.half_stencil_pair_forces.launches - before >= 20
        assert np.isfinite(np_(sim.state.positions)).all()
        moved = not np.array_equal(np_(sim.state.box), box0)
        assert moved == (kind == "npt")
        assert sim._layout.dynamic_box == (kind == "npt")


# ---------------------------------------------------------------------------
# slice G: mapped coarse-grained lists, MolSimModel, the CG operator
# ---------------------------------------------------------------------------

class MappedLJ(htt.SimModel):
    """Reference example 02's structure with LJ (chip_smoke.py phase
    19's): forces from the atoms' list, the beads' RDF into a
    MeanTensor."""

    def setup(self):
        self.rdf = htt.MeanTensor()

    def compute(self, nlist, positions, box):
        aa, cg = self.mapped_nlist(nlist)
        rdf, _ = htt.compute_rdf(cg, [0.5, 3.0], nbins=20)
        self.rdf.update_state(rdf)
        inv_r6 = htt.nlist_rinv(aa) ** 6
        e = torch.sum(2.0 * (inv_r6 * inv_r6 - inv_r6), dim=1)
        return htt.compute_nlist_forces(aa, e)


def group_operator(n, device, k=4):
    groups = [list(range(k * i, k * i + k)) for i in range(n // k)]
    return htt.sparse_mapping([np.ones((1, k)) / k] * len(groups), groups,
                              device=device)


def mapped_fluid(device, nlist, n=4096, seed=0):
    sim = htt.Simulation(dt=0.005, integrator=htt.md.NVT(kT=1.5, tau=0.5),
                         seed=seed, device=device)
    pos, vel, lengths = fluid_arrays(n, 0.4, seed=seed, kT=1.5)
    sim.set_state(torch_state(pos, vel, lengths, device=device))
    op = group_operator(n, device)

    def mapping(pos4, box):
        com = htt.center_of_mass(pos4, op, box)
        return torch.cat([com, torch.zeros_like(com[:, :1])], dim=1)
    tfc = htt.tfcompute(MappedLJ(96))
    tfc.enable_mapped_nlist(sim, mapping)
    tfc.attach(sim, r_cut=3.0, nlist=nlist)
    return sim, tfc, op


def test_center_of_mass_on_card_has_no_host_sync(cuda_device):
    """sparse_mapping's CSR operator lives on the card and its product in
    center_of_mass waits on nothing (set_sync_debug_mode('error')); the
    result equals the CPU's at 1e-5. The groups are compact, as a
    molecule's atoms are (within 1 of their center, which lies anywhere
    in the box, across its boundary too): for atoms spread over the box
    the circular mean is ill-conditioned, and the card's and the CPU's
    cos and sin, a few ulp apart, then differ by more."""
    n = 4096
    rng = np.random.RandomState(0)
    centers = np.repeat(rng.rand(n // 4, 3) * 20 - 10, 4, axis=0)
    pos = centers + rng.uniform(-1, 1, (n, 3))
    pos = torch.as_tensor((pos - np.round(pos / 20) * 20).astype(np.float32))
    box = torch.tensor([20.0, 20.0, 20.0])
    op = group_operator(n, cuda_device)
    assert op.is_cuda and op.layout == torch.sparse_csr
    pc, bc = pos.to(cuda_device), box.to(cuda_device)
    htt.center_of_mass(pc, op, bc)
    torch.cuda.synchronize()
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = htt.center_of_mass(pc, op, bc)
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    want = htt.center_of_mass(pos, group_operator(n, "cpu"), box)
    d = np_(got) - np_(want)
    np.testing.assert_allclose(d - np.round(d / 20.0) * 20.0, 0.0,
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("nlist", ["cell", "cellwise"])
def test_mapped_runs_have_no_host_sync(cuda_device, nlist):
    """A mapped model (4096 atoms, 1024 beads) on 'cell' (the sort
    method) and on 'cellwise' (the planes route) with the step loop
    under set_sync_debug_mode('error'): the beads at the mapping of the
    atoms (1e-4), zero bead forces, finite; one step's forces equal the
    CPU's (5e-4, the 'cellwise' bar)."""
    sim, tfc, op = mapped_fluid(cuda_device, nlist)
    cpu, _, _ = mapped_fluid(torch.device("cpu"), nlist)
    sim.run(1)
    cpu.run(1)
    np.testing.assert_allclose(np_(sim.state.forces), np_(cpu.state.forces),
                               rtol=5e-4, atol=5e-4)
    sim.check_syncs = True
    sim.run(20)
    st = sim.state
    n = 4096
    L = htt.box_size(st.box)
    d = st.positions[n:] - htt.center_of_mass(st.positions[:n], op, L)
    d = d - torch.round(d / L) * L
    assert float(d.abs().max()) <= 1e-4
    assert float(st.forces[n:].abs().max()) == 0.0
    assert np.isfinite(np_(st.positions)).all()
    assert float(tfc.model.rdf.result().sum()) > 0


def test_molsim_run_has_no_host_sync(cuda_device):
    """A MolSimModel of four-atom molecules on the card's default build
    (the cell list with K3), the step loop under set_sync_debug_mode(
    'error'): K3 at every build, forces equal the plain LJ model's on
    the same list (every atom in one molecule)."""
    from hoomd_tf_tpu_torch.ops import nlist_cuda as tnc

    class LJMol(htt.MolSimModel):
        def mol_compute(self, nlist, positions, mol_nlist, mol_positions,
                        box):
            rinv = htt.nlist_rinv(mol_nlist)
            return htt.compute_nlist_forces(
                nlist, torch.sum(2.0 * (rinv ** 12 - rinv ** 6)))

    n = 4096
    mols = [list(range(4 * i, 4 * i + 4)) for i in range(n // 4)]
    sim = htt.Simulation(dt=0.005, integrator=htt.md.NVT(kT=1.5, tau=0.5),
                         device=cuda_device)
    pos, vel, lengths = fluid_arrays(n, 0.4, seed=1, kT=1.5)
    sim.set_state(torch_state(pos, vel, lengths, device=cuda_device))
    model = LJMol(4, mols, 64)
    htt.tfcompute(model).attach(sim, r_cut=3.0)
    assert sim._packed_build().method == "pallas"
    nl = sim._build_nlist(sim.state)
    inputs = [nl, sim.state.positions4, sim.state.box]
    np.testing.assert_allclose(np_(model(inputs)[0])[:, :3],
                               np_(SimLJ(64).to(cuda_device)(inputs)[0])
                               [:, :3], rtol=0, atol=1e-4)
    sim.check_syncs = True
    before, builds = tnc.nlist_select.launches, sim.nlist_builds
    sim.run(30)
    assert tnc.nlist_select.launches - before == \
        sim.nlist_builds - builds == 30
    assert np.isfinite(np_(sim.state.forces)).all()
    assert 0.8 < sim.thermo()["temperature"] < 2.5
