"""Card-only checks of the port: kernel K1 against its plain version, and
the step loop free of host syncs. Every test here needs a CUDA device and
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
