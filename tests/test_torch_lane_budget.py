"""The size of K1's generic-form list on the CPU: the sizing rule of
``cellwise_cuda.LaneBudget`` (a fitted budget follows the need down and up,
with hysteresis on the way down), the first estimate ``lane_budget``
against the lanes an LJ fluid at density 0.4 needs, and the engine's use
of both: each committed run sizes the next one's list from its need, read
in the run's one readback, with no re-run, and a forced short list still
rolls back and ends where a run with a generous list does (the generic form's plain
version, stencil='kernel')."""

import numpy as np
import pytest
import torch

import hoomd_tf_tpu_torch as htt
from hoomd_tf_tpu_torch.ops import cellwise_cuda as tcc


def test_fit_follows_the_need_down_and_up_with_hysteresis():
    lanes = tcc.LaneBudget(10 ** 5, "cpu")
    assert lanes.fit(20000)  # 5x the need: shrinks
    assert 1.05 * 20000 <= lanes.budget <= 1.07 * 20000
    first = lanes.budget
    # inside [1.05, 1.12] times the need: kept as it is
    for need in (19000, 20000, first / 1.0505, first / 1.11):
        assert not lanes.fit(int(need))
        assert lanes.budget == first and lanes.committed == int(need)
    assert lanes.fit(18000)  # budget / need 1.17: shrinks
    assert 1.05 * 18000 <= lanes.budget <= 1.07 * 18000 < first
    # below the headroom, however close: grows, so a fitted list always
    # leaves the next run 5% to rise
    for ratio in (1.01, 1.04, 1.049):
        assert lanes.fit(int(lanes.budget / ratio) + 1)
        assert lanes.budget >= 1.05 * lanes.committed
    assert not lanes.fit(0) and lanes.committed > 0


@pytest.mark.parametrize("n", [100, 1000, 2000000, 2097152, 4000001])
def test_round_lanes(n):
    got = tcc._round_lanes(n)
    assert n <= got <= 1.016 * n + 64
    # a few sizes only: a size is its own rounding
    assert tcc._round_lanes(got) == got


def test_grow_after_an_overflow_is_unchanged():
    lanes = tcc.LaneBudget(100, "cpu")
    lanes.record(torch.tensor(1000))
    assert bool(lanes.overflow())
    lanes.grow()
    assert lanes.budget >= 1250 and int(lanes.needed) == 0


def fluid(n, seed=0, device="cpu"):
    """An LJ fluid at density 0.4 from a jittered lattice: LJPotential on
    'cellwise' (the generic form's plain version), a quench, then NVT at
    kT 1.5."""
    sim = htt.Simulation(dt=0.005, integrator=htt.md.Minimize(0.05),
                         seed=seed, device=device)
    sim.init_lattice(n, density=0.4, kT_init=1.5)
    sim.state.positions = sim.state.positions + torch.as_tensor(
        0.3 * np.random.RandomState(seed).randn(n, 3).astype(np.float32))
    sim.stencil = "kernel"
    tfc = htt.tfcompute(htt.LJPotential(64))
    tfc.attach(sim, r_cut=3.0, nlist="cellwise")
    sim.run(20)
    assert tfc._lane_fast_ok is True
    sim.thermalize_velocities(1.5)
    sim.integrator = htt.md.NVT(kT=1.5, tau=0.5)
    return sim


@pytest.mark.parametrize("n", [500, 1000])
def test_first_estimate_bounds_the_need(n):
    """lane_budget, made before any run has counted its need, is above
    the lanes an LJ fluid at density 0.4 needs, and within 1.5x of them
    (the list's share of a cell's own pairs is the in-cut share, not all
    of them)."""
    sim = fluid(n)
    sim.run(50)
    plan = sim._layout.plan
    need = sim._lanes.committed
    est = tcc.lane_budget(plan, n)
    assert need < est <= 1.5 * need, (plan, need, est)


@pytest.mark.parametrize("edges", [(4.56, 4.56, 4.56), (3.91, 3.91, 3.91),
                                   (3.0, 4.0, 5.0), (1.0, 1.0, 1.0)])
def test_same_cell_share(edges):
    """The in-cut share of two uniform points in a cell (r_cut 3) against
    a count over 2e6 seeded pairs: all of them in a cell within the cut."""
    rng = np.random.RandomState(0)
    e = np.asarray(edges)
    d = rng.uniform(0, 1, (2000000, 3)) * e - rng.uniform(0, 1,
                                                         (2000000, 3)) * e
    want = float(((d * d).sum(1) <= 9.0).mean())
    assert tcc.same_cell_share(edges, 3.0) == pytest.approx(want, abs=3e-3)


def _runs(short, monkeypatch, generous=False):
    if generous:
        monkeypatch.setattr(tcc.LaneBudget, "headroom", 4.0)
        monkeypatch.setattr(tcc.LaneBudget, "shrink_above", 1e9)
    sim = fluid(400, seed=1)
    sim.run(10)
    if short:
        sim._lanes.budget = 10
        with pytest.warns(UserWarning, match="too short"):
            sim.run(10)
        assert sim.lane_reruns == 1
    else:
        sim.run(10)
    before = sim.lane_reruns
    ratios = []
    for _ in range(4):
        sim.run(15)
        ratios.append(sim._lanes.budget / sim._lanes.committed)
    assert sim.lane_reruns == before
    return sim, ratios


def test_engine_sizes_the_list_from_each_run(monkeypatch):
    """LJPotential at 400 particles over several run() calls: after the
    first the list stays within 1.05-1.12x of the need, no run is re-run;
    the trajectory and forces equal a run whose list is 4x the need."""
    sim, ratios = _runs(False, monkeypatch)
    assert sim.lane_reruns == 0
    assert all(1.05 <= r <= 1.12 for r in ratios), ratios
    ref, big = _runs(False, monkeypatch, generous=True)
    assert all(r >= 4.0 for r in big), big
    torch.testing.assert_close(sim.state.positions, ref.state.positions,
                               rtol=0, atol=0)
    torch.testing.assert_close(sim.state.forces, ref.state.forces, rtol=0,
                               atol=0)


def test_forced_short_list_rolls_back_and_ends_as_a_generous_run(
        monkeypatch):
    sim, ratios = _runs(True, monkeypatch)
    assert all(1.05 <= r <= 1.12 for r in ratios), ratios
    ref, _ = _runs(False, monkeypatch, generous=True)
    assert ref.lane_reruns == 0
    torch.testing.assert_close(sim.state.positions, ref.state.positions,
                               rtol=0, atol=0)
