"""The lane-separability probe of the port against the JAX package's, on
the models of tests/test_lane_fast.py: the same state (carried across
with ``interop``) through ``Simulation.run`` on ``nlist='cellwise'`` in
both packages, the port's verdict (``tfc._lane_fast_ok``) equal to the
JAX package's. The positions after the run agree within the JAX test's
trajectory tolerance (atol 2e-3, modulo the box); a run on the
validated route also matches the port's own packed cell-list route."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import hoomd_tf_tpu as htf
import hoomd_tf_tpu_torch as htt
from hoomd_tf_tpu_torch.interop import state_from_numpy
from hoomd_tf_tpu_torch.ops import lane_fast

from torch_helpers import jax_state_numpy, np_

N, STEPS = 128, 3


class JGenericLJ(htf.SimModel):
    def compute(self, nlist, positions, box):
        rinv = htf.nlist_rinv(nlist)
        e = jnp.sum(2.0 * (rinv ** 12 - rinv ** 6), axis=1)
        return htf.compute_nlist_forces(nlist, e)


class TGenericLJ(htt.SimModel):
    def compute(self, nlist, positions, box):
        rinv = htt.nlist_rinv(nlist)
        e = torch.sum(2.0 * (rinv ** 12 - rinv ** 6), dim=1)
        return htt.compute_nlist_forces(nlist, e)


class JTypedLJ(htf.SimModel):
    def compute(self, nlist, positions, box):
        r2, tj = nlist.r2(), nlist.type
        pad = r2 > 0
        rinv2 = jnp.where(pad, 1.0 / jnp.maximum(r2, 1e-4),
                          jnp.zeros_like(r2))
        eps = 0.5 + 0.25 * (positions[:, 3][:, None] + tj)
        u = 4.0 * eps * (rinv2 ** 6 - rinv2 ** 3)
        e = 0.5 * jnp.sum(jnp.where(pad, u, 0.0), axis=1)
        return htf.compute_nlist_forces(nlist, e)


class TTypedLJ(htt.SimModel):
    """Per-type-pair epsilon through the type columns: separable, but
    only with the probe's (ti, tj) planes."""

    def compute(self, nlist, positions, box):
        if isinstance(nlist, htt.NlistPlanes):
            r2, tj = nlist.r2(), nlist.type
        else:
            r2 = torch.sum(nlist[..., :3] ** 2, dim=-1)
            tj = nlist[..., 3]
        pad = r2 > 0
        rinv2 = torch.where(pad, 1.0 / torch.clamp_min(r2, 1e-4),
                            torch.zeros_like(r2))
        eps = 0.5 + 0.25 * (positions[:, 3][:, None] + tj)
        u = 4.0 * eps * (rinv2 ** 6 - rinv2 ** 3)
        e = 0.5 * torch.sum(torch.where(pad, u, torch.zeros_like(u)), dim=1)
        return htt.compute_nlist_forces(nlist, e)


class JCrossLane(htf.SimModel):
    def compute(self, nlist, positions, box):
        s = jnp.sum(htf.nlist_rinv(nlist) ** 6, axis=1)
        return htf.compute_nlist_forces(nlist, 0.01 * s * s)


class TCrossLane(htt.SimModel):
    """Energy quadratic in the lane sum: not separable."""

    def compute(self, nlist, positions, box):
        s = torch.sum(htt.nlist_rinv(nlist) ** 6, dim=1)
        return htt.compute_nlist_forces(nlist, 0.01 * s * s)


class JField(htf.SimModel):
    def compute(self, nlist, positions, box):
        rinv = htf.nlist_rinv(nlist)
        e = jnp.sum(2.0 * (rinv ** 12 - rinv ** 6), axis=1)
        return htf.compute_nlist_forces(nlist, e) + \
            htf.compute_positions_forces(
                positions, 0.05 * jnp.sum(positions[:, :3] ** 2, axis=-1))


class TField(htt.SimModel):
    """A pair term plus a harmonic field in the positions: the field's
    force is invisible to a pair function."""

    def compute(self, nlist, positions, box):
        rinv = htt.nlist_rinv(nlist)
        e = torch.sum(2.0 * (rinv ** 12 - rinv ** 6), dim=1)
        return htt.compute_nlist_forces(nlist, e) + \
            htt.compute_positions_forces(
                positions, 0.05 * torch.sum(positions[:, :3] ** 2, dim=-1))


class JPair(htf.PairModel):
    def pair_energy(self, r2):
        rinv2 = 1.0 / r2
        return 4.0 * (rinv2 ** 6 - rinv2 ** 3)


class TPair(htt.PairModel):
    def pair_energy(self, r2):
        rinv2 = 1.0 / r2
        return 4.0 * (rinv2 ** 6 - rinv2 ** 3)


CASES = {"separable": (JGenericLJ, TGenericLJ, False, True),
         "typed": (JTypedLJ, TTypedLJ, True, True),
         "cross-lane": (JCrossLane, TCrossLane, False, False),
         "position-force": (JField, TField, False, False),
         "env-opt-out": (JGenericLJ, TGenericLJ, False, False),
         "pair-model": (JPair, TPair, False, False)}


def _sims(jcls, tcls, two_types, mode="cellwise"):
    jsim = htf.Simulation(dt=0.005, integrator=htf.md.NVE(), seed=11)
    jsim.init_lattice(n=N, density=0.3, kT_init=1.0)
    if two_types:
        jsim.state = dataclasses.replace(
            jsim.state, types=jnp.asarray(np.arange(N) % 2, jnp.int32))
    tsim = htt.Simulation(dt=0.005, integrator=htt.md.NVE(), seed=11,
                          device="cpu")
    tsim.set_state(state_from_numpy(jax_state_numpy(jsim.state),
                                    device="cpu"))
    jt, tt = htf.tfcompute(jcls(24)), htt.tfcompute(tcls(24))
    jt.attach(jsim, r_cut=2.5, nlist="cellwise")
    tt.attach(tsim, r_cut=2.5, nlist=mode)
    return (jsim, jt), (tsim, tt)


def _wrapped_close(a, b, lengths, atol):
    d = np_(a) - np_(b)
    L = np.asarray(lengths)
    d = d - np.round(d / L) * L
    np.testing.assert_allclose(d, 0.0, atol=atol)


@pytest.mark.parametrize("case", list(CASES))
def test_verdict_equals_jax(case, monkeypatch):
    jcls, tcls, typed, want = CASES[case]
    if case == "env-opt-out":
        monkeypatch.setenv("HTF_LANE_FAST", "0")
    (jsim, jt), (tsim, tt) = _sims(jcls, tcls, typed)
    jsim.run(STEPS)
    tsim.run(STEPS)
    assert bool(getattr(jt, "_lane_fast_ok", False)) is want
    assert tt._lane_fast_ok is want
    _wrapped_close(tsim.state.positions, jsim.state.positions,
                   tsim._lengths, atol=2e-3)


@pytest.mark.parametrize("case", ["separable", "typed"])
def test_validated_route_matches_packed_route(case):
    """The synthesized pair function on the cellwise route against the
    model itself on the packed cell list (the JAX test's comparison)."""
    jcls, tcls, typed, _ = CASES[case]
    (_, _), (a, ta) = _sims(jcls, tcls, typed)
    (_, _), (b, _) = _sims(jcls, tcls, typed, mode="cell")
    a.run(10)
    b.run(10)
    assert ta._lane_fast_ok is True
    _wrapped_close(a.state.positions, b.state.positions, a._lengths,
                   atol=2e-3)
    np.testing.assert_allclose(np_(a.state.velocities),
                               np_(b.state.velocities), rtol=1e-2,
                               atol=5e-3)


def test_synthesized_pair_fn_is_the_lane_energy():
    """On the separable LJ, the synthesized (U, dU/dr2) is the full pair
    LJ and its slope (nlist_rinv's offsets aside)."""
    box = htt.ops.box_from_lengths([10.0] * 3, device="cpu")
    fn = lane_fast.synthesize_pair_fn(TGenericLJ(8), box)
    r2 = torch.linspace(0.8, 6.0, 50)
    z = torch.zeros_like(r2)
    U, dU = fn(r2, z, z)
    sr6 = r2 ** -3
    torch.testing.assert_close(U, 4.0 * (sr6 * sr6 - sr6), rtol=1e-4,
                               atol=1e-5)
    torch.testing.assert_close(
        dU, -12.0 * (2.0 * sr6 - 1.0) * sr6 / r2, rtol=1e-4, atol=1e-5)


def test_probe_cached_and_retraced():
    """The verdict is cached per configuration and plan; retrace_compute
    invalidates it."""
    (_, _), (tsim, tt) = _sims(JGenericLJ, TGenericLJ, False)
    calls = []
    real = lane_fast.validate_pair_fn

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    lane_fast.validate_pair_fn = counting
    try:
        tsim.run(2)
        tsim.run(2)
        assert len(calls) == 1 and tt._lane_fast_ok
        tt.model.retrace_compute()
        tsim.run(2)
        assert len(calls) == 2
    finally:
        lane_fast.validate_pair_fn = real


def test_rows_at_the_cut_left_out():
    """A pair whose d2 sits within 1e-5 of the cut marks its two rows;
    the comparison leaves exactly those rows out, and fails on a
    difference anywhere else."""
    from hoomd_tf_tpu_torch.md.slots import SlotLayout
    from hoomd_tf_tpu_torch.md.state import init_state
    from hoomd_tf_tpu_torch.ops import cellwise as tcw
    pos = np.array([[0.0, 0.0, 0.0], [3.0 * (1 + 2e-6), 0.0, 0.0],
                    [-4.0, -4.0, -4.0], [-2.5, -4.0, -4.0]], np.float32)
    L = np.array([12.0] * 3)
    plan = tcw.plan_cellwise(4, L, 3.0, positions=pos, lo=-L / 2)
    layout = SlotLayout(plan, 4, -L / 2, device="cpu")
    st, aux = layout.pack(init_state(pos, L, device="cpu"))
    near = lane_fast.near_cut_rows(st, aux, layout)
    orig = np_(aux["orig"])
    assert sorted(orig[np_(near)].tolist()) == [0, 1]
    ref = torch.zeros((plan.n_slots, 4))
    ref[:, 0] = 1.0
    fast = ref.clone()
    fast[np_(near).nonzero()[0][0], 0] += 0.5
    ok, rep = lane_fast.route_errors(ref, fast, near)
    assert ok and rep["rows_at_the_cut"] == 2
    fast[int(np.nonzero(orig == 2)[0][0]), 0] += 0.5
    assert lane_fast.route_errors(ref, fast, near)[0] is False
