"""Port vs JAX package: forces and virial from energies by autodiff
(``ops/forces.py``) through a SimModel call, on the same numpy inputs.

The JAX package replays ``compute`` under ``jax.vjp``; the port
differentiates the energy on PyTorch's tape. Tolerance rtol = atol =
1e-5: autograd sums the per-neighbor terms in another order. Padded rows
must give exactly zero force and no NaN."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import hoomd_tf_tpu as htf
import hoomd_tf_tpu_torch as htt

from torch_helpers import nlist_with_padding, np_

TOL = dict(rtol=1e-5, atol=1e-5)


def lj_energy(rinv, xp):
    inv_r6 = rinv ** 6
    return xp.sum(4.0 / 2.0 * (inv_r6 * inv_r6 - inv_r6), axis=1) \
        if xp is jnp else torch.sum(4.0 / 2.0 * (inv_r6 * inv_r6 - inv_r6),
                                    dim=1)


class JLJ(htf.SimModel):
    def compute(self, nlist, positions, box):
        return htf.compute_nlist_forces(
            nlist, lj_energy(htf.nlist_rinv(nlist), jnp), virial=self.virial)


class TLJ(htt.SimModel):
    def compute(self, nlist, positions, box):
        return htt.compute_nlist_forces(
            nlist, lj_energy(htt.nlist_rinv(nlist), torch),
            virial=self.virial)


class JCallable(htf.SimModel):
    def compute(self, nlist):
        return htf.compute_nlist_forces(
            nlist, lambda nl: lj_energy(htf.nlist_rinv(nl), jnp))


class TCallable(htt.SimModel):
    def compute(self, nlist):
        return htt.compute_nlist_forces(
            nlist, lambda nl: lj_energy(htt.nlist_rinv(nl), torch))


class JPos(htf.SimModel):
    def compute(self, nlist, positions):
        e = jnp.sum(jnp.sin(positions[:, :3]) * positions[:, :3] ** 2,
                    axis=1)
        return htf.compute_positions_forces(positions, e)


class TPos(htt.SimModel):
    def compute(self, nlist, positions):
        e = torch.sum(torch.sin(positions[:, :3]) * positions[:, :3] ** 2,
                      dim=1)
        return htt.compute_positions_forces(positions, e)


def inputs(seed=0, n=40, nn=12):
    nl = nlist_with_padding(n, nn, seed)
    # keep neighbors outside overlap so the LJ forces stay moderate
    nl[..., :3] *= 1.5
    pos = np.random.RandomState(seed + 1).uniform(
        -2, 2, (n, 4)).astype(np.float32)
    box = np.array([[-5, -5, -5], [5, 5, 5], [0, 0, 0]], np.float32)
    return nl, pos, box


def run_both(jm, tm, seed=0):
    nl, pos, box = inputs(seed)
    jout = jm([jnp.asarray(nl), jnp.asarray(pos), jnp.asarray(box)])
    tout = tm([torch.as_tensor(nl), torch.as_tensor(pos),
               torch.as_tensor(box)])
    return nl, jout, tout


@pytest.mark.parametrize("virial", [False, True])
def test_nlist_forces_match_jax(virial):
    nl, jout, tout = run_both(JLJ(12, virial=virial), TLJ(12, virial=virial))
    assert len(tout) == (2 if virial else 1)
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(np_(t), np_(j), **TOL)
    assert not tout[0].requires_grad   # an eval call keeps no graph
    pad = ~nl[..., :3].any(-1).any(-1)
    assert pad.sum() >= 3
    f = np_(tout[0])
    assert np.all(np.isfinite(f)) and np.all(f[pad, :3] == 0)


def test_callable_energy_matches_jax():
    _, jout, tout = run_both(JCallable(12), TCallable(12), seed=1)
    np.testing.assert_allclose(np_(tout[0]), np_(jout[0]), **TOL)
    # outside any model too
    nl = torch.as_tensor(inputs(2)[0])
    f = htt.compute_nlist_forces(
        nl, lambda x: lj_energy(htt.nlist_rinv(x), torch))
    fj = htf.compute_nlist_forces(
        jnp.asarray(np_(nl)), lambda x: lj_energy(htf.nlist_rinv(x), jnp))
    np.testing.assert_allclose(np_(f), np_(fj), **TOL)


def test_positions_forces_match_jax():
    _, jout, tout = run_both(JPos(12), TPos(12), seed=3)
    np.testing.assert_allclose(np_(tout[0]), np_(jout[0]), **TOL)


def test_slice_of_the_nlist():
    """The gradient root may be any tensor derived from the model's nlist
    (here two row slices): the forces equal the whole-list forces."""
    class Halves(htt.SimModel):
        def compute(self, nlist):
            a, b = nlist[:20], nlist[20:]
            fa = htt.compute_nlist_forces(a, lj_energy(htt.nlist_rinv(a),
                                                       torch))
            fb = htt.compute_nlist_forces(b, lj_energy(htt.nlist_rinv(b),
                                                       torch))
            return torch.cat([fa, fb])
    nl, _, tout = run_both(JLJ(12), TLJ(12), seed=4)
    halves = Halves(12)([torch.as_tensor(nl)])[0]
    np.testing.assert_allclose(np_(halves), np_(tout[0]), rtol=1e-6,
                               atol=1e-6)


def test_training_keeps_the_graph():
    """With training=True the forces stay differentiable in the weights:
    d(sum F^2)/d(eps) equals the analytic 2 sum F^2 / eps."""
    class Eps(htt.SimModel):
        def setup(self):
            self.eps = self.add_weight((), initializer=0.7)

        def compute(self, nlist, training):
            e = self.eps * lj_energy(htt.nlist_rinv(nlist), torch)
            return htt.compute_nlist_forces(nlist, e)
    m = Eps(12)
    nl = torch.as_tensor(inputs(5)[0])
    f = m([nl], training=True)[0]
    loss = torch.sum(f[:, :3] ** 2)
    g, = torch.autograd.grad(loss, m.eps)
    np.testing.assert_allclose(g.item(), 2 * loss.item() / 0.7, rtol=1e-5)
    assert not m([nl], training=False)[0].requires_grad


def test_value_energy_needs_a_graph():
    with pytest.raises(ValueError, match="require grad"):
        nl = torch.as_tensor(inputs(6)[0])
        htt.compute_nlist_forces(nl, torch.ones(nl.shape[0],
                                                requires_grad=True) * 2)


def test_check_nlist_sets_the_device_flag():
    """check_nlist ORs a device flag (it never reads it back); the
    tfcompute raises on it after a run."""
    nl, pos, box = (torch.as_tensor(a) for a in inputs(7))
    m = TLJ(12, check_nlist=True)
    m([nl, pos, box])
    full = bool((nl[:, :, 0] > 0).sum(1).max() >= 12)
    assert bool(m.nlist_overflow) == full
    m.nlist_overflow.zero_()
    m([nl[:, :6], pos, box])
    assert bool(m.nlist_overflow) is False
