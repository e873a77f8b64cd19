"""Typed online training with a Chebyshev proxy on the port against the JAX
package, and kernel K2's typed path on the CPU.

- A binary A:B = 80:20 fluid (N = 512, density 0.4) labelled by the
  Kob-Andersen mixture's built-in LJ (Phys. Rev. E 51, 4626 (1995)),
  trained online on 'cellwise' by a typed proxy NN (``pair_energy(r2, ti,
  tj)`` on 1/r and the unordered type pair's one-hot, ``proxy_degree=16``,
  ``proxy_types=2``): five SGD train steps in both packages from the same
  seeded state and the same weights (``interop.load_jax_variables``).
  SGD keeps Adam's rounding of a near-zero gradient out of the
  comparison. Losses per step, the final weights and the final proxy
  coefficients at the existing pair-train parity bar
  (tests/test_torch_train.py: a 5-step SGD trajectory at rtol 1e-3, the
  weights with atol 1e-6; the coefficients, which the weights give, at
  that rtol with tests/test_torch_chebyshev.py's atol for fitted
  coefficients, 1e-5 of the largest, for the high terms that cancel to
  near zero).
- K2's plain version (what the wrapper runs on a CPU tensor) against the
  JAX package's typed XLA lane contraction (``bwd_impl='xla'``) at 2, 3
  and 8 types, with and without a per-type cutoff matrix, at the JAX bar
  for its proxy backward (rtol 2e-4, atol 2e-5 max|g|).
- The tile path's walk (``pair_train_cuda.tile_walk``, a model of
  ``csrc/proxy_bwd.cu::tile_block``): every (home row, staged candidate)
  lane of types in the table is walked exactly once, in the block of its
  unordered type pair; a pair's row of the block's sums is written by at
  most one warp; and every column of the ``[P * 2K]`` partial row by
  exactly one pass.
"""

import collections

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
from hoomd_tf_tpu_torch.ops import cellwise as tcw
from hoomd_tf_tpu_torch.ops import chebyshev as tch
from hoomd_tf_tpu_torch.ops import pair_train_cuda as tptc

from torch_helpers import (fluid_arrays, force_loss, jax_state,
                           jax_state_numpy, np_, seed_jax_weights,
                           torch_state)

R_CUT = 2.5
# the Kob-Andersen mixture (A-A, A-B, B-B)
KA_EPS = [[1.0, 1.5], [1.5, 0.5]]
KA_SIG = [[1.0, 0.8], [0.8, 0.88]]


def mixture_types(n, seed=0):
    """A:B = 80:20 by a seeded permutation: type 1 on the last fifth."""
    perm = np.random.RandomState(seed).permutation(n)
    return (perm >= 0.8 * n).astype(np.int32)


class JTypedNN(htf.PairModel):
    """Phase 39's typed proxy NN (JAX): an MLP (16 -> 1) on 1/r and the
    one-hot of the unordered type pair (ti + tj for two types)."""

    def setup(self):
        self.dense1 = htf.Dense(16)
        self.last = htf.Dense(1)

    def pair_energy(self, r2, ti, tj):
        s = ti + tj
        x = jnp.concatenate(
            [jax.lax.rsqrt(r2)[..., None]] +
            [(s == k).astype(r2.dtype)[..., None] for k in range(3)], -1)
        return 2.0 * self.last(jax.nn.tanh(self.dense1(x)))[..., 0]


class TTypedNN(htt.PairModel):
    """The same model in the port."""

    def setup(self):
        self.dense1 = htt.Dense(16)
        self.last = htt.Dense(1)

    def pair_energy(self, r2, ti, tj):
        s = ti + tj
        x = torch.cat(
            [torch.rsqrt(r2)[..., None]] +
            [(s == k).to(r2.dtype)[..., None] for k in range(3)], -1)
        return 2.0 * self.last(torch.tanh(self.dense1(x)))[..., 0]


def j_force_loss(yt, yp):
    return jnp.mean((yt[:, :3] - yp[:, :3]) ** 2)


def typed_trainers(lr, n=512, seed=1):
    """A JAX and a port simulation of the 80:20 mixture from the same
    state and weights, each training the typed proxy NN online (SGD)
    against the mixture's built-in LJ: ``(jsim, jtfc, jm), (tsim, ttfc,
    tm)``."""
    pos, vel, lengths = fluid_arrays(n, 0.4, seed, kT=1.5)
    types = mixture_types(n, seed)
    js = jax_state(pos, vel, lengths, types=types)
    jsim = htf.Simulation(dt=0.005, integrator=htf.md.NVT(kT=1.5, tau=0.5),
                          seed=seed)
    jsim.set_state(js)
    jsim.add_force(htf.md.LennardJones(epsilon=KA_EPS, sigma=KA_SIG,
                                       r_cut=R_CUT))
    jm = JTypedNN(64, output_forces=False, proxy_degree=16, proxy_types=2)
    jm.pair_energy(jnp.ones(4), jnp.zeros(4), jnp.zeros(4))
    seed_jax_weights(jm, 0)
    jm.compile(optimizer="sgd", loss=j_force_loss, learning_rate=lr)
    jtfc = htf.tfcompute(jm)
    jtfc.attach(jsim, r_cut=R_CUT, nlist="cellwise", train=True)

    tsim = htt.Simulation(dt=0.005, integrator=htt.md.NVT(kT=1.5, tau=0.5),
                          seed=seed, device="cpu")
    tsim.set_state(state_from_numpy(jax_state_numpy(js), device="cpu"))
    tsim.add_force(htt.md.LennardJones(epsilon=KA_EPS, sigma=KA_SIG,
                                       r_cut=R_CUT))
    tm = TTypedNN(64, output_forces=False, proxy_degree=16, proxy_types=2)
    build_model(tm, R_CUT, "cpu")
    load_jax_variables(tm, jm.get_weights())
    tm.compile(optimizer="sgd", loss=force_loss, learning_rate=lr)
    ttfc = htt.tfcompute(tm)
    ttfc.attach(tsim, r_cut=R_CUT, nlist="cellwise", train=True)
    # the same plan in both (the loss averages over slot rows, ghosts
    # included): the JAX planner prices a typed proxy's lane by counting
    # its traced primitives (the masks, the blend and the fit at the
    # nodes), the port's by an operation count of the Chebyshev series,
    # which the card's typed table does not change (K1 reads a pair's
    # coefficients, it does not blend them)
    scale = jsim._model_lane_cost_scale()
    tsim._model_lane_cost_scale = lambda: scale
    return (jsim, jtfc, jm), (tsim, ttfc, tm)


def coeff_arrays(jm, tm):
    """The final proxy coefficients of both models, ``[P, 2K]`` numpy."""
    fit, _ = jm.proxy_parts(R_CUT)
    jc = fit(jm.pair_energy_and_slope)
    with torch.no_grad():
        tc = tm.proxy_coeffs(R_CUT, "cpu")
    pairs = tch.type_pairs(2)
    j = np.concatenate([np.stack([np.asarray(jc[p][k]) for p in pairs])
                        for k in ("c", "cd")], axis=1)
    t = np.concatenate([np_(tc["c"]), np_(tc["cd"])], axis=1)
    return j, t


def test_typed_sgd_trajectory_matches_jax():
    """Five SGD train steps of the typed proxy on the 80:20 mixture: the
    losses, the weights and the proxy coefficients against the JAX
    package's; the port's CPU run takes K2's plain version (no launch)."""
    (jsim, jtfc, jm), (tsim, ttfc, tm) = typed_trainers(1e-3)
    before = tptc.proxy_bwd_moments.launches
    jsim.run(5)
    tsim.run(5)
    jp, tp = jsim._layout.plan, tsim._layout.plan
    assert (tp.grid, tp.capacity) == (jp.grid, jp.capacity)
    assert tsim.train_steps == 5
    assert tptc.proxy_bwd_moments.launches == before
    assert len(ttfc.loss_history) == len(jtfc.loss_history) == 5
    np.testing.assert_allclose(ttfc.loss_history, jtfc.loss_history,
                               rtol=1e-3)
    for a, b in zip(tm.get_weights()[2:], jm.get_weights()[2:]):
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64), rtol=1e-3,
                                   atol=1e-6)
    jc, tc = coeff_arrays(jm, tm)
    assert tc.shape == (3, 32)
    np.testing.assert_allclose(tc, jc, rtol=1e-3,
                               atol=1e-5 * np.abs(jc).max())


def energy(r2, ti, tj):
    """A smooth, bounded typed pair energy (rational, so both packages
    compute it alike; tests/test_torch_pair_train.py's)."""
    u = 1.0 / r2
    return 0.9 / (1.0 + ti + tj) * (u * u - 2.0 * u) / (1.0 + u * u)


def packed_types(n, T, rc_matrix, seed=3):
    """tests/torch_helpers.packed_pair with ``T`` types (slot % T)."""
    pos, vel, lengths = fluid_arrays(n, 0.35, seed)
    types = np.arange(n) % T
    js = jax_state(pos, vel, lengths, types=types)
    ts = torch_state(pos, vel, lengths, types=types)
    lo = np.asarray(js.box[0])
    jplan = jcw.plan_cellwise(n, lengths, R_CUT, positions=pos, lo=lo)
    tplan = tcw.plan_cellwise(n, lengths, R_CUT, positions=pos, lo=lo)
    assert (tplan.grid, tplan.capacity) == (jplan.grid, jplan.capacity)
    jl = JLayout(jplan, n, lo)
    tl = TLayout(tplan, n, lo, rc_matrix=rc_matrix, device="cpu")
    jss, jaux, _ = jl.pack(js)
    tss, taux = tl.pack(ts)
    return (jl, jss, jaux), (tl, tss, taux)


def rc_matrix(T):
    """A symmetric ``[T, T]`` cutoff matrix between 1.8 and 2.5."""
    a = np.arange(T)
    return (2.5 - 0.7 * np.abs(a[:, None] - a[None, :]) /
            max(1, T - 1)).astype(np.float32)


@pytest.mark.parametrize("rcut", [False, True])
@pytest.mark.parametrize("T", [2, 3, 8])
def test_typed_k2_plain_matches_jax_xla(T, rcut):
    """K2's plain version at ``T`` types (with energy) against the
    gradient of the JAX typed primal through its XLA lane contraction."""
    K = 8
    rc = rc_matrix(T) if rcut else None
    (jl, jss, jaux), (tl, tss, taux) = packed_types(256, T, rc)
    r2_lo = (0.25 * R_CUT) ** 2
    jfit, jev = jch.make_typed_pair_proxy(K, r2_lo, R_CUT ** 2, T)
    tfit, tev = tch.make_typed_pair_proxy(K, r2_lo, R_CUT ** 2, T,
                                          device="cpu")
    jc = jfit(lambda r2, *t: (energy(r2, *t), None))
    ct = np.random.RandomState(5).randn(tl.plan.n_slots, 4).astype(
        np.float32)
    g_c, g_cd = tptc.proxy_bwd_moments(
        tss.positions, tss.types, taux["valid"], torch.as_tensor(ct),
        tl.plan, tl.lo, tev.basis, rc2_tab=tl.rc2_tab, geometry=tl.geometry)
    got = np.concatenate([np_(g_c), np_(g_cd)], axis=1).ravel()

    def primal(c):
        return j_ptf(c, jev, jss.positions, jss.types, jaux["valid"],
                     jl.plan, jl.lo, with_types=True, rcut_matrix=rc,
                     needs_energy=True, fwd_stencil="full", bwd_impl="xla")
    _, vjp = jax.vjp(primal, jc)
    g = vjp(jnp.asarray(ct))[0]
    want = np.concatenate([np.concatenate([np.asarray(g[p]["c"]),
                                           np.asarray(g[p]["cd"])])
                           for p in jev.basis["pairs"]])
    assert got.size == T * (T + 1) * K
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5 * scale)


@pytest.mark.parametrize("T,Q,n0,extra,outside", [
    (1, 1, 30, 150, False), (2, 3, 24, 140, False), (2, 1, 24, 140, True),
    (3, 6, 11, 60, True), (3, 4, 0, 40, False), (5, 15, 17, 90, True),
    (8, 36, 24, 150, True), (8, 10, 36, 300, False)])
def test_tile_walk_visits_each_lane_once(T, Q, n0, extra, outside):
    """The tile path's walk on random staged types (``outside``: some of
    a type outside the table): each lane of types in the table once, in
    its unordered pair's block; each pair's row written by at most one
    warp, and each pair summed in exactly one pass."""
    rng = np.random.RandomState(T * 100 + Q)
    keys = rng.randint(0, T + (1 if outside else 0), n0 + extra).tolist()
    if T == 1:
        keys = [0] * len(keys)
    lanes, flushes = tptc.tile_walk(keys, n0, T, Q)
    seen = collections.Counter((i, j) for _, _, i, j in lanes)
    want = {(i, j) for i in range(n0) for j in range(len(keys))
            if keys[i] < T and keys[j] < T}
    assert set(seen) == want
    assert set(seen.values()) <= {1}
    pairs = tch.type_pairs(T)
    for p, _, i, j in lanes:
        assert pairs[p] == tuple(sorted((keys[i], keys[j])))
    rows = collections.Counter(p for p, _, d in flushes if d == "row")
    assert set(rows.values()) <= {1}
    # in each pass, a warp's first flush (its first pair) goes to its own
    # slot, the others to their pairs' rows, in pair order
    by_warp = collections.defaultdict(list)
    for p, w, d in flushes:
        by_warp[p // Q, w].append((p, d))
    for w, fl in by_warp.items():
        assert fl[0][1] == "first"
        assert all(d == "row" for _, d in fl[1:])
        assert [p for p, _ in fl] == sorted({p for p, _ in fl})
    # the passes: consecutive ranges of Q pairs covering every column once
    P = T * (T + 1) // 2
    K2 = 32
    cols = [p * K2 + m for p0 in range(0, P, Q)
            for p in range(p0, min(P, p0 + Q)) for m in range(K2)]
    assert sorted(cols) == list(range(P * K2))
