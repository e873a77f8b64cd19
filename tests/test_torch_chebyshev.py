"""Port vs JAX package: the Chebyshev pair proxy (``ops/chebyshev.py``),
``Dense``, and the proxy surface of ``PairModel``, on the same numpy
inputs and weights (carried across with ``interop``).

Tolerances: the fitted coefficients, the lane evaluation and the typed
blend at rtol 1e-5 (float32 arithmetic of one order in both packages;
atol 1e-5 of the largest value, for terms that cancel to near zero); a
loss through the fit into the NN's weights and its gradient at rtol 2e-4,
atol 2e-5 max|g|, the JAX package's bar for its proxy backward
(tests/test_pair_train.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import hoomd_tf_tpu as htf
from hoomd_tf_tpu.models.module import functional_call, get_state
from hoomd_tf_tpu.ops import chebyshev as jch
import hoomd_tf_tpu_torch as htt
from hoomd_tf_tpu_torch.interop import build_model, load_jax_variables
from hoomd_tf_tpu_torch.ops import chebyshev as tch

from torch_helpers import nn_pair_class, np_, seed_jax_weights

R_CUT = 2.5
R2_LO, R2_HI = (0.25 * R_CUT) ** 2, R_CUT ** 2


def close(a, b, rtol=1e-5, atol_rel=1e-5):
    a, b = np_(a), np_(b)
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=atol_rel * np.abs(b).max())


class JNNPair(htf.PairModel):
    """north_star.py's TrainableNNPair (JAX)."""

    def setup(self):
        self.dense1 = htf.Dense(16)
        self.last = htf.Dense(1)

    def pair_energy(self, r2):
        x = jax.nn.tanh(self.dense1(jax.lax.rsqrt(r2)[..., None]))
        return 2.0 * self.last(x)[..., 0]


def nn_pair_models(degree=16, seed=0):
    """The same NN pair potential in both packages, both built, with
    weights drawn from ``seed`` carried from the JAX model into the
    port's."""
    jm = JNNPair(64, output_forces=False, proxy_degree=degree)
    jm.pair_energy(jnp.ones(4))                 # builds the lazy layers
    seed_jax_weights(jm, seed)
    tm = nn_pair_class()(64, output_forces=False, proxy_degree=degree)
    build_model(tm, R_CUT, "cpu")
    load_jax_variables(tm, jm.get_weights())
    return jm, tm


def lanes(n=4000, seed=0, lo=0.2):
    """Lane ``r2`` values across the fit range, below its inner edge (the
    linear continuation) and past r_cut."""
    return np.random.RandomState(seed).uniform(
        lo, 1.1 * R2_HI, n).astype(np.float32)


def jax_fit(fit, energy):
    return fit(lambda r2, *t: (energy(r2, *t), None))


def jax_coeff_arrays(c, pairs=None):
    if pairs is None:
        return np.asarray(c["c"]), np.asarray(c["cd"])
    return (np.stack([np.asarray(c[p]["c"]) for p in pairs]),
            np.stack([np.asarray(c[p]["cd"]) for p in pairs]))


def _lj_energy(r2):
    u = 1.0 / r2
    sr6 = u * u * u
    return 4.0 * (sr6 * sr6 - sr6)


@pytest.mark.parametrize("K", [8, 16])
def test_fit_and_evaluate_match_jax(K):
    """The fit (node, DCT and derivative matrices) and the lane
    evaluation, on an energy both packages compute bit for bit."""
    jfit, jev = jch.make_pair_proxy(K, R2_LO, R2_HI)
    tfit, tev = tch.make_pair_proxy(K, R2_LO, R2_HI, device="cpu")
    assert tev.basis == jev.basis
    jc = jax_fit(jfit, _lj_energy)
    tc = tfit(_lj_energy)
    c, cd = jax_coeff_arrays(jc)
    close(tc["c"], c)
    close(tc["cd"], cd)
    r2 = lanes()
    U_j, s_j = jev(jc, jnp.asarray(r2))
    for fn in (tev, lambda co, r: tev.kernel_form(co).evaluate(r)):
        # the evaluator, and the K1 proxy form's plain lane function
        U_t, s_t = fn(tc, torch.as_tensor(r2))
        close(U_t, U_j)
        close(s_t, s_j)


def test_nn_proxy_matches_jax():
    """The NN pair potential's proxy: the coefficients at rtol 1e-5, and
    the lanes from the same coefficients at rtol 1e-5. End to end (each
    package fitting its own NN) the lanes agree to 1e-3 of their largest
    value: the two packages' tanh and rsqrt differ in the last bit at
    the nodes, and the derivative series (entries up to 2(K-1)/half)
    magnifies that near the fit's inner edge."""
    jm, tm = nn_pair_models()
    jfit, jev = jm.proxy_parts(R_CUT)
    tfit, tev = tm.proxy_parts(R_CUT, "cpu")
    jc = jax_fit(jfit, jm.pair_energy)
    with torch.no_grad():
        tc = tfit(tm.pair_energy)
    c, cd = jax_coeff_arrays(jc)
    close(tc["c"], c)
    r2 = lanes()
    U_j, s_j = jev(jc, jnp.asarray(r2))
    same = {"c": torch.as_tensor(c), "cd": torch.as_tensor(cd)}
    for co, atol_rel in ((same, 1e-5), (tc, 1e-3)):
        U_t, s_t = tev(co, torch.as_tensor(r2))
        close(U_t, U_j, atol_rel=atol_rel)
        close(s_t, s_j, atol_rel=atol_rel)


def _typed_energy(xp):
    def energy(r2, ti, tj):
        u = 1.0 / r2
        sr6 = u * u * u
        return 4.0 / (1.0 + ti + tj) * (sr6 * sr6 - sr6)
    return energy


@pytest.mark.parametrize("T", [2, 3])
def test_typed_blend_matches_jax(T):
    jfit, jev = jch.make_typed_pair_proxy(16, R2_LO, R2_HI, T)
    tfit, tev = tch.make_typed_pair_proxy(16, R2_LO, R2_HI, T,
                                          device="cpu")
    assert tev.basis == jev.basis
    jc = jax_fit(jfit, _typed_energy(jnp))
    tc = tfit(_typed_energy(torch))
    pairs = jev.basis["pairs"]
    c, cd = jax_coeff_arrays(jc, pairs)
    close(tc["c"], c)
    close(tc["cd"], cd)
    rng = np.random.RandomState(1)
    r2 = lanes(3000)
    # types beyond the table (T) get zero coefficients in both
    ti = rng.randint(0, T + 1, r2.shape).astype(np.float32)
    tj = rng.randint(0, T + 1, r2.shape).astype(np.float32)
    U_j, s_j = jev(jc, *(jnp.asarray(a) for a in (r2, ti, tj)))
    targs = [torch.as_tensor(a) for a in (r2, ti, tj)]
    U_t, s_t = tev(tc, *targs)
    close(U_t, U_j)
    close(s_t, s_j)
    form = tev.kernel_form(tc)
    assert form.table.shape == (len(pairs), 2, 16)
    U_k, s_k = form.evaluate(targs[0], targs[1].int(), targs[2].int())
    close(U_k, U_j)
    close(s_k, s_j)


def test_gradient_through_fit_matches_jax():
    """d/dweights of a weighted lane sum of the proxy's energy and slope:
    autograd through the port's node fit against jax.grad through the
    JAX package's. The sum's random-signed terms cancel to a few percent
    of their size, so its value is held to 2e-4 of the terms' summed
    magnitude; the gradients to the JAX bar."""
    jm, tm = nn_pair_models()
    rng = np.random.RandomState(2)
    r2 = lanes(2000, seed=3)
    a = rng.randn(r2.size).astype(np.float32)
    b = rng.randn(r2.size).astype(np.float32)
    jfit, jev = jm.proxy_parts(R_CUT)
    tfit, tev = tm.proxy_parts(R_CUT, "cpu")

    values = get_state(jm)
    trainable = [i for i, v in enumerate(jm.variables) if v.trainable]
    assert len(trainable) == 4

    def jloss(train_values):
        vals = list(values)
        for i, v in zip(trainable, train_values):
            vals[i] = v

        def body():
            U, s = jev(jfit(jm.pair_energy_and_slope), jnp.asarray(r2))
            return jnp.sum(a * U) + jnp.sum(b * s)
        return functional_call(jm, vals, body)[0]

    jv = [values[i] for i in trainable]
    jl, jg = jax.value_and_grad(jloss)(jv)
    U, s = tev(tfit(tm.pair_energy), torch.as_tensor(r2))
    terms = torch.cat([torch.as_tensor(a) * U, torch.as_tensor(b) * s])
    loss = torch.sum(terms)
    assert abs(float(loss.detach()) - float(jl)) <= \
        2e-4 * float(terms.detach().abs().sum())
    loss.backward()
    tvars = [tm.variables[i] for i in trainable]
    scale = max(np.abs(np.asarray(g)).max() for g in jg)
    for v, g in zip(tvars, jg):
        np.testing.assert_allclose(np_(v.grad), np.asarray(g), rtol=2e-4,
                                   atol=2e-5 * scale)


def test_variables_follow_jax_order():
    """Both models list the two SimModel bookkeeping variables, then each
    Dense's kernel before its bias, in assignment order."""
    jm, tm = nn_pair_models()
    shapes = [tuple(np.shape(w)) for w in jm.get_weights()]
    assert [tuple(v.shape) for v in tm.variables] == shapes
    assert shapes[2:] == [(1, 16), (16,), (16, 1), (1,)]
    for a, b in zip(tm.get_weights(), jm.get_weights()):
        np.testing.assert_array_equal(a, b)
    # get_weights hands out copies: training the model leaves them be
    w = tm.get_weights()
    with torch.no_grad():
        tm.last.bias.add_(1.0)
    assert not np.array_equal(w[-1], tm.get_weights()[-1])


def test_dense_lazy_glorot_init():
    gens = [torch.Generator().manual_seed(7) for _ in range(2)]
    a, b = (htt.Dense(16, generator=g) for g in gens)
    assert a.kernel is None and a.variables == []
    ya = a(torch.ones(5, 3))
    b(torch.ones(2, 3))
    assert ya.shape == (5, 16)
    assert [tuple(v.shape) for v in a.variables] == [(3, 16), (16,)]
    limit = np.sqrt(6.0 / (3 + 16))
    k = np_(a.kernel)
    assert np.abs(k).max() <= limit and np.abs(k).std() > 0.2 * limit
    assert not np_(a.bias).any()
    np.testing.assert_array_equal(k, np_(b.kernel))
    assert all(isinstance(v, torch.nn.Parameter) for v in a.variables)


def test_proxy_config_and_checks():
    NN = nn_pair_class()
    m = NN(32, proxy_degree=12, proxy_r_lo=0.8)
    cfg = m.get_config()
    assert cfg["proxy_degree"] == 12 and cfg["proxy_r_lo"] == 0.8
    m2 = NN.from_config(cfg)
    assert (m2.proxy_degree, m2.proxy_r_lo) == (12, 0.8)

    class Typed(htt.PairModel):
        def pair_energy(self, r2, ti, tj):
            return r2 * 0.0

    with pytest.raises(ValueError, match="proxy_types"):
        Typed(16, proxy_degree=8)
    t = Typed(16, proxy_degree=8, proxy_types=2)
    form = t.pair_kernel_form(R_CUT, "cpu")
    assert form.ntypes == 2 and form.table.shape == (3, 2, 8)


def test_proxy_pair_fn_matches_jax():
    """Each package fits its own NN: the lanes agree to 1e-3 of their
    largest value, the end-to-end bar of test_nn_proxy_matches_jax (which
    depends on the weights: over eight draws one reached 3e-3 on a few
    lanes; this draw stays inside)."""
    jm, tm = nn_pair_models()
    r2 = lanes(500, seed=5)
    U_j, s_j = jm.proxy_pair_fn(R_CUT)(jnp.asarray(r2))
    with torch.no_grad():
        U_t, s_t = tm.proxy_pair_fn(R_CUT, "cpu")(torch.as_tensor(r2))
    close(U_t, U_j, atol_rel=1e-3)
    close(s_t, s_j, atol_rel=1e-3)
