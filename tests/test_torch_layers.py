"""The stateful layers and the state helpers, port against the JAX
package: ``Mean``, ``MeanTensor``, ``get_state``, ``set_state``,
``functional_call``, ``WCARepulsion`` (with its regularizer) and
``EDSLayer`` (the cases of tests/test_model.py:106-132, 215-229 and
243-249). Inputs are made with numpy from a seed and handed to both
packages.

Tolerances: metric counts exactly, metric values and the state helpers'
values at rtol 1e-6; the WCA energy and the gradients through
``functional_call`` at rtol 1e-5; the EDS state after every call at rtol
1e-5 (atol 1e-7 for entries that are zero in one package and a rounding
away in the other)."""

import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hoomd_tf_tpu as htf
import hoomd_tf_tpu_torch as htt
from hoomd_tf_tpu_torch.interop import build_model, load_jax_variables

from torch_helpers import np_


def inputs(n=9, NN=8, seed=0, L=8.0, r_cut=4.0):
    """The same ``[nlist, positions, box]`` for both packages (the JAX
    test's ``make_inputs``): the JAX dense list, carried to the port."""
    rng = np.random.RandomState(seed)
    box_l = np.array([L, L, L], dtype=np.float32)
    pos = (rng.rand(n, 3) * box_l - box_l / 2).astype(np.float32)
    pos4 = np.concatenate([pos, np.zeros((n, 1), np.float32)], axis=1)
    nlist = np.asarray(htf.compute_nlist(jnp.asarray(pos4), r_cut, NN, box_l,
                                         sorted=True, return_types=True))
    box = np.asarray(htf.box_from_lengths(box_l))
    j = [jnp.asarray(nlist), jnp.asarray(pos4), jnp.asarray(box)]
    t = [torch.as_tensor(np.array(a)) for a in (nlist, pos4, box)]
    return j, t


class JMeanModel(htf.SimModel):
    """tests/zoo.py's LJRunningMeanModel."""

    def setup(self):
        self.avg_energy = htf.Mean()

    def compute(self, nlist, positions, box):
        rinv = htf.nlist_rinv(nlist)
        r6 = rinv ** 6
        energy = jnp.sum(2.0 * (r6 * r6 - r6), axis=1)
        self.avg_energy.update_state(energy)
        return htf.compute_nlist_forces(nlist, energy)


class TMeanModel(htt.SimModel):
    def setup(self):
        self.avg_energy = htt.Mean()

    def compute(self, nlist, positions, box):
        rinv = htt.nlist_rinv(nlist)
        r6 = rinv ** 6
        energy = torch.sum(2.0 * (r6 * r6 - r6), dim=1)
        self.avg_energy.update_state(energy)
        return htt.compute_nlist_forces(nlist, energy)


class JScaledLJ(htf.SimModel):
    """LJ scaled by a trainable Variable, with a running mean."""

    def setup(self):
        self.eps = htf.Variable(1.3, name="eps")
        self.avg = htf.Mean()

    def compute(self, nlist, positions, box):
        rinv = htf.nlist_rinv(nlist)
        r6 = rinv ** 6
        energy = self.eps * jnp.sum(2.0 * (r6 * r6 - r6), axis=1)
        self.avg.update_state(energy)
        return htf.compute_nlist_forces(nlist, energy)


class TScaledLJ(htt.SimModel):
    def setup(self):
        self.eps = htt.Variable(1.3, name="eps")
        self.avg = htt.Mean()

    def compute(self, nlist, positions, box):
        rinv = htt.nlist_rinv(nlist)
        r6 = rinv ** 6
        energy = self.eps * torch.sum(2.0 * (r6 * r6 - r6), dim=1)
        self.avg.update_state(energy)
        return htt.compute_nlist_forces(nlist, energy)


def test_metrics_update_once_per_call():
    """A model call updates its metric once (JAX
    test_metrics_update_once_per_call): count 9, then 18."""
    _, t = inputs()
    model = TMeanModel(8)
    model(t)
    assert float(model.avg_energy.count.value) == 9.0
    model(t)
    assert float(model.avg_energy.count.value) == 18.0


@pytest.mark.parametrize("kind", ["mean", "mean_tensor"])
def test_metrics_match_jax(kind):
    """The same seeded values through both packages' metric: counts
    exactly, totals and results at 1e-6; reset zeroes both."""
    rng = np.random.RandomState(3)
    jm = htf.Mean() if kind == "mean" else htf.MeanTensor()
    tm = htt.Mean() if kind == "mean" else htt.MeanTensor()
    for shape in [(5,), (5,), (5,), (5,)]:
        x = rng.randn(*shape).astype(np.float32)
        jm.update_state(jnp.asarray(x))
        tm(torch.as_tensor(x))
        np.testing.assert_array_equal(np_(tm.count.value),
                                      np.asarray(jm.count.value))
        np.testing.assert_allclose(np_(tm.total.value),
                                   np.asarray(jm.total.value), rtol=1e-6)
        np.testing.assert_allclose(np_(tm.result()), np.asarray(jm.result()),
                                   rtol=1e-6)
    assert [tuple(v.shape) for v in tm.variables] == \
        [tuple(v.value.shape) for v in jm.variables]
    tm.reset_state()
    assert float(tm.count.value.sum()) == 0.0
    assert float(tm.result().abs().sum()) == 0.0


def test_metric_keeps_no_graph():
    """A metric updated from a value that carries a graph keeps none of
    it: over 1000 updates every input leaf is freed (no graph grows from
    step to step), and the stored values carry no gradient."""
    m, mt = htt.Mean(), htt.MeanTensor()
    refs = []
    for _ in range(1000):
        x = torch.randn(256, requires_grad=True)
        y = (x * 2.0).tanh()
        m.update_state(y)
        mt.update_state(y[:4])
        refs.append(weakref.ref(x))
    del x, y
    assert all(r() is None for r in refs)
    for v in m.variables + mt.variables:
        assert v.grad_fn is None and not v.requires_grad
    assert float(m.count.value) == 256000.0
    assert np.all(np_(mt.count.value) == 1000.0)


def _pair(seed=0):
    """A JAX and a port ``ScaledLJ`` with one call's state each."""
    j, t = inputs(seed=seed)
    jm, tm = JScaledLJ(8), TScaledLJ(8)
    jm(j)
    tm(t)
    return (jm, j), (tm, t)


def test_get_and_set_state_match_jax():
    (jm, j), (tm, t) = _pair()
    jvals, tvals = htf.models.get_state(jm), htt.models.get_state(tm)
    assert len(jvals) == len(tvals)
    for a, b in zip(tvals, jvals):
        np.testing.assert_allclose(np_(a).astype(np.float64),
                                   np.asarray(b).astype(np.float64),
                                   rtol=1e-6)
    # get_state copies: a later call leaves the list as it was read
    tm(t)
    assert float(tvals[4]) == 9.0 and float(tm.avg.count.value) == 18.0
    htt.models.set_state(tm, tvals)
    assert float(tm.avg.count.value) == 9.0
    with pytest.raises(ValueError):
        htt.models.set_state(tm, tvals[:-1])


def test_functional_call_matches_jax():
    """``functional_call`` runs under the given values and returns the
    values the call left (the metric's update), restoring the module; the
    gradient through it reaches the trainable values as JAX's does
    (JAX test_grad_flows_to_params_through_capture)."""
    (jm, j), (tm, t) = _pair(seed=1)
    jvals, tvals = htf.models.get_state(jm), htt.models.get_state(tm)
    jidx = [i for i, v in enumerate(jm.variables) if v.trainable]
    tidx = [i for i, v in enumerate(tm.variables)
            if isinstance(v, torch.nn.Parameter)]
    assert jidx == tidx == [2]

    def jloss(params):
        vals = list(jvals)
        for i, p in zip(jidx, params):
            vals[i] = p
        (out,), new = htf.models.functional_call(jm, vals, lambda: jm(j))
        return jnp.sum(out[:, :3] ** 2), new

    (jl, jnew), jg = jax.value_and_grad(jloss, has_aux=True)(
        [jvals[i] for i in jidx])
    params = [tvals[i].clone().requires_grad_() for i in tidx]
    vals = list(tvals)
    for i, p in zip(tidx, params):
        vals[i] = p
    (out,), tnew = htt.models.functional_call(
        tm, vals, lambda: tm(t, training=True))
    tl = torch.sum(out[:, :3] ** 2)
    tg = torch.autograd.grad(tl, params)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for a, b in zip(tg, jg):
        assert float(np.abs(np.asarray(b))) > 0
        np.testing.assert_allclose(np_(a), np.asarray(b), rtol=1e-5)
    # the call's metric update is in the new values, not in the module
    assert float(tnew[4]) == float(jnew[4]) == 18.0
    assert float(tm.avg.count.value) == 9.0
    np.testing.assert_allclose(np_(tnew[3]), np.asarray(jnew[3]), rtol=1e-5)


class JWCAModel(htf.SimModel):
    """tests/zoo.py's WCAModel."""

    def setup(self):
        self.wca = htf.WCARepulsion(0.5)

    def compute(self, nlist):
        return htf.compute_nlist_forces(nlist, self.wca(nlist))


class TWCAModel(htt.SimModel):
    def setup(self):
        self.wca = htt.WCARepulsion(0.5)

    def compute(self, nlist):
        return htt.compute_nlist_forces(nlist, self.wca(nlist))


@pytest.mark.parametrize("sigma", [0.9, 2.5])
def test_wca_energy_matches_jax(sigma):
    """The clipped per-pair energy at a seeded list (sigma 2.5 puts many
    pairs inside the 2^(1/3) sigma cut and some at the clip), and the
    regularizer's loss term."""
    j, t = inputs(n=32, NN=16, seed=4, L=6.0, r_cut=3.0)
    jl, tl = htf.WCARepulsion(sigma), htt.WCARepulsion(sigma)
    e_j, e_t = np.asarray(jl(j[0])), np_(tl(t[0]))
    assert (e_j > 0).sum() > 10
    np.testing.assert_allclose(e_t, e_j, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose([float(x) for x in tl.losses],
                               [float(x) for x in jl.losses], rtol=1e-6)
    assert tl.get_config() == jl.get_config() == \
        {"sigma": float(np.float32(sigma))}
    assert htt.WCARepulsion(**tl.get_config()).get_config() == \
        tl.get_config()


def test_wca_regularizer_raises_sigma():
    """The negative-strength regularizer pushes sigma up under training
    (JAX TestWCARegularizer), by the same amount as in JAX."""
    j, t = inputs()
    out = []
    for pkg, model, x in ((htf, JWCAModel(8), j), (htt, TWCAModel(8), t)):
        model.compile(optimizer="sgd", loss="mse", learning_rate=1e-2)
        labels = model(x)[0]
        s0 = float(model.wca.sigma.value)
        for _ in range(10):
            model.train_on_batch(x, labels)
        out.append((s0, float(model.wca.sigma.value)))
    (js0, js1), (ts0, ts1) = out
    assert ts1 > ts0 and js1 > js0
    np.testing.assert_allclose(ts1, js1, rtol=1e-5)


def _jax_eds_step(layer):
    """The JAX layer's call under jit, as the JAX engine runs it (its
    compiled masks are selects; an eager call turns alpha into 0 * NaN
    before the first Adam step)."""
    @jax.jit
    def call(vals, cv):
        return htf.models.functional_call(layer, vals, lambda: layer(cv))
    return call


@pytest.mark.parametrize("shape", [(), (3,)])
def test_eds_layer_matches_jax(shape):
    """The same seeded CV sequence, 3 periods + 2 calls, through both
    layers: after every call the statistics, the int32 counters, alpha and
    the Adam moments agree."""
    period = 5
    rng = np.random.RandomState(7)
    cvs = (3.0 + rng.rand(3 * period + 2, *shape)).astype(np.float32)
    jl = htf.EDSLayer(4.0, period, learning_rate=0.2)
    tl = htt.EDSLayer(4.0, period, learning_rate=0.2)
    jl(jnp.asarray(cvs[0]))            # builds the JAX state
    call = _jax_eds_step(jl)
    jvals = [jnp.zeros_like(v.value) for v in jl.variables]
    names = ["mean", "ssd", "n", "alpha", "adam_m", "adam_v", "adam_t"]
    for k, cv in enumerate(cvs):
        ja, jvals = call(jvals, jnp.asarray(cv))
        ta = tl(torch.as_tensor(cv))
        for name, tv, jv in zip(names, tl.variables, jvals):
            jv = np.asarray(jv)
            assert np_(tv).dtype == jv.dtype, name
            if jv.dtype == np.int32:
                np.testing.assert_array_equal(np_(tv), jv, err_msg=name)
            else:
                np.testing.assert_allclose(np_(tv), jv, rtol=1e-5,
                                           atol=1e-7,
                                           err_msg=f"{name} call {k}")
        np.testing.assert_allclose(np_(ta), np.asarray(ja), rtol=1e-5,
                                   atol=1e-7)
    assert float(np.abs(np_(tl.alpha.value)).min()) > 0   # 3 Adam steps


def test_eds_config_roundtrip_and_dtype_error():
    layer = htt.EDSLayer(4.0, 5, learning_rate=0.2)
    c = layer.get_config()
    assert c == htf.EDSLayer(4.0, 5, learning_rate=0.2).get_config()
    assert c["period"] == 5 and c["learning_rate"] == 0.2
    layer2 = htt.EDSLayer(**c)
    assert layer2.period == 5 and layer2.get_config() == c
    for bad in (4, np.int32(4), torch.tensor(4)):
        with pytest.raises(ValueError, match="EDS only works with floats"):
            htt.EDSLayer(bad, 5)
    with pytest.raises(ValueError, match="EDS only works with floats"):
        htf.EDSLayer(4, 5)


class JEDSModel(htf.SimModel):
    """Reference example 03's model."""

    def setup(self, set_point):
        self.cv_avg = htf.Mean()
        self.eds_bias = htf.EDSLayer(set_point, period=5, learning_rate=0.2)

    def compute(self, nlist, positions, box):
        cv = jnp.linalg.norm(htf.wrap_vector(positions[0, :3], box))
        self.cv_avg.update_state(cv)
        alpha = self.eds_bias(cv)
        energy = (cv - 5.0) ** 2 + cv * alpha
        return htf.compute_positions_forces(positions, energy), alpha


class TEDSModel(htt.SimModel):
    def setup(self, set_point):
        self.cv_avg = htt.Mean()
        self.eds_bias = htt.EDSLayer(set_point, period=5, learning_rate=0.2)

    def compute(self, nlist, positions, box):
        cv = torch.linalg.norm(htt.wrap_vector(positions[0, :3], box))
        self.cv_avg.update_state(cv)
        alpha = self.eds_bias(cv)
        energy = (cv - 5.0) ** 2 + cv * alpha
        return htt.compute_positions_forces(positions, energy), alpha


def test_lazy_state_carries_from_jax():
    """``build_model`` builds the lazily made EDS state and leaves it at
    its initial values (no count, no statistics), and
    ``load_jax_variables`` carries every variable of a JAX model that ran
    -- float, int32 and bool, trainable or not."""
    j, t = inputs()
    jm = JEDSModel(0, set_point=4.0)
    for _ in range(7):
        jm(j)
    tm = TEDSModel(0, set_point=4.0)
    build_model(tm, 0.0, "cpu")
    assert len(tm.variables) == len(jm.variables) == 2 + 2 + 7
    assert float(tm.cv_avg.count.value) == 0.0
    assert int(tm.eds_bias.n.value) == 0
    assert tm.eds_bias.n.value.dtype == torch.int32
    load_jax_variables(tm, jm.get_weights())
    for a, b in zip(tm.get_weights(), jm.get_weights()):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert int(tm.eds_bias.n.value) == 2
    assert int(tm.eds_bias.adam_t.value) == 1
