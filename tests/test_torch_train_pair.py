"""Port vs JAX package: the training gradients of K1's generic form (the
list route of ``ops/pair_train.py``: the list, the pair function on it
with grad, the reduction whose backward is the kernel
``generic_reduce_bwd``) in its plain versions, and that backward's plain
version ``generic_reduce_bwd_plain``, on the same numpy inputs (256
particles at density 0.35, r_cut 2.5, the JAX package's own
``_slot_setup`` size; the NN pair potentials at width 8).

The JAX side runs as its own tests run it on the CPU: its
``pair_train_forces`` with the XLA lane contraction (``bwd_impl='xla'``)
and the full-stencil forward.

Tolerances: parameter gradients at rtol 2e-4, atol 2e-5 max|g| (the JAX
bar for its Pallas backward against XLA); the backward's plain version
against autograd through the reduction's plain version at rtol = atol =
1e-5 (the same float32 products summed in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hoomd_tf_tpu as htf
from hoomd_tf_tpu.models.module import functional_call as j_call
from hoomd_tf_tpu.models.module import get_state as j_state
from hoomd_tf_tpu.ops.lane_fast import synthesize_pair_fn as j_synth
from hoomd_tf_tpu.ops.pair_train import pair_train_forces as j_ptf
import hoomd_tf_tpu_torch as htt
from hoomd_tf_tpu_torch.interop import build_model, load_jax_variables
from hoomd_tf_tpu_torch.md.simulation import _module_pair_apply
from hoomd_tf_tpu_torch.ops import cellwise_cuda as tcc
from hoomd_tf_tpu_torch.ops.lane_fast import synthesize_pair_fn as t_synth
from hoomd_tf_tpu_torch.ops.pair_train import pair_train_forces as t_ptf

from torch_helpers import np_, packed_pair, seed_jax_weights

R_CUT = 2.5
WIDTH = 8
RCM = np.array([[2.5, 1.8], [1.8, 2.2]], dtype=np.float32)


class JNNPair(htf.PairModel):
    """north_star.py's TrainableNNPair at width 8 (JAX)."""

    def setup(self):
        self.dense1 = htf.Dense(WIDTH)
        self.last = htf.Dense(1)

    def pair_energy(self, r2):
        x = jax.nn.tanh(self.dense1(jax.lax.rsqrt(r2)[..., None]))
        return 2.0 * self.last(x)[..., 0]


class TNNPair(htt.PairModel):
    def setup(self):
        self.dense1 = htt.Dense(WIDTH)
        self.last = htt.Dense(1)

    def pair_energy(self, r2):
        x = torch.tanh(self.dense1(torch.rsqrt(r2)[..., None]))
        return 2.0 * self.last(x)[..., 0]


class JNN(htf.SimModel):
    """north_star.py's TrainableNN (reference example 08) at width 8."""

    def setup(self):
        self.dense1 = htf.Dense(WIDTH)
        self.last = htf.Dense(1)

    def compute(self, nlist, positions, box):
        rinv = htf.nlist_rinv(nlist)
        x = jax.nn.tanh(self.dense1(rinv[..., None]))
        e = jnp.sum(self.last(x)[..., 0], axis=1)
        return htf.compute_nlist_forces(nlist, e)[:, :3]


class TNN(htt.SimModel):
    def setup(self):
        self.dense1 = htt.Dense(WIDTH)
        self.last = htt.Dense(1)

    def compute(self, nlist, positions, box):
        rinv = htt.nlist_rinv(nlist)
        x = torch.tanh(self.dense1(rinv[..., None]))
        e = torch.sum(self.last(x)[..., 0], dim=1)
        return htt.compute_nlist_forces(nlist, e)[:, :3]


def jax_built(jm, pair):
    if pair:
        jm.pair_energy(jnp.ones(4))
    else:
        z = jnp.zeros((1, 4, 4))
        jm([z, jnp.zeros((1, 4)), jnp.zeros((3, 3))])
    return seed_jax_weights(jm, 0)


def models(kind):
    """The same NN in both packages, the port's weights from the JAX
    model's: ``(jm, tm)``."""
    pair = kind == "pair"
    jm = jax_built(JNNPair(16) if pair else JNN(16, output_forces=False),
                   pair)
    tm = TNNPair(16) if pair else TNN(16, output_forces=False)
    build_model(tm, R_CUT, "cpu")
    load_jax_variables(tm, jm.get_weights())
    return jm, tm


def j_pair_apply(jm, fn_of_model):
    """``pair_apply(params, r2, ...)`` of a JAX model: its trainable
    weights replaced by ``params``."""
    vals = j_state(jm)
    idx = [i for i, v in enumerate(jm.variables) if v.trainable]

    def pair_apply(params, *args):
        v = list(vals)
        for i, p in zip(idx, params):
            v[i] = p
        out, _ = j_call(jm, v, lambda: fn_of_model()(*args))
        return out

    return pair_apply, [vals[i] for i in idx]


#: model kind, energy channel, per-type cutoffs
CASES = {"pair_energy": ("pair", True, None),
         "pair_forces_only": ("pair", False, None),
         "pair_rcut_matrix": ("pair", True, RCM),
         "synthesized_forces_only": ("synth", False, None)}


def setup(case):
    kind, energy_on, rc = CASES[case]
    typed = rc is not None
    (jl, jss, jaux), (tl, tss, taux) = packed_pair(
        256, 0.35, 3, R_CUT, typed=typed, rc_matrix=rc)
    ct = np.random.RandomState(5).randn(tl.plan.n_slots, 4).astype(
        np.float32)
    if not energy_on:
        ct[:, 3] = 0.0
    return kind, energy_on, rc, (jl, jss, jaux), (tl, tss, taux), ct


def jax_grads(case):
    kind, energy_on, rc, (jl, jss, jaux), _, ct = setup(case)
    jm, _ = models(kind)
    if kind == "pair":
        apply, params = j_pair_apply(jm, lambda: jm.pair_energy_and_slope)
        with_types = False
    else:
        apply, params = j_pair_apply(jm, lambda: j_synth(jm, jss.box))
        with_types = True

    def primal(p):
        f4 = j_ptf(p, apply, jss.positions, jss.types, jaux["valid"],
                   jl.plan, jl.lo, with_types=with_types, rcut_matrix=rc,
                   needs_energy=energy_on, fwd_stencil="full",
                   bwd_impl="xla")
        return jnp.sum(f4 * jnp.asarray(ct))
    return [np.asarray(g) for g in jax.grad(primal)(params)]


def port_forces(route, tm, kind, energy_on, tl, tss, taux, lanes=None):
    """The port's training forces of ``tm`` by ``route``: ``'list'`` (K1's
    generic form's plain list route through ``pair_train_forces``),
    ``'train_forces'`` (``generic_train_forces`` called directly) or
    ``'contract'`` (the lane contraction, the CPU oracle)."""
    if kind == "pair":
        fn, typed = tm.pair_energy_and_slope, False
    else:
        fn, typed = t_synth(tm, tss.box, differentiable=True), True
    args = (tss.positions, tss.types, taux["valid"], tl.plan, tl.lo)
    if route == "train_forces":
        return tcc.generic_train_forces(
            *args, fn, typed_fn=typed, rc2_tab=tl.rc2_tab,
            needs_energy=energy_on, geometry=tl.geometry, lanes=lanes)
    named = {k: v for k, v in tm.named_parameters() if v.requires_grad}
    return t_ptf(named, _module_pair_apply(tm, fn), *args,
                 with_types=typed, rcut_matrix=tl.rc2_tab,
                 needs_energy=energy_on, geometry=tl.geometry,
                 bwd_impl="list" if route == "list" else "generic",
                 lanes=lanes)


def assert_grads(got, want):
    for a, b in zip(got, want):
        scale = max(np.abs(w).max() for w in want)
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5 * scale)


@pytest.mark.parametrize("route", ["list", "train_forces", "contract"])
@pytest.mark.parametrize("case", list(CASES))
def test_training_gradients_match_jax(case, route):
    """The weights' gradient of <ct, forces4>: the list route's plain
    version (through ``pair_train_forces(bwd_impl='list')`` and
    ``generic_train_forces``) and the port's lane contraction against the
    JAX package's XLA contraction, for a non-proxy PairModel (the JVP
    slope) and a generic SimModel's synthesized pair function."""
    want = jax_grads(case)
    kind, energy_on, _, _, (tl, tss, taux), ct = setup(case)
    _, tm = models(kind)
    f4 = port_forces(route, tm, kind, energy_on, tl, tss, taux)
    loss = torch.sum(f4 * torch.as_tensor(ct))
    got = [np_(g) for g in torch.autograd.grad(loss,
                                               tm.trainable_weights())]
    assert len(got) == len(want) == 4
    assert_grads(got, want)
    assert tcc.generic_reduce_bwd.launches == 0   # plain versions on CPU


def test_list_route_forward_matches_contract_forward():
    """The list route's forces (generic form, plain) equal the contraction
    route's forward (the full tensor stencil) at rtol = atol = 1e-4."""
    kind, energy_on, _, _, (tl, tss, taux), _ = setup("pair_energy")
    _, tm = models(kind)
    a = port_forces("list", tm, kind, energy_on, tl, tss, taux)
    b = port_forces("contract", tm, kind, energy_on, tl, tss, taux)
    np.testing.assert_allclose(np_(a), np_(b), rtol=1e-4, atol=1e-4)


def plain_list(case, budget=None):
    kind, energy_on, rc, _, (tl, tss, taux), ct = setup(case)
    lst = tcc.generic_list_plain(tss.positions, tss.types, taux["valid"],
                                 tl.plan, tl.lo, rc2_tab=tl.rc2_tab,
                                 geometry=tl.geometry, budget=budget)
    return energy_on, tl, taux, lst, torch.as_tensor(ct)


@pytest.mark.parametrize("case", ["pair_energy", "pair_forces_only",
                                  "pair_rcut_matrix"])
def test_reduce_bwd_plain_matches_autograd(case):
    """``generic_reduce_bwd_plain`` is the transpose of the reduction's
    plain version: autograd through ``generic_reduce_plain`` (built from
    differentiable ``index_add``) at random ``(U, S)``, rtol = atol =
    1e-5."""
    energy_on, tl, taux, lst, ct = plain_list(case)
    n = lst["r2"].shape[0]
    rng = np.random.RandomState(1)
    U = torch.tensor(rng.randn(n).astype(np.float32), requires_grad=True)
    S = torch.tensor(rng.randn(n).astype(np.float32), requires_grad=True)
    f4, _ = tcc.generic_reduce_plain(lst, U, S, taux["valid"], tl.plan,
                                     energy_on)
    gU_a, gS_a = torch.autograd.grad(torch.sum(f4 * ct), [U, S],
                                     allow_unused=True)
    gU, gS = tcc.generic_reduce_bwd_plain(lst, ct, taux["valid"], tl.plan,
                                          energy_on)
    np.testing.assert_allclose(np_(gS), np_(gS_a), rtol=1e-5, atol=1e-5)
    if energy_on:
        np.testing.assert_allclose(np_(gU), np_(gU_a), rtol=1e-5,
                                   atol=1e-5)
    else:
        assert gU is None and gU_a is None
    # block 0 lists both orders and takes the row term only: some lanes
    # of each kind are present
    back = lst["col"] >= tl.plan.capacity
    assert bool(back.any()) and bool((~back).any())


def test_budget_tail_carries_no_gradient():
    """A list longer than the lanes needed, its tail holding earlier,
    finite ``r2`` (as the kernel's list does): the backward gives the
    tail exactly zero, and the weights' gradient through the pair
    function on the whole budget equals the gradient on the listed lanes
    alone."""
    energy_on, tl, taux, lst, ct = plain_list("pair_energy")
    _, tm = models("pair")
    n = lst["r2"].shape[0]
    budget = n + 300
    rng = np.random.RandomState(2)
    garbage = torch.tensor(rng.uniform(0.8, R_CUT ** 2, 300).astype(
        np.float32))
    r2 = torch.cat([lst["r2"], garbage])
    params = tm.trainable_weights()
    grads = []
    for lanes in (r2[:n], r2):
        U, S = tm.pair_energy_and_slope(lanes)
        f4, _ = tcc.generic_reduce_plain(lst, U, S, taux["valid"], tl.plan,
                                         energy_on)
        gU, gS = tcc.generic_reduce_bwd_plain(lst, ct, taux["valid"],
                                              tl.plan, energy_on,
                                              n_lanes=lanes.shape[0])
        assert gS.shape[0] == lanes.shape[0]
        assert not np_(gS[n:]).any() and not np_(gU[n:]).any()
        grads.append(torch.autograd.grad(
            torch.sum(gU * U) + torch.sum(gS * S), params))
    for a, b in zip(*grads):
        np.testing.assert_allclose(np_(a), np_(b), rtol=1e-5, atol=1e-7)


def test_generic_reduce_function_on_cpu():
    """``GenericReduce`` on a CPU list: its forward is the plain reduction
    (equal to ``generic_plain`` bit for bit), its backward the plain
    backward; a list from the plain version launches nothing."""
    _, _, _, _, (tl, tss, taux), ct = setup("pair_energy")
    ct = torch.as_tensor(ct)
    _, tm = models("pair")
    gl = tcc.generic_list(tss.positions, tss.types, taux["valid"], tl.plan,
                          tl.lo, typed_fn=False, geometry=tl.geometry)
    U, S = gl.evaluate(tm.pair_energy_and_slope, grad=True)
    assert S.requires_grad
    f4 = tcc.GenericReduce.apply(U, S, gl, True)
    ref, _ = tcc.generic_plain(tss.positions, tss.types, taux["valid"],
                               tl.plan, tl.lo, tm.pair_energy_and_slope,
                               typed_fn=False, geometry=tl.geometry)
    np.testing.assert_array_equal(np_(f4), np_(ref))
    gU, gS = torch.autograd.grad(torch.sum(f4 * ct), [U, S])
    wU, wS = tcc.generic_reduce_bwd(gl, ct)
    np.testing.assert_array_equal(np_(gU), np_(wU))
    np.testing.assert_array_equal(np_(gS), np_(wS))
    assert tcc.generic_reduce_bwd.launches == 0
    assert tcc.generic_pair_forces.launches == 0


def test_kernel_lane_index_maps_cells():
    """``kernel_lane_index`` places each plain lane at its cell's base plus
    its rank in the cell (the kernel lists a cell's lanes in the plain
    version's order), and marks cells without a base."""
    _, tl, _, lst, _ = plain_list("pair_energy")
    counts = torch.bincount(lst["cell"], minlength=tl.plan.n_cells)
    order = torch.randperm(tl.plan.n_cells, generator=torch.Generator()
                           .manual_seed(0))
    base = torch.zeros(tl.plan.n_cells, dtype=torch.long)
    base[order] = torch.cumsum(counts[order], 0) - counts[order]
    base[order[0]] = -1
    idx = tcc.kernel_lane_index(lst, base.to(torch.int32), tl.plan)
    listed = idx >= 0
    assert int((~listed).sum()) == int(counts[order[0]])
    assert len(set(idx[listed].tolist())) == int(listed.sum())
    first = idx[lst["cell"] == order[1]]
    assert first.tolist() == list(range(int(base[order[1]]),
                                        int(base[order[1]]) + len(first)))


def test_pair_slope_is_differentiable_in_the_weights():
    """``PairModel.pair_energy_and_slope`` (``torch.func.jvp``) carries the
    weights' gradient of the slope: equal to a double backward through
    ``torch.autograd.grad(U.sum(), r2, create_graph=True)``."""
    _, tm = models("pair")
    r2 = torch.linspace(0.8, R_CUT ** 2, 50)
    w = torch.linspace(-1.0, 1.0, 50)
    _, s = tm.pair_energy_and_slope(r2)
    # the last bias only shifts the energy: the slope does not read it
    params = tm.trainable_weights()[:3]
    g_jvp = torch.autograd.grad(torch.sum(w * s), params)
    x = r2.clone().requires_grad_()
    s2, = torch.autograd.grad(tm.pair_energy(x).sum(), x, create_graph=True)
    g_ref = torch.autograd.grad(torch.sum(w * s2), params)
    for a, b in zip(g_jvp, g_ref):
        assert float(torch.abs(a).max()) > 0
        np.testing.assert_allclose(np_(a), np_(b), rtol=1e-5, atol=1e-7)
