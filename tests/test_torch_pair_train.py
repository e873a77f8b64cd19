"""Port vs JAX package: the online-training pair forces
(``ops/pair_train.py``), kernel K2's plain version
(``ops/pair_train_cuda.py::proxy_bwd_plain`` and its lane math
``proxy_bwd_reference``) and K1's Chebyshev-proxy form's plain version, on the same numpy inputs, at the size of the JAX
package's own ``_slot_setup`` (tests/test_pair_train.py: 256 particles at
density 0.35, r_cut 2.5).

The JAX side runs as its own tests run it on the CPU: the Pallas proxy
backward interpreted (``interpret=True`` / ``bwd_impl='pallas'``) and the
XLA lane contraction (``bwd_impl='xla'``).

Tolerances: gradients and moment sums at rtol 2e-4, atol 2e-5 max|g|, the
JAX bar for its Pallas backward against XLA; forces, energies and virials
at rtol = atol = 1e-4, its bar for its Pallas forward; losses at rtol
1e-5 (float32 sums of the same terms in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hoomd_tf_tpu.ops import cellwise as jcw
from hoomd_tf_tpu.ops import chebyshev as jch
from hoomd_tf_tpu.ops.pair_train import pair_train_forces as j_ptf
from hoomd_tf_tpu.ops.pair_train_pallas import proxy_bwd_moments as j_bwd
from hoomd_tf_tpu_torch.ops import cellwise as tcw
from hoomd_tf_tpu_torch.ops import chebyshev as tch
from hoomd_tf_tpu_torch.ops import pair_train_cuda as tptc
from hoomd_tf_tpu_torch.ops.pair_train import pair_train_forces as t_ptf

from torch_helpers import np_, packed_pair

R_CUT = 2.5
R2_LO = (0.25 * R_CUT) ** 2
RCM = np.array([[2.5, 1.8], [1.8, 2.2]], dtype=np.float32)
K = 8
CASES = {"untyped": (False, True, None),
         "forces_only": (False, False, None),
         "typed": (True, True, None),
         "typed_rcut": (True, True, RCM)}


def energy(r2, ti=None, tj=None):
    """A smooth, bounded pair energy with a per-type-pair scale, in either
    package's arrays (rational, so both packages compute it bit for bit;
    of the size of the trained NN's, where an LJ core's proxy would carry
    coefficients in the hundreds)."""
    u = 1.0 / r2
    eps = 1.0 if ti is None else 0.9 / (1.0 + ti + tj)
    return eps * (u * u - 2.0 * u) / (1.0 + u * u)


def proxies(typed):
    """The same fitted proxy in both packages: ``(jev, jc, tev, tc)``, the
    port's coefficients as leaf tensors."""
    if typed:
        jfit, jev = jch.make_typed_pair_proxy(K, R2_LO, R_CUT ** 2, 2)
        tfit, tev = tch.make_typed_pair_proxy(K, R2_LO, R_CUT ** 2, 2,
                                              device="cpu")
    else:
        jfit, jev = jch.make_pair_proxy(K, R2_LO, R_CUT ** 2)
        tfit, tev = tch.make_pair_proxy(K, R2_LO, R_CUT ** 2,
                                        device="cpu")
    jc = jfit(lambda r2, *t: (energy(r2, *t), None))
    tc = {k: v.detach().requires_grad_() for k, v in tfit(energy).items()}
    return jev, jc, tev, tc


def grad_arrays(g, basis):
    """A JAX coefficient gradient pytree -> one flat array in the port's
    ``(c, cd)``, pair-major order."""
    if basis["pairs"] is None:
        return np.concatenate([np.asarray(g["c"]), np.asarray(g["cd"])])
    return np.concatenate([np.concatenate([np.asarray(g[p]["c"]),
                                           np.asarray(g[p]["cd"])])
                           for p in basis["pairs"]])


def port_arrays(g_c, g_cd):
    g_c, g_cd = np_(g_c).reshape(-1, K), np_(g_cd).reshape(-1, K)
    return np.concatenate([g_c, g_cd], axis=1).ravel()


def assert_grads(got, want):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5 * scale)


def setup(case):
    typed, energy_on, rc = CASES[case]
    (jl, jss, jaux), (tl, tss, taux) = packed_pair(256, 0.35, 3, R_CUT,
                                                   typed=typed,
                                                   rc_matrix=rc)
    ct = np.random.RandomState(5).randn(tl.plan.n_slots, 4).astype(
        np.float32)
    return typed, energy_on, rc, (jl, jss, jaux), (tl, tss, taux), ct


@pytest.mark.parametrize("case", list(CASES))
def test_proxy_backward_plain_matches_jax(case):
    """K2's plain version (what the wrapper runs on a CPU tensor) against
    the JAX Pallas kernel, interpreted, and the JAX XLA contraction."""
    typed, energy_on, rc, (jl, jss, jaux), (tl, tss, taux), ct = \
        setup(case)
    jev, jc, tev, _ = proxies(typed)
    g_c, g_cd = tptc.proxy_bwd_moments(
        tss.positions, tss.types, taux["valid"], torch.as_tensor(ct),
        tl.plan, tl.lo, tev.basis, rc2_tab=tl.rc2_tab,
        needs_energy=energy_on, geometry=tl.geometry)
    assert tptc.proxy_bwd_moments.launches == 0
    got = port_arrays(g_c, g_cd)
    if not energy_on:
        assert not np_(g_c).any()

    jp_c, jp_cd = j_bwd(jss.positions, jss.types, jaux["valid"],
                        jnp.asarray(ct), jl.plan, jl.lo, jev.basis,
                        rcut_matrix=rc, needs_energy=energy_on,
                        interpret=True)
    pallas = (grad_arrays({"c": jp_c, "cd": jp_cd}, jev.basis)
              if not typed else grad_arrays(
                  {p: {"c": jp_c[p], "cd": jp_cd[p]}
                   for p in jev.basis["pairs"]}, jev.basis))

    def primal(c):
        return j_ptf(c, jev, jss.positions, jss.types, jaux["valid"],
                     jl.plan, jl.lo, with_types=typed, rcut_matrix=rc,
                     needs_energy=energy_on, fwd_stencil="full",
                     bwd_impl="xla")
    _, vjp = jax.vjp(primal, jc)
    xla = grad_arrays(vjp(jnp.asarray(ct))[0], jev.basis)
    assert_grads(got, pallas)
    assert_grads(got, xla)


@pytest.mark.parametrize("case", list(CASES))
def test_proxy_bwd_plain_matches_reference_and_jax(case):
    """K2's plain version, called directly: exactly
    ``proxy_bwd_reference``'s moments on planes built here from the same
    state, and the JAX Pallas backward (interpreted) at the JAX bar."""
    typed, energy_on, rc, (jl, jss, jaux), (tl, tss, taux), ct = \
        setup(case)
    jev, _, tev, _ = proxies(typed)
    plan = tl.plan
    g_c, g_cd = tptc.proxy_bwd_plain(
        tss.positions, tss.types, taux["valid"], torch.as_tensor(ct), plan,
        tl.lo, tev.basis, rc2_tab=tl.rc2_tab, needs_energy=energy_on,
        geometry=tl.geometry)
    _, _, _, gx, gy, gz = tcw._relative_coords(
        tss.positions, taux["valid"], plan, tl.lo, tcw._HALF_OFFS,
        tl.geometry)
    ctv = torch.as_tensor(ct) * taux["valid"][:, None]
    cg = [tcw._roll_offs(ctv[:, k].contiguous(), plan, tcw._HALF_OFFS)
          for k in range(4)]
    gt = tcw._roll_offs(tss.types, plan, tcw._HALF_OFFS) \
        if typed or rc is not None else None
    ref = tptc.proxy_bwd_reference(
        gx, gy, gz, gt, cg[0], cg[1], cg[2], cg[3] if energy_on else None,
        tev.basis, plan.capacity, R_CUT ** 2, 1e-4, tl.rc2_tab)
    got = port_arrays(g_c, g_cd)
    np.testing.assert_array_equal(got, port_arrays(*ref.reshape(-1, 2, K)
                                                   .unbind(1)))
    jp_c, jp_cd = j_bwd(jss.positions, jss.types, jaux["valid"],
                        jnp.asarray(ct), jl.plan, jl.lo, jev.basis,
                        rcut_matrix=rc, needs_energy=energy_on,
                        interpret=True)
    want = (grad_arrays({"c": jp_c, "cd": jp_cd}, jev.basis)
            if not typed else grad_arrays(
                {p: {"c": jp_c[p], "cd": jp_cd[p]}
                 for p in jev.basis["pairs"]}, jev.basis))
    assert_grads(got, want)


def test_proxy_bwd_valid_not_a_prefix():
    """Occupied slots need not be a prefix of their cell: the same
    particles (and cotangents) in other slots give the same moments."""
    from torch_helpers import hole_permutation
    typed, energy_on, rc, _, (tl, tss, taux), ct = setup("typed_rcut")
    _, _, tev, _ = proxies(typed)
    perm = hole_permutation(taux["valid"], tl.plan.capacity)
    assert (np_(taux["valid"][perm]).reshape(tl.plan.n_cells, -1)[:, 0]
            == 0).any()
    ct = torch.as_tensor(ct)
    outs = []
    for p in (torch.arange(tl.plan.n_slots), perm):
        g = tptc.proxy_bwd_moments(
            tss.positions[p], tss.types[p], taux["valid"][p], ct[p],
            tl.plan, tl.lo, tev.basis, rc2_tab=tl.rc2_tab,
            geometry=tl.geometry)
        outs.append(port_arrays(*g))
    assert_grads(outs[1], outs[0])


@pytest.mark.parametrize("case", ["untyped", "typed_rcut"])
def test_proxy_form_plain_matches_jax(case):
    """K1's Chebyshev-proxy form, plain version (``ChebForm.evaluate``
    through ``half_stencil_plain``: the K1 wrapper on a CPU tensor),
    against the JAX package's analytic pair forces with the proxy as its
    pair function: forces, energy and virial."""
    typed, _, rc, (jl, jss, jaux), (tl, tss, taux), _ = setup(case)
    jev, jc, tev, tc = proxies(typed)
    f_j, w_j = jcw.analytic_pair_forces(
        jss.positions, jss.types, jaux["valid"], jl.plan, jl.lo,
        (lambda r2, ti, tj: jev(jc, r2, ti, tj)) if typed else
        (lambda r2: jev(jc, r2)), needs_virial=True, with_types=typed,
        rcut_matrix=rc, stencil="full")
    f_t, w_t = tcw.analytic_pair_forces(
        tss.positions, tss.types, taux["valid"], tl.plan, tl.lo, None,
        needs_virial=True, with_types=typed, rcut_matrix=tl.rc2_tab,
        stencil="kernel", form=tev.kernel_form(tc), geometry=tl.geometry)
    np.testing.assert_allclose(np_(f_t), np_(f_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np_(w_t), np_(w_j), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
@pytest.mark.parametrize("case", ["untyped", "forces_only", "typed_rcut"])
def test_pair_train_forces_gradients_match_jax(case, jax_impl):
    """The loss of the training primal and its coefficient gradients:
    the port's autograd Function (K2's plain version, and the generic
    lane contraction) against the JAX custom VJP (its interpreted Pallas
    backward, and its XLA contraction)."""
    typed, energy_on, rc, (jl, jss, jaux), (tl, tss, taux), labels = \
        setup(case)
    jev, jc, tev, tc = proxies(typed)
    cols = 4 if energy_on else 3

    def jloss(c):
        f4 = j_ptf(c, jev, jss.positions, jss.types, jaux["valid"],
                   jl.plan, jl.lo, with_types=typed, rcut_matrix=rc,
                   needs_energy=energy_on, fwd_stencil="full",
                   bwd_impl=jax_impl)
        return jnp.mean((f4[:, :cols] - labels[:, :cols]) ** 2)

    l_j, g_j = jax.value_and_grad(jloss)(jc)
    want = grad_arrays(g_j, jev.basis)
    lab = torch.as_tensor(labels)
    for impl in ("auto", "generic"):
        f4 = t_ptf(tc, tev, tss.positions, tss.types, taux["valid"],
                   tl.plan, tl.lo, with_types=typed, rcut_matrix=tl.rc2_tab,
                   needs_energy=energy_on, bwd_impl=impl,
                   geometry=tl.geometry)
        loss = torch.mean((f4[:, :cols] - lab[:, :cols]) ** 2)
        np.testing.assert_allclose(float(loss.detach()), float(l_j),
                                   rtol=1e-5)
        g_c, g_cd = torch.autograd.grad(loss, [tc["c"], tc["cd"]])
        assert_grads(port_arrays(g_c, g_cd), want)
