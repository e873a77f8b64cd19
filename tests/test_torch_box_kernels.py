"""The plain versions of kernel K1 (LJ, Chebyshev-proxy and generic
forms) and kernel K2 at the geometries of the port's slice E -- a box
tilted by the JAX tests' TILT, and a box rescaled by 0.97 under a
dynamic-box layout (NPT's) -- against the JAX package's Pallas kernels
run in interpret mode (``half_stencil_pair_forces(..., lengths=,
interpret=True)``) and the JAX proxy backward (its XLA lane contraction),
on the same slot state made from a numpy seed.

These plain versions are what the wrappers run on a CPU tensor and what
the CUDA kernels are held against on the card (tests/test_torch_cuda.py,
chip_smoke.py), so this ties the card's geometry to the reference.
Tolerances are the JAX package's own bars: K1 rtol = atol = 1e-4 (its
Pallas kernel against its tensor form, tests/test_cellwise.py), K2 rtol
2e-4, atol 2e-5 max|g| (tests/test_pair_train.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import hoomd_tf_tpu as htf
from hoomd_tf_tpu.md.slots import SlotLayout as JLayout
from hoomd_tf_tpu.ops import box as jbox
from hoomd_tf_tpu.ops import cellwise as jcw
from hoomd_tf_tpu.ops import chebyshev as jch
from hoomd_tf_tpu.ops.cellwise_pallas import half_stencil_pair_forces as jk1
import hoomd_tf_tpu_torch as htt
from hoomd_tf_tpu_torch.md.slots import SlotLayout as TLayout
from hoomd_tf_tpu_torch.ops import cellwise as tcw
from hoomd_tf_tpu_torch.ops import cellwise_cuda as tcc
from hoomd_tf_tpu_torch.ops import chebyshev as tch
from hoomd_tf_tpu_torch.ops import pair_train_cuda as tptc

from torch_helpers import (TILT, fluid_arrays, lj_slope_jax, np_,
                           tri_positions)

TOL = dict(rtol=1e-4, atol=1e-4)
R_CUT = 2.5
RCM = np.array([[2.5, 2.0], [2.0, 2.2]], dtype=np.float32)
KINDS = ["tilted", "scaled"]


def case(kind, n=300, density=0.35, seed=7):
    """The same typed fluid packed by both packages at a ``kind`` box:
    ``(jax (layout, slot, aux, lo, lengths), port (layout, slot, aux,
    geometry))``. 'tilted' is a static plan with the tilt; 'scaled' a
    dynamic-box layout planned at the fluid's box with NPT's 0.15 r_cut
    minimum skin, then run at the box rescaled by 0.97."""
    types = np.arange(n) % 2
    if kind == "tilted":
        L = (n / density) ** (1 / 3)
        lengths = np.array([L, L, L])
        pos = tri_positions(n, lengths, TILT, seed=seed)
        lo = (-lengths / 2).astype(np.float32)
        box = np.stack([lo, -lo, np.asarray(TILT)]).astype(np.float32)
        kw = dict(tilt=TILT)
        dynamic = False
    else:
        pos, _, lengths = fluid_arrays(n, density, seed)
        lo = (-lengths / 2).astype(np.float32)
        mu = np.float32(0.97)
        box = np.stack([lo * mu, -lo * mu, np.zeros(3)]).astype(np.float32)
        pos = pos * mu
        kw = dict(config=htf.Cellwise(skin=0.15 * R_CUT))
        dynamic = True
    jplan = jcw.plan_cellwise(n, lengths, R_CUT, positions=pos, lo=lo,
                              width_blocks=14, **kw)
    if not dynamic:
        kw_t = dict(tilt=TILT)
    else:
        kw_t = dict(config=tcw.Cellwise(skin=0.15 * R_CUT))
    tplan = tcw.plan_cellwise(n, lengths, R_CUT, positions=pos, lo=lo,
                              width_blocks=14, **kw_t)
    assert (tplan.grid, tplan.capacity) == (jplan.grid, jplan.capacity)
    js = htf.md.state.init_state(pos, box, types=types)
    jl = JLayout(jplan, n, lo, rc_matrix=RCM, dynamic_box=dynamic)
    jslot, jaux, _ = jl.pack(js)
    ts = htt.md.state.init_state(pos, box, types=types, device="cpu")
    tl = TLayout(tplan, n, lo, rc_matrix=RCM, device="cpu", box=ts.box,
                 dynamic_box=dynamic)
    tslot, taux = tl.pack(ts)
    np.testing.assert_array_equal(np_(taux["orig"]), np_(jaux["orig"]))
    jlo = js.box[0] if dynamic else lo
    jlen = jbox.box_size(js.box) if dynamic else None
    return ((jl, jslot, jaux, jlo, jlen),
            (tl, tslot, taux, tl.geom(tslot)))


def jax_k1(j, pair_fn, with_types=True, needs_virial=True):
    jl, jslot, jaux, jlo, jlen = j
    return jk1(jslot.positions, jslot.types, jaux["valid"], jl.plan, jlo,
               pair_fn, needs_virial=needs_virial, with_types=with_types,
               rcut_matrix=RCM, lengths=jlen, interpret=True)


def port_args(t):
    tl, tslot, taux, g = t
    return (tslot.positions, tslot.types, taux["valid"], tl.plan, tl.lo)


def assert_k1(got, want):
    np.testing.assert_allclose(np_(got[0]), np_(want[0]), **TOL)
    np.testing.assert_allclose(np_(got[1]), np_(want[1]), **TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_lj_form(kind):
    j, t = case(kind)
    tl, _, _, g = t
    form = htt.md.LennardJones([[1.0, 0.5], [0.5, 0.5]], 1.0,
                               r_cut=np.inf).kernel_form()
    got = tcc.half_stencil_pair_forces(*port_args(t), form,
                                       needs_virial=True,
                                       rc2_tab=tl.rc2_tab, geometry=g)
    assert tcc.half_stencil_pair_forces.launches == 0
    assert_k1(got, jax_k1(j, lj_slope_jax))


def proxy_pair(typed_k=8):
    """The same typed Chebyshev proxy of a smooth pair energy in both
    packages: ``(jax pair_fn, port ChebForm, jax evaluator, port
    evaluator, jax coefficients)``."""
    r2_lo = (0.25 * R_CUT) ** 2

    def energy(r2, ti, tj):
        u = 1.0 / r2
        return 0.9 / (1.0 + ti + tj) * (u * u - 2.0 * u) / (1.0 + u * u)

    jfit, jev = jch.make_typed_pair_proxy(typed_k, r2_lo, R_CUT ** 2, 2)
    tfit, tev = tch.make_typed_pair_proxy(typed_k, r2_lo, R_CUT ** 2, 2,
                                          device="cpu")
    jc = jfit(lambda r2, *tt: (energy(r2, *tt), None))
    tc = tfit(energy)
    return (lambda r2, ti, tj: jev(jc, r2, ti, tj)), \
        tev.kernel_form(tc), jev, tev, jc


@pytest.mark.parametrize("kind", KINDS)
def test_proxy_form(kind):
    j, t = case(kind)
    tl, _, _, g = t
    jfn, form, _, _, _ = proxy_pair()
    got = tcc.half_stencil_pair_forces(*port_args(t), form,
                                       needs_virial=True,
                                       rc2_tab=tl.rc2_tab, geometry=g)
    assert_k1(got, jax_k1(j, jfn))


def morse(r2, ti, tj, xp):
    """A typed pair function no kernel form covers, for either package."""
    r = xp.sqrt(r2)
    e = xp.exp(-1.5 * (r - 1.1))
    scale = 1.0 + 0.3 * (ti + tj)
    return (scale * (e * e - 2.0 * e),
            scale * (-3.0 * e * e + 3.0 * e) / (2.0 * r))


@pytest.mark.parametrize("kind", KINDS)
def test_generic_form(kind):
    """K1's generic form's plain version (the list and the reduction) on
    a pair function of no form, and its lanes against the kernel's
    record of what it lists: every listed lane within the cut."""
    j, t = case(kind)
    tl, _, _, g = t
    lanes = tcc.LaneBudget(tcc.lane_budget(tl.plan, 300), "cpu")
    got = tcc.generic_pair_forces(
        *port_args(t), lambda r2, ti, tj: morse(r2, ti, tj, torch),
        typed_fn=True, needs_virial=True, rc2_tab=tl.rc2_tab, geometry=g,
        lanes=lanes)
    assert not bool(lanes.overflow()) and int(lanes.needed) > 0
    assert_k1(got, jax_k1(j, lambda r2, ti, tj: morse(r2, ti, tj, jnp)))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("energy", [True, False])
def test_k2(kind, energy):
    """K2's plain version (the proxy backward's moments) against the JAX
    package's proxy backward by its XLA lane contraction (the VJP of
    ``pair_train_forces(..., lengths=, bwd_impl='xla')``), the reference's
    oracle of its Pallas backward. (At this fluid the JAX Pallas proxy
    backward, interpreted, disagrees with that contraction already in an
    orthorhombic static box, by ~7% in the (0, 0) moments; the port agrees
    with the contraction. ROADMAP.md Queue 3 records it.)"""
    import jax
    from hoomd_tf_tpu.ops.pair_train import pair_train_forces as j_ptf
    j, t = case(kind)
    jl, jslot, jaux, jlo, jlen = j
    tl, tslot, taux, g = t
    _, _, jev, tev, jc = proxy_pair()
    ct = np.random.RandomState(5).randn(tl.plan.n_slots, 4).astype(
        np.float32)
    g_c, g_cd = tptc.proxy_bwd_moments(
        tslot.positions, tslot.types, taux["valid"], torch.as_tensor(ct),
        tl.plan, tl.lo, tev.basis, rc2_tab=tl.rc2_tab, needs_energy=energy,
        geometry=g)
    assert tptc.proxy_bwd_moments.launches == 0

    def primal(c):
        return j_ptf(c, jev, jslot.positions, jslot.types, jaux["valid"],
                     jl.plan, jlo, with_types=True, rcut_matrix=RCM,
                     lengths=jlen, needs_energy=energy, fwd_stencil="full",
                     bwd_impl="xla")
    _, vjp = jax.vjp(primal, jc)
    gj = vjp(jnp.asarray(ct))[0]
    K = tev.basis["K"]
    want = np.concatenate([np.concatenate([np.asarray(gj[p]["c"]),
                                           np.asarray(gj[p]["cd"])])
                           for p in jev.basis["pairs"]])
    got = np.concatenate([np_(g_c).reshape(-1, K),
                          np_(g_cd).reshape(-1, K)], axis=1).ravel()
    np.testing.assert_allclose(got, want, rtol=2e-4,
                               atol=2e-5 * np.abs(want).max())
    if not energy:
        assert not np_(g_c).any()
