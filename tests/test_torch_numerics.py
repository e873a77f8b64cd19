"""Port vs JAX package: the NaN-safe numerics of the generic model route
(``ops/numerics.py``), on the same numpy inputs.

Tolerances: exact where both compute the same float32 operations in the
same order (the masks, ``divide_no_nan``, ``multiply_no_nan``); 1e-6
relative for the norms, whose reduction order may differ. Padded
all-zero rows must give exactly zero value and zero gradient under
``torch.autograd``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import hoomd_tf_tpu as htf
import hoomd_tf_tpu_torch as htt

from torch_helpers import nlist_with_padding, np_


def test_nlist_rinv_matches_jax():
    nl = nlist_with_padding()
    got = np_(htt.nlist_rinv(torch.as_tensor(nl)))
    want = np_(htf.nlist_rinv(jnp.asarray(nl)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert np.all(got[nl[..., :3].any(-1) == 0] == 0)


@pytest.mark.parametrize("axis", [-1, 0])
def test_safe_norm_matches_jax(axis):
    x = np.random.RandomState(1).randn(20, 3).astype(np.float32)
    got = np_(htt.safe_norm(torch.as_tensor(x), axis=axis))
    want = np_(htf.safe_norm(jnp.asarray(x), axis=axis))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("fn", ["divide_no_nan", "multiply_no_nan"])
def test_no_nan_ops_match_jax(fn):
    rng = np.random.RandomState(2)
    x = rng.randn(64).astype(np.float32)
    y = rng.randn(64).astype(np.float32)
    y[::4] = 0.0
    if fn == "multiply_no_nan":
        x[::8] = np.inf
        x[1::8] = np.nan
    got = np_(getattr(htt, fn)(torch.as_tensor(x), torch.as_tensor(y)))
    want = np_(getattr(htf, fn)(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_array_equal(got, want)
    assert np.all(got[y == 0] == 0)


@pytest.mark.parametrize("ti,tj", [(None, 1), (0, None), (1, 2)])
def test_masked_nlist_matches_jax(ti, tj):
    nl = nlist_with_padding(seed=3)
    types = np.random.RandomState(4).randint(0, 3, nl.shape[0]).astype(
        np.float32)
    got = htt.masked_nlist(torch.as_tensor(nl), torch.as_tensor(types),
                           type_i=ti, type_j=tj)
    want = htf.masked_nlist(jnp.asarray(nl), jnp.asarray(types),
                            type_i=ti, type_j=tj)
    np.testing.assert_array_equal(np_(got), np_(want))


def test_padded_rows_zero_value_and_gradient():
    """A padded row gives exactly zero 1/r and zero gradient (no NaN),
    through nlist_rinv and through divide_no_nan of a norm."""
    nl = torch.as_tensor(nlist_with_padding(seed=5), dtype=torch.float32)
    nl.requires_grad_()
    pad = (nl.detach()[..., :3] == 0).all(-1)
    rinv = htt.nlist_rinv(nl)
    assert torch.all(rinv[pad] == 0)
    g, = torch.autograd.grad(torch.sum(rinv ** 6), nl)
    assert torch.isfinite(g).all()
    assert torch.all(g[pad] == 0)
    r = htt.safe_norm(nl[..., :3], dim=-1, delta=0.0)
    e = htt.divide_no_nan(torch.ones_like(r), r ** 6)
    g, = torch.autograd.grad(torch.sum(e), nl)
    assert torch.all(e[pad] == 0)
    assert torch.all(g[pad] == 0) and torch.isfinite(g[~pad]).all()
