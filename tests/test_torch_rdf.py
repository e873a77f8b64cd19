"""``compute_rdf`` of the port against the JAX package on the same
numpy-seeded lists: packed ``[N, NN, 4]`` lists and planes, with and
without type filters.

The bin radii agree within 1e-6. The rdf divides the counts by shell
volumes, differences of cubes of the bin edges; XLA may round an edge of
``jnp.linspace`` one float32 ulp off the port's, and the difference of
cubes turns that into a relative error up to ~3 eps hi / width (eps =
2^-23, hi the outer edge, width the bin's). The rdf values are held at
rtol 4 eps hi / width: 1e-5 to 6e-5 here."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import hoomd_tf_tpu as htf
from hoomd_tf_tpu.ops.direct import direct_cell_planes as jdirect
import hoomd_tf_tpu_torch as htt
from hoomd_tf_tpu_torch.ops import cell_list as tcl
from hoomd_tf_tpu_torch.ops.direct import direct_cell_planes

from torch_helpers import fluid_arrays, nlist_with_padding, np_


def _compare(t, j, r_range, nbins):
    (tr, tc), (jr, jc) = t, j
    assert tr.shape == tc.shape and tr.dtype == torch.float32
    np.testing.assert_allclose(np_(tc), np.asarray(jc), rtol=0, atol=1e-6)
    lo, hi = r_range
    rtol = 4 * 2.0 ** -23 * hi / ((hi - lo) / nbins)
    np.testing.assert_allclose(np_(tr), np.asarray(jr), rtol=rtol,
                               atol=1e-6)
    assert np_(tr).sum() > 0


@pytest.mark.parametrize("filt", [(None, None), (0, None), (1, 2)])
def test_rdf_packed_matches_jax(filt):
    nl = nlist_with_padding(n=60, nn=16, seed=2)
    types = np.random.RandomState(1).randint(0, 3, 60).astype(np.float32)
    ti, tj = filt
    tt = None if ti is None and tj is None else types
    t = htt.compute_rdf(torch.as_tensor(nl), (0.2, 3.5),
                        None if tt is None else torch.as_tensor(tt), 40,
                        ti, tj)
    j = htf.compute_rdf(jnp.asarray(nl), (0.2, 3.5),
                        None if tt is None else jnp.asarray(tt), 40, ti, tj)
    _compare(t, j, (0.2, 3.5), 40)


@pytest.mark.parametrize("nbins", [25, 100])
def test_rdf_planes_matches_jax(nbins):
    pos, _, lengths = fluid_arrays(300, 0.35, 4)
    pos4 = np.concatenate([pos, (np.arange(300) % 2)[:, None]], 1)
    pos4 = pos4.astype(np.float32)
    lengths = np.asarray(lengths, np.float32)
    grid, cap = tcl.plan(300, lengths, 2.5)
    cap = max(cap, tcl.max_occupancy(pos4, lengths, grid))
    tp, _ = direct_cell_planes(torch.as_tensor(pos4), 2.5, grid, cap,
                               torch.as_tensor(lengths))
    jp, _ = jdirect(jnp.asarray(pos4), 2.5, grid, cap, jnp.asarray(lengths))
    _compare(htt.compute_rdf(tp, (0.5, 2.5), nbins=nbins),
             htf.compute_rdf(jp, (0.5, 2.5), nbins=nbins), (0.5, 2.5), nbins)
    _compare(htt.compute_rdf(tp, (0.5, 2.5), torch.as_tensor(pos4[:, 3]),
                             nbins, 1, 0),
             htf.compute_rdf(jp, (0.5, 2.5), jnp.asarray(pos4[:, 3]),
                             nbins, 1, 0), (0.5, 2.5), nbins)


def test_rdf_same_on_planes_and_packed_list():
    """Every pair within the cut is in both forms: one histogram."""
    pos, _, lengths = fluid_arrays(200, 0.3, 5)
    pos4 = np.concatenate([pos, np.zeros((200, 1))], 1).astype(np.float32)
    lengths = np.asarray(lengths, np.float32)
    grid, cap = tcl.plan(200, lengths, 2.5)
    cap = max(cap, tcl.max_occupancy(pos4, lengths, grid))
    tp, _ = direct_cell_planes(torch.as_tensor(pos4), 2.5, grid, cap,
                               torch.as_tensor(lengths))
    nl = htt.cell_list_nlist(torch.as_tensor(pos4), 2.5, 64,
                             torch.as_tensor(lengths), grid=grid,
                             capacity=cap)
    a, _ = htt.compute_rdf(tp, (0.5, 2.5), nbins=30)
    b, _ = htt.compute_rdf(nl, (0.5, 2.5), nbins=30)
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
