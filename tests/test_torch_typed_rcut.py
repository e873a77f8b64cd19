"""A per-type-pair ``r_cut`` matrix on every route of the port, against
the JAX package's dense build (tests/test_typed_rcut.py::
test_all_paths_match): the dense ``'n2'``, the cell list with the sort
method (``'cell'``) and with kernel K3's plain version asked for
(``'pallas'``, which falls back to the sort method on typed cuts, as in
JAX), ``'direct'`` and ``'cellwise'``. Negative entries exclude a type
pair; the largest positive entry sizes the cells.

Tolerance: one step's forces at rtol 2e-4, atol 2e-5, the JAX test's."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import hoomd_tf_tpu as htf
import hoomd_tf_tpu_torch as htt
from hoomd_tf_tpu_torch.interop import state_from_numpy

from torch_helpers import jax_state_numpy, np_
from test_torch_log import JLJModel, TLJModel

M = np.array([[1.8, 2.4], [2.4, 1.3]], np.float32)


def two_type_fluid(n=512, density=0.3, seed=11, jitter=0.08):
    """The JAX test's two-type fluid (tests/test_typed_rcut.py)."""
    sim = htf.Simulation(dt=0.005, integrator=htf.md.NVE(), seed=seed)
    sim.init_lattice(n, density=density, kT_init=0.8)
    rng = np.random.RandomState(seed)
    sim.state = dataclasses.replace(
        sim.state,
        positions=sim.state.positions + jitter * jnp.asarray(
            rng.uniform(-1, 1, (n, 3)).astype(np.float32)),
        types=jnp.asarray(np.arange(n) % 2, dtype=jnp.int32))
    return sim


@pytest.fixture(scope="module")
def reference():
    """The JAX package's one step on its dense build, and its start."""
    sim = two_type_fluid()
    start = jax_state_numpy(sim.state)
    tfc = htf.tfcompute(JLJModel(64))
    tfc.attach(sim, r_cut=M, nlist="n2")
    sim.run(1)
    return start, np.asarray(sim.state.forces)


@pytest.mark.parametrize("mode", ["n2", "cell", "pallas", "direct",
                                  "cellwise"])
def test_all_routes_match_jax(mode, reference):
    start, want = reference
    sim = htt.Simulation(dt=0.005, integrator=htt.md.NVE(), seed=11,
                         device="cpu")
    sim.set_state(state_from_numpy(start, device="cpu"))
    tfc = htt.tfcompute(TLJModel(64))
    tfc.attach(sim, r_cut=M, nlist=mode)
    assert tfc.r_cut == pytest.approx(2.4)
    sim.run(1)
    if mode in ("cell", "pallas"):
        # typed cutoffs are not in kernel K3: the sort method selects
        assert sim._packed_build().method == "sort"
    got = np_(sim.state.forces)
    assert np.abs(want[:, :3]).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5,
                               err_msg=mode)
