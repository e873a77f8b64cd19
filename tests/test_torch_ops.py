"""Port vs JAX package: box math, state construction and thermo, on the
same numpy inputs. Tolerances: exact where the arithmetic is the same
operations in the same order, 1e-6 relative for float32 sums that may be
taken in another order."""

import importlib
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import hoomd_tf_tpu as htf
import hoomd_tf_tpu_torch as htt
from hoomd_tf_tpu_torch.md import state as tstate
from hoomd_tf_tpu_torch.ops import box as tbox

from torch_helpers import fluid_arrays, jax_state, np_, torch_state

# both md namespaces export a `thermo` function under the module's name
jthermo = importlib.import_module("hoomd_tf_tpu.md.thermo")
tthermo = importlib.import_module("hoomd_tf_tpu_torch.md.thermo")


class TestBox:
    def test_make_box_and_lengths(self):
        lengths = np.array([4.0, 5.5, 7.25], np.float32)
        np.testing.assert_array_equal(
            np_(tbox.box_from_lengths(lengths, device="cpu")),
            np_(htf.ops.box_from_lengths(lengths)))
        np.testing.assert_array_equal(
            np_(tbox.make_box([-1, -2, -3], [1, 2, 3], device="cpu")),
            np_(htf.ops.make_box([-1, -2, -3], [1, 2, 3])))
        b = tbox.box_from_lengths(lengths, device="cpu")
        np.testing.assert_array_equal(np_(htt.box_size(b)), lengths)

    def test_wrap_vector(self):
        rng = np.random.RandomState(0)
        r = rng.uniform(-20, 20, (50, 3)).astype(np.float32)
        lengths = np.array([4.0, 5.5, 7.25], np.float32)
        got = htt.wrap_vector(torch.as_tensor(r),
                              tbox.box_from_lengths(lengths, device="cpu"))
        want = htf.wrap_vector(jnp.asarray(r),
                               htf.ops.box_from_lengths(lengths))
        np.testing.assert_allclose(np_(got), np_(want), rtol=0, atol=1e-5)

    @pytest.mark.parametrize("call", ["make_box", "wrap_vector"])
    def test_tilt_not_ported(self, call):
        """Tilted boxes were refused before the port's slice E; now
        ``make_box`` keeps the tilt row and ``wrap_vector`` applies the
        triclinic minimum image, both equal to the JAX package's (exact
        for the box, 1e-5 absolute for the wrap: float32 rounding)."""
        tilt = [0.1, -0.3, 0.2]
        if call == "make_box":
            np.testing.assert_array_equal(
                np_(tbox.make_box([0, 0, 0], [1, 1, 1], tilt=tilt,
                                  device="cpu")),
                np_(htf.ops.make_box([0, 0, 0], [1, 1, 1], tilt=tilt)))
        else:
            rng = np.random.RandomState(1)
            r = rng.uniform(-3, 3, (64, 3)).astype(np.float32)
            box = np.array([[0., 0, 0], [1, 1.5, 2], tilt], np.float32)
            np.testing.assert_allclose(
                np_(htt.wrap_vector(torch.as_tensor(r),
                                    torch.as_tensor(box))),
                np_(htf.wrap_vector(jnp.asarray(r), jnp.asarray(box))),
                rtol=0, atol=1e-5)


class TestState:
    @pytest.mark.parametrize("kind,n", [("sc", 100), ("fcc", 108)])
    def test_lattice_positions(self, kind, n):
        from hoomd_tf_tpu.md.state import lattice_positions
        for a, b in zip(tstate.lattice_positions(n, density=0.3, kind=kind),
                        lattice_positions(n, density=0.3, kind=kind)):
            np.testing.assert_array_equal(a, b)

    def test_init_state_matches(self):
        pos, vel, lengths = fluid_arrays(64, 0.3, seed=1)
        types = np.arange(64) % 3
        js = jax_state(pos, vel, lengths, types=types)
        ts = torch_state(pos, vel, lengths, types=types)
        for f in ("positions", "velocities", "types", "masses", "box",
                  "forces", "virial", "positions4"):
            np.testing.assert_array_equal(np_(getattr(ts, f)),
                                          np_(getattr(js, f)), err_msg=f)
        assert ts.types.dtype == torch.int32

    def test_init_state_thermal_velocities(self):
        """kT_init draws from the given torch.Generator: zero net
        momentum, reproducible from the seed."""
        pos, _, lengths = fluid_arrays(500, 0.3)
        draws = []
        for _ in range(2):
            g = torch.Generator().manual_seed(5)
            draws.append(tstate.init_state(pos, lengths, kT_init=1.2,
                                           generator=g,
                                           device="cpu").velocities)
        torch.testing.assert_close(draws[0], draws[1], rtol=0, atol=0)
        assert float(draws[0].mean(0).abs().max()) < 1e-6
        t = float(tthermo.temperature(tstate.init_state(
            pos, lengths, velocities=draws[0], device="cpu")))
        assert 1.0 < t < 1.4


class TestThermo:
    @pytest.mark.parametrize("dof", [None, 60.0])
    def test_thermo_matches(self, dof):
        pos, vel, lengths = fluid_arrays(32, 0.3, seed=2)
        rng = np.random.RandomState(3)
        forces = rng.normal(size=(32, 4)).astype(np.float32)
        virial = rng.normal(size=(32, 3, 3)).astype(np.float32)
        masses = rng.uniform(0.5, 2.0, 32).astype(np.float32)
        js = jax_state(pos, vel, lengths)
        js = dataclasses.replace(
            js, forces=jnp.asarray(forces), virial=jnp.asarray(virial),
            masses=jnp.asarray(masses),
            thermostat={} if dof is None else {"dof": jnp.float32(dof)})
        ts = torch_state(pos, vel, lengths)
        ts.forces = torch.as_tensor(forces)
        ts.virial = torch.as_tensor(virial)
        ts.masses = torch.as_tensor(masses)
        ts.thermostat = {} if dof is None else {"dof": dof}
        got, want = tthermo.thermo(ts), jthermo.thermo(js)
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=1e-6, err_msg=k)
