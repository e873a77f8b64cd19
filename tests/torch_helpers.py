"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``).

Inputs are made with numpy from a seed and handed to both packages, so
the JAX package (the reference) and the PyTorch port see the same
numbers. Torch runs single-threaded: the suite runs under several xdist
workers at once.
"""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def fluid_arrays(n, density, seed=0, jitter=0.2, kT=1.0):
    """A jittered simple-cubic lattice with Maxwell-Boltzmann velocities:
    numpy ``(positions, velocities, lengths)``. The jitter is bounded, as
    in tests/test_cellwise.py, so no pair overlaps deeply."""
    from hoomd_tf_tpu_torch.md.state import lattice_positions
    pos, lengths = lattice_positions(n, density=density)
    rng = np.random.RandomState(seed)
    pos = pos + jitter * rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    vel = rng.normal(size=(n, 3)).astype(np.float32) * np.float32(
        np.sqrt(kT))
    vel -= vel.mean(axis=0)
    return pos.astype(np.float32), vel.astype(np.float32), lengths


def jax_state(pos, vel, lengths, types=None):
    from hoomd_tf_tpu.md.state import init_state
    return init_state(pos, lengths, types=types, velocities=vel)


def torch_state(pos, vel, lengths, types=None, device="cpu"):
    from hoomd_tf_tpu_torch.md.state import init_state
    return init_state(pos, lengths, types=types, velocities=vel,
                      device=device)


def jax_state_numpy(state):
    """A JAX SimState's arrays as numpy (the input of
    ``interop.state_from_numpy``)."""
    out = {f.name: np.asarray(getattr(state, f.name))
           for f in dataclasses.fields(state)
           if f.name not in ("rng", "thermostat")}
    out["thermostat"] = {k: np.asarray(v)
                         for k, v in (state.thermostat or {}).items()}
    return out


def np_(t):
    """A torch tensor or JAX array as numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


@pytest.fixture
def cuda_device():
    """The CUDA device, or a skip: tests that need the card run on the
    machine with one (the decision is made here, at run time, never while
    a test module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100 machine)")
    return torch.device("cuda")


def lj_slope_jax(r2, ti=None, tj=None):
    """A two-type LJ pair function (JAX), as tests/test_cellwise.py's."""
    import jax.numpy as jnp
    u = 1.0 / r2
    sr6 = u * u * u
    eps = jnp.where((ti == 0) & (tj == 0), 1.0, 0.5)
    return (4.0 * eps * (sr6 * sr6 - sr6),
            -12.0 * eps * (2.0 * sr6 - 1.0) * sr6 * u)


def lj_slope_torch(r2, ti=None, tj=None):
    """The same pair function in torch."""
    u = 1.0 / r2
    sr6 = u * u * u
    eps = torch.where((ti == 0) & (tj == 0), 1.0, 0.5)
    return (4.0 * eps * (sr6 * sr6 - sr6),
            -12.0 * eps * (2.0 * sr6 - 1.0) * sr6 * u)
