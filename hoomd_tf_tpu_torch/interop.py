"""Carry state and weights from the JAX package into the port.

Both directions of a comparison start from the same numbers: a JAX
``SimState``'s arrays, taken as numpy, become the port's
:class:`.md.state.SimState` on a chosen device, and a JAX model's
``get_weights()`` list is copied into the port's module. Nothing here
imports JAX.

Both packages build ``Dense`` layers lazily, at the first call, so a
model's weight list is complete only after one call: build the port's
model with :func:`build_model` (one call at the proxy's nodes) and the
JAX model likewise before copying.
"""

import numpy as np
import torch

from ._device import resolve_device
from .md.state import SimState

__all__ = ["state_from_numpy", "load_jax_variables", "build_model"]

_FLOAT_FIELDS = ("positions", "velocities", "masses", "box", "forces",
                 "virial")


def state_from_numpy(arrays, device=None, dtype=torch.float32):
    """Build the port's ``SimState`` from a mapping of numpy arrays named
    like the JAX ``SimState`` fields (``positions``, ``velocities``,
    ``types``, ``masses``, ``box``, optional ``forces``, ``virial``,
    ``step`` and ``thermostat``; a JAX ``rng`` entry is ignored: the
    port draws from its ``Simulation``'s ``torch.Generator``). ``device``
    defaults to the CUDA card; pass ``device="cpu"`` for the CPU."""
    device = resolve_device(device, "state_from_numpy")
    a = dict(arrays)
    n = np.asarray(a["positions"]).shape[0]
    a.setdefault("forces", np.zeros((n, 4), np.float32))
    a.setdefault("virial", np.zeros((n, 3, 3), np.float32))
    kw = {k: torch.as_tensor(np.array(a[k]), dtype=dtype, device=device)
          for k in _FLOAT_FIELDS}
    thermostat = {k: torch.as_tensor(np.array(v), dtype=dtype,
                                     device=device)
                  for k, v in (a.get("thermostat") or {}).items()}
    return SimState(
        types=torch.as_tensor(np.array(a["types"]), dtype=torch.int32,
                              device=device),
        step=int(np.asarray(a.get("step", 0))), thermostat=thermostat,
        **kw)


def load_jax_variables(model, arrays):
    """Copy a JAX model's variables (its ``get_weights()`` list of numpy
    arrays, in the JAX package's variable order) into the port's
    :class:`.models.module.Layer` ``model``; shapes must match."""
    model.set_weights([np.asarray(a) for a in arrays])
    return model


def build_model(model, r_cut, device=None):
    """Build a proxy ``PairModel``'s lazy layers on ``device`` (default:
    the CUDA card; pass ``device="cpu"`` for the CPU) by one call at its
    Chebyshev proxy's nodes. Returns the model."""
    device = resolve_device(device, "build_model")
    model.to(device)
    with torch.no_grad():
        model.proxy_coeffs(r_cut, device)
    return model
