"""Carry state and weights from the JAX package into the port.

Both directions of a comparison start from the same numbers: a JAX
``SimState``'s arrays, taken as numpy, become the port's
:class:`.md.state.SimState` on a chosen device, and a JAX model's
``get_weights()`` list is copied into the port's module. Nothing here
imports JAX.

The ready-made potentials carry across the same way: ``TrainableLJ``'s
``epsilon`` and ``sigma``, and ``NeuralPairPotential``'s hidden kernels
and biases then its output kernel, each after the two bookkeeping
variables, in the JAX package's order; so do a model's
:class:`.models.module.Variable` s (after its own weights, before its
layers') and north_star.py's two NN models (``TrainableNNPair``,
``TrainableNN``: the first layer's kernel and bias, then the last's).

Both packages build ``Dense`` layers lazily, at the first call, so a
model's weight list is complete only after one call: build the port's
model with :func:`build_model` (one call at a proxy's nodes, or on a zero
``[rows, NN, 4]`` neighbor list) and the JAX model likewise
(``ensure_built``) before copying.

A mapped state carries across as any other: the ``n + m`` rows that the
JAX package's ``enable_mapped_nlist`` leaves (atoms, then CG beads with
their offset types) become the port's rows one to one. A mapped model or
a ``MolSimModel`` is built at that row count (``build_model(rows=)``). No JAX ``BCOO`` is read:
the port's :func:`.utils.cg.sparse_mapping` is built from the same numpy
inputs.
"""

import numpy as np
import torch

from ._device import resolve_device
from .md.state import SimState
from .models.module import StateSnapshot

__all__ = ["state_from_numpy", "load_jax_variables", "build_model"]

_FLOAT_FIELDS = ("positions", "velocities", "masses", "box", "forces",
                 "virial")


def state_from_numpy(arrays, device=None, dtype=None):
    """Build the port's ``SimState`` from a mapping of numpy arrays named
    like the JAX ``SimState`` fields (``positions``, ``velocities``,
    ``types``, ``masses``, ``box``, optional ``forces``, ``virial``,
    ``step`` and ``thermostat``). The box keeps its tilt row (``tilted``
    is set from it). A JAX ``rng`` entry (a PRNG key) is not carried:
    the port's stochastic integrators draw from their ``Simulation``'s
    ``torch.Generator``, whose numbers differ from JAX's for any seed.
    ``device`` defaults to the CUDA card; pass ``device="cpu"`` for the
    CPU. ``dtype`` defaults to the positions' own: float64 arrays (a JAX
    x64 state) stay float64, anything else becomes float32."""
    device = resolve_device(device, "state_from_numpy")
    a = dict(arrays)
    n = np.asarray(a["positions"]).shape[0]
    if dtype is None:
        dtype = (torch.float64 if np.asarray(a["positions"]).dtype ==
                 np.float64 else torch.float32)
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
        tilted=bool(np.any(np.asarray(a["box"])[2] != 0)), **kw)


def load_jax_variables(model, arrays):
    """Copy a JAX model's variables (its ``get_weights()`` list of numpy
    arrays, in the JAX package's variable order) into the port's
    :class:`.models.module.Layer` ``model``; shapes must match. Every
    variable is carried: trainable or not, float, int32 or bool, and
    the state of the running metrics and the EDS layer, whose lazily
    built variables need :func:`build_model` first. Each value takes its
    variable's dtype: a JAX x64 model's float64 weights enter a float64
    port model without rounding."""
    model.set_weights([np.asarray(a) for a in arrays])
    return model


def build_model(model, r_cut, device=None, rows=1):
    """Build a model's lazy layers on ``device`` (default: the CUDA card;
    pass ``device="cpu"`` for the CPU) by one call: a proxy
    ``PairModel`` at its Chebyshev proxy's nodes, any other model on a
    zero ``[rows, NN, 4]`` neighbor list. A mapped model or a
    ``MolSimModel`` needs its simulation's row count (atoms and beads;
    at least the atoms its molecules index), as does a model whose
    lazily built state is sized by rows. The call leaves no trace in the
    model's state: a metric counts nothing, and a variable it built
    (a ``MeanTensor``'s, an ``EDSLayer``'s) holds its initial value, as
    the JAX package's abstract build leaves them. Returns the model."""
    device = resolve_device(device, "build_model")
    model.to(device)
    if getattr(model, "proxy_degree", None):
        with torch.no_grad():
            model.proxy_coeffs(r_cut, device)
        return model
    kw = dict(dtype=model.dtype, device=device)
    nn = max(1, model.nneighbor_cutoff)
    snap = StateSnapshot(model)
    model([torch.zeros((rows, nn, 4), **kw), torch.zeros((rows, 4), **kw),
           torch.zeros((3, 3), **kw)], training=False)
    snap.restore()
    return model
