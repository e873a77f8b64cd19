"""Forces (and virial) from energies by autodiff (PyTorch port of
``hoomd_tf_tpu/ops/forces.py``).

Same contract as the JAX package and the reference:

- ``compute_nlist_forces(nlist, energy, virial=False)``: pairwise forces
  ``F_i = 2 sum_j dE/dnlist_ij`` (the 2 compensates the double-counted
  full neighbor list; no minus sign, the nlist vectors point away from
  the particle);
- ``compute_positions_forces(positions, energy)``: ``F = -dE/dpos``;
- both pack the per-particle energy into column 4 of the ``[N, 4]``
  result.

PyTorch keeps a tape, as the reference's TensorFlow does, so the energy
value is differentiated directly: :meth:`..models.simmodel.SimModel.
__call__` hands ``compute`` a detached nlist (and positions) that
requires grad, and the gradient is ``torch.autograd.grad`` of the energy
with respect to that tensor, or to any tensor derived from it (a row
slice, say). The JAX package's capture-and-replay scheme and its slice
registry exist only because JAX has no tape; they have no counterpart
here. The callable form ``energy = f(nlist)`` works too, inside a model
or outside.

The gradient keeps its graph (``create_graph``) when the model is called
with ``training=True`` (or with ``keep_graph=True``, which the lane-fast
training route uses to call a model with ``training=False``), so a loss
on the forces trains the weights; outside a model it keeps it whenever
grad mode is on.
"""

import contextlib
import contextvars

import torch

__all__ = ["compute_nlist_forces", "compute_positions_forces"]

# whether the SimModel call in flight keeps its force gradients' graph
# (None outside a model)
_TRAINING = contextvars.ContextVar("htf_training", default=None)


@contextlib.contextmanager
def model_call(training, keep_graph=None):
    """Mark a model call in flight: the force gradients keep their graph
    exactly when ``keep_graph``, by default ``training``."""
    keep = training if keep_graph is None else keep_graph
    token = _TRAINING.set(bool(keep))
    try:
        yield
    finally:
        _TRAINING.reset(token)


def _create_graph():
    training = _TRAINING.get()
    return torch.is_grad_enabled() if training is None else training


def _add_energy(forces, energy):
    """Pack the (per-particle) energy into column 4 of the forces: a
    scalar energy is broadcast to every row, an energy of rank >= 2 is
    summed over its trailing axes."""
    energy = torch.as_tensor(energy, dtype=forces.dtype,
                             device=forces.device)
    n = forces.shape[0]
    if energy.ndim > 1:
        col = torch.sum(energy, dim=tuple(range(1, energy.ndim)))
        col = col.reshape(n, 1)
    elif energy.ndim == 0:
        col = energy.reshape(1, 1).expand(n, 1)
    else:
        col = energy.reshape(n, 1)
    return torch.cat([forces[:, :3], col.to(forces.dtype)], dim=-1)


def _compute_virial(nlist, nlist_forces):
    """Pairwise virial ``W_i = -1/2 sum_j sym(f_ij (x) r_ij)`` with
    ``f_ij = 2 dE/dnlist_ij``: ``[N, 3, 3]``, HOOMD's sign convention.
    Exact for any pair force (the JAX package's deviation from the
    reference's norm-based form, kept)."""
    nlist3 = nlist[:, :, :3]
    f = nlist_forces[..., :3]
    outer = torch.einsum("ijk,ijl->ikl", f, nlist3)
    return -0.25 * (outer + outer.transpose(-1, -2))


def _sanitize(grad):
    """Zero the non-finite gradient elements: a padded (all-zero) row
    must contribute exactly zero force even when a natural energy form
    (``divide_no_nan(1, norm(nlist)**6)``) gives NaN there."""
    return torch.where(torch.isfinite(grad), grad, torch.zeros_like(grad))


def _energy_grad(kind, value, energy):
    """``(energy value, [d sum(energy) / d x for x in wrt], create_graph)``
    with ``wrt`` the value itself, or the ``dx, dy, dz`` components of
    planes; ``energy`` is a value computed from ``value`` or a callable
    ``f(value) -> energy``."""
    from .direct import NlistPlanes
    create_graph = _create_graph()
    planes = isinstance(value, NlistPlanes)
    with torch.enable_grad():
        if callable(energy):
            if planes:
                value = NlistPlanes(*(c if c.requires_grad else
                                      c.detach().requires_grad_()
                                      for c in value[:3]), value.type)
            elif not value.requires_grad:
                value = value.detach().requires_grad_()
            energy = energy(value)
        wrt = list(value[:3]) if planes else [value]
        energy = torch.as_tensor(energy)
        if not energy.requires_grad:
            # an energy that does not depend on any tensor with a
            # gradient (a constant): zero forces, as JAX's vjp gives
            return energy, [torch.zeros_like(w) for w in wrt], False
        if not all(w.requires_grad for w in wrt):
            raise ValueError(
                f"the {kind} passed to compute_{kind}_forces does not "
                "require grad, so the energy cannot be differentiated "
                f"with respect to it: pass the model's {kind} input (or a "
                "tensor derived from it), or a callable energy function")
        grads = torch.autograd.grad(
            energy, wrt, torch.ones_like(energy), retain_graph=True,
            create_graph=create_graph, allow_unused=True)
    grads = [_sanitize(torch.zeros_like(w) if g is None else g)
             for g, w in zip(grads, wrt)]
    if not create_graph:
        energy = energy.detach()
    return energy, grads, create_graph


def compute_nlist_forces(nlist, energy, virial=False):
    """Pairwise forces (and optionally the virial) from a neighbor-list
    energy.

    :param nlist: ``[N, NN, 4]`` (or ``[N, NN, 3]``) neighbor list, or the
        wide-direct :class:`.direct.NlistPlanes`: the model's nlist input
        or a tensor derived from it.
    :param energy: the potential energy (size ``1``, ``N`` or ``N x L``)
        computed from ``nlist``, or a callable ``f(nlist) -> energy``.
    :param virial: also return the ``[N, 3, 3]`` pairwise virial.
    :return: ``[N, 4]`` forces with the per-particle energy in column 4,
        or ``(forces, virial)``.
    """
    from .direct import NlistPlanes
    e_val, grads, create_graph = _energy_grad("nlist", nlist, energy)
    if isinstance(nlist, NlistPlanes):
        # f_ij components = 2 dE/d(dx_ij), and likewise for y and z
        f = [2.0 * g for g in grads]
        forces = _add_energy(torch.stack([g.sum(dim=1) for g in f], -1),
                             e_val)
        if not virial:
            return forces
        r = [c if create_graph else c.detach() for c in nlist[:3]]
        w = torch.stack([torch.stack(
            [-0.25 * torch.sum(f[a] * r[b] + f[b] * r[a], dim=1)
             for b in range(3)], dim=-1) for a in range(3)], dim=-2)
        return forces, w
    nlist_forces = 2.0 * grads[0]
    forces = _add_energy(torch.sum(nlist_forces, dim=1), e_val)
    if virial:
        if not create_graph:
            nlist = nlist.detach()
        return forces, _compute_virial(nlist, nlist_forces)
    return forces


def compute_positions_forces(positions, energy):
    """Position-dependent forces ``F = -dE/dpos``.

    :param positions: ``[N, 4]`` or ``[N, 3]`` positions: the model's
        positions input or a tensor derived from it.
    :param energy: the potential energy computed from ``positions``, or
        a callable ``f(positions) -> energy``.
    :return: ``[N, 4]`` forces with the per-particle energy in column 4.
    """
    e_val, grads, _ = _energy_grad("positions", positions, energy)
    return _add_energy(-grads[0], e_val)
