"""NaN-safe numerics of pair-potential models (PyTorch port of
``hoomd_tf_tpu/ops/numerics.py``).

Padded (all-zero) neighbor rows must contribute exactly zero energy, zero
force and zero gradient. As in the JAX package, that takes double-
``where`` guards: the gradient of ``where`` still carries NaN from the
branch not taken, so the unsafe operand is replaced before the operation.

Each helper takes the packed ``[N, NN, 4]`` list or the wide-direct
:class:`.direct.NlistPlanes`.
"""

import torch

from .._device import resolve_device

__all__ = ["safe_norm", "nlist_rinv", "masked_nlist", "divide_no_nan",
           "multiply_no_nan"]


def _operands(x, y, device, what):
    """``(x, y)`` as tensors. Host data takes the other operand's dtype
    and device; with no tensor operand, or a ``device`` named, both go to
    ``device``, by default the CUDA card (the port's rule)."""
    if device is not None or not (torch.is_tensor(x) or torch.is_tensor(y)):
        dev = resolve_device(device, what)
        x, y = (torch.as_tensor(v, device=dev) for v in (x, y))
    if not torch.is_tensor(x):
        x = torch.as_tensor(x, dtype=y.dtype, device=y.device)
    if not torch.is_tensor(y):
        y = torch.as_tensor(y, dtype=x.dtype, device=x.device)
    return x, y


def divide_no_nan(x, y, device=None):
    """``x / y``, but exactly 0 (with zero gradient) where ``y == 0``
    (``tf.math.divide_no_nan``). Host operands go to ``device`` as
    :func:`.box.make_box`'s do."""
    x, y = _operands(x, y, device, "divide_no_nan")
    zero = y == 0
    safe_y = torch.where(zero, torch.ones_like(y), y)
    q = x / safe_y
    return torch.where(zero, torch.zeros_like(q), q)


def multiply_no_nan(x, y, device=None):
    """``x * y``, but exactly 0 where ``y == 0`` even if ``x`` is NaN or
    inf (``tf.math.multiply_no_nan``; devices as :func:`divide_no_nan`)."""
    x, y = _operands(x, y, device, "multiply_no_nan")
    zero = y == 0
    safe_x = torch.where(zero, torch.zeros_like(x), x)
    p = safe_x * y
    return torch.where(zero, torch.zeros_like(p), p)


def safe_norm(tensor, delta=1e-7, dim=None, **kwargs):
    """Norm with ``delta`` added to the components first, so near-zero
    vectors have a finite gradient (the reference's ``safe_norm``). Do not
    combine with :func:`divide_no_nan`; use :func:`nlist_rinv`.

    :param dim: axis of the norm (``axis=`` is accepted too, as in the
        JAX package).
    """
    if "axis" in kwargs:
        dim = kwargs.pop("axis")
    return torch.linalg.norm(tensor + delta, dim=dim, **kwargs)


def nlist_rinv(nlist):
    """``1/r`` per neighbor of an ``[N, NN, 4]`` list or of planes:
    exactly zero for padded rows, differentiable. The deltas are the
    reference's, kept verbatim (they keep the parameter gradient of
    ``1/r`` free of NaN). On planes, as in the JAX package, a fused
    ``rsqrt`` of the offset components replaces the norm and the divide.

    :return: ``[N, NN]`` (or ``[N, C]``).
    """
    from .direct import NlistPlanes
    delta = 3e-6
    d = delta / 3 / 10
    if isinstance(nlist, NlistPlanes):
        r2 = (nlist.dx + d) ** 2 + (nlist.dy + d) ** 2 + (nlist.dz + d) ** 2
        good = r2 > delta * delta
        safe_r2 = torch.where(good, r2, torch.ones_like(r2))
        return torch.where(good, torch.rsqrt(safe_r2), torch.zeros_like(r2))
    r = safe_norm(nlist[..., :3], dim=-1, delta=d)
    # double-where so the gradient of the untaken branch is cut
    safe_r = torch.where(r > delta, r, torch.ones_like(r))
    return torch.where(r > delta, 1.0 / (safe_r + delta),
                       torch.zeros_like(r))


def masked_nlist(nlist, type_tensor, type_i=None, type_j=None):
    """Neighbor list masked by particle type(s). As in the JAX package,
    ``type_i`` zeroes the rows of other center types instead of removing
    them (a static shape; a zero row contributes nothing downstream).

    :param nlist: ``[N, NN, 4]`` neighbor list, or planes.
    :param type_tensor: ``[N]`` particle types (e.g. ``positions[:, 3]``).
    :param type_i: center-particle type filter.
    :param type_j: neighbor type filter.
    :return: the masked list, in the form it came.
    """
    from .direct import NlistPlanes
    if isinstance(nlist, NlistPlanes):
        mask = torch.ones_like(nlist.dx)
        if type_i is not None:
            mask = mask * (type_tensor == type_i).to(nlist.dx.dtype)[:, None]
        if type_j is not None:
            mask = mask * (nlist.type == type_j).to(nlist.dx.dtype)
        return nlist.map(lambda c: c * mask)
    if type_i is not None:
        mask = (type_tensor == type_i).to(nlist.dtype)
        nlist = nlist * mask[:, None, None]
    if type_j is not None:
        mask = (nlist[:, :, 3] == type_j).to(nlist.dtype)
        nlist = nlist * mask[:, :, None]
    return nlist
