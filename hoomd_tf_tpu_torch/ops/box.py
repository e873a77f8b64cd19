"""Simulation-box math (PyTorch port of ``hoomd_tf_tpu/ops/box.py``).

Same convention as the JAX package: a ``[3, 3]`` box tensor whose rows
are ``low``, ``high`` and the dimensionless tilt factors ``(xy, xz,
yz)`` of HOOMD. Triclinic (tilted) boxes are supported within HOOMD's
range ``|tilt| <= 0.5``, where the sequential minimum-image wrap is
exact (:func:`check_tilt`).
"""

import numpy as np
import torch

from .._device import device_for

__all__ = ["make_box", "box_from_lengths", "box_size", "box_matrix",
           "wrap_vector", "check_tilt", "host_tilt"]

#: the largest |tilt factor| the sequential minimum image is exact for
TILT_MAX = 0.5


def host_tilt(tilt):
    """The tilt factors as a tuple of host floats (a CUDA tensor is read
    back once)."""
    t = tilt.detach().cpu().numpy() if torch.is_tensor(tilt) \
        else np.asarray(tilt)
    return tuple(float(v) for v in np.asarray(t, np.float64).reshape(3))


def check_tilt(tilt):
    """Raise ``ValueError`` unless every ``|tilt factor| <= 0.5`` (HOOMD's
    convention, the JAX driver's guard); returns the host tilt."""
    t = host_tilt(tilt)
    tilt_max = max(abs(v) for v in t)
    if tilt_max > TILT_MAX + 1e-9:
        raise ValueError(
            f"box tilt factors must satisfy |tilt| <= 0.5 (HOOMD "
            f"convention); got max |tilt| = {tilt_max:.4f} -- "
            "lattice-reduce the box first")
    return t


def make_box(low, high, tilt=None, dtype=torch.float32, device=None):
    """Assemble a ``[3, 3]`` box tensor from low/high corners and tilt
    factors (on ``device``: by default the CUDA card for host data, the
    input's own device for a tensor; pass ``device="cpu"`` for the
    CPU)."""
    device = device_for(low, device, "make_box")
    low = torch.as_tensor(low, dtype=dtype, device=device)
    high = torch.as_tensor(high, dtype=dtype, device=device)
    if tilt is None:
        tilt = torch.zeros(3, dtype=dtype, device=low.device)
    else:
        tilt = torch.as_tensor(np.asarray(tilt) if not torch.is_tensor(tilt)
                               else tilt, dtype=dtype, device=low.device)
    return torch.stack([low, high, tilt])


def box_from_lengths(lengths, dtype=torch.float32, device=None):
    """Centered orthorhombic box (``-L/2 .. L/2``) from ``[Lx, Ly, Lz]``
    (device as :func:`make_box`)."""
    device = device_for(lengths, device, "box_from_lengths")
    lengths = torch.as_tensor(lengths, dtype=dtype, device=device)
    if lengths.ndim == 0:
        lengths = lengths.expand(3)
    return make_box(-lengths / 2, lengths / 2, dtype=dtype,
                    device=lengths.device)


def box_size(box):
    """Edge lengths ``high - low`` (shape ``[3]``)."""
    return box[1, :] - box[0, :]


def box_matrix(box):
    """Upper-triangular cell matrix ``h`` whose columns are the lattice
    vectors (HOOMD convention):
    ``[[Lx, xy Ly, xz Lz], [0, Ly, yz Lz], [0, 0, Lz]]``."""
    L = box[1] - box[0]
    xy, xz, yz = box[2, 0], box[2, 1], box[2, 2]
    z = torch.zeros((), dtype=box.dtype, device=box.device)
    return torch.stack([torch.stack([L[0], xy * L[1], xz * L[2]]),
                        torch.stack([z, L[1], yz * L[2]]),
                        torch.stack([z, z, L[2]])])


def wrap_vector(r, box):
    """Minimum-image wrap of displacement vector(s) ``r`` (trailing axis
    3): HOOMD's sequential convention (z, then y, then x, each removing
    its lattice vector's image; exact for ``|tilt| <= 0.5``), operation
    for operation as the JAX ``wrap_vector``. With zero tilt it is
    ``r - round(r / L) * L``."""
    bs = box_size(box).to(r.dtype)
    xy, xz, yz = (box[2, i].to(r.dtype) for i in range(3))
    rx, ry, rz = r[..., 0], r[..., 1], r[..., 2]
    iz = torch.round(rz / bs[2])
    rx = rx - iz * xz * bs[2]
    ry = ry - iz * yz * bs[2]
    rz = rz - iz * bs[2]
    iy = torch.round(ry / bs[1])
    rx = rx - iy * xy * bs[1]
    ry = ry - iy * bs[1]
    rx = rx - torch.round(rx / bs[0]) * bs[0]
    return torch.stack([rx, ry, rz], dim=-1)
