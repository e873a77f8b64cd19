"""Simulation-box math (PyTorch port of ``hoomd_tf_tpu/ops/box.py``).

Same convention as the JAX package: a ``[3, 3]`` box tensor whose rows
are ``low``, ``high`` and the tilt factors ``(xy, xz, yz)``. This slice
of the port supports orthorhombic boxes only; a nonzero tilt raises
``NotImplementedError`` (triclinic boxes arrive with slice C of the
port, ROADMAP.md Queue 1 item 19).
"""

import numpy as np
import torch

from .._device import device_for

__all__ = ["make_box", "box_from_lengths", "box_size", "wrap_vector",
           "check_orthorhombic"]

_TILT_MSG = ("tilted (triclinic) boxes are not ported yet; they arrive "
             "with slice C of the PyTorch port (ROADMAP.md Queue 1 "
             "item 19)")


def check_orthorhombic(tilt):
    """Raise ``NotImplementedError`` for a nonzero tilt row (host-side
    check; a CUDA tensor is read back once)."""
    t = tilt.detach().cpu().numpy() if torch.is_tensor(tilt) \
        else np.asarray(tilt)
    if np.any(t != 0):
        raise NotImplementedError(_TILT_MSG)


def make_box(low, high, tilt=None, dtype=torch.float32, device=None):
    """Assemble a ``[3, 3]`` box tensor from low/high corners (on
    ``device``: by default the CUDA card for host data, the input's own
    device for a tensor; pass ``device="cpu"`` for the CPU)."""
    if tilt is not None:
        check_orthorhombic(tilt)
    device = device_for(low, device, "make_box")
    low = torch.as_tensor(low, dtype=dtype, device=device)
    high = torch.as_tensor(high, dtype=dtype, device=device)
    if tilt is None:
        tilt = torch.zeros(3, dtype=dtype, device=low.device)
    else:
        tilt = torch.as_tensor(tilt, dtype=dtype, device=low.device)
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


def wrap_vector(r, box):
    """Minimum-image wrap of displacement vector(s) ``r`` (trailing axis
    3) in an orthorhombic box: ``r - round(r / L) * L``."""
    check_orthorhombic(box[2])
    bs = box_size(box).to(r.dtype)
    return r - torch.round(r / bs) * bs
