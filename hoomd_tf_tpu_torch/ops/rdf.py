"""Radial distribution function from a neighbor list (PyTorch port of
``hoomd_tf_tpu/ops/rdf.py``)."""

import numpy as np
import torch

from .numerics import masked_nlist

__all__ = ["compute_rdf"]


def compute_rdf(nlist, r_range, type_tensor=None, nbins=100, type_i=None,
                type_j=None):
    """Pairwise radial distribution function (not normalized), as the
    JAX package computes it: the ``nbins`` histogram bins align with the
    shell radii, and padded (``r == 0``) and out-of-range slots are left
    out (the reference's ``simmodel.py:638-669`` dropped its edge bins).

    :param nlist: ``[N, NN, 4]`` neighbor list, or
        :class:`.direct.NlistPlanes`.
    :param r_range: ``(r_min, r_max)`` of the histogram.
    :param type_tensor: ``[N]`` particle types (e.g. ``positions[:, 3]``).
    :param nbins: number of histogram bins.
    :param type_i: center-particle type filter.
    :param type_j: neighbor type filter.
    :return: ``(rdf [nbins], bin-center radii [nbins])``, float32.
    """
    from .direct import NlistPlanes
    if type_tensor is not None:
        nlist = masked_nlist(nlist, type_tensor, type_i, type_j)
    if isinstance(nlist, NlistPlanes):
        r = torch.sqrt(nlist.r2())
    else:
        r = torch.linalg.norm(nlist[:, :, :3], dim=2)
    if torch.is_tensor(r_range):
        r_range = r_range.to(dtype=torch.float32, device=r.device)
        lo, hi = r_range[0], r_range[1]
    else:
        # float32 host scalars, so no copy to the device waits in a step
        # loop; the arithmetic stays float32, as the JAX package's
        lo, hi = (np.float32(v) for v in r_range)
    width = (hi - lo) / np.float32(nbins)
    valid = (r > 0) & (r >= lo) & (r < hi)
    bin_idx = torch.clamp(((r - lo) / width).to(torch.int32), 0, nbins - 1)
    # invalid slots add 0.0, so their (clipped) bin index is harmless
    hist = torch.zeros(nbins, dtype=torch.float32, device=r.device)
    hist.index_add_(0, bin_idx.reshape(-1).long(),
                    valid.reshape(-1).to(torch.float32))
    # jnp.linspace's arithmetic: lo (1 - f) + hi f, f = i / nbins
    f = torch.arange(nbins, dtype=torch.float32, device=r.device) / nbins
    shell_rs = torch.cat([lo * (1.0 - f) + hi * f,
                          torch.ones_like(f[:1]) * hi])
    vis_rs = (shell_rs[1:] + shell_rs[:-1]) * 0.5
    vols = shell_rs[1:] ** 3 - shell_rs[:-1] ** 3
    return hist / vols, vis_rs
