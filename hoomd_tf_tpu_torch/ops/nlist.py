"""Dense neighbor-list construction (PyTorch port of
``hoomd_tf_tpu/ops/nlist.py``).

:func:`compute_nlist` is the dense O(N^2) build with the reference's
semantics (``utils.py:75-161``): the correctness oracle of the cell
lists, and the ``'n2'`` neighbor mode of the packed path. Outputs use
the reference convention: ``[N, NN, 4]``, the minimum-image displacement
``(dx, dy, dz)`` from particle i to its neighbor, then the neighbor's
type (in a simulation) or index; padded slots are all zero.

A full ``[3, 3]`` box with nonzero tilt factors gets the triclinic
minimum image (:func:`.box.wrap_vector`), as in the JAX package.
"""

import numpy as np
import torch

from .._device import device_for
from .box import box_size as _box_size, wrap_vector

__all__ = ["compute_nlist", "nlist_from_positions", "pair_rc2", "DenseNlist"]


def f32(x):
    """``x`` rounded to float32, as a Python float: the value a float32
    comparison with the JAX package's weakly typed scalar uses."""
    return float(np.float32(x))


def pair_rc2(type_i, type_j, r_cut_matrix, dtype):
    """Squared per-pair cutoff from a host ``[ntypes, ntypes]`` matrix
    (the reference's ``rcut()`` matrix): a negative entry (never
    neighbors) gives ``-1``, so ``d2 <= rc2`` is always False; types
    outside the matrix give 0.

    :param type_i, type_j: broadcastable integer (or float-typed) tensors.
    """
    from .cellwise import pair_rc2 as _table_rc2, rc2_table
    table = rc2_table(r_cut_matrix, dtype=dtype, device=type_i.device)
    return _table_rc2(type_i, type_j, table)


def compute_nlist(positions, r_cut, NN, box_size, sorted=False,
                  return_types=False, exclusion_matrix=None,
                  r_cut_matrix=None, device=None):
    """Dense pairwise neighbor list (the reference's O(N^2) build),
    quirks included: unsorted keeps the NN *largest* in-cutoff distances
    on overflow, ``sorted=True`` the nearest NN, ascending. Equal keys
    keep the lower index first, as ``jax.lax.top_k`` does.

    :param positions: ``[N, 4]`` or ``[N, 3]`` positions.
    :param r_cut: cutoff radius.
    :param NN: maximum number of neighbors per particle.
    :param box_size: ``[Lx, Ly, Lz]`` edge lengths, or a full ``[3, 3]``
        box (rows low, high, tilt): the triclinic minimum image then.
    :param sorted: sort each particle's neighbors ascending by distance.
    :param return_types: last channel is the neighbor's type (needs
        ``[N, 4]`` positions) instead of its index.
    :param exclusion_matrix: ``[N, N]`` bool, True = exclude the pair.
    :param r_cut_matrix: per-type-pair ``[ntypes, ntypes]`` cutoffs
        (negative = never neighbors); needs ``[N, 4]`` positions.
    :param device: where the list is built: by default a tensor's own
        device, and the CUDA card for host data (``device="cpu"`` for the
        CPU).
    :return: ``[N, NN, 4]`` neighbor list, on that device.
    """
    positions = torch.as_tensor(
        positions, device=device_for(positions, device, "compute_nlist"))
    rc2_tab = None
    if r_cut_matrix is not None:
        from .cellwise import rc2_table
        rc2_tab = rc2_table(r_cut_matrix, positions.dtype, positions.device)
    return _compute_nlist(positions, r_cut, NN, box_size, sorted,
                          return_types, exclusion_matrix, rc2_tab)


def _compute_nlist(positions, r_cut, NN, box_size, sorted=False,
                   return_types=False, exclusion_matrix=None, rc2_tab=None,
                   rows=None):
    """:func:`compute_nlist` with the typed cutoffs as a ``[T, T]`` device
    table (:func:`.cellwise.rc2_table`), so a caller in the step loop
    makes no host-to-device copy. With ``rows`` (a ``slice``) only those
    query rows' lists, each equal to its row of the whole list (a mesh
    shard's rows)."""
    rows = slice(None) if rows is None else rows
    if return_types and positions.shape[1] == 3:
        raise ValueError(
            'Cannot return type if positions does not have type. '
            'Make sure positions is N x 4')
    if rc2_tab is not None and positions.shape[1] != 4:
        raise ValueError('per-type r_cut needs N x 4 positions (types)')
    box_size = torch.as_tensor(box_size, dtype=positions.dtype,
                               device=positions.device)
    pos3 = positions[:, :3]
    # displacement from i (row) to j (column): r_ij = x_j - x_i
    dist_mat = pos3[None, :, :] - pos3[rows, None, :]
    if box_size.ndim == 2:
        dist_mat = wrap_vector(dist_mat, box_size)
    else:
        box = box_size.reshape(1, 1, 3)
        dist_mat = dist_mat - torch.round(dist_mat / box) * box
    dist = torch.linalg.norm(dist_mat, dim=2)
    mask = (dist <= f32(r_cut)) & (dist >= f32(5e-4))
    if rc2_tab is not None:
        from .cellwise import pair_rc2 as _table_rc2
        types = positions[:, 3]
        rc2 = _table_rc2(types[rows, None], types[None, :], rc2_tab)
        mask = mask & (dist * dist <= rc2)
    if exclusion_matrix is not None:
        nem = ~torch.as_tensor(exclusion_matrix, dtype=torch.bool,
                               device=positions.device)
        mask = mask & nem[rows] & nem.T[rows]
    mask_cast = mask.to(dist.dtype)
    # systems smaller than NN: take everything and zero-pad the columns
    k = min(NN, dist.shape[1])
    if sorted:
        # invalid -> huge distance -> never among the nearest k
        dist_mat_r = dist * mask_cast + (1 - mask_cast) * 1e20
        idx = torch.sort(dist_mat_r, dim=1, stable=True).indices[:, :k]
    else:
        # invalid -> 0 -> drops out of the largest k
        dist_mat_r = dist * mask_cast
        idx = torch.sort(dist_mat_r, dim=1, descending=True,
                         stable=True).indices[:, :k]

    nlist_pos = torch.gather(dist_mat, 1, idx[:, :, None].expand(-1, -1, 3))
    nlist_mask = torch.gather(mask_cast, 1, idx)[:, :, None]
    if return_types:
        last = positions[:, 3][idx][:, :, None].to(nlist_pos.dtype)
    else:
        last = idx[:, :, None].to(nlist_pos.dtype)
    out = torch.cat([nlist_pos, last], dim=-1) * nlist_mask
    if k < NN:
        out = torch.nn.functional.pad(out, (0, 0, 0, NN - k))
    return out


def nlist_from_positions(positions, types, r_cut, NN, box):
    """In-simulation neighbor list: ``[N, NN, 4]`` with the neighbor's
    type in the last channel, nearest first (what the reference plugin
    hands ``SimModel.compute``).

    :param positions: ``[N, 3]`` positions.
    :param types: ``[N]`` integer types.
    :param box: ``[3, 3]`` box.
    """
    pos4 = torch.cat([positions[:, :3],
                      types.to(positions.dtype)[:, None]], dim=-1)
    return compute_nlist(pos4, r_cut, NN, _box_size(box), sorted=True,
                         return_types=True)


class DenseNlist:
    """The ``'n2'`` neighbor mode of a simulation: :func:`compute_nlist`,
    sorted, with neighbor types, and the typed cutoffs as a device table
    made once. Same interface as :class:`.cell_list.CellNlist`; it has no
    plan and never overflows.

    :param rcut_matrix: per-type-pair cutoffs, or ``None``.
    :param dtype: the positions' dtype (the cutoff table's).
    """

    method = "n2"
    plan = None

    def __init__(self, r_cut, NN, device, rcut_matrix=None,
                 dtype=torch.float32):
        from .cellwise import rc2_table
        self.r_cut, self.NN = float(r_cut), int(NN)
        self.rc2_tab = (None if rcut_matrix is None else
                        rc2_table(rcut_matrix, dtype, device))

    def __call__(self, pos4, box_lengths, rows=None):
        """``(nlist [N, NN, 4], None)`` for ``pos4`` in a box of
        ``box_lengths`` (a ``[3]`` tensor on the positions' device, or
        the full ``[3, 3]`` box of a tilted one); with ``rows`` (a
        ``slice``) the lists of those rows only, against every particle.
        The typed cutoffs' table follows ``pos4`` to its device."""
        rc2 = self.rc2_tab
        if rc2 is not None:
            rc2 = rc2.to(pos4.device, non_blocking=True)
        return _compute_nlist(pos4, self.r_cut, self.NN, box_lengths,
                              sorted=True, return_types=True,
                              rc2_tab=rc2, rows=rows), None
