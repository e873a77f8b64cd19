"""Internal-coordinate features on molecule-batched or CG positions
(PyTorch port of ``hoomd_tf_tpu/utils/mol_features.py``, the reference's
``utils.py:789-1037``): bond distances, angles and dihedrals, wrapped by
the minimum image, on ``[M, MN, 4]`` molecule-batched positions
(:class:`..models.simmodel.MolSimModel`'s views) or on flat CG
coordinates indexed by bead lists of :func:`.graph.compute_cg_graph`.
"""

import torch

from .._device import device_for
from ..ops.box import wrap_vector

__all__ = ["mol_bond_distance", "mol_angle", "mol_dihedral"]


def _tensor(x, like=None, device=None):
    """``x`` as a tensor: a tensor stays on its device, host data goes to
    ``like``'s device, else to ``device`` (by default the CUDA card)."""
    if torch.is_tensor(x):
        return x
    device = like.device if torch.is_tensor(like) else \
        device_for(x, device, "mol_features")
    dtype = like.dtype if torch.is_tensor(like) else torch.float32
    return torch.as_tensor(x, dtype=dtype, device=device)


def _take(cg_positions, idx, device):
    cg = _tensor(cg_positions, device=device)
    return cg[torch.as_tensor(idx, device=cg.device).long()][..., :3]


def _wrap(v, box):
    return wrap_vector(v, _tensor(box, v))


def mol_bond_distance(mol_positions=None, type_i=None, type_j=None,
                      CG=False, cg_positions=None, b1=None, b2=None,
                      box=None, device=None):
    """Bond distance between two atom slots of each molecule, or between
    CG bead index sets (``CG=True``).

    :param mol_positions: ``[M, MN, 4]`` molecule-batched positions.
    :param type_i, type_j: the two atom slots (columns of the view).
    :param CG: use the flat CG positions and index lists ``b1``, ``b2``.
    :param cg_positions: ``[B, 3+]`` CG coordinates.
    :param box: ``[3, 3]`` box of the minimum image.
    :param device: where host positions go (default the CUDA card;
        tensors stay on their device).
    """
    if not CG:
        if mol_positions is None:
            raise ValueError("mol_positions not found. Call build_mol_rep()")
        mol_positions = _tensor(mol_positions, device=device)
        v_ij = mol_positions[:, type_j, :3] - mol_positions[:, type_i, :3]
        return torch.linalg.norm(_wrap(v_ij, box), dim=-1)
    if cg_positions is None:
        raise ValueError("cg_positions not found")
    u_ij = _take(cg_positions, b2, device) - \
        _take(cg_positions, b1, device)
    return torch.linalg.norm(_wrap(u_ij, box), dim=-1)


def mol_angle(mol_positions=None, type_i=None, type_j=None, type_k=None,
              CG=False, cg_positions=None, b1=None, b2=None, b3=None,
              box=None, device=None):
    """Angle (radians) of three atom slots of each molecule, or of CG
    bead index sets (``CG=True``); the vertex is the middle one."""
    if not CG:
        if mol_positions is None:
            raise ValueError("mol_positions not found. Call build_mol_rep()")
        mol_positions = _tensor(mol_positions, device=device)
        v_ij = mol_positions[:, type_i, :3] - mol_positions[:, type_j, :3]
        v_jk = mol_positions[:, type_k, :3] - mol_positions[:, type_j, :3]
    else:
        if cg_positions is None:
            raise ValueError("cg_positions not found.")
        c1, c2, c3 = (_take(cg_positions, b, device) for b in (b1, b2, b3))
        v_ij = c2 - c1
        v_jk = c3 - c2
    v_ij = _wrap(v_ij, box)
    v_jk = _wrap(v_jk, box)
    cos_a = torch.sum(v_ij * v_jk, dim=-1) / (
        torch.linalg.norm(v_ij, dim=-1) * torch.linalg.norm(v_jk, dim=-1))
    return torch.arccos(torch.clamp(cos_a, -1.0, 1.0))


def mol_dihedral(mol_positions=None, type_i=None, type_j=None, type_k=None,
                 type_l=None, CG=False, cg_positions=None, b1=None, b2=None,
                 b3=None, b4=None, box=None, device=None):
    """Dihedral angle (radians) of four atom slots of each molecule, or
    of CG bead index sets (``CG=True``)."""
    if not CG:
        if mol_positions is None:
            raise ValueError("mol_positions not found. Call build_mol_rep()")
        mol_positions = _tensor(mol_positions, device=device)
        p1, p2, p3, p4 = (mol_positions[:, t, :3]
                          for t in (type_i, type_j, type_k, type_l))
    else:
        if cg_positions is None:
            raise ValueError("cg_positions not found.")
        p1, p2, p3, p4 = (_take(cg_positions, b, device)
                          for b in (b1, b2, b3, b4))
    v_ij = _wrap(p2 - p1, box)
    v_jk = _wrap(p3 - p2, box)
    v_kl = _wrap(p4 - p3, box)
    n1 = torch.linalg.cross(v_ij, v_jk)
    n2 = torch.linalg.cross(v_jk, v_kl)
    n1 = n1 / torch.linalg.norm(n1, dim=-1, keepdim=True)
    n2 = n2 / torch.linalg.norm(n2, dim=-1, keepdim=True)
    cos_d = torch.sum(n1 * n2, dim=-1)
    return torch.arccos(torch.clamp(cos_d, -1.0, 1.0))
