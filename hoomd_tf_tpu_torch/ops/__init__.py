"""Tensor operations of the PyTorch port: box math; the NaN-safe
numerics and autodiff forces of the generic model route (``numerics``,
``forces``); the dense and cell-list neighbor builds (``nlist``,
``cell_list``) with the selection kernel K3 (``nlist_cuda``); the
cellwise neighbor machinery (``cellwise``) with its CUDA kernel K1
(``cellwise_cuda``: pair forms and the generic form); the wide-direct
planes (``direct``), the lane-separability probe of generic models
(``lane_fast``) and the radial distribution function (``rdf``); the Chebyshev pair proxy (``chebyshev``) and the
online-training pair forces (``pair_train``) with their backward kernel
K2 (``pair_train_cuda``)."""

from .box import (box_size, wrap_vector, make_box, box_from_lengths,
                  box_matrix)
from .cellwise import Cellwise, CellwisePlan, plan_cellwise, cellwise_planes
from .cell_list import CellList, cell_list_nlist
from .direct import NlistPlanes, direct_cell_planes
from .forces import compute_nlist_forces, compute_positions_forces
from .nlist import compute_nlist, nlist_from_positions
from .numerics import (divide_no_nan, masked_nlist, multiply_no_nan,
                       nlist_rinv, safe_norm)
from .rdf import compute_rdf

# the JAX package's names (box_matrix, the port's own, is importable but
# not listed)
__all__ = [
    "box_size", "wrap_vector", "make_box", "box_from_lengths",
    "safe_norm", "nlist_rinv", "masked_nlist", "divide_no_nan",
    "multiply_no_nan",
    "compute_nlist_forces", "compute_positions_forces",
    "compute_nlist", "nlist_from_positions",
    "CellList", "cell_list_nlist",
    "NlistPlanes", "direct_cell_planes",
    "Cellwise", "CellwisePlan", "plan_cellwise", "cellwise_planes",
    "compute_rdf",
]
