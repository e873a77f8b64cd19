"""Cell-list configuration (PyTorch port of the ``CellList`` config in
``hoomd_tf_tpu/ops/cell_list.py``).

Only the configuration object is ported in this slice: the cellwise
mode's :class:`.cellwise.Cellwise` extends it. The packed cell-list
neighbor build and its Pallas selection kernel (K3) are still to port
(ROADMAP.md Queue 1 item 18, Queue 2 K3).
"""

__all__ = ["CellList"]


class CellList:
    """Configuration for a cell-based neighbor build.

    :param capacity: max particles per cell (default: estimated by the
        planner).
    :param skin: minimum extra margin over ``r_cut`` on the cell edge.
    """

    def __init__(self, capacity=None, skin=0.0):
        self.capacity = capacity
        self.skin = float(skin)
