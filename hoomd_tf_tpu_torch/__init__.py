"""hoomd_tf_tpu_torch: the PyTorch / CUDA port of ``hoomd_tf_tpu``.

The package mirrors the JAX package's module paths and public names and
imports ``torch`` and numpy only, never JAX. This slice carries the
main path: a :class:`PairModel` attached with ``nlist='cellwise'`` to a
:class:`Simulation` running NVE, NVT or a Minimize quench, with the pair
forces from the hand-written Hopper kernel K1 on a CUDA device; and
online training of a Chebyshev-proxy NN pair potential during live MD
(``attach(train=True)``), whose gradient runs in kernel K2.
"""

from .ops import Cellwise, box_size, wrap_vector
from .models import SimModel, PairModel, Dense
from . import ops
from . import models
from . import md
from .md.simulation import Simulation
from .driver import tfcompute

__all__ = ["Simulation", "tfcompute", "PairModel", "SimModel", "Dense",
           "md", "ops", "models", "Cellwise", "box_size", "wrap_vector"]
