"""MD engine of the PyTorch port: integrators, built-in pair forms,
state and the Simulation."""

from .integrators import NVE, NVT, Minimize
from .pair import LennardJones, WCA

__all__ = ["NVE", "NVT", "Minimize", "LennardJones", "WCA"]
