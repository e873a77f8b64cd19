"""MD engine of the PyTorch port: integrators, built-in pair forms,
state and the Simulation."""

from .integrators import NVE, NVT, Minimize, NPT, Langevin, Brownian
from .pair import LennardJones, WCA

__all__ = ["NVE", "NVT", "Minimize", "NPT", "Langevin", "Brownian",
           "LennardJones", "WCA"]
