"""MD engine of the PyTorch port: state, integrators, built-in pair
forms, thermodynamic observables and the Simulation."""

from .state import SimState, init_state, lattice_positions
from .integrators import NVE, NVT, NPT, Langevin, Brownian, Minimize
from .simulation import Simulation
from . import pair
from .pair import LennardJones, WCA
from .thermo import (kinetic_energy, temperature, potential_energy, pressure,
                     thermo)

__all__ = [
    "SimState", "init_state", "lattice_positions",
    "NVE", "NVT", "NPT", "Langevin", "Brownian", "Minimize",
    "Simulation", "pair", "LennardJones", "WCA",
    "kinetic_energy", "temperature", "potential_energy", "pressure",
    "thermo",
]
