"""Models of the PyTorch port."""

from .module import Variable
from .simmodel import SimModel
from .pair import PairModel
from .layers import Dense, RBFExpansion
from .potentials import LJPotential, TrainableLJ, NeuralPairPotential

__all__ = ["Variable", "SimModel", "PairModel", "Dense", "RBFExpansion",
           "LJPotential", "TrainableLJ", "NeuralPairPotential"]
