"""Models of the PyTorch port."""

from .module import (Variable, Layer, Mean, MeanTensor, get_state, set_state,
                     functional_call)
from .simmodel import SimModel, MolSimModel
from .pair import PairModel
from .layers import RBFExpansion, WCARepulsion, EDSLayer, Dense
from .potentials import LJPotential, TrainableLJ, NeuralPairPotential

__all__ = [
    "Variable", "Layer", "Mean", "MeanTensor", "get_state", "set_state",
    "functional_call",
    "SimModel", "MolSimModel", "PairModel",
    "RBFExpansion", "WCARepulsion", "EDSLayer", "Dense",
    "LJPotential", "TrainableLJ", "NeuralPairPotential",
]
