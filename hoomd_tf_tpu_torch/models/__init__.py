"""Models of the PyTorch port."""

from .simmodel import SimModel
from .pair import PairModel
from .layers import Dense

__all__ = ["SimModel", "PairModel", "Dense"]
