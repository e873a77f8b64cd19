"""Models of the PyTorch port."""

from .simmodel import SimModel
from .pair import PairModel

__all__ = ["SimModel", "PairModel"]
