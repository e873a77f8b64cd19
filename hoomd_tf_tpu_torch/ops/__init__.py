"""Tensor operations of the PyTorch port: box math, the cellwise
neighbor machinery (``cellwise``) with its CUDA kernel K1
(``cellwise_cuda``), the Chebyshev pair proxy (``chebyshev``) and the
online-training pair forces (``pair_train``) with their backward kernel
K2 (``pair_train_cuda``)."""

from .box import box_size, wrap_vector, make_box, box_from_lengths
from .cellwise import Cellwise

__all__ = ["box_size", "wrap_vector", "make_box", "box_from_lengths",
           "Cellwise"]
