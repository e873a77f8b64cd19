"""Tensor operations of the PyTorch port: box math and the cellwise
neighbor machinery (``cellwise``) with its CUDA kernel
(``cellwise_cuda``)."""

from .box import box_size, wrap_vector, make_box, box_from_lengths
from .cellwise import Cellwise

__all__ = ["box_size", "wrap_vector", "make_box", "box_from_lengths",
           "Cellwise"]
