"""Layers of the PyTorch port (``Dense`` from
``hoomd_tf_tpu/models/layers.py``; the others arrive with slice C)."""

import numpy as np
import torch

from .module import Layer

__all__ = ["Dense"]

# deterministic per-process init stream for layers given no generator
_INIT_GENERATOR = torch.Generator().manual_seed(0)


class Dense(Layer):
    """Fully connected layer ``y = x W + b`` (Keras ``Dense``).

    Weights are built lazily on the first call (the input width is unknown
    until then), on the input's device: a Glorot-uniform kernel drawn from
    ``generator`` (default: the module's own seeded stream), created
    before the zero bias so :attr:`variables` lists them in the JAX
    package's order.

    :param generator: a CPU ``torch.Generator`` for the kernel's draw.
    """

    def __init__(self, units, activation=None, use_bias=True, name="dense",
                 dtype=torch.float32, generator=None):
        super().__init__(name=name, dtype=dtype)
        self.units = int(units)
        self.activation = activation
        self.use_bias = use_bias
        self.generator = generator
        self.kernel = None
        self.bias = None

    def _build(self, in_dim, device):
        limit = float(np.sqrt(6.0 / (in_dim + self.units)))
        gen = self.generator or _INIT_GENERATOR
        k = (torch.rand((in_dim, self.units), generator=gen,
                        dtype=torch.float64) * 2.0 - 1.0) * limit
        self.kernel = self.add_weight((in_dim, self.units),
                                      initializer=k.numpy(),
                                      name=f"{self.name}.kernel")
        if self.use_bias:
            self.bias = self.add_weight((self.units,),
                                        name=f"{self.name}.bias")
        self.to(device)

    def get_config(self):
        return {"units": self.units, "use_bias": self.use_bias,
                "name": self.name}

    def forward(self, x):
        x = x.to(self.dtype)
        if self.kernel is None:
            self._build(x.shape[-1], x.device)
        k = self.kernel
        in_dim, units = k.shape
        if in_dim <= 8 or units <= 8:
            # the JAX layer's form for per-lane MLPs (tiny feature axis):
            # broadcast-multiply and reduce, which also fixes the
            # summation order the parity tests compare
            y = torch.sum(x[..., :, None] * k, dim=-2)
        else:
            y = torch.matmul(x, k)
        if self.use_bias:
            y = y + self.bias
        if self.activation is not None:
            y = self.activation(y)
        return y
