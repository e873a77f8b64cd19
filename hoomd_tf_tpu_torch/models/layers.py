"""Layers of the PyTorch port (``Dense`` and ``RBFExpansion`` from
``hoomd_tf_tpu/models/layers.py``; ``WCARepulsion`` and ``EDSLayer`` are
still to be ported, ROADMAP.md Queue 1 item 4)."""

import numpy as np
import torch

from .module import Layer

__all__ = ["Dense", "RBFExpansion"]

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


class RBFExpansion(Layer):
    r"""SchNet-style Gaussian radial basis expansion (reference
    ``layers.py:7-49``): rank-K distances in, rank K+1 out with a trailing
    ``count`` axis, :math:`\exp(-(d - \mu)^2 / \gamma)` with the
    centers :math:`\mu` evenly spaced on ``[low, high]`` and
    :math:`\gamma` their spacing. Fixed centers, no weights."""

    def __init__(self, low, high, count, name="rbf-layer"):
        super().__init__(name=name)
        self.low = low
        self.high = high
        self.count = int(count)
        # jnp.linspace's float32 arithmetic: low (1 - f) + high f
        f = torch.arange(self.count - 1, dtype=torch.float32) / \
            (self.count - 1)
        lo = torch.tensor(float(low), dtype=torch.float32)
        hi = torch.tensor(float(high), dtype=torch.float32)
        centers = torch.cat([lo * (1.0 - f) + hi * f, hi[None]])
        self.register_buffer("centers", centers, persistent=False)
        self.register_buffer("gap", centers[1] - centers[0],
                             persistent=False)

    def get_config(self):
        return {"low": self.low, "high": self.high, "count": self.count}

    def forward(self, inputs):
        return torch.exp(-(inputs[..., None] - self.centers) ** 2 /
                         self.gap)
