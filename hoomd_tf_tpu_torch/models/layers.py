"""Layers of the PyTorch port (PyTorch port of
``hoomd_tf_tpu/models/layers.py``): ``Dense``, ``RBFExpansion``, the
trainable ``WCARepulsion`` and the experiment-directed-simulation
``EDSLayer``."""

import numpy as np
import torch

from .module import Layer, Variable
from ..ops.direct import NlistPlanes
from ..ops.numerics import divide_no_nan, nlist_rinv

__all__ = ["Dense", "RBFExpansion", "WCARepulsion", "EDSLayer"]

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


class WCARepulsion(Layer):
    r"""Trainable Weeks-Chandler-Anderson repulsion (reference
    ``layers.py:52-98``): the per-pair energy ``[N, NN]``

    .. math::
        U(r) = (\sigma/r)^6 \;\; \text{for } r < 2^{1/3}\sigma,\;
        \text{else } 0,

    clipped to ``[0, 10]``, with a trainable :math:`\sigma`
    (``self.sigma``, a :class:`.module.Variable`) whose regularizer
    ``-regularization_strength * sigma`` pushes it toward larger
    distances. The cut is :math:`2^{1/3}\sigma`, the JAX package's and
    the reference's, not the physical :math:`2^{1/6}\sigma` of the
    built-in ``md.WCA``.
    """

    def __init__(self, sigma, regularization_strength=1e-3,
                 name="wca-repulsion"):
        super().__init__(name=name)
        self.sigma = Variable(float(sigma), name="sigma",
                              regularizer=lambda x: -regularization_strength
                              * x)

    def get_config(self):
        return {"sigma": float(self.sigma.value)}

    def forward(self, nlist):
        rinv = nlist_rinv(nlist)
        true_sig = self.sigma.value
        rp = (true_sig * rinv) ** 6
        if isinstance(nlist, NlistPlanes):
            r = torch.sqrt(nlist.r2())
        else:
            r = torch.linalg.norm(nlist[..., :3], dim=-1)
        r_pair_energy = (r < true_sig * 2 ** (1 / 3)).to(rp.dtype) * rp
        return torch.clamp(r_pair_energy, 0.0, 10.0)


class EDSLayer(Layer):
    r"""Experiment-directed-simulation coupling constant (reference
    ``layers.py:101-195``).

    Called on a collective variable at each model call: keeps Welford
    running statistics of the CV and, every ``period`` calls, takes a
    v1-Adam step on the coupling :math:`\alpha` so that the biased
    simulation's mean CV moves to ``set_point``. Returns :math:`\alpha`
    (``self.alpha.value``).

    The state (``mean``, ``ssd``, the int32 call counter ``n``,
    ``alpha``, ``adam_m``, ``adam_v``, the int32 ``adam_t``) is built on
    the first call, with the CV's shape and device, as
    :class:`.module.Variable` s. Every update is a mask applied on the
    device (a select, as the JAX package's compiled step makes of its
    masks), never a branch, so the step loop reads nothing back.
    """

    def __init__(self, set_point, period, learning_rate=1e-2, cv_scale=1.0,
                 name="eds-layer", beta1=0.9, beta2=0.999, epsilon=1e-8,
                 dtype=torch.float32):
        sp = set_point.detach() if torch.is_tensor(set_point) else \
            torch.as_tensor(np.asarray(set_point))
        if not sp.is_floating_point():
            raise ValueError("EDS only works with floats, not dtype " +
                             str(sp.dtype).replace("torch.", ""))
        if not torch.is_tensor(set_point):
            # the JAX package's default float width
            sp = sp.to(torch.float32)
        super().__init__(name=name, dtype=sp.dtype)
        self.register_buffer("set_point", sp.clone(), persistent=False)
        self.period = int(period)
        self.cv_scale = cv_scale
        self.learning_rate = learning_rate
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self._stats_built = False

    def get_config(self):
        return {"set_point": self.set_point.cpu().numpy().tolist(),
                "period": self.period, "cv_scale": self.cv_scale,
                "learning_rate": self.learning_rate, "name": self.name}

    def _build(self, shape, device):
        def var(name, dtype=self.dtype, trainable=False, shape=shape):
            return Variable(torch.zeros(shape, dtype=dtype, device=device),
                            trainable=trainable, dtype=dtype, name=name)
        self.mean = var("mean")
        self.ssd = var("ssd")
        self.n = var("n", torch.int32)
        self.alpha = var("alpha", trainable=True)
        # internal Adam state (tf.compat.v1 AdamOptimizer semantics)
        self.adam_m = var("adam_m")
        self.adam_v = var("adam_v")
        self.adam_t = var("adam_t", torch.int32, shape=())
        self._stats_built = True

    def _adam_step(self, grad, apply_mask):
        """Masked v1-Adam update on alpha: the state advances only where
        ``apply_mask`` (the every-``period``-calls condition) holds."""
        b1, b2, eps = self.beta1, self.beta2, self.epsilon
        t = self.adam_t.value + torch.any(apply_mask).to(torch.int32)
        m = b1 * self.adam_m.value + (1 - b1) * grad
        v = b2 * self.adam_v.value + (1 - b2) * grad ** 2
        tf_ = t.to(self.dtype)
        lr_t = self.learning_rate * torch.sqrt(1 - b2 ** tf_) / \
            (1 - b1 ** tf_)
        new_alpha = self.alpha.value - lr_t * m / (torch.sqrt(v) + eps)
        self.adam_t.assign(t)
        self.adam_m.assign(torch.where(apply_mask, m, self.adam_m.value))
        self.adam_v.assign(torch.where(apply_mask, v, self.adam_v.value))
        self.alpha.assign(torch.where(apply_mask, new_alpha,
                                      self.alpha.value))

    def forward(self, cv):
        cv = torch.as_tensor(cv).to(self.dtype)
        if not self._stats_built:
            self._build(cv.shape, cv.device)
        half = self.period // 2
        n = self.n.value
        zero = torch.zeros((), dtype=self.dtype, device=cv.device)
        reset = n != 0
        self.mean.assign(torch.where(reset, self.mean.value, zero))
        self.ssd.assign(torch.where(reset, self.ssd.value, zero))

        delta = torch.where(n > half, cv - self.mean.value, zero)
        self.mean.assign_add(divide_no_nan(delta, (n - half).to(self.dtype)))
        self.ssd.assign_add(delta * (cv - self.mean.value))

        apply_mask = n == self.period - 1
        gradient = torch.where(
            apply_mask, -2.0 * (self.mean.value - self.set_point) *
            self.ssd.value / self.period / 2 / self.cv_scale, zero)
        self._adam_step(gradient, apply_mask)
        self.n.assign((n + 1) % self.period)
        return self.alpha.value
