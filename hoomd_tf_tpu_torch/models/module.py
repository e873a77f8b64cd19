"""The module base the port's models stand on (PyTorch port of the parts
of ``hoomd_tf_tpu/models/module.py`` that ``SimModel`` uses).

A :class:`Layer` is an ``nn.Module`` whose weights are created with
:meth:`Layer.add_weight`, as in the JAX package: trainable weights become
``nn.Parameter`` s, the others buffers. :attr:`Layer.variables` lists them
in the JAX package's order (own weights in creation order, then child
layers in the order they were assigned), so a JAX model's
``get_weights()`` list maps onto a port model one to one
(:func:`..interop.load_jax_variables`) once both have built their lazy
layers.
"""

import numpy as np
import torch
from torch import nn

__all__ = ["Layer"]


class Layer(nn.Module):
    """Base class for parameterized computations.

    :param name: layer name.
    :param dtype: default floating dtype of its weights.
    """

    def __init__(self, name=None, dtype=torch.float32):
        super().__init__()
        self.name = name or type(self).__name__.lower()
        self._layer_dtype = dtype
        self._weight_names = []
        #: weight attribute -> constraint (see :meth:`add_weight`)
        self.constraints = {}

    @property
    def dtype(self):
        return self._layer_dtype

    def add_weight(self, shape=(), initializer=None, trainable=True,
                   dtype=None, name=None, constraint=None):
        """Create a weight tensor of ``shape``; ``initializer`` is a
        constant, an array, a callable ``shape -> array`` or ``None``
        (zeros). ``name`` is accepted for JAX API parity. ``constraint``
        (a function of the weight's value), as in the JAX package, is
        what training applies after an optimizer step; it is kept in
        :attr:`constraints` (evaluation reads the weight as it is).
        Returns the registered parameter or buffer."""
        dtype = dtype or self.dtype
        if initializer is None:
            value = torch.zeros(shape, dtype=dtype)
        else:
            init = initializer(shape) if callable(initializer) \
                else initializer
            value = torch.as_tensor(np.asarray(init)).to(dtype).expand(
                shape).clone()
        attr = f"_w{len(self._weight_names)}"
        if trainable:
            self.register_parameter(attr, nn.Parameter(value))
        else:
            self.register_buffer(attr, value)
        self._weight_names.append(attr)
        if constraint is not None:
            self.constraints[attr] = constraint
        return getattr(self, attr)

    @property
    def variables(self):
        """All weights of this layer and its child layers, in the JAX
        package's order."""
        out = [getattr(self, a) for a in self._weight_names]
        for child in self.children():
            if isinstance(child, Layer):
                out.extend(child.variables)
        return out

    @property
    def losses(self):
        """Regularization losses (Keras ``layer.losses``) that
        ``SimModel.compute_loss`` adds to the loss; the port's weights
        carry no regularizers yet, so the list is empty."""
        return []

    def get_weights(self):
        """Copies of :attr:`variables` as numpy arrays (copies: a CPU
        tensor's ``numpy()`` shares its memory, and training updates the
        weights in place)."""
        return [v.detach().cpu().numpy().copy() for v in self.variables]

    def set_weights(self, weights):
        """Copy a list of arrays into :attr:`variables` (shapes checked)."""
        vs = self.variables
        if len(weights) != len(vs):
            raise ValueError(
                f"Expected {len(vs)} weight arrays, got {len(weights)}")
        with torch.no_grad():
            for v, w in zip(vs, weights):
                w = torch.as_tensor(np.array(w))
                if tuple(w.shape) != tuple(v.shape):
                    raise ValueError(f"Shape mismatch: {tuple(w.shape)} vs "
                                     f"{tuple(v.shape)}")
                v.copy_(w.to(v.dtype))
