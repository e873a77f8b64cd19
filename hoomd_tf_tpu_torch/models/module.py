"""The module base the port's models stand on (PyTorch port of the parts
of ``hoomd_tf_tpu/models/module.py`` that ``SimModel`` uses).

A :class:`Layer` is an ``nn.Module`` whose weights are created with
:meth:`Layer.add_weight`, as in the JAX package: trainable weights become
``nn.Parameter`` s, the others buffers. A :class:`Variable` assigned to a
layer's attribute is a weight too. :attr:`Layer.variables` lists them in
the JAX package's order (own weights in creation order, then the
attribute Variables, then child layers in the order they were assigned),
so a JAX model's ``get_weights()`` list maps onto a port model one to one
(:func:`..interop.load_jax_variables`) once both have built their lazy
layers. :attr:`Layer.variable_constraints` lists each weight's
constraint (or ``None``) in the same order; training applies them after
each optimizer step.
"""

import numpy as np
import torch
from torch import nn

__all__ = ["Variable", "Layer"]


class Variable(nn.Module):
    """A named weight slot (the JAX package's ``Variable``, the analog of
    ``tf.Variable``): ``value`` is an ``nn.Parameter`` when ``trainable``,
    else a buffer. :meth:`assign` writes in place without gradient, as
    ``tf.Variable.assign`` does. A Variable assigned to a
    :class:`Layer`'s attribute is listed in its :attr:`Layer.variables`.

    :param value: the initial value (a number, array or tensor).
    :param constraint: a function of the value training applies after
        each optimizer step.
    """

    def __init__(self, value, trainable=True, name=None, constraint=None,
                 dtype=None):
        super().__init__()
        t = torch.as_tensor(np.asarray(value) if not torch.is_tensor(value)
                            else value.detach())
        if dtype is not None:
            t = t.to(dtype)
        elif t.is_floating_point():
            t = t.to(torch.float32)
        t = t.clone()
        if trainable:
            self.value = nn.Parameter(t)
        else:
            self.register_buffer("value", t)
        self.trainable = bool(trainable)
        self.name = name
        self.constraint = constraint

    def assign(self, value):
        """Write ``value`` into the slot in place, with no gradient."""
        with torch.no_grad():
            self.value.copy_(torch.as_tensor(value, dtype=self.value.dtype,
                                             device=self.value.device))
        return self

    def assign_add(self, value):
        return self.assign(self.value + value)

    def assign_sub(self, value):
        return self.assign(self.value - value)

    def numpy(self):
        return self.value.detach().cpu().numpy().copy()

    @property
    def shape(self):
        return self.value.shape

    @property
    def dtype(self):
        return self.value.dtype

    def __repr__(self):
        return (f"Variable(name={self.name!r}, shape={tuple(self.shape)}, "
                f"dtype={self.dtype}, trainable={self.trainable})")

    # arithmetic, so that `self.eps * x` reads the value
    def __mul__(self, o):
        return self.value * o

    def __rmul__(self, o):
        return o * self.value

    def __add__(self, o):
        return self.value + o

    def __radd__(self, o):
        return o + self.value

    def __sub__(self, o):
        return self.value - o

    def __rsub__(self, o):
        return o - self.value

    def __truediv__(self, o):
        return self.value / o

    def __rtruediv__(self, o):
        return o / self.value

    def __pow__(self, o):
        return self.value ** o

    def __neg__(self):
        return -self.value


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
        return [v for v, _ in self._weights_and_constraints()]

    @property
    def variable_constraints(self):
        """Each weight's constraint, or ``None``, in :attr:`variables`'
        order."""
        return [c for _, c in self._weights_and_constraints()]

    def _weights_and_constraints(self):
        out = [(getattr(self, a), self.constraints.get(a))
               for a in self._weight_names]
        children = list(self.children())
        out.extend((c.value, c.constraint) for c in children
                   if isinstance(c, Variable))
        for child in children:
            if isinstance(child, Layer):
                out.extend(child._weights_and_constraints())
        return out

    def apply_constraints(self, params=None):
        """Apply each weight's constraint in place, with no gradient (after
        an optimizer step; ``params``: only these weights)."""
        keep = None if params is None else {id(p) for p in params}
        with torch.no_grad():
            for v, c in self._weights_and_constraints():
                if c is not None and (keep is None or id(v) in keep):
                    v.copy_(c(v))

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
