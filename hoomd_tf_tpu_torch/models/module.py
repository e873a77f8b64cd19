"""The module system the port's models stand on (PyTorch port of
``hoomd_tf_tpu/models/module.py``).

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
each optimizer step. :attr:`Layer.losses` are the weights' regularizer
terms, which ``SimModel.compute_loss`` adds to the loss.

A stateful layer (:class:`Mean`, :class:`MeanTensor`, the EDS layer and
the WCA repulsion of :mod:`.layers`) holds its state in
:class:`Variable` s, read as ``layer.count.value``, as in the JAX
package. :func:`get_state`, :func:`set_state` and
:func:`functional_call` read and write a model's variables as one flat
list.
"""

import copy

import numpy as np
import torch
from torch import nn

__all__ = ["Variable", "Layer", "Mean", "MeanTensor",
           "get_state", "set_state", "functional_call"]


class Variable(nn.Module):
    """A named weight slot (the JAX package's ``Variable``, the analog of
    ``tf.Variable``): ``value`` is an ``nn.Parameter`` when ``trainable``,
    else a buffer. :meth:`assign` writes in place without gradient, as
    ``tf.Variable.assign`` does. A Variable assigned to a
    :class:`Layer`'s attribute is listed in its :attr:`Layer.variables`.

    :param value: the initial value (a number, array or tensor), kept as
        ``initial_value`` (a run that is rolled back returns a variable
        built during it to this value).
    :param constraint: a function of the value training applies after
        each optimizer step.
    :param regularizer: a function of the value whose result
        :attr:`Layer.losses` lists (a training loss term).
    """

    def __init__(self, value, trainable=True, name=None, constraint=None,
                 regularizer=None, dtype=None):
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
        self.register_buffer("initial_value", t.clone(), persistent=False)
        self.trainable = bool(trainable)
        self.name = name
        self.constraint = constraint
        self.regularizer = regularizer

    def assign(self, value):
        """Write ``value`` into the slot in place, with no gradient (the
        JAX package's ``stop_gradient``): no graph of ``value`` outlives
        the call. A Python number is a fill, so no host copy waits on
        the device."""
        with torch.no_grad():
            if isinstance(value, (int, float, bool)):
                self.value.fill_(value)
            else:
                self.value.copy_(torch.as_tensor(
                    value, dtype=self.value.dtype, device=self.value.device))
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
        #: weight attribute -> regularizer (see :meth:`add_weight`)
        self.regularizers = {}

    @property
    def dtype(self):
        return self._layer_dtype

    def add_weight(self, shape=(), initializer=None, trainable=True,
                   constraint=None, regularizer=None, dtype=None, name=None):
        """Create a weight tensor of ``shape``; ``initializer`` is a
        constant, an array, a callable ``shape -> array`` or ``None``
        (zeros). ``name`` is accepted for JAX API parity. ``constraint``
        (a function of the weight's value), as in the JAX package, is
        what training applies after an optimizer step; it is kept in
        :attr:`constraints` (evaluation reads the weight as it is).
        ``regularizer`` (a function of the weight's value) gives the
        weight's term of :attr:`losses`. Returns the registered parameter
        or buffer."""
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
        if regularizer is not None:
            self.regularizers[attr] = regularizer
        return getattr(self, attr)

    @property
    def variables(self):
        """All weights of this layer and its child layers, in the JAX
        package's order."""
        return [v for v, _, _ in self._weight_entries()]

    @property
    def variable_constraints(self):
        """Each weight's constraint, or ``None``, in :attr:`variables`'
        order."""
        return [c for _, c, _ in self._weight_entries()]

    def _weight_entries(self):
        """``(weight, constraint, regularizer)`` of every weight, in
        :attr:`variables`' order."""
        out = [(getattr(self, a), self.constraints.get(a),
                self.regularizers.get(a)) for a in self._weight_names]
        children = list(self.children())
        out.extend((c.value, c.constraint, c.regularizer) for c in children
                   if isinstance(c, Variable))
        for child in children:
            if isinstance(child, Layer):
                out.extend(child._weight_entries())
        return out

    def apply_constraints(self, params=None):
        """Apply each weight's constraint in place, with no gradient (after
        an optimizer step; ``params``: only these weights)."""
        keep = None if params is None else {id(p) for p in params}
        with torch.no_grad():
            for v, c, _ in self._weight_entries():
                if c is not None and (keep is None or id(v) in keep):
                    v.copy_(c(v))

    @property
    def losses(self):
        """Regularization losses (Keras ``layer.losses``): each
        regularized weight's term, which ``SimModel.compute_loss`` adds
        to the loss."""
        return [r(v) for v, _, r in self._weight_entries() if r is not None]

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


# --------------------------------------------------------------------------
# State threading helpers
# --------------------------------------------------------------------------

def get_state(module):
    """Copies of all variable values of ``module`` (a :class:`Layer`), in
    :attr:`Layer.variables`' order: the JAX package's arrays are
    immutable, so later in-place updates of the module leave the list as
    it was read."""
    return [v.detach().clone() for v in module.variables]


def set_state(module, values):
    """Write a flat list of values (from :func:`get_state`) into
    ``module``'s variables, in place and with no gradient (the
    differentiable injection point is :func:`functional_call`)."""
    vs = module.variables
    if len(vs) != len(values):
        raise ValueError(f"Expected {len(vs)} values, got {len(values)}")
    with torch.no_grad():
        for v, val in zip(vs, values):
            v.copy_(torch.as_tensor(val, dtype=v.dtype, device=v.device))


class _Call(nn.Module):
    """``fn`` as the forward of a module whose child is ``module``, so
    that ``torch.func.functional_call`` swaps the child's tensors."""

    def __init__(self, module, fn):
        super().__init__()
        self.m = module
        self.fn = fn

    def forward(self, args, kwargs):
        out = self.fn(*args, **kwargs)
        # the swapped-in tensors, as the call left them
        return out, list(self.m.variables)


def functional_call(module, values, fn, *args, device=None, **kwargs):
    """Run ``fn(*args, **kwargs)`` with ``module``'s variables set to
    ``values``; return ``(output, new_values)``. The module's own tensors
    are swapped for copies of ``values`` for the call only
    (``torch.func.functional_call``), so gradients flow from the output
    and from ``new_values`` (the copies as the call's in-place updates,
    metrics or EDS state, left them) back to ``values``; the module
    keeps its state. With ``device`` the copies are made there (a mesh
    shard's call on its own device), else on each variable's device."""
    vs = module.variables
    if len(vs) != len(values):
        raise ValueError(f"Expected {len(vs)} values, got {len(values)}")
    names = {}
    for name, t in list(module.named_parameters(remove_duplicate=False)) + \
            list(module.named_buffers(remove_duplicate=False)):
        names.setdefault(id(t), "m." + name)
    swap = {names[id(v)]: torch.as_tensor(
                val, dtype=v.dtype,
                device=v.device if device is None else device).clone()
            for v, val in zip(vs, values)}
    return torch.func.functional_call(_Call(module, fn), swap,
                                      (args, kwargs))


class StateSnapshot:
    """Device copies of every variable of ``model`` (and, when given, an
    optimizer's state), which :meth:`restore` writes back: what a
    simulation run that is rolled back, and a model call that must leave
    no trace (a build, a probe), restore. A :class:`Variable` built
    during the interval goes back to its ``initial_value``. Taking one
    costs a device copy of the variables and reads nothing back."""

    def __init__(self, model, opt=None):
        self.model, self.opt = model, opt
        self.values = [(v, v.detach().clone()) for v in model.variables]
        self.opt_state = (None if opt is None else
                          copy.deepcopy(opt.state_dict()))

    def restore(self):
        kept = {id(v) for v, _ in self.values}
        with torch.no_grad():
            for v, w in self.values:
                v.copy_(w)
            for m in self.model.modules():
                if isinstance(m, Variable) and id(m.value) not in kept:
                    m.value.copy_(m.initial_value)
        if self.opt is not None:
            self.opt.load_state_dict(copy.deepcopy(self.opt_state))


# --------------------------------------------------------------------------
# Running metrics (Keras tf.keras.metrics.{Mean, MeanTensor} equivalents)
# --------------------------------------------------------------------------

class Mean(Layer):
    """Running scalar mean, like ``tf.keras.metrics.Mean``: ``total`` and
    ``count`` are :class:`Variable` s (``mean.count.value``). Updates are
    device operations with no gradient, so a model that updates it in its
    ``compute`` adds no host sync to the step loop."""

    def __init__(self, name="mean", dtype=torch.float32):
        super().__init__(name=name, dtype=dtype)
        self.total = Variable(0.0, trainable=False, name=f"{name}.total",
                              dtype=dtype)
        self.count = Variable(0.0, trainable=False, name=f"{name}.count",
                              dtype=dtype)

    def update_state(self, values):
        values = torch.as_tensor(values).to(self.dtype)
        self.total.assign_add(torch.sum(values))
        self.count.assign_add(float(values.numel()))
        return self

    def result(self):
        from ..ops.numerics import divide_no_nan
        return divide_no_nan(self.total.value, self.count.value)

    def reset_state(self):
        self.total.assign(0.0)
        self.count.assign(0.0)

    def forward(self, values):
        return self.update_state(values)


class MeanTensor(Layer):
    """Elementwise running mean of a fixed-shape tensor, like
    ``tf.keras.metrics.MeanTensor``. ``total`` and ``count`` are built on
    the first update, with its shape and device."""

    def __init__(self, name="mean_tensor", dtype=torch.float32):
        super().__init__(name=name, dtype=dtype)
        self.total = None
        self.count = None

    def _build(self, shape, device):
        zeros = torch.zeros(shape, dtype=self.dtype, device=device)
        self.total = Variable(zeros, trainable=False, dtype=self.dtype,
                              name=f"{self.name}.total")
        self.count = Variable(zeros, trainable=False, dtype=self.dtype,
                              name=f"{self.name}.count")

    def update_state(self, values):
        values = torch.as_tensor(values).to(self.dtype)
        if self.total is None:
            self._build(values.shape, values.device)
        self.total.assign_add(values)
        self.count.assign_add(torch.ones_like(values))
        return self

    def result(self):
        from ..ops.numerics import divide_no_nan
        return divide_no_nan(self.total.value, self.count.value)

    def reset_state(self):
        if self.total is not None:
            self.total.assign(0.0)
            self.count.assign(0.0)

    def forward(self, values):
        return self.update_state(values)
