"""Model and simulation checkpointing (PyTorch port of
``hoomd_tf_tpu/serialize.py``).

Models serialize as ``(class name, get_config(), weights)``, the weights
as numpy arrays at their own dtype (a float64 model's stay float64), with
a ``custom_objects`` registry of the built-in classes that
:func:`load_model` resolves names through (the reference's Keras
``custom_objects``). A checkpoint holds everything an exact resume needs:
the weights, the optimizers' ``state_dict`` s, the simulation state, the
state of the simulation's ``torch.Generator`` (its bytes) and the
engine's own schedule (the cellwise plan, the slot order the next run
starts from, the repack interval's history), all as numpy arrays, bytes
and plain Python values. A :func:`load_checkpoint` into a simulation set
up as the saved one was then continues bit for bit as the saved one did.
"""

import pickle

import numpy as np
import torch

__all__ = ["save_model", "load_model", "custom_objects",
           "save_checkpoint", "load_checkpoint"]

#: registry used to resolve classes at load time, mirroring the reference's
#: Keras ``custom_objects`` (populated with the built-ins; users add their
#: SimModel subclasses or pass them to :func:`load_model`)
custom_objects = {}


def _register_builtins():
    from .models.layers import RBFExpansion, WCARepulsion, EDSLayer, Dense
    from .models.simmodel import SimModel, MolSimModel
    from .models.pair import PairModel
    from .models.potentials import (LJPotential, TrainableLJ,
                                    NeuralPairPotential)
    for cls in (RBFExpansion, WCARepulsion, EDSLayer, Dense, SimModel,
                MolSimModel, PairModel, LJPotential, TrainableLJ,
                NeuralPairPotential):
        custom_objects.setdefault(cls.__name__, cls)


def _model_config(model):
    """``model.get_config()`` as its class's constructor takes it back: a
    ``MolSimModel``'s config holds its indices 1-indexed and zero-padded
    (the reference's), which the constructor would shift once more, so
    they are stored 0-indexed, unpadded."""
    from .models.simmodel import MolSimModel
    config = model.get_config()
    if isinstance(model, MolSimModel):
        config["mol_indices"] = [[i - 1 for i in m if i > 0]
                                 for m in config["mol_indices"]]
    return config


def save_model(model, path):
    """Serialize a model as (class name, config, weights)."""
    payload = {
        "class_name": type(model).__name__,
        "config": _model_config(model),
        "weights": model.get_weights(),
    }
    with open(path, "wb") as f:
        pickle.dump(payload, f)


def _build(model, inputs):
    """Build a model's lazy variables by one call on ``inputs`` that leaves
    no trace: variables that existed keep their values, new ones hold
    their initial values (as :func:`.interop.build_model`)."""
    from .models.module import StateSnapshot
    from .models.simmodel import SimModel
    snap = StateSnapshot(model)
    if isinstance(model, SimModel):
        model(inputs, training=False)
    else:
        model(inputs)
    snap.restore()


def load_model(path, custom_objects_arg=None, build_inputs=None):
    """Load a model saved with :func:`save_model`.

    :param path: file path.
    :param custom_objects_arg: dict mapping class names to classes (merged
        over the global :data:`custom_objects` registry).
    :param build_inputs: optional model inputs used to materialize lazily
        built variables before restoring weights (needed when the model
        contains :class:`.Dense`/metric layers built on first call).
    """
    _register_builtins()
    registry = dict(custom_objects)
    if custom_objects_arg:
        registry.update(custom_objects_arg)
    with open(path, "rb") as f:
        payload = pickle.load(f)
    cls = registry.get(payload["class_name"])
    if cls is None:
        raise ValueError(
            f"Unknown model class {payload['class_name']!r}; pass it via "
            "custom_objects")
    model = cls.from_config(payload["config"]) if hasattr(
        cls, "from_config") else cls(**payload["config"])
    if build_inputs is not None:
        _build(model, build_inputs)
    model.set_weights(payload["weights"])
    return model


def _to_numpy(obj):
    """Tensors in a nested dict/list/tuple as numpy arrays (copies)."""
    if torch.is_tensor(obj):
        return obj.detach().cpu().numpy().copy()
    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_numpy(v) for v in obj)
    return obj


def _to_torch(obj, device):
    """:func:`_to_numpy` undone: numpy arrays as tensors on ``device``."""
    if isinstance(obj, np.ndarray):
        return torch.as_tensor(obj.copy(), device=device)
    if isinstance(obj, dict):
        return {k: _to_torch(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_torch(v, device) for v in obj)
    return obj


_STATE_TENSORS = ("positions", "velocities", "types", "masses", "box",
                  "forces", "virial")


def _state_record(state):
    rec = {k: _to_numpy(getattr(state, k)) for k in _STATE_TENSORS}
    rec.update(step=int(state.step), tilted=bool(state.tilted),
               thermostat=_to_numpy(dict(state.thermostat or {})))
    return rec


def _load_optimizer(opt, record):
    """``opt.load_state_dict`` of a :func:`_to_numpy` ``state_dict``, its
    tensors made on the CPU: torch moves each to where its parameter and
    the optimizer's options want it."""
    opt.load_state_dict(_to_torch(record, "cpu"))


def save_checkpoint(path, model=None, sim=None, tfc=None, extra=None):
    """Checkpoint everything needed for exact resume: model weights,
    optimizer states, simulation state, its generator's state and the
    engine's schedule. ``extra`` is stored as given."""
    payload = {"extra": extra}
    if model is not None:
        payload["weights"] = model.get_weights()
        opt = getattr(model, "_batch_opt", None)
        if opt is not None:
            payload["model_opt_state"] = _to_numpy(opt.state_dict())
    if tfc is not None and tfc.opt_state is not None:
        payload["tfc_opt_state"] = _to_numpy(tfc.opt_state.state_dict())
    if sim is not None and sim.state is not None:
        payload["sim_state"] = _state_record(sim.state)
        payload["rng_state"] = sim.generator.get_state().numpy().tobytes()
        payload["engine"] = sim._engine_record()
    with open(path, "wb") as f:
        pickle.dump(payload, f)


def load_checkpoint(path, model=None, sim=None, tfc=None):
    """Restore a checkpoint written by :func:`save_checkpoint` into the
    given objects (set up as the saved ones were: the same model class and
    attachment). Returns the ``extra`` payload."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    if model is not None and "weights" in payload:
        model.set_weights(payload["weights"])
        if "model_opt_state" in payload:
            if model._optimizer is None:
                raise ValueError("the checkpoint holds train_on_batch's "
                                 "optimizer state: compile() the model "
                                 "first")
            params = model.trainable_weights()
            opt = model._batch_opt = model._optimizer(params)
            _load_optimizer(opt, payload["model_opt_state"])
    if tfc is not None and "tfc_opt_state" in payload:
        opt = tfc.ensure_opt_state()
        _load_optimizer(opt, payload["tfc_opt_state"])
    if sim is not None and "sim_state" in payload:
        from .md.state import SimState
        rec = payload["sim_state"]
        state = SimState(
            **{k: torch.as_tensor(rec[k].copy(), device=sim.device)
               for k in _STATE_TENSORS},
            step=rec["step"], tilted=rec["tilted"],
            thermostat=_to_torch(rec["thermostat"], sim.device))
        sim.set_state(state)
        sim.generator.set_state(torch.frombuffer(
            bytearray(payload["rng_state"]), dtype=torch.uint8))
        sim._restore_engine(payload["engine"])
    return payload.get("extra")
