"""Data-parallel training over a device mesh (PyTorch port of
``hoomd_tf_tpu/parallel/shard.py``).

The particle dimension is split by the engine (``Simulation(mesh=...)``,
:class:`.sharded_simulation.ShardedSimulation`). What lives here is the
other parallel axis: data parallelism over trajectory frames for
offline force-matching (reference examples 06/08). Frames are split over
the mesh's shards; each shard runs the model's standard call on its
frames on its device; the gradients are averaged on the first device
before one optimizer step, which keeps the one set of weights.
"""

import torch

from .._device import to_device
from ..models.module import functional_call, get_state

__all__ = ["data_parallel_grads", "sharded_train_step"]


def data_parallel_grads(grads_per_shard, axis="d"):
    """The sum over shards of per-shard gradients (JAX's ``psum`` over
    the mesh axis), on the first shard's device.

    :param grads_per_shard: one list of gradient tensors per shard (each
        on its shard's device).
    :param axis: the mesh axis (kept for the JAX signature).
    :returns: the list of summed tensors.
    """
    shards = list(grads_per_shard)
    if not shards:
        raise ValueError("no shards' gradients to sum")
    dev = [g.device for g in shards[0]]
    out = [g.clone() for g in shards[0]]
    for grads in shards[1:]:
        out = [o + to_device(g, d)
               for o, g, d in zip(out, grads, dev)]
    return out


def sharded_train_step(model, optimizer, mesh, axis="d"):
    """A force-matching training step with trajectory frames split over
    the mesh.

    Each shard evaluates the model's standard call on its frames (the
    route every single-device path uses) on its device, with the model's
    variables copied there through :func:`..models.module.functional_call`,
    and takes the mean-squared error against the frames' label forces and
    its gradients; the gradients are averaged over the shards on the first
    device (JAX's ``pmean``) and written to the trainable weights'
    ``.grad``, then ``optimizer`` takes one step.

    Where it differs from the JAX package's functional signature
    (``step(params, aux_values, opt_state, ...) -> (loss, params,
    opt_state)`` with an optax transformation): the weights are the
    model's own, updated in place by a ``torch.optim`` optimizer built
    over them (the port's ``compile`` does the same), and the step returns
    the loss alone. As in the JAX step, the weights' constraints are not
    applied: the update is the optimizer's, unconstrained (unlike
    ``train_on_batch``, which constrains).

    :param model: a built :class:`..models.simmodel.SimModel`.
    :param optimizer: a ``torch.optim`` optimizer over the model's
        trainable weights (``model.trainable_weights()``).
    :param mesh: the device mesh.
    :param axis: mesh axis name carrying the frame batch.
    :returns: ``step(nlist_b, pos4_b, box, labels_b) -> loss`` (a 0-d
        tensor on the first device), ``nlist_b`` ``[B, N, NN, 4]``,
        ``pos4_b`` ``[B, N, 4]``, ``labels_b`` ``[B, N, >=3]``, ``B``
        divisible by the mesh size.
    """
    devices = mesh.devices
    S = mesh.shape[axis]
    variables = model.variables
    trainable = [i for i, v in enumerate(variables)
                 if isinstance(v, torch.nn.Parameter) and v.requires_grad]

    def shard_loss(values, nl_s, p4_s, box, lab_s):
        frames = []
        for nl, p4, lab in zip(nl_s, p4_s, lab_s):
            (out, *_), _ = functional_call(
                model, values,
                lambda a, b, c: model([a, b, c], training=True),
                nl, p4, box, device=nl.device)
            frames.append(torch.mean((out[:, :3] - lab[:, :3]) ** 2))
        return torch.stack(frames).mean()

    def step(nlist_b, pos4_b, box, labels_b):
        B = nlist_b.shape[0]
        if B % S:
            raise ValueError(f"{B} frames are not divisible by the "
                             f"{S}-shard mesh")
        per = B // S
        base = get_state(model)
        losses, grads = [], []
        for s in range(S):
            dev = devices[s]
            sl = slice(s * per, (s + 1) * per)
            values = [v.to(dev) for v in base]
            for i in trainable:
                values[i] = values[i].detach().requires_grad_(True)
            with torch.enable_grad():
                loss = shard_loss(
                    values, to_device(nlist_b[sl], dev),
                    to_device(pos4_b[sl], dev), to_device(box, dev),
                    to_device(labels_b[sl], dev))
                g = torch.autograd.grad(loss, [values[i] for i in trainable])
            losses.append(loss.detach())
            grads.append(list(g))
        mean = [t / S for t in data_parallel_grads(grads, axis)]
        first = devices[0]
        for i, g in zip(trainable, mean):
            v = variables[i]
            v.grad = g.to(v.device, dtype=v.dtype)
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return torch.stack([l.to(first) for l in losses]).mean()

    return step
