"""Device meshes (PyTorch port of ``hoomd_tf_tpu/parallel/mesh.py``).

The JAX package runs one program over a ``jax.sharding.Mesh`` and lets
XLA place the shards. The port keeps that single-controller form: a
:class:`Mesh` is an ordered tuple of ``torch.device`` s under one axis
name, and the port's sharded paths (``Simulation(mesh=)``,
:mod:`.domain`, :mod:`.shard`) loop over its shards in one process,
each shard's work on its own device. A device may repeat: four shards
on one card are four slabs of work launched on that card, the
counterpart of the JAX tests' virtual CPU devices.
"""

import torch

from .._device import resolve_device

__all__ = ["make_mesh"]


class Mesh:
    """A 1-D mesh: ``devices`` (an ordered tuple of ``torch.device``,
    repeats allowed) along the axis ``axis_names[0]``; ``shape[axis]`` is
    their number, as on a JAX ``Mesh``."""

    def __init__(self, devices, axis="d"):
        # resolved ("cuda" -> "cuda:0"), so device checks compare exactly
        self.devices = tuple(resolve_device(d, "Mesh") for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_names = (axis,)
        self.shape = {axis: len(self.devices)}

    @property
    def size(self):
        return len(self.devices)

    def __repr__(self):
        return (f"Mesh({[str(d) for d in self.devices]}, "
                f"axis={self.axis_names[0]!r})")


def make_mesh(n_devices=None, axis="d", devices=None):
    """A 1-D mesh over (the first ``n_devices``) visible CUDA devices.

    :param n_devices: number of shards (default: every visible card).
    :param axis: mesh axis name (the slab / frame sharding axis).
    :param devices: explicit device list (overrides the visible cards;
        repeats allowed, e.g. ``[torch.device("cpu")] * 8`` for eight
        shards on the CPU, or ``["cuda:0"] * 4`` for four on one card).
        With ``n_devices`` too, its first ``n_devices``.
    :raises RuntimeError: without ``devices`` when no card is visible.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() takes the visible CUDA cards and found none; "
                "pass devices=[torch.device('cpu')] * n for a CPU mesh")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"{n_devices} devices asked for, "
                             f"{len(devices)} given")
        devices = devices[:n_devices]
    return Mesh(devices, axis)
