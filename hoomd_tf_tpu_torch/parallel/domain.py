"""Spatial domain decomposition with an explicit ring halo exchange
(PyTorch port of ``hoomd_tf_tpu/parallel/domain.py``).

The box is split into slabs along x, one per mesh shard; each shard
sends the particles within ``r_cut`` of its slab faces to its ring
neighbors (two hops, +1 and -1: the JAX package's ``ppermute``, here a
copy to the neighbor's device), then builds dense neighbor rows for its
own particles against [own + left halo + right halo] and runs the model
on them on its device. Traffic per shard is O(halo), not O(N).

As in the JAX package this is a reference implementation, not wired
into any front end: the engine's sharded path is ``Simulation(mesh=)``
(K1's group launch, ``ops/cellwise.py::analytic_pair_forces``). It stays as
an independent oracle of a sharded force evaluation.

Fixed shapes: halo buffers have a fixed capacity and particles are
assigned to slabs when the input is laid out; a face with more boundary
particles than the capacity sets the returned overflow flag.
"""

import numpy as np
import torch

from .._device import to_device
from ..models.module import functional_call, get_state, set_state

__all__ = ["domain_decompose", "halo_force_fn"]


def domain_decompose(positions4, box, n_domains, r_cut=None):
    """Host-side set-up: assign particles to x-slabs.

    :param positions4: ``[N, >=3]`` positions (numpy or a tensor).
    :param box: the ``[3, 3]`` box (rows low, high, tilt).
    :param r_cut: if given, check that slabs are at least ``r_cut`` wide
        (the ring halo reaches one neighbor slab only).
    :return: ``(perm, counts)`` -- a permutation sorting particles by slab
        and per-slab counts. Pad to equal per-slab size before the call
        (NaN coordinates make pad rows distance-invalid everywhere; a
        finite far coordinate would wrap back into the box).
    """
    pos = np.asarray(positions4.detach().cpu() if torch.is_tensor(positions4)
                     else positions4)
    box = np.asarray(box.detach().cpu() if torch.is_tensor(box) else box)
    lengths = box[1, :] - box[0, :]
    if r_cut is not None and lengths[0] / n_domains < r_cut:
        raise ValueError(
            f"slab width {lengths[0] / n_domains:.3f} < r_cut {r_cut}: "
            "the ring halo exchange only reaches adjacent slabs; use "
            "fewer domains or the all-gather strategy")
    lo = -lengths[0] / 2
    frac = (pos[:, 0] - lo) / lengths[0]
    frac = frac - np.floor(frac)
    slab = np.minimum((frac * n_domains).astype(np.int64), n_domains - 1)
    perm = np.argsort(slab, kind="stable")
    counts = np.bincount(slab, minlength=n_domains)
    return perm, counts


def _two_set_rows(q3, qt, s3, st, r_cut, NN, lengths):
    """Neighbor rows ``[M, NN, 4]`` of queries against sources (dense, on
    the queries' device): the nearest ``NN`` within ``r_cut``, by
    ``torch.topk``. NaN-coordinate sources (padding) are distance-invalid;
    the masking is where-based, so a NaN never leaks through a multiply."""
    disp = s3[None, :, :] - q3[:, None, :]
    box = lengths.reshape(1, 1, 3).to(disp.dtype)
    disp = disp - torch.round(disp / box) * box
    dist = torch.linalg.norm(disp, dim=2)
    mask = (dist <= r_cut) & (dist >= 5e-4)
    dist_masked = torch.where(mask, dist, torch.full_like(dist, 1e20))
    idx = torch.topk(dist_masked, NN, dim=1, largest=False).indices
    nl_pos = torch.gather(disp, 1, idx[:, :, None].expand(-1, -1, 3))
    nl_mask = torch.gather(mask, 1, idx)[:, :, None]
    nl_type = st[idx][:, :, None].to(nl_pos.dtype)
    vals = torch.cat([nl_pos, nl_type], dim=-1)
    return torch.where(nl_mask, vals, torch.zeros_like(vals))


def _call_model(model, values, args, device):
    """The model on ``args`` with its variables set to ``values``:
    ``(outputs, new values)``. On the model's own device through
    :func:`..models.module.get_state` / ``set_state`` (restored after);
    on another, through ``functional_call`` with the values copied
    there."""
    variables = model.variables
    home = variables[0].device if variables else device
    if torch.device(device) == home:
        old = get_state(model)
        set_state(model, list(values))
        try:
            out = model(list(args))
            return out, get_state(model)
        finally:
            set_state(model, old)
    return functional_call(model, list(values),
                           lambda a, b, c: model([a, b, c]), *args,
                           device=device)


def halo_force_fn(model, r_cut, mesh, halo_capacity, axis="d"):
    """Particle-sharded force evaluation with a ring halo exchange.

    :param model: a built :class:`..models.simmodel.SimModel`.
    :param r_cut: cutoff radius (also the halo width).
    :param mesh: 1-D mesh (:func:`.mesh.make_mesh`); the box is split into
        x-slabs, one per shard.
    :param halo_capacity: most boundary particles per face per shard
        (fixed; overflow is flagged).
    :return: ``fn(values, positions4, box) -> (forces [N, 4], overflow,
        new_values)`` with ``positions4`` slab-sorted and padded to equal
        per-shard counts (:func:`domain_decompose`), shard ``s``'s rows
        the ``s``-th block; ``values`` the model's variable values
        (:func:`..models.module.get_state`). ``forces`` and the 0-d bool
        ``overflow`` (any face of any shard over capacity) lie on the
        positions' device; ``new_values`` are the first shard's.
    """
    NN = max(1, model.nneighbor_cutoff)
    devices = mesh.devices
    n_dev = mesh.shape[axis]

    def fn(values, positions4, box):
        rows = positions4.shape[0]
        if rows % n_dev:
            raise ValueError(f"{rows} rows are not divisible by the "
                             f"{n_dev}-shard mesh")
        m = rows // n_dev
        home = positions4.device
        lengths = box[1] - box[0]
        slab_w = lengths[0] / n_dev
        shards, his, los, flows = [], [], [], []
        for s in range(n_dev):
            dev = devices[s]
            pos = to_device(positions4[s * m:(s + 1) * m], dev)
            bx = to_device(box, dev)
            slab_lo = bx[0, 0] + s * slab_w.to(dev)
            slab_hi = slab_lo + slab_w.to(dev)
            x = pos[:, 0]
            bufs = []
            for near in ((x - slab_lo) <= r_cut, (slab_hi - x) <= r_cut):
                # pack up to halo_capacity boundary particles in index
                # order; row halo_capacity takes the rest and is cut off;
                # far-sentinel padding is distance-invalid
                cnt = torch.cumsum(near.to(torch.int64), 0) - 1
                slot = torch.where(near & (cnt < halo_capacity), cnt,
                                   torch.full_like(cnt, halo_capacity))
                buf = torch.full((halo_capacity + 1, 4), 1e30,
                                 dtype=pos.dtype, device=dev)
                buf = buf.index_copy(0, slot, pos)
                bufs.append(buf[:halo_capacity])
                flows.append((near.sum() > halo_capacity).to(home))
            los.append(bufs[0])
            his.append(bufs[1])
            shards.append((pos, bx, dev))
        forces, new_values = [], None
        for s, (pos, bx, dev) in enumerate(shards):
            # the ring: the left neighbor's high face, the right one's low
            from_left = to_device(his[(s - 1) % n_dev], dev)
            from_right = to_device(los[(s + 1) % n_dev], dev)
            sources = torch.cat([pos, from_left, from_right])
            nlist = _two_set_rows(pos[:, :3], pos[:, 3], sources[:, :3],
                                  sources[:, 3], r_cut, NN, bx[1] - bx[0])
            out, new = _call_model(model, values, (nlist, pos, bx), dev)
            f = out[0].detach()
            if f.shape[-1] == 3:
                f = torch.cat([f, torch.zeros_like(f[:, :1])], dim=-1)
            forces.append(to_device(f, home))
            if new_values is None:
                new_values = tuple(v.detach().to(home) for v in new)
        overflow = torch.stack(flows).any()
        return torch.cat(forces), overflow, new_values

    return fn
