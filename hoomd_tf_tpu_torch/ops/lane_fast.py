"""Lane-separable route for generic :class:`..models.simmodel.SimModel` s
on the cellwise mode (PyTorch port of ``hoomd_tf_tpu/ops/lane_fast.py``).

The analytic route (:func:`.cellwise.analytic_pair_forces`) needs a per-
lane pair function ``U(r2, ti, tj) -> (U, dU/dr2)``. A :class:`..models.
pair.PairModel` declares one; a generic model is an opaque ``compute``
whose energy may or may not be a sum of independent per-lane terms. The
engine probes for that structure:

1. **Synthesis** (:func:`synthesize_pair_fn`): the model runs on
   single-lane planes: row ``m`` holds the displacement ``(r_m, 0, 0)``
   to a neighbor of type ``tj_m``, its own type ``ti_m`` and position
   the origin. For a lane-separable model the energy column is the lane
   energy ``g(r2)`` and the x force is ``4 r g'(r2)``, so one call gives
   ``(U, dU) = (2 g, 2 g')`` (the PairModel convention of a full pair
   energy per lane).
2. **Validation** (:func:`validate_pair_fn`): the candidate is trusted
   only once its analytic forces match the model's own planes-route
   forces on the current state. Cross-lane coupling, terms in the
   positions, or anisotropic use of the components show as a mismatch
   and keep the planes route.

A model whose output has no energy column (forces ``[:, :3]``) gets a
zero synthesized energy, and validation judges the common columns.

One deviation from the JAX package's rule: rows holding a lane whose
``d2`` lies within a relative 1e-5 of the cut are left out of the
comparison (:func:`near_cut_rows`). The planes route rounds ``d2`` from
minimum-imaged absolute positions, the analytic route from cell-relative
coordinates, so such a lane can fall inside the cut in one and outside in
the other; for a potential whose force does not vanish at the cut (a
neural pair potential) that one lane moves its two rows' forces by the
pair force. A coupling that is not a sum over lanes shows in every row.
"""

import dataclasses

import numpy as np
import torch

from .direct import NlistPlanes

__all__ = ["synthesize_pair_fn", "validate_pair_fn", "planes_forces",
           "near_cut_rows", "route_errors"]


def synthesize_pair_fn(model, box, differentiable=False):
    """An ``analytic_pair_forces`` pair function from a generic model's
    ``compute`` (see the module docstring).

    :param box: the ``[3, 3]`` box the model is handed.
    :param differentiable: keep ``(U, dU/dr2)`` differentiable in the
        model's weights (training: the model's force gradient keeps its
        graph), while the model still sees ``training=False``, as in the
        JAX package.
    :returns: ``pair_fn(r2, ti, tj) -> (U, dU/dr2)``, ``U`` the full
        per-pair energy.
    """

    def pair_fn(r2, ti, tj):
        shape, dtype = r2.shape, r2.dtype
        r2f = r2.reshape(-1)
        r = torch.sqrt(r2f)
        m = r.shape[0]
        tif = torch.broadcast_to(ti, shape).reshape(-1).to(dtype)
        tjf = torch.broadcast_to(tj, shape).reshape(-1).to(dtype)
        z = torch.zeros((m, 1), dtype=dtype, device=r2.device)
        planes = NlistPlanes(dx=r[:, None], dy=z, dz=z, type=tjf[:, None])
        pos4 = torch.cat([torch.zeros((m, 3), dtype=dtype,
                                      device=r2.device), tif[:, None]], 1)
        # (the box on the lanes' device: a mesh shard's may be another)
        f4 = model([planes, pos4, box.to(r2.device)], training=False,
                   keep_graph=differentiable)[0]
        if not differentiable:
            f4 = f4.detach()
        if f4.shape[1] >= 4:
            U = (2.0 * f4[:, 3]).to(dtype)
        else:
            U = torch.zeros((m,), dtype=dtype, device=r2.device)
        dU = (f4[:, 0] / (2.0 * r)).to(dtype)
        return U.reshape(shape), dU.reshape(shape)

    return pair_fn


def _cell_chunks(plan, lane_chunk):
    step = plan.n_cells
    if lane_chunk:
        step = max(1, lane_chunk // (plan.capacity * plan.width))
    for c0 in range(0, plan.n_cells, step):
        yield c0, min(plan.n_cells, c0 + step)


def near_cut_rows(slot_state, aux, layout, lane_chunk=None):
    """``[n_slots]`` bool: the rows with a lane whose ``d2`` lies within
    a relative 2e-5 of its cut (the global one, or the per-type one):
    the two routes' ``d2`` differ by a few float32 roundings of
    coordinates up to half the box, ~1e-6 of ``rc2`` at the 64k fluid."""
    from . import cellwise as cw
    rel = 1e-5
    plan = layout.plan
    wide = dataclasses.replace(plan, r_cut=plan.r_cut * (1.0 + rel))
    rc2 = plan.r_cut ** 2
    types = slot_state.types.to(slot_state.positions.dtype)
    out = []
    for c0, c1 in _cell_chunks(plan, lane_chunk):
        p = cw.cellwise_planes(slot_state.positions, slot_state.types,
                               aux["valid"], wide, cells=(c0, c1),
                               box=layout.geom(slot_state).box)
        r2 = p.r2()
        near = (r2 - rc2).abs() <= 2.0 * rel * rc2
        if layout.rc2_tab is not None:
            ti = types[c0 * plan.capacity:c1 * plan.capacity, None]
            prc2 = cw.pair_rc2(ti, p.type, layout.rc2_tab)
            near = near | ((r2 - prc2).abs() <= 2.0 * rel * prc2.abs())
        out.append((near & (r2 > 0)).any(dim=1))
    return torch.cat(out)


def route_errors(ref, fast, near, rtol=2e-3, atol=2e-4):
    """The validation's comparison: per output column the largest
    ``|ref - fast|`` over the rows outside ``near`` against ``atol + rtol
    * max|ref|``. Returns ``(ok, report)``."""
    ref, fast = ref.detach().cpu().numpy(), fast.detach().cpu().numpy()
    if ref.ndim != 2 or fast.ndim != 2:
        return False, {"error": f"output shapes {ref.shape}, {fast.shape}"}
    m = min(ref.shape[1], fast.shape[1])
    ref, fast = ref[:, :m], fast[:, :m]
    if not (np.isfinite(ref).all() and np.isfinite(fast).all()):
        return False, {"error": "non-finite forces"}
    keep = ~near.detach().cpu().numpy()
    limit = atol + rtol * (np.abs(ref).max(axis=0) + 1e-6)
    err = np.abs(ref - fast)[keep].max(axis=0, initial=0.0)
    report = {"err": err, "limit": limit,
              "rows_at_the_cut": int((~keep).sum())}
    return bool((err <= limit).all()), report


def planes_forces(model, slot_state, aux, layout, lane_chunk=None,
                  info=None):
    """The model's forces on the cellwise planes route: its first output
    on :meth:`..md.slots.SlotLayout.planes`, ghost rows zeroed. With
    ``lane_chunk``, the model runs on the rows of as many cells at a time
    as keep the planes near ``lane_chunk`` lanes (a model coupling rows
    then sees only its chunk, which a validation counts against it).
    ``info``, a dict, receives the model's number of outputs
    (``"n_outputs"``) and the first one's columns (``"cols"``)."""
    plan = layout.plan
    pos4 = slot_state.positions4
    outs = []
    for c0, c1 in _cell_chunks(plan, lane_chunk):
        rows = slice(c0 * plan.capacity, c1 * plan.capacity)
        planes = layout.planes(slot_state, aux, cells=(c0, c1))
        out = model([planes, pos4[rows], slot_state.box], training=False)
        outs.append(out[0].detach())
        if info is not None:
            info["n_outputs"], info["cols"] = len(out), out[0].shape[-1]
    f = torch.cat(outs)
    return f * aux["valid"][:, None].to(f.dtype)


class _ModelFailed(Exception):
    """The model failed inside the synthesized pair function."""


def validate_pair_fn(model, pair_fn, slot_state, aux, layout, stencil,
                     rtol=2e-3, atol=2e-4, lane_chunk=None, lanes=None,
                     on_eval=None, report=None):
    """Does ``pair_fn`` reproduce the model's planes-route forces and
    per-particle energy on the current state? Per output column, the
    largest error must be within ``atol + rtol * max|ref|``, rows with a
    lane at the cut left out (:func:`route_errors`).

    :param stencil: the analytic route to compare: ``'full'`` (the JAX
        package's choice, the CPU's) or ``'kernel'`` (K1's generic form,
        the card's: the route the model would then run).
    :param lane_chunk: the planes route in row chunks
        (:func:`planes_forces`), for a state whose whole planes do not fit.
    :param lanes: the generic form's :class:`.cellwise_cuda.LaneBudget`.
    :param on_eval: called after each analytic evaluation (the engine
        counts them: on the card each one launches K1's generic form).
    :param report: a dict that receives why: ``"error"`` (the model's
        exception) or the per-column ``"err"`` and ``"limit"`` and the
        rows left out; and the model's ``"n_outputs"`` and ``"cols"``
        (:func:`planes_forces`).
    :returns: a Python bool (one readback). A failure of the model itself
        disqualifies; a failure of a kernel raises.
    """
    from . import cellwise as cw

    report = {} if report is None else report
    try:
        ref = planes_forces(model, slot_state, aux, layout, lane_chunk,
                            info=report)
    except Exception as e:
        report["error"] = f"planes route: {e!r}"
        return False

    def guarded(r2, ti, tj):
        try:
            return pair_fn(r2, ti, tj)
        except Exception as e:
            raise _ModelFailed() from e

    for attempt in range(2):
        try:
            fast, _ = cw.analytic_pair_forces(
                slot_state.positions, slot_state.types, aux["valid"],
                layout.plan, layout.lo, guarded, with_types=True,
                rcut_matrix=layout.rc2_tab, stencil=stencil,
                geometry=layout.geom(slot_state), lanes=lanes)
        except _ModelFailed as e:
            report["error"] = f"synthesized pair function: {e.__cause__!r}"
            return False
        if on_eval is not None:
            on_eval()
        if lanes is None or not bool(lanes.overflow()):
            break
        lanes.grow()  # the list was too short: once more, sized to fit
    near = near_cut_rows(slot_state, aux, layout, lane_chunk=lane_chunk)
    ok, why = route_errors(ref, fast, near, rtol, atol)
    report.update(why)
    return ok
