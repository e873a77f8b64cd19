#!/usr/bin/env python3
"""Where a step's time goes on the card: the 64k online-training step
(``--mode train``, one of north_star.py's rows: ``--row proxy``, the
flagship proxy PairModel, ``--row pair``, the non-proxy PairModel, or
``--row generic``, the generic SimModel of reference example 08) or the
64k eval step
(``--mode eval``, the bench protocol), through the port's public API; or
(``--mode calls``) the whole calls of kernels K1, K2, K3 and
``generic_reduce_bwd`` alone, in float32 or (``--dtype float64``) in
their double instantiations; or
(``--mode k3parts``, ``--mode genparts``) where the time of K3, or of K1's
generic form, goes; or (``--mode mapped``) the coarse-grained steps of
chip_smoke.py phases 19-20.

Run from the root of a checkout on a machine with one CUDA card:

    python3 profile_step.py [--mode train|eval|calls|k3parts|genparts|
                                    mapped]
                            [--row proxy|pair|generic] [--steps 50]
                            [--box ortho|tilted|npt]
                            [--route cell|cellwise|molsim]
    python3 profile_step.py --mode calls [--tree DIR] [--dtype float64]
                            [--only k2|k3]
    python3 profile_step.py --mode mesh [--row generic|planes|packed|direct]
                            [--tree DIR]
    python3 profile_step.py --mode meshtrain [--tree DIR]

``--tree DIR`` imports the port's package from another checkout (an
older commit, say) while this file and ``chip_smoke.py`` stay this
checkout's: the public signatures of ``half_stencil_pair_forces``,
``proxy_bwd_moments`` and ``nlist_select`` are the same in both, so one
script times both trees at the same shapes.

``--box`` picks the eval step's box and ensemble: ``ortho`` (the bench
protocol, NVT), ``tilted`` (chip_smoke.py phase 15: NVT in the box
tilted by (0.3, -0.2, 0.25)) or ``npt`` (phase 14: the model with its
virial, NPT at 1.2 times the fluid's pressure through the dynamic-box
layout, 400 warm steps).

It prepares the state as chip_smoke.py does (for training through
chip_smoke.py's own set-up: quench, NVT, the proxy NN attached with
train=True and trained 600 steps around a replan), profiles ``run(steps)`` with torch.profiler and prints:

- wall time per step, summed kernel time per step, and the device's busy
  share (the union of kernel intervals over the wall time);
- kernels per step, and kernel time and count per step by group (K1's LJ
  and proxy forms, K2, torch.roll, the optimizer, the rest);
- for training, each part of a step timed alone by CUDA events at the
  run's shapes: the labels (K1, LJ form), the proxy forward (K1, proxy
  form), the backward (K2), the node fit with its backward, and Adam;
  for the non-proxy rows (chip_smoke.py phases 10 and 11) the labels, the
  forward (K1's generic form's list, the pair function with grad, the
  reduction), the backward kernel ``generic_reduce_bwd``, the pair
  function's backward, and Adam (``chip_smoke.generic_train_parts``).

``--mode calls`` quenches the 64k fluid (60 steps, as chip_smoke.py
phase 3) and times, by CUDA events, the whole call of K1's LJ form at the
eval plan, shard 0 of a 4-shard mesh alone as its group of one (K1's
LJ, proxy and generic forms, K2 and ``generic_reduce_bwd``; in a tree
without K2's and ``generic_reduce_bwd``'s group mode, their slab calls)
at the plan ``ShardedSimulation`` takes on this state, the training
backward over all 4 shards of one card (K2 and ``generic_reduce_bwd``:
one group launch each, or in a tree without a group mode its 4 slab
calls in a row), of K1's proxy form and K2 (K = 16, forces only) at the train
plan's grid (15^3, capacity 36), K2 with energy untyped and typed there
(float32: two types 80:20, phase 39's mixture, and eight types; float64:
two, three and five types), and of K3 (NN 64) at the packed path's
plan (18^3, capacity 29 on this state): unsharded, over the 4 shards of
a mesh of one card (one group launch in place, or in a tree without
K3's group mode its 4 slab calls in a row) and shard 0 alone (a group
of one in place and on its joined buffer, or its slab call). For each it profiles R = 10
back-to-back calls between marker kernels (``chip_smoke.profiled_calls``:
the profiler can leave the first kernels of a window unrecorded) and
reports the CUDA kernels per call (total / R; ``torch.roll``'s among
them; it raises when no window gives a total that is a multiple of R)
and their device time per call, and gives chip_smoke.py's bound for the
call. It also times K1's generic form on the LJ pair function and
``generic_reduce_bwd`` (forces only) at the eval plan, with the form's
own three kernels' share of the call. ``--dtype float64`` makes the
state, the model and the tables float64 and takes the bounds at
float64's 34 TFLOP/s; ``--only k2`` times the whole state's K2 calls
alone, ``--only k3`` K3's calls alone. Where the package has K3's
``launch_params`` it also times K3 at forced launch shapes (strip length, warps per block;
float32). Where it has K1's group launch (``half_stencil_group_forces``)
it also times, on the same state resident on the 4 shards: the LJ form's
group launch over the 4 shards (the whole K1's bound), shard 0 alone as a
group of one (shard 0's bound), and the generic form's group call with
the LJ pair function.

``--mode k3parts`` times K3 (kernel alone, profiler) at the packed
path's plan as it is and with one part of its work taken out, each a
text edit of ``csrc/nlist_select.cu`` built with the package's flags:
without the ranking, without the candidate loop, without the queries
(staging only), and without the minimum image of the chunks that the
|d| <= t0 vote sends to it. The variants' lists are wrong by design;
the differences say where the kernel's time goes.

``--mode mesh`` runs chip_smoke.py phase 29's step loop: phase 4's
fluid (quench, NVT 2000 steps) and LJ PairModel through
``ShardedSimulation`` on ``'cellwise'`` (4 virtual shards of cuda:0, or
min(4, cards) cards), ``run(200)`` and ``run(500)`` to warm up, then a
timed ``run(1000)`` with host syncs forbidden, beside phase 4's own
timed ``run(1000)`` from the same state. It prints both steps/s, the
peak device memory of each timed run (and its rise above what stood
before it), one evaluation of each engine (forces only, the engine's
own ``_forces`` on the slot state its run kept) by CUDA events, that
evaluation's kernels and their device time by the profiler (on the
resident shards: K1's group launch and whatever the halo exchange
launches), and the kernels of a step of ``run(100)`` under
torch.profiler (their number, their summed time and the device's busy
share). ``--row generic`` runs phase 30's configuration instead
(``LJPotential(64)``, Langevin, K1's generic form) beside the same model
unsharded (phase 7's route); ``--row planes`` the planes route of
phases 35 and 38 (:func:`mesh_planes`); ``--row packed`` and ``--row
direct`` the packed routes' step loops of phases 36 and 37
(:func:`mesh_packed`). With
``--tree DIR`` the package is an older checkout's, so one call measures
two trees on one card.

``--mode meshtrain`` runs chip_smoke.py phases 32, 33 and 40's sharded
training from the same NVT fluid: the proxy row (K1's proxy form, K2),
the pair and lane rows (the list route: K1's generic form, the pair
function with grad, ``generic_reduce_bwd``) and the typed proxy row on
the 80:20 Kob-Andersen mixture, through ``ShardedSimulation`` on 4
virtual shards of cuda:0 (or min(4, cards) cards), each beside the same
row unsharded (phases 5, 10, 11, 39); a warm ``run(50)``, then three
timed ``run(200)`` with host syncs forbidden: train steps/s, the first
card's peak memory, the backward kernel's launches and all kernels per
train step (the 25 most launched by name), and where the state lived
(``SlabState``: resident per shard). With ``--tree DIR`` an older
checkout's package runs the same script.

``--mode genparts`` times K1's generic form (``generic_list``,
``generic_reduce`` and the finish, each alone by the profiler) at phase
7's plan, as built and with one part of its work taken out by a text
edit of ``csrc/cellwise_generic.cu`` (``GEN_PARTS``), compiled in a
temporary directory: the staging only; without the marking (the cut
test replaced by an index rule); without the list writes and the
reduction's sweeps. With ``--tree DIR`` it edits and times that
checkout's source. It also gives the whole call at the list
the engine sized, and the pair function's share of its device time.

``--mode mapped`` profiles phase 19's mapped model (65,536 atoms, 16,384
beads; ``--route cell``, the sort method, or ``--route cellwise``, the
planes route) or phase 20's MolSimModel (``--route molsim``, the cell
list with K3) after 20 warm steps from the eval protocol's fluid, and
adds the ten kernels that take the most time and the peak memory.

The profiler adds host overhead, so the wall time and busy share under it
are of a profiled run; the per-part times are not.
"""

import argparse
import dataclasses
import importlib.util
import inspect
import json
import os
import re
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

GROUPS = (("K1 LJ form", ("half_stencil_forces", "LJForm")),
          ("K1 proxy form", ("half_stencil_forces", "ChebForm")),
          ("K1 push-back", ("half_stencil_home",)),
          ("K2", ("proxy_bwd_",)),
          ("K1 generic list", ("generic_list",)),
          ("generic_reduce_bwd", ("generic_reduce_bwd",)),
          ("K1 generic reduction", ("generic_reduce",)),
          ("K2 cross-cell sum", ("reduce_partials",)),
          ("optimizer", ("adam",)),
          ("K3", ("nlist_select",)),
          ("sort", ("sort",)))


def is_roll(name):
    """A torch.roll kernel (and not, say, PyTorch's unrolled elementwise
    kernels, whose names hold "roll" too)."""
    return re.search(r"(?<![a-z])roll", name.lower()) is not None


def group_of(name):
    if is_roll(name):
        return "roll"
    low = name.lower()
    for label, keys in GROUPS:
        if all(k.lower() in low for k in keys):
            return label
    return "other"


def kernel_events(prof):
    """``(name, start_us, end_us)`` of every kernel the profiler saw."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        tr = e.time_range
        out.append((e.name, tr.start, tr.end))
    return out


def union_us(intervals):
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def prepare(mode, cs, row="proxy", box="ortho"):
    """The 64k system, ready for the profiled window: for training,
    chip_smoke.py's own set-up of the ``row`` and its warm training; for
    eval, the bench protocol in the ``box`` of ``--box``."""
    if mode == "train":
        model, loss = {
            "proxy": (None, None),
            "pair": (cs.make_nn(seed=0, proxy_degree=None), cs.force_loss),
            "generic": (cs.make_nn_generic(seed=0), "mse")}[row]
        sim, model = cs.train_sim_attached(model, loss)
        cs.warm_train(sim)
        return sim, model
    htt = cs.htt
    if box == "tilted":
        import numpy as np
        L = (cs.N / cs.DENSITY) ** (1 / 3)
        sim = htt.Simulation(dt=0.005, seed=0, device="cuda",
                             integrator=htt.md.Minimize(max_disp=0.05))
        sim.init_state(cs.tri_lattice(cs.N, L, cs.TILT),
                       np.stack([[-L / 2] * 3, [L / 2] * 3, cs.TILT]),
                       kT_init=1.5)
    else:
        sim = cs.jittered_sim(cs.N, htt.md.Minimize(max_disp=0.05), "cuda")
    htt.tfcompute(cs.make_model()).attach(sim, r_cut=cs.R_CUT,
                                          nlist="cellwise")
    sim.run(60)
    sim.thermalize_velocities(1.5)
    sim.integrator = htt.md.NVT(kT=1.5, tau=0.5)
    sim.run(400)
    sim.run(400)
    sim.replan()
    sim.run(200)
    if box == "npt":
        htt.tfcompute(cs.make_model(virial=True)).attach(
            sim, r_cut=cs.R_CUT, nlist="cellwise")
        sim.run(50)
        p0 = sim.thermo()["pressure"]
        sim.integrator = htt.md.NPT(kT=1.5, tau=0.5, P=1.2 * p0, tauP=0.5)
        sim.run(400)
    sim.auto_replan = False
    return sim, None


def prepare_mapped(cs, route):
    """Phase 19's mapped simulation on ``route`` ('cell' or 'cellwise'),
    or phase 20's MolSimModel ('molsim'), from the eval protocol's fluid
    thermalized at kT 1.5, after 20 warm steps."""
    htt = cs.htt
    fluid, _ = prepare("eval", cs)
    fluid.thermalize_velocities(1.5)
    if route == "molsim":
        sim = htt.Simulation(dt=0.005, device="cuda",
                             integrator=htt.md.NVT(kT=1.5, tau=0.5))
        sim.set_state(fluid.state)
        mols = [list(range(cs.GROUP * i, cs.GROUP * (i + 1)))
                for i in range(cs.N // cs.GROUP)]
        htt.tfcompute(cs.make_lj_mol(mols)).attach(sim, r_cut=cs.R_CUT)
    else:
        sim, _, _ = cs.mapped_sim(fluid.state, route)
    sim.run(20)
    cs.torch.cuda.reset_peak_memory_stats()
    return sim


def train_parts(sim, model, cs):
    """Each part of a train step alone, CUDA-event medians in ms."""
    torch = cs.torch
    from hoomd_tf_tpu_torch.ops import cellwise as cw
    from hoomd_tf_tpu_torch.ops.pair_train import pair_train_forces
    from hoomd_tf_tpu_torch.ops.pair_train_cuda import proxy_bwd_moments

    layout = sim._layout
    p = layout.plan
    st, aux = layout.pack(sim.state)
    lj = sim.forces[0]
    lj_form = sim._builtin_forms[0]
    fit, evaluate = model.proxy_parts(p.r_cut, sim.device)
    tfc = sim.tfc
    opt = tfc.ensure_opt_state()
    common = (st.positions, st.types, aux["valid"], p, layout.lo)

    def labels():
        return cw.analytic_pair_forces(
            *common, lj.pair_energy_and_slope, needs_virial=False,
            with_types=True, needs_energy=False, form=lj_form,
            stencil="kernel", geometry=layout.geometry)

    with torch.no_grad():
        coeffs = fit(model.pair_energy)
    form = evaluate.kernel_form(coeffs)

    def forward():
        return cw.analytic_pair_forces(
            *common, None, needs_virial=False, min_r2=model.min_r2,
            needs_energy=False, form=form, stencil="kernel",
            geometry=layout.geometry)

    ct = torch.randn((p.n_slots, 4), device=sim.device)

    def backward():
        return proxy_bwd_moments(
            st.positions, st.types, aux["valid"], ct, p, layout.lo,
            evaluate.basis, min_r2=model.min_r2, needs_energy=False,
            geometry=layout.geometry)

    g_c = torch.randn(evaluate.basis["K"], device=sim.device)

    def node_fit():
        with torch.enable_grad():
            co = fit(model.pair_energy)
            (co["c"] * g_c).sum().backward()

    def adam():
        opt.step()

    def whole():
        with torch.enable_grad():
            co = fit(model.pair_energy)
            f4 = pair_train_forces(
                co, evaluate, *common, min_r2=model.min_r2,
                needs_energy=False, geometry=layout.geometry)
            loss = model.compute_loss([f4], labels()[0])
        opt.zero_grad()
        loss.backward()
        opt.step()

    out = {}
    for name, fn in (("labels: K1 LJ form, whole call", labels),
                     ("proxy forward: K1 proxy form, whole call", forward),
                     ("backward: K2, whole call", backward),
                     ("node fit + its backward", node_fit),
                     ("Adam step", adam),
                     ("train update: all of the above + loss (no MD)",
                      whole)):
        out[name] = cs.cuda_ms(fn, reps=15)
    return out


def typed_k2_calls(cs, dtype, tr_st, tr_lay, train_plan, ct):
    """K2's typed calls with energy at the train plan (float32: two types
    80:20 by a seeded permutation, phase 39's mixture, and eight types;
    float64: two, three and five types, the types of the others slot %
    T as chip_smoke.py's), beside the untyped call with energy: ``(name,
    plan, state, fn, cost)`` rows of :func:`whole_calls`. The bound adds
    the types' bytes to chip_smoke.k2_cost's."""
    torch, np = cs.torch, cs.np
    from hoomd_tf_tpu_torch.ops import pair_train_cuda as pc
    from hoomd_tf_tpu_torch.ops.chebyshev import (make_pair_proxy,
                                                  make_typed_pair_proxy)
    r2_lo, rc2 = (0.25 * cs.R_CUT) ** 2, cs.R_CUT ** 2
    n_slots = train_plan.n_slots
    rows = []
    basis1 = make_pair_proxy(cs.K_PROXY, r2_lo, rc2, dtype=dtype,
                             device="cuda")[1].basis
    rows.append(("K2 untyped, with energy", train_plan, tr_st,
                 lambda: pc.proxy_bwd_moments(
                     *tr_st[:3], ct, *tr_st[3:], basis1, needs_energy=True,
                     geometry=tr_lay.geometry),
                 lambda: cs.k2_cost(tr_st[0], tr_st[2], train_plan,
                                    cs.K_PROXY, True, 2 * cs.K_PROXY)))
    for T in ((2, 8) if dtype == torch.float32 else (2, 3, 5)):
        if T == 2:
            perm = np.random.RandomState(0).permutation(n_slots)
            types = torch.as_tensor((perm >= 0.8 * n_slots).astype(
                np.int32), device="cuda")
        else:
            types = (torch.arange(n_slots, device="cuda") % T).to(
                torch.int32)
        basis = make_typed_pair_proxy(cs.K_PROXY, r2_lo, rc2, T,
                                      dtype=dtype, device="cuda")[1].basis
        st = (tr_st[0], types, *tr_st[2:])
        M = T * (T + 1) * cs.K_PROXY

        def fn(st=st, basis=basis):
            return pc.proxy_bwd_moments(*st[:3], ct, *st[3:], basis,
                                        needs_energy=True,
                                        geometry=tr_lay.geometry)

        def cost(M=M):
            nbytes, ops = cs.k2_cost(tr_st[0], tr_st[2], train_plan,
                                     cs.K_PROXY, True, M)
            return nbytes + 4 * n_slots, ops
        rows.append((f"K2 {T} types, with energy", train_plan, st, fn,
                     cost))
    return tuple(rows)


def whole_calls(cs, dtype, only=None):
    """K1 (LJ, proxy and generic forms), K2, ``generic_reduce_bwd`` and K3
    whole calls alone, on a ``dtype`` state (float32, or float64 for the
    double instantiations): CUDA-event medians, the kernels one call
    launches and their device time (for the generic form also its own
    three kernels' share), and chip_smoke.py's bound (float64 operations
    at their own peak), at the eval, train and packed shapes; K2 also
    typed (:func:`typed_k2_calls`). ``only='k2'``: the whole state's K2
    calls alone."""
    torch, htt = cs.torch, cs.htt
    from hoomd_tf_tpu_torch.md.slots import SlotLayout
    from hoomd_tf_tpu_torch.ops import cellwise_cuda as cc
    from hoomd_tf_tpu_torch.ops import pair_train_cuda as pc
    from hoomd_tf_tpu_torch.ops.cellwise import _measured_occupancy
    from hoomd_tf_tpu_torch.ops.chebyshev import make_pair_proxy

    peak = cs.PEAK_F64_PER_S if dtype == torch.float64 else cs.PEAK_F32_PER_S
    sim = cs.jittered_sim(cs.N, htt.md.Minimize(max_disp=0.05), "cuda",
                          dtype=dtype)
    htt.tfcompute(cs.make_model(dtype=dtype)).attach(sim, r_cut=cs.R_CUT,
                                                     nlist="cellwise")
    sim.run(60)
    eval_plan = sim._layout.plan
    pos = sim.state.positions
    occ_max, _, _ = _measured_occupancy(pos.cpu().numpy(), sim._lo,
                                        eval_plan.lengths, (15, 15, 15))
    train_plan = dataclasses.replace(eval_plan, grid=(15, 15, 15),
                                     capacity=max(36, occ_max))

    def slots(plan):
        layout = SlotLayout(plan, cs.N, sim._lo, dtype=dtype, device="cuda")
        slot, aux = cs.slot_state(layout, sim.state)
        return layout, (slot.positions, slot.types, aux["valid"], plan,
                        layout.lo)

    ev_lay, ev_st = slots(eval_plan)
    tr_lay, tr_st = slots(train_plan)
    lj = htt.md.LennardJones(1.0, 1.0, r_cut=cs.R_CUT).kernel_form()
    fit, proxy = make_pair_proxy(cs.K_PROXY, (0.25 * cs.R_CUT) ** 2,
                                 cs.R_CUT ** 2, dtype=dtype, device="cuda")

    def energy(r2):
        u = 1.0 / r2
        return (u * u - 2.0 * u) / (1.0 + u * u)
    with torch.no_grad():
        cheb = proxy.kernel_form(fit(energy))
    ct = torch.randn((train_plan.n_slots, 4), device="cuda", dtype=dtype,
                     generator=torch.Generator("cuda").manual_seed(0))
    # K1's generic form on the LJ pair function, and the backward of its
    # reduction, at the eval plan (forces only, the train path's)
    ljf = htt.md.LennardJones(1.0, 1.0, r_cut=cs.R_CUT)
    lanes = cc.LaneBudget(cc.lane_budget(eval_plan, cs.N), "cuda")
    gen_kw = dict(typed_fn=False, needs_energy=False,
                  geometry=ev_lay.geometry, lanes=lanes)

    def pair_fn(r2):
        return ljf.pair_energy_and_slope(r2)
    lanes.reset()
    cc.generic_pair_forces(*ev_st, pair_fn, **gen_kw)
    need = int(lanes.needed)
    gl = cc.generic_list(*ev_st, typed_fn=False, geometry=ev_lay.geometry,
                         lanes=lanes, needs_energy=False)
    cc.generic_reduce(gl, *gl.evaluate(pair_fn), False)
    ct_ev = torch.randn((eval_plan.n_slots, 4), device="cuda", dtype=dtype,
                        generator=torch.Generator("cuda").manual_seed(1))
    calls = (
        ("K1 LJ form, forces only", eval_plan, ev_st,
         lambda: cc.half_stencil_pair_forces(
             *ev_st, lj, needs_energy=False, geometry=ev_lay.geometry),
         lambda: cs.k1_cost(ev_st[0], ev_st[2], eval_plan, 3, lj)),
        ("K1 proxy form, forces only", train_plan, tr_st,
         lambda: cc.half_stencil_pair_forces(
             *tr_st, cheb, needs_energy=False, geometry=tr_lay.geometry),
         lambda: cs.k1_cost(tr_st[0], tr_st[2], train_plan, 3, cheb)),
        ("K2, forces-only cotangent", train_plan, tr_st,
         lambda: pc.proxy_bwd_moments(
             *tr_st[:3], ct, *tr_st[3:], proxy.basis, needs_energy=False,
             geometry=tr_lay.geometry),
         lambda: cs.k2_cost(tr_st[0], tr_st[2], train_plan, cs.K_PROXY,
                            False, 2 * cs.K_PROXY)),
        # the backward before any later generic-form call rewrites its
        # records
        ("generic_reduce_bwd, forces only", eval_plan, ev_st,
         lambda: cc.generic_reduce_bwd(gl, ct_ev, False),
         lambda: cs.bwd_cost(gl, need, False)),
        ("K1 generic form, LJ pair function, forces only", eval_plan, ev_st,
         lambda: cc.generic_pair_forces(*ev_st, pair_fn, **gen_kw),
         lambda: cs.k1_generic_cost(ev_st[0], ev_st[2], eval_plan, 3,
                                    need)))
    calls = calls + typed_k2_calls(cs, dtype, tr_st, tr_lay, train_plan, ct)
    k3 = (None,) * 7
    if only == "k2":
        calls = tuple(c for c in calls if c[0].startswith("K2"))
    elif only == "k3":
        k3 = k3_call(cs, sim, shapes=False, dtype=dtype)
        calls = (k3[:5],) + k3_group_calls(cs, k3)
    else:
        calls = calls + slab_calls(cs, sim, dtype, lj, cheb, proxy, pair_fn)
        k3 = k3_call(cs, sim, dtype=dtype)
        calls = calls + (k3[:5],) + k3_group_calls(cs, k3)
    calls_n = cs.PROFILED_CALLS
    form = ("generic_list", "generic_reduce", "half_stencil_home")
    out = []
    for name, plan, _, fn, cost in calls:
        ms = cs.cuda_ms(fn, reps=25)
        names, dev_ms, dropped, each = cs.profiled_calls(fn)
        b_ms, b_by = cs.bound(*cost()[:2], peak)
        rec = {"call": name, "plan": [list(plan.grid), plan.capacity],
               "ms": ms, "kernels_per_call": len(names) / calls_n,
               "roll_kernels_per_call": sum(map(is_roll, names)) /
               calls_n,
               "kernel_ms_per_call": dev_ms / calls_n,
               "profiler_windows_dropped": dropped,
               "kernels": sorted(set(n[:60] for n in names)),
               "bound_ms": b_ms, "bound_by": b_by}
        if name.startswith("K1 generic"):
            rec["form_kernels_ms_per_call"] = sum(
                t for n, t in zip(names, each)
                if any(k in n for k in form)) / calls_n
        out.append(rec)
    if k3[5] is not None:
        out.append({"call": "K3 at forced launch shapes", "shapes": k3[5]})
    if only == "k3":
        out.append(k3_builds(cs, k3))
    return out


def k3_builds(cs, k3, S=4, rounds=2):
    """The packed build with K3 (``CellNlist``: the binning and the
    selection) on :func:`k3_call`'s state, whole by CUDA events: on
    ``S`` virtual shards of one card (``sharded``, as chip_smoke.py phase
    36 runs it) and unsharded, in turns (sharded, unsharded, unsharded,
    sharded, ...), so that the host's drift falls on both."""
    from hoomd_tf_tpu_torch.ops import cell_list as cl
    torch = cs.torch
    _, plan, args, _, _, _, pos4 = k3
    slots4, _, _, grid, cap, nn, r_cut, host_L, _ = args
    build = cl.CellNlist(grid, cap, host_L, r_cut, nn, "pallas",
                         slots4.device, dtype=slots4.dtype)
    lengths = torch.as_tensor(host_L, dtype=pos4.dtype, device=pos4.device)
    devices = [torch.device("cuda", 0)] * S
    fns = {"sharded_ms": lambda: build.sharded(pos4, lengths, devices),
           "unsharded_ms": lambda: build(pos4, lengths)}
    times = {k: [] for k in fns}
    for r in range(rounds):
        order = ("sharded_ms", "unsharded_ms")
        for k in (order if r % 2 == 0 else order[::-1]) + \
                (order[::-1] if r % 2 == 0 else order):
            times[k].append(cs.cuda_ms(fns[k]))
    return {"call": f"the packed build with K3, {S} virtual shards of one "
                    "card against unsharded, in turns", **times}


def slab_calls(cs, sim, dtype, lj, cheb, proxy, pair_fn, S=4):
    """Shard 0's calls (a mesh of ``S`` shards) at the plan
    ShardedSimulation takes on this state (``nz % S == 0``): K1's LJ and
    proxy forms, its generic form on the LJ pair function, K2 and
    ``generic_reduce_bwd`` (forces only), each on shard 0's slab buffers
    (home layers and forward halo) as its group of one (in a tree without
    K2's or ``generic_reduce_bwd``'s group mode, their slab calls), with
    its own bound (chip_smoke.py's phases 29, 30, 32 and 33); then the
    group launches over every shard."""
    torch = cs.torch
    from hoomd_tf_tpu_torch.md.slots import SlotLayout
    from hoomd_tf_tpu_torch.ops import cellwise as cw
    from hoomd_tf_tpu_torch.ops import cellwise_cuda as cc
    from hoomd_tf_tpu_torch.ops import pair_train_cuda as pc
    from hoomd_tf_tpu_torch.parallel import ShardedSimulation, make_mesh
    # the plan the sharded engine takes on this state
    shd = ShardedSimulation(mesh=make_mesh(
        S, devices=[torch.device("cuda", 0)] * S))
    shd.set_state(sim.state)
    shd.attach(cs.make_model(dtype=dtype), r_cut=cs.R_CUT)
    plan = shd._ensure_layout().plan
    pos = sim.state.positions
    layout = SlotLayout(plan, cs.N, sim._lo, dtype=dtype, device="cuda")
    slot, aux = cs.slot_state(layout, sim.state)
    slab = cw.slab_layers(plan, S)[0]
    one = cw.slab_groups(cw.mesh_slabs(plan, shd.mesh), whole=False)[0]
    buf = [cw.slab_buffer(t, plan, *slab)
           for t in (slot.positions, slot.types, aux["valid"])]
    b1 = [[x] for x in buf]
    ct = cw.slab_buffer(torch.randn(
        (plan.n_slots, 4), device="cuda", dtype=dtype,
        generator=torch.Generator("cuda").manual_seed(2)), plan, *slab)
    common = (*buf, plan, layout.lo)
    g = layout.geometry
    group = "group" in inspect.signature(pc.proxy_bwd_moments).parameters
    lanes = cc.LaneBudget(cc.lane_budget(plan, cs.N, slab), "cuda")
    if group:
        gl = cc.generic_group_list(*b1, plan, layout.lo, one,
                                   typed_fn=False, geometry=g, lanes=lanes,
                                   needs_energy=False)
    else:
        gl = cc.generic_list(*common, typed_fn=False, geometry=g,
                             lanes=lanes, needs_energy=False, slab=slab)
    cc.generic_reduce(gl, *gl.evaluate(pair_fn), False)
    need = int(lanes.needed)
    tested, inside = cs.slab_pair_counts(slot.positions, aux["valid"], plan,
                                         *slab)
    esize = pos.element_size()
    rows = buf[0].shape[0]
    K = cs.K_PROXY

    def k1(per):
        return (rows * esize * (3 + 1 + 4), 9 * tested + inside * (per + 9))
    if group:
        k2_one = (lambda: pc.proxy_bwd_moments(
            *b1, [ct], plan, layout.lo, proxy.basis, needs_energy=False,
            geometry=g, group=one))
    else:
        k2_one = (lambda: pc.proxy_bwd_moments(
            *buf, ct, plan, layout.lo, proxy.basis, needs_energy=False,
            geometry=g, slab=slab))
    how = "a group of one" if group else "slab mode"
    return group_calls(cs, shd.mesh, layout, sim.state, slot, aux, lj,
                       pair_fn, slab, k1) + (
        ("K1 proxy form, shard 0 as a group of one, forces only", plan,
         common,
         lambda: cc.half_stencil_group_forces(
             *b1, plan, layout.lo, cheb, one, needs_energy=False,
             geometry=g),
         lambda: k1(8 * K + 10)),
        (f"K2, shard 0 alone ({how}), forces-only cotangent", plan, common,
         k2_one,
         lambda: (esize * (rows * (3 + 1 + 4) + 2 * K),
                  9 * tested + inside * (27 + K * 4))),
        # the backward before the generic form's call rewrites this
        # group's records
        (f"generic_reduce_bwd, shard 0 alone ({how}), forces only", plan,
         common,
         lambda: cc.generic_reduce_bwd(gl, [ct] if group else ct, False),
         lambda: cs.bwd_cost(gl, need, False)),
        *bwd_group_calls(cs, shd.mesh, layout, sim.state, slot, aux, proxy,
                         pair_fn, dtype),
        ("K1 generic form, shard 0 as a group of one, LJ pair function, "
         "forces only", plan, common,
         lambda: cc.generic_group_pair_forces(
             *b1, plan, layout.lo, pair_fn, one, typed_fn=False,
             needs_energy=False, geometry=g, lanes=lanes),
         lambda: (rows * esize * (3 + 1 + 4) + need * esize * 5,
                  9 * tested + need * 9)))


def bwd_group_calls(cs, mesh, layout, state, slot, aux, proxy, pair_fn,
                    dtype):
    """The training backward's kernels over every shard of ``mesh`` (one
    card): K2 and ``generic_reduce_bwd`` (forces only) as one group launch
    each on the shards' buffers of ``state`` made resident
    (``SlabSlots.pack``; the cotangent cut as each shard's slab buffer),
    or, in a tree without a group mode, the same work as its
    per-shard slab calls in a row (each shard's slab buffers and, for
    ``generic_reduce_bwd``, its own slab list). The lists are made at the
    first call (a warm-up), after the calls timed before them, which
    rewrite the lists of their own keys; bounds: the whole K2's and the
    backward's of the lists."""
    torch = cs.torch
    from hoomd_tf_tpu_torch.ops import cellwise as cw
    from hoomd_tf_tpu_torch.ops import cellwise_cuda as cc
    from hoomd_tf_tpu_torch.ops import pair_train_cuda as pc
    plan, lo, g = layout.plan, layout.lo, layout.geometry
    S = mesh.size
    group = "group" in inspect.signature(pc.proxy_bwd_moments).parameters
    grp = cw.slab_groups(cw.mesh_slabs(plan, mesh))[0]
    whole = (slot.positions, slot.types, aux["valid"])
    ct = torch.randn((plan.n_slots, 4), device="cuda", dtype=dtype,
                     generator=torch.Generator("cuda").manual_seed(3))
    K = cs.K_PROXY
    if group:
        rst, raux = layout.resident(mesh).pack(state)
        bufs = [[p.positions for p in rst.shards],
                [p.types for p in rst.shards], list(raux["valid"]),
                [cw.slab_buffer(ct, plan, z0, nzl) for z0, nzl in
                 cw.slab_layers(plan, S)]]
        k2 = (lambda: pc.proxy_bwd_moments(
            *bufs, plan, lo, proxy.basis, needs_energy=False, geometry=g,
            group=grp))
    else:
        shards = [[cw.slab_buffer(t, plan, z0, nzl) for t in (*whole, ct)]
                  + [(z0, nzl)] for z0, nzl in cw.slab_layers(plan, S)]

        def k2():
            for *b, sl in shards:
                pc.proxy_bwd_moments(*b, plan, lo, proxy.basis,
                                     needs_energy=False, geometry=g,
                                     slab=sl)
    made = {}

    def lists():
        if made:
            return made
        if group:
            lanes = cc.LaneBudget(cc.lane_budget(plan, cs.N, grp.slabs[0]),
                                  "cuda")
            gl = cc.generic_group_list(*bufs[:3], plan, lo, grp,
                                       typed_fn=False, geometry=g,
                                       lanes=lanes, needs_energy=False)
            cc.generic_reduce(gl, *gl.evaluate(pair_fn), False)
            made["calls"] = [(gl, bufs[3])]
        else:
            made["calls"] = []
            for *b, sl in shards:
                lanes = cc.LaneBudget(cc.lane_budget(plan, cs.N, sl),
                                      "cuda")
                gl = cc.generic_list(*b[:3], plan, lo, typed_fn=False,
                                     geometry=g, lanes=lanes,
                                     needs_energy=False, slab=sl)
                cc.generic_reduce(gl, *gl.evaluate(pair_fn), False)
                made["calls"].append((gl, b[3]))
        return made

    def bwd():
        for gl, c in lists()["calls"]:
            cc.generic_reduce_bwd(gl, c, False)

    def bwd_cost():
        parts = [cs.bwd_cost(gl, int(gl.needed), False)
                 for gl, _ in lists()["calls"]]
        return tuple(map(sum, zip(*parts)))
    how = "one group launch" if group else f"{S} slab calls"
    return (
        (f"K2 over {S} shards of one card ({how}), forces-only cotangent",
         plan, whole, k2,
         lambda: cs.k2_cost(slot.positions, aux["valid"], plan, K, False,
                            2 * K)),
        (f"generic_reduce_bwd over {S} shards of one card ({how}), forces "
         "only", plan, whole, bwd, bwd_cost))


def group_calls(cs, mesh, layout, state, slot, aux, lj, pair_fn, slab, k1):
    """K1's group launch (a package that has it) on the same state made
    (``state``, packed whole in ``slot``, ``aux``) resident on ``mesh``'s
    shards: the LJ form over every shard (bound: the whole K1's), shard 0
    alone as a group of one (bound: shard 0's, ``k1``), and the generic
    form over every shard with the LJ pair function (bound: the whole
    generic form's at this plan's need)."""
    from hoomd_tf_tpu_torch.ops import cellwise as cw
    from hoomd_tf_tpu_torch.ops import cellwise_cuda as cc
    if not hasattr(cc, "half_stencil_group_forces"):
        return ()
    plan, lo, g = layout.plan, layout.lo, layout.geometry
    rs = layout.resident(mesh)
    rst, raux = rs.pack(state)
    grp = cw.slab_groups(cw.mesh_slabs(plan, mesh))[0]
    bufs = [[p.positions for p in rst.shards], [p.types for p in rst.shards],
            list(raux["valid"])]
    g0 = rs.geoms(rst)[0]
    one = cw.SlabGroup(grp.device, (0,), (slab,), (-1,), (-1,))
    b0 = [[x[0]] for x in bufs]
    whole = (slot.positions, slot.types, aux["valid"], plan, lo)

    def generic_cost():
        # the whole state's need at this plan (an unsharded list call: it
        # rewrites the unsharded buffers, so only after the calls above)
        wl = cc.LaneBudget(cc.lane_budget(plan, cs.N), "cuda")
        cc.generic_pair_forces(*whole, pair_fn, typed_fn=False,
                               needs_energy=False, geometry=g, lanes=wl)
        return cs.k1_generic_cost(slot.positions, aux["valid"], plan, 3,
                                  int(wl.needed))
    glanes = cc.LaneBudget(cc.lane_budget(plan, cs.N, slab), "cuda")
    n = len(grp.members)
    calls = [
        (f"K1 LJ form, group launch over {n} shards, forces only", plan,
         whole, lambda: cc.half_stencil_group_forces(
             *bufs, plan, lo, lj, grp, needs_energy=False, geometry=g0),
         lambda: cs.k1_cost(slot.positions, aux["valid"], plan, 3, lj))]
    calls.append((
        "K1 LJ form, shard 0 as a group of one, forces only", plan, whole,
        lambda: cc.half_stencil_group_forces(
            *b0, plan, lo, lj, one, needs_energy=False, geometry=g0),
        lambda: k1(14)))
    calls.append((
        f"K1 generic form, group launch over {n} shards, LJ pair function, "
        f"forces only", plan, whole,
        lambda: cc.generic_group_pair_forces(
            *bufs, plan, lo, pair_fn, grp, typed_fn=False,
            needs_energy=False, geometry=g0, lanes=glanes),
        generic_cost))
    return tuple(calls)


def k3_call(cs, sim, shapes=True, dtype=None):
    """K3's whole call at the packed path's plan on the quenched state:
    ``(name, plan, inputs, fn, cost, shapes, positions)``, ``shapes`` the
    times at forced launch shapes where the package has ``launch_params``
    (and ``shapes`` is asked for; float32 only)."""
    import numpy as np
    from hoomd_tf_tpu_torch.ops import cell_list as cl
    from hoomd_tf_tpu_torch.ops import nlist_cuda as nc
    from hoomd_tf_tpu_torch.ops.box import box_size
    htt, torch = cs.htt, cs.torch
    dtype = dtype or torch.float32
    psim = cs.jittered_sim(cs.N, htt.md.Minimize(max_disp=0.05), "cuda",
                           dtype=dtype)
    htt.tfcompute(cs.make_simmodel(64, dtype=dtype)).attach(psim,
                                                            r_cut=cs.R_CUT)
    grid, cap = psim._packed_build().plan
    st = sim.state
    lengths = box_size(st.box)
    host_L = tuple(float(v) for v in lengths.cpu())
    slots4, counts, pid, ovf = cl.build_planes(st.positions4, grid, cap,
                                               lengths)
    cs.check(not bool(ovf), "the quenched state overflows the packed plan")
    args = (slots4, counts, pid, grid, cap, 64, cs.R_CUT, host_L, cs.N)

    def cost():
        key = cs.k3_keys(slots4, grid, cap, lengths)
        far = nc.FAR_KEY64 if key.dtype == torch.int64 else nc.FAR_KEY
        valid = (key != far).sum(1)[pid >= 0]
        return cs.k3_cost(slots4, counts, grid, cap, 64, cs.N, valid)
    plan = dataclasses.make_dataclass("Plan", ["grid", "capacity"])(
        grid, cap)
    if not (shapes and hasattr(nc, "launch_params")) or \
            dtype != torch.float32:
        shapes = None
    else:
        shapes = []
        for strip, warps in ((1, 8), (2, 8), (3, 8), (6, 8), (9, 8),
                             (18, 8), (3, 4), (6, 4)):
            p = nc.launch_params(tuple(grid), cap, 64, cs.R_CUT, host_L,
                                 strip=strip, warps=warps)
            ms = cs.cuda_ms(lambda: nc.launch(p, *args[:3], cs.N), reps=25)
            _, dev_ms, _, _ = cs.profiled_calls(
                lambda: nc.launch(p, *args[:3], cs.N))
            shapes.append({"strip": p.strip, "warps": p.warps,
                           "smem": p.smem, "ms": ms,
                           "kernel_ms": dev_ms / cs.PROFILED_CALLS})
    return ("K3, NN 64", plan, args, lambda: nc.nlist_select(*args), cost,
            shapes, st.positions4)


def mesh_loop(cs, row="proxy"):
    """``--mode mesh``: phase 29's and phase 4's timed runs and one
    evaluation of each (see the module's docstring); ``row='generic'``:
    phase 30's configuration (LJPotential, Langevin) beside the same model
    unsharded."""
    torch, htt = cs.torch, cs.htt
    from hoomd_tf_tpu_torch.parallel import ShardedSimulation
    sim = cs.jittered_sim(cs.N, htt.md.Minimize(max_disp=0.05), "cuda")
    htt.tfcompute(cs.make_model()).attach(sim, r_cut=cs.R_CUT,
                                          nlist="cellwise")
    sim.run(60)
    sim.thermalize_velocities(1.5)
    sim.integrator = htt.md.NVT(kT=1.5, tau=0.5)
    sim.run(1000)
    sim.run(1000)
    generic = row == "generic"
    if generic:
        base = htt.Simulation(dt=0.005, seed=1, device="cuda",
                              integrator=htt.md.Langevin(kT=1.5, gamma=1.0))
        base.set_state(sim.state)
        htt.tfcompute(htt.LJPotential(64)).attach(base, r_cut=cs.R_CUT,
                                                  nlist="cellwise")
        base.run(200)
        sim = base

    def timed(s):
        s.check_syncs = True
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        m0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        s.run(1000)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        st, aux = s._packed[2]
        route = s._route(s._layout, st, aux)
        def evaluate():
            return s._forces(st, aux, s._packed[1], route, False, False)
        ms = cs.cuda_ms(evaluate)
        # the kernels of one evaluation and their device time
        names, dev_ms, _, _ = cs.profiled_calls(evaluate)
        # the kernels of a step: run(100) under the profiler
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            s.run(100)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        ev = kernel_events(prof)
        return {"steps_per_s": 1000 / dt, "peak_mib": peak / 2**20,
                "rise_mib": (peak - m0) / 2**20, "eval_ms": ms,
                "eval_kernels": len(names) / cs.PROFILED_CALLS,
                "eval_kernel_ms": dev_ms / cs.PROFILED_CALLS,
                "kernels_per_step": len(ev) / 100,
                "kernel_ms_per_step": sum(b - a for _, a, b in ev) / 1e5,
                "busy_share": union_us([(a, b) for _, a, b in ev]) / 1e3 /
                wall,
                "plan": [list(s._layout.plan.grid),
                         s._layout.plan.capacity],
                "slot_state": type(st).__name__}
    one, many = ("phase7", "phase30") if generic else ("phase4", "phase29")
    out = {one: timed(sim)}
    mesh, kind = cs.shard_mesh()
    if generic:
        shd = ShardedSimulation(dt=0.005, mesh=mesh, seed=1,
                                integrator=htt.md.Langevin(kT=1.5,
                                                           gamma=1.0))
        shd.set_state(sim.state)
        shd.attach(htt.LJPotential(64), r_cut=cs.R_CUT)
    else:
        shd = ShardedSimulation(dt=0.005, kT=1.5, tau=0.5, mesh=mesh, seed=0)
        shd.set_state(sim.state)
        shd.attach(cs.make_model(), r_cut=cs.R_CUT)
    del sim
    torch.cuda.empty_cache()
    shd.run(200)
    shd.run(500)
    out[many] = timed(shd)
    out["mesh"] = kind
    out["ratio"] = out[many]["steps_per_s"] / out[one]["steps_per_s"]
    return out


def mesh_planes(cs):
    """``--mode mesh --row planes``: the planes route under a mesh, from
    phase 4's NVT fluid through 4 virtual shards of cuda:0 (or min(4,
    cards) cards): chip_smoke.py phase 35's coupled LJ that the probe
    rejects (NVT; warm ``run(20)``, timed ``run(100)``), its planes
    training branch (Adam 1e-2 against the built-in LJ; warm ``run(10)``,
    timed ``run(50)``), and phase 38's mapped model on ``'cellwise'``
    (example 02, 65,536 atoms + 16,384 beads; warm ``run(3)``, timed
    ``run(10)``). Each timed run forbids host syncs; for each: steps/s,
    the first card's peak memory over the timed run, and the kernels of a
    step under torch.profiler (a ``run(5)``, ``run(3)`` for the mapped
    model): their number, their summed time and the busy share; and the
    type of the slot state the run kept."""
    torch, htt = cs.torch, cs.htt
    from torch.profiler import ProfilerActivity, profile
    from hoomd_tf_tpu_torch.parallel import ShardedSimulation
    sim = cs.jittered_sim(cs.N, htt.md.Minimize(max_disp=0.05), "cuda")
    htt.tfcompute(cs.make_model()).attach(sim, r_cut=cs.R_CUT,
                                          nlist="cellwise")
    sim.run(60)
    sim.thermalize_velocities(1.5)
    sim.integrator = htt.md.NVT(kT=1.5, tau=0.5)
    sim.run(1000)
    sim.run(1000)
    state = sim.state
    del sim
    torch.cuda.empty_cache()
    mesh, kind = cs.shard_mesh()
    out = {"mesh": kind}

    def measure(s, warm, steps, prof_steps):
        s.check_syncs = True
        s.run(warm)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(0)
        t0 = time.perf_counter()
        s.run(steps)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            s.run(prof_steps)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        ev = kernel_events(prof)
        return {"steps_per_s": steps / dt, "peak_gib": peak / 2 ** 30,
                "kernels_per_step": len(ev) / prof_steps,
                "kernel_ms_per_step":
                    sum(b - a for _, a, b in ev) / 1e3 / prof_steps,
                "busy_share": union_us([(a, b) for _, a, b in ev]) / 1e3 /
                wall,
                "plan": [list(s._layout.plan.grid), s._layout.plan.capacity],
                "slot_state": type(s._packed[2][0]).__name__}

    shd = ShardedSimulation(dt=0.005, kT=1.5, tau=0.5, mesh=mesh, seed=0)
    shd.set_state(state)
    htt.tfcompute(cs.make_coupled(False)).attach(shd, r_cut=cs.R_CUT,
                                                 nlist="cellwise")
    out["phase35_planes"] = measure(shd, 20, 100, 5)
    trn = ShardedSimulation(dt=0.005, kT=1.5, tau=0.5, mesh=mesh, seed=0)
    trn.set_state(shd.state)
    del shd
    trn.add_force(htt.md.LennardJones(r_cut=cs.R_CUT))
    model = cs.make_coupled(True, epsilon=0.8, sigma=1.05)
    model.compile(optimizer="adam", loss=cs.force_loss, learning_rate=1e-2)
    htt.tfcompute(model).attach(trn, r_cut=cs.R_CUT, nlist="cellwise",
                                train=True)
    out["phase35_train"] = measure(trn, 10, 50, 5)
    del trn, model
    torch.cuda.empty_cache()
    base = htt.Simulation(dt=0.005, integrator=htt.md.NVT(kT=1.5, tau=0.5),
                          seed=19, device="cuda")
    base.set_state(dataclasses.replace(state))
    base.thermalize_velocities(1.5)
    mapped = htt.Simulation(dt=0.005, seed=0, mesh=mesh,
                            integrator=htt.md.NVT(kT=1.5, tau=0.5))
    mapped.set_state(base.state)
    del base
    tfc = htt.tfcompute(cs.make_mapped_lj(64))
    tfc.enable_mapped_nlist(mapped, cs.com_mapping(cs.N)[0])
    tfc.attach(mapped, r_cut=cs.R_CUT, nlist="cellwise")
    out["phase38_mapped_cellwise"] = measure(mapped, 3, 10, 3)
    return out


def mesh_packed(cs, row="packed"):
    """``--mode mesh --row packed|direct``: chip_smoke.py phase 36's step
    loop (a generic SimModel, ``LJModel(64)``, on ``'auto'``: the cell
    list with K3's group mode; warm ``run(20)``, timed ``run(200)``,
    profiled ``run(10)``) or phase 37's (``LJPotential(64)`` on
    ``'direct'``; ``run(5)``, ``run(50)``, ``run(3)``) through
    ``Simulation(mesh=)`` on 4 virtual shards of cuda:0 (or min(4, cards)
    cards), NVT at kT 1.5 from phase 4's fluid. The timed run forbids host
    syncs. Reports steps/s, the first card's peak memory over the timed
    run (and what stood before it), the kernels of a step under
    torch.profiler (their number, summed time, the busy share) and the
    class of the state the engine holds after the run (``RowState``: by
    particle rows per shard; ``SimState``: whole on the first card)."""
    torch, htt = cs.torch, cs.htt
    from torch.profiler import ProfilerActivity, profile
    sim = cs.jittered_sim(cs.N, htt.md.Minimize(max_disp=0.05), "cuda")
    htt.tfcompute(cs.make_model()).attach(sim, r_cut=cs.R_CUT,
                                          nlist="cellwise")
    sim.run(60)
    sim.thermalize_velocities(1.5)
    sim.integrator = htt.md.NVT(kT=1.5, tau=0.5)
    sim.run(1000)
    sim.run(1000)
    state = sim.state
    del sim
    torch.cuda.empty_cache()
    mesh, kind = cs.shard_mesh()
    shd = htt.Simulation(dt=0.005, seed=0, mesh=mesh,
                         integrator=htt.md.NVT(kT=1.5, tau=0.5))
    shd.set_state(state)
    del state
    if row == "direct":
        model, nlist, (warm, steps, prof_steps) = (
            htt.LJPotential(64), "direct", (5, 50, 3))
    else:
        model, nlist, (warm, steps, prof_steps) = (
            cs.make_simmodel(64), None, (20, 200, 10))
    htt.tfcompute(model).attach(shd, r_cut=cs.R_CUT, nlist=nlist)
    shd.check_syncs = True
    shd.run(warm)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(0)
    m0 = torch.cuda.memory_allocated(0)
    t0 = time.perf_counter()
    shd.run(steps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        shd.run(prof_steps)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ev = kernel_events(prof)
    held = shd.__dict__.get("_state", shd.state)
    return {"phase": "37" if row == "direct" else "36", "mesh": kind,
            "method": shd._packed_build().method,
            "steps_per_s": steps / dt, "timed_steps": steps,
            "peak_gib": peak / 2 ** 30, "before_gib": m0 / 2 ** 30,
            "kernels_per_step": len(ev) / prof_steps,
            "kernel_ms_per_step":
                sum(b - a for _, a, b in ev) / 1e3 / prof_steps,
            "busy_share": union_us([(a, b) for _, a, b in ev]) / 1e3 /
            wall,
            "state": type(held).__name__}


def mesh_train(cs, steps=200):
    """``--mode meshtrain``: chip_smoke.py's sharded training rows through
    ShardedSimulation on 4 virtual shards of the card (or min(4, cards)
    cards) -- phase 32's proxy row (K2), phase 33's pair row (the list
    route) and lane row, phase 40's typed proxy row on the 80:20
    Kob-Andersen mixture -- each beside the same row on the unsharded
    engine (phases 5, 10, 11 and 39), all from the NVT fluid of ``--mode
    mesh`` (the typed rows with the mixture's types and its LJ): a warm
    ``run(50)``, then three timed ``run(steps)`` with host syncs
    forbidden, each with the first card's peak memory; train steps/s, the
    backward kernel's launches and all kernels (torch.profiler, between
    markers) per train step."""
    torch, htt = cs.torch, cs.htt
    from hoomd_tf_tpu_torch.ops import cellwise_cuda as cc
    from hoomd_tf_tpu_torch.ops import pair_train_cuda as pc
    from hoomd_tf_tpu_torch.parallel import ShardedSimulation
    sim = cs.jittered_sim(cs.N, htt.md.Minimize(max_disp=0.05), "cuda")
    htt.tfcompute(cs.make_model()).attach(sim, r_cut=cs.R_CUT,
                                          nlist="cellwise")
    sim.run(60)
    sim.thermalize_velocities(1.5)
    sim.integrator = htt.md.NVT(kT=1.5, tau=0.5)
    sim.run(1000)
    state = sim.state
    mixture = dataclasses.replace(state, types=torch.as_tensor(
        cs.mixture_types(cs.N), dtype=torch.int32, device="cuda"))
    del sim
    mesh, kind = cs.shard_mesh()
    out = {"mesh": kind}
    k2, bwd = pc.proxy_bwd_moments, cc.generic_reduce_bwd
    rows = (("proxy", ("phase32", "phase5"), lambda: cs.make_nn(seed=0),
             cs.force_loss, k2, False),
            ("pair", ("phase33", "phase10"),
             lambda: cs.make_nn(seed=0, proxy_degree=None), cs.force_loss,
             bwd, False),
            ("lane", ("phase33", "phase11"), lambda: cs.make_nn_generic(
                seed=0), "mse", bwd, False),
            ("typed", ("phase40", "phase39"), cs.make_typed_nn,
             cs.force_loss, k2, True))
    for row, names, make, loss, counter, typed in rows:
        for name, m in zip(names, (mesh, None)):
            if m is None:
                sim = htt.Simulation(dt=0.005, seed=0, device="cuda",
                                     integrator=htt.md.NVT(kT=1.5, tau=0.5))
            else:
                sim = ShardedSimulation(dt=0.005, kT=1.5, tau=0.5, mesh=m,
                                        seed=0)
            sim.set_state(mixture if typed else state)
            sim.add_force(cs.ka_lj() if typed else
                          htt.md.LennardJones(r_cut=cs.R_CUT))
            model = make()
            model.compile(optimizer="adam", loss=loss, learning_rate=1e-2)
            htt.tfcompute(model).attach(sim, r_cut=cs.R_CUT,
                                        nlist="cellwise", train=True)
            sim.check_syncs = True
            sim.run(50)
            times, peaks = [], []
            n0, s0 = counter.launches, sim.train_steps
            for _ in range(3):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(0)
                t0 = time.perf_counter()
                sim.run(steps)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                peaks.append(torch.cuda.max_memory_allocated(0) / 1e9)
            per = (counter.launches - n0) / (sim.train_steps - s0)
            kernels, _, names = cs.train_kernels(sim)
            counted = len(names) / kernels
            by_name = {}
            for k in names:
                k = re.sub(r"^void |at::native::|\(anonymous namespace\)::",
                           "", k)[:80]
                by_name[k] = by_name.get(k, 0) + 1
            out[f"{name}_{row}"] = {
                "sharded": m is not None,
                "steps_per_s": [steps / t for t in times],
                "best_steps_per_s": steps / min(times),
                "backward_launches_per_step": per,
                "kernels_per_step": kernels,
                "top_kernels_per_step": {
                    k: v / counted for k, v in sorted(
                        by_name.items(), key=lambda x: -x[1])[:25]},
                "peak_memory_gb": peaks,
                "plan": [list(sim._layout.plan.grid),
                         sim._layout.plan.capacity],
                "resident": type(sim._packed[2][0]).__name__}
            del sim, model
            torch.cuda.empty_cache()
    return out


def k3_group_calls(cs, k3, S=4):
    """K3 under a mesh of ``S`` virtual shards of one card (the packed
    grid's ``nz s // S`` layers a shard, as chip_smoke.py phase 36 splits
    it) on :func:`k3_call`'s planes: every shard as one group launch in
    place (the whole call's bound, ``k3_cost``'s), shard 0 alone as a
    group of one in place and on its joined buffer made beforehand (the
    launch of a card that does not bin; each its own bound,
    ``k3_group_cost``); in a tree without the group mode, the same work as
    its slab calls (the 4 in a row, and shard 0's, twice), on slab buffers
    made beforehand: a group of one's joined buffer is shard 0's slab
    buffer. ``(name, plan, inputs, fn, cost)`` each."""
    from hoomd_tf_tpu_torch.ops import cell_stencil as cst
    from hoomd_tf_tpu_torch.ops import nlist_cuda as nc
    torch = cs.torch
    name, plan, args, _, whole_cost, _, _ = k3
    slots4, counts, pid, grid, cap, nn, r_cut, host_L, n = args
    shards = [sl for sl in cst.z_slabs(grid[2], S) if sl[1]]
    group = "group" in inspect.signature(nc.nlist_select).parameters
    if group:
        out = torch.empty((n + 1, nn, 4), dtype=slots4.dtype,
                          device=slots4.device)
        every = cst.group_layers(shards)

        def call(runs):
            return lambda: nc.nlist_select(*args, group=runs, out=out)
        one = (shards[0],)
        buf = (cst.joined_slab(slots4, grid, cap, one, slots4.device),
               cst.joined_slab(counts, grid, 1, one, slots4.device))
        fns = call(every), call(one), lambda: nc.nlist_select(
            *buf, None, grid, cap, nn, r_cut, host_L, None, group=one)
    else:
        bufs = [(cst.halo_slab(slots4, grid, cap, z0, k, slots4.device),
                 cst.halo_slab(counts, grid, 1, z0, k, slots4.device),
                 (z0, k)) for z0, k in shards]

        def call(parts):
            def fn():
                for b, c, sl in parts:
                    nc.nlist_select(b, c, None, grid, cap, nn, r_cut,
                                    host_L, None, slab=sl)
            return fn
        fns = call(bufs), call(bufs[:1]), call(bufs[:1])

    def shard0_cost(joined=False):
        lengths = torch.as_tensor(host_L, dtype=slots4.dtype,
                                  device=slots4.device)
        # the whole table's keys (either tree's package), shard 0's rows
        key = cs.k3_keys(slots4, grid, cap, lengths)
        far = nc.FAR_KEY64 if key.dtype == torch.int64 else nc.FAR_KEY
        layer = grid[0] * grid[1] * cap
        z0, k = shards[0]
        rows = slice(z0 * layer, (z0 + k) * layer)
        valid = (key[rows] != far).sum(1)[pid[rows] >= 0]
        return cs.k3_group_cost(counts, grid, cap, nn, n, (shards[0],),
                                valid, slots4.element_size(), joined)[:2]
    how = ("one group launch", "a group of one in place",
           "a group of one on its joined buffer") if group else \
        (f"{len(shards)} slab calls", "its slab call",
         "its slab call on its slab buffer")
    z0, k = shards[0]
    return ((f"{name} over {S} shards of one card ({how[0]})", plan, args,
             fns[0], whole_cost),
            (f"{name}, shard 0 of {S} alone (layers {z0}-{z0 + k - 1}; "
             f"{how[1]})", plan, args, fns[1], shard0_cost),
            (f"{name}, shard 0 of {S} alone, joined (layers {z0}-"
             f"{z0 + k - 1}; {how[2]})", plan, args, fns[2],
             lambda: shard0_cost(True)))


#: part of K3 -> (anchor, replacement) edits of csrc/nlist_select.cu
K3_PARTS = {
    "as built": (),
    "without the ranking": (
        ("int r0 = 0, r1 = 0;", "int r0 = h, r1 = h + 32;"),
        ("for (int m = 0; m < nv4 / 4; ++m) {",
         "for (int m = 0; m < 0; ++m) {")),
    "without the candidate loop": (
        ("const int total = start[9 * i + 27] - lo;",
         "const int total = 0 * (start[9 * i + 27] - lo);"),),
    "without the queries (staging only)": (
        ("for (int t = warp; t < Q; t += p.warps) {",
         "for (int t = warp; t < Q * 0; t += p.warps) {"),),
    "without the voted minimum image": (
        ("if (__any_sync(kFull, far)) {", "if (far && lane > 99) {"),),
}


def k3_parts(cs):
    """K3's kernel alone at the packed plan, as built and without each
    part of its work (K3_PARTS): ``{part: ms}``."""
    import ctypes
    import subprocess
    import tempfile
    from hoomd_tf_tpu_torch import _build
    from hoomd_tf_tpu_torch.ops import nlist_cuda as nc
    torch = cs.torch
    sim = cs.jittered_sim(cs.N, cs.htt.md.Minimize(max_disp=0.05), "cuda")
    cs.htt.tfcompute(cs.make_model()).attach(sim, r_cut=cs.R_CUT,
                                             nlist="cellwise")
    sim.run(60)
    name, plan, args, _, _, _, _ = k3_call(cs, sim, shapes=False)
    src = (_build._PKG / "csrc" / "nlist_select.cu").read_text()
    p = nc.launch_params(plan.grid, plan.capacity, 64, cs.R_CUT, args[7])
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for part, edits in K3_PARTS.items():
            text = src
            for old, new in edits:
                cs.check(old in text, f"K3_PARTS: {old!r} not in the source")
                text = text.replace(old, new)
            cu, so = f"{tmp}/k3.cu", f"{tmp}/k3_{len(out)}.so"
            with open(cu, "w") as f:
                f.write(text)
            subprocess.run([_build._nvcc(), *_build._FLAGS, "-o", so, cu],
                           check=True, capture_output=True)
            lib = ctypes.CDLL(so)
            lib.htf_nlist_select.argtypes = (
                [ctypes.c_void_p] * 4 + [ctypes.c_int] +
                [ctypes.c_void_p] * 2)
            lib.htf_nlist_select.restype = ctypes.c_int
            lib.htf_nlist_error_string.argtypes = [ctypes.c_int]
            lib.htf_nlist_error_string.restype = ctypes.c_char_p
            nc._LIB = lib
            _, dev_ms, _, _ = cs.profiled_calls(
                lambda: nc.launch(p, *args[:3], cs.N))
            out[part] = dev_ms / cs.PROFILED_CALLS
    nc._LIB = None
    torch.cuda.synchronize()
    return {"call": name, "plan": [list(plan.grid), plan.capacity],
            "strip": p.strip, "warps": p.warps, "kernel_ms": out}


#: part of K1's generic form -> its edits of csrc/cellwise_generic.cu, one
#: set of (anchor, replacement) pairs for each design of the source: PR
#: 7's (both kernels stage and mark) and the list kernel that hands each
#: cell's record to the reduction. A part applies the first set whose
#: anchors are all in the source, and a source none of whose sets applies
#: whole is refused.
GEN_PARTS = {
    "as built": ((),),
    "staging only": (
        # both kernels stage and mark: return after the staging
        (("  const int n_lanes = mark_lanes(spos, n0, total, rcm, rcm_t, "
          "rc2, s);",
          "  if (total >= 0) return;\n  const int n_lanes = mark_lanes("
          "spos, n0, total, rcm, rcm_t, rc2, s);"),
         ("  mark_lanes(spos, n0, total, rcm, rcm_t, rc2, s);\n"
          "  const int base = cell_base[c];",
          "  if (total >= 0) return;\n  const int base = cell_base[c];")),
        # the record: the list returns after the staging, the reduction
        # after reading the record into shared memory
        (("  mark_lanes(n0, total, rcm, rcm_t, rc2, s);\n  if (tid == 0) {",
          "  if (total >= 0) return;\n"
          "  mark_lanes(n0, total, rcm, rcm_t, rc2, s);\n  if (tid == 0) {"),
         ("  __syncthreads();\n  const size_t home = static_cast<size_t>(c) "
          "* cap;",
          "  __syncthreads();\n  if (n0 >= 0) return;\n"
          "  const size_t home = static_cast<size_t>(c) * cap;")),
    ),
    "without the marking": (
        # the cut test's arithmetic replaced by an index rule that keeps
        # a similar share of the lanes (1 in 8)
        (("        ok = in_cut(q, spos[j], rcm, rcm_t, rc2, dx, dy, dz, "
          "d2);",
          "        ok = (j & 7) == (i & 7);"),),
        (("        ok = in_cut(q, g, rcm, rcm_t, rc2, dx, dy, dz, d2);",
          "        ok = (j & 7) == (i & 7);"),),
    ),
    "without the list writes and sweeps": (
        (("  if (base < 0) return;", "  if (base >= -1) return;"),
         ("  const int base = cell_base[c];  // -1: the cell's lanes are "
          "not listed",
          "  const int base = -1;")),
    ),
}


def gen_part_source(src, part):
    """``src`` with GEN_PARTS[part] applied: the first of the part's edit
    sets whose anchors are all in ``src``."""
    for edits in GEN_PARTS[part]:
        if all(old in src for old, _ in edits):
            for old, new in edits:
                src = src.replace(old, new)
            return src
    raise RuntimeError(f"GEN_PARTS: no design of {part!r} has all its "
                       "anchors in csrc/cellwise_generic.cu")


def gen_parts(cs):
    """K1's generic form at phase 7's plan (LJPotential(64) on
    'cellwise', quenched, then phase 7's warm NVT runs), each of its
    kernels alone by the profiler: as built and without one part of its
    work (GEN_PARTS), each a text edit of ``csrc/cellwise_generic.cu``
    built with the package's flags. The list is given three times the
    lanes needed, so no variant overflows it. Also the whole call by CUDA
    events and the pair function's share of its device time."""
    import subprocess
    import tempfile
    from hoomd_tf_tpu_torch import _build
    from hoomd_tf_tpu_torch.md.slots import SlotLayout
    from hoomd_tf_tpu_torch.ops import cellwise_cuda as cc
    from hoomd_tf_tpu_torch.ops.lane_fast import synthesize_pair_fn
    torch, htt = cs.torch, cs.htt
    sim = cs.jittered_sim(cs.N, htt.md.Minimize(max_disp=0.05), "cuda")
    model = htt.LJPotential(64)
    htt.tfcompute(model).attach(sim, r_cut=cs.R_CUT, nlist="cellwise")
    sim.run(60)
    sim.thermalize_velocities(1.5)
    sim.integrator = htt.md.NVT(kT=1.5, tau=0.5)
    sim.run(1000)
    for _ in range(4):  # phase 7's warm runs: until the plan settles
        plan = sim._layout.plan
        sim.run(1000)
        if sim._layout.plan == plan:
            break
    plan = sim._layout.plan
    layout = SlotLayout(plan, cs.N, sim._lo, device="cuda")
    slot, aux = cs.slot_state(layout, sim.state)
    fn = synthesize_pair_fn(model, slot.box)
    args = (slot.positions, slot.types, aux["valid"], plan, layout.lo, fn)
    kw = dict(min_r2=1e-4, geometry=layout.geometry, needs_energy=False)
    probe = cc.LaneBudget(cc.lane_budget(plan, cs.N), "cuda")
    cc.generic_pair_forces(*args, lanes=probe, **kw)
    needed = int(probe.needed)
    lanes = cc.LaneBudget(3 * needed, "cuda")
    engine = cc.LaneBudget(sim._lanes.budget, "cuda")
    src = (_build._PKG / "csrc" / "cellwise_generic.cu").read_text()
    names = ("generic_list", "generic_reduce", "half_stencil_home")
    out, whole = {}, {}
    real_build = _build.build_shared_library
    csrc = str(_build._PKG / "csrc")
    with tempfile.TemporaryDirectory() as tmp:
        for part in GEN_PARTS:
            # the edited source compiles in the temporary directory, its
            # headers from the package's csrc/
            cu, so = f"{tmp}/generic.cu", f"{tmp}/gen_{len(out)}.so"
            with open(cu, "w") as f:
                f.write(gen_part_source(src, part))
            subprocess.run([_build._nvcc(), *_build._FLAGS, "-I", csrc,
                            "-o", so, cu], check=True, capture_output=True)
            _build.build_shared_library = lambda name, so=so: so
            cc._GLIB = None
            try:
                cc._generic_library()
            finally:
                _build.build_shared_library = real_build
            call = (lambda: cc.generic_pair_forces(*args, lanes=lanes, **kw))
            got, dev_ms, _, each = cs.profiled_calls(call)
            per = {k: 0.0 for k in names}
            for name, ms in zip(got, each):
                for k in names:
                    if k in name:
                        per[k] += ms / cs.PROFILED_CALLS
            per["all kernels of a call"] = dev_ms / cs.PROFILED_CALLS
            out[part] = per
            if part == "as built":
                # the whole call with the list the engine sized
                call = (lambda: cc.generic_pair_forces(
                    *args, lanes=engine, **kw))
                got, dev_ms, _, _ = cs.profiled_calls(call)
                whole = {"ms": cs.cuda_ms(call, reps=11),
                         "list_budget": engine.budget,
                         "all_kernels_ms": dev_ms / cs.PROFILED_CALLS,
                         "kernels_per_call": len(got) / cs.PROFILED_CALLS,
                         "pair_function_share": 1.0 - sum(
                             per[k] for k in names) / dev_ms *
                         cs.PROFILED_CALLS}
    cc._GLIB = None
    torch.cuda.synchronize()
    return {"plan": [list(plan.grid), plan.capacity], "lanes_needed": needed,
            "whole_call": whole, "kernel_ms": out}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("train", "eval", "calls", "k3parts",
                                       "genparts", "mapped", "mesh",
                                       "meshtrain"),
                    default="train")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--row", choices=("proxy", "pair", "generic", "planes",
                                      "packed", "direct"),
                    default="proxy")
    ap.add_argument("--box", choices=("ortho", "tilted", "npt"),
                    default="ortho")
    ap.add_argument("--route", choices=("cell", "cellwise", "molsim"),
                    default="cell")
    ap.add_argument("--tree", default=HERE,
                    help="checkout whose hoomd_tf_tpu_torch is imported")
    ap.add_argument("--dtype", choices=("float32", "float64"),
                    default="float32",
                    help="--mode calls: the state's dtype (float64: the "
                    "kernels' double instantiations)")
    ap.add_argument("--only", choices=("k2", "k3"),
                    help="--mode calls: only the whole state's K2 calls, "
                    "or K3's (unsharded, a mesh's 4 shards, shard 0)")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: profile_step.py needs one card",
              file=sys.stderr)
        return 2
    import hoomd_tf_tpu_torch as htt
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import numpy as np
    cs.torch, cs.htt, cs.np = torch, htt, np
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.mode == "k3parts":
        print(json.dumps({"mode": "k3parts", "device":
                          torch.cuda.get_device_name(0),
                          "smi": cs.smi_line(), **k3_parts(cs)}, indent=1))
        return 0
    if args.mode == "genparts":
        print(json.dumps({"mode": "genparts", "tree": os.path.abspath(
            args.tree), "device": torch.cuda.get_device_name(0),
            "smi": cs.smi_line(), **gen_parts(cs)}, indent=1))
        return 0
    if args.mode == "mesh":
        print(json.dumps({"mode": "mesh", "tree": os.path.abspath(
            args.tree), "package": os.path.dirname(htt.__file__),
            "device": torch.cuda.get_device_name(0), "smi": cs.smi_line(),
            "row": args.row, **(
                mesh_planes(cs) if args.row == "planes" else
                mesh_packed(cs, args.row) if args.row in ("packed", "direct")
                else mesh_loop(cs, args.row))}, indent=1))
        return 0
    if args.mode == "meshtrain":
        print(json.dumps({"mode": "meshtrain", "tree": os.path.abspath(
            args.tree), "package": os.path.dirname(htt.__file__),
            "device": torch.cuda.get_device_name(0), "smi": cs.smi_line(),
            **mesh_train(cs)}, indent=1))
        return 0
    if args.mode == "calls":
        print(json.dumps({"mode": "calls", "tree": os.path.abspath(
            args.tree), "package": os.path.dirname(htt.__file__),
            "device": torch.cuda.get_device_name(0), "smi": cs.smi_line(),
            "dtype": args.dtype,
            "calls": whole_calls(cs, getattr(torch, args.dtype),
                                 args.only)},
            indent=1))
        return 0

    if args.mode == "mapped":
        sim, model = prepare_mapped(cs, args.route), None
    else:
        sim, model = prepare(args.mode, cs, args.row, args.box)
    n = args.steps
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run(n)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ev = kernel_events(prof)
    busy = union_us([(a, b) for _, a, b in ev]) / 1e3
    groups = {}
    for name, a, b in ev:
        g = groups.setdefault(group_of(name), [0, 0.0])
        g[0] += 1
        g[1] += (b - a) / 1e3
    if sim._layout is not None:
        plan = [list(sim._layout.plan.grid), sim._layout.plan.capacity]
    else:
        grid, cap = sim._packed_build().plan
        plan = [list(grid), cap]
    rec = {
        "mode": args.mode, "box": args.box, "n": cs.N, "steps": n,
        "rows": sim.state.n_particles,
        "device": torch.cuda.get_device_name(0), "smi": cs.smi_line(),
        "plan": plan,
        "wall_ms_per_step": wall_ms / n,
        "kernel_ms_per_step": sum(g[1] for g in groups.values()) / n,
        "busy_share": busy / wall_ms,
        "kernels_per_step": len(ev) / n,
        "by_group_per_step": {k: {"kernels": v[0] / n, "ms": v[1] / n}
                              for k, v in sorted(groups.items())},
    }
    if args.mode == "train":
        rec["row"] = args.row
        rec["parts_ms"] = (train_parts(sim, model, cs) if args.row == "proxy"
                           else cs.generic_train_parts(sim)[0])
        rec["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if args.mode == "mapped":
        rec["route"] = args.route
        top = {}
        for name, a, b in ev:
            top[name] = top.get(name, 0.0) + (b - a) / 1e3
        rec["top_kernels_ms_per_step"] = {
            k[:100]: v / n for k, v in sorted(top.items(),
                                              key=lambda x: -x[1])[:10]}
        rec["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
