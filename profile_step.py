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
eval plan, of K1's proxy form and K2 (K = 16, forces only) at the train
plan's grid (15^3, capacity 36), and of K3 (NN 64) at the packed path's
plan (18^3, capacity 29 on this state). For each it profiles R = 10
back-to-back calls between marker kernels (``chip_smoke.profiled_calls``:
the profiler can leave the first kernels of a window unrecorded) and
reports the CUDA kernels per call (total / R; ``torch.roll``'s among
them; it raises when no window gives a total that is a multiple of R)
and their device time per call, and gives chip_smoke.py's bound for the
call. It also times K1's generic form on the LJ pair function and
``generic_reduce_bwd`` (forces only) at the eval plan, with the form's
own three kernels' share of the call. ``--dtype float64`` makes the
state, the model and the tables float64 and takes the bounds at
float64's 34 TFLOP/s. Where the package has K3's ``launch_params`` it
also times K3 at forced launch shapes (strip length, warps per block;
float32).

``--mode k3parts`` times K3 (kernel alone, profiler) at the packed
path's plan as it is and with one part of its work taken out, each a
text edit of ``csrc/nlist_select.cu`` built with the package's flags:
without the ranking, without the candidate loop, without the queries
(staging only), and without the minimum image of the chunks that the
|d| <= t0 vote sends to it. The variants' lists are wrong by design;
the differences say where the kernel's time goes.

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
import json
import os
import re
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

GROUPS = (("K1 LJ form", ("half_stencil_forces", "LJForm")),
          ("K1 proxy form", ("half_stencil_forces", "ChebForm")),
          ("K1 push-back", ("half_stencil_home",)),
          ("K2", ("proxy_bwd_kernel",)),
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


def whole_calls(cs, dtype):
    """K1 (LJ, proxy and generic forms), K2, ``generic_reduce_bwd`` and K3
    whole calls alone, on a ``dtype`` state (float32, or float64 for the
    double instantiations): CUDA-event medians, the kernels one call
    launches and their device time (for the generic form also its own
    three kernels' share), and chip_smoke.py's bound (float64 operations
    at their own peak), at the eval, train and packed shapes."""
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
    k3 = k3_call(cs, sim, dtype=dtype)
    calls = calls + (k3[:5],)
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
    return out


def k3_call(cs, sim, shapes=True, dtype=None):
    """K3's whole call at the packed path's plan on the quenched state:
    ``(name, plan, inputs, fn, cost, shapes)``, ``shapes`` the times at
    forced launch shapes where the package has ``launch_params`` (and
    ``shapes`` is asked for; float32 only)."""
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
            shapes)


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
    name, plan, args, _, _, _ = k3_call(cs, sim, shapes=False)
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
                                       "genparts", "mapped"),
                    default="train")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--row", choices=("proxy", "pair", "generic"),
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
    if args.mode == "calls":
        print(json.dumps({"mode": "calls", "tree": os.path.abspath(
            args.tree), "package": os.path.dirname(htt.__file__),
            "device": torch.cuda.get_device_name(0), "smi": cs.smi_line(),
            "dtype": args.dtype,
            "calls": whole_calls(cs, getattr(torch, args.dtype))},
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
