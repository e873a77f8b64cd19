#!/usr/bin/env python3
"""Where a step's time goes on the card: the 64k online-training step
(``--mode train``, north_star.py's flagship row) or the 64k eval step
(``--mode eval``, the bench protocol), through the port's public API; or
(``--mode calls``) the whole calls of kernels K1 and K2 alone.

Run from the root of a checkout on a machine with one CUDA card:

    python3 profile_step.py [--mode train|eval|calls] [--steps 50]
    python3 profile_step.py --mode calls --tree DIR

``--tree DIR`` imports the port's package from another checkout (an
older commit, say) while this file and ``chip_smoke.py`` stay this
checkout's: the public signatures of ``half_stencil_pair_forces`` and
``proxy_bwd_moments`` are the same in both, so one script times both
trees at the same shapes.

It prepares the state as chip_smoke.py does (for training through
chip_smoke.py's own set-up: quench, NVT, the proxy NN attached with
train=True and trained 600 steps around a replan), profiles ``run(steps)`` with torch.profiler and prints:

- wall time per step, summed kernel time per step, and the device's busy
  share (the union of kernel intervals over the wall time);
- kernels per step, and kernel time and count per step by group (K1's LJ
  and proxy forms, K2, torch.roll, the optimizer, the rest);
- for training, each part of a step timed alone by CUDA events at the
  run's shapes: the labels (K1, LJ form), the proxy forward (K1, proxy
  form), the backward (K2), the node fit with its backward, and Adam.

``--mode calls`` quenches the 64k fluid (60 steps, as chip_smoke.py
phase 3) and times, by CUDA events, the whole call of K1's LJ form at the
eval plan, and of K1's proxy form and K2 (K = 16, forces only) at the
train plan's grid (15^3, capacity 36); for each it counts the CUDA
kernels (``torch.roll``'s among them) one call launches, by
torch.profiler, and gives chip_smoke.py's bound for the call.

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
          ("K2 cross-cell sum", ("reduce_partials",)),
          ("optimizer", ("adam",)))


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


def prepare(mode, cs):
    """The 64k system, ready for the profiled window: for training,
    chip_smoke.py's own set-up and warm training."""
    if mode == "train":
        sim, model = cs.train_sim_attached()
        cs.warm_train(sim)
        return sim, model
    htt = cs.htt
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
    sim.auto_replan = False
    return sim, None


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


def whole_calls(cs):
    """K1 and K2 whole calls alone: CUDA-event medians, the kernels one
    call launches, and chip_smoke.py's bound, at the eval and train
    shapes."""
    torch, htt = cs.torch, cs.htt
    from hoomd_tf_tpu_torch.md.slots import SlotLayout
    from hoomd_tf_tpu_torch.ops import cellwise_cuda as cc
    from hoomd_tf_tpu_torch.ops import pair_train_cuda as pc
    from hoomd_tf_tpu_torch.ops.cellwise import _measured_occupancy
    from hoomd_tf_tpu_torch.ops.chebyshev import make_pair_proxy
    from torch.profiler import ProfilerActivity, profile

    sim = cs.jittered_sim(cs.N, htt.md.Minimize(max_disp=0.05), "cuda")
    htt.tfcompute(cs.make_model()).attach(sim, r_cut=cs.R_CUT,
                                          nlist="cellwise")
    sim.run(60)
    eval_plan = sim._layout.plan
    pos = sim.state.positions
    occ_max, _, _ = _measured_occupancy(pos.cpu().numpy(), sim._lo,
                                        eval_plan.lengths, (15, 15, 15))
    train_plan = dataclasses.replace(eval_plan, grid=(15, 15, 15),
                                     capacity=max(36, occ_max))

    def slots(plan):
        layout = SlotLayout(plan, cs.N, sim._lo, device="cuda")
        slot, aux = cs.slot_state(layout, sim.state)
        return layout, (slot.positions, slot.types, aux["valid"], plan,
                        layout.lo)

    ev_lay, ev_st = slots(eval_plan)
    tr_lay, tr_st = slots(train_plan)
    lj = htt.md.LennardJones(1.0, 1.0, r_cut=cs.R_CUT).kernel_form()
    fit, proxy = make_pair_proxy(cs.K_PROXY, (0.25 * cs.R_CUT) ** 2,
                                 cs.R_CUT ** 2, device="cuda")

    def energy(r2):
        u = 1.0 / r2
        return (u * u - 2.0 * u) / (1.0 + u * u)
    with torch.no_grad():
        cheb = proxy.kernel_form(fit(energy))
    ct = torch.randn((train_plan.n_slots, 4), device="cuda",
                     generator=torch.Generator("cuda").manual_seed(0))
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
                            False, 2 * cs.K_PROXY)))
    out = []
    for name, plan, _, fn, cost in calls:
        ms = cs.cuda_ms(fn, reps=25)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [n for n, _, _ in kernel_events(prof)]
        b_ms, b_by = cs.bound(*cost())
        out.append({"call": name, "plan": [list(plan.grid), plan.capacity],
                    "ms": ms, "kernels_per_call": len(names),
                    "roll_kernels_per_call": sum(map(is_roll, names)),
                    "bound_ms": b_ms, "bound_by": b_by})
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("train", "eval", "calls"),
                    default="train")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--tree", default=HERE,
                    help="checkout whose hoomd_tf_tpu_torch is imported")
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
    cs.torch, cs.htt = torch, htt
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.mode == "calls":
        print(json.dumps({"mode": "calls", "tree": os.path.abspath(
            args.tree), "package": os.path.dirname(htt.__file__),
            "device": torch.cuda.get_device_name(0), "smi": cs.smi_line(),
            "calls": whole_calls(cs)}, indent=1))
        return 0

    sim, model = prepare(args.mode, cs)
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
    plan = sim._layout.plan
    rec = {
        "mode": args.mode, "n": cs.N, "steps": n,
        "device": torch.cuda.get_device_name(0), "smi": cs.smi_line(),
        "plan": [list(plan.grid), plan.capacity],
        "wall_ms_per_step": wall_ms / n,
        "kernel_ms_per_step": sum(g[1] for g in groups.values()) / n,
        "busy_share": busy / wall_ms,
        "kernels_per_step": len(ev) / n,
        "by_group_per_step": {k: {"kernels": v[0] / n, "ms": v[1] / n}
                              for k, v in sorted(groups.items())},
    }
    if args.mode == "train":
        rec["parts_ms"] = train_parts(sim, model, cs)
    print(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
