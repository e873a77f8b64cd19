#!/usr/bin/env python3
"""Where a step's time goes on the card: the 64k online-training step
(``--mode train``, north_star.py's flagship row) or the 64k eval step
(``--mode eval``, the bench protocol), through the port's public API.

Run from the root of a checkout on a machine with one CUDA card:

    python3 profile_step.py [--mode train|eval] [--steps 50]

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

The profiler adds host overhead, so the wall time and busy share under it
are of a profiled run; the per-part times are not.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

GROUPS = (("K1 LJ form", ("half_stencil_kernel", "LJForm")),
          ("K1 proxy form", ("half_stencil_kernel", "ChebForm")),
          ("K2", ("proxy_bwd_kernel",)),
          ("K2 cross-cell sum", ("reduce_partials",)),
          ("roll", ("roll",)),
          ("optimizer", ("adam",)))


def group_of(name):
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
    for name, fn in (("labels: K1 LJ form + planes", labels),
                     ("proxy forward: K1 proxy form + planes", forward),
                     ("backward: K2 + planes", backward),
                     ("node fit + its backward", node_fit),
                     ("Adam step", adam),
                     ("train update: all of the above + loss (no MD)",
                      whole)):
        out[name] = cs.cuda_ms(fn, reps=15)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("train", "eval"), default="train")
    ap.add_argument("--steps", type=int, default=50)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: profile_step.py needs one card",
              file=sys.stderr)
        return 2
    import hoomd_tf_tpu_torch as htt
    import chip_smoke as cs
    cs.torch, cs.htt = torch, htt
    torch.backends.cuda.matmul.allow_tf32 = False

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
