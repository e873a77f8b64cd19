#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``hoomd_tf_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing one info line; any failure raises and the script
exits non-zero:

1. device   -- a CUDA card must be present; prints its name and power
               limit as nvidia-smi reports them;
2. build    -- compiles kernel K1 (csrc/cellwise_half.cu) with nvcc;
3. kernels  -- K1 against its plain PyTorch version and the full-stencil
               tensor form at the 64k fluid's shapes (one- and two-type
               potentials, a per-type cutoff matrix, and a capacity whose
               14*cap exceeds 1024 lanes), plus both times;
4. main     -- the benchmark protocol through the public API: a 64k LJ
               fluid at density 0.4, r_cut 3, PairModel + cellwise,
               Minimize quench, thermalize, NVT at kT 1.5, warm runs, a
               timed run(1000) with host syncs forbidden in the step loop,
               and a small-N trajectory against the CPU tensor form.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N = 65536
DENSITY = 0.4
R_CUT = 3.0
# Tolerance of a kernel against its plain version: rtol = atol = 1e-4, the
# JAX package's own bar for its Pallas kernel (tests/test_cellwise.py).
RTOL = ATOL = 1e-4


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def compare(name, got, want):
    """max |got - want| and the worst ratio to atol + rtol * |want|."""
    err = (got - want).abs()
    bound = ATOL + RTOL * want.abs()
    worst = float((err / bound).max())
    max_abs = float(err.max())
    print(f"  {name}: max_abs_err={max_abs:.3e} "
          f"max|ref|={float(want.abs().max()):.3e} worst/bound={worst:.3f}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    check(worst <= 1.0, f"{name}: kernel disagrees with its plain version")
    return max_abs


def cuda_ms(fn, reps=25):
    """Median time of ``fn()`` in ms by CUDA events (after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def make_model():
    class LJ(htt.PairModel):
        """The benchmark's LJ (epsilon = sigma = 1), declaring its form."""

        def pair_energy(self, r2):
            return self.pair_energy_and_slope(r2)[0]

        def pair_energy_and_slope(self, r2):
            u = 1.0 / r2
            sr6 = u * u * u
            return (4.0 * (sr6 * sr6 - sr6),
                    -12.0 * (2.0 * sr6 - 1.0) * sr6 * u)

        def pair_kernel_form(self):
            return htt.md.LennardJones(1.0, 1.0, r_cut=R_CUT)
    return LJ(64)


def jittered_sim(n, integrator, device, seed=0):
    import numpy as np
    sim = htt.Simulation(dt=0.005, integrator=integrator, seed=seed,
                         device=device)
    sim.init_lattice(n, density=DENSITY, kT_init=1.5)
    rng = np.random.RandomState(seed)
    sim.state.positions = sim.state.positions + torch.as_tensor(
        0.3 * rng.randn(n, 3).astype(np.float32), device=device)
    return sim


def phase_kernels():
    """K1 vs plain at the shapes the main path gives it."""
    from hoomd_tf_tpu_torch.ops import cellwise as cw
    from hoomd_tf_tpu_torch.ops import cellwise_cuda as cc
    from hoomd_tf_tpu_torch.md.slots import SlotLayout

    sim = jittered_sim(N, htt.md.Minimize(max_disp=0.05), "cuda")
    tfc = htt.tfcompute(make_model())
    tfc.attach(sim, r_cut=R_CUT, nlist="cellwise")
    sim.run(60)
    plan = sim._layout.plan
    print(f"  quenched 64k state; plan the port picks on the card: grid "
          f"{plan.grid}, capacity {plan.capacity}, "
          f"14*cap {14 * plan.capacity}")
    state = sim.state
    dev = state.positions.device
    lj1 = htt.md.LennardJones(1.0, 1.0, r_cut=R_CUT)
    eps = [[1.0, 0.5], [0.5, 0.5]]
    lj2 = htt.md.LennardJones(eps, 1.0, r_cut=R_CUT)
    rcm = [[3.0, 2.2], [2.2, 2.6]]
    types2 = (torch.arange(N, device=dev) % 2).to(torch.int32)
    # the same grid with room for 80 per cell (a self-heal capacity floor
    # can do this): 14*cap = 1120 lanes, more than one pass of the block
    big = dataclasses.replace(plan, capacity=80)
    cases = [("one type", plan, state.types, lj1, None),
             ("two types + rcut_matrix", plan, types2, lj2, rcm),
             ("capacity 80 (14*cap = 1120 lanes)", big, state.types, lj1,
              None)]
    max_err = 0.0
    timing = None
    for label, p, types, pot, rc in cases:
        st = dataclasses.replace(state, types=types)
        layout = SlotLayout(p, N, sim._lo, rc_matrix=rc, device=dev)
        slot, aux = layout.pack(st)
        check(not bool(aux["overflow"]), f"{label}: pack overflowed")
        form = pot.kernel_form()
        geo = layout.geometry
        _, _, _, gx, gy, gz = cw._relative_coords(
            slot.positions, aux["valid"], p, layout.lo, cw._HALF_OFFS, geo)
        gt = cw._roll_offs(slot.types, p, cw._HALF_OFFS)
        occ = aux["valid"].reshape(p.n_cells, p.capacity).sum(1).to(
            torch.int32)
        args = (occ, gx, gy, gz, gt, form, p.capacity, R_CUT ** 2, 1e-4)
        kw = dict(needs_energy=True, needs_virial=True,
                  rc2_tab=layout.rc2_tab)
        print(f" case {label}: grid {p.grid} cap {p.capacity}")
        got = cc.half_stencil_planes(*args, **kw)
        want = cc.half_stencil_reference(*args, **kw)
        torch.cuda.synchronize()
        max_err = max(max_err, compare("planes (kernel vs plain)", got,
                                       want))
        common = (slot.positions, slot.types, aux["valid"], p, layout.lo,
                  pot.pair_energy_and_slope)
        fkw = dict(needs_virial=True, with_types=True,
                   rcut_matrix=layout.rc2_tab, form=form, geometry=geo)
        f_k, w_k = cw.analytic_pair_forces(*common, stencil="kernel", **fkw)
        f_f, w_f = cw.analytic_pair_forces(*common, stencil="full", **fkw)
        max_err = max(max_err, compare("forces+energy (kernel vs full)",
                                       f_k, f_f))
        max_err = max(max_err, compare("virial (kernel vs full)", w_k, w_f))
        if timing is None:
            # the main path's configuration: forces only
            a1 = args[:4] + (None, form) + args[6:]
            t_k = cuda_ms(lambda: cc.half_stencil_planes(
                *a1, needs_energy=False, needs_virial=False))
            t_p = cuda_ms(lambda: cc.half_stencil_reference(
                *a1, needs_energy=False, needs_virial=False), reps=21)
            timing = (t_k, t_p)
            print(f"  time at the main path's shapes (forces only, median "
                  f"of CUDA events): kernel {t_k:.4f} ms, plain "
                  f"{t_p:.4f} ms")
    return max_err, timing


def phase_main():
    """The benchmark protocol through the port's public API."""
    from hoomd_tf_tpu_torch.ops import cellwise_cuda as cc

    k1 = cc.half_stencil_planes
    k1.launches = 0
    sim = jittered_sim(N, htt.md.Minimize(max_disp=0.05), "cuda")
    sim.check_syncs = True
    tfc = htt.tfcompute(make_model())
    tfc.attach(sim, r_cut=R_CUT, nlist="cellwise")
    evals0 = sim.force_evals
    sim.run(60)
    sim.thermalize_velocities(1.5)
    sim.integrator = htt.md.NVT(kT=1.5, tau=0.5)
    t0 = time.perf_counter()
    sim.run(1000)
    for _ in range(4):
        plan = sim._layout.plan
        sim.run(1000)
        if sim._layout.plan == plan:
            break
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    ev_before, l_before = sim.force_evals, k1.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run(1000)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    timed_evals = sim.force_evals - ev_before
    timed_launches = k1.launches - l_before
    launches = k1.launches
    evals = sim.force_evals - evals0
    th = sim.thermo()
    pos = sim.state.positions
    f = sim.state.forces
    check(bool(torch.isfinite(pos).all()), "non-finite positions")
    check(bool(torch.isfinite(f).all()), "non-finite forces")
    check(tuple(f.shape) == (N, 4), f"forces shape {tuple(f.shape)}")
    check(1.1 < th["temperature"] < 1.9,
          f"not a healthy kT=1.5 fluid: {th}")
    check(launches > 0 and launches == evals,
          f"K1 launches {launches} != force evaluations {evals}")
    check(timed_launches == timed_evals,
          f"timed run: K1 launches {timed_launches} != {timed_evals}")
    plan = sim._layout.plan
    print(f"  plan grid {plan.grid} cap {plan.capacity}; warm runs "
          f"{warm_s:.1f} s; T={th['temperature']:.4f} "
          f"PE/N={th['potential_energy'] / N:.4f}")
    print(f"  K1 launches {launches} == force evaluations {evals} "
          f"(timed run: {timed_launches} for {timed_evals}); no host sync "
          f"in the step loops (set_sync_debug_mode('error'))")
    print(f"  steps/s {1000 / dt:.2f} (timed run(1000), N={N}) on "
          f"{smi_line()} -- info, not a claim")

    # small-N trajectory: the CUDA main path against the CPU tensor form
    def small(device):
        s = jittered_sim(512, htt.md.Minimize(max_disp=0.05), device,
                         seed=3)
        htt.tfcompute(make_model()).attach(s, r_cut=2.5, nlist="cellwise")
        return s
    a, b = small("cuda"), small("cpu")
    a.run(30)
    b.run(30)
    pa = a.state.positions.cpu()
    pb = b.state.positions
    L = torch.as_tensor(b._lengths, dtype=pb.dtype)
    d = pa - pb
    d = d - torch.round(d / L) * L
    err = float(d.abs().max())
    fa, fb = a.state.forces.cpu(), b.state.forces
    ferr = float(((fa - fb).abs() / (2e-4 * fb.abs() + 2e-4)).max())
    print(f"  N=512 quench, CUDA kernel path vs CPU tensor form: max "
          f"position diff {err:.3e} (limit 2e-3), force err/bound "
          f"{ferr:.3f}")
    check(err < 2e-3, "small-N trajectory disagrees with the CPU form")
    check(ferr <= 1.0, "small-N forces disagree with the CPU form")
    return launches, 1000 / dt


def main():
    global torch, htt
    if not os.path.isfile(os.path.join(HERE, "hoomd_tf_tpu_torch",
                                       "__init__.py")):
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one card", file=sys.stderr)
        return 2
    import hoomd_tf_tpu_torch as htt
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = smi_line()
    print(f"[1 device] {torch.cuda.get_device_name(0)} "
          f"(count {torch.cuda.device_count()}); nvidia-smi: {smi}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}")

    from hoomd_tf_tpu_torch import _build
    from hoomd_tf_tpu_torch.ops import cellwise_cuda as cc
    t0 = time.perf_counter()
    cc._library()
    secs, log = _build.BUILD_LOG.get("cellwise_half", (0.0, "(cached)"))
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"[2 build] K1 built in {secs:.2f} s "
          f"(load {time.perf_counter() - t0:.2f} s); " + " | ".join(ptxas))

    print("[3 kernels] K1 vs plain PyTorch, rtol = atol = 1e-4")
    max_err, (ms, plain_ms) = phase_kernels()

    print("[4 main] 64k LJ fluid, the benchmark protocol on the port")
    launches, sps = phase_main()
    check("jax" not in sys.modules, "JAX was imported")

    print(smi_line())
    print(json.dumps({"kernels": [{
        "name": "K1 half-stencil pair forces (half_stencil_planes)",
        "route": "cuda",
        "source": "hoomd_tf_tpu_torch/csrc/cellwise_half.cu",
        "replaces": "hoomd_tf_tpu/ops/cellwise_pallas.py:43",
        "launches": launches, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
