#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``hoomd_tf_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing info lines; any failure raises and the script
exits non-zero:

1. device   -- a CUDA card must be present; prints its name and power
               limit as nvidia-smi reports them;
2. build    -- compiles kernel K1 (csrc/cellwise_half.cu, LJ and
               Chebyshev-proxy forms), kernel K2 (csrc/proxy_bwd.cu) and
               kernel K3 (csrc/nlist_select.cu) with nvcc, one process per
               source started together, printing ptxas registers and
               spills;
3. kernels  -- K1's LJ form against its plain PyTorch version and the
               full-stencil tensor form at the 64k fluid's shapes (one-
               and two-type potentials, a per-type cutoff matrix, and a
               capacity whose 14*cap exceeds 1024 lanes), plus both times;
4. main     -- the eval protocol through the public API: a 64k LJ fluid
               at density 0.4, r_cut 3, PairModel + cellwise, Minimize
               quench, thermalize, NVT at kT 1.5, warm runs, a timed
               run(1000) with host syncs forbidden in the step loop, and a
               small-N trajectory against the CPU tensor form;
5. train    -- online training (benchmarks/north_star.py's flagship row)
               through the public API at N = 65536: a proxy NN pair
               potential (MLP on 1/r, widths 16 -> 1, K = 16) trained
               with Adam at lr 1e-2 against built-in LJ labels during
               live NVT; then K1's proxy form and K2 against their plain
               versions at the train plan's shapes, and a small-N SGD
               trajectory on the card against the CPU;
6. packed   -- the JAX package's typical use through the public API: a
               generic SimModel (LJ from nlist_rinv, NN = 64) attached
               with attach(sim, r_cut=3.0), which on the card resolves
               to the cell list with kernel K3; the 64k fluid's protocol
               (quench, thermalize, NVT, warm runs, a timed run with host
               syncs forbidden); K3 against its plain version and the
               topk yardstick at the path's shapes; a small-N step on the
               card against the CPU; a 20-step torch.profiler window.

Each path runs with the launch counts set to 0 just before it and read
just after. The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N = 65536
DENSITY = 0.4
R_CUT = 3.0
K_PROXY = 16
# Tolerance of K1 against its plain version: rtol = atol = 1e-4, the JAX
# package's own bar for its Pallas kernel (tests/test_cellwise.py).
RTOL = ATOL = 1e-4
# K2 against its plain version: rtol 2e-4, atol 2e-5 * max|g|, the JAX
# package's bar for its Pallas proxy backward (tests/test_pair_train.py).
K2_RTOL, K2_ATOL_REL = 2e-4, 2e-5
# K3 against its plain version: the same order, displacements at 1e-6 (the
# arithmetic is the same IEEE operations, so the expected error is 0).
# Steps of the timed packed run.
PACKED_STEPS = 500
# Published peaks of one H100 SXM at 700 W: HBM 3.35 TB/s, float32 outside
# the tensor cores 67 TFLOP/s (NVIDIA's data sheet).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12


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


def compare(name, got, want, rtol=RTOL, atol=ATOL):
    """max |got - want| and the worst ratio to atol + rtol * |want|."""
    err = (got - want).abs()
    bound = atol + rtol * want.abs()
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


def bound(nbytes, ops):
    """The least time (ms) the card could take: the larger of the bytes
    over the memory rate and the float32 operations over their peak."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def lane_counts(occ, gx, gy, gz, cap, rc2, gt=None, rc2_tab=None):
    """``(evaluated, inside)``: the pair lanes a half-stencil pass walks on
    these inputs (every candidate lane of each occupied row) and those
    inside the cut (the pair function runs there), counted on the card."""
    from hoomd_tf_tpu_torch.ops.cellwise import pair_rc2
    n_cells, C = gx.shape
    row = torch.arange(cap, device=gx.device)[:, None]
    col = torch.arange(C, device=gx.device)[None, :]
    inside = 0
    step = max(1, (1 << 24) // (cap * C))
    for a in range(0, n_cells, step):
        s = slice(a, a + step)
        d2 = sum((g[s, None, :] - g[s, :cap, None]) ** 2
                 for g in (gx, gy, gz))
        ok = (d2 <= rc2) & (col != row)[None] & \
            (row[None] < occ[s, None, None])
        if rc2_tab is not None:
            ok = ok & (d2 <= pair_rc2(gt[s, :cap, None], gt[s, None, :],
                                      rc2_tab))
        inside += int(ok.sum())
    return int(occ.sum()) * C, inside


def k1_cost(occ, gx, gy, gz, gt, cap, rc2, rc2_tab, n_ch, form):
    """Bytes and float32 operations of one K1 call on these inputs. Per
    walked lane: the displacement, d2 and the cut test (9 operations);
    per lane inside the cut: the pair form (LJ 14, the proxy's two
    Clenshaw series 8K + 10) and, per channel, the product and its two
    sums (3)."""
    from hoomd_tf_tpu_torch.ops.cellwise_cuda import ChebForm
    walked, inside = lane_counts(occ, gx, gy, gz, cap, rc2, gt, rc2_tab)
    planes = 3 + (gt is not None)
    nbytes = 4 * (planes * gx.numel() + occ.numel() + n_ch * gx.numel()) \
        + form.tensor(gx.device).numel() * 4
    per = 8 * form.K + 10 if isinstance(form, ChebForm) else 14
    return nbytes, 9 * walked + inside * (per + 3 * n_ch)


def k2_cost(occ, gx, gy, gz, gt, cap, rc2, rc2_tab, K, energy, M):
    """Bytes and float32 operations of one K2 call on these inputs. Per
    walked lane 9 operations; per lane inside the cut 27 (weights, u, w)
    plus, per term, the recurrence (2) and each moment's multiply-add (2
    per moment set)."""
    walked, inside = lane_counts(occ, gx, gy, gz, cap, rc2, gt, rc2_tab)
    planes = 6 + energy + (gt is not None)
    nbytes = 4 * (planes * gx.numel() + occ.numel() + M)
    return nbytes, 9 * walked + inside * (27 + K * (2 + 2 * (1 + energy)))


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


def make_nn(seed=0, proxy_degree=K_PROXY):
    """north_star.py's TrainableNNPair: a per-lane MLP on 1/r (widths
    16 -> 1), random weights from ``seed``."""
    gen = torch.Generator().manual_seed(seed)

    class NNPair(htt.PairModel):
        def setup(self):
            self.dense1 = htt.Dense(16, generator=gen)
            self.last = htt.Dense(1, generator=gen)

        def pair_energy(self, r2):
            x = torch.tanh(self.dense1(torch.rsqrt(r2)[..., None]))
            return 2.0 * self.last(x)[..., 0]
    return NNPair(64, output_forces=False, proxy_degree=proxy_degree)


def force_loss(yt, yp):
    """Force matching on forces[:, :3] (north_star.py's proxy row)."""
    return torch.mean((yt[:, :3] - yp[:, :3]) ** 2)


def jittered_sim(n, integrator, device, seed=0):
    import numpy as np
    sim = htt.Simulation(dt=0.005, integrator=integrator, seed=seed,
                         device=device)
    sim.init_lattice(n, density=DENSITY, kT_init=1.5)
    rng = np.random.RandomState(seed)
    sim.state.positions = sim.state.positions + torch.as_tensor(
        0.3 * rng.randn(n, 3).astype(np.float32), device=device)
    return sim


def slot_planes(layout, state):
    """Pack ``state`` into ``layout`` and build K1's / K2's input planes:
    ``(slot, aux, occ, gx, gy, gz, gt)``."""
    from hoomd_tf_tpu_torch.ops import cellwise as cw
    p = layout.plan
    slot, aux = layout.pack(state)
    check(not bool(aux["overflow"]), "pack overflowed")
    _, _, _, gx, gy, gz = cw._relative_coords(
        slot.positions, aux["valid"], p, layout.lo, cw._HALF_OFFS,
        layout.geometry)
    gt = cw._roll_offs(slot.types, p, cw._HALF_OFFS)
    occ = aux["valid"].reshape(p.n_cells, p.capacity).sum(1).to(torch.int32)
    return slot, aux, occ, gx, gy, gz, gt


def make_simmodel(nn=64):
    """The JAX package's typical use (hoomd_tf_tpu/__init__.py), jnp.sum
    -> torch.sum: LJ (epsilon = sigma = 1) from nlist_rinv, forces by
    autodiff."""
    class LJModel(htt.SimModel):
        def compute(self, nlist, positions, box):
            rinv = htt.nlist_rinv(nlist)
            inv_r6 = rinv ** 6
            energy = torch.sum(4.0 / 2.0 * (inv_r6 * inv_r6 - inv_r6),
                               dim=1)
            return htt.compute_nlist_forces(nlist, energy)
    return LJModel(nn)


def k3_cost(slots4, counts, grid, cap, nn, n, valid_per_row):
    """Bytes and operations of one K3 call on these inputs: the slot rows,
    counts and particle ids read once, the [n, nn, 4] list written once;
    per real candidate pair (each query slot against the occupied slots
    of its 27 cells) ~24 float operations (3 subtractions, 3 divisions,
    3 roundings, 3 multiply-subtracts, d2's 5, the cut tests and the
    key), and per query ``valid^2`` key comparisons of the ranking."""
    from hoomd_tf_tpu_torch.ops.cell_stencil import neighbor_cells
    neigh = neighbor_cells(grid, counts.device)
    cand = counts.long()[neigh].sum(1)
    pairs = int((counts.long() * cand).sum())
    nbytes = slots4.numel() * 4 + counts.numel() * 4 + \
        slots4.shape[0] * 4 + n * nn * 16
    v = valid_per_row.double()
    return nbytes, 24 * pairs + float((v * v).sum()), pairs


def phase_packed():
    """The packed path through the public API at the 64k fluid."""
    import numpy as np
    from hoomd_tf_tpu_torch.ops import cell_list as cl
    from hoomd_tf_tpu_torch.ops import cell_stencil as cs
    from hoomd_tf_tpu_torch.ops import nlist_cuda as nc
    from hoomd_tf_tpu_torch.ops.box import box_size

    k3 = nc.nlist_select
    NN = 64
    sim = jittered_sim(N, htt.md.Minimize(max_disp=0.05), "cuda")
    sim.check_syncs = True
    htt.tfcompute(make_simmodel(NN)).attach(sim, r_cut=R_CUT)
    build = sim._packed_build()
    check(build.method == "pallas",
          f"'auto' resolved to {build.method!r} on the card, not K3")
    grid, cap = build.plan
    print(f"  'auto' on the card -> cell list + K3; plan grid {grid} "
          f"({int(np.prod(grid))} cells), capacity {cap}, candidates "
          f"27*cap = {27 * cap} per query, NN {NN}")
    k3.launches = 0
    builds0 = sim.nlist_builds
    t0 = time.perf_counter()
    sim.run(60)
    sim.thermalize_velocities(1.5)
    sim.integrator = htt.md.NVT(kT=1.5, tau=0.5)
    sim.run(200)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    steps = PACKED_STEPS
    b_before, l_before = sim.nlist_builds, k3.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run(steps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = k3.launches
    builds = sim.nlist_builds - builds0
    timed_builds = sim.nlist_builds - b_before
    timed_launches = launches - l_before
    th = sim.thermo()
    pos, f = sim.state.positions, sim.state.forces
    check(bool(torch.isfinite(pos).all()), "non-finite positions")
    check(bool(torch.isfinite(f).all()), "non-finite forces")
    check(tuple(f.shape) == (N, 4), f"forces shape {tuple(f.shape)}")
    check(1.1 < th["temperature"] < 1.9, f"not a healthy kT=1.5 fluid: {th}")
    check(launches > 0 and launches == builds,
          f"K3 launches {launches} != nlist builds {builds}")
    check(timed_launches == timed_builds == steps,
          f"timed run: K3 launches {timed_launches}, builds {timed_builds}")
    grid, cap = sim._packed_build().plan
    print(f"  NVT plan grid {grid} cap {cap}; warm runs {warm_s:.1f} s; "
          f"T={th['temperature']:.4f} PE/N={th['potential_energy'] / N:.4f}")
    print(f"  K3 launches {launches} == nlist builds {builds} (timed run: "
          f"{timed_launches}); no host sync in the step loops "
          f"(set_sync_debug_mode('error'))")
    print(f"  steps/s {steps / dt:.2f} (timed run({steps}), N={N}, NN={NN}) "
          f"on {smi_line()} -- info, not a claim")

    # K3 against its plain version at the path's shapes
    st = sim.state
    lengths = box_size(st.box)
    host_L = tuple(float(v) for v in lengths.cpu())
    slots4, counts, pid, ovf = cl.build_planes(st.positions4, grid, cap,
                                               lengths)
    check(not bool(ovf), "the state overflows its own plan")
    args = (slots4, counts, pid, grid, cap, NN, R_CUT, host_L, N)
    got = k3(*args)
    want = nc.nlist_select_reference(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    same_order = bool(torch.equal(got[..., 3], want[..., 3])) and \
        bool(torch.equal(got != 0, want != 0))
    n_nb = (got[..., :3] != 0).any(-1).sum(1)
    print(f"  K3 vs plain: max_abs_err={err:.3e}, order identical: "
          f"{same_order}; neighbors per particle mean "
          f"{float(n_nb.float().mean()):.2f} max {int(n_nb.max())}")
    check(same_order and err <= 1e-6, "K3 disagrees with its plain version")
    t_k = cuda_ms(lambda: k3(*args))
    t_p = cuda_ms(lambda: nc.nlist_select_reference(*args), reps=5)
    # the yardstick: torch.topk's selection over the plain version's keys
    neigh = cs.neighbor_cells(grid, slots4.device)
    ddx, ddy, ddz, _, _, _ = cs.chunk_pairs(slots4, neigh, cap, lengths,
                                             0, int(np.prod(grid)))
    C = 27 * cap
    key, _ = nc.selection_keys(ddx.reshape(-1, C), ddy.reshape(-1, C),
                               ddz.reshape(-1, C), R_CUT, nc.slot_bits(C))
    del ddx, ddy, ddz
    occupied = (pid >= 0)
    valid = ((key != nc.FAR_KEY).sum(1))[occupied]
    t_lib = cuda_ms(lambda: torch.topk(key, NN, dim=1, largest=False,
                                       sorted=True), reps=5)
    nbytes, ops, pairs = k3_cost(slots4, counts, grid, cap, NN, N, valid)
    del key
    b_ms, b_by = bound(nbytes, ops)
    print(f"  K3 time (median of CUDA events): kernel {t_k:.4f} ms, plain "
          f"{t_p:.4f} ms, topk yardstick (selection only, keys given) "
          f"{t_lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.1f} "
          f"MB, {ops / 1e9:.3f} G operations over {pairs} candidate pairs)")
    rec = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
               library_ms=t_lib, max_abs_err=err, launches=launches)

    # small N: one step on the card against the port on the CPU
    q = jittered_sim(4096, htt.md.Minimize(max_disp=0.05), "cpu", seed=3)
    htt.tfcompute(make_simmodel(NN)).attach(q, r_cut=R_CUT, nlist="pallas")
    q.run(30)
    q.thermalize_velocities(1.5)
    res = {}
    for dev, mode in (("cuda", None), ("cpu", "pallas")):
        s = htt.Simulation(dt=0.005, integrator=htt.md.NVT(kT=1.5, tau=0.5),
                           seed=0, device=dev)
        fields = {k.name: getattr(q.state, k.name).to(dev)
                  for k in dataclasses.fields(q.state)
                  if torch.is_tensor(getattr(q.state, k.name))}
        s.set_state(dataclasses.replace(q.state, thermostat={}, **fields))
        htt.tfcompute(make_simmodel(NN)).attach(s, r_cut=R_CUT, nlist=mode)
        s.run(1)
        res[dev] = (s.state.positions.cpu(), s.state.forces.cpu(),
                    s._packed_build().method)
    check(res["cuda"][2] == "pallas", "small-N card run did not take K3")
    perr = float((res["cuda"][0] - res["cpu"][0]).abs().max())
    ferr = float((res["cuda"][1] - res["cpu"][1]).abs().max())
    fmax = float(res["cpu"][1][:, :3].abs().max())
    print(f"  N=4096, one NVT step, card (K3) vs CPU (plain K3): max "
          f"position diff {perr:.3e} (limit 1e-6), max force diff "
          f"{ferr:.3e} (limit 1e-4; max|F| {fmax:.2f})")
    check(perr <= 1e-6, "small-N positions disagree with the CPU")
    check(ferr <= 1e-4, "small-N forces disagree with the CPU")

    # a short profiler window: kernels per step, busy share, K3's share
    from torch.profiler import ProfilerActivity, profile
    sim.check_syncs = False
    sim.run(5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run(20)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.events()
            if getattr(e, "device_type", None) is not None and
            e.device_type.name == "CUDA"]
    if kern:
        busy = sum(e.time_range.elapsed_us() for e in kern)
        k3_us = sum(e.time_range.elapsed_us() for e in kern
                    if "nlist_select" in e.name)
        top = {}
        for e in kern:
            top[e.name] = top.get(e.name, 0.0) + e.time_range.elapsed_us()
        print(f"  profiler, 20 NVT steps: {len(kern) / 20:.1f} kernels per "
              f"step, device busy {busy / wall_us:.3f} of {wall_us / 20:.1f} "
              f"us per step, K3 {k3_us / busy:.3f} of device time")
        for name, us in sorted(top.items(), key=lambda x: -x[1])[:6]:
            print(f"    {us / 20:9.1f} us/step  {name[:90]}")
    else:
        print("  profiler: no device events recorded (timing above is by "
              "CUDA events)")
    return rec


def phase_kernels():
    """K1's LJ form vs plain at the shapes the eval path gives it."""
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
    rec = None
    for label, p, types, pot, rc in cases:
        st = dataclasses.replace(state, types=types)
        layout = SlotLayout(p, N, sim._lo, rc_matrix=rc, device=dev)
        slot, aux, occ, gx, gy, gz, gt = slot_planes(layout, st)
        form = pot.kernel_form()
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
                   rcut_matrix=layout.rc2_tab, form=form, geometry=layout.geometry)
        f_k, w_k = cw.analytic_pair_forces(*common, stencil="kernel", **fkw)
        f_f, w_f = cw.analytic_pair_forces(*common, stencil="full", **fkw)
        max_err = max(max_err, compare("forces+energy (kernel vs full)",
                                       f_k, f_f))
        max_err = max(max_err, compare("virial (kernel vs full)", w_k, w_f))
        if rec is None:
            # the main path's configuration: forces only
            a1 = args[:4] + (None, form) + args[6:]
            t_k = cuda_ms(lambda: cc.half_stencil_planes(
                *a1, needs_energy=False, needs_virial=False))
            t_p = cuda_ms(lambda: cc.half_stencil_reference(
                *a1, needs_energy=False, needs_virial=False), reps=21)
            b_ms, b_by = bound(*k1_cost(occ, gx, gy, gz, None, p.capacity,
                                        R_CUT ** 2, None, 3, form))
            rec = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by)
            print(f"  time at the main path's shapes (forces only, median "
                  f"of CUDA events): kernel {t_k:.4f} ms, plain "
                  f"{t_p:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    rec["max_abs_err"] = max_err
    return rec


def phase_main():
    """The eval protocol through the port's public API."""
    from hoomd_tf_tpu_torch.ops import cellwise_cuda as cc

    k1 = cc.half_stencil_planes
    sim = jittered_sim(N, htt.md.Minimize(max_disp=0.05), "cuda")
    sim.check_syncs = True
    tfc = htt.tfcompute(make_model())
    tfc.attach(sim, r_cut=R_CUT, nlist="cellwise")
    k1.launches = k1.proxy_launches = 0
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
    launches = k1.launches
    timed_evals = sim.force_evals - ev_before
    timed_launches = launches - l_before
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
    check(k1.proxy_launches == 0, "the eval path launched the proxy form")
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
    return launches


def train_sim_attached():
    """north_star.py's flagship set-up on the port: the 64k fluid quenched
    and equilibrated (NVT, 400 steps) under a built-in LJ, which stays as
    the labels and the driving forces, then the proxy NN compiled (Adam,
    lr 1e-2) and attached with train=True: ``(sim, model)``."""
    sim = jittered_sim(N, htt.md.Minimize(max_disp=0.05), "cuda")
    sim.add_force(htt.md.LennardJones(r_cut=R_CUT))
    sim.run(60)
    sim.thermalize_velocities(1.5)
    sim.integrator = htt.md.NVT(kT=1.5, tau=0.5)
    sim.run(400)
    th = sim.thermo()
    print(f"  equilibrated: T={th['temperature']:.4f}")
    check(1.1 < th["temperature"] < 1.9,
          f"training system is not a healthy kT=1.5 fluid: {th}")
    model = make_nn()
    model.compile(optimizer="adam", loss=force_loss, learning_rate=1e-2)
    htt.tfcompute(model).attach(sim, r_cut=R_CUT, nlist="cellwise",
                                train=True)
    return sim, model


def warm_train(sim):
    """The protocol's training before its timed window: run(400), a
    replan, run(200), then the plan held fixed."""
    sim.run(400)
    sim.replan()
    sim.run(200)
    sim.auto_replan = False


def phase_train():
    """north_star.py's flagship protocol on the port: the set-up of
    :func:`train_sim_attached`, the warm training of :func:`warm_train`,
    then timed rounds, all under check_syncs."""
    import numpy as np
    from hoomd_tf_tpu_torch.ops import cellwise_cuda as cc
    from hoomd_tf_tpu_torch.ops import pair_train_cuda as pc

    k1, k2 = cc.half_stencil_planes, pc.proxy_bwd_planes
    sim, model = train_sim_attached()
    tfc = sim.tfc
    sim.check_syncs = True
    k1.launches = k1.proxy_launches = k2.launches = 0
    evals0, steps0 = sim.force_evals, sim.train_steps
    warm_train(sim)
    loss0 = float(np.mean(tfc.loss_history[:50]))
    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.run(200)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = dict(lj=k1.launches - k1.proxy_launches,
                    proxy=k1.proxy_launches, k2=k2.launches)
    evals = sim.force_evals - evals0
    steps = sim.train_steps - steps0
    hist = tfc.loss_history
    loss1 = float(np.mean(hist[-50:]))
    th = sim.thermo()
    check(len(hist) == steps == 1400, f"{len(hist)} losses, {steps} steps")
    check(bool(np.isfinite(hist).all()), "non-finite training loss")
    check(bool(torch.isfinite(sim.state.positions).all()),
          "non-finite positions")
    check(bool(torch.isfinite(sim.state.forces).all()), "non-finite forces")
    check(1.1 < th["temperature"] < 1.9, f"unhealthy fluid after: {th}")
    check(launches["k2"] == steps, f"K2 launches {launches['k2']} != "
          f"train steps {steps}")
    check(launches["proxy"] == steps,
          f"K1 proxy launches {launches['proxy']} != train steps {steps}")
    check(k1.launches == evals, f"K1 launches {k1.launches} != built-in "
          f"+ model-forward evaluations {evals}")
    check(loss1 < 0.3 * loss0, f"loss did not fall: {loss0} -> {loss1}")
    plan = sim._layout.plan
    best = min(times)
    print(f"  plan grid {plan.grid} cap {plan.capacity}; T={th['temperature']:.4f}")
    print(f"  launches: K2 {launches['k2']} == train steps {steps}; K1 "
          f"{k1.launches} == evaluations {evals} (LJ labels "
          f"{launches['lj']}, proxy forward {launches['proxy']}); no host "
          f"sync in the step loops")
    print(f"  loss (50-step windows) {loss0:.4f} -> {loss1:.4f} "
          f"(ratio {loss1 / loss0:.4f}, limit 0.3)")
    print(f"  train steps/s {200 / best:.2f} (best of 4 timed run(200), "
          f"rounds {[round(t, 3) for t in times]} s, N={N}) on "
          f"{smi_line()} -- info, not a claim")
    return sim, model, launches


def phase_train_kernels(sim, model):
    """K1's proxy form and K2 against their plain versions at the train
    plan's shapes, with the trained model's coefficients."""
    import numpy as np
    from hoomd_tf_tpu_torch.md.slots import SlotLayout
    from hoomd_tf_tpu_torch.ops import cellwise_cuda as cc
    from hoomd_tf_tpu_torch.ops import pair_train_cuda as pc
    from hoomd_tf_tpu_torch.ops.chebyshev import make_typed_pair_proxy

    layout = sim._layout
    p = layout.plan
    dev = sim.device
    print(f" train plan: grid {p.grid} cap {p.capacity}")
    rc2 = R_CUT ** 2
    r2_lo = (0.25 * R_CUT) ** 2
    state = sim.state
    types2 = (torch.arange(N, device=dev) % 2).to(torch.int32)
    types3 = (torch.arange(N, device=dev) % 3).to(torch.int32)
    rcm = [[3.0, 2.2], [2.2, 2.6]]

    def typed_proxy(T):
        fit, ev = make_typed_pair_proxy(K_PROXY, r2_lo, rc2, T, device=dev)

        def energy(r2, ti, tj):
            return model.pair_energy(r2) / (1.0 + ti + tj)
        with torch.no_grad():
            return ev, fit(energy)

    with torch.no_grad():
        form1 = model.pair_kernel_form(R_CUT, dev)
    basis1 = model.proxy_parts(R_CUT, dev)[1].basis
    ev2, co2 = typed_proxy(2)
    ev3, co3 = typed_proxy(3)

    # K1, proxy form
    k1_err = 0.0
    k1_rec = None
    for label, types, form, rc in (
            ("untyped K=16", None, form1, None),
            ("two types + rcut_matrix", types2, ev2.kernel_form(co2), rcm)):
        st = state if types is None else dataclasses.replace(state,
                                                             types=types)
        lay = SlotLayout(p, N, sim._lo, rc_matrix=rc, device=dev)
        _, _, occ, gx, gy, gz, gt = slot_planes(lay, st)
        gt = gt if (form.ntypes > 1 or rc is not None) else None
        args = (occ, gx, gy, gz, gt, form, p.capacity, rc2, model.min_r2)
        kw = dict(needs_energy=True, needs_virial=True, rc2_tab=lay.rc2_tab)
        got = cc.half_stencil_planes(*args, **kw)
        want = cc.half_stencil_reference(*args, **kw)
        torch.cuda.synchronize()
        k1_err = max(k1_err, compare(f"K1 proxy {label} (kernel vs plain)",
                                     got, want))
        if k1_rec is None:
            # the train path's forward: forces only
            t_k = cuda_ms(lambda: cc.half_stencil_planes(
                *args, needs_energy=False, needs_virial=False))
            t_p = cuda_ms(lambda: cc.half_stencil_reference(
                *args, needs_energy=False, needs_virial=False), reps=5)
            b_ms, b_by = bound(*k1_cost(occ, gx, gy, gz, None, p.capacity,
                                        rc2, None, 3, form))
            k1_rec = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by)
            print(f"  K1 proxy time (forces only, the train forward): "
                  f"kernel {t_k:.4f} ms, plain {t_p:.4f} ms, bound "
                  f"{b_ms:.4f} ms ({b_by})")
    k1_rec["max_abs_err"] = k1_err

    # K2
    rng = np.random.RandomState(0)
    ct = torch.as_tensor(rng.randn(p.n_slots, 4).astype(np.float32),
                         device=dev)
    k2_err = 0.0
    k2_rec = None
    for label, types, basis, rc, energy in (
            ("untyped, forces only (the train path)", None, basis1, None,
             False),
            ("untyped with energy", None, basis1, None, True),
            ("two types + rcut_matrix", types2, ev2.basis, rcm, True),
            ("three types (2*K*P = 192 > 128)", types3, ev3.basis, None,
             True)):
        st = state if types is None else dataclasses.replace(state,
                                                             types=types)
        lay = SlotLayout(p, N, sim._lo, rc_matrix=rc, device=dev)
        slot, aux, occ, gx, gy, gz, gt = slot_planes(lay, st)
        typed = basis["pairs"] is not None or rc is not None
        gt = gt if typed else None
        ctv = ct * aux["valid"][:, None]
        from hoomd_tf_tpu_torch.ops.cellwise import _roll_offs, _HALF_OFFS
        cg = [_roll_offs(ctv[:, k].contiguous(), p, _HALF_OFFS)
              for k in range(4)]
        args = (occ, gx, gy, gz, gt, cg[0], cg[1], cg[2],
                cg[3] if energy else None, basis, p.capacity, rc2,
                model.min_r2, lay.rc2_tab)
        got = pc.proxy_bwd_planes(*args)
        want = pc.proxy_bwd_reference(*args)
        torch.cuda.synchronize()
        M = got.numel()
        scale = float(want.abs().max())
        k2_err = max(k2_err, compare(f"K2 {label}, {M} moments (kernel vs "
                                     f"plain)", got, want, rtol=K2_RTOL,
                                     atol=K2_ATOL_REL * scale))
        if k2_rec is None:
            t_k = cuda_ms(lambda: pc.proxy_bwd_planes(*args))
            t_p = cuda_ms(lambda: pc.proxy_bwd_reference(*args), reps=5)
            b_ms, b_by = bound(*k2_cost(occ, gx, gy, gz, gt, p.capacity, rc2,
                                        None, K_PROXY, energy, M))
            k2_rec = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by)
            print(f"  K2 time (forces-only cotangent, the train path): "
                  f"kernel {t_k:.4f} ms, plain {t_p:.4f} ms, bound "
                  f"{b_ms:.4f} ms ({b_by})")
    k2_rec["max_abs_err"] = k2_err
    return k1_rec, k2_rec


def phase_train_small():
    """A 20-step SGD training trajectory at N = 512: the card against the
    port on the CPU, from the same state and weights."""
    runs = {}
    state = weights = None
    for dev in ("cpu", "cuda"):
        sim = htt.Simulation(dt=0.005, integrator=htt.md.NVT(kT=1.5, tau=0.5),
                             seed=0, device=dev)
        if state is None:
            q = jittered_sim(512, htt.md.Minimize(max_disp=0.05), "cpu",
                             seed=3)
            q.add_force(htt.md.LennardJones(r_cut=2.5))
            q.run(30)
            q.thermalize_velocities(1.5)
            state = q.state
        fields = {f.name: getattr(state, f.name).to(dev)
                  for f in dataclasses.fields(state)
                  if torch.is_tensor(getattr(state, f.name))}
        sim.set_state(dataclasses.replace(state, thermostat={}, **fields))
        sim.add_force(htt.md.LennardJones(r_cut=2.5))
        model = make_nn(seed=1)
        model.compile(optimizer="sgd", loss=force_loss, learning_rate=1e-3)
        htt.interop.build_model(model, 2.5, dev)
        if weights is None:
            weights = model.get_weights()
        model.set_weights(weights)
        tfc = htt.tfcompute(model)
        tfc.attach(sim, r_cut=2.5, nlist="cellwise", train=True)
        sim.check_syncs = dev == "cuda"
        sim.run(20)
        runs[dev] = torch.tensor(tfc.loss_history)
    worst = float(((runs["cuda"] - runs["cpu"]).abs() /
                   runs["cpu"].abs()).max())
    print(f"  N=512, 20 SGD train steps, card vs CPU: worst relative loss "
          f"difference {worst:.3e} (limit 1e-3)")
    check(worst < 1e-3, "small-N training disagrees with the CPU run")


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
    import hoomd_tf_tpu_torch.interop  # noqa: F401
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    smi = smi_line()
    print(f"[1 device] {torch.cuda.get_device_name(0)} "
          f"(count {torch.cuda.device_count()}); nvidia-smi: {smi}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}")

    from hoomd_tf_tpu_torch import _build
    from hoomd_tf_tpu_torch.ops import cellwise_cuda as cc
    from hoomd_tf_tpu_torch.ops import pair_train_cuda as pc
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    from hoomd_tf_tpu_torch.ops import nlist_cuda as nc
    sources = ["cellwise_half", "proxy_bwd", "nlist_select"]
    # one nvcc per source, started together
    with ThreadPoolExecutor(len(sources)) as ex:
        list(ex.map(_build.build_shared_library, sources))
    cc._library()
    pc._library()
    nc._library()
    print(f"[2 build] built in {time.perf_counter() - t0:.2f} s")
    for name in sources:
        secs, log = _build.BUILD_LOG.get(name, (0.0, "(cached)"))
        lines = log.splitlines()
        for i, ln in enumerate(lines):
            if "Compiling entry function" in ln:
                # the kernel's name and template arguments, unmangled enough
                # to tell the variants apart
                entry = re.sub(r"^.*?_cu_[0-9a-f]+\d+", "", ln.split("'")[1])
                stats = "; ".join(
                    x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                    if "registers" in x or "spill" in x)
                print(f"  {name} ({secs:.2f} s) {entry[:60]}: {stats}")

    print("[3 kernels] K1 (LJ form) vs plain PyTorch, rtol = atol = 1e-4")
    k1_lj = phase_kernels()

    print("[4 main] 64k LJ fluid, the eval protocol on the port")
    k1_lj["launches"] = phase_main()

    print("[5 train] 64k online training, north_star.py's flagship row")
    sim, model, launches = phase_train()
    k1_lj["launches"] += launches["lj"]
    k1_px, k2 = phase_train_kernels(sim, model)
    k1_px["launches"], k2["launches"] = launches["proxy"], launches["k2"]
    phase_train_small()

    print("[6 packed] 64k generic SimModel on the packed path (K3)")
    k3 = phase_packed()
    check("jax" not in sys.modules, "JAX was imported")
    print(f"  total {time.perf_counter() - t_start:.1f} s")

    rows = [
        dict(name="K1 half-stencil pair forces, LJ form "
                  "(half_stencil_planes)",
             source="hoomd_tf_tpu_torch/csrc/cellwise_half.cu", **k1_lj),
        dict(name="K1 half-stencil pair forces, Chebyshev-proxy form "
                  "(half_stencil_planes)",
             source="hoomd_tf_tpu_torch/csrc/cellwise_half.cu", **k1_px),
        dict(name="K2 Chebyshev-proxy backward moments (proxy_bwd_planes)",
             source="hoomd_tf_tpu_torch/csrc/proxy_bwd.cu",
             replaces="hoomd_tf_tpu/ops/pair_train_pallas.py:80", **k2),
        dict(name="K3 cell-list neighbor selection (nlist_select); "
                  "library_ms: torch.topk, selection only",
             source="hoomd_tf_tpu_torch/csrc/nlist_select.cu",
             replaces="hoomd_tf_tpu/ops/nlist_pallas.py:43", **k3),
    ]
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels = []
    for r in rows:
        r.setdefault("replaces", "hoomd_tf_tpu/ops/cellwise_pallas.py:43")
        # no single PyTorch call computes K1's or K2's function
        r.setdefault("library_ms", None)
        r["route"] = "cuda"
        kernels.append({k: r[k] for k in keys})
    print(smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
