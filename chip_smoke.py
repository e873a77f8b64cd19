#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``hoomd_tf_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing info lines; any failure raises and the script
exits non-zero:

1. device   -- a CUDA card must be present; prints its name and power
               limit as nvidia-smi reports them;
2. build    -- compiles kernel K1 (csrc/cellwise_half.cu, LJ and
               Chebyshev-proxy forms; csrc/cellwise_generic.cu, the
               generic form), kernel K2 (csrc/proxy_bwd.cu), all on the
               shared staging of csrc/half_stencil_stage.cuh, and
               kernel K3 (csrc/nlist_select.cu) with nvcc, one process per
               source started together, printing ptxas registers and
               spills;
3. kernels  -- K1's LJ form against its plain PyTorch version and the
               full-stencil tensor form at the 64k fluid's shapes (one-
               and two-type potentials, a per-type cutoff matrix, and
               capacities 80 and 200, whose 14 staged cells span many
               chunks of the thread block), plus both times;
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
               syncs forbidden); K3 against its plain version at the
               path's shapes, at a 3x3x3 grid and at the path's state
               unwrapped by whole boxes; K3's whole call, its kernel
               alone and its kernels per call (one) by the profiler, and
               the topk yardstick; a small-N step on the card against
               the CPU; a 20-step torch.profiler window;
7. generic  -- a generic SimModel, LJPotential(64), on 'cellwise' at the
               64k fluid through the public API: the lane-separability
               probe validates it, its synthesized pair function runs in
               K1's generic form (csrc/cellwise_generic.cu: a list
               kernel, the pair function in PyTorch, a reduction kernel
               from the list kernel's records, the finish) at every force
               evaluation;
               the eval protocol with a timed run(1000), host syncs
               forbidden; after each run the list's budget against the
               lanes the run needed; the timed run re-runs nothing and its
               list is at most 1.15x its need; at one state the generic
               form against its plain version and against K1's LJ form,
               its whole call, its kernels by the profiler and the pair
               function's share, the bound;
8. nn       -- NeuralPairPotential() at the JAX package's widths, weights
               from a seed, on 'cellwise' from phase 7's fluid: validated
               by the probe, 100 NVT steps with finite positions and
               forces, the list against its need; the generic form
               against its plain version and the planes route (autograd,
               in row chunks) at one state;
9. direct   -- LJPotential(64) with nlist='direct' from phase 7's fluid:
               its forces against the packed K3 route (NN 128) at one
               state, then a timed run(500), host syncs forbidden;
10. train-pair -- north_star.py's non-proxy PairModel row through the
               public API at N = 65536: TrainableNNPair(64) (MLP on 1/r,
               16 -> 1) trained with Adam at lr 1e-2 against the built-in
               LJ with phase 5's protocol (1400 committed steps, host
               syncs forbidden): K1's generic form forward and the
               backward kernel generic_reduce_bwd at every train step, K1's
               LJ form for the labels; the loss must fall below 0.3x; the
               parts of one step by CUDA events and the peak memory; then
               generic_reduce_bwd against its plain version lane by lane
               and the weights' gradient against the lane contraction, and
               the training forward against its plain version;
11. train-generic -- north_star.py's generic SimModel row (TrainableNN(64),
               reference example 08's form): the probe must validate it,
               then as phase 10 through its synthesized pair function;
12. train-packed -- reference example 08's NNPotential trained on the
               packed path (K3) at N = 4096 with period 2, 200 steps;
13. langevin -- phase 4's 64k fluid and model: a quench, then
               Langevin(kT=1.5, gamma=1.0) with a timed run(1000), host
               syncs forbidden, 1.1 < T < 1.9; 50 steps run twice from one
               state and one seed, the second forced through a capacity-
               overflow rollback, positions equal to 1e-5; Brownian(kT=1.5)
               for 200 steps (dt 2e-4), finite and moved;
14. npt      -- phase 4's NVT fluid, the model with its virial: NPT(kT=1.5,
               tau=0.5, P=1.2 x the fluid's measured pressure, tauP=0.5)
               through the dynamic-box slot layout, a timed run(1000) with
               host syncs forbidden: the volume falls by 1% or more,
               repacks ran, no geometry flag; at the final box K1 (LJ form
               with its virial, proxy form, generic form) and K2 against
               their plain versions;
15. triclinic -- a 64k fluid at density 0.4 in a box tilted by (0.3, -0.2,
               0.25): a quench, NVT at kT 1.5, a timed run(1000) with host
               syncs forbidden; at one state K1 (every form) and K2
               against their plain versions and the generic form's listed
               lanes bit-equal to the plain list's (the staged candidate
               masks); a step at N = 512 against the 27-image numpy
               oracle;
16. logged   -- phase 4's NVT fluid, the LJ PairModel with its virial on
               'cellwise': a timed run(1000), then a timed run(1000,
               log_period=10), both with host syncs forbidden, and
               run(500, log_period=10): 150 finite records 10 steps apart,
               mean T within 1.1-1.9; the timed pair once more (steps/s
               of both pairs printed); K1's <energy, virial> variant (the
               one a logged step launches) against its plain version at
               that state, its whole call and its bound; then the model
               with period=5 (at dt 0.001) and a timed run(1000): K1
               launches equal to the model's 200 evaluations, T healthy;
17. stateful -- reference example 04's model (WCARepulsion(0.9) energy,
               compute_rdf over [0.5, 3.0] into a MeanTensor, NN 48,
               r_cut 3) at N = 65536, density 0.5, Langevin(kT=0.8,
               gamma=1.0), dt 0.002, seed 7, on the packed route (the cell
               list with K3): run(100), a timed run(1000) with host syncs
               forbidden; the MeanTensor count equal to the committed
               model calls, a non-empty RDF, |T - 0.8| < 0.5; K3 against
               its plain version at this state; then a CellList smaller
               than the fullest cell: a rollback, after which the count
               still equals the committed calls;
18. eds      -- reference example 03 as it stands (9 particles, r_cut 0,
               EDSLayer(4.0, period=5, learning_rate=0.2) and Mean,
               save_output_period=10, run(1000), host syncs forbidden):
               (<cv> - 4)^2 < 0.8, 100 finite captures, device memory
               flat over the run;
19. mapped   -- phase 4's fluid thermalized at kT 1.5, then
               enable_mapped_nlist with center_of_mass through a
               sparse_mapping operator over groups of 4 atoms (16,384
               beads, 81,920 rows); reference example 02's model with LJ
               (forces from the atoms' list, the beads' RDF into a
               MeanTensor), NN 64, NVT(1.5, 0.5): on 'cell' (the sort
               method) a timed run(200) logged every 10th step, host
               syncs forbidden; beads at the mapping of the atoms
               (1e-4), no force or velocity on them, no row lists the
               other group, the engine T's mean over the mapped
               trajectory's log in (1.1, 1.9), a non-empty RDF; then
               'cellwise' (the planes route) from that state: its forces
               after one step against 'cell' (rtol = atol = 5e-4),
               run(99) logged every 10th step, the same gates, peak
               memory;
20. molsim   -- a MolSimModel of 16,384 four-atom molecules (tests/zoo.py's
               LJMolModel) at 64k on the default build (cell list + K3):
               its forces at the first state against the plain LJ
               model's on the same list (1e-4), a timed run(200) with host
               syncs forbidden, K3 launches equal to the model
               evaluations, T in (1.1, 1.9), K3 against its plain
               version at the final state;
21. cg-tools -- reference examples 07 (peg2.pdb and its DSGPM map) and 09
               (8 five-atom molecules) on the card with their own
               assertions; iter_from_trajectory over 20 frames of a
               4,096-atom LJ run, each frame's model forces against the
               engine's 'n2' forces at those positions (1e-4);
22. fp64-eval -- phase 4's protocol with init_lattice(dtype=torch.float64)
               and a float64 model: a timed run(1000), host syncs
               forbidden, 1.1 < T < 1.9, every state tensor float64, every
               K1 launch the double instantiation, as many as the force
               evaluations; the forces of 256 rows against the float64
               27-image oracle (1e-10 max|F|); K1 double against its plain
               version (1e-11 max|F|), its whole call and its bound at
               float64's 34 TFLOP/s;
23. fp64-train -- phases 5 and 10's rows (the proxy NN, TrainableNNPair)
               in float64 from one float64 fluid, phase 5's protocol and
               loss gate, every launch double: K1's proxy form and K2
               (rtol 1e-10), generic_reduce_bwd lane by lane and K1's
               generic form (1e-11) against their plain versions, times
               and bounds;
24. fp64-packed -- phase 6's packed path (LJModel(64), the cell list with
               K3) in float64: a timed run(500), K3 double equal to its
               plain version element for element, its times; then
               save_checkpoint, run(20), load_checkpoint: the restored
               positions bit-equal, the resumed run(20) within 1e-9 of the
               uninterrupted one (bit-equal reported).

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
# the tensor cores 67 TFLOP/s, float64 outside the tensor cores 34 TFLOP/s
# (NVIDIA's data sheet).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
PEAK_F64_PER_S = 34e12
# float64 (phases 22-24): each double kernel against its plain version,
# relative to the reference's max |value|: K1 (every form) 1e-11, K2 rtol
# 1e-10, generic_reduce_bwd 1e-11 lane by lane, K3 element for element;
# the forces against the float64 27-image oracle 1e-10 (tests/test_fp64.py's
# bar); the resumed run within 1e-9 of the uninterrupted one.
F64_K1_TOL, F64_K2_RTOL, F64_BWD_TOL = 1e-11, 1e-10, 1e-11
F64_ORACLE_TOL, F64_RESUME_TOL = 1e-10, 1e-9


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


def bound(nbytes, ops, peak_ops=PEAK_F32_PER_S):
    """The least time (ms) the card could take: the larger of the bytes
    over the memory rate and the operations over their peak (float32's,
    or ``PEAK_F64_PER_S`` for a float64 function)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pair_counts(positions, valid, plan):
    """``(tested, inside)``: the occupied x occupied pairs of the half
    stencil on this state, each unordered pair once (a cell's own pairs,
    and its slots against each directed neighbour cell's), and those
    within the cut, counted by brute force over the occupied slots with the
    minimum image (every pair within the cut lies in the half stencil
    once)."""
    import numpy as np
    from hoomd_tf_tpu_torch.ops.cellwise import _HALF_OFFS
    nx, ny, nz = plan.grid
    occ = valid.reshape(nz, ny, nx, plan.capacity).sum(-1).double()
    occ = occ.cpu().numpy()
    tested = float((occ * (occ - 1) / 2).sum())
    for ox, oy, oz in _HALF_OFFS[1:]:
        tested += float((occ * np.roll(occ, (-oz, -oy, -ox),
                                       axis=(0, 1, 2))).sum())
    real = positions[valid > 0]
    L = torch.as_tensor(plan.lengths, dtype=real.dtype, device=real.device)
    hits = 0
    for a in range(0, real.shape[0], 1024):
        d = real[None, :, :] - real[a:a + 1024, None, :]
        d = d - torch.round(d / L) * L
        hits += int(((d * d).sum(-1) <= plan.r_cut ** 2).sum())
    return tested, (hits - real.shape[0]) / 2


def k1_cost(positions, valid, plan, n_ch, form):
    """Bytes and operations of the function K1 computes on this state,
    forces only or with energy (``n_ch`` 3 or 4), untyped: the slot
    positions and ``valid`` read once, ``forces4`` written once, the form's
    table, each value of the positions' size (4 bytes, 8 in float64); per
    tested pair the displacement, d2 and the cut test (9 operations), per
    pair inside the cut the pair form (LJ 14, the proxy's two Clenshaw
    series 8K + 10) and, per channel, the product and its two sums (3)."""
    from hoomd_tf_tpu_torch.ops.cellwise_cuda import ChebForm
    tested, inside = pair_counts(positions, valid, plan)
    esize = positions.element_size()
    nbytes = plan.n_slots * esize * (3 + 1 + 4) + \
        form.tensor(positions.device).numel() * esize
    per = 8 * form.K + 10 if isinstance(form, ChebForm) else 14
    return nbytes, 9 * tested + inside * (per + 3 * n_ch)


def k2_cost(positions, valid, plan, K, energy, M):
    """Bytes and operations of the function K2 computes on this state,
    untyped: the slot positions, ``valid`` and the ``[n_slots, 4]``
    cotangent read once, the ``M`` moments written once (values of the
    positions' size); per tested pair 9 operations, per pair inside the
    cut 27 (weights, u, w) plus, per term, the recurrence (2) and each
    moment's multiply-add (2 per moment set)."""
    tested, inside = pair_counts(positions, valid, plan)
    nbytes = positions.element_size() * (plan.n_slots * (3 + 1 + 4) + M)
    return nbytes, 9 * tested + inside * (27 + K * (2 + 2 * (1 + energy)))


def make_model(nn=64, virial=False, dtype=None):
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
    return LJ(nn, virial=virial, dtype=dtype or torch.float32)


def make_nn(seed=0, proxy_degree=K_PROXY, dtype=None):
    """north_star.py's TrainableNNPair: a per-lane MLP on 1/r (widths
    16 -> 1), random weights from ``seed``, in ``dtype`` (float32 by
    default)."""
    gen = torch.Generator().manual_seed(seed)
    dtype = dtype or torch.float32

    class NNPair(htt.PairModel):
        def setup(self):
            self.dense1 = htt.Dense(16, generator=gen, dtype=dtype)
            self.last = htt.Dense(1, generator=gen, dtype=dtype)

        def pair_energy(self, r2):
            x = torch.tanh(self.dense1(torch.rsqrt(r2)[..., None]))
            return 2.0 * self.last(x)[..., 0]
    return NNPair(64, output_forces=False, proxy_degree=proxy_degree,
                  dtype=dtype)


def make_nn_generic(seed=0):
    """north_star.py's TrainableNN, reference example 08's form: a
    generic SimModel, the same MLP on 1/r (widths 16 -> 1) summed over a
    particle's neighbors, forces by autograd, its output forces[:, :3];
    random weights from ``seed``."""
    gen = torch.Generator().manual_seed(seed)

    class TrainableNN(htt.SimModel):
        def setup(self):
            self.dense1 = htt.Dense(16, generator=gen)
            self.last = htt.Dense(1, generator=gen)

        def compute(self, nlist, positions, box):
            rinv = htt.nlist_rinv(nlist)
            x = torch.tanh(self.dense1(rinv[..., None]))
            e = torch.sum(self.last(x)[..., 0], dim=1)
            return htt.compute_nlist_forces(nlist, e)[:, :3]
    return TrainableNN(64, output_forces=False)


def make_nn_potential(nn=64, seed=0):
    """Reference example 08's NNPotential (examples/08): an RBF expansion
    (16) of the 16 nearest neighbors' distances, Dense(16) with tanh,
    Dense(1) without bias, forces by autograd; weights from ``seed``."""
    gen = torch.Generator().manual_seed(seed)

    class NNPotential(htt.SimModel):
        def setup(self, dim=16, top_neighs=16):
            self.rbf = htt.RBFExpansion(0.5, 3.0, dim)
            self.dense1 = htt.Dense(dim, generator=gen)
            self.last = htt.Dense(1, use_bias=False, generator=gen)
            self.top_neighs = top_neighs

        def compute(self, nlist, positions, box, training=False):
            rinv = htt.nlist_rinv(nlist)
            top = torch.sort(rinv, dim=1, descending=True)[0][
                :, :self.top_neighs]
            x = self.rbf(htt.divide_no_nan(torch.ones_like(top), top))
            x = torch.tanh(self.dense1(x))
            energy = torch.sum(self.last(x), dim=(1, 2))
            return htt.compute_nlist_forces(nlist, energy)
    return NNPotential(nn, output_forces=False)


def force_loss(yt, yp):
    """Force matching on forces[:, :3] (north_star.py's proxy row)."""
    return torch.mean((yt[:, :3] - yp[:, :3]) ** 2)


def jittered_sim(n, integrator, device, seed=0, dtype=None):
    import numpy as np
    dtype = dtype or torch.float32
    sim = htt.Simulation(dt=0.005, integrator=integrator, seed=seed,
                         device=device)
    sim.init_lattice(n, density=DENSITY, kT_init=1.5, dtype=dtype)
    rng = np.random.RandomState(seed)
    sim.state.positions = sim.state.positions + torch.as_tensor(
        0.3 * rng.randn(n, 3).astype(np.float32), device=device).to(dtype)
    return sim


def slot_state(layout, state):
    """Pack ``state`` into ``layout``: ``(slot_state, aux)``."""
    slot, aux = layout.pack(state)
    check(not bool(aux["overflow"]), "pack overflowed")
    return slot, aux


def make_simmodel(nn=64, dtype=None):
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
    return LJModel(nn, dtype=dtype or torch.float32)


def k3_cost(slots4, counts, grid, cap, nn, n, valid_per_row):
    """Bytes and operations of one K3 call on these inputs: the slot rows,
    counts and particle ids read once, the [n, nn, 4] list written once;
    per real candidate pair (each query slot against the occupied slots
    of its 27 cells) ~24 float operations (3 subtractions, 3 divisions,
    3 roundings, 3 multiply-subtracts, d2's 5, the cut tests and the
    key), and per query ``valid^2`` key comparisons of the ranking. An
    IEEE division counts as one operation (on the card it is a sequence
    of several), as the function's work and not any kernel's."""
    from hoomd_tf_tpu_torch.ops.cell_stencil import neighbor_cells
    neigh = neighbor_cells(grid, counts.device)
    cand = counts.long()[neigh].sum(1)
    pairs = int((counts.long() * cand).sum())
    esize = slots4.element_size()
    nbytes = slots4.numel() * esize + counts.numel() * 4 + \
        slots4.shape[0] * 4 + n * nn * 4 * esize
    v = valid_per_row.double()
    return nbytes, 24 * pairs + float((v * v).sum()), pairs


def k3_keys(slots4, grid, cap, lengths):
    """K3's selection keys of every query slot over its 27 cells, in the
    plain version's arithmetic: ``[n_cells * cap, 27 cap]`` int32,
    ``FAR_KEY`` where invalid."""
    import numpy as np
    from hoomd_tf_tpu_torch.ops import cell_stencil as cs
    from hoomd_tf_tpu_torch.ops import nlist_cuda as nc
    neigh = cs.neighbor_cells(grid, slots4.device)
    ddx, ddy, ddz, _, _, _ = cs.chunk_pairs(slots4, neigh, cap, lengths,
                                             0, int(np.prod(grid)))
    C = 27 * cap
    key, _ = nc.selection_keys(ddx.reshape(-1, C), ddy.reshape(-1, C),
                               ddz.reshape(-1, C), R_CUT, nc.slot_bits(C))
    return key


#: back-to-back calls in a profiled window, and windows tried at most
PROFILED_CALLS = 10
PROFILED_TRIES = 3


def profiled_calls(fn):
    """Names of the CUDA kernels of ``PROFILED_CALLS`` back-to-back calls
    of ``fn`` and their summed device time in ms, the windows that were
    dropped before one was whole, and each kernel's time in ms. torch.profiler can leave the
    first kernels after it starts unrecorded (a window of 84-kernel calls
    lost its three opening markers), so each window opens with one
    uncounted call of ``fn``, then three marker kernels
    (``torch.cuda._sleep``) and a synchronize, ends
    with one more, and only the kernels between the last opening marker
    and the closing one count. A window without an opening and a closing
    marker, or whose count is no multiple of the calls, is run again, up
    to ``PROFILED_TRIES`` windows; then it raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for tries in range(PROFILED_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # a call the profiler may leave half unrecorded, then markers
            fn()
            torch.cuda.synchronize()
            for _ in range(3):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(PROFILED_CALLS):
                fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        ev = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
        marks = [k for k, e in enumerate(ev) if "spin_kernel" in e[2]]
        if len(marks) >= 2:
            inside = ev[marks[-2] + 1:marks[-1]]
            if inside and len(inside) % PROFILED_CALLS == 0:
                return ([e[2] for e in inside],
                        sum(b - a for a, b, _ in inside) / 1e3, tries,
                        [(b - a) / 1e3 for a, b, _ in inside])
    raise RuntimeError(f"torch.profiler lost kernels in {PROFILED_TRIES} "
                       f"windows of {PROFILED_CALLS} calls (last: {len(ev)} "
                       f"kernels, markers at {marks})")


def k3_against_plain(label, args):
    """K3 against its plain version on the card: the same type column and
    nonzero pattern (the same order), displacements within 1e-6."""
    from hoomd_tf_tpu_torch.ops import nlist_cuda as nc
    got = nc.nlist_select(*args)
    want = nc.nlist_select_reference(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    same_order = bool(torch.equal(got[..., 3], want[..., 3])) and \
        bool(torch.equal(got != 0, want != 0))
    n_nb = (got[..., :3] != 0).any(-1).sum(1)
    print(f"  K3 vs plain, {label}: max_abs_err={err:.3e}, order "
          f"identical: {same_order}; neighbors per particle mean "
          f"{float(n_nb.float().mean()):.2f} max {int(n_nb.max())}")
    check(same_order and err <= 1e-6,
          f"K3 disagrees with its plain version ({label})")
    return err


def k3_cases(st, grid, cap, NN):
    """K3's harder inputs against its plain version: a 3 x 3 x 3 grid
    (many |d| near L / 2, where the thresholds leave the shift to the
    division) and the path's state with a third of its particles moved by
    -2..2 boxes per axis (unwrapped positions, |d| past 1.49 L)."""
    import numpy as np
    from hoomd_tf_tpu_torch.ops import cell_list as cl
    from hoomd_tf_tpu_torch.ops.box import box_size
    rng = np.random.RandomState(7)
    L = 10.0
    pos4 = np.concatenate([rng.rand(300, 3) * L - L / 2,
                           rng.randint(0, 3, (300, 1))], 1)
    pos4 = torch.as_tensor(pos4.astype(np.float32), device="cuda")
    g3, c3 = cl.plan(300, [L] * 3, R_CUT)
    c3 = max(c3, cl.max_occupancy(pos4[:, :3], [L] * 3, g3))
    lt = torch.tensor([L] * 3, device="cuda")
    s4, cnt, pid, ovf = cl.build_planes(pos4, g3, c3, lt)
    check(g3 == (3, 3, 3) and not bool(ovf), "3x3x3 case")
    err = k3_against_plain("3x3x3 grid (300 particles, L 10)",
                           (s4, cnt, pid, g3, c3, NN, R_CUT, (L,) * 3, 300))
    lengths = box_size(st.box)
    host_L = tuple(float(v) for v in lengths.cpu())
    shift = torch.as_tensor(rng.randint(-2, 3, (N, 3)) *
                            (rng.rand(N, 1) < 0.34), device="cuda")
    pos4 = st.positions4.clone()
    pos4[:, :3] += shift.to(pos4.dtype) * lengths
    s4, cnt, pid, ovf = cl.build_planes(pos4, grid, cap, lengths)
    check(not bool(ovf), "unwrapped case overflowed")
    return max(err, k3_against_plain(
        "the path's state, a third unwrapped by -2..2 boxes",
        (s4, cnt, pid, grid, cap, NN, R_CUT, host_L, N)))


def phase_packed():
    """The packed path through the public API at the 64k fluid."""
    import numpy as np
    from hoomd_tf_tpu_torch.ops import cell_list as cl
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
    err = max(k3_against_plain("the path's state", args),
              k3_cases(st, grid, cap, NN))
    t_k = cuda_ms(lambda: k3(*args))
    names, dev_ms, dropped, _ = profiled_calls(lambda: k3(*args))
    per_call = len(names) / PROFILED_CALLS
    k3_per_call = sum("nlist_select" in n for n in names) / PROFILED_CALLS
    check(per_call == 1 and k3_per_call == 1,
          f"a K3 call launched {per_call} kernels ({sorted(set(names))})")
    t_p = cuda_ms(lambda: nc.nlist_select_reference(*args), reps=5)
    # the yardstick: torch.topk's selection over the plain version's keys
    key = k3_keys(slots4, grid, cap, lengths)
    valid = (key != nc.FAR_KEY).sum(1)[pid >= 0]
    t_lib = cuda_ms(lambda: torch.topk(key, NN, dim=1, largest=False,
                                       sorted=True), reps=5)
    nbytes, ops, pairs = k3_cost(slots4, counts, grid, cap, NN, N, valid)
    del key
    b_ms, b_by = bound(nbytes, ops)
    print(f"  K3 time: whole call {t_k:.4f} ms (median of CUDA events), "
          f"kernel alone {dev_ms / PROFILED_CALLS:.4f} ms (profiler, "
          f"{PROFILED_CALLS} calls, {dropped} windows dropped), "
          f"{per_call:g} kernel per call; plain "
          f"{t_p:.4f} ms, topk yardstick (selection only, keys given) "
          f"{t_lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.1f} "
          f"MB, {ops / 1e9:.3f} G operations over {pairs} candidate pairs)")
    rec = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
               library_ms=t_lib, max_abs_err=err, launches=launches,
               sps=steps / dt)

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


def k1_generic_cost(positions, valid, plan, n_ch, needed):
    """Bytes and operations of K1's own work in its generic form, the
    user's pair function left out: the slot positions and ``valid`` read
    once, ``forces4`` written once, the list's ``needed`` lanes written
    (r2, ti, tj) and their (U, s) read once, values of the positions' size
    (20 bytes a lane, 40 in float64); per tested pair the displacement, d2
    and the cut test (9, as ``k1_cost``), per listed lane the products and
    their sums (3 per channel)."""
    tested, _ = pair_counts(positions, valid, plan)
    esize = positions.element_size()
    nbytes = plan.n_slots * esize * (3 + 1 + 4) + needed * esize * (3 + 2)
    return nbytes, 9 * tested + needed * 3 * n_ch


def seeded_weights(model, seed):
    """Set a built model's layer weights to a draw from ``seed``
    (Glorot-uniform kernels, zero biases), as the JAX package's Dense
    draws them; the two bookkeeping variables stay."""
    import numpy as np
    rng = np.random.RandomState(seed)
    weights = model.get_weights()
    out = list(weights[:2])
    for w in weights[2:]:
        if w.ndim == 2:
            lim = np.sqrt(6.0 / sum(w.shape))
            out.append(rng.uniform(-lim, lim, w.shape).astype(w.dtype))
        else:
            out.append(np.zeros_like(w))
    model.set_weights(out)
    return model


def generic_calls(label, layout, slot, aux, model, lanes):
    """K1's generic form at one state of a path, with the synthesized pair
    function of ``model``: against its plain version (rtol = atol = 1e-4);
    its whole call by CUDA events, the kernels of a call by the profiler;
    the plain version's time and the bound. Returns the row's numbers and
    the kernel's forces."""
    from hoomd_tf_tpu_torch.ops import cellwise_cuda as cc
    from hoomd_tf_tpu_torch.ops.lane_fast import synthesize_pair_fn
    fn = synthesize_pair_fn(model, slot.box)
    args = (slot.positions, slot.types, aux["valid"], layout.plan, layout.lo,
            fn)
    kw = dict(min_r2=1e-4, geometry=layout.geometry, needs_energy=False)
    lanes.reset()
    f_k, _ = cc.generic_pair_forces(*args, lanes=lanes, **kw)
    needed = int(lanes.needed)
    check(not bool(lanes.overflow()), f"{label}: the list overflowed")
    f_p, _ = cc.generic_plain(*args, lanes=None, **kw)
    torch.cuda.synchronize()
    err = compare(f"K1 generic, {label}, forces (kernel vs plain)", f_k, f_p)
    t_k = cuda_ms(lambda: cc.generic_pair_forces(*args, lanes=lanes, **kw),
                  reps=11)
    names, dev_ms, dropped, each = profiled_calls(
        lambda: cc.generic_pair_forces(*args, lanes=lanes, **kw))
    parts = {k: 0.0 for k in ("generic_list", "generic_reduce",
                              "half_stencil_home")}
    for name, ms in zip(names, each):
        for k in parts:
            if k in name:
                parts[k] += ms / PROFILED_CALLS
    ours = sum(any(k in n for k in parts) for n in names)
    check(ours == 3 * PROFILED_CALLS,
          f"{label}: {ours / PROFILED_CALLS} generic-form kernels per call, "
          "not 3")
    t_p = cuda_ms(lambda: cc.generic_plain(*args, lanes=None, **kw), reps=3)
    nbytes, ops = k1_generic_cost(slot.positions, aux["valid"],
                                  layout.plan, 3, needed)
    b_ms, b_by = bound(nbytes, ops)
    print(f"  K1 generic, {label}: {needed} lanes of a {lanes.budget}-lane "
          f"list; whole call {t_k:.4f} ms (median of CUDA events, the pair "
          f"function included), {len(names) / PROFILED_CALLS:g} kernels per "
          f"call, 3 of them the form's, all kernels "
          f"{dev_ms / PROFILED_CALLS:.4f} ms per call (profiler, {dropped} "
          f"windows dropped); plain {t_p:.4f} ms; bound {b_ms:.4f} ms "
          f"({b_by}: {nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} G operations)")
    form_ms = sum(parts.values())
    print("  the form's kernels alone per call (profiler): " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in parts.items()) +
        f"; together {form_ms:.4f} ms; the pair function and the rest "
        f"{dev_ms / PROFILED_CALLS - form_ms:.4f} ms, "
        f"{1 - form_ms * PROFILED_CALLS / dev_ms:.3f} of the call's device "
        f"time; list {lanes.budget / needed:.4f}x the lanes needed")
    return dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                max_abs_err=err), f_k


def lane_line(sim, label):
    """Print the generic-form list's budget against the lanes the last
    committed run needed, the need's rise over the run before, and the
    list re-runs so far."""
    lanes = sim._lanes
    need = lanes.committed
    prev = getattr(sim, "_smoke_last_need", None)
    rise = (f"{need / prev:.4f}x the run before" if prev and need
            else "the first")
    sim._smoke_last_need = need
    ratio = f"{lanes.budget / need:.4f}x" if need else "-"
    print(f"  list after {label}: need {need} lanes ({rise}), budget "
          f"{lanes.budget} for the next run ({ratio} the need), re-runs "
          f"{sim.lane_reruns}")


def phase_generic():
    """A generic SimModel, LJPotential(64), on 'cellwise' at the 64k
    fluid: the probe validates it and its synthesized pair function runs
    in K1's generic form; the eval protocol with a timed run(1000)."""
    from hoomd_tf_tpu_torch.ops import cellwise_cuda as cc
    from hoomd_tf_tpu_torch.md.slots import SlotLayout

    gen, k1 = cc.generic_pair_forces, cc.half_stencil_pair_forces
    sim = jittered_sim(N, htt.md.Minimize(max_disp=0.05), "cuda")
    sim.check_syncs = True
    model = htt.LJPotential(64)
    tfc = htt.tfcompute(model)
    tfc.attach(sim, r_cut=R_CUT, nlist="cellwise")
    gen.launches = k1.launches = 0
    evals0 = sim.force_evals
    sim.run(60)
    check(tfc._lane_fast_ok is True, "the probe did not validate "
          f"LJPotential: {tfc._lane_fast_report}")
    sim.thermalize_velocities(1.5)
    sim.integrator = htt.md.NVT(kT=1.5, tau=0.5)
    lane_line(sim, "quench run(60)")
    t0 = time.perf_counter()
    sim.run(1000)
    lane_line(sim, "warm run(1000)")
    for _ in range(4):
        plan = sim._layout.plan
        sim.run(1000)
        lane_line(sim, "warm run(1000)")
        if sim._layout.plan == plan:
            break
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    ev_before, l_before = sim.force_evals, gen.launches
    reruns, lanes_timed = sim.lane_reruns, sim._lanes.budget
    t0 = time.perf_counter()
    sim.run(1000)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    lane_line(sim, "timed run(1000)")
    check(sim.lane_reruns == reruns,
          f"the timed run(1000) re-ran {sim.lane_reruns - reruns} times "
          "for a short list")
    check(lanes_timed <= 1.15 * sim._lanes.committed,
          f"the timed run's list ({lanes_timed} lanes) is more than 1.15x "
          f"the lanes it needed ({sim._lanes.committed})")
    print(f"  the timed run's list: {lanes_timed} lanes, "
          f"{lanes_timed / sim._lanes.committed:.4f}x its need: a margin of "
          f"{lanes_timed - sim._lanes.committed} lanes "
          f"({lanes_timed / sim._lanes.committed - 1:.2%}) left unused")
    launches = gen.launches
    evals = sim.force_evals - evals0
    th = sim.thermo()
    check(bool(torch.isfinite(sim.state.positions).all()),
          "non-finite positions")
    check(bool(torch.isfinite(sim.state.forces).all()), "non-finite forces")
    check(1.1 < th["temperature"] < 1.9, f"not a healthy kT=1.5 fluid: {th}")
    check(launches > 0 and launches == evals,
          f"generic-form launches {launches} != force evaluations {evals}")
    timed = gen.launches - l_before
    check(sim.force_evals - ev_before == timed >= 1001,
          f"timed run: generic-form launches {timed} != evaluations")
    check(k1.launches == 0, "the generic path launched a pair form")
    plan = sim._layout.plan
    print(f"  probe: validated (tfc._lane_fast_ok True); plan grid "
          f"{plan.grid} cap {plan.capacity}; list budget "
          f"{sim._lanes.budget} lanes; warm runs {warm_s:.1f} s; "
          f"T={th['temperature']:.4f} PE/N={th['potential_energy'] / N:.4f}")
    print(f"  generic-form launches {launches} == force evaluations {evals} "
          f"(timed run: {timed}); K1 pair-form launches 0; no host sync in the "
          f"step loops (set_sync_debug_mode('error')); list re-runs "
          f"{sim.lane_reruns} in all, 0 in the timed run")
    print(f"  steps/s {1000 / dt:.2f} (timed run(1000), N={N}) on "
          f"{smi_line()} -- info, not a claim")

    # one state: the kernel against its plain version and K1's LJ form
    layout = SlotLayout(plan, N, sim._lo, device="cuda")
    slot, aux = slot_state(layout, sim.state)
    lanes = cc.LaneBudget(sim._lanes.budget, "cuda")
    rec, f_g = generic_calls("LJPotential", layout, slot, aux, model, lanes)
    # the two forms compute one function: the generic form with the LJ
    # pair function against K1's LJ form
    lj = htt.md.LennardJones(1.0, 1.0, r_cut=float("inf"))
    common = (slot.positions, slot.types, aux["valid"], plan, layout.lo)
    f_l, _ = k1(*common, lj.kernel_form(), needs_energy=False,
                geometry=layout.geometry)
    f_e, _ = cc.generic_pair_forces(*common, lj.pair_energy_and_slope,
                                    needs_energy=False,
                                    geometry=layout.geometry, lanes=lanes)
    torch.cuda.synchronize()
    rec["max_abs_err"] = max(rec["max_abs_err"], compare(
        "K1 generic (the LJ pair function) vs K1 LJ form, forces", f_e, f_l))
    # LJPotential is LJ of nlist_rinv, whose offsets (1e-7 per component,
    # the reference's deltas) move each pair force by ~1e-6 of itself:
    # held to the LJ form at the probe's own rule
    err = (f_g - f_l).abs().amax(0)[:3]
    lim = 2e-4 + 2e-3 * f_l.abs().amax(0)[:3]
    worst = float(((f_g - f_l).abs() / (1e-4 + 1e-4 * f_l.abs())).max())
    print(f"  K1 generic (LJPotential, synthesized) vs K1 LJ form: max err "
          f"per axis {[round(float(e), 6) for e in err]} (probe's limits "
          f"{[round(float(v), 5) for v in lim]}); against rtol = atol = "
          f"1e-4 worst/bound {worst:.3f}")
    check(bool((err <= lim).all()), "LJPotential disagrees with the LJ form")
    rec["launches"] = launches
    return sim, rec


def phase_nn(state):
    """NeuralPairPotential at the JAX package's widths (RBF 32, two
    hidden layers of 64) on 'cellwise' at the 64k fluid, weights from a
    seed: validated by the probe, K1's generic form against the planes
    route (autograd, in row chunks) and its plain version at one state,
    then 100 NVT steps with finite positions and forces (an untrained NN
    is no fluid: no temperature gate)."""
    from hoomd_tf_tpu_torch.ops import cellwise_cuda as cc
    from hoomd_tf_tpu_torch.ops.lane_fast import (near_cut_rows,
                                                  planes_forces, route_errors)
    from hoomd_tf_tpu_torch.md.slots import SlotLayout

    gen = cc.generic_pair_forces
    model = htt.interop.build_model(htt.NeuralPairPotential(64), R_CUT,
                                    "cuda")
    seeded_weights(model, seed=0)
    sim = htt.Simulation(dt=0.005, integrator=htt.md.NVT(kT=1.5, tau=0.5),
                         seed=0, device="cuda")
    sim.set_state(state)
    sim.check_syncs = True
    tfc = htt.tfcompute(model)
    tfc.attach(sim, r_cut=R_CUT, nlist="cellwise")
    gen.launches = 0
    evals0 = sim.force_evals
    torch.cuda.reset_peak_memory_stats()
    print(f"  device memory before: {torch.cuda.memory_allocated() / 1e9:.2f} "
          f"GB allocated")
    t0 = time.perf_counter()
    try:
        sim.run(100)
    except Exception as e:
        raise RuntimeError(
            f"the NN run failed ({e!r}); probe verdict "
            f"{tfc._lane_fast_ok}: {tfc._lane_fast_report}") from e
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"  peak device memory of the run: "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    lane_line(sim, "run(100)")
    launches = gen.launches
    check(tfc._lane_fast_ok is True, "the probe did not validate "
          f"NeuralPairPotential: {tfc._lane_fast_report}")
    check(launches == sim.force_evals - evals0 and launches > 0,
          f"NN generic-form launches {launches} != evaluations")
    check(bool(torch.isfinite(sim.state.positions).all()),
          "non-finite positions")
    check(bool(torch.isfinite(sim.state.forces).all()), "non-finite forces")
    th = sim.thermo()
    plan = sim._layout.plan
    print(f"  probe: validated; plan grid {plan.grid} cap {plan.capacity}; "
          f"100 NVT steps in {dt:.2f} s (probe and its validation "
          f"included), T={th['temperature']:.4f} (no gate: untrained); "
          f"launches {launches} == evaluations")

    layout = SlotLayout(plan, N, sim._lo, device="cuda")
    slot, aux = slot_state(layout, sim.state)
    lanes = cc.LaneBudget(sim._lanes.budget, "cuda")
    rec, f_g = generic_calls("NeuralPairPotential", layout, slot, aux,
                             model, lanes)
    ref = planes_forces(model, slot, aux, layout, lane_chunk=1 << 22)
    near = near_cut_rows(slot, aux, layout, lane_chunk=1 << 22)
    # forces only: the row's timed call left the energy column out
    ok, why = route_errors(ref[:, :3], f_g[:, :3], near)
    print(f"  K1 generic vs the planes route (autograd), forces, "
          f"the probe's rule: max err per column "
          f"{[round(float(e), 6) for e in why.get('err', [])]}, limits "
          f"{[round(float(v), 6) for v in why.get('limit', [])]}, "
          f"{why.get('rows_at_the_cut')} rows with a lane at the cut left "
          f"out")
    check(ok, f"NN: generic form disagrees with the planes route: {why}")
    rec["launches"] = launches
    return rec


def phase_direct(state):
    """LJPotential(64) with nlist='direct' at the 64k fluid: its forces
    against the packed K3 route on the same state, then a timed
    run(500)."""
    from hoomd_tf_tpu_torch.ops.box import box_size

    sim = htt.Simulation(dt=0.005, integrator=htt.md.NVT(kT=1.5, tau=0.5),
                         seed=0, device="cuda")
    sim.set_state(state)
    sim.check_syncs = True
    htt.tfcompute(htt.LJPotential(64)).attach(sim, r_cut=R_CUT,
                                              nlist="direct")
    build = sim._packed_build()
    check(build.method == "direct", f"'direct' resolved to {build.method}")
    grid, cap = build.plan
    st = sim.state
    planes, ovf = build(st.positions4, box_size(st.box))
    check(not bool(ovf), "direct planes overflowed")
    ref = htt.Simulation(dt=0.005, integrator=htt.md.NVT(kT=1.5, tau=0.5),
                         seed=0, device="cuda")
    ref.set_state(state)
    htt.tfcompute(htt.LJPotential(128)).attach(ref, r_cut=R_CUT)
    rb = ref._packed_build()
    check(rb.method == "pallas", "the reference did not take K3")
    nl, ovf = rb(st.positions4, box_size(st.box))
    n_nb = int((nl[..., :3] != 0).any(-1).sum(1).max())
    check(not bool(ovf) and n_nb < 128, f"K3 list full ({n_nb})")
    f_d, _ = sim._eval_model(st, planes)
    f_k, _ = ref._eval_model(st, nl)
    # one function on both routes: a PairModel's r2-based compute
    inputs = [st.positions4, st.box]
    g_d = make_model(64)([planes] + inputs)[0]
    g_k = make_model(128)([nl] + inputs)[0]
    torch.cuda.synchronize()
    err = compare("direct planes vs packed K3 list (NN 128), the LJ "
                  "PairModel, forces+energy", g_d, g_k)
    # LJPotential: nlist_rinv adds the reference's 3e-6 to r on a packed
    # list and takes an rsqrt of the offset components on planes (as the
    # JAX package does), ~4e-5 of each pair force apart: the probe's rule
    e = (f_d - f_k).abs().amax(0)
    lim = 2e-4 + 2e-3 * f_k.abs().amax(0)
    print(f"  direct vs K3, LJPotential: max err per column "
          f"{[round(float(v), 6) for v in e]} (limits "
          f"{[round(float(v), 5) for v in lim]})")
    check(bool((e <= lim).all()), "LJPotential: direct disagrees with K3")
    del planes, nl
    sim.run(50)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run(500)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    th = sim.thermo()
    check(bool(torch.isfinite(sim.state.positions).all()),
          "non-finite positions")
    check(1.1 < th["temperature"] < 1.9, f"not a healthy kT=1.5 fluid: {th}")
    print(f"  plan grid {grid} cap {cap}: planes [{N}, {27 * cap}]; max "
          f"neighbors {n_nb}; T={th['temperature']:.4f}; no host sync in "
          f"the step loop")
    print(f"  steps/s {500 / dt:.2f} (timed run(500), N={N}) on "
          f"{smi_line()} -- info, not a claim")
    return err


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
    # the same grid with room for 80 and 200 per cell (a self-heal
    # capacity floor can do this): 14*cap = 1120 and 2800 slots staged per
    # cell, 5 and 11 chunks of the thread block, past 48 KB of shared
    # memory at 200
    cases = [("one type", plan, state.types, lj1, None),
             ("two types + rcut_matrix", plan, types2, lj2, rcm)]
    for cap in (max(80, plan.capacity + 1), 200):
        cases.append((f"capacity {cap} (14*cap = {14 * cap} slots)",
                      dataclasses.replace(plan, capacity=cap), state.types,
                      lj1, None))
    max_err = 0.0
    rec = None
    for label, p, types, pot, rc in cases:
        st = dataclasses.replace(state, types=types)
        layout = SlotLayout(p, N, sim._lo, rc_matrix=rc, device=dev)
        slot, aux = slot_state(layout, st)
        form = pot.kernel_form()
        common = (slot.positions, slot.types, aux["valid"], p, layout.lo)
        kw = dict(needs_energy=True, needs_virial=True,
                  rc2_tab=layout.rc2_tab, geometry=layout.geometry)
        print(f" case {label}: grid {p.grid} cap {p.capacity}")
        f_k, w_k = cc.half_stencil_pair_forces(*common, form, **kw)
        f_p, w_p = cc.half_stencil_plain(*common, form, **kw)
        torch.cuda.synchronize()
        max_err = max(max_err,
                      compare("forces+energy (kernel vs plain)", f_k, f_p),
                      compare("virial (kernel vs plain)", w_k, w_p))
        f_f, w_f = cw.analytic_pair_forces(
            *common, pot.pair_energy_and_slope, needs_virial=True,
            with_types=True, rcut_matrix=layout.rc2_tab, form=form,
            geometry=layout.geometry, stencil="full")
        max_err = max(max_err,
                      compare("forces+energy (kernel vs full)", f_k, f_f),
                      compare("virial (kernel vs full)", w_k, w_f))
        if rec is None:
            # the main path's configuration: forces only
            t_k = cuda_ms(lambda: cc.half_stencil_pair_forces(
                *common, form, needs_energy=False,
                geometry=layout.geometry))
            t_p = cuda_ms(lambda: cc.half_stencil_plain(
                *common, form, needs_energy=False,
                geometry=layout.geometry), reps=21)
            nbytes, ops = k1_cost(slot.positions, aux["valid"], p, 3, form)
            b_ms, b_by = bound(nbytes, ops)
            rec = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by)
            print(f"  time of the whole call at the main path's shapes "
                  f"(forces only, median of CUDA events): kernel "
                  f"{t_k:.4f} ms, plain {t_p:.4f} ms, bound {b_ms:.4f} ms "
                  f"({b_by}: {nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} G "
                  f"operations)")
    rec["max_abs_err"] = max_err
    return rec


def phase_main():
    """The eval protocol through the port's public API."""
    from hoomd_tf_tpu_torch.ops import cellwise_cuda as cc

    k1 = cc.half_stencil_pair_forces
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
    sps = 1000 / dt

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
    return launches, sim, sps


def train_sim_attached(model=None, loss=None):
    """north_star.py's set-up on the port: the 64k fluid quenched and
    equilibrated (NVT, 400 steps) under a built-in LJ, which stays as the
    labels and the driving forces, then the model (default: the flagship
    row's proxy NN, force-matching loss) compiled (Adam, lr 1e-2) and
    attached with train=True: ``(sim, model)``."""
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
    model = make_nn() if model is None else model
    model.compile(optimizer="adam", loss=loss or force_loss,
                  learning_rate=1e-2)
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

    k1, k2 = cc.half_stencil_pair_forces, pc.proxy_bwd_moments
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
                    proxy=k1.proxy_launches, k2=k2.launches,
                    sps=200 / min(times))
    evals = sim.force_evals - evals0
    # train steps attempted: a run rolled back by the engine's self-heal
    # (a cell over capacity) re-runs its steps, and its losses are dropped
    steps = sim.train_steps - steps0
    hist = tfc.loss_history
    loss1 = float(np.mean(hist[-50:]))
    th = sim.thermo()
    check(len(hist) == 1400 <= steps,
          f"{len(hist)} losses of committed steps, {steps} steps attempted")
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
    print(f"  train steps: 1400 committed, {steps} attempted ({steps - 1400} "
          f"re-run after a self-heal rollback)")
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
        slot, aux = slot_state(lay, st)
        common = (slot.positions, slot.types, aux["valid"], p, lay.lo, form)
        kw = dict(min_r2=model.min_r2, rc2_tab=lay.rc2_tab,
                  geometry=lay.geometry)
        f_k, w_k = cc.half_stencil_pair_forces(*common, needs_virial=True,
                                               **kw)
        f_p, w_p = cc.half_stencil_plain(*common, needs_virial=True, **kw)
        torch.cuda.synchronize()
        k1_err = max(k1_err,
                     compare(f"K1 proxy {label}, forces+energy (kernel vs "
                             f"plain)", f_k, f_p),
                     compare(f"K1 proxy {label}, virial (kernel vs plain)",
                             w_k, w_p))
        if k1_rec is None:
            # the train path's forward: forces only
            t_k = cuda_ms(lambda: cc.half_stencil_pair_forces(
                *common, needs_energy=False, **kw))
            t_p = cuda_ms(lambda: cc.half_stencil_plain(
                *common, needs_energy=False, **kw), reps=5)
            nbytes, ops = k1_cost(slot.positions, aux["valid"], p, 3, form)
            b_ms, b_by = bound(nbytes, ops)
            k1_rec = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by)
            print(f"  K1 proxy time of the whole call (forces only, the "
                  f"train forward): kernel {t_k:.4f} ms, plain {t_p:.4f} "
                  f"ms, bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.2f} "
                  f"MB, {ops / 1e9:.3f} G operations)")
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
        slot, aux = slot_state(lay, st)
        args = (slot.positions, slot.types, aux["valid"], ct, p, lay.lo,
                basis)
        kw = dict(min_r2=model.min_r2, rc2_tab=lay.rc2_tab,
                  needs_energy=energy, geometry=lay.geometry)
        got = torch.cat([g.reshape(-1) for g in pc.proxy_bwd_moments(
            *args, **kw)])
        want = torch.cat([g.reshape(-1) for g in pc.proxy_bwd_plain(
            *args, **kw)])
        torch.cuda.synchronize()
        M = got.numel()
        scale = float(want.abs().max())
        k2_err = max(k2_err, compare(f"K2 {label}, {M} moments (kernel vs "
                                     f"plain)", got, want, rtol=K2_RTOL,
                                     atol=K2_ATOL_REL * scale))
        if k2_rec is None:
            t_k = cuda_ms(lambda: pc.proxy_bwd_moments(*args, **kw))
            t_p = cuda_ms(lambda: pc.proxy_bwd_plain(*args, **kw), reps=5)
            nbytes, ops = k2_cost(slot.positions, aux["valid"], p, K_PROXY,
                                  energy, M)
            b_ms, b_by = bound(nbytes, ops)
            k2_rec = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by)
            print(f"  K2 time of the whole call (forces-only cotangent, "
                  f"the train path): kernel {t_k:.4f} ms, plain {t_p:.4f} "
                  f"ms, bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.2f} "
                  f"MB, {ops / 1e9:.3f} G operations)")
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


def generic_train_parts(sim):
    """Each part of a train step of the list route alone at the run's
    state, CUDA-event medians in ms: the labels (K1, LJ form), the forward
    (the list kernel, the pair function with grad, the reduction), the
    backward kernel, the pair function's backward, Adam, and the whole
    update; plus the trainer and the forward's list for the kernel
    checks."""
    from hoomd_tf_tpu_torch.ops import cellwise as cw
    from hoomd_tf_tpu_torch.ops import cellwise_cuda as cc
    layout = sim._layout
    st, aux = slot_state(layout, sim.state)
    tr = sim._route(layout, st, aux).trainer
    model = sim.tfc.model
    lj, lj_form = sim.forces[0], sim._builtin_forms[0]
    common = (st.positions, st.types, aux["valid"], layout.plan, layout.lo)

    def labels():
        return cw.analytic_pair_forces(
            *common, lj.pair_energy_and_slope, needs_virial=False,
            with_types=True, needs_energy=False, form=lj_form,
            stencil="kernel", geometry=layout.geometry)[0]

    def forward():
        gl = cc.generic_list(*common, typed_fn=tr.typed, min_r2=tr.min_r2,
                             rc2_tab=layout.rc2_tab,
                             geometry=layout.geometry, lanes=sim._lanes,
                             needs_energy=tr.energy)
        U, S = gl.evaluate(tr.pair_fn, grad=True)
        f4 = cc.GenericReduce.apply(U if tr.energy else U.detach(), S, gl,
                                    tr.energy)
        return gl, U, S, f4

    out = {"labels: K1 LJ form, whole call": cuda_ms(labels, reps=15),
           "forward: list kernel + pair function (grad) + reduction":
           cuda_ms(forward, reps=15)}
    gl, U, S, f4 = forward()
    ct = torch.randn((layout.plan.n_slots, 4), device="cuda")
    ct[:, 3] = 0.0
    gU, gS = cc.generic_reduce_bwd(gl, ct, tr.energy)
    out["backward kernel: generic_reduce_bwd"] = cuda_ms(
        lambda: cc.generic_reduce_bwd(gl, ct, tr.energy), reps=25)
    outs, grads = [S], [gS]
    if tr.energy:
        outs, grads = [U, S], [gU, gS]
    out["pair function's backward (autograd, double backward of the "
        "slope)"] = cuda_ms(lambda: torch.autograd.grad(
            outs, tr.params, grads, retain_graph=True, allow_unused=True),
        reps=15)

    def whole():
        with torch.enable_grad():
            pred = tr.forces(st, aux, layout)[:, :tr.cols]
            loss = model.compute_loss([pred], labels())
        tr.opt.zero_grad()
        loss.backward()
        tr.opt.step()
    out["train update: labels + forward + loss + backward + Adam (no MD)"] = \
        cuda_ms(whole, reps=15)
    out["Adam step"] = cuda_ms(tr.opt.step, reps=25)
    return out, tr, st, aux


def phase_train_generic(label, model, loss):
    """Phases 10 and 11: north_star.py's non-proxy rows on the port at
    N = 65536, with phase 5's protocol (the set-up of
    :func:`train_sim_attached`, :func:`warm_train`, four timed run(200),
    1400 committed steps), under check_syncs: K1's generic form forward
    and the backward kernel at every train step, K1's LJ form for the
    labels."""
    import numpy as np
    from hoomd_tf_tpu_torch.ops import cellwise_cuda as cc
    gen, bwd = cc.generic_pair_forces, cc.generic_reduce_bwd
    k1 = cc.half_stencil_pair_forces
    sim, model = train_sim_attached(model, loss)
    tfc = sim.tfc
    sim.check_syncs = True
    gen.launches = bwd.launches = k1.launches = k1.proxy_launches = 0
    evals0, steps0, probe0 = sim.force_evals, sim.train_steps, \
        sim.probe_evals
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    warm_train(sim)
    warm_s = time.perf_counter() - t0
    hist = tfc.loss_history
    loss0 = float(np.mean(hist[:50]))
    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.run(200)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    launches = dict(gen=gen.launches, bwd=bwd.launches, lj=k1.launches,
                    sps=200 / min(times))
    steps = sim.train_steps - steps0
    evals = sim.force_evals - evals0
    probes = sim.probe_evals - probe0
    loss1 = float(np.mean(hist[-50:]))
    th = sim.thermo()
    report = tfc._lane_fast_report
    print(f"  probe verdict {tfc._lane_fast_ok}: " + (
        report.get("error") or
        f"max err per column {report.get('err')}, limits "
        f"{report.get('limit')}, {report.get('rows_at_the_cut')} rows at "
        "the cut left out" if report else "(a PairModel: no probe)"))
    check(len(hist) == 1400 <= steps,
          f"{len(hist)} losses of committed steps, {steps} steps attempted")
    check(bool(np.isfinite(hist).all()), "non-finite training loss")
    check(bool(torch.isfinite(sim.state.positions).all()),
          "non-finite positions")
    check(bool(torch.isfinite(sim.state.forces).all()), "non-finite forces")
    check(1.1 < th["temperature"] < 1.9, f"unhealthy fluid after: {th}")
    check(launches["bwd"] == steps,
          f"backward-kernel launches {launches['bwd']} != train steps "
          f"{steps}")
    check(launches["gen"] == steps + probes,
          f"generic-form launches {launches['gen']} != train steps {steps} "
          f"+ probe validations {probes}")
    check(k1.proxy_launches == 0, "a proxy form launched")
    check(launches["lj"] == evals - launches["gen"],
          f"K1 LJ launches {launches['lj']} != label evaluations "
          f"{evals - launches['gen']}")
    check(loss1 < 0.3 * loss0, f"loss did not fall: {loss0} -> {loss1}")
    plan = sim._layout.plan
    best = min(times)
    need = sim._lanes.committed
    print(f"  plan grid {plan.grid} cap {plan.capacity}; list budget "
          f"{sim._lanes.budget} lanes for a need of {need}, list re-runs "
          f"{sim.lane_reruns}; T={th['temperature']:.4f}; warm training "
          f"{warm_s:.1f} s")
    print(f"  train steps: 1400 committed, {steps} attempted; launches: "
          f"generic forward {launches['gen']} == train steps + {probes} probe "
          f"validations, generic_reduce_bwd {launches['bwd']} == train "
          f"steps, K1 LJ {launches['lj']} == label evaluations; no host "
          f"sync in the step loops")
    print(f"  loss (50-step windows) {loss0:.4f} -> {loss1:.4f} (ratio "
          f"{loss1 / loss0:.4f}, limit 0.3)")
    print(f"  train steps/s {200 / best:.2f} (best of 4 timed run(200), "
          f"rounds {[round(t, 3) for t in times]} s, N={N}); peak device "
          f"memory {peak / 1e9:.2f} GB; on {smi_line()} -- info, not a claim")
    parts, tr, st, aux = generic_train_parts(sim)
    print(f"  trainer branch {tr.kind!r}; one train step's parts alone "
          "(CUDA events, median ms): " +
          "; ".join(f"{k} {v:.4f}" for k, v in parts.items()))
    return sim, tr, st, aux, launches, parts


def bwd_cost(gl, needed, energy):
    """Bytes and operations of the function generic_reduce_bwd computes
    on this list: each listed cell's record (the words its header says it
    uses: a staged entry is 4 words, 8 in float64) read once, the cell
    bases, ``ct`` [n_slots, 4] and ``valid`` read once, the budget's lanes
    of gS (and gU) written once, values of the list's size; per listed
    lane the displacement (3), the row and candidate weights (8 + 4) and
    the dot product (5)."""
    plan = gl.plan
    esize = gl.r2.element_size()
    hdr = gl.rec.view(plan.n_cells, -1)[:, :3].long()
    n0, total, nw = hdr[:, 0], hdr[:, 1], hdr[:, 2]
    words = (4 + (esize + 1) * total + n0 + 1 + n0 * nw +
             (n0 * nw + 1) // 2)
    nbytes = (4 * int(words.sum()) + 4 * plan.n_cells +
              plan.n_slots * esize * (4 + 1) +
              gl.budget * esize * (1 + energy))
    return nbytes, 20 * needed


def phase_bwd_kernel(sim, tr, st, aux):
    """generic_reduce_bwd at phase 10's state against its plain version,
    lane by lane (rtol = atol = 1e-4), the tail zero; its time, the plain
    version's and the bound; the weights' gradient of the list route
    against the lane contraction (the CPU's oracle, run here on the card:
    rtol 2e-4, atol 2e-5 max|g|)."""
    from hoomd_tf_tpu_torch.ops import cellwise_cuda as cc
    layout = sim._layout
    plan = layout.plan
    common = (st.positions, st.types, aux["valid"], plan, layout.lo)
    lanes = cc.LaneBudget(sim._lanes.budget, "cuda")
    ct = torch.as_tensor(__import__("numpy").random.RandomState(0).randn(
        plan.n_slots, 4).astype("float32"), device="cuda")
    lst = cc.generic_list_plain(*common, min_r2=tr.min_r2,
                                rc2_tab=layout.rc2_tab,
                                geometry=layout.geometry, typed=tr.typed)
    err = 0.0
    rec = None
    for energy in (False, True):
        lanes.reset()
        gl = cc.generic_list(*common, typed_fn=tr.typed, min_r2=tr.min_r2,
                             rc2_tab=layout.rc2_tab,
                             geometry=layout.geometry, lanes=lanes,
                             needs_energy=energy)
        U, S = gl.evaluate(tr.pair_fn)
        cc.generic_reduce(gl, U, S, energy)
        gU, gS = cc.generic_reduce_bwd(gl, ct, energy)
        pU, pS = cc.generic_reduce_bwd_plain(lst, ct, aux["valid"], plan,
                                             energy)
        need = int(lanes.needed)
        check(not bool(lanes.overflow()), "the list overflowed")
        idx = cc.kernel_lane_index(lst, gl.cell_base, plan)
        check(need == lst["needed"] and bool(torch.equal(
            torch.sort(idx).values, torch.arange(need, device="cuda"))),
            "the kernel's list and the plain list differ")
        torch.cuda.synchronize()
        label = "with energy" if energy else "forces only (the train path)"
        err = max(err, compare(f"generic_reduce_bwd gS, {label} (kernel vs "
                               "plain, lane by lane)", gS[idx], pS))
        check(int(torch.count_nonzero(gS[need:])) == 0,
              "the list's tail carries a gradient")
        if energy:
            err = max(err, compare("generic_reduce_bwd gU (kernel vs plain)",
                                   gU[idx], pU))
            check(int(torch.count_nonzero(gU[need:])) == 0,
                  "the list's tail carries a gradient")
            continue
        t_k = cuda_ms(lambda: cc.generic_reduce_bwd(gl, ct, False))
        t_p = cuda_ms(lambda: cc.generic_reduce_bwd_plain(
            lst, ct, aux["valid"], plan, False), reps=5)
        nbytes, ops = bwd_cost(gl, need, False)
        b_ms, b_by = bound(nbytes, ops)
        rec = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by)
        print(f"  generic_reduce_bwd (forces only): kernel {t_k:.4f} ms, "
              f"plain {t_p:.4f} ms, bound {b_ms:.4f} ms ({b_by}: "
              f"{nbytes / 1e6:.2f} MB, {ops / 1e9:.4f} G operations); "
              f"{need} lanes of a {gl.budget}-lane list")
    rec["max_abs_err"] = err
    list_vs_contract(sim, tr, st, aux, ct, lanes)
    return rec


def list_vs_contract(sim, tr, st, aux, ct, lanes):
    """The weights' gradient of <ct, forces> (forces only) by the list
    route against the lane contraction, the CPU's oracle, run here on the
    card in chunks: rtol 2e-4, atol 2e-5 max|g|."""
    from hoomd_tf_tpu_torch.md.simulation import _module_pair_apply
    from hoomd_tf_tpu_torch.ops import cellwise_cuda as cc
    from hoomd_tf_tpu_torch.ops import pair_train as pt
    layout = sim._layout
    plan = layout.plan
    common = (st.positions, st.types, aux["valid"], plan, layout.lo)
    ct = ct.clone()
    ct[:, 3] = 0.0
    params = tr.params
    f4 = cc.generic_train_forces(*common, tr.pair_fn, typed_fn=tr.typed,
                                 min_r2=tr.min_r2, rc2_tab=layout.rc2_tab,
                                 needs_energy=tr.energy,
                                 geometry=layout.geometry, lanes=lanes)
    g_list = torch.autograd.grad(torch.sum(f4 * ct), params,
                                 allow_unused=True)
    named = {k: v for k, v in tr.model.named_parameters() if v.requires_grad}
    run = pt._Run(list(named), _module_pair_apply(tr.model, tr.pair_fn),
                  st.positions, st.types, aux["valid"], plan, layout.lo,
                  tr.min_r2, tr.typed, layout.rc2_tab, tr.energy, "auto",
                  "generic", layout.geometry)
    g_con = dict(zip(named, run._contract(list(named.values()), ct,
                                          chunk_lanes=1 << 22)))
    by_id = {id(v): g_con[k] for k, v in named.items()}
    scale = max(float(by_id[id(p)].abs().max()) for p in params)
    for i, (p, g) in enumerate(zip(params, g_list)):
        g = torch.zeros_like(p) if g is None else g
        compare(f"weights' gradient {i}, list route vs lane contraction",
                g, by_id[id(p)], rtol=K2_RTOL, atol=K2_ATOL_REL * scale)


def generic_forward_row(sim, tr, st, aux):
    """The training forward of phase 10 as a kernel row: its whole call
    (list kernel, the pair function with grad, reduction) by CUDA events
    against the plain version (the same function, no grad) and K1's
    generic-form bound at this list's need."""
    from hoomd_tf_tpu_torch.ops import cellwise_cuda as cc
    layout = sim._layout
    common = (st.positions, st.types, aux["valid"], layout.plan, layout.lo)
    lanes = cc.LaneBudget(sim._lanes.budget, "cuda")
    kw = dict(min_r2=tr.min_r2, rc2_tab=layout.rc2_tab,
              needs_energy=tr.energy, geometry=layout.geometry)
    f_k = cc.generic_train_forces(*common, tr.pair_fn, typed_fn=tr.typed,
                                  lanes=lanes, **kw)
    f_p, _ = cc.generic_plain(*common, tr.pair_fn, typed_fn=tr.typed,
                              lanes=None, **kw)
    torch.cuda.synchronize()
    err = compare("K1 generic training forward (kernel vs plain), forces",
                  f_k.detach(), f_p)
    need = int(lanes.needed)
    t_k = cuda_ms(lambda: cc.generic_train_forces(
        *common, tr.pair_fn, typed_fn=tr.typed, lanes=lanes, **kw), reps=11)
    t_p = cuda_ms(lambda: cc.generic_plain(
        *common, tr.pair_fn, typed_fn=tr.typed, lanes=None, **kw), reps=3)
    nbytes, ops = k1_generic_cost(st.positions, aux["valid"], layout.plan,
                                  3, need)
    b_ms, b_by = bound(nbytes, ops)
    print(f"  K1 generic training forward: whole call {t_k:.4f} ms (the "
          f"pair function with grad included), plain {t_p:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by})")
    return dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                max_abs_err=err)


def phase_train_packed():
    """Reference example 08's set-up on the packed path at N = 4096:
    NNPotential trained online with Adam (lr 1e-3) every second step
    (period=2) against the built-in LJ's forces (set_reference_forces),
    200 steps, the cell list selecting with K3 at every step, no host
    sync."""
    import numpy as np
    from hoomd_tf_tpu_torch.ops import nlist_cuda as nc
    k3 = nc.nlist_select
    sim = htt.Simulation(dt=0.002, integrator=htt.md.Minimize(0.05),
                         seed=0, device="cuda")
    sim.init_lattice(4096, density=0.3, kT_init=1.0)
    lj = sim.add_force(htt.md.LennardJones(r_cut=3.0))
    sim.run(30)
    sim.integrator = htt.md.NVT(kT=1.0, tau=0.5)
    model = htt.interop.build_model(make_nn_potential(64), 3.0, "cuda")
    model.compile(optimizer="adam", loss="mse", learning_rate=1e-3)
    tfc = htt.tfcompute(model)
    tfc.attach(sim, r_cut=3.0, train=True, period=2)
    tfc.set_reference_forces(lj)
    sim.check_syncs = True
    k3.launches = 0
    builds0, steps0 = sim.nlist_builds, sim.train_steps
    w0 = model.get_weights()
    t0 = time.perf_counter()
    sim.run(200)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    build = sim._packed_build()
    hist = np.asarray(tfc.loss_history)
    moved = max(float(np.abs(a - b).max())
                for a, b in zip(w0[2:], model.get_weights()[2:]))
    check(build.method == "pallas", f"the packed path took {build.method}")
    check(len(hist) == 100 and sim.train_steps - steps0 == 100,
          f"{len(hist)} losses, {sim.train_steps - steps0} train steps")
    check(bool(np.isfinite(hist).all()), "non-finite training loss")
    check(bool(torch.isfinite(sim.state.positions).all()),
          "non-finite positions")
    check(moved > 0, "the weights did not move")
    check(k3.launches == sim.nlist_builds - builds0 == 200,
          f"K3 launches {k3.launches} != neighbor builds")
    print(f"  N=4096, 200 steps, period 2: 100 train steps, K3 launches "
          f"{k3.launches} == neighbor builds; loss (20-step windows) "
          f"{hist[:20].mean():.5f} -> {hist[-20:].mean():.5f}; weights "
          f"moved up to {moved:.3e}; {200 / dt:.2f} steps/s (info); no host "
          f"sync in the step loop")
    return k3.launches


# ---------------------------------------------------------------------------
# Phases 13-15: the remaining ensembles and box shapes
# ---------------------------------------------------------------------------

TILT = (0.3, -0.2, 0.25)


def timed_run(sim, steps, **run_kw):
    """``sim.run(steps, **run_kw)`` under the sync-debug mode 'error',
    timed on the host clock around work that ends in a synchronize:
    ``(seconds, K1 launches, force evaluations)``."""
    from hoomd_tf_tpu_torch.ops import cellwise_cuda as cc
    sim.check_syncs = True
    l0, e0 = cc.half_stencil_pair_forces.launches, sim.force_evals
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run(steps, **run_kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = cc.half_stencil_pair_forces.launches - l0
    evals = sim.force_evals - e0
    check(launches == evals,
          f"timed run: K1 launches {launches} != force evaluations {evals}")
    return dt, launches, evals


def healthy(sim, label, kT=1.5):
    th = sim.thermo()
    check(bool(torch.isfinite(sim.state.positions).all()),
          f"{label}: non-finite positions")
    check(bool(torch.isfinite(sim.state.forces).all()),
          f"{label}: non-finite forces")
    check(tuple(sim.state.forces.shape) == (N, 4),
          f"{label}: forces shape {tuple(sim.state.forces.shape)}")
    check(1.1 < th["temperature"] < 1.9,
          f"{label}: not a healthy kT={kT} fluid: {th}")
    return th


def smooth_energy(r2):
    """A smooth, bounded pair energy for the proxy checks (the port's
    proxy tests' own)."""
    u = 1.0 / r2
    return (u * u - 2.0 * u) / (1.0 + u * u)


def box_kernels(label, layout, slot, aux, lj_virial):
    """At one state of phases 14-15, with the layout's geometry of that
    state's box: K1's LJ form (energy and virial), its proxy form (a
    Chebyshev proxy of ``smooth_energy``, K = 16) and its generic form (the
    LJ slope as a PyTorch pair function) against their plain versions at
    rtol = atol = 1e-4; K2 at the JAX bar; the generic form's listed lanes
    against the plain list's: the same lanes, r2 bit for bit (the staging's
    geometry rounds as the tensor form does). Returns ``(errors, LJ whole
    call ms)``."""
    from hoomd_tf_tpu_torch.ops import cellwise_cuda as cc
    from hoomd_tf_tpu_torch.ops import pair_train_cuda as pc
    from hoomd_tf_tpu_torch.ops.chebyshev import make_pair_proxy
    dev = slot.positions.device
    plan = layout.plan
    g = layout.geom(slot)
    common = (slot.positions, slot.types, aux["valid"], plan, layout.lo)
    errs = {}
    lj = htt.md.LennardJones(1.0, 1.0, r_cut=R_CUT).kernel_form()
    kw = dict(needs_energy=True, needs_virial=True, geometry=g)
    f_k, w_k = cc.half_stencil_pair_forces(*common, lj, **kw)
    f_p, w_p = cc.half_stencil_plain(*common, lj, **kw)
    torch.cuda.synchronize()
    errs["lj"] = max(compare(f"{label}: K1 LJ forces+energy", f_k, f_p),
                     compare(f"{label}: K1 LJ virial", w_k, w_p))
    fit, ev = make_pair_proxy(K_PROXY, (0.25 * R_CUT) ** 2, R_CUT ** 2,
                              device=dev)
    with torch.no_grad():
        coeffs = fit(smooth_energy)
    form = ev.kernel_form(coeffs)
    f_k, w_k = cc.half_stencil_pair_forces(*common, form, **kw)
    f_p, w_p = cc.half_stencil_plain(*common, form, **kw)
    torch.cuda.synchronize()
    errs["proxy"] = max(
        compare(f"{label}: K1 proxy forces+energy", f_k, f_p),
        compare(f"{label}: K1 proxy virial", w_k, w_p))

    def slope(r2):
        u = 1.0 / r2
        sr6 = u * u * u
        return (4.0 * (sr6 * sr6 - sr6),
                -12.0 * (2.0 * sr6 - 1.0) * sr6 * u)
    lanes = cc.LaneBudget(cc.lane_budget(plan, N), dev)
    gl = cc.generic_list(*common, typed_fn=False, geometry=g, lanes=lanes)
    U, S = gl.evaluate(slope)
    f_k, _ = cc.generic_reduce(gl, U, S, True, False)
    need = int(lanes.needed)
    check(not bool(lanes.overflow()), f"{label}: the list overflowed")
    lst = cc.generic_list_plain(*common, geometry=g, typed=False)
    f_p, _ = cc.generic_reduce_plain(lst, *slope(lst["r2"]), aux["valid"],
                                     plan, True, False)
    torch.cuda.synchronize()
    errs["generic"] = compare(f"{label}: K1 generic forces+energy", f_k,
                              f_p)
    check(need == lst["needed"],
          f"{label}: the kernel lists {need} lanes, the plain list "
          f"{lst['needed']}")
    idx = cc.kernel_lane_index(lst, gl.cell_base, plan)
    check(bool((torch.sort(idx).values == torch.arange(
        need, device=dev)).all()),
          f"{label}: the kernel's lanes are not the plain list's")
    same = bool((gl.r2[idx] == lst["r2"]).all())
    check(same, f"{label}: listed r2 differ from the plain list's bits")
    print(f"  {label}: the generic form lists the plain list's {need} "
          f"lanes, r2 equal bit for bit: the staged candidate masks equal "
          f"the tensor form's")
    ct = torch.randn((plan.n_slots, 4), device=dev,
                     generator=torch.Generator(dev).manual_seed(5))
    args = (slot.positions, slot.types, aux["valid"], ct, plan, layout.lo,
            ev.basis)
    got = torch.cat([x.reshape(-1) for x in pc.proxy_bwd_moments(
        *args, geometry=g)])
    want = torch.cat([x.reshape(-1) for x in pc.proxy_bwd_plain(
        *args, geometry=g)])
    torch.cuda.synchronize()
    errs["k2"] = compare(f"{label}: K2 moments", got, want, rtol=K2_RTOL,
                         atol=K2_ATOL_REL * float(want.abs().max()))
    t = cuda_ms(lambda: cc.half_stencil_pair_forces(
        *common, lj, needs_energy=False, needs_virial=lj_virial,
        geometry=g))
    print(f"  {label}: K1 LJ whole call (forces"
          f"{' and virial' if lj_virial else ''}, box read on the card) "
          f"{t:.4f} ms")
    return errs, t


def phase_langevin():
    """Phase 13: Langevin and Brownian dynamics on phase 4's path."""
    import warnings
    from hoomd_tf_tpu_torch.ops import cellwise_cuda as cc
    k1 = cc.half_stencil_pair_forces
    t_phase = time.perf_counter()
    sim = jittered_sim(N, htt.md.Minimize(max_disp=0.05), "cuda")
    tfc = htt.tfcompute(make_model())
    tfc.attach(sim, r_cut=R_CUT, nlist="cellwise")
    k1.launches = 0
    evals0 = sim.force_evals
    sim.run(60)
    sim.integrator = htt.md.Langevin(kT=1.5, gamma=1.0)
    sim.run(1000)
    dt, tl, te = timed_run(sim, 1000)
    th = healthy(sim, "langevin")
    print(f"  Langevin: steps/s {1000 / dt:.2f} (timed run(1000), N={N}, "
          f"plan {sim._layout.plan.grid} cap {sim._layout.plan.capacity}, "
          f"K {sim._static_K_last}); K1 launches {tl} in the timed run; "
          f"T={th['temperature']:.4f} -- info, not a claim")
    # one state, one seed, 50 steps twice: the first forced through a
    # capacity-overflow rollback (capacity 4, which the fluid overflows at
    # once; state and generator rolled back, then re-run on the replanned
    # floor), the second on the plan that run ended with, no rollback
    start = sim.state
    sim.check_syncs = False
    tfc.nlist_method = htt.Cellwise(capacity=4)
    # the speeds the repack interval is sized from, as both runs start
    hist = list(sim._vmax_hist)
    outs = []
    for forced in (True, False):
        sim.set_state(start)
        sim._vmax_hist = list(hist)
        sim.generator.manual_seed(1234)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            sim.run(50)
        rolled = [x for x in w if "exceeded" in str(x.message)]
        check(len(rolled) == int(forced),
              f"forced={forced}: {len(rolled)} rollbacks")
        outs.append((sim.state.positions.clone(), sim._layout.plan,
                     sim._static_K_last))
    check(outs[0][1:] == outs[1][1:],
          f"the two runs took different plans or intervals: "
          f"{outs[0][1:]} {outs[1][1:]}")
    err = float((outs[0][0] - outs[1][0]).abs().max())
    print(f"  50 steps twice from one state and seed, the first through "
          f"one capacity-overflow rollback (capacity 4 -> "
          f"{outs[0][1].capacity}, grid {outs[0][1].grid}): max position "
          f"difference {err:.3e} (limit 1e-5)")
    check(err <= 1e-5, "a rolled-back run drew other noise")
    tfc.nlist_method = "cellwise"
    # Brownian dynamics
    sim.replan()
    sim.integrator = htt.md.Brownian(kT=1.5, gamma=1.0)
    dt0 = sim.dt
    sim.dt = 2e-4
    p0 = sim.state.positions.clone()
    r0 = sim.repacks
    sim.check_syncs = True
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run(200)
    torch.cuda.synchronize()
    t_b = time.perf_counter() - t0
    p1 = sim.state.positions
    L = torch.as_tensor(sim._lengths, dtype=p1.dtype, device=p1.device)
    d = p1 - p0
    d = d - torch.round(d / L) * L
    msd = float((d * d).mean())
    check(bool(torch.isfinite(p1).all()), "Brownian: non-finite positions")
    check(0.02 < msd < 0.5, f"Brownian: mean squared displacement {msd}")
    print(f"  Brownian(kT=1.5), dt 2e-4: 200 steps, {200 / t_b:.2f} "
          f"steps/s, {sim.repacks - r0} repacks (one a step), mean "
          f"squared displacement per axis {msd:.4f} (free diffusion "
          f"0.12)")
    sim.dt = dt0
    launches = k1.launches
    evals = sim.force_evals - evals0
    check(launches > 0 and launches == evals,
          f"K1 launches {launches} != force evaluations {evals}")
    print(f"  K1 launches {launches} == force evaluations {evals}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return launches


def phase_npt(sim):
    """Phase 14: NPT from phase 4's NVT fluid."""
    from hoomd_tf_tpu_torch.ops import cellwise_cuda as cc
    k1 = cc.half_stencil_pair_forces
    t_phase = time.perf_counter()
    tfc = htt.tfcompute(make_model(virial=True))
    tfc.attach(sim, r_cut=R_CUT, nlist="cellwise")
    sim.check_syncs = False
    k1.launches = 0
    evals0 = sim.force_evals
    sim.run(50)
    p0 = sim.thermo()["pressure"]
    check(p0 > 0, f"the NVT fluid's pressure {p0} is not positive")
    target = 1.2 * p0
    sim.integrator = htt.md.NPT(kT=1.5, tau=0.5, P=target, tauP=0.5)
    vol0 = float(torch.prod(sim.state.box[1] - sim.state.box[0]))
    sim.run(100)
    r0 = sim.repacks
    dt, tl, te = timed_run(sim, 1000)
    layout = sim._layout
    check(layout.dynamic_box, "NPT did not take the dynamic-box layout")
    th = healthy(sim, "npt")
    vol1 = float(torch.prod(sim.state.box[1] - sim.state.box[0]))
    repacks = sim.repacks - r0
    print(f"  NPT(P = 1.2 x {p0:.4f} = {target:.4f}): steps/s "
          f"{1000 / dt:.2f} (timed run(1000)), K {sim._static_K_last}, "
          f"{repacks} repacks; volume {vol0:.1f} -> {vol1:.1f} "
          f"({vol1 / vol0 - 1:+.4f}), P={th['pressure']:.4f}, "
          f"T={th['temperature']:.4f} -- info, not a claim")
    check(vol1 <= 0.99 * vol0, f"the volume fell by less than 1%: "
          f"{vol0} -> {vol1}")
    check(repacks > 0, "no repack ran")
    slot, aux = slot_state(layout, sim.state)
    check(not bool(layout.geometry_bad(slot)), "the geometry flag is set")
    launches = k1.launches
    evals = sim.force_evals - evals0
    check(launches > 0 and launches == evals,
          f"K1 launches {launches} != force evaluations {evals}")
    errs, t = box_kernels("npt final box", layout, slot, aux, True)
    print(f"  K1 launches {launches} == force evaluations {evals}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return launches


def tri_lattice(n, L, tilt, seed=0, jitter=0.15):
    """``n`` positions on a jittered simple-cubic lattice in fractional
    space of a cubic box of edge ``L`` tilted by ``tilt`` (as the JAX
    tests' tri_positions)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    xy, xz, yz = tilt
    h = np.array([[L, xy * L, xz * L], [0, L, yz * L], [0, 0, L]])
    m = int(np.ceil(n ** (1 / 3)))
    g = (np.arange(m) + 0.5) / m
    frac = np.stack(np.meshgrid(g, g, g, indexing="ij"),
                    -1).reshape(-1, 3)[:n]
    frac = frac + rng.uniform(-jitter, jitter, frac.shape) / m
    return (frac @ h.T - L / 2).astype(np.float32)


def oracle_27(pos, L, tilt, r_cut):
    """LJ forces by the exact 27-image minimum image (float64)."""
    import numpy as np
    xy, xz, yz = tilt
    h = np.array([[L, xy * L, xz * L], [0, L, yz * L], [0, 0, L]])
    combos = np.array([(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
                       for k in (-1, 0, 1)])
    d = pos[None].astype(np.float64) - pos[:, None]
    cand = d[..., None, :] + combos @ h.T
    idx = np.argmin((cand * cand).sum(-1), -1)
    d = np.take_along_axis(cand, idx[..., None, None], -2)[..., 0, :]
    r = np.linalg.norm(d, axis=-1)
    np.fill_diagonal(r, np.inf)
    m = r <= r_cut
    rs = np.where(m, r, np.inf)
    fmag = 24 * (2 * rs ** -13 - rs ** -7)
    return -((fmag / np.where(m, r, 1.0))[..., None] * d).sum(1)


def phase_triclinic():
    """Phase 15: a 64k fluid in a tilted box."""
    import numpy as np
    from hoomd_tf_tpu_torch.ops import cellwise_cuda as cc
    k1 = cc.half_stencil_pair_forces
    t_phase = time.perf_counter()
    L = (N / DENSITY) ** (1 / 3)
    box = np.stack([[-L / 2] * 3, [L / 2] * 3, TILT])
    sim = htt.Simulation(dt=0.005, seed=0, device="cuda",
                         integrator=htt.md.Minimize(max_disp=0.05))
    sim.init_state(tri_lattice(N, L, TILT), box, kT_init=1.5)
    tfc = htt.tfcompute(make_model())
    tfc.attach(sim, r_cut=R_CUT, nlist="cellwise")
    k1.launches = 0
    evals0 = sim.force_evals
    sim.run(60)
    sim.thermalize_velocities(1.5)
    sim.integrator = htt.md.NVT(kT=1.5, tau=0.5)
    sim.run(1000)
    dt, tl, te = timed_run(sim, 1000)
    th = healthy(sim, "triclinic")
    plan = sim._layout.plan
    check(plan.tilted, "the plan is not tilted")
    print(f"  tilt {TILT}: plan {plan.grid} cap {plan.capacity} (by the "
          f"perpendicular widths); steps/s {1000 / dt:.2f} (timed "
          f"run(1000)); T={th['temperature']:.4f} -- info, not a claim")
    launches = k1.launches
    evals = sim.force_evals - evals0
    check(launches > 0 and launches == evals,
          f"K1 launches {launches} != force evaluations {evals}")
    slot, aux = slot_state(sim._layout, sim.state)
    box_kernels("tilted box", sim._layout, slot, aux, False)
    # N = 512 on the card against the 27-image oracle
    n = 512
    L5 = (n / DENSITY) ** (1 / 3)
    small = htt.Simulation(dt=0.005, seed=1, device="cuda")
    small.init_state(tri_lattice(n, L5, TILT, seed=1),
                     np.stack([[-L5 / 2] * 3, [L5 / 2] * 3, TILT]),
                     kT_init=1.0)
    small.add_force(htt.md.LennardJones(r_cut=2.5))
    l0 = k1.launches
    small.run(1)
    check(k1.launches > l0 and small._layout.plan.tilted,
          "the N = 512 tilted step did not run K1")
    got = small.state.forces[:, :3].double().cpu().numpy()
    want = oracle_27(small.state.positions.cpu().numpy(), L5, TILT, 2.5)
    ratio = float((np.abs(got - want) / (2e-3 + 2e-4 * np.abs(want)))
                  .max())
    print(f"  N=512 tilted step on the card vs the 27-image oracle: max "
          f"|diff| {np.abs(got - want).max():.3e}, worst/bound {ratio:.3f} "
          f"(rtol 2e-4, atol 2e-3, the JAX test's)")
    check(ratio <= 1.0, "the tilted step disagrees with the oracle")
    print(f"  K1 launches {launches} == force evaluations {evals} (the "
          f"64k run); phase {time.perf_counter() - t_phase:.1f} s")
    return launches


def phase_logged(state, main_sps):
    """Phase 16: ``run(log_period=)`` and ``period`` > 1 on phase 4's
    fluid (its NVT state), the LJ PairModel with its virial on
    'cellwise'."""
    from hoomd_tf_tpu_torch.ops import cellwise_cuda as cc
    k1 = cc.half_stencil_pair_forces
    t_phase = time.perf_counter()
    sim = htt.Simulation(dt=0.005, integrator=htt.md.NVT(kT=1.5, tau=0.5),
                         seed=0, device="cuda")
    sim.set_state(state)
    tfc = htt.tfcompute(make_model(virial=True))
    tfc.attach(sim, r_cut=R_CUT, nlist="cellwise")
    k1.launches = 0
    evals0 = sim.force_evals
    sim.run(200)
    for _ in range(3):
        plan = sim._layout.plan
        sim.run(500)
        if sim._layout.plan == plan:
            break
    dt_plain, _, _ = timed_run(sim, 1000)
    check(sim.log is None, "an unlogged run made records")
    dt_log, _, _ = timed_run(sim, 1000, log_period=10)
    sim.run(500, log_period=10)
    log = sim.log
    steps = log["step"]
    check(len(steps) == 150 and bool((np.diff(steps) == 10).all()) and
          steps[0] % 10 == 0, f"records at steps {steps[:3]}... "
          f"({len(steps)} of them)")
    for k, v in log.items():
        check(bool(np.isfinite(v).all()), f"non-finite logged {k}")
    t_mean = float(log["temperature"].mean())
    check(1.1 < t_mean < 1.9, f"logged mean T {t_mean}")
    healthy(sim, "logged")
    print(f"  log: {len(steps)} records, steps {steps[0]}..{steps[-1]} by "
          f"10; mean T {t_mean:.4f}, mean PE/N "
          f"{float(log['potential_energy'].mean()) / N:.4f}, mean P "
          f"{float(log['pressure'].mean()):.4f}")
    # a second pair in the same order: the host's share of the card
    # varies from run to run
    dt_plain2, _, _ = timed_run(sim, 1000)
    dt_log2, _, _ = timed_run(sim, 1000, log_period=10)
    check(len(sim.log["step"]) == 250, "the second logged run's records")
    print(f"  steps/s: run(1000) {1000 / dt_plain:.2f}, run(1000, "
          f"log_period=10) {1000 / dt_log:.2f} (ratio "
          f"{dt_plain / dt_log:.3f}); again {1000 / dt_plain2:.2f}, "
          f"{1000 / dt_log2:.2f} (ratio {dt_plain2 / dt_log2:.3f}); phase "
          f"4 {main_sps:.2f}; on {smi_line()} -- info, not a claim")
    launches = k1.launches
    evals = sim.force_evals - evals0
    check(launches == evals, f"K1 launches {launches} != force "
          f"evaluations {evals}")
    # K1's <energy, virial> variant at this state, as a logged step
    # launches it, against its plain version (launches that compare
    # count nowhere)
    layout = sim._layout
    slot, aux = slot_state(layout, sim.state)
    plan = layout.plan
    form = htt.md.LennardJones(1.0, 1.0, r_cut=R_CUT).kernel_form()
    common = (slot.positions, slot.types, aux["valid"], plan, layout.lo)
    kw = dict(needs_energy=True, needs_virial=True,
              geometry=layout.geometry)
    f_k, w_k = k1(*common, form, **kw)
    f_p, w_p = cc.half_stencil_plain(*common, form, **kw)
    torch.cuda.synchronize()
    err = max(compare("K1 <energy, virial> forces+energy (kernel vs "
                      "plain)", f_k, f_p),
              compare("K1 <energy, virial> virial (kernel vs plain)", w_k,
                      w_p))
    t_ev = cuda_ms(lambda: k1(*common, form, **kw))
    # the function's bytes: k1_cost's with the [n_slots, 3, 3] virial
    # written too; its operations with 10 channels (3 forces, the
    # energy, 6 virial components)
    nbytes, ops = k1_cost(slot.positions, aux["valid"], plan, 10, form)
    nbytes += plan.n_slots * 9 * 4
    b_ms, b_by = bound(nbytes, ops)
    print(f"  K1 <energy, virial> whole call {t_ev:.4f} ms (plan "
          f"{plan.grid} cap {plan.capacity}), bound {b_ms:.4f} ms ({b_by}: "
          f"{nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} G operations)")
    k1.launches = launches
    # the same model evaluated every 5 steps: its forces and virial stand
    # between, following their particles through each repack. At dt 0.001,
    # so that the forces are new every 0.005 time units, as on the main
    # path: held for 5 steps of 0.005, they let the LJ fluid blow up (in
    # the JAX package too)
    sim.dt = 0.001
    tfc.attach(sim, r_cut=R_CUT, nlist="cellwise", period=5)
    sim.run(100)
    s0 = sim.state.step
    dt_p, tl, te = timed_run(sim, 1000)
    want = sum(1 for s in range(s0, s0 + 1000) if s % 5 == 0)
    check(tl == te == want, f"period 5: K1 launches {tl}, evaluations "
          f"{te}, model evaluations {want}")
    th = healthy(sim, "period 5")
    print(f"  period 5: steps/s {1000 / dt_p:.2f} (timed run(1000); phase "
          f"4 {main_sps:.2f}); K1 launches {tl} == model evaluations "
          f"{want}; T={th['temperature']:.4f} -- info, not a claim")
    launches = k1.launches
    evals = sim.force_evals - evals0
    check(launches == evals, f"K1 launches {launches} != force "
          f"evaluations {evals}")
    print(f"  K1 launches {launches} == force evaluations {evals}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return launches


def make_wca_rdf(nn):
    """Reference example 04's model (examples/04): a WCARepulsion(0.9)
    energy through compute_nlist_forces, the RDF over [0.5, 3.0] into a
    MeanTensor."""
    class WCARDF(htt.SimModel):
        def setup(self):
            self.wca = htt.WCARepulsion(0.9)
            self.avg_rdf = htt.MeanTensor()

        def compute(self, nlist, positions, box):
            p_energy = self.wca(nlist)
            forces = htt.compute_nlist_forces(nlist, p_energy)
            rdf, rs = htt.compute_rdf(nlist, [0.5, 3.0], positions[:, 3])
            self.avg_rdf.update_state(rdf)
            return forces
    return WCARDF(nn)


def phase_stateful():
    """Phase 17: reference example 04's model at 65,536 particles on the
    packed route (the cell list with K3), Langevin at kT 0.8; then a run
    forced through a capacity-overflow rollback."""
    import warnings
    from hoomd_tf_tpu_torch.ops import cell_list as cl
    from hoomd_tf_tpu_torch.ops import nlist_cuda as nc
    from hoomd_tf_tpu_torch.ops.box import box_size
    k3 = nc.nlist_select
    t_phase = time.perf_counter()
    NN = 48
    model = make_wca_rdf(NN)
    sim = htt.Simulation(dt=0.002, integrator=htt.md.Langevin(kT=0.8,
                                                              gamma=1.0),
                         seed=7, device="cuda")
    sim.init_lattice(N, density=0.5, kT_init=0.8)
    tfc = htt.tfcompute(model)
    tfc.attach(sim, r_cut=3.0)
    build = sim._packed_build()
    check(build.method == "pallas", f"'auto' took {build.method!r}")
    k3.launches = 0
    b0 = sim.nlist_builds
    sim.run(100)
    sim.check_syncs = True
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run(1000)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    sim.check_syncs = False
    launches = k3.launches
    check(launches == sim.nlist_builds - b0 == 1100,
          f"K3 launches {launches} != neighbor builds")
    count = model.avg_rdf.count.value
    check(bool((count == tfc._calls).all()) and tfc._calls == 1100,
          f"MeanTensor count {float(count[0])} != committed calls "
          f"{tfc._calls}")
    rdf = model.avg_rdf.result()
    check(float(rdf.sum()) > 0, "the RDF is empty")
    th = sim.thermo()
    check(bool(torch.isfinite(sim.state.positions).all()),
          "non-finite positions")
    check(abs(th["temperature"] - 0.8) < 0.5, f"T {th['temperature']}")
    grid, cap = sim._packed_build().plan
    print(f"  WCARDF(48), Langevin(0.8), N={N}: plan {grid} cap {cap}; "
          f"steps/s {1000 / dt:.2f} (timed run(1000), host syncs "
          f"forbidden) on {smi_line()} -- info, not a claim; "
          f"T={th['temperature']:.4f}, sigma "
          f"{float(model.wca.sigma.value.detach()):.3f}, RDF peak at "
          f"bin {int(rdf.argmax())}; MeanTensor count {float(count[0]):g} "
          f"== committed calls {tfc._calls}; K3 launches {launches}")
    # K3 at this path's shapes against its plain version
    st = sim.state
    lengths = box_size(st.box)
    host_L = tuple(float(v) for v in lengths.cpu())
    slots4, counts, pid, ovf = cl.build_planes(st.positions4, grid, cap,
                                               lengths)
    check(not bool(ovf), "the state overflows its own plan")
    err = k3_against_plain("phase 17's state (NN 48)",
                           (slots4, counts, pid, grid, cap, NN, 3.0,
                            host_L, N))
    # rollbacks: a cell list half as deep as the fluid's fullest cell
    # (each retry grows it 1.3x)
    occ = cl.max_occupancy(st.positions, host_L, grid)
    small = max(2, occ // 2)
    before = float(model.avg_rdf.count.value[0])
    tfc.attach(sim, r_cut=3.0, nlist=htt.CellList(capacity=small))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        sim.run(20)
    rolled = [x for x in w if "exceeded" in str(x.message)]
    after = float(model.avg_rdf.count.value[0])
    check(len(rolled) >= 1, "the small cell list did not overflow")
    check(after - before == tfc._calls == 20,
          f"after a rollback the count rose by {after - before}, the "
          f"committed calls {tfc._calls}")
    print(f"  capacity {small} < the fullest cell's {occ}: "
          f"{len(rolled)} rollback(s), then 20 committed steps; the count "
          f"rose by {after - before:g} == committed calls {tfc._calls}")
    print(f"  phase {time.perf_counter() - t_phase:.1f} s")
    return launches, err


def phase_eds():
    """Phase 18: reference example 03 as it stands (9 particles, r_cut 0,
    EDSLayer and Mean), on the card, host syncs forbidden."""
    t_phase = time.perf_counter()

    class EDSModel(htt.SimModel):
        def setup(self, set_point):
            self.cv_avg = htt.Mean()
            self.eds_bias = htt.EDSLayer(set_point, period=5,
                                         learning_rate=0.2)

        def compute(self, nlist, positions, box):
            rvec = htt.wrap_vector(positions[0, :3], box)
            cv = torch.linalg.norm(rvec)
            self.cv_avg.update_state(cv)
            alpha = self.eds_bias(cv)
            energy = (cv - 5.0) ** 2 + cv * alpha
            forces = htt.compute_positions_forces(positions, energy)
            return forces, alpha

    model = EDSModel(0, set_point=4.0)
    sim = htt.Simulation(dt=0.05, seed=2, device="cuda")
    sim.init_lattice(n=9, a=4.0, kT_init=0.2)
    tfc = htt.tfcompute(model)
    tfc.attach(sim, r_cut=0, save_output_period=10)
    sim.check_syncs = True
    sim.run(100)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    sim.run(900)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    mem1 = torch.cuda.memory_allocated()
    cv = float(model.cv_avg.result())
    alpha = float(model.eds_bias.alpha.value.detach())
    out = tfc.outputs[0]
    check((cv - 4.0) ** 2 < 0.8, f"<cv> {cv}")
    check(out.shape[0] == 100 and bool(np.isfinite(out).all()),
          f"{out.shape[0]} captures")
    check(float(model.cv_avg.count.value) == 1000, "Mean count")
    check(mem1 <= mem0 + 65536, f"device memory grew {mem0} -> {mem1}")
    print(f"  target cv 4.0, <cv> {cv:.4f} ((cv - 4)^2 = "
          f"{(cv - 4) ** 2:.4f} < 0.8), alpha {alpha:.4f}, 100 finite "
          f"captures; device memory {mem0} -> {mem1} bytes over 900 steps; "
          f"{900 / dt:.2f} steps/s (no kernel of the port runs here); "
          f"phase {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# Phases 19-21: the coarse-grained workflow
# ---------------------------------------------------------------------------

GROUP = 4


def com_mapping(n, device="cuda"):
    """A mapping of groups of ``GROUP`` consecutive atoms to one bead of
    type 0 each: ``center_of_mass`` through the ``sparse_mapping``
    operator (made once on the card); returns ``(mapping, operator)``."""
    import numpy as np
    groups = [list(range(GROUP * i, GROUP * i + GROUP))
              for i in range(n // GROUP)]
    op = htt.sparse_mapping([np.ones((1, GROUP)) / GROUP] * len(groups),
                            groups, device=device)

    def mapping(pos4, box):
        com = htt.center_of_mass(pos4, op, box)
        return torch.cat([com, torch.zeros_like(com[:, :1])], dim=1)
    return mapping, op


def make_mapped_lj(nn=64):
    """Reference example 02's structure (examples/02_mapped_cg_simulation.
    py:19-40) with LJ (epsilon = sigma = 1) in place of its 1/r
    repulsion: forces from the atom rows' list, the bead rows' RDF over
    [0.5, 3.0] into a MeanTensor."""
    class MappedLJ(htt.SimModel):
        def setup(self):
            self.avg_cg_rdf = htt.MeanTensor()

        def compute(self, nlist, positions, box):
            aa_nlist, cg_nlist = self.mapped_nlist(nlist)
            aa_pos, cg_pos = self.mapped_positions(positions)
            rdf, rs = htt.compute_rdf(cg_nlist, [0.5, 3.0], nbins=20)
            self.avg_cg_rdf.update_state(rdf)
            inv_r6 = htt.nlist_rinv(aa_nlist) ** 6
            energy = torch.sum(4.0 / 2.0 * (inv_r6 * inv_r6 - inv_r6),
                               dim=1)
            return htt.compute_nlist_forces(aa_nlist, energy)
    return MappedLJ(nn)


def mapped_sim(state, nlist, seed=0, nn=64):
    """A new simulation from ``state`` (atoms only), the beads appended by
    enable_mapped_nlist, the mapped LJ attached on ``nlist``."""
    sim = htt.Simulation(dt=0.005, integrator=htt.md.NVT(kT=1.5, tau=0.5),
                         seed=seed, device="cuda")
    sim.set_state(state)
    tfc = htt.tfcompute(make_mapped_lj(nn))
    mapping, op = com_mapping(N)
    tfc.enable_mapped_nlist(sim, mapping)
    tfc.attach(sim, r_cut=R_CUT, nlist=nlist)
    return sim, tfc, op


def mapped_gates(sim, tfc, op, label, log_t):
    """Phase 19's gates on a mapped state: bead rows at the mapping of
    the atom rows (1e-4 by minimum image), no force and no velocity on
    them, the groups apart in the list's type channel, everything
    finite, the engine's T averaged over ``log_t``, the logged T of the
    mapped trajectory so far, in (1.1, 1.9), a non-empty RDF. The last
    T is printed, not gated: the beads start at rest, so the thermostat
    swings the engine's T (dof 3 (N + M) - 3) from 0.8 kT up past kT
    and back over some 500 steps, and step 210 lies near that swing's
    top (1.8149 and 1.8720 on 'cell' in PERF.md 6). Returns the
    engine's last T and the atoms-only T."""
    import numpy as np
    from hoomd_tf_tpu_torch.ops.box import box_size
    st = sim.state
    L = box_size(st.box)
    com = htt.center_of_mass(st.positions[:N], op, L)
    d = st.positions[N:] - com
    d = d - torch.round(d / L) * L
    err = float(d.abs().max())
    check(err <= 1e-4, f"{label}: bead rows are {err:.3e} from the "
          "mapping of the atoms")
    check(float(st.forces[N:].abs().max()) == 0.0,
          f"{label}: force on a bead row")
    check(float(st.velocities[N:].abs().max()) == 0.0,
          f"{label}: velocity on a bead row")
    for name in ("positions", "velocities", "forces"):
        check(bool(torch.isfinite(getattr(st, name)).all()),
              f"{label}: non-finite {name}")
    with torch.no_grad():
        nl = sim._build_nlist(st)
        if isinstance(nl, htt.NlistPlanes):
            listed, ty = nl.r2() > 0, nl.type
        else:
            listed, ty = (nl[..., :3] != 0).any(-1), nl[..., 3]
    check(not bool((listed[:N] & (ty[:N] != 0)).any()),
          f"{label}: an atom row lists a bead")
    check(not bool((listed[N:] & (ty[N:] != 1)).any()),
          f"{label}: a bead row lists an atom")
    check(bool(listed[N:].any()), f"{label}: no bead row lists a bead")
    full = "" if isinstance(nl, htt.NlistPlanes) else (
        f", {int((listed.sum(1) == nl.shape[1]).sum())} rows with a full "
        f"list (NN {nl.shape[1]})")
    th = sim.thermo()
    t_mean = float(log_t.mean())
    check(bool(np.isfinite(log_t).all()) and 1.1 < t_mean < 1.9,
          f"{label}: engine T over the trajectory's log {log_t}")
    v = st.velocities[:N]
    t_atoms = float((st.masses[:N, None] * v * v).sum()) / (3 * N - 3)
    rdf = float(tfc.model.avg_cg_rdf.result().sum())
    check(rdf > 0, f"{label}: the beads' RDF is empty")
    print(f"  {label}: beads at the mapping of the atoms (max "
          f"{err:.2e}, limit 1e-4), zero bead forces and velocities, no "
          f"row lists the other group, finite; engine T (dof 3 (N + M) "
          f"- 3) over the trajectory's {len(log_t)} logged steps mean "
          f"{t_mean:.4f} (limits "
          f"1.1-1.9), min {float(log_t.min()):.4f}, max "
          f"{float(log_t.max()):.4f}, last {th['temperature']:.4f}; "
          f"atoms-only T {t_atoms:.4f}; CG RDF sum {rdf:.4g}{full}")
    return th["temperature"], t_atoms


def phase_mapped(state):
    """Phase 19: example 02's mapped CG model at 65,536 atoms + 16,384
    beads, on 'cell' (the sort method: the synthesized matrix is a typed
    cut) with a timed run(200), then on 'cellwise' (the planes route)
    with run(100) and its forces against 'cell' after one step."""
    import numpy as np
    t_phase = time.perf_counter()
    base = htt.Simulation(dt=0.005, integrator=htt.md.NVT(kT=1.5, tau=0.5),
                          seed=19, device="cuda")
    base.set_state(dataclasses.replace(state))
    # thermalized before the mapping, so the beads start at rest
    base.thermalize_velocities(1.5)
    start = base.state
    sim, tfc, op = mapped_sim(start, "cell")
    check(sim.state.n_particles == N + N // GROUP,
          f"{sim.state.n_particles} rows after enable_mapped_nlist")
    rcm = tfc.r_cut_matrix
    check(rcm is not None and rcm[0, 1] < 0 and rcm[1, 1] == R_CUT,
          f"the synthesized matrix {rcm}")
    check(sim._packed_build().method == "sort",
          f"mapped 'cell' took {sim._packed_build().method!r}")
    sim.check_syncs = True
    sim.run(10)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim.run(200, log_period=10)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    grid, cap = sim._packed_build().plan
    t_cell = sim.log["temperature"]
    mapped_gates(sim, tfc, op, "'cell'", t_cell)
    print(f"  'cell' (sort method, plan {grid} cap {cap}): steps/s "
          f"{200 / dt:.2f} (timed run(200), logged every 10th step, "
          f"{N} atoms + {N // GROUP} "
          f"beads, host syncs forbidden), peak memory {peak:.2f} GiB on "
          f"{smi_line()} -- info, not a claim")

    # 'cellwise' from the same state: one step against 'cell', then 99
    mid = sim.state
    atoms = dataclasses.replace(
        mid, positions=mid.positions[:N], velocities=mid.velocities[:N],
        types=mid.types[:N], masses=mid.masses[:N], forces=mid.forces[:N],
        virial=mid.virial[:N], thermostat=dict(mid.thermostat))
    # the beads' rows are rebuilt by enable_mapped_nlist (at rest, as
    # here); the reference list holds every neighbor (NN 64 drops the
    # farthest of the fullest rows, the planes none)
    ref, _, _ = mapped_sim(atoms, "cell", nn=128)
    ref.run(1)
    cw, cwtfc, _ = mapped_sim(atoms, "cellwise", nn=128)
    cw.check_syncs = True
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cw.run(1)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    fa, fb = ref.state.forces, cw.state.forces
    ferr = float(((fb - fa).abs() / (5e-4 + 5e-4 * fa.abs())).max())
    print(f"  'cellwise' (planes route) vs 'cell' (NN 128) after one step: "
          f"force "
          f"err/bound {ferr:.3f} (rtol = atol = 5e-4), max|F| "
          f"{float(fa[:, :3].abs().max()):.2f}")
    check(ferr <= 1.0, "mapped 'cellwise' forces disagree with 'cell'")
    check(cwtfc._lane_fast_ok is False, "a mapped model took the probe")
    t0 = time.perf_counter()
    cw.run(99, log_period=10)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    plan = cw._layout.plan
    check(peak < 60.0, f"'cellwise' peak memory {peak:.1f} GiB")
    # 'cellwise' goes on from the 'cell' run's last state: the swing's
    # top, so the mean takes the trajectory from its start
    mapped_gates(cw, cwtfc, op, "'cellwise'",
                 np.concatenate([t_cell, cw.log["temperature"]]))
    print(f"  'cellwise' planes route (plan {plan.grid} cap "
          f"{plan.capacity}, {plan.n_slots} slots x 27 cap = "
          f"{plan.n_slots * 27 * plan.capacity / 1e6:.1f} M lanes): first "
          f"step {t_first:.2f} s, steps/s {99 / dt:.2f} (run(99), logged "
          f"every 10th step, host syncs forbidden), peak memory "
          f"{peak:.2f} GiB on {smi_line()} -- info, not a claim; phase "
          f"{time.perf_counter() - t_phase:.1f} s")


def make_lj_mol(mol_indices, nn=64):
    """tests/zoo.py's LJMolModel (tests/zoo.py:142-151) in torch: LJ
    through mol_nlist, forces from nlist."""
    class LJMolModel(htt.MolSimModel):
        def mol_compute(self, nlist, positions, mol_nlist, mol_positions,
                        box):
            rinv = htt.nlist_rinv(mol_nlist)
            total_e = torch.sum(4.0 / 2.0 * (rinv ** 12 - rinv ** 6))
            return htt.compute_nlist_forces(nlist, total_e)
    return LJMolModel(GROUP, mol_indices, nn)


def phase_molsim(state):
    """Phase 20: a MolSimModel of 16,384 four-atom molecules at 65,536
    atoms on the card's default neighbor build (the cell list with K3):
    its forces at the first state against the plain LJ model's on the
    same list, a timed run(200) with host syncs forbidden, K3's launches
    against the evaluations and K3 against its plain version."""
    from hoomd_tf_tpu_torch.ops import cell_list as cl
    from hoomd_tf_tpu_torch.ops import nlist_cuda as nc
    from hoomd_tf_tpu_torch.ops.box import box_size
    k3 = nc.nlist_select
    t_phase = time.perf_counter()
    NN = 64
    mols = [list(range(GROUP * i, GROUP * i + GROUP))
            for i in range(N // GROUP)]
    model = make_lj_mol(mols, NN)
    sim = htt.Simulation(dt=0.005, integrator=htt.md.NVT(kT=1.5, tau=0.5),
                         seed=20, device="cuda")
    sim.set_state(dataclasses.replace(state))
    tfc = htt.tfcompute(model)
    tfc.attach(sim, r_cut=R_CUT)
    check(sim._packed_build().method == "pallas",
          f"'auto' took {sim._packed_build().method!r}, not K3")
    # the first state: the molecules' energy is the plain model's (every
    # atom in one molecule), so are the forces on the same list
    st = sim.state
    with torch.no_grad():
        nl = sim._build_nlist(st)
    inputs = [nl, st.positions4, st.box]
    f_mol = model(inputs)[0].detach()
    f_lj = make_simmodel(NN).to("cuda")(inputs)[0].detach()
    ferr = float((f_mol[:, :3] - f_lj[:, :3]).abs().max())
    print(f"  first state: MolSimModel vs the plain LJ model on the same "
          f"list: max force diff {ferr:.3e} (limit 1e-4), max|F| "
          f"{float(f_lj[:, :3].abs().max()):.2f}")
    check(ferr <= 1e-4, "MolSimModel forces disagree with the LJ model's")
    del nl, inputs, f_mol, f_lj
    sim.check_syncs = True
    k3.launches = 0
    b0, c0 = sim.nlist_builds, tfc._calls
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim.run(200)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = k3.launches
    evals = tfc._calls - c0
    builds = sim.nlist_builds - b0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(launches == evals == builds == 200,
          f"K3 launches {launches}, model evaluations {evals}, builds "
          f"{builds}")
    th = healthy(sim, "molsim")
    grid, cap = sim._packed_build().plan
    print(f"  MolSimModel (MN {GROUP}, {len(mols)} molecules, NN {NN}), "
          f"cell list + K3 (plan {grid} cap {cap}): steps/s {200 / dt:.2f} "
          f"(timed run(200), host syncs forbidden), peak memory "
          f"{peak:.2f} GiB on {smi_line()} -- info, not a claim; "
          f"T={th['temperature']:.4f}; K3 launches {launches} == model "
          f"evaluations {evals}")
    st = sim.state
    lengths = box_size(st.box)
    host_L = tuple(float(v) for v in lengths.cpu())
    slots4, counts, pid, ovf = cl.build_planes(st.positions4, grid, cap,
                                               lengths)
    check(not bool(ovf), "the state overflows its own plan")
    err = k3_against_plain("phase 20's state",
                           (slots4, counts, pid, grid, cap, NN, R_CUT,
                            host_L, N))
    print(f"  phase {time.perf_counter() - t_phase:.1f} s")
    return launches, err


class FrameUniverse:
    """The universe protocol of utils.trajectory over frames held in
    memory: one atom type, a cubic box."""

    class _Group:
        def __init__(self, n):
            self.atoms = self
            self.types = np.array(["A"] * n)
            self.positions = None

        def __len__(self):
            return len(self.types)

    class _Step:
        def __init__(self, frame):
            self.frame = frame

    def __init__(self, frames, L):
        self._frames = frames
        self._group = self._Group(frames[0].shape[0])
        self.dimensions = np.array([L, L, L, 90.0, 90.0, 90.0])
        self.atoms = self._group

    def select_atoms(self, selection):
        return self._group

    @property
    def trajectory(self):
        for i, f in enumerate(self._frames):
            self._group.positions = f
            yield self._Step(i)


def example_07():
    """Reference example 07 (examples/07_cg_mapping_from_files.py) on the
    card: peg2.pdb's 24 atoms and its DSGPM map."""
    from hoomd_tf_tpu_torch.utils.pdb_io import PDBUniverse
    fixtures = os.path.join(HERE, "tests", "fixtures")
    u = PDBUniverse(os.path.join(fixtures, "peg2.pdb"))
    chain = ["C1", "C2", "O1", "C3", "C4", "O2",
             "C5", "C6", "O3", "C7", "C8", "O4"]
    mols = htt.find_molecules_from_topology(u, [chain])
    check(len(mols) == 2 and len(mols[0]) == 12, f"molecules {mols}")

    class FirstMolecule:
        names = list(u.atoms.names[:12])
        masses = list(u.atoms.masses[:12])
        n_atoms = 12

        def __len__(self):
            return 12

    names = FirstMolecule.names
    beads = [names[0:3], names[3:6], names[6:9], names[9:12]]
    mol_map = htt.matrix_mapping(FirstMolecule(), beads)
    sparse = htt.sparse_mapping([mol_map] * len(mols), mols, device="cuda")
    check(tuple(sparse.shape) == (8, 24), f"operator {tuple(sparse.shape)}")
    bonds, angles, dihedrals = htt.compute_cg_graph(
        DSGPM=True, infile=os.path.join(fixtures, "peg2_cgmap.json"))
    check((len(bonds), len(angles), len(dihedrals)) == (3, 2, 1),
          "CG graph of the DSGPM map")
    b_ids, a_ids, d_ids = htt.mol_features_multiple(
        bnd_indices=bonds, ang_indices=angles, dih_indices=dihedrals,
        molecules=len(mols), beads=len(beads))
    box = htt.box_from_lengths(u.dimensions[:3], device="cuda")
    M = sparse.to_dense()
    means = []
    for _ in u.trajectory:
        cg_pos = M @ torch.as_tensor(u.atoms.positions, device="cuda")
        rs = htt.mol_bond_distance(CG=True, cg_positions=cg_pos,
                                   b1=b_ids[:, 0], b2=b_ids[:, 1], box=box)
        angs = htt.mol_angle(CG=True, cg_positions=cg_pos, b1=a_ids[:, 0],
                             b2=a_ids[:, 1], b3=a_ids[:, 2], box=box)
        dihs = htt.mol_dihedral(CG=True, cg_positions=cg_pos,
                                b1=d_ids[:, 0], b2=d_ids[:, 1],
                                b3=d_ids[:, 2], b4=d_ids[:, 3], box=box)
        check(rs.is_cuda and 2.0 < float(rs.mean()) < 6.0,
              f"example 07: mean CG bond {float(rs.mean())}")
        check(bool(torch.isfinite(angs).all() & torch.isfinite(dihs).all()),
              "example 07: non-finite features")
        means.append(float(rs.mean()))
    print(f"  example 07: 24 atoms, 2 molecules, operator (8, 24) on the "
          f"card, CG graph 3/2/1, {len(means)} frames, mean CG bond "
          f"{', '.join(f'{m:.3f}' for m in means)}")


def example_09():
    """Reference example 09 (examples/09_cg_properties.py) on the card:
    8 five-atom molecules."""
    class Mol:
        def __init__(self, names, masses):
            self.names, self.masses = names, masses
            self.n_atoms = len(names)

        def __len__(self):
            return self.n_atoms

    mol = Mol(["O", "H1", "H2", "C1", "C2"], [16.0, 1.0, 1.0, 12.0, 12.0])
    mol_map = htt.matrix_mapping(mol, [["O", "H1", "H2"], ["C1", "C2"]])
    n_mol = 8
    sim = htt.Simulation(seed=0, device="cuda")
    sim.init_lattice(n_mol * 5, a=2.0)
    sim.bonds = [[5 * i + a, 5 * i + b] for i in range(n_mol)
                 for a, b in [(0, 1), (0, 2), (0, 3), (3, 4)]]
    mol_indices = htt.find_molecules(sim)
    check(len(mol_indices) == n_mol, f"{len(mol_indices)} molecules")
    mapping = htt.sparse_mapping([mol_map] * n_mol, mol_indices, system=sim)
    check(mapping.is_cuda, "example 09: the operator is not on the card")
    box_l = htt.box_size(sim.state.box)
    cg_pos = htt.center_of_mass(sim.state.positions, mapping, box_l)
    adj = np.zeros((2, 2))
    adj[0, 1] = adj[1, 0] = 1
    bonds, angles, dihedrals = htt.compute_cg_graph(
        DSGPM=False, adj_mat=adj, cg_beads=2)
    b, a, d = htt.mol_features_multiple(bnd_indices=bonds, molecules=n_mol,
                                        beads=2)
    r = htt.mol_bond_distance(CG=True, cg_positions=cg_pos, b1=b[:, 0],
                              b2=b[:, 1], box=sim.state.box)
    check(r.is_cuda and bool(torch.isfinite(r).all()) and
          bool((r > 0).all()), f"example 09: CG bond lengths {r}")
    print(f"  example 09: {n_mol} molecules of 5 atoms, operator "
          f"{tuple(mapping.shape)} on the card, CG positions "
          f"{tuple(cg_pos.shape)}, CG bonds "
          f"{[round(float(x), 3) for x in r[:4]]}")


def phase_cg_tools():
    """Phase 21: examples 07 and 09 on the card, then iter_from_trajectory
    over 20 frames of a 4,096-atom LJ run against the engine's 'n2'
    forces at the same positions."""
    t_phase = time.perf_counter()
    example_07()
    example_09()
    n, NN = 4096, 128
    sim = jittered_sim(n, htt.md.Minimize(max_disp=0.05), "cuda", seed=21)
    htt.tfcompute(make_simmodel(NN)).attach(sim, r_cut=R_CUT, nlist="n2")
    sim.run(30)
    sim.thermalize_velocities(1.5)
    sim.integrator = htt.md.NVT(kT=1.5, tau=0.5)
    frames, engine = [], []
    for _ in range(20):
        sim.run(5)
        frames.append(sim.state.positions.cpu().numpy())
        engine.append(sim.state.forces)
    L = float(sim._lengths[0])
    u = FrameUniverse(frames, L)
    model = make_simmodel(NN).to("cuda")
    worst = 0.0
    count = 0
    for (inputs, ts), want in zip(htt.iter_from_trajectory(
            NN, u, r_cut=R_CUT, device="cuda"), engine):
        check(all(x.is_cuda for x in inputs),
              "iter_from_trajectory's tensors are not on the card")
        nb = (inputs[0][..., :3] != 0).any(-1).sum(1)
        check(int(nb.max()) < NN, f"frame {ts.frame}: a full list")
        got = model(inputs)[0].detach()
        worst = max(worst, float((got[:, :3] - want[:, :3]).abs().max()))
        count += 1
    check(count == 20, f"{count} frames")
    check(worst <= 1e-4, f"trajectory forces differ from the engine's by "
          f"{worst:.3e}")
    print(f"  iter_from_trajectory: 20 frames of a {n}-atom LJ run (NN "
          f"{NN}, r_cut {R_CUT}), the model's forces vs the engine's 'n2' "
          f"forces at those positions: max diff {worst:.3e} (limit 1e-4); "
          f"phase {time.perf_counter() - t_phase:.1f} s")


F64 = None  # torch.float64, set in main()


def f64_compare(name, got, want, tol):
    """``max |got - want| <= tol * max |want|`` for float64 tensors (both
    float64, finite); returns the max abs error."""
    check(got.dtype == F64 and want.dtype == F64,
          f"{name}: not float64 ({got.dtype}, {want.dtype})")
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    print(f"  {name}: max_abs_err={err:.3e} max|ref|={scale:.3e} "
          f"err/(max|ref|)={err / scale:.3e} (limit {tol:g})")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    check(err <= tol * scale, f"{name}: disagrees beyond {tol:g} max|ref|")
    return err


def check_f64_state(sim, label):
    st = sim.state
    for name in ("positions", "velocities", "masses", "box", "forces",
                 "virial"):
        check(getattr(st, name).dtype == F64,
              f"{label}: state.{name} is {getattr(st, name).dtype}")


def oracle_rows(pos, L, rows, r_cut):
    """LJ forces on ``rows`` by the exact 27-image minimum image, float64,
    on the card (``oracle_27``'s arithmetic, orthorhombic, in row chunks)."""
    import itertools
    shifts = torch.tensor(list(itertools.product((-1, 0, 1), repeat=3)),
                          dtype=F64, device=pos.device) * L
    out = []
    for a in range(0, rows.numel(), 16):
        r = rows[a:a + 16]
        d = pos[None] - pos[r, None]
        cand = d[:, :, None, :] + shifts
        k = (cand * cand).sum(-1).argmin(-1)
        d = torch.gather(cand, 2, k[..., None, None].expand(
            -1, -1, 1, 3))[:, :, 0]
        rr = torch.linalg.norm(d, dim=-1)
        rr[torch.arange(r.numel()), r] = float("inf")
        m = rr <= r_cut
        rs = torch.where(m, rr, torch.full_like(rr, float("inf")))
        fmag = 24 * (2 * rs ** -13 - rs ** -7)
        out.append(-((fmag / torch.where(m, rr, torch.ones_like(rr)))
                     [..., None] * d).sum(1))
    return torch.cat(out)


def phase_fp64_eval(main_sps):
    """Phase 22: phase 4's eval protocol with a float64 state and model:
    every launch K1's double instantiation, the state float64 throughout,
    the forces against the float64 27-image oracle on rows of the final
    state, K1 double against its plain version."""
    from hoomd_tf_tpu_torch.ops import cellwise_cuda as cc
    k1 = cc.half_stencil_pair_forces
    t_phase = time.perf_counter()
    sim = jittered_sim(N, htt.md.Minimize(max_disp=0.05), "cuda", dtype=F64)
    sim.check_syncs = True
    tfc = htt.tfcompute(make_model(dtype=F64))
    tfc.attach(sim, r_cut=R_CUT, nlist="cellwise")
    k1.launches = k1.proxy_launches = k1.f64_launches = 0
    evals0 = sim.force_evals
    sim.run(60)
    sim.thermalize_velocities(1.5)
    sim.integrator = htt.md.NVT(kT=1.5, tau=0.5)
    sim.run(1000)
    dt, tl, te = timed_run(sim, 1000)
    th = healthy(sim, "float64 eval")
    check_f64_state(sim, "float64 eval")
    launches, evals = k1.launches, sim.force_evals - evals0
    check(launches > 0 and launches == evals,
          f"K1 launches {launches} != force evaluations {evals}")
    check(k1.f64_launches == launches and k1.proxy_launches == 0,
          f"{launches - k1.f64_launches} K1 launches were not double")
    plan = sim._layout.plan
    sps = 1000 / dt
    print(f"  plan grid {plan.grid} cap {plan.capacity}; T="
          f"{th['temperature']:.4f} PE/N={th['potential_energy'] / N:.6f}; "
          f"K1 launches {launches} == force evaluations {evals}, all double "
          f"(timed run {tl} for {te}); no host sync in the step loops")
    print(f"  float64 steps/s {sps:.2f} (timed run(1000)) against phase 4's "
          f"float32 {main_sps:.2f} ({sps / main_sps:.3f}x) on {smi_line()} "
          "-- info, not a claim")
    # the forces against the 27-image oracle on 256 rows spread over the box
    pos = sim.state.positions
    L = float(sim._lengths[0])
    rows = torch.arange(0, N, N // 256, device="cuda")
    want = oracle_rows(pos, L, rows, R_CUT)
    oracle_err = f64_compare("forces on 256 rows vs the float64 27-image "
                             "oracle", sim.state.forces[rows, :3], want,
                             F64_ORACLE_TOL)
    # K1 double against its plain version at the final state
    layout = sim._layout
    slot, aux = slot_state(layout, sim.state)
    form = htt.md.LennardJones(1.0, 1.0, r_cut=R_CUT).kernel_form()
    common = (slot.positions, slot.types, aux["valid"], layout.plan,
              layout.lo, form)
    kw = dict(needs_virial=True, geometry=layout.geometry)
    f_k, w_k = k1(*common, **kw)
    f_p, w_p = cc.half_stencil_plain(*common, **kw)
    torch.cuda.synchronize()
    err = max(f64_compare("K1 double, forces+energy (kernel vs plain)", f_k,
                          f_p, F64_K1_TOL),
              f64_compare("K1 double, virial (kernel vs plain)", w_k, w_p,
                          F64_K1_TOL))
    t_k = cuda_ms(lambda: k1(*common, needs_energy=False,
                             geometry=layout.geometry))
    t_p = cuda_ms(lambda: cc.half_stencil_plain(
        *common, needs_energy=False, geometry=layout.geometry), reps=11)
    nbytes, ops = k1_cost(slot.positions, aux["valid"], layout.plan, 3, form)
    b_ms, b_by = bound(nbytes, ops, PEAK_F64_PER_S)
    print(f"  K1 double, the whole call (forces only, the eval step's): "
          f"kernel {t_k:.4f} ms, plain {t_p:.4f} ms, bound {b_ms:.4f} ms "
          f"({b_by}: {nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} G float64 "
          f"operations at 34 TFLOP/s); phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                max_abs_err=err, launches=launches), oracle_err


def fp64_train_base():
    """The float64 set-up shared by phase 23's rows: the 64k fluid in
    float64, quenched and equilibrated (NVT, 400 steps) under a built-in
    LJ, as :func:`train_sim_attached` makes it."""
    sim = jittered_sim(N, htt.md.Minimize(max_disp=0.05), "cuda", dtype=F64)
    sim.add_force(htt.md.LennardJones(r_cut=R_CUT))
    sim.run(60)
    sim.thermalize_velocities(1.5)
    sim.integrator = htt.md.NVT(kT=1.5, tau=0.5)
    sim.run(400)
    th = sim.thermo()
    check_f64_state(sim, "float64 training set-up")
    check(1.1 < th["temperature"] < 1.9,
          f"float64 training system is not a healthy fluid: {th}")
    print(f"  float64 fluid equilibrated: T={th['temperature']:.4f}")
    return sim.state


def fp64_train_row(base, row):
    """One of phase 23's rows from ``base``: the model (``row`` 'proxy':
    phase 5's proxy NN; 'pair': phase 10's TrainableNNPair) in float64,
    trained with phase 5's protocol (Adam lr 1e-2, warm training, four
    timed run(200), 1400 committed steps) under check_syncs, every launch
    of its kernels double; the loss must fall below 0.3x."""
    import numpy as np
    from hoomd_tf_tpu_torch.ops import cellwise_cuda as cc
    from hoomd_tf_tpu_torch.ops import pair_train_cuda as pc
    k1, k2 = cc.half_stencil_pair_forces, pc.proxy_bwd_moments
    gen, bwd = cc.generic_pair_forces, cc.generic_reduce_bwd
    sim = htt.Simulation(dt=0.005, integrator=htt.md.NVT(kT=1.5, tau=0.5),
                         seed=0, device="cuda")
    sim.set_state(dataclasses.replace(base, thermostat={}))
    sim.add_force(htt.md.LennardJones(r_cut=R_CUT))
    model = make_nn(seed=0, proxy_degree=K_PROXY if row == "proxy" else None,
                    dtype=F64)
    model.compile(optimizer="adam", loss=force_loss, learning_rate=1e-2)
    tfc = htt.tfcompute(model)
    tfc.attach(sim, r_cut=R_CUT, nlist="cellwise", train=True)
    sim.check_syncs = True
    for f in (k1, k2, gen, bwd):
        f.launches = f.f64_launches = 0
    k1.proxy_launches = 0
    evals0, steps0 = sim.force_evals, sim.train_steps
    warm_train(sim)
    hist = tfc.loss_history
    loss0 = float(np.mean(hist[:50]))
    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.run(200)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    steps = sim.train_steps - steps0
    evals = sim.force_evals - evals0
    loss1 = float(np.mean(hist[-50:]))
    th = healthy(sim, f"float64 {row} row")
    check_f64_state(sim, f"float64 {row} row")
    check(len(hist) == 1400 <= steps,
          f"{len(hist)} losses of committed steps, {steps} steps attempted")
    check(bool(np.isfinite(hist).all()), "non-finite training loss")
    check(loss1 < 0.3 * loss0, f"loss did not fall: {loss0} -> {loss1}")
    for f in (k1, k2, gen, bwd):
        check(f.f64_launches == f.launches,
              f"{f.__name__}: {f.launches - f.f64_launches} launches not "
              "double")
    if row == "proxy":
        check(k2.launches == steps == k1.proxy_launches,
              f"K2 {k2.launches}, K1 proxy {k1.proxy_launches} launches "
              f"for {steps} train steps")
        check(k1.launches == evals, f"K1 launches {k1.launches} != "
              f"evaluations {evals}")
    else:
        check(bwd.launches == steps == gen.launches,
              f"generic_reduce_bwd {bwd.launches}, generic form "
              f"{gen.launches} launches for {steps} train steps")
        check(k1.proxy_launches == 0, "a proxy form launched")
        check(k1.launches == evals - gen.launches,
              f"K1 LJ launches {k1.launches} != label evaluations "
              f"{evals - gen.launches}")
    best = min(times)
    print(f"  float64 {row} row: 1400 committed, {steps} attempted; loss "
          f"(50-step windows) {loss0:.6f} -> {loss1:.6f} (ratio "
          f"{loss1 / loss0:.4f}, limit 0.3); T={th['temperature']:.4f}; all "
          f"launches double (K1 {k1.launches}, proxy {k1.proxy_launches}, "
          f"K2 {k2.launches}, generic {gen.launches}, generic_reduce_bwd "
          f"{bwd.launches}); no host sync")
    print(f"  float64 train steps/s {200 / best:.2f} (best of 4 timed "
          f"run(200), rounds {[round(t, 3) for t in times]} s) on "
          f"{smi_line()} -- info, not a claim")
    launches = dict(lj=k1.launches - k1.proxy_launches,
                    proxy=k1.proxy_launches, k2=k2.launches,
                    gen=gen.launches, bwd=bwd.launches)
    return sim, model, launches, 200 / best


def fp64_proxy_kernels(sim, model):
    """K1's proxy form and K2 in double at the proxy row's state against
    their plain versions (1e-11 max|F|, rtol 1e-10), their whole calls,
    the plain versions' and the bounds."""
    import numpy as np
    from hoomd_tf_tpu_torch.ops import cellwise_cuda as cc
    from hoomd_tf_tpu_torch.ops import pair_train_cuda as pc
    layout = sim._layout
    p = layout.plan
    slot, aux = slot_state(layout, sim.state)
    with torch.no_grad():
        form = model.pair_kernel_form(R_CUT, "cuda")
    check(form.table.dtype == F64, "the proxy's table is not float64")
    basis = model.proxy_parts(R_CUT, "cuda")[1].basis
    common = (slot.positions, slot.types, aux["valid"], p, layout.lo)
    kw = dict(min_r2=model.min_r2, geometry=layout.geometry)
    f_k, w_k = cc.half_stencil_pair_forces(*common, form, needs_virial=True,
                                           **kw)
    f_p, w_p = cc.half_stencil_plain(*common, form, needs_virial=True, **kw)
    torch.cuda.synchronize()
    k1_err = max(f64_compare("K1 double proxy, forces+energy (kernel vs "
                             "plain)", f_k, f_p, F64_K1_TOL),
                 f64_compare("K1 double proxy, virial (kernel vs plain)",
                             w_k, w_p, F64_K1_TOL))
    t_k = cuda_ms(lambda: cc.half_stencil_pair_forces(
        *common, form, needs_energy=False, **kw))
    t_p = cuda_ms(lambda: cc.half_stencil_plain(
        *common, form, needs_energy=False, **kw), reps=5)
    nbytes, ops = k1_cost(slot.positions, aux["valid"], p, 3, form)
    b_ms, b_by = bound(nbytes, ops, PEAK_F64_PER_S)
    k1_rec = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                  max_abs_err=k1_err)
    print(f"  K1 double proxy, the whole call (forces only, the train "
          f"forward): kernel {t_k:.4f} ms, plain {t_p:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} G "
          f"float64 operations)")
    ct = torch.as_tensor(np.random.RandomState(0).randn(p.n_slots, 4),
                         device="cuda")
    k2_err, k2_rec = 0.0, None
    for energy in (False, True):
        args = (slot.positions, slot.types, aux["valid"], ct, p, layout.lo,
                basis)
        kw2 = dict(min_r2=model.min_r2, needs_energy=energy,
                   geometry=layout.geometry)
        got = torch.cat([g.reshape(-1) for g in pc.proxy_bwd_moments(
            *args, **kw2)])
        want = torch.cat([g.reshape(-1) for g in pc.proxy_bwd_plain(
            *args, **kw2)])
        torch.cuda.synchronize()
        k2_err = max(k2_err, compare(
            f"K2 double, {'with energy' if energy else 'forces only'} "
            f"({got.numel()} moments, kernel vs plain)", got, want,
            rtol=F64_K2_RTOL, atol=F64_K2_RTOL * float(want.abs().max())))
        check(got.dtype == F64, "K2's moments are not float64")
        if k2_rec is None:
            t_k = cuda_ms(lambda: pc.proxy_bwd_moments(*args, **kw2))
            t_p = cuda_ms(lambda: pc.proxy_bwd_plain(*args, **kw2), reps=5)
            nbytes, ops = k2_cost(slot.positions, aux["valid"], p, K_PROXY,
                                  energy, got.numel())
            b_ms, b_by = bound(nbytes, ops, PEAK_F64_PER_S)
            k2_rec = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by)
            print(f"  K2 double, the whole call (forces only): kernel "
                  f"{t_k:.4f} ms, plain {t_p:.4f} ms, bound {b_ms:.4f} ms "
                  f"({b_by}: {nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} G "
                  "float64 operations)")
    k2_rec["max_abs_err"] = k2_err
    return k1_rec, k2_rec


def fp64_pair_kernels(sim):
    """``generic_reduce_bwd`` and K1's generic form (the training forward)
    in double at the pair row's state against their plain versions, lane
    by lane at 1e-11 max|g| and at 1e-11 max|F|; times and bounds."""
    import numpy as np
    from hoomd_tf_tpu_torch.ops import cellwise_cuda as cc
    layout = sim._layout
    plan = layout.plan
    st, aux = slot_state(layout, sim.state)
    tr = sim._route(layout, st, aux).trainer
    check(tr.kind == "pair", f"the pair row trained on {tr.kind!r}")
    common = (st.positions, st.types, aux["valid"], plan, layout.lo)
    lanes = cc.LaneBudget(sim._lanes.budget, "cuda")
    ct = torch.as_tensor(np.random.RandomState(0).randn(plan.n_slots, 4),
                         device="cuda")
    lst = cc.generic_list_plain(*common, min_r2=tr.min_r2,
                                geometry=layout.geometry, typed=tr.typed)
    check(lst["r2"].dtype == F64, "the plain list is not float64")
    err, rec = 0.0, None
    for energy in (False, True):
        lanes.reset()
        gl = cc.generic_list(*common, typed_fn=tr.typed, min_r2=tr.min_r2,
                             geometry=layout.geometry, lanes=lanes,
                             needs_energy=energy)
        check(gl.r2.dtype == F64, "the list is not float64")
        U, S = gl.evaluate(tr.pair_fn)
        cc.generic_reduce(gl, U, S, energy)
        gU, gS = cc.generic_reduce_bwd(gl, ct, energy)
        pU, pS = cc.generic_reduce_bwd_plain(lst, ct, aux["valid"], plan,
                                             energy)
        need = int(lanes.needed)
        check(not bool(lanes.overflow()), "the list overflowed")
        idx = cc.kernel_lane_index(lst, gl.cell_base, plan)
        check(need == lst["needed"] and bool(torch.equal(
            torch.sort(idx).values, torch.arange(need, device="cuda"))),
            "the kernel's list and the plain list differ")
        torch.cuda.synchronize()
        label = "with energy" if energy else "forces only"
        err = max(err, f64_compare(
            f"generic_reduce_bwd double gS, {label} (kernel vs plain, lane "
            "by lane)", gS[idx], pS, F64_BWD_TOL))
        check(int(torch.count_nonzero(gS[need:])) == 0,
              "the list's tail carries a gradient")
        if energy:
            err = max(err, f64_compare("generic_reduce_bwd double gU",
                                       gU[idx], pU, F64_BWD_TOL))
            continue
        t_k = cuda_ms(lambda: cc.generic_reduce_bwd(gl, ct, False))
        t_p = cuda_ms(lambda: cc.generic_reduce_bwd_plain(
            lst, ct, aux["valid"], plan, False), reps=5)
        nbytes, ops = bwd_cost(gl, need, False)
        b_ms, b_by = bound(nbytes, ops, PEAK_F64_PER_S)
        rec = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by)
        print(f"  generic_reduce_bwd double (forces only): kernel {t_k:.4f} "
              f"ms, plain {t_p:.4f} ms, bound {b_ms:.4f} ms ({b_by}: "
              f"{nbytes / 1e6:.2f} MB); {need} lanes of a {gl.budget}-lane "
              "list")
    rec["max_abs_err"] = err
    # the training forward (the generic form in double) against its plain
    # version, with the energy channel and the virial
    kw = dict(min_r2=tr.min_r2, geometry=layout.geometry)
    lanes.reset()
    f_k, w_k = cc.generic_pair_forces(*common, tr.pair_fn, typed_fn=tr.typed,
                                      needs_virial=True, lanes=lanes, **kw)
    f_p, w_p = cc.generic_plain(*common, tr.pair_fn, typed_fn=tr.typed,
                                needs_virial=True, lanes=None, **kw)
    torch.cuda.synchronize()
    gerr = max(f64_compare("K1 double generic, forces+energy (kernel vs "
                           "plain)", f_k, f_p, F64_K1_TOL),
               f64_compare("K1 double generic, virial (kernel vs plain)",
                           w_k, w_p, F64_K1_TOL))
    need = int(lanes.needed)
    fw = dict(needs_energy=tr.energy, **kw)
    t_k = cuda_ms(lambda: cc.generic_train_forces(
        *common, tr.pair_fn, typed_fn=tr.typed, lanes=lanes, **fw), reps=11)
    t_p = cuda_ms(lambda: cc.generic_plain(
        *common, tr.pair_fn, typed_fn=tr.typed, lanes=None, **fw), reps=3)
    nbytes, ops = k1_generic_cost(st.positions, aux["valid"], plan, 3, need)
    b_ms, b_by = bound(nbytes, ops, PEAK_F64_PER_S)
    print(f"  K1 double generic, the training forward's whole call (the "
          f"pair function with grad): {t_k:.4f} ms, plain {t_p:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.2f} MB)")
    gen = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
               max_abs_err=gerr)
    return rec, gen


def phase_fp64_packed(packed_sps):
    """Phase 24: phase 6's packed path in float64 (LJModel(64), the cell
    list selecting with K3's double instantiation), a timed run; K3 double
    against its plain version element for element; then a checkpoint:
    save, run(20), load, run(20)."""
    import tempfile
    from hoomd_tf_tpu_torch import serialize
    from hoomd_tf_tpu_torch.ops import cell_list as cl
    from hoomd_tf_tpu_torch.ops import nlist_cuda as nc
    from hoomd_tf_tpu_torch.ops.box import box_size
    k3 = nc.nlist_select
    NN = 64
    t_phase = time.perf_counter()
    sim = jittered_sim(N, htt.md.Minimize(max_disp=0.05), "cuda", dtype=F64)
    sim.check_syncs = True
    model = make_simmodel(NN, dtype=F64)
    tfc = htt.tfcompute(model)
    tfc.attach(sim, r_cut=R_CUT)
    build = sim._packed_build()
    check(build.method == "pallas",
          f"'auto' resolved to {build.method!r} on the card, not K3")
    k3.launches = k3.f64_launches = 0
    builds0 = sim.nlist_builds
    sim.run(60)
    sim.thermalize_velocities(1.5)
    sim.integrator = htt.md.NVT(kT=1.5, tau=0.5)
    sim.run(200)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run(PACKED_STEPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    th = healthy(sim, "float64 packed")
    check_f64_state(sim, "float64 packed")
    builds = sim.nlist_builds - builds0
    launches = k3.launches
    check(launches > 0 and launches == builds == k3.f64_launches,
          f"K3 launches {launches} (double {k3.f64_launches}) != nlist "
          f"builds {builds}")
    sps = PACKED_STEPS / dt
    grid, cap = sim._packed_build().plan
    print(f"  plan grid {grid} cap {cap}; T={th['temperature']:.4f}; K3 "
          f"launches {launches} == nlist builds {builds}, all double; no "
          f"host sync")
    print(f"  float64 packed steps/s {sps:.2f} (timed run({PACKED_STEPS})) "
          f"against phase 6's float32 {packed_sps:.2f} "
          f"({sps / packed_sps:.3f}x) on {smi_line()} -- info, not a claim")
    st = sim.state
    lengths = box_size(st.box)
    host_L = tuple(float(v) for v in lengths.cpu())
    slots4, counts, pid, ovf = cl.build_planes(st.positions4, grid, cap,
                                               lengths)
    check(not bool(ovf) and slots4.dtype == F64, "the double planes")
    args = (slots4, counts, pid, grid, cap, NN, R_CUT, host_L, N)
    got = k3(*args)
    want = nc.nlist_select_reference(*args)
    torch.cuda.synchronize()
    same = bool(torch.equal(got, want))
    print(f"  K3 double vs plain at the path's state: equal element for "
          f"element: {same}")
    check(same and got.dtype == F64,
          "K3 double disagrees with its plain version")
    t_k = cuda_ms(lambda: k3(*args))
    t_p = cuda_ms(lambda: nc.nlist_select_reference(*args), reps=5)
    # the yardstick: torch.topk over the plain version's int64 keys
    from hoomd_tf_tpu_torch.ops import cell_stencil as cs
    neigh = cs.neighbor_cells(grid, slots4.device)
    C = 27 * cap
    key = None
    keys = []
    for c0, c1 in cs.cell_chunks(int(grid[0] * grid[1] * grid[2]), cap):
        ddx, ddy, ddz, _, _, _ = cs.chunk_pairs(slots4, neigh, cap,
                                                lengths, c0, c1)
        keys.append(nc.selection_keys(ddx.reshape(-1, C), ddy.reshape(-1, C),
                                      ddz.reshape(-1, C), R_CUT,
                                      nc.slot_bits(C))[0])
    key = torch.cat(keys)
    del keys
    valid = (key != nc.FAR_KEY64).sum(1)[pid >= 0]
    t_lib = cuda_ms(lambda: torch.topk(key, NN, dim=1, largest=False,
                                       sorted=True), reps=5)
    nbytes, ops, pairs = k3_cost(slots4, counts, grid, cap, NN, N, valid)
    del key
    b_ms, b_by = bound(nbytes, ops, PEAK_F64_PER_S)
    print(f"  K3 double, the whole call: {t_k:.4f} ms, plain {t_p:.4f} ms, "
          f"topk yardstick (int64 keys given) {t_lib:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} G "
          "float64 operations)")
    rec = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
               library_ms=t_lib, max_abs_err=float((got - want).abs().max()),
               launches=launches)
    # a checkpoint: the restored state exact, the resumed run against the
    # uninterrupted one
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ckpt.pkl")
        serialize.save_checkpoint(path, model=model, sim=sim, tfc=tfc)
        saved = sim.state.positions.clone()
        sim.run(20)
        first = sim.state.positions.clone()
        serialize.load_checkpoint(path, model=model, sim=sim, tfc=tfc)
    check(bool(torch.equal(sim.state.positions, saved)),
          "the restored positions are not the saved ones")
    check_f64_state(sim, "restored")
    sim.run(20)
    resume_err = float((sim.state.positions - first).abs().max())
    bit_equal = bool(torch.equal(sim.state.positions, first))
    print(f"  checkpoint: restored positions bit-equal; the resumed run(20) "
          f"against the uninterrupted one: max |diff| {resume_err:.3e} "
          f"(limit {F64_RESUME_TOL:g}), bit-equal: {bit_equal}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    check(resume_err <= F64_RESUME_TOL, "the resumed run drifted")
    return rec


def main():
    global torch, htt, np
    if not os.path.isfile(os.path.join(HERE, "hoomd_tf_tpu_torch",
                                       "__init__.py")):
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np
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
    sources = ["cellwise_half", "cellwise_generic", "proxy_bwd",
               "nlist_select"]
    # one nvcc per source, started together
    with ThreadPoolExecutor(len(sources)) as ex:
        list(ex.map(_build.build_shared_library, sources))
    cc._library()
    cc._generic_library()
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
    k1_lj["launches"], main_sim, main_sps = phase_main()
    main_state = main_sim.state

    print("[5 train] 64k online training, north_star.py's flagship row")
    sim, model, launches = phase_train()
    train_sps = launches["sps"]
    k1_lj["launches"] += launches["lj"]
    k1_px, k2 = phase_train_kernels(sim, model)
    k1_px["launches"], k2["launches"] = launches["proxy"], launches["k2"]
    phase_train_small()

    print("[6 packed] 64k generic SimModel on the packed path (K3)")
    k3 = phase_packed()

    print("[7 generic] 64k LJPotential on 'cellwise': the probe and K1's "
          "generic form")
    gsim, k1_gen = phase_generic()
    torch.cuda.empty_cache()
    print("[8 nn] 64k NeuralPairPotential (RBF 32, 2 x 64) on 'cellwise'")
    k1_nn = phase_nn(gsim.state)
    print("[9 direct] 64k LJPotential on nlist='direct'")
    phase_direct(gsim.state)
    del gsim
    torch.cuda.empty_cache()

    print("[10 train-pair] 64k online training, north_star.py's non-proxy "
          "PairModel row (TrainableNNPair(64))")
    psim, ptr, pst, paux, pl, _ = phase_train_generic(
        "pair", make_nn(seed=0, proxy_degree=None), force_loss)
    k1_lj["launches"] += pl["lj"]
    print("  [kernel] generic_reduce_bwd at phase 10's state")
    bwd = phase_bwd_kernel(psim, ptr, pst, paux)
    bwd["launches"] = pl["bwd"]
    fwd = generic_forward_row(psim, ptr, pst, paux)
    fwd["launches"] = pl["gen"]
    del psim, ptr, pst, paux
    torch.cuda.empty_cache()
    print("[11 train-generic] 64k online training, north_star.py's generic "
          "SimModel row (TrainableNN(64), reference example 08)")
    gsim2, gtr, _, _, gl_, _ = phase_train_generic(
        "generic", make_nn_generic(seed=0), "mse")
    check(gtr.kind == "lane", f"TrainableNN trained on the {gtr.kind!r} "
          "route: the probe did not accept it")
    k1_lj["launches"] += gl_["lj"]
    bwd["launches"] += gl_["bwd"]
    fwd["launches"] += gl_["gen"]
    del gsim2, gtr
    torch.cuda.empty_cache()
    print("[12 train-packed] reference example 08's NNPotential on the "
          "packed path (K3), period 2")
    k3["launches"] += phase_train_packed()
    torch.cuda.empty_cache()
    print("[13 langevin] 64k LJ fluid, Langevin and Brownian dynamics")
    k1_lj["launches"] += phase_langevin()
    print("[14 npt] 64k LJ fluid, NPT through the dynamic-box layout")
    k1_lj["launches"] += phase_npt(main_sim)
    del main_sim
    torch.cuda.empty_cache()
    print("[15 triclinic] 64k LJ fluid in a tilted box")
    k1_lj["launches"] += phase_triclinic()
    torch.cuda.empty_cache()
    print("[16 logged] 64k LJ fluid: run(log_period=10) and period 5 on "
          "'cellwise'")
    k1_lj["launches"] += phase_logged(main_state, main_sps)
    torch.cuda.empty_cache()
    print("[17 stateful] reference example 04's model (WCARepulsion, "
          "MeanTensor of the RDF) at 64k on the packed route (K3)")
    launches, k3_err = phase_stateful()
    k3["launches"] += launches
    k3["max_abs_err"] = max(k3["max_abs_err"], k3_err)
    torch.cuda.empty_cache()
    print("[18 eds] reference example 03 (EDSLayer, Mean), 9 particles")
    phase_eds()
    print("[19 mapped] reference example 02's mapped CG model (LJ) at 64k "
          "atoms + 16k beads, on 'cell' and on 'cellwise'")
    phase_mapped(main_state)
    torch.cuda.empty_cache()
    print("[20 molsim] a MolSimModel of 16k four-atom molecules at 64k on "
          "the packed route (K3)")
    launches, k3_err = phase_molsim(main_state)
    k3["launches"] += launches
    k3["max_abs_err"] = max(k3["max_abs_err"], k3_err)
    del main_state
    torch.cuda.empty_cache()
    print("[21 cg-tools] reference examples 07 and 09, and "
          "iter_from_trajectory, on the card")
    phase_cg_tools()
    global F64
    F64 = torch.float64
    print("[22 fp64 eval] phase 4's eval protocol in float64: K1's double "
          "instantiation")
    k1_lj64, _ = phase_fp64_eval(main_sps)
    torch.cuda.empty_cache()
    print("[23 fp64 train] phases 5 and 10's rows in float64: K1 (proxy, "
          "generic), K2 and generic_reduce_bwd in double")
    base64 = fp64_train_base()
    sim64, model64, l64, sps64 = fp64_train_row(base64, "proxy")
    print(f"  float64 proxy row {sps64:.2f} train steps/s against phase 5's "
          f"float32 {train_sps:.2f} ({sps64 / train_sps:.3f}x)")
    k1_px64, k2_64 = fp64_proxy_kernels(sim64, model64)
    k1_px64["launches"], k2_64["launches"] = l64["proxy"], l64["k2"]
    k1_lj64["launches"] += l64["lj"]
    del sim64, model64
    torch.cuda.empty_cache()
    sim64, _, l64, sps64 = fp64_train_row(base64, "pair")
    print(f"  float64 pair row {sps64:.2f} train steps/s against phase 10's "
          f"float32 {pl['sps']:.2f} ({sps64 / pl['sps']:.3f}x)")
    bwd64, gen64 = fp64_pair_kernels(sim64)
    bwd64["launches"], gen64["launches"] = l64["bwd"], l64["gen"]
    k1_lj64["launches"] += l64["lj"]
    del sim64, base64
    torch.cuda.empty_cache()
    print("[24 fp64 packed] phase 6's packed path in float64 (K3's double "
          "instantiation), and a checkpoint resumed")
    k3_64 = phase_fp64_packed(k3["sps"])
    torch.cuda.empty_cache()
    check("jax" not in sys.modules, "JAX was imported")
    print(f"  total {time.perf_counter() - t_start:.1f} s")

    rows = [
        dict(name="K1 half-stencil pair forces, LJ form "
                  "(half_stencil_pair_forces)",
             source="hoomd_tf_tpu_torch/csrc/cellwise_half.cu", **k1_lj),
        dict(name="K1 half-stencil pair forces, Chebyshev-proxy form "
                  "(half_stencil_pair_forces)",
             source="hoomd_tf_tpu_torch/csrc/cellwise_half.cu", **k1_px),
        dict(name="K1 half-stencil pair forces, generic form, LJPotential's "
                  "synthesized pair function (generic_pair_forces; ms: the "
                  "whole call with the pair function)",
             source="hoomd_tf_tpu_torch/csrc/cellwise_generic.cu", **k1_gen),
        dict(name="K1 half-stencil pair forces, generic form, "
                  "NeuralPairPotential's synthesized pair function "
                  "(generic_pair_forces; ms: the whole call with the pair "
                  "function)",
             source="hoomd_tf_tpu_torch/csrc/cellwise_generic.cu", **k1_nn),
        dict(name="K1 half-stencil pair forces, generic form, training "
                  "forward of phases 10-11 (generic_train_forces: list, "
                  "the pair function with grad, reduction; ms: phase 10's "
                  "whole forward; launches: the train steps of phases "
                  "10-11 and phase 11's probe validation)",
             source="hoomd_tf_tpu_torch/csrc/cellwise_generic.cu", **fwd),
        dict(name="generic_reduce_bwd, the backward of K1's generic-form "
                  "reduction (training, phases 10-11)",
             source="hoomd_tf_tpu_torch/csrc/cellwise_generic.cu",
             replaces="hoomd_tf_tpu/ops/pair_train.py:161 (the XLA lane "
                      "contraction; no Pallas kernel)", **bwd),
        dict(name="K2 Chebyshev-proxy backward moments "
                  "(proxy_bwd_moments)",
             source="hoomd_tf_tpu_torch/csrc/proxy_bwd.cu",
             replaces="hoomd_tf_tpu/ops/pair_train_pallas.py:80", **k2),
        dict(name="K3 cell-list neighbor selection (nlist_select); "
                  "library_ms: torch.topk, selection only",
             source="hoomd_tf_tpu_torch/csrc/nlist_select.cu",
             replaces="hoomd_tf_tpu/ops/nlist_pallas.py:43", **k3),
        dict(name="K1 half-stencil pair forces, LJ form, float64 (the "
                  "double instantiation; launches: phases 22-23)",
             source="hoomd_tf_tpu_torch/csrc/cellwise_half.cu", **k1_lj64),
        dict(name="K1 half-stencil pair forces, Chebyshev-proxy form, "
                  "float64 (phase 23)",
             source="hoomd_tf_tpu_torch/csrc/cellwise_half.cu", **k1_px64),
        dict(name="K1 half-stencil pair forces, generic form, float64, "
                  "training forward of phase 23's pair row (ms: the whole "
                  "forward with the pair function)",
             source="hoomd_tf_tpu_torch/csrc/cellwise_generic.cu", **gen64),
        dict(name="generic_reduce_bwd, float64 (phase 23's pair row)",
             source="hoomd_tf_tpu_torch/csrc/cellwise_generic.cu",
             replaces="hoomd_tf_tpu/ops/pair_train.py:161 (the XLA lane "
                      "contraction; no Pallas kernel)", **bwd64),
        dict(name="K2 Chebyshev-proxy backward moments, float64 (phase 23)",
             source="hoomd_tf_tpu_torch/csrc/proxy_bwd.cu",
             replaces="hoomd_tf_tpu/ops/pair_train_pallas.py:80", **k2_64),
        dict(name="K3 cell-list neighbor selection, float64 (phase 24); "
                  "library_ms: torch.topk over int64 keys, selection only",
             source="hoomd_tf_tpu_torch/csrc/nlist_select.cu",
             replaces="hoomd_tf_tpu/ops/nlist_pallas.py:43", **k3_64),
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
