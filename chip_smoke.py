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
               versions at the train plan's shapes (K2 also with two
               types and a cutoff matrix, three and eight types: its tile
               path; two and eight timed), and a small-N SGD trajectory on
               the card against the CPU;
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
               (rtol 1e-10; K2 also with two, three and five types, its
               tile path, timed), generic_reduce_bwd lane by lane and K1's
               generic form (1e-11) against their plain versions, times
               and bounds;
24. fp64-packed -- phase 6's packed path (LJModel(64), the cell list with
               K3) in float64: a timed run(500), K3 double equal to its
               plain version element for element, its times; then
               save_checkpoint, run(20), load_checkpoint: the restored
               positions bit-equal, the resumed run(20) within 1e-9 of the
               uninterrupted one (bit-equal reported);
25. trajectory -- phase 4's 64k fluid runs 1000 NVT steps on 'cellwise'
               with a frame (positions, velocities, net forces, typeid,
               step) every 100 steps, written with write_gsd_frames (the
               package's own g++-built GSD library), read back by GSDFile
               bit-equal chunk for chunk; GSDUniverse's box; K1 launches
               equal to the force evaluations; MB and seconds printed;
26. offline -- reference examples 05 and 06 at 16,384 particles: an LJ
               fluid at density 0.3, r_cut 3, on 'cellwise' writes 20
               frames with forces; iter_from_trajectory(48,
               GSDUniverse(path), r_cut=3.0) feeds example 05's RDF
               (finite, maximum at 0.8 < r < 2.8, none below 0.85) and
               example 06's TrainableLJ (eps 0.8, sig 1.1, Adam 2e-2,
               8 to 18 epochs, ending within 0.2 of eps 1 and 0.1 of
               sig 1). Both packages build that list densely ([N, N, 3]),
               which sets the size;
27. profiling -- time_steps and benchmark_simulation (200 steps, 3 reps)
               on phase 25's simulation, finite and positive, beside phase
               4's rate; trace() around a run(50) writes a Chrome trace
               naming K1's kernel (a window that missed it is run again);
28. examples -- the eleven scripts of examples/torch run in-process as
               __main__ on the card, each gated by its own asserts, their
               seconds printed; PDBUniverse(peg2.pdb, traj=<a GSD of its
               frames>) iterated on the card;
29. sharded eval -- phase 4's NVT fluid and LJ PairModel through
               ShardedSimulation on a mesh of min(4, card count) cards,
               or 4 virtual shards on cuda:0 (printed): the plan's nz
               divisible by the shards; one resident evaluation (K1's
               group launch, one a device) against the unsharded K1
               (rtol = atol = 1e-4, and bit for bit when one card holds
               every shard), the group launch against its plain version
               on the same buffers (1e-4), each shard alone as its group
               of one against its slab plain version; the group launch, its
               plain version and shard 0 alone as a group of one timed;
               8 NVT steps with the repack interval pinned to 3 within
               5e-4 of the unsharded engine; a timed run(1000) with host
               syncs forbidden, 1.1 < T < 1.9, group launches = devices
               x evaluations and no other K1 launch; steps/s beside
               phase 4's;
30. sharded generic and 'n2' -- LJPotential(64) through ShardedSimulation
               (the probe accepts it: K1's generic form over each
               device's group, its pair function once a device on the
               joined list) with Langevin(1.5, 1.0) and run(200,
               log_period=10), host syncs forbidden: finite records,
               healthy T, group launches = pair-function calls = devices
               x evaluations; at one state against the unsharded generic
               form and each shard as its group of one against its slab
               plain version (1e-4), the group call, its plain version
               and shard 0 as a group of one timed; then the small-box fallback to the 'n2' rows (128
               particles, 50 steps);
31. parallel helpers -- halo_force_fn at 16,384 particles (x-slabs, the
               ring exchange) against the model on the whole system
               (rtol 1e-4, atol 1e-5); sharded_train_step over 8 frames
               of 4,096 particles: its SGD(1) update against one device's
               gradient (1e-4), and 30 Adam steps that halve the loss;
32. sharded train -- phase 5's row (the proxy NN) from phase 5's NVT
               state through ShardedSimulation on phase 29's mesh, the
               slot state resident per z-slab shard: the first train
               step's loss and every gradient against the unsharded
               engine's on the same state and plan (bit for bit on one
               card, else K2's bars); on the shards' resident buffers
               K2's group launch (one a card) against its plain version
               (the JAX bar), a group of every shard against the
               unsharded K2 bit for bit (else the cards' sum at the JAX
               bar), shard 0 as a group of one timed, K1's proxy form in
               one group launch (the training forward) against its plain
               version and timed; the coefficients' gradient through
               resident_train_forces and pair_train_forces(mesh=) against
               the unsharded one, the resident backward timed; 8 SGD train
               steps' losses and weights against the unsharded engine at
               the same plan (rtol 2e-4), then 300 Adam train steps and
               a profiled run(10), host syncs forbidden, the last 20
               losses' mean below the first 20's; K2 and K1's proxy form: group launches = cards x
               train steps and no other launch, the LJ labels in group
               launches only, the state a SlabState; train steps/s,
               kernels a train step and the first card's peak memory;
33. sharded train-pair and train-lane -- phases 10-11's rows from phase
               5's state through ShardedSimulation on the resident shards,
               220 train steps and a profiled run(10) each, host syncs
               forbidden, the plan held: the first train step against
               the unsharded engine's (the loss bit for bit on one card,
               the gradients at K2's bars: the list's order comes from an
               atomic counter; bit-equality printed), a weight gradient through resident_train_forces
               against the unsharded one (2e-4), each card's
               generic_reduce_bwd group launch on the resident buffers
               against its plain version lane by lane (1e-4 in float32; in
               float64 1e-10, the pair row), a group of every shard
               against the unsharded kernel bit for bit, shard 0 as a
               group of one timed; generic_reduce_bwd and the generic
               form's group calls = cards x train steps, no other launch,
               the state a SlabState; steps/s, kernels a train step, peak
               memory;
34. sharded npt -- phase 14's barostat (P = 1.2 x the NVT pressure) from
               phase 4's fluid through ShardedSimulation: 8 steps within
               5e-4 of the unsharded engine (volume 1e-5), run(1000) with
               host syncs forbidden, the volume down by 1% or more,
               repacks, no geometry flag, 1.1 < T < 1.9, group launches
               = devices x evaluations;
35. sharded planes -- a coupled LJ the probe rejects (energy scaled by the
               coordination over all rows' mean) through ShardedSimulation
               on the slot state resident per shard: the joined planes
               bit-equal to the unsharded planes, the first evaluation's
               forces against the unsharded planes route (1e-4), run(100)
               with host syncs forbidden beside the unsharded route, then
               50 steps of the planes training branch on the shards; the
               state resident after each run, K1 group launches = cards x
               label evaluations and no other K1 launch; steps/s, kernels
               a step and the first card's peak memory of each.
36. sharded packed -- phase 6's configuration (LJModel(64), 'auto' -> the
               cell list with K3) from phase 4's fluid through
               Simulation(mesh=) on phase 29's mesh: the packed grid has
               no divisor, so shard s takes the z-layers nz s // S on;
               K3's group mode, one launch a card a build; 8 steps
               equal to the unsharded engine's (1e-6; the lists are
               bit-equal), each card's group launch and shard 0 as a
               group of one (in place and on a joined buffer) against
               their group plain versions and the unsharded K3 (bit for
               bit), a group of every shard and the gathered list
               bit-equal to the unsharded K3's, the binning card's group
               call timed beside its group plain version, shard 0 as a
               group of one, torch.topk over its keys and its bound, the
               whole sharded build beside the unsharded one, then a timed
               run(200) with host syncs forbidden, group launches = cards
               x builds;
37. sharded direct -- phase 9's model (LJPotential(64) on 'direct'): each
               shard's particle rows' planes, gathered bit-equal to the
               whole planes; 8 steps equal to the unsharded engine's, a
               timed run(50) with host syncs forbidden;
38. sharded mapped -- phase 19's example 02 (65,536 atoms + 16,384 beads)
               through Simulation(mesh=) on 'cell' (the sort method per
               z-slab shard with the synthesized typed cut) and
               'cellwise' (the slot state resident per shard: the planes
               per shard, the beads written per shard): one step equal
               to the unsharded engine's (1e-6), then run(20) and run(10)
               logged every 2nd step under phase 19's gates, host syncs
               forbidden; on 'cellwise' the state resident, kernels a
               step and the first card's peak memory.
39. train-typed -- typed online training: phase 5's fluid made an 80:20
               Kob-Andersen mixture (types by a seeded permutation; the
               labels and driving forces its built-in LJ, epsilon [[1,
               1.5], [1.5, 0.5]], sigma [[1, 0.8], [0.8, 0.88]]), phase
               5's proxy NN made typed (the pair's one-hot as an extra
               input, proxy_types=2), Adam 1e-2, phase 5's warm training,
               the best of two timed run(200), host syncs forbidden: K2
               and K1's proxy form launched once a train step, the loss
               below 0.3x its start, 1.1 < T < 1.9, finite positions and
               forces; train steps/s beside phase 5's; at its state K1's
               typed proxy form and the typed K2 (the path's call, with
               energy beside the untyped call, eight types) against their
               plain versions, each timed; then the mixture in float64,
               run(100) with every launch double, and the double typed K2
               against its plain version (rtol 1e-10);
40. sharded train-typed -- phase 39's typed proxy training from phase 39's
               equilibrated mixture and the same seeded weights through
               ShardedSimulation on the resident shards: the first train
               step against the unsharded engine's (bit for bit on one
               card), then 200 Adam steps and a profiled run(10) with host
               syncs forbidden, the loss falling, beside phase 39's first 200; the typed K2 and
               K1's typed proxy form in group launches = cards x train
               steps and no other launch, the state a SlabState; steps/s
               beside phase 39's, kernels a train step, peak memory.

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


def k3_keys(slots4, grid, cap, lengths, group=None, joined=False):
    """K3's selection keys of every query slot over its 27 cells, in the
    plain version's arithmetic: ``[n_cells * cap, 27 cap]`` int32,
    ``FAR_KEY`` where invalid; with ``group`` (runs of layers) those of
    the group's home slots, in place on the cell table or (``joined``) on
    the group's joined buffer ``slots4``."""
    import numpy as np
    from hoomd_tf_tpu_torch.ops import cell_stencil as cs
    from hoomd_tf_tpu_torch.ops import nlist_cuda as nc
    if group is None:
        neigh, qcells = cs.neighbor_cells(grid, slots4.device), None
        m = int(np.prod(grid))
    else:
        qcells, neigh = cs.group_cells(grid, group, joined, slots4.device)
        m = qcells.shape[0]
    ddx, ddy, ddz, _, _, _ = cs.chunk_pairs(
        slots4, neigh, cap, lengths, 0, m,
        *(() if qcells is None else (qcells,)))
    C = 27 * cap
    key, _ = nc.selection_keys(ddx.reshape(-1, C), ddy.reshape(-1, C),
                               ddz.reshape(-1, C), R_CUT, nc.slot_bits(C))
    return key


#: back-to-back calls in a profiled window, and windows tried at most
PROFILED_CALLS = 10
PROFILED_TRIES = 5


def profiled_calls(fn):
    """Names of the CUDA kernels of ``PROFILED_CALLS`` back-to-back calls
    of ``fn`` and their summed device time in ms, the windows that were
    dropped before one was whole, and each kernel's time in ms.
    torch.profiler can leave the first kernels after it starts unrecorded
    (a window of 84-kernel calls lost its three opening markers; one of
    2-kernel calls lost its first 6 kernels three times in a row), so each
    window opens with 5 ms of the host's sleep, one uncounted call of
    ``fn``, then six marker kernels (``torch.cuda._sleep``) and a
    synchronize, ends with one more, and only the kernels between the last
    opening marker and the closing one count. A window without an opening and a closing marker, or whose
    count is no multiple of the calls, is run again, up to
    ``PROFILED_TRIES`` windows; then it raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for tries in range(PROFILED_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # a pause and a call the profiler may leave unrecorded, then
            # markers
            time.sleep(0.005)
            fn()
            torch.cuda.synchronize()
            for _ in range(6):
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


def train_sim_attached(model=None, loss=None, types=None, lj=None):
    """north_star.py's set-up on the port: the 64k fluid quenched and
    equilibrated (NVT, 400 steps) under a built-in LJ (default: epsilon =
    sigma = 1; ``types`` the particles' types, default all 0), which stays
    as the labels and the driving forces, then the model (default: the
    flagship row's proxy NN, force-matching loss) compiled (Adam, lr 1e-2)
    and attached with train=True: ``(sim, model)``."""
    sim = jittered_sim(N, htt.md.Minimize(max_disp=0.05), "cuda")
    if types is not None:
        sim.state.types = torch.as_tensor(types, dtype=torch.int32,
                                          device="cuda")
    sim.add_force(lj or htt.md.LennardJones(r_cut=R_CUT))
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
    types8 = (torch.arange(N, device=dev) % 8).to(torch.int32)
    ev8 = make_typed_pair_proxy(K_PROXY, r2_lo, rc2, 8, device=dev)[1]

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
             True),
            ("eight types (type pairs in "
             f"{len(pc.pair_groups(0, p.capacity, K_PROXY, 8))} pass)",
             types8, ev8.basis, None, True)):
        st = state if types is None else dataclasses.replace(state,
                                                             types=types)
        lay = SlotLayout(p, N, sim._lo, rc_matrix=rc, device=dev)
        slot, aux = slot_state(lay, st)
        args = (slot.positions, slot.types, aux["valid"], ct, p, lay.lo,
                basis)
        kw = dict(min_r2=model.min_r2, rc2_tab=lay.rc2_tab,
                  needs_energy=energy, geometry=lay.geometry)
        split = pc.proxy_bwd_moments.type_group_launches
        T = 1 if basis["pairs"] is None else len(
            {b for _, b in basis["pairs"]})
        got = torch.cat([g.reshape(-1) for g in pc.proxy_bwd_moments(
            *args, **kw)])
        check(pc.proxy_bwd_moments.type_group_launches - split ==
              (len(pc.pair_groups(0, p.capacity, K_PROXY, T)) > 1),
              f"K2 {label}: type pair passes not as planned")
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
        if types is types8 or types is types2:
            t_k = cuda_ms(lambda: pc.proxy_bwd_moments(*args, **kw))
            t_p = cuda_ms(lambda: pc.proxy_bwd_plain(*args, **kw), reps=1)
            nbytes, ops = k2_cost(slot.positions, aux["valid"], p, K_PROXY,
                                  energy, M)
            nbytes += 4 * p.n_slots  # the types
            b_ms, b_by = bound(nbytes, ops)
            print(f"  K2 {T} types, the whole call (with energy): kernel "
                  f"{t_k:.4f} ms, plain {t_p:.4f} ms, bound {b_ms:.4f} ms "
                  f"({b_by}: {nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} G "
                  "operations)")
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


def group_rows_read(bufs, grp):
    """Rows a group launch reads of its members' buffers (``bufs`` in
    group order, each ``(nzl + 1) * layer`` rows): a member's halo layer
    only where its next shard lies outside the group; otherwise the kernel
    reads that halo in place, as the next member's first home layer."""
    rows = 0
    for b, nxt, (_, nzl) in zip(bufs, grp.next, grp.slabs):
        n = b.shape[0]
        rows += n if nxt < 0 else n - n // (nzl + 1)
    return rows


def bwd_cost(gl, needed, energy):
    """Bytes and operations of the function generic_reduce_bwd computes
    on this list (a slab list's: its home cells and buffer rows): each
    listed cell's record (the words its header says it uses: a staged
    entry is 4 words, 8 in float64) read once, the cell bases, ``ct``
    [rows, 4] and ``valid`` read once, the budget's lanes
    of gS (and gU) written once, values of the list's size; per listed
    lane the displacement (3), the row and candidate weights (8 + 4) and
    the dot product (5)."""
    esize = gl.r2.element_size()
    hdr = gl.rec.view(gl.n_cells, -1)[:, :3].long()
    n0, total, nw = hdr[:, 0], hdr[:, 1], hdr[:, 2]
    words = (4 + (esize + 1) * total + n0 + 1 + n0 * nw +
             (n0 * nw + 1) // 2)
    # ct [rows, 4] and valid [rows] of each member of a group's list
    rows = (gl.rows if getattr(gl, "group", None) is None else
            group_rows_read(gl.valid, gl.group))
    nbytes = (4 * int(words.sum()) + 4 * gl.n_cells +
              rows * esize * (4 + 1) +
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
    the plain versions' and the bounds; K2 also with two, three and five
    types (slot % T, with energy), whose times it returns by T."""
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
    # two, three and five types: the tile path, every type pair in one
    # pass of a block that stages once
    from hoomd_tf_tpu_torch.ops.chebyshev import make_typed_pair_proxy
    typed = {}
    for T in (2, 3, 5):
        types = (torch.arange(N, device="cuda") % T).to(torch.int32)
        slot_t, aux_t = slot_state(layout, dataclasses.replace(
            sim.state, types=types))
        basis_t = make_typed_pair_proxy(
            K_PROXY, (0.25 * R_CUT) ** 2, R_CUT ** 2, T, dtype=F64,
            device="cuda")[1].basis
        args = (slot_t.positions, slot_t.types, aux_t["valid"], ct, p,
                layout.lo, basis_t)
        groups = pc.pair_groups(1, p.capacity, K_PROXY, T)
        split = pc.proxy_bwd_moments.type_group_launches
        got = torch.cat([g.reshape(-1) for g in pc.proxy_bwd_moments(
            *args, **kw2)])
        check(pc.proxy_bwd_moments.type_group_launches - split ==
              (len(groups) > 1) == 0,
              f"K2 double, {T} types: type pair passes not as planned")
        want = torch.cat([g.reshape(-1) for g in pc.proxy_bwd_plain(
            *args, **kw2)])
        torch.cuda.synchronize()
        k2_err = max(k2_err, compare(
            f"K2 double, {T} types ({len(groups)} pass of "
            f"{groups[0][1]} type pairs, {got.numel()} moments, kernel vs "
            "plain)", got, want,
            rtol=F64_K2_RTOL, atol=F64_K2_RTOL * float(want.abs().max())))
        t_k = cuda_ms(lambda: pc.proxy_bwd_moments(*args, **kw2))
        t_p = cuda_ms(lambda: pc.proxy_bwd_plain(*args, **kw2), reps=1)
        nbytes, ops = k2_cost(slot_t.positions, aux_t["valid"], p, K_PROXY,
                              True, got.numel())
        nbytes += 4 * p.n_slots  # the types
        b_ms, b_by = bound(nbytes, ops, PEAK_F64_PER_S)
        print(f"  K2 double, {T} types, the whole call (with energy): "
              f"kernel {t_k:.4f} ms, plain {t_p:.4f} ms, bound {b_ms:.4f} "
              f"ms ({b_by}: {nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} G "
              "float64 operations)")
        typed[T] = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms)
    k2_rec["max_abs_err"] = k2_err
    return k1_rec, k2_rec, typed


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


# ---------------------------------------------------------------------------
# Phases 25-28: GSD trajectory I/O, the profiling helpers, the examples
# ---------------------------------------------------------------------------

GSD_CHUNKS = ("configuration/step", "configuration/box", "particles/N",
              "particles/position", "particles/typeid",
              "particles/velocity", "log/particles/force")
EXAMPLES = ("01_quickstart", "02_mapped_cg_simulation", "03_eds_biasing",
            "04_particle_simulations", "05_running_from_trajectory",
            "06_force_matching", "07_cg_mapping_from_files",
            "08_nbody_neural_force_field", "09_cg_properties",
            "10_cg_force_matching", "11_external_models")


def example(name):
    """The globals of ``examples/torch/<name>.py`` (its main not run)."""
    import runpy
    return runpy.run_path(os.path.join(HERE, "examples", "torch",
                                       name + ".py"))


def gsd_chunks(path):
    """Every chunk of every frame of ``path``, read by the port:
    ``({(frame, name): array}, frames)``."""
    with htt.GSDFile(path) as f:
        return ({(i, name): f.read_chunk(i, name)
                 for i in range(f.nframes) for name in GSD_CHUNKS
                 if f.chunk_exists(i, name)}, f.nframes)


def phase_trajectory(state):
    """Phase 25: phase 4's 64k fluid (its NVT state) runs 1000 NVT steps
    on 'cellwise' with a frame every 100 steps, written with
    write_gsd_frames and read back bit-equal by GSDFile."""
    import shutil
    import tempfile
    import numpy as np
    from hoomd_tf_tpu_torch.ops import cellwise_cuda as cc
    k1 = cc.half_stencil_pair_forces
    t_phase = time.perf_counter()
    sim = htt.Simulation(dt=0.005, integrator=htt.md.NVT(kT=1.5, tau=0.5),
                         seed=0, device="cuda")
    sim.set_state(state)
    htt.tfcompute(make_model()).attach(sim, r_cut=R_CUT, nlist="cellwise")
    k1.launches = 0
    evals0 = sim.force_evals
    frames = []
    t0 = time.perf_counter()
    for _ in range(10):
        sim.run(100)
        st = sim.state
        frames.append({"positions": st.positions.clone(),
                       "velocity": st.velocities.clone(),
                       "forces": st.forces[:, :3].clone(),
                       "typeid": st.types.clone(), "step": st.step})
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches, evals = k1.launches, sim.force_evals - evals0
    check(launches > 0 and launches == evals,
          f"K1 launches {launches} != force evaluations {evals}")
    healthy(sim, "trajectory")
    box = htt.box_size(sim.state.box).cpu().numpy()
    tmp = tempfile.mkdtemp()
    try:
        path = os.path.join(tmp, "traj.gsd")
        t0 = time.perf_counter()
        htt.write_gsd_frames(path, frames, box=box)
        t_write = time.perf_counter() - t0
        mb = os.path.getsize(path) / 1e6
        host = [{k: v.cpu().numpy() if torch.is_tensor(v) else v
                 for k, v in fr.items()} for fr in frames]
        t0 = time.perf_counter()
        htt.write_gsd_frames(os.path.join(tmp, "host.gsd"), host, box=box)
        t_host = time.perf_counter() - t0
        t0 = time.perf_counter()
        got, nframes = gsd_chunks(path)
        t_read = time.perf_counter() - t0
        check(nframes == 10, f"{nframes} frames")
        for i, fr in enumerate(frames):
            want = {
                "configuration/step": np.array([fr["step"]], np.uint64),
                "particles/N": np.array([N], np.uint32),
                "particles/position": fr["positions"].cpu().numpy(),
                "particles/velocity": fr["velocity"].cpu().numpy(),
                "log/particles/force": fr["forces"].cpu().numpy(),
                "particles/typeid":
                    fr["typeid"].cpu().numpy().astype(np.uint32)}
            for name, w in want.items():
                g = got[(i, name)]
                check(g.dtype == w.dtype and g.shape == w.shape and
                      g.tobytes() == w.tobytes(),
                      f"frame {i} {name}: not read back bit-equal")
        u = htt.GSDUniverse(path)
        check(np.array_equal(u.dimensions[:3], box.astype(np.float32)) and
              np.allclose(u.dimensions[3:], 90.0),
              f"GSDUniverse box {u.dimensions} != {box}")
    finally:
        shutil.rmtree(tmp)
    print(f"  1000 NVT steps at N={N} on 'cellwise' in {t_run:.2f} s, 10 "
          f"frames (positions, velocities, net forces, typeid, step): "
          f"{mb:.2f} MB written from the card's tensors in {t_write:.3f} "
          f"s (from host copies {t_host:.3f} s), read back (every chunk) "
          f"in {t_read:.3f} s, bit-equal; GSDUniverse box "
          f"{u.dimensions[:3].tolist()}; K1 launches {launches} == force "
          f"evaluations {evals}; phase {time.perf_counter() - t_phase:.1f} "
          f"s")
    return launches, sim


def phase_offline(n=16384):
    """Phase 26: examples 05 and 06 at ``n`` particles from the card's own
    trajectory: an LJ fluid at density 0.3, r_cut 3, on 'cellwise' (K1)
    writes 20 frames with forces; iter_from_trajectory(48, GSDUniverse,
    r_cut=3.0) feeds example 05's MeanTensor RDF and example 06's
    TrainableLJ (eps 0.8, sig 1.1, Adam 2e-2, 8 to 18 epochs)."""
    import shutil
    import tempfile
    from hoomd_tf_tpu_torch.ops import cellwise_cuda as cc
    k1 = cc.half_stencil_pair_forces
    t_phase = time.perf_counter()
    ex05 = example("05_running_from_trajectory")
    ex06 = example("06_force_matching")
    sim = htt.Simulation(dt=0.002, integrator=htt.md.NVT(kT=1.0, tau=0.5),
                         seed=3, device="cuda")
    sim.init_lattice(n, density=0.3, kT_init=1.0)
    htt.tfcompute(make_model()).attach(sim, r_cut=R_CUT, nlist="cellwise")
    k1.launches = 0
    evals0 = sim.force_evals
    sim.run(200)
    frames = []
    for _ in range(20):
        sim.run(20)
        st = sim.state
        frames.append({"positions": st.positions.clone(),
                       "velocity": st.velocities.clone(),
                       "forces": st.forces[:, :3].clone(),
                       "typeid": st.types.clone(), "step": st.step})
    torch.cuda.synchronize()
    launches, evals = k1.launches, sim.force_evals - evals0
    check(launches > 0 and launches == evals,
          f"K1 launches {launches} != force evaluations {evals}")
    tmp = tempfile.mkdtemp()
    try:
        path = os.path.join(tmp, "lj_fluid.gsd")
        htt.write_gsd_frames(path, frames, box=htt.box_size(sim.state.box))
        del frames, sim
        t0 = time.perf_counter()
        rdf, rs = ex05["trajectory_rdf"](path, nn=48, r_cut=3.0,
                                         device="cuda")
        t_rdf = time.perf_counter() - t0
        peak = ex05["check_rdf"](rdf, rs)
        t0 = time.perf_counter()
        losses = []
        model = ex06["fit"](path, 48, 3.0, epochs=8, device="cuda",
                            log=losses.append)
        epochs = 8
        while epochs < 18:
            eps = float(model.eps.value.detach())
            sig = float(model.sig.value.detach())
            if abs(eps - 1.0) < 0.2 and abs(sig - 1.0) < 0.1:
                break
            ex06["fit"](path, 48, 3.0, epochs=1, device="cuda",
                        log=losses.append, model=model)
            epochs += 1
        t_fit = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp)
    eps = float(model.eps.value.detach())
    sig = float(model.sig.value.detach())
    check(abs(eps - 1.0) < 0.2 and abs(sig - 1.0) < 0.1,
          f"force matching ended at eps {eps}, sig {sig}")
    print(f"  N={n}, 20 frames from 'cellwise' (K1 launches {launches} == "
          f"force evaluations {evals}); example 05's RDF over the file "
          f"{t_rdf:.2f} s, max at r = {rs[peak]:.3f}, no density below "
          f"0.85; example 06's fit {epochs} epochs in {t_fit:.2f} s, last "
          f"{losses[-1].split('  ', 1)[1]}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return launches


def phase_profiling(sim, main_sps):
    """Phase 27: time_steps and benchmark_simulation on phase 25's 64k
    simulation, and trace() around a run(50), whose Chrome trace names
    K1's kernel. torch.profiler can leave the first kernels after it
    starts unrecorded, so a window that misses K1 is run again, up to
    PROFILED_TRIES windows."""
    import shutil
    import tempfile
    import numpy as np
    from hoomd_tf_tpu_torch.ops import cellwise_cuda as cc
    from torch.autograd import DeviceType
    k1 = cc.half_stencil_pair_forces
    t_phase = time.perf_counter()
    k1.launches = 0
    evals0 = sim.force_evals
    ts = htt.utils.time_steps(sim, 200, reps=3)
    bs = htt.utils.benchmark_simulation(sim, 200, reps=3)
    for k, v in list(ts.items()) + list(bs.items()):
        vals = np.atleast_1d(np.asarray(v, dtype=np.float64))
        check(bool(np.isfinite(vals).all() and (vals > 0).all()),
              f"{k} = {v}")
    tmp = tempfile.mkdtemp()
    try:
        for tries in range(PROFILED_TRIES):
            window = os.path.join(tmp, str(tries))
            with htt.utils.trace(window, device=sim.device) as prof:
                sim.run(50)
            k1_events = [e for e in prof.events()
                         if e.device_type == DeviceType.CUDA and
                         "half_stencil_forces" in e.name]
            files = os.listdir(window)
            check(len(files) == 1, f"trace files {files}")
            path = os.path.join(window, files[0])
            with open(path) as f:
                text = f.read()
            if k1_events and "half_stencil_forces" in text:
                break
        else:
            raise AssertionError(f"no trace of {PROFILED_TRIES} named K1's "
                                 "kernel")
        mb = os.path.getsize(path) / 1e6
    finally:
        shutil.rmtree(tmp)
    launches, evals = k1.launches, sim.force_evals - evals0
    check(launches == evals, f"K1 launches {launches} != force evaluations "
          f"{evals}")
    print(f"  time_steps(200, reps=3): {ts['steps_per_s']:.2f} steps/s "
          f"({ts['ms_per_step']:.4f} ms/step); benchmark_simulation(200, "
          f"reps=3): {bs['steps_per_s']:.2f} steps/s (mean "
          f"{bs['mean_s']:.4f} s, sd {bs['stddev_s']:.4f} s); phase 4's "
          f"timed run {main_sps:.2f} steps/s; on {smi_line()} -- info, not "
          f"a claim")
    print(f"  trace(run(50)): {len(k1_events)} K1 kernels recorded, "
          f"{mb:.2f} MB Chrome trace naming half_stencil_forces "
          f"({tries} window(s) dropped); K1 launches {launches} == force "
          f"evaluations {evals}; phase {time.perf_counter() - t_phase:.1f} s")
    return launches


def phase_examples():
    """Phase 28: the eleven port scripts of examples/torch in-process, as
    ``__main__`` on the card, each gated by its own asserts; then
    PDBUniverse(peg2.pdb, traj=<a GSD of its frames>)."""
    import runpy
    import shutil
    import tempfile
    import numpy as np
    from hoomd_tf_tpu_torch.utils.pdb_io import PDBUniverse
    t_phase = time.perf_counter()
    argv = sys.argv
    times = []
    for name in EXAMPLES:
        path = os.path.join(HERE, "examples", "torch", name + ".py")
        sys.argv = [path]
        t0 = time.perf_counter()
        try:
            runpy.run_path(path, run_name="__main__")
        finally:
            sys.argv = argv
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        print(f"  [example {name}] passed in {times[-1]:.2f} s")
    pdb = os.path.join(HERE, "tests", "fixtures", "peg2.pdb")
    u0 = PDBUniverse(pdb)
    frames = []
    for _ in u0.trajectory:
        frames.append({"positions": u0.atoms.positions.copy()})
    tmp = tempfile.mkdtemp()
    try:
        path = os.path.join(tmp, "peg2.gsd")
        htt.write_gsd_frames(path, frames, box=u0.dimensions[:3])
        u = PDBUniverse(pdb, traj=path)
        check(u.n_frames == len(frames), f"{u.n_frames} GSD frames")
        seen = 0
        for (inputs, ts), fr in zip(htt.iter_from_trajectory(
                8, u, r_cut=3.0, device="cuda"), frames):
            check(inputs[1].is_cuda and np.array_equal(
                ts.positions, fr["positions"]), f"GSD frame {seen}")
            seen += 1
        check(seen == len(frames), f"{seen} frames iterated")
    finally:
        shutil.rmtree(tmp)
    print(f"  PDBUniverse(peg2.pdb, traj=<GSD of its {seen} frames>): "
          f"{len(u.atoms)} atoms, frames equal, lists on the card; "
          f"examples {sum(times):.1f} s; phase "
          f"{time.perf_counter() - t_phase:.1f} s")


# ----------------------------------------------------------------------
# phases 29-31: parallel/ (the mesh, the sharded engine, the helpers)
# ----------------------------------------------------------------------
def shard_mesh():
    """The mesh of phases 29-31: the first min(4, count) cards when the
    machine has several, else 4 virtual shards on cuda:0 (four slab
    launches on one card)."""
    from hoomd_tf_tpu_torch.parallel import make_mesh
    count = torch.cuda.device_count()
    if count > 1:
        mesh = make_mesh(min(4, count))
        kind = (f"{mesh.size} cards "
                f"({', '.join(str(d) for d in mesh.devices)})")
    else:
        mesh = make_mesh(4, devices=[torch.device("cuda", 0)] * 4)
        kind = "4 virtual shards on cuda:0 (one card)"
    return mesh, kind


def slab_pair_counts(positions, valid, plan, z0, nzl):
    """``(tested, inside)`` of one z-slab shard's work: the half-stencil
    pairs of its home cells (``pair_counts``' count restricted to layers
    ``z0 .. z0 + nzl - 1``), and the pairs within the cut that its home
    cells own (a pair of two layers belongs to the lower one's cell, the
    half stencil reaching ``z + 1`` only)."""
    import numpy as np
    from hoomd_tf_tpu_torch.ops.cellwise import _HALF_OFFS
    nx, ny, nz = plan.grid
    home = np.zeros(nz, bool)
    home[z0:z0 + nzl] = True
    occ = valid.reshape(nz, ny, nx, plan.capacity).sum(-1).double()
    occ = occ.cpu().numpy()
    per = occ * (occ - 1) / 2
    for ox, oy, oz in _HALF_OFFS[1:]:
        per = per + occ * np.roll(occ, (-oz, -oy, -ox), axis=(0, 1, 2))
    tested = float(per[home].sum())
    dev = positions.device
    zc = (torch.arange(plan.n_slots, device=dev) // plan.capacity //
          (nx * ny))[valid > 0]
    real = positions[valid > 0]
    mine = (zc >= z0) & (zc < z0 + nzl)
    L = torch.as_tensor(plan.lengths, dtype=real.dtype, device=dev)
    hits = 0
    for a in range(0, real.shape[0], 1024):
        d = real[None, :, :] - real[a:a + 1024, None, :]
        d = d - torch.round(d / L) * L
        inside = (d * d).sum(-1) <= plan.r_cut ** 2
        zi, zj = zc[a:a + 1024, None], zc[None, :]
        own = torch.where((zj == zi) | (zj == (zi + 1) % nz), zi, zj)
        hits += int((inside & (own >= z0) & (own < z0 + nzl)).sum())
    return tested, (hits - int(mine.sum())) / 2


def resident_shards(sim):
    """The slot state a sharded run keeps resident per shard (its last
    run's, kept between runs): ``(slots, state, aux)``, each shard's
    buffers checked to hold ``(nzl + 1) * layer`` rows on its device."""
    from hoomd_tf_tpu_torch.md.state import SlabState
    slots, (st, aux) = sim._packed[1], sim._packed[2]
    check(isinstance(st, SlabState), "the sharded run's state is not "
          "resident per shard")
    for s, (dev, _, nzl) in enumerate(slots.slabs):
        p = st.shards[s]
        for t in (p.positions, p.velocities, p.forces, aux["valid"][s]):
            check(t.shape[0] == (nzl + 1) * slots.layer and
                  t.device == torch.device(sim.mesh.devices[s]),
                  f"shard {s}'s buffer: {tuple(t.shape)} on {t.device}")
    return slots, st, aux


def row_gate(sim, label, states=()):
    """The particle-order state a mesh simulation holds by rows per shard
    (``RowState``: shard s the rows ``n s // S`` on, each row field on its
    mesh device): its state after the run and each of ``states`` (the
    states its packed loop stepped through, :func:`watch_rows`) checked,
    the shards' row counts printed."""
    from hoomd_tf_tpu_torch.md.state import RowState, shard_rows
    fields = ("positions", "velocities", "types", "masses", "forces",
              "virial")
    S = sim.n_shards
    for st in (sim._state,) + tuple(states):
        check(isinstance(st, RowState), f"{label}: the state is a "
              f"{type(st).__name__}, not held by rows per shard")
        n = st.n_particles
        check(st.rows == shard_rows(n, S), f"{label}: rows {st.rows}")
        for s, (p, r) in enumerate(zip(st.shards, st.rows)):
            dev = torch.device(sim.mesh.devices[s])
            for f in fields:
                t = getattr(p, f)
                check(t.shape[0] == r.stop - r.start and t.device == dev,
                      f"{label}: shard {s}'s {f} {tuple(t.shape)} on "
                      f"{t.device}, not rows {r.start}-{r.stop - 1} on "
                      f"{dev}")
    st = sim._state
    print(f"  {label}: the state held by rows per shard after the run"
          + (f" and at each of its {len(states)} steps" if states else "")
          + f": {[r.stop - r.start for r in st.rows]} rows on "
          f"{[str(p.positions.device) for p in st.shards]}")


def between_runs_gate(sim, ref):
    """After a 'cellwise' run on a mesh: the state held by rows per shard
    (:func:`row_gate`), its read (the rows joined on the first card) equal
    to the whole-state gather of the slot shards the run kept, field for
    field, and to the unsharded engine ``ref``'s (printed; the positions
    gated by the caller)."""
    from hoomd_tf_tpu_torch.md.state import SimState
    row_gate(sim, "the state between 'cellwise' runs")
    slots, (st, aux) = sim._packed[1], sim._packed[2]
    w = slots.whole
    whole = slots.layout.unpack(SimState(
        positions=w(st.positions), velocities=w(st.velocities),
        types=w(st.types), masses=w(st.masses), box=st.box,
        forces=w(st.forces), virial=w(st.virial)), {"orig": w(aux["orig"])})
    got, want = sim.state, ref.state
    fields = ("positions", "velocities", "types", "masses", "forces",
              "virial")
    same = all(torch.equal(getattr(got, f), getattr(whole, f))
               for f in fields)
    diff = {f: float((getattr(got, f) - getattr(want, f)).abs().max())
            for f in ("velocities", "forces")}
    print(f"  the rows read equal to the slot shards' whole-state gather "
          f"(every field, bit for bit): {same}; against the unsharded "
          f"engine: max velocity difference {diff['velocities']:.3e}, "
          f"forces {diff['forces']:.3e}, bit for bit "
          f"{all(torch.equal(getattr(got, f), getattr(want, f)) for f in fields)}")
    check(same, "the rows between runs differ from the gather of the slot "
          "shards")


def watch_rows(sim):
    """The states ``sim``'s packed loop steps through, recorded after each
    step (a list; nothing is read back)."""
    seen = []
    step = sim._packed_step

    def spy(*args, **kw):
        out = step(*args, **kw)
        seen.append(out[0])
        return out
    sim._packed_step = spy
    return seen


def repack_gate(slots, st, aux):
    """One repack per shard (the migrating repack) of a run's resident
    state against ``repack_src`` and ``SlotLayout.rebuild`` of the
    gathered state: ``orig``, ``valid`` and every column bit for bit,
    no flag set, particles crossing slabs."""
    from hoomd_tf_tpu_torch.md.state import SimState
    from hoomd_tf_tpu_torch.ops import cellwise as cw
    layout, plan, n = slots.layout, slots.plan, slots.n
    w = slots.whole
    ws = SimState(positions=w(st.positions), velocities=w(st.velocities),
                  types=w(st.types), masses=w(st.masses), box=st.box,
                  forces=w(st.forces), virial=w(st.virial))
    dev = ws.positions.device
    waux = {"valid": w(aux["valid"]), "orig": w(aux["orig"]),
            "overflow": torch.zeros((), dtype=torch.bool, device=dev),
            "occ_max": torch.zeros((), dtype=torch.int32, device=dev),
            "vmax": torch.zeros((), device=dev)}
    t0 = time.perf_counter()
    new, naux = slots.rebuild(st.copy(), aux)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    g = layout.geom(ws)
    src, ovf = cw.repack_src(ws.positions, waux["valid"], slots.lo, plan,
                             geometry=g)
    n_slots = plan.n_slots
    want = torch.where(src < n_slots, waux["orig"][src.clamp_max(
        n_slots - 1).long()], n).to(torch.int32)
    same = (torch.equal(w(naux["orig"]), want) and
            torch.equal(w(naux["valid"]), (src < n_slots).to(
                waux["valid"].dtype)))
    wnew, _ = layout.rebuild(ws, waux)
    cols = all(torch.equal(w(getattr(new, f)), getattr(wnew, f)) for f in
               ("positions", "velocities", "types", "masses", "forces",
                "virial"))
    # particles whose shard changed
    bounds = [0]
    for s in range(len(slots.slabs)):
        bounds.append(bounds[-1] + slots.home(s))
    moved = 0
    for a, b in zip(bounds[:-1], bounds[1:]):
        s_ = src[a:b]
        moved += int(((s_ < n_slots) & ((s_ < a) | (s_ >= b))).sum())
    print(f"  one repack per shard at full width ({dt * 1e3:.1f} ms on the "
          f"host clock): orig and valid equal repack_src of the gathered "
          f"state {same}, every column SlotLayout.rebuild's {cols}; "
          f"{moved} particles changed shard; flag "
          f"{bool(naux['overflow'])}")
    check(same and cols and not bool(ovf) and
          not bool(naux["overflow"]),
          "the migrating repack differs from repack_src of the gathered "
          "state")


#: launches of K1 and of its generic form made by the mesh routes' own
#: runs in phases 32-38 and 40, by phase: (K1 group, K1 all, K1 proxy form, generic
#: group, generic all) launches; the comparisons and timings around the
#: runs are not counted.
SLAB_RUNS = {}


def slab_run(phase, run, *args, **kw):
    """``run(*args, **kw)``, a main-path run of a mesh route, with K1's and its generic form's counts set to 0 just before it and
    added to ``SLAB_RUNS[phase]`` just after it (then restored to what
    they were plus the run's, for the phase's own gates)."""
    from hoomd_tf_tpu_torch.ops import cellwise_cuda as cc
    k1, gen = cc.half_stencil_pair_forces, cc.generic_pair_forces
    counts = ((k1, "group_launches"), (k1, "launches"),
              (k1, "proxy_launches"), (gen, "group_launches"),
              (gen, "launches"))
    was = [getattr(fn, name) for fn, name in counts]
    for fn, name in counts:
        setattr(fn, name, 0)
    out = run(*args, **kw)
    got = tuple(getattr(fn, name) for fn, name in counts)
    for (fn, name), w, n in zip(counts, was, got):
        setattr(fn, name, w + n)
    SLAB_RUNS[phase] = tuple(a + b for a, b in zip(
        SLAB_RUNS.get(phase, (0,) * len(counts)), got))
    return out


def group_of_one(t, s, z0, nzl):
    """Shard ``s`` (home layers ``z0 .. z0 + nzl - 1``) alone on the device
    of ``t``: its group of one, its halo layer its own buffer's."""
    from hoomd_tf_tpu_torch.ops import cellwise as cw
    return cw.SlabGroup(t.device, (s,), ((z0, nzl),), (-1,), (-1,))


def mesh_devices(mesh):
    """The distinct devices of ``mesh``: the resident evaluation makes one
    grouped call of K1 on each per evaluation."""
    return len({str(d) for d in mesh.devices})


def phase_sharded(state, main_sps):
    """Phase 29: phase 4's fluid and LJ PairModel through
    ShardedSimulation on 'cellwise' (K1's group launch on each device over
    its shards; each shard alone as its group of one held against its
    slab plain version)."""
    from hoomd_tf_tpu_torch.ops import cellwise as cw
    from hoomd_tf_tpu_torch.ops import cellwise_cuda as cc
    from hoomd_tf_tpu_torch.md.state import SlabState
    from hoomd_tf_tpu_torch.parallel import ShardedSimulation
    k1 = cc.half_stencil_pair_forces
    mesh, kind = shard_mesh()
    S, D = mesh.size, mesh_devices(mesh)
    print(f"  mesh: {kind}; launch gates count one group launch per device "
          f"({D}) per evaluation, and no other K1 launch")
    sim = ShardedSimulation(dt=0.005, kT=1.5, tau=0.5, mesh=mesh, seed=0)
    sim.set_state(state)
    tfc = sim.attach(make_model(), r_cut=R_CUT)
    check(tfc.nlist_method == "cellwise",
          f"ShardedSimulation attached {tfc.nlist_method!r}, not cellwise")
    k1.launches = k1.group_launches = 0
    evals0 = sim.force_evals
    sim.run(200)
    for _ in range(3):
        plan = sim._layout.plan
        sim.run(500)
        if sim._layout.plan == plan:
            break
    launches, evals = k1.group_launches, sim.force_evals - evals0
    check(k1.launches == launches == D * evals,
          f"group launches {launches} (all K1 {k1.launches}) != {D} x "
          f"{evals} evaluations")
    layout = sim._ensure_layout()
    plan = layout.plan
    nx, ny, nz = plan.grid
    check(nz % S == 0, f"plan grid {plan.grid}: nz not divisible by {S}")
    nzl = nz // S
    layer = nx * ny * plan.capacity
    esize = state.positions.element_size()
    print(f"  plan grid {plan.grid} cap {plan.capacity}: {nzl} z-layers "
          f"({nzl * nx * ny} home cells, {nzl * layer} slab slots) a shard; "
          f"forward halo {layer} slots ({layer * esize * 5 / 1e6:.3f} MB of "
          f"positions, types and valid), reverse halo "
          f"{layer * esize * 4 / 1e6:.3f} MB of forces4")

    # one state, the run's resident shards: the sharded evaluation on them
    # against the unsharded K1 on the gathered state, each shard's resident
    # buffer as its group of one against its slab plain version, one
    # repack per shard against repack_src of the gathered state
    slots, st, aux = resident_shards(sim)
    repack_gate(slots, st, aux)
    form = sim._form
    whole = [slots.whole(t) for t in (st.positions, st.types, aux["valid"])]
    common = (*whole, plan, layout.lo)
    f_s, w_s = slots.pair_forces(st, aux, None, needs_virial=True,
                                 form=form)
    f_u, w_u = k1(*common, form, needs_virial=True, geometry=layout.geometry)
    torch.cuda.synchronize()
    err = max(compare("resident sharded forces+energy vs unsharded K1",
                      slots.whole(f_s), f_u),
              compare("resident sharded virial vs unsharded K1",
                      slots.whole(w_s), w_u))
    if D == 1:
        # the group of every shard adds the back sums across each boundary
        # in the unsharded order t = 1..13: the same sums, bit for bit
        same = (torch.equal(slots.whole(f_s), f_u) and
                torch.equal(slots.whole(w_s), w_u))
        print(f"  the {S}-virtual-shard group evaluation equals the "
              f"unsharded K1 bit for bit (forces, energy, virial): {same}")
        check(same, "the grouped evaluation differs from the unsharded K1")
    shards = cw.slab_layers(plan, S)
    geoms = slots.geoms(st)
    # the group launch of the first device's shards (every shard when one
    # card holds them) against its plain version on the same buffers
    grp = cw.slab_groups(cw.mesh_slabs(plan, mesh))[0]
    gbuf = [[t[s] for s in grp.members] for t in
            (st.positions, st.types, aux["valid"])]
    fg, wg = cc.half_stencil_group_forces(
        *gbuf, plan, layout.lo, form, grp, needs_virial=True,
        geometry=geoms[0])
    fgp, wgp = cw.half_stencil_group_plain(
        *gbuf, plan, layout.lo, form.evaluate, grp, needs_virial=True,
        with_types=form.ntypes > 1, geometry=geoms[0])
    torch.cuda.synchronize()
    m = len(grp.members)
    g_err = max(compare(f"group launch of {m} shards vs its plain version, "
                        "forces+energy", torch.stack(fg), torch.stack(fgp)),
                compare(f"group launch of {m} shards vs its plain version, "
                        "virial", torch.stack(wg), torch.stack(wgp)))
    del fg, wg, fgp, wgp
    for s, (z0, n) in enumerate(shards):
        buf = (st.shards[s].positions, st.shards[s].types, aux["valid"][s])
        g = geoms[s]
        (fk,), (wk,) = cc.half_stencil_group_forces(
            *([t] for t in buf), plan, layout.lo,
            cc.form_on(form, buf[0].device), group_of_one(buf[0], s, z0, n),
            needs_virial=True, geometry=g)
        fp, wp = cw.half_stencil_slab_plain(
            *buf, plan, layout.lo, form.evaluate, z0, n, needs_virial=True,
            with_types=form.ntypes > 1, geometry=g)
        torch.cuda.synchronize()
        err = max(err, compare(f"shard {s} (layers {z0}-{z0 + n - 1}) "
                               "as a group of one vs slab plain, "
                               "forces+energy", fk, fp),
                  compare(f"shard {s} as a group of one vs slab plain, "
                          "virial", wk, wp))
    # times at the main path's shapes (forces only): the resident
    # evaluation (halo copies, group launches, reverse-halo adds), the
    # same on the buffers of a fresh SlabSlots.pack of the gathered state,
    # the unsharded K1
    t_all = cuda_ms(lambda: slots.pair_forces(st, aux, None,
                                              needs_energy=False, form=form))
    pst, paux = slots.pack(sim.state)
    t_pack = cuda_ms(lambda: slots.pair_forces(pst, paux, None,
                                               needs_energy=False,
                                               form=form))
    del pst, paux
    t_one = cuda_ms(lambda: k1(*common, form, needs_energy=False,
                               geometry=layout.geometry))
    # the group launch of the first device's shards alone, its plain
    # version, and shard 0 alone as a group of one (a card holding one
    # shard)
    t_group = cuda_ms(lambda: cc.half_stencil_group_forces(
        *gbuf, plan, layout.lo, form, grp, needs_energy=False,
        geometry=geoms[0]))
    t_gplain = cuda_ms(lambda: cw.half_stencil_group_plain(
        *gbuf, plan, layout.lo, form.evaluate, grp, needs_energy=False,
        with_types=form.ntypes > 1, geometry=geoms[0]), reps=3)
    one = cw.SlabGroup(torch.device(mesh.devices[0]), (0,), (shards[0],),
                       (-1,), (-1,))
    buf0 = ([st.shards[0].positions], [st.shards[0].types],
            [aux["valid"][0]])
    t_one_g = cuda_ms(lambda: cc.half_stencil_group_forces(
        *buf0, plan, layout.lo, form, one, needs_energy=False,
        geometry=geoms[0]))
    nbytes, ops = k1_cost(whole[0], whole[2], plan, 3, form)
    b_ms, b_by = bound(nbytes, ops)
    tested, inside = slab_pair_counts(whole[0], whole[2], plan, *shards[0])
    s_bytes = (nzl + 1) * layer * esize * (3 + 1 + 4)
    s_ms, s_by = bound(s_bytes, 9 * tested + inside * (14 + 9))
    g_ms, g_by = (b_ms, b_by) if len(grp.members) == S else (s_ms, s_by)
    print(f"  resident sharded evaluation (forces only, median of CUDA "
          f"events): {t_all:.4f} ms for {D} group call(s) of {S} shards "
          f"(halo copies and reverse-halo adds between devices only); the "
          f"group launch alone {t_group:.4f} ms ({len(grp.members)} shards,"
          f" its plain version {t_gplain:.4f} ms); on a fresh "
          f"SlabSlots.pack of the gathered state {t_pack:.4f} ms; "
          f"unsharded K1 {t_one:.4f} ms "
          f"({t_all / t_one:.3f}x); bound {b_ms:.4f} ms ({b_by}: "
          f"{nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} G operations)")
    print(f"  shard 0 alone as a group of one: {t_one_g:.4f} ms, its bound "
          f"{s_ms:.4f} ms ({s_by}: {s_bytes / 1e6:.2f} MB, {tested:.4g} "
          f"pairs tested, {inside:.4g} inside the cut)")
    del whole, common, f_s, w_s, f_u, w_u

    # 8 steps with the repack interval pinned to 3 against the unsharded
    # engine from the same state
    ref = htt.Simulation(dt=0.005, integrator=htt.md.NVT(kT=1.5, tau=0.5),
                         seed=0, device="cuda")
    ref.set_state(sim.state)
    htt.tfcompute(make_model()).attach(ref, r_cut=R_CUT, nlist="cellwise")
    ref._plan_from_current = lambda: plan
    sim._choose_repack_interval = ref._choose_repack_interval = \
        lambda layout: 3
    l0, e0 = k1.group_launches, sim.force_evals
    sim.run(8)
    launches += k1.group_launches - l0
    evals += sim.force_evals - e0
    ref.run(8)
    del sim._choose_repack_interval
    d = sim.state.positions - ref.state.positions
    L = torch.as_tensor(sim._lengths, dtype=d.dtype, device=d.device)
    d = d - torch.round(d / L) * L
    dmax = float(d.abs().max())
    print(f"  8 NVT steps (K = 3) against the unsharded engine: max "
          f"position difference {dmax:.3e} (limit 5e-4)")
    check(dmax < 5e-4, "the sharded trajectory left the unsharded one")
    between_runs_gate(sim, ref)

    # the timed run, host syncs forbidden; the peak device memory of its
    # step loop above what stands before it
    sim.check_syncs = True
    l0, e0, a0 = k1.group_launches, sim.force_evals, k1.launches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    sim.run(1000)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(isinstance(sim._packed[2][0], SlabState),
          "the sharded run did not keep its state resident per shard")
    row_gate(sim, "phase 29's timed run")
    timed_l, timed_e = k1.group_launches - l0, sim.force_evals - e0
    launches += timed_l
    evals += timed_e
    check(timed_l == D * timed_e,
          f"timed run: group launches {timed_l} != {D} x {timed_e}")
    check(k1.launches - a0 == timed_l,
          "the sharded run launched an unsharded or a slab K1")
    th = healthy(sim, "sharded eval")
    sps = 1000 / dt
    print(f"  T={th['temperature']:.4f} PE/N={th['potential_energy'] / N:.4f}"
          f"; group launches {launches} == {D} x {evals} evaluations (timed "
          f"run: {timed_l}); no host sync in the step loop")
    print(f"  steps/s {sps:.2f} sharded against phase 4's {main_sps:.2f} "
          f"({sps / main_sps:.3f}x), {kind}, on {smi_line()} -- info, not "
          f"a claim")
    print(f"  timed run(1000): peak device memory {peak / 2**20:.1f} MiB, "
          f"{(peak - mem0) / 2**20:.1f} MiB above the {mem0 / 2**20:.1f} "
          f"MiB before it")
    return dict(ms=t_group, plain_ms=t_gplain, bound_ms=g_ms, bound_by=g_by,
                max_abs_err=max(err, g_err), launches=launches,
                sharded_ms=t_all, shard0_ms=t_one_g)


def phase_sharded_generic(state):
    """Phase 30: LJPotential(64) (a SimModel the probe accepts: K1's
    generic form in one group call a card) through ShardedSimulation with
    Langevin and run(200, log_period=10); then the small-box 'n2'
    fallback."""
    import numpy as np
    from hoomd_tf_tpu_torch.ops import cellwise as cw
    from hoomd_tf_tpu_torch.ops import cellwise_cuda as cc
    from hoomd_tf_tpu_torch.ops.lane_fast import synthesize_pair_fn
    from hoomd_tf_tpu_torch.parallel import ShardedSimulation
    gen = cc.generic_pair_forces
    mesh, kind = shard_mesh()
    S, D = mesh.size, mesh_devices(mesh)
    print(f"  mesh: {kind}; launch gates count one group call of the "
          f"generic form per device ({D}) per evaluation, its pair function "
          f"called once on the group's joined list")
    sim = ShardedSimulation(dt=0.005, mesh=mesh, seed=1,
                            integrator=htt.md.Langevin(kT=1.5, gamma=1.0))
    sim.set_state(state)
    model = htt.LJPotential(64)
    tfc = sim.attach(model, r_cut=R_CUT)
    gen.launches = gen.group_launches = 0
    # the pair function's calls on a group's joined list
    evaluate, pair_calls = cc.GenericList.evaluate, [0]

    def counted(gl, *a, **kw):
        pair_calls[0] += gl.group is not None
        return evaluate(gl, *a, **kw)
    cc.GenericList.evaluate = counted
    evals0, probe0 = sim.force_evals, sim.probe_evals
    sim.check_syncs = True
    try:
        t0 = time.perf_counter()
        sim.run(200, log_period=10)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        cc.GenericList.evaluate = evaluate
    check(tfc._lane_fast_ok is True,
          f"the probe did not accept LJPotential: {tfc._lane_fast_report}")
    evals = sim.force_evals - evals0 - (sim.probe_evals - probe0)
    launches = gen.group_launches
    check(launches == pair_calls[0] == D * evals and launches > 0,
          f"generic group launches {launches}, pair-function calls on a "
          f"joined list {pair_calls[0]}: not {D} x {evals} evaluations")
    log = sim.log
    check(len(log["step"]) == 20, f"{len(log['step'])} log records")
    for k, v in log.items():
        check(bool(np.isfinite(v).all()), f"non-finite logged {k}")
    th = healthy(sim, "sharded generic")
    print(f"  probe accepted; {launches} generic group launches and "
          f"pair-function calls == {D} x {evals} evaluations; 20 finite "
          f"records, mean T "
          f"{float(log['temperature'].mean()):.4f}; T={th['temperature']:.4f}"
          f"; run(200, log_period=10) {dt:.2f} s ({200 / dt:.2f} steps/s, "
          f"the probe's validation included); list budget "
          f"{sim._lanes.budget} a shard ({S} x that a group of {S}), need "
          f"{sim._lanes.committed} a shard")

    # one state, the run's resident shards: the sharded generic form on
    # them against the unsharded one on the gathered state, each shard's
    # resident buffer as its group of one against its slab plain version,
    # one repack per shard against repack_src
    layout = sim._ensure_layout()
    plan = layout.plan
    slots, st, aux = resident_shards(sim)
    repack_gate(slots, st, aux)
    fn = synthesize_pair_fn(model, st.box)
    whole = [slots.whole(t) for t in (st.positions, st.types, aux["valid"])]
    common = (*whole, plan, layout.lo)
    lanes = cc.LaneBudget(sim._lanes.budget, "cuda")
    whole_lanes = cc.LaneBudget(cc.lane_budget(plan, N), "cuda")
    kw = dict(needs_virial=True, geometry=layout.geometry)
    f_s, w_s = slots.pair_forces(st, aux, fn, with_types=True, lanes=lanes,
                                 needs_virial=True)
    f_u, w_u = gen(*common, fn, lanes=whole_lanes, **kw)
    torch.cuda.synchronize()
    check(not bool(lanes.overflow()) and not bool(whole_lanes.overflow()),
          "a generic-form list overflowed")
    err = max(compare("resident sharded generic forces+energy vs "
                      "unsharded", slots.whole(f_s), f_u),
              compare("resident sharded generic virial vs unsharded",
                      slots.whole(w_s), w_u))
    print(f"  bit for bit (information): "
          f"{torch.equal(slots.whole(f_s), f_u)} forces+energy, "
          f"{torch.equal(slots.whole(w_s), w_u)} virial")
    shards = cw.slab_layers(plan, S)
    geoms = slots.geoms(st)
    for s, (z0, n) in enumerate(shards):
        buf = (st.shards[s].positions, st.shards[s].types, aux["valid"][s])
        g = geoms[s]
        own = cc.LaneBudget(sim._lanes.budget, buf[0].device)
        (fk,), (wk,) = cc.generic_group_pair_forces(
            *([t] for t in buf), plan, layout.lo, fn,
            group_of_one(buf[0], s, z0, n), needs_virial=True, geometry=g,
            lanes=own)
        fp, wp = cw.half_stencil_slab_plain(
            *buf, plan, layout.lo, fn, z0, n, needs_virial=True,
            with_types=True, geometry=g)
        torch.cuda.synchronize()
        err = max(err, compare(f"shard {s} as a generic group of one vs "
                               "slab plain, forces+energy", fk, fp),
                  compare(f"shard {s} as a generic group of one vs slab "
                          "plain, virial", wk, wp))
    kw = dict(geometry=layout.geometry, needs_energy=False)
    t_all = cuda_ms(lambda: slots.pair_forces(
        st, aux, fn, with_types=True, lanes=lanes, needs_energy=False),
        reps=11)
    t_one = cuda_ms(lambda: gen(*common, fn, lanes=whole_lanes, **kw),
                    reps=11)
    buf = (st.shards[0].positions, st.shards[0].types, aux["valid"][0])
    g = geoms[0]
    own = cc.LaneBudget(sim._lanes.budget, "cuda")
    one = group_of_one(buf[0], 0, *shards[0])

    def shard0():
        return cc.generic_group_pair_forces(
            *([t] for t in buf), plan, layout.lo, fn, one, geometry=g,
            lanes=own, needs_energy=False)
    t_shard = cuda_ms(shard0, reps=11)
    # the group call of the first device's shards alone (list, the pair
    # function once, reduction, home pass) and its plain version
    grp = cw.slab_groups(cw.mesh_slabs(plan, mesh))[0]
    gbuf = [[t[s] for s in grp.members] for t in
            (st.positions, st.types, aux["valid"])]
    glanes = cc.LaneBudget(sim._lanes.budget, "cuda")
    fg, wg = cc.generic_group_pair_forces(
        *gbuf, plan, layout.lo, fn, grp, needs_virial=True, geometry=g,
        lanes=glanes)
    fgp, wgp, _ = cc.generic_group_plain(*gbuf, plan, layout.lo, fn, grp,
                                         needs_virial=True, geometry=g)
    torch.cuda.synchronize()
    check(not bool(glanes.overflow()), "the group's joined list overflowed")
    m = len(grp.members)
    g_err = max(compare(f"generic group call of {m} shards vs its plain "
                        "version, forces+energy", torch.stack(fg),
                        torch.stack(fgp)),
                compare(f"generic group call of {m} shards vs its plain "
                        "version, virial", torch.stack(wg), torch.stack(wgp)))
    del fg, wg, fgp, wgp
    t_group = cuda_ms(lambda: cc.generic_group_pair_forces(
        *gbuf, plan, layout.lo, fn, grp, geometry=g, lanes=glanes,
        needs_energy=False), reps=11)
    t_gplain = cuda_ms(lambda: cc.generic_group_plain(
        *gbuf, plan, layout.lo, fn, grp, geometry=g, needs_energy=False),
        reps=3)
    check(not bool(glanes.overflow()), "the group's joined list overflowed")
    own.reset()
    shard0()
    s_need = int(own.needed)
    tested, _ = slab_pair_counts(whole[0], whole[2], plan, *shards[0])
    esize = whole[0].element_size()
    s_bytes = buf[0].shape[0] * esize * (3 + 1 + 4) + s_need * esize * 5
    s_ms, s_by = bound(s_bytes, 9 * tested + s_need * 3 * 3)
    whole_lanes.reset()
    gen(*common, fn, lanes=whole_lanes, **kw)
    needed = int(whole_lanes.needed)
    nbytes, ops = k1_generic_cost(whole[0], whole[2], plan, 3, needed)
    b_ms, b_by = bound(nbytes, ops)
    g_ms, g_by = (b_ms, b_by) if len(grp.members) == S else (s_ms, s_by)
    print(f"  the generic form's group call of {len(grp.members)} shards "
          f"alone {t_group:.4f} ms (its plain version {t_gplain:.4f} ms, "
          f"its bound {g_ms:.4f} ms)")
    print(f"  resident sharded generic evaluation (forces only, the pair "
          f"function included): {t_all:.4f} ms for {S} shards; unsharded "
          f"{t_one:.4f} ms ({t_all / t_one:.3f}x); shard 0 alone as a "
          f"group of one {t_shard:.4f} ms, its bound {s_ms:.4f} ms ({s_by}: "
          f"{s_bytes / 1e6:.2f} MB, {s_need} lanes); bound of the whole "
          f"{b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.2f} MB, {needed} lanes)")
    del whole, common, f_s, w_s, f_u, w_u
    launches_main = launches

    # ShardedSimulation's small-box fallback: the dense build's rows
    small = ShardedSimulation(dt=0.002, kT=0.8, tau=0.5, mesh=mesh, seed=5)
    small.init_lattice(128, a=1.4, kT_init=0.8)
    stfc = small.attach(make_simmodel(24), r_cut=2.5)
    check(stfc.nlist_method == "n2", f"small box attached "
          f"{stfc.nlist_method!r}, not 'n2'")
    small.check_syncs = True
    small.run(50)
    t = small.thermo()
    check(np.isfinite(t["potential_energy"]) and
          0.1 < t["temperature"] < 3.0, f"small sharded 'n2' run: {t}")
    check(small.nlist_builds == 50, f"{small.nlist_builds} row builds")
    print(f"  small box (128 particles, a = 1.4): 'n2' rows over {S} shards,"
          f" 50 NVT steps, T={t['temperature']:.4f}, host syncs forbidden")
    return dict(ms=t_group, plain_ms=t_gplain, bound_ms=g_ms, bound_by=g_by,
                max_abs_err=max(err, g_err), launches=launches_main,
                sharded_ms=t_all, shard0_ms=t_shard)


def phase_parallel_helpers():
    """Phase 31: halo_force_fn at 16,384 particles against the model on
    the whole system, and sharded_train_step over 8 frames of 4,096."""
    import numpy as np
    from hoomd_tf_tpu_torch.models.module import get_state
    from hoomd_tf_tpu_torch.parallel import (domain_decompose,
                                             halo_force_fn,
                                             sharded_train_step)
    mesh, kind = shard_mesh()
    S = mesh.size
    print(f"  mesh: {kind}")
    n, r_cut, NN = 16384, 2.0, 32
    pos, lengths = htt.md.lattice_positions(n, a=1.1)
    rng = np.random.RandomState(4)
    pos = (pos + 0.05 * rng.randn(*pos.shape)).astype(np.float32)
    pos4 = np.concatenate([pos, np.zeros((n, 1), np.float32)], axis=1)
    L = float(lengths[0])
    box = htt.box_from_lengths(lengths, device="cuda")
    perm, counts = domain_decompose(pos4, box, S, r_cut=r_cut)
    cmax = int(counts.max())
    slabs, offs = [], 0
    for c in counts:
        slabs.append(np.concatenate([pos4[perm][offs:offs + c], np.full(
            (cmax - c, 4), np.nan, np.float32)]))
        offs += c
    sharded = torch.as_tensor(np.concatenate(slabs), device="cuda")
    model = make_simmodel(NN)
    p4 = torch.as_tensor(pos4, device="cuda")
    nlist = htt.compute_nlist(p4, r_cut, NN, [L, L, L], sorted=True,
                              return_types=True)
    want = model([nlist, p4, box])[0][torch.as_tensor(perm, device="cuda")]
    del nlist
    cap = 2048
    fn = halo_force_fn(model, r_cut, mesh, halo_capacity=cap)
    t0 = time.perf_counter()
    got, overflow, _ = fn(get_state(model), sharded, box)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(not bool(overflow), "halo buffers overflowed")
    rows = torch.cat([torch.arange(s * cmax, s * cmax + int(c))
                      for s, c in enumerate(counts)]).to("cuda")
    err = compare("halo_force_fn vs the model on the whole system",
                  got[rows], want, rtol=1e-4, atol=1e-5)
    print(f"  halo_force_fn: N {n}, {S} x-slabs of up to {cmax} rows, halo "
          f"capacity {cap}, {dt * 1e3:.1f} ms a call; max_abs_err {err:.3e}")

    # frame data parallelism: 8 frames of 4,096 particles
    nf, m, NNt = 8, 4096, 16
    base, lt = htt.md.lattice_positions(m, a=1.3)
    Lt = float(lt[0])
    boxt = htt.box_from_lengths(lt, device="cuda")
    lj = htt.md.LennardJones(r_cut=3.0)
    lab_sim = htt.Simulation(device="cuda")
    nls, p4s, labs = [], [], []
    for _ in range(nf):
        p = (base + 0.05 * rng.randn(m, 3)).astype(np.float32)
        q4 = torch.as_tensor(np.concatenate(
            [p, np.zeros((m, 1), np.float32)], axis=1), device="cuda")
        nl = htt.compute_nlist(q4, 3.0, NNt, [Lt] * 3, sorted=True,
                               return_types=True)
        lab_sim.init_state(p, [Lt] * 3)
        nls.append(nl)
        p4s.append(q4)
        labs.append(lj(lab_sim.state, nl)[0])
    nlist_b, pos4_b, labels_b = (torch.stack(x) for x in (nls, p4s, labs))

    class LJLayer(htt.Layer):
        def __init__(self):
            super().__init__(name="lj")
            self.w = self.add_weight(
                (2,), initializer=np.asarray([0.7, 1.2], np.float32),
                constraint=lambda x: torch.clamp_min(x, 0.0))

        def forward(self, r):
            r6 = htt.divide_no_nan(self.w[1] ** 6, r ** 6)
            return self.w[0] * 4.0 * (r6 ** 2 - r6) / 2.0

    class TrainableGraph(htt.SimModel):
        def setup(self):
            self.lj = LJLayer()

        def compute(self, nlist, positions, box):
            r = htt.safe_norm(nlist[:, :, :3], axis=2)
            return htt.compute_nlist_forces(nlist,
                                            torch.sum(self.lj(r), dim=1))

    class Seen(torch.optim.SGD):
        """Keeps the gradients a step hands it and moves nothing."""

        def step(self, closure=None):
            self.grads = [p.grad.clone() for p in
                          self.param_groups[0]["params"]]

    tg = TrainableGraph(NNt).to("cuda")
    tg([nlist_b[0], pos4_b[0], boxt])
    with torch.enable_grad():
        loss = torch.stack([
            torch.mean((tg([a, b, boxt], training=True)[0][:, :3] -
                        c[:, :3]) ** 2)
            for a, b, c in zip(nlist_b, pos4_b, labels_b)]).mean()
        (g1,) = torch.autograd.grad(loss, [tg.lj.w])
    seen = Seen(tg.trainable_weights(), lr=1.0)
    sharded_train_step(tg, seen, mesh)(nlist_b, pos4_b, boxt, labels_b)
    err = max(err, compare("frame-sharded grads vs one device",
                           seen.grads[0], g1, rtol=1e-4, atol=1e-6))
    step = sharded_train_step(tg, torch.optim.Adam(tg.trainable_weights(),
                                                   lr=5e-2), mesh)
    t0 = time.perf_counter()
    losses = [float(step(nlist_b, pos4_b, boxt, labels_b))
              for _ in range(30)]
    dt = time.perf_counter() - t0
    check(losses[-1] < 0.5 * losses[0],
          f"sharded training: loss {losses[0]:.4g} -> {losses[-1]:.4g}")
    print(f"  sharded_train_step: {nf} frames of {m} over {S} shards, 30 "
          f"Adam steps in {dt:.2f} s, loss {losses[0]:.4g} -> "
          f"{losses[-1]:.4g}")


# ----------------------------------------------------------------------
# phases 32-35: training, NPT and the planes route under a mesh
# ----------------------------------------------------------------------
def close_weights(label, got, want, rtol=2e-4, atol=1e-6):
    """``got`` and ``want`` (two models' weights) within rtol, atol."""
    import numpy as np
    worst = 0.0
    for a, b in zip(got.get_weights(), want.get_weights()):
        a = np.asarray(torch.as_tensor(a).cpu(), np.float64)
        b = np.asarray(torch.as_tensor(b).cpu(), np.float64)
        worst = max(worst, float((np.abs(a - b) /
                                  (atol + rtol * np.abs(b))).max()))
    print(f"  {label}: worst/bound={worst:.3f} (rtol {rtol}, atol {atol})")
    check(worst <= 1.0, f"{label}: the weights differ")


def sharded_train_pair(state, mesh, make, loss, sharded_only=False,
                       optimizer="adam"):
    """A ShardedSimulation on ``mesh`` and (unless ``sharded_only``) an
    unsharded Simulation on the card from ``state``, each with the
    built-in LJ (the labels and the driving forces) and a model from
    ``make()`` compiled (``optimizer``, lr 1e-2) and attached with
    train=True; the unsharded one pinned to the sharded plan (the loss
    averages over slot rows): ``[(sim, tfc, model), ...]``."""
    from hoomd_tf_tpu_torch.parallel import ShardedSimulation
    out = []
    for m in ((mesh,) if sharded_only else (mesh, None)):
        if m is None:
            sim = htt.Simulation(dt=0.005, seed=0, device="cuda",
                                 integrator=htt.md.NVT(kT=1.5, tau=0.5))
        else:
            sim = ShardedSimulation(dt=0.005, kT=1.5, tau=0.5, mesh=m,
                                    seed=0)
        sim.set_state(state)
        sim.add_force(htt.md.LennardJones(r_cut=R_CUT))
        model = make()
        model.compile(optimizer=optimizer, loss=loss, learning_rate=1e-2)
        tfc = htt.tfcompute(model)
        tfc.attach(sim, r_cut=R_CUT, nlist="cellwise", train=True)
        out.append((sim, tfc, model))
    plan = out[0][0]._ensure_layout().plan
    check(plan.grid[2] % mesh.size == 0,
          f"plan grid {plan.grid}: nz not divisible by {mesh.size}")
    if not sharded_only:
        out[1][0]._plan_from_current = lambda: plan
    return out


def compare_grads(label, got, want, params):
    scale = max(float(w.abs().max()) for w in want if w is not None)
    err = 0.0
    for i, (g, w, p) in enumerate(zip(got, want, params)):
        g = torch.zeros_like(p) if g is None else g
        w = torch.zeros_like(p) if w is None else w
        err = max(err, compare(f"{label} {i}", g, w, rtol=K2_RTOL,
                               atol=K2_ATOL_REL * scale))
    return err


def group_pair_counts(positions, valid, plan, group):
    """``(tested, inside)`` of a group's work: ``slab_pair_counts`` summed
    over its members' slabs."""
    tested = inside = 0.0
    for z0, nzl in group.slabs:
        t, i = slab_pair_counts(positions, valid, plan, z0, nzl)
        tested, inside = tested + t, inside + i
    return tested, inside


def resident_pack(sim):
    """The sharded engine's state packed resident per z-slab shard now
    (its layout's ``SlabSlots``; the pack writes every halo layer):
    ``(slots, state, aux)``."""
    from hoomd_tf_tpu_torch.md.state import SlabState
    slots = sim._slots(sim._ensure_layout())
    st, aux = slots.pack(sim.state)
    check(isinstance(st, SlabState) and not bool(aux["overflow"]),
          "the sharded training state is not resident per shard")
    return slots, st, aux


def members(tensors, grp):
    """``grp``'s members' buffers of each per-shard list in ``tensors``."""
    return [[t[s] for s in grp.members] for t in tensors]


def shard_cts(slots, ct):
    """The whole-state cotangent ``ct`` cut as each shard's buffer on its
    device: its home rows, then the next shard's first home layer in its
    halo rows (what the resident backward reads there)."""
    from hoomd_tf_tpu_torch.ops import cellwise as cw
    return [cw.slab_buffer(ct, slots.plan, z0, nzl, dev)
            for dev, z0, nzl in slots.slabs]


def train_step_grads(sim, slots, st, aux):
    """One training step of ``sim``'s trainer at ``(st, aux)`` (``slots``:
    the resident shards or the whole layout), its own labels, without the
    optimizer step: ``(loss, each trainable weight's gradient, the
    trainer)``."""
    tr = sim._route(sim._ensure_layout(), st, aux).trainer
    labels, _ = sim._builtins(st, aux, slots, tr.energy, False)
    loss, _ = tr.loss(st, aux, slots, labels)
    grads = torch.autograd.grad(loss, tr.params, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for g, p in zip(grads, tr.params)], tr


def first_step_gate(label, shd, ref, one_card, list_route=False):
    """The first train step on the sharded engine's resident shards
    against the unsharded engine's on the same state and plan. On one
    card (``one_card``: a group of every shard is the unsharded kernels'
    launch) the loss bit for bit, and every weight's gradient too but on
    the list route (``list_route``), whose joined list is ordered by an
    atomic counter, so that the MLP's backward sums its lanes in another
    order: there the gradients at K2's bars. On several cards the loss at
    rtol 1e-5 and the gradients at K2's bars. Bit-equality is printed
    either way. Returns the resident pack and the sharded engine's
    trainer."""
    slots, st, aux = resident_pack(shd)
    lay = ref._ensure_layout()
    check(lay.plan == slots.plan, f"{label}: the unsharded plan differs")
    wst, waux = slot_state(lay, ref.state)
    l_s, g_s, tr = train_step_grads(shd, slots, st, aux)
    l_u, g_u, _ = train_step_grads(ref, lay, wst, waux)
    same_loss = bool(torch.equal(l_s, l_u))
    same = same_loss and all(bool(torch.equal(a, b))
                             for a, b in zip(g_s, g_u))
    print(f"  {label}: the first train step on the resident shards against "
          f"the unsharded engine: loss {float(l_s):.9g} / {float(l_u):.9g} "
          f"(bit for bit: {same_loss}); the loss and {len(g_s)} gradients "
          f"bit for bit: {same}")
    if one_card:
        check(same_loss, f"{label}: the first train step's loss on the "
              "resident shards differs from the unsharded engine's")
    else:
        compare(f"{label}: the first train step's loss", l_s.reshape(1),
                l_u.reshape(1), rtol=1e-5, atol=0.0)
    if one_card and not list_route:
        check(same, f"{label}: the first train step's gradients on the "
              "resident shards differ from the unsharded engine's")
    else:
        compare_grads(f"{label}: the first train step's gradient", g_s,
                      g_u, tr.params)
    return slots, st, aux, tr


def train_kernels(sim, steps=10, md=False):
    """Device kernels per train step (``md``: per MD step) of
    ``sim.run(steps)`` by torch.profiler, counted between marker kernels
    as :func:`profiled_calls` counts (a window opens with a host sleep,
    one uncounted ``run(1)`` and six markers; a window that lost its
    markers is run again, up to ``PROFILED_TRIES``): ``(kernels a train
    step, the steps all windows ran, the counted kernels' names)``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    ran = 0
    for _ in range(PROFILED_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.005)
            sim.run(1)
            torch.cuda.synchronize()
            for _ in range(6):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            s0 = sim.train_steps
            sim.run(steps)
            n = steps if md else sim.train_steps - s0
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        ran += 1 + steps
        names = [e.name for e in sorted(
            prof.events(), key=lambda e: e.time_range.start)
            if e.device_type == DeviceType.CUDA]
        marks = [k for k, x in enumerate(names) if "spin_kernel" in x]
        if len(marks) >= 2 and marks[-1] > marks[-2] + 1:
            inside = names[marks[-2] + 1:marks[-1]]
            return len(inside) / n, ran, inside
    raise RuntimeError(f"torch.profiler lost the markers of "
                       f"{PROFILED_TRIES} windows")


def timed_train(phase, sim, steps):
    """``sim.run(steps)`` as a main-path run of ``phase`` (:func:`slab_run`),
    timed on the host clock around synchronizes, the first device's peak
    memory over it: ``(train steps/s, peak GB, its rise in GB above what
    stood before the run)``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(0)
    before = torch.cuda.memory_allocated(0)
    t0 = time.perf_counter()
    slab_run(phase, sim.run, steps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(0)
    return steps / dt, peak / 1e9, (peak - before) / 1e9


def k1_gate(phase, D, steps, field=2, probes=0):
    """Phase ``phase``'s K1 launches in its main-path runs: all group
    launches, and ``field`` of ``SLAB_RUNS`` (2: the proxy form, 3: the
    generic form's groups) ``D`` x its train steps; with ``field`` 3 the
    generic form launched outside a group once per validation of the
    lane-separability probe (``probes``, at a replan: on a whole pack of
    its own, an unsharded call) and at no other time."""
    n = SLAB_RUNS[phase]
    check(n[0] == n[1], f"phase {phase} launched K1 outside a group "
          f"launch: {n}")
    if field == 3:
        check(n[4] == n[3] + probes, f"phase {phase} launched the generic "
              f"form outside a group call other than {probes} probe "
              f"validation(s): {n}")
    check(n[field] == D * steps, f"phase {phase}: {n[field]} training "
          f"forward launches != {D} x {steps} train steps")


def phase_sharded_train(state, train_sps):
    """Phase 32: phase 5's row (the proxy NN) trained through
    ShardedSimulation from phase 5's NVT state on the slot state resident
    per z-slab shard: the labels, K1's proxy form and K2 in one group
    launch a card on the shards' own buffers. Returns K2's group record
    and K1's proxy-form group record."""
    import numpy as np
    from hoomd_tf_tpu_torch.ops import cellwise as cw
    from hoomd_tf_tpu_torch.ops import pair_train_cuda as pc
    from hoomd_tf_tpu_torch.ops.pair_train import (pair_train_forces,
                                                   resident_train_forces)
    k2 = pc.proxy_bwd_moments
    mesh, kind = shard_mesh()
    S, D = mesh.size, mesh_devices(mesh)
    print(f"  mesh: {kind}")
    (shd, stfc, sm), (ref, rtfc, rm) = sharded_train_pair(
        state, mesh, make_nn, force_loss, optimizer="sgd")
    slots, st, aux, _ = first_step_gate("proxy row", shd, ref, D == 1)
    layout, plan = slots.layout, slots.plan
    wst, waux = slot_state(layout, shd.state)
    geoms = slots.geoms(st)
    fit, ev = sm.proxy_parts(plan.r_cut, "cuda")
    with torch.no_grad():
        coeffs = fit(sm.pair_energy)
    ct = torch.as_tensor(np.random.RandomState(0).randn(
        plan.n_slots, 4).astype(np.float32), device="cuda")
    ct[:, 3] = 0.0  # the train path's forces-only cotangent
    cts = shard_cts(slots, ct)
    resident = (st.positions, st.types, aux["valid"], cts)
    kw = dict(min_r2=sm.min_r2, needs_energy=False)
    whole = torch.cat([g.reshape(-1) for g in k2(
        wst.positions, wst.types, waux["valid"], ct, plan, layout.lo,
        ev.basis, geometry=layout.geometry, **kw)])
    groups = cw.slab_groups(slots.slabs)
    acc, err, rec = None, 0.0, None
    for gi, grp in enumerate(groups):
        bufs = members(resident, grp)
        g = geoms[grp.members[0]]
        args = (*bufs, plan, layout.lo, ev.basis)
        got = torch.cat([x.reshape(-1) for x in k2(
            *args, geometry=g, group=grp, **kw)])
        want = torch.cat([x.reshape(-1) for x in pc.proxy_bwd_plain(
            *args, geometry=g, group=grp, **kw)])
        torch.cuda.synchronize()
        err = max(err, compare(
            f"K2 group of shards {grp.members} on {grp.device}, on their "
            "resident buffers, vs its plain version", got, want,
            rtol=K2_RTOL, atol=K2_ATOL_REL * float(want.abs().max())))
        if gi == 0:
            t_k = cuda_ms(lambda: k2(*args, geometry=g, group=grp, **kw))
            t_p = cuda_ms(lambda: pc.proxy_bwd_plain(
                *args, geometry=g, group=grp, **kw), reps=3)
            tested, inside = group_pair_counts(wst.positions, waux["valid"],
                                               plan, grp)
            esize = wst.positions.element_size()
            rows = group_rows_read(bufs[0], grp)
            nbytes = esize * (rows * (3 + 1 + 4) + got.numel())
            b_ms, b_by = bound(nbytes, 9 * tested +
                               inside * (27 + K_PROXY * (2 + 2)))
            # shard 0 alone: its group of one on its resident buffer
            one = cw.slab_groups(slots.slabs, whole=False)[0]
            oargs = (*members(resident, one), plan, layout.lo, ev.basis)
            t_one = cuda_ms(lambda: k2(*oargs, geometry=geoms[0], group=one,
                                       **kw))
            rec = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                       shard0_ms=t_one)
            print(f"  K2 group launch over shards {grp.members} "
                  f"(forces-only cotangent): {t_k:.4f} ms, its plain "
                  f"version {t_p:.4f} ms, its bound {b_ms:.4f} ms ({b_by}:"
                  f" {nbytes / 1e6:.2f} MB, {tested:.4g} pairs tested, "
                  f"{inside:.4g} inside); shard 0 as a group of one "
                  f"{t_one:.4f} ms")
        got = got.to("cuda")
        acc = got if acc is None else acc + got
    torch.cuda.synchronize()
    fwd = proxy_group_forward(slots, st, aux, groups[0], ev.kernel_form(
        coeffs), sm.min_r2, wst, waux)
    if len(groups) == 1 and len(groups[0].members) == S:
        same = bool(torch.equal(acc, whole))
        print(f"  K2's group of every shard equals the unsharded K2 bit for "
              f"bit: {same}")
        check(same, "K2's group of every shard differs from the unsharded "
              "K2")
    else:
        err = max(err, compare(
            f"K2 group moments summed over {D} cards vs the unsharded K2",
            acc, whole, rtol=K2_RTOL,
            atol=K2_ATOL_REL * float(whole.abs().max())))
    # the resident backward (the group calls on the shards' buffers and the
    # sum) against the unsharded one; the public mesh= keyword on a whole
    # state (split into shard buffers, the resident form, joined)
    p = {k: v.detach().clone().requires_grad_() for k, v in coeffs.items()}
    params = [p["c"], p["cd"]]
    f_s = resident_train_forces(p, ev, st.positions, st.types, aux["valid"],
                                plan, layout.lo, mesh, geoms, **kw)
    targs = (wst.positions, wst.types, waux["valid"], plan, layout.lo)
    f_u = pair_train_forces(p, ev, *targs, geometry=layout.geometry, **kw)
    f_m = pair_train_forces(p, ev, *targs, geometry=layout.geometry,
                            mesh=mesh, **kw)
    g_s = torch.autograd.grad(f_s, params, cts, retain_graph=True)
    g_u = torch.autograd.grad(f_u, params, ct, retain_graph=True)
    g_m = torch.autograd.grad(f_m, params, ct)
    compare_grads("resident_train_forces' coefficient gradient vs "
                  "unsharded", g_s, g_u, params)
    compare_grads("pair_train_forces(mesh=) coefficient gradient vs "
                  "unsharded", g_m, g_u, params)
    t_s = cuda_ms(lambda: torch.autograd.grad(
        f_s, params, cts, retain_graph=True), reps=11)
    t_u = cuda_ms(lambda: torch.autograd.grad(
        f_u, params, ct, retain_graph=True), reps=11)
    rec["sharded_ms"] = t_s
    print(f"  the whole resident backward ({D} K2 group calls on the "
          f"shards' buffers, the sum): {t_s:.4f} ms; unsharded (one K2) "
          f"{t_u:.4f} ms ({t_s / t_u:.3f}x)")
    del f_s, f_u, f_m, st, aux, wst, waux, cts, resident

    # the main path: 8 SGD steps against the unsharded engine (SGD: Adam's
    # normalized step turns the float32 rounding of a gradient element
    # near zero into steps of up to lr, tests/test_torch_train.py), then
    # phase 5's protocol, Adam, for 400 train steps, host syncs forbidden
    shd.check_syncs = True
    shd._choose_repack_interval = ref._choose_repack_interval = \
        lambda layout: 3
    k2.launches = k2.group_launches = 0
    steps0 = shd.train_steps
    slab_run("32", shd.run, 8)
    sgd_steps = shd.train_steps - steps0
    check(k2.group_launches == k2.launches == D * sgd_steps,
          f"K2 launches {k2.launches} (group {k2.group_launches}) != {D} x "
          f"{sgd_steps} train steps")
    resident_shards(shd)
    ref.run(8)
    a, b = np.asarray(stfc.loss_history), np.asarray(rtfc.loss_history)
    worst = float((np.abs(a - b) / (2e-4 * np.abs(b))).max())
    print(f"  8 SGD train steps against the unsharded engine: losses "
          f"worst/bound={worst:.3f} (rtol 2e-4)")
    check(len(a) == len(b) == 8 and worst <= 1.0,
          f"the sharded losses left the unsharded ones: {a} {b}")
    close_weights("8 SGD train steps' weights against the unsharded "
                  "engine", sm, rm)
    del shd, stfc, sm, ref, rtfc, rm
    (shd, stfc, sm), = sharded_train_pair(state, mesh, make_nn, force_loss,
                                          sharded_only=True)
    shd.check_syncs = True
    k2.launches = k2.group_launches = 0
    steps0 = shd.train_steps
    t0 = time.perf_counter()
    slab_run("32", shd.run, 100)
    torch.cuda.synchronize()
    dt_first = time.perf_counter() - t0
    sps, peak, rise = timed_train("32", shd, 300)
    per, ran, _ = slab_run("32", train_kernels, shd)
    steps = shd.train_steps - steps0
    hist = np.asarray(stfc.loss_history)
    check(len(hist) == 400 + ran <= steps,
          f"{len(hist)} losses of committed steps, {steps} attempted")
    check(bool(np.isfinite(hist).all()), "non-finite training loss")
    first, last = float(hist[:20].mean()), float(hist[-20:].mean())
    check(last < first, f"the loss did not fall: {first} -> {last}")
    launches = k2.group_launches
    check(launches == k2.launches == D * steps,
          f"K2 launches {k2.launches} (group {launches}) != {D} card(s) x "
          f"{steps} train steps")
    k1_gate("32", D, steps + sgd_steps)
    resident_shards(shd)
    th = healthy(shd, "sharded train")
    print(f"  Adam: {len(hist)} train steps ({steps} attempted, the first 100 in "
          f"{dt_first:.2f} s); loss (20-step windows) {first:.4f} -> "
          f"{last:.4f}; K2 group launches {launches} == {D} x {steps} == "
          f"all K2 launches, K1 launches of the runs (group, all, proxy "
          f"form) {SLAB_RUNS['32'][:3]}, the proxy form {D} a train step; "
          f"the state resident per shard; no host sync in the step loops; "
          f"T={th['temperature']:.4f}")
    print(f"  train steps/s {sps:.2f} (run(300)) against phase 5's "
          f"{train_sps:.2f} ({sps / train_sps:.3f}x); {per:.1f} kernels a "
          f"train step (profiler, run(10)); the first card's peak memory "
          f"{peak:.3f} GB ({rise:.3f} GB above what stood before the run); "
          f"{kind}, on {smi_line()} -- info, not a claim")
    rec.update(max_abs_err=err, launches=launches + D * sgd_steps)
    return rec, fwd


def proxy_group_forward(slots, st, aux, grp, form, min_r2, wst, waux):
    """K1's proxy form in one group launch over ``grp`` on the members'
    resident buffers (``st``, ``aux``), as the training forward under a
    mesh runs it (forces only), against its plain version; its time, its
    plain version's and its bound (the whole K1's, from the whole state
    ``wst``, for a group of every shard)."""
    from hoomd_tf_tpu_torch.ops import cellwise as cw
    from hoomd_tf_tpu_torch.ops import cellwise_cuda as cc
    plan = slots.plan
    bufs = members((st.positions, st.types, aux["valid"]), grp)
    g = slots.geoms(st)[grp.members[0]]
    form = cc.form_on(form, grp.device)
    args = (*bufs, plan, slots.lo)
    kw = dict(min_r2=min_r2, needs_energy=False, geometry=g)

    def kernel():
        return cc.half_stencil_group_forces(*args, form, grp, **kw)

    def plain():
        return cw.half_stencil_group_plain(*args, form.evaluate, grp, **kw)
    got, want = kernel()[0], plain()[0]
    torch.cuda.synchronize()
    err = compare(f"K1 proxy form, group of shards {grp.members} on their "
                  "resident buffers vs its plain version, forces",
                  torch.cat(got), torch.cat(want))
    t_k, t_p = cuda_ms(kernel), cuda_ms(plain, reps=3)
    if len(grp.members) == len(slots.slabs):
        nbytes, ops = k1_cost(wst.positions, waux["valid"], plan, 3, form)
    else:
        tested, inside = group_pair_counts(wst.positions, waux["valid"],
                                           plan, grp)
        esize = wst.positions.element_size()
        nbytes = (group_rows_read(bufs[0], grp) * esize * (3 + 1 + 4) +
                  form.tensor(grp.device).numel() * esize)
        ops = 9 * tested + inside * (8 * form.K + 10 + 9)
    b_ms, b_by = bound(nbytes, ops)
    print(f"  K1 proxy form, group launch over shards {grp.members} on their "
          f"resident buffers (the training forward, forces only): "
          f"{t_k:.4f} ms, its plain version {t_p:.4f} ms, its bound "
          f"{b_ms:.4f} ms ({b_by})")
    return dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                max_abs_err=err)


def group_bwd_check(label, shd, tr, slots, st, aux, cts, grp, dtype):
    """generic_reduce_bwd over ``grp``'s joined list of its members'
    resident buffers on the card against its plain version lane by lane
    (1e-4 in float32, 1e-10 in float64; the positions and cotangent cast
    to ``dtype``, and in float64 an analytic pair function): ``(max error,
    gS, the list, the lane index of the plain list in the kernel's, the
    lanes needed, the timing closures)``."""
    from hoomd_tf_tpu_torch.ops import cellwise as cw
    from hoomd_tf_tpu_torch.ops import cellwise_cuda as cc
    plan = slots.plan
    dev = grp.device
    bufs = [[x.to(dtype) if x.is_floating_point() else x for x in b]
            for b in members((st.positions, st.types, aux["valid"], cts),
                             grp)]
    g = (slots.geoms(st)[grp.members[0]] if dtype == torch.float32 else
         cw.SlotGeometry(plan, slots.lo, dtype, dev))
    rc = (None if slots.rc2_tab is None else slots.rc2_tab.to(dev, dtype))
    own = cc.LaneBudget(shd._lanes.budget, dev)
    gl = cc.generic_group_list(*bufs[:3], plan, slots.lo, grp,
                               typed_fn=tr.typed, min_r2=tr.min_r2,
                               rc2_tab=rc, geometry=g, lanes=own,
                               needs_energy=False)
    fn = (shd._on_device(tr.pair_fn, dev) if dtype == torch.float32 else
          (lambda r2, *t: (smooth_energy(r2), torch.zeros_like(r2))))
    U, Sv = gl.evaluate(fn)
    cc.generic_reduce(gl, U, Sv, False)
    gU, gS = cc.generic_reduce_bwd(gl, bufs[3], False)
    joined = cc.generic_group_list_plain(*bufs[:3], plan, slots.lo, grp,
                                         tr.min_r2, rc, g, typed=tr.typed)
    pU, pS = cc.generic_reduce_bwd_plain(joined, bufs[3], bufs[2], plan,
                                         False, group=grp)
    need = int(gl.needed)
    check(not bool(own.overflow()), "a group list overflowed")
    H = joined["cell"].new_tensor(slab_home_cells(plan, grp))
    idx = cc.kernel_lane_index(dict(cell=joined["member"] * H +
                                    joined["cell"]), gl.cell_base, plan)
    check(need == joined["needed"] and bool(torch.equal(
        torch.sort(idx).values.cpu(), torch.arange(need))),
        "the group kernel's list and its plain list differ")
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    name = (f"{label}: generic_reduce_bwd, {dtype}, group {grp.members} on "
            "its resident buffers, gS vs its plain version, lane by lane")
    err = (compare(name, gS[idx], pS, rtol=tol, atol=tol)
           if dtype == torch.float32 else
           f64_compare(name, gS[idx], pS, tol))
    check(int(torch.count_nonzero(gS[need:])) == 0,
          "a group list's tail carries a gradient")
    return err, gS, gl, idx, need, (lambda: cc.generic_reduce_bwd(
        gl, bufs[3], False)), (lambda: cc.generic_reduce_bwd_plain(
            joined, bufs[3], bufs[2], plan, False, group=grp))


def slab_home_cells(plan, grp):
    """Home cells of one member of ``grp``."""
    nx, ny, _ = plan.grid
    return grp.slabs[0][1] * nx * ny


def phase_sharded_train_generic(state, rates):
    """Phase 33: phases 10-11's non-proxy rows (TrainableNNPair(64),
    TrainableNN(64)) trained through ShardedSimulation from phase 5's NVT
    state on the slot state resident per z-slab shard: K1's generic form
    over each card's shards in one list on their own buffers, the pair
    function once on the joined list, and generic_reduce_bwd over the
    group."""
    import numpy as np
    from hoomd_tf_tpu_torch.ops import cellwise as cw
    from hoomd_tf_tpu_torch.ops import cellwise_cuda as cc
    from hoomd_tf_tpu_torch.ops.pair_train import (pair_train_forces,
                                                   resident_train_forces)
    bwd, gen = cc.generic_reduce_bwd, cc.generic_pair_forces
    mesh, kind = shard_mesh()
    S, D = mesh.size, mesh_devices(mesh)
    print(f"  mesh: {kind}")
    rec, launches, err = None, 0, 0.0
    rows = (("pair", lambda: make_nn(seed=0, proxy_degree=None), force_loss,
             rates[0]),
            ("lane", lambda: make_nn_generic(seed=0), "mse", rates[1]))
    for label, make, loss, rate in rows:
        (shd, tfc, model), (ref, _, _) = sharded_train_pair(state, mesh,
                                                            make, loss)
        slots, st, aux, tr = first_step_gate(f"{label} row", shd, ref,
                                             D == 1, list_route=True)
        del ref
        check(tr.kind == label, f"{label} row trained on {tr.kind!r}")
        layout, plan = slots.layout, slots.plan
        wst, waux = slot_state(layout, shd.state)
        geoms = slots.geoms(st)
        ct = torch.as_tensor(np.random.RandomState(0).randn(
            plan.n_slots, 4).astype(np.float32), device="cuda")
        ct[:, 3] = 0.0
        cts = shard_cts(slots, ct)
        kw = dict(min_r2=tr.min_r2, rcut_matrix=layout.rc2_tab,
                  needs_energy=False, with_types=tr.typed)
        # a weight gradient on the resident shards against the unsharded
        f_s = resident_train_forces(
            tr.named, tr.pair_apply, st.positions, st.types, aux["valid"],
            plan, layout.lo, mesh, geoms,
            lanes=cc.LaneBudget(shd._lanes.budget, "cuda"), **kw)
        f_u = pair_train_forces(
            tr.named, tr.pair_apply, wst.positions, wst.types,
            waux["valid"], plan, layout.lo, geometry=layout.geometry,
            lanes=cc.LaneBudget(cc.lane_budget(plan, N), "cuda"), **kw)
        g_s = torch.autograd.grad(f_s, tr.params, cts, retain_graph=True,
                                  allow_unused=True)
        g_u = torch.autograd.grad(f_u, tr.params, ct, retain_graph=True,
                                  allow_unused=True)
        compare_grads(f"{label} row: weights' gradient, resident vs "
                      "unsharded", g_s, g_u, tr.params)
        t_s = cuda_ms(lambda: torch.autograd.grad(
            f_s, tr.params, cts, retain_graph=True, allow_unused=True),
            reps=11)
        t_u = cuda_ms(lambda: torch.autograd.grad(
            f_u, tr.params, ct, retain_graph=True, allow_unused=True),
            reps=11)
        print(f"  {label} row: the whole resident backward ({D} "
              f"generic_reduce_bwd group calls, the pair function's "
              f"backward on each card's joined list) {t_s:.4f} ms; "
              f"unsharded {t_u:.4f} ms ({t_s / t_u:.3f}x)")
        del f_s, f_u
        # each card's backward kernel against its plain version
        groups = cw.slab_groups(slots.slabs)
        for gi, grp in enumerate(groups):
            e, gS, gl, idx, need, run_k, run_p = group_bwd_check(
                label, shd, tr, slots, st, aux, cts, grp, torch.float32)
            err = max(err, e)
            if gi == 0 and len(grp.members) == S:
                # the group of every shard against the unsharded kernel
                gl0 = cc.generic_list(wst.positions, wst.types,
                                      waux["valid"], plan, layout.lo,
                                      typed_fn=tr.typed, min_r2=tr.min_r2,
                                      rc2_tab=layout.rc2_tab,
                                      geometry=layout.geometry,
                                      lanes=cc.LaneBudget(gl.budget, "cuda"),
                                      needs_energy=False)
                U0, S0 = gl0.evaluate(tr.pair_fn)
                cc.generic_reduce(gl0, U0, S0, False)
                _, gS0 = bwd(gl0, ct, False)
                lst0 = cc.generic_list_plain(
                    wst.positions, wst.types, waux["valid"], plan,
                    layout.lo, tr.min_r2, layout.rc2_tab, layout.geometry,
                    typed=tr.typed)
                idx0 = cc.kernel_lane_index(lst0, gl0.cell_base, plan)
                same = bool(torch.equal(gS[idx], gS0[idx0]))
                print(f"  {label} row: generic_reduce_bwd over the group of "
                      f"every shard on their resident buffers equals the "
                      f"unsharded kernel lane by lane, bit for bit: {same}")
                check(same, "generic_reduce_bwd's group of every shard "
                      "differs from the unsharded kernel")
                del gl0, U0, S0, gS0, lst0, idx0
            if rec is None:
                t_k = cuda_ms(run_k)
                t_p = cuda_ms(run_p, reps=3)
                nbytes, ops = bwd_cost(gl, need, False)
                b_ms, b_by = bound(nbytes, ops)
                # shard 0 alone, as a group of one on its resident buffer
                one = cw.slab_groups(slots.slabs, whole=False)[0]
                buf = members((st.positions, st.types, aux["valid"], cts),
                              one)
                dev0 = buf[0][0].device
                rc = (None if layout.rc2_tab is None else
                      layout.rc2_tab.to(dev0))
                gl1 = cc.generic_group_list(
                    *buf[:3], plan, layout.lo, one, typed_fn=tr.typed,
                    min_r2=tr.min_r2, rc2_tab=rc, geometry=geoms[0],
                    lanes=cc.LaneBudget(shd._lanes.budget, dev0),
                    needs_energy=False)
                U1, S1 = gl1.evaluate(shd._on_device(tr.pair_fn, dev0))
                cc.generic_reduce(gl1, U1, S1, False)
                t_one = cuda_ms(lambda: bwd(gl1, buf[3], False))
                rec = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms,
                           bound_by=b_by, sharded_ms=t_s, shard0_ms=t_one)
                print(f"  generic_reduce_bwd group launch over shards "
                      f"{grp.members}: {t_k:.4f} ms, its plain version "
                      f"{t_p:.4f} ms, its bound {b_ms:.4f} ms ({b_by}: "
                      f"{nbytes / 1e6:.2f} MB, {need} lanes of a "
                      f"{gl.budget}-lane list); shard 0 as a group of one "
                      f"{t_one:.4f} ms")
                del gl1, U1, S1
            if gi == 0 and label == "pair":
                # and in double, on the same group (its own list: after
                # the timings of the float32 list, which it rewrites)
                e64 = group_bwd_check(label, shd, tr, slots, st, aux, cts,
                                      grp, torch.float64)[0]
                err = max(err, e64)
            del gl, gS
        del st, aux, wst, waux, cts, tr
        # the main path: 220 train steps, host syncs forbidden, replans
        # left on (each validates the probe anew: counted apart)
        shd.check_syncs = True
        bwd.launches = bwd.group_launches = 0
        key = f"33-{label}"
        steps0, probe0 = shd.train_steps, shd.probe_evals
        slab_run(key, shd.run, 20)
        sps, peak, rise = timed_train(key, shd, 200)
        per, ran, _ = slab_run(key, train_kernels, shd)
        steps = shd.train_steps - steps0
        probes = shd.probe_evals - probe0
        hist = np.asarray(tfc.loss_history)
        check(len(hist) == 220 + ran <= steps and
              bool(np.isfinite(hist).all()),
              f"{len(hist)} finite losses of committed steps, {steps} "
              "attempted")
        check(bwd.group_launches == D * steps == bwd.launches,
              f"generic_reduce_bwd group launches {bwd.group_launches} "
              f"(all {bwd.launches}) != {D} x {steps} train steps")
        k1_gate(key, D, steps, field=3, probes=probes)
        resident_shards(shd)
        launches += bwd.group_launches
        th = healthy(shd, f"sharded train-{label}")
        print(f"  {label} row: {len(hist)} train steps ({steps} attempted), "
              f"loss "
              f"{float(hist[:20].mean()):.4f} -> "
              f"{float(hist[-20:].mean()):.4f}; group launches "
              f"{bwd.group_launches} == {D} x {steps} == all launches, the "
              f"generic form's (group, all) {SLAB_RUNS[key][3:]}, "
              f"{probes} probe validation(s) at a replan; the state "
              f"resident per shard; no host sync; T={th['temperature']:.4f}; "
              f"train steps/s {sps:.2f} against phase "
              f"{10 if label == 'pair' else 11}'s {rate:.2f} "
              f"({sps / rate:.3f}x); {per:.1f} kernels a train step; the "
              f"first card's peak memory {peak:.3f} GB ({rise:.3f} above "
              f"what stood before) -- info, not a claim")
        del shd, tfc, model
        torch.cuda.empty_cache()
    rec.update(max_abs_err=err, launches=launches)
    return rec


def phase_sharded_npt(state):
    """Phase 34: phase 14's barostat through ShardedSimulation from phase
    4's NVT fluid: the dynamic-box layout planned with the mesh's divisor,
    K1's group launch with each step's box and virial."""
    from hoomd_tf_tpu_torch.ops import cellwise_cuda as cc
    from hoomd_tf_tpu_torch.parallel import ShardedSimulation
    k1 = cc.half_stencil_pair_forces
    mesh, kind = shard_mesh()
    S, D = mesh.size, mesh_devices(mesh)
    print(f"  mesh: {kind}; launch gates count one group launch per device "
          f"({D}) per evaluation")
    shd = ShardedSimulation(dt=0.005, kT=1.5, tau=0.5, mesh=mesh, seed=0)
    ref = htt.Simulation(dt=0.005, seed=0, device="cuda",
                         integrator=htt.md.NVT(kT=1.5, tau=0.5))
    for sim in (shd, ref):
        sim.set_state(state)
        htt.tfcompute(make_model(virial=True)).attach(sim, r_cut=R_CUT,
                                                      nlist="cellwise")
    shd.run(50)
    p0 = shd.thermo()["pressure"]
    check(p0 > 0, f"the NVT fluid's pressure {p0} is not positive")
    ref.set_state(shd.state)
    target = 1.2 * p0
    for sim in (shd, ref):
        sim.integrator = htt.md.NPT(kT=1.5, tau=0.5, P=target, tauP=0.5)
    layout = shd._ensure_layout()
    plan = layout.plan
    check(layout.dynamic_box and plan.grid[2] % S == 0,
          f"NPT under the mesh: dynamic {layout.dynamic_box}, grid "
          f"{plan.grid}")
    ref._plan_from_current = lambda: plan
    k1.launches = k1.group_launches = 0
    evals0 = shd.force_evals
    shd.check_syncs = True
    shd.run(8)
    ref.run(8)
    box_s = shd.state.box[1] - shd.state.box[0]
    box_r = ref.state.box[1] - ref.state.box[0]
    d = shd.state.positions - ref.state.positions
    d = d - torch.round(d / box_r) * box_r
    dmax = float(d.abs().max())
    dvol = float(abs(torch.prod(box_s) / torch.prod(box_r) - 1.0))
    print(f"  8 NPT steps against the unsharded engine: max position "
          f"difference {dmax:.3e} (limit 5e-4), volume {dvol:.3e} "
          f"relative")
    check(dmax < 5e-4 and dvol < 1e-5,
          "the sharded NPT trajectory left the unsharded one")
    vol0 = float(torch.prod(box_s))
    r0 = shd.repacks
    l0, e0 = k1.group_launches, shd.force_evals
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    shd.run(1000)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = k1.group_launches
    evals = shd.force_evals - evals0
    check(launches == D * evals and k1.group_launches - l0 ==
          D * (shd.force_evals - e0),
          f"group launches {launches} != {D} x {evals} evaluations")
    check(k1.launches - launches == ref.force_evals,
          "the sharded run launched an unsharded K1")
    th = healthy(shd, "sharded npt")
    vol1 = float(torch.prod(shd.state.box[1] - shd.state.box[0]))
    repacks = shd.repacks - r0
    repack_gate(*resident_shards(shd))
    slot, aux = slot_state(shd._layout, shd.state)
    check(not bool(shd._layout.geometry_bad(slot)),
          "the geometry flag is set")
    check(vol1 <= 0.99 * vol0, f"the volume fell by less than 1%: {vol0} "
          f"-> {vol1}")
    check(repacks > 0, "no repack ran")
    print(f"  NPT(P = 1.2 x {p0:.4f}): volume {vol0:.1f} -> {vol1:.1f} "
          f"({vol1 / vol0 - 1:+.4f}), {repacks} repacks, "
          f"T={th['temperature']:.4f}, P={th['pressure']:.4f}; group "
          f"launches {launches} == {D} x {evals}; no host sync; steps/s "
          f"{1000 / dt:.2f} (run(1000)) -- info, not a claim")
    return launches, 1000 / dt


def make_coupled(trainable, epsilon=1.0, sigma=1.0):
    """A many-body LJ the lane-separability probe rejects (it takes the
    planes route): each particle's LJ energy (epsilon, sigma its weights)
    scaled by its coordination over the mean coordination of all rows,
    a cross-row reduction; for training without output forces."""
    import numpy as np

    class CoupledLJ(htt.SimModel):
        def setup(self):
            self.w = self.add_weight(
                (2,), initializer=np.asarray([epsilon, sigma], np.float32),
                name="lj")

        def compute(self, nlist, positions, box):
            rinv = htt.nlist_rinv(nlist)
            sr6 = (self.w[1] * rinv) ** 6
            pe = self.w[0] * 2.0 * torch.sum(sr6 * sr6 - sr6, dim=1)
            coord = torch.sum(rinv, dim=1)
            e = pe * (1.0 + 0.05 * coord / torch.mean(coord))
            return htt.compute_nlist_forces(nlist, e)
    return CoupledLJ(64, output_forces=not trainable)


def phase_sharded_planes(state):
    """Phase 35: a SimModel the probe rejects through ShardedSimulation on
    the slot state resident per z-slab shard: each shard's planes built on
    its device from its own rows and its neighbours' boundary layers, the
    model run once on every row joined on the first card and its forces
    sent back per shard; run(100), then 50 steps of the planes training
    branch, whose labels take K1's group launch on the shards' buffers."""
    import numpy as np
    from hoomd_tf_tpu_torch.md.slots import SlabSlots
    from hoomd_tf_tpu_torch.ops import cellwise_cuda as cc
    from hoomd_tf_tpu_torch.parallel import ShardedSimulation
    k1 = cc.half_stencil_pair_forces
    mesh, kind = shard_mesh()
    D = mesh_devices(mesh)
    print(f"  mesh: {kind}")
    shd = ShardedSimulation(dt=0.005, kT=1.5, tau=0.5, mesh=mesh, seed=0)
    ref = htt.Simulation(dt=0.005, seed=0, device="cuda",
                         integrator=htt.md.NVT(kT=1.5, tau=0.5))
    tfcs = []
    for sim in (shd, ref):
        sim.set_state(state)
        tfcs.append(htt.tfcompute(make_coupled(False)))
        tfcs[-1].attach(sim, r_cut=R_CUT, nlist="cellwise")
    ls = shd._ensure_layout()
    plan = ls.plan
    ref._plan_from_current = lambda: plan
    lr = ref._ensure_layout()
    slots = shd._slots(ls)
    check(isinstance(slots, SlabSlots), "the planes route keeps a whole "
          "slot state under the mesh")
    sst, saux = slots.pack(shd.state)
    st, aux = slot_state(lr, ref.state)
    r_s, r_r = shd._route(ls, sst, saux), ref._route(lr, st, aux)
    check(r_s.planes and r_r.planes, "the probe accepted the coupled model")
    same = all(torch.equal(a, b) for a, b in
               zip(slots.planes(sst, saux), lr.planes(st, aux)))
    check(same, "the resident shards' joined planes differ from the "
          "unsharded planes")
    f_s, _ = shd._forces(sst, saux, slots, r_s, True, False)
    f_r, _ = ref._forces(st, aux, lr, r_r, True, False)
    torch.cuda.synchronize()
    f_s = slots.whole(f_s)
    err = compare("the first evaluation's forces+energy, resident planes "
                  "vs unsharded", f_s, f_r)
    print(f"  the joined planes equal the unsharded planes bit for bit: "
          f"{same}; the first evaluation bit for bit: "
          f"{bool(torch.equal(f_s, f_r))}")
    del f_s, f_r, r_s, r_r, sst, saux, st, aux
    torch.cuda.empty_cache()
    shd.check_syncs = True
    run_evals = 0

    def timed(sim, steps, phase=None):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(0)
        e0, p0 = sim.force_evals, sim.probe_evals
        t0 = time.perf_counter()
        if phase is None:
            sim.run(steps)
        else:
            slab_run(phase, sim.run, steps)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        evals = (sim.force_evals - e0) - (sim.probe_evals - p0)
        return steps / dt, torch.cuda.max_memory_allocated(0) / 2 ** 30, \
            evals
    sps, peak, evals = timed(shd, 100, "35")
    run_evals += evals
    resident_shards(shd)
    th = healthy(shd, "sharded planes")
    kern = train_kernels(shd, 10, md=True)[0]
    sps_r, peak_r, _ = timed(ref, 50)
    kern_r = train_kernels(ref, 10, md=True)[0]
    print(f"  run(100) on the resident planes route: {sps:.2f} steps/s, "
          f"{kern:.1f} kernels a step (profiler, run(10)), the first "
          f"card's peak memory {peak:.3f} GiB; the unsharded planes "
          f"route: {sps_r:.2f} steps/s (run(50)), {kern_r:.1f} kernels a "
          f"step, {peak_r:.3f} GiB (both simulations held); "
          f"T={th['temperature']:.4f}; no host sync -- info, not a claim")
    del ref
    torch.cuda.empty_cache()

    # the planes training branch
    trn = ShardedSimulation(dt=0.005, kT=1.5, tau=0.5, mesh=mesh, seed=0)
    trn.set_state(shd.state)
    del shd
    trn.add_force(htt.md.LennardJones(r_cut=R_CUT))
    model = make_coupled(True, epsilon=0.8, sigma=1.05)
    model.compile(optimizer="adam", loss=force_loss, learning_rate=1e-2)
    tfc = htt.tfcompute(model)
    tfc.attach(trn, r_cut=R_CUT, nlist="cellwise", train=True)
    trn.check_syncs = True
    tsps, tpeak, evals = timed(trn, 50, "35")
    run_evals += evals
    slots, st, aux = resident_shards(trn)
    kind_ = trn._route(trn._layout, st, aux).trainer.kind
    hist = np.asarray(tfc.loss_history)
    check(kind_ == "planes", f"the coupled model trained on {kind_!r}")
    check(len(hist) == 50 and bool(np.isfinite(hist).all()),
          f"{len(hist)} losses, finite {np.isfinite(hist).all()}")
    healthy(trn, "sharded planes training")
    n = SLAB_RUNS["35"]
    check(n[0] == n[1] == D * run_evals,
          f"phase 35's runs: K1 launches (group, all) {n[:2]} != {D} x "
          f"{run_evals} label evaluations")
    tkern = train_kernels(trn, 5)[0]
    w = model.w.detach().cpu().numpy()
    print(f"  50 train steps on the resident planes branch: loss "
          f"{hist[0]:.4f} -> {hist[-1]:.4f}, weights (0.8, 1.05) -> "
          f"({w[0]:.4f}, {w[1]:.4f}); {tsps:.2f} train steps/s, "
          f"{tkern:.1f} kernels a train step (profiler, run(5)); the "
          f"first card's peak memory {tpeak:.3f} GiB; K1 group launches "
          f"of the runs {n[0]} == {D} x {run_evals} label evaluations, no "
          f"other K1 launch -- info, not a claim")
    return err


# ----------------------------------------------------------------------
# phases 36-38: the packed routes and mapped models under a mesh
# ----------------------------------------------------------------------
def k3_group_cost(counts, grid, cap, nn, n, runs, valid_per_row, esize,
                  joined=False):
    """Bytes and operations of one K3 group call over the runs of layers
    ``runs`` of a state of ``n`` particles: the slots and counts of every
    layer its windows reach (its home layers and the layer on each side of
    each run) read once; in place the particle ids of its home slots read
    once and the rows of its held particles and of the particles without a
    slot written once; joined (``joined``) the rows of its occupied home
    slots written once; and ``k3_cost``'s operations for its home queries
    against their 27 cells. A group of every layer in place is
    ``k3_cost``'s call exactly. Returns ``(bytes, operations, pairs)``."""
    from hoomd_tf_tpu_torch.ops.cell_stencil import neighbor_cells
    nx, ny, nz = grid
    cells = nx * ny
    neigh = neighbor_cells(grid, counts.device)
    home = torch.cat([torch.arange(z0 * cells, (z0 + k) * cells,
                                   device=counts.device) for z0, k in runs])
    reach = {z % nz for z0, k in runs for z in range(z0 - 1, z0 + k + 1)}
    c = counts.long()
    pairs = int((c[home] * c[neigh[home]].sum(1)).sum())
    rows = int(c[home].sum())
    nbytes = len(reach) * cells * (cap * 4 * esize + 4)
    if not joined:
        rows += n - int(c.sum())
        nbytes += home.numel() * cap * 4
    nbytes += rows * nn * 4 * esize
    v = valid_per_row.double()
    return nbytes, 24 * pairs + float((v * v).sum()), pairs


def sharded_pair(state, mesh, make, nlist, steps=8):
    """A simulation on ``mesh`` and an unsharded one from ``state`` (NVT
    at kT 1.5), ``make()`` attached on ``nlist``; ``steps`` steps of each,
    the sharded one's state held by rows per shard at each step and after
    (:func:`row_gate`), the largest position difference by minimum image
    printed and gated at 1e-6 (the gathered lists are the unsharded ones
    bit for bit). Returns ``(sharded, unsharded)``."""
    sims = []
    for m in (mesh, None):
        sim = htt.Simulation(dt=0.005, seed=0, mesh=m,
                             device=None if m else "cuda",
                             integrator=htt.md.NVT(kT=1.5, tau=0.5))
        sim.set_state(state)
        htt.tfcompute(make()).attach(sim, r_cut=R_CUT, nlist=nlist)
        sims.append(sim)
    shd, ref = sims
    seen = watch_rows(shd)
    slab_run("36-37", shd.run, steps)
    del shd._packed_step
    row_gate(shd, f"{nlist!r} under the mesh", seen)
    del seen
    ref.run(steps)
    d = shd.state.positions - ref.state.positions
    L = torch.as_tensor(shd._lengths, dtype=d.dtype, device=d.device)
    dmax = float((d - torch.round(d / L) * L).abs().max())
    fmax = float((shd.state.forces - ref.state.forces).abs().max())
    print(f"  {steps} NVT steps against the unsharded engine: max position "
          f"difference {dmax:.3e}, forces {fmax:.3e} (limit 1e-6)")
    check(dmax <= 1e-6 and fmax <= 1e-6,
          f"{nlist!r}: the sharded trajectory left the unsharded one")
    return shd, ref


def same_rows(a, b):
    """Bit-equal lists on one device, NaN rows (rows a call leaves alone)
    equal too."""
    return bool(torch.equal(a.isnan(), b.isnan())) and \
        bool(torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0)))


def phase_sharded_packed(state, packed_sps):
    """Phase 36: phase 6's configuration (LJModel(64), 'auto' -> the cell
    list with K3) at 65,536 particles through Simulation(mesh=): K3's group
    mode, one launch a card a build (the binning card's group in place on
    the cell table, writing particle-order rows; any other card's on a
    joined buffer), each group launch and a group of one against its
    group plain version, a group of every shard and the gathered list
    bit-equal to the unsharded K3's, 8 steps against the unsharded engine,
    a timed run."""
    from hoomd_tf_tpu_torch.ops import cell_list as cl
    from hoomd_tf_tpu_torch.ops import cell_stencil as cst
    from hoomd_tf_tpu_torch.ops import nlist_cuda as nc
    from hoomd_tf_tpu_torch.ops.box import box_size
    k3 = nc.nlist_select
    NN = 64
    mesh, kind = shard_mesh()
    S = mesh.size
    print(f"  mesh: {kind}")
    devices = [mesh.devices[s] for s in range(S)]
    cards = len(set(str(d) for d in devices))
    # the sharded engine's 8 steps run first in sharded_pair, then the
    # unsharded engine's, which launch no group call
    k3.group_launches = 0
    shd, ref = sharded_pair(state, mesh, lambda: make_simmodel(NN), None)
    build = shd._packed_build()
    check(build.method == "pallas",
          f"'auto' under the mesh resolved to {build.method!r}, not K3")
    grid, cap = build.plan
    check(ref._packed_build().plan == build.plan, "the plans differ")
    launches = k3.group_launches
    check(launches == cards * 8,
          f"group launches {launches} != {cards} cards x 8 builds")
    shards = cst.z_slabs(grid[2], S)
    print(f"  plan grid {grid} cap {cap}; z-layers per shard "
          f"{[n for _, n in shards]} (nz s // S, no divisor); group "
          f"launches {launches} == {cards} card(s) x 8 builds")

    # one state: each card's group launch and shard 0 as a group of one
    # (in place and on its joined buffer) against their group plain
    # versions, a group of every shard against the unsharded K3
    st = shd.state
    lengths = box_size(st.box)
    host_L = tuple(float(v) for v in lengths.cpu())
    pos4 = st.positions4
    n = pos4.shape[0]
    slots4, counts, pid, ovf = cl.build_planes(pos4, grid, cap, lengths)
    check(not bool(ovf), "the state overflows its own plan")
    whole = k3(slots4, counts, pid, grid, cap, NN, R_CUT, host_L, n)
    every = cst.group_layers([sl for sl in shards])
    groups = build._groups(devices, pos4.device)
    args = (grid, cap, NN, R_CUT, host_L)
    err = 0.0

    def in_place(runs, fn):
        nan = torch.full((n, NN, 4), float("nan"), dtype=pos4.dtype,
                         device=pos4.device)
        return fn(slots4, counts, pid, *args, n, group=runs, out=nan)

    def joined(runs, dev, fn):
        buf = cst.joined_slab(slots4, grid, cap, runs, dev)
        cnt = cst.joined_slab(counts, grid, 1, runs, dev)
        return fn(buf, cnt, None, *args, None, group=runs)
    cases = [(f"card {dev}'s group, layers {list(runs)}" +
              (", joined" if jn else ", in place"), runs, dev, jn)
             for dev, runs, jn, *_ in groups]
    cases += [(f"shard 0 as a group of one, layers {shards[0]}, in place",
               (shards[0],), pos4.device, False),
              (f"shard 0 as a group of one, layers {shards[0]}, joined",
               (shards[0],), devices[0], True)]
    for name, runs, dev, jn in cases:
        if jn:
            got = joined(runs, dev, k3)
            want = joined(runs, dev, nc.nlist_select_reference)
            layer = grid[0] * grid[1] * cap
            p = torch.cat([pid[z0 * layer:(z0 + k) * layer]
                           for z0, k in runs])
            held = p >= 0
            torch.cuda.synchronize()
            g, w = got[held.to(got.device)], want[held.to(want.device)]
            same = bool(torch.equal(g, w)) and bool(torch.equal(
                g.to(whole.device), whole[p[held].long()]))
        else:
            g = in_place(runs, k3)
            w = in_place(runs, nc.nlist_select_reference)
            torch.cuda.synchronize()
            mine = ~g.isnan().all(2).all(1)
            same = same_rows(g, w) and bool(torch.equal(g[mine],
                                                        whole[mine]))
        e = float((g - w).nan_to_num(0.0).abs().max())
        err = max(err, e)
        print(f"  {name}: against its group plain version and the "
              f"unsharded K3, max_abs_err={e:.3e}, bit-equal {same}")
        check(same, f"{name}: K3's group mode disagrees with its plain "
              "version or with the unsharded K3")
    g = in_place(every, k3)
    torch.cuda.synchronize()
    check(bool(torch.equal(g, whole)),
          "K3's group of every shard differs from the unsharded K3")
    print(f"  a group of every shard (layers {list(every)}) in place: "
          f"bit-equal to the unsharded K3's [{n}, {NN}, 4] list")
    del g, whole

    t_sh = cuda_ms(lambda: build.sharded(pos4, lengths, devices))
    t_un = cuda_ms(lambda: build(pos4, lengths))
    nl_s, ovf_s = build.sharded(pos4, lengths, devices)
    nl_u, _ = build(pos4, lengths)
    torch.cuda.synchronize()
    check(not bool(ovf_s) and bool(torch.equal(nl_s, nl_u)),
          "the gathered list differs from the unsharded K3's")
    del nl_s, nl_u
    print(f"  gathered list [{N}, {NN}, 4] bit-equal to the unsharded K3's; "
          f"whole sharded build {t_sh:.4f} ms (binning, {cards} group "
          f"call(s)) against the unsharded build's {t_un:.4f} ms "
          f"({t_sh / t_un:.3f}x)")

    # the binning card's group call: its time, its plain version's, its
    # bound and torch.topk over its keys; shard 0 as a group of one
    runs = next(g[1] for g in groups if not g[2])
    out = torch.empty((n + 1, NN, 4), dtype=pos4.dtype, device=pos4.device)
    t_k = cuda_ms(lambda: k3(slots4, counts, pid, *args, n, group=runs,
                             out=out))
    t_p = cuda_ms(lambda: nc.nlist_select_reference(
        slots4, counts, pid, *args, n, group=runs, out=out), reps=5)
    t_one = cuda_ms(lambda: k3(slots4, counts, pid, *args, n,
                               group=(shards[0],), out=out))
    key = k3_keys(slots4, grid, cap, lengths, group=runs)
    layer = grid[0] * grid[1] * cap
    p = torch.cat([pid[z0 * layer:(z0 + k) * layer] for z0, k in runs])
    valid = (key != nc.FAR_KEY).sum(1)[p >= 0]
    t_lib = cuda_ms(lambda: torch.topk(key, NN, dim=1, largest=False,
                                       sorted=True), reps=5)
    nbytes, ops, pairs = k3_group_cost(counts, grid, cap, NN, n, runs,
                                       valid, slots4.element_size())
    del key, out
    b_ms, b_by = bound(nbytes, ops)
    print(f"  the binning card's group call ({len(runs)} run(s), "
          f"{sum(k for _, k in runs)} layers, {int((p >= 0).sum())} "
          f"queries): {t_k:.4f} ms; shard 0 as a group of one in place "
          f"{t_one:.4f} ms; group plain {t_p:.4f} ms; topk over its keys "
          f"{t_lib:.4f} ms; bound {b_ms:.4f} ms ({b_by}: "
          f"{nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} G operations over "
          f"{pairs} candidate pairs)")

    # shard 0 as a joined group of one on its joined buffer, the launch of
    # every card but the binning one on a host of several cards: its time
    # and its own bound
    one = (shards[0],)
    buf = cst.joined_slab(slots4, grid, cap, one, devices[0])
    cnt = cst.joined_slab(counts, grid, 1, one, devices[0])
    t_join = cuda_ms(lambda: k3(buf, cnt, None, *args, None, group=one))
    key = k3_keys(buf, grid, cap, lengths.to(buf.device), group=one,
                  joined=True)
    z0, k = shards[0]
    held = (pid[z0 * layer:(z0 + k) * layer] >= 0).to(key.device)
    valid = (key != nc.FAR_KEY).sum(1)[held]
    jbytes, jops, jpairs = k3_group_cost(counts, grid, cap, NN, n, one,
                                         valid, slots4.element_size(),
                                         joined=True)
    del key, buf, cnt
    jb_ms, jb_by = bound(jbytes, jops)
    print(f"  shard 0 as a joined group of one ({k} layers, "
          f"{int(held.sum())} queries, on {devices[0]}): {t_join:.4f} ms; "
          f"bound {jb_ms:.4f} ms ({jb_by}: {jbytes / 1e6:.2f} MB, "
          f"{jops / 1e9:.3f} G operations over {jpairs} candidate pairs)")

    # the timed run, host syncs forbidden
    del ref
    shd.check_syncs = True
    l0, a0, b0 = k3.group_launches, k3.launches, shd.nlist_builds
    steps = 200
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slab_run("36", shd.run, steps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    timed_l, timed_b = k3.group_launches - l0, shd.nlist_builds - b0
    check(timed_l == cards * timed_b == cards * steps,
          f"timed run: group launches {timed_l}, builds {timed_b}")
    check(k3.launches - a0 == timed_l,
          "the sharded run launched an unsharded K3")
    row_gate(shd, "phase 36's timed run")
    launches += timed_l
    th = healthy(shd, "sharded packed")
    sps = steps / dt
    print(f"  T={th['temperature']:.4f}; group launches of the runs "
          f"{launches} (timed run {timed_l} = {cards} x {timed_b} builds); "
          f"no host sync; steps/s {sps:.2f} against phase 6's "
          f"{packed_sps:.2f} ({sps / packed_sps:.3f}x), {kind}, on "
          f"{smi_line()} -- info, not a claim")
    return dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                library_ms=t_lib, max_abs_err=err, launches=launches,
                sharded_ms=t_sh, unsharded_ms=t_un, shard0_ms=t_one,
                shard0_joined_ms=t_join, shard0_joined_bound_ms=jb_ms)


def phase_sharded_direct(state):
    """Phase 37: phase 9's model (LJPotential(64) on 'direct') through
    Simulation(mesh=): each shard's particle rows' planes on its device,
    gathered bit-equal to the whole planes; 8 steps against the unsharded
    engine, a timed run."""
    from hoomd_tf_tpu_torch.ops.box import box_size
    mesh, kind = shard_mesh()
    S = mesh.size
    devices = [mesh.devices[s] for s in range(S)]
    shd, ref = sharded_pair(state, mesh, lambda: htt.LJPotential(64),
                            "direct")
    build = shd._packed_build()
    check(build.method == "direct", f"'direct' resolved to {build.method}")
    st = shd.state
    lengths = box_size(st.box)
    got, ovf = build.sharded(st.positions4, lengths, devices)
    want, _ = build(st.positions4, lengths)
    torch.cuda.synchronize()
    check(not bool(ovf) and all(bool(torch.equal(a, b))
                                for a, b in zip(got, want)),
          "the gathered planes differ from the whole planes")
    t_sh = cuda_ms(lambda: build.sharded(st.positions4, lengths, devices),
                   reps=5)
    t_un = cuda_ms(lambda: build(st.positions4, lengths), reps=5)
    grid, cap = build.plan
    print(f"  plan grid {grid} cap {cap}: planes [{N}, {27 * cap}] built "
          f"by {S} shards' particle rows, bit-equal to the whole planes; "
          f"the sharded build {t_sh:.4f} ms against {t_un:.4f} ms")
    del got, want, ref
    torch.cuda.empty_cache()
    shd.check_syncs = True
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slab_run("37", shd.run, 50)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    row_gate(shd, "phase 37's timed run")
    th = healthy(shd, "sharded direct")
    print(f"  T={th['temperature']:.4f}; no host sync; steps/s "
          f"{50 / dt:.2f} (timed run(50)), {kind}, on {smi_line()} -- "
          f"info, not a claim")


def phase_sharded_mapped(state):
    """Phase 38: phase 19's example 02 (the mapped LJ, 65,536 atoms +
    16,384 beads) through Simulation(mesh=) on 'cell' (the sort method
    per z-slab shard with the synthesized typed cut) and on 'cellwise'
    (the slot state resident per shard: the planes per shard, the model
    once on every row joined on the first card, the beads written per
    shard): one step equal to the unsharded engine's, then a short logged
    run under phase 19's gates; on 'cellwise' the state resident after
    each run, its kernels a step and the first card's peak memory."""
    mesh, kind = shard_mesh()
    base = htt.Simulation(dt=0.005, integrator=htt.md.NVT(kT=1.5, tau=0.5),
                          seed=19, device="cuda")
    base.set_state(dataclasses.replace(state))
    base.thermalize_velocities(1.5)
    start = base.state
    for nlist, steps in (("cell", 20), ("cellwise", 10)):
        t_p = time.perf_counter()
        sims = []
        for m in (mesh, None):
            sim = htt.Simulation(dt=0.005, seed=0, mesh=m,
                                 device=None if m else "cuda",
                                 integrator=htt.md.NVT(kT=1.5, tau=0.5))
            sim.set_state(start)
            tfc = htt.tfcompute(make_mapped_lj(64))
            mapping, op = com_mapping(N)
            tfc.enable_mapped_nlist(sim, mapping)
            tfc.attach(sim, r_cut=R_CUT, nlist=nlist)
            sims.append((sim, tfc))
        (shd, tfc), (ref, _) = sims
        if nlist == "cellwise":
            plan = shd._ensure_layout().plan
            ref._plan_from_current = lambda: plan
            check(plan.grid[2] % mesh.size == 0, f"plan {plan.grid}")
        else:
            check(shd._packed_build().method == "sort",
                  f"mapped 'cell' took {shd._packed_build().method!r}")
            seen = watch_rows(shd)
        slab_run("38", shd.run, 1)
        if nlist == "cell":
            del shd._packed_step
            row_gate(shd, "mapped 'cell' under the mesh", seen)
        ref.run(1)
        fmax = float((shd.state.forces - ref.state.forces).abs().max())
        print(f"  {nlist!r}: one step against the unsharded engine, max "
              f"force difference {fmax:.3e} (limit 1e-6), bit for bit "
              f"{bool(torch.equal(shd.state.forces, ref.state.forces))}")
        check(fmax <= 1e-6, f"mapped {nlist!r}: sharded != unsharded")
        if nlist == "cellwise":
            resident_shards(shd)
        del ref, sims
        torch.cuda.empty_cache()
        shd.check_syncs = True
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(0)
        t0 = time.perf_counter()
        slab_run("38", shd.run, steps, log_period=2)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(0) / 2 ** 30
        mapped_gates(shd, tfc, op, f"sharded {nlist!r}",
                     shd.log["temperature"])
        row_gate(shd, f"mapped {nlist!r}'s logged run")
        more = ""
        if nlist == "cellwise":
            resident_shards(shd)
            more = (f", {train_kernels(shd, 3, md=True)[0]:.1f} kernels a "
                    f"step (profiler, run(3)), the first card's peak "
                    f"memory {peak:.3f} GiB")
        print(f"  sharded {nlist!r}: steps/s {steps / dt:.2f} (run({steps}),"
              f" logged every 2nd step, host syncs forbidden){more}, "
              f"{kind}; phase part {time.perf_counter() - t_p:.1f} s -- "
              f"info, not a claim")
        del shd, tfc
        torch.cuda.empty_cache()


# ----------------------------------------------------------------------
# phase 39: typed proxy training, the Kob-Andersen binary mixture
# ----------------------------------------------------------------------
# Kob and Andersen, Phys. Rev. E 51, 4626 (1995): A-A, A-B, B-B
KA_EPS = [[1.0, 1.5], [1.5, 0.5]]
KA_SIG = [[1.0, 0.8], [0.8, 0.88]]


def mixture_types(n, seed=0):
    """A:B = 80:20 by a seeded permutation: type 1 on the last fifth."""
    import numpy as np
    perm = np.random.RandomState(seed).permutation(n)
    return (perm >= 0.8 * n).astype(np.int32)


def make_typed_nn(seed=0, dtype=None):
    """Phase 5's proxy NN made typed: the MLP (16 -> 1) on 1/r and the
    one-hot of the unordered type pair (ti + tj of two types),
    ``pair_energy(r2, ti, tj)``, K = 16, ``proxy_types=2``; random
    weights from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    dtype = dtype or torch.float32

    class TypedNNPair(htt.PairModel):
        def setup(self):
            self.dense1 = htt.Dense(16, generator=gen, dtype=dtype)
            self.last = htt.Dense(1, generator=gen, dtype=dtype)

        def pair_energy(self, r2, ti, tj):
            s = ti + tj
            x = torch.cat([torch.rsqrt(r2)[..., None]] +
                          [(s == k).to(r2.dtype)[..., None]
                           for k in range(3)], -1)
            return 2.0 * self.last(torch.tanh(self.dense1(x)))[..., 0]
    return TypedNNPair(64, output_forces=False, proxy_degree=K_PROXY,
                       proxy_types=2, dtype=dtype)


def ka_lj():
    return htt.md.LennardJones(epsilon=KA_EPS, sigma=KA_SIG, r_cut=R_CUT)


def phase_train_typed(train_sps):
    """Typed online training on the card: the 64k fluid of
    :func:`train_sim_attached` made an 80:20 Kob-Andersen mixture (its
    labels and driving forces the mixture's built-in LJ), the typed proxy
    NN (Adam 1e-2, phase 5's force loss), :func:`warm_train`, then the
    best of two timed run(200), all under check_syncs; K1's LJ form for
    the labels, its typed proxy form forward and the typed K2 at every
    train step."""
    import numpy as np
    from hoomd_tf_tpu_torch.ops import cellwise_cuda as cc
    from hoomd_tf_tpu_torch.ops import pair_train_cuda as pc
    k1, k2 = cc.half_stencil_pair_forces, pc.proxy_bwd_moments
    sim, model = train_sim_attached(make_typed_nn(), types=mixture_types(N),
                                    lj=ka_lj())
    # the equilibrated mixture phase 40 trains from
    start = sim.state
    tfc = sim.tfc
    sim.check_syncs = True
    k1.launches = k1.proxy_launches = k2.launches = 0
    evals0, steps0 = sim.force_evals, sim.train_steps
    warm_train(sim)
    hist = tfc.loss_history
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.run(200)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    evals = sim.force_evals - evals0
    steps = sim.train_steps - steps0
    loss0 = float(np.mean(hist[:50]))
    loss1 = float(np.mean(hist[-50:]))
    th = sim.thermo()
    curve = [round(float(np.mean(hist[a:a + 100])), 4)
             for a in range(0, len(hist), 100)]
    print(f"  loss curve (means of 100 steps): {curve}")
    check(len(hist) == 1000 <= steps,
          f"{len(hist)} losses of committed steps, {steps} steps attempted")
    check(bool(np.isfinite(hist).all()), "non-finite training loss")
    check(bool(torch.isfinite(sim.state.positions).all()),
          "non-finite positions")
    check(bool(torch.isfinite(sim.state.forces).all()), "non-finite forces")
    check(1.1 < th["temperature"] < 1.9, f"unhealthy mixture after: {th}")
    check(k2.launches == steps, f"K2 launches {k2.launches} != train "
          f"steps {steps}")
    check(k1.proxy_launches == steps, f"K1 proxy launches "
          f"{k1.proxy_launches} != train steps {steps}")
    check(k1.launches == evals, f"K1 launches {k1.launches} != built-in "
          f"+ model-forward evaluations {evals}")
    check(loss1 < 0.3 * loss0, f"loss did not fall: {loss0} -> {loss1}")
    plan = sim._layout.plan
    sps = 200 / min(times)
    n_b = int((sim.state.types == 1).sum())
    print(f"  plan grid {plan.grid} cap {plan.capacity}; {N - n_b} A, {n_b} "
          f"B; T={th['temperature']:.4f}")
    print(f"  train steps: 1000 committed, {steps} attempted; launches: K2 "
          f"{k2.launches} == K1 proxy {k1.proxy_launches} == train steps; "
          f"K1 {k1.launches} == evaluations {evals}; no host sync")
    print(f"  loss (50-step windows) {loss0:.4f} -> {loss1:.4f} (ratio "
          f"{loss1 / loss0:.4f}, limit 0.3)")
    print(f"  typed train steps/s {sps:.2f} (best of 2 timed run(200), "
          f"rounds {[round(t, 3) for t in times]} s) against phase 5's "
          f"untyped {train_sps:.2f} ({sps / train_sps:.3f}x) on "
          f"{smi_line()} -- info, not a claim")
    launches = dict(lj=k1.launches - k1.proxy_launches,
                    proxy=k1.proxy_launches, k2=k2.launches, sps=sps,
                    start=start, hist=list(hist))
    return sim, model, launches


def phase_sharded_train_typed(start, hist39, sps39):
    """Phase 40: phase 39's typed proxy training (the 64k 80:20
    Kob-Andersen mixture, the typed proxy NN from its seed, Adam 1e-2,
    phase 5's force loss) from phase 39's equilibrated mixture through
    ShardedSimulation on the slot state resident per z-slab shard: the
    labels (K1's typed LJ form), K1's typed proxy form and the typed K2 in
    one group launch a card on the shards' own buffers. The first train
    step against the unsharded engine's, then 200 train steps and a profiled
    run(10) with host syncs forbidden, beside phase 39's first steps from the same state
    and weights (its plan differs: the mesh plans with its divisor).
    Returns the runs' launches."""
    import numpy as np
    from hoomd_tf_tpu_torch.ops import pair_train_cuda as pc
    from hoomd_tf_tpu_torch.parallel import ShardedSimulation
    k2 = pc.proxy_bwd_moments
    mesh, kind = shard_mesh()
    D = mesh_devices(mesh)
    print(f"  mesh: {kind}")
    sims = []
    for m in (mesh, None):
        if m is None:
            sim = htt.Simulation(dt=0.005, seed=0, device="cuda",
                                 integrator=htt.md.NVT(kT=1.5, tau=0.5))
        else:
            sim = ShardedSimulation(dt=0.005, kT=1.5, tau=0.5, mesh=m,
                                    seed=0)
        sim.set_state(start)
        sim.add_force(ka_lj())
        model = make_typed_nn()
        model.compile(optimizer="adam", loss=force_loss, learning_rate=1e-2)
        htt.tfcompute(model).attach(sim, r_cut=R_CUT, nlist="cellwise",
                                    train=True)
        sims.append(sim)
    shd, ref = sims
    plan = shd._ensure_layout().plan
    ref._plan_from_current = lambda: plan
    first_step_gate("typed proxy", shd, ref, D == 1)
    del ref, sims
    shd.check_syncs = True
    k2.launches = k2.group_launches = 0
    steps0 = shd.train_steps
    sps, peak, rise = timed_train("40", shd, 200)
    per, ran, _ = slab_run("40", train_kernels, shd)
    steps = shd.train_steps - steps0
    hist = np.asarray(shd.tfc.loss_history)
    check(len(hist) == 200 + ran <= steps,
          f"{len(hist)} losses of committed steps, {steps} attempted")
    check(bool(np.isfinite(hist).all()), "non-finite training loss")
    first, last = float(hist[:20].mean()), float(hist[-20:].mean())
    check(last < first, f"the loss did not fall: {first} -> {last}")
    check(k2.group_launches == k2.launches == D * steps,
          f"K2 launches {k2.launches} (group {k2.group_launches}) != {D} x "
          f"{steps} train steps")
    k1_gate("40", D, steps)
    resident_shards(shd)
    th = healthy(shd, "sharded train-typed")
    n_b = int((shd.state.types == 1).sum())
    curve = [round(float(hist[a:a + 50].mean()), 4) for a in range(0, 200,
                                                                   50)]
    curve39 = [round(float(np.mean(hist39[a:a + 50])), 4)
               for a in range(0, 200, 50)]
    print(f"  plan grid {plan.grid} cap {plan.capacity}; {N - n_b} A, {n_b} "
          f"B; loss (means of 50 steps) {curve}, phase 39's first 200 "
          f"{curve39} (its plan grid differs); 20-step windows {first:.4f} "
          f"-> {last:.4f}; K2 group launches {k2.group_launches} == {D} x "
          f"{steps} == all K2 launches; K1 launches of the runs (group, "
          f"all, proxy form) {SLAB_RUNS['40'][:3]}; the state resident per "
          f"shard; no host sync; T={th['temperature']:.4f}")
    print(f"  typed train steps/s {sps:.2f} (run(200)) against phase 39's "
          f"{sps39:.2f} ({sps / sps39:.3f}x); {per:.1f} kernels a train "
          f"step; the first card's peak memory {peak:.3f} GB ({rise:.3f} GB "
          f"above what stood before the run); {kind}, on {smi_line()} -- "
          f"info, not a claim")
    n = SLAB_RUNS["40"]
    return dict(lj=n[0] - n[2], proxy=n[2], k2=k2.group_launches)


def timed_call(label, fn, plain, cost, peak=PEAK_F32_PER_S, plain_reps=5):
    """The whole call by CUDA events, the kernels alone by the profiler,
    the plain version's time and the bound: a kernels-line record."""
    t_k = cuda_ms(fn)
    names, dev_ms, _, _ = profiled_calls(fn)
    t_p = cuda_ms(plain, reps=plain_reps)
    nbytes, ops = cost
    b_ms, b_by = bound(nbytes, ops, peak)
    print(f"  {label}: whole call {t_k:.4f} ms, kernels alone "
          f"{dev_ms / PROFILED_CALLS:.4f} ms ({len(names) // PROFILED_CALLS} "
          f"a call), plain {t_p:.4f} ms, bound {b_ms:.4f} ms ({b_by}: "
          f"{nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} G operations)")
    return dict(ms=t_k, kernel_ms=dev_ms / PROFILED_CALLS, plain_ms=t_p,
                bound_ms=b_ms, bound_by=b_by)


def phase_train_typed_kernels(sim, model):
    """At phase 39's trained state and plan: K1's typed proxy form (the
    train forward, forces only) and the typed K2 against their plain
    versions (rtol = atol = 1e-4; the JAX bar), the path's K2 call
    (forces-only cotangent) and with energy beside the untyped call with
    energy at the same plan, and eight types (slot % 8); each timed."""
    import numpy as np
    from hoomd_tf_tpu_torch.ops import cellwise_cuda as cc
    from hoomd_tf_tpu_torch.ops import pair_train_cuda as pc
    from hoomd_tf_tpu_torch.ops.chebyshev import (make_pair_proxy,
                                                  make_typed_pair_proxy)
    layout = sim._layout
    p = layout.plan
    dev = sim.device
    slot, aux = slot_state(layout, sim.state)
    common = (slot.positions, slot.types, aux["valid"], p, layout.lo)
    with torch.no_grad():
        form = model.pair_kernel_form(R_CUT, dev)
    kw = dict(min_r2=model.min_r2, geometry=layout.geometry)
    f_k, _ = cc.half_stencil_pair_forces(*common, form, needs_energy=False,
                                         **kw)
    f_p, _ = cc.half_stencil_plain(*common, form, needs_energy=False, **kw)
    torch.cuda.synchronize()
    k1 = timed_call(
        "K1 typed proxy form (two types), the train forward",
        lambda: cc.half_stencil_pair_forces(*common, form,
                                            needs_energy=False, **kw),
        lambda: cc.half_stencil_plain(*common, form, needs_energy=False,
                                      **kw),
        k1_cost(slot.positions, aux["valid"], p, 3, form))
    k1["max_abs_err"] = compare("K1 typed proxy form, forces (kernel vs "
                                "plain)", f_k[:, :3], f_p[:, :3])
    basis = model.proxy_parts(R_CUT, dev)[1].basis
    ct = torch.as_tensor(np.random.RandomState(0).randn(p.n_slots, 4)
                         .astype(np.float32), device=dev)
    r2_lo = (0.25 * R_CUT) ** 2
    types8 = (torch.arange(p.n_slots, device=dev) % 8).to(torch.int32)
    cases = (
        ("two types, forces-only cotangent (the path)", slot.types, basis,
         False),
        ("two types, with energy", slot.types, basis, True),
        ("untyped, with energy", slot.types,
         make_pair_proxy(K_PROXY, r2_lo, R_CUT ** 2, device=dev)[1].basis,
         True),
        ("eight types (slot % 8), with energy", types8,
         make_typed_pair_proxy(K_PROXY, r2_lo, R_CUT ** 2, 8,
                               device=dev)[1].basis, True))
    rec, err = {}, 0.0
    for label, types, bas, energy in cases:
        args = (slot.positions, types, aux["valid"], ct, p, layout.lo, bas)
        kw2 = dict(min_r2=model.min_r2, needs_energy=energy,
                   geometry=layout.geometry)
        T = 1 if bas["pairs"] is None else 8 if types is types8 else 2
        split = pc.proxy_bwd_moments.type_group_launches
        got = torch.cat([g.reshape(-1) for g in pc.proxy_bwd_moments(
            *args, **kw2)])
        check(pc.proxy_bwd_moments.type_group_launches == split,
              f"K2 {label}: its type pairs took more than one pass")
        want = torch.cat([g.reshape(-1) for g in pc.proxy_bwd_plain(
            *args, **kw2)])
        torch.cuda.synchronize()
        err = max(err, compare(f"K2 {label}, {got.numel()} moments (kernel "
                               "vs plain)", got, want, rtol=K2_RTOL,
                               atol=K2_ATOL_REL * float(want.abs().max())))
        nbytes, ops = k2_cost(slot.positions, aux["valid"], p, K_PROXY,
                              energy, got.numel())
        if T > 1:
            nbytes += 4 * p.n_slots  # the types
        rec[label] = timed_call(
            f"K2 {label}", lambda: pc.proxy_bwd_moments(*args, **kw2),
            lambda: pc.proxy_bwd_plain(*args, **kw2), (nbytes, ops),
            plain_reps=1 if T == 8 else 3)
    k2 = dict(rec["two types, forces-only cotangent (the path)"],
              max_abs_err=err)
    k2["two_types_energy_ms"] = rec["two types, with energy"]["ms"]
    k2["untyped_energy_ms"] = rec["untyped, with energy"]["ms"]
    eight = rec["eight types (slot % 8), with energy"]
    for key in ("ms", "plain_ms", "bound_ms"):
        k2["eight_types_" + key] = eight[key]
    print(f"  K2 two types with energy / untyped with energy at this plan: "
          f"{k2['two_types_energy_ms'] / k2['untyped_energy_ms']:.3f}x")
    return k1, k2


def phase_train_typed_f64(sim32):
    """Phase 39's mixture in float64: its state made double, the typed
    proxy NN in double (Adam 1e-2), run(100) under check_syncs, every K1
    and K2 launch double, K2 = K1 proxy = train steps; then the typed K2
    double (forces-only cotangent, the path) against its plain version
    (rtol 1e-10), timed."""
    import numpy as np
    from hoomd_tf_tpu_torch.ops import cellwise_cuda as cc
    from hoomd_tf_tpu_torch.ops import pair_train_cuda as pc
    k1, k2 = cc.half_stencil_pair_forces, pc.proxy_bwd_moments
    st = sim32.state
    fields = {f.name: getattr(st, f.name).double()
              for f in dataclasses.fields(st)
              if torch.is_tensor(getattr(st, f.name)) and
              getattr(st, f.name).is_floating_point()}
    sim = htt.Simulation(dt=0.005, integrator=htt.md.NVT(kT=1.5, tau=0.5),
                         seed=0, device="cuda")
    sim.set_state(dataclasses.replace(st, thermostat={}, **fields))
    sim.add_force(ka_lj())
    model = make_typed_nn(dtype=F64)
    model.compile(optimizer="adam", loss=force_loss, learning_rate=1e-2)
    tfc = htt.tfcompute(model)
    tfc.attach(sim, r_cut=R_CUT, nlist="cellwise", train=True)
    sim.check_syncs = True
    for f in (k1, k2):
        f.launches = f.f64_launches = 0
    k1.proxy_launches = 0
    steps0 = sim.train_steps
    sim.run(100)
    steps = sim.train_steps - steps0
    hist = tfc.loss_history
    check_f64_state(sim, "float64 typed training")
    check(len(hist) == 100 <= steps and bool(np.isfinite(hist).all()),
          f"{len(hist)} finite losses of {steps} train steps")
    check(bool(torch.isfinite(sim.state.positions).all()),
          "non-finite positions")
    check(k2.launches == k2.f64_launches == steps == k1.proxy_launches,
          f"K2 {k2.launches} ({k2.f64_launches} double), K1 proxy "
          f"{k1.proxy_launches} launches for {steps} train steps")
    check(k1.f64_launches == k1.launches, "a K1 launch was not double")
    print(f"  float64: {steps} train steps, K2 {k2.launches} and K1 proxy "
          f"{k1.proxy_launches} launches, all double; loss {hist[0]:.6f} "
          f"-> {hist[-1]:.6f}; no host sync")
    launches = k2.launches
    layout = sim._layout
    p = layout.plan
    slot, aux = slot_state(layout, sim.state)
    basis = model.proxy_parts(R_CUT, "cuda")[1].basis
    ct = torch.as_tensor(np.random.RandomState(0).randn(p.n_slots, 4),
                         device="cuda")
    args = (slot.positions, slot.types, aux["valid"], ct, p, layout.lo,
            basis)
    kw = dict(min_r2=model.min_r2, needs_energy=False,
              geometry=layout.geometry)
    got = torch.cat([g.reshape(-1) for g in pc.proxy_bwd_moments(*args,
                                                                 **kw)])
    want = torch.cat([g.reshape(-1) for g in pc.proxy_bwd_plain(*args,
                                                                **kw)])
    torch.cuda.synchronize()
    err = compare("K2 double, two types, forces-only cotangent (kernel vs "
                  "plain)", got, want, rtol=F64_K2_RTOL,
                  atol=F64_K2_RTOL * float(want.abs().max()))
    nbytes, ops = k2_cost(slot.positions, aux["valid"], p, K_PROXY, False,
                          got.numel())
    rec = timed_call("K2 double, two types, forces-only cotangent (the "
                     "path)", lambda: pc.proxy_bwd_moments(*args, **kw),
                     lambda: pc.proxy_bwd_plain(*args, **kw),
                     (nbytes + 4 * p.n_slots, ops), PEAK_F64_PER_S)
    rec.update(max_abs_err=err, launches=launches)
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
    # phase 5's NVT state, for phases 32 and 33
    train_state = sim.state
    del sim, model

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
    k1_px64, k2_64, k2_typed23 = fp64_proxy_kernels(sim64, model64)
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
    print("[25 trajectory] phase 4's 64k fluid, 1000 NVT steps on "
          "'cellwise' written to GSD and read back")
    launches, traj_sim = phase_trajectory(main_state)
    k1_lj["launches"] += launches
    # phase 4's NVT state, for phases 29 and 30
    shard_state = main_state
    del main_state
    torch.cuda.empty_cache()
    print("[26 offline] reference examples 05 and 06 at 16k particles "
          "from the card's own GSD trajectory")
    k1_lj["launches"] += phase_offline()
    torch.cuda.empty_cache()
    print("[27 profiling] time_steps, benchmark_simulation and trace on "
          "phase 25's 64k simulation")
    k1_lj["launches"] += phase_profiling(traj_sim, main_sps)
    del traj_sim
    torch.cuda.empty_cache()
    print("[28 examples] the eleven port example scripts on the card, and "
          "PDBUniverse(traj=)")
    nc.nlist_select.launches = cc.half_stencil_pair_forces.launches = 0
    phase_examples()
    k3["launches"] += nc.nlist_select.launches
    k1_lj["launches"] += cc.half_stencil_pair_forces.launches
    print(f"  examples: K3 launches {nc.nlist_select.launches}, K1 "
          f"launches {cc.half_stencil_pair_forces.launches}")
    torch.cuda.empty_cache()
    print("[29 sharded eval] phase 4's fluid and LJ PairModel through "
          "ShardedSimulation on 'cellwise': K1's group launch")
    k1_group = phase_sharded(shard_state, main_sps)
    torch.cuda.empty_cache()
    print("[30 sharded generic and 'n2'] LJPotential in K1's generic form "
          "over the group, Langevin, run(200, log_period=10); the "
          "small-box 'n2' fallback")
    gen_group = phase_sharded_generic(shard_state)
    torch.cuda.empty_cache()
    print("[31 parallel helpers] halo_force_fn at 16,384 particles and "
          "sharded_train_step over 8 frames of 4,096")
    phase_parallel_helpers()
    torch.cuda.empty_cache()
    print("[32 sharded train] phase 5's proxy row through ShardedSimulation"
          ": K1's proxy form and K2 in one group launch a card")
    k2_slab, k1_px_group = phase_sharded_train(train_state, train_sps)
    torch.cuda.empty_cache()
    print("[33 sharded train-pair and train-lane] phases 10-11's rows "
          "through ShardedSimulation: one list, one pair-function call and "
          "generic_reduce_bwd over the group a card")
    bwd_slab = phase_sharded_train_generic(train_state,
                                           (pl["sps"], gl_["sps"]))
    del train_state
    torch.cuda.empty_cache()
    print("[34 sharded npt] phase 14's barostat through ShardedSimulation")
    launches, _ = phase_sharded_npt(shard_state)
    k1_group["launches"] += launches
    torch.cuda.empty_cache()
    print("[35 sharded planes] a SimModel the probe rejects through "
          "ShardedSimulation: the planes built per shard, run and train")
    phase_sharded_planes(shard_state)
    torch.cuda.empty_cache()
    t36 = time.perf_counter()
    print("[36 sharded packed] phase 6's configuration through "
          "Simulation(mesh=): K3's group mode, one launch a card")
    k3_group = phase_sharded_packed(shard_state, k3["sps"])
    torch.cuda.empty_cache()
    print("[37 sharded direct] phase 9's model on 'direct': the planes by "
          "particle rows per shard")
    phase_sharded_direct(shard_state)
    torch.cuda.empty_cache()
    print("[38 sharded mapped] phase 19's example 02 through "
          "Simulation(mesh=) on 'cell' and 'cellwise'")
    phase_sharded_mapped(shard_state)
    print(f"  phases 36-38: {time.perf_counter() - t36:.1f} s")
    print(f"  launches of the mesh routes' own runs in phases 32-38 (K1 "
          f"group, K1 all, K1 proxy form, generic group, generic all): "
          f"{SLAB_RUNS}")
    # phase 32's K1 launches are all group launches, so its proxy-form
    # count is that of the proxy form's group launches
    check(SLAB_RUNS["32"][0] == SLAB_RUNS["32"][1],
          "phase 32's training launched K1 outside a group launch")
    k1_px_group["launches"] = SLAB_RUNS["32"][2]
    lj_runs = sum(n[0] for n in SLAB_RUNS.values()) - SLAB_RUNS["32"][2]
    gen_runs = sum(n[3] for n in SLAB_RUNS.values())
    check(k1_px_group["launches"] > 0 and lj_runs > 0 and gen_runs > 0,
          "a K1 group launch (proxy form, LJ form or generic form) was "
          "made no time in the runs of phases 32-38")
    k1_group["launches"] += lj_runs
    gen_group["launches"] += gen_runs
    del shard_state
    torch.cuda.empty_cache()
    print("[39 train-typed] 64k online training of a typed proxy NN on the "
          "80:20 Kob-Andersen mixture: K2's typed path")
    t39 = time.perf_counter()
    tsim, tmodel, tl = phase_train_typed(train_sps)
    k1_lj["launches"] += tl["lj"]
    print(f"  phase 39: {train_kernels(tsim)[0]:.1f} kernels a train step "
          f"(profiler, run(10)) -- info")
    k1_typed, k2_typed = phase_train_typed_kernels(tsim, tmodel)
    k1_typed["launches"], k2_typed["launches"] = tl["proxy"], tl["k2"]
    k2_typed64 = phase_train_typed_f64(tsim)
    # three and five types: phase 23's calls (slot % T, with energy)
    for T, name in ((3, "three"), (5, "five")):
        for key in ("ms", "plain_ms", "bound_ms"):
            k2_typed64[f"{name}_types_{key}"] = k2_typed23[T][key]
    del tsim, tmodel
    torch.cuda.empty_cache()
    print(f"  phase 39: {time.perf_counter() - t39:.1f} s")
    print("[40 sharded train-typed] phase 39's typed proxy training through "
          "ShardedSimulation on the resident shards: the typed K1 and K2 "
          "in one group launch a card")
    t40 = time.perf_counter()
    l40 = phase_sharded_train_typed(tl["start"], tl["hist"], tl["sps"])
    k1_group["launches"] += l40["lj"]
    k1_px_group["launches"] += l40["proxy"]
    k2_slab["launches"] += l40["k2"]
    del tl
    torch.cuda.empty_cache()
    print(f"  phase 40: {time.perf_counter() - t40:.1f} s")
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
        dict(name="K1 LJ form, group launch over the shards of one card "
                  "(half_stencil_group_forces; ms, plain_ms, bound_ms: "
                  "phase 29's group launch alone, its plain version and "
                  "its bound; sharded_ms: the whole resident evaluation; "
                  "shard0_ms: shard 0 alone as a group of one; launches: "
                  "group launches of phases 29 and 34 and the LJ form's "
                  "group launches in the mesh routes' runs of phases "
                  "32-38 and 40)",
             source="hoomd_tf_tpu_torch/csrc/cellwise_half.cu",
             replaces="hoomd_tf_tpu/ops/cellwise_pallas.py:640 (the mesh "
                      "wrapper of the pallas_call at :629)", **k1_group),
        dict(name="K1 Chebyshev-proxy form, group launch over the shards "
                  "of one card (half_stencil_group_forces; ms, plain_ms, "
                  "bound_ms: phase 32's training forward on the shards' "
                  "resident buffers, its plain version and its bound; "
                  "launches: the proxy form's group launches in the "
                  "training runs of phases 32 and 40, typed in 40)",
             source="hoomd_tf_tpu_torch/csrc/cellwise_half.cu",
             replaces="hoomd_tf_tpu/ops/cellwise_pallas.py:640 (the mesh "
                      "wrapper of the pallas_call at :629)", **k1_px_group),
        dict(name="K1 generic form, group launch over the shards of one "
                  "card (generic_group_pair_forces: one list launch, the "
                  "pair function once on the joined list, one reduction; "
                  "ms, plain_ms, bound_ms: phase 30's group call alone with "
                  "the pair function, its plain version and its bound; "
                  "sharded_ms: the whole resident evaluation; shard0_ms: "
                  "shard 0 alone as a group of one; launches: group "
                  "launches of phase 30's run and of the mesh routes' runs "
                  "in phases 32-38, training's forward included)",
             source="hoomd_tf_tpu_torch/csrc/cellwise_generic.cu",
             replaces="hoomd_tf_tpu/ops/cellwise_pallas.py:640 (the mesh "
                      "wrapper of the pallas_call at :629)", **gen_group),
        dict(name="K2 Chebyshev-proxy backward moments, group launch over "
                  "the shards of one card (proxy_bwd_moments(group=); ms, "
                  "plain_ms, bound_ms: phase 32's group call with the "
                  "forces-only cotangent on the shards' resident buffers, "
                  "its plain version and its bound; shard0_ms: shard 0 "
                  "alone as a group of one; sharded_ms: phase 32's whole "
                  "resident backward, the group calls and the sum; "
                  "launches: group launches of the training of phases 32 "
                  "and 40, typed in 40)",
             source="hoomd_tf_tpu_torch/csrc/proxy_bwd.cu",
             replaces="hoomd_tf_tpu/ops/pair_train.py:161 (the XLA lane "
                      "contraction the JAX package takes for a proxy under "
                      "a mesh, pair_train_pallas.py:68-72; K2's Pallas "
                      "kernel, pair_train_pallas.py:80, without one)",
             **k2_slab),
        dict(name="generic_reduce_bwd, group launch over the shards of one "
                  "card (generic_reduce_bwd on a group's joined list; ms, "
                  "plain_ms, bound_ms: phase 33's pair row's group call, "
                  "its plain version and its bound; shard0_ms: shard 0's "
                  "list as a group of one; sharded_ms: the pair row's "
                  "whole resident backward with the pair function's; "
                  "launches: group launches of phase 33's training, both "
                  "rows)",
             source="hoomd_tf_tpu_torch/csrc/cellwise_generic.cu",
             replaces="hoomd_tf_tpu/ops/pair_train.py:161 (the XLA lane "
                      "contraction; no Pallas kernel)", **bwd_slab),
        dict(name="K1 half-stencil pair forces, Chebyshev-proxy form with "
                  "a typed table (two types), phase 39's training forward "
                  "(forces only; kernel_ms: its kernels alone by the "
                  "profiler; launches: phase 39's train steps)",
             source="hoomd_tf_tpu_torch/csrc/cellwise_half.cu", **k1_typed),
        dict(name="K2 Chebyshev-proxy backward moments, typed path (the "
                  "tile path), float32: phase 39's two types 80:20 with "
                  "the forces-only cotangent (kernel_ms: its kernels alone "
                  "by the profiler; two_types_energy_ms, "
                  "untyped_energy_ms: with energy, typed and untyped, at "
                  "the same plan; eight_types_*: eight types, slot % 8, "
                  "with energy; launches: phase 39's train steps)",
             source="hoomd_tf_tpu_torch/csrc/proxy_bwd.cu",
             replaces="hoomd_tf_tpu/ops/pair_train_pallas.py:80",
             **k2_typed),
        dict(name="K2 Chebyshev-proxy backward moments, typed path, "
                  "float64: phase 39's float64 segment, two types 80:20, "
                  "forces-only cotangent (three_types_*, five_types_*: "
                  "phase 23's state, slot % T, with energy; launches: the "
                  "segment's train steps)",
             source="hoomd_tf_tpu_torch/csrc/proxy_bwd.cu",
             replaces="hoomd_tf_tpu/ops/pair_train_pallas.py:80",
             **k2_typed64),
        dict(name="K3 cell-list neighbor selection, group mode, one "
                  "launch a card over its z-slab shards (nlist_select("
                  "group=); ms, plain_ms, bound_ms: the binning card's "
                  "group call in place, its group plain version and its "
                  "own bound; shard0_ms: shard 0 alone as a group of one "
                  "in place; shard0_joined_ms, shard0_joined_bound_ms: "
                  "shard 0 as a group of one on its joined buffer (the "
                  "launch of a card that does not bin) and its own bound; "
                  "sharded_ms, unsharded_ms: phase 36's whole sharded "
                  "build and the unsharded build; library_ms: torch.topk "
                  "over the group's keys, selection only; launches: group "
                  "launches of phase 36's runs)",
             source="hoomd_tf_tpu_torch/csrc/nlist_select.cu",
             replaces="hoomd_tf_tpu/ops/nlist_pallas.py:163 (the "
                      "pallas_call of _kernel at :43, on the rows GSPMD "
                      "gives each device under the JAX package's mesh)",
             **k3_group),
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
        kernels.append({k: r[k] for k in keys + (
            "sharded_ms", "unsharded_ms", "shard0_ms", "shard0_joined_ms",
            "shard0_joined_bound_ms", "kernel_ms",
            "two_types_energy_ms",
            "untyped_energy_ms") + tuple(
                f"{n}_types_{m}" for n in ("eight", "three", "five")
                for m in ("ms", "plain_ms", "bound_ms")) if k in r})
    print(smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
