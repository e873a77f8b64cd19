"""Simulation: the MD engine (PyTorch port of the main-path subset of
``hoomd_tf_tpu/md/simulation.py``).

Two routes are ported. The particle-order route (the JAX package's
``layout is None`` branches) runs any :class:`..models.simmodel.
SimModel` on a packed ``[N, NN, 4]`` neighbor list rebuilt every step:
the cell list (kernel K3 on a CUDA device when ``nlist`` is ``None`` /
``'auto'`` or ``'pallas'``, the sort method otherwise) or the dense
O(N^2) build (``'n2'``, and ``'auto'`` below 512 particles or 3 cells
per axis); the model's forces come from autodiff
(:func:`..ops.forces.compute_nlist_forces`), the built-in forces from
their ``__call__`` on the same list. A cell capacity overflow rolls the
run back and re-plans with a larger capacity floor; a model's
``check_nlist`` flag is read in the run's one readback.

The particle-order route also takes ``nlist='direct'``: the model gets
the masked 27-cell candidate planes (:mod:`..ops.direct`), no selection.

The other route is the cellwise mode. Pair forces come from
:func:`..ops.cellwise.analytic_pair_forces` -- kernel K1 on a CUDA device
(a pair form, or the generic form for any other pair function), the
full-stencil tensor form on the CPU (as the JAX package runs the XLA form
off the TPU) -- for the built-in forces (``add_force``:
``md.LennardJones``, ``md.WCA``), for an attached
:class:`..models.pair.PairModel`, and for a generic SimModel that the
lane-separability probe (:mod:`..ops.lane_fast`) validated, through its
synthesized pair function; a generic SimModel the probe rejects runs on
the masked planes (``SlotLayout.planes``), forces by autograd. The state lives in cell-slot order
during ``run()``; the slot assignment is rebuilt unconditionally every K
steps (the static repack schedule), and the Verlet criterion still runs
every step as a staleness bit.

Online training (``tfcompute.attach(train=True)``): one built-in
evaluation per training step serves as both the labels and the driving
forces (the trained model does not drive the dynamics), and the optimizer
steps in place every ``period`` steps, then the weights' constraints. On
the cellwise mode the model's forces come from one of the JAX package's
three analytic branches (``train_fast_update``) or its autodiff one
(``train_update``), picked by :class:`_Trainer`: a Chebyshev-proxy
PairModel fitted at its nodes (K1's proxy form forward, kernel K2
backward on CUDA); a PairModel without a proxy, or a generic SimModel
the lane-separability probe validated, through
:func:`..ops.pair_train.pair_train_forces` (on CUDA K1's generic form
forward and the kernel ``generic_reduce_bwd`` backward, the pair function
evaluated once on the list with grad; on the CPU the lane contraction);
any other SimModel by autograd through the model on the masked planes.
On the particle-order route the model trains by autograd on the packed
list, in ``batch_size`` particle chunks with one optimizer step each
when asked. A run that is rolled back (capacity overflow, staleness, a
too-short generic-form list) rolls the model's weights and the
optimizer's state back with it.

Host syncs: ``run()`` reads the device back exactly once, after the
step loop, in one packed copy (:meth:`Simulation._fetch_run_scalars`):
the overflow and staleness bits, the running max cell occupancy, the
running max speed, the most lanes K1's generic-form list needed (which
sizes the next run's list) and the per-step training losses stay device
tensors until then. With ``check_syncs = True`` the step loop runs under
``torch.cuda.set_sync_debug_mode("error")``, so any hidden sync raises.

Mapped coarse-grained lists (``tfcompute.enable_mapped_nlist``): the CG
beads are rows past the atoms. Each step the mapping writes their
positions from the atoms' before the neighbor build (on ``'cellwise'``
in particle order, scattered into the beads' slot rows), their rows get
no net force, and the model sees particle-order rows; a mapped model
never takes K1's fast routes or the probe (the JAX package's rule).

PyTorch runs eagerly, so the JAX package's scan machinery (the carry
wire, ``scan_block``, compile-cache keys, the readback caches for a
remote TPU) has no counterpart here.
"""

import contextlib
import copy
import dataclasses
import warnings

import numpy as np
import torch

from . import integrators as _integrators
from . import thermo as _thermo
from .slots import SlotLayout
from .state import init_state, lattice_positions
from .._device import resolve_device
from ..ops import cell_list as _cl
from ..ops import cellwise as _cw
from ..ops.box import box_size
from ..ops.cellwise_cuda import LaneBudget, lane_budget
from ..ops.direct import DirectPlanes
from ..ops.nlist import DenseNlist
from ..models.module import StateSnapshot
from ..models.pair import PairModel

__all__ = ["Simulation"]

# the neighbor build is not made yet (``None`` is a made "no build")
_UNBUILT = object()

# planes lanes per model call of the probe's validation on the card: the
# whole 27-block planes of the 64k fluid are 2.4e8 lanes, ~1 GB per
# float32 plane, and an NN potential holds hundreds of floats per lane
_PROBE_LANES = 1 << 22


@contextlib.contextmanager
def _sync_guard(on):
    """Raise on any host sync in the block (CUDA only)."""
    if not (on and torch.cuda.is_available()):
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


class Simulation:
    """An MD simulation owning state, integrator and the attached model.

    :param dt: timestep.
    :param integrator: an integrator from :mod:`.integrators` (default
        :class:`.integrators.NVE`).
    :param seed: seed of the simulation's ``torch.Generator``
        (velocities).
    :param device: the device every tensor lives on (default: the
        current CUDA device; with no card this raises -- pass
        ``device="cpu"`` to run on the CPU).
    :param auto_replan: re-plan the cellwise geometry at ``run()``
        boundaries (tighter capacity, overflow self-heal).
    """

    # static repack intervals are quantized so run-to-run velocity jitter
    # does not flap K
    _K_GRID = (1, 2, 3, 4, 5, 6, 8, 10, 12, 14, 16, 20, 24, 32, 48, 64,
               96, 128)

    def __init__(self, dt=0.005, integrator=None, seed=0, device=None,
                 auto_replan=True):
        self.dt = float(dt)
        self._integrator = integrator or _integrators.NVE()
        self.seed = seed
        self.device = resolve_device(device, "Simulation()")
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))
        self.auto_replan = bool(auto_replan)
        #: stencil of the pair forces: 'auto' (kernel K1 on CUDA, the
        #: full tensor form on the CPU), 'kernel', 'half' or 'full'
        self.stencil = "auto"
        #: run the step loop under set_sync_debug_mode("error")
        self.check_syncs = False
        #: pair-force evaluations made so far (built-in and model forces,
        #: loop steps, refreshes and the lane-separability probe's
        #: validation): on CUDA, each one launches K1
        self.force_evals = 0
        #: training updates made so far: on CUDA, each one launches K2
        self.train_steps = 0
        #: packed neighbor-list builds made so far (particle-order route;
        #: with the cell list's 'pallas' method on CUDA each launches K3)
        self.nlist_builds = 0
        #: runs rolled back and re-run because K1's generic-form list was
        #: too short
        self.lane_reruns = 0
        #: of force_evals, the lane-separability probe's validations
        self.probe_evals = 0
        #: slot-layout repacks made so far (cellwise mode; a host count)
        self.repacks = 0
        self._nlist_build = _UNBUILT
        self.state = None
        self.tfc = None
        #: built-in force computes (``add_force``)
        self.forces = []
        self._layout = None
        self._packed = None
        self._form = None
        self._vmax_cache = None
        self._replan_check_step = -1
        #: the thermodynamic records of ``run(n, log_period=k)``: a dict
        #: of numpy arrays (``LOG_KEYS`` and ``step``), accumulated across
        #: runs; ``None`` until a run logged
        self.log = None

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------
    def init_lattice(self, n, density=None, a=None, kind="sc", types=None,
                     kT_init=None, masses=None, dtype=torch.float32):
        """Place ``n`` particles on a lattice in a centered cubic box.

        :param dtype: the state's dtype: ``torch.float64`` runs the whole
            engine in double precision (every kernel's double
            instantiation on the card), the analog of attaching to a
            double-precision HOOMD build, as the JAX package's
            ``init_lattice(dtype=jnp.float64)``.
        """
        pos, lengths = lattice_positions(n, density=density, a=a, kind=kind)
        return self.set_state(init_state(
            pos, lengths, types=types, masses=masses, kT_init=kT_init,
            generator=self.generator, dtype=dtype, device=self.device))

    def init_state(self, positions, box, **kwargs):
        """Adopt :func:`.state.init_state` of ``positions`` and ``box``
        on this simulation's device and generator; ``dtype=`` (default
        float32) sets the state's precision as in :meth:`init_lattice`."""
        kwargs.setdefault("generator", self.generator)
        return self.set_state(init_state(positions, box, device=self.device,
                                         **kwargs))

    def set_state(self, state):
        """Adopt ``state`` (its tensors must be on :attr:`device`)."""
        if state.positions.device != self.device:
            raise ValueError(f"state is on {state.positions.device}, the "
                             f"simulation on {self.device}")
        self._box_host = None
        self._adopt(state)
        fresh = self.integrator.init(state)
        if set(state.thermostat or {}) != set(fresh):
            state.thermostat = fresh
        self.state = state
        self._layout = None
        self._packed = None
        self._vmax_cache = None
        self._nlist_build = _UNBUILT
        return state

    def _adopt(self, state):
        """Bind ``state`` to this simulation (its ``rng`` is the
        simulation's generator) and know its box on the host: ``_lengths``,
        ``_lo``, ``_tilt``. The box is read back only when it is a tensor
        not seen before (a user's new state, or a box a barostat changed
        that the run's readback did not bring)."""
        state.rng = self.generator
        cached = getattr(self, "_box_host", None)
        if cached is None or cached[0] is not state.box:
            box = state.box.detach().cpu().numpy().astype(np.float64)
            self._note_box(state.box, box)
        state.tilted = any(self._tilt)

    def _note_box(self, box_t, box):
        """Record the host values ``box`` of the box tensor ``box_t``."""
        self._box_host = (box_t, box)
        self._lengths, self._lo = box[1] - box[0], box[0]
        self._tilt = tuple(float(t) for t in box[2])

    @property
    def integrator(self):
        return self._integrator

    @integrator.setter
    def integrator(self, integ):
        """Swap integrators (e.g. a Minimize quench before NVT): keys both
        thermostats share carry over, the others are initialized."""
        self._integrator = integ
        # a new integrator gets a freshly sized cell list, as the JAX
        # package's recompiled step does
        self._nlist_build = _UNBUILT
        if self.state is not None:
            fresh = integ.init(self.state)
            current = dict(self.state.thermostat or {})
            if set(current) != set(fresh):
                fresh.update({k: current[k] for k in current if k in fresh})
                self.state.thermostat = fresh
                self._packed = None

    def thermalize_velocities(self, kT):
        """Fresh Maxwell-Boltzmann velocities at ``kT`` with zero net
        momentum, drawn from the simulation's generator."""
        st = self.state
        v = (torch.randn(st.velocities.shape, generator=self.generator,
                         dtype=st.velocities.dtype, device=self.device)
             * torch.sqrt(kT / st.masses)[:, None])
        v = v - v.mean(dim=0, keepdim=True)
        self.state = dataclasses.replace(st, velocities=v)
        self._vmax_cache = None
        return self.state

    def add_force(self, force):
        """Register a built-in pair force (``md.LennardJones``,
        ``md.WCA``). Built-in forces drive the dynamics alone, add to an
        attached model's forces, or serve as the labels of online
        training."""
        self.forces.append(force)
        self._layout = None
        self._packed = None
        self._nlist_build = _UNBUILT
        return force

    def thermo(self):
        """Current thermodynamic quantities (dict of host floats)."""
        return {k: float(v) for k, v in _thermo.thermo(self.state).items()}

    def _label_forces(self, subset=None):
        """The sum of the built-in forces (or of ``subset``) at the current
        state: ``[N, 4]`` in particle order, energy in column 4 (the
        staged label forces ``tfcompute.get_forces_array`` returns in
        training mode)."""
        forces = list(self.forces if subset is None else subset)
        state = self.state
        f = torch.zeros_like(state.forces)
        if self._use_cellwise():
            layout = self._ensure_layout()
            st, aux = layout.pack(state)
            with torch.no_grad():
                fs, _ = self._builtins(st, aux, layout, True, False, forces)
            return f if fs is None else layout.to_particles(fs, aux)
        nlist = self._build_nlist(state)
        with torch.no_grad():
            for force in forces:
                f = f + force(state, nlist)[0]
        return f

    def replan(self):
        """Re-derive the cellwise plan from the current state at the next
        ``run()`` (capacity and grid from measured occupancy)."""
        self._layout = None
        self._packed = None
        self._nlist_build = _UNBUILT
        self._static_K_cap = None
        self._static_K_last = None
        self._replan_check_step = (self.state.step if self.state is not None
                                   else -1)

    # ------------------------------------------------------------------
    # planning
    # ------------------------------------------------------------------
    def _nlist_params(self):
        """``(r_cut, rc_matrix, method, NN)`` of the neighbor build: from
        the attached tfcompute, or with none from the built-in forces' own
        cutoffs (the cellwise mode when the box holds 3 cells of the
        cutoff per axis, else ``'auto'`` with NN from the mean density);
        ``None`` when nothing needs neighbors."""
        tfc = self.tfc
        if tfc is not None:
            NN = tfc.model.nneighbor_cutoff
            if _is_cellwise(tfc.nlist_method):
                return tfc.r_cut, tfc.r_cut_matrix, tfc.nlist_method, NN
            if NN <= 0:
                return None
            return (tfc.r_cut, tfc.r_cut_matrix, tfc.nlist_method or "auto",
                    max(1, NN))
        r = max((float(getattr(f, "r_cut", 0.0) or 0.0)
                 for f in self.forces), default=0.0)
        if r <= 0.0:
            return None
        # a tilted box hosts the grid by its perpendicular layer widths
        widths = (_cw._perp_widths(self._lengths, self._tilt)
                  if any(self._tilt) else self._lengths)
        if np.all(np.asarray(widths) // r >= 3):
            return r, None, "cellwise", None
        n = self.state.n_particles
        mean_nbrs = 4.19 * r ** 3 * (n / float(np.prod(self._lengths)))
        NN = int(min(n - 1, max(8, np.ceil(2.0 * mean_nbrs))))
        return r, None, "auto", NN

    def _use_cellwise(self):
        p = self._nlist_params()
        return p is not None and _is_cellwise(p[2])

    def _kernel_eligible(self):
        """Will kernel K1 be the hot loop? (The planner then costs the
        14-block candidate width, like ``_pallas_eligible`` on a TPU; on
        the card every lane pass of a train step is a 14-wide kernel
        too.) A PairModel runs K1 in a pair form or the generic form; a
        generic SimModel once the lane-separability probe validated it
        (the planes route is 27 blocks wide)."""
        if self.stencil == "kernel":
            return True
        if self.stencil != "auto" or self.device.type != "cuda":
            return False
        tfc = self.tfc
        if tfc is not None and tfc.map_enabled:
            return False  # the planes route (JAX: _pallas_eligible)
        if tfc is None or tfc.train or isinstance(tfc.model, PairModel):
            return True
        return bool(getattr(tfc, "_lane_fast_ok", False))

    def _model_lane_cost_scale(self):
        """Relative per-lane cost of the model's pair evaluation against
        the LJ form the planner's lane cost stands for: 1, also for a
        synthesized pair function (no measurement on the card prices it
        yet; the JAX package counts its jaxpr's primitives, which the port
        does not have). For a proxy this
        is an operation count, not a measurement: two Clenshaw series of
        ~3 operations per term against LJ's ~10 inside the cut, times 3
        in training (the labels, the proxy primal and K2's moment pass),
        the shape of the JAX package's ``_model_lane_cost_scale``."""
        tfc = self.tfc
        if tfc is None or not getattr(tfc.model, "proxy_degree", None):
            return 1.0
        scale = max(1.0, (6.0 * tfc.model.proxy_degree + 10.0) / 10.0)
        return scale * 3.0 if tfc.train else scale

    def _vmax_now(self):
        """Max particle speed (one readback, cached per state object)."""
        c = self._vmax_cache
        if c is not None and c[0] is self.state:
            return c[1]
        v = self.state.velocities
        vm = float(torch.sqrt(torch.max(torch.sum(v * v, dim=-1))))
        self._vmax_cache = (self.state, vm)
        return vm

    def _drift_estimate(self):
        vmax = self._vmax_now()
        return self.dt * vmax / 0.8 if vmax > 0 else None

    def _plan_from_current(self):
        r_cut, _, method, _ = self._nlist_params()
        config = method if isinstance(method, _cw.Cellwise) else None
        dynamic = self._changes_box()
        if dynamic:
            if any(self._tilt):
                raise NotImplementedError(
                    "tilted (triclinic) boxes do not support "
                    "box-changing integrators (NPT) yet")
            # barostat headroom: a minimum skin that keeps a positive
            # Verlet margin through ~10% compression
            base = config or _cw.Cellwise()
            config = _cw.Cellwise(capacity=base.capacity,
                                  skin=max(base.skin, 0.15 * r_cut))
        occ_observed = None
        hist = getattr(self, "_occ_hist", [])
        if hist and not dynamic:
            okey = hist[-1][0]
            if okey[1] == tuple(float(v) for v in self._lengths) and \
                    okey[2] == self.state.n_particles and \
                    sum(h[2] for h in hist) >= 300:
                occ_observed = (okey[0], max(h[1] for h in hist))
        plan = _cw.plan_cellwise(
            self.state.n_particles, self._lengths, r_cut, config=config,
            positions=(None if occ_observed is not None else
                       self.state.positions.detach().cpu().numpy()),
            lo=self._lo, drift_per_step=self._drift_estimate(),
            width_blocks=14 if self._kernel_eligible() else 27,
            occ_observed=occ_observed,
            lane_cost_scale=self._model_lane_cost_scale(), tilt=self._tilt)
        floor = getattr(self, "_capacity_floor", 0)
        if plan is not None and plan.capacity < floor:
            plan = dataclasses.replace(plan, capacity=floor)
        if plan is not None and dynamic and \
                (config is None or config.capacity is None):
            # compression densifies the cells: 15% more slots before the
            # repack's overflow fires
            plan = dataclasses.replace(
                plan, capacity=int(np.ceil(plan.capacity * 1.15)))
        return plan

    def _changes_box(self):
        return bool(getattr(self.integrator, "changes_box", False))

    def _layout_fits(self, layout):
        """Does ``layout`` serve the current box and integrator? A static
        plan is made for one box, a dynamic one for any box of a
        box-changing integrator."""
        if layout.dynamic_box != self._changes_box():
            return False
        return layout.dynamic_box or (
            layout.plan.lengths == tuple(float(v) for v in self._lengths)
            and layout.lo == tuple(float(v) for v in self._lo)
            and layout.plan.tilt == self._tilt)

    def _ensure_layout(self, plan=None):
        """The slot layout of the current plan, made when there is none
        (from ``plan`` when given: a checkpoint's)."""
        layout = self._layout
        if layout is not None and not self._layout_fits(layout):
            self.replan()
            layout = None
        if layout is not None:
            return layout
        r_cut, rc_matrix, _, _ = self._nlist_params()
        if plan is None:
            plan = self._plan_from_current()
        if plan is None:
            raise ValueError(
                f"Box {self._lengths} too small for the cellwise mode at "
                f"r_cut={r_cut} (needs >= 3 cells per axis)")
        layout = SlotLayout(plan, self.state.n_particles, self._lo,
                            rc_matrix=rc_matrix,
                            dtype=self.state.positions.dtype,
                            device=self.device, box=self.state.box,
                            dynamic_box=self._changes_box())
        # every device constant the step loop reads is made here, so the
        # loop never copies from the host
        layout.geometry.offsets(_cw._HALF_OFFS)
        layout.geometry.offsets(_cw._OFFS)
        self._builtin_forms = []
        dtype = self.state.positions.dtype
        for f in self.forces:
            form = f.kernel_form()
            form.tensor(self.device, dtype)
            self._builtin_forms.append(form)
        form = None
        model = self.tfc.model if self.tfc is not None else None
        if isinstance(model, PairModel) and not model.proxy_degree:
            form = model.pair_kernel_form()
            if form is not None:
                form = form.kernel_form()
                form.tensor(self.device, dtype)
        self._form = form
        # the list of K1's generic form (a PairModel without a form, a
        # probed SimModel): first estimated for the plan, then sized by
        # each committed run's need, which depends on the cells and not
        # on their capacity: a plan of the same cells keeps the list
        key = (plan.grid, plan.lengths, plan.r_cut, self.state.n_particles)
        if getattr(self, "_lanes_key", None) != key:
            self._lanes = LaneBudget(
                lane_budget(plan, self.state.n_particles), self.device)
            self._lanes_key = key
        self._layout = layout
        return layout

    # the host-side schedule of the engine: what a run's choices (plan,
    # repack interval, list size) are made from besides the state
    _SCHEDULE = ("_static_K_last", "_static_K_cap", "_static_K_clean",
                 "_vmax_hist", "_occ_hist", "_capacity_floor",
                 "_cl_capacity_floor", "_replan_check_step")

    def _engine_record(self):
        """What :func:`..serialize.save_checkpoint` keeps for an exact
        resume besides the state: the schedule, the cellwise plan and the
        slot order the next ``run()`` would start from, and the generic
        form's list size; plain Python values and numpy arrays."""
        rec = {k: copy.deepcopy(getattr(self, k)) for k in self._SCHEDULE
               if hasattr(self, k)}
        rec["same_integrator"] = (getattr(self, "_static_K_integ", None) ==
                                  id(self.integrator))
        layout = self._layout
        if layout is not None:
            rec["plan"] = dataclasses.asdict(layout.plan)
            rec["replan_throttle"] = getattr(layout, "_replan_throttle",
                                             None)
            packed = self._packed
            if packed is not None and packed[0] is self.state and \
                    packed[1] is layout:
                aux = packed[2][1]
                rec["orig"] = aux["orig"].cpu().numpy().copy()
                rec["occ_max"] = int(aux["occ_max"])
        lanes = getattr(self, "_lanes", None)
        if lanes is not None:
            rec["lanes"] = (lanes.budget, lanes.committed,
                            copy.deepcopy(self._lanes_key))
        return rec

    def _restore_engine(self, rec):
        """Restore :meth:`_engine_record`'s record after the state it was
        taken with was set: the next ``run()`` then makes the choices and
        starts from the slot order the recorded simulation's would."""
        for k in self._SCHEDULE:
            if k in rec:
                setattr(self, k, copy.deepcopy(rec[k]))
        if rec.get("same_integrator"):
            self._static_K_integ = id(self.integrator)
        if "plan" in rec and self._use_cellwise():
            plan = _cw.CellwisePlan(**{k: tuple(v) if isinstance(v, list)
                                       else v for k, v in rec["plan"].items()})
            layout = self._ensure_layout(plan)
            if rec.get("replan_throttle") is not None:
                layout._replan_throttle = rec["replan_throttle"]
            if "orig" in rec:
                orig = torch.as_tensor(rec["orig"], device=self.device)
                st, aux = layout.pack(self.state, src=orig)
                aux["occ_max"] = torch.tensor(
                    rec["occ_max"], dtype=torch.int32, device=self.device)
                self._packed = (self.state, layout, (st, aux))
        if "lanes" in rec:
            # after the layout, which makes a first estimate of its own
            budget, committed, key = rec["lanes"]
            self._lanes = LaneBudget(budget, self.device)
            self._lanes.committed = committed
            self._lanes_key = key

    def _max_occupancy_now(self, layout):
        cell = _cw.bin_cells(self.state.positions, layout.lo, layout.plan,
                             layout.geom(self.state))
        return int(torch.bincount(cell.long(),
                                  minlength=layout.plan.n_cells).max())

    def _maybe_auto_replan(self, layout):
        """Tighten a stale plan at a run() boundary when a fresh plan
        would run clearly fewer pair lanes (throttled, with backoff)."""
        step = self.state.step
        if step < 100:
            return layout
        throttle = getattr(layout, "_replan_throttle", 500)
        if 0 <= self._replan_check_step and \
                step - self._replan_check_step < throttle:
            return layout
        self._replan_check_step = step
        hist = [h for h in getattr(self, "_occ_hist", [])
                if h[0][0] == layout.plan.grid]
        occ = (max(h[1] for h in hist) if hist
               else self._max_occupancy_now(layout))
        floor = getattr(self, "_capacity_floor", 0)
        if floor and floor > int(np.ceil(occ * 1.5)) + 5:
            self._capacity_floor = 0
        cap = layout.plan.capacity
        if not hist and \
                cap <= 1.1 * (occ + max(3, int(np.ceil(0.15 * occ)))):
            layout._replan_throttle = min(throttle * 2, 8000)
            return layout
        fresh = self._plan_from_current()
        if fresh is None:
            return layout
        wb = 14 if self._kernel_eligible() else 27
        pad = _cw._pad_to

        def lanes(p):
            return p.n_cells * pad(p.capacity, 8) * pad(wb * p.capacity, 128)

        cur, new = lanes(layout.plan), lanes(fresh)
        if cur <= 1.1 * new:
            layout._replan_throttle = min(throttle * 2, 8000)
            return layout
        if not self.auto_replan:
            warnings.warn(
                f"the active cellwise plan (grid {layout.plan.grid}, "
                f"capacity {layout.plan.capacity}) carries "
                f"{cur / new:.1f}x the pair work a fresh plan would: "
                "sim.replan() would run faster", stacklevel=3)
            return layout
        self.replan()
        return self._ensure_layout()

    def _choose_repack_interval(self, layout):
        """Static rebuild interval K: the Verlet bound (half skin over the
        fastest particle's per-step displacement) with a 0.8 safety
        factor, on the ``_K_GRID``; staleness self-heals by lowering K.

        A dynamic-box (NPT) layout takes its skin from the live box at
        the run() boundary, with half the margin (the barostat erodes it
        during the run); where that leaves K = 1 it returns ``None``: the
        step loop then repacks every step after the drift, right before
        the forces (the JAX package's per-step conditional rebuild, with
        no host sync), and no step can go stale."""
        if isinstance(self.integrator, _integrators.Brownian):
            # overdamped noise moves a particle ~sqrt(2 kT dt / gamma) a
            # step, bounded by no speed: repack every step (the moves come
            # after the step's forces, so every force evaluation sees a
            # fresh assignment)
            return 1
        skin = float(layout.plan.skin)
        if layout.dynamic_box:
            edges = np.asarray(self._lengths, float) / \
                np.asarray(layout.plan.grid, float)
            skin = (float(np.min(edges)) - float(layout.plan.r_cut)) * 0.5
            if skin <= 0:
                self._static_K_last = None
                return None
        if skin <= 0:
            return 1
        half = 0.98 * skin / 2.0
        per = getattr(self.integrator, "max_disp", None)
        if not per:
            vmax = max([self._vmax_now()] +
                       [h[0] for h in getattr(self, "_vmax_hist", [])])
            per = self.dt * vmax if vmax > 0 else half / 16.0
        K_est = max(int(half / float(per) * 0.8), 1)
        K = max(g for g in self._K_GRID if g <= K_est)
        if layout.dynamic_box and K == 1:
            self._static_K_last = None
            return None
        last = getattr(self, "_static_K_last", None)
        if last is not None and last <= K and \
                last >= max(g for g in self._K_GRID if g <= max(K - 1, 1)):
            K = last
        cap = getattr(self, "_static_K_cap", None)
        if cap:
            K = min(K, cap)
        self._static_K_last = K
        return K

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------
    def _pair_eval(self, st, aux, layout, pair_fn, form, needs_energy,
                   want_virial, with_types, min_r2):
        """One analytic pair-force evaluation on slot state (counted in
        :attr:`force_evals`)."""
        self.force_evals += 1
        return _cw.analytic_pair_forces(
            st.positions, st.types, aux["valid"], layout.plan, layout.lo,
            pair_fn, needs_virial=want_virial, min_r2=min_r2,
            with_types=with_types, rcut_matrix=layout.rc2_tab,
            stencil=self.stencil, needs_energy=needs_energy, form=form,
            geometry=layout.geom(st), lanes=self._lanes)

    def _count_eval(self):
        self.force_evals += 1
        self.probe_evals += 1

    def _planes_eval(self, st, aux, layout, want_virial, capture=True):
        """The model on the cellwise planes route: its outputs on the
        masked 27-block planes, forces by autograd (a generic SimModel
        the lane-separability probe did not validate)."""
        model = self.tfc.model
        planes, pos4 = layout.planes(st, aux), st.positions4
        mapped = self.tfc.map_enabled
        if mapped:
            # the model's rows are particle order (mapped_nlist slices by
            # row index): gather them, and scatter its outputs back
            inv = _inv_slots(layout, aux)
            planes = planes.map(lambda c: c.detach()[inv])
            pos4 = pos4[inv]
        out = model([planes, pos4, st.box], training=False)
        if capture:
            self.tfc.capture(out[self.tfc.output_offset:])
        valid = aux["valid"][:, None]
        f = out[0].detach()
        if f.shape[-1] == 3:
            f = torch.cat([f, torch.zeros_like(f[:, :1])], dim=-1)
        w = None
        if want_virial and model.virial and len(out) > 1:
            w = out[1].detach()
        if mapped:
            # a mapped model may give the atom rows only: the beads' are 0
            f = layout.to_slots(_pad_rows(f, layout.n), aux)
            if w is not None:
                w = layout.to_slots(_pad_rows(w, layout.n), aux)
        if w is not None:
            w = w * valid[:, :, None]
        return f * valid, w

    def _builtins(self, st, aux, layout, needs_energy, want_virial,
                  subset=None):
        """Sum of the built-in forces (or of ``subset``): ``(forces4,
        virial)``, ``(None, None)`` when there are none."""
        f = w = None
        for force, form in zip(self.forces, self._builtin_forms):
            if subset is not None and not any(force is g for g in subset):
                continue
            fi, wi = self._pair_eval(st, aux, layout,
                                     force.pair_energy_and_slope, form,
                                     needs_energy, want_virial, True, 1e-4)
            f = fi if f is None else f + fi
            if wi is not None:
                w = wi if w is None else w + wi
        return f, w

    def _model_eval(self, st, aux, layout, route, needs_energy,
                    want_virial, capture=True):
        """The attached model's forces and virial on slot state (outside
        training; ``(None, None)`` for a model that gives no forces). Its
        outputs go to the driver's capture, unless ``capture`` is False:
        the run's closing evaluation is no model call of the JAX
        package's."""
        if route.model_fn is not None:
            return self._pair_eval(
                st, aux, layout, route.model_fn, route.model_form,
                needs_energy, bool(want_virial and self.tfc.model.virial),
                route.with_types, route.min_r2)
        if route.planes:
            return self._planes_eval(st, aux, layout, want_virial, capture)
        return None, None

    def _carry_model(self, st, aux, layout, route):
        """An evaluation step of a ``period`` > 1 run: the model's forces
        (with their energy, as the JAX package's gated step computes
        them) and, when the run reads one, its virial go into ``aux``
        (``'mf'``, ``'mw'``), where they stand until the next evaluation
        and follow their particles through each repack."""
        fm, wm = self._model_eval(st, aux, layout, route, True,
                                  route.carry_virial)
        return {**aux, "mf": fm, "mw": wm if route.carry_virial else None}

    def _forces(self, st, aux, layout, route, needs_energy, want_virial,
                capture=True):
        """The forces that drive the dynamics: the built-ins plus, outside
        training, the attached model's (with ``period`` > 1 the carried
        ones)."""
        f, w = self._builtins(st, aux, layout, needs_energy, want_virial)
        if route.model_period > 1:
            fm, wm = aux["mf"], aux.get("mw")
        else:
            fm, wm = self._model_eval(st, aux, layout, route, needs_energy,
                                      want_virial, capture)
        if fm is not None:
            f = fm if f is None else f + fm
            if wm is not None:
                w = wm if w is None else w + wm
        return f, w

    def _route(self, layout, st, aux):
        """What one run() evaluates: the model's pair function and kernel
        form (a proxy is fitted once per run: its weights do not change
        outside training; a generic SimModel's is synthesized once the
        probe validated it, else the planes route), or the trainer; and
        the virial flags."""
        tfc = self.tfc
        model = tfc.model if tfc is not None else None
        r = _Route()
        # the step loop reads the virial only for a barostat (and on a
        # logged step); the run's closing evaluation computes it whenever
        # the state's virial has a source: a model that declares one, or a
        # built-in force
        r.virial_in_loop = bool(getattr(self.integrator, "needs_virial",
                                        False))
        r.needs_virial = bool(r.virial_in_loop or self.forces or
                              (model is not None and model.virial))
        if model is None:
            return r
        if tfc.map_enabled:
            r.map_i = model._map_i
        if tfc.train:
            if tfc.map_enabled:
                raise ValueError(
                    "train=True with a mapped neighbor list is not "
                    "supported in the cellwise mode; use nlist='cell' or "
                    "'n2'")
            if not self.forces:
                raise ValueError(
                    "online training needs label forces: add a built-in "
                    "force first (sim.add_force(md.LennardJones(...)))")
            r.trainer = _Trainer(self, layout, st, aux)
            subset = tfc.reference_forces
            if subset and len(subset) != len(self.forces):
                r.label_subset = list(subset)
        elif tfc.map_enabled:
            # mapped attachments never take K1's fast routes or the probe
            tfc._lane_fast_ok = False
            if not model.output_forces:
                return r
            r.planes = True
        elif not isinstance(model, PairModel):
            if not model.output_forces:
                return r
            if self._probe_lane_fast(layout, st, aux):
                from ..ops.lane_fast import synthesize_pair_fn
                r.model_fn = synthesize_pair_fn(model, st.box)
                r.with_types, r.min_r2 = True, 1e-4
            else:
                r.planes = True
        elif model.proxy_degree:
            fit, evaluate = model.proxy_parts(layout.plan.r_cut,
                                              self.device)
            with torch.no_grad():
                coeffs = fit(model.pair_energy)
            if model.pair_with_types:
                r.model_fn = lambda r2, ti, tj: evaluate(coeffs, r2, ti, tj)
            else:
                r.model_fn = lambda r2: evaluate(coeffs, r2)
            r.model_form = evaluate.kernel_form(coeffs)
        else:
            r.model_fn, r.model_form = model.pair_energy_and_slope, \
                self._form
        if isinstance(model, PairModel):
            r.with_types, r.min_r2 = model.pair_with_types, model.min_r2
        if r.model_fn is not None or r.planes:
            r.model_period = tfc.period
        return r

    def _probe_lane_fast(self, layout, st, aux):
        """Is the attached generic SimModel lane-separable on this state
        (:mod:`..ops.lane_fast`)? The verdict is kept on the driver
        (``tfc._lane_fast_ok``, why in ``tfc._lane_fast_report``) and
        cached per attach configuration, plan
        and ``model._trace_version``; ``HTF_LANE_FAST=0`` turns the probe
        off (the planes route). On the card the validation compares
        against K1's generic form, the route the model then runs, and
        runs the model's planes in row chunks."""
        import os
        from ..ops.lane_fast import synthesize_pair_fn, validate_pair_fn
        tfc = self.tfc
        model = tfc.model
        if os.environ.get("HTF_LANE_FAST", "1") == "0":
            tfc._lane_fast_ok = False
            return False
        key = (tfc.config_key(), layout.plan, model._trace_version,
               self.stencil, str(self.device))
        cache = getattr(tfc, "_lane_fast_cache", None)
        if cache is not None and cache[0] == key:
            tfc._lane_fast_ok = cache[1]
            return cache[1]
        stencil = self.stencil
        if stencil == "auto":
            stencil = "kernel" if self.device.type == "cuda" else "full"
        report = {}
        # the validation's model calls are no model calls of a run: what
        # they update (a metric's count) is restored
        snap = StateSnapshot(model)
        try:
            ok = validate_pair_fn(
                model, synthesize_pair_fn(model, st.box), st, aux, layout,
                stencil, lanes=self._lanes,
                lane_chunk=(_PROBE_LANES if self.device.type == "cuda"
                            else None),
                on_eval=self._count_eval, report=report)
        finally:
            snap.restore()
        tfc._lane_fast_ok = ok
        tfc._lane_fast_report = report
        tfc._lane_fast_cache = (key, ok)
        if ok:
            # the plan was costed for the planes route's 27-block width;
            # K1's is 14: re-judge it at the next run() boundary
            self._replan_check_step = -1
            layout._replan_throttle = 500
        return ok
    def _step(self, st, aux, flags, layout, route, i, log=None):
        """One MD step on slot state (slim: no energy column, and no
        virial unless something in the loop reads it; a step ``log``
        records takes both, K1's ``<energy, virial>`` variant, chosen on
        the host). Returns the state, the layout's ``aux`` and the
        flags."""
        integ, dt = self.integrator, self.dt
        log_now = log is not None and log.due(st.step)
        want_w = route.virial_in_loop or log_now
        st = integ.pre_force(st, dt)
        # ghost pins stay unconditional, as in the JAX engine
        st = layout.ghost_pin(st, aux)
        if route.map_i is not None:
            # the beads follow the atoms before the rebuild check, so a
            # bead's move counts toward a repack
            st = self._map_slots(st, aux, layout, route)
        if route.repack_each_step:
            st, aux = layout.rebuild(st, aux)
            self.repacks += 1
        stale = layout.needs_rebuild(st, aux)
        if layout.dynamic_box:
            # the box the forces see: too small a box (or a non-finite
            # one) is an overflow, which no repack can heal
            flags = flags | layout.geometry_bad(st).to(torch.int32)
        tr = route.trainer
        if tr is not None:
            # one built-in evaluation: the labels and the driving forces;
            # the model trains every `period` steps (st.step is a host int)
            f4, w = self._builtins(st, aux, layout, tr.energy or log_now,
                                   want_w)
            if st.step % self.tfc.period == 0:
                labels = f4
                if route.label_subset is not None:
                    labels, _ = self._builtins(st, aux, layout, tr.energy,
                                               False, route.label_subset)
                tr.step(st, aux, layout, labels, i)
        else:
            if route.model_period > 1 and st.step % route.model_period == 0:
                aux = self._carry_model(st, aux, layout, route)
            f4, w = self._forces(st, aux, layout, route, log_now, want_w)
        st.forces = _mask_beads(f4, aux["orig"], route.map_i)
        if want_w:
            st.virial = torch.zeros_like(st.virial) if w is None else w
        st = integ.post_force(st, dt)
        st = layout.ghost_pin(st, aux)
        if log_now:
            log.record(st, aux["valid"])
        st.step += 1
        return st, aux, flags | (stale.to(torch.int32) << 1)

    def _map_slots(self, st, aux, layout, route):
        """The mapping write-back in slot order: the atom rows gathered
        into particle order, the mapping run on them, the bead positions
        scattered into the beads' slot rows (the JAX package's
        ``mapped_apply_slots``)."""
        inv = _inv_slots(layout, aux)
        aan = route.map_i
        cg3 = self.tfc.bead_positions(st.positions4[inv[:aan]], st.box)
        return dataclasses.replace(
            st, positions=st.positions.index_copy(0, inv[aan:], cg3))

    def _fetch_run_scalars(self, flags, aux, losses=None, box=None,
                           log=None):
        """The one packed device->host readback of a run(): flags, running
        max occupancy, running max speed, the most lanes K1's generic-form
        list needed, the final box when a barostat changed it, the
        per-step training losses and the thermodynamic records (the
        floats bitcast into the int lanes). Returns ``(flags, occ, vmax,
        lanes, box or None, losses, log records [rows, 4])``."""
        ints = [flags.to(torch.int32).reshape(1),
                aux["occ_max"].to(torch.int32).reshape(1),
                aux["vmax"].to(torch.float32).reshape(1).view(torch.int32),
                self._lanes.needed.to(torch.int32).reshape(1)]
        head, box_f, losses_f, log_f = _readback(
            ints, box, losses, None if log is None else log.buf)
        box_now = (None if box_f is None else
                   box_f.astype(np.float64).reshape(3, 3))
        return (int(head[0]), int(head[1]),
                float(head[2:3].view(np.float32)[0]), int(head[3]),
                box_now, losses_f, log_f)

    # ------------------------------------------------------------------
    def run(self, n, log_period=None):
        """Advance the simulation ``n`` steps.

        Self-healing: a capacity overflow rolls the segment back (nothing
        of the attempt is committed: state, every model variable,
        optimizer state, outputs and log records) and replans with a
        raised capacity floor; a staleness bit (a particle outran skin/2
        between two scheduled repacks) rolls back and shortens the
        repack interval.

        :param log_period: if set, record the kinetic and potential
            energy, temperature and pressure at each step whose number is
            a multiple of it (taken after the step's forces and second
            half-kick, before the step count rises) into :attr:`log`, a
            dict of numpy arrays with the step numbers under ``'step'``;
            the records accumulate across runs (the analog of the
            reference's hoomd ``analyze.log``). They ride the run's one
            readback.
        """
        if self.state is None:
            raise RuntimeError("Initialize the simulation state first "
                               "(init_lattice / init_state)")
        if self.tfc is None and not self.forces:
            raise RuntimeError("Attach a model first (tfcompute.attach) or "
                               "add a built-in force (add_force)")
        n = int(n)
        if n <= 0:
            return
        if log_period is not None and int(log_period) < 1:
            raise ValueError(f"log_period must be >= 1, got {log_period}")
        self._adopt(self.state)
        run_once = self._run_once if self._use_cellwise() \
            else self._run_packed
        model = self.tfc.model if self.tfc is not None else None
        with _engine_calls(model):
            for attempt in range(5):
                # a rolled-back attempt is re-run with the same noise
                rng = self.generator.get_state()
                if run_once(n, allow_retry=attempt < 4,
                            log_period=log_period):
                    return
                self.generator.set_state(rng)

    def _run_once(self, n, allow_retry, log_period=None):
        layout = self._maybe_auto_replan(self._ensure_layout())
        if getattr(self, "_static_K_integ", None) != id(self.integrator):
            # a new integrator's regime must not inherit the old interval
            self._static_K_last = None
            self._vmax_hist = []
            self._static_K_integ = id(self.integrator)
        K = self._choose_repack_interval(layout)
        packed = self._packed
        if packed is not None and packed[0] is self.state and \
                packed[1] is layout:
            st, aux = packed[2]
            # shallow copy: fields are rebound, never written in place, so
            # the cached pack survives a rolled-back attempt
            st = dataclasses.replace(st)
            aux = {**aux, "vmax": layout._vmax(st.velocities)}
        else:
            st, aux = layout.pack(self.state)
        route = self._route(layout, st, aux)
        route.repack_each_step = K is None
        log = (None if log_period is None else
               _Log(log_period, self.state.step, n, self.state.positions))
        needs_virial = route.needs_virial or log is not None
        tfc = self.tfc
        if route.model_period > 1:
            # the model's forces and virial of its last evaluation, carried
            # from the last committed run (zeros at first), in slot order
            route.carry_virial = bool(tfc.model.virial and needs_virial)
            mf, mw = tfc.model_forces(self.state)
            aux = {**aux, "mf": layout.to_slots(mf, aux),
                   "mw": (layout.to_slots(mw, aux) if route.carry_virial
                          else None)}
        tr = route.trainer
        # what a rollback restores: every model variable (weights, metrics,
        # EDS state) and, under training, the optimizer's state
        snap = (None if tfc is None else
                StateSnapshot(tfc.model, None if tr is None else tr.opt))
        if tr is not None:
            tr.begin(n)
        if tfc is not None:
            tfc.begin_outputs()
        self._lanes.reset()
        start_step = self.state.step
        flags = torch.zeros((), dtype=torch.int32, device=self.device)
        with _sync_guard(self.check_syncs):
            done = 0
            while done < n:
                st, aux = layout.rebuild(st, aux)
                self.repacks += 1
                for _ in range(n - done if K is None else min(K, n - done)):
                    st, aux, flags = self._step(st, aux, flags, layout,
                                                route, done, log)
                    done += 1
            flags = flags | aux["overflow"].to(torch.int32)
            if layout.dynamic_box:
                flags = flags | layout.geometry_bad(st).to(torch.int32)
            # one full evaluation at the final positions: the slim loop
            # skipped the energy column (and the virial when unused); a
            # period > 1 run adds the model's carried forces. It is no
            # model call of the JAX package's: what the model updates in
            # it (a metric) is restored
            final = (StateSnapshot(tfc.model) if route.model_period == 1
                     and (route.model_fn is not None or route.planes)
                     else None)
            f4, w = self._forces(st, aux, layout, route, True,
                                 needs_virial, capture=False)
            if final is not None:
                final.restore()
            st.forces = _mask_beads(f4, aux["orig"], route.map_i)
            if needs_virial:
                st.virial = torch.zeros_like(st.virial) if w is None else w
            # bit 3: K1's generic-form list was too short in some call
            flags = flags | (self._lanes.overflow().to(torch.int32) << 3)
        flags_now, occ_now, vmax_now, lanes_now, box_now, losses, log_vals = \
            self._fetch_run_scalars(
                flags, aux, None if tr is None else tr.losses,
                st.box if layout.dynamic_box else None, log)
        if tr is not None:
            losses = losses[tr.trained]
        overflow, stale = bool(flags_now & 1), bool(flags_now & 2)
        short = bool(flags_now & 8)
        if (short or overflow or stale) and snap is not None:
            # a failed attempt commits nothing of the model, retried or
            # not (the JAX package commits model values only after a
            # clean run)
            snap.restore()
        if short:
            # forces of the cells that did not fit were left out: roll
            # back and re-run with a list sized from what was needed
            self._lanes.grow()
            self.lane_reruns += 1
            if allow_retry:
                warnings.warn(
                    f"the pair list of K1's generic form was too short; "
                    f"re-running these {n} steps with "
                    f"{self._lanes.budget} lanes")
                return False
            raise RuntimeError("the pair list of K1's generic form stayed "
                               "too short over the run's retries")
        if overflow and layout.dynamic_box:
            # under a barostat the grid cannot grow with the box: the run
            # is rolled back (self.state still holds its start) and raises
            raise ValueError(
                "Cell capacity exceeded during the run (a cell held more "
                "particles than planned, or -- under a barostat -- the box "
                "shrank until min(edge) < r_cut or went non-finite). "
                "Increase Cellwise(capacity=) or attach with nlist='n2'.")
        if overflow and allow_retry and self.auto_replan:
            floor = max(int(np.ceil(layout.plan.capacity * 1.3)) + 1,
                        int(np.ceil(self._max_occupancy_now(layout) * 1.15))
                        + 3)
            self._capacity_floor = max(getattr(self, "_capacity_floor", 0),
                                       floor)
            self._layout = None
            self._packed = None
            warnings.warn(
                f"cell capacity {layout.plan.capacity} exceeded; "
                f"replanning with capacity >= {floor} and re-running "
                f"these {n} steps from their start")
            return False
        if stale and not overflow and allow_retry:
            notch = max([g for g in self._K_GRID if g < K], default=1)
            prev = getattr(self, "_static_K_cap", None)
            self._static_K_cap = max(1, K // 4) if prev == K else notch
            self._static_K_clean = 0
            warnings.warn(
                f"Verlet staleness under the static repack schedule "
                f"(interval {K}); re-running these {n} steps with "
                f"interval {self._static_K_cap}")
            return False
        clean = not (overflow or stale)
        if clean and getattr(self, "_static_K_cap", None):
            self._static_K_clean = getattr(self, "_static_K_clean", 0) + 1
            if self._static_K_clean >= 2 and n >= 200:
                self._static_K_cap = min(
                    [g for g in self._K_GRID if g > self._static_K_cap],
                    default=self._static_K_cap)
                self._static_K_clean = 0
        if clean:
            # the next run's generic-form list, from this run's need
            self._lanes.fit(lanes_now)
            # running max occupancy and speed of committed runs, windowed
            # so transients age out; they calibrate replan() and K
            okey = (layout.plan.grid, layout.plan.lengths,
                    self.state.n_particles)
            hist = [h for h in getattr(self, "_occ_hist", [])
                    if h[0] == okey]
            hist.append((okey, occ_now, n))
            while len(hist) > 1 and sum(h[2] for h in hist[:-1]) > 2000:
                hist.pop(0)
            self._occ_hist = hist
            vhist = getattr(self, "_vmax_hist", [])
            vhist.append((vmax_now, n))
            while len(vhist) > 1 and sum(h[1] for h in vhist[:-1]) > 3000:
                vhist.pop(0)
            self._vmax_hist = vhist

        self.state = layout.unpack(st, aux)
        self.state.step = start_step + n
        if box_now is not None:
            self._note_box(self.state.box, box_now)
        self._vmax_cache = (self.state, vmax_now)
        self._packed = (self.state, layout, (st, aux))
        if overflow:
            raise ValueError(
                "Cell capacity exceeded during the run (a cell held more "
                "particles than planned). Increase Cellwise(capacity=).")
        if stale:
            raise ValueError(
                f"A particle moved more than skin/2 between two scheduled "
                f"neighbor rebuilds even at repack interval {K} -- the "
                f"integration is likely diverging (dt={self.dt}).")
        if route.model_period > 1:
            mw = aux.get("mw")
            tfc.keep_model_forces(
                layout.to_particles(aux["mf"], aux),
                torch.zeros_like(self.state.virial) if mw is None else
                layout.to_particles(mw, aux))
        if tr is not None:
            # a failed attempt's losses belong to training it rolled back
            tfc.loss_history.extend(losses.tolist())
        if tfc is not None:
            tfc.commit_outputs()
        self._commit_log(log, log_vals)
        return True

    def _commit_log(self, log, values):
        """A committed run's thermodynamic records join :attr:`log`."""
        if log is None or not len(log.steps):
            return
        values = values.reshape(len(log.steps), len(_thermo.LOG_KEYS))
        entry = {k: values[:, j].copy()
                 for j, k in enumerate(_thermo.LOG_KEYS)}
        entry["step"] = log.steps
        self.log = entry if self.log is None else {
            k: np.concatenate([self.log[k], entry[k]]) for k in entry}

    # ------------------------------------------------------------------
    # the particle-order route (packed neighbor list)
    # ------------------------------------------------------------------
    def _packed_build(self):
        """The neighbor build of the particle-order route, made once per
        plan (:meth:`_make_nlist_build`), or ``None`` when nothing needs
        neighbors. A cell list sizes its capacity from the measured
        occupancy too (one readback of the positions, here and not in the
        step loop)."""
        if self._nlist_build is _UNBUILT:
            params = self._nlist_params()
            self._nlist_build = (None if params is None else
                                 self._make_nlist_build(*params))
        return self._nlist_build

    def _make_nlist_build(self, r_cut, rc_matrix, method, NN):
        """A :class:`..ops.cell_list.CellNlist`, a
        :class:`..ops.nlist.DenseNlist` or (``'direct'``) a
        :class:`..ops.direct.DirectPlanes`, picked as the JAX package's
        ``_make_nlist_builder`` picks: ``build(pos4, box_lengths) ->
        (nlist [N, NN, 4] or planes, overflow or None)``, with ``plan``
        and ``method``."""
        lengths = np.asarray(self._lengths, dtype=np.float64)
        n = self.state.n_particles
        tilted = any(self._tilt)
        if tilted and (method in ("cell", "pallas", "direct") or
                       isinstance(method, _cl.CellList)):
            raise NotImplementedError(
                "tilted (triclinic) boxes support nlist='cellwise' "
                "(slot-resident, the fast path) and 'n2'; the packed "
                f"cell-list tier ({method!r}) is orthorhombic-only")
        if self._changes_box() and method != "n2":
            if method != "auto":
                raise ValueError(
                    "Static-geometry neighbor modes (cell/direct) plan "
                    "their grid from the initial box; box-changing "
                    "integrators (NPT) need attach(nlist='n2')")
            method = "n2"  # auto: the dense build reads the live box
        config = method if isinstance(method, _cl.CellList) else \
            _cl.CellList()
        if method == "direct":
            # the wide-direct mode: the model takes the masked 27-cell
            # candidate planes (ops/direct.py), with no selection
            grid, capacity = _cl.plan(n, lengths, r_cut, config)
            if grid is None:
                raise ValueError(f"Box {lengths} too small for the direct "
                                 f"mode at r_cut={r_cut}")
            if config.capacity is None:
                occ = _cl.max_occupancy(self.state.positions, lengths, grid)
                capacity = max(capacity, int(np.ceil(occ * 1.3)) + 1)
            capacity = max(capacity, getattr(self, "_cl_capacity_floor", 0))
            return DirectPlanes(grid, capacity, r_cut, self.device,
                                rc_matrix, self.state.positions.dtype)
        want_cell = isinstance(method, _cl.CellList) or \
            method in ("cell", "pallas")
        sel = "pallas" if method == "pallas" else "sort"
        if method == "auto":
            want_cell = (n >= 512 and not tilted and
                         config.usable(lengths, r_cut))
            # on the card the cell list selects with kernel K3, as the
            # JAX package picks its Pallas kernel on a TPU
            if want_cell and self.device.type == "cuda":
                sel = "pallas"
        if sel == "pallas" and rc_matrix is not None:
            sel = "sort"  # typed cutoffs are not in kernel K3
        if want_cell:
            grid, capacity = _cl.plan(n, lengths, r_cut, config)
            if grid is None:
                raise ValueError(f"Box {lengths} too small for a cell list "
                                 f"at r_cut={r_cut}")
            if config.capacity is None:
                # statistical headroom can lose to structured starts (an
                # aligned lattice packs one cell); size from measured
                # occupancy too
                occ = _cl.max_occupancy(self.state.positions, lengths, grid)
                capacity = max(capacity, int(np.ceil(occ * 1.3)) + 1)
            # the overflow self-heal floor beats even an explicit capacity
            capacity = max(capacity, getattr(self, "_cl_capacity_floor", 0))
            return _cl.CellNlist(grid, capacity, lengths, r_cut, NN, sel,
                                 self.device, rc_matrix,
                                 self.state.positions.dtype)
        return DenseNlist(r_cut, NN, self.device, rc_matrix,
                          self.state.positions.dtype)

    def _build_nlist(self, state):
        """One neighbor build on ``state`` (the host accessors')."""
        if self._use_cellwise():
            # the masked planes, in slot order; a mapped model's in
            # particle order, as it sees them
            layout = self._ensure_layout()
            st, aux = layout.pack(state)
            with torch.no_grad():
                planes = layout.planes(st, aux)
            if self.tfc is not None and self.tfc.map_enabled:
                inv = _inv_slots(layout, aux)
                planes = planes.map(lambda c: c[inv])
            return planes
        build = self._packed_build()
        if build is None:
            return torch.zeros((state.n_particles, 1, 4),
                               dtype=state.positions.dtype,
                               device=self.device)
        with torch.no_grad():
            return build(state.positions4, self._build_box(state))[0]

    def _build_box(self, state):
        """What a packed neighbor build reads of the box: its lengths, or
        the full box when tilted (the dense build's triclinic minimum
        image)."""
        return state.box if state.tilted else box_size(state.box)

    def _model_chunks(self, st, nlist, labels=None):
        """The model's inputs ``[nlist, positions4, box]`` (and labels),
        whole or, with ``batch_size``, as zero-padded particle chunks (the
        JAX package's ``_chunk_inputs``, the reference's
        ``TensorflowCompute.cc:141-212`` batching)."""
        k = self.tfc.batch_size
        pos4 = st.positions4
        if not k:
            return [(nlist, pos4, labels)]
        n = st.n_particles
        pad = -(-n // k) * k - n
        nl = torch.nn.functional.pad(nlist, (0, 0, 0, 0, 0, pad))
        pos4 = torch.nn.functional.pad(pos4, (0, 0, 0, pad))
        lab = (None if labels is None else
               torch.nn.functional.pad(labels, (0, 0, 0, pad)))
        return [(nl[a:a + k], pos4[a:a + k],
                 None if lab is None else lab[a:a + k])
                for a in range(0, n + pad, k)]

    def _eval_model(self, st, nlist):
        """One model evaluation (the JAX ``eval_model``, chunked with
        ``batch_size``): ``(forces4, virial)``, padded to every particle;
        its outputs past ``output_offset`` go to the driver's capture."""
        tfc = self.tfc
        model = tfc.model
        n = st.n_particles
        dtype = st.positions.dtype
        fs, ws, extras = [], [], []
        for nl, pos4, _ in self._model_chunks(st, nlist):
            out = model([nl, pos4, st.box], training=False)
            extras.append(out[tfc.output_offset:])
            rows = pos4.shape[0]
            f = torch.zeros((rows, 4), dtype=dtype, device=self.device)
            w = torch.zeros((rows, 3, 3), dtype=dtype, device=self.device)
            if model.output_forces:
                f = out[0].detach()
                if f.shape[-1] == 3:
                    f = torch.cat([f, torch.zeros_like(f[:, :1])], dim=-1)
                f = torch.nn.functional.pad(f, (0, 0, 0, rows - f.shape[0]))
                if model.virial and len(out) > 1:
                    w = out[1].detach()
                    w = torch.nn.functional.pad(
                        w, (0, 0, 0, 0, 0, rows - w.shape[0]))
            fs.append(f)
            ws.append(w)
        tfc.capture(*extras)
        return torch.cat(fs)[:n], torch.cat(ws)[:n]

    def _packed_train(self, st, nlist, labels, i, tr):
        """One online training step on the packed list (the JAX
        ``train_update``, per particle chunk with ``batch_size``): per
        chunk the model with ``training=True``, the loss against the
        labels, one optimizer step and the constraints; the step's loss
        is the chunks' mean."""
        tfc = self.tfc
        model = tfc.model
        losses, extras = [], []
        for nl, pos4, lab in self._model_chunks(st, nlist, labels):
            with torch.enable_grad():
                out = model([nl, pos4, st.box], training=True)
                loss = model.compute_loss(out, lab)
            tr.opt.zero_grad()
            loss.backward()
            tr.opt.step()
            model.apply_constraints(tr.params)
            losses.append(loss.detach())
            extras.append(out[tfc.output_offset:])
        self.train_steps += 1
        tr.losses[i] = torch.stack(losses).mean()
        tr.trained.append(i)
        tfc.capture(*extras)

    def _packed_step(self, st, flags, build, needs_virial, i, carry, tr,
                     log=None, rows=None):
        integ, dt = self.integrator, self.dt
        st = integ.pre_force(st, dt)
        n = st.n_particles
        tfc = self.tfc
        map_i = None if rows is None else tfc.model._map_i
        if map_i is not None:
            # the CG beads follow the atoms before the neighbor build
            st = tfc.apply_mapping(st)
        if build is not None:
            nlist, cell_overflow = build(st.positions4, self._build_box(st))
            self.nlist_builds += 1
        else:
            nlist = torch.zeros((n, 1, 4), dtype=st.positions.dtype,
                                device=self.device)
            cell_overflow = None
        # the model runs every `period` steps (st.step is a host int);
        # between, its last forces stand, as in the JAX package
        model_now = tfc is not None and st.step % tfc.period == 0
        if tfc is not None and not tfc.train:
            if model_now:
                carry[:] = self._eval_model(st, nlist)
            f, w = carry
        else:
            f = torch.zeros((n, 4), dtype=st.positions.dtype,
                            device=self.device)
            w = torch.zeros((n, 3, 3), dtype=st.positions.dtype,
                            device=self.device)
        for force in self.forces:
            fi, wi = force(st, nlist)
            f, w = f + fi, w + wi
        if tr is not None and model_now:
            labels = f
            subset = tfc.reference_forces
            if subset and len(subset) != len(self.forces):
                labels = sum(g(st, nlist)[0] for g in subset)
            self._packed_train(st, nlist, labels, i, tr)
        # the beads are virtual: no net force (the reference integrates
        # the atom group only)
        st.forces = _mask_beads(f, rows, map_i)
        if needs_virial:
            st.virial = w
        st = integ.post_force(st, dt)
        if log is not None and log.due(st.step):
            log.record(st)
        st.step += 1
        if cell_overflow is not None:
            flags = flags | cell_overflow.to(torch.int32)
        return st, flags

    def _run_packed(self, n, allow_retry, log_period=None):
        """One attempt at :meth:`run` on the particle-order route; returns
        False to ask for a retry after a capacity-overflow rollback (which
        also rolls back every model variable and, under training, the
        optimizer's state). Flags: bit 0 cell overflow, bit 2 the model's
        full-list flag."""
        tfc = self.tfc
        model = tfc.model if tfc is not None else None
        build = self._packed_build()
        log = (None if log_period is None else
               _Log(log_period, self.state.step, n, self.state.positions))
        needs_virial = bool(self.forces or log is not None or
                            getattr(self.integrator, "needs_virial", False) or
                            (model is not None and model.virial))
        check = model is not None and model.check_nlist
        for force in self.forces:
            force.prepare(self.state.positions)
        tr = snap = None
        if tfc is not None:
            if tfc.train:
                if not self.forces:
                    raise ValueError(
                        "online training needs label forces: add a "
                        "built-in force first (sim.add_force(md."
                        "LennardJones(...)))")
                tr = _TrainState(self)
                tr.begin(n)
            # what a rollback restores: every model variable and, under
            # training, the optimizer's state
            snap = StateSnapshot(model, None if tr is None else tr.opt)
            tfc.begin_outputs()
        carry = list(tfc.model_forces(self.state)) if tfc is not None \
            else None
        # a mapped run's particle index of each row, for the bead mask
        rows = (torch.arange(self.state.n_particles, device=self.device)
                if tfc is not None and tfc.map_enabled else None)
        st = dataclasses.replace(self.state)
        start_step = st.step
        flags = torch.zeros((), dtype=torch.int32, device=self.device)
        with _sync_guard(self.check_syncs), torch.no_grad():
            for i in range(n):
                st, flags = self._packed_step(st, flags, build, needs_virial,
                                              i, carry, tr, log, rows)
            if check:
                flags = flags | (model.nlist_overflow.to(torch.int32) << 2)
        # the one readback: flags, the barostat's final box (known on the
        # host for the next run), the losses and the log records
        head, box_now, losses, log_vals = _readback(
            [flags.to(torch.int32).reshape(1)],
            st.box if self._changes_box() else None,
            None if tr is None else tr.losses,
            None if log is None else log.buf)
        flags_now = int(head[0])
        overflow = bool(flags_now & 1)
        if overflow and snap is not None:
            snap.restore()
        if overflow and allow_retry and self.auto_replan and \
                build is not None and build.plan is not None:
            # roll back (self.state still holds the attempt's start) and
            # re-plan with a larger capacity floor, as HOOMD's cell list
            # resizes itself
            cap = build.plan[1]
            self._cl_capacity_floor = max(
                getattr(self, "_cl_capacity_floor", 0),
                int(np.ceil(cap * 1.3)) + 1)
            self._nlist_build = _UNBUILT
            warnings.warn(
                f"cell capacity {cap} exceeded; rebuilding the neighbor "
                f"plan with capacity >= {self._cl_capacity_floor} and "
                f"re-running these {n} steps from their start")
            return False
        st.step = start_step + n
        self.state = st
        if box_now is not None:
            self._note_box(st.box, box_now.astype(np.float64).reshape(3, 3))
        self._packed = None
        self._vmax_cache = None
        if overflow:
            raise ValueError(
                "Cell capacity exceeded during the run (a cell held more "
                "particles than planned). Increase CellList(capacity=) or "
                "attach with nlist='n2'.")
        if tfc is not None:
            if not tfc.train:
                tfc.keep_model_forces(*carry)
            if tr is not None:
                tfc.loss_history.extend(losses[tr.trained].tolist())
            tfc.commit_outputs()
        self._commit_log(log, log_vals)
        if flags_now & 4:
            tfc.check_overflow(full=True)
        return True


def _is_cellwise(method):
    return method == "cellwise" or isinstance(method, _cw.Cellwise)


def _inv_slots(layout, aux):
    """``[n]``: the slot row of each particle, the inverse of
    ``aux['orig']``. Kept in ``aux['inv']`` once made, so a step makes it
    once; a repack permutes the slots and its new ``aux`` has none."""
    inv = aux.get("inv")
    if inv is None:
        slots = torch.arange(layout.plan.n_slots, dtype=torch.long,
                             device=aux["orig"].device)
        inv = aux["inv"] = layout.to_particles(slots, aux)
    return inv


def _pad_rows(t, n):
    """``t`` zero-padded along its rows to ``n``."""
    pad = [0, 0] * (t.ndim - 1) + [0, n - t.shape[0]]
    return torch.nn.functional.pad(t, pad)


def _mask_beads(forces4, orig, map_i):
    """``forces4`` with the rows whose particle index ``orig`` is a CG
    bead's (``>= map_i``) zeroed (``orig``: ``aux['orig']`` in slot
    order, an ``arange`` on the packed routes); ``forces4`` itself when
    nothing is mapped (``map_i`` None)."""
    if map_i is None or forces4 is None:
        return forces4
    return forces4 * (orig < map_i).to(forces4.dtype)[:, None]


def _readback(ints, *floats):
    """One device->host copy of the int32 scalars ``ints`` and the float
    tensors ``floats`` (bitcast into int32 lanes: one per float32 value,
    two per float64 value; ``None`` entries skipped). Returns the ints as
    a numpy int32 array, then each float tensor as a flat numpy array of
    its own dtype, float32 or float64, bit for bit (``None`` where it was
    ``None``)."""
    parts = list(ints)
    for t in floats:
        if t is not None:
            parts.append(t.contiguous().reshape(-1).view(torch.int32))
    packed = torch.cat(parts).cpu().numpy()
    k = sum(int(t.numel()) for t in ints)
    out = [packed[:k]]
    for t in floats:
        if t is None:
            out.append(None)
            continue
        wide = t.dtype == torch.float64
        m = int(t.numel()) * (2 if wide else 1)
        out.append(packed[k:k + m].view(np.float64 if wide else np.float32))
        k += m
    return out


class _Log:
    """The thermodynamic records of one run attempt (``run(n,
    log_period=)``): a ``[rows, 4]`` device buffer of the state's dtype
    (``like``'s: float32, or float64 as the JAX package's log of a float64
    state), one row per step whose number is a multiple of ``period``,
    written in the step loop (the row and the step are host ints) and read
    back with the run's one readback."""

    def __init__(self, period, start, n, like):
        self.period = int(period)
        steps = np.arange(start, start + n)
        self.steps = steps[steps % self.period == 0]
        self.buf = torch.zeros((len(self.steps), len(_thermo.LOG_KEYS)),
                               dtype=like.dtype, device=like.device)
        self.row = 0

    def due(self, step):
        return step % self.period == 0

    def record(self, st, valid=None):
        self.buf[self.row] = _thermo.log_row(st, valid)
        self.row += 1


@contextlib.contextmanager
def _engine_calls(model):
    """The engine's model calls (the JAX package's traced calls): the
    eager-only "box is skewed" guard of a SimModel is off."""
    if model is None:
        yield
        return
    prev = model.__dict__.get("_in_engine", False)
    model._in_engine = True
    try:
        yield
    finally:
        model._in_engine = prev


class _Route:
    """What the step loop of one run() evaluates (see
    :meth:`Simulation._route`)."""
    repack_each_step = False
    model_fn = None
    model_form = None
    with_types = False
    min_r2 = 1e-4
    planes = False
    #: the model's evaluation period outside training (1: every step)
    model_period = 1
    #: a period > 1 run carries the model's virial too
    carry_virial = False
    trainer = None
    label_subset = None
    #: the atom rows of a mapped attachment (None: nothing is mapped)
    map_i = None
    virial_in_loop = False
    needs_virial = False


class _Bound(torch.nn.Module):
    """``fn`` (a function reading ``model``'s weights) as a module whose
    ``model`` is its child, so that ``torch.func.functional_call`` can
    run it under given weights."""

    def __init__(self, model, fn):
        super().__init__()
        self.m = model
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _module_pair_apply(model, fn):
    """``pair_apply(p, r2[, ti, tj])``: the pair function ``fn`` of
    ``model`` with its weights named in ``p`` replaced by ``p``'s tensors
    (the explicit-parameter form :func:`..ops.pair_train.pair_train_forces`
    differentiates)."""
    holder = _Bound(model, fn)

    def pair_apply(p, *args):
        return torch.func.functional_call(
            holder, {"m." + k: v for k, v in p.items()}, args)

    return pair_apply


class _TrainState:
    """What every training route keeps: the model's optimizer and
    trainable weights and the run's loss buffer (a rolled-back run
    restores the optimizer with the model's variables,
    :class:`..models.module.StateSnapshot`). The particle-order route
    trains with it alone (its steps are
    :meth:`Simulation._packed_train`)."""

    def __init__(self, sim):
        tfc = sim.tfc
        self.sim, self.model, self.tfc = sim, tfc.model, tfc
        self.opt = tfc.ensure_opt_state()
        self.params = [tfc.model.variables[i] for i in tfc.trainable_idx]
        self.losses = None

    def begin(self, n):
        """A device buffer for the run's ``n`` losses, of the state's
        dtype (the JAX package keeps the losses at their own dtype), and
        the list of the steps that trained."""
        self.losses = torch.zeros((n,), dtype=self.sim.state.positions.dtype,
                                  device=self.sim.device)
        self.trained = []


class _Trainer(_TrainState):
    """Online training on the cellwise mode (the JAX ``train_fast_update``
    and ``train_update``), one branch per model kind:

    - ``'proxy'``: a Chebyshev-proxy PairModel, fitted at its nodes per
      step, forces through :func:`..ops.pair_train.pair_train_forces`
      (K1's proxy form forward, K2 backward on CUDA);
    - ``'pair'``: a PairModel without a proxy, its
      ``pair_energy_and_slope`` under the current weights;
    - ``'lane'``: a generic SimModel the lane-separability probe
      validated (one output), its synthesized pair function, kept
      differentiable in the weights;
    - ``'planes'``: any other SimModel, by autograd through the model on
      the masked planes.

    ``'pair'`` and ``'lane'`` train through
    :func:`..ops.pair_train.pair_train_forces`, which runs K1's generic
    form with the backward kernel ``generic_reduce_bwd`` on CUDA; on the
    CPU it takes the lane contraction, the oracle, or with
    ``stencil='kernel'`` the list route's plain versions. Per training
    step: the loss against the labels, one optimizer step, the weights'
    constraints, all on the device."""

    def __init__(self, sim, layout, st, aux):
        super().__init__(sim)
        tfc, model = self.tfc, self.model
        self.cols = 4
        self.typed, self.min_r2 = True, 1e-4
        if isinstance(model, PairModel):
            self.kind = "proxy" if model.proxy_degree else "pair"
            self.typed, self.min_r2 = model.pair_with_types, model.min_r2
        elif sim._probe_lane_fast(layout, st, aux) and \
                tfc._lane_fast_report.get("n_outputs") == 1:
            self.kind = "lane"
            self.cols = min(int(tfc._lane_fast_report["cols"]), 4)
        else:
            self.kind = "planes"
        # the energy channel: when the loss reads the prediction's column
        # 3, or a saved output is the prediction itself
        self.energy = self.cols == 4 and (
            tfc.train_energy() or bool(tfc.save_output_period and
                                       tfc.output_offset == 0))
        if self.kind == "proxy":
            self.fit, self.evaluate = model.proxy_parts(layout.plan.r_cut,
                                                        sim.device)
        elif self.kind != "planes":
            from ..ops.lane_fast import synthesize_pair_fn
            self.pair_fn = (model.pair_energy_and_slope
                            if self.kind == "pair" else
                            synthesize_pair_fn(model, st.box,
                                               differentiable=True))
            self.named = {k: v for k, v in model.named_parameters()
                          if v.requires_grad}
            self.pair_apply = _module_pair_apply(model, self.pair_fn)
            # the list route's plain versions on the CPU with
            # stencil='kernel'; else pair_train_forces' own choice
            self.bwd_impl = ("list" if sim.device.type == "cpu" and
                             sim.stencil == "kernel" else "auto")

    def forces(self, st, aux, layout):
        """The analytic branches' ``forces4``, differentiable in the
        weights."""
        from ..ops.pair_train import pair_train_forces
        model, sim = self.model, self.sim
        kw = dict(min_r2=self.min_r2, rcut_matrix=layout.rc2_tab,
                  needs_energy=self.energy, geometry=layout.geom(st))
        args = (st.positions, st.types, aux["valid"], layout.plan,
                layout.lo)
        if self.kind == "proxy":
            return pair_train_forces(
                self.fit(model.pair_energy), self.evaluate, *args,
                with_types=self.typed, fwd_stencil=sim.stencil, **kw)
        return pair_train_forces(self.named, self.pair_apply, *args,
                                 with_types=self.typed,
                                 fwd_stencil=sim.stencil,
                                 bwd_impl=self.bwd_impl, lanes=sim._lanes,
                                 **kw)

    def step(self, st, aux, layout, labels, i):
        model, sim, tfc = self.model, self.sim, self.tfc
        with torch.enable_grad():
            if self.kind == "planes":
                out = model([layout.planes(st, aux), st.positions4, st.box],
                            training=True)
                loss = model.compute_loss(out, labels)
                extras = out[tfc.output_offset:]
            else:
                pred = self.forces(st, aux, layout)[:, :self.cols]
                loss = model.compute_loss([pred], labels)
                extras = (pred,) if tfc.output_offset == 0 else ()
                sim.force_evals += 1
        sim.train_steps += 1
        self.opt.zero_grad()
        loss.backward()
        self.opt.step()
        model.apply_constraints(self.params)
        self.losses[i] = loss.detach()
        self.trained.append(i)
        tfc.capture(extras)


def _loss_consumes_energy(model):
    """Does ``model.compute_loss`` read prediction column 3 (the
    per-particle energy)? Probed by the loss gradient with respect to the
    prediction at two random points on tiny arrays: the force-matching
    losses slice ``[:, :3]`` and probe identically zero, and training
    then drops the energy lanes in K1 and K2. Any probe failure keeps the
    energy on."""
    try:
        for seed in (0, 1):
            rng = np.random.RandomState(seed)
            y = torch.tensor(rng.randn(8, 4).astype(np.float32),
                             dtype=model.dtype, requires_grad=True)
            lab = torch.tensor(rng.randn(8, 4).astype(np.float32),
                               dtype=model.dtype)
            with torch.enable_grad():
                g, = torch.autograd.grad(
                    torch.as_tensor(model.compute_loss([y], lab)).sum(), y,
                    allow_unused=True)
            if g is not None and bool((g[:, 3] != 0).any()):
                return True
        return False
    except Exception:
        return True
