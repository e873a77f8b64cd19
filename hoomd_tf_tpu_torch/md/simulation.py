"""Simulation: the MD engine (PyTorch port of the main-path subset of
``hoomd_tf_tpu/md/simulation.py``).

The ported path is the pair fast route of the cellwise mode. Pair forces
come from :func:`..ops.cellwise.analytic_pair_forces` -- kernel K1 on a
CUDA device, the full-stencil tensor form on the CPU (as the JAX package
runs the XLA form off the TPU) -- for the built-in forces
(``add_force``: ``md.LennardJones``, ``md.WCA``) and for an attached
:class:`..models.pair.PairModel`. The state lives in cell-slot order
during ``run()``; the slot assignment is rebuilt unconditionally every K
steps (the static repack schedule), and the Verlet criterion still runs
every step as a staleness bit.

Online training (``tfcompute.attach(train=True)``): one built-in
evaluation per step serves as both the labels and the driving forces
(the trained model does not drive the dynamics); the model's Chebyshev
proxy is fitted at its nodes, its forces come from
:func:`..ops.pair_train.pair_train_forces` (K1's proxy form forward,
kernel K2 backward on CUDA) and the optimizer steps in place. A run that
is rolled back (capacity overflow, staleness) rolls the model's weights
and the optimizer's state back with it.

Host syncs: ``run()`` reads the device back exactly once, after the
step loop, in one packed copy (:meth:`Simulation._fetch_run_scalars`):
the overflow and staleness bits, the running max cell occupancy, the
running max speed and the per-step training losses stay device tensors
until then. With ``check_syncs = True`` the step loop runs under
``torch.cuda.set_sync_debug_mode("error")``, so any hidden sync raises.

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
from ..ops import cellwise as _cw
from ..ops.box import check_orthorhombic

__all__ = ["Simulation"]


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
        #: loop steps and refreshes): on CUDA, each one launches K1
        self.force_evals = 0
        #: training updates made so far: on CUDA, each one launches K2
        self.train_steps = 0
        self.state = None
        self.tfc = None
        #: built-in force computes (``add_force``)
        self.forces = []
        self._layout = None
        self._packed = None
        self._form = None
        self._vmax_cache = None
        self._replan_check_step = -1

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------
    def init_lattice(self, n, density=None, a=None, kind="sc", types=None,
                     kT_init=None, masses=None):
        """Place ``n`` particles on a lattice in a centered cubic box."""
        pos, lengths = lattice_positions(n, density=density, a=a, kind=kind)
        return self.set_state(init_state(
            pos, lengths, types=types, masses=masses, kT_init=kT_init,
            generator=self.generator, device=self.device))

    def init_state(self, positions, box, **kwargs):
        kwargs.setdefault("generator", self.generator)
        return self.set_state(init_state(positions, box, device=self.device,
                                         **kwargs))

    def set_state(self, state):
        """Adopt ``state`` (its tensors must be on :attr:`device`)."""
        if state.positions.device != self.device:
            raise ValueError(f"state is on {state.positions.device}, the "
                             f"simulation on {self.device}")
        box = state.box.detach().cpu().numpy().astype(np.float64)
        check_orthorhombic(box[2])
        self._lengths, self._lo = box[1] - box[0], box[0]
        fresh = self.integrator.init(state)
        if set(state.thermostat or {}) != set(fresh):
            state.thermostat = fresh
        self.state = state
        self._layout = None
        self._packed = None
        self._vmax_cache = None
        return state

    @property
    def integrator(self):
        return self._integrator

    @integrator.setter
    def integrator(self, integ):
        """Swap integrators (e.g. a Minimize quench before NVT): keys both
        thermostats share carry over, the others are initialized."""
        self._integrator = integ
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
        return force

    def thermo(self):
        """Current thermodynamic quantities (dict of host floats)."""
        return {k: float(v) for k, v in _thermo.thermo(self.state).items()}

    def replan(self):
        """Re-derive the cellwise plan from the current state at the next
        ``run()`` (capacity and grid from measured occupancy)."""
        self._layout = None
        self._packed = None
        self._static_K_cap = None
        self._static_K_last = None
        self._replan_check_step = (self.state.step if self.state is not None
                                   else -1)

    # ------------------------------------------------------------------
    # planning
    # ------------------------------------------------------------------
    def _nlist_params(self):
        """``(r_cut, rc_matrix, method)`` of the neighbor build: from the
        attached driver, or with none from the built-in forces' own
        cutoffs (the cellwise mode, when the box holds 3 cells per axis);
        ``None`` when nothing needs neighbors."""
        tfc = self.tfc
        if tfc is not None:
            return tfc.r_cut, tfc.r_cut_matrix, tfc.nlist_method
        r = max((float(getattr(f, "r_cut", 0.0) or 0.0)
                 for f in self.forces), default=0.0)
        if r <= 0.0:
            return None
        if not np.all(np.asarray(self._lengths) // r >= 3):
            raise NotImplementedError(
                f"built-in forces alone in a box {self._lengths} of fewer "
                f"than 3 cells of r_cut={r} per axis need the dense "
                "neighbor list, which is not ported yet")
        return r, None, "cellwise"

    def _model_has_form(self):
        model = self.tfc.model
        return bool(model.proxy_degree) or \
            model.pair_kernel_form() is not None

    def _kernel_eligible(self):
        """Will kernel K1 be the hot loop? (The planner then costs the
        14-block candidate width, like ``_pallas_eligible`` on a TPU; on
        the card every lane pass of a train step is a 14-wide kernel
        too.)"""
        if self.stencil == "kernel":
            return True
        if self.stencil != "auto" or self.device.type != "cuda":
            return False
        return self.tfc is None or self.tfc.train or self._model_has_form()

    def _model_lane_cost_scale(self):
        """Relative per-lane cost of the model's pair evaluation against
        the LJ form the planner's lane cost stands for. For a proxy this
        is an operation count, not a measurement: two Clenshaw series of
        ~3 operations per term against LJ's ~10 inside the cut, times 3
        in training (the labels, the proxy primal and K2's moment pass),
        the shape of the JAX package's ``_model_lane_cost_scale``."""
        tfc = self.tfc
        if tfc is None or not tfc.model.proxy_degree:
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
        r_cut, _, method = self._nlist_params()
        config = method if isinstance(method, _cw.Cellwise) else None
        occ_observed = None
        hist = getattr(self, "_occ_hist", [])
        if hist:
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
            lane_cost_scale=self._model_lane_cost_scale())
        floor = getattr(self, "_capacity_floor", 0)
        if plan is not None and plan.capacity < floor:
            plan = dataclasses.replace(plan, capacity=floor)
        return plan

    def _ensure_layout(self):
        if self._layout is not None:
            return self._layout
        r_cut, rc_matrix, _ = self._nlist_params()
        plan = self._plan_from_current()
        if plan is None:
            raise ValueError(
                f"Box {self._lengths} too small for the cellwise mode at "
                f"r_cut={r_cut} (needs >= 3 cells per axis)")
        layout = SlotLayout(plan, self.state.n_particles, self._lo,
                            rc_matrix=rc_matrix,
                            dtype=self.state.positions.dtype,
                            device=self.device)
        # every device constant the step loop reads is made here, so the
        # loop never copies from the host
        layout.geometry.offsets(_cw._HALF_OFFS)
        layout.geometry.offsets(_cw._OFFS)
        self._builtin_forms = []
        for f in self.forces:
            form = f.kernel_form()
            form.tensor(self.device)
            self._builtin_forms.append(form)
        form = None
        if self.tfc is not None and not self.tfc.model.proxy_degree:
            form = self.tfc.model.pair_kernel_form()
            if form is not None:
                form = form.kernel_form()
                form.tensor(self.device)
        self._form = form
        self._layout = layout
        return layout

    def _max_occupancy_now(self, layout):
        cell = _cw.bin_cells(self.state.positions, layout.lo, layout.plan,
                             layout.geometry)
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
        factor, on the ``_K_GRID``; staleness self-heals by lowering K."""
        skin = float(layout.plan.skin)
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
            geometry=layout.geometry)

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

    def _forces(self, st, aux, layout, route, needs_energy, want_virial):
        """The forces that drive the dynamics: the built-ins plus, outside
        training, the attached model."""
        f, w = self._builtins(st, aux, layout, needs_energy, want_virial)
        if route.model_fn is not None:
            m = self.tfc.model
            fm, wm = self._pair_eval(
                st, aux, layout, route.model_fn, route.model_form,
                needs_energy, bool(want_virial and m.virial),
                m.pair_with_types, m.min_r2)
            f = fm if f is None else f + fm
            if wm is not None:
                w = wm if w is None else w + wm
        return f, w

    def _route(self, layout):
        """What one run() evaluates: the model's pair function and kernel
        form (a proxy is fitted once per run: its weights do not change
        outside training), or the trainer; and the virial flags."""
        tfc = self.tfc
        model = tfc.model if tfc is not None else None
        r = _Route()
        r.virial_in_loop = bool((model is not None and model.virial) or
                                getattr(self.integrator, "needs_virial",
                                        False))
        r.needs_virial = r.virial_in_loop or bool(self.forces)
        if model is None:
            return r
        if tfc.train:
            if not self.forces:
                raise ValueError(
                    "online training needs label forces: add a built-in "
                    "force first (sim.add_force(md.LennardJones(...)))")
            r.trainer = _Trainer(self, layout)
            subset = tfc.reference_forces
            if subset and len(subset) != len(self.forces):
                r.label_subset = list(subset)
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
        return r

    def _step(self, st, aux, flags, layout, route, i):
        """One MD step on slot state (slim: no energy column, and no
        virial unless something in the loop reads it)."""
        integ, dt = self.integrator, self.dt
        st = integ.pre_force(st, dt)
        # ghost pins stay unconditional, as in the JAX engine
        st = layout.ghost_pin(st, aux)
        stale = layout.needs_rebuild(st, aux)
        tr = route.trainer
        if tr is not None:
            # one built-in evaluation: the labels and the driving forces
            f4, w = self._builtins(st, aux, layout, tr.energy,
                                   route.virial_in_loop)
            labels = f4
            if route.label_subset is not None:
                labels, _ = self._builtins(st, aux, layout, tr.energy,
                                           False, route.label_subset)
            tr.step(st, aux, layout, labels, i)
        else:
            f4, w = self._forces(st, aux, layout, route, False,
                                 route.virial_in_loop)
        st.forces = f4
        if route.virial_in_loop and w is not None:
            st.virial = w
        st = integ.post_force(st, dt)
        st = layout.ghost_pin(st, aux)
        st.step += 1
        return st, flags | (stale.to(torch.int32) << 1)

    def _fetch_run_scalars(self, flags, aux, losses=None):
        """The one packed device->host readback of a run(): flags, running
        max occupancy, running max speed and the per-step training losses
        (the floats bitcast into the int lanes)."""
        parts = [flags.to(torch.int32).reshape(1),
                 aux["occ_max"].to(torch.int32).reshape(1),
                 aux["vmax"].to(torch.float32).reshape(1).view(torch.int32)]
        if losses is not None:
            parts.append(losses.to(torch.float32).view(torch.int32))
        packed = torch.cat(parts).cpu().numpy()
        return (int(packed[0]), int(packed[1]),
                float(packed[2:3].view(np.float32)[0]),
                packed[3:].view(np.float32))

    # ------------------------------------------------------------------
    def run(self, n):
        """Advance the simulation ``n`` steps.

        Self-healing: a capacity overflow rolls the segment back (nothing
        of the attempt is committed: state, model weights and optimizer
        state) and replans with a raised capacity floor; a staleness bit
        (a particle outran skin/2 between two scheduled repacks) rolls
        back and shortens the repack interval.
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
        for attempt in range(5):
            if self._run_once(n, allow_retry=attempt < 4):
                return

    def _run_once(self, n, allow_retry):
        layout = self._maybe_auto_replan(self._ensure_layout())
        if getattr(self, "_static_K_integ", None) != id(self.integrator):
            # a new integrator's regime must not inherit the old interval
            self._static_K_last = None
            self._vmax_hist = []
            self._static_K_integ = id(self.integrator)
        K = self._choose_repack_interval(layout)
        route = self._route(layout)
        tr = route.trainer
        snap = None
        if tr is not None:
            # the optimizer updates the weights in place: keep what a
            # rollback restores, and a device buffer for the losses
            snap = tr.snapshot()
            tr.losses = torch.zeros((n,), dtype=torch.float32,
                                    device=self.device)

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
        start_step = self.state.step
        flags = torch.zeros((), dtype=torch.int32, device=self.device)
        with _sync_guard(self.check_syncs):
            done = 0
            while done < n:
                st, aux = layout.rebuild(st, aux)
                for _ in range(min(K, n - done)):
                    st, flags = self._step(st, aux, flags, layout, route,
                                           done)
                    done += 1
            flags = flags | aux["overflow"].to(torch.int32)
            # one full evaluation at the final positions: the slim loop
            # skipped the energy column (and the virial when unused)
            f4, w = self._forces(st, aux, layout, route, True,
                                 route.needs_virial)
            st.forces = f4
            if route.needs_virial and w is not None:
                st.virial = w
        flags_now, occ_now, vmax_now, losses = self._fetch_run_scalars(
            flags, aux, None if tr is None else tr.losses)
        overflow, stale = bool(flags_now & 1), bool(flags_now & 2)
        if (overflow or stale) and tr is not None:
            # a failed attempt commits no training, retried or not (the
            # JAX package commits model values only after a clean run)
            tr.restore(snap)
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
        if not overflow and not stale and \
                getattr(self, "_static_K_cap", None):
            self._static_K_clean = getattr(self, "_static_K_clean", 0) + 1
            if self._static_K_clean >= 2 and n >= 200:
                self._static_K_cap = min(
                    [g for g in self._K_GRID if g > self._static_K_cap],
                    default=self._static_K_cap)
                self._static_K_clean = 0
        if not overflow and not stale:
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
        self._vmax_cache = (self.state, vmax_now)
        self._packed = (self.state, layout, (st, aux))
        if tr is not None and not overflow and not stale:
            # a failed attempt's losses belong to training it rolled back
            self.tfc.loss_history.extend(losses.tolist())
        if overflow:
            raise ValueError(
                "Cell capacity exceeded during the run (a cell held more "
                "particles than planned). Increase Cellwise(capacity=).")
        if stale:
            raise ValueError(
                f"A particle moved more than skin/2 between two scheduled "
                f"neighbor rebuilds even at repack interval {K} -- the "
                f"integration is likely diverging (dt={self.dt}).")
        return True


class _Route:
    """What the step loop of one run() evaluates (see
    :meth:`Simulation._route`)."""
    model_fn = None
    model_form = None
    trainer = None
    label_subset = None
    virial_in_loop = False
    needs_virial = False


class _Trainer:
    """Online training of a Chebyshev-proxy PairModel (the proxy branch
    of the JAX ``train_fast_update``): per MD step, one fit at the nodes,
    the proxy forces through :func:`..ops.pair_train.pair_train_forces`
    (K1's proxy form forward, K2 backward on CUDA), the loss against the
    labels and one optimizer step, all on the device."""

    def __init__(self, sim, layout):
        tfc = sim.tfc
        model = tfc.model
        self.sim, self.model = sim, model
        self.fit, self.evaluate = model.proxy_parts(layout.plan.r_cut,
                                                    sim.device)
        self.opt = tfc.ensure_opt_state()
        self.params = [model.variables[i] for i in tfc.trainable_idx]
        self.energy = tfc.train_energy()
        self.losses = None

    def snapshot(self):
        """Device copies of the weights and the optimizer's state."""
        return ([p.detach().clone() for p in self.params],
                copy.deepcopy(self.opt.state_dict()))

    def restore(self, snap):
        with torch.no_grad():
            for p, v in zip(self.params, snap[0]):
                p.copy_(v)
        self.opt.load_state_dict(copy.deepcopy(snap[1]))

    def step(self, st, aux, layout, labels, i):
        from ..ops.pair_train import pair_train_forces
        model, sim = self.model, self.sim
        with torch.enable_grad():
            coeffs = self.fit(model.pair_energy)
            f4 = pair_train_forces(
                coeffs, self.evaluate, st.positions, st.types, aux["valid"],
                layout.plan, layout.lo, min_r2=model.min_r2,
                with_types=model.pair_with_types,
                rcut_matrix=layout.rc2_tab, needs_energy=self.energy,
                fwd_stencil=sim.stencil, geometry=layout.geometry)
            loss = model.compute_loss([f4], labels)
        sim.force_evals += 1
        sim.train_steps += 1
        self.opt.zero_grad()
        loss.backward()
        self.opt.step()
        self.losses[i] = loss.detach()


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
