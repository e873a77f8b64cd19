"""Integrators: NVE velocity Verlet, Nose-Hoover NVT, NPT (Nose-Hoover
plus a Berendsen barostat), Langevin (BAOAB), Brownian and the Minimize
quench (PyTorch port of ``hoomd_tf_tpu/md/integrators.py``).

Each splits into ``pre_force`` (kick + drift with the current forces)
and ``post_force`` (kick with fresh forces). They update the given
:class:`.state.SimState` by rebinding its tensors and return it. None of
them reads a tensor back to the host, so the step loop stays free of
host syncs. The stochastic ones draw their noise with one
``torch.randn`` per step from the state's ``rng``, the simulation's
``torch.Generator`` (:func:`_normal`).
"""

import math

import torch

from ..ops.box import box_size

__all__ = ["NVE", "NVT", "Minimize", "NPT", "Langevin", "Brownian"]


def _wrap_positions(positions, box, tilted=False):
    """Wrap into the box: to fractional coordinates (the upper-triangular
    cell-matrix solve when ``tilted``), ``mod 1`` and back, operation for
    operation as the JAX form; with zero tilt that form rounds exactly as
    ``lo + L * mod((x - lo) / L, 1)``, which an orthorhombic box takes."""
    lo = box[0]
    bs = box_size(box).to(positions.dtype)
    if not tilted:
        f = torch.remainder((positions - lo) / bs, 1.0)
        return lo + bs * f
    xy, xz, yz = (box[2, i].to(positions.dtype) for i in range(3))
    r = positions - lo
    fz = r[..., 2] / bs[2]
    fy = (r[..., 1] - yz * bs[2] * fz) / bs[1]
    fx = (r[..., 0] - xy * bs[1] * fy - xz * bs[2] * fz) / bs[0]
    fx, fy, fz = (torch.remainder(f, 1.0) for f in (fx, fy, fz))
    return lo + torch.stack([bs[0] * fx + xy * bs[1] * fy + xz * bs[2] * fz,
                             bs[1] * fy + yz * bs[2] * fz,
                             bs[2] * fz], dim=-1)


def _normal(state, shape):
    """Standard normal noise of ``shape`` (``[rows, 3]``) from the state's
    generator, on its device: one draw per step, of one row per particle
    (in slot order gathered into the particles' rows, zero on ghosts)."""
    x = state.positions
    kw = dict(generator=state.rng, dtype=x.dtype, device=x.device)
    if state.noise_rows is None:
        return torch.randn(shape, **kw)
    rows, n = state.noise_rows
    z = torch.randn((n,) + tuple(shape[1:]), **kw)
    return torch.cat([z, torch.zeros_like(z[:1])])[rows]


def _kick(state, dt_half):
    return state.velocities + dt_half * state.forces[:, :3] / \
        state.masses[:, None]


def _drift(state, dt):
    return _wrap_positions(state.positions + dt * state.velocities,
                           state.box, state.tilted)


class NVE:
    """Velocity-Verlet microcanonical integrator."""

    def init(self, state):
        return {}

    def pre_force(self, state, dt):
        state.velocities = _kick(state, dt / 2)
        state.positions = _drift(state, dt)
        return state

    def post_force(self, state, dt):
        state.velocities = _kick(state, dt / 2)
        return state


class NVT:
    """Nose-Hoover thermostat (single chain, symmetric splitting).

    :param kT: target temperature.
    :param tau: thermostat coupling time.
    """

    def __init__(self, kT, tau):
        self.kT = kT
        self.tau = tau

    def init(self, state):
        return {"xi": torch.zeros((), dtype=state.positions.dtype,
                                  device=state.positions.device)}

    def _thermo_half(self, state, dt):
        dof = state.thermostat.get("dof")
        if dof is None:
            dof = 3 * state.n_particles - 3
        ke2 = torch.sum(state.masses[:, None] * state.velocities ** 2)
        t_inst = ke2 / dof
        # overflow guard: a violent start (~1e29 forces) must not latch
        # xi at inf (the system would freeze at T = 0 for good); a
        # clamped measurement keeps xi huge but finite
        t_inst = torch.where(torch.isfinite(t_inst), t_inst, 1e30)
        xi = state.thermostat["xi"]
        xi = xi + dt / 2 * (t_inst / self.kT - 1.0) / self.tau ** 2
        # recoverable xi: cap where exp() has long underflowed, then
        # unwind the overshoot geometrically once T is back near target
        xi = torch.clamp(xi, -50.0 / dt, 50.0 / dt)
        xi = torch.where((t_inst < 10.0 * self.kT) &
                         (torch.abs(xi) > 10.0 / self.tau), xi * 0.8, xi)
        state.velocities = state.velocities * torch.exp(-xi * dt / 2)
        state.thermostat = {**state.thermostat, "xi": xi}
        return state

    def pre_force(self, state, dt):
        state = self._thermo_half(state, dt)
        state.velocities = _kick(state, dt / 2)
        state.positions = _drift(state, dt)
        return state

    def post_force(self, state, dt):
        state.velocities = _kick(state, dt / 2)
        return self._thermo_half(state, dt)


class Minimize:
    """Displacement-capped steepest-descent quench: each step moves every
    particle along its force by ``min(alpha * |F|, max_disp)`` and zeroes
    the velocities.

    :param max_disp: displacement cap per step.
    :param alpha: step scale multiplying the force.
    """

    def __init__(self, max_disp=0.1, alpha=1e-3):
        self.max_disp = float(max_disp)
        self.alpha = float(alpha)

    def init(self, state):
        return {}

    def pre_force(self, state, dt):
        return state

    def post_force(self, state, dt):
        f = state.forces[:, :3]
        f = torch.where(torch.isfinite(f), f, 0.0)
        # overflow-proof norm: clamped-overlap forces reach ~1e27, whose
        # square overflows f32; scale by the max component first
        m = torch.amax(torch.abs(f), dim=-1, keepdim=True)
        dirn = f / torch.clamp_min(m, 1e-30)
        norm = torch.sqrt(torch.sum(dirn * dirn, dim=-1, keepdim=True))
        unit = dirn / torch.clamp_min(norm, 1e-30)
        step = torch.clamp_max((self.alpha * m) * norm, self.max_disp)
        state.positions = _wrap_positions(state.positions + unit * step,
                                          state.box, state.tilted)
        state.velocities = torch.zeros_like(state.velocities)
        return state


class NPT(NVT):
    """Isothermal-isobaric ensemble: the Nose-Hoover thermostat plus a
    Berendsen weak-coupling barostat, which rescales the box and the
    positions isotropically about the box center by ``mu = mu3^(1/3)``,
    ``mu3 = 1 - kappa dt / tauP (P - P_inst)`` clamped to ``[0.9, 1.1]``
    (the tilt row is kept). ``P_inst`` comes from the virial of the
    step's forces, which the engine computes every step under
    ``needs_virial``.

    Runs on ``nlist='n2'`` (the dense build reads the live box) and on
    ``'cellwise'``, where the engine keeps a dynamic-box slot layout (the
    grid and capacity stay, the geometry follows the box each step;
    :class:`.slots.SlotLayout`). The static-geometry modes raise.

    :param kT: target temperature.
    :param tau: thermostat coupling time.
    :param P: target pressure.
    :param tauP: barostat coupling time.
    :param kappa: isothermal compressibility of the weak coupling.
    """

    changes_box = True
    needs_virial = True

    def __init__(self, kT, tau, P, tauP=1.0, kappa=1.0):
        super().__init__(kT, tau)
        self.P = P
        self.tauP = tauP
        self.kappa = kappa

    def post_force(self, state, dt):
        state = super().post_force(state, dt)
        vol = torch.prod(box_size(state.box))
        ke2 = torch.sum(state.masses[:, None] * state.velocities ** 2)
        w = torch.sum(torch.diagonal(state.virial, dim1=-2, dim2=-1))
        p_inst = (ke2 + w) / (3.0 * vol)
        mu3 = 1.0 - self.kappa * dt / self.tauP * (self.P - p_inst)
        mu = torch.clamp(mu3, 0.9, 1.1) ** (1.0 / 3.0)
        box = state.box
        center = 0.5 * (box[0] + box[1])
        state.positions = center + mu * (state.positions - center)
        state.box = torch.stack([center + mu * (box[0] - center),
                                 center + mu * (box[1] - center), box[2]])
        return state


class Langevin:
    """Langevin dynamics by BAOAB splitting, the O step the exact
    Ornstein-Uhlenbeck update ``v = c1 v + c2 xi``, ``c1 = exp(-gamma
    dt)``, ``c2 = sqrt((1 - c1^2) kT / m)``.

    :param kT: temperature.
    :param gamma: friction coefficient.
    """

    #: adds noise to every row, ghost slots too (the engine re-pins them)
    stochastic = True

    def __init__(self, kT, gamma=1.0):
        self.kT = kT
        self.gamma = gamma

    def init(self, state):
        return {}

    def pre_force(self, state, dt):
        state.velocities = _kick(state, dt / 2)                  # B
        state.positions = _drift(state, dt / 2)                  # A
        c1 = math.exp(-self.gamma * dt)                          # O
        c2 = torch.sqrt((1 - c1 ** 2) * self.kT / state.masses)[:, None]
        noise = _normal(state, state.velocities.shape)
        state.velocities = c1 * state.velocities + c2 * noise
        state.positions = _drift(state, dt / 2)                  # A
        return state

    def post_force(self, state, dt):
        state.velocities = _kick(state, dt / 2)                  # B
        return state


class Brownian:
    """Overdamped (Brownian) dynamics: ``x += dt / (gamma m) F +
    sqrt(2 kT dt / (gamma m)) xi``.

    :param kT: temperature.
    :param gamma: friction coefficient.
    """

    stochastic = True

    def __init__(self, kT, gamma=1.0):
        self.kT = kT
        self.gamma = gamma

    def init(self, state):
        return {}

    def pre_force(self, state, dt):
        return state

    def post_force(self, state, dt):
        mob = dt / (self.gamma * state.masses)[:, None]
        noise = _normal(state, state.positions.shape)
        x = (state.positions + mob * state.forces[:, :3] +
             torch.sqrt(2 * self.kT * mob) * noise)
        state.positions = _wrap_positions(x, state.box, state.tilted)
        return state
