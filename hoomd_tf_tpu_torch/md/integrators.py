"""Integrators: NVE velocity Verlet, Nose-Hoover NVT and the Minimize
quench (PyTorch port of ``hoomd_tf_tpu/md/integrators.py``).

Each splits into ``pre_force`` (kick + drift with the current forces)
and ``post_force`` (kick with fresh forces). They update the given
:class:`.state.SimState` by rebinding its tensors and return it. None of
them reads a tensor back to the host, so the step loop stays free of
host syncs.
"""

import torch

from ..ops.box import box_size

__all__ = ["NVE", "NVT", "Minimize", "NPT", "Langevin", "Brownian"]


def _wrap_positions(positions, box):
    """Wrap into the orthorhombic box: ``lo + L * mod((x - lo) / L, 1)``
    (the JAX form with zero tilt, operation for operation)."""
    lo = box[0]
    bs = box_size(box).to(positions.dtype)
    f = torch.remainder((positions - lo) / bs, 1.0)
    return lo + bs * f


def _kick(state, dt_half):
    return state.velocities + dt_half * state.forces[:, :3] / \
        state.masses[:, None]


def _drift(state, dt):
    return _wrap_positions(state.positions + dt * state.velocities,
                           state.box)


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
                                          state.box)
        state.velocities = torch.zeros_like(state.velocities)
        return state


class _NotPorted:
    """An integrator of the JAX package that the port does not have yet:
    making one raises, naming the part of the port that brings it."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"md.{type(self).__name__} (with the dynamic-box slot mode "
            "for NPT) arrives with the engine's remaining features, a later "
            "slice of the PyTorch port (ROADMAP.md Queue 1 item 5)")


class NPT(_NotPorted):
    """The JAX package's MTK barostat (``hoomd_tf_tpu/md/integrators.py:
    149``); not ported."""


class Langevin(_NotPorted):
    """The JAX package's Langevin thermostat (``integrators.py:203``);
    not ported."""


class Brownian(_NotPorted):
    """The JAX package's Brownian dynamics (``integrators.py:295``); not
    ported."""
