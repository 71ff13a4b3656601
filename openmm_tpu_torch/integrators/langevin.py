"""The Langevin family: LangevinMiddle (BAOAB), the leapfrog Langevin
integrator, and Brownian (overdamped) dynamics.

Counterpart of openmm_tpu/integrators/langevin.py:
- LangevinMiddleIntegrator (after langevinMiddle.cc): the update hooks
  (the CMMotionRemover, the barostats, the Andersen thermostat), a full
  force kick, velocity constraints, half a drift, the Ornstein-Uhlenbeck
  step, half a drift, position constraints, and velocities corrected by
  the constraint correction alone (the round-5 drift fix). Its
  velocities are on step: no kinetic-energy shift.
- LangevinIntegrator (after langevin.cc): v' = vscale v + fscale f / m +
  noisescale xi / sqrt(m) with vscale = exp(-gamma dt), fscale =
  (1 - vscale) / gamma (dt in the limit gamma -> 0), noisescale =
  sqrt(kT (1 - vscale^2)); a drift by v' dt, the position constraints,
  and the velocities corrected by the constraint correction.
- BrownianIntegrator (after brownian.cc): the move (dt / gamma) f / m +
  sqrt(2 kT dt / gamma) xi / sqrt(m), the position constraints, and the
  velocity (move + correction) / dt; no kinetic-energy shift.

Massless particles neither kick nor move. The noise comes from the
Context's torch.Generator (after the hooks' draws), so it does not
reproduce the JAX package's jax.random stream.
"""
from __future__ import annotations

import torch

from .. import unit as u
from ..constants import BOLTZ
from .base import Integrator, StepDeps

_K = u.kelvin
_PER_PS = u.picosecond ** -1


class _Stochastic(Integrator):
    def __init__(self, temperature: float, frictionCoeff: float,
                 stepSize: float):
        super().__init__(stepSize)
        self._temperature = float(u.strip(temperature, _K))
        self._friction = float(u.strip(frictionCoeff, _PER_PS))

    def getTemperature(self) -> float:
        return self._temperature

    def setTemperature(self, temperature: float) -> None:
        self._temperature = float(u.strip(temperature, _K))

    def getFriction(self) -> float:
        return self._friction

    def setFriction(self, friction: float) -> None:
        self._friction = float(u.strip(friction, _PER_PS))

    def _params(self) -> tuple:
        return (self._step_size, self._friction, self._temperature)


def _noise(deps, pos):
    return torch.randn(pos.shape, generator=deps.generator, dtype=pos.dtype,
                       device=pos.device)


class LangevinMiddleIntegrator(_Stochastic):
    def _kinetic_energy_shift(self) -> float:
        return 0.0

    def _make_step_fn(self, deps: StepDeps):
        inv_m = deps.inv_masses[:, None]
        sqrt_inv_m = torch.sqrt(deps.inv_masses)[:, None]
        moving = deps.moving
        dt, friction, temperature = deps.params.unbind()

        def step(pos, vel, box):
            # device scalars, so new parameters need no new step program
            vscale = torch.exp(-dt * friction)
            noisescale = torch.sqrt(BOLTZ * temperature
                                    * (1.0 - vscale * vscale))
            for hook in deps.update_hooks:
                pos, vel = hook(deps.step, pos, vel, box)
            _, forces = deps.force_fn(pos, box)
            v = vel + dt * forces.to(vel.dtype) * inv_m
            v = deps.apply_velocity_constraints(pos, v)
            xi = _noise(deps, pos)
            v_o = torch.where(moving, vscale * v + noisescale * sqrt_inv_m
                              * xi, v)
            new_raw = pos + torch.where(moving, 0.5 * dt * (v + v_o), 0.0)
            new_pos, corr = deps.apply_position_constraints_corr(pos, new_raw)
            new_pos = deps.compute_vsites(new_pos)
            if corr is not None:
                v_o = v_o + corr / dt
            deps.step.add_(1)
            return new_pos, v_o

        return step


class LangevinIntegrator(_Stochastic):
    def _make_step_fn(self, deps: StepDeps):
        inv_m = deps.inv_masses[:, None]
        sqrt_inv_m = torch.sqrt(deps.inv_masses)[:, None]
        moving = deps.moving
        dt, friction, temperature = deps.params.unbind()

        def step(pos, vel, box):
            vscale = torch.exp(-dt * friction)
            free = friction == 0
            fscale = torch.where(free, dt, (1.0 - vscale)
                                 / torch.where(free, 1.0, friction))
            noisescale = torch.sqrt(BOLTZ * temperature
                                    * (1.0 - vscale * vscale))
            for hook in deps.update_hooks:
                pos, vel = hook(deps.step, pos, vel, box)
            xi = _noise(deps, pos)
            _, forces = deps.force_fn(pos, box)
            v = (vscale * vel + fscale * forces.to(vel.dtype) * inv_m
                 + noisescale * sqrt_inv_m * xi)
            new_raw = pos + torch.where(moving, v * dt, 0.0)
            new_pos, corr = deps.apply_position_constraints_corr(pos, new_raw)
            new_pos = deps.compute_vsites(new_pos)
            if corr is not None:
                v = v + corr / dt
            deps.step.add_(1)
            return new_pos, torch.where(moving, v, vel)

        return step


class BrownianIntegrator(_Stochastic):
    def _kinetic_energy_shift(self) -> float:
        return 0.0

    def _make_step_fn(self, deps: StepDeps):
        inv_m = deps.inv_masses[:, None]
        sqrt_inv_m = torch.sqrt(deps.inv_masses)[:, None]
        moving = deps.moving
        dt, friction, temperature = deps.params.unbind()

        def step(pos, vel, box):
            tau_dt = dt / friction
            noise_amp = torch.sqrt(2.0 * BOLTZ * temperature * tau_dt)
            for hook in deps.update_hooks:
                pos, vel = hook(deps.step, pos, vel, box)
            xi = _noise(deps, pos)
            _, forces = deps.force_fn(pos, box)
            delta = (tau_dt * forces.to(pos.dtype) * inv_m
                     + noise_amp * sqrt_inv_m * xi)
            new_raw = pos + torch.where(moving, delta, 0.0)
            new_pos, corr = deps.apply_position_constraints_corr(pos, new_raw)
            new_pos = deps.compute_vsites(new_pos)
            if corr is not None:
                delta = delta + corr
            deps.step.add_(1)
            return new_pos, torch.where(moving, delta / dt, vel)

        return step
