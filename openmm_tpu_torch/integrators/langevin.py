"""LangevinMiddleIntegrator: the LFMiddle (BAOAB) discretization.

Counterpart of openmm_tpu/integrators/langevin.py (LangevinMiddleIntegrator,
after langevinMiddle.cc): the update hooks (the CMMotionRemover, the
barostats), a full
force kick, velocity constraints, half a drift, the Ornstein-Uhlenbeck
step, half a drift, position constraints, and velocities corrected by the
constraint correction alone (the round-5 drift fix). The noise comes from
the Context's torch.Generator, so it does not reproduce the JAX package's
jax.random stream.
"""
from __future__ import annotations

import torch

from ..constants import BOLTZ
from .base import Integrator, StepDeps


class LangevinMiddleIntegrator(Integrator):
    def __init__(self, temperature: float, frictionCoeff: float,
                 stepSize: float):
        super().__init__(stepSize)
        self._temperature = float(temperature)
        self._friction = float(frictionCoeff)

    def setTemperature(self, temperature: float) -> None:
        self._temperature = float(temperature)

    def setFriction(self, friction: float) -> None:
        self._friction = float(friction)

    def _params(self) -> tuple:
        return (self._step_size, self._friction, self._temperature)

    def _make_step_fn(self, deps: StepDeps):
        inv_m = deps.inv_masses[:, None]
        sqrt_inv_m = torch.sqrt(deps.inv_masses)[:, None]
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
            xi = torch.randn(pos.shape, generator=deps.generator,
                             dtype=pos.dtype, device=pos.device)
            v_o = vscale * v + noisescale * sqrt_inv_m * xi
            new_raw = pos + 0.5 * dt * (v + v_o)
            new_pos, corr = deps.apply_position_constraints_corr(pos, new_raw)
            if corr is not None:
                v_o = v_o + corr / dt
            deps.step.add_(1)
            return new_pos, v_o

        return step
