"""VerletIntegrator: leapfrog Verlet.

Counterpart of openmm_tpu/integrators/verlet.py (after verlet.cc and
ReferenceVerletDynamics.cpp): the update hooks, a full force kick into
the velocities, a drift by v dt, the position constraints, and the
velocities corrected by the constraint correction alone (the round-5
drift fix: recovering them from the rounded positions would kick each
atom by ~eps |x| / dt every step). Massless particles neither kick nor
move. The JAX package carries a float32 velocity plus a compensation
plane (vel_lo, TwoSum) under mixed precision; the port's velocities are
float64, which replaces it.
"""
from __future__ import annotations

import torch

from .base import Integrator, StepDeps


class VerletIntegrator(Integrator):
    def _make_step_fn(self, deps: StepDeps):
        inv_m = deps.inv_masses[:, None]
        moving = deps.moving
        dt = deps.params[0]

        def step(pos, vel, box):
            for hook in deps.update_hooks:
                pos, vel = hook(deps.step, pos, vel, box)
            _, forces = deps.force_fn(pos, box)
            v = vel + dt * forces.to(vel.dtype) * inv_m
            new_raw = pos + torch.where(moving, v * dt, 0.0)
            new_pos, corr = deps.apply_position_constraints_corr(pos, new_raw)
            new_pos = deps.compute_vsites(new_pos)
            if corr is not None:
                v = v + corr / dt
            deps.step.add_(1)
            return new_pos, torch.where(moving, v, vel)

        return step
