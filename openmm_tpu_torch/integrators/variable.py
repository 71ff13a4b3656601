"""Variable-step integrators: VariableVerlet and VariableLangevin.

Counterpart of openmm_tpu/integrators/variable.py. Each step picks its
step size on the device from the forces (_select_step_size, after OpenMM's
selectVerletStepSize: dt = sqrt(errorTol / sqrt(mean |f/m|^2)), at most
twice the previous one, the previous one kept while the new one would grow
it by less than 10 %, at most maxStepSize), writes it into deps.params[0]
in place (the JAX package's state["iparams"]["dt"]), and the Context's
clock advances by it. Then a leapfrog step with that size: Verlet's, or
the leapfrog Langevin step (v' = vscale v + fscale f/m + noisescale xi /
sqrt(m)). The velocities are corrected by the constraint correction alone
(the round-5 drift fix), massless particles never move, and the kinetic
energy is shifted by half the device step size.

getStepSize returns the step size the last step used, read from the
device, as OpenMM's does; the JAX package returns the host's value (0
until setStepSize). setStepSize, and any other setter, writes the host's
parameters again at the next step, so the next step size is picked
afresh, as in the JAX package.
"""
from __future__ import annotations

import torch

from .. import unit as u
from ..constants import BOLTZ
from .base import Integrator, StepDeps
from .langevin import _noise

_K = u.kelvin
_PER_PS = u.picosecond ** -1


def _select_step_size(forces, inv_m, old_dt, error_tol, max_dt):
    n = forces.shape[0]
    err = torch.sum((forces * inv_m[:, None]) ** 2)
    total_error = torch.sqrt(err / (n * 3))
    new_dt = torch.sqrt(error_tol / total_error)
    new_dt = torch.where(old_dt > 0, torch.minimum(new_dt, old_dt * 2.0),
                         new_dt)
    new_dt = torch.where((new_dt > old_dt) & (new_dt < 1.1 * old_dt), old_dt,
                         new_dt)
    return torch.minimum(new_dt, max_dt)


class _Variable(Integrator):
    def __init__(self, errorTol):
        super().__init__(0.0)
        self._error_tol = float(errorTol)
        self._max_step_size = 10.0      # ps: no bound by default
        self._dt = None                 # the device step size, once bound

    def getErrorTolerance(self) -> float:
        return self._error_tol

    def setErrorTolerance(self, tol) -> None:
        self._error_tol = float(tol)

    def getMaximumStepSize(self):
        return u.Quantity(self._max_step_size, u.picosecond)

    def setMaximumStepSize(self, size) -> None:
        self._max_step_size = float(u.strip(size, u.picosecond))

    def getStepSize(self):
        """The step size of the last step (the host's value before the
        first)."""
        if self._dt is None:
            return u.Quantity(self._step_size, u.picosecond)
        return u.Quantity(float(self._dt), u.picosecond)

    def _init_state(self, deps: StepDeps) -> None:
        self._dt = deps.params[0]

    def _stepper(self, deps):
        """(pos, vel, box) -> (forces, dt) after the hooks: the force
        evaluation, and the step size picked from it and written into the
        parameters."""
        params = deps.params
        tol, max_dt = params[-2], params[-1]

        def pick(pos, box):
            _, forces = deps.force_fn(pos, box)
            forces = forces.to(torch.float64)
            dt = _select_step_size(forces, deps.inv_masses, params[0], tol,
                                   max_dt)
            params[0].copy_(dt)
            return forces, dt

        return pick

    @staticmethod
    def _finish(deps, pos, vel, v, dt):
        new_raw = pos + torch.where(deps.moving, v * dt, 0.0)
        new_pos, corr = deps.apply_position_constraints_corr(pos, new_raw)
        new_pos = deps.compute_vsites(new_pos)
        if corr is not None:
            v = v + corr / dt
        deps.step.add_(1)
        return new_pos, torch.where(deps.moving, v, vel)


class VariableVerletIntegrator(_Variable):
    def _params(self) -> tuple:
        return (self._step_size, self._error_tol, self._max_step_size)

    def _param_names(self) -> tuple:
        return ("dt", "errorTol", "maxStepSize")

    def _make_step_fn(self, deps: StepDeps):
        inv_m = deps.inv_masses[:, None]
        pick = self._stepper(deps)

        def step(pos, vel, box):
            for hook in deps.update_hooks:
                pos, vel = hook(deps.step, pos, vel, box)
            forces, dt = pick(pos, box)
            v = vel + dt * forces * inv_m
            return self._finish(deps, pos, vel, v, dt)

        return step


class VariableLangevinIntegrator(_Variable):
    def __init__(self, temperature, frictionCoeff, errorTol):
        super().__init__(errorTol)
        self._temperature = float(u.strip(temperature, _K))
        self._friction = float(u.strip(frictionCoeff, _PER_PS))

    def getTemperature(self):
        return u.Quantity(self._temperature, _K)

    def setTemperature(self, temperature) -> None:
        self._temperature = float(u.strip(temperature, _K))

    def getFriction(self):
        return u.Quantity(self._friction, _PER_PS)

    def setFriction(self, friction) -> None:
        self._friction = float(u.strip(friction, _PER_PS))

    def _params(self) -> tuple:
        return (self._step_size, self._friction, self._temperature,
                self._error_tol, self._max_step_size)

    def _param_names(self) -> tuple:
        return ("dt", "friction", "temperature", "errorTol", "maxStepSize")

    def _make_step_fn(self, deps: StepDeps):
        inv_m = deps.inv_masses[:, None]
        sqrt_inv_m = torch.sqrt(deps.inv_masses)[:, None]
        pick = self._stepper(deps)
        friction, temperature = deps.params[1], deps.params[2]

        def step(pos, vel, box):
            kT = BOLTZ * temperature
            for hook in deps.update_hooks:
                pos, vel = hook(deps.step, pos, vel, box)
            forces, dt = pick(pos, box)
            vscale = torch.exp(-dt * friction)
            free = friction == 0
            fscale = torch.where(free, dt, (1.0 - vscale)
                                 / torch.where(free, 1.0, friction))
            noisescale = torch.sqrt(kT * (1.0 - vscale * vscale))
            xi = _noise(deps, pos)
            v = (vscale * vel + fscale * forces * inv_m
                 + noisescale * sqrt_inv_m * xi)
            return self._finish(deps, pos, vel, v, dt)

        return step
