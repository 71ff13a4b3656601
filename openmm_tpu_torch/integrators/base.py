"""The Context-Integrator contract.

Counterpart of openmm_tpu/integrators/base.py. A Context hands its
integrator a StepDeps bundle; the step function the integrator makes from
it, step(positions, velocities, box) -> (positions, velocities), advances
the device state by one step, and the Context advances the time and the
step count on the host. The step also adds one to deps.step, the
Context's step counter on the device, which the update hooks read (a
captured step graph replays with the counter's address, so a host integer
would be frozen at capture); the Context sets it from the host count
before each chunk of steps. The hooks run before the force evaluation,
so the Context's rebuild decision, made inside force_fn, sees the
positions and the box a barostat left. The integrator's parameters (_params: the step
size first) reach the step as the device tensor deps.params, the
counterpart of the JAX package's state["iparams"]: the Context writes them
before it steps, so setStepSize and the like take effect at the next step
without a new step program.

Precision: positions and velocities are float64 tensors on the device. The
JAX package carries float32 positions plus a float32 compensation plane
(hi/lo TwoSum) because the TPU has no fast float64; the H100 does, so a
float64 master copy replaces the pair (so committing positions is a plain
assignment) and forces are evaluated from its float32 image.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import torch


@dataclass
class StepDeps:
    """What an integrator step needs from the Context."""
    inv_masses: torch.Tensor      # (n,) float64
    # force_fn(pos, box) -> (energy, forces)
    force_fn: Callable
    # (ref, new) -> (constrained, corr) with constrained == new + corr and
    # corr exactly zero off the constrained atoms; corr is None without
    # constraints
    apply_position_constraints_corr: Callable
    # (pos, vel) -> vel with the constrained components removed
    apply_velocity_constraints: Callable
    generator: torch.Generator
    params: torch.Tensor          # (len(_params()),) float64: _params()
    # () int64 on the device: the steps completed before this one
    step: torch.Tensor = None
    # updateContextState hooks, hook(step, pos, vel, box) -> (pos, vel),
    # run at the top of every step in the System's force order: the
    # CMMotionRemover changes the velocities, a barostat the positions
    # and, in place, the box tensor
    update_hooks: list = field(default_factory=list)


class Integrator:
    def __init__(self, stepSize: float):
        self._step_size = float(stepSize)
        self._constraint_tol = 1e-5
        self._context = None
        self._seed = 0

    def getStepSize(self) -> float:
        return self._step_size

    def setStepSize(self, size: float) -> None:
        self._step_size = float(size)

    def getConstraintTolerance(self) -> float:
        """Relative tolerance of constraints (SETTLE is exact; the
        minimizer holds its penalty solution to twice this)."""
        return self._constraint_tol

    def setConstraintTolerance(self, tol: float) -> None:
        self._constraint_tol = float(tol)

    def getRandomNumberSeed(self) -> int:
        return self._seed

    def setRandomNumberSeed(self, seed: int) -> None:
        self._seed = int(seed)

    def step(self, steps: int) -> None:
        if self._context is None:
            raise RuntimeError("This Integrator is not bound to a context")
        self._context._step(int(steps))

    def _bind(self, context) -> None:
        if self._context is not None and self._context is not context:
            raise RuntimeError("This Integrator is already bound to a context")
        self._context = context

    def _params(self) -> tuple:
        """The floats the step reads from deps.params, step size first."""
        return (self._step_size,)

    def _make_step_fn(self, deps: StepDeps) -> Callable:
        raise NotImplementedError
