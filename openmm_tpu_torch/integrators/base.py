"""The Context-Integrator contract.

Counterpart of openmm_tpu/integrators/base.py. A Context hands its
integrator a StepDeps bundle; the step function the integrator makes from
it, step(positions, velocities, box) -> (positions, velocities), advances
the device state by one step, and the Context advances the step count on
the host and the time on the device. The step also adds one to deps.step, the
Context's step counter on the device, which the update hooks read (a
captured step graph replays with the counter's address, so a host integer
would be frozen at capture); the Context sets it from the host count
before each chunk of steps. The hooks run before the force evaluation,
so the Context's rebuild decision, made inside force_fn, sees the
positions and the box a barostat left. The integrator's parameters (_params: the step
size first) reach the step as the device tensor deps.params, the
counterpart of the JAX package's state["iparams"]: the Context writes them
before it steps, so setStepSize and the like take effect at the next step
without a new step program. The force evaluation sums the integrator's
integration force groups (getIntegrationForceGroups: a bit mask, -1 for
all), and a massless particle never moves (deps.moving is False for it,
its inverse mass 0). deps.forces_by_groups evaluates any other mask (a
CustomIntegrator's f0..f31, MTS, aMD), the rebuild gate included.

The time is a float64 device scalar that the Context advances after each
step by deps.params[0], the step size the step used: a variable-step
integrator writes its new step size there in place. State of the
integrator's own (Nose-Hoover chains, a CustomIntegrator's variables) is
a set of device tensors that _init_state allocates when the Context binds
and the step writes in place; _state_tensors lists them, so that a
snapshot, an undone chunk and the warm-up before a capture copy them
back. Control flow that depends on device values goes through
deps.branch(pred, body), which runs body() where the device bool pred
holds, and deps.loop(cond, body), which runs body() while the device bool
that cond() returns holds: host `if` and `while` in the eager loop,
conditional IF and WHILE nodes in a captured step (step_program.py).

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

from .. import unit as u


def no_vsites(pos):
    """StepDeps.compute_vsites of a System without virtual sites."""
    return pos


@dataclass
class StepDeps:
    """What an integrator step needs from the Context."""
    inv_masses: torch.Tensor      # (n,) float64, 0 for a massless particle
    moving: torch.Tensor          # (n, 1) bool: the particle has mass
    # force_fn(pos, box) -> (energy, forces) of the integration groups
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
    # (pos, box, mask) -> (energy, forces) of the force groups in the bit
    # mask `mask` (-1: all)
    forces_by_groups: Callable = None
    # branch(pred, body): body() where the device bool pred holds
    branch: Callable = None
    # loop(cond, body): body() while the device bool cond() holds
    loop: Callable = None
    # pos -> pos with the virtual sites' rows computed from their parents:
    # every step calls it after each position update (the identity when
    # the System has no sites)
    compute_vsites: Callable = no_vsites
    # (key, pos_all (count, n, 3), box, mask) -> forces (count, n, 3) of
    # the groups in `mask` at each of count configurations (a ring
    # polymer's copies), each through a candidate state of set `key`
    # under one rebuild gate (replicas.py)
    replica_forces: Callable = None


class Integrator:
    def __init__(self, stepSize: float):
        self._step_size = float(u.strip(stepSize, u.picosecond))
        self._constraint_tol = 1e-5
        self._force_groups = -1
        self._context = None
        self._seed = 0

    def getStepSize(self):
        return u.Quantity(self._step_size, u.picosecond)

    def setStepSize(self, size: float) -> None:
        self._step_size = float(u.strip(size, u.picosecond))

    def getConstraintTolerance(self) -> float:
        """Relative tolerance of constraints (SETTLE is exact; the
        minimizer holds its penalty solution to twice this)."""
        return self._constraint_tol

    def setConstraintTolerance(self, tol: float) -> None:
        self._constraint_tol = float(tol)

    def getIntegrationForceGroups(self) -> int:
        """The bit mask of the force groups a step integrates (-1: all)."""
        return self._force_groups

    def setIntegrationForceGroups(self, groups) -> None:
        """A bit mask, or a collection of group numbers."""
        if isinstance(groups, (set, frozenset, list, tuple)):
            mask = 0
            for g in groups:
                mask |= 1 << int(g)
            groups = mask
        self._force_groups = int(groups)

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

    def _param_names(self) -> tuple:
        """The names of the _params floats, in their order: the keys of
        the JAX package's _integrator_params, which getState reports
        (getIntegratorParameters) and setState writes."""
        return ("dt",)

    def _named_params(self) -> tuple:
        """(offset in deps.params, _param_names) of the parameters that
        getState reports: all of them but in a CompoundIntegrator."""
        return 0, self._param_names()

    def _dt_index(self) -> int:
        """Where the step size of the next step lies in deps.params."""
        return 0

    def _program_key(self):
        """What besides the shapes and the integration groups selects a
        step function (a CompoundIntegrator's current member)."""
        return None

    def _init_state(self, deps: StepDeps) -> None:
        """Allocate the device tensors of the integrator's own state."""

    def _state_tensors(self) -> list:
        """The device tensors of the integrator's own state, which its
        step writes in place."""
        return []

    def _kinetic_energy_requires_force(self) -> bool:
        return self._kinetic_energy_shift() != 0.0

    def _kinetic_energy(self, ctx, forces, dt) -> torch.Tensor:
        """0.5 sum m (v + s dt f / m)^2 with s the _kinetic_energy_shift,
        dt the step size on the device and f `forces` (used where s is
        not 0)."""
        v = ctx._state["velocities"]
        shift = self._kinetic_energy_shift()
        if shift != 0.0:
            v = v + (shift * dt) * forces * ctx._inv_masses[:, None]
        return 0.5 * torch.sum(ctx._masses[:, None] * v * v)

    def _kinetic_energy_shift(self) -> float:
        """The shift s, in steps, of the reported kinetic energy
        0.5 sum m (v + s dt f / m)^2 (Integrator.h computeKineticEnergy):
        0.5 for leapfrog integrators, whose velocities lie half a step
        behind the positions; 0 where they are on step."""
        return 0.5

    def _make_step_fn(self, deps: StepDeps) -> Callable:
        raise NotImplementedError
