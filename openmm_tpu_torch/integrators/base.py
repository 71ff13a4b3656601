"""The Context-Integrator contract.

Counterpart of openmm_tpu/integrators/base.py. A Context hands its
integrator a StepDeps bundle; the integrator's step(state) advances the
state dict {"positions", "velocities", "box", "time", "step"} by one step.

Precision: positions and velocities are float64 tensors on the device. The
JAX package carries float32 positions plus a float32 compensation plane
(hi/lo TwoSum) because the TPU has no fast float64; the H100 does, so a
float64 master copy replaces the pair (so committing positions is a plain
assignment) and forces are evaluated from its float32 image.
"""
from __future__ import annotations

from dataclasses import dataclass
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


class Integrator:
    def __init__(self, stepSize: float):
        self._step_size = float(stepSize)
        self._context = None
        self._seed = 0

    def setStepSize(self, size: float) -> None:
        self._step_size = float(size)

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

    def _make_step_fn(self, deps: StepDeps) -> Callable:
        raise NotImplementedError
