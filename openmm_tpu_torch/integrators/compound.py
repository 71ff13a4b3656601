"""CompoundIntegrator: switch between member integrators in one run.

Counterpart of openmm_tpu/integrators/compound.py (OpenMM's
CompoundIntegrator.cpp). The current member steps the Context: its step
function, its step size, integration force groups, kinetic-energy shift
and kinetic energy. The parameters are the concatenation of the members'
(_params), one device tensor; each member's StepDeps holds its slice as a
view, so the Context's writes reach every member and a switch needs no
new tensor. The Context keys its step programs and eager step functions
by the current member (_program_key), so each member's program is
captured once and switching back captures nothing.
"""
from __future__ import annotations

import dataclasses

from .base import Integrator, StepDeps


class CompoundIntegrator(Integrator):
    def __init__(self):
        super().__init__(0.0)
        self._integrators = []
        self._current = 0

    def addIntegrator(self, integrator) -> int:
        if self._context is not None:
            raise RuntimeError("integrators must be added before the "
                               "CompoundIntegrator is bound to a Context")
        self._integrators.append(integrator)
        return len(self._integrators) - 1

    def getNumIntegrators(self) -> int:
        return len(self._integrators)

    def getIntegrator(self, index):
        return self._integrators[index]

    def getCurrentIntegrator(self) -> int:
        return self._current

    def setCurrentIntegrator(self, index) -> None:
        if not 0 <= index < len(self._integrators):
            raise ValueError("invalid integrator index")
        self._current = int(index)

    def _member(self):
        return self._integrators[self._current]

    def getStepSize(self):
        return self._member().getStepSize()

    def setStepSize(self, size) -> None:
        self._member().setStepSize(size)

    def getConstraintTolerance(self) -> float:
        return self._member().getConstraintTolerance()

    def setConstraintTolerance(self, tol) -> None:
        for integ in self._integrators:
            integ.setConstraintTolerance(tol)

    def getIntegrationForceGroups(self) -> int:
        return self._member().getIntegrationForceGroups()

    def setIntegrationForceGroups(self, groups) -> None:
        self._member().setIntegrationForceGroups(groups)

    def _offsets(self) -> list:
        out, k = [], 0
        for integ in self._integrators:
            out.append(k)
            k += len(integ._params())
        return out

    def _params(self) -> tuple:
        return tuple(p for integ in self._integrators for p in integ._params())

    def _dt_index(self) -> int:
        return self._offsets()[self._current] + self._member()._dt_index()

    def _named_params(self) -> tuple:
        """The current member's, as the JAX package reports them."""
        return self._offsets()[self._current], self._member()._param_names()

    def _program_key(self):
        return self._current

    def _member_deps(self, deps: StepDeps, i: int) -> StepDeps:
        start = self._offsets()[i]
        size = len(self._integrators[i]._params())
        return dataclasses.replace(deps, params=deps.params[start:start
                                                            + size])

    def _bind(self, context) -> None:
        if not self._integrators:
            raise ValueError("a CompoundIntegrator needs a member")
        super()._bind(context)
        for integ in self._integrators:
            integ._bind(context)

    def _init_state(self, deps: StepDeps) -> None:
        for i, integ in enumerate(self._integrators):
            integ._init_state(self._member_deps(deps, i))

    def _state_tensors(self) -> list:
        return [t for integ in self._integrators
                for t in integ._state_tensors()]

    def _kinetic_energy_shift(self) -> float:
        return self._member()._kinetic_energy_shift()

    def _kinetic_energy_requires_force(self) -> bool:
        return self._member()._kinetic_energy_requires_force()

    def _kinetic_energy(self, ctx, forces, dt):
        return self._member()._kinetic_energy(ctx, forces, dt)

    def _make_step_fn(self, deps: StepDeps):
        return self._member()._make_step_fn(
            self._member_deps(deps, self._current))
