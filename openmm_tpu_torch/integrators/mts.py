"""Multiple-time-step (r-RESPA) integrators as CustomIntegrator programs.

Counterpart of openmm_tpu/integrators/mts.py (after OpenMM's
mtsintegrator.py): force groups evaluated at different frequencies,
groups = [(force group, substeps), ...] sorted by substeps as OpenMM sorts
them (_sorted_groups), each group's substeps a multiple of the previous
one's; the
innermost loop moves the positions. [(0, 1), (1, 2)] kicks with group 0
once a step and with group 1 twice. The CustomIntegrator's force cache
evaluates a group once for each position it is read at: group 0 once a
step, from the step's end to the next step's start.
"""
from __future__ import annotations

from .. import unit as u
from ..constants import BOLTZ
from .custom import CustomIntegrator

_K = u.kelvin
_PER_PS = u.picosecond ** -1


def _sorted_groups(groups):
    """The groups from the slowest (fewest substeps) to the fastest, as
    OpenMM's mtsintegrator.py orders them; among equal substeps by group
    number. Wherever the JAX package's order (by group number) is valid
    it is this one; [(1, 1), (0, 2)] (the reciprocal space in group 1,
    the slow one) it refuses, OpenMM and the port take it."""
    if len(groups) == 0:
        raise ValueError("No force groups specified")
    return sorted(((int(g), int(n)) for g, n in groups),
                  key=lambda gn: (gn[1], gn[0]))


def _check_ratio(substeps, parent_substeps):
    if substeps % parent_substeps != 0:
        raise ValueError("The number of substeps for each group must be a "
                         "multiple of the number for the previous group")
    return substeps // parent_substeps


class MTSIntegrator(CustomIntegrator):
    """MTSIntegrator(dt, groups): velocity Verlet with the groups' kicks
    nested."""

    def __init__(self, dt, groups):
        super().__init__(dt)
        groups = _sorted_groups(groups)
        self._mts_groups = groups
        self.addPerDofVariable("x1", 0)
        self.addUpdateContextState()
        self._create_substeps(1, groups)
        self.addConstrainVelocities()

    def _create_substeps(self, parent_substeps, groups):
        group, substeps = groups[0]
        sub = str(substeps)
        for _ in range(_check_ratio(substeps, parent_substeps)):
            self.addComputePerDof("v", "v+0.5*(dt/%s)*f%d/m" % (sub, group))
            if len(groups) == 1:
                self.addComputePerDof("x", "x+(dt/%s)*v" % sub)
                self.addComputePerDof("x1", "x")
                self.addConstrainPositions()
                self.addComputePerDof("v", "v+(x-x1)/(dt/%s)" % sub)
            else:
                self._create_substeps(substeps, groups[1:])
            self.addComputePerDof("v", "v+0.5*(dt/%s)*f%d/m" % (sub, group))


class MTSLangevinIntegrator(CustomIntegrator):
    """MTS with the BAOAB Langevin step innermost (mtsintegrator.py)."""

    def __init__(self, temperature, friction, dt, groups):
        super().__init__(dt)
        groups = _sorted_groups(groups)
        self._mts_groups = groups
        self._temperature = float(u.strip(temperature, _K))
        self._friction = float(u.strip(friction, _PER_PS))
        self.addGlobalVariable("a", 0.0)
        self.addGlobalVariable("b", 0.0)
        self.addGlobalVariable("kT", BOLTZ * self._temperature)
        self.addGlobalVariable("friction", self._friction)
        self.addPerDofVariable("x1", 0)
        self.addUpdateContextState()
        inner = groups[-1][1]
        self.addComputeGlobal("a", "exp(-friction*dt/%d)" % inner)
        self.addComputeGlobal("b", "sqrt(1-a^2)")
        self._create_substeps(1, groups)
        self.addConstrainVelocities()

    def getTemperature(self) -> float:
        return self._temperature

    def getFriction(self) -> float:
        return self._friction

    def _create_substeps(self, parent_substeps, groups):
        group, substeps = groups[0]
        sub = str(substeps)
        for _ in range(_check_ratio(substeps, parent_substeps)):
            self.addComputePerDof("v", "v+0.5*(dt/%s)*f%d/m" % (sub, group))
            if len(groups) == 1:
                self.addComputePerDof("x", "x+0.5*(dt/%s)*v" % sub)
                self.addComputePerDof("v", "a*v + b*sqrt(kT/m)*gaussian")
                self.addComputePerDof("x", "x+0.5*(dt/%s)*v" % sub)
                self.addComputePerDof("x1", "x")
                self.addConstrainPositions()
                self.addComputePerDof("v", "v+(x-x1)/(dt/%s)" % sub)
            else:
                self._create_substeps(substeps, groups[1:])
            self.addComputePerDof("v", "v+0.5*(dt/%s)*f%d/m" % (sub, group))
