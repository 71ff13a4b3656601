"""Accelerated molecular dynamics (aMD) as CustomIntegrator programs.

Counterpart of openmm_tpu/integrators/amd.py (after OpenMM's amd.py): below
a threshold E the potential is boosted by dV = (E - V)^2 / (alpha + E - V),
which scales the forces by (alpha / (alpha + E - V))^2. AMDIntegrator
boosts the whole potential, AMDForceGroupIntegrator one force group's
energy, DualAMDIntegrator both. Energies in kJ/mol.
"""
from __future__ import annotations

from .. import unit as u
from .custom import CustomIntegrator

_E = u.kilojoule_per_mole


def _boost(energy, alpha, E):
    """The boost dV of an energy for a threshold E and an alpha."""
    if energy > E:
        return 0.0
    return (E - energy) ** 2 / (alpha + E - energy)


class _AMD(CustomIntegrator):
    def _finish_program(self, kick):
        self.addPerDofVariable("oldx", 0)
        self.addUpdateContextState()
        self.addComputePerDof("v", kick)
        self.addComputePerDof("oldx", "x")
        self.addComputePerDof("x", "x+dt*v")
        self.addConstrainPositions()
        self.addComputePerDof("v", "(x-oldx)/dt")


class AMDIntegrator(_AMD):
    """The boost on the total potential energy."""

    def __init__(self, dt, alpha, E):
        super().__init__(dt)
        self.addGlobalVariable("alpha", alpha)
        self.addGlobalVariable("E", E)
        self._finish_program(
            "v+dt*fprime/m; "
            "fprime=f*((1-modify) + modify*(alpha/(alpha+E-energy))^2); "
            "modify=step(E-energy)")

    def getAlpha(self):
        return u.Quantity(self.getGlobalVariableByName("alpha"), _E)

    def setAlpha(self, alpha) -> None:
        self.setGlobalVariableByName("alpha", alpha)

    def getE(self):
        return u.Quantity(self.getGlobalVariableByName("E"), _E)

    def setE(self, E) -> None:
        self.setGlobalVariableByName("E", E)

    def getEffectiveEnergy(self, energy):
        """The boosted energy of a potential energy `energy`."""
        energy = float(u.strip(energy, _E))
        return u.Quantity(energy + _boost(
            energy, self.getGlobalVariableByName("alpha"),
            self.getGlobalVariableByName("E")), _E)


class AMDForceGroupIntegrator(_AMD):
    """The boost on one force group's energy."""

    def __init__(self, dt, group, alphaGroup, EGroup):
        super().__init__(dt)
        g = int(group)
        self._group = g
        self.addGlobalVariable("alphaGroup", alphaGroup)
        self.addGlobalVariable("EGroup", EGroup)
        self._finish_program(
            "v+dt*fprime/m; "
            "fprime=fother + fg*((1-modify) + modify*(alphaGroup/"
            "(alphaGroup+EGroup-energy%d))^2); "
            "fother=f-fg; fg=f%d; modify=step(EGroup-energy%d)" % (g, g, g))

    def getAlphaGroup(self):
        return u.Quantity(self.getGlobalVariableByName("alphaGroup"), _E)

    def setAlphaGroup(self, alpha) -> None:
        self.setGlobalVariableByName("alphaGroup", alpha)

    def getEGroup(self):
        return u.Quantity(self.getGlobalVariableByName("EGroup"), _E)

    def setEGroup(self, E) -> None:
        self.setGlobalVariableByName("EGroup", E)

    def getEffectiveEnergy(self, totalEnergy, groupEnergy):
        """The total energy with the group's boost."""
        return u.Quantity(float(u.strip(totalEnergy, _E)) + _boost(
            float(u.strip(groupEnergy, _E)),
            self.getGlobalVariableByName("alphaGroup"),
            self.getGlobalVariableByName("EGroup")), _E)


class DualAMDIntegrator(_AMD):
    """A boost on the total energy and another on one group's."""

    def __init__(self, dt, group, alphaTotal, ETotal, alphaGroup, EGroup):
        super().__init__(dt)
        g = int(group)
        self._group = g
        self.addGlobalVariable("alphaTotal", alphaTotal)
        self.addGlobalVariable("ETotal", ETotal)
        self.addGlobalVariable("alphaGroup", alphaGroup)
        self.addGlobalVariable("EGroup", EGroup)
        self._finish_program(
            "v+dt*fprime/m; "
            "fprime=fprime1 + fprime2; "
            "fprime2=fg*((1-modifyGroup) + modifyGroup*(alphaGroup/"
            "(alphaGroup+EGroup-energy%d))^2); "
            "fprime1=fother*((1-modifyTotal) + modifyTotal*(alphaTotal/"
            "(alphaTotal+ETotal-energy))^2); "
            "fother=f-fg; fg=f%d; "
            "modifyTotal=step(ETotal-energy); "
            "modifyGroup=step(EGroup-energy%d)" % (g, g, g))

    def getEffectiveEnergy(self, totalEnergy, groupEnergy):
        """The total energy with both boosts."""
        total = float(u.strip(totalEnergy, _E))
        group = float(u.strip(groupEnergy, _E))
        alpha_t = self.getGlobalVariableByName("alphaTotal")
        e_t = self.getGlobalVariableByName("ETotal")
        alpha_g = self.getGlobalVariableByName("alphaGroup")
        e_g = self.getGlobalVariableByName("EGroup")
        return u.Quantity(total + _boost(total, alpha_t, e_t)
                          + _boost(group, alpha_g, e_g), _E)
