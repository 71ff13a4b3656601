"""GBSAOBCForce: OBC-II generalized Born implicit solvent with the ACE
surface-area term.

Counterpart of openmm_tpu/forces/gbsa.py: the same object API (particles
of charge, radius and scale factor; the solute and solvent dielectrics;
the surface-area energy; NoCutoff, CutoffNonPeriodic or CutoffPeriodic
at a cutoff) and the same energy. GBSAModule computes it on one device
(ops/gbsa.py): every pair of atoms, analytic forces for the step
(`ef`), an energy that autograd differentiates for the minimizer and the
barostats (`energy`). Numbers are plain floats in nm, kJ/mol and e.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import unit as u
from ..ops import gbsa as gb_ops
from .base import Force

_E = u.kilojoule_per_mole
_Q = u.elementary_charge
_NM = u.nanometer
_E_PER_NM2 = _E / _NM ** 2


class GBSAOBCForce(Force):
    NoCutoff = 0
    CutoffNonPeriodic = 1
    CutoffPeriodic = 2

    def __init__(self):
        super().__init__()
        self._particles = []        # (charge, radius, scalingFactor)
        self._solvent_dielectric = 78.3
        self._solute_dielectric = 1.0
        self._surface_energy = 28.3919551 / (4.0 * math.pi)
        self._method = GBSAOBCForce.NoCutoff
        self._cutoff = 1.0

    def getNumParticles(self):
        return len(self._particles)

    def addParticle(self, charge, radius, scalingFactor):
        self._particles.append((float(u.strip(charge, _Q)),
                                float(u.strip(radius, _NM)),
                                float(scalingFactor)))
        return len(self._particles) - 1

    def getParticleParameters(self, index):
        return self._particles[index]

    def setParticleParameters(self, index, charge, radius, scalingFactor):
        self._particles[index] = (float(u.strip(charge, _Q)),
                                  float(u.strip(radius, _NM)),
                                  float(scalingFactor))

    def getSolventDielectric(self):
        return self._solvent_dielectric

    def setSolventDielectric(self, dielectric):
        self._solvent_dielectric = float(dielectric)

    def getSoluteDielectric(self):
        return self._solute_dielectric

    def setSoluteDielectric(self, dielectric):
        self._solute_dielectric = float(dielectric)

    def getSurfaceAreaEnergy(self):
        """kJ/mol/nm^2; the ACE term is 4 pi times it."""
        return self._surface_energy

    def setSurfaceAreaEnergy(self, energy):
        self._surface_energy = float(u.strip(energy, _E_PER_NM2))

    def getNonbondedMethod(self):
        return self._method

    def setNonbondedMethod(self, method):
        if not 0 <= int(method) <= 2:
            raise ValueError("GBSAOBCForce: illegal nonbonded method")
        self._method = int(method)

    def getCutoffDistance(self):
        return self._cutoff

    def setCutoffDistance(self, distance):
        self._cutoff = float(u.strip(distance, _NM))

    def usesPeriodicBoundaryConditions(self):
        return self._method == GBSAOBCForce.CutoffPeriodic

    def updateParametersInContext(self, context):
        """Copy the particles' parameters into the Context in place."""
        context._update_force_parameters(self)

    def _compile(self, n, device, precision="mixed"):
        if len(self._particles) != n:
            raise ValueError("GBSAOBCForce must have the same number of "
                             "particles as the System")
        return GBSAModule(self, device, precision)


class GBSAModule:
    """One GBSAOBCForce on one device: the pair arithmetic in float32
    under "mixed" and float64 under "double" (ops/gbsa.py), each row sum
    and the per-atom terms in float64."""

    def __init__(self, force: GBSAOBCForce, device, precision="mixed"):
        self.group = force.getForceGroup()
        self.name = force.getName()
        self.dtype = torch.float64 if precision == "double" \
            else torch.float32
        self.periodic = force.usesPeriodicBoundaryConditions()
        self.terms = gb_ops.gb_terms(
            force.getSoluteDielectric(), force.getSolventDielectric(),
            force.getSurfaceAreaEnergy(),
            None if force.getNonbondedMethod() == GBSAOBCForce.NoCutoff
            else force.getCutoffDistance())
        p = torch.as_tensor(np.asarray(force._particles, np.float64)
                            .reshape(-1, 3), device=device)
        self.charge, self.radius, self.scale = p.unbind(1)

    def update(self, force) -> None:
        """updateParametersInContext: the charges, radii and scales
        written in place."""
        if force.getNumParticles() != self.charge.shape[0]:
            raise ValueError("updateParametersInContext: the number of "
                             "particles has changed")
        p = torch.as_tensor(np.asarray(force._particles, np.float64)
                            .reshape(-1, 3))
        for t, new in zip((self.charge, self.radius, self.scale),
                          p.unbind(1)):
            t.copy_(new)

    def _args(self, pos, box):
        return (pos.to(self.dtype), self.charge, self.radius, self.scale,
                self.terms, box if self.periodic else None)

    def ef(self, pos, box):
        """(energy float64 scalar, forces (n, 3) float64), analytically."""
        return gb_ops.gbsa_energy_forces(*self._args(pos, box))

    def energy(self, pos, box):
        """The energy as a float64 scalar that autograd differentiates
        with respect to pos."""
        return gb_ops.gbsa_energy(*self._args(pos, box))
