"""State: a snapshot of a Context.

Counterpart of openmm_tpu/state.py. The data are held as float64 numpy
arrays and floats in MD units (nm, ps, kJ/mol); the accessors return
Quantities as the JAX State's do, and getPositions, getVelocities and
getForces return a list of Vec3s, or with asNumpy=True an array, in a
Quantity. The time, the step count, the box and what getState was asked
for: positions, velocities, forces, energies, the global parameters and
the energy parameter derivatives, and the integrator's parameters (the
JAX package's _integrator_params: "dt", and "temperature", "friction" and
the like by integrator).
"""
from __future__ import annotations

import numpy as np

from . import unit as u
from .vec3 import Vec3


class State:
    # data-type flags, matching State::DataType (State.h:62-71)
    Positions = 1
    Velocities = 2
    Forces = 4
    Energy = 8
    Parameters = 16
    ParameterDerivatives = 32
    IntegratorParameters = 64

    def __init__(self, time=0.0, step=0, box=None, positions=None,
                 velocities=None, forces=None, potential_energy=None,
                 kinetic_energy=None, parameters=None,
                 parameter_derivatives=None, integrator_parameters=None):
        self._time = float(time)
        self._step = int(step)
        self._box = box
        self._positions = positions
        self._velocities = velocities
        self._forces = forces
        self._pe = potential_energy
        self._ke = kinetic_energy
        self._parameters = parameters
        self._derivatives = parameter_derivatives
        self._integrator_parameters = integrator_parameters

    @staticmethod
    def _need(value, what):
        if value is None:
            raise ValueError("%s was not requested in getState" % what)
        return value

    def getTime(self):
        return u.Quantity(self._time, u.picosecond)

    def getStepCount(self) -> int:
        return self._step

    def getPeriodicBoxVectors(self, asNumpy=False):
        box = np.asarray(self._need(self._box, "the box"), np.float64)
        if asNumpy:
            return u.Quantity(box, u.nanometer)
        return tuple(Vec3(*row) for row in box.tolist()) * u.nanometer

    def getPeriodicBoxVolume(self):
        box = np.asarray(self._need(self._box, "the box"), np.float64)
        return u.Quantity(float(abs(np.linalg.det(box))), u.nanometer ** 3)

    @staticmethod
    def _vectors(values, unit, asNumpy):
        if asNumpy:
            return u.Quantity(np.asarray(values), unit)
        return u.Quantity([Vec3(*row) for row in np.asarray(values).tolist()],
                          unit)

    def getPositions(self, asNumpy=False):
        return self._vectors(self._need(self._positions, "positions"),
                             u.nanometer, asNumpy)

    def getVelocities(self, asNumpy=False):
        return self._vectors(self._need(self._velocities, "velocities"),
                             u.nanometer / u.picosecond, asNumpy)

    def getForces(self, asNumpy=False):
        return self._vectors(self._need(self._forces, "forces"),
                             u.kilojoule_per_mole / u.nanometer, asNumpy)

    def getPotentialEnergy(self):
        return u.Quantity(float(self._need(self._pe, "energy")),
                          u.kilojoule_per_mole)

    def getKineticEnergy(self):
        return u.Quantity(float(self._need(self._ke, "energy")),
                          u.kilojoule_per_mole)

    def getParameters(self) -> dict:
        return dict(self._need(self._parameters, "parameters"))

    def getEnergyParameterDerivatives(self) -> dict:
        """{parameter: dE/dparameter} of the parameters the forces
        requested (addEnergyParameterDerivative)."""
        return dict(self._need(self._derivatives, "parameter derivatives"))

    def getIntegratorParameters(self) -> dict:
        """{name: value} of the integrator's parameters as the step reads
        them (getState(getIntegratorParameters=True))."""
        return dict(self._need(self._integrator_parameters,
                               "integrator parameters"))

    def getDataTypes(self) -> int:
        """The flags of the data this State holds."""
        held = ((self._positions, State.Positions),
                (self._velocities, State.Velocities),
                (self._forces, State.Forces), (self._ke, State.Energy),
                (self._parameters, State.Parameters),
                (self._derivatives, State.ParameterDerivatives),
                (self._integrator_parameters, State.IntegratorParameters))
        types = 0
        for value, flag in held:
            if value is not None:
                types |= flag
        return types
