"""State: a snapshot of a Context as float64 numpy arrays and floats.

Counterpart of openmm_tpu/state.py, without units (nm, ps, kJ/mol): the
time, the step count, the box, and what getState was asked for: positions,
velocities, forces, energies, the global parameters and the energy
parameter derivatives.
"""
from __future__ import annotations


class State:
    # data-type flags, matching State::DataType (State.h:62-71)
    Positions = 1
    Velocities = 2
    Forces = 4
    Energy = 8
    Parameters = 16
    ParameterDerivatives = 32

    def __init__(self, time=0.0, step=0, box=None, positions=None,
                 velocities=None, forces=None, potential_energy=None,
                 kinetic_energy=None, parameters=None,
                 parameter_derivatives=None):
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

    @staticmethod
    def _need(value, what):
        if value is None:
            raise ValueError("%s was not requested in getState" % what)
        return value

    def getTime(self) -> float:
        return self._time

    def getStepCount(self) -> int:
        return self._step

    def getPeriodicBoxVectors(self):
        return self._box

    def getPositions(self):
        return self._need(self._positions, "positions")

    def getVelocities(self):
        return self._need(self._velocities, "velocities")

    def getForces(self):
        return self._need(self._forces, "forces")

    def getPotentialEnergy(self) -> float:
        return self._need(self._pe, "energy")

    def getKineticEnergy(self) -> float:
        return self._need(self._ke, "energy")

    def getParameters(self) -> dict:
        return dict(self._need(self._parameters, "parameters"))

    def getEnergyParameterDerivatives(self) -> dict:
        """{parameter: dE/dparameter} of the parameters the forces
        requested (addEnergyParameterDerivative)."""
        return dict(self._need(self._derivatives, "parameter derivatives"))

    def getDataTypes(self) -> int:
        """The flags of the data this State holds."""
        held = ((self._positions, State.Positions),
                (self._velocities, State.Velocities),
                (self._forces, State.Forces), (self._ke, State.Energy),
                (self._parameters, State.Parameters),
                (self._derivatives, State.ParameterDerivatives))
        types = 0
        for value, flag in held:
            if value is not None:
                types |= flag
        return types
