"""State: a snapshot of a Context as float64 numpy arrays and floats.

Counterpart of openmm_tpu/state.py, without units (nm, ps, kJ/mol).
"""
from __future__ import annotations


class State:
    def __init__(self, time=0.0, step=0, box=None, positions=None,
                 velocities=None, forces=None, potential_energy=None,
                 kinetic_energy=None):
        self._time = float(time)
        self._step = int(step)
        self._box = box
        self._positions = positions
        self._velocities = velocities
        self._forces = forces
        self._pe = potential_energy
        self._ke = kinetic_energy

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
