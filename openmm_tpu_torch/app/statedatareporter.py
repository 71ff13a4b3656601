"""StateDataReporter: step, time, energies, temperature, volume,
density, speed and remaining time as delimited text.

The port's copy of openmm_tpu/app/statedatareporter.py (after OpenMM's
wrappers/python/openmm/app/statedatareporter.py:59-60): the same header
and columns, read from the port's plain State (ps, kJ/mol, nm). The
temperature counts the degrees of freedom as the port's Context does
(Context.degrees_of_freedom: three for each particle with mass, less the
constraints, less three with a CMMotionRemover).
"""
from __future__ import annotations

import time

import numpy as np

from .. import unit as u
from ..constants import BOLTZ


class StateDataReporter(object):
    def __init__(self, file, reportInterval, step=False, time=True,
                 potentialEnergy=False, kineticEnergy=False, totalEnergy=False,
                 temperature=False, volume=False, density=False,
                 progress=False, remainingTime=False, speed=False,
                 elapsedTime=False, separator=",", systemMass=None,
                 totalSteps=None):
        self._reportInterval = reportInterval
        self._openedFile = isinstance(file, str)
        self._out = open(file, "w") if self._openedFile else file
        self._step = step
        self._time = time
        self._potentialEnergy = potentialEnergy
        self._kineticEnergy = kineticEnergy
        self._totalEnergy = totalEnergy
        self._temperature = temperature
        self._volume = volume
        self._density = density
        self._progress = progress
        self._remainingTime = remainingTime
        self._speed = speed
        self._elapsedTime = elapsedTime
        self._separator = separator
        self._systemMass = systemMass
        self._totalSteps = totalSteps
        self._hasInitialized = False
        if (progress or remainingTime) and totalSteps is None:
            raise ValueError("totalSteps required for progress/remainingTime")

    def describeNextReport(self, simulation):
        steps = self._reportInterval - simulation.currentStep % self._reportInterval
        need_energy = (self._potentialEnergy or self._kineticEnergy
                       or self._totalEnergy or self._temperature)
        return (steps, False, False, False, need_energy, False)

    def report(self, simulation, state):
        if not self._hasInitialized:
            self._initializeConstants(simulation)
            print("#\"%s\"" % ("\"" + self._separator + "\"").join(
                self._constructHeaders()), file=self._out)
            try:
                self._out.flush()
            except AttributeError:
                pass
            self._initialClockTime = time.time()
            self._initialSimulationTime = state.getTime()
            self._initialSteps = simulation.currentStep
            self._hasInitialized = True
        values = self._constructReportValues(simulation, state)
        print(self._separator.join(str(v) for v in values), file=self._out)
        try:
            self._out.flush()
        except AttributeError:
            pass

    def _initializeConstants(self, simulation):
        system = simulation.system
        if self._temperature:
            self._dof = max(simulation.context.degrees_of_freedom(), 1)
        if self._density:
            if self._systemMass is not None:
                self._totalMass = float(u.strip(self._systemMass, u.dalton))
            else:
                self._totalMass = sum(system.getParticleMass(i) for i in
                                      range(system.getNumParticles()))

    def _constructHeaders(self):
        headers = []
        if self._progress:
            headers.append("Progress (%)")
        if self._step:
            headers.append("Step")
        if self._time:
            headers.append("Time (ps)")
        if self._potentialEnergy:
            headers.append("Potential Energy (kJ/mole)")
        if self._kineticEnergy:
            headers.append("Kinetic Energy (kJ/mole)")
        if self._totalEnergy:
            headers.append("Total Energy (kJ/mole)")
        if self._temperature:
            headers.append("Temperature (K)")
        if self._volume:
            headers.append("Box Volume (nm^3)")
        if self._density:
            headers.append("Density (g/mL)")
        if self._speed:
            headers.append("Speed (ns/day)")
        if self._elapsedTime:
            headers.append("Elapsed Time (s)")
        if self._remainingTime:
            headers.append("Time Remaining")
        return headers

    def _constructReportValues(self, simulation, state):
        values = []
        clock = time.time()
        if self._progress:
            values.append("%.1f%%" % (100.0 * simulation.currentStep
                                      / self._totalSteps))
        if self._step:
            values.append(simulation.currentStep)
        if self._time:
            values.append(round(state.getTime(), 4))
        if self._potentialEnergy:
            values.append(round(state.getPotentialEnergy(), 6))
        if self._kineticEnergy:
            values.append(round(state.getKineticEnergy(), 6))
        if self._totalEnergy:
            values.append(round(state.getPotentialEnergy()
                                + state.getKineticEnergy(), 6))
        if self._temperature:
            ke = state.getKineticEnergy()
            values.append(round(2.0 * ke / (self._dof * BOLTZ), 2))
        if self._volume:
            values.append(round(_volume(state), 4))
        if self._density:
            vol = _volume(state)  # nm^3
            # g/mL = (amu -> g via 1/NA) / (nm^3 -> mL via 1e-21)
            values.append(round(self._totalMass / vol * 1.66053906660e-3, 5))
        if self._speed or self._remainingTime or self._elapsedTime:
            elapsed_clock = clock - self._initialClockTime
            elapsed_sim = 1e-3 * (state.getTime()
                                  - self._initialSimulationTime)  # ns
        if self._speed:
            if elapsed_clock > 0:
                values.append("%.3g" % (elapsed_sim / elapsed_clock * 86400))
            else:
                values.append("--")
        if self._elapsedTime:
            values.append(round(elapsed_clock, 2))
        if self._remainingTime:
            steps_done = simulation.currentStep - self._initialSteps
            if steps_done > 0:
                rem = elapsed_clock * (self._totalSteps
                                       - simulation.currentStep) / steps_done
                h = int(rem / 3600)
                m = int((rem - 3600 * h) / 60)
                s = int(rem - 3600 * h - 60 * m)
                values.append("%d:%02d:%02d" % (h, m, s) if h else
                              "%d:%02d" % (m, s))
            else:
                values.append("--")
        return values

    def __del__(self):
        if getattr(self, "_openedFile", False):
            self._out.close()


def _volume(state):
    """The State's box volume, nm^3."""
    return float(abs(np.linalg.det(np.asarray(
        state.getPeriodicBoxVectors(), np.float64))))
