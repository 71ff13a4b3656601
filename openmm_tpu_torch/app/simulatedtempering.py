"""Simulated tempering: the port's copy of
openmm_tpu/app/simulatedtempering.py (after
wrappers/python/openmm/app/simulatedtempering.py:56: random walk in
temperature space with on-the-fly Wang-Landau-style weight adaptation)."""
from __future__ import annotations

import math
import random

import numpy as np

from .. import unit
from ..constants import BOLTZ


class SimulatedTempering(object):
    def __init__(self, simulation, temperatures=None, numTemperatures=None,
                 minTemperature=None, maxTemperature=None, weights=None,
                 tempChangeInterval=25, reportInterval=1000, reportFile=None):
        self.simulation = simulation
        if temperatures is None:
            if (numTemperatures is None or minTemperature is None
                    or maxTemperature is None):
                raise ValueError("Must specify temperatures or "
                                 "(numTemperatures, minTemperature, maxTemperature)")
            t_min = unit.strip(minTemperature, unit.kelvin)
            t_max = unit.strip(maxTemperature, unit.kelvin)
            self.temperatures = [
                unit.Quantity(t_min * math.exp(
                    i * math.log(t_max / t_min) / (numTemperatures - 1)),
                    unit.kelvin)
                for i in range(numTemperatures)]
        else:
            self.temperatures = [
                t if unit.is_quantity(t) else unit.Quantity(t, unit.kelvin)
                for t in temperatures]
        self.inverseTemperatures = [
            1.0 / (BOLTZ * t.value_in_unit(unit.kelvin))
            for t in self.temperatures]
        self.tempChangeInterval = int(tempChangeInterval)
        self.reportInterval = int(reportInterval)
        self.reportFile = reportFile
        self._openedFile = isinstance(reportFile, str)
        if self._openedFile:
            self.reportFile = open(reportFile, "w")
        if weights is None:
            self._weights = [0.0] * len(self.temperatures)
            self._updateWeights = True
            self._weightUpdateFactor = 1.0
            self._histogram = [0] * len(self.temperatures)
            self._hasMadeTransition = False
        else:
            self._weights = list(weights)
            self._updateWeights = False
        self.currentTemperature = 0
        self._setTemperature(0)

    @property
    def weights(self):
        return list(self._weights)

    def step(self, steps):
        stepsToGo = steps
        while stepsToGo > 0:
            nextSteps = min(stepsToGo,
                            self.tempChangeInterval
                            - self.simulation.currentStep
                            % self.tempChangeInterval)
            self.simulation.step(nextSteps)
            if self.simulation.currentStep % self.tempChangeInterval == 0:
                self._attemptTemperatureChange()
            stepsToGo -= nextSteps

    def _setTemperature(self, index):
        self.currentTemperature = index
        integ = self.simulation.integrator
        if hasattr(integ, "setTemperature"):
            integ.setTemperature(self.temperatures[index])
        ctx = self.simulation.context
        for name in ("AndersenTemperature", "MonteCarloTemperature"):
            try:
                ctx.setParameter(name, unit.strip(
                    self.temperatures[index], unit.kelvin))
            except Exception:
                pass

    def _attemptTemperatureChange(self):
        state = self.simulation.context.getState(getEnergy=True)
        e = state.getPotentialEnergy().value_in_unit(unit.kilojoule_per_mole)
        i = self.currentTemperature
        # compute transition probabilities to every temperature
        log_probs = np.array([
            self._weights[j] - self.inverseTemperatures[j] * e
            for j in range(len(self.temperatures))])
        log_probs -= log_probs.max()
        probs = np.exp(log_probs)
        probs /= probs.sum()
        j = int(np.random.choice(len(probs), p=probs))
        if j != i:
            self._hasMadeTransition = True
            # rescale velocities by sqrt(Tnew/Told)
            scale = math.sqrt(
                self.temperatures[j].value_in_unit(unit.kelvin)
                / self.temperatures[i].value_in_unit(unit.kelvin))
            vel = self.simulation.context.getState(getVelocities=True) \
                .getVelocities(asNumpy=True)._value
            self.simulation.context.setVelocities(vel * scale)
            self._setTemperature(j)
        if self._updateWeights:
            self._histogram[j] += 1
            self._weights[j] -= self._weightUpdateFactor
            min_count = min(self._histogram)
            if min_count > 20 and (min_count
                                   > 0.2 * sum(self._histogram)
                                   / len(self._histogram)):
                self._weightUpdateFactor *= 0.5
                self._histogram = [0] * len(self.temperatures)
        if (self.reportFile is not None and self.simulation.currentStep
                % self.reportInterval == 0):
            print("%d\t%g" % (self.simulation.currentStep,
                              self.temperatures[self.currentTemperature]._value),
                  file=self.reportFile)
