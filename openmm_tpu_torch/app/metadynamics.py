"""Well-tempered metadynamics: the port's copy of
openmm_tpu/app/metadynamics.py (after
wrappers/python/openmm/app/metadynamics.py:42-272: Gaussian bumps accumulated
on a grid bias applied through a TabulatedFunction inside a CustomCVForce;
Barducci et al. 2008)."""
from __future__ import annotations

import os
from functools import reduce

import numpy as np

from .. import unit
from ..constants import BOLTZ
from ..forces import CustomCVForce
from ..tabulated import (Continuous1DFunction, Continuous2DFunction,
                         Continuous3DFunction)


class Metadynamics(object):
    def __init__(self, system, variables, temperature, biasFactor, height,
                 frequency, saveFrequency=None, biasDir=None):
        if not unit.is_quantity(temperature):
            temperature = temperature * unit.kelvin
        if not unit.is_quantity(height):
            height = height * unit.kilojoules_per_mole
        if biasFactor < 1.0:
            raise ValueError("biasFactor must be >= 1")
        if (saveFrequency is None) != (biasDir is None):
            raise ValueError("Must specify both saveFrequency and biasDir")
        if saveFrequency is not None and (saveFrequency < frequency
                                          or saveFrequency % frequency != 0):
            raise ValueError("saveFrequency must be a multiple of frequency")
        self.variables = variables
        self.temperature = temperature
        self.biasFactor = float(biasFactor)
        self.height = height
        self.frequency = int(frequency)
        self.biasDir = biasDir
        self.saveFrequency = saveFrequency
        self._id = np.random.randint(0x7FFFFFFF)
        self._saveIndex = 0
        self._selfBias = np.zeros(tuple(v.gridWidth for v in variables))
        self._totalBias = np.zeros(tuple(v.gridWidth for v in variables))
        self._loadedBiases = {}
        self._deltaT = temperature * (biasFactor - 1)

        varNames = ["cv%d" % i for i in range(len(variables))]
        self._force = CustomCVForce("table(%s)" % ", ".join(varNames))
        for name, var in zip(varNames, variables):
            self._force.addCollectiveVariable(name, var.force)
        widths = [v.gridWidth for v in variables]
        mins = [v.minValue for v in variables]
        maxs = [v.maxValue for v in variables]
        periodic = all(v.periodic for v in variables)
        if len(variables) == 1:
            self._table = Continuous1DFunction(
                self._totalBias.flatten(), mins[0], maxs[0], periodic)
        elif len(variables) == 2:
            self._table = Continuous2DFunction(
                widths[0], widths[1], self._totalBias.flatten(order="F"),
                mins[0], maxs[0], mins[1], maxs[1], periodic)
        elif len(variables) == 3:
            self._table = Continuous3DFunction(
                widths[0], widths[1], widths[2],
                self._totalBias.flatten(order="F"), mins[0], maxs[0],
                mins[1], maxs[1], mins[2], maxs[2], periodic)
        else:
            raise ValueError("Metadynamics requires 1-3 collective variables")
        self._force.addTabulatedFunction("table", self._table)
        self._force.setForceGroup(31)
        system.addForce(self._force)
        if biasDir is not None:
            self._syncWithDisk()

    def step(self, simulation, steps):
        """Advance the simulation, depositing Gaussians every `frequency`
        steps (metadynamics.py:154)."""
        stepsToGo = steps
        groups = {i for i in range(32) if i != 31}
        while stepsToGo > 0:
            nextSteps = stepsToGo
            if simulation.currentStep % self.frequency == 0:
                nextSteps = min(nextSteps, self.frequency)
            else:
                nextSteps = min(nextSteps, self.frequency
                                - simulation.currentStep % self.frequency)
            simulation.step(nextSteps)
            if simulation.currentStep % self.frequency == 0:
                position = self._force.getCollectiveVariableValues(
                    simulation.context)
                energy = simulation.context.getState(
                    getEnergy=True, groups={31}).getPotentialEnergy()
                kT_delta = (unit.MOLAR_GAS_CONSTANT_R * self._deltaT
                            ).value_in_unit(unit.kilojoule_per_mole)
                height = self.height * np.exp(
                    -energy.value_in_unit(unit.kilojoule_per_mole) / kT_delta)
                self._addGaussian(position, height, simulation.context)
            if (self.saveFrequency is not None
                    and simulation.currentStep % self.saveFrequency == 0):
                self._syncWithDisk()
            stepsToGo -= nextSteps

    def getFreeEnergy(self, asNumpy=True):
        """-(T+dT)/dT * bias (well-tempered free energy estimate)."""
        scale = -((self.temperature + self._deltaT) / self._deltaT)
        return unit.Quantity(float(scale) * self._totalBias,
                             unit.kilojoule_per_mole)

    def getCollectiveVariables(self, simulation):
        return self._force.getCollectiveVariableValues(simulation.context)

    def _addGaussian(self, position, height, context):
        axes = []
        for v in self.variables:
            x = (np.asarray(position[len(axes)]) - v.minValue) \
                / (v.maxValue - v.minValue)
            if v.periodic:
                x = x % 1.0
            grid = np.linspace(0, 1, v.gridWidth)
            dx = x - grid
            if v.periodic:
                dx -= np.round(dx)
            scaled_width = v.biasWidth / (v.maxValue - v.minValue)
            axes.append(np.exp(-0.5 * (dx / scaled_width) ** 2))
        gauss = reduce(np.multiply.outer, axes)
        h = unit.strip(height, unit.kilojoule_per_mole)
        self._selfBias += h * gauss
        self._totalBias += h * gauss
        self._updateTable(context)

    def _updateTable(self, context):
        widths = [v.gridWidth for v in self.variables]
        mins = [v.minValue for v in self.variables]
        maxs = [v.maxValue for v in self.variables]
        if len(self.variables) == 1:
            self._table.setFunctionParameters(
                self._totalBias.flatten(), mins[0], maxs[0])
        elif len(self.variables) == 2:
            self._table.setFunctionParameters(
                widths[0], widths[1], self._totalBias.flatten(order="F"),
                mins[0], maxs[0], mins[1], maxs[1])
        else:
            self._table.setFunctionParameters(
                widths[0], widths[1], widths[2],
                self._totalBias.flatten(order="F"), mins[0], maxs[0],
                mins[1], maxs[1], mins[2], maxs[2])
        self._force.updateParametersInContext(context)

    def _syncWithDisk(self):
        """Write own bias; load biases from other processes
        (metadynamics.py:230-260)."""
        if self.biasDir is None:
            return
        self._saveIndex += 1
        oldName = os.path.join(self.biasDir,
                               "bias_%d_%d.npy" % (self._id, self._saveIndex - 1))
        tempName = os.path.join(self.biasDir,
                                "temp_%d_%d.npy" % (self._id, self._saveIndex))
        fileName = os.path.join(self.biasDir,
                                "bias_%d_%d.npy" % (self._id, self._saveIndex))
        np.save(tempName, self._selfBias)
        os.replace(tempName, fileName)
        if os.path.exists(oldName):
            os.remove(oldName)
        fileLoaded = False
        for filename in os.listdir(self.biasDir):
            if filename.startswith("bias_") and filename.endswith(".npy"):
                parts = filename[5:-4].split("_")
                if len(parts) == 2 and int(parts[0]) != self._id:
                    data = np.load(os.path.join(self.biasDir, filename))
                    self._loadedBiases[int(parts[0])] = data
                    fileLoaded = True
        if fileLoaded:
            self._totalBias = self._selfBias.copy()
            for data in self._loadedBiases.values():
                self._totalBias += data


class BiasVariable(object):
    """A collective variable for metadynamics (metadynamics.py:272)."""

    def __init__(self, force, minValue, maxValue, biasWidth, periodic=False,
                 gridWidth=None):
        self.force = force
        self.minValue = float(unit.strip(minValue))
        self.maxValue = float(unit.strip(maxValue))
        self.biasWidth = float(unit.strip(biasWidth))
        self.periodic = bool(periodic)
        if gridWidth is None:
            self.gridWidth = int(np.ceil(
                5 * (self.maxValue - self.minValue) / self.biasWidth))
        else:
            self.gridWidth = int(gridWidth)
