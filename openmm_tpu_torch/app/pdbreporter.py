"""PDBReporter: a PDB trajectory, one MODEL a report (the port's copy of
openmm_tpu/app/pdbreporter.py, after OpenMM's app/pdbreporter.py)."""
from __future__ import annotations

from .pdbfile import PDBFile


class PDBReporter(object):
    def __init__(self, file, reportInterval, enforcePeriodicBox=None):
        self._reportInterval = reportInterval
        self._enforcePeriodicBox = enforcePeriodicBox
        self._out = open(file, "w")
        self._topology = None
        self._nextModel = 0

    def describeNextReport(self, simulation):
        steps = self._reportInterval - simulation.currentStep % self._reportInterval
        return (steps, True, False, False, False, self._enforcePeriodicBox)

    def report(self, simulation, state):
        if self._nextModel == 0:
            PDBFile.writeHeader(simulation.topology, self._out)
            self._topology = simulation.topology
            self._nextModel += 1
        PDBFile.writeModel(simulation.topology,
                           state.getPositions(asNumpy=True),
                           self._out, self._nextModel)
        self._nextModel += 1
        try:
            self._out.flush()
        except AttributeError:
            pass

    def __del__(self):
        if self._topology is not None:
            PDBFile.writeFooter(self._topology, self._out)
        self._out.close()
