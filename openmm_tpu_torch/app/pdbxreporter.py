"""PDBx/mmCIF trajectory reporter: the port's copy of
openmm_tpu/app/pdbxreporter.py (after app/pdbxfile.py's
PDBxReporter)."""
from __future__ import annotations

from .pdbxfile import PDBxFile


class PDBxReporter(object):
    def __init__(self, file, reportInterval, enforcePeriodicBox=None):
        self._reportInterval = reportInterval
        self._enforcePeriodicBox = enforcePeriodicBox
        self._out = open(file, "w")
        self._nextModel = 1
        self._headerWritten = False

    def describeNextReport(self, simulation):
        steps = self._reportInterval - simulation.currentStep % self._reportInterval
        return (steps, True, False, False, False, self._enforcePeriodicBox)

    def report(self, simulation, state):
        if not self._headerWritten:
            PDBxFile.writeHeader(simulation.topology, self._out)
            self._headerWritten = True
        PDBxFile.writeModel(simulation.topology,
                            state.getPositions(asNumpy=True),
                            self._out, self._nextModel)
        self._nextModel += 1
        self._out.flush()

    def __del__(self):
        try:
            self._out.close()
        except Exception:
            pass
