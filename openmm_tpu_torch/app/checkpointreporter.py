"""CheckpointReporter: a checkpoint every reportInterval steps, written
through a temporary file and a rename (the port's copy of
openmm_tpu/app/checkpointreporter.py, after OpenMM's
app/checkpointreporter.py:73,106). writeState=True needs XmlSerializer,
which waits for ROADMAP item 8, and raises when it reports."""
from __future__ import annotations

import os


class CheckpointReporter(object):
    def __init__(self, file, reportInterval, writeState=False):
        self._reportInterval = reportInterval
        self._file = file
        self._writeState = bool(writeState)

    def describeNextReport(self, simulation):
        steps = self._reportInterval - simulation.currentStep % self._reportInterval
        return (steps, False, False, False, False)

    def report(self, simulation, state):
        if isinstance(self._file, str):
            tmp = self._file + ".tmp"
            if self._writeState:
                simulation.saveState(tmp)
            else:
                simulation.saveCheckpoint(tmp)
            os.replace(tmp, self._file)
        else:
            self._file.seek(0)
            if self._writeState:
                simulation.saveState(self._file)
            else:
                simulation.saveCheckpoint(self._file)
            self._file.truncate()
