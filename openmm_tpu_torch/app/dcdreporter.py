"""DCD trajectories: DCDFile writes CHARMM/NAMD-style DCD frames with
unit-cell records, DCDReporter writes one a report.

The port's copy of openmm_tpu/app/dcdreporter.py (after OpenMM's
wrappers/python/openmm/app/dcdfile.py and dcdreporter.py): the same bytes
as the JAX package's but for the date in the header. Positions and box
come from the port's plain State, in nm.
"""
from __future__ import annotations

import math
import struct
import time

import numpy as np

from .. import unit as u
from . import unitcell


class DCDFile(object):
    def __init__(self, file, topology, dt, firstStep=0, interval=1,
                 append=False):
        self._file = file
        self._topology = topology
        self._firstStep = firstStep
        self._interval = interval
        self._modelCount = 0
        self._dt = u.strip(dt, u.picosecond)
        if append:
            file.seek(8, 0)
            self._modelCount = struct.unpack("<i", file.read(4))[0]
        else:
            self._writeHeader()

    def _writeHeader(self):
        f = self._file
        # AKMA time units: 1 ps = 20.45482949774598 AKMA
        akma_dt = self._dt * 20.45482949774598
        header = struct.pack("<i4c9if", 84, b"C", b"O", b"R", b"D", 0,
                             self._firstStep, self._interval, 0, 0, 0, 0, 0, 0,
                             akma_dt)
        header += struct.pack("<13i", 1, 0, 0, 0, 0, 0, 0, 0, 0, 24, 84, 164,
                              2)
        header += struct.pack("<80s", b"Created by openmm-tpu")
        header += struct.pack("<80s", b"Created " + time.asctime().encode())
        header += struct.pack("<4i", 164, 4,
                              self._topology.getNumAtoms(), 4)
        f.write(header)

    def writeModel(self, positions, unitCellDimensions=None,
                   periodicBoxVectors=None):
        pos = np.asarray(u.strip(positions, u.nanometer), float)
        n = len(pos)
        f = self._file
        self._modelCount += 1
        # update frame count in header
        f.seek(8, 0)
        f.write(struct.pack("<i", self._modelCount))
        f.seek(20, 0)
        f.write(struct.pack("<i", self._firstStep
                            + self._modelCount * self._interval))
        f.seek(0, 2)
        # unit cell record
        box = periodicBoxVectors
        if box is None and unitCellDimensions is not None:
            d = u.strip(unitCellDimensions, u.nanometer)
            box = u.Quantity(((d[0], 0, 0), (0, d[1], 0), (0, 0, d[2])),
                             u.nanometer)
        if box is None:
            box = self._topology.getPeriodicBoxVectors()
        if box is not None:
            a, b, c, alpha, beta, gamma = unitcell.computeLengthsAndAngles(box)
            # CHARMM unit-cell record ordering: a, gamma, b, beta, alpha, c
            f.write(struct.pack("<i6di", 48, a * 10, gamma * 180 / math.pi,
                                b * 10, beta * 180 / math.pi,
                                alpha * 180 / math.pi, c * 10, 48))
        ang = pos * 10.0  # nm -> angstrom
        length = struct.pack("<i", 4 * n)
        for axis in range(3):
            f.write(length)
            f.write(ang[:, axis].astype("<f4").tobytes())
            f.write(length)
        try:
            f.flush()
        except AttributeError:
            pass


class DCDReporter(object):
    def __init__(self, file, reportInterval, append=False,
                 enforcePeriodicBox=None):
        self._reportInterval = reportInterval
        self._append = append
        self._enforcePeriodicBox = enforcePeriodicBox
        self._out = open(file, "r+b" if append else "wb")
        self._dcd = None

    def describeNextReport(self, simulation):
        steps = self._reportInterval - simulation.currentStep % self._reportInterval
        return (steps, True, False, False, False, self._enforcePeriodicBox)

    def report(self, simulation, state):
        if self._dcd is None:
            self._dcd = DCDFile(self._out, simulation.topology,
                                simulation.integrator.getStepSize(),
                                simulation.currentStep, self._reportInterval,
                                self._append)
        self._dcd.writeModel(
            state.getPositions(),
            periodicBoxVectors=state.getPeriodicBoxVectors())

    def __del__(self):
        try:
            self._out.close()
        except Exception:
            pass
