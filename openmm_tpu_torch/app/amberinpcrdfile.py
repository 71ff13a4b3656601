"""Amber inpcrd / restart coordinate reader: the port's copy of
openmm_tpu/app/amberinpcrdfile.py (after
wrappers/python/openmm/app/amberinpcrdfile.py): ASCII restart with optional
velocities and box."""
from __future__ import annotations

import numpy as np

from .. import unit as u
from ..vec3 import Vec3
from . import unitcell

A2NM = 0.1
# Amber velocity unit: Angstrom / (1/20.455 ps)
VEL_SCALE = A2NM * 20.455


class AmberInpcrdFile(object):
    def __init__(self, file, loadVelocities=None, loadBoxVectors=None):
        with open(file) as f:
            lines = f.read().splitlines()
        # line 0: title; line 1: natoms [time]
        fields = lines[1].split()
        n = int(fields[0])
        numbers = []
        for line in lines[2:]:
            for i in range(0, len(line.rstrip()), 12):
                chunk = line[i:i + 12].strip()
                if chunk:
                    numbers.append(float(chunk))
        coords = np.asarray(numbers[:3 * n]).reshape(n, 3) * A2NM
        self.positions = u.Quantity([Vec3(*row) for row in coords],
                                    u.nanometer)
        rest = numbers[3 * n:]
        self.velocities = None
        self.boxVectors = None
        if len(rest) >= 3 * n:
            vel = np.asarray(rest[:3 * n]).reshape(n, 3) * VEL_SCALE
            self.velocities = u.Quantity([Vec3(*row) for row in vel],
                                         u.nanometer / u.picosecond)
            rest = rest[3 * n:]
        if len(rest) >= 6:
            a, b, c, alpha, beta, gamma = rest[:6]
            self.boxVectors = unitcell.computePeriodicBoxVectors(
                a * A2NM, b * A2NM, c * A2NM,
                np.radians(alpha), np.radians(beta), np.radians(gamma))
        elif len(rest) >= 3:
            self.boxVectors = unitcell.computePeriodicBoxVectors(
                rest[0] * A2NM, rest[1] * A2NM, rest[2] * A2NM,
                np.pi / 2, np.pi / 2, np.pi / 2)

    def getPositions(self, asNumpy=False):
        if asNumpy:
            return u.Quantity(
                np.asarray([[v.x, v.y, v.z] for v in self.positions._value]),
                u.nanometer)
        return self.positions

    def getVelocities(self, asNumpy=False):
        if self.velocities is None:
            return None
        if asNumpy:
            return u.Quantity(
                np.asarray([[v.x, v.y, v.z]
                            for v in self.velocities._value]),
                u.nanometer / u.picosecond)
        return self.velocities

    def getBoxVectors(self):
        return self.boxVectors
