"""GROMACS .gro coordinate file reader: the port's copy of
openmm_tpu/app/gromacsgrofile.py (after
wrappers/python/openmm/app/gromacsgrofile.py): fixed-column coordinates with
optional velocities and the box line (3 or 9 components)."""
from __future__ import annotations

import numpy as np

from .. import unit as u
from ..vec3 import Vec3
from .element import Element
from .pdbfile import _guess_element
from .topology import Topology


class GromacsGroFile(object):
    def __init__(self, file):
        with open(file) as f:
            lines = f.read().splitlines()
        n = int(lines[1].split()[0])
        self.elements = []
        self.atomNames = []
        self.residueNames = []
        self.residueIds = []
        positions = []
        velocities = []
        has_vel = None
        for line in lines[2:2 + n]:
            res_id = line[0:5].strip()
            res_name = line[5:10].strip()
            atom_name = line[10:15].strip()
            x = float(line[20:28])
            y = float(line[28:36])
            z = float(line[36:44])
            positions.append(Vec3(x, y, z))
            if has_vel is None:
                has_vel = len(line.rstrip()) >= 68
            if has_vel:
                velocities.append(Vec3(float(line[44:52]), float(line[52:60]),
                                       float(line[60:68])))
            self.residueIds.append(res_id)
            self.residueNames.append(res_name)
            self.atomNames.append(atom_name)
            self.elements.append(_guess_element(atom_name, res_name))
        box_fields = [float(x) for x in lines[2 + n].split()]
        if len(box_fields) >= 9:
            (ax, by, cz, ay, az, bx, bz, cx, cy) = box_fields[:9]
            box = ((ax, ay, az), (bx, by, bz), (cx, cy, cz))
        else:
            box = ((box_fields[0], 0, 0), (0, box_fields[1], 0),
                   (0, 0, box_fields[2]))
        self._box = box
        self.positions = u.Quantity(positions, u.nanometer)
        self.velocities = (u.Quantity(velocities,
                                      u.nanometer / u.picosecond)
                           if has_vel else None)
        # topology
        top = Topology()
        chain = top.addChain()
        last = None
        residue = None
        for i in range(n):
            key = (self.residueIds[i], self.residueNames[i])
            if key != last:
                residue = top.addResidue(self.residueNames[i], chain,
                                         self.residueIds[i])
                last = key
            top.addAtom(self.atomNames[i], self.elements[i], residue)
        top.setPeriodicBoxVectors(u.Quantity(
            tuple(Vec3(*v) for v in box), u.nanometer))
        self.topology = top

    def getPositions(self, asNumpy=False):
        if asNumpy:
            return u.Quantity(np.asarray(
                [[v.x, v.y, v.z] for v in self.positions._value]), u.nanometer)
        return self.positions

    def getVelocities(self, asNumpy=False):
        if self.velocities is None:
            return None
        if asNumpy:
            return u.Quantity(np.asarray(
                [[v.x, v.y, v.z] for v in self.velocities._value]),
                u.nanometer / u.picosecond)
        return self.velocities

    def getPeriodicBoxVectors(self):
        return self.topology.getPeriodicBoxVectors()

    def getUnitCellDimensions(self):
        return self.topology.getUnitCellDimensions()
