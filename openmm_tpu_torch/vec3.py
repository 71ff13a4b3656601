"""Vec3: a 3-vector named tuple (the port's copy of openmm_tpu/vec3.py,
OpenMM's openmmapi/include/openmm/Vec3.h and wrappers/python/openmm/vec3.py)."""
from __future__ import annotations

from collections import namedtuple

from . import unit as _unit


class Vec3(namedtuple("Vec3", ["x", "y", "z"])):
    """A 3-component vector supporting elementwise arithmetic."""

    __slots__ = ()

    def __new__(cls, x, y, z):
        return tuple.__new__(cls, (x, y, z))

    def __add__(self, other):
        return Vec3(self.x + other[0], self.y + other[1], self.z + other[2])

    __radd__ = __add__

    def __sub__(self, other):
        return Vec3(self.x - other[0], self.y - other[1], self.z - other[2])

    def __rsub__(self, other):
        return Vec3(other[0] - self.x, other[1] - self.y, other[2] - self.z)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)

    def __mul__(self, other):
        if isinstance(other, Vec3):
            return Vec3(self.x * other.x, self.y * other.y, self.z * other.z)
        if _unit.is_unit(other):
            return _unit.Quantity(self, other)
        return Vec3(self.x * other, self.y * other, self.z * other)

    def __rmul__(self, other):
        if _unit.is_unit(other):
            return _unit.Quantity(self, other)
        return Vec3(other * self.x, other * self.y, other * self.z)

    def __truediv__(self, other):
        if _unit.is_unit(other):
            return _unit.Quantity(self, other ** -1)
        return Vec3(self.x / other, self.y / other, self.z / other)

    def __abs__(self):
        return (self.x * self.x + self.y * self.y + self.z * self.z) ** 0.5

    def dot(self, other):
        return self.x * other[0] + self.y * other[1] + self.z * other[2]

    def cross(self, other):
        return Vec3(self.y * other[2] - self.z * other[1],
                    self.z * other[0] - self.x * other[2],
                    self.x * other[1] - self.y * other[0])

    def __repr__(self):
        return "Vec3(x=%r, y=%r, z=%r)" % (self.x, self.y, self.z)
