"""Box vectors to and from lengths and angles (the port's copy of
openmm_tpu/app/unitcell.py, after OpenMM's
wrappers/python/openmm/app/internal/unitcell.py)."""
from __future__ import annotations

import math

import numpy as np

from .. import unit as u
from ..vec3 import Vec3


def computePeriodicBoxVectors(a_length, b_length, c_length, alpha, beta, gamma):
    """Reduced-form box vectors from lengths (nm) and angles (radians)."""
    a_length = float(u.strip(a_length, u.nanometer))
    b_length = float(u.strip(b_length, u.nanometer))
    c_length = float(u.strip(c_length, u.nanometer))
    alpha = float(u.strip(alpha, u.radian))
    beta = float(u.strip(beta, u.radian))
    gamma = float(u.strip(gamma, u.radian))

    if min(a_length, b_length, c_length) <= 0:
        raise ValueError("box lengths must be positive")
    a = np.array([a_length, 0, 0])
    b = np.array([b_length * math.cos(gamma), b_length * math.sin(gamma), 0])
    cx = c_length * math.cos(beta)
    cy = c_length * (math.cos(alpha) - math.cos(beta) * math.cos(gamma)) \
        / math.sin(gamma)
    cz = math.sqrt(max(c_length * c_length - cx * cx - cy * cy, 0.0))
    c = np.array([cx, cy, cz])
    # reduce (make the off-diagonal components as small as possible)
    c = c - b * round(c[1] / b[1])
    c = c - a * round(c[0] / a[0])
    b = b - a * round(b[0] / a[0])
    clean = [Vec3(*[0.0 if abs(x) < 1e-10 else float(x) for x in v])
             for v in (a, b, c)]
    return u.Quantity(tuple(clean), u.nanometer)


def computeLengthsAndAngles(periodicBoxVectors):
    """(a, b, c, alpha, beta, gamma) in nm / radians."""
    v = u.strip(periodicBoxVectors, u.nanometer)
    a, b, c = (np.asarray(x, float) for x in v)
    la = np.linalg.norm(a)
    lb = np.linalg.norm(b)
    lc = np.linalg.norm(c)
    alpha = math.acos(np.dot(b, c) / (lb * lc))
    beta = math.acos(np.dot(c, a) / (lc * la))
    gamma = math.acos(np.dot(a, b) / (la * lb))
    return (la, lb, lc, alpha, beta, gamma)
