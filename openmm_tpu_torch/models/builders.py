"""Programmatic system builders.

Counterpart of openmm_tpu/models/builders.py: the same TIP3P water box,
built with numpy from the same np.random.RandomState(jitter_seed) stream,
so that the arrays are identical to the JAX builder's for the same seed.
"""
from __future__ import annotations

import math

import numpy as np

from ..forces.nonbonded import NonbondedForce
from ..system import System

# TIP3P parameters (tip3p.xml)
TIP3P_O_CHARGE = -0.834
TIP3P_H_CHARGE = 0.417
TIP3P_O_SIGMA = 0.31507524065751241
TIP3P_O_EPSILON = 0.635968
TIP3P_OH_DISTANCE = 0.09572
TIP3P_ANGLE = 104.52 * math.pi / 180.0
WATER_NUMBER_DENSITY = 33.37  # molecules / nm^3 at ~300 K
O_MASS, H_MASS = 15.99943, 1.007947


def tip3p_water_box(n_waters=216, cutoff=0.9, constraints=True,
                    jitter_seed=1234):
    """A cubic PME TIP3P box on a jittered lattice with random molecule
    orientations at liquid density. The count is rounded up to a cube.
    Returns (system, positions as an (n, 3) float64 array in nm)."""
    n_side = int(round(n_waters ** (1.0 / 3.0)))
    while n_side ** 3 < n_waters:
        n_side += 1
    n_waters = n_side ** 3
    box_l = (n_waters / WATER_NUMBER_DENSITY) ** (1.0 / 3.0)
    spacing = box_l / n_side

    system = System()
    system.setDefaultPeriodicBoxVectors([box_l, 0, 0], [0, box_l, 0],
                                        [0, 0, box_l])
    nb = NonbondedForce()
    nb.setNonbondedMethod(NonbondedForce.PME)
    nb.setCutoffDistance(min(cutoff, 0.49 * box_l))
    nb.setUseDispersionCorrection(True)
    system.addForce(nb)

    d_oh, theta = TIP3P_OH_DISTANCE, TIP3P_ANGLE
    d_hh = 2.0 * d_oh * math.sin(0.5 * theta)
    ref = np.array([[0.0, 0.0, 0.0], [d_oh, 0.0, 0.0],
                    [d_oh * math.cos(theta), d_oh * math.sin(theta), 0.0]])
    rng = np.random.RandomState(jitter_seed)
    positions = []
    for ix in range(n_side):
        for iy in range(n_side):
            for iz in range(n_side):
                o = system.addParticle(O_MASS)
                h1 = system.addParticle(H_MASS)
                h2 = system.addParticle(H_MASS)
                nb.addParticle(TIP3P_O_CHARGE, TIP3P_O_SIGMA, TIP3P_O_EPSILON)
                nb.addParticle(TIP3P_H_CHARGE, 1.0, 0.0)
                nb.addParticle(TIP3P_H_CHARGE, 1.0, 0.0)
                nb.addException(o, h1, 0.0, 1.0, 0.0)
                nb.addException(o, h2, 0.0, 1.0, 0.0)
                nb.addException(h1, h2, 0.0, 1.0, 0.0)
                if constraints:
                    system.addConstraint(o, h1, d_oh)
                    system.addConstraint(o, h2, d_oh)
                    system.addConstraint(h1, h2, d_hh)
                base = (np.array([ix, iy, iz], float) + 0.5) * spacing \
                    + (rng.rand(3) - 0.5) * 0.02
                axis = rng.randn(3)
                axis /= np.linalg.norm(axis)
                ang = rng.rand() * 2 * math.pi
                c, s = math.cos(ang), math.sin(ang)
                k = np.array([[0, -axis[2], axis[1]],
                              [axis[2], 0, -axis[0]],
                              [-axis[1], axis[0], 0]])
                rot = np.eye(3) + s * k + (1 - c) * (k @ k)
                positions.append(ref @ rot.T + base)
    return system, np.concatenate(positions)
