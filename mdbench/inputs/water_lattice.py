"""A cubic box of rigid TIP3P water on a jittered lattice at liquid density,
with random orientations drawn from the seed: the tables (numpy arrays)
from which the benchmark builds the program's System and its reference.

A frozen copy of the lattice of the port's
models/builders.py:tip3p_water_box (the same density, spacing, jitter of
+-0.01 nm and uniformly random rotations), with every draw from
numpy.random.default_rng(seed), so that any whole-number seed gives a box
of the same size. The parameters are amber14's TIP3P (tip3p.xml).
"""
from __future__ import annotations

import math

import numpy as np

O_CHARGE, H_CHARGE = -0.834, 0.417
O_SIGMA, O_EPSILON = 0.31507524065751241, 0.635968
OH_DISTANCE = 0.09572
HOH_ANGLE = 104.52 * math.pi / 180.0
O_MASS, H_MASS = 15.99943, 1.007947
NUMBER_DENSITY = 33.37            # molecules / nm^3 at ~300 K


def _rotations(rng, count):
    """`count` rotation matrices about uniformly random axes by uniformly
    random angles (Rodrigues' formula)."""
    axis = rng.standard_normal((count, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    ang = rng.random(count) * 2.0 * math.pi
    c, s = np.cos(ang), np.sin(ang)
    k = np.zeros((count, 3, 3))
    k[:, 0, 1], k[:, 0, 2] = -axis[:, 2], axis[:, 1]
    k[:, 1, 0], k[:, 1, 2] = axis[:, 2], -axis[:, 0]
    k[:, 2, 0], k[:, 2, 1] = -axis[:, 1], axis[:, 0]
    return (np.eye(3)[None] + s[:, None, None] * k
            + (1.0 - c)[:, None, None] * (k @ k))


def build(config: dict, seed: int) -> dict:
    """The tables of config["n_waters"] waters (rounded up to a cube)."""
    n_side = int(round(config["n_waters"] ** (1.0 / 3.0)))
    while n_side ** 3 < config["n_waters"]:
        n_side += 1
    n_waters = n_side ** 3
    box_l = (n_waters / NUMBER_DENSITY) ** (1.0 / 3.0)
    spacing = box_l / n_side
    rng = np.random.default_rng([seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF])
    cells = np.stack(np.meshgrid(*(np.arange(n_side),) * 3, indexing="ij"),
                     axis=-1).reshape(-1, 3).astype(float)
    base = (cells + 0.5) * spacing + (rng.random((n_waters, 3)) - 0.5) * 0.02
    ref = np.array([[0.0, 0.0, 0.0], [OH_DISTANCE, 0.0, 0.0],
                    [OH_DISTANCE * math.cos(HOH_ANGLE),
                     OH_DISTANCE * math.sin(HOH_ANGLE), 0.0]])
    rot = _rotations(rng, n_waters)
    positions = (np.einsum("ak,wjk->waj", ref, rot)
                 + base[:, None, :]).reshape(-1, 3)

    first = 3 * np.arange(n_waters)
    hh = 2.0 * OH_DISTANCE * math.sin(0.5 * HOH_ANGLE)
    pairs = np.stack([np.stack([first, first + 1], 1),
                      np.stack([first, first + 2], 1),
                      np.stack([first + 1, first + 2], 1)], 1).reshape(-1, 2)
    return {
        "masses": np.tile([O_MASS, H_MASS, H_MASS], n_waters),
        "charges": np.tile([O_CHARGE, H_CHARGE, H_CHARGE], n_waters),
        "sigma": np.tile([O_SIGMA, 1.0, 1.0], n_waters),
        "epsilon": np.tile([O_EPSILON, 0.0, 0.0], n_waters),
        "exception_pairs": pairs,
        "exception_params": np.tile([0.0, 1.0, 0.0], (len(pairs), 1)),
        "constraint_pairs": pairs,
        "constraint_distances": np.tile([OH_DISTANCE, OH_DISTANCE, hh],
                                        n_waters),
        "box": np.diag([box_l] * 3),
        "positions": positions,
        "molecules": [("HOH", 3, n_waters)],
        "cutoff": float(config["cutoff_nm"]),
        "ewald_tolerance": float(config["ewald_tolerance"]),
        "dispersion_correction": bool(config["dispersion_correction"]),
        "cmm_frequency": int(config["cmm_frequency"]),
    }
