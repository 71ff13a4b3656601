"""PME parameter selection, B-spline moduli and the Ewald self energy.

Host-side numpy, counterpart of openmm_tpu/ops/pme.py (ewald_alpha,
pme_grid_size, find_legal_fft_dim, make_pme_recip_data, ewald_self_energy);
the formulas follow NonbondedForceImpl::calcPMEParameters.
"""
from __future__ import annotations

import math

import numpy as np

from ..constants import ONE_4PI_EPS0

SQRT_PI = math.sqrt(math.pi)


def ewald_alpha(cutoff: float, tol: float) -> float:
    return (1.0 / cutoff) * math.sqrt(-math.log(2.0 * tol))


def find_legal_fft_dim(minimum: int) -> int:
    """Smallest 2,3,5,7-smooth integer >= minimum."""
    n = int(minimum)
    while True:
        m = n
        for f in (2, 3, 5, 7):
            while m % f == 0:
                m //= f
        if m == 1:
            return n
        n += 1


def pme_grid_size(box_widths, alpha: float, tol: float):
    sizes = [max(int(math.ceil(2 * alpha * w / (3 * tol ** 0.2))), 6)
             for w in box_widths]
    return [find_legal_fft_dim(s) for s in sizes]


def _bspline_int_values(order: int) -> np.ndarray:
    """M_order(k) at k = 1..order-1 by the weight recursion at t = 0."""
    w = [0.0] * order
    w[0], w[1] = 1.0, 0.0
    for k in range(3, order + 1):
        div = 1.0 / (k - 1)
        new = [0.0] * order
        new[k - 1] = 0.0
        for j in range(1, k - 1):
            new[k - 1 - j] = div * (j * w[k - 2 - j] + (k - j) * w[k - 1 - j])
        new[0] = div * w[0]
        w[:k] = new[:k]
    return np.array([w[order - 1 - m] for m in range(1, order)])


def bspline_moduli(grid_size: int, order: int) -> np.ndarray:
    """1/|b(m)|^2 for one axis; near-zeros patched by neighbour averages."""
    mvals = _bspline_int_values(order)
    m = np.arange(grid_size)
    k = np.arange(1, order)
    denom = np.exp(2j * np.pi * np.outer(m, k) / grid_size) @ mvals
    mag2 = np.abs(denom) ** 2
    bsq = 1.0 / np.maximum(mag2, 1e-300)
    for i in np.where(mag2 < 1e-10)[0]:
        bsq[i] = 0.5 * (bsq[(i - 1) % grid_size] + bsq[(i + 1) % grid_size])
    return bsq


def make_pme_recip_data(grid, order: int) -> dict:
    """Per-axis moduli {"bsq_x", "bsq_y", "bsq_z"} as float64 numpy."""
    return {key: bspline_moduli(g, order)
            for key, g in zip(("bsq_x", "bsq_y", "bsq_z"), grid)}


def ewald_self_energy(charges: np.ndarray, alpha: float) -> float:
    """The Ewald self term, -k_e alpha / sqrt(pi) sum q^2 (constant)."""
    q = np.asarray(charges, np.float64)
    return float(-ONE_4PI_EPS0 * alpha / SQRT_PI * np.sum(q * q))
