"""PME parameter selection, B-spline moduli, the Ewald self energy, and
the differentiable dense reciprocal energy.

Counterpart of openmm_tpu/ops/pme.py. Host-side numpy: ewald_alpha,
pme_grid_size, find_legal_fft_dim, make_pme_recip_data, ewald_self_energy
(the formulas follow NonbondedForceImpl::calcPMEParameters). Torch:
bspline_weights, dense_weights, spread_charges_dense, _k_vectors and the
Coulomb branch of pme_reciprocal_energy, which autograd differentiates (the
minimizer's objective). The dense spread goes through ops/pallas_pme.py
(kernels 4 and 5); where the JAX module takes |F(Q)|^2 by matmul DFTs, a
TPU workaround, this module calls torch.fft (cuFFT on the card).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..constants import ONE_4PI_EPS0
from . import geometry as geom
from . import pallas_pme

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


def bspline_weights(t: torch.Tensor, order: int) -> torch.Tensor:
    """M_order(t + j) for j = 0..order-1 at fractional offsets t in [0, 1):
    (..., order) weights summing to 1; weight j belongs to grid point
    floor(u) + j - (order - 1)."""
    w = [1.0 - t, t] + [torch.zeros_like(t)] * (order - 2)
    for k in range(3, order + 1):
        div = 1.0 / (k - 1)
        new = [None] * k
        new[k - 1] = div * t * w[k - 2]
        for j in range(1, k - 1):
            new[k - 1 - j] = div * ((t + j) * w[k - 2 - j]
                                    + (k - j - t) * w[k - 1 - j])
        new[0] = div * (1.0 - t) * w[0]
        w[:k] = new
    return torch.stack(w, dim=-1)


def dense_weights(pos, charges, box_inv, grid, order):
    """Per-axis dense weight planes of the dense spread: A = q * Wx (N, nx),
    Wy (N, ny), Wz (N, nz), differentiable in pos (floor carries no
    gradient, as in the JAX module)."""
    frac = geom.to_fractional(pos, box_inv)
    frac = frac - torch.floor(frac)
    sizes = torch.tensor(grid, dtype=pos.dtype, device=pos.device)
    u = frac * sizes
    base = torch.floor(u)
    w = bspline_weights(u - base, order)                  # (N, 3, order)
    offs = torch.arange(order, device=pos.device) - (order - 1)
    base = base.long()

    def axis_weights(axis, n_axis):
        g = torch.remainder(base[:, axis:axis + 1] + offs, n_axis)
        plane = torch.zeros((pos.shape[0], n_axis), dtype=pos.dtype,
                            device=pos.device)
        return plane.scatter_add(1, g, w[:, axis])

    a = charges.to(pos.dtype)[:, None] * axis_weights(0, grid[0])
    return a, axis_weights(1, grid[1]), axis_weights(2, grid[2])


def spread_charges_dense(pos, charges, box_inv, grid, order, plain=False):
    """The (nx, ny, nz) charge grid of the dense spread. plain=False runs
    spread_triple (kernels 4 and 5 on a float32 CUDA tensor); plain=True
    runs the plain einsum on any device (the float64 oracle)."""
    nx, ny, nz = grid
    a, wy, wz = dense_weights(pos, charges, box_inv, grid, order)
    spread = pallas_pme.spread_triple_plain if plain \
        else pallas_pme.spread_triple
    return spread(a, wy, wz).reshape(nx, ny, nz)


def _k_vectors(grid, box_inv, dtype):
    """Reciprocal vectors m~ (no 2 pi) of every FFT bin, (nx, ny, nz, 3),
    with fftfreq wrapping: combinations of the columns of box_inv."""
    nx, ny, nz = grid
    dev = box_inv.device
    bi = box_inv.to(dtype)
    mx = torch.fft.fftfreq(nx, 1.0 / nx, dtype=dtype, device=dev)
    my = torch.fft.fftfreq(ny, 1.0 / ny, dtype=dtype, device=dev)
    mz = torch.fft.fftfreq(nz, 1.0 / nz, dtype=dtype, device=dev)
    return (mx[:, None, None, None] * bi[:, 0]
            + my[None, :, None, None] * bi[:, 1]
            + mz[None, None, :, None] * bi[:, 2])


def pme_reciprocal_energy(pos, charges, box, grid, order, alpha, bsq_x,
                          bsq_y, bsq_z, plain=False) -> torch.Tensor:
    """Coulomb reciprocal-space PME energy as a float64 scalar that
    autograd differentiates with respect to pos:
    E = k_e / (2 pi V) sum_{m != 0} exp(-pi^2 m^2 / alpha^2) / m^2 B(m)
    |F(Q)(m)|^2. The grid and its FFT take pos.dtype; the sum over the
    spectrum is taken in float64. `plain` as in spread_charges_dense."""
    f64 = torch.float64
    box64 = box.to(f64)
    q = spread_charges_dense(pos, charges,
                             geom.box_inverse(box.to(pos.dtype)), grid,
                             order, plain)
    fq = torch.fft.fftn(q)
    sq = (fq.real * fq.real + fq.imag * fq.imag).to(f64)
    kv = _k_vectors(grid, geom.box_inverse(box64), f64)
    m2 = (kv * kv).sum(dim=-1)
    m2_safe = torch.where(m2 > 0, m2, 1.0)
    kern = torch.where(m2 > 0, torch.exp(-(math.pi ** 2) * m2_safe
                                         / alpha ** 2) / m2_safe, 0.0)
    b = (bsq_x.to(f64)[:, None, None] * bsq_y.to(f64)[None, :, None]
         * bsq_z.to(f64)[None, None, :])
    return ONE_4PI_EPS0 / (2.0 * math.pi * geom.box_volume(box64)) \
        * torch.sum(kern * b * sq)
