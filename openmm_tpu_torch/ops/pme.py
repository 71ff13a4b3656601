"""PME parameter selection, B-spline moduli, the Ewald self energy, the
differentiable dense reciprocal energy, and the exact Ewald k-sum.

Counterpart of openmm_tpu/ops/pme.py. Host-side numpy: ewald_alpha,
ewald_kmax, pme_grid_size, find_legal_fft_dim, make_pme_recip_data,
ewald_self_energy (the formulas follow
NonbondedForceImpl::calcEwaldParameters and calcPMEParameters). Torch:
ewald_reciprocal_ef and ewald_reciprocal_energy, the structure-factor sum
of NonbondedForce.Ewald in float64 (the JAX module pins its products to
HIGHEST precision, since a truncated phase k.r of up to ~10^2 rad put the
TPU's sum 1.4 % off; here no product of the sum goes through a tensor
core); and
bspline_weights, dense_weights, spread_charges_dense, _k_vectors and
pme_reciprocal_energy (the Coulomb grid, and LJPME's dispersion grid
with coulomb=False), which autograd differentiates (the minimizer's
objective); dispersion_self_energy, LJPME's self term. The dense spread
goes through ops/pallas_pme.py (kernels 4 and 5); where the JAX module
takes |F(Q)|^2 by matmul DFTs, a TPU workaround, this module calls
torch.fft (cuFFT on the card).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..constants import ONE_4PI_EPS0
from . import geometry as geom
from . import pallas_pme
from .pairs import AnalyticEnergy

SQRT_PI = math.sqrt(math.pi)


def ewald_alpha(cutoff: float, tol: float) -> float:
    return (1.0 / cutoff) * math.sqrt(-math.log(2.0 * tol))


def ewald_kmax(box_widths, alpha: float, tol: float) -> list:
    """kmax per axis: the smallest k whose error estimate is within tol,
    made odd (NonbondedForceImpl::calcEwaldParameters)."""
    out = []
    for width in box_widths:
        def err(k):
            temp = k * math.pi / (width * alpha)
            return tol - 0.05 * math.sqrt(width * alpha) * k * math.exp(
                -temp * temp)
        k = 10
        if err(k) > 0:
            while err(k) > 0 and k > 0:
                k -= 1
            k += 1
        else:
            while err(k) < 0:
                k += 1
        if k % 2 == 0:
            k += 1
        out.append(k)
    return out


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


def pme_grid_size(box_widths, alpha: float, tol: float, lj=False):
    """The grid of NonbondedForceImpl::calcPMEParameters; lj=True the
    dispersion grid's (half as fine for the same alpha)."""
    factor = 1.0 if lj else 2.0
    sizes = [max(int(math.ceil(factor * alpha * w / (3 * tol ** 0.2))), 6)
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


def dispersion_self_energy(c6s: np.ndarray, alpha: float) -> float:
    """LJPME's self term, alpha^6 / 12 sum c6_i^2 (JAX pme.py:516-520)."""
    c6 = np.asarray(c6s, np.float64)
    return float(alpha ** 6 / 12.0 * np.sum(c6 * c6))


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


def dispersion_green(m2, alpha, vol):
    """LJPME's dispersion kernel with its prefactor at |m|^2 = m2 (JAX
    pme.py:455-476, after pme.cc:396-431): -(pi sqrt(pi) / 6 V) [2 pi^3
    sqrt(pi) |m|^3 erfc(pi |m| / alpha) + e^-(pi |m| / alpha)^2 (alpha^3
    - 2 alpha pi^2 |m|^2)], the m = 0 term (alpha^3) included."""
    m_abs = torch.sqrt(m2)
    b = math.pi * m_abs / alpha
    eterm = (2.0 * math.pi ** 3 * SQRT_PI * torch.special.erfc(b) * m_abs
             * m2 + torch.exp(-b * b) * (alpha ** 3 - 2.0 * alpha
                                         * math.pi ** 2 * m2))
    return -0.5 * (2.0 * math.pi / 6.0) * SQRT_PI / vol * eterm


def pme_reciprocal_energy(pos, charges, box, grid, order, alpha, bsq_x,
                          bsq_y, bsq_z, plain=False,
                          coulomb=True) -> torch.Tensor:
    """Reciprocal-space PME energy as a float64 scalar that autograd
    differentiates with respect to pos. Coulomb:
    E = k_e / (2 pi V) sum_{m != 0} exp(-pi^2 m^2 / alpha^2) / m^2 B(m)
    |F(Q)(m)|^2. coulomb=False: LJPME's dispersion energy of the grid of
    c6 weights `charges`, sum_m (m = 0 included) of the dispersion kernel
    (dispersion_green) B(m) |F(Q)(m)|^2. The
    grid and its FFT take pos.dtype; the sum over the spectrum is taken in
    float64. `plain` as in spread_charges_dense."""
    f64 = torch.float64
    box64 = box.to(f64)
    q = spread_charges_dense(pos, charges,
                             geom.box_inverse(box.to(pos.dtype)), grid,
                             order, plain)
    fq = torch.fft.fftn(q)
    sq = (fq.real * fq.real + fq.imag * fq.imag).to(f64)
    kv = _k_vectors(grid, geom.box_inverse(box64), f64)
    m2 = (kv * kv).sum(dim=-1)
    b = (bsq_x.to(f64)[:, None, None] * bsq_y.to(f64)[None, :, None]
         * bsq_z.to(f64)[None, None, :])
    if not coulomb:
        return torch.sum(dispersion_green(m2, alpha, geom.box_volume(box64))
                         * b * sq)
    m2_safe = torch.where(m2 > 0, m2, 1.0)
    kern = torch.where(m2 > 0, torch.exp(-(math.pi ** 2) * m2_safe
                                         / alpha ** 2) / m2_safe, 0.0)
    return ONE_4PI_EPS0 / (2.0 * math.pi * geom.box_volume(box64)) \
        * torch.sum(kern * b * sq)


def ewald_m_vectors(kmax) -> np.ndarray:
    """(K, 3) integer reciprocal indices of the symmetric k-box,
    |m_axis| < kmax_axis, without m = 0, in the JAX module's order."""
    axes = [np.arange(-(k - 1), k) for k in kmax]
    m = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)
    return m[np.any(m != 0, axis=1)].astype(np.float64)


# (atoms x k-vectors) elements a chunk of the k-sum
EWALD_CHUNK = 1 << 21


def ewald_reciprocal_ef(pos, charges, box, m_vectors, alpha):
    """The Ewald reciprocal energy and forces, float64:
    E = k_e (2 pi / V) sum_k exp(-k^2 / 4 alpha^2) / k^2 |S(k)|^2 over the
    k = 2 pi m box^-T of `m_vectors` (ewald_m_vectors), with
    S(k) = sum_j q_j exp(i k.r_j), and
    F_i = -2 k_e (2 pi / V) q_i sum_k w_k k (Im S cos k.r_i - Re S sin k.r_i).
    Rows of atoms go in chunks through dense (atoms x k-vectors) products:
    a first pass sums S, a second the forces. Every sum is a reduction
    over a tensor axis, so the bits are the same on every call."""
    f64 = torch.float64
    pos = pos.to(f64)
    q = charges.to(f64)
    binv = geom.box_inverse(box.to(f64))
    m = m_vectors.to(f64)
    kvec = 2.0 * math.pi * (m[:, 0:1] * binv[:, 0] + m[:, 1:2] * binv[:, 1]
                            + m[:, 2:3] * binv[:, 2])          # (K, 3)
    k2 = (kvec * kvec).sum(dim=-1)
    w = torch.exp(-k2 / (4.0 * alpha * alpha)) / k2
    rows = max(1, EWALD_CHUNK // max(m.shape[0], 1))
    chunks = [(r0, min(pos.shape[0], r0 + rows))
              for r0 in range(0, pos.shape[0], rows)]

    def phases(r0, r1):
        p = pos[r0:r1]
        theta = (p[:, 0:1] * kvec[:, 0] + p[:, 1:2] * kvec[:, 1]
                 + p[:, 2:3] * kvec[:, 2])
        return torch.cos(theta), torch.sin(theta)

    s_re = torch.zeros_like(k2)
    s_im = torch.zeros_like(k2)
    for r0, r1 in chunks:
        c, s = phases(r0, r1)
        s_re = s_re + (q[r0:r1, None] * c).sum(dim=0)
        s_im = s_im + (q[r0:r1, None] * s).sum(dim=0)
    scale = ONE_4PI_EPS0 * 2.0 * math.pi / geom.box_volume(box.to(f64))
    energy = scale * (w * (s_re * s_re + s_im * s_im)).sum()
    a, b = w * s_im, w * s_re
    forces = []
    for r0, r1 in chunks:
        c, s = phases(r0, r1)
        g = c * a - s * b                                       # (rows, K)
        f = torch.stack([(g * kvec[:, 0]).sum(dim=1),
                         (g * kvec[:, 1]).sum(dim=1),
                         (g * kvec[:, 2]).sum(dim=1)], dim=1)
        forces.append(-2.0 * scale * q[r0:r1, None] * f)
    return energy, torch.cat(forces)


def ewald_reciprocal_deriv(pos, charges, dcharges, box, m_vectors, alpha):
    """dE/dlambda of ewald_reciprocal_ef's energy at fixed positions,
    given the charges' derivatives in lambda: 2 k_e (2 pi / V) sum_k w_k
    Re(S(k) conj(dS(k))), float64."""
    f64 = torch.float64
    pos = pos.to(f64)
    q = charges.to(f64)
    dq = dcharges.to(f64)
    binv = geom.box_inverse(box.to(f64))
    m = m_vectors.to(f64)
    kvec = 2.0 * math.pi * (m[:, 0:1] * binv[:, 0] + m[:, 1:2] * binv[:, 1]
                            + m[:, 2:3] * binv[:, 2])
    k2 = (kvec * kvec).sum(dim=-1)
    w = torch.exp(-k2 / (4.0 * alpha * alpha)) / k2
    rows = max(1, EWALD_CHUNK // max(m.shape[0], 1))
    s = torch.zeros((4, k2.shape[0]), dtype=f64, device=pos.device)
    for r0 in range(0, pos.shape[0], rows):
        p = pos[r0:r0 + rows]
        theta = (p[:, 0:1] * kvec[:, 0] + p[:, 1:2] * kvec[:, 1]
                 + p[:, 2:3] * kvec[:, 2])
        c, sn = torch.cos(theta), torch.sin(theta)
        s = s + torch.stack([(q[r0:r0 + rows, None] * c).sum(dim=0),
                             (q[r0:r0 + rows, None] * sn).sum(dim=0),
                             (dq[r0:r0 + rows, None] * c).sum(dim=0),
                             (dq[r0:r0 + rows, None] * sn).sum(dim=0)])
    scale = ONE_4PI_EPS0 * 2.0 * math.pi / geom.box_volume(box.to(f64))
    return 2.0 * scale * (w * (s[0] * s[2] + s[1] * s[3])).sum()


def ewald_reciprocal_energy(pos, charges, box, m_vectors, alpha):
    """The Ewald reciprocal energy, differentiable in pos through the
    forces of ewald_reciprocal_ef."""
    return AnalyticEnergy.apply(ewald_reciprocal_ef, pos, charges, box,
                                m_vectors, alpha)
