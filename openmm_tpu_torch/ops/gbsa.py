"""Generalized Born implicit solvent (OBC-II) with the ACE surface term,
over every pair of atoms.

Counterpart of the energy_fn of openmm_tpu/forces/gbsa.py (after
ReferenceObc.cpp): Born radii from the HCT pairwise integral rescaled by
OBC-II's tanh (alpha, beta, gamma = 1.0, 0.8, 4.85, dielectric offset
0.009 nm); the GB energy pre q_i q_j / f_ij over the pairs (shifted by
-pre q_i q_j / rc with a cutoff) and the self terms pre q_i^2 / (2 B_i)
(not shifted), with pre = -ONE_4PI_EPS0 (1/eps_solute - 1/eps_solvent)
and f_ij = sqrt(r^2 + B_i B_j exp(-r^2 / (4 B_i B_j))); the ACE term
4 pi Esa (R_i + 0.14)^2 (R_i / B_i)^6. A cutoff applies to both the
integral and the pair energy (r^2 < rc^2); a box, to both, by minimum
images.

Two entry points:
- gbsa_energy: the energy alone in torch operations that autograd
  differentiates (the minimizer's objective, a barostat's trial energy).
  The JAX package takes its forces this way, by jax.grad.
- gbsa_energy_forces: energy and forces analytically, in three sweeps
  as ReferenceObc.cpp has them: (1) the HCT sums and the Born radii;
  (2) the pair and self energies, the forces at fixed radii, and dE/dB_i
  (the ACE term's -6 sa_i / B_i included); (3) the chain rule through
  the radii, pair by pair, with the HCT integral's derivative taken
  region by region so that its branches are the energy's.

Both take each atom's row of partners in chunks (ops/pairs.py's idiom):
every pair is seen from both of its atoms, so each per-atom sum is a row
sum in a fixed order and nothing is scattered (float atomics would change
the bits from run to run on a card, and the step program is held bit for
bit against the eager loop). The pair arithmetic runs in pos.dtype
(float32 under "mixed", float64 under "double") and every row sum in
float64; the per-atom quantities (Born radii, their chain factors, the
self and ACE terms) are float64. r^2 is taken product by product and sum
by sum, so that a pair at the cutoff is counted the same way everywhere.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..constants import ONE_4PI_EPS0
from . import geometry as geom
from .pairs import _row_chunks

DIELECTRIC_OFFSET = 0.009
ALPHA_OBC = 1.0
BETA_OBC = 0.8
GAMMA_OBC = 4.85
PROBE_RADIUS = 0.14
F64 = torch.float64


class GBTerms(NamedTuple):
    """The settings of one GBSAOBCForce: pre_factor = -ONE_4PI_EPS0
    (1/eps_solute - 1/eps_solvent); pi4asolv = 4 pi Esa (kJ/mol/nm^2);
    cutoff None (every pair) or nm."""
    pre_factor: float
    pi4asolv: float
    cutoff: float | None = None


def gb_terms(solute, solvent, surface_energy, cutoff=None) -> GBTerms:
    return GBTerms(-ONE_4PI_EPS0 * (1.0 / solute - 1.0 / solvent),
                   4.0 * math.pi * surface_energy, cutoff)


def _rows(pos, r0, r1, box, cutoff):
    """(displacements (rows, n, 3), r^2, keep) of atoms r0:r1 against
    every atom; keep: another atom, within the cutoff."""
    n = pos.shape[0]
    d = pos[r0:r1, None, :] - pos[None, :, :]
    if box is not None:
        d = geom.periodic_delta(d, box)
    dx, dy, dz = d.unbind(-1)
    r2 = dx * dx + dy * dy + dz * dz
    keep = (torch.arange(r0, r1, device=pos.device)[:, None]
            != torch.arange(n, device=pos.device)[None, :])
    if cutoff is not None:
        keep = keep & (r2 < cutoff * cutoff)
    return d, r2, keep


def _hct_regions(r2, keep, rho, sr):
    """Where the pairs (r^2, keep) seen from atoms of offset radius rho
    against spheres of scaled radius sr (broadcast) fall in the HCT
    integral: (contributes, r (1 where a pair does not contribute),
    1/L, 1/U, inside), L = max(rho, |r - sr|), U = r + sr, in the JAX
    package's operations and order."""
    r = torch.sqrt(torch.where(keep, r2, 1.0))
    r_sr = r + sr
    contributes = keep & (rho < r_sr)
    r = torch.where(contributes, r, 1.0)
    inv_l = 1.0 / torch.maximum(rho, torch.abs(r - sr))
    inv_u = 1.0 / torch.where(contributes, r_sr, 1.0)
    inside = contributes & (rho < (sr - r))
    return contributes, r, inv_l, inv_u, inside


def _hct_term(r2, keep, rho, sr):
    """The HCT integral's term of each pair, 0 where it does not
    contribute."""
    contributes, r, inv_l, inv_u, inside = _hct_regions(r2, keep, rho, sr)
    inv_r = 1.0 / r
    l2 = inv_l * inv_l
    u2 = inv_u * inv_u
    term = (inv_l - inv_u + 0.25 * r * (u2 - l2)
            + 0.5 * inv_r * torch.log(inv_u / inv_l)
            + 0.25 * sr * sr * inv_r * (l2 - u2))
    term = term + torch.where(inside, 2.0 * (1.0 / rho - inv_l), 0.0)
    return torch.where(contributes, term, 0.0)


def _hct_derivative(r2, keep, rho, sr):
    """d term / dr of each pair of _hct_term (0 where it does not
    contribute): through the explicit r, L (dL/dr is sign(r - sr) where
    |r - sr| > rho, else 0) and U."""
    contributes, r, inv_l, inv_u, inside = _hct_regions(r2, keep, rho, sr)
    inv_r = 1.0 / r
    l2 = inv_l * inv_l
    u2 = inv_u * inv_u
    l3 = l2 * inv_l
    u3 = u2 * inv_u
    sr2 = sr * sr
    dl = torch.where(torch.abs(r - sr) > rho, torch.sign(r - sr), 0.0)
    d_explicit = (0.25 * (u2 - l2)
                  - 0.5 * inv_r * inv_r * torch.log(inv_u / inv_l)
                  - 0.25 * sr2 * inv_r * inv_r * (l2 - u2))
    d_l = (-l2 + 0.5 * r * l3 + 0.5 * inv_l * inv_r
           - 0.5 * sr2 * l3 * inv_r)
    d_u = u2 - 0.5 * r * u3 - 0.5 * inv_u * inv_r + 0.5 * sr2 * u3 * inv_r
    d_l = d_l + torch.where(inside, 2.0 * l2, 0.0)
    return torch.where(contributes, d_explicit + d_l * dl + d_u, 0.0)


def _per_atom(charge, radius, scale, dtype):
    """float64 offset radii and the pair dtype's (offset radius, scaled
    radius)."""
    rho = radius - DIELECTRIC_OFFSET
    return rho, rho.to(dtype), (rho * scale).to(dtype)


def _born(hct_sum, rho, radius):
    """(Born radii, dB/d(HCT sum)) in float64."""
    psi = 0.5 * hct_sum * rho
    t = torch.tanh(ALPHA_OBC * psi - BETA_OBC * psi * psi
                   + GAMMA_OBC * psi ** 3)
    born = 1.0 / (1.0 / rho - t / radius)
    dborn = (born * born * (1.0 - t * t)
             * (ALPHA_OBC - 2.0 * BETA_OBC * psi
                + 3.0 * GAMMA_OBC * psi * psi) / radius * 0.5 * rho)
    return born, dborn


def _ace(radius, born, pi4asolv):
    """The ACE surface terms sa_i (float64)."""
    return pi4asolv * (radius + PROBE_RADIUS) ** 2 * (radius / born) ** 6


def _gpol(r2, keep, bi, bj, qi, qj, cutoff):
    """The pair energies q_i q_j / f_ij (- q_i q_j / rc) of (r^2, keep),
    with pre_factor in qi, and (q_i q_j / f^3, the exp term, B_i B_j,
    r^2 of the kept pairs) for the derivatives."""
    r2s = torch.where(keep, r2, 1.0)
    alpha2 = bi * bj
    expterm = torch.exp(-(r2s / (4.0 * alpha2)))
    f2 = r2s + alpha2 * expterm
    inv_f = 1.0 / torch.sqrt(f2)
    qq = qi * qj
    gpol = qq * inv_f
    if cutoff is not None:
        gpol = gpol - qq / cutoff
    return torch.where(keep, gpol, 0.0), qq * inv_f * inv_f * inv_f, \
        expterm, alpha2, r2s


def _hct_sums(pos, rho_d, sr_d, box, cutoff):
    """Pass 1: each atom's HCT sum (n,) float64."""
    sums = []
    for r0, r1 in _row_chunks(pos.shape[0]):
        _, r2, keep = _rows(pos, r0, r1, box, cutoff)
        sums.append(_hct_term(r2, keep, rho_d[r0:r1, None],
                              sr_d[None, :]).sum(dim=1, dtype=F64))
    return torch.cat(sums)


def gbsa_energy(pos, charge, radius, scale, terms: GBTerms, box=None):
    """The GB and ACE energy (float64 scalar) at `pos` (n, 3), in
    operations that autograd differentiates with respect to pos: charge,
    radius and scale (n,) float64, the pair arithmetic in pos.dtype, a box
    (3, 3) for minimum images (CutoffPeriodic) or None."""
    dt = pos.dtype
    if box is not None:
        box = box.to(dt)
    rho, rho_d, sr_d = _per_atom(charge, radius, scale, dt)
    born, _ = _born(_hct_sums(pos, rho_d, sr_d, box, terms.cutoff), rho,
                    radius)
    qp = terms.pre_factor * charge
    energy = (_ace(radius, born, terms.pi4asolv).sum()
              + (0.5 * qp * charge / born).sum())
    born_d, qp_d, q_d = born.to(dt), qp.to(dt), charge.to(dt)
    pair = torch.zeros((), dtype=F64, device=pos.device)
    for r0, r1 in _row_chunks(pos.shape[0]):
        _, r2, keep = _rows(pos, r0, r1, box, terms.cutoff)
        gpol = _gpol(r2, keep, born_d[r0:r1, None], born_d[None, :],
                     qp_d[r0:r1, None], q_d[None, :], terms.cutoff)[0]
        pair = pair + gpol.sum(dtype=F64)
    return energy + 0.5 * pair


def gbsa_energy_forces(pos, charge, radius, scale, terms: GBTerms,
                       box=None):
    """(energy float64 scalar, forces (n, 3) float64) of gbsa_energy's
    arguments, analytically, in three sweeps of the rows (no autograd)."""
    dt = pos.dtype
    if box is not None:
        box = box.to(dt)
    cutoff = terms.cutoff
    rho, rho_d, sr_d = _per_atom(charge, radius, scale, dt)
    born, dborn = _born(_hct_sums(pos, rho_d, sr_d, box, cutoff), rho,
                        radius)
    sa = _ace(radius, born, terms.pi4asolv)
    qp = terms.pre_factor * charge
    born_d, qp_d, q_d = born.to(dt), qp.to(dt), charge.to(dt)
    chunks = list(_row_chunks(pos.shape[0]))

    # pass 2: pair energies, forces at fixed radii, dE/dB
    pair = torch.zeros((), dtype=F64, device=pos.device)
    forces, de_db = [], []
    for r0, r1 in chunks:
        d, r2, keep = _rows(pos, r0, r1, box, cutoff)
        bj = born_d[None, :]
        gpol, qq_f3, expterm, alpha2, r2s = _gpol(
            r2, keep, born_d[r0:r1, None], bj, qp_d[r0:r1, None],
            q_d[None, :], cutoff)
        pair = pair + gpol.sum(dtype=F64)
        # dE/d(r^2) = -qq/(2 f^3) (1 - e/4); dE/dB_i = -qq/(2 f^3) e
        # (1 + r^2/(4 B_i B_j)) B_j
        de_dr2 = torch.where(keep, -0.5 * qq_f3 * (1.0 - 0.25 * expterm),
                             0.0)
        forces.append((-2.0 * de_dr2[..., None] * d).sum(dim=1, dtype=F64))
        de_db.append(torch.where(
            keep, -0.5 * qq_f3 * expterm * (1.0 + r2s / (4.0 * alpha2))
            * bj, 0.0).sum(dim=1, dtype=F64))
    energy = sa.sum() + (0.5 * qp * charge / born).sum() + 0.5 * pair
    de_db = torch.cat(de_db) - 0.5 * qp * charge / (born * born) \
        - 6.0 * sa / born
    # dE/d(HCT sum) of each atom
    chain = (de_db * dborn).to(dt)

    # pass 3: the chain rule through the radii; a pair enters atom i's
    # sum (rho_i against sr_j) and atom j's (rho_j against sr_i)
    for k, (r0, r1) in enumerate(chunks):
        d, r2, keep = _rows(pos, r0, r1, box, cutoff)
        t_ij = _hct_derivative(r2, keep, rho_d[r0:r1, None], sr_d[None, :])
        t_ji = _hct_derivative(r2, keep, rho_d[None, :], sr_d[r0:r1, None])
        r = torch.sqrt(torch.where(keep, r2, 1.0))
        de_dr = chain[r0:r1, None] * t_ij + chain[None, :] * t_ji
        forces[k] = forces[k] + (-(de_dr / r)[..., None] * d).sum(
            dim=1, dtype=F64)
    return energy, torch.cat(forces)
