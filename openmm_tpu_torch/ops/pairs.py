"""Neighbour-list helpers (spatial sort keys, the rebuild predicate, the
exclusion table) and the all-pairs direct space.

Counterpart of openmm_tpu/ops/pairs.py (build_exclusion_table,
spatial_sort_keys, needs_rebuild; the rebuild predicate here also
fires on a change of the box; pair_energy_n2). The JAX pair_energy_n2
sums a pair function over the unordered pairs of blocked tiles and takes
forces by jax.grad. pair_energy_forces_n2 takes every atom's row of
partners instead (each pair from both atoms, the energy halved), so that
an atom's force is a dense sum over its own row: no scatter of forces,
and no float atomics, which would change the bits from run to run on a
card (the step program is held bit for bit against the eager loop).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..constants import ONE_4PI_EPS0
from . import geometry as geom

TWO_OVER_SQRT_PI = 2.0 / math.sqrt(math.pi)
# pair elements (row atoms x partners) a chunk of pair_energy_forces_n2
N2_CHUNK = 1 << 22


def pad_to_block(n: int, block: int) -> int:
    return ((n + block - 1) // block) * block


def build_exclusion_table(n_atoms: int, exclusion_pairs,
                          pad_multiple: int = 2) -> np.ndarray:
    """(n_atoms, E) int32 per-atom excluded partners in ascending order,
    -1 padded."""
    pairs = np.asarray(exclusion_pairs, np.int64).reshape(-1, 2)
    rows = np.concatenate([pairs[:, 0], pairs[:, 1]])
    cols = np.concatenate([pairs[:, 1], pairs[:, 0]])
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    counts = np.bincount(rows, minlength=n_atoms)
    max_e = int(counts.max(initial=0))
    max_e = max(1, ((max_e + pad_multiple - 1) // pad_multiple) * pad_multiple)
    table = np.full((n_atoms, max_e), -1, dtype=np.int32)
    # each partner's slot: its place among its row's partners
    slots = np.arange(len(rows)) - (np.cumsum(counts) - counts)[rows]
    table[rows, slots] = cols
    return table


def spatial_sort_keys(pos: torch.Tensor, box: torch.Tensor, n_real: int,
                      cell_size: float, widths=None) -> torch.Tensor:
    """Sort key that makes runs of atoms spatially compact: cells of half
    `cell_size` grouped into 2x2x2 bricks, bricks in snake order, cells in
    a brick in Morton order. Padding atoms sort last. The cell counts come
    from `widths`, the box's diagonal as Python floats in box.dtype, so
    that the key reads nothing back from the device; without them the
    diagonal is read from `box` (a host read when box is on a card)."""
    n_pad = pos.shape[0]
    cell_size = 0.5 * cell_size
    wrapped = geom.wrap_into_box(pos, box)
    if widths is None:
        widths = box.diagonal().to(torch.float64).tolist()
    ncx, ncy, ncz = (2 * max(int(round(w / (2 * cell_size))), 1)
                     for w in widths)

    def cell(axis, nc):
        c = torch.floor(wrapped[:, axis] * (nc / box[axis, axis]))
        return torch.clamp(c.to(torch.int64), 0, nc - 1)

    cx, cy, cz = cell(0, ncx), cell(1, ncy), cell(2, ncz)
    bx, ox = cx // 2, cx % 2
    by, oy = cy // 2, cy % 2
    bz, oz = cz // 2, cz % 2
    nby, nbz = (ncy + 1) // 2, (ncz + 1) // 2
    by_eff = torch.where(bx % 2 == 1, nby - 1 - by, by)
    col = bx * nby + by_eff
    bz_eff = torch.where(col % 2 == 1, nbz - 1 - bz, bz)
    key = (col * nbz + bz_eff) * 8 + (ox * 4 + oy * 2 + oz)
    pad = torch.arange(n_pad, device=pos.device) >= n_real
    return torch.where(pad, torch.iinfo(torch.int64).max, key)


def needs_rebuild(pos: torch.Tensor, ref_pos: torch.Tensor, skin: float,
                  box: torch.Tensor, ref_box: torch.Tensor) -> torch.Tensor:
    """True when any atom moved more than skin/2 since the last build, or
    when the box differs from the box of that build: a candidate state
    kept across a barostat's move could miss pairs without overflowing.
    The JAX refresher tests displacement alone."""
    d = pos - ref_pos
    moved = torch.max(torch.sum(d * d, dim=-1)) > (0.5 * skin) ** 2
    return moved | torch.any(box != ref_box)


class PairTerms(NamedTuple):
    """What the all-pairs direct space of the non-periodic methods
    computes. coulomb: "rf" (the reaction field, qq (1/r + krf r^2 - crf))
    or "plain" (qq / r). cutoff None: every pair counts; else pairs at
    r < cutoff. switch None, or the Lennard-Jones switch's (distance,
    1 / (cutoff - distance))."""
    coulomb: str
    cutoff: float | None = None
    krf: float = 0.0
    crf: float = 0.0
    switch: tuple | None = None


def dispersion_complement(x):
    """(g, h) at x = (alpha_LJ r)^2 >= 0: g = 1 - e^-x (1 + x + x^2/2),
    the share of c6/r^6 that the dispersion grid leaves to the direct
    space, and h = g - e^-x x^3/6, which its derivative takes
    (d/d(r^2) of c6 g / r^6 = -3 c6 h / r^8), in the direct form of the
    JAX package and of kernel 1's MODE_LJPME. Both cancel at small x, but
    their absolute error stays that of x.dtype on 1."""
    ex = torch.exp(-x)
    p = 1.0 + x + 0.5 * x * x
    return 1.0 - ex * p, 1.0 - ex * (p + x * x * x * (1.0 / 6.0))


def pair_terms(r2s, qq, sig, eps4, coulomb, alpha=0.0, krf=0.0, crf=0.0,
               switch=None, ljpme=None):
    """(dE/d(r^2), E) of the Lennard-Jones and Coulomb terms of pairs at
    r^2 = r2s (> 0): qq = k_e q_i q_j, sig = (sigma_i + sigma_j) / 2,
    eps4 = 4 sqrt(eps_i eps_j), coulomb "ewald" (qq erfc(alpha r) / r,
    kernel 1's MODE_EWALD) or as in PairTerms, switch as there (the
    constants floats or 0-d tensors). In float32 erfc is the Hastings form
    of the JAX float32 path and of kernel 1; in float64 the exact one.
    ljpme = (c6g, alpha_LJ^2, shift, 1 / rc^6) adds LJPME's terms to the
    Lennard-Jones part (after the switch, JAX nonbonded.py:663-676): the
    dispersion grid's complement c6g / r^6 g(alpha_LJ^2 r^2) with its
    force, and the energy-only shifts 4 eps (sig^6 / rc^6)(1 - sig^6 /
    rc^6) + shift c6g (kernel 1's MODE_LJPME)."""
    inv_r = torch.rsqrt(r2s)
    inv_r2 = inv_r * inv_r
    s2 = sig * sig * inv_r2
    s6 = s2 * s2 * s2
    es6 = eps4 * s6
    de_lj = -3.0 * es6 * (2.0 * s6 - 1.0) * inv_r2
    e_lj = es6 * (s6 - 1.0)
    if switch is not None:
        rs, inv_w = switch
        t = torch.clamp((r2s * inv_r - rs) * inv_w, 0.0, 1.0)
        t2 = t * t
        sw = 1.0 - t2 * t * (10.0 - 15.0 * t + 6.0 * t2)
        dsw = (-30.0 * t2 * (1.0 - t) ** 2 * inv_w) * (0.5 * inv_r)
        de_lj = de_lj * sw + e_lj * dsw
        e_lj = e_lj * sw
    if ljpme is not None:
        c6g, alpha2, shift, inv_cut6 = ljpme
        g, h = dispersion_complement(alpha2 * r2s)
        coef = c6g * inv_r2 * inv_r2 * inv_r2
        e_lj = e_lj + coef * g
        de_lj = de_lj - 3.0 * coef * h * inv_r2
        sig2 = sig * sig
        sig6c = sig2 * sig2 * sig2 * inv_cut6
        e_lj = e_lj + eps4 * sig6c * (1.0 - sig6c) + shift * c6g
    if coulomb == "ewald":
        ar = alpha * (r2s * inv_r)
        ex = torch.exp(-ar * ar)
        if r2s.dtype == torch.float64:
            erfc_ar = torch.special.erfc(ar)
        else:
            t = 1.0 / (1.0 + 0.3275911 * ar)
            erfc_ar = (0.254829592 + (-0.284496736 + (
                1.421413741 + (-1.453152027 + 1.061405429 * t) * t)
                * t) * t) * t * ex
        de_c = -qq * (erfc_ar * inv_r2
                      + TWO_OVER_SQRT_PI * alpha * ex * inv_r) \
            * (0.5 * inv_r)
        e_c = qq * inv_r * erfc_ar
    elif coulomb == "rf":
        de_c = qq * (-0.5 * inv_r2 * inv_r + krf)
        e_c = qq * (inv_r + krf * r2s - crf)
    else:
        de_c = -0.5 * qq * inv_r2 * inv_r
        e_c = qq * inv_r
    return de_lj + de_c, e_lj + e_c


def pair_param_derivative(r2s, qq, dqq, sig, dsig, eps4, deps4, coulomb,
                          alpha=0.0, krf=0.0, crf=0.0, switch=None,
                          ljpme=None):
    """dE/dlambda of pair_terms' pairs, given each pair's parameters and
    their derivatives in a global parameter lambda: dqq = d(qq)/dlambda,
    dsig, deps4 likewise; ljpme = (c6g, dc6g, alpha_LJ^2, shift, 1/rc^6).
    dE/dlambda = dE/dqq dqq + dE/dsig dsig + dE/deps4 deps4 (+ dE/dc6g
    dc6g) at fixed r, in pair_terms' forms (the switch scales the
    Lennard-Jones part before LJPME's terms are added)."""
    inv_r = torch.rsqrt(r2s)
    inv_r2 = inv_r * inv_r
    s2 = sig * sig * inv_r2
    s6 = s2 * s2 * s2
    # a pair whose sigma no offset moves takes no 0 / 0 at sigma 0
    dsig_sig = torch.where(dsig != 0, dsig / sig, 0.0)
    d_lj = (deps4 * s6 * (s6 - 1.0)
            + eps4 * 6.0 * s6 * (2.0 * s6 - 1.0) * dsig_sig)
    if switch is not None:
        rs, inv_w = switch
        t = torch.clamp((r2s * inv_r - rs) * inv_w, 0.0, 1.0)
        t2 = t * t
        d_lj = d_lj * (1.0 - t2 * t * (10.0 - 15.0 * t + 6.0 * t2))
    if ljpme is not None:
        c6g, dc6g, alpha2, shift, inv_cut6 = ljpme
        g, _ = dispersion_complement(alpha2 * r2s)
        d_lj = d_lj + dc6g * (inv_r2 * inv_r2 * inv_r2 * g + shift)
        sig2 = sig * sig
        sig6c = sig2 * sig2 * sig2 * inv_cut6
        d_lj = d_lj + deps4 * sig6c * (1.0 - sig6c) + eps4 * (
            6.0 * sig6c - 12.0 * sig6c * sig6c) * dsig_sig
    if coulomb == "ewald":
        ar = alpha * (r2s * inv_r)
        if r2s.dtype == torch.float64:
            erfc_ar = torch.special.erfc(ar)
        else:
            t = 1.0 / (1.0 + 0.3275911 * ar)
            erfc_ar = (0.254829592 + (-0.284496736 + (
                1.421413741 + (-1.453152027 + 1.061405429 * t) * t)
                * t) * t) * t * torch.exp(-ar * ar)
        e_c = inv_r * erfc_ar
    elif coulomb == "rf":
        e_c = inv_r + krf * r2s - crf
    else:
        e_c = inv_r
    return d_lj + dqq * e_c


def pair_param_derivative_n2(pos, params, dparams, exclusions,
                             terms: PairTerms):
    """dE/dlambda (float64 scalar) of pair_energy_forces_n2's energy, given
    the (charge, sigma, epsilon) (n,) of each atom and their derivatives
    in lambda; every pair counted once."""
    n = pos.shape[0]
    dt = pos.dtype
    dev = pos.device
    (q, sg, ep), (dq, dsg, dep) = ([x.to(dt) for x in params],
                                   [x.to(dt) for x in dparams])
    k = math.sqrt(ONE_4PI_EPS0)
    qs, dqs = k * q, k * dq
    sh, dsh = 0.5 * sg, 0.5 * dsg
    es = 2.0 * torch.sqrt(ep)
    des = torch.where(ep > 0, dep / torch.sqrt(torch.where(ep > 0, ep, 1.0)),
                      0.0)
    excl = torch.where(exclusions >= 0, exclusions.long(), n)
    total = torch.zeros((), dtype=torch.float64, device=dev)
    for r0, r1 in _row_chunks(n):
        rows = r1 - r0
        dr = pos[r0:r1, None, :] - pos[None, :, :]
        dx, dy, dz = dr.unbind(-1)
        r2 = dx * dx + dy * dy + dz * dz
        own = torch.arange(r0, r1, device=dev)[:, None]
        skip = torch.zeros((rows, n + 1), dtype=torch.bool, device=dev)
        skip.scatter_(1, torch.cat([excl[r0:r1], own], dim=1), True)
        keep = ~skip[:, :n]
        if terms.cutoff is not None:
            keep = keep & (r2 < terms.cutoff * terms.cutoff)
        row, col = slice(r0, r1), slice(None)
        d = pair_param_derivative(
            torch.where(keep, r2, 1.0),
            qs[row, None] * qs[None, col],
            dqs[row, None] * qs[None, col] + qs[row, None] * dqs[None, col],
            sh[row, None] + sh[None, col], dsh[row, None] + dsh[None, col],
            es[row, None] * es[None, col],
            des[row, None] * es[None, col] + es[row, None] * des[None, col],
            terms.coulomb, krf=terms.krf, crf=terms.crf,
            switch=terms.switch)
        total = total + torch.where(keep, d, 0.0).sum(dtype=torch.float64)
    return 0.5 * total


def _row_chunks(n: int, chunk: int = N2_CHUNK):
    rows = max(1, chunk // max(n, 1))
    for r0 in range(0, n, rows):
        yield r0, min(n, r0 + rows)


def pair_energy_forces_n2(pos, charge, sigma, epsilon, exclusions,
                          terms: PairTerms, mesh=None):
    """(energy float64 scalar, forces (n, 3) in pos.dtype) of the
    Lennard-Jones and Coulomb terms over every pair of atoms that is not
    excluded: exclusions (n, E) int of excluded partners, -1 padded. Rows
    of atoms go in chunks against all n partners; each atom's force is its
    row's sum (in float64), the energy half the sum of the chunks' sums, in
    chunk order (pair_terms). mesh: a parallel.Mesh whose rank sweeps its
    share of the chunks (the same chunks as on one rank), the forces and
    the chunks' energies gathered (Mesh.gather) before the energy is
    summed, or None."""
    n = pos.shape[0]
    dt = pos.dtype
    dev = pos.device
    qs = math.sqrt(ONE_4PI_EPS0) * charge.to(dt)
    sh = 0.5 * sigma.to(dt)
    es = 2.0 * torch.sqrt(epsilon.to(dt))
    excl = torch.where(exclusions >= 0, exclusions.long(), n)
    chunks = list(_row_chunks(n))
    # the rows' forces (float64) and each chunk's energy, in one tensor
    # that the mesh gathers
    out = torch.zeros(3 * n + len(chunks), dtype=torch.float64, device=dev)
    forces, energies = out[:3 * n].view(n, 3), out[3 * n:]
    c0, c1 = (0, len(chunks)) if mesh is None else mesh.rows(len(chunks))
    for c in range(c0, c1):
        r0, r1 = chunks[c]
        rows = r1 - r0
        dr = pos[r0:r1, None, :] - pos[None, :, :]
        # product by product and sum by sum, in every precision: a pair
        # at the cutoff is decided the same way everywhere
        dx, dy, dz = dr.unbind(-1)
        r2 = dx * dx + dy * dy + dz * dz
        # the excluded partners and the atom itself
        own = torch.arange(r0, r1, device=dev)[:, None]
        skip = torch.zeros((rows, n + 1), dtype=torch.bool, device=dev)
        skip.scatter_(1, torch.cat([excl[r0:r1], own], dim=1), True)
        keep = ~skip[:, :n]
        if terms.cutoff is not None:
            keep = keep & (r2 < terms.cutoff * terms.cutoff)
        de, e = pair_terms(torch.where(keep, r2, 1.0),
                           qs[r0:r1, None] * qs[None, :],
                           sh[r0:r1, None] + sh[None, :],
                           es[r0:r1, None] * es[None, :], terms.coulomb,
                           krf=terms.krf, crf=terms.crf, switch=terms.switch)
        dedr2 = torch.where(keep, de, 0.0)
        energies[c] = torch.where(keep, e, 0.0).sum(dtype=torch.float64)
        forces[r0:r1] = (-2.0 * dedr2[..., None] * dr).sum(
            dim=1, dtype=torch.float64)
    if mesh is not None:
        mesh.gather(out)
    energy = torch.zeros((), dtype=torch.float64, device=dev)
    for c in range(len(chunks)):
        energy = energy + energies[c]
    return 0.5 * energy, forces.to(dt)


class AnalyticEnergy(torch.autograd.Function):
    """The energy of fn(pos, *args) -> (energy float64 scalar, forces) as
    a scalar that autograd differentiates with respect to pos through the
    forces fn returns: the backward is -forces * grad_output, so fn runs
    once (the minimizer's objective).

    AnalyticEnergy.apply(fn, pos, *args)
    """

    @staticmethod
    def forward(ctx, fn, pos, *args):
        energy, forces = fn(pos, *args)
        ctx.save_for_backward(forces)
        ctx.dtype, ctx.n_args = pos.dtype, len(args)
        return energy

    @staticmethod
    def backward(ctx, grad):
        (forces,) = ctx.saved_tensors
        return (None, (-forces * grad.to(forces.dtype)).to(ctx.dtype)) \
            + (None,) * ctx.n_args
