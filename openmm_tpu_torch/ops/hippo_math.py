"""HIPPO pair math: damping factors (dense, vectorized).

Counterpart of openmm_tpu/ops/hippo_math.py, after the reference HIPPO
kernels (plugins/amoeba/platforms/reference/src/SimTKReference/
AmoebaReferenceHippoNonbondedForce.cpp): the overlap damping of the
charge-penetration electrostatics (:377-451), damped dispersion
(:452-488), Pauli repulsion damping (:490-556) and the direct and mutual
field damping (:333-375). All pairwise quantities are (n, n) tensors.
"""
from __future__ import annotations

import torch


def _branch(aI, aJ):
    """Common helpers for the equal/unequal alpha branches: returns
    (equal?, A, B) with safe denominators."""
    eq = torch.abs(aI - aJ) < 1e-9
    aI2 = aI * aI
    aJ2 = aJ * aJ
    den = torch.where(eq, 1.0, aJ2 - aI2)
    A = aJ2 / den
    B = -aI2 / den
    return eq, A, B


def direct_field_damping(alpha_j, r):
    """fdamp3/5/7 of the source particle (:333-342)."""
    ar = alpha_j * r
    ar2 = ar * ar
    ar3 = ar2 * ar
    ar4 = ar2 * ar2
    e = torch.exp(-ar)
    f3 = 1 - (1 + ar + ar2 / 2) * e
    f5 = 1 - (1 + ar + ar2 / 2 + ar3 / 6) * e
    f7 = 1 - (1 + ar + ar2 / 2 + ar3 / 6 + ar4 / 30) * e
    return f3, f5, f7


def mutual_field_damping(aI, aJ, r):
    """fdamp3/5 for induced-induced fields (:344-375)."""
    eq, A, B = _branch(aI, aJ)
    arI = aI * r
    arI2 = arI * arI
    arI3 = arI2 * arI
    arI4 = arI3 * arI
    arI5 = arI4 * arI
    eI = torch.exp(-arI)
    f3_eq = 1 - (1 + arI + arI2 / 2 + arI3 * (7 / 48) + arI4 / 48) * eI
    f5_eq = 1 - (1 + arI + arI2 / 2 + arI3 / 6 + arI4 / 24
                 + arI5 / 144) * eI
    arJ = aJ * r
    arJ2 = arJ * arJ
    arJ3 = arJ2 * arJ
    eJ = torch.exp(-arJ)
    A2 = A * A
    B2 = B * B
    f3_ne = (1 - A2 * (1 + arI + arI2 / 2) * eI
             - B2 * (1 + arJ + arJ2 / 2) * eJ
             - 2 * A2 * B * (1 + arI) * eI
             - 2 * B2 * A * (1 + arJ) * eJ)
    f5_ne = (1 - A2 * (1 + arI + arI2 / 2 + arI3 / 6) * eI
             - B2 * (1 + arJ + arJ2 / 2 + arJ3 / 6) * eJ
             - 2 * A2 * B * (1 + arI + arI2 / 3) * eI
             - 2 * B2 * A * (1 + arJ + arJ2 / 3) * eJ)
    return torch.where(eq, f3_eq, f3_ne), torch.where(eq, f5_eq, f5_ne)


def overlap_damping(aI, aJ, r):
    """The 16 overlap damping factors (:377-451). Returns dict with keys
    i1..i9, j1..j9, ij1..ij11."""
    eq, A, B = _branch(aI, aJ)
    out = {}

    def one_sided(a):
        ar = a * r
        ar2 = ar * ar
        ar3 = ar2 * ar
        ar4 = ar2 * ar2
        ar5 = ar3 * ar2
        e = torch.exp(-ar)
        return {
            1: 1 - (1 + ar / 2) * e,
            3: 1 - (1 + ar + ar2 / 2) * e,
            5: 1 - (1 + ar + ar2 / 2 + ar3 / 6) * e,
            7: 1 - (1 + ar + ar2 / 2 + ar3 / 6 + ar4 / 30) * e,
            9: 1 - (1 + ar + ar2 / 2 + ar3 / 6 + ar4 * (4 / 105)
                    + ar5 / 210) * e,
        }

    fI = one_sided(aI)
    fJ = one_sided(aJ)
    for k in (1, 3, 5, 7, 9):
        out["i%d" % k] = fI[k]
        out["j%d" % k] = fJ[k]

    arI = aI * r
    arI2 = arI * arI
    arI3 = arI2 * arI
    arI4 = arI2 * arI2
    arI5 = arI3 * arI2
    arI6 = arI3 * arI3
    arI7 = arI4 * arI3
    arI8 = arI4 * arI4
    eI = torch.exp(-arI)
    ij_eq = {
        1: 1 - (1 + arI * (11 / 16) + arI2 * (3 / 16) + arI3 / 48) * eI,
        3: 1 - (1 + arI + arI2 / 2 + arI3 * (7 / 48) + arI4 / 48) * eI,
        5: 1 - (1 + arI + arI2 / 2 + arI3 / 6 + arI4 / 24
                + arI5 / 144) * eI,
        7: 1 - (1 + arI + arI2 / 2 + arI3 / 6 + arI4 / 24 + arI5 / 120
                + arI6 / 720) * eI,
        9: 1 - (1 + arI + arI2 / 2 + arI3 / 6 + arI4 / 24 + arI5 / 120
                + arI6 / 720 + arI7 / 5040) * eI,
        11: 1 - (1 + arI + arI2 / 2 + arI3 / 6 + arI4 / 24 + arI5 / 120
                 + arI6 / 720 + arI7 / 5040 + arI8 / 45360) * eI,
    }
    arJ = aJ * r
    arJ2 = arJ * arJ
    arJ3 = arJ2 * arJ
    arJ4 = arJ2 * arJ2
    arJ5 = arJ3 * arJ2
    arJ6 = arJ3 * arJ3
    eJ = torch.exp(-arJ)
    A2 = A * A
    B2 = B * B
    ij_ne = {
        1: (1 - A2 * (1 + 2 * B + arI / 2) * eI
            - B2 * (1 + 2 * A + arJ / 2) * eJ),
        3: (1 - A2 * (1 + arI + arI2 / 2) * eI
            - B2 * (1 + arJ + arJ2 / 2) * eJ
            - 2 * A2 * B * (1 + arI) * eI
            - 2 * B2 * A * (1 + arJ) * eJ),
        5: (1 - A2 * (1 + arI + arI2 / 2 + arI3 / 6) * eI
            - B2 * (1 + arJ + arJ2 / 2 + arJ3 / 6) * eJ
            - 2 * A2 * B * (1 + arI + arI2 / 3) * eI
            - 2 * B2 * A * (1 + arJ + arJ2 / 3) * eJ),
        7: (1 - A2 * (1 + arI + arI2 / 2 + arI3 / 6 + arI4 / 30) * eI
            - B2 * (1 + arJ + arJ2 / 2 + arJ3 / 6 + arJ4 / 30) * eJ
            - 2 * A2 * B * (1 + arI + arI2 * (2 / 5) + arI3 / 15) * eI
            - 2 * B2 * A * (1 + arJ + arJ2 * (2 / 5) + arJ3 / 15) * eJ),
        9: (1 - A2 * (1 + arI + arI2 / 2 + arI3 / 6 + arI4 * (4 / 105)
                      + arI5 / 210) * eI
            - B2 * (1 + arJ + arJ2 / 2 + arJ3 / 6 + arJ4 * (4 / 105)
                    + arJ5 / 210) * eJ
            - 2 * A2 * B * (1 + arI + arI2 * (3 / 7) + arI3 * (2 / 21)
                            + arI4 / 105) * eI
            - 2 * B2 * A * (1 + arJ + arJ2 * (3 / 7) + arJ3 * (2 / 21)
                            + arJ4 / 105) * eJ),
        11: (1 - A2 * (1 + arI + arI2 / 2 + arI3 / 6 + arI4 * (5 / 126)
                       + arI5 * (2 / 315) + arI6 / 1890) * eI
             - B2 * (1 + arJ + arJ2 / 2 + arJ3 / 6 + arJ4 * (5 / 126)
                     + arJ5 * (2 / 315) + arJ6 / 1890) * eJ
             - 2 * A2 * B * (1 + arI + arI2 * (4 / 9) + arI3 / 9
                             + arI4 / 63 + arI5 / 945) * eI
             - 2 * B2 * A * (1 + arJ + arJ2 * (4 / 9) + arJ3 / 9
                             + arJ4 / 63 + arJ5 / 945) * eJ),
    }
    for k in (1, 3, 5, 7, 9, 11):
        out["ij%d" % k] = torch.where(eq, ij_eq[k], ij_ne[k])
    return out


def dispersion_damping(aI, aJ, r):
    """fdamp for dispersion (:452-488); the energy uses fdamp^2."""
    f3, f5 = mutual_field_damping(aI, aJ, r)
    return 1.5 * f5 - 0.5 * f3


def repulsion_damping(pauliAlphaI, pauliAlphaJ, r):
    """fdamp1..11 for Pauli repulsion (:490-556)."""
    aI2 = 0.5 * pauliAlphaI
    aJ2 = 0.5 * pauliAlphaJ
    eq = torch.abs(pauliAlphaI - pauliAlphaJ) < 1e-9
    r2 = r * r
    r3 = r2 * r
    r4 = r2 * r2
    r5 = r3 * r2
    r6 = r3 * r3
    r7 = r4 * r3
    r8 = r4 * r4
    expI = torch.exp(-aI2 * r)
    aI2_2 = aI2 * aI2
    aI2_3 = aI2_2 * aI2
    aI2_4 = aI2_2 * aI2_2
    aI2_5 = aI2_3 * aI2_2
    aI2_6 = aI2_3 * aI2_3
    aI2_7 = aI2_4 * aI2_3

    pre_eq = 128.0
    fexp_eq = (r + aI2 * r2 + aI2_2 * r3 / 3) * expI
    fexp1_eq = (aI2_2 * r3 + aI2_3 * r4) * expI / 3
    fexp2_eq = aI2_4 * expI * r5 / 9
    fexp3_eq = aI2_5 * expI * r6 / 45
    fexp4_eq = (aI2_5 * r6 + aI2_6 * r7) * expI / 315
    fexp5_eq = (aI2_5 * r6 + aI2_6 * r7 + aI2_7 * r8 / 3) * expI / 945

    expJ = torch.exp(-aJ2 * r)
    aJ2_2 = aJ2 * aJ2
    aJ2_3 = aJ2_2 * aJ2
    aJ2_4 = aJ2_2 * aJ2_2
    aJ2_5 = aJ2_3 * aJ2_2
    den = torch.where(eq, 1.0, aI2_2 - aJ2_2)
    scale = 1.0 / den
    aIJI = aI2 * aJ2 * expI
    aIJJ = aI2 * aJ2 * expJ
    pre_ne = 8192 * aI2_3 * aJ2_3 * (scale ** 4)
    tmp = 4 * aI2 * aJ2 * scale
    fexp_ne = (aI2 * r - tmp) * expJ + (aJ2 * r + tmp) * expI
    fexp1_ne = ((r2 - (4 * aJ2 * r + 4) * scale) * aIJJ
                + (r2 + (4 * aI2 * r + 4) * scale) * aIJI)
    fexp2_ne = ((r2 / 3 + aJ2 * r3 / 3
                 - ((4 / 3) * aJ2_2 * r2 + 4 * aJ2 * r + 4) * scale) * aIJJ
                + (r2 / 3 + aI2 * r3 / 3
                   + ((4 / 3) * aI2_2 * r2 + 4 * aI2 * r + 4) * scale)
                * aIJI)
    fexp3_ne = ((aJ2_2 * r4 / 15 + aJ2 * r3 / 5 + r2 / 5
                 - ((4 / 15) * aJ2_3 * r3 + (8 / 5) * aJ2_2 * r2
                    + 4 * aJ2 * r + 4) * scale) * aIJJ
                + (aI2_2 * r4 / 15 + aI2 * r3 / 5 + r2 / 5
                   + ((4 / 15) * aI2_3 * r3 + (8 / 5) * aI2_2 * r2
                      + 4 * aI2 * r + 4) * scale) * aIJI)
    fexp4_ne = ((aJ2_3 * r5 / 105 + (2 / 35) * aJ2_2 * r4 + aJ2 * r3 / 7
                 + r2 / 7
                 - ((4 / 105) * aJ2_4 * r4 + (8 / 21) * aJ2_3 * r3
                    + (12 / 7) * aJ2_2 * r2 + 4 * aJ2 * r + 4) * scale)
                * aIJJ
                + (aI2_3 * r5 / 105 + (2 / 35) * aI2_2 * r4 + aI2 * r3 / 7
                   + r2 / 7
                   + ((4 / 105) * aI2_4 * r4 + (8 / 21) * aI2_3 * r3
                      + (12 / 7) * aI2_2 * r2 + 4 * aI2 * r + 4) * scale)
                * aIJI)
    fexp5_ne = ((aJ2_4 * r6 / 945 + (2 / 189) * aJ2_3 * r5
                 + aJ2_2 * r4 / 21 + aJ2 * r3 / 9 + r2 / 9
                 - ((4 / 945) * aJ2_5 * r5 + (4 / 63) * aJ2_4 * r4
                    + (4 / 9) * aJ2_3 * r3 + (16 / 9) * aJ2_2 * r2
                    + 4 * aJ2 * r + 4) * scale) * aIJJ
                + (aI2_4 * r6 / 945 + (2 / 189) * aI2_3 * r5
                   + aI2_2 * r4 / 21 + aI2 * r3 / 9 + r2 / 9
                   + ((4 / 945) * aI2_5 * r5 + (4 / 63) * aI2_4 * r4
                      + (4 / 9) * aI2_3 * r3 + (16 / 9) * aI2_2 * r2
                      + 4 * aI2 * r + 4) * scale) * aIJI)

    pre = torch.where(eq, pre_eq, pre_ne)
    fexp = torch.where(eq, fexp_eq, fexp_ne) / r
    fexp1 = torch.where(eq, fexp1_eq, fexp1_ne) / r3
    fexp2 = 3 * torch.where(eq, fexp2_eq, fexp2_ne) / r5
    fexp3 = 15 * torch.where(eq, fexp3_eq, fexp3_ne) / (r5 * r2)
    fexp4 = 105 * torch.where(eq, fexp4_eq, fexp4_ne) / (r5 * r4)
    fexp5 = 945 * torch.where(eq, fexp5_eq, fexp5_ne) / (r5 * r6)
    return {
        1: 0.5 * pre * fexp * fexp,
        3: pre * fexp * fexp1,
        5: pre * (fexp * fexp2 + fexp1 * fexp1),
        7: pre * (fexp * fexp3 + 3 * fexp1 * fexp2),
        9: pre * (fexp * fexp4 + 4 * fexp1 * fexp3 + 3 * fexp2 * fexp2),
        11: pre * (fexp * fexp5 + 5 * fexp1 * fexp4 + 10 * fexp2 * fexp3),
    }
