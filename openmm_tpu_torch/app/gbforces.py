"""The Amber implicit-solvent GB models as CustomGBForce recipes: HCT
(igb=1), OBC1 (igb=2), OBC2 (igb=5), GBn (igb=7) and GBn2 (igb=8), with
Debye-Hueckel salt screening and the ACE surface term.

The port's own copy of openmm_tpu/app/gbforces.py (after OpenMM's
app/internal/customgbforces.py): the radius sets (Bondi and the mbondi
family), the screening factors, GBn2's alpha, beta and gamma, the GBn
neck tables (data/gbn_neck_tables.json, Mongan et al. 2006) and
build_gb_force with the JAX signature. gb_parameters takes each atom's
element symbol and the symbol of its first bonded partner (None: none);
standard_gb_parameters(model, topology) reads those from a Topology, as
the JAX package's does.

Every model shares one pipeline: a pairwise descreening integral I, an
effective Born radius B = 1/(1/rho - f(I)), and the GB energy over B.
They differ in f (HCT: identity; OBC and GBn: tanh rescalings) and in
whether I gains the neck correction (GBn, GBn2).
"""
from __future__ import annotations

import json
import math
import os

from .. import unit as u
from ..forces.customgb import CustomGBForce
from ..tabulated import Discrete2DFunction

GB_OFFSET = 0.009           # nm, the standard dielectric offset
GBN2_OFFSET = 0.0195141     # nm, GBn2's refit offset
MODELS = ("HCT", "OBC1", "OBC2", "GBn", "GBn2")

_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")

# intrinsic radii (Bondi 1964 and Amber's mbondi modifications), nm
_BONDI = {"C": 0.17, "H": 0.12, "D": 0.12, "N": 0.155, "O": 0.15, "F": 0.15,
          "Si": 0.21, "P": 0.185, "S": 0.18, "Cl": 0.17}
_DEFAULT_RADIUS = 0.15

# screening factors per element: (classic, GBn, GBn2, GBn2-nucleic)
_SCREEN = {
    "H": (0.85, 1.09085413633, 1.425952, 1.696538),
    "D": (0.85, 1.09085413633, 1.425952, 1.696538),
    "C": (0.72, 0.48435382330, 1.058554, 1.268902),
    "N": (0.79, 0.700147318409, 0.733599, 1.4259728),
    "O": (0.85, 1.06557401132, 1.061039, 0.1840098),
    "F": (0.88, 0.5, 0.5, 0.5),
    "P": (0.86, 0.5, 0.5, 1.5450597),
    "S": (0.96, 0.602256336067, -0.703469, 0.05),
}
_SCREEN_DEFAULT = (0.8, 0.5, 0.5, 0.5)

# GBn2's tanh coefficients (alpha, beta, gamma) per element, protein and
# nucleic
_GBN2_ABG = {
    "H": (0.788440, 0.798699, 0.437334), "D": (0.788440, 0.798699, 0.437334),
    "C": (0.733756, 0.506378, 0.205844), "N": (0.503364, 0.316828, 0.192915),
    "O": (0.867814, 0.876635, 0.387882), "S": (0.867814, 0.876635, 0.387882),
}
_GBN2_ABG_NUCLEIC = {
    "H": (0.537050, 0.362861, 0.116704), "D": (0.537050, 0.362861, 0.116704),
    "C": (0.331670, 0.196842, 0.093422), "N": (0.686311, 0.463189, 0.138722),
    "O": (0.606344, 0.463006, 0.142262), "S": (0.606344, 0.463006, 0.142262),
    "P": (0.418365, 0.290054, 0.1064245),
}
_GBN2_ABG_DEFAULT = (1.0, 0.8, 4.851)


def bondi_radii(elements):
    return [_BONDI.get(e or "", _DEFAULT_RADIUS) for e in elements]


def mbondi_radii(elements, partners):
    """A hydrogen's radius by its bonded heavy atom (Amber's mbondi)."""
    out = []
    for e, p in zip(elements, partners):
        if e in ("H", "D"):
            out.append(0.13 if p in ("C", "N") else 0.08 if p in ("O", "S")
                       else 0.12)
        else:
            out.append(_BONDI.get(e or "", _DEFAULT_RADIUS))
    return out


def mbondi2_radii(elements, partners):
    """mbondi2: only hydrogens bonded to nitrogen take 0.13 nm."""
    return [(0.13 if p == "N" else 0.12) if e in ("H", "D")
            else _BONDI.get(e or "", _DEFAULT_RADIUS)
            for e, p in zip(elements, partners)]


def mbondi3_radii(elements, partners, arg_hydrogens=()):
    """mbondi3 (GBn2's): mbondi2 with ARG's HH and HE hydrogens (the atom
    indices `arg_hydrogens`) at 0.117 nm. As in the JAX package, the
    carboxylate oxygens keep their mbondi2 radii (the reference's test for
    them never fires)."""
    out = mbondi2_radii(elements, partners)
    for i in arg_hydrogens:
        out[i] = 0.117
    return out


def gb_parameters(model, elements, partners, nucleic=None,
                  arg_hydrogens=()):
    """Per-atom [radius, screen] (GBn2: [radius, screen, alpha, beta,
    gamma]) of a model from each atom's element, its first bonded
    partner's element and whether its residue is a nucleic acid's
    (standard_gb_parameters' rules, without a Topology)."""
    if model == "HCT":
        radii, col = mbondi_radii(elements, partners), 0
    elif model in ("OBC1", "OBC2"):
        radii, col = mbondi2_radii(elements, partners), 0
    elif model == "GBn":
        radii, col = bondi_radii(elements), 1
    elif model == "GBn2":
        radii, col = mbondi3_radii(elements, partners, arg_hydrogens), None
    else:
        raise ValueError("unknown GB model: " + str(model))
    nucleic = nucleic or [False] * len(elements)
    out = []
    for e, r, nuc in zip(elements, radii, nucleic):
        sc = _SCREEN.get(e or "", _SCREEN_DEFAULT)
        if model != "GBn2":
            out.append([r, sc[col]])
        elif nuc:
            out.append([r, sc[3]] + list(_GBN2_ABG_NUCLEIC.get(
                e or "", _GBN2_ABG_DEFAULT)))
        else:
            out.append([r, sc[2]] + list(_GBN2_ABG.get(
                e or "", _GBN2_ABG_DEFAULT)))
    return out


_NUCLEIC_RESIDUES = frozenset(["A", "C", "G", "U", "DA", "DC", "DG", "DT"])


def standard_gb_parameters(model, topology):
    """Per-atom [radius, screen] (GBn2: [radius, screen, alpha, beta,
    gamma]) of a GB model from the Topology alone
    (openmm_tpu/app/gbforces.py:133): each atom's element, the element of
    its first bonded partner in the Topology's bond order, whether its
    residue is a nucleic acid's, and ARG's HH and HE hydrogens."""
    first = {}
    for a1, a2 in topology.bonds():
        first.setdefault(a1, a2)
        first.setdefault(a2, a1)
    atoms = list(topology.atoms())

    def symbol(atom):
        return atom.element.symbol if atom is not None and atom.element \
            else ""

    return gb_parameters(
        model, [symbol(a) for a in atoms],
        [symbol(first.get(a)) for a in atoms],
        [a.residue.name in _NUCLEIC_RESIDUES for a in atoms],
        [i for i, a in enumerate(atoms) if a.residue.name == "ARG"
         and (a.name.startswith("HH") or a.name.startswith("HE"))])


_I_HCT = ("select(step(r+sr2-or1),"
          " 0.5*(1/L-1/U+0.25*(r-sr2^2/r)*(1/(U^2)-1/(L^2))+0.5*log(L/U)/r),"
          " 0);"
          "U=r+sr2; L=max(or1, D); D=abs(r-sr2)")


def _neck_tables(unique_radii, offset):
    """The published 21 x 21 neck tables read bilinearly at each pair of
    unique radii; the grid covers radius + offset in [0.1, 0.2] nm in
    steps of 0.005 nm."""
    with open(os.path.join(_DATA, "gbn_neck_tables.json")) as f:
        tables = json.load(f)
    n = len(unique_radii)
    i1, i2, w1, w2 = [], [], [], []
    for r in unique_radii:
        p = (r + offset - 0.1) * 200.0
        if p <= 0:
            i1.append(0), i2.append(0), w1.append(1.0), w2.append(0.0)
        elif p >= 20:
            i1.append(20), i2.append(0), w1.append(1.0), w2.append(0.0)
        else:
            lo = int(math.floor(p))
            i1.append(lo), i2.append(lo + 1)
            w1.append(lo + 1 - p), w2.append(1.0 - (lo + 1 - p))
    out = {}
    for key in ("d0", "m0"):
        full = tables[key]
        out[key] = [w1[a] * w1[b] * full[i1[a] * 21 + i1[b]]
                    + w1[a] * w2[b] * full[i1[a] * 21 + i2[b]]
                    + w2[a] * w1[b] * full[i2[a] * 21 + i1[b]]
                    + w2[a] * w2[b] * full[i2[a] * 21 + i2[b]]
                    for a in range(n) for b in range(n)]
    return out


_BORN = {
    "OBC1": "tanh(0.8*psi+2.909125*psi^3)",
    "OBC2": "tanh(psi-0.8*psi^2+4.85*psi^3)",
    "GBn": "tanh(1.09511284*psi-1.907992938*psi^2+2.50798245*psi^3)",
    "GBn2": "tanh(alpha*psi-beta*psi^2+gamma*psi^3)",
}


def build_gb_force(model, charges, gb_params, solventDielectric=78.5,
                   soluteDielectric=1.0, SA=None, cutoff=None, kappa=0.0):
    """The CustomGBForce of `model`: charges per atom, gb_params per atom
    [radius, screen, ...] as gb_parameters gives them (the radius not yet
    offset: the offset and the scaled radius screen * (radius - offset)
    are taken here), kappa the Debye screening (1/nm), SA None or "ACE",
    cutoff None or nm (the pair energy shifted by 1/cutoff; the caller
    sets the method)."""
    if kappa < 0:
        raise ValueError("kappa/ionic strength must be >= 0")
    if model not in MODELS:
        raise ValueError("unknown GB model: " + str(model))
    offset = GBN2_OFFSET if model == "GBn2" else GB_OFFSET
    force = CustomGBForce()
    for name in ("charge", "or", "sr"):
        force.addPerParticleParameter(name)
    if model == "GBn2":
        for name in ("alpha", "beta", "gamma"):
            force.addPerParticleParameter(name)
    rows = []
    for q, p in zip(charges, gb_params):
        orad = p[0] - offset
        rows.append([q, orad, p[1] * orad] + list(p[2:]))

    if model in ("GBn", "GBn2"):
        force.addPerParticleParameter("radindex")
        unique = sorted({row[1] for row in rows})
        index = {r: i for i, r in enumerate(unique)}
        tabs = _neck_tables(unique, offset)
        n = len(unique)
        force.addTabulatedFunction("getd0",
                                   Discrete2DFunction(n, n, tabs["d0"]))
        force.addTabulatedFunction("getm0",
                                   Discrete2DFunction(n, n, tabs["m0"]))
        neck_scale = 0.826836 if model == "GBn2" else 0.361825
        force.addComputedValue(
            "I",
            "Ivdw+neckScale*Ineck;"
            "Ineck=step(radius1+radius2+neckCut-r)*getm0(radindex1,radindex2)"
            "/(1+100*(r-getd0(radindex1,radindex2))^2"
            "+0.3*1000000*(r-getd0(radindex1,radindex2))^6);"
            "Ivdw=" + _I_HCT + ";"
            "radius1=or1+offset; radius2=or2+offset;"
            "neckScale=%.16g; neckCut=0.68; offset=%.16g"
            % (neck_scale, offset),
            CustomGBForce.ParticlePairNoExclusions)
        for row in rows:
            row.append(index[row[1]])
    else:
        force.addComputedValue("I", _I_HCT,
                               CustomGBForce.ParticlePairNoExclusions)

    if model == "HCT":
        force.addComputedValue("B", "1/(1/or-I)", CustomGBForce.SingleParticle)
    else:
        force.addComputedValue(
            "B", "1/(1/or-%s/radius);psi=I*or; radius=or+offset; "
            "offset=%.16g" % (_BORN[model], offset),
            CustomGBForce.SingleParticle)

    consts = ("; solventDielectric=%.16g; soluteDielectric=%.16g;"
              " kappa=%.16g; offset=%.16g"
              % (solventDielectric, soluteDielectric, kappa, offset))
    if cutoff is not None:
        consts += "; cutoff=%.16g" % cutoff

    def screened(b):
        """The dielectric factor at the distance or radius `b`."""
        if kappa > 0:
            return ("(1/soluteDielectric-exp(-kappa*%s)/solventDielectric)"
                    % b)
        return "(1/soluteDielectric-1/solventDielectric)"

    force.addEnergyTerm("-0.5*138.935485*" + screened("B") + "*charge^2/B"
                        + consts, CustomGBForce.SingleParticle)
    if SA == "ACE":
        force.addEnergyTerm("28.3919551*(radius+0.14)^2*(radius/B)^6; "
                            "radius=or+offset" + consts,
                            CustomGBForce.SingleParticle)
    elif SA is not None:
        raise ValueError("Unknown surface area method: " + str(SA))
    diel = screened("f")
    f = "f=sqrt(r^2+B1*B2*exp(-r^2/(4*B1*B2)))"
    if cutoff is None:
        force.addEnergyTerm("-138.935485*" + diel + "*charge1*charge2/f;"
                            + f + consts,
                            CustomGBForce.ParticlePairNoExclusions)
    else:
        force.addEnergyTerm(
            "-138.935485*" + diel + "*charge1*charge2*(1/f-%.16g);"
            % (1.0 / cutoff) + f + consts,
            CustomGBForce.ParticlePairNoExclusions)
    for row in rows:
        force.addParticle(row)
    return force


def compute_kappa(saltConc, solventDielectric=78.5, temperature=298.15):
    """The Debye screening kappa (1/nm) of a salt concentration in mol/L,
    with Amber's ion-exclusion factor 0.73."""
    saltConc = float(u.strip(saltConc, u.mole / u.liter))
    temperature = float(u.strip(temperature, u.kelvin))
    return 7.3 * 50.33355 * math.sqrt(saltConc / solventDielectric
                                      / temperature)


def add_implicit_solvent(system, topology, model, charges, radii=None,
                         screens=None, solventDielectric=78.5,
                         soluteDielectric=1.0, SA=None, cutoff=None,
                         kappa=0.0):
    """Attach the GB force for `model` to `system` (the file readers'
    implicit solvent, as the JAX package's add_implicit_solvent):
    radii and screens override the standard tables (a prmtop's RADII and
    SCREEN; screens count for HCT and OBC only, GBn and GBn2 keep their
    refit screens, as sander and pmemd do). OBC2 without salt is a
    GBSAOBCForce, every other model build_gb_force's CustomGBForce."""
    from ..forces.gbsa import GBSAOBCForce
    params = standard_gb_parameters(model, topology)
    if radii is not None:
        for p, r in zip(params, radii):
            p[0] = float(r)
    if screens is not None and model in ("HCT", "OBC1", "OBC2"):
        for p, s in zip(params, screens):
            p[1] = float(s)
    if model == "OBC2" and kappa == 0.0:
        gb = GBSAOBCForce()
        gb.setSoluteDielectric(soluteDielectric)
        gb.setSolventDielectric(solventDielectric)
        if SA is None:
            gb.setSurfaceAreaEnergy(0)
        for q, p in zip(charges, params):
            gb.addParticle(q, p[0], p[1])
        if cutoff is not None:
            gb.setNonbondedMethod(GBSAOBCForce.CutoffNonPeriodic)
            gb.setCutoffDistance(cutoff)
        system.addForce(gb)
        return gb
    gb = build_gb_force(model, charges, params, solventDielectric,
                        soluteDielectric, SA, cutoff, kappa)
    if cutoff is not None:
        gb.setNonbondedMethod(CustomGBForce.CutoffNonPeriodic)
        gb.setCutoffDistance(cutoff)
    system.addForce(gb)
    return gb
