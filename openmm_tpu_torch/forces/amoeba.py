"""The AMOEBA forces: AmoebaVdwForce (buffered 14-7), AmoebaMultipoleForce
(point multipoles with induced dipoles: Direct, Mutual and Extrapolated
polarization; NoCutoff and PME), AmoebaGeneralizedKirkwoodForce
(implicit solvent inside the multipole force, ops/gk.py),
AmoebaTorsionTorsionForce and AmoebaWcaDispersionForce.

Counterpart of openmm_tpu/forces/amoeba.py, which computes the energy
over dense (n, n) pair matrices and takes every force and torque by
jax.grad through the SCF and the local frames. The port computes the same
energy and takes the forces by torch.autograd through the same steps,
over pair lists (ops/amoeba_pairs.py) instead of dense matrices:

- NoCutoff forces list every pair once on the host; the periodic ones
  (vdW CutoffPeriodic, multipole PME) read the lists of one candidate
  state, AmoebaPairs, that the Context's rebuild gate builds at the vdW
  cutoff plus the skin and that serves both cutoffs.
- The covalent scale factors (m, p, d, u) are sparse lists of the ordered
  pairs whose factor is not 1, applied as corrections to the unscaled
  sums; the vdW exclusions are left out of its lists (marked invalid at
  the build of a periodic force's, not listed at NoCutoff).
- Every per-atom sum, and the backward of every gather that autograd
  differentiates, adds in a fixed order (gather / segment_sum), so the
  step program's graph gives the eager loop's bits.
- The PME reciprocal space spreads its ten charge, dipole and quadrupole
  terms as one call of kernel 4 over 10N rows, and takes the dipole
  fields from the potential grid by kernel 5 (pallas_pme
  spread_triple_vjp), which autograd differentiates through kernels 4
  and 5 again; the SCF's reciprocal field is one kernel-4 and one
  kernel-5 call a sweep (_KernelGrid).

Precision: the real space, the frames, the SCF's dipoles and the GK
terms run in float64; the spreads, the grid and the SCF's real-space
dipole fields in float32 (through kernels 4-5) at the "mixed" precision
of a CUDA Context (their plain versions on the CPU);
at "double" in float64 over each atom's B-spline support
(_SparseGrid: the oracle, whose dense plain einsums would take seconds
at 24,000 atoms).

What the port copies from the JAX package, as it is: the SOR sweeps of
the Mutual SCF (omega 0.7, min(maxIter, 30) sweeps at NoCutoff, 60 at
PME) with no convergence test (mutualInducedTargetEpsilon is kept and
not read), the hard-coded covalent scale factors (_scale_entries), no
vdW taper and no dispersion correction.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from .. import unit as u
from ..constants import ONE_4PI_EPS0
from ..ops import geometry as geom
from ..ops import pallas_pme
from ..ops import pme as pme_ops
from ..ops.amoeba_pairs import (Plan, dipole_field, gather, pair_plans,
                                segment_sum, static_pairs)
from .base import Force

_NM = u.nanometer
_E = u.kilojoule_per_mole
F64 = torch.float64
SQRT_PI = math.sqrt(math.pi)
KE = ONE_4PI_EPS0
OMEGA = 0.7                      # the SOR step of the Mutual SCF


def _dot(a, b):
    return (a * b).sum(dim=-1)


def _unit(v):
    return v / torch.sqrt(torch.clamp((v * v).sum(dim=-1, keepdim=True),
                                      min=1e-20))


def _plan(idx, n, device):
    return Plan(torch.as_tensor(np.asarray(idx, np.int64), device=device), n)


class AmoebaVdwForce(Force):
    """Buffered 14-7 van der Waals (AmoebaVdwForce.h; Halgren 1992):
    E = eps_ij (1.07/(rho+0.07))^7 ((1.12/(rho^7+0.12)) - 2), rho = r/r0_ij,
    with cubic-mean sigma and HHG epsilon combining and hydrogen reduction
    factors. A particle's sigma is a radius (the ForceField generator
    halves a file's diameters) and r0_ij a diameter: 2 (s_i^3 + s_j^3) /
    (s_i^2 + s_j^2), 2 sqrt(s_i s_j) or s_i + s_j."""

    NoCutoff = 0
    CutoffPeriodic = 1

    def __init__(self):
        super().__init__()
        self._particles = []   # (parentIndex, sigma, epsilon, reduction)
        self._exclusions = []  # list of lists
        self._sigma_rule = "CUBIC-MEAN"
        self._eps_rule = "HHG"
        self._cutoff = 1.0
        self._method = AmoebaVdwForce.NoCutoff
        self._use_dispersion_correction = False

    def getNumParticles(self):
        return len(self._particles)

    def addParticle(self, parentIndex, sigma, epsilon, reductionFactor,
                    typeIndex=-1):
        self._particles.append((int(parentIndex),
                                float(u.strip(sigma, _NM)),
                                float(u.strip(epsilon, _E)),
                                float(reductionFactor)))
        self._exclusions.append([])
        return len(self._particles) - 1

    def getParticleParameters(self, index):
        return self._particles[index]

    def setParticleParameters(self, index, parentIndex, sigma, epsilon,
                              reductionFactor, typeIndex=-1):
        self._particles[index] = (int(parentIndex),
                                  float(u.strip(sigma, _NM)),
                                  float(u.strip(epsilon, _E)),
                                  float(reductionFactor))

    def setParticleExclusions(self, index, exclusions):
        self._exclusions[index] = [int(x) for x in exclusions]

    def getParticleExclusions(self, index):
        return list(self._exclusions[index])

    def getSigmaCombiningRule(self):
        return self._sigma_rule

    def setSigmaCombiningRule(self, rule):
        self._sigma_rule = str(rule)

    def getEpsilonCombiningRule(self):
        return self._eps_rule

    def setEpsilonCombiningRule(self, rule):
        self._eps_rule = str(rule)

    def getCutoffDistance(self):
        return u.Quantity(self._cutoff, _NM)

    def setCutoffDistance(self, cutoff):
        self._cutoff = float(u.strip(cutoff, _NM))

    def getNonbondedMethod(self):
        return self._method

    def setNonbondedMethod(self, method):
        self._method = int(method)

    def getUseDispersionCorrection(self):
        return self._use_dispersion_correction

    def setUseDispersionCorrection(self, use):
        self._use_dispersion_correction = bool(use)

    def usesPeriodicBoundaryConditions(self):
        return self._method == AmoebaVdwForce.CutoffPeriodic

    def updateParametersInContext(self, context):
        context._update_force_parameters(self)

    def _arrays(self):
        arr = (np.asarray(self._particles, np.float64)
               if self._particles else np.zeros((0, 4), np.float64))
        return arr[:, 0].astype(np.int64), arr[:, 1:]

    def _compile(self, ctx):
        return AmoebaVdwModule(self, ctx)


class _AutogradModule(nn.Module):
    """The CustomModule contract (forces/custom.py) over an energy that
    autograd differentiates: ef runs _energy at float64 positions and
    takes minus its gradient. A module with `pair_set` (the Context's
    AmoebaPairs) reads its pair lists from the state the Context passes;
    energy() without one (the minimizer, a barostat's trial) builds its
    own, NaN when it overflowed."""

    pair_set = None

    def ef(self, pos, box, state=None):
        with torch.enable_grad():
            x = pos.detach().to(F64).requires_grad_(True)
            energy = self._energy(x, box, state)
            (grad,) = torch.autograd.grad(energy, x, allow_unused=True)
        if grad is None:
            grad = torch.zeros_like(x)
        return energy.detach(), -grad.detach()

    def energy(self, pos, box, state=None):
        if self.pair_set is not None and state is None:
            state = self.pair_set.build_state(pos.detach(), box)
            energy = self._energy(pos.to(F64), box, state)
            return torch.where(state["overflow"] > 0,
                               torch.full_like(energy, math.nan), energy)
        return self._energy(pos.to(F64), box, state)

    def parameter_derivatives(self, pos, box) -> dict:
        return {}


class AmoebaVdwModule(_AutogradModule):
    def __init__(self, force, ctx):
        super().__init__()
        n = ctx._n
        if len(force._particles) != n:
            raise ValueError("AmoebaVdwForce must have same particle count "
                             "as the System")
        self.name, self.group, self.derivs = (force.getName(),
                                              force.getForceGroup(), ())
        dev = ctx._device
        self.n = n
        parents, par = force._arrays()
        self.register_buffer("par", torch.as_tensor(par, dtype=F64,
                                                    device=dev))
        self.parent = _plan(parents, n, dev)
        self.sigma_rule = force._sigma_rule.upper()
        self.eps_rule = force._eps_rule.upper()
        self.periodic = force.usesPeriodicBoundaryConditions()
        self.cutoff = (force._cutoff if force._method
                       != AmoebaVdwForce.NoCutoff else None)
        excl = {(min(i, j), max(i, j)) for i, ex in
                enumerate(force._exclusions) for j in ex if j != i}
        excl = np.asarray(sorted(excl), np.int64).reshape(-1, 2)
        self._parents = parents
        if self.periodic:
            # the site sits within (1 - reduction) of a bond of its atom:
            # the list reaches that much further
            margin = 0.05 if np.any(par[:, 2] != 1.0) else 0.0
            self.pair_set = ctx._amoeba_pair_set()
            self.pair_set.check(force._cutoff)
            self.key = self.pair_set.add("vdw", force._cutoff + margin, excl)
        else:
            keep = np.ones((n, n), bool)
            keep[excl[:, 0], excl[:, 1]] = False
            iu, ju = np.triu_indices(n, 1)
            keep = keep[iu, ju]
            self.all_pairs = static_pairs(iu[keep], ju[keep], n, dev)

    def update(self, force) -> None:
        parents, par = force._arrays()
        if not np.array_equal(parents, self._parents):
            raise ValueError("updateParametersInContext: the parent atoms of "
                             "the AmoebaVdwForce have changed")
        self.par.copy_(torch.as_tensor(par, dtype=F64))

    def _pair_energy(self, site, box, state, prefix):
        pi, pj, valid = pair_plans(state, prefix, self.n)
        dr = gather(site, pi) - gather(site, pj)
        if self.periodic:
            dr = geom.periodic_delta(dr, box.to(F64))
        r = torch.sqrt(torch.where(valid, _dot(dr, dr), 1.0))
        s, e = self.par[:, 0], self.par[:, 1]
        si, sj = s[pi.read], s[pj.read]
        ei, ej = e[pi.read], e[pj.read]
        if self.sigma_rule == "CUBIC-MEAN":
            # OpenMM's cubic mean of radii (AmoebaReferenceVdwForce.cpp
            # cubicMeanSigmaCombiningRule), a diameter like the other two
            # rules; the JAX package leaves out the 2 (ROADMAP, notes on
            # the reference)
            r0 = 2.0 * (si ** 3 + sj ** 3) / (si ** 2 + sj ** 2)
        elif self.sigma_rule == "GEOMETRIC":
            r0 = 2.0 * torch.sqrt(si * sj)
        else:
            r0 = si + sj
        if self.eps_rule == "HHG":
            e0 = 4.0 * ei * ej / (torch.sqrt(ei) + torch.sqrt(ej)) ** 2
        elif self.eps_rule == "GEOMETRIC":
            e0 = torch.sqrt(ei * ej)
        else:
            e0 = 0.5 * (ei + ej)
        rho = r / r0
        t1 = (1.07 / (rho + 0.07)) ** 7
        t2 = 1.12 / (rho ** 7 + 0.12) - 2.0
        keep = valid if self.cutoff is None else valid & (r < self.cutoff)
        return torch.where(keep, e0 * t1 * t2, 0.0).sum()

    def _energy(self, pos, box, state):
        red = self.par[:, 2:3]
        parent = gather(pos, self.parent)
        site = parent + red * (pos - parent)
        if not self.periodic:
            return self._pair_energy(site, box, self.all_pairs, "")
        return self._pair_energy(site, box, state, self.key)


class AmoebaMultipoleForce(Force):
    """Point multipoles with induced-dipole polarization
    (AmoebaMultipoleForce.h:72-92): NoCutoff and PME, Mutual (SOR
    fixed point) / Direct / Extrapolated polarization, Thole damping,
    local-frame multipole rotation (ZThenX / Bisector / ZBisect /
    ThreeFold / ZOnly / NoAxisType)."""

    NoCutoff = 0
    PME = 1
    Mutual = 0
    Direct = 1
    Extrapolated = 2
    ZThenX = 0
    Bisector = 1
    ZBisect = 2
    ThreeFold = 3
    ZOnly = 4
    NoAxisType = 5

    Covalent12 = 0
    Covalent13 = 1
    Covalent14 = 2
    Covalent15 = 3
    PolarizationCovalent11 = 4
    PolarizationCovalent12 = 5
    PolarizationCovalent13 = 6
    PolarizationCovalent14 = 7

    def __init__(self):
        super().__init__()
        self._particles = []   # dicts
        self._covalent = []    # list of dict type -> [indices]
        self._method = AmoebaMultipoleForce.NoCutoff
        self._polarization = AmoebaMultipoleForce.Mutual
        self._cutoff = 1.0
        self._mutual_max_iter = 60
        self._mutual_eps = 1e-5
        self._extrapolation_coefficients = [-0.154, 0.017, 0.657, 0.475]
        self._aewald = 0.0
        self._pme_grid = (0, 0, 0)
        self._ewald_tol = 1e-4

    def getNumMultipoles(self):
        return len(self._particles)

    @staticmethod
    def _entry(charge, molecularDipole, molecularQuadrupole, axisType,
               multipoleAtomZ, multipoleAtomX, multipoleAtomY, thole,
               dampingFactor, polarity):
        return {
            "charge": float(u.strip(charge, u.elementary_charge)),
            "dipole": [float(x) for x in u.strip(molecularDipole)],
            "quadrupole": [float(x) for x in u.strip(molecularQuadrupole)],
            "axisType": int(axisType),
            "atomZ": int(multipoleAtomZ),
            "atomX": int(multipoleAtomX),
            "atomY": int(multipoleAtomY),
            "thole": float(thole),
            "damp": float(dampingFactor),
            "polarity": float(u.strip(polarity)),
        }

    def addMultipole(self, charge, molecularDipole, molecularQuadrupole,
                     axisType, multipoleAtomZ, multipoleAtomX,
                     multipoleAtomY, thole, dampingFactor, polarity):
        self._particles.append(self._entry(
            charge, molecularDipole, molecularQuadrupole, axisType,
            multipoleAtomZ, multipoleAtomX, multipoleAtomY, thole,
            dampingFactor, polarity))
        self._covalent.append({})
        return len(self._particles) - 1

    def getMultipoleParameters(self, index):
        p = self._particles[index]
        return (p["charge"], p["dipole"], p["quadrupole"], p["axisType"],
                p["atomZ"], p["atomX"], p["atomY"], p["thole"], p["damp"],
                p["polarity"])

    def setMultipoleParameters(self, index, charge, molecularDipole,
                               molecularQuadrupole, axisType, multipoleAtomZ,
                               multipoleAtomX, multipoleAtomY, thole,
                               dampingFactor, polarity):
        self._particles[index] = self._entry(
            charge, molecularDipole, molecularQuadrupole, axisType,
            multipoleAtomZ, multipoleAtomX, multipoleAtomY, thole,
            dampingFactor, polarity)

    def setCovalentMap(self, index, typeId, covalentAtoms):
        self._covalent[index][int(typeId)] = [int(x) for x in covalentAtoms]

    def getCovalentMap(self, index, typeId):
        return list(self._covalent[index].get(int(typeId), []))

    def getNonbondedMethod(self):
        return self._method

    def setNonbondedMethod(self, method):
        self._method = int(method)

    def getPolarizationType(self):
        return self._polarization

    def setPolarizationType(self, ptype):
        self._polarization = int(ptype)

    def getCutoffDistance(self):
        return u.Quantity(self._cutoff, _NM)

    def setCutoffDistance(self, cutoff):
        self._cutoff = float(u.strip(cutoff, _NM))

    def getMutualInducedMaxIterations(self):
        return self._mutual_max_iter

    def setMutualInducedMaxIterations(self, n):
        self._mutual_max_iter = int(n)

    def getMutualInducedTargetEpsilon(self):
        return self._mutual_eps

    def setMutualInducedTargetEpsilon(self, eps):
        self._mutual_eps = float(eps)

    def getExtrapolationCoefficients(self):
        return list(self._extrapolation_coefficients)

    def setExtrapolationCoefficients(self, coeffs):
        self._extrapolation_coefficients = [float(c) for c in coeffs]

    def getAEwald(self):
        return self._aewald

    def setAEwald(self, aewald):
        self._aewald = float(u.strip(aewald, _NM ** -1))

    def getPmeGridDimensions(self):
        return list(self._pme_grid)

    def setPmeGridDimensions(self, dims):
        self._pme_grid = tuple(int(d) for d in dims)

    def getEwaldErrorTolerance(self):
        return self._ewald_tol

    def setEwaldErrorTolerance(self, tol):
        self._ewald_tol = float(tol)

    def usesPeriodicBoundaryConditions(self):
        return self._method == AmoebaMultipoleForce.PME

    def updateParametersInContext(self, context):
        context._update_force_parameters(self)

    def getInducedDipoles(self, context):
        """The induced dipoles (n, 3) at the Context's current positions,
        as a float64 numpy array."""
        module = context._modules[id(self)]
        state = context._module_state(module.pair_set, context._current_tiles()) \
            if module.pair_set is not None else None
        with torch.no_grad():
            mu = module.induced(context._state["positions"].to(F64),
                                context._state["box"], state)
        return mu.cpu().numpy()

    def _arrays(self):
        """(per-particle parameters (n, 16): charge, dipole (3),
        quadrupole (9), thole, damp, polarity; frames (n, 4): axis type,
        atoms z, x, y)."""
        rows = [[p["charge"], *p["dipole"], *p["quadrupole"], p["thole"],
                 p["damp"], p["polarity"]] for p in self._particles]
        frames = [[p["axisType"], p["atomZ"], p["atomX"], p["atomY"]]
                  for p in self._particles]
        return (np.asarray(rows, np.float64).reshape(-1, 16),
                np.asarray(frames, np.int64).reshape(-1, 4))

    def _scale_entries(self):
        """{(i, j): [m, p, d, u]} of the ordered pairs i != j whose
        covalent scale factors are not all 1 (the JAX _scale_matrices,
        sparse): m-scale 0 for 1-2 and 1-3, 0.4 for 1-4, 0.8 for 1-5;
        p-scale 0 for 1-2 and 1-3, 0.5 for a 1-4 pair in the
        polarization group; d-scale 0 in the group; u-scale 1."""
        out = {}

        def put(i, j, k, v):
            if i != j:
                out.setdefault((i, j), [1.0, 1.0, 1.0, 1.0])[k] = v

        for i, cov in enumerate(self._covalent):
            for j in cov.get(self.Covalent12, []):
                put(i, j, 0, 0.0)
            for j in cov.get(self.Covalent13, []):
                put(i, j, 0, 0.0)
            for j in cov.get(self.Covalent14, []):
                put(i, j, 0, 0.4)
            for j in cov.get(self.Covalent15, []):
                put(i, j, 0, 0.8)
            group = set(cov.get(self.PolarizationCovalent11, []))
            for j in cov.get(self.Covalent12, []):
                put(i, j, 1, 0.0)
            for j in cov.get(self.Covalent13, []):
                put(i, j, 1, 0.0)
            for j in cov.get(self.Covalent14, []):
                put(i, j, 1, 0.5 if j in group else 1.0)
            for j in group:
                put(i, j, 2, 0.0)
                put(i, j, 3, 1.0)
        return {k: v for k, v in out.items() if v != [1.0, 1.0, 1.0, 1.0]}

    def _compile(self, ctx):
        return AmoebaMultipoleModule(self, ctx)


def _frame_plans(frames, n, device):
    """The gathers of each site's z, x and y frame atoms. A missing atom
    (-1) reads the site itself: the axis types that leave it out never use
    the direction (the JAX package reads atom 0 there), and a table of
    atom 0's readers would be as wide as the system."""
    own = np.arange(n)
    return tuple(_plan(np.where(frames[:, k] >= 0, frames[:, k], own), n,
                       device) for k in (1, 2, 3))


def _rotations(pos, frames, axis, consts):
    """The lab rotation matrix of every site (n, 3, 3), rows the lab
    directions of its x, y and z axes (JAX amoeba.py rotation_matrices,
    with the degenerate-x fallback)."""
    pz, px, py = frames
    zdir = gather(pos, pz) - pos
    xdir = gather(pos, px) - pos
    ydir = gather(pos, py) - pos
    ex, ey, ez, eye = consts
    at = axis[:, None]
    uz = _unit(zdir)
    uz = torch.where(at == AmoebaMultipoleForce.Bisector,
                     _unit(_unit(zdir) + _unit(xdir)), uz)
    uz = torch.where(at == AmoebaMultipoleForce.ThreeFold,
                     _unit(_unit(zdir) + _unit(xdir) + _unit(ydir)), uz)
    ux_raw = torch.where(at == AmoebaMultipoleForce.ZBisect,
                         _unit(_unit(xdir) + _unit(ydir)), _unit(xdir))
    ux_raw = torch.where(at == AmoebaMultipoleForce.ZOnly, ex, ux_raw)
    ux = _unit(ux_raw - uz * (ux_raw * uz).sum(dim=-1, keepdim=True))
    alt = torch.linalg.cross(uz, ez.expand_as(uz), dim=-1)
    alt2 = torch.linalg.cross(uz, ey.expand_as(uz), dim=-1)
    alt = torch.where((alt * alt).sum(dim=-1, keepdim=True) > 0.01, alt,
                      alt2)
    bad = (ux * ux).sum(dim=-1, keepdim=True) < 1e-8
    ux = torch.where(bad, _unit(alt), ux)
    uy = torch.linalg.cross(uz, ux, dim=-1)
    rot = torch.stack([ux, uy, uz], dim=-2)
    return torch.where((at == AmoebaMultipoleForce.NoAxisType)[..., None],
                       eye, rot)


def lab_multipoles(rot, dipole, quad):
    """(lab dipoles (n, 3) = R^T d, lab quadrupoles (n, 3, 3) = R^T Q R)."""
    d_lab = (rot * dipole[:, :, None]).sum(dim=1)
    tmp = (quad[:, :, :, None] * rot[:, None, :, :]).sum(dim=2)
    q_lab = (rot[:, :, :, None] * tmp[:, :, None, :]).sum(dim=1)
    return d_lab, q_lab


class _Contractions:
    """The scalar and vector contractions of two sites' multipoles with
    their displacement dr = r_i - r_j (JAX amoeba.py contractions), for
    a batch of pairs."""

    def __init__(self, qi, qj, di, dj, Qi, Qj, dr):
        self.qi, self.qj, self.di, self.dj, self.dr = qi, qj, di, dj, dr
        self.di_r, self.dj_r, self.di_dj = _dot(di, dr), _dot(dj, dr), \
            _dot(di, dj)
        self.Qi_r = (Qi * dr[:, None, :]).sum(dim=-1)
        self.Qj_r = (Qj * dr[:, None, :]).sum(dim=-1)
        self.rQi_r, self.rQj_r = _dot(self.Qi_r, dr), _dot(self.Qj_r, dr)
        self.trQi = Qi[:, 0, 0] + Qi[:, 1, 1] + Qi[:, 2, 2]
        self.trQj = Qj[:, 0, 0] + Qj[:, 1, 1] + Qj[:, 2, 2]
        self.di_Qj_r, self.dj_Qi_r = _dot(di, self.Qj_r), _dot(dj, self.Qi_r)
        self.Qi_Qj = (Qi * Qj).sum(dim=(1, 2))
        self.QiQj_rr = _dot(self.Qi_r, self.Qj_r)

    def energy(self, k1, k2, k3, k4, k5):
        """The pair's multipole energy with radial kernels k1..k5 (plain:
        1/r, 1/r^3, ..., 1/r^9; Ewald: B0, B1, B2/3, B3/15, B4/105)."""
        c = self
        e = c.qi * c.qj * k1
        e = e + (-c.qj * c.di_r + c.qi * c.dj_r) * k2
        e = e - (3.0 * c.di_r * c.dj_r * k3 - c.di_dj * k2)
        e = e + (c.qi * (3.0 * c.rQj_r * k3 - c.trQj * k2)
                 + c.qj * (3.0 * c.rQi_r * k3 - c.trQi * k2))
        t3_i = (-15.0 * c.di_r * c.rQj_r * k4
                + 3.0 * (c.di_r * c.trQj + 2.0 * c.di_Qj_r) * k3)
        t3_j = (-15.0 * c.dj_r * c.rQi_r * k4
                + 3.0 * (c.dj_r * c.trQi + 2.0 * c.dj_Qi_r) * k3)
        e = e + (t3_i - t3_j)
        t4 = (105.0 * c.rQi_r * c.rQj_r * k5
              - 15.0 * (c.rQi_r * c.trQj + c.rQj_r * c.trQi
                        + 4.0 * c.QiQj_rr) * k4
              + 3.0 * (c.trQi * c.trQj + 2.0 * c.Qi_Qj) * k3)
        return e + t4

    def fields(self, k2, k3, k4, trace):
        """(field at i from j, field at j from i) with radial kernels
        k2..k4; `trace` adds the quadrupole trace term of the PME form
        (JAX tensor_field), which the NoCutoff form leaves out."""
        c = self

        def field(q, d, q_r, rq_r, tr, d_r, dr):
            f = ((q * k2 + 3.0 * d_r * k3 + 15.0 * rq_r * k4)[:, None] * dr
                 - d * k2[:, None] - 6.0 * q_r * k3[:, None])
            if trace:
                f = f - (3.0 * tr * k3)[:, None] * dr
            return f

        return (field(c.qj, c.dj, c.Qj_r, c.rQj_r, c.trQj, c.dj_r, c.dr),
                field(c.qi, c.di, -c.Qi_r, c.rQi_r, c.trQi, -c.di_r, -c.dr))


class _KernelGrid:
    """The reciprocal space through kernels 4-5: each atom's B-spline
    weights as dense (n, n_axis) planes, a spread of several terms as one
    call of kernel 4 over their rows stacked, the gradient of a potential
    grid in the fractional dipoles from one call of kernel 5 on
    (phi, Wx, Wy, Wz), both autograd Functions (pallas_pme)."""

    def __init__(self, stacks, base, grid, dtype):
        self.planes = [[pme_ops.dense_axis_weights(
            s[:, axis], base[:, axis], 4, grid[axis]).to(dtype)
            for s in stacks] for axis in range(3)]
        self.dtype = dtype
        self.stacked = {}

    def spread(self, terms):
        """One kernel-4 call over the terms' rows: each term a coefficient
        (n,) and the derivative orders of its x, y and z planes. The
        stacked planes of a pattern of orders are built once (the SCF
        spreads one pattern 60 times)."""
        key = tuple(k[1:] for k in terms)
        if key not in self.stacked:
            (px, py, pz) = self.planes
            self.stacked[key] = tuple(torch.cat([p[k[axis]] for k in key])
                                      for axis, p in enumerate((px, py, pz)))
        rows_x, rows_y, rows_z = self.stacked[key]
        coef = torch.cat([c for c, _, _, _ in terms]).to(self.dtype)
        return pallas_pme.spread_triple(coef[:, None] * rows_x, rows_y,
                                        rows_z)

    def frac_gradient(self, phi):
        (wx, dwx, _), (wy, dwy, _), (wz, dwz, _) = self.planes
        ga, gy, gz = pallas_pme.spread_triple_vjp(phi, wx, wy, wz)
        return torch.stack([_dot(dwx, ga), _dot(dwy, gy), _dot(dwz, gz)],
                           dim=1).to(F64)


class _SparseGrid:
    """The float64 reciprocal space of the "double" precision: the same
    sums over each atom's 5x5x5 B-spline support only (the dense planes
    are zero elsewhere), by index_add into the grid and gathers from it,
    which autograd differentiates to any order. Its float64 atomic adds
    change their order on a card, so its bits may differ from call to
    call there."""

    def __init__(self, stacks, base, grid, dtype):
        nx, ny, nz = grid
        self.n_cells = nx * ny * nz
        sizes = torch.tensor(grid, device=base.device)
        g = torch.remainder(base[:, :, None] + torch.arange(
            5, device=base.device) - 4, sizes[:, None])     # (n, 3, 5)
        self.idx = ((g[:, 0, :, None, None] * ny + g[:, 1, None, :, None])
                    * nz + g[:, 2, None, None, :]).reshape(-1)
        self.w = stacks

    def _outer(self, kx, ky, kz):
        x, y, z = self.w[kx][:, 0], self.w[ky][:, 1], self.w[kz][:, 2]
        return x[:, :, None, None] * y[:, None, :, None] * z[:, None, None, :]

    def spread(self, terms):
        vals = sum(c[:, None, None, None] * self._outer(kx, ky, kz)
                   for c, kx, ky, kz in terms)
        q = vals.new_zeros(self.n_cells)
        return q.index_add(0, self.idx, vals.reshape(-1))

    def frac_gradient(self, phi):
        at = phi.reshape(-1)[self.idx].reshape(-1, 5, 5, 5)
        return torch.stack([(at * self._outer(1, 0, 0)).sum(dim=(1, 2, 3)),
                            (at * self._outer(0, 1, 0)).sum(dim=(1, 2, 3)),
                            (at * self._outer(0, 0, 1)).sum(dim=(1, 2, 3))],
                           dim=1)


class AmoebaMultipoleModule(_AutogradModule):
    """The compiled AmoebaMultipoleForce (with the System's
    AmoebaGeneralizedKirkwoodForce at NoCutoff)."""

    def __init__(self, force, ctx):
        super().__init__()
        n = ctx._n
        if len(force._particles) != n:
            raise ValueError("AmoebaMultipoleForce must have same particle "
                             "count as System")
        self.name, self.group, self.derivs = (force.getName(),
                                              force.getForceGroup(), ())
        dev = ctx._device
        self.n = n
        par, frames = force._arrays()
        self._frames = frames
        self.register_buffer("par", torch.as_tensor(par, dtype=F64,
                                                    device=dev))
        self.register_buffer("axis", torch.as_tensor(frames[:, 0],
                                                     device=dev))
        self.frames = _frame_plans(frames, n, dev)
        eye = torch.eye(3, dtype=F64, device=dev)
        self.consts = (eye[0], eye[1], eye[2], eye)
        self.pme = force._method == AmoebaMultipoleForce.PME
        self.polarization = force._polarization
        self.max_iter = min(force._mutual_max_iter, 60 if self.pme else 30)
        self.ext = list(force._extrapolation_coefficients)
        # the ordered pairs whose scale factors are not all 1
        entries = force._scale_entries()
        keys = sorted(entries)
        ci = np.asarray([k[0] for k in keys], np.int64)
        cj = np.asarray([k[1] for k in keys], np.int64)
        self.corr = (_plan(ci, n, dev), _plan(cj, n, dev))
        self.register_buffer("scales", torch.as_tensor(
            np.asarray([entries[k] for k in keys], np.float64).reshape(-1, 4),
            device=dev))
        # the u-scale is 1 for every pair the force field makes
        self.has_u = any(v[3] != 1.0 for v in entries.values())
        self.gk = None
        # "mixed": kernels 4-5 in float32 (their plain versions on the
        # CPU); "double": the float64 sparse route (the oracle)
        self.sparse = ctx._precision == "double"
        self.dtype = torch.float64 if self.sparse else torch.float32
        if self.pme:
            self.cutoff = force._cutoff
            box0 = np.asarray(ctx._system._box, np.float64)
            widths = [box0[0][0], box0[1][1], box0[2][2]]
            alpha = force._aewald
            if alpha <= 0.0:
                alpha = pme_ops.ewald_alpha(self.cutoff, force._ewald_tol)
            self.alpha = alpha
            grid = (tuple(force._pme_grid) if all(force._pme_grid) else
                    tuple(pme_ops.pme_grid_size(widths, alpha,
                                                force._ewald_tol)))
            self.grid = grid
            md = pme_ops.make_pme_recip_data(grid, 5, zeta=True)
            for key in ("bsq_x", "bsq_y", "bsq_z"):
                self.register_buffer(key, torch.as_tensor(md[key],
                                                          device=dev))
            self.register_buffer("sizes", torch.tensor(
                grid, dtype=F64, device=dev))
            self.pair_set = ctx._amoeba_pair_set()
            self.pair_set.check(self.cutoff)
            self.key = self.pair_set.add("mpole", self.cutoff)
        else:
            iu, ju = np.triu_indices(n, 1)
            self.all_pairs = static_pairs(iu, ju, n, dev)
            for f in ctx._forces:
                if isinstance(f, AmoebaGeneralizedKirkwoodForce):
                    self.gk = f
            if self.gk is not None:
                gk = np.asarray(self.gk._particles,
                                np.float64).reshape(-1, 3)
                self.register_buffer("gk_par", torch.as_tensor(
                    gk, device=dev))
                # GK's quadrupole weights, on the device once (a copy from
                # the host cannot be captured)
                self.register_buffer("gk_offd", torch.tensor(
                    [1.0, 2.0, 2.0, 1.0, 2.0, 1.0], dtype=F64, device=dev))

    def update(self, force) -> None:
        par, frames = force._arrays()
        if (not np.array_equal(frames, self._frames)
                or force._scale_entries() != self._entries_now()):
            raise ValueError("updateParametersInContext: the frames or the "
                             "covalent maps of the AmoebaMultipoleForce "
                             "have changed")
        self.par.copy_(torch.as_tensor(par, dtype=F64))
        if self.gk is not None:
            self.gk_par.copy_(torch.as_tensor(np.asarray(
                self.gk._particles, np.float64).reshape(-1, 3)))

    def _entries_now(self):
        ci = self.corr[0].idx.cpu().numpy()
        cj = self.corr[1].idx.cpu().numpy()
        s = self.scales.cpu().numpy()
        return {(int(a), int(b)): list(map(float, v))
                for a, b, v in zip(ci, cj, s)}

    # -- the multipoles and the pairs --------------------------------------
    def _lab(self, pos):
        rot = _rotations(pos, self.frames, self.axis, self.consts)
        quad = self.par[:, 4:13].reshape(-1, 3, 3)
        return lab_multipoles(rot, self.par[:, 1:4], quad)

    def _pair_data(self, pos, box, d_lab, q_lab, pi, pj, valid):
        dr = gather(pos, pi) - gather(pos, pj)
        if self.pme:
            dr = geom.periodic_delta(dr, box.to(F64))
        r = torch.sqrt(torch.where(valid, _dot(dr, dr), 1.0))
        q9 = q_lab.reshape(-1, 9)
        charge = self.par[:, 0]
        c = _Contractions(charge[pi.read], charge[pj.read],
                          gather(d_lab, pi), gather(d_lab, pj),
                          gather(q9, pi).view(-1, 3, 3),
                          gather(q9, pj).view(-1, 3, 3), dr)
        return c, r

    def _thole(self, r, pi, pj, valid):
        """(lam3, lam5, lam7) of the Thole damping, 0 off `valid`."""
        thole, damp = self.par[:, 13], self.par[:, 14]
        dd = damp[pi.read] * damp[pj.read]
        dd = torch.where(dd > 0, dd, 1.0)
        a_th = torch.minimum(thole[pi.read], thole[pj.read])
        uu = a_th * (r / dd) ** 3
        expu = torch.exp(-torch.clamp(uu, max=50.0))
        lam3 = torch.where(valid, 1.0 - expu, 0.0)
        lam5 = torch.where(valid, 1.0 - (1.0 + uu) * expu, 0.0)
        lam7 = torch.where(valid, 1.0 - (1.0 + uu + 0.6 * uu * uu) * expu,
                           0.0)
        return lam3, lam5, lam7

    def _bn(self, r, within):
        """The Ewald real-space kernels (B0, B1, B2/3, B3/15, B4/105),
        0 off `within`."""
        alpha = self.alpha
        ar = alpha * r
        exp2a = torch.exp(-ar * ar)
        inv_r2 = 1.0 / (r * r)
        b0 = torch.special.erfc(ar) / r
        alsq2 = 2.0 * alpha * alpha
        alsq2n = (1.0 / (SQRT_PI * alpha)) * alsq2
        b1 = (b0 + alsq2n * exp2a) * inv_r2
        alsq2n = alsq2n * alsq2
        b2 = (3.0 * b1 + alsq2n * exp2a) * inv_r2
        alsq2n = alsq2n * alsq2
        b3 = (5.0 * b2 + alsq2n * exp2a) * inv_r2
        alsq2n = alsq2n * alsq2
        b4 = (7.0 * b3 + alsq2n * exp2a) * inv_r2
        w = within.to(F64)
        return (b0 * w, b1 * w, b2 / 3.0 * w, b3 / 15.0 * w, b4 / 105.0 * w)

    @staticmethod
    def _inv(r, valid):
        w = valid.to(F64)
        inv = 1.0 / r
        inv2 = inv * inv
        return [inv * w, inv * inv2 * w, inv * inv2 ** 2 * w,
                inv * inv2 ** 3 * w, inv * inv2 ** 4 * w]

    def _corrections(self, pos, box, d_lab, q_lab, field_scales):
        """Over the ordered correction pairs (i, j): the m-scale energy
        correction 0.5 k_e sum (m - 1) e_plain, the field corrections at
        i from j for each column of `field_scales` (s -> the Thole-damped
        field times its factor), and what the SCF's u correction needs."""
        ci, cj = self.corr
        valid = torch.ones(ci.idx.shape, dtype=torch.bool,
                           device=pos.device)
        c, r = self._pair_data(pos, box, d_lab, q_lab, ci, cj, valid)
        inv = self._inv(r, valid)
        m = self.scales[:, 0]
        energy = 0.5 * KE * ((m - 1.0) * c.energy(*inv)).sum()
        lam3, lam5, lam7 = self._thole(r, ci, cj, valid)
        fields = []
        for factor in field_scales:
            f = c.fields(factor * lam3 * inv[1], factor * lam5 * inv[2],
                         factor * lam7 * inv[3], self.pme)[0]
            fields.append(segment_sum(f, ci))
        return energy, fields, (c.dr, lam3 * inv[1], lam5 * inv[2])

    # -- the reciprocal space ------------------------------------------------
    def _recip_setup(self, pos, box):
        """(the B-spline weights of every atom as a grid route:
        _KernelGrid's dense planes for kernels 4-5, or _SparseGrid's
        supports at "double"; the fractional Jacobian J = box^-1
        diag(grid); the grid's kernel G B)."""
        binv = geom.box_inverse(box.to(F64))
        frac = geom.to_fractional(pos, binv)
        frac = frac - torch.floor(frac)
        u3 = frac * self.sizes
        base = torch.floor(u3)
        t = u3 - base
        stacks = pme_ops.bspline_w_dw_d2w(t, 5)         # each (n, 3, 5)
        route = (_SparseGrid if self.sparse else _KernelGrid)(
            stacks, base.long(), self.grid, self.dtype)
        jac = binv * self.sizes[None, :]
        bmod = (self.bsq_x[:, None, None] * self.bsq_y[None, :, None]
                * self.bsq_z[None, None, :])
        green = pme_ops.recip_green(self.grid, box, self.alpha) * bmod
        return route, jac, green

    def _dipole_gradient(self, route, phi, jac):
        """dE/d(lab dipole) (n, 3) float64 of the grid energy whose
        potential grid is phi: its gradient in the fractional dipoles,
        carried through J."""
        g_frac = route.frac_gradient(phi)
        return (g_frac[:, None, :] * jac[None, :, :]).sum(dim=-1)

    def _recip_perm(self, d_lab, q_lab, route, jac, green, box):
        """(reciprocal energy of the permanent multipoles, its field)."""
        charge = self.par[:, 0]
        df = (d_lab[:, :, None] * jac[None]).sum(dim=1)
        tmp = (q_lab[:, :, :, None] * jac[None, None]).sum(dim=2)
        qf = (jac[None, :, :, None] * tmp[:, :, None, :]).sum(dim=1)
        # (coefficient, derivative orders on x, y, z): the charge, the
        # fractional dipole and quadrupole terms of JAX amoeba.py:792-802
        terms = [(charge, 0, 0, 0), (df[:, 0], 1, 0, 0), (df[:, 1], 0, 1, 0),
                 (df[:, 2], 0, 0, 1), (qf[:, 0, 0], 2, 0, 0),
                 (qf[:, 1, 1], 0, 2, 0), (qf[:, 2, 2], 0, 0, 2),
                 (2.0 * qf[:, 0, 1], 1, 1, 0), (2.0 * qf[:, 0, 2], 1, 0, 1),
                 (2.0 * qf[:, 1, 2], 0, 1, 1)]
        q = route.spread(terms)
        energy = pme_ops.recip_energy_from_grid(
            q, box, self.grid, self.alpha, self.bsq_x, self.bsq_y,
            self.bsq_z)
        phi = pme_ops.recip_potential(q, green, self.grid)
        return energy, -self._dipole_gradient(route, phi, jac) / KE

    def _recip_dipole_field(self, mu, route, jac, green):
        muf = (mu[:, :, None] * jac[None]).sum(dim=1)
        q = route.spread([(muf[:, 0], 1, 0, 0), (muf[:, 1], 0, 1, 0),
                          (muf[:, 2], 0, 0, 1)])
        phi = pme_ops.recip_potential(q, green, self.grid)
        return -self._dipole_gradient(route, phi, jac) / KE

    # -- the energy ------------------------------------------------------------
    def _fields_and_energy(self, pos, box, state):
        """(permanent energy, the fixed field that polarizes, the field
        the polarization energy contracts, the SCF's dipole-field
        operator)."""
        d_lab, q_lab = self._lab(pos)
        if self.pme:
            pi, pj, valid = pair_plans(state, self.key, self.n)
        else:
            pi, pj, valid = pair_plans(self.all_pairs, "", self.n)
        c, r = self._pair_data(pos, box, d_lab, q_lab, pi, pj, valid)
        inv = self._inv(r, valid)
        lam3, lam5, lam7 = self._thole(r, pi, pj, valid)
        d, p_s, u_s = self.scales[:, 2], self.scales[:, 1], self.scales[:, 3]
        if self.pme:
            within = valid & (r < self.cutoff)
            kb = self._bn(r, within)
            e_pairs = KE * c.energy(*kb).sum()
            # full Bn minus the (1 - thole)-damped plain field; the
            # d-scale of the group pairs is a correction
            fi, fj = c.fields(kb[1] - (1.0 - lam3) * inv[1],
                              kb[2] - (1.0 - lam5) * inv[2],
                              kb[3] - (1.0 - lam7) * inv[3], True)
            e_corr, (f_corr,), u_data = self._corrections(
                pos, box, d_lab, q_lab, [-(1.0 - d)])
            field = segment_sum(fi, pi) + segment_sum(fj, pj) + f_corr
            route, jac, green = self._recip_setup(pos, box)
            e_recip, field_recip = self._recip_perm(d_lab, q_lab, route,
                                                    jac, green, box)
            alpha = self.alpha
            self_term = (4.0 / 3.0) * alpha ** 3 / SQRT_PI
            field = field + field_recip + self_term * d_lab
            charge = self.par[:, 0]
            a2 = alpha * alpha
            e_self = (-KE * alpha / SQRT_PI) * (
                (charge * charge).sum()
                + (2.0 / 3.0) * a2 * (d_lab * d_lab).sum()
                + (8.0 / 5.0) * a2 * a2 * (q_lab * q_lab).sum())
            e_perm = e_pairs + e_corr + e_recip + e_self
            k2 = kb[1] - (1.0 - lam3) * inv[1]
            k3 = kb[2] - (1.0 - lam5) * inv[2]
            def extra(mu):
                return (self._recip_dipole_field(mu, route, jac, green)
                        + self_term * mu)

            # the SCF's real-space sweeps at the spreads' precision
            op = (c.dr.to(self.dtype), k2.to(self.dtype), k3.to(self.dtype),
                  pi, pj, u_s - 1.0, u_data, extra)
            return e_perm, field, field, op, (d_lab, q_lab)
        e_perm = KE * c.energy(*inv).sum()
        fi, fj = c.fields(lam3 * inv[1], lam5 * inv[2], lam7 * inv[3],
                          False)
        e_corr, (fd, fp), u_data = self._corrections(
            pos, box, d_lab, q_lab, [d - 1.0, p_s - 1.0])
        base = segment_sum(fi, pi) + segment_sum(fj, pj)
        op = (c.dr, lam3 * inv[1], lam5 * inv[2], pi, pj, u_s - 1.0, u_data,
              None)
        return e_perm + e_corr, base + fd, base + fp, op, (d_lab, q_lab)

    def _dipole_field(self, mu, op):
        dr, k2, k3, pi, pj, du, u_data, extra = op
        out = dipole_field(mu.to(dr.dtype), dr, k2, k3, pi, pj).to(F64)
        if self.has_u:
            cdr, ck2, ck3 = u_data
            ci, cj = self.corr
            mu_j = gather(mu, cj)
            f = (3.0 * (du * ck3 * _dot(mu_j, cdr))[:, None] * cdr
                 - (du * ck2)[:, None] * mu_j)
            out = out + segment_sum(f, ci)
        if extra is not None:
            out = out + extra(mu)
        return out

    def _induce(self, field, op, extra_field=None):
        alpha = self.par[:, 15:16]
        if extra_field is not None:
            inner = op

            def operator(mu):
                return self._dipole_field(mu, inner) + extra_field(mu)
        else:
            def operator(mu):
                return self._dipole_field(mu, op)
        mu0 = alpha * field
        if self.polarization == AmoebaMultipoleForce.Direct:
            return mu0
        if self.polarization == AmoebaMultipoleForce.Extrapolated:
            mus = [mu0]
            for _ in range(len(self.ext) - 1):
                mus.append(alpha * (field + operator(mus[-1])))
            return sum(c * m for c, m in zip(self.ext, mus))
        mu = mu0
        for _ in range(self.max_iter):
            new = alpha * (field + operator(mu))
            mu = (1.0 - OMEGA) * mu + OMEGA * new
        return mu

    def _gk_terms(self, pos, lab):
        from ..ops import gk as gk_ops
        gk = self.gk
        radii, scales = self.gk_par[:, 1], self.gk_par[:, 2]
        born = gk_ops.grycuk_born_radii(pos, radii, scales)

        setup = gk_ops.gk_setup_recomputed(
            pos, born, self.par[:, 0], lab[0], lab[1],
            gk._solvent_dielectric, offd=self.gk_offd)
        return gk_ops, setup, born, radii

    def _solve(self, pos, box, state):
        """(permanent energy, polarizing field, contracted field, induced
        dipoles, GK energy or None)."""
        e_perm, field, field_p, op, lab = self._fields_and_energy(
            pos, box, state)
        if self.gk is None:
            return e_perm, field, field_p, self._induce(field, op), None
        gk_ops, setup, born, radii = self._gk_terms(pos, lab)
        gk_field = gk_ops.gk_permanent_field(setup)
        mu = self._induce(field + gk_field, op,
                          lambda m: gk_ops.gk_dipole_field(setup, m))
        e_gk = KE * (gk_ops.gk_energy_permanent(setup)
                     + gk_ops.gk_energy_induced(setup, mu))
        if self.gk._include_cavity:
            e_gk = e_gk + gk_ops.cavity_energy(
                radii, born, self.gk._probe_radius,
                self.gk._surface_area_factor)
        return e_perm, field, field_p, mu, e_gk

    def _energy(self, pos, box, state):
        e_perm, _, field_p, mu, e_gk = self._solve(pos, box, state)
        e = e_perm - 0.5 * KE * (mu * field_p).sum()
        return e if e_gk is None else e + e_gk

    def induced(self, pos, box, state):
        """The induced dipoles of the SCF without the GK reaction field,
        as the JAX package's getInducedDipoles gives them."""
        _, field, _, op, _ = self._fields_and_energy(pos, box, state)
        return self._induce(field, op)

    def scf_residual(self, pos, box, state):
        """max |mu - alpha (E + T mu)| over the sites at the SCF's
        result: how far its fixed sweeps are from the fixed point."""
        with torch.no_grad():
            _, field, _, op, lab = self._fields_and_energy(pos, box, state)
            mu = self._induce(field, op)
            alpha = self.par[:, 15:16]
            res = mu - alpha * (field + self._dipole_field(mu, op))
        return float(res.abs().max())


class AmoebaTorsionTorsionForce(Force):
    """Coupled torsion-torsion CMAP-style correction
    (AmoebaTorsionTorsionForce.h:49-139; reference kernel
    AmoebaReferenceTorsionTorsionForce.cpp:355-430): two consecutive
    dihedrals (1-2-3-4, 2-3-4-5) index a bicubic energy grid in degrees;
    a chirality-check atom may flip both angle signs."""

    def __init__(self):
        super().__init__()
        self._torsions = []   # (p1..p5, chiral, gridIndex)
        self._grids = []
        self._periodic = False

    def getNumTorsionTorsions(self):
        return len(self._torsions)

    def getNumTorsionTorsionGrids(self):
        return len(self._grids)

    def addTorsionTorsion(self, particle1, particle2, particle3, particle4,
                          particle5, chiralCheckAtomIndex, gridIndex):
        self._torsions.append((int(particle1), int(particle2),
                               int(particle3), int(particle4),
                               int(particle5), int(chiralCheckAtomIndex),
                               int(gridIndex)))
        return len(self._torsions) - 1

    def getTorsionTorsionParameters(self, index):
        return self._torsions[index]

    def setTorsionTorsionParameters(self, index, particle1, particle2,
                                    particle3, particle4, particle5,
                                    chiralCheckAtomIndex, gridIndex):
        self._torsions[index] = (int(particle1), int(particle2),
                                 int(particle3), int(particle4),
                                 int(particle5), int(chiralCheckAtomIndex),
                                 int(gridIndex))

    def getTorsionTorsionGrid(self, index):
        return self._grids[index]["raw"]

    def setTorsionTorsionGrid(self, index, grid):
        """grid[x][y] = [angle1, angle2, f(, fx, fy, fxy)]; angles in
        degrees on a uniform axis. Derivatives are fit with periodic
        splines when not supplied (TorsionTorsionForceImpl behavior)."""
        from ..utils.splines import (bicubic_coefficients_from_derivatives,
                                     bicubic_coefficients_periodic)
        while len(self._grids) <= index:
            self._grids.append(None)
        g = np.asarray(grid, np.float64)      # (nx, ny, 3 or 6)
        nx, ny = g.shape[0], g.shape[1]
        x0, y0 = g[0, 0, 0], g[0, 0, 1]
        dx = g[1, 0, 0] - g[0, 0, 0]
        dy = g[0, 1, 1] - g[0, 0, 1]
        if g.shape[2] >= 6:
            coeffs = bicubic_coefficients_from_derivatives(
                g[:, :, 2], g[:, :, 3] * dx, g[:, :, 4] * dy,
                g[:, :, 5] * dx * dy)
            self._grids[index] = {
                "raw": grid, "nx": nx, "ny": ny, "x0": x0, "y0": y0,
                "dx": dx, "dy": dy, "coeffs": coeffs, "wrap": False}
            return
        # values-only grid: endpoints duplicate (-180 == 180); fit doubly
        # periodic splines on the unique points
        coeffs = bicubic_coefficients_periodic(g[:nx - 1, :ny - 1, 2])
        self._grids[index] = {
            "raw": grid, "nx": nx - 1, "ny": ny - 1, "x0": x0, "y0": y0,
            "dx": dx, "dy": dy, "coeffs": coeffs, "wrap": True}

    def setUsesPeriodicBoundaryConditions(self, periodic):
        self._periodic = bool(periodic)

    def usesPeriodicBoundaryConditions(self):
        return self._periodic

    def _bonded_particles(self):
        out = []
        for (p1, p2, p3, p4, p5, chiral, _g) in self._torsions:
            out += [(p1, p2), (p2, p3), (p3, p4), (p4, p5)]
        return out

    def updateParametersInContext(self, context):
        context._update_force_parameters(self)

    def _compile(self, ctx):
        return AmoebaTorsionTorsionModule(self, ctx)


class AmoebaTorsionTorsionModule(_AutogradModule):
    def __init__(self, force, ctx):
        super().__init__()
        self.name, self.group, self.derivs = (force.getName(),
                                              force.getForceGroup(), ())
        dev = ctx._device
        n = ctx._n
        arr = np.asarray(force._torsions, np.int64).reshape(-1, 7)
        self._torsions = arr
        self.count = arr.shape[0]
        self.atoms = [_plan(arr[:, k], n, dev) for k in range(5)]
        # no chiral atom: its own third atom, never read (has_chiral)
        self.chiral = _plan(np.where(arr[:, 5] >= 0, arr[:, 5], arr[:, 2]),
                            n, dev)
        self.register_buffer("has_chiral", torch.as_tensor(
            arr[:, 5] >= 0, device=dev))
        self.register_buffer("gidx", torch.as_tensor(arr[:, 6], device=dev))
        self.periodic = force._periodic
        self._load(force, dev)

    def _load(self, force, dev):
        grids = force._grids
        if not grids:
            grids = [{"coeffs": np.zeros((1, 1, 4, 4)), "x0": 0.0,
                      "y0": 0.0, "dx": 1.0, "dy": 1.0}]
        max_cx = max(g["coeffs"].shape[0] for g in grids)
        max_cy = max(g["coeffs"].shape[1] for g in grids)
        coeffs = np.zeros((len(grids), max_cx, max_cy, 4, 4))
        info = np.zeros((len(grids), 6))
        for gi, g in enumerate(grids):
            c = g["coeffs"]
            coeffs[gi, :c.shape[0], :c.shape[1]] = c
            info[gi] = [g["x0"], g["y0"], g["dx"], g["dy"], c.shape[0],
                        c.shape[1]]
        self.register_buffer("coeffs", torch.as_tensor(coeffs, dtype=F64,
                                                       device=dev))
        self.register_buffer("info", torch.as_tensor(info, dtype=F64,
                                                     device=dev))

    def update(self, force) -> None:
        if not np.array_equal(np.asarray(force._torsions, np.int64)
                              .reshape(-1, 7), self._torsions):
            raise ValueError("updateParametersInContext: the torsion-torsion "
                             "terms have changed")
        self._load(force, self.coeffs.device)

    def _energy(self, pos, box, state):
        if self.count == 0:
            return pos.sum() * 0.0
        b = box.to(F64) if self.periodic else None
        p = [gather(pos, plan) for plan in self.atoms]
        rad2deg = 180.0 / math.pi
        a1 = geom.dihedral_angle(p[0], p[1], p[2], p[3], b) * rad2deg
        a2 = geom.dihedral_angle(p[1], p[2], p[3], p[4], b) * rad2deg
        ca = gather(pos, self.chiral)
        v1, v2, v3 = ca - p[2], p[1] - p[2], p[3] - p[2]
        volume = _dot(v1, torch.linalg.cross(v2, v3, dim=-1))
        flip = torch.where(self.has_chiral & (volume < 0), -1.0, 1.0)
        a1, a2 = a1 * flip, a2 * flip
        info = self.info[self.gidx]
        x0, y0, dx, dy = info[:, 0], info[:, 1], info[:, 2], info[:, 3]
        ncx, ncy = info[:, 4], info[:, 5]
        tx = torch.minimum(torch.clamp((a1 - x0) / dx, min=0.0), ncx - 1e-6)
        ty = torch.minimum(torch.clamp((a2 - y0) / dy, min=0.0), ncy - 1e-6)
        # a NaN angle (an overflowed step's poison) reads cell 0
        sx = torch.minimum(torch.floor(torch.nan_to_num(tx)), ncx - 1).long()
        sy = torch.minimum(torch.floor(torch.nan_to_num(ty)), ncy - 1).long()
        da = tx - sx
        db = ty - sy
        c = self.coeffs[self.gidx, sx, sy]              # (m, 4, 4)
        one = torch.ones_like(da)
        ta = torch.stack([one, da, da * da, da ** 3], -1)
        tb = torch.stack([one, db, db * db, db ** 3], -1)
        return (ta[:, :, None] * c * tb[:, None, :]).sum()


class AmoebaGeneralizedKirkwoodForce(Force):
    """Generalized Kirkwood implicit solvent for AMOEBA
    (AmoebaGeneralizedKirkwoodForce.h). Like the reference, it evaluates
    inside the multipole force: AmoebaMultipoleModule finds it on the
    System and folds the Grycuk Born radii, the GK reaction field of the
    SCF, the GK pair energies and the cavity term into its own energy
    (ops/gk.py). Its own module contributes nothing."""

    def __init__(self):
        super().__init__()
        self._particles = []   # (charge, radius, scalingFactor)
        self._solvent_dielectric = 78.3
        self._solute_dielectric = 1.0
        self._include_cavity = True
        self._probe_radius = 0.14
        self._surface_area_factor = -6.0 * 3.1415926535 * 0.0216 \
            * 1000.0 * 0.4184

    def getNumParticles(self):
        return len(self._particles)

    def addParticle(self, charge, radius, scalingFactor):
        self._particles.append((float(u.strip(charge, u.elementary_charge)),
                                float(u.strip(radius, u.nanometer)),
                                float(scalingFactor)))
        return len(self._particles) - 1

    def getParticleParameters(self, index):
        c, r, s = self._particles[index]
        return (u.Quantity(c, u.elementary_charge),
                u.Quantity(r, u.nanometer), s)

    def setParticleParameters(self, index, charge, radius, scalingFactor):
        self._particles[index] = (
            float(u.strip(charge, u.elementary_charge)),
            float(u.strip(radius, u.nanometer)), float(scalingFactor))

    def getSolventDielectric(self):
        return self._solvent_dielectric

    def setSolventDielectric(self, dielectric):
        self._solvent_dielectric = float(dielectric)

    def getSoluteDielectric(self):
        return self._solute_dielectric

    def setSoluteDielectric(self, dielectric):
        self._solute_dielectric = float(dielectric)

    def getIncludeCavityTerm(self):
        return int(self._include_cavity)

    def setIncludeCavityTerm(self, include):
        self._include_cavity = bool(include)

    def getProbeRadius(self):
        return u.Quantity(self._probe_radius, u.nanometer)

    def setProbeRadius(self, radius):
        self._probe_radius = float(u.strip(radius, u.nanometer))

    def getSurfaceAreaFactor(self):
        return self._surface_area_factor

    def setSurfaceAreaFactor(self, factor):
        self._surface_area_factor = float(factor)

    def updateParametersInContext(self, context):
        for f in context.getSystem().getForces():
            if isinstance(f, AmoebaMultipoleForce):
                context._update_force_parameters(f)

    def usesPeriodicBoundaryConditions(self):
        return False

    def _compile(self, ctx):
        if not any(isinstance(f, AmoebaMultipoleForce) for f in ctx._forces):
            raise ValueError("AmoebaGeneralizedKirkwoodForce requires an "
                             "AmoebaMultipoleForce in the System")
        return _FoldedModule(self)


class _FoldedModule(_AutogradModule):
    """The module of a force whose energy another module computes."""

    def __init__(self, force):
        super().__init__()
        self.name, self.group, self.derivs = (force.getName(),
                                              force.getForceGroup(), ())

    def update(self, force) -> None:
        pass

    def _energy(self, pos, box, state):
        return pos.sum() * 0.0


class AmoebaWcaDispersionForce(Force):
    """WCA dispersion for implicit solvent (AmoebaWcaDispersionForce.h;
    reference kernel AmoebaReferenceWcaDispersionForce.cpp:40-323): each
    atom's maximum dispersion energy in bulk water minus the part descreened
    by every other atom's occluding sphere, integrated analytically over the
    water O and H site densities."""

    def __init__(self):
        super().__init__()
        self._particles = []   # (radius, epsilon)
        self._epso = 0.1100
        self._epsh = 0.0135
        self._rmino = 1.7025
        self._rminh = 1.3275
        self._awater = 0.033428
        self._slevy = 1.0
        self._shctd = 0.81
        self._dispoff = 0.26

    def getNumParticles(self):
        return len(self._particles)

    def addParticle(self, radius, epsilon):
        self._particles.append((float(u.strip(radius, _NM)),
                                float(u.strip(epsilon, _E))))
        return len(self._particles) - 1

    def getParticleParameters(self, index):
        r, e = self._particles[index]
        return u.Quantity(r, _NM), u.Quantity(e, _E)

    def setParticleParameters(self, index, radius, epsilon):
        self._particles[index] = (float(u.strip(radius, _NM)),
                                  float(u.strip(epsilon, _E)))

    def updateParametersInContext(self, context):
        context._update_force_parameters(self)

    def getEpso(self):
        return self._epso

    def setEpso(self, v):
        self._epso = float(v)

    def getEpsh(self):
        return self._epsh

    def setEpsh(self, v):
        self._epsh = float(v)

    def getRmino(self):
        return self._rmino

    def setRmino(self, v):
        self._rmino = float(v)

    def getRminh(self):
        return self._rminh

    def setRminh(self, v):
        self._rminh = float(v)

    def getAwater(self):
        return self._awater

    def setAwater(self, v):
        self._awater = float(v)

    def getSlevy(self):
        return self._slevy

    def setSlevy(self, v):
        self._slevy = float(v)

    def getShctd(self):
        return self._shctd

    def setShctd(self, v):
        self._shctd = float(v)

    def getDispoff(self):
        return self._dispoff

    def setDispoff(self, v):
        self._dispoff = float(v)

    def usesPeriodicBoundaryConditions(self):
        return False

    def _max_dispersion_energy(self, radius, epsilon):
        """Per-atom bulk-water dispersion (ksolv.f knp loop;
        AmoebaWcaDispersionForceImpl.cpp:64-120)."""
        pi = math.pi
        rmini = radius
        rdisp = radius + self._dispoff
        epso, epsh = self._epso, self._epsh
        emixo = 4.0 * epso * epsilon / (math.sqrt(epso)
                                        + math.sqrt(epsilon)) ** 2
        rmixo = 2.0 * (self._rmino ** 3 + rmini ** 3) \
            / (self._rmino ** 2 + rmini ** 2)
        ao = emixo * rmixo ** 7
        emixh = 4.0 * epsh * epsilon / (math.sqrt(epsh)
                                        + math.sqrt(epsilon)) ** 2
        rmixh = 2.0 * (self._rminh ** 3 + rmini ** 3) \
            / (self._rminh ** 2 + rmini ** 2)
        ah = emixh * rmixh ** 7
        if rdisp < rmixh:
            cdisp = -4.0 * pi * emixh * (rmixh ** 3 - rdisp ** 3) / 3.0 \
                - emixh * 18.0 / 11.0 * rmixh ** 3 * pi
        else:
            cdisp = 2.0 * pi * (2.0 * rmixh ** 7 - 11.0 * rdisp ** 7) * ah \
                / (11.0 * rdisp ** 11)
        cdisp *= 2.0
        if rdisp < rmixo:
            cdisp -= 4.0 * pi * emixo * (rmixo ** 3 - rdisp ** 3) / 3.0
            cdisp -= emixo * 18.0 / 11.0 * rmixo ** 3 * pi
        else:
            cdisp += 2.0 * pi * (2.0 * rmixo ** 7 - 11.0 * rdisp ** 7) * ao \
                / (11.0 * rdisp ** 11)
        return self._slevy * self._awater * cdisp

    def _compile(self, ctx):
        return AmoebaWcaModule(self, ctx)


class AmoebaWcaModule(_AutogradModule):
    """The compiled AmoebaWcaDispersionForce: every pair, dense (n, n) as
    in the JAX package (an implicit-solvent, NoCutoff model)."""

    def __init__(self, force, ctx):
        super().__init__()
        self.name, self.group, self.derivs = (force.getName(),
                                              force.getForceGroup(), ())
        self.n = len(force._particles)
        self._load(force, ctx._device)

    def _load(self, force, dev):
        f = force
        self.consts = (f._epso, f._epsh, f._rmino, f._rminh, f._shctd,
                       f._slevy * f._awater)
        self.max_e = sum(f._max_dispersion_energy(r, e) if e > 0 and r > 0
                         else 0.0 for (r, e) in f._particles)
        arr = np.asarray(f._particles, np.float64).reshape(-1, 2)
        self.register_buffer("par", torch.as_tensor(arr, device=dev))

    def update(self, force) -> None:
        if len(force._particles) != self.n:
            raise ValueError("updateParametersInContext: the particles of "
                             "the AmoebaWcaDispersionForce have changed")
        self._load(force, self.par.device)

    def _energy(self, pos, box, state):
        n = self.n
        if n == 0:
            return pos.sum() * 0.0
        epso, epsh, rmino, rminh, shctd, slevy_awater = self.consts
        pi = math.pi
        rmin, eps = self.par[:, 0], self.par[:, 1]
        emixo = 4.0 * epso * eps / (math.sqrt(epso) + torch.sqrt(eps)) ** 2
        rmixo = 2.0 * (rmino ** 3 + rmin ** 3) / (rmino ** 2 + rmin ** 2)
        ao = emixo * rmixo ** 7
        emixh = 4.0 * epsh * eps / (math.sqrt(epsh) + torch.sqrt(eps)) ** 2
        rmixh = 2.0 * (rminh ** 3 + rmin ** 3) / (rminh ** 2 + rmin ** 2)
        ah = emixh * rmixh ** 7
        p = pos[:n]
        dr = p[:, None, :] - p[None, :, :]
        mask = ~torch.eye(n, dtype=torch.bool, device=pos.device)
        r2 = torch.where(mask, (dr * dr).sum(dim=-1), 1.0)
        r = torch.sqrt(r2)
        sk = (rmin * shctd)[None, :]
        sk2 = sk * sk
        ri = rmin[:, None]
        active = (ri < r + sk) & mask
        rmax = torch.maximum(ri, r - sk)

        def shell_low(rmix, emix):
            lik = rmax
            uik = torch.minimum(r + sk, rmix[:, None])
            take = (lik < rmix[:, None]) & active
            term = 4.0 * pi / (48.0 * r) * (
                3.0 * (lik ** 4 - uik ** 4) - 8.0 * r * (lik ** 3 - uik ** 3)
                + 6.0 * (r2 - sk2) * (lik ** 2 - uik ** 2))
            return torch.where(take, -emix[:, None] * term, 0.0)

        def high(rmix, a_val, rmix7, disp_scale, rep_scale):
            uik = r + sk
            take = (uik > rmix[:, None]) & active
            lik = torch.maximum(rmax, rmix[:, None])
            lik2, lik3 = lik * lik, lik ** 3
            lik4, lik5 = lik2 * lik2, lik2 * lik3
            lik10, lik11, lik12 = lik5 * lik5, lik5 * lik5 * lik, \
                lik5 * lik5 * lik2
            uik2, uik3 = uik * uik, uik ** 3
            uik4, uik5 = uik2 * uik2, uik2 * uik3
            uik10, uik11, uik12 = uik5 * uik5, uik5 * uik5 * uik, \
                uik5 * uik5 * uik2
            term = 4.0 * pi / (120.0 * r * lik5 * uik5) * (
                15.0 * uik * lik * r * (uik4 - lik4)
                - 10.0 * uik2 * lik2 * (uik3 - lik3)
                + 6.0 * (sk2 - r2) * (uik5 - lik5))
            idisp = disp_scale * a_val[:, None] * term
            term2 = 4.0 * pi / (2640.0 * r * lik12 * uik12) * (
                120.0 * uik * lik * r * (uik11 - lik11)
                - 66.0 * uik2 * lik2 * (uik10 - lik10)
                + 55.0 * (sk2 - r2) * (uik12 - lik12))
            irep = rep_scale * (a_val * rmix7)[:, None] * term2
            return torch.where(take, idisp + irep, 0.0)

        e_pairs = shell_low(rmixo, emixo) + 2.0 * shell_low(rmixh, emixh)
        e_pairs = e_pairs + high(rmixo, ao, rmixo ** 7, -2.0, 1.0)
        e_pairs = e_pairs + high(rmixh, ah, rmixh ** 7, -4.0, 2.0)
        return self.max_e - slevy_awater * e_pairs.sum()


AMOEBA_FORCES = (AmoebaVdwForce, AmoebaMultipoleForce,
                 AmoebaTorsionTorsionForce, AmoebaGeneralizedKirkwoodForce,
                 AmoebaWcaDispersionForce)
