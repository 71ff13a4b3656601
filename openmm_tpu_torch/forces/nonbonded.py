"""NonbondedForce: the object API and the module that computes it
(electrostatics and Lennard-Jones, by method, with analytic forces).

Counterpart of openmm_tpu/forces/nonbonded.py. Numbers are plain floats in
nm, kJ/mol and e. The module assembles what the JAX package's neighbour-list
engine assembles (nonbonded.py:_compile, make_direct_ef): the direct-space
tile sweep (kernel 1), the reciprocal space (kernels 2 and 3 around cuFFT;
for LJPME a second time on the dispersion grid, with c6 weights in place
of the charges), the self energies, the exceptions, the Ewald exclusion
correction and the dispersion correction. An overflowing candidate state
poisons energy AND forces with NaN: integrators read only forces, so a
truncated pair list must never give a finite trajectory. `potential_energy`
is the minimizer's objective: the same energy as a scalar that autograd
differentiates, with the reciprocal space through the dense spread (kernels
4 and 5) as the JAX package's differentiated path has it (nonbonded.py
reciprocal_energy).

The force splits as the JAX package splits it (nonbonded.py:674-708): the
direct part (the sweep, the exceptions, the exclusion correction, the
dispersion correction) in the force's group, unless setIncludeDirectSpace
(False) drops it; the reciprocal part of the Ewald family (the grid or
k-sum and the self energies) in the reciprocal space's group
(setReciprocalSpaceForceGroup; -1, the default, is the force's group).

Global parameters and parameter offsets (addGlobalParameter,
addParticleParameterOffset, addExceptionParameterOffset) make the
effective parameters base + sum of value * scale, computed on the device
from the Context's global-parameter tensor at every evaluation (sums by
gathers in a fixed order, ops/accumulate.py), so that setParameter needs
no new step program. Without offsets the parameters are those of the
candidate state's build, as before.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from .. import unit as u
from ..constants import ONE_4PI_EPS0
from ..ops import geometry as geom
from ..ops import pairs as pair_ops
from ..ops import pme as pme_mod
from ..ops import pme_zslab
from ..ops import tile_pairs
from ..ops.accumulate import GatherSum
from ..ops.pairs import build_exclusion_table, dispersion_complement
from ..ops.tile_pairs import TWO_OVER_SQRT_PI
from .base import Force

_E = u.kilojoule_per_mole
_Q = u.elementary_charge
_NM = u.nanometer
_Q2 = _Q ** 2
_PER_NM = _NM ** -1

NEIGHBOR_SKIN = 0.25     # nm; the JAX package's measured default


class NonbondedForce(Force):
    NoCutoff = 0
    CutoffNonPeriodic = 1
    CutoffPeriodic = 2
    Ewald = 3
    PME = 4
    LJPME = 5

    def __init__(self):
        super().__init__()
        self._particles = []        # (charge, sigma, epsilon)
        self._exceptions = []       # (p1, p2, chargeProd, sigma, epsilon)
        self._exception_index = {}
        self._method = NonbondedForce.NoCutoff
        self._cutoff = 1.0
        self._switching = False
        self._switch_dist = -1.0
        self._rf_dielectric = 78.3
        self._ewald_tol = 5e-4
        self._alpha = 0.0
        self._grid = (0, 0, 0)
        self._lj_alpha = 0.0
        self._lj_grid = (0, 0, 0)
        self._dispersion_correction = True
        self._exceptions_use_pbc = False
        self._include_direct = True
        self._recip_group = -1
        self._global_params = []    # (name, default)
        # (parameter, particle, charge scale, sigma scale, epsilon scale)
        self._particle_offsets = []
        # (parameter, exception, chargeProd scale, sigma scale, eps scale)
        self._exception_offsets = []

    def getNumParticles(self):
        return len(self._particles)

    def addParticle(self, charge, sigma, epsilon):
        self._particles.append((float(u.strip(charge, _Q)),
                                float(u.strip(sigma, _NM)),
                                float(u.strip(epsilon, _E))))
        return len(self._particles) - 1

    def getParticleParameters(self, index):
        return self._particles[index]

    def setParticleParameters(self, index, charge, sigma, epsilon):
        self._particles[index] = (float(u.strip(charge, _Q)),
                                  float(u.strip(sigma, _NM)),
                                  float(u.strip(epsilon, _E)))

    def getNumExceptions(self):
        return len(self._exceptions)

    def addException(self, particle1, particle2, chargeProd, sigma, epsilon,
                     replace=False):
        p1, p2 = int(particle1), int(particle2)
        key = (min(p1, p2), max(p1, p2))
        entry = (p1, p2, float(u.strip(chargeProd, _Q2)),
                 float(u.strip(sigma, _NM)), float(u.strip(epsilon, _E)))
        if key in self._exception_index:
            if not replace:
                raise ValueError("NonbondedForce: multiple exceptions for "
                                 "particles %d and %d" % (p1, p2))
            self._exceptions[self._exception_index[key]] = entry
            return self._exception_index[key]
        self._exceptions.append(entry)
        self._exception_index[key] = len(self._exceptions) - 1
        return len(self._exceptions) - 1

    def getExceptionParameters(self, index):
        return self._exceptions[index]

    def setExceptionParameters(self, index, particle1, particle2, chargeProd,
                               sigma, epsilon):
        old = self._exceptions[index]
        p1, p2 = int(particle1), int(particle2)
        del self._exception_index[(min(old[0], old[1]), max(old[0], old[1]))]
        self._exceptions[index] = (p1, p2, float(u.strip(chargeProd, _Q2)),
                                   float(u.strip(sigma, _NM)),
                                   float(u.strip(epsilon, _E)))
        self._exception_index[(min(p1, p2), max(p1, p2))] = index

    def createExceptionsFromBonds(self, bonds, coulomb14Scale, lj14Scale):
        """Pairs one and two bonds apart excluded, pairs three apart scaled
        (NonbondedForce::createExceptionsFromBonds, as the JAX package
        orders them: the exclusions sorted, then the 1-4 pairs sorted)."""
        bonded = {}
        for b1, b2 in bonds:
            bonded.setdefault(int(b1), set()).add(int(b2))
            bonded.setdefault(int(b2), set()).add(int(b1))
        exclusions = set()
        for p1 in bonded:
            for mid in bonded[p1]:
                exclusions.add((min(p1, mid), max(p1, mid)))
                for p2 in bonded[mid]:
                    if p2 != p1:
                        exclusions.add((min(p1, p2), max(p1, p2)))
        pairs14 = set()
        for p1 in bonded:
            for a in bonded[p1]:
                for b in bonded[a]:
                    if b == p1:
                        continue
                    for p2 in bonded[b]:
                        if p2 == p1 or p2 in bonded[p1] or p2 == a:
                            continue
                        key = (min(p1, p2), max(p1, p2))
                        if key not in exclusions:
                            pairs14.add(key)
        for p1, p2 in sorted(exclusions):
            self.addException(p1, p2, 0.0, 1.0, 0.0, True)
        for p1, p2 in sorted(pairs14):
            c1, s1, e1 = self._particles[p1]
            c2, s2, e2 = self._particles[p2]
            self.addException(p1, p2, coulomb14Scale * c1 * c2,
                              0.5 * (s1 + s2),
                              lj14Scale * math.sqrt(e1 * e2), True)

    def getNonbondedMethod(self):
        return self._method

    def setNonbondedMethod(self, method):
        if not 0 <= int(method) <= 5:
            raise ValueError("NonbondedForce: illegal nonbonded method")
        self._method = int(method)

    def getCutoffDistance(self):
        return self._cutoff

    def setCutoffDistance(self, distance):
        self._cutoff = float(u.strip(distance, _NM))

    def getUseSwitchingFunction(self):
        return self._switching

    def setUseSwitchingFunction(self, use):
        self._switching = bool(use)

    def getSwitchingDistance(self):
        return self._switch_dist

    def setSwitchingDistance(self, distance):
        self._switch_dist = float(u.strip(distance, _NM))

    def getReactionFieldDielectric(self):
        return self._rf_dielectric

    def setReactionFieldDielectric(self, dielectric):
        self._rf_dielectric = float(dielectric)

    def getEwaldErrorTolerance(self):
        return self._ewald_tol

    def setEwaldErrorTolerance(self, tol):
        self._ewald_tol = float(tol)

    def getPMEParameters(self):
        return (self._alpha, *self._grid)

    def setPMEParameters(self, alpha, nx, ny, nz):
        """alpha 0 (the default) chooses alpha and the grid from the cutoff
        and the tolerance."""
        self._alpha = float(u.strip(alpha, _PER_NM))
        self._grid = (int(nx), int(ny), int(nz))

    def getLJPMEParameters(self):
        return (self._lj_alpha, *self._lj_grid)

    def setLJPMEParameters(self, alpha, nx, ny, nz):
        self._lj_alpha = float(u.strip(alpha, _PER_NM))
        self._lj_grid = (int(nx), int(ny), int(nz))

    def getPMEParametersInContext(self, context):
        """(alpha, nx, ny, nz) the Context's PME uses."""
        nb = context._nonbonded_module(self)
        return (nb.alpha, *nb.grid)

    def getLJPMEParametersInContext(self, context):
        """(alpha, nx, ny, nz) of the Context's dispersion grid."""
        nb = context._nonbonded_module(self)
        return (nb.lj_alpha, *nb.lj_grid)

    def getUseDispersionCorrection(self):
        return self._dispersion_correction

    def setUseDispersionCorrection(self, use):
        self._dispersion_correction = bool(use)

    def getExceptionsUsePeriodicBoundaryConditions(self):
        return self._exceptions_use_pbc

    def setExceptionsUsePeriodicBoundaryConditions(self, flag):
        self._exceptions_use_pbc = bool(flag)

    def getIncludeDirectSpace(self):
        return self._include_direct

    def setIncludeDirectSpace(self, include):
        self._include_direct = bool(include)

    def getReciprocalSpaceForceGroup(self):
        return self._recip_group

    def setReciprocalSpaceForceGroup(self, group):
        """The group of the reciprocal space; -1: the force's own."""
        if not -1 <= int(group) <= 31:
            raise ValueError("Force group must be between -1 and 31")
        self._recip_group = int(group)

    # -- global parameters and offsets -------------------------------------
    def getNumGlobalParameters(self):
        return len(self._global_params)

    def addGlobalParameter(self, name, defaultValue):
        self._global_params.append((str(name), float(u.strip(defaultValue))))
        return len(self._global_params) - 1

    def getGlobalParameterName(self, index):
        return self._global_params[index][0]

    def setGlobalParameterName(self, index, name):
        self._global_params[index] = (str(name),
                                      self._global_params[index][1])

    def getGlobalParameterDefaultValue(self, index):
        return self._global_params[index][1]

    def setGlobalParameterDefaultValue(self, index, defaultValue):
        self._global_params[index] = (self._global_params[index][0],
                                      float(u.strip(defaultValue)))

    def getNumParticleParameterOffsets(self):
        return len(self._particle_offsets)

    def addParticleParameterOffset(self, parameter, particleIndex,
                                   chargeScale, sigmaScale, epsilonScale):
        self._particle_offsets.append((str(parameter), int(particleIndex),
                                       float(chargeScale), float(sigmaScale),
                                       float(epsilonScale)))
        return len(self._particle_offsets) - 1

    def getParticleParameterOffset(self, index):
        return self._particle_offsets[index]

    def setParticleParameterOffset(self, index, parameter, particleIndex,
                                   chargeScale, sigmaScale, epsilonScale):
        self._particle_offsets[index] = (str(parameter), int(particleIndex),
                                         float(chargeScale),
                                         float(sigmaScale),
                                         float(epsilonScale))

    def getNumExceptionParameterOffsets(self):
        return len(self._exception_offsets)

    def addExceptionParameterOffset(self, parameter, exceptionIndex,
                                    chargeProdScale, sigmaScale,
                                    epsilonScale):
        self._exception_offsets.append((str(parameter), int(exceptionIndex),
                                        float(chargeProdScale),
                                        float(sigmaScale),
                                        float(epsilonScale)))
        return len(self._exception_offsets) - 1

    def getExceptionParameterOffset(self, index):
        return self._exception_offsets[index]

    def setExceptionParameterOffset(self, index, parameter, exceptionIndex,
                                    chargeProdScale, sigmaScale,
                                    epsilonScale):
        self._exception_offsets[index] = (str(parameter), int(exceptionIndex),
                                          float(chargeProdScale),
                                          float(sigmaScale),
                                          float(epsilonScale))

    def _global_defaults(self) -> dict:
        return {name: value for name, value in self._global_params}

    def updateParametersInContext(self, context):
        """Copy the particles', exceptions' and offsets' parameters into
        the Context's device buffers in place (no step program is captured
        again). The particles, the exception pairs and the offsets'
        parameters and targets must be those the Context was built with."""
        context._update_force_parameters(self)

    def usesPeriodicBoundaryConditions(self):
        return self._method in (NonbondedForce.CutoffPeriodic,
                                NonbondedForce.Ewald, NonbondedForce.PME,
                                NonbondedForce.LJPME)

    def reaction_field_constants(self):
        """(krf, crf) of the reaction field at the cutoff
        (ReferenceLJCoulombIxn.cpp:78-79)."""
        eps, rc = self._rf_dielectric, self._cutoff
        return ((eps - 1.0) / (2.0 * eps + 1.0) / rc ** 3,
                3.0 * eps / (2.0 * eps + 1.0) / rc)

    def ewald_parameters(self, box_widths):
        """(alpha, kmax per axis) of the exact Ewald sum."""
        alpha = pme_mod.ewald_alpha(self._cutoff, self._ewald_tol)
        return alpha, pme_mod.ewald_kmax(box_widths, alpha, self._ewald_tol)

    def pme_parameters(self, box_widths, lj=False):
        """(alpha, (nx, ny, nz)) of the Coulomb grid (or, lj=True, of the
        dispersion grid): those set, with the grid made FFT-friendly, or
        chosen from the cutoff and the tolerance when alpha is 0."""
        alpha, grid = ((self._lj_alpha, self._lj_grid) if lj
                       else (self._alpha, self._grid))
        if alpha == 0.0:
            alpha = pme_mod.ewald_alpha(self._cutoff, self._ewald_tol)
            return alpha, tuple(pme_mod.pme_grid_size(
                box_widths, alpha, self._ewald_tol, lj=lj))
        return alpha, tuple(pme_mod.find_legal_fft_dim(g) for g in grid)

    def dispersion_coefficient(self):
        """Long-range LJ correction: the energy adds coefficient / volume
        (NonbondedForceImpl::calcDispersionCorrection; the switched region
        by 64-point Gauss-Legendre, as in the JAX package), with the
        particle offsets at the global parameters' default values, as the
        JAX package takes it; 0 without periodic boundaries."""
        if not self.usesPeriodicBoundaryConditions():
            return 0.0
        n = len(self._particles)
        sigma = [p[1] for p in self._particles]
        eps = [p[2] for p in self._particles]
        defaults = self._global_defaults()
        for param, index, _, s_scale, e_scale in self._particle_offsets:
            sigma[index] += defaults[param] * s_scale
            eps[index] += defaults[param] * e_scale
        classes = {}
        for s, e in zip(sigma, eps):
            classes[(s, e)] = classes.get((s, e), 0) + 1
        keys = list(classes)
        rc, rs = self._cutoff, self._switch_dist
        if self._switching:
            x_gl, w_gl = np.polynomial.legendre.leggauss(64)
            r_q = 0.5 * (rc - rs) * x_gl + 0.5 * (rc + rs)
            w_q = 0.5 * (rc - rs) * w_gl
            t = (r_q - rs) / (rc - rs)
            switch = 1.0 - t * t * t * (10.0 - 15.0 * t + 6.0 * t * t)
        sum1 = sum2 = sum3 = 0.0
        for a, (s1, e1) in enumerate(keys):
            for b, (s2, e2) in enumerate(keys[:a + 1]):
                if a == b:
                    count = classes[keys[a]] * (classes[keys[a]] + 1) / 2.0
                    sig, e = s1, e1
                else:
                    count = float(classes[keys[a]]) * classes[keys[b]]
                    sig, e = 0.5 * (s1 + s2), math.sqrt(e1 * e2)
                sig6 = sig ** 6
                sum1 += count * e * sig6 * sig6
                sum2 += count * e * sig6
                if self._switching:
                    fr = sig6 * sig6 / r_q ** 12 - sig6 / r_q ** 6
                    sum3 += count * e * np.sum(
                        w_q * fr * (1.0 - switch) * r_q * r_q)
        n_int = n * (n + 1) / 2.0
        sum1, sum2, sum3 = sum1 / n_int, sum2 / n_int, sum3 / n_int
        return 8.0 * n * n * math.pi * (sum1 / (9.0 * rc ** 9)
                                        - sum2 / (3.0 * rc ** 3)
                                        + 4.0 * sum3)


def _exception_terms(pos, idx, cp, sig, eps, box=None):
    """Per exception pair (exceptions ignore the cutoff; minimum images
    only with a box, under setExceptionsUsePeriodicBoundaryConditions):
    energy, dE/d(r^2) and the displacement. idx (m, 2) long; per-pair
    parameters."""
    dr = geom.bond_vectors(pos, idx, None if box is None
                           else box.to(pos.dtype))
    inv_r2 = 1.0 / (dr * dr).sum(dim=-1)
    s6 = (sig * sig * inv_r2) ** 3
    inv_r = torch.sqrt(inv_r2)
    e = 4.0 * eps * s6 * (s6 - 1.0) + ONE_4PI_EPS0 * cp * inv_r
    dedr2 = -12.0 * eps * s6 * (2.0 * s6 - 1.0) * inv_r2 \
        - 0.5 * ONE_4PI_EPS0 * cp * inv_r * inv_r2
    return e, dedr2, dr


def exception_energy(pos, idx, cp, sig, eps, box=None):
    """Exception pair energy alone, differentiable in pos."""
    return _exception_terms(pos, idx, cp, sig, eps, box)[0].sum(
        dtype=torch.float64)


def _exclusion_terms(pos, box, idx, qq, alpha, c6g=None, lj_alpha2=None):
    """Per excluded pair: energy -qq erf(alpha r) / r (the interaction the
    reciprocal sum contains but the direct sweep skips), dE/d(r^2) and the
    minimum-image displacement. qq holds k_e q_i q_j per pair. For LJPME
    (c6g the pairs' c6_i c6_j, lj_alpha2 the dispersion alpha squared) the
    pair's dispersion-grid term is cancelled too: + c6g / r^6 g(x), x =
    alpha_LJ^2 r^2, g = 1 - e^-x (1 + x + x^2/2) (JAX nonbonded.py:636-640)."""
    dr = geom.periodic_delta(pos[idx[:, 0]] - pos[idx[:, 1]], box.to(pos.dtype))
    r2 = (dr * dr).sum(dim=-1)
    r = torch.sqrt(r2)
    erf_ar = torch.special.erf(alpha * r)
    e = -qq * erf_ar / r
    # dE/dr = qq (erf(ar)/r^2 - 2a/sqrt(pi) exp(-a^2 r^2) / r)
    de_dr = qq * (erf_ar / r2 - TWO_OVER_SQRT_PI * alpha
                  * torch.exp(-alpha * alpha * r2) / r)
    dedr2 = 0.5 * de_dr / r
    if c6g is not None:
        inv_r2 = 1.0 / r2
        g, h = dispersion_complement(lj_alpha2 * r2)
        coef = c6g * inv_r2 * inv_r2 * inv_r2
        e = e + coef * g
        dedr2 = dedr2 - 3.0 * coef * h * inv_r2
    return e, dedr2, dr


def exclusion_correction_energy(pos, box, idx, qq, alpha, c6g=None,
                                lj_alpha2=None):
    """The Ewald exclusion correction alone, differentiable in pos."""
    return _exclusion_terms(pos, box, idx, qq, alpha, c6g, lj_alpha2)[0].sum(
        dtype=torch.float64)


def exception_pairs_ef(pos, box, idx, cp, sig, eps, qq, alpha, gather,
                       exc_box=None, c6g=None, lj_alpha2=None):
    """The exceptions and, for the Ewald family (alpha not None), the Ewald
    exclusion correction over the same pairs (for LJPME with its
    dispersion part, c6g and lj_alpha2 as in _exclusion_terms): (exception
    energy, correction energy, forces). exc_box: the box when the
    exceptions take minimum images. Each atom's sum of its pairs' forces
    is added by gathers in a fixed order (`gather`, the GatherSum of idx;
    ops/accumulate.py): index_add_ adds in float atomics on a card, whose
    order changes from run to run."""
    e_exc, dedr2_exc, dr = _exception_terms(pos, idx, cp, sig, eps, exc_box)
    f = dedr2_exc[:, None] * dr
    e_corr = torch.zeros((), dtype=torch.float64, device=pos.device)
    if alpha is not None:
        e_c, dedr2_corr, dr_pbc = _exclusion_terms(pos, box, idx, qq, alpha,
                                                   c6g, lj_alpha2)
        e_corr = e_c.sum(dtype=torch.float64)
        f = f + dedr2_corr[:, None] * dr_pbc
    f = -2.0 * f
    return (e_exc.sum(dtype=torch.float64), e_corr,
            gather(torch.stack([f, -f], dim=1)))


def _offset_table(offsets, names, count, what):
    """(parameter index (m,), target (m,), scales (m, 3)) of offsets, or
    None when there are none; raises on an unknown parameter or target."""
    if not offsets:
        return None
    for param, target, *_ in offsets:
        if param not in names:
            raise ValueError("%s offset of unknown global parameter %r"
                             % (what, param))
        if not 0 <= target < count:
            raise ValueError("%s offset of %s %d out of range"
                             % (what, what, target))
    return (np.asarray([names[o[0]] for o in offsets], np.int64),
            np.asarray([o[1] for o in offsets], np.int64),
            np.asarray([o[2:] for o in offsets], np.float64))


class NonbondedModule(nn.Module):
    """Energy and forces of one NonbondedForce on one device, by method
    (the JAX package's _compile):

    - PME: kernel 1 in MODE_EWALD on the candidate state, the z-slab
      reciprocal space (kernels 2 and 3 around cuFFT), the self energy,
      the Ewald exclusion correction;
    - LJPME: the same, kernel 1 in MODE_LJPME (the Lennard-Jones term with
      the dispersion grid's complement and its shifts at the cutoff), and
      kernels 2 and 3 a second time on the dispersion grid with c6 weights,
      the dispersion self energy, the dispersion part of the exclusion
      correction; no dispersion correction;
    - Ewald: the same direct space, the exact k-sum (ops/pme.py);
    - CutoffPeriodic: the reaction field, kernel 1 in MODE_RF;
    - CutoffNonPeriodic: the reaction field without images;
    - NoCutoff: plain Coulomb over every pair;

    each with the exceptions and, with periodic boundaries but LJPME, the
    dispersion correction. The periodic methods keep the candidate state
    at every size; the non-periodic ones run every pair
    (ops/pairs.py:pair_energy_forces_n2), with no candidate state, rebuild
    or overflow. (The JAX package takes its all-pairs path for periodic
    systems below 1,024 atoms too, nonbonded.py:703: a choice of speed on
    its device that does not change the result.)

    precision "mixed": float32 through the kernel wrappers (the kernels on
    a CUDA device, their plain versions on the CPU). precision "double":
    float64 through the plain versions on any device (the oracle). The
    Ewald k-sum is float64 in both. `gp` is the Context's float64 tensor
    of global parameters and `gp_index` their positions in it, which the
    offsets read.
    """

    def __init__(self, force: NonbondedForce, box, device, precision="mixed",
                 gp=None, gp_index=None):
        super().__init__()
        method = force.getNonbondedMethod()
        n = force.getNumParticles()
        self.n = n
        self.name = force.getName()
        self.method = method
        self.plain = precision == "double"
        self.dtype = torch.float64 if self.plain else torch.float32
        box = np.asarray(box, np.float64)
        widths = [box[0, 0], box[1, 1], box[2, 2]]
        self.cutoff = force.getCutoffDistance()
        self.periodic = force.usesPeriodicBoundaryConditions()
        use_cutoff = method != NonbondedForce.NoCutoff
        self.ljpme = method == NonbondedForce.LJPME
        ewald_family = method in (NonbondedForce.Ewald, NonbondedForce.PME,
                                  NonbondedForce.LJPME)
        grid_family = method in (NonbondedForce.PME, NonbondedForce.LJPME)
        if self.periodic and self.cutoff >= 0.5 * min(widths):
            raise ValueError("the cutoff must be below half the box width")
        # the split into a direct and a reciprocal part (JAX nonbonded.py
        # :674-708): the direct part in the force's group unless dropped,
        # the reciprocal part of the Ewald family in its own group
        self.group = force.getForceGroup()
        recip_group = force.getReciprocalSpaceForceGroup()
        self.recip_group = self.group if recip_group < 0 else recip_group
        self.has_direct = force.getIncludeDirectSpace() or not ewald_family
        self.has_recip = ewald_family
        self.mode = (tile_pairs.MODE_LJPME if self.ljpme
                     else tile_pairs.MODE_EWALD if ewald_family
                     else tile_pairs.MODE_RF)
        self.skin = NEIGHBOR_SKIN
        self.box_widths = widths
        self.capacity_scale = 1.0
        self.use_switch = bool(force.getUseSwitchingFunction() and use_cutoff)
        rs = force.getSwitchingDistance() if self.use_switch else 0.0
        inv_w = 1.0 / (self.cutoff - rs) if self.use_switch else 0.0
        self.alpha = None
        self.grid = (0, 0, 0)
        self.lj_alpha, self.lj_grid = 0.0, (0, 0, 0)
        krf = crf = 0.0
        scalars_tail = []
        if grid_family:
            self.alpha, self.grid = force.pme_parameters(widths)
        elif method == NonbondedForce.Ewald:
            self.alpha, self.kmax = force.ewald_parameters(widths)
        elif use_cutoff:
            krf, crf = force.reaction_field_constants()
        if self.ljpme:
            self.lj_alpha, self.lj_grid = force.pme_parameters(widths,
                                                               lj=True)
            # the MODE_LJPME constants in the reaction field's slots:
            # alpha_LJ^2 and the grid complement's shift at the cutoff,
            # -(1 - e^-x (1 + x + x^2/2)) / rc^6 at x = (alpha_LJ rc)^2
            # (JAX nonbonded.py:74-78); 1 / rc^6 in the last slot
            dar2c = (self.lj_alpha * self.cutoff) ** 2
            krf = self.lj_alpha ** 2
            crf = -(1.0 - math.exp(-dar2c) * (1.0 + dar2c + 0.5 * dar2c
                                              * dar2c)) / self.cutoff ** 6
            scalars_tail = [1.0 / self.cutoff ** 6]
        self.terms = None if self.periodic else pair_ops.PairTerms(
            coulomb="rf" if use_cutoff else "plain",
            cutoff=self.cutoff if use_cutoff else None, krf=krf, crf=crf,
            switch=(rs, inv_w) if self.use_switch else None)

        def buf(name, value, dtype=None):
            self.register_buffer(name, torch.as_tensor(
                value, dtype=dtype or self.dtype, device=device))

        p = np.asarray(force._particles, np.float64).reshape(n, 3)
        buf("charge", p[:, 0])
        buf("sigma", p[:, 1])
        buf("epsilon", p[:, 2])
        exc = force._exceptions
        idx = np.asarray([e[:2] for e in exc], np.int64).reshape(-1, 2)
        self._exc_pairs = idx
        ep = np.asarray([e[2:] for e in exc], np.float64).reshape(-1, 3)
        buf("exc_idx", idx, torch.int64)
        buf("exc_cp", ep[:, 0])
        buf("exc_sigma", ep[:, 1])
        buf("exc_eps", ep[:, 2])
        buf("exc_qq", ONE_4PI_EPS0 * p[idx[:, 0], 0] * p[idx[:, 1], 0])
        buf("exclusions", build_exclusion_table(n, idx), torch.int32)
        self.exc_pbc = force.getExceptionsUsePeriodicBoundaryConditions()
        self.exc_gather = GatherSum(idx, n, device)
        if grid_family:
            md = pme_mod.make_pme_recip_data(self.grid, pme_zslab.ORDER)
            buf("bsq_x", md["bsq_x"])
            buf("bsq_y", md["bsq_y"])
            buf("bsq_z", md["bsq_z"])
        elif method == NonbondedForce.Ewald:
            buf("ewald_m", pme_mod.ewald_m_vectors(self.kmax),
                torch.float64)
        if self.ljpme:
            md = pme_mod.make_pme_recip_data(self.lj_grid, pme_zslab.ORDER)
            buf("bsq_x_lj", md["bsq_x"])
            buf("bsq_y_lj", md["bsq_y"])
            buf("bsq_z_lj", md["bsq_z"])
            c6 = _c6(p[:, 1], p[:, 2])
            buf("exc_c6g", c6[idx[:, 0]] * c6[idx[:, 1]])
        buf("tile_scalars", [self.alpha or 0.0, self.cutoff ** 2, krf, crf,
                             rs, inv_w] + scalars_tail)
        # the self energies and the dispersion correction's coefficient:
        # float64 device scalars, rewritten in place by update()
        buf("self_energy", self._self_energy(p), torch.float64)
        buf("disp_coeff", self._disp_coeff(force), torch.float64)

        # global parameters and offsets
        self.gp = gp
        names = dict(gp_index or {})
        self.gp_index = names
        # the global parameters the offsets read
        self.offset_names = {o[0] for o in force._particle_offsets
                             + force._exception_offsets}
        p_off = _offset_table(force._particle_offsets, names, n, "particle")
        e_off = _offset_table(force._exception_offsets, names, len(exc),
                              "exception")
        self._offset_keys = self._offset_key(force)
        self.has_offsets = p_off is not None or e_off is not None
        self.p_off = self.e_off = None
        if p_off is not None:
            buf("p_off_param", p_off[0], torch.int64)
            buf("p_off_scale", p_off[2])
            self.p_off = GatherSum(p_off[1][:, None], n, device)
        if e_off is not None:
            buf("e_off_param", e_off[0], torch.int64)
            buf("e_off_scale", e_off[2])
            self.e_off = GatherSum(e_off[1][:, None], len(exc), device)

    # -- host-side constants -------------------------------------------------
    def _self_energy(self, p) -> float:
        """The constant self energies of the reciprocal part: Ewald's
        -k_e alpha / sqrt(pi) sum q^2 and, for LJPME, alpha_LJ^6 / 12 sum
        c6^2 (p: the (n, 3) float64 particle parameters)."""
        e = 0.0
        if self.alpha is not None:
            e = pme_mod.ewald_self_energy(p[:, 0], self.alpha)
        if self.ljpme:
            e = e + pme_mod.dispersion_self_energy(_c6(p[:, 1], p[:, 2]),
                                                   self.lj_alpha)
        return e

    def _disp_coeff(self, force) -> float:
        if self.ljpme or not force.getUseDispersionCorrection():
            return 0.0
        return force.dispersion_coefficient()

    @staticmethod
    def _offset_key(force):
        return ([o[:2] for o in force._particle_offsets],
                [o[:2] for o in force._exception_offsets])

    def update(self, force) -> None:
        """Write the force's current parameters into the buffers in place
        (updateParametersInContext): the particles' charges, sigmas and
        epsilons, the exceptions', the offsets' scales and the constants
        that follow from them. Raises when the particles, the exception
        pairs or the offsets' parameters and targets changed."""
        if force.getNumParticles() != self.n:
            raise ValueError("updateParametersInContext: the number of "
                             "particles has changed")
        idx = np.asarray([e[:2] for e in force._exceptions],
                         np.int64).reshape(-1, 2)
        if idx.shape != self._exc_pairs.shape \
                or not np.array_equal(idx, self._exc_pairs):
            raise ValueError("updateParametersInContext: the set of "
                             "exceptions (their number or their particle "
                             "pairs) has changed")
        if self._offset_key(force) != self._offset_keys:
            raise ValueError("updateParametersInContext: the parameter "
                             "offsets' parameters or targets have changed")
        p = np.asarray(force._particles, np.float64).reshape(self.n, 3)
        ep = np.asarray([e[2:] for e in force._exceptions],
                        np.float64).reshape(-1, 3)

        def put(name, value):
            t = getattr(self, name)
            t.copy_(torch.as_tensor(np.asarray(value), dtype=t.dtype))

        put("charge", p[:, 0])
        put("sigma", p[:, 1])
        put("epsilon", p[:, 2])
        put("exc_cp", ep[:, 0])
        put("exc_sigma", ep[:, 1])
        put("exc_eps", ep[:, 2])
        put("exc_qq", ONE_4PI_EPS0 * p[idx[:, 0], 0] * p[idx[:, 1], 0])
        if self.ljpme:
            c6 = _c6(p[:, 1], p[:, 2])
            put("exc_c6g", c6[idx[:, 0]] * c6[idx[:, 1]])
        put("self_energy", self._self_energy(p))
        put("disp_coeff", self._disp_coeff(force))
        if self.p_off is not None:
            put("p_off_scale", [o[2:] for o in force._particle_offsets])
        if self.e_off is not None:
            put("e_off_scale", [o[2:] for o in force._exception_offsets])

    # -- the effective parameters -------------------------------------------
    def _offset_sums(self, param, scale, gather):
        """(count, 3) sums of value * scale over the offsets of each
        target, in a fixed order (GatherSum), in self.dtype."""
        v = self.gp[param].to(self.dtype)
        return gather((v[:, None] * scale)[:, None, :])

    def particle_params(self):
        """(charge, sigma, epsilon) (n,) each: the base parameters plus
        the particle offsets at the current global parameters."""
        if self.p_off is None:
            return self.charge, self.sigma, self.epsilon
        d = self._offset_sums(self.p_off_param, self.p_off_scale, self.p_off)
        return (self.charge + d[:, 0], self.sigma + d[:, 1],
                self.epsilon + d[:, 2])

    def exception_params(self):
        """(chargeProd, sigma, epsilon) per exception, with the exception
        offsets at the current global parameters."""
        if self.e_off is None:
            return self.exc_cp, self.exc_sigma, self.exc_eps
        d = self._offset_sums(self.e_off_param, self.e_off_scale, self.e_off)
        return (self.exc_cp + d[:, 0], self.exc_sigma + d[:, 1],
                self.exc_eps + d[:, 2])

    def _derived(self, params):
        """(exc_qq, exc_c6g or None, self energy) from the particle
        parameters: the buffers without offsets, computed on the device
        from the effective parameters with them."""
        c6g = self.exc_c6g if self.ljpme else None
        if not self.has_offsets:
            return self.exc_qq, c6g, self.self_energy
        q, sig, eps = params
        i, j = self.exc_idx[:, 0], self.exc_idx[:, 1]
        qq = ONE_4PI_EPS0 * q[i] * q[j]
        q64 = q.to(torch.float64)
        e_self = torch.zeros((), dtype=torch.float64, device=q.device)
        if self.alpha is not None:
            e_self = -ONE_4PI_EPS0 * self.alpha / pme_mod.SQRT_PI \
                * (q64 * q64).sum()
        if self.ljpme:
            c6 = _c6(sig, eps)
            c6g = c6[i] * c6[j]
            c64 = c6.to(torch.float64)
            e_self = e_self + self.lj_alpha ** 6 / 12.0 * (c64 * c64).sum()
        return qq, c6g, e_self

    def active(self, groups) -> bool:
        """Whether a part of this force lies in the group mask."""
        return bool((self.has_direct and (groups >> self.group) & 1)
                    or (self.has_recip and (groups >> self.recip_group) & 1))

    def budget(self) -> dict:
        return tile_pairs.tile_budget(self.n, self.box_widths, self.cutoff,
                                      self.skin, self.capacity_scale)

    def build_state(self, pos, box, reach=None) -> dict:
        """Candidate state for positions `pos` with bricks that come within
        `reach` (default cutoff + skin), at the skinned capacity."""
        b = self.budget()
        q, sig, eps = self.particle_params()
        return tile_pairs.build_tile_state(
            pos.to(self.dtype), box, q, sig, eps, self.exclusions,
            self.cutoff + self.skin if reach is None else reach,
            b["max_bricks"], b["sort_cell"], b["exc_cap"], self.box_widths,
            c6=self.ljpme)

    def _direct(self, posd, boxd, state, params):
        """(energy, forces) of the direct sweep: kernel 1 on the candidate
        state (with offsets, its parameters gathered anew from the
        effective ones) or every pair."""
        if not self.periodic:
            return pair_ops.pair_energy_forces_n2(
                posd, *params, self.exclusions, self.terms)
        consts = tile_pairs.tile_consts(boxd, self.tile_scalars)
        par4 = (tile_pairs.tile_params(*params, state["order"],
                                       c6=self.ljpme)
                if self.has_offsets else None)
        return tile_pairs.tile_energy_forces(
            posd, boxd, state, consts, self.mode, self.use_switch,
            plain=self.plain, par4=par4)

    def _reciprocal(self, pos, posd, box, boxd, state, params):
        """(energy, forces) of the reciprocal grid or k-sum (without the
        self energy)."""
        if self.method == NonbondedForce.Ewald:
            e_rec, f_rec = pme_mod.ewald_reciprocal_ef(
                pos, params[0], box, self.ewald_m, self.alpha)
            return e_rec, f_rec.to(self.dtype)
        # kernel 3's visiting order; the plain gather on the CPU reads
        # none (it would only check its values, a host read in the step)
        order = (state["order"][:self.n]
                 if posd.is_cuda and state is not None else None)
        e_rec, f_rec = pme_zslab.pme_recip_ef(
            posd, params[0], boxd, self.grid, self.alpha,
            (self.bsq_x, self.bsq_y, self.bsq_z), plain=self.plain,
            order=order)
        energy = e_rec.to(torch.float64)
        if self.ljpme:
            e_lj, f_lj = pme_zslab.pme_recip_ef(
                posd, _c6(params[1], params[2]), boxd, self.lj_grid,
                self.lj_alpha, (self.bsq_x_lj, self.bsq_y_lj, self.bsq_z_lj),
                plain=self.plain, order=order, dispersion=True)
            energy = energy + e_lj.to(torch.float64)
            f_rec = f_rec + f_lj
        return energy, f_rec

    def forward(self, pos, box, state=None, groups=-1):
        """(energy float64 scalar, forces (n, 3) in self.dtype) of the parts
        of this force in the group mask `groups`. `state` is a candidate
        state from build_state; None builds one here (for the periodic
        methods)."""
        posd = pos.to(self.dtype)
        boxd = box.to(self.dtype)
        direct = self.has_direct and (groups >> self.group) & 1
        recip = self.has_recip and (groups >> self.recip_group) & 1
        params = self.particle_params()
        if direct and self.periodic and state is None:
            state = self.build_state(pos, box)
        energy = f = None
        if direct:
            energy, f = self._direct(posd, boxd, state, params)
        qq, c6g, e_self = self._derived(params)
        if recip:
            e_rec, f_rec = self._reciprocal(pos, posd, box, boxd, state,
                                            params)
            energy = e_rec if energy is None else energy + e_rec
            f = f_rec if f is None else f + f_rec
        if direct:
            e_exc, e_corr, f_pairs = exception_pairs_ef(
                posd, boxd, self.exc_idx, *self.exception_params(), qq,
                self.alpha, self.exc_gather, boxd if self.exc_pbc else None,
                c6g, self.tile_scalars[2] if self.ljpme else None)
            energy = energy + e_exc + e_corr
        if recip:
            energy = energy + e_self
        if direct:
            energy = energy + self.disp_coeff / geom.box_volume(
                box.to(torch.float64))
            f = f + f_pairs
        if f is None:
            energy = torch.zeros((), dtype=torch.float64, device=pos.device)
            f = torch.zeros_like(posd)
        if not (direct and self.periodic):
            return energy, f
        poison = torch.where(state["overflow"] > 0, math.nan, 0.0)
        return energy + poison, f + poison.to(f.dtype)

    def potential_energy(self, pos, box) -> torch.Tensor:
        """The potential energy of every part as a float64 scalar that
        autograd differentiates with respect to `pos` (the minimizer's
        objective): the direct space through kernel 1 on a candidate state
        built at the cutoff for these positions, or every pair (each
        through its analytic forces: ops/pairs.py:AnalyticEnergy); the
        exceptions; for PME and LJPME the dense reciprocal energy through
        kernels 4 and 5 (LJPME's dispersion grid too), for Ewald the k-sum,
        with the exclusion correction and the self energies; the dispersion
        correction. An overflowing candidate state poisons it with NaN."""
        posd = pos.to(self.dtype)
        boxd = box.to(self.dtype)
        params = self.particle_params()
        qq, c6g, e_self = self._derived(params)
        energy = torch.zeros((), dtype=torch.float64, device=pos.device)
        state = None
        if self.has_direct and self.periodic:
            state = self.build_state(posd.detach(), box, reach=self.cutoff)
            consts = tile_pairs.tile_consts(boxd, self.tile_scalars)
            par4 = (tile_pairs.tile_params(*params, state["order"],
                                           c6=self.ljpme)
                    if self.has_offsets else None)
            energy = pair_ops.AnalyticEnergy.apply(
                tile_pairs.tile_energy_forces, posd, boxd, state, consts,
                self.mode, self.use_switch, self.plain, par4)
        elif self.has_direct:
            energy = pair_ops.AnalyticEnergy.apply(
                pair_ops.pair_energy_forces_n2, posd, *params,
                self.exclusions, self.terms)
        if self.method in (NonbondedForce.PME, NonbondedForce.LJPME):
            energy = energy + pme_mod.pme_reciprocal_energy(
                posd, params[0], box, self.grid, pme_zslab.ORDER,
                self.alpha, self.bsq_x, self.bsq_y, self.bsq_z,
                plain=self.plain)
        elif self.method == NonbondedForce.Ewald:
            energy = energy + pme_mod.ewald_reciprocal_energy(
                pos, params[0], box, self.ewald_m, self.alpha)
        if self.ljpme:
            energy = energy + pme_mod.pme_reciprocal_energy(
                posd, _c6(params[1], params[2]), box, self.lj_grid,
                pme_zslab.ORDER, self.lj_alpha, self.bsq_x_lj,
                self.bsq_y_lj, self.bsq_z_lj, plain=self.plain,
                coulomb=False)
        if self.has_direct:
            energy = energy + exception_energy(
                posd, self.exc_idx, *self.exception_params(),
                boxd if self.exc_pbc else None)
            if self.alpha is not None:
                energy = energy + exclusion_correction_energy(
                    posd, boxd, self.exc_idx, qq, self.alpha, c6g,
                    self.tile_scalars[2] if self.ljpme else None)
            energy = energy + self.disp_coeff / geom.box_volume(
                box.to(torch.float64))
        if self.has_recip:
            energy = energy + e_self
        if state is None:
            return energy
        return energy + torch.where(state["overflow"] > 0, math.nan, 0.0)


    # -- energy parameter derivatives (between steps) ------------------------
    def _offset_derivs(self, index, param, scale, gather):
        """(count, 3) d(charge or chargeProd, sigma, epsilon)/dlambda of
        each target for the global parameter at `index`: the sums of the
        scales of its offsets."""
        pick = (param == index).to(self.dtype)
        return gather((pick[:, None] * scale)[:, None, :])

    def parameter_derivatives(self, pos, box, state=None, groups=-1,
                              names=None) -> dict:
        """{name: dE/dname (float64)} of the parts of this force in the
        group mask `groups` for each global parameter of `names` (default:
        all) that its offsets read, at fixed positions: the direct sweep
        (kernel 1's derivative instantiation on the candidate state
        `state`, or every pair), the exceptions and the Ewald exclusion
        correction in closed form, the reciprocal space (kernel 2 on the
        charges and on their derivatives, bilinear: no gather) and the self
        energies. The dispersion correction takes the parameters at their
        defaults (as the JAX package does) and so adds nothing."""
        wanted = [n for n in (self.offset_names if names is None else names)
                  if n in self.offset_names]
        if not wanted:
            return {}
        posd = pos.to(self.dtype)
        boxd = box.to(self.dtype)
        direct = self.has_direct and (groups >> self.group) & 1
        recip = self.has_recip and (groups >> self.recip_group) & 1
        params = self.particle_params()
        exc = self.exception_params()
        q, sig, eps = params
        zeros_n = torch.zeros((self.n, 3), dtype=self.dtype,
                              device=pos.device)
        zeros_e = torch.zeros((self.exc_idx.shape[0], 3), dtype=self.dtype,
                              device=pos.device)
        out = {}
        for name in wanted:
            k = self.gp_index[name]
            dp = (zeros_n if self.p_off is None else self._offset_derivs(
                k, self.p_off_param, self.p_off_scale, self.p_off))
            de = (zeros_e if self.e_off is None else self._offset_derivs(
                k, self.e_off_param, self.e_off_scale, self.e_off))
            dq, dsig, deps = dp.unbind(1)
            total = torch.zeros((), dtype=torch.float64, device=pos.device)
            if direct:
                total = total + self._direct_deriv(posd, boxd, state, params,
                                                   (dq, dsig, deps))
                total = total + self._pairs_deriv(posd, boxd, params, exc,
                                                  (dq, dsig, deps),
                                                  de.unbind(1))
            if recip:
                total = total + self._recip_deriv(pos, posd, box, boxd,
                                                  params, (dq, dsig, deps))
            out[name] = total
        return out

    def _direct_deriv(self, posd, boxd, state, params, dparams):
        if not self.periodic:
            return pair_ops.pair_param_derivative_n2(
                posd, params, dparams, self.exclusions, self.terms)
        if state is None:
            state = self.build_state(posd, boxd)
        order = state["order"]
        par4 = tile_pairs.tile_params(*params, order, c6=self.ljpme)
        dpar4 = tile_pairs.tile_param_derivs(*params, *dparams, order,
                                             c6=self.ljpme)
        consts = tile_pairs.tile_consts(boxd, self.tile_scalars)
        value = tile_pairs.tile_param_derivative(
            posd, boxd, state, consts, self.mode, self.use_switch, par4,
            dpar4, plain=self.plain)
        return value + torch.where(state["overflow"] > 0, math.nan, 0.0)

    def _pairs_deriv(self, posd, boxd, params, exc, dparams, dexc):
        """The exceptions' and the exclusion correction's dE/dlambda."""
        cp, esig, eeps = exc
        dcp, desig, deeps = dexc
        dr = geom.bond_vectors(posd, self.exc_idx,
                               boxd if self.exc_pbc else None)
        inv_r2 = 1.0 / (dr * dr).sum(dim=-1)
        s6 = (esig * esig * inv_r2) ** 3
        d = (4.0 * deeps * s6 * (s6 - 1.0)
             + torch.where(desig != 0, 24.0 * eeps * s6 * (2.0 * s6 - 1.0)
                           * desig / esig, 0.0)
             + ONE_4PI_EPS0 * dcp * torch.sqrt(inv_r2))
        total = d.sum(dtype=torch.float64)
        if self.alpha is None:
            return total
        q, sig, eps = params
        dq, dsig, deps = dparams
        i, j = self.exc_idx[:, 0], self.exc_idx[:, 1]
        dr = geom.periodic_delta(posd[i] - posd[j], boxd)
        r2 = (dr * dr).sum(dim=-1)
        r = torch.sqrt(r2)
        dqq = ONE_4PI_EPS0 * (dq[i] * q[j] + q[i] * dq[j])
        d = -dqq * torch.special.erf(self.alpha * r) / r
        if self.ljpme:
            c6, dc6 = _c6(sig, eps), _dc6(sig, eps, dsig, deps)
            g, _ = dispersion_complement(self.tile_scalars[2] * r2)
            inv_r2 = 1.0 / r2
            d = d + (dc6[i] * c6[j] + c6[i] * dc6[j]) \
                * inv_r2 * inv_r2 * inv_r2 * g
        return total + d.sum(dtype=torch.float64)

    def _recip_deriv(self, pos, posd, box, boxd, params, dparams):
        """The reciprocal space's and the self energies' dE/dlambda."""
        q, sig, eps = params
        dq, dsig, deps = dparams
        q64, dq64 = q.to(torch.float64), dq.to(torch.float64)
        total = -2.0 * ONE_4PI_EPS0 * self.alpha / pme_mod.SQRT_PI * (
            q64 * dq64).sum()
        if self.method == NonbondedForce.Ewald:
            return total + pme_mod.ewald_reciprocal_deriv(
                pos, q, dq, box, self.ewald_m, self.alpha)
        total = total + pme_zslab.pme_recip_deriv(
            posd, q, dq, boxd, self.grid, self.alpha,
            (self.bsq_x, self.bsq_y, self.bsq_z), plain=self.plain)
        if self.ljpme:
            c6, dc6 = _c6(sig, eps), _dc6(sig, eps, dsig, deps)
            total = total + pme_zslab.pme_recip_deriv(
                posd, c6, dc6, boxd, self.lj_grid, self.lj_alpha,
                (self.bsq_x_lj, self.bsq_y_lj, self.bsq_z_lj),
                plain=self.plain, dispersion=True)
            total = total + self.lj_alpha ** 6 / 6.0 * (
                c6.to(torch.float64) * dc6.to(torch.float64)).sum()
        return total


class CandidateSet:
    """The NonbondedModules of a System, more than one, that keep a
    candidate state: built together at one rebuild predicate (positions
    and box of the last build, the smallest skin), as one state whose keys
    carry each module's prefix ("m<k>_"), its "overflow" the sum of
    theirs, so that the Context, the step program's one gate, the
    escalation and the checkpoints handle it as one module's. The JAX
    package keeps a refresher for each force (context.py:384-394)."""

    def __init__(self, modules):
        self.modules = list(modules)
        self.skin = min(m.skin for m in self.modules)

    @property
    def capacity_scale(self) -> float:
        return self.modules[0].capacity_scale

    @capacity_scale.setter
    def capacity_scale(self, value) -> None:
        for m in self.modules:
            m.capacity_scale = value

    def build_state(self, pos, box) -> dict:
        out, overflow = {}, None
        for k, m in enumerate(self.modules):
            st = m.build_state(pos, box)
            out.update({"m%d_%s" % (k, key): v for key, v in st.items()})
            overflow = (st["overflow"] if overflow is None
                        else overflow + st["overflow"])
        out["overflow"] = overflow
        return out

    def module_state(self, module, state):
        """The part of `state` that belongs to `module` (None for a module
        not in the set)."""
        if module not in self.modules:
            return None
        prefix = "m%d_" % self.modules.index(module)
        return {key[len(prefix):]: v for key, v in state.items()
                if key.startswith(prefix)}


def _dc6(sigma, epsilon, dsigma, depsilon):
    """d c6_i / dlambda of _c6 (torch), 0 where epsilon is 0."""
    positive = epsilon > 0
    root = torch.sqrt(torch.where(positive, epsilon, 1.0))
    return torch.where(positive, depsilon / root * sigma ** 3
                       + 6.0 * root * sigma * sigma * dsigma, 0.0)


def _c6(sigma, epsilon):
    """The geometric dispersion coefficient of each particle, c6_i =
    2 sqrt(eps_i) sigma_i^3 (so that c6_i c6_j = 4 sqrt(eps_i eps_j)
    (sigma_i sigma_j)^3): numpy or torch."""
    if torch.is_tensor(sigma):
        return 2.0 * torch.sqrt(epsilon) * sigma ** 3
    return 2.0 * np.sqrt(epsilon) * np.asarray(sigma) ** 3


class NonbondedVariable:
    """A NonbondedForce without periodic boundaries (every pair, no
    candidate state) as a CustomCVForce's collective variable: the
    CustomModule contract over NonbondedModule."""

    def __init__(self, module: NonbondedModule):
        self.module = module
        self.name, self.group = module.name, module.group

    def ef(self, pos, box):
        energy, forces = self.module(pos, box)
        return energy, forces.to(torch.float64)

    def energy(self, pos, box):
        return self.module.potential_energy(pos, box)

    def parameter_derivatives(self, pos, box) -> dict:
        return self.module.parameter_derivatives(pos, box)

    def update(self, force) -> None:
        self.module.update(force)
