"""NonbondedForce: the object API of the slice and the module that
computes it (PME electrostatics and Lennard-Jones with analytic forces).

Counterpart of openmm_tpu/forces/nonbonded.py. Numbers are plain floats in
nm, kJ/mol and e. The module assembles what the JAX package's neighbour-list
engine assembles (nonbonded.py:_compile, make_direct_ef): the direct-space
tile sweep (kernel 1), the reciprocal space (kernels 2 and 3 around cuFFT),
the self energy, the exceptions, the Ewald exclusion correction and the
dispersion correction. An overflowing candidate state poisons energy AND
forces with NaN: integrators read only forces, so a truncated pair list must
never give a finite trajectory. `potential_energy` is the minimizer's
objective: the same energy as a scalar that autograd differentiates, with
the reciprocal space through the dense spread (kernels 4 and 5) as the JAX
package's differentiated path has it (nonbonded.py reciprocal_energy).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..constants import ONE_4PI_EPS0
from ..ops import geometry as geom
from ..ops import pme as pme_mod
from ..ops import pme_zslab
from ..ops import tile_pairs
from ..ops.pairs import build_exclusion_table
from ..ops.tile_pairs import TWO_OVER_SQRT_PI

NEIGHBOR_SKIN = 0.25     # nm; the JAX package's measured default


class NonbondedForce:
    NoCutoff = 0
    CutoffNonPeriodic = 1
    CutoffPeriodic = 2
    Ewald = 3
    PME = 4
    LJPME = 5

    def __init__(self):
        self._particles = []        # (charge, sigma, epsilon)
        self._exceptions = []       # (p1, p2, chargeProd, sigma, epsilon)
        self._exception_index = {}
        self._method = NonbondedForce.NoCutoff
        self._cutoff = 1.0
        self._switching = False
        self._switch_dist = -1.0
        self._ewald_tol = 5e-4
        self._dispersion_correction = True

    def getNumParticles(self):
        return len(self._particles)

    def addParticle(self, charge, sigma, epsilon):
        self._particles.append((float(charge), float(sigma), float(epsilon)))
        return len(self._particles) - 1

    def getParticleParameters(self, index):
        return self._particles[index]

    def getNumExceptions(self):
        return len(self._exceptions)

    def addException(self, particle1, particle2, chargeProd, sigma, epsilon,
                     replace=False):
        p1, p2 = int(particle1), int(particle2)
        key = (min(p1, p2), max(p1, p2))
        entry = (p1, p2, float(chargeProd), float(sigma), float(epsilon))
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

    def getNonbondedMethod(self):
        return self._method

    def setNonbondedMethod(self, method):
        if not 0 <= int(method) <= 5:
            raise ValueError("NonbondedForce: illegal nonbonded method")
        self._method = int(method)

    def getCutoffDistance(self):
        return self._cutoff

    def setCutoffDistance(self, distance):
        self._cutoff = float(distance)

    def getUseSwitchingFunction(self):
        return self._switching

    def setUseSwitchingFunction(self, use):
        self._switching = bool(use)

    def getSwitchingDistance(self):
        return self._switch_dist

    def setSwitchingDistance(self, distance):
        self._switch_dist = float(distance)

    def getEwaldErrorTolerance(self):
        return self._ewald_tol

    def setEwaldErrorTolerance(self, tol):
        self._ewald_tol = float(tol)

    def getUseDispersionCorrection(self):
        return self._dispersion_correction

    def setUseDispersionCorrection(self, use):
        self._dispersion_correction = bool(use)

    def pme_parameters(self, box_widths):
        """(alpha, (nx, ny, nz)) chosen from the cutoff and the tolerance."""
        alpha = pme_mod.ewald_alpha(self._cutoff, self._ewald_tol)
        grid = pme_mod.pme_grid_size(box_widths, alpha, self._ewald_tol)
        return alpha, tuple(grid)

    def dispersion_coefficient(self):
        """Long-range LJ correction: the energy adds coefficient / volume
        (NonbondedForceImpl::calcDispersionCorrection; the switched region
        by 64-point Gauss-Legendre, as in the JAX package)."""
        n = len(self._particles)
        classes = {}
        for _, s, e in self._particles:
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
                    sig, eps = s1, e1
                else:
                    count = float(classes[keys[a]]) * classes[keys[b]]
                    sig, eps = 0.5 * (s1 + s2), math.sqrt(e1 * e2)
                sig6 = sig ** 6
                sum1 += count * eps * sig6 * sig6
                sum2 += count * eps * sig6
                if self._switching:
                    fr = sig6 * sig6 / r_q ** 12 - sig6 / r_q ** 6
                    sum3 += count * eps * np.sum(
                        w_q * fr * (1.0 - switch) * r_q * r_q)
        n_int = n * (n + 1) / 2.0
        sum1, sum2, sum3 = sum1 / n_int, sum2 / n_int, sum3 / n_int
        return 8.0 * n * n * math.pi * (sum1 / (9.0 * rc ** 9)
                                        - sum2 / (3.0 * rc ** 3)
                                        + 4.0 * sum3)


def _exception_terms(pos, idx, cp, sig, eps):
    """Per exception pair (no periodic images: exceptions ignore the
    cutoff): energy, dE/d(r^2) and the displacement. idx (m, 2) long;
    per-pair parameters."""
    dr = pos[idx[:, 0]] - pos[idx[:, 1]]
    inv_r2 = 1.0 / (dr * dr).sum(dim=-1)
    s6 = (sig * sig * inv_r2) ** 3
    inv_r = torch.sqrt(inv_r2)
    e = 4.0 * eps * s6 * (s6 - 1.0) + ONE_4PI_EPS0 * cp * inv_r
    dedr2 = -12.0 * eps * s6 * (2.0 * s6 - 1.0) * inv_r2 \
        - 0.5 * ONE_4PI_EPS0 * cp * inv_r * inv_r2
    return e, dedr2, dr


def exception_ef(pos, idx, cp, sig, eps):
    """Exception pair terms as (energy, forces)."""
    e, dedr2, dr = _exception_terms(pos, idx, cp, sig, eps)
    return e.sum(dtype=torch.float64), _pair_forces(pos, idx, dedr2, dr)


def exception_energy(pos, idx, cp, sig, eps):
    """Exception pair energy alone, differentiable in pos."""
    return _exception_terms(pos, idx, cp, sig, eps)[0].sum(
        dtype=torch.float64)


def _exclusion_terms(pos, box, idx, qq, alpha):
    """Per excluded pair: energy -qq erf(alpha r) / r (the interaction the
    reciprocal sum contains but the direct sweep skips), dE/d(r^2) and the
    minimum-image displacement. qq holds k_e q_i q_j per pair."""
    dr = geom.periodic_delta(pos[idx[:, 0]] - pos[idx[:, 1]], box.to(pos.dtype))
    r2 = (dr * dr).sum(dim=-1)
    r = torch.sqrt(r2)
    erf_ar = torch.special.erf(alpha * r)
    e = -qq * erf_ar / r
    # dE/dr = qq (erf(ar)/r^2 - 2a/sqrt(pi) exp(-a^2 r^2) / r)
    de_dr = qq * (erf_ar / r2 - TWO_OVER_SQRT_PI * alpha
                  * torch.exp(-alpha * alpha * r2) / r)
    return e, 0.5 * de_dr / r, dr


def exclusion_correction_ef(pos, box, idx, qq, alpha):
    """The Ewald exclusion correction as (energy, forces)."""
    e, dedr2, dr = _exclusion_terms(pos, box, idx, qq, alpha)
    return e.sum(dtype=torch.float64), _pair_forces(pos, idx, dedr2, dr)


def exclusion_correction_energy(pos, box, idx, qq, alpha):
    """The Ewald exclusion correction alone, differentiable in pos."""
    return _exclusion_terms(pos, box, idx, qq, alpha)[0].sum(
        dtype=torch.float64)


def _pair_forces(pos, idx, dedr2, dr):
    f = -2.0 * dedr2[:, None] * dr
    out = torch.zeros_like(pos)
    out.index_add_(0, idx[:, 0], f)
    out.index_add_(0, idx[:, 1], -f)
    return out


class NonbondedModule(nn.Module):
    """Energy and forces of one PME NonbondedForce on one device.

    precision "mixed": float32 through the kernel wrappers (the kernels on
    a CUDA device, their plain versions on the CPU). precision "double":
    float64 through the plain versions on any device (the oracle).
    """

    def __init__(self, force: NonbondedForce, box, device, precision="mixed"):
        super().__init__()
        if force.getNonbondedMethod() != NonbondedForce.PME:
            raise NotImplementedError(
                "this slice of the port runs NonbondedForce.PME only")
        n = force.getNumParticles()
        self.n = n
        self.plain = precision == "double"
        self.dtype = torch.float64 if self.plain else torch.float32
        box = np.asarray(box, np.float64)
        widths = [box[0, 0], box[1, 1], box[2, 2]]
        self.cutoff = force.getCutoffDistance()
        if self.cutoff >= 0.5 * min(widths):
            raise ValueError("the cutoff must be below half the box width")
        self.skin = NEIGHBOR_SKIN
        self.box_widths = widths
        self.capacity_scale = 1.0
        self.alpha, self.grid = force.pme_parameters(widths)
        use_switch = force.getUseSwitchingFunction()
        self.use_switch = bool(use_switch)
        rs = force.getSwitchingDistance() if use_switch else 0.0
        inv_w = 1.0 / (self.cutoff - rs) if use_switch else 0.0

        def buf(name, value, dtype=None):
            self.register_buffer(name, torch.as_tensor(
                value, dtype=dtype or self.dtype, device=device))

        p = np.asarray(force._particles, np.float64).reshape(n, 3)
        buf("charge", p[:, 0])
        buf("sigma", p[:, 1])
        buf("epsilon", p[:, 2])
        exc = force._exceptions
        idx = np.asarray([e[:2] for e in exc], np.int64).reshape(-1, 2)
        ep = np.asarray([e[2:] for e in exc], np.float64).reshape(-1, 3)
        buf("exc_idx", idx, torch.int64)
        buf("exc_cp", ep[:, 0])
        buf("exc_sigma", ep[:, 1])
        buf("exc_eps", ep[:, 2])
        buf("exc_qq", ONE_4PI_EPS0 * p[idx[:, 0], 0] * p[idx[:, 1], 0])
        buf("exclusions", build_exclusion_table(n, idx), torch.int32)
        md = pme_mod.make_pme_recip_data(self.grid, pme_zslab.ORDER)
        buf("bsq_x", md["bsq_x"])
        buf("bsq_y", md["bsq_y"])
        buf("bsq_z", md["bsq_z"])
        buf("tile_scalars", [self.alpha, self.cutoff ** 2, 0.0, 0.0, rs,
                             inv_w])
        self.self_energy = pme_mod.ewald_self_energy(p[:, 0], self.alpha)
        self.disp_coeff = (force.dispersion_coefficient()
                           if force.getUseDispersionCorrection() else 0.0)

    def budget(self) -> dict:
        return tile_pairs.tile_budget(self.n, self.box_widths, self.cutoff,
                                      self.skin, self.capacity_scale)

    def build_state(self, pos, box, reach=None) -> dict:
        """Candidate state for positions `pos` with bricks that come within
        `reach` (default cutoff + skin), at the skinned capacity."""
        b = self.budget()
        return tile_pairs.build_tile_state(
            pos.to(self.dtype), box, self.charge, self.sigma, self.epsilon,
            self.exclusions,
            self.cutoff + self.skin if reach is None else reach,
            b["max_bricks"], b["sort_cell"], b["exc_cap"], self.box_widths)

    def forward(self, pos, box, state=None):
        """(energy float64 scalar, forces (n, 3) in self.dtype). `state`
        is a candidate state from build_state; None builds one here."""
        if state is None:
            state = self.build_state(pos, box)
        posd = pos.to(self.dtype)
        boxd = box.to(self.dtype)
        consts = tile_pairs.tile_consts(boxd, self.tile_scalars)
        e_dir, f = tile_pairs.tile_energy_forces(
            posd, boxd, state, consts, tile_pairs.MODE_EWALD,
            self.use_switch, plain=self.plain)
        # kernel 3's visiting order; the plain gather on the CPU reads none
        # (it would only check its values, a host read in the step)
        order = state["order"][:self.n] if posd.is_cuda else None
        e_rec, f_rec = pme_zslab.pme_recip_ef(
            posd, self.charge, boxd, self.grid, self.alpha,
            (self.bsq_x, self.bsq_y, self.bsq_z), plain=self.plain,
            order=order)
        e_exc, f_exc = exception_ef(posd, self.exc_idx, self.exc_cp,
                                    self.exc_sigma, self.exc_eps)
        e_corr, f_corr = exclusion_correction_ef(posd, boxd, self.exc_idx,
                                                 self.exc_qq, self.alpha)
        energy = (e_dir + e_rec.to(torch.float64) + e_exc + e_corr
                  + self.self_energy
                  + self.disp_coeff / geom.box_volume(box.to(torch.float64)))
        forces = f + f_rec + f_exc + f_corr
        poison = torch.where(state["overflow"] > 0, math.nan, 0.0)
        return energy + poison, forces + poison.to(forces.dtype)

    def potential_energy(self, pos, box) -> torch.Tensor:
        """The potential energy as a float64 scalar that autograd
        differentiates with respect to `pos` (the minimizer's objective):
        the direct sweep through kernel 1 (TileEnergy) on a candidate state
        built at the cutoff for these positions, the exceptions, the Ewald
        exclusion correction, the self energy, the dispersion correction,
        and the dense reciprocal energy through kernels 4 and 5. An
        overflowing candidate state poisons it with NaN."""
        posd = pos.to(self.dtype)
        boxd = box.to(self.dtype)
        state = self.build_state(posd.detach(), box, reach=self.cutoff)
        consts = tile_pairs.tile_consts(boxd, self.tile_scalars)
        e_dir = tile_pairs.TileEnergy.apply(
            posd, boxd, state, consts, tile_pairs.MODE_EWALD,
            self.use_switch, self.plain)
        e_rec = pme_mod.pme_reciprocal_energy(
            posd, self.charge, box, self.grid, pme_zslab.ORDER, self.alpha,
            self.bsq_x, self.bsq_y, self.bsq_z, plain=self.plain)
        e_exc = exception_energy(posd, self.exc_idx, self.exc_cp,
                                 self.exc_sigma, self.exc_eps)
        e_corr = exclusion_correction_energy(posd, boxd, self.exc_idx,
                                             self.exc_qq, self.alpha)
        box64 = box.to(torch.float64)
        energy = (e_dir + e_rec + e_exc + e_corr + self.self_energy
                  + self.disp_coeff / geom.box_volume(box64))
        return energy + torch.where(state["overflow"] > 0, math.nan, 0.0)
