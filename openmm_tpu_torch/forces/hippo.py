"""HippoNonbondedForce: the HIPPO polarizable force field
(plugins/amoeba/openmmapi/include/openmm/HippoNonbondedForce.h).

Counterpart of openmm_tpu/forces/hippo.py. One force covers
charge-penetration multipole electrostatics, extrapolated induced-dipole
polarization, Pauli (exchange) repulsion, charge transfer and damped
dispersion, with per-exception scale factors for each component. As in
the JAX package: dense (n, n) lab-frame pair math (ops/hippo_math.py),
the reference's quasi-internal-frame scalars evaluated as frame-invariant
contractions in the lab frame, every force and torque the gradient of the
energy (torch.autograd here, jax.grad there), float64, and the NoCutoff
method only: PME raises, as it does in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import unit as u
from ..constants import ONE_4PI_EPS0
from ..ops import hippo_math as hm
from .amoeba import (F64, _AutogradModule, _dot, _frame_plans, _rotations,
                     lab_multipoles)
from .base import Force

_E = u.kilojoule_per_mole
_NM = u.nanometer
_SCALES = ("mm", "dm", "dd", "disp", "rep", "ct")


class HippoNonbondedForce(Force):
    NoCutoff = 0
    PME = 1
    ZThenX = 0
    Bisector = 1
    ZBisect = 2
    ThreeFold = 3
    ZOnly = 4
    NoAxisType = 5

    def __init__(self):
        super().__init__()
        self._particles = []
        self._exceptions = []
        self._method = HippoNonbondedForce.NoCutoff
        self._cutoff = 1.0
        self._switching = 0.9
        self._ewald_tol = 1e-4
        self._alpha = 0.0
        self._grid = (0, 0, 0)
        self._d_alpha = 0.0
        self._d_grid = (0, 0, 0)
        self._ext_coeffs = [-0.154, 0.017, 0.657, 0.475]

    def getNumParticles(self):
        return len(self._particles)

    def addParticle(self, charge, dipole, quadrupole, coreCharge, alpha,
                    epsilon, damping, c6, pauliK, pauliQ, pauliAlpha,
                    polarizability, axisType, multipoleAtomZ,
                    multipoleAtomX, multipoleAtomY):
        self._particles.append({
            "charge": float(u.strip(charge, u.elementary_charge)),
            "dipole": [float(x) for x in dipole],
            "quadrupole": [float(x) for x in quadrupole],
            "coreCharge": float(u.strip(coreCharge, u.elementary_charge)),
            "alpha": float(alpha), "epsilon": float(epsilon),
            "damping": float(damping), "c6": float(c6),
            "pauliK": float(pauliK), "pauliQ": float(pauliQ),
            "pauliAlpha": float(pauliAlpha),
            "polarizability": float(polarizability),
            "axisType": int(axisType), "atomZ": int(multipoleAtomZ),
            "atomX": int(multipoleAtomX), "atomY": int(multipoleAtomY)})
        return len(self._particles) - 1

    def getParticleParameters(self, index):
        p = self._particles[index]
        return (p["charge"], list(p["dipole"]), list(p["quadrupole"]),
                p["coreCharge"], p["alpha"], p["epsilon"], p["damping"],
                p["c6"], p["pauliK"], p["pauliQ"], p["pauliAlpha"],
                p["polarizability"], p["axisType"], p["atomZ"], p["atomX"],
                p["atomY"])

    def setParticleParameters(self, index, charge, dipole, quadrupole,
                              coreCharge, alpha, epsilon, damping, c6,
                              pauliK, pauliQ, pauliAlpha, polarizability,
                              axisType, multipoleAtomZ, multipoleAtomX,
                              multipoleAtomY):
        self._particles[index] = {
            "charge": float(charge), "dipole": [float(x) for x in dipole],
            "quadrupole": [float(x) for x in quadrupole],
            "coreCharge": float(coreCharge), "alpha": float(alpha),
            "epsilon": float(epsilon), "damping": float(damping),
            "c6": float(c6), "pauliK": float(pauliK),
            "pauliQ": float(pauliQ), "pauliAlpha": float(pauliAlpha),
            "polarizability": float(polarizability),
            "axisType": int(axisType), "atomZ": int(multipoleAtomZ),
            "atomX": int(multipoleAtomX), "atomY": int(multipoleAtomY)}

    def getNumExceptions(self):
        return len(self._exceptions)

    def addException(self, particle1, particle2, multipoleMultipoleScale,
                     dipoleMultipoleScale, dipoleDipoleScale,
                     dispersionScale, repulsionScale, chargeTransferScale,
                     replace=False):
        self._exceptions.append((int(particle1), int(particle2),
                                 float(multipoleMultipoleScale),
                                 float(dipoleMultipoleScale),
                                 float(dipoleDipoleScale),
                                 float(dispersionScale),
                                 float(repulsionScale),
                                 float(chargeTransferScale)))
        return len(self._exceptions) - 1

    def getExceptionParameters(self, index):
        return self._exceptions[index]

    def setExceptionParameters(self, index, particle1, particle2, mm, dm,
                               dd, disp, rep, ct):
        self._exceptions[index] = (int(particle1), int(particle2),
                                   float(mm), float(dm), float(dd),
                                   float(disp), float(rep), float(ct))

    def getNonbondedMethod(self):
        return self._method

    def setNonbondedMethod(self, method):
        if method not in (0, 1):
            raise ValueError("HippoNonbondedForce: illegal method")
        self._method = int(method)

    def getCutoffDistance(self):
        return u.Quantity(self._cutoff, _NM)

    def setCutoffDistance(self, distance):
        self._cutoff = float(u.strip(distance, _NM))

    def getSwitchingDistance(self):
        return u.Quantity(self._switching, _NM)

    def setSwitchingDistance(self, distance):
        self._switching = float(u.strip(distance, _NM))

    def getExtrapolationCoefficients(self):
        return list(self._ext_coeffs)

    def setExtrapolationCoefficients(self, coeffs):
        self._ext_coeffs = [float(c) for c in coeffs]

    def getEwaldErrorTolerance(self):
        return self._ewald_tol

    def setEwaldErrorTolerance(self, tol):
        self._ewald_tol = float(tol)

    def getPMEParameters(self):
        return self._alpha, *self._grid

    def setPMEParameters(self, alpha, nx, ny, nz):
        self._alpha = float(alpha)
        self._grid = (int(nx), int(ny), int(nz))

    def getDPMEParameters(self):
        return self._d_alpha, *self._d_grid

    def setDPMEParameters(self, alpha, nx, ny, nz):
        self._d_alpha = float(alpha)
        self._d_grid = (int(nx), int(ny), int(nz))

    def _module_at(self, context):
        module = context._modules[id(self)]
        return module, context._state["positions"].to(F64)

    def getInducedDipoles(self, context):
        module, pos = self._module_at(context)
        with torch.no_grad():
            return module.induced(pos).cpu().numpy()

    def getLabFramePermanentDipoles(self, context):
        module, pos = self._module_at(context)
        with torch.no_grad():
            return module.lab(pos)[0].cpu().numpy()

    def usesPeriodicBoundaryConditions(self):
        return self._method == HippoNonbondedForce.PME

    def updateParametersInContext(self, context):
        context._update_force_parameters(self)

    def _bonded_particles(self):
        return [(e[0], e[1]) for e in self._exceptions]

    def _arrays(self):
        keys = ("charge", "coreCharge", "alpha", "epsilon", "damping", "c6",
                "pauliK", "pauliQ", "pauliAlpha", "polarizability")
        rows = [[p[k] for k in keys] + p["dipole"] + p["quadrupole"]
                for p in self._particles]
        frames = [[p["axisType"], p["atomZ"], p["atomX"], p["atomY"]]
                  for p in self._particles]
        return (np.asarray(rows, np.float64).reshape(-1, 22),
                np.asarray(frames, np.int64).reshape(-1, 4))

    def _scale_matrices(self, n):
        out = {k: np.ones((n, n)) for k in _SCALES}
        for (p1, p2, *values) in self._exceptions:
            for k, v in zip(_SCALES, values):
                out[k][p1, p2] = v
                out[k][p2, p1] = v
        for k in _SCALES:
            np.fill_diagonal(out[k], 0.0)
        return out

    def _compile(self, ctx):
        return HippoModule(self, ctx)


class HippoModule(_AutogradModule):
    """The compiled HippoNonbondedForce (NoCutoff)."""

    def __init__(self, force, ctx):
        super().__init__()
        n = ctx._n
        if len(force._particles) != n:
            raise ValueError("HippoNonbondedForce must have same particle "
                             "count as the System")
        if force._method != HippoNonbondedForce.NoCutoff:
            raise NotImplementedError(
                "HippoNonbondedForce: only NoCutoff is implemented, as in "
                "the JAX package")
        self.name, self.group, self.derivs = (force.getName(),
                                              force.getForceGroup(), ())
        dev = ctx._device
        self.n = n
        par, frames = force._arrays()
        self._frames = frames
        self._exceptions = list(force._exceptions)
        self.register_buffer("par", torch.as_tensor(par, dtype=F64,
                                                    device=dev))
        self.register_buffer("axis", torch.as_tensor(frames[:, 0],
                                                     device=dev))
        self.frames = _frame_plans(frames, n, dev)
        eye = torch.eye(3, dtype=F64, device=dev)
        self.consts = (eye[0], eye[1], eye[2], eye)
        self.register_buffer("off", ~torch.eye(n, dtype=torch.bool,
                                               device=dev))
        scales = force._scale_matrices(n)
        for k in _SCALES:
            self.register_buffer("s_" + k, torch.as_tensor(
                scales[k], dtype=F64, device=dev))
        coeffs = list(force._ext_coeffs)
        # partial sums: mu = sum_k (sum_{j>=k} c_j) mu^(k)  (:85-95)
        self.part = [sum(coeffs[k:]) for k in range(len(coeffs))]

    def update(self, force) -> None:
        par, frames = force._arrays()
        if (not np.array_equal(frames, self._frames)
                or [e[:2] for e in force._exceptions]
                != [e[:2] for e in self._exceptions]):
            raise ValueError("updateParametersInContext: the frames or the "
                             "exception pairs of the HippoNonbondedForce "
                             "have changed")
        self.par.copy_(torch.as_tensor(par, dtype=F64))
        scales = force._scale_matrices(self.n)
        for k in _SCALES:
            getattr(self, "s_" + k).copy_(torch.as_tensor(scales[k]))
        self._exceptions = list(force._exceptions)

    def _p(self, k):
        return self.par[:, k]

    def lab(self, pos):
        rot = _rotations(pos, self.frames, self.axis, self.consts)
        return lab_multipoles(rot, self.par[:, 10:13],
                              self.par[:, 13:22].reshape(-1, 3, 3))

    def _geometry(self, pos):
        dr = pos[None, :, :] - pos[:, None, :]          # Delta = r_k - r_i
        r2 = torch.where(self.off, (dr * dr).sum(dim=-1), 1.0)
        return dr, torch.sqrt(r2)

    @staticmethod
    def _contractions(d_lab, q_lab, dr):
        d_i, d_k = d_lab[:, None, :], d_lab[None, :, :]
        q_i, q_k = q_lab[:, None, :, :], q_lab[None, :, :, :]
        dir_ = _dot(d_i, dr)
        dkr = _dot(d_k, dr)
        dik = _dot(d_i, d_k)
        qi_d = (q_i * dr[:, :, None, :]).sum(dim=-1)
        qk_d = (q_k * dr[:, :, None, :]).sum(dim=-1)
        qir = _dot(qi_d, dr)
        qkr = _dot(qk_d, dr)
        qik = _dot(qi_d, qk_d)
        diqk = _dot(d_i, qk_d)
        dkqi = _dot(d_k, qi_d)
        qiqk = (q_i * q_k).sum(dim=(-2, -1))
        return dir_, dkr, dik, qir, qkr, qik, diqk, dkqi, qiqk

    def _electrostatic(self, c, r):
        dir_, dkr, dik, qir, qkr, qik, diqk, dkqi, qiqk = c
        core = self._p(1)
        val = self._p(0) - core
        inv = 1.0 / r
        inv2 = inv * inv
        rr1 = inv
        rr3 = rr1 * inv2
        rr5 = 3 * rr3 * inv2
        rr7 = 5 * rr5 * inv2
        rr9 = 7 * rr7 * inv2
        alpha = self._p(2)
        f = hm.overlap_damping(alpha[:, None], alpha[None, :], r)
        ci, ck = core[:, None], core[None, :]
        vi, vk = val[:, None], val[None, :]
        term1 = ci * ck
        term1i = ck * vi
        term2i = ck * dir_
        term3i = ck * qir
        term1k = ci * vk
        term2k = -ci * dkr
        term3k = ci * qkr
        term1ik = vi * vk
        term2ik = vk * dir_ - vi * dkr + dik
        term3ik = vi * qkr + vk * qir - dir_ * dkr \
            + 2 * (dkqi - diqk + qiqk)
        term4ik = dir_ * qkr - dkr * qir - 4 * qik
        term5ik = qir * qkr
        e = (term1 * rr1
             + term4ik * f["ij7"] * rr7 + term5ik * f["ij9"] * rr9
             + term1i * f["i1"] * rr1 + term1k * f["j1"] * rr1
             + term1ik * f["ij1"] * rr1
             + term2i * f["i3"] * rr3 + term2k * f["j3"] * rr3
             + term2ik * f["ij3"] * rr3
             + term3i * f["i5"] * rr5 + term3k * f["j5"] * rr5
             + term3ik * f["ij5"] * rr5)
        return ONE_4PI_EPS0 * self.s_mm * e

    def _repulsion(self, c, r):
        dir_, dkr, dik, qir, qkr, qik, diqk, dkqi, qiqk = c
        q = self._p(7)
        qI, qK = q[:, None], q[None, :]
        pa = self._p(8)
        f = hm.repulsion_damping(pa[:, None], pa[None, :], r)
        eterm1 = qI * qK
        eterm2 = qK * dir_ - qI * dkr + dik
        eterm3 = qI * qkr + qK * qir - dir_ * dkr \
            + 2 * (dkqi - diqk + qiqk)
        eterm4 = dir_ * qkr - dkr * qir - 4 * qik
        eterm5 = qir * qkr
        eterm = (eterm1 * f[1] + eterm2 * f[3] + eterm3 * f[5]
                 + eterm4 * f[7] + eterm5 * f[9])
        k = self._p(6)
        return self.s_rep * k[:, None] * k[None, :] * eterm / r

    def _dispersion(self, r):
        alpha, c6 = self._p(2), self._p(5)
        fd = hm.dispersion_damping(alpha[:, None], alpha[None, :], r)
        return self.s_disp * (-c6[:, None] * c6[None, :] / r ** 6) * fd * fd

    def _charge_transfer(self, r):
        eps, damping = self._p(3), self._p(4)
        t1 = eps[:, None] * torch.exp(-damping[None, :] * r)
        t2 = eps[None, :] * torch.exp(-damping[:, None] * r)
        return self.s_ct * (-(t1 + t2))

    def _fixed_field(self, d_lab, q_lab, dr, r):
        """Damped permanent field at every site (:557-589)."""
        core = self._p(1)
        val = self._p(0) - core
        inv = 1.0 / r
        inv2 = inv * inv
        r_inv3 = inv * inv2
        r_inv5 = r_inv3 * inv2
        r_inv7 = r_inv5 * inv2
        f3, f5, f7 = hm.direct_field_damping(self._p(2)[None, :], r)
        s = self.s_dm
        rr3 = s * r_inv3
        rr3j = s * f3 * r_inv3
        rr5j = s * 3 * f5 * r_inv5
        rr7j = s * 15 * f7 * r_inv7
        qk_d = (q_lab[None, :, :, :] * dr[:, :, None, :]).sum(dim=-1)
        dipdel = _dot(d_lab[None, :, :], dr)
        qdel = _dot(qk_d, dr)
        factor = (rr3 * core[None, :] + rr3j * val[None, :]
                  - rr5j * dipdel + rr7j * qdel)
        field = (factor[:, :, None] * dr
                 + d_lab[None, :, :] * rr3j[:, :, None]
                 - qk_d * (2 * rr5j)[:, :, None])
        w = self.off.to(F64)
        return -(field * w[:, :, None]).sum(dim=1)

    def _induce(self, e_fixed_mu, dr, r):
        """Extrapolated (OPT) induced dipoles (:640-683)."""
        alpha = self._p(2)
        f3, f5 = hm.mutual_field_damping(alpha[:, None], alpha[None, :], r)
        f3 = f3 * self.s_dd
        f5 = f5 * self.s_dd
        inv = 1.0 / r
        inv2 = inv * inv
        r_inv3 = inv * inv2
        w = self.off.to(F64)
        scale3 = -f3 * r_inv3 * w
        scale5 = 3 * f5 * r_inv3 * inv2 * w

        def field(mu):
            mu_r = _dot(mu[None, :, :], dr)
            contrib = (mu[None, :, :] * scale3[:, :, None]
                       + dr * (scale5 * mu_r)[:, :, None])
            return contrib.sum(dim=1)

        pol = self._p(9)[:, None]
        mus = [e_fixed_mu]
        for _ in range(1, len(self.part)):
            mus.append(pol * field(mus[-1]))
        return sum(c * m for c, m in zip(self.part, mus)), mus[0]

    def induced(self, pos):
        d_lab, q_lab = self.lab(pos)
        dr, r = self._geometry(pos)
        e_f = self._fixed_field(d_lab, q_lab, dr, r)
        return self._induce(self._p(9)[:, None] * e_f, dr, r)[0]

    def _energy(self, pos, box, state):
        d_lab, q_lab = self.lab(pos)
        dr, r = self._geometry(pos)
        c = self._contractions(d_lab, q_lab, dr)
        e_pair = (self._electrostatic(c, r) + self._repulsion(c, r)
                  + self._dispersion(r) + self._charge_transfer(r))
        e = 0.5 * torch.where(self.off, e_pair, 0.0).sum()
        e_f = self._fixed_field(d_lab, q_lab, dr, r)
        pol = self._p(9)
        mu, mu0 = self._induce(pol[:, None] * e_f, dr, r)
        inv_pol = torch.where(pol > 0, 1.0 / torch.clamp(pol, min=1e-12),
                              0.0)
        return e - 0.5 * ONE_4PI_EPS0 * (inv_pol[:, None] * mu0 * mu).sum()
