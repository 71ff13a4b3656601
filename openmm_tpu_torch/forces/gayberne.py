"""GayBerneForce: the anisotropic Lennard-Jones interaction of ellipsoids
whose body frames follow from particles (Everaers and Ejtehadi 2003).

Counterpart of openmm_tpu/forces/gayberne.py (GayBerneForce.h): each
particle has sigma, epsilon, half axes sx/2, sy/2, sz/2 (the radii r_k)
and energy scales e_k, and its frame from xparticle (x axis towards it)
and yparticle (y axis towards it, orthogonalised; -1: any perpendicular);
a pair's energy is E = U_r eta chi (times the switch) with
  G = A1^T S1^2 A1 + A2^T S2^2 A2, sigma12 = (r^ . G^-1 r^ / 2)^-1/2,
  h = r - sigma12, U_r = 4 eps ((sig/(h + sig))^12 - (sig/(h + sig))^6),
  eta = sqrt(2 s1 s2 / det G), s = (r_x r_y + r_z^2) sqrt(r_x r_y),
  B = A1^T E1 A1 + A2^T E2 A2 with E = diag(e_k^-1/2), chi = (2 r^ . B^-1 r^)^2,
Lorentz-Berthelot mixing (an exception's sigma and epsilon replace a
pair's), the switch and the three methods; it is Lennard-Jones for
spheres with unit energy scales.

The JAX package takes the forces by jax.grad. Here they are written by
hand: each pair's gradient in its displacement and in G and B
(d quad/dG = -u u^T with u = G^-1 r^, d eta/dG = -eta G^-1 / 2,
d c/dB = -v v^T with v = B^-1 r^), G's and B's gradients carried to each
particle's frame (dE/dA = 2 S^2 A W), and the frame's gradient carried to
the particle and its frame particles through the cross product, the
Gram-Schmidt step and the normalisations, as OpenMM's reference turns
torques into forces. Every pair is listed once (i < j, the exceptions
apart) when the Context is built, as the JAX package sweeps them; the
per-particle sums go through gather tables (ops/accumulate.py). float64.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import unit as u
from ..ops import geometry as geom
from ..ops.accumulate import GatherSum
from ..ops.pairs import AnalyticEnergy
from .base import Force

_E = u.kilojoule_per_mole
_NM = u.nanometer

F64 = torch.float64


def _inv3(m):
    """(inverse, determinant) of (..., 3, 3) by the adjugate."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    cof = torch.stack([e * i - f * h, c * h - b * i, b * f - c * e,
                       f * g - d * i, a * i - c * g, c * d - a * f,
                       d * h - e * g, b * g - a * h, a * e - b * d],
                      dim=-1).reshape(m.shape)
    det = a * cof[..., 0, 0] + b * cof[..., 1, 0] + c * cof[..., 2, 0]
    return cof / det[..., None, None], det


def _dot(a, b):
    return (a * b).sum(dim=-1, keepdim=True)


def _unit_back(g, e, norm):
    """The gradient in v of a loss through e = v / |v|, given its gradient
    g in e."""
    return (g - e * _dot(e, g)) / norm


class GayBerneForce(Force):
    NoCutoff = 0
    CutoffNonPeriodic = 1
    CutoffPeriodic = 2

    def __init__(self):
        super().__init__()
        # (sigma, eps, xparticle, yparticle, sx, sy, sz, ex, ey, ez)
        self._particles = []
        self._exceptions = []         # (p1, p2, sigma, epsilon)
        self._exception_index = {}
        self._method = GayBerneForce.NoCutoff
        self._cutoff = 1.0
        self._switching = False
        self._switch_dist = -1.0

    def getNumParticles(self) -> int:
        return len(self._particles)

    def addParticle(self, sigma, epsilon, xparticle, yparticle, sx, sy, sz,
                    ex, ey, ez) -> int:
        self._particles.append((
            float(u.strip(sigma, _NM)), float(u.strip(epsilon, _E)),
            int(xparticle), int(yparticle), float(u.strip(sx, _NM)),
            float(u.strip(sy, _NM)), float(u.strip(sz, _NM)), float(ex),
            float(ey), float(ez)))
        return len(self._particles) - 1

    def getParticleParameters(self, index):
        return self._particles[index]

    def setParticleParameters(self, index, sigma, epsilon, xparticle,
                              yparticle, sx, sy, sz, ex, ey, ez) -> None:
        self._particles[index] = (
            float(u.strip(sigma, _NM)), float(u.strip(epsilon, _E)),
            int(xparticle), int(yparticle), float(u.strip(sx, _NM)),
            float(u.strip(sy, _NM)), float(u.strip(sz, _NM)), float(ex),
            float(ey), float(ez))

    def getNumExceptions(self) -> int:
        return len(self._exceptions)

    def addException(self, particle1, particle2, sigma, epsilon,
                     replace=False) -> int:
        key = (min(particle1, particle2), max(particle1, particle2))
        if key in self._exception_index and not replace:
            raise ValueError("GayBerneForce: duplicate exception")
        entry = (int(particle1), int(particle2), float(u.strip(sigma, _NM)),
                 float(u.strip(epsilon, _E)))
        if key in self._exception_index:
            self._exceptions[self._exception_index[key]] = entry
            return self._exception_index[key]
        self._exceptions.append(entry)
        self._exception_index[key] = len(self._exceptions) - 1
        return len(self._exceptions) - 1

    def getExceptionParameters(self, index):
        return self._exceptions[index]

    def setExceptionParameters(self, index, particle1, particle2, sigma,
                               epsilon) -> None:
        self._exceptions[index] = (int(particle1), int(particle2),
                                   float(u.strip(sigma, _NM)),
                                   float(u.strip(epsilon, _E)))

    def getNonbondedMethod(self) -> int:
        return self._method

    def setNonbondedMethod(self, method) -> None:
        self._method = int(method)

    def getCutoffDistance(self) -> float:
        return self._cutoff

    def setCutoffDistance(self, distance) -> None:
        self._cutoff = float(u.strip(distance, _NM))

    def getUseSwitchingFunction(self) -> bool:
        return self._switching

    def setUseSwitchingFunction(self, use) -> None:
        self._switching = bool(use)

    def getSwitchingDistance(self) -> float:
        return self._switch_dist

    def setSwitchingDistance(self, distance) -> None:
        self._switch_dist = float(u.strip(distance, _NM))

    def usesPeriodicBoundaryConditions(self) -> bool:
        return self._method == GayBerneForce.CutoffPeriodic

    def updateParametersInContext(self, context) -> None:
        context._update_force_parameters(self)

    def _arrays(self):
        """(particle parameters (n, 8): sigma, eps, radii, scales; frame
        particles (n, 2); exception pairs (m, 2) and parameters (m, 2))."""
        p = self._particles
        par = np.asarray([(q[0], q[1], 0.5 * q[4], 0.5 * q[5], 0.5 * q[6],
                           *q[7:]) for q in p], np.float64).reshape(-1, 8)
        frames = np.asarray([q[2:4] for q in p], np.int64).reshape(-1, 2)
        exc = self._exceptions
        return (par, frames,
                np.asarray([e[:2] for e in exc], np.int64).reshape(-1, 2),
                np.asarray([e[2:] for e in exc], np.float64).reshape(-1, 2))

    def _compile(self, ctx):
        return GayBerneModule(self, ctx)


class GayBerneModule(nn.Module):
    """The compiled GayBerneForce (the CustomModule contract of
    forces/custom.py: ef, energy, parameter_derivatives, update)."""

    def __init__(self, force, ctx):
        super().__init__()
        n = ctx._n
        if len(force._particles) != n:
            raise ValueError("GayBerneForce must have the same number of "
                             "particles as the System")
        self.name = force.getName()
        self.group = force.getForceGroup()
        self.derivs = ()
        self.n = n
        dev = ctx._device
        par, frames, exc, exc_par = force._arrays()
        self.periodic = force.usesPeriodicBoundaryConditions()
        method = force.getNonbondedMethod()
        self.cutoff = (None if method == GayBerneForce.NoCutoff
                       else force.getCutoffDistance())
        self.switch = (force.getSwitchingDistance()
                       if force.getUseSwitchingFunction()
                       and self.cutoff is not None else None)
        # every pair once: i < j but the exceptions, then the exceptions
        is_exc = np.zeros((n, n), bool)
        is_exc[exc[:, 0], exc[:, 1]] = is_exc[exc[:, 1], exc[:, 0]] = True
        iu, ju = np.triu_indices(n, k=1)
        keep = ~is_exc[iu, ju]
        pairs = np.concatenate([np.stack([iu[keep], ju[keep]], axis=1),
                                exc]).astype(np.int64)
        self.n_mixed = int(keep.sum())
        self._exc_pairs = exc
        self.register_buffer("pairs", torch.as_tensor(pairs, device=dev))
        self.register_buffer("par", torch.as_tensor(par, dtype=F64,
                                                    device=dev))
        self.register_buffer("exc_par", torch.as_tensor(exc_par, dtype=F64,
                                                        device=dev))
        has = frames >= 0
        self.register_buffer("frames", torch.as_tensor(
            np.maximum(frames, 0), device=dev))
        self.register_buffer("has_x", torch.as_tensor(has[:, :1],
                                                      device=dev))
        self.register_buffer("has_y", torch.as_tensor(has[:, 1:],
                                                      device=dev))
        self.pair_gather = GatherSum(pairs, n, dev)
        own = np.concatenate([np.arange(n)[:, None], np.maximum(frames, 0)],
                             axis=1)
        self.frame_gather = GatherSum(own, n, dev)
        # the lab axes, on the device once (a copy from the host cannot be
        # captured in a CUDA graph)
        self.register_buffer("axes", torch.eye(3, dtype=F64, device=dev))

    def update(self, force) -> None:
        par, frames, exc, exc_par = force._arrays()
        if (par.shape != tuple(self.par.shape)
                or not np.array_equal(exc, self._exc_pairs)
                or not np.array_equal(np.maximum(frames, 0),
                                      self.frames.cpu().numpy())
                or not np.array_equal(frames >= 0, np.concatenate(
                    [self.has_x.cpu().numpy(), self.has_y.cpu().numpy()],
                    axis=1))):
            raise ValueError("updateParametersInContext: the particles, "
                             "frames or exceptions of the GayBerneForce "
                             "have changed")
        self.par.copy_(torch.as_tensor(par))
        self.exc_par.copy_(torch.as_tensor(exc_par))

    def _frames(self, pos):
        """(A (n, 3, 3), the rows the body axes, and what the backward
        needs)."""
        xdir = pos[self.frames[:, 0]] - pos
        xnorm = torch.sqrt(_dot(xdir, xdir))
        unit_x, k_y, k_z = self.axes
        ex = torch.where(self.has_x, xdir / torch.where(self.has_x, xnorm,
                                                        1.0), unit_x)
        ydir = pos[self.frames[:, 1]] - pos
        w = ydir - ex * _dot(ydir, ex)
        alt_z = torch.cross(ex, k_z.expand_as(ex), dim=-1)
        big = _dot(alt_z, alt_z) > 0.01
        axis = torch.where(big, k_z, k_y)
        alt = torch.cross(ex, axis, dim=-1)
        v = torch.where(self.has_y, w, alt)
        vnorm = torch.sqrt(_dot(v, v))
        ey = v / vnorm
        ez = torch.cross(ex, ey, dim=-1)
        saved = (xdir, xnorm, ex, ydir, w, axis, ey, vnorm)
        return torch.stack([ex, ey, ez], dim=-2), saved

    def _frames_back(self, grad_a, saved):
        """The gradient in the positions (n, 3) through the frames, given
        the gradient in A (n, 3, 3)."""
        xdir, xnorm, ex, ydir, w, axis, ey, vnorm = saved
        gx, gy, gz = grad_a.unbind(1)
        # through ez = ex x ey
        gx = gx + torch.cross(ey, gz, dim=-1)
        gy = gy + torch.cross(gz, ex, dim=-1)
        gv = _unit_back(gy, ey, vnorm)
        # through w = ydir - ex (ydir . ex), or alt = ex x axis
        g_ydir = torch.where(self.has_y, gv - ex * _dot(ex, gv), 0.0)
        gx = gx + torch.where(self.has_y,
                              -_dot(ydir, ex) * gv - ydir * _dot(ex, gv),
                              torch.cross(axis, gv, dim=-1))
        g_xdir = torch.where(self.has_x, _unit_back(
            gx, ex, torch.where(self.has_x, xnorm, 1.0)), 0.0)
        contrib = torch.stack([-(g_xdir + g_ydir), g_xdir, g_ydir], dim=1)
        return self.frame_gather(contrib)

    def _compute(self, pos, box):
        pos = pos.to(F64)
        a, saved = self._frames(pos)
        i, j = self.pairs[:, 0], self.pairs[:, 1]
        sig_p, eps_p = self.par[:, 0], self.par[:, 1]
        radii, scale = self.par[:, 2:5], self.par[:, 5:8]
        m = self.n_mixed
        sig = torch.cat([0.5 * (sig_p[i[:m]] + sig_p[j[:m]]),
                         self.exc_par[:, 0]])
        eps = torch.cat([torch.sqrt(eps_p[i[:m]] * eps_p[j[:m]]),
                         self.exc_par[:, 1]])
        r12 = geom.delta(pos[j], pos[i],
                         box.to(F64) if self.periodic else None)
        r = torch.sqrt((r12 * r12).sum(dim=-1) + 1e-30)
        rhat = r12 / r[:, None]
        a1, a2 = a[i], a[j]
        s1, s2 = radii[i] ** 2, radii[j] ** 2
        g_mat = (torch.einsum("mia,mi,mib->mab", a1, s1, a1)
                 + torch.einsum("mia,mi,mib->mab", a2, s2, a2))
        g_inv, det_g = _inv3(g_mat)
        u = torch.einsum("mab,mb->ma", g_inv, rhat)
        quad = (rhat * u).sum(dim=-1)
        half = 0.5 * quad
        ok_q = half > 1e-12
        sigma12 = 1.0 / torch.sqrt(torch.where(ok_q, half, 1e-12))
        h = r - sigma12
        frac = sig / (h + sig)
        f6 = frac ** 6
        ur = 4.0 * eps * f6 * (f6 - 1.0)
        dur_dh = -24.0 * eps * f6 * (2.0 * f6 - 1.0) / (h + sig)
        dsig_dquad = torch.where(ok_q, -0.25 * sigma12 ** 3, 0.0)
        r1, r2 = radii[i], radii[j]
        shape1 = (r1[:, 0] * r1[:, 1] + r1[:, 2] ** 2) * torch.sqrt(
            r1[:, 0] * r1[:, 1])
        shape2 = (r2[:, 0] * r2[:, 1] + r2[:, 2] ** 2) * torch.sqrt(
            r2[:, 0] * r2[:, 1])
        ok_det = det_g > 1e-30
        eta = torch.sqrt(2.0 * shape1 * shape2
                         / torch.where(ok_det, det_g, 1e-30))
        einv = 1.0 / torch.sqrt(scale)
        e1, e2 = einv[i], einv[j]
        b_mat = (torch.einsum("mia,mi,mib->mab", a1, e1, a1)
                 + torch.einsum("mia,mi,mib->mab", a2, e2, a2))
        b_inv, _ = _inv3(b_mat)
        v = torch.einsum("mab,mb->ma", b_inv, rhat)
        c = (rhat * v).sum(dim=-1)
        chi = 4.0 * c * c
        sw = torch.ones_like(r)
        dsw = torch.zeros_like(r)
        if self.switch is not None:
            width = self.cutoff - self.switch
            x = torch.clamp((r - self.switch) / width, 0.0, 1.0)
            sw = 1.0 - x ** 3 * (10.0 - 15.0 * x + 6.0 * x * x)
            dsw = -30.0 * x * x * (1.0 - x) ** 2 / width
        inside = (torch.ones_like(r, dtype=torch.bool) if self.cutoff is None
                  else r < self.cutoff)
        energy = torch.where(inside, ur * eta * chi * sw, 0.0).sum()
        # dE/dr12
        dquad = (2.0 / r)[:, None] * (u - quad[:, None] * rhat)
        dh = rhat - dsig_dquad[:, None] * dquad
        dc = (2.0 / r)[:, None] * (v - c[:, None] * rhat)
        g_r = ((sw * eta * chi * dur_dh)[:, None] * dh
               + (sw * ur * eta * 8.0 * c)[:, None] * dc
               + (ur * eta * chi * dsw)[:, None] * rhat)
        # dE/dG and dE/dB
        w_g = ((sw * chi * eta * dur_dh * dsig_dquad)[:, None, None]
               * u[:, :, None] * u[:, None, :]
               - (0.5 * sw * chi * ur * torch.where(ok_det, eta, 0.0))[
                   :, None, None] * g_inv)
        w_b = -(sw * ur * eta * 8.0 * c)[:, None, None] \
            * v[:, :, None] * v[:, None, :]
        keep = inside[:, None, None]
        w_g = torch.where(keep, w_g, 0.0)
        w_b = torch.where(keep, w_b, 0.0)
        g_r = torch.where(inside[:, None], g_r, 0.0)

        def frame_grad(ak, sk, ek):
            return 2.0 * (sk[:, :, None] * (ak @ w_g)
                          + ek[:, :, None] * (ak @ w_b))

        contrib = torch.cat([
            torch.stack([-g_r, g_r], dim=1),
            torch.stack([frame_grad(a1, s1, e1),
                         frame_grad(a2, s2, e2)], dim=1).reshape(-1, 2, 9)],
            dim=-1)
        sums = self.pair_gather(contrib)
        grad = sums[:, :3] + self._frames_back(sums[:, 3:].reshape(-1, 3, 3),
                                               saved)
        return energy, -grad

    def ef(self, pos, box):
        return self._compute(pos, box)

    def energy(self, pos, box):
        return AnalyticEnergy.apply(self.ef, pos, box)

    def parameter_derivatives(self, pos, box) -> dict:
        return {}
