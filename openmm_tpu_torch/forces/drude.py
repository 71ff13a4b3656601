"""DrudeForce: charge-on-spring polarization and Thole-screened pairs.

Counterpart of openmm_tpu/forces/drude.py (the drude plugin's
DrudeForce.h; drudeParticleForce.cc and drudePairForce.cc). Each Drude
particle d is tied to its parent p by a spring of energy

    E = k3 |delta|^2 / 2 + k1 (u1 . delta)^2 / 2 + k2 (u2 . delta)^2 / 2,

delta = x_d - x_p, u1 the unit vector from particle2 to the parent, u2
from particle4 to particle3, and k1, k2, k3 from the charge, the
polarizability and aniso12/aniso34 as _pack_params computes them
(CommonDrudeKernels.cpp:114-128): a partner of -1 makes that term
isotropic (its k is 0, its partner the parent, its direction the zero
vector over the clamped norm of geom.distance, so nothing divides by 0).
Each screened pair of Drude particles (d1, p1), (d2, p2) adds four
Coulomb terms, +d1-d2, -d1-p2, -p1-d2, +p1-p2, each q_i q_j S(u) / r
with u = thole / (alpha_1 alpha_2)^(1/6) r and S(u) = 1 - (1 + u/2) e^-u.
With periodic boundaries every displacement is a minimum image.

The energy and the forces are float64, the forces in closed form, as
forces/bonded.py computes its terms, and each atom's sum of its terms'
forces goes through gathers in a fixed order (ops/accumulate.py): no
float atomics on the step.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import unit as u
from ..constants import ONE_4PI_EPS0
from ..ops import geometry as geom
from ..ops.accumulate import GatherSum
from .base import Force

_NM = u.nanometer
F64 = torch.float64


class DrudeForce(Force):
    def __init__(self):
        super().__init__()
        # (particle, particle1, particle2, particle3, particle4, charge,
        #  polarizability, aniso12, aniso34)
        self._particles = []
        self._screened_pairs = []   # (particle1, particle2, thole)
        self._periodic = False

    def getNumParticles(self) -> int:
        return len(self._particles)

    @staticmethod
    def _entry(particle, particle1, particle2, particle3, particle4, charge,
               polarizability, aniso12, aniso34) -> tuple:
        return (int(particle), int(particle1), int(particle2),
                int(particle3), int(particle4),
                float(u.strip(charge, u.elementary_charge)),
                float(u.strip(polarizability, _NM ** 3)),
                float(aniso12), float(aniso34))

    def addParticle(self, particle, particle1, particle2, particle3,
                    particle4, charge, polarizability, aniso12,
                    aniso34) -> int:
        self._particles.append(self._entry(
            particle, particle1, particle2, particle3, particle4, charge,
            polarizability, aniso12, aniso34))
        return len(self._particles) - 1

    def getParticleParameters(self, index):
        return self._particles[index]

    def setParticleParameters(self, index, particle, particle1, particle2,
                              particle3, particle4, charge, polarizability,
                              aniso12, aniso34) -> None:
        self._particles[index] = self._entry(
            particle, particle1, particle2, particle3, particle4, charge,
            polarizability, aniso12, aniso34)

    def getNumScreenedPairs(self) -> int:
        return len(self._screened_pairs)

    def addScreenedPair(self, particle1, particle2, thole) -> int:
        self._screened_pairs.append((int(particle1), int(particle2),
                                     float(thole)))
        return len(self._screened_pairs) - 1

    def getScreenedPairParameters(self, index):
        return self._screened_pairs[index]

    def setScreenedPairParameters(self, index, particle1, particle2,
                                  thole) -> None:
        self._screened_pairs[index] = (int(particle1), int(particle2),
                                       float(thole))

    def setUsesPeriodicBoundaryConditions(self, periodic) -> None:
        self._periodic = bool(periodic)

    def usesPeriodicBoundaryConditions(self) -> bool:
        return self._periodic

    def updateParametersInContext(self, context) -> None:
        """Copy the charges, polarizabilities, anisotropies and tholes
        into the Context in place (the particles and the pairs must be
        those it was built with)."""
        context._update_force_parameters(self)

    def _bonded_particles(self):
        return [(p[0], p[1]) for p in self._particles]

    def _drude_pairs(self):
        """(drude, parent) index pairs: what the Drude integrators
        thermostat apart."""
        return [(p[0], p[1]) for p in self._particles]

    def _pack_params(self) -> tuple:
        """(k (m, 3) = k1, k2, k3 of each particle; (s, 2) = the Thole
        scale thole / (alpha_1 alpha_2)^(1/6) and k_e q_1 q_2 of each
        screened pair), float64 numpy, as the JAX package packs them."""
        k123 = np.zeros((len(self._particles), 3))
        for i, (_, _, p2, p3, p4, charge, alpha, aniso12,
                aniso34) in enumerate(self._particles):
            a1 = 1.0 if p2 == -1 else aniso12
            a2 = 1.0 if (p3 == -1 or p4 == -1) else aniso34
            a3 = 3.0 - a1 - a2
            k3 = ONE_4PI_EPS0 * charge * charge / (alpha * a3)
            k1 = ONE_4PI_EPS0 * charge * charge / (alpha * a1) - k3
            k2 = ONE_4PI_EPS0 * charge * charge / (alpha * a2) - k3
            k123[i] = (0.0 if p2 == -1 else k1,
                       0.0 if (p3 == -1 or p4 == -1) else k2, k3)
        sp = np.zeros((len(self._screened_pairs), 2))
        for j, (s1, s2, thole) in enumerate(self._screened_pairs):
            a, b = self._particles[s1], self._particles[s2]
            sp[j] = (thole / (a[6] * b[6]) ** (1.0 / 6.0),
                     ONE_4PI_EPS0 * a[5] * b[5])
        return k123, sp

    def _indices(self) -> tuple:
        """(the springs' (m, 5) atoms: drude, parent, particle2..4 with a
        partner of -1 replaced by the parent; the screened pairs' (s, 4)
        atoms: drude1, parent1, drude2, parent2)."""
        arr = np.asarray([p[:5] for p in self._particles],
                         np.int64).reshape(-1, 5)
        springs = np.where(arr < 0, arr[:, 1:2], arr)
        pairs = np.asarray(
            [self._particles[s1][:2] + self._particles[s2][:2]
             for s1, s2, _ in self._screened_pairs], np.int64).reshape(-1, 4)
        return springs, pairs

    def _compile(self, n_atoms, device) -> "DrudeModule":
        return DrudeModule(self, n_atoms, device)


def _direction(pos, a, b, box):
    """(unit vectors from b to a, their clamped norms)."""
    d = geom.delta(pos[a], pos[b], box)
    n = geom.distance(d)
    return d / n[:, None], n


def spring_terms(pos, idx, k, box=None):
    """(energy, forces (m, 5, 3) on drude, parent, particle2..4) of the
    springs: -dE/dx in closed form. An anisotropic term's direction u = d
    / |d| has dE/dd = k (u . delta) (delta - (u . delta) u) / |d|."""
    delta = geom.delta(pos[idx[:, 0]], pos[idx[:, 1]], box)
    f_delta = -k[:, 2, None] * delta
    energy = 0.5 * k[:, 2] * (delta * delta).sum(dim=-1)
    slots = [None, None, None, None]
    for col, (a, b) in ((0, (1, 2)), (1, (3, 4))):
        unit, norm = _direction(pos, idx[:, a], idx[:, b], box)
        proj = (unit * delta).sum(dim=-1)
        kp = k[:, col] * proj
        energy = energy + 0.5 * kp * proj
        f_delta = f_delta - kp[:, None] * unit
        g = (kp / norm)[:, None] * (delta - proj[:, None] * unit)
        slots[2 * col], slots[2 * col + 1] = -g, g
    # slot 1 is the parent: -delta's force plus its share as the first
    # atom of direction 1
    forces = torch.stack([f_delta, -f_delta + slots[0], slots[1],
                          slots[2], slots[3]], dim=1)
    return energy.sum(), forces


_SCREENED = ((0, 2, 1.0), (0, 3, -1.0), (1, 2, -1.0), (1, 3, 1.0))


def screened_terms(pos, idx, params, box=None):
    """(energy, forces (s, 4, 3) on drude1, parent1, drude2, parent2) of
    the Thole-screened pairs: each of the four terms sign qq S(u) / r,
    dS/du = (1 + u) e^-u / 2."""
    uscale, qq = params[:, 0], params[:, 1]
    energy = pos.new_zeros(())
    forces = pos.new_zeros((idx.shape[0], 4, 3))
    for i, j, sign in _SCREENED:
        d = geom.delta(pos[idx[:, i]], pos[idx[:, j]], box)
        r = geom.distance(d)
        uu = uscale * r
        ex = torch.exp(-uu)
        s = 1.0 - (1.0 + 0.5 * uu) * ex
        energy = energy + (sign * qq * s / r).sum()
        de_dr = sign * qq * (0.5 * (1.0 + uu) * ex * uscale / r - s / (r * r))
        f = -(de_dr / r)[:, None] * d
        forces[:, i] += f
        forces[:, j] -= f
    return energy, forces


class DrudeModule(nn.Module):
    """A DrudeForce on one device, in float64: ef(pos, box) -> (energy,
    forces (n, 3)), energy(pos, box), update(force)."""

    def __init__(self, force, n_atoms, device):
        super().__init__()
        self.name = force.getName()
        self.group = force.getForceGroup()
        self.periodic = force.usesPeriodicBoundaryConditions()
        self.n = n_atoms
        springs, pairs = force._indices()
        k, sp = force._pack_params()
        self.springs = torch.as_tensor(springs, device=device)
        self.pairs = torch.as_tensor(pairs, device=device)
        self.k = torch.as_tensor(k, dtype=F64, device=device)
        self.sp = torch.as_tensor(sp, dtype=F64, device=device)
        self.gather = GatherSum(springs, n_atoms, device)
        self.pair_gather = GatherSum(pairs, n_atoms, device)

    def _box(self, box):
        return box.to(F64) if self.periodic else None

    def ef(self, pos, box):
        pos = pos.to(F64)
        box = self._box(box)
        energy = pos.new_zeros(())
        forces = torch.zeros_like(pos)
        if self.springs.shape[0]:
            e, contrib = spring_terms(pos, self.springs, self.k, box)
            energy, forces = energy + e, forces + self.gather(contrib)
        if self.pairs.shape[0]:
            e, contrib = screened_terms(pos, self.pairs, self.sp, box)
            energy = energy + e
            forces = forces + self.pair_gather(contrib)
        return energy, forces

    def energy(self, pos, box):
        """The energy, differentiable in pos (the minimizer's objective,
        the barostats' trials)."""
        return self.ef(pos, box)[0]

    def update(self, force) -> None:
        springs, pairs = force._indices()
        if springs.shape != tuple(self.springs.shape) \
                or pairs.shape != tuple(self.pairs.shape) \
                or not np.array_equal(springs, self.springs.cpu().numpy()) \
                or not np.array_equal(pairs, self.pairs.cpu().numpy()):
            raise ValueError("updateParametersInContext: the particles or "
                             "the screened pairs of %s have changed"
                             % self.name)
        k, sp = force._pack_params()
        self.k.copy_(torch.as_tensor(k, dtype=F64))
        self.sp.copy_(torch.as_tensor(sp, dtype=F64))
