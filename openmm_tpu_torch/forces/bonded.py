"""The standard bonded forces: HarmonicBond, HarmonicAngle, PeriodicTorsion,
RBTorsion and CMAPTorsion.

Counterpart of openmm_tpu/forces/bonded.py, in nm, rad and kJ/mol. Every
term of a force is one gather and one elementwise pass. Each force has
two functions, in the idiom of forces/nonbonded.py: `<kind>_ef` gives the
energy and the analytic forces on the atoms of each term (what the MD
step calls), `<kind>_energy` the energy alone, differentiable in the
positions (the minimizer's objective). A compiled force (BondedModule)
adds the per-term forces of each atom by gathers in a fixed order
(ops/accumulate.py), so a step gives the same bits on every run.

Bonded terms are evaluated in float64 in every precision: they are cheap,
and the stiff bond and angle terms amplify the rounding of float32
positions (~2.4e-7 nm at 4-8 nm from the origin) into force errors of
1e-4 and more of a typical total force. The JAX package's TPU band-matmul
path (_make_windowed_ef, ops/bandsel.py) is a workaround for the TPU and
has no counterpart here.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from .. import unit as u
from ..ops import geometry as geom
from ..ops.accumulate import GatherSum
from ..utils.splines import bicubic_coefficients_periodic
from .base import Force

_E = u.kilojoule_per_mole
_NM = u.nanometer
_RAD = u.radian
_E_PER_NM2 = _E / _NM ** 2
_E_PER_RAD2 = _E / _RAD ** 2

F64 = torch.float64


class _PeriodicMixin:
    def setUsesPeriodicBoundaryConditions(self, periodic: bool) -> None:
        self._periodic = bool(periodic)

    def updateParametersInContext(self, context) -> None:
        """Copy the terms' parameters into the Context in place (the
        terms' count and particles must be those it was built with)."""
        context._update_force_parameters(self)

    def usesPeriodicBoundaryConditions(self) -> bool:
        return self._periodic


# -- the functions: energies and per-slot forces (m, k, 3) ----------------
def _bond_terms(pos, idx, r0, k, box):
    dr = geom.bond_vectors(pos, idx, box)
    r = geom.distance(dr)
    dev = r - r0
    return 0.5 * k * dev * dev, k * dev, dr, r


def bond_energy(pos, idx, r0, k, box=None):
    """E = sum (k/2)(r - r0)^2, differentiable in pos."""
    return _bond_terms(pos, idx, r0, k, box)[0].sum()


def bond_ef(pos, idx, r0, k, box=None):
    """(energy, forces (m, 2, 3) on the two atoms of each bond)."""
    e, de_dr, dr, r = _bond_terms(pos, idx, r0, k, box)
    f0 = -(de_dr / r)[:, None] * dr
    return e.sum(), torch.stack([f0, -f0], dim=1)


def _angle_vectors(pos, idx, box):
    return (geom.delta(pos[idx[:, 0]], pos[idx[:, 1]], box),
            geom.delta(pos[idx[:, 2]], pos[idx[:, 1]], box))


def angle_energy(pos, idx, theta0, k, box=None):
    """E = sum (k/2)(theta - theta0)^2, theta the angle 0-1-2."""
    v1, v2 = _angle_vectors(pos, idx, box)
    d = geom.angle_between(v1, v2) - theta0
    return (0.5 * k * d * d).sum()


def angle_ef(pos, idx, theta0, k, box=None):
    """(energy, forces (m, 3, 3)). With c = v1 x v2 (v1 = r0 - r1,
    v2 = r2 - r1): dtheta/dv1 = v1 x c / (|v1|^2 |c|) and
    dtheta/dv2 = -v2 x c / (|v2|^2 |c|)."""
    v1, v2 = _angle_vectors(pos, idx, box)
    c = torch.linalg.cross(v1, v2)
    cn = torch.sqrt((c * c).sum(dim=-1))
    theta = torch.atan2(cn, (v1 * v2).sum(dim=-1))
    d = theta - theta0
    de = k * d
    # a straight angle (c = 0) gets no force rather than 0/0
    scale = de / torch.clamp(cn, min=1e-30)
    f0 = -(scale / (v1 * v1).sum(dim=-1))[:, None] * torch.linalg.cross(v1, c)
    f2 = (scale / (v2 * v2).sum(dim=-1))[:, None] * torch.linalg.cross(v2, c)
    return (0.5 * k * d * d).sum(), torch.stack([f0, -(f0 + f2), f2], dim=1)


def _dihedral(pos, quad, box):
    return geom.dihedral_angle(pos[quad[:, 0]], pos[quad[:, 1]],
                               pos[quad[:, 2]], pos[quad[:, 3]], box)


def angle_gradient(v1, v2):
    """(theta, dtheta/dv1, dtheta/dv2) of the angle between v1 and v2 (the
    formulas of angle_ef, a straight angle with no gradient rather than
    0/0)."""
    c = torch.linalg.cross(v1, v2)
    cn = torch.sqrt((c * c).sum(dim=-1))
    theta = torch.atan2(cn, (v1 * v2).sum(dim=-1))
    inv = 1.0 / torch.clamp(cn, min=1e-30)
    g1 = (inv / (v1 * v1).sum(dim=-1))[:, None] * torch.linalg.cross(v1, c)
    g2 = -(inv / (v2 * v2).sum(dim=-1))[:, None] * torch.linalg.cross(v2, c)
    return theta, g1, g2


def dihedral_gradient(r1, r2, r3, r4, box):
    """(phi, dphi/dr (m, 4, 3)) of the dihedrals r1-r2-r3-r4 (Blondel &
    Karplus 1996, written in b1 = r2 - r1, b2 = r3 - r2, b3 = r4 - r3)."""
    b1 = geom.delta(r2, r1, box)
    b2 = geom.delta(r3, r2, box)
    b3 = geom.delta(r4, r3, box)
    n1 = torch.linalg.cross(b1, b2)
    n2 = torch.linalg.cross(b2, b3)
    b2sq = (b2 * b2).sum(dim=-1)
    b2n = torch.sqrt(b2sq)
    x = (n1 * n2).sum(dim=-1)
    y = (torch.linalg.cross(n1, n2) * (b2 / b2n[:, None])).sum(dim=-1)
    phi = torch.atan2(y, x)
    g1 = -(b2n / (n1 * n1).sum(dim=-1))[:, None] * n1
    g4 = (b2n / (n2 * n2).sum(dim=-1))[:, None] * n2
    s = ((b1 * b2).sum(dim=-1) / b2sq)[:, None]
    t = ((b3 * b2).sum(dim=-1) / b2sq)[:, None]
    g2 = -g1 - s * g1 + t * g4
    g3 = s * g1 - t * g4 - g4
    return phi, torch.stack([g1, g2, g3, g4], dim=1)


def _dihedral_gradient(pos, quad, box):
    """(phi, dphi/dr (m, 4, 3)) of the dihedrals quad."""
    return dihedral_gradient(*(pos[quad[:, a]] for a in range(4)), box)


def torsion_energy(pos, idx, periodicity, phase, k, box=None):
    """E = sum k (1 + cos(n phi - phase))."""
    phi = _dihedral(pos, idx, box)
    return (k * (1.0 + torch.cos(periodicity * phi - phase))).sum()


def torsion_ef(pos, idx, periodicity, phase, k, box=None):
    """(energy, forces (m, 4, 3))."""
    phi, grad = _dihedral_gradient(pos, idx, box)
    arg = periodicity * phi - phase
    de = -k * periodicity * torch.sin(arg)
    return (k * (1.0 + torch.cos(arg))).sum(), -de[:, None, None] * grad


def _rb_poly(c, cpsi):
    """sum_n C_n cpsi^n and its derivative in cpsi, by Horner."""
    e = c[:, 5]
    de = 5.0 * c[:, 5]
    for n in (4, 3, 2, 1, 0):
        e = e * cpsi + c[:, n]
        if n > 0:
            de = de * cpsi + n * c[:, n]
    return e, de


def rb_energy(pos, idx, c, box=None):
    """E = sum_n C_n cos(psi)^n with psi = phi - pi."""
    phi = _dihedral(pos, idx, box)
    return _rb_poly(c, torch.cos(phi - math.pi))[0].sum()


def rb_ef(pos, idx, c, box=None):
    """(energy, forces (m, 4, 3)); d cos(phi - pi)/dphi = sin(phi)."""
    phi, grad = _dihedral_gradient(pos, idx, box)
    e, de_dc = _rb_poly(c, torch.cos(phi - math.pi))
    de = de_dc * torch.sin(phi)
    return e.sum(), -de[:, None, None] * grad


def _cmap_cell(angle, size):
    two_pi = 2.0 * math.pi
    angle = torch.remainder(angle + two_pi, two_pi)
    delta = two_pi / size
    cell = torch.clamp(torch.floor(angle / delta), max=size - 1)
    return cell.to(torch.int64), angle / delta - cell, delta


def _cmap_patch(coeffs, maps, phi, psi):
    """The bicubic patch of each torsion: (coefficients (m, 4, 4), da, db,
    cell width); coeffs is (maps, size, size, 4, 4)."""
    size = coeffs.shape[1]
    s, da, delta = _cmap_cell(phi, size)
    t, db, _ = _cmap_cell(psi, size)
    return coeffs[maps, s, t], da, db, delta


def _powers(x):
    one = torch.ones_like(x)
    return torch.stack([one, x, x * x, x * x * x], dim=-1)


def cmap_energy(pos, maps, idx, coeffs, box=None):
    """E = sum over torsions of the bicubic map at (phi, psi); idx (m, 8)
    holds the two dihedrals' atoms."""
    phi = _dihedral(pos, idx[:, :4], box)
    psi = _dihedral(pos, idx[:, 4:], box)
    c, da, db, _ = _cmap_patch(coeffs, maps, phi, psi)
    return torch.einsum("ta,tab,tb->t", _powers(da), c, _powers(db)).sum()


def cmap_ef(pos, maps, idx, coeffs, box=None):
    """(energy, forces (m, 8, 3))."""
    phi, g_phi = _dihedral_gradient(pos, idx[:, :4], box)
    psi, g_psi = _dihedral_gradient(pos, idx[:, 4:], box)
    c, da, db, delta = _cmap_patch(coeffs, maps, phi, psi)
    pa, pb = _powers(da), _powers(db)
    zero = torch.zeros_like(da)
    dpa = torch.stack([zero, torch.ones_like(da), 2.0 * da,
                       3.0 * da * da], dim=-1)
    dpb = torch.stack([zero, torch.ones_like(db), 2.0 * db,
                       3.0 * db * db], dim=-1)
    e = torch.einsum("ta,tab,tb->t", pa, c, pb)
    de_phi = torch.einsum("ta,tab,tb->t", dpa, c, pb) / delta
    de_psi = torch.einsum("ta,tab,tb->t", pa, c, dpb) / delta
    forces = torch.cat([-de_phi[:, None, None] * g_phi,
                        -de_psi[:, None, None] * g_psi], dim=1)
    return e.sum(), forces


# -- the compiled force ----------------------------------------------------
class BondedModule(nn.Module):
    """One bonded force on one device, in float64: ef(pos, box) ->
    (energy, forces (n, 3)) and energy(pos, box) -> energy. `args` are
    the term tensors the force's functions take after the positions."""

    def __init__(self, force, n_atoms, idx, args, ef_fn, energy_fn, device):
        super().__init__()
        self.name = force.getName()
        self.group = force.getForceGroup()
        self.periodic = force.usesPeriodicBoundaryConditions()
        self.n = n_atoms
        self._ef_fn, self._energy_fn = ef_fn, energy_fn
        idx = np.asarray(idx, np.int64)
        self.empty = idx.shape[0] == 0
        self.args = [torch.as_tensor(a, device=device,
                                     dtype=torch.int64 if np.asarray(a).dtype
                                     .kind in "iu" else F64)
                     for a in args]
        self.gather = GatherSum(idx, n_atoms, device)

    def _box(self, box):
        return box.to(F64) if self.periodic else None

    def ef(self, pos, box):
        pos = pos.to(F64)
        if self.empty:
            return pos.new_zeros(()), torch.zeros_like(pos)
        e, contrib = self._ef_fn(pos, *self.args, box=self._box(box))
        return e, self.gather(contrib)

    def energy(self, pos, box):
        pos = pos.to(F64)
        if self.empty:
            return pos.new_zeros(())
        return self._energy_fn(pos, *self.args, box=self._box(box))

    def update(self, force) -> None:
        """updateParametersInContext: the force's current parameters
        written into the term tensors in place; raises when its terms'
        count or particles changed."""
        fresh = force._compile(self.n, "cpu")
        for old, new in zip(self.args, fresh.args):
            if old.shape != new.shape or (
                    old.dtype == torch.int64
                    and not torch.equal(old.cpu(), new)):
                raise ValueError("updateParametersInContext: the number of "
                                 "terms of %s or their particles have "
                                 "changed" % self.name)
        for old, new in zip(self.args, fresh.args):
            if old.dtype != torch.int64:
                old.copy_(new)


class HarmonicBondForce(_PeriodicMixin, Force):
    """E = (k/2)(r - r0)^2."""

    def __init__(self):
        super().__init__()
        self._bonds = []        # (p1, p2, length nm, k kJ/mol/nm^2)
        self._periodic = False

    def getNumBonds(self) -> int:
        return len(self._bonds)

    def addBond(self, particle1, particle2, length, k) -> int:
        self._bonds.append((int(particle1), int(particle2),
                            float(u.strip(length, _NM)),
                            float(u.strip(k, _E_PER_NM2))))
        return len(self._bonds) - 1

    def getBondParameters(self, index):
        return self._bonds[index]

    def setBondParameters(self, index, particle1, particle2, length, k):
        self._bonds[index] = (int(particle1), int(particle2),
                              float(u.strip(length, _NM)),
                              float(u.strip(k, _E_PER_NM2)))

    def _bonded_particles(self):
        return [(b[0], b[1]) for b in self._bonds]

    def _compile(self, n_atoms, device) -> BondedModule:
        arr = np.asarray(self._bonds, np.float64).reshape(-1, 4)
        idx = arr[:, :2].astype(np.int64)
        return BondedModule(self, n_atoms, idx, (idx, arr[:, 2], arr[:, 3]),
                            bond_ef, bond_energy, device)


class HarmonicAngleForce(_PeriodicMixin, Force):
    """E = (k/2)(theta - theta0)^2."""

    def __init__(self):
        super().__init__()
        self._angles = []       # (p1, p2, p3, angle rad, k kJ/mol/rad^2)
        self._periodic = False

    def getNumAngles(self) -> int:
        return len(self._angles)

    def addAngle(self, particle1, particle2, particle3, angle, k) -> int:
        self._angles.append((int(particle1), int(particle2), int(particle3),
                             float(u.strip(angle, _RAD)),
                             float(u.strip(k, _E_PER_RAD2))))
        return len(self._angles) - 1

    def getAngleParameters(self, index):
        return self._angles[index]

    def setAngleParameters(self, index, particle1, particle2, particle3,
                           angle, k):
        self._angles[index] = (int(particle1), int(particle2),
                               int(particle3), float(u.strip(angle, _RAD)),
                               float(u.strip(k, _E_PER_RAD2)))

    def _bonded_particles(self):
        return ([(a[0], a[1]) for a in self._angles]
                + [(a[1], a[2]) for a in self._angles])

    def _compile(self, n_atoms, device) -> BondedModule:
        arr = np.asarray(self._angles, np.float64).reshape(-1, 5)
        idx = arr[:, :3].astype(np.int64)
        return BondedModule(self, n_atoms, idx, (idx, arr[:, 3], arr[:, 4]),
                            angle_ef, angle_energy, device)


class PeriodicTorsionForce(_PeriodicMixin, Force):
    """E = k (1 + cos(n phi - phase))."""

    def __init__(self):
        super().__init__()
        # (p1, p2, p3, p4, periodicity, phase rad, k kJ/mol)
        self._torsions = []
        self._periodic = False

    def getNumTorsions(self) -> int:
        return len(self._torsions)

    def addTorsion(self, particle1, particle2, particle3, particle4,
                   periodicity, phase, k) -> int:
        self._torsions.append((int(particle1), int(particle2),
                               int(particle3), int(particle4),
                               int(periodicity), float(u.strip(phase, _RAD)),
                               float(u.strip(k, _E))))
        return len(self._torsions) - 1

    def getTorsionParameters(self, index):
        return self._torsions[index]

    def setTorsionParameters(self, index, particle1, particle2, particle3,
                             particle4, periodicity, phase, k):
        self._torsions[index] = (int(particle1), int(particle2),
                                 int(particle3), int(particle4),
                                 int(periodicity),
                                 float(u.strip(phase, _RAD)),
                                 float(u.strip(k, _E)))

    def _bonded_particles(self):
        return [pair for t in self._torsions
                for pair in ((t[0], t[1]), (t[1], t[2]), (t[2], t[3]))]

    def _compile(self, n_atoms, device) -> BondedModule:
        arr = np.asarray(self._torsions, np.float64).reshape(-1, 7)
        idx = arr[:, :4].astype(np.int64)
        return BondedModule(self, n_atoms, idx,
                            (idx, arr[:, 4], arr[:, 5], arr[:, 6]),
                            torsion_ef, torsion_energy, device)


class RBTorsionForce(_PeriodicMixin, Force):
    """Ryckaert-Bellemans: E = sum_n C_n cos(psi)^n, psi = phi - pi."""

    def __init__(self):
        super().__init__()
        self._torsions = []     # (p1, p2, p3, p4, c0, ..., c5)
        self._periodic = False

    def getNumTorsions(self) -> int:
        return len(self._torsions)

    def addTorsion(self, particle1, particle2, particle3, particle4,
                   c0, c1, c2, c3, c4, c5) -> int:
        self._torsions.append((int(particle1), int(particle2),
                               int(particle3), int(particle4),
                               *(float(u.strip(c, _E))
                                 for c in (c0, c1, c2, c3, c4, c5))))
        return len(self._torsions) - 1

    def getTorsionParameters(self, index):
        return self._torsions[index]

    def setTorsionParameters(self, index, particle1, particle2, particle3,
                             particle4, c0, c1, c2, c3, c4, c5):
        self._torsions[index] = (int(particle1), int(particle2),
                                 int(particle3), int(particle4),
                                 *(float(u.strip(c, _E))
                                   for c in (c0, c1, c2, c3, c4, c5)))

    def _bonded_particles(self):
        return [pair for t in self._torsions
                for pair in ((t[0], t[1]), (t[1], t[2]), (t[2], t[3]))]

    def _compile(self, n_atoms, device) -> BondedModule:
        arr = np.asarray(self._torsions, np.float64).reshape(-1, 10)
        idx = arr[:, :4].astype(np.int64)
        return BondedModule(self, n_atoms, idx, (idx, arr[:, 4:10]), rb_ef,
                            rb_energy, device)


class CMAPTorsionForce(_PeriodicMixin, Force):
    """A bicubic energy map over pairs of dihedrals (CMAPTorsionForce.h:
    element energy[i + size * j] of a map is E at angle1 = i 2pi/size,
    angle2 = j 2pi/size)."""

    def __init__(self):
        super().__init__()
        self._maps = []         # (size, energy list)
        self._torsions = []     # (map, a1, a2, a3, a4, b1, b2, b3, b4)
        self._periodic = False

    def getNumMaps(self) -> int:
        return len(self._maps)

    def getNumTorsions(self) -> int:
        return len(self._torsions)

    def addMap(self, size, energy) -> int:
        energy = [float(u.strip(e, _E)) for e in energy]
        if len(energy) != size * size:
            raise ValueError("CMAP energy array must have size*size "
                             "elements")
        self._maps.append((int(size), energy))
        return len(self._maps) - 1

    def getMapParameters(self, index):
        return self._maps[index]

    def addTorsion(self, map, a1, a2, a3, a4, b1, b2, b3, b4) -> int:  # noqa: A002
        self._torsions.append(tuple(int(x) for x in
                                    (map, a1, a2, a3, a4, b1, b2, b3, b4)))
        return len(self._torsions) - 1

    def getTorsionParameters(self, index):
        return self._torsions[index]

    def _bonded_particles(self):
        return [pair for t in self._torsions
                for pair in ((t[1], t[2]), (t[2], t[3]), (t[3], t[4]),
                             (t[5], t[6]), (t[6], t[7]), (t[7], t[8]))]

    def _compile(self, n_atoms, device) -> BondedModule:
        arr = np.asarray(self._torsions, np.int64).reshape(-1, 9)
        sizes = {s for s, _ in self._maps}
        if len(sizes) > 1:
            raise NotImplementedError("CMAP maps of differing sizes")
        size = sizes.pop() if sizes else 1
        coeffs = (np.stack([bicubic_coefficients_periodic(
            np.asarray(e, np.float64).reshape(size, size, order="F"))
            for _, e in self._maps]) if self._maps
            else np.zeros((1, 1, 1, 4, 4)))
        return BondedModule(self, n_atoms, arr[:, 1:],
                            (arr[:, 0], arr[:, 1:], coeffs), cmap_ef,
                            cmap_energy, device)


BONDED_FORCES = (HarmonicBondForce, HarmonicAngleForce, PeriodicTorsionForce,
                 RBTorsionForce, CMAPTorsionForce)
