"""RMSDForce: the root-mean-square deviation of particles from a reference
structure after the optimal superposition, as an energy.

Counterpart of openmm_tpu/forces/rmsd.py (RMSDForce.h). Both centre the
particles and the reference, build the correlation R = x^T y and the
quaternion key matrix F(R) (Kearsley's; OpenMM's rmsd.cc), whose largest
eigenvalue lambda gives msd = (sum x^2 + sum y^2 - 2 lambda) / m and
RMSD = sqrt(msd + 1e-30) (the JAX package's guard). The JAX package
takes lambda from jnp.linalg.eigvalsh and the forces from jax.grad
through it. The step here is a captured CUDA graph, and
torch.linalg.eigh checks its result on the host (a read that a capture
forbids), so lambda is the largest root of F's characteristic polynomial
lambda^4 + e2 lambda^2 - e3 lambda + e4 (F is traceless; e2, e3, e4 from
the traces of F^2, F^3, F^4), found by Newton's method from the bound
(sum x^2 + sum y^2) / 2 above it, where it converges from above
(Theobald's QCP, 2005), a fixed NEWTON_STEPS times. The forces are the
closed form: dlambda/dR = U, the optimal rotation, from the adjugate of
F - lambda I (rank one, proportional to q q^T for the top eigenvector q:
U_ab = q^T F(E_ab) q), so dRMSD/dx_i = (x_i - U y_i) / (m RMSD); the
centring drops out (both sums of x_i - U y_i vanish). Per-particle forces
go through a gather table (ops/accumulate.py). float64 throughout.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import unit as u
from ..ops.accumulate import GatherSum
from ..ops.pairs import AnalyticEnergy
from ..vec3 import Vec3
from .base import Force

F64 = torch.float64
NEWTON_STEPS = 30


def _key_basis() -> np.ndarray:
    """(3, 3, 4, 4): F(R) = sum_ab R_ab basis[a, b] (the key matrix of
    openmm_tpu/forces/rmsd.py)."""
    basis = np.zeros((3, 3, 4, 4))
    entries = {
        (0, 0): [(0, 0, 1), (1, 1, 1), (2, 2, -1), (3, 3, -1)],
        (1, 1): [(0, 0, 1), (1, 1, -1), (2, 2, 1), (3, 3, -1)],
        (2, 2): [(0, 0, 1), (1, 1, -1), (2, 2, -1), (3, 3, 1)],
        (1, 2): [(0, 1, 1), (1, 0, 1), (2, 3, 1), (3, 2, 1)],
        (2, 1): [(0, 1, -1), (1, 0, -1), (2, 3, 1), (3, 2, 1)],
        (2, 0): [(0, 2, 1), (2, 0, 1), (1, 3, 1), (3, 1, 1)],
        (0, 2): [(0, 2, -1), (2, 0, -1), (1, 3, 1), (3, 1, 1)],
        (0, 1): [(0, 3, 1), (3, 0, 1), (1, 2, 1), (2, 1, 1)],
        (1, 0): [(0, 3, -1), (3, 0, -1), (1, 2, 1), (2, 1, 1)],
    }
    for (a, b), cells in entries.items():
        for i, j, v in cells:
            basis[a, b, i, j] = v
    return basis


def _minor_index() -> tuple:
    """Row and column indices (4, 4, 3) of each entry's 3 x 3 minor, and
    the cofactor signs (4, 4)."""
    rows = np.asarray([[[k for k in range(4) if k != i]] * 4
                       for i in range(4)])
    cols = np.asarray([[[k for k in range(4) if k != j] for j in range(4)]
                       for _ in range(4)])
    signs = np.asarray([[(-1.0) ** (i + j) for j in range(4)]
                        for i in range(4)])
    return rows, cols, signs


def _det3(m):
    """Determinants of (..., 3, 3)."""
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2]
                            - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2]
                              - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1]
                              - m[..., 1, 1] * m[..., 2, 0]))


class RMSDForce(Force):
    def __init__(self, referencePositions, particles=()):
        super().__init__()
        self.setReferencePositions(referencePositions)
        self._particles = [int(p) for p in particles]

    def getReferencePositions(self):
        return u.Quantity([Vec3(*r) for r in self._ref.tolist()],
                          u.nanometer)

    def setReferencePositions(self, positions) -> None:
        self._ref = np.array(u.strip(positions, u.nanometer),
                             np.float64).reshape(-1, 3)

    def getParticles(self):
        return list(self._particles)

    def setParticles(self, particles) -> None:
        self._particles = [int(p) for p in particles]

    def updateParametersInContext(self, context) -> None:
        context._update_force_parameters(self)

    def _centred_reference(self, n) -> np.ndarray:
        particles = self._particles or list(range(n))
        ref = self._ref[np.asarray(particles)]
        return ref - ref.mean(axis=0)

    def _compile(self, ctx):
        return RMSDModule(self, ctx)


class RMSDModule(nn.Module):
    """The compiled RMSDForce: ef (its energy is the RMSD), energy and
    parameter_derivatives (none), as forces/custom.py's CustomModule has
    them."""

    def __init__(self, force, ctx):
        super().__init__()
        self.name = force.getName()
        self.group = force.getForceGroup()
        self.derivs = ()
        n = ctx._n
        dev = ctx._device
        particles = force._particles or list(range(n))
        self.n = n
        self.m = len(particles)
        self.register_buffer("idx", torch.as_tensor(particles, device=dev))
        self.register_buffer("ref", torch.as_tensor(
            force._centred_reference(n), dtype=F64, device=dev))
        self.register_buffer("basis", torch.as_tensor(_key_basis(),
                                                      dtype=F64, device=dev))
        rows, cols, signs = _minor_index()
        self.register_buffer("minor_rows", torch.as_tensor(rows, device=dev))
        self.register_buffer("minor_cols", torch.as_tensor(cols, device=dev))
        self.register_buffer("signs", torch.as_tensor(signs, dtype=F64,
                                                      device=dev))
        self.gather = GatherSum(np.asarray(particles)[:, None], n, dev)

    def update(self, force) -> None:
        particles = force._particles or list(range(self.n))
        if len(particles) != self.m or not np.array_equal(
                particles, self.idx.cpu().numpy()):
            raise ValueError("updateParametersInContext: the particles of "
                             "the RMSDForce have changed")
        self.ref.copy_(torch.as_tensor(force._centred_reference(self.n),
                                       dtype=F64))

    def _top(self, x):
        """(lambda, U) of centred positions x: the largest eigenvalue of
        the key matrix and dlambda/dR."""
        y = self.ref
        corr = x.T @ y
        key = torch.einsum("ab,abij->ij", corr, self.basis)
        k2 = key @ key
        p2 = torch.diagonal(k2).sum()
        p3 = torch.diagonal(k2 @ key).sum()
        p4 = (k2 * k2).sum()
        e2 = -0.5 * p2
        e3 = p3 / 3.0
        e4 = p2 * p2 / 8.0 - p4 / 4.0
        lam = 0.5 * ((x * x).sum() + (y * y).sum())
        for _ in range(NEWTON_STEPS):
            lam2 = lam * lam
            poly = lam2 * lam2 + e2 * lam2 - e3 * lam + e4
            slope = 4.0 * lam2 * lam + 2.0 * e2 * lam - e3
            lam = lam - torch.where(slope != 0, poly / slope, 0.0)
        shifted = key - lam * torch.eye(4, dtype=F64, device=x.device)
        minors = shifted[self.minor_rows[..., :, None],
                          self.minor_cols[..., None, :]]
        adj = (self.signs * _det3(minors)).T
        u = torch.einsum("ij,abij->ab", adj, self.basis) / torch.trace(adj)
        return lam, u

    def _compute(self, pos):
        """(RMSD, dRMSD/dx of the particles (m, 3)) at float64 positions."""
        x = pos[self.idx]
        x = x - x.mean(dim=0)
        lam, u = self._top(x)
        y = self.ref
        msd = ((x * x).sum() + (y * y).sum() - 2.0 * lam) / self.m
        positive = msd > 0
        msd = torch.where(positive, msd, 0.0)
        rmsd = torch.sqrt(msd + 1e-30)
        grad = torch.where(positive, 1.0 / (self.m * rmsd), 0.0) * (
            x - y @ u.T)
        return rmsd, grad

    def ef(self, pos, box):
        rmsd, grad = self._compute(pos.to(F64))
        return rmsd, self.gather(-grad[:, None, :])

    def energy(self, pos, box):
        return AnalyticEnergy.apply(self.ef, pos, box)

    def parameter_derivatives(self, pos, box) -> dict:
        return {}

