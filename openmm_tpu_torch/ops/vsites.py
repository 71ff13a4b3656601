"""Virtual sites: their positions from their parents, and their forces
spread onto the parents.

Counterpart of openmm_tpu/ops/vsites.py (make_vsite_updater) and of the
reference's ReferenceVirtualSites::computePositions / distributeForces.
The JAX package gets the redistribution from jax.grad, by differentiating
energies composed with the position update; the port's MD step takes
analytic forces and no autograd, so the chain rule is written out here for
each of the four site types. Each parent's share of every site force is
added by gathers in a fixed order (ops/accumulate.py), so the step keeps
its bits from run to run. The minimizer composes its objective with
`compute` and lets autograd apply the same chain rule.

The parents are taken as they are, without minimum images, as in the JAX
package and the reference. A site whose parent is itself a site is not in
this slice of the port (the JAX package handles it through autograd).
"""
from __future__ import annotations

import numpy as np
import torch

from ..system import (LocalCoordinatesSite, OutOfPlaneSite,
                      ThreeParticleAverageSite, TwoParticleAverageSite)
from .accumulate import GatherSum


class VirtualSites:
    """The virtual sites of a System on one device, in float64.

    compute(pos) -> pos with every site's row set from its parents (the
    averages, the out-of-plane sites, then the local-coordinate sites, as
    the JAX updater orders them); distribute(pos, forces) -> forces with
    each site's force moved onto its parents and the site's row zero."""

    def __init__(self, system, device):
        n = system.getNumParticles()
        f64 = dict(dtype=torch.float64, device=device)
        average, oop, local = [], [], []
        for index, site in sorted(system._vsites.items()):
            if not 0 <= index < n:
                raise ValueError("virtual site %d out of range" % index)
            if isinstance(site, (TwoParticleAverageSite,
                                 ThreeParticleAverageSite)):
                average.append((index, site._particles, site.weights))
            elif isinstance(site, OutOfPlaneSite):
                oop.append((index, site._particles,
                            (site.weight12, site.weight13,
                             site.weightCross)))
            elif isinstance(site, LocalCoordinatesSite):
                local.append((index, site))
            else:
                raise TypeError("unknown virtual site type: %r" % (site,))
        for index, site in sorted(system._vsites.items()):
            if any(p in system._vsites for p in site._particles):
                raise NotImplementedError(
                    "virtual site %d has a virtual site among its parents: "
                    "not in this slice of the port" % index)
        self.sites = torch.as_tensor(sorted(system._vsites), device=device)
        # parent slots of every site, in the order distribute adds them
        slots = []
        self._average = None
        if average:
            width = max(len(p) for _, p, _ in average)
            parents = np.zeros((len(average), width), np.int64)
            weights = np.zeros((len(average), width))
            for r, (_, p, w) in enumerate(average):
                parents[r, :len(p)] = p
                parents[r, len(p):] = p[0]
                weights[r, :len(w)] = w
            self._average = (
                torch.as_tensor([a[0] for a in average], device=device),
                torch.as_tensor(parents, device=device),
                torch.as_tensor(weights, **f64))
            slots.append(parents)
        self._oop = None
        if oop:
            parents = np.asarray([p for _, p, _ in oop], np.int64)
            self._oop = (
                torch.as_tensor([o[0] for o in oop], device=device),
                torch.as_tensor(parents, device=device),
                torch.as_tensor([w for _, _, w in oop], **f64))
            slots.append(parents)
        self._local = None
        if local:
            width = max(len(s._particles) for _, s in local)
            parents = np.zeros((len(local), width), np.int64)
            w = np.zeros((len(local), 3, width))
            frame = np.zeros((len(local), 3))
            for r, (_, s) in enumerate(local):
                k = len(s._particles)
                parents[r, :k] = s._particles
                parents[r, k:] = s._particles[0]
                w[r, 0, :k] = s.originWeights
                w[r, 1, :k] = s.xWeights
                w[r, 2, :k] = s.yWeights
                frame[r] = s.localPosition
            self._local = (
                torch.as_tensor([x[0] for x in local], device=device),
                torch.as_tensor(parents, device=device),
                torch.as_tensor(w, **f64), torch.as_tensor(frame, **f64))
            slots.append(parents)
        width = max(s.shape[1] for s in slots)
        self._gather = GatherSum(np.concatenate(
            [np.pad(s, ((0, 0), (0, width - s.shape[1])), mode="edge")
             for s in slots]), n, device)
        self._width = width
        self.is_site = torch.zeros((n, 1), dtype=torch.bool, device=device)
        self.is_site[self.sites] = True

    # -- positions ------------------------------------------------------------
    def compute(self, pos: torch.Tensor) -> torch.Tensor:
        """pos with every site's row computed from its parents' rows."""
        if self._average is not None:
            sites, parents, w = self._average
            new = (pos[parents] * w.to(pos.dtype)[:, :, None]).sum(dim=1)
            pos = pos.index_copy(0, sites, new)
        if self._oop is not None:
            sites, parents, w = self._oop
            w = w.to(pos.dtype)
            p1 = pos[parents[:, 0]]
            r12 = pos[parents[:, 1]] - p1
            r13 = pos[parents[:, 2]] - p1
            new = (p1 + w[:, 0:1] * r12 + w[:, 1:2] * r13
                   + w[:, 2:3] * torch.linalg.cross(r12, r13))
            pos = pos.index_copy(0, sites, new)
        if self._local is not None:
            sites, parents, w, frame = self._local
            new = self._local_frame(pos[parents], w.to(pos.dtype),
                                    frame.to(pos.dtype))[0]
            pos = pos.index_copy(0, sites, new)
        return pos

    @staticmethod
    def _local_frame(p, w, frame):
        """(site positions, x direction, y direction, xhat, zhat, |x dir|,
        |z dir|) of local-coordinate sites from their parents p (m, k, 3)."""
        origin = (p * w[:, 0, :, None]).sum(dim=1)
        xdir = (p * w[:, 1, :, None]).sum(dim=1)
        ydir = (p * w[:, 2, :, None]).sum(dim=1)
        zdir = torch.linalg.cross(xdir, ydir)
        xlen = torch.linalg.norm(xdir, dim=-1, keepdim=True)
        zlen = torch.linalg.norm(zdir, dim=-1, keepdim=True)
        xhat = xdir / xlen
        zhat = zdir / zlen
        yhat = torch.linalg.cross(zhat, xhat)
        new = (origin + frame[:, 0:1] * xhat + frame[:, 1:2] * yhat
               + frame[:, 2:3] * zhat)
        return new, xdir, ydir, xhat, zhat, xlen, zlen

    # -- forces ---------------------------------------------------------------
    def distribute(self, pos: torch.Tensor,
                   forces: torch.Tensor) -> torch.Tensor:
        """forces with each site's force spread onto its parents (the
        transpose of the Jacobian of compute: ReferenceVirtualSites::
        distributeForces) and the sites' rows zero."""
        shares = []
        if self._average is not None:
            sites, parents, w = self._average
            f = forces[sites]
            shares.append(w.to(f.dtype)[:, :, None] * f[:, None, :])
        if self._oop is not None:
            sites, parents, w = self._oop
            w = w.to(forces.dtype)
            f = forces[sites]
            p1 = pos[parents[:, 0]].to(f.dtype)
            r12 = pos[parents[:, 1]].to(f.dtype) - p1
            r13 = pos[parents[:, 2]].to(f.dtype) - p1
            f2 = w[:, 0:1] * f + w[:, 2:3] * torch.linalg.cross(r13, f)
            f3 = w[:, 1:2] * f + w[:, 2:3] * torch.linalg.cross(f, r12)
            shares.append(torch.stack([f - f2 - f3, f2, f3], dim=1))
        if self._local is not None:
            sites, parents, w, frame = self._local
            w, frame = w.to(forces.dtype), frame.to(forces.dtype)
            f = forces[sites]
            _, xdir, ydir, xhat, zhat, xlen, zlen = self._local_frame(
                pos[parents].to(f.dtype), w, frame)
            a, b, c = frame[:, 0:1], frame[:, 1:2], frame[:, 2:3]
            # s = f . (a xhat + b (zhat x xhat) + c zhat): its gradients
            # in xhat and zhat, through the normalizations, then through
            # zdir = xdir x ydir
            g_x = a * f + b * torch.linalg.cross(f, zhat)
            g_z = b * torch.linalg.cross(xhat, f) + c * f
            g_zdir = (g_z - zhat * (zhat * g_z).sum(-1, keepdim=True)) / zlen
            g_xdir = ((g_x - xhat * (xhat * g_x).sum(-1, keepdim=True))
                      / xlen + torch.linalg.cross(ydir, g_zdir))
            g_ydir = torch.linalg.cross(g_zdir, xdir)
            shares.append(w[:, 0, :, None] * f[:, None, :]
                          + w[:, 1, :, None] * g_xdir[:, None, :]
                          + w[:, 2, :, None] * g_ydir[:, None, :])
        width = self._width
        shares = torch.cat([torch.nn.functional.pad(
            s, (0, 0, 0, width - s.shape[1])) for s in shares])
        moved = self._gather(shares)
        return torch.where(self.is_site, 0.0, forces) + moved
