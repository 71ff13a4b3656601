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
package and the reference. The sites are computed family by family in the
JAX updater's order (two-particle averages, three-particle averages,
out-of-plane, local coordinates: openmm_tpu/ops/vsites.py:81-111), so a
site may have a site of an earlier family among its parents; the forces
are spread family by family in the reverse order, so a site's share
reaches the parents of its parent site. A parent site of the same or a
later family, which the JAX order reads before it is computed, raises.
"""
from __future__ import annotations

import numpy as np
import torch

from ..system import (LocalCoordinatesSite, OutOfPlaneSite,
                      ThreeParticleAverageSite, TwoParticleAverageSite)
from .accumulate import GatherSum


# the JAX updater's order of the site families
FAMILIES = (TwoParticleAverageSite, ThreeParticleAverageSite,
            OutOfPlaneSite, LocalCoordinatesSite)


class VirtualSites:
    """The virtual sites of a System on one device, in float64.

    compute(pos) -> pos with every site's row set from its parents, family
    by family in the JAX updater's order; distribute(pos, forces) ->
    forces with each site's force moved onto its parents and the site's
    row zero, family by family in the reverse order."""

    def __init__(self, system, device):
        n = system.getNumParticles()
        f64 = dict(dtype=torch.float64, device=device)
        members = [[] for _ in FAMILIES]
        family_of = {}
        for index, site in sorted(system._vsites.items()):
            if not 0 <= index < n:
                raise ValueError("virtual site %d out of range" % index)
            kinds = [k for k, cls in enumerate(FAMILIES)
                     if type(site) is cls]
            if not kinds:
                raise TypeError("unknown virtual site type: %r" % (site,))
            members[kinds[0]].append((index, site))
            family_of[index] = kinds[0]
        for index, site in sorted(system._vsites.items()):
            late = [p for p in site._particles
                    if family_of.get(p, -1) >= family_of[index]]
            if late:
                raise NotImplementedError(
                    "virtual site %d has the virtual site %d among its "
                    "parents, which the JAX package's order computes after "
                    "it (two-particle averages, three-particle averages, "
                    "out-of-plane, local coordinates)" % (index, late[0]))
        self.sites = torch.as_tensor(sorted(system._vsites), device=device)
        self._families = []
        for kind, sites in enumerate(members):
            if not sites:
                continue
            rows = torch.as_tensor([i for i, _ in sites], device=device)
            if kind <= 1:
                parents = np.asarray([s._particles for _, s in sites],
                                     np.int64)
                data = (torch.as_tensor([s.weights for _, s in sites],
                                        **f64),)
            elif kind == 2:
                parents = np.asarray([s._particles for _, s in sites],
                                     np.int64)
                data = (torch.as_tensor([(s.weight12, s.weight13,
                                          s.weightCross) for _, s in sites],
                                        **f64),)
            else:
                width = max(len(s._particles) for _, s in sites)
                parents = np.zeros((len(sites), width), np.int64)
                w = np.zeros((len(sites), 3, width))
                frame = np.zeros((len(sites), 3))
                for r, (_, s) in enumerate(sites):
                    k = len(s._particles)
                    parents[r, :k] = s._particles
                    parents[r, k:] = s._particles[0]
                    w[r, 0, :k] = s.originWeights
                    w[r, 1, :k] = s.xWeights
                    w[r, 2, :k] = s.yWeights
                    frame[r] = s.localPosition
                data = (torch.as_tensor(w, **f64),
                        torch.as_tensor(frame, **f64))
            is_site = torch.zeros((n, 1), dtype=torch.bool, device=device)
            is_site[rows] = True
            self._families.append(
                (kind, rows, torch.as_tensor(parents, device=device), data,
                 GatherSum(parents, n, device), is_site))

    # -- positions ------------------------------------------------------------
    def compute(self, pos: torch.Tensor) -> torch.Tensor:
        """pos with every site's row computed from its parents' rows."""
        for kind, sites, parents, data, _, _ in self._families:
            if kind <= 1:
                new = (pos[parents] * data[0].to(pos.dtype)[:, :, None]).sum(
                    dim=1)
            elif kind == 2:
                w = data[0].to(pos.dtype)
                p1 = pos[parents[:, 0]]
                r12 = pos[parents[:, 1]] - p1
                r13 = pos[parents[:, 2]] - p1
                new = (p1 + w[:, 0:1] * r12 + w[:, 1:2] * r13
                       + w[:, 2:3] * torch.linalg.cross(r12, r13))
            else:
                new = self._local_frame(pos[parents], data[0].to(pos.dtype),
                                        data[1].to(pos.dtype))[0]
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
        distributeForces) and the sites' rows zero, the last family first:
        a share that lands on a site of an earlier family moves on with
        that family's."""
        for kind, sites, parents, data, gather, is_site in reversed(
                self._families):
            f = forces[sites]
            share = self._shares(kind, pos, f, parents, data)
            forces = torch.where(is_site, 0.0, forces) + gather(share)
        return forces

    def _shares(self, kind, pos, f, parents, data):
        """(sites, parents, 3) shares of the site forces f."""
        if kind <= 1:
            return data[0].to(f.dtype)[:, :, None] * f[:, None, :]
        if kind == 2:
            w = data[0].to(f.dtype)
            p1 = pos[parents[:, 0]].to(f.dtype)
            r12 = pos[parents[:, 1]].to(f.dtype) - p1
            r13 = pos[parents[:, 2]].to(f.dtype) - p1
            f2 = w[:, 0:1] * f + w[:, 2:3] * torch.linalg.cross(r13, f)
            f3 = w[:, 1:2] * f + w[:, 2:3] * torch.linalg.cross(f, r12)
            return torch.stack([f - f2 - f3, f2, f3], dim=1)
        w, frame = data[0].to(f.dtype), data[1].to(f.dtype)
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
        return (w[:, 0, :, None] * f[:, None, :]
                + w[:, 1, :, None] * g_xdir[:, None, :]
                + w[:, 2, :, None] * g_ydir[:, None, :])
