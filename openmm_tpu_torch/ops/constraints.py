"""Rigid-water constraints: cluster partition and SETTLE.

Counterpart of openmm_tpu/ops/constraints.py (partition_constraints,
make_settle). SETTLE is solved in float64 for every cluster at once and
returns a CORRECTION field c with constrained = proposed + c, exactly zero
off the clusters; integrators recover velocities from c alone (the JAX
package's round-5 drift fix: re-deriving velocities from rounded positions
injects an eps*|x|/dt kick every step). Constraints that are not SETTLE
triangles need CCMA, which this slice does not have yet.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


def partition_constraints(constraints, masses):
    """Split (i, j, d) constraints into SETTLE clusters (centre, h1, h2,
    d(centre, h), d(h, h)) and the remaining constraints."""
    n_cons = len(constraints)
    by_atom = {}
    for ci, (i, j, _) in enumerate(constraints):
        by_atom.setdefault(i, []).append(ci)
        by_atom.setdefault(j, []).append(ci)
    used = [False] * n_cons
    settle = []

    def partners(atom, skip):
        out = {}
        for c in by_atom.get(atom, []):
            if not used[c] and c != skip:
                a, b, _ = constraints[c]
                out[a if b == atom else b] = c
        return out

    for ci in range(n_cons):
        if used[ci]:
            continue
        i, j, d = constraints[ci]
        partners_i, partners_j = partners(i, ci), partners(j, ci)
        for k in sorted(set(partners_i) & set(partners_j)):
            c_ik, c_jk = partners_i[k], partners_j[k]
            tri = {tuple(sorted((i, j))): d,
                   tuple(sorted((i, k))): constraints[c_ik][2],
                   tuple(sorted((j, k))): constraints[c_jk][2]}

            def dist(a, b):
                return tri[tuple(sorted((a, b)))]

            if any(not used[c] and c not in (ci, c_ik, c_jk)
                   for a in (i, j, k) for c in by_atom.get(a, [])):
                continue
            placed = False
            for centre, o1, o2 in ((i, j, k), (j, i, k), (k, i, j)):
                if (abs(dist(centre, o1) - dist(centre, o2)) < 1e-10
                        and abs(masses[o1] - masses[o2]) < 1e-10
                        and masses[centre] > 0 and masses[o1] > 0):
                    settle.append((centre, o1, o2, dist(centre, o1),
                                   dist(o1, o2)))
                    used[ci] = used[c_ik] = used[c_jk] = True
                    placed = True
                    break
            if placed:
                break
    rest = [constraints[c] for c in range(n_cons) if not used[c]]
    return settle, rest


def _dot(a, b):
    return (a * b).sum(dim=-1)


def _unit(v):
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _solve3(a, b):
    """Batched 3x3 solve by the adjugate (no pivoting, no host sync)."""
    a00, a01, a02 = a[..., 0, 0], a[..., 0, 1], a[..., 0, 2]
    a10, a11, a12 = a[..., 1, 0], a[..., 1, 1], a[..., 1, 2]
    a20, a21, a22 = a[..., 2, 0], a[..., 2, 1], a[..., 2, 2]
    c00, c01, c02 = a11 * a22 - a12 * a21, a12 * a20 - a10 * a22, \
        a10 * a21 - a11 * a20
    c10, c11, c12 = a02 * a21 - a01 * a22, a00 * a22 - a02 * a20, \
        a01 * a20 - a00 * a21
    c20, c21, c22 = a01 * a12 - a02 * a11, a02 * a10 - a00 * a12, \
        a00 * a11 - a01 * a10
    inv_det = 1.0 / (a00 * c00 + a01 * c01 + a02 * c02)
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([(c00 * b0 + c10 * b1 + c20 * b2) * inv_det,
                        (c01 * b0 + c11 * b1 + c21 * b2) * inv_det,
                        (c02 * b0 + c12 * b1 + c22 * b2) * inv_det], dim=-1)


class Settle(nn.Module):
    """SETTLE (Miyamoto & Kollman 1992) over all clusters, in float64."""

    def __init__(self, clusters, masses, device):
        super().__init__()
        clusters = sorted(clusters, key=lambda c: c[0])
        idx = np.asarray([c[:3] for c in clusters], np.int64).reshape(-1, 3)
        m = np.asarray(masses, np.float64)
        f64 = dict(dtype=torch.float64, device=device)
        self.register_buffer("idx", torch.as_tensor(idx, device=device))
        self.register_buffer("m", torch.as_tensor(m[idx], **f64))
        self.register_buffer("d1", torch.as_tensor(
            [c[3] for c in clusters], **f64))
        self.register_buffer("d2", torch.as_tensor(
            [c[4] for c in clusters], **f64))

    def _triples(self, x):
        return x[self.idx[:, 0]], x[self.idx[:, 1]], x[self.idx[:, 2]]

    def _scatter(self, like, v0, v1, v2):
        out = torch.zeros_like(like)
        out[self.idx[:, 0]] = v0
        out[self.idx[:, 1]] = v1
        out[self.idx[:, 2]] = v2
        return out

    def position_corrections(self, ref, new):
        """Correction c (same dtype as `new`) with new + c satisfying the
        constraints; `ref` holds the constrained positions before the move."""
        f64 = torch.float64
        a0, a1, a2 = (t.to(f64) for t in self._triples(ref))
        p0, p1, p2 = (t.to(f64) for t in self._triples(new))
        m0, m1, m2 = self.m[:, 0:1], self.m[:, 1:2], self.m[:, 2:3]
        d1, d2 = self.d1, self.d2
        xp0, xp1, xp2 = p0 - a0, p1 - a1, p2 - a2
        b0, c0 = a1 - a0, a2 - a0
        inv_total = 1.0 / (m0 + m1 + m2)
        com = (xp0 * m0 + (b0 + xp1) * m1 + (c0 + xp2) * m2) * inv_total
        a1v, b1v, c1v = xp0 - com, b0 + xp1 - com, c0 + xp2 - com
        zd = torch.linalg.cross(b0, c0)
        xd = torch.linalg.cross(a1v, zd)
        yd = torch.linalg.cross(zd, xd)
        ex, ey, ez = _unit(xd), _unit(yd), _unit(zd)

        def frame(v):
            return _dot(v, ex), _dot(v, ey), _dot(v, ez)

        b0x, b0y, _ = frame(b0)
        c0x, c0y, _ = frame(c0)
        _, _, a1z = frame(a1v)
        b1x, b1y, b1z = frame(b1v)
        c1x, c1y, c1z = frame(c1v)

        rc = 0.5 * d2
        rb = torch.sqrt(d1 * d1 - rc * rc)
        ra = rb * (m1 + m2)[:, 0] * inv_total[:, 0]
        rb = rb - ra
        sinphi = a1z / ra
        cosphi = torch.sqrt(1.0 - sinphi * sinphi)
        sinpsi = (b1z - c1z) / (2.0 * rc * cosphi)
        cospsi = torch.sqrt(1.0 - sinpsi * sinpsi)
        ya2 = ra * cosphi
        xb2 = -rc * cospsi
        yb2 = -rb * cosphi - rc * sinpsi * sinphi
        yc2 = -rb * cosphi + rc * sinpsi * sinphi
        hh2 = 4.0 * xb2 * xb2 + (yb2 - yc2) ** 2 + (b1z - c1z) ** 2
        deltx = 2.0 * xb2 + torch.sqrt(4.0 * xb2 * xb2 - hh2 + d2 * d2)
        xb2 = xb2 - 0.5 * deltx
        alpha = xb2 * (b0x - c0x) + b0y * yb2 + c0y * yc2
        beta = xb2 * (c0y - b0y) + b0x * yb2 + c0x * yc2
        gamma = b0x * b1y - b1x * b0y + c0x * c1y - c1x * c0y
        al2be2 = alpha * alpha + beta * beta
        sintheta = (alpha * gamma - beta * torch.sqrt(
            torch.clamp(al2be2 - gamma * gamma, min=0.0))) / al2be2
        costheta = torch.sqrt(1.0 - sintheta * sintheta)

        def back(x, y, z):
            return x[:, None] * ex + y[:, None] * ey + z[:, None] * ez

        a3 = back(-ya2 * sintheta, ya2 * costheta, a1z)
        b3 = back(xb2 * costheta - yb2 * sintheta,
                  xb2 * sintheta + yb2 * costheta, b1z)
        c3 = back(-xb2 * costheta - yc2 * sintheta,
                  -xb2 * sintheta + yc2 * costheta, c1z)
        # constrained = com + a3 + a0 etc.; return it minus the proposal
        c_0 = (com + a3 + a0) - p0
        c_1 = (com + b3 - b0 + a1) - p1
        c_2 = (com + c3 - c0 + a2) - p2
        return self._scatter(new, c_0.to(new.dtype), c_1.to(new.dtype),
                             c_2.to(new.dtype))

    def apply_velocities(self, pos, vel):
        """Remove the velocity components along the three bonds of every
        cluster: solve (J M^-1 J^T) lambda = -J v per cluster."""
        f64 = torch.float64
        a0, a1, a2 = (t.to(f64) for t in self._triples(pos))
        v0, v1, v2 = (t.to(f64) for t in self._triples(vel))
        eab, eac, ebc = _unit(a1 - a0), _unit(a2 - a0), _unit(a2 - a1)
        w0, w1, w2 = (1.0 / self.m[:, k] for k in range(3))
        g = torch.stack([_dot(eab, v1 - v0), _dot(eac, v2 - v0),
                         _dot(ebc, v2 - v1)], dim=-1)
        ab_ac, ab_bc, ac_bc = _dot(eab, eac), _dot(eab, ebc), _dot(eac, ebc)
        a = torch.stack([
            torch.stack([w0 + w1, w0 * ab_ac, -w1 * ab_bc], -1),
            torch.stack([w0 * ab_ac, w0 + w2, w2 * ac_bc], -1),
            torch.stack([-w1 * ab_bc, w2 * ac_bc, w1 + w2], -1)], -2)
        lam = _solve3(a, -g)
        l0, l1, l2 = lam[:, 0:1], lam[:, 1:2], lam[:, 2:3]
        n0 = v0 + (-l0 * eab - l1 * eac) * w0[:, None]
        n1 = v1 + (l0 * eab - l2 * ebc) * w1[:, None]
        n2 = v2 + (l1 * eac + l2 * ebc) * w2[:, None]
        out = vel.clone()
        out[self.idx[:, 0]] = n0.to(vel.dtype)
        out[self.idx[:, 1]] = n1.to(vel.dtype)
        out[self.idx[:, 2]] = n2.to(vel.dtype)
        return out
