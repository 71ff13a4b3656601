"""Holonomic distance constraints: SETTLE, SHAKE and CCMA.

Counterpart of openmm_tpu/ops/constraints.py (partition_constraints,
partition_shake_clusters, make_settle, make_shake, make_ccma). A Context
splits its constraints into SETTLE water triangles, then SHAKE-H star
clusters, then the rest, which CCMA solves; each stage runs in float64 on
every cluster (or constraint) at once, with a fixed number of iterations
and no early exit read on the host, so a step with constraints can be
captured in a CUDA graph. SETTLE returns a CORRECTION field c with
constrained = proposed + c, exactly zero off its clusters; the Context
sums the corrections of the three stages the way the JAX Context does,
and integrators recover velocities from that field alone (the JAX
package's round-5 drift fix: re-deriving velocities from rounded
positions injects an eps*|x|/dt kick every step).

The JAX SHAKE writes its clusters back through a scatter-free
permutation and its CCMA through gather tables, both TPU workarounds for
slow scatters. Here every atom of a SHAKE cluster is written back once by
index (index_copy_: no two writes meet, so the bits are fixed), and CCMA
adds each atom's constraint corrections by gathers in a fixed order
(ops/accumulate.py).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from .accumulate import GatherSum


def partition_constraints(constraints, masses):
    """Split (i, j, d) constraints into SETTLE clusters (centre, h1, h2,
    d(centre, h), d(h, h)) and the remaining constraints. A cluster is a
    triangle of three constraints whose atoms carry no other constraint,
    with a centre whose two distances and whose partners' masses are
    equal (tried in the order i, j, k of the triangle's first
    constraint).

    The triangles are found for all constraints at once: with every atom
    of a triangle on two constraints, a triangle is a component of its
    own, found at its first constraint, and a triangle without a centre
    has none whichever of its constraints it is tried from."""
    masses = np.asarray(masses, np.float64)
    m = len(constraints)
    if m == 0:
        return [], []
    table = np.asarray(constraints, np.float64).reshape(m, 3)
    ends = table[:, :2].astype(np.int64)
    dist = table[:, 2]
    i, j = ends[:, 0], ends[:, 1]
    # each atom's constraints in the order (constraint, then i before j)
    flat = ends.ravel()
    degree = np.bincount(flat, minlength=len(masses))
    order = np.argsort(flat, kind="stable")
    start = np.concatenate(([0], np.cumsum(degree)[:-1]))
    first_c = np.zeros(len(degree), np.int64)
    second_c = np.zeros(len(degree), np.int64)
    two = degree == 2
    first_c[two] = order[start[two]] // 2
    second_c[two] = order[start[two] + 1] // 2
    ci = np.nonzero((i != j) & two[i] & two[j])[0]

    def other(atom, c):
        """The constraint of `atom` (which has two) other than c, and that
        constraint's other atom."""
        oc = np.where(first_c[atom] == c, second_c[atom], first_c[atom])
        a, b = ends[oc, 0], ends[oc, 1]
        return oc, np.where(a == atom, b, a)

    ii, jj = i[ci], j[ci]
    c_ik, k = other(ii, ci)
    c_jk, k_j = other(jj, ci)
    keep = ((k == k_j) & (k != ii) & (k != jj) & two[k]
            & (ci < c_ik) & (ci < c_jk))
    ci, ii, jj, k, c_ik, c_jk = (a[keep] for a in (ci, ii, jj, k, c_ik,
                                                   c_jk))
    d, d_ik, d_jk = dist[ci], dist[c_ik], dist[c_jk]
    # (centre, o1, o2, d(centre, o1), d(centre, o2), d(o1, o2)) in turn
    tries = ((ii, jj, k, d, d_ik, d_jk), (jj, ii, k, d, d_jk, d_ik),
             (k, ii, jj, d_ik, d_jk, d))
    passes = np.stack([(np.abs(d1 - d2) < 1e-10)
                       & (np.abs(masses[o1] - masses[o2]) < 1e-10)
                       & (masses[centre] > 0) & (masses[o1] > 0)
                       for centre, o1, o2, d1, d2, _ in tries])
    found = passes.any(axis=0)
    pick = np.argmax(passes, axis=0)
    rows = np.arange(len(ci))
    cols = [np.stack(col)[pick, rows] for col in zip(*tries)]
    centre, o1, o2, d1, _, d12 = (c[found] for c in cols)
    settle = list(zip(centre.tolist(), o1.tolist(), o2.tolist(),
                      d1.tolist(), d12.tolist()))
    used = np.zeros(m, bool)
    used[np.concatenate([ci[found], c_ik[found], c_jk[found]])] = True
    rest = [c for c, u in zip(constraints, used.tolist()) if not u]
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


def partition_shake_clusters(constraints, masses):
    """Split (i, j, d) constraints into SHAKE-H star clusters and the rest.

    A cluster (IntegrationUtilities.cpp:44-63, 204-259) is a central atom
    with 1-3 peripheral atoms that all share the cluster's one distance
    and one mass and take part in no other constraint; the central atom's
    constraints are exactly the cluster's. Returns (clusters, rest) with
    clusters a list of (central, [peripherals], distance)."""
    count = {}
    for i, j, _ in constraints:
        count[i] = count.get(i, 0) + 1
        count[j] = count.get(j, 0) + 1
    by_central, invalid = {}, set()
    for ci, (i, j, d) in enumerate(constraints):
        if count[i] > 1 and count[j] > 1:
            invalid.update((i, j))
            continue
        if count[i] > 1:
            central, periph = i, j
        elif count[j] > 1:
            central, periph = j, i
        else:
            central, periph = (i, j) if i < j else (j, i)
        by_central.setdefault(central, []).append((ci, periph, d))
    clusters, used = [], [False] * len(constraints)
    for central, members in by_central.items():
        ok = (central not in invalid and len(members) <= 3
              and masses[central] > 0)
        d0, m0 = members[0][2], masses[members[0][1]]
        for _, p, d in members:
            if (p in invalid or p in by_central or abs(d - d0) > 1e-8 * d0
                    or masses[p] <= 0 or abs(masses[p] - m0) > 1e-8 * m0):
                ok = False
        if ok:
            clusters.append((central, [p for _, p, _ in members], d0))
            for ci, _, _ in members:
                used[ci] = True
    rest = [constraints[c] for c in range(len(constraints)) if not used[c]]
    return clusters, rest


class Shake(nn.Module):
    """Parallel SHAKE over independent H star clusters in float64: per
    cluster the (up to three) bond corrections are applied in turn, the
    central atom's displacement accumulating, for a fixed `iterations`
    sweeps (make_shake's lax.scan; applyShakeToPositions and
    applyShakeToVelocities of integrationUtilities.cc). A bond whose
    residual is within tol of d^2 takes no correction."""

    def __init__(self, clusters, masses, device, tol=1e-6, iterations=15):
        super().__init__()
        k = len(clusters)
        cent = np.asarray([c[0] for c in clusters], np.int64)
        peri = np.full((k, 3), -1, np.int64)
        for row, (_, ps, _) in enumerate(clusters):
            peri[row, :len(ps)] = ps
        valid = peri >= 0
        m = np.asarray(masses, np.float64)
        inv_mc = 1.0 / m[cent]
        inv_mp = np.asarray([1.0 / m[c[1][0]] for c in clusters])
        f64 = dict(dtype=torch.float64, device=device)
        self.iterations, self.tol = int(iterations), float(tol)
        self.register_buffer("cent", torch.as_tensor(cent, device=device))
        # an empty slot reads the central atom; its correction is masked
        self.register_buffer("peri", torch.as_tensor(
            np.where(valid, peri, cent[:, None]), device=device))
        # per slot: no peripheral atom there; and the constants that stand
        # in for a skipped slot's values (tensors: a Python scalar in
        # torch.where costs a fill kernel a call)
        self.skip = [torch.as_tensor(~valid[:, a], device=device)
                     for a in range(3)]
        self.register_buffer("one", torch.ones(k, **f64))
        self.register_buffer("zero", torch.zeros(k, **f64))
        self.register_buffer("d2", torch.as_tensor(
            [c[2] * c[2] for c in clusters], **f64))
        self.register_buffer("inv_mc", torch.as_tensor(inv_mc, **f64))
        self.register_buffer("inv_mp", torch.as_tensor(inv_mp, **f64))
        self.register_buffer("avg_m", torch.as_tensor(
            0.5 / (inv_mc + inv_mp), **f64))
        # the atoms written back: the centres, then each live slot
        rows, slots = np.nonzero(valid)
        self.register_buffer("live", torch.as_tensor(rows * 3 + slots,
                                                     device=device))
        self.register_buffer("out_atoms", torch.as_tensor(
            np.concatenate([cent, peri[rows, slots]]), device=device))

    def _frame(self, x):
        """(centres (K, 3), peripherals (K, 3 slots, 3))."""
        return x[self.cent], x[self.peri]

    def _write(self, x, centres, periph):
        rows = torch.cat([centres, periph.reshape(-1, 3)[self.live]])
        return x.clone().index_copy_(0, self.out_atoms, rows.to(x.dtype))

    def apply_positions(self, ref, new):
        """The proposed positions `new` constrained along the bonds of
        the constrained positions `ref`."""
        f64 = torch.float64
        rc, rp = (t.to(f64) for t in self._frame(ref))
        nc, np_ = (t.to(f64) for t in self._frame(new))
        rij = rc[:, None, :] - rp
        rijsq = (rij * rij).sum(dim=-1)
        ld = self.d2[:, None] - rijsq
        xpi = nc - rc
        xpj = list((np_ - rp).unbind(dim=1))
        near_tol = self.d2 * self.tol
        for _ in range(self.iterations):
            for a in range(3):
                skip = self.skip[a]
                rpij = xpi - xpj[a]
                rpsq = (rpij * rpij).sum(dim=-1)
                rrpr = (rij[:, a] * rpij).sum(dim=-1)
                resid = ld[:, a] - 2.0 * rrpr - rpsq
                near = resid.abs() < near_tol
                denom = torch.where(skip, self.one, rrpr + rijsq[:, a])
                acor = torch.where(near | skip, self.zero,
                                   resid * self.avg_m / denom)
                dr = rij[:, a] * acor[:, None]
                xpi = xpi + dr * self.inv_mc[:, None]
                xpj[a] = xpj[a] - dr * self.inv_mp[:, None]
        return self._write(new, rc + xpi, rp + torch.stack(xpj, dim=1))

    def apply_velocities(self, pos, vel):
        """`vel` with the components along each cluster's bonds removed."""
        f64 = torch.float64
        rc, rp = (t.to(f64) for t in self._frame(pos))
        vc, vp = (t.to(f64) for t in self._frame(vel))
        rij = rc[:, None, :] - rp
        rijsq = (rij * rij).sum(dim=-1)
        vi, vj = vc, list(vp.unbind(dim=1))
        for _ in range(self.iterations):
            for a in range(3):
                skip = self.skip[a]
                rrpr = ((vi - vj[a]) * rij[:, a]).sum(dim=-1)
                denom = torch.where(skip, self.one, rijsq[:, a])
                delta = torch.where(skip, self.zero,
                                    -2.0 * self.avg_m * rrpr / denom)
                dr = rij[:, a] * delta[:, None]
                vi = vi + dr * self.inv_mc[:, None]
                vj[a] = vj[a] - dr * self.inv_mp[:, None]
        return self._write(vel, vi, torch.stack(vj, dim=1))


def ccma_coupling_matrix(cons, masses, angles):
    """The constraint-coupling matrix K (ReferenceCCMAAlgorithm): for two
    constraints that share an atom, w_shared cos(theta) / (w_i + w_j) of
    the first, theta the angle between them from a constrained triangle
    or from a harmonic angle's equilibrium (angles: (i, j, k, theta0)
    with j central)."""
    n = len(cons)
    k = np.eye(n)
    inv_m = np.array([0.0 if m == 0 else 1.0 / m for m in masses])
    dist = {(min(i, j), max(i, j)): d for i, j, d in cons}
    angle_map = {(min(i, kk), j, max(i, kk)): theta0
                 for i, j, kk, theta0 in angles}
    by_atom = {}
    for ci, (i, j, _) in enumerate(cons):
        by_atom.setdefault(i, []).append(ci)
        by_atom.setdefault(j, []).append(ci)
    for shared, clist in by_atom.items():
        for ca in clist:
            for cb in clist:
                if ca == cb:
                    continue
                ia, ja, da = cons[ca]
                ib, jb, db = cons[cb]
                oa = ja if ia == shared else ia
                ob = jb if ib == shared else ib
                key = (min(oa, ob), max(oa, ob))
                if key in dist:
                    d3 = dist[key]
                    cos_t = (da * da + db * db - d3 * d3) / (2 * da * db)
                elif (key[0], shared, key[1]) in angle_map:
                    cos_t = math.cos(angle_map[(key[0], shared, key[1])])
                else:
                    continue
                k[ca, cb] = inv_m[shared] / (inv_m[ia] + inv_m[ja]) * cos_t
    return k


class CCMA(nn.Module):
    """CCMA for general constraint networks in float64: the inverse of
    the coupling matrix, computed on the host and sparsified at
    `sparsify_cutoff` to rows of fixed width, turns each iteration's
    violations into multipliers; the corrections act along the reference
    bond directions for a fixed `iterations` sweeps, on the compact set of
    atoms that any constraint touches (make_ccma)."""

    def __init__(self, cons, masses, angles, device, iterations=40,
                 sparsify_cutoff=0.02):
        super().__init__()
        pairs = np.asarray([(c[0], c[1]) for c in cons], np.int64)
        d0 = np.asarray([c[2] for c in cons], np.float64)
        inv_m_all = np.array([0.0 if m == 0 else 1.0 / m for m in masses])
        involved = np.unique(pairs.reshape(-1))
        local = np.searchsorted(involved, pairs)
        k_inv = np.linalg.inv(ccma_coupling_matrix(cons, masses, angles))
        k_inv[np.abs(k_inv) < sparsify_cutoff] = 0.0
        width = max(1, int((k_inv != 0).sum(axis=1).max()))
        cols = np.zeros((len(cons), width), np.int64)
        vals = np.zeros((len(cons), width))
        for r in range(len(cons)):
            nz = np.nonzero(k_inv[r])[0]
            cols[r, :len(nz)] = nz
            vals[r, :len(nz)] = k_inv[r, nz]
        f64 = dict(dtype=torch.float64, device=device)
        self.iterations = int(iterations)
        self.register_buffer("involved", torch.as_tensor(involved,
                                                         device=device))
        self.register_buffer("idx", torch.as_tensor(local, device=device))
        self.register_buffer("d0", torch.as_tensor(d0, **f64))
        self.register_buffer("red_m", torch.as_tensor(
            1.0 / (2.0 * (inv_m_all[pairs[:, 0]] + inv_m_all[pairs[:, 1]])),
            **f64))
        self.register_buffer("inv_m", torch.as_tensor(inv_m_all[involved],
                                                      **f64))
        self.register_buffer("cols", torch.as_tensor(cols, device=device))
        self.register_buffer("vals", torch.as_tensor(vals, **f64))
        self.gather = GatherSum(local, len(involved), device)

    def _distribute(self, dr):
        """(C, 3) constraint corrections -> (atoms, 3) displacements:
        -dr on the first atom of each constraint, +dr on the second, over
        the atom's inverse mass."""
        return self.inv_m[:, None] * self.gather(torch.stack([-dr, dr],
                                                             dim=1))

    def _pair(self, x):
        return x[self.idx[:, 0]] - x[self.idx[:, 1]]

    def apply_positions(self, ref, new):
        f64 = torch.float64
        r_ref = self._pair(ref[self.involved].to(f64))
        x = new[self.involved].to(f64)
        for _ in range(self.iterations):
            rp = self._pair(x)
            diff = (rp * rp).sum(dim=-1) - self.d0 * self.d0
            g = diff * self.red_m / (r_ref * rp).sum(dim=-1)
            lam = (self.vals * g[self.cols]).sum(dim=1)
            x = x + self._distribute(r_ref * lam[:, None])
        return new.clone().index_copy_(0, self.involved, x.to(new.dtype))

    def apply_velocities(self, pos, vel):
        f64 = torch.float64
        r = self._pair(pos[self.involved].to(f64))
        r2 = (r * r).sum(dim=-1)
        v = vel[self.involved].to(f64)
        for _ in range(self.iterations):
            rv = (r * self._pair(v)).sum(dim=-1)
            lam = (self.vals * (rv * self.red_m * 2.0 / r2)[self.cols]).sum(
                dim=1)
            v = v + self._distribute(r * lam[:, None])
        return vel.clone().index_copy_(0, self.involved, v.to(vel.dtype))
