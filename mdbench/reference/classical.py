"""Plain reference of a classical fixed-charge force field: the potential
energy and forces that OpenMM's NonbondedForce (PME, Lennard-Jones with
Lorentz-Berthelot mixing, exceptions, the long-range dispersion
correction), HarmonicBondForce, HarmonicAngleForce and
PeriodicTorsionForce give, and the constraint and kinetic-energy readings
of a state, and one LangevinMiddle step (BAOAB with OpenMM's constraint
handling: a kick, the velocity constraints, half a drift, the
Ornstein-Uhlenbeck step, half a drift, the position constraints along the
bonds of the state before the move, and the velocities corrected by the
constraint correction alone).

Written from the published equations, in plain PyTorch, and independent of
the program under test: the smooth PME of Essmann et al., J. Chem. Phys.
103, 8577 (1995), with OpenMM's choice of alpha and grid
(NonbondedForceImpl::calcPMEParameters, order 5), the erfc-screened direct
space within the cutoff, the erf correction of every excluded pair, the
self energy, and OpenMM's dispersion correction
(NonbondedForceImpl::calcDispersionCorrection). Forces come from autograd
of the energy. The box must be rectangular.

`Precision("float64")` is the reference. `Precision("tf32")` is the
control: the same arithmetic in float32 with every operand and result
rounded to TF32's 10-bit mantissa, the precision below the program's
float32 forces.
"""
from __future__ import annotations

import math

import numpy as np
import torch

# CODATA 2018, in kJ nm / (mol e^2)
_AVOGADRO = 6.02214076e23
_E_CHARGE = 1.602176634e-19
ONE_4PI_EPS0 = 1.0 / (4.0 * math.pi * 1e-6 * 8.8541878128e-12
                      / (_E_CHARGE * _E_CHARGE * _AVOGADRO))
# the molar gas constant, kJ / (mol K)
GAS_CONSTANT = 1.380649e-23 * _AVOGADRO * 1e-3
PME_ORDER = 5
ROW_BLOCK = 2048


class _RoundTF32(torch.autograd.Function):
    """Round a float32 tensor to TF32 (10 mantissa bits, nearest), and its
    gradient too."""

    @staticmethod
    def forward(ctx, x):
        return _tf32(x)

    @staticmethod
    def backward(ctx, g):
        return _tf32(g)


def _tf32(x):
    if x.is_complex():
        return torch.complex(_tf32(x.real), _tf32(x.imag))
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class Precision:
    """float64 (the reference) or tf32 (the control)."""

    def __init__(self, name="float64"):
        if name not in ("float64", "tf32"):
            raise ValueError("precision is float64 or tf32, not %r" % name)
        self.name = name
        self.dtype = torch.float64 if name == "float64" else torch.float32

    def __call__(self, x):
        if self.name == "float64":
            return x
        return _RoundTF32.apply(x) if x.requires_grad else _tf32(x)


def find_fft_dim(minimum):
    """The smallest 2,3,5,7-smooth integer >= minimum."""
    n = int(minimum)
    while True:
        m = n
        for f in (2, 3, 5, 7):
            while m % f == 0:
                m //= f
        if m == 1:
            return n
        n += 1


def pme_parameters(cutoff, tolerance, widths):
    """(alpha, grid) by OpenMM's rule from the cutoff, the Ewald error
    tolerance and the box widths the Context starts from."""
    alpha = math.sqrt(-math.log(2.0 * tolerance)) / cutoff
    grid = tuple(find_fft_dim(max(int(math.ceil(
        2.0 * alpha * w / (3.0 * tolerance ** 0.2))), 6)) for w in widths)
    return alpha, grid


def bspline_weights(frac, order=PME_ORDER):
    """w[..., j] = M_order(frac + j), j = 0..order-1, of the cardinal
    B-spline M_order, for frac in [0, 1)."""
    w = [frac, 1.0 - frac]
    for k in range(3, order + 1):
        nxt = []
        for j in range(k):
            left = (frac + j) * w[j] if j < k - 1 else 0.0
            right = (k - frac - j) * w[j - 1] if j > 0 else 0.0
            nxt.append((left + right) / (k - 1))
        w = nxt
    return torch.stack(w, dim=-1)


def _bspline_moduli(k_size, order, dtype, device):
    """|sum_{k=0}^{order-2} M_order(k+1) exp(2 pi i m k / K)|^2, m = 0..K-1
    (the inverse of Essmann's |b(m)|^2)."""
    ints = bspline_weights(torch.zeros((), dtype=torch.float64),
                           order)[1:].numpy()  # M(1) .. M(order-1)
    m = np.arange(k_size)[:, None]
    k = np.arange(order - 1)[None, :]
    s = (ints[None, :] * np.exp(2j * math.pi * m * k / k_size)).sum(axis=1)
    mod = np.abs(s) ** 2
    # at m = K/2 the sum vanishes for an even K; OpenMM (after GROMACS's
    # pme.c) takes the mean of the neighbours there
    for i in np.nonzero(mod < 1e-7)[0]:
        mod[i] = 0.5 * (mod[(i - 1) % k_size] + mod[(i + 1) % k_size])
    return torch.as_tensor(mod, dtype=dtype, device=device)


def dispersion_coefficient(sigma, epsilon, cutoff):
    """OpenMM's long-range correction without switching: the energy adds
    this over the volume. Sums over every pair of Lennard-Jones classes,
    self pairs included."""
    pairs = {}
    for s, e in zip(np.asarray(sigma, float), np.asarray(epsilon, float)):
        pairs[(s, e)] = pairs.get((s, e), 0) + 1
    keys = list(pairs)
    sum1 = sum2 = 0.0
    for a, (s1, e1) in enumerate(keys):
        for b in range(a + 1):
            s2, e2 = keys[b]
            na, nb = pairs[keys[a]], pairs[keys[b]]
            count = na * (na + 1) / 2.0 if a == b else float(na) * nb
            sig6 = (0.5 * (s1 + s2)) ** 6
            eps = math.sqrt(e1 * e2)
            sum1 += count * eps * sig6 * sig6
            sum2 += count * eps * sig6
    n = float(len(sigma))
    pairs_all = n * (n + 1) / 2.0
    sum1 /= pairs_all
    sum2 /= pairs_all
    return 8.0 * n * n * math.pi * (sum1 / (9.0 * cutoff ** 9)
                                   - sum2 / (3.0 * cutoff ** 3))


def _min_image(d, widths):
    return d - widths * torch.round(d / widths)


class ClassicalForceField:
    """The energy and forces of one System's terms (`tables`: the numpy
    arrays the benchmark builds the program's System from) at positions
    and a rectangular box, on `device`, at `precision`."""

    def __init__(self, tables, device, precision="float64"):
        self.p = Precision(precision)
        self.device = torch.device(device)
        dt = self.p.dtype

        def t(key, dtype=dt):
            return torch.as_tensor(np.asarray(tables[key]), dtype=dtype,
                                   device=self.device)

        self.n = len(tables["masses"])
        self.masses = t("masses", torch.float64)
        self.charges = self.p(t("charges"))
        self.sigma = self.p(t("sigma"))
        self.epsilon = self.p(t("epsilon"))
        self.cutoff = float(tables["cutoff"])
        self.alpha, self.grid = pme_parameters(
            self.cutoff, float(tables["ewald_tolerance"]),
            np.diag(np.asarray(tables["box"], float)))
        self.disp = (dispersion_coefficient(tables["sigma"],
                                            tables["epsilon"], self.cutoff)
                     if tables["dispersion_correction"] else 0.0)
        ex = np.asarray(tables["exception_pairs"], np.int64).reshape(-1, 2)
        ex = np.sort(ex, axis=1)
        self.ex = torch.as_tensor(ex, device=self.device)
        self.ex_par = self.p(t("exception_params").reshape(-1, 3))
        self.ex_keys = torch.sort(self.ex[:, 0] * self.n + self.ex[:, 1])[0]
        self.terms = {}
        for key, width in (("bond", 2), ("angle", 3), ("torsion", 4)):
            atoms = np.asarray(tables.get(key + "_atoms", np.zeros(
                (0, width))), np.int64).reshape(-1, width)
            pars = np.asarray(tables.get(key + "_params", np.zeros(
                (0, 3 if key == "torsion" else 2))), float)
            if len(atoms):
                self.terms[key] = (torch.as_tensor(atoms, device=self.device),
                                   self.p(torch.as_tensor(
                                       pars, dtype=dt, device=self.device)))
        self.bmod = [_bspline_moduli(k, PME_ORDER, dt, self.device)
                     for k in self.grid]

    # -- the terms -------------------------------------------------------
    def _direct(self, pos, widths, rows):
        """Direct-space Coulomb (erfc-screened) and Lennard-Jones over the
        pairs i < j within the cutoff whose rows lie in `rows`, less the
        excluded pairs."""
        p, rc2 = self.p, self.cutoff * self.cutoff
        i0, i1 = rows
        with torch.no_grad():
            d = pos[None, :, :] - pos[i0:i1, None, :]
            d = _min_image(d, widths)
            r2 = (d * d).sum(-1)
            cols = torch.arange(self.n, device=self.device)
            upper = cols[None, :] > torch.arange(i0, i1, device=self.device
                                                 )[:, None]
            ii, jj = torch.nonzero((r2 < rc2) & upper, as_tuple=True)
            ii = ii + i0
            del d, r2, upper
            keys = ii * self.n + jj
            keep = ~torch.isin(keys, self.ex_keys)
            ii, jj = ii[keep], jj[keep]
            shift = widths * torch.round((pos[jj] - pos[ii]) / widths)
        d = p(p(pos[jj] - pos[ii]) - shift)
        r2 = p((d * d).sum(-1))
        r = p(torch.sqrt(r2))
        qq = p(self.charges[ii] * self.charges[jj])
        coul = p(ONE_4PI_EPS0 * p(qq * p(torch.special.erfc(self.alpha * r)
                                         / r)))
        sig = p(0.5 * (self.sigma[ii] + self.sigma[jj]))
        eps = p(torch.sqrt(self.epsilon[ii] * self.epsilon[jj]))
        s6 = p(p(p(sig * sig) / r2) ** 3)
        lj = p(4.0 * eps * p(s6 * s6 - s6))
        return p(coul.sum() + lj.sum())

    def _exceptions(self, pos, widths):
        """Each exception's own Coulomb and Lennard-Jones, plus the erf
        correction that removes its reciprocal-space interaction."""
        p = self.p
        i, j = self.ex[:, 0], self.ex[:, 1]
        d = p(_min_image(p(pos[j] - pos[i]), widths))
        r = p(torch.sqrt(p((d * d).sum(-1))))
        qq, sig, eps = self.ex_par[:, 0], self.ex_par[:, 1], self.ex_par[:, 2]
        s6 = p(p(sig / r) ** 6)
        e = p(ONE_4PI_EPS0 * qq / r) + p(4.0 * eps * p(s6 * s6 - s6))
        qiqj = p(self.charges[i] * self.charges[j])
        corr = p(ONE_4PI_EPS0 * p(qiqj * p(torch.special.erf(self.alpha * r)
                                           / r)))
        return p(e.sum() - corr.sum())

    def _reciprocal(self, pos, widths):
        """Smooth PME: the charges spread on the grid by order-5 B-splines,
        the structure factor's energy, the self energy and the neutralising
        background's."""
        p, dev = self.p, self.device
        k = torch.as_tensor(self.grid, dtype=self.p.dtype, device=dev)
        u = p(pos / widths * k)
        with torch.no_grad():
            base = torch.floor(u)
        frac = p(u - base)
        w = p(bspline_weights(frac))                 # (n, 3, order)
        offs = torch.arange(PME_ORDER, device=dev)
        idx = [torch.remainder(base[:, a].long()[:, None] - offs,
                               self.grid[a]) for a in range(3)]
        kx, ky, kz = self.grid
        flat = ((idx[0][:, :, None, None] * ky + idx[1][:, None, :, None])
                * kz + idx[2][:, None, None, :]).reshape(-1)
        vals = p(p(self.charges[:, None, None, None] * w[:, 0, :, None, None]
                   * w[:, 1, None, :, None]) * w[:, 2, None, None, :])
        grid = torch.zeros(kx * ky * kz, dtype=vals.dtype, device=dev)
        grid = p(grid.index_add(0, flat, vals.reshape(-1)).reshape(
            kx, ky, kz))
        s = p(torch.fft.fftn(grid))
        m = [torch.fft.fftfreq(g, d=1.0 / g).to(dev, self.p.dtype)
             / widths[a] for a, g in enumerate(self.grid)]
        m2 = (m[0][:, None, None] ** 2 + m[1][None, :, None] ** 2
              + m[2][None, None, :] ** 2)
        m2[0, 0, 0] = 1.0
        volume = widths.prod()
        denom = (m2 * self.bmod[0][:, None, None] * self.bmod[1][None, :, None]
                 * self.bmod[2][None, None, :])
        green = torch.exp(-(math.pi / self.alpha) ** 2 * m2) / denom
        green[0, 0, 0] = 0.0
        struct = p(s.real * s.real + s.imag * s.imag)
        e_rec = p(ONE_4PI_EPS0 / (2.0 * math.pi * volume)
                  * p((green * struct).sum()))
        q = self.charges
        e_self = -ONE_4PI_EPS0 * self.alpha / math.sqrt(math.pi) * (q * q
                                                                     ).sum()
        e_net = (-ONE_4PI_EPS0 * math.pi * q.sum() ** 2
                 / (2.0 * volume * self.alpha ** 2))
        return p(e_rec + p(e_self) + p(e_net))

    def _bonded(self, pos, widths):
        p = self.p
        e = torch.zeros((), dtype=self.p.dtype, device=self.device)
        if "bond" in self.terms:
            a, par = self.terms["bond"]
            d = p(_min_image(p(pos[a[:, 1]] - pos[a[:, 0]]), widths))
            r = p(torch.sqrt(p((d * d).sum(-1))))
            e = e + p((0.5 * par[:, 1] * p((r - par[:, 0]) ** 2)).sum())
        if "angle" in self.terms:
            a, par = self.terms["angle"]
            v1 = p(_min_image(p(pos[a[:, 0]] - pos[a[:, 1]]), widths))
            v2 = p(_min_image(p(pos[a[:, 2]] - pos[a[:, 1]]), widths))
            theta = p(torch.atan2(p(torch.linalg.norm(
                torch.cross(v1, v2, dim=-1), dim=-1)), p((v1 * v2).sum(-1))))
            e = e + p((0.5 * par[:, 1] * p((theta - par[:, 0]) ** 2)).sum())
        if "torsion" in self.terms:
            a, par = self.terms["torsion"]
            b1 = p(_min_image(p(pos[a[:, 1]] - pos[a[:, 0]]), widths))
            b2 = p(_min_image(p(pos[a[:, 2]] - pos[a[:, 1]]), widths))
            b3 = p(_min_image(p(pos[a[:, 3]] - pos[a[:, 2]]), widths))
            n1 = p(torch.cross(b1, b2, dim=-1))
            n2 = p(torch.cross(b2, b3, dim=-1))
            y = p(torch.linalg.norm(b2, dim=-1) * p((b1 * n2).sum(-1)))
            x = p((n1 * n2).sum(-1))
            phi = p(torch.atan2(y, x))
            e = e + p((par[:, 2] * (1.0 + torch.cos(par[:, 0] * phi
                                                    - par[:, 1]))).sum())
        return e

    # -- what callers use --------------------------------------------------
    def _prepare(self, positions, box):
        box = np.asarray(box, float)
        if np.count_nonzero(box - np.diag(np.diag(box))):
            raise ValueError("the reference takes rectangular boxes only")
        pos = torch.as_tensor(np.asarray(positions, float),
                              dtype=self.p.dtype, device=self.device)
        widths = torch.as_tensor(np.diag(box).copy(), dtype=self.p.dtype,
                                 device=self.device)
        return self.p(pos), self.p(widths)

    def _whole(self, pos, widths, backward):
        """The total energy; with `backward`, the gradient accumulated into
        pos.grad term by term, so that no two terms' graphs live at once."""
        total = 0.0
        terms = [lambda: self._reciprocal(pos, widths),
                 lambda: self._exceptions(pos, widths),
                 lambda: self._bonded(pos, widths)]
        terms += [(lambda r=(i0, min(i0 + ROW_BLOCK, self.n)):
                   self._direct(pos, widths, r))
                  for i0 in range(0, self.n, ROW_BLOCK)]
        for term in terms:
            e = term()
            if backward and e.requires_grad:
                e.backward()
            total += float(e.detach().double())
        return total + self.disp / float(widths.double().prod())

    def energy(self, positions, box) -> float:
        """The potential energy (kJ/mol) at `positions` (n, 3) nm and the
        3x3 `box` nm."""
        pos, widths = self._prepare(positions, box)
        with torch.no_grad():
            return self._whole(pos, widths, backward=False)

    def energy_forces(self, positions, box):
        """(energy kJ/mol, forces (n, 3) float64 numpy kJ/mol/nm)."""
        pos, widths = self._prepare(positions, box)
        pos = pos.detach().requires_grad_(True)
        energy = self._whole(pos, widths, backward=True)
        forces = -self.p(pos.grad)
        return energy, forces.double().cpu().numpy()


def constraint_error(tables, positions, box) -> float:
    """The largest |r - d| / d over the constraints, at positions nm in a
    rectangular box (minimum images)."""
    pairs = np.asarray(tables["constraint_pairs"], np.int64).reshape(-1, 2)
    if not len(pairs):
        return 0.0
    d = np.asarray(positions, float)
    d = d[pairs[:, 1]] - d[pairs[:, 0]]
    widths = np.diag(np.asarray(box, float))
    d -= widths * np.round(d / widths)
    r = np.linalg.norm(d, axis=1)
    want = np.asarray(tables["constraint_distances"], float)
    return float(np.max(np.abs(r - want) / want))


def kinetic_energy(tables, velocities) -> float:
    """0.5 sum m v^2 (kJ/mol) of velocities nm/ps."""
    v = np.asarray(velocities, float)
    return float(0.5 * np.sum(np.asarray(tables["masses"], float)[:, None]
                              * v * v))


class Constraints:
    """The distance constraints of `tables` in clusters (the connected
    components of the constraint graph: a water, a methyl group), on
    `device` in `dtype`. G(x) is the constraints' Jacobian at x (row k
    holds r_ij = x_i - x_j at atom i and -r_ij at atom j) and M the masses.
    """

    def __init__(self, tables, device, dtype=torch.float64):
        pairs = np.asarray(tables["constraint_pairs"], np.int64).reshape(
            -1, 2)
        masses = np.asarray(tables["masses"], float)
        self.device, self.dtype = torch.device(device), dtype
        self.n = len(masses)
        self.m = torch.as_tensor(masses, dtype=dtype, device=self.device)
        self.empty = not len(pairs)
        if self.empty:
            return
        label = np.arange(self.n)
        while True:
            low = np.minimum(label[pairs[:, 0]], label[pairs[:, 1]])
            new = label.copy()
            np.minimum.at(new, pairs[:, 0], low)
            np.minimum.at(new, pairs[:, 1], low)
            if np.array_equal(new, label):
                break
            label = new
        cluster_of = label[pairs[:, 0]]
        ids, cluster = np.unique(cluster_of, return_inverse=True)
        members = [[] for _ in ids]
        for k, c in enumerate(cluster):
            members[c].append(k)
        k_max = max(len(ms) for ms in members)
        atoms = [sorted(set(pairs[ms].reshape(-1).tolist()))
                 for ms in members]
        a_max = max(len(a) for a in atoms)
        n_c = len(ids)
        atom_idx = np.full((n_c, a_max), -1, np.int64)
        con_idx = np.full((n_c, k_max), -1, np.int64)
        local = np.zeros((n_c, k_max, 2), np.int64)
        for c, (ms, at) in enumerate(zip(members, atoms)):
            atom_idx[c, :len(at)] = at
            con_idx[c, :len(ms)] = ms
            where = {a: i for i, a in enumerate(at)}
            for slot, k in enumerate(ms):
                local[c, slot] = (where[pairs[k, 0]], where[pairs[k, 1]])

        def t(x, dtype=torch.int64):
            return torch.as_tensor(x, dtype=dtype, device=self.device)

        self.live_atoms = t(atom_idx >= 0, torch.bool)
        self.live_cons = t(con_idx >= 0, torch.bool)
        self.atom_idx = t(np.where(atom_idx >= 0, atom_idx, 0))
        self.local = t(local)
        dist = np.asarray(tables["constraint_distances"], float)
        d2 = np.where(con_idx >= 0, dist[np.maximum(con_idx, 0)] ** 2, 0.0)
        self.d2 = t(d2, dtype)
        inv = np.where(atom_idx >= 0, 1.0 / masses[np.maximum(atom_idx, 0)],
                       0.0)
        self.inv_m = t(inv, dtype)
        self.eye = torch.diag_embed((~self.live_cons).to(dtype))

    def _gather(self, x):
        return x[self.atom_idx] * self.live_atoms[..., None]

    def _bonds(self, xc, widths):
        """r_ij of each cluster's constraints (minimum images)."""
        i, j = self.local[..., 0], self.local[..., 1]
        take = (lambda a: torch.gather(
            xc, 1, a[..., None].expand(-1, -1, 3)))
        return _min_image(take(i) - take(j), widths)

    def _jacobian(self, r):
        """G per cluster, (clusters, k_max, a_max, 3)."""
        n_c, k_max = self.local.shape[:2]
        a_max = self.atom_idx.shape[1]
        g = torch.zeros(n_c, k_max, a_max, 3, dtype=self.dtype,
                        device=self.device)
        r = r * self.live_cons[..., None]
        g.scatter_add_(2, self.local[..., 0, None, None].expand(
            -1, -1, 1, 3), r[:, :, None, :])
        g.scatter_add_(2, self.local[..., 1, None, None].expand(
            -1, -1, 1, 3), -r[:, :, None, :])
        return g

    def _scatter(self, w, wc):
        out = w.clone()
        rows = self.atom_idx[self.live_atoms]
        out[rows] = wc[self.live_atoms]
        return out

    def project(self, x, w, widths):
        """P w: `w` (n, 3), a velocity, less its part in the span of
        M^-1 G(x)^T, in the metric of M. P is the velocity constraints
        that a constrained integrator applies, and it removes any
        correction that a constraint solver makes along the bonds at x."""
        if self.empty:
            return w
        g = self._jacobian(self._bonds(self._gather(x), widths))
        a = torch.einsum("ckad,clad,ca->ckl", g, g, self.inv_m) + self.eye
        wc = self._gather(w)
        mu = torch.linalg.solve(a, torch.einsum("ckad,cad->ck", g, wc))
        wc = wc - self.inv_m[..., None] * torch.einsum("ckad,ck->cad", g, mu)
        return self._scatter(w, wc)

    def solve_positions(self, ref, new, widths, iterations=30):
        """`new` moved along M^-1 G(ref)^T until every constrained
        distance holds (Newton's method on each cluster's multipliers)."""
        if self.empty:
            return new
        g = self._jacobian(self._bonds(self._gather(ref), widths))
        step = self.inv_m[:, None, :, None] * g      # d x / d lambda
        base = self._bonds(self._gather(new), widths)
        i, j = self.local[..., 0], self.local[..., 1]

        def pick(a):
            return torch.gather(step, 2, a[:, None, :, None].expand(
                -1, step.shape[1], -1, 3))          # (c, l, k, 3)

        # d r_k / d lambda_l
        dr = (pick(i) - pick(j)).transpose(1, 2)    # (c, k, l, 3)
        lam = torch.zeros(self.d2.shape, dtype=self.dtype,
                          device=self.device)
        for _ in range(iterations):
            r = base + torch.einsum("ckld,cl->ckd", dr, lam)
            resid = ((r * r).sum(-1) - self.d2) * self.live_cons
            jac = 2.0 * torch.einsum("ckd,ckld->ckl", r, dr) + self.eye
            lam = lam - torch.linalg.solve(jac, resid)
        wc = self._gather(new) + torch.einsum("clad,cl->cad", step, lam)
        return self._scatter(new, wc)


def langevin_middle_step(tables, x, v, widths, forces, dt, friction,
                         temperature, xi, remove_cm):
    """One LangevinMiddle step from positions x and velocities v (n, 3)
    with `forces` at x and the standard normals `xi` (n, 3), all tensors
    of one dtype on one device: (positions, velocities) after it. With
    `remove_cm` the centre-of-mass velocity is removed first (a
    CMMotionRemover firing at this step)."""
    cons = Constraints(tables, x.device, x.dtype)
    m = cons.m[:, None]
    if remove_cm:
        v = v - (m * v).sum(0) / m.sum()
    vk = cons.project(x, v + dt * forces / m, widths)
    a = math.exp(-friction * dt)
    s = math.sqrt(GAS_CONSTANT * temperature * (1.0 - a * a))
    vo = a * vk + s * xi / torch.sqrt(m)
    raw = x + 0.5 * dt * (vk + vo)
    new = cons.solve_positions(x, raw, widths)
    return new, vo + (new - raw) / dt
