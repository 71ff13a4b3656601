"""Generalized Kirkwood implicit solvent for AMOEBA multipoles.

Counterpart of openmm_tpu/ops/gk.py, the same energy terms as dense
(n, n) torch tensors (GK is a NoCutoff implicit-solvent model); forces
come from torch.autograd through the Born radii, the solvated SCF and the
pair energies, as the JAX package takes them by jax.grad. Sources:

* Grycuk Born radii: plugins/amoeba/platforms/reference/src/SimTKReference/
  AmoebaReferenceGeneralizedKirkwoodForce.cpp:135-203
* GK auxiliary terms / reaction-potential tensors / pair energies:
  AmoebaReferenceMultipoleForce.cpp:2538-3948 (energy terms only; tensors
  through the 2nd reaction-potential gradient)
* permanent + induced GK reaction fields: same file :2170-2536
* cavity term: :4124-4135
* dielectric factors fc/fd/fq and gkc: :2113-2140
"""
from __future__ import annotations

import torch

GKC = 2.455
DIELECTRIC_OFFSET = 0.009
BIG_RADIUS = 1000.0


def grycuk_born_radii(pos, radii, scale_factors):
    """Grycuk pairwise-descreening Born radii (exact port; piecewise branches
    as nested where)."""
    n = pos.shape[0]
    dr = pos[None, :, :] - pos[:, None, :]
    r2 = torch.sum(dr * dr, dim=-1)
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)
    r = torch.sqrt(torch.where(eye, 1.0, r2))
    rho_i = radii[:, None]
    sk = (radii * scale_factors)[None, :]
    sk2 = sk * sk

    engulfed = rho_i > (r + sk)          # no descreening from j
    inside = (rho_i + r) < sk            # i inside j's descreening sphere

    # extra term when i sits inside j's scaled sphere
    lik_in = rho_i
    uik_in = torch.clamp(sk - r, min=1e-10)
    term_in = -(1.0 / uik_in ** 3 - 1.0 / lik_in ** 3)

    uik = r + sk
    lik = torch.where(inside, torch.clamp(sk - r, min=1e-10),
                    torch.where(r < rho_i + sk, rho_i, r - sk))
    l2 = lik * lik
    l4 = l2 * l2
    u2 = uik * uik
    u4 = u2 * u2
    term = ((3.0 * (r2 - sk2) + 6.0 * u2 - 8.0 * uik * r) / (u4 * r)
            - (3.0 * (r2 - sk2) + 6.0 * l2 - 8.0 * lik * r) / (l4 * r))
    pair = torch.where(inside, term_in, 0.0) + term / 16.0
    pair = torch.where(eye | engulfed | (sk <= 0.0), 0.0, pair)
    born_sum = 1.0 / torch.clamp(radii, min=1e-6) ** 3 - torch.sum(pair, dim=1)
    born = torch.where(born_sum <= 0.0, BIG_RADIUS,
                     torch.clamp(born_sum, min=1e-12) ** (-1.0 / 3.0))
    return torch.where(radii <= 0.0, BIG_RADIUS, born)


def _aux_terms(r2, rb2, gkc):
    """Reaction-potential auxiliary terms a_nm (n = source order, m =
    gradient order), unscaled by the dielectric factors."""
    expterm = torch.exp(-r2 / (gkc * rb2))
    expc = expterm / gkc
    dexpc = -2.0 / (gkc * rb2)
    gf2 = 1.0 / (r2 + rb2 * expterm)
    gf = torch.sqrt(gf2)
    gf3 = gf2 * gf
    gf5 = gf3 * gf2
    gf7 = gf5 * gf2
    gf9 = gf7 * gf2
    a00 = gf
    a10 = -gf3
    a20 = 3.0 * gf5
    a30 = -15.0 * gf7
    a40 = 105.0 * gf9
    expc1 = 1.0 - expc
    a01 = expc1 * a10
    a11 = expc1 * a20
    a21 = expc1 * a30
    a31 = expc1 * a40
    expcdexpc = -expc * dexpc
    a02 = expc1 * a11 + expcdexpc * a10
    a12 = expc1 * a21 + expcdexpc * a20
    a22 = expc1 * a31 + expcdexpc * a30
    return {"a00": a00, "a10": a10, "a20": a20,
            "a01": a01, "a11": a11, "a21": a21,
            "a02": a02, "a12": a12, "a22": a22}


def _tensors(dr, aux, fc, fd, fq):
    """Reaction potential tensors through the 2nd gradient, with the
    dielectric factors folded (reference :2693-2945 energy subset).

    Index convention mirrors the reference: slot 1 = potential value,
    2-4 = gradient (x,y,z), 5-10 = 2nd gradient (xx,xy,xz,yy,yz,zz)."""
    xr = dr[..., 0]
    yr = dr[..., 1]
    zr = dr[..., 2]
    xr2, yr2, zr2 = xr * xr, yr * yr, zr * zr
    a00 = fc * aux["a00"]
    a01 = fc * aux["a01"]
    a02 = fc * aux["a02"]
    a10 = fd * aux["a10"]
    a11 = fd * aux["a11"]
    a12 = fd * aux["a12"]
    a20 = fq * aux["a20"]
    a21 = fq * aux["a21"]
    a22 = fq * aux["a22"]

    t = {}
    t["gc1"] = a00
    t["gc"] = _stack([xr * a01, yr * a01, zr * a01], -1)       # 2-4
    # gc5..10: xx, xy, xz, yy, yz, zz
    t["gc2nd"] = _stack([
        a01 + xr2 * a02, xr * yr * a02, xr * zr * a02,
        a01 + yr2 * a02, yr * zr * a02, a01 + zr2 * a02], -1)
    # dipole potential value (gux1, guy1, guz1)
    t["gu1"] = _stack([xr * a10, yr * a10, zr * a10], -1)
    # dipole gradient gu[d][g]: (3,3) per pair, d = dipole comp, g = grad
    gux2 = a10 + xr2 * a11
    gux3 = xr * yr * a11
    gux4 = xr * zr * a11
    guy3 = a10 + yr2 * a11
    guy4 = yr * zr * a11
    guz4 = a10 + zr2 * a11
    t["gu_g"] = _stack([
        _stack([gux2, gux3, gux4], -1),
        _stack([gux3, guy3, guy4], -1),
        _stack([gux4, guy4, guz4], -1)], -2)
    # dipole 2nd gradient gu[d][s] with s = xx,xy,xz,yy,yz,zz
    gux5 = xr * (3.0 * a11 + xr2 * a12)
    gux6 = yr * (a11 + xr2 * a12)
    gux7 = zr * (a11 + xr2 * a12)
    gux8 = xr * (a11 + yr2 * a12)
    gux9 = zr * xr * yr * a12
    gux10 = xr * (a11 + zr2 * a12)
    guy5 = yr * (a11 + xr2 * a12)
    guy6 = xr * (a11 + yr2 * a12)
    guy8 = yr * (3.0 * a11 + yr2 * a12)
    guy9 = zr * (a11 + yr2 * a12)
    guy10 = yr * (a11 + zr2 * a12)
    guz5 = zr * (a11 + xr2 * a12)
    guz7 = xr * (a11 + zr2 * a12)
    guz8 = zr * (a11 + yr2 * a12)
    guz9 = yr * (a11 + zr2 * a12)
    guz10 = zr * (3.0 * a11 + zr2 * a12)
    t["gu_2"] = _stack([
        _stack([gux5, gux6, gux7, gux8, gux9, gux10], -1),
        _stack([guy5, guy6, gux9, guy8, guy9, guy10], -1),
        _stack([guz5, gux9, guz7, guz8, guz9, guz10], -1)], -2)
    # quadrupole potential value gq**1 as symmetric 6-vector (xx,xy,xz,yy,yz,zz)
    t["gq1"] = _stack([xr2 * a20, xr * yr * a20, xr * zr * a20,
                          yr2 * a20, yr * zr * a20, zr2 * a20], -1)
    # quadrupole gradient gq[s][g]
    gqxx2 = xr * (2.0 * a20 + xr2 * a21)
    gqxx3 = yr * xr2 * a21
    gqxx4 = zr * xr2 * a21
    gqyy2 = xr * yr2 * a21
    gqyy3 = yr * (2.0 * a20 + yr2 * a21)
    gqyy4 = zr * yr2 * a21
    gqzz2 = xr * zr2 * a21
    gqzz3 = yr * zr2 * a21
    gqzz4 = zr * (2.0 * a20 + zr2 * a21)
    gqxy2 = yr * (a20 + xr2 * a21)
    gqxy3 = xr * (a20 + yr2 * a21)
    gqxy4 = zr * xr * yr * a21
    gqxz2 = zr * (a20 + xr2 * a21)
    gqxz4 = xr * (a20 + zr2 * a21)
    gqyz3 = zr * (a20 + yr2 * a21)
    gqyz4 = yr * (a20 + zr2 * a21)
    t["gq_g"] = _stack([
        _stack([gqxx2, gqxx3, gqxx4], -1),
        _stack([gqxy2, gqxy3, gqxy4], -1),
        _stack([gqxz2, gqxy4, gqxz4], -1),
        _stack([gqyy2, gqyy3, gqyy4], -1),
        _stack([gqxy4, gqyz3, gqyz4], -1),
        _stack([gqzz2, gqzz3, gqzz4], -1)], -2)
    # quadrupole 2nd gradient gq[s][s'] (reference gq**5..10)
    gqxx5 = 2.0 * a20 + xr2 * (5.0 * a21 + xr2 * a22)
    gqxx6 = yr * xr * (2.0 * a21 + xr2 * a22)
    gqxx7 = zr * xr * (2.0 * a21 + xr2 * a22)
    gqxx8 = xr2 * (a21 + yr2 * a22)
    gqxx9 = zr * yr * xr2 * a22
    gqxx10 = xr2 * (a21 + zr2 * a22)
    gqyy5 = yr2 * (a21 + xr2 * a22)
    gqyy6 = xr * yr * (2.0 * a21 + yr2 * a22)
    gqyy7 = xr * zr * yr2 * a22
    gqyy8 = 2.0 * a20 + yr2 * (5.0 * a21 + yr2 * a22)
    gqyy9 = yr * zr * (2.0 * a21 + yr2 * a22)
    gqyy10 = yr2 * (a21 + zr2 * a22)
    gqzz5 = zr2 * (a21 + xr2 * a22)
    gqzz6 = xr * yr * zr2 * a22
    gqzz7 = xr * zr * (2.0 * a21 + zr2 * a22)
    gqzz8 = zr2 * (a21 + yr2 * a22)
    gqzz9 = yr * zr * (2.0 * a21 + zr2 * a22)
    gqzz10 = 2.0 * a20 + zr2 * (5.0 * a21 + zr2 * a22)
    gqxy5 = xr * yr * (3.0 * a21 + xr2 * a22)
    gqxy6 = a20 + (xr2 + yr2) * a21 + xr2 * yr2 * a22
    gqxy7 = zr * yr * (a21 + xr2 * a22)
    gqxy8 = xr * yr * (3.0 * a21 + yr2 * a22)
    gqxy9 = zr * xr * (a21 + yr2 * a22)
    gqxy10 = xr * yr * (a21 + zr2 * a22)
    gqxz5 = xr * zr * (3.0 * a21 + xr2 * a22)
    gqxz6 = yr * zr * (a21 + xr2 * a22)
    gqxz7 = a20 + (xr2 + zr2) * a21 + xr2 * zr2 * a22
    gqxz8 = xr * zr * (a21 + yr2 * a22)
    gqxz9 = xr * yr * (a21 + zr2 * a22)
    gqxz10 = xr * zr * (3.0 * a21 + zr2 * a22)
    gqyz5 = zr * yr * (a21 + xr2 * a22)
    gqyz6 = xr * zr * (a21 + yr2 * a22)
    gqyz7 = xr * yr * (a21 + zr2 * a22)
    gqyz8 = yr * zr * (3.0 * a21 + yr2 * a22)
    gqyz9 = a20 + (yr2 + zr2) * a21 + yr2 * zr2 * a22
    gqyz10 = yr * zr * (3.0 * a21 + zr2 * a22)
    t["gq_2"] = _stack([
        _stack([gqxx5, gqxx6, gqxx7, gqxx8, gqxx9, gqxx10], -1),
        _stack([gqxy5, gqxy6, gqxy7, gqxy8, gqxy9, gqxy10], -1),
        _stack([gqxz5, gqxz6, gqxz7, gqxz8, gqxz9, gqxz10], -1),
        _stack([gqyy5, gqyy6, gqyy7, gqyy8, gqyy9, gqyy10], -1),
        _stack([gqyz5, gqyz6, gqyz7, gqyz8, gqyz9, gqyz10], -1),
        _stack([gqzz5, gqzz6, gqzz7, gqzz8, gqzz9, gqzz10], -1)], -2)
    return t


def _stack(xs, axis):
    return torch.stack(xs, dim=axis)


def _sym6(q):
    """(n, 3, 3) symmetric matrices -> (n, 6) [xx, xy, xz, yy, yz, zz] with
    the reference's double-weighting of off-diagonal components applied at
    CONTRACTION time, not here."""
    return _stack([q[:, 0, 0], q[:, 0, 1], q[:, 0, 2],
                      q[:, 1, 1], q[:, 1, 2], q[:, 2, 2]], -1)


def _offd(like):
    """The reference's double weight of the off-diagonal quadrupole
    components (xx, xy, xz, yy, yz, zz)."""
    return torch.tensor([1.0, 2.0, 2.0, 1.0, 2.0, 1.0], dtype=like.dtype,
                        device=like.device)


def gk_setup(pos, born, charge, d_lab, q_lab, solvent_dielectric,
             gkc=GKC, offd=None):
    """Common pair data for the GK energy/field evaluations."""
    eps = solvent_dielectric
    fc = (1.0 - eps) / eps
    fd = 2.0 * (1.0 - eps) / (1.0 + 2.0 * eps)
    fq = 3.0 * (1.0 - eps) / (2.0 + 3.0 * eps)
    dr = pos[None, :, :] - pos[:, None, :]     # dr[i,j] = r_j - r_i
    r2 = torch.sum(dr * dr, dim=-1)
    rb2 = born[:, None] * born[None, :]
    aux = _aux_terms(r2, rb2, gkc)
    t = _tensors(dr, aux, fc, fd, fq)
    q6 = _sym6(q_lab)
    return {"t": t, "q6": q6, "charge": charge, "d": d_lab,
            "w": _offd(q6) if offd is None else offd}


class _Recomputed(torch.autograd.Function):
    """fn(*inputs)'s tensors, none of them kept for the backward: it
    recomputes them from the inputs and backpropagates through that (what
    torch.utils.checkpoint does; its first call imports torch._dynamo,
    ~9 s of host work). First derivatives only."""

    @staticmethod
    def forward(ctx, fn, *inputs):
        ctx.fn = fn
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*inputs)
        with torch.no_grad():
            return tuple(fn(*inputs))

    @staticmethod
    def backward(ctx, *grads):
        needs = ctx.needs_input_grad[1:]
        inputs = [x.detach().requires_grad_(need)
                  for x, need in zip(ctx.saved_tensors, needs)]
        with torch.enable_grad():
            outputs = ctx.fn(*inputs)
        used = [(o, g) for o, g in zip(outputs, grads)
                if g is not None and o.requires_grad]
        wanted = [x for x in inputs if x.requires_grad]
        got = iter(torch.autograd.grad(
            [o for o, _ in used], wanted, [g for _, g in used],
            allow_unused=True) if used and wanted else [None] * len(wanted))
        return (None, *[next(got) if need else None for need in needs])


def gk_setup_recomputed(pos, born, charge, d_lab, q_lab,
                        solvent_dielectric, gkc=GKC, offd=None):
    """gk_setup with its ~200 dense (n, n) reaction-potential
    intermediates recomputed in the backward instead of kept from the
    forward (a 2,482-atom step's capture needed ~60 GB with them)."""
    keys = []

    def tensors(pos, born, d_lab, q_lab):
        setup = gk_setup(pos, born, charge, d_lab, q_lab,
                         solvent_dielectric, gkc, offd)
        keys[:] = list(setup["t"])
        return [setup["t"][k] for k in keys] + [setup["q6"]]

    out = _Recomputed.apply(tensors, pos, born, d_lab, q_lab)
    return {"t": dict(zip(keys, out[:-1])), "q6": out[-1],
            "charge": charge, "d": d_lab,
            "w": _offd(out[-1]) if offd is None else offd}


def _q6w(setup):
    return setup["q6"] * setup["w"]


def gk_permanent_field(setup):
    """GK reaction field of the permanent multipoles at every site (fid
    assembly, reference :2332-2400), summed over all sources incl. self.
    Contractions written as broadcasts and sums: autograd keeps the
    tensors of setup and small operands, not einsum's copies."""
    t = setup["t"]
    c = setup["charge"]
    d = setup["d"]
    q6w = _q6w(setup)
    # field at i from source j (dipole part): sum_d d_j[d] * gu_g[i,j,d,g]
    f_d = (d[None, :, :, None] * t["gu_g"]).sum(dim=(1, 2))
    # charge part: 0.5 * (c_j * gu1[i,j,g] + c_j * gc[i,j,g])
    f_c = 0.5 * (c[None, :, None] * (t["gu1"] + t["gc"])).sum(dim=1)
    # quadrupole part: 0.5 * (q6_j . (gu_2 + gq_g))
    f_q = 0.5 * (q6w[None, :, None, :] * t["gu_2"]).sum(dim=(1, 3)) \
        + 0.5 * (q6w[None, :, :, None] * t["gq_g"]).sum(dim=(1, 2))
    return f_d + f_c + f_q


def gk_dipole_field(setup, mu):
    """Reaction field of (induced) dipoles mu at every site, incl. self."""
    return (mu[None, :, :, None] * setup["t"]["gu_g"]).sum(dim=(1, 2))


def _dipole_pair(a, b, gu_g):
    """sum_ab a_i[a] b_j[b] gu_g[i,j,a,b] as (n, n)."""
    return ((a[:, None, :, None] * gu_g).sum(dim=2) * b[None, :, :]).sum(-1)


def gk_energy_permanent(setup):
    """esym + 0.5 (ewi + ewk) summed over unordered pairs incl. self
    (reference :3055-3116)."""
    t = setup["t"]
    c = setup["charge"]
    d = setup["d"]
    q6w = _q6w(setup)
    cc = c[:, None] * c[None, :]
    esym = cc * t["gc1"] - _dipole_pair(d, d, t["gu_g"])
    y = (q6w[None, :, None, :] * t["gu_2"]).sum(-1)       # (n, n, 3)
    z = (q6w[:, None, :, None] * t["gq_g"]).sum(2)         # (n, n, 3)
    q2 = (q6w[None, :, None, :] * t["gq_2"]).sum(-1)       # (n, n, 6)
    ewi = (c[:, None] * (d[None, :, :] * t["gc"]).sum(-1)
           - c[None, :] * (d[:, None, :] * t["gu1"]).sum(-1)
           + c[:, None] * (q6w[None, :, :] * t["gc2nd"]).sum(-1)
           + c[None, :] * (q6w[:, None, :] * t["gq1"]).sum(-1)
           - (d[:, None, :] * y).sum(-1)
           + (d[None, :, :] * z).sum(-1)
           + (q6w[:, None, :] * q2).sum(-1))
    # ewk is the role-swapped twin; e(i,j) is symmetric after the 0.5
    # symmetrization, so summing the full matrix with 0.5 off-diagonal
    # weight reproduces the reference's (ii, jj>=ii) loop. ewk(i,j) =
    # ewi(j,i) by construction of the tensors (parity in dr).
    e_pair = esym + 0.5 * (ewi + ewi.transpose(0, 1))
    # reference loop (ii, jj>=ii) with 0.5x self weight == 0.5 * full sum
    return 0.5 * torch.sum(e_pair)


def gk_energy_induced(setup, mu_s):
    """0.5*(esymi_dbl + 0.5*(ewii+ewki)) — the ENERGY contracts the
    solvated induced dipoles u_S directly (the uS+uPS sums appear only in
    the reference's hand-coded force terms; reference :3585-3620, :3919)."""
    t = setup["t"]
    c = setup["charge"]
    d = setup["d"]
    q6w = _q6w(setup)
    s = mu_s
    # esymi is double-sided in the reference; the symmetrized half-sum
    # below restores it from the single-orientation matrix
    esymi = -2.0 * _dipole_pair(d, s, t["gu_g"])
    y = (q6w[None, :, None, :] * t["gu_2"]).sum(-1)
    z = (q6w[:, None, :, None] * t["gq_g"]).sum(2)
    ewii = (c[:, None] * (s[None, :, :] * t["gc"]).sum(-1)
            - c[None, :] * (s[:, None, :] * t["gu1"]).sum(-1)
            - (s[:, None, :] * y).sum(-1)
            + (s[None, :, :] * z).sum(-1))
    e_pair = 0.5 * (esymi + 0.5 * (ewii + ewii.transpose(0, 1)))
    return 0.5 * torch.sum(e_pair)


def cavity_energy(radii, born, probe_radius, surface_area_factor,
                  dielectric_offset=DIELECTRIC_OFFSET):
    """ACE-type surface-area term (reference :4124-4135)."""
    r = radii + dielectric_offset + probe_radius
    ratio = (radii + dielectric_offset) / born
    sa = surface_area_factor * r * r * ratio ** 6
    return -torch.sum(sa) / 6.0
