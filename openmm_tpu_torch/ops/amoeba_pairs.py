"""Pair lists of the AMOEBA real space and per-atom sums over them in a
fixed order.

The JAX package sweeps every (n, n) pair of the AMOEBA forces
(openmm_tpu/forces/amoeba.py) with dense matrices, which at 24,000 atoms
is 288M pairs and 4.6 GB an array. The port sweeps pair lists instead: a
list holds each pair (i < j) once, as two (cap,) int64 index tensors with
a `valid` mask (padding pairs point at atom n, outside the system).

- A NoCutoff force takes every pair, listed once on the host
  (static_pairs).
- A periodic force takes the pairs of AmoebaPairs, which keeps the port's
  candidate state (ops/tile_pairs.py build_tile_state: atoms sorted into
  16-atom bricks, each brick's list of bricks within reach) at the
  largest cutoff plus AMOEBA_SKIN, expands its brick pairs into atom
  pairs and compacts, for each cutoff asked for, the pairs closer than
  that cutoff plus the skin into a list of fixed capacity, its excluded
  pairs (a sorted table of keys, searched) marked invalid. The build has
  static shapes and reads nothing back, so the step program builds it
  under its rebuild gate (an atom moved more than skin/2, or the box
  changed), with the NonbondedForces' candidate states; a list that did
  not fit its capacity counts as the state's overflow, which the Context
  escalates.

The per-atom sums go through `gather` and `segment_sum`, autograd
Functions whose backward passes are each other: a gather's backward is
the segment sum of its cotangent, which reads each atom's entries through
a padded (n, width) table (their positions in a stable sort of the index,
built with the list; entries beyond the width count as the overflow) and
sums them over the table's axis, so the bits are the same on every call.
index_add_, the backward of plain indexing (float atomics) and a
cumulative sum (a decoupled look-back scan) on the card change their
order from call to call, and the step program is held bit for bit
against the eager loop. DipoleField is the induced-dipole field of
the SCF over a pair list, as a Function that saves only the dipoles.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import geometry as geom
from .tile_pairs import BRICK, build_tile_state, sorted_positions, tile_budget

AMOEBA_SKIN = 0.1        # nm
PAIR_MARGIN = 1.25       # capacity over the pairs a uniform density gives
TABLE_MARGIN = 1.3       # an atom's table width over its partners there


def _table(perm, ptr, width, m, pad):
    """(n, width) positions into the sorted rows of each row's segment,
    padded with `pad` (a zero row), and the entries that did not fit."""
    counts = ptr[1:] - ptr[:-1]
    at = ptr[:-1, None] + torch.arange(width, device=ptr.device)
    fits = at < ptr[1:, None]
    if m == 0:
        table = torch.zeros_like(at)
    else:
        table = torch.where(fits, perm[at.clamp(max=m - 1)], pad)
    return table, torch.clamp(counts - width, min=0).sum()


class Plan:
    """An index (m,) into n rows and what sums rows back in a fixed order:
    for each row, the positions of its entries (in the order of a stable
    sort of the index) as one row of a padded (n, width) table. Entries
    equal to n (padding) read row n - 1 and add to no row. `width`
    defaults to the longest segment (read on the host: a fixed list).
    `zero_last`: the index ends with a padding entry whose rows the
    callers keep zero (a pair list's last, invalid pair), which the
    table's padding then reads: no zero row is appended to each sum's
    rows."""

    def __init__(self, idx, n, width=None, zero_last=False):
        self.n = n
        self.idx = idx
        self.read = idx.clamp(max=n - 1)
        self.zero_last = zero_last
        perm = torch.argsort(idx, stable=True)
        ptr = torch.searchsorted(idx[perm],
                                 torch.arange(n + 1, device=idx.device))
        if width is None:
            width = max(1, int((ptr[1:] - ptr[:-1]).max()) if n else 1)
        m = idx.shape[0]
        self.table, self.overflow = _table(perm, ptr, max(1, int(width)), m,
                                           m - 1 if zero_last else m)

    @staticmethod
    def from_state(state, key, n, zero_last=True):
        plan = Plan.__new__(Plan)
        plan.n = n
        plan.idx = state[key]
        plan.read = state[key].clamp(max=n - 1)
        plan.zero_last = zero_last
        plan.table = state[key + "_table"]
        return plan

    def tensors(self, key) -> dict:
        return {key: self.idx, key + "_table": self.table}


def _segsum(v, plan):
    """Each row's entries summed over its row of the table, in their
    order (a reduction over a tensor axis: the same bits on every call;
    a cumulative sum or index_add_ on the card is not)."""
    rows = v if plan.zero_last else torch.cat(
        [v, v.new_zeros((1,) + v.shape[1:])])
    return rows[plan.table].sum(dim=1)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan = plan
        return x[plan.read]

    @staticmethod
    def backward(ctx, g):
        return _SegmentSum.apply(g, ctx.plan), None


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, plan):
        ctx.plan = plan
        return _segsum(v, plan)

    @staticmethod
    def backward(ctx, g):
        return _Gather.apply(g, ctx.plan), None


def gather(x, plan):
    """x[plan.idx] (padding entries read row n - 1); its backward is a
    fixed-order segment sum."""
    return _Gather.apply(x, plan)


def segment_sum(v, plan):
    """(n, ...) sums of the rows v (m, ...) by plan.idx, in a fixed order
    (padding entries add to no row)."""
    return _SegmentSum.apply(v, plan)


def _dot(a, b):
    return (a * b).sum(dim=-1)


def _pair_field(mu_src, dr, k2, k3):
    return 3.0 * (k3 * _dot(mu_src, dr))[:, None] * dr - k2[:, None] * mu_src


class _DipoleField(torch.autograd.Function):
    """field_i = sum over the pairs (i, j) of T mu_j, and field_j of
    T mu_i, T = 3 k3 dr dr^T - k2 I (symmetric): what the SCF sweeps. Saves
    the dipoles only; the pair tensors (dr, k2, k3) are the caller's and
    saved once for every sweep."""

    @staticmethod
    def forward(ctx, mu, dr, k2, k3, pi, pj):
        ctx.save_for_backward(mu, dr, k2, k3)
        ctx.plans = (pi, pj)
        return (_segsum(_pair_field(mu[pj.read], dr, k2, k3), pi)
                + _segsum(_pair_field(mu[pi.read], dr, k2, k3), pj))

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        mu, dr, k2, k3 = ctx.saved_tensors
        pi, pj = ctx.plans
        mu_i, mu_j = mu[pi.read], mu[pj.read]
        g_i, g_j = g[pi.read], g[pj.read]
        tmi, tmj = _dot(mu_i, dr), _dot(mu_j, dr)
        tgi, tgj = _dot(g_i, dr), _dot(g_j, dr)
        d_k3 = 3.0 * (tmj * tgi + tmi * tgj)
        d_k2 = -(_dot(mu_j, g_i) + _dot(mu_i, g_j))
        d_dr = (3.0 * k3)[:, None] * (tmj[:, None] * g_i + tgi[:, None] * mu_j
                                      + tmi[:, None] * g_j
                                      + tgj[:, None] * mu_i)
        d_mu = (_segsum(_pair_field(g_j, dr, k2, k3), pi)
                + _segsum(_pair_field(g_i, dr, k2, k3), pj))
        return d_mu, d_dr, d_k2, d_k3, None, None


def dipole_field(mu, dr, k2, k3, pi, pj):
    """The field at every atom of the dipoles mu through the pair
    tensors T = 3 k3 dr dr^T - k2 I of the pairs (pi, pj)."""
    return _DipoleField.apply(mu, dr, k2, k3, pi, pj)


def pair_plans(state, prefix, n):
    """(i plan, j plan, valid) of the pair list `prefix` in `state`."""
    return (Plan.from_state(state, prefix + "i", n),
            Plan.from_state(state, prefix + "j", n),
            state[prefix + "valid"])


def list_tensors(prefix, i, j, valid, n, width=None) -> tuple:
    """(the state tensors of the pair list (i, j), which ends with an
    invalid padding pair (n, n), with its i and j plans, the entries
    their tables could not hold)."""
    out = {prefix + "valid": valid}
    pi = Plan(i, n, width, zero_last=True)
    pj = Plan(j, n, width, zero_last=True)
    out.update(pi.tensors(prefix + "i"))
    out.update(pj.tensors(prefix + "j"))
    return out, pi.overflow + pj.overflow


def static_pairs(i, j, n, device) -> dict:
    """A pair list of fixed pairs (numpy (m,) each) and a padding pair
    as state tensors."""
    ti = torch.as_tensor(np.append(np.asarray(i, np.int64), n),
                         device=device)
    tj = torch.as_tensor(np.append(np.asarray(j, np.int64), n),
                         device=device)
    return list_tensors("", ti, tj, tj < n, n)[0]


class AmoebaPairs:
    """The pair lists of the periodic AMOEBA forces of a Context: one
    candidate state at the largest cutoff plus the skin, one list a
    cutoff (add). The Context's rebuild gate builds them (build_state) as
    it builds a NonbondedForce's candidate state; capacity_scale grows
    them after an overflow."""

    def __init__(self, n, box, device):
        self.n = n
        self.device = device
        self.widths = [float(box[0][0]), float(box[1][1]), float(box[2][2])]
        self.vol = self.widths[0] * self.widths[1] * self.widths[2]
        self.skin = AMOEBA_SKIN
        self.capacity_scale = 1.0
        self.cutoffs = {}
        self.excluded = {}      # name -> sorted keys i * n + j (i < j)

    def check(self, cutoff) -> None:
        if cutoff > 0.5 * min(self.widths):
            raise ValueError("the AMOEBA cutoff must be below half the box "
                             "width")

    def add(self, name, cutoff, exclusions=None) -> str:
        """Ask for the list of pairs within `cutoff`, without the pairs
        (i < j) of `exclusions` ((m, 2) numpy), which its build marks
        invalid; returns its key prefix in the state."""
        self.cutoffs[name] = float(cutoff)
        keys = np.zeros(0, np.int64)
        if exclusions is not None and len(exclusions):
            e = np.sort(np.asarray(exclusions, np.int64).reshape(-1, 2),
                        axis=1)
            keys = np.unique(e[:, 0] * self.n + e[:, 1])
        self.excluded[name] = torch.as_tensor(keys, device=self.device)
        return name + "_"

    def _per_atom(self, cutoff) -> float:
        r = cutoff + self.skin
        return self.n / self.vol * 4.0 / 3.0 * math.pi * r ** 3

    def capacity(self, cutoff) -> int:
        full = self.n * (self.n - 1) // 2
        return min(full, int(PAIR_MARGIN * self.capacity_scale * 0.5
                             * self.n * self._per_atom(cutoff))) + 64

    def width(self, cutoff) -> int:
        """The per-atom table width: an atom's partners within the
        reach (in the i or the j role), at a margin."""
        return min(self.n, int(TABLE_MARGIN * self.capacity_scale
                               * self._per_atom(cutoff)) + 32)

    def build_state(self, pos, box) -> dict:
        n, dev = self.n, pos.device
        far = max(self.cutoffs.values())
        budget = tile_budget(n, self.widths, far, self.skin,
                             self.capacity_scale)
        p32 = pos.to(torch.float32)
        none = torch.zeros((n, 0), dtype=torch.int64, device=dev)
        zero = torch.zeros(n, dtype=torch.float32, device=dev)
        st = build_tile_state(p32, box, zero, zero + 1.0, zero, none,
                              far + self.skin, budget["max_bricks"],
                              budget["sort_cell"], box_widths=self.widths)
        cand = st["cand"].long()
        nb, mc = cand.shape
        order = st["order"]
        ps = sorted_positions(p32, box, st)[:, :3].reshape(nb, BRICK, 3)
        lane = torch.arange(BRICK, device=dev)
        d = ps[:, None, :, None, :] - ps[cand][:, :, None, :, :]
        d = geom.periodic_delta(d, box.to(torch.float32))
        r2 = (d * d).sum(dim=-1)                        # (nb, mc, 16, 16)
        del d
        oi = order.view(nb, BRICK)[:, None, :, None]
        oj = order[cand[:, :, None] * BRICK + lane][:, :, None, :]
        live = (torch.arange(mc, device=dev)[None, :]
                < st["count"].long()[:, None])[:, :, None, None]
        base = live & (oi < oj) & (oj < n)
        shape = base.shape
        oi = oi.expand(shape).reshape(-1)
        oj = oj.expand(shape).reshape(-1)
        out = {"overflow": st["overflow"]}
        for name, cutoff in self.cutoffs.items():
            keep = (base & (r2 < (cutoff + self.skin) ** 2)).reshape(-1)
            cap = self.capacity(cutoff)
            slot = torch.cumsum(keep, dim=0) - 1
            total = slot[-1] + 1
            # slots 0..cap-1 hold pairs, slot cap stays the padding pair,
            # slot cap + 1 takes what does not fit (and is dropped)
            dest = torch.where(keep & (slot < cap), slot, cap + 1)
            pi = torch.full((cap + 2,), n, dtype=torch.int64, device=dev)
            pj = torch.full((cap + 2,), n, dtype=torch.int64, device=dev)
            pi.scatter_(0, dest, oi)
            pj.scatter_(0, dest, oj)
            pi, pj = pi[:cap + 1].contiguous(), pj[:cap + 1].contiguous()
            valid = pj < n
            keys = self.excluded[name]
            if keys.numel():
                key = pi * n + pj
                at = torch.searchsorted(keys, key).clamp(max=keys.numel() - 1)
                valid = valid & (keys[at] != key)
            tensors, spill = list_tensors(name + "_", pi, pj, valid, n,
                                          self.width(cutoff))
            out.update(tensors)
            out["overflow"] = (out["overflow"] + spill
                               + torch.clamp(total - cap, min=0))
        return out
