"""The pair sweep of a CustomNonbondedForce: energy, analytic forces and
energy parameter derivatives of a pair function, with no float atomics.

Counterpart of openmm_tpu/forces/custom.py _custom_pair_sum, which sums
the pair energy over every unordered pair of the padded system (i < j,
the lower index the expression's particle 1) and masks the pairs that no
interaction group allows, taking forces by jax.grad. The sweep here gives
the same sum with less work: each block is one interaction group's set1
(rows) against its set2 (columns), so 64 decoupled waters of a
24,000-atom box cost 192 x 24,000 pairs, not 24,000^2; without groups
there is one block, every atom against every atom. A pair that several
blocks hold counts in the first of them, in the JAX order (group by
group; within a group whose sets overlap, from the lower index's row), so
each allowed pair counts once, as in the masked sum; the expression takes
the row as particle 1 and must be symmetric in its particles, as OpenMM
requires of it. Rows go in chunks of at most PAIR_CHUNK pairs; a pair's
force goes to its row atom by a sum over the columns and to its column
atom by a sum over the rows, both float64 reductions over fixed
dimensions, written into the (n, 3) forces by index_copy of distinct
atoms: the same bits on every run.
"""
from __future__ import annotations

import numpy as np
import torch

from . import geometry as geom
from .pairs import build_exclusion_table

F64 = torch.float64
# pair elements of a chunk of rows: one chunk for a 64-water solute
# against a 24,000-atom solvent (192 x 23,808)
PAIR_CHUNK = 1 << 23


class _Block:
    """One interaction group's rows and columns (device index tensors),
    its bit, and whether its rule needs the earlier groups' bits or the
    orientation of pairs both of whose atoms lie in both sets."""

    def __init__(self, rows, cols, bit, earlier, overlap, n, device):
        self.rows = torch.as_tensor(rows, dtype=torch.int64, device=device)
        self.cols = torch.as_tensor(cols, dtype=torch.int64, device=device)
        self.bit = bit
        self.earlier = earlier
        self.overlap = overlap
        # each atom's column position, len(cols) for an atom not a column
        pos = np.full(n + 1, len(cols), np.int64)
        pos[np.asarray(cols, np.int64)] = np.arange(len(cols))
        self.col_pos = torch.as_tensor(pos, device=device)
        width = max(1, PAIR_CHUNK // max(len(cols), 1))
        self.chunks = [(r0, min(len(rows), r0 + width))
                       for r0 in range(0, len(rows), width)]


class PairSweep:
    """The blocks of one CustomNonbondedForce: `groups` a list of (set1,
    set2) (at most 32), or empty for every pair; `exclusions` the excluded
    pairs."""

    def __init__(self, n, groups, exclusions, device):
        self.n = n
        if len(groups) > 32:
            raise ValueError("at most 32 interaction groups supported")
        if not groups:
            groups = [(range(n), range(n))]
        s1 = np.zeros(n, np.int64)
        s2 = np.zeros(n, np.int64)
        for g, (set1, set2) in enumerate(groups):
            s1[list(set1)] |= 1 << g
            s2[list(set2)] |= 1 << g
        self.s1 = torch.as_tensor(s1, device=device)
        self.s2 = torch.as_tensor(s2, device=device)
        self.blocks = [
            _Block(sorted(set1), sorted(set2), 1 << g, g > 0,
                   bool(set(set1) & set(set2)), n, device)
            for g, (set1, set2) in enumerate(groups)
            if len(set1) and len(set2)]
        table = build_exclusion_table(n, exclusions)
        self.has_exclusions = bool(np.any(table >= 0))
        self.exclusions = torch.as_tensor(
            np.where(table >= 0, table, n), dtype=torch.int64,
            device=device)

    def _keep(self, block, rows, cols):
        """(rows, cols) bool: the pairs this block counts."""
        keep = rows[:, None] != cols[None, :]
        if block.earlier or block.overlap:
            i1, i2 = self.s1[rows][:, None], self.s2[rows][:, None]
            j1, j2 = self.s1[cols][None, :], self.s2[cols][None, :]
            if block.earlier:
                lower = block.bit - 1
                keep = keep & ((((i1 & j2) | (i2 & j1)) & lower) == 0)
            if block.overlap:
                # (j, i) is this block's pair too: count it from the lower
                # index's row
                twice = ((i2 & j1) & block.bit) != 0
                keep = keep & ~(twice & (rows[:, None] > cols[None, :]))
        if self.has_exclusions:
            skip = torch.zeros((rows.shape[0], cols.shape[0] + 1),
                               dtype=torch.bool, device=rows.device)
            skip.scatter_(1, block.col_pos[self.exclusions[rows]], True)
            keep = keep & ~skip[:, :-1]
        return keep

    def __call__(self, pos, box, pair_fn, cutoff, n_derivs=0,
                 dtype=F64):
        """(energy float64 scalar, forces (n, 3) float64, [dE/dparameter
        float64 scalars] * n_derivs) of pair_fn over the kept pairs at
        r < cutoff (None: every pair); box None without periodic images.
        Each pair's displacement is taken from the float64 positions and
        rounded to `dtype`, the precision of the pair function:
        pair_fn(r, rows, cols) -> (E, dE/dr, [dE/dparameter]), each
        (rows, cols) in dtype or a number; r is 1 at pairs not kept. (A
        float32 displacement of atoms far from the origin would carry
        their positions' rounding, which the r^-12 of a Lennard-Jones
        term multiplies twelve times.)"""
        dev = pos.device
        energy = torch.zeros((), dtype=F64, device=dev)
        derivs = [torch.zeros((), dtype=F64, device=dev)
                  for _ in range(n_derivs)]
        forces = torch.zeros((self.n, 3), dtype=F64, device=dev)
        for block in self.blocks:
            cols = block.cols
            col_f = torch.zeros((cols.shape[0], 3), dtype=F64, device=dev)
            for r0, r1 in block.chunks:
                rows = block.rows[r0:r1]
                dr = pos[rows][:, None, :] - pos[cols][None, :, :]
                if box is not None:
                    dr = geom.periodic_delta(dr, box)
                dr = dr.to(dtype)
                dx, dy, dz = dr.unbind(-1)
                r2 = dx * dx + dy * dy + dz * dz
                keep = self._keep(block, rows, cols)
                if cutoff is not None:
                    keep = keep & (r2 < cutoff * cutoff)
                r = torch.sqrt(torch.where(keep, r2, 1.0))
                e, de_dr, de_dp = pair_fn(r, rows, cols)
                energy = energy + torch.where(keep, e, 0.0).sum(dtype=F64)
                for k, d in enumerate(de_dp):
                    derivs[k] = derivs[k] + torch.where(
                        keep, d, 0.0).sum(dtype=F64)
                # the force on the row atom: -dE/dr dr / r
                g = torch.where(keep, de_dr / r, 0.0)[..., None] * dr
                row_f = -g.sum(dim=1, dtype=F64)
                col_f = col_f + g.sum(dim=0, dtype=F64)
                forces = forces.index_copy(0, rows, forces[rows] + row_f)
            forces = forces.index_copy(0, cols, forces[cols] + col_f)
        return energy, forces, derivs


def switch(r, e, de_dr, rs, cutoff):
    """(E S, d(E S)/dr, S) with the switch S = 1 - t^3 (10 - 15 t + 6 t^2),
    t = max(r - rs, 0) / (cutoff - rs), as the JAX package applies it."""
    inv_w = 1.0 / (cutoff - rs)
    t = torch.clamp(r - rs, min=0.0) * inv_w
    t2 = t * t
    s = 1.0 - t2 * t * (10.0 - 15.0 * t + 6.0 * t2)
    ds = -30.0 * t2 * (1.0 - t) * (1.0 - t) * inv_w
    return e * s, de_dr * s + e * ds, s
