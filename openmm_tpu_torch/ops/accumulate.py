"""Per-atom sums of per-term contributions by gathers, in a fixed order.

A force made of terms over a few atoms each (bonds, angles, torsions,
exception pairs) computes one contribution per (term, slot) and must add
the contributions of each atom. index_add_ does that with float atomics
on a card, whose order (and so whose bits) changes from call to call; the
step program is held bit for bit against the eager loop, so the port adds
by gathers instead: a table built once on the host lists, for each atom
that appears in any term, the flat (term, slot) positions it holds, in
increasing order and padded with a position that reads a zero row. The
sum over the table's columns has a fixed order on every device. This is
the pattern of the JAX CCMA's `distribute`
(openmm_tpu/ops/constraints.py, make_ccma).
"""
from __future__ import annotations

import numpy as np
import torch


class GatherSum:
    """Sums (m, k, 3) per-slot contributions of terms over the atoms of an
    (m, k) index array into an (n, 3) tensor."""

    def __init__(self, idx, n_atoms: int, device):
        idx = np.asarray(idx, np.int64)
        flat = idx.reshape(-1)
        self.n = int(n_atoms)
        self.size = flat.size                  # the zero row's position
        atoms, counts = np.unique(flat, return_counts=True)
        width = int(counts.max()) if counts.size else 1
        order = np.argsort(flat, kind="stable")
        starts = np.cumsum(counts) - counts
        rank = np.arange(flat.size) - np.repeat(starts, counts)
        table = np.full((atoms.size, width), self.size, np.int64)
        table[np.searchsorted(atoms, flat[order]), rank] = order
        self.atoms = torch.as_tensor(atoms, device=device)
        self.table = torch.as_tensor(table, device=device)

    def __call__(self, contrib: torch.Tensor) -> torch.Tensor:
        """(n, 3) sums of contrib (m, k, 3) (or (m * k, 3)) per atom; zero
        for atoms in no term."""
        rows = contrib.reshape(-1, contrib.shape[-1])
        rows = torch.cat([rows, rows.new_zeros((1, rows.shape[1]))])
        sums = rows[self.table].sum(dim=1)
        out = rows.new_zeros((self.n, rows.shape[1]))
        return out.index_copy_(0, self.atoms, sums)


class GroupSum:
    """Sums (n, k) per-atom rows into (groups, k) by each atom's group (a
    molecule), in a fixed order. The groups are bucketed by size, each
    bucket's width the next power of two of its sizes, so the padding
    stays under twice the atoms whatever the molecules (one protein of
    thousands of atoms beside thousands of waters); a bucket is one gather
    table of its groups' member atoms, in increasing order, padded with
    a position that reads a zero row, and its rows are summed over the
    table's columns. No float atomics: the same bits on every call."""

    def __init__(self, group_id, n_groups: int, device):
        group_id = np.asarray(group_id, np.int64)
        self.n_groups = int(n_groups)
        self.pad = group_id.size               # the zero row's position
        self.group_id = torch.as_tensor(group_id, device=device)
        sizes = np.bincount(group_id, minlength=self.n_groups)
        order = np.argsort(group_id, kind="stable")
        starts = np.cumsum(sizes) - sizes
        width = 1 << np.ceil(np.log2(np.maximum(sizes, 1))).astype(np.int64)
        self.buckets = []
        for w in np.unique(width):
            groups = np.nonzero(width == w)[0]
            table = np.full((groups.size, int(w)), self.pad, np.int64)
            for row, g in enumerate(groups):
                table[row, :sizes[g]] = order[starts[g]:starts[g] + sizes[g]]
            self.buckets.append((torch.as_tensor(groups, device=device),
                                 torch.as_tensor(table, device=device)))

    def __call__(self, rows: torch.Tensor) -> torch.Tensor:
        """(groups, k) sums of the rows (n, k) of each group's atoms."""
        rows = torch.cat([rows, rows.new_zeros((1, rows.shape[1]))])
        out = rows.new_empty((self.n_groups, rows.shape[1]))
        for groups, table in self.buckets:
            out.index_copy_(0, groups, rows[table].sum(dim=1))
        return out
