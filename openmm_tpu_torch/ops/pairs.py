"""Neighbour-list helpers: spatial sort keys, the rebuild predicate and the
exclusion table.

Counterpart of openmm_tpu/ops/pairs.py (build_exclusion_table,
spatial_sort_keys, needs_rebuild; the rebuild predicate here also
fires on a change of the box).
"""
from __future__ import annotations

import numpy as np
import torch

from . import geometry as geom


def pad_to_block(n: int, block: int) -> int:
    return ((n + block - 1) // block) * block


def build_exclusion_table(n_atoms: int, exclusion_pairs,
                          pad_multiple: int = 2) -> np.ndarray:
    """(n_atoms, E) int32 per-atom excluded partners, -1 padded."""
    excl = [[] for _ in range(n_atoms)]
    for i, j in exclusion_pairs:
        excl[int(i)].append(int(j))
        excl[int(j)].append(int(i))
    max_e = max((len(e) for e in excl), default=0)
    max_e = max(1, ((max_e + pad_multiple - 1) // pad_multiple) * pad_multiple)
    table = np.full((n_atoms, max_e), -1, dtype=np.int32)
    for i, e in enumerate(excl):
        table[i, :len(e)] = sorted(e)
    return table


def spatial_sort_keys(pos: torch.Tensor, box: torch.Tensor, n_real: int,
                      cell_size: float, widths=None) -> torch.Tensor:
    """Sort key that makes runs of atoms spatially compact: cells of half
    `cell_size` grouped into 2x2x2 bricks, bricks in snake order, cells in
    a brick in Morton order. Padding atoms sort last. The cell counts come
    from `widths`, the box's diagonal as Python floats in box.dtype, so
    that the key reads nothing back from the device; without them the
    diagonal is read from `box` (a host read when box is on a card)."""
    n_pad = pos.shape[0]
    cell_size = 0.5 * cell_size
    wrapped = geom.wrap_into_box(pos, box)
    if widths is None:
        widths = box.diagonal().to(torch.float64).tolist()
    ncx, ncy, ncz = (2 * max(int(round(w / (2 * cell_size))), 1)
                     for w in widths)

    def cell(axis, nc):
        c = torch.floor(wrapped[:, axis] * (nc / box[axis, axis]))
        return torch.clamp(c.to(torch.int64), 0, nc - 1)

    cx, cy, cz = cell(0, ncx), cell(1, ncy), cell(2, ncz)
    bx, ox = cx // 2, cx % 2
    by, oy = cy // 2, cy % 2
    bz, oz = cz // 2, cz % 2
    nby, nbz = (ncy + 1) // 2, (ncz + 1) // 2
    by_eff = torch.where(bx % 2 == 1, nby - 1 - by, by)
    col = bx * nby + by_eff
    bz_eff = torch.where(col % 2 == 1, nbz - 1 - bz, bz)
    key = (col * nbz + bz_eff) * 8 + (ox * 4 + oy * 2 + oz)
    pad = torch.arange(n_pad, device=pos.device) >= n_real
    return torch.where(pad, torch.iinfo(torch.int64).max, key)


def needs_rebuild(pos: torch.Tensor, ref_pos: torch.Tensor, skin: float,
                  box: torch.Tensor, ref_box: torch.Tensor) -> torch.Tensor:
    """True when any atom moved more than skin/2 since the last build, or
    when the box differs from the box of that build: a candidate state
    kept across a barostat's move could miss pairs without overflowing.
    The JAX refresher tests displacement alone."""
    d = pos - ref_pos
    moved = torch.max(torch.sum(d * d, dim=-1)) > (0.5 * skin) ** 2
    return moved | torch.any(box != ref_box)
