"""The yardstick of the kernels' roofline shares: the operations and bytes
that the problem needs, whatever implements it, and the peaks of the chip.

The constants are copies of the port's chip_smoke.py arithmetic (operations
a pair and an atom, the published peaks); the pair count is this module's
own cell list over the positions, and no count of the program (candidate
slots, tiles, capacity) enters.
"""
from __future__ import annotations

import math

import numpy as np
import torch

# published peaks of one NVIDIA H100 SXM (data sheet, dense): float32
# outside the tensor cores, and HBM bandwidth; they assume 700 W
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12

# float operations (an FMA counts 2) each function needs, at least.
# Kernel 1, a distinct pair inside the cutoff: the minimum image and r^2
# (24), Lennard-Jones (16), the Ewald erfc and its force (29), the force
# applied to both atoms and the energy summed (11)
OPS_PER_PAIR = 80.0
# kernels 2-3, an atom and an axis: the fractional coordinate, the base and
# the order-5 weights by recursion (55), with their derivatives (60)
OPS_WEIGHTS, OPS_WEIGHTS_DW = 55.0, 60.0
# kernel 2, an atom: q wx (5), x wy (25), x wz (125), 125 additions
OPS_SPREAD = 5.0 + 25.0 + 125.0 + 125.0
# kernel 3, an atom, one axis at a time: over y the weights and derivatives
# against 25 rows of 5, over x the three sums the forces need, over z, then
# the chain rule to Cartesian forces (21)
OPS_GATHER = 2 * (2 * 25 * 5 + 3 * 5 * 5 + 3 * 5) + 21.0
FLOAT = 4                       # bytes of a float32


def least_seconds(nbytes: float, flops: float) -> tuple[float, str]:
    """(seconds, "bytes" or "operations"): the larger of the bytes over
    the bandwidth and the operations over the float32 peak."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FP32_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nonbonded_work(n_atoms: int, pairs: int) -> tuple[float, float]:
    """(bytes, operations) of the direct space: positions and parameters
    (charge, sigma, epsilon) read once, forces and the energy written once,
    and OPS_PER_PAIR for each pair within the cutoff."""
    nbytes = FLOAT * (n_atoms * (3 + 3) + 9 + n_atoms * 3 + 1)
    return nbytes, OPS_PER_PAIR * pairs


def spread_work(n_atoms: int, grid) -> tuple[float, float]:
    """(bytes, operations) of the charge spread: positions and charges and
    the box read, the grid written."""
    return (FLOAT * (4 * n_atoms + 9 + math.prod(grid)),
            n_atoms * (3 * OPS_WEIGHTS + OPS_SPREAD))


def gather_work(n_atoms: int, grid) -> tuple[float, float]:
    """(bytes, operations) of the force gather: positions, charges, the
    box and the potential grid read, the forces written."""
    return (FLOAT * (4 * n_atoms + 9 + math.prod(grid) + 3 * n_atoms),
            n_atoms * (3 * OPS_WEIGHTS_DW + OPS_GATHER))


# the 13 neighbour cells of a half shell, plus the cell itself
_HALF_SHELL = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
               for dz in (-1, 0, 1) if (dx, dy, dz) > (0, 0, 0)]


def count_pairs(positions, box_widths, cutoff: float) -> int:
    """The distinct pairs i < j closer than `cutoff` (minimum images) in a
    rectangular periodic box, by a cell list of cells no narrower than
    the cutoff (three or more along each axis). positions: (n, 3) tensor or
    array, nm."""
    pos = torch.as_tensor(positions, dtype=torch.float64)
    widths = torch.as_tensor(np.array(box_widths, float), dtype=torch.float64,
                             device=pos.device)
    cells = torch.clamp(torch.floor(widths / cutoff), min=1).long()
    if int(cells.min()) < 3:
        raise ValueError("count_pairs needs three cells along each axis")
    frac = torch.remainder(pos / widths, 1.0)
    idx = torch.minimum((frac * cells).long(), cells - 1)
    nc = [int(c) for c in cells]
    flat = (idx[:, 0] * nc[1] + idx[:, 1]) * nc[2] + idx[:, 2]
    order = torch.argsort(flat)
    flat_sorted = flat[order]
    n_cells = nc[0] * nc[1] * nc[2]
    counts = torch.bincount(flat_sorted, minlength=n_cells)
    start = torch.cumsum(counts, 0) - counts
    width = int(counts.max())
    slot = torch.arange(pos.shape[0], device=pos.device) - start[flat_sorted]
    table = torch.full((n_cells, width), -1, dtype=torch.long,
                       device=pos.device)
    table[flat_sorted, slot] = order
    cell_xyz = torch.stack(torch.meshgrid(
        *(torch.arange(c, device=pos.device) for c in nc), indexing="ij"),
        dim=-1).reshape(-1, 3)
    rc2 = cutoff * cutoff
    total = 0
    for offset in [(0, 0, 0)] + _HALF_SHELL:
        other = torch.remainder(cell_xyz + torch.tensor(offset,
                                                        device=pos.device),
                                cells)
        other = (other[:, 0] * nc[1] + other[:, 1]) * nc[2] + other[:, 2]
        a, b = table, table[other]
        pa = pos[a.clamp(min=0)]
        pb = pos[b.clamp(min=0)]
        d = pb[:, None, :, :] - pa[:, :, None, :]
        d -= widths * torch.round(d / widths)
        near = (d * d).sum(-1) < rc2
        near &= (a >= 0)[:, :, None] & (b >= 0)[:, None, :]
        if offset == (0, 0, 0):
            near &= a[:, :, None] < b[:, None, :]
        total += int(near.sum())
    return total
