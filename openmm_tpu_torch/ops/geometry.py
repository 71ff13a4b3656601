"""Periodic geometry for reduced-form (lower-triangular) boxes.

Counterpart of openmm_tpu/ops/geometry.py. `box` is a (3, 3) tensor whose
rows are the box vectors a, b, c with a = (ax, 0, 0), b = (bx, by, 0) and
c = (cx, cy, cz). Coordinate transforms are written out elementwise rather
than as an (N, 3) x (3, 3) product, so no reduced-precision matmul path
(TF32 on the card) can flip a floor() at a box edge.
"""
from __future__ import annotations

import torch


def periodic_delta(dr: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """Minimum-image displacement by the staged reduction c, then b, then a."""
    dr = dr - box[2] * torch.round(dr[..., 2:3] / box[2, 2])
    dr = dr - box[1] * torch.round(dr[..., 1:2] / box[1, 1])
    dr = dr - box[0] * torch.round(dr[..., 0:1] / box[0, 0])
    return dr


def delta(pos_i: torch.Tensor, pos_j: torch.Tensor,
          box: torch.Tensor | None = None) -> torch.Tensor:
    """pos_i - pos_j, at the minimum image when a box is given."""
    dr = pos_i - pos_j
    return dr if box is None else periodic_delta(dr, box)


def bond_vectors(pos: torch.Tensor, idx: torch.Tensor,
                 box: torch.Tensor | None = None) -> torch.Tensor:
    """pos[idx[:, 0]] - pos[idx[:, 1]] for an (m, 2) index tensor."""
    return delta(pos[idx[:, 0]], pos[idx[:, 1]], box)


def distance(dr: torch.Tensor, eps: float = 1e-24) -> torch.Tensor:
    """|dr| with its square clamped at eps, so that coincident points give
    a zero gradient and not NaN."""
    return torch.sqrt(torch.clamp((dr * dr).sum(dim=-1), min=eps))


def angle_between(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """The angle between v1 and v2 as atan2(|v1 x v2|, v1 . v2)."""
    cross = torch.linalg.cross(v1, v2)
    return torch.atan2(torch.sqrt((cross * cross).sum(dim=-1)),
                       (v1 * v2).sum(dim=-1))


def dihedral_angle(r1, r2, r3, r4, box=None) -> torch.Tensor:
    """The signed dihedral 1-2-3-4 as atan2((n1 x n2) . b2/|b2|, n1 . n2),
    n1 = b1 x b2, n2 = b2 x b3 with b1 = r2 - r1, b2 = r3 - r2,
    b3 = r4 - r3: the sign convention of the JAX package (and of
    ReferenceBondIxn::getDihedralAngleBetweenThreeVectors)."""
    b1 = delta(r2, r1, box)
    b2 = delta(r3, r2, box)
    b3 = delta(r4, r3, box)
    n1 = torch.linalg.cross(b1, b2)
    n2 = torch.linalg.cross(b2, b3)
    b2n = b2 / torch.linalg.vector_norm(b2, dim=-1, keepdim=True)
    x = (n1 * n2).sum(dim=-1)
    y = (torch.linalg.cross(n1, n2) * b2n).sum(dim=-1)
    return torch.atan2(y, x)


def box_volume(box: torch.Tensor) -> torch.Tensor:
    return box[0, 0] * box[1, 1] * box[2, 2]


def box_inverse(box: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of the lower-triangular box matrix."""
    ax = box[0, 0]
    bx, by = box[1, 0], box[1, 1]
    cx, cy, cz = box[2, 0], box[2, 1], box[2, 2]
    inv_ax, inv_by, inv_cz = 1.0 / ax, 1.0 / by, 1.0 / cz
    zero = torch.zeros_like(ax)
    return torch.stack([
        torch.stack([inv_ax, zero, zero]),
        torch.stack([-bx * inv_ax * inv_by, inv_by, zero]),
        torch.stack([(bx * cy - by * cx) * inv_ax * inv_by * inv_cz,
                     -cy * inv_by * inv_cz, inv_cz]),
    ])


def to_fractional(pos: torch.Tensor, box_inv: torch.Tensor) -> torch.Tensor:
    """pos @ box_inv, elementwise."""
    bi = box_inv.to(pos.dtype)
    x, y, z = pos[..., 0], pos[..., 1], pos[..., 2]
    return torch.stack([x * bi[0, 0] + y * bi[1, 0] + z * bi[2, 0],
                        x * bi[0, 1] + y * bi[1, 1] + z * bi[2, 1],
                        x * bi[0, 2] + y * bi[1, 2] + z * bi[2, 2]], dim=-1)


def from_fractional(frac: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """frac @ box, elementwise."""
    b = box.to(frac.dtype)
    x, y, z = frac[..., 0], frac[..., 1], frac[..., 2]
    return torch.stack([x * b[0, 0] + y * b[1, 0] + z * b[2, 0],
                        x * b[0, 1] + y * b[1, 1] + z * b[2, 1],
                        x * b[0, 2] + y * b[1, 2] + z * b[2, 2]], dim=-1)


def wrap_into_box(pos: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """Each position moved to its image in the home box."""
    frac = to_fractional(pos, box_inverse(box))
    return pos - from_fractional(torch.floor(frac), box)
