"""Smooth-PME reciprocal space, forward only: kernel 2 (`pme_spread`),
the FFT convolution, kernel 3 (`pme_gather`) and their plain versions.

Counterpart of openmm_tpu/ops/pme_zslab.py (bspline_w_dw,
convolve_potential, _spread_kernel, _gather_kernel, pme_recip_ef). The JAX
module keeps atoms z-sorted between neighbour rebuilds so that the TPU can
spread and gather plane by plane with matmuls; that z-state, its drift
margins and its span poison exist only to feed the TPU's matrix unit. Here
the spread is an atomic scatter (in 64-bit fixed point, so the grid has
the same bits on every call) and the gather an indexed read, so the
reciprocal space needs no persistent state of its own: the gather may
visit the atoms in the direct space's spatial order (`order`), which the
candidate state keeps anyway, so that the atoms of a warp of kernel 3 read
nearby grid cells; the forces do not depend on the order. The grid layout
is the JAX module's (nz, nx, ny); weight j of an atom on one axis belongs
to grid index floor(u) + j - 4 (mod the grid size).

LJPME's dispersion grid goes through the same two kernels with c6 weights
in place of the charges (the energy is a quadratic form of the grid in
both, so the gather's -w dphi/dr is the force either way; kernel 2 takes
its fixed-point scale from the weights' bound at every call), and its own
influence function (convolve_potential, dispersion=True: JAX pme.py
:455-476). Their launches there count apart (SPREAD_DISPERSION,
GATHER_DISPERSION).
"""
from __future__ import annotations

import functools
import math

import torch

from .. import _build
from ..constants import ONE_4PI_EPS0
from . import geometry as geom
from . import pme as pme_mod

ORDER = 5

SPREAD = _build.Kernel(
    name="pme_spread", source="openmm_tpu_torch/csrc/pme_spread.cu",
    replaces="openmm_tpu/ops/pme_zslab.py:290")
GATHER = _build.Kernel(
    name="pme_gather", source="openmm_tpu_torch/csrc/pme_gather.cu",
    replaces="openmm_tpu/ops/pme_zslab.py:315")
# the same kernels on LJPME's dispersion grid, counted apart
SPREAD_DISPERSION = _build.Kernel(
    name="pme_spread_dispersion", source=SPREAD.source,
    replaces=SPREAD.replaces)
GATHER_DISPERSION = _build.Kernel(
    name="pme_gather_dispersion", source=GATHER.source,
    replaces=GATHER.replaces)


def bspline_w_dw(t: torch.Tensor, order: int = ORDER):
    """(weights, d weights / du), each (..., order): the weights of
    pme.bspline_weights (the recursion the CUDA kernels unroll) and, from
    the order - 1 weights, dM_n(u) = M_{n-1}(u) - M_{n-1}(u - 1)."""
    lower = pme_mod.bspline_weights(t, order - 1)
    zero = torch.zeros_like(lower[..., :1])
    dw = torch.cat([zero, lower], dim=-1) - torch.cat([lower, zero], dim=-1)
    return pme_mod.bspline_weights(t, order), dw


def _grid_weights(pos, binv, grid):
    """Per atom: grid indices (n, 3, 5) and weights, derivative weights
    (n, 3, 5) on each axis (x, y, z)."""
    frac = geom.to_fractional(pos, binv.view(3, 3))
    frac = frac - torch.floor(frac)
    # the grid sizes enter as Python numbers, never as a tensor copied from
    # the host, so this runs inside a captured CUDA graph too
    u = torch.stack([frac[:, a] * grid[a] for a in range(3)], dim=1)
    base = torch.floor(u)
    w, dw = bspline_w_dw(u - base)
    offs = torch.arange(ORDER, device=pos.device) - (ORDER - 1)
    base = base.long()
    idx = torch.stack([torch.remainder(base[:, a, None] + offs, grid[a])
                       for a in range(3)], dim=1)
    return idx, w, dw


def _check_pme_args(pos, charge, binv, *grids):
    n = pos.shape[0]
    if pos.shape != (n, 3) or charge.shape != (n,) or binv.shape != (9,):
        raise ValueError("pos (n, 3), charge (n,) and binv (9,) expected")
    for t in (pos, charge, binv, *grids):
        if t.device != pos.device or t.dtype != pos.dtype \
                or not t.is_contiguous():
            raise ValueError("PME tensors must be contiguous, one device "
                             "and one dtype")


def _flat_index(idx, grid):
    nx, ny, _ = grid
    ix, iy, iz = idx[:, 0], idx[:, 1], idx[:, 2]
    return ((iz[:, None, None, :] * nx + ix[:, :, None, None]) * ny
            + iy[:, None, :, None])                    # (n, jx, jy, jz)


def spread_terms(pos, charge, binv, grid):
    """(flat grid index, value) of every atom's 125 grid contributions."""
    idx, w, _ = _grid_weights(pos, binv, grid)
    val = ((charge[:, None] * w[:, 0])[:, :, None, None]
           * w[:, 1][:, None, :, None] * w[:, 2][:, None, None, :])
    return _flat_index(idx, grid).reshape(-1), val.reshape(-1)


def pme_spread_plain(pos, charge, binv, grid) -> torch.Tensor:
    """Plain version of kernel 2: the (nz, nx, ny) charge grid."""
    _check_pme_args(pos, charge, binv)
    nx, ny, nz = grid
    flat, val = spread_terms(pos, charge, binv, grid)
    q = torch.zeros(nz * nx * ny, dtype=pos.dtype, device=pos.device)
    return q.index_add_(0, flat, val).view(nz, nx, ny)


def pme_spread(pos, charge, binv, grid, counter=SPREAD) -> torch.Tensor:
    """Kernel 2. pos (n, 3), charge (n,), binv the row-major (9,) inverse
    box; returns the (nz, nx, ny) charge grid. A CUDA tensor runs the
    hand-written kernel (float32 only); a CPU tensor the plain version.
    `counter` counts the launch (SPREAD_DISPERSION on the dispersion
    grid)."""
    _check_pme_args(pos, charge, binv)
    if pos.device.type == "cpu":
        return pme_spread_plain(pos, charge, binv, grid)
    if pos.device.type != "cuda" or pos.dtype != torch.float32:
        raise TypeError("the CUDA spread kernel takes float32 CUDA tensors")
    nx, ny, nz = grid
    q = torch.empty((nz, nx, ny), dtype=pos.dtype, device=pos.device)
    acc = _build.fixed_accumulator(nx * ny * nz, pos.device)
    code = _build.library().omm_pme_spread(
        pos.data_ptr(), charge.data_ptr(), binv.data_ptr(), pos.shape[0],
        nx, ny, nz, acc.data_ptr(), q.data_ptr(),
        torch.cuda.current_stream(pos.device).cuda_stream)
    _build.check_launch(code, counter)
    counter.launches += 1
    return q


def _check_order(order, n, device):
    """A visiting order is a contiguous int64 tensor of length n on the
    positions' device. A CPU order is also checked to be a permutation of
    0..n-1; a CUDA one is not (that would wait for the card), and the
    rows of the atoms it does not name are left unwritten."""
    if order is None:
        return
    if (order.shape != (n,) or order.dtype != torch.int64
            or order.device != device or not order.is_contiguous()):
        raise ValueError("order must be a contiguous int64 permutation of "
                         "0..n-1 on the positions' device")
    if device.type == "cpu" and not torch.equal(
            torch.sort(order).values, torch.arange(n)):
        raise ValueError("order is not a permutation of 0..n-1")


def pme_gather_plain(pos, charge, phi2, binv, grid, order=None):
    """Plain version of kernel 3: forces (n, 3) from 2*phi (nz, nx, ny).
    `order` is checked but not read: the forces do not depend on it."""
    _check_pme_args(pos, charge, binv, phi2)
    _check_order(order, pos.shape[0], pos.device)
    nx, ny, nz = grid
    idx, w, dw = _grid_weights(pos, binv, grid)
    v = phi2.reshape(-1)[_flat_index(idx, grid)]        # (n, jx, jy, jz)
    wx, wy, wz = w[:, 0], w[:, 1], w[:, 2]
    gx = torch.einsum("nabc,na,nb,nc->n", v, dw[:, 0], wy, wz)
    gy = torch.einsum("nabc,na,nb,nc->n", v, wx, dw[:, 1], wz)
    gz = torch.einsum("nabc,na,nb,nc->n", v, wx, wy, dw[:, 2])
    ga = torch.stack([gx * nx, gy * ny, gz * nz], dim=1)
    # u_a = n_a frac_a and frac_a = sum_k pos_k binv[k, a]
    return -charge[:, None] * (ga @ binv.view(3, 3).T)


def pme_gather(pos, charge, phi2, binv, grid, order=None,
               counter=GATHER) -> torch.Tensor:
    """Kernel 3: reciprocal-space forces (n, 3) from 2*phi. `order`, an
    int64 permutation of 0..n-1 or None (the identity), is the order in
    which the kernel's threads visit the atoms: in a spatial order the
    atoms of a warp read nearby grid cells. The forces have the same bits
    in any order; on the card, the rows of atoms that an order which is no
    permutation leaves out are undefined (_check_order). A CUDA tensor
    runs the hand-written kernel (float32 only); a CPU tensor the plain
    version. `counter` as in pme_spread."""
    _check_pme_args(pos, charge, binv, phi2)
    _check_order(order, pos.shape[0], pos.device)
    if pos.device.type == "cpu":
        return pme_gather_plain(pos, charge, phi2, binv, grid, order)
    if pos.device.type != "cuda" or pos.dtype != torch.float32:
        raise TypeError("the CUDA gather kernel takes float32 CUDA tensors")
    nx, ny, nz = grid
    if phi2.shape != (nz, nx, ny):
        raise ValueError("phi2 must be (nz, nx, ny)")
    forces = torch.empty_like(pos)
    code = _build.library().omm_pme_gather(
        pos.data_ptr(), charge.data_ptr(), phi2.data_ptr(), binv.data_ptr(),
        None if order is None else order.data_ptr(), pos.shape[0], nx, ny,
        nz, forces.data_ptr(),
        torch.cuda.current_stream(pos.device).cuda_stream)
    _build.check_launch(code, counter)
    counter.launches += 1
    return forces


def convolve_potential(q_grid, box, grid, alpha, bsq_x, bsq_y, bsq_z,
                       dispersion=False):
    """(phi, energy) of the (nz, nx, ny) charge grid on cuFFT (torch.fft).

    energy = sum_m Kt(m) |F(m)|^2 over the full spectrum, Kt folding the
    Ewald Green's function, the B-spline moduli and k_e / (2 pi V). phi is
    the UNNORMALIZED inverse transform of Kt F (no 1/G^3), so dE/dQ = 2 phi
    feeds the force interpolation directly. dispersion=True: the grid holds
    c6 weights and Kt is LJPME's dispersion kernel (pme.dispersion_green),
    its m = 0 term included.
    """
    nx, ny, nz = grid
    dt = q_grid.dtype
    dev = q_grid.device
    bi = geom.box_inverse(box.to(dt))
    f = torch.fft.rfftn(q_grid)                          # (nz, nx, ny//2+1)
    mz = torch.fft.fftfreq(nz, 1.0 / nz, dtype=dt, device=dev)
    mx = torch.fft.fftfreq(nx, 1.0 / nx, dtype=dt, device=dev)
    my = torch.fft.rfftfreq(ny, 1.0 / ny, dtype=dt, device=dev)
    kv = (mz[:, None, None, None] * bi[:, 2]
          + mx[None, :, None, None] * bi[:, 0]
          + my[None, None, :, None] * bi[:, 1])
    m2 = (kv * kv).sum(dim=-1)
    b = (bsq_z[:, None, None] * bsq_x[None, :, None]
         * bsq_y[None, None, :ny // 2 + 1]).to(dt)
    if dispersion:
        kt = pme_mod.dispersion_green(m2, alpha,
                                      geom.box_volume(box.to(dt))) * b
    else:
        m2_safe = torch.where(m2 > 0, m2, 1.0)
        kern = torch.where(m2 > 0, torch.exp(-(math.pi ** 2) * m2_safe
                                             / alpha ** 2) / m2_safe, 0.0)
        kt = ONE_4PI_EPS0 / (2.0 * math.pi * geom.box_volume(box.to(dt))) \
            * kern * b
    # the half spectrum holds each +-m pair once, except the my = 0 and
    # (even ny) Nyquist planes, which are their own partners (made on the
    # device: a scalar stored from the host cannot be captured in a graph)
    my_index = torch.arange(ny // 2 + 1, device=dev)
    mult = torch.where((my_index == 0) | (2 * my_index == ny), 1.0,
                       2.0).to(dt)
    energy = torch.sum(mult * kt * (f.real ** 2 + f.imag ** 2))
    phi = torch.fft.irfftn(kt * f, s=(nz, nx, ny)) * (nx * ny * nz)
    return phi, energy


def pme_recip_ef(pos, charge, box, grid, alpha, bsq, plain=False,
                 order=None, dispersion=False):
    """Reciprocal-space PME (energy, forces (n, 3)) in pos.dtype.
    bsq = (bsq_x, bsq_y, bsq_z) tensors; plain=True runs the plain
    versions of kernels 2 and 3 on any device (the float64 oracle);
    `order` is kernel 3's visiting order (pme_gather). dispersion=True:
    LJPME's dispersion grid, `charge` the c6 weights, the launches counted
    as SPREAD_DISPERSION and GATHER_DISPERSION."""
    dt = pos.dtype
    binv = geom.box_inverse(box.to(dt)).reshape(9).contiguous()
    pos = pos.contiguous()
    charge = charge.to(dt).contiguous()
    if plain:
        spread, gather = pme_spread_plain, pme_gather_plain
    elif dispersion:
        spread = functools.partial(pme_spread, counter=SPREAD_DISPERSION)
        gather = functools.partial(pme_gather, counter=GATHER_DISPERSION)
    else:
        spread, gather = pme_spread, pme_gather
    q_grid = spread(pos, charge, binv, grid)
    phi, energy = convolve_potential(q_grid, box, grid, alpha, *bsq,
                                     dispersion=dispersion)
    forces = gather(pos, charge, (2.0 * phi).contiguous(), binv, grid,
                    order)
    return energy, forces
