"""Distributed 3-D FFT for PME split over a mesh.

Counterpart of openmm_tpu/parallel/fft.py (the textbook decomposition the
JAX package offers for a multi-chip PME): the grid split over the ranks
along z, the (x, y) 2-D FFTs local to each z-plane, an all-to-all
transpose that makes z local (x split), the z-axis 1-D FFTs, and the
reciprocal-space kernel applied in that layout; the inverse retraces the
path. As in the JAX package this is a library function that no step
calls. The local steps are torch.fft (cuFFT on a card) and the transpose
is all_to_all_single, as JAX's are jnp.fft and lax.all_to_all.

Layouts (D = mesh.size), each rank holding its block:
  input  Q (nz, nx, ny), rank r's z-planes [r nz/D, (r+1) nz/D): (nz/D, nx, ny)
  spectrum (nz, nx, ny) transposed, rank r's x-columns: (nz, nx/D, ny)
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _all_to_all(mesh, blocks: torch.Tensor) -> torch.Tensor:
    """blocks (D, ...) complex: block d to rank d; returns (D, ...), block
    s from rank s."""
    if mesh.size == 1:
        return blocks
    send = torch.view_as_real(blocks.contiguous())
    got = torch.empty_like(send)
    dist.all_to_all_single(got, send, group=mesh.group)
    return torch.view_as_complex(got)


def fft3_zsharded(mesh, q: torch.Tensor) -> torch.Tensor:
    """Forward 3-D FFT of the grid whose z-planes this rank holds, q
    (nz/D, nx, ny) real or complex; returns this rank's x-columns of the
    spectrum in the transposed layout, (nz, nx/D, ny) complex64 (complex128
    from float64): the layout of the PME convolution, with no second
    transpose until the inverse."""
    d = mesh.size
    nzl, nx, ny = q.shape
    if nx % d:
        raise ValueError("nx = %d does not split over %d ranks" % (nx, d))
    cdt = torch.complex128 if q.dtype in (torch.float64,
                                          torch.complex128) \
        else torch.complex64
    f = torch.fft.fftn(q.to(cdt), dim=(1, 2))
    # x split over the ranks: z-slabs traded for x-slabs
    blocks = f.reshape(nzl, d, nx // d, ny).movedim(1, 0)
    zloc = _all_to_all(mesh, blocks).reshape(d * nzl, nx // d, ny)
    return torch.fft.fft(zloc, dim=0)


def ifft3_to_zsharded(mesh, fk: torch.Tensor) -> torch.Tensor:
    """Inverse of fft3_zsharded: this rank's x-columns of the spectrum,
    (nz, nx/D, ny); returns its z-planes of the (complex) grid, (nz/D, nx,
    ny)."""
    d = mesh.size
    nz, nxl, ny = fk.shape
    if nz % d:
        raise ValueError("nz = %d does not split over %d ranks" % (nz, d))
    f = torch.fft.ifft(fk, dim=0)
    blocks = f.reshape(d, nz // d, nxl, ny)
    got = _all_to_all(mesh, blocks)
    zsl = got.movedim(0, 1).reshape(nz // d, d * nxl, ny)
    return torch.fft.ifftn(zsl, dim=(1, 2))


def pme_convolve_sharded(mesh, q_grid: torch.Tensor,
                         kernel_zxy: torch.Tensor) -> tuple:
    """E = sum(K |F(Q)|^2) and phi = the unnormalised inverse FFT of
    K F(Q), with this rank's z-planes of the grid Q (nz/D, nx, ny) and its
    x-columns of the spectral kernel K (nz, nx/D, ny). Returns (this
    rank's z-planes of phi, real; E, float64 on every rank). The
    multi-rank twin of ops/pme_zslab.convolve_potential: dE/dQ(r) = 2
    phi(r). The ranks' partial sums of E are gathered into one slot a
    rank and added in rank order, so every rank holds the same bits."""
    fk = fft3_zsharded(mesh, q_grid)
    kf = kernel_zxy.to(fk.real.dtype)
    partial = (kf * (fk.real ** 2 + fk.imag ** 2)).sum(dtype=torch.float64)
    slots = torch.zeros(mesh.size, dtype=torch.float64, device=fk.device)
    slots[mesh.rank] = partial
    if mesh.size > 1:
        dist.all_reduce(slots.view(torch.int64), group=mesh.group)
    energy = slots.sum()
    nz, nx, ny = fk.shape[0], q_grid.shape[1], q_grid.shape[2]
    phi = ifft3_to_zsharded(mesh, kf * fk) * (nz * nx * ny)
    return phi.real, energy
