"""The dense charge spread as one triple contraction: kernels 4
(`spread_triple_fwd`) and 5 (`spread_triple_bwd`), their plain versions,
the autograd Function `spread_triple` whose forward and backward they
are, and `spread_triple_vjp`, kernel 5 as a function that autograd
differentiates again through kernels 4 and 5 (the second derivatives of
the AMOEBA reciprocal space, whose dipole field is itself a gradient).

Counterpart of openmm_tpu/ops/pallas_pme.py (the jax.custom_vjp
spread_triple over _fwd_kernel and _bwd_kernel). The public layout is the
JAX module's: a (N, nx) charge-scaled x-weights, wy (N, ny), wz (N, nz),
and Q as (nx, ny*nz). Unlike the JAX function, N is any size: the kernels
mask the ragged edge, so nothing is padded. Kernel 4 scatters the nonzero
products of each atom's rows in 64-bit fixed point, so Q has the same bits
on every call; kernel 5 computes the dense VJP from each atom's supports
in float32 (the counterpart of Precision.HIGHEST), one warp an atom and no
atomics, so it too gives the same bits on every call. Each takes any grid
below 2^31 cells in one call.
"""
from __future__ import annotations

import torch

from .. import _build

FWD = _build.Kernel(
    name="spread_triple_fwd", source="openmm_tpu_torch/csrc/spread_triple.cu",
    replaces="openmm_tpu/ops/pallas_pme.py:65")
BWD = _build.Kernel(
    name="spread_triple_bwd", source="openmm_tpu_torch/csrc/spread_triple.cu",
    replaces="openmm_tpu/ops/pallas_pme.py:96")


def _check(a, wy, wz, dq=None):
    n, nx = a.shape
    if wy.dim() != 2 or wz.dim() != 2 or wy.shape[0] != n \
            or wz.shape[0] != n:
        raise ValueError("a (N, nx), wy (N, ny) and wz (N, nz) expected")
    ny, nz = wy.shape[1], wz.shape[1]
    if dq is not None and dq.shape != (nx, ny * nz):
        raise ValueError("dq must be (nx, ny*nz) = (%d, %d)"
                         % (nx, ny * nz))
    for t in (a, wy, wz) + ((dq,) if dq is not None else ()):
        if t.device != a.device or t.dtype != a.dtype \
                or not t.is_contiguous():
            raise ValueError("spread tensors must be contiguous, one device "
                             "and one dtype")
    return n, nx, ny, nz


def _cuda_ready(t):
    if t.device.type != "cuda" or t.dtype != torch.float32:
        raise TypeError("the CUDA spread_triple kernels take float32 CUDA "
                        "tensors")


def _check_grid(nx, ny, nz):
    if nx * ny * nz >= 2 ** 31:
        raise ValueError("the spread_triple kernels take grids below 2^31 "
                         "cells")


def spread_triple_plain(a, wy, wz) -> torch.Tensor:
    """Plain version of kernel 4: Q (nx, ny*nz)."""
    _, nx, ny, nz = _check(a, wy, wz)
    return torch.einsum("ix,iy,iz->xyz", a, wy, wz).reshape(nx, ny * nz)


def spread_triple_vjp_plain(dq, a, wy, wz):
    """Plain version of kernel 5: (dA, dWy, dWz) for the cotangent dq."""
    _, nx, ny, nz = _check(a, wy, wz, dq)
    d = dq.reshape(nx, ny, nz)
    return (torch.einsum("xyz,iy,iz->ix", d, wy, wz),
            torch.einsum("xyz,ix,iz->iy", d, a, wz),
            torch.einsum("xyz,ix,iy->iz", d, a, wy))


def spread_triple_fwd(a, wy, wz) -> torch.Tensor:
    """Kernel 4: Q (nx, ny*nz) = sum_i a[i,x] wy[i,y] wz[i,z]. A CUDA
    tensor runs the hand-written kernel (float32 only); a CPU tensor runs
    the plain version."""
    n, nx, ny, nz = _check(a, wy, wz)
    if a.device.type == "cpu":
        return spread_triple_plain(a, wy, wz)
    _cuda_ready(a)
    _check_grid(nx, ny, nz)
    dev = a.device
    out = torch.empty((nx, ny * nz), dtype=a.dtype, device=dev)
    entries = torch.empty((n, nx + ny + nz, 2), dtype=torch.int32,
                          device=dev)
    counts = torch.empty((n, 3), dtype=torch.int32, device=dev)
    acc = _build.fixed_accumulator(nx * ny * nz, dev)
    code = _build.library().omm_spread_triple_fwd(
        a.data_ptr(), wy.data_ptr(), wz.data_ptr(), n, nx, ny, nz,
        entries.data_ptr(), counts.data_ptr(), acc.data_ptr(),
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(code, FWD)
    FWD.launches += 1
    return out


def spread_triple_bwd(dq, a, wy, wz):
    """Kernel 5: (dA (N, nx), dWy (N, ny), dWz (N, nz)) from the cotangent
    dq (nx, ny*nz), in one launch for any grid. A CUDA tensor runs the
    hand-written kernel (float32 only); a CPU tensor runs the plain
    version."""
    n, nx, ny, nz = _check(a, wy, wz, dq)
    if a.device.type == "cpu":
        return spread_triple_vjp_plain(dq, a, wy, wz)
    _cuda_ready(a)
    _check_grid(nx, ny, nz)
    da = torch.empty_like(a)
    dwy = torch.empty_like(wy)
    dwz = torch.empty_like(wz)
    entries = torch.empty((n, nx + ny + nz, 2), dtype=torch.int32,
                          device=a.device)
    transposed = torch.empty((2, nx * ny * nz), dtype=a.dtype,
                             device=a.device)
    code = _build.library().omm_spread_triple_bwd(
        dq.data_ptr(), a.data_ptr(), wy.data_ptr(), wz.data_ptr(), n, nx, ny,
        nz, entries.data_ptr(), transposed.data_ptr(), da.data_ptr(),
        dwy.data_ptr(), dwz.data_ptr(),
        torch.cuda.current_stream(a.device).cuda_stream)
    _build.check_launch(code, BWD)
    BWD.launches += 1
    return da, dwy, dwz


class _SpreadTriple(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, wy, wz):
        ctx.save_for_backward(a, wy, wz)
        return spread_triple_fwd(a, wy, wz)

    @staticmethod
    def backward(ctx, dq):
        return spread_triple_vjp(dq, *ctx.saved_tensors)


class _SpreadTripleVJP(torch.autograd.Function):
    """Kernel 5 as a function of (dq, a, wy, wz), differentiable again.
    Its outputs dA = einsum("xyz,iy,iz->ix"), dWy and dWz are trilinear in
    (dq, rows of a, wy, wz), so the VJP of a cotangent (gA, gWy, gWz) is
    kernel 4 in dq, sum_i spread of (gA, wy, wz), (a, gWy, wz) and
    (a, wy, gWz), and kernel 5 again in a, wy and wz: dWy and dWz of
    (gA, wy, wz), dA and dWz of (a, gWy, wz), dA and dWy of (a, wy, gWz).
    The three spreads go as one launch of kernel 4 over 3N rows, the three
    VJPs as one launch of kernel 5; both are the differentiable functions
    again, so every order of derivative runs on kernels 4 and 5."""

    @staticmethod
    def forward(ctx, dq, a, wy, wz):
        ctx.save_for_backward(dq, a, wy, wz)
        return spread_triple_bwd(dq, a, wy, wz)

    @staticmethod
    def backward(ctx, ga, gwy, gwz):
        dq, a, wy, wz = ctx.saved_tensors
        n = a.shape[0]
        ga = torch.zeros_like(a) if ga is None else ga
        gwy = torch.zeros_like(wy) if gwy is None else gwy
        gwz = torch.zeros_like(wz) if gwz is None else gwz
        rows_a = torch.cat([ga, a, a])
        rows_y = torch.cat([wy, gwy, wy])
        rows_z = torch.cat([wz, wz, gwz])
        ddq = (spread_triple(rows_a, rows_y, rows_z)
               if ctx.needs_input_grad[0] else None)
        x, y, z = spread_triple_vjp(dq, rows_a, rows_y, rows_z)
        return (ddq, x[n:2 * n] + x[2 * n:], y[:n] + y[2 * n:],
                z[:n] + z[n:2 * n])


def spread_triple(a, wy, wz) -> torch.Tensor:
    """Q[x, (y,z)] = sum_i a[i,x] wy[i,y] wz[i,z] as (nx, ny*nz),
    differentiable in a, wy and wz to any order: kernel 4 forward, kernel
    5 backward (spread_triple_vjp)."""
    return _SpreadTriple.apply(a.contiguous(), wy.contiguous(),
                               wz.contiguous())


def spread_triple_vjp(dq, a, wy, wz):
    """Kernel 5's (dA, dWy, dWz) for the cotangent dq (nx, ny*nz),
    differentiable in dq, a, wy and wz to any order (_SpreadTripleVJP):
    the backward of spread_triple, and the gather of a potential grid
    through derivative weights (the AMOEBA dipole fields)."""
    return _SpreadTripleVJP.apply(dq.contiguous(), a.contiguous(),
                                  wy.contiguous(), wz.contiguous())
