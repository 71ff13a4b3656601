"""The dense charge spread as one triple contraction: kernels 4
(`spread_triple_fwd`) and 5 (`spread_triple_bwd`), their plain versions,
and the autograd Function `spread_triple` whose forward and backward they
are.

Counterpart of openmm_tpu/ops/pallas_pme.py (the jax.custom_vjp
spread_triple over _fwd_kernel and _bwd_kernel). The public layout is the
JAX module's: a (N, nx) charge-scaled x-weights, wy (N, ny), wz (N, nz),
and Q as (nx, ny*nz). Unlike the JAX function, N is any size: the kernels
mask the ragged edge, so nothing is padded. The kernels compute in float32
on the CUDA cores (the counterpart of Precision.HIGHEST).
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

# largest grid axis the backward kernel's shared-memory layout takes
MAX_AXIS = 128
# the forward kernel's output tile edge and the block tiles it aims for per
# SM when it splits the atom axis
_TILE = 64
_BLOCKS_PER_SM = 4


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


def fwd_splits(n, nx, ny, nz, sm_count) -> int:
    """How many slices kernel 4 cuts the atom axis into: enough block
    tiles for _BLOCKS_PER_SM per SM, at least one 32-atom step each."""
    tiles = -(-nx // _TILE) * -(-(ny * nz) // _TILE)
    want = -(-_BLOCKS_PER_SM * sm_count // tiles)
    return max(1, min(want, -(-n // 32)))


def spread_triple_fwd(a, wy, wz) -> torch.Tensor:
    """Kernel 4: Q (nx, ny*nz) = sum_i a[i,x] wy[i,y] wz[i,z]. A CUDA
    tensor runs the hand-written kernel (float32 only); a CPU tensor runs
    the plain version."""
    n, nx, ny, nz = _check(a, wy, wz)
    if a.device.type == "cpu":
        return spread_triple_plain(a, wy, wz)
    _cuda_ready(a)
    dev = a.device
    splits = fwd_splits(n, nx, ny, nz,
                        torch.cuda.get_device_properties(dev)
                        .multi_processor_count)
    out = torch.empty((nx, ny * nz), dtype=a.dtype, device=dev)
    scratch = (torch.empty((splits, nx, ny * nz), dtype=a.dtype, device=dev)
               if splits > 1 else out)
    code = _build.library().omm_spread_triple_fwd(
        a.data_ptr(), wy.data_ptr(), wz.data_ptr(), n, nx, ny, nz, splits,
        scratch.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(code, FWD)
    FWD.launches += 1
    return out


def spread_triple_bwd(dq, a, wy, wz):
    """Kernel 5: (dA (N, nx), dWy (N, ny), dWz (N, nz)) from the cotangent
    dq (nx, ny*nz). A CUDA tensor runs the hand-written kernel (float32,
    grid axes up to MAX_AXIS); a CPU tensor runs the plain version."""
    n, nx, ny, nz = _check(a, wy, wz, dq)
    if a.device.type == "cpu":
        return spread_triple_vjp_plain(dq, a, wy, wz)
    _cuda_ready(a)
    if max(nx, ny, nz) > MAX_AXIS:
        raise ValueError("spread_triple_bwd takes grid axes up to %d, not "
                         "(%d, %d, %d)" % (MAX_AXIS, nx, ny, nz))
    da = torch.empty_like(a)
    dwy = torch.empty_like(wy)
    dwz = torch.empty_like(wz)
    code = _build.library().omm_spread_triple_bwd(
        dq.data_ptr(), a.data_ptr(), wy.data_ptr(), wz.data_ptr(), n, nx, ny,
        nz, da.data_ptr(), dwy.data_ptr(), dwz.data_ptr(),
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
        return spread_triple_bwd(dq.contiguous(), *ctx.saved_tensors)


def spread_triple(a, wy, wz) -> torch.Tensor:
    """Q[x, (y,z)] = sum_i a[i,x] wy[i,y] wz[i,z] as (nx, ny*nz),
    differentiable in a, wy and wz: kernel 4 forward, kernel 5 backward."""
    return _SpreadTriple.apply(a.contiguous(), wy.contiguous(),
                               wz.contiguous())
