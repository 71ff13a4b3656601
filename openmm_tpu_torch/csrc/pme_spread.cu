// Order-5 B-spline charge spread onto the PME grid (kernel 2 of the PME
// water-box path).
//
// Replaces: openmm_tpu/ops/pme_zslab.py _spread_kernel (launched from
// pme_recip_ef). The Pallas kernel keeps atoms z-sorted between neighbour
// rebuilds and builds each z plane as a matmul over that plane's window of
// atoms, because the TPU has no fast scatter; the windows need drift
// margins, an overflow count and a persisted z-order. On Hopper a scatter
// with atomics is the natural form, so none of that state exists here.
//
// Design: one thread per atom computes its fractional coordinates, base
// indices and 5 weights per axis in registers, then adds its 125 products
// into the (nz, nx, ny) grid with atomicAdd(float), wrapping periodically.
// The grid (56^3 floats, 0.7 MB) lives in L2, where the atomics resolve.
// The order of the additions varies from run to run, so Q agrees with the
// plain version to float32 rounding, not bit for bit.
//
// Bound on this card: neither bytes (~1 MB a step) nor float operations
// (~0.5 Mflop per 1,000 atoms) is close to the limit; the 125 atomics per
// atom to L2 are what this kernel waits on.
#include <cuda_runtime.h>

#include "bspline5.cuh"

namespace {

__global__ void pme_spread_kernel(const float* __restrict__ pos,
                                  const float* __restrict__ charge,
                                  const float* __restrict__ binv, int n,
                                  int nx, int ny, int nz,
                                  float* __restrict__ grid) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float x = pos[3 * i], y = pos[3 * i + 1], z = pos[3 * i + 2];
  int bx, by, bz;
  float wx[5], wy[5], wz[5], unused[5];
  grid_axis(x, y, z, binv, 0, nx, &bx, wx, unused);
  grid_axis(x, y, z, binv, 1, ny, &by, wy, unused);
  grid_axis(x, y, z, binv, 2, nz, &bz, wz, unused);
  const float q = charge[i];
#pragma unroll
  for (int jx = 0; jx < 5; ++jx) {
    const int gx = (bx + jx - 4 + nx) % nx;
    const float qx = q * wx[jx];
#pragma unroll
    for (int jy = 0; jy < 5; ++jy) {
      const int gy = (by + jy - 4 + ny) % ny;
      const float qxy = qx * wy[jy];
#pragma unroll
      for (int jz = 0; jz < 5; ++jz) {
        const int gz = (bz + jz - 4 + nz) % nz;
        atomicAdd(grid + (static_cast<long>(gz) * nx + gx) * ny + gy,
                  qxy * wz[jz]);
      }
    }
  }
}

}  // namespace

extern "C" int omm_pme_spread(const void* pos, const void* charge,
                              const void* binv, int n, int nx, int ny, int nz,
                              void* grid, void* stream) {
  if (n > 0) {
    const int threads = 128;
    pme_spread_kernel<<<(n + threads - 1) / threads, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(pos), static_cast<const float*>(charge),
        static_cast<const float*>(binv), n, nx, ny, nz,
        static_cast<float*>(grid));
  }
  return static_cast<int>(cudaGetLastError());
}
